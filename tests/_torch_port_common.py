"""Shared set-up of the port's parity tests: a small JAX DiT and a small
multimodal JAX MMDiT with every parameter overwritten by seeded numpy noise,
a small Flux2 tower loaded from a synthetic diffusers state dict, and their
port twins.

The reference's Modulation layers are zero-initialised (adaLN-zero), so on
fresh weights every block adds exactly nothing and a parity test would see
only patchify and the last layer (trap T9). Every parameter is therefore
replaced before the weights are bridged.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from diffulab_tpu.networks.denoisers.mmdit import MMDiT as JaxMMDiT
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.weights import state_dict_from_jax

#: depth 2, inner dim 64, 4 heads of 16, patch 2 on 8x8x4 latents (16 tokens)
TINY = dict(simple_dit=True, input_channels=4, inner_dim=64, embedding_dim=64, num_heads=4,
            mlp_ratio=4, patch_size=2, depth=2, n_classes=10, classifier_free=True)
LATENT = (8, 8, 4)

#: precision policies: fp32, the bench's whole-model bf16 cast, and the
#: library's mixed default (bf16 matmuls, fp32 conditioning and stream)
POLICIES = {
    "fp32": (dict(), dict()),
    "bf16_full": (dict(dtype=jnp.bfloat16, stable_conditioning=False, stream_dtype=jnp.bfloat16),
                  dict(dtype=torch.bfloat16, stable_conditioning=False, stream_dtype=torch.bfloat16)),
    "bf16_mixed": (dict(dtype=jnp.bfloat16), dict(dtype=torch.bfloat16)),
}


def _noise(path: str, shape, rng: np.random.Generator) -> np.ndarray:
    if path.endswith("kernel"):
        fan_in = int(np.prod(shape[:-1]))
        return rng.standard_normal(shape) * fan_in ** -0.5
    if path.endswith("scale"):
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if path.endswith("bias"):
        return 0.1 * rng.standard_normal(shape)
    return rng.standard_normal(shape)


def randomized_jax_model(policy: str, seed: int = 0):
    """The tiny JAX DiT with all parameters replaced; returns (model, {path: array})."""
    model = JaxMMDiT(**TINY, **POLICIES[policy][0], rngs=nnx.Rngs(0))
    return model, _randomize(model, seed)


def port_model(policy: str, params: dict) -> MMDiT:
    model = MMDiT(**TINY, **POLICIES[policy][1], device="cpu")
    missing, unexpected = model.load_state_dict(state_dict_from_jax(params), strict=True)
    assert not missing and not unexpected
    return model


def rel_err(ours: np.ndarray, ref: np.ndarray) -> float:
    """max |ours - ref| over max |ref|."""
    return float(np.max(np.abs(ours - ref)) / np.max(np.abs(ref)))


# --- the txt2img slice: a tiny multimodal MMDiT and a tiny Flux2 tower -------

#: 2 dual-stream + 1 single-stream block, inner dim 64, 4 heads of 16, patch 1,
#: 3-axis RoPE over the whole head; the context is 8 tokens of width 32
TINY_MM = dict(simple_dit=False, input_channels=4, inner_dim=64, embedding_dim=64, num_heads=4, mlp_ratio=4,
               patch_size=1, depth=3, n_single_stream_blocks=1, rope_axes_dim=[4, 6, 6], classifier_free=True)
CONTEXT = (8, 32)
NULL_SEQ_LEN = 3
#: 32x32 latents: 1024 image tokens + 8 text tokens, past the fused kernel's
#: 512, so the port takes the flash route
MM_LATENT = (32, 32, 4)
#: the tower: 2 levels of 16/32 channels, 4 latent channels (16 packed), f = 4
TINY_TOWER = dict(base_channels=16, ch_mult=(1, 2), num_res_blocks=1, latent_channels=4)


def null_embedding(seed: int = 11) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(CONTEXT).astype(np.float32)


def _randomize(model, seed: int) -> dict:
    """Replace every nnx.Param of ``model`` with seeded noise; returns {path: array}."""
    rng = np.random.default_rng(seed)
    flat, params = [], {}
    for path, var in nnx.state(model, nnx.Param).flat_state():
        key = "/".join(str(p) for p in path)
        value = _noise(key, np.shape(var.get_value()), rng).astype(np.float32)
        params[key] = value
        flat.append((path, var.replace(jnp.asarray(value))))
    nnx.update(model, nnx.State.from_flat_path(flat))
    return params


def randomized_jax_mmdit(policy: str, seed: int = 0, **overrides):
    """The tiny multimodal JAX MMDiT with a PrecomputedEmbedder and all
    parameters replaced; returns (model, {path: array})."""
    from diffulab_tpu.networks.embedders.precomputed import PrecomputedEmbedder as JaxEmbedder

    cfg = {**TINY_MM, **overrides}
    embedder = JaxEmbedder(null_embedding=null_embedding(), null_embedding_seq_len=NULL_SEQ_LEN)
    model = JaxMMDiT(**cfg, context_embedder=embedder, **POLICIES[policy][0], rngs=nnx.Rngs(0))
    return model, _randomize(model, seed)


def port_mmdit(policy: str, params: dict, **overrides) -> MMDiT:
    from diffulab_tpu_torch.networks.embedders import PrecomputedEmbedder

    embedder = PrecomputedEmbedder(null_embedding=null_embedding(), null_embedding_seq_len=NULL_SEQ_LEN, device="cpu")
    model = MMDiT(**{**TINY_MM, **overrides}, context_embedder=embedder, **POLICIES[policy][1], device="cpu")
    model.load_state_dict(state_dict_from_jax(params, model), strict=True)
    return model


def context_inputs(batch: int, seed: int = 12):
    """Seeded numpy context embeddings [batch, 8, 32] and a ragged mask
    (every row keeps at least one token)."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((batch, *CONTEXT)).astype(np.float32)
    lengths = (np.arange(batch) * 3) % CONTEXT[0] + 1
    return emb, np.arange(CONTEXT[0])[None, :] < lengths[:, None]


def diffusers_vae_state_dict(seed: int = 13, base_channels: int = 16, ch_mult=(1, 2), num_res_blocks: int = 1,
                             latent_channels: int = 4) -> dict[str, np.ndarray]:
    """A synthetic diffusers ``AutoencoderKL`` state dict (numpy, OIHW convs,
    [out, in] linears) for the tower, with seeded noise of unit fan-in scale."""
    rng = np.random.default_rng(seed)
    sd: dict[str, np.ndarray] = {}

    def conv(name, cin, cout, k=3):
        sd[name + ".weight"] = (rng.standard_normal((cout, cin, k, k)) * (cin * k * k) ** -0.5).astype(np.float32)
        sd[name + ".bias"] = (0.1 * rng.standard_normal(cout)).astype(np.float32)

    def norm(name, c):
        sd[name + ".weight"] = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[name + ".bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)

    def resnet(name, cin, cout):
        norm(name + ".norm1", cin)
        conv(name + ".conv1", cin, cout)
        norm(name + ".norm2", cout)
        conv(name + ".conv2", cout, cout)
        if cin != cout:
            conv(name + ".conv_shortcut", cin, cout, 1)

    def attn(name, c):
        norm(name + ".group_norm", c)
        for lin in ("to_q", "to_k", "to_v", "to_out.0"):
            sd[f"{name}.{lin}.weight"] = (rng.standard_normal((c, c)) * c ** -0.5).astype(np.float32)
            sd[f"{name}.{lin}.bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)

    conv("encoder.conv_in", 3, base_channels)
    ch = base_channels
    for i, mult in enumerate(ch_mult):
        for j in range(num_res_blocks):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", ch, base_channels * mult)
            ch = base_channels * mult
        if i != len(ch_mult) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", ch, ch)
    resnet("encoder.mid_block.resnets.0", ch, ch)
    attn("encoder.mid_block.attentions.0", ch)
    resnet("encoder.mid_block.resnets.1", ch, ch)
    norm("encoder.conv_norm_out", ch)
    conv("encoder.conv_out", ch, 2 * latent_channels)

    ch = base_channels * ch_mult[-1]
    conv("decoder.conv_in", latent_channels, ch)
    resnet("decoder.mid_block.resnets.0", ch, ch)
    attn("decoder.mid_block.attentions.0", ch)
    resnet("decoder.mid_block.resnets.1", ch, ch)
    for i, mult in enumerate(reversed(ch_mult)):
        for j in range(num_res_blocks + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", ch, base_channels * mult)
            ch = base_channels * mult
        if i != len(ch_mult) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", ch, ch)
    norm("decoder.conv_norm_out", ch)
    conv("decoder.conv_out", ch, 3)
    return sd


def tower_pair(sd: dict[str, np.ndarray], bn_stats: bool = False):
    """(JAX Flux2VAE, port Flux2VAE) of :data:`TINY_TOWER`, both loaded from
    the diffusers-style ``sd`` through their own ``load_autoencoder_kl_state_dict``;
    with ``bn_stats``, seeded batch-norm running stats for the latent scale and bias."""
    from diffulab_tpu.networks.vision_towers.flux2 import Flux2VAE as JaxFlux2VAE
    from diffulab_tpu.networks.vision_towers.vae import load_autoencoder_kl_state_dict as jax_load
    from diffulab_tpu_torch.networks.vision_towers.flux2 import Flux2VAE
    from diffulab_tpu_torch.networks.vision_towers.vae import load_autoencoder_kl_state_dict

    stats = {}
    if bn_stats:
        rng = np.random.default_rng(14)
        packed = TINY_TOWER["latent_channels"] * 4
        stats = dict(bn_running_mean=(0.1 * rng.standard_normal(packed)).astype(np.float32),
                     bn_running_var=rng.uniform(0.5, 2.0, packed).astype(np.float32))
    jax_tower = JaxFlux2VAE(**TINY_TOWER, **stats, rngs=nnx.Rngs(0))
    jax_load(jax_tower.encoder, jax_tower.decoder, sd)
    tower = Flux2VAE(**TINY_TOWER, **stats, device="cpu")
    load_autoencoder_kl_state_dict(tower.encoder, tower.decoder, sd)
    return jax_tower, tower


# --- injected randomness (trap T4) ---------------------------------------------

def jax_scan_noise(key, n_steps: int, shape, dtype, inpaint: bool = False, kind: str = "step") -> dict:
    """The draws of the reference's denoise scan from ``key`` (flow.py:360-370,
    edm.py:375-397): per step ``step_rng, use_rng = split(step_rng)`` for the
    sampler (``kind``: "step", or EDM's "churn") and, with inpainting,
    ``step_rng, ip_rng = split(step_rng)``; keyed ``(kind, step)`` as the
    port's ``draw_noise`` asks for them."""
    draws = {}
    step_rng = key
    for i in range(n_steps):
        step_rng, use_rng = jax.random.split(step_rng)
        draws[(kind, i)] = np.asarray(jax.random.normal(use_rng, shape, dtype=dtype), np.float32)
        if inpaint:
            step_rng, ip_rng = jax.random.split(step_rng)
            draws[("inpaint", i)] = np.asarray(jax.random.normal(ip_rng, shape, dtype=dtype), np.float32)
    return draws


def injected(draws: dict):
    """A ``draw_noise`` callable that hands out the reference's draws."""
    def draw(kind, step, shape, dtype):
        value = torch.from_numpy(np.array(draws[(kind, step)])).to(dtype)
        assert tuple(value.shape) == tuple(shape)
        return value
    return draw


def write_mnist(root, n_train: int = 12, n_test: int = 5, seed: int = 0) -> None:
    """Valid MNIST idx files from a seed (idx headers, uniform uint8 pixels
    and labels) in ``root``: train and t10k images and labels."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for prefix, n in (("train", n_train), ("t10k", n_test)):
        with open(root / f"{prefix}-images-idx3-ubyte", "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28))
            f.write(rng.integers(0, 256, (n, 28, 28), dtype=np.uint8).tobytes())
        with open(root / f"{prefix}-labels-idx1-ubyte", "wb") as f:
            f.write(struct.pack(">II", 2049, n))
            f.write(rng.integers(0, 10, n, dtype=np.uint8).tobytes())
