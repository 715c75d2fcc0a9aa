"""The port's latent text-to-image path against the JAX package: the
PrecomputedEmbedder, the multimodal MMDiT (its sequence past 512 tokens, so
the port takes the flash route), the Flux2 tower, and a latent-mode CFG
``generate`` with decode.

Weights: every JAX parameter of the MMDiT is replaced by seeded noise and
bridged (trap T9); both towers load one synthetic diffusers state dict
through their own ``load_autoencoder_kl_state_dict``. Tolerances, as
max |port - JAX| over max |JAX|: 1e-5 in fp32 (summation order only); 4e-2
for the mixed bf16 policy (bf16 rounds at the same places, but the port's
flash attention rounds p at other tile boundaries than XLA's softmax, and
XLA's CPU backend may keep excess precision between fused bf16 ops).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import (
    CONTEXT,
    MM_LATENT,
    NULL_SEQ_LEN,
    POLICIES,
    TINY_MM,
    TINY_TOWER,
    JaxMMDiT,
    _randomize,
    context_inputs,
    diffusers_vae_state_dict,
    null_embedding,
    port_mmdit,
    randomized_jax_mmdit,
    rel_err,
    tower_pair,
)
from flax import nnx

from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.diffuse.flow import _cfg_model_call as jax_cfg_model_call
from diffulab_tpu.networks import nn as jnn
from diffulab_tpu.networks.embedders.precomputed import PrecomputedEmbedder as JaxEmbedder
from diffulab_tpu.networks.vision_towers.common import normalize_to_pm1 as jax_normalize
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.diffuse.flow import _cfg_model_call
from diffulab_tpu_torch.networks import nn as tnn
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.networks.embedders import ContextEmbedder, PrecomputedEmbedder
from diffulab_tpu_torch.networks.vision_towers.common import normalize_to_pm1
from diffulab_tpu_torch.networks.vision_towers.flux2 import Flux2VAE
from diffulab_tpu_torch.networks.vision_towers.vae import diagonal_gaussian_sample
from diffulab_tpu_torch.weights import state_dict_from_jax

TOL = {"fp32": 1e-5, "bf16_mixed": 4e-2}
#: the tower in fp32: conv sums in another order (measured ~1e-6)
TOWER_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_cond(emb, mask):
    return {"context": {"embeddings": jnp.asarray(emb), "attn_mask": jnp.asarray(mask)}}


def _cond(emb, mask):
    return {"context": {"embeddings": torch.from_numpy(emb), "attn_mask": torch.from_numpy(mask)}}


# --- the embedder -------------------------------------------------------------


def test_precomputed_embedder_drop_and_mask_match_jax():
    emb, mask = context_inputs(4)
    drop = np.array([False, True, False, True])
    ref = JaxEmbedder(null_embedding=null_embedding(), null_embedding_seq_len=NULL_SEQ_LEN)(
        {"embeddings": jnp.asarray(emb), "attn_mask": jnp.asarray(mask)}, jnp.asarray(drop))
    embedder = PrecomputedEmbedder(null_embedding=null_embedding(), null_embedding_seq_len=NULL_SEQ_LEN, device="cpu")
    out = embedder({"embeddings": torch.from_numpy(emb), "attn_mask": torch.from_numpy(mask)}, torch.from_numpy(drop))
    np.testing.assert_array_equal(out["embeddings"].numpy(), np.asarray(ref["embeddings"]))
    np.testing.assert_array_equal(out["attn_mask"].numpy(), np.asarray(ref["attn_mask"]))
    # dropped rows take the null embedding and its mask: NULL_SEQ_LEN valid tokens
    np.testing.assert_array_equal(out["embeddings"][1].numpy(), null_embedding())
    assert out["attn_mask"][1].tolist() == [True] * NULL_SEQ_LEN + [False] * (CONTEXT[0] - NULL_SEQ_LEN)
    # no mask and no drop: every token valid, the embeddings untouched
    plain = embedder({"embeddings": torch.from_numpy(emb)})
    assert plain["attn_mask"].all() and torch.equal(plain["embeddings"], torch.from_numpy(emb))
    assert embedder.n_output == 1 and embedder.output_size == (CONTEXT[1],)


def test_null_embedding_is_a_buffer_from_npy(tmp_path):
    path = tmp_path / "null.npy"
    np.save(path, null_embedding()[None])  # a leading 1 is squeezed, as in the reference
    embedder = PrecomputedEmbedder(path, null_embedding_seq_len=2, device="cpu")
    assert not list(embedder.parameters()) and not embedder.state_dict()
    np.testing.assert_array_equal(embedder.null_embedding.numpy(), null_embedding())
    assert embedder.null_embedding_mask.tolist() == [True, True] + [False] * (CONTEXT[0] - 2)
    with pytest.raises(ValueError, match="null_embedding"):
        PrecomputedEmbedder(device="cpu")
    with pytest.raises(ValueError, match=r"\[L, D\]"):
        PrecomputedEmbedder(null_embedding=np.zeros((2, 3, 4)), device="cpu")


# --- the multimodal MMDiT -----------------------------------------------------


@pytest.mark.parametrize("policy", ["fp32", "bf16_mixed"])
def test_mmdit_forward_matches_jax(policy):
    jax_model, params = randomized_jax_mmdit(policy)
    model = port_mmdit(policy, params)
    jdt = POLICIES[policy][0].get("dtype", jnp.float32)
    tdt = POLICIES[policy][1].get("dtype", torch.float32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, *MM_LATENT)).astype(np.float32)
    t = rng.uniform(size=4).astype(np.float32)
    emb, mask = context_inputs(4)
    drop = np.array([False, True, False, True])  # the fused-CFG drop: rows take the null embedding

    ref = jax_model(jnp.asarray(x, jdt), jnp.asarray(t), _jax_cond(emb, mask), jnp.asarray(drop))["x"]
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(tdt), torch.from_numpy(t), _cond(emb, mask), torch.from_numpy(drop))["x"]
    assert out.shape == ref.shape == (4, *MM_LATENT)
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    assert rel_err(out.float().numpy(), np.asarray(ref, np.float32)) < TOL[policy]


def test_mmdit_bridge_structure_and_positions():
    _, params = randomized_jax_mmdit("fp32")
    model = port_mmdit("fp32", params)
    assert [type(layer).__name__ for layer in model.layers] == ["MMDiTBlock"] * 2 + ["MMDiTSingleStreamBlock"]
    assert set(state_dict_from_jax(params, model)) == set(model.state_dict())
    np.testing.assert_array_equal(model.context_embed.weight.detach().numpy(), params["context_embed/kernel"].T)
    np.testing.assert_array_equal(model.layers[0].attention.qkv_context.weight.detach().numpy(),
                                  params["layers/0/attention/qkv_context/kernel"].T)
    jax_model, _ = randomized_jax_mmdit("fp32")
    np.testing.assert_array_equal(model._text_pos_ids(2, 5, "cpu").numpy(), np.asarray(jax_model._text_pos_ids(2, 5)))
    assert model._text_pos_ids(1, 3, "cpu")[0, :, 0].tolist() == [1, 2, 3]  # text positions start at 1
    np.testing.assert_array_equal(model._image_pos_ids(2, (3, 4), 3, "cpu").numpy(),
                                  np.asarray(jax_model._image_pos_ids(2, (3, 4), 3)))


class _PooledStub(ContextEmbedder):
    """Two outputs (pooled [B, 24], tokens [B, 8, 32]) passed through."""

    _n_output = 2
    _output_size = (24, CONTEXT[1])

    def forward(self, context, drop=None):
        return dict(context)


class _JaxPooledStub(JaxEmbedder):
    def __init__(self):
        self._n_output, self._output_size = 2, (24, CONTEXT[1])

    def __call__(self, context, drop=None):
        return dict(context)


def test_pooled_context_mlp_with_a_two_output_embedder_matches_jax():
    cfg = {**TINY_MM, "depth": 2, "n_single_stream_blocks": 1}
    jax_model = JaxMMDiT(**cfg, context_embedder=_JaxPooledStub(), rngs=nnx.Rngs(0))
    params = _randomize(jax_model, 4)
    model = MMDiT(**cfg, context_embedder=_PooledStub(), device="cpu")
    model.load_state_dict(state_dict_from_jax(params, model), strict=True)
    assert model.pooled_embedding and model.mlp_pooled_context.fc1.weight.shape == (128, 24)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = rng.uniform(size=2).astype(np.float32)
    emb, mask = context_inputs(2)
    pooled = rng.standard_normal((2, 24)).astype(np.float32)
    ref = jax_model(jnp.asarray(x), jnp.asarray(t), {"context": {"embeddings": jnp.asarray(emb),
                    "attn_mask": jnp.asarray(mask), "pooled_embeddings": jnp.asarray(pooled)}})["x"]
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), {"context": {
            "embeddings": torch.from_numpy(emb), "attn_mask": torch.from_numpy(mask),
            "pooled_embeddings": torch.from_numpy(pooled)}})["x"]
    assert rel_err(out.numpy(), np.asarray(ref)) < TOL["fp32"]


def test_mmdit_argument_checks():
    embedder = PrecomputedEmbedder(null_embedding=null_embedding(), device="cpu")
    with pytest.raises(ValueError, match="context embedder"):
        MMDiT(**TINY_MM, device="cpu")
    with pytest.raises(ValueError, match="cannot both"):
        MMDiT(**TINY_MM, n_classes=10, context_embedder=embedder, device="cpu")
    model = MMDiT(**TINY_MM, context_embedder=embedder, device="cpu")
    x, t = torch.zeros(1, 4, 4, 4), torch.zeros(1)
    with pytest.raises(ValueError, match="context"):
        model(x, t, {})
    model.feature_layers = (0, 2)  # REPA capture is ported (tests/test_torch_port_repa.py): the image tokens
    with torch.no_grad():
        feats = model(x, t, _cond(*context_inputs(1)), capture_features=True)["features"]
    assert [f.shape for f in feats] == [(1, 16, TINY_MM["inner_dim"])] * 2
    # block caching is ported (tests/test_torch_port_caching.py); a span must lie inside the stack
    with pytest.raises(ValueError, match="out of range"):
        model.set_block_cache_span((0, 4))
    model.set_block_cache_span((0, 1))
    assert model.cache_span == (0, 1)


# --- primitives and the tower -------------------------------------------------


@pytest.mark.parametrize("channels,groups", [(16, 16), (64, 32), (8, 8)])
def test_group_norm_matches_nnx(channels, groups):
    rng = np.random.default_rng(channels)
    x = (rng.standard_normal((2, 5, 6, channels)) * 3 + 1).astype(np.float32)
    scale, bias = (1 + 0.1 * rng.standard_normal(channels)).astype(np.float32), rng.standard_normal(channels).astype(np.float32)
    jnorm = nnx.GroupNorm(channels, num_groups=min(32, channels), epsilon=1e-6, rngs=nnx.Rngs(0))
    jnorm.scale.set_value(jnp.asarray(scale))
    jnorm.bias.set_value(jnp.asarray(bias))
    norm = tnn.GroupNorm(channels)
    assert norm.num_groups == groups
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        out = norm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jnorm(jnp.asarray(x))), atol=1e-5, rtol=1e-5)


def test_nearest_upsample_and_range_normalisation_match_jax():
    x = np.random.default_rng(3).standard_normal((2, 3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(tnn.nearest_upsample_2x(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnn.nearest_upsample_2x(jnp.asarray(x))))
    for img in (x * 100 + 120, np.abs(x) / 4, np.clip(x, -1, 1)):  # 0-255, 0-1, [-1, 1]
        np.testing.assert_allclose(normalize_to_pm1(torch.from_numpy(img)).numpy(),
                                   np.asarray(jax_normalize(jnp.asarray(img))), atol=1e-6)


@pytest.mark.parametrize("bn_stats", [False, True])
def test_flux2_decode_and_encode_match_jax(bn_stats):
    jax_tower, tower = tower_pair(diffusers_vae_state_dict(), bn_stats=bn_stats)
    assert tower.compression_factor == jax_tower.compression_factor == 4
    assert tower.latent_channels == jax_tower.latent_channels == 16
    if bn_stats:
        np.testing.assert_array_equal(tower.latent_scale.numpy(), np.asarray(jax_tower.latent_scale))
        np.testing.assert_array_equal(tower.latent_bias.numpy(), np.asarray(jax_tower.latent_bias))
    else:
        assert tower.latent_scale == 1.0 and tower.latent_bias == 0.0
    rng = np.random.default_rng(4)
    image = rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    z_ref = np.asarray(jax_tower.encode(jnp.asarray(image)))  # rng None: the posterior mean
    with torch.no_grad():
        z = tower.encode(torch.from_numpy(image)).numpy()
        assert z.shape == z_ref.shape == (2, 8, 8, 16)
        assert rel_err(z, z_ref) < TOWER_TOL
        latents = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
        out = tower.decode(torch.from_numpy(latents)).numpy()
    ref = np.asarray(jax_tower.decode(jnp.asarray(latents)))
    assert out.shape == ref.shape == (2, 32, 32, 3)
    assert rel_err(out, ref) < TOWER_TOL


def test_tower_bridge_names_group_norm_scales():
    # trap T16: mid_attn/norm/scale is a GroupNorm's, not a LayerNorm's
    jax_tower, tower = tower_pair(diffusers_vae_state_dict())
    params = {"/".join(str(p) for p in path): np.asarray(v.get_value())
              for path, v in nnx.state(jax_tower, nnx.Param).flat_state()}
    sd = state_dict_from_jax(params, tower)
    assert set(sd) == set(tower.state_dict())
    assert "decoder.mid_attn.norm.scale" in sd and "decoder.mid_res1.norm1.scale" in sd
    fresh = Flux2VAE(**TINY_TOWER, device="cpu")
    fresh.load_state_dict(sd, strict=True)
    for key, value in tower.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[key], value, rtol=0, atol=0)
    assert "layers.0.norm_1.norm.weight" in state_dict_from_jax({"layers/0/norm_1/norm/scale": np.ones(3)})


def test_tower_weights_path_and_unported_options(tmp_path):
    sd = diffusers_vae_state_dict()
    sd["bn.running_mean"] = np.zeros(16, np.float32)
    sd["bn.running_var"] = np.full(16, 4.0, np.float32)
    np.savez(tmp_path / "vae.npz", **sd)
    tower = Flux2VAE(**TINY_TOWER, weights_path=tmp_path / "vae.npz", device="cpu")
    _, ref = tower_pair(diffusers_vae_state_dict())
    torch.testing.assert_close(tower.decoder.conv_out.weight, ref.decoder.conv_out.weight, rtol=0, atol=0)
    torch.testing.assert_close(tower.latent_scale, torch.full((1, 1, 1, 16), 1 / np.sqrt(4.0001), dtype=torch.float32))
    orbax = tmp_path / "orbax_tower"  # a JAX package tower: the port reads it only through the importer
    orbax.mkdir()
    (orbax / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax.*import_orbax_checkpoint"):
        Flux2VAE(flax_ckpt=orbax, device="cpu")


def test_diagonal_gaussian_sample():
    moments = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 4, 4, 8)).astype(np.float32))
    torch.testing.assert_close(diagonal_gaussian_sample(moments, None), moments[..., :4], rtol=0, atol=0)
    a = diagonal_gaussian_sample(moments, torch.Generator().manual_seed(0))
    b = diagonal_gaussian_sample(moments, torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    noise = torch.randn((2, 4, 4, 4), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, moments[..., :4] + torch.exp(0.5 * moments[..., 4:].clamp(-30, 20)) * noise)


# --- the whole slice ----------------------------------------------------------


def test_cfg_concatenates_a_nested_cond_like_jax():
    # trap T14: a txt2img cond is a dict inside a dict
    emb, mask = context_inputs(2)
    seen = {}

    def model_fn(x, timesteps, cond, drop):
        seen.update(cond=cond, drop=drop)
        return {"x": x * 0 + 1}

    x, t = np.zeros((2, 2, 2, 1), np.float32), np.full(2, 0.5, np.float32)
    _cfg_model_call(model_fn, torch.from_numpy(x), torch.from_numpy(t), _cond(emb, mask), 4.0, True)
    ours = seen["cond"]["context"]
    jax_cfg_model_call(model_fn, jnp.asarray(x), jnp.asarray(t), _jax_cond(emb, mask), 4.0, True)
    ref = seen["cond"]["context"]
    for key in ("embeddings", "attn_mask"):
        assert ours[key].shape[0] == 4
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]))


@pytest.mark.parametrize("policy", ["fp32", "bf16_mixed"])
def test_latent_generate_with_decode_matches_jax(policy):
    """4 Euler steps with fused CFG 4.0 on 24x24x16 latents (576 image + 8
    text tokens: the flash route), then the Flux2 decode to 96x96 pixels
    clipped to [-1, 1], from the same injected x (trap T4)."""
    overrides = dict(input_channels=16)
    jax_model, params = randomized_jax_mmdit(policy, seed=3, **overrides)
    model = port_mmdit(policy, params, **overrides)
    jax_tower, tower = tower_pair(diffusers_vae_state_dict(), bn_stats=True)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 24, 24, 16)).astype(np.float32)
    emb, mask = context_inputs(2)
    extra = {"logits_normal": True, "shift": 4.63}
    ref = JaxDiffuser(jax_model, "euler", n_steps=4, vision_tower=jax_tower, extra_args=extra).generate(
        jax.random.key(0), _jax_cond(emb, mask), x=jnp.asarray(x), guidance_scale=4.0, clamp_x=True)["x"]
    diffuser = Diffuser(model, "euler", n_steps=4, vision_tower=tower, extra_args=extra)
    assert diffuser.diffusion.latent_diffusion and diffuser.latent_scale is tower.latent_scale
    out = diffuser.generate(_cond(emb, mask), x=torch.from_numpy(x), guidance_scale=4.0, clamp_x=True,
                            device="cpu")["x"]
    assert out.shape == ref.shape == (2, 96, 96, 3)
    assert float(out.abs().max()) <= 1.0
    assert rel_err(out.float().numpy(), np.asarray(ref, np.float32)) < TOL[policy]


def test_return_latents_skips_the_decode_and_the_clip():
    # trap T5: clamp_x is a pixel range; the latents come back unclipped
    overrides = dict(input_channels=16)
    _, params = randomized_jax_mmdit("fp32", seed=3, **overrides)
    model = port_mmdit("fp32", params, **overrides)
    _, tower = tower_pair(diffusers_vae_state_dict())
    x = torch.from_numpy(3 * np.random.default_rng(7).standard_normal((1, 8, 8, 16)).astype(np.float32))
    cond = _cond(*context_inputs(1))
    latent = Diffuser(model, "euler", n_steps=2, vision_tower=tower)
    latents = latent.generate(cond, x=x, guidance_scale=2.0, clamp_x=True, return_latents=True, device="cpu")["x"]
    assert latents.shape == (1, 8, 8, 16) and float(latents.abs().max()) > 1.0
    plain = Diffuser(model, "euler", n_steps=2).generate(cond, x=x, guidance_scale=2.0, device="cpu")["x"]
    torch.testing.assert_close(latents, plain, rtol=0, atol=0)
