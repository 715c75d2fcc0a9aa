"""REPA's pretrained encoders and the Perceiver resampler in the port
against the JAX package, on the CPU (``networks/repa/{common,vit,dinov2,
dinov3,perceiver_resampler}.py``):

- ``bicubic_resize`` against ``jax.image.resize(..., "bicubic")`` (trap T3:
  Keys a = -0.5, antialiased when shrinking) at 256 -> 224 (DINOv2's
  preprocessing), 37 -> 16 (a position table) and an upscale, at 1e-5 of
  the max; ``F.interpolate``'s bicubic differs;
- ``normalize_imagenet`` on 0-255 and on 0-1 pixels;
- a tiny ViT through ``load_dinov2_state_dict`` from one random state dict
  in the hub's key names, its 6x6 position table resampled to 4x4, on both
  sides; ``DinoV2`` (ViT-S/14 with registers, bridged noise weights) with
  ``target_seq_len``, and its ``weights_path``;
- a tiny DINOv3 from an HF checkpoint directory the test writes
  (config.json and safetensors shards, fp32 and bf16), through
  ``load_hf_checkpoint_dir`` and ``DinoV3(weights_path=...)`` on both sides;
- the Perceiver resampler with bridged noise weights (trap T2: the tanh
  GELU), its default 2-axis RoPE grid and a given one, rel 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from _torch_port_common import _randomize, rel_err
from flax import nnx

from diffulab_tpu.networks.repa import common as jcommon
from diffulab_tpu.networks.repa import dinov2 as jdinov2
from diffulab_tpu.networks.repa import dinov3 as jdinov3
from diffulab_tpu.networks.repa import perceiver_resampler as jpr
from diffulab_tpu.networks.repa import vit as jvit
from diffulab_tpu_torch.networks.repa import DinoV2, DinoV3, PerceiverResampler, ViTEncoder
from diffulab_tpu_torch.networks.repa.common import bicubic_resize, normalize_imagenet
from diffulab_tpu_torch.networks.repa.vit import load_dinov2_state_dict, load_hf_checkpoint_dir, read_safetensors
from diffulab_tpu_torch.weights import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("size_in,size_out", [(256, 224), (37, 16), (16, 40)])
def test_bicubic_resize_matches_jax(size_in, size_out):
    x = np.random.default_rng(size_in).standard_normal((2, size_in, size_in, 3)).astype(np.float32)
    ref = np.asarray(jcommon.bicubic_resize(jnp.asarray(x), size_out))
    out = bicubic_resize(torch.from_numpy(x), size_out).numpy()
    assert out.shape == ref.shape == (2, size_out, size_out, 3)
    assert rel_err(out, ref) <= 1e-5
    plain = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(size_out, size_out), mode="bicubic",
                          align_corners=False).permute(0, 2, 3, 1).numpy()
    assert rel_err(plain, ref) > 1e-3  # T3: torch's a = -0.75 without antialias is another resize


@pytest.mark.parametrize("scale", [255.0, 1.0])
def test_normalize_imagenet_matches_jax(scale):
    px = np.random.default_rng(7).uniform(0, scale, (2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(normalize_imagenet(torch.from_numpy(px)).numpy(),
                               np.asarray(jcommon.normalize_imagenet(jnp.asarray(px))), rtol=1e-6, atol=1e-6)


def _hub_state_dict(model: ViTEncoder, grid: int, seed: int) -> dict[str, np.ndarray]:
    """A random facebookresearch/dinov2 state dict for ``model``'s
    architecture, its position table at ``grid`` x ``grid`` patches."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, value in model.state_dict().items():
        shape = tuple(value.shape)
        key = name.replace("patch_embed.", "patch_embed.proj.").replace(".fc", ".mlp.fc")
        key = key.replace(".ls1", ".ls1.gamma").replace(".ls2", ".ls2.gamma")
        if name == "pos_embed":
            shape = (1, grid * grid + 1, shape[-1])
        scale = 1.0 if name in ("cls_token", "register_tokens", "pos_embed") else 0.3
        out[key] = (scale * rng.standard_normal(shape) + (1.0 if "norm" in key and key.endswith("weight") else 0.0)
                    ).astype(np.float32)
    return out


def test_load_dinov2_state_dict_matches_jax():
    kw = dict(img_size=56, patch_size=14, embed_dim=32, depth=2, num_heads=2, num_register_tokens=2)
    ours = ViTEncoder(**kw, device="cpu")
    sd = _hub_state_dict(ours, 6, 3)
    jm = nnx.eval_shape(lambda: jvit.ViTEncoder(**kw, rngs=nnx.Rngs(0)))
    _randomize(jm, 0)
    jvit.load_dinov2_state_dict(jm, sd, target_grid=(4, 4))
    load_dinov2_state_dict(ours, sd, target_grid=(4, 4))
    assert rel_err(ours.pos_embed.detach().numpy(), np.asarray(jm.pos_embed[...])) <= 1e-6
    x = np.random.default_rng(4).standard_normal((2, 56, 56, 3)).astype(np.float32)
    ref = jax.jit(jm.__call__)(jnp.asarray(x))
    with torch.no_grad():
        out = ours(torch.from_numpy(x))
    for key in ("patch_tokens", "cls"):
        assert rel_err(out[key].numpy(), np.asarray(ref[key])) <= 1e-5, key
    with pytest.raises(ValueError, match="pos_embed"):
        load_dinov2_state_dict(ours, sd)  # the 6x6 table does not fit a 4x4 grid unresampled


def test_dinov2_matches_jax(tmp_path):
    """ViT-S/14 with registers, at target_seq_len 4 (2x2 patches, 28 px): 32 px
    0-255 images normalised and bicubic-resized on both sides; then its
    weights_path against load_dinov2_state_dict on the same checkpoint."""
    jm = nnx.eval_shape(lambda: jdinov2.DinoV2("dinov2_vits14_reg", target_seq_len=4, rngs=nnx.Rngs(0)))
    params = _randomize(jm, 5)
    ours = DinoV2("dinov2_vits14_reg", target_seq_len=4, device="cpu")
    ours.load_state_dict(state_dict_from_jax(params, ours), strict=True)
    assert ours.inference_resolution == jm.inference_resolution == 28 and ours.embedding_dim == 384
    assert DinoV2("dinov2_vits14", resolution=512, device="meta").inference_resolution == 448
    x = np.random.default_rng(6).uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.__call__)(jnp.asarray(x)))
    out = ours(torch.from_numpy(x))
    assert out.shape == ref.shape == (2, 4, 384) and not out.requires_grad
    assert rel_err(out.numpy(), ref) <= 1e-5
    sd = _hub_state_dict(ours.encoder, 16, 8)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "dinov2.pt")
    loaded = DinoV2("dinov2_vits14_reg", target_seq_len=4, weights_path=tmp_path / "dinov2.pt", device="cpu")
    direct = ViTEncoder(img_size=28, patch_size=14, embed_dim=384, depth=12, num_heads=6, device="cpu")
    load_dinov2_state_dict(direct, sd, target_grid=(2, 2))
    for key, value in direct.state_dict().items():
        assert torch.equal(loaded.encoder.state_dict()[key], value), key


DINOV3_CONFIG = {"patch_size": 8, "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
                 "intermediate_size": 48, "num_register_tokens": 2, "use_gated_mlp": True, "rope_theta": 100.0,
                 "layer_norm_eps": 1e-5, "key_bias": False}


def _write_hf_dir(root, dtype: str, seed: int) -> None:
    """An HF DINOv3ViTModel checkpoint directory in two safetensors shards."""
    from safetensors.numpy import save_file as save_numpy
    from safetensors.torch import save_file as save_torch

    from diffulab_tpu_torch.networks.repa.vit import build_dinov3_from_config

    model = build_dinov3_from_config(DINOV3_CONFIG, device="cpu")
    rng = np.random.default_rng(seed)
    sd = {}
    for name, value in model.state_dict().items():
        key = (name.replace("patch_embed.", "embeddings.patch_embeddings.").replace("blocks.", "layer.")
               .replace(".attn.", ".attention.").replace("_proj", "_proj").replace(".ls1", ".layer_scale1.lambda1")
               .replace(".ls2", ".layer_scale2.lambda1"))
        key = {"cls_token": "embeddings.cls_token", "register_tokens": "embeddings.register_tokens"}.get(key, key)
        for proj in ("up_proj", "down_proj", "gate_proj"):
            key = key.replace(f".{proj}.", f".mlp.{proj}.")
        sd[key] = (0.3 * rng.standard_normal(tuple(value.shape))
                   + (1.0 if "norm" in key and key.endswith("weight") else 0.0)).astype(np.float32)
    sd["embeddings.mask_token"] = np.zeros((1, 1, 32), np.float32)  # pre-training only: ignored
    root.mkdir()
    (root / "config.json").write_text(json.dumps(DINOV3_CONFIG))
    names = sorted(sd)
    for i, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        if dtype == "float32":
            save_numpy({k: sd[k] for k in part}, str(root / f"model-{i:05d}.safetensors"))
        else:
            save_torch({k: torch.from_numpy(sd[k]).bfloat16() for k in part}, str(root / f"model-{i:05d}.safetensors"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dinov3_from_a_checkpoint_dir_matches_jax(dtype, tmp_path):
    ckpt = tmp_path / "dinov3"
    _write_hf_dir(ckpt, dtype, 9)
    cfg, state = load_hf_checkpoint_dir(ckpt)
    jcfg, jstate = jvit.load_hf_checkpoint_dir(ckpt)
    assert cfg == jcfg and set(state) == set(jstate)
    for key in state:
        np.testing.assert_array_equal(state[key].astype(np.float32), np.asarray(jstate[key], np.float32))
    assert read_safetensors(sorted(ckpt.glob("*.safetensors"))[0]).keys() <= state.keys()
    jm = jdinov3.DinoV3(resolution=32, weights_path=str(ckpt), cancel_affine=False, rngs=nnx.Rngs(0))
    ours = DinoV3(resolution=32, weights_path=ckpt, device="cpu")
    assert ours.embedding_dim == jm.embedding_dim == 32
    x = np.random.default_rng(10).uniform(0, 1, (2, 40, 40, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.__call__)(jnp.asarray(x)))
    out = ours(torch.from_numpy(x))
    assert out.shape == ref.shape == (2, 16, 32)
    assert rel_err(out.numpy(), ref) <= 1e-5
    no_affine = DinoV3(resolution=32, weights_path=ckpt, cancel_affine=True, device="cpu")
    assert not no_affine.encoder.norm.elementwise_affine


@pytest.mark.parametrize("given_grid", [False, True])
def test_perceiver_resampler_matches_jax(given_grid):
    """T2: the feed-forward's GELU is the tanh approximation on both sides."""
    kw = dict(dim=32, depth=2, head_dim=8, num_heads=2, ff_mult=2, num_latents=5)
    jm = nnx.eval_shape(lambda: jpr.PerceiverResampler(**kw, rngs=nnx.Rngs(0)))
    params = _randomize(jm, 11)
    ours = PerceiverResampler(**kw, device="cpu")
    ours.load_state_dict(state_dict_from_jax(params, ours), strict=True)
    x = np.random.default_rng(12).standard_normal((2, 16, 32)).astype(np.float32)
    cos_sin = None
    if given_grid:
        rng = np.random.default_rng(13)
        cos_sin = tuple(rng.uniform(-1, 1, (16, 4)).astype(np.float32) for _ in range(2))
    ref = np.asarray(jax.jit(lambda a, cs: jm(a, cs))(jnp.asarray(x), cos_sin))
    with torch.no_grad():
        out = ours(torch.from_numpy(x), None if cos_sin is None else tuple(torch.from_numpy(c) for c in cos_sin))
    assert out.shape == ref.shape == (2, 5, 32)
    assert rel_err(out.numpy(), ref) <= 1e-5
