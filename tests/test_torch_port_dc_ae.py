"""The DC-AE tower and the vision towers' latent precompute in the port
against the JAX package, on the CPU:

- a tiny DCAE (channels (8, 16, 16), stages (res, vit, vit), one block a
  stage, LiteMLA with a 5x5 multi-scale branch, both upsample modes) with
  every parameter overwritten with seeded noise (T9) and bridged: encode
  and decode at 1e-5 of each tensor's max |value|;
- trap T26: a stride-2 conv on an even input pads 0 before and 1 after, as
  flax's ``padding="SAME"``, and differs from symmetric padding;
- ``_space_to_depth`` / ``_depth_to_space`` equal JAX's channel order, and
  the space-to-depth equals ``F.pixel_unshuffle`` on the NCHW view;
- ``load_dc_ae_state_dict`` from one random state dict in diffusers' key
  names, on both sides, and its refusals;
- ``VisionTower.compute_on_dataset`` for DCAE and for the Flux2 VAE (its
  stochastic encode: batch ``bi``'s noise from ``fold_in(key(seed), bi)``)
  against the JAX package's shards;
- the full f32c32 DCAE's parameter tree against the JAX one's, from shapes
  only (``nnx.eval_shape``), and the ``vision_tower=dcae`` config resolving.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from _torch_port_common import TINY_TOWER, _randomize, diffusers_vae_state_dict, rel_err
from flax import nnx

from diffulab_tpu.data.streaming import ShardedDataset as JaxShardedDataset
from diffulab_tpu.networks.vision_towers import dc_ae as jdc
from diffulab_tpu_torch.config import compose_config, instantiate
from diffulab_tpu_torch.data.streaming import ShardedDataset, ShardedDatasetWriter
from diffulab_tpu_torch.examples.train_diffusion import CONFIG_DIR
from diffulab_tpu_torch.networks.vision_towers import dc_ae
from diffulab_tpu_torch.weights import _torch_key, state_dict_from_jax

TINY_DCAE = dict(block_out_channels=(8, 16, 16), block_types=("res", "vit", "vit"),
                 encoder_layers_per_block=(1, 1, 1), decoder_layers_per_block=(1, 1, 1), latent_channels=4,
                 qkv_multiscales=((), (5,), (5,)), attention_head_dim=4)


def bridged_shapes(jax_model, module) -> dict[str, tuple[int, ...]]:
    """The port state-dict names and shapes that ``jax_model``'s parameters
    (an ``nnx.eval_shape`` tree will do) bridge to, as ``state_dict_from_jax``
    maps them with ``module``, without allocating a full-size array."""
    names = set(module.state_dict())
    out = {}
    for path, v in nnx.state(jax_model, nnx.Param).flat_state():
        path = "/".join(str(p) for p in path)
        key, view = _torch_key(path, np.broadcast_to(np.float32(0), np.shape(v.get_value())))
        if path.endswith("/scale") and key not in names:
            stem = key.rsplit(".", 1)[0]
            key = next((f"{stem}.{leaf}" for leaf in ("scale", "weight") if f"{stem}.{leaf}" in names), key)
        out[key] = tuple(view.shape)
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(seed: int, **overrides):
    cfg = {**TINY_DCAE, **overrides}
    jm = nnx.eval_shape(lambda: jdc.DCAE(**cfg, rngs=nnx.Rngs(0)))  # every parameter is replaced
    tm = dc_ae.DCAE(**cfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax(_randomize(jm, seed), tm), strict=True)
    return jm, tm


@pytest.mark.parametrize("mode", ["pixel_shuffle", "interpolate"])
def test_tiny_dcae_encode_decode_match_jax(mode):
    jm, tm = _pair(3, upsample_mode=mode)
    x = np.random.default_rng(4).uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    ref_z = np.asarray(jax.jit(jm.encode)(jnp.asarray(x)))
    ref_x = np.asarray(jax.jit(jm.decode)(jnp.asarray(ref_z)))
    with torch.no_grad():
        z = tm.encode(torch.from_numpy(x)).numpy()
        out = tm.decode(torch.from_numpy(ref_z)).numpy()
    assert z.shape == ref_z.shape == (2, 4, 4, 4) and out.shape == ref_x.shape == (2, 16, 16, 3)
    assert rel_err(z, ref_z) <= 1e-5
    assert rel_err(out, ref_x) <= 1e-5
    assert tm.compression_factor == jm.compression_factor == 4 and tm.latent_scale == jm.latent_scale


@pytest.mark.parametrize("size", [8, 9])
def test_strided_conv_pads_as_flax_same(size):
    """T26: flax's SAME at stride 2 pads (0, 1) on an even input and (1, 1)
    on an odd one; a symmetric padding of 1 shifts the even case by a pixel."""
    jconv = nnx.Conv(3, 4, (3, 3), strides=(2, 2), padding="SAME", rngs=nnx.Rngs(0))
    params = _randomize(jconv, 5)
    conv = dc_ae.SameConv2d(3, 4, 3, 2, device="cpu")
    conv.load_state_dict(state_dict_from_jax(params, conv), strict=True)
    x = np.random.default_rng(6).standard_normal((1, size, size, 3)).astype(np.float32)
    ref = np.asarray(jconv(jnp.asarray(x)))
    with torch.no_grad():
        out = conv(torch.from_numpy(x)).numpy()
        symmetric = conv.conv(torch.from_numpy(x), 1).numpy()
    assert dc_ae.same_padding(size, 3, 2) == ((0, 1) if size % 2 == 0 else (1, 1))
    assert out.shape == ref.shape
    assert rel_err(out, ref) <= 1e-6
    if size % 2 == 0:
        assert rel_err(symmetric, ref) > 1e-2
    else:
        np.testing.assert_array_equal(symmetric, out)


def test_space_depth_channel_order_matches_jax():
    x = np.random.default_rng(7).standard_normal((2, 4, 6, 5)).astype(np.float32)
    s2d = dc_ae._space_to_depth(torch.from_numpy(x))
    np.testing.assert_array_equal(s2d.numpy(), np.asarray(jdc._space_to_depth(jnp.asarray(x))))
    unshuffled = F.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(s2d.numpy(), unshuffled.numpy())
    np.testing.assert_array_equal(dc_ae._depth_to_space(s2d).numpy(), x)
    y = np.random.default_rng(8).standard_normal((2, 3, 2, 8)).astype(np.float32)
    np.testing.assert_array_equal(dc_ae._depth_to_space(torch.from_numpy(y)).numpy(),
                                  np.asarray(jdc._depth_to_space(jnp.asarray(y))))


def diffusers_key(name: str) -> str:
    """diffusers AutoencoderDC's name of a port DCAE state-dict entry: the
    RMSNorms' ``scale`` is ``weight``, a multi-scale conv sits under ``.proj``."""
    key = name.replace(".scale", ".weight")
    if ".to_qkv_multiscale." in key:
        stem, leaf = key.rsplit(".", 1)
        key = f"{stem}.proj.{leaf}"
    return key


def diffusers_dc_ae_state_dict(model: dc_ae.DCAE, seed: int) -> dict[str, np.ndarray]:
    """A random state dict in diffusers' names for ``model``'s architecture."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, value in model.state_dict().items():
        key = diffusers_key(name)
        out[key] = (rng.standard_normal(tuple(value.shape)) * (0.2 if value.ndim > 1 else 0.05)
                    + (1.0 if key.endswith("norm.weight") or key.endswith("norm_out.weight") else 0.0)
                    ).astype(np.float32)
    return out


def test_load_dc_ae_state_dict_matches_jax():
    tm = dc_ae.DCAE(**TINY_DCAE, device="cpu")
    sd = diffusers_dc_ae_state_dict(tm, 9)
    jm = nnx.eval_shape(lambda: jdc.DCAE(**TINY_DCAE, rngs=nnx.Rngs(0)))
    _randomize(jm, 0)  # concrete arrays, which the loader then overwrites
    jdc.load_dc_ae_state_dict(jm, sd)
    dc_ae.load_dc_ae_state_dict(tm, sd)
    x = np.random.default_rng(10).uniform(0, 255, (1, 16, 16, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.__call__)(jnp.asarray(x)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    assert rel_err(out, ref) <= 1e-5
    with pytest.raises(ValueError, match="unmatched checkpoint keys"):
        dc_ae.load_dc_ae_state_dict(tm, {**sd, "encoder.extra.weight": np.zeros(1, np.float32)})
    with pytest.raises(KeyError, match="missing checkpoint key"):
        dc_ae.load_dc_ae_state_dict(tm, {k: v for k, v in sd.items() if k != "decoder.conv_out.bias"})


def _write_images(root, n: int = 4, size: int = 16) -> None:
    rng = np.random.default_rng(11)
    with ShardedDatasetWriter(root, shard_size=3) as writer:
        for i in range(n):
            writer.write({"image": rng.integers(0, 256, (size, size, 3), dtype=np.uint8), "label": np.int64(i % 3)})


@pytest.mark.parametrize("tower", ["dcae", "flux2"])
def test_compute_on_dataset_matches_jax(tower, tmp_path):
    """The tower's latents column against the JAX package's shards, batch 2
    over 4 images in shards of 3, seed 5."""
    src = tmp_path / "src"
    _write_images(src)
    if tower == "dcae":
        jm, tm = _pair(12)
    else:  # tower_pair's towers, the JAX one built from shapes (its eager init is slow) and then loaded
        from diffulab_tpu.networks.vision_towers.flux2 import Flux2VAE as JaxFlux2VAE
        from diffulab_tpu.networks.vision_towers.vae import load_autoencoder_kl_state_dict as jax_load
        from diffulab_tpu_torch.networks.vision_towers.flux2 import Flux2VAE
        from diffulab_tpu_torch.networks.vision_towers.vae import load_autoencoder_kl_state_dict

        sd = diffusers_vae_state_dict(13, **TINY_TOWER)
        jm = nnx.eval_shape(lambda: JaxFlux2VAE(**TINY_TOWER, rngs=nnx.Rngs(0)))
        _randomize(jm, 0)
        jax_load(jm.encoder, jm.decoder, sd)
        tm = Flux2VAE(**TINY_TOWER, device="cpu")
        load_autoencoder_kl_state_dict(tm.encoder, tm.decoder, sd)
    jm.compute_on_dataset(str(src), str(tmp_path / "jax"), batch_size=2, seed=5)
    tm.compute_on_dataset(src, tmp_path / "port", batch_size=2, seed=5)
    ref, ours = JaxShardedDataset(tmp_path / "jax"), ShardedDataset(tmp_path / "port")
    assert len(ours) == len(ref) == 4 and sorted(ours.columns) == sorted(ref.columns) == ["image", "label",
                                                                                          "vision_latents"]
    for i in range(4):
        a, b = ours[i], ref[i]
        np.testing.assert_array_equal(a["image"], b["image"])
        assert a["label"] == b["label"]
        assert a["vision_latents"].dtype == np.float32
        assert rel_err(a["vision_latents"], b["vision_latents"]) <= 1e-5, i
    if tower == "flux2":  # the stochastic encode drew noise: the latents are not the posterior mean
        with torch.no_grad():
            mean = tm.encode(torch.as_tensor(ours[0]["image"][None], dtype=torch.float32)).numpy()[0]
        assert rel_err(ours[0]["vision_latents"], mean) > 1e-3


def test_full_width_dcae_tree_matches_jax():
    """The config's tower (f32c32, ~365M parameters): the port's parameter
    names and shapes against the JAX tree, drawn from shapes alone."""
    cfg = compose_config(CONFIG_DIR, "train_imagenet_flow_matching_repa")
    assert cfg["vision_tower"]["_target_"] == "diffulab_tpu.networks.vision_towers.dc_ae.DCAE"
    abstract = nnx.eval_shape(lambda: jdc.DCAE(latent_channels=32, scaling_factor=0.41407, rngs=nnx.Rngs(0)))
    tm = instantiate(cfg["vision_tower"], device="meta")
    ours = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert ours == bridged_shapes(abstract, tm)
    n = sum(p.numel() for p in tm.parameters())
    assert 3.5e8 < n < 3.8e8
    assert isinstance(tm, dc_ae.DCAE) and tm.compression_factor == 32 and tm.latent_channels == 32
