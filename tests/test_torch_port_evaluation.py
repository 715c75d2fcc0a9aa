"""``training/evaluation.py`` in the port against the JAX package, on the CPU.

- ``feature_statistics``, ``frechet_distance``, ``compute_fid``,
  ``compute_kid``, ``compute_precision_recall`` (streamed in small chunks)
  and ``extract_features`` on seeded features: the port's NumPy copy gives
  the JAX module's numbers within 1e-12 relative (float64 where the
  reference accumulates in float64).
- ``frozen_vit_features``'s ViT-S/4 (patch 4, width 384, 6 blocks of 6
  heads, no registers, no LayerScale, drawn from ``nnx.Rngs(1234)``,
  evaluation.py:245): the port's weights against the JAX draw, every array
  of the same name and shape, the uniform-based and constant ones bitwise,
  every entry within 4 float32 ulps and 1e-6 (``jax_prng``'s normals are
  within 2 ulps; the 0.02 and lecun scales round once more), as
  ``FixedViT``'s are, and at least 99% of them bitwise (trap T24); its features of RGB and of grayscale
  (tiled) batches at a 16-px image within rel 1e-4 of the JAX features
  (fp32, the two frameworks' sums in different orders).
- ``dinov2_features`` maps [-1, 1] input to [0, 1] as the reference does;
  ``evaluate_fid`` scores a sampler's output against the real images;
  ``sample_batches`` (the evaluate CLIs' loop) conditions and seeds each
  batch from its start.
- ``FEATURE_SPACE_VERSION`` is the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from diffulab_tpu.networks.repa.vit import ViTEncoder as JaxViTEncoder
from diffulab_tpu.training import evaluation as jev
from diffulab_tpu_torch.training import evaluation as ev
from diffulab_tpu_torch.weights import state_dict_from_jax

IMAGE = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _features(seed: int, n: int = 300, d: int = 16, shift: float = 0.0, scale: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((d, d)) / np.sqrt(d)
    return ((rng.standard_normal((n, d)) @ mix) * scale + shift).astype(np.float32)


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-12 * max(abs(b), 1e-30)


@pytest.mark.parametrize("shift,scale", [(0.0, 1.0), (0.3, 1.0), (0.0, 1.7)], ids=["same", "shifted", "scaled"])
def test_fid_kid_precision_recall_match_jax(shift, scale):
    real, fake = _features(1), _features(2, n=250, shift=shift, scale=scale)
    mu, sigma = ev.feature_statistics(real)
    jmu, jsigma = jev.feature_statistics(real)
    assert mu.dtype == sigma.dtype == np.float64
    np.testing.assert_array_equal(mu, jmu)
    np.testing.assert_array_equal(sigma, jsigma)
    fmu, fsigma = ev.feature_statistics(fake)
    assert _close(ev.frechet_distance(mu, sigma, fmu, fsigma), jev.frechet_distance(jmu, jsigma, fmu, fsigma))
    assert _close(ev.compute_fid(real, fake), jev.compute_fid(real, fake))
    kid, jkid = ev.compute_kid(real, fake, subset_size=100, n_subsets=10, seed=3), \
        jev.compute_kid(real, fake, subset_size=100, n_subsets=10, seed=3)
    assert all(_close(kid[k], jkid[k]) for k in ("kid", "kid_std"))
    pr, jpr = ev.compute_precision_recall(real, fake, k=3, chunk=64), \
        jev.compute_precision_recall(real, fake, k=3, chunk=64)
    assert pr == jpr
    assert pr == ev.compute_precision_recall(real, fake, k=3)  # the chunking does not change the result


def test_extract_features_batches_like_jax():
    images = np.random.default_rng(4).uniform(-1, 1, (10, 4, 4, 3)).astype(np.float32)

    def fn(batch):
        return batch.reshape(len(batch), -1)[:, :5] * len(batch)  # depends on the batching

    np.testing.assert_array_equal(ev.extract_features(images, fn, 4), jev.extract_features(images, fn, 4))


@pytest.fixture(scope="module")
def jax_vit():
    return JaxViTEncoder(img_size=IMAGE, patch_size=4, embed_dim=384, depth=6, num_heads=6, num_register_tokens=0,
                         layerscale=False, rngs=nnx.Rngs(1234))


def test_frozen_vit_weights_are_the_jax_draw(jax_vit):
    ref = {"/".join(str(p) for p in path): np.asarray(v.get_value())
           for path, v in nnx.state(jax_vit, nnx.Param).flat_state()}
    enc = ev.frozen_vit(IMAGE, device="cpu")
    want = state_dict_from_jax(ref, enc)
    ours = {name: p.detach().numpy() for name, p in enc.named_parameters()}
    assert set(ours) == set(want) and len(ours) == len(ref) and not any(p.requires_grad for p in enc.parameters())
    exact = total = 0
    for name, value in ours.items():
        w = want[name].numpy()
        assert value.shape == w.shape and value.dtype == w.dtype == np.float32, name
        ulps = np.abs(value.view(np.int32).astype(np.int64) - w.view(np.int32).astype(np.int64))
        assert ulps.max() <= 4 and np.abs(value - w).max() <= 1e-6, name
        if name.endswith(("bias", "cls_token")) or "norm" in name:
            np.testing.assert_array_equal(value, w, err_msg=name)
        exact += int((ulps == 0).sum())
        total += ulps.size
    assert exact >= 0.99 * total


@pytest.mark.parametrize("channels", [3, 1], ids=["rgb", "gray"])
def test_frozen_vit_features_match_jax(channels):
    batch = np.random.default_rng(5).uniform(-1, 1, (4, IMAGE, IMAGE, channels)).astype(np.float32)
    ours = ev.frozen_vit_features(IMAGE, device="cpu")(batch)
    ref = jev.frozen_vit_features(IMAGE)(batch)
    assert ours.shape == ref.shape == (4, 384) and ours.dtype == np.float32
    assert float(np.max(np.abs(ours - ref)) / np.max(np.abs(ref))) < 1e-4


class _Tokens(torch.nn.Module):
    """A stand-in encoder: the pixels as tokens of width 3."""

    def __init__(self):
        super().__init__()
        self.unused = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return x.reshape(x.shape[0], -1, 3)


@pytest.mark.parametrize("lo", [-1.0, 0.0], ids=["pm1", "unit"])
def test_dinov2_features_maps_input_like_jax(lo):
    batch = np.random.default_rng(6).uniform(lo, 1, (3, 4, 4, 3)).astype(np.float32)
    ours = ev.dinov2_features(_Tokens())(batch)
    ref = jev.dinov2_features(lambda x: x.reshape(x.shape[0], -1, 3))(batch)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-6, atol=1e-7)


class _Sampler:
    """A diffuser stand-in whose samples are its generator's uniform draws in [-1, 1]."""

    def __init__(self):
        self.denoiser = _Tokens()

    def generate(self, cond, data_shape, generator, device, **kwargs):
        assert kwargs["clamp_x"] and set(cond) == {"y"} and len(cond["y"]) == data_shape[0]
        return {"x": torch.rand(data_shape, generator=generator, device=device) * 2 - 1}


def test_evaluate_fid_scores_the_samples():
    real = np.random.default_rng(7).uniform(-1, 1, (12, 4, 4, 3)).astype(np.float32)
    labels = {"y": np.arange(12) % 3}

    def fn(batch):
        return batch.reshape(len(batch), -1)[:, :6]

    fid = ev.evaluate_fid(_Sampler(), real, labels, fn, batch_size=5, seed=1)
    again = ev.evaluate_fid(_Sampler(), real, labels, fn, batch_size=5, seed=1)
    assert np.isfinite(fid) and fid > 0 and fid == again


def test_sample_batches_draws_each_batch_from_its_start():
    seen = []

    class Recorder(_Sampler):
        def generate(self, cond, data_shape, generator, device, **kwargs):
            seen.append((int(cond["y"][0]), kwargs["guidance_scale"], kwargs["guide_denoiser"]))
            return super().generate(cond, data_shape, generator, device, **kwargs)

    def cond_fn(start, bsz):
        return {"y": torch.arange(start, start + bsz)}

    guide = object()
    fake = ev.sample_batches(Recorder(), cond_fn, 7, 5, (4, 4, 3), seed=1, device="cpu", guidance_scale=1.5,
                             guide_denoiser=guide)
    assert fake.shape == (7, 4, 4, 3) and fake.dtype == np.float32
    assert seen == [(0, 1.5, guide), (5, 1.5, guide)]
    second = torch.rand((2, 4, 4, 3), generator=torch.Generator().manual_seed(ev._fold_seed(1, 5))) * 2 - 1
    np.testing.assert_array_equal(fake[5:], second.numpy())


def test_feature_space_version_is_the_jax_one():
    assert ev.FEATURE_SPACE_VERSION == jev.FEATURE_SPACE_VERSION
