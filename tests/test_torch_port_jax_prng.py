"""``diffulab_tpu_torch.jax_prng`` (JAX's threefry2x32 PRNG in NumPy) and the
port's ``FixedViT`` weights against the JAX package, on the CPU.

- ``key``, ``fold_in``, ``random_bits`` and ``uniform`` (with and without a
  range) bitwise equal to ``jax.random``'s, at several seeds, fold-in data
  and shapes (odd sizes among them);
- ``truncated_normal`` and ``lecun_normal`` to 1e-6 absolute (the erfinv
  polynomial's log1p is NumPy's, not XLA's: measured up to 2.4e-7);
- ``normal`` to 4 float32 ulps of each value (measured up to 3 ulps, where
  the erfinv near +-1 amplifies the last bit of w);
- ``Rngs(seed).params()`` against ``nnx.Rngs(seed).params()``;
- the port's ``FixedViT(img_size=32, patch_size=4, depth=6, seed=4321)``
  (``train_synthetic_ddpm_repa``'s encoder) weight for weight against the
  JAX ``FixedViT``, all 78 arrays, to 1e-6 absolute, and one case at patch 2
  with a smaller ViT;
- importing ``jax_prng`` and the REPA modules pulls in neither ``jax`` nor
  ``diffulab_tpu`` (checked in a fresh interpreter).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from diffulab_tpu.networks.repa.fixed import FixedViT as JaxFixedViT
from diffulab_tpu_torch import jax_prng
from diffulab_tpu_torch.networks.repa import FixedViT
from diffulab_tpu_torch.weights import state_dict_from_jax

SEEDS = (0, 1, 4321, 2**31 - 1, 2**40 + 7, -5)
SHAPES = ((1,), (7,), (3, 5), (2, 3, 4, 5), (1031,))
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _keys(seed: int, data: int):
    return jax.random.fold_in(jax.random.key(seed), data), jax_prng.fold_in(jax_prng.key(seed), data)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_are_bitwise_jax(seed):
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jax.random.key(seed))), jax_prng.key(seed))
    for data in (0, 1, 77, 2**31 + 3, 2**32 - 1):
        ref, ours = _keys(seed, data)
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(ref)), ours)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_and_uniform_are_bitwise_jax(seed, shape):
    ref, ours = _keys(seed, 3)
    np.testing.assert_array_equal(np.asarray(jax.random.bits(ref, shape, jnp.uint32)), jax_prng.random_bits(ours, shape))
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(ref, shape)), jax_prng.uniform(ours, shape))
    lo, hi = np.float32(-0.9544997), np.float32(0.9544997)  # truncated_normal's range at +-2
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(ref, shape, jnp.float32, lo, hi)),
                                  jax_prng.uniform(ours, shape, lo, hi))
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(ref, shape, jnp.float32, -0.3, 2.7)),
                                  jax_prng.uniform(ours, shape, -0.3, 2.7))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_normals_match_jax(seed):
    ref, ours = _keys(seed, 11)
    shape = (4099,)
    want = np.asarray(jax.random.normal(ref, shape))
    got = jax_prng.normal(ours, shape)
    assert np.all(np.abs(got - want) <= 4 * np.spacing(np.abs(want)))
    want = np.asarray(jax.random.truncated_normal(ref, -2, 2, shape))
    got = jax_prng.truncated_normal(ours, -2, 2, shape)
    assert np.abs(got - want).max() <= 1e-6 and got.min() > -2 and got.max() < 2
    for kernel_shape in ((33, 64), (4, 4, 3, 17)):
        want = np.asarray(jax.nn.initializers.lecun_normal()(ref, kernel_shape))
        got = jax_prng.lecun_normal(ours, kernel_shape)
        assert got.dtype == np.float32 and np.abs(got - want).max() <= 1e-6


def test_rngs_params_is_nnx_rngs_params():
    ref, ours = nnx.Rngs(4321), jax_prng.Rngs(4321)
    for _ in range(5):
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(ref.params())), ours.params())


def _jax_flat(module) -> dict[str, np.ndarray]:
    return {"/".join(str(p) for p in path): np.asarray(var.get_value())
            for path, var in nnx.state(module, nnx.Param).flat_state()}


@pytest.mark.parametrize("kwargs,n_arrays", [(dict(img_size=32, patch_size=4, depth=6, seed=4321), 78),
                                             (dict(img_size=16, patch_size=2, embed_dim=64, depth=2, num_heads=4,
                                                   seed=7), 30)],
                         ids=["ddpm_repa_vit", "patch2"])
def test_fixed_vit_weights_equal_the_jax_draw(kwargs, n_arrays):
    ref = {path.removeprefix("_encoder/"): value for path, value in _jax_flat(JaxFixedViT(**kwargs)).items()}
    assert len(ref) == n_arrays
    encoder = FixedViT(**kwargs, device="cpu").encoder
    want = state_dict_from_jax(ref, encoder)  # the JAX draw in the port's layout
    ours = dict(encoder.named_parameters())
    assert set(ours) == set(want) and len(ours) == n_arrays
    worst = max(float((ours[name].detach() - value).abs().max()) for name, value in want.items())
    assert worst <= 1e-6
    assert not any(p.requires_grad for p in ours.values())  # a frozen target


def test_the_prng_and_the_repa_modules_import_no_jax():
    code = ("import sys; import diffulab_tpu_torch.jax_prng, diffulab_tpu_torch.networks.repa, "
            "diffulab_tpu_torch.training.losses, diffulab_tpu_torch.data.synthetic_txt2img; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'diffulab_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
