"""The fp32 K1 and K2 at the ADM UNet's head dims 192 and 384
(``train_synthetic_ddpm.yaml``: 96 channels x 4 and x 8 over 2 heads),
emulated on the CPU at their designs' arithmetic and tiles, against the JAX
kernels run in interpret mode in fp32; and the dispatch rules at those dims.

The fp32 instances form every product as 3xTF32 on the tensor cores
(``ops/fused_mha.py::matmul_3xtf32`` emulates it). K1 runs one pass over
ring slots of ``f32_keys(d)`` keys (32 at D = 192, 16 at D = 384) with an
online softmax; at D = 384 two CTAs split the output columns, which changes
no sum. K2 runs the dq kernel that forms s and dp again (``kept=False``: q's
and dO's fragments do not fit in registers above D = 64), then the dk/dv
kernel, whose CTAs split dk's and dv's columns above D = 128. Shapes as the
fused route hands them over: S = 128, padded from the UNet's 64 or 16
tokens with the padding key mask, and unpadded. Tolerances are those of
``tests/test_torch_port_fp32_tiles.py`` and of ``chip_smoke.py``: o within
atol 2e-5 + rtol 2e-5, lse within atol 1e-4 + rtol 1e-5, each gradient
within 2e-5·(max|ref| + |ref|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffulab_tpu.ops.attention import use_fused as jax_use_fused
from diffulab_tpu.ops.fused_mha import _mha_backward, _mha_forward
from diffulab_tpu_torch.ops import dot_product_attention
from diffulab_tpu_torch.ops.attention import use_fused
from diffulab_tpu_torch.ops.fused_mha import (
    F32_ONLY_HEAD_DIMS,
    LAUNCHES,
    check_head_dim,
    f32_keys,
    fused_mha,
    fused_mha_bwd_reference,
    fused_mha_bwd_tf32x3_emulation,
    fused_mha_reference,
    fused_mha_tf32x3_emulation,
)

O_TOL = (2e-5, 2e-5)
LSE_TOL = (1e-4, 1e-5)
GRAD_TOL = 2e-5

#: (Sq, Skv, D, valid keys of each batch row or None)
CASES = {
    "d192_ds4_padded": (128, 128, 192, (64, 64)),
    "d192_unmasked": (128, 128, 192, None),
    "d384_ds8_padded": (128, 128, 384, (16, 16)),
    "d384_ragged": (64, 128, 384, (128, 37)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(case):
    sq, skv, d, valid = CASES[case]
    rng = np.random.default_rng(sq + skv + d + (0 if valid is None else sum(valid)))
    b, h = 2, 1
    q, do = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, skv, h, d)).astype(np.float32) for _ in range(2))
    mask = None if valid is None else np.arange(skv)[None, :] < np.asarray(valid)[:, None]
    return q, k, v, do, mask, d ** -0.5


def _close(ours, ref, atol, rtol, label):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    finite = np.isfinite(ref)
    assert np.array_equal(np.isfinite(ours), finite), f"{label}: non-finite values differ"
    err = np.abs(ours[finite] - ref[finite])
    assert np.all(err <= atol + rtol * np.abs(ref[finite])), f"{label}: max err {err.max():.3e}"


def _within(ours, ref, label):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    bound = GRAD_TOL * (np.abs(ref).max() + np.abs(ref))
    assert np.all(np.abs(ours - ref) <= bound), f"{label}: max err {np.abs(ours - ref).max():.3e}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_k1_tiles_at_the_unet_head_dims_match_the_jax_kernel(case):
    q, k, v, _, mask, scale = _inputs(case)
    jmask = None if mask is None else jnp.asarray(mask)
    jo, jlse = _mha_forward(*(jnp.asarray(a) for a in (q, k, v)), jmask, scale, True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    o, lse = fused_mha_tf32x3_emulation(tq, tk, tv, tmask, scale)
    _close(o.numpy(), np.asarray(jo), *O_TOL, "o vs JAX")
    _close(lse.numpy(), np.asarray(jlse), *LSE_TOL, "lse vs JAX")
    ro, rlse = fused_mha_reference(tq, tk, tv, tmask, scale)
    _close(o.numpy(), ro.numpy(), *O_TOL, "o vs plain")
    _close(lse.numpy(), rlse.numpy(), *LSE_TOL, "lse vs plain")


@pytest.mark.parametrize("case", sorted(CASES))
def test_k2_split_at_the_unet_head_dims_matches_the_jax_kernel(case):
    q, k, v, do, mask, scale = _inputs(case)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jmask = None if mask is None else jnp.asarray(mask)
    _, jlse = _mha_forward(jq, jk, jv, jmask, scale, True)
    jax_grads = _mha_backward(jq, jk, jv, jmask, jlse, jdo, scale, True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tmask = None if mask is None else torch.from_numpy(mask)
    lse = torch.from_numpy(np.array(jlse))
    *grads, _ = fused_mha_bwd_tf32x3_emulation(tq, tk, tv, tmask, lse, tdo, scale, kept=False)
    plain = fused_mha_bwd_reference(tq, tk, tv, tmask, lse, tdo, scale)
    for label, g, r, pr in zip(("dq", "dk", "dv"), grads, jax_grads, plain):
        _within(g.numpy(), np.asarray(r), f"{label} vs JAX")
        _within(g.numpy(), pr.numpy(), f"{label} vs plain")
    if mask is not None and mask[0].sum() < mask.shape[1]:  # padded keys get exactly zero dk and dv
        n = int(mask[0].sum())
        assert all((g[0, n:] == 0).all() for g in grads[1:])


def test_k1_key_tile_by_head_dim():
    assert [f32_keys(d) for d in (16, 64, 128, 192, 384)] == [32, 32, 32, 32, 16]


@pytest.mark.parametrize("shape", [(128, 64, 2, 192), (128, 16, 2, 384), (32, 64, 2, 192), (32, 16, 2, 384)])
def test_the_unet_shapes_take_the_fused_route_on_both_sides(shape):
    # 64 and 16 tokens pad to 128 (MIN_BLOCK) on both sides: K1/K2 cases, as on the TPU
    assert use_fused(shape, shape[1]) and jax_use_fused(shape, shape[1], backend="tpu")


def test_auto_runs_the_fused_route_at_the_unet_head_dims_in_fp32():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 2, 384)).astype(np.float32)) for _ in range(3))
    ours = dot_product_attention(q, k, v)
    ref = dot_product_attention(q, k, v, impl="xla")  # K1's plain version on the padded inputs
    torch.testing.assert_close(ours, ref, rtol=0, atol=0)
    jref = _mha_forward(*(jnp.asarray(np.pad(t.numpy(), ((0, 0), (0, 112), (0, 0), (0, 0)))) for t in (q, k, v)),
                        jnp.asarray(np.arange(128)[None].repeat(2, 0) < 16), 384 ** -0.5, True)[0]
    _close(ours.numpy(), np.asarray(jref)[:, :16], *O_TOL, "auto vs JAX")


@pytest.mark.parametrize("d", F32_ONLY_HEAD_DIMS)
def test_bf16_at_the_fp32_only_head_dims_raises_naming_queue_2a(d):
    q = torch.zeros(1, 64, 2, d, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="queue 2a"):
        dot_product_attention(q, q, q)
    with pytest.raises(NotImplementedError, match="queue 2a"):
        check_head_dim(d, torch.bfloat16)
    check_head_dim(d, torch.float32)
    # past the fused kernel's 512 tokens the flash kernels would take it: not instantiated above D = 128
    long = torch.zeros(1, 600, 2, d)
    with pytest.raises(NotImplementedError, match="queue 2a"):
        dot_product_attention(long, long, long)


def test_the_fp32_only_instances_have_launch_counters_of_their_own():
    assert {f"fused_mha_{kind}_f32_d{d}" for kind in ("fwd", "bwd") for d in F32_ONLY_HEAD_DIMS} <= set(LAUNCHES)
    # on the CPU the wrappers run the plain versions and count nothing
    before = dict(LAUNCHES)
    q = torch.zeros(1, 64, 1, 192)
    fused_mha(q, q, q)
    assert LAUNCHES == before
