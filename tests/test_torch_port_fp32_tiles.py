"""The fp32 K1 and K2 at their designs' arithmetic and tiles, emulated on the
CPU, against the JAX kernels run in interpret mode in fp32.

On the card the fp32 instances form every product on the tensor cores as
3xTF32 (``csrc/tf32x3.cuh``): each operand split into ``hi = tf32(x)``,
rounded to nearest with ties away, and ``lo = x - hi``, of which the tensor
cores read the top 19 bits, and ``lo·hi + hi·lo + hi·hi`` accumulated in
fp32. ``ops/fused_mha.py`` emulates that (``tf32_round``, ``split_tf32``,
``matmul_3xtf32``) and the kernels' tile math: K1 in one pass over tiles of
``F32_KEYS`` (32) keys with an online row max and sum and o divided by l at
the end (``fused_mha_tf32x3_emulation``), K2 as its dq kernel's di pass and
dq, then its dk/dv kernel (``fused_mha_bwd_tf32x3_emulation``). The
emulations are held here to the JAX ``_mha_forward`` / ``_mha_backward`` at
the tolerances ``chip_smoke.py`` holds the CUDA kernels to against their
plain versions: o within atol 2e-5 + rtol 2e-5, lse within atol 1e-4 + rtol
1e-5, each gradient within 2e-5·(max|ref| + |ref|). The difference is the
split products (about 2^-21 relative each) and the summation order. Cases: a
ragged key mask, a 64-key masked block, a fully-masked row (o exactly 0, lse
+inf, its gradients exactly 0), Sq ≠ Skv, head dims 16/32/64/128, and Skv
64, 256 and 512. The split itself: its error against fp64 stays under 2^-20
of ``|a|@|b|``, where one TF32 product does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffulab_tpu_torch.ops.fused_mha as port_mha
from diffulab_tpu.ops.fused_mha import _mha_backward, _mha_forward
from diffulab_tpu_torch.ops.fused_mha import (
    fused_mha_bwd_reference,
    fused_mha_bwd_tf32x3_emulation,
    fused_mha_reference,
    fused_mha_tf32x3_emulation,
    matmul_3xtf32,
    split_tf32,
    tf32_round,
)

O_TOL = (2e-5, 2e-5)
LSE_TOL = (1e-4, 1e-5)
GRAD_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- the split --------------------------------------------------------------------


def _tf32_by_grid(x: np.ndarray) -> np.ndarray:
    """The nearest value on the TF32 grid (10 mantissa bits), ties away from
    zero, from the spacing of the grid at |x| in fp64."""
    mag = np.abs(x.astype(np.float64))
    spacing = np.exp2(np.floor(np.log2(mag)) - 10)
    return (np.sign(x) * np.floor(mag / spacing + 0.5) * spacing).astype(np.float32)


def test_tf32_round_is_nearest_with_ties_away():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * np.exp2(rng.integers(-20, 20, 4096))).astype(np.float32)
    got = tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _tf32_by_grid(x))
    assert np.all(got.view(np.int32) & 0x1FFF == 0)
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 2 ** -11 + 2 ** -22], dtype=torch.float32)
    assert tf32_round(ties).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, 2 ** -11 + 2 ** -21]


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
@pytest.mark.parametrize("batch, m, kdim, n", [((), 16, 64, 8), ((3,), 16, 512, 64)])
def test_split_product_error_against_fp64_is_under_2_pow_20(batch, m, kdim, n, scale):
    rng = np.random.default_rng(kdim + int(np.log10(scale) + 3))
    a = (rng.standard_normal((*batch, m, kdim)) * scale).astype(np.float32)
    b = rng.standard_normal((*batch, kdim, n)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    size = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    ours = matmul_3xtf32(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.all(np.abs(ours - exact) <= 2.0 ** -20 * size)
    # one TF32 product is not enough: the bound above tells the split from it
    one = (tf32_round(torch.from_numpy(a)) @ tf32_round(torch.from_numpy(b))).numpy()
    assert np.any(np.abs(one - exact) > 2.0 ** -20 * size)
    hi, lo = split_tf32(torch.from_numpy(a))
    assert torch.all(lo.abs() <= hi.abs() * 2.0 ** -11)


# --- K1 and K2 at their tiles, against the JAX kernels -----------------------------

#: (Sq, Skv, D, key mask kind); Sq and Skv multiples of 64 as the kernels take them
CASES = {
    "skv64_d64": (64, 64, 64, None),
    "skv256_d64_ragged": (128, 256, 64, "lengths"),
    "skv512_d32_ragged": (64, 512, 32, "lengths"),
    "cross_sq192_skv128_d16": (192, 128, 16, None),
    "skv256_d128_dead_row": (64, 256, 128, "dead_row"),
    "skv512_d128_hole": (64, 512, 128, "hole"),
    "cross_sq64_skv256_d16_hole": (64, 256, 16, "hole"),
}


def _mask(kind, skv):
    if kind is None:
        return None
    keys = np.arange(skv)
    if kind == "lengths":
        return keys[None, :] < np.asarray([skv, 77])[:, None]
    if kind == "dead_row":
        return np.stack([np.zeros(skv, bool), keys < 131])
    hole = (keys < 64) | (keys >= 128)  # keys 64-127 masked: a whole 64-key block
    return np.stack([hole, keys < 200])


def _inputs(case):
    sq, skv, d, kind = CASES[case]
    rng = np.random.default_rng(sq * 7 + skv + d)
    b, h = 2, 2
    q, do = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, skv, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do, _mask(kind, skv), d ** -0.5, kind


def _close(ours, ref, atol, rtol, label):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    finite = np.isfinite(ref)
    assert np.array_equal(np.isfinite(ours), finite), f"{label}: non-finite values differ"
    err = np.abs(ours[finite] - ref[finite])
    assert np.all(err <= atol + rtol * np.abs(ref[finite])), f"{label}: max err {err.max():.3e}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_k1_tiles_match_the_jax_kernel(case):
    q, k, v, _, mask, scale, kind = _inputs(case)
    jmask = None if mask is None else jnp.asarray(mask)
    jo, jlse = _mha_forward(*(jnp.asarray(a) for a in (q, k, v)), jmask, scale, True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    o, lse = fused_mha_tf32x3_emulation(tq, tk, tv, tmask, scale)
    assert o.shape == tq.shape and o.dtype == torch.float32 and lse.shape == tq.shape[:3]
    _close(o.numpy(), np.asarray(jo), *O_TOL, "o vs JAX")
    _close(lse.numpy(), np.asarray(jlse), *LSE_TOL, "lse vs JAX")
    # and the port's plain version, which the card holds the kernel to
    ro, rlse = fused_mha_reference(tq, tk, tv, tmask, scale)
    _close(o.numpy(), ro.numpy(), *O_TOL, "o vs plain")
    _close(lse.numpy(), rlse.numpy(), *LSE_TOL, "lse vs plain")
    if kind == "dead_row":
        assert (o[0] == 0).all() and torch.isposinf(lse[0]).all()


def _within(ours, ref, label):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    bound = GRAD_TOL * (np.abs(ref).max() + np.abs(ref))
    assert np.all(np.abs(ours - ref) <= bound), f"{label}: max err {np.abs(ours - ref).max():.3e}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_k2_split_matches_the_jax_kernel(case):
    q, k, v, do, mask, scale, kind = _inputs(case)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jmask = None if mask is None else jnp.asarray(mask)
    _, jlse = _mha_forward(jq, jk, jv, jmask, scale, True)
    jax_grads = _mha_backward(jq, jk, jv, jmask, jlse, jdo, scale, True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tmask = None if mask is None else torch.from_numpy(mask)
    lse = torch.from_numpy(np.array(jlse))
    *grads, di = fused_mha_bwd_tf32x3_emulation(tq, tk, tv, tmask, lse, tdo, scale)
    plain = fused_mha_bwd_reference(tq, tk, tv, tmask, lse, tdo, scale)
    assert di.shape == (2, 2, tq.shape[1])
    for label, g, r, pr in zip(("dq", "dk", "dv"), grads, jax_grads, plain):
        assert g.shape == pr.shape and g.dtype == torch.float32
        _within(g.numpy(), np.asarray(r), f"{label} vs JAX")
        _within(g.numpy(), pr.numpy(), f"{label} vs plain")
    if kind == "dead_row":  # lse = +inf: p = 0, so di = 0 and the row's gradients are exactly 0
        assert (di[0] == 0).all() and all((g[0] == 0).all() for g in grads)
    if kind == "hole":  # the masked block's keys get exactly zero dk and dv
        assert all((g[0, 64:128] == 0).all() for g in grads[1:])


@pytest.mark.parametrize("skv, d, keeps, products", [
    (256, 64, True, 7), (320, 64, False, 9), (512, 64, False, 9), (64, 128, False, 9), (320, 32, True, 7),
    (384, 16, True, 7), (448, 16, False, 9),
])
def test_k2_keeps_p_and_dp_where_they_fit(skv, d, keeps, products, monkeypatch):
    """The launch keeps the dq kernel's 64 rows' fp32 p and dp (64 x Skv x 8
    bytes) in shared memory beside its 64-key k/v ring where they fit in 227
    KB and q's and do's split fragments fit in registers (D <= 64):
    ``f32_keeps`` in ``csrc/fused_mha_bwd.cu``, whose product count
    ``chip_smoke.py`` prints from the built library. Each shape runs in the
    form that rule picks for it: C1's 256 keys at D=64 take 7 [Sq x Skv x D]
    products, not 9, and either form matches the JAX kernel with ragged keys."""
    rng = np.random.default_rng(skv + d)
    b, sq, h = 2, 64, 1
    q, do = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, skv, h, d)).astype(np.float32) for _ in range(2))
    mask = np.arange(skv)[None, :] < np.asarray([skv, skv - 45])[:, None]
    scale = d ** -0.5
    jq, jk, jv, jdo, jmask = (jnp.asarray(a) for a in (q, k, v, do, mask))
    _, jlse = _mha_forward(jq, jk, jv, jmask, scale, True)
    jax_grads = _mha_backward(jq, jk, jv, jmask, jlse, jdo, scale, True)

    work = []
    product = port_mha.matmul_3xtf32

    def counted(x, y):
        work.append(torch.broadcast_shapes(x.shape[:-2], y.shape[:-2]).numel() * x.shape[-2] * x.shape[-1]
                    * y.shape[-1])
        return product(x, y)

    monkeypatch.setattr(port_mha, "matmul_3xtf32", counted)
    tq, tk, tv, tdo, tmask = (torch.from_numpy(a) for a in (q, k, v, do, mask))
    *grads, _ = port_mha.fused_mha_bwd_tf32x3_emulation(tq, tk, tv, tmask, torch.from_numpy(np.array(jlse)), tdo,
                                                         scale, kept=keeps)
    assert sum(work) == products * b * h * sq * skv * d
    for label, g, r in zip(("dq", "dk", "dv"), grads, jax_grads):
        _within(g.numpy(), np.asarray(r), f"{label} vs JAX")
