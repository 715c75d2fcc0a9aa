"""The fp32 K1 and K2 at the ADM UNet's head dims 192 and 384
(``train_synthetic_ddpm.yaml``: 96 channels x 4 and x 8 over 2 heads, 64
tokens at ds 4 and 16 at ds 8), emulated on the CPU at their designs'
arithmetic and tiles, against the JAX kernels run in interpret mode in fp32;
and the dispatch rules at those dims.

The fp32 instances form every product as 3xTF32 on the tensor cores
(``ops/fused_mha.py::matmul_3xtf32`` emulates it). They are built around the
valid rows (``VALID_ROWS_HEAD_DIMS``), as at the MNIST UNet's 256 and 512:
they take the unpadded q, do and lse rows, while k, v and the key mask stay
padded to 128; K1 walks tiles of ``f32_keys(d)`` = 8 keys with an online
softmax and skips a tile whose mask is all 0 (which changes no value, so the
emulation walks every tile), and column groups of warps (96 columns at D =
192, 64 at 384: 2 and 6 groups) split the score products' reduction over
D. K2 runs the dq kernel that forms s and dp again (``kept=False``: q's and
dO's fragments do not fit in registers above D = 64), then the dk/dv kernel
over the valid query rows. The JAX kernels take the reference's padded q
(its ``_fused_path``): the rows are independent, so the valid rows are
compared. Masks: the UNet's padding mask, an empty key tile between live
ones beside a fully masked batch row (o = 0, lse = +inf and zero gradients
there), no mask, and a ragged Sq. Tolerances are those of
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
    LAUNCHES,
    MIN_BLOCK,
    VALID_ROWS_HEAD_DIMS,
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

#: (valid query rows Sq, head dim, mask kind); keys are padded to 128
CASES = {
    "d192_ds4_padded": (64, 192, "padded"),
    "d192_hole_and_dead_row": (64, 192, "hole"),
    "d192_unmasked": (64, 192, None),
    "d192_ragged": (37, 192, "padded"),
    "d384_ds8_padded": (16, 384, "padded"),
    "d384_hole_and_dead_row": (16, 384, "hole"),
    "d384_ragged": (11, 384, "padded"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mask(kind, sq, b):
    """The padding mask (the first sq keys), or: batch row 0 with keys 8-15
    masked and as many valid keys after them (an empty 8-key tile between
    live ones), every other batch row fully masked."""
    keys = np.arange(MIN_BLOCK)
    if kind is None:
        return None
    mask = np.repeat((keys < sq)[None], b, axis=0)
    if kind == "hole":
        mask[0] = (keys < 8) | ((keys >= 16) & (keys < sq + 8))
        mask[1:] = False
    return mask


def _inputs(case):
    sq, d, kind = CASES[case]
    rng = np.random.default_rng(sq + d + len(case))
    b, h = 2, 1
    q, do = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, MIN_BLOCK, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do, _mask(kind, sq, b), d ** -0.5


def _pad_rows(x):
    return np.pad(x, ((0, 0), (0, MIN_BLOCK - x.shape[1])) + ((0, 0),) * (x.ndim - 2))


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


def _jax_forward(q, k, v, mask, scale):
    """The interpret-mode K1 on the reference's padded q, cut to the valid rows."""
    jmask = None if mask is None else jnp.asarray(mask)
    o, lse = _mha_forward(jnp.asarray(_pad_rows(q)), jnp.asarray(k), jnp.asarray(v), jmask, scale, True)
    return np.asarray(o)[:, :q.shape[1]], np.asarray(lse)[:, :q.shape[1]], lse


@pytest.mark.parametrize("case", sorted(CASES))
def test_k1_tiles_at_the_unet_head_dims_match_the_jax_kernel(case):
    q, k, v, _, mask, scale = _inputs(case)
    jo, jlse, _ = _jax_forward(q, k, v, mask, scale)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    o, lse = fused_mha_tf32x3_emulation(tq, tk, tv, tmask, scale)
    assert o.shape == q.shape and lse.shape == q.shape[:3]
    _close(o.numpy(), jo, *O_TOL, "o vs JAX")
    _close(lse.numpy(), jlse, *LSE_TOL, "lse vs JAX")
    ro, rlse = fused_mha_reference(tq, tk, tv, tmask, scale)
    _close(o.numpy(), ro.numpy(), *O_TOL, "o vs plain")
    _close(lse.numpy(), rlse.numpy(), *LSE_TOL, "lse vs plain")
    if CASES[case][2] == "hole":  # the fully masked row: o = 0, lse = +inf
        assert (o[1] == 0).all() and torch.isinf(lse[1]).all() and (lse[1] > 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_k2_split_at_the_unet_head_dims_matches_the_jax_kernel(case):
    q, k, v, do, mask, scale = _inputs(case)
    sq = q.shape[1]
    _, _, jlse = _jax_forward(q, k, v, mask, scale)
    jmask = None if mask is None else jnp.asarray(mask)
    jdq, jdk, jdv = _mha_backward(jnp.asarray(_pad_rows(q)), jnp.asarray(k), jnp.asarray(v), jmask, jlse,
                                  jnp.asarray(_pad_rows(do)), scale, True)
    jax_grads = (np.asarray(jdq)[:, :sq], np.asarray(jdk), np.asarray(jdv))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tmask = None if mask is None else torch.from_numpy(mask)
    lse = torch.from_numpy(np.array(jlse)[:, :sq])
    *grads, _ = fused_mha_bwd_tf32x3_emulation(tq, tk, tv, tmask, lse, tdo, scale, kept=False)
    plain = fused_mha_bwd_reference(tq, tk, tv, tmask, lse, tdo, scale)
    for label, g, r, pr in zip(("dq", "dk", "dv"), grads, jax_grads, plain):
        _within(g.numpy(), r, f"{label} vs JAX")
        _within(g.numpy(), pr.numpy(), f"{label} vs plain")
    if mask is not None:  # masked keys, and every key of a fully masked row, get exactly zero dk and dv
        dead = ~torch.from_numpy(mask)
        assert all((g[dead] == 0).all() for g in grads[1:])
    if CASES[case][2] == "hole":
        assert (grads[0][1] == 0).all()


def test_k1_key_tile_by_head_dim():
    assert [f32_keys(d) for d in (16, 64, 128, 192, 384)] == [32, 32, 32, 8, 8]


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


@pytest.mark.parametrize("d", VALID_ROWS_HEAD_DIMS)
def test_bf16_at_the_fp32_only_head_dims_raises_naming_queue_2a(d):
    # once fp32-only: the fused route now takes bf16 at these dims (K1's plain version on the CPU, the bf16
    # instance on the card); only the flash route, past the fused kernel's 512 tokens, raises naming queue 2a
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, 2, d)).astype(np.float32)).bfloat16() for _ in range(3))
    out = dot_product_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out, dot_product_attention(q, k, v, impl="xla"), rtol=0, atol=0)
    check_head_dim(d)
    with pytest.raises(NotImplementedError, match="queue 2a"):
        check_head_dim(d, "flash")
    # past the fused kernel's 512 tokens the flash kernels would take it: not instantiated above D = 128
    long = torch.zeros(1, 600, 2, d, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="queue 2a"):
        dot_product_attention(long, long, long)


def test_the_fp32_only_instances_have_launch_counters_of_their_own():
    assert {f"fused_mha_{kind}_{dt}_d{d}" for kind in ("fwd", "bwd") for dt in ("f32", "bf16")
            for d in VALID_ROWS_HEAD_DIMS} <= set(LAUNCHES)
    # on the CPU the wrappers run the plain versions and count nothing
    before = dict(LAUNCHES)
    q = torch.zeros(1, 64, 1, 192)
    fused_mha(q, q, q)
    assert LAUNCHES == before
