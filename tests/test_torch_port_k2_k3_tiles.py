"""The plain versions of the Hopper K2 and K3 at their designs' splits and
tiles, against the JAX kernels run in interpret mode.

K2 (the fused backward) runs on the flash backward's Hopper kernels: K5's dq
kernel with a first pass that forms ``di = rowsum(p·dp)`` over the whole key
row from the fp32 p and dp (the reference's fused di, not the flash path's
``rowsum(o·do)``, T17), and K4's dk/dv kernel fed that di and the lse.
``fused_mha_bwd_di`` and ``flash_attention_bwd_from_di`` are the plain
versions of that split: chained, they must give ``fused_mha_bwd_reference``'s
gradients up to the fp32 summation order, and the JAX ``_mha_backward``'s in
interpret mode. Tolerances, per gradient ``|ours - ref| <= tol * (max|ref| +
|ref|)``: 1e-5 in fp32 (summation order only); against the plain fused
backward 1e-2 in bf16 (p and ds are rounded to bf16 at the same places, but a
score summed in another order can flip one rounding), against the JAX kernel
the 3e-2 of tests/test_torch_port_attention_grad.py.

K3 (the flash forward) takes one running max per 128-key tile, so its bf16
result depends on the tile: ``flash_attention_reference`` at ``block_k`` =
``KERNEL_BLOCK_N`` = 128 is held against ``_flash_forward`` with 128-key tiles
at ragged lengths (Sq 65, 130, 300; Skv 130, 300), with a 128-key hole in the
key mask and a fully-masked row; the JAX side runs on inputs zero-padded to
whole tiles with the padding keys masked, as ``_flash_path`` pads them.
Tolerances: 2e-5 in fp32 (summation order); in bf16 1e-2 absolute and
relative, one bf16 step (2^-8) of o and a rounding of p that a different fp32
exponent can flip. The CUDA kernels are held against the same plain versions
on the card by chip_smoke.py phases 5 and 8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffulab_tpu.ops.flash_attention import _block_sizes, _flash_forward
from diffulab_tpu.ops.fused_mha import _mha_backward, _mha_forward
from diffulab_tpu_torch.ops.flash_attention import (
    KERNEL_BLOCK_N,
    flash_attention_bwd_from_di,
    flash_attention_reference,
)
from diffulab_tpu_torch.ops.fused_mha import fused_mha_bwd_di, fused_mha_bwd_reference

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _within(ours, ref, tol, label):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    bound = tol * (np.abs(ref).max() + np.abs(ref))
    assert np.all(np.abs(ours - ref) <= bound), f"{label}: max err {np.abs(ours - ref).max():.3e}"


# --- K2: the fused backward as K5 with a di pass, then K4 --------------------------

#: (Sq, Skv, key mask of the two batch rows): lengths are K2's multiples of 64
K2_CASES = {
    "unmasked_128_256": (128, 256, None),
    "masked_keys": (192, 256, "lengths"),
    "fully_masked_row": (128, 192, "dead_row"),
    "key_hole_64": (128, 320, "hole"),
}


def _k2_mask(kind, skv):
    if kind is None:
        return None
    keys = np.arange(skv)
    if kind == "lengths":
        return keys[None, :] < np.asarray([skv, 77])[:, None]
    if kind == "dead_row":
        return np.stack([np.zeros(skv, bool), keys < 131])
    hole = (keys < 64) | (keys >= 128)  # keys 64-127 masked: a whole 64-key block
    return np.stack([hole, keys < 200])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_split_is_k4_and_k5_with_the_fused_di(case, dtype):
    sq, skv, kind = K2_CASES[case]
    b, h, d = 2, 2, 64
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(sq + skv)
    q, do = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, skv, h, d)).astype(np.float32) for _ in range(2))
    mask = _k2_mask(kind, skv)
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    jmask = None if mask is None else jnp.asarray(mask)
    _, jlse = _mha_forward(jq, jk, jv, jmask, scale, True)  # [B, Sq, H]
    jax_grads = _mha_backward(jq, jk, jv, jmask, jlse, jdo, scale, True)

    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    tmask = None if mask is None else torch.from_numpy(mask)
    lse = torch.from_numpy(np.array(jlse))
    di = fused_mha_bwd_di(tq, tk, tv, tmask, lse, tdo, scale)
    assert di.shape == (b, h, sq) and di.dtype == torch.float32
    split = flash_attention_bwd_from_di(tq, tk, tv, tmask, lse.permute(0, 2, 1), di, tdo, scale)
    fused = fused_mha_bwd_reference(tq, tk, tv, tmask, lse, tdo, scale)

    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    for label, g, f, r in zip(("dq", "dk", "dv"), split, fused, jax_grads):
        assert g.dtype == tdt and g.shape == f.shape
        _within(g.float().numpy(), f.float().numpy(), tol, f"{label} vs plain fused")
        _within(g.float().numpy(), np.asarray(r, np.float32), {"float32": 1e-5, "bfloat16": 3e-2}[dtype],
                f"{label} vs JAX")
    if kind == "dead_row":  # lse = +inf: p = 0, so di = 0 and the row's gradients are exactly 0
        assert torch.isposinf(lse[0]).all()
        assert (di[0] == 0).all() and (split[0][0] == 0).all()
        assert all((g[0] == 0).all() for g in split[1:])
    if kind == "hole":  # the masked block's keys get exactly zero dk and dv
        assert all((g[0, 64:128] == 0).all() for g in split[1:])


# --- K3: the flash forward at its 128-key tile -------------------------------------

#: (Sq, Skv, key mask kind)
K3_CASES = {
    "sq65_skv130": (65, 130, None),
    "sq130_skv300_masked": (130, 300, "lengths"),
    "sq300_skv300_hole": (300, 300, "hole"),
    "sq130_skv130_dead_row": (130, 130, "dead_row"),
}


def _k3_mask(kind, skv):
    if kind is None:
        return None
    keys = np.arange(skv)
    if kind == "lengths":
        return keys[None, :] < np.asarray([skv, 131])[:, None]
    if kind == "hole":
        hole = (keys < 128) | (keys >= 256)  # keys 128-255 masked: a whole tile
        return np.stack([hole, keys < 129])
    return np.stack([np.zeros(skv, bool), keys < 100])


def _pad(a: np.ndarray, axis: int, n: int) -> np.ndarray:
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, n - a.shape[axis])
    return np.pad(a, widths)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_plain_forward_matches_jax_at_128_key_tiles(case, dtype):
    assert KERNEL_BLOCK_N == 128
    sq, skv, kind = K3_CASES[case]
    b, h, d, block = 2, 2, 64, KERNEL_BLOCK_N
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(sq * skv)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, h, d)).astype(np.float32) for _ in range(2))
    mask = _k3_mask(kind, skv)
    scale = d ** -0.5

    sq_p, skv_p = (-(-n // block) * block for n in (sq, skv))
    assert _block_sizes(sq_p, skv_p, block, block, d) == (block, block)
    jmask = np.ones((b, skv), bool) if mask is None else mask
    jq = jnp.asarray(np.swapaxes(_pad(q, 1, sq_p), 1, 2), jdt)
    jk, jv = (jnp.asarray(np.swapaxes(_pad(a, 1, skv_p), 1, 2), jdt) for a in (k, v))
    jo, jlse = _flash_forward(jq, jk, jv, jnp.asarray(_pad(jmask, 1, skv_p)), scale, block, block, True)
    ref_o = np.swapaxes(np.asarray(jo, np.float32), 1, 2)[:, :sq]
    ref_lse = np.asarray(jlse)[:, :, :sq, 0]

    tmask = None if mask is None else torch.from_numpy(mask)
    o, lse = flash_attention_reference(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), tmask, scale)
    assert o.dtype == tdt and lse.shape == (b, h, sq)
    tol = {"float32": 2e-5, "bfloat16": 1e-2}[dtype]
    np.testing.assert_allclose(o.float().numpy(), ref_o, atol=tol, rtol=tol)
    finite = np.isfinite(ref_lse)
    np.testing.assert_array_equal(np.isfinite(lse.numpy()), finite)
    np.testing.assert_allclose(lse.numpy()[finite], ref_lse[finite], atol=1e-4, rtol=1e-5)
    if kind == "dead_row":  # o exactly 0 and lse +inf, on both sides
        np.testing.assert_array_equal(o[0].float().numpy(), 0.0)
        np.testing.assert_array_equal(ref_o[0], 0.0)
        assert torch.isposinf(lse[0]).all()


def test_k3_bf16_result_depends_on_the_key_tile():
    # T15 at the tile: the unnormalised p is rounded relative to each tile's
    # running max, so 64- and 128-key tiles round differently in bf16 (and
    # agree in fp32 up to the summation order)
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 128, 2, 64)).astype(np.float32) * 2) for _ in range(3))
    o64, _ = flash_attention_reference(q, k, v, block_k=64)
    o128, _ = flash_attention_reference(q, k, v)
    torch.testing.assert_close(o64, o128, atol=2e-5, rtol=2e-5)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    assert not torch.equal(flash_attention_reference(qb, kb, vb, block_k=64)[0], flash_attention_reference(qb, kb, vb)[0])
