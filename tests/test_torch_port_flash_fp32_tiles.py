"""The fp32 K3, K4 and K5 at their designs' arithmetic and tiles, emulated on
the CPU, against the JAX flash kernels run in interpret mode in fp32.

On the card the fp32 flash forward (K3), dk/dv kernel (K4) and dq kernel (K5) form every
product on the tensor cores as 3xTF32 (``csrc/tf32x3.cuh``: each operand split
into ``hi = tf32(x)`` and ``lo = x - hi``, ``lo·hi + hi·lo + hi·hi``
accumulated in fp32). ``ops/flash_attention.py`` emulates their tile math:
K3 in one pass over tiles of ``f32_fwd_keys`` keys with the scores in log2
units, an online row max and sum and o divided by l at the end
(``flash_attention_tf32x3_emulation``); K4 over query tiles of
``f32_dkv_queries`` from the pre-pass's ``di = rowsum(o·do)`` and ``lse·log2
e`` (``flash_attention_bwd_dkv_tf32x3_emulation``); K5 over key tiles of
``f32_dq_keys`` from K3's lse and that di, each tile's dq summed from zero
(``flash_attention_bwd_dq_tf32x3_emulation``). The emulations are held
here to the JAX path ``_flash_path(..., interpret=True)`` (its o; its lse
from ``_flash_forward`` on the same padded inputs) and to ``jax.vjp`` of it
(dq, dk and dv, the backward fed the JAX forward's o and lse; one vjp a case,
shared by the K4 and K5 tests), and to the port's plain versions, which the
card holds the kernels to, at the tolerances of ``chip_smoke.py``: o within
atol 2e-5 + rtol 2e-5, lse within atol 1e-4 + rtol 1e-5, dq, dk and dv
within 2e-5·(max|ref| + |ref|). The difference is the
split products (about 2^-21 relative each), exp2 in place of exp, and the
summation order. Cases: Sq=100 with Skv=300; Skv=600 (padded to 1024 by the
JAX path); a key mask with a whole masked 64-key block (a whole fp32 K3 tile
at D = 64, half an fp32 K4 CTA, a whole K5 tile that K5 skips); a
fully-masked row (o exactly 0, lse +inf, dq, dk and dv of it exactly 0); Sq
≠ Skv; head dims 16, 32, 64 and 128; a scale override.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffulab_tpu.ops.attention import TUNED_BLOCK_K, TUNED_BLOCK_Q, _flash_path, _pad_target, _pad_to
from diffulab_tpu.ops.flash_attention import _flash_forward
from diffulab_tpu_torch.ops.flash_attention import (
    BWD_ROW_ALIGN,
    f32_dkv_queries,
    f32_dq_keys,
    f32_fwd_keys,
    flash_attention_bwd_dkv_tf32x3_emulation,
    flash_attention_bwd_dq_tf32x3_emulation,
    flash_attention_bwd_reference,
    flash_attention_reference,
    flash_attention_tf32x3_emulation,
)
from diffulab_tpu_torch.ops.fused_mha import KERNEL_HEAD_DIMS

O_TOL = (2e-5, 2e-5)
LSE_TOL = (1e-4, 1e-5)
GRAD_TOL = 2e-5
jax_flash = functools.partial(_flash_path, interpret=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


#: (Sq, Skv, D, key mask kind, scale override)
CASES = {
    "sq100_skv300_d64": (100, 300, 64, None, None),
    "skv600_padded_to_1024_d32": (600, 600, 32, "lengths", None),
    "hole_64_keys_d64": (128, 256, 64, "hole", None),
    "dead_row_d64": (90, 200, 64, "dead_row", None),
    "cross_sq192_skv80_d16": (192, 80, 16, "lengths", None),
    "ragged_sq70_skv130_d128": (70, 130, 128, "lengths", None),
    "scale_0.3_d64": (128, 128, 64, None, 0.3),
}


def _mask(kind, skv):
    if kind is None:
        return None
    keys = np.arange(skv)
    if kind == "lengths":
        return keys[None, :] < np.asarray([skv, skv * 3 // 4 + 1])[:, None]
    if kind == "dead_row":
        return np.stack([np.zeros(skv, bool), keys < 131])
    hole = (keys < 64) | (keys >= 128)  # keys 64-127 masked: a whole fp32 K3 key tile at D = 64
    return np.stack([hole, keys < 200])


def _inputs(case):
    sq, skv, d, kind, scale = CASES[case]
    rng = np.random.default_rng(sq * 7 + skv + d)
    b, h = 2, 2
    q, do = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, skv, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do, _mask(kind, skv), scale, kind


@functools.cache
def _jax_forward(case):
    """The JAX path's o ([B, Sq, H, D], as ``_flash_path`` gives it) and lse
    ([B, H, Sq]) from ``_flash_forward`` on the inputs ``_flash_path`` pads."""
    q, k, v, _, mask, scale, _ = _inputs(case)
    b, sq, _, d = q.shape
    skv = k.shape[1]
    sq_p, skv_p = _pad_target(sq), _pad_target(skv)
    jmask = None if mask is None else jnp.asarray(mask)
    if jmask is None and skv_p != skv:
        jmask = jnp.ones((b, skv), dtype=bool)
    qp = jnp.swapaxes(_pad_to(jnp.asarray(q), 1, sq_p), 1, 2)
    kp, vp = (jnp.swapaxes(_pad_to(jnp.asarray(a), 1, skv_p), 1, 2) for a in (k, v))
    maskp = None if jmask is None else _pad_to(jmask, 1, skv_p)
    o, lse = _flash_forward(qp, kp, vp, maskp, d ** -0.5 if scale is None else scale, TUNED_BLOCK_Q, TUNED_BLOCK_K,
                            True)
    return np.swapaxes(np.asarray(o), 1, 2)[:, :sq], np.asarray(lse)[:, :, :sq, 0]


@functools.cache
def _jax_grads(case):
    """(dq, dk, dv) of ``jax.vjp`` of the JAX path at the case's inputs and do:
    one interpret-mode backward a case, for the K4 and K5 tests."""
    q, k, v, do, mask, scale, _ = _inputs(case)
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b_, c: jax_flash(a, b_, c, jmask, scale), *(jnp.asarray(a) for a in (q, k, v)))
    return tuple(np.asarray(g) for g in vjp(jnp.asarray(do)))


def _torch_case(case):
    """The case's inputs as torch tensors, with the JAX forward's o and lse."""
    q, k, v, do, mask, scale, kind = _inputs(case)
    jo, jlse = _jax_forward(case)
    tq, tk, tv, tdo, to, tlse = (torch.from_numpy(a.copy()) for a in (q, k, v, do, jo, jlse))
    tmask = None if mask is None else torch.from_numpy(mask)
    return tq, tk, tv, tdo, tmask, to, tlse, scale, kind


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


def test_tiles_mirror_the_kernels_rules():
    """K3 and K5 walk key tiles of whole 32-key ballot words of mask; K4's
    query tiles divide the workspace's row alignment, so its last tile reads
    whole rows of lse·log2 e and di (+inf and 0 past Sq). chip_smoke.py holds
    these rules to the built libraries' ``flash_attn_{fwd,bwd}_f32_tiles``."""
    for d in KERNEL_HEAD_DIMS:
        assert f32_fwd_keys(d) % 32 == 0
        assert f32_dq_keys(d) % 32 == 0
        assert BWD_ROW_ALIGN % f32_dkv_queries(d) == 0
    assert [f32_fwd_keys(d) for d in KERNEL_HEAD_DIMS] == [64, 64, 64, 32]
    assert [f32_dkv_queries(d) for d in KERNEL_HEAD_DIMS] == [64, 64, 64, 32]
    assert [f32_dq_keys(d) for d in KERNEL_HEAD_DIMS] == [64, 64, 64, 32]


@pytest.mark.parametrize("case", sorted(CASES))
def test_k3_tiles_match_the_jax_kernel(case):
    q, k, v, _, mask, scale, kind = _inputs(case)
    jo, jlse = _jax_forward(case)
    path_o = np.asarray(jax_flash(*(jnp.asarray(a) for a in (q, k, v)), None if mask is None else jnp.asarray(mask),
                                  scale))
    np.testing.assert_array_equal(jo, path_o)  # the lse above is the path's own forward's
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    o, lse = flash_attention_tf32x3_emulation(tq, tk, tv, tmask, scale)
    assert o.shape == tq.shape and o.dtype == torch.float32 and lse.shape == (2, 2, tq.shape[1])
    _close(o.numpy(), jo, *O_TOL, "o vs JAX")
    _close(lse.numpy(), jlse, *LSE_TOL, "lse vs JAX")
    # and the port's plain version, which the card holds the kernel to
    ro, rlse = flash_attention_reference(tq, tk, tv, tmask, scale)
    _close(o.numpy(), ro.numpy(), *O_TOL, "o vs plain")
    _close(lse.numpy(), rlse.numpy(), *LSE_TOL, "lse vs plain")
    if kind == "dead_row":
        assert (o[0] == 0).all() and torch.isposinf(lse[0]).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_k4_tiles_match_the_jax_kernels(case):
    _, jdk, jdv = _jax_grads(case)
    tq, tk, tv, tdo, tmask, to, tlse, scale, kind = _torch_case(case)
    dk, dv, di = flash_attention_bwd_dkv_tf32x3_emulation(tq, tk, tv, tmask, to, tlse, tdo, scale)
    assert di.shape == (2, 2, tq.shape[1]) and dk.shape == tk.shape and dv.shape == tv.shape
    _, pdk, pdv = flash_attention_bwd_reference(tq, tk, tv, tmask, to, tlse, tdo, scale)
    for label, g, r, pr in (("dk", dk, jdk, pdk), ("dv", dv, jdv, pdv)):
        assert g.dtype == torch.float32
        _within(g.numpy(), r, f"{label} vs JAX")
        _within(g.numpy(), pr.numpy(), f"{label} vs plain")
    if kind == "dead_row":  # lse = +inf: p = 0, so no key of the row gets a gradient from it
        assert (di[0] == 0).all() and (dk[0] == 0).all() and (dv[0] == 0).all()
    if kind == "hole":  # the masked block's keys get exactly zero dk and dv
        assert (dk[0, 64:128] == 0).all() and (dv[0, 64:128] == 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_k5_tiles_match_the_jax_kernels(case):
    jdq, _, _ = _jax_grads(case)
    tq, tk, tv, tdo, tmask, to, tlse, scale, kind = _torch_case(case)
    di = (to * tdo).sum(dim=-1).permute(0, 2, 1)  # the pre-pass's rowsum(o·do), [B, H, Sq]
    dq = flash_attention_bwd_dq_tf32x3_emulation(tq, tk, tv, tmask, tlse, di, tdo, scale)
    assert dq.shape == tq.shape and dq.dtype == torch.float32
    _within(dq.numpy(), jdq, "dq vs JAX")
    pdq, _, _ = flash_attention_bwd_reference(tq, tk, tv, tmask, to, tlse, tdo, scale)
    _within(dq.numpy(), pdq.numpy(), "dq vs plain")
    if kind == "dead_row":  # lse = +inf: p = 0 on every key, so dq of the row is exactly 0
        assert (dq[0] == 0).all()
    if kind == "hole":
        # keys 64-127 of row 0 are a whole K5 tile at D = 64, which the kernel skips: the tile adds exact
        # zeros, so dq of row 0 is bitwise the dq over the 192 attended keys alone
        keep = torch.cat([torch.arange(64), torch.arange(128, tk.shape[1])])
        alone = flash_attention_bwd_dq_tf32x3_emulation(tq[:1], tk[:1, keep], tv[:1, keep], None, tlse[:1], di[:1],
                                                        tdo[:1], scale)
        assert torch.equal(dq[:1], alone)
