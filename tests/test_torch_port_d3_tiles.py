"""The bf16 K1 and K2 at the UNets' head dims 192, 256, 384 and 512 (a bf16
UNet, ``trainer.precision_type=bf16``: 64 tokens at D = 192 and 256, 16 at
384 and 512, keys padded to 128), emulated on the CPU at their designs'
arithmetic and tiles, against the JAX kernels run in interpret mode in bf16.

The bf16 instances are built around the valid rows as the fp32 ones are
(``VALID_ROWS_HEAD_DIMS``): the unpadded q, do and lse rows, k, v and the key
mask padded. They are staged: a slot of ``bf16_keys`` keys (64 at D = 192 and
256, 16 at 384 and 512: the UNets' whole live row) gathered from the mask
row's live tiles of ``BF16_LIVE_KEYS`` keys (``bf16_slots``); each warp forms
its rows' scores over the whole of D, the column groups (``bf16_groups``)
splitting only the output columns, so a score is one product of bf16 values
summed in fp32. K1 keeps the reference's rounding: m and l over the whole row
in a first pass over the slots, then ``p = exp(s - m)·(1 / l)`` rounded to
bf16 before PV (an online softmax would round another p); K2 rounds p before
dv and ds before dq and dk, and forms di from the fp32 p. The JAX kernels
take the reference's padded q (its ``_fused_path``): the rows are
independent, so the valid rows are compared. Masks: the UNet's padding mask,
an empty 16-key tile between live ones beside a fully masked batch row (o =
0, lse = +inf and zero gradients there), no mask, a ragged Sq, 512 keys at D
= 192 with 400 of them attended (25 live tiles in 7 slots, so K1's second
pass forms the scores anew), and the slots' edges: one live key past a full
slot (a second slot of one live key), live keys straddling two slots, one
live key in each of two tiles or slots, one query row, more query rows than
a CTA's (where K2 runs as two kernels; else one a batch and head).

Tolerances (``chip_smoke.py``'s for bf16): o within atol 1e-2 + rtol 1e-2
(the two sides round p and o to bf16 at the same places, and an exp or sum
rounded otherwise can flip one rounding by a bf16 step, 2^-8 relative), lse
within atol 1e-4 + rtol 1e-5 (fp32 sums of exact products), each gradient
within 1e-2·(max|ref| + |ref|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffulab_tpu.ops.fused_mha import _mha_backward, _mha_forward
from diffulab_tpu_torch.ops.fused_mha import (
    BF16_LIVE_KEYS,
    KERNEL_HEAD_DIMS,
    MIN_BLOCK,
    VALID_ROWS_HEAD_DIMS,
    bf16_groups,
    bf16_keys,
    bf16_rows,
    bf16_slots,
    fused_mha_bf16_valid_emulation,
    fused_mha_bwd_bf16_valid_emulation,
    fused_mha_bwd_reference,
    fused_mha_reference,
)

O_TOL = (1e-2, 1e-2)
LSE_TOL = (1e-4, 1e-5)
GRAD_TOL = 1e-2

#: (valid query rows Sq, head dim, mask kind, padded keys)
CASES = {
    "d192_ds4_padded": (64, 192, "padded", 128),
    "d192_hole_and_dead_row": (64, 192, "hole", 128),
    "d192_ragged": (37, 192, "padded", 128),
    "d192_512_keys": (64, 192, "long", 512),
    "d256_ds4_padded": (64, 256, "padded", 128),
    "d256_unmasked": (64, 256, None, 128),
    "d384_ds8_padded": (16, 384, "padded", 128),
    "d384_ragged": (11, 384, "padded", 128),
    "d512_ds8_padded": (16, 512, "padded", 128),
    "d512_hole_and_dead_row": (16, 512, "hole", 128),
    # the staged slots' edges: the attended keys [lo, hi) of 128
    "d192_kept_plus_one": (64, 192, ((0, 65),), 128),
    "d192_straddle": (64, 192, ((40, 120),), 128),
    "d192_one_key_tiles": (64, 192, ((37, 38), (100, 101)), 128),
    "d192_sq1": (1, 192, ((0, 64),), 128),
    "d256_sq1": (1, 256, ((0, 64),), 128),
    "d384_kept_plus_one": (16, 384, ((0, 17),), 128),
    "d384_straddle": (16, 384, ((8, 24),), 128),
    "d512_one_key_slots": (16, 512, ((5, 6), (100, 101)), 128),
    # more query rows than a CTA's: K2 as two kernels, dq then dk/dv
    "d192_split_sq100": (100, 192, ((0, 100),), 128),
    "d384_split_sq40": (40, 384, ((0, 40),), 128),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mask(kind, sq, b, skv):
    """The padding mask (the first sq keys; 400 of 512 for ``long``; the keys
    of the ranges [lo, hi) of a tuple), or: batch row 0 with keys 16-31 masked and as many
    valid keys after them (an empty 16-key tile between live ones), every
    other batch row fully masked."""
    keys = np.arange(skv)
    if kind is None:
        return None
    if isinstance(kind, tuple):
        return np.repeat(np.any([(keys >= lo) & (keys < hi) for lo, hi in kind], axis=0)[None], b, axis=0)
    mask = np.repeat((keys < (400 if kind == "long" else sq))[None], b, axis=0)
    if kind == "hole":
        mask[0] = (keys < 16) | ((keys >= 32) & (keys < sq + 16))
        mask[1:] = False
    return mask


def _bf16(rng, shape):
    """A seeded normal draw rounded to bf16, as fp32 numpy (exact) and as a bf16 tensor."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
    return t.float().numpy(), t


def _inputs(case):
    sq, d, kind, skv = CASES[case]
    rng = np.random.default_rng(sq + d + skv + len(case))
    b, h = 2, 2
    (q, tq), (do, tdo) = (_bf16(rng, (b, sq, h, d)) for _ in range(2))
    (k, tk), (v, tv) = (_bf16(rng, (b, skv, h, d)) for _ in range(2))
    mask = _mask(kind, sq, b, skv)
    return (q, k, v, do), (tq, tk, tv, tdo), mask, d ** -0.5


def _jnp(x):
    return jnp.asarray(x, jnp.bfloat16)


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
    """The interpret-mode K1 in bf16 on the reference's padded q, cut to the valid rows."""
    jmask = None if mask is None else jnp.asarray(mask)
    o, lse = _mha_forward(_jnp(_pad_rows(q)), _jnp(k), _jnp(v), jmask, scale, True)
    sq = q.shape[1]
    return np.asarray(o.astype(jnp.float32))[:, :sq], np.asarray(lse)[:, :sq], lse


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_k1_tiles_at_the_unet_head_dims_match_the_jax_kernel(case):
    (q, k, v, _), (tq, tk, tv, _), mask, scale = _inputs(case)
    jo, jlse, _ = _jax_forward(q, k, v, mask, scale)
    tmask = None if mask is None else torch.from_numpy(mask)
    o, lse = fused_mha_bf16_valid_emulation(tq, tk, tv, tmask, scale)
    assert o.dtype == torch.bfloat16 and o.shape == tq.shape and lse.shape == tq.shape[:3]
    _close(o.float().numpy(), jo, *O_TOL, "o vs JAX")
    _close(lse.numpy(), jlse, *LSE_TOL, "lse vs JAX")
    ro, rlse = fused_mha_reference(tq, tk, tv, tmask, scale)
    _close(o.float().numpy(), ro.float().numpy(), *O_TOL, "o vs plain")
    _close(lse.numpy(), rlse.numpy(), *LSE_TOL, "lse vs plain")
    # the rounding order pinned: p normalised before its bf16 rounding leaves o bitwise the plain version's
    # almost everywhere (sums in another order flip a rounding now and then); rounding exp(s - m) and dividing
    # by l after it, as an online softmax would, matches about half of the elements here
    assert float((o == ro).float().mean()) >= 0.99
    if CASES[case][2] == "hole":  # the fully masked row: o = 0, lse = +inf
        assert (o[1] == 0).all() and torch.isinf(lse[1]).all() and (lse[1] > 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_k2_split_at_the_unet_head_dims_matches_the_jax_kernel(case):
    (q, k, v, do), (tq, tk, tv, tdo), mask, scale = _inputs(case)
    sq = q.shape[1]
    _, _, jlse = _jax_forward(q, k, v, mask, scale)
    jmask = None if mask is None else jnp.asarray(mask)
    jgrads = _mha_backward(_jnp(_pad_rows(q)), _jnp(k), _jnp(v), jmask, jlse, _jnp(_pad_rows(do)), scale, True)
    jdq, jdk, jdv = (np.asarray(g.astype(jnp.float32)) for g in jgrads)
    tmask = None if mask is None else torch.from_numpy(mask)
    lse = torch.from_numpy(np.array(jlse)[:, :sq])
    *grads, _ = fused_mha_bwd_bf16_valid_emulation(tq, tk, tv, tmask, lse, tdo, scale)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    plain = fused_mha_bwd_reference(tq, tk, tv, tmask, lse, tdo, scale)
    for label, g, r, pr in zip(("dq", "dk", "dv"), grads, (jdq[:, :sq], jdk, jdv), plain):
        _within(g.float().numpy(), r, f"{label} vs JAX")
        _within(g.float().numpy(), pr.float().numpy(), f"{label} vs plain")
    if mask is not None:  # masked keys, and every key of a fully masked row, get exactly zero dk and dv
        dead = ~torch.from_numpy(mask)
        assert all((g[dead] == 0).all() for g in grads[1:])
    if CASES[case][2] == "hole":
        assert (grads[0][1] == 0).all()


def test_bf16_tile_rules():
    # the staged slot: the UNets' whole live row (64 keys at D = 192 and 256, 16 at 384 and 512) in one slot
    # gathered from 16-key liveness tiles; column groups that split only the output columns, each warp forming
    # its rows' scores over the whole of D; a head's valid rows a CTA
    assert [(bf16_keys(d), bf16_groups(d), bf16_groups(d, backward=True), bf16_rows(d))
            for d in VALID_ROWS_HEAD_DIMS] == [(64, 1, 2, 64), (64, 1, 2, 64), (16, 3, 6, 16), (16, 4, 4, 16)]
    assert [bf16_keys(d) for d in KERNEL_HEAD_DIMS] == [0, 0, 0, 0]
    assert BF16_LIVE_KEYS == 16
    # the slots of a row: its live 16-key tiles in order, a slot's worth at a time
    row = torch.zeros(128, dtype=torch.bool)
    row[[3, 40, 41, 99]] = True
    assert [t.tolist() for t in bf16_slots(row, 128, 384)] == [list(range(16)), list(range(32, 48)),
                                                                list(range(96, 112))]
    assert [t.tolist() for t in bf16_slots(row, 128, 192)] == [list(range(16)) + list(range(32, 48))
                                                               + list(range(96, 112))]
    assert [t.numel() for t in bf16_slots(None, 512, 256)] == [64] * 8
    assert [t.tolist() for t in bf16_slots(row, 128, 64)] == [list(range(64)), list(range(64, 128))]
