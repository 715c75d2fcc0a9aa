"""The fp32 K1 and K2 at the MNIST UNet's head dims 256 and 512
(``configs/model/unet.yaml``: 128 channels x 4 and x 8 over 2 heads, 64
tokens at ds 4 and 16 at ds 8), emulated on the CPU at their designs'
arithmetic and tiles, against the JAX kernels run in interpret mode in fp32;
the route that hands them the unpadded query rows; and the UNet's
``AttentionBlock`` at those widths against the JAX block.

K2 at both dims and K1 at 256 are staged (``STAGED_F32_HEAD_DIMS``,
``STAGED_F32_FWD_HEAD_DIMS``, ``f32_staged``): they take the unpadded q, do
and lse rows, while k, v and the key mask stay padded to 128; the live
8-key tiles of the mask row are gathered into slots of 64 keys (16 at D =
512: the UNet's whole live row is one slot), and a score sum runs over D
chunk by chunk, each chunk's 3xTF32 product from zero and the chunks added
in fp32, within one warp (no column groups split the reduction). K1 takes m
and l over the slots, then p = exp(s - m) / l before P.V
(``fused_mha_tf32x3_staged_emulation``); at 512 it is the split instance of
8-key tiles whose 4 column groups add their partial scores
(``fused_mha_tf32x3_emulation``). K2 is one kernel a batch and
head that forms s and dp once, di from the fp32 p and dp, and dq, dk and dv
from them, a head's row blocks of 64 (16) query rows in turn
(``fused_mha_bwd_tf32x3_staged_emulation``). The JAX kernels take the
reference's padded q (its ``_fused_path``): the rows are independent, so the
valid rows are compared. Masks: the UNet's padding mask, an empty key tile
between live ones beside a fully masked batch row (traps T1 and T18: the
interpret-mode kernels, not ``jax.nn.dot_product_attention``, give o = 0 and
lse = +inf there), no mask (two slots at D = 256, eight at 512), a ragged
Sq, and an Sq past a CTA's rows (the row blocks in turn; two slots at 256,
three at 512). Tolerances are those of ``tests/test_torch_port_d1_tiles.py``
and of ``chip_smoke.py``: o within atol 2e-5 + rtol 2e-5, lse within atol
1e-4 + rtol 1e-5, each gradient within 2e-5·(max|ref| + |ref|); the block's
output within atol 1e-5 + rtol 1e-5 and its gradients within 1e-4 of each
tensor's largest (``tests/test_torch_port_unet.py``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import _randomize
from flax import nnx

import diffulab_tpu.networks.denoisers.unet as jax_unet
import diffulab_tpu_torch.networks.denoisers.unet as port_unet
import diffulab_tpu_torch.ops.attention as attention
from diffulab_tpu.ops.fused_mha import _mha_backward, _mha_forward
from diffulab_tpu_torch.ops import dot_product_attention
from diffulab_tpu_torch.ops.fused_mha import (
    MIN_BLOCK,
    F32_STAGED_FWD_CHUNK,
    F32_STAGED_FWD_ROWS,
    STAGED_F32_FWD_HEAD_DIMS,
    STAGED_F32_HEAD_DIMS,
    VALID_ROWS_HEAD_DIMS,
    F32Staged,
    f32_groups,
    f32_keys,
    f32_slots,
    f32_staged,
    fused_mha,
    fused_mha_bwd_reference,
    fused_mha_bwd_tf32x3_emulation,
    fused_mha_bwd_tf32x3_staged_emulation,
    fused_mha_reference,
    fused_mha_tf32x3_emulation,
    fused_mha_tf32x3_staged_emulation,
    takes_valid_rows,
)
from diffulab_tpu_torch.weights import state_dict_from_jax

O_TOL = (2e-5, 2e-5)
LSE_TOL = (1e-4, 1e-5)
GRAD_TOL = 2e-5

#: (valid query rows Sq, head dim, mask kind); keys are padded to 128
CASES = {
    "d256_ds4_padded": (64, 256, "padded"),
    "d256_hole_and_dead_row": (64, 256, "hole"),
    "d256_unmasked": (64, 256, None),
    "d256_ragged": (37, 256, "padded"),
    "d256_past_rows": (100, 256, "padded"),
    "d512_ds8_padded": (16, 512, "padded"),
    "d512_hole_and_dead_row": (16, 512, "hole"),
    "d512_unmasked": (16, 512, None),
    "d512_ragged": (9, 512, "padded"),
    "d512_past_rows": (40, 512, "padded"),
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
    b, h = 2, 2
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
def test_k1_tiles_at_the_mnist_head_dims_match_the_jax_kernel(case):
    q, k, v, _, mask, scale = _inputs(case)
    jo, jlse, _ = _jax_forward(q, k, v, mask, scale)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    o, lse = fused_mha_tf32x3_emulation(tq, tk, tv, tmask, scale)
    assert o.shape == q.shape and lse.shape == q.shape[:3]
    # the general emulation takes the staged instance's arithmetic at 256, the split instance's at 512
    if CASES[case][1] in STAGED_F32_FWD_HEAD_DIMS:
        so, slse = fused_mha_tf32x3_staged_emulation(tq, tk, tv, tmask, scale)
        assert torch.equal(so, o) and torch.equal(slse, lse)
    else:
        with pytest.raises(ValueError):
            fused_mha_tf32x3_staged_emulation(tq, tk, tv, tmask, scale)
    _close(o.numpy(), jo, *O_TOL, "o vs JAX")
    _close(lse.numpy(), jlse, *LSE_TOL, "lse vs JAX")
    ro, rlse = fused_mha_reference(tq, tk, tv, tmask, scale)
    _close(o.numpy(), ro.numpy(), *O_TOL, "o vs plain")
    _close(lse.numpy(), rlse.numpy(), *LSE_TOL, "lse vs plain")
    if CASES[case][2] == "hole":  # the fully masked row: o = 0, lse = +inf (T1)
        assert (o[1] == 0).all() and torch.isinf(lse[1]).all() and (lse[1] > 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_k2_split_at_the_mnist_head_dims_matches_the_jax_kernel(case):
    """The staged one-kernel K2 (the name is kept from the split pair of
    kernels that ran these dims before it)."""
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
    *grads, di = fused_mha_bwd_tf32x3_staged_emulation(tq, tk, tv, tmask, lse, tdo, scale)
    *general, _ = fused_mha_bwd_tf32x3_emulation(tq, tk, tv, tmask, lse, tdo, scale)
    assert all(torch.equal(a, b) for a, b in zip(general, grads))
    plain = fused_mha_bwd_reference(tq, tk, tv, tmask, lse, tdo, scale)
    for label, g, r, pr in zip(("dq", "dk", "dv"), grads, jax_grads, plain):
        _within(g.numpy(), r, f"{label} vs JAX")
        _within(g.numpy(), pr.numpy(), f"{label} vs plain")
    if mask is not None:  # masked keys, and every key of a fully masked row, get exactly zero dk and dv (T18)
        dead = ~torch.from_numpy(mask)
        assert all((g[dead] == 0).all() for g in grads[1:])
    if CASES[case][2] == "hole":
        assert (grads[0][1] == 0).all()


def test_the_tile_rules_at_the_mnist_head_dims():
    # every UNet head dim (the D1 UNet's 192 and 384 too) is built around the valid rows; the MNIST UNet's are staged
    assert VALID_ROWS_HEAD_DIMS == (192, 256, 384, 512) and STAGED_F32_HEAD_DIMS == (256, 512)
    assert STAGED_F32_FWD_HEAD_DIMS == (256,)
    # the staged instances: a slot of the UNet's whole live row, no column group splitting the score reduction;
    # K1 at 512 keeps 8-key tiles and 4 groups of 128 columns
    assert [(f32_keys(d), f32_groups(d)) for d in VALID_ROWS_HEAD_DIMS] == [(8, 2), (64, 1), (8, 6), (8, 4)]
    assert [f32_groups(d, backward=True) for d in VALID_ROWS_HEAD_DIMS] == [2, 1, 6, 1]
    assert f32_staged(256) == F32Staged(slot=64, rows=64, chunk=32, parts=1, key_parts=1)
    assert f32_staged(512) == F32Staged(slot=16, rows=16, chunk=128, parts=4, key_parts=2)
    assert (F32_STAGED_FWD_ROWS, F32_STAGED_FWD_CHUNK) == (64, 64)
    with pytest.raises(ValueError):
        f32_staged(192)
    # the padded instances, and the valid-rows ones at 64, keep their tiles
    assert [(f32_keys(d), f32_groups(d)) for d in (64, 128)] == [(32, 1), (32, 1)]
    assert (f32_keys(64, valid_rows=True), f32_groups(64)) == (32, 1)


@pytest.mark.parametrize("kind,d,want", [
    ("hole", 256, [[*range(8), *range(16, 72)]]),
    ("hole", 512, [[*range(8), *range(16, 24)]]),
    ("padded", 512, [list(range(16))]),
    (None, 256, [list(range(64)), list(range(64, 128))]),
    ("padded100", 256, [list(range(64)), list(range(64, 104))]),
], ids=["d256_hole", "d512_hole", "d512_padded", "d256_unmasked", "d256_past_rows"])
def test_the_staged_slots_gather_the_live_tiles(kind, d, want):
    """The slots of the staged instances: the live 8-key tiles in order
    (a tile with an attended key is live whole), a slot's worth at a time."""
    sq = {256: 64, 512: 16}[d]
    if kind == "padded100":
        row = torch.arange(MIN_BLOCK) < 100
    else:
        mask = _mask(kind, sq, 2)
        row = None if mask is None else torch.from_numpy(mask[0])
    assert [s.tolist() for s in f32_slots(row, MIN_BLOCK, d)] == want
    if kind == "hole":  # the fully masked batch row has no slot
        assert f32_slots(torch.from_numpy(_mask(kind, sq, 2)[1]), MIN_BLOCK, d) == []


def _recording(monkeypatch):
    calls = []

    def record(q, k, v, mask, scale):
        calls.append((q, k, v, mask))
        return fused_mha(q, k, v, mask, scale)

    monkeypatch.setattr(attention, "fused_mha", record)
    return calls


@pytest.mark.parametrize("d", [64, 128])
def test_the_padded_contract_of_the_other_head_dims_is_unchanged(monkeypatch, d):
    """k, v and the synthesized key mask padded to 128 rows with zeros, o
    sliced back: the kernels' inputs are bitwise what they were. q is padded
    too at D = 128; at D = 64 its 50 rows, not a whole 128-row block, go to
    the instances built around the valid rows unpadded (takes_valid_rows)."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 50, 2, d)).astype(np.float32)) for _ in range(3))
    calls = _recording(monkeypatch)
    out = dot_product_attention(q, k, v)
    ((rq, rk, rv, rmask),) = calls
    pad = torch.zeros(2, MIN_BLOCK - 50, 2, d)
    assert takes_valid_rows(50, d) == (d == 64)
    assert torch.equal(rq, q if d == 64 else torch.cat([q, pad], dim=1))
    for recorded, t in ((rk, k), (rv, v)):
        assert torch.equal(recorded, torch.cat([t, pad], dim=1))
    assert torch.equal(rmask, torch.arange(MIN_BLOCK)[None].expand(2, -1) < 50)
    assert torch.equal(out, fused_mha(rq, rk, rv, rmask)[0][:, :50])


@pytest.mark.parametrize("d", VALID_ROWS_HEAD_DIMS)
def test_the_mnist_head_dims_take_the_unpadded_query_rows(monkeypatch, d):
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 2, d)).astype(np.float32)) for _ in range(3))
    calls = _recording(monkeypatch)
    out = dot_product_attention(q, k, v)
    ((rq, rk, rv, rmask),) = calls
    assert rq is q and rk.shape == rv.shape == (2, MIN_BLOCK, 2, d) and torch.equal(rk[:, :16], k)
    assert torch.equal(rmask, torch.arange(MIN_BLOCK)[None].expand(2, -1) < 16)
    # the rows are independent: the same o as the reference's padded route
    padded = fused_mha_reference(*(attention._pad_to(t, 1, MIN_BLOCK) for t in (q, k, v)), rmask)[0]
    torch.testing.assert_close(out, padded[:, :16], rtol=1e-6, atol=1e-6)
    # and the autograd of the route gives q's gradient its own shape
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    dot_product_attention(*leaves).sum().backward()
    assert all(t.grad.shape == t.shape for t in leaves)


@pytest.mark.parametrize("channels,side", [(512, 8), (1024, 4)], ids=["d256_8x8", "d512_4x4"])
def test_attention_block_at_the_mnist_widths_matches_jax(channels, side):
    """The UNet's self-attention block with 2 heads (head dims 256 and 512),
    through ``auto`` on the CPU (the fused route's plain versions, q
    unpadded), against the JAX block: output and every gradient."""
    jm = jax_unet.AttentionBlock(channels, None, 2, rngs=nnx.Rngs(0))
    params = _randomize(jm, channels)
    tm = port_unet.AttentionBlock(channels, None, 2)
    tm.load_state_dict(state_dict_from_jax(params, tm), strict=True)
    assert tm.dim_head == channels // 2
    rng = np.random.default_rng(side)
    x = rng.standard_normal((2, side, side, channels)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    graphdef, jparams, rest = nnx.split(jm, nnx.Param, ...)

    def loss(p, xj):
        return jnp.sum(nnx.merge(graphdef, p, rest)(xj) * jnp.asarray(w))

    ref_out = jm(jnp.asarray(x))
    ref_grads, ref_dx = jax.grad(loss, argnums=(0, 1))(jparams, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=1e-5, rtol=1e-5)
    (out * torch.from_numpy(w)).sum().backward()
    flat = {"/".join(str(p) for p in path): np.asarray(v.get_value()) for path, v in ref_grads.flat_state()}
    ref = state_dict_from_jax(flat, tm)
    for name, p in tm.named_parameters():
        err = float((p.grad - ref[name]).abs().max())
        assert err <= 1e-4 * float(ref[name].abs().max()), (name, err)
    dx = np.asarray(ref_dx)
    assert float(np.abs(tx.grad.numpy() - dx).max()) <= 1e-4 * float(np.abs(dx).max())
