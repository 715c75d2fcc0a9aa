"""Ring attention: sequence-parallel attention over the mesh's ``sp`` axis
(port of diffulab_tpu/ops/ring_attention.py).

Each of the n ranks holds a 1/n block of the tokens' q, k and v. The K/V
blocks travel around the ring point to point (``batch_isend_irecv``, the
reference's ``lax.ppermute``) while each rank folds the visiting block into
running online-softmax statistics (m, l) and an unnormalised output, the
reference's merge (ring_attention.py:38-81). The per-block product is
``_block_attn``'s plain einsum (:24-35), outside any kernel in the reference
too, so it stays a torch product here.

The gradient comes from :class:`RingAttention`, whose backward runs the ring
again (the reference gets it from JAX transposing ``ppermute``): the K/V
blocks travel with their dk/dv accumulators, each rank adds its queries'
share to the visiting block's, and after n steps every accumulator is back
on the rank that owns the block. The probabilities are recomputed from the
saved row statistics (m, l), so no block's scores are kept.

Masking (trap T1 in the ring): a masked score is ``-0.7 * finfo(f32).max``,
a finite value, and ``l == 0`` becomes 1 (ring_attention.py:30, 79). A row
whose keys are all masked therefore scores every key alike and gives the
mean of v over all keys, as the reference's ring does; the masked scores
take no gradient.
"""

from __future__ import annotations

import torch

from diffulab_tpu_torch.parallel import _comm
from diffulab_tpu_torch.parallel.mesh import axis_group

#: the reference's masked score (ring_attention.py:30)
MASKED_SCORE = -0.7 * torch.finfo(torch.float32).max


def _scores(q, k, scale, kv_mask):
    """fp32 scores [B, H, Q, K] of one block, masked as the reference masks them."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :], s, torch.full_like(s, MASKED_SCORE))
    return s


def _block_attn(q, k, v, scale, kv_mask=None):
    """Unnormalised attention against one K/V block: (o*l [B, Q, H, D] fp32,
    m, l [B, H, Q]), the reference's ``_block_attn``."""
    s = _scores(q, k, scale, kv_mask)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    return o, m, l


def _ring_forward(q, k, v, kv_mask, scale, group):
    n = _comm._size(group)
    b, sq, h, d = q.shape
    acc = torch.zeros(b, sq, h, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), -torch.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    k_blk, v_blk, mask_blk = k, v, kv_mask
    for step in range(n):
        o_blk, m_blk, l_blk = _block_attn(q, k_blk, v_blk, scale, mask_blk)
        m_new = torch.maximum(m, m_blk)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_blk - m_new)
        l = alpha * l + beta * l_blk
        acc = acc * alpha.transpose(1, 2)[..., None] + o_blk * beta.transpose(1, 2)[..., None]
        m = m_new
        if step < n - 1:  # the reference's last rotation is never read
            k_blk, v_blk = _comm.shift_raw(k_blk, group), _comm.shift_raw(v_blk, group)
            if mask_blk is not None:
                mask_blk = _comm.shift_raw(mask_blk, group)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = acc / l_safe.transpose(1, 2)[..., None]
    return out.to(q.dtype), m, l_safe


class RingAttention(torch.autograd.Function):
    """Ring attention over ``group`` on local blocks q/k/v [B, S/n, H, D]."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale, group):
        out, m, l = _ring_forward(q, k, v, kv_mask, scale, group)
        ctx.save_for_backward(q, k, v, kv_mask, out, m, l)
        ctx.scale, ctx.group = scale, group
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, m, l = ctx.saved_tensors
        scale, group = ctx.scale, ctx.group
        n = _comm._size(group)
        do = dout.float()
        di = (do * out.float()).sum(dim=-1).transpose(1, 2)  # [B, H, Q]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        k_blk, v_blk, mask_blk = k, v, kv_mask
        dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_blk = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for step in range(n):
            s = _scores(q, k_blk, scale, mask_blk)
            # the forward's probabilities from its row statistics; m + log(l) would lose log(l)
            # against a masked row's -0.7 finfo.max
            p = torch.exp(s - m[..., None]) / l[..., None]
            dv_blk = dv_blk + torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), do)
            dp = torch.einsum("bqhd,bkhd->bhqk", do, v_blk.float())
            ds = p * (dp - di[..., None]) * scale
            if mask_blk is not None:  # the where's masked branch is a constant
                ds = torch.where(mask_blk[:, None, None, :], ds, torch.zeros_like(ds))
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_blk.float())
            dk_blk = dk_blk + torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
            # the block's accumulators move on with it; after n moves each is home
            dk_blk, dv_blk = _comm.shift_raw(dk_blk, group), _comm.shift_raw(dv_blk, group)
            if step < n - 1:
                k_blk, v_blk = _comm.shift_raw(k_blk, group), _comm.shift_raw(v_blk, group)
                if mask_blk is not None:
                    mask_blk = _comm.shift_raw(mask_blk, group)
        return dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype), None, None, None


def ring_attention_local(q, k, v, group, kv_mask=None, scale: float | None = None) -> torch.Tensor:
    """Per-rank body: q/k/v [B, S_local, H, D], ``kv_mask`` [B, S_local] bool
    (True = attend), the ring over ``group`` (None: one block)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.bool)
    return RingAttention.apply(q, k, v, kv_mask, float(scale), group)


def sequence_parallel_attention(mesh, axis: str = "sp"):
    """Ring attention with the token axis sharded over ``mesh[axis]``
    (ring_attention.py:84). Returns ``(q, k, v, kv_mask=None, scale=None) ->
    out`` on the rank's [B, S, H, D] tensors, the same on every rank of the
    axis: each takes its 1/n of the tokens, the ring attends them, and the
    ranks all-gather the outputs. S must divide by the axis size."""
    group = axis_group(mesh, axis)

    def call(q, k, v, kv_mask=None, scale=None):
        if q.shape[1] % _comm._size(group):
            raise ValueError(f"sequence length {q.shape[1]} is not divisible by the {axis} axis "
                             f"({_comm._size(group)})")
        ql, kl, vl = (_comm.split(t, group, 1) for t in (q, k, v))
        mask = None if kv_mask is None else kv_mask.to(torch.bool).chunk(_comm._size(group), dim=1)[
            _comm._rank(group)]
        return _comm.gather(ring_attention_local(ql, kl, vl, group, mask, scale), group, 1)

    return call
