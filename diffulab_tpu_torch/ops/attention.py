"""Attention entry point (port of diffulab_tpu/ops/attention.py).

The models call ``dot_product_attention(q, k, v, kv_mask)`` on the
reference's ``[B, S, H, D]`` layout. Dispatch:

- ``impl="auto"``: the fused whole-softmax kernel K1 for padded sequences
  of at most :data:`FUSED_MAX_SEQ` tokens, the KV-tiled flash kernel K3
  above (on CPU tensors, their plain versions), for head dims in
  :data:`~diffulab_tpu_torch.ops.fused_mha.KERNEL_HEAD_DIMS`; at the UNets'
  head dims :data:`~diffulab_tpu_torch.ops.fused_mha.VALID_ROWS_HEAD_DIMS`,
  K1 alone, in bf16 and fp32. Any other head dim, or those past the fused
  kernel's length, raise ``NotImplementedError``
  (:func:`~diffulab_tpu_torch.ops.fused_mha.check_head_dim`; the latter
  names ROADMAP queue 2a). The reference keeps K1 while its VMEM
  budget holds, then XLA SDPA, then flash from ``FLASH_MIN_SEQ``; the port
  never calls SDPA, so K3 takes the whole range beyond K1's.
- ``impl="fused"`` / ``"flash"``: that kernel at any length.
- ``impl="xla"``: the caller's explicit request for the plain version of K1
  (:func:`~diffulab_tpu_torch.ops.fused_mha.fused_mha_reference`) on any
  device. It keeps K1's fully-masked-row rule (o = 0), not the mean(V) of
  the reference's ``jax.nn.dot_product_attention`` path.

The inputs are local tensors: a DTensor (a tensor-parallel or FSDP
shard's wrapper) raises ``TypeError`` before any kernel sees it.

The fused route pads sequences to :data:`MIN_BLOCK` multiples with a
synthesized key mask and slices off padded query rows, as the reference's
``_fused_path``; it is differentiable (backward K2). Where K1/K2 run their
instances built around the valid rows
(:func:`~diffulab_tpu_torch.ops.fused_mha.route_takes_valid_rows`: at the
head dims of :data:`~diffulab_tpu_torch.ops.fused_mha.VALID_ROWS_HEAD_DIMS`,
and at head dim 64 where Sq is not a multiple of :data:`MIN_BLOCK` and is at
most :data:`~diffulab_tpu_torch.ops.fused_mha.SHORT_ROWS_MAX_SQ` rows in the
dtype, the crossover measured on the card) it pads k, v and the mask alone: those
instances take the unpadded query rows, so that no padded row is read,
multiplied or stored (the rows are independent, so o is the same), and
skip the key tiles the padding masks. The flash route pads
nothing: K3 masks the ragged ends itself, which is what the reference's
padding mask does; it is differentiable too (backward K4 then K5, through
:class:`~diffulab_tpu_torch.ops.flash_attention.FlashAttention`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from diffulab_tpu_torch.ops.flash_attention import flash_attention
from diffulab_tpu_torch.ops.fused_mha import (
    FUSED_HEAD_DIMS,
    MIN_BLOCK,
    check_head_dim,
    fused_mha,
    fused_mha_reference,
    route_takes_valid_rows,
)

#: longest padded sequence the fused kernel takes under ``auto``; the flash
#: kernel takes longer ones. K1 against K3 on the H100 (chip_smoke.py phase
#: 8, PERF.md) sets where the line falls.
FUSED_MAX_SEQ = 512

IMPLS = ("auto", "fused", "flash", "xla")


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_to(x: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    pad = target - x.shape[axis]
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return F.pad(x, widths)


def use_fused(q_shape: tuple[int, ...], kv_len: int) -> bool:
    """Whether ``auto`` takes the fused kernel for this shape (after padding)."""
    _, sq, _, d = q_shape
    seq = max(_round_up(sq, MIN_BLOCK), _round_up(kv_len, MIN_BLOCK))
    return d in FUSED_HEAD_DIMS and seq <= FUSED_MAX_SEQ


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    scale: float | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Bidirectional attention. q [B,Sq,H,D], k/v [B,Skv,H,D], kv_mask bool
    [B,Skv] (True = attend). Returns [B, Sq, H, D] in q's dtype."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if any(isinstance(t, DTensor) for t in (q, k, v, kv_mask)):
        raise TypeError("the attention kernels take local tensors: a sharded model's layers hand them their "
                        "shards (parallel/sharding.py), never a DTensor")
    if impl == "xla":
        return _fused_path(q, k, v, kv_mask, scale, plain=True)
    if impl == "auto":
        impl = "fused" if use_fused(q.shape, k.shape[1]) else "flash"
        check_head_dim(q.shape[-1], impl)
    if impl == "flash":
        return flash_attention(q, k, v, kv_mask, scale)[0]
    return _fused_path(q, k, v, kv_mask, scale)


def _fused_path(q, k, v, kv_mask, scale, plain: bool = False):
    b, sq, _, d = q.shape
    skv = k.shape[1]
    sq_p = sq if route_takes_valid_rows(sq, d, q.dtype) else _round_up(sq, MIN_BLOCK)
    skv_p = _round_up(skv, MIN_BLOCK)

    if kv_mask is None and skv_p != skv:
        kv_mask = torch.ones((b, skv), dtype=torch.bool, device=q.device)
    qp = _pad_to(q, 1, sq_p)
    kp = _pad_to(k, 1, skv_p)
    vp = _pad_to(v, 1, skv_p)
    maskp = _pad_to(kv_mask, 1, skv_p) if kv_mask is not None else None
    o, _ = (fused_mha_reference if plain else fused_mha)(qp, kp, vp, maskp, scale)
    return o[:, :sq]
