"""Attention entry point (port of diffulab_tpu/ops/attention.py).

The models call ``dot_product_attention(q, k, v, kv_mask)`` on the
reference's ``[B, S, H, D]`` layout. Dispatch:

- ``impl="auto"`` / ``"fused"``: the fused whole-softmax kernel
  (:func:`~diffulab_tpu_torch.ops.fused_mha.fused_mha`; its plain version for
  CPU tensors), for every shape it supports: head dim in
  :data:`~diffulab_tpu_torch.ops.fused_mha.KERNEL_HEAD_DIMS` and padded
  sequences of at most :data:`FUSED_MAX_SEQ` tokens. Longer sequences need
  the KV-tiled flash kernel, which is not ported yet: they raise
  ``NotImplementedError``.
- ``impl="xla"``: the caller's explicit request for the plain version
  (:func:`~diffulab_tpu_torch.ops.fused_mha.fused_mha_reference`) on any
  device. It keeps K1's fully-masked-row rule (o = 0), not the mean(V) of
  the reference's ``jax.nn.dot_product_attention`` path.

Sequences are padded to :data:`MIN_BLOCK` multiples with a synthesized key
mask, and padded query rows are sliced off, as in the reference's
``_fused_path``. Both are differentiable: under grad the fused path goes
through :class:`~diffulab_tpu_torch.ops.fused_mha.FusedMHA` (backward K2),
and ``impl="xla"`` differentiates through the plain forward itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from diffulab_tpu_torch.ops.fused_mha import (
    KERNEL_HEAD_DIMS,
    MIN_BLOCK,
    fused_mha,
    fused_mha_reference,
)

#: longest padded sequence the fused kernel takes here: 512 tokens is where
#: the reference stops using its fused kernel at DiT-B widths, and the
#: sequences beyond it belong to the flash kernel (ROADMAP queue 2, K3)
FUSED_MAX_SEQ = 512


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_to(x: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    pad = target - x.shape[axis]
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return F.pad(x, widths)


def use_fused(q_shape: tuple[int, ...], kv_len: int) -> bool:
    """Whether the fused kernel takes this shape (after padding)."""
    _, sq, _, d = q_shape
    seq = max(_round_up(sq, MIN_BLOCK), _round_up(kv_len, MIN_BLOCK))
    return d in KERNEL_HEAD_DIMS and seq <= FUSED_MAX_SEQ


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
    if impl not in ("auto", "fused", "xla"):
        raise ValueError(f"impl must be 'auto', 'fused' or 'xla', got {impl!r}")
    if impl == "xla":
        return _fused_path(q, k, v, kv_mask, scale, plain=True)
    if not use_fused(q.shape, k.shape[1]):
        raise NotImplementedError(
            f"attention at q {tuple(q.shape)}, kv length {k.shape[1]} needs the KV-tiled "
            "flash kernel (K3), which is ROADMAP slice B and not ported yet; the fused "
            f"kernel takes head dims {KERNEL_HEAD_DIMS} and up to {FUSED_MAX_SEQ} tokens"
        )
    return _fused_path(q, k, v, kv_mask, scale)


def _fused_path(q, k, v, kv_mask, scale, plain: bool = False):
    b, sq, _, _ = q.shape
    skv = k.shape[1]
    sq_p = _round_up(sq, MIN_BLOCK)
    skv_p = _round_up(skv, MIN_BLOCK)

    if kv_mask is None and skv_p != skv:
        kv_mask = torch.ones((b, skv), dtype=torch.bool, device=q.device)
    qp = _pad_to(q, 1, sq_p)
    kp = _pad_to(k, 1, skv_p)
    vp = _pad_to(v, 1, skv_p)
    maskp = _pad_to(kv_mask, 1, skv_p) if kv_mask is not None else None
    o, _ = (fused_mha_reference if plain else fused_mha)(qp, kp, vp, maskp, scale)
    return o[:, :sq]
