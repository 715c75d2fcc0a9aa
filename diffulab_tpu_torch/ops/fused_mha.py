"""Fused multi-head attention forward for short sequences (Hopper CUDA).

Replaces the Pallas TPU kernel ``diffulab_tpu/ops/fused_mha.py::_mha_fwd_kernel``
(launched by ``_mha_forward``). What it computes, per (batch, head):

- ``s = q·kᵀ·scale`` in fp32; a key-padding mask sets masked scores to the
  finite ``DEFAULT_MASK_VALUE``;
- a plain softmax ``p = exp(s - m) / l``, normalised BEFORE the PV product
  and rounded to the input dtype there (the bf16 rounding of XLA SDPA);
- ``o = p·v`` accumulated in fp32, written in the input dtype, and
  ``lse = m + log l`` in fp32 ``[B, Sq, H]``;
- a fully-masked row gives ``o = 0`` and ``lse = +inf``.

What bounds it on an H100: at the DiT-B/2 sampling shape (B=32, S=256, H=12,
D=64, bf16) it does 6.4 GFLOP on 50.7 MB of q/k/v/o/lse, about 127 FLOP a
byte, under the card's ~295 FLOP/byte balance point: it is memory-bound
(15.1 µs at 3.35 TB/s). The design therefore reads q/k/v in the
``[B, S, H·D]`` layout the qkv projection writes (a head is a D-wide column
slice, so no transpose pass), keeps the ``[S, S]`` scores out of device
memory, and writes only o and lse. ``csrc/fused_mha_fwd.cu`` holds two
kernels: for bf16, one CTA per (batch, head, 64 queries) with four warps of
``mma.sync`` m16n8k16 (bf16 in, fp32 accumulate) over 64-key tiles staged in
shared memory, in two passes over the keys (pass 1: row max and sum; pass 2:
``p`` rounded to bf16, then PV) so that K1's rounding order holds at any
length; for fp32, the same two passes with one thread per query row and
fp32 FMAs, since the tensor cores take no exact fp32 product.

:func:`fused_mha_reference` is the plain PyTorch version with the same op
order. The wrapper uses it only for tensors on the CPU; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from diffulab_tpu_torch.ops import _build

#: finite additive mask value of the reference kernels (flash_attention.py:37)
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
#: sequence padding granularity of the fused path (flash_attention.py MIN_BLOCK)
MIN_BLOCK = 128
#: query rows per CTA and keys per staged tile: Sq and Skv must be multiples
KERNEL_BLOCK = 64
#: head dims the kernel is instantiated for
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel by :func:`fused_mha` (read by chip_smoke.py)
LAUNCHES = {"fused_mha_fwd": 0}


def fused_mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, in K1's op order.

    q [B,Sq,H,D], k/v [B,Skv,H,D], kv_mask bool [B,Skv] (True = attend).
    Returns (o [B,Sq,H,D] in q's dtype, lse [B,Sq,H] fp32).
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * sm_scale
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :].bool(), s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / l
    lse = m + torch.log(l)
    if kv_mask is not None:
        fully_masked = m <= DEFAULT_MASK_VALUE
        p = torch.where(fully_masked, 0.0, p)
        lse = torch.where(fully_masked, torch.inf, lse)
    # p rounds to the input dtype before the PV product, which accumulates in fp32
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype), lse[..., 0].permute(0, 2, 1).contiguous()


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads each row with 16-byte loads: heads contiguous
    (strides ``(.., .., D, 1)``), rows and the base 16-byte aligned. A view
    such as the v slice of the packed qkv output passes as it is."""
    b, s, h, d = t.shape
    items = 16 // t.element_size()
    ok = (
        t.stride(3) == 1 and t.stride(2) == d
        and t.stride(1) % items == 0 and t.stride(0) % items == 0
        and t.data_ptr() % 16 == 0
    )
    return t if ok else t.contiguous()


def fused_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused attention forward. q [B,Sq,H,D], k/v [B,Skv,H,D], kv_mask [B,Skv].

    On CUDA tensors it launches the kernel (Sq and Skv multiples of 64,
    head dim in :data:`KERNEL_HEAD_DIMS`, bf16 or fp32 — pad through
    :func:`diffulab_tpu_torch.ops.attention.dot_product_attention`); on CPU
    tensors it runs :func:`fused_mha_reference`. Forward only: the backward
    kernel (K2) comes with the training slice.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return fused_mha_reference(q, k, v, kv_mask, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_mha runs on CUDA or CPU tensors, got {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "fused_mha has no backward kernel yet (K2, ROADMAP slice A2); "
            "call it under torch.no_grad()"
        )
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if k.shape != (b, skv, h, d) or v.shape != (b, skv, h, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"fused_mha takes bf16 or fp32 q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {KERNEL_HEAD_DIMS}")
    if sq % KERNEL_BLOCK or skv % KERNEL_BLOCK:
        raise ValueError(f"Sq={sq} and Skv={skv} must be multiples of {KERNEL_BLOCK}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    q, k, v = (_kernel_ready(t) for t in (q, k, v))
    mask_ptr = None
    if kv_mask is not None:
        if kv_mask.shape != (b, skv):
            raise ValueError(f"kv_mask shape {tuple(kv_mask.shape)} != {(b, skv)}")
        kv_mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
        mask_ptr = kv_mask.data_ptr()

    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    lib = _build.load("fused_mha_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.fused_mha_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, o.data_ptr(), lse.data_ptr(),
            b, sq, skv, h, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            ctypes.c_float(sm_scale), _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mha_fwd launch failed: CUDA error {err} ({_build.error_string(err)})")
    LAUNCHES["fused_mha_fwd"] += 1
    return o, lse
