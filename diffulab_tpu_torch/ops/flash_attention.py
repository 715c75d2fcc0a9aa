"""KV-tiled flash attention for long sequences (Hopper CUDA), forward.

**Forward (K3)** replaces the Pallas TPU kernel
``diffulab_tpu/ops/flash_attention.py::_fwd_kernel`` (launched by
``_flash_forward``). What it computes, per (batch, head, query row), over key
tiles:

- ``s = q·kᵀ·scale`` in fp32; a key-padding mask sets masked scores to the
  finite ``DEFAULT_MASK_VALUE``;
- an online softmax with a running max ``m`` and sum ``l``: per tile
  ``m_new = max(m, rowmax(s))``, ``alpha = exp(m - m_new)``,
  ``p = exp(s - m_new)`` **unnormalised**, ``l = alpha·l + rowsum(p)``;
- ``p`` rounded to the input dtype before ``acc = alpha·acc + p·v`` (fp32);
- at the end ``o = acc / l_safe`` (``l_safe = 1`` where ``l == 0``) and
  ``lse = m + log(l_safe)``; a fully-masked row (``m <= DEFAULT_MASK_VALUE``)
  gives ``o = 0`` and ``lse = +inf``.

This is not K1's rounding order: K1 normalises p before PV
(:mod:`diffulab_tpu_torch.ops.fused_mha`). In bf16 the result also depends on
where the key tiles start, since p is rounded relative to the running max of
the tiles seen so far; the kernel and :func:`flash_attention_reference` share
:data:`KERNEL_BLOCK_N`, so they differ only in summation order.

What bounds it on an H100 SXM (data-sheet peaks at 700 W): at the txt2img MMDiT sampling shape (B=8,
S=4224, H=12, D=64, bf16) the two products are 438.5 GFLOP (0.443 ms at 989
TFLOP/s) against ~209 MB of q/k/v/o/lse (62 µs at 3.35 TB/s): it is
compute-bound. ``csrc/flash_attn_fwd.cu`` therefore keeps the scores on chip
and the tensor cores fed: one CTA per (batch, head, 128 queries), eight
warps of ``mma.sync`` m16n8k16 (bf16 in, fp32 accumulate), K/V tiles of 64
keys double-buffered in shared memory by ``cp.async``, m/l/o in registers.
q/k/v are read in the ``[B, S, H, D]`` layout at the caller's strides (no
transpose, no padded copy: the ragged ends are masked inside the kernel).
fp32 tensors run a second kernel with fp32 FMAs, one thread per query row.
``lse`` is written ``[B, H, Sq]``, the layout the backward kernels (K4, K5)
will read.

:func:`flash_attention_reference` is the plain PyTorch version, the same
recurrence over the same key tiles. :func:`flash_attention` uses it only for
tensors on the CPU (where autograd runs through it); a CUDA tensor launches
the kernel or raises, and under grad on the card it raises: the backward
kernels K4 and K5 are ROADMAP slice B2.
"""

from __future__ import annotations

import ctypes

import torch

from diffulab_tpu_torch.ops import _build
from diffulab_tpu_torch.ops.fused_mha import (
    _DTYPE_CODES,
    DEFAULT_MASK_VALUE,
    _check_cuda_inputs,
    _int_mask,
    _kernel_ready,
    _raise_on,
)

#: keys per tile of the kernel and of its plain version
KERNEL_BLOCK_N = 64

#: launches of the CUDA kernel by :func:`flash_attention` (read by chip_smoke.py)
LAUNCHES = {"flash_attn_fwd": 0}


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    sm_scale: float | None = None,
    block_k: int = KERNEL_BLOCK_N,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: K3's online recurrence
    over key tiles of ``block_k`` keys.

    q [B,Sq,H,D], k/v [B,Skv,H,D], kv_mask bool [B,Skv] (True = attend).
    Returns (o [B,Sq,H,D] in q's dtype, lse [B,H,Sq] fp32).
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    b, sq, h, _ = q.shape
    qf = q.float()
    m = torch.full((b, h, sq), -torch.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, q.shape[-1]), dtype=torch.float32, device=q.device)
    for n0 in range(0, k.shape[1], block_k):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k[:, n0:n0 + block_k].float()) * sm_scale
        if kv_mask is not None:
            s = torch.where(kv_mask[:, None, None, n0:n0 + block_k].bool(), s, DEFAULT_MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(dim=-1)
        # p rounds to the input dtype before the PV product, which accumulates in fp32
        vt = v[:, n0:n0 + block_k]
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p.to(vt.dtype).float(), vt.float())
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = acc / l_safe[..., None]
    lse = m + torch.log(l_safe)
    # a fully-masked row: every score at the mask value (padded keys too)
    dead = m <= DEFAULT_MASK_VALUE
    o = torch.where(dead[..., None], 0.0, o)
    lse = torch.where(dead, torch.inf, lse)
    return o.permute(0, 2, 1, 3).to(q.dtype), lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward. q [B,Sq,H,D], k/v [B,Skv,H,D], kv_mask [B,Skv].
    Returns (o [B,Sq,H,D] in q's dtype, lse [B,H,Sq] fp32).

    On CUDA tensors it launches K3 (any lengths, head dim in
    :data:`~diffulab_tpu_torch.ops.fused_mha.KERNEL_HEAD_DIMS`, bf16 or fp32, no grad); on CPU tensors it runs
    :func:`flash_attention_reference`, differentiable by autograd.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_mask, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash attention backward (K4 _bwd_dkv_kernel, K5 _bwd_dq_kernel) is ROADMAP "
            "slice B2 and not ported yet: the flash route runs without grad on the card"
        )
    _check_cuda_inputs(q, k, v, kv_mask, block=1, name="flash_attention")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    q, k, v = (_kernel_ready(t) for t in (q, k, v))
    mask = _int_mask(kv_mask, q.device)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attn_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
            o.data_ptr(), lse.data_ptr(),
            b, sq, skv, h, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            ctypes.c_float(sm_scale), _DTYPE_CODES[q.dtype], stream,
        )
    _raise_on(err, "flash_attn_fwd")
    LAUNCHES["flash_attn_fwd"] += 1
    return o, lse
