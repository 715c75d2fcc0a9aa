"""KV-tiled flash attention for long sequences (Hopper CUDA), forward and
backward.

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

What bounds it on an H100 SXM (data-sheet peaks at 700 W): at the txt2img MMDiT
sampling shape (B=8, S=4224, H=12, D=64, bf16, the fused-CFG text mask) the
two products over the keys each row attends are 428.4 GFLOP (0.433 ms at 989
TFLOP/s) against ~209 MB of q/k/v/o/lse (62 µs at 3.35 TB/s): it is
compute-bound, and its ~1.7 G exponentials take as long on the SMs' ``ex2``
units, so the softmax has to overlap the products. ``csrc/flash_attn_fwd.cu``
therefore keeps the scores on chip and the tensor cores fed: in bf16, one CTA
per (batch, head, 192 queries; 128 at head dim 128), warpgroups of 64 rows
taking turns at ``wgmma`` (S = Q·Kᵀ from shared memory; round(p)·V with p
from the accumulators in registers), Q loaded once and K/V tiles of 128 keys
streamed through a TMA ring, the key mask held as bit words in shared memory,
m/l/o in registers, o written back by TMA store. q/k/v are
read in the ``[B, S, H, D]`` layout at the caller's strides (no transpose, no
padded copy: the ragged ends are masked inside the kernel). ``lse`` is written
``[B, H, Sq]``, the layout the backward reads. fp32 tensors (the library's
default ``dtype=None``, the ``sample`` CLI, the MMDiT's
``attention_dtype=float32``) run a second kernel, bound by operations: its
products on the tensor cores as 3xTF32 (each operand split into two TF32
halves, three ``mma.sync`` products, about 2^-21 relative each), one CTA per
128 queries (64 at head dim 128) in one pass over tiles of :func:`f32_fwd_keys` keys with an online
softmax in log2 units and o divided by l at the end
(:func:`flash_attention_tf32x3_emulation` emulates it).

**Backward (K4, K5)** replaces ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``
(launched by ``_flash_backward``). From the forward's q, k, v, mask, o and
lse, with ``di = rowsum(o·do)`` in fp32 from the stored o (the reference
forms it outside Pallas, flash_attention.py:275):
``p = exp(s - lse)`` (0 on a row with lse = +inf), ``dv = round(p)ᵀ·do``,
``dp = do·vᵀ``, ``ds = p·(dp - di)·scale``, ``dk = round(ds)ᵀ·q`` (K4) and
``dq = round(ds)·k`` (K5), where ``round`` is the cast to the input dtype and
every product accumulates in fp32. At the txt2img training shape K4 makes
four products over the valid keys and K5 three: compute-bound, ~0.87 and
~0.65 ms at 989 TFLOP/s. ``csrc/flash_attn_bwd.cu`` turns each TPU kernel's
sequential grid axis into a loop inside one CTA, with no atomics
(deterministic, as the reference's two kernels are). In bf16 at head dims 64
and 128: K4 per (128 keys, head, batch) over TMA-fed 64-query tiles (32 at
D = 128), K5 per (128 queries, head, batch) over 128-key tiles (64 at
D = 128), two warpgroups of 64 rows taking turns at ``wgmma``, the sums in
fp32 registers; p and ds go from the accumulators into register operands.
At head dims 16 and 32 the first ``mma.sync`` kernels run. A coalesced
pre-pass launched with K4 forms di and lse·log2 e into a workspace. In fp32
both run their products as 3xTF32 ``mma.sync``: K4 one CTA per 128 keys (64
at head dim 128) over query tiles of :func:`f32_dkv_queries` with lse·log2 e
and di from that workspace (:func:`flash_attention_bwd_dkv_tf32x3_emulation`
emulates it), K5 one CTA per 128 query rows (64 at head dim 128) over key
tiles of :func:`f32_dq_keys` from K3's lse and that di
(:func:`flash_attention_bwd_dq_tf32x3_emulation`); each tile's sums start
from zero and are added in fp32.

:func:`flash_attention_reference` and :func:`flash_attention_bwd_reference`
are the plain PyTorch versions, the same arithmetic over the same key tiles.
The wrappers use them only for tensors on the CPU; a CUDA tensor launches the
kernels or raises. :class:`FlashAttention` ties forward and backward into
autograd, as the reference's ``jax.custom_vjp`` does: on the CPU it runs the
plain forward and the plain backward (not autograd of the plain forward).
"""

from __future__ import annotations

import collections
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
    matmul_3xtf32,
)

#: keys per tile of the kernel and of its plain version. In bf16 the result
#: depends on it (p is rounded relative to the running max of the tiles seen
#: so far); 128 is the Hopper kernel's tile, one ``wgmma`` of 128 keys
KERNEL_BLOCK_N = 128

#: keys per tile of the backward's sums: K4's CTA and K5's tile at head dim 64.
#: The backward has no online rescale, so the tiling moves only the fp32
#: summation order
BWD_BLOCK_K = 128

#: the backward's fp32 workspace rows (lse and di of each (batch, head)) are
#: padded to a multiple of this, so that K4's last query tile reads whole rows
BWD_ROW_ALIGN = 64

#: log2(e) and ln(2) as the kernels hold them (fp32)
_LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
_LN2 = torch.tensor(0.6931471805599453, dtype=torch.float32)


def f32_fwd_keys(d: int) -> int:
    """Keys of a ring slot of the fp32 K3 at head dim ``d``, the tile of its
    online softmax: 64, and 32 at D = 128 (``fwd_f32_keys`` in
    ``csrc/flash_attn_fwd.cu``, which the library exports as
    ``flash_attn_fwd_f32_tiles``; chip_smoke.py holds this to it on the
    card)."""
    return 64 if d <= 64 else 32


def f32_dkv_queries(d: int) -> int:
    """Queries of a ring slot of the fp32 K4 at head dim ``d``: 64, and 32 at
    D = 128 (``dkv_f32_queries`` in ``csrc/flash_attn_bwd.cu``, exported as
    ``flash_attn_bwd_f32_tiles(d, 0)``). Each divides :data:`BWD_ROW_ALIGN`."""
    return 64 if d <= 64 else 32


def f32_dq_keys(d: int) -> int:
    """Keys of a ring slot of the fp32 K5 at head dim ``d``: 64, and 32 at
    D = 128, whole 32-key ballot words of mask (``dq_f32_keys`` in
    ``csrc/flash_attn_bwd.cu``, exported as ``flash_attn_bwd_f32_tiles(d, 1)``)."""
    return 64 if d <= 64 else 32

#: launches of the CUDA kernels: K3 by :func:`flash_attention`, K4 by
#: :func:`flash_attention_bwd_dkv`, K5 by :func:`flash_attention_bwd_dq`;
#: an ``_f32`` key counts the fp32 instance's launches alone, which its
#: kernel's key counts too (read by chip_smoke.py)
LAUNCHES = {"flash_attn_fwd": 0, "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0,
            "flash_attn_fwd_f32": 0, "flash_attn_bwd_dkv_f32": 0, "flash_attn_bwd_dq_f32": 0}


#: the same launches by ``(kernel, dtype name, Skv)`` (read by chip_smoke.py)
LAUNCHES_BY_KEYS: collections.Counter = collections.Counter()


def _count(name: str, dtype: torch.dtype, skv: int) -> None:
    LAUNCHES[name] += 1
    LAUNCHES_BY_KEYS[name, str(dtype).removeprefix("torch."), skv] += 1
    if dtype == torch.float32:
        LAUNCHES[f"{name}_f32"] += 1


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


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    sm_scale: float | None = None,
    block_k: int = BWD_BLOCK_K,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels K4 and K5, in their op
    order and roundings, over key tiles of ``block_k`` keys (so no
    ``[B, H, Sq, Skv]`` intermediate is held whole).

    q/o/do [B,Sq,H,D], k/v [B,Skv,H,D], kv_mask bool [B,Skv] or None, lse fp32
    [B,H,Sq] from the forward. Returns (dq, dk, dv) in q's, k's and v's dtypes.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    di = (o.float() * do.float()).sum(dim=-1).permute(0, 2, 1)  # [B, H, Sq], from the stored o
    return flash_attention_bwd_from_di(q, k, v, kv_mask, lse, di, do, sm_scale, block_k)


def flash_attention_bwd_from_di(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None,
    lse: torch.Tensor,
    di: torch.Tensor,
    do: torch.Tensor,
    sm_scale: float,
    block_k: int = BWD_BLOCK_K,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain K4 and K5 from a given ``di`` fp32 ``[B, H, Sq]`` (and lse
    ``[B, H, Sq]``) instead of o: the backward that the Hopper K2 runs with
    its own ``di = rowsum(p·dp)``
    (:func:`~diffulab_tpu_torch.ops.fused_mha.fused_mha_bwd_di`)."""
    qf, dof = q.float(), do.float()
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for n0 in range(0, k.shape[1], block_k):
        kt, vt = k[:, n0:n0 + block_k].float(), v[:, n0:n0 + block_k].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kt) * sm_scale
        if kv_mask is not None:
            s = torch.where(kv_mask[:, None, None, n0:n0 + block_k].bool(), s, DEFAULT_MASK_VALUE)
        p = torch.exp(s - lse[..., None])  # 0 on a row with lse = +inf
        # K4: p rounds to do's dtype before dv = pᵀ·do, ds to q's before dk = dsᵀ·q
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof))
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vt)
        ds = p * (dp - di[..., None]) * sm_scale
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qf))
        # K5: ds rounds to k's dtype before dq += ds·k
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kt)
    return dq.to(q.dtype), torch.cat(dks, dim=1).to(k.dtype), torch.cat(dvs, dim=1).to(v.dtype)


def _scale_log2(sm_scale: float) -> torch.Tensor:
    """``sm_scale·log2 e`` as the kernels form it, in fp32."""
    return torch.tensor(sm_scale, dtype=torch.float32) * _LOG2E


def flash_attention_tf32x3_emulation(q, k, v, kv_mask=None, sm_scale=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 K3's tile math on fp32 CPU tensors: :func:`matmul_3xtf32`
    products, one pass over tiles of :func:`f32_fwd_keys` keys with the
    scores in log2 units (``s·scale·log2 e``, masked keys at
    ``DEFAULT_MASK_VALUE``), the online row max m and sum l, ``alpha =
    2^(m - m_new)`` rescaling l and o, ``p = 2^(s - m_new)`` into ``o =
    alpha·o + p·v``, and at the end ``o / l`` and
    ``lse = m·ln 2 + log l``; a fully-masked row gives o = 0, lse = +inf.
    Each tile's ``p·v`` is summed from zero and then added, as the kernel
    adds it (the tensor cores' own accumulation rounds toward zero, which a
    sum over thousands of keys would carry).
    The kernel's last tile is padded to whole tiles with masked keys: they
    add exact zeros past a live key, and a row with none is dead, so the
    emulation walks the ragged tile as it is.
    Returns (o [B,Sq,H,D], lse [B,H,Sq])."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    qh, kh, vh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))  # [B, H, S, D]
    b, h, sq, d = qh.shape
    scale_log2 = _scale_log2(sm_scale)
    m = torch.full((b, h, sq, 1), -torch.inf)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, d)
    kt = f32_fwd_keys(d)
    for n0 in range(0, kh.shape[2], kt):
        s = matmul_3xtf32(qh, kh[:, :, n0:n0 + kt].transpose(-1, -2)) * scale_log2
        if kv_mask is not None:
            s = torch.where(kv_mask[:, None, None, n0:n0 + kt].bool(), s, DEFAULT_MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + matmul_3xtf32(p, vh[:, :, n0:n0 + kt])
        m = m_new
    dead = m <= DEFAULT_MASK_VALUE
    o = torch.where(dead, 0.0, acc / l)
    lse = torch.where(dead, torch.inf, m * _LN2 + torch.log(l))
    return o.permute(0, 2, 1, 3).contiguous(), lse[..., 0].contiguous()


def flash_attention_bwd_dkv_tf32x3_emulation(q, k, v, kv_mask, o, lse, do, sm_scale=None):
    """The fp32 K4's tile math on fp32 CPU tensors: the pre-pass's ``di =
    rowsum(o·do)`` from the stored o and ``lse2 = lse·log2 e``, then over
    query tiles of :func:`f32_dkv_queries`, with :func:`matmul_3xtf32`
    products, ``pᵀ = 2^(k·qᵀ·scale·log2 e - lse2)`` (0 on a masked key, and
    on a row with lse = +inf), ``dv += pᵀ·do``, ``dpᵀ = v·doᵀ``, ``dsᵀ =
    pᵀ·(dpᵀ - di)·scale`` and ``dk += dsᵀ·q``, each tile's sums formed from
    zero and then added to dk and dv. Returns (dk, dv [B,Skv,H,D], di
    [B,H,Sq])."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    qh, kh, vh, doh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, do))  # [B, H, S, D]
    di = (o.float() * do.float()).sum(dim=-1).permute(0, 2, 1)  # [B, H, Sq]
    lse2 = lse.float() * _LOG2E
    scale_log2 = _scale_log2(sm_scale)
    dk, dv = torch.zeros(kh.shape), torch.zeros(vh.shape)
    qt = f32_dkv_queries(qh.shape[-1])
    for m0 in range(0, qh.shape[2], qt):
        rows = slice(m0, m0 + qt)
        pt = torch.exp2(matmul_3xtf32(kh, qh[:, :, rows].transpose(-1, -2)) * scale_log2 - lse2[:, :, None, rows])
        if kv_mask is not None:
            pt = torch.where(kv_mask[:, None, :, None].bool(), pt, 0.0)
        dv = dv + matmul_3xtf32(pt, doh[:, :, rows])
        dst = pt * (matmul_3xtf32(vh, doh[:, :, rows].transpose(-1, -2)) - di[:, :, None, rows]) * sm_scale
        dk = dk + matmul_3xtf32(dst, qh[:, :, rows])
    return dk.permute(0, 2, 1, 3).contiguous(), dv.permute(0, 2, 1, 3).contiguous(), di


def flash_attention_bwd_dq_tf32x3_emulation(q, k, v, kv_mask, lse, di, do, sm_scale=None):
    """The fp32 K5's tile math on fp32 CPU tensors: from K3's lse and the
    pre-pass's di (both ``[B, H, Sq]``), over key tiles of
    :func:`f32_dq_keys`, with :func:`matmul_3xtf32` products, ``p =
    2^(q·kᵀ·scale·log2 e - lse·log2 e)`` (0 on a masked key, and on a row with
    lse = +inf), ``dp = do·vᵀ``, ``ds = p·(dp - di)·scale``, and each tile's
    ``ds·k`` summed from zero and then added to dq. The kernel skips a tile
    with no attended key, which adds exactly 0. Returns dq [B,Sq,H,D]."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    qh, kh, vh, doh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, do))  # [B, H, S, D]
    lse2 = lse.float() * _LOG2E
    scale_log2 = _scale_log2(sm_scale)
    dq = torch.zeros(qh.shape)
    kt = f32_dq_keys(qh.shape[-1])
    for n0 in range(0, kh.shape[2], kt):
        keys = slice(n0, n0 + kt)
        p = torch.exp2(matmul_3xtf32(qh, kh[:, :, keys].transpose(-1, -2)) * scale_log2 - lse2[..., None])
        if kv_mask is not None:
            p = torch.where(kv_mask[:, None, None, keys].bool(), p, 0.0)
        ds = p * (matmul_3xtf32(doh, vh[:, :, keys].transpose(-1, -2)) - di[..., None]) * sm_scale
        dq = dq + matmul_3xtf32(ds, kh[:, :, keys])
    return dq.permute(0, 2, 1, 3).contiguous()


def _forward(q, k, v, kv_mask, sm_scale) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_mask, sm_scale)
    _check_cuda_inputs(q, k, v, kv_mask, route="flash", name="flash_attention")
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
    _count("flash_attn_fwd", q.dtype, skv)
    return o, lse


def _check_bwd_inputs(q, k, v, kv_mask, lse, *like_q) -> None:
    """Raise unless the backward's inputs meet the kernels' contract: q/k/v as
    for K3, each of ``like_q`` (o, do) q's shape and dtype, lse fp32 [B, H, Sq]."""
    _check_cuda_inputs(q, k, v, kv_mask, route="flash", name="flash_attention_bwd")
    b, sq, h, _ = q.shape
    for t in like_q:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"o/do {tuple(t.shape)} {t.dtype} do not match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be fp32 {(b, h, sq)} on {q.device}, got {tuple(lse.shape)} {lse.dtype}")


def flash_attention_bwd_dkv(q, k, v, kv_mask, o, lse, do, sm_scale):
    """K4 on CUDA tensors (the pre-pass, then dk/dv): returns (dk, dv, di
    fp32 [B, H, Sq]). The contract of :func:`flash_attention_bwd`. di is a view
    of the pre-pass's workspace ``[2, B, H, Sq padded to BWD_ROW_ALIGN]``
    (lse·log2 e, then di), whose rows K4 reads whole."""
    _check_bwd_inputs(q, k, v, kv_mask, lse, o, do)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    q, k, v, o, do = (_kernel_ready(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    mask = _int_mask(kv_mask, q.device)
    sq_pad = -(-sq // BWD_ROW_ALIGN) * BWD_ROW_ALIGN
    ws = torch.empty((2, b, h, sq_pad), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, skv, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, skv, h, d), dtype=v.dtype, device=q.device)
    lib = _build.load("flash_attn_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_attn_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            None if mask is None else mask.data_ptr(), lse.data_ptr(), ws.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            b, sq, skv, h, d, sq_pad,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            o.stride(0), o.stride(1), do.stride(0), do.stride(1),
            ctypes.c_float(sm_scale), _DTYPE_CODES[q.dtype], stream,
        )
    _raise_on(err, "flash_attn_bwd_dkv")
    _count("flash_attn_bwd_dkv", q.dtype, skv)
    return dk, dv, ws[1, :, :, :sq]


def flash_attention_bwd_dq(q, k, v, kv_mask, lse, di, do, sm_scale):
    """K5 on CUDA tensors, from the di of :func:`flash_attention_bwd_dkv`: returns dq."""
    _check_bwd_inputs(q, k, v, kv_mask, lse, do)
    if di.shape != lse.shape or di.dtype != torch.float32 or di.device != q.device:
        raise ValueError(f"di must be fp32 {tuple(lse.shape)} on {q.device}, got {tuple(di.shape)} {di.dtype}")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    q, k, v, do = (_kernel_ready(t) for t in (q, k, v, do))
    lse = lse.contiguous()
    if di.stride(2) != 1 or di.stride(0) != h * di.stride(1):  # rows (b, h) evenly spaced, as K4's view is
        di = di.contiguous()
    mask = _int_mask(kv_mask, q.device)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attn_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_attn_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            None if mask is None else mask.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
            b, sq, skv, h, d, di.stride(1),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            do.stride(0), do.stride(1),
            ctypes.c_float(sm_scale), _DTYPE_CODES[q.dtype], stream,
        )
    _raise_on(err, "flash_attn_bwd_dq")
    _count("flash_attn_bwd_dq", q.dtype, skv)
    return dq


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash attention backward from the forward's o and lse: (dq, dk, dv).

    Shapes as :func:`flash_attention_bwd_reference`. On CUDA tensors it
    launches K4 then K5 (the shape contract of :func:`flash_attention`; o and
    do in q's dtype); on CPU tensors it runs
    :func:`flash_attention_bwd_reference`.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, kv_mask, o, lse, do, sm_scale)
    dk, dv, di = flash_attention_bwd_dkv(q, k, v, kv_mask, o, lse, do, sm_scale)
    return flash_attention_bwd_dq(q, k, v, kv_mask, lse, di, do, sm_scale), dk, dv


class FlashAttention(torch.autograd.Function):
    """Autograd of the flash attention (the reference's ``flash_attention``
    custom_vjp, flash_attention.py:357-394): the forward is K3 and saves q,
    k, v, the mask, o and lse, as ``_flash_fwd_rule``; the backward is K4 and
    K5. On CPU tensors both run their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, sm_scale):
        o, lse = _forward(q, k, v, kv_mask, sm_scale)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.sm_scale = sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, o, lse, do.to(q.dtype), ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention. q [B,Sq,H,D], k/v [B,Skv,H,D], kv_mask [B,Skv].
    Returns (o [B,Sq,H,D] in q's dtype, lse [B,H,Sq] fp32); o is
    differentiable in q, k and v.

    On CUDA tensors it launches K3 and, under grad, K4 and K5 in the backward
    (any lengths, head dim in
    :data:`~diffulab_tpu_torch.ops.fused_mha.KERNEL_HEAD_DIMS`, bf16 or fp32);
    on CPU tensors it runs the plain versions. Without grad (sampling) it is
    the forward alone and saves nothing.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, kv_mask, sm_scale)
    return _forward(q, k, v, kv_mask, sm_scale)
