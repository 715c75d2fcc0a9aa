"""Fused multi-head attention for short sequences (Hopper CUDA), forward and
backward.

**Forward (K1)** replaces the Pallas TPU kernel
``diffulab_tpu/ops/fused_mha.py::_mha_fwd_kernel`` (launched by
``_mha_forward``). What it computes, per (batch, head):

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
kernels. For bf16, persistent CTAs of two warpgroups walk (batch, head, 128
queries) items: TMA loads the head's K, then its V, into shared memory once
per item (the next item's while this one computes; where they do not fit,
one warpgroup a query tile streams them through a two-slot ring), ``wgmma``
forms a whole row of up to 256 scores in registers,
and ``p = exp(s - m)·(1/l)`` is rounded to bf16 straight into the register
operand of the PV ``wgmma`` — one pass over the keys; longer rows take two
(pass 1: row max and sum chunk by chunk; pass 2: the scores again, then PV),
so that K1's rounding order holds at any length. :func:`forward_instance`
picks the instance from the shape. For fp32 (bound by operations: 17.2
GFLOP at slice C1's B=128, S=256, H=8, D=64) the products run on the tensor
cores as 3xTF32 (each operand split into two TF32 halves, three ``mma.sync``
products, about 2^-21 relative each; :func:`matmul_3xtf32` emulates them),
one CTA per 64 queries in one pass over 32-key tiles with an online softmax
and o divided by l at the end (:func:`fused_mha_tf32x3_emulation`). The
UNets' head dims 192, 256, 384 and 512 have fp32 instances alone
(:data:`F32_ONLY_HEAD_DIMS`), built around the valid rows
(:data:`VALID_ROWS_HEAD_DIMS`; 64 tokens at D = 192 and 256, 16 at 384 and
512, padded to 128 keys): they take the unpadded query rows
(``ops/attention.py`` pads only k, v and the mask for them), neither load
nor multiply a key tile whose mask is all 0, and split each row's output and
the score products' reduction over D between column groups of warps
(:func:`f32_groups`); K2's dk/dv kernel writes zeros for a CTA whose keys
are all masked.

**Backward (K2)** replaces ``_mha_bwd_kernel`` (launched by
``_mha_backward``): from the saved q, k, v, mask and lse (o is not saved) it
recomputes ``p = exp(s - lse)`` in fp32 (0 on a row with lse = +inf) and
forms ``dv = round(p)ᵀ·do``, ``dp = do·vᵀ``, ``di = rowsum(p·dp)`` over the
whole key row, ``ds = p·(dp - di)·scale``, ``dq = round(ds)·k`` and
``dk = round(ds)ᵀ·q``, where ``round`` is the cast to the input dtype.
At the DiT-B/2 training shape (B=64, S=256, H=12, D=64, bf16) it reads q, k,
v, do and lse and writes dq, dk, dv: 176.9 MB, 52.8 µs at 3.35 TB/s, against
32.2 GFLOP (32.6 µs at 989 TFLOP/s): memory-bound. ``csrc/fused_mha_bwd.cu``
splits it in two kernels, launched back to back by one call, so that no sum
crosses CTAs and no atomics make the result depend on the run. In bf16 at
head dims 64 and 128 they are the flash backward's Hopper kernels
(``csrc/attn_bwd_hopper.cuh``): K5's dq kernel with a first pass over the
keys that forms di for its 128 queries (TMA-fed K and V, ``wgmma``, the
head's K and V loaded once for both passes up to 512 keys at head dim 64,
256 at 128), which writes lse·log2 e and di to an fp32 workspace
``[2, B, H, Sq]``; then K4's dk/dv kernel per 128 keys, which walks the
query tiles with that workspace. At
head dims 16 and 32, the first ``mma.sync`` kernels (64 queries or keys a
CTA). In fp32, 3xTF32 ``mma.sync`` kernels of 64 queries or keys a CTA: the
dq kernel keeps its fp32 p and dp in shared memory between the di pass and
the dq pass where they fit (the launch decides, ``f32_keeps`` in the source),
so the pair runs 7 products of [Sq x Skv x D] (the bound counts 5), else 9;
:func:`fused_mha_bwd_tf32x3_emulation` emulates both forms.

:func:`fused_mha_reference` and :func:`fused_mha_bwd_reference` are the
plain PyTorch versions with the same op order. Every call goes through
the ``torch.library`` custom ops ``torch.ops.diffulab_tpu_torch.fused_mha_fwd``
and ``fused_mha_bwd``: on CPU tensors they run the plain versions, on CUDA
tensors they launch the kernel or raise, and their fake implementations let
``torch.export`` keep a launch as one node (``deploy/export.py``).
:class:`FusedMHA` ties the two into autograd, as the reference's
``jax.custom_vjp`` does.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from diffulab_tpu_torch.ops import _build

#: finite additive mask value of the reference kernels (flash_attention.py:37)
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
#: sequence padding granularity of the fused path (flash_attention.py MIN_BLOCK)
MIN_BLOCK = 128
#: query rows of a tile and keys of a TMA box: Sq and Skv must be multiples
KERNEL_BLOCK = 64
#: head dims the kernels are instantiated for, bf16 and fp32
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
#: head dims with an fp32 instance alone (the UNet's: ``train_synthetic_ddpm.yaml``
#: at 192 and 384, the MNIST configs at 256 and 512); their bf16 instances are
#: ROADMAP queue 2a
F32_ONLY_HEAD_DIMS = (192, 256, 384, 512)
#: fp32 instances built around the valid rows: they take the unpadded query
#: rows (any Sq) and skip the key tiles whose mask is all 0
VALID_ROWS_HEAD_DIMS = (192, 256, 384, 512)
#: every head dim of the fused kernels K1/K2
FUSED_HEAD_DIMS = KERNEL_HEAD_DIMS + F32_ONLY_HEAD_DIMS
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: dynamic shared memory one block may use on an H100 (bytes)
SMEM_LIMIT = 232448
#: keys of one score product the bf16 kernel is instantiated for, by head dim:
#: a chunk of 256 scores takes 128 fp32 registers a thread, 128 at D=128
#: (whose output takes 64 more)
KERNEL_CHUNKS = {16: (64, 128, 192, 256), 32: (64, 128, 192, 256), 64: (64, 128, 192, 256), 128: (64, 128)}
#: keys of a ring slot when K and V stream instead of staying resident
STREAM_CHUNK = 64


class FwdInstance(NamedTuple):
    """The bf16 forward kernel instance a shape takes."""

    resident: bool  # the head's K and V loaded once into shared memory (else streamed through a ring)
    chunk: int  # keys of one score product; one pass over the keys when chunk == Skv
    buffers: int  # resident: with 2, the next item's loads overlap this one's compute; streamed: the ring's 2 slots
    smem: int  # dynamic shared memory bytes


def _smem_bytes(d: int, resident: bool, skv: int, buffers: int) -> int:
    """Shared memory of the bf16 kernel (``smem_bytes`` in the source): 1 KB
    of alignment slack; resident, per buffer two Q tiles and the head's K and
    V; streamed, one Q tile and two ring slots of K and V; then the mbarriers."""
    tile = KERNEL_BLOCK * d * 2
    data = buffers * (2 * tile + 2 * skv * d * 2) if resident else tile + 2 * 2 * STREAM_CHUNK * d * 2
    return 1024 + data + 128


@functools.lru_cache(maxsize=None)
def forward_instance(skv: int, d: int) -> FwdInstance:
    """The bf16 forward instance for ``Skv`` keys (a multiple of 64) and
    head dim ``d``, from the shape alone.

    K and V stay resident when a head's K and V and two Q tiles fit in shared
    memory: persistent CTAs of two warpgroups then walk (batch, head, 128
    queries) items, with a second buffer where it fits, so that the next
    item's loads overlap this one's compute. The chunk is the largest
    instantiated one that divides ``Skv``: the whole row, and one pass, up to
    256 keys (128 at D=128). Otherwise K and V stream in 64-key slots, one
    query tile a CTA.
    """
    for buffers in (2, 1):
        smem = _smem_bytes(d, True, skv, buffers)
        if smem <= SMEM_LIMIT:
            chunk = max(c for c in KERNEL_CHUNKS[d] if skv % c == 0)
            return FwdInstance(True, chunk, buffers, smem)
    return FwdInstance(False, STREAM_CHUNK, 2, _smem_bytes(d, False, skv, 2))


#: keys of a ring slot of the fp32 K1 at D <= 128 (``F32_KEYS`` in the source)
F32_KEYS = 32


def f32_keys(d: int) -> int:
    """Keys of a ring slot of the fp32 K1 at head dim ``d``, the tile of its
    online softmax: 32 at D <= 128 (``F32_KEYS`` in the source), and 8 at
    :data:`VALID_ROWS_HEAD_DIMS` (``VR_TILE``), where K2's dq kernel takes
    key tiles and its dk/dv kernel query tiles of the same size. This and
    :func:`f32_groups` mirror the built libraries'
    ``fused_mha_fwd_f32_tiles`` and ``fused_mha_bwd_f32_groups``, which
    chip_smoke.py holds them to on the card."""
    return 8 if d in VALID_ROWS_HEAD_DIMS else F32_KEYS


def f32_groups(d: int) -> int:
    """Column groups of warps that split the score products' D-reduction in
    the fp32 kernels (K1, and K2's dq and dk/dv kernels) at head dim ``d``:
    at :data:`VALID_ROWS_HEAD_DIMS` groups of 96 columns at D = 192, 64 at
    384 and 128 at 256 and 512 (``vr_cols``, ``vr_groups`` in
    ``csrc/tf32x3.cuh``), 2, 2, 6 and 4 groups at D = 192, 256, 384 and 512,
    each group's partial tile summed with the others' in group order; else 1."""
    return d // {192: 96, 384: 64}.get(d, 128) if d in VALID_ROWS_HEAD_DIMS else 1


def check_head_dim(d: int, dtype: torch.dtype, route: str = "fused") -> None:
    """Raise ``NotImplementedError`` unless the ``route``'s kernels ("fused":
    K1/K2, "flash": K3-K5) have an instance for head dim ``d`` in ``dtype``,
    naming ROADMAP queue 2a where the instance is queued: a bf16 tensor at an
    fp32-only dim, or the flash route at one."""
    if d in F32_ONLY_HEAD_DIMS and (route == "flash" or dtype != torch.float32):
        kernels = "flash kernels' instances" if route == "flash" else f"fused kernels' {dtype} instances"
        raise NotImplementedError(f"head dim {d}: the {kernels} at head dims {F32_ONLY_HEAD_DIMS} are not ported yet "
                                  "(ROADMAP queue 2a)")
    if d not in (FUSED_HEAD_DIMS if route == "fused" else KERNEL_HEAD_DIMS):
        raise NotImplementedError(f"head dim {d}: the attention kernels are instantiated for {KERNEL_HEAD_DIMS} "
                                  f"(and in fp32 for {F32_ONLY_HEAD_DIMS} on the fused route)")


#: launches of the CUDA kernels by :func:`fused_mha` and :func:`fused_mha_bwd`;
#: a ``_bf16`` key counts the launches of the bf16 instances alone, a
#: ``_f32_d<D>`` key those of the fp32 instance at an fp32-only head dim, and
#: the kernel's key counts them too (read by chip_smoke.py)
LAUNCHES = {"fused_mha_fwd": 0, "fused_mha_bwd": 0, "fused_mha_fwd_bf16": 0, "fused_mha_bwd_bf16": 0,
            **{f"fused_mha_{kind}_f32_d{d}": 0 for kind in ("fwd", "bwd") for d in F32_ONLY_HEAD_DIMS}}


#: the same launches by ``(kernel, dtype name, Skv)``: the padded key length a
#: launch took (read by chip_smoke.py, which tells the paths' lengths apart)
LAUNCHES_BY_KEYS: collections.Counter = collections.Counter()


def _count(name: str, d: int, dtype: torch.dtype, skv: int) -> None:
    LAUNCHES[name] += 1
    LAUNCHES_BY_KEYS[name, str(dtype).removeprefix("torch."), skv] += 1
    if dtype == torch.bfloat16:
        LAUNCHES[f"{name}_bf16"] += 1
    if d in F32_ONLY_HEAD_DIMS:
        LAUNCHES[f"{name}_f32_d{d}"] += 1


def _masked_scores(s, kv_mask, sm_scale) -> torch.Tensor:
    """``s·scale`` for raw scores ``[B, H, Sq, Skv]``, masked keys at the mask value."""
    s = s * sm_scale
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :].bool(), s, DEFAULT_MASK_VALUE)
    return s


def _scores(q, k, kv_mask, sm_scale) -> torch.Tensor:
    """fp32 ``s = q·kᵀ·scale`` ``[B, H, Sq, Skv]``, masked keys at the mask value."""
    return _masked_scores(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()), kv_mask, sm_scale)


def fused_mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel, in K1's op order.

    q [B,Sq,H,D], k/v [B,Skv,H,D], kv_mask bool [B,Skv] (True = attend).
    Returns (o [B,Sq,H,D] in q's dtype, lse [B,Sq,H] fp32).
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = _scores(q, k, kv_mask, sm_scale)
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


def _probs_and_dp(q, k, v, kv_mask, lse, do, sm_scale) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``p = exp(s - lse)`` (0 on an lse = +inf row) and ``dp = do·vᵀ``,
    both ``[B, H, Sq, Skv]``, from K1's lse ``[B, Sq, H]``."""
    p = torch.exp(_scores(q, k, kv_mask, sm_scale) - lse.permute(0, 2, 1)[..., None])
    return p, torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())


def fused_mha_bwd_di(q, k, v, kv_mask, lse, do, sm_scale: float | None = None) -> torch.Tensor:
    """K2's ``di = rowsum(p·dp)`` over the whole key row from the fp32 p and
    dp, fp32 ``[B, H, Sq]``: what the Hopper K2's dq kernel forms in its first
    pass and hands, with lse, to K4's dk/dv kernel."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    p, dp = _probs_and_dp(q, k, v, kv_mask, lse, do, sm_scale)
    return (p * dp).sum(dim=-1)


def fused_mha_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None,
    lse: torch.Tensor,
    do: torch.Tensor,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel, in K2's op order.

    q/do [B,Sq,H,D], k/v [B,Skv,H,D], kv_mask bool [B,Skv] or None, lse fp32
    [B,Sq,H] from the forward. Returns (dq, dk, dv) in q's, k's and v's dtypes.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    p, dp = _probs_and_dp(q, k, v, kv_mask, lse, do, sm_scale)
    # p rounds to do's dtype before dv = pᵀ·do
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    di = (p * dp).sum(dim=-1, keepdim=True)  # == rowsum(o·do), from the fp32 p
    ds = p * (dp - di) * sm_scale
    # ds rounds to the input dtype before dq = ds·k and dk = dsᵀ·q
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --- the fp32 kernels' arithmetic: 3xTF32 products, emulated ------------------------


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds: half of the 13 dropped bits added to the
    bit pattern, then the 13 bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two TF32 halves of x that the fp32 kernels' tensor cores read:
    ``hi = tf32_round(x)`` and ``lo = x - hi`` (exact in fp32) truncated to
    its top 19 bits, as the tensor cores take a TF32 operand from an fp32
    register."""
    hi = tf32_round(x)
    lo = (x.float() - hi).contiguous().view(torch.int32) & -0x2000
    return hi, lo.view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 ``a @ b`` (batched as :func:`torch.matmul`) as the fp32 kernels
    form it on the tensor cores (``csrc/tf32x3.cuh``): a and b split into
    TF32 halves, and per k step of 8 the fp32 accumulator takes lo·hi, then
    hi·lo, then hi·hi. hi·hi is exact in fp32; the dropped lo·lo and lo's
    truncation leave about 2^-21 of ``|a|@|b|``."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    acc = torch.zeros(*torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]), a.shape[-2], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        ka, kb = (..., slice(k0, k0 + 8)), (..., slice(k0, k0 + 8), slice(None))
        acc = acc + al[ka] @ bh[kb]
        acc = acc + ah[ka] @ bl[kb]
        acc = acc + ah[ka] @ bh[kb]
    return acc


def matmul_3xtf32_grouped(a: torch.Tensor, b: torch.Tensor, groups: int) -> torch.Tensor:
    """:func:`matmul_3xtf32` with the reduction split into ``groups`` equal
    chunks, each chunk's product formed alone and the partials added in
    order: the fp32 kernels' score products split over column groups."""
    if groups == 1:
        return matmul_3xtf32(a, b)
    n = a.shape[-1] // groups
    out = torch.zeros(())
    for c in range(groups):
        out = out + matmul_3xtf32(a[..., c * n:(c + 1) * n], b[..., c * n:(c + 1) * n, :])
    return out


def fused_mha_tf32x3_emulation(q, k, v, kv_mask=None, sm_scale=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 K1's tile math on fp32 CPU tensors: :func:`matmul_3xtf32`
    products, one pass over tiles of :func:`f32_keys` keys with an online row
    max and sum (the running o rescaled), and o divided by l at the end (not
    p before PV: fp32 p is never rounded to a narrower type, so the two
    orders differ in rounding only). At :data:`VALID_ROWS_HEAD_DIMS` the
    scores are the sum of the column groups' products (:func:`f32_groups`),
    and the kernels skip a key tile whose mask is all 0; that changes no
    value (a masked p is exactly 0, and alpha = 0 drops what a masked tile
    leaves before the first live one), so the emulation walks every tile.
    Returns (o [B,Sq,H,D], lse [B,Sq,H])."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    qh, kh, vh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))  # [B, H, S, D]
    b, h, sq, d = qh.shape
    m = torch.full((b, h, sq, 1), -torch.inf)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, d)
    kt = f32_keys(d)
    for n0 in range(0, kh.shape[2], kt):
        tile_mask = None if kv_mask is None else kv_mask[:, n0:n0 + kt]
        s = _masked_scores(matmul_3xtf32_grouped(qh, kh[:, :, n0:n0 + kt].transpose(-1, -2), f32_groups(d)),
                           tile_mask, sm_scale)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + matmul_3xtf32(p, vh[:, :, n0:n0 + kt])
        m = m_new
    o = acc / l
    lse = m + torch.log(l)
    if kv_mask is not None:
        dead = m <= DEFAULT_MASK_VALUE
        o = torch.where(dead, 0.0, o)
        lse = torch.where(dead, torch.inf, lse)
    return o.permute(0, 2, 1, 3).contiguous(), lse[..., 0].permute(0, 2, 1).contiguous()


def fused_mha_bwd_tf32x3_emulation(q, k, v, kv_mask, lse, do, sm_scale=None, kept=True):
    """The fp32 K2's split on fp32 CPU tensors, products by
    :func:`matmul_3xtf32`: the dq kernel's pass over the keys (``p = exp(s -
    lse)``, ``dp = do·vᵀ``, ``di = rowsum(p·dp)``), its dq = ds·k, then the
    dk/dv kernel's pᵀ = exp(k·qᵀ - lse), dv = pᵀ·do, dpᵀ = v·doᵀ, dsᵀ and dk
    = dsᵀ·q. ``kept``: the dq kernel that keeps p and dp between its passes,
    two warps a row each summing di and dq over one half of every 64-key
    step, half 0's sum plus half 1's; else the one that forms s and dp again
    for dq (the only one above D = 64). At :data:`VALID_ROWS_HEAD_DIMS` the
    score products are split over column groups (:func:`f32_groups`), and
    the key tiles the kernels skip add exact zeros here. Returns (dq, dk, dv,
    di [B,H,Sq])."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    groups = f32_groups(q.shape[-1])
    qh, kh, vh, doh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, do))  # [B, H, S, D]
    lse_r = lse.float().permute(0, 2, 1)[..., None]  # [B, H, Sq, 1]

    def probs_and_dp():
        s = matmul_3xtf32_grouped(qh, kh.transpose(-1, -2), groups)
        p = torch.exp(_masked_scores(s, kv_mask, sm_scale) - lse_r)
        return p, matmul_3xtf32_grouped(doh, vh.transpose(-1, -2), groups)

    p, dp = probs_and_dp()
    if kept:
        halves = [(torch.arange(kh.shape[2]) // 32) % 2 == i for i in (0, 1)]  # of each 64-key step
        di = sum((p[..., m] * dp[..., m]).sum(dim=-1, keepdim=True) for m in halves)
        ds = p * (dp - di) * sm_scale
        dq = sum(matmul_3xtf32(ds[..., m], kh[:, :, m]) for m in halves)
    else:
        di = (p * dp).sum(dim=-1, keepdim=True)
        p, dp = probs_and_dp()
        dq = matmul_3xtf32(p * (dp - di) * sm_scale, kh)
    # the dk/dv kernel: rows are keys, masked by key; lse and di by query column
    st = matmul_3xtf32_grouped(kh, qh.transpose(-1, -2), groups) * sm_scale
    if kv_mask is not None:
        st = torch.where(kv_mask[:, None, :, None].bool(), st, DEFAULT_MASK_VALUE)
    pt = torch.exp(st - lse_r.transpose(-1, -2))
    dv = matmul_3xtf32(pt, doh)
    dst = pt * (matmul_3xtf32_grouped(vh, doh.transpose(-1, -2), groups) - di.transpose(-1, -2)) * sm_scale
    dk = matmul_3xtf32(dst, qh)
    back = (t.permute(0, 2, 1, 3).contiguous() for t in (dq, dk, dv))
    return (*back, di[..., 0])


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """The kernels read each row with 16-byte loads or TMA boxes: heads
    contiguous (strides ``(.., .., D, 1)``), rows and the base 16-byte
    aligned. A view such as the v slice of the packed qkv output passes as it
    is; so does a gradient that arrives contiguous, and one that does not is
    copied."""
    sb, ss, sh, sd = t.stride()
    items = 16 // t.element_size()
    if sd == 1 and sh == t.shape[3] and ss % items == 0 and sb % items == 0 and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def _check_cuda_inputs(q, k, v, kv_mask, route: str = "fused", name: str = "fused_mha") -> None:
    """Raise unless q/k/v/kv_mask meet the ``route``'s kernels' device, shape
    and dtype contract: Sq and Skv nonzero multiples of :data:`KERNEL_BLOCK`
    (of 1 on the flash route; Sq any nonzero length for the fp32 instances at
    :data:`VALID_ROWS_HEAD_DIMS`), the head dim one :func:`check_head_dim`
    takes."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {device}")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    kv_shape = (b, skv, h, d)
    if k.shape != kv_shape or v.shape != kv_shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    dtype = q.dtype
    if dtype not in _DTYPE_CODES or k.dtype != dtype or v.dtype != dtype:
        raise ValueError(f"{name} takes bf16 or fp32 q/k/v of one dtype, got {dtype}/{k.dtype}/{v.dtype}")
    check_head_dim(d, dtype, route)
    block = 1 if route == "flash" else KERNEL_BLOCK
    q_block = 1 if route == "fused" and d in VALID_ROWS_HEAD_DIMS else block
    if sq < 1 or skv < 1 or sq % q_block or skv % block:
        raise ValueError(f"Sq={sq} must be a nonzero multiple of {q_block}, Skv={skv} of {block}")
    if k.device != device or v.device != device:
        raise ValueError("q, k and v must be on one device")
    if kv_mask is not None and kv_mask.shape != (b, skv):
        raise ValueError(f"kv_mask shape {tuple(kv_mask.shape)} != {(b, skv)}")


def _int_mask(kv_mask: torch.Tensor | None, device: torch.device) -> torch.Tensor | None:
    if kv_mask is None:
        return None
    return kv_mask.to(device=device, dtype=torch.int32).contiguous()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({_build.error_string(err)})")


def fused_mha_fwd_cuda(q, k, v, kv_mask, sm_scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 on CUDA tensors: launches the kernel or raises. The CUDA
    implementation of the ``fused_mha_fwd`` op, which every caller goes
    through (:func:`fused_mha`)."""
    _check_cuda_inputs(q, k, v, kv_mask)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
    device = q.device
    mask = _int_mask(kv_mask, device)  # held until the launch: o must not take its memory
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=device)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=device)
    # the bf16 kernel's instance; the fp32 kernel takes its tiles from the head dim alone
    inst = forward_instance(skv, d) if q.dtype == torch.bfloat16 else None
    q_sb, q_ss = q.stride()[:2]
    k_sb, k_ss = k.stride()[:2]
    v_sb, v_ss = v.stride()[:2]
    # the C side makes the tensors' device current for the launch
    err = _build.load("fused_mha_fwd").fused_mha_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, sq, skv, h, d, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
        sm_scale, _DTYPE_CODES[q.dtype], *((inst.resident, inst.chunk, inst.buffers) if inst else (0, 0, 0)),
        device.index, torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(err, "fused_mha_fwd")
    _count("fused_mha_fwd", d, q.dtype, skv)
    return o, lse


def fused_mha_bwd_cuda(q, k, v, kv_mask, lse, do, sm_scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 on CUDA tensors: launches the kernel or raises (the contract of
    :func:`fused_mha_bwd`). The CUDA implementation of the ``fused_mha_bwd``
    op."""
    _check_cuda_inputs(q, k, v, kv_mask)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} does not match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, sq, h) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be fp32 {(b, sq, h)} on {q.device}, got {tuple(lse.shape)} {lse.dtype}")
    q, k, v, do = (_kernel_ready(t) for t in (q, k, v, do))
    lse = lse.contiguous()
    mask = _int_mask(kv_mask, q.device)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, skv, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, skv, h, d), dtype=v.dtype, device=q.device)
    ws = torch.empty((2, b, h, sq), dtype=torch.float32, device=q.device)  # lse (·log2 e in bf16) and di, or di
    lib = _build.load("fused_mha_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.fused_mha_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            None if mask is None else mask.data_ptr(), lse.data_ptr(), ws.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, skv, h, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            do.stride(0), do.stride(1),
            ctypes.c_float(sm_scale), _DTYPE_CODES[q.dtype], stream,
        )
    _raise_on(err, "fused_mha_bwd")
    _count("fused_mha_bwd", d, q.dtype, skv)
    return dq, dk, dv


# --- K1 and K2 as torch.library custom ops -------------------------------------------
#
# Every call of the kernels goes through these ops, so that ``torch.export``
# keeps each launch as one node of its graph (``deploy/export.py``). An op on
# CPU tensors runs the plain version; on CUDA tensors it launches the kernel
# or raises (no CUDA implementation falls back to the plain version); the
# fake implementation states the outputs' shapes and dtypes for tracing.

#: the namespace of the port's custom ops: ``torch.ops.diffulab_tpu_torch.<kernel>``
OPS_NAMESPACE = "diffulab_tpu_torch"


def _register(name: str, schema: str, cpu, cuda, fake):
    """The custom op ``OPS_NAMESPACE::name``: ``cpu`` its plain version,
    ``cuda`` its kernel's launch, ``fake`` its output shapes."""
    op = torch.library.custom_op(f"{OPS_NAMESPACE}::{name}", cpu, mutates_args=(), device_types="cpu",
                                 schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    return op


def _fused_mha_fwd_fake(q, k, v, kv_mask, sm_scale):
    b, sq, h, d = q.shape
    return q.new_empty((b, sq, h, d)), q.new_empty((b, sq, h), dtype=torch.float32)


def _fused_mha_bwd_fake(q, k, v, kv_mask, lse, do, sm_scale):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


#: K1: (q, k, v, kv_mask, sm_scale) -> (o, lse), as :func:`fused_mha_reference`
fused_mha_fwd_op = _register(
    "fused_mha_fwd", "(Tensor q, Tensor k, Tensor v, Tensor? kv_mask, float sm_scale) -> (Tensor, Tensor)",
    fused_mha_reference, fused_mha_fwd_cuda, _fused_mha_fwd_fake)
#: K2: (q, k, v, kv_mask, lse, do, sm_scale) -> (dq, dk, dv), as :func:`fused_mha_bwd_reference`
fused_mha_bwd_op = _register(
    "fused_mha_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor? kv_mask, Tensor lse, Tensor do, float sm_scale) -> (Tensor, Tensor, Tensor)",
    fused_mha_bwd_reference, fused_mha_bwd_cuda, _fused_mha_bwd_fake)


def fused_mha_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None,
    lse: torch.Tensor,
    do: torch.Tensor,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused attention backward from the forward's lse: (dq, dk, dv).

    Shapes as :func:`fused_mha_bwd_reference`. Through the ``fused_mha_bwd``
    op: on CUDA tensors it launches the kernel (the shape contract of
    :func:`fused_mha`; ``do`` in q's dtype); on CPU tensors it runs
    :func:`fused_mha_bwd_reference`.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mha_bwd runs on CUDA or CPU tensors, got {q.device}")
    return fused_mha_bwd_op(q, k, v, kv_mask, lse, do, sm_scale)


class FusedMHA(torch.autograd.Function):
    """Autograd of the fused attention (the reference's ``fused_mha``
    custom_vjp, fused_mha.py:218-254): the forward is K1 and saves q, k, v,
    the mask and lse — not o; the backward is K2. On CPU tensors both run
    their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, sm_scale):
        o, lse = fused_mha_fwd_op(q, k, v, kv_mask, sm_scale)
        ctx.save_for_backward(q, k, v, kv_mask, lse)
        ctx.sm_scale = sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, kv_mask, lse = ctx.saved_tensors
        dq, dk, dv = fused_mha_bwd(q, k, v, kv_mask, lse, do.to(q.dtype), ctx.sm_scale)
        return dq, dk, dv, None, None


def fused_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused attention. q [B,Sq,H,D], k/v [B,Skv,H,D], kv_mask [B,Skv].
    Returns (o, lse); o is differentiable in q, k and v.

    On CUDA tensors it launches the kernels (Sq and Skv multiples of 64,
    head dim in :data:`KERNEL_HEAD_DIMS` in bf16 or fp32, or in
    :data:`F32_ONLY_HEAD_DIMS` in fp32, where at :data:`VALID_ROWS_HEAD_DIMS`
    Sq may be any length — pad through
    :func:`diffulab_tpu_torch.ops.attention.dot_product_attention`); on CPU
    tensors it runs the plain versions. Without grad (sampling) it is the
    forward alone and saves nothing.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mha runs on CUDA or CPU tensors, got {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FusedMHA.apply(q, k, v, kv_mask, sm_scale)
    return fused_mha_fwd_op(q, k, v, kv_mask, sm_scale)
