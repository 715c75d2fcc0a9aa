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
UNets' head dims 192, 256, 384 and 512 (:data:`VALID_ROWS_HEAD_DIMS`; 64
tokens at D = 192 and 256, 16 at 384 and 512, padded to 128 keys) have
instances of their own in both dtypes, built around the valid rows: they
take the unpadded query rows (``ops/attention.py`` pads only k, v and the
mask for them), neither load nor multiply a key tile whose mask is all 0,
and split each row's output between column groups of warps; K2 writes
zeros for the keys whose mask tile is all 0. In fp32 at D = 192 and 384,
and K1 at 512, the groups split the score products' reduction over D too
(:func:`f32_groups`), and the products are 3xTF32 over tiles of 8 keys; K2
at 256 and 512 (:data:`STAGED_F32_HEAD_DIMS`) and K1 at 256
(:data:`STAGED_F32_FWD_HEAD_DIMS`) are staged (:func:`f32_staged`): a slot
of the live 8-key tiles (64 keys at 256, 16 at 512: the UNet's whole live
row), D staged in chunks through a cp.async ring, each warp's score sums
over the whole of D, each chunk's 3xTF32 product from zero; K1 keeps
``p = exp(s - m) / l`` in fp32 registers for P.V
(:func:`fused_mha_tf32x3_staged_emulation`), and K2 is one kernel a batch
and head that forms s and dp once, keeps p and ds in shared memory and
forms dq, dk and dv a chunk of columns at a time, a head's row blocks in
turn (:func:`fused_mha_bwd_tf32x3_staged_emulation`). In bf16 the instances are
staged: a slot of :func:`bf16_keys` keys (64 at D = 192 and 256, 16 at 384
and 512: the UNets' whole live row) gathered from the mask's live 16-key
tiles is requested at once, K beside V, each warp forms its rows' scores
over the whole of D by ``mma.sync`` m16n8k16 and the groups
(:func:`bf16_groups`) split only the output columns; K1 keeps its rounding order in two passes over the slots, m and l first, then
``p = exp(s - m)·(1 / l)`` rounded to bf16 before PV, a one-slot row's p
kept in registers (:func:`fused_mha_bf16_valid_emulation`); K2 runs as one
kernel a batch and head where the head's valid query rows fit one CTA.
At head dim 64 (:data:`SHORT_ROWS_HEAD_DIM`) the same instances stand
beside the padded ones for the DiTs' short sequences that the fused route
pads (64 or 72 tokens to 128 keys, 264 to 384): the kernels' wrappers take
them wherever Sq is not a multiple of 128 (:func:`takes_valid_rows`), and
the route hands them the unpadded rows where they are the faster
(:func:`route_takes_valid_rows`: in fp32 at every such Sq up to the fused
route's 512, in bf16 up to 64 rows, so G1's 64-token DiT; the padded bf16
instances keep the hard pair's 72 and 264). There one column group holds
the head, the CTA lists its live key tiles once in shared memory, the
tiles are 32 (fp32) or 64 keys (bf16), the bf16 ones
exponentiate with ``__expf``, and the fp32 dq kernel keeps a 64-token row's
p and dp in registers between its passes.

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
:func:`fused_mha_bwd_tf32x3_emulation` emulates both forms. The staged fp32
K2 at :data:`STAGED_F32_HEAD_DIMS` runs as one kernel a batch and head at any
Sq (its row blocks in turn), the bf16 K2 at the UNets' head dims where the
head's rows fit one CTA: no workspace, no second launch.

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
#: head dims of every kernel, K1-K5, bf16 and fp32
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
#: the UNets' head dims (``train_synthetic_ddpm.yaml`` at 192 and 384, the MNIST
#: configs at 256 and 512): K1/K2 instances in bf16 and fp32 built around the
#: valid rows, which take the unpadded query rows (any Sq) and skip the key
#: tiles whose mask is all 0; the flash kernels' instances there are ROADMAP
#: queue 2a
VALID_ROWS_HEAD_DIMS = (192, 256, 384, 512)
#: every head dim of the fused kernels K1/K2
FUSED_HEAD_DIMS = KERNEL_HEAD_DIMS + VALID_ROWS_HEAD_DIMS
#: the head dim whose instances built around the valid rows stand beside the
#: padded ones: the DiTs' short sequences that the fused route pads (64 or 72
#: tokens to 128 keys, 264 to 384) take them (:func:`takes_valid_rows`)
SHORT_ROWS_HEAD_DIM = 64
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


#: the head dims of the staged fp32 K2 (the MNIST UNet's, ``csrc/tf32x3.cuh``'s
#: ``staged_f32_instance``): a slot of live keys, D staged in chunks, each warp's scores over the whole of D
STAGED_F32_HEAD_DIMS = (256, 512)
#: the head dims of the staged fp32 K1: at 512 the split instance of 8-key tiles stays (the faster at the
#: sampler's batch)
STAGED_F32_FWD_HEAD_DIMS = (256,)
#: the staged fp32 K1's query rows a CTA and columns of D a stage, each stage's score sum from zero
#: (``VR_F32S_FWD_ROWS``, ``VR_F32S_FWD_CHUNK``)
F32_STAGED_FWD_ROWS = 64
F32_STAGED_FWD_CHUNK = 64
#: keys of the mask's liveness tiles of the fp32 instances at :data:`VALID_ROWS_HEAD_DIMS` (``VR_TILE``)
F32_LIVE_KEYS = 8


class F32Staged(NamedTuple):
    """The rules of the staged fp32 K2 at a head dim of
    :data:`STAGED_F32_HEAD_DIMS` (``vr_f32s_*`` in ``csrc/tf32x3.cuh``)."""

    slot: int  # keys of a slot, gathered from the live 8-key tiles (K2, and K1 at 256)
    rows: int  # query rows a CTA (a row block; a longer head's blocks in turn)
    chunk: int  # columns of D a stage holds
    parts: int  # score sums a stage, each over chunk / parts columns from zero, added in order
    key_parts: int  # warps that split a slot's keys for the s (and the dp) of 16 rows


def f32_staged(d: int) -> F32Staged:
    """The staged fp32 K2's rules at head dim ``d`` (one of
    :data:`STAGED_F32_HEAD_DIMS`): a slot of 64 keys and 64 rows at D = 256,
    16 and 16 at 512 (the UNet's whole live row and a head's valid rows); it
    stages 32 columns (128 at 512) in 1 (4) score sums a stage and splits a
    slot's keys between 1 (2) warps. The staged K1 at 256 takes the same slot
    (:data:`F32_STAGED_FWD_ROWS`, :data:`F32_STAGED_FWD_CHUNK`). They mirror
    the built libraries' ``fused_mha_{fwd,bwd}_valid_tiles``, which
    chip_smoke.py holds them to on the card."""
    if d not in STAGED_F32_HEAD_DIMS:
        raise ValueError(f"head dim {d} has no staged fp32 instance (only {STAGED_F32_HEAD_DIMS})")
    if d == 256:
        return F32Staged(slot=64, rows=64, chunk=32, parts=1, key_parts=1)
    return F32Staged(slot=16, rows=16, chunk=128, parts=4, key_parts=2)


def f32_keys(d: int, valid_rows: bool = False) -> int:
    """Keys of a ring slot of the fp32 K1 at head dim ``d``, the tile of its
    online softmax: 32 at D <= 128 (``F32_KEYS`` in the source), 8 at D = 192,
    384 and 512 (``VR_TILE``), where K2's dq kernel takes key tiles and its
    dk/dv kernel query tiles of the same size (at 192 and 384), and at
    :data:`STAGED_F32_FWD_HEAD_DIMS` the staged instance's slot
    (:func:`f32_staged`: 64 at 256);
    with ``valid_rows``, the instance built around the valid rows at
    :data:`SHORT_ROWS_HEAD_DIM`: 32 (``vr_tile`` in the source). This and
    :func:`f32_groups` mirror the built libraries'
    ``fused_mha_fwd_f32_tiles``, ``fused_mha_{fwd,bwd}_valid_tiles`` and
    ``fused_mha_bwd_f32_groups``, which chip_smoke.py holds them to on the
    card."""
    if valid_rows and d == SHORT_ROWS_HEAD_DIM:
        return 32
    if d in STAGED_F32_FWD_HEAD_DIMS:
        return f32_staged(d).slot
    return F32_LIVE_KEYS if d in VALID_ROWS_HEAD_DIMS else F32_KEYS


def f32_groups(d: int, backward: bool = False) -> int:
    """Column groups of warps that split the score products' D-reduction in
    the fp32 kernels built around the valid rows at head dim ``d`` (K1, or
    with ``backward`` K2's dq and dk/dv kernels): at D = 192 and 384 groups
    of 96 and 64 columns (``vr_cols``, ``vr_groups`` in
    ``csrc/tf32x3.cuh``), 2 and 6 groups, and K1's 4 groups of 128 at 512,
    each group's partial tile summed with the others' in group order; else 1
    (the fp32 kernels at D <= 128, and the staged ones, K2 at
    :data:`STAGED_F32_HEAD_DIMS` and K1 at :data:`STAGED_F32_FWD_HEAD_DIMS`,
    where each warp forms its scores over the whole of D)."""
    if d == 512 and not backward:
        return 4
    return d // {192: 96, 384: 64}[d] if d in (192, 384) else 1


#: live tiles whose scores the bf16 K1 built around the valid rows at
#: :data:`SHORT_ROWS_HEAD_DIM` keeps in registers between its two passes
#: (``VR_BF16_KEEP``): a 64-token row loads K once, a longer one K again
BF16_KEPT_TILES = 1

#: keys of the mask's liveness tiles at :data:`VALID_ROWS_HEAD_DIMS`
#: (``VR_BF16_TILE``): a tile with an attended key is live, and a staged slot
#: gathers the live ones (:func:`bf16_keys` keys a slot)
BF16_LIVE_KEYS = 16


def bf16_keys(d: int, valid_rows: bool = False) -> int:
    """Keys (K1, K2's dq kernel) or queries (K2's dk/dv kernel) of a slot of
    the bf16 instances at head dim ``d`` where they are built around the
    valid rows: at :data:`VALID_ROWS_HEAD_DIMS` the staged instances' slot
    (``vr_bf16_slot`` in ``csrc/bf16_valid.cuh``), 64 at D = 192 and 256, 16
    at 384 and 512, gathered from live tiles of :data:`BF16_LIVE_KEYS` keys;
    with ``valid_rows`` 64 at :data:`SHORT_ROWS_HEAD_DIM`, where a slot is one
    tile (``vr_bf16_tile``); 0 elsewhere. This, :func:`bf16_groups`,
    :func:`bf16_rows` and :data:`BF16_KEPT_TILES` mirror the built libraries'
    ``fused_mha_fwd_bf16_tiles``, ``fused_mha_{fwd,bwd}_valid_tiles`` and
    ``fused_mha_bwd_bf16_tiles``, which chip_smoke.py holds them to on the
    card."""
    if valid_rows and d == SHORT_ROWS_HEAD_DIM:
        return 64
    return {192: 64, 256: 64, 384: 16, 512: 16}.get(d, 0)


def bf16_groups(d: int, backward: bool = False) -> int:
    """Column groups of warps of the bf16 instances built around the valid
    rows at head dim ``d``, K1's or (``backward``) K2's: at
    :data:`VALID_ROWS_HEAD_DIMS` the staged instances' (``vr_bf16_groups``:
    K1 one group at D = 192 and 256, groups of 128 columns at 384 and 512;
    K2 96, 128, 64 and 128 columns), which split only the output columns,
    each warp forming its rows' scores over the whole of D; 1 at
    :data:`SHORT_ROWS_HEAD_DIM`."""
    if d not in VALID_ROWS_HEAD_DIMS:
        return 1
    if backward:
        return d // {192: 96, 384: 64}.get(d, 128)
    return 1 if d <= 256 else d // 128


def bf16_rows(d: int) -> int:
    """Query rows (keys in K2's dk/dv kernel) a CTA of the bf16 instances
    built around the valid rows at head dim ``d`` (``vr_bf16_rows``, and
    ``vr_rows`` at :data:`SHORT_ROWS_HEAD_DIM`): a head's 64 valid rows at D =
    64, 192 and 256, its 16 at 384 and 512."""
    return 16 if d in (384, 512) else 64


def takes_valid_rows(sq: int, d: int) -> bool:
    """Whether K1 and K2 on ``sq`` query rows at head dim ``d`` run their
    instances built around the valid rows (the unpadded query rows, any Sq;
    the key tiles whose mask is all 0 skipped): always at
    :data:`VALID_ROWS_HEAD_DIMS`, where they are the only ones; at
    :data:`SHORT_ROWS_HEAD_DIM` where ``sq`` is not a whole number of
    :data:`MIN_BLOCK` rows (64, 72 or 264 tokens), in both dtypes, so that
    the fused route pads k, v and the mask alone there; else the padded
    instances. A rule of the shape alone: the route reads it on the unpadded
    ``sq``, the kernels' wrappers on the rows they are handed, and a padded
    ``sq`` is a whole number of blocks, so the two agree."""
    return d in VALID_ROWS_HEAD_DIMS or (d == SHORT_ROWS_HEAD_DIM and sq % MIN_BLOCK != 0)


#: the most query rows at :data:`SHORT_ROWS_HEAD_DIM` that the fused route hands
#: the instances built around the valid rows unpadded, by dtype; above it the
#: route pads them to :data:`MIN_BLOCK` rows and the padded instances run,
#: which are the faster there (the crossover measured by
#: ``scripts/d64_valid_variants.py`` and ``scripts/ab_fused_mha_{fwd,bwd}.py
#: --short``, PERF.md §6)
SHORT_ROWS_MAX_SQ = {torch.float32: 512, torch.bfloat16: 64}


def route_takes_valid_rows(sq: int, d: int, dtype: torch.dtype) -> bool:
    """Whether the fused route (``ops/attention.py``) hands K1 and K2 the
    unpadded ``sq`` query rows: where :func:`takes_valid_rows`, except at
    :data:`SHORT_ROWS_HEAD_DIM` above :data:`SHORT_ROWS_MAX_SQ` rows in
    ``dtype``, where it pads them so that the padded instances run. By the
    shape and the dtype alone."""
    if d == SHORT_ROWS_HEAD_DIM:
        return takes_valid_rows(sq, d) and sq <= SHORT_ROWS_MAX_SQ.get(dtype, 0)
    return takes_valid_rows(sq, d)


def check_head_dim(d: int, route: str = "fused") -> None:
    """Raise ``NotImplementedError`` unless the ``route``'s kernels ("fused":
    K1/K2, "flash": K3-K5) have an instance for head dim ``d`` (in both
    dtypes), naming ROADMAP queue 2a for the flash route at
    :data:`VALID_ROWS_HEAD_DIMS`, where its instances are queued."""
    if route == "flash" and d in VALID_ROWS_HEAD_DIMS:
        raise NotImplementedError(f"head dim {d}: the flash kernels' instances at head dims {VALID_ROWS_HEAD_DIMS} "
                                  "are not ported yet (ROADMAP queue 2a)")
    if d not in (FUSED_HEAD_DIMS if route == "fused" else KERNEL_HEAD_DIMS):
        raise NotImplementedError(f"head dim {d}: the attention kernels are instantiated for {KERNEL_HEAD_DIMS} "
                                  f"(and for {VALID_ROWS_HEAD_DIMS} on the fused route)")


#: launches of the CUDA kernels by :func:`fused_mha` and :func:`fused_mha_bwd`;
#: a ``_bf16`` key counts the launches of the bf16 instances alone, a
#: ``_{f32,bf16}_d<D>`` key those of the instance of that dtype at a head dim
#: of :data:`VALID_ROWS_HEAD_DIMS`, ``_valid_d64`` those of the instances
#: built around the valid rows at :data:`SHORT_ROWS_HEAD_DIM` (and
#: ``_valid_d64_bf16`` of the bf16 one alone), and the kernel's key counts
#: them too (read by chip_smoke.py)
LAUNCHES = {"fused_mha_fwd": 0, "fused_mha_bwd": 0, "fused_mha_fwd_bf16": 0, "fused_mha_bwd_bf16": 0,
            **{f"fused_mha_{kind}_{dt}_d{d}": 0 for kind in ("fwd", "bwd") for dt in ("f32", "bf16")
               for d in VALID_ROWS_HEAD_DIMS},
            **{f"fused_mha_{kind}_valid_d{SHORT_ROWS_HEAD_DIM}{dt}": 0 for kind in ("fwd", "bwd")
               for dt in ("", "_bf16")}}


#: the same launches by ``(kernel, dtype name, Skv)``: the padded key length a
#: launch took (read by chip_smoke.py, which tells the paths' lengths apart)
LAUNCHES_BY_KEYS: collections.Counter = collections.Counter()


def _count(name: str, d: int, dtype: torch.dtype, skv: int, valid_rows: bool) -> None:
    LAUNCHES[name] += 1
    LAUNCHES_BY_KEYS[name, str(dtype).removeprefix("torch."), skv] += 1
    bf16 = dtype == torch.bfloat16
    if bf16:
        LAUNCHES[f"{name}_bf16"] += 1
    if d in VALID_ROWS_HEAD_DIMS:
        LAUNCHES[f"{name}_{'bf16' if bf16 else 'f32'}_d{d}"] += 1
    elif valid_rows:
        LAUNCHES[f"{name}_valid_d{d}"] += 1
        if bf16:
            LAUNCHES[f"{name}_valid_d{d}_bf16"] += 1


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
    orders differ in rounding only). The instance is the one the kernels'
    wrapper picks for the shape (:func:`takes_valid_rows`). Those built
    around the valid rows skip a key tile whose mask is all 0; that changes
    no value (a masked p is exactly 0, and alpha = 0 drops what a masked tile
    leaves before the first live one), so the emulation walks every tile. At
    D = 192 and 384 the scores are the sum of the column groups' products
    (:func:`f32_groups`); at :data:`STAGED_F32_FWD_HEAD_DIMS` it is
    :func:`fused_mha_tf32x3_staged_emulation`. Returns (o [B,Sq,H,D], lse
    [B,Sq,H])."""
    if q.shape[-1] in STAGED_F32_FWD_HEAD_DIMS:
        return fused_mha_tf32x3_staged_emulation(q, k, v, kv_mask, sm_scale)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    qh, kh, vh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))  # [B, H, S, D]
    b, h, sq, d = qh.shape
    m = torch.full((b, h, sq, 1), -torch.inf)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, d)
    kt = f32_keys(d, takes_valid_rows(sq, d))
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
    = dsᵀ·q. ``kept``: the padded dq kernel that keeps p and dp between its
    passes, two warps a row each summing di and dq over one half of every
    64-key step, half 0's sum plus half 1's; else one warp a row sums them
    key tile after key tile (the instances above D = 64, and those built
    around the valid rows at :data:`SHORT_ROWS_HEAD_DIM`, whose fp32 dq kernel
    keeps a 64-token row's p and dp too). At D = 192 and 384 the score
    products are split over column groups (:func:`f32_groups`), and the key
    tiles the kernels skip add exact zeros here; at
    :data:`STAGED_F32_HEAD_DIMS` it is
    :func:`fused_mha_bwd_tf32x3_staged_emulation` (``kept`` unread). Returns
    (dq, dk, dv, di [B,H,Sq])."""
    if q.shape[-1] in STAGED_F32_HEAD_DIMS:
        return fused_mha_bwd_tf32x3_staged_emulation(q, k, v, kv_mask, lse, do, sm_scale)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    groups = f32_groups(q.shape[-1], backward=True)
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


def f32_slots(mask_row: torch.Tensor | None, skv: int, d: int) -> list[torch.Tensor]:
    """The key indices of the slots that the staged fp32 instances walk for
    one batch row at head dim ``d`` (:data:`STAGED_F32_HEAD_DIMS`): the live
    tiles of :data:`F32_LIVE_KEYS` keys (a tile with an attended key; every
    tile without a mask) in order, :func:`f32_staged` ``.slot`` keys a slot."""
    slot = f32_staged(d).slot
    tiles = torch.arange(skv).reshape(-1, F32_LIVE_KEYS)
    if mask_row is not None:
        tiles = tiles[mask_row.bool().reshape(-1, F32_LIVE_KEYS).any(dim=1)]
    keys = tiles.reshape(-1)
    return [keys[i:i + slot] for i in range(0, keys.numel(), slot)]


def _chunked_scores(a: torch.Tensor, b: torch.Tensor, chunk: int) -> torch.Tensor:
    """``a·bᵀ`` over D as the staged instances sum it: each chunk of
    ``chunk`` columns a :func:`matmul_3xtf32` product from zero, the chunks
    added in order in fp32."""
    return matmul_3xtf32_grouped(a, b.transpose(-1, -2), a.shape[-1] // chunk)


def fused_mha_tf32x3_staged_emulation(q, k, v, kv_mask=None, sm_scale=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The staged fp32 K1's arithmetic (``csrc/fused_mha_fwd.cu::
    mha_fwd_tf32x3_staged``) on fp32 CPU tensors at :data:`STAGED_F32_FWD_HEAD_DIMS`:
    for each batch row the slots of :func:`f32_slots`; a slot's scores summed
    over D a stage at a time (:data:`F32_STAGED_FWD_CHUNK` columns, each
    stage's 3xTF32 product from zero); m and l over the slots in order, then
    ``p = exp(s - m) / l`` normalised before P.V and kept in fp32; o the sum
    of the slots' ``p·v`` (each a :func:`matmul_3xtf32` product), added in
    slot order. A row without an attended key gives o = 0, lse = +inf.
    Returns (o [B,Sq,H,D], lse [B,Sq,H])."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    qh, kh, vh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))  # [B, H, S, D]
    b, h, sq, d = qh.shape
    if d not in STAGED_F32_FWD_HEAD_DIMS:
        raise ValueError(f"head dim {d} has no staged fp32 K1 (only {STAGED_F32_FWD_HEAD_DIMS})")
    o = torch.zeros(b, h, sq, d)
    lse = torch.full((b, h, sq, 1), torch.inf)
    for bi in range(b):
        row = None if kv_mask is None else kv_mask[bi]
        slots = f32_slots(row, kh.shape[2], d)

        def scores(keys):
            s = _chunked_scores(qh[bi], kh[bi][:, keys], F32_STAGED_FWD_CHUNK) * sm_scale
            return s if row is None else torch.where(row[keys].bool(), s, DEFAULT_MASK_VALUE)

        m = torch.full((h, sq, 1), -torch.inf)
        l = torch.zeros(h, sq, 1)
        for keys in slots:
            s = scores(keys)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(dim=-1, keepdim=True)
            m = m_new
        dead = (m <= DEFAULT_MASK_VALUE) if row is not None else torch.zeros_like(m, dtype=torch.bool)
        for keys in slots:
            p = torch.where(dead, 0.0, torch.exp(scores(keys) - m) / l)
            o[bi] = o[bi] + matmul_3xtf32(p, vh[bi][:, keys])
        if slots:
            lse[bi] = torch.where(dead, torch.inf, m + torch.log(l))
    return o.permute(0, 2, 1, 3).contiguous(), lse[..., 0].permute(0, 2, 1).contiguous()


def fused_mha_bwd_tf32x3_staged_emulation(q, k, v, kv_mask, lse, do, sm_scale=None):
    """The staged fp32 K2's arithmetic (``csrc/fused_mha_bwd.cu::
    mha_bwd_fused_tf32x3_staged``, one kernel a batch and head) on fp32 CPU
    tensors at :data:`STAGED_F32_HEAD_DIMS`, products by
    :func:`matmul_3xtf32`: the query rows in blocks of :func:`f32_staged`
    ``.rows``, the keys in the slots of :func:`f32_slots`; a slot's s and dp
    summed over D a partial at a time (``.chunk // .parts`` columns, each from
    zero), formed once; ``p = exp(s - lse)``, ``di = rowsum(p·dp)`` from the fp32 p and dp
    (a slot's sum, the slots' added in order), ``ds = p·(dp - di)·scale``;
    ``dq`` the sum of the slots' ``ds·k`` in slot order, ``dk`` and ``dv`` the
    sums of the row blocks' ``dsᵀ·q`` and ``pᵀ·do`` in block order; the keys
    of the tiles without an attended key get exact zeros. Returns (dq, dk,
    dv, di [B,H,Sq])."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    qh, kh, vh, doh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, do))  # [B, H, S, D]
    b, h, sq, d = qh.shape
    rules = f32_staged(d)
    chunk = rules.chunk // rules.parts
    lse_r = lse.float().permute(0, 2, 1)[..., None]  # [B, H, Sq, 1]
    dq, dk, dv = torch.zeros_like(qh), torch.zeros_like(kh), torch.zeros_like(vh)
    di = torch.zeros(b, h, sq, 1)
    for bi in range(b):
        row = None if kv_mask is None else kv_mask[bi]
        slots = f32_slots(row, kh.shape[2], d)
        for m0 in range(0, sq, rules.rows):
            rows = slice(m0, m0 + rules.rows)
            qb, dob, lb = qh[bi][:, rows], doh[bi][:, rows], lse_r[bi][:, rows]

            def probs_and_dp(keys):
                s = _chunked_scores(qb, kh[bi][:, keys], chunk) * sm_scale
                if row is not None:
                    s = torch.where(row[keys].bool(), s, DEFAULT_MASK_VALUE)
                return torch.exp(s - lb), _chunked_scores(dob, vh[bi][:, keys], chunk)

            formed = [probs_and_dp(keys) for keys in slots]
            dib = torch.zeros(h, qb.shape[1], 1)
            for p, dp in formed:
                dib = dib + (p * dp).sum(dim=-1, keepdim=True)
            di[bi][:, rows] = dib
            for keys, (p, dp) in zip(slots, formed):
                ds = p * (dp - dib) * sm_scale
                dq[bi][:, rows] += matmul_3xtf32(ds, kh[bi][:, keys])
                dk[bi][:, keys] += matmul_3xtf32(ds.transpose(-1, -2), qb)
                dv[bi][:, keys] += matmul_3xtf32(p.transpose(-1, -2), dob)
    back = (t.permute(0, 2, 1, 3).contiguous() for t in (dq, dk, dv))
    return (*back, di[..., 0])


# --- the bf16 kernels' arithmetic built around the valid rows, emulated ---------------------


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` (to nearest even) and back to fp32: an operand
    of the kernels' bf16 products."""
    return x.to(dtype).float()


def bf16_slots(mask_row: torch.Tensor | None, skv: int, d: int) -> list[torch.Tensor]:
    """The key indices of the slots that the bf16 instances built around the
    valid rows walk for one batch row at head dim ``d``: the live tiles (a
    tile of :data:`BF16_LIVE_KEYS` keys at :data:`VALID_ROWS_HEAD_DIMS`, of
    64 at :data:`SHORT_ROWS_HEAD_DIM`, with an attended key; every tile
    without a mask) in order, :func:`bf16_keys` keys a slot."""
    slot = bf16_keys(d, valid_rows=True)
    tile = BF16_LIVE_KEYS if d in VALID_ROWS_HEAD_DIMS else slot
    tiles = torch.arange(skv).reshape(-1, tile)
    if mask_row is not None:
        tiles = tiles[mask_row.bool().reshape(-1, tile).any(dim=1)]
    keys = tiles.reshape(-1)
    return [keys[i:i + slot] for i in range(0, keys.numel(), slot)]


def fused_mha_bf16_valid_emulation(q, k, v, kv_mask=None, sm_scale=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 K1's tile math at :data:`VALID_ROWS_HEAD_DIMS` and
    :data:`SHORT_ROWS_HEAD_DIM` on CPU tensors, where it is built around the
    valid rows (``csrc/fused_mha_fwd.cu::mha_fwd_bf16_staged`` and
    ``mha_fwd_bf16_valid<64>``): for each batch row the slots of
    :func:`bf16_slots`, each slot's scores one product over the whole of D;
    pass 1 an online row max m and sum l slot by slot; pass 2 ``p = exp(s - m)·(1 / l)`` rounded to
    q's dtype BEFORE ``o += p·v`` (fp32), o rounded at the end. The kernels'
    exp is ``__expf`` (ex2.approx, about 2 ulp): the emulation's exact exp
    rounds p the same but where a bf16 step falls between the two. A batch
    row without a live tile gives o = 0, lse = +inf. Returns (o [B,Sq,H,D] in
    q's dtype, lse [B,Sq,H])."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    qh, kh, vh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))  # [B, H, S, D]
    b, h, sq, d = qh.shape
    o = torch.zeros(b, h, sq, d)
    lse = torch.full((b, h, sq, 1), torch.inf)
    for bi in range(b):
        row = None if kv_mask is None else kv_mask[bi]
        slots = bf16_slots(row, kh.shape[2], d)

        def scores(keys):
            s = qh[bi] @ kh[bi][:, keys].transpose(-1, -2) * sm_scale
            return s if row is None else torch.where(row[keys].bool(), s, DEFAULT_MASK_VALUE)

        m = torch.full((h, sq, 1), -torch.inf)
        l = torch.zeros(h, sq, 1)
        for keys in slots:
            s = scores(keys)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(dim=-1, keepdim=True)
            m = m_new
        for keys in slots:
            o[bi] += _round(torch.exp(scores(keys) - m) * (1 / l), q.dtype) @ vh[bi][:, keys]
        lse[bi] = m + torch.log(l)
        if row is not None:  # a row without an attended key
            dead = m <= DEFAULT_MASK_VALUE
            o[bi] = torch.where(dead, 0.0, o[bi])
            lse[bi] = torch.where(dead, torch.inf, lse[bi])
    return o.to(q.dtype).permute(0, 2, 1, 3).contiguous(), lse[..., 0].permute(0, 2, 1).contiguous()


def fused_mha_bwd_bf16_valid_emulation(q, k, v, kv_mask, lse, do, sm_scale=None):
    """The bf16 K2's split at :data:`VALID_ROWS_HEAD_DIMS` and
    :data:`SHORT_ROWS_HEAD_DIM` on CPU tensors, built around the valid rows
    (``csrc/fused_mha_bwd.cu::mha_bwd_{dq,dkv}_bf16_staged`` and
    ``mha_bwd_{dq,dkv}_bf16_valid<64>``), each score product one over the
    whole of D: the dq kernel's pass over the keys (``p = exp(s - lse)``,
    ``dp = do·vᵀ``, ``di = rowsum(p·dp)`` from the fp32 p), then ``ds =
    p·(dp - di)·scale`` rounded to the input dtype and ``dq = ds·k``; the
    dk/dv kernel's ``pᵀ = exp(k·qᵀ·scale - lse)``, ``dv = round(pᵀ)·do``,
    ``dpᵀ = v·doᵀ``, ``dsᵀ`` and ``dk = round(dsᵀ)·q``. The kernels' exp is
    ``__expf``; the key tiles they skip add exact zeros here. Returns (dq,
    dk, dv in the input dtype, di [B,H,Sq])."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    dtype = q.dtype
    qh, kh, vh, doh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, do))  # [B, H, S, D]
    lse_r = lse.float().permute(0, 2, 1)[..., None]  # [B, H, Sq, 1]
    p = torch.exp(_masked_scores(qh @ kh.transpose(-1, -2), kv_mask, sm_scale) - lse_r)
    dp = doh @ vh.transpose(-1, -2)
    di = (p * dp).sum(dim=-1, keepdim=True)
    dq = _round(p * (dp - di) * sm_scale, dtype) @ kh
    # the dk/dv kernel: rows are keys, masked by key; lse and di by query column
    st = kh @ qh.transpose(-1, -2) * sm_scale
    if kv_mask is not None:
        st = torch.where(kv_mask[:, None, :, None].bool(), st, DEFAULT_MASK_VALUE)
    pt = torch.exp(st - lse_r.transpose(-1, -2))
    dv = _round(pt, dtype) @ doh
    dst = pt * (vh @ doh.transpose(-1, -2) - di.transpose(-1, -2)) * sm_scale
    dk = _round(dst, dtype) @ qh
    back = (t.to(dtype).permute(0, 2, 1, 3).contiguous() for t in (dq, dk, dv))
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
    (of 1 on the flash route; Sq any nonzero length for the instances built
    around the valid rows, :func:`takes_valid_rows`), the head dim one
    :func:`check_head_dim` takes."""
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
    check_head_dim(d, route)
    block = 1 if route == "flash" else KERNEL_BLOCK
    q_block = 1 if route == "fused" and takes_valid_rows(sq, d) else block
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
    valid = takes_valid_rows(sq, d)
    # the padded bf16 kernel's instance; the others take their tiles from the head dim alone
    inst = forward_instance(skv, d) if q.dtype == torch.bfloat16 and not valid else None
    q_sb, q_ss = q.stride()[:2]
    k_sb, k_ss = k.stride()[:2]
    v_sb, v_ss = v.stride()[:2]
    # the C side makes the tensors' device current for the launch
    err = _build.load("fused_mha_fwd").fused_mha_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, sq, skv, h, d, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
        sm_scale, _DTYPE_CODES[q.dtype], int(valid),
        *((inst.resident, inst.chunk, inst.buffers) if inst else (0, 0, 0)),
        device.index, torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(err, "fused_mha_fwd")
    _count("fused_mha_fwd", d, q.dtype, skv, valid)
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
    valid = takes_valid_rows(sq, d)
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
            ctypes.c_float(sm_scale), _DTYPE_CODES[q.dtype], int(valid), stream,
        )
    _raise_on(err, "fused_mha_bwd")
    _count("fused_mha_bwd", d, q.dtype, skv, valid)
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
    head dim in :data:`FUSED_HEAD_DIMS` in bf16 or fp32, where the instances
    built around the valid rows take any Sq: at :data:`VALID_ROWS_HEAD_DIMS`,
    and at :data:`SHORT_ROWS_HEAD_DIM` where Sq is not a multiple of
    :data:`MIN_BLOCK`, :func:`takes_valid_rows` — pad through
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
