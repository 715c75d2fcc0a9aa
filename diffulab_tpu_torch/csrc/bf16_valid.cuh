// bf16 attention products with mma.sync m16n8k16, for the bf16 instances of
// K1 (fused_mha_fwd.cu) and K2 (fused_mha_bwd.cu) built around the valid
// rows: at head dim 64 on padded short sequences (mha_fwd_bf16_valid,
// mha_bwd_{dq,dkv}_bf16_valid; mma_bf16, ldsm_x4_trans and
// scores_times_tile_bf16 also serve K2's bf16 kernels at D = 16 and 32), and
// staged at the UNets' head dims 192-512 (mha_fwd_bf16_staged,
// mha_bwd_{dq,dkv}_bf16_staged; their rules and helpers at the end of this
// file). Both take the unpadded query rows and only the key tiles whose mask
// holds an attended key; a masked key inside a live tile gets MASK_VALUE, so
// its p is exactly 0. At D = 64 a ring slot holds one tile of vr_bf16_tile =
// 64 keys (K1, K2's dq kernel) or queries (the dk/dv kernel). Operands are
// bf16 in shared memory, rows of D + 8 elements: the row stride is 4 words
// mod 32 banks at every one of these head dims, so the fragment loads (word 4
// g + t4) and ldmatrix's eight 16-byte rows are free of bank conflicts.
// Accumulators are fp32.
//
// Fragments (g = lane / 4, t4 = lane % 4), two bf16 a register: A a0 (row g,
// k 2 t4, 2 t4 + 1), a1 (g + 8, same k), a2 (g, k 2 t4 + 8, + 9), a3 (g + 8,
// same); B b0 (k 2 t4, 2 t4 + 1, col g), b1 (k 2 t4 + 8, + 9, col g); C c0,
// c1 (row g, cols 2 t4, 2 t4 + 1), c2, c3 (row g + 8). Two C tiles of 8
// columns are the A operand of the next product over those 16 columns, after
// the rounding to bf16 (pack_bf16, to nearest even, as a cast in PyTorch);
// its B operand, rows of a tile along the reduction, comes by
// ldmatrix.trans.
//
// Sums: a score tile is formed from zero over the whole of D (at most 512 /
// 16 = 32 k-steps; at D = 64 four). o, dq, dk and dv carry one accumulator
// over the live keys (or valid queries): at most 512 / 16 = 32 k-steps. Each
// k-step's fp32 sum is truncated toward zero by the tensor cores, which
// leaves at most 32 fp32 ulps (2^-18 relative) in either sum, far below the
// half bf16 step (2^-9) at which p, ds and the outputs are rounded.

#pragma once

#include <stdint.h>

namespace {

// keys of a liveness tile at 192-512 (one m16n8k16 reduction): the staged
// instances' slots gather the live ones
constexpr int VR_BF16_TILE = 16;

// the ring slot of the instances at head dim 64: 64 keys (or queries), where
// a slot's products over D are short (8 mma.sync a warp for 16 keys) and each
// slot's load latency and barriers show: K1 at G1's shape (B=128, 64 of 128
// keys, H=12) took 0.0386 ms with 32-key slots against 0.0341, though K2
// 0.0976 against 0.1022 (scripts/d64_valid_variants.py, bf16_tile32; NVIDIA
// H100 80GB HBM3, 700 W). A slot is live when any of its keys is attended.
template <int D>
__host__ __device__ constexpr int vr_bf16_tile() {
  return D == 64 ? 64 : VR_BF16_TILE;
}

// live slots kept between K1's passes at head dim 64 (a 64-token row, 32
// values a thread): keeping two took K1 to 226 registers against 158 and
// G1's K1 from 0.0341 ms to 0.0410 (scripts/d64_valid_variants.py,
// bf16_keep2; NVIDIA H100 80GB HBM3, 700 W)
constexpr int VR_BF16_KEEP = 1;

// exp(x) in the instances at head dim 64: __expf (one ex2.approx, about 2
// ulp), where the exponentials bound K1: with expf and p divided by l the
// bf16 K1 at B=128, 64 of 128 keys, H=12 took 0.0390 ms, with __expf and p
// times 1 / l 0.0341, and at the hard pair's 72 tokens 0.0401 against 0.0258
// (scripts/d64_valid_variants.py, precise_exp, which compiles the expf
// branch; NVIDIA H100 80GB HBM3, 700 W). p is rounded to bf16 all the same:
// a rounding flips where the two exps differ across a bf16 step. The staged
// instances at 192-512 call __expf too.
template <int D>
__device__ __forceinline__ float bf16_exp(float x) {
  if constexpr (D == 64)
    return __expf(x);
  else
    return expf(x);
}

template <int D>
__host__ __device__ constexpr int ldb() {
  return D + 8;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8x8 bf16 matrices from shared memory, transposed: lanes 8i..8i+7 give
// the row addresses of matrix i, whose fragment lands in r[i]
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// rows [r0, r0 + ROWS) of one head (D bf16 at row stride `ss` elements) into a
// [ROWS][D + 8] tile by the CTA's THREADS threads, 16 bytes a copy; rows at
// or past `end` are zero-filled by the copy itself; not awaited
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_bf16_rows(bf16* dst, const bf16* src, long long ss, int r0, int end) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const bool in = r0 + r < end;
    cp_async16(reinterpret_cast<float*>(dst + r * ldb<D>() + c),
               reinterpret_cast<const float*>(in ? src + (long long)(r0 + r) * ss + c : src), in ? 16 : 0);
  }
}

// s[nt] = A.T^T for a warp's 16 rows (rows a0 of tile `a`) against tile rows
// 8 nt, over DC columns (a column slice of tiles whose rows are LDT apart),
// each tile from zero
template <int DC, int N, int LDT>
__device__ __forceinline__ void rows_dot_bf16(float (&s)[N / 8][4], const bf16* a, int a0, const bf16* t, int g,
                                              int t4) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DC / 16; ++kk) {
    const bf16* p = a + (a0 + g) * LDT + kk * 16 + 2 * t4;
    const uint32_t af[4] = {ld_u32(p), ld_u32(p + 8 * LDT), ld_u32(p + 8), ld_u32(p + 8 * LDT + 8)};
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const bf16* r = t + (nt * 8 + g) * LDT + kk * 16 + 2 * t4;
      const uint32_t b[2] = {ld_u32(r), ld_u32(r + 8)};
      mma_bf16(s[nt], af, b);
    }
  }
}

// acc[16 rows x DC] += round_bf16(x[16 rows x N]) . T[N rows][DC], x in C
// layout; T's rows (the reduction) LDT apart, a DC-wide column slice; only
// the first n_rows of T (a multiple of 16) are read
template <int DC, int N, int LDT>
__device__ __forceinline__ void scores_times_tile_bf16(float (&acc)[DC / 8][4], const float (&x)[N / 8][4],
                                                       const bf16* t, int lane, int n_rows = N) {
  static_assert(DC % 16 == 0 && N % 16 == 0, "whole 16-wide fragments");
  const int mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    if (kk * 16 < n_rows) {
      const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]), pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                             pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                             pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DC / 8; dn += 2) {
        // matrices: (rows 16 kk.., cols 8 dn..), (16 kk + 8.., 8 dn..), (16 kk.., 8 dn + 8..), (16 kk + 8.., 8 dn + 8..)
        uint32_t b[4];
        ldsm_x4_trans(b, t + (kk * 16 + (mat & 1) * 8 + r) * LDT + dn * 8 + (mat >> 1) * 8);
        mma_bf16(acc[dn], a, b);
        mma_bf16(acc[dn + 1], a, b + 2);
      }
    }
  }
}

// a C-layout [16 x DC] accumulator, rounded to bf16, to rows `row`, `row` + 8
// of `out` (row stride `ss` elements), those below `end` alone
template <int DC>
__device__ __forceinline__ void store_bf16_rows(bf16* out, long long ss, int row, const float (&acc)[DC / 8][4],
                                                int t4, int end) {
#pragma unroll
  for (int dn = 0; dn < DC / 8; ++dn) {
    const int col = dn * 8 + 2 * t4;
    if (row < end)
      *reinterpret_cast<uint32_t*>(out + (long long)row * ss + col) = pack_bf16(acc[dn][0], acc[dn][1]);
    if (row + 8 < end)
      *reinterpret_cast<uint32_t*>(out + (long long)(row + 8) * ss + col) = pack_bf16(acc[dn][2], acc[dn][3]);
  }
}

// raw C-layout scores of keys key0 + [0, N) -> s * scale, a masked key (0 in
// the mask row `mrow`, when there is one) -> MASK_VALUE
template <int N>
__device__ __forceinline__ void scale_and_mask_c(float (&s)[N / 8][4], float sm_scale, const int* mrow, int key0,
                                                 int t4) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    const int2 keep = mrow == nullptr ? make_int2(1, 1)
                                      : *reinterpret_cast<const int2*>(mrow + key0 + nt * 8 + 2 * t4);
    s[nt][0] = keep.x ? s[nt][0] * sm_scale : MASK_VALUE;
    s[nt][1] = keep.y ? s[nt][1] * sm_scale : MASK_VALUE;
    s[nt][2] = keep.x ? s[nt][2] * sm_scale : MASK_VALUE;
    s[nt][3] = keep.y ? s[nt][3] * sm_scale : MASK_VALUE;
  }
}

// ---- the staged instances at head dims 192-512 (mha_fwd_bf16_staged, mha_bwd_{dq,dkv}_bf16_staged)
//
// At the UNets' shapes a (batch, head) attends 64 keys (D = 192, 256) or 16
// (384, 512) of 128, and the key row of 16-key ring slots left a chain of
// exposed loads (a cp.async wait and two or three barriers a slot) and a
// shared-memory exchange of the column groups' partial scores on every slot.
// These instances stage a slot of vr_bf16_slot keys at once, gathered from
// the live 16-key tiles of the mask row (VR_BF16_TILE: the liveness grain),
// so that the UNets' whole live row is one slot, requested with V beside K;
// each warp forms its 16 rows' scores over the whole of D (ldmatrix
// fragments), and the column groups split only the output columns, with no
// exchange. A longer live row goes through the slots in turn.

// keys (K1, the dq kernel) or queries (the dk/dv kernel) of a staged slot:
// the UNets' live row, 64 at D = 192 and 256, 16 at 384 and 512. 16-key
// slots took K1 at D = 192, B=128, H=2 from 0.0176 ms to 0.0242 and K2 from
// 0.0468 to 0.0676 (scripts/d3_valid_variants.py, slot16; NVIDIA H100 80GB
// HBM3, 700 W; the variants below are timed there too)
template <int D>
__host__ __device__ constexpr int vr_bf16_slot() {
  return D <= 256 ? 64 : 16;
}

// query rows (keys in the dk/dv kernel) of a CTA: a head's 64 or 16 valid rows
template <int D>
__host__ __device__ constexpr int vr_bf16_rows() {
  return D <= 256 ? 64 : 16;
}

// output columns of a column group of warps in K1 (BWD false) and K2 (BWD
// true): K1 one group of four warps at D = 192 and 256 (2 CTAs an SM: a warp
// holds 96 or 128 accumulators and its packed p in 219 or 244 registers; two
// groups took it from 0.0176 ms to 0.0218 at D = 192, k1_cols_half), groups
// of 128 at 384 and 512; K2 96, 128, 64 and 128 columns (one group at D = 192
// took it from 0.0468 to 0.0488, bwd_cols_whole192), its kernels in 93-255
// registers
template <int D, bool BWD = false>
__host__ __device__ constexpr int vr_bf16_cols() {
  return BWD ? (D == 192 ? 96 : D == 384 ? 64 : 128) : D <= 256 ? D : 128;
}

template <int D, bool BWD = false>
__host__ __device__ constexpr int vr_bf16_groups() {
  return D / vr_bf16_cols<D, BWD>();
}

// a warp for each 16 rows in each column group
template <int D, bool BWD = false>
__host__ __device__ constexpr int vr_bf16_threads() {
  return 32 * (vr_bf16_rows<D>() / 16) * vr_bf16_groups<D, BWD>();
}

// queries of the dk/dv kernel's inner step: its scores stay 32 fp32 values a thread or fewer
template <int D>
__host__ __device__ constexpr int vr_bf16_sub() {
  return vr_bf16_slot<D>() < 32 ? vr_bf16_slot<D>() : 32;
}

// slot buffers of K1's ring: the UNets' one slot takes two (K, then V, requested at once)
constexpr int VR_BF16_BUFFERS = 2;

// whether the live tiles of a slot's worth, tiles[0, min(CT, n)), are the row's first: the tiles a padded row
// attends, whose K and V the fused K2 requests before it has read the mask
template <int CT>
__device__ __forceinline__ bool live_prefix(const int* tiles, int n) {
  bool prefix = n > 0;
  for (int j = 0; j < CT && j < n; ++j) prefix = prefix && tiles[j] == j;
  return prefix;
}

// four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, whose fragment lands in r[i]
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// s[nt] = A.T^T for a warp's 16 rows (rows a0 of tile `a`) against tile rows
// 8 nt below n_rows (a multiple of 16; the others left 0), over DC columns,
// from zero; both operands by ldmatrix (rows LDT apart)
template <int DC, int N, int LDT>
__device__ __forceinline__ void rows_dot_bf16_ldsm(float (&s)[N / 8][4], const bf16* a, int a0, const bf16* t,
                                                   int lane, int n_rows = N) {
  static_assert(DC % 16 == 0 && N % 16 == 0, "whole 16-wide fragments");
  const int mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DC / 16; ++kk) {
    // A: (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
    uint32_t af[4];
    ldsm_x4(af, a + (a0 + (lane & 15)) * LDT + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < N / 8; nt += 2) {
      if (nt * 8 < n_rows) {
        // B: (rows 8 nt.., k 0-7), (8 nt.., 8-15), (8 nt + 8.., 0-7), (8 nt + 8.., 8-15)
        uint32_t b[4];
        ldsm_x4(b, t + (nt * 8 + (mat >> 1) * 8 + r) * LDT + kk * 16 + (mat & 1) * 8);
        mma_bf16(s[nt], af, b);
        mma_bf16(s[nt + 1], af, b + 2);
      }
    }
  }
}

// x[16 rows x N] in C layout rounded to bf16 into A fragments over its N
// columns, two C tiles of 8 columns a fragment
template <int N>
__device__ __forceinline__ void pack_a_bf16(uint32_t (&a)[N / 16][4], const float (&x)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// acc[16 rows x DC] += A[16 rows x N] . T[N rows][DC], A as bf16 fragments
// (pack_a_bf16); T's rows (the reduction) LDT apart, a DC-wide column slice,
// only its first n_rows (a multiple of 16) read
template <int DC, int N, int LDT>
__device__ __forceinline__ void frags_times_tile_bf16(float (&acc)[DC / 8][4], const uint32_t (&a)[N / 16][4],
                                                      const bf16* t, int lane, int n_rows = N) {
  const int mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    if (kk * 16 < n_rows) {
#pragma unroll
      for (int dn = 0; dn < DC / 8; dn += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, t + (kk * 16 + (mat & 1) * 8 + r) * LDT + dn * 8 + (mat >> 1) * 8);
        mma_bf16(acc[dn], a[kk], b);
        mma_bf16(acc[dn + 1], a[kk], b + 2);
      }
    }
  }
}

// acc[16 rows x DC] += S^T[16 rows x N] . T[N rows][DC], where S is a bf16
// [N][LDS] tile in shared memory whose columns s0 + [0, 16) are this warp's
// rows (S^T's A fragments by ldmatrix.trans); T as above. One k-step at a
// time: with the N / 16 steps unrolled the fused K2 spilled at D = 192 and 256
template <int DC, int N, int LDS, int LDT>
__device__ __forceinline__ void tile_t_times_tile_bf16(float (&acc)[DC / 8][4], const bf16* st, int s0, const bf16* t,
                                                       int lane) {
  const int mat = lane >> 3, r = lane & 7;
#pragma unroll 1
  for (int kk = 0; kk < N / 16; ++kk) {
    // A = S^T: (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15), k along S's rows
    uint32_t a[4];
    ldsm_x4_trans(a, st + (kk * 16 + (mat >> 1) * 8 + r) * LDS + s0 + (mat & 1) * 8);
#pragma unroll
    for (int dn = 0; dn < DC / 8; dn += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, t + (kk * 16 + (mat & 1) * 8 + r) * LDT + dn * 8 + (mat >> 1) * 8);
      mma_bf16(acc[dn], a, b);
      mma_bf16(acc[dn + 1], a, b + 2);
    }
  }
}

// a C-layout [16 x N] tile rounded to bf16 into rows r0 + g, r0 + g + 8 of a
// bf16 [rows][LDS] tile in shared memory
template <int N, int LDS>
__device__ __forceinline__ void put_bf16_c(bf16* dst, const float (&c)[N / 8][4], int r0, int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    *reinterpret_cast<uint32_t*>(dst + (r0 + g) * LDS + nt * 8 + 2 * t4) = pack_bf16(c[nt][0], c[nt][1]);
    *reinterpret_cast<uint32_t*>(dst + (r0 + g + 8) * LDS + nt * 8 + 2 * t4) = pack_bf16(c[nt][2], c[nt][3]);
  }
}

// the rows of a slot: tiles[0, n) of KT rows each (row tiles[j] KT + r of one
// head, D bf16 at row stride `ss`) into rows j KT + r of a [n KT][D + 8]
// tile by the CTA's THREADS threads, 16 bytes a copy; not awaited
template <int D, int KT, int THREADS>
__device__ __forceinline__ void stage_bf16_tiles(bf16* dst, const bf16* src, long long ss, const int* tiles, int n) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < n * KT * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    cp_async16(reinterpret_cast<float*>(dst + r * ldb<D>() + c),
               reinterpret_cast<const float*>(src + (long long)(tiles[r / KT] * KT + r % KT) * ss + c));
  }
}

// raw C-layout scores of a slot (column 8 nt + c is key tiles[8 nt / KT] KT +
// 8 nt % KT + c) -> s * scale; a masked key (0 in the mask row `mrow`, when
// there is one) -> MASK_VALUE; a column past the slot's n tiles -> -inf
template <int N, int KT>
__device__ __forceinline__ void scale_and_mask_slot(float (&s)[N / 8][4], float sm_scale, const int* mrow,
                                                    const int* tiles, int n, int t4) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    const int j = nt * 8 / KT;
    if (j >= n) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = -INFINITY;
      continue;
    }
    const int2 keep = mrow == nullptr
                          ? make_int2(1, 1)
                          : *reinterpret_cast<const int2*>(mrow + tiles[j] * KT + nt * 8 % KT + 2 * t4);
    s[nt][0] = keep.x ? s[nt][0] * sm_scale : MASK_VALUE;
    s[nt][1] = keep.y ? s[nt][1] * sm_scale : MASK_VALUE;
    s[nt][2] = keep.x ? s[nt][2] * sm_scale : MASK_VALUE;
    s[nt][3] = keep.y ? s[nt][3] * sm_scale : MASK_VALUE;
  }
}

// wait until at most `pending` (0 .. N) of the CTA's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  if constexpr (N > 0) {
    if (pending >= N) {
      cp_async_wait<N>();
      return;
    }
    cp_async_wait_upto<N - 1>(pending);
  } else {
    cp_async_wait<0>();
  }
}

}  // namespace
