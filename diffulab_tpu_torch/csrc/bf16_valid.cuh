// bf16 attention products with mma.sync m16n8k16, for the bf16 instances of
// K1 (fused_mha_fwd.cu) and K2 (fused_mha_bwd.cu) at the UNets' head dims
// 192-512 and at D = 64 on padded short sequences (mma_bf16, ldsm_x4_trans
// and scores_times_tile_bf16 also serve K2's bf16 kernels at D = 16 and 32),
// built around the valid rows as the fp32 instances are
// (tf32x3.cuh: valid_rows_instance, vr_rows, vr_cols, vr_groups, put_c,
// sum_c): the unpadded query rows, only the key tiles whose mask holds an
// attended key, column groups of warps that split each row's output and the
// score products' reduction over D.
//
// m16n8k16 reduces over 16: a ring slot holds VR_BF16_TILE = 16 keys (K1,
// K2's dq kernel) or queries (the dk/dv kernel; 64 at D = 64,
// vr_bf16_tile), and a key tile is live when
// any of its 16 mask entries is set; a masked key inside a live tile gets
// MASK_VALUE, so its p is exactly 0. Operands are bf16 in shared memory, rows
// of D + 8 elements: the row stride is 4 words mod 32 banks at every one of
// these head dims, so the fragment loads (word 4 g + t4) and ldmatrix's eight
// 16-byte rows are free of bank conflicts. Accumulators are fp32.
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
// Sums: a score tile is formed from zero over its group's columns (at most
// 128 / 16 = 8 k-steps) and the groups' partials are added in fp32 in group
// order (at D = 64, one group: the tile stays in its warp's registers). o,
// dq, dk and dv carry one accumulator over the live keys (or valid
// queries): at most 512 / 16 = 32 k-steps, whose truncation toward zero in
// the tensor cores leaves at most 32 fp32 ulps (2^-18 relative), far below
// the half bf16 step (2^-9) at which the result is rounded.

#pragma once

#include <stdint.h>

namespace {

constexpr int VR_BF16_TILE = 16;  // keys or queries of a ring slot: one m16n8k16 reduction
// live key tiles (64 keys) whose scores K1 keeps in registers between its
// passes (32 fp32 values a thread); above that it forms them again
constexpr int VR_BF16_KEEP = 4;

// the ring slot at head dim D: VR_BF16_TILE at 192-512; 64 keys (or
// queries) at D = 64, where a slot's products over D are short (8 mma.sync
// a warp for 16 keys) and each slot's load latency and barriers show: K1 at
// G1's shape (B=128, 64 of 128 keys, H=12) took 0.0386 ms with 32-key slots
// against 0.0341, though K2 0.0976 against 0.1022 (scripts/
// d64_valid_variants.py, bf16_tile32; NVIDIA H100 80GB HBM3, 700 W). A slot
// is live when any of its keys is attended.
template <int D>
__host__ __device__ constexpr int vr_bf16_tile() {
  return D == 64 ? 64 : VR_BF16_TILE;
}

// live slots kept between K1's passes at head dim D: VR_BF16_KEEP at
// 192-512; 1 at D = 64 (a 64-token row, 32 values a thread): keeping two
// took K1 to 226 registers against 158 and G1's K1 from 0.0341 ms to 0.0410
// (scripts/d64_valid_variants.py, bf16_keep2; NVIDIA H100 80GB HBM3, 700 W)
template <int D>
__host__ __device__ constexpr int vr_bf16_keep() {
  return D == 64 ? 1 : VR_BF16_KEEP;
}

// exp(x) in the bf16 instances at head dim D: expf at 192-512; __expf (one
// ex2.approx, about 2 ulp) at D = 64, where the exponentials bound K1: with
// expf and p divided by l the bf16 K1 at B=128, 64 of 128 keys, H=12 took
// 0.0390 ms, with __expf and p times 1 / l 0.0341, and at the hard pair's 72
// tokens 0.0401 against 0.0258 (scripts/d64_valid_variants.py, precise_exp;
// NVIDIA H100 80GB HBM3, 700 W). p is rounded to bf16 all the same: a
// rounding flips where the two exps differ across a bf16 step.
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
// layout; T's rows (the reduction) LDT apart, a DC-wide column slice
template <int DC, int N, int LDT>
__device__ __forceinline__ void scores_times_tile_bf16(float (&acc)[DC / 8][4], const float (&x)[N / 8][4],
                                                       const bf16* t, int lane) {
  static_assert(DC % 16 == 0 && N % 16 == 0, "whole 16-wide fragments");
  const int mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
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

}  // namespace
