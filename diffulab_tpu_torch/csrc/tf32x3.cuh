// fp32 attention products on Hopper's tensor cores as 3xTF32, shared by the
// fp32 instances of K1 (fused_mha_fwd.cu), K2 (fused_mha_bwd.cu), K3
// (flash_attn_fwd.cu) and K4's dk/dv and K5's dq kernels (flash_attn_bwd.cu).
//
// The tensor cores take no fp32 operand, but TF32 (8 exponent bits, 10
// mantissa bits) at 495 TFLOP/s dense. Each fp32 operand x is split into
// hi = tf32(x), rounded to nearest with ties away (cvt.rna.tf32.f32's
// rounding), and lo = x - hi, exact in fp32, of which the tensor cores read
// the top 19 bits; a product accumulates lo.hi + hi.lo + hi.hi in fp32, the
// small terms first, as CUTLASS's OpMultiplyAddFastF32 does. hi.hi is exact
// in fp32, |lo| <= 2^-11 |x|, so the dropped lo.lo is about 2^-22 of |a||b|
// and lo's truncation 2^-21: about 2^-21 relative per product
// (ops/fused_mha.py::matmul_3xtf32 is the plain emulation). Three products at
// 495 TFLOP/s still beat the fp32 CUDA cores (67 TFLOP/s) by 2.5x.
//
// The split is bit arithmetic: add half of the 13 dropped bits, clear them
// (an IADD3 and a LOP3), and one FADD for lo. cvt.rna.tf32.f32 compiles to a
// sequence of IMAD, FSETP and SEL instructions, and rounding lo as well
// costs two more: at C1's shapes (B=128, S=256, H=8, D=64) the fp32 K1 took
// 0.4525 ms with cvt.rna for hi and lo, 0.3841 with this rounding for both,
// 0.3606 with lo left to the tensor cores, and K2 1.7231, 1.4099 and 1.3286
// (scripts/fp32_attn_variants.py, NVIDIA H100 80GB HBM3, 700 W).
//
// The instruction is mma.sync m16n8k8 .tf32 (a warp's 16 x 8 tile, k = 8).
// wgmma takes .tf32 operands from shared memory only K-major (the transpose
// flags are for 16-bit types), and P.V, dS.K, dS^T.Q and P^T.dO each read an
// operand stored N-major; mma.sync fragments are loaded by the threads and
// read either layout. Operands are split when their fragment is loaded.
//
// Fragments (g = lane / 4, t4 = lane % 4): A a0 (row g, k t4), a1 (g + 8, t4),
// a2 (g, t4 + 4), a3 (g + 8, t4 + 4); B b0 (k t4, col g), b1 (k t4 + 4, g); C
// c0, c1 (row g, cols 2 t4, 2 t4 + 1), c2, c3 (row g + 8, same cols). A score
// tile in C layout becomes the A operand of the next product without a
// shuffle by permuting the reduction axis: k slot t4 takes key 2 t4 and slot
// t4 + 4 key 2 t4 + 1, and the B operand reads its rows in the same order.
//
// Tiles sit in shared memory as [rows][D + 4] fp32: a row stride of 4 words
// mod 32 banks keeps both fragment patterns below free of bank conflicts
// (4 g + t4, and 8 t4 + g, are 32 distinct banks). They arrive by cp.async,
// 16 bytes a thread, from rows of one head at the caller's strides.

#pragma once

#include <stdint.h>

namespace {

constexpr int F32_THREADS = 128;  // four warps of 16 rows: 64 rows a CTA
constexpr int F32_ROWS = 64;

template <int D>
__host__ __device__ constexpr int ld() {
  return D + 4;
}

// x rounded to TF32, to nearest with ties away from zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a_lo.b_hi + a_hi.b_lo + a_hi.b_hi
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// ---- cp.async

// 16 bytes global -> shared, of which the first `bytes` (16 or 0) are read:
// the rest is zero-filled by the copy itself
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes = 16) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of one head (D floats at row stride `ss` elements)
// into a [ROWS][D + 4] tile by the CTA's THREADS threads; not awaited
template <int D, int ROWS, int THREADS = F32_THREADS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long ss, int r0) {
  constexpr int CHUNKS = D / 4;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
    cp_async16(dst + r * ld<D>() + c, src + (long long)(r0 + r) * ss + c);
  }
}

// rows [r0, r0 + ROWS) as stage_rows, but only those below `end` come from
// device memory: a row at or past it is read with a source size of 0, so the
// copy fills it with zeros (a ragged last tile); not awaited
template <int D, int ROWS, int THREADS = F32_THREADS>
__device__ __forceinline__ void stage_rows_upto(float* dst, const float* src, long long ss, int r0, int end) {
  constexpr int CHUNKS = D / 4;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
    const bool in = r0 + r < end;
    cp_async16(dst + r * ld<D>() + c, in ? src + (long long)(r0 + r) * ss + c : src, in ? 16 : 0);
  }
}

// ---- the instances built around the valid rows (head dims 64 and 192-512)
//
// The ADM UNets attend over 64 tokens at D = 192 and 256 and over 16 at D =
// 384 and 512, padded to 128 keys; at D = 64 the DiTs' short sequences (64,
// 72 or 264 tokens) are padded to 128 or 384 keys. These instances take the
// unpadded query rows (ragged ends guarded), skip every key tile whose mask
// is all 0 (the CTA's first warp lists the live ones, find_live_tiles), and
// split the head into column groups of warps of vr_cols output
// columns, which also split the score products' reduction over D: the
// partial tiles are added in group order in shared memory (put_c, sum_c).
// At D = 64 one group holds the whole head: no partial tiles, each warp's
// scores stay in its registers. The fp32 launches take these instances at D =
// 64, 192 and 384, and K1 at 512 too; the staged ones below take K2 at 256
// and 512 and K1 at 256. The rules' values at 256 and 512 are the split
// instances' of 8-key tiles, which scripts/d2_valid_variants.py (split,
// k1_valid) still builds to compare.

// the head dims where these are the only instances, the one place that names
// them: both entry points' rules read it, the fwd library exports it
// (fused_mha_fwd_f32_tiles(D, 2)), and chip_smoke.py holds
// ops/fused_mha.py's VALID_ROWS_HEAD_DIMS to that export
__host__ __device__ constexpr bool valid_rows_instance(int D) {
  return D == 192 || D == 256 || D == 384 || D == 512;
}

// the head dims with an instance built around the valid rows: those, and 64,
// where it stands beside the padded instances and the caller picks it by
// shape (ops/fused_mha.py::takes_valid_rows)
__host__ __device__ constexpr bool has_valid_rows_instance(int D) {
  return D == 64 || valid_rows_instance(D);
}

constexpr int VR_TILE = 8;  // keys (K1, K2's dq kernel) or queries (the dk/dv kernel) of a ring slot, fp32

// the fp32 ring slot at head dim D: VR_TILE at 192-512, 32 at 64, where a
// slot's 3xTF32 products over D are short and a slot of few keys leaves
// each slot's load latency and barriers exposed (bf16_valid.cuh,
// vr_bf16_tile); a slot of K and V takes 17 KB
template <int D>
__host__ __device__ constexpr int vr_tile() {
  return D == 64 ? 32 : VR_TILE;
}

// slots of the instances' rings, VR_SLOTS - 1 of them loading while one is
// computed. At D = 64 three slots moved the fp32 instances by 3% or less
// either way (the fp32 K2 at G1's request, B=32, 64 of 128 keys, H=12:
// 0.0651 ms against 0.0638) and took the bf16 K2 at G1's training shape from
// 0.1022 ms to 0.0965, at 35 KB more shared memory a CTA
// (scripts/d64_valid_variants.py, slots3; NVIDIA H100 80GB HBM3, 700 W)
constexpr int VR_SLOTS = 2;

// This rule and vr_cols at D = 192 and 384 were picked by timing chip_smoke.py
// phase 17a with them varied (B=128 and 32, H=2; NVIDIA H100 80GB HBM3, 700
// W; PERF.md §6).
//
// rows (queries, or keys in the dk/dv kernel) of a CTA, a tile size: 64 at
// D = 256 and 16 at D = 384 and 512, so that one CTA holds a head's valid
// rows at the UNets' token counts (64 and 16); 32 at D = 192, where two CTAs
// for a head's 64 rows took K2 0.1780 ms against 0.1966-0.1988 with one, and
// K1 at B=32 0.0226 against 0.0263. 64 at D = 64: a 64-token row in one
// CTA of four warps, which share each live key tile it loads; 32 rows a CTA
// took the fp32 K1 / K2 at slice F1's deep path (B=128, 64 of 128 keys, H=8)
// 0.0512 / 0.1439 ms against 0.0462 / 0.1338 (scripts/d64_valid_variants.py,
// rows32; NVIDIA H100 80GB HBM3, 700 W). Any Sq runs, its last tile ragged.
template <int D>
__host__ __device__ constexpr int vr_rows() {
  return D == 192 ? 32 : D <= 256 ? 64 : 16;
}

// output columns of a column group of warps: 96 at D = 192 (2 groups, 48
// accumulators a thread in K1, 96 in the dk/dv kernel; 64-column groups took
// K1 0.0573 ms against 0.0420), 64 at D = 384 (6 groups: K1 0.0173 ms, 0.0194
// with 128 columns), the whole head at D = 64 (32 accumulators a thread in
// K1), else 128 (2 and 4 groups at D = 256 and 512)
template <int D>
__host__ __device__ constexpr int vr_cols() {
  return D == 192 ? 96 : D == 384 ? 64 : D == 64 ? 64 : 128;
}

template <int D>
__host__ __device__ constexpr int vr_groups() {
  return D / vr_cols<D>();
}

// a warp for each 16 rows in each column group
template <int D>
__host__ __device__ constexpr int vr_threads() {
  return 32 * (vr_rows<D>() / 16) * vr_groups<D>();
}

// whether key tile t (KT keys: vr_tile, or vr_bf16_tile in the bf16 instances) of a mask row has an attended key
template <int KT = VR_TILE>
__device__ __forceinline__ bool tile_live(const int* mrow, int t) {
  int any = 0;
#pragma unroll
  for (int i = 0; i < KT; i += 4) {
    const int4 a = *reinterpret_cast<const int4*>(mrow + t * KT + i);
    any |= a.x | a.y | a.z | a.w;
  }
  return any != 0;
}

// live key tiles whose p and dp the fp32 K2's dq kernel keeps in registers
// between its passes at head dim D, their K left in the ring's slots (so at
// most VR_SLOTS): at D = 64 two tiles of 32 keys (64 values a thread), a
// 64-token row, whose pass 2 then loads nothing and forms no s or dp; none
// elsewhere. It took the fp32 K2 at slice F1's deep path (B=128, 64 of 128
// keys, H=8) from 0.1488 ms to 0.1338, the embedder's from 0.0480 to 0.0413
// (scripts/d64_valid_variants.py, dq_nokeep; NVIDIA H100 80GB HBM3, 700 W).
// The bf16 dq kernel keeps none: a 64-key tile's p and dp, 64 values a
// thread, would cost it a CTA an SM.
template <int D>
__host__ __device__ constexpr int vr_dq_keep() {
  return D == 64 ? 2 : 0;
}

// the live key tiles (KT keys) of the mask row `mrow`, in order, into
// list[0, n) and their count n into list[n_tiles], by the CTA's first warp
// (one ballot a 32 tiles); every tile without a mask. The caller
// synchronises before reading the list.
template <int KT>
__device__ __forceinline__ void find_live_tiles(int* list, const int* mrow, int n_tiles) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int base = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += 32) {
    const int t = t0 + lane;
    const bool live = t < n_tiles && (mrow == nullptr || tile_live<KT>(mrow, t));
    const unsigned bits = __ballot_sync(0xffffffffu, live);
    if (live) list[base + __popc(bits & ((1u << lane) - 1u))] = t;
    base += __popc(bits);
  }
  if (lane == 0) list[n_tiles] = base;
}

// ---- fragments from a [rows][D + 4] tile, split at the load

// A: rows r0 + [0, 16), reduction over columns 8 kk + [0, 8); rows LDT floats apart
template <int D, int LDT = ld<D>()>
__device__ __forceinline__ void frag_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* t, int r0, int kk, int g,
                                       int t4) {
  const float* p = t + (r0 + g) * LDT + kk * 8 + t4;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * LDT], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * LDT + 4], hi[3], lo[3]);
}

// B of a row-by-row product (s = A.T^T): columns n0 + [0, 8) are tile rows,
// the reduction runs over the tile's columns 8 kk + [0, 8); rows LDT floats apart
template <int D, int LDT = ld<D>()>
__device__ __forceinline__ void frag_b_rows(uint32_t (&hi)[2], uint32_t (&lo)[2], const float* t, int n0, int kk,
                                            int g, int t4) {
  const float* p = t + (n0 + g) * LDT + kk * 8 + t4;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[4], hi[1], lo[1]);
}

// B of a product over the tile's rows (o = P.T): the reduction runs over tile
// rows 8 kk + [0, 8) in the permuted order (slot t4: row 2 t4, slot t4 + 4:
// row 2 t4 + 1), the columns are the tile's columns n0 + [0, 8); rows LDT
// floats apart (a D-wide tile by default; a column slice of a wider one)
template <int D, int LDT = ld<D>()>
__device__ __forceinline__ void frag_b_cols(uint32_t (&hi)[2], uint32_t (&lo)[2], const float* t, int kk, int n0,
                                            int g, int t4) {
  const float* p = t + (kk * 8 + 2 * t4) * LDT + n0 + g;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[LDT], hi[1], lo[1]);
}

// A fragments of a warp's 16 rows (row, row + 8 for this thread) of one head
// read from device memory (row stride `ss` elements), split
template <int D>
__device__ __forceinline__ void frags_a_global(uint32_t (&hi)[D / 8][4], uint32_t (&lo)[D / 8][4], const float* src,
                                               long long ss, int row, int t4) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const float* p = src + (long long)row * ss + kk * 8 + t4;
    split_tf32(p[0], hi[kk][0], lo[kk][0]);
    split_tf32(p[8 * ss], hi[kk][1], lo[kk][1]);
    split_tf32(p[4], hi[kk][2], lo[kk][2]);
    split_tf32(p[8 * ss + 4], hi[kk][3], lo[kk][3]);
  }
}

// A from 8 columns (n-tile kk) of a C-layout tile, in the permuted order
__device__ __forceinline__ void frag_a_from_c(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&c)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// s[nt] = A.T^T for a warp's 16 rows (rows a0 of tile `a`) against tile rows
// 8 nt, over D columns (a column slice of wider tiles whose rows are LDT floats apart)
template <int D, int N, int LDT = ld<D>()>
__device__ __forceinline__ void rows_dot(float (&s)[N / 8][4], const float* a, int a0, const float* t, int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
    frag_a<D, LDT>(ah, al, a, a0, kk, g, t4);
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      uint32_t bh[2], bl[2];
      frag_b_rows<D, LDT>(bh, bl, t, nt * 8, kk, g, t4);
      mma3(s[nt], ah, al, bh, bl);
    }
  }
}

// the same with A's fragments held in registers
template <int D, int N>
__device__ __forceinline__ void rows_dot(float (&s)[N / 8][4], const uint32_t (&ah)[D / 8][4],
                                         const uint32_t (&al)[D / 8][4], const float* t, int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      uint32_t bh[2], bl[2];
      frag_b_rows<D>(bh, bl, t, nt * 8, kk, g, t4);
      mma3(s[nt], ah[kk], al[kk], bh, bl);
    }
}

// acc[16 rows x D] += x[16 rows x N] . T[N rows][D], x in C layout; T's rows
// LDT floats apart (T may be a D-wide column slice of a wider tile)
template <int D, int N, int LDT = ld<D>()>
__device__ __forceinline__ void scores_times_tile(float (&acc)[D / 8][4], const float (&x)[N / 8][4], const float* t,
                                                  int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    uint32_t ah[4], al[4];
    frag_a_from_c(ah, al, x[kk]);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      uint32_t bh[2], bl[2];
      frag_b_cols<D, LDT>(bh, bl, t, kk, dn * 8, g, t4);
      mma3(acc[dn], ah, al, bh, bl);
    }
  }
}

// scores_times_tile over a long reduction: the tensor cores round the fp32
// sum of an mma toward zero, so an accumulator carried through thousands of
// products drifts by up to an ulp a product, always the same way. Here each
// block of CB output columns is summed over the tile's N rows in a fresh
// accumulator (a chain of 3 N / 8 products) and then added to acc with
// fp32 adds, which round to nearest. A block of CB columns (64 by default)
// takes CB / 2 registers a thread for its partial.
template <int D, int N, int CB = (D < 64 ? D : 64), int LDT = ld<D>()>
__device__ __forceinline__ void scores_times_tile_fresh(float (&acc)[D / 8][4], const float (&x)[N / 8][4],
                                                        const float* t, int g, int t4) {
  static_assert(D % CB == 0, "whole column blocks");
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += CB) {
    float part[CB / 8][4];
#pragma unroll
    for (int dn = 0; dn < CB / 8; ++dn) part[dn][0] = part[dn][1] = part[dn][2] = part[dn][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk) {
      uint32_t ah[4], al[4];
      frag_a_from_c(ah, al, x[kk]);
#pragma unroll
      for (int dn = 0; dn < CB / 8; ++dn) {
        uint32_t bh[2], bl[2];
        frag_b_cols<D, LDT>(bh, bl, t, kk, c0 + dn * 8, g, t4);
        mma3(part[dn], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int dn = 0; dn < CB / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c0 / 8 + dn][e] += part[dn][e];
  }
}

// a C-layout [16 x D] accumulator to rows `row`, `row` + 8 of `out` (row
// stride `ss` elements), two floats a store
template <int D>
__device__ __forceinline__ void store_c_rows(float* out, long long ss, int row, const float (&acc)[D / 8][4], int t4) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t4;
    *reinterpret_cast<float2*>(out + (long long)row * ss + col) = make_float2(acc[dn][0], acc[dn][1]);
    *reinterpret_cast<float2*>(out + (long long)(row + 8) * ss + col) = make_float2(acc[dn][2], acc[dn][3]);
  }
}

// store_c_rows for the rows below `end` alone (a ragged last tile)
template <int D>
__device__ __forceinline__ void store_c_rows_upto(float* out, long long ss, int row, const float (&acc)[D / 8][4],
                                                  int t4, int end) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t4;
    if (row < end) *reinterpret_cast<float2*>(out + (long long)row * ss + col) = make_float2(acc[dn][0], acc[dn][1]);
    if (row + 8 < end)
      *reinterpret_cast<float2*>(out + (long long)(row + 8) * ss + col) = make_float2(acc[dn][2], acc[dn][3]);
  }
}

// ---- a score product's D-reduction split over column groups of warps

// a warp's C-layout [16 x N] tile (its rows r0 + [0, 16)) into a [rows][N] buffer
template <int N>
__device__ __forceinline__ void put_c(float* buf, const float (&c)[N / 8][4], int r0, int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    const int col = nt * 8 + 2 * t4;
    *reinterpret_cast<float2*>(buf + (r0 + g) * N + col) = make_float2(c[nt][0], c[nt][1]);
    *reinterpret_cast<float2*>(buf + (r0 + g + 8) * N + col) = make_float2(c[nt][2], c[nt][3]);
  }
}

// c = the sum of GROUPS partial tiles, [GROUPS][rows][N] apart by `stride`
// floats, added in group order, so that every group's warps hold the same sum
template <int N, int GROUPS>
__device__ __forceinline__ void sum_c(float (&c)[N / 8][4], const float* buf, int stride, int r0, int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int grp = 0; grp < GROUPS; ++grp)
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const int col = nt * 8 + 2 * t4;
      const float2 a = *reinterpret_cast<const float2*>(buf + grp * stride + (r0 + g) * N + col);
      const float2 b = *reinterpret_cast<const float2*>(buf + grp * stride + (r0 + g + 8) * N + col);
      c[nt][0] += a.x;
      c[nt][1] += a.y;
      c[nt][2] += b.x;
      c[nt][3] += b.y;
    }
}

// ---- the staged instances at the MNIST UNet's head dims 256 and 512
//
// mha_fwd_tf32x3_staged<D> (K1, at D = 256 alone) and
// mha_bwd_fused_tf32x3_staged<D> (K2, at 256 and 512): a slot of
// vr_f32s_slot keys gathered from the mask row's live VR_TILE-key tiles (the
// UNet's whole live row: 64 keys at D = 256, 16 at 512), D staged in chunks
// through a ring of VR_F32S_STAGES cp.async stages. Each warp forms its rows' s (and dp) over the whole of D: every
// chunk's 3xTF32 product summed from zero and added to the warp's fp32 sums
// (T25: a chain of 3 C / 8 products a chunk), so no partial score crosses
// warps. The slot's p and ds stay in shared memory (K2) or registers (K1),
// and the outputs come one chunk of columns at a time from a second walk
// over the chunks. The other head dims keep the instances above.

// head dims of the staged fp32 K2 (K1's: 256 alone)
__host__ __device__ constexpr bool staged_f32_instance(int D) {
  return D == 256 || D == 512;
}

// keys of a staged slot: the UNet's live row, 64 at D = 256, 16 at 512; a
// longer live row goes through its slots in turn
template <int D>
__host__ __device__ constexpr int vr_f32s_slot() {
  return D == 256 ? 64 : 16;
}

// query rows of K2's CTA: a head's valid rows at the UNet's token counts, a
// longer head's row blocks in turn inside the one CTA
template <int D>
__host__ __device__ constexpr int vr_f32s_rows() {
  return D == 256 ? 64 : 16;
}

// columns of D a K2 stage holds of Q, dO, K and V: 32 at D = 256 (four tiles
// of 64 rows, 36.9 KB a stage, two CTAs an SM), 128 at 512
template <int D>
__host__ __device__ constexpr int vr_f32s_chunk() {
  return D == 256 ? 32 : 128;
}

// K2's score partials a stage: its chunk's columns split into this many
// sums, each from zero, interleaved so that their mma.sync chains overlap,
// added in order (a sum over chunk / parts columns): 1 at D = 256, where a
// warp's eight n-tiles already overlap, 4 at 512, where a warp has one
template <int D>
__host__ __device__ constexpr int vr_f32s_parts() {
  return D == 256 ? 1 : 4;
}

// K2: the slot's keys split between this many warps for s, and as many for
// dp, of each 16 query rows: 1 at D = 256 (a warp's s or dp over 64 keys), 2
// at 512 (8 keys each, so that four warps form the 16 rows' scores)
template <int D>
__host__ __device__ constexpr int vr_f32s_key_parts() {
  return D == 256 ? 1 : 2;
}

// K2's CTAs an SM that its registers must allow (128 a thread at D = 256)
constexpr int VR_F32S_BWD_BLOCKS = 2;

// K2's threads: eight warps, a warp for the s and one for the dp of each 16
// rows and key part (at D = 512 four of them, the others idle in phase 1),
// all sharing phase 2's tiles and the zero dk and dv of the padded keys;
// eight took K2 at D = 512, B=128, H=2 to 0.0798 ms from four's 0.0831-0.0841
// (scripts/d2_valid_variants.py; NVIDIA H100 80GB HBM3, 700 W)
constexpr int VR_F32S_BWD_THREADS = 256;

// K1's query rows a CTA (a head's 64 valid rows at D = 256) and the columns
// of D a stage holds of Q and K (or of V). Each warp forms its 16 rows'
// scores over the whole of D, one sum from zero a stage, and one column
// group holds the head. At D = 512 the split instance of 8-key tiles stays:
// the staged one tied it at B=128 and lost 0.91x at the sampler's B=16
// (PERF.md, NVIDIA H100 80GB HBM3, 700 W)
constexpr int VR_F32S_FWD_ROWS = 64;
constexpr int VR_F32S_FWD_CHUNK = 64;
constexpr int VR_F32S_FWD_THREADS = 32 * VR_F32S_FWD_ROWS / 16;

// stages of the staged instances' rings, one loading while one is computed
constexpr int VR_F32S_STAGES = 2;

// acc += s for a warp's 16 rows (rows a0 of tile `a`) against tile rows 8
// nt, over C columns, as P sums of C / P columns each from zero, their
// k-steps interleaved (P independent mma.sync chains), added to acc in order
template <int C, int N, int LDT, int P>
__device__ __forceinline__ void rows_dot_add(float (&acc)[N / 8][4], const float* a, int a0, const float* t, int g,
                                             int t4) {
  static_assert(C % (8 * P) == 0, "whole k-steps a partial");
  constexpr int KS = C / 8 / P;
  float part[P][N / 8][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) part[p][nt][0] = part[p][nt][1] = part[p][nt][2] = part[p][nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int p = 0; p < P; ++p) {
      uint32_t ah[4], al[4];
      frag_a<C, LDT>(ah, al, a, a0, p * KS + ks, g, t4);
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        uint32_t bh[2], bl[2];
        frag_b_rows<C, LDT>(bh, bl, t, nt * 8, p * KS + ks, g, t4);
        mma3(part[p][nt], ah, al, bh, bl);
      }
    }
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += part[p][nt][e];
}

// A of a warp's rows r0 + [0, 16) of a row-major tile (rows LDT floats
// apart), the reduction over its columns 8 kk + [0, 8) in the permuted order
// of frag_b_cols (slot t4: column 2 t4, slot t4 + 4: 2 t4 + 1), two floats a load
template <int LDT>
__device__ __forceinline__ void frag_a_rows_perm(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* t, int r0, int kk,
                                                 int g, int t4) {
  const float2 x = *reinterpret_cast<const float2*>(t + (r0 + g) * LDT + kk * 8 + 2 * t4);
  const float2 y = *reinterpret_cast<const float2*>(t + (r0 + g + 8) * LDT + kk * 8 + 2 * t4);
  split_tf32(x.x, hi[0], lo[0]);
  split_tf32(y.x, hi[1], lo[1]);
  split_tf32(x.y, hi[2], lo[2]);
  split_tf32(y.y, hi[3], lo[3]);
}

// A = T^T for the warp's rows c0 + [0, 16), which are columns of the
// row-major tile T (rows LDT floats apart): the reduction runs over T's rows
// 8 kk + [0, 8) in the permuted order of frag_b_cols
template <int LDT>
__device__ __forceinline__ void frag_a_cols_perm(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* t, int c0, int kk,
                                                 int g, int t4) {
  const float* p = t + (kk * 8 + 2 * t4) * LDT + c0 + g;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8], hi[1], lo[1]);
  split_tf32(p[LDT], hi[2], lo[2]);
  split_tf32(p[LDT + 8], hi[3], lo[3]);
}

// rows r0 + [0, ROWS) of one head, columns col + [0, C), into a [ROWS][C + 4]
// tile by the CTA's THREADS threads: a row at or past `end` is zero-filled
// by the copy itself; not awaited
template <int C, int ROWS, int THREADS>
__device__ __forceinline__ void stage_chunk_rows(float* dst, const float* src, long long ss, int r0, int end,
                                                 int col) {
  constexpr int CHUNKS = C / 4;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
    const bool in = r0 + r < end;
    cp_async16(dst + r * (C + 4) + c, in ? src + (long long)(r0 + r) * ss + col + c : src, in ? 16 : 0);
  }
}

// the rows of a slot, columns col + [0, C): tiles[0, n) of KT rows each (row
// tiles[j] KT + r of one head) into rows j KT + r of a [SLOT][C + 4] tile,
// the rows past n KT zero-filled; not awaited
template <int C, int SLOT, int KT, int THREADS>
__device__ __forceinline__ void stage_chunk_tiles(float* dst, const float* src, long long ss, const int* tiles, int n,
                                                  int col) {
  constexpr int CHUNKS = C / 4;
  for (int i = threadIdx.x; i < SLOT * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
    const bool in = r / KT < n;
    const long long row = in ? (long long)tiles[r / KT] * KT + r % KT : 0;
    cp_async16(dst + r * (C + 4) + c, src + row * ss + col + c, in ? 16 : 0);
  }
}

}  // namespace
