// KV-tiled flash-attention backward for Hopper (sm_90a): K4 (dk, dv) and K5 (dq).
//
// Replaces the Pallas TPU kernels diffulab_tpu/ops/flash_attention.py::
// _bwd_dkv_kernel (K4) and ::_bwd_dq_kernel (K5), both launched by
// _flash_backward. From the forward's residuals q, k, v, the key mask, o and
// lse (K3's [B, H, Sq] layout), with di = rowsum(o * do) in fp32 formed from
// the STORED o (the reference forms it outside Pallas, flash_attention.py:275;
// here a pre-pass kernel launched by flash_attn_bwd_dkv), per (batch, head):
//   s  = q.k^T * scale in fp32; masked keys (and keys past Skv) give p = 0;
//   p  = exp(s - lse) in fp32 (a fully-masked row has lse = +inf: p = 0);
//   dv = round(p)^T . do     (K4; p rounded to do's dtype);
//   dp = do . v^T            in fp32;
//   ds = p * (dp - di) * scale;
//   dk = round(ds)^T . q     (K4; ds rounded to q's dtype);
//   dq = round(ds) . k       (K5; ds rounded to k's dtype);
// fp32 accumulation, dq/dk/dv written in the input dtype; p as one
// ex2.approx of s * scale * log2(e) - lse * log2(e).
//
// Bound on an H100 SXM (data-sheet peaks at 700 W): at the txt2img MMDiT
// training shape (B=8, S=4224, H=12, D=64, bf16, the ragged text mask) K4
// makes four products over the valid keys (s, dv, dp, dk) and K5 three (s,
// dp, dq): ~860 and ~645 GFLOP, 0.87 and 0.65 ms at 989 TFLOP/s, against
// ~367 MB and ~263 MB of inputs and outputs, 0.11 and 0.08 ms at 3.35 TB/s.
// Both are compute-bound, and ~1.7 G exponentials each are a second ceiling
// (~0.45 ms at 16 ex2 a clock on each of 132 SMs) that has to overlap the
// products. The pre-pass is bound by its bytes: o and do read once (104 MB,
// 31 us).
//
// The TPU kernels ran a sequential grid axis and carried the sums in VMEM
// scratch; on Hopper that axis is a loop inside one CTA, and each sum stays
// in one CTA's registers (no atomics: the result does not depend on the run,
// as the reference's two-kernel split does not).
//
// bf16 at D = 64 and 128 (flash_bwd_dkv_hopper, flash_bwd_dq_hopper, whose
// bodies live in attn_bwd_hopper.cuh, where K2 shares them): one CTA
// per 128 keys (K4) or 128 queries (K5) of one (batch, head), two warpgroups
// of 64 rows. The CTA's own rows (K and V in K4, Q and dO in K5) land once by
// TMA and stay in shared memory, at D = 64 also as register A operands; the
// other operands stream through a four-slot TMA ring (K4: Q and dO tiles of 64
// queries, 32 at D = 128, with their lse and di vectors; K5: K and V tiles of
// 128 keys, 64 at D = 128), refilled by one thread as soon as both warpgroups
// have released a slot. Every product is a wgmma with fp32 accumulators: the
// score-like products (S = Q.K^T and dP = dO.V^T, or their transposes with
// keys as rows in K4) against a K-major B, the gradient products taking p or
// ds from the accumulators straight into A registers (rounded to bf16)
// against an MN-major B. A warpgroup issues a tile's score products together
// with the last tile's gradient products, then forms p while dP runs; the two
// warpgroups take turns at the tensor cores, so that one's exponentials
// overlap the other's products. Results are staged in shared memory where
// the warpgroup's own rows were and leave by TMA store. q/k/v/o/do are read
// in the [B, S, H, D] layout at the caller's batch and row strides through
// 3-D tensor maps (no transpose, no padded copy); TMA zero-fills the ragged
// ends, which the kernels mask.
//
// bf16 at D = 16 and 32: the first kernels, mma.sync m16n8k16 with tiles
// double-buffered by cp.async (K4 one CTA per 64 keys, K5 per 64 queries, four
// warps of 16 rows, p and ds from the C fragments into A fragments, B operands
// by ldmatrix[.trans]).
//
// fp32 K4 and K5 (flash_bwd_dkv_tf32x3<D>, flash_bwd_dq_tf32x3<D>, D =
// 16-128): the tensor cores take no fp32 operand, so their products run as
// 3xTF32 (tf32x3.cuh: each operand split into two TF32 halves, three mma.sync
// m16n8k8 products, about 2^-21 relative each). At the training shape that is
// 3 x 859.9 GFLOP (K4) and 3 x 644.9 (K5) at 495 TFLOP/s, 5.211 and 3.909
// ms, against 12.834 and 9.626 at the CUDA cores' 67 TFLOP/s and ~0.7 and
// ~0.5 GB of fp32 operands (0.2 and 0.15 ms): bound by operations. K4: one CTA per (128
// keys, head, batch; 64 at D = 128), warps of 16 keys, the CTA's K and V rows
// staged once; Q and dO tiles of dkv_f32_queries queries, with their lse2
// and di from the pre-pass's workspace, through a two-slot cp.async ring
// (rows past Sq and Skv zero-filled by the copy itself, source size 0). Per
// tile p^T = ex2(K.Q^T * scale * log2 e - lse2) (0 on a masked key, and on a
// query past Sq, whose lse2 is +inf), dv += p^T.dO, dp^T = V.dO^T, ds^T =
// p^T * (dp^T - di) * scale, dk += ds^T.Q: four products of [keys x Sq x D],
// p and ds from the C fragments straight into A operands. dk and dv stay in
// fp32 registers until one store of the rows below Skv; each tile's dv and
// dk sums start from zero and are added to them in fp32, since the tensor
// cores round an mma's sum toward zero and a sum carried through 4224
// queries drifted one way (dv 1.0e-5 off at max |dv| 0.28 in a 2e-5 * (max
// + |dv|) check; tf32x3.cuh, scores_times_tile_fresh). K5 is the fp32 K3's
// structure (flash_attn_fwd.cu) with K in V's place: one CTA per (128 query
// rows, head, batch; 64 at D = 128), warps of 16 rows, Q and dO staged once
// (Q's split fragments kept in registers at D <= 64), K and V tiles of
// dq_f32_keys keys through a two-slot cp.async ring, the tile's mask as
// ballot words; per tile s = Q.K^T, p = ex2(s * scale * log2 e - lse2),
// dp = dO.V^T, ds = p * (dp - di) * scale and dq += ds.K, each tile's dq
// summed from zero as K4's sums are, and dq stored once.
//
// Plain C interface (bound with ctypes): flash_attn_bwd_dkv launches the
// pre-pass and K4, flash_attn_bwd_dq launches K5; each returns the first CUDA
// error of its launches.

#include <math.h>
#include <stdint.h>

#include "attn_bwd_hopper.cuh"  // the Hopper kernels at D = 64 and 128 (shared with K2), hopper.cuh
#include "tf32x3.cuh"            // fp32 K4/K5's 3xTF32 mma.sync fragments, cp.async staging

namespace {

constexpr int BLOCK = 64;     // rows per CTA and rows per staged tile (bf16 kernels at D = 16, 32)
constexpr int WARPS = 4;      // bf16 kernels at D = 16, 32: 16 rows per warp
constexpr int CHUNK = 32;     // score columns held in registers at a time
constexpr int PAD = 8;        // bf16 elements of padding per shared-memory row
static_assert(BLOCK == 2 * CHUNK && CHUNK == 32, "K5 holds a tile's key mask in two 32-bit words");

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, whose fragment lands in r[i]
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const bf16* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// the same, transposed
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes global -> shared, asynchronous; src_bytes = 0 fills zeros
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared, asynchronous; src_bytes = 0 fills zeros
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(src), "r"(src_bytes));
}

template <int D>
using Tile = bf16 (*)[D + PAD];

// rows [r0, r0 + BLOCK) of one head (D columns) into shared memory, 16 bytes
// a thread, asynchronously; rows past S are zero-filled
template <int D>
__device__ __forceinline__ void stage_async(Tile<D> dst, const bf16* src, long long row_stride, int r0, int S) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < BLOCK * CHUNKS; i += WARPS * 32) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const bool in = r0 + r < S;
    const bf16* s = in ? src + (long long)(r0 + r) * row_stride + c : src;
    cp_async_16(&dst[r][c], s, in ? 16 : 0);
  }
}

// BLOCK fp32 values src[r0 ..] into shared memory, asynchronously; past S, zeros
__device__ __forceinline__ void stage_vec_async(float* dst, const float* src, int r0, int S) {
  for (int i = threadIdx.x; i < BLOCK; i += WARPS * 32) {
    const bool in = r0 + i < S;
    cp_async_4(dst + i, in ? src + r0 + i : src, in ? 4 : 0);
  }
}

// A fragments (16 rows x D) of rows row, row + 8 read from global memory;
// rows at or past S are zeros
template <int D>
__device__ __forceinline__ void load_a(uint32_t f[D / 16][4], const bf16* base, long long stride, int row, int S,
                                       int t4) {
  const bool in0 = row < S, in1 = row + 8 < S;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* r0 = base + (long long)row * stride + kk * 16 + 2 * t4;
    const bf16* r1 = r0 + 8 * stride;
    f[kk][0] = in0 ? *reinterpret_cast<const uint32_t*>(r0) : 0u;
    f[kk][1] = in1 ? *reinterpret_cast<const uint32_t*>(r1) : 0u;
    f[kk][2] = in0 ? *reinterpret_cast<const uint32_t*>(r0 + 8) : 0u;
    f[kk][3] = in1 ? *reinterpret_cast<const uint32_t*>(r1 + 8) : 0u;
  }
}

// c[nt][j] = sum_d A[row][d] * T[c0 + col][d] for the warp's 16 rows against
// tile rows c0 + [0, CHUNK). C layout: j = 0,1 -> row g, col nt*8 + 2*t4 + j;
// j = 2,3 -> row g + 8. T's rows are the n axis, read with ldmatrix.
template <int D>
__device__ __forceinline__ void rows_dot_tile(float c[CHUNK / 8][4], const uint32_t af[D / 16][4], Tile<D> ts,
                                              int c0, int lane) {
  const int mat = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int nt = 0; nt < CHUNK / 8; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
    if constexpr (D >= 32) {
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        // matrices: (rows c0+nt*8.., cols kk*16..), (.., kk*16+8..), (.., kk*16+16..), (.., kk*16+24..)
        uint32_t b[4];
        ldsm_x4(b, &ts[c0 + nt * 8 + mr][kk * 16 + mat * 8]);
        mma_16816(c[nt], af[kk], b);
        mma_16816(c[nt], af[kk + 1], b + 2);
      }
    } else {
      uint32_t b[2];
      ldsm_x2(b, &ts[c0 + nt * 8 + mr][(mat & 1) * 8]);
      mma_16816(c[nt], af[0], b);
    }
  }
}

// acc[16 rows x D] += round_bf16(x[16 rows x CHUNK]) . T[c0 .. c0 + CHUNK)[0 .. D):
// x in the C layout of rows_dot_tile becomes the A operand in registers; T's
// rows are the reduction axis, read with ldmatrix.trans.
template <int D>
__device__ __forceinline__ void chunk_times_tile(float acc[D / 8][4], const float x[CHUNK / 8][4], Tile<D> ts,
                                                 int c0, int lane) {
  const int mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < CHUNK / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const int k0 = c0 + kk * 16;
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      // matrices: (rows k0.., cols dn*8..), (k0+8.., dn*8..), (k0.., dn*8+8..), (k0+8.., dn*8+8..)
      uint32_t b[4];
      ldsm_x4_trans(b, &ts[k0 + (mat & 1) * 8 + r][dn * 8 + (mat >> 1) * 8]);
      mma_16816(acc[dn], a, b);
      mma_16816(acc[dn + 1], a, b + 2);
    }
  }
}

// rows row, row + 8 of a contiguous [.., H * D] output, in bf16; rows at or past S skipped
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long row_stride, int row, int S,
                                           const float acc[D / 8][4], int t4) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t4;
    if (row < S)
      *reinterpret_cast<uint32_t*>(out + (long long)row * row_stride + col) = pack_bf16(acc[dn][0], acc[dn][1]);
    if (row + 8 < S)
      *reinterpret_cast<uint32_t*>(out + (long long)(row + 8) * row_stride + col) = pack_bf16(acc[dn][2], acc[dn][3]);
  }
}

template <int D>
constexpr int bf16_smem_bytes() {
  // two stages of two [BLOCK][D + PAD] tiles, and (K4) two stages of lse and di
  return 4 * BLOCK * (D + PAD) * static_cast<int>(sizeof(bf16)) + 4 * BLOCK * static_cast<int>(sizeof(float));
}

// --- the pre-pass: lse in log2 units and di = rowsum(o * do), fp32 ----------------

// fp32 dot product of two 16-byte pieces of a row
template <typename T>
__device__ __forceinline__ float dot16(const uint4& x, const uint4& y);

template <>
__device__ __forceinline__ float dot16<float>(const uint4& x, const uint4& y) {
  float acc = __uint_as_float(x.x) * __uint_as_float(y.x);
  acc = fmaf(__uint_as_float(x.y), __uint_as_float(y.y), acc);
  acc = fmaf(__uint_as_float(x.z), __uint_as_float(y.z), acc);
  return fmaf(__uint_as_float(x.w), __uint_as_float(y.w), acc);
}

template <>
__device__ __forceinline__ float dot16<bf16>(const uint4& x, const uint4& y) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    acc = fmaf(a.x, c.x, acc);
    acc = fmaf(a.y, c.y, acc);
  }
  return acc;
}

// One pass over o and do before K4. For each row (b, q, h): di = rowsum(o *
// do) in fp32 from the stored o, and lse2 = lse * log2(e), into the fp32
// workspace ws = [2][B * H][ws_rs] (lse2, then di; row q of (b, h) at (b * H +
// h) * ws_rs + q), with lse2 = +inf and di = 0 on the padding rows [Sq,
// ws_rs), which K4's last query tile reads. A row of one head is LANES
// 16-byte pieces, one a lane: a warp reads 32 / LANES neighbouring rows
// ([B, Sq, H, D] with the heads contiguous), 512 contiguous bytes, and sums
// each row over its lanes by shuffles.
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep(const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ ws, int B, int Sq, int H, int ws_rs, long long o_sb, long long o_ss,
               long long do_sb, long long do_ss) {
  constexpr int LANES = D * static_cast<int>(sizeof(T)) / 16;
  constexpr int ELEMS = 16 / static_cast<int>(sizeof(T));
  static_assert(LANES >= 1 && LANES <= 32 && (LANES & (LANES - 1)) == 0, "a row is 1-32 lanes, a power of two");
  const long long rows = (long long)B * Sq * H;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t / LANES;  // (b, q, h), h fastest
  const int part = static_cast<int>(t % LANES);
  const int h = static_cast<int>(row % H);
  const long long bq = row / H;
  const int qi = static_cast<int>(bq % Sq), b = static_cast<int>(bq / Sq);
  float acc = 0.f;
  if (row < rows) {
    const uint4 x = *reinterpret_cast<const uint4*>(o + b * o_sb + qi * o_ss + h * D + part * ELEMS);
    const uint4 y = *reinterpret_cast<const uint4*>(dout + b * do_sb + qi * do_ss + h * D + part * ELEMS);
    acc = dot16<T>(x, y);
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  const long long plane = (long long)B * H * ws_rs;
  if (row < rows && part == 0) {
    const long long i = ((long long)b * H + h) * ws_rs + qi;
    ws[i] = lse[((long long)b * H + h) * Sq + qi] * LOG2E;
    ws[plane + i] = acc;
  }
  const int pad = ws_rs - Sq;
  for (long long i = t; i < (long long)B * H * pad; i += (long long)gridDim.x * blockDim.x) {
    const long long j = (i / pad) * ws_rs + Sq + i % pad;
    ws[j] = INFINITY;
    ws[plane + j] = 0.f;
  }
}

// --- bf16 -----------------------------------------------------------------------

// K4 at D = 16 and 32: dk, dv for 64 keys of one (batch, head), over every
// query tile; three CTAs an SM (at most 168 registers a thread)
template <int D>
__global__ void __launch_bounds__(WARPS * 32, 3)
flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const bf16* __restrict__ dout, const int* __restrict__ mask, const float* __restrict__ lse,
                   const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv,
                   int H, int di_rs, long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                   long long v_ss, long long do_sb, long long do_ss, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile<D> tiles = reinterpret_cast<Tile<D>>(smem);
  Tile<D> qbuf[2] = {tiles, tiles + BLOCK};
  Tile<D> dobuf[2] = {tiles + 2 * BLOCK, tiles + 3 * BLOCK};
  float* vecs = reinterpret_cast<float*>(tiles + 4 * BLOCK);
  float* lse_s[2] = {vecs, vecs + BLOCK};
  float* di_s[2] = {vecs + 2 * BLOCK, vecs + 3 * BLOCK};

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int key0 = blockIdx.x * BLOCK + warp * 16 + g;  // this thread's keys: key0, key0 + 8

  const bf16* qb = q + b * q_sb + h * D;
  const bf16* dob = dout + b * do_sb + h * D;
  const float* lb = lse + ((long long)b * H + h) * Sq;
  const float* db = di + ((long long)b * H + h) * di_rs;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  const bool keep[2] = {key0 < Skv && (mb == nullptr || mb[key0] != 0),
                        key0 + 8 < Skv && (mb == nullptr || mb[key0 + 8] != 0)};
  const float scale_log2 = sm_scale * LOG2E;
  const int n_tiles = (Sq + BLOCK - 1) / BLOCK;

  stage_async<D>(qbuf[0], qb, q_ss, 0, Sq);
  stage_async<D>(dobuf[0], dob, do_ss, 0, Sq);
  stage_vec_async(lse_s[0], lb, 0, Sq);
  stage_vec_async(di_s[0], db, 0, Sq);
  cp_async_commit();

  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, k + b * k_sb + h * D, k_ss, key0, Skv, t4);
  load_a<D>(vf, v + b * v_sb + h * D, v_ss, key0, Skv, t4);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    dk_acc[dn][0] = dk_acc[dn][1] = dk_acc[dn][2] = dk_acc[dn][3] = 0.f;
    dv_acc[dn][0] = dv_acc[dn][1] = dv_acc[dn][2] = dv_acc[dn][3] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      const int m1 = (j + 1) * BLOCK;
      stage_async<D>(qbuf[st ^ 1], qb, q_ss, m1, Sq);
      stage_async<D>(dobuf[st ^ 1], dob, do_ss, m1, Sq);
      stage_vec_async(lse_s[st ^ 1], lb, m1, Sq);
      stage_vec_async(di_s[st ^ 1], db, m1, Sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    Tile<D> qs = qbuf[st], dos = dobuf[st];
    const float* ls = lse_s[st];
    const float* ds_ = di_s[st];
#pragma unroll
    for (int c0 = 0; c0 < BLOCK; c0 += CHUNK) {
      // p^T [key, query] = exp(k.q^T * scale - lse[query]), 0 for a masked key
      float p[CHUNK / 8][4], dp[CHUNK / 8][4];
      rows_dot_tile<D>(p, kf, qs, c0, lane);
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float l2 = ls[c0 + nt * 8 + 2 * t4 + (jj & 1)] * LOG2E;
          p[nt][jj] = keep[jj >> 1] ? exp2_approx(fmaf(p[nt][jj], scale_log2, -l2)) : 0.f;
        }
      chunk_times_tile<D>(dv_acc, p, dos, c0, lane);  // dv += round(p)^T . do
      rows_dot_tile<D>(dp, vf, dos, c0, lane);       // dp^T = v . do^T
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          dp[nt][jj] = p[nt][jj] * (dp[nt][jj] - ds_[c0 + nt * 8 + 2 * t4 + (jj & 1)]) * sm_scale;
      chunk_times_tile<D>(dk_acc, dp, qs, c0, lane);  // dk += round(ds)^T . q
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }

  // dk, dv [B, Skv, H, D] contiguous
  const long long o_ss = (long long)H * D;
  store_rows<D>(dk + (long long)b * Skv * o_ss + h * D, o_ss, key0, Skv, dk_acc, t4);
  store_rows<D>(dv + (long long)b * Skv * o_ss + h * D, o_ss, key0, Skv, dv_acc, t4);
}

// K5 at D = 16 and 32: dq for 64 queries of one (batch, head), over every key
// tile; four CTAs an SM (at most 128 registers a thread)
template <int D>
__global__ void __launch_bounds__(WARPS * 32, 4)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                  const bf16* __restrict__ dout, const int* __restrict__ mask, const float* __restrict__ lse,
                  const float* __restrict__ di, bf16* __restrict__ dq, int Sq, int Skv, int H, int di_rs,
                  long long q_sb,
                  long long q_ss, long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                  long long do_sb, long long do_ss, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile<D> tiles = reinterpret_cast<Tile<D>>(smem);
  Tile<D> kbuf[2] = {tiles, tiles + BLOCK};
  Tile<D> vbuf[2] = {tiles + 2 * BLOCK, tiles + 3 * BLOCK};

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * BLOCK + warp * 16 + g;  // this thread's queries: row0, row0 + 8

  const bf16* kb = k + b * k_sb + h * D;
  const bf16* vb = v + b * v_sb + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  const float scale_log2 = sm_scale * LOG2E;
  const int n_tiles = (Skv + BLOCK - 1) / BLOCK;

  stage_async<D>(kbuf[0], kb, k_ss, 0, Skv);
  stage_async<D>(vbuf[0], vb, v_ss, 0, Skv);
  cp_async_commit();

  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a<D>(qf, q + b * q_sb + h * D, q_ss, row0, Sq, t4);
  load_a<D>(df, dout + b * do_sb + h * D, do_ss, row0, Sq, t4);
  // lse in log2 units (+inf past Sq: p = 0 there) and di of the two rows
  const long long lrow = ((long long)b * H + h) * Sq;
  const float l2[2] = {row0 < Sq ? lse[lrow + row0] * LOG2E : INFINITY,
                       row0 + 8 < Sq ? lse[lrow + row0 + 8] * LOG2E : INFINITY};
  const float* drow = di + ((long long)b * H + h) * di_rs;
  const float dir[2] = {row0 < Sq ? drow[row0] : 0.f, row0 + 8 < Sq ? drow[row0 + 8] : 0.f};

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BLOCK, st = j & 1;
    // the tile's key mask as two warp-uniform words: keys n0 + [0, 32), n0 + [32, 64)
    const int key_lo = n0 + lane, key_hi = n0 + 32 + lane;
    const unsigned keep_lo = __ballot_sync(0xffffffffu, key_lo < Skv && (mb == nullptr || mb[key_lo] != 0));
    const unsigned keep_hi = __ballot_sync(0xffffffffu, key_hi < Skv && (mb == nullptr || mb[key_hi] != 0));
    if (j + 1 < n_tiles) {
      stage_async<D>(kbuf[st ^ 1], kb, k_ss, n0 + BLOCK, Skv);
      stage_async<D>(vbuf[st ^ 1], vb, v_ss, n0 + BLOCK, Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    Tile<D> ks = kbuf[st], vs = vbuf[st];
#pragma unroll
    for (int c0 = 0; c0 < BLOCK; c0 += CHUNK) {
      const unsigned word = c0 == 0 ? keep_lo : keep_hi;
      float p[CHUNK / 8][4], dp[CHUNK / 8][4];
      rows_dot_tile<D>(p, qf, ks, c0, lane);  // s = q.k^T
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const bool kept = (word >> (nt * 8 + 2 * t4 + (jj & 1))) & 1u;
          p[nt][jj] = kept ? exp2_approx(fmaf(p[nt][jj], scale_log2, -l2[jj >> 1])) : 0.f;
        }
      rows_dot_tile<D>(dp, df, vs, c0, lane);  // dp = do.v^T
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) dp[nt][jj] = p[nt][jj] * (dp[nt][jj] - dir[jj >> 1]) * sm_scale;
      chunk_times_tile<D>(acc, dp, ks, c0, lane);  // dq += round(ds) . k
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }

  // dq [B, Sq, H, D] contiguous
  const long long o_ss = (long long)H * D;
  store_rows<D>(dq + (long long)b * Sq * o_ss + h * D, o_ss, row0, Sq, acc, t4);
}

// --- fp32 -------------------------------------------------------------------------

// K4 in fp32: 3xTF32 products on the tensor cores (tf32x3.cuh)

// The tiles below were picked by timing scripts/flash_fp32_variants.py at the
// txt2img training shape (B=8, S=4224, H=12, D=64, the training mask; NVIDIA
// H100 80GB HBM3, 700 W): with its pre-pass, eight warps took 14.05 ms, four
// 14.80; 32-query slots 15.27 (PERF.md §6).

// warps of 16 keys in a CTA: eight at D <= 64 (128 keys), four at D = 128,
// where dk and dv take 128 registers a thread
template <int D>
__host__ __device__ constexpr int dkv_f32_warps() {
  return D <= 64 ? 8 : 4;
}

// queries of a ring slot: 64, and 32 at D = 128; a divisor of WS_ALIGN, so
// that the last tile reads whole workspace rows (+inf and 0 past Sq)
template <int D>
__host__ __device__ constexpr int dkv_f32_queries() {
  return D <= 64 ? 64 : 32;
}

// bytes of dynamic shared memory: the CTA's K and V rows, two ring slots of Q and dO, and their lse2 and di
template <int D>
__host__ __device__ constexpr int dkv_f32_smem_bytes() {
  return 4 * (ld<D>() * (2 * 16 * dkv_f32_warps<D>() + 2 * 2 * dkv_f32_queries<D>()) + 2 * 2 * dkv_f32_queries<D>());
}

// dk and dv for 16 * dkv_f32_warps keys of a (batch, head) over every query
// tile, from the pre-pass's lse2 (lse * log2 e) and di rows, ws_rs apart
template <int D>
__global__ void __launch_bounds__(32 * dkv_f32_warps<D>())
flash_bwd_dkv_tf32x3(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ dout, const int* __restrict__ mask, const float* __restrict__ ws_lse2,
                     const float* __restrict__ ws_di, float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv,
                     int H, int ws_rs, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                     long long v_sb, long long v_ss, long long do_sb, long long do_ss, float sm_scale) {
  constexpr int QT = dkv_f32_queries<D>(), LD = ld<D>(), KEYS = 16 * dkv_f32_warps<D>(), THREADS = 2 * KEYS;
  // columns of a tile sum's block: 32 at D = 128, where dk and dv hold 128 registers (64 spilled 76 bytes)
  constexpr int CB = D <= 64 ? D : 32;
  static_assert(WS_ALIGN % QT == 0 && QT / 2 <= THREADS,
                "a slot's lse2 and di: whole workspace rows, one 16-byte copy a thread");
  extern __shared__ __align__(16) float fsmem[];
  float* ks = fsmem;                 // [KEYS][LD]
  float* vs = ks + KEYS * LD;        // [KEYS][LD]
  float* qs = vs + KEYS * LD;        // [2][QT][LD]
  float* dos = qs + 2 * QT * LD;     // [2][QT][LD]
  float* lse_s = dos + 2 * QT * LD;  // [2][QT]
  float* di_s = lse_s + 2 * QT;      // [2][QT]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * KEYS, r0 = 16 * warp;
  const int key = n0 + r0 + g;  // this thread's keys: key, key + 8
  const float* qb = q + b * q_sb + h * D;
  const float* dob = dout + b * do_sb + h * D;
  const float* wl = ws_lse2 + ((long long)b * H + h) * ws_rs;
  const float* wd = ws_di + ((long long)b * H + h) * ws_rs;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  bool keep[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) keep[r] = key + 8 * r < Skv && (mb == nullptr || mb[key + 8 * r] != 0);
  const float scale_log2 = sm_scale * LOG2E;
  const int n_tiles = (Sq + QT - 1) / QT;

  auto stage = [&](int t) {
    const int slot = t & 1;
    stage_rows_upto<D, QT, THREADS>(qs + slot * QT * LD, qb, q_ss, t * QT, Sq);
    stage_rows_upto<D, QT, THREADS>(dos + slot * QT * LD, dob, do_ss, t * QT, Sq);
    const int i = threadIdx.x;  // QT / 4 chunks of lse2, then of di
    if (i < QT / 4)
      cp_async16(lse_s + slot * QT + 4 * i, wl + t * QT + 4 * i);
    else if (i < QT / 2)
      cp_async16(di_s + slot * QT + 4 * (i - QT / 4), wd + t * QT + 4 * (i - QT / 4));
  };

  stage_rows_upto<D, KEYS, THREADS>(ks, k + b * k_sb + h * D, k_ss, n0, Skv);
  stage_rows_upto<D, KEYS, THREADS>(vs, v + b * v_sb + h * D, v_ss, n0, Skv);
  stage(0);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dn][e] = dv_acc[dn][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int slot = t & 1;
    const float* qt = qs + slot * QT * LD;
    const float* dot = dos + slot * QT * LD;
    const float* lt = lse_s + slot * QT;
    const float* dt = di_s + slot * QT;

    // p^T [key, query] = ex2(k.q^T * scale * log2 e - lse2[query]), 0 on a masked key; dp^T = v.dO^T
    float p[QT / 8][4], dp[QT / 8][4];
    rows_dot<D, QT>(p, ks, r0, qt, g, t4);
    rows_dot<D, QT>(dp, vs, r0, dot, g, t4);
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[nt][e] = keep[e >> 1] ? exp2_approx(fmaf(p[nt][e], scale_log2, -lt[nt * 8 + 2 * t4 + (e & 1)])) : 0.f;
    scores_times_tile_fresh<D, QT, CB>(dv_acc, p, dot, g, t4);  // dv += p^T.dO, the tile's sum added
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = p[nt][e] * (dp[nt][e] - dt[nt * 8 + 2 * t4 + (e & 1)]) * sm_scale;
    scores_times_tile_fresh<D, QT, CB>(dk_acc, dp, qt, g, t4);  // dk += ds^T.Q, the tile's sum added
    __syncthreads();  // the slot is refilled next iteration
  }

  // dk, dv [B, Skv, H, D] contiguous, the rows below Skv
  const long long o_ss = (long long)H * D;
  store_c_rows_upto<D>(dk + (long long)b * Skv * o_ss + h * D, o_ss, key, dk_acc, t4, Skv);
  store_c_rows_upto<D>(dv + (long long)b * Skv * o_ss + h * D, o_ss, key, dv_acc, t4, Skv);
}

// K5 in fp32: 3xTF32 products on the tensor cores (tf32x3.cuh), K3's fp32
// structure with K in V's place in the last product

// The tiles and the operand rule below were picked by timing
// scripts/flash_fp32_variants.py at the txt2img training shape (B=8, S=4224,
// H=12, D=64, the training mask; NVIDIA H100 80GB HBM3, 700 W; PERF.md §6):
// eight warps, 64-key slots and Q's fragments held took 10.80 ms; four warps
// 10.98; 32-key slots 11.67; dO's fragments held too 12.38 (80 bytes
// spilled); Q's split from shared memory as well 12.62.

// warps of 16 query rows in a CTA: eight at D <= 64, four at D = 128, where dq takes 64 registers a thread
template <int D>
__host__ __device__ constexpr int dq_f32_warps() {
  return D <= 64 ? 8 : 4;
}

// keys of a ring slot (KT / 32 mask words): 64 at D <= 64, 32 at D = 128
template <int D>
__host__ __device__ constexpr int dq_f32_keys() {
  return D <= 64 ? 64 : 32;
}

// bytes of dynamic shared memory: the CTA's Q and dO rows and two ring slots of K and V
template <int D>
__host__ __device__ constexpr int dq_f32_bytes() {
  return 4 * ld<D>() * (2 * 16 * dq_f32_warps<D>() + 2 * 2 * dq_f32_keys<D>());
}

// dq for 16 * dq_f32_warps query rows of a (batch, head) over every key
// tile, from K3's lse [B, H, Sq] and the pre-pass's di (rows di_rs apart):
// per tile s = Q.K^T, p = ex2(s * scale * log2 e - lse2) (0 on a key masked
// or past Skv, and on a row past Sq, whose lse2 is +inf), dp = dO.V^T, ds =
// p * (dp - di) * scale, dq += ds.K summed from zero and added in fp32. A
// tile without an attended key adds exactly 0 and is skipped.
template <int D>
__global__ void __launch_bounds__(32 * dq_f32_warps<D>())
flash_bwd_dq_tf32x3(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout, const int* __restrict__ mask, const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq, int Sq, int Skv, int H, int di_rs,
                    long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                    long long do_sb, long long do_ss, float sm_scale) {
  constexpr int KT = dq_f32_keys<D>(), LD = ld<D>(), ROWS = 16 * dq_f32_warps<D>(), THREADS = 2 * ROWS;
  // Q's split fragments stay in registers for every key tile at D <= 64; dO's are split from shared memory
  // every tile (DOREG holds them too: the variant that spilled)
  constexpr bool QREG = D <= 64, DOREG = false;
  static_assert(KT % 32 == 0, "a tile's mask is KT / 32 ballot words");
  extern __shared__ __align__(16) float fsmem[];
  float* qs = fsmem;             // [ROWS][LD]
  float* dos = qs + ROWS * LD;   // [ROWS][LD]
  float* ks = dos + ROWS * LD;   // [2][KT][LD]
  float* vs = ks + 2 * KT * LD;  // [2][KT][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * ROWS, r0 = 16 * warp;
  const int row = m0 + r0 + g;  // this thread's rows: row, row + 8
  const float* kb = k + b * k_sb + h * D;
  const float* vb = v + b * v_sb + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  const int n_tiles = (Skv + KT - 1) / KT;
  const float scale_log2 = sm_scale * LOG2E;

  auto stage = [&](int t) {
    stage_rows_upto<D, KT, THREADS>(ks + (t & 1) * KT * LD, kb, k_ss, t * KT, Skv);
    stage_rows_upto<D, KT, THREADS>(vs + (t & 1) * KT * LD, vb, v_ss, t * KT, Skv);
  };
  stage_rows_upto<D, ROWS, THREADS>(qs, q + b * q_sb + h * D, q_ss, m0, Sq);
  stage_rows_upto<D, ROWS, THREADS>(dos, dout + b * do_sb + h * D, do_ss, m0, Sq);
  cp_async_commit();
  stage(0);
  cp_async_commit();

  // lse2 = lse * log2 e, the pre-pass's multiply, and di of the two rows; +inf and 0 past Sq
  const long long bh = (long long)b * H + h;
  float lse2[2], dir[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    lse2[r] = i < Sq ? lse[bh * Sq + i] * LOG2E : INFINITY;
    dir[r] = i < Sq ? di[bh * di_rs + i] : 0.f;
  }

  [[maybe_unused]] uint32_t qh[QREG ? D / 8 : 1][4], ql[QREG ? D / 8 : 1][4];
  [[maybe_unused]] uint32_t dh[DOREG ? D / 8 : 1][4], dl[DOREG ? D / 8 : 1][4];
  if constexpr (QREG || DOREG) {
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      if constexpr (QREG) frag_a<D>(qh[kk], ql[kk], qs, r0, kk, g, t4);
      if constexpr (DOREG) frag_a<D>(dh[kk], dl[kk], dos, r0, kk, g, t4);
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    // the tile's mask: bit i of word w is key t * KT + 32 w + i kept (0 past Skv), the same in every lane
    uint32_t words[KT / 32];
    uint32_t any = 0u;
    bool full = true;
#pragma unroll
    for (int w = 0; w < KT / 32; ++w) {
      const int key = t * KT + 32 * w + lane;
      words[w] = __ballot_sync(0xffffffffu, key < Skv && (mb == nullptr || mb[key] != 0));
      any |= words[w];
      full &= words[w] == 0xffffffffu;
    }
    if (t + 1 < n_tiles) {
      stage(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (any != 0u) {  // the same in every warp of the CTA
      const float* kt = ks + (t & 1) * KT * LD;
      const float* vt = vs + (t & 1) * KT * LD;
      float s[KT / 8][4], dp[KT / 8][4];
      if constexpr (QREG)
        rows_dot<D, KT>(s, qh, ql, kt, g, t4);
      else
        rows_dot<D, KT>(s, qs, r0, kt, g, t4);
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool kept = full || ((words[nt / 4] >> ((nt % 4) * 8 + 2 * t4 + (e & 1))) & 1u);
          s[nt][e] = kept ? exp2_approx(fmaf(s[nt][e], scale_log2, -lse2[e >> 1])) : 0.f;
        }
      if constexpr (DOREG)
        rows_dot<D, KT>(dp, dh, dl, vt, g, t4);  // dp = dO.V^T
      else
        rows_dot<D, KT>(dp, dos, r0, vt, g, t4);
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - dir[e >> 1]) * sm_scale;
      scores_times_tile_fresh<D, KT>(acc, dp, kt, g, t4);  // dq += ds.K, the tile's sum added
    }
    __syncthreads();  // the slot is refilled next iteration
  }

  // dq [B, Sq, H, D] contiguous, the rows below Sq
  const long long o_ss = (long long)H * D;
  store_c_rows_upto<D>(dq + (long long)b * Sq * o_ss + h * D, o_ss, row, acc, t4, Sq);
}

// --- bf16 at D = 64 and 128: the Hopper kernels of attn_bwd_hopper.cuh -----------

// K4 (dk, dv), one CTA per (128 keys, head, batch): bwd_dkv_hopper
template <int D>
__global__ void __launch_bounds__(HB_THREADS, 1)
flash_bwd_dkv_hopper(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
                     const int* __restrict__ mask, const float* __restrict__ ws, int Sq, int Skv, int H, int ws_rs,
                     float sm_scale) {
  bwd_dkv_hopper<D>(tq, tk, tv, tdo, tdk, tdv, mask, ws, Sq, Skv, H, ws_rs, sm_scale);
}

// K5 (dq), one CTA per (128 queries, head, batch): bwd_dq_hopper from K3's
// lse [B, H, Sq] and the pre-pass's di (`ws` unused)
template <int D>
__global__ void __launch_bounds__(HB_THREADS, 1)
flash_bwd_dq_hopper(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tdq, const int* __restrict__ mask,
                    const float* __restrict__ lse, const float* __restrict__ di, float* __restrict__ ws, int Sq,
                    int Skv, int H, int di_rs, float sm_scale) {
  bwd_dq_hopper<D, false>(tq, tk, tv, tdo, tdq, mask, lse, di, ws, Sq, Skv, H, di_rs, sm_scale);
}

// --- launches -------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_prep(const Args& a, cudaStream_t stream) {
  constexpr int lanes = D * static_cast<int>(sizeof(T)) / 16, threads = 256;
  const long long blocks = ((long long)a.B * a.Sq * a.H * lanes + threads - 1) / threads;
  flash_bwd_prep<T, D><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.ws, a.B, a.Sq, a.H, a.ws_rs, a.o_sb,
      a.o_ss, a.do_sb, a.do_ss);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 1) {
    cudaError_t err = launch_prep<bf16, D>(a, stream);
    if (err != cudaSuccess) return err;
    if constexpr (D >= 64) {
      static bool configured[MAX_DEVICES] = {};
      return launch_dkv_hopper<D>(flash_bwd_dkv_hopper<D>, configured, a, stream);
    } else {
      constexpr int bytes = bf16_smem_bytes<D>();
      err = cudaFuncSetAttribute(flash_bwd_dkv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
      const dim3 grid((a.Skv + BLOCK - 1) / BLOCK, a.H, a.B);
      flash_bwd_dkv_bf16<D><<<grid, WARPS * 32, bytes, stream>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
          static_cast<const bf16*>(a.dout), a.mask, a.lse, a.di, static_cast<bf16*>(a.dk),
          static_cast<bf16*>(a.dv), a.Sq, a.Skv, a.H, a.ws_rs, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss,
          a.do_sb, a.do_ss, a.sm_scale);
      return cudaGetLastError();
    }
  }
  cudaError_t err = launch_prep<float, D>(a, stream);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_tf32x3<D>;
  static bool configured[MAX_DEVICES] = {};
  int device = 0;
  err = current_device(device);
  if (err == cudaSuccess) err = allow_smem(kernel, configured, device);
  if (err != cudaSuccess) return err;
  static_assert(dkv_f32_smem_bytes<D>() <= SMEM_LIMIT, "the fp32 K4's tiles exceed shared memory");
  constexpr int KEYS = 16 * dkv_f32_warps<D>();
  const dim3 grid((a.Skv + KEYS - 1) / KEYS, a.H, a.B);
  kernel<<<grid, 2 * KEYS, dkv_f32_smem_bytes<D>(), stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.dout), a.mask, a.ws, a.di, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.Sq, a.Skv, a.H, a.ws_rs, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 1) {
    if constexpr (D >= 64) {
      static bool configured[MAX_DEVICES] = {};
      return launch_dq_hopper<D>(flash_bwd_dq_hopper<D>, configured, a, stream);
    } else {
      constexpr int bytes = bf16_smem_bytes<D>();
      cudaError_t err =
          cudaFuncSetAttribute(flash_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
      const dim3 grid((a.Sq + BLOCK - 1) / BLOCK, a.H, a.B);
      flash_bwd_dq_bf16<D><<<grid, WARPS * 32, bytes, stream>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
          static_cast<const bf16*>(a.dout), a.mask, a.lse, a.di, static_cast<bf16*>(a.dq), a.Sq, a.Skv, a.H,
          a.ws_rs, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale);
      return cudaGetLastError();
    }
  }
  auto kernel = flash_bwd_dq_tf32x3<D>;
  static bool configured[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = current_device(device);
  if (err == cudaSuccess) err = allow_smem(kernel, configured, device);
  if (err != cudaSuccess) return err;
  static_assert(dq_f32_bytes<D>() <= SMEM_LIMIT, "the fp32 K5's tiles exceed shared memory");
  constexpr int ROWS = 16 * dq_f32_warps<D>();
  const dim3 grid((a.Sq + ROWS - 1) / ROWS, a.H, a.B);
  kernel<<<grid, 2 * ROWS, dq_f32_bytes<D>(), stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.dout), a.mask, a.lse, a.di, static_cast<float*>(a.dq), a.Sq, a.Skv, a.H, a.ws_rs,
      a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale);
  return cudaGetLastError();
}

enum Which { DKV, DQ };

template <int D>
cudaError_t launch(Which which, int dtype, const Args& a, cudaStream_t stream) {
  return which == DKV ? launch_dkv<D>(dtype, a, stream) : launch_dq<D>(dtype, a, stream);
}

int dispatch(Which which, int D, int dtype, const Args& a, void* stream) {
  if (a.Sq < 1 || a.Skv < 1 || (dtype != 0 && dtype != 1) || a.ws_rs < a.Sq) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return static_cast<int>(launch<16>(which, dtype, a, s));
    case 32: return static_cast<int>(launch<32>(which, dtype, a, s));
    case 64: return static_cast<int>(launch<64>(which, dtype, a, s));
    case 128: return static_cast<int>(launch<128>(which, dtype, a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q/o/do: [B, Sq, H, D], k/v: [B, Skv, H, D], each with unit stride over D,
// stride D over heads and the given batch/row strides (in elements; 16-byte
// aligned rows); any Sq, Skv >= 1; D in {16, 32, 64, 128}; dtype 0 = fp32,
// 1 = bf16; mask: int32 [B, Skv] (nonzero = attend) or null; lse: contiguous
// fp32 [B, H, Sq] from K3. flash_attn_bwd_dkv writes lse * log2(e) and di =
// rowsum(o * do) to the fp32 workspace ws = [2][B, H, ws_rs] (ws_rs >= Sq, a
// multiple of 64: rows padded with +inf and 0), then dk and dv;
// flash_attn_bwd_dq reads di (rows (b, h) at (b * H + h) * di_rs) and writes
// dq. dq/dk/dv: contiguous, in the input dtype. Launches on `stream` of the
// current device.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                  const void* mask, const void* lse, void* ws, void* dk, void* dv, int B, int Sq,
                                  int Skv, int H, int D, int ws_rs, long long q_sb, long long q_ss, long long k_sb,
                                  long long k_ss, long long v_sb, long long v_ss, long long o_sb, long long o_ss,
                                  long long do_sb, long long do_ss, float sm_scale, int dtype, void* stream) {
  if (ws_rs % WS_ALIGN != 0) return static_cast<int>(cudaErrorInvalidValue);
  float* w = static_cast<float*>(ws);
  const Args a{q, k, v, o, dout, static_cast<const int*>(mask), static_cast<const float*>(lse),
               w, w + (long long)B * H * ws_rs, nullptr, dk, dv, B, Sq, Skv, H, ws_rs,
               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, do_sb, do_ss, sm_scale};
  return dispatch(DKV, D, dtype, a, stream);
}

extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* mask,
                                 const void* lse, const void* di, void* dq, int B, int Sq, int Skv, int H, int D,
                                 int di_rs, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                                 long long v_sb, long long v_ss, long long do_sb, long long do_ss, float sm_scale,
                                 int dtype, void* stream) {
  const Args a{q, k, v, nullptr, dout, static_cast<const int*>(mask), static_cast<const float*>(lse),
               nullptr, static_cast<const float*>(di), dq, nullptr, nullptr, B, Sq, Skv, H, di_rs,
               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, 0, 0, do_sb, do_ss, sm_scale};
  return dispatch(DQ, D, dtype, a, stream);
}

// the tiles of the fp32 kernels at head dim D, by the rules their launches
// follow: the queries of the dk/dv kernel's ring slot (what = 0) and the keys
// of the dq kernel's (what = 1); 0 for another D. The emulations in
// ops/flash_attention.py (f32_dkv_queries, f32_dq_keys) mirror them.
extern "C" int flash_attn_bwd_f32_tiles(int D, int what) {
#define F32_TILES(DD) \
  if (D == DD) return what == 0 ? dkv_f32_queries<DD>() : dq_f32_keys<DD>();
  F32_TILES(16) F32_TILES(32) F32_TILES(64) F32_TILES(128)
#undef F32_TILES
  return 0;
}

extern "C" const char* dl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
