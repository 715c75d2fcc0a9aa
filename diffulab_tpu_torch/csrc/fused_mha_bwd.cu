// Fused multi-head attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel diffulab_tpu/ops/fused_mha.py::_mha_bwd_kernel
// (K2). From the forward's residuals q, k, v, the key mask and lse (o is not
// saved), per (batch, head):
//   s  = q.k^T * scale in fp32, masked keys at the finite MASK_VALUE;
//   p  = exp(s - lse) in fp32 (a row with lse = +inf gives p = 0, so zero grads);
//   dv = round(p)^T . do          (p rounded to the input dtype first);
//   dp = do . v^T                  in fp32;
//   di = rowsum(p * dp)            from the fp32 p and dp over the WHOLE key row;
//   ds = p * (dp - di) * scale;
//   dq = round(ds) . k, dk = round(ds)^T . q   (ds rounded to the input dtype);
// fp32 accumulation, dq/dk/dv written in the input dtype.
//
// Bound on an H100 SXM (data-sheet peaks at 700 W): at the DiT-B/2 training
// shape (B=64, S=256, H=12, D=64, bf16) it must read q, k, v, do (4 x 25.2 MB)
// and lse and write dq, dk, dv: 176.9 MB, 52.8 us at 3.35 TB/s, against
// 10*B*H*S^2*D = 32.2 GFLOP, 32.6 us at 989 TFLOP/s. Memory-bound, so the
// scores stay on the SM and q/k/v/do are read in the [B, S, H*D] layout the
// qkv projection writes (a head is a D-wide column slice at a caller-given
// row stride: no transpose pass).
//
// The TPU kernel ran one program per batch element with the whole K/V in
// VMEM and summed dq over keys and dk/dv over queries in one pass. On Hopper
// the work spreads over CTAs, and one of the two sums would cross them. The
// design keeps every sum inside a CTA, without atomics, so results do not
// depend on the run: two kernels, launched back to back by one call.
//
// bf16 at D = 64 and 128: the flash backward's Hopper kernels (K4, K5), whose
// bodies attn_bwd_hopper.cuh shares, under names of their own:
//  1. mha_bwd_dq_hopper, one CTA per (128 queries, head, batch), two
//     warpgroups of 64 queries: K5's kernel with a first pass over the key
//     tiles that sums p * dp into di for the CTA's rows (the same wgmma S =
//     Q.K^T and dP = dO.V^T, p from the fp32 accumulators), then K5's pass
//     for dq with that di. K and V come through a TMA ring; at up to four
//     key tiles (DiT-B/2's 256 keys) they land once and stay for both passes.
//     The CTA writes lse * log2 e and di into the fp32 workspace [2][B * H][Sq].
//  2. mha_bwd_dkv_hopper, one CTA per (128 keys, head, batch): K4's kernel,
//     which walks TMA-fed query tiles with that workspace's lse and di.
// bf16 at D = 16 and 32, the first kernels: mma.sync m16n8k16, one CTA per 64
// rows, 4 warps of 16 rows with q and do (or k and v) in A fragments; the dq
// kernel makes two passes over 64-key tiles staged in shared memory (di, then
// dq) and the dk/dv kernel walks 64-query tiles with that di; scores 32
// columns at a time, p and ds from the C fragments into A fragments, B
// operands along the staged rows by ldmatrix.trans.
//
// fp32 (the fp32 instance of the TPU kernel, diffulab_tpu/ops/fused_mha.py:87;
// slice C1 trains through it at B=128, S=256, H=8, D=64): 42.9 GFLOP on 471 MB, 0.64 ms at the CUDA cores' 67
// TFLOP/s against 0.14 ms of bytes, so it is bound by operations, and a
// product formed again costs time directly. The products run on the tensor
// cores as 3xTF32 (tf32x3.cuh: each operand split into two TF32 halves, three
// mma.sync products, about 2^-21 relative each): 3 x 42.9 GFLOP at 495
// TFLOP/s is 0.26 ms. The same split as the bf16 kernels, no atomics:
//  1. The dq kernel, one CTA per (64 queries, head, batch). Pass 1 forms s,
//     p and dp tile by tile and di = rowsum(p * dp) over the whole key row;
//     pass 2 forms ds and dq = ds.K. Where the CTA's fp32 p and dp fit in
//     shared memory (64 x Skv x 8 bytes: up to 256 keys at D = 64; D <= 64),
//     mha_bwd_dq_kept_tf32x3<D> leaves them there in pass 1 and streams K
//     alone in pass 2: 3 products of [64 x Skv x D], not 5. They take 128 KB
//     at 256 keys, so one CTA fills an SM: it runs eight warps, two for each
//     16 rows, each taking half of every 64-key tile, with q's and dO's split
//     fragments in registers; the two halves' di and dq are added in a fixed
//     order. Elsewhere mha_bwd_dq_tf32x3<D>, four warps of 16 rows, forms s
//     and dp again (5 products). The CTA writes lse and di to the workspace.
//  2. mha_bwd_dkv_tf32x3<D>, one CTA per (64 keys, head, batch), four warps
//     of 16 keys: p^T, dv, dp^T, ds^T and dk over query tiles that a
//     two-slot cp.async ring brings with their lse and di: 4 products.
// So 7 products of [Sq x Skv x D] where the bound counts 5 (9 where p and dp
// do not fit). p and ds stay fp32: the input dtype's rounding is none. At the
// D1 UNet's head dims 192 and 384 (64 or 16 tokens, padded to 128 keys),
// mha_bwd_{dq,dkv}_tf32x3_valid<D> are built around the valid rows: the dq
// CTAs cover the unpadded query rows alone and skip every key tile whose mask
// is all 0, a dk/dv CTA whose keys are all masked writes zeros, and the dk/dv
// query loop walks the valid query rows; column groups of vr_cols columns. At
// the MNIST UNet's 256 and 512, mha_bwd_fused_tf32x3_staged<D>: one kernel a
// (batch, head) that forms s and dp once over the live keys, D staged in
// chunks, no workspace.
// In bf16 at those dims, mha_bwd_{dq,dkv}_bf16_valid<D>: the same split on
// mma.sync m16n8k16 over tiles of 16 keys or queries (bf16_valid.cuh). At D =
// 64 both dtypes' valid-rows kernels take the padded short sequences (the
// unpadded rows of 64, 72 or 264 tokens); the caller picks them by shape
// (valid_rows = 1), and the padded instances keep the rest.
//
// Plain C interface (bound with ctypes): fused_mha_bwd launches both kernels
// on the given stream and returns the first CUDA error.

#include <math.h>
#include <stdint.h>

#include "attn_bwd_hopper.cuh"  // K4/K5's Hopper kernels; hopper.cuh: MASK_VALUE, bf16, pack_bf16, quad_sum
#include "tf32x3.cuh"            // the fp32 kernels' 3xTF32 mma.sync fragments
#include "bf16_valid.cuh"        // mma_bf16, ldsm_x4_trans; the bf16 kernels' fragments at D = 192-512

namespace {

constexpr int BLOCK = 64;     // rows per CTA, and rows per staged tile (bf16 at D = 16, 32)
constexpr int WARPS = 4;      // bf16 kernels at D = 16, 32: 16 rows per warp
constexpr int CHUNK = 32;     // score columns held in registers at a time
constexpr int PAD = 8;        // bf16 elements of padding per shared-memory row

template <int D>
using Tile = bf16 (*)[D + PAD];

// rows [r0, r0 + BLOCK) of one head (D columns) into shared memory, 16 bytes a thread
template <int D>
__device__ __forceinline__ void stage_tile(Tile<D> dst, const bf16* src, long long row_stride, int r0) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < BLOCK * CHUNKS; i += WARPS * 32) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    *reinterpret_cast<int4*>(&dst[r][c]) =
        *reinterpret_cast<const int4*>(src + (long long)(r0 + r) * row_stride + c);
  }
}

// A fragments (16 rows x D) of rows row, row + 8 read from global memory
template <int D>
__device__ __forceinline__ void load_a(uint32_t f[D / 16][4], const bf16* base, long long stride, int row, int t4) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* r0 = base + (long long)row * stride + kk * 16 + 2 * t4;
    const bf16* r1 = r0 + 8 * stride;
    f[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
    f[kk][1] = *reinterpret_cast<const uint32_t*>(r1);
    f[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    f[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
  }
}

// c[nt][j] = sum_d A[row][d] * T[c0 + col][d] for the warp's 16 rows against
// tile rows c0 + [0, CHUNK). C layout: j = 0,1 -> row g, col nt*8 + 2*t4 + j;
// j = 2,3 -> row g + 8.
template <int D>
__device__ __forceinline__ void rows_dot_tile(float c[CHUNK / 8][4], const uint32_t af[D / 16][4],
                                              Tile<D> ts, int c0, int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < CHUNK / 8; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[2];
      b[0] = *reinterpret_cast<const uint32_t*>(&ts[c0 + nt * 8 + g][kk * 16 + 2 * t4]);
      b[1] = *reinterpret_cast<const uint32_t*>(&ts[c0 + nt * 8 + g][kk * 16 + 2 * t4 + 8]);
      mma_bf16(c[nt], af[kk], b);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long row_stride, int row,
                                           const float acc[D / 8][4], int t4) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(out + (long long)row * row_stride + col) = pack_bf16(acc[dn][0], acc[dn][1]);
    *reinterpret_cast<uint32_t*>(out + (long long)(row + 8) * row_stride + col) = pack_bf16(acc[dn][2], acc[dn][3]);
  }
}

// --- bf16 at D = 16 and 32 -----------------------------------------------------

// s -> p = exp(s * scale - lse) for query rows (g, g + 8) against keys key0 + col
__device__ __forceinline__ void probs_rows(float s[CHUNK / 8][4], float sm_scale, const int* mask,
                                           int key0, const float lse_r[2], int t4) {
#pragma unroll
  for (int nt = 0; nt < CHUNK / 8; ++nt) {
    const int key = key0 + nt * 8 + 2 * t4;
    const bool keep0 = mask == nullptr || mask[key] != 0;
    const bool keep1 = mask == nullptr || mask[key + 1] != 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = ((j & 1) ? keep1 : keep0) ? s[nt][j] * sm_scale : MASK_VALUE;
      s[nt][j] = expf(x - lse_r[j >> 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
mha_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                const bf16* __restrict__ dout, const int* __restrict__ mask,
                const float* __restrict__ lse, float* __restrict__ di_out, bf16* __restrict__ dq,
                int Sq, int Skv, int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                long long v_sb, long long v_ss, long long do_sb, long long do_ss, float sm_scale) {
  __shared__ __align__(16) bf16 ks[BLOCK][D + PAD];
  __shared__ __align__(16) bf16 vs[BLOCK][D + PAD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * BLOCK + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const bf16* kb = k + b * k_sb + h * D;
  const bf16* vb = v + b * v_sb + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;

  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a<D>(qf, q + b * q_sb + h * D, q_ss, row0, t4);
  load_a<D>(df, dout + b * do_sb + h * D, do_ss, row0, t4);
  const float lse_r[2] = {lse[((long long)b * Sq + row0) * H + h], lse[((long long)b * Sq + row0 + 8) * H + h]};

  // pass 1: di = rowsum(p * dp) over every key
  float di[2] = {0.f, 0.f};
  for (int n0 = 0; n0 < Skv; n0 += BLOCK) {
    __syncthreads();
    stage_tile<D>(ks, kb, k_ss, n0);
    stage_tile<D>(vs, vb, v_ss, n0);
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < BLOCK; c0 += CHUNK) {
      float p[CHUNK / 8][4], dp[CHUNK / 8][4];
      rows_dot_tile<D>(p, qf, ks, c0, g, t4);
      probs_rows(p, sm_scale, mb, n0 + c0, lse_r, t4);
      rows_dot_tile<D>(dp, df, vs, c0, g, t4);
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) di[j >> 1] += p[nt][j] * dp[nt][j];
    }
  }
  di[0] = quad_sum(di[0]);
  di[1] = quad_sum(di[1]);

  // pass 2: ds = p * (dp - di) * scale, rounded to bf16; dq += ds . K
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int n0 = 0; n0 < Skv; n0 += BLOCK) {
    __syncthreads();
    stage_tile<D>(ks, kb, k_ss, n0);
    stage_tile<D>(vs, vb, v_ss, n0);
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < BLOCK; c0 += CHUNK) {
      float p[CHUNK / 8][4], dp[CHUNK / 8][4];
      rows_dot_tile<D>(p, qf, ks, c0, g, t4);
      probs_rows(p, sm_scale, mb, n0 + c0, lse_r, t4);
      rows_dot_tile<D>(dp, df, vs, c0, g, t4);
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[nt][j] = p[nt][j] * (dp[nt][j] - di[j >> 1]) * sm_scale;
      scores_times_tile_bf16<D, CHUNK, D + PAD>(acc, dp, &ks[c0][0], lane);
    }
  }

  // dq [B, Sq, H, D] contiguous; di [B, Sq, H]
  const long long o_ss = (long long)H * D;
  store_rows<D>(dq + (long long)b * Sq * o_ss + h * D, o_ss, row0, acc, t4);
  if (t4 == 0) {
    di_out[((long long)b * Sq + row0) * H + h] = di[0];
    di_out[((long long)b * Sq + row0 + 8) * H + h] = di[1];
  }
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
mha_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const bf16* __restrict__ dout, const int* __restrict__ mask,
                 const float* __restrict__ lse, const float* __restrict__ di, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int Sq, int Skv, int H, long long q_sb, long long q_ss,
                 long long k_sb, long long k_ss, long long v_sb, long long v_ss, long long do_sb,
                 long long do_ss, float sm_scale) {
  __shared__ __align__(16) bf16 qs[BLOCK][D + PAD];
  __shared__ __align__(16) bf16 dos[BLOCK][D + PAD];
  __shared__ float lse_s[BLOCK];
  __shared__ float di_s[BLOCK];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * BLOCK + warp * 16 + g;  // this thread's keys: row0, row0 + 8

  const bf16* qb = q + b * q_sb + h * D;
  const bf16* dob = dout + b * do_sb + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  const bool keep[2] = {mb == nullptr || mb[row0] != 0, mb == nullptr || mb[row0 + 8] != 0};

  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, k + b * k_sb + h * D, k_ss, row0, t4);
  load_a<D>(vf, v + b * v_sb + h * D, v_ss, row0, t4);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    dk_acc[dn][0] = dk_acc[dn][1] = dk_acc[dn][2] = dk_acc[dn][3] = 0.f;
    dv_acc[dn][0] = dv_acc[dn][1] = dv_acc[dn][2] = dv_acc[dn][3] = 0.f;
  }

  for (int m0 = 0; m0 < Sq; m0 += BLOCK) {
    __syncthreads();
    stage_tile<D>(qs, qb, q_ss, m0);
    stage_tile<D>(dos, dob, do_ss, m0);
    for (int i = threadIdx.x; i < BLOCK; i += WARPS * 32) {
      lse_s[i] = lse[((long long)b * Sq + m0 + i) * H + h];
      di_s[i] = di[((long long)b * Sq + m0 + i) * H + h];
    }
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < BLOCK; c0 += CHUNK) {
      // p^T [key, query] = exp(k.q^T * scale - lse[query]), masked by key
      float p[CHUNK / 8][4], dp[CHUNK / 8][4];
      rows_dot_tile<D>(p, kf, qs, c0, g, t4);
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = keep[j >> 1] ? p[nt][j] * sm_scale : MASK_VALUE;
          p[nt][j] = expf(x - lse_s[c0 + nt * 8 + 2 * t4 + (j & 1)]);
        }
      scores_times_tile_bf16<D, CHUNK, D + PAD>(dv_acc, p, &dos[c0][0], lane);  // dv += round(p)^T . do
      rows_dot_tile<D>(dp, vf, dos, c0, g, t4);       // dp^T = v . do^T
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dp[nt][j] = p[nt][j] * (dp[nt][j] - di_s[c0 + nt * 8 + 2 * t4 + (j & 1)]) * sm_scale;
      scores_times_tile_bf16<D, CHUNK, D + PAD>(dk_acc, dp, &qs[c0][0], lane);  // dk += round(ds)^T . q
    }
  }

  // dk, dv [B, Skv, H, D] contiguous
  const long long o_ss = (long long)H * D;
  store_rows<D>(dk + (long long)b * Skv * o_ss + h * D, o_ss, row0, dk_acc, t4);
  store_rows<D>(dv + (long long)b * Skv * o_ss + h * D, o_ss, row0, dv_acc, t4);
}

// --- fp32: 3xTF32 products on the tensor cores (tf32x3.cuh) ----------------------

constexpr int KEPT_THREADS = 2 * F32_THREADS;  // the kept dq kernel: eight warps, two for each 16 rows
constexpr int KEPT_STEP = 64;                  // keys of its ring slot, 32 for each of the two warps

// keys of a ring slot of the dq kernel that forms p and dp again: 64, and 32
// at D = 128, where dq takes 64 registers a thread
template <int D>
__host__ __device__ constexpr int dq_keys() {
  return D <= 64 ? 64 : 32;
}

// queries of a ring slot of the dk/dv kernel: 64, and 32 at D = 128
template <int D>
__host__ __device__ constexpr int dkv_queries() {
  return D <= 64 ? 64 : 32;
}

// shared memory of the dq kernel that forms p and dp again: the CTA's q and
// dO rows and two ring slots of K and V
template <int D>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ld<D>() * (2 * F32_ROWS + 2 * 2 * dq_keys<D>());
}

// shared memory of the kept dq kernel: two ring slots of K and V, the two
// halves' di, and the CTA's fp32 p and dp over the whole key row
template <int D>
__host__ __device__ constexpr size_t dq_kept_smem_bytes(int Skv) {
  return sizeof(float) * (ld<D>() * 2 * 2 * KEPT_STEP + 2 * F32_ROWS + (size_t)2 * F32_ROWS * Skv);
}

// whether the fp32 dq kernel keeps p and dp between its passes: where they
// fit in shared memory, and q's and dO's split fragments in registers (D <= 64)
template <int D>
constexpr bool f32_keeps(int Skv) {
  return D <= 64 && dq_kept_smem_bytes<D>(Skv) <= SMEM_LIMIT;
}

// shared memory of the dk/dv kernel: the CTA's K and V rows, two ring slots of Q and dO, and their lse and di
template <int D>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (ld<D>() * (2 * F32_ROWS + 2 * 2 * dkv_queries<D>()) + 2 * 2 * dkv_queries<D>());
}

// s -> p = exp(s * scale - lse) for query rows (g, g + 8) against keys key0 +
// [0, N); FAST: __expf (the bf16 instances at D = 64, bf16_exp)
template <int N, bool FAST = false>
__device__ __forceinline__ void probs_f32(float (&s)[N / 8][4], float sm_scale, const int* mrow, int key0,
                                          const float (&lse_r)[2], int t4) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    const int2 keep = mrow == nullptr ? make_int2(1, 1)
                                      : *reinterpret_cast<const int2*>(mrow + key0 + nt * 8 + 2 * t4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = ((j & 1) ? keep.y : keep.x) ? s[nt][j] * sm_scale : MASK_VALUE;
      s[nt][j] = FAST ? __expf(x - lse_r[j >> 1]) : expf(x - lse_r[j >> 1]);
    }
  }
}

// dq for 64 queries of a (batch, head) where their fp32 p and dp fit in
// shared memory (f32_keeps): eight warps, two for each 16 rows, each of the
// two taking 32 keys of a 64-key step, q's and dO's split fragments in
// registers. Pass 1 forms s, p = exp(s - lse) and dp = dO.V^T, sums di =
// rowsum(p * dp) and leaves each thread's p and dp in shared memory; the
// two warps' di are added in a fixed order. Pass 2 streams K alone: ds = p *
// (dp - di) * scale, dq = ds.K, the two warps' partial dq added in a fixed
// order. 3 products of [64 x Skv x D]. The CTA writes lse
// and di, rows (b, h) Sq apart, for the dk/dv kernel.
template <int D>
__global__ void __launch_bounds__(KEPT_THREADS, 1)
mha_bwd_dq_kept_tf32x3(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                       const float* __restrict__ dout, const int* __restrict__ mask, const float* __restrict__ lse,
                       float* __restrict__ ws_lse, float* __restrict__ ws_di, float* __restrict__ dq, int Sq,
                       int Skv, int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                       long long v_sb, long long v_ss, long long do_sb, long long do_ss, float sm_scale) {
  constexpr int LD = ld<D>(), KH = KEPT_STEP / 2;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                        // [2][64][LD]
  float* vs = ks + 2 * KEPT_STEP * LD;     // [2][64][LD]
  float* di_s = vs + 2 * KEPT_STEP * LD;   // [2][64]: each half's di
  float4* kept_p = reinterpret_cast<float4*>(di_s + 2 * F32_ROWS);  // [Skv / 16][256], then dp
  float4* kept_dp = kept_p + (Skv / 16) * KEPT_THREADS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int half = warp >> 2, r0 = 16 * (warp & 3);  // this warp's keys of a step, and rows
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * F32_ROWS;
  const int row = m0 + r0 + g;  // this thread's rows: row, row + 8
  const float* kb = k + b * k_sb + h * D;
  const float* vb = v + b * v_sb + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  const int n_steps = Skv / KEPT_STEP;
  const float lse_r[2] = {lse[((long long)b * Sq + row) * H + h], lse[((long long)b * Sq + row + 8) * H + h]};

  // loads 0 .. n_steps - 1: K and V for pass 1; n_steps .. 2 n_steps - 1: K for pass 2
  auto stage = [&](int j) {
    const int step = j < n_steps ? j : j - n_steps;
    stage_rows<D, KEPT_STEP, KEPT_THREADS>(ks + (j & 1) * KEPT_STEP * LD, kb, k_ss, step * KEPT_STEP);
    if (j < n_steps) stage_rows<D, KEPT_STEP, KEPT_THREADS>(vs + (j & 1) * KEPT_STEP * LD, vb, v_ss, step * KEPT_STEP);
  };
  auto advance = [&](int j) {  // the next load in flight, then load j landed
    if (j + 1 < 2 * n_steps) {
      stage(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  };
  stage(0);
  cp_async_commit();
  uint32_t qh[D / 8][4], ql[D / 8][4], dh[D / 8][4], dl[D / 8][4];
  frags_a_global<D>(qh, ql, q + b * q_sb + h * D, q_ss, row, t4);
  frags_a_global<D>(dh, dl, dout + b * do_sb + h * D, do_ss, row, t4);

  // pass 1: p, dp kept; di = rowsum(p * dp)
  float di[2] = {0.f, 0.f};
  for (int j = 0; j < n_steps; ++j) {
    advance(j);
    const int off = ((j & 1) * KEPT_STEP + half * KH) * LD;
    float p[KH / 8][4], dp[KH / 8][4];
    rows_dot<D, KH>(p, qh, ql, ks + off, g, t4);
    probs_f32<KH>(p, sm_scale, mb, j * KEPT_STEP + half * KH, lse_r, t4);
    rows_dot<D, KH>(dp, dh, dl, vs + off, g, t4);
#pragma unroll
    for (int nt = 0; nt < KH / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) di[e >> 1] += p[nt][e] * dp[nt][e];
      const int at = (j * (KH / 8) + nt) * KEPT_THREADS + threadIdx.x;
      kept_p[at] = make_float4(p[nt][0], p[nt][1], p[nt][2], p[nt][3]);
      kept_dp[at] = make_float4(dp[nt][0], dp[nt][1], dp[nt][2], dp[nt][3]);
    }
    __syncthreads();  // the slot is refilled next
  }
  di[0] = quad_sum(di[0]);
  di[1] = quad_sum(di[1]);
  if (t4 == 0) {
    di_s[half * F32_ROWS + r0 + g] = di[0];
    di_s[half * F32_ROWS + r0 + g + 8] = di[1];
  }
  __syncthreads();
  di[0] = di_s[r0 + g] + di_s[F32_ROWS + r0 + g];
  di[1] = di_s[r0 + g + 8] + di_s[F32_ROWS + r0 + g + 8];

  // pass 2: ds = p * (dp - di) * scale; dq += ds.K
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int j = n_steps; j < 2 * n_steps; ++j) {
    advance(j);
    float ds[KH / 8][4];
#pragma unroll
    for (int nt = 0; nt < KH / 8; ++nt) {
      const int at = ((j - n_steps) * (KH / 8) + nt) * KEPT_THREADS + threadIdx.x;
      const float4 pp = kept_p[at], dd = kept_dp[at];
      ds[nt][0] = pp.x * (dd.x - di[0]) * sm_scale;
      ds[nt][1] = pp.y * (dd.y - di[0]) * sm_scale;
      ds[nt][2] = pp.z * (dd.z - di[1]) * sm_scale;
      ds[nt][3] = pp.w * (dd.w - di[1]) * sm_scale;
    }
    scores_times_tile<D, KH>(acc, ds, ks + ((j & 1) * KEPT_STEP + half * KH) * LD, g, t4);
    __syncthreads();
  }

  // dq = half 0's sum + half 1's, through the ring's shared memory
  float* part = smem;  // [D / 2][128]
  if (half == 1) {
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[(dn * 4 + e) * F32_THREADS + threadIdx.x - F32_THREADS] = acc[dn][e];
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] += part[(dn * 4 + e) * F32_THREADS + threadIdx.x];
  const long long o_ss = (long long)H * D;
  store_c_rows<D>(dq + (long long)b * Sq * o_ss + h * D, o_ss, row, acc, t4);
  if (t4 == 0) {
    const long long w = ((long long)b * H + h) * Sq + row;
    ws_lse[w] = lse_r[0];
    ws_lse[w + 8] = lse_r[1];
    ws_di[w] = di[0];
    ws_di[w + 8] = di[1];
  }
}

// dq for 64 queries of a (batch, head) where p and dp do not fit: four warps
// of 16 rows, K and V through a two-slot cp.async ring. Pass 1 forms s, p and
// dp tile by tile and di = rowsum(p * dp) over the whole key row; pass 2
// forms s and dp again, ds and dq = ds.K: 5 products of [64 x Skv x D]. The
// CTA writes lse and di for the dk/dv kernel.
template <int D>
__global__ void __launch_bounds__(F32_THREADS)
mha_bwd_dq_tf32x3(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ dout, const int* __restrict__ mask, const float* __restrict__ lse,
                  float* __restrict__ ws_lse, float* __restrict__ ws_di, float* __restrict__ dq, int Sq, int Skv,
                  int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                  long long v_ss, long long do_sb, long long do_ss, float sm_scale) {
  constexpr int KT = dq_keys<D>(), LD = ld<D>();
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [64][LD]
  float* dos = qs + F32_ROWS * LD;   // [64][LD]
  float* ks = dos + F32_ROWS * LD;   // [2][KT][LD]
  float* vs = ks + 2 * KT * LD;      // [2][KT][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * F32_ROWS, r0 = 16 * warp;
  const int row = m0 + r0 + g;  // this thread's rows: row, row + 8
  const float* kb = k + b * k_sb + h * D;
  const float* vb = v + b * v_sb + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  const int n_tiles = Skv / KT;
  const float lse_r[2] = {lse[((long long)b * Sq + row) * H + h], lse[((long long)b * Sq + row + 8) * H + h]};

  auto stage = [&](int j) {  // loads 0 .. n_tiles - 1 feed pass 1, the next n_tiles pass 2
    const int tile = j < n_tiles ? j : j - n_tiles;
    stage_rows<D, KT>(ks + (j & 1) * KT * LD, kb, k_ss, tile * KT);
    stage_rows<D, KT>(vs + (j & 1) * KT * LD, vb, v_ss, tile * KT);
  };
  auto advance = [&](int j) {  // the next load in flight, then load j landed
    if (j + 1 < 2 * n_tiles) {
      stage(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  };
  // p and dp of key tile `tile` (in slot `slot`) for the warp's rows
  auto scores = [&](float (&p)[KT / 8][4], float (&dp)[KT / 8][4], int slot, int tile) {
    rows_dot<D, KT>(p, qs, r0, ks + slot * KT * LD, g, t4);
    rows_dot<D, KT>(dp, dos, r0, vs + slot * KT * LD, g, t4);
    probs_f32<KT>(p, sm_scale, mb, tile * KT, lse_r, t4);
  };

  stage_rows<D, F32_ROWS>(qs, q + b * q_sb + h * D, q_ss, m0);
  stage_rows<D, F32_ROWS>(dos, dout + b * do_sb + h * D, do_ss, m0);
  stage(0);
  cp_async_commit();

  // pass 1: di = rowsum(p * dp) over every key
  float di[2] = {0.f, 0.f};
  for (int j = 0; j < n_tiles; ++j) {
    advance(j);
    float p[KT / 8][4], dp[KT / 8][4];
    scores(p, dp, j & 1, j);
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) di[e >> 1] += p[nt][e] * dp[nt][e];
    __syncthreads();  // the slot is refilled next
  }
  di[0] = quad_sum(di[0]);
  di[1] = quad_sum(di[1]);

  // pass 2: s and dp again; ds = p * (dp - di) * scale; dq += ds.K
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int j = n_tiles; j < 2 * n_tiles; ++j) {
    advance(j);
    float p[KT / 8][4], dp[KT / 8][4];
    scores(p, dp, j & 1, j - n_tiles);
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = p[nt][e] * (dp[nt][e] - di[e >> 1]) * sm_scale;
    scores_times_tile<D, KT>(acc, p, ks + (j & 1) * KT * LD, g, t4);
    __syncthreads();
  }

  // dq [B, Sq, H, D] contiguous; lse and di [B * H][Sq]
  const long long o_ss = (long long)H * D;
  store_c_rows<D>(dq + (long long)b * Sq * o_ss + h * D, o_ss, row, acc, t4);
  if (t4 == 0) {
    const long long w = ((long long)b * H + h) * Sq + row;
    ws_lse[w] = lse_r[0];
    ws_lse[w + 8] = lse_r[1];
    ws_di[w] = di[0];
    ws_di[w + 8] = di[1];
  }
}

// dk and dv for 64 keys of a (batch, head): four warps of 16 keys walk the
// query tiles (Q, dO, and their lse and di through a two-slot cp.async ring):
// p^T = exp(K.Q^T * scale - lse), dv += p^T.dO, dp^T = V.dO^T, ds^T = p^T *
// (dp^T - di) * scale, dk += ds^T.Q. Four products of [64 x Sq x D].
template <int D>
__global__ void __launch_bounds__(F32_THREADS)
mha_bwd_dkv_tf32x3(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ dout, const int* __restrict__ mask, const float* __restrict__ ws_lse,
                   const float* __restrict__ ws_di, float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv,
                   int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                   long long v_ss, long long do_sb, long long do_ss, float sm_scale) {
  constexpr int QT = dkv_queries<D>(), LD = ld<D>();
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                  // [64][LD]
  float* vs = ks + F32_ROWS * LD;    // [64][LD]
  float* qs = vs + F32_ROWS * LD;    // [2][QT][LD]
  float* dos = qs + 2 * QT * LD;     // [2][QT][LD]
  float* lse_s = dos + 2 * QT * LD;  // [2][QT]
  float* di_s = lse_s + 2 * QT;      // [2][QT]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * F32_ROWS, r0 = 16 * warp;
  const int row = n0 + r0 + g;  // this thread's keys: row, row + 8
  const float* qb = q + b * q_sb + h * D;
  const float* dob = dout + b * do_sb + h * D;
  const float* wl = ws_lse + ((long long)b * H + h) * Sq;
  const float* wd = ws_di + ((long long)b * H + h) * Sq;
  const bool keep[2] = {mask == nullptr || mask[(long long)b * Skv + row] != 0,
                        mask == nullptr || mask[(long long)b * Skv + row + 8] != 0};
  const int n_tiles = Sq / QT;

  auto stage = [&](int t) {
    const int slot = t & 1;
    stage_rows<D, QT>(qs + slot * QT * LD, qb, q_ss, t * QT);
    stage_rows<D, QT>(dos + slot * QT * LD, dob, do_ss, t * QT);
    const int i = threadIdx.x;  // QT / 4 chunks of lse, then of di
    if (i < QT / 4)
      cp_async16(lse_s + slot * QT + 4 * i, wl + t * QT + 4 * i);
    else if (i < QT / 2)
      cp_async16(di_s + slot * QT + 4 * (i - QT / 4), wd + t * QT + 4 * (i - QT / 4));
  };

  stage_rows<D, F32_ROWS>(ks, k + b * k_sb + h * D, k_ss, n0);
  stage_rows<D, F32_ROWS>(vs, v + b * v_sb + h * D, v_ss, n0);
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

    // p^T [key, query] = exp(k.q^T * scale - lse[query]), masked by key; dp^T = v.dO^T
    float p[QT / 8][4], dp[QT / 8][4];
    rows_dot<D, QT>(p, ks, r0, qt, g, t4);
    rows_dot<D, QT>(dp, vs, r0, dot, g, t4);
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = keep[e >> 1] ? p[nt][e] * sm_scale : MASK_VALUE;
        p[nt][e] = expf(x - lt[nt * 8 + 2 * t4 + (e & 1)]);
      }
    scores_times_tile<D, QT>(dv_acc, p, dot, g, t4);  // dv += p^T.dO
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = p[nt][e] * (dp[nt][e] - dt[nt * 8 + 2 * t4 + (e & 1)]) * sm_scale;
    scores_times_tile<D, QT>(dk_acc, dp, qt, g, t4);  // dk += ds^T.Q
    __syncthreads();
  }

  // dk, dv [B, Skv, H, D] contiguous
  const long long o_ss = (long long)H * D;
  store_c_rows<D>(dk + (long long)b * Skv * o_ss + h * D, o_ss, row, dk_acc, t4);
  store_c_rows<D>(dv + (long long)b * Skv * o_ss + h * D, o_ss, row, dv_acc, t4);
}

// --- fp32 at D = 64, 192 and 384: built around the valid rows (tf32x3.cuh) ----
//
// The fp32 instance of K2 (diffulab_tpu/ops/fused_mha.py:87) at the D1 UNet's
// head dims: 64 tokens at D = 192, 16 at D = 384, keys padded to 128 (the
// MNIST UNet's 256 and 512 run the staged kernel below, which took these
// kernels' place there). At B=128, H=2 a call must read q, do, k and v and write dq, dk and
// dv over the valid rows and keys (dk and dv: the route's pad drops the
// padded keys' rows), 88.1 / 44.0 MB at D = 192 / 384 (0.026 / 0.013 ms at
// 3.35 TB/s), against 2.01 / 0.25 GFLOP (0.016 ms or less at 3xTF32): bound
// by bytes. Padded to
// 128 query rows and walking every key tile, the instances before this design
// did 2x (64 tokens) and 8x (16) the bytes of q, do and dq and 4x and 64x the
// score work. So the q, dO and lse rows are the unpadded ones (ragged ends
// guarded); a warp for each 16 rows in each column group of vr_cols output
// columns, the groups splitting the score products' reduction over D and
// adding their partial tiles in group order; no atomics.
//
// At D = 64 the same kernels serve the DiTs' padded short sequences (64 or 72
// tokens padded to 128 keys, 264 to 384), where the padded instances ran 128
// query rows, half or more of them padding, over every key tile: at slice
// F1's deep path (B=128, 64 tokens, H=8) a call must move 117 MB over the
// valid rows and keys, 0.035 ms at 3.35 TB/s, against 2.7 GFLOP (0.016 ms at
// 3xTF32): bound by bytes. One group holds the whole head, so no partial
// tile leaves a warp's registers; key (or query) tiles of 64 (vr_tile,
// vr_bf16_tile); and
// in the dk/dv kernel a warp whose 16 keys are all masked (72 tokens: keys
// 80-127 of the second CTA) forms no product and writes zeros.

// dq for vr_rows queries of a (batch, head): K and V stream in tiles of
// vr_tile keys through a ring of VR_SLOTS cp.async slots, and only the tiles
// whose mask has an attended key (the CTA's list of them, find_live_tiles):
// a tile whose mask is all 0 has p = 0 exactly, so it adds
// nothing to di or dq, and is neither loaded nor multiplied. Pass 1 forms s, p
// and dp and di = rowsum(p * dp); pass 2 forms s and dp again, ds and dq =
// ds.K (5 products of [rows x live keys x D]), or, where the live tiles fit
// (vr_dq_keep: a 64-token row at D = 64), takes p and dp from the registers
// pass 1 left them in and K from its slot (3 products). The CTA writes lse
// and di for the dk/dv kernel.
template <int D>
__global__ void __launch_bounds__(vr_threads<D>())
mha_bwd_dq_tf32x3_valid(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ dout, const int* __restrict__ mask, const float* __restrict__ lse,
                        float* __restrict__ ws_lse, float* __restrict__ ws_di, float* __restrict__ dq, int Sq,
                        int Skv, int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                        long long v_sb, long long v_ss, long long do_sb, long long do_ss, float sm_scale) {
  constexpr int KT = vr_tile<D>(), DO = vr_cols<D>(), ROWS = vr_rows<D>(), THREADS = vr_threads<D>(), LD = ld<D>();
  constexpr int ROW_WARPS = ROWS / 16, GROUPS = vr_groups<D>(), PART = GROUPS * ROWS * KT, NS = VR_SLOTS;
  constexpr int KEEP = vr_dq_keep<D>();
  static_assert(KEEP <= NS, "the kept tiles' K stays in the ring's slots");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [ROWS][LD]
  float* dos = qs + ROWS * LD;      // [ROWS][LD]
  float* ks = dos + ROWS * LD;      // [NS][KT][LD]
  float* vs = ks + NS * KT * LD;    // [NS][KT][LD]
  float* part = vs + NS * KT * LD;  // [2][GROUPS][ROWS][KT]: the groups' partial s, then dp (GROUPS > 1)
  int* live = reinterpret_cast<int*>(part + (GROUPS > 1 ? 2 * PART : 0));  // [Skv / KT + 1]: live tiles, count

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * ROWS, r0 = 16 * (warp % ROW_WARPS);
  const int grp = warp / ROW_WARPS, col0 = grp * DO;  // this warp's dq columns: col0 + [0, DO)
  const int row = m0 + r0 + g;                        // this thread's rows: row, row + 8
  const bool active = m0 + r0 < Sq;                   // the warp has a valid row
  const float* kb = k + b * k_sb + h * D;
  const float* vb = v + b * v_sb + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  const int n_tiles = Skv / KT;
  const float lse_r[2] = {row < Sq ? lse[((long long)b * Sq + row) * H + h] : INFINITY,
                          row + 8 < Sq ? lse[((long long)b * Sq + row + 8) * H + h] : INFINITY};

  find_live_tiles<KT>(live, mb, n_tiles);
  __syncthreads();
  const int n_live = live[n_tiles], n_items = 2 * n_live;
  // where the row's live tiles fit (vr_dq_keep), pass 1 keeps p and dp in registers and leaves each tile's K
  // in its slot: pass 2 loads nothing and forms no s or dp
  const bool kept = n_live <= KEEP;
  // the load sequence, item i: the live tiles for pass 1 (i < n_live), then again for pass 2 unless kept; NS -
  // 1 items loading while one is computed
  auto stage = [&](int item) {
    const int pass = item >= n_live;
    if (pass == 1 && kept) return;
    const int tile = live[item - pass * n_live], slot = item % NS;
    stage_rows<D, KT, THREADS>(ks + slot * KT * LD, kb, k_ss, tile * KT);
    stage_rows<D, KT, THREADS>(vs + slot * KT * LD, vb, v_ss, tile * KT);
  };
  if (n_live > 0) {
    stage_rows_upto<D, ROWS, THREADS>(qs, q + b * q_sb + h * D, q_ss, m0, Sq);
    stage_rows_upto<D, ROWS, THREADS>(dos, dout + b * do_sb + h * D, do_ss, m0, Sq);
  }

  for (int item = 0; item < NS - 1; ++item) {  // a group each, empty or not, so that the waits below count right
    if (item < n_items) stage(item);
    cp_async_commit();
  }

  float di[2] = {0.f, 0.f}, acc[DO / 8][4];
  float kept_p[KEEP > 0 ? KEEP : 1][KT / 8][4], kept_dp[KEEP > 0 ? KEEP : 1][KT / 8][4];
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int i = 0; i < n_items; ++i) {
    if (i + NS - 1 < n_items) stage(i + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();  // item i has landed
    __syncthreads();
    // j: the live tile's place in its pass; kept, pass 2 reads pass 1's slot
    const int pass = i >= n_live, j = i - pass * n_live, slot = (kept ? j : i) % NS, cur = live[j];
    const bool formed = pass == 0 || !kept;  // s and dp formed here, else taken from the registers
    float p[KT / 8][4], dp[KT / 8][4];
    if (active && formed) {  // this group's columns of D
      rows_dot<DO, KT, LD>(p, qs + col0, r0, ks + slot * KT * LD + col0, g, t4);
      rows_dot<DO, KT, LD>(dp, dos + col0, r0, vs + slot * KT * LD + col0, g, t4);
    }
    if constexpr (GROUPS > 1) {
      if (active) {
        put_c<KT>(part + grp * ROWS * KT, p, r0, g, t4);
        put_c<KT>(part + PART + grp * ROWS * KT, dp, r0, g, t4);
      }
      __syncthreads();
      if (active) {
        sum_c<KT, GROUPS>(p, part, ROWS * KT, r0, g, t4);
        sum_c<KT, GROUPS>(dp, part + PART, ROWS * KT, r0, g, t4);
      }
    }
    if (active) {
      if (formed) {
        probs_f32<KT>(p, sm_scale, mb, cur * KT, lse_r, t4);
      } else {
#pragma unroll
        for (int jj = 0; jj < KEEP; ++jj)
          if (jj == j)
#pragma unroll
            for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                p[nt][e] = kept_p[jj][nt][e];
                dp[nt][e] = kept_dp[jj][nt][e];
              }
      }
      if (pass == 0) {
#pragma unroll
        for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) di[e >> 1] += p[nt][e] * dp[nt][e];
#pragma unroll
        for (int jj = 0; jj < KEEP; ++jj)
          if (kept && jj == j)
#pragma unroll
            for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                kept_p[jj][nt][e] = p[nt][e];
                kept_dp[jj][nt][e] = dp[nt][e];
              }
      } else {
#pragma unroll
        for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[nt][e] = p[nt][e] * (dp[nt][e] - di[e >> 1]) * sm_scale;
        scores_times_tile<DO, KT, LD>(acc, p, ks + slot * KT * LD + col0, g, t4);
      }
    }
    __syncthreads();  // the slot and the partial tiles are written again
    if (i == n_live - 1) {  // di over the whole key row, before pass 2
      di[0] = quad_sum(di[0]);
      di[1] = quad_sum(di[1]);
    }
  }

  // dq [B, Sq, H, D] contiguous; lse and di [B * H][Sq]
  if (!active) return;
  const long long o_ss = (long long)H * D;
  store_c_rows_upto<DO>(dq + (long long)b * Sq * o_ss + h * D + col0, o_ss, row, acc, t4, Sq);
  if (grp == 0 && t4 == 0) {
    const long long w = ((long long)b * H + h) * Sq + row;
    if (row < Sq) {
      ws_lse[w] = lse_r[0];
      ws_di[w] = di[0];
    }
    if (row + 8 < Sq) {
      ws_lse[w + 8] = lse_r[1];
      ws_di[w + 8] = di[1];
    }
  }
}

// dk and dv for vr_rows keys of a (batch, head). A CTA whose keys are all
// masked writes zeros and forms no product: their p is exactly 0 for every
// query. Otherwise its K and V rows stay in shared memory and the valid query
// rows (Sq, unpadded) stream in tiles of vr_tile queries, with their lse and
// di, through a ring of VR_SLOTS slots; rows past Sq are zero-filled with lse
// = +inf, so that their p is 0. p^T = exp(K.Q^T * scale - lse), dv +=
// p^T.dO, dp^T = V.dO^T, ds^T = p^T * (dp^T - di) * scale, dk += ds^T.Q: 4
// products of [keys x Sq x D].
template <int D>
__global__ void __launch_bounds__(vr_threads<D>())
mha_bwd_dkv_tf32x3_valid(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ dout, const int* __restrict__ mask,
                         const float* __restrict__ ws_lse, const float* __restrict__ ws_di, float* __restrict__ dk,
                         float* __restrict__ dv, int Sq, int Skv, int H, long long q_sb, long long q_ss,
                         long long k_sb, long long k_ss, long long v_sb, long long v_ss, long long do_sb,
                         long long do_ss, float sm_scale) {
  constexpr int QT = vr_tile<D>(), DO = vr_cols<D>(), ROWS = vr_rows<D>(), THREADS = vr_threads<D>(), LD = ld<D>();
  constexpr int ROW_WARPS = ROWS / 16, GROUPS = vr_groups<D>(), PART = GROUPS * ROWS * QT, NS = VR_SLOTS;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                   // [ROWS][LD]
  float* vs = ks + ROWS * LD;         // [ROWS][LD]
  float* qs = vs + ROWS * LD;         // [NS][QT][LD]
  float* dos = qs + NS * QT * LD;     // [NS][QT][LD]
  float* lse_s = dos + NS * QT * LD;  // [NS][QT]
  float* di_s = lse_s + NS * QT;      // [NS][QT]
  float* part = di_s + NS * QT;       // [2][GROUPS][ROWS][QT]: the groups' partial s^T, then dp^T (GROUPS > 1)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * ROWS, r0 = 16 * (warp % ROW_WARPS);
  const int grp = warp / ROW_WARPS, col0 = grp * DO;  // this warp's dk and dv columns: col0 + [0, DO)
  const int row = n0 + r0 + g;                        // this thread's keys: row, row + 8
  const long long o_ss = (long long)H * D;
  float* dkb = dk + (long long)b * Skv * o_ss + h * D;
  float* dvb = dv + (long long)b * Skv * o_ss + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;

  bool live = mb == nullptr;
  for (int t = 0; !live && t < ROWS / 16; ++t) live = tile_live<16>(mb + n0, t);
  if (!live) {  // every key masked: dk = dv = 0
    for (int i = threadIdx.x; i < ROWS * (D / 4); i += THREADS) {
      const long long at = (long long)(n0 + i / (D / 4)) * o_ss + (i % (D / 4)) * 4;
      *reinterpret_cast<float4*>(dkb + at) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dvb + at) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  const float* qb = q + b * q_sb + h * D;
  const float* dob = dout + b * do_sb + h * D;
  const float* wl = ws_lse + ((long long)b * H + h) * Sq;
  const float* wd = ws_di + ((long long)b * H + h) * Sq;
  const bool keep[2] = {mb == nullptr || mb[row] != 0, mb == nullptr || mb[row + 8] != 0};
  // one group: a warp whose 16 keys are all masked forms no product and writes zeros
  const bool warp_live = GROUPS > 1 || mb == nullptr || tile_live<16>(mb + n0 + r0, 0);
  const int n_tiles = (Sq + QT - 1) / QT;

  auto stage = [&](int t) {  // the query tile's rows past Sq zero-filled, their lse +inf
    const int slot = t % NS;
    stage_rows_upto<D, QT, THREADS>(qs + slot * QT * LD, qb, q_ss, t * QT, Sq);
    stage_rows_upto<D, QT, THREADS>(dos + slot * QT * LD, dob, do_ss, t * QT, Sq);
    for (int i = threadIdx.x; i < 2 * QT; i += THREADS) {
      const int r = t * QT + i % QT;
      if (i < QT)
        lse_s[slot * QT + i] = r < Sq ? wl[r] : INFINITY;
      else
        di_s[slot * QT + i - QT] = r < Sq ? wd[r] : 0.f;
    }
  };

  stage_rows<D, ROWS, THREADS>(ks, k + b * k_sb + h * D, k_ss, n0);
  stage_rows<D, ROWS, THREADS>(vs, v + b * v_sb + h * D, v_ss, n0);
  for (int t = 0; t < NS - 1; ++t) {  // a group each, empty or not, so that the waits below count right
    if (t < n_tiles) stage(t);
    cp_async_commit();
  }

  float dk_acc[DO / 8][4], dv_acc[DO / 8][4];
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dn][e] = dv_acc[dn][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + NS - 1 < n_tiles) stage(t + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();  // query tile t has landed
    __syncthreads();
    const int slot = t % NS;
    const float* qt = qs + slot * QT * LD;
    const float* dot = dos + slot * QT * LD;
    const float* lt = lse_s + slot * QT;
    const float* dt = di_s + slot * QT;

    // p^T [key, query] = exp(k.q^T * scale - lse[query]), masked by key; dp^T = v.dO^T
    float p[QT / 8][4], dp[QT / 8][4];
    if (warp_live) {
      rows_dot<DO, QT, LD>(p, ks + col0, r0, qt + col0, g, t4);
      rows_dot<DO, QT, LD>(dp, vs + col0, r0, dot + col0, g, t4);
    }
    if constexpr (GROUPS > 1) {
      put_c<QT>(part + grp * ROWS * QT, p, r0, g, t4);
      put_c<QT>(part + PART + grp * ROWS * QT, dp, r0, g, t4);
      __syncthreads();
      sum_c<QT, GROUPS>(p, part, ROWS * QT, r0, g, t4);
      sum_c<QT, GROUPS>(dp, part + PART, ROWS * QT, r0, g, t4);
    }
    if (warp_live) {
#pragma unroll
      for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = keep[e >> 1] ? p[nt][e] * sm_scale : MASK_VALUE;
          p[nt][e] = expf(x - lt[nt * 8 + 2 * t4 + (e & 1)]);
        }
      scores_times_tile<DO, QT, LD>(dv_acc, p, dot + col0, g, t4);  // dv += p^T.dO
#pragma unroll
      for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nt][e] = p[nt][e] * (dp[nt][e] - dt[nt * 8 + 2 * t4 + (e & 1)]) * sm_scale;
      scores_times_tile<DO, QT, LD>(dk_acc, dp, qt + col0, g, t4);  // dk += ds^T.Q
    }
    __syncthreads();  // the slot and the partial tiles are written again next iteration
  }

  // dk, dv [B, Skv, H, D] contiguous
  store_c_rows<DO>(dkb + col0, o_ss, row, dk_acc, t4);
  store_c_rows<DO>(dvb + col0, o_ss, row, dv_acc, t4);
}

// the partial score tiles of the column groups, two (s, then dp): none with one group
template <int D>
__host__ __device__ constexpr size_t vr_part_floats(int tile) {
  return vr_groups<D>() > 1 ? 2 * vr_groups<D>() * vr_rows<D>() * tile : 0;
}

template <int D>
__host__ __device__ constexpr size_t vr_dq_smem_bytes() {
  return sizeof(float) *
         (ld<D>() * (2 * vr_rows<D>() + VR_SLOTS * 2 * vr_tile<D>()) + vr_part_floats<D>(vr_tile<D>()));
}

template <int D>
__host__ __device__ constexpr size_t vr_dkv_smem_bytes() {
  return sizeof(float) * (ld<D>() * (2 * vr_rows<D>() + VR_SLOTS * 2 * vr_tile<D>()) +
                          VR_SLOTS * 2 * vr_tile<D>() + vr_part_floats<D>(vr_tile<D>()));
}

// the ints after the dq kernel's tiles: the live key tiles of kt keys and their count
inline size_t vr_live_bytes(int skv, int kt) {
  return sizeof(int) * (skv / kt + 1);
}

// --- fp32 at D = 256 and 512: staged, one kernel a (batch, head) (tf32x3.cuh)
//
// The fp32 instance of K2 (diffulab_tpu/ops/fused_mha.py:87) at the MNIST
// UNet's head dims: 64 tokens at D = 256, 16 at 512, keys padded to 128. At
// B=128, H=2 a call must read q, do, k and v and write dq, dk and dv over the
// valid rows and keys, 117.4 / 58.7 MB (0.035 / 0.018 ms at 3.35 TB/s), and
// the padded contract has the kernel write the zero dk and dv of the padded
// keys too, 33.6 / 117.4 MB more; against 2.68 / 0.34 GFLOP (0.016 ms or
// less at 3xTF32): bound by bytes. The split pair above (a dq kernel forming s and dp
// twice over 8-key tiles, a dk/dv kernel forming them a third time, lse and
// di through a workspace, the score reduction split between column groups
// that added their partial tiles in shared memory every tile) took 6.2x /
// 6.4x the valid bound. Here one CTA a (batch, head) forms s and dp once per
// (row, live key), as the TPU kernel's one program a batch and head does:
//  - the live 8-key tiles of the mask row are gathered into slots of
//    vr_f32s_slot keys (the UNet's whole live row is one slot); the keys of
//    the tiles without an attended key get dk = dv = 0 first;
//  - phase 1 walks D a chunk of vr_f32s_chunk columns at a time through a
//    ring of VR_F32S_STAGES cp.async stages (Q, dO, and the slot's K and V):
//    a warp forms the s (or the dp) of its 16 rows and its keys, each chunk's
//    3xTF32 product summed from zero and added to its fp32 sums (T25). Then
//    p = exp(s - lse) goes to shared memory, the dp warp of the same rows
//    sums di = rowsum(p * dp) from the fp32 p and dp and writes ds = p * (dp
//    - di) * scale beside it;
//  - phase 2 walks the chunks again (Q, dO and K, from L2): dq = ds.K, dk =
//    ds^T.Q and dv = p^T.dO, each 16 x 16 output tile complete for its chunk
//    of columns and stored at once.
// A CTA holds 64 (or 16) query rows and 64 (or 16) keys at a time: the
// whole head in fp32 (4 x 66.5 KB at D = 256) does not fit in one SM, so the
// chunks (36.9 KB a stage at D = 256) keep two CTAs on an SM. A head whose
// valid rows exceed vr_f32s_rows (the route hands these dims any Sq up to
// 512; the UNets' are one block) loops over its row blocks inside the CTA,
// carrying dk and dv: a later block adds its partial to the stored values;
// a live row of more than one slot first sums di over its slots (s and dp
// formed, p and dp not kept), then adds each slot's dq to the stored one. No
// workspace, no second launch, no atomics: the sums run in a fixed order. A
// batch row with no live tile writes dq = 0. A cluster of two CTAs a head,
// each taking half of a row block and adding its partner's partial dk and dv
// through distributed shared memory, took twice as long at D = 256 (0.2037
// against 0.1062 ms, B=128, H=2; NVIDIA H100 80GB HBM3, 700 W; PERF.md).

// which pass, slot, phase and chunk a load of the staged K2 serves
struct StagedItem {
  int m0;     // the row block's first query row
  int c;      // the slot
  int ch;     // the chunk of columns
  bool p2;    // phase 2 (dq, dk, dv), else phase 1 (s, dp)
  bool full;  // the pass that forms ds and the outputs, else the di pass of a row of more than one slot
};

template <int D>
__global__ void __launch_bounds__(VR_F32S_BWD_THREADS, VR_F32S_BWD_BLOCKS)
mha_bwd_fused_tf32x3_staged(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                            const float* __restrict__ dout, const int* __restrict__ mask,
                            const float* __restrict__ lse, float* __restrict__ dq, float* __restrict__ dk,
                            float* __restrict__ dv, int Sq, int Skv, int H, long long q_sb, long long q_ss,
                            long long k_sb, long long k_ss, long long v_sb, long long v_ss, long long do_sb,
                            long long do_ss, float sm_scale) {
  constexpr int KT = VR_TILE, SLOT = vr_f32s_slot<D>(), CT = SLOT / KT, ROWS = vr_f32s_rows<D>();
  constexpr int C = vr_f32s_chunk<D>(), NC = D / C, LDC = C + 4, R = ROWS > SLOT ? ROWS : SLOT, TILE = R * LDC;
  constexpr int NB = VR_F32S_STAGES, LDP = SLOT + 4, KP = vr_f32s_key_parts<D>(), KPW = SLOT / KP;
  constexpr int THREADS = VR_F32S_BWD_THREADS, WARPS = THREADS / 32, RB = ROWS / 16, KB = SLOT / 16;
  constexpr int CP = C / 16, UNITS = (RB + 2 * KB) * CP;
  constexpr int NG = KPW / 8 < 4 ? KPW / 8 : 4;  // n-tiles of a phase-1 partial
  constexpr int PARTS = vr_f32s_parts<D>();
  static_assert((KPW / 8) % NG == 0 && 2 * RB * KP <= WARPS && KPW % 8 == 0 && SLOT % 16 == 0 && ROWS % 16 == 0 &&
                    C % 16 == 0 && D % C == 0,
                "the staged fp32 K2's tiles");
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                // [NB][4][R][LDC]: chunks of Q, dO, K and V
  float* ps = ring + NB * 4 * TILE;  // [ROWS][LDP]: p
  float* dss = ps + ROWS * LDP;      // [ROWS][LDP]: ds
  float* di_x = dss + ROWS * LDP;    // [KP][ROWS]: the key parts' di
  int* live = reinterpret_cast<int*>(di_x + KP * ROWS);  // [Skv / KT + 1]: live tiles, count
  int* dead = live + Skv / KT + 1;                        // [Skv / KT]: 1 for a tile without one

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  // phase 1: warp (is_dp, rb1, kp) forms the s (dp) of rows rb1 * 16 + [0, 16) and keys kp * KPW + [0, KPW)
  const bool scorer = warp < 2 * RB * KP, is_dp = warp >= RB * KP;
  const int rb1 = (warp % (RB * KP)) / KP, kp = warp % KP;
  const long long o_ss = (long long)H * D;
  const float* qb = q + b * q_sb + h * D;
  const float* dob = dout + b * do_sb + h * D;
  const float* kb = k + b * k_sb + h * D;
  const float* vb = v + b * v_sb + h * D;
  float* dqb = dq + (long long)b * Sq * o_ss + h * D;
  float* dkb = dk + (long long)b * Skv * o_ss + h * D;
  float* dvb = dv + (long long)b * Skv * o_ss + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  const int n_tiles = Skv / KT;

  find_live_tiles<KT>(live, mb, n_tiles);
  for (int t = threadIdx.x; t < n_tiles; t += THREADS) dead[t] = mb != nullptr && !tile_live<KT>(mb, t);
  __syncthreads();
  const int n_live = live[n_tiles], n_slots = (n_live + CT - 1) / CT;
  const bool kept = n_slots == 1;  // the same for every thread: one pass, di from the slot alone
  const int n_blocks = (Sq + ROWS - 1) / ROWS;  // the head's row blocks, in turn
  const int per_block = kept ? 2 * NC : 3 * NC * n_slots;
  const int n_items = n_slots > 0 ? n_blocks * per_block : 0;

  // dk = dv = 0 on the keys of the tiles without an attended key (the padded keys: most of the bytes at D =
  // 512); written after the first loads are requested they took as long (0.0862 ms against 0.0842 at D = 512,
  // B=128, H=2; 0.1047 against 0.1063 at 256: scripts/d2_valid_variants.py; NVIDIA H100 80GB HBM3, 700 W)
  for (int i = threadIdx.x; i < n_tiles * KT * (D / 4); i += THREADS) {
    const int key = i / (D / 4);
    if (dead[key / KT]) {
      const long long at = (long long)key * o_ss + (i % (D / 4)) * 4;
      *reinterpret_cast<float4*>(dkb + at) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dvb + at) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (n_live == 0) {  // no attended key: dq = 0
    for (int i = threadIdx.x; i < Sq * (D / 4); i += THREADS)
      *reinterpret_cast<float4*>(dqb + (long long)(i / (D / 4)) * o_ss + (i % (D / 4)) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

  auto decode = [&](int i) {
    const int blk = i / per_block, j = i % per_block;
    StagedItem it;
    it.m0 = blk * ROWS;
    if (kept) {
      it.c = 0, it.full = true, it.p2 = j >= NC, it.ch = j % NC;
    } else if (j < NC * n_slots) {
      it.c = j / NC, it.full = false, it.p2 = false, it.ch = j % NC;
    } else {
      const int jj = j - NC * n_slots;
      it.c = jj / (2 * NC), it.full = true, it.p2 = jj % (2 * NC) >= NC, it.ch = jj % NC;
    }
    return it;
  };
  // the loads of item i into stage i % NB: Q, dO (the row block, zero past Sq), K and, in phase 1, V (the
  // slot's live tiles, zero past them)
  auto stage = [&](int i) {
    const StagedItem it = decode(i);
    float* st = ring + (i % NB) * 4 * TILE;
    const int col = it.ch * C, n = min(CT, n_live - it.c * CT);
    stage_chunk_rows<C, ROWS, THREADS>(st, qb, q_ss, it.m0, Sq, col);
    stage_chunk_rows<C, ROWS, THREADS>(st + TILE, dob, do_ss, it.m0, Sq, col);
    stage_chunk_tiles<C, SLOT, KT, THREADS>(st + 2 * TILE, kb, k_ss, live + it.c * CT, n, col);
    if (!it.p2) stage_chunk_tiles<C, SLOT, KT, THREADS>(st + 3 * TILE, vb, v_ss, live + it.c * CT, n, col);
  };
  for (int i = 0; i < NB - 1; ++i) {  // a group each, empty or not, so that the waits below count right
    if (i < n_items) stage(i);
    cp_async_commit();
  }

  // the items in order: a row block's passes (kept, one; else the di pass over the slots, then the full one),
  // a pass's slots, a slot's phase-1 chunks and, in the full pass, its phase-2 chunks; item i is computed while
  // the next NB - 1 load
  int i = 0;
  auto begin_item = [&]() {
    if (i + NB - 1 < n_items) stage(i + NB - 1);
    cp_async_commit();
    cp_async_wait<NB - 1>();  // item i has landed
    __syncthreads();
    return static_cast<const float*>(ring + (i % NB) * 4 * TILE);
  };
  auto end_item = [&]() {
    __syncthreads();  // the stage, p and ds are written again
    ++i;
  };
  float di[2] = {0.f, 0.f};  // the dp warp's rows' di
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int m0 = blk * ROWS, row = m0 + rb1 * 16 + g;  // a scorer's rows: row, row + 8
    float dsum[2] = {0.f, 0.f};  // the dp warp's rows: its keys' p * dp over the slots
    for (int full = kept ? 1 : 0; full < 2; ++full) {
      for (int c = 0; c < n_slots; ++c) {
        const int n = min(CT, n_live - c * CT);
        float acc[KPW / 8][4] = {};  // phase 1: the warp's s or dp, summed over the chunks
        for (int ch = 0; ch < NC; ++ch) {
          const float* st = begin_item();
          if (scorer) {  // this chunk's s = Q.K^T (dp = dO.V^T), NG n-tiles at a time from zero, added to the sums
#pragma unroll
            for (int n0 = 0; n0 < KPW / 8; n0 += NG)
              rows_dot_add<C, NG * 8, LDC, PARTS>(*reinterpret_cast<float(*)[NG][4]>(&acc[n0]), st + (is_dp ? TILE : 0),
                                                  rb1 * 16, st + (is_dp ? 3 : 2) * TILE + (kp * KPW + n0 * 8) * LDC, g, t4);
          }
          if (ch == NC - 1) {  // the slot's s and dp are whole
            if (scorer && !is_dp) {  // p = exp(s * scale - lse); a masked key at MASK_VALUE, a key past the slot 0
              const float lse_r[2] = {row < Sq ? lse[((long long)b * Sq + row) * H + h] : INFINITY,
                                      row + 8 < Sq ? lse[((long long)b * Sq + row + 8) * H + h] : INFINITY};
#pragma unroll
              for (int nt = 0; nt < KPW / 8; ++nt) {
                const int col = kp * KPW + nt * 8 + 2 * t4, j = col / KT;
                float p[4] = {0.f, 0.f, 0.f, 0.f};
                if (j < n) {
                  const int key = live[c * CT + j] * KT + col % KT;
                  const int2 keep = mb == nullptr ? make_int2(1, 1) : *reinterpret_cast<const int2*>(mb + key);
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    p[e] = expf(((e & 1) ? keep.y : keep.x) ? acc[nt][e] * sm_scale - lse_r[e >> 1]
                                                             : MASK_VALUE - lse_r[e >> 1]);
                }
                *reinterpret_cast<float2*>(ps + (rb1 * 16 + g) * LDP + col) = make_float2(p[0], p[1]);
                *reinterpret_cast<float2*>(ps + (rb1 * 16 + g + 8) * LDP + col) = make_float2(p[2], p[3]);
              }
            }
            __syncthreads();  // p is whole
            // p where the dp warp's dp lies
            auto p_at = [&](int nt, float (&pv)[4]) {
              const int col = kp * KPW + nt * 8 + 2 * t4;
              const float2 x = *reinterpret_cast<const float2*>(ps + (rb1 * 16 + g) * LDP + col);
              const float2 y = *reinterpret_cast<const float2*>(ps + (rb1 * 16 + g + 8) * LDP + col);
              pv[0] = x.x, pv[1] = x.y, pv[2] = y.x, pv[3] = y.y;
            };
            if (scorer && is_dp && (kept || !full)) {  // di's sum over the dp warp's keys
#pragma unroll
              for (int nt = 0; nt < KPW / 8; ++nt) {
                float pv[4];
                p_at(nt, pv);
#pragma unroll
                for (int e = 0; e < 4; ++e) dsum[e >> 1] += pv[e] * acc[nt][e];
              }
            }
            if (kept || (!full && c == n_slots - 1)) {  // di over the whole key row: the quads, the key parts in order
              if (scorer && is_dp) {
                dsum[0] = quad_sum(dsum[0]);
                dsum[1] = quad_sum(dsum[1]);
                if (t4 == 0) {
                  di_x[kp * ROWS + rb1 * 16 + g] = dsum[0];
                  di_x[kp * ROWS + rb1 * 16 + g + 8] = dsum[1];
                }
              }
              __syncthreads();
              if (scorer && is_dp) {
                di[0] = di[1] = 0.f;
#pragma unroll
                for (int x = 0; x < KP; ++x) {
                  di[0] += di_x[x * ROWS + rb1 * 16 + g];
                  di[1] += di_x[x * ROWS + rb1 * 16 + g + 8];
                }
              }
            }
            if (full && scorer && is_dp) {  // ds = p * (dp - di) * scale, beside p
#pragma unroll
              for (int nt = 0; nt < KPW / 8; ++nt) {
                const int col = kp * KPW + nt * 8 + 2 * t4;
                float pv[4], ds[4];
                p_at(nt, pv);
#pragma unroll
                for (int e = 0; e < 4; ++e) ds[e] = pv[e] * (acc[nt][e] - di[e >> 1]) * sm_scale;
                *reinterpret_cast<float2*>(dss + (rb1 * 16 + g) * LDP + col) = make_float2(ds[0], ds[1]);
                *reinterpret_cast<float2*>(dss + (rb1 * 16 + g + 8) * LDP + col) = make_float2(ds[2], ds[3]);
              }
            }
          }
          end_item();
        }
        for (int ch = 0; full && ch < NC; ++ch) {
          // phase 2: the warp's 16 x 16 tiles of this chunk's columns, unit u: dq rows (u < RB CP), dk keys, dv keys
          const float* st = begin_item();
          auto product = [&](int u, float (&o)[2][4]) {
            const int prod = u < RB * CP ? 0 : u < (RB + KB) * CP ? 1 : 2;
            const int w = u - (prod == 0 ? 0 : prod == 1 ? RB * CP : (RB + KB) * CP), rb = w / CP, cp = w % CP;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
            if (prod == 0) {  // dq = ds.K over the slot's keys
#pragma unroll
              for (int kk = 0; kk < SLOT / 8; ++kk) {
                uint32_t ah[4], al[4];
                frag_a_rows_perm<LDP>(ah, al, dss, rb * 16, kk, g, t4);
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                  uint32_t bh[2], bl[2];
                  frag_b_cols<C, LDC>(bh, bl, st + 2 * TILE, kk, cp * 16 + nt * 8, g, t4);
                  mma3(o[nt], ah, al, bh, bl);
                }
              }
            } else {  // dk = ds^T.Q, dv = p^T.dO over the block's query rows
              const float* a = prod == 1 ? dss : ps;
              const float* bt = st + (prod == 1 ? 0 : TILE);
#pragma unroll
              for (int kk = 0; kk < ROWS / 8; ++kk) {
                uint32_t ah[4], al[4];
                frag_a_cols_perm<LDP>(ah, al, a, rb * 16, kk, g, t4);
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                  uint32_t bh[2], bl[2];
                  frag_b_cols<C, LDC>(bh, bl, bt, kk, cp * 16 + nt * 8, g, t4);
                  mma3(o[nt], ah, al, bh, bl);
                }
              }
            }
          };
          // stored, or added to what an earlier slot (dq) or row block (dk, dv) stored
          auto store = [&](int u, const float (&o)[2][4]) {
            const int prod = u < RB * CP ? 0 : u < (RB + KB) * CP ? 1 : 2;
            const int w = u - (prod == 0 ? 0 : prod == 1 ? RB * CP : (RB + KB) * CP), rb = w / CP, cp = w % CP;
            const int col = ch * C + cp * 16 + 2 * t4;
            const bool add = prod == 0 ? c > 0 : blk > 0;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              long long at;
              if (prod == 0) {
                const int r = m0 + rb * 16 + g + 8 * half;
                if (r >= Sq) continue;
                at = (long long)r * o_ss;
              } else {
                const int r = rb * 16 + g + 8 * half;
                if (r / KT >= n) continue;
                at = ((long long)live[c * CT + r / KT] * KT + r % KT) * o_ss;
              }
              float* dst = (prod == 0 ? dqb : prod == 1 ? dkb : dvb) + at + col;
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                float2 val = make_float2(o[nt][2 * half], o[nt][2 * half + 1]);
                if (add) {
                  const float2 was = *reinterpret_cast<const float2*>(dst + nt * 8);
                  val = make_float2(was.x + val.x, was.y + val.y);
                }
                *reinterpret_cast<float2*>(dst + nt * 8) = val;
              }
            }
          };
#pragma unroll 1
          for (int u = warp; u < UNITS; u += WARPS) {  // a tile at a time: one accumulator live
            float o[2][4];
            product(u, o);
            store(u, o);
          }
          end_item();
        }
      }
    }
  }
}

template <int D>
__host__ __device__ constexpr size_t vr_f32s_bwd_smem_bytes() {
  constexpr int R = vr_f32s_rows<D>() > vr_f32s_slot<D>() ? vr_f32s_rows<D>() : vr_f32s_slot<D>();
  return sizeof(float) * (VR_F32S_STAGES * 4 * R * (vr_f32s_chunk<D>() + 4) +
                          2 * vr_f32s_rows<D>() * (vr_f32s_slot<D>() + 4) + vr_f32s_key_parts<D>() * vr_f32s_rows<D>());
}

// --- bf16 at D = 64: the same split around the valid rows (bf16_valid.cuh)
//
// The bf16 instance of K2 (diffulab_tpu/ops/fused_mha.py:87) for the DiTs'
// padded short sequences at head dim 64 (a 64-token row, keys padded to 128).
// The CTAs and warps are the fp32 valid-rows kernels' at D = 64 (one column
// group); the products are mma.sync m16n8k16 on bf16 tiles of vr_bf16_tile =
// 64 keys (dq) or queries (dk/dv); K2's roundings: p to bf16 before dv =
// p^T.dO, ds to bf16 before dq = ds.K and dk = ds^T.Q, di from the fp32 p and
// dp. The UNets' head dims 192-512 run the staged kernels below.

// dq for vr_rows queries of a (batch, head): pass 1 over the live key tiles
// forms s, p = exp(s - lse) and dp = dO.V^T and sums di = rowsum(p * dp);
// pass 2 forms them again, ds = p * (dp - di) * scale and dq += round(ds).K.
// The CTA writes lse and di for the dk/dv kernel.
template <int D>
__global__ void __launch_bounds__(vr_threads<D>())
mha_bwd_dq_bf16_valid(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const bf16* __restrict__ dout, const int* __restrict__ mask, const float* __restrict__ lse,
                      float* __restrict__ ws_lse, float* __restrict__ ws_di, bf16* __restrict__ dq, int Sq, int Skv,
                      int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                      long long v_ss, long long do_sb, long long do_ss, float sm_scale) {
  constexpr int KT = vr_bf16_tile<D>(), DO = vr_cols<D>(), ROWS = vr_rows<D>(), THREADS = vr_threads<D>();
  constexpr int LD = ldb<D>(), NS = VR_SLOTS;
  constexpr int ROW_WARPS = ROWS / 16;
  static_assert(vr_groups<D>() == 1, "one column group: each warp's s and dp over the whole of D");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);              // [ROWS][LD]
  bf16* dos = qs + ROWS * LD;                                // [ROWS][LD]
  bf16* ks = dos + ROWS * LD;                                // [NS][KT][LD]
  bf16* vs = ks + NS * KT * LD;                              // [NS][KT][LD]
  int* live = reinterpret_cast<int*>(vs + NS * KT * LD);     // [Skv / KT + 1]: live tiles, count

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * ROWS, r0 = 16 * (warp % ROW_WARPS);
  const int grp = warp / ROW_WARPS, col0 = grp * DO;  // this warp's dq columns: col0 + [0, DO)
  const int row = m0 + r0 + g;                        // this thread's rows: row, row + 8
  const bool active = m0 + r0 < Sq;                   // the warp has a valid row
  const bf16* kb = k + b * k_sb + h * D;
  const bf16* vb = v + b * v_sb + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  const int n_tiles = Skv / KT;
  const float lse_r[2] = {row < Sq ? lse[((long long)b * Sq + row) * H + h] : INFINITY,
                          row + 8 < Sq ? lse[((long long)b * Sq + row + 8) * H + h] : INFINITY};

  find_live_tiles<KT>(live, mb, n_tiles);
  __syncthreads();
  const int n_live = live[n_tiles], n_items = 2 * n_live;
  // the load sequence, item i: the live tiles for pass 1 (i < n_live), then again for pass 2 (p and dp formed
  // twice: keeping them, as the fp32 kernel does, doubles this kernel's registers); NS - 1 items loading while
  // one is computed
  auto stage = [&](int item) {
    const int tile = live[item % n_live], slot = item % NS;
    stage_bf16_rows<D, KT, THREADS>(ks + slot * KT * LD, kb, k_ss, tile * KT, Skv);
    stage_bf16_rows<D, KT, THREADS>(vs + slot * KT * LD, vb, v_ss, tile * KT, Skv);
  };
  if (n_live > 0) {
    stage_bf16_rows<D, ROWS, THREADS>(qs, q + b * q_sb + h * D, q_ss, m0, Sq);
    stage_bf16_rows<D, ROWS, THREADS>(dos, dout + b * do_sb + h * D, do_ss, m0, Sq);
  }

  for (int item = 0; item < NS - 1; ++item) {  // a group each, empty or not, so that the waits below count right
    if (item < n_items) stage(item);
    cp_async_commit();
  }

  float di[2] = {0.f, 0.f}, acc[DO / 8][4];
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int i = 0; i < n_items; ++i) {
    if (i + NS - 1 < n_items) stage(i + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();  // item i has landed
    __syncthreads();
    const int pass = i >= n_live, slot = i % NS, cur = live[i - pass * n_live];
    float p[KT / 8][4], dp[KT / 8][4];
    if (active) {
      rows_dot_bf16<DO, KT, LD>(p, qs + col0, r0, ks + slot * KT * LD + col0, g, t4);
      rows_dot_bf16<DO, KT, LD>(dp, dos + col0, r0, vs + slot * KT * LD + col0, g, t4);
      probs_f32<KT, D == 64>(p, sm_scale, mb, cur * KT, lse_r, t4);
      if (pass == 0) {
#pragma unroll
        for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) di[e >> 1] += p[nt][e] * dp[nt][e];
      } else {
#pragma unroll
        for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[nt][e] = p[nt][e] * (dp[nt][e] - di[e >> 1]) * sm_scale;
        scores_times_tile_bf16<DO, KT, LD>(acc, p, ks + slot * KT * LD + col0, lane);  // dq += round(ds).K
      }
    }
    __syncthreads();  // the slot and the partial tiles are written again
    if (i == n_live - 1) {  // di over the whole key row, before pass 2
      di[0] = quad_sum(di[0]);
      di[1] = quad_sum(di[1]);
    }
  }

  // dq [B, Sq, H, D] contiguous; lse and di [B * H][Sq]
  if (!active) return;
  const long long o_ss = (long long)H * D;
  store_bf16_rows<DO>(dq + (long long)b * Sq * o_ss + h * D + col0, o_ss, row, acc, t4, Sq);
  if (grp == 0 && t4 == 0) {
    const long long w = ((long long)b * H + h) * Sq + row;
    if (row < Sq) {
      ws_lse[w] = lse_r[0];
      ws_di[w] = di[0];
    }
    if (row + 8 < Sq) {
      ws_lse[w + 8] = lse_r[1];
      ws_di[w + 8] = di[1];
    }
  }
}

// dk and dv for vr_rows keys of a (batch, head): a CTA whose keys are all
// masked writes zeros; otherwise its K and V rows stay in shared memory and the
// valid query rows stream in tiles of VR_BF16_TILE queries with their lse and
// di (rows past Sq zero-filled, lse +inf: p = 0). p^T = exp(K.Q^T * scale -
// lse), dv += round(p^T).dO, dp^T = V.dO^T, ds^T = p^T * (dp^T - di) * scale,
// dk += round(ds^T).Q.
template <int D>
__global__ void __launch_bounds__(vr_threads<D>())
mha_bwd_dkv_bf16_valid(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const bf16* __restrict__ dout, const int* __restrict__ mask,
                       const float* __restrict__ ws_lse, const float* __restrict__ ws_di, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int Sq, int Skv, int H, long long q_sb, long long q_ss, long long k_sb,
                       long long k_ss, long long v_sb, long long v_ss, long long do_sb, long long do_ss,
                       float sm_scale) {
  constexpr int QT = vr_bf16_tile<D>(), DO = vr_cols<D>(), ROWS = vr_rows<D>(), THREADS = vr_threads<D>();
  constexpr int LD = ldb<D>(), NS = VR_SLOTS;
  constexpr int ROW_WARPS = ROWS / 16;
  static_assert(vr_groups<D>() == 1, "one column group: each warp's s^T and dp^T over the whole of D");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);                 // [ROWS][LD]
  bf16* vs = ks + ROWS * LD;                                    // [ROWS][LD]
  bf16* qs = vs + ROWS * LD;                                    // [NS][QT][LD]
  bf16* dos = qs + NS * QT * LD;                                // [NS][QT][LD]
  float* lse_s = reinterpret_cast<float*>(dos + NS * QT * LD);  // [NS][QT]
  float* di_s = lse_s + NS * QT;                                // [NS][QT]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * ROWS, r0 = 16 * (warp % ROW_WARPS);
  const int grp = warp / ROW_WARPS, col0 = grp * DO;  // this warp's dk and dv columns: col0 + [0, DO)
  const int row = n0 + r0 + g;                        // this thread's keys: row, row + 8
  const long long o_ss = (long long)H * D;
  bf16* dkb = dk + (long long)b * Skv * o_ss + h * D;
  bf16* dvb = dv + (long long)b * Skv * o_ss + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;

  bool live = mb == nullptr;
  for (int t = 0; !live && t < ROWS / 16; ++t) live = tile_live<16>(mb + n0, t);
  if (!live) {  // every key masked: dk = dv = 0
    for (int i = threadIdx.x; i < ROWS * (D / 8); i += THREADS) {
      const long long at = (long long)(n0 + i / (D / 8)) * o_ss + (i % (D / 8)) * 8;
      *reinterpret_cast<int4*>(dkb + at) = make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(dvb + at) = make_int4(0, 0, 0, 0);
    }
    return;
  }

  const bf16* qb = q + b * q_sb + h * D;
  const bf16* dob = dout + b * do_sb + h * D;
  const float* wl = ws_lse + ((long long)b * H + h) * Sq;
  const float* wd = ws_di + ((long long)b * H + h) * Sq;
  const bool keep[2] = {mb == nullptr || mb[row] != 0, mb == nullptr || mb[row + 8] != 0};
  // a warp whose 16 keys are all masked forms no product and writes zeros
  const bool warp_live = mb == nullptr || tile_live<16>(mb + n0 + r0, 0);
  const int n_tiles = (Sq + QT - 1) / QT;

  auto stage = [&](int t) {  // the query tile's rows past Sq zero-filled, their lse +inf
    const int slot = t % NS;
    stage_bf16_rows<D, QT, THREADS>(qs + slot * QT * LD, qb, q_ss, t * QT, Sq);
    stage_bf16_rows<D, QT, THREADS>(dos + slot * QT * LD, dob, do_ss, t * QT, Sq);
    for (int i = threadIdx.x; i < 2 * QT; i += THREADS) {
      const int r = t * QT + i % QT;
      if (i < QT)
        lse_s[slot * QT + i] = r < Sq ? wl[r] : INFINITY;
      else
        di_s[slot * QT + i - QT] = r < Sq ? wd[r] : 0.f;
    }
  };

  stage_bf16_rows<D, ROWS, THREADS>(ks, k + b * k_sb + h * D, k_ss, n0, Skv);
  stage_bf16_rows<D, ROWS, THREADS>(vs, v + b * v_sb + h * D, v_ss, n0, Skv);
  for (int t = 0; t < NS - 1; ++t) {  // a group each, empty or not, so that the waits below count right
    if (t < n_tiles) stage(t);
    cp_async_commit();
  }

  float dk_acc[DO / 8][4], dv_acc[DO / 8][4];
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dn][e] = dv_acc[dn][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + NS - 1 < n_tiles) stage(t + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();  // query tile t has landed
    __syncthreads();
    const int slot = t % NS;
    const bf16* qt = qs + slot * QT * LD;
    const bf16* dot = dos + slot * QT * LD;
    const float* lt = lse_s + slot * QT;
    const float* dt = di_s + slot * QT;

    // p^T [key, query] = exp(k.q^T * scale - lse[query]), masked by key; dp^T = v.dO^T
    float p[QT / 8][4], dp[QT / 8][4];
    if (warp_live) {
      rows_dot_bf16<DO, QT, LD>(p, ks + col0, r0, qt + col0, g, t4);
      rows_dot_bf16<DO, QT, LD>(dp, vs + col0, r0, dot + col0, g, t4);
#pragma unroll
      for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = keep[e >> 1] ? p[nt][e] * sm_scale : MASK_VALUE;
          p[nt][e] = bf16_exp<D>(x - lt[nt * 8 + 2 * t4 + (e & 1)]);
        }
      scores_times_tile_bf16<DO, QT, LD>(dv_acc, p, dot + col0, lane);  // dv += round(p^T).dO
#pragma unroll
      for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nt][e] = p[nt][e] * (dp[nt][e] - dt[nt * 8 + 2 * t4 + (e & 1)]) * sm_scale;
      scores_times_tile_bf16<DO, QT, LD>(dk_acc, dp, qt + col0, lane);  // dk += round(ds^T).Q
    }
    __syncthreads();  // the slot and the partial tiles are written again next iteration
  }

  // dk, dv [B, Skv, H, D] contiguous
  store_bf16_rows<DO>(dkb + col0, o_ss, row, dk_acc, t4, Skv);
  store_bf16_rows<DO>(dvb + col0, o_ss, row, dv_acc, t4, Skv);
}

template <int D>
__host__ __device__ constexpr size_t vr_bf16_dq_smem_bytes() {
  return 2 * ldb<D>() * (2 * vr_rows<D>() + VR_SLOTS * 2 * vr_bf16_tile<D>());
}

template <int D>
__host__ __device__ constexpr size_t vr_bf16_dkv_smem_bytes() {
  return 2 * ldb<D>() * (2 * vr_rows<D>() + VR_SLOTS * 2 * vr_bf16_tile<D>()) +
         sizeof(float) * VR_SLOTS * 2 * vr_bf16_tile<D>();
}

// --- bf16 at the UNets' head dims 192-512: staged (bf16_valid.cuh)
//
// The same split and roundings as above, for a bf16 UNet's backward: dq over
// a head's vr_bf16_rows valid query rows and its live keys, gathered a slot
// of vr_bf16_slot keys at a time from the live 16-key tiles, then dk and dv
// over vr_bf16_rows keys and the valid queries, a slot of vr_bf16_slot at a
// time. At B=128, H=2 the pair must read q, do, k and v and write dq, dk and
// dv over the valid rows and keys, 44.2 / 58.9 / 22.1 / 29.4 MB at D = 192 /
// 256 / 384 / 512 (0.0132 / 0.0176 / 0.0066 / 0.0088 ms at 3.35 TB/s): bound
// by bytes and, at one short wave of CTAs, by its loads' latency. So each
// kernel stages what a step reads in one request (the UNets' shapes are one
// step a CTA: one wait), each warp forms its rows' s and dp over the whole of
// D and the column groups split only the output columns (no partial score
// crosses warps), exponentials by __expf.

// dq for vr_bf16_rows queries of a (batch, head). Where the live keys are one
// slot (the UNets'), one step: s, p = exp(s - lse), dp = dO.V^T, di =
// rowsum(p * dp) over the whole key row, ds = p * (dp - di) * scale and dq =
// round(ds).K, p and dp in registers throughout (3 products). A longer row
// runs pass 1 (di) over its slots, then pass 2 with s and dp formed anew. The
// CTA writes lse and di for the dk/dv kernel.
template <int D>
__global__ void __launch_bounds__(vr_bf16_threads<D, true>())
mha_bwd_dq_bf16_staged(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const bf16* __restrict__ dout, const int* __restrict__ mask, const float* __restrict__ lse,
                       float* __restrict__ ws_lse, float* __restrict__ ws_di, bf16* __restrict__ dq, int Sq,
                       int Skv, int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                       long long v_sb, long long v_ss, long long do_sb, long long do_ss, float sm_scale) {
  constexpr int KT = VR_BF16_TILE, SLOT = vr_bf16_slot<D>(), CT = SLOT / KT, DO = vr_bf16_cols<D, true>();
  constexpr int ROWS = vr_bf16_rows<D>(), THREADS = vr_bf16_threads<D, true>(), LD = ldb<D>(), ROW_WARPS = ROWS / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LD]
  bf16* dos = qs + ROWS * LD;                    // [ROWS][LD]
  bf16* ks = dos + ROWS * LD;                    // [SLOT][LD]
  bf16* vs = ks + SLOT * LD;                     // [SLOT][LD]
  int* live = reinterpret_cast<int*>(vs + SLOT * LD);  // [Skv / KT + 1]: live tiles, count

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * ROWS, r0 = 16 * (warp % ROW_WARPS);
  const int grp = warp / ROW_WARPS, col0 = grp * DO;  // this warp's dq columns: col0 + [0, DO)
  const int row = m0 + r0 + g;                        // this thread's rows: row, row + 8
  const bool active = m0 + r0 < Sq;                   // the warp has a valid row
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  const int n_tiles = Skv / KT;
  const float lse_r[2] = {row < Sq ? lse[((long long)b * Sq + row) * H + h] : INFINITY,
                          row + 8 < Sq ? lse[((long long)b * Sq + row + 8) * H + h] : INFINITY};
  find_live_tiles<KT>(live, mb, n_tiles);
  __syncthreads();
  const int n_live = live[n_tiles], n_slots = (n_live + CT - 1) / CT;
  const bool kept = n_slots == 1;  // the same for every thread: p and dp stay in registers
  const int n_steps = kept ? 1 : 2 * n_slots;

  float di[2] = {0.f, 0.f}, acc[DO / 8][4];
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int i = 0; i < n_steps; ++i) {
    const int c = i % n_slots, n = min(CT, n_live - c * CT);
    if (i == 0) {
      stage_bf16_rows<D, ROWS, THREADS>(qs, q + b * q_sb + h * D, q_ss, m0, Sq);
      stage_bf16_rows<D, ROWS, THREADS>(dos, dout + b * do_sb + h * D, do_ss, m0, Sq);
    }
    stage_bf16_tiles<D, KT, THREADS>(ks, k + b * k_sb + h * D, k_ss, live + c * CT, n);
    stage_bf16_tiles<D, KT, THREADS>(vs, v + b * v_sb + h * D, v_ss, live + c * CT, n);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (active) {
      float p[SLOT / 8][4], dp[SLOT / 8][4];
      rows_dot_bf16_ldsm<D, SLOT, LD>(p, qs, r0, ks, lane, n * KT);
      rows_dot_bf16_ldsm<D, SLOT, LD>(dp, dos, r0, vs, lane, n * KT);
      scale_and_mask_slot<SLOT, KT>(p, sm_scale, mb, live + c * CT, n, t4);
#pragma unroll
      for (int nt = 0; nt < SLOT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[nt][e] = __expf(p[nt][e] - lse_r[e >> 1]);
      if (i < n_slots) {  // the di pass (the one step where kept)
#pragma unroll
        for (int nt = 0; nt < SLOT / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) di[e >> 1] += p[nt][e] * dp[nt][e];
        if (i == n_slots - 1) {  // di over the whole key row
          di[0] = quad_sum(di[0]);
          di[1] = quad_sum(di[1]);
        }
      }
      if (kept || i >= n_slots) {
#pragma unroll
        for (int nt = 0; nt < SLOT / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[nt][e] = p[nt][e] * (dp[nt][e] - di[e >> 1]) * sm_scale;
        scores_times_tile_bf16<DO, SLOT, LD>(acc, p, ks + col0, lane, n * KT);  // dq += round(ds).K
      }
    }
    __syncthreads();  // the slot is written again
  }

  // dq [B, Sq, H, D] contiguous; lse and di [B * H][Sq]
  if (!active) return;
  const long long o_ss = (long long)H * D;
  store_bf16_rows<DO>(dq + (long long)b * Sq * o_ss + h * D + col0, o_ss, row, acc, t4, Sq);
  if (grp == 0 && t4 == 0) {
    const long long w = ((long long)b * H + h) * Sq + row;
    if (row < Sq) {
      ws_lse[w] = lse_r[0];
      ws_di[w] = di[0];
    }
    if (row + 8 < Sq) {
      ws_lse[w + 8] = lse_r[1];
      ws_di[w + 8] = di[1];
    }
  }
}

// dk and dv for vr_bf16_rows keys of a (batch, head): a CTA whose keys are all
// masked writes zeros; otherwise its K and V rows stay in shared memory and the
// valid query rows come a slot of vr_bf16_slot at a time with their lse and di
// (rows past Sq zero-filled, lse +inf: p = 0), each slot worked in steps of
// vr_bf16_sub queries: p^T = exp(K.Q^T * scale - lse), dv += round(p^T).dO,
// dp^T = V.dO^T, ds^T = p^T * (dp^T - di) * scale, dk += round(ds^T).Q. A warp
// whose 16 keys are all masked forms nothing and writes zeros.
template <int D>
__global__ void __launch_bounds__(vr_bf16_threads<D, true>())
mha_bwd_dkv_bf16_staged(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const bf16* __restrict__ dout, const int* __restrict__ mask,
                        const float* __restrict__ ws_lse, const float* __restrict__ ws_di, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int Sq, int Skv, int H, long long q_sb, long long q_ss,
                        long long k_sb, long long k_ss, long long v_sb, long long v_ss, long long do_sb,
                        long long do_ss, float sm_scale) {
  constexpr int QS = vr_bf16_slot<D>(), SUB = vr_bf16_sub<D>(), DO = vr_bf16_cols<D, true>(), ROWS = vr_bf16_rows<D>();
  constexpr int THREADS = vr_bf16_threads<D, true>(), LD = ldb<D>(), ROW_WARPS = ROWS / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);          // [ROWS][LD]
  bf16* vs = ks + ROWS * LD;                             // [ROWS][LD]
  bf16* qs = vs + ROWS * LD;                             // [QS][LD]
  bf16* dos = qs + QS * LD;                              // [QS][LD]
  float* lse_s = reinterpret_cast<float*>(dos + QS * LD);  // [QS]
  float* di_s = lse_s + QS;                              // [QS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * ROWS, r0 = 16 * (warp % ROW_WARPS);
  const int grp = warp / ROW_WARPS, col0 = grp * DO;  // this warp's dk and dv columns: col0 + [0, DO)
  const int row = n0 + r0 + g;                        // this thread's keys: row, row + 8
  const long long o_ss = (long long)H * D;
  bf16* dkb = dk + (long long)b * Skv * o_ss + h * D;
  bf16* dvb = dv + (long long)b * Skv * o_ss + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;

  bool any = mb == nullptr;
  for (int t = 0; !any && t < ROWS / 16; ++t) any = tile_live<16>(mb + n0, t);
  if (!any) {  // every key masked: dk = dv = 0
    for (int i = threadIdx.x; i < ROWS * (D / 8); i += THREADS) {
      const long long at = (long long)(n0 + i / (D / 8)) * o_ss + (i % (D / 8)) * 8;
      *reinterpret_cast<int4*>(dkb + at) = make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(dvb + at) = make_int4(0, 0, 0, 0);
    }
    return;
  }

  const float* wl = ws_lse + ((long long)b * H + h) * Sq;
  const float* wd = ws_di + ((long long)b * H + h) * Sq;
  const bool keep[2] = {mb == nullptr || mb[row] != 0, mb == nullptr || mb[row + 8] != 0};
  const bool warp_live = mb == nullptr || tile_live<16>(mb + n0 + r0, 0);
  const int n_steps = (Sq + QS - 1) / QS;

  float dk_acc[DO / 8][4], dv_acc[DO / 8][4];
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dn][e] = dv_acc[dn][e] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    if (t == 0) {
      stage_bf16_rows<D, ROWS, THREADS>(ks, k + b * k_sb + h * D, k_ss, n0, Skv);
      stage_bf16_rows<D, ROWS, THREADS>(vs, v + b * v_sb + h * D, v_ss, n0, Skv);
    }
    stage_bf16_rows<D, QS, THREADS>(qs, q + b * q_sb + h * D, q_ss, t * QS, Sq);
    stage_bf16_rows<D, QS, THREADS>(dos, dout + b * do_sb + h * D, do_ss, t * QS, Sq);
    for (int i = threadIdx.x; i < QS; i += THREADS) {
      const int r = t * QS + i;
      lse_s[i] = r < Sq ? wl[r] : INFINITY;
      di_s[i] = r < Sq ? wd[r] : 0.f;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (warp_live) {
#pragma unroll 1
      for (int q0 = 0; q0 < QS && t * QS + q0 < Sq; q0 += SUB) {
        const bf16* qt = qs + q0 * LD;
        const bf16* dot = dos + q0 * LD;
        // p^T [key, query] = exp(k.q^T * scale - lse[query]), masked by key; dp^T = v.dO^T
        float p[SUB / 8][4], dp[SUB / 8][4];
        rows_dot_bf16_ldsm<D, SUB, LD>(p, ks, r0, qt, lane);
        rows_dot_bf16_ldsm<D, SUB, LD>(dp, vs, r0, dot, lane);
#pragma unroll
        for (int nt = 0; nt < SUB / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = keep[e >> 1] ? p[nt][e] * sm_scale : MASK_VALUE;
            p[nt][e] = __expf(x - lse_s[q0 + nt * 8 + 2 * t4 + (e & 1)]);
          }
        scores_times_tile_bf16<DO, SUB, LD>(dv_acc, p, dot + col0, lane);  // dv += round(p^T).dO
#pragma unroll
        for (int nt = 0; nt < SUB / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[nt][e] = p[nt][e] * (dp[nt][e] - di_s[q0 + nt * 8 + 2 * t4 + (e & 1)]) * sm_scale;
        scores_times_tile_bf16<DO, SUB, LD>(dk_acc, dp, qt + col0, lane);  // dk += round(ds^T).Q
      }
    }
    __syncthreads();  // the slot is written again next step
  }

  // dk, dv [B, Skv, H, D] contiguous
  store_bf16_rows<DO>(dkb + col0, o_ss, row, dk_acc, t4, Skv);
  store_bf16_rows<DO>(dvb + col0, o_ss, row, dv_acc, t4, Skv);
}

// dq, dk and dv of a (batch, head) whose valid query rows are one CTA's
// (Sq <= vr_bf16_rows: the UNets'), in one kernel, as the TPU kernel forms
// them (one program a batch and head): Q and dO come once, with the K and V
// of the row's first slot, while the mask row is read (a padded row's
// attended keys come first; else the live keys are requested anew), then
// the live keys a slot at a time, K beside V. A warp forms
// its rows' s and dp over the whole of D; p = exp(s - lse) and di = rowsum(p *
// dp) from the fp32 p (over the whole row: where the live keys are more than
// a slot, a first pass over the slots sums di); ds = p * (dp - di) * scale; dq
// += round(ds).K from the warp's registers; round(p) and round(ds) go to
// shared memory in V's place, where the warps take the slot's keys: dv =
// round(p)^T.dO and dk = round(ds)^T.Q over every valid query, complete for
// those keys. The keys of the tiles without an attended key get dk = dv = 0.
// No workspace and no second launch: Q, dO, K and V are read once. At B=128,
// H=2 it took 0.0468 / 0.0595 / 0.0354 / 0.0434 ms at D = 192 / 256 / 384 /
// 512 against the two kernels' 0.0725 / 0.0919 / 0.0451 / 0.0556, and
// 0.0473 / 0.0606 / 0.0386 / 0.0476 with K and V requested once the mask row
// is read (scripts/d3_valid_variants.py, split, no_spec; NVIDIA H100 80GB
// HBM3, 700 W).
template <int D>
__global__ void __launch_bounds__(vr_bf16_threads<D, true>())
mha_bwd_fused_bf16_staged(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const bf16* __restrict__ dout, const int* __restrict__ mask, const float* __restrict__ lse,
                   bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int H,
                   long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                   long long do_sb, long long do_ss, float sm_scale) {
  constexpr int KT = VR_BF16_TILE, SLOT = vr_bf16_slot<D>(), CT = SLOT / KT, DO = vr_bf16_cols<D, true>();
  constexpr int ROWS = vr_bf16_rows<D>(), THREADS = vr_bf16_threads<D, true>(), LD = ldb<D>();
  constexpr int ROW_WARPS = ROWS / 16, LDP = SLOT + 8;
  static_assert(2 * ROWS * LDP <= SLOT * LD, "p and ds fit in V's place");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LD]
  bf16* dos = qs + ROWS * LD;                    // [ROWS][LD]
  bf16* ks = dos + ROWS * LD;                    // [SLOT][LD]
  bf16* vs = ks + SLOT * LD;                     // [SLOT][LD]; then p and ds, [ROWS][LDP] each
  bf16* ps = vs;
  bf16* dss = vs + ROWS * LDP;
  int* live = reinterpret_cast<int*>(vs + SLOT * LD);  // [Skv / KT + 1]: live tiles, count
  int* dead = live + Skv / KT + 1;                      // [Skv / KT]: 1 for a tile without an attended key

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, r0 = 16 * (warp % ROW_WARPS);
  const int grp = warp / ROW_WARPS, col0 = grp * DO;  // this warp's output columns: col0 + [0, DO)
  const int row = r0 + g;                             // this thread's query rows, and slot keys: row, row + 8
  const bool active = r0 < Sq;                        // the warp has a valid query row
  const long long o_ss = (long long)H * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  const int n_tiles = Skv / KT;
  const float lse_r[2] = {row < Sq ? lse[((long long)b * Sq + row) * H + h] : INFINITY,
                          row + 8 < Sq ? lse[((long long)b * Sq + row + 8) * H + h] : INFINITY};
  // Q, dO, and K and V of the row's first SLOT keys (a padded row's first slot) land while the mask is read
  stage_bf16_rows<D, ROWS, THREADS>(qs, q + b * q_sb + h * D, q_ss, 0, Sq);
  stage_bf16_rows<D, ROWS, THREADS>(dos, dout + b * do_sb + h * D, do_ss, 0, Sq);
  stage_bf16_rows<D, SLOT, THREADS>(ks, k + b * k_sb + h * D, k_ss, 0, Skv);
  stage_bf16_rows<D, SLOT, THREADS>(vs, v + b * v_sb + h * D, v_ss, 0, Skv);
  cp_async_commit();
  find_live_tiles<KT>(live, mb, n_tiles);
  for (int t = threadIdx.x; t < n_tiles; t += THREADS) dead[t] = mb != nullptr && !tile_live<KT>(mb, t);
  __syncthreads();
  const int n_live = live[n_tiles], n_slots = (n_live + CT - 1) / CT;
  const bool kept = n_slots == 1;  // the same for every thread: one step a slot, p and dp in registers
  int resident = live_prefix<CT>(live, n_live) ? 0 : -1;  // the slot K and V hold

  bf16* dkb = dk + (long long)b * Skv * o_ss + h * D;
  bf16* dvb = dv + (long long)b * Skv * o_ss + h * D;
  for (int i = threadIdx.x; i < n_tiles * KT * (D / 8); i += THREADS) {  // dk = dv = 0 on the dead tiles' keys
    const int key = i / (D / 8);
    if (dead[key / KT]) {
      const long long at = (long long)key * o_ss + (i % (D / 8)) * 8;
      *reinterpret_cast<int4*>(dkb + at) = make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(dvb + at) = make_int4(0, 0, 0, 0);
    }
  }

  // s and dp of slot c for this warp's rows: p = exp(s - lse) in p, dp in dp
  auto scores = [&](float (&p)[SLOT / 8][4], float (&dp)[SLOT / 8][4], int c, int n) {
    rows_dot_bf16_ldsm<D, SLOT, LD>(p, qs, r0, ks, lane, n * KT);
    rows_dot_bf16_ldsm<D, SLOT, LD>(dp, dos, r0, vs, lane, n * KT);
    scale_and_mask_slot<SLOT, KT>(p, sm_scale, mb, live + c * CT, n, t4);
#pragma unroll
    for (int nt = 0; nt < SLOT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = __expf(p[nt][e] - lse_r[e >> 1]);
  };
  auto stage_slot = [&](int c, int n) {
    if (resident != c) {
      if (resident == -1) {  // the early loads land before K and V are requested anew
        cp_async_wait<0>();
        __syncthreads();
      }
      stage_bf16_tiles<D, KT, THREADS>(ks, k + b * k_sb + h * D, k_ss, live + c * CT, n);
      stage_bf16_tiles<D, KT, THREADS>(vs, v + b * v_sb + h * D, v_ss, live + c * CT, n);
      cp_async_commit();
      resident = c;
    }
    cp_async_wait<0>();
    __syncthreads();
  };

  float di[2] = {0.f, 0.f}, dq_acc[DO / 8][4];
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn) dq_acc[dn][0] = dq_acc[dn][1] = dq_acc[dn][2] = dq_acc[dn][3] = 0.f;
  for (int c = 0; !kept && c < n_slots; ++c) {  // the di pass over a row of more than a slot
    const int n = min(CT, n_live - c * CT);
    stage_slot(c, n);
    if (active) {
      float p[SLOT / 8][4], dp[SLOT / 8][4];
      scores(p, dp, c, n);
#pragma unroll
      for (int nt = 0; nt < SLOT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) di[e >> 1] += p[nt][e] * dp[nt][e];
    }
    __syncthreads();  // the slot is written again
  }
  if (!kept) {
    di[0] = quad_sum(di[0]);
    di[1] = quad_sum(di[1]);
  }

  for (int c = 0; c < n_slots; ++c) {
    const int n = min(CT, n_live - c * CT);
    stage_slot(c, n);
    float p[SLOT / 8][4], dp[SLOT / 8][4];
    if (active) {
      scores(p, dp, c, n);
      if (kept) {  // di over the whole key row: this slot
#pragma unroll
        for (int nt = 0; nt < SLOT / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) di[e >> 1] += p[nt][e] * dp[nt][e];
        di[0] = quad_sum(di[0]);
        di[1] = quad_sum(di[1]);
      }
#pragma unroll
      for (int nt = 0; nt < SLOT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nt][e] = p[nt][e] * (dp[nt][e] - di[e >> 1]) * sm_scale;  // ds
    }
    __syncthreads();  // V is read: p and ds take its place
    if (grp == 0) {  // round(p) and round(ds) of the warp's rows; zeros for rows without a valid query
      if (active) {
        put_bf16_c<SLOT, LDP>(ps, p, r0, g, t4);
        put_bf16_c<SLOT, LDP>(dss, dp, r0, g, t4);
      } else {
        for (int i = lane; i < 16 * SLOT / 8; i += 32) {
          const int at = (r0 + i / (SLOT / 8)) * LDP + (i % (SLOT / 8)) * 8;
          *reinterpret_cast<int4*>(ps + at) = make_int4(0, 0, 0, 0);
          *reinterpret_cast<int4*>(dss + at) = make_int4(0, 0, 0, 0);
        }
      }
    }
    if (active) {  // dq += round(ds).K
      uint32_t dsa[SLOT / 16][4];
      pack_a_bf16<SLOT>(dsa, dp);
      frags_times_tile_bf16<DO, SLOT, LD>(dq_acc, dsa, ks + col0, lane, n * KT);
    }
    __syncthreads();  // p and ds are whole
    for (int k0 = r0; k0 < n * KT; k0 += ROWS) {  // the slot's keys k0 + [0, 16): one live tile, every query
      const int key = live[c * CT + k0 / KT] * KT;
      float acc[DO / 8][4];
#pragma unroll
      for (int dn = 0; dn < DO / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
      tile_t_times_tile_bf16<DO, ROWS, LDP, LD>(acc, ps, k0, dos + col0, lane);  // dv = round(p)^T.dO
      store_bf16_rows<DO>(dvb + col0, o_ss, key + g, acc, t4, Skv);
#pragma unroll
      for (int dn = 0; dn < DO / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
      tile_t_times_tile_bf16<DO, ROWS, LDP, LD>(acc, dss, k0, qs + col0, lane);  // dk = round(ds)^T.Q
      store_bf16_rows<DO>(dkb + col0, o_ss, key + g, acc, t4, Skv);
    }
    __syncthreads();  // K, V, p and ds are written again
  }
  cp_async_wait<0>();  // Q's and dO's group, where no slot waited for it
  if (active) store_bf16_rows<DO>(dq + (long long)b * Sq * o_ss + h * D + col0, o_ss, row, dq_acc, t4, Sq);
}

template <int D>
__host__ __device__ constexpr size_t vr_bf16_fused_smem_bytes() {
  return 2 * ldb<D>() * (2 * vr_bf16_rows<D>() + 2 * vr_bf16_slot<D>());
}

template <int D>
__host__ __device__ constexpr size_t vr_bf16_staged_dq_smem_bytes() {
  return 2 * ldb<D>() * (2 * vr_bf16_rows<D>() + 2 * vr_bf16_slot<D>());
}

template <int D>
__host__ __device__ constexpr size_t vr_bf16_staged_dkv_smem_bytes() {
  return 2 * ldb<D>() * (2 * vr_bf16_rows<D>() + 2 * vr_bf16_slot<D>()) + sizeof(float) * 2 * vr_bf16_slot<D>();
}

// --- bf16 at D = 64 and 128: the Hopper kernels of attn_bwd_hopper.cuh ---------

// dq, and the workspace's lse2 and di: K5's kernel with the di pass, from K1's lse [B, Sq, H]
template <int D>
__global__ void __launch_bounds__(HB_THREADS, 1)
mha_bwd_dq_hopper(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tdq, const int* __restrict__ mask,
                  const float* __restrict__ lse, const float* __restrict__ di, float* __restrict__ ws, int Sq,
                  int Skv, int H, int ws_rs, float sm_scale) {
  bwd_dq_hopper<D, true>(tq, tk, tv, tdo, tdq, mask, lse, di, ws, Sq, Skv, H, ws_rs, sm_scale);
}

// dk, dv from the workspace: K4's kernel
template <int D>
__global__ void __launch_bounds__(HB_THREADS, 1)
mha_bwd_dkv_hopper(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
                   const int* __restrict__ mask, const float* __restrict__ ws, int Sq, int Skv, int H, int ws_rs,
                   float sm_scale) {
  bwd_dkv_hopper<D>(tq, tk, tv, tdo, tdk, tdv, mask, ws, Sq, Skv, H, ws_rs, sm_scale);
}

// --- launches -------------------------------------------------------------------

// the fp32 dq kernel (p and dp kept where f32_keeps, else formed again),
// then the dk/dv kernel; a.ws holds lse, then di, rows (b, h) Sq apart
template <int D>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  static bool configured[3][MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = current_device(device);
  if (err != cudaSuccess) return err;
  float* ws_lse = a.ws;
  float* ws_di = a.ws + (long long)a.B * a.H * a.Sq;
  const dim3 grid_q(a.Sq / F32_ROWS, a.H, a.B);
  const bool keep = f32_keeps<D>(a.Skv);
  if constexpr (D <= 64) {
    if (keep) {
      err = allow_smem(mha_bwd_dq_kept_tf32x3<D>, configured[0], device);
      if (err != cudaSuccess) return err;
      mha_bwd_dq_kept_tf32x3<D><<<grid_q, KEPT_THREADS, dq_kept_smem_bytes<D>(a.Skv), stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
          static_cast<const float*>(a.dout), a.mask, a.lse, ws_lse, ws_di, static_cast<float*>(a.dq), a.Sq, a.Skv,
          a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale);
    }
  }
  if (!keep) {
    static_assert(dq_smem_bytes<D>() <= SMEM_LIMIT && dkv_smem_bytes<D>() <= SMEM_LIMIT,
                  "the fp32 K2's tiles exceed shared memory");
    err = allow_smem(mha_bwd_dq_tf32x3<D>, configured[1], device);
    if (err != cudaSuccess) return err;
    mha_bwd_dq_tf32x3<D><<<grid_q, F32_THREADS, dq_smem_bytes<D>(), stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
        static_cast<const float*>(a.dout), a.mask, a.lse, ws_lse, ws_di, static_cast<float*>(a.dq), a.Sq, a.Skv,
        a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale);
  }
  err = cudaGetLastError();
  if (err == cudaSuccess) err = allow_smem(mha_bwd_dkv_tf32x3<D>, configured[2], device);
  if (err != cudaSuccess) return err;
  mha_bwd_dkv_tf32x3<D><<<dim3(a.Skv / F32_ROWS, a.H, a.B), F32_THREADS, dkv_smem_bytes<D>(), stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.dout), a.mask, ws_lse, ws_di, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.Sq, a.Skv, a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb,
      a.do_ss, a.sm_scale);
  return cudaGetLastError();
}

// the fp32 dq kernel, then the dk/dv kernel, built around the valid rows (D
// = 64, 192-512); a.ws holds lse, then di, rows (b, h) Sq apart
template <int D>
cudaError_t launch_f32_valid(const Args& a, cudaStream_t stream) {
  static bool configured[2][MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = current_device(device);
  if (err == cudaSuccess) err = allow_smem(mha_bwd_dq_tf32x3_valid<D>, configured[0], device);
  if (err == cudaSuccess) err = allow_smem(mha_bwd_dkv_tf32x3_valid<D>, configured[1], device);
  if (err != cudaSuccess) return err;
  static_assert(vr_dq_smem_bytes<D>() <= SMEM_LIMIT && vr_dkv_smem_bytes<D>() <= SMEM_LIMIT,
                "the fp32 K2's tiles exceed shared memory");
  float* ws_lse = a.ws;
  float* ws_di = a.ws + (long long)a.B * a.H * a.Sq;
  constexpr int ROWS = vr_rows<D>();
  const size_t dq_smem = vr_dq_smem_bytes<D>() + vr_live_bytes(a.Skv, vr_tile<D>());
  if (dq_smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  mha_bwd_dq_tf32x3_valid<D><<<dim3((a.Sq + ROWS - 1) / ROWS, a.H, a.B), vr_threads<D>(), dq_smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.dout), a.mask, a.lse, ws_lse, ws_di, static_cast<float*>(a.dq), a.Sq, a.Skv, a.H,
      a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_bwd_dkv_tf32x3_valid<D><<<dim3(a.Skv / ROWS, a.H, a.B), vr_threads<D>(), vr_dkv_smem_bytes<D>(), stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.dout), a.mask, ws_lse, ws_di, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.Sq, a.Skv, a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale);
  return cudaGetLastError();
}

// the staged fp32 K2 at D = 256 and 512: one kernel a (batch, head); no workspace
template <int D>
cudaError_t launch_f32_staged(const Args& a, cudaStream_t stream) {
  static bool configured[MAX_DEVICES] = {};
  auto kernel = mha_bwd_fused_tf32x3_staged<D>;
  int device = 0;
  cudaError_t err = current_device(device);
  if (err == cudaSuccess) err = allow_smem(kernel, configured, device);
  if (err != cudaSuccess) return err;
  static_assert(vr_f32s_bwd_smem_bytes<D>() <= SMEM_LIMIT, "the fp32 K2's tiles exceed shared memory");
  const size_t smem = vr_f32s_bwd_smem_bytes<D>() + vr_live_bytes(a.Skv, VR_TILE) + sizeof(int) * (a.Skv / VR_TILE);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  kernel<<<dim3(1, a.H, a.B), VR_F32S_BWD_THREADS, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.dout), a.mask, a.lse, static_cast<float*>(a.dq), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.Sq, a.Skv, a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss,
      a.sm_scale);
  return cudaGetLastError();
}

// the bf16 dq kernel, then the dk/dv kernel, built around the valid rows (D
// = 64, 192-512); a.ws holds lse, then di, rows (b, h) Sq apart
template <int D>
cudaError_t launch_bf16_valid(const Args& a, cudaStream_t stream) {
  static bool configured[2][MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = current_device(device);
  if (err == cudaSuccess) err = allow_smem(mha_bwd_dq_bf16_valid<D>, configured[0], device);
  if (err == cudaSuccess) err = allow_smem(mha_bwd_dkv_bf16_valid<D>, configured[1], device);
  if (err != cudaSuccess) return err;
  static_assert(vr_bf16_dq_smem_bytes<D>() <= SMEM_LIMIT && vr_bf16_dkv_smem_bytes<D>() <= SMEM_LIMIT,
                "the bf16 K2's tiles exceed shared memory");
  float* ws_lse = a.ws;
  float* ws_di = a.ws + (long long)a.B * a.H * a.Sq;
  constexpr int ROWS = vr_rows<D>();
  const size_t dq_smem = vr_bf16_dq_smem_bytes<D>() + vr_live_bytes(a.Skv, vr_bf16_tile<D>());
  if (dq_smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  mha_bwd_dq_bf16_valid<D><<<dim3((a.Sq + ROWS - 1) / ROWS, a.H, a.B), vr_threads<D>(), dq_smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), a.mask, a.lse, ws_lse, ws_di, static_cast<bf16*>(a.dq), a.Sq, a.Skv, a.H,
      a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_bwd_dkv_bf16_valid<D><<<dim3(a.Skv / ROWS, a.H, a.B), vr_threads<D>(), vr_bf16_dkv_smem_bytes<D>(),
                              stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), a.mask, ws_lse, ws_di, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.Sq, a.Skv, a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale);
  return cudaGetLastError();
}

// the staged bf16 K2 at D = 192-512: where the valid query rows are one
// CTA's, the fused kernel; else the dq kernel, then the dk/dv kernel, a.ws
// holding lse, then di, rows (b, h) Sq apart
template <int D>
cudaError_t launch_bf16_staged(const Args& a, cudaStream_t stream) {
  static bool configured[2][MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = current_device(device);
  if (err == cudaSuccess) err = allow_smem(mha_bwd_dq_bf16_staged<D>, configured[0], device);
  if (err == cudaSuccess) err = allow_smem(mha_bwd_dkv_bf16_staged<D>, configured[1], device);
  if (err != cudaSuccess) return err;
  static_assert(vr_bf16_staged_dq_smem_bytes<D>() <= SMEM_LIMIT && vr_bf16_staged_dkv_smem_bytes<D>() <= SMEM_LIMIT,
                "the bf16 K2's tiles exceed shared memory");
  constexpr int ROWS = vr_bf16_rows<D>();
  if (a.Sq <= ROWS) {  // one kernel a (batch, head)
    static bool fused_configured[MAX_DEVICES] = {};
    static_assert(vr_bf16_fused_smem_bytes<D>() <= SMEM_LIMIT, "the bf16 K2's tiles exceed shared memory");
    err = allow_smem(mha_bwd_fused_bf16_staged<D>, fused_configured, device);
    if (err != cudaSuccess) return err;
    const size_t smem = vr_bf16_fused_smem_bytes<D>() + vr_live_bytes(a.Skv, VR_BF16_TILE) +
                        sizeof(int) * (a.Skv / VR_BF16_TILE);
    if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
    mha_bwd_fused_bf16_staged<D><<<dim3(1, a.H, a.B), vr_bf16_threads<D, true>(), smem, stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
        static_cast<const bf16*>(a.dout), a.mask, a.lse, static_cast<bf16*>(a.dq), static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.Sq, a.Skv, a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb,
        a.do_ss, a.sm_scale);
    return cudaGetLastError();
  }
  float* ws_lse = a.ws;
  float* ws_di = a.ws + (long long)a.B * a.H * a.Sq;
  const size_t dq_smem = vr_bf16_staged_dq_smem_bytes<D>() + vr_live_bytes(a.Skv, VR_BF16_TILE);
  if (dq_smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  mha_bwd_dq_bf16_staged<D><<<dim3((a.Sq + ROWS - 1) / ROWS, a.H, a.B), vr_bf16_threads<D, true>(), dq_smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), a.mask, a.lse, ws_lse, ws_di, static_cast<bf16*>(a.dq), a.Sq, a.Skv, a.H,
      a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_bwd_dkv_bf16_staged<D><<<dim3(a.Skv / ROWS, a.H, a.B), vr_bf16_threads<D, true>(),
                               vr_bf16_staged_dkv_smem_bytes<D>(), stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), a.mask, ws_lse, ws_di, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.Sq, a.Skv, a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 1) {
    if constexpr (D >= 64) {
      static bool dq_configured[MAX_DEVICES] = {}, dkv_configured[MAX_DEVICES] = {};
      const cudaError_t err = launch_dq_hopper<D>(mha_bwd_dq_hopper<D>, dq_configured, a, stream);
      if (err != cudaSuccess) return err;
      return launch_dkv_hopper<D>(mha_bwd_dkv_hopper<D>, dkv_configured, a, stream);
    } else {
      const dim3 grid_q(a.Sq / BLOCK, a.H, a.B), grid_kv(a.Skv / BLOCK, a.H, a.B);
      mha_bwd_dq_bf16<D><<<grid_q, WARPS * 32, 0, stream>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
          static_cast<const bf16*>(a.dout), a.mask, a.lse, a.ws, static_cast<bf16*>(a.dq), a.Sq, a.Skv,
          a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      mha_bwd_dkv_bf16<D><<<grid_kv, WARPS * 32, 0, stream>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
          static_cast<const bf16*>(a.dout), a.mask, a.lse, a.ws, static_cast<bf16*>(a.dk),
          static_cast<bf16*>(a.dv), a.Sq, a.Skv, a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss,
          a.do_sb, a.do_ss, a.sm_scale);
      return cudaGetLastError();
    }
  }
  return launch_f32<D>(a, stream);
}

}  // namespace

// q/do: [B, Sq, H, D], k/v: [B, Skv, H, D], each with unit stride over D,
// stride D over heads and the given batch/row strides (in elements; 16-byte
// aligned rows); Skv a multiple of 64; D in {16, 32, 64, 128, 192, 256, 384,
// 512}; dtype 0 = fp32, 1 = bf16; valid_rows 1: the instances built around
// the valid rows (any Sq, the unpadded query rows; the only ones at D =
// 192-512, beside the padded ones at D = 64: the caller picks them by shape,
// ops/fused_mha.py::takes_valid_rows), 0: the padded ones (Sq a multiple of
// 64); mask: int32 [B, Skv] (nonzero = attend) or null; lse: contiguous fp32
// [B, Sq, H] from the forward; ws: fp32 workspace of 2 * B * H * Sq (the
// padded bf16 instances at D = 64, 128: lse * log2 e, then di, rows (b, h)
// Sq apart; fp32, and the valid-rows bf16 ones: lse, then di, rows (b, h) Sq
// apart; bf16 at D = 16, 32: di [B, Sq, H] in its first B * Sq * H). fp32
// keeps p and dp in shared memory between the padded dq kernel's passes where
// f32_keeps. dq/dk/dv: contiguous, in the input dtype. Launches on `stream`
// of the current device.
extern "C" int fused_mha_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* mask, const void* lse, void* ws, void* dq, void* dk,
                             void* dv, int B, int Sq, int Skv, int H, int D, long long q_sb,
                             long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                             long long v_ss, long long do_sb, long long do_ss, float sm_scale,
                             int dtype, int valid_rows, void* stream) {
  // the valid-rows instances take the unpadded query rows
  const bool any_rows = valid_rows != 0;
  if (Sq < 1 || Skv < 1 || (!any_rows && Sq % BLOCK != 0) || Skv % BLOCK != 0 || (dtype != 0 && dtype != 1) ||
      (valid_rows != 0 && valid_rows != 1) || (any_rows && !has_valid_rows_instance(D)) ||
      (!any_rows && valid_rows_instance(D)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, nullptr, dout, static_cast<const int*>(mask), static_cast<const float*>(lse),
               static_cast<float*>(ws), nullptr, dq, dk, dv, B, Sq, Skv, H, Sq,
               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, 0, 0, do_sb, do_ss, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16: err = launch<16>(dtype, a, s); break;
    case 32: err = launch<32>(dtype, a, s); break;
    case 64:
      err = !any_rows ? launch<64>(dtype, a, s) : dtype == 0 ? launch_f32_valid<64>(a, s) : launch_bf16_valid<64>(a, s);
      break;
    case 128: err = launch<128>(dtype, a, s); break;
    case 192: err = dtype == 0 ? launch_f32_valid<192>(a, s) : launch_bf16_staged<192>(a, s); break;
    case 256: err = dtype == 0 ? launch_f32_staged<256>(a, s) : launch_bf16_staged<256>(a, s); break;
    case 384: err = dtype == 0 ? launch_f32_valid<384>(a, s) : launch_bf16_staged<384>(a, s); break;
    case 512: err = dtype == 0 ? launch_f32_staged<512>(a, s) : launch_bf16_staged<512>(a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// [Sq x Skv x D] products the fp32 backward runs at head dim D and Skv keys,
// by the rule its launch follows: the dq kernel's s and dp, then dq (and s and
// dp again unless f32_keeps), and the dk/dv kernel's s, dv, dp and dk; 0 for
// another D. At D <= 128 the padded instances' (the valid-rows instance at D
// = 64 runs 5 + 4 over the live key tiles, as at 192 and 384, or 3 + 4 where
// its dq kernel keeps p and dp, vr_dq_keep); the staged instance at 256 and
// 512 forms s and dp once, then dq, dk and dv (5, over the live keys of a
// one-slot row)
extern "C" int fused_mha_bwd_f32_products(int D, int Skv) {
  switch (D) {
    case 16: return (f32_keeps<16>(Skv) ? 3 : 5) + 4;
    case 32: return (f32_keeps<32>(Skv) ? 3 : 5) + 4;
    case 64: return (f32_keeps<64>(Skv) ? 3 : 5) + 4;
    case 128: return (f32_keeps<128>(Skv) ? 3 : 5) + 4;
    case 192: case 384: return 5 + 4;  // over the live key tiles alone
    case 256: case 512: return 5;
    default: return 0;
  }
}

// column groups of warps whose partial score tiles are summed in shared
// memory, in the fp32 dq and dk/dv kernels at head dim D, by the rule their
// launch follows: vr_groups at 192 and 384, 1 where a warp forms the products
// over the whole of D (the staged instance at 256 and 512 too); 0 for another
// D. The emulation in ops/fused_mha.py (f32_groups) mirrors it.
extern "C" int fused_mha_bwd_f32_groups(int D) {
  switch (D) {
    case 16: case 32: case 64: case 128: case 256: case 512: return 1;
    case 192: return vr_groups<192>();
    case 384: return vr_groups<384>();
    default: return 0;
  }
}

// the staged bf16 K2 at the valid-rows head dims, by the rules its launch
// follows: keys (dq kernel) or queries (dk/dv kernel) of a staged slot (what =
// 0), column groups of warps (what = 1); 0 for another D. ops/fused_mha.py
// (bf16_keys, bf16_groups) mirrors them.
extern "C" int fused_mha_bwd_bf16_tiles(int D, int what) {
  switch (D) {
    case 192: return what == 0 ? vr_bf16_slot<192>() : vr_bf16_groups<192, true>();
    case 256: return what == 0 ? vr_bf16_slot<256>() : vr_bf16_groups<256, true>();
    case 384: return what == 0 ? vr_bf16_slot<384>() : vr_bf16_groups<384, true>();
    case 512: return what == 0 ? vr_bf16_slot<512>() : vr_bf16_groups<512, true>();
    default: return 0;
  }
}

// the instances of K2 built around the valid rows at head dim D in dtype (0
// fp32, 1 bf16), by the rules their launch follows: keys (dq kernel) or
// queries (dk/dv kernel) of a ring (or staged) slot (what = 0), column groups
// of warps (what = 1), rows a CTA (what = 3); 0 where D has no such instance
// (and for what = 2, which the forward's export uses for its kept slots). The
// staged fp32 instance at 256 and 512 (one group: no warp splits the
// columns) also reports the columns of a stage (what = 4), the key parts of
// its score warps (what = 5) and its score partials a stage (what = 6); what
// >= 4 is 0 elsewhere. ops/fused_mha.py (f32_keys and bf16_keys with valid_rows,
// f32_groups, bf16_groups, bf16_rows, f32_staged) mirrors them.
extern "C" int fused_mha_bwd_valid_tiles(int D, int dtype, int what) {
  if (what >= 4) {
#define K2_TILES_STAGED(DD)                                                                                   \
  if (D == DD && dtype == 0)                                                                                  \
    return what == 4 ? vr_f32s_chunk<DD>() : what == 5 ? vr_f32s_key_parts<DD>() : what == 6 ? vr_f32s_parts<DD>() \
                                                                                              : 0;
    K2_TILES_STAGED(256) K2_TILES_STAGED(512)
#undef K2_TILES_STAGED
    return 0;
  }
  if (D == 64)
    return what == 0 ? (dtype == 1 ? vr_bf16_tile<64>() : vr_tile<64>()) : what == 1 ? vr_groups<64>()
         : what == 2 ? 0 : vr_rows<64>();
#define K2_TILES_ANY(DD)                                                                                        \
  if (D == DD)                                                                                                  \
    return what == 2 ? 0                                                                                        \
         : dtype == 1 ? (what == 0 ? vr_bf16_slot<DD>() : what == 1 ? vr_bf16_groups<DD, true>() : vr_bf16_rows<DD>()) \
         : staged_f32_instance(DD) ? (what == 0 ? vr_f32s_slot<DD>() : what == 1 ? 1 : vr_f32s_rows<DD>())            \
                      : (what == 0 ? vr_tile<DD>() : what == 1 ? vr_groups<DD>() : vr_rows<DD>());
  K2_TILES_ANY(192) K2_TILES_ANY(256) K2_TILES_ANY(384) K2_TILES_ANY(512)
#undef K2_TILES_ANY
  return 0;
}

extern "C" const char* dl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
