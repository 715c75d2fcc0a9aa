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
// operands along the staged rows by ldmatrix.trans. fp32 inputs run the same
// two kernels with one thread per row and fp32 FMAs (the tensor cores take no
// exact fp32 product); each thread's own q/do (or k/v) row sits in padded
// shared memory.
//
// Plain C interface (bound with ctypes): fused_mha_bwd launches both kernels
// on the given stream and returns the first CUDA error.

#include <math.h>
#include <stdint.h>

#include "attn_bwd_hopper.cuh"  // K4/K5's Hopper kernels; hopper.cuh: MASK_VALUE, bf16, pack_bf16, quad_sum

namespace {

constexpr int BLOCK = 64;     // rows per CTA, and rows per staged tile (D = 16, 32 and fp32)
constexpr int WARPS = 4;      // bf16 kernels at D = 16, 32: 16 rows per warp
constexpr int CHUNK = 32;     // score columns held in registers at a time
constexpr int PAD = 8;        // bf16 elements of padding per shared-memory row
constexpr int F32_TILE = 16;  // fp32 kernels: rows of the other operand per staged tile

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8x8 bf16 matrices from shared memory, transposed: lanes 8i..8i+7 give
// the row addresses of matrix i, whose fragment lands in r[i]
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

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
      mma_16816(c[nt], af[kk], b);
    }
  }
}

// acc[16 rows x D] += round_bf16(x[16 rows x CHUNK]) . T[c0 .. c0 + CHUNK)[0 .. D):
// x in the C layout of rows_dot_tile becomes the A operand in registers; T's
// rows are the reduction axis, read with ldmatrix.trans.
template <int D>
__device__ __forceinline__ void chunk_times_tile(float acc[D / 8][4], const float x[CHUNK / 8][4],
                                                 Tile<D> ts, int c0, int lane) {
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
      chunk_times_tile<D>(acc, dp, ks, c0, lane);
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
      chunk_times_tile<D>(dv_acc, p, dos, c0, lane);  // dv += round(p)^T . do
      rows_dot_tile<D>(dp, vf, dos, c0, g, t4);       // dp^T = v . do^T
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dp[nt][j] = p[nt][j] * (dp[nt][j] - di_s[c0 + nt * 8 + 2 * t4 + (j & 1)]) * sm_scale;
      chunk_times_tile<D>(dk_acc, dp, qs, c0, lane);  // dk += round(ds)^T . q
    }
  }

  // dk, dv [B, Skv, H, D] contiguous
  const long long o_ss = (long long)H * D;
  store_rows<D>(dk + (long long)b * Skv * o_ss + h * D, o_ss, row0, dk_acc, t4);
  store_rows<D>(dv + (long long)b * Skv * o_ss + h * D, o_ss, row0, dv_acc, t4);
}

// --- fp32 -------------------------------------------------------------------

// shared memory of the fp32 kernels: the CTA's own rows (two operands,
// padded to D + 1 so that a warp reading one column of 32 rows hits 32
// banks) and a staged tile of F32_TILE rows of the other two operands
template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (2 * BLOCK * (D + 1) + 2 * F32_TILE * D + 2 * F32_TILE);
}

template <int D>
__device__ __forceinline__ void stage_own_rows(float* dst, const float* src, long long row_stride, int r0) {
  for (int i = threadIdx.x; i < BLOCK * D; i += BLOCK)
    dst[(i / D) * (D + 1) + i % D] = src[(long long)(r0 + i / D) * row_stride + i % D];
}

template <int D>
__device__ __forceinline__ void stage_f32_tile(float* dst, const float* src, long long row_stride, int r0) {
  for (int i = threadIdx.x; i < F32_TILE * D; i += BLOCK)
    dst[i] = src[(long long)(r0 + i / D) * row_stride + i % D];
}

template <int D>
__device__ __forceinline__ float dot_row(const float* own, const float* other) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) acc = fmaf(own[d], other[d], acc);
  return acc;
}

template <int D>
__global__ void __launch_bounds__(BLOCK)
mha_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
               const float* __restrict__ dout, const int* __restrict__ mask,
               const float* __restrict__ lse, float* __restrict__ di_out, float* __restrict__ dq,
               int Sq, int Skv, int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
               long long v_sb, long long v_ss, long long do_sb, long long do_ss, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [BLOCK][D + 1]
  float* dos = qs + BLOCK * (D + 1);   // [BLOCK][D + 1]
  float* ks = dos + BLOCK * (D + 1);   // [F32_TILE][D]
  float* vs = ks + F32_TILE * D;       // [F32_TILE][D]

  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int m0 = blockIdx.x * BLOCK, row = m0 + tid;
  const float* kb = k + b * k_sb + h * D;
  const float* vb = v + b * v_sb + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;

  stage_own_rows<D>(qs, q + b * q_sb + h * D, q_ss, m0);
  stage_own_rows<D>(dos, dout + b * do_sb + h * D, do_ss, m0);
  const float* qr = qs + tid * (D + 1);
  const float* dr = dos + tid * (D + 1);
  const float lse_r = lse[((long long)b * Sq + row) * H + h];

  // pass 1: di = rowsum(p * dp)
  float di = 0.f;
  for (int n0 = 0; n0 < Skv; n0 += F32_TILE) {
    __syncthreads();
    stage_f32_tile<D>(ks, kb, k_ss, n0);
    stage_f32_tile<D>(vs, vb, v_ss, n0);
    __syncthreads();
    for (int j = 0; j < F32_TILE; ++j) {
      const float x = (mb == nullptr || mb[n0 + j] != 0) ? dot_row<D>(qr, ks + j * D) * sm_scale : MASK_VALUE;
      di += expf(x - lse_r) * dot_row<D>(dr, vs + j * D);
    }
  }

  // pass 2: ds = p * (dp - di) * scale; dq += ds . K
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int n0 = 0; n0 < Skv; n0 += F32_TILE) {
    __syncthreads();
    stage_f32_tile<D>(ks, kb, k_ss, n0);
    stage_f32_tile<D>(vs, vb, v_ss, n0);
    __syncthreads();
    for (int j = 0; j < F32_TILE; ++j) {
      const float x = (mb == nullptr || mb[n0 + j] != 0) ? dot_row<D>(qr, ks + j * D) * sm_scale : MASK_VALUE;
      const float p = expf(x - lse_r);
      const float ds = p * (dot_row<D>(dr, vs + j * D) - di) * sm_scale;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, ks[j * D + d], acc[d]);
    }
  }
  float* out = dq + ((long long)b * Sq + row) * H * D + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) out[d] = acc[d];
  di_out[((long long)b * Sq + row) * H + h] = di;
}

template <int D>
__global__ void __launch_bounds__(BLOCK)
mha_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ dout, const int* __restrict__ mask,
                const float* __restrict__ lse, const float* __restrict__ di, float* __restrict__ dk,
                float* __restrict__ dv, int Sq, int Skv, int H, long long q_sb, long long q_ss,
                long long k_sb, long long k_ss, long long v_sb, long long v_ss, long long do_sb,
                long long do_ss, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                      // [BLOCK][D + 1]
  float* vs = ks + BLOCK * (D + 1);      // [BLOCK][D + 1]
  float* qt = vs + BLOCK * (D + 1);      // [F32_TILE][D]
  float* dt = qt + F32_TILE * D;         // [F32_TILE][D]
  float* lse_t = dt + F32_TILE * D;      // [F32_TILE]
  float* di_t = lse_t + F32_TILE;        // [F32_TILE]

  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int n0 = blockIdx.x * BLOCK, row = n0 + tid;
  const float* qb = q + b * q_sb + h * D;
  const float* dob = dout + b * do_sb + h * D;
  const bool keep = mask == nullptr || mask[(long long)b * Skv + row] != 0;

  stage_own_rows<D>(ks, k + b * k_sb + h * D, k_ss, n0);
  stage_own_rows<D>(vs, v + b * v_sb + h * D, v_ss, n0);
  const float* kr = ks + tid * (D + 1);
  const float* vr = vs + tid * (D + 1);

  float dk_acc[D], dv_acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dk_acc[d] = dv_acc[d] = 0.f;
  for (int m0 = 0; m0 < Sq; m0 += F32_TILE) {
    __syncthreads();
    stage_f32_tile<D>(qt, qb, q_ss, m0);
    stage_f32_tile<D>(dt, dob, do_ss, m0);
    if (tid < F32_TILE) {
      lse_t[tid] = lse[((long long)b * Sq + m0 + tid) * H + h];
      di_t[tid] = di[((long long)b * Sq + m0 + tid) * H + h];
    }
    __syncthreads();
    for (int j = 0; j < F32_TILE; ++j) {
      const float x = keep ? dot_row<D>(kr, qt + j * D) * sm_scale : MASK_VALUE;
      const float p = expf(x - lse_t[j]);
      const float ds = p * (dot_row<D>(vr, dt + j * D) - di_t[j]) * sm_scale;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv_acc[d] = fmaf(p, dt[j * D + d], dv_acc[d]);
        dk_acc[d] = fmaf(ds, qt[j * D + d], dk_acc[d]);
      }
    }
  }
  const long long out_off = ((long long)b * Skv + row) * H * D + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk[out_off + d] = dk_acc[d];
    dv[out_off + d] = dv_acc[d];
  }
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
  const dim3 grid_q(a.Sq / BLOCK, a.H, a.B), grid_kv(a.Skv / BLOCK, a.H, a.B);
  constexpr size_t smem = f32_smem_bytes<D>();
  static bool configured = false;  // shared memory beyond 48 KB needs the opt-in (D = 128)
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(mha_bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mha_bwd_dkv_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  mha_bwd_dq_f32<D><<<grid_q, BLOCK, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.dout), a.mask, a.lse, a.ws, static_cast<float*>(a.dq), a.Sq, a.Skv,
      a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_bwd_dkv_f32<D><<<grid_kv, BLOCK, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.dout), a.mask, a.lse, a.ws, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.Sq, a.Skv, a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss,
      a.do_sb, a.do_ss, a.sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q/do: [B, Sq, H, D], k/v: [B, Skv, H, D], each with unit stride over D,
// stride D over heads and the given batch/row strides (in elements; 16-byte
// aligned rows); Sq, Skv multiples of 64; D in {16, 32, 64, 128}; dtype 0 =
// fp32, 1 = bf16; mask: int32 [B, Skv] (nonzero = attend) or null; lse:
// contiguous fp32 [B, Sq, H] from the forward; ws: fp32 workspace of 2 * B *
// H * Sq (bf16 at D = 64, 128: lse * log2 e, then di, rows (b, h) Sq apart;
// otherwise di in its first B * Sq * H). dq/dk/dv: contiguous, in the input
// dtype. Launches on `stream` of the current device.
extern "C" int fused_mha_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* mask, const void* lse, void* ws, void* dq, void* dk,
                             void* dv, int B, int Sq, int Skv, int H, int D, long long q_sb,
                             long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                             long long v_ss, long long do_sb, long long do_ss, float sm_scale,
                             int dtype, void* stream) {
  if (Sq < 1 || Skv < 1 || Sq % BLOCK != 0 || Skv % BLOCK != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, nullptr, dout, static_cast<const int*>(mask), static_cast<const float*>(lse),
               static_cast<float*>(ws), nullptr, dq, dk, dv, B, Sq, Skv, H, Sq,
               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, 0, 0, do_sb, do_ss, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16: err = launch<16>(dtype, a, s); break;
    case 32: err = launch<32>(dtype, a, s); break;
    case 64: err = launch<64>(dtype, a, s); break;
    case 128: err = launch<128>(dtype, a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* dl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
