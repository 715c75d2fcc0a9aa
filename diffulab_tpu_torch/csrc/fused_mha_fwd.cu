// Fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel diffulab_tpu/ops/fused_mha.py::_mha_fwd_kernel
// (K1). Per (batch, head): s = q.k^T * scale in fp32; masked keys get the
// finite MASK_VALUE; plain softmax p = exp(s - m) / l, normalised BEFORE the
// PV product and rounded to the input dtype there; o = p.v accumulated in
// fp32; lse = m + log(l); a fully-masked row gives o = 0, lse = +inf.
//
// Bound on an H100: at the DiT-B/2 sampling shape (B=32, S=256, H=12, D=64,
// bf16) 6.4 GFLOP over 50.7 MB is ~127 FLOP/byte, below the card's ~295:
// memory-bound. So q/k/v are read in the [B, S, H*D] layout the qkv
// projection writes (a head is a D-wide column slice, rows at a caller-given
// stride: no transpose pass), the scores never leave the SM, and only o and
// lse are written.
//
// Two kernels:
//  - mha_fwd_bf16: one CTA per (64 queries, head, batch); 4 warps own 16
//    query rows each, with Q held in mma fragments. K (and V) tiles of 64 keys
//    are staged through shared memory. Pass 1 over the keys gives the row max
//    and sum (online); pass 2 recomputes s, forms p = exp(s - m) / l, rounds
//    it to bf16 into the A fragment of the PV mma (the C layout of two
//    adjacent 16x8 score tiles is the A layout of one 16x16 operand) and
//    accumulates o in fp32. mma.sync m16n8k16, bf16 in, fp32 accumulate.
//  - mha_fwd_f32: the same two passes with one thread per query row and
//    fp32 FMAs, because the tensor cores have no exact fp32 product.
//
// Plain C interface (bound with ctypes): fused_mha_fwd returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// -0.7 * FLT_MAX, formed in double and rounded once, as the reference forms it
constexpr float MASK_VALUE = static_cast<float>(-0.7 * 3.4028234663852886e+38);

constexpr int BLOCK_M = 64;  // query rows per CTA
constexpr int BLOCK_N = 64;  // keys per staged tile (bf16 kernel)
constexpr int WARPS = 4;     // bf16 kernel: 16 query rows per warp
constexpr int PAD = 8;       // bf16 elements of padding per shared-memory row
constexpr int F32_TILE = 32; // keys per staged tile (fp32 kernel)

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// rows [n0, n0 + BLOCK_N) of one head (D columns) into shared memory, 16 bytes a thread
template <int D>
__device__ __forceinline__ void stage_tile(__nv_bfloat16 (*dst)[D + PAD], const __nv_bfloat16* src,
                                           long long row_stride, int n0) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < BLOCK_N * CHUNKS; i += WARPS * 32) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    *reinterpret_cast<int4*>(&dst[r][c]) =
        *reinterpret_cast<const int4*>(src + (long long)(n0 + r) * row_stride + c);
  }
}

// s[nt][j]: this thread's scores of the warp's 16 rows against keys n0 + [0, 64),
// scaled and masked. C layout: j = 0,1 -> row g, key nt*8 + 2*t4 + j; j = 2,3 -> row g + 8.
template <int D>
__device__ __forceinline__ void tile_scores(float s[BLOCK_N / 8][4], const uint32_t qf[D / 16][4],
                                            const __nv_bfloat16 (*ks)[D + PAD], float sm_scale,
                                            const int* mask, int n0, int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[2];
      b[0] = *reinterpret_cast<const uint32_t*>(&ks[nt * 8 + g][kk * 16 + 2 * t4]);
      b[1] = *reinterpret_cast<const uint32_t*>(&ks[nt * 8 + g][kk * 16 + 2 * t4 + 8]);
      mma_16816(c, qf[kk], b);
    }
    const int key = n0 + nt * 8 + 2 * t4;
    const bool keep0 = mask == nullptr || mask[key] != 0;
    const bool keep1 = mask == nullptr || mask[key + 1] != 0;
    s[nt][0] = keep0 ? c[0] * sm_scale : MASK_VALUE;
    s[nt][1] = keep1 ? c[1] * sm_scale : MASK_VALUE;
    s[nt][2] = keep0 ? c[2] * sm_scale : MASK_VALUE;
    s[nt][3] = keep1 ? c[3] * sm_scale : MASK_VALUE;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
mha_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
             __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int H,
             long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb,
             long long v_ss, float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[BLOCK_N][D + PAD];
  __shared__ __align__(16) __nv_bfloat16 vs[BLOCK_N][D + PAD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * BLOCK_M + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const __nv_bfloat16* qb = q + b * q_sb + h * D;
  const __nv_bfloat16* kb = k + b * k_sb + h * D;
  const __nv_bfloat16* vb = v + b * v_sb + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;

  // A fragments of Q (16 rows x D), read once from global memory
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* r0 = qb + (long long)row0 * q_ss + kk * 16 + 2 * t4;
    const __nv_bfloat16* r1 = r0 + 8 * q_ss;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(r1);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
  }

  // pass 1: row max m and row sum l = sum exp(s - m), online over key tiles
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int n0 = 0; n0 < Skv; n0 += BLOCK_N) {
    __syncthreads();
    stage_tile<D>(ks, kb, k_ss, n0);
    __syncthreads();
    float s[BLOCK_N / 8][4];
    tile_scores<D>(s, qf, ks, sm_scale, mb, n0, g, t4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BLOCK_N / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BLOCK_N / 8; ++nt)
        sum += expf(s[nt][2 * r] - m_new) + expf(s[nt][2 * r + 1] - m_new);
      l[r] = l[r] * expf(m[r] - m_new) + quad_sum(sum);
      m[r] = m_new;
    }
  }
  const bool dead[2] = {mb != nullptr && m[0] <= MASK_VALUE, mb != nullptr && m[1] <= MASK_VALUE};

  // pass 2: p = exp(s - m) / l rounded to bf16, o += p.v in fp32
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int n0 = 0; n0 < Skv; n0 += BLOCK_N) {
    __syncthreads();
    stage_tile<D>(ks, kb, k_ss, n0);
    stage_tile<D>(vs, vb, v_ss, n0);
    __syncthreads();
    float s[BLOCK_N / 8][4];
    tile_scores<D>(s, qf, ks, sm_scale, mb, n0, g, t4);
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1;
        s[nt][j] = dead[r] ? 0.f : expf(s[nt][j] - m[r]) / l[r];
      }
    }
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + 2 * t4;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const int col = dn * 8 + g;
        uint32_t bfrag[2];
        bfrag[0] = pack_bf16_raw(vs[key][col], vs[key + 1][col]);
        bfrag[1] = pack_bf16_raw(vs[key + 8][col], vs[key + 9][col]);
        mma_16816(acc[dn], a, bfrag);
      }
    }
  }

  // o [B, Sq, H, D] contiguous; lse [B, Sq, H]
  const long long o_ss = (long long)H * D;
  __nv_bfloat16* ob = o + (long long)b * Sq * o_ss + h * D;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(ob + (long long)row0 * o_ss + col) = pack_bf16(acc[dn][0], acc[dn][1]);
    *reinterpret_cast<uint32_t*>(ob + (long long)(row0 + 8) * o_ss + col) = pack_bf16(acc[dn][2], acc[dn][3]);
  }
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float val = dead[r] ? INFINITY : m[r] + logf(l[r]);
      lse[((long long)b * Sq + row0 + 8 * r) * H + h] = val;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(BLOCK_M)
mha_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const int* __restrict__ mask, float* __restrict__ o, float* __restrict__ lse, int Sq,
            int Skv, int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
            long long v_sb, long long v_ss, float sm_scale) {
  __shared__ __align__(16) float ks[F32_TILE][D];
  __shared__ __align__(16) float vs[F32_TILE][D];

  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * BLOCK_M + threadIdx.x;
  const float* kb = k + b * k_sb + h * D;
  const float* vb = v + b * v_sb + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;

  float qr[D];
  const float* qrow = q + b * q_sb + (long long)row * q_ss + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = qrow[d];

  // pass 1: online row max and sum
  float m = -INFINITY, l = 0.f;
  for (int n0 = 0; n0 < Skv; n0 += F32_TILE) {
    __syncthreads();
    for (int i = threadIdx.x; i < F32_TILE * D; i += BLOCK_M)
      ks[i / D][i % D] = kb[(long long)(n0 + i / D) * k_ss + i % D];
    __syncthreads();
    for (int j = 0; j < F32_TILE; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      const float s = (mb == nullptr || mb[n0 + j] != 0) ? dot * sm_scale : MASK_VALUE;
      if (s > m) {
        l = l * expf(m - s) + 1.f;
        m = s;
      } else {
        l += expf(s - m);
      }
    }
  }
  const bool dead = mb != nullptr && m <= MASK_VALUE;

  // pass 2: p = exp(s - m) / l, o += p.v
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int n0 = 0; n0 < Skv; n0 += F32_TILE) {
    __syncthreads();
    for (int i = threadIdx.x; i < F32_TILE * D; i += BLOCK_M) {
      ks[i / D][i % D] = kb[(long long)(n0 + i / D) * k_ss + i % D];
      vs[i / D][i % D] = vb[(long long)(n0 + i / D) * v_ss + i % D];
    }
    __syncthreads();
    for (int j = 0; j < F32_TILE; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      const float s = (mb == nullptr || mb[n0 + j] != 0) ? dot * sm_scale : MASK_VALUE;
      const float p = dead ? 0.f : expf(s - m) / l;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
  }
  float* orow = o + ((long long)b * Sq + row) * H * D + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) orow[d] = acc[d];
  lse[((long long)b * Sq + row) * H + h] = dead ? INFINITY : m + logf(l);
}

template <int D>
void launch(int dtype, const void* q, const void* k, const void* v, const int* mask, void* o,
            float* lse, int B, int Sq, int Skv, int H, long long q_sb, long long q_ss,
            long long k_sb, long long k_ss, long long v_sb, long long v_ss, float sm_scale,
            cudaStream_t stream) {
  const dim3 grid(Sq / BLOCK_M, H, B);
  if (dtype == 1) {
    mha_fwd_bf16<D><<<grid, WARPS * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(o), lse, Sq, Skv,
        H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale);
  } else {
    mha_fwd_f32<D><<<grid, BLOCK_M, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        mask, static_cast<float*>(o), lse, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
        sm_scale);
  }
}

}  // namespace

// q/k/v: [B, S, H, D] with unit stride over D, stride D over heads and the given
// batch/row strides (in elements); Sq, Skv multiples of 64; D in {16, 32, 64, 128};
// dtype 0 = fp32, 1 = bf16; mask: int32 [B, Skv] (nonzero = attend) or null.
// o: contiguous [B, Sq, H, D] in the input dtype; lse: contiguous fp32 [B, Sq, H].
extern "C" int fused_mha_fwd(const void* q, const void* k, const void* v, const void* mask,
                             void* o, void* lse, int B, int Sq, int Skv, int H, int D,
                             long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                             long long v_sb, long long v_ss, float sm_scale, int dtype,
                             void* stream) {
  const int* m = static_cast<const int*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq % BLOCK_M != 0 || Skv % BLOCK_N != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: launch<16>(dtype, q, k, v, m, o, l, B, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale, s); break;
    case 32: launch<32>(dtype, q, k, v, m, o, l, B, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale, s); break;
    case 64: launch<64>(dtype, q, k, v, m, o, l, B, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale, s); break;
    case 128: launch<128>(dtype, q, k, v, m, o, l, B, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
