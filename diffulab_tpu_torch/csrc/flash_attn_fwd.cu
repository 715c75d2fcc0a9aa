// KV-tiled flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel diffulab_tpu/ops/flash_attention.py::_fwd_kernel
// (K3, launched by _flash_forward). Per (batch, head, query row), over key
// tiles of BLOCK_N keys:
//   s = q.k^T * scale in fp32; masked keys (and keys past Skv) get the finite
//   MASK_VALUE; m_new = max(m, rowmax(s)); alpha = exp(m - m_new);
//   p = exp(s - m_new), UNNORMALISED, rounded to the input dtype before PV;
//   l = alpha * l + rowsum(p) (fp32 p); acc = acc * alpha + round(p).v.
// At the end o = acc / l_safe (l_safe = 1 where l == 0) and lse = m + log(l_safe);
// a fully-masked row (m <= MASK_VALUE) gives o = 0 and lse = +inf.
// This is not K1's rounding order (K1 normalises p before PV).
//
// Bound on an H100 SXM (data-sheet peaks at 700 W): at the txt2img MMDiT
// sampling shape (B=8, S=4224, H=12, D=64, bf16) the two products are 438.5
// GFLOP, 0.443 ms at 989 TFLOP/s, against ~209 MB of q/k/v/o/lse (62 us at
// 3.35 TB/s): compute-bound. So the design keeps the tensor cores fed and the
// scores on chip: one CTA per (128 queries, head, batch), eight warps of
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), each warp owning 16 query
// rows with Q in registers; K and V tiles of 64 keys are double-buffered in
// shared memory by cp.async, so the next tile's copy overlaps this tile's
// products; K is read with ldmatrix, V with ldmatrix.trans, the tile's key
// mask once per warp as two ballot words; m, l and o stay in registers (at
// most 128 a thread for D <= 64, so two CTAs share an SM); the C layout of
// two 16x8 score tiles is the A layout of one 16x16 operand, so p goes from
// the QK^T accumulators straight into the PV product. exp, ~1.7 G of them a
// launch at the slice shape and as slow on the SFUs as the products on the
// tensor cores, runs as one ex2.approx on (s - m) * log2(e). q/k/v are read in
// the [B, S, H, D] layout at the caller's batch and row strides (no transpose
// pass), the ragged ends of Sq and Skv are masked here (no padded copies), and
// only o and lse are written.
//
// fp32 inputs run a second kernel with one thread per query row and fp32
// FMAs (the tensor cores take no exact fp32 product), with the same tiles.
//
// Plain C interface (bound with ctypes): flash_attn_fwd returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// -0.7 * FLT_MAX, formed in double and rounded once, as the reference forms it
constexpr float MASK_VALUE = static_cast<float>(-0.7 * 3.4028234663852886e+38);
constexpr float LOG2E = 1.4426950408889634f;

constexpr int BLOCK_M = 128;  // query rows per CTA (bf16 kernel)
constexpr int BLOCK_N = 64;   // keys per tile (both kernels; the plain version's tile)
constexpr int WARPS = 8;      // bf16 kernel: 16 query rows per warp
constexpr int PAD = 8;        // bf16 elements of padding per shared-memory row
constexpr int F32_ROWS = 64;  // query rows per CTA (fp32 kernel), one per thread
static_assert(BLOCK_N == 64, "the bf16 kernel holds a tile's key mask in two 32-bit words");

using bf16 = __nv_bfloat16;

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

// four (two) 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the
// row addresses of matrix i, whose fragment lands in r[i]
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

// 16 bytes global -> shared, asynchronous; src_bytes = 0 fills zeros
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(x) as 2^(x * log2 e); exp(-inf) = 0
__device__ __forceinline__ float fast_exp(float x) { return exp2_approx(x * LOG2E); }

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
using Tile = bf16 (*)[D + PAD];

template <int D>
constexpr int bf16_smem_bytes() {
  return 4 * BLOCK_N * (D + PAD) * static_cast<int>(sizeof(bf16));  // K and V, two stages each
}

// keys [n0, n0 + BLOCK_N) of one head into shared memory, 16 bytes a thread,
// asynchronously; rows past Skv are zero-filled
template <int D>
__device__ __forceinline__ void stage_async(Tile<D> dst, const bf16* src, long long row_stride, int n0,
                                            int Skv) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < BLOCK_N * CHUNKS; i += WARPS * 32) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const bool in = n0 + r < Skv;
    const bf16* s = in ? src + (long long)(n0 + r) * row_stride + c : src;
    cp_async_16(&dst[r][c], s, in ? 16 : 0);
  }
}

// two CTAs an SM where the registers allow it (D <= 64: at most 128 a thread)
template <int D>
__global__ void __launch_bounds__(WARPS * 32, D <= 64 ? 2 : 1)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const int* __restrict__ mask, bf16* __restrict__ o, float* __restrict__ lse, int Sq,
               int Skv, int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
               long long v_sb, long long v_ss, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile<D> kbuf[2] = {reinterpret_cast<Tile<D>>(smem),
                     reinterpret_cast<Tile<D>>(smem) + BLOCK_N};
  Tile<D> vbuf[2] = {reinterpret_cast<Tile<D>>(smem) + 2 * BLOCK_N,
                     reinterpret_cast<Tile<D>>(smem) + 3 * BLOCK_N};

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * BLOCK_M + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const bf16* qb = q + b * q_sb + h * D;
  const bf16* kb = k + b * k_sb + h * D;
  const bf16* vb = v + b * v_sb + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  const int n_tiles = (Skv + BLOCK_N - 1) / BLOCK_N;

  stage_async<D>(kbuf[0], kb, k_ss, 0, Skv);
  stage_async<D>(vbuf[0], vb, v_ss, 0, Skv);
  cp_async_commit();

  // A fragments of Q (16 rows x D), read once from global memory; rows past Sq are 0
  uint32_t qf[D / 16][4];
  const bool in0 = row0 < Sq, in1 = row0 + 8 < Sq;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* r0 = qb + (long long)row0 * q_ss + kk * 16 + 2 * t4;
    const bf16* r1 = r0 + 8 * q_ss;
    qf[kk][0] = in0 ? *reinterpret_cast<const uint32_t*>(r0) : 0u;
    qf[kk][1] = in1 ? *reinterpret_cast<const uint32_t*>(r1) : 0u;
    qf[kk][2] = in0 ? *reinterpret_cast<const uint32_t*>(r0 + 8) : 0u;
    qf[kk][3] = in1 ? *reinterpret_cast<const uint32_t*>(r1 + 8) : 0u;
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int mat = lane >> 3, mr = lane & 7;
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BLOCK_N, st = j & 1;
    // the tile's key mask as two warp-uniform words: keys n0 + [0, 32), n0 + [32, 64)
    const int key_lo = n0 + lane, key_hi = n0 + 32 + lane;
    const unsigned keep_lo = __ballot_sync(0xffffffffu, key_lo < Skv && (mb == nullptr || mb[key_lo] != 0));
    const unsigned keep_hi = __ballot_sync(0xffffffffu, key_hi < Skv && (mb == nullptr || mb[key_hi] != 0));
    if (j + 1 < n_tiles) {
      stage_async<D>(kbuf[st ^ 1], kb, k_ss, n0 + BLOCK_N, Skv);
      stage_async<D>(vbuf[st ^ 1], vb, v_ss, n0 + BLOCK_N, Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    Tile<D> ks = kbuf[st], vs = vbuf[st];

    // s = q.k^T * scale, masked; C layout: j = 0,1 -> row g, key nt*8 + 2*t4 + j; 2,3 -> row g + 8
    float s[BLOCK_N / 8][4];
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (D >= 32) {
#pragma unroll
        for (int kk = 0; kk < D / 16; kk += 2) {
          // matrices: (keys nt*8.., cols kk*16..), (.., kk*16+8..), (.., kk*16+16..), (.., kk*16+24..)
          uint32_t bf[4];
          ldsm_x4(bf, &ks[nt * 8 + mr][kk * 16 + mat * 8]);
          mma_16816(c, qf[kk], bf);
          mma_16816(c, qf[kk + 1], bf + 2);
        }
      } else {
        uint32_t bf[2];
        ldsm_x2(bf, &ks[nt * 8 + mr][(mat & 1) * 8]);
        mma_16816(c, qf[0], bf);
      }
      const int bit = (nt * 8 + 2 * t4) & 31;
      const unsigned word = nt < 4 ? keep_lo : keep_hi;
      const bool keep0 = (word >> bit) & 1u, keep1 = (word >> (bit + 1)) & 1u;
      s[nt][0] = keep0 ? c[0] * sm_scale : MASK_VALUE;
      s[nt][1] = keep1 ? c[1] * sm_scale : MASK_VALUE;
      s[nt][2] = keep0 ? c[2] * sm_scale : MASK_VALUE;
      s[nt][3] = keep1 ? c[3] * sm_scale : MASK_VALUE;
    }

    // online softmax: running max and sum, p = exp(s - m_new) unnormalised
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BLOCK_N / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
      const float alpha = fast_exp(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
        s[nt][2 * r] = fast_exp(s[nt][2 * r] - m_new);
        s[nt][2 * r + 1] = fast_exp(s[nt][2 * r + 1] - m_new);
        sum += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      l[r] = alpha * l[r] + quad_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        acc[dn][2 * r] *= alpha;
        acc[dn][2 * r + 1] *= alpha;
      }
    }

    // acc += round_bf16(p) . V
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        // matrices: (keys kk*16.., cols dn*8..), (kk*16+8.., dn*8..), (kk*16.., dn*8+8..), (kk*16+8.., dn*8+8..)
        uint32_t bf[4];
        ldsm_x4_trans(bf, &vs[kk * 16 + (mat & 1) * 8 + mr][dn * 8 + (mat >> 1) * 8]);
        mma_16816(acc[dn], a, bf);
        mma_16816(acc[dn + 1], a, bf + 2);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }

  // o [B, Sq, H, D] contiguous; lse [B, H, Sq]
  const long long o_ss = (long long)H * D;
  bf16* ob = o + (long long)b * Sq * o_ss + h * D;
  float* lb = lse + ((long long)b * H + h) * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const bool dead = m[r] <= MASK_VALUE;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const float x0 = dead ? 0.f : acc[dn][2 * r] / l_safe;
      const float x1 = dead ? 0.f : acc[dn][2 * r + 1] / l_safe;
      *reinterpret_cast<uint32_t*>(ob + (long long)row * o_ss + dn * 8 + 2 * t4) = pack_bf16(x0, x1);
    }
    if (t4 == 0) lb[row] = dead ? INFINITY : m[r] + logf(l_safe);
  }
}

template <int D>
constexpr int f32_smem_bytes() {
  return (2 * BLOCK_N * D + BLOCK_N * F32_ROWS) * static_cast<int>(sizeof(float));  // K, V, scores
}

template <int D>
__global__ void __launch_bounds__(F32_ROWS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const int* __restrict__ mask, float* __restrict__ o, float* __restrict__ lse, int Sq,
              int Skv, int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
              long long v_sb, long long v_ss, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float (*ks)[D] = reinterpret_cast<float (*)[D]>(smem);
  float (*vs)[D] = ks + BLOCK_N;
  float (*ss)[F32_ROWS] = reinterpret_cast<float (*)[F32_ROWS]>(vs + BLOCK_N);  // [key][thread]

  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int row = blockIdx.x * F32_ROWS + tid;
  const float* kb = k + b * k_sb + h * D;
  const float* vb = v + b * v_sb + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;

  float qr[D];
  const float* qrow = q + b * q_sb + (long long)row * q_ss + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = row < Sq ? qrow[d] : 0.f;

  float m = -INFINITY, l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int n0 = 0; n0 < Skv; n0 += BLOCK_N) {
    __syncthreads();
    for (int i = tid; i < BLOCK_N * D; i += F32_ROWS) {
      const int r = i / D, c = i % D;
      const bool in = n0 + r < Skv;
      ks[r][c] = in ? kb[(long long)(n0 + r) * k_ss + c] : 0.f;
      vs[r][c] = in ? vb[(long long)(n0 + r) * v_ss + c] : 0.f;
    }
    __syncthreads();
    float mx = -INFINITY;
    for (int j = 0; j < BLOCK_N; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      const int key = n0 + j;
      const float s = (key < Skv && (mb == nullptr || mb[key] != 0)) ? dot * sm_scale : MASK_VALUE;
      ss[j][tid] = s;
      mx = fmaxf(mx, s);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = fast_exp(m - m_new);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
    float sum = 0.f;
    for (int j = 0; j < BLOCK_N; ++j) {
      const float p = fast_exp(ss[j][tid] - m_new);
      sum += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    l = alpha * l + sum;
    m = m_new;
  }
  if (row >= Sq) return;
  const bool dead = m <= MASK_VALUE;
  const float l_safe = l == 0.f ? 1.f : l;
  float* orow = o + ((long long)b * Sq + row) * H * D + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) orow[d] = dead ? 0.f : acc[d] / l_safe;
  lse[((long long)b * H + h) * Sq + row] = dead ? INFINITY : m + logf(l_safe);
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, const int* mask, void* o, float* lse,
           int B, int Sq, int Skv, int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
           long long v_sb, long long v_ss, float sm_scale, cudaStream_t stream) {
  if (dtype == 1) {
    constexpr int bytes = bf16_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, H, B);
    flash_fwd_bf16<D><<<grid, WARPS * 32, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), mask,
        static_cast<bf16*>(o), lse, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale);
  } else {
    constexpr int bytes = f32_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((Sq + F32_ROWS - 1) / F32_ROWS, H, B);
    flash_fwd_f32<D><<<grid, F32_ROWS, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), mask,
        static_cast<float*>(o), lse, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v: [B, S, H, D] with unit stride over D, stride D over heads and the given
// batch/row strides (in elements; 16-byte aligned rows); any Sq, Skv >= 1;
// D in {16, 32, 64, 128}; dtype 0 = fp32, 1 = bf16; mask: int32 [B, Skv]
// (nonzero = attend) or null. o: contiguous [B, Sq, H, D] in the input dtype;
// lse: contiguous fp32 [B, H, Sq] (the layout the backward kernels read).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                              void* lse, int B, int Sq, int Skv, int H, int D, long long q_sb,
                              long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                              long long v_ss, float sm_scale, int dtype, void* stream) {
  const int* m = static_cast<const int*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq < 1 || Skv < 1 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: return launch<16>(dtype, q, k, v, m, o, l, B, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale, s);
    case 32: return launch<32>(dtype, q, k, v, m, o, l, B, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale, s);
    case 64: return launch<64>(dtype, q, k, v, m, o, l, B, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale, s);
    case 128: return launch<128>(dtype, q, k, v, m, o, l, B, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* dl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
