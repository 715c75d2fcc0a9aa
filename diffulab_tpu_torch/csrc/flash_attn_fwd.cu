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
// This is not K1's rounding order (K1 normalises p before PV), and the bf16
// result depends on BLOCK_N (m_new is taken once a tile): the plain version
// in ops/flash_attention.py tiles the keys by the same 128.
//
// Bound on an H100 SXM (data-sheet peaks at 700 W): at the txt2img MMDiT
// sampling shape (B=8, S=4224, H=12, D=64, bf16, the fused-CFG text mask) the
// two products over the keys each row attends are 428.4 GFLOP, 0.433 ms at
// 989 TFLOP/s (438.5 GFLOP over every key, masked ones included, which the
// kernel multiplies too), against 209.4 MB of q/k/v/o/lse/mask (62.5 us at
// 3.35 TB/s): compute-bound. The ~1.71 G exponentials are a second ceiling of
// the same height (~0.46 ms at 16 ex2 a clock on 132 SMs), so the softmax has
// to overlap the products rather than follow them.
//
// bf16 (flash_fwd_hopper<D>, D = 16, 32, 64, 128), an FA3-style design on the
// helpers of hopper.cuh: one CTA per (64 * NWG queries, head, batch), NWG
// consumer warpgroups of 64 query rows (three at D <= 64, two at D = 128,
// where the registers are short). Q lands once by TMA; K and V tiles of 128
// keys stream through a ring of STAGES slots (TMA, one mbarrier a slot),
// refilled by one consumer thread as soon as all warps have released a slot
// (a separate producer warp caps the registers, as K4/K5 found). Per
// tile a warpgroup issues, in its turn at the tensor cores, S = Q.K^T (SS
// wgmma, Q and K K-major) and the last tile's acc += round(p).V (RS wgmma: p
// from the accumulators into A registers, V an MN-major B), then hands the
// tensor cores to the next warpgroup (named barriers, in a ring) and forms
// the new tile's max, alpha and p = ex2(s * scale * log2 e - m) while its own
// PV and the others' products run; acc is rescaled by alpha once PV is done,
// and only where the running max moved. Every product retires in the
// iteration that issues it. The batch's key mask is read once per CTA, while
// the first tiles load, into 32-key words in shared memory (up to 65536 keys;
// past that each warp reads it tile by tile); a tile with no masked key takes
// a path without selects. q/k/v are read in the [B, S, H, D] layout at the
// caller's batch and row strides through 3-D tensor maps (no transpose, no
// padded copy); TMA zero-fills rows past Sq and Skv, and keys past Skv score
// MASK_VALUE. o is staged where the warpgroup's Q was and leaves by TMA store;
// lse is written [B, H, Sq], the layout K4/K5 read.
//
// What holds it (clock64 spans per warpgroup and tile at the txt2img shape,
// measured on an H100): ~1.3-1.9 k cycles waiting to issue its
// products behind the other warpgroups', ~1.3 k in the softmax, ~0.5 k in
// the mask, the slot release and the packing of p; the tensor cores work
// ~45% of the time. Neither the exponentials nor the bf16 packing is the
// limit: replacing either with a cheap stand-in changed nothing.
//
// fp32 inputs run a second kernel with one thread per query row and fp32
// FMAs (the tensor cores take no exact fp32 product), over the same tiles.
//
// Plain C interface (bound with ctypes): flash_attn_fwd returns
// cudaGetLastError() after the launch.

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, turns and the tensor-map encoder

namespace {

constexpr float LN2 = 0.6931471805599453f;

constexpr int BLOCK_N = 128;   // keys a tile (both kernels; the plain version's tile, KERNEL_BLOCK_N)
constexpr int F32_ROWS = 64;   // query rows per CTA (fp32 kernel), one per thread

// consumer warpgroups of a bf16 CTA, 64 query rows each
constexpr int fwd_warpgroups(int D) { return D == 128 ? 2 : 3; }

// named barriers: TURN_BAR + w is warpgroup w's turn at the tensor cores,
// STORE_BAR + w gathers warpgroup w's threads before its o leaves (w < 3)
constexpr int TURN_BAR = 1, STORE_BAR = 4;

// 32-key words of the key mask a CTA holds in shared memory: up to 65536 keys
constexpr int MASK_WORDS = 2048;

// the bf16 kernel's shared memory, from a 1024-byte aligned base: the CTA's
// Q tiles ([wg][half][64 rows][ROWB], the swizzled TMA boxes), STAGES slots
// of a K and a V tile ([half][128 rows][ROWB]), the barriers, the key mask's
// words
template <int D>
struct FwdSmem {
  static constexpr int NWG = fwd_warpgroups(D);
  static constexpr int ROWS = NWG * TMA_ROWS;  // query rows of a CTA
  static constexpr int Q = ROWS * D * 2;
  static constexpr int TILE = BLOCK_N * D * 2;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 128 - Q - 4 * MASK_WORDS) / (2 * TILE);  // slots beside Q
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int RING = Q;
  static constexpr int BARS = RING + STAGES * 2 * TILE;
  static constexpr int WORDS = BARS + 128;
  static constexpr int BYTES = 1024 + WORDS + 4 * MASK_WORDS;
  static_assert(BYTES <= SMEM_LIMIT, "the ring must fit in shared memory");
};

// a warpgroup's 64 x D accumulator times inv (0 on a dead row), rounded to
// bf16, into a 64-row TMA box of o at dst ([half][64 rows][ROWB], 16-byte
// chunks swizzled by the row): rows r_lo and r_lo + 8 of this thread
template <int D>
__device__ __forceinline__ void stage_o(uint32_t dst, const float (&acc)[D / 2], const float (&inv)[2],
                                        const bool (&dead)[2], int r_lo, int t4) {
  using G = Geometry<D>;
  constexpr uint32_t SWZ = G::ROWB / 16 - 1;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t off = (col / 64) * TMA_ROWS * G::ROWB + (r_lo + 8 * r) * G::ROWB + (col % 64) * 2;
      off ^= ((off >> 7) & SWZ) << 4;
      const uint32_t val = dead[r] ? 0u : pack_bf16(acc[4 * dn + 2 * r] * inv[r], acc[4 * dn + 2 * r + 1] * inv[r]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst + off), "r"(val) : "memory");
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FwdSmem<D>::NWG * WG, 1)
flash_fwd_hopper(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                 const int* __restrict__ mask, float* __restrict__ lse, int Sq, int Skv, int H, float sm_scale) {
  using G = Geometry<D>;
  using S = FwdSmem<D>;
  constexpr int STAGES = S::STAGES, NWG = S::NWG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem), q_half = TMA_ROWS * G::ROWB, tile_half = BLOCK_N * G::ROWB;
  // barriers: 0 the CTA's Q landed; 1 + s slot s full; 1 + STAGES + s slot s free
  auto bar = [&](int i) { return base + S::BARS + 8 * i; };
  const int tid = threadIdx.x, b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * S::ROWS;
  const int n_tiles = (Skv + BLOCK_N - 1) / BLOCK_N;
  auto load_tile = [&](int t) {
    const int s = t % STAGES;
    const uint32_t dst = base + S::RING + s * 2 * S::TILE;
    mbar_expect_tx(bar(1 + s), 2 * S::TILE);
    load_rows<D>(dst, &tk, b, h, t * BLOCK_N, BLOCK_N, tile_half, bar(1 + s));
    load_rows<D>(dst + S::TILE, &tv, b, h, t * BLOCK_N, BLOCK_N, tile_half, bar(1 + s));
  };

  if (tid == 0) {
    mbar_init(bar(0), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar(1 + s), 1);
      mbar_init(bar(1 + STAGES + s), 4 * NWG);  // one arrival from each warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar(0), S::Q);
    for (int w = 0; w < NWG; ++w)
      load_rows<D>(base + w * G::TILE_BYTES, &tq, b, h, m0 + w * TMA_ROWS, TMA_ROWS, q_half, bar(0));
    for (int t = 0; t < STAGES && t < n_tiles; ++t) load_tile(t);
  }

  const int wg = tid / WG, warp = (tid % WG) / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int r_lo = 16 * warp + g;  // this thread's rows: r_lo and r_lo + 8 of the warpgroup's 64
  const float scale_log2 = sm_scale * LOG2E;
  const int* mrow = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  // a key kept: in range and not masked (a tile's rows past Skv load as zeros)
  auto kept_key = [&](int key) { return key < Skv && (mrow == nullptr || mrow[key] != 0); };
  // the batch's key mask as 32-key words in shared memory (bit i of word w: key 32w + i kept), formed
  // while the first loads are in flight; past MASK_WORDS words each warp reads it tile by tile
  uint32_t* key_words = reinterpret_cast<uint32_t*>(smem + S::WORDS);
  const bool words_held = n_tiles * (BLOCK_N / 32) <= MASK_WORDS;
  if (words_held) {
    constexpr int BATCH = 8;  // words a warp reads before it forms them: loads in flight together
    for (int w0 = tid / 32; w0 < n_tiles * (BLOCK_N / 32); w0 += BATCH * 4 * NWG) {
      bool kept[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) kept[i] = kept_key(32 * (w0 + i * 4 * NWG) + lane);
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const uint32_t ballot = __ballot_sync(0xffffffffu, kept[i]);
        if (lane == 0 && w0 + i * 4 * NWG < n_tiles * (BLOCK_N / 32)) key_words[w0 + i * 4 * NWG] = ballot;
      }
    }
  }
  __syncthreads();
  const uint32_t q_w = base + wg * G::TILE_BYTES;
  // the warpgroups take turns in order, each handing them to the next
  auto turn = [&]() { named_sync(TURN_BAR + wg, 2 * WG); };
  auto pass_turn = [&]() { named_arrive(TURN_BAR + (wg + 1) % NWG, 2 * WG); };
  if (wg == NWG - 1) pass_turn();  // the first warpgroup takes the tensor cores first

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // running max (log2 units) and sum of the two rows
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BLOCK_N / 2];  // scores, then p
  uint32_t pa[BLOCK_N / 16][4];  // the last tile's round(p), the A operand of its PV product
  mbar_wait(bar(0), 0);
  uint32_t v_last = 0;  // the last tile's V, which its PV product reads
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    const uint32_t k_t = base + S::RING + st * 2 * S::TILE, v_t = k_t + S::TILE;
    // the tile's mask: bit 8c + e of word w is key 32w + 8c + 2 t4 + e of the tile kept
    uint32_t words[BLOCK_N / 32];
    bool full = true;  // no masked key in the tile (warp-uniform)
#pragma unroll
    for (int w = 0; w < BLOCK_N / 32; ++w) {
      const int word = j * (BLOCK_N / 32) + w;
      const uint32_t ballot = words_held ? key_words[word] : __ballot_sync(0xffffffffu, kept_key(32 * word + lane));
      full &= ballot == 0xffffffffu;
      words[w] = ballot >> (2 * t4);
    }
    mbar_wait(bar(1 + st), (j / STAGES) & 1);
    turn();
    ss_issue<D, BLOCK_N>(s, q_w, q_half, k_t, tile_half);               // S = Q.K^T
    if (j > 0) rs_issue<D, BLOCK_N / 16>(acc, pa, v_last, tile_half);  // acc += round(p).V of the last tile
    pass_turn();
    if (j > 0) {
      wgmma_wait<1>();  // S done; the last tile's PV may still run
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);
    float m_new[2];
    if (full) {  // the max of the raw scores, the scale folded into the exponent
#pragma unroll
      for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(m[r], row_max<BLOCK_N>(s, r) * scale_log2);
#pragma unroll
      for (int i = 0; i < BLOCK_N / 2; ++i) s[i] = exp2_approx(fmaf(s[i], scale_log2, -m_new[(i >> 1) & 1]));
    } else {  // s * scale * log2 e, MASK_VALUE on a masked key
#pragma unroll
      for (int c = 0; c < BLOCK_N / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool kept = (words[c / 4] >> (8 * (c % 4) + (e & 1))) & 1u;
          s[4 * c + e] = kept ? s[4 * c + e] * scale_log2 : MASK_VALUE;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(m[r], row_max<BLOCK_N>(s, r));
#pragma unroll
      for (int i = 0; i < BLOCK_N / 2; ++i) s[i] = exp2_approx(s[i] - m_new[(i >> 1) & 1]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2_approx(m[r] - m_new[r]);
      l[r] = alpha[r] * l[r] + row_sum<BLOCK_N>(s, r);
      m[r] = m_new[r];
    }
    if (j > 0) {
      wgmma_wait<0>();  // the last tile's PV done: acc and pa are free, and its slot
      fence_regs(acc);
      const int free_slot = (j - 1) % STAGES;
      if (lane == 0) mbar_arrive(bar(1 + STAGES + free_slot));
      if (tid == (NWG - 1) * WG && j - 1 + STAGES < n_tiles) {  // the last warpgroup releases last
        mbar_wait(bar(1 + STAGES + free_slot), ((j - 1) / STAGES) & 1);
        load_tile(j - 1 + STAGES);
      }
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // past the first tiles the max rarely moves
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
    pack_a<BLOCK_N>(pa, s);  // p rounded to bf16
    v_last = v_t;
  }
  turn();
  rs_issue<D, BLOCK_N / 16>(acc, pa, v_last, tile_half);
  pass_turn();
  wgmma_wait<0>();
  fence_regs(acc);

  // o = acc / l where the row attends a key, 0 on a fully-masked row; staged where this warpgroup's Q was
  bool dead[2];
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dead[r] = m[r] <= MASK_VALUE;
    inv[r] = __frcp_rn(l[r] == 0.f ? 1.f : l[r]);
  }
  stage_o<D>(q_w, acc, inv, dead, r_lo, t4);
  fence_async_smem();
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 64 * wg + r_lo + 8 * r;
      if (row < Sq)
        lse[((long long)b * H + h) * Sq + row] = dead[r] ? INFINITY : m[r] * LN2 + logf(l[r] == 0.f ? 1.f : l[r]);
    }
  }
  named_sync(STORE_BAR + wg, WG);
  if (tid % WG == 0 && m0 + 64 * wg < Sq) {
    store_tile<D>(&to, q_w, b, h, m0 + 64 * wg);
    tma_store_done();
  }
}

// exp(x) as 2^(x * log2 e); exp(-inf) = 0
__device__ __forceinline__ float fast_exp(float x) { return exp2_approx(x * LOG2E); }

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
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float (*ks)[D] = reinterpret_cast<float (*)[D]>(smem_f32);
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
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const int* mask, void* o, float* lse, int B,
                        int Sq, int Skv, int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                        long long v_sb, long long v_ss, float sm_scale, int device, cudaStream_t stream) {
  CUtensorMap maps[4];  // q, k, v, o
  if (!encode_rows(&maps[0], q, B, Sq, H, D, q_sb, q_ss) || !encode_rows(&maps[1], k, B, Skv, H, D, k_sb, k_ss) ||
      !encode_rows(&maps[2], v, B, Skv, H, D, v_sb, v_ss) ||
      !encode_rows(&maps[3], o, B, Sq, H, D, (long long)Sq * H * D, (long long)H * D))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_hopper<D>;
  static bool configured[MAX_DEVICES] = {};
  const cudaError_t err = allow_smem(kernel, configured, device);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + FwdSmem<D>::ROWS - 1) / FwdSmem<D>::ROWS, H, B);
  kernel<<<grid, FwdSmem<D>::NWG * WG, FwdSmem<D>::BYTES, stream>>>(maps[0], maps[1], maps[2], maps[3], mask, lse, Sq, Skv, H,
                                                      sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const int* mask, void* o, float* lse, int B,
                       int Sq, int Skv, int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                       long long v_sb, long long v_ss, float sm_scale, int device, cudaStream_t stream) {
  auto kernel = flash_fwd_f32<D>;
  static bool configured[MAX_DEVICES] = {};
  const cudaError_t err = allow_smem(kernel, configured, device);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + F32_ROWS - 1) / F32_ROWS, H, B);
  kernel<<<grid, F32_ROWS, f32_smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), mask,
      static_cast<float*>(o), lse, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const int* mask, void* o, float* lse,
                   int B, int Sq, int Skv, int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                   long long v_sb, long long v_ss, float sm_scale, cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && (device < 0 || device >= MAX_DEVICES)) err = cudaErrorInvalidDevice;
  if (err != cudaSuccess) return err;
  return dtype == 1 ? launch_bf16<D>(q, k, v, mask, o, lse, B, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                                     sm_scale, device, stream)
                    : launch_f32<D>(q, k, v, mask, o, lse, B, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                                    sm_scale, device, stream);
}

}  // namespace

// q/k/v: [B, S, H, D] with unit stride over D, stride D over heads and the given
// batch/row strides (in elements; 16-byte aligned rows); any Sq, Skv >= 1;
// D in {16, 32, 64, 128}; dtype 0 = fp32, 1 = bf16; mask: int32 [B, Skv]
// (nonzero = attend) or null. o: contiguous [B, Sq, H, D] in the input dtype;
// lse: contiguous fp32 [B, H, Sq] (the layout the backward kernels read).
// Launches on `stream` of the current device.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                              void* lse, int B, int Sq, int Skv, int H, int D, long long q_sb,
                              long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                              long long v_ss, float sm_scale, int dtype, void* stream) {
  const int* m = static_cast<const int*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq < 1 || Skv < 1 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (D) {
    case 16: err = launch<16>(dtype, q, k, v, m, o, l, B, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale, s); break;
    case 32: err = launch<32>(dtype, q, k, v, m, o, l, B, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale, s); break;
    case 64: err = launch<64>(dtype, q, k, v, m, o, l, B, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale, s); break;
    case 128: err = launch<128>(dtype, q, k, v, m, o, l, B, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* dl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
