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
// fp32 (flash_fwd_tf32x3<D>, D = 16-128). The tensor cores take no fp32
// operand, so the two products run as 3xTF32 (tf32x3.cuh: each operand split
// into two TF32 halves, three mma.sync m16n8k8 products, about 2^-21
// relative each). At the slice shape that is 3 x 428.4 GFLOP at 495 TFLOP/s,
// 2.597 ms, against 6.395 at the CUDA cores' 67 TFLOP/s and ~415 MB of fp32
// q/k/v/o (0.12 ms): bound by operations. One CTA per (128 queries, head,
// batch; 64 at D = 128), warps of 16 query rows; K and V tiles of
// fwd_f32_keys keys through a two-slot cp.async ring at the caller's
// strides, rows past Sq and Skv zero-filled by the copy itself (source size
// 0); Q's split fragments stay in registers at D <= 64. Per tile S = Q.K^T,
// scaled into log2 units, keys masked or past Skv at MASK_VALUE (the tile's
// mask read once a warp as ballot words), the online row max and sum with
// alpha rescaling O, and P = ex2(S - m) from the C fragments straight into
// the A operand of P.V. The tile's P.V starts from zero and is added to O in
// fp32: the tensor cores round an mma's fp32 sum toward zero, and O carried
// through 4224 keys drifted one way (tf32x3.cuh, scores_times_tile_fresh).
// O / l at the end. fp32 p is never rounded to a narrower type, so this is
// K3's order up to rounding. The first live tile's alpha = ex2(MASK_VALUE -
// m) = 0 clears what masked tiles before it left in l and O.
//
// Plain C interface (bound with ctypes): flash_attn_fwd returns
// cudaGetLastError() after the launch.

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, turns and the tensor-map encoder
#include "tf32x3.cuh"  // the fp32 kernel's 3xTF32 mma.sync fragments and cp.async staging

namespace {

constexpr float LN2 = 0.6931471805599453f;

constexpr int BLOCK_N = 128;   // keys a tile of the bf16 kernel (the plain version's tile, KERNEL_BLOCK_N)

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

// ---- fp32: 3xTF32 products on the tensor cores (tf32x3.cuh)

// The tiles below were picked by timing scripts/flash_fp32_variants.py at the
// txt2img shape (B=8, S=4224, H=12, D=64, the text mask; NVIDIA H100 80GB
// HBM3, 700 W): eight warps and 64-key slots took 7.89 ms, four warps and
// 32-key slots 8.27, four and 64 8.01, eight and 32 8.34 (PERF.md §6).

// warps of 16 query rows in a CTA: eight at D <= 64 (one CTA an SM at 240
// registers a thread), four at D = 128, where the output takes 64 registers
template <int D>
__host__ __device__ constexpr int fwd_f32_warps() {
  return D <= 64 ? 8 : 4;
}

// keys of a ring slot, the tile of the online softmax (KT / 32 mask words):
// 64 at D <= 64, 32 at D = 128
template <int D>
__host__ __device__ constexpr int fwd_f32_keys() {
  return D <= 64 ? 64 : 32;
}

// bytes of dynamic shared memory: the CTA's Q rows and two ring slots of K and V
template <int D>
__host__ __device__ constexpr int fwd_f32_smem_bytes() {
  return 4 * ld<D>() * (16 * fwd_f32_warps<D>() + 2 * 2 * fwd_f32_keys<D>());
}

// One CTA per (16 * fwd_f32_warps query rows, head, batch), one pass over the
// key tiles; lse [B, H, Sq] and o [B, Sq, H, D] written for the rows below Sq.
template <int D>
__global__ void __launch_bounds__(32 * fwd_f32_warps<D>())
flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const int* __restrict__ mask, float* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int H,
                 long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                 float sm_scale) {
  constexpr int KT = fwd_f32_keys<D>(), LD = ld<D>(), ROWS = 16 * fwd_f32_warps<D>(), THREADS = 2 * ROWS;
  constexpr bool QREG = D <= 64;  // Q's split fragments stay in registers for every key tile
  static_assert(KT % 32 == 0, "a tile's mask is KT / 32 ballot words");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // [ROWS][LD]
  float* ks = qs + ROWS * LD;   // [2][KT][LD]
  float* vs = ks + 2 * KT * LD; // [2][KT][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * ROWS, r0 = 16 * warp;
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
  cp_async_commit();
  stage(0);
  cp_async_commit();

  uint32_t qh[QREG ? D / 8 : 1][4], ql[QREG ? D / 8 : 1][4];
  if constexpr (QREG) {
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) frag_a<D>(qh[kk], ql[kk], qs, r0, kk, g, t4);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  // rows g, g + 8 of the warp: running max (log2 units) and sum, l summed over the quad at the end
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    // the tile's mask: bit i of word w is key t * KT + 32 w + i kept (0 past Skv), the same in every lane
    uint32_t words[KT / 32];
    bool full = true;
#pragma unroll
    for (int w = 0; w < KT / 32; ++w) {
      const int key = t * KT + 32 * w + lane;
      words[w] = __ballot_sync(0xffffffffu, key < Skv && (mb == nullptr || mb[key] != 0));
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
    const float* kt = ks + (t & 1) * KT * LD;
    float s[KT / 8][4];
    if constexpr (QREG)
      rows_dot<D, KT>(s, qh, ql, kt, g, t4);
    else
      rows_dot<D, KT>(s, qs, r0, kt, g, t4);

    // s * scale * log2 e, MASK_VALUE on a key masked or past Skv; the tile's row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t4 + (e & 1);
        const bool kept = full || ((words[col / 32] >> (col % 32)) & 1u);
        s[nt][e] = kept ? s[nt][e] * scale_log2 : MASK_VALUE;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2_approx(m[r] - m_new);  // 0 on the first tile (m = -inf), and past masked tiles
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2_approx(s[nt][e] - m[e >> 1]);  // a masked key beside a live score: exactly 0
        l[e >> 1] += s[nt][e];
      }
    scores_times_tile_fresh<D, KT>(acc, s, vs + (t & 1) * KT * LD, g, t4);  // O += P.V, the tile's sum added
    __syncthreads();  // the slot is refilled next iteration
  }

  // o = acc / l; a fully-masked row (m still MASK_VALUE) gives o = 0, lse = +inf
  bool dead[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    dead[r] = m[r] <= MASK_VALUE;
  }
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = dead[e >> 1] ? 0.f : acc[dn][e] / l[e >> 1];
  const long long o_ss = (long long)H * D;
  const int row = m0 + r0 + g;  // this thread's rows: row, row + 8
  store_c_rows_upto<D>(o + (long long)b * Sq * o_ss + h * D, o_ss, row, acc, t4, Sq);
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + 8 * r < Sq)
        lse[((long long)b * H + h) * Sq + row + 8 * r] = dead[r] ? INFINITY : m[r] * LN2 + logf(l[r]);
  }
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
  auto kernel = flash_fwd_tf32x3<D>;
  static bool configured[MAX_DEVICES] = {};
  const cudaError_t err = allow_smem(kernel, configured, device);
  if (err != cudaSuccess) return err;
  static_assert(fwd_f32_smem_bytes<D>() <= SMEM_LIMIT, "the fp32 K3's tiles exceed shared memory");
  constexpr int ROWS = 16 * fwd_f32_warps<D>();
  const dim3 grid((Sq + ROWS - 1) / ROWS, H, B);
  kernel<<<grid, 2 * ROWS, fwd_f32_smem_bytes<D>(), stream>>>(
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

// keys of the fp32 kernel's ring slot at head dim D, the tile of its online
// softmax, by the rule its launch follows; 0 for another D. The emulation in
// ops/flash_attention.py (f32_fwd_keys) mirrors it.
extern "C" int flash_attn_fwd_f32_tiles(int D) {
  switch (D) {
    case 16: return fwd_f32_keys<16>();
    case 32: return fwd_f32_keys<32>();
    case 64: return fwd_f32_keys<64>();
    case 128: return fwd_f32_keys<128>();
    default: return 0;
  }
}

extern "C" const char* dl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
