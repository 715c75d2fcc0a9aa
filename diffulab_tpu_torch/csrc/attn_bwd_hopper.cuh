// The attention backward's Hopper (sm_90a) kernels, bf16 at D = 64 and 128:
// wgmma on TMA-fed tiles, shared by two sources that each instantiate them
// under kernel names of their own.
//  - flash_attn_bwd.cu: K4 (dk, dv) and K5 (dq) of the flash backward, from
//    di = rowsum(o * do) formed by its pre-pass and K3's lse [B, H, Sq].
//  - fused_mha_bwd.cu: K2, the fused backward, which saves no o. Its dq
//    kernel is K5's with a first pass over the keys that forms di =
//    rowsum(p * dp) from the fp32 p and dp of the CTA's rows and writes it,
//    with lse * log2 e from K1's lse [B, Sq, H], into the workspace that K4's
//    kernel then reads for dk and dv.
// Each source wraps the __device__ bodies below in its own __global__
// kernels and launches them through launch_dkv_hopper / launch_dq_hopper.
//
// Per (batch, head), with p = ex2(s * scale * log2 e - lse * log2 e), 0 on a
// masked key or a key past Skv (and on a row with lse = +inf):
//   dv = round(p)^T . do, dk = round(ds)^T . q, dq = round(ds) . k, ds = p *
//   (dp - di) * scale, dp = do . v^T, every sum in one CTA's fp32 registers
//   (no atomics: the result does not depend on the run).

#pragma once

#include "hopper.cuh"  // mbarriers, TMA, wgmma and the tensor-map encoder

namespace {

constexpr int HB_ROWS = 128;             // keys of a K4 CTA, queries of a K5 CTA
constexpr int HB_THREADS = 2 * WG;       // two warpgroups: up to 255 registers a thread
constexpr int STAGES = 4;                // slots of the ring
constexpr int WS_ALIGN = 64;             // the workspace's rows are padded to a multiple of this

// K4's shared memory, from a 1024-byte aligned base: the CTA's K, then V
// ([half][128 rows][128 B], the swizzled TMA boxes), STAGES slots of a Q and
// a dO tile of BQ queries, the slots' lse2 and di vectors, the barriers
template <int D>
struct DkvSmem {
  static constexpr int BQ = D == 128 ? 32 : 64;  // queries a tile: at D = 128, dk and dv hold 128 registers
  static constexpr int KV = HB_ROWS * D * 2;
  static constexpr int TILE = BQ * D * 2;
  static constexpr int VEC = BQ * 4;
  static constexpr int RING = 2 * KV;
  static constexpr int VECS = RING + STAGES * 2 * TILE;
  static constexpr int BARS = VECS + STAGES * 2 * VEC;
  static constexpr int BYTES = 1024 + BARS + (1 + 2 * STAGES) * 8;
};

// K5's: the CTA's Q, then dO, STAGES slots of a K and a V tile of KT keys,
// the barriers
template <int D>
struct DqSmem {
  static constexpr int KT = D == 128 ? 64 : 128;  // keys a tile: at D = 128, 128 would not fit four slots
  static constexpr int QD = HB_ROWS * D * 2;
  static constexpr int TILE = KT * D * 2;
  static constexpr int RING = 2 * QD;
  static constexpr int BARS = RING + STAGES * 2 * TILE;
  static constexpr int BYTES = 1024 + BARS + (1 + 2 * STAGES) * 8;
};

// the register A operand of rows [row0, row0 + 64) (x D, K-major) of a
// [half][rows][128 B] region that TMA filled with the 128-byte swizzle:
// a[kk][i] holds row 16 * warp + g + 8 (i & 1), columns 16 kk + 2 t4 + 8 (i >> 1)
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], uint32_t region, uint32_t half, int row0, int warp,
                                       int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 16 * warp + g + 8 * (i & 1), col = 16 * kk + 2 * t4 + 8 * (i >> 1);
      const uint32_t off = (col / 64) * half + row * 128 + ((((col % 64) / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(a[kk][i]) : "r"(region + off) : "memory");
    }
}

// a warpgroup's 64 x D accumulator, rounded to bf16, into rows [row0, row0 +
// 64) of a [half][rows][128 B] region (halves `half` bytes apart) in the
// swizzled layout of a TMA box: rows r_lo and r_lo + 8 of this thread
template <int D>
__device__ __forceinline__ void stage_acc(uint32_t region, uint32_t half, int row0, const float (&acc)[D / 2],
                                          int r_lo, int t4) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t off = (col / 64) * half + (row0 + r_lo + 8 * r) * 128 + (col % 64) * 2;
      off ^= ((off >> 7) & 7) << 4;
      const uint32_t val = pack_bf16(acc[4 * dn + 2 * r], acc[4 * dn + 2 * r + 1]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(region + off), "r"(val) : "memory");
    }
  }
}

// the rows of [row0, row0 + HB_ROWS) that TMA boxes of 64 rows load: boxes
// wholly past S are not loaded (their rows are masked and never stored)
__device__ __forceinline__ int loaded_rows(int row0, int S) {
  return min(HB_ROWS, (S - row0 + TMA_ROWS - 1) / TMA_ROWS * TMA_ROWS);
}

// K4 (dk, dv), one CTA per (128 keys, head, batch): two warpgroups of 64 keys.
// The CTA's K and V land once by TMA and stay (at D = 64 also as register A
// operands); Q and dO tiles of BQ queries, with their lse2 and di vectors by
// bulk copy from the workspace ws = [2][B * H][ws_rs] (lse * log2 e, then
// di), stream through a ring of STAGES slots, refilled by one thread of the
// second warpgroup as soon as both have released a slot. Per tile, keys as
// rows: S^T = K.Q^T and dP^T = V.dO^T (RS wgmma at D = 64, SS at D = 128,
// where the registers are short; Q and dO K-major B); P^T = ex2(S^T * scale *
// log2 e - lse2), 0 on a masked key (one predicate a row), while dP^T runs;
// dS^T = P^T * (dP^T - di) * scale; then, issued with the next tile's scores,
// dV += round(P^T).dO and dK += round(dS^T).Q (RS: P^T and dS^T from the
// accumulators into A registers, dO and Q MN-major B). The warpgroups take
// turns at the tensor cores, one batch of products a tile each, so that one's
// exponentials overlap the other's products. A slot is released once every
// product that read it is done. dk and dv are staged where the warpgroup's own
// K and V were and leave by TMA store.
template <int D>
__device__ __forceinline__ void bwd_dkv_hopper(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                                               const CUtensorMap& tdo, const CUtensorMap& tdk,
                                               const CUtensorMap& tdv, const int* __restrict__ mask,
                                               const float* __restrict__ ws, int Sq, int Skv, int H, int ws_rs,
                                               float sm_scale) {
  using G = Geometry<D>;
  using S = DkvSmem<D>;
  constexpr int BQ = S::BQ;
  constexpr bool KV_REGS = D == 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem), kv_half = HB_ROWS * G::ROWB, tile_half = BQ * G::ROWB;
  // barriers: 0 the CTA's K and V landed; 1 + s slot s full; 1 + STAGES + s slot s free
  auto bar = [&](int i) { return base + S::BARS + 8 * i; };
  const int tid = threadIdx.x, b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * HB_ROWS;
  const int n_tiles = (Sq + BQ - 1) / BQ;
  const float* lse2_g = ws + ((long long)b * H + h) * ws_rs;
  const float* di_g = lse2_g + (long long)gridDim.z * H * ws_rs;
  auto load_tile = [&](int t) {
    const int s = t % STAGES;
    const uint32_t dst = base + S::RING + s * 2 * S::TILE, vec = base + S::VECS + s * 2 * S::VEC;
    mbar_expect_tx(bar(1 + s), 2 * S::TILE + 2 * S::VEC);
    load_rows<D, BQ>(dst, &tq, b, h, t * BQ, BQ, tile_half, bar(1 + s));
    load_rows<D, BQ>(dst + S::TILE, &tdo, b, h, t * BQ, BQ, tile_half, bar(1 + s));
    bulk_load(vec, lse2_g + t * BQ, S::VEC, bar(1 + s));
    bulk_load(vec + S::VEC, di_g + t * BQ, S::VEC, bar(1 + s));
  };

  if (tid == 0) {
    mbar_init(bar(0), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar(1 + s), 1);
      mbar_init(bar(1 + STAGES + s), 8);  // one arrival from each warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    const int kv_rows = loaded_rows(n0, Skv);
    mbar_expect_tx(bar(0), 2 * kv_rows * D * 2);
    load_rows<D>(base, &tk, b, h, n0, kv_rows, kv_half, bar(0));
    load_rows<D>(base + S::KV, &tv, b, h, n0, kv_rows, kv_half, bar(0));
    for (int t = 0; t < STAGES && t < n_tiles; ++t) load_tile(t);
  }

  const int wg = tid / WG, warp = (tid % WG) / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int r_lo = 16 * warp + g;  // this thread's keys: rows r_lo and r_lo + 8 of the warpgroup's 64
  const float scale_log2 = sm_scale * LOG2E;
  bool keep[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = n0 + 64 * wg + r_lo + 8 * r;
    keep[r] = key < Skv && (mask == nullptr || mask[(long long)b * Skv + key] != 0);
  }
  const uint32_t k_w = base + wg * 64 * G::ROWB, v_w = k_w + S::KV;
  const float* vecs = reinterpret_cast<const float*>(smem + S::VECS);
  auto turn = [&]() { named_sync(SCHED_BAR + wg, 2 * WG); };
  auto pass_turn = [&]() { named_arrive(SCHED_BAR + 1 - wg, 2 * WG); };
  if (wg == 1) pass_turn();  // the first warpgroup takes the tensor cores first

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[BQ / 2], dp[BQ / 2];
  uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
  uint32_t ka[KV_REGS ? D / 16 : 1][4], va[KV_REGS ? D / 16 : 1][4];
  mbar_wait(bar(0), 0);
  if constexpr (KV_REGS) {
    load_a<D>(ka, base, kv_half, 64 * wg, warp, g, t4);
    load_a<D>(va, base + S::KV, kv_half, 64 * wg, warp, g, t4);
  }
  uint32_t q_last = 0, do_last = 0;  // the last tile's Q and dO, which its gradient products read
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    const uint32_t q_t = base + S::RING + st * 2 * S::TILE, do_t = q_t + S::TILE;
    mbar_wait(bar(1 + st), (j / STAGES) & 1);
    turn();
    if (j > 0) {
      rs_issue<D, BQ / 16>(dv, pa, do_last, tile_half);   // dV += round(P^T).dO of the last tile
      rs_issue<D, BQ / 16>(dk, dsa, q_last, tile_half);   // dK += round(dS^T).Q of the last tile
    }
    if constexpr (KV_REGS) {
      rs_issue_t<D, BQ>(s, ka, q_t, tile_half);    // S^T = K.Q^T
      rs_issue_t<D, BQ>(dp, va, do_t, tile_half);  // dP^T = V.dO^T
    } else {
      ss_issue<D, BQ>(s, k_w, kv_half, q_t, tile_half);
      ss_issue<D, BQ>(dp, v_w, kv_half, do_t, tile_half);
    }
    pass_turn();
    wgmma_wait<1>();  // S^T, and the last tile's products, done
    fence_regs(s);
    if (j > 0) {  // the last tile's slot is free: refill it
      const int free_slot = (j - 1) % STAGES;
      if (lane == 0) mbar_arrive(bar(1 + STAGES + free_slot));
      if (tid == WG && j - 1 + STAGES < n_tiles) {
        mbar_wait(bar(1 + STAGES + free_slot), ((j - 1) / STAGES) & 1);
        load_tile(j - 1 + STAGES);
      }
    }
    const float* lse2 = vecs + st * 2 * BQ;
    const float* di = lse2 + BQ;
#pragma unroll
    for (int c = 0; c < BQ / 8; ++c) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * c + 2 * t4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        s[4 * c + 2 * r] = keep[r] ? exp2_approx(fmaf(s[4 * c + 2 * r], scale_log2, -l2.x)) : 0.f;
        s[4 * c + 2 * r + 1] = keep[r] ? exp2_approx(fmaf(s[4 * c + 2 * r + 1], scale_log2, -l2.y)) : 0.f;
      }
    }
    pack_a<BQ>(pa, s);
    wgmma_wait<0>();  // dP^T done
    fence_regs(dp);
#pragma unroll
    for (int c = 0; c < BQ / 8; ++c) {
      const float2 d2 = *reinterpret_cast<const float2*>(di + 8 * c + 2 * t4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dp[4 * c + 2 * r] = s[4 * c + 2 * r] * (dp[4 * c + 2 * r] - d2.x) * sm_scale;
        dp[4 * c + 2 * r + 1] = s[4 * c + 2 * r + 1] * (dp[4 * c + 2 * r + 1] - d2.y) * sm_scale;
      }
    }
    pack_a<BQ>(dsa, dp);
    q_last = q_t;
    do_last = do_t;
  }
  turn();
  rs_issue<D, BQ / 16>(dv, pa, do_last, tile_half);
  rs_issue<D, BQ / 16>(dk, dsa, q_last, tile_half);
  pass_turn();
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
  // dk and dv where this warpgroup's K and V were (no other warpgroup reads those rows)
  stage_acc<D>(base, kv_half, 64 * wg, dk, r_lo, t4);
  stage_acc<D>(base + S::KV, kv_half, 64 * wg, dv, r_lo, t4);
  fence_async_smem();
  named_sync(DONE_BAR + wg, WG);
  if (tid % WG == 0 && n0 + 64 * wg < Skv) {
    for (int hh = 0; hh < G::HALVES; ++hh) {
      tma_store_3d(&tdk, k_w + hh * kv_half, h * D + hh * 64, n0 + 64 * wg, b);
      tma_store_3d(&tdv, v_w + hh * kv_half, h * D + hh * 64, n0 + 64 * wg, b);
    }
    tma_store_commit();
    tma_store_done();
  }
}

// K5 (dq), one CTA per (128 queries, head, batch): two warpgroups of 64
// queries. The CTA's Q and dO land once and stay (at D = 64 also as register A
// operands); lse2 and di of each thread's two queries sit in registers. K and
// V tiles of KT keys stream through the ring; each warp forms a tile's key
// mask as ballot words, its loads issued a tile ahead. Per tile: S =
// Q.K^T and dP = dO.V^T (RS at D = 64, SS at D = 128; K and V K-major B); P =
// ex2(S * scale * log2 e - lse2), 0 on a masked key, while dP runs; dS = P *
// (dP - di) * scale; then, issued with the next tile's scores, dQ +=
// round(dS).K (RS, K an MN-major B). The warpgroups take turns at the tensor
// cores. dq is staged where the warpgroup's Q was and leaves by TMA store.
//
// FORM_DI = false (K5): lse is K3's [B, H, Sq], di given (rows (b, h) di_rs
// apart). FORM_DI = true (K2's dq): lse is K1's [B, Sq, H], and a first pass
// over the key tiles (the same S and dP products, turns and mask) sums p * dp
// into di for the CTA's rows before K5's loop; the CTA then writes lse2 and
// di into ws = [2][B * H][di_rs], the workspace of bwd_dkv_hopper. The ring
// carries every key tile twice; where each tile has a slot of its own
// (Skv <= STAGES * KT: DiT-B/2's 256 keys), K and V land once and stay in
// their slots for both passes.
template <int D, bool FORM_DI>
__device__ __forceinline__ void bwd_dq_hopper(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                                              const CUtensorMap& tdo, const CUtensorMap& tdq,
                                              const int* __restrict__ mask, const float* __restrict__ lse,
                                              const float* __restrict__ di, float* __restrict__ ws, int Sq, int Skv,
                                              int H, int di_rs, float sm_scale) {
  using G = Geometry<D>;
  using S = DqSmem<D>;
  constexpr int KT = S::KT;
  constexpr bool QD_REGS = D == 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem), qd_half = HB_ROWS * G::ROWB, tile_half = KT * G::ROWB;
  // barriers: 0 the CTA's Q and dO landed; 1 + s slot s full; 1 + STAGES + s slot s free
  auto bar = [&](int i) { return base + S::BARS + 8 * i; };
  const int tid = threadIdx.x, b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * HB_ROWS;
  const int n_tiles = (Skv + KT - 1) / KT;
  // the ring's items: key tile i % n_tiles; with FORM_DI the di pass's n_tiles, then the dq pass's
  const int n_items = FORM_DI ? 2 * n_tiles : n_tiles;
  const bool resident = FORM_DI && n_tiles <= STAGES;  // item i stays in slot i % n_tiles, loaded once
  auto slot = [&](int i) { return resident ? i % n_tiles : i % STAGES; };
  auto parity = [&](int i) { return resident ? 0u : static_cast<uint32_t>((i / STAGES) & 1); };
  auto load_item = [&](int i) {
    const int s = slot(i), t = i % n_tiles;
    const uint32_t dst = base + S::RING + s * 2 * S::TILE;
    mbar_expect_tx(bar(1 + s), 2 * S::TILE);
    load_rows<D>(dst, &tk, b, h, t * KT, KT, tile_half, bar(1 + s));
    load_rows<D>(dst + S::TILE, &tv, b, h, t * KT, KT, tile_half, bar(1 + s));
  };

  if (tid == 0) {
    mbar_init(bar(0), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar(1 + s), 1);
      mbar_init(bar(1 + STAGES + s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    const int q_rows = loaded_rows(m0, Sq);
    mbar_expect_tx(bar(0), 2 * q_rows * D * 2);
    load_rows<D>(base, &tq, b, h, m0, q_rows, qd_half, bar(0));
    load_rows<D>(base + S::QD, &tdo, b, h, m0, q_rows, qd_half, bar(0));
    for (int i = 0; i < STAGES && i < (resident ? n_tiles : n_items); ++i) load_item(i);
  }

  const int wg = tid / WG, warp = (tid % WG) / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int r_lo = 16 * warp + g;  // this thread's queries: rows r_lo and r_lo + 8 of the warpgroup's 64
  // item i is done with: once all eight warps have released its slot, refilled with item i + STAGES
  auto release = [&](int i) {
    if (resident) return;
    const int s = i % STAGES;
    if (lane == 0) mbar_arrive(bar(1 + STAGES + s));
    if (tid == WG && i + STAGES < n_items) {
      mbar_wait(bar(1 + STAGES + s), (i / STAGES) & 1);
      load_item(i + STAGES);
    }
  };
  const float scale_log2 = sm_scale * LOG2E;
  float l2[2], dd[2];  // lse in log2 units (+inf past Sq: p = 0 there) and di of the two queries
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + 64 * wg + r_lo + 8 * r;
    const long long at = FORM_DI ? ((long long)b * Sq + row) * H + h : ((long long)b * H + h) * Sq + row;
    l2[r] = row < Sq ? lse[at] * LOG2E : INFINITY;
    dd[r] = FORM_DI || row >= Sq ? 0.f : di[((long long)b * H + h) * di_rs + row];
  }
  const int* mrow = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  // a key kept: in range and not masked (a tile's rows past Skv load as zeros, fully-OOB boxes too)
  auto kept_key = [&](int key) { return key < Skv && (mrow == nullptr || mrow[key] != 0); };
  const uint32_t q_w = base + wg * 64 * G::ROWB, do_w = q_w + S::QD;
  auto turn = [&]() { named_sync(SCHED_BAR + wg, 2 * WG); };
  auto pass_turn = [&]() { named_arrive(SCHED_BAR + 1 - wg, 2 * WG); };
  if (wg == 1) pass_turn();

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float s[KT / 2], dp[KT / 2];
  uint32_t dsa[KT / 16][4];
  uint32_t qa[QD_REGS ? D / 16 : 1][4], doa[QD_REGS ? D / 16 : 1][4];
  bool next[KT / 32];  // this lane's keys of the next tile kept: the mask of tile 0 first
#pragma unroll
  for (int w = 0; w < KT / 32; ++w) next[w] = kept_key(32 * w + lane);
  mbar_wait(bar(0), 0);
  if constexpr (QD_REGS) {
    load_a<D>(qa, base, qd_half, 64 * wg, warp, g, t4);
    load_a<D>(doa, base + S::QD, qd_half, 64 * wg, warp, g, t4);
  }
  // this tile's mask words from `next` (bit 8c + e of word w: key 32w + 8c + 2 t4 + e of the tile
  // kept); `next` then reads tile next_tile's mask, a tile ahead
  auto mask_words = [&](uint32_t (&words)[KT / 32], int next_tile) {
#pragma unroll
    for (int w = 0; w < KT / 32; ++w) {
      words[w] = __ballot_sync(0xffffffffu, next[w]) >> (2 * t4);
      next[w] = kept_key(next_tile * KT + 32 * w + lane);
    }
  };
  auto probs = [&](const uint32_t (&words)[KT / 32]) {  // s <- p, 0 on a masked key
#pragma unroll
    for (int c = 0; c < KT / 8; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * c + 2 * r + e;
          const bool kept = (words[c / 4] >> (8 * (c % 4) + e)) & 1u;
          s[i] = kept ? exp2_approx(fmaf(s[i], scale_log2, -l2[r])) : 0.f;
        }
  };
  auto issue_scores = [&](uint32_t k_t, uint32_t v_t) {  // issued and committed, not awaited
    if constexpr (QD_REGS) {
      rs_issue_t<D, KT>(s, qa, k_t, tile_half);    // S = Q.K^T
      rs_issue_t<D, KT>(dp, doa, v_t, tile_half);  // dP = dO.V^T
    } else {
      ss_issue<D, KT>(s, q_w, qd_half, k_t, tile_half);
      ss_issue<D, KT>(dp, do_w, qd_half, v_t, tile_half);
    }
  };

  if constexpr (FORM_DI) {  // the di pass: di = rowsum(p * dp) over every key, from the fp32 p and dp
    float part[2] = {0.f, 0.f};
    for (int j = 0; j < n_tiles; ++j) {
      const int st = slot(j);
      const uint32_t k_t = base + S::RING + st * 2 * S::TILE, v_t = k_t + S::TILE;
      uint32_t words[KT / 32];
      mask_words(words, (j + 1) % n_tiles);
      mbar_wait(bar(1 + st), parity(j));
      turn();
      issue_scores(k_t, v_t);
      pass_turn();
      wgmma_wait<1>();  // S done
      fence_regs(s);
      probs(words);
      wgmma_wait<0>();  // dP done: the slot's K and V are read
      fence_regs(dp);
      release(j);
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) part[(i >> 1) & 1] += s[i] * dp[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dd[r] = quad_sum(part[r]);
      const int row = m0 + 64 * wg + r_lo + 8 * r;
      if (t4 == 0 && row < Sq) {
        const long long at = ((long long)b * H + h) * di_rs + row;
        ws[at] = l2[r];
        ws[(long long)gridDim.z * H * di_rs + at] = dd[r];
      }
    }
  }

  const int i0 = FORM_DI ? n_tiles : 0;  // the dq pass's first item
  uint32_t k_last = 0;  // the last tile's K, which its dQ product reads
  for (int j = 0; j < n_tiles; ++j) {
    const int st = slot(i0 + j);
    const uint32_t k_t = base + S::RING + st * 2 * S::TILE, v_t = k_t + S::TILE;
    uint32_t words[KT / 32];
    mask_words(words, j + 1);
    mbar_wait(bar(1 + st), parity(i0 + j));
    turn();
    if (j > 0) rs_issue<D, KT / 16>(dq, dsa, k_last, tile_half);  // dQ += round(dS).K of the last tile
    issue_scores(k_t, v_t);
    pass_turn();
    wgmma_wait<1>();  // S, and the last tile's dQ product, done
    fence_regs(s);
    if (j > 0) release(i0 + j - 1);
    probs(words);
    wgmma_wait<0>();  // dP done
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) dp[i] = s[i] * (dp[i] - dd[(i >> 1) & 1]) * sm_scale;
    pack_a<KT>(dsa, dp);
    k_last = k_t;
  }
  turn();
  rs_issue<D, KT / 16>(dq, dsa, k_last, tile_half);
  pass_turn();
  wgmma_wait<0>();
  fence_regs(dq);
  stage_acc<D>(base, qd_half, 64 * wg, dq, r_lo, t4);  // where this warpgroup's Q was
  fence_async_smem();
  named_sync(DONE_BAR + wg, WG);
  if (tid % WG == 0 && m0 + 64 * wg < Sq) {
    for (int hh = 0; hh < G::HALVES; ++hh) tma_store_3d(&tdq, q_w + hh * qd_half, h * D + hh * 64, m0 + 64 * wg, b);
    tma_store_commit();
    tma_store_done();
  }
}

// ---- host side

// one backward call: q/o/do [B, Sq, H, D] and k/v [B, Skv, H, D] at the
// given batch and row strides (elements), the key mask, lse, the fp32
// workspace ws (rows ws_rs apart) and di, the outputs
struct Args {
  const void *q, *k, *v, *o, *dout;
  const int* mask;
  const float* lse;
  float* ws;
  const float* di;  // rows of di, ws_rs apart
  void *dq, *dk, *dv;
  int B, Sq, Skv, H, ws_rs;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, do_sb, do_ss;
  float sm_scale;
};

// the current device, for the once-per-device opt-in to large shared memory
cudaError_t current_device(int& device) {
  const cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && (device < 0 || device >= MAX_DEVICES)) return cudaErrorInvalidDevice;
  return err;
}

// a __global__ wrapper of bwd_dkv_hopper<D> over the tensor maps (q, k, v,
// do, dk, dv), launched one CTA per (128 keys, head, batch); it reads lse2
// and di from a.ws. dk and dv: contiguous [B, Skv, H, D].
template <int D, typename Kernel>
cudaError_t launch_dkv_hopper(Kernel kernel, bool (&configured)[MAX_DEVICES], const Args& a, cudaStream_t stream) {
  using S = DkvSmem<D>;
  const long long out_ss = (long long)a.H * D, out_sb = (long long)a.Skv * out_ss;
  CUtensorMap maps[6];  // q, k, v, do, dk, dv
  if (!encode_rows(&maps[0], a.q, a.B, a.Sq, a.H, D, a.q_sb, a.q_ss, S::BQ) ||
      !encode_rows(&maps[1], a.k, a.B, a.Skv, a.H, D, a.k_sb, a.k_ss) ||
      !encode_rows(&maps[2], a.v, a.B, a.Skv, a.H, D, a.v_sb, a.v_ss) ||
      !encode_rows(&maps[3], a.dout, a.B, a.Sq, a.H, D, a.do_sb, a.do_ss, S::BQ) ||
      !encode_rows(&maps[4], a.dk, a.B, a.Skv, a.H, D, out_sb, out_ss) ||
      !encode_rows(&maps[5], a.dv, a.B, a.Skv, a.H, D, out_sb, out_ss))
    return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = current_device(device);
  if (err == cudaSuccess) err = allow_smem(kernel, configured, device);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Skv + HB_ROWS - 1) / HB_ROWS, a.H, a.B);
  kernel<<<grid, HB_THREADS, S::BYTES, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], a.mask, a.ws,
                                                 a.Sq, a.Skv, a.H, a.ws_rs, a.sm_scale);
  return cudaGetLastError();
}

// a __global__ wrapper of bwd_dq_hopper<D, FORM_DI> over the tensor maps (q,
// k, v, do, dq), launched one CTA per (128 queries, head, batch); K5 reads
// a.di, K2's dq writes a.ws. dq: contiguous [B, Sq, H, D].
template <int D, typename Kernel>
cudaError_t launch_dq_hopper(Kernel kernel, bool (&configured)[MAX_DEVICES], const Args& a, cudaStream_t stream) {
  const long long out_ss = (long long)a.H * D, out_sb = (long long)a.Sq * out_ss;
  CUtensorMap maps[5];  // q, k, v, do, dq
  if (!encode_rows(&maps[0], a.q, a.B, a.Sq, a.H, D, a.q_sb, a.q_ss) ||
      !encode_rows(&maps[1], a.k, a.B, a.Skv, a.H, D, a.k_sb, a.k_ss) ||
      !encode_rows(&maps[2], a.v, a.B, a.Skv, a.H, D, a.v_sb, a.v_ss) ||
      !encode_rows(&maps[3], a.dout, a.B, a.Sq, a.H, D, a.do_sb, a.do_ss) ||
      !encode_rows(&maps[4], a.dq, a.B, a.Sq, a.H, D, out_sb, out_ss))
    return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = current_device(device);
  if (err == cudaSuccess) err = allow_smem(kernel, configured, device);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + HB_ROWS - 1) / HB_ROWS, a.H, a.B);
  kernel<<<grid, HB_THREADS, DqSmem<D>::BYTES, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], a.mask, a.lse,
                                                         a.di, a.ws, a.Sq, a.Skv, a.H, a.ws_rs, a.sm_scale);
  return cudaGetLastError();
}

}  // namespace
