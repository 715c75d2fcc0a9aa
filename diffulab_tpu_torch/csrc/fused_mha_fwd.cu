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
// memory-bound. So each head's k and v should leave device memory once for
// many query rows, the scores never leave the SM, and only o and lse are
// written.
//
// bf16: q/k/v are read in the [B, S, H*D] layout the qkv projection writes (a
// head is a D-wide column slice at the caller's row and batch strides), and
// o written in [B, Sq, H*D], through TMA tensor maps with a {min(D, 64), 64,
// 1} box: a tile's o is staged in shared memory where its Q was and leaves in
// one TMA store, in whole 128-byte rows rather than 4-byte pieces. The box's
// swizzle (128, 64 or 32 bytes for a row of 64, 32 or 16 bf16) is the layout
// wgmma's shared-memory descriptors read; D = 128 takes two boxes a row, one
// per 64-column half. S = Q.K^T is wgmma m64n{CHUNK}k16 per 64-row tile, Q and
// K read from shared memory, K-major. When CHUNK = Skv (up to 256 keys; 128
// for D = 128) the whole row of scores stays in registers: row max and sum by
// quad shuffles, one reciprocal per row, p = exp(s - m) * (1 / l) rounded to
// bf16 straight into the register A operand of wgmma m64n{D}k16, V read from
// shared memory as an MN-major (transposed) B. One pass over the keys. For
// longer rows, pass 1 finds m and l chunk by chunk and pass 2 recomputes each
// chunk's scores. Scores are kept in log2 units (s * scale * log2 e) and
// exponentiated with ex2.approx.
//  - mha_fwd_resident<D, CHUNK>: a head's K and V fit in shared memory.
//    Persistent CTAs of two consumer warpgroups walk (batch, head, 128
//    queries) items; an item's K, then its V, land in shared memory once,
//    each on its own mbarrier. With two buffers the next item's Q, K and V
//    are in flight while this one computes, and the warpgroups take turns at
//    the tensor cores, so that one's exponentials overlap the other's
//    products.
//  - mha_fwd_streamed<D>: K + V beyond shared memory. One warpgroup a 64-row
//    tile; K, then K and V, stream through a two-slot TMA ring of 64 keys.
// fp32, mha_fwd_tf32x3<D>: the same function in fp32 (the fp32 instance of
// the TPU kernel, diffulab_tpu/ops/fused_mha.py:50). At slice C1's shapes
// (B=128, S=256, H=8, D=64) it does 17.2 GFLOP on 269.5 MB: 0.26 ms at the
// CUDA cores' 67 TFLOP/s against 0.08 ms of bytes, so it is bound by
// operations. The products run on the tensor cores as 3xTF32 (tf32x3.cuh:
// each operand split into two TF32 halves, three mma.sync products, about
// 2^-21 relative each): 3 x 17.2 GFLOP at 495 TFLOP/s is 0.10 ms. One CTA
// per (64 queries, head, batch), four warps of 16 rows; K and V stream in
// 32-key tiles through a two-slot cp.async ring; Q's split fragments stay in
// registers (D <= 64). One pass over the keys: an online row max and sum,
// the running O rescaled, P in registers as the A operand of P.V, and O / l
// at the end. That differs from the reference's "normalise p before PV" in
// rounding only: fp32 p is never rounded to a narrower type. Two products of
// [S x S x D], not the three of a two-pass softmax. At the UNets' head dims
// 192-512 the instances are built around the valid rows: in fp32
// mha_fwd_tf32x3_valid<D> at 192, 384 and 512 and mha_fwd_tf32x3_staged<D>
// (a slot of live keys, D staged in chunks, each warp's scores over the
// whole of D) at 256; in bf16 mha_fwd_bf16_staged<D>. At D = 64 the valid
// instances (mha_fwd_tf32x3_valid<64>, mha_fwd_bf16_valid<64>) take the
// padded short sequences (64, 72 or 264 tokens), which the caller picks by
// shape (valid_rows = 1), and the padded ones keep the rest.
//
// Plain C interface (bound with ctypes): fused_mha_fwd returns
// cudaGetLastError() after the launch. ops/fused_mha.py::forward_instance
// picks the bf16 instance (resident or streamed, CHUNK, buffers) from the
// shape alone.

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma and the tensor-map encoder
#include "tf32x3.cuh"  // the fp32 instance's 3xTF32 mma.sync fragments
#include "bf16_valid.cuh"  // the bf16 valid-rows instances' mma.sync fragments (D = 64, 192-512)

namespace {

constexpr float LN2 = 0.6931471805599453f;

constexpr int BLOCK_M = 64;          // query rows of a tile (one wgmma M)
constexpr int THREADS = 128;         // one warpgroup
constexpr int STREAM_CHUNK = 64;     // keys of a ring slot of the streaming instance

// bytes of dynamic shared memory of a bf16 instance: 1 KB of alignment slack;
// resident, `buffers` buffers of two Q tiles and a head's K and V; streamed,
// one Q tile and two ring slots of K and V; then the mbarriers.
// ops/fused_mha.py::_smem_bytes mirrors it.
constexpr int smem_bytes(int D, bool resident, int Skv, int buffers) {
  return 1024 + (resident ? buffers * (2 * BLOCK_M * D * 2 + 2 * Skv * D * 2)
                          : BLOCK_M * D * 2 + 2 * 2 * STREAM_CHUNK * D * 2) +
         128;
}

// ---- softmax pieces

// Scores are wgmma accumulators of 64 rows x CHUNK keys: s[4j + 2r + e] is
// row 16*warp + g + 8r, key 8j + 2*t4 + e (g = lane / 4, t4 = lane % 4).

// s = Q.K^T issued and committed (not awaited): q_addr the Q tile, k_addr the
// chunk's first key row, k_half the bytes between K's 64-column halves
template <int D, int CHUNK>
__device__ __forceinline__ void qk_issue(float (&s)[CHUNK / 2], uint32_t q_addr, uint32_t k_addr, uint32_t k_half) {
  using G = Geometry<D>;
#pragma unroll
  for (int i = 0; i < CHUNK / 2; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t half = kk / G::KSTEPS_PER_HALF, within = (kk % G::KSTEPS_PER_HALF) * 32;
    const uint64_t da = smem_desc(q_addr + half * TMA_ROWS * G::ROWB + within, 16, 8 * G::ROWB, G::SWIZZLE);
    const uint64_t db = smem_desc(k_addr + half * k_half + within, 16, 8 * G::ROWB, G::SWIZZLE);
    Wgmma<CHUNK>::ss(s, da, db, kk > 0);
  }
  wgmma_commit();
}

template <int D, int CHUNK>
__device__ __forceinline__ void qk_scores(float (&s)[CHUNK / 2], uint32_t q_addr, uint32_t k_addr, uint32_t k_half) {
  qk_issue<D, CHUNK>(s, q_addr, k_addr, k_half);
  wgmma_done(s);
}

// raw scores -> s * scale * log2(e); a masked key (0 in the batch's mask row
// `mrow`, when there is one) -> MASK_VALUE. The two keys a thread holds in an
// 8-key block are adjacent: one 8-byte load.
template <int CHUNK>
__device__ __forceinline__ void scale_and_mask(float (&s)[CHUNK / 2], float scale_log2, const int* mrow, int key0,
                                               int t4) {
  if (mrow == nullptr) {
#pragma unroll
    for (int i = 0; i < CHUNK / 2; ++i) s[i] *= scale_log2;
    return;
  }
#pragma unroll
  for (int j = 0; j < CHUNK / 8; ++j) {
    const int2 keep = *reinterpret_cast<const int2*>(mrow + key0 + 8 * j + 2 * t4);
    s[4 * j + 0] = keep.x ? s[4 * j + 0] * scale_log2 : MASK_VALUE;
    s[4 * j + 1] = keep.y ? s[4 * j + 1] * scale_log2 : MASK_VALUE;
    s[4 * j + 2] = keep.x ? s[4 * j + 2] * scale_log2 : MASK_VALUE;
    s[4 * j + 3] = keep.y ? s[4 * j + 3] * scale_log2 : MASK_VALUE;
  }
}

// s <- exp2(s - m) for both rows
template <int CHUNK>
__device__ __forceinline__ void exp_rows(float (&s)[CHUNK / 2], const float (&m)[2]) {
#pragma unroll
  for (int i = 0; i < CHUNK / 2; ++i) s[i] = exp2_approx(s[i] - m[(i >> 1) & 1]);
}

// raw scores s <- exp2(s * scale_log2 - m), the scale folded into one FMA (no
// mask); returns the two rows' sums, accumulated as the exponentials form
template <int CHUNK>
__device__ __forceinline__ void exp_rows_scaled(float (&s)[CHUNK / 2], float scale_log2, const float (&m)[2],
                                                float (&l)[2]) {
  float sum[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < CHUNK / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2_approx(fmaf(s[i], scale_log2, -m[r]));
    sum[r][(i >> 2) % 4] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

// pass 1 over one chunk: running max m and sum l = sum exp2(s - m)
template <int CHUNK>
__device__ __forceinline__ void online_update(const float (&s)[CHUNK / 2], float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], row_max<CHUNK>(s, r));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CHUNK / 8; ++j)
      sum += exp2_approx(s[4 * j + 2 * r] - m_new) + exp2_approx(s[4 * j + 2 * r + 1] - m_new);
    l[r] = l[r] * exp2_approx(m[r] - m_new) + quad_sum(sum);
    m[r] = m_new;
  }
}

// acc += round_bf16(p * inv) . V over CHUNK keys, issued and committed (not
// awaited): p in the score layout, which is the register A layout of m64k16
// for keys 16kk..16kk+15; v_addr the chunk's first key row of V, v_half the
// bytes between V's 64-column halves
template <int D, int CHUNK>
__device__ __forceinline__ void pv_issue(float (&acc)[D / 2], const float (&p)[CHUNK / 2], const float (&inv)[2],
                                         uint32_t v_addr, uint32_t v_half) {
  using G = Geometry<D>;
  uint32_t a[CHUNK / 16][4];
#pragma unroll
  for (int kk = 0; kk < CHUNK / 16; ++kk) {
    a[kk][0] = pack_bf16(p[8 * kk + 0] * inv[0], p[8 * kk + 1] * inv[0]);
    a[kk][1] = pack_bf16(p[8 * kk + 2] * inv[1], p[8 * kk + 3] * inv[1]);
    a[kk][2] = pack_bf16(p[8 * kk + 4] * inv[0], p[8 * kk + 5] * inv[0]);
    a[kk][3] = pack_bf16(p[8 * kk + 6] * inv[1], p[8 * kk + 7] * inv[1]);
  }
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < CHUNK / 16; ++kk) {
    // MN-major B: rows of 16 keys at ROWB bytes, 8-key groups SBO apart, 64-column halves LBO apart
    const uint64_t db = smem_desc(v_addr + kk * 16 * G::ROWB, v_half, 8 * G::ROWB, G::SWIZZLE);
    WgmmaRs<D>::rs(acc, a[kk], db, 1);
  }
  wgmma_commit();
}

template <int D, int CHUNK>
__device__ __forceinline__ void pv_accumulate(float (&acc)[D / 2], const float (&p)[CHUNK / 2], const float (&inv)[2],
                                              uint32_t v_addr, uint32_t v_half) {
  pv_issue<D, CHUNK>(acc, p, inv, v_addr, v_half);
  wgmma_done(acc);
}

// per thread, its two rows: max m and sum l (log2 units), 1 / l, fully masked
struct Rows {
  float m[2], l[2], inv[2];
  bool dead[2];

  __device__ __forceinline__ void finish(bool has_mask) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dead[r] = has_mask && m[r] <= MASK_VALUE;
      inv[r] = dead[r] ? 0.f : __frcp_rn(l[r]);
    }
  }
};

// The tile's o (rows r_lo and r_lo + 8 of this thread) into shared memory at
// dst in the layout of a TMA box of o (64-column halves, rows of ROWB bytes,
// 16-byte chunks swizzled by the row), for one TMA store; its lse straight to
// device memory, [B, Sq, H] fp32
template <int D>
__device__ __forceinline__ void stage_tile(uint32_t dst, float* lse, const float (&acc)[D / 2], const Rows& rows,
                                           int b, int h, int Sq, int H, int row_base, int r_lo, int t4) {
  using G = Geometry<D>;
  constexpr uint32_t SWZ = G::ROWB / 16 - 1;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t off = (col / 64) * TMA_ROWS * G::ROWB + (r_lo + 8 * r) * G::ROWB + (col % 64) * 2;
      off ^= ((off >> 7) & SWZ) << 4;
      const uint32_t val = rows.dead[r] ? 0u : pack_bf16(acc[4 * dn + 2 * r], acc[4 * dn + 2 * r + 1]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst + off), "r"(val) : "memory");
    }
  }
  fence_async_smem();
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse[((long long)b * Sq + row_base + r_lo + 8 * r) * H + h] =
          rows.dead[r] ? INFINITY : rows.m[r] * LN2 + logf(rows.l[r]);
  }
}

// Resident instance: persistent CTAs of two consumer warpgroups walk items
// (batch, head, 128 query rows), one 64-row tile per warpgroup. An item's two
// Q tiles and the head's K land on one mbarrier and its V on another. With two
// buffers, item i + 2's loads are issued as soon as both warpgroups are done
// with item i and its o stores have read their tiles (early in item i + 1),
// so they overlap item i + 1's compute. On the one-pass path the warpgroups
// take turns at the tensor cores (two named barriers): while one issues its
// Q.K^T or P.V, the other computes exponentials.
template <int D, int CHUNK>
__global__ void __launch_bounds__(2 * THREADS, 1)
mha_fwd_resident(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                 const int* __restrict__ mask, float* __restrict__ lse, int Sq, int Skv, int H, float sm_scale,
                 int n_items, int buffers) {
  using G = Geometry<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x, wg = tid / THREADS, wtid = tid % THREADS, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int r_lo = 16 * (wtid / 32) + g;  // this thread's rows of its tile: r_lo and r_lo + 8
  const int n_qt = Sq / BLOCK_M, n_pairs = (n_qt + 1) / 2, n_chunks = Skv / CHUNK;
  const float scale_log2 = sm_scale * LOG2E;

  // per buffer: two Q tiles | K | V; then per buffer three barriers: Q and K landed, V landed, warpgroup 0 done
  const uint32_t kv_bytes = Skv * D * 2, buf_bytes = 2 * G::TILE_BYTES + 2 * kv_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + buffers * buf_bytes);
  const uint32_t base = smem_u32(smem), kv_half = Skv * G::ROWB;
  auto bar = [&](int buf, int which) { return smem_u32(&bars[3 * buf + which]); };

  if (tid == 0) {
    for (int i = 0; i < 3 * buffers; ++i) mbar_init(smem_u32(&bars[i]), 1);
    fence_barrier_init();
  }
  __syncthreads();

  // item -> (batch, head, pair of query tiles), pairs fastest
  auto decode = [&](int item, int& b, int& h, int& pair) {
    const unsigned bh = unsigned(item) / unsigned(n_pairs);
    pair = item - int(bh) * n_pairs;
    b = int(bh / unsigned(H));
    h = int(bh) - b * H;
  };
  auto issue = [&](int item, int buf) {  // K first, so that Q.K^T starts while V lands
    int b, h, pair;
    decode(item, b, h, pair);
    const int tiles = min(2, n_qt - 2 * pair);
    const uint32_t q_dst = base + buf * buf_bytes, k_dst = q_dst + 2 * G::TILE_BYTES;
    mbar_expect_tx(bar(buf, 0), tiles * G::TILE_BYTES + kv_bytes);
    for (int t = 0; t < tiles; ++t)
      load_rows<D>(q_dst + t * G::TILE_BYTES, &tq, b, h, (2 * pair + t) * BLOCK_M, BLOCK_M, TMA_ROWS * G::ROWB,
                   bar(buf, 0));
    load_rows<D>(k_dst, &tk, b, h, 0, Skv, kv_half, bar(buf, 0));
    mbar_expect_tx(bar(buf, 1), kv_bytes);
    load_rows<D>(k_dst + kv_bytes, &tv, b, h, 0, Skv, kv_half, bar(buf, 1));
  };

  const int first = blockIdx.x, stride = gridDim.x;
  if (tid == 0)
    for (int j = 0; j < buffers && first + j * stride < n_items; ++j) issue(first + j * stride, j);
  // a buffer is free once both warpgroups are done with its item and their o
  // stores have read it: warpgroup 0's first thread reports, warpgroup 1's
  // waits for that and refills it with the item `buffers` strides on
  auto release = [&](int done_item, int done_buf, uint32_t done_parity) {
    if (wtid != 0) return;
    tma_store_read_done();
    const int next = done_item + buffers * stride;
    if (wg == 0) {
      mbar_arrive(bar(done_buf, 2));
    } else if (next < n_items) {
      mbar_wait(bar(done_buf, 2), done_parity);
      issue(next, done_buf);
    }
  };
  auto turn = [&]() { named_sync(SCHED_BAR + wg, 2 * THREADS); };
  auto pass_turn = [&]() { named_arrive(SCHED_BAR + 1 - wg, 2 * THREADS); };
  if (wg == 1) pass_turn();  // warpgroup 0 takes the tensor cores first

  int i = 0;
  for (int item = first; item < n_items; item += stride, ++i) {
    const int buf = buffers == 2 ? i & 1 : 0;
    const uint32_t parity = buffers == 2 ? (i >> 1) & 1 : i & 1;
    int b, h, pair;
    decode(item, b, h, pair);
    const int tile = 2 * pair + wg;
    const int* mrow = mask == nullptr ? nullptr : mask + (long long)b * Skv;
    const uint32_t q_addr = base + buf * buf_bytes + wg * G::TILE_BYTES;
    const uint32_t k_addr = base + buf * buf_bytes + 2 * G::TILE_BYTES, v_addr = k_addr + kv_bytes;
    // the last item's buffer: released once this warpgroup's o store has read
    // it (and, for warpgroup 1, once warpgroup 0 has released it too), then
    // refilled; with one buffer before this item's wait, with two after it, so
    // that the last store's read overlaps that wait
    if (buffers == 1 && i > 0) release(item - stride, 0, (i - 1) & 1);
    mbar_wait(bar(buf, 0), parity);
    if (buffers == 2 && i > 0) release(item - stride, (i - 1) & 1, ((i - 1) >> 1) & 1);
    if (n_chunks == 1) {  // the whole row in registers: one pass
      if (tile < n_qt) {
        float acc[D / 2];
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
        Rows rows;
        float s[CHUNK / 2];
        turn();
        qk_issue<D, CHUNK>(s, q_addr, k_addr, kv_half);
        pass_turn();
        wgmma_done(s);
        if (mrow == nullptr) {  // the max of the raw scores, the scale folded into the exponent
          rows.m[0] = row_max<CHUNK>(s, 0) * scale_log2;
          rows.m[1] = row_max<CHUNK>(s, 1) * scale_log2;
          exp_rows_scaled<CHUNK>(s, scale_log2, rows.m, rows.l);
        } else {
          scale_and_mask<CHUNK>(s, scale_log2, mrow, 0, t4);
          rows.m[0] = row_max<CHUNK>(s, 0);
          rows.m[1] = row_max<CHUNK>(s, 1);
          exp_rows<CHUNK>(s, rows.m);
          rows.l[0] = row_sum<CHUNK>(s, 0);
          rows.l[1] = row_sum<CHUNK>(s, 1);
        }
        rows.finish(mrow != nullptr);
        mbar_wait(bar(buf, 1), parity);
        turn();
        pv_issue<D, CHUNK>(acc, s, rows.inv, v_addr, kv_half);
        pass_turn();
        wgmma_done(acc);
        stage_tile<D>(q_addr, lse, acc, rows, b, h, Sq, H, tile * BLOCK_M, r_lo, t4);  // Q is done with
      } else {  // the second warpgroup idles on an odd last tile, keeping its turns
        turn();
        pass_turn();
        turn();
        pass_turn();
      }
    } else if (tile < n_qt) {  // pass 1: m and l chunk by chunk; pass 2: the scores again from the resident K, then PV
      float acc[D / 2];
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
      Rows rows;
      rows.m[0] = rows.m[1] = -INFINITY;
      rows.l[0] = rows.l[1] = 0.f;
      for (int c = 0; c < n_chunks; ++c) {
        float s[CHUNK / 2];
        qk_scores<D, CHUNK>(s, q_addr, k_addr + c * CHUNK * G::ROWB, kv_half);
        scale_and_mask<CHUNK>(s, scale_log2, mrow, c * CHUNK, t4);
        online_update<CHUNK>(s, rows.m, rows.l);
      }
      rows.finish(mrow != nullptr);
      mbar_wait(bar(buf, 1), parity);
      for (int c = 0; c < n_chunks; ++c) {
        float s[CHUNK / 2];
        qk_scores<D, CHUNK>(s, q_addr, k_addr + c * CHUNK * G::ROWB, kv_half);
        scale_and_mask<CHUNK>(s, scale_log2, mrow, c * CHUNK, t4);
        exp_rows<CHUNK>(s, rows.m);
        pv_accumulate<D, CHUNK>(acc, s, rows.inv, v_addr + c * CHUNK * G::ROWB, kv_half);
      }
      stage_tile<D>(q_addr, lse, acc, rows, b, h, Sq, H, tile * BLOCK_M, r_lo, t4);
    }

    // the tile's o leaves through one TMA store from where its Q was
    named_sync(DONE_BAR + wg, THREADS);
    if (wtid == 0 && tile < n_qt) store_tile<D>(&to, q_addr, b, h, tile * BLOCK_M);
  }
  if (wtid == 0) tma_store_done();
}

// Streamed instance (a head's K and V beyond shared memory): one warpgroup and
// one 64-row query tile a CTA; K (pass 1), then K and V (pass 2), stream
// through a ring of two slots of STREAM_CHUNK keys, each slot refilled once
// every warp's wgmma is done with it.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
mha_fwd_streamed(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                 const int* __restrict__ mask, float* __restrict__ lse, int Sq, int Skv, int H, float sm_scale) {
  using G = Geometry<D>;
  constexpr int CHUNK = STREAM_CHUNK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, tile = blockIdx.x;
  const int n_chunks = Skv / CHUNK;
  const float scale_log2 = sm_scale * LOG2E;

  // Q | two slots of K then V | barriers (Q, slot 0, slot 1)
  const uint32_t slot_bytes = 2 * CHUNK * D * 2, kv_half = CHUNK * G::ROWB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::TILE_BYTES + 2 * slot_bytes);
  const uint32_t q_addr = smem_u32(smem), ring = q_addr + G::TILE_BYTES;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(smem_u32(&bars[i]), 1);
    fence_barrier_init();
  }
  __syncthreads();

  // item j < n_chunks is chunk j's K (pass 1), item n_chunks + c chunk c's K and V (pass 2)
  auto load_item = [&](int j) {
    const int c = j < n_chunks ? j : j - n_chunks;
    const uint32_t bar = smem_u32(&bars[1 + (j & 1)]), dst = ring + (j & 1) * slot_bytes;
    mbar_expect_tx(bar, (j < n_chunks ? 1 : 2) * CHUNK * D * 2);
    load_rows<D>(dst, &tk, b, h, c * CHUNK, CHUNK, kv_half, bar);
    if (j >= n_chunks) load_rows<D>(dst + CHUNK * D * 2, &tv, b, h, c * CHUNK, CHUNK, kv_half, bar);
  };

  if (tid == 0) {
    mbar_expect_tx(smem_u32(&bars[0]), G::TILE_BYTES);
    load_rows<D>(q_addr, &tq, b, h, tile * BLOCK_M, BLOCK_M, TMA_ROWS * G::ROWB, smem_u32(&bars[0]));
    load_item(0);
    load_item(1);
  }
  const int* mrow = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  mbar_wait(smem_u32(&bars[0]), 0);

  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  Rows rows;
  rows.m[0] = rows.m[1] = -INFINITY;
  rows.l[0] = rows.l[1] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    mbar_wait(smem_u32(&bars[1 + (c & 1)]), (c >> 1) & 1);
    float s[CHUNK / 2];
    qk_scores<D, CHUNK>(s, q_addr, ring + (c & 1) * slot_bytes, kv_half);
    __syncthreads();  // every warp's wgmma is done with the slot
    if (tid == 0 && c + 2 < 2 * n_chunks) load_item(c + 2);
    scale_and_mask<CHUNK>(s, scale_log2, mrow, c * CHUNK, t4);
    online_update<CHUNK>(s, rows.m, rows.l);
  }
  rows.finish(mrow != nullptr);
  for (int c = 0; c < n_chunks; ++c) {
    const int j = n_chunks + c;
    mbar_wait(smem_u32(&bars[1 + (j & 1)]), (j >> 1) & 1);
    const uint32_t slot = ring + (j & 1) * slot_bytes;
    float s[CHUNK / 2];
    qk_scores<D, CHUNK>(s, q_addr, slot, kv_half);
    scale_and_mask<CHUNK>(s, scale_log2, mrow, c * CHUNK, t4);
    exp_rows<CHUNK>(s, rows.m);
    pv_accumulate<D, CHUNK>(acc, s, rows.inv, slot + CHUNK * D * 2, kv_half);
    __syncthreads();
    if (tid == 0 && j + 2 < 2 * n_chunks) load_item(j + 2);
  }
  stage_tile<D>(q_addr, lse, acc, rows, b, h, Sq, H, tile * BLOCK_M, 16 * warp + g, t4);  // Q is done with
  __syncthreads();
  if (tid == 0) {
    store_tile<D>(&to, q_addr, b, h, tile * BLOCK_M);
    tma_store_done();
  }
}

// ---- fp32: 3xTF32 products on the tensor cores (tf32x3.cuh)

// keys of a ring slot: 32, so that three CTAs (twelve warps) fit on an SM at
// D = 64 (52 KB of shared memory and 167 registers a thread each); with
// 64-key slots two fit, and the kernel took 0.4340 ms at C1's B=128 against
// 0.3606 (scripts/fp32_attn_variants.py, NVIDIA H100 80GB HBM3, 700 W)
constexpr int F32_KEYS = 32;

// bytes of dynamic shared memory: the CTA's 64 Q rows and two ring slots of K and V
template <int D>
__host__ __device__ constexpr int f32_smem_bytes() {
  return 4 * ld<D>() * (F32_ROWS + 2 * 2 * F32_KEYS);
}

// One CTA per (64 queries, head, batch), four warps of 16 query rows, one
// pass over the keys: each key tile's scores S = Q.K^T, the running row max
// and sum updated online (the running O rescaled), P = exp(S - m) in C layout
// straight into the A operand of O += P.V. O / l at the end. D <= 128: a warp
// holds its rows' whole output (64 accumulators a thread at 128).
template <int D>
__global__ void __launch_bounds__(F32_THREADS)
mha_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
               const int* __restrict__ mask, float* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int H,
               long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb, long long v_ss,
               float sm_scale) {
  constexpr int KT = F32_KEYS, LD = ld<D>();
  constexpr bool QREG = D <= 64;  // Q's split fragments stay in registers for every key tile
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // [64][LD]
  float* ks = qs + F32_ROWS * LD;  // [2][KT][LD]
  float* vs = ks + 2 * KT * LD;    // [2][KT][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * F32_ROWS, r0 = 16 * warp;
  const float* kb = k + b * k_sb + h * D;
  const float* vb = v + b * v_sb + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  const int n_tiles = Skv / KT;

  stage_rows<D, F32_ROWS>(qs, q + b * q_sb + h * D, q_ss, m0);
  cp_async_commit();
  stage_rows<D, KT>(ks, kb, k_ss, 0);
  stage_rows<D, KT>(vs, vb, v_ss, 0);
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
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8; l summed over the quad at the end

  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t & 1;
    if (t + 1 < n_tiles) {
      stage_rows<D, KT>(ks + (slot ^ 1) * KT * LD, kb, k_ss, (t + 1) * KT);
      stage_rows<D, KT>(vs + (slot ^ 1) * KT * LD, vb, v_ss, (t + 1) * KT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + slot * KT * LD;
    float s[KT / 8][4];
    if constexpr (QREG)
      rows_dot<D, KT>(s, qh, ql, kt, g, t4);
    else
      rows_dot<D, KT>(s, qs, r0, kt, g, t4);

    // scale, mask, and the tile's row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
      const int2 keep = mb == nullptr ? make_int2(1, 1)
                                      : *reinterpret_cast<const int2*>(mb + t * KT + nt * 8 + 2 * t4);
      s[nt][0] = keep.x ? s[nt][0] * sm_scale : MASK_VALUE;
      s[nt][1] = keep.y ? s[nt][1] * sm_scale : MASK_VALUE;
      s[nt][2] = keep.x ? s[nt][2] * sm_scale : MASK_VALUE;
      s[nt][3] = keep.y ? s[nt][3] * sm_scale : MASK_VALUE;
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);  // 0 on the first tile (m = -inf)
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
      for (int j = 0; j < 4; ++j) {
        s[nt][j] = expf(s[nt][j] - m[j >> 1]);  // a masked key beside a real score: exactly 0
        l[j >> 1] += s[nt][j];
      }
    scores_times_tile<D, KT>(acc, s, vs + slot * KT * LD, g, t4);
    __syncthreads();  // the slot is refilled next iteration
  }

  // o = acc / l; a fully-masked row (m still MASK_VALUE) gives o = 0, lse = +inf
  bool dead[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    dead[r] = mb != nullptr && m[r] <= MASK_VALUE;
  }
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[dn][j] = dead[j >> 1] ? 0.f : acc[dn][j] / l[j >> 1];
  const long long o_ss = (long long)H * D;
  const int row = m0 + r0 + g;
  store_c_rows<D>(o + (long long)b * Sq * o_ss + h * D, o_ss, row, acc, t4);
  if (t4 == 0) {
    lse[((long long)b * Sq + row) * H + h] = dead[0] ? INFINITY : m[0] + logf(l[0]);
    lse[((long long)b * Sq + row + 8) * H + h] = dead[1] ? INFINITY : m[1] + logf(l[1]);
  }
}

// The fp32 instance of K1 (diffulab_tpu/ops/fused_mha.py:50) at the D1
// UNet's head dims, built around the valid rows (tf32x3.cuh,
// valid_rows_instance): 64 tokens at D = 192 (train_synthetic_ddpm, ds 4),
// 16 at D = 384 (ds 8), keys padded to 128 with the mask, and the MNIST
// UNet's 16 tokens at D = 512 (its 256 runs mha_fwd_tf32x3_staged below,
// which took this instance's place there; at 512 the staged one lost at the
// sampler's batch). At B=128, H=2 a call must read q, k and v and write o
// over the valid rows and keys, 50.4 / 25.2 MB at D = 192 / 384 (0.015 /
// 0.0075 ms at 3.35 TB/s),
// against 0.81 / 0.10 GFLOP (0.005 ms or less at 3xTF32): bound by bytes.
// Padded to 128 rows and walking every key tile, the instances before this
// design did 2x (64 tokens) and 8x (16) the bytes of q and o and 4x and 64x
// the score work. So: one CTA per (vr_rows queries, head, batch) of the
// UNPADDED query rows (32 at D = 192, 16 at 384 and 512), rows past Sq
// zero-filled in shared memory and never stored; a warp for each 16 rows in
// each column group of vr_cols output columns (2 groups at D = 192, 6 at
// 384, 4 at 512), each group
// forming the scores over its columns of D and the partial tiles added in
// group order. The ring
// brings only the key tiles of VR_TILE keys that hold an attended key: a tile
// whose mask is all 0 is neither loaded nor multiplied. That is exact: such a
// tile's p is exactly 0 after a live one, and before the first live one the
// online max it leaves (MASK_VALUE) is dropped by alpha = exp(MASK_VALUE - m)
// = 0. A batch row with no live tile writes o = 0, lse = +inf without loading
// Q. 52-104 KB of shared memory: 2 CTAs an SM, 4 at D = 192.
//
// At D = 64 the same instance serves the DiTs' short sequences that the fused
// route pads (64 or 72 tokens to 128 keys, 264 to 384), where the padded
// instance ran 128 query rows of which half or more were padding and every
// key tile, masked or not (PERF.md §6): at slice F1's deep path (B=128, 64
// tokens, H=8) a call must move 67 MB over the valid rows and keys, 0.020 ms
// at 3.35 TB/s, against 1.07 GFLOP (0.0065 ms at 3xTF32): bound by bytes.
// One group of warps holds the whole head, so a warp's scores never leave its
// registers and its rows' split Q fragments stay there for every key tile;
// 64 rows a CTA, key tiles of vr_tile = 32 keys, the CTA's live key tiles
// listed once (find_live_tiles); 52 KB of shared memory.
template <int D>
__global__ void __launch_bounds__(vr_threads<D>())
mha_fwd_tf32x3_valid(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const int* __restrict__ mask, float* __restrict__ o, float* __restrict__ lse, int Sq, int Skv,
                     int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                     long long v_ss, float sm_scale) {
  constexpr int KT = vr_tile<D>(), DO = vr_cols<D>(), ROWS = vr_rows<D>(), THREADS = vr_threads<D>(), LD = ld<D>();
  constexpr int ROW_WARPS = ROWS / 16, GROUPS = vr_groups<D>(), NS = VR_SLOTS;
  // one group (D = 64): no partial tiles, and Q's split fragments stay in registers for every key tile
  constexpr bool QREG = GROUPS == 1;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [ROWS][LD]
  float* ks = qs + ROWS * LD;       // [NS][KT][LD]
  float* vs = ks + NS * KT * LD;    // [NS][KT][LD]
  float* part = vs + NS * KT * LD;  // [GROUPS][ROWS][KT]: the groups' partial scores (GROUPS > 1)
  int* live = reinterpret_cast<int*>(part + (GROUPS > 1 ? GROUPS * ROWS * KT : 0));  // [Skv / KT + 1]: live tiles

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * ROWS, r0 = 16 * (warp % ROW_WARPS);
  const int grp = warp / ROW_WARPS, col0 = grp * DO;  // this warp's output columns: col0 + [0, DO)
  const bool active = m0 + r0 < Sq;  // the warp has a valid row
  const float* kb = k + b * k_sb + h * D;
  const float* vb = v + b * v_sb + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  const int n_tiles = Skv / KT;

  find_live_tiles<KT>(live, mb, n_tiles);
  __syncthreads();
  const int n_live = live[n_tiles];
  // the load sequence: the live tiles in order, NS - 1 of them loading while one is computed
  auto stage = [&](int j) {
    const int tile = live[j], slot = j % NS;
    stage_rows<D, KT, THREADS>(ks + slot * KT * LD, kb, k_ss, tile * KT);
    stage_rows<D, KT, THREADS>(vs + slot * KT * LD, vb, v_ss, tile * KT);
  };
  if (n_live > 0) stage_rows_upto<D, ROWS, THREADS>(qs, q + b * q_sb + h * D, q_ss, m0, Sq);
  for (int j = 0; j < NS - 1; ++j) {  // a group each, empty or not, so that the waits below count right
    if (j < n_live) stage(j);
    cp_async_commit();
  }

  float acc[DO / 8][4];
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8; l summed over the quad at the end
  uint32_t qh[QREG ? D / 8 : 1][4], ql[QREG ? D / 8 : 1][4];

  for (int i = 0; i < n_live; ++i) {
    if (i + NS - 1 < n_live) stage(i + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();  // live tile i has landed
    __syncthreads();
    const int slot = i % NS, cur = live[i];
    float s[KT / 8][4];
    if constexpr (QREG) {
      if (active) {
        if (i == 0)
#pragma unroll
          for (int kk = 0; kk < D / 8; ++kk) frag_a<D>(qh[kk], ql[kk], qs, r0, kk, g, t4);
        rows_dot<D, KT>(s, qh, ql, ks + slot * KT * LD, g, t4);
      }
    } else {
      if (active) {  // this group's columns of D
        rows_dot<DO, KT, LD>(s, qs + col0, r0, ks + slot * KT * LD + col0, g, t4);
        put_c<KT>(part + grp * ROWS * KT, s, r0, g, t4);
      }
      __syncthreads();
      if (active) sum_c<KT, GROUPS>(s, part, ROWS * KT, r0, g, t4);  // the whole of D, in group order
    }
    if (active) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
        const int2 keep = mb == nullptr ? make_int2(1, 1)
                                        : *reinterpret_cast<const int2*>(mb + cur * KT + nt * 8 + 2 * t4);
        s[nt][0] = keep.x ? s[nt][0] * sm_scale : MASK_VALUE;
        s[nt][1] = keep.y ? s[nt][1] * sm_scale : MASK_VALUE;
        s[nt][2] = keep.x ? s[nt][2] * sm_scale : MASK_VALUE;
        s[nt][3] = keep.y ? s[nt][3] * sm_scale : MASK_VALUE;
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = expf(m[r] - m_new);  // 0 on the first live tile (m = -inf)
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int dn = 0; dn < DO / 8; ++dn) {
        acc[dn][0] *= alpha[0];
        acc[dn][1] *= alpha[0];
        acc[dn][2] *= alpha[1];
        acc[dn][3] *= alpha[1];
      }
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[nt][j] = expf(s[nt][j] - m[j >> 1]);
          l[j >> 1] += s[nt][j];
        }
      scores_times_tile<DO, KT, LD>(acc, s, vs + slot * KT * LD + col0, g, t4);
    }
    __syncthreads();  // the slot and the partial tiles are written again
  }

  // o = acc / l; a row without an attended key (m still -inf or MASK_VALUE) gives o = 0, lse = +inf
  if (!active) return;
  bool dead[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    dead[r] = mb != nullptr && m[r] <= MASK_VALUE;
  }
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[dn][j] = dead[j >> 1] ? 0.f : acc[dn][j] / l[j >> 1];
  const long long o_ss = (long long)H * D;
  const int row = m0 + r0 + g;
  store_c_rows_upto<DO>(o + (long long)b * Sq * o_ss + h * D + col0, o_ss, row, acc, t4, Sq);
  if (grp == 0 && t4 == 0) {
    if (row < Sq) lse[((long long)b * Sq + row) * H + h] = dead[0] ? INFINITY : m[0] + logf(l[0]);
    if (row + 8 < Sq) lse[((long long)b * Sq + row + 8) * H + h] = dead[1] ? INFINITY : m[1] + logf(l[1]);
  }
}

// the partial score tiles of the column groups; none with one group
template <int D>
__host__ __device__ constexpr int vr_part_floats(int tile) {
  return vr_groups<D>() > 1 ? vr_groups<D>() * vr_rows<D>() * tile : 0;
}

template <int D>
__host__ __device__ constexpr int vr_fwd_smem_bytes() {
  return 4 * (ld<D>() * (vr_rows<D>() + VR_SLOTS * 2 * vr_tile<D>()) + vr_part_floats<D>(vr_tile<D>()));
}

// the ints after the tiles: the live key tiles of kt keys and their count
inline int vr_live_bytes(int skv, int kt) {
  return 4 * (skv / kt + 1);
}

// The fp32 instance of K1 (diffulab_tpu/ops/fused_mha.py:50) at the MNIST
// UNet's head dim 256 (64 tokens, keys padded to 128), staged (tf32x3.cuh,
// the vr_f32s rules). At B=128, H=2 a call must read q, k and v and write o
// over the valid rows and keys, 67.1 MB (0.020 ms at 3.35 TB/s): bound by
// bytes. The split instance above streams 8-key tiles, each its own ring
// wait, and splits the score reduction between 2 column groups that add
// their partial tiles in shared memory every tile. Here a CTA takes
// VR_F32S_FWD_ROWS unpadded query rows (a head's 64) and the live keys a slot
// of vr_f32s_slot at a time (the UNet's whole live row), gathered from the
// mask row's live 8-key tiles. Phase 1 walks D a chunk of VR_F32S_FWD_CHUNK
// columns at a time (Q and the slot's K through a ring of VR_F32S_STAGES
// cp.async stages): each warp forms its 16 rows' scores over the whole of D,
// each chunk's 3xTF32 product summed from zero and added in fp32 (T25), so
// no partial score crosses warps. Then K1's op order: m and l over the whole row,
// p = exp(s - m) / l normalised before P.V and kept in fp32 registers. Phase
// 2 walks V's chunks: o = p.V a chunk of columns at a time, each stored at
// once. A live row of more than one slot runs pass 0 (m and l over its
// slots), then each slot's scores anew and its P.V added to the stored o. A
// row without an attended key gives o = 0, lse = +inf.
template <int D>
__global__ void __launch_bounds__(VR_F32S_FWD_THREADS)
mha_fwd_tf32x3_staged(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const int* __restrict__ mask, float* __restrict__ o, float* __restrict__ lse, int Sq, int Skv,
                      int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                      long long v_ss, float sm_scale) {
  constexpr int KT = VR_TILE, SLOT = vr_f32s_slot<D>(), CT = SLOT / KT, ROWS = VR_F32S_FWD_ROWS;
  constexpr int C = VR_F32S_FWD_CHUNK, NC = D / C, LDC = C + 4, R = ROWS > SLOT ? ROWS : SLOT, TILE = R * LDC;
  constexpr int THREADS = VR_F32S_FWD_THREADS, NB = VR_F32S_STAGES;
  static_assert(C % 8 == 0 && D % C == 0 && SLOT % 8 == 0 && ROWS % 16 == 0 && THREADS == 32 * ROWS / 16,
                "the staged fp32 K1's tiles");
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                         // [NB][2][R][LDC]: chunks of Q and K, or of V
  int* live = reinterpret_cast<int*>(ring + NB * 2 * TILE);  // [Skv / KT + 1]: live tiles, count

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * ROWS, rb = warp;
  const int row = m0 + rb * 16 + g;   // this thread's rows: row, row + 8
  const bool active = m0 + rb * 16 < Sq;  // the warp has a valid row
  const long long o_ss = (long long)H * D;
  const float* qb = q + b * q_sb + h * D;
  const float* kb = k + b * k_sb + h * D;
  const float* vb = v + b * v_sb + h * D;
  float* ob = o + (long long)b * Sq * o_ss + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  const int n_tiles = Skv / KT;

  find_live_tiles<KT>(live, mb, n_tiles);
  __syncthreads();
  const int n_live = live[n_tiles], n_slots = (n_live + CT - 1) / CT;
  const bool kept = n_slots == 1;  // the same for every thread: one pass, p in registers from the scores to P.V
  if (n_live == 0) {  // no attended key: o = 0, lse = +inf
    for (int i = threadIdx.x; i < ROWS * (D / 4); i += THREADS) {
      const int r = m0 + i / (D / 4);
      if (r < Sq) *reinterpret_cast<float4*>(ob + (long long)r * o_ss + (i % (D / 4)) * 4) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int r = m0 + threadIdx.x; r < m0 + ROWS && r < Sq; r += THREADS) lse[((long long)b * Sq + r) * H + h] = INFINITY;
    return;
  }
  // the loads, item i: kept, the chunks of Q and K (i < NC), then of V; else pass 0's chunks of Q and K of each
  // slot, then pass 1's, each slot's chunks of Q and K, then of V
  const int n_items = kept ? 2 * NC : 3 * NC * n_slots;
  auto decode = [&](int i, int& c, int& ch, bool& is_v, bool& pass1) {
    if (kept) {
      c = 0, ch = i % NC, is_v = i >= NC, pass1 = true;
    } else if (i < NC * n_slots) {
      c = i / NC, ch = i % NC, is_v = false, pass1 = false;
    } else {
      const int j = i - NC * n_slots;
      c = j / (2 * NC), ch = j % NC, is_v = j % (2 * NC) >= NC, pass1 = true;
    }
  };
  auto stage = [&](int i) {
    int c, ch;
    bool is_v, pass1;
    decode(i, c, ch, is_v, pass1);
    float* st = ring + (i % NB) * 2 * TILE;
    const int n = min(CT, n_live - c * CT);
    if (is_v) {
      stage_chunk_tiles<C, SLOT, KT, THREADS>(st, vb, v_ss, live + c * CT, n, ch * C);
    } else {
      stage_chunk_rows<C, ROWS, THREADS>(st, qb, q_ss, m0, Sq, ch * C);
      stage_chunk_tiles<C, SLOT, KT, THREADS>(st + TILE, kb, k_ss, live + c * CT, n, ch * C);
    }
  };
  for (int i = 0; i < NB - 1; ++i) {  // a group each, empty or not, so that the waits below count right
    if (i < n_items) stage(i);
    cp_async_commit();
  }

  float s[SLOT / 8][4];  // the warp's scores of the slot, then its p
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, lsum[2] = {1.f, 1.f};  // rows g, g + 8
  for (int i = 0; i < n_items; ++i) {
    if (i + NB - 1 < n_items) stage(i + NB - 1);
    cp_async_commit();
    cp_async_wait<NB - 1>();  // item i has landed
    __syncthreads();
    int c, ch;
    bool is_v, pass1;
    decode(i, c, ch, is_v, pass1);
    const float* st = ring + (i % NB) * 2 * TILE;
    if (!is_v && active) {  // this chunk's scores, summed from zero, added to the sums
      if (ch == 0)
#pragma unroll
        for (int nt = 0; nt < SLOT / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      rows_dot_add<C, SLOT, LDC, 1>(s, st, rb * 16, st + TILE, g, t4);
      if (ch == NC - 1) {  // the slot's scores are whole: scale and mask; a key past the slot's tiles -inf
        const int n = min(CT, n_live - c * CT);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < SLOT / 8; ++nt) {
          const int col = nt * 8 + 2 * t4, j = col / KT;
          if (j >= n) {
            s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = -INFINITY;
            continue;
          }
          const int key = live[c * CT + j] * KT + col % KT;
          const int2 keep = mb == nullptr ? make_int2(1, 1) : *reinterpret_cast<const int2*>(mb + key);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = ((e & 1) ? keep.y : keep.x) ? s[nt][e] * sm_scale : MASK_VALUE;
          mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
        }
        if (!pass1 || kept) {  // the row max and sum, slot by slot
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m[r], quad_max(mx[r]));
            l[r] *= expf(m[r] - m_new);  // 0 on the first slot (m = -inf)
            m[r] = m_new;
          }
#pragma unroll
          for (int nt = 0; nt < SLOT / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) l[e >> 1] += expf(s[nt][e] - m[e >> 1]);
          if (kept || c == n_slots - 1) {  // l over the whole row
            lsum[0] = quad_sum(l[0]);
            lsum[1] = quad_sum(l[1]);
          }
        }
        if (pass1) {  // p = exp(s - m) / l, normalised before P.V; a row without an attended key 0
          const bool dead[2] = {mb != nullptr && m[0] <= MASK_VALUE, mb != nullptr && m[1] <= MASK_VALUE};
#pragma unroll
          for (int nt = 0; nt < SLOT / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = dead[e >> 1] ? 0.f : expf(s[nt][e] - m[e >> 1]) / lsum[e >> 1];
        }
      }
    } else if (is_v && active) {  // o = p.V over this chunk's columns, stored, or added to the earlier slots'
      float acc[C / 8][4];
#pragma unroll
      for (int dn = 0; dn < C / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
      scores_times_tile<C, SLOT, LDC>(acc, s, st, g, t4);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (row + 8 * half >= Sq) continue;
        float* dst = ob + (long long)(row + 8 * half) * o_ss + ch * C + 2 * t4;
#pragma unroll
        for (int dn = 0; dn < C / 8; ++dn) {
          float2 val = make_float2(acc[dn][2 * half], acc[dn][2 * half + 1]);
          if (c > 0) {
            const float2 was = *reinterpret_cast<const float2*>(dst + dn * 8);
            val = make_float2(was.x + val.x, was.y + val.y);
          }
          *reinterpret_cast<float2*>(dst + dn * 8) = val;
        }
      }
    }
    __syncthreads();  // the stage is written again
  }

  // lse = m + log l; a row without an attended key (m still MASK_VALUE) +inf
  if (active && t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool dead = mb != nullptr && m[r] <= MASK_VALUE;
      if (row + 8 * r < Sq) lse[((long long)b * Sq + row + 8 * r) * H + h] = dead ? INFINITY : m[r] + logf(lsum[r]);
    }
  }
}

template <int D>
__host__ __device__ constexpr int vr_f32s_fwd_smem_bytes() {
  constexpr int R = VR_F32S_FWD_ROWS > vr_f32s_slot<D>() ? VR_F32S_FWD_ROWS : vr_f32s_slot<D>();
  return 4 * VR_F32S_STAGES * 2 * R * (VR_F32S_FWD_CHUNK + 4);
}

// The bf16 instance of K1 (diffulab_tpu/ops/fused_mha.py:50) around the same
// valid rows at head dim 64, for the DiTs' padded short sequences (as the
// fp32 instance's note says): one column group holds the head, and the scores
// stay in each warp's registers; the products are mma.sync m16n8k16 on bf16
// tiles (bf16_valid.cuh) over key tiles of vr_bf16_tile = 64 keys, only the
// live ones loaded or multiplied. The rounding is K1's: p = exp(s - m) / l
// with m and l over the whole row, rounded to bf16 BEFORE p.v (an online
// softmax would round another p). So two passes over the live tiles: pass 1
// brings K alone and forms m and l; pass 2 brings V, forms p and o += p.v.
// One live tile (a 64-token row) keeps its scores in registers between the
// passes (VR_BF16_KEEP) and pass 2 loads no K; above that pass 2 brings K
// again and forms the scores anew, bit for bit the same. p is exponentiated
// by __expf and multiplied by 1 / l (bf16_exp). A batch row with no live
// tile writes o = 0, lse = +inf without loading Q. 46 KB of shared memory.
// The UNets' head dims 192-512 run the staged instance below.
template <int D>
__global__ void __launch_bounds__(vr_threads<D>())
mha_fwd_bf16_valid(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const int* __restrict__ mask, bf16* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int H,
                   long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                   float sm_scale) {
  constexpr int KT = vr_bf16_tile<D>(), KEEP = VR_BF16_KEEP, DO = vr_cols<D>(), ROWS = vr_rows<D>();
  constexpr int THREADS = vr_threads<D>(), LD = ldb<D>(), ROW_WARPS = ROWS / 16;
  constexpr int NS = VR_SLOTS;
  static_assert(vr_groups<D>() == 1, "one column group: each warp's scores over the whole of D");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);       // [ROWS][LD]
  bf16* ks = qs + ROWS * LD;                          // [NS][KT][LD]
  bf16* vs = ks + NS * KT * LD;                       // [NS][KT][LD]
  int* live = reinterpret_cast<int*>(vs + NS * KT * LD);  // [Skv / KT + 1]: live tiles

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * ROWS, r0 = 16 * (warp % ROW_WARPS);
  const int grp = warp / ROW_WARPS, col0 = grp * DO;  // this warp's output columns: col0 + [0, DO)
  const bool active = m0 + r0 < Sq;                   // the warp has a valid row
  const bf16* kb = k + b * k_sb + h * D;
  const bf16* vb = v + b * v_sb + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  const int n_tiles = Skv / KT;
  find_live_tiles<KT>(live, mb, n_tiles);
  __syncthreads();
  const int n_live = live[n_tiles], n_items = 2 * n_live;
  const bool kept = n_live <= KEEP;  // the same for every thread: the scores stay in registers

  // the load sequence, item i: pass 0 (i < n_live) the live tiles' K; pass 1 their V, and K again unless kept;
  // NS - 1 items loading while one is computed
  auto stage = [&](int item) {
    const int pass = item >= n_live, tile = live[item - pass * n_live], slot = item % NS;
    if (pass == 0 || !kept) stage_bf16_rows<D, KT, THREADS>(ks + slot * KT * LD, kb, k_ss, tile * KT, Skv);
    if (pass == 1) stage_bf16_rows<D, KT, THREADS>(vs + slot * KT * LD, vb, v_ss, tile * KT, Skv);
  };
  if (n_live > 0) stage_bf16_rows<D, ROWS, THREADS>(qs, q + b * q_sb + h * D, q_ss, m0, Sq);
  for (int item = 0; item < NS - 1; ++item) {  // a group each, empty or not, so that the waits below count right
    if (item < n_items) stage(item);
    cp_async_commit();
  }

  float acc[DO / 8][4], kept_s[KEEP][KT / 8][4];
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8; l summed over the quad after pass 0
  float inv_l[2] = {0.f, 0.f};

  for (int i = 0; i < n_items; ++i) {
    if (i + NS - 1 < n_items) stage(i + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();  // item i has landed
    __syncthreads();
    // j: the live tile's place in its pass
    const int pass = i >= n_live, j = i - pass * n_live, slot = i % NS, cur = live[j];
    float s[KT / 8][4];
    if (pass == 0 || !kept) {  // the whole row's scores of this tile
      if (active) rows_dot_bf16<DO, KT, LD>(s, qs + col0, r0, ks + slot * KT * LD + col0, g, t4);
      if (active) scale_and_mask_c<KT>(s, sm_scale, mb, cur * KT, t4);
    }
    if (active) {
      if (pass == 0) {  // the row max and sum; the scores kept where they fit
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < KT / 8; ++nt) {
          mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], quad_max(mx[r]));
          l[r] *= bf16_exp<D>(m[r] - m_new);  // 0 on the first live tile (m = -inf)
          m[r] = m_new;
        }
#pragma unroll
        for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) l[e >> 1] += bf16_exp<D>(s[nt][e] - m[e >> 1]);
#pragma unroll
        for (int jj = 0; jj < KEEP; ++jj)
          if (kept && jj == j)
#pragma unroll
            for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) kept_s[jj][nt][e] = s[nt][e];
      } else {  // p = exp(s - m) / l, rounded to bf16 in the product: o += p.v
        if (kept) {
#pragma unroll
          for (int jj = 0; jj < KEEP; ++jj)
            if (jj == j)
#pragma unroll
              for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[nt][e] = kept_s[jj][nt][e];
        }
#pragma unroll
        for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (D == 64)  // p times 1 / l, the reciprocal once a row (bf16_exp)
              s[nt][e] = bf16_exp<D>(s[nt][e] - m[e >> 1]) * inv_l[e >> 1];
            else
              s[nt][e] = expf(s[nt][e] - m[e >> 1]) / l[e >> 1];
          }
        scores_times_tile_bf16<DO, KT, LD>(acc, s, vs + slot * KT * LD + col0, lane);
      }
    }
    __syncthreads();  // the slot and the partial tiles are written again
    if (i == n_live - 1) {  // l over the whole row, before pass 1
      l[0] = quad_sum(l[0]);
      l[1] = quad_sum(l[1]);
      inv_l[0] = 1.f / l[0];
      inv_l[1] = 1.f / l[1];
    }
  }

  // a row without an attended key (m still -inf, or MASK_VALUE) gives o = 0, lse = +inf
  if (!active) return;
  bool dead[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) dead[r] = mb != nullptr && m[r] <= MASK_VALUE;
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = dead[e >> 1] ? 0.f : acc[dn][e];
  const long long o_ss = (long long)H * D;
  const int row = m0 + r0 + g;
  store_bf16_rows<DO>(o + (long long)b * Sq * o_ss + h * D + col0, o_ss, row, acc, t4, Sq);
  if (grp == 0 && t4 == 0) {
    if (row < Sq) lse[((long long)b * Sq + row) * H + h] = dead[0] ? INFINITY : m[0] + logf(l[0]);
    if (row + 8 < Sq) lse[((long long)b * Sq + row + 8) * H + h] = dead[1] ? INFINITY : m[1] + logf(l[1]);
  }
}

template <int D>
__host__ __device__ constexpr int vr_bf16_fwd_smem_bytes() {
  return 2 * ldb<D>() * (vr_rows<D>() + VR_SLOTS * 2 * vr_bf16_tile<D>());
}

// The bf16 instance of K1 at the UNets' head dims 192, 256, 384 and 512,
// staged (bf16_valid.cuh): a CTA takes a head's vr_bf16_rows unpadded query
// rows (64 at D = 192 and 256, so one CTA loads a head's K and V once; 16 at
// 384 and 512) and walks the live keys a slot of vr_bf16_slot keys at a time
// (64 or 16: the UNets' whole live row), each slot gathered from the mask
// row's live 16-key tiles. At B=128, H=2 a call must read q, k and v and write
// o over the valid rows and keys, 25.3 / 33.7 / 12.7 / 16.9 MB at D = 192 /
// 256 / 384 / 512 (0.0076 / 0.0101 / 0.0038 / 0.0050 ms at 3.35 TB/s),
// against 0.81 / 1.07 / 0.10 / 0.13 GFLOP: bound by bytes, and by the
// latency of its loads at one short wave of CTAs. So Q is requested while
// the mask row is read, K and V once it is: where the live row is one slot
// (the UNets'), the scores and p are formed while V lands, and the kernel
// waits twice. Each warp forms its 16 rows' scores over the whole of D (the
// column groups repeat them, a few hundred cycles of mma.sync) and the
// groups split only P.V's output columns, so no partial scores cross warps.
// K1's rounding stays the reference's: m and l over the
// whole row, then p = exp(s - m) * (1 / l) rounded to bf16 before P.V, the
// exponentials by __expf (ex2.approx, about 2 ulp), as at D = 64 (expf and a
// division by l took it from 0.0176 ms to 0.0196 at D = 192, B=128, H=2:
// scripts/d3_valid_variants.py, precise_exp; NVIDIA H100 80GB HBM3, 700 W).
// A one-slot row's p stays in registers, packed to bf16; a longer row
// (FUSED_MAX_SEQ allows 512 keys) runs pass 0 (m and l) over its slots' K,
// then pass 1 over K and V again, the scores formed anew bit for bit,
// through VR_BF16_BUFFERS slot buffers, the next one loading while one is
// computed. A batch row with no live tile writes o = 0, lse = +inf.
template <int D>
__global__ void __launch_bounds__(vr_bf16_threads<D>())
mha_fwd_bf16_staged(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const int* __restrict__ mask, bf16* __restrict__ o, float* __restrict__ lse, int Sq, int Skv,
                    int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                    long long v_ss, float sm_scale) {
  constexpr int KT = VR_BF16_TILE, SLOT = vr_bf16_slot<D>(), CT = SLOT / KT, DO = vr_bf16_cols<D>();
  constexpr int ROWS = vr_bf16_rows<D>(), THREADS = vr_bf16_threads<D>(), LD = ldb<D>(), ROW_WARPS = ROWS / 16;
  constexpr int NB = VR_BF16_BUFFERS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);          // [ROWS][LD]
  bf16* buf = qs + ROWS * LD;                            // [NB][SLOT][LD]: a slot's K or V
  int* live = reinterpret_cast<int*>(buf + NB * SLOT * LD);  // [Skv / KT + 1]: live tiles, count

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * ROWS, r0 = 16 * (warp % ROW_WARPS);
  const int grp = warp / ROW_WARPS, col0 = grp * DO;  // this warp's output columns: col0 + [0, DO)
  const bool active = m0 + r0 < Sq;                   // the warp has a valid row
  const bf16* kb = k + b * k_sb + h * D;
  const bf16* vb = v + b * v_sb + h * D;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * Skv;
  const int n_tiles = Skv / KT;
  stage_bf16_rows<D, ROWS, THREADS>(qs, q + b * q_sb + h * D, q_ss, m0, Sq);  // Q lands while the mask is read
  cp_async_commit();
  find_live_tiles<KT>(live, mb, n_tiles);
  __syncthreads();
  const int n_live = live[n_tiles], n_slots = (n_live + CT - 1) / CT;
  const bool kept = n_slots == 1;  // the same for every thread: p stays in registers
  // the load sequence: pass 0 the slots' K (items 0 .. n_slots - 1); pass 1 their V where kept, else each
  // slot's K, then its V; item i in buffer i % NB
  const int n_items = kept ? 2 : 3 * n_slots;
  int issued = 0;
  auto issue_upto = [&](int last) {  // every item up to `last` requested, one cp.async group each
    for (; issued <= last && issued < n_items; ++issued) {
      const int j = issued - n_slots, slot = issued < n_slots ? issued : kept ? 0 : j >> 1;
      const bool is_v = issued >= n_slots && (kept || (j & 1));
      const int n = min(CT, n_live - slot * CT);
      stage_bf16_tiles<D, KT, THREADS>(buf + (issued % NB) * SLOT * LD, is_v ? vb : kb, is_v ? v_ss : k_ss,
                                       live + slot * CT, n);
      cp_async_commit();
    }
  };
  // item `last` has landed and the items [first, last] are read here: request up to NB items from `first`
  auto await_items = [&](int first, int last) {
    issue_upto(first + NB - 1);
    cp_async_wait_upto<NB - 1>(issued - last - 1);
    __syncthreads();
  };

  float acc[DO / 8][4], s[SLOT / 8][4];
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8; l summed over the quad after pass 0

  for (int c = 0; c < n_slots; ++c) {  // pass 0: the row max and sum over the whole row
    await_items(c, c);
    const int n = min(CT, n_live - c * CT);
    if (active) {
      rows_dot_bf16_ldsm<D, SLOT, LD>(s, qs, r0, buf + (c % NB) * SLOT * LD, lane, n * KT);
      scale_and_mask_slot<SLOT, KT>(s, sm_scale, mb, live + c * CT, n, t4);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < SLOT / 8; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        l[r] *= __expf(m[r] - m_new);  // 0 on the first slot (m = -inf)
        m[r] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < SLOT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += __expf(s[nt][e] - m[e >> 1]);
    }
    __syncthreads();  // the buffer is written again
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
  // p = exp(s - m) * (1 / l), rounded to bf16: the A operand of o += p.v
  uint32_t pa[SLOT / 16][4];
  auto probs = [&]() {
#pragma unroll
    for (int nt = 0; nt < SLOT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = __expf(s[nt][e] - m[e >> 1]) * inv_l[e >> 1];
    pack_a_bf16<SLOT>(pa, s);
  };
  if (kept && active) probs();  // while V lands

  for (int c = 0; c < n_slots; ++c) {  // pass 1: o += p.v
    const int kb_item = kept ? 0 : n_slots + 2 * c, vb_item = kept ? 1 : kb_item + 1;
    await_items(kept ? vb_item : kb_item, vb_item);
    const int n = min(CT, n_live - c * CT);
    if (active) {
      if (!kept) {
        rows_dot_bf16_ldsm<D, SLOT, LD>(s, qs, r0, buf + (kb_item % NB) * SLOT * LD, lane, n * KT);
        scale_and_mask_slot<SLOT, KT>(s, sm_scale, mb, live + c * CT, n, t4);
        probs();
      }
      frags_times_tile_bf16<DO, SLOT, LD>(acc, pa, buf + (vb_item % NB) * SLOT * LD + col0, lane, n * KT);
    }
    __syncthreads();  // the buffers are written again
  }
  cp_async_wait<0>();  // Q's group, where no slot waited for it

  // a row without an attended key (m still -inf, or MASK_VALUE) gives o = 0, lse = +inf
  if (!active) return;
  bool dead[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) dead[r] = mb != nullptr && m[r] <= MASK_VALUE;
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = dead[e >> 1] ? 0.f : acc[dn][e];
  const long long o_ss = (long long)H * D;
  const int row = m0 + r0 + (lane >> 2);
  store_bf16_rows<DO>(o + (long long)b * Sq * o_ss + h * D + col0, o_ss, row, acc, t4, Sq);
  if (grp == 0 && t4 == 0) {
    if (row < Sq) lse[((long long)b * Sq + row) * H + h] = dead[0] ? INFINITY : m[0] + logf(l[0]);
    if (row + 8 < Sq) lse[((long long)b * Sq + row + 8) * H + h] = dead[1] ? INFINITY : m[1] + logf(l[1]);
  }
}

template <int D>
__host__ __device__ constexpr int vr_bf16_staged_fwd_smem_bytes() {
  return 2 * ldb<D>() * (vr_bf16_rows<D>() + VR_BF16_BUFFERS * vr_bf16_slot<D>());
}

// ---- host side

template <int D, int CHUNK>
cudaError_t launch_resident(const CUtensorMap (&maps)[4], const int* mask, float* lse, int B, int Sq,
                            int Skv, int H, float sm_scale, int buffers, int device, cudaStream_t stream) {
  auto kernel = mha_fwd_resident<D, CHUNK>;
  static bool configured[MAX_DEVICES] = {};
  static int slots[MAX_DEVICES][2] = {};  // (shared memory, resident CTAs an SM) last seen on each device
  cudaError_t err = allow_smem(kernel, configured, device);
  if (err != cudaSuccess) return err;
  const int smem = smem_bytes(D, true, Skv, buffers);
  if (slots[device][0] != smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 2 * THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    slots[device][0] = smem;
    slots[device][1] = sms * per_sm;
  }
  const int n_items = B * H * ((Sq / BLOCK_M + 1) / 2);
  const int grid = n_items < slots[device][1] ? n_items : slots[device][1];
  kernel<<<grid, 2 * THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], mask, lse, Sq, Skv, H, sm_scale,
                                             n_items, buffers);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_streamed(const CUtensorMap (&maps)[4], const int* mask, float* lse, int B, int Sq,
                            int Skv, int H, float sm_scale, int device, cudaStream_t stream) {
  auto kernel = mha_fwd_streamed<D>;
  static bool configured[MAX_DEVICES] = {};
  const cudaError_t err = allow_smem(kernel, configured, device);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Sq / BLOCK_M, H, B), THREADS, smem_bytes(D, false, Skv, 2), stream>>>(
      maps[0], maps[1], maps[2], maps[3], mask, lse, Sq, Skv, H, sm_scale);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(int D, int chunk, int resident, const CUtensorMap (&maps)[4], const int* mask,
                          float* lse, int B, int Sq, int Skv, int H, float sm_scale, int buffers, int device,
                          cudaStream_t stream) {
  if (!resident) {
    switch (D) {
      case 16: return launch_streamed<16>(maps, mask, lse, B, Sq, Skv, H, sm_scale, device, stream);
      case 32: return launch_streamed<32>(maps, mask, lse, B, Sq, Skv, H, sm_scale, device, stream);
      case 64: return launch_streamed<64>(maps, mask, lse, B, Sq, Skv, H, sm_scale, device, stream);
      case 128: return launch_streamed<128>(maps, mask, lse, B, Sq, Skv, H, sm_scale, device, stream);
      default: return cudaErrorInvalidValue;
    }
  }
#define K1_RESIDENT(DD, CC)                    \
  if (D == DD && chunk == CC)                  \
    return launch_resident<DD, CC>(maps, mask, lse, B, Sq, Skv, H, sm_scale, buffers, device, stream);
  K1_RESIDENT(16, 64) K1_RESIDENT(16, 128) K1_RESIDENT(16, 192) K1_RESIDENT(16, 256)
  K1_RESIDENT(32, 64) K1_RESIDENT(32, 128) K1_RESIDENT(32, 192) K1_RESIDENT(32, 256)
  K1_RESIDENT(64, 64) K1_RESIDENT(64, 128) K1_RESIDENT(64, 192) K1_RESIDENT(64, 256)
  K1_RESIDENT(128, 64) K1_RESIDENT(128, 128)
#undef K1_RESIDENT
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const int* mask, void* o, float* lse, int B,
                       int Sq, int Skv, int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                       long long v_sb, long long v_ss, float sm_scale, int device, cudaStream_t stream) {
  auto kernel = mha_fwd_tf32x3<D>;
  static bool configured[MAX_DEVICES] = {};
  const cudaError_t err = allow_smem(kernel, configured, device);
  if (err != cudaSuccess) return err;
  static_assert(f32_smem_bytes<D>() <= SMEM_LIMIT, "the fp32 K1's tiles exceed shared memory");
  kernel<<<dim3(Sq / F32_ROWS, H, B), F32_THREADS, f32_smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), mask,
      static_cast<float*>(o), lse, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32_valid(const void* q, const void* k, const void* v, const int* mask, void* o, float* lse,
                             int B, int Sq, int Skv, int H, long long q_sb, long long q_ss, long long k_sb,
                             long long k_ss, long long v_sb, long long v_ss, float sm_scale, int device,
                             cudaStream_t stream) {
  auto kernel = mha_fwd_tf32x3_valid<D>;
  static bool configured[MAX_DEVICES] = {};
  const cudaError_t err = allow_smem(kernel, configured, device);
  if (err != cudaSuccess) return err;
  static_assert(vr_fwd_smem_bytes<D>() <= SMEM_LIMIT, "the fp32 K1's tiles exceed shared memory");
  const int smem = vr_fwd_smem_bytes<D>() + vr_live_bytes(Skv, vr_tile<D>());
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  kernel<<<dim3((Sq + vr_rows<D>() - 1) / vr_rows<D>(), H, B), vr_threads<D>(), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), mask,
      static_cast<float*>(o), lse, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32_staged(const void* q, const void* k, const void* v, const int* mask, void* o, float* lse,
                              int B, int Sq, int Skv, int H, long long q_sb, long long q_ss, long long k_sb,
                              long long k_ss, long long v_sb, long long v_ss, float sm_scale, int device,
                              cudaStream_t stream) {
  auto kernel = mha_fwd_tf32x3_staged<D>;
  static bool configured[MAX_DEVICES] = {};
  const cudaError_t err = allow_smem(kernel, configured, device);
  if (err != cudaSuccess) return err;
  static_assert(vr_f32s_fwd_smem_bytes<D>() <= SMEM_LIMIT, "the fp32 K1's tiles exceed shared memory");
  const int smem = vr_f32s_fwd_smem_bytes<D>() + vr_live_bytes(Skv, VR_TILE);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  kernel<<<dim3((Sq + VR_F32S_FWD_ROWS - 1) / VR_F32S_FWD_ROWS, H, B), VR_F32S_FWD_THREADS, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), mask,
                     static_cast<float*>(o), lse, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16_staged(const void* q, const void* k, const void* v, const int* mask, void* o, float* lse,
                               int B, int Sq, int Skv, int H, long long q_sb, long long q_ss, long long k_sb,
                               long long k_ss, long long v_sb, long long v_ss, float sm_scale, int device,
                               cudaStream_t stream) {
  auto kernel = mha_fwd_bf16_staged<D>;
  static bool configured[MAX_DEVICES] = {};
  const cudaError_t err = allow_smem(kernel, configured, device);
  if (err != cudaSuccess) return err;
  static_assert(vr_bf16_staged_fwd_smem_bytes<D>() <= SMEM_LIMIT, "the bf16 K1's tiles exceed shared memory");
  const int smem = vr_bf16_staged_fwd_smem_bytes<D>() + vr_live_bytes(Skv, VR_BF16_TILE);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  kernel<<<dim3((Sq + vr_bf16_rows<D>() - 1) / vr_bf16_rows<D>(), H, B), vr_bf16_threads<D>(), smem,
           stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), mask,
                     static_cast<bf16*>(o), lse, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16_valid(const void* q, const void* k, const void* v, const int* mask, void* o, float* lse,
                              int B, int Sq, int Skv, int H, long long q_sb, long long q_ss, long long k_sb,
                              long long k_ss, long long v_sb, long long v_ss, float sm_scale, int device,
                              cudaStream_t stream) {
  auto kernel = mha_fwd_bf16_valid<D>;
  static bool configured[MAX_DEVICES] = {};
  const cudaError_t err = allow_smem(kernel, configured, device);
  if (err != cudaSuccess) return err;
  static_assert(vr_bf16_fwd_smem_bytes<D>() <= SMEM_LIMIT, "the bf16 K1's tiles exceed shared memory");
  const int smem = vr_bf16_fwd_smem_bytes<D>() + vr_live_bytes(Skv, vr_bf16_tile<D>());
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  kernel<<<dim3((Sq + vr_rows<D>() - 1) / vr_rows<D>(), H, B), vr_threads<D>(), smem,
           stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), mask,
                     static_cast<bf16*>(o), lse, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale);
  return cudaGetLastError();
}

cudaError_t run(const void* q, const void* k, const void* v, const int* mask, void* o, float* lse, int B, int Sq,
                int Skv, int H, int D, long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                long long v_ss, float sm_scale, int dtype, int valid_rows, int resident, int chunk, int buffers,
                int device, cudaStream_t stream) {
#define K1_VALID(DD, BF16, F32)                                                                             \
  if (D == DD && valid_rows)                                                                                \
    return (dtype == 1 ? BF16<DD> : F32<DD>)(q, k, v, mask, o, lse, B, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, \
                                             v_ss, sm_scale, device, stream);
  K1_VALID(64, launch_bf16_valid, launch_f32_valid) K1_VALID(192, launch_bf16_staged, launch_f32_valid)
  K1_VALID(256, launch_bf16_staged, launch_f32_staged) K1_VALID(384, launch_bf16_staged, launch_f32_valid)
  K1_VALID(512, launch_bf16_staged, launch_f32_valid)
#undef K1_VALID
  if (dtype == 1) {
    if (smem_bytes(D, resident != 0, Skv, buffers) > SMEM_LIMIT) return cudaErrorInvalidValue;
    CUtensorMap maps[4];  // q, k, v, o
    if (!encode_rows(&maps[0], q, B, Sq, H, D, q_sb, q_ss) || !encode_rows(&maps[1], k, B, Skv, H, D, k_sb, k_ss) ||
        !encode_rows(&maps[2], v, B, Skv, H, D, v_sb, v_ss) ||
        !encode_rows(&maps[3], o, B, Sq, H, D, (long long)Sq * H * D, (long long)H * D))
      return cudaErrorInvalidValue;
    return dispatch_bf16(D, chunk, resident, maps, mask, lse, B, Sq, Skv, H, sm_scale, buffers, device, stream);
  }
#define K1_F32(DD) \
  if (D == DD) return launch_f32<DD>(q, k, v, mask, o, lse, B, Sq, Skv, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale, device, stream);
  K1_F32(16) K1_F32(32) K1_F32(64) K1_F32(128)
#undef K1_F32
  return cudaErrorInvalidValue;
}

}  // namespace

// q/k/v: [B, S, H, D] with unit stride over D, stride D over heads and the given
// batch/row strides (in elements, multiples of 16 bytes); Skv a multiple of
// 64; D in {16, 32, 64, 128, 192, 256, 384, 512}; dtype 0 = fp32, 1 = bf16;
// mask: int32 [B, Skv] (nonzero = attend) or null. valid_rows 1: the
// instance built around the valid rows (any Sq, the unpadded query rows; the
// only one at D = 192-512, beside the padded ones at D = 64: the caller
// picks it by shape, ops/fused_mha.py::takes_valid_rows), 0: a padded
// instance (Sq a multiple of 64). o: contiguous [B, Sq, H, D] in the input
// dtype; lse: contiguous fp32 [B, Sq, H]. bf16 padded instance: resident (a
// head's K and V in shared memory; `buffers` 1 or 2, 2 prefetching the next
// item) with `chunk` keys a score product (Skv a multiple of it), or streamed
// (chunk 64, buffers 2: the ring); with valid_rows the three are not read.
// Launches on `stream` of `device`, which is made current for the call.
extern "C" int fused_mha_fwd(const void* q, const void* k, const void* v, const void* mask, void* o, void* lse,
                             int B, int Sq, int Skv, int H, int D, long long q_sb, long long q_ss, long long k_sb,
                             long long k_ss, long long v_sb, long long v_ss, float sm_scale, int dtype, int valid_rows,
                             int resident, int chunk, int buffers, int device, void* stream) {
  // the valid-rows instances take the unpadded query rows, and the bf16 one no instance choice
  const bool any_rows = valid_rows != 0;
  if (Sq < 1 || (!any_rows && Sq % BLOCK_M != 0) || Skv < 1 || Skv % TMA_ROWS != 0 || (dtype != 0 && dtype != 1) ||
      (valid_rows != 0 && valid_rows != 1) || (any_rows && !has_valid_rows_instance(D)) ||
      (!any_rows && valid_rows_instance(D)) || device < 0 || device >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && !any_rows && (buffers < 1 || buffers > 2 || chunk < 64 || Skv % chunk != 0 ||
                     (!resident && (chunk != STREAM_CHUNK || buffers != 2))))
    return static_cast<int>(cudaErrorInvalidValue);
  int previous = device;
  cudaError_t err = cudaGetDevice(&previous);
  if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = run(q, k, v, static_cast<const int*>(mask), o, static_cast<float*>(lse), B, Sq, Skv, H, D, q_sb, q_ss, k_sb,
            k_ss, v_sb, v_ss, sm_scale, dtype, valid_rows, resident, chunk, buffers, device,
            static_cast<cudaStream_t>(stream));
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

// keys of the fp32 K1's ring slot (what = 0) and its column groups of warps
// that split the score reduction (what = 1) at head dim D, by the rules its
// launch follows: at 256 the staged instance's slot, and 1 (each warp forms
// its scores over the whole of D); 0 for another D. The emulation in
// ops/fused_mha.py (f32_keys, f32_groups) mirrors them. what = 2: 1 where the
// fp32 K1 and K2 take the unpadded query rows (valid_rows_instance;
// VALID_ROWS_HEAD_DIMS in ops/fused_mha.py), else 0.
extern "C" int fused_mha_fwd_f32_tiles(int D, int what) {
  if (what == 2) return valid_rows_instance(D) ? 1 : 0;
  if (D == 16 || D == 32 || D == 64 || D == 128) return what == 0 ? F32_KEYS : 1;
  if (D == 256) return what == 0 ? vr_f32s_slot<256>() : 1;
#define K1_TILES_VALID(DD) \
  if (D == DD) return what == 0 ? VR_TILE : vr_groups<DD>();
  K1_TILES_VALID(192) K1_TILES_VALID(384) K1_TILES_VALID(512)
#undef K1_TILES_VALID
  return 0;
}

// the staged bf16 K1 at the valid-rows head dims, by the rules its launch
// follows: keys of a staged slot (what = 0), column groups of warps (what =
// 1), keys of the mask's liveness tiles that a slot gathers (what = 2); 0
// for another D. ops/fused_mha.py (bf16_keys, bf16_groups, BF16_LIVE_KEYS)
// mirrors them.
extern "C" int fused_mha_fwd_bf16_tiles(int D, int what) {
#define K1_TILES_BF16(DD) \
  if (D == DD) return what == 0 ? vr_bf16_slot<DD>() : what == 1 ? vr_bf16_groups<DD>() : VR_BF16_TILE;
  K1_TILES_BF16(192) K1_TILES_BF16(256) K1_TILES_BF16(384) K1_TILES_BF16(512)
#undef K1_TILES_BF16
  return 0;
}

// the instance of K1 built around the valid rows at head dim D in dtype (0
// fp32, 1 bf16), by the rules its launch follows: keys of a ring (or staged)
// slot (what = 0), column groups of warps (what = 1), slots whose scores stay
// in registers between the passes (what = 2; the bf16 instance at D = 64
// alone, else 0), query rows a CTA (what = 3), and, of the staged fp32
// instance at 256, the columns of a stage (what = 4; 0 elsewhere); 0 where D
// has no such instance. ops/fused_mha.py (f32_keys and bf16_keys with
// valid_rows, f32_groups, bf16_groups, BF16_KEPT_TILES, bf16_rows,
// f32_staged) mirrors them.
extern "C" int fused_mha_fwd_valid_tiles(int D, int dtype, int what) {
  if (D == 256 && dtype == 0)
    return what == 0 ? vr_f32s_slot<256>() : what == 1 ? 1 : what == 3 ? VR_F32S_FWD_ROWS
         : what == 4 ? VR_F32S_FWD_CHUNK : 0;
  if (what >= 4) return 0;
  if (D == 64)
    return what == 0 ? (dtype == 1 ? vr_bf16_tile<64>() : vr_tile<64>()) : what == 1 ? vr_groups<64>()
         : what == 2 ? (dtype == 1 ? VR_BF16_KEEP : 0) : vr_rows<64>();
#define K1_TILES_ANY(DD)                                                                                   \
  if (D == DD)                                                                                             \
    return dtype == 1 ? (what == 0 ? vr_bf16_slot<DD>() : what == 1 ? vr_bf16_groups<DD>() : what == 2 ? 0 \
                         : vr_bf16_rows<DD>())                                                             \
                      : (what == 0 ? vr_tile<DD>() : what == 1 ? vr_groups<DD>() : what == 2 ? 0 : vr_rows<DD>());
  K1_TILES_ANY(192) K1_TILES_ANY(256) K1_TILES_ANY(384) K1_TILES_ANY(512)
#undef K1_TILES_ANY
  return 0;
}

extern "C" const char* dl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
