// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA loads and stores through 3-D tensor maps {H*D columns, S rows, B} over
// [B, S, H, D] rows at the caller's strides, wgmma (shared-memory descriptors,
// SS and RS products with fp32 accumulators, issued on whole tiles), named
// barriers for two warpgroups taking turns, and the driver's
// cuTensorMapEncodeTiled reached through the runtime (no link against
// libcuda). Included by fused_mha_fwd.cu (K1) and flash_attn_fwd.cu (K3), and
// through attn_bwd_hopper.cuh by flash_attn_bwd.cu (K4, K5) and
// fused_mha_bwd.cu (K2); each source is its own shared library, so everything
// here has internal linkage.
//
// Layout contract between TMA and wgmma: a row of one head is D bf16 values
// in 64-column halves (D = 128 takes two boxes a row); a box of rows lands
// with the 128-, 64- or 32-byte swizzle of a 64-, 32- or 16-wide row, which
// is the layout the descriptors below read. A K-major operand advances 32
// bytes a k16 step within a half; an MN-major B 16 rows a step, its halves
// `lbo` bytes apart.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
// -0.7 * FLT_MAX, formed in double and rounded once, as the reference forms it
constexpr float MASK_VALUE = static_cast<float>(-0.7 * 3.4028234663852886e+38);
constexpr float LOG2E = 1.4426950408889634f;

constexpr int TMA_ROWS = 64;         // rows of one TMA box
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory one block may use on an H100
constexpr int MAX_DEVICES = 64;

template <int D>
struct Geometry {
  static constexpr int ROWB = (D < 64 ? D : 64) * 2;        // bytes of a row of one 64-column half
  static constexpr int HALVES = D > 64 ? D / 64 : 1;        // TMA boxes (64-column halves) a row takes
  static constexpr int KSTEPS_PER_HALF = ROWB / 32;         // k16 steps of wgmma within one half
  static constexpr uint64_t SWIZZLE = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;  // descriptor layout type
  static constexpr int TILE_BYTES = TMA_ROWS * D * 2;       // 64 rows of one head
};

// ---- shared memory, mbarriers, TMA

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed; a
// copy that never lands (a malformed tensor map) traps after ~10 s of clock
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  } while (!done);
}

// one TMA box {c0 (column), c1 (row), c2 (batch)} of `map` into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned) into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// a tile from shared memory (the same box and swizzle) to device memory
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ void tma_store_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// the stores' reads of shared memory are done (the source may be overwritten)
__device__ __forceinline__ void tma_store_read_done() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void tma_store_done() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// generic-proxy writes to shared memory made visible to the TMA unit
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// ---- wgmma

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// wait until at most N of the warpgroup's committed groups are in flight (groups complete in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// keeps the compiler from moving reads or writes of wgmma registers across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle layout (1 = 128 B, 2 = 64 B, 3 = 32 B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

template <int N>
struct Wgmma;
template <int N>
struct WgmmaRs;

template <>
struct Wgmma<32> {
  // d[16] (+)= A (shared, K-major) x B (shared, K-major), m64n32k16
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  // d[32] (+)= A (shared, K-major) x B (shared, K-major), m64n64k16
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  // d[64] (+)= A (shared, K-major) x B (shared, K-major), m64n128k16
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<192> {
  // d[96] (+)= A (shared, K-major) x B (shared, K-major), m64n192k16
  __device__ __forceinline__ static void ss(float (&d)[96], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<256> {
  // d[128] (+)= A (shared, K-major) x B (shared, K-major), m64n256k16
  __device__ __forceinline__ static void ss(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct WgmmaRs<16> {
  // d[8] (+)= A (registers) x B (shared; MN-major, or K-major with TRANS_B = 0), m64n16k16
  template <int TRANS_B = 1>
  __device__ __forceinline__ static void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TRANS_B));
  }
};

template <>
struct WgmmaRs<32> {
  // d[16] (+)= A (registers) x B (shared; MN-major, or K-major with TRANS_B = 0), m64n32k16
  template <int TRANS_B = 1>
  __device__ __forceinline__ static void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TRANS_B));
  }
};

template <>
struct WgmmaRs<64> {
  // d[32] (+)= A (registers) x B (shared; MN-major, or K-major with TRANS_B = 0), m64n64k16
  template <int TRANS_B = 1>
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TRANS_B));
  }
};

template <>
struct WgmmaRs<128> {
  // d[64] (+)= A (registers) x B (shared; MN-major, or K-major with TRANS_B = 0), m64n128k16
  template <int TRANS_B = 1>
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TRANS_B));
  }
};

// ---- elementwise

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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

// a row's max and sum over this thread's scores of a 64-row accumulator tile
// (s[4j + 2r + e] is row 16 * warp + g + 8r, key 8j + 2 t4 + e), in four
// independent partials (short dependency chains), then over the quad that
// holds the row
template <int CHUNK>
__device__ __forceinline__ float row_max(const float (&s)[CHUNK / 2], int r) {
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < CHUNK / 8; ++j) mx[j % 4] = fmaxf(mx[j % 4], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
  return quad_max(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3])));
}

template <int CHUNK>
__device__ __forceinline__ float row_sum(const float (&s)[CHUNK / 2], int r) {
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < CHUNK / 8; ++j) sum[j % 4] += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
  return quad_sum((sum[0] + sum[1]) + (sum[2] + sum[3]));
}

// wait for the warpgroup's products in flight; their accumulators are then readable
template <int N>
__device__ __forceinline__ void wgmma_done(float (&d)[N]) {
  wgmma_wait0();
  fence_regs(d);
}

// rows [row0, row0 + rows) of head h of batch b into dst, BOX rows a box (the
// map's box); the 64-column halves of a row (D = 128) `half` bytes apart
template <int D, int BOX = TMA_ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, int b, int h, int row0, int rows,
                                          uint32_t half, uint32_t bar) {
  using G = Geometry<D>;
  for (int r = 0; r < rows; r += BOX)
    for (int hh = 0; hh < G::HALVES; ++hh)
      tma_load_3d(dst + hh * half + r * G::ROWB, map, h * D + hh * 64, row0 + r, b, bar);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// threads of a warpgroup. Named barriers: 0 is __syncthreads; SCHED_BAR + w is
// warpgroup w's turn at the tensor cores, DONE_BAR + w gathers warpgroup w's threads
constexpr int WG = 128;
constexpr int SCHED_BAR = 1, DONE_BAR = 3;

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- whole-tile wgmma products (a warpgroup's 64 rows)

// acc = A . B^T over D, both K-major in shared memory: A 64 rows at a_addr, B N
// rows at b_addr, their 64-column halves a_half and b_half bytes apart; issued
// and committed, not awaited
template <int D, int N>
__device__ __forceinline__ void ss_issue(float (&acc)[N / 2], uint32_t a_addr, uint32_t a_half, uint32_t b_addr,
                                         uint32_t b_half) {
  using G = Geometry<D>;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t half = kk / G::KSTEPS_PER_HALF, within = (kk % G::KSTEPS_PER_HALF) * 32;
    Wgmma<N>::ss(acc, smem_desc(a_addr + half * a_half + within, 16, 8 * G::ROWB, G::SWIZZLE),
                 smem_desc(b_addr + half * b_half + within, 16, 8 * G::ROWB, G::SWIZZLE), kk > 0);
  }
  wgmma_commit();
}

// x (64 rows x N columns in the accumulator layout: x[4c + 2r + e] is row
// 16 * warp + g + 8r, column 8c + 2 * t4 + e) rounded to bf16 into the
// register A operand of N / 16 k16 steps
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// acc += A . B over 16 * KSTEPS rows of B: A in registers (pack_a), B MN-major
// in shared memory (rows of D bf16 from b_addr, 64-column halves b_half bytes
// apart); issued and committed, not awaited
template <int D, int KSTEPS>
__device__ __forceinline__ void rs_issue(float (&acc)[D / 2], const uint32_t (&a)[KSTEPS][4], uint32_t b_addr,
                                         uint32_t b_half) {
  using G = Geometry<D>;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    WgmmaRs<D>::rs(acc, a[kk], smem_desc(b_addr + kk * 16 * G::ROWB, b_half, 8 * G::ROWB, G::SWIZZLE), 1);
  wgmma_commit();
}

// acc = A . B^T over D: A (64 rows x D) in registers (load_a), B N rows
// K-major in shared memory at b_addr, its 64-column halves b_half bytes apart;
// issued and committed, not awaited
template <int D, int N>
__device__ __forceinline__ void rs_issue_t(float (&acc)[N / 2], const uint32_t (&a)[D / 16][4], uint32_t b_addr,
                                           uint32_t b_half) {
  using G = Geometry<D>;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t half = kk / G::KSTEPS_PER_HALF, within = (kk % G::KSTEPS_PER_HALF) * 32;
    WgmmaRs<N>::template rs<0>(acc, a[kk], smem_desc(b_addr + half * b_half + within, 16, 8 * G::ROWB, G::SWIZZLE),
                               kk > 0);
  }
  wgmma_commit();
}

// one thread: the staged tile at src to rows [row0, row0 + 64) of head h of batch b of the map's tensor
template <int D>
__device__ __forceinline__ void store_tile(const CUtensorMap* to, uint32_t src, int b, int h, int row0) {
  using G = Geometry<D>;
  for (int hh = 0; hh < G::HALVES; ++hh) tma_store_3d(to, src + hh * TMA_ROWS * G::ROWB, h * D + hh * 64, row0, b);
  tma_store_commit();
}

// ---- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found once through the runtime (no link against libcuda)
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a 3-D map {H*D columns, S rows, B} over rows of bf16 heads (q, k, v, o or a
// gradient; row and batch strides in elements), read or written in
// {min(D, 64), box_rows, 1} boxes with the swizzle wgmma reads; rows past S
// load as zeros and are not stored
bool encode_rows(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, long long sb, long long ss,
                 int box_rows = TMA_ROWS) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H) * D, static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const long long batch_stride = B == 1 ? S * ss : sb;  // a single batch's stride is never used
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(batch_stride) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(D < 64 ? D : 64), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = D == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
                                     : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_128B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a kernel's dynamic shared memory opted in to SMEM_LIMIT once per device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&configured)[MAX_DEVICES], int device) {
  if (configured[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  configured[device] = err == cudaSuccess;
  return err;
}

}  // namespace
