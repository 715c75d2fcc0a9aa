#!/usr/bin/env python3
"""The rate of ``mma.sync.aligned.m16n8k8`` TF32 products on one card: the
instruction the fp32 K1 and K2 run (``csrc/tf32x3.cuh``).

Builds a kernel whose warps issue only these products, on accumulators in
registers (``CHAINS`` independent ones a warp, so that a product's latency
hides behind the others), and prints the TFLOP/s it reaches with 4, 8, 12 and
16 warps an SM (one CTA of 4 warps each), beside the card's data-sheet TF32
peak (495 TFLOP/s dense, H100 SXM at 700 W), with the card's name and power
limit.

Run from the repository root on the card: ``python3 scripts/mma_tf32_rate.py``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ITERS, CHAINS = 4096, 8
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(128) mma_rate(float* out, int iters) {
  float c[CHAINS][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 4 + i;
  b[0] = threadIdx.x; b[1] = threadIdx.x + 1;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int launch(float* out, int blocks, int iters, void* stream) {
  mma_rate<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_tf32_rate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from diffulab_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, so = out_dir / "mma_tf32_rate.cu", out_dir / "mma_tf32_rate.so"
    src.write_text(SOURCE.replace("CHAINS", str(CHAINS)))
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)], capture_output=True,
                          text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.launch.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 4 * 128, device="cuda")
    for ctas_per_sm in (1, 2, 3, 4):
        blocks = sms * ctas_per_sm

        def run():
            assert lib.launch(out.data_ptr(), blocks, ITERS, torch.cuda.current_stream().cuda_stream) == 0

        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 10
        flops = blocks * 4 * ITERS * CHAINS * 2 * 16 * 8 * 8
        print(f"{4 * ctas_per_sm} warps an SM, {CHAINS} accumulators a warp: {ms:.4f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s of TF32 mma.sync (data-sheet dense TF32 peak 495)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
