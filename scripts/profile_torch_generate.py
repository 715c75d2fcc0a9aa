#!/usr/bin/env python3
"""Where the time of one ``generate`` request goes in the PyTorch/CUDA port.

Builds the model as chip_smoke.py does, with seeded random weights: by
default bench.py's DiT-B/2 (bf16 whole-model cast, batch 16, Euler-50, CFG
4.0); with ``--txt2img`` the txt2img MMDiT with its Flux2 tower (4 prompts,
64x64x128 latents, 4224 tokens, Euler-50, CFG 4.0, decode to 1024x1024);
with ``--c1`` slice C1's sample request: the DiT of
configs/train_synthetic_flow_matching.yaml built through the port's config
layer (width 512, depth 10, fp32), 16 images of 32x32x3 for labels 0-9
tiled, Euler-50, CFG 1.5 (the request chip_smoke.py phase 14 makes through
the sample CLI).
Times requests without the profiler (for txt2img also the denoising loop and
the decode apart), then records one request under ``torch.profiler`` and
prints, from the device's kernel records: the kernel launches per request,
the device busy time (union of kernel intervals) against the request's wall
time, and the device time by kernel group and by kernel name.

Run on the card from the repository root:
``python3 scripts/profile_torch_generate.py [--txt2img | --c1]``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _group(name: str) -> str:
    low = name.lower()
    if "flash_bwd_dkv" in low:
        return "attention (flash_attn_bwd_dkv)"
    if "flash_bwd_dq" in low:
        return "attention (flash_attn_bwd_dq)"
    if "flash_bwd_prep" in low:
        return "attention (flash_attn_bwd_dkv di pre-pass)"
    if "flash_fwd" in low:
        return "attention (flash_attn_fwd)"
    if "mha_fwd" in low:
        return "attention (fused_mha_fwd)"
    if "mha_bwd" in low:
        return "attention (fused_mha_bwd)"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "optimizer (foreach)"
    if any(tag in low for tag in ("fprop", "dgrad", "conv", "winograd")):
        return "convolution (cuDNN)"
    if any(tag in low for tag in ("gemm", "xmma", "nvjet", "cutlass", "matmul")):
        return "matmul (cuBLAS)"
    if "layer_norm" in low or "layernorm" in low:
        return "layer_norm"
    if "reduce" in low:
        return "reductions"
    if "catarray" in low:
        return "cat"
    if "elementwise" in low or "vectorized" in low or "unrolled" in low:
        return "elementwise"
    return "other"


def _timed(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def txt2img() -> None:
    """The txt2img request: the loop and the decode timed apart, then traced whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from diffulab_tpu_torch.diffuse import Diffuser

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, _, tower, cond = chip_smoke.build_txt2img()
    diffuser = Diffuser(model, "euler", n_steps=chip_smoke.STEPS, vision_tower=tower,
                        extra_args=chip_smoke.TXT_EXTRA)

    def request(seed: int) -> float:
        return _timed(lambda: chip_smoke.txt2img_request(diffuser, cond, seed))

    request(0)  # warm-up: cuBLAS/cuDNN heuristics, allocator
    plain_ms = [request(1 + i) for i in range(3)]
    loop_ms, decode_ms = [], []
    with torch.no_grad():
        for i in range(2):
            latents = chip_smoke.txt2img_request(diffuser, cond, 20 + i, return_latents=True)
            loop_ms.append(_timed(lambda: chip_smoke.txt2img_request(diffuser, cond, 20 + i, return_latents=True)))
            decode_ms.append(_timed(lambda: tower.decode(latents / diffuser.latent_scale + diffuser.latent_bias)))
    print(f"denoising loop ms (50 steps, latents only): {[round(m, 2) for m in loop_ms]}; "
          f"Flux2 decode ms: {[round(m, 2) for m in decode_ms]}; peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = request(10)
    summarize(prof, plain_ms, traced_ms, "request")


def _c1_request():
    """Slice C1's sample request, built from its config: (request fn, label)."""
    import torch

    import chip_smoke
    from diffulab_tpu_torch.config import compose_config, instantiate
    from diffulab_tpu_torch.diffuse import Diffuser

    cfg = compose_config(ROOT / "configs", chip_smoke.C1_CONFIG)
    torch.manual_seed(0)
    model = instantiate(cfg["model"], device="cuda").eval()
    diffuser = Diffuser(model, cfg["diffuser"]["sampling_method"], n_steps=cfg["diffuser"]["n_steps"],
                        extra_args=cfg["diffuser"].get("extra_args", {}))
    n = chip_smoke.C1_SAMPLES
    y = torch.arange(n, device="cuda") % 10

    def run(gen):
        diffuser.generate({"y": y}, data_shape=(n, 32, 32, 3), generator=gen, clamp_x=True,
                          guidance_scale=chip_smoke.C1_GUIDANCE)

    return run, f"C1 DiT fp32, {n} images, CFG {chip_smoke.C1_GUIDANCE}"


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = parser.add_mutually_exclusive_group()
    which.add_argument("--txt2img", action="store_true", help="profile the txt2img MMDiT request")
    which.add_argument("--c1", action="store_true", help="profile slice C1's sample request, from its config")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_generate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.txt2img:
        txt2img()
        return 0
    import chip_smoke
    from diffulab_tpu_torch.diffuse import Diffuser

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.c1:
        run, label = _c1_request()
    else:
        model, _ = chip_smoke.build_models()
        diffuser = Diffuser(model, "euler", n_steps=chip_smoke.STEPS)
        shape = (chip_smoke.SAMPLE_BATCH, *chip_smoke.LATENT)
        y = torch.arange(chip_smoke.SAMPLE_BATCH, device="cuda") * 7 % 1000
        label = "DiT-B/2 bf16, batch 16, CFG 4.0"

        def run(gen):
            diffuser.generate({"y": y}, data_shape=shape, generator=gen,
                              guidance_scale=chip_smoke.CFG, dtype=torch.bfloat16)

    def request(seed: int) -> float:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    request(0)  # warm-up: cuBLAS heuristics, allocator
    plain_ms = [request(1 + i) for i in range(5)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = request(10)
    print(f"request: {label}, Euler-{chip_smoke.STEPS}")
    summarize(prof, plain_ms, traced_ms, "request")
    return 0


def summarize(prof, plain_ms: list[float], traced_ms: float, unit: str) -> None:
    """Print the device's kernel records of one traced ``unit`` (a request, a
    step): launches, busy time against the kernel window, device time by
    group and the top kernels by name."""
    import torch
    from torch.autograd import DeviceType

    # device records, without the user annotations (e.g. "Optimizer.step#AdamW.step")
    # that span the kernels they enclose
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    window_us = spans[-1][1] - spans[0][0] if spans else 0.0
    by_group: dict[str, float] = defaultdict(float)
    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        dur = e.time_range.elapsed_us()
        by_group[_group(e.name)] += dur
        by_name[e.name][0] += dur
        by_name[e.name][1] += 1
    total = sum(by_group.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"{unit} wall ms without profiler: {[round(m, 2) for m in plain_ms]} "
          f"(median {statistics.median(plain_ms):.2f}); traced {unit} wall ms {traced_ms:.2f}")
    print(f"kernel launches per {unit}: {len(kernels)}; device busy {busy_us / 1e3:.2f} ms of a "
          f"{window_us / 1e3:.2f} ms kernel window (idle share {1 - busy_us / window_us:.3f})")
    print("device time by group: " + json.dumps(
        {g: {"ms": round(t / 1e3, 2), "share": round(t / total, 3)}
         for g, t in sorted(by_group.items(), key=lambda kv: -kv[1])}))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (t, n) in top:
        print(f"  {t / 1e3:9.2f} ms  {n:6d} launches  {t / n:8.2f} us each  {name[:110]}")


if __name__ == "__main__":
    sys.exit(main())
