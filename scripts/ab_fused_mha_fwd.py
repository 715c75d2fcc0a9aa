#!/usr/bin/env python3
"""K1 (the fused-MHA forward) of two checkouts of the port, timed on one card.

``--root DIR`` times the ``diffulab_tpu_torch`` package under DIR and prints
one JSON line: K1's device time per call from CUDA-graph replays at the
DiT-B/2 shapes (B=32 sampling and B=64 training, S=256, H=12, D=64, bf16,
q/k/v as views of one packed qkv tensor) and at 384 and 512 tokens (B=32),
its wall time per call back to back, and the wrapper's host time per call
at a one-head shape whose kernel takes a few microseconds.

``--ab PARENT`` runs ``--root PARENT``, ``--root`` this checkout, this
checkout again, and PARENT again, each in its own process (the two packages
share a name), and prints the four lines and their medians side by side.
Unpack the parent commit into a directory that git ignores, e.g.
``git archive HEAD~1 | tar -x -C _parent``, then run from the repository
root on the card: ``python3 scripts/ab_fused_mha_fwd.py --ab _parent``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time per call: ``calls`` calls in one CUDA graph, replayed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def wall_ms(fn, iters: int = 200) -> float:
    """Wall time per call, back to back, between two events."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 2000) -> float:
    """Host time per call of a call whose kernel is shorter than its launch."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from diffulab_tpu_torch.ops.fused_mha import fused_mha

    assert Path(sys.modules["diffulab_tpu_torch"].__file__).resolve().is_relative_to(root.resolve())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def packed(b, s, h=12, d=64):
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").bfloat16()
        return tuple(t.reshape(b, s, h, d) for t in qkv.chunk(3, dim=-1))

    out = {"root": str(root)}
    with torch.no_grad():
        for b, s in ((32, 256), (64, 256), (32, 384), (32, 512)):
            q, k, v = packed(b, s)
            out[f"device_ms_B{b}_S{s}"] = graph_ms(lambda: fused_mha(q, k, v))
            if s == 256:
                out[f"wall_ms_B{b}_S{s}"] = wall_ms(lambda: fused_mha(q, k, v))
        q, k, v = packed(1, 64, h=1)
        out["host_us_per_call"] = host_us(lambda: fused_mha(q, k, v))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--root", type=Path, help="time the package under this directory")
    group.add_argument("--ab", type=Path, metavar="PARENT", help="parent, change, change, parent")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_fused_mha_fwd: no CUDA device", file=sys.stderr)
        return 2
    if args.root is not None:
        print(json.dumps(measure(args.root)))
        return 0
    runs = []
    for root in (args.ab, ROOT, ROOT, args.ab):
        done = subprocess.run([sys.executable, __file__, "--root", str(root)], capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout, done.stderr, file=sys.stderr)
            return done.returncode
        runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    for key in runs[0]:
        if key == "root":
            continue
        parent = statistics.median([runs[0][key], runs[3][key]])
        change = statistics.median([runs[1][key], runs[2][key]])
        print(f"{key}: parent {runs[0][key]:.4f} / {runs[3][key]:.4f}, change {runs[1][key]:.4f} / "
              f"{runs[2][key]:.4f} (medians {parent:.4f} -> {change:.4f}, x{parent / change:.2f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
