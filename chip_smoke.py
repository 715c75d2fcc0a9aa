#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``diffulab_tpu_torch``) on one card.

Drives the port's main path — DiT-B/2 class-conditional sampling, Euler-50
with CFG 4.0 as one fused 2x batch, bf16 whole-model cast, batch 16 on
32x32x4 latents — through ``Diffuser.generate``, with seeded random weights.

Phases, one line each:
  1. build every CUDA kernel from the sources in the checkout (one nvcc per
     source, all started at once);
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shape and at the edge cases, with the tolerance stated; timings of
     the kernel, the plain version and one library call (yardstick only);
  3. the DiT-B/2 forward, kernel path against the same model with the plain
     attention (``attention_impl="xla"``);
  4. three ``generate`` requests, with the kernels' launch counts set to 0
     just before and read just after: 600 fused-MHA launches per request.
Then the card's name and power limit, a JSON line of per-kernel numbers, and
as the last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without a CUDA card, or without the package beside it, it
exits non-zero and prints no result.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# DiT-B/2 as bench.py builds it, at the bench's precision policy
DIT_B2 = dict(simple_dit=True, input_channels=4, inner_dim=768, embedding_dim=768, num_heads=12,
              mlp_ratio=4, patch_size=2, depth=12, n_classes=1000, classifier_free=True,
              stable_conditioning=False)
LATENT = (32, 32, 4)
SAMPLE_BATCH = 16
STEPS = 50
CFG = 4.0
N_REQUESTS = 3

# H100 SXM data-sheet peaks at 700 W (hopper-kernels guide, section 1)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# kernel vs plain: |kernel - plain| <= atol + rtol * |plain|. fp32: the same
# arithmetic in another summation order. bf16: p is rounded to bf16 before
# PV in both, but exp/sum rounding can flip a rounding of p or of o by one
# bf16 step (2^-8 relative).
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 1e-2)}
LSE_TOL = (1e-4, 1e-5)
# DiT-B/2 forward, max|kernel path - plain path| / max|plain path|: 12 bf16
# blocks carry the attention difference forward through bf16 rounding
DIT_REL_TOL = 5e-2
# a whole 50-step request, kernel path against plain-attention path from the
# same noise: the per-step difference compounds along the trajectory
# (3.3e-2 measured on an H100 80GB HBM3 at 700 W)
GEN_REL_TOL = 1e-1


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name, ours, ref, atol, rtol) -> float:
    import torch

    err = (ours.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    finite = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(ours), finite):
        fail(f"{name}: non-finite values differ")
    bad &= finite
    max_err = float(err[finite].max()) if finite.any() else 0.0
    if bool(bad.any()):
        fail(f"{name}: max_abs_err {max_err:.3e} beyond atol {atol} + rtol {rtol}")
    return max_err


def phase_build():
    from diffulab_tpu_torch.ops import _build

    seconds, logs = _build.build_all()
    usage = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    print(f"phase 1 build: {len(logs)} kernel libraries in {seconds:.1f} s; ptxas: {json.dumps(usage)}")


def phase_kernel():
    """Each kernel case against the plain version on the same CUDA inputs."""
    import torch
    import torch.nn.functional as F

    from diffulab_tpu_torch.ops import dot_product_attention
    from diffulab_tpu_torch.ops.fused_mha import fused_mha, fused_mha_reference

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)

    results = {}
    with torch.no_grad():
        # main path's shape, q/k/v as views of one packed qkv projection output
        b, s, h, d = 2 * SAMPLE_BATCH, 256, 12, 64
        qkv = rand(b, s, 3 * h * d, dtype=torch.bfloat16)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.chunk(3, dim=-1))
        o, lse = fused_mha(q, k, v)
        ro, rlse = fused_mha_reference(q, k, v)
        err = check_close("main bf16 o", o, ro, *TOL["bfloat16"])
        check_close("main bf16 lse", lse, rlse, *LSE_TOL)
        kernel_ms = cuda_time_ms(lambda: fused_mha(q, k, v), iters=200)
        plain_ms = cuda_time_ms(lambda: fused_mha_reference(q, k, v), iters=20)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=200)
        elem = q.element_size()
        bytes_moved = 4 * b * s * h * d * elem + b * s * h * 4  # q, k, v, o once each + lse
        flops = 4 * b * h * s * s * d
        bound_ms = max(bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3
        bound_by = "bytes" if bytes_moved / PEAK_BYTES_PER_S >= flops / PEAK_BF16_FLOPS else "operations"
        print(f"phase 2 kernel main B={b} S={s} H={h} D={d} bf16: max_abs_err {err:.3e} "
              f"(tol atol {TOL['bfloat16'][0]} rtol {TOL['bfloat16'][1]}); kernel_ms {kernel_ms:.4f} "
              f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} bound_us {bound_ms * 1e3:.2f} "
              f"({bound_by}: {bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        results["main"] = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                               bound_ms=bound_ms, bound_by=bound_by)

        # fp32 at the main shape (the library's default dtype=None runs fp32)
        q32, k32, v32 = (rand(b, s, h, d, dtype=torch.float32) for _ in range(3))
        o, lse = fused_mha(q32, k32, v32)
        ro, rlse = fused_mha_reference(q32, k32, v32)
        err = check_close("main fp32 o", o, ro, *TOL["float32"])
        check_close("main fp32 lse", lse, rlse, *LSE_TOL)
        ms32 = cuda_time_ms(lambda: fused_mha(q32, k32, v32), iters=20)
        print(f"phase 2 kernel main fp32: max_abs_err {err:.3e} (tol atol {TOL['float32'][0]} "
              f"rtol {TOL['float32'][1]}); kernel_ms {ms32:.4f}")

        for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
            tol = TOL[name]
            # ragged key mask
            q, k, v = (rand(4, 256, 4, 64, dtype=dtype) for _ in range(3))
            lengths = torch.tensor([256, 200, 77, 1], device="cuda")
            mask = torch.arange(256, device="cuda")[None, :] < lengths[:, None]
            o, lse = fused_mha(q, k, v, mask)
            ro, rlse = fused_mha_reference(q, k, v, mask)
            e_mask = check_close(f"mask {name}", o, ro, *tol)
            check_close(f"mask {name} lse", lse, rlse, *LSE_TOL)
            # unaligned 100 / 300 through the padding entry point, and cross-attention
            q, k, v = rand(2, 100, 4, 64, dtype=dtype), rand(2, 300, 4, 64, dtype=dtype), rand(2, 300, 4, 64, dtype=dtype)
            e_unal = check_close(f"unaligned {name}", dot_product_attention(q, k, v),
                                 dot_product_attention(q, k, v, impl="xla"), *tol)
            q, k, v = rand(2, 256, 4, 64, dtype=dtype), rand(2, 128, 4, 64, dtype=dtype), rand(2, 128, 4, 64, dtype=dtype)
            o, _ = fused_mha(q, k, v)
            e_cross = check_close(f"cross {name}", o, fused_mha_reference(q, k, v)[0], *tol)
            # head dims of the other instances
            e_dims = []
            for hd in (16, 32, 128):
                q, k, v = (rand(2, 128, 2, hd, dtype=dtype) for _ in range(3))
                e_dims.append(check_close(f"D={hd} {name}", fused_mha(q, k, v)[0],
                                          fused_mha_reference(q, k, v)[0], *tol))
            # a fully-masked row: o exactly 0, lse exactly +inf
            q, k, v = (rand(2, 128, 2, 64, dtype=dtype) for _ in range(3))
            mask = torch.stack([torch.zeros(128, dtype=torch.bool, device="cuda"),
                                torch.ones(128, dtype=torch.bool, device="cuda")])
            o, lse = fused_mha(q, k, v, mask)
            if not (bool((o[0] == 0).all()) and bool(torch.isposinf(lse[0]).all())):
                fail(f"fully-masked row {name}: o not exactly 0 or lse not +inf")
            e_full = check_close(f"fully-masked other row {name}", o[1], fused_mha_reference(q, k, v, mask)[0][1], *tol)
            print(f"phase 2 kernel edge cases {name} (tol atol {tol[0]} rtol {tol[1]}): max_abs_err "
                  f"mask {e_mask:.3e} unaligned_100_300 {e_unal:.3e} cross_256_128 {e_cross:.3e} "
                  f"D16/32/128 {max(e_dims):.3e} fully_masked_row o==0 lse==+inf other_row {e_full:.3e}")
        torch.cuda.synchronize()
    return results


def randomize_(model, seed: int) -> None:
    """Seeded noise in every parameter, so the adaLN-zero blocks are live."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if p.ndim >= 2:
                noise = torch.randn(p.shape, generator=gen) * math.prod(p.shape[1:]) ** -0.5
            elif name.endswith("bias"):
                noise = 0.1 * torch.randn(p.shape, generator=gen)
            else:
                noise = 1.0 + 0.1 * torch.randn(p.shape, generator=gen)
            p.copy_(noise)


def build_models():
    import torch

    from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT

    kw = dict(DIT_B2, dtype=torch.bfloat16, stream_dtype=torch.bfloat16)
    model = MMDiT(**kw)  # no device: the card
    randomize_(model, seed=0)
    plain = MMDiT(**kw, attention_impl="xla")
    plain.load_state_dict(model.state_dict(), strict=True)
    return model.eval(), plain.eval()


def phase_forward(model, plain):
    import torch

    from diffulab_tpu_torch.ops.fused_mha import LAUNCHES

    gen = torch.Generator(device="cuda").manual_seed(1)
    b = 2 * SAMPLE_BATCH
    x = torch.randn(b, *LATENT, generator=gen, device="cuda").bfloat16()
    t = torch.rand(b, generator=gen, device="cuda")
    y = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    drop = torch.arange(b, device="cuda") >= SAMPLE_BATCH
    with torch.no_grad():
        before = LAUNCHES["fused_mha_fwd"]
        out = model(x, t, {"y": y}, drop)["x"]
        launches = LAUNCHES["fused_mha_fwd"] - before
        ref = plain(x, t, {"y": y}, drop)["x"]
    torch.cuda.synchronize()
    if out.shape != (b, *LATENT) or not bool(torch.isfinite(out).all()):
        fail("DiT-B/2 forward: bad shape or non-finite output")
    rel = float((out.float() - ref.float()).abs().max() / ref.float().abs().max())
    if rel > DIT_REL_TOL or launches != DIT_B2["depth"]:
        fail(f"DiT-B/2 forward: rel err {rel:.3e} (tol {DIT_REL_TOL}), launches {launches}")
    print(f"phase 3 DiT-B/2 forward B={b} bf16: kernel path vs plain attention max rel err {rel:.3e} "
          f"(tol {DIT_REL_TOL}); {launches} kernel launches; output max |x| {float(ref.float().abs().max()):.3f}")


def phase_generate(model, plain):
    import torch

    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.ops.fused_mha import LAUNCHES

    diffuser = Diffuser(model, "euler", model_type="rectified_flow", n_steps=STEPS,
                        extra_args={"logits_normal": True})
    per_request = STEPS * DIT_B2["depth"]
    times, first = [], None
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES["fused_mha_fwd"] = 0
    labels = torch.Generator(device="cuda").manual_seed(99)
    for r in range(N_REQUESTS):
        y = torch.randint(0, 1000, (SAMPLE_BATCH,), generator=labels, device="cuda")
        noise = torch.Generator(device="cuda").manual_seed(100 + r)
        before = LAUNCHES["fused_mha_fwd"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = diffuser.generate({"y": y}, data_shape=(SAMPLE_BATCH, *LATENT), generator=noise,
                                guidance_scale=CFG, dtype=torch.bfloat16)["x"]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launched = LAUNCHES["fused_mha_fwd"] - before
        if out.shape != (SAMPLE_BATCH, *LATENT) or out.dtype != torch.bfloat16:
            fail(f"request {r}: output {tuple(out.shape)} {out.dtype}")
        if not bool(torch.isfinite(out).all()):
            fail(f"request {r}: non-finite output")
        if launched != per_request:
            fail(f"request {r}: {launched} fused_mha_fwd launches, expected {per_request}")
        if first is None:
            first = (y, out)
    total_launches = LAUNCHES["fused_mha_fwd"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # request 0 again with the plain attention, from the same starting noise
    y, out = first
    noise = torch.Generator(device="cuda").manual_seed(100)
    ref = Diffuser(plain, "euler", n_steps=STEPS).generate(
        {"y": y}, data_shape=(SAMPLE_BATCH, *LATENT), generator=noise, guidance_scale=CFG,
        dtype=torch.bfloat16)["x"]
    rel = float((out.float() - ref.float()).abs().max() / ref.float().abs().max())
    if rel > GEN_REL_TOL:
        fail(f"request 0 against its plain-attention rerun: rel err {rel:.3e} (tol {GEN_REL_TOL})")
    ms = [t * 1e3 for t in times]
    print(f"phase 4 generate x{N_REQUESTS}: batch {SAMPLE_BATCH} {LATENT} Euler-{STEPS} CFG {CFG} bf16: "
          f"ms/request {[round(m, 2) for m in ms]} (median {statistics.median(ms):.2f}), imgs/s "
          f"{[round(SAMPLE_BATCH / t, 2) for t in times]}; fused_mha_fwd launches {per_request}/request "
          f"({total_launches} total); peak mem {peak_gib:.2f} GiB; request 0 vs plain-attention rerun "
          f"max rel err {rel:.3e} (tol {GEN_REL_TOL})")
    return total_launches, ms


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    if not (ROOT / "diffulab_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the diffulab_tpu_torch package is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # full-precision fp32 products everywhere (cuDNN would otherwise default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    phase_build()
    kernel = phase_kernel()
    model, plain = build_models()
    phase_forward(model, plain)
    launches, _ = phase_generate(model, plain)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    main_case = kernel["main"]
    print(json.dumps({"kernels": [{
        "name": "fused_mha_fwd",
        "route": "cuda",
        "source": "diffulab_tpu_torch/csrc/fused_mha_fwd.cu",
        "replaces": "diffulab_tpu/ops/fused_mha.py:50",
        "launches": launches,
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
