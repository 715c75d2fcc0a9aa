#!/usr/bin/env python3
"""Variants of the fp32 K1 and K2 (3xTF32, ``csrc/tf32x3.cuh``) built side
by side and timed on one card.

Each variant is the kernels' sources (``fused_mha_fwd.cu``,
``fused_mha_bwd.cu`` and the ``tf32x3.cuh`` they include) under textual
substitutions (each asserted to apply), built with the port's ``nvcc`` flags
into ``diffulab_tpu_torch/_build/variants/`` and called through the same C
interfaces:

- ``kernel``: the sources as they are: hi = x rounded to TF32 by bit
  arithmetic (nearest, ties away), lo = x - hi left for the tensor cores to
  read to its top 19 bits;
- ``cvt_rna``: hi and lo both by ``cvt.rna.tf32.f32``;
- ``rounded_lo``: lo rounded by the same bit arithmetic as hi;
- ``fwd_keys64``: K1 with 64-key ring slots (two CTAs an SM at D = 64, not
  three);
- ``dkv_queries32``: K2's dk/dv kernel with 32-query ring slots (three CTAs
  an SM, not two, and half the columns for each split fragment of k or v);
- ``dq_recompute``: K2's dq kernel forming s and dp again for dq (5
  products) where the sources keep p and dp in shared memory (3);
- ``fresh``: K1's P.V and K2's dq, dk and dv (at head dims up to 128) summed
  from zero a tile and added in fp32 (``scores_times_tile_fresh``, as the
  flash kernels sum), where the sources carry them through every tile in the
  tensor cores' accumulator, which rounds toward zero.

At slice C1's shapes (S=256, H=8, D=64, fp32) it prints, for each variant,
ptxas's registers and spills, K1's device ms per call from CUDA-graph
replays at B=128 and B=32, K2's at B=128, and each one's largest difference
from its plain version. Then, on the same inputs for every variant (drawn in
fp32), the fp32 checks of ``chip_smoke.py``'s phases 2 and 5 whose sums are
longest (Sq = Skv = 512, D = 64 and 128) and phase 5's ragged mask (lengths
256, 200, 77 and 1): each output's largest error as a fraction of the
phase's tolerance (above 1 the phase fails).

Run from the repository root on the card:
``python3 scripts/fp32_attn_variants.py [variant ...]`` (all by default).
"""

from __future__ import annotations

import ctypes
import json
import sys

from variant_build import build_variants, card

SOURCES = ("fused_mha_fwd", "fused_mha_bwd")

HI_BITS = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
HI_CVT = '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n  return r;'
LO_RAW = "  lo = __float_as_uint(x - __uint_as_float(hi));"
LO_ROUNDED = "  lo = tf32_rna(x - __uint_as_float(hi));"
FWD_KEYS = "constexpr int F32_KEYS = 32;"
DKV_QUERIES = "constexpr int dkv_queries() {\n  return D <= 64 ? 64 : 32;"
KEEPS = "  return D <= 64 && dq_kept_smem_bytes<D>(Skv) <= SMEM_LIMIT;"
CARRIED = "scores_times_tile<"
FRESH = "scores_times_tile_fresh<"
#: the carried sums of the instances at head dims up to 128; dk and dv take 32-column blocks at D = 128
FRESH_SITES = [("fused_mha_fwd.cu", CARRIED + "D, KT>(acc, s,", FRESH + "D, KT>(acc, s,"),
               ("fused_mha_bwd.cu", CARRIED + "D, KH>(acc, ds,", FRESH + "D, KH>(acc, ds,"),
               ("fused_mha_bwd.cu", CARRIED + "D, KT>(acc, p,", FRESH + "D, KT>(acc, p,"),
               ("fused_mha_bwd.cu", CARRIED + "D, QT>(", FRESH + "D, QT, (D <= 64 ? D : 32)>(")]
#: variant -> [(file under csrc/, text, its replacement)]
VARIANTS = {
    "kernel": [],
    "cvt_rna": [("tf32x3.cuh", HI_BITS, HI_CVT), ("tf32x3.cuh", LO_RAW, LO_ROUNDED)],
    "rounded_lo": [("tf32x3.cuh", LO_RAW, LO_ROUNDED)],
    "fwd_keys64": [("fused_mha_fwd.cu", FWD_KEYS, "constexpr int F32_KEYS = 64;")],
    "dkv_queries32": [("fused_mha_bwd.cu", DKV_QUERIES, DKV_QUERIES.replace("D <= 64 ? 64 : 32", "32"))],
    "dq_recompute": [("fused_mha_bwd.cu", KEEPS, "  return false;")],
    "fresh": FRESH_SITES,
}


def margins(libs, names, gen) -> dict[str, dict[str, dict[str, float]]]:
    """{variant: {case: {output: largest error / tolerance}}} of the fp32 K1
    and K2 through the port's wrappers with each variant's libraries in
    place, at phases 2 and 5's tolerances, on the same inputs for every
    variant."""
    import torch

    import chip_smoke
    from diffulab_tpu_torch.ops import _build
    from diffulab_tpu_torch.ops.fused_mha import fused_mha, fused_mha_bwd, fused_mha_bwd_reference, fused_mha_reference

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    cases = {f"512_D{hd}": (tuple(rand(4, 512, 4, hd) for _ in range(4)), None) for hd in (64, 128)}
    lengths = torch.tensor([256, 200, 77, 1], device="cuda")
    cases["mask_256"] = (tuple(rand(4, 256, 4, 64) for _ in range(4)),
                         torch.arange(256, device="cuda")[None, :] < lengths[:, None])
    atol, rtol = chip_smoke.TOL["float32"]
    tol = chip_smoke.BWD_TOL["float32"]
    out = {name: {} for name in names}
    for case, (tensors, mask) in cases.items():
        q, k, v, do = tensors
        ro, rlse = fused_mha_reference(q, k, v, mask)
        refs = fused_mha_bwd_reference(q, k, v, mask, rlse, do)
        for name in names:
            _build._loaded["fused_mha_fwd"] = libs[name, "fused_mha_fwd"]
            _build._loaded["fused_mha_bwd"] = libs[name, "fused_mha_bwd"]
            o, _ = fused_mha(q, k, v, mask)
            row = {"o": float(((o - ro).abs() / (atol + rtol * ro.abs())).max())}
            for label, g, r in zip(("dq", "dk", "dv"), fused_mha_bwd(q, k, v, mask, rlse, do), refs):
                err = (g - r).abs()
                row[label] = float(torch.where(err == 0, 0.0, err / (tol * (r.abs().max() + r.abs()))).max())
            out[name][case] = {key: round(val, 3) for key, val in row.items()}
    _build._loaded.pop("fused_mha_fwd", None)
    _build._loaded.pop("fused_mha_bwd", None)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fp32_attn_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sys.argv[1:] or list(VARIANTS)
    libs = build_variants(VARIANTS, names, SOURCES, "tf32x3<64")
    import chip_smoke
    from diffulab_tpu_torch.ops.fused_mha import fused_mha_bwd_reference, fused_mha_reference

    gen = torch.Generator(device="cuda").manual_seed(9)
    s, h, d = chip_smoke.C1_SEQ, chip_smoke.C1_HEADS, 64

    def fwd(fn, q, k, v, o, lse):
        b = q.shape[0]
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(), lse.data_ptr(), b, s, s, h, d,
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                 ctypes.c_float(d ** -0.5), 0, 0, 0, 0, 0, torch.cuda.current_device(),
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    def bwd(fn, q, k, v, do, lse, out):
        dq, dk, dv, ws = out
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), None, lse.data_ptr(), ws.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), q.shape[0], s, s, h, d, q.stride(0), q.stride(1),
                 k.stride(0), k.stride(1), v.stride(0), v.stride(1), do.stride(0), do.stride(1),
                 ctypes.c_float(d ** -0.5), 0, 0, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    rows = {name: {} for name in names}
    for b in (chip_smoke.C1_BATCH, 2 * chip_smoke.C1_SAMPLES):
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda") for _ in range(3))
        ref, _ = fused_mha_reference(q, k, v)
        for name in names:
            o, lse = torch.empty_like(q), torch.empty(b, s, h, device="cuda")
            fn = libs[name, "fused_mha_fwd"].fused_mha_fwd
            fwd(fn, q, k, v, o, lse)
            torch.cuda.synchronize()
            rows[name][f"K1_B{b}"] = {
                "device_ms": round(chip_smoke.cuda_graph_ms(lambda: fwd(fn, q, k, v, o, lse)), 4),
                "max_abs_err": float(f"{float((o - ref).abs().max()):.3e}")}
    b = chip_smoke.C1_BATCH
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device="cuda") for _ in range(4))
    _, lse = fused_mha_reference(q, k, v)
    refs = fused_mha_bwd_reference(q, k, v, None, lse, do)
    for name in names:
        fn = libs[name, "fused_mha_bwd"].fused_mha_bwd
        out = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), torch.empty(2, b, h, s, device="cuda"))
        bwd(fn, q, k, v, do, lse, out)
        torch.cuda.synchronize()
        err = chip_smoke.check_grads(name, out[:3], refs, chip_smoke.BWD_TOL["float32"])
        ms = chip_smoke.cuda_graph_ms(lambda: bwd(fn, q, k, v, do, lse, out), calls=10, replays=5)
        rows[name][f"K2_B{b}"] = {"device_ms": round(ms, 4), "max_abs_err": float(f"{err:.3e}")}
    fractions = margins(libs, names, gen)
    for name, row in rows.items():
        print(name, json.dumps(row), "of_tol", json.dumps(fractions[name]))
    print(f"card: {card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
