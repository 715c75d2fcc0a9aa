#!/usr/bin/env python3
"""Variants of the staged fp32 K2 at the MNIST UNet's head dims 256 and 512
and of the staged fp32 K1 at 256 (``csrc/fused_mha_{fwd,bwd}.cu``:
``mha_bwd_fused_tf32x3_staged``, ``mha_fwd_tf32x3_staged``; their rules in
``tf32x3.cuh``), built side by side and timed on one card.

Each variant is the kernels' sources under textual substitutions (each
asserted to apply), built with the port's ``nvcc`` flags into
``diffulab_tpu_torch/_build/variants/`` (``scripts/variant_build.py``) and
called through the port's wrappers, its libraries put in their place:

- ``kernel``: the sources as they are (K2 route (b): one CTA a head, D
  staged 32 columns at a time at D = 256, two CTAs an SM; 128 columns in
  four score partials at 512, eight warps; K1 64 columns at 256, and at 512
  the split instance of 8-key tiles);
- ``blocks1``: K2's registers bound for one CTA an SM, not two (255 a
  thread at D = 256, not 128);
- ``chunk64``: K2 stages 64 columns at D = 256 (one CTA an SM);
  ``c64_512``: 64 at 512 (the sources: 128); ``parts1_512``: one score sum a
  stage at 512 (the sources: four interleaved partials);
- ``stages3``: rings of three stages, K1 and K2 (the sources: two);
- ``slot32``: slots of 32 keys at D = 256, K1 and K2 (the UNet's live row in
  two slots: K1 in two passes, K2 with a di pass first);
- ``k2_rows32``: K2 takes a head's rows 32 at a time at D = 256, in turn
  inside the CTA (the sources: 64);
- ``k1_rows32``: K1 takes 32 rows a CTA at D = 256 (two CTAs a head);
- ``k1_chunk32``, ``k1_chunk128``: K1 stages 32 or 128 columns at D = 256
  (the sources: 64);
- ``split``: K2 as the split pair of 8-key tiles at D = 256 and 512 (a dq
  kernel that forms s and dp twice, then a dk/dv kernel, lse and di through
  a workspace; 2 and 4 column groups of 128);
- ``k1_valid``: K1 as the split instance of 8-key tiles at D = 256 (a
  partial-score exchange between column groups every tile).

At the shapes of ``ab_fused_mha_fwd.D2_CASES`` (K2 at B=128) it prints, for
each variant, ptxas's registers and spills of the fp32 instances at D = 256
and 512, K1's and K2's device ms per call from CUDA-graph replays on the
unpadded q (do) and the padded k, v and mask, fp32 draws, and each output's
largest error as a fraction of chip_smoke.py's tolerance (K1's o atol / rtol
2e-5, K2's 2e-5·(max|ref| + |ref|)) against the plain version, there and on
the edge cases: an empty 8-key tile beside a fully masked row, no mask, and
an Sq past a CTA's rows (100 of 128 keys at D = 256, 28 at 512).

Run from the repository root on the card:
``python3 scripts/d2_valid_variants.py [variant ...]`` (all by default).
"""

from __future__ import annotations

import json
import sys

from variant_build import build_variants, card

SOURCES = ("fused_mha_fwd", "fused_mha_bwd")
HEADER = "tf32x3.cuh"


def rule(name: str, body: str, new: str) -> tuple[str, str, str]:
    """(the header, a staged rule's ``name() {\\n  return body;``, the same with ``new``)."""
    return (HEADER, f"constexpr int {name}() {{\n  return {body};", f"constexpr int {name}() {{\n  return {new};")


K2_DISPATCH = ("case {d}: err = dtype == 0 ? launch_f32_staged<{d}>(a, s)", "case {d}: err = dtype == 0 ? "
               "launch_f32_valid<{d}>(a, s)")
K1_DISPATCH = ("K1_VALID({d}, launch_bf16_staged, launch_f32_staged)", "K1_VALID({d}, launch_bf16_staged, "
               "launch_f32_valid)")

#: variant -> [(file under csrc/, text, its replacement)]
VARIANTS = {
    "kernel": [],
    "blocks1": [(HEADER, "constexpr int VR_F32S_BWD_BLOCKS = 2;", "constexpr int VR_F32S_BWD_BLOCKS = 1;")],
    "chunk64": [rule("vr_f32s_chunk", "D == 256 ? 32 : 128", "D == 256 ? 64 : 128")],
    "c64_512": [rule("vr_f32s_chunk", "D == 256 ? 32 : 128", "D == 256 ? 32 : 64")],
    "parts1_512": [rule("vr_f32s_parts", "D == 256 ? 1 : 4", "1")],
    "stages3": [(HEADER, "constexpr int VR_F32S_STAGES = 2;", "constexpr int VR_F32S_STAGES = 3;")],
    "slot32": [rule("vr_f32s_slot", "D == 256 ? 64 : 16", "D == 256 ? 32 : 16")],
    "k2_rows32": [rule("vr_f32s_rows", "D == 256 ? 64 : 16", "D == 256 ? 32 : 16")],
    "k1_rows32": [(HEADER, "constexpr int VR_F32S_FWD_ROWS = 64;", "constexpr int VR_F32S_FWD_ROWS = 32;")],
    "k1_chunk32": [(HEADER, "constexpr int VR_F32S_FWD_CHUNK = 64;", "constexpr int VR_F32S_FWD_CHUNK = 32;")],
    "k1_chunk128": [(HEADER, "constexpr int VR_F32S_FWD_CHUNK = 64;", "constexpr int VR_F32S_FWD_CHUNK = 128;")],
    "split": [("fused_mha_bwd.cu", K2_DISPATCH[0].format(d=d), K2_DISPATCH[1].format(d=d)) for d in (256, 512)],
    "k1_valid": [("fused_mha_fwd.cu", K1_DISPATCH[0].format(d=256), K1_DISPATCH[1].format(d=256))],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("d2_valid_variants: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    libs = build_variants(VARIANTS, names, SOURCES, ("tf32x3_staged<", "tf32x3_valid<256", "tf32x3_valid<512"))
    import chip_smoke
    from ab_fused_mha_fwd import D2_CASES, unet_inputs

    from diffulab_tpu_torch.ops import _build
    from diffulab_tpu_torch.ops.fused_mha import fused_mha, fused_mha_bwd, fused_mha_bwd_reference, fused_mha_reference
    from diffulab_tpu_torch.utils import full_fp32_products

    full_fp32_products()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {case: unet_inputs(case, gen, D2_CASES, "float32") for case in D2_CASES}
    for d, tokens, past in ((256, 64, 100), (512, 16, 28)):  # the edge cases, at B=8
        def rand(n):
            return torch.randn(8, n, 2, d, generator=gen, device="cuda")

        k, v = rand(128), rand(128)
        cases[f"d{d}_hole_B8"] = (rand(tokens), k, v, rand(tokens), chip_smoke.d2_mask("hole", 8, tokens))
        cases[f"d{d}_unmasked_B8"] = (rand(tokens), k, v, rand(tokens), None)
        cases[f"d{d}_past_rows_B8"] = (rand(past), k, v, rand(past), chip_smoke.d2_mask("padded", 8, past))
    atol, rtol = chip_smoke.TOL["float32"]
    tol = chip_smoke.BWD_TOL["float32"]
    rows = {name: {} for name in names}
    with torch.no_grad():
        for case, (q, k, v, do, mask) in cases.items():
            ro, rlse = fused_mha_reference(q, k, v, mask)
            refs = fused_mha_bwd_reference(q, k, v, mask, rlse, do)
            for name in names:
                _build._loaded["fused_mha_fwd"] = libs[name, "fused_mha_fwd"]
                _build._loaded["fused_mha_bwd"] = libs[name, "fused_mha_bwd"]
                o, lse = fused_mha(q, k, v, mask)
                grads = fused_mha_bwd(q, k, v, mask, rlse, do)
                torch.cuda.synchronize()
                row = {"K1_of_tol": round(float(((o - ro).abs() / (atol + rtol * ro.abs())).max()), 4),
                       "K2_of_tol": round(max(float(((g - r).abs() / (tol * (r.abs().max() + r.abs()))).max())
                                              for g, r in zip(grads, refs)), 4)}
                if case in D2_CASES:
                    row["K1_ms"] = round(chip_smoke.cuda_graph_ms(lambda: fused_mha(q, k, v, mask)), 4)
                    if q.shape[0] == 128:
                        row["K2_ms"] = round(chip_smoke.cuda_graph_ms(
                            lambda: fused_mha_bwd(q, k, v, mask, lse, do), calls=10, replays=5), 4)
                rows[name][case] = row
    _build._loaded.pop("fused_mha_fwd", None)
    _build._loaded.pop("fused_mha_bwd", None)
    for name, row in rows.items():
        print(name, json.dumps(row))
    print(f"card: {card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
