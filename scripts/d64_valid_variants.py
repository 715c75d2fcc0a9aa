#!/usr/bin/env python3
"""Variants of the K1 and K2 instances built around the valid rows at head
dim 64 (``csrc/fused_mha_{fwd,bwd}.cu``, ``tf32x3.cuh``, ``bf16_valid.cuh``),
built side by side and timed on one card.

Each variant is the kernels' sources under textual substitutions (each
asserted to apply), built with the port's ``nvcc`` flags into
``diffulab_tpu_torch/_build/variants/`` (``scripts/variant_build.py``) and
called through the port's wrappers, its libraries put in their place:

- ``kernel``: the sources as they are;
- ``slots3``: rings of three slots, two loads in flight while a slot is
  computed (the sources: two slots, one load);
- ``rows32``: 32 query rows (or keys) a CTA at D = 64 (the sources: 64);
- ``bf16_tile32``: 32-key bf16 slots (2 kept between K1's passes);
- ``precise_exp``: the bf16 instances' exponentials by ``expf`` and K1's p
  divided by l, as at D = 192-512 (the sources: ``__expf`` and a product with
  1 / l at D = 64, ``bf16_exp``);
- ``dq_nokeep``: the fp32 dq kernel forms s and dp again in its second pass
  (the sources keep p and dp of a 64-token row, ``vr_dq_keep``);
- ``bf16_keep2``: bf16 K1 keeps two live tiles' scores (the sources: one);
  ``bf16_min3``: bf16 K1 compiled for three CTAs an SM
  (``__launch_bounds__`` at 170 registers).

At the padded short sequences of ``ab_fused_mha_fwd.SHORT_CASES`` it prints,
for each variant, ptxas's registers and spills of the D = 64 kernels and K1's
and K2's device ms per call from CUDA-graph replays on the unpadded q (do)
and the padded k, v and mask, with each output's largest difference from the
plain version; and once, the padded instances' times on the padded q (do).

Run from the repository root on the card:
``python3 scripts/d64_valid_variants.py [variant ...]`` (all by default).
"""

from __future__ import annotations

import json
import sys

from variant_build import build_variants, card

SOURCES = ("fused_mha_fwd", "fused_mha_bwd")

KEEP = "constexpr int VR_BF16_KEEP = 1;"

#: variant -> [(file under csrc/, text, its replacement)]
VARIANTS = {
    "kernel": [],
    "slots3": [("tf32x3.cuh", "constexpr int VR_SLOTS = 2;", "constexpr int VR_SLOTS = 3;")],
    "rows32": [("tf32x3.cuh", "  return D == 192 ? 32 : D <= 256 ? 64 : 16;",
                "  return D == 192 || D == 64 ? 32 : D <= 256 ? 64 : 16;")],
    "bf16_tile32": [("bf16_valid.cuh", "  return D == 64 ? 64 : VR_BF16_TILE;",
                     "  return D == 64 ? 32 : VR_BF16_TILE;"),
                    ("bf16_valid.cuh", KEEP, "constexpr int VR_BF16_KEEP = 2;")],
    "precise_exp": [("bf16_valid.cuh", "  if constexpr (D == 64)\n    return __expf(x);",
                     "  if constexpr (false)\n    return __expf(x);"),
                    ("fused_mha_fwd.cu", "if constexpr (D == 64)  // p times 1 / l",
                     "if constexpr (false)  // p times 1 / l"),
                    ("fused_mha_bwd.cu", "probs_f32<KT, D == 64>(", "probs_f32<KT, false>(")],
    "dq_nokeep": [("tf32x3.cuh", "constexpr int vr_dq_keep() {\n  return D == 64 ? 2 : 0;",
                   "constexpr int vr_dq_keep() {\n  return 0;")],
    "bf16_keep2": [("bf16_valid.cuh", KEEP, "constexpr int VR_BF16_KEEP = 2;")],
    "bf16_min3": [("fused_mha_fwd.cu", "__launch_bounds__(vr_threads<D>())\nmha_fwd_bf16_valid(",
                   "__launch_bounds__(vr_threads<D>(), D == 64 ? 3 : 1)\nmha_fwd_bf16_valid(")],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("d64_valid_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sys.argv[1:] or list(VARIANTS)
    libs = build_variants(VARIANTS, names, SOURCES, "valid<64>")
    import chip_smoke
    from ab_fused_mha_fwd import SHORT_CASES, padded_q, short_inputs

    from diffulab_tpu_torch.ops import _build
    from diffulab_tpu_torch.ops.fused_mha import fused_mha, fused_mha_bwd, fused_mha_bwd_reference, fused_mha_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {name: {} for name in names}
    padded = {}
    with torch.no_grad():
        for case in SHORT_CASES:
            q, k, v, do, key_mask = short_inputs(case, gen)
            s = -(-q.shape[1] // 128) * 128
            kp, vp = padded_q(k, s), padded_q(v, s)
            mask = torch.nn.functional.pad(
                torch.ones(q.shape[:2], dtype=torch.bool, device="cuda") if key_mask is None else key_mask,
                (0, s - q.shape[1]))
            ro, rlse = fused_mha_reference(q, kp, vp, mask)
            refs = fused_mha_bwd_reference(q, kp, vp, mask, rlse, do)
            dtype = str(q.dtype).removeprefix("torch.")
            for name in names:
                _build._loaded["fused_mha_fwd"] = libs[name, "fused_mha_fwd"]
                _build._loaded["fused_mha_bwd"] = libs[name, "fused_mha_bwd"]
                o, lse = fused_mha(q, kp, vp, mask)
                grads = fused_mha_bwd(q, kp, vp, mask, lse, do)
                torch.cuda.synchronize()
                rows[name][case] = {
                    "K1_ms": round(chip_smoke.cuda_graph_ms(lambda: fused_mha(q, kp, vp, mask)), 4),
                    "K2_ms": round(chip_smoke.cuda_graph_ms(lambda: fused_mha_bwd(q, kp, vp, mask, lse, do),
                                                            calls=10, replays=5), 4),
                    "K1_err": float(f"{float((o.float() - ro.float()).abs().max()):.3e}"),
                    "K2_err": float(f"{max(float((g.float() - r.float()).abs().max())
                                           for g, r in zip(grads, refs)):.3e}"),
                }
            _build._loaded["fused_mha_fwd"] = libs[names[0], "fused_mha_fwd"]
            _build._loaded["fused_mha_bwd"] = libs[names[0], "fused_mha_bwd"]
            qp, dop = padded_q(q, s), padded_q(do, s)
            _, lse_p = fused_mha(qp, kp, vp, mask)
            padded[case] = {"K1_ms": round(chip_smoke.cuda_graph_ms(lambda: fused_mha(qp, kp, vp, mask)), 4),
                            "K2_ms": round(chip_smoke.cuda_graph_ms(lambda: fused_mha_bwd(qp, kp, vp, mask, lse_p, dop),
                                                                    calls=10, replays=5), 4),
                            "dtype": dtype}
    _build._loaded.pop("fused_mha_fwd", None)
    _build._loaded.pop("fused_mha_bwd", None)
    for name, row in rows.items():
        print(name, json.dumps(row))
    print("padded instances", json.dumps(padded))
    print(f"card: {card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
