#!/usr/bin/env python3
"""Variants of the staged bf16 K1 and K2 at the UNets' head dims 192-512
(``csrc/fused_mha_{fwd,bwd}.cu``: ``mha_fwd_bf16_staged``,
``mha_bwd_{dq,dkv}_bf16_staged``; their rules in ``bf16_valid.cuh``), built
side by side and timed on one card.

Each variant is the kernels' sources under textual substitutions (each
asserted to apply), built with the port's ``nvcc`` flags into
``diffulab_tpu_torch/_build/variants/`` (``scripts/variant_build.py``) and
called through the port's wrappers, its libraries put in their place:

- ``kernel``: the sources as they are;
- ``slot16``: slots of 16 keys (queries) at every head dim, the UNets' live
  row of 64 keys in four slots, each its own wait (the sources: 64 at D =
  192 and 256);
- ``split``: K2 as two kernels at every shape, the dq kernel (which writes
  lse and di to a workspace) then the dk/dv kernel (the sources: one fused
  kernel where a head's valid query rows are one CTA's, the UNets');
- ``k1_cols_half``: K1 in two column groups at D = 192 and 256 (the sources:
  one); ``k1_cols64_384``: K1 in groups of 64 columns at D = 384 (the
  sources: 128); ``bwd_cols_whole192``: K2 in one group at D = 192 (the
  sources: two of 96);
- ``dkdv_unrolled``: the fused K2's dk and dv products unrolled over their
  k-steps (the sources: one at a time);
- ``no_spec``: K2's K and V requested once the mask row is read (the
  sources: the row's first slot requested with Q and dO, before it);
- ``v_after_k``: K1 requests V once K has landed (the sources: with K);
  ``spec_kv``: K1 requests the K and V of the row's first slot with Q,
  before it has read the mask row, as K2 does (the sources: once it has);
- ``precise_exp``: ``expf``, and K1's p divided by l (the sources:
  ``__expf`` and a product with 1 / l);
- ``rows32``: 32 query rows (keys) a CTA at D = 192 and 256 (the sources:
  64, a head's valid rows).

At the UNets' shapes of ``ab_fused_mha_fwd.UNET_CASES`` and at ``D3_LONG``
(512 keys at D = 192, 400 attended: seven slots, two passes) it prints, for
each variant, ptxas's registers and spills of the staged kernels and K1's and
K2's device ms per call from CUDA-graph replays on the unpadded q (do) and
the padded k, v and mask, with each output's largest difference from the
plain version and K1's o bitwise share.

Run from the repository root on the card:
``python3 scripts/d3_valid_variants.py [variant ...]`` (all by default).
"""

from __future__ import annotations

import json
import sys

from variant_build import build_variants, card

SOURCES = ("fused_mha_fwd", "fused_mha_bwd")

SLOT = "constexpr int vr_bf16_slot() {\n  return D <= 256 ? 64 : 16;"
ROWS = "constexpr int vr_bf16_rows() {\n  return D <= 256 ? 64 : 16;"
COLS = ("constexpr int vr_bf16_cols() {\n  return BWD ? (D == 192 ? 96 : D == 384 ? 64 : 128) : D <= 256 ? D : "
        "128;")
AWAIT = ("    issue_upto(first + NB - 1);\n    cp_async_wait_upto<NB - 1>(issued - last - 1);\n"
         "    __syncthreads();\n")
Q_MASK = ("  cp_async_commit();\n  find_live_tiles<KT>(live, mb, n_tiles);\n  __syncthreads();\n  const int n_live = "
          "live[n_tiles], n_slots = (n_live + CT - 1) / CT;\n  const bool kept = n_slots == 1;  // the same for every "
          "thread: p stays in registers\n")
SPEC_BWD = ("  stage_bf16_rows<D, SLOT, THREADS>(ks, k + b * k_sb + h * D, k_ss, 0, Skv);\n"
            "  stage_bf16_rows<D, SLOT, THREADS>(vs, v + b * v_sb + h * D, v_ss, 0, Skv);\n")


def cols(rule: str) -> list:
    return [("bf16_valid.cuh", COLS, f"constexpr int vr_bf16_cols() {{\n  return {rule};")]


#: variant -> [(file under csrc/, text, its replacement)]
VARIANTS = {
    "kernel": [],
    "slot16": [("bf16_valid.cuh", SLOT, "constexpr int vr_bf16_slot() {\n  return 16;")],
    "split": [("fused_mha_bwd.cu", "if (a.Sq <= ROWS) {  // one kernel a (batch, head)",
               "if (false) {  // one kernel a (batch, head)")],
    "k1_cols_half": cols("BWD ? (D == 192 ? 96 : D == 384 ? 64 : 128) : D <= 256 ? D / 2 : 128"),
    "k1_cols64_384": cols("BWD ? (D == 192 ? 96 : D == 384 ? 64 : 128) : D <= 256 ? D : D == 384 ? 64 : 128"),
    "bwd_cols_whole192": cols("BWD ? (D == 192 ? 192 : D == 384 ? 64 : 128) : D <= 256 ? D : 128"),
    "dkdv_unrolled": [("bf16_valid.cuh", "#pragma unroll 1\n  for (int kk = 0; kk < N / 16; ++kk) {\n    // A = S^T",
                       "#pragma unroll\n  for (int kk = 0; kk < N / 16; ++kk) {\n    // A = S^T")],
    "no_spec": [("fused_mha_bwd.cu", SPEC_BWD + "  cp_async_commit();\n  find_live_tiles",
                 "  cp_async_commit();\n  find_live_tiles"),
                ("fused_mha_bwd.cu", "int resident = live_prefix<CT>(live, n_live) ? 0 : -1;", "int resident = -2;")],
    "v_after_k": [("fused_mha_fwd.cu", AWAIT, "    issue_upto(last);\n    cp_async_wait_upto<NB - 1>(issued - last - "
                   "1);\n    __syncthreads();\n    issue_upto(first + NB - 1);\n")],
    "spec_kv": [("fused_mha_fwd.cu", Q_MASK, "  cp_async_commit();\n  stage_bf16_rows<D, SLOT, THREADS>(buf, kb, k_ss, 0, "
                 "Skv);\n  cp_async_commit();\n  stage_bf16_rows<D, SLOT, THREADS>(buf + SLOT * LD, vb, v_ss, 0, Skv);\n"
                 "  cp_async_commit();\n  find_live_tiles<KT>(live, mb, n_tiles);\n  __syncthreads();\n  const int "
                 "n_live = live[n_tiles], n_slots = (n_live + CT - 1) / CT;\n  const bool kept = n_slots == 1;\n"
                 "  if (!kept || !live_prefix<CT>(live, n_live)) {\n    cp_async_wait<0>();\n    __syncthreads();\n"
                 "  }\n"),
                ("fused_mha_fwd.cu", "  int issued = 0;\n", "  int issued = kept && live_prefix<CT>(live, n_live) ? 2 : "
                 "0;\n")],
    "precise_exp": [("fused_mha_fwd.cu", "l[r] *= __expf(m[r] - m_new);", "l[r] *= expf(m[r] - m_new);"),
                    ("fused_mha_fwd.cu", "l[e >> 1] += __expf(s[nt][e] - m[e >> 1]);",
                     "l[e >> 1] += expf(s[nt][e] - m[e >> 1]);"),
                    ("fused_mha_fwd.cu", "s[nt][e] = __expf(s[nt][e] - m[e >> 1]) * inv_l[e >> 1];",
                     "s[nt][e] = expf(s[nt][e] - m[e >> 1]) / l[e >> 1];"),
                    ("fused_mha_bwd.cu", "p[nt][e] = __expf(p[nt][e] - lse_r[e >> 1]);",
                     "p[nt][e] = expf(p[nt][e] - lse_r[e >> 1]);"),
                    ("fused_mha_bwd.cu", "p[nt][e] = __expf(x - lse_s[", "p[nt][e] = expf(x - lse_s[")],
    "rows32": [("bf16_valid.cuh", ROWS, "constexpr int vr_bf16_rows() {\n  return D <= 256 ? 32 : 16;")],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("d3_valid_variants: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    libs = build_variants(VARIANTS, names, SOURCES, "bf16_staged")
    import chip_smoke
    from ab_fused_mha_fwd import UNET_CASES, unet_inputs

    from diffulab_tpu_torch.ops import _build
    from diffulab_tpu_torch.ops.fused_mha import fused_mha, fused_mha_bwd, fused_mha_bwd_reference, fused_mha_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {case: unet_inputs(case, gen) for case in UNET_CASES}
    d, sq, skv, attended = chip_smoke.D3_LONG
    q, do = (torch.randn(8, sq, 2, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(8, skv, 2, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
    cases["d3_long_192_B8"] = (q, k, v, do, (torch.arange(skv, device="cuda") < attended)[None].expand(8, -1))
    rows = {name: {} for name in names}
    with torch.no_grad():
        for case, (q, k, v, do, mask) in cases.items():
            ro, rlse = fused_mha_reference(q, k, v, mask)
            refs = fused_mha_bwd_reference(q, k, v, mask, rlse, do)
            for name in names:
                _build._loaded["fused_mha_fwd"] = libs[name, "fused_mha_fwd"]
                _build._loaded["fused_mha_bwd"] = libs[name, "fused_mha_bwd"]
                o, lse = fused_mha(q, k, v, mask)
                grads = fused_mha_bwd(q, k, v, mask, lse, do)
                torch.cuda.synchronize()
                row = {"K1_err": float(f"{float((o.float() - ro.float()).abs().max()):.3e}"),
                       "K1_bitwise": round(chip_smoke.bitwise_share(o, ro), 4),
                       "K2_err": float(f"{max(float((g.float() - r.float()).abs().max())
                                              for g, r in zip(grads, refs)):.3e}")}
                if not case.startswith("d3_long"):
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
