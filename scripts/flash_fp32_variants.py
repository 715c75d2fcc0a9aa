#!/usr/bin/env python3
"""Tile variants of the fp32 flash forward (K3, ``flash_fwd_tf32x3``) and of
its dk/dv and dq kernels (K4, ``flash_bwd_dkv_tf32x3``; K5,
``flash_bwd_dq_tf32x3``), built side by side and timed on one card.

Each variant is ``flash_attn_fwd.cu`` and ``flash_attn_bwd.cu`` under textual
substitutions of their tile rules, built by ``variant_build.build_variants``
and put in place of the port's own libraries, so that the wrappers
(``flash_attention``, ``flash_attention_bwd``) call them:

- ``kernel``: the sources as they are (at D = 64, K3 eight warps, 128 query
  rows a CTA, and 64-key slots; K4 eight warps, 128 keys a CTA, and 64-query
  slots; K5 eight warps, 128 query rows a CTA, 64-key slots, Q's split
  fragments in registers and dO's split from shared memory every tile);
- ``fwd_keys32``: K3 with 32-key slots;
- ``fwd_warps4``: K3 with four warps, 64 query rows a CTA;
- ``fwd_keys32_warps4``: both (the first build);
- ``fwd_q_smem``: K3 splitting Q's fragments from shared memory every tile
  at D = 64 (the sources keep them in registers up to D = 64);
- ``fwd_minblocks2``: K3 compiled for two CTAs an SM (registers capped at 128);
- ``dkv_queries32``: K4 with 32-query slots;
- ``dkv_warps4``: K4 with four warps, 64 keys a CTA (the first build);
- ``dq_q_smem``: K5 splitting Q's fragments from shared memory every tile,
  as dO's;
- ``dq_do_reg``: K5 holding dO's split fragments in registers too;
- ``dq_keys32``: K5 with 32-key slots;
- ``dq_warps4``: K5 with four warps, 64 query rows a CTA;
- ``carried``: the three kernels with their O, dv, dk and dq sums carried
  through every tile in the tensor cores' accumulator (the sources sum each
  tile from zero and add it in fp32, ``scores_times_tile_fresh``).

At the txt2img slice shapes in fp32 it runs the main-shape checks of
``chip_smoke.py``'s phases 8 and 11 on their own inputs
(``chip_smoke.txt2img_fp32_inputs``, drawn in fp32): K3 with the fused-CFG
text mask at B=8, and K4 (with the port's K5 beside it for dq) with the
training mask at B=8 from K3's o and lse, at S=4224, H=12, D=64. For each
variant it prints ptxas's registers and spills of the D = 64 instances, each
kernel's device ms per call from CUDA-graph replays (K4 with its pre-pass; K5
from that pre-pass's di),
and each output's largest difference from its plain version as a fraction of
the phase's tolerance (above 1: the phase fails on it).

Run from the repository root on the card:
``python3 scripts/flash_fp32_variants.py [variant ...]`` (all by default).
"""

from __future__ import annotations

import json
import sys

from variant_build import build_variants, card

FWD_KEYS = "fwd_f32_keys() {\n  return D <= 64 ? 64 : 32;"
FWD_WARPS = "fwd_f32_warps() {\n  return D <= 64 ? 8 : 4;"
FWD_QREG = "constexpr bool QREG = D <= 64;"
FWD_BOUNDS = "__launch_bounds__(32 * fwd_f32_warps<D>())"
DKV_QUERIES = "dkv_f32_queries() {\n  return D <= 64 ? 64 : 32;"
DKV_WARPS = "dkv_f32_warps() {\n  return D <= 64 ? 8 : 4;"
DQ_KEYS = "dq_f32_keys() {\n  return D <= 64 ? 64 : 32;"
DQ_WARPS = "dq_f32_warps() {\n  return D <= 64 ? 8 : 4;"
DQ_REGS = "constexpr bool QREG = D <= 64, DOREG = false;"
FRESH = "scores_times_tile_fresh<"
FWD, BWD = "flash_attn_fwd.cu", "flash_attn_bwd.cu"
#: variant -> [(file under csrc/, text, its replacement)]
VARIANTS = {
    "kernel": [],
    "fwd_keys32": [(FWD, FWD_KEYS, FWD_KEYS.replace("? 64 :", "? 32 :"))],
    "fwd_warps4": [(FWD, FWD_WARPS, FWD_WARPS.replace("? 8 :", "? 4 :"))],
    "fwd_keys32_warps4": [(FWD, FWD_KEYS, FWD_KEYS.replace("? 64 :", "? 32 :")),
                          (FWD, FWD_WARPS, FWD_WARPS.replace("? 8 :", "? 4 :"))],
    "fwd_q_smem": [(FWD, FWD_QREG, FWD_QREG.replace("64", "32"))],
    "fwd_minblocks2": [(FWD, FWD_BOUNDS, FWD_BOUNDS.replace("())", "(), 2)"))],
    "dkv_queries32": [(BWD, DKV_QUERIES, DKV_QUERIES.replace("? 64 :", "? 32 :"))],
    "dkv_warps4": [(BWD, DKV_WARPS, DKV_WARPS.replace("? 8 :", "? 4 :"))],
    "dq_q_smem": [(BWD, DQ_REGS, "constexpr bool QREG = false, DOREG = false;")],
    "dq_do_reg": [(BWD, DQ_REGS, "constexpr bool QREG = D <= 64, DOREG = D <= 64;")],
    "dq_keys32": [(BWD, DQ_KEYS, DQ_KEYS.replace("? 64 :", "? 32 :"))],
    "dq_warps4": [(BWD, DQ_WARPS, DQ_WARPS.replace("? 8 :", "? 4 :"))],
    "carried": [(FWD, FRESH, "scores_times_tile<"), (BWD, FRESH + "D, QT, CB>", "scores_times_tile<D, QT>"),
                (BWD, FRESH + "D, KT>", "scores_times_tile<D, KT>")],
}


def of_tol(ours, ref, atol, rtol) -> float:
    """max |ours - ref| / (atol + rtol * |ref|): above 1, chip_smoke's check fails."""
    return round(float(((ours - ref).abs() / (atol + rtol * ref.abs())).max()), 3)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_fp32_variants: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    libs = build_variants(VARIANTS, names, ("flash_attn_fwd", "flash_attn_bwd"), "tf32x3<64")
    import chip_smoke
    from diffulab_tpu_torch.ops import _build
    from diffulab_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )
    from diffulab_tpu_torch.utils import full_fp32_products

    full_fp32_products()
    scale = (chip_smoke.TXT["inner_dim"] // chip_smoke.TXT["num_heads"]) ** -0.5
    rows = {name: {} for name in names}

    # phase 8's check: o within TOL["float32"], lse within LSE_TOL
    mask = chip_smoke.txt2img_mask(chip_smoke.TXT_BATCH, chip_smoke.TEXT_LENGTHS)
    q, k, v = chip_smoke.txt2img_fp32_inputs(2 * chip_smoke.TXT_BATCH, chip_smoke.FP32_FWD_SEED)
    ref, ref_lse = flash_attention_reference(q, k, v, mask)
    for name in names:
        _build._loaded["flash_attn_fwd"] = libs[name, "flash_attn_fwd"]
        o, lse = flash_attention(q, k, v, mask)
        ms = chip_smoke.cuda_graph_ms(lambda: flash_attention(q, k, v, mask), calls=10, replays=3)
        rows[name]["K3_fp32"] = {"device_ms": round(ms, 4), "o_of_tol": of_tol(o, ref, *chip_smoke.TOL["float32"]),
                                 "lse_of_tol": of_tol(lse, ref_lse, *chip_smoke.LSE_TOL)}
    del q, k, v, ref, ref_lse

    # phase 11's check: each gradient within BWD_TOL["float32"] * (max|ref| + |ref|), from the port's K3 o and lse
    mask = chip_smoke.txt2img_train_mask()
    q, k, v, do = chip_smoke.txt2img_fp32_inputs(chip_smoke.TXT_TRAIN_BATCH, chip_smoke.FP32_BWD_SEED, with_do=True)
    _build._loaded.pop("flash_attn_fwd", None)
    o, lse = flash_attention(q, k, v, mask)
    refs = flash_attention_bwd_reference(q, k, v, mask, o, lse, do)
    tol = chip_smoke.BWD_TOL["float32"]
    for name in names:
        _build._loaded["flash_attn_bwd"] = libs[name, "flash_attn_bwd"]
        grads = flash_attention_bwd(q, k, v, mask, o, lse, do)
        ms = chip_smoke.cuda_graph_ms(lambda: flash_attention_bwd_dkv(q, k, v, mask, o, lse, do, scale), calls=5,
                                      replays=3)
        _, _, di = flash_attention_bwd_dkv(q, k, v, mask, o, lse, do, scale)
        dq_ms = chip_smoke.cuda_graph_ms(lambda: flash_attention_bwd_dq(q, k, v, mask, lse, di, do, scale), calls=3,
                                         replays=2)
        fractions = {label: round(float(((g - r).abs() / (tol * (r.abs().max() + r.abs()))).max()), 3)
                     for label, g, r in zip(("dq", "dk", "dv"), grads, refs)}
        rows[name]["K4_fp32_with_prepass"] = {"device_ms": round(ms, 4), "dk_of_tol": fractions["dk"],
                                              "dv_of_tol": fractions["dv"]}
        rows[name]["K5_fp32"] = {"device_ms": round(dq_ms, 4), "dq_of_tol": fractions["dq"]}
        del grads, di
    for name, row in rows.items():
        print(name, json.dumps(row))
    print(f"card: {card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
