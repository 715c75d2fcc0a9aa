#!/usr/bin/env python3
"""Variants of K3 (``csrc/flash_attn_fwd.cu``) built side by side and timed on one card.

Each variant is the kernel's source with a few textual substitutions (each
asserted to apply), built with the port's ``nvcc`` flags into
``diffulab_tpu_torch/_build/variants/`` and called through the same C
interface. For each variant it prints ptxas's registers and spills, then at
the txt2img sampling shape (B=8, S=4224, H=12, D=64, bf16) with chip_smoke.py's
fused-CFG text mask and without a mask, and at small ragged shapes, the
device ms per call from CUDA-graph replays and the largest difference from
``flash_attention_reference``. The timing-only variants compute wrong values
on purpose, to find what the kernel waits on:

- ``kernel``: the kernel as it is;
- ``spans``: clock64 spans of each warpgroup's loop (waiting for the tile,
  the turn, issuing the products, waiting for S, the softmax, waiting for
  P.V and the slot release, rescale and packing), cycles per tile, and the
  prologue and epilogue per CTA, at the txt2img shape;
- ``two_warpgroups``: two consumer warpgroups (128 queries a CTA) at D = 64;
- ``no_turns``: the warpgroups issue their products without taking turns;
- ``exp_stand_in`` (timing only): each exponential replaced by a multiply;
- ``pack_stand_in`` (timing only): p truncated to bf16 by a byte permute;
- ``products_only`` (timing only): no softmax, the scores go straight to P.V.

Run from the repository root on the card: ``python3
scripts/flash_fwd_variants.py [variant ...]`` (all by default).
"""

from __future__ import annotations

import ctypes
import json
import sys

from variant_build import CSRC, build_variants, card

SRC = (CSRC / "flash_attn_fwd.cu").read_text()

SPANS_HEAD = "\n__device__ unsigned long long g_spans[3][12];\n"
SPANS_TAIL = """
extern "C" int read_spans(unsigned long long* out) { return (int)cudaMemcpyFromSymbol(out, g_spans, sizeof(g_spans)); }
extern "C" int reset_spans() { static unsigned long long z[3][12] = {}; return (int)cudaMemcpyToSymbol(g_spans, z, sizeof(z)); }
"""
SPAN_LABELS = ["prologue", "tile wait", "turn", "issue", "wait S", "softmax", "wait PV, release", "rescale, pack",
               "epilogue"]


def _mark(k: int) -> str:
    return f"sp[{k}] += clock64() - t_; t_ = clock64();\n"


SPANS = [
    ("namespace {\n\nconstexpr float LN2", "namespace {\n" + SPANS_HEAD + "\nconstexpr float LN2"),
    ("constexpr int STAGES = S::STAGES, NWG = S::NWG;",
     "constexpr int STAGES = S::STAGES, NWG = S::NWG;\n  long long t_ = clock64(); unsigned long long sp[12] = {};"),
    ("  mbar_wait(bar(0), 0);\n  uint32_t v_last", "  mbar_wait(bar(0), 0);\n  " + _mark(0) + "  uint32_t v_last"),
    ("    const int st = j % STAGES;\n    const uint32_t k_t", "    t_ = clock64();\n    const int st = j % STAGES;\n    const uint32_t k_t"),
    ("    mbar_wait(bar(1 + st), (j / STAGES) & 1);\n    turn();\n    ss_issue",
     "    mbar_wait(bar(1 + st), (j / STAGES) & 1);\n    " + _mark(1) + "    turn();\n    " + _mark(2) + "    ss_issue"),
    ("    pass_turn();\n    if (j > 0) {\n      wgmma_wait<1>();",
     "    pass_turn();\n    " + _mark(3) + "    if (j > 0) {\n      wgmma_wait<1>();"),
    ("    fence_regs(s);\n    float m_new[2];", "    fence_regs(s);\n    " + _mark(4) + "    float m_new[2];"),
    ("    if (j > 0) {\n      wgmma_wait<0>();", "    " + _mark(5) + "    if (j > 0) {\n      wgmma_wait<0>();"),
    ("    if (__any_sync(0xffffffffu, alpha[0] != 1.f", "    " + _mark(6) + "    if (__any_sync(0xffffffffu, alpha[0] != 1.f"),
    ("    v_last = v_t;\n  }", "    v_last = v_t;\n    " + _mark(7) + "  }"),
    ("  named_sync(STORE_BAR + wg, WG);", "  " + _mark(8) + "  sp[9] = 1; sp[10] = n_tiles;\n"
     "  if (lane == 0 && warp == 0) for (int k_ = 0; k_ < 11; ++k_) atomicAdd(&g_spans[wg][k_], sp[k_]);\n"
     "  named_sync(STORE_BAR + wg, WG);"),
    ('extern "C" const char* dl_cuda_error_string', SPANS_TAIL + 'extern "C" const char* dl_cuda_error_string'),
]
STAND_INS = """
__device__ __forceinline__ float exp_stand_in(float x) { return x * 0.5f; }
__device__ __forceinline__ void pack_stand_in(uint32_t (&a)[8][4], const float (&x)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = __byte_perm(__float_as_uint(x[8 * kk + 2 * i]), __float_as_uint(x[8 * kk + 2 * i + 1]), 0x7632);
}
"""
KERNEL_DECL = "template <int D>\n__global__ void __launch_bounds__(FwdSmem"
SOFTMAX = SRC[SRC.index("    float m_new[2];\n    if (full) {"):SRC.index("    float alpha[2];")]

VARIANTS = {
    "kernel": [],
    "spans": SPANS,
    "two_warpgroups": [("return D == 128 ? 2 : 3;", "return 2;")],
    "no_turns": [("named_sync(TURN_BAR + wg, 2 * WG);", ""), ("named_arrive(TURN_BAR + (wg + 1) % NWG, 2 * WG);", "")],
    "exp_stand_in": [(KERNEL_DECL, STAND_INS + KERNEL_DECL), ("s[i] = exp2_approx(", "s[i] = exp_stand_in(")],
    "pack_stand_in": [(KERNEL_DECL, STAND_INS + KERNEL_DECL), ("pack_a<BLOCK_N>(pa, s);", "pack_stand_in(pa, s);")],
    "products_only": [(SOFTMAX, "    float m_new[2] = {m[0], m[1]};\n")],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    libs = {name: lib for (name, _), lib in build_variants(
        {name: [("flash_attn_fwd.cu", old, new) for old, new in VARIANTS[name]] for name in names}, names,
        ("flash_attn_fwd",), "hopper").items()}
    import chip_smoke
    from diffulab_tpu_torch.ops.flash_attention import flash_attention_reference

    gen = torch.Generator(device="cuda").manual_seed(8)

    def case(b, sq, skv, h, d, lengths=None):
        q = torch.randn(b, sq, h, d, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(b, skv, h, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
        mask = None if lengths is None else (torch.arange(skv, device="cuda")[None, :] < torch.tensor(
            lengths, device="cuda")[:, None])
        return q, k, v, mask

    s = chip_smoke.TXT_SEQ
    cases = {"txt2img_mask": (*case(8, s, s, 12, 64)[:3], chip_smoke.txt2img_mask(chip_smoke.TXT_BATCH,
                                                                                 chip_smoke.TEXT_LENGTHS)),
             "txt2img_no_mask": case(8, s, s, 12, 64),
             "D128_1000": case(2, 1000, 1000, 4, 128),
             "mask_130_300": case(2, 130, 300, 4, 64, [300, 131]),
             "dead_row_77_257": case(2, 77, 257, 4, 64, [0, 200])}

    def call(lib, q, k, v, mask, o, lse):
        b, sq, h, d = q.shape
        err = lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), b, sq, k.shape[1], h, d, q.stride(0), q.stride(1),
                                 k.stride(0), k.stride(1), v.stride(0), v.stride(1), ctypes.c_float(d ** -0.5), 1,
                                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    for cname, (q, k, v, mask) in cases.items():
        ref, _ = flash_attention_reference(q, k, v, mask)
        imask = None if mask is None else mask.to(torch.int32).contiguous()
        row = {}
        for name, lib in libs.items():
            o = torch.empty_like(q)
            lse = torch.empty(q.shape[0], q.shape[2], q.shape[1], device="cuda")
            call(lib, q, k, v, imask, o, lse)
            torch.cuda.synchronize()
            err = float((o.float() - ref.float()).abs().max())
            ms = chip_smoke.cuda_graph_ms(lambda: call(lib, q, k, v, imask, o, lse), calls=10, replays=5)
            row[name] = {"device_ms": round(ms, 4), "max_abs_err": float(f"{err:.3e}")}
            if name == "spans" and cname == "txt2img_mask":
                lib.reset_spans()
                call(lib, q, k, v, imask, o, lse)
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * 36)()
                lib.read_spans(buf)
                for w in range(3):
                    spans = list(buf[12 * w:12 * w + 12])
                    if spans[9]:
                        ctas, tiles = spans[9], spans[10] / spans[9]
                        print(f"spans warpgroup {w} (cycles; per tile, prologue and epilogue per CTA): " + json.dumps(
                            {lab: round(spans[i] / ctas / (tiles if 1 <= i <= 7 else 1), 1)
                             for i, lab in enumerate(SPAN_LABELS)}))
        print(cname, json.dumps(row))
    print(f"card: {card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
