#!/usr/bin/env python3
"""K1 (the fused-MHA forward) of two checkouts of the port, timed on one card.

``--root DIR`` times the ``diffulab_tpu_torch`` package under DIR and prints
one JSON line: K1's device time per call from CUDA-graph replays at the
DiT-B/2 shapes (B=32 sampling and B=64 training, S=256, H=12, D=64, bf16,
q/k/v as views of one packed qkv tensor) and at 384 and 512 tokens (B=32),
its wall time per call back to back, and the wrapper's host time per call
at a one-head shape whose kernel takes a few microseconds.

With ``--fp32``, the fp32 instance at slice C1's shapes instead (B=128, the
train step's, and B=32, the sample request's; S=256, H=8, D=64, fp32): K1's
and fp32 SDPA's device times from CUDA-graph replays.

With ``--short``, K1 at the padded short sequences of the DiTs at head dim
64 (:data:`SHORT_CASES`: slice F1's deep path, G1's train step and request,
the hard pair's 264 and 72 tokens, the trainable embedder's 64 byte tokens
under a caption mask), each on the tensors the tree's own fused route hands
the kernel (``ops/attention.py::_fused_path``, recorded through the tree's
``fused_mha``): ``<case>`` its device time from CUDA-graph replays;
``<case>_padded`` the padded instance on the padded q; where the tree has
them, ``<case>_valid`` the instance built around the valid rows on the
unpadded q; ``<case>_sdpa_unpadded`` SDPA on the unpadded tensors (with the
case's key mask), the yardstick.

With ``--unet``, the bf16 K1 at the UNets' attention shapes (:data:`UNET_CASES`:
D1's head dims 192 at 64 tokens and 384 at 16, D2's 256 and 512, B=128, H=2,
and D1's CFG request at B=32), on the tensors the fused route hands the
kernel there (the unpadded q, k and v padded to 128 keys with the padding
mask): ``<case>`` its device time from CUDA-graph replays and
``<case>_sdpa_unpadded`` bf16 SDPA's on the unpadded tensors, the yardstick.

With ``--d2``, the fp32 K1 at the MNIST UNet's attention shapes
(:data:`D2_CASES`: head dims 256 at 64 tokens and 512 at 16, B=128, H=2, and
the 16-image request's B=16), on the tensors the fused route hands it (the
unpadded q, k and v padded to 128 keys with the padding mask), fp32 draws:
``<case>`` its device time from CUDA-graph replays and
``<case>_sdpa_unpadded`` fp32 SDPA's on the unpadded tensors.

``--ab PARENT`` runs ``--root PARENT``, ``--root`` this checkout, this
checkout again, and PARENT again, each in its own process (the two packages
share a name), and prints the four lines and their medians side by side;
with ``--c1`` it then runs ``scripts/profile_torch_train.py --c1`` and
``scripts/profile_torch_generate.py --c1`` of PARENT and of this checkout.
Unpack the parent commit into a directory that git ignores, e.g.
``git archive HEAD~1 | tar -x -C _parent``, then run from the repository
root on the card: ``python3 scripts/ab_fused_mha_fwd.py --ab _parent``, or
``python3 scripts/ab_fused_mha_fwd.py --ab _parent --fp32`` (or ``--d2``).
"""

from __future__ import annotations

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


def measure_fp32(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    from diffulab_tpu_torch.ops.fused_mha import fused_mha

    assert Path(sys.modules["diffulab_tpu_torch"].__file__).resolve().is_relative_to(root.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(root)}
    with torch.no_grad():
        for b in (128, 32):
            q, k, v = (torch.randn(b, 256, 8, 64, generator=gen, device="cuda") for _ in range(3))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            out[f"K1_fp32_device_ms_B{b}"] = graph_ms(lambda: fused_mha(q, k, v))
            out[f"sdpa_fp32_device_ms_B{b}"] = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    return out


#: the padded short sequences at head dim 64: tag -> (B, tokens, H, dtype, key mask): None for the route's
#: padding mask, "caption" for a byte-token mask of seeded lengths 8 to the tokens (the trainable embedder's),
#: "joint8" for 8 caption keys of seeded lengths 1-8 before the image keys (evaluate_txt2img's request under CFG)
SHORT_CASES = {
    "f1_sprint_deep_fp32_B128": (128, 64, 8, "float32", None),
    "h1_embedder_fp32_B64": (64, 64, 4, "float32", "caption"),
    "g1_request_fp32_B32": (32, 64, 12, "float32", None),
    "g1_train_bf16_B128": (128, 64, 12, "bfloat16", None),
    "hard_train_264_bf16_B64": (64, 264, 6, "bfloat16", None),
    "hard_request_264_bf16_B32": (32, 264, 6, "bfloat16", None),
    "hard_train_72_bf16_B64": (64, 72, 6, "bfloat16", None),
    "h1_eval_264_fp32_B200": (200, 264, 6, "float32", "joint8"),
}


def short_inputs(case: str, gen):
    """q, k, v, do [B, tokens, H, 64] in the case's dtype and its key mask over the tokens (or None)."""
    import torch

    b, tokens, h, dtype, kind = SHORT_CASES[case]
    q, k, v, do = (torch.randn(b, tokens, h, 64, generator=gen, device="cuda").to(getattr(torch, dtype))
                   for _ in range(4))
    mask = None
    keys = torch.arange(tokens, device="cuda")[None]
    if kind == "caption":
        mask = keys < torch.randint(8, tokens + 1, (b, 1), generator=gen, device="cuda")
    elif kind == "joint8":
        mask = (keys < torch.randint(1, 9, (b, 1), generator=gen, device="cuda")) | (keys >= 8)
    return q, k, v, do, mask


def route_tensors(q, k, v, mask):
    """(q, k, v, mask) as the loaded tree's fused route hands them to ``fused_mha``."""
    import diffulab_tpu_torch.ops.attention as attention

    seen = []
    real = attention.fused_mha

    def record(*args):
        seen.append(args[:4])
        return real(*args)

    attention.fused_mha = record
    try:
        attention.dot_product_attention(q, k, v, mask, impl="fused")
    finally:
        attention.fused_mha = real
    return seen[0]


def padded_q(t, rows: int):
    import torch.nn.functional as F

    return F.pad(t, (0, 0, 0, 0, 0, rows - t.shape[1]))


def measure_short(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    from diffulab_tpu_torch.ops import fused_mha as fm

    assert Path(sys.modules["diffulab_tpu_torch"].__file__).resolve().is_relative_to(root.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(root)}
    with torch.no_grad():
        for case in SHORT_CASES:
            q, k, v, _, mask = short_inputs(case, gen)
            qr, kp, vp, maskp = route_tensors(q, k, v, mask)
            out[case] = graph_ms(lambda: fm.fused_mha(qr, kp, vp, maskp))
            qp = padded_q(q, kp.shape[1])
            out[f"{case}_padded"] = graph_ms(lambda: fm.fused_mha(qp, kp, vp, maskp))
            if hasattr(fm, "takes_valid_rows"):
                out[f"{case}_valid"] = graph_ms(lambda: fm.fused_mha(q, kp, vp, maskp))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            attn_mask = None if mask is None else mask[:, None, None, :]
            out[f"{case}_sdpa_unpadded"] = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                                           attn_mask=attn_mask))
    return out


#: the bf16 UNets' attention shapes: tag -> (B, tokens, H, D), keys padded to 128 with the padding mask
UNET_CASES = {
    "d1_192_B128": (128, 64, 2, 192),
    "d1_384_B128": (128, 16, 2, 384),
    "d2_256_B128": (128, 64, 2, 256),
    "d2_512_B128": (128, 16, 2, 512),
    "d1_request_192_B32": (32, 64, 2, 192),
    "d1_request_384_B32": (32, 16, 2, 384),
}


#: the fp32 MNIST UNet's attention shapes: tag -> (B, tokens, H, D), keys padded to 128 with the padding mask
D2_CASES = {
    "d2_256_B128": (128, 64, 2, 256),
    "d2_512_B128": (128, 16, 2, 512),
    "d2_request_256_B16": (16, 64, 2, 256),
    "d2_request_512_B16": (16, 16, 2, 512),
}


def unet_inputs(case: str, gen, cases: dict | None = None, dtype: str = "bfloat16"):
    """q, do [B, tokens, H, D], k, v [B, 128, H, D] in ``dtype`` (drawn in it) and the padding mask [B, 128]
    of a case of ``cases`` (:data:`UNET_CASES` by default)."""
    import torch

    b, tokens, h, d = (cases or UNET_CASES)[case]
    q, do = (torch.randn(b, tokens, h, d, generator=gen, device="cuda").to(getattr(torch, dtype)) for _ in range(2))
    k, v = (torch.randn(b, 128, h, d, generator=gen, device="cuda").to(getattr(torch, dtype)) for _ in range(2))
    mask = (torch.arange(128, device="cuda") < tokens)[None].expand(b, -1).contiguous()
    return q, k, v, do, mask


def measure_unet(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    from diffulab_tpu_torch.ops.fused_mha import fused_mha

    assert Path(sys.modules["diffulab_tpu_torch"].__file__).resolve().is_relative_to(root.resolve())
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(root)}
    with torch.no_grad():
        for case, (_, tokens, _, _) in UNET_CASES.items():
            q, k, v, _, mask = unet_inputs(case, gen)
            out[case] = graph_ms(lambda: fused_mha(q, k, v, mask))
            qt, kt, vt = (t[:, :tokens].transpose(1, 2) for t in (q, k, v))
            out[f"{case}_sdpa_unpadded"] = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    return out


def measure_d2(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    from diffulab_tpu_torch.ops.fused_mha import fused_mha

    assert Path(sys.modules["diffulab_tpu_torch"].__file__).resolve().is_relative_to(root.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(root)}
    with torch.no_grad():
        for case, (_, tokens, _, _) in D2_CASES.items():
            q, k, v, _, mask = unet_inputs(case, gen, D2_CASES, "float32")
            out[case] = graph_ms(lambda: fused_mha(q, k, v, mask))
            qt, kt, vt = (t[:, :tokens].transpose(1, 2) for t in (q, k, v))
            out[f"{case}_sdpa_unpadded"] = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    return out


def main() -> int:
    from ab_flash_attn_bwd import ab_main
    from ab_fused_mha_bwd import C1_PROFILES

    return ab_main(__doc__, __file__, measure,
                   {"c1": ("with --ab: slice C1's train and sample profiles of both trees", C1_PROFILES)},
                   fp32_measure=measure_fp32,
                   modes={"short": ("time K1 at the padded short sequences at D = 64 (SHORT_CASES)",
                                    measure_short),
                          "unet": ("time the bf16 K1 at the UNets' attention shapes (UNET_CASES)", measure_unet),
                          "d2": ("time the fp32 K1 at the MNIST UNet's attention shapes (D2_CASES)", measure_d2)})


if __name__ == "__main__":
    sys.exit(main())
