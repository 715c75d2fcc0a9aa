#!/usr/bin/env python3
"""K2 (the fused-MHA backward) of two checkouts of the port, timed on one card.

``--root DIR`` times the ``diffulab_tpu_torch`` package under DIR and prints
one JSON line. At the DiT-B/2 training shape (B=64, S=256, H=12, D=64, bf16,
q/k/v as views of one packed qkv tensor, from K1's lse): K2
(``fused_mha_bwd``) as wall time per call back to back between two events and
as device time from CUDA-graph replays, the device time of each of its two
kernels (dq, then dk/dv) from ``torch.profiler``, and SDPA's backward (dq, dk
and dv) as the yardstick, back to back and summed by ``torch.profiler`` (a
CUDA graph cannot capture autograd); then K2's device time at 384, 512, 640
and 768 tokens (B=64), and K1's device time at B=32, S=256 (a kernel this
change should not move).

With ``--fp32``, the fp32 instance at slice C1's shape instead (B=128,
S=256, H=8, D=64, fp32, from K1's lse): the device time of K2 and of SDPA's
fp32 backward (its memory-efficient backward op,
``chip_smoke.sdpa_fp32_backward`` of this checkout for both trees), both from
CUDA-graph replays; beside them K2's two kernels and the SDPA autograd
backward's kernels summed by ``torch.profiler``.

With ``--short``, K2 at the padded short sequences at head dim 64 of
``ab_fused_mha_fwd.SHORT_CASES``, each on the tensors the tree's own fused
route hands the kernel, from that tree's K1's lse: ``<case>`` its device
time from CUDA-graph replays, ``<case>_padded`` the padded instance on the
padded q and do, ``<case>_valid`` (where the tree has them) the instances
built around the valid rows on the unpadded ones, and
``<case>_sdpa_unpadded`` SDPA's backward on the unpadded tensors (fp32: its
memory-efficient backward op from CUDA-graph replays, as with ``--fp32``;
bf16: its autograd backward's kernels summed by ``torch.profiler``).

With ``--unet``, the bf16 K2 at the UNets' attention shapes at B=128
(``ab_fused_mha_fwd.UNET_CASES`` but the request's), on the tensors the
fused route hands it, from that tree's K1's lse: ``<case>`` its device time
from CUDA-graph replays, ``<case>_dq``, ``<case>_dkv`` and ``<case>_fused``
its kernels' from ``torch.profiler`` (the dq and dk/dv kernels, or the one
that forms all three), and ``<case>_sdpa_unpadded`` SDPA's bf16 backward on
the unpadded tensors (its memory-efficient backward op from CUDA-graph
replays, ``chip_smoke.sdpa_fp32_backward`` of this checkout).

With ``--d2``, the fp32 K2 at the MNIST UNet's attention shapes at B=128
(``ab_fused_mha_fwd.D2_CASES`` but the request's), on the tensors the fused
route hands it, fp32 draws, from that tree's K1's lse: ``<case>`` its device
time from CUDA-graph replays, ``<case>_dq``, ``<case>_dkv`` and
``<case>_fused`` its kernels' from ``torch.profiler`` (the split dq and
dk/dv kernels of 8-key tiles, or the staged kernel that forms all three), and
``<case>_sdpa_unpadded`` SDPA's fp32 backward on the unpadded tensors (its
memory-efficient backward op from CUDA-graph replays,
``chip_smoke.sdpa_fp32_backward`` of this checkout).

``--ab PARENT`` runs ``--root PARENT``, ``--root`` this checkout, this
checkout again, and PARENT again, each in its own process (the two packages
share a name), and prints the four lines and their medians side by side;
with ``--train`` it then runs ``scripts/profile_torch_train.py`` (the
DiT-B/2 train step) of PARENT and of this checkout, with ``--c1``
``scripts/profile_torch_train.py --c1`` and ``scripts/profile_torch_generate.py
--c1`` (slice C1's train step and sample request). Unpack the parent commit
into a directory that git ignores, e.g. ``git archive HEAD~1 | tar -x -C
_parent``, then run from the repository root on the card:
``python3 scripts/ab_fused_mha_bwd.py --ab _parent --train``, or for the fp32
instance ``python3 scripts/ab_fused_mha_bwd.py --ab _parent --fp32 --c1``.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
from ab_flash_attn_bwd import ab_main, kernel_device_ms  # noqa: E402
from ab_fused_mha_fwd import graph_ms, wall_ms  # noqa: E402

#: K2's kernels by a piece of their names (both trees' kernels, bf16 and fp32): the dq kernel, then the dk/dv
#: kernel, or the one kernel that forms all three (the staged bf16 K2 where a head's rows are one CTA's)
K2_PARTS = {"K2_dq": ("mha_bwd_dq",), "K2_dkv": ("mha_bwd_dkv",), "K2_fused": ("mha_bwd_fused",)}
#: slice C1's attention shape: the config's batch, 256 tokens, 8 heads of 64
C1_SHAPE = (128, 256, 8, 64)
#: slice C1's train step and sample request profiles
C1_PROFILES = [["scripts/profile_torch_train.py", "--c1"], ["scripts/profile_torch_generate.py", "--c1"]]


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    from diffulab_tpu_torch.ops.fused_mha import fused_mha, fused_mha_bwd

    assert Path(sys.modules["diffulab_tpu_torch"].__file__).resolve().is_relative_to(root.resolve())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def packed(b, s, h=12, d=64):
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").bfloat16()
        return tuple(t.reshape(b, s, h, d) for t in qkv.chunk(3, dim=-1))

    out = {"root": str(root)}
    with torch.no_grad():
        q, k, v = packed(64, 256)
        do = torch.randn(64, 256, 12, 64, generator=gen, device="cuda").bfloat16()
        _, lse = fused_mha(q, k, v)
        out["K2_wall_ms"] = wall_ms(lambda: fused_mha_bwd(q, k, v, None, lse, do), 100)
        out["K2_device_ms"] = graph_ms(lambda: fused_mha_bwd(q, k, v, None, lse, do))
        for part, ms in kernel_device_ms(lambda: fused_mha_bwd(q, k, v, None, lse, do), K2_PARTS).items():
            out[f"{part}_device_ms"] = ms
    with torch.enable_grad():
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        out["sdpa_bwd_wall_ms"] = wall_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot, retain_graph=True), 100)
        out["sdpa_bwd_device_ms"] = kernel_device_ms(  # autograd cannot be captured in a CUDA graph
            lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot, retain_graph=True), {"all": ("",)})["all"]
        del sdpa, qt, kt, vt
    with torch.no_grad():
        for ss in (384, 512, 640, 768):
            q, k, v = packed(64, ss)
            do = torch.randn(64, ss, 12, 64, generator=gen, device="cuda").bfloat16()
            _, lse = fused_mha(q, k, v)
            out[f"K2_device_ms_B64_S{ss}"] = graph_ms(lambda: fused_mha_bwd(q, k, v, None, lse, do), calls=10)
        q, k, v = packed(32, 256)
        out["K1_device_ms_B32_S256"] = graph_ms(lambda: fused_mha(q, k, v))
    return out


def measure_fp32(root: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # this checkout's, before the measured tree's package is on the path

    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    from diffulab_tpu_torch.ops.fused_mha import fused_mha, fused_mha_bwd

    assert Path(sys.modules["diffulab_tpu_torch"].__file__).resolve().is_relative_to(root.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(*C1_SHAPE, generator=gen, device="cuda") for _ in range(4))
    out = {"root": str(root)}
    with torch.no_grad():
        _, lse = fused_mha(q, k, v)
        out["K2_fp32_device_ms"] = graph_ms(lambda: fused_mha_bwd(q, k, v, None, lse, do), calls=10)
        out["sdpa_bwd_fp32_device_ms"] = graph_ms(chip_smoke.sdpa_fp32_backward(q, k, v, do), calls=10)
        parts = kernel_device_ms(lambda: fused_mha_bwd(q, k, v, None, lse, do), K2_PARTS)
        for part, ms in parts.items():
            out[f"{part}_fp32_profiler_ms"] = ms
        out["K2_fp32_profiler_ms"] = sum(parts.values())
    with torch.enable_grad():
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        out["sdpa_autograd_bwd_fp32_profiler_ms"] = kernel_device_ms(
            lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot, retain_graph=True), {"all": ("",)})["all"]
    return out


def measure_short(root: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # this checkout's, before the measured tree's package is on the path

    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F
    from ab_fused_mha_fwd import SHORT_CASES, padded_q, route_tensors, short_inputs

    from diffulab_tpu_torch.ops import fused_mha as fm

    assert Path(sys.modules["diffulab_tpu_torch"].__file__).resolve().is_relative_to(root.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(root)}
    for case in SHORT_CASES:
        q, k, v, do, mask = short_inputs(case, gen)
        with torch.no_grad():
            qr, kp, vp, maskp = route_tensors(q, k, v, mask)
            dor = do if qr.shape[1] == q.shape[1] else padded_q(do, qr.shape[1])
            _, lse = fm.fused_mha(qr, kp, vp, maskp)
            out[case] = graph_ms(lambda: fm.fused_mha_bwd(qr, kp, vp, maskp, lse, dor), calls=10)
            qp, dop = padded_q(q, kp.shape[1]), padded_q(do, kp.shape[1])
            _, lse_p = fm.fused_mha(qp, kp, vp, maskp)
            out[f"{case}_padded"] = graph_ms(lambda: fm.fused_mha_bwd(qp, kp, vp, maskp, lse_p, dop), calls=10)
            if hasattr(fm, "takes_valid_rows"):
                _, lse_v = fm.fused_mha(q, kp, vp, maskp)
                out[f"{case}_valid"] = graph_ms(lambda: fm.fused_mha_bwd(q, kp, vp, maskp, lse_v, do), calls=10)
            if q.dtype == torch.float32:
                out[f"{case}_sdpa_unpadded"] = graph_ms(chip_smoke.sdpa_fp32_backward(q, k, v, do, mask), calls=10)
        if q.dtype != torch.float32:
            with torch.enable_grad():
                leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
                sdpa = F.scaled_dot_product_attention(*leaves, attn_mask=None if mask is None
                                                      else mask[:, None, None, :])
                dot = do.transpose(1, 2)
                out[f"{case}_sdpa_unpadded"] = kernel_device_ms(
                    lambda: torch.autograd.grad(sdpa, leaves, dot, retain_graph=True), {"all": ("",)})["all"]
                del sdpa, leaves
    return out


def measure_unet(root: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # this checkout's, before the measured tree's package is on the path

    sys.path.insert(0, str(root))
    import torch
    from ab_fused_mha_fwd import UNET_CASES, unet_inputs

    from diffulab_tpu_torch.ops.fused_mha import fused_mha, fused_mha_bwd

    assert Path(sys.modules["diffulab_tpu_torch"].__file__).resolve().is_relative_to(root.resolve())
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(root)}
    with torch.no_grad():
        for case, (b, tokens, _, _) in UNET_CASES.items():
            if b != 128:
                continue
            q, k, v, do, mask = unet_inputs(case, gen)
            _, lse = fused_mha(q, k, v, mask)
            out[case] = graph_ms(lambda: fused_mha_bwd(q, k, v, mask, lse, do), calls=10)
            for part, ms in kernel_device_ms(lambda: fused_mha_bwd(q, k, v, mask, lse, do), K2_PARTS).items():
                out[f"{case}_{part.removeprefix('K2_')}"] = ms
            kv = [t[:, :tokens].contiguous() for t in (k, v)]
            out[f"{case}_sdpa_unpadded"] = graph_ms(chip_smoke.sdpa_fp32_backward(q, *kv, do), calls=10)
    return out


def measure_d2(root: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # this checkout's, before the measured tree's package is on the path

    sys.path.insert(0, str(root))
    import torch
    from ab_fused_mha_fwd import D2_CASES, unet_inputs

    from diffulab_tpu_torch.ops.fused_mha import fused_mha, fused_mha_bwd

    assert Path(sys.modules["diffulab_tpu_torch"].__file__).resolve().is_relative_to(root.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(root)}
    with torch.no_grad():
        for case, (b, tokens, _, _) in D2_CASES.items():
            if b != 128:
                continue
            q, k, v, do, mask = unet_inputs(case, gen, D2_CASES, "float32")
            _, lse = fused_mha(q, k, v, mask)
            out[case] = graph_ms(lambda: fused_mha_bwd(q, k, v, mask, lse, do), calls=10)
            for part, ms in kernel_device_ms(lambda: fused_mha_bwd(q, k, v, mask, lse, do), K2_PARTS).items():
                out[f"{case}_{part.removeprefix('K2_')}"] = ms
            kv = [t[:, :tokens].contiguous() for t in (k, v)]
            out[f"{case}_sdpa_unpadded"] = graph_ms(chip_smoke.sdpa_fp32_backward(q, *kv, do), calls=10)
    return out


def main() -> int:
    return ab_main(__doc__, __file__, measure,
                   {"train": ("with --ab: the DiT-B/2 train profile of both trees",
                              [["scripts/profile_torch_train.py"]]),
                    "c1": ("with --ab: slice C1's train and sample profiles of both trees", C1_PROFILES)},
                   fp32_measure=measure_fp32,
                   modes={"short": ("time K2 at the padded short sequences at D = 64 (SHORT_CASES)",
                                    measure_short),
                          "unet": ("time the bf16 K2 at the UNets' attention shapes (UNET_CASES at B=128)",
                                   measure_unet),
                          "d2": ("time the fp32 K2 at the MNIST UNet's attention shapes (D2_CASES at B=128)",
                                 measure_d2)})


if __name__ == "__main__":
    sys.exit(main())
