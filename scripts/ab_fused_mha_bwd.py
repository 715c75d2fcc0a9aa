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

``--ab PARENT`` runs ``--root PARENT``, ``--root`` this checkout, this
checkout again, and PARENT again, each in its own process (the two packages
share a name), and prints the four lines and their medians side by side;
with ``--train`` it then runs ``scripts/profile_torch_train.py`` (the
DiT-B/2 train step) of PARENT and of this checkout. Unpack the parent commit
into a directory that git ignores, e.g. ``git archive HEAD~1 | tar -x -C
_parent``, then run from the repository root on the card:
``python3 scripts/ab_fused_mha_bwd.py --ab _parent --train``.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
from ab_flash_attn_bwd import ab_main, kernel_device_ms  # noqa: E402
from ab_fused_mha_fwd import graph_ms, wall_ms  # noqa: E402

#: K2's two kernels by a piece of their names (the bf16 kernels of both trees)
K2_PARTS = {"K2_dq": ("mha_bwd_dq",), "K2_dkv": ("mha_bwd_dkv",)}


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


def main() -> int:
    return ab_main(__doc__, __file__, measure,
                   {"train": ("with --ab: the DiT-B/2 train profile of both trees",
                              ["scripts/profile_torch_train.py"])})


if __name__ == "__main__":
    sys.exit(main())
