#!/usr/bin/env python3
"""K3 (the flash-attention forward) of two checkouts of the port, timed on one card.

``--root DIR`` times the ``diffulab_tpu_torch`` package under DIR and prints
one JSON line. At the txt2img sampling shape (B=8, S=4224, H=12, D=64, bf16,
q/k/v as views of one packed qkv tensor, chip_smoke.py's fused-CFG text
mask): K3 (``flash_attention``) as wall time per call back to back between
two events and as device time from CUDA-graph replays, and masked SDPA both
ways as the yardstick; K3's device time at 256 to 768 tokens (B=32, no mask);
and the device times of kernels this change should not move: K1 at B=32,
S=256, and K4 with its pre-pass and K5 at the txt2img training shape (B=8,
S=4224, the training mask) from ``torch.profiler``.

With ``--fp32``, the fp32 instance at the sampling shape instead (q/k/v
fp32 views of one packed tensor, the same mask): K3's and masked fp32
SDPA's device times from CUDA-graph replays; then one forward of the
txt2img MMDiT in bf16 with fp32 attention in its dual-stream blocks
(``attention_dtype=float32``, chip_smoke.py's seeded weights) at the
request's fused-CFG batch, ms per forward (one Euler step's model call).

``--ab PARENT`` runs ``--root PARENT``, ``--root`` this checkout, this
checkout again, and PARENT again, each in its own process (the two packages
share a name), and prints the four lines and their medians side by side;
with ``--generate`` it then runs ``scripts/profile_torch_generate.py
--txt2img`` (one txt2img request) of PARENT and of this checkout, and with
``--train`` ``scripts/profile_torch_train.py --txt2img`` (the txt2img train
step). Unpack the parent commit into a directory that git ignores, e.g.
``git archive HEAD~1 | tar -x -C _parent``, then run from the repository root
on the card: ``python3 scripts/ab_flash_attn_fwd.py --ab _parent --generate --train``, or
``python3 scripts/ab_flash_attn_fwd.py --ab _parent --fp32``.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
from ab_flash_attn_bwd import ab_main, fp32_attention_mmdit, kernel_device_ms, text_cond  # noqa: E402
from ab_fused_mha_fwd import graph_ms, wall_ms  # noqa: E402


def measure(root: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from diffulab_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from diffulab_tpu_torch.ops.fused_mha import fused_mha

    assert Path(sys.modules["diffulab_tpu_torch"].__file__).resolve().is_relative_to(root.resolve())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def packed(b, s, h=12, d=64):
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").bfloat16()
        return tuple(t.reshape(b, s, h, d) for t in qkv.chunk(3, dim=-1))

    b, s = 2 * chip_smoke.TXT_BATCH, chip_smoke.TXT_SEQ
    out = {"root": str(root)}
    with torch.no_grad():
        q, k, v = packed(b, s)
        mask = chip_smoke.txt2img_mask(chip_smoke.TXT_BATCH, chip_smoke.TEXT_LENGTHS)
        out["K3_wall_ms"] = wall_ms(lambda: flash_attention(q, k, v, mask), 20)
        out["K3_device_ms"] = graph_ms(lambda: flash_attention(q, k, v, mask), calls=10, replays=5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_mask = mask[:, None, None, :]
        out["sdpa_wall_ms"] = wall_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask), 20)
        out["sdpa_device_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask),
                                         calls=10, replays=5)
        for ss in (256, 384, 512, 640, 768):
            q, k, v = packed(32, ss)
            out[f"K3_device_ms_B32_S{ss}"] = graph_ms(lambda: flash_attention(q, k, v))
        q1, k1, v1 = packed(32, 256)
        out["K1_device_ms_B32_S256"] = graph_ms(lambda: fused_mha(q1, k1, v1))
        q, k, v = packed(chip_smoke.TXT_TRAIN_BATCH, s)
        do = torch.randn(chip_smoke.TXT_TRAIN_BATCH, s, 12, 64, generator=gen, device="cuda").bfloat16()
        tmask = chip_smoke.txt2img_train_mask()
        o, lse = flash_attention(q, k, v, tmask)
        for part, ms in kernel_device_ms(lambda: flash_attention_bwd(q, k, v, tmask, o, lse, do)).items():
            out[f"{part}_device_ms"] = ms
    return out


def measure_fp32(root: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from diffulab_tpu_torch.diffuse.flow import _tree_cat2
    from diffulab_tpu_torch.ops.flash_attention import flash_attention
    from diffulab_tpu_torch.utils import full_fp32_products

    assert Path(sys.modules["diffulab_tpu_torch"].__file__).resolve().is_relative_to(root.resolve())
    full_fp32_products()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, d = 2 * chip_smoke.TXT_BATCH, chip_smoke.TXT_SEQ, 12, 64
    out = {"root": str(root)}
    with torch.no_grad():
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda")
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.chunk(3, dim=-1))
        mask = chip_smoke.txt2img_mask(chip_smoke.TXT_BATCH, chip_smoke.TEXT_LENGTHS)
        out["K3_fp32_device_ms"] = graph_ms(lambda: flash_attention(q, k, v, mask), calls=5, replays=3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        out["sdpa_fp32_device_ms"] = graph_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None, None, :]), calls=5, replays=3)
        del qkv, q, k, v, qt, kt, vt
        model = fp32_attention_mmdit().eval()
        x = torch.randn(b, *chip_smoke.TXT_LATENT, generator=gen, device="cuda")
        t = torch.rand(b, generator=gen, device="cuda")
        cond = _tree_cat2(text_cond(gen, chip_smoke.TXT_BATCH, chip_smoke.TEXT_LENGTHS))
        drop = torch.arange(b, device="cuda") >= chip_smoke.TXT_BATCH
        out["mmdit_fp32_attention_forward_ms"] = wall_ms(lambda: model(x, t, cond, drop), 5)
    return out


def main() -> int:
    return ab_main(__doc__, __file__, measure,
                   {"generate": ("with --ab: the txt2img request profile of both trees",
                                 [["scripts/profile_torch_generate.py", "--txt2img"]]),
                    "train": ("with --ab: the txt2img train profile of both trees",
                              [["scripts/profile_torch_train.py", "--txt2img"]])},
                   fp32_measure=measure_fp32)


if __name__ == "__main__":
    sys.exit(main())
