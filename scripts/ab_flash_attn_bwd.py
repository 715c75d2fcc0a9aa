#!/usr/bin/env python3
"""K4 and K5 (the flash-attention backward) of two checkouts of the port,
timed on one card.

``--root DIR`` times the ``diffulab_tpu_torch`` package under DIR and prints
one JSON line. At the txt2img training shape (B=8, S=4224, H=12, D=64,
bf16, q/k/v as views of one packed qkv tensor, chip_smoke.py's training key
mask): K4 with its pre-pass (``flash_attention_bwd_dkv``), K5
(``flash_attention_bwd_dq``) and both (``flash_attention_bwd``), each as
wall time per call back to back between two events (the kernels run for
milliseconds, so the host's launch time hides behind them); the device time
of each kernel alone (the pre-pass, K4, K5) from ``torch.profiler``; masked
SDPA's backward (dq, dk and dv together) as the yardstick. Then K4+K5 at
B=64 and 256, 384 and 512 tokens without a mask (the dispatch line of
``ops/attention.py``), and K1's device time at B=32, S=256 from CUDA-graph
replays (a kernel this change should not move: it shares the Hopper header).

With ``--fp32``, the fp32 instances at that shape instead (q/k/v fp32 views
of one packed tensor, the plain forward's o and lse): K4 with its pre-pass,
K5 and both, each as device time per call from CUDA-graph replays, beside
SDPA's fp32 masked backward op (``chip_smoke.sdpa_fp32_backward``, dq, dk
and dv together, CUDA-graph replays); then a train step's loss and backward
of the txt2img MMDiT in bf16 with fp32 attention in its dual-stream blocks
(``attention_dtype=float32``, chip_smoke.py's seeded weights, batch 8, the
training text lengths), ms per step.

``--ab PARENT`` runs ``--root PARENT``, ``--root`` this checkout, this
checkout again, and PARENT again, each in its own process (the two packages
share a name), and prints the four lines and their medians side by side;
with ``--train`` it then runs ``scripts/profile_torch_train.py --txt2img``
of PARENT and of this checkout, one after the other, for the ms per step.
Unpack the parent commit into a directory that git ignores, e.g.
``git archive HEAD~1 | tar -x -C _parent``, then run from the repository
root on the card: ``python3 scripts/ab_flash_attn_bwd.py --ab _parent --train``,
or ``python3 scripts/ab_flash_attn_bwd.py --ab _parent --fp32``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
from ab_fused_mha_fwd import graph_ms, wall_ms  # noqa: E402

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, 700 W


#: the flash backward's kernels by a piece of their names: the pre-pass, K4, K5
BWD_PARTS = {"prepass": ("flash_bwd_di", "flash_bwd_prep"), "K4": ("flash_bwd_dkv",), "K5": ("flash_bwd_dq",)}


def kernel_device_ms(fn, parts: dict[str, tuple[str, ...]] = BWD_PARTS, calls: int = 10) -> dict[str, float]:
    """Device ms per call of ``fn``'s kernels, summed by ``parts`` (a part
    takes the kernels whose names hold one of its pieces), from
    ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(parts, 0.0)
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CPU:  # the runtime's launch calls
            continue
        part = next((name for name, pieces in parts.items() if any(p in evt.key for p in pieces)), None)
        if part is not None:
            total_us = getattr(evt, "device_time_total", None)
            if total_us is None:
                total_us = evt.cuda_time_total
            out[part] += total_us / 1e3 / calls
    return out


def measure(root: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from diffulab_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from diffulab_tpu_torch.ops.fused_mha import fused_mha

    assert Path(sys.modules["diffulab_tpu_torch"].__file__).resolve().is_relative_to(root.resolve())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def packed(b, s, h=12, d=64):
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").bfloat16()
        return tuple(t.reshape(b, s, h, d) for t in qkv.chunk(3, dim=-1))

    b, s, h, d = chip_smoke.TXT_TRAIN_BATCH, chip_smoke.TXT_SEQ, 12, 64
    out = {"root": str(root)}
    mask = chip_smoke.txt2img_train_mask()
    with torch.no_grad():
        q, k, v = packed(b, s)
        do = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
        o, lse = flash_attention(q, k, v, mask)
        scale = d ** -0.5
        _, _, di = flash_attention_bwd_dkv(q, k, v, mask, o, lse, do, scale)
        out["K4_with_prepass_ms"] = wall_ms(lambda: flash_attention_bwd_dkv(q, k, v, mask, o, lse, do, scale), 20)
        out["K5_ms"] = wall_ms(lambda: flash_attention_bwd_dq(q, k, v, mask, lse, di, do, scale), 20)
        out["K4_K5_ms"] = wall_ms(lambda: flash_attention_bwd(q, k, v, mask, o, lse, do), 20)
        for part, ms in kernel_device_ms(lambda: flash_attention_bwd(q, k, v, mask, o, lse, do)).items():
            out[f"{part}_device_ms"] = ms
    # the pre-pass's bytes: o and do read once, lse read, the workspace (lse and di) written
    prepass_bytes = 2 * b * s * h * d * 2 + b * h * s * 4 + 2 * b * h * s * 4
    out["prepass_bound_ms"] = prepass_bytes / PEAK_BYTES_PER_S * 1e3
    with torch.enable_grad():
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None, None, :])
        dot = do.transpose(1, 2)
        out["sdpa_bwd_ms"] = wall_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot, retain_graph=True), 20)
        del sdpa, qt, kt, vt
    del q, k, v, do, o, lse, di
    with torch.no_grad():
        for ss in (256, 384, 512):
            q, k, v = packed(64, ss)
            do = torch.randn(64, ss, h, d, generator=gen, device="cuda").bfloat16()
            o, lse = flash_attention(q, k, v)
            out[f"K4_K5_B64_S{ss}_ms"] = wall_ms(lambda: flash_attention_bwd(q, k, v, None, o, lse, do), 50)
        q, k, v = packed(32, 256)
        out["K1_device_ms_B32_S256"] = graph_ms(lambda: fused_mha(q, k, v))
    return out


def fp32_attention_mmdit():
    """The txt2img MMDiT of chip_smoke.py (its seeded weights and null
    embedding), bf16 with fp32 attention in the dual-stream blocks, on the
    card."""
    import numpy as np
    import torch

    import chip_smoke
    from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
    from diffulab_tpu_torch.networks.embedders import PrecomputedEmbedder

    rng = np.random.default_rng(9)
    null = rng.standard_normal((chip_smoke.TEXT_LEN, chip_smoke.TEXT_DIM)).astype(np.float32)
    embedder = PrecomputedEmbedder(null_embedding=null, null_embedding_seq_len=chip_smoke.NULL_SEQ_LEN)
    model = MMDiT(**chip_smoke.TXT, context_embedder=embedder, dtype=torch.bfloat16, attention_dtype=torch.float32)
    chip_smoke.randomize_(model, seed=10)
    return model


def text_cond(gen, batch: int, lengths):
    """A text conditioning of ``batch`` seeded embeddings with ``lengths`` valid tokens."""
    import torch

    import chip_smoke

    emb = torch.randn(batch, chip_smoke.TEXT_LEN, chip_smoke.TEXT_DIM, generator=gen, device="cuda")
    mask = torch.arange(chip_smoke.TEXT_LEN, device="cuda")[None, :] < torch.tensor(lengths, device="cuda")[:, None]
    return {"context": {"embeddings": emb, "attn_mask": mask}}


def measure_fp32(root: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke
    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_reference,
    )
    from diffulab_tpu_torch.utils import full_fp32_products

    assert Path(sys.modules["diffulab_tpu_torch"].__file__).resolve().is_relative_to(root.resolve())
    full_fp32_products()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, d = chip_smoke.TXT_TRAIN_BATCH, chip_smoke.TXT_SEQ, 12, 64
    scale = d ** -0.5
    out = {"root": str(root)}
    mask = chip_smoke.txt2img_train_mask()
    with torch.no_grad():
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda")
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.chunk(3, dim=-1))
        do = torch.randn(b, s, h, d, generator=gen, device="cuda")
        o, lse = flash_attention_reference(q, k, v, mask)
        _, _, di = flash_attention_bwd_dkv(q, k, v, mask, o, lse, do, scale)
        out["K4_fp32_with_prepass_device_ms"] = graph_ms(
            lambda: flash_attention_bwd_dkv(q, k, v, mask, o, lse, do, scale), calls=3, replays=2)
        out["K5_fp32_device_ms"] = graph_ms(lambda: flash_attention_bwd_dq(q, k, v, mask, lse, di, do, scale),
                                            calls=3, replays=2)
        out["K4_K5_fp32_device_ms"] = graph_ms(lambda: flash_attention_bwd(q, k, v, mask, o, lse, do), calls=3,
                                               replays=2)
        out["sdpa_bwd_fp32_device_ms"] = graph_ms(chip_smoke.sdpa_fp32_backward(q, k, v, do, mask), calls=3,
                                                  replays=2)
        del qkv, q, k, v, do, o, lse, di
    # a train step's loss and backward of the MMDiT with fp32 attention
    model = fp32_attention_mmdit().train()
    diffuser = Diffuser(model, "euler", extra_args=chip_smoke.TXT_EXTRA)
    x0 = torch.randn(b, *chip_smoke.TXT_LATENT, generator=gen, device="cuda")
    cond = text_cond(gen, b, chip_smoke.TRAIN_TEXT_LENGTHS)
    t = diffuser.draw_timesteps(gen, b)
    noise = torch.randn(x0.shape, generator=gen, device="cuda")
    drop = torch.zeros(b, dtype=torch.bool, device="cuda")
    drop[list(chip_smoke.TRAIN_DROPPED)] = True

    def step():
        model.zero_grad(set_to_none=True)
        diffuser.compute_loss(x0, cond, t, noise, drop=drop)["loss"].backward()

    out["mmdit_fp32_attention_loss_backward_ms"] = wall_ms(step, 3)
    return out


def ab_main(doc: str, script: str, measure, profiles: dict[str, tuple[str, list[list[str]]]],
            fp32_measure=None, modes: dict | None = None) -> int:
    """The command line the A/B scripts share: ``--root DIR`` prints one JSON
    line of ``measure(DIR)`` (``fp32_measure(DIR)`` with ``--fp32``, where the
    script has one; ``fn(DIR)`` with ``--<flag>`` for each of ``modes``, flag
    -> (help, fn)); ``--ab PARENT`` runs ``--root PARENT``, this checkout
    twice and PARENT again, each in its own process, prints the four lines and
    their medians, and then, for each flag of ``profiles`` given (flag ->
    (help, profile commands)), the profile commands in PARENT and in this
    checkout."""
    modes = dict(modes or {})
    if fp32_measure is not None:
        modes = {"fp32": ("time the fp32 instances (the docstring's shapes)", fp32_measure), **modes}
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--root", type=Path, help="time the package under this directory")
    group.add_argument("--ab", type=Path, metavar="PARENT", help="parent, change, change, parent")
    if modes:  # argparse cannot print the usage of an empty group
        mode_group = parser.add_mutually_exclusive_group()
        for flag, (help_text, _) in modes.items():
            mode_group.add_argument(f"--{flag}", action="store_true", help=help_text)
    for flag, (help_text, _) in profiles.items():
        parser.add_argument(f"--{flag}", action="store_true", help=help_text)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print(f"{Path(script).stem}: no CUDA device", file=sys.stderr)
        return 2
    mode = next((flag for flag in modes if getattr(args, flag)), None)
    if args.root is not None:
        print(json.dumps((modes[mode][1] if mode else measure)(args.root)))
        return 0
    runs = []
    for root in (args.ab, ROOT, ROOT, args.ab):
        done = subprocess.run([sys.executable, script, "--root", str(root), *([f"--{mode}"] if mode else [])],
                              capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout, done.stderr, file=sys.stderr)
            return done.returncode
        runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    for key in runs[0]:
        if key == "root" or key not in runs[1]:
            continue
        parent = statistics.median([runs[0][key], runs[3][key]])
        change = statistics.median([runs[1][key], runs[2][key]])
        ratio = f"x{parent / change:.2f}" if change else "the change has none"
        print(f"{key}: parent {runs[0][key]:.4f} / {runs[3][key]:.4f}, change {runs[1][key]:.4f} / "
              f"{runs[2][key]:.4f} (medians {parent:.4f} -> {change:.4f}, {ratio})")
    for flag, (_, commands) in profiles.items():
        if not getattr(args, flag):
            continue
        for command in commands:
            for label, root in (("parent", args.ab.resolve()), ("change", ROOT)):
                done = subprocess.run([sys.executable, str(root / command[0]), *command[1:]],
                                      capture_output=True, text=True, cwd=root)
                if done.returncode != 0:
                    print(done.stdout, done.stderr, file=sys.stderr)
                    return done.returncode
                print(f"--- {' '.join(command)}, {label} ({root}):")
                print(done.stdout.strip())
    return 0


def main() -> int:
    return ab_main(__doc__, __file__, measure,
                   {"train": ("with --ab: the txt2img train profile of both trees",
                              [["scripts/profile_torch_train.py", "--txt2img"]])},
                   fp32_measure=measure_fp32)


if __name__ == "__main__":
    sys.exit(main())
