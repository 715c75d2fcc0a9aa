#!/usr/bin/env python3
"""Where the time of one DiT-B/2 train step goes in the PyTorch/CUDA port.

Builds the model as chip_smoke.py does (bench.py's DiT-B/2, bf16 whole-model
cast, seeded random weights) and runs the trainer's own step,
``training.trainer.train_step``, at batch 64 on 32x32x4 latents with
logit-normal t, p_cfg 0.1, AdamW (lr 1e-4, weight decay 1e-4) and the EMA at
the trainer's default cadence (every 10 steps). Times steps without the
profiler, then records one step that is not an EMA step under
``torch.profiler`` and prints what profile_torch_generate.py prints for a
request: launches, device busy time against the kernel window, device time
by group and by kernel.

Run on the card from the repository root: ``python3 scripts/profile_torch_train.py``.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCH = 64


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke
    from profile_torch_generate import summarize

    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.networks.nn import make_drop_mask
    from diffulab_tpu_torch.training.ema import EMAConfig, init_ema
    from diffulab_tpu_torch.training.optim import adamw
    from diffulab_tpu_torch.training.trainer import EMA, MultiStepOptimizer, train_step

    model, plain = chip_smoke.build_models()
    del plain
    diffuser = Diffuser(model, "euler", extra_args={"logits_normal": True})
    params = dict(model.named_parameters())
    opt = MultiStepOptimizer(adamw(lr=1e-4, weight_decay=1e-4)(list(params.values())))
    ema = EMA(EMAConfig(update_after_step=0, update_every=10), init_ema(params))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"model_inputs": {"x": torch.randn(BATCH, *chip_smoke.LATENT, generator=gen, device="cuda").bfloat16(),
                              "y": torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")}}
    x0 = batch["model_inputs"]["x"]

    def step(i: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = diffuser.draw_timesteps(gen, BATCH)
        noise = torch.randn(x0.shape, generator=gen, device="cuda", dtype=x0.dtype)
        train_step(diffuser, opt, ema, batch, t, noise, make_drop_mask(gen, 0.1, BATCH), i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for i in range(1, 4):  # warm-up: cuBLAS heuristics, allocator, optimizer state
        step(i)
    plain_ms = [step(i) for i in range(4, 14)]  # steps 4..13 (step 10 updates the EMA)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = step(14)
    print(f"train step: DiT-B/2 bf16 batch {BATCH}, AdamW, EMA every 10 steps; peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    summarize(prof, plain_ms, traced_ms, "step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
