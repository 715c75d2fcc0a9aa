#!/usr/bin/env python3
"""Where the time of one train step goes in the PyTorch/CUDA port.

Builds the model as chip_smoke.py does, with seeded random weights, and runs
the trainer's own step, ``training.trainer.train_step``, with logit-normal
t, p_cfg 0.1 and the EMA at the trainer's default cadence (every 10 steps):
by default bench.py's DiT-B/2 (bf16 whole-model cast) at batch 64 on
32x32x4 latents with AdamW (lr 1e-4, weight decay 1e-4); with ``--txt2img``
the txt2img MMDiT (mixed bf16) at batch 8 on 64x64x128 latents with 128-token
precomputed text embeddings (4224 tokens), shift 4.63 and AdamW at
configs/optimizer/adamw.yaml's values; with ``--c1`` slice C1's model,
built from configs/train_synthetic_flow_matching.yaml through the port's
config layer (the DiT at width 512, depth 10, fp32), at the config's batch
128 of procedural shapes (the dataset and the native batch path of the
training CLI), with the config's AdamW and both post-hoc EMA tracks. Times
steps without the profiler,
then records one step that is not an EMA step under ``torch.profiler`` and
prints what profile_torch_generate.py prints for a request: launches, device
busy time against the kernel window, device time by group and by kernel.

Run on the card from the repository root:
``python3 scripts/profile_torch_train.py [--txt2img | --c1]``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCH = 64


def _dit_step_inputs(chip_smoke, gen):
    """DiT-B/2: (model, diffuser, optimizer factory, batch)."""
    import torch

    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.training.optim import adamw

    model, plain = chip_smoke.build_models()
    del plain
    diffuser = Diffuser(model, "euler", extra_args={"logits_normal": True})
    batch = {"model_inputs": {"x": torch.randn(BATCH, *chip_smoke.LATENT, generator=gen, device="cuda").bfloat16(),
                              "y": torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")}}
    return model, diffuser, adamw(lr=1e-4, weight_decay=1e-4), batch, "DiT-B/2 bf16"


def _txt2img_step_inputs(chip_smoke, gen):
    """The txt2img MMDiT: (model, diffuser, optimizer factory, batch)."""
    import torch

    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.training.optim import adamw

    model, plain, tower, _ = chip_smoke.build_txt2img()
    del plain
    diffuser = Diffuser(model, "euler", vision_tower=tower, extra_args=chip_smoke.TXT_EXTRA)
    b = chip_smoke.TXT_TRAIN_BATCH
    lengths = torch.tensor(chip_smoke.TRAIN_TEXT_LENGTHS, device="cuda")
    context = {"embeddings": torch.randn(b, chip_smoke.TEXT_LEN, chip_smoke.TEXT_DIM, generator=gen, device="cuda"),
               "attn_mask": torch.arange(chip_smoke.TEXT_LEN, device="cuda")[None, :] < lengths[:, None]}
    batch = {"model_inputs": {"x": torch.randn(b, *chip_smoke.TXT_LATENT, generator=gen, device="cuda"),
                              "context": context}}
    return model, diffuser, adamw(**chip_smoke.TXT_ADAMW), batch, "txt2img MMDiT mixed bf16, 4224 tokens"


def _c1_step_inputs(chip_smoke, gen):
    """Slice C1 from its config: (model, diffuser, optimizer factory, batch)."""
    import torch

    from diffulab_tpu_torch.config import compose_config, instantiate
    from diffulab_tpu_torch.config.instantiate import model_dtype_kwargs
    from diffulab_tpu_torch.diffuse import Diffuser

    cfg = compose_config(ROOT / "configs", chip_smoke.C1_CONFIG, ["dataset.train.n_samples=128"])
    torch.manual_seed(0)
    model = instantiate(cfg["model"], device="cuda", **model_dtype_kwargs(cfg["trainer"]))
    diffuser = Diffuser(model, cfg["diffuser"]["sampling_method"], n_steps=cfg["diffuser"]["n_steps"],
                        extra_args=cfg["diffuser"].get("extra_args", {}))
    dataset = instantiate(cfg["dataset"]["train"])
    bsz = cfg["dataloader"]["batch_size"]
    host = dataset.get_batch(list(range(bsz)))
    batch = {"model_inputs": {k: torch.as_tensor(v).to("cuda") for k, v in host["model_inputs"].items()}}
    return model, diffuser, instantiate(cfg["optimizer"]), batch, "C1 train_synthetic_flow_matching DiT fp32"


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = parser.add_mutually_exclusive_group()
    which.add_argument("--txt2img", action="store_true", help="profile the txt2img MMDiT train step")
    which.add_argument("--c1", action="store_true", help="profile slice C1's train step, from its config")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke
    from profile_torch_generate import summarize

    from diffulab_tpu_torch.networks.nn import make_drop_mask
    from diffulab_tpu_torch.training.ema import EMAConfig, init_ema
    from diffulab_tpu_torch.training.posthoc_ema import DEFAULT_GAMMAS, init_tracks
    from diffulab_tpu_torch.training.trainer import EMA, MultiStepOptimizer, PowerEMA, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    build = _txt2img_step_inputs if args.txt2img else _c1_step_inputs if args.c1 else _dit_step_inputs
    model, diffuser, factory, batch, label = build(chip_smoke, gen)
    model.train()
    params = dict(model.named_parameters())
    opt = MultiStepOptimizer(factory(list(params.values())))
    ema = EMA(EMAConfig(update_after_step=0, update_every=10), init_ema(params))
    # the C1 config trains with post-hoc EMA: two power-function tracks updated every step
    phema = PowerEMA(DEFAULT_GAMMAS, tuple(init_tracks(params) for _ in DEFAULT_GAMMAS)) if args.c1 else None
    x0 = batch["model_inputs"]["x"]
    bsz = x0.shape[0]

    def step(i: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = diffuser.draw_timesteps(gen, bsz)
        noise = torch.randn(x0.shape, generator=gen, device="cuda", dtype=x0.dtype)
        train_step(diffuser, opt, ema, batch, t, noise, make_drop_mask(gen, 0.1, bsz), i, phema)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for i in range(1, 4):  # warm-up: cuBLAS heuristics, allocator, optimizer state
        step(i)
    torch.cuda.reset_peak_memory_stats()
    plain_ms = [step(i) for i in range(4, 14)]  # steps 4..13 (step 10 updates the EMA)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = step(14)
    print(f"train step: {label} batch {bsz}, AdamW, EMA every 10 steps{', post-hoc EMA' if phema else ''}; peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    summarize(prof, plain_ms, traced_ms, "step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
