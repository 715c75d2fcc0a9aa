"""Standalone sampling CLI: checkpoint -> image grid (+ optional per-image
PNGs) (port of examples/sample.py).

Usage (from the repository root):
    python -m diffulab_tpu_torch.examples.sample \\
        --config-name train_synthetic_flow_matching \\
        --ckpt runs/synthetic_flow_matching/checkpoints/phema_sr0.05 \\
        --n 16 --steps 50 --guidance 1.5 --labels 0,1,2,3 --out samples.png

Samples on ``--device`` (default ``cuda``) from a torch generator seeded
with ``--seed``, with fused CFG when ``--guidance`` > 0. ``--steps`` swaps
the sampling schedule; ``--sampler`` takes the samplers the port has (Euler).
Options whose modules are not ported raise ``NotImplementedError`` naming
their ROADMAP queue 1 item: ``--guide-ckpt``, ``--inpaint-*`` and
``--img2img-image`` (15), ``--prompts`` (16), ``--cache-*`` (7).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from diffulab_tpu_torch.config import compose_config, instantiate
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.training.checkpoint import restore_sampling_model
from diffulab_tpu_torch.training.logging import make_grid
from diffulab_tpu_torch.utils import resolve_device

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"


def _check_ported(args: argparse.Namespace) -> None:
    if args.guide_ckpt:
        raise NotImplementedError("autoguidance (--guide-ckpt) is not ported yet (ROADMAP queue 1, item 15)")
    if args.inpaint_image or args.inpaint_box or args.img2img_image:
        raise NotImplementedError("inpainting and img2img are not ported yet (ROADMAP queue 1, item 15)")
    if args.prompts:
        raise NotImplementedError("--prompts (HF text embedders) is not ported yet (ROADMAP queue 1, item 16)")
    if args.cache_interval or args.cache_span:
        raise NotImplementedError("block caching (--cache-*) is not ported yet (ROADMAP queue 1, item 7)")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-name", default="train_synthetic_flow_matching")
    parser.add_argument("--config-dir", default=str(CONFIG_DIR))
    parser.add_argument("--ckpt", required=True, help="denoiser / ema / phema_sr* checkpoint dir")
    parser.add_argument("--n", type=int, default=16)
    parser.add_argument("--steps", type=int, default=None, help="override sampling steps")
    parser.add_argument("--sampler", default=None, help="override sampling_method")
    parser.add_argument("--guidance", type=float, default=0.0)
    parser.add_argument("--guide-ckpt", default=None, help="autoguidance (not ported)")
    parser.add_argument("--labels", default=None,
                        help="comma-separated class labels, tiled to --n (default: random)")
    parser.add_argument("--image-size", type=int, default=None,
                        help="pixel H=W (default: dataset image_size)")
    parser.add_argument("--prompts", default=None, help="'|'-separated text prompts (not ported)")
    parser.add_argument("--out", default="samples.png")
    parser.add_argument("--inpaint-image", default=None, help="inpainting (not ported)")
    parser.add_argument("--inpaint-box", default=None, help="inpainting (not ported)")
    parser.add_argument("--img2img-image", default=None, help="img2img (not ported)")
    parser.add_argument("--strength", type=float, default=0.6, help="img2img strength (not ported)")
    parser.add_argument("--separate", action="store_true", help="also write per-image PNGs")
    parser.add_argument("--cache-interval", type=int, default=None, help="block caching (not ported)")
    parser.add_argument("--cache-span", type=int, nargs=2, default=None, metavar=("LO", "HI"),
                        help="block caching (not ported)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("overrides", nargs="*")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> dict[str, Any]:
    """Sample and write the grid; returns ``{"images": [N, H, W, C] float in
    [0, 1], "labels", "out", "generate_ms"}`` (the time of the ``generate``
    call alone, the card synchronised)."""
    args = parse_args(argv)
    _check_ported(args)
    device = resolve_device(args.device)
    cfg = compose_config(args.config_dir, args.config_name, args.overrides)
    ds_cfg = cfg["dataset"]["val"]

    torch.manual_seed(args.seed)  # the random init the checkpoint overwrites
    # txt2img configs carry an embedder group: the denoiser is built WITH it,
    # since the checkpoint's `rest` holds the frozen embedder state
    model_kwargs = {}
    if cfg.get("embedder"):
        model_kwargs["context_embedder"] = instantiate(cfg["embedder"], device=device)
    denoiser = instantiate(cfg["model"], device=device, **model_kwargs)
    vision_tower = None
    if cfg.get("vision_tower"):
        vision_tower = instantiate(cfg["vision_tower"], device=device)

    diffuser = Diffuser(
        denoiser=denoiser,
        model_type=cfg["diffuser"]["model_type"],
        n_steps=cfg["diffuser"]["n_steps"],
        sampling_method=args.sampler or cfg["diffuser"]["sampling_method"],
        extra_args=cfg["diffuser"].get("extra_args", {}),
        vision_tower=vision_tower,
    )
    if args.steps:
        diffuser.set_steps(args.steps)

    restore_sampling_model(args.ckpt, denoiser, diffuser.extra_losses, cfg["trainer"])
    denoiser.eval()
    print(f"restored {args.ckpt}")

    size = args.image_size or ds_cfg.get("image_size", 32)
    channels = cfg["model"].get("input_channels", cfg["model"].get("in_channels", 3))
    if vision_tower is not None:
        # the denoiser runs on the latent grid; generate() decodes to pixels
        size //= vision_tower.compression_factor

    cond: dict[str, torch.Tensor] = {}
    labels = None
    n_classes = cfg["model"].get("n_classes")
    if n_classes:
        if args.labels:
            base = [int(v) for v in args.labels.split(",")]
            labels = np.resize(np.asarray(base, np.int64), args.n)
        else:
            labels = np.random.default_rng(args.seed).integers(0, n_classes, args.n)
        cond["y"] = torch.as_tensor(labels, device=device)
        print(f"labels: {labels.tolist()}")

    generator = torch.Generator(device=device).manual_seed(args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = diffuser.generate(
        cond, data_shape=(args.n, size, size, channels), generator=generator,
        guidance_scale=args.guidance, clamp_x=True, device=device,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    generate_ms = (time.perf_counter() - t0) * 1e3
    images = np.clip(out["x"].float().cpu().numpy() * 0.5 + 0.5, 0, 1)
    print(f"generate: {args.n} images in {generate_ms:.1f} ms on {device}")

    from PIL import Image

    grid = (make_grid(images) * 255).astype(np.uint8)
    if grid.shape[-1] == 1:
        grid = grid[..., 0]
    Image.fromarray(grid).save(args.out)
    print(f"wrote {args.out} ({args.n} images)")
    if args.separate:
        stem = Path(args.out)
        for i, img in enumerate(images):
            arr = (img * 255).astype(np.uint8)
            Image.fromarray(arr[..., 0] if arr.shape[-1] == 1 else arr).save(
                stem.with_name(f"{stem.stem}_{i:03d}.png"))
    return {"images": images, "labels": labels, "out": Path(args.out), "generate_ms": generate_ms}


if __name__ == "__main__":
    main()
