"""Standalone sampling CLI: checkpoint -> image grid (+ optional per-image
PNGs) (port of examples/sample.py).

Usage (from the repository root):
    python -m diffulab_tpu_torch.examples.sample \\
        --config-name train_synthetic_flow_matching \\
        --ckpt runs/synthetic_flow_matching/checkpoints/phema_sr0.05 \\
        --n 16 --steps 50 --guidance 1.5 --labels 0,1,2,3 --out samples.png

Samples on ``--device`` (default ``cuda``) from a torch generator seeded
with ``--seed``, with fused CFG when ``--guidance`` > 0. ``--steps`` swaps
the sampling schedule and ``--sampler`` the sampler (euler, euler_maruyama,
heun, dpmpp_2m, unipc; heun, euler, dpmpp_2m, unipc for EDM configs);
``--cache-interval N --cache-span LO HI`` turns on Delta-DiT block caching;
``--guide-ckpt`` replaces the unconditional branch by a degraded checkpoint
(autoguidance, needs ``--guidance`` > 0); ``--inpaint-image`` with
``--inpaint-box y0:y1,x0:x1`` regenerates that box and keeps the rest;
``--img2img-image`` with ``--strength`` edits an image (SDEdit). A REPA
config's checkpoint is restored with its extra losses, built as the training
CLI builds them (the Perceiver resampler of a precomputed-feature config
among them). A config with a ``vision_tower`` samples latents of
``--image-size`` over the tower's compression (the dataset's ``image_size``
where it has one, else 32 as in the reference) and decodes them. A model that takes channel-concatenated context (more input
than output channels, ``train_synthetic_colorize``) is conditioned on the
``x_context`` of the first ``--n`` images of the config's validation set, as
the trainer's validation images are. A LoRA run's checkpoint
(``trainer.lora_rank``) restores onto the base of ``trainer.lora_from``.
``--prompts 'a|b|...'`` conditions a text-to-image config on those prompts,
tiled to ``--n``: its HF text embedder (``configs/embedder/qwen.yaml``,
``networks/embedders/hf_text.py``) embeds them on the host, caching the ""
null embedding that the CFG half swaps in.
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
from diffulab_tpu_torch.training.losses import build_extra_losses
from diffulab_tpu_torch.utils import full_fp32_products, resolve_device

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"


def _load_image(path: str, px: int, channels: int) -> np.ndarray:
    """A PNG resized to px x px, in [-1, 1], HWC."""
    from PIL import Image

    img = Image.open(path).convert("RGB" if channels >= 3 else "L").resize((px, px))
    arr = np.asarray(img, np.float32) / 127.5 - 1.0
    return arr[..., None] if arr.ndim == 2 else arr


def _encode(vision_tower: Any, pixels: np.ndarray, device: torch.device) -> torch.Tensor:
    return vision_tower.encode(torch.as_tensor(np.ascontiguousarray(pixels), device=device))


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-name", default="train_synthetic_flow_matching")
    parser.add_argument("--config-dir", default=str(CONFIG_DIR))
    parser.add_argument("--ckpt", required=True, help="denoiser / ema / phema_sr* checkpoint dir")
    parser.add_argument("--n", type=int, default=16)
    parser.add_argument("--steps", type=int, default=None, help="override sampling steps")
    parser.add_argument("--sampler", default=None, help="override sampling_method")
    parser.add_argument("--guidance", type=float, default=0.0)
    parser.add_argument("--guide-ckpt", default=None,
                        help="autoguidance: checkpoint of a degraded sibling model replacing the "
                             "unconditional branch (needs --guidance > 0)")
    parser.add_argument("--labels", default=None,
                        help="comma-separated class labels, tiled to --n (default: random)")
    parser.add_argument("--image-size", type=int, default=None,
                        help="pixel H=W (default: dataset image_size)")
    parser.add_argument("--prompts", default=None, help="'|'-separated text prompts (HF text-embedder configs)")
    parser.add_argument("--out", default="samples.png")
    parser.add_argument("--inpaint-image", default=None, help="PNG whose content is kept outside --inpaint-box")
    parser.add_argument("--inpaint-box", default=None, help="'y0:y1,x0:x1' pixel region to REGENERATE")
    parser.add_argument("--img2img-image", default=None,
                        help="PNG to edit (SDEdit): noised to --strength and denoised")
    parser.add_argument("--strength", type=float, default=0.6,
                        help="img2img noise strength in (0, 1]: fraction of the schedule run")
    parser.add_argument("--separate", action="store_true", help="also write per-image PNGs")
    parser.add_argument("--cache-interval", type=int, default=None,
                        help="Delta-DiT block caching: refresh the cached block span every N denoise steps")
    parser.add_argument("--cache-span", type=int, nargs=2, default=None, metavar=("LO", "HI"),
                        help="block index range [LO, HI) to cache between refreshes")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("overrides", nargs="*")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> dict[str, Any]:
    """Sample and write the grid; returns ``{"images": [N, H, W, C] float in
    [0, 1], "labels", "out", "generate_ms", "inpaint"}`` (the time of the
    ``generate`` call alone, the card synchronised; ``inpaint`` the known
    pixels and keep-mask, or None)."""
    args = parse_args(argv)
    full_fp32_products()
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
        extra_losses=build_extra_losses(cfg, seed=args.seed, device=device),
        vision_tower=vision_tower,
    )
    if args.steps:
        diffuser.set_steps(args.steps)
    if args.cache_interval:
        if args.cache_span is None:
            raise SystemExit("--cache-interval needs --cache-span LO HI")
        diffuser.set_block_cache(args.cache_interval, tuple(args.cache_span))

    # a LoRA run is restored in the training CLI's order: base, wrap, adapters
    restore_sampling_model(args.ckpt, denoiser, diffuser.extra_losses, cfg["trainer"], seed=args.seed)
    denoiser.eval()
    print(f"restored {args.ckpt}")

    guide_denoiser = None
    if args.guide_ckpt:
        if args.guidance <= 0:
            raise SystemExit("--guide-ckpt requires --guidance > 0")
        guide_denoiser = instantiate(cfg["model"], device=device, **model_kwargs)
        restore_sampling_model(args.guide_ckpt, guide_denoiser, build_extra_losses(cfg, seed=args.seed, device=device),
                               cfg["trainer"], seed=args.seed + 100)
        guide_denoiser.eval()
        print(f"autoguidance: negative branch from {args.guide_ckpt}")

    size = args.image_size or ds_cfg.get("image_size", 32)
    channels = cfg["model"].get("input_channels", cfg["model"].get("in_channels", 3))
    if vision_tower is not None:
        # the denoiser runs on the latent grid; generate() decodes to pixels
        size //= vision_tower.compression_factor

    cond: dict[str, Any] = {}
    if args.prompts:
        embedder = getattr(denoiser, "context_embedder", None)
        if not hasattr(embedder, "embed_host"):
            raise SystemExit("--prompts requires an HF text embedder (an embedder group with embed_host); "
                             "precomputed-embedding configs sample through a dataset that carries the cached "
                             "caption embeddings.")
        texts = args.prompts.split("|")
        texts = (texts * ((args.n + len(texts) - 1) // len(texts)))[:args.n]
        # embed_host caches the CFG null embedding on its first call
        cond["context"] = {k: torch.as_tensor(v, device=device) for k, v in embedder.embed_host(texts).items()}
        print(f"prompts: {texts}")
    out_channels = cfg["model"].get("output_channels", cfg["model"].get("out_channels")) or channels
    if out_channels < channels:  # the rest are x_context channels, concatenated by the denoiser
        context = instantiate(ds_cfg).get_batch(range(args.n))["model_inputs"].get("x_context")
        if context is None:
            raise SystemExit(f"the model takes {channels - out_channels} context channels; the config's "
                             "validation set gives no x_context")
        cond["x_context"] = torch.as_tensor(context, device=device)
        channels = out_channels
        print(f"conditioned on the x_context of the first {args.n} validation images")
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

    px = args.image_size or ds_cfg.get("image_size", 32)
    inpaint = None
    if args.inpaint_image:
        if not args.inpaint_box:
            raise SystemExit("--inpaint-image requires --inpaint-box y0:y1,x0:x1")
        known_px = np.broadcast_to(_load_image(args.inpaint_image, px, channels), (args.n, px, px, channels))
        ys, xs = args.inpaint_box.split(",")
        y0, y1 = (int(v) for v in ys.split(":"))
        x0, x1 = (int(v) for v in xs.split(":"))
        mask_px = np.ones((args.n, px, px, 1), np.float32)  # 1 = keep known
        mask_px[:, y0:y1, x0:x1, :] = 0.0
        if vision_tower is not None:
            # the reverse process runs on latents: encode the known image and pool the
            # keep-mask onto the latent grid (a latent is kept only when its whole field is)
            f = vision_tower.compression_factor
            mask = mask_px.reshape(args.n, px // f, f, px // f, f, 1).min(axis=(2, 4))
            inpaint = {"known": _encode(vision_tower, known_px, device), "mask": mask}
        else:
            inpaint = {"known": np.ascontiguousarray(known_px), "mask": mask_px}
        print(f"inpainting {args.inpaint_image}, regenerating [{y0}:{y1}, {x0}:{x1}]")

    img2img = None
    if args.img2img_image:
        init = np.broadcast_to(_load_image(args.img2img_image, px, channels), (args.n, px, px, channels))
        init = _encode(vision_tower, init, device) if vision_tower is not None else np.ascontiguousarray(init)
        img2img = {"init": init, "strength": args.strength}
        print(f"img2img from {args.img2img_image} at strength {args.strength}")

    generator = torch.Generator(device=device).manual_seed(args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = diffuser.generate(
        cond, data_shape=(args.n, size, size, channels), generator=generator,
        guidance_scale=args.guidance, clamp_x=True, device=device,
        inpaint=inpaint, img2img=img2img, guide_denoiser=guide_denoiser,
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
    return {"images": images, "labels": labels, "out": Path(args.out), "generate_ms": generate_ms,
            "inpaint": inpaint if vision_tower is None else None}


if __name__ == "__main__":
    main()
