"""Export a trained checkpoint into a self-contained serving artifact (port of
examples/export_sampler.py).

Usage (from the repository root):
    python -m diffulab_tpu_torch.examples.export_sampler --config-name train_synthetic_flow_matching \\
        --ckpt runs/synthetic_flow_matching/checkpoints/ema \\
        --out artifacts/flow --batch-size 16 --guidance 1.5

    >>> from diffulab_tpu_torch.deploy import DeployedSampler
    >>> images = DeployedSampler("artifacts/flow")(seed=0, y=labels)

The model, tower and embedder are built from the config on ``--device``
(default ``cuda``) and the checkpoint restored as the ``sample`` CLI restores
it (``denoiser``, ``ema`` or ``phema_sr*``; a LoRA run onto the base of
``trainer.lora_from``). The artifact (``deploy/export.py``) serves with
``torch``, ``numpy`` and the port's op registrations, on the device type it
was exported on: export on the card to serve on the card. ``--smoke`` loads
the artifact back and runs one batch.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from diffulab_tpu_torch.config import compose_config, instantiate
from diffulab_tpu_torch.deploy import DeployedSampler, TensorSpec, export_generate
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.training.checkpoint import restore_sampling_model
from diffulab_tpu_torch.training.losses import build_extra_losses
from diffulab_tpu_torch.utils import full_fp32_products, resolve_device

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-name", required=True)
    parser.add_argument("--config-dir", default=str(CONFIG_DIR))
    parser.add_argument("--ckpt", required=True, help="denoiser / ema / phema_sr* checkpoint dir")
    parser.add_argument("--out", required=True, help="artifact output directory")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--guidance", type=float, default=0.0)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--image-size", type=int, default=None)
    parser.add_argument("--smoke", action="store_true", help="load the artifact back and run one batch")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("overrides", nargs="*")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Export (and with ``--smoke`` run) the artifact; returns ``{"artifact":
    its directory, "bytes": its size, "smoke": the smoke batch or None}``."""
    args = parse_args(argv)
    full_fp32_products()
    device = resolve_device(args.device)
    cfg = compose_config(args.config_dir, args.config_name, args.overrides)
    ds_cfg = cfg["dataset"]["val"]

    torch.manual_seed(args.seed)  # the random init the checkpoint overwrites
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
        sampling_method=cfg["diffuser"]["sampling_method"],
        extra_args=cfg["diffuser"].get("extra_args", {}),
        extra_losses=build_extra_losses(cfg, seed=args.seed, device=device),
        vision_tower=vision_tower,
    )
    if args.steps:
        diffuser.set_steps(args.steps)

    # checkpoints hold the trainer's modules (denoiser + extra losses); a LoRA run is
    # restored in the training CLI's order
    restore_sampling_model(args.ckpt, denoiser, diffuser.extra_losses, cfg["trainer"], seed=args.seed)
    print(f"restored {args.ckpt}")

    size = args.image_size or ds_cfg.get("image_size", 32)
    channels = cfg["model"].get("input_channels", cfg["model"].get("in_channels", 3))
    if vision_tower is not None:
        size //= vision_tower.compression_factor
        channels = vision_tower.latent_channels
    image_shape = (size, size, channels)

    cond_spec = {}
    if cfg["model"].get("n_classes"):
        cond_spec["y"] = TensorSpec((), torch.int64)

    art = export_generate(diffuser, cond_spec, batch_size=args.batch_size, image_shape=image_shape,
                          out_dir=args.out, guidance_scale=args.guidance)
    total_bytes = sum(p.stat().st_size for p in art.iterdir())
    print(f"exported artifact to {art} ({total_bytes / 1e6:.1f} MB)")

    out = None
    if args.smoke:
        sampler = DeployedSampler(art, device=device)
        kwargs = {}
        if "y" in cond_spec:
            kwargs["y"] = np.zeros((args.batch_size,), np.int64)
        out = sampler(seed=args.seed, **kwargs)
        print(f"smoke sample ok: {out.shape} in [{out.min():.2f}, {out.max():.2f}]")
    return {"artifact": art, "bytes": total_bytes, "smoke": out}


if __name__ == "__main__":
    main()
