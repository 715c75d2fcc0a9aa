"""ReFlow entry point: straighten a trained rectified flow for few-step
sampling (port of examples/reflow.py; Liu et al. 2022, arXiv:2209.03003).

Two phases, both on ``--device`` (default ``cuda``):
1. generate N coupled pairs (z, x-hat = ODE-solve(z)) from the checkpoint
   through ``Diffuser.generate`` (:func:`~diffulab_tpu_torch.data.reflow.generate_pairs`);
2. continue training the SAME model on the couplings: the trainer takes the
   stored z from the ``coupled_noise`` batch key, so interpolation runs along
   the pair's own trajectory.

Usage (from the repository root):
    python -m diffulab_tpu_torch.examples.reflow --config-name train_synthetic_flow_matching \\
        --ckpt runs/synthetic_flow_matching/checkpoints/phema_sr0.05 \\
        --n-pairs 8192 --epochs 8 trainer.save_path=runs
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from diffulab_tpu_torch.config import compose_config, instantiate
from diffulab_tpu_torch.config.instantiate import model_dtype_kwargs
from diffulab_tpu_torch.data.loader import DataLoader
from diffulab_tpu_torch.data.reflow import ReflowPairsDataset, generate_pairs
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.training.checkpoint import restore_train_modules
from diffulab_tpu_torch.training.trainer import BaseTrainer
from diffulab_tpu_torch.utils import full_fp32_products, resolve_device

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-name", default="train_synthetic_flow_matching")
    parser.add_argument("--config-dir", default=str(CONFIG_DIR))
    parser.add_argument("--ckpt", required=True, help="trained flow checkpoint (denoiser, ema or phema_sr*)")
    parser.add_argument("--n-pairs", type=int, default=8192)
    parser.add_argument("--val-pairs", type=int, default=512)
    parser.add_argument("--pair-steps", type=int, default=None,
                        help="ODE steps for pair generation (default: config n_steps)")
    parser.add_argument("--pair-guidance", type=float, default=0.0)
    parser.add_argument("--epochs", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=None, help="override optimizer lr")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("overrides", nargs="*")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> BaseTrainer:
    """Generate the pairs and straighten; returns the trainer."""
    args = parse_args(argv)
    full_fp32_products()
    device = resolve_device(args.device)
    cfg = compose_config(args.config_dir, args.config_name, args.overrides)
    if cfg["diffuser"]["model_type"] != "rectified_flow":
        raise SystemExit("reflow straightens flow models")

    torch.manual_seed(args.seed)  # the random init the checkpoint overwrites
    denoiser = instantiate(cfg["model"], device=device, **model_dtype_kwargs(cfg["trainer"]))
    diffuser = Diffuser(
        denoiser=denoiser,
        model_type="rectified_flow",
        n_steps=args.pair_steps or cfg["diffuser"]["n_steps"],
        sampling_method=cfg["diffuser"]["sampling_method"],
        extra_args=cfg["diffuser"].get("extra_args", {}),
    )
    restore_train_modules(args.ckpt, denoiser)
    print(f"restored flow checkpoint from {args.ckpt}")

    # phase 1: couplings ---------------------------------------------------
    ds_cfg = cfg["dataset"]["train"]
    image_size = ds_cfg.get("image_size", 32)
    channels = cfg["model"].get("input_channels", 3)
    n_classes = cfg["model"].get("n_classes")
    total = args.n_pairs + args.val_pairs
    denoiser.eval()
    pairs = generate_pairs(diffuser, total, (image_size, image_size, channels), n_classes=n_classes,
                           batch_size=args.batch_size, guidance_scale=args.pair_guidance, seed=args.seed,
                           device=device)
    print(f"generated {total} coupled pairs")
    labels = pairs.labels
    train_ds = ReflowPairsDataset(pairs.x[: args.n_pairs], pairs.noise[: args.n_pairs],
                                  None if labels is None else labels[: args.n_pairs])
    val_ds = ReflowPairsDataset(pairs.x[args.n_pairs:], pairs.noise[args.n_pairs:],
                                None if labels is None else labels[args.n_pairs:])

    # phase 2: straighten --------------------------------------------------
    trainer_cfg = cfg["trainer"]
    opt_cfg = dict(cfg["optimizer"])
    if args.lr is not None:
        opt_cfg["lr"] = args.lr
    trainer = BaseTrainer(
        n_epoch=args.epochs,
        precision_type=trainer_cfg.get("precision_type", "no"),
        project_name=trainer_cfg.get("project_name", "flow") + "_reflow",
        save_path=trainer_cfg.get("save_path"),
        use_ema=trainer_cfg.get("use_ema", False),
        ema_rate=trainer_cfg.get("ema_rate", 0.999),
        ema_update_every=trainer_cfg.get("ema_update_every", 10),
        run_config=cfg,
        mesh=trainer_cfg.get("mesh"),
        log_every_n_steps=trainer_cfg.get("log_every_n_steps"),
        async_checkpointing=trainer_cfg.get("async_checkpointing", True),
        posthoc_ema=trainer_cfg.get("posthoc_ema", False),
        posthoc_ema_gammas=tuple(trainer_cfg.get("posthoc_ema_gammas", (6.94, 16.97))),
        save_every_n_epochs=trainer_cfg.get("save_every_n_epochs"),
        device=device,
    )
    # CFG drop stays on only for class-conditional reflow
    p_cfg = trainer_cfg.get("p_classifier_free_guidance", 0.1) if n_classes else 0.0
    trainer.train(
        diffuser=diffuser,
        optimizer=instantiate(opt_cfg),
        train_dataloader=DataLoader(train_ds, batch_size=args.batch_size, seed=args.seed),
        val_dataloader=DataLoader(val_ds, batch_size=args.batch_size, shuffle=False),
        log_validation_images=False,
        p_classifier_free_guidance=p_cfg,
        val_steps=trainer_cfg.get("val_steps", 50),
        seed=args.seed,
        auto_resume=trainer_cfg.get("auto_resume", False),
    )
    print("reflow training complete")
    return trainer


if __name__ == "__main__":
    main()
