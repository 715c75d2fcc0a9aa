"""Supervised diffusion training entry point (port of
examples/train_diffusion.py; reference examples/train_diffusion.py:11-81).

Usage (from the repository root):
    python -m diffulab_tpu_torch.examples.train_diffusion \\
        --config-name train_synthetic_flow_matching trainer.n_epoch=5
    # on the CPU, at a toy size
    python -m diffulab_tpu_torch.examples.train_diffusion --device cpu \\
        --config-name train_synthetic_flow_matching model.depth=2 ...

The config tree is the JAX package's ``configs/``, unedited; its
``_target_`` paths are remapped to the port
(:mod:`diffulab_tpu_torch.config.instantiate`). The model is built on
``--device`` (default ``cuda``) under a torch RNG seeded with ``--seed``.
``trainer.distill_from`` (with ``trainer.distill_guidance``) distils a
frozen teacher restored from a port checkpoint directory (``denoiser``,
``ema`` or ``phema_sr*``) into the student, which warm-starts from the same
weights unless ``trainer.denoiser_ckpt`` is given; ``trainer.augment_p``
turns on non-leaky augmentation (a model with ``augment_dim > 0``). A
``repa:`` section adds the REPA loss with its live frozen encoder
(``fixed_vit``, ``dinov2`` or ``dinov3``;
:func:`~diffulab_tpu_torch.training.losses.build_extra_losses`); REPA on
precomputed features trains through
:mod:`~diffulab_tpu_torch.examples.train_repa`, whose latent shards carry
them. ``trainer.lora_rank`` finetunes LoRA adapters (``trainer.lora_variant``
``lora`` or ``dora``, :mod:`~diffulab_tpu_torch.training.lora`) on the base
weights restored from ``trainer.lora_from``, and trains the adapters alone.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch
import yaml

from diffulab_tpu_torch.config import instantiate, sweep
from diffulab_tpu_torch.config.instantiate import model_dtype_kwargs
from diffulab_tpu_torch.data.loader import DataLoader
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.training.checkpoint import restore_train_modules
from diffulab_tpu_torch.training.lora import apply_lora, count_lora_params
from diffulab_tpu_torch.training.losses import build_extra_losses
from diffulab_tpu_torch.training.trainer import BaseTrainer
from diffulab_tpu_torch.utils import full_fp32_products, resolve_device

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"


def count_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-name", default="train_mnist_flow_matching")
    parser.add_argument("--config-dir", default=str(CONFIG_DIR))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sweep.add_sweep_arg(parser)
    parser.add_argument("overrides", nargs="*", help="dotlist overrides key=value")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> list[BaseTrainer]:
    """Train once per sweep combination; returns the trainers."""
    args = parse_args(argv)
    full_fp32_products()
    device = resolve_device(args.device)
    return sweep.dispatch(args, lambda cfg, seed: run_one(cfg, seed, device))


def run_one(cfg: dict, seed: int, device: torch.device) -> BaseTrainer:
    print(yaml.safe_dump(cfg, sort_keys=False))

    train_dataset = instantiate(cfg["dataset"]["train"])
    val_dataset = instantiate(cfg["dataset"]["val"])

    dl_cfg = cfg.get("dataloader", {})
    train_loader = DataLoader(
        train_dataset,
        batch_size=dl_cfg.get("batch_size", 32),
        shuffle=dl_cfg.get("shuffle", True),
        prefetch=dl_cfg.get("prefetch", 2),
        seed=seed,
    )
    val_loader = DataLoader(
        val_dataset,
        batch_size=dl_cfg.get("batch_size", 32),
        shuffle=False,
        prefetch=dl_cfg.get("prefetch", 2),
    )

    torch.manual_seed(seed)  # the port's counterpart of the reference's rngs=nnx.Rngs(seed)
    denoiser = instantiate(cfg["model"], device=device, **model_dtype_kwargs(cfg["trainer"]))

    # LoRA finetuning: restore the base BEFORE wrapping (the wrapped parameter tree differs), then
    # train the adapters alone
    lora_rank = cfg["trainer"].get("lora_rank")
    if lora_rank:
        base_ckpt = cfg["trainer"].get("lora_from")
        if base_ckpt:
            restore_train_modules(base_ckpt, denoiser)
            print(f"restored LoRA base weights from {base_ckpt}")
        variant = cfg["trainer"].get("lora_variant", "lora")
        n_adapters = apply_lora(denoiser, int(lora_rank), generator=torch.Generator().manual_seed(seed + 1),
                                variant=variant)
        print(f"{variant.upper()}: wrapped {n_adapters} projections at rank {lora_rank} "
              f"({count_lora_params(denoiser):,} adapter params)")

    # guidance distillation: the teacher is a frozen copy restored from a trained
    # checkpoint; the student warm-starts from the same weights unless a denoiser_ckpt is given
    distill_teacher = None
    distill_from = cfg["trainer"].get("distill_from")
    if distill_from:
        distill_teacher = instantiate(cfg["model"], device=device, **model_dtype_kwargs(cfg["trainer"]))
        restore_train_modules(distill_from, distill_teacher)
        print(f"distillation teacher restored from {distill_from}")
        if not cfg["trainer"].get("denoiser_ckpt"):
            restore_train_modules(distill_from, denoiser)
            print("student warm-started from the teacher weights")
    print(f"Number of trainable parameters: {count_parameters(denoiser):,}")

    # a repa: section builds RepaLoss with its live frozen encoder; the formalizations hand it x0
    diffuser = Diffuser(
        denoiser=denoiser,
        model_type=cfg["diffuser"]["model_type"],
        n_steps=cfg["diffuser"]["n_steps"],
        sampling_method=cfg["diffuser"]["sampling_method"],
        extra_args=cfg["diffuser"].get("extra_args", {}),
        extra_losses=build_extra_losses(cfg, seed=seed, device=device),
    )

    optimizer = instantiate(cfg["optimizer"])

    trainer_cfg = cfg["trainer"]
    trainer = BaseTrainer(
        n_epoch=trainer_cfg["n_epoch"],
        gradient_accumulation_step=trainer_cfg.get("gradient_accumulation_step", 1),
        precision_type=trainer_cfg.get("precision_type", "no"),
        project_name=trainer_cfg.get("project_name", "diffulab"),
        save_path=trainer_cfg.get("save_path"),
        use_ema=trainer_cfg.get("use_ema", False),
        ema_rate=trainer_cfg.get("ema_rate", 0.999),
        ema_update_after_step=trainer_cfg.get("ema_update_after_step", 0),
        ema_update_every=trainer_cfg.get("ema_update_every", 10),
        ema_inv_gamma=trainer_cfg.get("ema_inv_gamma", 1.0),
        ema_power=trainer_cfg.get("ema_power", 2.0 / 3.0),
        run_config=cfg,
        compile=trainer_cfg.get("compile", False),
        mesh=trainer_cfg.get("mesh"),
        init_kwargs={"wandb": trainer_cfg.get("wandb", {})},
        log_every_n_steps=trainer_cfg.get("log_every_n_steps"),
        async_checkpointing=trainer_cfg.get("async_checkpointing", True),
        posthoc_ema=trainer_cfg.get("posthoc_ema", False),
        posthoc_ema_gammas=tuple(trainer_cfg.get("posthoc_ema_gammas", (6.94, 16.97))),
        save_every_n_epochs=trainer_cfg.get("save_every_n_epochs"),
        save_optimizer=trainer_cfg.get("save_optimizer", True),
        augment_p=trainer_cfg.get("augment_p", 0.0),
        distill_guidance=trainer_cfg.get("distill_guidance", 0.0),
        device=device,
    )

    scheduler = None
    if trainer_cfg.get("lr_scheduler"):
        scheduler = instantiate(trainer_cfg["lr_scheduler"])

    trainer.train(
        diffuser=diffuser,
        optimizer=optimizer,
        train_dataloader=train_loader,
        val_dataloader=val_loader,
        scheduler=scheduler,
        per_batch_scheduler=trainer_cfg.get("per_batch_scheduler", False),
        train_embedder=trainer_cfg.get("train_embedder", False),
        log_validation_images=trainer_cfg.get("log_validation_images", True),
        p_classifier_free_guidance=trainer_cfg.get("p_classifier_free_guidance", 0.2),
        val_steps=trainer_cfg.get("val_steps", 50),
        val_step_shift=trainer_cfg.get("val_step_shift"),
        denoiser_ckpt=trainer_cfg.get("denoiser_ckpt"),
        optimizer_ckpt=trainer_cfg.get("optimizer_ckpt"),
        ema_ckpt=trainer_cfg.get("ema_ckpt"),
        epoch_start=trainer_cfg.get("epoch_start", 0),
        auto_resume=trainer_cfg.get("auto_resume", False),
        seed=seed,
        lora_only=bool(trainer_cfg.get("lora_rank")),
        distill_teacher=distill_teacher,
    )
    return trainer


if __name__ == "__main__":
    main()
