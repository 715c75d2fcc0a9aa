"""Text-to-image latent diffusion training with multi-aspect-ratio
bucketing (port of examples/train_repa_txt_to_img.py; reference
examples/train_repa_txt_to_img.py:15-117).

Usage (from the repository root):
    python -m diffulab_tpu_torch.examples.train_repa_txt_to_img --config-name train_hard_txt2img_mmdit
    # the trainable byte-level text encoder, trained with the denoiser
    python -m diffulab_tpu_torch.examples.train_repa_txt_to_img --config-name train_hard_txt2img_mmdit \\
        embedder=trainable trainer.train_embedder=true
    # on the CPU, at a toy size
    python -m diffulab_tpu_torch.examples.train_repa_txt_to_img --device cpu model.depth=2 ...

The dataset's shards hold precomputed ``vision_latents`` and captions, with
their precomputed ``caption_embeddings`` where a ``PrecomputedEmbedder``
reads them (``diffulab_tpu_torch.scripts.build_hard_txt2img`` writes such
shards for the ``train_hard_txt2img_*`` configs). The latents are shifted by
the vision tower's ``latent_bias`` and scaled by its ``latent_scale``; the
batches come from :class:`~diffulab_tpu_torch.data.imagenet.MultiARBatchSampler`
(one latent shape a batch) through
:func:`~diffulab_tpu_torch.data.imagenet.collate_fn`. The embedder is built
from the config's ``embedder`` group without the trainer's precision, as
the reference's is; ``trainer.train_embedder`` trains it with the denoiser.
Everything is built on ``--device`` (default ``cuda``) under a torch RNG
seeded with ``--seed``; ``--sweep`` runs one training per combination.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch
import yaml

from diffulab_tpu_torch.config import instantiate, sweep
from diffulab_tpu_torch.config.instantiate import model_dtype_kwargs
from diffulab_tpu_torch.data.imagenet import MultiARBatchSampler, collate_fn
from diffulab_tpu_torch.data.loader import DataLoader
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.examples.train_diffusion import check_ported, count_parameters
from diffulab_tpu_torch.examples.train_repa import _host
from diffulab_tpu_torch.training.losses import build_extra_losses
from diffulab_tpu_torch.training.trainer import BaseTrainer
from diffulab_tpu_torch.utils import full_fp32_products, resolve_device

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-name", default="train_imagenet_repa_txt_to_img")
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
    check_ported(cfg)
    train_dataset = instantiate(cfg["dataset"]["train"])
    val_dataset = instantiate(cfg["dataset"]["val"])

    torch.manual_seed(seed)
    embedder = instantiate(cfg["embedder"], device=device)
    denoiser = instantiate(cfg["model"], context_embedder=embedder, device=device,
                           **model_dtype_kwargs(cfg["trainer"]))
    print(f"Number of trainable parameters: {count_parameters(denoiser):,}")
    extra_losses = build_extra_losses(cfg, seed=seed, device=device)
    vision_tower = instantiate(cfg["vision_tower"], device=device)
    for ds in (train_dataset, val_dataset):
        ds.set_latent_scale(_host(vision_tower.latent_scale))
        ds.set_latent_bias(_host(vision_tower.latent_bias))

    dl_cfg = cfg.get("dataloader", {})
    bs = dl_cfg.get("batch_size", 32)
    prefetch = dl_cfg.get("prefetch", 2)
    train_loader = DataLoader(train_dataset, batch_size=bs, collate_fn=collate_fn, prefetch=prefetch,
                              sampler=MultiARBatchSampler(train_dataset, bs, shuffle=True, drop_last=True, seed=seed))
    val_loader = DataLoader(val_dataset, batch_size=bs, collate_fn=collate_fn, prefetch=prefetch,
                            sampler=MultiARBatchSampler(val_dataset, bs, shuffle=False, drop_last=False))

    diffuser = Diffuser(
        denoiser=denoiser,
        model_type=cfg["diffuser"]["model_type"],
        n_steps=cfg["diffuser"]["n_steps"],
        sampling_method=cfg["diffuser"]["sampling_method"],
        vision_tower=vision_tower,
        extra_args=cfg["diffuser"].get("extra_args", {}),
        extra_losses=extra_losses,
    )
    optimizer = instantiate(cfg["optimizer"])

    trainer_cfg = cfg["trainer"]
    trainer = BaseTrainer(
        n_epoch=trainer_cfg["n_epoch"],
        gradient_accumulation_step=trainer_cfg.get("gradient_accumulation_step", 1),
        precision_type=trainer_cfg.get("precision_type", "no"),
        project_name=trainer_cfg.get("project_name", "diffulab"),
        save_path=trainer_cfg.get("save_path"),
        save_optimizer=trainer_cfg.get("save_optimizer", True),
        use_ema=trainer_cfg.get("use_ema", False),
        ema_rate=trainer_cfg.get("ema_rate", 0.9999),
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
        device=device,
    )
    trainer.train(
        diffuser=diffuser,
        optimizer=optimizer,
        train_dataloader=train_loader,
        val_dataloader=val_loader,
        log_validation_images=trainer_cfg.get("log_validation_images", True),
        val_steps=trainer_cfg.get("val_steps", 50),
        val_step_shift=trainer_cfg.get("val_step_shift"),
        p_classifier_free_guidance=trainer_cfg.get("p_classifier_free_guidance", 0),
        scheduler=instantiate(trainer_cfg["lr_scheduler"]) if trainer_cfg.get("lr_scheduler") else None,
        per_batch_scheduler=trainer_cfg.get("per_batch_scheduler", False),
        train_embedder=trainer_cfg.get("train_embedder", False),
        denoiser_ckpt=trainer_cfg.get("denoiser_ckpt"),
        optimizer_ckpt=trainer_cfg.get("optimizer_ckpt"),
        ema_ckpt=trainer_cfg.get("ema_ckpt"),
        epoch_start=trainer_cfg.get("epoch_start", 0),
        auto_resume=trainer_cfg.get("auto_resume", False),
        seed=seed,
    )
    return trainer


if __name__ == "__main__":
    main()
