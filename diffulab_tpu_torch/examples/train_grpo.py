"""GRPO post-training entry point (port of examples/train_grpo.py).

Usage (from the repository root):
    python -m diffulab_tpu_torch.examples.train_grpo --config-name train_grpo_alignment \\
        reward.version=7b grpo.n_image_per_prompt=16
    # offline runs (no VLM weights): the brighter-image-wins judge, or a constant stub
    python -m diffulab_tpu_torch.examples.train_grpo --luma-judge ...
    python -m diffulab_tpu_torch.examples.train_grpo --device cpu --stub-judge model.depth=2 ...

Prompts come from a dataset that yields captions and their precomputed
caption embeddings (``ImageNetmultiAR`` shards, batched by
:class:`~diffulab_tpu_torch.data.imagenet.MultiARBatchSampler`; the
composed ``train_grpo_alignment`` reads ``imagenet_repa``, whose
``ImageNetLatentREPA`` yields no captions, and is refused, as the
reference's is: runs override the dataset to ``ImageNetmultiAR``). The
images are sampled in groups with the Euler-Maruyama sampler, the judge
scores pairwise preferences on the host, and the clipped-ratio objective
updates the denoiser (:class:`~diffulab_tpu_torch.training.grpo_trainer.GRPOTrainer`).
The VLM judge needs ``transformers`` and local UnifiedReward weights; without
them a run that asks for it fails. Everything is built on ``--device``
(default ``cuda``) under a torch RNG seeded with ``--seed``; ``--sweep``
runs one training per combination.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Iterator

import torch
import yaml

from diffulab_tpu_torch.config import instantiate, sweep
from diffulab_tpu_torch.config.instantiate import model_dtype_kwargs
from diffulab_tpu_torch.data.imagenet import MultiARBatchSampler, collate_fn
from diffulab_tpu_torch.data.loader import DataLoader
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.examples.train_repa import _host
from diffulab_tpu_torch.networks.rewards.grpo import LumaJudge
from diffulab_tpu_torch.training.grpo_trainer import GRPOTrainer
from diffulab_tpu_torch.parallel.mesh import initialize_distributed
from diffulab_tpu_torch.utils import full_fp32_products, resolve_device

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"

#: the stub judge's reply: the Alignment Score block preferring image 1, which exercises the whole
#: parse -> win-rate -> z-score path without VLM weights
STUB_REPLY = ("Alignment Score:\nImage 1: 0.6\nImage 2: 0.4\n"
              "Coherence Score:\nImage 1: 0.6\nImage 2: 0.4\n"
              "Style Score:\nImage 1: 0.6\nImage 2: 0.4")


def stub_judge(queries) -> list[str]:
    return [STUB_REPLY for _ in queries]


def _prompt_batches(loader) -> Iterator[dict[str, Any]]:
    """Adapt latent-dataset batches to the GRPO contract: the captions move
    to ``extra['captions']`` and ``x`` is dropped (GRPO samples from noise)."""
    for batch in loader:
        mi = dict(batch["model_inputs"])
        captions = mi.pop("initial_context", None)
        mi.pop("x", None)
        extra = dict(batch.get("extra", {}))
        if captions is not None:
            extra["captions"] = list(captions)
        yield {"model_inputs": mi, "extra": extra}


class PromptLoader:
    """Re-iterable view over the adapted batches (the trainer iterates the
    train loader once an epoch and peeks at its first batch up front)."""

    def __init__(self, loader):
        self.loader = loader

    def __iter__(self) -> Iterator[dict[str, Any]]:
        return _prompt_batches(self.loader)

    def set_process_slice(self, index: int, count: int) -> None:
        self.loader.set_process_slice(index, count)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-name", default="train_grpo_alignment")
    parser.add_argument("--config-dir", default=str(CONFIG_DIR))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--stub-judge", action="store_true",
                        help="replace the VLM judge with a deterministic stub (offline smoke runs)")
    parser.add_argument("--luma-judge", action="store_true",
                        help="deterministic brighter-image-wins judge: a real preference the policy can learn "
                             "(val/judge_score tracks mean luma per epoch)")
    sweep.add_sweep_arg(parser)
    parser.add_argument("overrides", nargs="*", help="dotlist overrides key=value")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> list[GRPOTrainer]:
    """Train once per sweep combination; returns the trainers."""
    args = parse_args(argv)
    full_fp32_products()
    device = resolve_device(initialize_distributed(args.device))
    return sweep.dispatch(args, lambda cfg, seed: run_one(cfg, seed, device, args))


def run_one(cfg: dict, seed: int, device: torch.device, args: argparse.Namespace) -> GRPOTrainer:
    print(yaml.safe_dump(cfg, sort_keys=False))
    train_dataset = instantiate(cfg["dataset"]["train"])
    val_dataset = instantiate(cfg["dataset"]["val"])

    torch.manual_seed(seed)
    embedder = instantiate(cfg["embedder"], device=device)
    denoiser = instantiate(cfg["model"], context_embedder=embedder, device=device,
                           **model_dtype_kwargs(cfg["trainer"]))
    vision_tower = instantiate(cfg["vision_tower"], device=device)
    for ds in (train_dataset, val_dataset):
        ds.set_latent_scale(_host(vision_tower.latent_scale))
        if hasattr(ds, "set_latent_bias"):
            ds.set_latent_bias(_host(vision_tower.latent_bias))

    reward_cfg = dict(cfg["reward"])
    if args.luma_judge:
        reward_cfg["judge"] = LumaJudge()
    elif args.stub_judge:
        reward_cfg["judge"] = stub_judge
    reward_model = instantiate(reward_cfg)

    dl_cfg = cfg.get("dataloader", {})
    bs = dl_cfg.get("batch_size", 8)
    mk = dict(batch_size=bs, collate_fn=collate_fn)
    if type(train_dataset).__name__ == "ImageNetmultiAR":
        train_loader = DataLoader(train_dataset, sampler=MultiARBatchSampler(
            train_dataset, bs, shuffle=True, drop_last=True, seed=seed), **mk)
        val_loader = DataLoader(val_dataset, sampler=MultiARBatchSampler(
            val_dataset, bs, shuffle=False, drop_last=False), **mk)
    else:
        train_loader = DataLoader(train_dataset, shuffle=True, seed=seed, drop_last=True, **mk)
        val_loader = DataLoader(val_dataset, shuffle=False, **mk)

    diffuser = Diffuser(
        denoiser=denoiser,
        model_type=cfg["diffuser"]["model_type"],
        n_steps=cfg["diffuser"]["n_steps"],
        sampling_method=cfg["diffuser"]["sampling_method"],
        vision_tower=vision_tower,
        extra_args=cfg["diffuser"].get("extra_args", {}),
    )
    optimizer = instantiate(cfg["optimizer"])

    trainer_cfg = cfg["trainer"]
    grpo_cfg = cfg.get("grpo", {})
    trainer = GRPOTrainer(
        n_epoch=trainer_cfg["n_epoch"],
        gradient_accumulation_step=trainer_cfg.get("gradient_accumulation_step", 1),
        precision_type=trainer_cfg.get("precision_type", "no"),
        project_name=trainer_cfg.get("project_name", "grpo_alignment"),
        save_path=trainer_cfg.get("save_path"),
        save_optimizer=trainer_cfg.get("save_optimizer", True),
        use_ema=trainer_cfg.get("use_ema", True),
        ema_rate=trainer_cfg.get("ema_rate", 0.9999),
        ema_update_after_step=trainer_cfg.get("ema_update_after_step", 0),
        ema_update_every=trainer_cfg.get("ema_update_every", 1),
        ema_inv_gamma=trainer_cfg.get("ema_inv_gamma", 1.0),
        ema_power=trainer_cfg.get("ema_power", 2.0 / 3.0),
        run_config=cfg,
        mesh=trainer_cfg.get("mesh"),
        init_kwargs={"wandb": trainer_cfg.get("wandb", {})},
        async_checkpointing=trainer_cfg.get("async_checkpointing", True),
        timestep_fraction=grpo_cfg.get("timestep_fraction", 0.6),
        kl_beta=grpo_cfg.get("kl_beta", 0.0),
        eps=grpo_cfg.get("eps", 0.1),
        mini_batch_size=grpo_cfg.get("mini_batch_size"),
        offload_trajectories=grpo_cfg.get("offload_trajectories", True),
        trust_region=grpo_cfg.get("trust_region", 0.3),
        trust_region_backoff=grpo_cfg.get("trust_region_backoff", 0.5),
        device=device,
    )
    trainer.train(
        diffuser=diffuser,
        reward_model=reward_model,
        optimizer=optimizer,
        train_dataloader=PromptLoader(train_loader),
        val_dataloader=PromptLoader(val_loader),
        log_validation_images=trainer_cfg.get("log_validation_images", True),
        n_image_per_prompt=grpo_cfg.get("n_image_per_prompt", 16),
        guidance_scale=grpo_cfg.get("guidance_scale", 4.0),
        image_resolution=tuple(grpo_cfg.get("image_resolution", (512, 512))),
        seed=seed,
    )
    return trainer


if __name__ == "__main__":
    main()
