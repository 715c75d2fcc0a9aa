"""Offline precompute entry point: vision-tower latents and REPA features
(port of examples/precompute.py).

Usage (from the repository root):
    # add vision_latents to a dataset (a tower of configs/vision_tower/)
    python -m diffulab_tpu_torch.examples.precompute latents --vision-tower dcae \\
        --src data/imagenet_raw/train --dst data/imagenet_latents/train
    # add dst_features (DINO patch features for REPA)
    python -m diffulab_tpu_torch.examples.precompute features --encoder dinov2 \\
        --encoder-args "{dino_model: dinov2_vitl14_reg, resolution: 256}" \\
        --src data/imagenet_latents/train --dst data/imagenet/train
    # add caption_embeddings / caption_mask (an HF text embedder of configs/embedder/)
    python -m diffulab_tpu_torch.examples.precompute captions --embedder qwen \\
        --src data/imagenet_latents/train --dst data/imagenet_captions/train

The source is a sharded dataset (npz or MDS shards) with one ``image*``
column (``captions``: a ``caption`` column); the destination holds every
source column and the new ones. The tower, encoder or embedder is built on
``--device`` (default ``cuda``) under a torch RNG seeded with ``--seed``,
and loads weights only where its config or ``--encoder-args`` name them
(``weights_path``); ``--seed`` also seeds a
stochastic tower's encode (the JAX key ``fold_in(key(seed), batch)``).
``captions`` runs the embedder's language model through ``transformers``
(``networks/embedders/hf_text.py``), from a local checkpoint.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any

import torch
import yaml

from diffulab_tpu_torch.config import instantiate, load_yaml
from diffulab_tpu_torch.utils import full_fp32_products, resolve_device

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=["latents", "features", "captions"])
    parser.add_argument("--src", required=True, help="source sharded dataset dir")
    parser.add_argument("--dst", required=True, help="destination dataset dir")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--vision-tower", default="flux2", help="config group name (latents)")
    parser.add_argument("--encoder", default="dinov2", help="dinov2|dinov3 (features)")
    parser.add_argument("--encoder-args", default="{}", help="yaml dict of encoder kwargs")
    parser.add_argument("--embedder", default="qwen", help="config group name (captions)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def build(args: argparse.Namespace, device: torch.device) -> Any:
    """The tower (``latents``), the REPA encoder (``features``) or the text
    embedder (``captions``) of ``args``."""
    torch.manual_seed(args.seed)
    if args.mode == "latents":
        return instantiate(load_yaml(CONFIG_DIR / "vision_tower" / f"{args.vision_tower}.yaml"), device=device)
    if args.mode == "captions":
        return instantiate(load_yaml(CONFIG_DIR / "embedder" / f"{args.embedder}.yaml"), device=device)
    from diffulab_tpu_torch.training.losses.repa import RepaLoss

    return RepaLoss.encoder_registry[args.encoder](**yaml.safe_load(args.encoder_args), device=device)


def main(argv: list[str] | None = None) -> Path:
    """Write the destination dataset; returns its path."""
    args = parse_args(argv)
    full_fp32_products()
    device = resolve_device(args.device)
    module = build(args, device)
    if args.mode == "latents":
        module.compute_on_dataset(args.src, args.dst, batch_size=args.batch_size, seed=args.seed)
    else:
        module.compute_on_dataset(args.src, args.dst, batch_size=args.batch_size)
    print(f"wrote {args.dst}")
    return Path(args.dst)


if __name__ == "__main__":
    main()
