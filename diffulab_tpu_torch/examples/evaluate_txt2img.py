"""Quality evaluation of the latent txt2img path (port of
examples/evaluate_txt2img.py).

Scores a caption-conditional latent run (MMDiT / SprintDiT / DDT through
the in-framework tower, ``configs/train_hard_txt2img_*.yaml``) on the
compositional-scenes benchmark:

- FID, KID and precision/recall between the decoded samples and the
  re-rendered validation split, in the frozen ViT-S/4 feature space of
  ``evaluate_fid`` (one ``FEATURE_SPACE_VERSION``);
- caption consistency: the deterministic judge
  (:func:`~diffulab_tpu_torch.data.synthetic_txt2img.caption_consistency`)
  reads colour, count, size, background and shape off each sample and
  checks them against the caption it was generated from;
- calibration rows: FID(train, val), the floor; FID(val, tower recon), the
  tower's own ceiling; and the judge on the tower's reconstructions.

The model is built as the reference builds it (evaluate_txt2img.py:82),
without the trainer's precision, so a request runs in fp32. Its captions
condition it through the fixed ``caption_embedding_table`` and
``embed_captions``; ``diffuser.generate(..., clamp_x=True)`` samples on
``--device`` (default ``cuda``) and decodes through the tower. Several
``--ckpt`` share one model build and one real-feature pass. Each checkpoint
prints the one JSON line ``txt2img``.

Usage (from the repository root):
    python -m diffulab_tpu_torch.examples.evaluate_txt2img --config-name train_hard_txt2img_mmdit \\
        --ckpt runs/hard_txt2img_mmdit/checkpoints/phema_sr0.05 --n-samples 2000 --guidance 1.5
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from diffulab_tpu_torch.config import compose_config, instantiate
from diffulab_tpu_torch.data.synthetic_txt2img import (
    SyntheticCompositionalDataset,
    caption_consistency,
    caption_embedding_table,
    embed_captions,
)
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.training.checkpoint import restore_train_modules
from diffulab_tpu_torch.training.evaluation import (
    compute_fid,
    compute_kid,
    compute_precision_recall,
    extract_features,
    frozen_vit_features,
    sample_batches,
)
from diffulab_tpu_torch.training.losses import build_extra_losses
from diffulab_tpu_torch.utils import full_fp32_products, resolve_device

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-name", default="train_hard_txt2img_mmdit")
    parser.add_argument("--config-dir", default=str(CONFIG_DIR))
    parser.add_argument("--ckpt", required=True, nargs="+")
    parser.add_argument("--n-samples", type=int, default=2000)
    parser.add_argument("--batch-size", type=int, default=100)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--guidance", type=float, default=1.5)
    parser.add_argument("--image-size", type=int, default=64)
    parser.add_argument("--n-val", type=int, default=2000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--skip-floor", action="store_true",
                        help="skip the train-vs-val floor row (saves a render pass)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("overrides", nargs="*")
    return parser.parse_args(argv)


def _pm1(images_u8: np.ndarray) -> np.ndarray:
    return images_u8.astype(np.float32) / 127.5 - 1.0


def main(argv: list[str] | None = None) -> dict[str, Any]:
    """Evaluate; returns ``{"floor", "ceiling", "recon_judge", "rows": [the
    JSON line's dict and its ``images_per_s`` and ``generate_s``]}``."""
    args = parse_args(argv)
    full_fp32_products()
    device = resolve_device(args.device)
    cfg = compose_config(args.config_dir, args.config_name, args.overrides)

    torch.manual_seed(args.seed)  # the random init the checkpoints overwrite
    embedder = instantiate(cfg["embedder"], device=device)
    denoiser = instantiate(cfg["model"], context_embedder=embedder, device=device)
    vision_tower = instantiate(cfg["vision_tower"], device=device)
    diffuser = Diffuser(
        denoiser=denoiser,
        model_type=cfg["diffuser"]["model_type"],
        n_steps=cfg["diffuser"]["n_steps"],
        sampling_method=cfg["diffuser"]["sampling_method"],
        vision_tower=vision_tower,
        extra_args=cfg["diffuser"].get("extra_args", {}),
        extra_losses=build_extra_losses(cfg, seed=args.seed, device=device),
    )
    if args.steps:
        diffuser.set_steps(args.steps)

    # --- real data (the builder's splits, re-rendered from the seed) --------
    n = args.n_samples
    val_ds = SyntheticCompositionalDataset(train=False, n_samples=max(args.n_val, n), image_size=args.image_size,
                                           seed=args.seed)
    real_val = _pm1(val_ds.images)
    feature_fn = frozen_vit_features(image_size=args.image_size, device=device)
    val_feats = extract_features(real_val, feature_fn, args.batch_size)

    floor = None
    if not args.skip_floor:
        train_ds = SyntheticCompositionalDataset(train=True, n_samples=len(real_val), image_size=args.image_size,
                                                 seed=args.seed)
        train_feats = extract_features(_pm1(train_ds.images), feature_fn, args.batch_size)
        floor = compute_fid(train_feats, val_feats)
        print(f"FID(train, val) floor        = {floor:.3f}")

    # --- tower ceiling: encode -> decode the validation images --------------
    recs = []
    with torch.no_grad():
        for s0 in range(0, n, args.batch_size):
            x = torch.as_tensor(real_val[s0:s0 + args.batch_size], device=device)
            recs.append(vision_tower.decode(vision_tower.encode(x)).float().cpu().numpy())
    rec = np.concatenate(recs)[:n]
    rec_feats = extract_features(rec, feature_fn, args.batch_size)
    ceiling = compute_fid(val_feats[:n], rec_feats)
    print(f"FID(val, tower recon) ceiling = {ceiling:.3f}")
    rec_acc = caption_consistency(rec, val_ds.captions[:n])
    print(f"judge on tower recons         = {rec_acc}")

    # --- conditioning: the validation captions through the fixed table ------
    emb, mask = embed_captions(val_ds.captions[:n], caption_embedding_table())
    latent_hw = args.image_size // vision_tower.compression_factor
    data_shape_tail = (latent_hw, latent_hw, vision_tower.latent_channels)

    def captions(start: int, bsz: int) -> dict:
        return {"context": {"embeddings": torch.as_tensor(emb[start:start + bsz], device=device),
                            "attn_mask": torch.as_tensor(mask[start:start + bsz], device=device)}}

    rows = []
    for ckpt in args.ckpt:
        restore_train_modules(ckpt, denoiser, diffuser.extra_losses)
        denoiser.eval()
        print(f"restored checkpoint from {ckpt}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fake = sample_batches(diffuser, captions, n, args.batch_size, data_shape_tail, args.seed, device,
                              guidance_scale=args.guidance)
        dt = time.perf_counter() - t0
        print(f"sampled+decoded {n} images in {dt:.1f}s ({n / dt:.2f} imgs/s)")

        fake_feats = extract_features(fake, feature_fn, args.batch_size)
        fid = compute_fid(val_feats[:n], fake_feats)
        kid = compute_kid(val_feats[:n], fake_feats, seed=args.seed)
        pr = compute_precision_recall(val_feats[:n], fake_feats)
        acc = caption_consistency(fake, val_ds.captions[:n])
        print(f"FID(val, samples)             = {fid:.3f}  [{ckpt}]")
        print(f"KID x1000                     = {kid['kid'] * 1e3:.2f} +- {kid['kid_std'] * 1e3:.2f}")
        print(f"precision/recall              = {pr['precision']:.3f} / {pr['recall']:.3f}")
        print(f"caption consistency           = {acc}")
        line = ('{"metric": "txt2img", "fid": %.3f, "kid_x1000": %.3f, '
                '"precision": %.3f, "recall": %.3f, "acc_color": %.3f, '
                '"acc_count": %.3f, "acc_size": %.3f, "acc_background": %.3f, '
                '"acc_shape": %.3f, "acc_all": %.3f, "ckpt": "%s"}'
                % (fid, kid["kid"] * 1e3, pr["precision"], pr["recall"], acc["color"], acc["count"], acc["size"],
                   acc["background"], acc["shape"], acc["all"], ckpt))
        print(line)
        rows.append({**json.loads(line), "images_per_s": n / dt, "generate_s": dt, "fake": fake})
    return {"floor": floor, "ceiling": ceiling, "recon_judge": rec_acc, "rows": rows}


if __name__ == "__main__":
    main()
