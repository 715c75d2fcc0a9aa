"""FID evaluation entry point (port of examples/evaluate_fid.py): the last
step of a config's chain, train -> post-hoc EMA -> sample -> FID.

Usage (from the repository root):
    python -m diffulab_tpu_torch.examples.evaluate_fid --config-name train_synthetic_flow_matching \\
        --ckpt runs/synthetic_flow_matching/checkpoints/ema --n-samples 2000 --guidance 1.5

Loads a training config and one or more checkpoints (``denoiser``, ``ema``,
``phema_sr*``; several share one model build and the real-feature cache),
samples with ``Diffuser.generate`` on ``--device`` (default ``cuda``; the
model in fp32, as the reference builds it) and computes FID, KID and
precision/recall/density/coverage in the frozen ViT-S/4 feature space of
:func:`~diffulab_tpu_torch.training.evaluation.frozen_vit_features` (the
JAX package's, drawn from the same RNG stream). Two calibration rows make
the number readable: FID(train, val), the floor, and FID(val, uniform
noise), the ceiling. The real features are cached under ``--cache-dir``
(``data/fid_cache``) by a key over both splits' dataset configs, the
number of validation images, ``--seed`` and ``FEATURE_SPACE_VERSION``, the
reference's key; the port's composed configs equal the JAX package's, so
the key is the same. ``--guidance`` takes comma-separated scales;
``--guide-ckpt`` is autoguidance; ``--cache-interval/--cache-span`` turn on
block caching. Each (checkpoint, scale) prints the one JSON line
``fid_synthetic``. A LoRA run (``trainer.lora_rank``) is evaluated as the
reference does it: the base from ``trainer.lora_from``, the model wrapped,
then each checkpoint's adapters.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from diffulab_tpu_torch.config import compose_config, instantiate
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.training.checkpoint import restore_sampling_model, restore_train_modules
from diffulab_tpu_torch.training.lora import apply_lora
from diffulab_tpu_torch.training.evaluation import (
    FEATURE_SPACE_VERSION,
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
    parser.add_argument("--config-name", default="train_synthetic_flow_matching")
    parser.add_argument("--config-dir", default=str(CONFIG_DIR))
    parser.add_argument("--ckpt", required=True, nargs="+",
                        help="denoiser / ema / phema_sr* checkpoint dir(s), sharing one model build and the "
                             "real-feature cache")
    parser.add_argument("--n-samples", type=int, default=2000)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--steps", type=int, default=None, help="override sampling steps")
    parser.add_argument("--guidance", default=[0.0], type=lambda s: [float(g) for g in s.split(",")],
                        help="CFG scale, or several comma-separated scales (e.g. 0.0,1.5,3.0)")
    parser.add_argument("--guide-ckpt", default=None,
                        help="autoguidance: checkpoint of a degraded sibling replacing the unconditional branch "
                             "(needs --guidance > 0)")
    parser.add_argument("--cache-interval", type=int, default=None,
                        help="Delta-DiT block caching: refresh the cached block span every N denoise steps")
    parser.add_argument("--cache-span", type=int, nargs=2, default=None, metavar=("LO", "HI"),
                        help="block index range [LO, HI) to cache between refreshes")
    parser.add_argument("--cache-dir", default=str(Path("data") / "fid_cache"),
                        help="directory of the real-feature cache")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("overrides", nargs="*")
    return parser.parse_args(argv)


def feature_cache_key(cfg: dict, n_val: int, seed: int) -> str:
    """The real-feature cache's key (evaluate_fid.py:160-166): both splits'
    dataset configs, the number of validation images, the seed and the
    feature space."""
    return hashlib.sha1(repr((sorted(cfg["dataset"]["val"].items()), sorted(cfg["dataset"]["train"].items()),
                              n_val, seed, FEATURE_SPACE_VERSION)).encode()).hexdigest()[:16]


def main(argv: list[str] | None = None) -> dict[str, Any]:
    """Evaluate; returns ``{"floor", "ceiling", "rows": [the JSON line's dict
    and its ``images_per_s`` and ``generate_s``], "cache": path, "cached": bool}``."""
    args = parse_args(argv)
    full_fp32_products()
    device = resolve_device(args.device)
    cfg = compose_config(args.config_dir, args.config_name, args.overrides)

    val_ds = instantiate(cfg["dataset"]["val"])
    train_ds = instantiate(cfg["dataset"]["train"])
    real_val = np.stack([val_ds.preprocess_image(img) for img in val_ds.images])
    real_train = np.stack([train_ds.preprocess_image(img) for img in train_ds.images[: len(real_val)]])

    torch.manual_seed(args.seed)  # the random init the checkpoints overwrite
    denoiser = instantiate(cfg["model"], device=device)
    diffuser = Diffuser(
        denoiser=denoiser,
        model_type=cfg["diffuser"]["model_type"],
        n_steps=cfg["diffuser"]["n_steps"],
        sampling_method=cfg["diffuser"]["sampling_method"],
        extra_args=cfg["diffuser"].get("extra_args", {}),
        extra_losses=build_extra_losses(cfg, seed=args.seed, device=device),
    )
    if args.steps:
        diffuser.set_steps(args.steps)
    if args.cache_interval:
        if args.cache_span is None:
            raise SystemExit("--cache-interval needs --cache-span LO HI")
        diffuser.set_block_cache(args.cache_interval, tuple(args.cache_span))
        print(f"block cache: interval={args.cache_interval} span={args.cache_span}")
    # a LoRA run's entries hold the adapters in params and its base in rest; wrap the model as the training
    # CLI did before restoring them. Its ema / phema entries hold the adapters alone: the base comes from
    # trainer.lora_from, else the FID would be of random base weights
    lora_rank = cfg["trainer"].get("lora_rank")
    if lora_rank:
        base_ckpt = cfg["trainer"].get("lora_from")
        if base_ckpt:
            restore_train_modules(base_ckpt, denoiser)
            print(f"restored LoRA base weights from {base_ckpt}")
        elif any(Path(c).name == "ema" or Path(c).name.startswith("phema") for c in args.ckpt):
            raise SystemExit("--ckpt points at a LoRA run's params-only dir (ema / phema_sr*), which stores only "
                             "adapter params; set trainer.lora_from so the base weights can be restored (evaluating "
                             "without them would score a random model).")
        apply_lora(denoiser, int(lora_rank), generator=torch.Generator().manual_seed(args.seed + 1),
                   variant=cfg["trainer"].get("lora_variant", "lora"))

    guide_denoiser = None
    if args.guide_ckpt:
        if min(args.guidance) <= 0:
            raise SystemExit("--guide-ckpt requires --guidance > 0")
        guide_denoiser = instantiate(cfg["model"], device=device)
        restore_sampling_model(args.guide_ckpt, guide_denoiser, build_extra_losses(cfg, seed=args.seed, device=device),
                               cfg["trainer"], seed=args.seed + 100)
        guide_denoiser.eval()
        print(f"autoguidance: negative branch from {args.guide_ckpt}")

    feature_fn = frozen_vit_features(image_size=real_val.shape[1], device=device)
    cache_path = Path(args.cache_dir) / f"{feature_cache_key(cfg, len(real_val), args.seed)}.npz"
    cached = cache_path.exists()
    if cached:
        with np.load(cache_path) as c:
            val_feats, train_feats, noise_feats = c["val"], c["train"], c["noise"]
        print(f"loaded cached real features ({cache_path})")
    else:
        val_feats = extract_features(real_val, feature_fn, args.batch_size)
        train_feats = extract_features(real_train, feature_fn, args.batch_size)
        noise = np.random.default_rng(args.seed).uniform(-1, 1, real_val.shape).astype(np.float32)
        noise_feats = extract_features(noise, feature_fn, args.batch_size)
        cache_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache_path, val=val_feats, train=train_feats, noise=noise_feats)
    fid_floor = compute_fid(train_feats, val_feats)
    fid_ceiling = compute_fid(val_feats, noise_feats)
    print(f"FID(train, val) floor     = {fid_floor:.3f}")
    print(f"FID(val, uniform noise)   = {fid_ceiling:.3f}")

    n = min(args.n_samples, len(real_val))
    n_classes = int(getattr(val_ds, "n_classes", int(val_ds.labels.max()) + 1))
    labels = np.random.default_rng(args.seed).integers(0, n_classes, size=n).astype(np.int64)

    rows = []
    for ckpt in args.ckpt:
        restore_train_modules(ckpt, denoiser, diffuser.extra_losses, lora=bool(lora_rank))
        denoiser.eval()
        print(f"restored checkpoint from {ckpt}")
        for guidance in args.guidance:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            fake = sample_batches(diffuser, lambda start, bsz: {"y": torch.as_tensor(labels[start:start + bsz],
                                                                                     device=device)},
                                  n, args.batch_size, real_val.shape[1:], args.seed, device,
                                  guidance_scale=guidance, guide_denoiser=guide_denoiser)
            dt = time.perf_counter() - t0
            print(f"sampled {n} images in {dt:.1f}s ({n / dt:.2f} imgs/s)")

            fake_feats = extract_features(fake, feature_fn, args.batch_size)
            ref_feats = val_feats[:n] if n < len(val_feats) else val_feats
            fid = compute_fid(ref_feats, fake_feats)
            pr = compute_precision_recall(ref_feats, fake_feats)
            kid = compute_kid(ref_feats, fake_feats, seed=args.seed)
            tag = f"  [g={guidance:g}]" if len(args.guidance) > 1 else ""
            print(f"FID(val, model samples)   = {fid:.3f}  [{ckpt}]{tag}")
            print("precision/recall (k=3)    = %.3f / %.3f   density/coverage = %.3f / %.3f"
                  % (pr["precision"], pr["recall"], pr["density"], pr["coverage"]))
            print("KID x 1000                = %.3f +- %.3f (unbiased)" % (kid["kid"] * 1e3, kid["kid_std"] * 1e3))
            line = ('{"metric": "fid_synthetic", "value": %.3f, "floor": %.3f, "ceiling": %.3f, '
                    '"precision": %.3f, "recall": %.3f, "density": %.3f, "coverage": %.3f, '
                    '"kid_x1000": %.3f, "guidance": %.3f, "ckpt": "%s"}'
                    % (fid, fid_floor, fid_ceiling, pr["precision"], pr["recall"], pr["density"], pr["coverage"],
                       kid["kid"] * 1e3, guidance, ckpt))
            print(line)
            rows.append({**json.loads(line), "images_per_s": n / dt, "generate_s": dt})
    return {"floor": fid_floor, "ceiling": fid_ceiling, "rows": rows, "cache": cache_path, "cached": cached,
            "feature_fn": feature_fn}


if __name__ == "__main__":
    main()
