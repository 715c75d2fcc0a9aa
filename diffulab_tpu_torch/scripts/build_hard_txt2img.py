"""Build the hard latent txt2img benchmark (port of
scripts/build_hard_txt2img.py).

Three phases (``--phase all`` runs them in order):

1. ``tower``: train the shrunk Flux2 KL-VAE (``TOWER_KW``) on the
   compositional scenes (recon MSE + ``kl_weight`` x KL, AdamW, ``logvar``
   clipped to [-30, 20]), measure the per-channel packed-latent mean and std
   over the first 2048 training images, and save the tower directory that
   ``Flux2VAE(flax_ckpt=...)`` restores (encoder, decoder,
   ``latent_scale = 1 / max(std, 1e-4)``, ``latent_bias = mean``);
2. ``shards``: encode the train and validation splits through the frozen
   tower and write ``ShardedDataset`` shards with the ``ImageNetmultiAR``
   columns (``vision_latents``, ``caption``, ``caption_embeddings``,
   ``caption_mask``, ``label``), plus the ``PrecomputedEmbedder``'s null
   embedding (``null_embedding.npy``, ``[EMB_LEN, 512]`` zeros);
3. ``report``: the tower's recon MSE, PSNR and the caption judge on its
   reconstructions of the validation split.

The images themselves are not stored: the splits re-render from the seed
(:class:`~diffulab_tpu_torch.data.synthetic_txt2img.SyntheticCompositionalDataset`),
which is how ``evaluate_txt2img`` gets its reference set. The tower's
reparameterisation noise comes from a ``torch.Generator`` seeded per step
(:func:`tower_step` takes it as an argument), so a trained tower is this
package's own, not the JAX package's bit for bit.

Usage (from the repository root):
    python -m diffulab_tpu_torch.scripts.build_hard_txt2img --phase all --out data/hard_txt2img
    python -m diffulab_tpu_torch.scripts.build_hard_txt2img --device cpu --n-train 64 --n-val 32 --epochs 1 ...
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from diffulab_tpu_torch.data.streaming import ShardedDatasetWriter
from diffulab_tpu_torch.data.synthetic_txt2img import (
    EMB_LEN,
    SyntheticCompositionalDataset,
    caption_consistency,
    caption_embedding_table,
    embed_captions,
)
from diffulab_tpu_torch.networks.vision_towers.flux2 import Flux2VAE, save_tower_checkpoint
from diffulab_tpu_torch.training.trainer import _fold_seed
from diffulab_tpu_torch.utils import full_fp32_products, resolve_device

TOWER_KW = dict(base_channels=32, ch_mult=(1, 2), num_res_blocks=1, latent_channels=8)
EMB_DIM = 512
#: images the latent statistics are measured over
STATS_IMAGES = 2048
#: optax.adamw's defaults (trap T7: torch's AdamW decays by 1e-2)
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def build_tower(seed: int = 0, flax_ckpt: str | Path | None = None, device: str | torch.device | None = None,
                **tower_kw: Any) -> Flux2VAE:
    torch.manual_seed(seed)
    return Flux2VAE(**{**TOWER_KW, **tower_kw}, flax_ckpt=flax_ckpt, device=device)


def to_pm1(images_u8: np.ndarray) -> np.ndarray:
    return images_u8.astype(np.float32) / 127.5 - 1.0


def posterior_shape(image_shape: tuple[int, ...]) -> tuple[int, ...]:
    """The shape of the encoder's posterior mean (before the 2x2 packing) for NHWC images."""
    f = 2 ** (len(TOWER_KW["ch_mult"]) - 1)
    b, h, w = image_shape[:3]
    return (b, h // f, w // f, TOWER_KW["latent_channels"])


def tower_loss(tower: Flux2VAE, x: torch.Tensor, noise: torch.Tensor, kl_weight: float):
    """(loss, mse, kl) of one batch (build_hard_txt2img.py:69-78): the
    posterior sample ``mean + exp(logvar / 2) * noise`` decoded back."""
    mean, logvar = tower.encoder(x).chunk(2, dim=-1)
    logvar = logvar.clamp(-30.0, 20.0)
    z = mean + torch.exp(0.5 * logvar) * noise
    mse = ((tower.decoder(z) - x) ** 2).mean()
    kl = 0.5 * (mean ** 2 + torch.exp(logvar) - 1.0 - logvar).mean()
    return mse + kl_weight * kl, mse, kl


def tower_step(tower: Flux2VAE, optimizer: torch.optim.Optimizer, x: torch.Tensor, noise: torch.Tensor,
               kl_weight: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One AdamW step on the tower with its noise given; returns (mse, kl)."""
    optimizer.zero_grad(set_to_none=True)
    loss, mse, kl = tower_loss(tower, x, noise, kl_weight)
    loss.backward()
    optimizer.step()
    return mse.detach(), kl.detach()


def encode_all(tower: Flux2VAE, images_pm1: np.ndarray, batch: int) -> np.ndarray:
    """The posterior means of ``images_pm1`` (NHWC in [-1, 1]), packed, as fp32 numpy."""
    device = next(tower.parameters()).device
    out = []
    with torch.no_grad():
        for s0 in range(0, len(images_pm1), batch):
            x = torch.as_tensor(images_pm1[s0:s0 + batch], device=device)
            out.append(tower.encode(x).float().cpu().numpy())
    return np.concatenate(out)


def latent_stats(latents: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel (mean, std) of packed latents ``[N, h, w, C]``, each ``[1, 1, 1, C]``."""
    mean = latents.mean(axis=(0, 1, 2)).reshape(1, 1, 1, -1)
    std = latents.std(axis=(0, 1, 2)).reshape(1, 1, 1, -1)
    return mean, std


def train_tower(out: Path, images_u8: np.ndarray, epochs: int, batch: int, lr: float, kl_weight: float,
                seed: int, device: torch.device) -> Flux2VAE:
    tower = build_tower(seed, device=device)
    optimizer = torch.optim.AdamW(tower.parameters(), lr=lr, **ADAMW)
    images = to_pm1(images_u8)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    n = len(images)
    t0 = time.perf_counter()
    it = 0
    mse = kl = torch.zeros(())
    for epoch in range(epochs):
        order = rng.permutation(n)
        for s0 in range(0, n - batch + 1, batch):
            x = torch.as_tensor(images[order[s0:s0 + batch]], device=device)
            gen.manual_seed(_fold_seed(seed, it))
            noise = torch.randn(posterior_shape(x.shape), generator=gen, device=device)
            mse, kl = tower_step(tower, optimizer, x, noise, kl_weight)
            it += 1
        print(f"tower epoch {epoch + 1}/{epochs}: recon_mse={float(mse):.5f} kl={float(kl):.3f} "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)

    tower.eval()
    # the reference's whole batches from 0 up to the first STATS_IMAGES (build_hard_txt2img.py:96-98)
    n_stats = min(n, -(-min(n, STATS_IMAGES) // batch) * batch)
    mean, std = latent_stats(encode_all(tower, images[:n_stats], batch))
    save_tower_checkpoint(out / "tower", tower.encoder.state_dict(), tower.decoder.state_dict(),
                          1.0 / np.maximum(std, 1e-4), mean)
    print(f"tower saved to {out / 'tower'}; latent std range [{std.min():.3f}, {std.max():.3f}]")
    return build_tower(seed, flax_ckpt=out / "tower", device=device)


def tower_report(tower: Flux2VAE, ds: SyntheticCompositionalDataset, batch: int) -> dict[str, Any]:
    """Recon MSE, PSNR ([-1, 1] pixels: peak-to-peak 2) and the judge on the reconstructions."""
    images = to_pm1(ds.images)
    device = next(tower.parameters()).device
    recs = []
    with torch.no_grad():
        for s0 in range(0, len(images), batch):
            x = torch.as_tensor(images[s0:s0 + batch], device=device)
            recs.append(tower.decode(tower.encode(x)).float().cpu().numpy())
    rec = np.concatenate(recs)[: len(images)]
    mse = float(np.mean((rec - images) ** 2))
    psnr = float(10 * np.log10(4.0 / mse))
    acc = caption_consistency(rec, ds.captions)
    print(f"tower gate: recon mse={mse:.5f} psnr={psnr:.1f}dB judge-on-recons={acc}")
    return {"mse": mse, "psnr": psnr, "judge": acc}


def write_shards(out: Path, tower: Flux2VAE, table: np.ndarray, batch: int, n_train: int, n_val: int,
                 image_size: int, seed: int) -> dict[str, int]:
    """The two splits' shards and ``null_embedding.npy``; returns the bytes written by split."""
    sizes = {}
    for split, n, train in (("train", n_train, True), ("val", n_val, False)):
        ds = SyntheticCompositionalDataset(train=train, n_samples=n, image_size=image_size, seed=seed)
        emb, mask = embed_captions(ds.captions, table)
        lat = encode_all(tower, to_pm1(ds.images), batch)
        with ShardedDatasetWriter(out / split, shard_size=2048) as writer:
            for i in range(n):
                writer.write({
                    "vision_latents": lat[i],
                    "caption": ds.captions[i],
                    "caption_embeddings": emb[i],
                    "caption_mask": mask[i],
                    "label": int(ds.labels[i]),
                })
        sizes[split] = sum(f.stat().st_size for f in (out / split).iterdir())
        print(f"wrote {n} {split} samples to {out / split}")
    np.save(out / "null_embedding.npy", np.zeros((EMB_LEN, table.shape[1]), np.float32))
    return sizes


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--phase", choices=("tower", "shards", "report", "all"), default="all")
    p.add_argument("--out", default="data/hard_txt2img")
    p.add_argument("--n-train", type=int, default=10_000)
    p.add_argument("--n-val", type=int, default=2_000)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--kl-weight", type=float, default=1e-5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict[str, Any]:
    """Run the phases; returns the seconds of each, the tower report and the shard bytes."""
    args = parse_args(argv)
    full_fp32_products()
    device = resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    result: dict[str, Any] = {"seconds": {}}
    t0 = time.perf_counter()
    train_ds = SyntheticCompositionalDataset(train=True, n_samples=args.n_train, image_size=args.image_size,
                                             seed=args.seed)
    result["seconds"]["render"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if args.phase in ("tower", "all"):
        tower = train_tower(out, train_ds.images, args.epochs, args.batch, args.lr, args.kl_weight, args.seed,
                            device)
    else:
        tower = build_tower(args.seed, flax_ckpt=out / "tower", device=device)
    tower.eval()
    result["seconds"]["tower"] = time.perf_counter() - t0

    if args.phase in ("report", "tower", "all"):
        t0 = time.perf_counter()
        val_ds = SyntheticCompositionalDataset(train=False, n_samples=min(args.n_val, 512),
                                               image_size=args.image_size, seed=args.seed)
        result["report"] = tower_report(tower, val_ds, args.batch)
        result["seconds"]["report"] = time.perf_counter() - t0

    if args.phase in ("shards", "all"):
        t0 = time.perf_counter()
        table = caption_embedding_table(EMB_DIM)
        result["shard_bytes"] = write_shards(out, tower, table, args.batch, args.n_train, args.n_val,
                                             args.image_size, args.seed)
        result["seconds"]["shards"] = time.perf_counter() - t0
    print(f"build_hard_txt2img: seconds {({k: round(v, 1) for k, v in result['seconds'].items()})}")
    return result


if __name__ == "__main__":
    main()
