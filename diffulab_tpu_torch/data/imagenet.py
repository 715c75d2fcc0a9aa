"""Caption-conditioned latent dataset with aspect-ratio bucketing (port of
diffulab_tpu/data/imagenet.py; reference src/diffulab/datasets/imagenet.py:89-236).

:class:`ImageNetmultiAR` streams precomputed ``vision_latents`` (NHWC), the
caption and, where the shards carry them, precomputed ``caption_embeddings``
and ``caption_mask`` (the ``context`` a ``PrecomputedEmbedder`` reads) from a
:class:`~diffulab_tpu_torch.data.streaming.ShardedDataset`.
:class:`MultiARBatchSampler` yields same-bucket index batches, so every batch
is shape-uniform, and :func:`collate_fn` stacks them (captions stay a list).
A batch is ``[collate_fn([ds[i] for i in idx]) for idx in sampler]``, or
:class:`~diffulab_tpu_torch.data.loader.DataLoader` with ``sampler=`` and
``collate_fn=`` for the threaded prefetch.

Not ported yet: ``ImageNetLatentREPA`` (class-conditional latents with REPA
features) waits for REPA's precomputed half (ROADMAP queue 1, item 13b).
"""

from __future__ import annotations

import hashlib
import logging
import math
import pickle
from pathlib import Path
from typing import Any, Iterator

import numpy as np

from diffulab_tpu_torch.data.base import BatchData
from diffulab_tpu_torch.data.streaming import ShardedDataset

logger = logging.getLogger(__name__)


def _to_float_image(image: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float [0,1] (torchvision ToTensor analog, kept NHWC)."""
    image = np.asarray(image)
    if image.dtype == np.uint8:
        return image.astype(np.float32) / 255.0
    return image.astype(np.float32)


def _per_sample(value):
    """Latent scale/bias as a per-SAMPLE broadcastable array: towers hand
    back per-channel stats shaped [1, 1, 1, C] (batch layout); squeezing
    keeps them broadcasting against the [H, W, C] latents a dataset item
    holds (a leading batch-1 dim would survive collation as [B, 1, H, W, C])."""
    if value is None or np.isscalar(value):
        return value
    return np.squeeze(np.asarray(value, np.float32))


class ImageNetmultiAR:
    """Caption-conditional latents with aspect-ratio bucketing
    (reference imagenet.py:89-174)."""

    def __init__(self, data_path: str, split: str | None = None, batch_size: int = 64,
                 cache_dir: str | Path | None = None) -> None:
        del batch_size  # parity arg; batching is the sampler's job here
        self.latent_scale: float | None = None
        self.latent_bias: float = 0.0
        path = Path(data_path) if split is None else Path(data_path) / split
        self.dataset = ShardedDataset(path)

        cache_dir = Path(cache_dir) if cache_dir else Path.home() / ".cache" / "diffulab_tpu_torch"
        cache_dir.mkdir(parents=True, exist_ok=True)
        # the cache key includes the dataset path, so different datasets never collide
        path_tag = hashlib.sha1(str(path.resolve()).encode()).hexdigest()[:10]
        cache_file = cache_dir / f"buckets_cache_{path_tag}_{split or 'all'}.pickle"
        if cache_file.exists():
            logger.info("Loading buckets from cache...")
            with open(cache_file, "rb") as f:
                self.buckets: dict[tuple[int, int], list[int]] = pickle.load(f)
        else:
            logger.info("No buckets cache found, constructing buckets...")
            self.buckets = {}
            for i in range(len(self.dataset)):
                latent = self.dataset[i]["vision_latents"]
                hw = (int(latent.shape[0]), int(latent.shape[1]))  # NHWC latent
                self.buckets.setdefault(hw, []).append(i)
            with open(cache_file, "wb") as f:
                pickle.dump(self.buckets, f)

    def set_latent_scale(self, scale: float) -> None:
        self.latent_scale = _per_sample(scale)

    def set_latent_bias(self, bias: float) -> None:
        self.latent_bias = _per_sample(bias)

    def __len__(self) -> int:
        return sum(len(v) for v in self.buckets.values())

    def __getitem__(self, idx: int) -> BatchData:
        if self.latent_scale is None:
            raise ValueError("Latent scale must be set before getting items")
        sample = self.dataset[idx]
        if "vision_latents" not in sample:
            raise KeyError("precompute the latents before training")
        if "caption" not in sample:
            raise KeyError("add captions to the dataset")

        latent = np.asarray(sample["vision_latents"], np.float32)
        batch: BatchData = {
            "model_inputs": {
                "x": (latent - self.latent_bias) * self.latent_scale,
                "initial_context": str(sample["caption"]),
            },
            "extra": {},
        }
        # precomputed caption embeddings feed a PrecomputedEmbedder
        if "caption_embeddings" in sample:
            batch["model_inputs"]["context"] = {
                "embeddings": np.asarray(sample["caption_embeddings"], np.float32),
            }
            if "caption_mask" in sample:
                batch["model_inputs"]["context"]["attn_mask"] = np.asarray(sample["caption_mask"], bool)
        if "dst_features" in sample:
            batch["extra"]["dst_features"] = np.asarray(sample["dst_features"], np.float32)
        elif "image" in sample:
            batch["extra"]["x0"] = _to_float_image(sample["image"])
        return batch


def collate_fn(batch: list[BatchData]) -> BatchData:
    """Stack arrays; keep caption strings as a list (reference imagenet.py:177-194).
    Nested dicts (precomputed "context" embeddings) are stacked per sub-key."""
    model_inputs: dict[str, Any] = {}
    extra: dict[str, Any] = {}
    for key in batch[0]["model_inputs"]:
        if key == "initial_context":
            model_inputs[key] = [s["model_inputs"].get(key, "") for s in batch]
        elif isinstance(batch[0]["model_inputs"][key], dict):
            sub = batch[0]["model_inputs"][key]
            model_inputs[key] = {
                k: np.stack([np.asarray(s["model_inputs"][key][k]) for s in batch]) for k in sub
            }
        else:
            model_inputs[key] = np.stack([np.asarray(s["model_inputs"][key]) for s in batch])
    extra_keys = set().union(*(s.get("extra", {}).keys() for s in batch))
    for key in extra_keys:
        vals = [s["extra"][key] for s in batch if key in s.get("extra", {})]
        extra[key] = np.stack([np.asarray(v) for v in vals])
    return {"model_inputs": model_inputs, "extra": extra}


class MultiARBatchSampler:
    """Yields same-bucket index batches, shuffled (reference imagenet.py:197-236)."""

    def __init__(self, dataset: ImageNetmultiAR, batch_size: int, shuffle: bool = True,
                 drop_last: bool = False, seed: int = 0) -> None:
        if not hasattr(dataset, "buckets"):
            raise ValueError("Dataset must have 'buckets' attribute for MultiARBatchSampler")
        self.buckets = dataset.buckets
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle epoch (``__iter__`` pre-increments, so the next
        iteration shuffles with ``seed + epoch + 1``); a resumed run replays
        the epoch's order."""
        self._epoch = epoch

    def __iter__(self) -> Iterator[list[int]]:
        self._epoch += 1
        rng = np.random.default_rng(self.seed + self._epoch)
        all_batches: list[list[int]] = []
        for idxs in self.buckets.values():
            idxs = list(idxs)
            if self.shuffle:
                rng.shuffle(idxs)
            for i in range(0, len(idxs), self.batch_size):
                chunk = idxs[i : i + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    continue
                all_batches.append(chunk)
        if self.shuffle:
            rng.shuffle(all_batches)
        yield from all_batches

    def __len__(self) -> int:
        total = 0
        for idxs in self.buckets.values():
            if self.drop_last:
                total += len(idxs) // self.batch_size
            else:
                total += math.ceil(len(idxs) / self.batch_size)
        return total
