"""Vision tower interface and the offline latent precompute (port of
diffulab_tpu/networks/vision_towers/common.py).

A vision tower encodes NHWC images to latents and back. The latent scale and
bias are floats or per-channel ``[1, 1, 1, C]`` fp32 tensors (non-persistent
buffers, so they follow the tower's device). ``compute_on_dataset`` streams
a sharded dataset, encodes its image column and writes a new sharded
dataset with an added ``vision_latents`` column; a stochastic encoder (the
Flux2 VAE) draws batch ``bi``'s noise from the JAX key
``fold_in(key(seed), bi)`` (common.py:93), reproduced by :mod:`...jax_prng`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from diffulab_tpu_torch import jax_prng
from diffulab_tpu_torch.data.streaming import ShardedDataset, ShardedDatasetWriter


def normalize_to_pm1(x: torch.Tensor) -> torch.Tensor:
    """Range detection then scale to [-1, 1] (common.py:22): 0-255 input is
    divided down first, 0-1 input is mapped affinely to [-1, 1], and input
    already in [-1, 1] (any negative mass) is clipped and passed through."""
    x = x.float()
    x = torch.where(x.abs().max() > 1.5, x / 255.0, x)
    already_pm1 = x.min() < -1e-3
    return torch.where(already_pm1, torch.clamp(x, -1.0, 1.0), (torch.clamp(x, 0.0, 1.0) - 0.5) * 2.0)


class VisionTower(nn.Module):
    """Base class for VAE towers with latent scale/bias handling."""

    def __init__(self, latent_scale: Any = 1.0, latent_bias: Any = 0.0) -> None:
        super().__init__()
        for name, value in (("latent_scale", latent_scale), ("latent_bias", latent_bias)):
            if isinstance(value, torch.Tensor):
                self.register_buffer(name, value.float(), persistent=False)
            else:
                setattr(self, name, float(value))

    @property
    def compression_factor(self) -> int:
        raise NotImplementedError

    @property
    def latent_channels(self) -> int:
        raise NotImplementedError

    def encode(self, x: torch.Tensor, generator: Any = None) -> torch.Tensor:
        """NHWC image -> latents; ``generator`` (a torch Generator or a JAX
        PRNG key) draws a stochastic encoder's sample."""
        raise NotImplementedError

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.decode(self.encode(x, generator))

    def compute_on_dataset(
        self,
        dataset_path: str | Path,
        dst_path: str | Path,
        batch_size: int = 64,
        to_process_data_key: str | None = None,
        target_type: str = "float32",
        column_target: str = "vision_latents",
        shard_size: int = 1024,
        seed: int = 0,
    ) -> None:
        """Stream ``dataset_path``, add a ``vision_latents`` column, write
        ``dst_path`` (common.py:66-100). Each batch goes to the tower's
        device as fp32 pixels."""
        dataset = ShardedDataset(dataset_path)
        if to_process_data_key is None:
            image_cols = [c for c in dataset.columns if c.startswith("image")]
            if len(image_cols) != 1:
                raise ValueError(f"need exactly one image column, got {image_cols}")
            to_process_data_key = image_cols[0]
        if target_type not in ("float32", "float16"):
            raise ValueError("target_type must be 'float32' or 'float16'")
        out_dtype = np.float32 if target_type == "float32" else np.float16
        device = next(self.parameters()).device
        key = jax_prng.key(seed)
        with ShardedDatasetWriter(dst_path, shard_size=shard_size) as writer, torch.no_grad():
            n = len(dataset)
            for bi, start in enumerate(range(0, n, batch_size)):
                samples = [dataset[i] for i in range(start, min(start + batch_size, n))]
                images = torch.as_tensor(np.stack([np.asarray(s[to_process_data_key], np.float32) for s in samples]),
                                         device=device)
                latents = self.encode(images, jax_prng.fold_in(key, bi)).float().cpu().numpy().astype(out_dtype)
                for i, s in enumerate(samples):
                    writer.write({**s, column_target: latents[i]})
