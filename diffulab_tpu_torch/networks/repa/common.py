"""REPA encoder interface and the offline feature precompute (port of
diffulab_tpu/networks/repa/common.py; reference src/diffulab/networks/repa/common.py:17-139).

A REPA encoder maps NHWC images to patch-token features ``[B, N, D]``: the
frozen alignment target of :class:`~diffulab_tpu_torch.training.losses.RepaLoss`.
``compute_on_dataset`` streams a sharded dataset, encodes its image column
and writes a new sharded dataset with an added ``dst_features`` column.

:func:`bicubic_resize` is ``jax.image.resize(..., "bicubic")`` (trap T3):
Keys' cubic at a = -0.5, antialiased when it shrinks (the kernel widened by
the inverse scale), the weights of each output renormalised to sum to 1.
``F.interpolate(mode="bicubic")`` (a = -0.75, no antialias) differs, so the
two separable weight matrices are built in NumPy as
``jax.image.scale_and_translate`` builds them and applied as two matmuls.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from diffulab_tpu_torch.data.streaming import ShardedDataset, ShardedDatasetWriter

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class REPA(nn.Module):
    """Abstract frozen feature encoder (common.py:26-45)."""

    @property
    def encoder(self) -> nn.Module:
        raise NotImplementedError

    @property
    def embedding_dim(self) -> int:
        raise NotImplementedError

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def compute_on_dataset(
        self,
        dataset_path: str | Path,
        dst_path: str | Path,
        target_type: str = "float32",
        batch_size: int = 64,
        image_key: str | None = None,
        shard_size: int = 1024,
    ) -> None:
        """Stream ``dataset_path``, add a ``dst_features`` column, write
        ``dst_path`` (common.py:47-76). Each batch goes to the encoder's
        device as fp32 pixels."""
        dataset = ShardedDataset(dataset_path)
        if image_key is None:
            image_cols = [c for c in dataset.columns if c.startswith("image")]
            if len(image_cols) != 1:
                raise ValueError(f"Dataset must contain exactly one 'image*' column, found {image_cols}")
            image_key = image_cols[0]
        if target_type not in ("float32", "float16"):
            raise ValueError(f"Unsupported target type: {target_type}")
        out_dtype = np.float32 if target_type == "float32" else np.float16
        device = next(self.parameters()).device
        with ShardedDatasetWriter(dst_path, shard_size=shard_size) as writer, torch.no_grad():
            n = len(dataset)
            for start in range(0, n, batch_size):
                samples = [dataset[i] for i in range(start, min(start + batch_size, n))]
                images = torch.as_tensor(np.stack([np.asarray(s[image_key], np.float32) for s in samples]),
                                         device=device)
                feats = self(images).float().cpu().numpy().astype(out_dtype)
                for i, s in enumerate(samples):
                    writer.write({**s, "dst_features": feats[i]})


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """0-1 / 0-255 range detection, then the ImageNet mean/std normalisation
    of NHWC pixels, in fp32 (common.py:79)."""
    x = x.float()
    x = torch.where(x.abs().max() > 1.5, x / 255.0, x)
    x = x.clamp(0.0, 1.0)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def keys_cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """The ``[in_size, out_size]`` fp32 weights that
    ``jax.image.scale_and_translate`` applies along one axis for a bicubic
    resize (jax/_src/image/scale.py ``compute_weight_mat``): sample points
    ``(j + 0.5) / scale - 0.5``, Keys' cubic (a = -0.5) over distances divided
    by ``max(1 / scale, 1)`` (the antialias), each column normalised to sum
    to 1, columns whose sample lies outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))  # a Python float in JAX, rounded where it meets fp32
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), w)
    w = np.where(x >= 2.0, f32(0.0), w).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def bicubic_resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, size, size, C), "bicubic")`` of an NHWC
    tensor, in fp32 (common.py:88): an axis already at ``size`` is left as
    it is, as in JAX."""
    x = x.float()
    if x.shape[1] != size:
        x = torch.einsum("bhwc,hy->bywc", x, torch.as_tensor(keys_cubic_weights(x.shape[1], size), device=x.device))
    if x.shape[2] != size:
        x = torch.einsum("bhwc,wx->bhxc", x, torch.as_tensor(keys_cubic_weights(x.shape[2], size), device=x.device))
    return x
