"""REPA encoder interface (port of diffulab_tpu/networks/repa/common.py).

A REPA encoder maps NHWC images to patch-token features ``[B, N, D]``: the
frozen alignment target of :class:`~diffulab_tpu_torch.training.losses.RepaLoss`.
Not ported yet (they raise ``NotImplementedError``, ROADMAP queue 1, item
13b): ``compute_on_dataset`` (the offline ``dst_features`` precompute, which
needs the pretrained DINO encoders) and ``bicubic_resize`` (the reference's
antialiased Keys a = -0.5 resize, trap T3).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

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

    def compute_on_dataset(self, *args, **kwargs) -> None:
        raise NotImplementedError("REPA.compute_on_dataset (precomputed dst_features) is not ported yet "
                                  "(ROADMAP queue 1, item 13b)")


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """0-1 / 0-255 range detection, then the ImageNet mean/std normalisation
    of NHWC pixels, in fp32 (common.py:79)."""
    x = x.float()
    x = torch.where(x.abs().max() > 1.5, x / 255.0, x)
    x = x.clamp(0.0, 1.0)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def bicubic_resize(x: torch.Tensor, size: int) -> torch.Tensor:
    raise NotImplementedError("bicubic_resize (jax.image.resize's antialiased bicubic, trap T3) is not ported yet "
                              "(ROADMAP queue 1, item 13b)")
