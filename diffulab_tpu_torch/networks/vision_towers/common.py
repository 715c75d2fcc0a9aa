"""Vision tower interface (port of diffulab_tpu/networks/vision_towers/common.py).

A vision tower encodes NHWC images to latents and back. The latent scale and
bias are floats or per-channel ``[1, 1, 1, C]`` fp32 tensors (non-persistent
buffers, so they follow the tower's device). ``compute_on_dataset`` is not
ported yet (ROADMAP item 10r).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn


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

    def encode(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        raise NotImplementedError

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.decode(self.encode(x, generator))
