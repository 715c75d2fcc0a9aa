"""Denoiser interface (port of diffulab_tpu/networks/denoisers/common.py).

Call convention for every denoiser (the ``model_fn`` the formalizations drive):

    model(x, timesteps, cond=None, drop=None, train=False,
          capture_features=False) -> ModelOutput

- ``x``: NHWC image/latent batch ``[B, H, W, C]``.
- ``timesteps``: ``[B]`` floats (flow time in [0, 1]).
- ``cond``: dict of conditioning inputs; ``y`` holds int class labels ``[B]``,
  ``x_context`` extra image channels concatenated to x.
- ``drop``: per-sample bool mask selecting the null condition.

ModelOutput: dict with "x" ([B, H, W, C_out]).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

ModelInput = Dict[str, Any]
ModelOutput = Dict[str, Any]


class Denoiser(nn.Module):
    """Base class for denoiser architectures."""

    classifier_free: bool = False

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        cond: ModelInput | None = None,
        drop: torch.Tensor | None = None,
        train: bool = False,
        capture_features: bool = False,
    ) -> ModelOutput:
        raise NotImplementedError
