"""Denoiser interface (port of diffulab_tpu/networks/denoisers/common.py).

Call convention for every denoiser (the ``model_fn`` the formalizations drive):

    model(x, timesteps, cond=None, drop=None, train=False,
          capture_features=False, generator=None) -> ModelOutput

- ``x``: NHWC image/latent batch ``[B, H, W, C]``.
- ``timesteps``: ``[B]`` floats (flow time in [0, 1]).
- ``cond``: dict of conditioning inputs; ``y`` holds int class labels ``[B]``,
  ``x_context`` extra image channels concatenated to x.
- ``drop``: per-sample bool mask selecting the null condition.
- ``generator``: the ``torch.Generator`` a training forward draws its own
  randomness from (SprintDiT's token drop; the reference's call-time
  ``rngs``, trainer.py:355). The trainer passes one, seeded per step, to a
  denoiser whose ``draws_in_training`` is set, so that a run's draws follow
  its seed; a denoiser without such draws takes the keyword and ignores it.

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
    #: whether a training forward draws from its ``generator`` (the trainer then passes one)
    draws_in_training: bool = False

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        cond: ModelInput | None = None,
        drop: torch.Tensor | None = None,
        train: bool = False,
        capture_features: bool = False,
        generator: torch.Generator | None = None,
    ) -> ModelOutput:
        raise NotImplementedError
