"""Auxiliary loss interface (port of diffulab_tpu/training/losses/common.py).

A LossFunction is a named module whose parameters train jointly with the
denoiser (the trainer optimises, averages and checkpoints them together,
:class:`~diffulab_tpu_torch.training.checkpoint.TrainModules`). ``set_model``
is the attachment point: it configures the denoiser's declarative feature
capture, and the loss later reads those features from the model output.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn


class LossFunction(nn.Module):
    name: str = "extra_loss"

    def set_model(self, model: Any) -> None:
        """Attach to a denoiser (default: no-op)."""

    def forward(self, model_output: dict[str, Any], **kwargs: Any) -> torch.Tensor:
        raise NotImplementedError
