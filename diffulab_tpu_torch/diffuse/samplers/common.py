"""Sampler interfaces (port of diffulab_tpu/diffuse/samplers/common.py).

A sampler step is a function of the current state: the current sample, the
model prediction and the timesteps; it returns a :data:`StepResult` dict with
``x_prev`` (the sample at the less noisy time) and ``estimated_x0``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

StepResult = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Sampler:
    name: str = dataclasses.field(default="", init=False)

    def step(self, *args: Any, **kwargs: Any) -> StepResult:  # pragma: no cover - interface
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FlowSampler(Sampler):
    """Flow samplers integrate ``dx/dt = v`` from t_curr down to t_prev:
    ``step(x_t, v, t_curr, t_prev, *, generator=None, x_prev=None)``."""

    def with_timesteps(self, timesteps) -> "FlowSampler":
        """Return a sampler with any schedule-derived constants bound."""
        return self
