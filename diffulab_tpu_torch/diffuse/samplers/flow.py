"""Flow-matching samplers (port of diffulab_tpu/diffuse/samplers/flow.py):
the deterministic Euler step. The stochastic and multistep samplers are not
ported yet."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diffulab_tpu_torch.diffuse.samplers.common import FlowSampler, StepResult
from diffulab_tpu_torch.utils import at_least_f32


@dataclasses.dataclass(frozen=True)
class Euler(FlowSampler):
    """Deterministic Euler ODE step: ``x_prev = x_t - v * (t_curr - t_prev)``.

    ``t_curr``/``t_prev`` are fp32 schedule values. The reference's schedule
    scalars are non-weak fp32 arrays, so a bf16 ``v`` times ``dt`` promotes to
    fp32 there; the port computes the step in fp32 too (trap T8) and the
    caller casts the carry back.
    """

    name = "euler"

    def step(
        self,
        x_t: torch.Tensor,
        v: torch.Tensor,
        t_curr: float,
        t_prev: float,
        *,
        generator: torch.Generator | None = None,
        x_prev: torch.Tensor | None = None,
    ) -> StepResult:
        del generator, x_prev
        dt = float(np.float32(t_curr) - np.float32(t_prev))  # positive: time flows 1 -> 0
        v32 = at_least_f32(v)
        return {
            "x_prev": x_t - v32 * dt,
            "estimated_x0": x_t - v32 * float(np.float32(t_curr)),
        }
