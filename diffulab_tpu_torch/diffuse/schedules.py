"""Timestep schedules of the flow formalization (port of the flow part of
diffulab_tpu/diffuse/schedules.py). Grids are built on the host in float64
and rounded once to float32, as the reference does."""

from __future__ import annotations

import numpy as np


def shift_timestep(t, alpha: float):
    """Time-shifting s(alpha, t) = alpha*t / (1 + (alpha - 1) * t);
    alpha > 1 concentrates samples at higher noise levels."""
    return alpha * t / (1 + (alpha - 1) * t)


def flow_linear_timesteps(n_steps: int, shift: float | None = None) -> np.ndarray:
    """Descending flow-matching time grid 1 -> 0 with ``n_steps + 1`` points (fp32)."""
    ts = np.linspace(1.0, 0.0, n_steps + 1, dtype=np.float64)
    if shift is not None:
        ts = shift_timestep(ts, shift)
    return ts.astype(np.float32)
