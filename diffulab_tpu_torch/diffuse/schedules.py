"""Timestep schedules and table utilities of the diffusion formalizations
(port of diffulab_tpu/diffuse/schedules.py).

Grids and beta tables are built on the host in float64 NumPy, as the
reference builds them, and rounded to float32 at the point where the
reference rounds them: the flow grid once, the Gaussian tables when a value
is gathered (:func:`extract_into_tensor`).
"""

from __future__ import annotations

import math

import numpy as np
import torch


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


def get_variance_schedule(n_steps: int, schedule: str = "linear") -> np.ndarray:
    """DDPM beta schedule in float64 (schedules.py:43): Ho et al.'s linear
    one scaled to ``n_steps``, or the cosine one."""
    if schedule == "linear":
        scale = 1000 / n_steps
        return np.linspace(scale * 0.0001, scale * 0.02, n_steps, dtype=np.float64)
    if schedule == "cosine":
        return betas_for_alpha_bar(n_steps, lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2)
    raise NotImplementedError(f"unknown beta schedule: {schedule}")


def betas_for_alpha_bar(n_steps: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    """Betas realising a cumulative alpha_bar(t) curve (schedules.py:58)."""
    betas = [min(1 - alpha_bar((i + 1) / n_steps) / alpha_bar(i / n_steps), max_beta) for i in range(n_steps)]
    return np.array(betas, dtype=np.float64)


def space_timesteps(num_timesteps: int, section_counts: str | int, ddim: bool = False) -> set[int]:
    """The training timesteps a respaced sampler visits (schedules.py:68):
    guided-diffusion's section spacing (``"10,15,20"`` or an int), or with
    ``ddim`` the first integer stride that gives exactly ``section_counts``
    steps (searched over every stride, as the reference does)."""
    if ddim:
        for i in range(1, num_timesteps):
            if len(range(0, num_timesteps, i)) == section_counts:
                return set(range(0, num_timesteps, i))
        raise ValueError(f"cannot create exactly {section_counts} steps with an integer stride")

    if isinstance(section_counts, str):
        counts = [int(x) for x in section_counts.split(",")]
    else:
        counts = [section_counts]
    size_per, extra = divmod(num_timesteps, len(counts))
    start_idx = 0
    all_steps: list[int] = []
    for i, section_count in enumerate(counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1.0 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        start_idx += size
    return set(all_steps)


def respace_betas(betas: np.ndarray, use_timesteps: set[int]) -> tuple[np.ndarray, np.ndarray]:
    """Betas over a subset of the timesteps that keep alpha_bar there
    (schedules.py:111): ``(new_betas fp64, timestep_map int32)``, where
    ``timestep_map[i]`` is the training timestep of respaced step ``i``."""
    alphas_bar = np.cumprod(1.0 - betas)
    last_alpha_bar = 1.0
    new_betas: list[float] = []
    timestep_map: list[int] = []
    for i, alpha_bar in enumerate(alphas_bar):
        if i in use_timesteps:
            new_betas.append(1.0 - alpha_bar / last_alpha_bar)
            last_alpha_bar = alpha_bar
            timestep_map.append(i)
    return np.array(new_betas, dtype=np.float64), np.array(timestep_map, dtype=np.int32)


def extract_into_tensor(arr: np.ndarray, timesteps: torch.Tensor, broadcast_ndim: int) -> torch.Tensor:
    """fp32 ``arr[timesteps]`` shaped ``[B, 1, ..., 1]`` with
    ``broadcast_ndim`` dims, on the timesteps' device (schedules.py:130): the
    fp64 table rounds to fp32 before the gather, as the reference's does."""
    table = torch.as_tensor(np.asarray(arr, dtype=np.float32), device=timesteps.device)
    res = table[timesteps.long()]
    return res.reshape(res.shape[0], *([1] * (broadcast_ndim - 1)))
