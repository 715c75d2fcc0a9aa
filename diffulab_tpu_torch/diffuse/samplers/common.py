"""Sampler interfaces (port of diffulab_tpu/diffuse/samplers/common.py).

A sampler step is a function of the current state: the current sample, the
model prediction and the timesteps; it returns a :data:`StepResult` dict with
``x_prev`` (the sample at the less noisy time) and ``estimated_x0``, and for
the stochastic sampler ``x_prev_mean``/``x_prev_std``/``logprob``.

Multistep samplers (``is_multistep = True``) carry a state from step to step:
``init_state(x)`` gives the first, ``step(..., state=...)`` takes it and
returns the next under ``"state"``. The tensors of a state live on the card;
the Gaussian samplers keep their per-sample schedule scalars as ``[B, 1, ...]``
tensors, as the reference does;
its scalars (log-SNR gaps, history depth) are host numbers, so the loop never
waits on the device to decide a branch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

StepResult = Dict[str, Any]

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class Sampler:
    name: str = dataclasses.field(default="", init=False)

    def step(self, *args: Any, **kwargs: Any) -> StepResult:  # pragma: no cover - interface
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FlowSampler(Sampler):
    """Flow samplers integrate ``dx/dt = v`` from t_curr down to t_prev:
    ``step(x_t, v, t_curr, t_prev, *, noise=None, x_prev=None)``."""

    def with_timesteps(self, timesteps) -> "FlowSampler":
        """Return a sampler with any schedule-derived constants bound."""
        return self


@dataclasses.dataclass(frozen=True)
class GaussianSampler(Sampler):
    """Discrete-time samplers over a beta table (common.py:50):
    ``step(model_prediction, timesteps, xt, *, noise=None, clamp_x=False)``,
    where ``noise`` is the step's standard normal draw of a stochastic
    sampler (the reference takes a PRNG key)."""

    def with_betas(self, betas) -> "GaussianSampler":
        raise NotImplementedError


def unipc_bh2_correction(hh_c_safe, r0c_safe, n_prev: int, m0: torch.Tensor, m_last: torch.Tensor,
                         m_last2: torch.Tensor) -> tuple[np.float32, torch.Tensor]:
    """UniPC-2 (bh2 variant) corrector algebra shared by the flow and EDM
    schedules (common.py:61; arXiv:2302.04867, eq. 14-16): given the safe
    negative lambda gap ``hh_c_safe`` of the transition being corrected, the
    normalised gap ``r0c_safe`` to the second history point (fp32 host
    scalars), the history depth ``n_prev`` and the fp32 data predictions
    ``m0`` (fresh eval), ``m_last``, ``m_last2``, return ``(phi1_c, corr)``.
    Falls back to the order-1 corrector (rho = 1/2 on D1_t) until two history
    points exist. The coefficients are solved in fp32 on the host, as the
    reference's 0-d fp32 arrays are."""
    hh_c_safe, r0c_safe = F32(hh_c_safe), F32(r0c_safe)
    phi1_c = F32(np.expm1(hh_c_safe))
    d1_t = m0 - m_last
    hk1 = phi1_c / hh_c_safe - F32(1.0)
    b1 = hk1 / phi1_c
    b2 = (hk1 / hh_c_safe - F32(0.5)) * F32(2.0) / phi1_c
    # order-2 corrector: solve [[1, 1], [r0, 1]] @ rhos = [b1, b2]
    det = F32(1.0) - r0c_safe if abs(F32(1.0) - r0c_safe) > 1e-8 else F32(1.0)
    if n_prev > 1:
        rho0 = (b1 - b2) / det
        rho1 = (b2 - r0c_safe * b1) / det
        d1_0 = (m_last2 - m_last) / float(r0c_safe)
        corr = float(rho0) * d1_0 + float(rho1) * d1_t
    else:
        corr = 0.5 * d1_t
    return phi1_c, corr
