"""Flow-matching samplers (port of diffulab_tpu/diffuse/samplers/flow.py):
the Euler ODE step, the Euler-Maruyama SDE step with its transition
log-density, the multistep DPM-Solver++(2M) and UniPC(bh2) solvers, and Heun.

The timesteps are fp32 schedule values given as host numbers. The reference's
are non-weak fp32 0-d arrays, so a bf16 tensor times one of them promotes to
fp32 there (trap T8): the port forms every scalar coefficient in fp32 with
numpy and multiplies fp32 tensors by it, and the caller casts the carry back.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from diffulab_tpu_torch.diffuse.samplers.common import F32, FlowSampler, StepResult, unipc_bh2_correction
from diffulab_tpu_torch.utils import at_least_f32


@dataclasses.dataclass(frozen=True)
class Euler(FlowSampler):
    """Deterministic Euler ODE step: ``x_prev = x_t - v * (t_curr - t_prev)``."""

    name = "euler"

    def step(self, x_t: torch.Tensor, v: torch.Tensor, t_curr: float, t_prev: float, *,
             noise: torch.Tensor | None = None, x_prev: torch.Tensor | None = None) -> StepResult:
        del noise, x_prev
        dt = float(F32(t_curr) - F32(t_prev))  # positive: time flows 1 -> 0
        v32 = at_least_f32(v)
        return {
            "x_prev": x_t - v32 * dt,
            "estimated_x0": x_t - v32 * float(F32(t_curr)),
        }


@dataclasses.dataclass(frozen=True)
class EulerMaruyama(FlowSampler):
    """Stochastic SDE sampler with per-element transition log-probs (flow.py:49).

    sigma(t) = eta * sqrt(t / (1 - min(t, tmax))) with ``tmax`` the second
    timestep of the schedule; the drift adds the score-correction term so the
    SDE marginals match the ODE flow. ``noise`` is the standard normal draw of
    the step (in ``x_t``'s dtype, as the reference draws it); with ``x_prev``
    the step does not sample and only re-evaluates that sample's log-density.
    """

    name = "euler_maruyama"
    eta: float = 0.7
    tmax: float | None = None

    def with_timesteps(self, timesteps) -> "EulerMaruyama":
        return dataclasses.replace(self, tmax=float(timesteps[1]))

    def step(self, x_t: torch.Tensor, v: torch.Tensor, t_curr: float, t_prev: float, *,
             noise: torch.Tensor | None = None, x_prev: torch.Tensor | None = None) -> StepResult:
        if self.tmax is None:
            raise ValueError("with_timesteps must be called before step")
        t_curr, t_prev = F32(t_curr), F32(t_prev)
        sigma = np.sqrt(t_curr / (F32(1.0) - min(t_curr, F32(self.tmax)))) * F32(self.eta)
        dt = t_curr - t_prev
        drift_c = sigma**2 / (F32(2.0) * t_curr)
        v32 = at_least_f32(v)
        x_prev_mean = x_t - (v32 + float(drift_c) * (x_t + float(F32(1.0) - t_curr) * v32)) * float(dt)
        x_prev_std = F32(sigma * np.sqrt(dt))
        if x_prev is None:
            if noise is None:
                raise ValueError("Euler-Maruyama needs the step's noise to sample")
            x_prev = x_prev_mean + float(x_prev_std) * at_least_f32(noise)
        logprob = -((x_prev.detach() - x_prev_mean) ** 2 / float(F32(2.0) * x_prev_std**2)
                    + float(np.log(x_prev_std)) + 0.5 * math.log(2.0 * math.pi))
        return {
            "x_prev": x_prev,
            "estimated_x0": x_t - v32 * float(t_curr),
            "x_prev_mean": x_prev_mean,
            "x_prev_std": torch.full((1,), float(x_prev_std), dtype=torch.float32, device=x_t.device),
            "logprob": logprob,
        }


def _flow_lam(t, t_eps: float) -> np.float32:
    """Half-log-SNR of the rectified-flow schedule, ``log((1 - t) / t)``, fp32."""
    t = F32(np.clip(F32(t), F32(t_eps), F32(1.0 - t_eps)))
    return F32(np.log((F32(1.0) - t) / t))


@dataclasses.dataclass(frozen=True)
class DPMSolverPP2M(FlowSampler):
    """Multistep DPM-Solver++(2M) under the rectified-flow schedule (flow.py:107):
    ``lambda(t) = log((1 - t) / t)``, ``h = lambda(t_prev) - lambda(t_curr)``,
    ``D = (1 + 1/2r) x0_i - 1/2r x0_{i-1}`` with ``r = h_last / h``, and
    ``x_prev = (t_prev / t_curr) x_t - (1 - t_prev)(e^{-h} - 1) D``. The first
    and the final (``t_prev <= t_eps``) steps are first order; the final one
    returns the data prediction exactly.

    State: ``x0_prev`` (the previous data prediction, rounded to the input
    dtype as the reference does), ``h_last`` (fp32) and ``has_prev``.
    """

    name = "dpmpp_2m"
    is_multistep = True
    t_eps: float = 1e-5

    def init_state(self, x: torch.Tensor) -> dict:
        return {"x0_prev": torch.zeros_like(x), "h_last": F32(0.0), "has_prev": False}

    def step(self, x_t: torch.Tensor, v: torch.Tensor, t_curr: float, t_prev: float, *,
             noise: torch.Tensor | None = None, x_prev: torch.Tensor | None = None,
             state: dict | None = None) -> StepResult:
        del noise, x_prev
        if state is None:
            raise ValueError("multistep sampler: denoise must thread init_state")
        t_curr, t_prev = F32(t_curr), F32(t_prev)
        # x_t - v * t_curr promotes to fp32 (t_curr is an fp32 0-d array in the reference)
        x0 = x_t - at_least_f32(v) * float(t_curr)
        h = _flow_lam(t_prev, self.t_eps) - _flow_lam(t_curr, self.t_eps)
        final = bool(t_prev <= F32(self.t_eps))
        if not state["has_prev"] or final:  # first order on the first and on the final step
            d = at_least_f32(x0)
        else:
            r_safe = max(F32(state["h_last"] / h), F32(1e-8))
            c = F32(1.0) / (F32(2.0) * r_safe)
            d = float(F32(1.0) + c) * at_least_f32(x0) - float(c) * at_least_f32(state["x0_prev"])
        if final:
            sig_ratio, em1 = F32(0.0), F32(-1.0)  # e^{-h} - 1 is exactly -1 at the final step
        else:
            sig_ratio = F32(np.clip(t_prev, F32(self.t_eps), F32(1.0)) / np.clip(t_curr, F32(self.t_eps), F32(1.0)))
            em1 = F32(np.expm1(-h))
        alpha_prev = F32(1.0) - t_prev
        x_next = float(sig_ratio) * at_least_f32(x_t) - float(alpha_prev * em1) * d
        return {
            "x_prev": x_next.to(x_t.dtype),
            "estimated_x0": x0,
            "state": {"x0_prev": x0.to(x_t.dtype), "h_last": h, "has_prev": True},
        }


@dataclasses.dataclass(frozen=True)
class UniPC(FlowSampler):
    """UniPC (arXiv:2302.04867) under the rectified-flow schedule, order 2,
    B(h) = e^h - 1 ("bh2") (flow.py:192): each step's fresh eval first
    corrects the previous transition (UniC), then the order-2 predictor (UniP)
    advances. The final step (``t_prev <= t_eps``) is first order.

    State: ``x_last`` (the sample the last transition started from),
    ``m_last``/``m_last2`` (previous data predictions, in the input dtype),
    ``lam_last``/``lam_last2`` (fp32) and ``n_prev`` (history depth, at most 2).
    """

    name = "unipc"
    is_multistep = True
    t_eps: float = 1e-5

    def init_state(self, x: torch.Tensor) -> dict:
        zeros = torch.zeros_like(x)
        return {"x_last": zeros, "m_last": zeros, "m_last2": zeros,
                "lam_last": F32(0.0), "lam_last2": F32(0.0), "n_prev": 0}

    def step(self, x_t: torch.Tensor, v: torch.Tensor, t_curr: float, t_prev: float, *,
             noise: torch.Tensor | None = None, x_prev: torch.Tensor | None = None,
             state: dict | None = None) -> StepResult:
        del noise, x_prev
        if state is None:
            raise ValueError("multistep sampler: denoise must thread init_state")
        t_curr, t_prev = F32(t_curr), F32(t_prev)
        m0 = at_least_f32(x_t - at_least_f32(v) * float(t_curr))
        lam_curr = _flow_lam(t_curr, self.t_eps)
        n_prev = state["n_prev"]
        m_last = at_least_f32(state["m_last"])

        # UniC: correct the previous transition t_last -> t_curr with m0
        if n_prev > 0:
            hh_c_safe = F32(state["lam_last"] - lam_curr)  # < 0
            r0c_safe = (F32((state["lam_last2"] - state["lam_last"]) / -hh_c_safe) if n_prev > 1 else F32(-1.0))
            phi1_c, corr = unipc_bh2_correction(hh_c_safe, r0c_safe, n_prev, m0, m_last,
                                                at_least_f32(state["m_last2"]))
            t_last = F32(1.0 / (1.0 + np.exp(F32(state["lam_last"]))))  # sigmoid(-lam), the inverse of lam
            c_last = F32(1.0) - t_curr
            x_used = (float(t_curr / max(t_last, F32(self.t_eps))) * at_least_f32(state["x_last"])
                      - float(c_last * phi1_c) * m_last - float(c_last * phi1_c) * corr)
        else:
            x_used = at_least_f32(x_t)

        # UniP: order-2 predictor t_curr -> t_prev from the corrected x
        hh = F32(lam_curr - _flow_lam(t_prev, self.t_eps))  # < 0
        final = bool(t_prev <= F32(self.t_eps))
        if final:
            sig_ratio, phi1 = F32(0.0), F32(-1.0)
        else:
            sig_ratio = F32(np.clip(t_prev, F32(self.t_eps), F32(1.0)) / np.clip(t_curr, F32(self.t_eps), F32(1.0)))
            phi1 = F32(np.expm1(hh))
        c_prev = F32(1.0) - t_prev
        base = float(sig_ratio) * x_used - float(c_prev * phi1) * m0
        if n_prev == 0 or final:
            x_next = base
        else:
            r0p = F32((state["lam_last"] - lam_curr) / -hh)  # < 0
            d1_p = (m_last - m0) / float(r0p)
            x_next = base - float(c_prev * phi1 * F32(0.5)) * d1_p  # B_h = phi1 (bh2)

        return {
            "x_prev": x_next.to(x_t.dtype),
            "estimated_x0": m0.to(x_t.dtype),
            "state": {"x_last": x_used.to(x_t.dtype), "m_last": m0.to(x_t.dtype), "m_last2": state["m_last"],
                      "lam_last": lam_curr, "lam_last2": state["lam_last"], "n_prev": min(n_prev + 1, 2)},
        }


@dataclasses.dataclass(frozen=True)
class Heun(FlowSampler):
    """Second-order Heun (predictor-corrector) step (flow.py:307): the
    formalization evaluates the corrector velocity ``v2`` at the Euler-predicted
    point ``predict(...)``; ``x_prev = x_t - dt/2 * (v + v2)``."""

    name = "heun"
    needs_second_eval = True

    def predict(self, x_t: torch.Tensor, v: torch.Tensor, t_curr: float, t_prev: float) -> torch.Tensor:
        return x_t - at_least_f32(v) * float(F32(t_curr) - F32(t_prev))

    def step(self, x_t: torch.Tensor, v: torch.Tensor, t_curr: float, t_prev: float, *,
             v2: torch.Tensor | None = None, noise: torch.Tensor | None = None,
             x_prev: torch.Tensor | None = None) -> StepResult:
        del noise, x_prev
        dt = F32(t_curr) - F32(t_prev)
        if v2 is None:  # degrade to Euler when no corrector velocity is given
            v2 = v
        return {
            "x_prev": x_t - float(F32(0.5) * dt) * at_least_f32(v + v2),
            "estimated_x0": x_t - at_least_f32(v) * float(F32(t_curr)),
        }
