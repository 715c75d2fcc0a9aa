"""Gaussian-diffusion samplers: DDPM ancestral, DDIM, DPM-Solver++(2M) and
UniPC over the discrete DDPM schedule (port of
diffulab_tpu/diffuse/samplers/gaussian.py).

The posterior tables are built in float64 on the host, as the reference
builds them, and gathered as fp32 ``[B, 1, ...]`` tensors
(:func:`~diffulab_tpu_torch.diffuse.schedules.extract_into_tensor`), so a
bf16 sample promotes to fp32 against them as it does in JAX (trap T8).
Images are NHWC: the learned-variance channel split chunks the last axis.

A stochastic step takes its standard normal draw as ``noise`` (the
reference takes a PRNG key); the denoise loop hands it the draw of the
formalization's ``draw_noise`` (trap T4). The multistep samplers keep their
per-sample schedule scalars as tensors, as the reference does, and their
history depth (``has_prev``, ``n_prev``) on the host, so the loop never
reads the device to pick a branch; the state rounds at the reference's
points (trap T22).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from diffulab_tpu_torch.diffuse.samplers.common import GaussianSampler, StepResult
from diffulab_tpu_torch.diffuse.schedules import extract_into_tensor

MEAN_TYPES = ("epsilon", "xstart", "xprev")
VAR_TYPES = ("learned", "fixed_small", "fixed_large", "learned_range")


def _mask_t(timesteps: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``(t > 0)`` in ``like``'s dtype, shaped ``[B, 1, ...]``."""
    return (timesteps > 0).to(like.dtype).reshape(-1, *([1] * (like.ndim - 1)))


@dataclasses.dataclass(frozen=True)
class DDPM(GaussianSampler):
    """DDPM ancestral sampler with selectable mean/variance parameterizations (gaussian.py:34)."""

    name = "ddpm"
    mean_type: str = "epsilon"
    var_type: str = "fixed_small"
    # fp64 tables, None until with_betas
    betas: np.ndarray | None = None
    alphas_bar: np.ndarray | None = None
    alphas_bar_prev: np.ndarray | None = None
    alphas_bar_next: np.ndarray | None = None
    sqrt_alphas_bar: np.ndarray | None = None
    posterior_variance: np.ndarray | None = None
    posterior_log_variance_clipped: np.ndarray | None = None
    posterior_mean_coef1: np.ndarray | None = None
    posterior_mean_coef2: np.ndarray | None = None

    def __post_init__(self):
        if self.mean_type not in MEAN_TYPES:
            raise ValueError(f"mean_type must be one of {MEAN_TYPES}")
        if self.var_type not in VAR_TYPES:
            raise ValueError(f"var_type must be one of {VAR_TYPES}")

    def with_betas(self, betas: np.ndarray) -> "DDPM":
        """The posterior tables of a beta schedule, in fp64 (gaussian.py:59)."""
        betas = np.asarray(betas, dtype=np.float64)
        alphas = 1.0 - betas
        alphas_bar = np.cumprod(alphas)
        alphas_bar_prev = np.concatenate([[1.0], alphas_bar[:-1]])
        posterior_variance = betas * (1.0 - alphas_bar_prev) / (1.0 - alphas_bar)
        return dataclasses.replace(
            self,
            betas=betas,
            alphas_bar=alphas_bar,
            alphas_bar_prev=alphas_bar_prev,
            alphas_bar_next=np.concatenate([alphas_bar[1:], [0.0]]),
            sqrt_alphas_bar=np.sqrt(alphas_bar),
            posterior_variance=posterior_variance,
            # clipped: the posterior variance is 0 at t = 0
            posterior_log_variance_clipped=np.log(np.concatenate([posterior_variance[1:2], posterior_variance[1:]])),
            posterior_mean_coef1=betas * np.sqrt(alphas_bar_prev) / (1.0 - alphas_bar),
            posterior_mean_coef2=(1.0 - alphas_bar_prev) * np.sqrt(alphas) / (1.0 - alphas_bar),
        )

    # --- x0 recovery ------------------------------------------------------
    def _get_x_start_from_x_prev(self, x_prev, xt, t):
        c1 = extract_into_tensor(self.posterior_mean_coef1, t, x_prev.ndim)
        c2 = extract_into_tensor(self.posterior_mean_coef2, t, xt.ndim)
        return (1.0 / c1) * x_prev - (c2 / c1) * xt

    def _get_x_start_from_eps(self, eps, xt, t):
        sab = extract_into_tensor(self.sqrt_alphas_bar, t, xt.ndim)
        ab = extract_into_tensor(self.alphas_bar, t, eps.ndim)
        return (1.0 / sab) * xt - (torch.sqrt(1.0 - ab) / sab) * eps

    def _get_eps_from_xstart(self, x_start, xt, t):
        sab = extract_into_tensor(self.sqrt_alphas_bar, t, xt.ndim)
        ab = extract_into_tensor(self.alphas_bar, t, xt.ndim)
        return ((1.0 / sab) * xt - x_start) / torch.sqrt(1.0 / ab - 1.0)

    def get_x_start(self, model_output, xt, t, clamp_x: bool = False):
        if self.mean_type == "xprev":
            x_start = self._get_x_start_from_x_prev(model_output, xt, t)
        elif self.mean_type == "xstart":
            x_start = model_output
        else:
            x_start = self._get_x_start_from_eps(model_output, xt, t)
        if clamp_x:
            x_start = torch.clamp(x_start, -1.0, 1.0)
        return x_start

    def _get_mean_from_x_start(self, xt, x_start, t):
        return (extract_into_tensor(self.posterior_mean_coef1, t, x_start.ndim) * x_start
                + extract_into_tensor(self.posterior_mean_coef2, t, xt.ndim) * xt)

    # --- variance dispatch ------------------------------------------------
    def get_variance(self, t, x_ndim: int, log_var=None):
        if self.var_type == "fixed_small":
            var = extract_into_tensor(self.posterior_variance, t, x_ndim)
            lv = extract_into_tensor(self.posterior_log_variance_clipped, t, x_ndim)
        elif self.var_type == "fixed_large":
            v_seq = np.concatenate([self.posterior_variance[1:2], self.betas[1:]])
            var = extract_into_tensor(v_seq, t, x_ndim)
            lv = extract_into_tensor(np.log(v_seq), t, x_ndim)
        elif self.var_type == "learned":
            if log_var is None:
                raise ValueError("log_var must be provided for learned variance")
            var, lv = torch.exp(log_var), log_var
        else:  # learned_range
            if log_var is None:
                raise ValueError("log_var must be provided for learned_range variance")
            min_log = extract_into_tensor(self.posterior_log_variance_clipped, t, x_ndim)
            max_log = extract_into_tensor(np.log(self.betas), t, x_ndim)
            w = (log_var + 1.0) / 2.0
            lv = w * max_log + (1.0 - w) * min_log
            var = torch.exp(lv)
        return var, lv

    def _get_p_mean_var(self, prediction, xt, t, clamp_x: bool = False):
        model_output, log_var = prediction, None
        if self.var_type in ("learned", "learned_range"):
            if model_output.shape[-1] % 2:
                raise ValueError("a learned-variance head has an even number of channels")
            model_output, log_var = model_output.chunk(2, dim=-1)
        x_start = self.get_x_start(model_output, xt, t, clamp_x)
        mean = self._get_mean_from_x_start(xt, x_start, t)
        var, log_var = self.get_variance(t, xt.ndim, log_var)
        return mean, var, log_var, x_start

    # --- ancestral step ----------------------------------------------------
    def step(self, model_prediction: torch.Tensor, timesteps: torch.Tensor, xt: torch.Tensor, *,
             noise: torch.Tensor | None = None, clamp_x: bool = False,
             x_prev: torch.Tensor | None = None) -> StepResult:
        """``x_prev = mean + [t > 0] noise e^{log_var / 2}`` (gaussian.py:154)
        and its Gaussian log-density; ``noise`` in the mean's dtype (fp32)."""
        mean, var, log_var, x_start = self._get_p_mean_var(model_prediction, xt, timesteps, clamp_x)
        t_mask = _mask_t(timesteps, mean)
        if x_prev is None:
            if noise is None:
                raise ValueError("the DDPM ancestral step needs its noise draw")
            x_prev = mean + t_mask * noise.to(mean.dtype) * torch.exp(0.5 * log_var)
        var_safe = torch.clamp(var, min=1e-20)
        const = 0.5 * torch.log(2.0 * math.pi * var_safe)
        elem = -((x_prev.detach() - mean) ** 2) / (2.0 * var_safe) - const
        return {"x_prev": x_prev, "estimated_x0": x_start, "x_prev_mean": mean,
                "x_prev_std": torch.sqrt(var_safe), "logprob": elem * t_mask}


@dataclasses.dataclass(frozen=True)
class DDIM(DDPM):
    """DDIM update, deterministic at eta = 0, stochastic with log-densities
    at eta > 0 (gaussian.py:185)."""

    name = "ddim"
    eta: float = 0.0

    def _sample_x_prev_ddim(self, xt, eps, x_start, t, noise):
        ab = extract_into_tensor(self.alphas_bar, t, xt.ndim)
        ab_prev = extract_into_tensor(self.alphas_bar_prev, t, xt.ndim)
        sigma = self.eta * torch.sqrt((1.0 - ab_prev) / (1.0 - ab)) * torch.sqrt(1.0 - ab / ab_prev)
        mean_pred = x_start * torch.sqrt(ab_prev) + torch.sqrt(1.0 - ab_prev - sigma ** 2) * eps
        if self.eta > 0:
            if noise is None:
                raise ValueError("stochastic DDIM needs its noise draw")
            return mean_pred + _mask_t(t, mean_pred) * sigma * noise.to(mean_pred.dtype), mean_pred, sigma
        return mean_pred, mean_pred, sigma

    def step(self, model_prediction: torch.Tensor, timesteps: torch.Tensor, xt: torch.Tensor, *,
             noise: torch.Tensor | None = None, clamp_x: bool = False,
             x_prev: torch.Tensor | None = None) -> StepResult:
        del x_prev
        _, _, _, x_start = self._get_p_mean_var(model_prediction, xt, timesteps, clamp_x)
        eps = self._get_eps_from_xstart(x_start, xt, timesteps)
        x_prev_s, ddim_mean, ddim_std = self._sample_x_prev_ddim(xt, eps, x_start, timesteps, noise)
        out: StepResult = {"x_prev": x_prev_s, "estimated_x0": x_start, "x_prev_mean": ddim_mean}
        if self.eta > 0:
            out["x_prev_std"] = ddim_std
            out["logprob"] = -((x_prev_s.detach() - ddim_mean) ** 2 / (2.0 * ddim_std ** 2)
                               + torch.log(ddim_std) + 0.5 * math.log(2.0 * math.pi))
        return out


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, e^logvar1) || N(mean2, e^logvar2)), elementwise (gaussian.py:244)."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def _vp_scalars(sampler: DDPM, timesteps: torch.Tensor, ndim: int):
    """Per-sample fp32 ``alpha_bar`` and ``alpha_bar_prev`` ``[B, 1, ...]``."""
    ab = extract_into_tensor(sampler.alphas_bar, timesteps, ndim)
    abp = extract_into_tensor(sampler.alphas_bar_prev, timesteps, ndim)
    return ab, abp


def _log_snr(ab: torch.Tensor, eps_: float) -> torch.Tensor:
    """lambda = log(alpha / sigma) = 0.5 log(ab / (1 - ab)), guarded."""
    return 0.5 * torch.log(torch.clamp(ab, min=eps_) / torch.clamp(1.0 - ab, min=eps_))


@dataclasses.dataclass(frozen=True)
class DPMSolverPPGaussian(DDPM):
    """Multistep DPM-Solver++(2M) over the discrete DDPM schedule
    (gaussian.py:253): alpha = sqrt(alpha_bar), sigma = sqrt(1 - alpha_bar),
    x0 from the DDPM machinery; the first and the final step (sigma_prev =
    0) run first-order, the final one returning the data prediction."""

    name = "dpmpp_2m"
    is_multistep = True

    def init_state(self, x: torch.Tensor) -> dict:
        return {"x0_prev": torch.zeros_like(x),
                "h_last": torch.zeros((x.shape[0],) + (1,) * (x.ndim - 1), dtype=torch.float32, device=x.device),
                "has_prev": False}

    def step(self, model_prediction: torch.Tensor, timesteps: torch.Tensor, xt: torch.Tensor, *,
             noise: torch.Tensor | None = None, clamp_x: bool = False, x_prev: torch.Tensor | None = None,
             state: dict | None = None) -> StepResult:
        del noise, x_prev
        if state is None:
            raise ValueError("multistep sampler: denoise must thread init_state")
        _, _, _, x0 = self._get_p_mean_var(model_prediction, xt, timesteps, clamp_x)
        ab, abp = _vp_scalars(self, timesteps, xt.ndim)
        eps_ = 1e-12
        sigma_t = torch.sqrt(1.0 - ab)
        alpha_p, sigma_p = torch.sqrt(abp), torch.sqrt(torch.clamp(1.0 - abp, min=0.0))
        final = sigma_p <= eps_
        h = _log_snr(abp, eps_) - _log_snr(ab, eps_)
        x0f = x0.float()
        if state["has_prev"]:
            r_safe = torch.clamp(state["h_last"] / torch.clamp(h, min=eps_), min=1e-8)
            d2 = (1.0 + 1.0 / (2.0 * r_safe)) * x0f - (1.0 / (2.0 * r_safe)) * state["x0_prev"].float()
            d = torch.where(final, x0f, d2)
        else:
            d = x0f
        sig_ratio = torch.where(final, 0.0, sigma_p / torch.clamp(sigma_t, min=eps_))
        em1 = torch.where(final, -1.0, torch.expm1(-h))
        x_next = sig_ratio * xt.float() - alpha_p * em1 * d
        return {"x_prev": x_next.to(xt.dtype), "estimated_x0": x0,
                "state": {"x0_prev": x0.to(xt.dtype), "h_last": h, "has_prev": True}}


def _bh2_correction(hh_c_safe, r0c_safe, n_prev: int, m0, m_last, m_last2):
    """The UniPC-2 bh2 corrector (common.py:61) on per-sample ``[B, 1, ...]``
    gaps: ``(phi1_c, corr)``; the order-1 corrector (rho = 1/2 on D1_t)
    until two history points exist."""
    phi1_c = torch.expm1(hh_c_safe)
    d1_t = m0 - m_last
    if n_prev <= 1:
        return phi1_c, 0.5 * d1_t
    hk1 = phi1_c / hh_c_safe - 1.0
    b1 = hk1 / phi1_c
    b2 = (hk1 / hh_c_safe - 0.5) * 2.0 / phi1_c
    det = torch.where(torch.abs(1.0 - r0c_safe) > 1e-8, 1.0 - r0c_safe, 1.0)
    rho0 = (b1 - b2) / det
    rho1 = (b2 - r0c_safe * b1) / det
    return phi1_c, rho0 * ((m_last2 - m_last) / r0c_safe) + rho1 * d1_t


@dataclasses.dataclass(frozen=True)
class UniPCGaussian(DDPM):
    """UniPC-2/bh2 (arXiv:2302.04867) over the discrete DDPM schedule
    (gaussian.py:336): the UniC corrector refines the previous transition
    with this step's model evaluation, then the order-2 predictor advances."""

    name = "unipc"
    is_multistep = True

    def init_state(self, x: torch.Tensor) -> dict:
        bshape = (x.shape[0],) + (1,) * (x.ndim - 1)
        zeros = torch.zeros(bshape, dtype=torch.float32, device=x.device)
        return {"x_last": torch.zeros_like(x), "m_last": torch.zeros_like(x), "m_last2": torch.zeros_like(x),
                "lam_last": zeros, "lam_last2": zeros, "sig_last": torch.ones_like(zeros), "n_prev": 0}

    def step(self, model_prediction: torch.Tensor, timesteps: torch.Tensor, xt: torch.Tensor, *,
             noise: torch.Tensor | None = None, clamp_x: bool = False, x_prev: torch.Tensor | None = None,
             state: dict | None = None) -> StepResult:
        del noise, x_prev
        if state is None:
            raise ValueError("multistep sampler: denoise must thread init_state")
        _, _, _, x0 = self._get_p_mean_var(model_prediction, xt, timesteps, clamp_x)
        m0 = x0.float()
        ab, abp = _vp_scalars(self, timesteps, xt.ndim)
        eps_ = 1e-12
        alpha_t, sigma_t = torch.sqrt(ab), torch.sqrt(torch.clamp(1.0 - ab, min=eps_))
        alpha_p, sigma_p = torch.sqrt(abp), torch.sqrt(torch.clamp(1.0 - abp, min=0.0))
        lam_t, lam_p = _log_snr(ab, eps_), _log_snr(abp, eps_)
        n_prev = state["n_prev"]
        m_last = state["m_last"].float()

        # UniC: correct the previous transition with this step's evaluation
        if n_prev > 0:
            hh_c_safe = torch.clamp(state["lam_last"] - lam_t, max=-eps_)
            r0c = (state["lam_last2"] - state["lam_last"]) / (-hh_c_safe)
            r0c_safe = r0c if n_prev > 1 else torch.full_like(r0c, -1.0)
            phi1_c, corr = _bh2_correction(hh_c_safe, r0c_safe, n_prev, m0, m_last, state["m_last2"].float())
            x_used = ((sigma_t / torch.clamp(state["sig_last"], min=eps_)) * state["x_last"].float()
                      - alpha_t * phi1_c * m_last - alpha_t * phi1_c * corr)
        else:
            x_used = xt.float()

        # UniP: the order-2 predictor (DPMSolverPPGaussian with history)
        h = lam_p - lam_t
        final = sigma_p <= eps_
        sig_ratio = torch.where(final, 0.0, sigma_p / torch.clamp(sigma_t, min=eps_))
        em1 = torch.where(final, -1.0, torch.expm1(-h))
        base = sig_ratio * x_used - alpha_p * em1 * m0
        if n_prev == 0:
            x_next = base
        else:
            r0p_safe = torch.clamp((state["lam_last"] - lam_t) / torch.clamp(h, min=eps_), max=-1e-8)
            d1_p = (m_last - m0) / r0p_safe
            x_next = torch.where(final, base, base - alpha_p * em1 * 0.5 * d1_p)
        return {"x_prev": x_next.to(xt.dtype), "estimated_x0": x0,
                "state": {"x_last": x_used.to(xt.dtype), "m_last": m0.to(xt.dtype), "m_last2": state["m_last"],
                          "lam_last": lam_t, "lam_last2": state["lam_last"], "sig_last": sigma_t,
                          "n_prev": min(n_prev + 1, 2)}}


def _approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, means, log_scales):
    """log p(x) for images discretised to 255 bins, x in [-1, 1] (gaussian.py:437)."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = _approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = _approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus, torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))
