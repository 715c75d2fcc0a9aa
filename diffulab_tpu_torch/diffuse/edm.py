"""EDM formalization, Karras et al. 2022 (arXiv:2206.00364) (port of
diffulab_tpu/diffuse/edm.py).

The denoiser is preconditioned around the raw network F:

    D(x; sigma) = c_skip x + c_out * F(c_in x, c_noise)
    c_skip = sd^2/(sigma^2+sd^2)        c_out  = sigma*sd/sqrt(sigma^2+sd^2)
    c_in   = 1/sqrt(sigma^2+sd^2)       c_noise = ln(sigma)/4

Training draws log-normal sigmas and minimises the lambda(sigma)-weighted
D-vs-x0 MSE (or, with a frozen teacher, the MSE to its guided D: guidance
distillation). Sampling integrates ``dx/dsigma = (x - D)/sigma`` down the
Karras rho-schedule with Heun (optionally stochastic through S_churn), Euler,
DPM-Solver++(2M) or UniPC(bh2) on the VE schedule; the last interval
(sigma_min -> 0) is the exact collapse x -> D(x; sigma_min), so 18 Heun steps
make 35 model evaluations. ``timesteps`` throughout are continuous sigmas.
The loop, its random draws (``draw_noise``), inpainting, img2img,
autoguidance and block caching are the flow formalization's
(:meth:`..flow.Flow.denoise`), with the initial noise scaled by sigma_max and
the CFG interval in sigma units.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from diffulab_tpu_torch.diffuse.caching import wrap_block_cache
from diffulab_tpu_torch.diffuse.flow import NoiseFn, _tree_cat2, generator_noise, stack_intermediates
from diffulab_tpu_torch.diffuse.guidance import combine_cfg, effective_scale
from diffulab_tpu_torch.diffuse.samplers.common import F32, unipc_bh2_correction
from diffulab_tpu_torch.utils import at_least_f32, batch_broadcast

ModelFn = Callable[..., dict[str, torch.Tensor]]

EDM_SAMPLERS = ("heun", "euler", "dpmpp_2m", "unipc")


@dataclasses.dataclass(frozen=True)
class EDM:
    """Karras-EDM: preconditioning, log-normal sigma draws, rho-schedule (edm.py:36)."""

    n_steps: int = 18
    sampling_method: str = "heun"
    latent_diffusion: bool = False
    sigma_data: float = 0.5
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0
    p_mean: float = -1.2
    p_std: float = 1.2
    # stochastic sampling (S_churn > 0 re-noises each step; 0 = deterministic)
    s_churn: float = 0.0
    s_noise: float = 1.0
    # CFG shaping: [lo, hi] window in SIGMA units, and the std rescale
    guidance_interval: Sequence[float] | None = None
    guidance_rescale: float = 0.0

    def __post_init__(self):
        if self.sampling_method not in EDM_SAMPLERS:
            raise ValueError("EDM sampling_method must be 'heun', 'euler', 'dpmpp_2m', or 'unipc'")

    # --- schedule -----------------------------------------------------------
    @property
    def steps(self) -> int:
        return self.n_steps

    @property
    def timesteps(self) -> np.ndarray:
        """Karras sigma grid [n_steps+1], descending, final entry exactly 0 (fp32)."""
        i = np.arange(self.n_steps, dtype=np.float64)
        inv_rho = 1.0 / self.rho
        sig = (
            self.sigma_max**inv_rho
            + i / max(self.n_steps - 1, 1) * (self.sigma_min**inv_rho - self.sigma_max**inv_rho)
        ) ** self.rho
        return np.concatenate([sig, [0.0]]).astype(np.float32)

    def set_steps(self, n_steps: int, **kwargs: Any) -> "EDM":
        return dataclasses.replace(self, n_steps=n_steps, **kwargs)

    # --- forward process ----------------------------------------------------
    def draw_timesteps(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """Log-normal sigmas, fp32 ``[batch_size]`` on the generator's device."""
        z = torch.randn((batch_size,), generator=generator, device=generator.device, dtype=torch.float32)
        return torch.exp(self.p_mean + self.p_std * z)

    def add_noise(self, x: torch.Tensor, timesteps: torch.Tensor, noise: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        sigma = batch_broadcast(timesteps, x.ndim).to(x.dtype)
        return x + sigma * noise, noise

    # --- preconditioned model call -------------------------------------------
    def _denoised(self, model_fn: ModelFn, x: torch.Tensor, sigma: torch.Tensor, cond, drop,
                  return_prediction: bool = False):
        """D(x; sigma) in fp32 (edm.py:96); ``sigma`` is a [B] fp32 vector."""
        sd = self.sigma_data
        s = batch_broadcast(sigma, x.ndim).float()
        xf = x.float()
        c_skip = sd**2 / (s**2 + sd**2)
        c_out = s * sd / torch.sqrt(s**2 + sd**2)
        c_in = 1.0 / torch.sqrt(s**2 + sd**2)
        c_noise = torch.log(torch.clamp(sigma, min=1e-20)).float() / 4.0
        pred = model_fn(x=(c_in * xf).to(x.dtype), timesteps=c_noise, cond=cond, drop=drop)
        d = c_skip * xf + c_out * pred["x"].float()
        return (d, pred) if return_prediction else d

    def _denoised_cfg(self, model_fn, x, sigma, cond, guidance_scale, use_cfg, guide_fn=None):
        """D with CFG as one 2x call, or with an autoguidance model's D as the
        negative branch (edm.py:111); the scale's interval in sigma units."""
        b = x.shape[0]
        if not use_cfg:
            return self._denoised(model_fn, x, sigma, cond, torch.zeros((b,), dtype=torch.bool, device=x.device))
        if guide_fn is not None:
            drop = torch.zeros((b,), dtype=torch.bool, device=x.device)
            d_cond = self._denoised(model_fn, x, sigma, cond, drop)
            d_bad = self._denoised(guide_fn, x, sigma, cond, drop)
            scale = effective_scale(guidance_scale, sigma, self.guidance_interval)
            return combine_cfg(d_cond, d_bad, scale, self.guidance_rescale)
        drop = torch.cat([torch.zeros((b,), dtype=torch.bool, device=x.device),
                          torch.ones((b,), dtype=torch.bool, device=x.device)])
        d = self._denoised(model_fn, torch.cat([x, x]), torch.cat([sigma, sigma]), _tree_cat2(cond), drop)
        d_cond, d_uncond = d.chunk(2, dim=0)
        scale = effective_scale(guidance_scale, sigma, self.guidance_interval)
        return combine_cfg(d_cond, d_uncond, scale, self.guidance_rescale)

    # --- training loss ------------------------------------------------------
    def compute_loss(
        self,
        model_fn: ModelFn,
        x0: torch.Tensor,
        cond: dict[str, Any],
        timesteps: torch.Tensor,
        noise: torch.Tensor,
        drop: torch.Tensor | None = None,
        extra_losses: Sequence[Any] = (),
        extra_args: dict[str, Any] | None = None,
        distill_fn: ModelFn | None = None,
        distill_guidance: float = 0.0,
    ) -> dict[str, torch.Tensor]:
        """mean(lambda(sigma) (D(x0 + sigma n; sigma) - target)^2), lambda =
        (sigma^2 + sd^2) / (sigma sd)^2 (edm.py:136); the target is x0, or the
        frozen teacher's guided D at ``distill_guidance``. Each extra loss
        (REPA) is called on the raw model output with D in ``"x"``, with x0
        and then ``extra_args`` as keywords (edm.py:169-173)."""
        xt, noise = self.add_noise(x0, timesteps, noise)
        if drop is None:
            drop = torch.zeros((x0.shape[0],), dtype=torch.bool, device=x0.device)
        denoised, prediction = self._denoised(model_fn, xt, timesteps, cond, drop, return_prediction=True)
        sd = self.sigma_data
        s = batch_broadcast(timesteps, x0.ndim).float()
        weight = (s**2 + sd**2) / (s * sd) ** 2
        target = x0.float()
        if distill_fn is not None:
            with torch.no_grad():
                target = self._denoised_cfg(distill_fn, xt, timesteps, cond, distill_guidance, use_cfg=True)
        loss_dict = {"loss": torch.mean(weight * (denoised - target) ** 2)}
        for extra_loss in extra_losses:
            loss_dict[extra_loss.name] = extra_loss(model_output={**prediction, "x": denoised},
                                                    **{"x0": x0, **(extra_args or {})})
        return loss_dict

    # --- sampling -----------------------------------------------------------
    def one_step_denoise(
        self,
        model_fn: ModelFn,
        x: torch.Tensor,
        cond: dict[str, Any],
        sigma_next: float,
        sigma: float,
        guidance_scale: float = 0.0,
        use_cfg: bool = False,
        noise: torch.Tensor | None = None,
        sampler_args: dict[str, Any] | None = None,
        guide_fn: ModelFn | None = None,
    ) -> dict[str, Any]:
        """One Karras step sigma -> sigma_next (edm.py:180): 'heun' (two
        evals), 'euler', or the multistep 'dpmpp_2m' / 'unipc' on the VE
        schedule with their state in ``sampler_args['state']``. ``noise`` is
        the S_churn draw (used when ``s_churn > 0``)."""
        b = x.shape[0]
        sigma, sigma_next = F32(sigma), F32(sigma_next)
        sig = torch.full((b,), float(sigma), dtype=torch.float32, device=x.device)

        if self.sampling_method == "unipc":
            state = (sampler_args or {})["state"]
            m0 = self._denoised_cfg(model_fn, x, sig, cond, guidance_scale, use_cfg, guide_fn)
            lam_curr = F32(-np.log(max(sigma, F32(1e-12))))
            n_prev = state["n_prev"]
            m_last = at_least_f32(state["m_last"])
            # UniC: correct the previous transition with this step's eval
            if n_prev > 0:
                hh_c_safe = F32(state["lam_last"] - lam_curr)
                r0c_safe = F32((state["lam_last2"] - state["lam_last"]) / -hh_c_safe) if n_prev > 1 else F32(-1.0)
                phi1_c, corr = unipc_bh2_correction(hh_c_safe, r0c_safe, n_prev, m0, m_last,
                                                    at_least_f32(state["m_last2"]))
                x_used = (float(F32(np.exp(hh_c_safe))) * at_least_f32(state["x_last"])
                          - float(phi1_c) * m_last - float(phi1_c) * corr)
            else:
                x_used = at_least_f32(x)
            # UniP: order-2 predictor (== dpmpp_2m when history exists)
            hh = F32(-np.log(sigma / max(sigma_next, F32(1e-12))))
            phi1 = F32(np.expm1(hh))
            base = float(F32(np.exp(hh))) * x_used - float(phi1) * m0
            if n_prev == 0:
                x_next = base
            else:
                r0p = F32((state["lam_last"] - lam_curr) / -hh)
                x_next = base - float(phi1 * F32(0.5)) * ((m_last - m0) / float(r0p))
            return {
                "x_prev": x_next.to(x.dtype),
                "estimated_x0": m0.to(x.dtype),
                "state": {"x_last": x_used.to(x.dtype), "m_last": m0.to(x.dtype), "m_last2": state["m_last"],
                          "lam_last": lam_curr, "lam_last2": state["lam_last"], "n_prev": min(n_prev + 1, 2)},
            }

        if self.sampling_method == "dpmpp_2m":
            state = (sampler_args or {})["state"]
            d0 = self._denoised_cfg(model_fn, x, sig, cond, guidance_scale, use_cfg, guide_fn)
            # lambda = ln(1/sigma); h = ln(sigma / sigma_next)
            h = F32(np.log(sigma / max(sigma_next, F32(1e-12))))
            if state["has_prev"]:
                r_safe = max(F32(state["h_last"] / max(h, F32(1e-12))), F32(1e-8))
                c = F32(1.0) / (F32(2.0) * r_safe)
                d = float(F32(1.0) + c) * d0 - float(c) * at_least_f32(state["x0_prev"])
            else:
                d = d0
            # VE update: x_next = (sig_next/sig) x - (e^{-h} - 1) D, e^{-h} = sig_next/sig
            ratio = F32(sigma_next / max(sigma, F32(1e-12)))
            x_next = float(ratio) * at_least_f32(x) + float(F32(1.0) - ratio) * d
            return {
                "x_prev": x_next.to(x.dtype),
                "estimated_x0": d0.to(x.dtype),
                "state": {"x0_prev": d0.to(x.dtype), "h_last": h, "has_prev": True},
            }

        if self.s_churn > 0 and noise is not None:
            gamma = F32(min(self.s_churn / self.n_steps, float(np.sqrt(2.0) - 1.0)))
            sig_hat = sig * float(F32(1.0) + gamma)
            extra = torch.sqrt(torch.clamp(sig_hat**2 - sig**2, min=0.0))
            eps = noise.to(x.dtype) * self.s_noise
            x = x + batch_broadcast(extra, x.ndim).to(x.dtype) * eps
            sig = sig_hat

        d0 = self._denoised_cfg(model_fn, x, sig, cond, guidance_scale, use_cfg, guide_fn)
        sigv = batch_broadcast(sig, x.ndim)
        dxds = (x.float() - d0) / sigv
        dt = float(sigma_next) - sigv
        x_euler = x.float() + dt * dxds
        if self.sampling_method == "heun":
            # denoise never takes a Heun step INTO sigma = 0 (the final step is the exact collapse)
            sig_next_b = torch.full((b,), float(sigma_next), dtype=torch.float32, device=x.device)
            d1 = self._denoised_cfg(model_fn, x_euler.to(x.dtype), sig_next_b, cond, guidance_scale, use_cfg,
                                    guide_fn)
            x_next = x.float() + dt * 0.5 * (dxds + (x_euler - d1) / float(sigma_next))
        else:
            x_next = x_euler
        return {"x_prev": x_next.to(x.dtype), "estimated_x0": d0.to(x.dtype)}

    def init_state(self, x: torch.Tensor) -> dict | None:
        """The multistep state of 'dpmpp_2m' and 'unipc' (edm.py:352-366); None otherwise."""
        if self.sampling_method == "dpmpp_2m":
            return {"x0_prev": torch.zeros_like(x), "h_last": F32(0.0), "has_prev": False}
        if self.sampling_method == "unipc":
            zeros = torch.zeros_like(x)
            return {"x_last": zeros, "m_last": zeros, "m_last2": zeros,
                    "lam_last": F32(0.0), "lam_last2": F32(0.0), "n_prev": 0}
        return None

    def denoise(
        self,
        model_fn: ModelFn,
        cond: dict[str, Any],
        generator: torch.Generator | None = None,
        data_shape: tuple[int, ...] | None = None,
        x: torch.Tensor | None = None,
        clamp_x: bool = False,
        guidance_scale: float = 0.0,
        use_cfg: bool = False,
        return_intermediates: bool = False,
        dtype: torch.dtype = torch.float32,
        device: torch.device | None = None,
        inpaint: dict[str, torch.Tensor] | None = None,
        img2img_init: torch.Tensor | None = None,
        img2img_strength: float = 1.0,
        guide_fn: ModelFn | None = None,
        block_cache0: Any = None,
        cache_interval: int = 1,
        draw_noise: NoiseFn | None = None,
    ) -> dict[str, torch.Tensor]:
        """The Karras reverse ODE (edm.py:304): initial noise scaled by
        sigma_max; all but the final interval through the solver, then the
        exact, uncached collapse x -> D(x; sigma_min). ``inpaint`` blends
        ``known + sigma * noise`` after every step and the clean known at the
        end; ``img2img_init`` starts from ``init + sigma_start * noise``; the
        intermediates' ``xt`` and ``estimated_x0`` end with the collapse."""
        draw = draw_noise or generator_noise(generator, device)
        ts = self.timesteps
        start_idx = 0
        if img2img_init is not None:
            k = min(max(int(round(img2img_strength * self.n_steps)), 1), self.n_steps)
            start_idx = self.n_steps - k
            noise = draw("img2img", 0, tuple(img2img_init.shape), dtype)
            x = img2img_init.to(dtype) + float(ts[start_idx]) * noise
        if x is None:
            if data_shape is None:
                raise ValueError("'data_shape' must be provided if 'x' is not given")
            x = draw("init", 0, tuple(data_shape), dtype) * self.sigma_max
        x0 = x
        s_state = self.init_state(x)
        mcache = block_cache0 if block_cache0 is not None else ()
        ys = []
        for step_idx, (sigma, sigma_next) in enumerate(zip(ts[start_idx:-2], ts[start_idx + 1:-1])):
            # the final sigma_min -> 0 collapse below stays uncached (exact)
            step_model_fn, step_guide_fn, cell = wrap_block_cache(
                model_fn, guide_fn, mcache, step_idx, cache_interval, enabled=block_cache0 is not None)
            churn = self.s_churn > 0 and self.sampling_method in ("heun", "euler")
            step = self.one_step_denoise(
                step_model_fn, x, cond, sigma_next, sigma, guidance_scale=guidance_scale, use_cfg=use_cfg,
                noise=draw("churn", step_idx, tuple(x.shape), x.dtype) if churn else None,
                sampler_args={"state": s_state} if s_state is not None else None, guide_fn=step_guide_fn,
            )
            mcache = cell["c"]
            s_state = step.pop("state", s_state)
            x_next = step["x_prev"]
            if inpaint is not None:
                known = inpaint["known"].to(x_next.dtype)
                noise = draw("inpaint", step_idx, tuple(known.shape), x_next.dtype)
                mask = inpaint["mask"].to(x_next.dtype)
                # sigma_next is an fp32 0-d array in the reference: a bf16 noise promotes
                x_next = mask * (known + float(F32(sigma_next)) * at_least_f32(noise)) + (1.0 - mask) * x_next
                step["x_prev"] = x_next
            if return_intermediates:
                ys.append(step)
            x = x_next.to(x.dtype)
        sig_last = torch.full((x.shape[0],), float(ts[-2]), dtype=torch.float32, device=x.device)
        x_final = self._denoised_cfg(model_fn, x, sig_last, cond, guidance_scale, use_cfg, guide_fn).to(x.dtype)
        if inpaint is not None:
            mask = inpaint["mask"].to(x_final.dtype)
            x_final = mask * inpaint["known"].to(x_final.dtype) + (1.0 - mask) * x_final
        if clamp_x:
            x_final = torch.clamp(x_final, -1.0, 1.0)
        out = {"x": x_final}
        if return_intermediates and ys:
            inter = stack_intermediates(x0, ys)
            out["xt"] = torch.cat([inter["xt"], x_final[:, None]], dim=1)
            out["estimated_x0"] = torch.cat([inter["estimated_x0"], x_final[:, None]], dim=1)
        return out
