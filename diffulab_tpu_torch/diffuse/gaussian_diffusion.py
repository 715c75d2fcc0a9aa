"""Gaussian (DDPM) diffusion formalization (port of
diffulab_tpu/diffuse/gaussian_diffusion.py).

The beta tables (linear or cosine) are built on the host in float64 and
gathered as fp32 (:mod:`.schedules`); respacing selects a subset of the
training timesteps and recomputes the betas over them, with a
``timestep_map`` back to the training indices the model sees. The training
loss is the MSE of an epsilon, x0 or v head, optionally min-SNR weighted,
plus the Improved-DDPM hybrid VLB term under a learned-range variance. The
reference's ``lax.scan`` reverse process becomes a Python loop over the
descending step indices, with classifier-free guidance as one batched 2x
model call per step (or, with an autoguidance model, a conditional call of
each), any of the four samplers (:mod:`.samplers.gaussian`), block caching
(:mod:`.caching`), RePaint-lite inpainting, SDEdit img2img and the per-step
intermediates in batch-major layout.

Every random draw of the loop (initial noise, img2img start, the DDPM and
stochastic-DDIM step noise, inpaint re-noising) goes through one
``draw_noise(kind, step, shape, dtype)`` callable, by default standard
normals from the caller's generator (trap T4).
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property
from typing import Any, Callable, Sequence

import numpy as np
import torch

from diffulab_tpu_torch.diffuse.caching import wrap_block_cache
from diffulab_tpu_torch.diffuse.flow import NoiseFn, _tree_cat2, generator_noise
from diffulab_tpu_torch.diffuse.guidance import combine_cfg, effective_scale
from diffulab_tpu_torch.diffuse.samplers.common import StepResult
from diffulab_tpu_torch.diffuse.samplers.gaussian import (
    DDIM,
    DDPM,
    DPMSolverPPGaussian,
    UniPCGaussian,
    discretized_gaussian_log_likelihood,
    normal_kl,
)
from diffulab_tpu_torch.diffuse.schedules import extract_into_tensor, get_variance_schedule, respace_betas, space_timesteps

ModelFn = Callable[..., dict[str, torch.Tensor]]

SAMPLER_REGISTRY = {
    "ddpm": DDPM,
    "ddim": DDIM,
    "dpmpp_2m": DPMSolverPPGaussian,
    "unipc": UniPCGaussian,
}

_LEARNED = ("learned", "learned_range")


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """DDPM (Ho et al. 2020) with respacing and selectable samplers (gaussian_diffusion.py:56)."""

    n_steps: int = 1000
    sampling_method: str = "ddpm"
    schedule: str = "linear"
    latent_diffusion: bool = False
    sampler_parameters: dict[str, Any] = dataclasses.field(default_factory=dict)
    sampling_steps: int | None = None
    section_counts: int | str | None = None
    prediction_type: str = "epsilon"
    loss_weighting: str = "none"
    min_snr_gamma: float = 5.0
    guidance_interval: Sequence[float] | None = None
    guidance_rescale: float = 0.0

    def __post_init__(self):
        if self.sampling_method not in SAMPLER_REGISTRY:
            raise ValueError(f"sampling method must be one of {list(SAMPLER_REGISTRY)}")
        if self.prediction_type not in ("epsilon", "xstart", "v"):
            raise ValueError("prediction_type must be 'epsilon', 'xstart', or 'v'")
        if self.loss_weighting not in ("none", "min_snr"):
            raise ValueError("loss_weighting must be 'none' or 'min_snr'")
        if self.prediction_type != "epsilon" and self.sampler_parameters.get("mean_type", "epsilon") != "epsilon":
            raise ValueError("non-epsilon prediction_type requires the sampler's default mean_type='epsilon' "
                             "(the head is converted to epsilon before sampling)")

    @property
    def training_steps(self) -> int:
        return self.n_steps

    @property
    def steps(self) -> int:
        return self.sampling_steps if self.sampling_steps is not None else self.n_steps

    @cached_property
    def _tables(self) -> tuple[np.ndarray, np.ndarray | None]:
        """(betas, timestep_map) after the optional respacing (gaussian_diffusion.py:122)."""
        betas = get_variance_schedule(self.training_steps, self.schedule)
        section_counts = self.section_counts
        if self.steps != self.training_steps:
            section_counts = section_counts or self.steps
        if section_counts:
            use = space_timesteps(self.training_steps, section_counts, ddim=self.sampling_method == "ddim")
            return respace_betas(betas, use)
        return betas, None

    @property
    def betas(self) -> np.ndarray:
        return self._tables[0]

    @property
    def timestep_map(self) -> np.ndarray | None:
        return self._tables[1]

    @cached_property
    def alphas_bar(self) -> np.ndarray:
        return np.cumprod(1.0 - self.betas)

    @cached_property
    def sqrt_alphas_bar(self) -> np.ndarray:
        return np.sqrt(self.alphas_bar)

    @cached_property
    def sampler(self):
        return SAMPLER_REGISTRY[self.sampling_method](**self.sampler_parameters).with_betas(self.betas)

    @property
    def _learned_var(self) -> bool:
        return self.sampler.var_type in _LEARNED

    def set_steps(self, n_steps: int, schedule: str | None = None,
                  section_counts: int | str | None = None) -> "GaussianDiffusion":
        """A formalization with another sampling grid and its respaced tables;
        the training steps stay (gaussian_diffusion.py:159)."""
        return dataclasses.replace(self, schedule=schedule or self.schedule, sampling_steps=n_steps,
                                   section_counts=section_counts)

    # --- forward process ------------------------------------------------------
    def draw_timesteps(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """Uniform step indices ``[0, steps)`` on the generator's device."""
        return torch.randint(0, self.steps, (batch_size,), generator=generator, device=generator.device)

    def add_noise(self, x: torch.Tensor, timesteps: torch.Tensor, noise: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """``sqrt(ab) x + sqrt(1 - ab) noise`` with the table values cast to
        x's dtype first, as the reference does (gaussian_diffusion.py:175)."""
        sab = extract_into_tensor(self.sqrt_alphas_bar, timesteps, x.ndim).to(x.dtype)
        ab = extract_into_tensor(self.alphas_bar, timesteps, x.ndim).to(x.dtype)
        return sab * x + torch.sqrt(1.0 - ab) * noise, noise

    def _map_timesteps(self, timesteps: torch.Tensor) -> torch.Tensor:
        """Respaced step indices -> the training timesteps the model sees."""
        if self.timestep_map is not None:
            return torch.as_tensor(self.timestep_map, device=timesteps.device)[timesteps.long()]
        return timesteps

    # --- training loss ----------------------------------------------------------
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
        vlb_weight: float = 1e-3,
        distill_fn: ModelFn | None = None,
        distill_guidance: float = 0.0,
    ) -> dict[str, torch.Tensor]:
        """The head's MSE to its target (gaussian_diffusion.py:183), min-SNR
        weighted if asked, plus under a learned variance the hybrid VLB term
        ``vlb`` (the mean detached, so only the variance trains through it;
        the discretised NLL at t = 0). With ``distill_fn`` (a frozen teacher)
        the target is its guided head at ``distill_guidance``. Each extra loss
        (REPA) is called on the model's output, with x0 and then
        ``extra_args`` as keywords (gaussian_diffusion.py:276-279)."""
        xt, noise = self.add_noise(x0, timesteps, noise)
        if drop is None:
            drop = torch.zeros((x0.shape[0],), dtype=torch.bool, device=x0.device)
        model_timesteps = self._map_timesteps(timesteps)
        prediction = model_fn(x=xt, timesteps=model_timesteps, cond=cond, drop=drop)
        out = prediction["x"].float()
        learned_var = self._learned_var
        head = out.chunk(2, dim=-1)[0] if learned_var else out
        if distill_fn is not None:
            if learned_var:
                raise ValueError("guidance distillation requires a fixed-variance gaussian student")
            b = xt.shape[0]
            with torch.no_grad():
                drop2 = torch.cat([torch.zeros((b,), dtype=torch.bool, device=xt.device),
                                   torch.ones((b,), dtype=torch.bool, device=xt.device)])
                t_out = distill_fn(x=torch.cat([xt, xt]), timesteps=torch.cat([model_timesteps, model_timesteps]),
                                   cond=_tree_cat2(cond), drop=drop2)["x"]
                t_cond, t_uncond = t_out.chunk(2, dim=0)
                frac = timesteps.float() / max(self.training_steps - 1, 1)
                scale = effective_scale(distill_guidance, frac, self.guidance_interval)
                target = combine_cfg(t_cond, t_uncond, scale, self.guidance_rescale).float()
        else:
            target = self._training_target(x0, noise, timesteps, xt)
        if self.loss_weighting == "min_snr":
            ab = torch.as_tensor(np.asarray(self.alphas_bar, np.float32), device=x0.device)[timesteps.long()]
            snr = ab / (1.0 - ab)
            capped = torch.clamp(snr, max=self.min_snr_gamma)
            w = {"epsilon": capped / snr, "xstart": capped, "v": capped / (snr + 1.0)}[self.prediction_type]
            mse = torch.mean((head - target) ** 2, dim=tuple(range(1, head.ndim)))
            loss = torch.mean(w * mse)
        else:
            loss = torch.mean((head - target) ** 2)
        loss_dict = {"loss": loss}

        if learned_var:
            eps_pred = self._head_to_eps(head, xt, timesteps)
            frozen = torch.cat([eps_pred.detach(), out[..., eps_pred.shape[-1]:]], dim=-1)
            mean, _, log_var, _ = self.sampler._get_p_mean_var(frozen, xt, timesteps)
            q_mean = self.sampler._get_mean_from_x_start(xt, x0, timesteps)
            q_log_var = extract_into_tensor(self.sampler.posterior_log_variance_clipped, timesteps, xt.ndim)
            kl = normal_kl(q_mean, q_log_var, mean, log_var) / math.log(2.0)
            nll = -discretized_gaussian_log_likelihood(x0, mean, 0.5 * log_var) / math.log(2.0)
            t_mask = (timesteps == 0).reshape(-1, *([1] * (xt.ndim - 1)))
            vlb = torch.where(t_mask, nll, kl)
            loss_dict["vlb"] = vlb_weight * vlb.reshape(vlb.shape[0], -1).mean(dim=-1).mean()
        for extra_loss in extra_losses:
            loss_dict[extra_loss.name] = extra_loss(model_output=prediction, **{"x0": x0, **(extra_args or {})})
        return loss_dict

    # --- prediction-parametrization conversions -------------------------------
    def _alpha_sigma(self, timesteps: torch.Tensor, ndim: int):
        ab = extract_into_tensor(self.alphas_bar, timesteps, ndim)
        return torch.sqrt(ab), torch.sqrt(1.0 - ab)

    def _training_target(self, x0, noise, timesteps, xt):
        if self.prediction_type == "epsilon":
            return noise
        if self.prediction_type == "xstart":
            return x0.float()
        alpha, sigma = self._alpha_sigma(timesteps, xt.ndim)
        return alpha * noise.float() - sigma * x0.float()

    def _head_to_eps(self, head, xt, timesteps):
        """The first-C-channels head as epsilon (affine in the head for fixed
        xt and t, so it commutes with the CFG combination)."""
        if self.prediction_type == "epsilon":
            return head
        alpha, sigma = self._alpha_sigma(timesteps, xt.ndim)
        alpha, sigma, xt = alpha.to(head.dtype), sigma.to(head.dtype), xt.to(head.dtype)
        if self.prediction_type == "xstart":
            return (xt - alpha * head) / torch.clamp(sigma, min=1e-12)
        return sigma * xt + alpha * head  # v: eps = sigma xt + alpha v

    def _prediction_to_eps(self, prediction, xt, timesteps):
        """The full model output in epsilon form (variance channels untouched)."""
        if self.prediction_type == "epsilon":
            return prediction
        if self._learned_var:
            head, var = prediction.chunk(2, dim=-1)
            return torch.cat([self._head_to_eps(head, xt, timesteps), var], dim=-1)
        return self._head_to_eps(prediction, xt, timesteps)

    def _guided(self, pred_cond, pred_other, scale):
        """CFG combination; under a learned variance the mean head only, the
        conditional variance kept."""
        if self._learned_var:
            head_c, var_c = pred_cond.chunk(2, dim=-1)
            head_o, _ = pred_other.chunk(2, dim=-1)
            return torch.cat([combine_cfg(head_c, head_o, scale, self.guidance_rescale), var_c], dim=-1)
        return combine_cfg(pred_cond, pred_other, scale, self.guidance_rescale)

    # --- one reverse step ---------------------------------------------------------
    def one_step_denoise(
        self,
        model_fn: ModelFn,
        x: torch.Tensor,
        cond: dict[str, Any],
        t: int,
        clamp_x: bool = False,
        guidance_scale: float = 0.0,
        use_cfg: bool = False,
        noise: torch.Tensor | None = None,
        sampler_args: dict[str, Any] | None = None,
        guide_fn: ModelFn | None = None,
    ) -> StepResult:
        """One reverse step from respaced index ``t`` (gaussian_diffusion.py:321);
        ``noise`` is the stochastic samplers' draw."""
        batch = x.shape[0]
        timesteps = torch.full((batch,), int(t), dtype=torch.long, device=x.device)
        model_timesteps = self._map_timesteps(timesteps)
        zeros = torch.zeros((batch,), dtype=torch.bool, device=x.device)
        if use_cfg:
            # the interval is a fraction of the training schedule, invariant under respacing
            frac = model_timesteps.float() / max(self.training_steps - 1, 1)
            scale = effective_scale(guidance_scale, frac, self.guidance_interval)
            if guide_fn is not None:  # autoguidance: the negative branch is a degraded model's conditional call
                pred_cond = model_fn(x=x, timesteps=model_timesteps, cond=cond, drop=zeros)["x"]
                pred_bad = guide_fn(x=x, timesteps=model_timesteps, cond=cond, drop=zeros)["x"]
                prediction = self._guided(pred_cond, pred_bad, scale)
            else:
                drop = torch.cat([zeros, torch.ones_like(zeros)])
                out = model_fn(x=torch.cat([x, x]), timesteps=torch.cat([model_timesteps, model_timesteps]),
                               cond=_tree_cat2(cond), drop=drop)["x"]
                pred_cond, pred_uncond = out.chunk(2, dim=0)
                prediction = self._guided(pred_cond, pred_uncond, scale)
        else:
            prediction = model_fn(x=x, timesteps=model_timesteps, cond=cond, drop=zeros)["x"]
        prediction = self._prediction_to_eps(prediction, x, timesteps)
        return self.sampler.step(prediction, timesteps, x, noise=noise, clamp_x=clamp_x, **(sampler_args or {}))

    def _stochastic(self) -> bool:
        return type(self.sampler) is DDPM or (isinstance(self.sampler, DDIM) and self.sampler.eta > 0)

    # --- the reverse process ---------------------------------------------------------
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
        """The ancestral / DDIM / multistep reverse process over the respaced
        indices ``start .. 0`` (gaussian_diffusion.py:393), the carry kept in
        its starting dtype. ``inpaint = {"known", "mask"}`` (mask 1 = keep)
        blends the known image q-sampled to each step's result index, and the
        clean known exactly at the end; ``img2img_init`` is q-sampled to the
        respaced index ``round(strength * steps) - 1`` and only that tail runs.
        Returns ``{"x"}`` and, with ``return_intermediates``, ``xt`` [B,
        steps+1, ...] from the start, ``estimated_x0`` and the sampler's
        ``xt_mean``, ``xt_std``, ``logprob``, batch-major."""
        draw = draw_noise or generator_noise(generator, device)
        start = self.steps - 1
        if img2img_init is not None:
            k = min(max(int(round(img2img_strength * self.steps)), 1), self.steps)
            start = k - 1
            init = img2img_init.to(dtype)
            noise = draw("img2img", 0, tuple(init.shape), dtype)
            x, _ = self.add_noise(init, torch.full((init.shape[0],), start, dtype=torch.long, device=init.device),
                                  noise)
        if x is None:
            if data_shape is None:
                raise ValueError("'data_shape' must be provided if 'x' is not given")
            x = draw("init", 0, tuple(data_shape), dtype)
        x_start = x
        multistep = getattr(self.sampler, "is_multistep", False)
        s_state = self.sampler.init_state(x) if multistep else None
        stochastic = self._stochastic()
        mcache = block_cache0 if block_cache0 is not None else ()
        sqrt_ab, ab = np.float32(self.sqrt_alphas_bar), np.float32(self.alphas_bar)
        ys = []
        for step_idx, t in enumerate(range(start, -1, -1)):
            step_model_fn, step_guide_fn, cell = wrap_block_cache(
                model_fn, guide_fn, mcache, step_idx, cache_interval, enabled=block_cache0 is not None)
            noise = (draw("step", step_idx, tuple(x.shape), torch.promote_types(x.dtype, torch.float32))
                     if stochastic else None)
            step = self.one_step_denoise(
                step_model_fn, x, cond, t, clamp_x=clamp_x, guidance_scale=guidance_scale, use_cfg=use_cfg,
                noise=noise, sampler_args={"state": s_state} if multistep else None, guide_fn=step_guide_fn)
            mcache = cell["c"]
            s_state = step.pop("state", s_state)
            x_next = step["x_prev"]
            if inpaint is not None:
                # the step's result sits at index t - 1 (the clean x0 when t == 0)
                known = inpaint["known"].float()
                ip_noise = draw("inpaint", step_idx, tuple(known.shape), torch.float32)
                if t > 0:
                    known = float(sqrt_ab[t - 1]) * known + float(np.sqrt(np.float32(1.0) - ab[t - 1])) * ip_noise
                mask = inpaint["mask"].float()
                x_next = (mask * known + (1.0 - mask) * x_next.float()).to(x_next.dtype)
                step["x_prev"] = x_next
            if return_intermediates:
                ys.append(step)
            x = x_next.to(x.dtype)
        if inpaint is not None:
            mask = inpaint["mask"].to(x.dtype)
            x = mask * inpaint["known"].to(x.dtype) + (1.0 - mask) * x
        out: dict[str, torch.Tensor] = {"x": x}
        if return_intermediates and ys:
            out["xt"] = torch.cat([x_start[:, None], torch.stack([y["x_prev"] for y in ys], dim=1)], dim=1)
            out["estimated_x0"] = torch.stack([y["estimated_x0"] for y in ys], dim=1)
            for src, dst in (("x_prev_mean", "xt_mean"), ("x_prev_std", "xt_std"), ("logprob", "logprob")):
                if src in ys[0]:
                    out[dst] = torch.stack([y[src] for y in ys], dim=1)
        return out
