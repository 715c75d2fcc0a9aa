"""Rectified-flow / flow-matching formalization (port of
diffulab_tpu/diffuse/flow.py).

The forward process is ``x_t = (1 - t)·x0 + t·eps``; the training loss is the
MSE between the model velocity and ``eps - x0`` (with the x-prediction
conversion ``v = (x_t - x0_hat) / t``); timesteps are drawn uniform or
logit-normal with a ``torch.Generator``, optionally time-shifted. The reverse
process runs the reference's ``lax.scan`` as a Python loop over the fp32
timestep grid, with classifier-free guidance as ONE batched 2x model call per
step. The model is an opaque callable ``model_fn(x, timesteps, cond, drop)``
returning ``{"x": prediction}``.

Not ported yet (they raise ``NotImplementedError``): extra losses (REPA,
ROADMAP item 13), guidance distillation, samplers other than Euler,
inpainting, img2img, autoguidance, block caching and the GRPO loss (items 7,
15, 16).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Any, Callable, Sequence

import numpy as np
import torch

from diffulab_tpu_torch.diffuse.guidance import combine_cfg, effective_scale
from diffulab_tpu_torch.diffuse.samplers.common import StepResult
from diffulab_tpu_torch.diffuse.samplers.flow import Euler
from diffulab_tpu_torch.diffuse.schedules import flow_linear_timesteps, shift_timestep
from diffulab_tpu_torch.utils import at_least_f32, batch_broadcast, flatten_nonbatch_mean

ModelFn = Callable[..., dict[str, torch.Tensor]]

SAMPLER_REGISTRY = {"euler": Euler}
#: samplers of the reference that this port does not have yet
_UNPORTED_SAMPLERS = ("euler_maruyama", "heun", "dpmpp_2m", "unipc")


def _tree_cat2(c: Any) -> Any:
    """``[c; c]`` along the batch for every tensor of a nested ``cond`` (dicts,
    lists and tuples; None stays None), as ``jax.tree.map`` does in the
    reference (flow.py:97): a txt2img ``cond`` is
    ``{"context": {"embeddings": ..., "attn_mask": ...}}``."""
    if c is None:
        return None
    if isinstance(c, dict):
        return {key: _tree_cat2(value) for key, value in c.items()}
    if isinstance(c, (list, tuple)):
        return type(c)(_tree_cat2(value) for value in c)
    return torch.cat([c, c], dim=0)


def _cfg_model_call(
    model_fn: ModelFn,
    x: torch.Tensor,
    t_vec: torch.Tensor,
    cond: dict[str, Any],
    guidance_scale: float,
    use_cfg: bool,
    guidance_interval: Sequence[float] | None = None,
    guidance_rescale: float = 0.0,
) -> torch.Tensor:
    """Model forward with classifier-free guidance as ONE batched 2x call
    (flow.py:55): [x; x] with the second half's condition dropped, then
    ``uncond + scale * (cond - uncond)`` in fp32 (T8, see :func:`combine_cfg`)."""
    batch = x.shape[0]
    if not use_cfg:
        drop = torch.zeros((batch,), dtype=torch.bool, device=x.device)
        return model_fn(x=x, timesteps=t_vec, cond=cond, drop=drop)["x"]

    x2 = torch.cat([x, x], dim=0)
    t2 = torch.cat([t_vec, t_vec], dim=0)
    cond2 = _tree_cat2(cond)
    drop = torch.cat([torch.zeros((batch,), dtype=torch.bool, device=x.device),
                      torch.ones((batch,), dtype=torch.bool, device=x.device)])
    out = model_fn(x=x2, timesteps=t2, cond=cond2, drop=drop)["x"]
    out_cond, out_uncond = out.chunk(2, dim=0)
    scale = effective_scale(guidance_scale, t_vec, guidance_interval)
    return combine_cfg(out_cond, out_uncond, scale, guidance_rescale)


@dataclasses.dataclass(frozen=True)
class Flow:
    """Continuous-time flow matching (Lipman et al. 2022)."""

    n_steps: int = 50
    sampling_method: str = "euler"
    schedule: str = "linear"
    latent_diffusion: bool = False
    logits_normal: bool = False
    shift: float | None = None
    prediction_type: str = "v"
    sampler_parameters: dict[str, Any] = dataclasses.field(default_factory=dict)
    guidance_interval: Sequence[float] | None = None
    guidance_rescale: float = 0.0

    def __post_init__(self):
        if self.prediction_type not in ("v", "x"):
            raise ValueError("prediction_type must be 'v' or 'x'; noise prediction is not "
                             "supported for flow models")
        if self.schedule != "linear":
            raise NotImplementedError("Only the linear schedule is supported for flow models")
        if self.sampling_method in _UNPORTED_SAMPLERS:
            raise NotImplementedError(f"the {self.sampling_method!r} sampler is not ported yet "
                                      "(ROADMAP queue 1, items 7 and 15)")
        if self.sampling_method not in SAMPLER_REGISTRY:
            raise ValueError(f"sampling method must be one of {list(SAMPLER_REGISTRY)}")

    @property
    def x_prediction(self) -> bool:
        return self.prediction_type == "x"

    @property
    def steps(self) -> int:
        return self.n_steps

    @cached_property
    def timesteps(self) -> np.ndarray:
        """Descending grid 1 -> 0 with ``n_steps + 1`` points (fp32)."""
        return flow_linear_timesteps(self.n_steps, self.shift)

    @cached_property
    def sampler(self):
        s = SAMPLER_REGISTRY[self.sampling_method](**self.sampler_parameters)
        return s.with_timesteps(self.timesteps)

    def set_steps(self, n_steps: int, schedule: str = "linear", shift: float | None = None) -> "Flow":
        """A new Flow with another timestep grid."""
        return dataclasses.replace(self, n_steps=n_steps, schedule=schedule, shift=shift)

    # --- forward process ----------------------------------------------------
    def at(self, timesteps: torch.Tensor) -> torch.Tensor:
        return 1.0 - timesteps

    def bt(self, timesteps: torch.Tensor) -> torch.Tensor:
        return timesteps

    def draw_timesteps(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """fp32 ``[batch_size]`` on the generator's device (flow.py:161):
        logit-normal or uniform, then the shift, then the x-prediction clip."""
        kw = dict(generator=generator, device=generator.device, dtype=torch.float32)
        if self.logits_normal:
            t = torch.sigmoid(torch.randn((batch_size,), **kw))
        else:
            t = torch.rand((batch_size,), **kw)
        if self.shift is not None:
            t = shift_timestep(t, self.shift)
        if self.x_prediction:
            t = torch.clamp(t, min=0.05)
        return t

    def add_noise(
        self, x: torch.Tensor, timesteps: torch.Tensor, noise: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(at·x + bt·noise, noise)`` with at/bt cast to x's dtype first, as
        the reference does (flow.py:175-176): at bf16 x the mix is bf16 (T10)."""
        at = batch_broadcast(self.at(timesteps), x.ndim).to(x.dtype)
        bt = batch_broadcast(self.bt(timesteps), x.ndim).to(x.dtype)
        return at * x + bt * noise, noise

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
        """Flow-matching MSE (flow.py:180), with t, noise and the CFG drop
        mask given by the caller. ``(noise - x0)`` is formed in x0's dtype and
        only then promoted against the fp32 prediction (T10)."""
        del extra_args
        if distill_fn is not None:
            raise NotImplementedError("guidance distillation is not ported yet (ROADMAP queue 1, item 15)")
        if extra_losses:
            raise NotImplementedError("extra losses (REPA) are not ported yet (ROADMAP queue 1, item 13)")
        xt, noise = self.add_noise(x0, timesteps, noise)
        if drop is None:
            drop = torch.zeros((x0.shape[0],), dtype=torch.bool, device=x0.device)
        v_pred = model_fn(x=xt, timesteps=timesteps, cond=cond, drop=drop)["x"]
        if self.x_prediction:
            # bf16 / fp32 [B,1,..] promotes to fp32, as in JAX
            v_pred = (xt - v_pred) / batch_broadcast(timesteps, xt.ndim)
        losses = ((noise - x0) - v_pred.float()) ** 2
        return {"loss": flatten_nonbatch_mean(losses).mean()}

    # --- one reverse step ---------------------------------------------------
    def get_v(
        self,
        model_fn: ModelFn,
        x: torch.Tensor,
        cond: dict[str, Any],
        t_curr: float,
        guidance_scale: float = 0.0,
        use_cfg: bool = False,
    ) -> torch.Tensor:
        t_vec = torch.full((x.shape[0],), float(t_curr), dtype=torch.float32, device=x.device)
        pred = _cfg_model_call(model_fn, x, t_vec, cond, guidance_scale, use_cfg,
                               self.guidance_interval, self.guidance_rescale)
        if self.x_prediction:
            return at_least_f32(x - pred) / float(max(np.float32(t_curr), np.float32(0.05)))
        return pred

    def one_step_denoise(
        self,
        model_fn: ModelFn,
        x: torch.Tensor,
        cond: dict[str, Any],
        t_prev: float,
        t_curr: float,
        guidance_scale: float = 0.0,
        use_cfg: bool = False,
    ) -> StepResult:
        v = self.get_v(model_fn, x, cond, t_curr, guidance_scale, use_cfg)
        return self.sampler.step(x, v, t_curr, t_prev)

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
        dtype: torch.dtype = torch.float32,
        device: torch.device | None = None,
    ) -> dict[str, torch.Tensor]:
        """Full reverse flow (flow.py:280): Euler steps over the grid, the
        carry kept in its starting dtype (the step itself runs in fp32).
        Starts from ``x`` or from standard normal noise of ``data_shape``
        drawn with ``generator`` on ``device``."""
        if x is None:
            if data_shape is None:
                raise ValueError("'data_shape' must be provided if 'x' is not given")
            x = torch.randn(tuple(data_shape), generator=generator, dtype=dtype, device=device)
        ts = self.timesteps
        for t_curr, t_prev in zip(ts[:-1], ts[1:]):
            step = self.one_step_denoise(model_fn, x, cond, t_prev, t_curr,
                                         guidance_scale=guidance_scale, use_cfg=use_cfg)
            # keep the carry dtype stable (fp32 schedule scalars promote bf16 x)
            x = step["x_prev"].to(x.dtype)
        if clamp_x:
            x = torch.clamp(x, -1.0, 1.0)
        return {"x": x}
