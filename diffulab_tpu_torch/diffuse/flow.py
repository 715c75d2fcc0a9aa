"""Rectified-flow / flow-matching formalization (port of
diffulab_tpu/diffuse/flow.py).

The forward process is ``x_t = (1 - t)·x0 + t·eps``; the training loss is the
MSE between the model velocity and ``eps - x0`` (with the x-prediction
conversion ``v = (x_t - x0_hat) / t``), or, with a frozen teacher, the MSE to
its CFG-guided prediction (guidance distillation, arXiv:2210.03142);
timesteps are drawn uniform or logit-normal with a ``torch.Generator``,
optionally time-shifted. The reverse process runs the reference's
``lax.scan`` as a Python loop over the fp32 timestep grid, with
classifier-free guidance as ONE batched 2x model call per step (or, with an
autoguidance model, a conditional call of each model), any of the five
samplers (multistep ones thread their state through the loop), Delta-DiT
block caching (:mod:`.caching`), RePaint-lite inpainting, SDEdit img2img and
the per-step intermediates. The model is an opaque callable
``model_fn(x, timesteps, cond, drop)`` returning ``{"x": prediction}``.

Every random draw of the loop (initial noise, img2img start, Euler-Maruyama
steps, inpaint re-noising) goes through one ``draw_noise(kind, step, shape,
dtype)`` callable, by default standard normals from the caller's generator;
the parity tests pass the reference's draws through it (trap T4).

The GRPO objective (:meth:`Flow.compute_loss_grpo`) re-evaluates stored
Euler-Maruyama trajectories with gradients.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Any, Callable, Sequence

import numpy as np
import torch

from diffulab_tpu_torch.diffuse.caching import wrap_block_cache
from diffulab_tpu_torch.diffuse.guidance import combine_cfg, effective_scale
from diffulab_tpu_torch.diffuse.samplers.common import StepResult
from diffulab_tpu_torch.diffuse.samplers.flow import DPMSolverPP2M, Euler, EulerMaruyama, Heun, UniPC
from diffulab_tpu_torch.diffuse.schedules import flow_linear_timesteps, shift_timestep
from diffulab_tpu_torch.utils import at_least_f32, batch_broadcast, flatten_nonbatch_mean

ModelFn = Callable[..., dict[str, torch.Tensor]]

NoiseFn = Callable[[str, int, tuple, torch.dtype], torch.Tensor]

SAMPLER_REGISTRY = {
    "euler": Euler,
    "euler_maruyama": EulerMaruyama,
    "heun": Heun,
    "dpmpp_2m": DPMSolverPP2M,
    "unipc": UniPC,
}


def generator_noise(generator: torch.Generator | None, device: torch.device | None) -> NoiseFn:
    """The default ``draw_noise``: standard normals from ``generator`` on ``device``."""
    def draw(kind: str, step: int, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        del kind, step
        return torch.randn(tuple(shape), generator=generator, dtype=dtype, device=device)
    return draw


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
    guide_fn: ModelFn | None = None,
    promote: bool = True,
) -> torch.Tensor:
    """Model forward with classifier-free guidance as ONE batched 2x call
    (flow.py:55): [x; x] with the second half's condition dropped, then
    ``uncond + scale * (cond - uncond)`` in fp32 (T8, see :func:`combine_cfg`;
    ``promote=False`` keeps the outputs' dtype, as a Python-float scale does
    in the reference). With ``guide_fn`` (autoguidance, arXiv:2406.02507) the
    negative branch is a conditional call of that degraded model instead:
    two calls at batch B."""
    batch = x.shape[0]
    if not use_cfg:
        drop = torch.zeros((batch,), dtype=torch.bool, device=x.device)
        return model_fn(x=x, timesteps=t_vec, cond=cond, drop=drop)["x"]

    if guide_fn is not None:
        drop = torch.zeros((batch,), dtype=torch.bool, device=x.device)
        out_cond = model_fn(x=x, timesteps=t_vec, cond=cond, drop=drop)["x"]
        out_bad = guide_fn(x=x, timesteps=t_vec, cond=cond, drop=drop)["x"]
        scale = effective_scale(guidance_scale, t_vec, guidance_interval)
        return combine_cfg(out_cond, out_bad, scale, guidance_rescale, promote=promote)

    x2 = torch.cat([x, x], dim=0)
    t2 = torch.cat([t_vec, t_vec], dim=0)
    cond2 = _tree_cat2(cond)
    drop = torch.cat([torch.zeros((batch,), dtype=torch.bool, device=x.device),
                      torch.ones((batch,), dtype=torch.bool, device=x.device)])
    out = model_fn(x=x2, timesteps=t2, cond=cond2, drop=drop)["x"]
    out_cond, out_uncond = out.chunk(2, dim=0)
    scale = effective_scale(guidance_scale, t_vec, guidance_interval)
    return combine_cfg(out_cond, out_uncond, scale, guidance_rescale, promote=promote)


def stack_intermediates(x0: torch.Tensor, ys: list[StepResult]) -> dict[str, torch.Tensor]:
    """The per-step results in batch-major layout (flow.py:390-404): ``xt``
    [B, steps+1, ...] from the start, ``estimated_x0`` [B, steps, ...], and
    for the stochastic sampler ``xt_mean`` [B, steps, ...], ``xt_std``
    [steps] and ``logprob`` [B, steps, ...]."""
    out = {"xt": torch.cat([x0[:, None], torch.stack([y["x_prev"] for y in ys], dim=1)], dim=1),
           "estimated_x0": torch.stack([y["estimated_x0"] for y in ys], dim=1)}
    if "x_prev_mean" in ys[0]:
        out["xt_mean"] = torch.stack([y["x_prev_mean"] for y in ys], dim=1)
    if "x_prev_std" in ys[0]:
        out["xt_std"] = torch.cat([y["x_prev_std"].reshape(-1) for y in ys])
    if "logprob" in ys[0]:
        out["logprob"] = torch.stack([y["logprob"] for y in ys], dim=1)
    return out


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
        only then promoted against the fp32 prediction (T10). With
        ``distill_fn`` (a frozen teacher) the target is the teacher's guided
        raw prediction at ``distill_guidance``, formed without gradients.
        Each extra loss (REPA) is called on the model's output, with x0 and
        then ``extra_args`` as keywords, under its own name (flow.py:219-234)."""
        xt, noise = self.add_noise(x0, timesteps, noise)
        if drop is None:
            drop = torch.zeros((x0.shape[0],), dtype=torch.bool, device=x0.device)
        prediction = model_fn(x=xt, timesteps=timesteps, cond=cond, drop=drop)
        v_pred = prediction["x"]
        if distill_fn is not None:
            with torch.no_grad():
                target = _cfg_model_call(distill_fn, xt, timesteps, cond, distill_guidance, use_cfg=True,
                                         guidance_interval=self.guidance_interval,
                                         guidance_rescale=self.guidance_rescale, promote=False).float()
            losses = (target - v_pred.float()) ** 2
        else:
            if self.x_prediction:
                # bf16 / fp32 [B,1,..] promotes to fp32, as in JAX
                v_pred = (xt - v_pred) / batch_broadcast(timesteps, xt.ndim)
            losses = ((noise - x0) - v_pred.float()) ** 2
        loss_dict = {"loss": flatten_nonbatch_mean(losses).mean()}
        for extra_loss in extra_losses:
            loss_dict[extra_loss.name] = extra_loss(model_output=prediction, **{"x0": x0, **(extra_args or {})})
        return loss_dict

    # --- GRPO loss ----------------------------------------------------------
    def compute_loss_grpo(
        self,
        model_fn: ModelFn,
        cond: dict[str, Any],
        sampling: dict[str, torch.Tensor],
        advantages: torch.Tensor,
        generator: torch.Generator | None = None,
        kl_beta: float = 0.0,
        eps: float = 1e-4,
        timestep_fraction: float = 0.6,
        guidance_scale: float = 4.0,
        indices: Sequence[int] | None = None,
        backward: bool = False,
    ) -> dict[str, torch.Tensor]:
        """Clipped-ratio GRPO objective over stored Euler-Maruyama trajectories
        (flow.py:406-469; reference flow.py:317-380, arXiv:2508.20751).

        ``sampling`` holds ``xt`` [B, steps+1, ...], ``logprob`` and ``xt_mean``
        [B, steps, ...] from :meth:`denoise` with intermediates; ``advantages``
        is [B]. ``k = round(steps * timestep_fraction)`` trajectory indices are
        drawn without replacement from ``generator`` (a permutation's first k;
        the reference's ``jax.random.choice`` stream is not reproduced), or
        given as ``indices``. For each index the step is re-run with the stored
        ``x_prev`` forced and fused CFG; the loss is the mean over the indices
        of the clipped policy term plus ``kl_beta`` times the mean-difference
        KL over ``2·std²``. ``clip_frac`` (the share of ratios outside
        ``[1 - eps, 1 + eps]``) and ``ratio_dev`` (mean ``|ratio - 1|``) are
        detached means over the indices.

        The reference differentiates all k evaluations at once. The loss is a
        sum of per-index terms, so with ``backward=True`` the port calls
        ``backward()`` on each index's term divided by k as soon as it is
        formed: the parameters' ``.grad`` accumulate the same gradient while
        only one evaluation's activations are held, and the returned loss is
        detached. With ``backward=False`` the loss keeps the graph of all k."""
        if not isinstance(self.sampler, EulerMaruyama):
            raise ValueError("GRPO only works with the Euler-Maruyama sampler")
        k = round(self.steps * timestep_fraction)
        if indices is None:
            device = generator.device if generator is not None else None
            indices = torch.randperm(self.steps, generator=generator, device=device)[:k].tolist()
        indices = [int(i) for i in indices]
        if len(indices) != k or len(set(indices)) != k:
            raise ValueError(f"GRPO needs {k} distinct trajectory indices, got {indices}")
        ts = self.timesteps
        adv = batch_broadcast(advantages.float(), sampling["logprob"].ndim - 1)
        total = torch.zeros((), dtype=torch.float32, device=advantages.device)
        clip_frac = torch.zeros((), dtype=torch.float32, device=advantages.device)
        ratio_dev = torch.zeros((), dtype=torch.float32, device=advantages.device)
        for idx in indices:
            step = self.one_step_denoise(
                model_fn, sampling["xt"][:, idx], cond, t_prev=float(ts[idx + 1]), t_curr=float(ts[idx]),
                guidance_scale=guidance_scale, use_cfg=True, sampler_args={"x_prev": sampling["xt"][:, idx + 1]},
            )
            prob_ratios = torch.exp(step["logprob"] - sampling["logprob"][:, idx])
            unclipped = adv * prob_ratios
            clipped = adv * torch.clamp(prob_ratios, 1.0 - eps, 1.0 + eps)
            policy_loss = -torch.minimum(unclipped, clipped).mean()
            diff = (step["x_prev_mean"] - sampling["xt_mean"][:, idx]) ** 2
            kl_loss = (flatten_nonbatch_mean(diff) / (2.0 * step["x_prev_std"].reshape(()) ** 2)).mean()
            term = policy_loss + kl_beta * kl_loss
            if backward:
                (term / k).backward()
                term = term.detach()
            total = total + term
            with torch.no_grad():
                deviation = torch.abs(prob_ratios - 1.0)
                clip_frac += (deviation > eps).float().mean()
                ratio_dev += deviation.mean()
        return {"loss": total / k, "clip_frac": clip_frac / k, "ratio_dev": ratio_dev / k}

    # --- one reverse step ---------------------------------------------------
    def get_v(
        self,
        model_fn: ModelFn,
        x: torch.Tensor,
        cond: dict[str, Any],
        t_curr: float,
        guidance_scale: float = 0.0,
        use_cfg: bool = False,
        guide_fn: ModelFn | None = None,
    ) -> torch.Tensor:
        t_vec = torch.full((x.shape[0],), float(t_curr), dtype=torch.float32, device=x.device)
        pred = _cfg_model_call(model_fn, x, t_vec, cond, guidance_scale, use_cfg,
                               self.guidance_interval, self.guidance_rescale, guide_fn=guide_fn)
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
        noise: torch.Tensor | None = None,
        sampler_args: dict[str, Any] | None = None,
        guide_fn: ModelFn | None = None,
    ) -> StepResult:
        """One reverse step t_curr -> t_prev (flow.py:255); Heun evaluates the
        corrector velocity at the Euler-predicted point."""
        v = self.get_v(model_fn, x, cond, t_curr, guidance_scale, use_cfg, guide_fn)
        if getattr(self.sampler, "needs_second_eval", False):
            x_pred = self.sampler.predict(x, v, t_curr, t_prev)
            v2 = self.get_v(model_fn, x_pred, cond, t_prev, guidance_scale, use_cfg, guide_fn)
            return self.sampler.step(x, v, t_curr, t_prev, v2=v2, noise=noise, **(sampler_args or {}))
        return self.sampler.step(x, v, t_curr, t_prev, noise=noise, **(sampler_args or {}))

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
        """Full reverse flow (flow.py:280), the carry kept in its starting
        dtype (the steps themselves run in fp32). Starts from ``x``, from
        standard normal noise of ``data_shape``, or (img2img, SDEdit) from
        ``img2img_init`` noised to the grid entry ``1 - img2img_strength`` of
        the way in, running only that tail of the grid.

        ``inpaint = {"known", "mask"}`` (mask 1 = keep) replaces the known
        region after every step by the known image noised to the step's
        result time, and blends the clean known exactly at the end.
        ``block_cache0`` (a ``(main, guide)`` pair) with ``cache_interval``
        turns on block caching. Returns ``{"x"}``, and with
        ``return_intermediates`` the per-step tensors of
        :func:`stack_intermediates`.
        """
        draw = draw_noise or generator_noise(generator, device)
        ts = self.timesteps
        n_total = len(ts) - 1
        start_idx = 0
        if img2img_init is not None:
            k = min(max(int(round(img2img_strength * n_total)), 1), n_total)
            start_idx = n_total - k
            t0 = float(ts[start_idx])
            noise = draw("img2img", 0, tuple(img2img_init.shape), dtype)
            x = (1.0 - t0) * img2img_init.to(dtype) + t0 * noise
        if x is None:
            if data_shape is None:
                raise ValueError("'data_shape' must be provided if 'x' is not given")
            x = draw("init", 0, tuple(data_shape), dtype)
        x0 = x
        stochastic = isinstance(self.sampler, EulerMaruyama)
        multistep = getattr(self.sampler, "is_multistep", False)
        s_state = self.sampler.init_state(x) if multistep else None
        mcache = block_cache0 if block_cache0 is not None else ()
        ys = []
        for step_idx, (t_curr, t_prev) in enumerate(zip(ts[start_idx:-1], ts[start_idx + 1:])):
            step_model_fn, step_guide_fn, cell = wrap_block_cache(
                model_fn, guide_fn, mcache, step_idx, cache_interval, enabled=block_cache0 is not None)
            step = self.one_step_denoise(
                step_model_fn, x, cond, t_prev, t_curr, guidance_scale=guidance_scale, use_cfg=use_cfg,
                noise=draw("step", step_idx, tuple(x.shape), x.dtype) if stochastic else None,
                sampler_args={"state": s_state} if multistep else None, guide_fn=step_guide_fn,
            )
            mcache = cell["c"]
            s_state = step.pop("state", s_state)
            x_next = step["x_prev"]
            if inpaint is not None:
                known = inpaint["known"].to(x_next.dtype)
                noise = draw("inpaint", step_idx, tuple(known.shape), x_next.dtype)
                # (1 - t_prev) and t_prev are fp32 0-d arrays in the reference: a bf16 known promotes
                known_t = (float(np.float32(1.0) - np.float32(t_prev)) * at_least_f32(known)
                           + float(np.float32(t_prev)) * at_least_f32(noise))
                mask = inpaint["mask"].to(x_next.dtype)
                x_next = mask * known_t + (1.0 - mask) * x_next
                step["x_prev"] = x_next
            if return_intermediates:
                ys.append(step)
            # keep the carry dtype stable (fp32 schedule scalars promote bf16 x)
            x = x_next.to(x.dtype)
        if inpaint is not None:
            mask = inpaint["mask"].to(x.dtype)
            x = mask * inpaint["known"].to(x.dtype) + (1.0 - mask) * x
        if clamp_x:
            x = torch.clamp(x, -1.0, 1.0)
        out = {"x": x}
        if return_intermediates and ys:
            out.update(stack_intermediates(x0, ys))
        return out
