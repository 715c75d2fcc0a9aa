"""Diffuser facade binding a denoiser to a formalization and an optional
vision tower (port of diffulab_tpu/diffuse/diffuser.py).

``generate`` runs the reverse process eagerly under ``torch.no_grad()``: the
reference jit-compiles one program per sampling configuration, the port runs
the same steps as launches on the card (a CUDA graph is later work). In
latent mode (``vision_tower``) it decodes ``x / latent_scale + latent_bias``
through the tower and applies ``clamp_x`` to the decoded pixels. It takes the
reference's sampling options: the per-step intermediates, inpainting,
img2img, an autoguidance model (``guide_denoiser``) and Delta-DiT block
caching (:meth:`Diffuser.set_block_cache`). ``compute_loss`` is the training
loss the trainer differentiates, with the ``extra_losses`` (REPA) beside it,
each under its own name; with extra losses the denoiser's forward captures
the features they read.

Formalizations: ``rectified_flow``, ``edm`` and ``gaussian_diffusion``.
Not ported yet (it raises ``NotImplementedError``): the GRPO loss
(ROADMAP queue 1, item 16).
"""

from __future__ import annotations

from typing import Any

import torch

from diffulab_tpu_torch.diffuse.edm import EDM
from diffulab_tpu_torch.diffuse.flow import Flow
from diffulab_tpu_torch.diffuse.gaussian_diffusion import GaussianDiffusion
from diffulab_tpu_torch.utils import resolve_device, resolve_dtype


class Diffuser:
    """Unified interface over the diffusion formalizations (diffuser.py:22)."""

    model_registry: dict[str, type] = {"rectified_flow": Flow, "edm": EDM, "gaussian_diffusion": GaussianDiffusion}

    def __init__(
        self,
        denoiser: Any,
        sampling_method: str,
        model_type: str = "rectified_flow",
        n_steps: int = 1000,
        vision_tower: Any | None = None,
        extra_args: dict[str, Any] | None = None,
        extra_losses: list[Any] | None = None,
    ):
        if model_type not in self.model_registry:
            raise NotImplementedError(f"Model type {model_type} is not implemented")
        self.model_type = model_type
        self.extra_losses: list[Any] = list(extra_losses or [])
        self.denoiser = denoiser
        self.n_steps = n_steps
        self.vision_tower = vision_tower
        if vision_tower is not None:
            self.latent_scale = vision_tower.latent_scale
            self.latent_bias = vision_tower.latent_bias
        self.diffusion = self.model_registry[model_type](
            n_steps=n_steps,
            sampling_method=sampling_method,
            latent_diffusion=vision_tower is not None,
            **(extra_args or {}),
        )
        self._block_cache: dict[str, Any] | None = None

    @staticmethod
    def _model_fn(denoiser: Any, train: bool, capture_features: bool = False,
                  generator: torch.Generator | None = None):
        def fn(x, timesteps, cond, drop, **kwargs):
            if capture_features:
                kwargs["capture_features"] = True
            if generator is not None:
                kwargs["generator"] = generator
            return denoiser(x=x, timesteps=timesteps, cond=cond, drop=drop, train=train, **kwargs)
        return fn

    def model_fn(self, train: bool = False, capture_features: bool = False,
                 generator: torch.Generator | None = None):
        """The (x, timesteps, cond, drop) callable the formalizations consume;
        further keywords (the block cache) go through to the denoiser;
        ``capture_features`` returns the features the extra losses read;
        ``generator`` is the one the denoiser's own draws take (the token
        drop of a training forward)."""
        return self._model_fn(self.denoiser, train, capture_features, generator)

    def draw_timesteps(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        return self.diffusion.draw_timesteps(generator, batch_size)

    def compute_loss(
        self,
        x0: torch.Tensor,
        cond: dict[str, Any],
        timesteps: torch.Tensor,
        noise: torch.Tensor,
        drop: torch.Tensor | None = None,
        extra_args: dict[str, Any] | None = None,
        train: bool = True,
        grpo: bool = False,
        generator: torch.Generator | None = None,
    ) -> dict[str, torch.Tensor]:
        """The training loss (diffuser.py:117) with the given t, noise and drop
        mask; ``generator`` goes to the denoiser (see :meth:`model_fn`)."""
        if grpo:
            raise NotImplementedError("the GRPO loss is not ported yet (ROADMAP queue 1, item 16)")
        return self.diffusion.compute_loss(
            self.model_fn(train=train, capture_features=bool(self.extra_losses), generator=generator), x0, cond,
            timesteps, noise,
            drop=drop, extra_losses=self.extra_losses, extra_args=extra_args,
        )

    def set_steps(self, n_steps: int, **kwargs: Any) -> None:
        """Swap the sampling schedule (diffuser.py:82); a Gaussian formalization respaces."""
        self.diffusion = self.diffusion.set_steps(n_steps, **kwargs)

    def set_block_cache(self, interval: int | None, span: tuple[int, int] | None = None) -> None:
        """Training-free sampling acceleration by block caching (Delta-DiT,
        arXiv:2406.01125; diffuser.py:89-115): every ``interval``-th denoise
        step the blocks in ``span = (lo, hi)`` run and cache their combined
        residual delta; the steps in between reuse it and skip those blocks.
        ``interval=None`` or ``1`` disables it."""
        if interval is None or int(interval) <= 1:
            self._block_cache = None
            if hasattr(self.denoiser, "set_block_cache_span"):
                self.denoiser.set_block_cache_span(None)
            return
        if not hasattr(self.denoiser, "init_block_cache"):
            raise ValueError(f"{type(self.denoiser).__name__} does not support block caching")
        if span is None:
            raise ValueError("block caching needs a (lo, hi) block span")
        span = (int(span[0]), int(span[1]))
        self.denoiser.set_block_cache_span(span)
        self._block_cache = {"interval": int(interval), "span": span}

    @torch.no_grad()
    def generate(
        self,
        cond: dict[str, Any],
        data_shape: tuple[int, ...] | None = None,
        x: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        clamp_x: bool = False,
        guidance_scale: float = 0.0,
        dtype: Any = torch.float32,
        device: str | torch.device | None = None,
        return_latents: bool = False,
        return_intermediates: bool = False,
        inpaint: dict[str, Any] | None = None,
        img2img: dict[str, Any] | None = None,
        guide_denoiser: Any = None,
        draw_noise: Any = None,
    ) -> dict[str, torch.Tensor]:
        """Sample NHWC images of ``data_shape`` (or from the given start ``x``)
        with CFG when ``guidance_scale > 0``, on ``device`` (default: the card).

        ``generator`` draws the noise (it must live on ``device``); torch
        cannot reproduce the reference's JAX random streams, so parity runs
        pass ``x`` or ``draw_noise`` (the formalizations' noise callable)
        instead (trap T4). ``cond`` tensors must be on ``device``.

        ``inpaint = {"known", "mask"}`` (mask 1 = keep) and ``img2img =
        {"init", "strength"}`` live in the space the reverse process runs in
        (latents with a vision tower). ``guide_denoiser`` (autoguidance,
        arXiv:2406.02507) replaces the unconditional branch by a conditional
        call of a degraded sibling model, ``guided = bad + s * (good - bad)``;
        it needs ``guidance_scale > 0``. With block caching on, the guide gets
        the denoiser's span and a cache of its own; the denoiser's cache is
        2x-batched only under fused CFG without a guide (diffuser.py:184-200).

        In latent mode the result is decoded to pixels, and ``clamp_x`` clips
        those pixels to [-1, 1] (diffuser.py:204-222). ``return_latents=True``
        skips the decode and returns the latents unclipped: ``clamp_x`` means
        the pixel range, and the reference's clip of tower-normalised latents
        on that path is a residue this port does not copy (ROADMAP trap T5).
        """
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        use_cfg = guidance_scale > 0
        if x is not None:
            x = x.to(device=device, dtype=dtype)
        guide_fn = None
        if guide_denoiser is not None:
            if not use_cfg:
                raise ValueError("guide_denoiser requires guidance_scale > 0")
            if self._block_cache is not None:
                if not hasattr(guide_denoiser, "set_block_cache_span"):
                    raise ValueError(f"{type(guide_denoiser).__name__} does not support block caching; "
                                     "disable set_block_cache before autoguidance")
                guide_denoiser.set_block_cache_span(self._block_cache["span"])
            guide_fn = self._model_fn(guide_denoiser, train=False)
        block_cache0 = None
        if self._block_cache is not None:
            shape = tuple(data_shape) if x is None else tuple(x.shape)
            main0 = self.denoiser.init_block_cache(shape, cond, use_cfg and guide_denoiser is None)
            guide0 = guide_denoiser.init_block_cache(shape, cond, False) if guide_denoiser is not None else ()
            block_cache0 = (main0, guide0)
        if inpaint is not None:
            inpaint = {key: torch.as_tensor(inpaint[key], device=device) for key in ("known", "mask")}
        init = None
        strength = 1.0
        if img2img is not None:
            init = torch.as_tensor(img2img["init"], device=device)
            strength = float(img2img.get("strength", 0.8))
        latent = self.vision_tower is not None
        out = self.diffusion.denoise(
            self.model_fn(train=False), cond, generator,
            data_shape=data_shape, x=x, clamp_x=clamp_x and not latent,
            guidance_scale=float(guidance_scale), use_cfg=use_cfg,
            return_intermediates=return_intermediates, dtype=dtype, device=device,
            inpaint=inpaint, img2img_init=init, img2img_strength=strength, guide_fn=guide_fn,
            block_cache0=block_cache0,
            cache_interval=self._block_cache["interval"] if self._block_cache else 1,
            draw_noise=draw_noise,
        )
        if latent and not return_latents:
            out["x"] = self.vision_tower.decode(out["x"] / self.latent_scale + self.latent_bias)
            if clamp_x:
                out["x"] = torch.clamp(out["x"], -1.0, 1.0)
        return out
