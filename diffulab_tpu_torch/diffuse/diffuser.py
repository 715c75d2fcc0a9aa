"""Diffuser facade binding a denoiser to a formalization and an optional
vision tower (port of diffulab_tpu/diffuse/diffuser.py).

``generate`` runs the reverse process eagerly under ``torch.no_grad()``: the
reference jit-compiles one program per sampling configuration, the port runs
the same steps as launches on the card (a CUDA graph is later work). In
latent mode (``vision_tower``) it decodes ``x / latent_scale + latent_bias``
through the tower and applies ``clamp_x`` to the decoded pixels.
``compute_loss`` is the training loss the trainer differentiates.

Not ported yet (they raise ``NotImplementedError``): intermediates,
inpainting, img2img, autoguidance, block caching, extra losses, the GRPO
loss, and the Gaussian/EDM formalizations.
"""

from __future__ import annotations

from typing import Any

import torch

from diffulab_tpu_torch.diffuse.flow import Flow
from diffulab_tpu_torch.utils import resolve_device, resolve_dtype

_UNPORTED_MODEL_TYPES = ("gaussian_diffusion", "edm")


class Diffuser:
    """Unified interface over the diffusion formalizations (diffuser.py:22)."""

    model_registry: dict[str, type] = {"rectified_flow": Flow}

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
        if model_type in _UNPORTED_MODEL_TYPES:
            raise NotImplementedError(f"model type {model_type!r} is not ported yet (ROADMAP queue 1, items 14-15)")
        if model_type not in self.model_registry:
            raise NotImplementedError(f"Model type {model_type} is not implemented")
        if extra_losses:
            raise NotImplementedError("extra losses (REPA) are not ported yet (ROADMAP queue 1, item 13)")
        self.model_type = model_type
        self.extra_losses: list[Any] = []
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

    def model_fn(self, train: bool = False):
        """The (x, timesteps, cond, drop) callable the formalizations consume."""
        def fn(x, timesteps, cond, drop):
            return self.denoiser(x=x, timesteps=timesteps, cond=cond, drop=drop, train=train)
        return fn

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
    ) -> dict[str, torch.Tensor]:
        """The training loss (diffuser.py:117) with the given t, noise and drop mask."""
        if grpo:
            raise NotImplementedError("the GRPO loss is not ported yet (ROADMAP queue 1, item 16)")
        return self.diffusion.compute_loss(
            self.model_fn(train=train), x0, cond, timesteps, noise,
            drop=drop, extra_losses=self.extra_losses, extra_args=extra_args,
        )

    def set_steps(self, n_steps: int, **kwargs: Any) -> None:
        """Swap the sampling schedule (diffuser.py:82)."""
        self.diffusion = self.diffusion.set_steps(n_steps, **kwargs)

    def set_block_cache(self, interval: int | None, span: tuple[int, int] | None = None) -> None:
        if interval is not None and int(interval) > 1:
            raise NotImplementedError("block caching is not ported yet (ROADMAP queue 1, item 7)")

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
    ) -> dict[str, torch.Tensor]:
        """Sample NHWC images of ``data_shape`` (or from the given start ``x``)
        with CFG when ``guidance_scale > 0``, on ``device`` (default: the card).

        ``generator`` draws the starting noise (it must live on ``device``);
        torch cannot reproduce the reference's JAX random streams, so parity
        runs pass ``x`` instead (trap T4). ``cond`` tensors must be on
        ``device``.

        In latent mode ``data_shape`` and ``x`` are latents; the result is
        decoded to pixels, and ``clamp_x`` clips those pixels to [-1, 1]
        (diffuser.py:204-222). ``return_latents=True`` skips the decode and
        returns the latents unclipped: ``clamp_x`` means the pixel range, and
        the reference's clip of tower-normalised latents on that path is a
        residue this port does not copy (ROADMAP trap T5).
        """
        if return_intermediates or inpaint is not None or img2img is not None or guide_denoiser is not None:
            raise NotImplementedError(
                "intermediates, inpaint, img2img and autoguidance are not ported yet "
                "(ROADMAP queue 1, item 15)"
            )
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        if x is not None:
            x = x.to(device=device, dtype=dtype)
        latent = self.vision_tower is not None
        out = self.diffusion.denoise(
            self.model_fn(train=False), cond, generator,
            data_shape=data_shape, x=x, clamp_x=clamp_x and not latent,
            guidance_scale=float(guidance_scale), use_cfg=guidance_scale > 0,
            dtype=dtype, device=device,
        )
        if latent and not return_latents:
            out["x"] = self.vision_tower.decode(out["x"] / self.latent_scale + self.latent_bias)
            if clamp_x:
                out["x"] = torch.clamp(out["x"], -1.0, 1.0)
        return out
