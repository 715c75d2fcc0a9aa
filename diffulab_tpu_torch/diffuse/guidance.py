"""Classifier-free-guidance shaping (port of diffulab_tpu/diffuse/guidance.py):
the guidance interval (arXiv:2404.07724) and std rescale (arXiv:2305.08891)
on top of plain CFG."""

from __future__ import annotations

from typing import Sequence

import torch

from diffulab_tpu_torch.utils import at_least_f32


def effective_scale(
    guidance_scale: float,
    noise_level: torch.Tensor,
    interval: Sequence[float] | None,
) -> float | torch.Tensor:
    """Per-sample CFG scale: ``guidance_scale`` inside [lo, hi], 1 outside.

    ``noise_level`` is a [B] vector; with ``interval=None`` this is the identity.
    """
    if interval is None:
        return guidance_scale
    lo, hi = float(interval[0]), float(interval[1])
    inside = (noise_level >= lo) & (noise_level <= hi)
    return torch.where(inside, float(guidance_scale), 1.0).float()


def combine_cfg(
    out_cond: torch.Tensor,
    out_uncond: torch.Tensor,
    scale: float | torch.Tensor,
    rescale: float = 0.0,
    promote: bool = True,
) -> torch.Tensor:
    """``uncond + scale * (cond - uncond)``, optionally std-rescaled.

    The scale is an fp32 value, as the reference's ``Diffuser.generate`` passes
    it (an fp32 0-d array, diffuser.py:305). JAX promotes a bf16 difference
    times that scale to fp32, so the product and the sum are taken in fp32
    here too (trap T8); the difference itself rounds in the outputs' dtype.
    ``scale`` may be a float or a [B] vector (from :func:`effective_scale`).
    ``promote=False`` is the reference's Python-float scale (a weak type, as
    guidance distillation passes it, flow.py:226): the combine stays in the
    outputs' dtype.
    """
    if isinstance(scale, torch.Tensor) and scale.ndim == 1:
        scale = scale.reshape(-1, *([1] * (out_cond.ndim - 1)))
    if not promote:
        if isinstance(scale, torch.Tensor):
            scale = scale.to(out_cond.dtype)
        guided = out_uncond + scale * (out_cond - out_uncond)
    else:
        guided = at_least_f32(out_uncond) + scale * at_least_f32(out_cond - out_uncond)
    if rescale:
        dims = tuple(range(1, guided.ndim))
        std_cond = torch.std(out_cond, dim=dims, keepdim=True, correction=0)
        std_cfg = torch.std(guided, dim=dims, keepdim=True, correction=0)
        renorm = guided * (std_cond / torch.clamp(std_cfg, min=1e-12))
        guided = rescale * renorm + (1.0 - rescale) * guided
    return guided
