"""Extra-loss construction from a composed config (port of
diffulab_tpu/training/losses/build.py).

The training and the sampling CLIs build the same extra-loss modules: a
REPA run's checkpoints hold the denoiser and its extra losses together
(:class:`~diffulab_tpu_torch.training.checkpoint.TrainModules`), so a
restore needs them too.
"""

from __future__ import annotations

from typing import Any

import torch

from diffulab_tpu_torch.training.losses.repa import RepaLoss
from diffulab_tpu_torch.utils import resolve_device


def build_extra_losses(cfg: dict[str, Any], *, seed: int = 0,
                       device: str | torch.device | None = None) -> list[RepaLoss]:
    """Extra-loss modules for a composed experiment config (build.py:18-69).

    Two REPA styles: a live encoder (a ``repa:`` section naming a
    ``repa_encoder`` or ``encoder_args``: features computed from x0 during
    training) and precomputed features (a ``perceiver_resampler:`` section
    or a ``repa:`` section without an encoder: the dataset's
    ``dst_features``). The aligned token width is ``repa.denoiser_dimension``
    or, for the DiT family, ``model.inner_dim``. The projector's init comes
    from torch's generator seeded with ``seed + 2`` (the reference's
    ``nnx.Rngs(seed + 2)``), on the CPU, then moves to ``device``.
    """
    repa_cfg = cfg.get("repa") or {}
    resampler_cfg = cfg.get("perceiver_resampler") or {}
    if not (repa_cfg or resampler_cfg):
        return []
    live = "repa_encoder" in repa_cfg or "encoder_args" in repa_cfg
    denoiser_dim = repa_cfg.get("denoiser_dimension") or cfg["model"].get("inner_dim")
    if denoiser_dim is None:
        raise ValueError("REPA needs the aligned-layer token width: set model.inner_dim (DiT) or "
                         "repa.denoiser_dimension (UNet capture-point channels)")
    common: dict[str, Any] = dict(
        denoiser_dimension=denoiser_dim,
        alignment_layer=repa_cfg.get("alignment_layer", 8),
        use_resampler=resampler_cfg.get("use_resampler", False),
        resampler_params=resampler_cfg.get("parameters"),
        coeff=repa_cfg.get("coeff", 0.5),
    )
    if live:
        kwargs = dict(repa_encoder=repa_cfg.get("repa_encoder", "fixed_vit"),
                      encoder_args=repa_cfg.get("encoder_args"), hidden_dim=repa_cfg.get("hidden_dim", 1024),
                      load_dino=True)
    else:
        kwargs = dict(embedding_dim=repa_cfg.get("embedding_dim", 1024), load_dino=False)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed + 2)
        loss = RepaLoss(**kwargs, **common, device="cpu")
    return [loss.to(resolve_device(device))]
