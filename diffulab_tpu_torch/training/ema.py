"""Exponential moving average of parameters, ema-pytorch semantics (port of
diffulab_tpu/training/ema.py).

The decay ramps up as ``1 - (1 + step/inv_gamma) ** -power`` capped at
``beta``, counts steps only after ``update_after_step``, and the average
copies the parameters verbatim until then. The JAX version is a pure pytree
update inside the jitted step; here the average is a dict of fp32 tensors
(parameter name -> tensor) updated in place under ``torch.no_grad()``. The
decay is formed in fp32 on the host, as the reference forms it in fp32 from
the raw step counter.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    beta: float = 0.999
    update_after_step: int = 100
    update_every: int = 10
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0


def ema_decay(config: EMAConfig, step: int) -> np.float32:
    """Current decay for a raw train-step counter (ema-pytorch ramp): the
    warm-up length is measured in train steps, not in updates."""
    epoch = np.float32(max(step - config.update_after_step - 1.0, 0.0))
    value = np.float32(1.0) - (np.float32(1.0) + epoch / np.float32(config.inv_gamma)) ** np.float32(-config.power)
    return np.float32(min(max(value, np.float32(0.0)), np.float32(config.beta)))


def init_ema(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """fp32 copies of ``params`` (distinct buffers)."""
    return {name: p.detach().float().clone() for name, p in params.items()}


@torch.no_grad()
def ema_update(config: EMAConfig, ema_params: dict[str, torch.Tensor],
               params: dict[str, torch.Tensor], step: int) -> None:
    """One (conditional) EMA update in place; call every train step with the raw counter.

    - step <= update_after_step: hard copy (the average tracks the parameters);
    - afterwards, every ``update_every`` steps: lerp with the ramped decay.
    """
    warmup = step <= config.update_after_step
    if not warmup and step % config.update_every != 0:
        return
    decay = ema_decay(config, step)
    keep, take = float(decay), float(np.float32(1.0) - decay)
    for name, e in ema_params.items():
        p = params[name].detach().float()
        if warmup:
            e.copy_(p)
        else:
            e.mul_(keep).add_(p * take)
