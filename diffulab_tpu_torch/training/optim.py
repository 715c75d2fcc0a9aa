"""Optimizer factories with torch-style argument names (port of
diffulab_tpu/training/optim.py).

The reference factories keep the YAML keys of the configs
(``configs/optimizer/adamw.yaml``: lr/weight_decay/betas/eps) and return optax
transformations. Here each returns an :class:`OptimizerFactory`, a callable
``params -> torch.optim.Optimizer``, because a torch optimizer needs its
parameters when it is built; the trainer builds it once it holds the model.

Each optax rule has its torch counterpart with the same update:

- ``optax.adamw``: ``p - lr·(m̂/(√v̂ + eps) + wd·p)``, which is torch's
  decoupled ``p·(1 - lr·wd) - lr·m̂/(√v̂ + eps)``. The decay is passed through
  as given: this factory defaults to 0.01, ``optax.adamw`` itself to 1e-4
  (bench.py:65), ``torch.optim.AdamW`` to 1e-2 (trap T7).
- ``optax.adam`` and ``optax.sgd`` (momentum as a trace, Nesterov, weight
  decay added to the gradient before it) are ``torch.optim.Adam`` and
  ``torch.optim.SGD``.
- ``grad_clip_norm`` is not part of the torch optimizer: the trainer applies
  it with optax's rule, :func:`clip_by_global_norm` (trap T11), whose norm is
  that of the whole gradient when it is sharded (FSDP2 or tensor-parallel
  DTensors): each shard's sum of squares is summed over the mesh dims it is
  sharded on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerFactory:
    """``factory(params)`` builds the optimizer; ``grad_clip_norm`` (or None)
    is the global-norm clip the trainer applies to each update's gradient."""

    build: Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]
    grad_clip_norm: float | None = None

    def __call__(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        return self.build(params)


def _clip(grad_clip_norm: float | None) -> float | None:
    return float(grad_clip_norm) if grad_clip_norm else None


def adamw(
    lr: float = 1e-4,
    weight_decay: float = 0.01,
    betas: Sequence[float] = (0.9, 0.999),
    eps: float = 1e-8,
    grad_clip_norm: float | None = None,
    params: object = None,  # accepted for config parity; the trainer passes the parameters
) -> OptimizerFactory:
    del params
    return OptimizerFactory(
        lambda ps: torch.optim.AdamW(ps, lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay),
        _clip(grad_clip_norm),
    )


def adam(
    lr: float = 1e-4,
    betas: Sequence[float] = (0.9, 0.999),
    eps: float = 1e-8,
    grad_clip_norm: float | None = None,
    params: object = None,
) -> OptimizerFactory:
    del params
    return OptimizerFactory(
        lambda ps: torch.optim.Adam(ps, lr=lr, betas=tuple(betas), eps=eps),
        _clip(grad_clip_norm),
    )


def sgd(
    lr: float = 1e-2,
    momentum: float = 0.0,
    weight_decay: float = 0.0,
    nesterov: bool = False,
    grad_clip_norm: float | None = None,
    params: object = None,
) -> OptimizerFactory:
    del params
    return OptimizerFactory(
        lambda ps: torch.optim.SGD(ps, lr=lr, momentum=momentum, weight_decay=weight_decay,
                                   nesterov=nesterov),
        _clip(grad_clip_norm),
    )


@torch.no_grad()
def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """‖g‖ over every tensor of ``grads``, whole where they are sharded: a
    DTensor's shards' sums of squares are summed over the mesh dims it is
    sharded on (collective then: every rank calls it)."""
    from torch.distributed.tensor import DTensor

    def sq_sum(g: torch.Tensor) -> torch.Tensor:
        if not isinstance(g, DTensor):
            return torch.sum(g.float() ** 2)
        local = torch.sum(g.to_local().float() ** 2)
        for dim, placement in enumerate(g.placements):
            if placement.is_shard():
                torch.distributed.all_reduce(local, group=g.device_mesh.get_group(dim))
        return local

    return torch.sqrt(sum(sq_sum(g) for g in grads))


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / ‖g‖`` when ``‖g‖ >= max_norm``
    (``optax.clip_by_global_norm``, which adds no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``). Returns the global norm, on the
    gradients' device: nothing here waits for the card."""
    from torch.distributed.tensor import DTensor

    norm = global_norm(grads)
    for g in grads:
        g = g.to_local() if isinstance(g, DTensor) else g
        # optax: (t / g_norm) * max_norm, skipped below the threshold
        g.copy_(torch.where(norm < max_norm, g, (g / norm.to(g.dtype)) * max_norm))
    return norm

