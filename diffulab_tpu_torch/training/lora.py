"""LoRA and DoRA finetuning (port of diffulab_tpu/training/lora.py; Hu et al.
2021, arXiv:2106.09685; Liu et al. 2024, arXiv:2402.09353).

:func:`apply_lora` wraps the denoiser's projection Linears in adapters, in
place: :class:`LoRALinear` (flax's ``nnx.LoRA`` around a base module, ``y =
x @ a @ b + base(x)``) or :class:`DoRALinear`. ``b`` starts at zero, so the
wrapped model is the base model at step 0. The adapter parameters are named
``lora_a`` ``[in, r]``, ``lora_b`` ``[r, out]`` and ``magnitude`` ``[out]``,
in the reference's layout, and the wrapped Linear sits under ``base_module``
(LoRA) or ``base`` (DoRA), as in the reference's paths, so
:mod:`diffulab_tpu_torch.weights` bridges a wrapped JAX model by name.
:func:`is_lora_param` is the trainable split of a ``lora_only`` run
(``nnx.LoRAParam`` in the reference): the optimizer and the EMA hold the
adapters, and checkpoints store them apart from the frozen base.

:func:`merge_lora` folds each adapter into its base weight and puts the
plain Linear back.
"""

from __future__ import annotations

import math
from typing import Iterable, Iterator

import torch
import torch.nn.functional as F
from torch import nn

from diffulab_tpu_torch.networks.nn import Linear

# attribute names of the projection Linears in this framework's blocks
# (DiT/MMDiT attention + SwiGLU MLPs, UNet qkv/proj, DDT/Sprint reuse these)
DEFAULT_TARGETS = (
    "qkv", "proj_out", "fc_in", "fc_out",
    "qkv_input", "qkv_context", "input_proj_out", "context_proj_out",
    "to_q", "to_k", "to_v", "to_out",
)

#: the adapters' parameter names
LORA_PARAMS = ("lora_a", "lora_b", "magnitude")


def is_lora_param(name: str) -> bool:
    """Whether a ``named_parameters()`` name is an adapter's."""
    return name.rsplit(".", 1)[-1] in LORA_PARAMS


def _he_uniform(din: int, rank: int, like: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """``nnx.initializers.he_uniform`` on ``[din, rank]``: U(-sqrt(6 / din), sqrt(6 / din)),
    drawn on the CPU from ``generator`` and moved to ``like``'s device and dtype."""
    limit = math.sqrt(6.0 / din)
    a = (torch.rand((din, rank), generator=generator) * 2.0 - 1.0) * limit
    return a.to(device=like.device, dtype=like.dtype)


class LoRALinear(nn.Module):
    """``nnx.LoRA`` around a base Linear: ``x``, ``lora_a`` and ``lora_b`` are
    promoted to the base's compute dtype (to their common type when it is
    None), then ``x @ a @ b`` is formed first and ``base(x)`` of the promoted
    ``x`` added to it, the reference's order (in bf16 the order shows)."""

    def __init__(self, base: Linear, rank: int, generator: torch.Generator | None = None):
        super().__init__()
        dout, din = base.weight.shape
        self.base_module = base
        self.dtype = base.dtype
        self.lora_a = nn.Parameter(_he_uniform(din, rank, base.weight, generator))
        self.lora_b = nn.Parameter(torch.zeros(rank, dout, device=base.weight.device, dtype=base.weight.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(torch.promote_types(x.dtype, self.lora_a.dtype), self.lora_b.dtype)
        x = x.to(dt)
        out = (x @ self.lora_a.to(dt)) @ self.lora_b.to(dt)
        return out + self.base_module(x)


class DoRALinear(nn.Module):
    """Weight-decomposed low-rank adaptation: ``W' = m * (W + B A) /
    ||W + B A||`` with a trainable magnitude ``m`` per output, the norm over
    each output's inputs (axis 0 of the reference's ``[in, out]`` kernel,
    ``dim=1`` of torch's ``[out, in]`` weight), formed in fp32 and detached
    (the DoRA paper's gradient simplification, eq. 5). At init ``B = 0`` and
    ``m = ||W||``, so the layer is the base. The product runs in ``x``'s
    dtype, the base's compute dtype aside, as the reference's does; with the
    bias in one ``F.linear``, as the base Linear adds it, so that the fp32
    layer at init gives the base's output bit for bit."""

    def __init__(self, base: Linear, rank: int, generator: torch.Generator | None = None):
        super().__init__()
        dout, din = base.weight.shape
        self.base = base
        self.lora_a = nn.Parameter(_he_uniform(din, rank, base.weight, generator))
        self.lora_b = nn.Parameter(torch.zeros(rank, dout, device=base.weight.device, dtype=base.weight.dtype))
        self.magnitude = nn.Parameter(
            torch.linalg.vector_norm(base.weight.detach().float(), dim=1).to(base.weight.dtype))

    def directional_weight(self) -> torch.Tensor:
        """The adapted weight ``[out, in]`` in the base weight's dtype."""
        w = self.base.weight + (self.lora_a @ self.lora_b).T
        col_norm = torch.linalg.vector_norm(w.float(), dim=1).clamp_min(1e-12).detach()
        return w * (self.magnitude.float() / col_norm).to(w.dtype)[:, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.base.bias is None else self.base.bias.to(x.dtype)
        return F.linear(x, self.directional_weight().to(x.dtype), bias)


def _children(module: nn.Module) -> Iterator[tuple[nn.Module, str, nn.Module]]:
    """(parent, name, child) over every submodule, each module visited once;
    ``nn.ModuleList`` children are named by their index, so they never match
    a target name (the reference's ``_iter_children`` wraps attributes only)."""
    seen: set[int] = set()
    stack = [module]
    while stack:
        mod = stack.pop()
        if id(mod) in seen:
            continue
        seen.add(id(mod))
        for name, child in mod.named_children():
            yield mod, name, child
            stack.append(child)


def apply_lora(
    module: nn.Module,
    rank: int,
    *,
    generator: torch.Generator | None = None,
    targets: Iterable[str] = DEFAULT_TARGETS,
    variant: str = "lora",
) -> int:
    """Wrap the :class:`~diffulab_tpu_torch.networks.nn.Linear` attributes
    named in ``targets`` in place; returns the number of adapters inserted
    (the reference's count for the same model). ``variant``: "lora" or
    "dora". ``lora_a`` is drawn from ``generator`` (a CPU generator; the
    global one when None). Layers already wrapped are skipped: their base
    sits under ``base_module`` or ``base``, which no target names."""
    if variant not in ("lora", "dora"):
        raise ValueError(f"variant must be 'lora' or 'dora', got {variant!r}")
    targets = set(targets)
    wrap = DoRALinear if variant == "dora" else LoRALinear
    found = [(parent, name, child) for parent, name, child in _children(module)
             if isinstance(child, Linear) and name in targets]
    for parent, name, child in found:
        setattr(parent, name, wrap(child, rank, generator))
    return len(found)


@torch.no_grad()
def merge_lora(module: nn.Module) -> int:
    """Fold every adapter into its base weight and put the plain Linear
    back; returns the number of adapters merged."""
    found = [(parent, name, child) for parent, name, child in _children(module)
             if isinstance(child, (LoRALinear, DoRALinear))]
    for parent, name, child in found:
        if isinstance(child, LoRALinear):
            base = child.base_module
            base.weight.add_((child.lora_a @ child.lora_b).T.to(base.weight.dtype))
        else:
            base = child.base
            base.weight.copy_(child.directional_weight().to(base.weight.dtype))
        setattr(parent, name, base)
    return len(found)


def count_lora_params(module: nn.Module) -> int:
    """The number of adapter parameters (elements)."""
    return sum(p.numel() for name, p in module.named_parameters() if is_lora_param(name))
