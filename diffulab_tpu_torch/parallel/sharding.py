"""Sharding rules: the reference's logical axes on the port's mesh (port of
diffulab_tpu/parallel/sharding.py).

The reference annotates the DiT/MMDiT weight matrices with logical axes
(mmdit.py:97-99, 148-151, 199-204): "embed", the model width, shards over
``fsdp``; "hidden", the attention/MLP expansion, over ``tensor``; a size-1
mesh axis is dropped (:34-45) and everything unannotated is replicated.
In the port each layer declares its own annotated linears in a class
attribute, ``tp_plan = {attribute: (kind, parts)}`` (kind ``column`` or
``row``, ``parts`` the fused parts of a column-parallel output: 3 for qkv,
2 for the packed SwiGLU input); a model whose layers declare none stays
replicated. :func:`shard_model` applies:

- ``tensor`` > 1: Megatron tensor parallelism, the weight a DTensor sharded
  over the ``tensor`` dim (column-parallel qkv and MLP-in along their output
  rows, row-parallel projections and MLP-out along their input columns),
  run by the Linear on its local shard with the collectives of
  :mod:`._comm` (its ``tp``). Each rank runs its own heads: the fused qkv
  ``[3d, d]`` weight is sharded by head, not by rows (trap T27: a row split
  would give rank 0 all of q and half of k), and the packed SwiGLU input
  ``[2h, d]`` by channel pair, so its local rows are stored as
  ``[q_r; k_r; v_r]`` / ``[x_r; gate_r]`` (:func:`to_sharded_layout`). A
  planned layer with ``num_heads`` keeps its share of them, and the norms
  inside it (those with a ``tp_group``: the QKNorm over the full width)
  take their mean of squares over the tensor group.
- ``fsdp`` > 1: FSDP2 ``fully_shard`` of those linears over the
  ``(data, fsdp)`` dims, sharded along "embed" and replicated over ``data``
  (HSDP); FSDP2 averages their gradients over both.
- ``data``: every other gradient is averaged over ``(data, fsdp)`` by one
  all-reduce a dtype (:func:`sync_grads`, DDP).

The ops inside a forward receive local tensors: a DTensor never reaches an
attention kernel (``dot_product_attention`` raises on one). Checkpoints are
whole: :func:`full_state_dict` gathers every DTensor into the reference's
layout, and :func:`shard_like` puts a whole tensor back in a parameter's
placement.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch
import torch.distributed as dist

from diffulab_tpu_torch.parallel import _comm
from diffulab_tpu_torch.parallel.mesh import axis_group, batch_shard, mesh_shape

LOGICAL_RULES: dict[str, str | None] = {"embed": "fsdp", "hidden": "tensor"}

#: the logical axes of the annotated kernels in the reference's [in, out] layout
_LOGICAL = {"column": ("embed", "hidden"), "row": ("hidden", "embed")}


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def is_dtensor(t: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def annotated_linears(model: torch.nn.Module) -> dict[str, tuple[str, int]]:
    """``{parameter name: (kind, fused parts)}`` of the weights the layers'
    ``tp_plan`` annotate."""
    out = {}
    for name, module in model.named_modules():
        for attr, (kind, parts) in getattr(module, "tp_plan", {}).items():
            if hasattr(module, attr):
                out[f"{name}.{attr}.weight".lstrip(".")] = (kind, parts)
    return out


def param_specs(model: torch.nn.Module, mesh) -> dict[str, tuple[str | None, ...]]:
    """Every parameter's mesh axes per dimension in the reference's layout
    (a kernel ``[in, out]``), size-1 axes dropped: what the reference's
    ``get_param_shardings`` gives its ``NamedSharding``s (:69-80). Unannotated
    parameters are replicated (all None)."""
    shape = mesh_shape(mesh)
    annotated = annotated_linears(model)
    specs = {}
    for name, p in model.named_parameters():
        if name in annotated:
            logical = _LOGICAL[annotated[name][0]]
            specs[name] = tuple(LOGICAL_RULES[a] if shape[LOGICAL_RULES[a]] > 1 else None for a in logical)
        else:
            specs[name] = (None,) * p.dim()
    return specs


def to_sharded_layout(w: torch.Tensor, parts: int, n: int) -> torch.Tensor:
    """Reorder a fused ``[parts * m, ...]`` weight's rows so that a split into n
    contiguous chunks gives rank r ``[part_0 rows r; part_1 rows r; ...]``."""
    if parts == 1 or n == 1:
        return w
    return w.reshape(parts, n, -1, *w.shape[1:]).transpose(0, 1).reshape(w.shape)


def from_sharded_layout(w: torch.Tensor, parts: int, n: int) -> torch.Tensor:
    """The inverse of :func:`to_sharded_layout`."""
    if parts == 1 or n == 1:
        return w
    return w.reshape(n, parts, -1, *w.shape[1:]).transpose(0, 1).reshape(w.shape)


# --- applying the plan ---------------------------------------------------------------------------


def shard_model(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Apply the mesh's ``tensor`` and ``fsdp`` sharding to ``model`` in
    place (the reference's ``shard_model_state``). A no-op where both are 1."""
    shape = mesh_shape(mesh)
    n_tp, n_fsdp = shape["tensor"], shape["fsdp"]
    if n_tp == 1 and n_fsdp == 1:
        return model
    from torch.distributed.tensor import Shard, distribute_tensor

    linears = {name[: -len(".weight")]: spec for name, spec in annotated_linears(model).items()}
    modules = dict(model.named_modules())
    for name in linears:
        lin = modules[name]
        if not hasattr(lin, "tp") or lin.bias is not None:
            raise NotImplementedError(f"{name} is a {type(lin).__name__}: sharding covers the plain, bias-free "
                                      "Linear projections (not LoRA-wrapped ones)")
    if n_tp > 1:
        group = axis_group(mesh, "tensor")
        tp_mesh = mesh["tensor"]
        for name, (kind, parts) in linears.items():
            lin = modules[name]
            w = lin.weight.detach()
            if kind == "column":
                w = distribute_tensor(to_sharded_layout(w, parts, n_tp), tp_mesh, [Shard(0)])
            else:
                w = distribute_tensor(w, tp_mesh, [Shard(1)])
            lin.weight = torch.nn.Parameter(w, requires_grad=lin.weight.requires_grad)
            lin.tp = (kind, group)
        for name, module in model.named_modules():
            if not getattr(module, "tp_plan", None) or not hasattr(module, "num_heads"):
                continue
            if module.num_heads % n_tp:
                raise ValueError(f"{name}: {module.num_heads} heads do not divide over tensor={n_tp}")
            module.num_heads //= n_tp
            for norm in module.modules():
                if hasattr(norm, "tp_group"):
                    norm.tp_group = group
    if n_fsdp > 1:
        from torch.distributed.fsdp import fully_shard

        dp_mesh = mesh["data", "fsdp"]
        for name, (kind, parts) in linears.items():
            # the "embed" dim: the input columns of a column-parallel weight [out, in], the rows of a row one
            fully_shard(modules[name], mesh=dp_mesh, shard_placement_fn=lambda p, d=(1 if kind == "column" else 0):
                        Shard(d))
    model._parallel_layout = {name + ".weight": (kind, parts, n_tp) for name, (kind, parts) in linears.items()}
    return model


def is_fsdp_managed(p: torch.Tensor) -> bool:
    return is_dtensor(p) and "fsdp" in (p.device_mesh.mesh_dim_names or ())


def sync_grads(params: Iterable[torch.nn.Parameter], mesh) -> None:
    """Average the gradients FSDP2 did not average over ``(data, fsdp)``,
    one all-reduce a dtype (DDP). Call once per update, after backward."""
    group = axis_group(mesh, ("data", "fsdp"))
    if group is None:
        return
    n = dist.get_world_size(group)
    grads = [_local(p.grad) for p in params if p.grad is not None and not is_fsdp_managed(p)]
    for dtype in sorted({g.dtype for g in grads}, key=str):
        same = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        offset = 0
        for g in same:
            g.copy_(flat[offset: offset + g.numel()].view_as(g))
            offset += g.numel()


# --- whole tensors for checkpoints ---------------------------------------------------------------------


def full_tensor(model: torch.nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` (a parameter named ``name`` of ``model``, or a tensor placed like
    it: its EMA, an optimizer moment) whole and in the reference's layout.
    Collective when ``t`` is a DTensor: every rank calls it."""
    if not is_dtensor(t):
        return t
    t = t.full_tensor()
    kind, parts, n_tp = getattr(model, "_parallel_layout", {}).get(name, ("", 1, 1))
    return from_sharded_layout(t, parts, n_tp) if kind == "column" else t


def shard_like(model: torch.nn.Module, name: str, like: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """A whole tensor ``full`` (the reference's layout) in the placement of
    ``like`` (the parameter ``name``, or a tensor placed like it)."""
    if not is_dtensor(like):
        return full.to(device=like.device, dtype=like.dtype)
    from torch.distributed.tensor import distribute_tensor

    kind, parts, n_tp = getattr(model, "_parallel_layout", {}).get(name, ("", 1, 1))
    if kind == "column":
        full = to_sharded_layout(full, parts, n_tp)
    return distribute_tensor(full.to(device=_local(like).device, dtype=like.dtype), like.device_mesh,
                             like.placements)


def full_state_dict(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """``model.state_dict()`` with every DTensor gathered whole, in the
    reference's layout (collective)."""
    return {k: full_tensor(model, k, v) for k, v in model.state_dict().items()}


def full_tensors(model: torch.nn.Module, tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """:func:`full_tensor` of each entry of a ``{parameter name: tensor}`` dict (collective)."""
    return {k: full_tensor(model, k, v) for k, v in tensors.items()}


# --- the batch ---------------------------------------------------------------------------------------


def shard_batch(x: Any, mesh) -> Any:
    """This rank's rows of a global batch (array or tensor, or a dict/list
    tree of them): the contiguous slice at its ``(data, fsdp)`` coordinate,
    the axes the reference's ``batch_sharding`` shards over (:53-56); the
    loader (``data/loader.py``) slices a global batch's indices the same way."""
    index, count = batch_shard(mesh)
    if isinstance(x, dict):
        return {k: shard_batch(v, mesh) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not isinstance(x, str):
        return type(x)(shard_batch(v, mesh) for v in x)
    if count == 1 or not isinstance(x, (np.ndarray, torch.Tensor)) or x.ndim == 0:
        return x
    if x.shape[0] % count:
        raise ValueError(f"global batch {x.shape[0]} not divisible by the {count} (data, fsdp) shards")
    local = x.shape[0] // count
    return x[index * local:(index + 1) * local]
