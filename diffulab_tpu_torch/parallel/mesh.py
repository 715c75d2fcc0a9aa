"""The device mesh on torch.distributed (port of diffulab_tpu/parallel/mesh.py).

The mesh has the reference's six axes, ``("data", "fsdp", "tensor", "sp",
"expert", "pipe")``:

- ``data``: data parallelism, a gradient all-reduce (DDP);
- ``fsdp``: the "embed" dimension of the annotated weights sharded by FSDP2's
  ``fully_shard``, replicated over ``data``; the batch shards over
  ``(data, fsdp)`` jointly;
- ``tensor``: Megatron tensor parallelism of the annotated linears, by head;
- ``sp``: ring attention over the token axis (:mod:`..ops.ring_attention`);
- ``expert``: the switch-MoE's all-to-all dispatch (:mod:`.moe`);
- ``pipe``: GPipe stages of the DiT block stack (:mod:`.pipeline`).

:func:`make_mesh` returns a :class:`~torch.distributed.device_mesh.DeviceMesh`
with those dim names over the processes of the default group, one process a
device. A run launched by ``torchrun`` starts that group through
:func:`initialize_distributed` (NCCL on the card, gloo with
``device="cpu"``). A single process needs no launcher and no group: its
mesh, the counterpart of the one-device mesh the reference builds on one
chip, is the dict of its six axis sizes, every one 1, which every function
here takes in place of a DeviceMesh.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

AXIS_NAMES = ("data", "fsdp", "tensor", "sp", "expert", "pipe")

#: the meshes made in this process, by (dims, device type): a mesh's groups are made once
_MESHES: dict[tuple, Any] = {}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh axis sizes. ``data=-1`` absorbs all remaining devices; ``sp``,
    ``expert`` and ``pipe`` default to 1, so every config shares one 6-axis
    mesh shape."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    sp: int = 1
    expert: int = 1
    pipe: int = 1

    def resolve(self, n_devices: int | None = None) -> tuple[int, int, int, int, int, int]:
        """The six axis sizes for ``n_devices`` (default: the world size).
        Raises ``AssertionError`` with the reference's messages."""
        n = n_devices if n_devices is not None else world_size()
        fixed = self.fsdp * self.tensor * self.sp * self.expert * self.pipe
        data = self.data
        if data == -1:
            if n % fixed != 0:
                raise AssertionError(f"device count {n} not divisible by fsdp*tensor*sp*expert*pipe={fixed}")
            data = n // fixed
        if data * fixed != n:
            raise AssertionError(f"mesh {data}x{self.fsdp}x{self.tensor}x{self.sp}x{self.expert}x{self.pipe}"
                                 f" != device count {n}")
        return data, self.fsdp, self.tensor, self.sp, self.expert, self.pipe


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize_distributed(device: str | torch.device | None = None) -> torch.device | None:
    """Start the default process group from the ``torchrun`` environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``):
    NCCL when ``device`` is the card (each process on card ``LOCAL_RANK``),
    gloo on the CPU. Without that environment, or with a group already
    started, it does nothing (the reference's ``jax.distributed.initialize``
    is a no-op on one host). Returns the process's device, or ``device``."""
    device = torch.device("cuda" if device is None else device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device


def is_main_process() -> bool:
    """Rank-0 gating of the tracker and of checkpoint writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(config: MeshConfig | dict[str, int] | None = None):
    """A DeviceMesh with dims :data:`AXIS_NAMES` over the default group's
    processes, sized by ``config.resolve(world_size)``; in a world of one,
    the dict of the six axis sizes."""
    if isinstance(config, dict):
        config = MeshConfig(**config)
    config = config or MeshConfig()
    dims = config.resolve(world_size())
    if world_size() == 1:
        return dict(zip(AXIS_NAMES, dims))
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    key = (dims, device_type)
    if key not in _MESHES:
        from torch.distributed.device_mesh import init_device_mesh

        _MESHES[key] = init_device_mesh(device_type, dims, mesh_dim_names=AXIS_NAMES)
    return _MESHES[key]


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` of a mesh (every axis 1 for None; a dict of sizes
    passes through, the axes it leaves out 1)."""
    if mesh is None or isinstance(mesh, dict):
        return {**dict.fromkeys(AXIS_NAMES, 1), **(mesh or {})}
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 on a mesh of sizes)."""
    return 0 if mesh is None or isinstance(mesh, dict) else mesh.get_local_rank(axis)


def axis_group(mesh, axes: str | tuple[str, ...]):
    """The process group of this rank along ``axes`` (one axis or several,
    the first major), or None where their product is 1."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    shape = mesh_shape(mesh)
    if all(shape[a] == 1 for a in axes):
        return None
    axes = tuple(a for a in axes if shape[a] > 1)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = ("joint", id(mesh), axes)
    if key not in _MESHES:
        # every rank makes every group of these axes, in the same order (new_group is collective)
        ranks = mesh.mesh.permute(*[AXIS_NAMES.index(a) for a in AXIS_NAMES if a not in axes],
                                  *[AXIS_NAMES.index(a) for a in axes])
        ranks = ranks.reshape(-1, int(torch.tensor([shape[a] for a in axes]).prod()))
        me = dist.get_rank()
        for row in ranks.tolist():
            group = dist.new_group(row)
            if me in row:
                _MESHES[key] = group
    return _MESHES[key]


def batch_shard(mesh) -> tuple[int, int]:
    """(index, count) of this rank's slice of a global batch: its coordinate
    on ``(data, fsdp)``, ``data`` major (the reference's batch sharding over
    the two axes, sharding.py:53-56), not its global rank."""
    shape = mesh_shape(mesh)
    return axis_index(mesh, "data") * shape["fsdp"] + axis_index(mesh, "fsdp"), shape["data"] * shape["fsdp"]
