"""Parallelism on torch.distributed (port of diffulab_tpu/parallel): the
six-axis mesh, the sharding rules, expert parallelism and GPipe."""

from diffulab_tpu_torch.parallel.mesh import MeshConfig, initialize_distributed, is_main_process, make_mesh
from diffulab_tpu_torch.parallel.moe import ExpertMlp, expert_parallel_mlp, moe_mlp_local, route_top1
from diffulab_tpu_torch.parallel.pipeline import pipeline_apply, stack_block_params
from diffulab_tpu_torch.parallel.sharding import full_state_dict, param_specs, shard_batch, shard_model

__all__ = [
    "ExpertMlp",
    "MeshConfig",
    "expert_parallel_mlp",
    "full_state_dict",
    "initialize_distributed",
    "is_main_process",
    "make_mesh",
    "moe_mlp_local",
    "param_specs",
    "pipeline_apply",
    "route_top1",
    "shard_batch",
    "shard_model",
    "stack_block_params",
]
