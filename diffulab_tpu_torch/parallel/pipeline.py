"""GPipe pipeline parallelism over the mesh's ``pipe`` axis (port of
diffulab_tpu/parallel/pipeline.py).

The reference stacks the homogeneous blocks' parameters along a leading
layer axis, gives each of the S ``pipe`` devices a contiguous stage of L/S
layers, and streams M microbatches through the stages in one ``lax.scan``
of M + S - 1 ticks, rotating the activations one stage on with
``lax.ppermute`` after each tick; the backward reverses the ring. This port
runs the same ticks on every rank of the axis (SPMD): each rank applies its
stage to the activation it holds, the last stage records microbatch
t - (S - 1), and :func:`~._comm.ring_shift` (``batch_isend_irecv``, whose
backward shifts the other way) moves the activations on. The fill and
drain ticks compute on placeholders, as the reference's do, so that every
rank builds the same graph and runs the same collectives in its backward.
The recorded outputs reach every rank of the axis through an all-reduce of
the last stage's (the reference's ``psum``).

Layout contract (the reference's):

- ``stacked_params``: a dict of tensors with leading axis L (total layers);
  L % S == 0. Every rank holds them whole and applies its stage's slice; the
  slice is taken after an all-reduce-backward copy, so each rank ends with
  every layer's full gradient (and so with the inputs' and the stream's).
- ``inputs``: the circulating activations, a dict of [B, ...] tensors; B
  must divide by ``n_microbatches``.
- ``stream``: per-microbatch operands the stages read but never transform
  (conditioning vectors, RoPE tables): they stay on every rank and each
  stage indexes the microbatch it is processing.
- ``stage_fn(layer_params, state) -> state`` applies ONE layer to the merged
  dict ``{**inputs_slice, **stream_slice}``; only the ``inputs`` keys of its
  result go on around the ring.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from diffulab_tpu_torch.parallel import _comm
from diffulab_tpu_torch.parallel.mesh import axis_group

__all__ = ["pipeline_apply", "stack_block_params"]


def pipeline_apply(
    stage_fn: Callable[[dict[str, torch.Tensor], dict[str, torch.Tensor]], dict[str, torch.Tensor]],
    stacked_params: dict[str, torch.Tensor],
    inputs: dict[str, torch.Tensor],
    *,
    mesh,
    axis: str = "pipe",
    n_microbatches: int,
    stream: dict[str, torch.Tensor] | None = None,
) -> dict[str, torch.Tensor]:
    """Run ``inputs`` through all L layers, pipelined over ``mesh[axis]``
    (pipeline.py:53). Returns a dict shaped like ``inputs`` holding the last
    stage's activations, on every rank of the axis."""
    group = axis_group(mesh, axis)
    n_stages, s_idx = _comm._size(group), _comm._rank(group)
    if not stacked_params:
        raise ValueError("stacked_params has no leaves")
    total_layers = next(iter(stacked_params.values())).shape[0]
    if total_layers % n_stages:
        raise ValueError(f"L={total_layers} not divisible by pipe={n_stages}")
    m = n_microbatches
    batch = next(iter(inputs.values())).shape[0]
    if batch % m:
        raise ValueError(f"B={batch} not divisible by M={m}")
    per_stage = total_layers // n_stages
    # every rank uses the replicated parameters, inputs and stream in its own way (its stage, its
    # microbatch): their gradients are summed over the ranks
    local = {k: _comm.copy_to(v, group)[s_idx * per_stage:(s_idx + 1) * per_stage]
             for k, v in stacked_params.items()}
    to_mb = lambda a: _comm.copy_to(a, group).reshape(m, a.shape[0] // m, *a.shape[1:])  # noqa: E731
    xm = {k: to_mb(v) for k, v in inputs.items()}
    stream_m = {k: to_mb(v) for k, v in (stream or {}).items()}
    device = next(iter(inputs.values())).device
    first = torch.tensor(s_idx == 0, device=device)
    last = torch.tensor(s_idx == n_stages - 1, device=device)
    state = {k: torch.zeros_like(v[0]) for k, v in xm.items()}
    outs = {k: [torch.zeros_like(v[0]) for _ in range(m)] for k, v in xm.items()}
    for t in range(m + n_stages - 1):
        # stage 0 takes microbatch t in (the last one again once the stream has drained)
        state = {k: torch.where(first, xm[k][min(t, m - 1)], state[k]) for k in state}
        # the microbatch at stage s during tick t is t - s (clamped in the fill and drain)
        mb = min(max(t - s_idx, 0), m - 1)
        stream_t = {k: v[mb] for k, v in stream_m.items()}
        for i in range(per_stage):
            out = stage_fn({k: v[i] for k, v in local.items()}, {**state, **stream_t})
            state = {k: out[k] for k in state}
        if t >= n_stages - 1:  # the last stage records microbatch t - (S - 1)
            o = t - (n_stages - 1)
            for k in state:
                outs[k][o] = torch.where(last, state[k], outs[k][o])
        if n_stages > 1:
            state = {k: _comm.ring_shift(v, group) for k, v in state.items()}
    result = {}
    for k, parts in outs.items():
        o = torch.stack(parts)
        o = _comm.reduce_from(torch.where(last, o, torch.zeros_like(o)), group)
        result[k] = o.reshape(batch, *o.shape[2:])
    return result


def stack_block_params(blocks: Sequence[torch.nn.Module]) -> dict[str, torch.Tensor]:
    """The blocks' parameters stacked along a leading layer axis, by name
    (differentiable: each layer's slice takes its block's gradient); the
    blocks must share one structure. The reference's ``stack_block_states``."""
    named = [dict(b.named_parameters()) for b in blocks]
    return {name: torch.stack([p[name] for p in named]) for name in named[0]}

