"""Expert parallelism: a switch-routed mixture-of-experts MLP with all-to-all
token dispatch over the mesh's ``expert`` axis (port of
diffulab_tpu/parallel/moe.py).

- :class:`ExpertMlp`: E two-layer GELU MLPs with stacked ``w_in [E, d, h]``
  and ``w_out [E, h, d]`` and a router ``w_gate [d, E]``, the reference's
  leaves and layouts (the weight bridge maps them by name);
- :func:`route_top1`: switch routing to the top-1 expert with a fixed
  capacity C, as the reference's one-hot ``dispatch`` / gate-weighted
  ``combine`` tensors ``[T, E, C]``; a token past its expert's capacity is
  dropped (zero combine weight: it passes through as residual only);
- :func:`moe_mlp_local`: one device, no mesh: route, bin, the batched FFN,
  combine;
- :func:`expert_parallel_mlp`: over a group of n ranks, each holding the
  same tokens (the batch shards over ``(data, fsdp)`` alone): each rank
  routes its own 1/n of the tokens with the capacity of that share (trap
  T29), one ``all_to_all_single`` sends every bin to the rank owning its
  expert (E/n experts each), a second one sends the results home, and the
  ranks all-gather the tokens' outputs.

The bins are filled and read by index (a scatter of the kept tokens to
their (expert, slot) and a gather back) where the reference multiplies by
its one-hot ``[T, E, C]`` tensors: each of the reference's sums has one
nonzero term, so the values are the same, and at the MoE DiT's T = 8192
tokens a step the two dense tensors would take 512 MiB each a layer.

The expert weights are stored whole on every rank, as the reference keeps
them (they carry no sharding annotation; its ``shard_map`` slices them);
each rank takes its experts' slice with a split whose backward all-gathers,
so every rank ends with every expert's full gradient. The router is used on
each rank's own tokens, so its gradient is summed over the ranks (T30).
The switch load-balance loss is returned in ``aux`` (the reference sows it;
nothing adds it to the training loss).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from diffulab_tpu_torch.parallel import _comm

__all__ = ["ExpertMlp", "expert_parallel_mlp", "moe_mlp_local", "route_top1"]


class ExpertMlp(nn.Module):
    """E independent 2-layer MLPs with stacked weights [E, ...] (moe.py:37)."""

    def __init__(self, n_experts: int, dim: int, hidden: int, *, dtype=None, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=param_dtype)
        self.w_in = nn.Parameter(torch.randn(n_experts, dim, hidden, **kw) * (2.0 / dim) ** 0.5)
        self.w_out = nn.Parameter(torch.randn(n_experts, hidden, dim, **kw) * (2.0 / hidden) ** 0.5)
        self.w_gate = nn.Parameter(torch.randn(dim, n_experts, **kw) * (2.0 / dim) ** 0.5)
        self.n_experts = n_experts
        self.dtype = dtype

    @staticmethod
    def ffn(w_in: torch.Tensor, w_out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """x [E?, C, d] through the stacked FFNs; ``jax.nn.gelu`` is the tanh
        approximation (trap T2)."""
        h = F.gelu(torch.bmm(x, w_in), approximate="tanh")
        return torch.bmm(h, w_out)


def route_top1(logits: torch.Tensor, capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Switch top-1 routing (moe.py:64): logits [T, E] -> (dispatch, combine),
    both [T, E, C]. The reference's dense form; the MLPs use :func:`_route`."""
    expert, pos, keep, gate, _ = _route(logits, capacity)
    t, e = logits.shape
    dispatch = torch.zeros(t, e, capacity, dtype=torch.float32, device=logits.device)
    rows = torch.nonzero(keep).squeeze(-1)
    dispatch[rows, expert[rows], pos[rows]] = 1.0
    return dispatch, dispatch * gate[:, None, None]


def _route(logits: torch.Tensor, capacity: int):
    """(expert [T], slot [T], keep [T] bool, gate [T] (zero where dropped),
    gates [T, E]) of top-1 routing: a token's slot is the count of earlier
    tokens sent to its expert."""
    gates = torch.softmax(logits.float(), dim=-1)
    expert = torch.argmax(gates, dim=-1)  # the first of equal maxima, as jnp.argmax
    onehot = F.one_hot(expert, logits.shape[-1]).to(torch.float32)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1).to(torch.long)
    keep = pos < capacity
    gate = torch.gather(gates, 1, expert[:, None]).squeeze(1) * keep
    return expert, pos, keep, gate, gates


def _dispatch_combine(experts: ExpertMlp, xt: torch.Tensor, logits: torch.Tensor, capacity: int, n_experts: int,
                      run_ffn) -> tuple[torch.Tensor, torch.Tensor]:
    """Bin the kept tokens ``xt`` [T, d] into [E, C, d], run ``run_ffn`` on
    the bins and combine: y_t = gate_t * out[expert_t, slot_t]. Returns (y, gates)."""
    expert, pos, keep, gate, gates = _route(logits, capacity)
    d = xt.shape[-1]
    kept = torch.nonzero(keep).squeeze(-1)
    slot = expert * capacity + pos.clamp(max=capacity - 1)
    binned = xt.new_zeros(n_experts * capacity, d).index_copy(0, slot[kept], xt[kept])
    out = run_ffn(binned.reshape(n_experts, capacity, d)).reshape(n_experts * capacity, d)
    return out[slot] * gate[:, None], gates


def _aux(logits: torch.Tensor, gates: torch.Tensor, n_experts: int, group=None) -> dict[str, torch.Tensor]:
    """Mean gate entropy and the switch load-balance loss E * sum_i f_i P_i,
    ``f`` and ``P`` averaged over the group's ranks (moe.py:152-168)."""
    n = _comm._size(group)
    entropy = -torch.mean(torch.sum(gates * torch.log_softmax(logits.float(), dim=-1), dim=-1))
    frac = torch.mean(F.one_hot(torch.argmax(gates, dim=-1), n_experts).to(torch.float32), dim=0)
    prob = torch.mean(gates, dim=0)
    if n > 1:
        entropy, frac, prob = (_comm.reduce_from(v, group) / n for v in (entropy, frac, prob))
    return {"gate_entropy": entropy, "load_balance_loss": n_experts * torch.sum(frac * prob)}


def moe_mlp_local(mlp: ExpertMlp, x: torch.Tensor, capacity_factor: float = 2.0):
    """Single-device switch MoE (moe.py:86): capacity
    ``max(1, int(capacity_factor * B * S / E))``. Returns (y in x's dtype, aux)."""
    b, s, d = x.shape
    e = mlp.n_experts
    capacity = max(1, int(capacity_factor * b * s / e))
    xt = x.reshape(-1, d).float()
    logits = xt @ mlp.w_gate.float()
    yt, gates = _dispatch_combine(mlp, xt, logits, capacity, e,
                                  lambda bins: mlp.ffn(mlp.w_in.float(), mlp.w_out.float(), bins))
    return yt.reshape(x.shape).to(x.dtype), _aux(logits, gates, e)


def expert_parallel_mlp(mlp: ExpertMlp, x: torch.Tensor, *, group, capacity_factor: float = 2.0):
    """x [B, S, d], the same on every rank of ``group`` (the ``expert``
    axis), through the expert-parallel MoE (moe.py:107). Each rank routes
    rows ``[r B/n, (r+1) B/n)`` with the capacity of ``t_local = B/n * S``
    tokens; returns [B, S, d] on every rank and the aux dict, its statistics
    averaged over the ranks."""
    n = _comm._size(group)
    b, s, d = x.shape
    e = mlp.n_experts
    if e % n:
        raise ValueError(f"experts {e} not divisible by axis size {n}")
    if b % n:
        raise ValueError(f"batch {b} not divisible by expert x batch shards {n}")
    capacity = max(1, int(capacity_factor * (b // n) * s / e))
    xt = _comm.split(x, group, 0).reshape(-1, d).float()
    logits = xt @ _comm.copy_to(mlp.w_gate, group).float()
    w_in = _comm.split(mlp.w_in, group, 0).float()
    w_out = _comm.split(mlp.w_out, group, 0).float()

    def run_ffn(bins: torch.Tensor) -> torch.Tensor:
        # [E, C, d] -> [E/n, n*C, d]: every rank receives the bins of its own experts from all ranks
        local = _comm.all_to_all(bins.reshape(n, e // n, capacity, d), group)
        local = local.transpose(0, 1).reshape(e // n, n * capacity, d)
        out = mlp.ffn(w_in, w_out, local)
        out = out.reshape(e // n, n, capacity, d).transpose(0, 1).contiguous()
        return _comm.all_to_all(out, group).reshape(e, capacity, d)

    yt, gates = _dispatch_combine(mlp, xt, logits, capacity, e, run_ffn)
    y = _comm.gather(yt.reshape(b // n, s, d), group, 0)
    return y.to(x.dtype), _aux(logits, gates, e, group)
