"""Multi-process dry run of the port's sharding on the CPU (the torch-only
counterpart of ``__graft_entry__.py::_dryrun_impl``).

Starts N gloo processes on this host, factors N into ``data x fsdp x
tensor`` as the reference does (2-way tensor and 2-way fsdp where N allows,
so all three are live), prints the mesh, shards a small DiT on it, and
checks that the sharding is real and right:

- every qkv / MLP / projection weight carries an ``fsdp`` or ``tensor``
  shard, and some weight carries each live axis;
- each process's parameter bytes equal the bytes its placements imply and,
  with ``fsdp x tensor`` > 1, are below the replicated total;
- one sharded train step (AdamW) is finite, and its loss equals a
  replicated one-process evaluation of the same loss on the same batch and
  draws.

    python -m diffulab_tpu_torch.scripts.dryrun_multichip --devices 4
    # expect "dryrun mesh: data=1 fsdp=2 tensor=2" and "dryrun_multichip ok"
"""

from __future__ import annotations

import argparse
import os
import socket

import numpy as np
import torch

MODEL = dict(simple_dit=True, input_channels=4, inner_dim=64, embedding_dim=64, num_heads=4, mlp_ratio=2,
             patch_size=2, depth=2, n_classes=10, classifier_free=True)


def factor(n: int) -> tuple[int, int, int]:
    """(data, fsdp, tensor) of n devices, as the reference factors them."""
    tensor = 2 if n % 2 == 0 else 1
    fsdp = 2 if n % (tensor * 2) == 0 else 1
    return n // (tensor * fsdp), fsdp, tensor


def _loss(model, x0, y, rows: slice, global_batch: int, seed: int):
    """The loss on ``x0``/``y``, the global batch's ``rows``, with t, noise
    and the drop mask drawn for the global batch (their rows kept)."""
    from diffulab_tpu_torch.diffuse import Diffuser

    g = torch.Generator().manual_seed(seed)
    diffusion = Diffuser(model, "euler", n_steps=4).diffusion
    t = diffusion.draw_timesteps(g, global_batch)[rows]
    noise = torch.randn((global_batch, *x0.shape[1:]), generator=g)[rows]
    drop = (torch.rand(global_batch, generator=g) < 0.1)[rows]
    return diffusion.compute_loss(Diffuser._model_fn(model, train=True), x0, {"y": y}, t, noise, drop=drop)["loss"]


def run_checks() -> list[str]:
    """The checks on the started process group's world; returns the lines
    rank 0 reports (every rank runs the collectives)."""
    import torch.distributed as dist

    from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
    from diffulab_tpu_torch.parallel.mesh import MeshConfig, axis_group, batch_shard, make_mesh
    from diffulab_tpu_torch.parallel.sharding import param_specs, shard_model, sync_grads
    from diffulab_tpu_torch.training import optim as toptim
    from diffulab_tpu_torch.training.trainer import MultiStepOptimizer

    world = dist.get_world_size()
    data, fsdp, tensor = factor(world)
    mesh = make_mesh(MeshConfig(data=data, fsdp=fsdp, tensor=tensor))
    lines = [f"dryrun mesh: data={data} fsdp={fsdp} tensor={tensor}"]

    torch.manual_seed(0)
    model = MMDiT(**MODEL, device="cpu")
    with torch.no_grad():  # the adaLN-zero modulations would leave the blocks out of the loss
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    replicated = MMDiT(**MODEL, device="cpu")
    replicated.load_state_dict(model.state_dict())
    specs = param_specs(model, mesh)
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    shard_model(model, mesh)

    # (a) the annotated weights carry their axes
    live = {"fsdp": fsdp > 1, "tensor": tensor > 1}
    for name, spec in specs.items():
        if name.endswith(("qkv.weight", "fc_in.weight", "fc_out.weight", "proj_out.weight")) and any(live.values()):
            assert any(a in spec for a in ("fsdp", "tensor")), f"matmul weight {name} is replicated: {spec}"
    for axis, on in live.items():
        assert not on or any(axis in s for s in specs.values()), f"no parameter carries a {axis} shard"

    # (b) each process's bytes are what the placements imply
    def local_bytes(p):
        local = p.to_local() if hasattr(p, "to_local") else p
        return local.numel() * local.element_size()

    ours = sum(local_bytes(p) for p in model.parameters())
    expected = 0
    for name, p in replicated.named_parameters():
        shards = int(np.prod([{"fsdp": fsdp, "tensor": tensor}[a] for a in specs[name] if a]))
        expected += p.numel() * p.element_size() // shards
    assert ours == expected, f"per-process bytes {ours} != placement-implied {expected}: shardings not applied"
    if fsdp * tensor > 1:
        assert ours < total, f"parameters fully replicated: {ours} == total {total}"
        lines.append(f"dryrun sharding: per-process param bytes {ours} / {total} total "
                     f"({total / ours:.2f}x shrink, fsdp x tensor = {fsdp * tensor})")

    # (c) one sharded step, and its loss against the replicated one
    rng = np.random.default_rng(0)
    global_batch = data * fsdp * 2
    x0 = torch.from_numpy(rng.standard_normal((global_batch, 8, 8, 4)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, global_batch))
    index, count = batch_shard(mesh)
    rows = slice(index * global_batch // count, (index + 1) * global_batch // count)
    group = axis_group(mesh, ("data", "fsdp"))
    opt = MultiStepOptimizer(toptim.adamw(lr=1e-4)(list(model.parameters())),
                             grad_sync=None if group is None else (lambda ps: sync_grads(ps, mesh)))
    loss = _loss(model, x0[rows], y[rows], rows, global_batch, 0)
    loss.backward()
    opt.step()
    loss = loss.detach().reshape(1)
    if group is not None:
        dist.all_reduce(loss, group=group)
        loss /= dist.get_world_size(group)
    loss = float(loss)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    with torch.no_grad():
        single = float(_loss(replicated, x0, y, slice(None), global_batch, 0))
    assert abs(loss - single) <= 1e-4 * max(1.0, abs(single)), f"sharded loss {loss} != replicated loss {single}"
    lines.append(f"dryrun_multichip ok on {world} processes; loss={loss:.4f} "
                 f"(sharded/replicated parity {loss:.6f}/{single:.6f})")
    return lines


def _worker(rank: int, world: int, port: int) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    lines = run_checks()
    if rank == 0:
        print("\n".join(lines), flush=True)
    dist.destroy_process_group()


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--devices", type=int, default=4, help="gloo processes on this host")
    args = parser.parse_args(argv)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    torch.multiprocessing.start_processes(_worker, args=(args.devices, port), nprocs=args.devices,
                                          start_method="spawn")


if __name__ == "__main__":
    main()
