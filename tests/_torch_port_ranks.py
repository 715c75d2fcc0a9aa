"""Multi-rank harness of the port's parallel tests: N gloo processes on the CPU.

A world of N processes of this file is started once per test process and
world size, and serves every job sent to it until the test process exits
(the imports and the process group are paid once). :func:`run_ranks`
writes ``{case: payload}`` (numpy arrays and plain values) to a directory,
sends it to the world of N, and returns ``{case: [rank 0's result, rank
1's, ...]}`` (:func:`launch_ranks` and :func:`collect` do it in two halves,
so that several worlds run at once). Each process has the ``torchrun``
environment variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``),
starts the gloo group, sets one thread, and runs a job's cases in order; a
case builds its own mesh over the world (``make_mesh``), so one world
serves several mesh shapes. This file imports torch, numpy and the port
only: the references are the JAX package's, computed in the test's own
process.

    python tests/_torch_port_ranks.py            # a world's process: job directories on stdin
    torchrun --nproc-per-node N tests/_torch_port_ranks.py --train <argv.json>
        # the port's train_diffusion CLI on each argument list in turn, in one process group
"""

from __future__ import annotations

import atexit
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _World:
    """N processes of this file, each reading job directories on its stdin."""

    def __init__(self, n: int):
        self.n = n
        self.logdir = Path(tempfile.mkdtemp(prefix=f"torch_port_world{n}_"))
        env = {**os.environ, "WORLD_SIZE": str(n), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
               "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
        self.procs = []
        for r in range(n):
            with open(self.logdir / f"rank{r}.log", "w") as log:
                self.procs.append(subprocess.Popen([sys.executable, __file__], env={**env, "RANK": str(r),
                                                                                   "LOCAL_RANK": str(r)},
                                                   stdin=subprocess.PIPE, stdout=log, stderr=subprocess.STDOUT,
                                                   text=True))

    def submit(self, workdir: Path) -> None:
        for p in self.procs:
            p.stdin.write(f"{workdir}\n")
            p.stdin.flush()

    def logs(self) -> str:
        return "\n".join(f"--- rank {r}\n{(self.logdir / f'rank{r}.log').read_text()[-4000:]}"
                         for r in range(self.n))

    def close(self, kill: bool = False) -> None:
        for p in self.procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in self.procs:
            try:
                if kill:
                    raise subprocess.TimeoutExpired(p.args, 0)
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(self.logdir, ignore_errors=True)


_WORLDS: dict[int, _World] = {}


@atexit.register
def _close_worlds() -> None:
    while _WORLDS:
        _WORLDS.popitem()[1].close()


def launch_ranks(world: int, cases: dict, workdir: Path):
    """Send ``cases`` to the world of N processes (started on first use); :func:`collect` waits for them."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    with open(workdir / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    if world not in _WORLDS:
        _WORLDS[world] = _World(world)
    _WORLDS[world].submit(workdir)
    return workdir, cases, _WORLDS[world]


def collect(handle, timeout: float = 240) -> dict:
    """``{case: [rank 0's result, rank 1's, ...]}`` of a launched job."""
    workdir, cases, world = handle
    files = [workdir / f"rank{r}.pkl" for r in range(world.n)]
    deadline = time.monotonic() + timeout
    while not all(f.exists() for f in files):
        dead = [(r, p.returncode) for r, p in enumerate(world.procs) if p.poll() is not None]
        if dead or time.monotonic() > deadline:
            if _WORLDS.get(world.n) is world:
                del _WORLDS[world.n]
            logs = world.logs()
            world.close(kill=True)
            raise RuntimeError(f"ranks {dead or 'timed out'} in {workdir}:\n{logs}")
        time.sleep(0.05)
    results = []
    for f in files:
        with open(f, "rb") as fh:
            results.append(pickle.load(fh))
    return {case: [res[case] for res in results] for case in cases}


def run_ranks(world: int, cases: dict, workdir: Path, timeout: float = 240) -> dict:
    return collect(launch_ranks(world, cases, workdir), timeout)


# --- the cases (run in the worker processes) ---------------------------------------------------------


def _np(t):
    import torch

    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    return t


def _tiny_model(p, **overrides):
    """The port's tiny DiT of ``p["config"]`` with the bridged weights ``p["params"]``."""
    import torch

    from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
    from diffulab_tpu_torch.weights import state_dict_from_jax

    torch.manual_seed(0)
    model = MMDiT(**p["config"], **overrides, device="cpu")
    model.load_state_dict(state_dict_from_jax(p["params"]), strict=True)
    return model


def case_moe(p):
    """expert_parallel_mlp on the ``expert`` axis: output, aux and every gradient."""
    import torch

    from diffulab_tpu_torch.parallel.mesh import axis_group, make_mesh
    from diffulab_tpu_torch.parallel.moe import ExpertMlp, expert_parallel_mlp

    mesh = make_mesh(p["mesh"])
    e, d, h = p["w_in"].shape
    mlp = ExpertMlp(e, d, h, device="cpu")
    with torch.no_grad():
        for k in ("w_in", "w_out", "w_gate"):
            getattr(mlp, k).copy_(torch.from_numpy(p[k]))
    x = torch.from_numpy(p["x"]).requires_grad_()
    y, aux = expert_parallel_mlp(mlp, x, group=axis_group(mesh, "expert"), capacity_factor=p["capacity_factor"])
    ((y * torch.from_numpy(p["r"])).sum() + p["lb_coeff"] * aux["load_balance_loss"]).backward()
    return {"y": _np(y), "aux": _np(aux), "grads": {"x": _np(x.grad), **{k: _np(getattr(mlp, k).grad)
                                                                         for k in ("w_in", "w_out", "w_gate")}}}


def case_ring(p):
    """sequence_parallel_attention on the ``sp`` axis: output and dq, dk, dv."""
    import torch

    from diffulab_tpu_torch.ops.ring_attention import sequence_parallel_attention
    from diffulab_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(p["mesh"])
    q, k, v = (torch.from_numpy(p[n]).requires_grad_() for n in ("q", "k", "v"))
    mask = None if p["mask"] is None else torch.from_numpy(p["mask"])
    out = sequence_parallel_attention(mesh, "sp")(q, k, v, kv_mask=mask, scale=p["scale"])
    (out * torch.from_numpy(p["r"])).sum().backward()
    return {"out": _np(out), "dq": _np(q.grad), "dk": _np(k.grad), "dv": _np(v.grad)}


def case_pipeline(p):
    """pipeline_apply on a toy layer stack over ``pipe``: output and gradients,
    or the error of a bad shape."""
    import torch

    from diffulab_tpu_torch.parallel.mesh import make_mesh
    from diffulab_tpu_torch.parallel.pipeline import pipeline_apply

    mesh = make_mesh(p["mesh"])
    params = {k: torch.from_numpy(p[k]).requires_grad_() for k in ("w", "b")}
    x = torch.from_numpy(p["x"]).requires_grad_()

    def stage(layer, state):
        return {**state, "x": torch.tanh(state["x"] @ layer["w"] + layer["b"])}

    try:
        out = pipeline_apply(stage, params, {"x": x}, mesh=mesh, axis="pipe", n_microbatches=p["m"])["x"]
    except ValueError as e:
        return {"error": str(e)}
    (out * torch.from_numpy(p["r"])).sum().backward()
    return {"out": _np(out), "dx": _np(x.grad), "dw": _np(params["w"].grad), "db": _np(params["b"].grad)}


def case_model(p):
    """The tiny DiT (MoE, ring or pipelined by ``p["config"]``) with the mesh
    set: its output and every parameter's gradient."""
    import torch

    from diffulab_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(p["mesh"])
    model = _tiny_model(p)
    model.set_parallel_mesh(mesh)
    x, t, y = (torch.from_numpy(p[k]) for k in ("x", "t", "y"))
    out = model(x, t, {"y": y})["x"]
    (out * torch.from_numpy(p["r"])).sum().backward()
    return {"out": _np(out), "grads": {n: _np(q.grad) for n, q in model.named_parameters()}}


def case_train_step(p):
    """One sharded train step: the model sharded on the mesh, this rank's
    rows of the global batch and of the global draws, AdamW with a global-norm
    clip; the batch-mean loss, the updated parameters (whole) and each
    parameter's placement."""
    import torch

    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.parallel.mesh import axis_group, make_mesh
    from diffulab_tpu_torch.parallel.sharding import full_state_dict, shard_batch, shard_model, sync_grads
    from diffulab_tpu_torch.training import optim as toptim
    from diffulab_tpu_torch.training.trainer import MultiStepOptimizer, train_step

    mesh = make_mesh(p["mesh"])
    model = _tiny_model(p)
    model.set_parallel_mesh(mesh)
    shard_model(model, mesh)
    params = list(model.parameters())
    factory = toptim.adamw(lr=p["lr"], grad_clip_norm=p["clip"])
    group = axis_group(mesh, ("data", "fsdp"))
    opt = MultiStepOptimizer(factory(params), 1, factory.grad_clip_norm, None,
                             None if group is None else (lambda ps: sync_grads(ps, mesh)))
    local = {k: torch.from_numpy(shard_batch(p[k], mesh)) for k in ("x0", "y", "t", "noise", "drop")}
    diffuser = Diffuser(model, "euler", n_steps=4)
    losses = train_step(diffuser, opt, None, {"model_inputs": {"x": local["x0"], "y": local["y"]}}, local["t"],
                        local["noise"], local["drop"], 1)
    loss = losses["loss"].reshape(1)
    if group is not None:
        torch.distributed.all_reduce(loss, group=group)
        loss /= torch.distributed.get_world_size(group)
    placements = {n: str(getattr(q, "placements", "plain")) for n, q in model.named_parameters()}
    return {"loss": float(loss), "params": _np(full_state_dict(model)), "placements": placements}


def case_trainer(p):
    """BaseTrainer.train on the mesh over a small in-memory dataset through
    the port's DataLoader (each rank its rows), with a validation epoch and
    its checkpoints; the final parameters whole, the loader's slice, and
    the checkpoint entries restored into placed tensors and gathered back."""
    import torch

    from diffulab_tpu_torch.data.loader import DataLoader
    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.parallel.sharding import full_state_dict, full_tensor, full_tensors, shard_like
    from diffulab_tpu_torch.training import optim as toptim
    from diffulab_tpu_torch.training.checkpoint import restore_checkpoint
    from diffulab_tpu_torch.training.trainer import BaseTrainer, MultiStepOptimizer, _opt_state_map, _restore_placed

    class Data:
        def __len__(self):
            return len(p["x"])

        def __getitem__(self, i):
            return {"model_inputs": {"x": p["x"][i], "y": p["y"][i]}}

    model = _tiny_model(p)
    trainer = BaseTrainer(n_epoch=p["epochs"], save_path=p["save"], device="cpu", mesh=p["mesh"], use_ema=True,
                          ema_update_every=1, async_checkpointing=False, gradient_accumulation_step=p["accum"],
                          posthoc_ema=True)
    loader = DataLoader(Data(), batch_size=p["batch"], shuffle=True, seed=p["seed"], prefetch=0)
    val = DataLoader(Data(), batch_size=p["batch"], shuffle=False, prefetch=0)
    trainer.train(Diffuser(model, "euler", n_steps=2), toptim.adamw(lr=1e-3, grad_clip_norm=p["clip"]), loader, val,
                  log_validation_images=p["images"], val_steps=2, seed=p["seed"])
    loader.set_epoch(0)  # the first epoch's batches, as train() sliced them
    seen = [list(map(int, idx)) for idx in loader._batch_indices()]
    out = {"params": _np(full_state_dict(model)), "slice": (loader.process_index, loader.process_count),
           "first_batch": seen[0], "step": trainer.step, "save": p["save"]}
    ckpt = Path(p["save"]) / "my_project" / "checkpoints"
    torch.distributed.barrier()  # rank 0 has written the checkpoints
    if (ckpt / "ema").exists():
        live = {n: q for n, q in model.named_parameters()}
        out["ema_restored"] = _np(full_tensors(model, _restore_placed(ckpt / "ema", live, model)))
        # a resume's optimizer: the whole moments put back into the shards (as train() loads them), gathered again
        names = list(live)
        opt = MultiStepOptimizer(toptim.adamw(lr=1e-3)(list(live.values())))
        opt.load_state_dict(_opt_state_map(restore_checkpoint(ckpt / "optimizer")["opt_state"], names,
                                           lambda n, v: shard_like(model, n, live[n], v)))
        state = _opt_state_map(opt.state_dict(), names, lambda n, v: full_tensor(model, n, v))
        out["moments_restored"] = {names[int(i)]: _np(m["exp_avg"]) for i, m in state["optimizer"]["state"].items()}
    return out


class GivenDraws:
    """A GRPO train batch's draws, given as arrays for the global batch (the
    JAX trainer's, made by the test): ``x_init``, each group's SDE noise by
    (kind, step) and each group's learn indices."""

    def __init__(self, draws: dict):
        self.draws = draws

    def x_init(self, shape):
        import torch

        assert tuple(shape) == self.draws["x_init"].shape
        return torch.from_numpy(self.draws["x_init"])

    def sample_noise(self, group, start):
        import torch

        assert start == 0  # one chunk: the whole prompt batch
        noise = self.draws["noise"][group]

        def draw(kind, step, shape, dtype):
            assert tuple(shape) == noise[(kind, step)].shape
            return torch.from_numpy(noise[(kind, step)]).to(dtype)

        return draw

    def indices(self, group, steps, k):
        assert len(self.draws["indices"][group]) == k
        return self.draws["indices"][group]


def run_grpo(p, mesh=None):
    """One GRPOTrainer train batch (the luma judge, AdamW) on ``p``'s model and
    prompts, this process's rows of them under a sharded mesh; returns the
    parameters whole and the logged means."""
    import json

    import torch

    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
    from diffulab_tpu_torch.networks.embedders import PrecomputedEmbedder
    from diffulab_tpu_torch.networks.rewards import grpo as tgrpo
    from diffulab_tpu_torch.parallel.mesh import batch_shard
    from diffulab_tpu_torch.parallel.sharding import full_state_dict, shard_batch
    from diffulab_tpu_torch.training import optim as toptim
    from diffulab_tpu_torch.training.grpo_trainer import GRPOTrainer

    embedder = PrecomputedEmbedder(null_embedding=p["null"], null_embedding_seq_len=3, device="cpu")
    model = MMDiT(**p["config"], context_embedder=embedder, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in p["state"].items()}, strict=True)
    trainer = GRPOTrainer(n_epoch=1, save_path=p["save"], project_name="grpo", device="cpu", mesh=mesh,
                          use_ema=False, timestep_fraction=0.5, kl_beta=0.1, eps=0.1, trust_region=0.3,
                          async_checkpointing=False)
    index, count = batch_shard(trainer.mesh)
    rows = slice(index * len(p["captions"]) // count, (index + 1) * len(p["captions"]) // count)
    batch = {"model_inputs": {"context": {"embeddings": torch.from_numpy(shard_batch(p["emb"], trainer.mesh)),
                                          "attn_mask": torch.from_numpy(shard_batch(p["mask"], trainer.mesh))}},
             "extra": {"captions": p["captions"][rows]}}
    rm = tgrpo.PrefGRPORewardModel(n_image_per_prompt=2, judge=tgrpo.LumaJudge())
    trainer.train(Diffuser(model, "euler_maruyama", n_steps=4), rm, toptim.adamw(lr=1e-3, weight_decay=1e-2), [batch],
                  None, n_image_per_prompt=2, guidance_scale=1.5, image_resolution=(8, 8),
                  log_validation_images=False, seed=5, draws=lambda key: GivenDraws(p["draws"]))
    metrics = Path(p["save"]) / "grpo" / "metrics.jsonl"
    rows = [json.loads(line) for line in metrics.read_text().splitlines()] if metrics.exists() else []
    return {"params": _np(full_state_dict(model)), "metrics": rows, "step": trainer.step}


def case_grpo(p):
    return run_grpo(p, p["mesh"])


def case_dryrun(p):
    """scripts/dryrun_multichip.py's checks on the world: the lines rank 0 prints."""
    from diffulab_tpu_torch.scripts.dryrun_multichip import run_checks

    return run_checks()


CASES = {name[len("case_"):]: fn for name, fn in list(globals().items()) if name.startswith("case_")}


def serve() -> None:
    """Run each job directory read on stdin: its cases in order, the results to ``rank<r>.pkl``."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    for line in sys.stdin:
        workdir = Path(line.strip())
        with open(workdir / "cases.pkl", "rb") as f:
            cases = pickle.load(f)
        results = {}
        for name, payload in cases.items():
            results[name] = CASES[payload["case"]](payload)
            dist.barrier()
        out = workdir / f"rank{dist.get_rank()}.pkl"
        with open(out.with_suffix(".tmp"), "wb") as f:
            pickle.dump(results, f)
        os.replace(out.with_suffix(".tmp"), out)
    dist.destroy_process_group()


def train_in_turn(argv_file: str) -> None:
    """The port's train_diffusion CLI on each argument list of ``argv_file``, in one process group."""
    import torch.distributed as dist

    from diffulab_tpu_torch.examples import train_diffusion

    with open(argv_file) as f:
        for argv in json.load(f):
            train_diffusion.main(argv)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == ["--train"]:
        train_in_turn(sys.argv[2])
    else:
        serve()
