"""Slice P1 through the CLIs: ``train_cifar10_{moe,ring_attention,pipeline}``
trained by the port's ``train_diffusion`` CLI under one two-process
``torchrun`` on the CPU (gloo), the three configs in turn, each on its own
``trainer.mesh`` (``expert: 2``, ``sp: 2``, ``pipe: 2``) over the two
processes, shrunk as tests/test_parallel_configs.py shrinks them (depth 2,
width 32, 2 heads, MLP ratio 2, global batch 8, one epoch) on CIFAR-10
pickles written from a seed; and ``scripts/dryrun_multichip.py``'s checks
on a world of 4 processes (tests/_torch_port_ranks.py).

Each run must end with finite train and validation losses, one row of each
in metrics.jsonl (the tracker is rank 0's), a validation image grid
(generation runs on both ranks) and whole checkpoints.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_port_ranks import run_ranks

from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT, MoEMlp
from diffulab_tpu_torch.training.checkpoint import restore_train_modules

ROOT = Path(__file__).resolve().parents[1]
SHRINK = ["model.depth=2", "model.inner_dim=32", "model.embedding_dim=32", "model.num_heads=2", "model.mlp_ratio=2",
          "dataloader.batch_size=8", "trainer.n_epoch=1", "diffuser.n_steps=4", "trainer.val_steps=2"]
CONFIGS = {"train_cifar10_moe": "cifar10_moe", "train_cifar10_ring_attention": "cifar10_ring_attention",
           "train_cifar10_pipeline": "cifar10_pipeline"}


def _env() -> dict:
    return {**os.environ, "OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_cifar10(root: Path, per_batch: int = 16, val: int = 16, seed: int = 0) -> None:
    """CIFAR-10 python pickles from a seed (data_batch_1-4 train, 5 validation)."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(1, 6):
        n = per_batch if i < 5 else val
        with open(root / f"data_batch_{i}", "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         "labels": rng.integers(0, 10, n).tolist()}, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three configs trained in turn by one two-process torchrun; {config: save path} and its log."""
    cifar = tmp_path_factory.mktemp("cifar")
    write_cifar10(cifar)
    saves = {config: tmp_path_factory.mktemp(config) for config in CONFIGS}
    argv = [["--device", "cpu", "--config-name", config, *SHRINK, f"dataset.train.data_path={cifar}",
             f"dataset.val.data_path={cifar}", f"trainer.save_path={save}"] for config, save in saves.items()]
    argv_file = cifar / "argv.json"
    argv_file.write_text(json.dumps(argv))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
           "--master-port", str(_free_port()), str(ROOT / "tests" / "_torch_port_ranks.py"), "--train",
           str(argv_file)]
    proc = subprocess.run(cmd, cwd=cifar, env={**_env(), "WANDB_MODE": "disabled"}, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=240)
    return proc.returncode, proc.stdout, saves


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_parallel_config_trains_under_torchrun(config, runs):
    returncode, log, saves = runs
    assert returncode == 0, log[-6000:]
    save = saves[config]
    run = save / CONFIGS[config]
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    train = [r["train/loss"] for r in rows if "train/loss" in r]
    val = [r["val/loss"] for r in rows if "val/loss" in r]
    assert len(train) == len(val) == 1 and np.isfinite(train + val).all()
    assert rows[0]["step"] == 64 // 8  # 64 images, a global batch of 8
    assert len(list((run / "images").glob("val_images_step*.png"))) == 1
    # the checkpoint is whole: it loads into a one-process model of the config's shape
    kw = dict(simple_dit=True, input_channels=3, inner_dim=32, embedding_dim=32, num_heads=2, mlp_ratio=2,
              patch_size=2, depth=2, n_classes=10)
    if config == "train_cifar10_moe":
        kw.update(mlp_type="moe", n_experts=8, capacity_factor=2.0)
    model = MMDiT(**kw, device="cpu")
    restore_train_modules(run / "checkpoints" / "ema", model)
    assert (config != "train_cifar10_moe") or isinstance(model.layers[0].mlp_input, MoEMlp)
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_dryrun_multichip_at_four_processes(tmp_path):
    lines = run_ranks(4, {"dryrun": {"case": "dryrun"}}, tmp_path)["dryrun"][0]
    assert lines[0] == "dryrun mesh: data=1 fsdp=2 tensor=2"
    assert "1.60x shrink" in lines[1] and lines[2].startswith("dryrun_multichip ok on 4 processes")
