"""Slice C2 through the port's CLIs on the CPU at a toy size (depth 2, width
64, 64 samples, batch 32): every sampler, block caching, autoguidance,
inpainting and img2img of the ``sample`` CLI on a trained flow checkpoint;
``train_synthetic_edm`` and ``train_synthetic_edm_aug`` through
``train_diffusion`` and ``sample``; ``train_synthetic_flow_distill`` with
``trainer.distill_from`` at the flow checkpoint; the ``reflow`` CLI; and the
``rectified_flow_fast`` diffuser (UniPC) on the flow checkpoint. Each output
is checked for its shape and finite values; an inpainting request gives the
known region back exactly.
"""

import json
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from diffulab_tpu_torch.examples import reflow, sample, train_diffusion

TINY_OVERRIDES = ["model.depth=2", "model.inner_dim=64", "model.embedding_dim=64", "model.num_heads=4",
                  "dataset.train.n_samples=64", "dataset.val.n_samples=32", "dataloader.batch_size=32",
                  "trainer.n_epoch=2", "trainer.val_steps=2", "diffuser.n_steps=2"]
MODEL_OVERRIDES = TINY_OVERRIDES[:4]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)


@pytest.fixture(scope="module")
def flow_run(tmp_path_factory):
    """A trained toy flow run, with its epoch-1 post-hoc EMA snapshot kept as
    the ``phema_epoch1`` entry (an early-training model: the autoguidance guide)."""
    root = tmp_path_factory.mktemp("c2")
    train_diffusion.main(["--device", "cpu", "--config-name", "train_synthetic_flow_matching", *TINY_OVERRIDES,
                          f"trainer.save_path={root}"])
    run = root / "synthetic_flow_matching"
    ckpts = run / "checkpoints"
    first = sorted((ckpts / "phema").glob("step*_g6.94"))[0]
    shutil.copytree(first, ckpts / "phema_epoch1")
    png = root / "image.png"
    Image.fromarray((np.random.default_rng(0).uniform(0, 1, (32, 32, 3)) * 255).astype(np.uint8)).save(png)
    return run, png


def _sample(run, out, *flags, config="train_synthetic_flow_matching", ckpt="ema"):
    return sample.main(["--device", "cpu", "--config-name", config, "--ckpt", str(run / "checkpoints" / ckpt),
                        "--n", "4", "--guidance", "1.5", "--labels", "0,1", "--out", str(out), *flags,
                        *TINY_OVERRIDES])


@pytest.mark.parametrize("flags", [
    ["--sampler", "heun"], ["--sampler", "dpmpp_2m", "--steps", "3"], ["--sampler", "unipc", "--steps", "3"],
    ["--sampler", "euler_maruyama"], ["--cache-interval", "2", "--cache-span", "0", "1", "--steps", "4"],
    ["--guide-ckpt", "GUIDE"], ["--inpaint-image", "PNG", "--inpaint-box", "8:24,4:20"],
    ["--img2img-image", "PNG", "--strength", "0.6", "--steps", "4"], ["diffuser=rectified_flow_fast"],
], ids=["heun", "dpmpp_2m", "unipc", "euler_maruyama", "cache", "guide", "inpaint", "img2img", "unipc_fast_config"])
def test_sample_cli_options(flow_run, tmp_path, flags):
    run, png = flow_run
    flags = [str(png) if f == "PNG" else str(run / "checkpoints" / "phema_epoch1") if f == "GUIDE" else f
             for f in flags]
    result = _sample(run, tmp_path / "grid.png", *flags)
    images = result["images"]
    assert images.shape == (4, 32, 32, 3) and np.isfinite(images).all()
    assert (tmp_path / "grid.png").is_file()
    if "--inpaint-image" in flags:
        known, mask = result["inpaint"]["known"], result["inpaint"]["mask"]
        keep = np.broadcast_to(mask, images.shape) > 0
        assert keep.sum() == 4 * (32 * 32 - 16 * 16) * 3
        expected = np.clip(known * 0.5 + 0.5, 0, 1)
        np.testing.assert_array_equal(images[keep], expected[keep])
        assert np.abs(images[~keep] - expected[~keep]).max() > 1e-3


@pytest.mark.parametrize("config", ["train_synthetic_edm", "train_synthetic_edm_aug"])
def test_edm_configs_train_and_sample(tmp_path, config):
    (trainer,) = train_diffusion.main(["--device", "cpu", "--config-name", config, *TINY_OVERRIDES,
                                       "trainer.n_epoch=1", f"trainer.save_path={tmp_path}"])
    assert trainer.step == 2 and trainer.augment_p == (0.12 if config.endswith("aug") else 0.0)
    run = tmp_path / config.removeprefix("train_")
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(r["train/loss"]) for r in rows if "train/loss" in r)
    result = _sample(run, tmp_path / "edm.png", "--steps", "3", config=config, ckpt="denoiser")
    assert result["images"].shape == (4, 32, 32, 3) and np.isfinite(result["images"]).all()
    for sampler in ("dpmpp_2m", "unipc"):
        out = _sample(run, tmp_path / f"{sampler}.png", "--sampler", sampler, "--steps", "3", config=config,
                      ckpt="denoiser")
        assert np.isfinite(out["images"]).all()


def test_distill_cli_from_the_flow_checkpoint(flow_run, tmp_path):
    run, _ = flow_run
    (trainer,) = train_diffusion.main(["--device", "cpu", "--config-name", "train_synthetic_flow_distill",
                                       *TINY_OVERRIDES, "trainer.n_epoch=1",
                                       f"trainer.distill_from={run / 'checkpoints' / 'ema'}",
                                       f"trainer.save_path={tmp_path}"])
    assert trainer.step == 2 and trainer.distill_guidance == 1.5
    rows = [json.loads(line) for line in
            (tmp_path / "synthetic_flow_distill" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert len(losses) == 1 and np.isfinite(losses[0])


def test_reflow_cli(flow_run, tmp_path):
    run, _ = flow_run
    trainer = reflow.main(["--device", "cpu", "--ckpt", str(run / "checkpoints" / "ema"), "--n-pairs", "8",
                           "--val-pairs", "4", "--pair-steps", "2", "--epochs", "1", "--batch-size", "4",
                           *MODEL_OVERRIDES, f"trainer.save_path={tmp_path}"])
    assert trainer.step == 2
    rows = [json.loads(line) for line in
            (tmp_path / "synthetic_flow_matching_reflow" / "metrics.jsonl").read_text().splitlines()]
    assert any("val/loss" in r and np.isfinite(r["val/loss"]) for r in rows)


def test_reflow_cli_device_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert reflow.parse_args(["--ckpt", str(tmp_path)]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reflow.main(["--ckpt", str(tmp_path)])
