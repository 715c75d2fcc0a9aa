"""Slice D1, ``configs/train_synthetic_ddpm.yaml`` (the ADM UNet under
Gaussian diffusion), through the port's CLIs on the CPU at a toy size:
``train_diffusion`` (2 epochs of 64 16x16 samples, post-hoc EMA on,
validation images by DDIM respaced to ``trainer.val_steps``),
``reconstruct_ema`` and ``sample`` (DDIM respaced by ``--steps``, CFG, and a
DDPM and a DeepCache request). The config composes exactly as the JAX
package composes it, and its model target resolves to the port's UNet.
"""

import json
import sys

import numpy as np
import pytest
import torch

from diffulab_tpu.config.compose import compose_config as jax_compose
from diffulab_tpu_torch.config import compose_config
from diffulab_tpu_torch.config.instantiate import instantiate, locate
from diffulab_tpu_torch.examples import reconstruct_ema, sample, train_diffusion
from diffulab_tpu_torch.networks.denoisers.unet import UNetModel

CONFIG = "train_synthetic_ddpm"
CONFIGS = train_diffusion.CONFIG_DIR
#: 2 levels of 32 / 64 channels on 16x16 images, attention at ds 2 (D = 32) and in the middle
MODEL_OVERRIDES = ["model.model_channels=32", "model.channel_mult=1, 2", "model.attention_resolutions=[2]",
                   "model.image_size=[16, 16]", "dataset.train.image_size=16", "dataset.val.image_size=16"]
TINY_OVERRIDES = MODEL_OVERRIDES + ["dataset.train.n_samples=64", "dataset.val.n_samples=32",
                                    "dataloader.batch_size=32", "trainer.n_epoch=2", "trainer.val_steps=2",
                                    "trainer.posthoc_ema=true"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)


def test_config_composes_like_jax_and_builds_the_port_unet():
    cfg = compose_config(CONFIGS, CONFIG)
    assert cfg == jax_compose(CONFIGS, CONFIG)
    assert cfg["model"]["_target_"] == "diffulab_tpu.networks.denoisers.unet.UNetModel"
    assert locate(cfg["model"]["_target_"]) is UNetModel
    assert cfg["diffuser"] == {"model_type": "gaussian_diffusion", "n_steps": 1000, "sampling_method": "ddim",
                               "extra_args": {}}
    assert cfg["trainer"]["precision_type"] == "no" and cfg["trainer"]["val_steps"] == 50
    model = instantiate(compose_config(CONFIGS, CONFIG, MODEL_OVERRIDES)["model"], device="cpu")
    assert isinstance(model, UNetModel) and model.classifier_free and model.n_classes == 10
    # the full-width config's attention: 2 heads of 192 at ds 4, of 384 at ds 8 and in the middle
    full = compose_config(CONFIGS, CONFIG)["model"]
    widths = [96 * int(m) for m in full.get("channel_mult", "1, 2, 4, 8").split(",")]
    assert [w // full["num_heads"] for w in widths[2:]] == [192, 384]


@pytest.fixture(scope="module")
def ddpm_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("d1")
    (trainer,) = train_diffusion.main(["--device", "cpu", "--config-name", CONFIG, *TINY_OVERRIDES,
                                       f"trainer.save_path={root}"])
    return root / "synthetic_ddpm", trainer


def test_train_cli_runs_the_gaussian_unet_with_posthoc_ema(ddpm_run):
    run, trainer = ddpm_run
    assert trainer.step == 4
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in rows if "train/loss" in r] + [r["val/loss"] for r in rows if "val/loss" in r]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert len(sorted((run / "images").glob("val_images_step*.png"))) == 2
    assert len(sorted((run / "checkpoints" / "phema").glob("step*_g*"))) == 4


@pytest.mark.parametrize("flags", [["--steps", "3"], ["--sampler", "ddpm", "--steps", "3"],
                                   ["--steps", "4", "--cache-interval", "2", "--cache-span", "2", "6"]],
                         ids=["ddim", "ddpm", "deepcache"])
def test_reconstruct_then_sample(ddpm_run, tmp_path, flags):
    run, _ = ddpm_run
    results = reconstruct_ema.main(["--run-dir", str(run), "--sigma-rel", "0.05"])
    assert abs(float(results[0]["weights"].sum()) - 1.0) < 5e-2
    result = sample.main(["--device", "cpu", "--config-name", CONFIG, "--ckpt",
                          str(run / "checkpoints" / "phema_sr0.05"), "--n", "4", "--guidance", "1.5", "--labels",
                          "0,1", "--out", str(tmp_path / "grid.png"), *flags, *MODEL_OVERRIDES])
    images = result["images"]
    assert images.shape == (4, 16, 16, 3) and np.isfinite(images).all()
    assert (images >= 0).all() and (images <= 1).all() and (tmp_path / "grid.png").is_file()
