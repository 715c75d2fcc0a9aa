"""Slice E1 through the port's CLIs on the CPU at a toy size: the six
download-free configs this slice brings up compose exactly as the JAX
package composes them and train through ``train_diffusion``, then
``reconstruct_ema`` and ``sample``:

- ``train_synthetic_hard_flow`` (the hard compositional dataset, bf16, post-hoc
  EMA), reconstructed to ``phema_sr0.05``, which ``train_synthetic_hard_distill``
  distils from (``trainer.distill_from``); the student samples;
- ``train_synthetic_colorize``: the sample request takes the luma of the
  validation images as ``x_context``;
- ``train_synthetic_{flow,edm,ddpm}_repa``: the REPA loss joins the train
  and validation losses; the checkpoints hold the projector with the
  trainable parameters and the frozen FixedViT, unchanged, in ``rest``; the
  sample CLI restores the checkpoint with its extra losses.

Toy sizes: a DiT of depth 2 and width 64, a two-level UNet of width 32 on
16x16, a ViT of one block of width 32, 64 + 32 samples (32x32 for the hard
dataset), batches of 32, one epoch (two for hard_flow), 2 sampling steps.
Also the fp32 policy of every CLI: TF32 off for cuBLAS and cuDNN after
``main`` parses its arguments.
"""

import json
import sys

import numpy as np
import pytest
import torch

from diffulab_tpu.config.compose import compose_config as jax_compose
from diffulab_tpu_torch.config import compose_config
from diffulab_tpu_torch.config.instantiate import locate
from diffulab_tpu_torch.data.synthetic_txt2img import SyntheticCompositionalDataset
from diffulab_tpu_torch.examples import reconstruct_ema, reflow, sample, train_diffusion
from diffulab_tpu_torch.networks.repa import FixedViT
from diffulab_tpu_torch.training.checkpoint import restore_checkpoint

CONFIGS = train_diffusion.CONFIG_DIR
DIT = ["model.depth=2", "model.inner_dim=64", "model.embedding_dim=64", "model.num_heads=4"]
DATA = ["dataset.train.n_samples=64", "dataset.val.n_samples=32", "dataloader.batch_size=32", "trainer.n_epoch=1",
        "trainer.val_steps=2"]
HARD = [*DIT, "dataset.train.image_size=32", "dataset.val.image_size=32"]
VIT = ["repa.encoder_args.embed_dim=32", "repa.encoder_args.depth=1", "repa.encoder_args.num_heads=2",
       "repa.hidden_dim=32"]
#: per REPA config: the model and encoder cuts (the UNet's first ds-2 decoder group is capture point 8 of 13,
#: 8x8 tokens of 64 channels, as many as the 16x16 ViT's patches of 2)
REPA = {
    "train_synthetic_flow_repa": [*DIT, *VIT, "repa.alignment_layer=2"],
    "train_synthetic_edm_repa": [*DIT, *VIT, "repa.alignment_layer=2"],
    "train_synthetic_ddpm_repa": ["model.model_channels=32", "model.channel_mult=1, 2", "model.attention_resolutions=[2]",
                                  "model.image_size=[16, 16]", "dataset.train.image_size=16", "dataset.val.image_size=16",
                                  *VIT, "repa.alignment_layer=8", "repa.denoiser_dimension=64",
                                  "repa.encoder_args.img_size=16", "repa.encoder_args.patch_size=2"],
}
E1 = ["train_synthetic_hard_flow", "train_synthetic_hard_distill", "train_synthetic_colorize", *REPA]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _no_wandb():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "wandb", None)
        yield


def _train(config, root, *overrides):
    (trainer,) = train_diffusion.main(["--device", "cpu", "--config-name", config, *overrides,
                                       f"trainer.save_path={root}"])
    return trainer


def _rows(run):
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def _sample(config, ckpt, out, *overrides, **flags):
    argv = ["--device", "cpu", "--config-name", config, "--ckpt", str(ckpt), "--n", "4", "--steps", "2",
            "--out", str(out), *[str(v) for k, v in flags.items() for v in (f"--{k}", v)], *overrides]
    result = sample.main(argv)
    assert np.isfinite(result["images"]).all() and out.is_file()
    return result


@pytest.mark.parametrize("config", E1)
def test_e1_configs_compose_like_jax_and_resolve(config):
    cfg = compose_config(CONFIGS, config)
    assert cfg == jax_compose(CONFIGS, config)
    for target in (cfg["model"]["_target_"], cfg["dataset"]["train"]["_target_"]):
        assert locate(target).__module__.startswith("diffulab_tpu_torch.")
    if "hard" in config:
        assert locate(cfg["dataset"]["train"]["_target_"]) is SyntheticCompositionalDataset
        assert cfg["trainer"]["precision_type"] == "bf16" and cfg["model"]["patch_size"] == 4
    if config in REPA:
        assert cfg["repa"]["repa_encoder"] == "fixed_vit" and cfg["repa"]["encoder_args"]["seed"] == 4321


@pytest.fixture(scope="module")
def hard_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hard")
    flow = _train("train_synthetic_hard_flow", root, *HARD, *DATA, "trainer.n_epoch=2")
    reconstruct_ema.main(["--run-dir", str(root / "synthetic_hard_flow"), "--sigma-rel", "0.05"])
    snapshot = root / "synthetic_hard_flow" / "checkpoints" / "phema_sr0.05"
    distill = _train("train_synthetic_hard_distill", root, *HARD, *DATA, f"trainer.distill_from={snapshot}")
    return root, flow, distill


def test_hard_flow_then_distill_through_the_clis(hard_runs, tmp_path):
    root, flow, distill = hard_runs
    assert flow.step == 4 and distill.step == 2
    for name in ("synthetic_hard_flow", "synthetic_hard_distill"):
        run = root / name
        losses = [r["train/loss"] for r in _rows(run) if "train/loss" in r]
        assert losses and all(np.isfinite(losses))
        assert not (run / "checkpoints" / "optimizer").exists()  # save_optimizer: false
    assert len(list((root / "synthetic_hard_distill" / "checkpoints" / "phema").glob("step*_g*"))) == 2
    reconstruct_ema.main(["--run-dir", str(root / "synthetic_hard_distill"), "--sigma-rel", "0.05"])
    result = _sample("train_synthetic_hard_distill", root / "synthetic_hard_distill" / "checkpoints" / "phema_sr0.05",
                     tmp_path / "hard.png", *HARD, labels="0,1,2,3,4")
    assert result["images"].shape == (4, 32, 32, 3) and result["labels"].tolist() == [0, 1, 2, 3]


def test_colorize_trains_and_samples_from_the_validation_luma(tmp_path):
    trainer = _train("train_synthetic_colorize", tmp_path, *DIT, *DATA)
    run = tmp_path / "synthetic_colorize"
    assert trainer.step == 2 and any("val/loss" in r for r in _rows(run))
    result = _sample("train_synthetic_colorize", run / "checkpoints" / "denoiser", tmp_path / "c.png", *DIT)
    assert result["images"].shape == (4, 32, 32, 3) and result["labels"] is None


@pytest.mark.parametrize("config", list(REPA))
def test_repa_config_trains_checkpoints_and_samples(config, tmp_path):
    overrides = REPA[config]
    trainer = _train(config, tmp_path, *overrides, *DATA)
    run = tmp_path / config.removeprefix("train_")
    assert trainer.step == 2
    rows = _rows(run)
    for key in ("train/loss", "train/RepaLoss", "val/loss", "val/RepaLoss"):
        values = [r[key] for r in rows if key in r]
        assert len(values) == 1 and np.isfinite(values[0]), key
    state = restore_checkpoint(run / "checkpoints" / "denoiser")
    params, rest = state["params"], state["rest"]
    assert {"extra_losses.0.proj_fc1.weight", "extra_losses.0.proj_fc3.bias"} <= set(params)
    assert all(k.startswith(("denoiser.", "extra_losses.0.proj_fc")) for k in params)
    encoder = {k.removeprefix("extra_losses.0.repa_encoder."): v for k, v in rest.items() if "repa_encoder" in k}
    cfg = compose_config(CONFIGS, config, overrides)
    fresh = FixedViT(**cfg["repa"]["encoder_args"], device="cpu").state_dict()
    assert set(encoder) == set(fresh) and all(torch.equal(encoder[k], fresh[k]) for k in fresh)  # frozen
    if config == "train_synthetic_edm_repa":  # the config's EMA holds the projector too
        assert "extra_losses.0.proj_fc1.weight" in restore_checkpoint(run / "checkpoints" / "ema")["params"]
    for entry in ("denoiser", "ema"):
        if (run / "checkpoints" / entry).exists():
            _sample(config, run / "checkpoints" / entry, tmp_path / f"{entry}.png", *overrides, guidance=1.5)


@pytest.mark.parametrize("cli", ["train_diffusion", "sample", "reflow", "reconstruct_ema"])
def test_every_cli_turns_tf32_off(cli, monkeypatch, tmp_path):
    """The port's fp32 policy (``utils.full_fp32_products``): float32 matmuls
    and convolutions are full fp32 products on the card, as the reference's
    and as chip_smoke.py's. Each CLI sets it right after parsing."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = {"train_diffusion": train_diffusion, "sample": sample, "reflow": reflow,
              "reconstruct_ema": reconstruct_ema}[cli]
    argv = {"reconstruct_ema": ["--run-dir", str(tmp_path), "--sigma-rel", "0.05"]}.get(cli, ["--ckpt", str(tmp_path)])
    with pytest.raises((RuntimeError, SystemExit)):  # no card (or, for reconstruct_ema, no snapshots)
        module.main(argv if cli != "train_diffusion" else [])
    assert torch.backends.cuda.matmul.allow_tf32 is False and torch.backends.cudnn.allow_tf32 is False
