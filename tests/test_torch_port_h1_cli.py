"""Slice H1 through the port's CLIs on the CPU, at a toy size: the hard
text-to-image benchmark's chain (``scripts/r5_*.sh``: build the tower and
the shards, ``train_repa_txt_to_img``, ``reconstruct_ema``,
``evaluate_txt2img``) and ``evaluate_fid`` on the class-conditional
synthetic config.

- ``train_hard_txt2img_{mmdit,sprint,ddt}`` (and the mmdit arm with
  ``embedder=trainable``) compose as the JAX package composes them, and
  every ``_target_`` resolves in the port.
- The chain runs from a working directory where the builder wrote
  ``data/hard_txt2img``, so the configs' own paths (``flax_ckpt:
  data/hard_txt2img/tower``, the null embedding, the shards) are used
  unedited; the models are cut to toy widths, the data to 32-px images.
  The MMDiT arm trains with post-hoc EMA; ``evaluate_txt2img`` scores its
  ``ema`` and ``phema_sr0.05`` entries and prints the reference's
  ``txt2img`` JSON line for each; ``embedder=trainable
  trainer.train_embedder=true`` trains the encoder into the checkpoint's
  ``params``; the SprintDiT arm trains; the DDT arm raises the reference's
  ``TypeError`` on its config's stray ``simple_dit`` (fault F3), as the JAX
  package's instantiation does.
- ``evaluate_fid`` on a ``train_synthetic_flow_matching`` run: two
  checkpoints and two comma-separated guidance scales give four
  ``fid_synthetic`` lines with the floor and the ceiling; a second call
  reads the real-feature cache, whose key is the reference's expression on
  the JAX package's composed config; the LoRA branch raises naming item 16.
"""

import hashlib
import json
import sys

import numpy as np
import pytest
import torch

from diffulab_tpu.config import instantiate as jax_instantiate
from diffulab_tpu.config.compose import compose_config as jax_compose
from diffulab_tpu_torch.config import compose_config
from diffulab_tpu_torch.config.instantiate import locate, port_path
from diffulab_tpu_torch.examples import (
    evaluate_fid,
    evaluate_txt2img,
    reconstruct_ema,
    train_diffusion,
    train_repa_txt_to_img,
)
from diffulab_tpu_torch.scripts import build_hard_txt2img
from diffulab_tpu_torch.training.checkpoint import restore_checkpoint
from diffulab_tpu_torch.training.evaluation import FEATURE_SPACE_VERSION

CONFIGS = train_repa_txt_to_img.CONFIG_DIR
HARD = ["train_hard_txt2img_mmdit", "train_hard_txt2img_sprint", "train_hard_txt2img_ddt"]
#: the toy cut: 32-px scenes (8x8x32 latents, 64 image tokens), 32 + 16 images, batch 16, one epoch
BUILD = ["--device", "cpu", "--n-train", "32", "--n-val", "16", "--epochs", "1", "--batch", "16", "--image-size", "32"]
RUN = ["dataloader.batch_size=16", "trainer.n_epoch=1", "trainer.val_steps=2", "diffuser.n_steps=2",
       "trainer.save_path=runs"]
TOY = {"train_hard_txt2img_mmdit": ["model.inner_dim=32", "model.embedding_dim=32", "model.num_heads=2",
                                    "model.depth=2", "model.n_single_stream_blocks=1", "model.rope_axes_dim=[4,6,6]"],
       "train_hard_txt2img_sprint": ["model.inner_dim=32", "model.embedding_dim=32", "model.num_heads=2",
                                     "model.encoder_depth=1", "model.deep_layers_depth=1",
                                     "model.n_single_stream_blocks=1", "model.decoder_depth=1",
                                     "model.rope_axes_dim=[4,6,6]"]}
TRAINABLE = ["embedder=trainable", "trainer.train_embedder=true", "embedder.dim=32", "embedder.depth=1",
             "embedder.num_heads=2", "embedder.max_len=16"]
C1 = "train_synthetic_flow_matching"
C1_TOY = ["model.depth=2", "model.inner_dim=64", "model.embedding_dim=64", "model.num_heads=4",
          "dataset.train.n_samples=64", "dataset.val.n_samples=32"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)


def _targets(node, out):
    if isinstance(node, dict):
        for k, v in node.items():
            if k == "_target_":
                out.add(v)
            else:
                _targets(v, out)
    return out


@pytest.mark.parametrize("name,overrides", [(c, []) for c in HARD] + [(HARD[0], TRAINABLE[:2])],
                         ids=["mmdit", "sprint", "ddt", "mmdit_trainable"])
def test_hard_configs_compose_like_jax_and_resolve(name, overrides):
    cfg = compose_config(CONFIGS, name, overrides)
    assert cfg == jax_compose(CONFIGS, name, overrides)
    for target in _targets(cfg, set()):
        assert locate(target).__module__ == port_path(target).rsplit(".", 1)[0], target
    assert cfg["vision_tower"]["flax_ckpt"] == "data/hard_txt2img/tower"
    assert (cfg["model"]["inner_dim"], cfg["model"]["num_heads"], cfg["dataloader"]["batch_size"]) == (384, 6, 64)


def _json_lines(text: str, metric: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{") and json.loads(line).get("metric") == metric]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The builder's toy benchmark under a fresh working directory's data/hard_txt2img."""
    root = tmp_path_factory.mktemp("h1")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        result = build_hard_txt2img.main(BUILD + ["--out", "data/hard_txt2img"])
    return root, result


def test_the_hard_chain_runs_through_the_cli(built, monkeypatch, capsys):
    root, result = built
    monkeypatch.chdir(root)
    assert set(result["seconds"]) == {"render", "tower", "report", "shards"} and result["report"]["mse"] > 0
    assert (root / "data/hard_txt2img/null_embedding.npy").exists()
    name = HARD[0]
    (trainer,) = train_repa_txt_to_img.main(["--device", "cpu", "--config-name", name, *TOY[name], *RUN])
    assert trainer.step == 2
    run = root / "runs" / "hard_txt2img_mmdit"
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(r[k]) for r in rows for k in ("train/loss", "val/loss") if k in r)
    reconstruct_ema.main(["--run-dir", str(run), "--sigma-rel", "0.05"])
    capsys.readouterr()
    ckpts = [str(run / "checkpoints" / "ema"), str(run / "checkpoints" / "phema_sr0.05")]
    out = evaluate_txt2img.main(["--device", "cpu", "--config-name", name, "--ckpt", *ckpts, "--n-samples", "8",
                                 "--batch-size", "4", "--steps", "2", "--image-size", "32", "--n-val", "8", *TOY[name]])
    lines = _json_lines(capsys.readouterr().out, "txt2img")
    assert [line["ckpt"] for line in lines] == ckpts and len(out["rows"]) == 2
    for line, row in zip(lines, out["rows"]):
        assert set(line) == {"metric", "fid", "kid_x1000", "precision", "recall", "acc_color", "acc_count",
                             "acc_size", "acc_background", "acc_shape", "acc_all", "ckpt"}
        assert all(np.isfinite(v) for k, v in line.items() if k not in ("metric", "ckpt"))
        assert row["fake"].shape == (8, 32, 32, 3) and np.abs(row["fake"]).max() <= 1.0
    assert np.isfinite(out["floor"]) and np.isfinite(out["ceiling"]) and set(out["recon_judge"]) >= {"all"}


def test_the_trainable_embedder_and_the_other_arms_train_through_the_cli(built, monkeypatch):
    root, _ = built
    monkeypatch.chdir(root)
    name = HARD[0]
    train_repa_txt_to_img.main(["--device", "cpu", "--config-name", name, *TOY[name], *RUN, *TRAINABLE,
                                "trainer.project_name=hard_trainable"])
    entry = restore_checkpoint(root / "runs" / "hard_trainable" / "checkpoints" / "denoiser")
    assert any(k.startswith("context_embedder.blocks.") for k in entry["params"])
    assert not any(k.startswith("context_embedder.") for k in entry["rest"])
    (trainer,) = train_repa_txt_to_img.main(["--device", "cpu", "--config-name", HARD[1], *TOY[HARD[1]], *RUN])
    assert trainer.step == 2
    with pytest.raises(TypeError, match="simple_dit") as ours:
        train_repa_txt_to_img.main(["--device", "cpu", "--config-name", HARD[2], *RUN])
    with pytest.raises(TypeError, match="simple_dit") as ref:
        jax_instantiate(jax_compose(CONFIGS, HARD[2])["model"], context_embedder=None)
    assert str(ours.value).split(".")[-1] == str(ref.value).split(".")[-1]


def test_evaluate_fid_scores_a_run_and_caches_its_real_features(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    train_diffusion.main(["--device", "cpu", "--config-name", C1, *C1_TOY, "dataloader.batch_size=32",
                          "trainer.n_epoch=1", "trainer.val_steps=2", "diffuser.n_steps=2", "trainer.posthoc_ema=true",
                          "trainer.save_path=runs"])
    run = tmp_path / "runs" / "synthetic_flow_matching"
    reconstruct_ema.main(["--run-dir", str(run), "--sigma-rel", "0.05"])
    ckpts = [str(run / "checkpoints" / "ema"), str(run / "checkpoints" / "phema_sr0.05")]
    argv = ["--device", "cpu", "--config-name", C1, "--ckpt", *ckpts, "--n-samples", "8", "--batch-size", "8",
            "--steps", "2", "--guidance", "0,1.5", "--cache-dir", str(tmp_path / "fid_cache"), *C1_TOY]
    capsys.readouterr()
    first = evaluate_fid.main(argv)
    lines = _json_lines(capsys.readouterr().out, "fid_synthetic")
    assert [(line["ckpt"], line["guidance"]) for line in lines] == [(c, g) for c in ckpts for g in (0.0, 1.5)]
    for line in lines:
        assert set(line) == {"metric", "value", "floor", "ceiling", "precision", "recall", "density", "coverage",
                             "kid_x1000", "guidance", "ckpt"}
        assert all(np.isfinite(v) for k, v in line.items() if k not in ("metric", "ckpt"))
        assert line["floor"] < line["ceiling"]
    assert not first["cached"] and first["cache"].exists()
    cfg = jax_compose(CONFIGS, C1, C1_TOY)
    key = hashlib.sha1(repr((sorted(cfg["dataset"]["val"].items()), sorted(cfg["dataset"]["train"].items()), 32, 0,
                             FEATURE_SPACE_VERSION)).encode()).hexdigest()[:16]
    assert first["cache"].name == f"{key}.npz"
    second = evaluate_fid.main(argv[:argv.index("--guidance")] + ["--cache-dir", str(tmp_path / "fid_cache"),
                                                                   *C1_TOY])
    assert second["cached"] and (second["floor"], second["ceiling"]) == (first["floor"], first["ceiling"])
    with pytest.raises(NotImplementedError, match="item 16"):
        evaluate_fid.main(argv + ["trainer.lora_rank=4"])
