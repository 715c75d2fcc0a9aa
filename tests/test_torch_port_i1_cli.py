"""Slice I1 through the port's CLIs on the CPU, at a toy size: ``train_grpo``
on ``ImageNetmultiAR`` caption shards, the config fault F4, LoRA finetuning
through ``train_diffusion`` then ``sample`` and ``evaluate_fid`` from the
LoRA run, and ``training.profiling``.

- ``train_grpo_alignment`` composes as the JAX package composes it and its
  targets resolve in the port (the reward model among them). With the
  dataset overridden to ``ImageNetmultiAR`` over MDS shards written from a
  seed by the port's ``data.mds`` writer (as ``scripts/r4_grpo_campaign.sh``
  overrides it), the tower's ``latent_channels`` set so that its packed
  latents are the model's input channels, and toy widths, ``train_grpo``
  trains one epoch with ``--luma-judge`` and with ``--stub-judge``.
- F4: as composed the config reads ``imagenet_repa``, whose
  ``ImageNetLatentREPA`` yields no captions; both packages refuse it at the
  trainer's first batch (the JAX package with ``KeyError: 'captions'``, the
  port with a ``ValueError`` naming them).
- ``train_diffusion --config-name train_synthetic_flow_matching`` with
  ``trainer.lora_rank=4 trainer.lora_from=<a base run's denoiser>`` (LoRA
  and DoRA) trains the adapters alone on the base's weights; ``sample`` and
  ``evaluate_fid`` restore its ``ema`` onto the base.
- ``profiling.StepTimer`` has the JAX package's summary keys, and ``trace``
  writes a Chrome trace.
"""

import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from diffulab_tpu.config.compose import compose_config as jax_compose
from diffulab_tpu.training import profiling as jprofiling
from diffulab_tpu_torch.config import compose_config
from diffulab_tpu_torch.config.instantiate import locate
from diffulab_tpu_torch.data.mds import MDSDatasetWriter
from diffulab_tpu_torch.data.streaming import ShardedDatasetWriter
from diffulab_tpu_torch.examples import evaluate_fid, sample, train_diffusion, train_grpo
from diffulab_tpu_torch.training import lora, profiling
from diffulab_tpu_torch.training.checkpoint import restore_checkpoint

ROOT = Path(__file__).resolve().parents[1]
GRPO = "train_grpo_alignment"
TEXT = (8, 32)
#: toy widths: 2 dual-stream blocks of 32 (2 heads of 16), a 2-level tower of 16/32 channels with 4 latent
#: channels (16 packed, f = 4), 16-px images on 4x4x16 latents, EM-4, 2 images a prompt, batch 2
GRPO_TOY = ["model.inner_dim=32", "model.embedding_dim=32", "model.num_heads=2", "model.depth=2", "model.mlp_ratio=2",
            "model.input_channels=16", "model.output_channels=16", "model.rope_axes_dim=[4,6,6]",
            "vision_tower.base_channels=16", "vision_tower.ch_mult=[1, 2]", "vision_tower.num_res_blocks=1",
            "vision_tower.latent_channels=4", "grpo.n_image_per_prompt=2", "reward.n_image_per_prompt=2",
            "grpo.image_resolution=[16, 16]", "diffuser.n_steps=4", "dataloader.batch_size=2", "trainer.n_epoch=1",
            "trainer.precision_type=no", "trainer.save_path=runs"]
#: the override of the repository's own GRPO runs (scripts/r4_grpo_campaign.sh:16-19)
MULTIAR = [f"dataset.{split}.{key}={value}" for split in ("train", "val") for key, value in (
    ("_target_", "diffulab_tpu.data.imagenet.ImageNetmultiAR"), ("data_path", "data/captions"), ("cache_dir", "cache"))]
C1 = "train_synthetic_flow_matching"
C1_TOY = ["model.depth=2", "model.inner_dim=64", "model.embedding_dim=64", "model.num_heads=4",
          "dataset.train.n_samples=64", "dataset.val.n_samples=32", "dataloader.batch_size=32", "trainer.n_epoch=1",
          "trainer.val_steps=2", "diffuser.n_steps=2", "trainer.save_path=runs"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)


def _write_caption_shards(root: Path, seed: int = 0) -> None:
    """MDS shards of 4 train and 2 validation prompts: latents, captions,
    caption embeddings with per-prompt lengths; and the null embedding."""
    rng = np.random.default_rng(seed)
    columns = {"vision_latents": "ndarray:float32", "caption": "str", "caption_embeddings": "ndarray:float32",
               "caption_mask": "ndarray:uint8"}
    for split, n in (("train", 4), ("val", 2)):
        with MDSDatasetWriter(root / "data" / "captions" / split, columns) as writer:
            for i in range(n):
                length = int(rng.integers(1, TEXT[0] + 1))
                writer.write({"vision_latents": rng.standard_normal((4, 4, 16)).astype(np.float32),
                              "caption": f"{split} prompt {i}",
                              "caption_embeddings": rng.standard_normal(TEXT).astype(np.float32),
                              "caption_mask": (np.arange(TEXT[0]) < length).astype(np.uint8)})
    np.save(root / "data" / "null_embedding.npy", rng.standard_normal(TEXT).astype(np.float32))


def _metrics(run: Path) -> dict:
    return {k: v for line in (run / "metrics.jsonl").read_text().splitlines()
            for k, v in json.loads(line).items() if k not in ("step", "time")}


def test_grpo_config_composes_like_jax_and_resolves():
    overrides = [*GRPO_TOY, *MULTIAR]
    cfg = compose_config(train_grpo.CONFIG_DIR, GRPO, overrides)
    assert cfg == jax_compose(train_grpo.CONFIG_DIR, GRPO, overrides)
    for group in ("model", "embedder", "vision_tower", "reward", "optimizer"):
        assert locate(cfg[group]["_target_"]).__module__.startswith("diffulab_tpu_torch."), group
    assert locate(cfg["dataset"]["train"]["_target_"]).__name__ == "ImageNetmultiAR"


@pytest.mark.parametrize("judge", ["--luma-judge", "--stub-judge"])
def test_train_grpo_runs_on_caption_shards(tmp_path, monkeypatch, judge):
    monkeypatch.chdir(tmp_path)
    _write_caption_shards(tmp_path)
    (trainer,) = train_grpo.main(["--device", "cpu", judge, *GRPO_TOY, *MULTIAR])
    run = tmp_path / "runs" / "grpo_alignment"
    metrics = _metrics(run)
    assert trainer.step == 2 * 2  # two batches of 2 prompts, one learn step a group of 2
    assert {"train/loss", "train/clip_frac", "train/ratio_dev", "train/grad_norm", "train/tr_reject",
            "train/lr_scale", "train/advantage_mean", "val/loss"} <= set(metrics)
    assert ("val/judge_score" in metrics) == (judge == "--luma-judge")
    assert all(np.isfinite(v) for v in metrics.values())
    assert len(list((run / "images").glob("*.png"))) == 1
    entry = restore_checkpoint(run / "checkpoints" / "denoiser")
    assert entry["params"] and not any(k.startswith("context_embedder.") for k in entry["params"])


def _write_repa_shards(root: Path) -> None:
    """``imagenet_repa``'s shards at data/imagenet: latents, labels and REPA features, no captions."""
    rng = np.random.default_rng(1)
    for split in ("train", "val"):
        with ShardedDatasetWriter(root / "data" / "imagenet" / split, shard_size=8) as writer:
            for _ in range(4):
                writer.write({"vision_latents": rng.standard_normal((4, 4, 16)).astype(np.float32),
                              "label": np.int64(rng.integers(0, 10)),
                              "dst_features": rng.standard_normal((4, 8)).astype(np.float32)})


def test_f4_the_composed_dataset_has_no_captions_in_both(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _write_caption_shards(tmp_path)
    _write_repa_shards(tmp_path)
    assert compose_config(train_grpo.CONFIG_DIR, GRPO)["dataset"]["train"]["_target_"].endswith("ImageNetLatentREPA")
    with pytest.raises(ValueError, match="captions"):
        train_grpo.main(["--device", "cpu", "--stub-judge", *GRPO_TOY])
    monkeypatch.setattr(sys, "argv", ["train_grpo.py", "--stub-judge", *GRPO_TOY])
    with pytest.raises(KeyError, match="captions"):
        runpy.run_path(str(ROOT / "examples" / "train_grpo.py"), run_name="__main__")


@pytest.mark.parametrize("variant", ["lora", "dora"])
def test_lora_finetuning_then_sample_and_evaluate_fid(tmp_path, monkeypatch, variant):
    monkeypatch.chdir(tmp_path)
    train_diffusion.main(["--device", "cpu", "--config-name", C1, *C1_TOY])
    base = tmp_path / "runs" / "synthetic_flow_matching" / "checkpoints" / "denoiser"
    lora_cfg = ["trainer.lora_rank=4", f"trainer.lora_from={base}", f"trainer.lora_variant={variant}"]
    (trainer,) = train_diffusion.main(["--device", "cpu", "--config-name", C1, *C1_TOY, *lora_cfg,
                                       "trainer.project_name=lora"])
    ckpt = tmp_path / "runs" / "lora" / "checkpoints"
    entry = restore_checkpoint(ckpt / "denoiser")
    assert entry["params"] and all(lora.is_lora_param(k) for k in entry["params"])
    base_state = restore_checkpoint(base)
    base_weights = {**base_state["params"], **base_state["rest"]}
    for key, value in entry["rest"].items():  # the base rides frozen in rest, under the wrappers' names
        plain = key.replace(".base_module.", ".").replace(".base.", ".")
        assert torch.equal(value, base_weights[plain]), key
    out = sample.main(["--device", "cpu", "--config-name", C1, "--ckpt", str(ckpt / "ema"), "--n", "4", "--steps", "2",
                       "--guidance", "1.5", "--labels", "0,1", "--out", str(tmp_path / "lora.png"), *C1_TOY, *lora_cfg])
    assert out["images"].shape == (4, 32, 32, 3) and np.isfinite(out["images"]).all()
    fid = evaluate_fid.main(["--device", "cpu", "--config-name", C1, "--ckpt", str(ckpt / "ema"), "--n-samples", "8",
                             "--batch-size", "8", "--steps", "2", "--guidance", "1.5", "--cache-dir",
                             str(tmp_path / "fid_cache"), *C1_TOY, *lora_cfg])
    (row,) = fid["rows"]
    assert np.isfinite(row["value"])


def test_profiling_step_timer_and_trace(tmp_path):
    ours, ref = profiling.StepTimer(warmup=1), jprofiling.StepTimer(warmup=1)
    for timer in (ours, ref):
        assert timer.summary == {}
        for _ in range(3):
            with timer.step():
                sum(range(1000))
    assert set(ours.summary) == set(ref.summary) and ours.summary["steps"] == ref.summary["steps"] == 2
    assert set(ours.time_fn(lambda: torch.ones(4).sum(), n_iters=2)) == {"mean_s", "p50_s", "p90_s", "min_s"}
    with profiling.trace(tmp_path / "trace"):
        with profiling.annotate("block"):
            torch.ones(8) @ torch.ones(8)
    trace = json.loads((tmp_path / "trace" / profiling.TRACE_FILE).read_text())
    assert any(event.get("name") == "block" for event in trace["traceEvents"])
