"""The port's config layer and CLIs (diffulab_tpu_torch.config,
diffulab_tpu_torch.examples) against the JAX package.

- ``compose_config``: the composed dict equals the JAX package's exactly,
  for every ``configs/train_*.yaml`` and for CLI overrides, once the
  ``_target_`` paths are remapped (``diffulab_tpu.`` -> ``diffulab_tpu_torch.``)
  on both sides;
- every ``_target_`` under ``configs/`` resolves in the port or raises
  ``NotImplementedError``; the main path's (DiT, synthetic shapes, AdamW)
  resolve, and the DiT the config builds has the JAX model's parameters,
  name for name and shape for shape;
- sweeps expand and dispatch as the JAX package's;
- the three CLIs end to end on the CPU at depth 2, width 64, 64 samples,
  2 epochs and 2 sampling steps: post-hoc EMA snapshots, then the
  reconstruction (its weights equal the JAX package's solve to 1e-12), then
  a PNG grid; ``--device`` defaults to ``cuda`` and raises without a card.
"""

import argparse
import fractions
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from flax import nnx
from PIL import Image

from diffulab_tpu.config import compose_config as jax_compose
from diffulab_tpu.config import instantiate as jax_instantiate
from diffulab_tpu.config import sweep as jax_sweep
from diffulab_tpu.training import posthoc_ema as jphema
from diffulab_tpu_torch.config import compose_config, instantiate, sweep
from diffulab_tpu_torch.config.instantiate import locate, model_dtype_kwargs, port_path
from diffulab_tpu_torch.examples import reconstruct_ema, sample, train_diffusion
from diffulab_tpu_torch.training import posthoc_ema
from diffulab_tpu_torch.training.checkpoint import restore_checkpoint
from diffulab_tpu_torch.training.lora import is_lora_param
from diffulab_tpu_torch.weights import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs"
TRAIN_CONFIGS = sorted(p.stem for p in CONFIGS.glob("train_*.yaml"))
#: the CLI runs' cut: depth 2, width 64 (4 heads of 16), 64 train and 32 val
#: samples at batch 32 (2 steps an epoch), 2 epochs, 2 sampling steps
TINY_OVERRIDES = ["model.depth=2", "model.inner_dim=64", "model.embedding_dim=64", "model.num_heads=4",
                  "dataset.train.n_samples=64", "dataset.val.n_samples=32", "dataloader.batch_size=32",
                  "trainer.n_epoch=2", "trainer.val_steps=2", "diffuser.n_steps=2"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    # the tracker writes metrics.jsonl; where wandb is installed it is not imported
    monkeypatch.setitem(sys.modules, "wandb", None)


def _remap(node):
    """The tree with every ``_target_`` remapped to the port."""
    if isinstance(node, dict):
        return {k: (port_path(v) if k == "_target_" and isinstance(v, str) else _remap(v)) for k, v in node.items()}
    if isinstance(node, list):
        return [_remap(v) for v in node]
    return node


def _targets(node, out):
    if isinstance(node, dict):
        for k, v in node.items():
            if k == "_target_" and isinstance(v, str):
                out.add(v)
            else:
                _targets(v, out)
    elif isinstance(node, list):
        for v in node:
            _targets(v, out)
    return out


ALL_TARGETS = sorted(set().union(*(_targets(jax_compose(CONFIGS, name), set()) for name in TRAIN_CONFIGS)))


# --- compose -----------------------------------------------------------------

def test_every_train_config_is_covered():
    assert len(TRAIN_CONFIGS) >= 20 and "train_synthetic_flow_matching" in TRAIN_CONFIGS


@pytest.mark.parametrize("name", TRAIN_CONFIGS)
def test_compose_config_equals_jax(name):
    ours = compose_config(CONFIGS, name)
    ref = jax_compose(CONFIGS, name)
    assert _remap(ours) == _remap(ref)
    # the port composes the tree as it is: the remap happens at instantiate
    assert ours == ref


@pytest.mark.parametrize("overrides", [
    ["trainer.n_epoch=2", "optimizer.lr=3e-4", "dataloader.batch_size=16"],
    ["optimizer=sgd", "trainer.mesh.data=2"],
    ["trainer.lr_scheduler._target_=optax.cosine_decay_schedule", "trainer.lr_scheduler.decay_steps=100"],
    ["model.depth=2", "trainer.posthoc_ema_gammas=[5.0, 10.0]", "trainer.save_path=null", "dataset.train.seed=1e1"],
])
def test_compose_overrides_equal_jax(overrides):
    ours = compose_config(CONFIGS, "train_synthetic_flow_matching", overrides)
    assert ours == jax_compose(CONFIGS, "train_synthetic_flow_matching", overrides)


def test_compose_coerces_scientific_floats_like_jax():
    cfg = compose_config(CONFIGS, "train_synthetic_flow_matching")
    assert cfg["optimizer"]["lr"] == 3e-4 and isinstance(cfg["optimizer"]["eps"], float)
    assert cfg["trainer"]["posthoc_ema"] is True and cfg["trainer"]["precision_type"] == "no"
    with pytest.raises(ValueError, match="key=value"):
        compose_config(CONFIGS, "train_synthetic_flow_matching", ["trainer.n_epoch"])


# --- instantiate -------------------------------------------------------------

def test_targets_are_collected():
    assert "diffulab_tpu.networks.denoisers.mmdit.MMDiT" in ALL_TARGETS and len(ALL_TARGETS) >= 15


@pytest.mark.parametrize("target", ALL_TARGETS)
def test_every_target_resolves_in_the_port_or_raises_not_implemented(target):
    try:
        obj = locate(target)
    except NotImplementedError as e:
        assert target in str(e) and "ROADMAP queue 1" in str(e)
        return
    assert callable(obj)
    assert obj.__module__.startswith("diffulab_tpu_torch.")


@pytest.mark.parametrize("target", ["diffulab_tpu.networks.denoisers.mmdit.MMDiT",
                                    "diffulab_tpu.networks.denoisers.sprint.SprintDiT",
                                    "diffulab_tpu.networks.denoisers.ddt.DDT",
                                    "diffulab_tpu.data.SyntheticShapesDataset",
                                    "diffulab_tpu.data.MNISTDataset", "diffulab_tpu.data.CIFAR10Dataset",
                                    "diffulab_tpu.data.ImageFolderDataset", "diffulab_tpu.training.optim.adamw",
                                    "diffulab_tpu.networks.embedders.precomputed.PrecomputedEmbedder",
                                    "diffulab_tpu.networks.vision_towers.flux2.Flux2VAE",
                                    "diffulab_tpu.networks.vision_towers.dc_ae.DCAE",
                                    "diffulab_tpu.networks.repa.dinov2.DinoV2",
                                    "diffulab_tpu.networks.repa.perceiver_resampler.PerceiverResampler",
                                    "diffulab_tpu.data.imagenet.ImageNetLatentREPA"])
def test_ported_targets_resolve(target):
    assert locate(target).__module__.startswith("diffulab_tpu_torch.")


def test_unported_and_jax_side_targets_raise():
    # the HF text embedders are ported (slice J1): configs/embedder/qwen.yaml's target resolves to the port's class
    qwen = locate("diffulab_tpu.networks.embedders.hf_text.QwenTextEmbedder")
    assert qwen.__module__ == "diffulab_tpu_torch.networks.embedders.hf_text"
    # the GRPO reward model is ported: the reward config's target resolves to the port's class
    reward = locate("diffulab_tpu.networks.rewards.grpo.PrefGRPORewardModel")
    assert reward.__module__ == "diffulab_tpu_torch.networks.rewards.grpo"
    with pytest.raises(NotImplementedError, match="optax.cosine_decay_schedule"):
        instantiate({"_target_": "optax.cosine_decay_schedule", "init_value": 1.0, "decay_steps": 10})
    with pytest.raises(ImportError, match="cannot locate"):
        locate("no_such_package.Thing")


@pytest.mark.parametrize("cfg", [
    {"_target_": "fractions.Fraction", "_args_": [3, 4]},
    {"_target_": "fractions.Fraction", "numerator": 6, "denominator": 8},
    {"a": [{"_target_": "fractions.Fraction", "_args_": [1, 2]}, 3], "b": {"c": None}},
])
def test_instantiate_equals_jax(cfg):
    assert instantiate(cfg) == jax_instantiate(cfg)


def test_instantiate_partial_and_kwargs():
    part = instantiate({"_target_": "fractions.Fraction", "_partial_": True, "numerator": 1})
    ref = jax_instantiate({"_target_": "fractions.Fraction", "_partial_": True, "numerator": 1})
    assert part(denominator=3) == ref(denominator=3) == fractions.Fraction(1, 3)
    assert instantiate({"_target_": "fractions.Fraction", "_args_": [1]}, denominator=5) == fractions.Fraction(1, 5)


def test_model_dtype_kwargs_are_torch_dtypes():
    assert model_dtype_kwargs({"precision_type": "bf16"}) == {"dtype": torch.bfloat16}
    assert model_dtype_kwargs({"precision_type": "no"}) == {} == model_dtype_kwargs({})


def test_config_dit_has_the_jax_models_parameters():
    """The config's DiT (cut to depth 2, width 64) built by both packages'
    instantiate: the bridged JAX state dict loads strictly into the port's."""
    cfg = compose_config(CONFIGS, "train_synthetic_flow_matching", TINY_OVERRIDES)
    jmodel = jax_instantiate(cfg["model"], rngs=nnx.Rngs(0))
    torch.manual_seed(0)
    model = instantiate(cfg["model"], device="cpu", **model_dtype_kwargs(cfg["trainer"]))
    flat = {"/".join(str(p) for p in path): np.asarray(var.get_value())
            for path, var in nnx.state(jmodel, nnx.Param).flat_state()}
    sd = state_dict_from_jax(flat, model)
    live = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(live[k].shape) for k in sd}
    model.load_state_dict(sd, strict=True)
    assert model.classifier_free and model.n_classes == 10 and model.patch_size == 2


def test_config_optimizer_and_dataset_instantiate():
    cfg = compose_config(CONFIGS, "train_synthetic_flow_matching",
                         ["dataset.train.n_samples=8", "dataset.val.n_samples=4"])
    opt = instantiate(cfg["optimizer"])([torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(opt, torch.optim.AdamW)
    assert opt.defaults["lr"] == 3e-4 and opt.defaults["weight_decay"] == 0.01 and opt.defaults["eps"] == 1e-8
    ours = instantiate(cfg["dataset"]["train"])
    ref = jax_instantiate(cfg["dataset"]["train"])
    assert np.array_equal(ours.images, ref.images) and np.array_equal(ours.labels, ref.labels)


# --- sweep -------------------------------------------------------------------

@pytest.mark.parametrize("overrides", [
    [],
    ["trainer.ema_rate=0.99,0.999", "optimizer.lr=1e-4,3e-4"],
    ["diffuser.cache_span=[2, 10]", "model.channel_mult=1, 2", "trainer.project_name='a,b'"],
])
def test_expand_sweep_equals_jax(overrides):
    assert sweep.expand_sweep(overrides) == jax_sweep.expand_sweep(overrides)
    for ov in overrides:
        value = ov.partition("=")[2]
        assert sweep.split_top_level_commas(value) == jax_sweep.split_top_level_commas(value)


@pytest.mark.parametrize("sweep_on", [False, True])
def test_dispatch_equals_jax(sweep_on, capsys):
    args = argparse.Namespace(config_dir=str(CONFIGS), config_name="train_synthetic_flow_matching", seed=3,
                              sweep=sweep_on, overrides=["trainer.ema_rate=0.99,0.999", "trainer.n_epoch=2"]
                              if sweep_on else ["trainer.n_epoch=2"])
    ours, ref = [], []
    returned = sweep.dispatch(args, lambda cfg, seed: ours.append((cfg, seed)) or len(ours))
    jax_sweep.dispatch(args, lambda cfg, seed: ref.append((cfg, seed)))
    assert ours == ref and len(ours) == (2 if sweep_on else 1)
    assert returned == list(range(1, len(ours) + 1))
    if sweep_on:
        assert ours[1][0]["trainer"]["project_name"] == "synthetic_flow_matching/trainer.ema_rate=0.999"


# --- the CLIs ----------------------------------------------------------------

def test_cli_train_reconstruct_sample_end_to_end(tmp_path):
    """train_synthetic_flow_matching through the port's three CLIs on the CPU."""
    (trainer,) = train_diffusion.main(["--device", "cpu", "--config-name", "train_synthetic_flow_matching",
                                       *TINY_OVERRIDES, f"trainer.save_path={tmp_path}"])
    run = tmp_path / "synthetic_flow_matching"
    assert trainer.step == 4 and trainer.posthoc_ema and trainer.posthoc_ema_gammas == (6.94, 16.97)
    snaps = posthoc_ema.list_snapshots(run / "checkpoints" / "phema")
    assert [(s, g) for s, g, _ in snaps] == [(2, 6.94), (2, 16.97), (4, 6.94), (4, 16.97)]
    assert sorted((run / "images").glob("val_images_step*.png"))  # validation images every epoch
    for part in ("denoiser", "optimizer", "ema", "scheduler"):
        assert (run / "checkpoints" / part / "state.pt").is_file()

    results = reconstruct_ema.main(["--run-dir", str(run), "--sigma-rel", "0.05", "0.10"])
    for result, sigma_rel in zip(results, (0.05, 0.10)):
        gamma = jphema.sigma_rel_to_gamma(sigma_rel)
        ref_w = jphema.solve_weights([s for s, _, _ in snaps], [g for _, g, _ in snaps], 4, gamma)
        np.testing.assert_allclose(result["weights"], ref_w, rtol=1e-12, atol=1e-12)
        assert abs(result["weights"].sum() - 1.0) < 1e-2 and result["out"].name == f"phema_sr{sigma_rel:g}"
        # the saved reconstruction is the JAX package's combination of the same fp16 snapshots
        trees = [{k: v.numpy() for k, v in torch.load(p / "state.pt")["params"].items()} for _, _, p in snaps]
        ref = jphema.combine_snapshots(trees, ref_w)
        saved = torch.load(result["out"] / "state.pt")["params"]
        assert set(saved) == set(ref)
        for name, value in saved.items():
            np.testing.assert_array_equal(value.numpy(), ref[name])

    out = tmp_path / "grid.png"
    result = sample.main(["--device", "cpu", "--config-name", "train_synthetic_flow_matching",
                          "--ckpt", str(run / "checkpoints" / "phema_sr0.05"), "--n", "6", "--guidance", "1.5",
                          "--labels", "0,1,2", "--steps", "2", "--separate", "--out", str(out), *TINY_OVERRIDES])
    assert result["labels"].tolist() == [0, 1, 2, 0, 1, 2]
    assert result["images"].shape == (6, 32, 32, 3) and np.isfinite(result["images"]).all()
    grid = np.asarray(Image.open(out))
    assert grid.shape == (2 + 1 * 34, 2 + 6 * 34, 3)
    assert len(list(tmp_path.glob("grid_*.png"))) == 6


@pytest.mark.parametrize("cli", ["train_diffusion", "sample"])
def test_cli_device_defaults_to_cuda_and_raises_without_a_card(cli, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = {"train_diffusion": train_diffusion, "sample": sample}[cli]
    argv = ["--ckpt", str(tmp_path)] if cli == "sample" else []
    assert module.parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--config-name", "train_synthetic_flow_matching", *argv])


#: ROADMAP item 13b's options at a toy size: the live DINOv2 (ViT-S/14 with registers, 4 tokens at 28 px) on the
#: DiT at patch 16 (4 tokens), aligned at its first block
DINO_OVERRIDES = ["repa.repa_encoder=dinov2", "repa.encoder_args={dino_model: dinov2_vits14_reg, target_seq_len: 4}",
                  "model.patch_size=16", "repa.alignment_layer=1"]
#: train_imagenet_flow_matching_repa at a toy size: a 3-stage DC-AE (8x8x32 latents of 32 px), the DiT at depth 2
#: and width 64, REPA through a 1-deep resampler onto 4 precomputed tokens of 16
PRECOMPUTED_OVERRIDES = ["vision_tower.block_out_channels=[8, 16, 32]", "vision_tower.block_types=[res, vit, vit]",
                         "vision_tower.encoder_layers_per_block=[1, 1, 1]",
                         "vision_tower.decoder_layers_per_block=[1, 1, 1]", "vision_tower.qkv_multiscales=[[], [5], [5]]",
                         "vision_tower.attention_head_dim=4", "model.depth=2", "model.inner_dim=64",
                         "model.embedding_dim=64", "model.num_heads=4", "repa.alignment_layer=1", "repa.embedding_dim=16",
                         "perceiver_resampler.parameters.depth=1", "perceiver_resampler.parameters.dim=16",
                         "perceiver_resampler.parameters.head_dim=8", "perceiver_resampler.parameters.num_heads=2",
                         "perceiver_resampler.parameters.num_latents=4", "dataloader.batch_size=8", "trainer.n_epoch=1",
                         "trainer.val_steps=2", "diffuser.n_steps=2"]


def _write_latent_shards(root) -> None:
    """train (16) and val (8) shards of precomputed latents, labels and REPA features, from a seed."""
    from diffulab_tpu_torch.data.streaming import ShardedDatasetWriter

    rng = np.random.default_rng(0)
    for split, n in (("train", 16), ("val", 8)):
        with ShardedDatasetWriter(root / split) as writer:
            for _ in range(n):
                writer.write({"vision_latents": rng.standard_normal((8, 8, 32)).astype(np.float32),
                              "label": int(rng.integers(0, 1000)),
                              "dst_features": rng.standard_normal((4, 16)).astype(np.float32)})


def _repa_rows(run: Path) -> list[float]:
    import json

    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    return [r[k] for r in rows for k in ("train/RepaLoss", "val/RepaLoss") if k in r]


@pytest.mark.parametrize("override,item", [("trainer.lora_rank=4", "item 16"),
                                           ("train_synthetic_edm_repa", "item 13"), ("+repa", "item 13")])
def test_train_cli_unported_options_raise(override, item, tmp_path):
    """LoRA (item 16) and item 13b's two cases raised until slices I1 and G1
    and now run at a toy size, each through the CLI that takes it: LoRA
    through ``train_diffusion`` on a fresh base (the adapters alone in the
    checkpoint's ``params``, LoRA from a trained base in
    tests/test_torch_port_{lora,i1_cli}.py), a DINO
    encoder in train_synthetic_edm_repa through ``train_diffusion``, and a
    ``repa:`` section naming no encoder (precomputed features, which only
    latent shards carry) through ``train_repa`` on shards the test writes.
    The live FixedViT REPA is tested in tests/test_torch_port_e1_cli.py, and
    ``trainer.distill_from`` in tests/test_torch_port_c2_cli.py."""
    if item == "item 16":
        (trainer,) = train_diffusion.main(["--device", "cpu", "--config-name", "train_synthetic_flow_matching", override,
                                           *TINY_OVERRIDES, f"trainer.save_path={tmp_path}"])
        entry = restore_checkpoint(tmp_path / "synthetic_flow_matching" / "checkpoints" / "denoiser")
        assert trainer.step > 0 and entry["params"] and all(is_lora_param(n) for n in entry["params"])
        return
    if override == "+repa":
        from diffulab_tpu_torch.examples import train_repa

        _write_latent_shards(tmp_path / "imagenet")
        (trainer,) = train_repa.main(["--device", "cpu", *PRECOMPUTED_OVERRIDES, f"trainer.save_path={tmp_path}",
                                      *(f"dataset.{s}.data_path={tmp_path / 'imagenet'}" for s in ("train", "val"))])
        run, steps = tmp_path / "imagenet_repa_flow_matching", 2

        assert any(k.startswith("extra_losses.0.resampler.") for k in restore_checkpoint(run / "checkpoints" /
                                                                                          "denoiser")["params"])
    else:
        (trainer,) = train_diffusion.main(["--device", "cpu", "--config-name", override, *DINO_OVERRIDES,
                                           *TINY_OVERRIDES, f"trainer.save_path={tmp_path}"])
        run, steps = tmp_path / "synthetic_edm_repa", 4
    rows = _repa_rows(run)
    assert trainer.step == steps and len(rows) == 2 * trainer.n_epoch and all(np.isfinite(rows))


@pytest.mark.parametrize("flags,item", [(["--prompts", "a cat"], "item 16"),
                                        (["model.attention_impl=ring"], "item 17"),
                                        (["trainer.lora_rank=4"], "item 16"),
                                        (["--config-name", "train_synthetic_edm_repa", "repa.repa_encoder=dinov2"],
                                         "item 13")])
def test_sample_cli_unported_options_raise(flags, item, tmp_path):
    """Ring attention (item 17) is ported since slice P1: the sample CLI
    builds no mesh, so ``attention_impl=ring`` takes the attention kernels'
    route, as the reference's does without one (mmdit.py:158), and samples
    what the default attention samples. --prompts (item 16) is ported since
    slice J1 (tests/test_torch_port_hf_text.py samples a text-to-image config
    through it); on a class-conditional config, which has no HF text
    embedder, it stops with the reference's message. LoRA
    checkpoints (item 16) restore since slice I1: a LoRA run's ``denoiser``
    entry holds its base and samples; its ``ema`` holds the adapters alone
    and is refused without ``trainer.lora_from``. A REPA config with a DINO encoder (item 13b) raised until slice
    G1; it now trains at a toy size and samples from its checkpoint, the
    frozen DINOv2 restored with it. The live FixedViT REPA configs sample in
    tests/test_torch_port_e1_cli.py. --guide-ckpt, --cache-*, --inpaint-*,
    --img2img-image and every sampler are ported and run in
    tests/test_torch_port_c2_cli.py; the Gaussian formalization in
    tests/test_torch_port_d1_cli.py."""
    if item == "item 17":
        config = ["--config-name", "train_synthetic_flow_matching", *TINY_OVERRIDES]
        train_diffusion.main(["--device", "cpu", *config, f"trainer.save_path={tmp_path}"])
        ckpt = tmp_path / "synthetic_flow_matching" / "checkpoints" / "ema"
        request = ["--device", "cpu", "--ckpt", str(ckpt), "--n", "4", "--steps", "2", "--out", str(tmp_path / "s.png")]
        ring = sample.main([*request, *config, *flags])
        plain = sample.main([*request, *config])
        assert np.isfinite(ring["images"]).all() and np.array_equal(ring["images"], plain["images"])
        return
    if flags == ["trainer.lora_rank=4"]:
        config = ["--config-name", "train_synthetic_flow_matching", *flags, *TINY_OVERRIDES]
        train_diffusion.main(["--device", "cpu", *config, f"trainer.save_path={tmp_path}"])
        ckpt = tmp_path / "synthetic_flow_matching" / "checkpoints"
        result = sample.main(["--device", "cpu", "--ckpt", str(ckpt / "denoiser"), "--n", "4", "--steps", "2",
                              "--out", str(tmp_path / "s.png"), *config])
        assert np.isfinite(result["images"]).all()
        with pytest.raises(SystemExit, match="lora_from"):
            sample.main(["--device", "cpu", "--ckpt", str(ckpt / "ema"), *config])
        return
    if flags[0] == "--prompts":
        config = ["--config-name", "train_synthetic_flow_matching", *TINY_OVERRIDES]
        train_diffusion.main(["--device", "cpu", *config, f"trainer.save_path={tmp_path}"])
        ckpt = tmp_path / "synthetic_flow_matching" / "checkpoints" / "ema"
        with pytest.raises(SystemExit, match="HF text embedder"):
            sample.main(["--device", "cpu", "--ckpt", str(ckpt), "--n", "2", *flags, *config])
        return
    if item != "item 13":
        with pytest.raises(NotImplementedError, match=item):
            sample.main(["--device", "cpu", "--ckpt", str(tmp_path), *flags, *TINY_OVERRIDES])
        return
    overrides = [*flags[2:], *DINO_OVERRIDES[1:], *TINY_OVERRIDES]
    train_diffusion.main(["--device", "cpu", *flags[:2], *overrides, f"trainer.save_path={tmp_path}"])
    result = sample.main(["--device", "cpu", "--ckpt", str(tmp_path / "synthetic_edm_repa" / "checkpoints" / "ema"),
                          *flags[:2], "--n", "4", "--guidance", "1.5", "--steps", "2", "--out", str(tmp_path / "s.png"),
                          *overrides])
    assert result["images"].shape == (4, 32, 32, 3) and np.isfinite(result["images"]).all()


def test_reconstruct_cli_without_snapshots_exits(tmp_path):
    with pytest.raises(SystemExit, match="no phema snapshots"):
        reconstruct_ema.main(["--run-dir", str(tmp_path), "--sigma-rel", "0.05"])
