"""Slice G1 through the port on the CPU: ``configs/train_imagenet_flow_matching_repa.yaml``
(a class-conditional DiT at patch 1 on DC-AE latents, REPA on precomputed
DINOv2 features through a Perceiver resampler) and its CLIs
(``precompute``, ``train_repa``, ``sample``).

- The config composes exactly as the JAX package composes it, alone and
  with ``vision_tower=dcae`` and ``repa.repa_encoder=dinov2|dinov3``, and
  every ``_target_`` resolves in the port (the encoders through RepaLoss's
  registry).
- ``RepaLoss(load_dino=False, use_resampler=True)`` in one flow
  ``compute_loss`` of a tiny DiT at patch 1 on latents, the batch's
  ``dst_features`` passed as the trainer passes them: every entry of the
  loss dict at rel 1e-5 and every gradient of their sum on the
  ``_TrainModules`` bundle (denoiser, projector, resampler) against
  ``jax.grad``, bridged noise weights and injected t, noise and drop.
- The full-width parameter trees, from shapes only: the config's extra loss
  (projector 768 -> 1024, the 3-deep resampler over 256 latents) and
  ``dinov2_vitl14_reg`` (24 blocks of 1024).
- ``precompute latents`` (a tiny DC-AE config) and ``precompute features``
  (a tiny DINOv3 from an HF checkpoint directory the test writes) against
  the JAX package's shards; ``precompute captions`` (a tiny Qwen3-VL
  checkpoint the test writes) against the JAX embedder's ``compute_on_dataset``.
- ``precompute`` -> ``train_repa`` -> ``sample`` at toy size: a tiny DC-AE
  (32x32 images to 8x8x32 latents, 64 tokens as the config's), random
  ViT-S/14 features at 4 tokens, the DiT at depth 2 and width 64.
"""

import json
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import _randomize, rel_err
from flax import nnx
from test_torch_port_dc_ae import bridged_shapes, diffusers_key
from test_torch_port_repa import _check_bundle_grads
from test_torch_port_repa_encoders import _write_hf_dir

from diffulab_tpu.config.compose import compose_config as jax_compose
from diffulab_tpu.data.streaming import ShardedDataset as JaxShardedDataset
from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.networks.denoisers.mmdit import MMDiT as JaxMMDiT
from diffulab_tpu.networks.repa.dinov2 import DinoV2 as JaxDinoV2
from diffulab_tpu.networks.vision_towers import dc_ae as jdc
from diffulab_tpu.training.losses.build import build_extra_losses as jax_build_extra_losses
from diffulab_tpu.training.losses.repa import RepaLoss as JaxRepaLoss
from diffulab_tpu.training.trainer import _TrainModules
from diffulab_tpu_torch.config import compose_config
from diffulab_tpu_torch.config.instantiate import locate, port_path
from diffulab_tpu_torch.data.streaming import ShardedDataset, ShardedDatasetWriter
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.examples import precompute, sample, train_repa
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.networks.repa import DinoV2, DinoV3, PerceiverResampler
from diffulab_tpu_torch.networks.vision_towers.dc_ae import DCAE
from diffulab_tpu_torch.training.checkpoint import TrainModules, restore_checkpoint
from diffulab_tpu_torch.training.losses import RepaLoss, build_extra_losses
from diffulab_tpu_torch.weights import state_dict_from_jax

CONFIG = "train_imagenet_flow_matching_repa"
CONFIGS = train_repa.CONFIG_DIR
JAX_PRECOMPUTE = CONFIGS.parent / "examples" / "precompute.py"
#: the tiny DC-AE: three stages (res, vit, vit) of 8, 16, 32 channels, 32 latent channels as the config's,
#: compression 4 (32x32 images to 8x8x32 latents, 64 tokens at patch 1)
TINY_TOWER = {"block_out_channels": [8, 16, 32], "block_types": ["res", "vit", "vit"],
              "encoder_layers_per_block": [1, 1, 1], "decoder_layers_per_block": [1, 1, 1],
              "qkv_multiscales": [[], [5], [5]], "attention_head_dim": 4}
TOWER_OVERRIDES = [f"vision_tower.{k}={json.dumps(v)}" for k, v in TINY_TOWER.items()]
#: the toy run: the DiT at depth 2, width 64; REPA at block 1 onto 4 ViT-S/14 tokens of 384 through a 1-deep
#: resampler of 4 latents; 32 + 16 images at batch 8, one epoch, 2 sampling steps
TOY = ["model.depth=2", "model.inner_dim=64", "model.embedding_dim=64", "model.num_heads=4", "repa.alignment_layer=1",
       "repa.embedding_dim=384", "perceiver_resampler.parameters.depth=1", "perceiver_resampler.parameters.dim=384",
       "perceiver_resampler.parameters.head_dim=8", "perceiver_resampler.parameters.num_heads=2",
       "perceiver_resampler.parameters.num_latents=4"]
RUN = ["dataloader.batch_size=8", "trainer.n_epoch=1", "trainer.val_steps=2", "diffuser.n_steps=2"]


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


@pytest.mark.parametrize("overrides", [[], ["vision_tower=dcae"], ["repa.repa_encoder=dinov2"],
                                       ["repa.repa_encoder=dinov3"]], ids=["config", "dcae", "dinov2", "dinov3"])
def test_g1_config_composes_like_jax_and_resolves(overrides):
    cfg = compose_config(CONFIGS, CONFIG, overrides)
    assert cfg == jax_compose(CONFIGS, CONFIG, overrides)
    for target in _targets(cfg, set()):
        assert locate(target).__module__.startswith("diffulab_tpu_torch."), target
        assert locate(target).__module__ == port_path(target).rsplit(".", 1)[0]
    assert locate(cfg["vision_tower"]["_target_"]) is DCAE
    model = cfg["model"]
    assert (model["inner_dim"], model["num_heads"], model["patch_size"], model["depth"], model["n_classes"],
            model["input_channels"]) == (768, 12, 1, 12, 1000, 32)
    assert cfg["trainer"]["precision_type"] == "bf16" and cfg["dataloader"]["batch_size"] == 128
    encoder = cfg["repa"].get("repa_encoder")
    if encoder:
        assert RepaLoss.encoder_registry[encoder] is {"dinov2": DinoV2, "dinov3": DinoV3}[encoder]


#: a tiny DiT at patch 1 on 4x4x8 latents (16 tokens of width 64); REPA at block 2 through a 2-deep resampler
#: onto 4 target tokens of width 16
TINY_DIT = dict(simple_dit=True, input_channels=8, output_channels=8, inner_dim=64, embedding_dim=64, num_heads=4,
                mlp_ratio=2, patch_size=1, depth=2, n_classes=10, classifier_free=True)
TINY_REPA = dict(load_dino=False, embedding_dim=16, alignment_layer=2, denoiser_dimension=64, hidden_dim=48,
                 use_resampler=True, coeff=0.5,
                 resampler_params=dict(dim=16, depth=2, head_dim=8, num_heads=2, ff_mult=2, num_latents=4))


def test_precomputed_repa_loss_and_gradients_match_jax():
    jm = nnx.eval_shape(lambda: JaxMMDiT(**TINY_DIT, rngs=nnx.Rngs(0)))
    tm = MMDiT(**TINY_DIT, device="cpu")
    tm.load_state_dict(state_dict_from_jax(_randomize(jm, 31), tm), strict=True)
    jl = nnx.eval_shape(lambda: JaxRepaLoss(**TINY_REPA, rngs=nnx.Rngs(2)))
    tl = RepaLoss(**TINY_REPA, device="cpu")
    tl.load_state_dict(state_dict_from_jax(_randomize(jl, 32), tl), strict=True)
    assert jl.repa_encoder is None and tl.repa_encoder is None and isinstance(tl.resampler, PerceiverResampler)
    jl.set_model(jm)
    tl.set_model(tm)
    rng = np.random.default_rng(33)
    x0 = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    feats = rng.standard_normal((2, 4, 16)).astype(np.float32)
    t, y, drop = np.array([0.25, 0.7], np.float32), np.array([1, 8]), np.array([True, False])
    jd = JaxDiffuser(jm, "euler", model_type="rectified_flow", n_steps=2, extra_losses=[jl])
    td = Diffuser(tm, "euler", model_type="rectified_flow", n_steps=2, extra_losses=[tl])
    graphdef, params, rest = nnx.split(_TrainModules(jm, [jl]), nnx.Param, ...)

    def jax_losses(p):
        m = nnx.merge(graphdef, p, rest)
        losses = jd.diffusion.compute_loss(
            lambda **kw: m.denoiser(**kw, train=True, capture_features=True), jnp.asarray(x0), {"y": jnp.asarray(y)},
            jnp.asarray(t), jnp.asarray(noise), drop=jnp.asarray(drop), extra_losses=list(m.extra_losses),
            extra_args={"dst_features": jnp.asarray(feats)})
        return sum(losses.values()), losses

    (ref_total, ref), ref_grads = jax.jit(jax.value_and_grad(jax_losses, has_aux=True))(params)
    ours = td.compute_loss(torch.from_numpy(x0), {"y": torch.from_numpy(y)}, torch.from_numpy(t),
                           torch.from_numpy(noise), drop=torch.from_numpy(drop),
                           extra_args={"dst_features": torch.from_numpy(feats)})
    assert set(ours) == set(ref) == {"loss", "RepaLoss"}
    for name in ref:
        assert abs(ours[name].item() - float(ref[name])) <= 1e-5 * abs(float(ref[name])), name
    total = sum(ours.values())
    total.backward()
    _check_bundle_grads(TrainModules(tm, [tl]), ref_grads)
    assert all(p.grad is not None and float(p.grad.abs().max()) > 0 for p in tl.resampler.parameters())
    with pytest.raises(ValueError, match="no dst_features"):
        tl(tm(torch.from_numpy(x0), torch.from_numpy(t), {"y": torch.from_numpy(y)}, capture_features=True),
           x0=torch.from_numpy(x0))


def test_full_width_extra_loss_and_dinov2_trees_match_jax():
    cfg = compose_config(CONFIGS, CONFIG)
    jl = nnx.eval_shape(lambda: jax_build_extra_losses(cfg)[0])
    (tl,) = build_extra_losses(cfg, device="cpu")
    assert tl.repa_encoder is None and (tl.alignment_layer, tl.coeff) == (8, 0.5)
    assert tuple(tl.proj_fc1.weight.shape) == (1024, 768) and tuple(tl.proj_fc3.weight.shape) == (1024, 1024)
    assert tuple(tl.resampler.latents.shape) == (256, 1024) and len(tl.resampler.attn_layers) == 3
    assert {k: tuple(v.shape) for k, v in tl.state_dict().items()} == bridged_shapes(jl, tl)
    jm = nnx.eval_shape(lambda: JaxDinoV2("dinov2_vitl14_reg", resolution=256, rngs=nnx.Rngs(0)))
    tm = DinoV2("dinov2_vitl14_reg", resolution=256, device="meta")
    assert tm.inference_resolution == jm.inference_resolution == 224 and tm.embedding_dim == 1024
    assert tuple(tm.encoder.pos_embed.shape) == (1, 257, 1024) and len(tm.encoder.blocks) == 24
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == bridged_shapes(jm, tm)


def _write_images(root, n: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    with ShardedDatasetWriter(root, shard_size=20) as writer:
        for _ in range(n):
            writer.write({"image": rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
                          "label": int(rng.integers(0, 1000))})


def _tiny_tower_dir(tmp_path):
    (tmp_path / "configs" / "vision_tower").mkdir(parents=True)
    tower = {"_target_": "diffulab_tpu.networks.vision_towers.dc_ae.DCAE", "latent_channels": 32, **TINY_TOWER}
    (tmp_path / "configs" / "vision_tower" / "tiny.yaml").write_text(json.dumps(tower))
    return tmp_path / "configs"


@pytest.mark.parametrize("mode", ["latents", "features", "captions"])
def test_precompute_cli_matches_jax(mode, tmp_path, monkeypatch):
    """latents: the CLI's tiny DC-AE (its seeded weights carried to the JAX
    tower through the diffusers checkpoint format) against the JAX
    package's ``compute_on_dataset``; features: the port's CLI against the
    JAX package's on one DINOv3 checkpoint directory; captions: the CLI with
    an embedder group naming a tiny Qwen3-VL checkpoint against the JAX
    package's ``QwenTextEmbedder.compute_on_dataset`` on that checkpoint."""
    src = tmp_path / "src"
    _write_images(src, 5, 1)
    if mode == "captions":
        from test_torch_port_hf_text import _caption_shards, _qwen_config, _qwen_dir

        from diffulab_tpu.networks.embedders.hf_text import QwenTextEmbedder as JaxQwen

        _caption_shards(src := tmp_path / "captions")
        group = _qwen_config(tmp_path, _qwen_dir(tmp_path / "qwen"))
        precompute.main(["captions", "--embedder", str(group).removesuffix(".yaml"), "--src", str(src), "--dst",
                         str(tmp_path / "port"), "--batch-size", "2", "--device", "cpu"])
        JaxQwen(**{k: v for k, v in json.loads(group.read_text()).items() if k != "_target_"}).compute_on_dataset(
            str(src), str(tmp_path / "jax"), batch_size=2)
        ours, ref = ShardedDataset(tmp_path / "port"), JaxShardedDataset(tmp_path / "jax")
        assert len(ours) == len(ref) == 5 and sorted(ours.columns) == sorted(ref.columns)
        for i in range(5):
            assert ours[i]["caption_embeddings"].shape[-1] == 32 and ours[i]["caption_mask"].dtype == np.bool_
            for col in ours.columns:
                np.testing.assert_array_equal(ours[i][col], ref[i][col])
        return
    if mode == "latents":
        monkeypatch.setattr(precompute, "CONFIG_DIR", _tiny_tower_dir(tmp_path))
        argv = ["latents", "--vision-tower", "tiny", "--src", str(src), "--dst", str(tmp_path / "port"),
                "--batch-size", "2", "--seed", "3", "--device", "cpu"]
        precompute.main(argv)
        tower = precompute.build(precompute.parse_args(argv), torch.device("cpu"))
        jm = nnx.eval_shape(lambda: jdc.DCAE(latent_channels=32, **TINY_TOWER, rngs=nnx.Rngs(0)))
        _randomize(jm, 0)
        jdc.load_dc_ae_state_dict(jm, {diffusers_key(k): v.numpy() for k, v in tower.state_dict().items()})
        jm.compute_on_dataset(str(src), str(tmp_path / "jax"), batch_size=2, seed=3)
        column, shape = "vision_latents", (8, 8, 32)
    else:
        _write_hf_dir(tmp_path / "dinov3", "float32", 4)
        args = ["features", "--encoder", "dinov3", "--encoder-args",
                f"{{resolution: 32, weights_path: {tmp_path / 'dinov3'}}}", "--src", str(src), "--batch-size", "2"]
        precompute.main([*args, "--dst", str(tmp_path / "port"), "--device", "cpu"])
        monkeypatch.setattr(sys, "argv", ["precompute.py", *args, "--dst", str(tmp_path / "jax")])
        runpy.run_path(str(JAX_PRECOMPUTE), run_name="__main__")
        column, shape = "dst_features", (16, 32)
    ours, ref = ShardedDataset(tmp_path / "port"), JaxShardedDataset(tmp_path / "jax")
    assert len(ours) == len(ref) == 5 and sorted(ours.columns) == sorted(ref.columns) == sorted(["image", "label",
                                                                                                   column])
    for i in range(5):
        assert ours[i][column].shape == shape and ours[i]["label"] == ref[i]["label"]
        assert rel_err(ours[i][column], ref[i][column]) <= 1e-5, i


def test_precompute_train_repa_sample_chain(tmp_path, monkeypatch):
    """The slice's four steps at toy size through the port's CLIs; the run's
    REPA rows, its checkpoint split (the resampler trainable, no frozen
    encoder), a validation grid decoded by the tower, and a request of 4
    images at CFG 4.0 decoded to 32x32 pixels."""
    monkeypatch.setattr(precompute, "CONFIG_DIR", _tiny_tower_dir(tmp_path))
    for split, n, seed in (("train", 32, 5), ("val", 16, 6)):
        _write_images(tmp_path / "raw" / split, n, seed)
        common = ["--batch-size", "8", "--device", "cpu"]
        precompute.main(["latents", "--vision-tower", "tiny", "--src", str(tmp_path / "raw" / split), "--dst",
                         str(tmp_path / "latents" / split), *common])
        precompute.main(["features", "--encoder", "dinov2", "--encoder-args",
                         "{dino_model: dinov2_vits14_reg, target_seq_len: 4}", "--src",
                         str(tmp_path / "latents" / split), "--dst", str(tmp_path / "imagenet" / split), *common])
    row = ShardedDataset(tmp_path / "imagenet" / "train")[0]
    assert row["vision_latents"].shape == (8, 8, 32) and row["dst_features"].shape == (4, 384)
    data = [f"dataset.{s}.data_path={tmp_path / 'imagenet'}" for s in ("train", "val")]
    (trainer,) = train_repa.main(["--device", "cpu", *TOWER_OVERRIDES, *TOY, *RUN, *data,
                                  f"trainer.save_path={tmp_path / 'runs'}"])
    run = tmp_path / "runs" / "imagenet_repa_flow_matching"
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    repa = [r[k] for r in rows for k in ("train/RepaLoss", "val/RepaLoss") if k in r]
    assert trainer.step == 4 and len(repa) == 2 and all(np.isfinite(v) and v > 0 for v in repa)
    assert len(list((run / "images").glob("val_images_step*.png"))) == 1
    state = restore_checkpoint(run / "checkpoints" / "denoiser")
    assert any(k.startswith("extra_losses.0.resampler.") for k in state["params"])
    assert not any("repa_encoder" in k for k in (*state["params"], *state["rest"]))
    result = sample.main(["--device", "cpu", "--config-name", CONFIG, "--ckpt", str(run / "checkpoints" / "ema"),
                          "--n", "4", "--guidance", "4.0", "--steps", "2", "--image-size", "32", "--labels", "3,999",
                          "--out", str(tmp_path / "s.png"), *TOWER_OVERRIDES, *TOY])
    assert result["images"].shape == (4, 32, 32, 3) and np.isfinite(result["images"]).all()
    assert result["labels"].tolist() == [3, 999, 3, 999]
