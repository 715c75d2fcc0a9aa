"""Slice F1 through the port's CLIs on the CPU at a toy size:
``train_synthetic_flow_matching`` with ``model=sprint`` and ``model=ddt``,
and ``train_cifar10_flow_matching`` on CIFAR-10 pickles written from a seed,
each through ``train_diffusion`` then ``sample``.

- Each config composes exactly as the JAX package composes it and every
  ``_target_`` resolves in the port.
- ``classifier_free: false`` with a guidance scale: the reference's sample
  CLI passes ``--guidance`` to ``generate`` whatever the model (sample.py:47,
  :204), so the request runs fused CFG with a null half whose drop mask the
  model ignores: a DiT or DDT gives the conditional prediction, and the
  guided request equals the unguided one; a SprintDiT still path-drops the
  null half's deep output, so its guidance acts. Pinned on the JAX models
  and through the port's CLI.
- The trainer's generator reaches SprintDiT's token drop: one seed keeps the
  same tokens, another seed others, and each step draws anew.

Toy sizes: width 64, 4 heads, depth 1-2 a stack, 32x32x3 images (256
tokens at patch 2), 64 + 32 samples (CIFAR: 4 x 16 + 32 images), batches of
32, one epoch, 2 sampling steps.
"""

import json
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from diffulab_tpu.config.compose import compose_config as jax_compose
from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.networks.denoisers.mmdit import MMDiT as JaxMMDiT
from diffulab_tpu.networks.denoisers.sprint import SprintDiT as JaxSprint
from diffulab_tpu_torch.config import compose_config
from diffulab_tpu_torch.config.instantiate import locate
from diffulab_tpu_torch.examples import sample, train_diffusion
from diffulab_tpu_torch.networks.denoisers import SprintDiT

CONFIGS = train_diffusion.CONFIG_DIR
MODELS = {
    "sprint": ["model=sprint", "model.inner_dim=64", "model.embedding_dim=64", "model.num_heads=4",
               "model.encoder_depth=1", "model.deep_layers_depth=2", "model.decoder_depth=1"],
    "ddt": ["model=ddt", "model.inner_dim=64", "model.num_heads=4", "model.encoder_depth=2", "model.decoder_depth=1"],
}
DIT = ["model.depth=2", "model.inner_dim=64", "model.embedding_dim=64", "model.num_heads=4"]
DATA = ["dataset.train.n_samples=64", "dataset.val.n_samples=32", "dataloader.batch_size=32", "trainer.n_epoch=1",
        "trainer.val_steps=2"]
CIFAR = "train_cifar10_flow_matching"


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


def _targets(node):
    if isinstance(node, dict):
        if "_target_" in node:
            yield node["_target_"]
        for value in node.values():
            yield from _targets(value)
    elif isinstance(node, list):
        for value in node:
            yield from _targets(value)


def write_cifar10(root, per_batch: int = 16, val: int = 32, seed: int = 0) -> None:
    """CIFAR-10 python pickles from a seed: data_batch_1-4 of ``per_batch``
    images and data_batch_5 of ``val``, uint8 rows of 3072 (CHW) and labels."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(1, 6):
        n = per_batch if i < 5 else val
        with open(root / f"data_batch_{i}", "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         "labels": rng.integers(0, 10, n).tolist()}, f)


@pytest.mark.parametrize("config, overrides", [
    ("train_synthetic_flow_matching", ["model=sprint"]),
    ("train_synthetic_flow_matching", ["model=ddt"]),
    (CIFAR, []),
])
def test_f1_configs_compose_like_jax_and_resolve(config, overrides):
    cfg = compose_config(CONFIGS, config, overrides)
    assert cfg == jax_compose(CONFIGS, config, overrides)
    assert all(locate(target) is not None for target in _targets(cfg))
    model = cfg["model"]
    assert locate(model["_target_"]).__module__.startswith("diffulab_tpu_torch.")
    # C1's config gives the model group a CFG null class; the CIFAR config keeps dit.yaml's none
    assert model["classifier_free"] is (config != CIFAR) and model["inner_dim"] == 512 and model["num_heads"] == 8
    assert model["n_classes"] == 10 and model["patch_size"] == 2
    if config == CIFAR:
        assert locate(model["_target_"]).__name__ == "MMDiT" and model["depth"] == 10
        assert cfg["dataloader"]["batch_size"] == 32 and cfg["trainer"]["gradient_accumulation_step"] == 2
        assert cfg["trainer"]["precision_type"] == "no" and cfg["diffuser"]["n_steps"] == 100
        assert cfg["trainer"]["p_classifier_free_guidance"] == 0.2


def _run(config, overrides, tmp_path, seed: int = 0):
    (trainer,) = train_diffusion.main(["--device", "cpu", "--seed", str(seed), "--config-name", config, *overrides,
                                       f"trainer.save_path={tmp_path}"])
    return trainer


def _losses(run):
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    return [r[key] for r in rows for key in ("train/loss", "val/loss") if key in r]


def _sample(config, ckpt, overrides, out, guidance):
    return sample.main(["--device", "cpu", "--config-name", config, "--ckpt", str(ckpt), "--n", "4", "--steps", "2",
                        "--labels", "0,1", "--guidance", str(guidance), "--out", str(out), *overrides])["images"]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_override_trains_and_samples_through_the_clis(model, tmp_path):
    """``model=sprint`` / ``model=ddt`` on C1's config (``classifier_free:
    true`` there): one epoch (2 steps, post-hoc EMA on), then a sample
    request from the EMA checkpoint at CFG 1.5."""
    overrides = [*MODELS[model], *DATA]
    trainer = _run("train_synthetic_flow_matching", overrides, tmp_path)
    run = tmp_path / "synthetic_flow_matching"
    assert trainer.step == 2
    losses = _losses(run)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert len(sorted((run / "images").glob("val_images_step*.png"))) == 1
    assert len(sorted((run / "checkpoints" / "phema").iterdir())) == 2
    images = _sample("train_synthetic_flow_matching", run / "checkpoints" / "ema", MODELS[model], tmp_path / "g.png",
                     1.5)
    assert images.shape == (4, 32, 32, 3) and np.isfinite(images).all() and (tmp_path / "g.png").is_file()


def test_cifar10_trains_and_samples_on_written_pickles(tmp_path):
    """train_cifar10_flow_matching on pickles written from a seed: 64
    training images in batches of 32 with the config's accumulation of 2
    (one AdamW update), validation on data_batch_5 (32); then sample requests at
    CFG 1.5 and without, equal as the reference's would be (the DiT has no
    null class, so the null half is the conditional one)."""
    data = tmp_path / "cifar"
    write_cifar10(data)
    overrides = [*DIT, f"dataset.train.data_path={data}", f"dataset.val.data_path={data}", "trainer.n_epoch=1",
                 "trainer.val_steps=2"]
    trainer = _run(CIFAR, overrides, tmp_path)
    run = tmp_path / "cifar10_flow_matching"
    assert trainer.step == 2
    losses = _losses(run)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert len(sorted((run / "images").glob("val_images_step*.png"))) == 1
    ckpt = next(p for p in sorted((run / "checkpoints").iterdir()) if p.name in ("ema", "denoiser"))
    guided = _sample(CIFAR, ckpt, overrides, tmp_path / "g.png", 1.5)
    plain = _sample(CIFAR, ckpt, overrides, tmp_path / "p.png", 0.0)
    assert guided.shape == (4, 32, 32, 3) and np.isfinite(guided).all() and (guided >= 0).all() and (guided <= 1).all()
    assert float(np.abs(guided - plain).max()) < 1e-5


@pytest.mark.parametrize("kind", ["dit", "sprint"])
def test_the_reference_guides_a_model_without_a_null_class_by_its_drop_mask(kind):
    """The reference at ``classifier_free: false``: a guided Euler-2 request
    of the JAX DiT equals its unguided one (the drop mask reaches no
    condition), the JAX SprintDiT's does not (path drop); the port's models
    give the same requests."""
    from _torch_port_common import _randomize

    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.networks.denoisers import MMDiT
    from diffulab_tpu_torch.weights import state_dict_from_jax

    cfg = dict(simple_dit=True, input_channels=3, inner_dim=64, embedding_dim=64, num_heads=4, patch_size=2,
               n_classes=10, classifier_free=False)
    cfg.update(depth=2) if kind == "dit" else cfg.update(encoder_depth=1, deep_layers_depth=1, decoder_depth=1)
    jax_cls, port_cls = (JaxMMDiT, MMDiT) if kind == "dit" else (JaxSprint, SprintDiT)
    jm = jax_cls(**cfg, rngs=nnx.Rngs(0))
    params = _randomize(jm, 21)
    tm = port_cls(**cfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, tm), strict=True)
    x = np.random.default_rng(22).standard_normal((2, 8, 8, 3)).astype(np.float32)
    y = np.array([3, 7])
    jd, td = JaxDiffuser(jm, "euler", n_steps=2), Diffuser(tm, "euler", n_steps=2)
    ref = {s: np.asarray(jd.generate(jax.random.key(0), {"y": jnp.asarray(y)}, x=jnp.asarray(x),
                                     guidance_scale=s)["x"]) for s in (0.0, 1.5)}
    ours = {s: td.generate({"y": torch.from_numpy(y)}, x=torch.from_numpy(x), guidance_scale=s,
                           device="cpu")["x"].numpy() for s in (0.0, 1.5)}
    scale = float(np.abs(ref[0.0]).max())
    ref_gap = float(np.abs(ref[1.5] - ref[0.0]).max()) / scale
    assert (ref_gap < 1e-6) if kind == "dit" else (ref_gap > 1e-3)
    for s in (0.0, 1.5):
        assert float(np.abs(ours[s] - ref[s]).max()) < 1e-5 * scale


def test_the_trainers_generator_reaches_the_token_drop(tmp_path, monkeypatch):
    """The kept tokens of every training forward, over two runs with seed 0
    and one with seed 1: the same two lists for seed 0, other tokens for seed
    1, and a fresh draw each step."""
    kept_by_run = []
    original = SprintDiT.drop_tokens

    def recording(self, x, cos_sin, train, generator=None, scores=None):
        out = original(self, x, cos_sin, train, generator, scores)
        if train:
            assert generator is not None and scores is None
            kept_by_run[-1].append(out[1].clone())
        return out

    monkeypatch.setattr(SprintDiT, "drop_tokens", recording)
    overrides = [*MODELS["sprint"], *DATA, "trainer.posthoc_ema=false", "trainer.log_validation_images=false"]
    for i, seed in enumerate((0, 0, 1)):
        kept_by_run.append([])
        _run("train_synthetic_flow_matching", overrides, tmp_path / str(i), seed=seed)
    same, again, other = kept_by_run
    assert len(same) == 2 and all(k.shape == (32, 64) for k in same)  # int(256 * 0.25) of a batch of 32
    assert all(torch.equal(a, b) for a, b in zip(same, again))
    assert not torch.equal(same[0], same[1])
    assert not any(torch.equal(a, b) for a, b in zip(same, other))
