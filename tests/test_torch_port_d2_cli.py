"""Slice D2, ``configs/train_mnist_ddpm.yaml`` (the MNIST UNet under
Gaussian diffusion, DDPM ancestral sampling) and
``configs/train_mnist_flow_matching.yaml`` (the same UNet under rectified
flow, Euler), on the CPU at a toy width: ``model_channels`` 32 with the
config's ``channel_mult`` 1, 2, 4, 8, so that the attention at ds 4 (8x8
tokens) and ds 8 (4x4 tokens, and the middle block) still runs, at head dims
64 and 128 (the JAX GroupNorm32 takes no narrower decoder).

- Each config composes exactly as the JAX package composes it, every
  ``_target_`` resolves, and the full-width UNet (built on the meta device)
  attends at head dims 256 (5 calls a forward) and 512 (6), never at ds 16.
- The train step's loss and every parameter gradient, and a short request
  (DDPM-3 from injected draws, trap T4; Euler-3), against the JAX package
  with bridged weights (trap T9): the UNet under each formalization, fed
  integer timesteps by the Gaussian one and continuous t by the flow.
- ``train_diffusion`` and ``sample`` on MNIST idx files written from a seed
  (no download).

Tolerances: the loss within 1e-5 relative, each gradient within 1e-4 of its
tensor's largest (or of a hundredth of the model's largest, for a gradient
of rounding noise; ``tests/test_torch_port_unet.py``'s), a request's sample
within 5e-4 of the largest |JAX| value for DDPM (x0 is the epsilon head's
rounding times up to 1/sqrt(alpha_bar) = 157, as
``tests/test_torch_port_gaussian.py`` states) and 1e-5 for Euler.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import _randomize, injected, jax_scan_noise, rel_err, write_mnist
from flax import nnx

from diffulab_tpu.config.compose import compose_config as jax_compose
from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.networks.denoisers.unet import UNetModel as JaxUNet
from diffulab_tpu_torch.config import compose_config
from diffulab_tpu_torch.config.instantiate import instantiate, locate
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.examples import sample, train_diffusion
from diffulab_tpu_torch.networks.denoisers.unet import AttentionBlock, UNetModel
from diffulab_tpu_torch.ops import dot_product_attention
from diffulab_tpu_torch.ops.fused_mha import check_head_dim
from diffulab_tpu_torch.weights import state_dict_from_jax

CONFIGS = {"ddpm": "train_mnist_ddpm", "flow": "train_mnist_flow_matching"}
CONFIG_DIR = train_diffusion.CONFIG_DIR
TOY = ["model.model_channels=32"]
BATCH = 2
SHAPE = (BATCH, 32, 32, 1)


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


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_mnist_config_composes_like_jax_and_resolves(kind):
    cfg = compose_config(CONFIG_DIR, CONFIGS[kind])
    assert cfg == jax_compose(CONFIG_DIR, CONFIGS[kind])
    assert all(locate(target) is not None for target in _targets(cfg))
    model = cfg["model"]
    assert locate(model["_target_"]) is UNetModel
    assert (model["in_channels"], model["out_channels"], model["model_channels"], model["num_heads"]) == (1, 1, 128, 2)
    assert model["classifier_free"] is False and model["resblock_updown"] and model["use_scale_shift_norm"]
    assert cfg["dataloader"]["batch_size"] == 128 and cfg["trainer"]["gradient_accumulation_step"] == 2
    assert cfg["trainer"]["precision_type"] == "no" and cfg["trainer"]["val_steps"] == 50
    assert cfg["diffuser"]["model_type"] == {"ddpm": "gaussian_diffusion", "flow": "rectified_flow"}[kind]
    # the full width on the meta device: 2 heads of 256 at ds 4 (2 encoder + 3 decoder blocks), of 512 at
    # ds 8 (2 + 3) and in the middle block; ds 16 is listed but never reached
    full = instantiate(model, device="meta")
    dims = [m.dim_head for m in full.modules() if isinstance(m, AttentionBlock)]
    assert sorted(dims) == [256] * 5 + [512] * 6
    assert sum(p.numel() for p in full.parameters()) == 276_690_433


@pytest.mark.parametrize("d", [256, 512])
def test_check_head_dim_takes_fp32_and_names_queue_2a_for_bf16(d):
    # the fused route takes both dtypes at the MNIST UNet's dims; the flash route (past the fused kernel's 512
    # tokens) names queue 2a, for a bf16 tensor as for an fp32 one
    check_head_dim(d)
    with pytest.raises(NotImplementedError, match="queue 2a"):
        check_head_dim(d, "flash")
    q = torch.zeros(1, 64, 2, d, dtype=torch.bfloat16)
    assert dot_product_attention(q, q, q).dtype == torch.bfloat16
    long = torch.zeros(1, 520, 2, d, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="queue 2a"):
        dot_product_attention(long, long, long)


def _toy(kind):
    """The config's diffuser section and its UNet at the toy width on both
    sides, every JAX parameter seeded noise, bridged (the JAX module is built
    abstractly, since every parameter is replaced)."""
    cfg = compose_config(CONFIG_DIR, CONFIGS[kind], TOY)
    kwargs = {k: v for k, v in cfg["model"].items() if k != "_target_"}
    jm = nnx.eval_shape(lambda: JaxUNet(**kwargs, rngs=nnx.Rngs(0)))
    params = _randomize(jm, 13)
    tm = instantiate(cfg["model"], device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, tm), strict=True)
    return cfg["diffuser"], jm, tm


def _diffusers(diffuser_cfg, jm, tm):
    kw = dict(model_type=diffuser_cfg["model_type"], n_steps=diffuser_cfg["n_steps"],
              extra_args=diffuser_cfg.get("extra_args", {}))
    return (JaxDiffuser(jm, diffuser_cfg["sampling_method"], **kw),
            Diffuser(tm, diffuser_cfg["sampling_method"], **kw))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def toy(request):
    return request.param, *_toy(request.param)


def test_train_step_loss_and_gradients_match_jax(toy):
    kind, diffuser_cfg, jm, tm = toy
    jd, td = _diffusers(diffuser_cfg, jm, tm)
    rng = np.random.default_rng(14)
    x0 = np.clip(rng.standard_normal(SHAPE), -1, 1).astype(np.float32)
    noise = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.array([17, 802], np.int32) if kind == "ddpm" else np.array([0.13, 0.71], np.float32)
    y, drop = np.array([3, 8]), np.array([False, True])  # no null class: the drop is ignored
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def jax_loss(p):
        jd.denoiser = nnx.merge(graphdef, p, rest)
        return jd.compute_loss(jnp.asarray(x0), {"y": jnp.asarray(y)}, jnp.asarray(t), jnp.asarray(noise),
                               drop=jnp.asarray(drop))["loss"]

    ref, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    tm.zero_grad(set_to_none=True)
    loss = td.compute_loss(torch.from_numpy(x0), {"y": torch.from_numpy(y)}, torch.from_numpy(t),
                           torch.from_numpy(noise), drop=torch.from_numpy(drop))["loss"]
    loss.backward()
    assert abs(float(loss.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    flat = {"/".join(str(p) for p in path): np.asarray(v.get_value()) for path, v in ref_grads.flat_state()}
    grads = state_dict_from_jax(flat, tm)
    floor = 1e-2 * max(float(g.abs().max()) for g in grads.values())
    for name, param in tm.named_parameters():
        err = float((param.grad - grads[name]).abs().max())
        assert err <= 1e-4 * max(float(grads[name].abs().max()), floor), (name, err)


def test_a_short_request_matches_jax(toy):
    kind, diffuser_cfg, jm, tm = toy
    jd, td = _diffusers(diffuser_cfg, jm, tm)
    for d in (jd, td):
        d.set_steps(3)
    x = np.random.default_rng(15).standard_normal(SHAPE).astype(np.float32)
    y = np.array([2, 6])
    key = jax.random.key(16)
    ref = jd.generate(key, {"y": jnp.asarray(y)}, x=jnp.asarray(x), clamp_x=True)["x"]
    draws = jax_scan_noise(key, 3, SHAPE, jnp.float32) if kind == "ddpm" else {}
    out = td.generate({"y": torch.from_numpy(y)}, x=torch.from_numpy(x), clamp_x=True, device="cpu",
                      draw_noise=injected(draws))["x"]
    assert out.shape == SHAPE and torch.isfinite(out).all()
    assert rel_err(out.numpy(), np.asarray(ref)) < (5e-4 if kind == "ddpm" else 1e-5)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_train_and_sample_clis_on_synthesized_mnist(kind, tmp_path):
    data = tmp_path / "mnist"
    write_mnist(data, 8, 4)
    overrides = [*TOY, f"dataset.train.data_path={data}", f"dataset.val.data_path={data}"]
    (trainer,) = train_diffusion.main(["--device", "cpu", "--config-name", CONFIGS[kind], *overrides,
                                       "trainer.n_epoch=1", "dataloader.batch_size=4", "trainer.val_steps=2",
                                       f"trainer.save_path={tmp_path}"])
    run = tmp_path / {"ddpm": "mnist_ddpm", "flow": "mnist_flow_matching"}[kind]
    assert trainer.step == 2  # 8 images in batches of 4; one AdamW update (accumulation 2)
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r[key] for r in rows for key in ("train/loss", "val/loss") if key in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert len(sorted((run / "images").glob("val_images_step*.png"))) == 1
    ckpt = next(p for p in sorted((run / "checkpoints").iterdir()) if p.name in ("ema", "denoiser"))
    result = sample.main(["--device", "cpu", "--config-name", CONFIGS[kind], "--ckpt", str(ckpt), "--n", "4",
                          "--steps", "2", "--labels", "0,1", "--out", str(tmp_path / "grid.png"), *overrides])
    images = result["images"]
    assert images.shape == (4, 32, 32, 1) and np.isfinite(images).all()
    assert (images >= 0).all() and (images <= 1).all() and (tmp_path / "grid.png").is_file()
