"""The port's guided and conditioned sampling and its training extras
against the JAX package: autoguidance, inpainting and img2img trajectories
(flow and EDM), guidance distillation, reflow's coupled noise, and the
trainer's augmentation, distillation and reflow paths on the CPU.

Trajectories start from the same injected ``x`` (or img2img ``init``) and
take the reference's own draws (its img2img start noise and its per-step
inpaint re-noising) through ``draw_noise`` (trap T4); fp32 throughout, rel
err 1e-5 (max |port - JAX| over max |JAX|). Losses at injected t/sigma,
noise and drop mask, rel err 1e-5.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import (
    LATENT,
    TINY,
    injected,
    jax_scan_noise,
    port_model,
    randomized_jax_model,
    rel_err,
)

from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu_torch.data.reflow import ReflowPairsDataset, generate_pairs
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.training import optim as toptim
from diffulab_tpu_torch.training import trainer as trainer_mod
from diffulab_tpu_torch.training.trainer import BaseTrainer

STEPS = 6
FORMS = {"flow": ("euler", "rectified_flow", 1.0), "flow_heun": ("heun", "rectified_flow", 1.0),
         "edm": ("heun", "edm", 80.0)}


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
def pairs():
    """Two randomised tiny DiTs (the model and a degraded guide / teacher) on both sides."""
    out = []
    for seed in (3, 31):
        jax_model, params = randomized_jax_model("fp32", seed=seed)
        out.append((jax_model, port_model("fp32", params)))
    return out


def _inputs(seed, batch=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, *LATENT)).astype(np.float32), rng.integers(0, TINY["n_classes"], batch)


def _both(pairs, form):
    sampler, model_type, _ = FORMS[form]
    (jax_model, model), _ = pairs
    return (JaxDiffuser(jax_model, sampler, model_type=model_type, n_steps=STEPS),
            Diffuser(model, sampler, model_type=model_type, n_steps=STEPS))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_autoguidance_matches_jax(pairs, form):
    jd, td = _both(pairs, form)
    (_, _), (jax_guide, guide) = pairs
    x, y = _inputs(40)
    x = FORMS[form][2] * x
    ref = jd.generate(jax.random.key(0), {"y": jnp.asarray(y)}, x=jnp.asarray(x), guidance_scale=2.5,
                      guide_denoiser=jax_guide)["x"]
    out = td.generate({"y": torch.from_numpy(y)}, x=torch.from_numpy(x), guidance_scale=2.5, guide_denoiser=guide,
                      device="cpu")["x"]
    assert rel_err(out.numpy(), np.asarray(ref)) < 1e-5
    with pytest.raises(ValueError, match="guidance_scale > 0"):
        td.generate({"y": torch.from_numpy(y)}, x=torch.from_numpy(x), guide_denoiser=guide, device="cpu")


@pytest.mark.parametrize("form", sorted(FORMS))
def test_inpaint_matches_jax_and_keeps_the_known_region(pairs, form):
    jd, td = _both(pairs, form)
    x, y = _inputs(41)
    x = FORMS[form][2] * x
    known = np.tanh(np.random.default_rng(42).standard_normal((3, *LATENT))).astype(np.float32)
    mask = np.ones((3, *LATENT[:2], 1), np.float32)
    mask[:, 2:6, 1:5] = 0.0
    key = jax.random.key(43)
    ref = jd.generate(key, {"y": jnp.asarray(y)}, x=jnp.asarray(x), guidance_scale=1.5,
                      inpaint={"known": known, "mask": mask}, return_intermediates=True)
    n_body = STEPS - 1 if FORMS[form][1] == "edm" else STEPS
    draws = jax_scan_noise(key, n_body, x.shape, jnp.float32, inpaint=True)
    out = td.generate({"y": torch.from_numpy(y)}, x=torch.from_numpy(x), guidance_scale=1.5, device="cpu",
                      inpaint={"known": known, "mask": mask}, return_intermediates=True, draw_noise=injected(draws))
    for name in ("x", "xt"):
        assert rel_err(out[name].numpy(), np.asarray(ref[name])) < 1e-5, name
    keep = np.broadcast_to(mask, out["x"].shape) > 0
    np.testing.assert_array_equal(out["x"].numpy()[keep], np.broadcast_to(known, out["x"].shape)[keep])
    assert float(np.abs(out["x"].numpy()[~keep] - known[~keep]).max()) > 1e-3


@pytest.mark.parametrize("strength", [0.5, 1.0])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_img2img_matches_jax(pairs, form, strength):
    jd, td = _both(pairs, form)
    init, y = _inputs(44)
    key = jax.random.key(45)
    ref = jd.generate(key, {"y": jnp.asarray(y)}, data_shape=init.shape, guidance_scale=1.5,
                      img2img={"init": init, "strength": strength}, return_intermediates=True)
    _, init_rng = jax.random.split(key)
    draws = {("img2img", 0): np.asarray(jax.random.normal(init_rng, init.shape, dtype=jnp.float32))}
    out = td.generate({"y": torch.from_numpy(y)}, data_shape=init.shape, guidance_scale=1.5, device="cpu",
                      img2img={"init": init, "strength": strength}, return_intermediates=True,
                      draw_noise=injected(draws))
    k = min(max(int(round(strength * STEPS)), 1), STEPS)
    n_steps = k - 1 if FORMS[form][1] == "edm" else k  # EDM's collapse is the last grid step
    assert out["estimated_x0"].shape[1] == ref["estimated_x0"].shape[1] == n_steps + (FORMS[form][1] == "edm")
    for name in ("x", "xt", "estimated_x0"):
        assert rel_err(out[name].numpy(), np.asarray(ref[name])) < 1e-5, name


@pytest.mark.parametrize("model_type", ["rectified_flow", "edm"])
def test_distillation_loss_matches_jax(pairs, model_type):
    (jax_model, model), (jax_teacher, teacher) = pairs
    x0, y = _inputs(46, batch=4)
    rng = np.random.default_rng(47)
    t = (rng.uniform(0.05, 1.0, 4) if model_type == "rectified_flow" else np.exp(rng.standard_normal(4))
         ).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    sampler = "euler" if model_type == "rectified_flow" else "heun"
    jd = JaxDiffuser(jax_model, sampler, model_type=model_type, n_steps=STEPS)
    ref = jd.diffusion.compute_loss(jd.model_fn(), jnp.asarray(x0), {"y": jnp.asarray(y)}, jnp.asarray(t),
                                    jnp.asarray(noise), distill_fn=lambda **kw: jax_teacher(**kw, train=False),
                                    distill_guidance=1.5)["loss"]
    td = Diffuser(model, sampler, model_type=model_type, n_steps=STEPS)
    loss = td.diffusion.compute_loss(td.model_fn(), torch.from_numpy(x0), {"y": torch.from_numpy(y)},
                                     torch.from_numpy(t), torch.from_numpy(noise),
                                     distill_fn=Diffuser._model_fn(teacher, False), distill_guidance=1.5)["loss"]
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
    loss.backward()  # the target is formed without gradients: none reach the teacher
    assert all(p.grad is None for p in teacher.parameters())
    assert any(p.grad is not None for p in model.parameters())
    model.zero_grad(set_to_none=True)


def test_reflow_coupled_noise_loss_matches_jax(pairs, tmp_path):
    """A reflow batch's coupled z is the noise of the step's loss, as the
    reference's trainer uses it (trainer.py:324-329)."""
    (jax_model, model), _ = pairs
    x0, y = _inputs(48, batch=4)
    z = np.random.default_rng(49).standard_normal(x0.shape).astype(np.float32)
    t = np.array([0.1, 0.4, 0.7, 0.95], np.float32)
    jd = JaxDiffuser(jax_model, "euler", n_steps=STEPS)
    ref = jd.diffusion.compute_loss(jd.model_fn(), jnp.asarray(x0), {"y": jnp.asarray(y)}, jnp.asarray(t),
                                    jnp.asarray(z))["loss"]
    diffuser = Diffuser(model, "euler", n_steps=STEPS)
    batch = ReflowPairsDataset(x0, z, y).get_batch(np.arange(4))
    assert set(batch["model_inputs"]) == {"x", "coupled_noise", "y"}
    batch = {"model_inputs": {k: torch.as_tensor(v) for k, v in batch["model_inputs"].items()}}
    opt = trainer_mod.MultiStepOptimizer(torch.optim.SGD(model.parameters(), lr=0.0))
    losses = trainer_mod.train_step(diffuser, opt, None, batch, torch.from_numpy(t), None, None, 1)
    assert abs(float(losses["loss"]) - float(ref)) <= 1e-5 * abs(float(ref))


# --- the trainer and the pairs generator on the CPU --------------------------------

def _loader(n_batches, seed, batch=4, coupled=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        mi = {"x": rng.standard_normal((batch, *LATENT)).astype(np.float32),
              "y": rng.integers(0, TINY["n_classes"], batch)}
        if coupled:
            mi["coupled_noise"] = rng.standard_normal((batch, *LATENT)).astype(np.float32)
        out.append({"model_inputs": mi})
    return out


def _recording(monkeypatch):
    seen = []
    original = trainer_mod.train_step

    def wrapped(diffuser, opt, ema, batch, t, noise, drop, step, phema=None, **kw):
        seen.append(dict(batch=batch["model_inputs"], noise=noise, drop=drop, **kw))
        return original(diffuser, opt, ema, batch, t, noise, drop, step, phema, **kw)

    monkeypatch.setattr(trainer_mod, "train_step", wrapped)
    return seen


def test_trainer_augments_with_labels_and_refuses_reflow_batches(tmp_path, monkeypatch):
    seen = _recording(monkeypatch)
    torch.manual_seed(0)
    model = MMDiT(**TINY, augment_dim=6, device="cpu")
    trainer = BaseTrainer(n_epoch=1, save_path=tmp_path, augment_p=0.5, device="cpu")
    batches = _loader(2, 0)
    trainer.train(Diffuser(model, "heun", model_type="edm", n_steps=2), toptim.adamw(lr=1e-3), batches, seed=0)
    assert trainer.step == 2
    labels = torch.cat([s["batch"]["augment_labels"] for s in seen])
    assert labels.shape == (8, 6) and bool((labels[:, 5] > 0).any())
    for s, b in zip(seen, batches):  # the model sees the transform the labels encode
        from diffulab_tpu_torch.diffuse.augment import AugmentPipe

        expected = AugmentPipe.apply(torch.from_numpy(b["model_inputs"]["x"]), s["batch"]["augment_labels"])
        torch.testing.assert_close(s["batch"]["x"], expected, rtol=0, atol=0)
    with pytest.raises(ValueError, match="reflow"):
        trainer.train(Diffuser(model, "euler", n_steps=2), toptim.adamw(), _loader(1, 1, coupled=True))
    with pytest.raises(ValueError, match="augment_dim"):
        BaseTrainer(n_epoch=1, save_path=tmp_path, augment_p=0.5, device="cpu").train(
            Diffuser(MMDiT(**TINY, device="cpu"), "euler", n_steps=2), toptim.adamw(), _loader(1, 0))


def test_trainer_distils_a_frozen_teacher(pairs, tmp_path, monkeypatch):
    seen = _recording(monkeypatch)
    (_, teacher), _ = pairs
    torch.manual_seed(1)
    model = MMDiT(**TINY, device="cpu")
    before = {n: p.detach().clone() for n, p in teacher.named_parameters()}
    trainer = BaseTrainer(n_epoch=1, save_path=tmp_path, project_name="run", distill_guidance=1.5, device="cpu",
                          async_checkpointing=False)
    trainer.train(Diffuser(model, "euler", n_steps=2), toptim.adamw(lr=1e-3), _loader(2, 2), _loader(1, 3),
                  p_classifier_free_guidance=0.5, log_validation_images=False, distill_teacher=teacher, seed=0)
    assert trainer.step == 2 and all(s["drop"] is None for s in seen)  # p_cfg forced to 0
    assert all(s["distill"]["distill_guidance"] == 1.5 for s in seen)
    assert all(torch.equal(p, before[n]) for n, p in teacher.named_parameters())
    saved = torch.load(tmp_path / "run" / "checkpoints" / "denoiser" / "state.pt")
    assert set(saved["params"]) == {n for n, _ in model.named_parameters()}  # the teacher is not saved
    with pytest.raises(ValueError, match="distill_guidance"):
        BaseTrainer(n_epoch=1, save_path=tmp_path, device="cpu").train(
            Diffuser(model, "euler", n_steps=2), toptim.adamw(), _loader(1, 0), distill_teacher=teacher)


def test_trainer_takes_the_coupled_noise_of_reflow_batches(tmp_path, monkeypatch):
    seen = _recording(monkeypatch)
    torch.manual_seed(2)
    model = MMDiT(**TINY, device="cpu")
    trainer = BaseTrainer(n_epoch=1, save_path=tmp_path, device="cpu")
    batches = _loader(2, 4, coupled=True)
    trainer.train(Diffuser(model, "euler", n_steps=2), toptim.adamw(lr=1e-3), batches, _loader(1, 5, coupled=True),
                  log_validation_images=False, seed=0)
    assert trainer.step == 2 and all(s["noise"] is None for s in seen)
    for s, b in zip(seen, batches):
        np.testing.assert_array_equal(s["batch"]["coupled_noise"].numpy(), b["model_inputs"]["coupled_noise"])


def test_generate_pairs_draws_like_the_reference(pairs):
    """z and the labels come from numpy with the reference's seed rule; x is
    the port's generate from that z."""
    from diffulab_tpu.data.reflow import generate_pairs as jax_generate_pairs

    (jax_model, model), _ = pairs
    ref = jax_generate_pairs(JaxDiffuser(jax_model, "euler", n_steps=2), 5, LATENT, n_classes=10, batch_size=3,
                             guidance_scale=1.5, seed=7)
    ours = generate_pairs(Diffuser(model, "euler", n_steps=2), 5, LATENT, n_classes=10, batch_size=3,
                          guidance_scale=1.5, seed=7, device="cpu")
    np.testing.assert_array_equal(ours.noise, ref.noise)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    assert len(ours) == 5 and rel_err(ours.x, ref.x) < 1e-5 and np.abs(ours.x).max() <= 1.0
