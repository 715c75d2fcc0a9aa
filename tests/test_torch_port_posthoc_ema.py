"""The port's post-hoc EMA (diffulab_tpu_torch.training.posthoc_ema and the
trainer's ``posthoc_ema=True``) against the JAX package.

Tolerances:
- ``power_ema_update`` over 5 steps: rtol 1e-6 (the same fp32 beta and
  lerp; XLA may contract the lerp's multiply-add into one FMA, the port
  rounds the product first: a few fp32 ulps over 5 steps);
- ``sigma_rel_to_gamma``, ``gamma_to_sigma_rel``, ``_profile_dot`` and
  ``solve_weights``: 1e-12 (the same fp64 numpy code);
- ``combine_snapshots``: bitwise (the same fp64 sums, rounded once to fp32);
- the trainer's tracks over 3 injected steps against JAX's
  ``power_ema_update`` applied to the same parameter sequence: rtol 1e-5
  (the trainer's foreach update against the jitted lerp, plus the
  parameters' own rounding carried through 3 steps);
- the fp16 snapshots: exactly the tracks cast to fp16.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import LATENT, TINY

from diffulab_tpu.training import posthoc_ema as jphema
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.training import optim as toptim
from diffulab_tpu_torch.training import posthoc_ema as phema
from diffulab_tpu_torch.training import trainer as trainer_mod
from diffulab_tpu_torch.training.checkpoint import (
    restore_checkpoint,
    restore_sampling_model,
    restore_train_modules,
    save_checkpoint,
    split_state,
    trainable_filter,
)
from diffulab_tpu_torch.training.trainer import BaseTrainer, PowerEMA

GAMMAS = (6.94, 16.97)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)


def _loader(n_batches, seed, batch=4):
    rng = np.random.default_rng(seed)
    return [{"model_inputs": {"x": rng.standard_normal((batch, *LATENT)).astype(np.float32),
                              "y": rng.integers(0, TINY["n_classes"], batch)}}
            for _ in range(n_batches)]


# --- the math ---------------------------------------------------------------------

@pytest.mark.parametrize("gamma", GAMMAS + (0.5,))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_power_ema_update_equals_jax_over_five_steps(gamma, dtype):
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b.weight": (7,)}
    seq = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()} for _ in range(5)]
    tdtype = getattr(torch, dtype)
    ours = phema.init_tracks({k: torch.from_numpy(v).to(tdtype) for k, v in seq[0].items()})
    ref = {k: jnp.asarray(v, getattr(jnp, dtype)).astype(jnp.float32) for k, v in seq[0].items()}
    assert all(t.dtype == torch.float32 for t in ours.values())
    for step, params in enumerate(seq, start=1):
        phema.power_ema_update(ours, {k: torch.from_numpy(v).to(tdtype) for k, v in params.items()}, step, gamma)
        ref = jphema.power_ema_update(ref, {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in params.items()},
                                      jnp.asarray(step), gamma)
        for k in shapes:
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-7)
    # step 1 copies the parameters (beta_1 = 0)
    assert phema.power_ema_beta(1, gamma) == 0.0


@pytest.mark.parametrize("step", [1, 2, 10, 1000])
def test_power_ema_beta_equals_jax(step):
    for gamma in GAMMAS:
        t = jnp.maximum(jnp.asarray(step), 1).astype(jnp.float32)
        ref = (1.0 - 1.0 / t) ** (gamma + 1.0)
        np.testing.assert_allclose(phema.power_ema_beta(step, gamma), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("sigma_rel", [0.02, 0.05, 0.10, 0.15, 0.25])
def test_sigma_rel_and_gamma_equal_jax(sigma_rel):
    gamma = phema.sigma_rel_to_gamma(sigma_rel)
    np.testing.assert_allclose(gamma, jphema.sigma_rel_to_gamma(sigma_rel), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(phema.gamma_to_sigma_rel(gamma), sigma_rel, rtol=1e-12)
    np.testing.assert_allclose(phema.gamma_to_sigma_rel(gamma), jphema.gamma_to_sigma_rel(gamma), rtol=1e-12)


def test_default_gammas_are_the_sigma_rel_anchors():
    assert phema.DEFAULT_GAMMAS == jphema.DEFAULT_GAMMAS == GAMMAS
    np.testing.assert_allclose([phema.gamma_to_sigma_rel(g) for g in GAMMAS], [0.10, 0.05], atol=5e-4)
    with pytest.raises(ValueError):
        phema.sigma_rel_to_gamma(0.5)


@pytest.mark.parametrize("case", [
    ([100, 200, 300, 100, 200, 300], [6.94, 6.94, 6.94, 16.97, 16.97, 16.97], 300, 0.05),
    ([16, 16, 32, 32], [6.94, 16.97, 6.94, 16.97], 32, 0.10),
    ([5, 10, 15, 20], [6.94, 6.94, 16.97, 16.97], 25, 0.15),
])
def test_solve_weights_equals_jax(case):
    ts, gs, t_out, sigma_rel = case
    gamma = phema.sigma_rel_to_gamma(sigma_rel)
    ours = phema.solve_weights(ts, gs, t_out, gamma)
    np.testing.assert_allclose(ours, jphema.solve_weights(ts, gs, t_out, gamma), rtol=1e-12, atol=1e-12)
    a = np.asarray(ts, np.float64)
    np.testing.assert_allclose(phema._profile_dot(a[:, None], np.asarray(gs)[:, None], a[None, :],
                                                  np.asarray(gs)[None, :]),
                               jphema._profile_dot(a[:, None], np.asarray(gs)[:, None], a[None, :],
                                                   np.asarray(gs)[None, :]), rtol=1e-12, atol=1e-12)


def test_combine_snapshots_equals_jax_bitwise():
    rng = np.random.default_rng(1)
    trees = [{"w": rng.standard_normal((4, 3)).astype(np.float16), "b": rng.standard_normal(3).astype(np.float16)}
             for _ in range(4)]
    weights = np.array([1.7, -0.9, 0.25, -0.05])
    ours = phema.combine_snapshots([{k: torch.from_numpy(v) for k, v in t.items()} for t in trees], weights)
    ref = jphema.combine_snapshots(trees, weights)
    for k in ref:
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), ref[k])


# --- the snapshot store -----------------------------------------------------------------

def test_snapshot_dirs_are_named_as_the_jax_ones(tmp_path):
    for step, gamma in ((16, 6.94), (32, 16.97), (7, 1.23456789012)):
        assert phema.snapshot_dir(tmp_path, step, gamma) == jphema.snapshot_dir(tmp_path, step, gamma)


def test_list_snapshots_skips_incomplete_and_foreign_entries(tmp_path):
    for step, gamma in ((32, 6.94), (16, 16.97), (16, 6.94)):
        save_checkpoint(phema.snapshot_dir(tmp_path, step, gamma), {"params": {"w": torch.zeros(2)}})
    (tmp_path / "step00000048_g6.94").mkdir()  # a save cut off before its state.pt landed
    (tmp_path / "step00000048_gX").mkdir()
    (tmp_path / "notes.txt").write_text("x")
    got = [(s, g, p.name) for s, g, p in phema.list_snapshots(tmp_path)]
    assert got == [(16, 6.94, "step00000016_g6.94"), (16, 16.97, "step00000016_g16.97"),
                   (32, 6.94, "step00000032_g6.94")]


def test_reconstruct_from_dir_equals_the_jax_math(tmp_path):
    rng = np.random.default_rng(2)
    stored = {}
    for step in (10, 20, 30):
        for gamma in GAMMAS:
            tree = {"w": rng.standard_normal((3, 2)).astype(np.float16)}
            stored[(step, gamma)] = tree
            save_checkpoint(phema.snapshot_dir(tmp_path, step, gamma),
                            {"params": {k: torch.from_numpy(v) for k, v in tree.items()}})
    result = phema.reconstruct_from_dir(tmp_path, 0.08)
    keys = sorted(stored)
    gamma_out = jphema.sigma_rel_to_gamma(0.08)
    weights = jphema.solve_weights([s for s, _ in keys], [g for _, g in keys], 30, gamma_out)
    np.testing.assert_allclose(result["weights"], weights, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(result["params"]["w"].numpy(),
                                  jphema.combine_snapshots([stored[k] for k in keys], weights)["w"])
    assert result["t_out"] == 30 and abs(result["weights"].sum() - 1) < 5e-2  # least squares, not a constrained fit
    thinned = phema.reconstruct_from_dir(tmp_path, 0.08, max_snapshots=4)
    assert len(thinned["weights"]) == 4
    phema.save_reconstruction(tmp_path / "phema_sr0.08", result["params"])
    assert torch.equal(restore_checkpoint(tmp_path / "phema_sr0.08")["params"]["w"], result["params"]["w"])


# --- the trainer ------------------------------------------------------------------------

def _recording_train_step(monkeypatch):
    """Record the trainable parameters and the tracks after every train step."""
    seen = []
    original = trainer_mod.train_step

    def wrapped(diffuser, optimizer, ema, batch, t, noise, drop, step, phema_state=None):
        out = original(diffuser, optimizer, ema, batch, t, noise, drop, step, phema_state)
        seen.append((step, {n: p.detach().clone() for n, p in diffuser.denoiser.named_parameters()},
                     tuple({k: v.clone() for k, v in tr.items()} for tr in phema_state.tracks)))
        return out

    monkeypatch.setattr(trainer_mod, "train_step", wrapped)
    return seen


@pytest.mark.parametrize("accumulation", [1, 3])
def test_trainer_tracks_equal_jax_power_ema_over_three_steps(tmp_path, monkeypatch, accumulation):
    seen = _recording_train_step(monkeypatch)
    torch.manual_seed(0)
    model = MMDiT(**TINY, device="cpu")
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = BaseTrainer(n_epoch=1, save_path=tmp_path, project_name="run", device="cpu", posthoc_ema=True,
                          gradient_accumulation_step=accumulation, async_checkpointing=False)
    trainer.train(Diffuser(model, "euler", n_steps=2), toptim.adamw(lr=1e-2), _loader(3, 0), None, seed=0)
    assert [s for s, _, _ in seen] == [1, 2, 3]
    ref = [{n: jnp.asarray(v.numpy()) for n, v in start.items()} for _ in GAMMAS]
    for step, params, tracks in seen:
        ref = [jphema.power_ema_update(r, {n: jnp.asarray(v.numpy()) for n, v in params.items()},
                                       jnp.asarray(step), g) for r, g in zip(ref, GAMMAS)]
        for ours, want in zip(tracks, ref):
            assert set(ours) == set(want)
            for name, value in ours.items():
                np.testing.assert_allclose(value.numpy(), np.asarray(want[name]), rtol=1e-5, atol=1e-6)
    # the parameters moved (accumulation: only at the 3rd micro-step), and the tracks followed
    moved = [any(not torch.equal(p, seen[i - 1][1][n]) for n, p in seen[i][1].items()) for i in (1, 2)]
    assert moved == ([True, True] if accumulation == 1 else [False, True])


def test_trainer_snapshots_every_epoch_in_fp16(tmp_path, monkeypatch):
    seen = _recording_train_step(monkeypatch)
    torch.manual_seed(0)
    model = MMDiT(**TINY, device="cpu")
    trainer = BaseTrainer(n_epoch=2, save_path=tmp_path, project_name="run", device="cpu", posthoc_ema=True,
                          posthoc_ema_gammas=[5.0, 12.5])
    trainer.train(Diffuser(model, "euler", n_steps=2), toptim.adamw(lr=1e-3), _loader(2, 0), None, seed=0)
    base = tmp_path / "run" / "checkpoints" / "phema"
    snaps = phema.list_snapshots(base)
    assert [(s, g) for s, g, _ in snaps] == [(2, 5.0), (2, 12.5), (4, 5.0), (4, 12.5)]
    trainable = {n for n, _ in model.named_parameters() if trainable_filter(model)(n)}
    by_step = {step: tracks for step, _, tracks in seen}
    for step, gamma, path in snaps:
        saved = restore_checkpoint(path)["params"]
        assert set(saved) == trainable and all(v.dtype == torch.float16 for v in saved.values())
        track = by_step[step][(5.0, 12.5).index(gamma)]
        for name, value in saved.items():
            assert torch.equal(value, track[name].half())


def test_init_phema_resumes_from_the_snapshot_at_or_before_the_resume_step(tmp_path):
    trainer = BaseTrainer(n_epoch=1, save_path=tmp_path, project_name="run", device="cpu", posthoc_ema=True)
    params = {"w": torch.full((2,), 9.0)}
    base = tmp_path / "phema"
    for step in (4, 8, 12):
        for gamma in GAMMAS:
            save_checkpoint(phema.snapshot_dir(base, step, gamma),
                            {"params": {"w": torch.full((2,), step + gamma).half()}})
    for resume_step, expected_step in ((8, 8), (10, 8), (0, None), (3, None)):
        state = trainer._init_phema(params, base, resume_step)
        assert isinstance(state, PowerEMA) and state.gammas == GAMMAS
        for gamma, track in zip(GAMMAS, state.tracks):
            want = params["w"] if expected_step is None else torch.full((2,), expected_step + gamma).half().float()
            assert track["w"].dtype == torch.float32 and torch.equal(track["w"], want)
            assert track["w"] is not params["w"]


def test_auto_resume_continues_the_tracks_from_the_latest_set(tmp_path, monkeypatch):
    torch.manual_seed(0)
    model = MMDiT(**TINY, device="cpu")
    kw = dict(save_path=tmp_path, project_name="run", device="cpu", posthoc_ema=True, save_every_n_epochs=1)
    BaseTrainer(n_epoch=1, **kw).train(Diffuser(model, "euler", n_steps=2), toptim.adamw(lr=1e-3),
                                       _loader(2, 0), None, seed=0)
    base = tmp_path / "run" / "checkpoints" / "phema"
    # a snapshot past the resume point (from a run cut later) is never used
    save_checkpoint(phema.snapshot_dir(base, 6, GAMMAS[0]),
                    {"params": {n: torch.zeros_like(p) for n, p in model.named_parameters()}})
    snap = restore_checkpoint(phema.snapshot_dir(base, 2, GAMMAS[0]))["params"]
    seen = _recording_train_step(monkeypatch)
    BaseTrainer(n_epoch=2, **kw).train(Diffuser(model, "euler", n_steps=2), toptim.adamw(lr=1e-3),
                                       _loader(2, 0), None, seed=0, auto_resume=True)
    step, params, tracks = seen[0]
    assert step == 3
    beta = float(phema.power_ema_beta(3, GAMMAS[0]))
    for name, value in tracks[0].items():
        want = snap[name].float() * beta + params[name] * float(np.float32(1) - np.float32(beta))
        torch.testing.assert_close(value, want, rtol=1e-6, atol=1e-7)


# --- checkpoint restores for the CLIs -------------------------------------------------------

def test_restore_train_modules_params_only_and_full(tmp_path):
    torch.manual_seed(0)
    src = MMDiT(**TINY, device="cpu")
    torch.manual_seed(1)
    dst = MMDiT(**TINY, device="cpu")
    params, rest = split_state(src, trainable_filter(src))
    save_checkpoint(tmp_path / "denoiser", {"params": params, "rest": rest})
    save_checkpoint(tmp_path / "phema_sr0.05", {"params": {k: v * 2 for k, v in params.items()}})
    restore_train_modules(tmp_path / "denoiser", dst)
    assert all(torch.equal(v, src.state_dict()[k]) for k, v in dst.state_dict().items())
    restore_sampling_model(tmp_path / "phema_sr0.05", dst, [], {"lora_rank": None})
    assert all(torch.equal(dst.state_dict()[k], v * 2) for k, v in params.items())
    with pytest.raises(ValueError):  # a params-only entry does not restore as a full one
        save_checkpoint(tmp_path / "best", {"params": params})
        restore_train_modules(tmp_path / "best", dst)
    with pytest.raises(NotImplementedError, match="item 16"):
        restore_sampling_model(tmp_path / "denoiser", dst, [], {"lora_rank": 4})
