"""The port's training side (diffulab_tpu_torch) against the JAX package.

Every parity test injects the same numpy t, noise, drop mask and x0 into both
sides (trap T4) and randomises every JAX parameter before bridging (T9).
The JAX model runs ``_xla_path`` attention on the CPU and the port its plain
versions of K1/K2; the model has no key mask, so T1 does not bite.

Tolerances, as max |port - JAX| over max |JAX| unless stated: the loss 1e-5
in fp32 and 2e-2 under the bf16 whole-model cast (the forward's bf16
rounding, tests/test_torch_port_dit.py; measured 0 and 2.3e-3); parameter
gradients per tensor 1e-4 in fp32 (summation order over a batch and 16
tokens; measured 1.7e-6) and 6e-2 in bf16 (the forward's difference carried
back through bf16 products; measured 4.0e-2, on the norm scales, whose
gradients sum over every token); parameters and
EMA after AdamW updates at lr 1e-3 within 2e-5 absolute, 2% of lr (Adam's
first update is lr·g/(|g| + eps): where |g| is near eps = 1e-8 the fp32
gradients' summation-order difference moves it by up to a few percent of lr;
measured 7e-6 on 2 of 32768 elements, all others within 1e-6).
"""

import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_port_common import LATENT, POLICIES, TINY, port_model, randomized_jax_model, rel_err
from flax import nnx

from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.training import ema as jema
from diffulab_tpu.training import optim as joptim
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.diffuse.schedules import shift_timestep
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.networks.nn import make_drop_mask
from diffulab_tpu_torch.training import ema as tema
from diffulab_tpu_torch.training import optim as toptim
from diffulab_tpu_torch.training.lora import apply_lora, is_lora_param
from diffulab_tpu_torch.training.checkpoint import (
    AsyncCheckpointer,
    restore_checkpoint,
    save_checkpoint,
    split_state,
)
from diffulab_tpu_torch.training.trainer import (
    EMA,
    BaseTrainer,
    MultiStepOptimizer,
    Trainer,
    train_step,
)
from diffulab_tpu_torch.weights import state_dict_from_jax

LOSS_TOL = {"fp32": 1e-5, "bf16_full": 2e-2}
GRAD_TOL = {"fp32": 1e-4, "bf16_full": 6e-2}
BATCH = 4
#: parameters and EMA after AdamW updates (see above)
UPDATE_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _draws(seed, x_prediction=False):
    """x0, labels, t, noise and drop from numpy (T4)."""
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((BATCH, *LATENT)).astype(np.float32)
    y = rng.integers(0, TINY["n_classes"], BATCH)
    t = rng.uniform(0.05 if x_prediction else 0.0, 1.0, BATCH).astype(np.float32)
    noise = rng.standard_normal((BATCH, *LATENT)).astype(np.float32)
    drop = np.array([False, True, False, False])
    return x0, y, t, noise, drop


def _jax_loss_fn(jax_model, prediction_type, x0, y, t, noise, drop, dtype):
    """The JAX loss as a function of the model's parameters (trainer.py:322-367)."""
    diffuser = JaxDiffuser(jax_model, "euler", n_steps=4, extra_args={"prediction_type": prediction_type})
    graphdef, params, rest = nnx.split(jax_model, nnx.Param, ...)

    def loss_fn(params):
        model = nnx.merge(graphdef, params, rest)
        return diffuser.diffusion.compute_loss(
            lambda **kw: model(**kw, train=True), jnp.asarray(x0, dtype), {"y": jnp.asarray(y)},
            jnp.asarray(t), jnp.asarray(noise, dtype), drop=jnp.asarray(drop),
        )["loss"]

    return loss_fn, params


def _flat(tree) -> dict[str, np.ndarray]:
    return {"/".join(str(p) for p in path): np.asarray(v.get_value(), np.float32)
            for path, v in tree.flat_state()}


def _port_loss(model, prediction_type, x0, y, t, noise, drop, dtype):
    diffuser = Diffuser(model, "euler", n_steps=4, extra_args={"prediction_type": prediction_type})
    return diffuser.compute_loss(
        torch.from_numpy(x0).to(dtype), {"y": torch.from_numpy(y)}, torch.from_numpy(t),
        noise=torch.from_numpy(noise).to(dtype), drop=torch.from_numpy(drop),
    )["loss"]


# --- the loss and the draws -------------------------------------------------


@pytest.mark.parametrize("prediction_type", ["v", "x"])
@pytest.mark.parametrize("policy", ["fp32", "bf16_full"])
def test_compute_loss_matches_jax(policy, prediction_type):
    """With bf16 x0 and noise (the whole-model cast, as the trainer draws the
    noise in x0's dtype) add_noise and (noise - x0) round in bf16 on both
    sides (T10)."""
    jax_model, params = randomized_jax_model(policy)
    model = port_model(policy, params)
    jdt = POLICIES[policy][0].get("dtype", jnp.float32)
    tdt = POLICIES[policy][1].get("dtype", torch.float32)
    draws = _draws(1, x_prediction=prediction_type == "x")
    loss_fn, jparams = _jax_loss_fn(jax_model, prediction_type, *draws, jdt)
    ref = float(loss_fn(jparams))
    with torch.no_grad():
        ours = _port_loss(model, prediction_type, *draws, tdt)
    assert ours.dtype == torch.float32 and ours.shape == ()
    assert abs(float(ours) - ref) / abs(ref) < LOSS_TOL[policy]


def test_add_noise_rounds_in_x0_dtype_like_jax():
    from diffulab_tpu.diffuse.flow import Flow as JaxFlow
    from diffulab_tpu_torch.diffuse.flow import Flow

    x0, _, t, noise, _ = _draws(2)
    ours, _ = Flow().add_noise(torch.from_numpy(x0).bfloat16(), torch.from_numpy(t),
                               torch.from_numpy(noise).bfloat16())
    ref, _ = JaxFlow().add_noise(jnp.asarray(x0, jnp.bfloat16), jnp.asarray(t), jnp.asarray(noise, jnp.bfloat16))
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("kind", ["logit_normal", "uniform", "shift", "x_prediction_clip"])
def test_draw_timesteps_distribution(kind):
    from diffulab_tpu_torch.diffuse.flow import Flow

    n = 200_000
    kw = {"logit_normal": dict(logits_normal=True), "uniform": dict(),
          "shift": dict(shift=3.0), "x_prediction_clip": dict(prediction_type="x")}[kind]
    gen = torch.Generator().manual_seed(0)
    t = Flow(**kw).draw_timesteps(gen, n)
    assert t.shape == (n,) and t.dtype == torch.float32
    assert float(t.min()) >= 0.0 and float(t.max()) <= 1.0
    if kind == "logit_normal":
        z = torch.logit(t.double())
        assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01
    elif kind == "uniform":
        assert abs(float(t.mean()) - 0.5) < 0.005 and abs(float(t.std()) - 12 ** -0.5) < 0.005
    elif kind == "shift":
        # the same uniform draws, shifted: alpha t / (1 + (alpha - 1) t)
        u = torch.rand(n, generator=torch.Generator().manual_seed(0))
        torch.testing.assert_close(t, shift_timestep(u, 3.0), rtol=0, atol=0)
        assert abs(float(t.mean()) - (1.5 - 0.75 * math.log(3))) < 0.005  # E[3u / (1 + 2u)]
    else:
        assert float(t.min()) == float(np.float32(0.05))
        assert abs(float((t == 0.05).double().mean()) - 0.05) < 0.003


def test_make_drop_mask_rate():
    gen = torch.Generator().manual_seed(1)
    drop = make_drop_mask(gen, 0.1, 200_000)
    assert drop.dtype == torch.bool and drop.shape == (200_000,)
    assert abs(float(drop.double().mean()) - 0.1) < 0.003
    assert not make_drop_mask(gen, 0.0, 1000).any()


# --- gradients, one update, accumulation --------------------------------------


@pytest.mark.parametrize("policy", ["fp32", "bf16_full"])
def test_model_gradients_match_jax(policy):
    jax_model, params = randomized_jax_model(policy, seed=3)
    model = port_model(policy, params)
    jdt = POLICIES[policy][0].get("dtype", jnp.float32)
    tdt = POLICIES[policy][1].get("dtype", torch.float32)
    draws = _draws(4)
    loss_fn, jparams = _jax_loss_fn(jax_model, "v", *draws, jdt)
    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(jparams)
    ref = state_dict_from_jax(_flat(ref_grads))
    loss = _port_loss(model, "v", *draws, tdt)
    loss.backward()
    assert abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)) < LOSS_TOL[policy]
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(grads) == set(ref) and all(g is not None for g in grads.values())
    for name, g in grads.items():
        r = ref[name].numpy()
        if not np.any(r):  # e.g. the embedding rows of labels the batch does not use
            np.testing.assert_array_equal(g.numpy(), 0.0, err_msg=name)
            continue
        assert rel_err(g.numpy(), r) < GRAD_TOL[policy], name


def _jax_step(jax_model, optimizer, draws_list, ema_config, step0):
    """The JAX train step composed as trainer.py:371-386, over micro-batches."""
    grads_fns = [jax.value_and_grad(_jax_loss_fn(jax_model, "v", *d, jnp.float32)[0]) for d in draws_list]
    _, params, _ = nnx.split(jax_model, nnx.Param, ...)
    opt_state = optimizer.init(params)
    ema = jax.tree.map(jnp.copy, params)
    for i, grads_fn in enumerate(grads_fns):
        _, grads = grads_fn(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jema.ema_update(ema_config, ema, params, step0 + i)
    return state_dict_from_jax(_flat(params)), state_dict_from_jax(_flat(ema))


def _port_step(model, factory, draws_list, ema_config, step0, every_k):
    diffuser = Diffuser(model, "euler", n_steps=4)
    opt = MultiStepOptimizer(factory(list(model.parameters())), every_k, factory.grad_clip_norm)
    ema = EMA(ema_config, tema.init_ema(dict(model.named_parameters())))
    for i, (x0, y, t, noise, drop) in enumerate(draws_list):
        batch = {"model_inputs": {"x": torch.from_numpy(x0), "y": torch.from_numpy(y)}}
        losses = train_step(diffuser, opt, ema, batch, torch.from_numpy(t), torch.from_numpy(noise),
                            torch.from_numpy(drop), step0 + i)
        assert set(losses) == {"loss"} and not losses["loss"].requires_grad
    return {n: p.detach() for n, p in model.named_parameters()}, ema.params


@pytest.mark.parametrize("clip", [None, 0.05])
def test_one_train_step_matches_jax(clip):
    """Loss, gradients, one AdamW update with the weight decay passed
    explicitly (T7), optax's clipping rule when set (T11: 0.05 is below the
    gradient norm, so it scales), and one EMA update on the ramp."""
    jax_model, params = randomized_jax_model("fp32", seed=5)
    model = port_model("fp32", params)
    draws = [_draws(6)]
    kw = dict(lr=1e-3, weight_decay=1e-4, grad_clip_norm=clip)
    ema_config = dict(beta=0.999, update_after_step=0, update_every=1)
    ref_params, ref_ema = _jax_step(jax_model, joptim.adamw(**kw), draws, jema.EMAConfig(**ema_config), 5)
    ours, ours_ema = _port_step(model, toptim.adamw(**kw), draws, tema.EMAConfig(**ema_config), 5, 1)
    for name, p in ours.items():
        np.testing.assert_allclose(p.numpy(), ref_params[name].numpy(), atol=UPDATE_ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(ours_ema[name].numpy(), ref_ema[name].numpy(), atol=UPDATE_ATOL, rtol=0,
                                   err_msg=name)


def test_accumulation_matches_optax_multisteps():
    """k=2 micro-batches: the mean gradient, one update at the second, Adam's
    count at 1; EMA on every micro-step with the k-scaled cadence (T12)."""
    jax_model, params = randomized_jax_model("fp32", seed=7)
    model = port_model("fp32", params)
    draws = [_draws(8), _draws(9)]
    k = 2
    ema_config = dict(beta=0.999, update_after_step=1 * k, update_every=1 * k)
    jopt = optax.MultiSteps(joptim.adamw(lr=1e-3, weight_decay=1e-4, grad_clip_norm=0.05), every_k_schedule=k)
    ref_params, ref_ema = _jax_step(jax_model, jopt, draws, jema.EMAConfig(**ema_config), 3)
    ours, ours_ema = _port_step(model, toptim.adamw(lr=1e-3, weight_decay=1e-4, grad_clip_norm=0.05), draws,
                                tema.EMAConfig(**ema_config), 3, k)
    moved = 0
    for name, p in ours.items():
        np.testing.assert_allclose(p.numpy(), ref_params[name].numpy(), atol=UPDATE_ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(ours_ema[name].numpy(), ref_ema[name].numpy(), atol=UPDATE_ATOL, rtol=0,
                                   err_msg=name)
        moved += int(not np.array_equal(p.numpy(), state_dict_from_jax(params)[name].numpy()))
    assert moved > 0


def test_micro_steps_before_the_kth_do_not_update():
    model = MMDiT(**TINY, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = MultiStepOptimizer(toptim.adamw(lr=1e-2)(list(model.parameters())), every_k=3)
    x0, y, t, noise, drop = _draws(10)
    batch = {"model_inputs": {"x": torch.from_numpy(x0), "y": torch.from_numpy(y)}}
    for i in range(2):
        train_step(Diffuser(model, "euler", n_steps=4), opt, None, batch, torch.from_numpy(t),
                   torch.from_numpy(noise), torch.from_numpy(drop), i + 1)
        assert opt.mini_step == i + 1
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), before[n], rtol=0, atol=0)
    assert all(p.grad is not None for p in model.parameters())


def test_optimizer_state_resumes_mid_accumulation(tmp_path):
    """A checkpoint taken between updates carries the accumulated gradient and
    the micro-step, as optax's MultiSteps state does."""
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    opt = MultiStepOptimizer(toptim.adamw(lr=1e-2)([p]), every_k=2)
    p.grad = torch.tensor([0.5, 0.25])
    assert not opt.step()
    save_checkpoint(tmp_path / "optimizer", {"opt_state": opt.state_dict()})
    state = restore_checkpoint(tmp_path / "optimizer")["opt_state"]
    q = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    resumed = MultiStepOptimizer(toptim.adamw(lr=1e-2)([q]), every_k=2)
    resumed.load_state_dict(state)
    assert resumed.mini_step == 1
    torch.testing.assert_close(q.grad, torch.tensor([0.5, 0.25]), rtol=0, atol=0)
    for param, o in ((p, opt), (q, resumed)):
        param.grad += torch.tensor([0.1, 0.2])
        assert o.step()
    torch.testing.assert_close(q.detach(), p.detach(), rtol=0, atol=0)


def test_clip_by_global_norm_is_optax_rule():
    rng = np.random.default_rng(11)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    for max_norm in (0.5, 100.0):
        ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(a) for a in arrays], None)
        grads = [torch.from_numpy(a.copy()) for a in arrays]
        norm = toptim.clip_by_global_norm(grads, max_norm)
        np.testing.assert_allclose(float(norm), np.sqrt(sum((a ** 2).sum() for a in arrays)), rtol=1e-6)
        for g, r in zip(grads, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["adam", "sgd_nesterov"])
def test_other_optimizers_match_optax_over_three_steps(name):
    rng = np.random.default_rng(12)
    p0 = rng.standard_normal(6).astype(np.float32)
    grads = [rng.standard_normal(6).astype(np.float32) for _ in range(3)]
    if name == "adam":
        kw = dict(lr=1e-2, betas=(0.8, 0.99), eps=1e-6)
        jtx, factory = joptim.adam(**kw), toptim.adam(**kw)
    else:
        kw = dict(lr=1e-2, momentum=0.9, weight_decay=1e-3, nesterov=True)
        jtx, factory = joptim.sgd(**kw), toptim.sgd(**kw)
    jp, state = jnp.asarray(p0), None
    state = jtx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = factory([tp])
    for g in grads:
        updates, state = jtx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


# --- EMA ------------------------------------------------------------------------


def test_ema_decay_matches_jax_over_warmup_and_ramp():
    config = dict(beta=0.9999, update_after_step=10, update_every=3, inv_gamma=2.0, power=0.75)
    steps = list(range(0, 40)) + [100, 1000, 10**6]
    ours = [float(tema.ema_decay(tema.EMAConfig(**config), s)) for s in steps]
    ref = [float(jema.ema_decay(jema.EMAConfig(**config), jnp.asarray(s))) for s in steps]
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
    assert ours[0] == 0.0 and ours[-1] == pytest.approx(0.9999)


def test_ema_update_matches_jax_across_warmup_cadence_and_ramp():
    config = dict(beta=0.99, update_after_step=2, update_every=3)
    rng = np.random.default_rng(13)
    tree = {"a": rng.standard_normal((3, 2)).astype(np.float32), "b": rng.standard_normal(4).astype(np.float32)}
    ours = tema.init_ema({k: torch.from_numpy(v) for k, v in tree.items()})
    ref = {k: jnp.asarray(v) for k, v in tree.items()}
    for step in range(1, 12):
        params = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in tree.items()}
        tema.ema_update(tema.EMAConfig(**config), ours, {k: torch.from_numpy(v) for k, v in params.items()}, step)
        ref = jema.ema_update(jema.EMAConfig(**config), ref, {k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(step))
        for k in tree:
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {k}")


# --- checkpoints ------------------------------------------------------------------


def test_checkpoint_round_trip_and_async_writes(tmp_path):
    payload = {"params": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2, dtype=torch.bfloat16)},
               "step": 7, "nested": {"lr": [1e-3, 2e-3]}}
    save_checkpoint(tmp_path / "a", payload)
    back = restore_checkpoint(tmp_path / "a")
    assert back["step"] == 7 and back["nested"] == {"lr": [1e-3, 2e-3]}
    torch.testing.assert_close(back["params"]["w"], payload["params"]["w"], rtol=0, atol=0)
    target = {"params": {"w": torch.zeros(2, 3, dtype=torch.float64), "b": torch.zeros(2)}, "step": 0,
              "nested": {"lr": []}}
    cast = restore_checkpoint(tmp_path / "a", target)
    assert cast["params"]["w"].dtype == torch.float64 and cast["params"]["b"].dtype == torch.float32
    with pytest.raises(ValueError, match="keys differ"):
        restore_checkpoint(tmp_path / "a", {"params": {"w": target["params"]["w"]}, "step": 0, "nested": {}})
    live = torch.zeros(3)
    ckptr = AsyncCheckpointer()
    ckptr.save({tmp_path / "b": {"x": live}})
    live.add_(1.0)  # the snapshot was taken on the calling thread
    ckptr.wait()
    torch.testing.assert_close(restore_checkpoint(tmp_path / "b")["x"], torch.zeros(3), rtol=0, atol=0)


# --- the trainer end to end ---------------------------------------------------------


def _loader(n_batches, seed, batch=4):
    rng = np.random.default_rng(seed)
    return [{"model_inputs": {"x": rng.standard_normal((batch, *LATENT)).astype(np.float32),
                              "y": rng.integers(0, TINY["n_classes"], batch), "caption": ["unused"] * batch}}
            for _ in range(n_batches)]


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    # the tracker writes metrics.jsonl; where wandb is installed it is not imported
    monkeypatch.setitem(sys.modules, "wandb", None)


def _trainer(tmp_path, **kw):
    return BaseTrainer(n_epoch=kw.pop("n_epoch", 1), save_path=tmp_path, project_name="run", use_ema=True,
                       ema_update_after_step=0, ema_update_every=1, device="cpu", **kw)


def test_base_trainer_end_to_end_on_cpu(tmp_path):
    torch.manual_seed(0)
    model = MMDiT(**TINY, device="cpu")
    diffuser = Diffuser(model, "euler", n_steps=4)
    trainer = _trainer(tmp_path, save_every_n_epochs=1)
    trainer.train(diffuser, toptim.adamw(lr=1e-3, weight_decay=1e-4), _loader(3, 0), _loader(1, 1),
                  p_classifier_free_guidance=0.1, val_steps=2, seed=0)
    assert trainer.step == 3
    run = tmp_path / "run"
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    train_loss = [r["train/loss"] for r in rows if "train/loss" in r]
    val_loss = [r["val/loss"] for r in rows if "val/loss" in r]
    assert len(train_loss) == 1 and len(val_loss) == 1
    assert np.isfinite(train_loss[0]) and np.isfinite(val_loss[0])
    assert any((run / "images").glob("*.png"))
    # the best-val set, and it restores to the trained tensors (the trainable
    # parameters and the rest of the state, as the reference's layout)
    for part in ("denoiser", "optimizer", "ema", "scheduler"):
        assert (run / "checkpoints" / part / "state.pt").is_file(), part
    params, rest = split_state(model, lambda name: True)
    restored = restore_checkpoint(run / "checkpoints" / "denoiser", {"params": params, "rest": rest})
    restored = {**restored["params"], **restored["rest"]}
    assert set(restored) == set(model.state_dict())
    for name, tensor in model.state_dict().items():
        torch.testing.assert_close(restored[name], tensor, rtol=0, atol=0)
    assert restore_checkpoint(run / "checkpoints" / "scheduler")["step"] == 3
    ema = restore_checkpoint(run / "checkpoints" / "ema")["params"]
    assert set(ema) == set(dict(model.named_parameters()))

    # auto_resume picks up the periodic set at epoch 1 and continues the step counter
    assert (run / "checkpoints_latest" / "ep000001" / "scheduler" / "state.pt").is_file()
    resumed_model = MMDiT(**TINY, device="cpu")
    resumed = _trainer(tmp_path, n_epoch=2, save_every_n_epochs=1)
    resumed.train(Diffuser(resumed_model, "euler", n_steps=4), toptim.adamw(lr=1e-3, weight_decay=1e-4),
                  _loader(3, 0), None, p_classifier_free_guidance=0.1, seed=0, auto_resume=True)
    assert resumed.step == 6
    assert sorted(p.name for p in (run / "checkpoints_latest").iterdir()) == ["ep000002"]


def test_trainer_with_accumulation_and_per_epoch_schedule(tmp_path):
    model = MMDiT(**TINY, device="cpu")
    trainer = _trainer(tmp_path, gradient_accumulation_step=2, async_checkpointing=False)
    assert trainer.ema_config.update_every == 2 and trainer.ema_config.update_after_step == 0
    seen = []

    def schedule(epoch_index):
        seen.append(epoch_index)
        return 0.5

    trainer.train(Diffuser(model, "euler", n_steps=4), toptim.adamw(lr=1e-3), _loader(4, 2), None,
                  scheduler=schedule, seed=1)
    # LambdaLR evaluates the multiplier of the next update eagerly: updates 0 and 1
    # (epoch index 0, as the reference's count // (4 // 2)), then the next one's
    assert trainer.step == 4 and seen == [0, 0, 1]


@pytest.mark.parametrize("kwargs", [dict(mesh={"fsdp": 2}), dict(mesh={"tensor": 4}, augment_p=0.1),
                                    dict(mesh={"data": 2}), dict(mesh={"data": -1, "tensor": 2})])
def test_unported_trainer_options_raise(tmp_path, kwargs):
    """Meshes of more than one device (ROADMAP item 17) raise; augmentation
    is ported (tests/test_torch_port_guided.py) and builds on its own."""
    with pytest.raises(NotImplementedError, match="item 17"):
        BaseTrainer(n_epoch=1, save_path=tmp_path, device="cpu", **kwargs)
    if "augment_p" in kwargs:
        assert BaseTrainer(n_epoch=1, save_path=tmp_path, device="cpu", augment_p=0.1).augment_p == 0.1


@pytest.mark.parametrize("kwargs", [dict(lora_only=True), dict(train_embedder=True),
                                    dict(distill_teacher=object())])
def test_unported_train_options_raise(tmp_path, kwargs):
    """LoRA is ported (tests/test_torch_port_lora.py): ``lora_only`` on a
    model without adapters is refused, and on a wrapped one trains the
    adapters alone. Trainable embedders are ported
    (tests/test_torch_port_trainable_embedder.py): ``train_embedder`` on a
    model without a context embedder trains as without it. Guidance
    distillation is ported (tests/test_torch_port_guided.py); a teacher
    without ``distill_guidance > 0`` is refused, as the reference asserts."""
    trainer = BaseTrainer(n_epoch=1, save_path=tmp_path, device="cpu")
    if "lora_only" in kwargs:
        with pytest.raises(ValueError, match="apply_lora"):
            trainer.train(Diffuser(MMDiT(**TINY, device="cpu"), "euler", n_steps=4), toptim.adamw(), _loader(1, 0),
                          **kwargs)
        model = MMDiT(**TINY, device="cpu")
        apply_lora(model, 2)
        base = {n: p.detach().clone() for n, p in model.named_parameters() if not is_lora_param(n)}
        trainer.train(Diffuser(model, "euler", n_steps=4), toptim.adamw(lr=1e-2), _loader(1, 0),
                      log_validation_images=False, **kwargs)
        assert trainer.step == 1 and all(torch.equal(p, base[n]) for n, p in model.named_parameters() if n in base)
        return
    if "train_embedder" in kwargs:
        trainer.train(Diffuser(MMDiT(**TINY, device="cpu"), "euler", n_steps=4), toptim.adamw(), _loader(1, 0),
                      log_validation_images=False, **kwargs)
        assert trainer.step == 1
        return
    with pytest.raises(ValueError):
        trainer.train(Diffuser(MMDiT(**TINY, device="cpu"), "euler", n_steps=4), toptim.adamw(),
                      _loader(1, 0), **kwargs)


@pytest.mark.parametrize("key", ["coupled_noise", "initial_context"])
def test_unported_batches_raise(tmp_path, key):
    """Reflow batches train (their coupled noise is the step's noise,
    tests/test_torch_port_guided.py) and raise under augmentation, whose
    transform would break the coupling; a text batch (captions and a
    precomputed context, as ImageNetmultiAR + collate_fn give it) trains
    since the txt2img slice: the captions are dropped from what the model sees."""
    trainer = BaseTrainer(n_epoch=1, save_path=tmp_path, device="cpu")
    if key == "coupled_noise":
        batches = _loader(1, 0)
        batches[0]["model_inputs"][key] = np.zeros((4, *LATENT), np.float32)
        trainer.train(Diffuser(MMDiT(**TINY, device="cpu"), "euler", n_steps=4), toptim.adamw(), batches)
        assert trainer.step == 1
        augmenting = BaseTrainer(n_epoch=1, save_path=tmp_path, device="cpu", augment_p=0.5)
        with pytest.raises(ValueError, match="reflow"):
            augmenting.train(Diffuser(MMDiT(**TINY, augment_dim=6, device="cpu"), "euler", n_steps=4),
                             toptim.adamw(), batches)
        return
    from _torch_port_common import CONTEXT, TINY_MM, context_inputs, null_embedding

    from diffulab_tpu_torch.networks.embedders import PrecomputedEmbedder

    emb, mask = context_inputs(2)
    batch = {"model_inputs": {"x": np.random.default_rng(3).standard_normal((2, 4, 4, 4)).astype(np.float32),
                              "context": {"embeddings": emb, "attn_mask": mask},
                              key: ["a caption", "another"]}}
    model = MMDiT(**TINY_MM, context_embedder=PrecomputedEmbedder(null_embedding=null_embedding(),
                                                                  null_embedding_seq_len=1, device="cpu"),
                  device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer.train(Diffuser(model, "euler", n_steps=4), toptim.adamw(lr=1e-3, weight_decay=1e-2), [batch], seed=0)
    assert trainer.step == 1 and emb.shape[1:] == CONTEXT
    assert any(not torch.equal(p.detach(), before[n]) for n, p in model.named_parameters())


def test_unported_loss_paths_raise():
    """The GRPO loss is ported (tests/test_torch_port_grpo.py): it refuses a
    sampler other than Euler-Maruyama, whose log-probs it needs; extra losses
    (item 13) are ported: each joins the loss dict under its name, called on
    the model's output with x0 (REPA itself: tests/test_torch_port_repa.py)."""
    diffuser = Diffuser(MMDiT(**TINY, device="cpu"), "euler", n_steps=4, extra_losses=[])
    assert diffuser.extra_losses == []
    x0, t = torch.zeros(1, *LATENT), torch.full((1,), 0.5)
    with pytest.raises(ValueError, match="Euler-Maruyama"):  # an Euler trajectory has no log-probs
        diffuser.compute_loss(x0, {}, t, x0, grpo=True, grpo_args=dict(sampling={}, advantages=t, indices=[0, 1]))

    class Probe:
        name = "probe"

        def __call__(self, model_output, x0, **_):
            return model_output["x"].float().mean() + x0.sum()

    with_extra = Diffuser(diffuser.denoiser, "euler", extra_losses=[Probe()])
    y = torch.zeros(1, dtype=torch.long)
    losses = with_extra.compute_loss(x0, {"y": y}, t, x0)
    assert set(losses) == {"loss", "probe"} and torch.isfinite(losses["probe"])


def test_trainer_needs_a_device_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (Trainer, BaseTrainer):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(n_epoch=1, save_path=tmp_path)
    assert not (tmp_path / "my_project").exists()  # nothing written before the refusal


def test_train_refuses_a_model_off_the_trainer_device(tmp_path):
    trainer = BaseTrainer(n_epoch=1, save_path=tmp_path, device="meta")
    with pytest.raises(ValueError, match="trainer runs on meta"):
        trainer.train(Diffuser(MMDiT(**TINY, device="cpu"), "euler", n_steps=4), toptim.adamw(), _loader(1, 0))
