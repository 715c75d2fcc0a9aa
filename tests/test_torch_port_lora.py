"""The port's LoRA and DoRA finetuning against the JAX package on the CPU:
the wrap is the identity at init, the adapter count is the reference's on
the DiT, the multimodal MMDiT and the UNet, the adapted forward with bridged
adapters (``lora_a``, ``lora_b``, ``magnitude``, and the base under
``base_module`` / ``base``) matches, ``merge_lora`` matches the adapted
forward, a ``lora_only`` AdamW step matches optax's on the adapters, and a
LoRA run's checkpoint restores through ``trainer.lora_from``.

The models are ``_torch_port_common``'s tiny DiT and multimodal MMDiT and
``test_torch_port_unet``'s UNet, every JAX parameter (adapters included:
``lora_b`` is zero at init) replaced by seeded noise (trap T9), the
adapters' at unit fan-in variance and DoRA's magnitudes near 1.

Tolerances, as max |port - JAX| over max |JAX|: the forward 1e-5 in fp32;
4e-2 in the mixed bf16 policy (the DiT tests' bf16 tolerance: nnx.LoRA
rounds ``x @ a``, ``@ b`` and the sum with the base's output to bf16, in
that order, on both sides; measured 1.0e-2 against 4.0e-3 without the
adapters); the merged model against the adapted one 1e-5; the adapters
after one AdamW step at lr 1e-3 within 5e-5 absolute (5% of lr, Adam's
first update on near-eps gradients, as in test_torch_port_txt2img_train).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_port_common import LATENT, POLICIES, TINY, TINY_MM, _randomize, context_inputs, null_embedding, rel_err
from flax import nnx

import diffulab_tpu.networks.denoisers.unet as jax_unet
from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.networks.denoisers.mmdit import MMDiT as JaxMMDiT
from diffulab_tpu.training import lora as jlora
from diffulab_tpu.training import optim as joptim
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.networks.denoisers.unet import UNetModel
from diffulab_tpu_torch.training import lora
from diffulab_tpu_torch.training import optim as toptim
from diffulab_tpu_torch.training.checkpoint import (
    restore_checkpoint,
    restore_sampling_model,
    save_checkpoint,
    split_state,
    trainable_filter,
)
from diffulab_tpu_torch.training.trainer import BaseTrainer, MultiStepOptimizer, train_step
from diffulab_tpu_torch.weights import state_dict_from_jax

FWD_TOL = {"fp32": 1e-5, "bf16_mixed": 4e-2}
MERGE_TOL, UPDATE_ATOL = 1e-5, 5e-5
RANK = 4
UNET = dict(image_size=[16, 16], in_channels=3, model_channels=32, out_channels=3, num_res_blocks=1,
            attention_resolutions=[1, 2], channel_mult="1, 2", num_heads=2, resblock_updown=True,
            use_scale_shift_norm=True, n_classes=10, classifier_free=True)
BATCH = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)


def _jax_embedder():
    from diffulab_tpu.networks.embedders.precomputed import PrecomputedEmbedder

    return PrecomputedEmbedder(null_embedding=null_embedding(), null_embedding_seq_len=3)


def _port_embedder():
    from diffulab_tpu_torch.networks.embedders import PrecomputedEmbedder

    return PrecomputedEmbedder(null_embedding=null_embedding(), null_embedding_seq_len=3, device="cpu")


#: name -> (JAX model, port model) builders at a policy
MODELS = {
    "dit": (lambda p: JaxMMDiT(**TINY, **POLICIES[p][0], rngs=nnx.Rngs(0)),
            lambda p: MMDiT(**TINY, **POLICIES[p][1], device="cpu")),
    "mmdit": (lambda p: JaxMMDiT(**TINY_MM, context_embedder=_jax_embedder(), **POLICIES[p][0], rngs=nnx.Rngs(0)),
              lambda p: MMDiT(**TINY_MM, context_embedder=_port_embedder(), **POLICIES[p][1], device="cpu")),
    "unet": (lambda p: jax_unet.UNetModel(**UNET, rngs=nnx.Rngs(0)), lambda p: UNetModel(**UNET, device="cpu")),
}


def _inputs(name, seed=1):
    rng = np.random.default_rng(seed)
    shape = {"dit": LATENT, "mmdit": (8, 8, 4), "unet": (16, 16, 3)}[name]
    x = rng.standard_normal((BATCH, *shape)).astype(np.float32)
    t = rng.uniform(0.05, 1.0, BATCH).astype(np.float32)
    if name == "mmdit":
        emb, mask = context_inputs(BATCH)
        return x, t, {"context": {"embeddings": emb, "attn_mask": mask}}
    return x, t, {"y": np.array([3, 7])}


def _jax_out(model, x, t, cond):
    cond = jax.tree.map(jnp.asarray, cond)
    return np.asarray(model(jnp.asarray(x), jnp.asarray(t), cond, jnp.zeros(BATCH, bool))["x"], np.float32)


def _port_out(model, x, t, cond):
    cond = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in cond.items()}
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(t), cond, torch.zeros(BATCH, dtype=torch.bool))["x"]


def _randomize_wrapped(model, seed):
    """:func:`_randomize`, the adapters at their own scales: ``lora_a`` and
    ``lora_b`` at unit fan-in variance, ``magnitude`` near 1."""
    params = _randomize(model, seed)
    flat = []
    for path, var in nnx.state(model, nnx.Param).flat_state():
        key = "/".join(str(p) for p in path)
        value = params[key]
        if key.endswith(("lora_a", "lora_b")):
            value = (value * value.shape[0] ** -0.5).astype(np.float32)
        elif key.endswith("magnitude"):
            value = (1.0 + 0.1 * value).astype(np.float32)
        params[key] = value
        flat.append((path, var.replace(jnp.asarray(value))))
    nnx.update(model, nnx.State.from_flat_path(flat))
    return params


def _wrapped_pair(name, policy, variant, seed=2):
    """(JAX model, port model) wrapped, every parameter randomised and bridged."""
    jm = MODELS[name][0](policy)
    n_jax = jlora.apply_lora(jm, RANK, rngs=nnx.Rngs(1), variant=variant)
    params = _randomize_wrapped(jm, seed)
    pm = MODELS[name][1](policy)
    n_port = lora.apply_lora(pm, RANK, variant=variant)
    pm.load_state_dict(state_dict_from_jax(params, pm), strict=True)
    assert n_port == n_jax > 0
    return jm, pm, n_port


@pytest.mark.parametrize("variant", ["lora", "dora"])
@pytest.mark.parametrize("name", ["dit", "mmdit"])
def test_adapter_count_and_names_match_jax(name, variant):
    jm = MODELS[name][0]("fp32")
    n_jax = jlora.apply_lora(jm, RANK, rngs=nnx.Rngs(1), variant=variant)
    pm = MODELS[name][1]("fp32")
    n_port = lora.apply_lora(pm, RANK, variant=variant)
    assert n_port == n_jax > 0
    jax_names = {".".join(str(p) for p in path) for path, _ in nnx.state(jm, nnx.LoRAParam).flat_state()}
    assert {n for n, _ in pm.named_parameters() if lora.is_lora_param(n)} == jax_names
    assert lora.count_lora_params(pm) == jlora.count_lora_params(jm)
    assert lora.apply_lora(pm, RANK, variant=variant) == 0  # already wrapped


@pytest.mark.parametrize("variant", ["lora", "dora"])
@pytest.mark.parametrize("policy", ["fp32", "bf16_mixed"])
@pytest.mark.parametrize("name", ["dit", "mmdit"])
def test_wrap_is_the_identity_at_init(name, policy, variant):
    base = MODELS[name][1](policy)
    x, t, cond = _inputs(name)
    before = _port_out(base, x, t, cond)
    lora.apply_lora(base, RANK, generator=torch.Generator().manual_seed(0), variant=variant)
    after = _port_out(base, x, t, cond)
    if variant == "lora" or policy == "fp32":
        assert torch.equal(after, before)
    else:  # DoRA computes in x's dtype, the base's bf16 aside (the reference's rule): not the identity there
        assert rel_err(after.float().numpy(), before.float().numpy()) < FWD_TOL[policy]


@pytest.mark.parametrize("variant", ["lora", "dora"])
@pytest.mark.parametrize("policy", ["fp32", "bf16_mixed"])
@pytest.mark.parametrize("name", ["dit", "mmdit"])
def test_adapted_forward_and_merge_match_jax(name, policy, variant):
    jm, pm, _ = _wrapped_pair(name, policy, variant)
    x, t, cond = _inputs(name)
    ours, ref = _port_out(pm, x, t, cond), _jax_out(jm, x, t, cond)
    assert rel_err(ours.float().numpy(), ref) < FWD_TOL[policy]
    n_merged = lora.merge_lora(pm)
    assert n_merged == jlora.merge_lora(jm) and lora.count_lora_params(pm) == 0
    merged = _port_out(pm, x, t, cond)
    if policy == "fp32":
        assert rel_err(merged.numpy(), ours.numpy()) < MERGE_TOL
    _, jparams, _ = nnx.split(jm, nnx.Param, ...)
    ref_sd = state_dict_from_jax({"/".join(str(p) for p in path): np.asarray(v.get_value(), np.float32)
                                  for path, v in jparams.flat_state()}, pm)
    for key, value in pm.state_dict().items():
        if key in ref_sd:
            np.testing.assert_allclose(value.float().numpy(), ref_sd[key].numpy(), atol=1e-6, rtol=1e-5, err_msg=key)


def test_unet_adapter_count_and_forward_match_jax():
    jm, pm, _ = _wrapped_pair("unet", "fp32", "lora")  # the counts are equal
    jax_names = {".".join(str(p) for p in path) for path, _ in nnx.state(jm, nnx.LoRAParam).flat_state()}
    assert {n for n, _ in pm.named_parameters() if lora.is_lora_param(n)} == jax_names
    x, t, cond = _inputs("unet")
    assert rel_err(_port_out(pm, x, t, cond).numpy(), _jax_out(jm, x, t, cond)) < FWD_TOL["fp32"]


@pytest.mark.parametrize("variant", ["lora", "dora"])
def test_lora_only_step_matches_optax(variant):
    """One flow-matching AdamW step on the adapters alone (trainer.py:607):
    the optimizer holds the adapters, the base stays, DoRA's magnitude
    takes a gradient."""
    jm, pm, _ = _wrapped_pair("dit", "fp32", variant, seed=3)
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal((BATCH, *LATENT)).astype(np.float32)
    noise = rng.standard_normal((BATCH, *LATENT)).astype(np.float32)
    t = rng.uniform(0, 1, BATCH).astype(np.float32)
    y = np.array([1, 5])
    kw = dict(lr=1e-3, weight_decay=1e-2)
    graphdef, lparams, rest = nnx.split(jm, nnx.LoRAParam, ...)
    jd = JaxDiffuser(jm, "euler", n_steps=4)

    def loss_fn(p):
        m = nnx.merge(graphdef, p, rest)
        return jd.diffusion.compute_loss(lambda **k: m(**k, train=True), jnp.asarray(x0), {"y": jnp.asarray(y)},
                                         jnp.asarray(t), jnp.asarray(noise))["loss"]

    tx = joptim.adamw(**kw)
    _, grads = jax.value_and_grad(loss_fn)(lparams)
    updates, _ = tx.update(grads, tx.init(lparams), lparams)
    new = optax.apply_updates(lparams, updates)
    ref = state_dict_from_jax({"/".join(str(p) for p in path): np.asarray(v.get_value(), np.float32)
                               for path, v in new.flat_state()}, pm)

    trainable = trainable_filter(pm, lora=True)
    params = {n: p for n, p in pm.named_parameters() if trainable(n)}
    assert set(params) == set(ref) and all(lora.is_lora_param(n) for n in params)
    for n, p in pm.named_parameters():
        p.requires_grad_(trainable(n))
    base = {n: p.detach().clone() for n, p in pm.named_parameters() if not trainable(n)}
    factory = toptim.adamw(**kw)
    opt = MultiStepOptimizer(factory(list(params.values())), 1)
    batch = {"model_inputs": {"x": torch.from_numpy(x0), "y": torch.from_numpy(y)}}
    diffuser = Diffuser(pm, "euler", n_steps=4)
    if variant == "dora":
        magnitude = next(p for n, p in params.items() if n.endswith("magnitude"))
        magnitude.register_hook(lambda g: g_seen.append(g.clone()))
        g_seen = []
    train_step(diffuser, opt, None, batch, torch.from_numpy(t), torch.from_numpy(noise), None, 1)
    if variant == "dora":
        assert g_seen and bool(torch.any(g_seen[0] != 0))
    for n, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), atol=UPDATE_ATOL, rtol=0, err_msg=n)
    for n, p in pm.named_parameters():
        if n in base:
            assert torch.equal(p.detach(), base[n]), n


@pytest.mark.parametrize("variant", ["lora", "dora"])
def test_lora_run_restores_through_lora_from(tmp_path, variant):
    """BaseTrainer.train(lora_only=True) on a wrapped model: the optimizer,
    the EMA and the checkpoint's params hold the adapters alone; the run's
    entries restore into a fresh model through trainer.lora_from, and a
    params-only entry without lora_from is refused."""
    torch.manual_seed(0)
    base = MMDiT(**TINY, device="cpu")
    params, rest = split_state(base, trainable_filter(base))
    save_checkpoint(tmp_path / "base" / "denoiser", {"params": params, "rest": rest})
    model = MMDiT(**TINY, device="cpu")
    restore_sampling_model(tmp_path / "base" / "denoiser", model, [], {})
    lora.apply_lora(model, RANK, generator=torch.Generator().manual_seed(1), variant=variant)
    rng = np.random.default_rng(5)
    batches = [{"model_inputs": {"x": torch.from_numpy(rng.standard_normal((4, *LATENT)).astype(np.float32)),
                                 "y": torch.from_numpy(rng.integers(0, 10, 4))}} for _ in range(2)]
    trainer = BaseTrainer(n_epoch=1, save_path=tmp_path, project_name="run", use_ema=True, ema_update_every=1,
                          device="cpu")
    trainer.train(Diffuser(model, "euler", n_steps=2), toptim.adamw(lr=1e-2), batches, batches[:1],
                  log_validation_images=False, lora_only=True, seed=0)
    ckpt = tmp_path / "run" / "checkpoints"
    entry = restore_checkpoint(ckpt / "denoiser")
    assert entry["params"] and all(lora.is_lora_param(n) for n in entry["params"])
    assert not any(lora.is_lora_param(n) for n in entry["rest"])
    assert set(restore_checkpoint(ckpt / "ema")["params"]) == set(entry["params"])
    opt = restore_checkpoint(ckpt / "optimizer")["opt_state"]["optimizer"]
    assert len(opt["param_groups"][0]["params"]) == len(entry["params"])
    for n, p in model.named_parameters():  # the base is untouched
        key = n.replace(".base_module.", ".").replace(".base.", ".")
        if not lora.is_lora_param(n):
            assert torch.equal(p.detach(), params.get(key, rest.get(key))), n
    cfg = {"lora_rank": RANK, "lora_from": str(tmp_path / "base" / "denoiser"), "lora_variant": variant}
    fresh = MMDiT(**TINY, device="cpu")
    restore_sampling_model(ckpt / "denoiser", fresh, [], cfg)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in fresh.state_dict().items())
    fresh = MMDiT(**TINY, device="cpu")
    restore_sampling_model(ckpt / "ema", fresh, [], cfg)
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in restore_checkpoint(ckpt / "ema")["params"].items())
    with pytest.raises(SystemExit, match="lora_from"):
        restore_sampling_model(ckpt / "ema", MMDiT(**TINY, device="cpu"), [], {"lora_rank": RANK})
