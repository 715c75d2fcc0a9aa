"""The port's GRPO post-training against the JAX package on the CPU: the
reward models' parsing and aggregation, ``compute_loss_grpo`` (loss,
``clip_frac``, ``ratio_dev`` and every parameter gradient), one
``GRPOTrainer`` batch, the trust region's reject, and the port's
``mini_batch_size`` and ``offload_trajectories`` options.

The model is the tiny multimodal MMDiT of ``_torch_port_common`` with two
dual-stream blocks and no single-stream one, as ``train_grpo_alignment``'s
(the last block's text stream then reaches no output: its parameters take a
zero gradient and AdamW decays them on both sides), on 4x4x16 latents with
8 text tokens (the fused route: its plain K1/K2 on the CPU), every JAX
parameter replaced by seeded noise and bridged (trap T9). The trainer tests
decode through the tiny Flux2 tower of ``_torch_port_common``. Every draw is
injected (T4): the trajectories' ``x_init``, the SDE noise of each step and
the trajectory indices are the JAX trainer's own, from its keys
(``fold_in(key(seed), batch)``, then 0, ``100 + g·4096 + c0`` and ``200 +
g`` under it).

Tolerances: the loss 1e-5 relative, ``clip_frac`` 1e-6 relative and
``ratio_dev`` 1e-5 absolute, each gradient 1e-4 relative (max |port - JAX| over max |JAX|,
fp32 summation order); after a batch of two AdamW steps at lr 1e-3, the
parameters and the EMA within 5e-5 absolute (5% of lr: Adam's first update
is lr·g/(|g| + eps), so where |g| is near eps the gradients' summation order
moves it by a few percent of lr) and the logged means within 1e-4 relative.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import (
    diffusers_vae_state_dict,
    injected,
    jax_scan_noise,
    port_mmdit,
    randomized_jax_mmdit,
    rel_err,
    tower_pair,
)
from flax import nnx

from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.networks.rewards import grpo as jgrpo
from diffulab_tpu.training import checkpoint as jcheckpoint
from diffulab_tpu.training import optim as joptim
from diffulab_tpu.training.grpo_trainer import GRPOTrainer as JaxGRPOTrainer
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.networks.rewards import grpo as tgrpo
from diffulab_tpu_torch.training import optim as toptim
from diffulab_tpu_torch.training.checkpoint import restore_checkpoint
from diffulab_tpu_torch.training.grpo_trainer import GRPOTrainer, SeededDraws
from diffulab_tpu_torch.weights import state_dict_from_jax

#: train_grpo_alignment's block layout (dual-stream only) at the tiny widths, on the tower's 16 packed channels
GRPO_MM = dict(depth=2, n_single_stream_blocks=0, input_channels=16)
LATENT = (4, 4, 16)
PIXELS = (16, 16)  # the tower's compression factor is 4
STEPS, FRACTION, EPS, GUIDANCE = 4, 0.5, 0.1, 1.5
K = round(STEPS * FRACTION)
PROMPTS, N_IMAGES, TEXT = 2, 2, (8, 32)
LOSS_TOL, RATIO_TOL, GRAD_TOL = 1e-5, 1e-5, 1e-4
UPDATE_ATOL, METRIC_TOL = 5e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)


# --- the reward models ------------------------------------------------------------


def _prefer_first(queries):
    return ["Alignment Score:\nImage 1: 0.8\nImage 2: 0.2\n\nCoherence Score:\nImage 1: 0.7\nImage 2: 0.3\n"
            for _ in queries]


def _ties(queries):
    return ["unparseable"] * len(queries)


def _clip_scorer(images, context):
    return np.arange(len(images), dtype=np.float32)


def _images(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 8, 8, 3)).astype(np.float32)


#: tests/test_grpo.py:27-80's cases and the luma judge: (reward model kwargs, images, contexts)
REWARD_CASES = {
    "prefer_first": (dict(judge=_prefer_first, n_image_per_prompt=4), _images(8), ["a cat", "a dog"]),
    "ties": (dict(judge=_ties, n_image_per_prompt=3), _images(3), ["p"]),
    "clip_blend": (dict(judge=_ties, n_image_per_prompt=2, use_clip=True, clip_scorer=_clip_scorer, lambda_base=0.5,
                        lambda_clip=2.0), _images(4), ["a", "b"]),
    "cot": (dict(version="cot_7b", n_image_per_prompt=2,
                 judge=lambda q: ["<think>x</think><answer>Image 2 is better</answer>"] * len(q)), _images(4), ["a", "b"]),
    "global_zscore": (dict(judge=_prefer_first, n_image_per_prompt=2), _images(4), ["a", "b"]),
}


@pytest.mark.parametrize("case", sorted(REWARD_CASES))
def test_reward_aggregation_matches_jax(case):
    kwargs, images, context = REWARD_CASES[case]
    per_prompt = case != "global_zscore"
    ours = tgrpo.PrefGRPORewardModel(**kwargs)(images, context, advantage_per_prompt=per_prompt)
    ref = jgrpo.PrefGRPORewardModel(**kwargs)(images, context, advantage_per_prompt=per_prompt)
    np.testing.assert_array_equal(ours, ref)
    assert ours.shape == (len(images),)


@pytest.mark.parametrize("text", [
    "Alignment Score:\nImage 1: 0.45\nImage 2: 0.55\n\nStyle Score:\nImage 1: 0.6\nImage 2: 0.4",
    "Alignment Score:\\n Image 1: 0.8\\n Image 2: 0.2",
    "garbage",
    "<think>xx</think><answer>Image 2 is better</answer>",
    "<answer>Image 1 is better</answer>",
])
def test_score_and_answer_parsing_match_jax(text):
    for version in ("7b", "cot_7b"):
        ours = tgrpo.PrefGRPORewardModel(version=version, judge=_ties)
        ref = jgrpo.PrefGRPORewardModel(version=version, judge=_ties)
        assert ours._parse_scores(text) == ref._parse_scores(text)
        assert ours._extract_cot_answer(text) == ref._extract_cot_answer(text)
        assert ours._assess_winner(text) == ref._assess_winner(text)


def test_luma_judge_and_raw_metrics_match_jax():
    images = _images(4, seed=3)
    queries = [(tgrpo.to_uint8_image(images[i]), tgrpo.to_uint8_image(images[i + 1]), "p") for i in range(3)]
    assert tgrpo.LumaJudge()(queries) == jgrpo.LumaJudge()(queries)
    ours = tgrpo.PrefGRPORewardModel(n_image_per_prompt=2, judge=tgrpo.LumaJudge())
    ref = jgrpo.PrefGRPORewardModel(n_image_per_prompt=2, judge=jgrpo.LumaJudge())
    np.testing.assert_array_equal(ours(images, ["a", "b"]), ref(images, ["a", "b"]))
    assert ours.raw_metrics(images, ["a", "b"]) == ref.raw_metrics(images, ["a", "b"])
    win = ours.parse_and_aggregate(ours.judge(queries[:1]), np.array([[0, 1]]), 1)
    np.testing.assert_array_equal(win[0], ref.parse_and_aggregate(ref.judge(queries[:1]), np.array([[0, 1]]), 1)[0])


def test_indivisible_batch_raises_in_both():
    with pytest.raises(AssertionError):
        jgrpo.PrefGRPORewardModel(n_image_per_prompt=4, judge=_prefer_first)(_images(6), ["a"])
    with pytest.raises(ValueError, match="not divisible"):
        tgrpo.PrefGRPORewardModel(n_image_per_prompt=4, judge=_prefer_first)(_images(6), ["a"])
    with pytest.raises(ValueError, match="context length"):
        tgrpo.PrefGRPORewardModel(n_image_per_prompt=2, judge=_prefer_first)(_images(4), ["a"])


def test_vlm_judge_needs_transformers_only_when_it_loads():
    judge = tgrpo.VLMJudge("no/such/model")  # builds without loading anything
    assert judge._model is None and tgrpo.PrefGRPORewardModel(version="3b").judge.model_path.endswith("qwen-3b")


# --- compute_loss_grpo ------------------------------------------------------------


def _models(seed):
    jax_model, params = randomized_jax_mmdit("fp32", seed=seed, **GRPO_MM)
    return jax_model, port_mmdit("fp32", params, **GRPO_MM)


def _cond(seed, batch=PROMPTS):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((batch, *TEXT)).astype(np.float32)
    mask = np.arange(TEXT[0])[None, :] < (np.arange(batch) * 5 % TEXT[0] + 2)[:, None]
    return emb, mask


def _jax_cond(emb, mask):
    return {"context": {"embeddings": jnp.asarray(emb), "attn_mask": jnp.asarray(mask)}}


def _torch_cond(emb, mask):
    return {"context": {"embeddings": torch.from_numpy(emb), "attn_mask": torch.from_numpy(mask)}}


def _trajectory(jax_model, emb, mask, seed):
    """An EM-4 trajectory of the JAX model under CFG, its stored logprobs
    moved by seeded noise so that ratios leave [1 - eps, 1 + eps]."""
    diffuser = JaxDiffuser(jax_model, "euler_maruyama", n_steps=STEPS)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((PROMPTS, *LATENT)).astype(np.float32))
    out = diffuser.diffusion.denoise(lambda **kw: jax_model(**kw, train=False), _jax_cond(emb, mask),
                                     jax.random.key(seed), x=x, guidance_scale=GUIDANCE, use_cfg=True,
                                     return_intermediates=True)
    sampling = {k: np.asarray(out[k], np.float32) for k in ("xt", "xt_mean", "logprob")}
    sampling["logprob"] = sampling["logprob"] + 0.2 * rng.standard_normal(sampling["logprob"].shape).astype(np.float32)
    return sampling


def _flat(tree) -> dict[str, np.ndarray]:
    return {"/".join(str(p) for p in path): np.asarray(v.get_value(), np.float32) for path, v in tree.flat_state()}


@pytest.fixture(scope="module")
def grpo_case():
    """The tiny model's bridged parameters, a JAX trajectory, advantages and
    indices, and the JAX loss and gradients by ``kl_beta`` (computed once)."""
    jax_model, params = randomized_jax_mmdit("fp32", seed=21, **GRPO_MM)
    emb, mask = _cond(22)
    sampling = _trajectory(jax_model, emb, mask, seed=23)
    adv = np.array([1.3, -0.7], np.float32)
    rng = jax.random.key(24)
    jd = JaxDiffuser(jax_model, "euler_maruyama", n_steps=STEPS)
    graphdef, jparams, rest = nnx.split(jax_model, nnx.Param, ...)
    refs = {}

    def reference(kl_beta):
        if kl_beta not in refs:
            def loss_fn(p):
                m = nnx.merge(graphdef, p, rest)
                losses = jd.diffusion.compute_loss_grpo(
                    lambda **kw: m(**kw, train=True), _jax_cond(emb, mask),
                    {k: jnp.asarray(v) for k, v in sampling.items()}, jnp.asarray(adv), rng, kl_beta=kl_beta,
                    eps=EPS, timestep_fraction=FRACTION, guidance_scale=GUIDANCE)
                return losses["loss"], losses

            (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
            refs[kl_beta] = ({k: float(v) for k, v in losses.items()}, _flat(grads))
        return refs[kl_beta]

    indices = np.asarray(jax.random.choice(rng, STEPS, shape=(K,), replace=False)).tolist()
    return dict(params=params, emb=emb, mask=mask, sampling=sampling, adv=adv, indices=indices, reference=reference)


@pytest.mark.parametrize("kl_beta", [0.0, 0.5])
@pytest.mark.parametrize("backward", [True, False])
def test_compute_loss_grpo_matches_jax(grpo_case, kl_beta, backward):
    c = grpo_case
    model = port_mmdit("fp32", c["params"], **GRPO_MM)
    ref, ref_grads = c["reference"](kl_beta)
    ref_grads = state_dict_from_jax(ref_grads, model)
    diffuser = Diffuser(model, "euler_maruyama", n_steps=STEPS)
    losses = diffuser.compute_loss(None, _torch_cond(c["emb"], c["mask"]), None, None, grpo=True, grpo_args=dict(
        sampling={k: torch.from_numpy(v) for k, v in c["sampling"].items()}, advantages=torch.from_numpy(c["adv"]),
        indices=c["indices"], backward=backward, kl_beta=kl_beta, eps=EPS, timestep_fraction=FRACTION,
        guidance_scale=GUIDANCE))
    if not backward:
        losses["loss"].backward()
    assert abs(float(losses["loss"]) - ref["loss"]) <= LOSS_TOL * abs(ref["loss"])
    assert 0 < float(losses["clip_frac"]) < 1 and float(losses["clip_frac"]) == pytest.approx(ref["clip_frac"])
    assert abs(float(losses["ratio_dev"]) - ref["ratio_dev"]) <= RATIO_TOL
    assert not losses["clip_frac"].requires_grad and not losses["ratio_dev"].requires_grad
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        r = ref_grads[name].numpy()
        if not np.any(r):  # the last block's text stream: no gradient reaches it on either side
            assert g is None or not torch.any(g), name
            continue
        assert rel_err(g.numpy(), r) < GRAD_TOL, name


def test_compute_loss_grpo_draws_distinct_indices_from_the_generator():
    jax_model, model = _models(seed=25)
    emb, mask = _cond(26)
    sampling = {k: torch.from_numpy(v) for k, v in _trajectory(jax_model, emb, mask, seed=27).items()}
    diffusion = Diffuser(model, "euler_maruyama", n_steps=STEPS).diffusion
    args = dict(sampling=sampling, advantages=torch.ones(PROMPTS), timestep_fraction=FRACTION, guidance_scale=GUIDANCE)
    model_fn = Diffuser(model, "euler_maruyama").model_fn(train=False)
    with torch.no_grad():
        a = diffusion.compute_loss_grpo(model_fn, _torch_cond(emb, mask), generator=torch.Generator().manual_seed(1),
                                        **args)
        b = diffusion.compute_loss_grpo(model_fn, _torch_cond(emb, mask), indices=torch.randperm(
            STEPS, generator=torch.Generator().manual_seed(1))[:K].tolist(), **args)
    assert float(a["loss"]) == float(b["loss"])
    with pytest.raises(ValueError, match="distinct"):
        diffusion.compute_loss_grpo(model_fn, _torch_cond(emb, mask), indices=[1, 1], **args)
    with pytest.raises(ValueError, match="Euler-Maruyama"):
        Diffuser(model, "euler", n_steps=STEPS).diffusion.compute_loss_grpo(model_fn, {}, indices=[0, 1], **args)


# --- the trainer --------------------------------------------------------------------


class JaxDraws:
    """The JAX trainer's draws for the batch folded ``batch_key`` into ``key(seed)``."""

    def __init__(self, seed: int, batch_key: int):
        self.rng = jax.random.fold_in(jax.random.key(seed), batch_key)

    def x_init(self, shape):
        return torch.from_numpy(np.asarray(jax.random.normal(jax.random.fold_in(self.rng, 0), shape), np.float32))

    def sample_noise(self, group, start):
        key = jax.random.fold_in(self.rng, 100 + group * 4096 + start)
        cache = {}

        def draw(kind, step, shape, dtype):
            if not cache:
                cache.update(jax_scan_noise(key, STEPS, shape, jnp.float32))
            return injected(cache)(kind, step, shape, dtype)
        return draw

    def indices(self, group, steps, k):
        key = jax.random.fold_in(self.rng, 200 + group)
        return np.asarray(jax.random.choice(key, steps, shape=(k,), replace=False)).tolist()


def _batch(seed, framework):
    emb, mask = _cond(seed)
    cond = _jax_cond(emb, mask) if framework == "jax" else _torch_cond(emb, mask)
    return [{"model_inputs": cond, "extra": {"captions": [f"prompt {i}" for i in range(PROMPTS)]}}]


def _trainer_kwargs(tmp_path, name, trust_region):
    return dict(n_epoch=1, save_path=tmp_path, project_name=name, use_ema=True, ema_update_every=1,
                timestep_fraction=FRACTION, kl_beta=0.1, eps=EPS, trust_region=trust_region)


def _train_kwargs(framework, judge):
    rm = (jgrpo if framework == "jax" else tgrpo).PrefGRPORewardModel(n_image_per_prompt=N_IMAGES, judge=judge)
    return dict(reward_model=rm, optimizer=(joptim if framework == "jax" else toptim).adamw(lr=1e-3, weight_decay=1e-2),
                train_dataloader=_batch(31, framework), val_dataloader=_batch(32, framework),
                n_image_per_prompt=N_IMAGES, guidance_scale=GUIDANCE, image_resolution=PIXELS,
                log_validation_images=False, seed=5)


def _metrics(run):
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    return {k: v for r in rows for k, v in r.items() if k not in ("step", "time")}


def _run_both(tmp_path, trust_region):
    jax_model, model = _models(seed=33)
    jax_tower, tower = tower_pair(diffusers_vae_state_dict(), bn_stats=True)
    start = {name: p.detach().clone() for name, p in model.named_parameters()}
    jt = JaxGRPOTrainer(**_trainer_kwargs(tmp_path, "jax", trust_region))
    jt.train(JaxDiffuser(jax_model, "euler_maruyama", n_steps=STEPS, vision_tower=jax_tower),
             **_train_kwargs("jax", jgrpo.LumaJudge()))
    tt = GRPOTrainer(**_trainer_kwargs(tmp_path, "port", trust_region), device="cpu")
    tt.train(Diffuser(model, "euler_maruyama", n_steps=STEPS, vision_tower=tower),
             draws=lambda key: JaxDraws(5, key), **_train_kwargs("port", tgrpo.LumaJudge()))
    _, jparams, _ = nnx.split(jax_model, nnx.Param, ...)
    ref_params = state_dict_from_jax(_flat(jparams), model)
    return jt, tt, model, start, ref_params


def test_grpo_trainer_batch_matches_jax(tmp_path):
    """One train batch (2 prompts x 2 images, the luma judge, two learn
    steps) and one validation batch on the EMA weights, then the best-val
    checkpoint: the parameters, the EMA and every logged mean."""
    jt, tt, model, start, ref_params = _run_both(tmp_path, trust_region=0.3)
    assert tt.step == 2 and float(jt._lr_scale) == tt.lr_scale == 1.0
    for name, p in model.named_parameters():
        assert not torch.equal(p.detach(), start[name]), name  # zero-gradient parameters decay too
        np.testing.assert_allclose(p.detach().numpy(), ref_params[name].numpy(), atol=UPDATE_ATOL, rtol=0,
                                   err_msg=name)
    ema = restore_checkpoint(tmp_path / "port" / "checkpoints" / "ema")["params"]
    ref_ema = state_dict_from_jax({k.removeprefix("denoiser/").removesuffix("/value"): np.asarray(v) for k, v in
                                   _flat_dict(jcheckpoint.restore_checkpoint(
                                       tmp_path / "jax" / "checkpoints" / "ema")["params"]).items()}, model)
    for name, value in ema.items():
        np.testing.assert_allclose(value.numpy(), ref_ema[name].numpy(), atol=UPDATE_ATOL, rtol=0, err_msg=name)
    ours, ref = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    assert set(ours) == set(ref) and {"train/grad_norm", "train/tr_reject", "val/judge_score"} <= set(ours)
    for key, value in ref.items():
        assert abs(ours[key] - value) <= METRIC_TOL * max(abs(value), 1.0), (key, ours[key], value)
    assert ours["train/tr_reject"] == 0 and ours["train/ratio_dev"] < 0.3


def test_trust_region_reject_rolls_back_in_both(tmp_path):
    """A region no update fits (``ratio_dev > -1`` always): both groups are
    rejected, so the parameters are the batch start's, the optimizer never
    stepped, the EMA is the initial copy and ``lr_scale`` halved twice."""
    jt, tt, model, start, ref_params = _run_both(tmp_path, trust_region=-1.0)
    assert float(jt._lr_scale) == tt.lr_scale == 0.25
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), start[name]), name
        np.testing.assert_array_equal(ref_params[name].numpy(), start[name].numpy(), err_msg=name)
    opt = restore_checkpoint(tmp_path / "port" / "checkpoints" / "optimizer")["opt_state"]
    assert opt["optimizer"]["state"] == {} and opt["mini_step"] == 0
    jopt = jcheckpoint.restore_checkpoint(tmp_path / "jax" / "checkpoints" / "optimizer")["opt_state"]
    counts = [int(np.asarray(v)) for k, v in _flat_dict(jopt).items() if k.endswith("count")]
    assert counts and not any(counts)
    ema = restore_checkpoint(tmp_path / "port" / "checkpoints" / "ema")["params"]
    for name, value in ema.items():
        assert torch.equal(value, start[name]), name
    ours, ref = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    assert ours["train/tr_reject"] == ref["train/tr_reject"] == 1.0


def _flat_dict(tree, prefix=""):
    """{"a/b/c": leaf} of a restored orbax tree of dicts and lists."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        path = f"{prefix}{key}"
        if isinstance(value, (dict, list, tuple)):
            out.update(_flat_dict(value, path + "/"))
        else:
            out[path] = value
    return out


class SlicedDraws(SeededDraws):
    """Seeded draws whose chunk noise is the rows of one whole-batch draw,
    so that chunking the prompts changes no sample."""

    def sample_noise(self, group, start):
        noise = {}

        def draw(kind, step, shape, dtype):
            if (kind, step) not in noise:
                gen = self._generator(1000 * group + step)
                noise[kind, step] = torch.randn((PROMPTS, *shape[1:]), generator=gen, dtype=dtype)
            return noise[kind, step][start:start + shape[0]]
        return draw


@pytest.mark.parametrize("options", [dict(mini_batch_size=1, offload_trajectories=False),
                                     dict(mini_batch_size=None, offload_trajectories=False)])
def test_mini_batch_and_offload_give_the_same_result(tmp_path, options):
    """The same draws sampled in chunks of one prompt, or kept on the
    device: offloading changes no bit; chunking changes the model's batch,
    hence the summation order, and the parameters stay within UPDATE_ATOL
    (measured 3.2e-5 after the two Adam steps)."""
    results = []
    for name, opts in (("base", dict(mini_batch_size=None, offload_trajectories=True)), ("other", options)):
        _, model = _models(seed=41)
        _, tower = tower_pair(diffusers_vae_state_dict())
        trainer = GRPOTrainer(**_trainer_kwargs(tmp_path, name, 0.3), **opts, device="cpu")
        trainer.train(Diffuser(model, "euler_maruyama", n_steps=STEPS, vision_tower=tower),
                      draws=lambda key: SlicedDraws(0, key, torch.device("cpu")),
                      **{**_train_kwargs("port", tgrpo.LumaJudge()), "val_dataloader": None})
        results.append(({n: p.detach().clone() for n, p in model.named_parameters()}, _metrics(tmp_path / name)))
    (params, metrics), (other_params, other_metrics) = results
    exact = options["mini_batch_size"] is None
    for name, value in params.items():
        torch.testing.assert_close(other_params[name], value, rtol=0, atol=0 if exact else UPDATE_ATOL, msg=name)
    assert metrics.keys() == other_metrics.keys()


def test_grpo_trainer_refusals(tmp_path):
    _, model = _models(seed=43)
    trainer = GRPOTrainer(n_epoch=1, save_path=tmp_path, device="cpu")
    rm = tgrpo.PrefGRPORewardModel(n_image_per_prompt=2, judge=_ties)
    no_captions = [{"model_inputs": _batch(44, "port")[0]["model_inputs"], "extra": {}}]
    with pytest.raises(ValueError, match="captions"):
        trainer.train(Diffuser(model, "euler_maruyama", n_steps=STEPS), rm, toptim.adamw(), no_captions)
    with pytest.raises(ValueError, match="rectified_flow"):
        trainer.train(Diffuser(model, "ddim", model_type="gaussian_diffusion", n_steps=STEPS), rm, toptim.adamw(),
                      _batch(45, "port"))
    with pytest.raises(NotImplementedError, match="item 17"):
        GRPOTrainer(n_epoch=1, save_path=tmp_path, device="cpu", mesh={"data": 2})
