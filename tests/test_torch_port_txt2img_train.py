"""The port's latent text-to-image training path against the JAX package:
the multimodal MMDiT's loss and gradients at a length where the port takes
the flash route (its plain K3 forward and K4/K5 backward), one AdamW + EMA
step on a text batch, per-block recompute, the trainable split, the sharded
text-to-image data, and ``BaseTrainer.train`` end to end on the CPU.

The model is the tiny multimodal MMDiT of ``_torch_port_common`` (2 dual + 1
single-stream block, 4 heads of 16) on 24x24 latents with 8 text tokens: 584
tokens, 640 padded, past the fused kernel's 512. Every JAX parameter is
replaced by seeded noise and bridged (trap T9); t, noise and the CFG drop are
injected on both sides (T4). The JAX model runs XLA attention on the CPU;
every row keeps a valid key, so T1 does not bite.

Tolerances, as max |port - JAX| over max |JAX| (per tensor for gradients):
the loss 1e-5 in fp32 and 2e-2 in the mixed bf16 policy; gradients 1e-4 in
fp32 (summation order over 584 tokens) and 1e-1 in mixed bf16, where the
port's flash route rounds p (unnormalised, over 64-key tiles, T15) and ds to
bf16 at other places than XLA's attention and its autograd, and the blocks
carry the difference back; parameters and EMA after one AdamW update at lr
1e-3 within 5e-5 absolute, 5% of lr: Adam's first update is lr·g/(|g| + eps),
so where |g| is near eps = 1e-8 the fp32 gradients' summation-order
difference moves it by a few percent of lr (measured 2.4e-5 on 1 of 32768
elements of one tensor, the rest within 1e-6).
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_port_common import (
    CONTEXT,
    NULL_SEQ_LEN,
    TINY_MM,
    TINY_TOWER,
    context_inputs,
    diffusers_vae_state_dict,
    null_embedding,
    port_mmdit,
    randomized_jax_mmdit,
    rel_err,
    tower_pair,
)
from flax import nnx

from diffulab_tpu.data import imagenet as jimagenet
from diffulab_tpu.data.streaming import ShardedDatasetWriter as JaxShardedDatasetWriter
from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.training import ema as jema
from diffulab_tpu.training import optim as joptim
from diffulab_tpu_torch.data.imagenet import ImageNetmultiAR, MultiARBatchSampler, collate_fn
from diffulab_tpu_torch.data.streaming import ShardedDataset, ShardedDatasetWriter
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.networks.embedders import ContextEmbedder, PrecomputedEmbedder
from diffulab_tpu_torch.ops.attention import use_fused
from diffulab_tpu_torch.training import ema as tema
from diffulab_tpu_torch.training import optim as toptim
from diffulab_tpu_torch.training.checkpoint import restore_checkpoint, split_state, trainable_filter
from diffulab_tpu_torch.training.trainer import EMA, BaseTrainer, MultiStepOptimizer, train_step
from diffulab_tpu_torch.weights import state_dict_from_jax

LATENT = (24, 24, 4)
BATCH = 2
LOSS_TOL = {"fp32": 1e-5, "bf16_mixed": 2e-2}
GRAD_TOL = {"fp32": 1e-4, "bf16_mixed": 1e-1}
UPDATE_ATOL = 5e-5
EXTRA = {"logits_normal": True, "shift": 4.63}


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


def _draws(seed):
    """x0, context embeddings and mask, t, noise and drop from numpy (T4)."""
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((BATCH, *LATENT)).astype(np.float32)
    emb, mask = context_inputs(BATCH, seed + 100)
    t = rng.uniform(0.0, 1.0, BATCH).astype(np.float32)
    noise = rng.standard_normal((BATCH, *LATENT)).astype(np.float32)
    drop = np.array([False, True])
    return x0, emb, mask, t, noise, drop


def _jax_loss_fn(jax_model, x0, emb, mask, t, noise, drop, dtype):
    """The JAX loss as a function of the model's parameters (trainer.py:322-367)."""
    diffuser = JaxDiffuser(jax_model, "euler", n_steps=4, extra_args=EXTRA)
    graphdef, params, rest = nnx.split(jax_model, nnx.Param, ...)
    cond = {"context": {"embeddings": jnp.asarray(emb), "attn_mask": jnp.asarray(mask)}}

    def loss_fn(params):
        model = nnx.merge(graphdef, params, rest)
        return diffuser.diffusion.compute_loss(
            lambda **kw: model(**kw, train=True), jnp.asarray(x0, dtype), cond,
            jnp.asarray(t), jnp.asarray(noise, dtype), drop=jnp.asarray(drop),
        )["loss"]

    return loss_fn, params


def _flat(tree) -> dict[str, np.ndarray]:
    return {"/".join(str(p) for p in path): np.asarray(v.get_value(), np.float32)
            for path, v in tree.flat_state()}


def _text_batch(x0, emb, mask, captions=None):
    mi = {"x": torch.from_numpy(x0), "context": {"embeddings": torch.from_numpy(emb),
                                                 "attn_mask": torch.from_numpy(mask)}}
    if captions is not None:
        mi["initial_context"] = captions
    return {"model_inputs": mi}


def _port_loss(model, x0, emb, mask, t, noise, drop, dtype):
    diffuser = Diffuser(model, "euler", n_steps=4, extra_args=EXTRA)
    cond = {"context": {"embeddings": torch.from_numpy(emb), "attn_mask": torch.from_numpy(mask)}}
    return diffuser.compute_loss(torch.from_numpy(x0).to(dtype), cond, torch.from_numpy(t),
                                 noise=torch.from_numpy(noise).to(dtype), drop=torch.from_numpy(drop))["loss"]


# --- the loss and its gradients ---------------------------------------------------


@pytest.mark.parametrize("policy", ["fp32", "bf16_mixed"])
def test_mmdit_loss_and_gradients_match_jax(policy):
    assert not use_fused((BATCH, CONTEXT[0] + LATENT[0] * LATENT[1], 4, 16), CONTEXT[0] + LATENT[0] * LATENT[1])
    jax_model, params = randomized_jax_mmdit(policy, seed=3)
    model = port_mmdit(policy, params)
    draws = _draws(4)
    # x0 and noise stay fp32 under the mixed policy (only the whole-model cast draws them in bf16)
    loss_fn, jparams = _jax_loss_fn(jax_model, *draws, jnp.float32)
    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(jparams)
    ref = state_dict_from_jax(_flat(ref_grads), model)
    loss = _port_loss(model, *draws, torch.float32)
    loss.backward()
    assert abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)) < LOSS_TOL[policy]
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(grads) == set(ref) and all(g is not None for g in grads.values())
    for name, g in grads.items():
        assert rel_err(g.numpy(), ref[name].numpy()) < GRAD_TOL[policy], name


def test_one_adamw_and_ema_step_on_a_text_batch_matches_optax():
    """Loss, gradients, one AdamW update with the weight decay passed
    explicitly (T7) and one EMA update on the ramp, through train_step."""
    jax_model, params = randomized_jax_mmdit("fp32", seed=5)
    model = port_mmdit("fp32", params)
    x0, emb, mask, t, noise, drop = _draws(6)
    kw = dict(lr=1e-3, weight_decay=1e-2)
    ema_config = dict(beta=0.999, update_after_step=0, update_every=1)
    # JAX: the step composed as trainer.py:371-386
    loss_fn, jparams = _jax_loss_fn(jax_model, x0, emb, mask, t, noise, drop, jnp.float32)
    tx = joptim.adamw(**kw)
    _, grads = jax.value_and_grad(loss_fn)(jparams)
    updates, _ = tx.update(grads, tx.init(jparams), jparams)
    new = optax.apply_updates(jparams, updates)
    ref_ema = jema.ema_update(jema.EMAConfig(**ema_config), jax.tree.map(jnp.copy, jparams), new, 5)
    ref_params = state_dict_from_jax(_flat(new), model)
    ref_ema = state_dict_from_jax(_flat(ref_ema), model)
    # the port
    diffuser = Diffuser(model, "euler", n_steps=4, extra_args=EXTRA)
    factory = toptim.adamw(**kw)
    opt = MultiStepOptimizer(factory(list(model.parameters())), 1, factory.grad_clip_norm)
    ema = EMA(tema.EMAConfig(**ema_config), tema.init_ema(dict(model.named_parameters())))
    losses = train_step(diffuser, opt, ema, _text_batch(x0, emb, mask), torch.from_numpy(t),
                        torch.from_numpy(noise), torch.from_numpy(drop), 5)
    assert set(losses) == {"loss"} and np.isfinite(float(losses["loss"]))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref_params[name].numpy(), atol=UPDATE_ATOL, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(ema.params[name].numpy(), ref_ema[name].numpy(), atol=UPDATE_ATOL, rtol=0,
                                   err_msg=name)


def test_use_checkpoint_gives_the_same_gradients():
    _, params = randomized_jax_mmdit("fp32", seed=7)
    grads = []
    for use_checkpoint in (False, True):
        model = port_mmdit("fp32", params, use_checkpoint=use_checkpoint)
        assert model.use_checkpoint is use_checkpoint
        _port_loss(model, *_draws(8), torch.float32).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0, msg=name)


# --- the trainable split -------------------------------------------------------------


class _TrainableStub(ContextEmbedder):
    """An embedder with a parameter of its own (a trainable text encoder's place)."""

    _n_output = 1
    _output_size = (CONTEXT[1],)

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(CONTEXT[1], CONTEXT[1])

    def forward(self, context, drop=None):
        return {"embeddings": self.proj(context["embeddings"]), "attn_mask": context["attn_mask"]}


def test_trainable_filter_leaves_out_the_context_embedder():
    model = MMDiT(**TINY_MM, context_embedder=_TrainableStub(), device="cpu")
    names = [n for n, _ in model.named_parameters()]
    frozen = {"context_embedder.proj.weight", "context_embedder.proj.bias"}
    assert frozen <= set(names)
    trainable = trainable_filter(model)
    assert {n for n in names if not trainable(n)} == frozen
    assert all(trainable_filter(model, train_embedder=True)(n) for n in names)
    params, rest = split_state(model, trainable)
    assert set(rest) == frozen and set(params) | set(rest) == set(model.state_dict())
    assert "context_embed.weight" in params  # the projection after the embedder trains
    # a PrecomputedEmbedder has no parameters: everything of the model trains
    pre = MMDiT(**TINY_MM, context_embedder=PrecomputedEmbedder(null_embedding=null_embedding(), device="cpu"),
                device="cpu")
    assert all(trainable_filter(pre)(n) for n, _ in pre.named_parameters())
    with pytest.raises(NotImplementedError, match="item 16"):
        trainable_filter(model, lora=True)
    model.repa_encoder = torch.nn.Linear(2, 2)  # a live REPA encoder is a frozen target (checkpoint.py:114-131)
    trainable = trainable_filter(model)
    assert not trainable("repa_encoder.weight") and not trainable("extra_losses.0.repa_encoder._encoder.pos_embed")
    assert trainable("extra_losses.0.proj_fc1.weight")


def test_trainer_optimises_and_saves_only_the_trainable_parameters(tmp_path):
    model = MMDiT(**{**TINY_MM, "depth": 2, "n_single_stream_blocks": 0}, context_embedder=_TrainableStub(),
                  device="cpu")
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if n.startswith("context_embedder.")}
    x0, emb, mask, *_ = _draws(9)
    trainer = BaseTrainer(n_epoch=1, save_path=tmp_path, project_name="run", use_ema=True, device="cpu",
                          ema_update_every=1)
    trainer.train(Diffuser(model, "euler", n_steps=2), toptim.adamw(lr=1e-2, weight_decay=0.1),
                  [_text_batch(x0, emb, mask)], [_text_batch(x0, emb, mask)], log_validation_images=False, seed=0)
    for name, before in frozen.items():  # weight decay would have moved them
        torch.testing.assert_close(dict(model.named_parameters())[name].detach(), before, rtol=0, atol=0)
    entry = restore_checkpoint(tmp_path / "run" / "checkpoints" / "denoiser")
    assert set(entry["rest"]) == set(frozen) and not set(entry["params"]) & set(frozen)
    ema = restore_checkpoint(tmp_path / "run" / "checkpoints" / "ema")["params"]
    assert set(ema) == set(entry["params"])


# --- the sharded text-to-image data --------------------------------------------------


def _write_shards(writer_cls, path, seed, n_per_bucket=((4, 4), (3, 5)), buckets=((6, 6), (4, 8))):
    rng = np.random.default_rng(seed)
    with writer_cls(path, shard_size=3) as writer:
        i = 0
        for (h, w), (n, _) in zip(buckets, n_per_bucket):
            for _ in range(n):
                length = int(rng.integers(1, CONTEXT[0] + 1))
                writer.write({"vision_latents": rng.standard_normal((h, w, 4)).astype(np.float32),
                              "caption_embeddings": rng.standard_normal(CONTEXT).astype(np.float32),
                              "caption_mask": np.arange(CONTEXT[0]) < length,
                              "caption": f"sample {i}"})
                i += 1


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, list):
        assert a == list(b)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_sharded_text_data_reads_and_batches_like_the_reference(tmp_path):
    _write_shards(JaxShardedDatasetWriter, tmp_path / "jax", seed=1)
    _write_shards(ShardedDatasetWriter, tmp_path / "port", seed=1)
    # the JAX package's shards, read by the port, give what the port's own shards give
    ours, theirs = ShardedDataset(tmp_path / "jax"), ShardedDataset(tmp_path / "port")
    assert len(ours) == len(theirs) == 7 and ours.columns == theirs.columns
    for i in range(len(ours)):
        _tree_equal(ours[i], theirs[i])
    # ImageNetmultiAR + MultiARBatchSampler + collate_fn against the reference's, one seed
    ref_ds = jimagenet.ImageNetmultiAR(str(tmp_path / "jax"), cache_dir=tmp_path / "cache_jax")
    ds = ImageNetmultiAR(str(tmp_path / "jax"), cache_dir=tmp_path / "cache_port")
    for d in (ref_ds, ds):
        d.set_latent_scale(0.5)
        d.set_latent_bias(0.1)
    assert ds.buckets == ref_ds.buckets == {(6, 6): [0, 1, 2, 3], (4, 8): [4, 5, 6]}
    ref_sampler = jimagenet.MultiARBatchSampler(ref_ds, 2, seed=3)
    sampler = MultiARBatchSampler(ds, 2, seed=3)
    for epoch in range(2):
        ref_sampler.set_epoch(epoch)
        sampler.set_epoch(epoch)
        ref_order, order = list(ref_sampler), list(sampler)
        assert order == ref_order and len(sampler) == len(ref_sampler) == 4
        for idx in order:
            batch = collate_fn([ds[i] for i in idx])
            _tree_equal(batch, jimagenet.collate_fn([ref_ds[i] for i in idx]))
            assert batch["model_inputs"]["initial_context"] == [f"sample {i}" for i in idx]
            assert batch["model_inputs"]["context"]["attn_mask"].dtype == bool
    assert len(MultiARBatchSampler(ds, 2, drop_last=True)) == 3
    with pytest.raises(ValueError, match="Latent scale"):
        ImageNetmultiAR(str(tmp_path / "jax"), cache_dir=tmp_path / "cache_port")[0]


# --- the trainer end to end -------------------------------------------------------------


def test_base_trainer_trains_txt2img_end_to_end_on_cpu(tmp_path):
    """Two aspect-ratio buckets (584 and 520 tokens: the flash route), the
    Flux2 tower's decode for the validation images with their captions, the
    EMA validation loss and the best-val checkpoint."""
    _, tower = tower_pair(diffusers_vae_state_dict(**TINY_TOWER))
    channels = TINY_TOWER["latent_channels"] * 4
    embedder = PrecomputedEmbedder(null_embedding=null_embedding(), null_embedding_seq_len=NULL_SEQ_LEN, device="cpu")
    torch.manual_seed(0)
    model = MMDiT(**{**TINY_MM, "input_channels": channels}, context_embedder=embedder, device="cpu")
    rng = np.random.default_rng(10)
    with ShardedDatasetWriter(tmp_path / "data", shard_size=4) as writer:
        for i, (h, w) in enumerate([(24, 24)] * 4 + [(16, 32)] * 4):
            length = int(rng.integers(1, CONTEXT[0] + 1))
            writer.write({"vision_latents": rng.standard_normal((h, w, channels)).astype(np.float32),
                          "caption_embeddings": rng.standard_normal(CONTEXT).astype(np.float32),
                          "caption_mask": np.arange(CONTEXT[0]) < length, "caption": f"caption {i}"})
    ds = ImageNetmultiAR(str(tmp_path / "data"), cache_dir=tmp_path / "cache")
    ds.set_latent_scale(1.0)
    batches = [collate_fn([ds[i] for i in idx]) for idx in MultiARBatchSampler(ds, 2, seed=0)]
    assert sorted(b["model_inputs"]["x"].shape[1:3] for b in batches) == [(16, 32)] * 2 + [(24, 24)] * 2
    trainer = BaseTrainer(n_epoch=1, save_path=tmp_path, project_name="run", use_ema=True, device="cpu",
                          ema_update_every=1)
    logged = []
    trainer.tracker.log_images = lambda images, step, key="val/images", captions=None: logged.append(
        (images.shape, captions, float(images.min()), float(images.max())))
    diffuser = Diffuser(model, "euler", n_steps=4, vision_tower=tower, extra_args=EXTRA)
    trainer.train(diffuser, toptim.adamw(lr=1e-4, weight_decay=0.01), batches, batches[:1],
                  p_classifier_free_guidance=0.5, val_steps=2, val_step_shift=6.93, seed=0)
    assert trainer.step == 4
    run = tmp_path / "run"
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(r[key]) for r in rows for key in ("train/loss", "val/loss") if key in r)
    assert len([r for r in rows if "val/loss" in r]) == 1
    # the validation grid: 2 images decoded to pixels (f = 4) in [0, 1], with their captions
    h, w = batches[0]["model_inputs"]["x"].shape[1:3]
    assert len(logged) == 1
    shape, captions, lo, hi = logged[0]
    assert shape == (2, h * tower.compression_factor, w * tower.compression_factor, 3)
    assert captions == batches[0]["model_inputs"]["initial_context"] and 0.0 <= lo <= hi <= 1.0
    # the best-val checkpoint restores to the trained model
    entry = restore_checkpoint(run / "checkpoints" / "denoiser")
    saved = {**entry["params"], **entry["rest"]}
    assert set(saved) == set(model.state_dict())
    for name, tensor in model.state_dict().items():
        torch.testing.assert_close(saved[name], tensor, rtol=0, atol=0)
