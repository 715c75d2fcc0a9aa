"""The trainable byte-level text embedder in the port against the JAX
package (``networks/embedders/trainable.py``, ``networks/nn.py``'s 1-D
RoPE, the trainer's ``train_embedder`` path), on the CPU.

- ``rope_1d_cos_sin`` / ``apply_rope_1d`` at rel 1e-6 (fp32).
- ``byte_tokenize`` equal to the JAX tokenizer on ASCII, UTF-8, empty and
  truncated captions.
- ``TrainableTextEmbedder`` with bridged noise weights (``tok_embed/embedding``
  through the bridge's ``*/embedding`` rule): the embeddings and the pooled
  embeddings of a batch with padding and a dropped sample within rel 1e-5,
  and the gradients of a weighted sum within rel 1e-4; a dropped row
  equals the empty prompt's encoding.
- A tiny multimodal MMDiT conditioned through the embedder: the flow loss
  with injected t, noise and drop (one sample dropped) within rel 1e-5 and
  every gradient, the embedder's among them, within rel 1e-4 of ``jax.grad``.
- ``BaseTrainer._host_embed``: the embedder's tokens replace a precomputed
  ``context`` the shards carry (as ``tests/test_trainable_embedder.py``
  pins for the JAX package), the same arrays as the JAX trainer's.
- ``BaseTrainer.train`` with ``train_embedder`` on and off: the encoder
  trains and its parameters are in the checkpoint's ``params`` (and
  ``restore_train_modules(train_embedder=True)`` restores the run's EMA
  entry, which the default split refuses), or it stays bit-identical,
  takes no gradient and rides in ``rest``.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import TINY_MM, _randomize, rel_err
from flax import nnx

from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.networks import nn as jnn
from diffulab_tpu.networks.denoisers.mmdit import MMDiT as JaxMMDiT
from diffulab_tpu.networks.embedders.trainable import TrainableTextEmbedder as JaxEmbedder
from diffulab_tpu.networks.embedders.trainable import byte_tokenize as jax_byte_tokenize
from diffulab_tpu.training.trainer import BaseTrainer as JaxBaseTrainer
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.networks import nn as tnn
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.networks.embedders import TrainableTextEmbedder, byte_tokenize
from diffulab_tpu_torch.training import optim as toptim
from diffulab_tpu_torch.training.checkpoint import restore_checkpoint, restore_train_modules
from diffulab_tpu_torch.training.trainer import BaseTrainer
from diffulab_tpu_torch.weights import state_dict_from_jax

#: dim 32, 2 blocks of 2 heads (head dim 16), 16 byte tokens
EMB = dict(dim=32, depth=2, num_heads=2, max_len=16)
CAPTIONS = ["a red square", "two blue rings on a dark background", "", "ok"]
DROP = np.array([False, True, False, False])
LATENT = (8, 8, 4)
EXTRA = {"logits_normal": True, "shift": 4.63}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)


def _flat(tree) -> dict[str, np.ndarray]:
    return {"/".join(str(p) for p in path): np.asarray(v.get_value(), np.float32) for path, v in tree.flat_state()}


def _pair(pooled: bool = False, seed: int = 0):
    jax_emb = JaxEmbedder(**EMB, pooled=pooled, rngs=nnx.Rngs(0))
    params = _randomize(jax_emb, seed)
    emb = TrainableTextEmbedder(**EMB, pooled=pooled, device="cpu")
    emb.load_state_dict(state_dict_from_jax(params, emb), strict=True)
    return jax_emb, emb


def _context(tokens: dict, torch_side: bool):
    if torch_side:
        return {k: torch.from_numpy(v) for k, v in tokens.items()}
    return {k: jnp.asarray(v) for k, v in tokens.items()}


def test_rope_1d_matches_jax():
    rng = np.random.default_rng(0)
    q, k = (rng.standard_normal((2, 16, 2, 16)).astype(np.float32) for _ in range(2))
    jcos, jsin = jnn.rope_1d_cos_sin(16, 12)
    cos, sin = tnn.rope_1d_cos_sin(16, 12)
    assert rel_err(cos.numpy(), np.asarray(jcos)) < 1e-6 and rel_err(sin.numpy(), np.asarray(jsin)) < 1e-6
    jq, jk = jnn.apply_rope_1d(jnp.asarray(q), jnp.asarray(k), jcos, jsin, 12)  # the last 4 channels pass
    tq, tk = tnn.apply_rope_1d(torch.from_numpy(q), torch.from_numpy(k), cos, sin, 12)
    assert rel_err(tq.numpy(), np.asarray(jq)) < 1e-6 and rel_err(tk.numpy(), np.asarray(jk)) < 1e-6
    np.testing.assert_array_equal(tq.numpy()[..., 12:], q[..., 12:])


@pytest.mark.parametrize("max_len", [16, 4])
def test_byte_tokenize_equals_jax(max_len):
    texts = CAPTIONS + ["héllo wörld ✓", "x" * 40]
    ours, ref = byte_tokenize(texts, max_len), jax_byte_tokenize(texts, max_len)
    for key in ("token_ids", "attn_mask"):
        assert ours[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(ours[key], ref[key])


@pytest.mark.parametrize("pooled", [False, True], ids=["tokens", "pooled"])
def test_embedder_forward_and_gradients_match_jax(pooled):
    jax_emb, emb = _pair(pooled, seed=1)
    tokens = byte_tokenize(CAPTIONS, EMB["max_len"])
    drop = DROP
    ref = jax_emb(_context(tokens, False), jnp.asarray(drop))
    out = emb(_context(tokens, True), torch.from_numpy(drop))
    keys = ["embeddings"] + (["pooled_embeddings"] if pooled else [])
    for key in keys:
        assert rel_err(out[key].detach().numpy(), np.asarray(ref[key])) < 1e-5, key
    np.testing.assert_array_equal(out["attn_mask"].numpy(), np.asarray(ref["attn_mask"]))
    assert out["attn_mask"][1].tolist() == [True] + [False] * (EMB["max_len"] - 1)  # the BOS-only prompt

    # gradients of a weighted sum of the outputs
    rng = np.random.default_rng(2)
    weights = {key: rng.standard_normal(np.shape(ref[key])).astype(np.float32) for key in keys}
    graphdef, params, rest = nnx.split(jax_emb, nnx.Param, ...)

    def loss_fn(params):
        o = nnx.merge(graphdef, params, rest)(_context(tokens, False), jnp.asarray(drop))
        return sum(jnp.sum(o[key] * weights[key]) for key in keys)

    ref_grads = state_dict_from_jax(_flat(jax.jit(jax.grad(loss_fn))(params)), emb)
    sum((out[key] * torch.from_numpy(weights[key])).sum() for key in keys).backward()
    for name, p in emb.named_parameters():
        assert p.grad is not None, name
        assert rel_err(p.grad.numpy(), ref_grads[name].numpy()) < 1e-4, name


def test_dropped_row_is_the_empty_prompt():
    _, emb = _pair(seed=3)
    with torch.no_grad():
        dropped = emb(_context(byte_tokenize(CAPTIONS, EMB["max_len"]), True), torch.from_numpy(DROP))
        null = emb(_context(byte_tokenize([""], EMB["max_len"]), True))
        kept = emb(_context(byte_tokenize(CAPTIONS[:1], EMB["max_len"]), True))
    torch.testing.assert_close(dropped["embeddings"][1], null["embeddings"][0], rtol=0, atol=1e-6)
    torch.testing.assert_close(dropped["embeddings"][0], kept["embeddings"][0], rtol=0, atol=1e-6)


def _mmdit_pair(seed: int):
    jax_model = JaxMMDiT(**TINY_MM, context_embedder=JaxEmbedder(**EMB, rngs=nnx.Rngs(0)), rngs=nnx.Rngs(0))
    params = _randomize(jax_model, seed)
    model = MMDiT(**TINY_MM, context_embedder=TrainableTextEmbedder(**EMB, device="cpu"), device="cpu")
    model.load_state_dict(state_dict_from_jax(params, model), strict=True)
    return jax_model, model


def test_mmdit_loss_and_gradients_through_the_embedder_match_jax():
    jax_model, model = _mmdit_pair(seed=4)
    rng = np.random.default_rng(5)
    b = len(CAPTIONS)
    x0 = rng.standard_normal((b, *LATENT)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, b).astype(np.float32)
    noise = rng.standard_normal((b, *LATENT)).astype(np.float32)
    tokens = byte_tokenize(CAPTIONS, EMB["max_len"])

    jdiffuser = JaxDiffuser(jax_model, "euler", n_steps=4, extra_args=EXTRA)
    graphdef, params, rest = nnx.split(jax_model, nnx.Param, ...)

    def loss_fn(params):
        m = nnx.merge(graphdef, params, rest)
        return jdiffuser.diffusion.compute_loss(lambda **kw: m(**kw, train=True), jnp.asarray(x0),
                                                {"context": _context(tokens, False)}, jnp.asarray(t),
                                                jnp.asarray(noise), drop=jnp.asarray(DROP))["loss"]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    ref = state_dict_from_jax(_flat(ref_grads), model)
    loss = Diffuser(model, "euler", n_steps=4, extra_args=EXTRA).compute_loss(
        torch.from_numpy(x0), {"context": _context(tokens, True)}, torch.from_numpy(t), noise=torch.from_numpy(noise),
        drop=torch.from_numpy(DROP))["loss"]
    loss.backward()
    assert abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)) < 1e-5
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(grads) == set(ref) and any(name.startswith("context_embedder.") for name in grads)
    for name, g in grads.items():
        assert g is not None, name
        assert rel_err(g.numpy(), ref[name].numpy()) < 1e-4, name


def test_tokens_replace_a_precomputed_context_like_jax():
    """With the trainable embedder the tokenizer takes precedence over the
    shards' precomputed embeddings (trainer.py:424-429)."""
    jax_model, model = _mmdit_pair(seed=6)
    batch = {"model_inputs": {"x": np.zeros((2, *LATENT), np.float32), "initial_context": CAPTIONS[:2],
                              "context": {"embeddings": np.ones((2, 8, 32), np.float32)}}}
    ours = BaseTrainer._host_embed(batch, Diffuser(model, "euler", n_steps=4))["model_inputs"]["context"]
    ref = JaxBaseTrainer._host_embed(batch, JaxDiffuser(jax_model, "euler", n_steps=4))["model_inputs"]["context"]
    assert set(ours) == set(ref) == {"token_ids", "attn_mask"}
    for key in ours:
        np.testing.assert_array_equal(ours[key], ref[key])


def _text_batches(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [{"model_inputs": {"x": torch.from_numpy(rng.standard_normal((2, *LATENT)).astype(np.float32)),
                              "initial_context": CAPTIONS[2 * (i % 2): 2 * (i % 2) + 2],
                              "context": {"embeddings": torch.ones(2, 8, 32)}}} for i in range(n)]


@pytest.mark.parametrize("train_embedder", [True, False], ids=["trained", "frozen"])
def test_train_embedder_trains_the_encoder_or_leaves_it_bit_identical(tmp_path, train_embedder):
    _, model = _mmdit_pair(seed=7)
    before = {n: p.detach().clone() for n, p in model.named_parameters() if n.startswith("context_embedder.")}
    trainer = BaseTrainer(n_epoch=1, save_path=tmp_path, project_name="run", use_ema=True, device="cpu",
                          ema_update_every=1)
    trainer.train(Diffuser(model, "euler", n_steps=2, extra_args=EXTRA), toptim.adamw(lr=1e-2, weight_decay=0.1),
                  _text_batches(3, 8), _text_batches(1, 9), log_validation_images=False,
                  p_classifier_free_guidance=0.5, train_embedder=train_embedder, seed=0)
    after = dict(model.named_parameters())
    changed = {n for n, b in before.items() if not torch.equal(after[n].detach(), b)}
    entry = restore_checkpoint(tmp_path / "run" / "checkpoints" / "denoiser")
    if train_embedder:
        assert changed == set(before)
        assert set(before) <= set(entry["params"]) and not set(before) & set(entry["rest"])
        for name in before:
            torch.testing.assert_close(entry["params"][name], after[name].detach(), rtol=0, atol=0)
        # the run's split restores its EMA entry; the default split (the sampling CLIs') does not match it
        ema = tmp_path / "run" / "checkpoints" / "ema"
        fresh = MMDiT(**TINY_MM, context_embedder=TrainableTextEmbedder(**EMB, device="cpu"), device="cpu")
        restore_train_modules(ema, fresh, train_embedder=True)
        restored = dict(fresh.named_parameters())
        for name, value in restore_checkpoint(ema)["params"].items():
            torch.testing.assert_close(restored[name].detach(), value, rtol=0, atol=0)
        with pytest.raises(ValueError, match="keys differ"):
            restore_train_modules(ema, fresh)
    else:
        assert not changed and all(after[n].grad is None for n in before)
        assert set(before) <= set(entry["rest"]) and not set(before) & set(entry["params"])
