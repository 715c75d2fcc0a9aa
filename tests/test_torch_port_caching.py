"""Delta-DiT block caching in the port (diffulab_tpu_torch.diffuse.caching,
``MMDiT`` ``cache_span``, ``Diffuser.set_block_cache``) against the JAX
package, on the simple DiT and on the dual-stream MMDiT.

- a refresh step is bit-exact with the uncached stack (atol 0), and its
  delta is non-trivial;
- a reuse step passes the cache through unchanged and, with the delta taken
  at the same input, gives the refresh step's output;
- a 6-step cached trajectory at interval 2 with fused CFG (and one with an
  autoguidance model, whose cache is the pair's second entry) equals the
  JAX package's at 1e-5 (max |port - JAX| over max |JAX|, fp32, the same
  bridged weights and start);
- ``set_block_cache(1)`` (or None) disables it, as in the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import (
    TINY,
    _randomize,
    context_inputs,
    port_mmdit,
    randomized_jax_mmdit,
    rel_err,
)
from flax import nnx

from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.networks.denoisers.mmdit import MMDiT as JaxMMDiT
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.weights import state_dict_from_jax

SHAPE = (2, 8, 8, 4)
DIT3 = dict(TINY, depth=3)
SPANS = {"dit": (1, 3), "mmdit": (0, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def dit_pair(seed: int = 3):
    jax_model = JaxMMDiT(**DIT3, rngs=nnx.Rngs(0))
    params = _randomize(jax_model, seed)
    model = MMDiT(**DIT3, device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return jax_model, model


def mmdit_pair(seed: int = 4):
    jax_model, params = randomized_jax_mmdit("fp32", seed=seed, patch_size=2)
    return jax_model, port_mmdit("fp32", params, patch_size=2)


def conds(kind: str, batch: int = SHAPE[0]):
    if kind == "dit":
        y = np.arange(batch) % TINY["n_classes"]
        return {"y": jnp.asarray(y)}, {"y": torch.from_numpy(y)}
    emb, mask = context_inputs(batch)
    return ({"context": {"embeddings": jnp.asarray(emb), "attn_mask": jnp.asarray(mask)}},
            {"context": {"embeddings": torch.from_numpy(emb), "attn_mask": torch.from_numpy(mask)}})


PAIRS = {"dit": dit_pair, "mmdit": mmdit_pair}


@pytest.mark.parametrize("kind", ["dit", "mmdit"])
def test_refresh_step_is_exact_and_reuse_passes_the_cache_through(kind):
    _, model = PAIRS[kind]()
    model.set_block_cache_span(SPANS[kind])
    _, cond = conds(kind)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32))
    t, drop = torch.tensor([0.3, 0.7]), torch.zeros(2, dtype=torch.bool)
    with torch.no_grad():
        plain = model(x, t, cond, drop)
        zeros = model.init_block_cache(SHAPE, cond, use_cfg=False)
        fresh = model(x, t, cond, drop, block_cache=zeros, cache_refresh=True)
        torch.testing.assert_close(fresh["x"], plain["x"], rtol=0, atol=0)
        assert len(fresh["block_cache"]) == len(zeros) == (1 if kind == "dit" else 2)
        assert all(a.shape == b.shape for a, b in zip(fresh["block_cache"], zeros))
        assert float(fresh["block_cache"][0].abs().max()) > 0
        reused = model(x, t, cond, drop, block_cache=fresh["block_cache"], cache_refresh=False)
        for a, b in zip(reused["block_cache"], fresh["block_cache"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(reused["x"], fresh["x"], rtol=1e-5, atol=1e-5)
        skipped = model(x, t, cond, drop, block_cache=zeros, cache_refresh=False)
        assert float((skipped["x"] - fresh["x"]).abs().max()) > 1e-6
    model.set_block_cache_span(None)
    assert model.cache_span is None
    with pytest.raises(ValueError, match="out of range"):
        model.set_block_cache_span((0, 4))


@pytest.mark.parametrize("kind,sampler", [("dit", "euler"), ("dit", "heun"), ("mmdit", "euler")])
def test_cached_trajectory_matches_jax(kind, sampler):
    jax_model, model = PAIRS[kind]()
    jcond, cond = conds(kind)
    x = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    jd = JaxDiffuser(jax_model, sampler, n_steps=6)
    jd.set_block_cache(2, span=SPANS[kind])
    ref = jd.generate(jax.random.key(0), jcond, x=jnp.asarray(x), guidance_scale=3.0,
                      return_intermediates=True)
    diffuser = Diffuser(model, sampler, n_steps=6)
    diffuser.set_block_cache(2, span=SPANS[kind])
    out = diffuser.generate(cond, x=torch.from_numpy(x), guidance_scale=3.0, device="cpu",
                            return_intermediates=True)
    assert rel_err(out["x"].numpy(), np.asarray(ref["x"])) < 1e-5
    assert rel_err(out["xt"].numpy(), np.asarray(ref["xt"])) < 1e-5
    # the uncached trajectory is another one, and its first (refresh) step is bit for bit the cached one's
    diffuser.set_block_cache(1)
    assert diffuser._block_cache is None and model.cache_span is None
    plain = diffuser.generate(cond, x=torch.from_numpy(x), guidance_scale=3.0, device="cpu",
                              return_intermediates=True)
    torch.testing.assert_close(plain["xt"][:, 1], out["xt"][:, 1], rtol=0, atol=0)
    assert float((plain["x"] - out["x"]).abs().max()) > 1e-6


def test_cached_autoguidance_matches_jax():
    """The guide model gets the denoiser's span and its own cache (the
    pair's second entry); the denoiser's cache is batch B, not 2B."""
    jax_model, model = dit_pair(3)
    jax_guide, guide = dit_pair(5)
    jcond, cond = conds("dit")
    x = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    jd = JaxDiffuser(jax_model, "euler", n_steps=6)
    jd.set_block_cache(2, span=SPANS["dit"])
    ref = jd.generate(jax.random.key(0), jcond, x=jnp.asarray(x), guidance_scale=2.0, guide_denoiser=jax_guide)
    diffuser = Diffuser(model, "euler", n_steps=6)
    diffuser.set_block_cache(2, span=SPANS["dit"])
    seen = []
    original = model.init_block_cache

    def recording(shape, c, use_cfg):
        seen.append(use_cfg)
        return original(shape, c, use_cfg)

    model.init_block_cache = recording
    out = diffuser.generate(cond, x=torch.from_numpy(x), guidance_scale=2.0, guide_denoiser=guide, device="cpu")
    assert seen == [False] and guide.cache_span == SPANS["dit"]
    assert rel_err(out["x"].numpy(), np.asarray(ref["x"])) < 1e-5


def test_set_block_cache_guards():
    _, model = dit_pair()
    diffuser = Diffuser(model, "euler", n_steps=4)
    with pytest.raises(ValueError, match="span"):
        diffuser.set_block_cache(2)
    diffuser.set_block_cache(3, span=(0, 2))
    assert diffuser._block_cache == {"interval": 3, "span": (0, 2)} and model.cache_span == (0, 2)
    diffuser.set_block_cache(None)
    assert diffuser._block_cache is None and model.cache_span is None
