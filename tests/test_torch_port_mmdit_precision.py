"""The MMDiT's per-component precision overrides (``attention_dtype``,
``mlp_dtype``; diffulab_tpu/networks/denoisers/mmdit.py:248-334, :443-454)
against the JAX MMDiT, with bridged weights overwritten by seeded noise
(trap T9): bf16 blocks with fp32 attention, and fp32 blocks with a bf16 MLP,
on the simple DiT and on the multimodal MMDiT (whose single-stream blocks
take the block dtype, as the reference's do). The ``"float32"`` string of a
YAML config is accepted, and ``model.attention_dtype=float32`` composes and
builds through the port's config layer as through the JAX one. Forward
outputs within rel 4e-2 (max |port - JAX| over max |JAX|), the tolerance of
``tests/test_torch_port_dit.py`` for bf16 blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import LATENT, TINY, _randomize, context_inputs, port_mmdit, randomized_jax_mmdit, rel_err
from flax import nnx

from diffulab_tpu.config.compose import compose_config as jax_compose
from diffulab_tpu.networks.denoisers.mmdit import MMDiT as JaxMMDiT
from diffulab_tpu_torch.config import compose_config, instantiate
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.weights import state_dict_from_jax

REL_TOL = 4e-2
#: (JAX kwargs, port kwargs): bf16 blocks with fp32 attention, fp32 blocks with a bf16 MLP
OVERRIDES = {
    "bf16_blocks_fp32_attention": (dict(dtype=jnp.bfloat16, attention_dtype="float32"),
                                   dict(dtype=torch.bfloat16, attention_dtype="float32")),
    "fp32_blocks_bf16_mlp": (dict(mlp_dtype="bfloat16"), dict(mlp_dtype="bfloat16")),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_dit_precision_overrides_match_jax(case):
    jkw, tkw = OVERRIDES[case]
    jax_model = JaxMMDiT(**TINY, **jkw, rngs=nnx.Rngs(0))
    params = _randomize(jax_model, 3)
    model = MMDiT(**TINY, **tkw, device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    block = model.layers[0]
    want_attn = torch.float32 if "attention" in case else None
    want_mlp = torch.bfloat16 if "mlp" in case else tkw.get("dtype")
    assert block.attention.kernel_dtype == want_attn and block.attention.qkv.dtype == want_attn
    assert block.mlp_input.fc_in.dtype == want_mlp
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, *LATENT)).astype(np.float32)
    t, y, drop = rng.uniform(size=3).astype(np.float32), rng.integers(0, 10, 3), np.array([False, True, False])
    xdt = (jnp.bfloat16, torch.bfloat16) if "dtype" in tkw else (jnp.float32, torch.float32)
    ref = jax_model(jnp.asarray(x, xdt[0]), jnp.asarray(t), {"y": jnp.asarray(y)}, jnp.asarray(drop))["x"]
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(xdt[1]), torch.from_numpy(t), {"y": torch.from_numpy(y)},
                    torch.from_numpy(drop))["x"]
    assert rel_err(out.float().numpy(), np.asarray(ref, np.float32)) < REL_TOL


def test_multimodal_mmdit_fp32_attention_over_bf16_blocks_matches_jax():
    kwargs = dict(attention_dtype="float32")
    jax_model, params = randomized_jax_mmdit("bf16_mixed", 5, **kwargs)
    model = port_mmdit("bf16_mixed", params, **kwargs)
    dual, single = model.layers[0], model.layers[-1]
    assert dual.attention.kernel_dtype == torch.float32 and dual.mlp_input.fc_in.dtype == torch.bfloat16
    assert single.attention.kernel_dtype == torch.bfloat16  # the single-stream blocks take no override
    emb, mask = context_inputs(2)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t, drop = rng.uniform(size=2).astype(np.float32), np.array([False, True])
    jcond = {"context": {"embeddings": jnp.asarray(emb), "attn_mask": jnp.asarray(mask)}}
    tcond = {"context": {"embeddings": torch.from_numpy(emb), "attn_mask": torch.from_numpy(mask)}}
    ref = jax_model(jnp.asarray(x, jnp.bfloat16), jnp.asarray(t), jcond, jnp.asarray(drop))["x"]
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(t), tcond, torch.from_numpy(drop))["x"]
    assert rel_err(out.float().numpy(), np.asarray(ref, np.float32)) < REL_TOL


def test_attention_dtype_override_composes_and_builds():
    from diffulab_tpu_torch.examples.train_diffusion import CONFIG_DIR

    overrides = ["model.attention_dtype=float32", "model.depth=2", "model.inner_dim=64", "model.embedding_dim=64",
                 "model.num_heads=4"]
    cfg = compose_config(CONFIG_DIR, "train_synthetic_flow_matching", overrides)
    assert cfg == jax_compose(CONFIG_DIR, "train_synthetic_flow_matching", overrides)
    assert cfg["model"]["attention_dtype"] == "float32"
    model = instantiate(cfg["model"], device="cpu", dtype=torch.bfloat16)
    assert all(block.attention.kernel_dtype == torch.float32 for block in model.layers)
    assert all(block.mlp_input.fc_in.dtype == torch.bfloat16 for block in model.layers)
