"""Shared set-up of the port's parity tests: a small JAX DiT with every
parameter overwritten by seeded numpy noise, and its port twin.

The reference's Modulation layers are zero-initialised (adaLN-zero), so on
fresh weights every block adds exactly nothing and a parity test would see
only patchify and the last layer (trap T9). Every parameter is therefore
replaced before the weights are bridged.
"""

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from diffulab_tpu.networks.denoisers.mmdit import MMDiT as JaxMMDiT
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.weights import state_dict_from_jax

#: depth 2, inner dim 64, 4 heads of 16, patch 2 on 8x8x4 latents (16 tokens)
TINY = dict(simple_dit=True, input_channels=4, inner_dim=64, embedding_dim=64, num_heads=4,
            mlp_ratio=4, patch_size=2, depth=2, n_classes=10, classifier_free=True)
LATENT = (8, 8, 4)

#: precision policies: fp32, the bench's whole-model bf16 cast, and the
#: library's mixed default (bf16 matmuls, fp32 conditioning and stream)
POLICIES = {
    "fp32": (dict(), dict()),
    "bf16_full": (dict(dtype=jnp.bfloat16, stable_conditioning=False, stream_dtype=jnp.bfloat16),
                  dict(dtype=torch.bfloat16, stable_conditioning=False, stream_dtype=torch.bfloat16)),
    "bf16_mixed": (dict(dtype=jnp.bfloat16), dict(dtype=torch.bfloat16)),
}


def _noise(path: str, shape, rng: np.random.Generator) -> np.ndarray:
    if path.endswith("kernel"):
        fan_in = int(np.prod(shape[:-1]))
        return rng.standard_normal(shape) * fan_in ** -0.5
    if path.endswith("scale"):
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if path.endswith("bias"):
        return 0.1 * rng.standard_normal(shape)
    return rng.standard_normal(shape)


def randomized_jax_model(policy: str, seed: int = 0):
    """The tiny JAX DiT with all parameters replaced; returns (model, {path: array})."""
    model = JaxMMDiT(**TINY, **POLICIES[policy][0], rngs=nnx.Rngs(0))
    rng = np.random.default_rng(seed)
    flat = []
    params = {}
    for path, var in nnx.state(model, nnx.Param).flat_state():
        key = "/".join(str(p) for p in path)
        value = _noise(key, np.shape(var.get_value()), rng).astype(np.float32)
        params[key] = value
        flat.append((path, var.replace(jnp.asarray(value))))
    nnx.update(model, nnx.State.from_flat_path(flat))
    return model, params


def port_model(policy: str, params: dict) -> MMDiT:
    model = MMDiT(**TINY, **POLICIES[policy][1], device="cpu")
    missing, unexpected = model.load_state_dict(state_dict_from_jax(params), strict=True)
    assert not missing and not unexpected
    return model


def rel_err(ours: np.ndarray, ref: np.ndarray) -> float:
    """max |ours - ref| over max |ref|."""
    return float(np.max(np.abs(ours - ref)) / np.max(np.abs(ref)))
