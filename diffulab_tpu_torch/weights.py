"""Weight bridge from the JAX package's parameters to the port's modules.

:func:`state_dict_from_jax` takes the JAX model's parameters as a flat dict of
numpy arrays keyed by the ``/``-joined ``nnx.state(model, nnx.Param)`` paths
(e.g. ``layers/0/attention/qkv/kernel``) and returns the port model's
``state_dict``. The port names its modules after the reference's paths, so
the mapping is by leaf name only:

- ``*/kernel`` of rank 2 ``[in, out]`` -> Linear ``weight`` ``[out, in]``;
- ``*/kernel`` of rank 4 (HWIO conv) -> ``weight`` OIHW;
- ``*/bias`` -> ``bias``;
- ``*/norm/scale`` (an ``nnx.LayerNorm`` named ``norm``) -> ``norm.weight``;
  other ``*/scale`` (RMSNorm, GroupNorm) stay ``scale``;
- ``*/embedding`` (an ``nnx.Embed``: the label table ``embedding/embedding``,
  the trainable text embedder's ``tok_embed/embedding``) -> ``*.weight``;
- the bare arrays (the ViTs' ``cls_token``, ``register_tokens``,
  ``pos_embed``, ``ls1``, ``ls2``; SprintDiT's ``mask_token``; the Perceiver
  resampler's ``latents``; the LoRA and DoRA adapters' ``lora_a`` ``[in, r]``,
  ``lora_b`` ``[r, out]`` and ``magnitude``) keep their name and layout; a
  wrapped Linear's ``*/base_module/kernel`` (LoRA) or ``*/base/kernel``
  (DoRA) is a kernel like any other (:mod:`.training.lora` keeps those
  paths).

The DINOv3 ViT, the Perceiver resampler and DC-AE map by these rules too:
their LayerNorms named ``norm1``, ``norm_x``... and DC-AE's
``ChannelRMSNorm`` (``scale``, ``bias``) need the port ``module`` (below),
and a depthwise conv's HWIO kernel ``[k, k, 1, C]`` becomes ``[C, 1, k, k]``.

A JAX ``RepaLoss`` maps the same way (its projector ``proj_fc*``, its frozen
encoder under ``repa_encoder/_encoder/``), and so does the trainer's
``_TrainModules`` tree ``{denoiser/..., extra_losses/<i>/...}``: the port's
:class:`~diffulab_tpu_torch.training.checkpoint.TrainModules` has those module
paths.

The name alone cannot tell a LayerNorm named ``norm`` from a GroupNorm named
``norm`` (the VAE's mid attention, ``mid_attn/norm/scale``; trap T16): pass
the port ``module`` and each ``scale`` goes to whichever of ``scale`` and
``weight`` that module has.

A gradient tree of the JAX model (``jax.grad`` with respect to
``nnx.state(model, nnx.Param)``) has the same paths and the same layouts, so
the same mapping bridges it to the port's ``param.grad`` by name; the parity
tests compare gradients that way.
"""

from __future__ import annotations

import numpy as np
import torch


#: parameters held as a bare array, the same layout on both sides (the ViTs' tokens and LayerScale,
#: SprintDiT's mask token, the Perceiver resampler's latents, the LoRA/DoRA adapters)
_PLAIN_LEAVES = frozenset({"cls_token", "register_tokens", "pos_embed", "ls1", "ls2", "mask_token", "latents",
                           "lora_a", "lora_b", "magnitude"})


def _torch_key(path: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    parts = path.split("/")
    leaf = parts[-1]
    if leaf == "kernel":
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"unexpected kernel rank {value.ndim} at {path}")
        parts[-1] = "weight"
    elif leaf == "scale" and len(parts) > 1 and parts[-2] == "norm":
        parts[-1] = "weight"
    elif leaf == "embedding" and len(parts) > 1:
        parts[-1] = "weight"
    elif leaf not in ("bias", "scale") and leaf not in _PLAIN_LEAVES:
        raise ValueError(f"no port mapping for parameter {path}")
    return ".".join(parts), value


def state_dict_from_jax(params: dict[str, np.ndarray],
                        module: torch.nn.Module | None = None) -> dict[str, torch.Tensor]:
    """Map a flat ``{path: array}`` JAX parameter dict to a torch state dict
    (float arrays keep their dtype; load with ``strict=True``). With
    ``module``, a ``*/scale`` leaf is named after the parameter that module
    has at that place (``scale`` or ``weight``)."""
    names = None if module is None else set(module.state_dict())
    out: dict[str, torch.Tensor] = {}
    for path, value in params.items():
        key, arr = _torch_key(path, np.asarray(value))
        if names is not None and path.endswith("/scale") and key not in names:
            stem = key.rsplit(".", 1)[0]
            key = next((f"{stem}.{leaf}" for leaf in ("scale", "weight") if f"{stem}.{leaf}" in names), key)
        out[key] = torch.from_numpy(np.array(arr))  # a writable copy
    return out


def copy_checked_(param: torch.Tensor, value: np.ndarray, name: str) -> None:
    """Copy a checkpoint array (a torch layout) into ``param``, cast to its
    dtype; a shape that differs raises, naming the entry (the checkpoint
    loaders of the DINO ViTs and DC-AE)."""
    value = torch.as_tensor(np.asarray(value, np.float32))
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"{name}: {tuple(param.shape)} vs {tuple(value.shape)}")
    with torch.no_grad():
        param.copy_(value.to(param.dtype))
