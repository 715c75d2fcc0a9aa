"""``_target_``-based object instantiation (port of
diffulab_tpu/config/instantiate.py; a hydra.utils.instantiate subset).

Supported keys: ``_target_`` (dotted import path), ``_partial_`` (return
functools.partial instead of calling), ``_args_`` (positional args). Nested
dicts/lists are instantiated recursively.

The configs under ``configs/`` name the JAX package (``diffulab_tpu.…``);
:func:`locate` remaps that prefix to ``diffulab_tpu_torch.…``. A target the
port does not have yet, and any JAX-side library (``jax``, ``flax``,
``optax``, ``orbax``), raises ``NotImplementedError`` naming the target.
"""

from __future__ import annotations

import functools
import importlib
from typing import Any

import torch

_JAX_PACKAGE = "diffulab_tpu"
_PORT_PACKAGE = "diffulab_tpu_torch"
_JAX_LIBRARIES = ("jax", "jaxlib", "flax", "optax", "orbax")


def port_path(path: str) -> str:
    """``diffulab_tpu.x.y`` -> ``diffulab_tpu_torch.x.y``; other paths unchanged."""
    head, _, rest = path.partition(".")
    return f"{_PORT_PACKAGE}.{rest}" if head == _JAX_PACKAGE else path


def _import(module: str) -> Any | None:
    """The module, or None when it (or a parent package) does not exist. An
    import error raised from inside an existing module propagates."""
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name is not None and (module == e.name or module.startswith(e.name + ".")):
            return None
        raise


def _resolve(path: str) -> Any | None:
    parts = path.split(".")
    for split in range(len(parts) - 1, 0, -1):
        module = _import(".".join(parts[:split]))
        if module is None:
            continue
        obj = module
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError:
            continue
        return obj
    return None


def locate(path: str) -> Any:
    """The object a config's ``_target_`` names, in the port."""
    if path.split(".")[0] in _JAX_LIBRARIES:
        raise NotImplementedError(
            f"{path!r}: the port imports no JAX-side library; its torch counterpart is not ported "
            "(ROADMAP queue 1)"
        )
    target = port_path(path)
    obj = _resolve(target)
    if obj is not None:
        return obj
    if target != path:
        raise NotImplementedError(f"{path!r} ({target}) is not ported yet (ROADMAP queue 1)")
    raise ImportError(f"cannot locate {path!r}")


def instantiate(cfg: Any, /, **kwargs: Any) -> Any:
    if isinstance(cfg, list):
        return [instantiate(v) for v in cfg]
    if not isinstance(cfg, dict):
        return cfg
    if "_target_" not in cfg:
        return {k: instantiate(v) for k, v in cfg.items()}

    cfg = dict(cfg)
    target = locate(cfg.pop("_target_"))
    partial = cfg.pop("_partial_", False)
    args = [instantiate(a) for a in cfg.pop("_args_", [])]
    call_kwargs = {k: instantiate(v) for k, v in cfg.items()}
    call_kwargs.update(kwargs)
    if partial:
        return functools.partial(target, *args, **call_kwargs)
    return target(*args, **call_kwargs)


def model_dtype_kwargs(trainer_cfg) -> dict:
    """bf16 mixed precision = construct the model with compute dtype bf16
    (fp32 master params are the param_dtype default). The trainer's
    ``precision_type`` knob selects it; anything else runs full fp32."""
    if trainer_cfg.get("precision_type") == "bf16":
        return {"dtype": torch.bfloat16}
    return {}
