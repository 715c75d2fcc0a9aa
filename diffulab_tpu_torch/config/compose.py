"""Hydra-style YAML config composition (port of
diffulab_tpu/config/compose.py; no hydra dependency).

Supports the subset of Hydra the config tree under ``configs/`` uses:
- a ``defaults:`` list of ``{group: name}`` entries loading
  ``<config_dir>/<group>/<name>.yaml`` into ``cfg[group]`` (with ``group: null``
  skipped), plus the ``_self_`` marker controlling merge order;
- deep-merging of the experiment file's own overrides;
- CLI dotlist overrides (``trainer.n_epoch=5``, values YAML-parsed;
  ``group=name`` swaps a defaults-group selection when the group dir exists).

``hydra:`` blocks (run-dir templating) are accepted and ignored. The
composed dict is the JAX package's, key for key: ``_target_`` paths still
name ``diffulab_tpu.…``, which :func:`~diffulab_tpu_torch.config.instantiate.instantiate`
remaps to the port.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any

import yaml

# YAML 1.1 (pyyaml) requires a dot/sign for scientific floats, so "1e-8" loads
# as a *string*; hydra/OmegaConf coerce it. Match that behavior.
_SCI_FLOAT = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _coerce_numbers(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _coerce_numbers(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_coerce_numbers(v) for v in node]
    if isinstance(node, str) and _SCI_FLOAT.match(node):
        return float(node)
    return node


def load_yaml(path: str | Path) -> dict[str, Any]:
    with open(path) as f:
        return _coerce_numbers(yaml.safe_load(f) or {})


def deep_merge(base: dict[str, Any], override: dict[str, Any]) -> dict[str, Any]:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _set_dotted(cfg: dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        # a null placeholder (e.g. `lr_scheduler: null`) becomes a dict when
        # the CLI sets nested keys under it (hydra allows the same)
        if not isinstance(node.get(k), dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def compose_config(
    config_dir: str | Path,
    config_name: str,
    overrides: list[str] | None = None,
) -> dict[str, Any]:
    config_dir = Path(config_dir)
    name = config_name if config_name.endswith(".yaml") else config_name + ".yaml"
    raw = load_yaml(config_dir / name)
    raw.pop("hydra", None)

    defaults = raw.pop("defaults", [])
    overrides = list(overrides or [])

    # group=name CLI overrides swap defaults selections
    group_overrides: dict[str, str] = {}
    dot_overrides: list[tuple[str, Any]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, _, val = ov.partition("=")
        parsed = _coerce_numbers(yaml.safe_load(val))
        if "." not in key and (config_dir / key).is_dir():
            group_overrides[key] = str(parsed)
        else:
            dot_overrides.append((key, parsed))

    cfg: dict[str, Any] = {}
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            cfg = deep_merge(cfg, raw)
            self_merged = True
            continue
        if not (isinstance(entry, dict) and len(entry) == 1):
            raise ValueError(f"bad defaults entry: {entry}")
        group, sel = next(iter(entry.items()))
        sel = group_overrides.pop(group, sel)
        if sel is None:
            continue
        group_cfg = load_yaml(config_dir / group / f"{sel}.yaml")
        cfg = deep_merge(cfg, {group: group_cfg})
    if not self_merged:
        cfg = deep_merge(cfg, raw)
    for group, sel in group_overrides.items():
        cfg = deep_merge(cfg, {group: load_yaml(config_dir / group / f"{sel}.yaml")})

    for key, value in dot_overrides:
        _set_dotted(cfg, key, value)
    return cfg
