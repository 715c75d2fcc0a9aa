"""Hydra-style multirun sweeps (port of diffulab_tpu/config/sweep.py).

With ``--sweep``, every override whose value contains TOP-LEVEL commas
(commas inside ``[...]``/quotes stay list/string syntax, e.g.
``cache_span=[2, 10]`` or ``"model.channel_mult=1, 2"``) becomes a choice
axis, and the cartesian product of all axes yields N sequential runs, each
tagged with its concrete choices (the tag templates the run dir via
``trainer.project_name``).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable

from diffulab_tpu_torch.config.compose import compose_config


def split_top_level_commas(value: str) -> list[str]:
    """Split on commas not nested inside brackets, braces, or quotes."""
    parts: list[str] = []
    buf: list[str] = []
    depth = 0
    quote: str | None = None
    for ch in value:
        if quote:
            buf.append(ch)
            if ch == quote:
                quote = None
            continue
        if ch in "\"'":
            quote = ch
            buf.append(ch)
        elif ch in "[{(":
            depth += 1
            buf.append(ch)
        elif ch in "]})":
            depth -= 1
            buf.append(ch)
        elif ch == "," and depth == 0:
            parts.append("".join(buf).strip())
            buf = []
        else:
            buf.append(ch)
    parts.append("".join(buf).strip())
    return parts


def expand_sweep(overrides: list[str]) -> list[tuple[list[str], str]]:
    """Expand choice axes into the cartesian product of concrete runs.

    Returns ``[(concrete_overrides, tag), ...]`` in hydra's order (last axis
    varies fastest). ``tag`` is empty for a single run, else
    ``"key=val,key2=val2"`` over the swept axes only.
    """
    axes: list[list[str]] = []  # per-override candidate values
    swept: list[int] = []
    for i, ov in enumerate(overrides):
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, _, val = ov.partition("=")
        choices = split_top_level_commas(val)
        axes.append([f"{key}={c}" for c in choices])
        if len(choices) > 1:
            swept.append(i)
    runs: list[tuple[list[str], str]] = []
    for combo in itertools.product(*axes) if axes else [()]:
        concrete = list(combo)
        tag = ",".join(concrete[i] for i in swept)
        runs.append((concrete, tag))
    return runs


def tag_to_dirname(tag: str) -> str:
    """Make a sweep tag filesystem-safe (a readable ``key=val`` slug)."""
    out = tag.replace("/", ".").replace(" ", "")
    for ch in "[]{}()\"'":
        out = out.replace(ch, "")
    return out


def dispatch(args, run_one: Callable[[dict, int], Any]) -> list[Any]:
    """Shared CLI entry: run ``run_one(cfg, seed)`` once per sweep
    combination (``--sweep``), or once on the composed config without it.
    Each combination's tag templates the run dir via
    ``trainer.project_name``. Returns what each run returned."""
    if not getattr(args, "sweep", False):
        return [run_one(compose_config(args.config_dir, args.config_name, args.overrides), args.seed)]
    runs = expand_sweep(args.overrides)
    print(f"sweep: {len(runs)} runs")
    results = []
    for i, (concrete, tag) in enumerate(runs):
        cfg = compose_config(args.config_dir, args.config_name, concrete)
        if tag:
            cfg["trainer"]["project_name"] = (
                f"{cfg['trainer'].get('project_name', 'diffulab')}/{tag_to_dirname(tag)}"
            )
        print(f"=== sweep run {i + 1}/{len(runs)}: {tag or '(single)'} -> "
              f"{cfg['trainer'].get('project_name')}")
        results.append(run_one(cfg, args.seed))
    return results


def add_sweep_arg(parser) -> None:
    parser.add_argument(
        "--sweep", action="store_true",
        help="hydra-multirun-style sweep: overrides with top-level commas "
             "(trainer.ema_rate=0.99,0.999) become choice axes; runs the "
             "cartesian product sequentially, one templated run dir per combo",
    )
