"""Sampling-time block caching: the denoise loop's wrapper shared by the flow
and EDM formalizations (port of diffulab_tpu/diffuse/caching.py).

Delta-DiT-style residual block caching (arXiv:2406.01125) carries a cache
from step to step; every ``cache_interval``-th step refreshes it (bit-exact
with the uncached model), the steps in between reuse the cached span delta
and skip those blocks. The carried cache is a ``(main, guide)`` pair: ``main``
feeds the denoiser, ``guide`` the autoguidance model (arXiv:2406.02507) when
there is one, since their weights and their call batches differ; without a
guide it is ``()``.

The refresh decision is a host bool: the reference traces it into a
``lax.cond``, the port picks the branch in Python and never reads the device
to decide it.
"""

from __future__ import annotations

from typing import Any, Callable

ModelFn = Callable[..., dict[str, Any]]


def wrap_block_cache(
    model_fn: ModelFn,
    guide_fn: ModelFn | None,
    mcache: Any,
    step_idx: int,
    cache_interval: int,
    *,
    enabled: bool,
) -> tuple[ModelFn, ModelFn | None, dict[str, Any]]:
    """Wrap ``model_fn`` (and ``guide_fn``) so that the block cache threads
    through the step (caching.py:27).

    Returns ``(step_model_fn, step_guide_fn, cell)``; ``cell["c"]`` is the
    cache pair after the step's model evaluations. Every evaluation of one
    step (Heun's two) shares the step's refresh decision and updates the same
    cell.
    """
    if not enabled:
        return model_fn, guide_fn, {"c": mcache}

    refresh = (int(step_idx) % int(cache_interval)) == 0
    cell = {"c": mcache}

    def step_model_fn(**kw: Any) -> dict[str, Any]:
        out = model_fn(**kw, block_cache=cell["c"][0], cache_refresh=refresh)
        cell["c"] = (out["block_cache"], cell["c"][1])
        return out

    step_guide_fn = guide_fn
    if guide_fn is not None:

        def step_guide_fn(**kw: Any) -> dict[str, Any]:
            out = guide_fn(**kw, block_cache=cell["c"][1], cache_refresh=refresh)
            cell["c"] = (cell["c"][0], out["block_cache"])
            return out

    return step_model_fn, step_guide_fn, cell
