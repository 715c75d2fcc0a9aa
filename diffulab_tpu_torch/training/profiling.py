"""Tracing and profiling utilities (port of diffulab_tpu/training/profiling.py).

- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``, for chrome://tracing or Perfetto) under
  ``log_dir``, with the card's activity where there is a card;
- :class:`StepTimer`: steady-state step timing, the first ``warmup`` calls
  excluded, every timed region ended by ``torch.cuda.synchronize()`` (the
  reference's ``block_until_ready``), with percentile summaries;
- :func:`annotate`: ``torch.profiler.record_function``, so that model blocks
  show up named in traces.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import numpy as np
import torch

annotate = torch.profiler.record_function

#: the file :func:`trace` writes under its ``log_dir``
TRACE_FILE = "trace.json"


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[torch.profiler.profile]:
    """Profile the block (host activity, and the card's where CUDA is
    available) and write its Chrome trace to ``log_dir/trace.json``."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _synchronize()
    prof.export_chrome_trace(str(log_dir / TRACE_FILE))


class StepTimer:
    """Steady-state step timing: the first ``warmup`` calls (kernel builds,
    cold caches) are excluded; every timed region ends with
    ``torch.cuda.synchronize()`` where a card is in use."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: list[float] = []
        self._seen = 0

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        start = time.perf_counter()
        yield
        _synchronize()
        self._seen += 1
        if self._seen > self.warmup:
            self._times.append(time.perf_counter() - start)

    def time_fn(self, fn: Callable[..., Any], *args: Any, n_iters: int = 20, **kwargs: Any) -> dict[str, float]:
        """Time ``fn(*args, **kwargs)``: one first call and ``warmup`` more
        untimed, then ``n_iters`` timed; returns mean/p50/p90/min seconds."""
        for _ in range(1 + self.warmup):
            fn(*args, **kwargs)
        _synchronize()
        times = []
        for _ in range(n_iters):
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            _synchronize()
            times.append(time.perf_counter() - t0)
        arr = np.asarray(times)
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "min_s": float(arr.min()),
        }

    @property
    def summary(self) -> dict[str, float]:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
        }
