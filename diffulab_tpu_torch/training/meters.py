"""Keyed running averages (reference src/diffulab/training/utils.py:1-25).

A copy of diffulab_tpu/training/meters.py, which imports no JAX; the port keeps its own.
"""

from __future__ import annotations


class AverageMeter:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.avg: dict[str, float] = {}
        self.sum: dict[str, float] = {}
        self.count: dict[str, int] = {}

    def update(self, value: float, key: str, n: int = 1) -> None:
        self.sum[key] = self.sum.get(key, 0.0) + value * n
        self.count[key] = self.count.get(key, 0) + n
        self.avg[key] = self.sum[key] / self.count[key]
