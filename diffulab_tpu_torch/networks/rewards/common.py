"""Reward model interface (port of diffulab_tpu/networks/rewards/common.py;
reference src/diffulab/networks/rewards/common.py:10-40).

A copy of the JAX package's module, which imports no JAX; the port keeps its
own. Reward models run on the host, outside the model's steps: the GRPO
judge is an autoregressive VLM. Inputs and outputs are numpy.
"""

from __future__ import annotations

from typing import Any

import numpy as np


class RewardModel:
    def __init__(self, n_image_per_prompt: int):
        self._n_image_per_prompt = n_image_per_prompt

    def __call__(self, images: np.ndarray, context: Any) -> np.ndarray:
        """images: [B, H, W, C] in [-1, 1]; returns rewards [B]."""
        raise NotImplementedError

    def set_n_image_per_prompt(self, n: int) -> None:
        self._n_image_per_prompt = n

    @property
    def n_image_per_prompt(self) -> int:
        return self._n_image_per_prompt
