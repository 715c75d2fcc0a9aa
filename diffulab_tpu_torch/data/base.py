"""Dataset base types (port of diffulab_tpu/data/base.py; reference
src/diffulab/datasets/base.py:13-85).

Datasets yield numpy ``BatchData`` dicts:
    {"model_inputs": {"x": [H, W, C] float32 in [-1, 1], "y": int64, ...},
     "extra": {...}}   # optional auxiliary-loss inputs (e.g. REPA dst features)

Layout: NHWC end to end, as the JAX package (the reference is NCHW). The
trainer moves the arrays to the card (``BaseTrainer._prepare_batch``).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np

from diffulab_tpu_torch.data import native

BatchData = Dict[str, Any]


class BaseDataset:
    """In-memory image dataset with [-1, 1] float normalization."""

    def __init__(self):
        self.images: np.ndarray | None = None
        self.labels: np.ndarray | None = None

    def load_data(self) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def preprocess_image(self, image: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def __len__(self) -> int:
        if self.images is None:
            raise ValueError("Dataset has not been initialized properly. Images are None.")
        return len(self.images)

    def __getitem__(self, idx: int) -> BatchData:
        if self.images is None or self.labels is None:
            raise ValueError("Dataset has not been initialized properly.")
        image = self.preprocess_image(self.images[idx])
        label = np.int64(self.labels[idx])
        return {"model_inputs": {"x": image, "y": label}}

    def get_batch(self, indices: Sequence[int]) -> BatchData:
        """A whole batch at once: uint8 stores through the fused gather +
        uint8->[-1,1] normalize of :mod:`~diffulab_tpu_torch.data.native`
        (one multithreaded C++ call), other stores through
        ``preprocess_image``, bypassing the per-item __getitem__ + collate loop."""
        if self.images is None or self.labels is None:
            raise ValueError("Dataset has not been initialized properly.")
        idx = np.asarray(indices, np.int64)
        if self.images.dtype == np.uint8:
            x = native.gather_normalize_u8(self.images, idx)
        else:
            x = np.stack([self.preprocess_image(self.images[i]) for i in idx])
        return {"model_inputs": {"x": x, "y": self.labels[idx].astype(np.int64)}}
