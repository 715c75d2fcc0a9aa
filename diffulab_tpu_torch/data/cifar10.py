"""CIFAR-10 pickle-batch parser (port of diffulab_tpu/data/cifar10.py; reference
src/diffulab/datasets/cifar10.py:10-85).

NHWC [32, 32, 3] float32 in [-1, 1] (the reference transposes to CHW)."""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from diffulab_tpu_torch.data.base import BaseDataset

DEFAULT_BATCHES = ["data_batch_1", "data_batch_2", "data_batch_3", "data_batch_4", "data_batch_5"]


class CIFAR10Dataset(BaseDataset):
    def __init__(self, data_path: str, batches_to_load: list[str] | None = None):
        super().__init__()
        self.data_path = Path(data_path)
        self.batches_to_load = batches_to_load or list(DEFAULT_BATCHES)
        self.images, self.labels = self.load_data()

    def load_data(self) -> tuple[np.ndarray, np.ndarray]:
        images, labels = [], []
        for batch in self.batches_to_load:
            imgs, labs = self._load_cifar10_batch(self.data_path / batch)
            images.append(imgs)
            labels.append(labs)
        return np.concatenate(images, axis=0), np.concatenate(labels, axis=0)

    @staticmethod
    def _load_cifar10_batch(file: Path) -> tuple[np.ndarray, np.ndarray]:
        with open(file, "rb") as f:
            batch = pickle.load(f, encoding="latin1")
        features = batch["data"]
        r = features[:, :1024].reshape(-1, 32, 32)
        g = features[:, 1024:2048].reshape(-1, 32, 32)
        b = features[:, 2048:].reshape(-1, 32, 32)
        images = np.stack([r, g, b], axis=-1).astype(np.uint8)
        labels = np.array(batch["labels"], dtype=np.int64)
        return images, labels

    def preprocess_image(self, image: np.ndarray) -> np.ndarray:
        return (image.astype(np.float32) / 255.0 - 0.5) / 0.5
