"""MNIST raw idx-ubyte parser (port of diffulab_tpu/data/mnist.py; reference
src/diffulab/datasets/mnist.py:11-86).

28x28 images zero-padded to 32x32, normalized to [-1, 1], NHWC ([32, 32, 1])."""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from diffulab_tpu_torch.data.base import BaseDataset


class MNISTDataset(BaseDataset):
    def __init__(self, data_path: str, train: bool = True):
        super().__init__()
        self.data_path = Path(data_path)
        self.train = train
        self.images, self.labels = self.load_data()

    def load_data(self) -> tuple[np.ndarray, np.ndarray]:
        if self.train:
            images_file = self.data_path / "train-images-idx3-ubyte"
            labels_file = self.data_path / "train-labels-idx1-ubyte"
        else:
            images_file = self.data_path / "t10k-images-idx3-ubyte"
            labels_file = self.data_path / "t10k-labels-idx1-ubyte"
        return self._load_images(images_file), self._load_labels(labels_file)

    @staticmethod
    def _load_images(file: Path) -> np.ndarray:
        with open(file, "rb") as f:
            _, num_images, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), dtype=np.uint8).reshape(num_images, rows, cols, 1)
        # center the 28x28 digits in a 32x32 frame (vectorized, not per-image)
        padded = np.zeros((num_images, 32, 32, 1), dtype=np.uint8)
        padded[:, 2:30, 2:30] = images
        return padded

    @staticmethod
    def _load_labels(file: Path) -> np.ndarray:
        with open(file, "rb") as f:
            struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), dtype=np.uint8)
        return labels.astype(np.int64)

    def preprocess_image(self, image: np.ndarray) -> np.ndarray:
        return ((image.astype(np.float32) / 255.0) - 0.5) / 0.5
