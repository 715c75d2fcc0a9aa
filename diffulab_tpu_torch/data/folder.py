"""Generic image-folder dataset: train on your own images with zero prep
(port of diffulab_tpu/data/folder.py).

No reference counterpart (its datasets are MNIST/CIFAR parsers and MDS
streams); this is the bring-your-own-data entry path:

    root/
      class_a/ img001.png img002.jpg ...
      class_b/ ...

Class labels come from the sorted subdirectory names; a flat directory of
images becomes a single-class (unconditional) dataset. Images are decoded
once at construction, center-cropped to square, resized to ``image_size``,
and held in memory as uint8 NHWC — the same layout the other in-memory
datasets use, so the native fused gather+normalize batch path applies.

Deterministic split: ``split="train"``/``"val"`` partitions each class by a
hash of the filename (stable across runs and machines, independent of
directory enumeration order).
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

from diffulab_tpu_torch.data.base import BaseDataset

IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


def _is_val(name: str, val_fraction: float) -> bool:
    """Stable filename-hash split (first 8 hex digits of sha1 as a fraction)."""
    h = int(hashlib.sha1(name.encode()).hexdigest()[:8], 16) / 0xFFFFFFFF
    return h < val_fraction


class ImageFolderDataset(BaseDataset):
    def __init__(
        self,
        data_path: str,
        image_size: int = 32,
        split: str = "train",
        val_fraction: float = 0.1,
        grayscale: bool = False,
    ):
        super().__init__()
        if split not in ("train", "val", "all"):
            raise ValueError(f"split must be train/val/all, got {split!r}")
        self.data_path = Path(data_path)
        self.image_size = int(image_size)
        self.split = split
        self.val_fraction = float(val_fraction)
        self.grayscale = bool(grayscale)
        self.images, self.labels = self.load_data()

    def load_data(self) -> tuple[np.ndarray, np.ndarray]:
        from PIL import Image

        root = self.data_path
        if not root.is_dir():
            raise FileNotFoundError(f"image folder {root} does not exist")
        class_dirs = sorted(d for d in root.iterdir() if d.is_dir())
        if class_dirs:
            sources = [(i, d) for i, d in enumerate(class_dirs)]
            self.class_names = [d.name for d in class_dirs]
        else:
            sources = [(0, root)]  # flat directory: single (null) class
            self.class_names = [root.name]
        self.n_classes = len(self.class_names)

        s = self.image_size
        images, labels = [], []
        for label, directory in sources:
            files = sorted(
                p for p in directory.iterdir()
                if p.suffix.lower() in IMAGE_EXTENSIONS
            )
            for p in files:
                if self.split != "all" and (
                    _is_val(p.name, self.val_fraction) != (self.split == "val")
                ):
                    continue
                img = Image.open(p).convert("L" if self.grayscale else "RGB")
                w, h = img.size
                side = min(w, h)  # center-crop to square, then resize
                img = img.crop(((w - side) // 2, (h - side) // 2,
                                (w + side) // 2, (h + side) // 2))
                arr = np.asarray(img.resize((s, s), Image.BICUBIC), np.uint8)
                if arr.ndim == 2:
                    arr = arr[..., None]
                images.append(arr)
                labels.append(label)
        if not images:
            raise FileNotFoundError(
                f"no images with extensions {sorted(IMAGE_EXTENSIONS)} found "
                f"under {root} for split={self.split!r}")
        return np.stack(images), np.asarray(labels, np.int64)

    def preprocess_image(self, image: np.ndarray) -> np.ndarray:
        return (image.astype(np.float32) / 255.0 - 0.5) / 0.5
