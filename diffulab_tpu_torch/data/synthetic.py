"""Procedural class-conditional image dataset for zero-egress end-to-end runs
(port of diffulab_tpu/data/synthetic.py: pure numpy, the same arrays for the
same seed).

The environment ships no real datasets (no MNIST/CIFAR downloads), so full
training -> sampling -> FID pipelines need a distribution that is (a)
learnable by a small diffusion model in a few hundred steps, (b) rich enough
that FID discriminates a trained model from noise, and (c) exactly
reproducible from a seed. This generates anti-aliased colored shapes over
gradient backgrounds: 10 classes = 5 shapes (disk, square, triangle, ring,
cross) x 2 color families (warm fg / cool fg), with per-sample jitter in
position, scale, rotation, hue, and background gradient.

Plays the role of CIFAR10Dataset (reference src/diffulab/datasets/cifar10.py)
in the BASELINE.md "FID measured end-to-end" recipe; images are uint8 HWC so
the native C++ gather+normalize fast path applies
(:mod:`diffulab_tpu_torch.data.native`).
"""

from __future__ import annotations

import numpy as np

from diffulab_tpu_torch.data.base import BaseDataset

_SHAPES = ("disk", "square", "triangle", "ring", "cross")

# (base RGB in [0,1]) per color family; hue-jittered per sample.
_WARM = np.array([0.85, 0.35, 0.20])
_COOL = np.array([0.20, 0.45, 0.85])


def _sdf(shape: str, x: np.ndarray, y: np.ndarray, r: float) -> np.ndarray:
    """Signed distance (<0 inside) of the unit-parameterized shape."""
    if shape == "disk":
        return np.hypot(x, y) - r
    if shape == "square":
        return np.maximum(np.abs(x), np.abs(y)) - r
    if shape == "triangle":
        # equilateral triangle (point up) via three half-plane distances
        k = np.sqrt(3.0)
        d1 = y - r * 0.8
        d2 = -0.5 * y - (k / 2) * x - r * 0.4
        d3 = -0.5 * y + (k / 2) * x - r * 0.4
        return np.maximum(np.maximum(d1, d2), d3)
    if shape == "ring":
        return np.abs(np.hypot(x, y) - r * 0.8) - r * 0.28
    if shape == "cross":
        bar = np.minimum(
            np.maximum(np.abs(x) - r, np.abs(y) - r * 0.35),
            np.maximum(np.abs(x) - r * 0.35, np.abs(y) - r),
        )
        return bar
    raise ValueError(shape)


def render_shape(
    rng: np.random.Generator, label: int, size: int = 32, supersample: int = 2
) -> np.ndarray:
    """One uint8 [size, size, 3] image for class ``label`` in [0, 10)."""
    shape = _SHAPES[label % len(_SHAPES)]
    base = _WARM if label < len(_SHAPES) else _COOL
    bg_base = _COOL if label < len(_SHAPES) else _WARM

    s = size * supersample
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    xx = (xx + 0.5) / s * 2 - 1
    yy = (yy + 0.5) / s * 2 - 1

    # jittered pose
    cx, cy = rng.uniform(-0.3, 0.3, size=2)
    radius = rng.uniform(0.35, 0.55)
    theta = rng.uniform(0.0, 2 * np.pi)
    ct, st = np.cos(theta), np.sin(theta)
    xr = ct * (xx - cx) + st * (yy - cy)
    yr = -st * (xx - cx) + ct * (yy - cy)

    d = _sdf(shape, xr, yr, radius)
    # anti-alias over ~1 output pixel
    alpha = np.clip(0.5 - d * (s / 4.0), 0.0, 1.0)[..., None]

    fg = np.clip(base + rng.uniform(-0.12, 0.12, size=3), 0.0, 1.0)
    g_dir = rng.uniform(0.0, 2 * np.pi)
    grad = 0.5 + 0.5 * (np.cos(g_dir) * xx + np.sin(g_dir) * yy) / np.sqrt(2)
    bg_lo = np.clip(bg_base * rng.uniform(0.15, 0.35), 0.0, 1.0)
    bg_hi = np.clip(bg_base * rng.uniform(0.55, 0.85) + 0.15, 0.0, 1.0)
    bg = bg_lo + (bg_hi - bg_lo) * grad[..., None]

    img = alpha * fg + (1.0 - alpha) * bg
    img = img.reshape(size, supersample, size, supersample, 3).mean(axis=(1, 3))
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


class SyntheticShapesDataset(BaseDataset):
    """Deterministic procedural shapes; ``data_path`` ignored (no IO).

    ``task``:
      - "generate": class-conditional generation (x, y) — the default;
      - "colorize": image-to-image — ``model_inputs`` additionally carries
        ``x_context``: the luma (grayscale) rendering of the target, wired
        into the denoisers' channel-concat conditioning path (reference
        unet.py x_context / mmdit x_context concat). This instantiates the
        reference roadmap's "different tasks (conditional generation,
        Image to Image ...)" item with a runnable toy.
    """

    n_classes = 10

    def __init__(
        self,
        data_path: str | None = None,
        train: bool = True,
        n_samples: int = 10_000,
        image_size: int = 32,
        seed: int = 0,
        task: str = "generate",
    ):
        super().__init__()
        assert task in ("generate", "colorize"), task
        self.task = task
        self.image_size = image_size
        # disjoint streams for train/val splits
        base_seed = seed * 2 + (0 if train else 1)
        rng = np.random.default_rng(np.random.SeedSequence([base_seed, 0xD1FF]))
        labels = rng.integers(0, self.n_classes, size=n_samples)
        images = np.stack(
            [render_shape(rng, int(lbl), image_size) for lbl in labels]
        )
        self.images = images
        self.labels = labels.astype(np.int64)

    def load_data(self) -> tuple[np.ndarray, np.ndarray]:
        assert self.images is not None and self.labels is not None
        return self.images, self.labels

    def preprocess_image(self, image: np.ndarray) -> np.ndarray:
        return image.astype(np.float32) / 127.5 - 1.0

    @staticmethod
    def _luma(x: np.ndarray) -> np.ndarray:
        """BT.601 luma of [-1, 1] RGB, kept as a single channel in [-1, 1]."""
        return (x @ np.asarray([0.299, 0.587, 0.114], np.float32))[..., None]

    def __getitem__(self, idx: int):
        batch = super().__getitem__(idx)
        if self.task == "colorize":
            batch["model_inputs"]["x_context"] = self._luma(batch["model_inputs"]["x"])
        return batch

    def get_batch(self, indices):
        batch = super().get_batch(indices)
        if self.task == "colorize":
            batch["model_inputs"]["x_context"] = self._luma(batch["model_inputs"]["x"])
        return batch
