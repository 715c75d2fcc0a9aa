"""Coupled-pairs dataset for ReFlow (Rectified Flow, Liu et al. 2022,
arXiv:2209.03003) (port of diffulab_tpu/data/reflow.py).

A k-rectified flow is retrained on COUPLED pairs (z, x-hat) with x-hat =
ODE-solve(z) under the previous flow: interpolation then runs along
(1-t) x-hat + t z with the z that generated x-hat, which straightens the
velocity field. The trainer takes the coupling from the ``coupled_noise``
key of ``model_inputs`` in place of fresh Gaussian noise.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from diffulab_tpu_torch.utils import resolve_device

BatchData = dict[str, Any]


class ReflowPairsDataset:
    """In-memory (x-hat, z[, y]) coupling dataset; the batch protocol of
    :class:`~diffulab_tpu_torch.data.base.BaseDataset`."""

    def __init__(self, x: np.ndarray, noise: np.ndarray, labels: np.ndarray | None = None):
        if x.shape != noise.shape:
            raise ValueError(f"x {x.shape} and noise {noise.shape} differ")
        self.x = np.asarray(x, np.float32)
        self.noise = np.asarray(noise, np.float32)
        self.labels = None if labels is None else np.asarray(labels, np.int64)

    def __len__(self) -> int:
        return len(self.x)

    def __getitem__(self, idx: int) -> BatchData:
        return self.get_batch(idx)

    def get_batch(self, indices: Sequence[int] | int) -> BatchData:
        idx = np.asarray(indices, np.int64)
        mi: dict[str, Any] = {"x": self.x[idx], "coupled_noise": self.noise[idx]}
        if self.labels is not None:
            mi["y"] = self.labels[idx]
        return {"model_inputs": mi}


def generate_pairs(
    diffuser,
    n_pairs: int,
    data_shape: tuple[int, ...],
    n_classes: int | None = None,
    batch_size: int = 128,
    guidance_scale: float = 0.0,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> ReflowPairsDataset:
    """Sample ``n_pairs`` couplings (z, ODE-solve(z)) from a trained flow
    through ``Diffuser.generate`` on ``device`` (default: the card).

    z and the labels (class-conditional models) are drawn on the host with
    numpy from ``seed``, as the reference draws them, and z goes in as ``x``
    so that every trajectory's exact start is kept; a ``torch.Generator``
    seeded from ``seed`` serves the sampler's own draws (a stochastic one).
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    xs, zs, ys = [], [], []
    for start in range(0, n_pairs, batch_size):
        bsz = min(batch_size, n_pairs - start)
        z = rng.standard_normal((bsz, *data_shape)).astype(np.float32)
        cond: dict[str, Any] = {}
        if n_classes is not None:
            y = rng.integers(0, n_classes, size=bsz).astype(np.int64)
            cond["y"] = torch.as_tensor(y, device=device)
            ys.append(y)
        out = diffuser.generate(cond, x=torch.from_numpy(z), generator=generator,
                                guidance_scale=guidance_scale, clamp_x=True, device=device)
        xs.append(out["x"].float().cpu().numpy())
        zs.append(z)
    return ReflowPairsDataset(
        np.concatenate(xs)[:n_pairs],
        np.concatenate(zs)[:n_pairs],
        np.concatenate(ys)[:n_pairs] if ys else None,
    )
