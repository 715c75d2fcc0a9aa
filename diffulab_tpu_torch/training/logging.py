"""Experiment tracking: wandb-compatible, with a local JSONL fallback.

The reference logs through ``Accelerator(log_with="wandb")`` +
``init_trackers`` (trainers/common.py:107-114) and logs validation image grids
(common.py:178-242). Here the tracker is host-0-only; if wandb is importable
and configured it is used, otherwise metrics go to ``metrics.jsonl`` and image
grids to PNG files under the run directory — same metric names either way.

A copy of diffulab_tpu/training/logging.py, which imports no JAX; the port keeps its own.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any

import numpy as np


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """Tile [N, H, W, C] float images in [0,1] into one [GH, GW, C] grid
    (torchvision.utils.make_grid analog, NHWC)."""
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c), dtype=images.dtype)
    for idx in range(n):
        r, col = divmod(idx, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0 : y0 + h, x0 : x0 + w] = images[idx]
    return grid


class Tracker:
    """Metric + image logger. wandb when available, JSONL/PNG files otherwise."""

    def __init__(
        self,
        save_path: str | Path,
        project_name: str = "my_project",
        run_config: dict[str, Any] | None = None,
        init_kwargs: dict[str, Any] | None = None,
        enabled: bool = True,
        use_wandb: bool | None = None,
    ):
        self.save_path = Path(save_path)
        self.enabled = enabled
        self._wandb = None
        if not enabled:
            return
        self.save_path.mkdir(parents=True, exist_ok=True)
        if use_wandb is None or use_wandb:
            try:
                import wandb  # noqa: PLC0415

                self._wandb = wandb.init(
                    project=project_name,
                    dir=str(self.save_path),
                    config=run_config,
                    **(init_kwargs or {}).get("wandb", {}),
                )
            except Exception:
                if use_wandb:
                    raise
                self._wandb = None
        self._metrics_file = self.save_path / "metrics.jsonl"
        with open(self.save_path / "run_config.json", "w") as f:
            json.dump(run_config or {}, f, indent=2, default=str)

    def log(self, metrics: dict[str, float], step: int) -> None:
        if not self.enabled:
            return
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        else:
            with open(self._metrics_file, "a") as f:
                f.write(json.dumps({"step": step, "time": time.time(), **metrics}) + "\n")

    def log_images(self, images: np.ndarray, step: int, key: str = "val/images",
                   captions: list[str] | None = None) -> None:
        """images: [N, H, W, C] float in [0, 1]."""
        if not self.enabled:
            return
        if self._wandb is not None:
            import wandb  # noqa: PLC0415

            if captions is not None:
                payload = [wandb.Image(img, caption=cap) for img, cap in zip(images, captions)]
            else:
                payload = wandb.Image(make_grid(images))
            self._wandb.log({key: payload}, step=step)
        else:
            from PIL import Image  # noqa: PLC0415

            grid = make_grid(images)
            arr = (np.clip(grid, 0, 1) * 255).astype(np.uint8)
            if arr.shape[-1] == 1:
                arr = arr[..., 0]
            out_dir = self.save_path / "images"
            out_dir.mkdir(exist_ok=True)
            Image.fromarray(arr).save(out_dir / f"{key.replace('/', '_')}_step{step:06d}.png")

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
