"""Checkpoint save/resume in torch format (port of
diffulab_tpu/training/checkpoint.py).

The artifact set is the reference's (trainers/common.py:130-176): per run,
entry directories ``denoiser`` / ``optimizer`` / ``ema`` / ``scheduler``. Each
entry directory holds one file, ``state.pt``: ``torch.save`` of a dict of CPU
tensors and Python scalars, written to a temporary name and renamed into
place, so an entry is either complete or absent.

Not ported yet (ROADMAP queue 1, item 8): ``trainable_filter``,
``restore_train_modules``, ``restore_sampling_model`` and an importer of the
JAX package's orbax runs.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Any

import torch

#: the one file of an entry directory
STATE_FILE = "state.pt"


def _map_tensors(tree: Any, fn) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def to_cpu(tree: Any, copy: bool = True) -> Any:
    """Every tensor of a nested dict/list payload detached on the CPU (copied
    even where it already lies there, unless ``copy=False``)."""
    return _map_tensors(tree, lambda t: t.detach().to("cpu", copy=copy))


def save_checkpoint(path: str | Path, payload: dict[str, Any]) -> None:
    """Save a dict of tensors and scalars (tensors may be on any device) as
    ``path/state.pt``, atomically."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f".{STATE_FILE}.{os.getpid()}.tmp"
    torch.save(to_cpu(payload, copy=False), tmp)
    os.replace(tmp, path / STATE_FILE)


def restore_checkpoint(path: str | Path, target: dict[str, Any] | None = None) -> dict[str, Any]:
    """Restore an entry directory. With ``target`` (a matching nested dict of
    tensors), each tensor comes back on its target's device and in its dtype,
    and a key or shape that does not match raises; without, as saved (CPU)."""
    state = torch.load(Path(path).absolute() / STATE_FILE, map_location="cpu", weights_only=True)
    if target is None:
        return state
    return _restore_like(state, target, str(path))


def _restore_like(saved: Any, target: Any, where: str) -> Any:
    if isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != target.shape:
            raise ValueError(f"checkpoint {where}: {getattr(saved, 'shape', type(saved))} "
                             f"does not match {tuple(target.shape)}")
        return saved.to(device=target.device, dtype=target.dtype)
    if isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            missing = set(target) - set(saved) if isinstance(saved, dict) else set(target)
            raise ValueError(f"checkpoint {where}: keys differ from the target (missing {sorted(missing)[:5]})")
        return {k: _restore_like(saved[k], v, f"{where}/{k}") for k, v in target.items()}
    return saved


class AsyncCheckpointer:
    """Checkpoint saves that do not hold up the train loop for the write.

    ``save`` snapshots every tensor to the CPU on the calling thread (so the
    loop may go on updating its parameters in place) and writes the files on
    one background thread. Saves are serialised: a new ``save`` waits for the
    one in flight. ``wait()`` joins the thread and re-raises a write error;
    the trainer calls it at the end of ``train``.
    """

    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def save(self, entries: dict[str | Path, dict[str, Any]]) -> None:
        """Snapshot and asynchronously write ``{path: payload}`` entries, in order."""
        self.wait()
        snapshots = {path: to_cpu(payload) for path, payload in entries.items()}

        def work() -> None:
            try:
                for path, payload in snapshots.items():
                    save_checkpoint(path, payload)
            except BaseException as e:  # surfaced on the next wait() or save()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True, name="ckpt-writer")
        self._thread.start()
