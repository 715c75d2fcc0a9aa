"""Checkpoint save/resume in torch format (port of
diffulab_tpu/training/checkpoint.py).

The artifact set is the reference's (trainers/common.py:130-176): per run,
entry directories ``denoiser`` / ``optimizer`` / ``ema`` / ``scheduler``. Each
entry directory holds one file, ``state.pt``: ``torch.save`` of a dict of CPU
tensors and Python scalars, written to a temporary name and renamed into
place, so an entry is either complete or absent.

The layout of a model entry follows :func:`trainable_filter`, as the
reference's (checkpoint.py:113-160): the ``denoiser`` entry holds
``{"params": <the trainable parameters by name>, "rest": <every other
state_dict entry: frozen parameters such as a frozen context embedder's or a
REPA encoder's, and persistent buffers>}``, so the whole model restores from
it; the ``ema`` entry holds ``{"params": <the EMA of the trainable
parameters>}`` only. The names are the denoiser's own; a run with extra
losses (REPA) saves :class:`TrainModules`, the reference's ``_TrainModules``
bundle, whose names are ``denoiser.*`` and ``extra_losses.<i>.*``.

:func:`restore_train_modules` and :func:`restore_sampling_model` restore a
run's entry into a freshly built model for the CLIs: entries named ``ema``
or ``phema*`` (a post-hoc EMA snapshot or reconstruction) hold
``{"params"}`` only, the others ``{"params", "rest"}``. A JAX package run
(orbax directories) comes into this format through
``scripts/import_orbax_checkpoint.py``, which runs where orbax does; the
port itself reads no orbax directory (:func:`is_orbax_dir` tells one apart).
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Any, Callable, Sequence

import torch
from torch import nn

#: the one file of an entry directory
STATE_FILE = "state.pt"


def map_tensors(tree: Any, fn) -> Any:
    """``fn`` applied to every tensor of a nested dict/list/tuple tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn) for v in tree)
    return tree


def to_cpu(tree: Any, copy: bool = True) -> Any:
    """Every tensor of a nested dict/list payload detached on the CPU (copied
    even where it already lies there, unless ``copy=False``)."""
    return map_tensors(tree, lambda t: t.detach().to("cpu", copy=copy))


def save_checkpoint(path: str | Path, payload: dict[str, Any]) -> None:
    """Save a dict of tensors and scalars (tensors may be on any device) as
    ``path/state.pt``, atomically."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f".{STATE_FILE}.{os.getpid()}.tmp"
    torch.save(to_cpu(payload, copy=False), tmp)
    os.replace(tmp, path / STATE_FILE)


def is_orbax_dir(path: str | Path) -> bool:
    """Whether ``path`` is an orbax checkpoint directory (the JAX package's
    format) rather than one of the port's entries."""
    path = Path(path)
    return path.is_dir() and not (path / STATE_FILE).exists() and any(
        (path / name).exists() for name in ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt", "_sharding"))


def restore_checkpoint(path: str | Path, target: dict[str, Any] | None = None) -> dict[str, Any]:
    """Restore an entry directory. With ``target`` (a matching nested dict of
    tensors), each tensor comes back on its target's device and in its dtype,
    and a key or shape that does not match raises; without, as saved (CPU).
    An orbax directory raises, naming the importer."""
    if is_orbax_dir(path):
        raise ValueError(f"{path} is an orbax checkpoint of the JAX package; convert it with "
                         f"scripts/import_orbax_checkpoint.py (where orbax is installed) and give the port its output")
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


class TrainModules(nn.Module):
    """The denoiser and its extra-loss modules as one module (the reference's
    ``_TrainModules``, trainer.py:63-70): one trainable split, optimizer, EMA
    and checkpoint cover the denoiser and, for REPA, the projector."""

    def __init__(self, denoiser: nn.Module, extra_losses: Sequence[nn.Module]):
        super().__init__()
        self.denoiser = denoiser
        self.extra_losses = nn.ModuleList(extra_losses)


def train_modules(denoiser: nn.Module, extra_losses: Sequence[nn.Module] = ()) -> nn.Module:
    """What the trainer optimises and checkpoints: the denoiser alone, or with
    extra losses their :class:`TrainModules` bundle."""
    return TrainModules(denoiser, extra_losses) if extra_losses else denoiser


def trainable_filter(denoiser: torch.nn.Module, *, lora: bool = False,
                     train_embedder: bool = False) -> Callable[[str], bool]:
    """The trainer's trainable-parameter filter (reference checkpoint.py:113-134):
    a predicate on ``named_parameters()`` names (of the denoiser or of its
    :class:`TrainModules`), true for every parameter except those of a live
    REPA ``repa_encoder`` (a frozen alignment target) and of a frozen
    ``context_embedder`` (excluded unless ``train_embedder``). It sets what
    the optimizer and the EMA hold and the checkpoint layout
    (:func:`split_state`). LoRA (item 16) is not ported and raises."""
    if lora:
        raise NotImplementedError("LoRA training is not ported yet (ROADMAP queue 1, item 16)")
    frozen = ["repa_encoder"]
    if not train_embedder and getattr(denoiser, "context_embedder", None) is not None:
        frozen.append("context_embedder")

    def trainable(name: str) -> bool:
        return not any(part in frozen for part in name.split("."))

    return trainable


def split_state(model: torch.nn.Module, trainable: Callable[[str], bool]
                ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """(params, rest) of ``model.state_dict()``: the trainable parameters, and
    every other entry (the ``denoiser`` checkpoint's two halves)."""
    names = {name for name, _ in model.named_parameters() if trainable(name)}
    state = model.state_dict()
    return ({k: v for k, v in state.items() if k in names},
            {k: v for k, v in state.items() if k not in names})


def restore_train_modules(path: str | Path, denoiser: torch.nn.Module,
                          extra_losses: Sequence[nn.Module] = (), train_embedder: bool = False) -> None:
    """Restore a trainer checkpoint entry (``denoiser``, ``ema`` or a post-hoc
    EMA ``phema*`` directory) into a live model and its extra losses (the
    run's :func:`train_modules`), with the trainable split the run used
    (:func:`trainable_filter`; the reference's sampling CLIs restore with the
    default, ``train_embedder=False``; checkpoint.py:138-160). ``ema`` and
    ``phema*`` entries hold ``{"params"}`` only and leave the rest of the
    state as it is; others hold ``{"params", "rest"}`` and restore the whole
    state. A key or shape that does not match raises."""
    path = Path(path)
    modules = train_modules(denoiser, extra_losses)
    params, rest = split_state(modules, trainable_filter(denoiser, train_embedder=train_embedder))
    if path.name == "ema" or path.name.startswith("phema"):
        restored = restore_checkpoint(path, {"params": params})
        modules.load_state_dict({**rest, **restored["params"]}, strict=True)
    else:
        restored = restore_checkpoint(path, {"params": params, "rest": rest})
        modules.load_state_dict({**restored["params"], **restored["rest"]}, strict=True)


def restore_sampling_model(ckpt_path: str | Path, denoiser: torch.nn.Module, extra_losses: list,
                           trainer_cfg: dict) -> None:
    """Restore a run checkpoint into a freshly built denoiser (and the run's
    extra losses, which a REPA run's checkpoint holds beside it) for the
    sampling CLI (reference checkpoint.py:188-225). A LoRA run
    (``trainer.lora_rank``) would restore its base, wrap the model and then
    the adapters; LoRA is not ported yet and raises."""
    if trainer_cfg.get("lora_rank"):
        raise NotImplementedError("LoRA checkpoints (trainer.lora_rank) are not ported yet (ROADMAP queue 1, item 16)")
    restore_train_modules(ckpt_path, denoiser, extra_losses)
