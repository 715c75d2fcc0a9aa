"""Supervised trainer on one card (port of diffulab_tpu/training/trainer.py).

The reference runs one jitted, sharded train step over a device mesh; here
one eager step runs on one card: the loss through the model (on the card the
attention runs K1 forward and K2 backward up to 512 tokens, K3 forward and
K4/K5 backward beyond), ``.backward()``, and the optimizer with optax's
accumulation and clipping rules. Mirrored from the reference:

- per step, t, the noise and the CFG drop mask are drawn from one
  ``torch.Generator`` on the card, seeded from (seed, step) so that a resumed
  run draws what the uninterrupted one would (the reference folds the step
  into its key); a denoiser with ``draws_in_training`` (SprintDiT) gets a
  second one for its forward, seeded from that step seed (the reference's
  call-time ``rngs``, the fourth split of the step key);
- gradient accumulation with ``optax.MultiSteps`` semantics
  (:class:`MultiStepOptimizer`: the mean of k micro-gradients, one update
  every k micro-steps, Adam's bias correction counting updates only);
- the scheduler as a ``LambdaLR`` multiplier with the reference's
  per-epoch or per-batch index (trainer.py:584-598);
- EMA with ema-pytorch semantics on the raw micro-step counter, with
  ``update_after_step`` and ``update_every`` multiplied by the accumulation
  (trainer.py:113-119);
- post-hoc EMA (``posthoc_ema``, :mod:`.posthoc_ema`): one power-function
  track per gamma, fp32 copies of the trainable parameters updated after
  every micro-step with the raw counter (trainer.py:381-386), snapshot in
  fp16 every epoch under ``checkpoints/phema/`` through the asynchronous
  checkpointer (:712-722), and on resume restored from the newest snapshot
  at or before the resume step, never a later one (:234-264);
- the trainable split of :func:`.checkpoint.trainable_filter`: the optimizer
  and the EMA hold the trainable parameters (a frozen context embedder's are
  left out), and checkpoints store them apart from the rest of the state;
- text batches (``ImageNetmultiAR`` + ``collate_fn``): a precomputed
  ``context`` passes through :meth:`BaseTrainer._host_embed` untouched
  unless the context embedder tokenizes (the trainable embedder, whose
  tokens then replace it), and the caption strings (``initial_context``)
  are dropped from the batch the model sees and handed to the tracker with
  the validation images; ``train_embedder`` puts the context embedder's
  parameters in the trainable split, and without it they take no gradient;
- per-epoch train-loss means (one host sync per epoch), the validation loss
  on the EMA weights where there are any, validation images through
  ``Diffuser.generate``, best-val checkpoints, periodic "latest" sets and
  ``auto_resume`` (torch-format checkpoints, :mod:`.checkpoint`).

:func:`train_step` does one step with its randomness given, so that the
parity tests can inject the reference's draws; the loop draws and calls it.
Also mirrored:

- EDM-style non-leaky augmentation (``augment_p > 0``, trainer.py:312-341):
  each step's x0 goes through :class:`..diffuse.augment.AugmentPipe` with
  the step's generator and the labels ride in ``cond["augment_labels"]``;
  refused on reflow batches, whose (noise, data) coupling it would scramble;
- guidance distillation (``distill_teacher`` with ``distill_guidance > 0``,
  trainer.py:278-302): the frozen teacher's guided prediction is the target;
  it is kept out of the trainable split and the checkpoints, and the CFG
  drop is forced off;
- reflow batches: a ``coupled_noise`` model input replaces the step's noise
  draw (trainer.py:329-345);
- extra losses (REPA, ``Diffuser(extra_losses=...)``): ``set_model`` runs
  before the split (trainer.py:567-570), the train and validation forwards
  capture features (:283), and the extra losses' trainable parameters (the
  projector) share the optimizer, the EMA and the checkpoints with the
  denoiser's (:class:`.checkpoint.TrainModules`), the frozen encoder in the
  checkpoint's ``rest``; a batch's ``extra`` (precomputed ``dst_features``)
  reaches them as keywords (:363, :408).

- LoRA (``lora_only``, trainer.py:528, :607): the trainable split holds the
  adapters alone (:func:`.checkpoint.trainable_filter` with ``lora=True``),
  so the optimizer and the EMA hold them and the base weights ride in the
  checkpoint's ``rest``.

Not ported yet (it raises ``NotImplementedError``, ROADMAP queue 1): meshes
of more than one device (item 17). The HF text embedders' ``embed_host``
turns caption strings into conditioning on the host (:meth:`BaseTrainer._host_embed`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging as pylog
import shutil
from datetime import datetime
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from diffulab_tpu_torch.diffuse.augment import AugmentPipe
from diffulab_tpu_torch.diffuse.diffuser import Diffuser
from diffulab_tpu_torch.networks.nn import make_drop_mask
from diffulab_tpu_torch.training.checkpoint import (
    STATE_FILE,
    AsyncCheckpointer,
    map_tensors,
    restore_checkpoint,
    save_checkpoint,
    split_state,
    train_modules,
    trainable_filter,
)
from diffulab_tpu_torch.training.ema import EMAConfig, ema_update, init_ema
from diffulab_tpu_torch.training.logging import Tracker
from diffulab_tpu_torch.training.meters import AverageMeter
from diffulab_tpu_torch.training.optim import OptimizerFactory, clip_by_global_norm
from diffulab_tpu_torch.training.posthoc_ema import (
    DEFAULT_GAMMAS,
    cast_tree_f16,
    init_tracks,
    list_snapshots,
    power_ema_update,
    snapshot_dir,
)
from diffulab_tpu_torch.utils import resolve_device

logger = pylog.getLogger(__name__)

#: offset of the validation draws' seeds, as the reference's fold_in(rng, 1_000_000 + i)
_VAL_SEED_OFFSET = 1_000_000
_IMAGE_SEED_OFFSET = 10_000
#: index of the denoiser's draws under a step's seed: the fourth of the
#: reference's split of the step key, its call-time ``rngs`` (trainer.py:342-355)
_MODEL_DRAW = 3


def _fold_seed(seed: int, index: int) -> int:
    """A generator seed for draw ``index`` of the run seeded ``seed``."""
    return (int(seed) * 1_000_003 + int(index)) % (2**63)


class MultiStepOptimizer:
    """A torch optimizer under ``optax.MultiSteps`` semantics.

    Call :meth:`step` after each micro-batch's ``backward()``. Every
    ``every_k``-th call divides the summed gradients by k (``backward()``
    sums, MultiSteps averages), clips them by global norm with optax's rule
    when ``grad_clip_norm`` is set, steps the optimizer and the scheduler
    and zeroes the gradients; the calls in between only accumulate. A
    parameter the loss did not reach (the last dual-stream block's text
    stream) gets a zero gradient before the update, as optax gives every
    leaf one: AdamW then decays it and ages its moments.
    """

    def __init__(self, optimizer: torch.optim.Optimizer, every_k: int = 1,
                 grad_clip_norm: float | None = None,
                 scheduler: torch.optim.lr_scheduler.LRScheduler | None = None):
        self.optimizer = optimizer
        self.every_k = int(every_k)
        self.grad_clip_norm = grad_clip_norm
        self.scheduler = scheduler
        self.mini_step = 0
        self.optimizer.zero_grad(set_to_none=True)

    def _params(self) -> list[torch.nn.Parameter]:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def step(self) -> bool:
        """Returns whether this call applied an update."""
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return False
        for p in self._params():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self._params()]
        if self.every_k > 1:
            torch._foreach_div_(grads, float(self.every_k))
        if self.grad_clip_norm:
            clip_by_global_norm(grads, self.grad_clip_norm)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.mini_step = 0
        return True

    def state_dict(self) -> dict[str, Any]:
        acc = {}
        if self.mini_step:
            acc = {str(i): p.grad for i, p in enumerate(self._params()) if p.grad is not None}
        return {
            "optimizer": self.optimizer.state_dict(),
            "scheduler": None if self.scheduler is None else self.scheduler.state_dict(),
            "mini_step": self.mini_step,
            "acc_grads": acc,
        }

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None and state.get("scheduler") is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        self.mini_step = int(state.get("mini_step", 0))
        params = self._params()
        for i, grad in state.get("acc_grads", {}).items():
            params[int(i)].grad = grad.to(device=params[int(i)].device, dtype=params[int(i)].dtype)


@dataclasses.dataclass
class EMA:
    """The EMA of the trainable parameters: fp32 tensors by parameter name."""

    config: EMAConfig
    params: dict[str, torch.Tensor]

    def update(self, params: dict[str, torch.Tensor], step: int) -> None:
        ema_update(self.config, self.params, params, step)


def split_batch(batch: dict[str, Any]) -> tuple[torch.Tensor, dict[str, Any], torch.Tensor | None]:
    """(x0, conditioning, coupled noise) of a prepared batch: the conditioning
    is every other model input (``y``, or a text batch's nested ``context``);
    the coupled noise is a reflow batch's ``coupled_noise`` (None elsewhere),
    the z each x was generated from (trainer.py:324-329)."""
    model_inputs = dict(batch["model_inputs"])
    coupled = model_inputs.pop("coupled_noise", None)
    return model_inputs.pop("x"), model_inputs, coupled


@dataclasses.dataclass
class PowerEMA:
    """The post-hoc EMA tracks: one dict of fp32 tensors by parameter name
    per gamma."""

    gammas: tuple[float, ...]
    tracks: tuple[dict[str, torch.Tensor], ...]

    def update(self, params: dict[str, torch.Tensor], step: int) -> None:
        for track, gamma in zip(self.tracks, self.gammas):
            power_ema_update(track, params, step, gamma)


def train_step(
    diffuser: Diffuser,
    optimizer: MultiStepOptimizer,
    ema: EMA | None,
    batch: dict[str, Any],
    t: torch.Tensor,
    noise: torch.Tensor,
    drop: torch.Tensor | None,
    step: int,
    phema: PowerEMA | None = None,
    distill: dict[str, Any] | None = None,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """One micro-step with its randomness given (trainer.py:371-386): the
    loss, its gradients, the (accumulated) optimizer update, and the EMA and
    post-hoc EMA updates at the raw counter ``step``. ``batch`` holds the
    (augmented) x0 and the conditioning; a reflow batch's ``coupled_noise``
    takes the place of ``noise``. ``distill`` is the ``distill_fn`` /
    ``distill_guidance`` pair of guidance distillation. The diffuser's extra
    losses join the loss dict (their features captured by the forward), the
    batch's ``extra`` entries (precomputed ``dst_features``) passed to them.
    ``generator`` is the denoiser's own for the forward's draws (SprintDiT's
    token drop). Returns the detached losses."""
    x0, cond, coupled = split_batch(batch)
    if coupled is not None:
        noise = coupled.to(x0.dtype)
    extra_losses = diffuser.extra_losses
    model_fn = diffuser.model_fn(train=True, capture_features=bool(extra_losses), generator=generator)
    losses = diffuser.diffusion.compute_loss(model_fn, x0, cond, t, noise, drop=drop, extra_losses=extra_losses,
                                             extra_args=batch.get("extra") or {}, **(distill or {}))
    sum(losses.values()).backward()
    optimizer.step()
    if ema is not None or phema is not None:
        params = dict(train_modules(diffuser.denoiser, extra_losses).named_parameters())
        if ema is not None:
            ema.update(params, step)
        if phema is not None:
            phema.update(params, step)
    return {key: value.detach() for key, value in losses.items()}


class Trainer:
    """Run set-up: device, tracker, save paths (reference trainers/common.py:72-114)."""

    def __init__(
        self,
        n_epoch: int,
        gradient_accumulation_step: int = 1,
        precision_type: str = "no",
        save_path: str | Path | None = None,
        project_name: str = "my_project",
        run_config: dict[str, Any] | None = None,
        init_kwargs: dict[str, Any] | None = None,
        use_ema: bool = False,
        ema_rate: float = 0.999,
        ema_update_after_step: int = 0,
        ema_update_every: int = 10,
        ema_inv_gamma: float = 1.0,
        ema_power: float = 2.0 / 3.0,
        mesh: Any = None,
        compile: bool = True,  # noqa: A002 - parity with the reference flag; the port runs eagerly
        log_every_n_steps: int | None = None,
        async_checkpointing: bool = True,
        posthoc_ema: bool = False,
        posthoc_ema_gammas: tuple[float, ...] = DEFAULT_GAMMAS,
        save_every_n_epochs: int | None = None,
        save_optimizer: bool = True,
        augment_p: float = 0.0,
        distill_guidance: float = 0.0,
        device: str | torch.device | None = None,
    ):
        del compile  # config parity: the port runs eagerly
        if mesh is not None:
            sizes = mesh if isinstance(mesh, dict) else dataclasses.asdict(mesh)
            if any(int(n) not in (1, -1) for n in sizes.values()):
                raise NotImplementedError(
                    f"a mesh of more than one device ({sizes}) is not ported yet (ROADMAP queue 1, item 17)"
                )
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.n_epoch = n_epoch
        self.log_every_n_steps = log_every_n_steps
        self.gradient_accumulation_step = gradient_accumulation_step
        self.precision_type = precision_type
        self.use_ema = use_ema
        self.ema_config = EMAConfig(
            beta=ema_rate,
            update_after_step=ema_update_after_step * gradient_accumulation_step,
            update_every=ema_update_every * gradient_accumulation_step,
            inv_gamma=ema_inv_gamma,
            power=ema_power,
        )
        self.posthoc_ema = posthoc_ema
        self.posthoc_ema_gammas = tuple(float(g) for g in posthoc_ema_gammas)
        self.save_every_n_epochs = save_every_n_epochs
        self.save_optimizer = save_optimizer
        # EDM-style non-leaky augmentation (diffuse/augment.py), in the train loss only
        self.augment_p = augment_p
        # guidance distillation: the CFG weight the frozen teacher is evaluated at
        self.distill_guidance = distill_guidance
        if save_path is None:
            save_path = Path.home() / "experiments" / datetime.now().strftime("%Y%m%d_%H%M%S")
        self.save_path = Path(save_path) / project_name
        self.tracker = Tracker(self.save_path, project_name=project_name, run_config=run_config,
                               init_kwargs=init_kwargs)
        self._async_ckptr = AsyncCheckpointer() if async_checkpointing else None
        #: the raw micro-step counter, after train()
        self.step = 0

    # ------------------------------------------------------------------ #
    def _write(self, entries: dict[Path, dict[str, Any]]) -> None:
        if self._async_ckptr is not None:
            self._async_ckptr.save(entries)
        else:
            for path, payload in entries.items():
                save_checkpoint(path, payload)

    def save_model(self, params: dict[str, torch.Tensor], rest: dict[str, torch.Tensor],
                   opt_state: dict[str, Any], ema_params: dict[str, torch.Tensor] | None, step: int) -> None:
        """Best-val checkpoint (reference trainers/common.py:130-176 artifact
        set; the denoiser entry split as :func:`.checkpoint.split_state`)."""
        base = self.save_path / "checkpoints"
        entries: dict[Path, dict[str, Any]] = {base / "denoiser": {"params": params, "rest": rest}}
        if self.save_optimizer:
            entries[base / "optimizer"] = {"opt_state": opt_state}
        if ema_params is not None:
            entries[base / "ema"] = {"params": ema_params}
        entries[base / "scheduler"] = {"step": step}
        self._write(entries)

    def save_latest(self, params: dict[str, torch.Tensor], rest: dict[str, torch.Tensor],
                    opt_state: dict[str, Any], ema_params: dict[str, torch.Tensor] | None, step: int, epoch: int,
                    best_val_loss: float = float("inf")) -> None:
        """Preemption checkpoint in ``checkpoints_latest/ep<N>/``: the full set
        plus resume metadata, the scheduler entry written last so that its
        presence marks the set complete; the previous set is removed first."""
        root = self.save_path / "checkpoints_latest"
        self.wait_for_checkpoints()
        keep = f"ep{epoch:06d}"
        if root.exists():
            for old in root.iterdir():
                if old.name != keep:
                    shutil.rmtree(old, ignore_errors=True)
        base = root / keep
        entries: dict[Path, dict[str, Any]] = {
            base / "denoiser": {"params": params, "rest": rest},
            base / "optimizer": {"opt_state": opt_state},
        }
        if ema_params is not None:
            entries[base / "ema"] = {"params": ema_params}
        entries[base / "scheduler"] = {
            "step": step, "epoch": epoch,
            "best_val_loss": best_val_loss if np.isfinite(best_val_loss) else 1e30,
        }
        self._write(entries)

    @staticmethod
    def find_latest_checkpoint(root: Path) -> Path | None:
        """Newest COMPLETE ``checkpoints_latest/ep*`` set."""
        if not root.exists():
            return None
        for cand in sorted(root.glob("ep*"), reverse=True):
            if all((cand / part / STATE_FILE).is_file() for part in ("scheduler", "denoiser", "optimizer")):
                return cand
        return None

    def wait_for_checkpoints(self) -> None:
        """Join the in-flight background save (re-raising write errors)."""
        if self._async_ckptr is not None:
            self._async_ckptr.wait()

    def _prepare_batch(self, batch: dict[str, Any]) -> dict[str, Any]:
        """Every array leaf to a tensor on the trainer's device; host-only
        leaves (caption strings) dropped, as the reference drops them."""

        def clean(node):
            if isinstance(node, dict):
                out = {}
                for k, v in node.items():
                    v = clean(v)
                    if v is not None:
                        out[k] = v
                return out
            if isinstance(node, torch.Tensor):
                return node.to(self.device, non_blocking=True)
            if isinstance(node, (np.ndarray, np.generic, int, float)):
                return torch.as_tensor(np.asarray(node)).to(self.device)
            return None

        return clean(batch)

    def _init_phema(self, params: dict[str, torch.Tensor], phema_base: Path, resume_step: int) -> PowerEMA:
        """Fresh power-EMA tracks (fp32 copies of the trainable parameters),
        or, when resuming, the stored fp16 snapshots at (or before) the resume
        step. Snapshots PAST the resume point are never used: the re-trained
        steps would be double-counted in the average. The fp16 roundtrip
        costs <1e-3 relative, far under the width of any profile being
        reconstructed."""
        tracks = []
        snaps = list_snapshots(phema_base) if resume_step else []
        for gamma in self.posthoc_ema_gammas:
            candidates = [(s, p) for s, g, p in snaps
                          if abs(g - gamma) < 1e-6 * max(abs(gamma), 1.0) and s <= resume_step]
            track = init_tracks(params)
            if candidates:
                snap_step, path = max(candidates)
                if snap_step != resume_step:
                    logger.warning(
                        f"phema track gamma={gamma}: resuming from snapshot at step "
                        f"{snap_step} != resume step {resume_step}; the gap's steps "
                        "are missing from this track's average"
                    )
                track = restore_checkpoint(path, {"params": track})["params"]
            tracks.append(track)
        return PowerEMA(self.posthoc_ema_gammas, tuple(tracks))


@contextlib.contextmanager
def _swapped_params(model: torch.nn.Module, params: dict[str, torch.Tensor] | None) -> Iterator[None]:
    """Run the block with ``params`` (e.g. the EMA of the trainable
    parameters) in those of the model's parameters, then put the live ones back."""
    if params is None:
        yield
        return
    live = dict(model.named_parameters())
    saved = {name: live[name].detach().clone() for name in params}
    with torch.no_grad():
        for name, value in params.items():
            live[name].copy_(value)
    try:
        yield
    finally:
        with torch.no_grad():
            for name, value in saved.items():
                live[name].copy_(value)


class BaseTrainer(Trainer):
    """Supervised diffusion training loop (reference base_trainer.py:22-399)."""

    @staticmethod
    def _host_embed(batch: dict[str, Any], diffuser: Diffuser) -> dict[str, Any]:
        """Embed raw caption strings on the host (reference trainer.py:417-438):
        an embedder with ``tokenize`` (the trainable one; its tokens replace a
        precomputed ``context`` the shards carry) or ``embed_host`` (the HF
        embedders of ``networks/embedders/hf_text.py``, when the batch has no
        precomputed ``context``) turns
        ``initial_context`` into the ``context``; otherwise the batch passes
        through untouched, as it does for a :class:`PrecomputedEmbedder`."""
        mi = batch.get("model_inputs", {})
        texts = mi.get("initial_context")
        embedder = getattr(diffuser.denoiser, "context_embedder", None)
        if texts is None:
            return batch
        if hasattr(embedder, "tokenize"):
            out = embedder.tokenize(list(texts))
        elif hasattr(embedder, "embed_host") and "context" not in mi:
            out = embedder.embed_host(list(texts))
        else:
            return batch
        return {**batch, "model_inputs": {**mi, "context": dict(out)}}

    def log_images(
        self,
        diffuser: Diffuser,
        val_batch: dict[str, Any],
        epoch: int,
        val_steps: int,
        step_shift: float | None = None,
        guidance_scale: float = 4.0,
        generator: torch.Generator | None = None,
    ) -> None:
        """Generate a validation grid with a temporarily re-stepped sampler
        (reference trainers/common.py:178-242, trainer.py:465-506) from the
        first ``min(8, batch)`` rows of a raw validation batch; a text batch's
        captions go to the tracker beside the images."""
        original = diffuser.diffusion
        diffuser.set_steps(val_steps, **({} if step_shift is None else {"shift": step_shift}))
        try:
            val_batch = self._host_embed(val_batch, diffuser)
            captions_raw = val_batch["model_inputs"].get("initial_context")
            x_ref, cond, _ = split_batch(self._prepare_batch(val_batch))
            n = min(8, x_ref.shape[0])
            # x_ref's shape is the latent shape when the diffuser has a vision tower
            out = diffuser.generate(map_tensors(cond, lambda t: t[:n]), data_shape=(n, *x_ref.shape[1:]),
                                    generator=generator, guidance_scale=guidance_scale, device=self.device)
            images = np.clip(out["x"].float().cpu().numpy() * 0.5 + 0.5, 0, 1)
            captions = list(captions_raw[:n]) if isinstance(captions_raw, (list, tuple)) else None
            self.tracker.log_images(images, step=epoch + 1, captions=captions)
        finally:
            diffuser.diffusion = original

    # ------------------------------------------------------------------ #
    def train(
        self,
        diffuser: Diffuser,
        optimizer: OptimizerFactory | Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer],
        train_dataloader: Iterable[dict[str, Any]],
        val_dataloader: Iterable[dict[str, Any]] | None = None,
        scheduler: Callable[[int], float] | None = None,
        per_batch_scheduler: bool = False,
        log_validation_images: bool = True,
        train_embedder: bool = False,
        p_classifier_free_guidance: float = 0.2,
        val_steps: int = 50,
        val_step_shift: float | None = None,
        optimizer_ckpt: str | None = None,
        denoiser_ckpt: str | None = None,
        ema_ckpt: str | None = None,
        epoch_start: int = 0,
        seed: int = 0,
        steps_per_epoch: int | None = None,
        lora_only: bool = False,
        auto_resume: bool = False,
        distill_teacher: Any = None,
    ) -> None:
        model = diffuser.denoiser
        extra_losses = diffuser.extra_losses
        # attach the extra losses (REPA's feature-capture registration) before the split
        for loss in extra_losses:
            loss.set_model(model)
        capture = bool(extra_losses)
        # the trainable split (checkpoint.py::trainable_filter) of the denoiser and its extra
        # losses sets what the optimizer and the EMA hold, and the checkpoint layout
        modules = train_modules(model, extra_losses)
        trainable = trainable_filter(model, lora=lora_only, train_embedder=train_embedder)
        params = {name: p for name, p in modules.named_parameters() if trainable(name)}
        if lora_only and not params:
            raise ValueError("lora_only trains the adapters alone, and the model has none: wrap it with "
                             "training.lora.apply_lora first")
        # the reference differentiates the trainable split alone (trainer.py:608): a frozen context
        # embedder's forward builds no graph, so its attention runs no backward
        for name, p in modules.named_parameters():
            p.requires_grad_(trainable(name))
        off = sorted({str(p.device) for p in modules.parameters() if p.device != self.device})
        if off:
            raise ValueError(f"the model's parameters are on {off}, the trainer runs on {self.device}; "
                             "build the model on the trainer's device")

        resume_best_val = float("inf")
        if auto_resume:
            # the newest complete periodic set overrides explicit checkpoint arguments
            latest = self.find_latest_checkpoint(self.save_path / "checkpoints_latest")
            if latest is not None:
                meta = restore_checkpoint(latest / "scheduler")
                epoch_start = int(meta["epoch"])
                resume_best_val = float(meta.get("best_val_loss", float("inf")))
                denoiser_ckpt = str(latest / "denoiser")
                optimizer_ckpt = str(latest / "optimizer")
                ema_ckpt = str(latest / "ema") if (latest / "ema").exists() else None
                logger.info(f"auto-resume from {latest} at epoch {epoch_start}")

        if val_step_shift is not None and diffuser.model_type != "rectified_flow":
            raise ValueError("Time-shifting during validation is only supported for flow-based models.")
        if not getattr(model, "classifier_free", False):
            p_classifier_free_guidance = 0.0
        distill = None
        if distill_teacher is not None:
            if self.distill_guidance <= 0:
                raise ValueError("distill_teacher needs trainer.distill_guidance > 0 (the CFG weight being "
                                 "distilled into the student)")
            # the student regresses onto guided targets and samples at guidance 0:
            # training its own uncond branch is meaningless
            p_classifier_free_guidance = 0.0
            distill_teacher.eval().requires_grad_(False)  # frozen, outside the trainable split
            distill = {"distill_fn": Diffuser._model_fn(distill_teacher, train=False),
                       "distill_guidance": self.distill_guidance}
            logger.info(f"guidance distillation: teacher CFG w={self.distill_guidance}, p_cfg forced to 0")
        augment_pipe = None
        if self.augment_p > 0:
            if getattr(model, "augment_embed", None) is None:
                raise ValueError("trainer.augment_p > 0 requires the model's augment_dim > 0 (the non-leaky "
                                 "conditioning path, diffuse/augment.py)")
            augment_pipe = AugmentPipe(p=self.augment_p)

        # --- optimizer: schedule + gradient accumulation -------------------
        if denoiser_ckpt:
            live_params, live_rest = split_state(modules, trainable)
            restored = restore_checkpoint(denoiser_ckpt, {"params": live_params, "rest": live_rest})
            modules.load_state_dict({**restored["params"], **restored["rest"]}, strict=True)
        torch_opt = optimizer(list(params.values()))
        lr_scheduler = None
        if scheduler is not None:
            if steps_per_epoch is None and not per_batch_scheduler:
                try:
                    steps_per_epoch = len(train_dataloader)  # type: ignore[arg-type]
                except TypeError as e:
                    raise ValueError("steps_per_epoch required for per-epoch scheduler") from e
            if per_batch_scheduler:
                idx = lambda c: c  # noqa: E731
            else:
                # the schedule counts real updates; steps_per_epoch counts micro-batches
                updates_per_epoch = max(steps_per_epoch // self.gradient_accumulation_step, 1)
                idx = lambda c: c // updates_per_epoch  # noqa: E731
            lr_scheduler = torch.optim.lr_scheduler.LambdaLR(torch_opt, lambda c: float(scheduler(idx(c))))
        opt = MultiStepOptimizer(torch_opt, self.gradient_accumulation_step,
                                 getattr(optimizer, "grad_clip_norm", None), lr_scheduler)
        if optimizer_ckpt:
            opt.load_state_dict(restore_checkpoint(optimizer_ckpt)["opt_state"])

        ema = None
        if self.use_ema:
            ema = EMA(self.ema_config, init_ema(params))
            if ema_ckpt:
                ema.params = restore_checkpoint(ema_ckpt, {"params": ema.params})["params"]

        if epoch_start and steps_per_epoch is None:
            # resume continues the raw step counter: it drives the EMA ramp and the draws
            try:
                steps_per_epoch = len(train_dataloader)  # type: ignore[arg-type]
            except TypeError as e:
                raise ValueError("epoch_start > 0 requires steps_per_epoch when the "
                                 "dataloader has no len()") from e
        step = epoch_start * (steps_per_epoch or 0)
        phema = None
        phema_base = self.save_path / "checkpoints" / "phema"
        if self.posthoc_ema:
            phema = self._init_phema(params, phema_base, step)

        best_val_loss = resume_best_val
        tracker_meter = AverageMeter()
        generator = torch.Generator(device=self.device)
        # the denoiser's own draws (SprintDiT's token drop), from a generator seeded per step
        model_generator = (torch.Generator(device=self.device)
                           if getattr(diffuser.denoiser, "draws_in_training", False) else None)
        diffusion = diffuser.diffusion

        logger.info("Begin training")
        for epoch in range(epoch_start, self.n_epoch):
            if hasattr(train_dataloader, "set_epoch"):
                train_dataloader.set_epoch(epoch)
            # --- train epoch: losses summed on the card, one host sync per epoch
            loss_sums: dict[str, torch.Tensor] = {}
            n_steps_epoch = 0
            modules.train()
            for batch in train_dataloader:
                batch = self._prepare_batch(self._host_embed(batch, diffuser))
                step += 1
                generator.manual_seed(_fold_seed(seed, step))
                mi = batch["model_inputs"]
                x0 = mi["x"]
                bsz = x0.shape[0]
                if augment_pipe is not None:
                    if "coupled_noise" in mi:
                        raise ValueError(
                            "trainer.augment_p > 0 would scramble a reflow dataset's deterministic (noise, "
                            "data) coupling: the flip/rotate/translate of x0 cannot be applied to its paired z. "
                            "Disable augmentation for straightening runs.")
                    x0, labels = augment_pipe(x0, generator)
                    batch = {**batch, "model_inputs": {**mi, "x": x0, "augment_labels": labels}}
                t = diffusion.draw_timesteps(generator, bsz)
                noise = None
                if "coupled_noise" not in mi:
                    noise = torch.randn(x0.shape, generator=generator, device=self.device, dtype=x0.dtype)
                drop = None
                if p_classifier_free_guidance > 0:
                    drop = make_drop_mask(generator, p_classifier_free_guidance, bsz)
                extra: dict[str, Any] = {"distill": distill} if distill else {}
                if model_generator is not None:
                    extra["generator"] = model_generator.manual_seed(_fold_seed(_fold_seed(seed, step), _MODEL_DRAW))
                losses = train_step(diffuser, opt, ema, batch, t, noise, drop, step, phema, **extra)
                n_steps_epoch += 1
                for key, loss in losses.items():
                    prev = loss_sums.get(key)
                    loss_sums[key] = loss if prev is None else prev + loss
                if self.log_every_n_steps and step % self.log_every_n_steps == 0:
                    self.tracker.log({f"train_step/{k}": float(v) for k, v in losses.items()}, step=step)
            self.step = step

            for key, total in loss_sums.items():
                tracker_meter.update(float(total) / max(n_steps_epoch, 1), key=f"train/{key}")
            for key, value in tracker_meter.avg.items():
                if key.startswith("train/"):
                    self.tracker.log({key: value, "epoch": epoch + 1}, step=step)
            tracker_meter.reset()

            # post-hoc EMA snapshots go out EVERY epoch (the reconstruction
            # basis must cover the whole trajectory, unlike best-val checkpoints)
            if phema is not None:
                self._write({snapshot_dir(phema_base, step, gamma): {"params": cast_tree_f16(track)}
                             for gamma, track in zip(phema.gammas, phema.tracks)})

            # --- validation, on the EMA weights where there are any ------------
            if val_dataloader is not None:
                modules.eval()
                with _swapped_params(modules, None if ema is None else ema.params), torch.no_grad():
                    val_sums: dict[str, torch.Tensor] = {}
                    n_val = 0
                    for vi, val_batch in enumerate(val_dataloader):
                        val_batch = self._prepare_batch(self._host_embed(val_batch, diffuser))
                        generator.manual_seed(_fold_seed(seed, _VAL_SEED_OFFSET + vi))
                        x0, cond, coupled = split_batch(val_batch)
                        t = diffusion.draw_timesteps(generator, x0.shape[0])
                        noise = (coupled.to(x0.dtype) if coupled is not None else
                                 torch.randn(x0.shape, generator=generator, device=self.device, dtype=x0.dtype))
                        val_losses = diffusion.compute_loss(
                            diffuser.model_fn(train=False, capture_features=capture), x0, cond, t, noise,
                            extra_losses=extra_losses, extra_args=val_batch.get("extra") or {}, **(distill or {}))
                        n_val += 1
                        for key, val_loss in val_losses.items():
                            prev = val_sums.get(key)
                            val_sums[key] = val_loss if prev is None else prev + val_loss
                    for key, total in val_sums.items():
                        tracker_meter.update(float(total) / max(n_val, 1), key=f"val/{key}")

                    total_loss = 0.0
                    for key, value in tracker_meter.avg.items():
                        if key.startswith("val/"):
                            self.tracker.log({key: value, "epoch": epoch + 1}, step=step)
                            total_loss += value

                    if log_validation_images:
                        logger.info("creating validation images")
                        first_val = next(iter(val_dataloader))
                        image_gen = torch.Generator(device=self.device)
                        image_gen.manual_seed(_fold_seed(seed, _IMAGE_SEED_OFFSET + epoch))
                        self.log_images(
                            diffuser, first_val, epoch, val_steps, step_shift=val_step_shift,
                            guidance_scale=4.0 if getattr(model, "classifier_free", False) else 0.0,
                            generator=image_gen,
                        )

                if total_loss < best_val_loss:
                    best_val_loss = total_loss
                    self.save_model(*split_state(modules, trainable), opt.state_dict(),
                                    None if ema is None else ema.params, step)
                tracker_meter.reset()

            if self.save_every_n_epochs and (epoch + 1) % self.save_every_n_epochs == 0:
                self.save_latest(*split_state(modules, trainable), opt.state_dict(),
                                 None if ema is None else ema.params, step, epoch + 1, best_val_loss=best_val_loss)

        self.step = step
        self.wait_for_checkpoints()
        self.tracker.finish()
        logger.info("Training complete")
