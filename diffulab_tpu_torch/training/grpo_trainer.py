"""GRPO post-training on one card (port of diffulab_tpu/training/grpo_trainer.py;
reference trainers/grpo_trainer.py:25-623).

The RL alignment loop, per batch of P prompts:

- SAMPLE: each prompt gets one shared ``x_init``; for each of the
  ``n_image_per_prompt`` groups (and each ``mini_batch_size`` chunk of
  prompts) the Euler-Maruyama reverse process runs with its intermediates
  (``xt``, ``xt_mean``, ``logprob``) under fused CFG, in eval mode and
  without gradients, and its latents are decoded through the vision tower;
  with ``offload_trajectories`` each group's trajectory moves to host memory
  until its learn step;
- REWARD (host): the images in prompt-major ``[P·N]`` order go to the reward
  model, whose advantages come back per image;
- LEARN, one step a group: the clipped-ratio objective
  (:meth:`~diffulab_tpu_torch.diffuse.flow.Flow.compute_loss_grpo`, one
  backward a trajectory index), ``grad_norm`` (the raw global norm, before any
  clip), the AdamW step and the EMA.

On the card the denoiser's attention runs the flash kernels past 512 tokens
(K3 forward, K4 and K5 backward) and the fused ones below (K1, K2).

The trust region (grpo_trainer.py:147-170, :276-284): ``params_ref`` is a
copy of the trainable parameters taken once a batch, before its first group.
When a learn step's ``ratio_dev`` (mean ``|ratio - 1|``, measured before the
step) exceeds ``trust_region``, the update is rejected: the parameters go
back to ``params_ref``, the optimizer state stays as it was before the step
(the optimizer does not step, so AdamW's moments and step count are
untouched), the EMA is not updated, and the persistent ``lr_scale`` is
multiplied by ``trust_region_backoff``. An accepted step moves the
parameters by ``lr_scale`` times the optimizer's update, weight decay
included (``p_old + lr_scale · (p_stepped - p_old)``), as the reference
scales optax's ``updates``. ``ratio_dev`` is known before the update, so the
port decides first and steps only on an accepted update, where the
reference computes both and selects.

Every random draw of a batch goes through a :class:`SeededDraws` (or any
object with its three methods): ``x_init``, each sampled chunk's SDE noise
and each learn step's trajectory indices, from torch generators seeded from
(seed, batch key, the reference's key offset); the parity tests pass the
reference's draws instead (trap T4).

Checkpoints, metrics, validation on the EMA weights and the best-validation
save work as in :class:`~diffulab_tpu_torch.training.trainer.BaseTrainer`;
a failed validation image grid raises (the reference logs it and goes on).

``trainer.mesh`` (grpo_trainer.py:200-208, 337-360): the parameters are
sharded as BaseTrainer shards them, and the prompt batch over ``(data,
fsdp)``: each process samples, rewards and learns on its own rows (its
loader's slice), with its rows of the batch's draws made for the global
batch (``x_init`` and each step's SDE noise, T28); each learn step's
gradients are averaged over the processes before its norm and update, and
``ratio_dev`` (the trust region's test) and the logged means are the global
batch's. A ``mini_batch_size`` smaller than the process's prompts raises
under a sharded batch (the reference's chunks run over the global batch).
"""

from __future__ import annotations

import logging as pylog
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from diffulab_tpu_torch.diffuse.diffuser import Diffuser
from diffulab_tpu_torch.diffuse.flow import Flow, NoiseFn, generator_noise
from diffulab_tpu_torch.networks.rewards.common import RewardModel
from diffulab_tpu_torch.parallel.mesh import batch_shard
from diffulab_tpu_torch.parallel.sharding import full_tensor, full_tensors, shard_like, shard_model, sync_grads
from diffulab_tpu_torch.training.checkpoint import (
    map_tensors,
    restore_checkpoint,
    split_state,
    to_cpu,
    train_modules,
    trainable_filter,
)
from diffulab_tpu_torch.training.ema import init_ema
from diffulab_tpu_torch.training.meters import AverageMeter
from diffulab_tpu_torch.training.optim import OptimizerFactory, global_norm
from diffulab_tpu_torch.training.trainer import (
    EMA,
    MultiStepOptimizer,
    Trainer,
    _fold_seed,
    _full_split,
    _opt_state_map,
    _restore_placed,
    _swapped_params,
)

logger = pylog.getLogger(__name__)

#: the reference's keys: a train batch folds ``epoch * EPOCH_STRIDE + i`` into the run key, a validation batch
#: ``VAL_BATCH_KEY + i``, an epoch's validation images ``IMAGE_KEY + epoch`` (grpo_trainer.py:420-453)
EPOCH_STRIDE, VAL_BATCH_KEY, IMAGE_KEY = 100_000, 999_000, 555
#: under a batch's key: x_init, sampling (``+ group * GROUP_STRIDE + first prompt``) and learning (``+ group``)
X_INIT_KEY, SAMPLE_KEY, LEARN_KEY, GROUP_STRIDE = 0, 100, 200, 4096


class SeededDraws:
    """One batch's randomness from torch generators on ``device``, seeded
    from (``seed``, ``batch_key``) and the reference's offsets under a
    batch's key."""

    def __init__(self, seed: int, batch_key: int, device: torch.device):
        self.seed = _fold_seed(seed, batch_key)
        self.device = device

    def _generator(self, offset: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(_fold_seed(self.seed, offset))

    def x_init(self, shape: tuple[int, ...]) -> torch.Tensor:
        """The prompts' shared starting noise (fp32)."""
        return torch.randn(shape, generator=self._generator(X_INIT_KEY), device=self.device)

    def sample_noise(self, group: int, start: int) -> NoiseFn:
        """The ``draw_noise`` of group ``group``'s chunk from prompt ``start``."""
        return generator_noise(self._generator(SAMPLE_KEY + group * GROUP_STRIDE + start), self.device)

    def indices(self, group: int, steps: int, k: int) -> list[int]:
        """Group ``group``'s learn-step trajectory indices: k of ``steps``, without replacement."""
        perm = torch.randperm(steps, generator=self._generator(LEARN_KEY + group), device=self.device)
        return perm[:k].tolist()


class GRPOTrainer(Trainer):
    """GRPO trainer on one card.

    ``mini_batch_size`` bounds how many prompts one sampling call takes
    (reference grpo_trainer.py:237-242: full EM trajectories of 16 images a
    prompt explode memory); a batch it does not divide is sampled whole.
    ``offload_trajectories`` moves each group's trajectory to host memory
    after sampling, so that at most one group's is on the card at a time.
    ``eps`` is the PPO clip range (the reference defaults 1e-4, measured to
    clip away the policy-gradient signal; 0.1 here as in the JAX package);
    ``trust_region`` (None disables it) and ``trust_region_backoff`` are the
    guard of the module docstring.
    """

    def __init__(self, *args: Any, timestep_fraction: float = 0.6, kl_beta: float = 0.0,
                 eps: float = 0.1, mini_batch_size: int | None = None,
                 offload_trajectories: bool = True, trust_region: float | None = 0.3,
                 trust_region_backoff: float = 0.5, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.timestep_fraction = timestep_fraction
        self.kl_beta = kl_beta
        self.eps = eps
        self.mini_batch_size = mini_batch_size
        self.offload_trajectories = offload_trajectories
        self.trust_region = trust_region
        self.trust_region_backoff = trust_region_backoff
        #: the persistent trust-region scale of the updates (shrinks on each rejected update)
        self.lr_scale = 1.0

    # ------------------------------------------------------------------ #
    @staticmethod
    def _data_shape(diffuser: Diffuser, batch_size: int, image_resolution: Sequence[int]) -> tuple[int, ...]:
        """NHWC sampling shape (reference sample_model, :203-216)."""
        if diffuser.vision_tower is not None:
            f = diffuser.vision_tower.compression_factor
            return (batch_size, image_resolution[0] // f, image_resolution[1] // f,
                    diffuser.vision_tower.latent_channels)
        return (batch_size, image_resolution[0], image_resolution[1], 3)

    def _grpo_args(self, guidance_scale: float) -> dict[str, Any]:
        return dict(kl_beta=self.kl_beta, eps=self.eps, timestep_fraction=self.timestep_fraction,
                    guidance_scale=guidance_scale)

    @staticmethod
    def sample_group(diffuser: Diffuser, x_init: torch.Tensor, cond: dict[str, Any], guidance_scale: float,
                     draw_noise: NoiseFn) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """One sampled chunk of a group (grpo_trainer.py:101-118): the
        Euler-Maruyama reverse process from ``x_init`` with its intermediates,
        fused CFG when ``guidance_scale > 0``, the denoiser in eval mode and
        no gradients; returns the trajectory and the decoded pixels
        (``x / latent_scale + latent_bias`` through the tower, unclipped)."""
        with torch.no_grad():
            out = diffuser.diffusion.denoise(
                diffuser.model_fn(train=False), cond, x=x_init, guidance_scale=guidance_scale,
                use_cfg=guidance_scale > 0, return_intermediates=True, device=x_init.device, draw_noise=draw_noise)
            decoded = out["x"]
            if diffuser.vision_tower is not None:
                decoded = diffuser.vision_tower.decode(decoded / diffuser.latent_scale + diffuser.latent_bias)
        return out, decoded

    def learn_step(self, diffuser: Diffuser, optimizer: MultiStepOptimizer, ema: EMA | None,
                   params: dict[str, torch.nn.Parameter], params_ref: dict[str, torch.Tensor] | None,
                   cond: dict[str, Any], sampling: dict[str, torch.Tensor], advantages: torch.Tensor,
                   indices: Sequence[int], step: int, guidance_scale: float) -> dict[str, torch.Tensor]:
        """One learn step on one group (grpo_trainer.py:122-172) with the
        denoiser in train mode: the loss and its gradient (one backward a
        trajectory index), ``grad_norm``, the optimizer step under the trust
        region and the EMA at the raw counter ``step``. Gradients of earlier
        micro-steps of an accumulation stay apart until the step is accepted.
        Returns the detached losses, with ``tr_reject`` and ``lr_scale`` when
        the trust region is on."""
        tensors = list(params.values())
        carried = [p.grad for p in tensors]
        for p in tensors:
            p.grad = None
        losses = diffuser.diffusion.compute_loss_grpo(
            diffuser.model_fn(train=True), cond, sampling, advantages, indices=indices, backward=True,
            **self._grpo_args(guidance_scale))
        if self._batch_group is not None:  # the global batch's gradient and statistics
            sync_grads(tensors, self.mesh)
            losses = self._batch_mean(losses)
        grads = [p.grad for p in tensors if p.grad is not None]
        losses["grad_norm"] = global_norm(grads) if grads else torch.zeros((), device=advantages.device)
        reject = self.trust_region is not None and float(losses["ratio_dev"]) > self.trust_region
        with torch.no_grad():
            if reject:
                for p, grad, ref in zip(tensors, carried, params_ref.values()):
                    p.grad = grad
                    p.copy_(ref)
                self.lr_scale *= self.trust_region_backoff
            else:
                for p, grad in zip(tensors, carried):
                    if grad is not None:
                        p.grad = grad if p.grad is None else grad.add_(p.grad)
                old = [p.detach().clone() for p in tensors] if self.lr_scale != 1.0 else None
                if optimizer.step() and old is not None:
                    for p, p_old in zip(tensors, old):
                        p.copy_(p_old + self.lr_scale * (p - p_old))
                if ema is not None:
                    ema.update(params, step)
        if self.trust_region is not None:
            losses["tr_reject"] = torch.tensor(float(reject))
            losses["lr_scale"] = torch.tensor(self.lr_scale)
        return {key: value.detach() for key, value in losses.items()}

    def _run_batch(self, batch: dict[str, Any], diffuser: Diffuser, reward_model: RewardModel,
                   optimizer: MultiStepOptimizer, ema: EMA | None, params: dict[str, torch.nn.Parameter],
                   draws: Any, step: int, n_image_per_prompt: int, tracker: AverageMeter, guidance_scale: float,
                   train: bool) -> int:
        """Sample, reward and learn on one batch (grpo_trainer.py:220-299);
        validation samples and evaluates with the EMA weights. Returns the
        raw step counter, one step a group on a train batch."""
        modules = train_modules(diffuser.denoiser, diffuser.extra_losses)
        captions = batch.get("extra", {}).get("captions")
        if captions is None:
            raise ValueError("GRPO batches need extra['captions']")
        model_inputs = self._prepare_batch({"model_inputs": batch["model_inputs"]})["model_inputs"]
        cond = {k: v for k, v in model_inputs.items() if k != "x"}
        p = len(captions)
        _, n_shards = batch_shard(self.mesh)
        x_init = model_inputs.get("x")
        if x_init is None:
            # drawn for the global batch, this process's rows kept (T28)
            x_init = self._local_rows(draws.x_init((p * n_shards, *self._grpo_shape[1:])))
        if x_init.shape[0] != p:
            raise ValueError(f"x_init {tuple(x_init.shape)} for {p} prompts")
        mini = self.mini_batch_size or p
        if p % mini != 0:
            mini = p
        if n_shards > 1 and mini != p:
            raise NotImplementedError("mini_batch_size chunks the global prompt batch; it is sharded over "
                                      "(data, fsdp) here")
        diffusion = diffuser.diffusion
        k = round(diffusion.steps * self.timestep_fraction)
        prefix = "train" if train else "val"

        with _swapped_params(modules, None if train or ema is None else ema.params):
            # --- SAMPLE: one trajectory set per image-per-prompt group --------
            modules.eval()
            samplings, decoded_all = [], []
            for g in range(n_image_per_prompt):
                chunks, dec_chunks = [], []
                for c0 in range(0, p, mini):
                    out, decoded = self.sample_group(diffuser, x_init[c0:c0 + mini],
                                                     map_tensors(cond, lambda t: t[c0:c0 + mini]), guidance_scale,
                                                     self._local_noise(draws.sample_noise(g, c0)))
                    chunks.append(to_cpu(out) if self.offload_trajectories else out)
                    dec_chunks.append(decoded.float().cpu().numpy())
                samplings.append({key: torch.cat([c[key] for c in chunks]) for key in chunks[0]})
                decoded_all.append(np.concatenate(dec_chunks, axis=0))

            # --- REWARD (host): the groups are N x [P], the reward model wants [P*N] prompt-major
            images = np.stack(decoded_all, axis=1).reshape(p * n_image_per_prompt, *decoded_all[0].shape[1:])
            advantages = np.asarray(reward_model(images=images, context=list(captions)), np.float32)
            advantages = advantages.reshape(p, n_image_per_prompt)

            # --- LEARN per group ---------------------------------------------
            params_ref = ({name: value.detach().clone() for name, value in params.items()}
                          if train and self.trust_region is not None else None)
            for g, sampling in enumerate(samplings):
                sampling = map_tensors(sampling, lambda t: t.to(self.device))
                adv_g = torch.as_tensor(advantages[:, g], device=self.device)
                indices = draws.indices(g, diffusion.steps, k)
                if train:
                    step += 1
                    modules.train()
                    losses = self.learn_step(diffuser, optimizer, ema, params, params_ref, cond, sampling, adv_g,
                                             indices, step, guidance_scale)
                else:
                    with torch.no_grad():
                        losses = self._batch_mean(diffusion.compute_loss_grpo(
                            diffuser.model_fn(train=False), cond, sampling, adv_g, indices=indices,
                            **self._grpo_args(guidance_scale)))
                for key, loss in losses.items():
                    tracker.update(float(loss), key=f"{prefix}/{key}")
        means = {"advantage_mean": float(advantages.mean())}
        # absolute reward curves (z-scored advantages are 0-mean by design)
        raw_metrics = getattr(reward_model, "raw_metrics", None)
        if raw_metrics is not None:
            means.update({key: float(value) for key, value in raw_metrics(images, list(captions)).items()})
        means = self._batch_mean({k: torch.tensor(v, device=self.device) for k, v in means.items()})
        for key, value in means.items():
            tracker.update(float(value), key=f"{prefix}/{key}")
        return step

    def _local_noise(self, draw: NoiseFn) -> NoiseFn:
        """``draw`` made for the global batch, this process's rows kept (T28)."""
        _, n_shards = batch_shard(self.mesh)
        if n_shards == 1:
            return draw
        return lambda kind, step, shape, dtype: self._local_rows(draw(kind, step, (shape[0] * n_shards,
                                                                                   *shape[1:]), dtype))

    def log_images(self, diffuser: Diffuser, val_batch: dict[str, Any], ema: EMA | None, epoch: int,
                   guidance_scale: float, seed: int) -> None:
        """One grid from the first ``min(4, P)`` prompts of a validation
        batch, sampled with the EMA weights and decoded (grpo_trainer.py:428-450)."""
        modules = train_modules(diffuser.denoiser, diffuser.extra_losses)
        inputs = self._prepare_batch({"model_inputs": val_batch["model_inputs"]})["model_inputs"]
        n = min(4, self._grpo_shape[0])
        cond = map_tensors({k: v for k, v in inputs.items() if k != "x"}, lambda t: t[:n])
        generator = torch.Generator(device=self.device).manual_seed(_fold_seed(seed, IMAGE_KEY + epoch))
        modules.eval()
        with _swapped_params(modules, None if ema is None else ema.params):
            out = diffuser.generate(cond, data_shape=(n, *self._grpo_shape[1:]), generator=generator,
                                    guidance_scale=guidance_scale, device=self.device)
        self.tracker.log_images(np.clip(out["x"].float().cpu().numpy() * 0.5 + 0.5, 0, 1), step=epoch + 1)

    # ------------------------------------------------------------------ #
    def train(
        self,
        diffuser: Diffuser,
        reward_model: RewardModel,
        optimizer: OptimizerFactory,
        train_dataloader: Iterable[dict[str, Any]],
        val_dataloader: Iterable[dict[str, Any]] | None = None,
        log_validation_images: bool = True,
        val_steps: int = 25,
        optimizer_ckpt: str | None = None,
        denoiser_ckpt: str | None = None,
        ema_ckpt: str | None = None,
        epoch_start: int = 0,
        n_image_per_prompt: int = 16,
        guidance_scale: float = 4.0,
        image_resolution: Sequence[int] = (512, 512),
        batch_size: int | None = None,
        seed: int = 0,
        draws: Any = None,
    ) -> None:
        """The GRPO loop (grpo_trainer.py:302-455). ``draws(batch_key)``
        gives a batch's randomness (default :class:`SeededDraws`); the batch
        key is ``epoch * 100000 + i`` for train batch i and ``999000 + i``
        for validation batch i, the reference's. ``val_steps`` is unused, as
        in the reference."""
        del val_steps
        self._slice_loaders(train_dataloader, val_dataloader)
        model = diffuser.denoiser
        if getattr(model, "context_embedder", None) is None:
            raise ValueError("Alignment training requires a context embedder in the denoiser model.")
        if not isinstance(diffuser.diffusion, Flow):
            raise ValueError("GRPO requires the rectified_flow formalization")
        reward_model.set_n_image_per_prompt(n_image_per_prompt)

        # the context embedder is frozen during GRPO (reference :514-515); the shared filter also keeps a
        # live REPA encoder out of the optimizer
        modules = train_modules(model, diffuser.extra_losses)
        trainable = trainable_filter(model, train_embedder=False)
        for name, p in modules.named_parameters():
            p.requires_grad_(trainable(name))
        off = sorted({str(p.device) for p in modules.parameters() if p.device != self.device})
        if off:
            raise ValueError(f"the model's parameters are on {off}, the trainer runs on {self.device}; "
                             "build the model on the trainer's device")
        if denoiser_ckpt:
            live_params, live_rest = split_state(modules, trainable)
            restored = restore_checkpoint(denoiser_ckpt, {"params": live_params, "rest": live_rest})
            modules.load_state_dict({**restored["params"], **restored["rest"]}, strict=True)
        if hasattr(model, "set_parallel_mesh"):
            model.set_parallel_mesh(self.mesh)
        shard_model(modules, self.mesh)
        params = {name: p for name, p in modules.named_parameters() if trainable(name)}
        names = list(params)
        # the learn step averages each step's gradients itself (before its norm and the trust region)
        opt = MultiStepOptimizer(optimizer(list(params.values())), self.gradient_accumulation_step,
                                 getattr(optimizer, "grad_clip_norm", None))
        if optimizer_ckpt:
            opt.load_state_dict(_opt_state_map(restore_checkpoint(optimizer_ckpt)["opt_state"], names,
                                               lambda n, v: shard_like(modules, n, params[n], v)))
        ema = None
        if self.use_ema:
            ema = EMA(self.ema_config, init_ema(params))
            if ema_ckpt:
                ema.params = _restore_placed(ema_ckpt, ema.params, modules)

        # the sampling shape needs the prompt batch size: peek at the first batch
        first_batch = next(iter(train_dataloader))
        captions = first_batch.get("extra", {}).get("captions")
        if batch_size is None and captions is None:
            raise ValueError("GRPO batches need extra['captions'] (a dataset that yields captions)")
        self._grpo_shape = self._data_shape(diffuser, batch_size or len(captions), image_resolution)
        if draws is None:
            def draws(batch_key: int) -> SeededDraws:
                return SeededDraws(seed, batch_key, self.device)

        tracker = AverageMeter()
        best_val_loss = float("inf")
        self.lr_scale = 1.0
        # resume continues the raw step counter (it drives the EMA ramp); one step a group a train batch
        step = 0
        if epoch_start:
            try:
                step = epoch_start * len(train_dataloader) * n_image_per_prompt  # type: ignore[arg-type]
            except TypeError as e:
                raise ValueError("epoch_start > 0 requires a train_dataloader with len()") from e
        logger.info("Begin GRPO training")

        for epoch in range(epoch_start, self.n_epoch):
            if hasattr(train_dataloader, "set_epoch"):
                train_dataloader.set_epoch(epoch)
            for bi, batch in enumerate(train_dataloader):
                step = self._run_batch(batch, diffuser, reward_model, opt, ema, params, draws(epoch * EPOCH_STRIDE + bi),
                                       step, n_image_per_prompt, tracker, guidance_scale, train=True)
            self.step = step
            for key, value in tracker.avg.items():
                if key.startswith("train/"):
                    self.tracker.log({key: value}, step=epoch + 1)
            tracker.reset()

            if val_dataloader is not None:
                for bi, batch in enumerate(val_dataloader):
                    step = self._run_batch(batch, diffuser, reward_model, opt, ema, params, draws(VAL_BATCH_KEY + bi),
                                           step, n_image_per_prompt, tracker, guidance_scale, train=False)
                total_loss = 0.0
                for key, value in tracker.avg.items():
                    if key.startswith("val/"):
                        self.tracker.log({key: value}, step=epoch + 1)
                        if key == "val/loss":
                            total_loss += value
                if log_validation_images:
                    self.log_images(diffuser, next(iter(val_dataloader)), ema, epoch, guidance_scale, seed)
                if total_loss < best_val_loss:
                    best_val_loss = total_loss
                    self.save_model(*_full_split(modules, trainable),
                                    _opt_state_map(opt.state_dict(), names, lambda n, v: full_tensor(modules, n, v)),
                                    None if ema is None else full_tensors(modules, ema.params), step)
                tracker.reset()

        self.step = step
        self.wait_for_checkpoints()
        self.tracker.finish()
        logger.info("GRPO training complete")
