#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``diffulab_tpu_torch``) on one card.

Drives the port's five paths with seeded random weights: DiT-B/2
class-conditional sampling (Euler-50, CFG 4.0 as one fused 2x batch, bf16
whole-model cast, batch 16 on 32x32x4 latents) through ``Diffuser.generate``;
DiT-B/2 rectified-flow training (logit-normal t, v-prediction, p_cfg 0.1,
AdamW with bench.py's lr and weight decay 1e-4, EMA, batch 64) through
``BaseTrainer.train``; and latent text-to-image sampling with the txt2img
MMDiT (768 wide, 8 dual + 4 single-stream blocks, mixed bf16, a
PrecomputedEmbedder with a 128 x 2048 null embedding) on 64x64x128 latents
(4096 image + 128 text tokens), 4 prompts, Euler-50 with shift 4.63 and CFG
4.0, decoded by the Flux2 VAE to 1024x1024 pixels, through
``Diffuser.generate``; and training of that txt2img MMDiT at batch 8
(rectified flow, logit-normal t with shift 4.63, p_cfg 0.1, AdamW at
configs/optimizer/adamw.yaml's values, EMA) through ``BaseTrainer.train``
over shards that the port's ``ShardedDatasetWriter`` writes from a seed;
and slice C1, ``configs/train_synthetic_flow_matching.yaml`` through the
port's own CLIs (``diffulab_tpu_torch.examples``: train with post-hoc EMA,
reconstruct an EMA horizon, sample a grid from it) at the config's full
width and depth in fp32, cut only in epochs and dataset size; bench.py's
DPM++ and block-cache sampling arms on DiT-B/2; and slice C2,
``configs/train_synthetic_edm.yaml`` through the same CLIs with the rest of
the sampler family, block caching, autoguidance, inpainting and img2img,
then guidance distillation and reflow from the C1 run; and slice D1,
``configs/train_synthetic_ddpm.yaml`` (the ADM UNet under Gaussian diffusion,
attention at head dims 192 and 384) through the same CLIs; slice E1's six
configs; and slice D2, ``configs/train_mnist_ddpm.yaml`` and
``configs/train_mnist_flow_matching.yaml`` (the MNIST UNet, attention at
head dims 256 and 512) through the same CLIs on MNIST files written from a
seed; and slice F1, SprintDiT and DDT: the txt2img SprintDiT of
``configs/train_imagenet_repa_txt_to_img_sprint.yaml`` serving and training,
the hard-txt2img SprintDiT and DDT, and ``model=sprint``, ``model=ddt`` and
``configs/train_cifar10_flow_matching.yaml`` through the same CLIs; and
slice G1, ``configs/train_imagenet_flow_matching_repa.yaml`` (a DiT-B at
patch 1 on DC-AE latents with REPA on precomputed DINOv2-L features through
a Perceiver resampler) through the port's ``precompute``, ``train_repa``
and ``sample`` CLIs on images written from a seed; and slice H1, the hard
text-to-image benchmark (``configs/train_hard_txt2img_*.yaml``: the port's
builder trains the tower and writes the shards, ``train_repa_txt_to_img``
trains the MMDiT arm, also with the trainable text embedder, and the
SprintDiT arm, ``evaluate_txt2img`` scores the MMDiT's checkpoints) and
``evaluate_fid`` on the C1 run; and slice I1, GRPO post-training of
``configs/train_grpo_alignment.yaml`` through the port's ``train_grpo`` CLI
at full width, and LoRA/DoRA finetuning of the C1 run; and slice J1,
serving from an artifact that ``deploy/export.py`` exports (DiT-B/2, and the
C1 run through the ``export_sampler`` and ``serve`` CLIs), the kernels as
``torch.library`` ops, and ``--prompts`` through the HF text embedder of
``configs/embedder/qwen.yaml``.

Phases, one line each:
  1. build every CUDA kernel from the sources in the checkout (one nvcc per
     source, all started at once), with each instance's registers and spills
     and any warning of ptxas;
  2. K1 (attention forward) against its plain PyTorch version on the card,
     at the sampling shape, at each of its other instances (two passes over
     resident K and V, 192- and 64-key chunks, K and V streamed) and at the
     edge cases, with the tolerance stated; the device time of the kernel and
     of one library call (yardstick only) from CUDA-graph replays, their wall
     time per call beside it, the plain version's time, and the kernel at the
     training batch;
  3. the DiT-B/2 forward, kernel path against the same model with the plain
     attention (``attention_impl="xla"``);
  4. three ``generate`` requests, with the kernels' launch counts set to 0
     just before and read just after: 600 K1 launches per request;
  5. K2 (attention backward) against its plain version, at the training
     shape and at the edge cases (among them the Hopper K2's: Skv 64 to 768,
     K and V resident for both passes or streamed twice, a 64-key masked
     block, D=128, packed qkv views), with its wall and device times and
     SDPA's backward as the yardstick;
  6. the DiT-B/2 parameter gradients of one loss at batch 64, kernel path
     against plain attention: 12 K1 and 12 K2 launches;
  7. ``BaseTrainer.train`` for 12 steps plus validation and the best-val
     checkpoint, with the counts set to 0 just before: 12 K1 + 12 K2 launches
     in every step; ms per step and samples/s;
  8. K3 (flash attention forward) against its plain version, at the txt2img
     shape (B=8, S=4224, H=12, D=64, bf16) with the fused-CFG ragged text
     mask, in fp32, and at the edge cases (among them the Hopper K3's tile
     edges: Skv 129/130, Sq 65/129, Skv <= 64, a 128-key hole, D=128 ragged);
     its wall and device times, SDPA's as the yardstick, and K1 against K3
     (and SDPA) at 256-768 tokens, device times from CUDA-graph replays;
  9. the txt2img MMDiT forward at that shape, kernel path against the plain
     attention: 12 K3 launches and no K1;
 10. two txt2img ``generate`` requests with the Flux2 decode, the counts set
     to 0 just before each and read just after: 600 K3 launches and 0 K1 per
     request; ms per request, images/s, peak memory, pixels finite and in
     [-1, 1]; a 4-step trajectory, kernel path against plain attention;
 11. K4 and K5 (flash attention backward) against their plain version, from
     K3's o and lse, at the txt2img training shape (B=8, S=4224, H=12, D=64,
     bf16) with the training key mask, in fp32 at that shape, at the edge
     cases (among them the tile edges of the Hopper kernels: Skv 129 and 130,
     Sq 65, a 128-key masked hole, D=128 at ragged lengths, Skv <= 64) and
     through the entry point under grad; their timings, bounds and SDPA's
     masked backward as the yardstick; K2 against K4+K5 at 256-768 tokens,
     and with phase 8's forwards the fused route (K1 + K2) against the flash
     route (K3 + K4 + K5) about the dispatch line;
 12. the txt2img MMDiT parameter gradients of one loss at 4224 tokens (model
     batch 2), kernel path against plain attention: 12 K3 + 12 K4 + 12 K5
     launches and no K1/K2;
 13. ``BaseTrainer.train`` on the txt2img MMDiT at batch 8 over two
     aspect-ratio buckets (``ImageNetmultiAR``, ``MultiARBatchSampler``,
     ``collate_fn``), validation loss on the EMA weights, validation images
     decoded by the Flux2 tower with their captions, and the best-val
     checkpoint: 12 K3 + 12 K4 + 12 K5 launches in every step; ms per step,
     samples/s and peak memory;
 13b. the same MMDiT (build_txt2img's seeded weights) with fp32 attention in
     its 8 dual-stream blocks (``attention_dtype=float32``, the reference's
     stability option): a forward at the fused-CFG batch against its plain
     twin (8 fp32 K3 + 4 bf16 K3), an Euler-10 request of 4 prompts with the
     Flux2 decode (80 fp32 K3 + 40 bf16), and two train steps at batch 8 (8
     fp32 K3, K4 and K5 and 4 bf16 of each a step, by the fp32 instances' own
     counters); ms per request and per step, peak memory;
 14. slice C1: the fp32 instances of K1 (B=128 and B=32) and K2 (B=128),
     3xTF32 on the tensor cores, at the config's attention shape (S=256,
     H=8, D=64) against their plain versions, each timed as its yardstick is
     (K1 and fp32 SDPA, K2 and SDPA's fp32 backward op, all from CUDA-graph
     replays; K2's and the SDPA autograd backward's kernels also summed by
     torch.profiler), bounds at 3xTF32 and at the fp32 CUDA-core peak, the
     products each design runs; then, in process, the
     ``train_diffusion`` CLI on ``train_synthetic_flow_matching`` (1 epoch of
     2048 samples, 256 for validation; everything else at the config's
     values), ``reconstruct_ema`` at sigma_rel 0.05 and 0.10, and ``sample``
     of 16 images at CFG 1.5 from the 0.05 reconstruction: 10 K1 + 10 K2
     launches in every train step, 4 post-hoc EMA snapshots, reconstruction
     weights finite and summing to about 1, the native collate loaded, 500
     K1 and 0 K3 launches in the sample request, a PNG grid of the expected
     size; ms per step, samples/s, peak memory, ms per sample request;
 15. bench.py's other two sampling arms on DiT-B/2 (bf16, batch 16, CFG 4.0):
     K1 at their shape against its plain version; DPM-Solver++(2M) at 15
     steps (180 K1 launches a request) and Euler-50 with
     ``set_block_cache(2, span=(2, 10))`` (400), each request 0 against the
     plain-attention model's, ms a request (median of 3 after a warm-up);
     the cached request's first (refresh) step bit for bit the uncached
     one's, and ``set_block_cache(1, ...)`` turning caching off;
 16. slice C2: the fp32 K1 (B=128, 32) and K2 (B=128) against their plain
     versions; ``configs/train_synthetic_edm.yaml`` (EDM, Heun-18) through
     ``train_diffusion`` (10 K1 + 10 K2 a step), ``reconstruct_ema`` and
     ``sample`` (350 K1 a Heun-18 request), then one request each of
     DPM++-15, UniPC-10, block caching, autoguidance with the epoch-1
     post-hoc EMA snapshot, an inpaint box (the known region back exactly)
     and img2img at strength 0.6, each with its K1 count; on phase 14's flow
     run a UniPC-10 request, one epoch of
     ``train_synthetic_flow_distill`` from its checkpoint (20 K1 + 10 K2 a
     step: the teacher's guided forward is one 2x call), and the ``reflow``
     CLI on 512 pairs for one epoch; ms per step, samples/s, peak memory,
     ms per request;
 17. slice D1: the libraries' fp32 tile rules against the emulation's; the
     fp32 K1 (B=128, and the CFG sample's B=32) and K2 (B=128) instances at
     head dims 192 and 384, built around the valid rows, at the UNet's shapes
     (H=2, the unpadded 64 or 16 query rows, keys padded to 128 with the
     padding mask) against their plain versions, with the edge cases, timings
     and bounds of 19a; the config's UNet (155.7M parameters,
     fp32) forward and gradients on the kernel path against plain attention
     (11 K1, 11 K2); ``configs/train_synthetic_ddpm.yaml`` (the ADM UNet under
     Gaussian diffusion) through ``train_diffusion`` with post-hoc EMA (1
     epoch of 1024 samples, 256 for validation; 11 K1 + 11 K2 a step),
     ``reconstruct_ema`` and two DDIM-50 ``sample`` requests of 16 images at
     CFG 1.5 (550 K1 each), every K1/K2 launch an instance at D=192 or D=384
     by their own counters; ms per step, samples/s, peak memory, ms per request;
 18. slice E1, the hard synthetic dataset and live-encoder REPA: the bf16 K1
     and K2 at the hard configs' attention shape (B=128, S=256, H=8, D=64;
     K1 also at the teacher's B=256) against their plain versions, each timed
     beside bf16 SDPA (K2 beside SDPA's backward) and its bound; then six
     configs through the CLIs, each one epoch of 1024 samples (256 for
     validation): (a)
     ``train_synthetic_hard_flow`` (bf16: 10 bf16 K1 + 10 bf16 K2 a step by
     the instances' own counters), ``reconstruct_ema``,
     ``train_synthetic_hard_distill`` from its ``phema_sr0.05`` (20 + 10 a
     step) and a 16-image Euler-50 request at CFG 1.5 from the student (500
     K1, fp32 as the sample CLI builds the model), with the samples' caption
     consistency; (b) ``train_synthetic_colorize`` and a request on the
     validation luma; (c) ``train_synthetic_{flow,edm,ddpm}_repa`` (the
     seed-4321 FixedViT as the frozen target; 10 + 10 or, for the UNet, 11 +
     11 a step at D=192/384), a request from each restored checkpoint (500,
     350, 550 K1), one REPA loss dict recomputed on the host with the same
     weights, rows and draws (rtol 1e-3), and the card's FixedViT against
     jax_prng's draw, bit for bit;
 19. slice D2, the MNIST UNet: (a) the fp32 K1 and K2 instances at head dims
     256 and 512, built around the valid rows, at the UNet's shapes (B=128,
     H=2, the unpadded 64 or 16 query rows, keys padded to 128 with the
     padding mask) against their plain versions, with an empty key tile
     between live ones beside a fully masked row and a ragged Sq; each timed
     beside fp32 SDPA on the same inputs, on the padded and on the unpadded
     tensors, with bounds over the valid rows and keys and over the padded
     rows; (b) the config's UNet (276.7M parameters, fp32) forward and
     gradients on the kernel path against plain attention (11 K1, 11 K2: 5 at D=256, 6 at
     D=512); (c) ``train_mnist_ddpm`` and ``train_mnist_flow_matching`` through
     ``train_diffusion`` (one epoch of 1024 images, 256 for validation,
     written as MNIST idx files from a seed; 11 K1 + 11 K2 a step) and two
     ``sample`` requests each of 16 images at 50 steps (DDPM ancestral, Euler;
     550 K1 each), every K1/K2 launch an instance at D=256 or D=512 by their
     own counters; ms per step, samples/s, peak memory, ms per request;
 20. slice F1, the txt2img SprintDiT (the config's model block as composed:
     2 MMDiT + 8 single-stream deep + 2 MMDiT blocks, 768 wide, bf16; phase
     8-13's shapes, context and tower, seeded weights): a forward at the
     fused-CFG batch of 8 against its plain twin (12 K3 at 4224 tokens); two
     4-prompt Euler-50 requests with fused CFG, shift 4.63 and the Flux2
     decode (600 K3 each; the null half's deep output all mask tokens: path
     drop); the gradients of one loss at batch 2 against the plain twin with
     the same kept tokens; ``BaseTrainer.train`` at batch 8 over phase 13's
     shards (per step 12 K3, K4 and K5: 4 at 4224 / 3968 tokens, 8 at 1152 /
     1088, the deep path's kept tokens and the text); the bf16 K3, K4 and
     K5 at 1152 tokens against their plain versions, timed beside masked
     SDPA and their bounds;
 21. the hard-txt2img SprintDiT and DDT (``configs/train_hard_txt2img_{sprint,
     ddt}.yaml``' model blocks, bf16) on 16x16x32 latents (64x64 images
     through the hard benchmark's tower) with 8-token captions: each a
     forward against its plain twin, a 16-image Euler-50 request at CFG 1.5
     and two train steps at batch 64, with exact bf16 K1/K2 counts by padded
     length (SprintDiT 8 a forward, DDT 9);
 22. ``train_synthetic_flow_matching`` with ``model=sprint`` and
     ``model=ddt`` (fp32, batch 128, post-hoc EMA; phase 14's cuts) and
     ``train_cifar10_flow_matching`` on CIFAR-10 pickles written from a seed
     (batch 32, accumulation 2; 1024 + 256 images, one epoch) through
     ``train_diffusion`` and a 16-image ``sample`` request at CFG 1.5 each,
     with exact fp32 K1/K2 counts by padded length (SprintDiT 12 a step: 4 at
     256 tokens, 8 at 64 padded to 128; DDT 12, CIFAR 10 at 256); then the
     fp32 K2 at B=32 and the fp32 K1/K2 at 64 tokens padded to 128 against
     their plain versions, beside fp32 SDPA on the same and on the unpadded
     tensors, and their bounds;
 23. slice G1, ``configs/train_imagenet_flow_matching_repa.yaml`` at its
     widths: (a) 1024 + 128 seeded 256x256 images with labels written by the
     port's ShardedDatasetWriter, the validation split also as MDS shards,
     read back the same; (b) ``precompute latents`` with the full DC-AE
     f32c32 tower (seeded random weights), 8x8x32 latents, images/s, peak
     memory, one batch decoded back to finite pixels; (c) ``precompute
     features`` with dinov2_vitl14_reg at 224 px (256 tokens of 1024),
     images/s; (d) ``train_repa`` one epoch of 8 steps at batch 128, bf16, 12
     bf16 K1 + 12 bf16 K2 at 128 padded keys every step (64 tokens), the REPA
     term non-zero, ms per step, peak memory; (e) ``sample`` of 16 images
     Euler-50 at CFG 4.0 with the DC-AE decode, 600 K1 at 128 padded keys;
     (f) a B=128 forward and the gradients of a B=2 loss with the
     precomputed RepaLoss and its resampler against the plain-attention
     twin; (g) the bf16 K1/K2 at B=128, 64 tokens padded to 128, H=12, the
     fp32 K1 at the request's B=32, and the hard txt2img pair's bf16 K1/K2
     instances (phase 21's: 264 tokens padded to 384, 256, 72 padded to 128;
     H=6), each beside SDPA on the padded and the unpadded tensors, its plain
     version and both bounds;
 24. slice H1 from a working directory of its own (the configs' relative
     ``data/hard_txt2img`` paths unedited): (a) the port's
     ``build_hard_txt2img`` at 64 px (2048 + 256 scenes, one tower epoch at
     batch 64), its report and shard bytes; (b) ``train_hard_txt2img_mmdit``
     as composed through ``train_repa_txt_to_img``, one epoch of 32 steps,
     6 + 6 bf16 K1/K2 at 384 padded keys a step; (c) the same with
     ``embedder=trainable trainer.train_embedder=true`` (plus 4 + 4 fp32 at
     128 a step), the encoder's parameters moved and checkpointed, its
     K1/K2 timed against SDPA and their bounds; (d)
     ``train_hard_txt2img_sprint`` one epoch, and ``train_hard_txt2img_ddt``
     refused with F3's ``TypeError``; (e) ``reconstruct_ema`` and
     ``evaluate_txt2img`` on ``ema`` and ``phema_sr0.05`` (200 samples each,
     Euler-50, CFG 1.5, 1200 fp32 K1); (f) ``evaluate_fid`` on phase 14's
     ``ema`` (256 samples, 1000 fp32 K1), the feature ViT's weights on the
     card bitwise the ``jax_prng`` draw and its features against the CPU;
 25. slice I1 from a working directory of its own: (a) ``train_grpo
     --config-name train_grpo_alignment --luma-judge``, the model block as
     composed (12 dual-stream blocks of 640, 10 heads, patch 1, bf16) and
     the Flux2 tower at full width with seeded weights, 512x512 (32x32x128
     latents: 1152 keys with the captions), EM-25 at CFG 4.0, cut to one
     epoch of 2 batches of 2 prompts and 4 images a prompt over 4 + 2 seeded
     caption prompts (the dataset and the tower's latent channels overridden:
     faults F4, F5): 300 bf16 K3 a sampled group, 180 K3 + 180 K4 + 180 K5 a
     learn step, the first group's ``ratio_dev`` ~0, the best-val checkpoint
     restored, a learn step in ``profiling.trace``; one learn step's
     gradients against the plain path; the bf16 K3-K5 at B=4, H=10, S=1152
     with the caption mask beside SDPA and their bounds; (b) LoRA and DoRA
     (rank 8) through ``train_diffusion`` on phase 14's run with phase 14's
     cuts: the wrapped model at step 0 bitwise the base, the optimizer
     holding the adapters alone, 10 + 10 fp32 K1/K2 a step, ``merge_lora``
     against the adapted forward, a 16-image ``sample`` request (500 K1).
 26. slice J1: (a) phase 4's DiT-B/2 request (batch 16, Euler-50, CFG 4.0,
     bf16) exported by ``deploy.export_generate`` (export and load seconds,
     the artifact's bytes) and served by ``DeployedSampler``, three seeds
     each against the live ``generate`` with the same labels, interleaved:
     the images equal, 600 K1 and no other kernel a request, ms of each;
     (b) phase 14's ``ema`` through ``export_sampler --smoke`` and
     ``serve``'s handler on 127.0.0.1: a request of 5 labels (padded to the
     batch and trimmed) equal to ``DeployedSampler``'s rows, ``/healthz``,
     a 400 on a malformed request, 500 fp32 K1 in the smoke batch and in
     the served request; (c) each of the five kernels' ops once on CUDA
     tensors against its direct wrapper: its counter up by one, bitwise;
 27. ``--prompts``: ``configs/embedder/qwen.yaml``'s ``QwenTextEmbedder``
     (a stub encoder; no ``transformers`` on the card) with
     ``train_imagenet_repa_txt_to_img``'s DDT at full width on 32x32x128
     latents: one CFG call's null half bitwise the explicit null
     embeddings', a 4-prompt Euler-50 request bitwise its explicit-null
     twin, its launches 50 times one call's (bf16 K3 at 1088 and 1024 keys).
Phases 8 and 11 also hold the flash kernels' fp32 instances (K3's, K4's and
K5's 3xTF32 designs) to their plain versions at the slice shapes and the edge
cases, each timed beside fp32 SDPA, and their tiles to the emulations'
(``ops/flash_attention.py``); phases 2, 5 and 11 print every fp32 error as a
fraction of its tolerance, phases 2 and 5 with the fp32 K1/K2 at 512 keys.
Then the card's name and power limit, a JSON line of per-kernel numbers, and
as the last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without a CUDA card, or without the package beside it, it
exits non-zero and prints no result.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any

ROOT = Path(__file__).resolve().parent

# DiT-B/2 as bench.py builds it, at the bench's precision policy
DIT_B2 = dict(simple_dit=True, input_channels=4, inner_dim=768, embedding_dim=768, num_heads=12,
              mlp_ratio=4, patch_size=2, depth=12, n_classes=1000, classifier_free=True,
              stable_conditioning=False)
LATENT = (32, 32, 4)
SAMPLE_BATCH = 16
TRAIN_BATCH = 64
TRAIN_STEPS = 12
P_CFG = 0.1
STEPS = 50
CFG = 4.0
N_REQUESTS = 3

# the txt2img MMDiT of README.md:100 at the widths of
# configs/train_imagenet_repa_txt_to_img_sprint.yaml:26-39 (8 dual + 4
# single-stream blocks), the library's mixed bf16 policy (precision_type
# "bf16": bf16 matmuls, fp32 conditioning and stream), a PrecomputedEmbedder
# with a seeded [128, 2048] null embedding (2048: Qwen3-VL-2B's hidden size),
# and the Flux2 tower at its defaults with 32 latent channels (128 packed)
TXT = dict(simple_dit=False, input_channels=128, output_channels=128, inner_dim=768, embedding_dim=768,
           num_heads=12, mlp_ratio=4, patch_size=1, depth=12, n_single_stream_blocks=4, rope_base=2000,
           rope_axes_dim=[16, 24, 24], n_classes=None, classifier_free=True)
TEXT_LEN, TEXT_DIM, NULL_SEQ_LEN = 128, 2048, 1
TXT_BATCH = 4  # prompts per request; the model batch is 8 under fused CFG
TXT_LATENT = (64, 64, 128)  # 4096 image tokens, 1024x1024x3 decoded
TXT_SEQ = TEXT_LEN + TXT_LATENT[0] * TXT_LATENT[1]  # 4224
TEXT_LENGTHS = (128, 77, 31, 9)  # valid tokens of the 4 prompts
TXT_EXTRA = {"logits_normal": True, "shift": 4.63}  # the txt2img configs' diffuser extra_args
TXT_REQUESTS = 2
# txt2img training: batch 8 (4224 tokens each); the text lengths of the batch
# in phase 11, and the rows the CFG drop sent to the null embedding there
TXT_TRAIN_BATCH = 8
TRAIN_TEXT_LENGTHS = (128, 77, 31, 9, 100, 54, 16, 3)
TRAIN_DROPPED = (5,)
# phase 12's model batch: autograd through the plain attention keeps fp32
# [B, 12, 4224, 4224] score matrices (1.7 GB each at B=2, several a block)
TXT_GRAD_BATCH = 2
# phase 13: configs/optimizer/adamw.yaml's values, passed explicitly (trap T7),
# and the txt2img configs' validation sampler; shards of a 64x64x128 bucket
# (4224 tokens) and a 48x80x128 one (3968 tokens), 12 train batches and 1 val
TXT_ADAMW = dict(lr=1e-4, weight_decay=0.01, betas=(0.9, 0.999), eps=1e-8)
TXT_VAL_STEPS, TXT_VAL_SHIFT = 4, 6.93
TXT_BUCKETS = {(64, 64): 8, (48, 80): 4}  # latent (H, W) -> train batches
# phase 13b: the same MMDiT with fp32 attention in its dual-stream blocks (attention_dtype=float32):
# an Euler request at 10 steps (50 in the request of phase 10: cut for the script's time) and
# two train steps, the second after the first's warm-up
TXT32_STEPS = 10
TXT32_TRAIN_STEPS = 2

# H100 SXM data-sheet peaks at 700 W (hopper-kernels guide, section 1): fp32
# outside the tensor cores (FFMA), and TF32 on them, which the fp32 instances
# run three times over (3xTF32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12

# slice C1: configs/train_synthetic_flow_matching.yaml through the port's CLIs,
# cut only in epochs (12 -> 1; 2 until slice E1's phase 18 took the time) and data
# (10000 -> 2048 train, 2000 -> 256 val)
C1_CONFIG = "train_synthetic_flow_matching"
C1_CUTS = {"trainer.n_epoch": (12, 1), "dataset.train.n_samples": (10000, 2048), "dataset.val.n_samples": (2000, 256)}
C1_BATCH, C1_DEPTH, C1_HEADS, C1_SEQ = 128, 10, 8, 256  # the config's batch, depth, heads; 32x32 / patch 2
C1_SIGMA_RELS = ("0.05", "0.10")
C1_SAMPLES, C1_GUIDANCE, C1_STEPS = 16, 1.5, 50  # the sample request: 2x16 under fused CFG, Euler-50

# phase 15: bench.py's other two sampling arms on DiT-B/2 (bench.py:128-150): DPM++(2M)
# at 15 steps, and Euler-50 with a block cache refreshed every 2nd step over blocks
# [2, 10): 25 refresh steps of 12 blocks and 25 reuse steps of 4
C2_DPM_STEPS = 15
C2_DIT_CACHE = (2, (2, 10))
C2_DIT_CACHED_K1 = sum(12 if i % 2 == 0 else 12 - 8 for i in range(50))  # 400
# phase 16: slice C2, configs/train_synthetic_edm.yaml (the C1 DiT under EDM, Heun-18:
# 17 two-eval steps and the collapse, 35 evals) with phase 14's cuts; the cached request
# refreshes every 2nd step over blocks [2, 8); reflow on 512 pairs (+128 for validation)
C2_CONFIG = "train_synthetic_edm"
C2_STEPS = 18
C2_EDM_CACHE = (2, (2, 8))
C2_REFLOW_PAIRS, C2_REFLOW_VAL = 512, 128

# phase 17: slice D1, configs/train_synthetic_ddpm.yaml (the ADM UNet at model_channels 96,
# channel_mult 1,2,4,8, 2 heads, attention at ds 4 and 8 and in the middle block; Gaussian
# diffusion sampled by DDIM; fp32, batch 128) through the CLIs, cut in epochs and data as C1
# (12 -> 1 epoch, 2 until phase 18; 10000 -> 1024 train and 2000 -> 256 validation samples),
# with post-hoc EMA
D1_CONFIG = "train_synthetic_ddpm"
D1_CUTS = {"trainer.n_epoch": (12, 1), "dataset.train.n_samples": (10000, 1024), "dataset.val.n_samples": (2000, 256)}
D1_ON = ("trainer.posthoc_ema=true",)  # the config leaves post-hoc EMA off; the reconstruct step needs it
D1_BATCH, D1_HEADS, D1_PADDED = 128, 2, 128
# (head dim, tokens, attention calls a forward): 8x8 tokens at ds 4 (2 encoder + 3 decoder
# blocks), 4x4 at ds 8 (2 + 3) and in the middle block; both pad to 128 keys
D1_ATTN = ((192, 64, 5), (384, 16, 6))
D1_CALLS = sum(n for _, _, n in D1_ATTN)  # 11 K1 a forward, 11 K2 a backward
D1_SAMPLES, D1_GUIDANCE, D1_STEPS = 16, 1.5, 50  # a DDIM-50 request, 2x16 under fused CFG
BF16_COUNTERS = ("fused_mha_fwd_bf16", "fused_mha_bwd_bf16")  # the bf16 instances' own counts (slice E1)

# phase 18: slice E1, the hard synthetic dataset and live-encoder REPA: six download-free configs
# through the CLIs at their full width and depth, each cut to one epoch and in data (10000 -> 1024
# train, 2000 -> 256 validation samples: 8 steps of 128 an epoch, 2 validation batches). The hard
# configs are bf16 DiTs with patch 4 on 64x64 (256 tokens, 8 heads of 64); colorize and the DiT REPA
# configs are C1's fp32 DiT; ddpm_repa is D1's UNet; the REPA encoder is the seed-4321 FixedViT.
E1_DATA = {"dataset.train.n_samples": (10000, 1024), "dataset.val.n_samples": (2000, 256)}
E1_BATCH, E1_STEPS_PER_EPOCH, E1_SEQ = 128, 1024 // 128, 256
E1_SAMPLES, E1_GUIDANCE = 16, 1.5
# per config: K1, K2 and K3 launches a train step, K1 a sample request and the request's flags
# (the DiTs: 10 blocks; Euler-50 with CFG as one 2x call, EDM's Heun-18 35 evals; the UNet: 11
# attention calls, DDIM-50); the distillation step adds the teacher's guided forward (one 2x call)
E1_RUNS = {
    "train_synthetic_hard_flow": ((C1_DEPTH, C1_DEPTH, 0), None, ()),
    "train_synthetic_hard_distill": ((2 * C1_DEPTH, C1_DEPTH, 0), 50 * C1_DEPTH, ("--guidance", str(E1_GUIDANCE))),
    "train_synthetic_colorize": ((C1_DEPTH, C1_DEPTH, 0), 50 * C1_DEPTH, ()),
    "train_synthetic_flow_repa": ((C1_DEPTH, C1_DEPTH, 0), 50 * C1_DEPTH, ("--guidance", str(E1_GUIDANCE))),
    "train_synthetic_edm_repa": ((C1_DEPTH, C1_DEPTH, 0), None, ("--guidance", str(E1_GUIDANCE))),
    "train_synthetic_ddpm_repa": ((D1_CALLS, D1_CALLS, 0), 50 * D1_CALLS, ("--guidance", str(E1_GUIDANCE),
                                                                          "--steps", "50")),
}
E1_CPU_BATCH = 4  # the rows of a batch whose REPA loss dict is recomputed on the host
E1_LOSS_RTOL = 1e-3

# phase 19: slice D2, configs/train_mnist_ddpm.yaml (Gaussian, DDPM ancestral) and
# configs/train_mnist_flow_matching.yaml (rectified flow, Euler) on the MNIST UNet
# (configs/model/unet.yaml: model_channels 128, channel_mult 1,2,4,8, 2 heads, attention at ds 4
# and 8 and in the middle block; fp32, batch 128, gradient accumulation 2) through the CLIs, on
# MNIST idx files written from a seed, cut only in epochs (50 -> 1) and in the images written
# (60000 -> 1024 train, 10000 -> 256 validation)
D2_CONFIGS = {"train_mnist_ddpm": ("mnist_ddpm", "DDPM ancestral"),
              "train_mnist_flow_matching": ("mnist_flow_matching", "Euler")}
D2_CUTS = {"trainer.n_epoch": (50, 1)}
D2_IMAGES = {"train": (60000, 1024), "t10k": (10000, 256)}
D2_BATCH, D2_HEADS, D2_PADDED = 128, 2, 128
# (head dim, tokens, attention calls a forward): 8x8 tokens at ds 4 (2 encoder + 3 decoder
# blocks), 4x4 at ds 8 (2 + 3) and in the middle block; keys padded to 128, queries not
D2_ATTN = ((256, 64, 5), (512, 16, 6))
D2_CALLS = sum(n for _, _, n in D2_ATTN)  # 11 K1 a forward, 11 K2 a backward
# the counters of every fp32-only instance: D1's and D2's head dims
F32_ONLY_COUNTERS = tuple(f"fused_mha_{kind}_f32_d{d}" for kind in ("fwd", "bwd") for d, _, _ in (*D1_ATTN, *D2_ATTN))
D2_SAMPLES, D2_STEPS = 16, 50  # a request of 16 images, 50 steps, no CFG (classifier_free: false)
D2_PARAMS = 276_690_433

# phase 20: slice F1, the txt2img SprintDiT: the model block of configs/train_imagenet_repa_txt_to_img_sprint.yaml
# as composed (768 wide, 12 heads of 64, patch 1, 128 channels; encoder 2 MMDiT blocks; deep_layers_depth 8 with
# n_single_stream_blocks 8, so 0 dual + 8 single-stream deep blocks; decoder 2; drop 0.75, rope base 2000, axes
# [16, 24, 24], a CFG null), bf16 (its precision_type), on phases 8-13's shapes, context, tower and shards, with
# seeded random weights. Cut: the config's accumulation of 8 (1), its compile (the port runs eagerly), its 50
# epochs (one of 12 batches) and its REPA loss (precomputed DINOv2 features: ROADMAP item 13b)
F1_TXT_CONFIG = "train_imagenet_repa_txt_to_img_sprint"
F1_TXT_CUTS = {"trainer.gradient_accumulation_step": (8, 1), "trainer.compile": (True, "eager"),
               "trainer.n_epoch": (50, 1), "repa": ("RepaLoss on precomputed DINOv2-S features", "none")}
F1_TXT_REQUESTS = 2
FLASH_KERNELS = ("flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq")
# phase 21: the hard-txt2img SprintDiT and DDT, the model blocks of configs/train_hard_txt2img_{sprint,ddt}.yaml
# (384 wide, 6 heads of 64, patch 1, 32 channels, bf16) on the shapes the hard benchmark's tower gives: 64x64
# images through scripts/build_hard_txt2img.py:51's Flux2VAE (base 32, ch_mult (1, 2), 8 latent channels), f =
# 2 ** len(ch_mult) = 4 and latents packed 2x2 to 32 channels, so 16x16x32 (256 image tokens); captions of
# EMB_LEN = 8 tokens of the caption table's 512 (data/synthetic_txt2img.py), the null embedding of
# build_hard_txt2img.py:158 (zeros); seeded random latents and weights, no tower checkpoint (item 8), so no decode.
# The DDT's block carries `simple_dit: false` from its MMDiT sibling, which DDT does not take (nor the JAX one):
# dropped here. A request of 16 at evaluate_txt2img.py's CFG 1.5, two train steps at the configs' batch of 64
F1_HARD = {"sprint": "train_hard_txt2img_sprint", "ddt": "train_hard_txt2img_ddt"}
F1_HARD_LATENT, F1_HARD_TEXT = (16, 16, 32), (8, 512)
F1_HARD_SAMPLES, F1_HARD_GUIDANCE, F1_HARD_BATCH, F1_HARD_STEPS = 16, 1.5, 64, 2
# phase 22: slice F1 through the CLIs: train_synthetic_flow_matching with model=sprint and model=ddt (the widths
# of configs/model/{sprint,ddt}.yaml on C1's 32x32x3 shapes, fp32, batch 128, post-hoc EMA), cut as phase 14
# cuts C1, and train_cifar10_flow_matching (C1's DiT without a CFG null, fp32, batch 32, accumulation 2, 100
# sampling steps) on CIFAR-10 pickles written from a seed, cut in epochs (100 -> 1) and images (50000 -> 1024
# in data_batch_1-4, 10000 -> 256 in data_batch_5); a 16-image request at CFG 1.5 from each EMA checkpoint
F1_CLI = {"sprint": ("train_synthetic_flow_matching", ("model=sprint",)),
          "ddt": ("train_synthetic_flow_matching", ("model=ddt",)),
          "cifar10": ("train_cifar10_flow_matching", ())}
F1_CIFAR_CUTS = {"trainer.n_epoch": (100, 1)}
F1_CIFAR_IMAGES = {"train": (50000, 1024), "val": (10000, 256)}
F1_CIFAR_BATCH = 32
F1_SAMPLES, F1_GUIDANCE = 16, 1.5
# phase 23: slice G1, configs/train_imagenet_flow_matching_repa.yaml (a class-conditional DiT-B at patch 1 on the
# 8x8x32 latents of the DC-AE f32c32 tower: 768 wide, 12 heads of 64, 12 blocks, 1000 classes with a CFG null,
# bf16, batch 128; REPA at block 8 through a 3-deep Perceiver resampler of 256 latents onto precomputed DINOv2-L
# features) through the port's CLIs: precompute latents (vision_tower=dcae), precompute features
# (dinov2_vitl14_reg at resolution 256: 224 px, 256 patch tokens of 1024), train_repa, sample. Cut: ImageNet's
# images (1,281,167 train, 50,000 val) -> seeded 256x256 RGB images with labels in 0-999, its 150 epochs -> 1, the
# pretrained DC-AE and DINOv2-L weights -> seeded random weights (their download is not available)
G1_CONFIG = "train_imagenet_flow_matching_repa"
G1_IMAGES = {"train": (1_281_167, 1024), "val": (50_000, 128)}
G1_CUTS = {"trainer.n_epoch": (150, 1)}
G1_PX, G1_BATCH, G1_DEPTH, G1_HEADS = 256, 128, 12, 12
G1_TOKENS = 64  # 8x8 latents at patch 1, padded to 128 keys by the fused route
G1_DINO = "{dino_model: dinov2_vitl14_reg, resolution: 256}"
G1_PRECOMPUTE_BATCH = 64
G1_SAMPLES, G1_GUIDANCE = 16, 4.0  # one Euler-50 request at CFG 4.0: 2x16 under fused CFG
G1_GRAD_BATCH = 2

# slice H1 (phase 24): the hard text-to-image benchmark through the port's builder and CLIs, from a working
# directory of its own so that the configs' relative paths (data/hard_txt2img/...) are used unedited
H1_CONFIGS = {"mmdit": "train_hard_txt2img_mmdit", "sprint": "train_hard_txt2img_sprint",
              "ddt": "train_hard_txt2img_ddt"}
H1_BUILD = {"--n-train": (10_000, 2048), "--n-val": (2_000, 256), "--epochs": (12, 1)}
H1_CUTS = {"trainer.n_epoch": (12, 1)}
H1_BATCH, H1_PX = 64, 64
H1_TOKENS = 264  # 16x16 packed latents at patch 1 and 8 caption tokens, padded to 384 keys
H1_DEPTH = 6  # 4 dual-stream + 2 single-stream blocks, one joint attention each
H1_EMB_TOKENS, H1_EMB_DEPTH, H1_EMB_HEADS = 64, 4, 4  # configs/embedder/trainable.yaml: fp32 (no trainer dtype)
H1_TRAINABLE = ("embedder=trainable", "trainer.train_embedder=true")
H1_EVAL = {"--n-samples": (2000, 200), "--n-val": (2000, 256)}
H1_EVAL_BATCH, H1_GUIDANCE = 100, 1.5  # Euler-50 at CFG 1.5: 2x100 under fused CFG
H1_FID_SAMPLES, H1_FID_BATCH = 256, 128  # evaluate_fid on phase 14's C1 run, CFG 1.5
H1_FEATURE_TOL = 1e-4  # the frozen ViT's features, card against the port on the CPU: max |diff| / max |cpu|

# phase 25: slice I1, configs/train_grpo_alignment.yaml through the port's train_grpo CLI: its model block as
# composed (the multimodal MMDiT, 12 dual-stream blocks of 640, 10 heads of 64, patch 1, 128 channels, bf16) on
# 512x512 images, 32x32x128 Flux2 latents (1024 image + 128 caption tokens), EM-25 at CFG 4.0, trust region 0.3,
# EMA; the luma judge (no VLM weights on the card). Cut in epochs, prompts a batch, images a prompt and data;
# two config faults overridden as the repository's own GRPO runs override them (scripts/r4_grpo_campaign.sh:16-22)
I1_CONFIG = "train_grpo_alignment"
I1_CUTS = {"trainer.n_epoch": (5, 1), "dataloader.batch_size": (8, 2), "grpo.n_image_per_prompt": (16, 4),
           "reward.n_image_per_prompt": (16, 4)}
I1_FAULTS = {"dataset": ("imagenet_repa (ImageNetLatentREPA: no captions, F4)", "ImageNetmultiAR"),
             "vision_tower.latent_channels": ("16 (64 packed; the model takes 128, F5)", 32)}
I1_PROMPTS = {"train": (77, 9, 128, 31), "val": (54, 16)}  # caption tokens a prompt: 4 train, 2 validation
I1_BATCH, I1_IMAGES, I1_STEPS, I1_BLOCKS, I1_HEADS = 2, 4, 25, 12, 10
I1_SEQ = TEXT_LEN + 32 * 32  # 1152 keys, unpadded on the flash route
I1_K = round(I1_STEPS * 0.6)  # trajectory indices a learn step (timestep_fraction 0.6)
# the first group of a batch re-evaluates the log-probs with the parameters that sampled them: |ratio - 1|
# should be ~0 there (a guess before the first run on the card; any misalignment of the stored trajectory, of
# the train-mode forward or of the CFG batch shows as a deviation of order eps = 0.1 or more)
I1_RATIO_TOL = 1e-2
I1_LORA_RANK, I1_MERGE_TOL = 8, 1e-4  # phase 25b on C1's config; the merged model against the adapted one (rel)

# kernel vs plain: |kernel - plain| <= atol + rtol * |plain|. fp32: K1's
# products are 3xTF32 on the tensor cores (each operand split into two TF32
# halves, about 2^-21 relative per product) where the plain version's are
# exact fp32, and the sums run in another order (K1 divides o by l at the end
# of an online softmax, the plain version normalises p first); K3's are
# 3xTF32 too, in log2 units (ex2.approx). bf16: p is rounded to bf16 before PV in
# both, but exp/sum rounding can flip a rounding of p or of o by one bf16
# step (2^-8 relative).
# phase 26: slice J1, serving from an exported artifact. (a) phase 4's DiT-B/2 request exported with
# deploy/export.py and served by DeployedSampler, J1_REQUESTS seeds each against the live generate (the same
# noise from one generator, the loop traced as it runs: expected 0); (b) phase 14's C1 run through the
# export_sampler and serve CLIs, J1_SERVE_ROWS labels in the served request (fewer than its batch of 16)
J1_REQUESTS = 3
J1_DEPLOY_TOL = 0.0
J1_SERVE_ROWS = 5
# phase 27: --prompts on the card: configs/train_imagenet_repa_txt_to_img.yaml's DDT at full width with
# configs/embedder/qwen.yaml's QwenTextEmbedder and a stub encode_fn (no transformers and no Qwen3-VL-2B weights
# on the card), 4 prompts of J1_TEXT_LEN tokens at 2048 wide, on 32x32x128 latents (512 px: 1024 image tokens)
J1_TXT_CONFIG = "train_imagenet_repa_txt_to_img"
J1_PROMPTS = ("a red cube on a wooden table", "two dogs", "a city at night in the rain", "snow")
J1_TEXT_LEN, J1_TEXT_LENGTHS = 64, (64, 41, 17, 5)
J1_LATENT = (32, 32, 128)

TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 1e-2)}
LSE_TOL = (1e-4, 1e-5)
# K2, and K4/K5, against their plain versions, per gradient:
# |kernel - plain| <= tol * (max|plain| + |plain|). fp32: K2's, K4's and
# K5's products are 3xTF32 (about 2^-21 relative each), summed in another
# order. bf16: p and ds are rounded to bf16 at the same places in
# both, but exp/sum rounding (K4/K5's exp is ex2.approx) can flip a rounding
# of p, ds or the output by one bf16 step (2^-8 relative), and a gradient
# element near 0 is a sum of terms as large as the largest one.
BWD_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# seeds of the fp32 slice-shape inputs of phase 8 (K3) and phase 11 (K4, K5), drawn by txt2img_fp32_inputs
FP32_FWD_SEED, FP32_BWD_SEED = 15, 16
# gradients through dot_product_attention against autograd of the plain
# forward (impl="xla"), which rounds the upstream gradient to bf16 at other
# places than K2: the bf16 tolerance of tests/test_fused_mha.py
GRAD_PATH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# DiT-B/2 parameter gradients of one loss at the training batch, per
# parameter ||kernel path - plain path|| / ||plain path||: the attention
# forward and backward round in bf16 at other places in the two paths, and 12
# bf16 blocks carry the difference back
DIT_GRAD_TOL = 5e-2
# txt2img MMDiT parameter gradients of one loss (mixed bf16), per parameter
# ||kernel path - plain path|| / ||plain path||: K3 rounds the unnormalised p
# and K4/K5 round p and ds to bf16 where autograd of the plain forward rounds
# the normalised p and the gradient of its bf16 cast, and 12 blocks carry the
# difference back
TXT_GRAD_TOL = 5e-2
# DiT-B/2 forward, max|kernel path - plain path| / max|plain path|: 12 bf16
# blocks carry the attention difference forward through bf16 rounding
DIT_REL_TOL = 5e-2
# a whole 50-step request, kernel path against plain-attention path from the
# same noise: the per-step difference compounds along the trajectory
# (3.3e-2 measured on an H100 80GB HBM3 at 700 W)
GEN_REL_TOL = 1e-1
# the txt2img MMDiT (one forward, and a TRAJ_STEPS-step trajectory), kernel
# path against plain attention, max|diff| / max|plain|: K3 rounds the
# unnormalised p to bf16, the plain path (K1's plain version) the normalised
# p, and 12 bf16 blocks carry the difference
TXT_REL_TOL = 5e-2
TRAJ_STEPS = 4
# padded lengths about the fused/flash dispatch line (FUSED_MAX_SEQ = 512; the
# reference's VMEM budget admits the fused kernel to 640 at H=12, D=64)
CROSSOVER_SEQS = (256, 384, 512, 640, 768)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Wall time per call of ``fn`` called back to back, between two events:
    the device's time, or the host's per call where the host is slower."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between two events, so that the host's
    time per call does not enter it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # builds, allocator, library heuristics: outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (calls * replays)


def profiled_kernels(fn, calls: int = 10) -> tuple[float, int]:
    """Device time per call of ``fn`` and the number of device activities
    (kernels, copies, fills) ``torch.profiler`` saw over ``calls`` calls, in a
    profiler session of its own: for a call that a CUDA graph cannot capture
    (autograd's backward), and beside it for the kernel it is compared with.
    The session records a warm-up step of ``calls`` calls first and keeps
    only the second: late in a long process, a session without one saw 16
    of K2's 20 kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    total_us, seen = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CPU:  # the runtime's launch calls
            continue
        device_us = getattr(evt, "device_time_total", None)
        total_us += evt.cuda_time_total if device_us is None else device_us
        seen += evt.count
    return total_us / 1e3 / calls, seen


def complete_sessions(fn, complete, sessions: int = 2, attempts: int = 4):
    """Up to ``sessions`` :func:`profiled_kernels` results of ``fn`` whose
    count of device activities passes ``complete``, from at most
    ``attempts`` sessions, and the (ms, activities) of the sessions that did
    not: a session now and then loses a few of its activities (19 of K2's 20
    kernels and 45 of the SDPA backward's 50 were seen on an H100 80GB
    HBM3), and its time would then be short. The caller fails if fewer than
    ``sessions`` were complete, and prints the others."""
    kept, rejected = [], []
    for _ in range(attempts):
        if len(kept) == sessions:
            break
        ms, seen = profiled_kernels(fn)
        (kept if complete(seen) else rejected).append((ms, seen))
    return kept, rejected


def sdpa_fp32_backward(q, k, v, do, mask=None):
    """SDPA's backward as one call that a CUDA graph can capture: the
    memory-efficient attention's backward op (what the autograd of
    ``F.scaled_dot_product_attention`` runs for fp32 on this card) from that
    op's forward. q, k, v, do: [B, S, H, D]; mask: bool [B, S] (True =
    attend) or None, handed to the op as SDPA hands it a boolean mask: an
    additive bias, 0 where attended and -inf elsewhere, expanded to [B, H,
    S, S]. The call returns (dq, dk, dv) as [B, H, S, D]."""
    import torch

    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    bias = None
    if mask is not None:
        bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device).masked_fill_(~mask, float("-inf"))
        bias = bias[:, None, None, :].expand(qt.shape[0], qt.shape[1], qt.shape[2], kt.shape[2])
    out, lse, seed, offset = torch.ops.aten._scaled_dot_product_efficient_attention(qt, kt, vt, bias, True)

    def call():
        return torch.ops.aten._scaled_dot_product_efficient_attention_backward(
            dot, qt, kt, vt, bias, out, lse, seed, offset, 0.0, [True, True, True, False])[:3]

    return call


# (check name, its largest error as a fraction of its tolerance: above 1 the check fails), one entry a
# check_close or check_grads call (a gradient each), in the order of the calls; phases 2, 5 and 11 print
# their fp32 entries
TOL_FRACTIONS: list[tuple[str, float]] = []


def fp32_fractions(since: int) -> str:
    """The fp32 entries of TOL_FRACTIONS from index ``since`` on, as 'name: fraction' pairs."""
    return ", ".join(f"{name}: {frac:.3f}" for name, frac in TOL_FRACTIONS[since:]
                     if "fp32" in name or "float32" in name)


def check_close(name, ours, ref, atol, rtol) -> float:
    import torch

    err = (ours.float() - ref.float()).abs()
    allowed = atol + rtol * ref.float().abs()
    bad = err > allowed
    finite = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(ours), finite):
        fail(f"{name}: non-finite values differ")
    bad &= finite
    max_err = float(err[finite].max()) if finite.any() else 0.0
    TOL_FRACTIONS.append((name, float((err[finite] / allowed[finite]).max()) if finite.any() else 0.0))
    if bool(bad.any()):
        fail(f"{name}: max_abs_err {max_err:.3e} beyond atol {atol} + rtol {rtol}")
    return max_err


def check_grads(name, ours, refs, tol) -> float:
    """Each gradient within tol * (max|ref| + |ref|) of its reference, both
    finite; returns the largest absolute error."""
    import torch

    worst = 0.0
    for label, o, r in zip(("dq", "dk", "dv"), ours, refs):
        o, r = o.float(), r.float()
        if not (bool(torch.isfinite(o).all()) and bool(torch.isfinite(r).all())):
            fail(f"{name} {label}: non-finite gradient")
        err = (o - r).abs()
        allowed = tol * (r.abs().max() + r.abs())
        frac = torch.where(err == 0, 0.0, err / allowed)  # an all-zero reference allows nothing
        TOL_FRACTIONS.append((name if len(ours) == 1 else f"{name} {label}", float(frac.max())))
        if bool((err > allowed).any()):
            fail(f"{name} {label}: max_abs_err {float(err.max()):.3e} beyond {tol} * (max|ref| + |ref|), "
                 f"max|ref| {float(r.abs().max()):.3e}")
        worst = max(worst, float(err.max()))
    return worst


def ptxas_usage(log: str) -> dict[str, str]:
    """``{"kernel<D>": "R regs, S B spilled"}`` from an ``nvcc -Xptxas -v`` log."""
    usage, current, spill = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            # the anonymous namespace mangles as <len><source name>_cu_<hash>: keep the last name;
            # an entry that is no head-dim instance (the di pre-pass) is not reported
            current, spill = None, 0
            entry = re.search(r"Compiling entry function '\w*?((?:mha|flash)_\w+?)I((?:L[ib]\d+E)+)E", line)
            if entry:
                name = re.split(r"\d+(?=(?:mha|flash)_)", entry.group(1))[-1]
                current = f"{name}<{','.join(re.findall(r'L[ib](\d+)E', entry.group(2)))}>"
        stores = re.search(r"(\d+) bytes spill stores", line)
        if stores:
            spill = int(stores.group(1))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and current:
            usage[current] = f"{regs.group(1)} regs, {spill} B spilled"
    return usage


def phase_build():
    from diffulab_tpu_torch.ops import _build

    seconds, logs = _build.build_all()
    usage = {name: ptxas_usage(log) for name, log in logs.items()}
    # ptxas warns where it serialises wgmma (an accumulator touched in flight, too few registers)
    warnings = sorted({line.strip() for log in logs.values() for line in log.splitlines() if "warning" in line})
    print(f"phase 1 build: {len(logs)} kernel libraries in {seconds:.1f} s; ptxas: {json.dumps(usage)}; "
          f"warnings: {json.dumps(warnings)}")


def phase_kernel():
    """Each kernel case against the plain version on the same CUDA inputs."""
    import torch
    import torch.nn.functional as F

    from diffulab_tpu_torch.ops import dot_product_attention
    from diffulab_tpu_torch.ops.attention import FUSED_MAX_SEQ
    from diffulab_tpu_torch.ops.fused_mha import forward_instance, fused_mha, fused_mha_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    mark = len(TOL_FRACTIONS)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)

    results = {}
    with torch.no_grad():
        # main path's shape, q/k/v as views of one packed qkv projection output
        b, s, h, d = 2 * SAMPLE_BATCH, 256, 12, 64
        qkv = rand(b, s, 3 * h * d, dtype=torch.bfloat16)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.chunk(3, dim=-1))
        o, lse = fused_mha(q, k, v)
        ro, rlse = fused_mha_reference(q, k, v)
        err = check_close("main bf16 o", o, ro, *TOL["bfloat16"])
        check_close("main bf16 lse", lse, rlse, *LSE_TOL)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt)

        # device time from CUDA-graph replays; wall time per call back to back beside it
        kernel_ms = cuda_graph_ms(lambda: fused_mha(q, k, v))
        library_ms = cuda_graph_ms(sdpa)
        kernel_wall_ms = cuda_time_ms(lambda: fused_mha(q, k, v), iters=200)
        library_wall_ms = cuda_time_ms(sdpa, iters=200)
        plain_ms = cuda_time_ms(lambda: fused_mha_reference(q, k, v), iters=20)
        qkv64 = rand(TRAIN_BATCH, s, 3 * h * d, dtype=torch.bfloat16)
        q64, k64, v64 = (t.reshape(TRAIN_BATCH, s, h, d) for t in qkv64.chunk(3, dim=-1))
        train_ms = cuda_graph_ms(lambda: fused_mha(q64, k64, v64))
        del qkv64, q64, k64, v64
        bound_ms, bound_by, mb, gflop = attention_bound(b, s, h, d, b * s, q.element_size(), mask=False)
        inst = forward_instance(s, d)
        print(f"phase 2 kernel main B={b} S={s} H={h} D={d} bf16 ({inst}): max_abs_err {err:.3e} "
              f"(tol atol {TOL['bfloat16'][0]} rtol {TOL['bfloat16'][1]}); device ms (CUDA-graph replay) kernel "
              f"{kernel_ms:.4f} SDPA {library_ms:.4f}; wall ms per call back to back kernel {kernel_wall_ms:.4f} "
              f"SDPA {library_wall_ms:.4f}; plain_ms {plain_ms:.4f}; bound_us {bound_ms * 1e3:.2f} ({bound_by}: "
              f"{mb:.1f} MB, {gflop:.2f} GFLOP); kernel at B={TRAIN_BATCH} (training shape) device ms {train_ms:.4f}")
        results["main"] = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                               bound_ms=bound_ms, bound_by=bound_by, wall_ms=kernel_wall_ms,
                               library_wall_ms=library_wall_ms, train_shape_ms=train_ms)

        # the instances off the main path: two passes over resident K and V, chunks of 192 and 64
        # keys, and K and V streamed where they do not fit in shared memory, each with a ragged mask
        errs = {}
        for sq, skv, hd in ((512, 512, 64), (384, 384, 128), (192, 192, 32), (256, 320, 64), (448, 448, 128),
                            (128, 1024, 64), (64, 4096, 16)):
            q, k, v = rand(2, sq, 2, hd, dtype=torch.bfloat16), *(rand(2, skv, 2, hd, dtype=torch.bfloat16)
                                                                 for _ in range(2))
            kmask = torch.arange(skv, device="cuda")[None, :] < torch.tensor([skv, skv // 3 + 1], device="cuda")[:, None]
            o, lse = fused_mha(q, k, v, kmask)
            ro, rlse = fused_mha_reference(q, k, v, kmask)
            inst = forward_instance(skv, hd)
            key = f"{sq}x{skv}_D{hd}_{'resident' if inst.resident else 'streamed'}_chunk{inst.chunk}"
            errs[key] = check_close(f"instance {key} o", o, ro, *TOL["bfloat16"])
            check_close(f"instance {key} lse", lse, rlse, *LSE_TOL)
        print(f"phase 2 kernel instances bf16 (ragged mask; tol atol {TOL['bfloat16'][0]} rtol "
              f"{TOL['bfloat16'][1]}): max_abs_err " + " ".join(f"{key} {val:.3e}" for key, val in errs.items()))

        # fp32 at the main shape (the library's default dtype=None runs fp32)
        q32, k32, v32 = (rand(b, s, h, d, dtype=torch.float32) for _ in range(3))
        o, lse = fused_mha(q32, k32, v32)
        ro, rlse = fused_mha_reference(q32, k32, v32)
        err = check_close("main fp32 o", o, ro, *TOL["float32"])
        check_close("main fp32 lse", lse, rlse, *LSE_TOL)
        ms32 = cuda_time_ms(lambda: fused_mha(q32, k32, v32), iters=20)
        print(f"phase 2 kernel main fp32: max_abs_err {err:.3e} (tol atol {TOL['float32'][0]} "
              f"rtol {TOL['float32'][1]}); kernel_ms {ms32:.4f}")
        # the fp32 K1 sums P.V over every key in the tensor cores' accumulator, which rounds toward zero:
        # its longest rows, Sq = Skv = FUSED_MAX_SEQ, at D = 64 and 128, on inputs drawn in fp32
        for hd in (64, 128):
            q, k, v = (rand(4, FUSED_MAX_SEQ, 4, hd, dtype=torch.float32) for _ in range(3))
            o, lse = fused_mha(q, k, v)
            ro, rlse = fused_mha_reference(q, k, v)
            check_close(f"fp32 {FUSED_MAX_SEQ} keys D={hd} o", o, ro, *TOL["float32"])
            check_close(f"fp32 {FUSED_MAX_SEQ} keys D={hd} lse", lse, rlse, *LSE_TOL)

        for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
            tol = TOL[name]
            # ragged key mask
            q, k, v = (rand(4, 256, 4, 64, dtype=dtype) for _ in range(3))
            lengths = torch.tensor([256, 200, 77, 1], device="cuda")
            mask = torch.arange(256, device="cuda")[None, :] < lengths[:, None]
            o, lse = fused_mha(q, k, v, mask)
            ro, rlse = fused_mha_reference(q, k, v, mask)
            e_mask = check_close(f"mask {name}", o, ro, *tol)
            check_close(f"mask {name} lse", lse, rlse, *LSE_TOL)
            # unaligned 100 / 300 through the padding entry point, and cross-attention
            q, k, v = rand(2, 100, 4, 64, dtype=dtype), rand(2, 300, 4, 64, dtype=dtype), rand(2, 300, 4, 64, dtype=dtype)
            e_unal = check_close(f"unaligned {name}", dot_product_attention(q, k, v),
                                 dot_product_attention(q, k, v, impl="xla"), *tol)
            q, k, v = rand(2, 256, 4, 64, dtype=dtype), rand(2, 128, 4, 64, dtype=dtype), rand(2, 128, 4, 64, dtype=dtype)
            o, _ = fused_mha(q, k, v)
            e_cross = check_close(f"cross {name}", o, fused_mha_reference(q, k, v)[0], *tol)
            # head dims of the other instances
            e_dims = []
            for hd in (16, 32, 128):
                q, k, v = (rand(2, 128, 2, hd, dtype=dtype) for _ in range(3))
                e_dims.append(check_close(f"D={hd} {name}", fused_mha(q, k, v)[0],
                                          fused_mha_reference(q, k, v)[0], *tol))
            # a fully-masked row: o exactly 0, lse exactly +inf
            q, k, v = (rand(2, 128, 2, 64, dtype=dtype) for _ in range(3))
            mask = torch.stack([torch.zeros(128, dtype=torch.bool, device="cuda"),
                                torch.ones(128, dtype=torch.bool, device="cuda")])
            o, lse = fused_mha(q, k, v, mask)
            if not (bool((o[0] == 0).all()) and bool(torch.isposinf(lse[0]).all())):
                fail(f"fully-masked row {name}: o not exactly 0 or lse not +inf")
            e_full = check_close(f"fully-masked other row {name}", o[1], fused_mha_reference(q, k, v, mask)[0][1], *tol)
            print(f"phase 2 kernel edge cases {name} (tol atol {tol[0]} rtol {tol[1]}): max_abs_err "
                  f"mask {e_mask:.3e} unaligned_100_300 {e_unal:.3e} cross_256_128 {e_cross:.3e} "
                  f"D16/32/128 {max(e_dims):.3e} fully_masked_row o==0 lse==+inf other_row {e_full:.3e}")
        torch.cuda.synchronize()
    print(f"phase 2 fp32 errors as a fraction of the tolerance (above 1 fails): {fp32_fractions(mark)}")
    return results


def txt2img_mask(batch: int, lengths, device="cuda"):
    """[batch, TEXT_LEN + image tokens] key mask of the fused-CFG model batch:
    the cond half's text lengths, the uncond half's null embedding with one
    valid token, every image token valid."""
    import torch

    lengths = torch.tensor(list(lengths) + [NULL_SEQ_LEN] * batch, device=device)
    text = torch.arange(TEXT_LEN, device=device)[None, :] < lengths[:, None]
    image = torch.ones(2 * batch, TXT_LATENT[0] * TXT_LATENT[1], dtype=torch.bool, device=device)
    return torch.cat([text, image], dim=1)


def txt2img_fp32_inputs(batch: int, seed: int, with_do: bool = False):
    """q, k, v (and do) of the fp32 slice shape [batch, TXT_SEQ, 12, 64],
    drawn in fp32 from their own seed: a bf16 draw cast up holds exactly in
    TF32, so the low halves of the 3xTF32 split would be zero and a wrong
    split product or a drifting sum could not show. Phases 8 and 11 and
    scripts/flash_fp32_variants.py check the kernels on these."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    h, d = TXT["num_heads"], TXT["inner_dim"] // TXT["num_heads"]
    return tuple(torch.randn(batch, TXT_SEQ, h, d, generator=gen, device="cuda") for _ in range(4 if with_do else 3))


def attention_bound(b, sq, h, d, valid_keys, elem, mask: bool = True, peak_flops: float = PEAK_BF16_FLOPS):
    """(bound ms, what bounds it, MB, GFLOP) of one self-attention forward:
    q read and o written once, the rows of k and v that a row attends read
    once (``valid_keys``, the keys each batch row attends summed over the
    batch: no output depends on a masked key's), the fp32 lse and the int32
    mask (if any), and the two products over the valid keys, at
    ``peak_flops``."""
    bytes_moved = (2 * b * sq + 2 * valid_keys) * h * d * elem + b * h * sq * 4 + (b * sq * 4 if mask else 0)
    flops = 4 * h * sq * d * valid_keys
    t_bytes, t_flops = bytes_moved / PEAK_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations"), \
        bytes_moved / 1e6, flops / 1e9


def phase_flash_kernel():
    """K3 against its plain version on the same CUDA inputs: the slice shape
    with the fused-CFG ragged text mask, the edge cases, fp32, and K1 against
    K3 at 256, 384 and 512 tokens."""
    import torch
    import torch.nn.functional as F

    from diffulab_tpu_torch.ops import _build, dot_product_attention
    from diffulab_tpu_torch.ops.flash_attention import f32_fwd_keys, flash_attention, flash_attention_reference
    from diffulab_tpu_torch.ops.fused_mha import KERNEL_HEAD_DIMS, fused_mha

    gen = torch.Generator(device="cuda").manual_seed(8)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)

    def both(q, k, v, mask=None, scale=None):
        return flash_attention(q, k, v, mask, scale), flash_attention_reference(q, k, v, mask, scale)

    def check(name, pair, tol):
        (o, lse), (ro, rlse) = pair
        err = check_close(f"{name} o", o, ro, *tol)
        check_close(f"{name} lse", lse, rlse, *LSE_TOL)
        return err

    with torch.no_grad():
        b, s, h, d = 2 * TXT_BATCH, TXT_SEQ, TXT["num_heads"], TXT["inner_dim"] // TXT["num_heads"]
        mask = txt2img_mask(TXT_BATCH, TEXT_LENGTHS)
        q, k, v = (rand(b, s, h, d, dtype=torch.bfloat16) for _ in range(3))
        err = check("main bf16", both(q, k, v, mask), TOL["bfloat16"])
        kernel_ms = cuda_time_ms(lambda: flash_attention(q, k, v, mask), iters=20)
        device_ms = cuda_graph_ms(lambda: flash_attention(q, k, v, mask), calls=10, replays=5)
        plain_ms = cuda_time_ms(lambda: flash_attention_reference(q, k, v, mask), iters=2, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_mask = mask[:, None, None, :]
        library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask), iters=20)
        library_device_ms = cuda_graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask),
                                          calls=10, replays=5)
        bound_ms, bound_by, mb, gflop = attention_bound(b, s, h, d, int(mask.sum()), q.element_size())
        print(f"phase 8 kernel K3 main B={b} S={s} H={h} D={d} bf16, text mask {list(TEXT_LENGTHS)} + "
              f"{TXT_BATCH}x{NULL_SEQ_LEN}: max_abs_err {err:.3e} (tol atol {TOL['bfloat16'][0]} rtol "
              f"{TOL['bfloat16'][1]}); wall ms per call back to back kernel {kernel_ms:.4f} SDPA (masked) "
              f"{library_ms:.4f}; device ms (CUDA-graph replay) kernel {device_ms:.4f} SDPA {library_device_ms:.4f}; "
              f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}: {mb:.1f} MB, "
              f"{gflop:.1f} GFLOP; {gflop / device_ms:.1f} TFLOP/s achieved)")
        result = dict(max_abs_err=err, ms=device_ms, plain_ms=plain_ms, library_ms=library_device_ms,
                      bound_ms=bound_ms, bound_by=bound_by, wall_ms=kernel_ms, library_wall_ms=library_ms,
                      timing="ms and library_ms: device time per call from CUDA-graph replays; wall_ms and "
                             "library_wall_ms: wall time per call back to back")

        # fp32 at the slice shape (the library's default dtype=None runs fp32, and so does the MMDiT's
        # attention_dtype=float32 of phase 13b): flash_fwd_tf32x3, 3xTF32 mma.sync, its key tile the
        # emulation's (ops/flash_attention.py::f32_fwd_keys), timed beside fp32 SDPA in this call
        tiles = {hd: _build.load("flash_attn_fwd").flash_attn_fwd_f32_tiles(hd) for hd in KERNEL_HEAD_DIMS}
        if tiles != {hd: f32_fwd_keys(hd) for hd in KERNEL_HEAD_DIMS}:
            fail(f"fp32 K3 key tiles {tiles} differ from the emulation's f32_fwd_keys")
        q32, k32, v32 = txt2img_fp32_inputs(b, FP32_FWD_SEED)
        err32 = check("main fp32", both(q32, k32, v32, mask), TOL["float32"])
        ms32 = cuda_graph_ms(lambda: flash_attention(q32, k32, v32, mask), calls=10, replays=3)
        plain32 = cuda_time_ms(lambda: flash_attention_reference(q32, k32, v32, mask), iters=1, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q32, k32, v32))
        library32 = cuda_graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask), calls=10,
                                  replays=3)
        del q32, k32, v32, qt, kt, vt
        bound32, by32, mb32, gflop32 = attention_bound(b, s, h, d, int(mask.sum()), 4, peak_flops=PEAK_TF32_FLOPS / 3)
        ffma32 = attention_bound(b, s, h, d, int(mask.sum()), 4, peak_flops=PEAK_FP32_FLOPS)[0]
        result["fp32"] = dict(max_abs_err=err32, ms=ms32, plain_ms=plain32, library_ms=library32, bound_ms=bound32,
                              bound_by=by32, key_tiles=tiles)
        print(f"phase 8 kernel K3 main fp32 (flash_fwd_tf32x3, key tiles {tiles}): max_abs_err {err32:.3e} (tol "
              f"atol {TOL['float32'][0]} rtol {TOL['float32'][1]}); device ms (CUDA-graph replay) kernel {ms32:.4f} "
              f"SDPA fp32 (masked) {library32:.4f}; wall ms plain {plain32:.4f}; bound_ms {bound32:.4f} at 3xTF32 ({by32}: {mb32:.1f} MB, "
              f"{gflop32:.1f} GFLOP; {3 * gflop32 / ms32:.1f} TFLOP/s of TF32 products achieved), {ffma32:.4f} at "
              f"the fp32 CUDA-core peak")

        for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
            tol = TOL[name]
            errs = {}
            # ragged key mask at a length that is no multiple of the tiles
            q, k, v = (rand(4, 300, 4, 64, dtype=dtype) for _ in range(3))
            lengths = torch.tensor([300, 200, 77, 1], device="cuda")
            kmask = torch.arange(300, device="cuda")[None, :] < lengths[:, None]
            errs["mask_300"] = check(f"mask {name}", both(q, k, v, kmask), tol)
            # unaligned 100 / 300, cross-attention 256 / 128, 600 tokens
            q, k, v = rand(2, 100, 4, 64, dtype=dtype), rand(2, 300, 4, 64, dtype=dtype), rand(2, 300, 4, 64, dtype=dtype)
            errs["unaligned_100_300"] = check(f"unaligned {name}", both(q, k, v), tol)
            q, k, v = rand(2, 256, 4, 64, dtype=dtype), rand(2, 128, 4, 64, dtype=dtype), rand(2, 128, 4, 64, dtype=dtype)
            errs["cross_256_128"] = check(f"cross {name}", both(q, k, v), tol)
            q, k, v = (rand(2, 600, 4, 64, dtype=dtype) for _ in range(3))
            errs["seq_600"] = check(f"600 tokens {name}", both(q, k, v), tol)
            errs["scale_0.3"] = check(f"scale override {name}", both(q, k, v, None, 0.3), tol)
            # q/k/v as strided views of one packed projection output, through the entry point
            qkv = rand(2, 600, 3 * 4 * 64, dtype=dtype)
            q, k, v = (t.reshape(2, 600, 4, 64) for t in qkv.chunk(3, dim=-1))
            errs["packed_views"] = check_close(f"packed views {name}", dot_product_attention(q, k, v, impl="flash"),
                                               flash_attention_reference(q, k, v)[0], *tol)
            # head dims of the other instances
            errs["D16/32/128"] = max(check(f"D={hd} {name}", both(*(rand(2, 200, 2, hd, dtype=dtype) for _ in range(3))), tol)
                                     for hd in (16, 32, 128))
            # a fully-masked row: o exactly 0, lse exactly +inf
            q, k, v = (rand(2, 200, 2, 64, dtype=dtype) for _ in range(3))
            fmask = torch.stack([torch.zeros(200, dtype=torch.bool, device="cuda"),
                                 torch.ones(200, dtype=torch.bool, device="cuda")])
            (o, lse), (ro, _) = both(q, k, v, fmask)
            if not (bool((o[0] == 0).all()) and bool(torch.isposinf(lse[0]).all())):
                fail(f"K3 fully-masked row {name}: o not exactly 0 or lse not +inf")
            errs["fully_masked_other_row"] = check_close(f"fully-masked other row {name}", o[1], ro[1], *tol)
            # the Hopper K3's tile edges: 128 queries a CTA in 64-row warpgroup tiles, 128-key ring tiles
            q = rand(2, 200, 4, 64, dtype=dtype)
            for skv in (129, 130):  # one and two keys past a tile
                k, v = rand(2, skv, 4, 64, dtype=dtype), rand(2, skv, 4, 64, dtype=dtype)
                kmask = torch.arange(skv, device="cuda")[None, :] < torch.tensor([[skv], [100]], device="cuda")
                errs[f"skv_{skv}"] = check(f"Skv={skv} {name}", both(q, k, v, kmask), tol)
            k, v = rand(2, 300, 4, 64, dtype=dtype), rand(2, 300, 4, 64, dtype=dtype)
            for sq in (65, 129):  # one query past a warpgroup's tile and past a CTA
                errs[f"sq_{sq}"] = check(f"Sq={sq} {name}", both(rand(2, sq, 4, 64, dtype=dtype), k, v), tol)
            errs["skv_64_50"] = max(check(f"Skv={skv} {name}", both(
                q, rand(2, skv, 4, 64, dtype=dtype), rand(2, skv, 4, 64, dtype=dtype)), tol) for skv in (64, 50))
            # a 128-key hole: a whole tile of masked keys between two valid ones
            q, k, v = (rand(2, 384, 4, 64, dtype=dtype) for _ in range(3))
            hmask = torch.ones(2, 384, dtype=torch.bool, device="cuda")
            hmask[:, 128:256] = False
            errs["hole_128"] = check(f"128-key hole {name}", both(q, k, v, hmask), tol)
            # D = 128 at ragged lengths, with a mask
            kmask = torch.arange(300, device="cuda")[None, :] < torch.tensor([[300], [131]], device="cuda")
            errs["D128_130_300"] = check(f"D=128 130/300 {name}", both(
                rand(2, 130, 2, 128, dtype=dtype), rand(2, 300, 2, 128, dtype=dtype), rand(2, 300, 2, 128, dtype=dtype),
                kmask), tol)
            if dtype == torch.bfloat16:  # past the key-mask words a CTA holds (65536 keys): read tile by tile
                skv = 65600
                kmask = torch.rand(1, skv, generator=gen, device="cuda") < 0.9
                errs["skv_65600_mask"] = check(f"Skv={skv} {name}", both(
                    rand(1, 64, 1, 64, dtype=dtype), rand(1, skv, 1, 64, dtype=dtype), rand(1, skv, 1, 64, dtype=dtype),
                    kmask), tol)
            print(f"phase 8 kernel K3 edge cases {name} (tol atol {tol[0]} rtol {tol[1]}): max_abs_err "
                  + " ".join(f"{key} {val:.3e}" for key, val in errs.items()) + "; fully_masked_row o==0 lse==+inf")

        # K1 against K3 about the dispatch line (FUSED_MAX_SEQ; the reference's budget reaches 640 at H=12):
        # device times from CUDA-graph replays
        times = {}
        for bb in (TXT_BATCH * 2, 32, TRAIN_BATCH):
            for ss in CROSSOVER_SEQS:
                q, k, v = (rand(bb, ss, 12, 64, dtype=torch.bfloat16) for _ in range(3))
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                times[f"B{bb}_S{ss}"] = (cuda_graph_ms(lambda: fused_mha(q, k, v)),
                                         cuda_graph_ms(lambda: flash_attention(q, k, v)),
                                         cuda_graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)))
        print("phase 8 K1 vs K3 (H=12, D=64, bf16, device ms from CUDA-graph replays; SDPA as the yardstick): "
              + " ".join(f"{key} K1 {k1:.4f} K3 {k3:.4f} SDPA {sd:.4f}" for key, (k1, k3, sd) in times.items()))
        result["crossover"] = times
    torch.cuda.synchronize()
    return result


def txt2img_train_mask(device="cuda"):
    """[TXT_TRAIN_BATCH, TXT_SEQ] key mask of a txt2img training batch: the
    batch's text lengths, the rows the CFG drop sent to the null embedding
    with its one valid token, every image token valid."""
    import torch

    lengths = torch.tensor(TRAIN_TEXT_LENGTHS, device=device)
    lengths[list(TRAIN_DROPPED)] = NULL_SEQ_LEN
    text = torch.arange(TEXT_LEN, device=device)[None, :] < lengths[:, None]
    image = torch.ones(len(TRAIN_TEXT_LENGTHS), TXT_LATENT[0] * TXT_LATENT[1], dtype=torch.bool, device=device)
    return torch.cat([text, image], dim=1)


def flash_bwd_bounds(b, sq, h, d, valid_keys, elem, peak_flops: float = PEAK_BF16_FLOPS):
    """{kernel: (bound ms, what bounds it, MB, GFLOP)} of K4 and K5: K4 reads
    q, k, v, o, do, lse and the mask and writes dk, dv and di; K5 reads q, k,
    v, do, lse, di and the mask and writes dq; K4 makes four products over
    the keys each row attends (s, dv, dp, dk), K5 three (s, dp, dq), at
    ``peak_flops``."""
    row = b * sq * h * d * elem
    vec = b * h * sq * 4
    out = {}
    for name, n_bytes, products in (("flash_attn_bwd_dkv", 7 * row + 2 * vec + b * sq * 4, 4),
                                    ("flash_attn_bwd_dq", 5 * row + 2 * vec + b * sq * 4, 3)):
        flops = products * 2 * h * sq * d * valid_keys
        t_bytes, t_flops = n_bytes / PEAK_BYTES_PER_S, flops / peak_flops
        out[name] = (max(t_bytes, t_flops) * 1e3, "bytes" if t_bytes >= t_flops else "operations",
                     n_bytes / 1e6, flops / 1e9)
    return out


def phase_flash_bwd_kernel(forward_times=None):
    """K4 and K5 against their plain version on the same CUDA inputs, from
    the o and lse K3 gives: the slice shape with the training key mask, fp32,
    the edge cases, the entry point under grad, and K2 against K4+K5 at
    CROSSOVER_SEQS tokens (with ``forward_times``, phase 8's K1 and K3 there,
    the two routes' sums)."""
    import torch
    import torch.nn.functional as F

    from diffulab_tpu_torch.ops import _build, dot_product_attention
    from diffulab_tpu_torch.ops.flash_attention import (
        f32_dkv_queries,
        f32_dq_keys,
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_reference,
    )
    from diffulab_tpu_torch.ops.fused_mha import KERNEL_HEAD_DIMS, fused_mha, fused_mha_bwd

    gen = torch.Generator(device="cuda").manual_seed(11)
    mark = len(TOL_FRACTIONS)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)

    def both(q, k, v, do, mask=None, scale=None):
        o, lse = flash_attention(q, k, v, mask, scale)
        return (flash_attention_bwd(q, k, v, mask, o, lse, do, scale),
                flash_attention_bwd_reference(q, k, v, mask, o, lse, do, scale))

    b, s, h, d = TXT_TRAIN_BATCH, TXT_SEQ, TXT["num_heads"], TXT["inner_dim"] // TXT["num_heads"]
    scale = d ** -0.5
    mask = txt2img_train_mask()
    with torch.no_grad():
        # the slice shape, q/k/v as views of one packed qkv projection output
        qkv = rand(b, s, 3 * h * d, dtype=torch.bfloat16)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.chunk(3, dim=-1))
        do = rand(b, s, h, d, dtype=torch.bfloat16)
        o, lse = flash_attention(q, k, v, mask)
        ours = flash_attention_bwd(q, k, v, mask, o, lse, do)
        ref = flash_attention_bwd_reference(q, k, v, mask, o, lse, do)
        errs = {name: check_grads(f"main bf16 {name}", [g], [r], BWD_TOL["bfloat16"])
                for name, g, r in zip(("dq", "dk", "dv"), ours, ref)}
        del ours, ref
        dkv_ms = cuda_time_ms(lambda: flash_attention_bwd_dkv(q, k, v, mask, o, lse, do, scale), iters=10)
        _, _, di = flash_attention_bwd_dkv(q, k, v, mask, o, lse, do, scale)
        dq_ms = cuda_time_ms(lambda: flash_attention_bwd_dq(q, k, v, mask, lse, di, do, scale), iters=10)
        both_ms = cuda_time_ms(lambda: flash_attention_bwd(q, k, v, mask, o, lse, do), iters=10)
        dkv_device = cuda_graph_ms(lambda: flash_attention_bwd_dkv(q, k, v, mask, o, lse, do, scale), calls=10,
                                   replays=3)
        dq_device = cuda_graph_ms(lambda: flash_attention_bwd_dq(q, k, v, mask, lse, di, do, scale), calls=10,
                                  replays=3)
        plain_ms = cuda_time_ms(lambda: flash_attention_bwd_reference(q, k, v, mask, o, lse, do), iters=1, warmup=1)
    with torch.enable_grad():
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None, None, :])
        dot = do.transpose(1, 2)
        library_ms = cuda_time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), iters=10)
        # SDPA's bf16 autograd backward is not the memory-efficient op that sdpa_fp32_backward replays (on an
        # H100 80GB HBM3 that op took 10.8 ms where autograd's whole call took 3.7), so its kernels are summed
        library_device = profiled_kernels(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))[0]
        del out, qt, kt, vt
    valid = int(mask.sum())
    bounds = flash_bwd_bounds(b, s, h, d, valid, q.element_size())
    results = {}
    for name, ms, device, grads in (("flash_attn_bwd_dkv", dkv_ms, dkv_device, ("dk", "dv")),
                                    ("flash_attn_bwd_dq", dq_ms, dq_device, ("dq",))):
        bound_ms, bound_by, mb, gflop = bounds[name]
        results[name] = dict(max_abs_err=max(errs[g] for g in grads), ms=device, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, library_ms=library_device, wall_ms=ms,
                             library_wall_ms=library_ms,
                             timing="ms: device time per call from CUDA-graph replays; library_ms: device time "
                                    "per call of SDPA's masked autograd backward (dq, dk and dv together), kernels "
                                    "summed by torch.profiler; wall_ms and library_wall_ms: wall time per call back "
                                    "to back")
        print(f"phase 11 kernel {'K4' if name.endswith('dkv') else 'K5'} {name} main B={b} S={s} H={h} D={d} bf16, "
              f"text lengths {list(TRAIN_TEXT_LENGTHS)} with rows {list(TRAIN_DROPPED)} dropped to {NULL_SEQ_LEN}: "
              f"max_abs_err " + " ".join(f"{g} {errs[g]:.3e}" for g in grads)
              + f" (tol {BWD_TOL['bfloat16']} * (max|ref| + |ref|)); device ms (CUDA-graph replay) {device:.4f} "
              f"wall ms per call back to back {ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}: {mb:.1f} MB, "
              f"{gflop:.1f} GFLOP; {gflop / device:.1f} TFLOP/s achieved)")
    print(f"phase 11 K4+K5 main: wall ms {both_ms:.4f} (one flash_attention_bwd call) plain_ms {plain_ms:.4f} "
          f"(K4 and K5 together) SDPA masked autograd backward (dq, dk and dv together): device ms (kernels summed "
          f"by torch.profiler) {library_device:.4f} wall ms {library_ms:.4f} "
          f"bound_ms {bounds['flash_attn_bwd_dkv'][0] + bounds['flash_attn_bwd_dq'][0]:.4f}")

    with torch.no_grad():
        # fp32 at the slice shape (the library's default dtype=None trains in fp32, and so does the
        # MMDiT's attention_dtype=float32 of phase 13b): K4 as flash_bwd_dkv_tf32x3 after the pre-pass
        # and K5 as flash_bwd_dq_tf32x3 (3xTF32 mma.sync, their query and key tiles the emulations',
        # ops/flash_attention.py::f32_dkv_queries and f32_dq_keys), each timed, beside SDPA's fp32 masked
        # backward
        lib = _build.load("flash_attn_bwd")
        tiles = {hd: lib.flash_attn_bwd_f32_tiles(hd, 0) for hd in KERNEL_HEAD_DIMS}
        if tiles != {hd: f32_dkv_queries(hd) for hd in KERNEL_HEAD_DIMS}:
            fail(f"fp32 K4 query tiles {tiles} differ from the emulation's f32_dkv_queries")
        dq_tiles = {hd: lib.flash_attn_bwd_f32_tiles(hd, 1) for hd in KERNEL_HEAD_DIMS}
        if dq_tiles != {hd: f32_dq_keys(hd) for hd in KERNEL_HEAD_DIMS}:
            fail(f"fp32 K5 key tiles {dq_tiles} differ from the emulation's f32_dq_keys")
        q32, k32, v32, do32 = txt2img_fp32_inputs(b, FP32_BWD_SEED, with_do=True)
        (g32, r32) = both(q32, k32, v32, do32, mask)
        slice_mark = len(TOL_FRACTIONS)
        errs32 = {name: check_grads(f"main fp32 {name}", [g], [r], BWD_TOL["float32"])
                  for name, g, r in zip(("dq", "dk", "dv"), g32, r32)}
        of_tol32 = dict(zip(("dq", "dk", "dv"), (frac for _, frac in TOL_FRACTIONS[slice_mark:])))
        o32, lse32 = flash_attention(q32, k32, v32, mask)
        dkv32 = cuda_graph_ms(lambda: flash_attention_bwd_dkv(q32, k32, v32, mask, o32, lse32, do32, scale), calls=5,
                              replays=3)
        _, _, di32 = flash_attention_bwd_dkv(q32, k32, v32, mask, o32, lse32, do32, scale)
        dq32 = cuda_graph_ms(lambda: flash_attention_bwd_dq(q32, k32, v32, mask, lse32, di32, do32, scale), calls=3,
                             replays=2)
        plain32 = cuda_time_ms(lambda: flash_attention_bwd_reference(q32, k32, v32, mask, o32, lse32, do32), iters=1,
                               warmup=1)
        library_device32 = cuda_graph_ms(sdpa_fp32_backward(q32, k32, v32, do32, mask), calls=3, replays=2)
        del g32, r32, o32, lse32, di32, q32, k32, v32, do32
    bounds32 = flash_bwd_bounds(b, s, h, d, valid, 4, peak_flops=PEAK_TF32_FLOPS / 3)
    ffma32 = flash_bwd_bounds(b, s, h, d, valid, 4, peak_flops=PEAK_FP32_FLOPS)
    for name, ms, grads in (("flash_attn_bwd_dkv", dkv32, ("dk", "dv")), ("flash_attn_bwd_dq", dq32, ("dq",))):
        results[name]["fp32"] = dict(max_abs_err=max(errs32[g] for g in grads), ms=ms, plain_ms=plain32,
                                     library_ms=library_device32, bound_ms=bounds32[name][0],
                                     bound_by=bounds32[name][1], of_tol={g: of_tol32[g] for g in grads},
                                     **({"query_tiles": tiles} if name == "flash_attn_bwd_dkv" else
                                        {"key_tiles": dq_tiles}))
    gflop_dkv, gflop_dq = bounds32["flash_attn_bwd_dkv"][3], bounds32["flash_attn_bwd_dq"][3]
    print(f"phase 11 kernel K4+K5 main fp32 (the slice shape; flash_bwd_dkv_tf32x3 with query tiles {tiles} after "
          f"the pre-pass, flash_bwd_dq_tf32x3 with key tiles {dq_tiles}): max_abs_err "
          + " ".join(f"{g} {e:.3e}" for g, e in errs32.items())
          + f" (tol {BWD_TOL['float32']} * (max|ref| + |ref|); as a fraction of it "
          + " ".join(f"{g} {f:.3f}" for g, f in of_tol32.items())
          + f"); device ms (CUDA-graph replay) K4 with its pre-pass {dkv32:.4f} ({3 * gflop_dkv / dkv32:.1f} TFLOP/s "
          f"of TF32 products achieved) K5 {dq32:.4f} ({3 * gflop_dq / dq32:.1f} TFLOP/s) K4+K5 {dkv32 + dq32:.4f} SDPA "
          f"fp32 masked backward op {library_device32:.4f} (dq, dk, dv together); wall ms plain {plain32:.4f}; bounds "
          f"at 3xTF32 K4 {bounds32['flash_attn_bwd_dkv'][0]:.4f} K5 {bounds32['flash_attn_bwd_dq'][0]:.4f}, at the "
          f"fp32 CUDA-core peak K4 {ffma32['flash_attn_bwd_dkv'][0]:.4f} K5 {ffma32['flash_attn_bwd_dq'][0]:.4f}")

    for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        tol = BWD_TOL[name]
        errs = {}
        with torch.no_grad():
            # ragged key mask at a length that is no multiple of the tiles
            q, k, v, do = (rand(4, 300, 4, 64, dtype=dtype) for _ in range(4))
            lengths = torch.tensor([300, 200, 77, 1], device="cuda")
            kmask = torch.arange(300, device="cuda")[None, :] < lengths[:, None]
            errs["mask_300"] = check_grads(f"mask {name}", *both(q, k, v, do, kmask), tol)
            # unaligned 100 / 300, cross-attention 256 / 128, 600 tokens, scale 0.3
            q, do = rand(2, 100, 4, 64, dtype=dtype), rand(2, 100, 4, 64, dtype=dtype)
            k, v = rand(2, 300, 4, 64, dtype=dtype), rand(2, 300, 4, 64, dtype=dtype)
            errs["unaligned_100_300"] = check_grads(f"unaligned {name}", *both(q, k, v, do), tol)
            q, do = rand(2, 256, 4, 64, dtype=dtype), rand(2, 256, 4, 64, dtype=dtype)
            k, v = rand(2, 128, 4, 64, dtype=dtype), rand(2, 128, 4, 64, dtype=dtype)
            errs["cross_256_128"] = check_grads(f"cross {name}", *both(q, k, v, do), tol)
            q, k, v, do = (rand(2, 600, 4, 64, dtype=dtype) for _ in range(4))
            errs["seq_600"] = check_grads(f"600 tokens {name}", *both(q, k, v, do), tol)
            errs["scale_0.3"] = check_grads(f"scale override {name}", *both(q, k, v, do, None, 0.3), tol)
            # q/k/v and do as strided views of packed tensors
            qkv = rand(2, 600, 3 * 4 * 64, dtype=dtype)
            q, k, v = (t.reshape(2, 600, 4, 64) for t in qkv.chunk(3, dim=-1))
            do = rand(2, 4, 600, 64, dtype=dtype).transpose(1, 2)
            errs["packed_views"] = check_grads(f"packed views {name}", *both(q, k, v, do), tol)
            # head dims of the other instances
            errs["D16/32/128"] = max(check_grads(f"D={hd} {name}", *both(*(rand(2, 200, 2, hd, dtype=dtype)
                                                                            for _ in range(4))), tol)
                                     for hd in (16, 32, 128))
            # the tile edges of the bf16 kernels at D = 64 and 128 (128 keys a K4 CTA, 128 queries a K5
            # CTA, 64-query and 64-key ring tiles, 32-query tiles at D = 128)
            q, do = rand(2, 200, 4, 64, dtype=dtype), rand(2, 200, 4, 64, dtype=dtype)
            for skv in (129, 130):  # one and two keys past a K4 CTA
                k, v = rand(2, skv, 4, 64, dtype=dtype), rand(2, skv, 4, 64, dtype=dtype)
                kmask = torch.arange(skv, device="cuda")[None, :] < torch.tensor([[skv], [100]], device="cuda")
                errs[f"skv_{skv}"] = check_grads(f"Skv={skv} {name}", *both(q, k, v, do, kmask), tol)
            q, do = rand(2, 65, 4, 64, dtype=dtype), rand(2, 65, 4, 64, dtype=dtype)  # one query past a tile
            k, v = rand(2, 300, 4, 64, dtype=dtype), rand(2, 300, 4, 64, dtype=dtype)
            errs["sq_65"] = check_grads(f"Sq=65 {name}", *both(q, k, v, do), tol)
            # a 128-key hole in the middle: a whole K4 CTA and two K5 tiles of masked keys
            q, k, v, do = (rand(2, 384, 4, 64, dtype=dtype) for _ in range(4))
            hmask = torch.ones(2, 384, dtype=torch.bool, device="cuda")
            hmask[:, 128:256] = False
            ours, ref = both(q, k, v, do, hmask)
            if not all(bool((g[:, 128:256] == 0).all()) for g in ours[1:]):
                fail(f"K4 128-key hole {name}: dk or dv of a masked key not exactly 0")
            errs["hole_128"] = check_grads(f"128-key hole {name}", ours, ref, tol)
            # D = 128 at ragged lengths, with a mask
            q, do = rand(2, 130, 2, 128, dtype=dtype), rand(2, 130, 2, 128, dtype=dtype)
            k, v = rand(2, 300, 2, 128, dtype=dtype), rand(2, 300, 2, 128, dtype=dtype)
            kmask = torch.arange(300, device="cuda")[None, :] < torch.tensor([[300], [131]], device="cuda")
            errs["D128_130_300"] = check_grads(f"D=128 130/300 {name}", *both(q, k, v, do, kmask), tol)
            # at most one key tile: Skv 64 and 50 (the second warpgroup of K4 has no key)
            q, do = rand(2, 200, 4, 64, dtype=dtype), rand(2, 200, 4, 64, dtype=dtype)
            errs["skv_64_50"] = max(check_grads(f"Skv={skv} {name}", *both(
                q, rand(2, skv, 4, 64, dtype=dtype), rand(2, skv, 4, 64, dtype=dtype), do), tol) for skv in (64, 50))
            # a fully-masked row: its dq exactly 0, and no key of it gets a gradient from it
            q, k, v, do = (rand(2, 200, 2, 64, dtype=dtype) for _ in range(4))
            fmask = torch.stack([torch.zeros(200, dtype=torch.bool, device="cuda"),
                                 torch.ones(200, dtype=torch.bool, device="cuda")])
            ours, ref = both(q, k, v, do, fmask)
            if not all(bool((g[0] == 0).all()) for g in ours):
                fail(f"K4/K5 fully-masked row {name}: dq, dk or dv not exactly 0")
            errs["fully_masked_other_row"] = check_grads(f"fully-masked other row {name}", [g[1] for g in ours],
                                                         [g[1] for g in ref], tol)
        # the entry point under grad (autograd through FlashAttention: K3, then K4 and K5)
        qs, ks, vs = rand(2, 100, 4, 64, dtype=dtype), rand(2, 300, 4, 64, dtype=dtype), rand(2, 300, 4, 64, dtype=dtype)
        do = rand(2, 100, 4, 64, dtype=dtype)
        leaves = [t.clone().requires_grad_() for t in (qs, ks, vs)]
        grads = torch.autograd.grad(dot_product_attention(*leaves, impl="flash"), leaves, do)
        o, lse = flash_attention(qs, ks, vs)
        errs["entry_point_grad"] = check_grads(f"entry point {name}", grads,
                                               flash_attention_bwd_reference(qs, ks, vs, None, o, lse, do), tol)
        print(f"phase 11 kernel K4/K5 edge cases {name} (tol {tol} * (max|ref| + |ref|)): max_abs_err "
              + " ".join(f"{key} {val:.3e}" for key, val in errs.items()) + "; fully_masked_row grads==0")
    print(f"phase 11 fp32 errors as a fraction of the tolerance (above 1 fails): {fp32_fractions(mark)}")

    # K2 against K4+K5 about the dispatch line, each after its own forward: device times from CUDA-graph
    # replays; with phase 8's forwards, the fused route (K1 + K2) against the flash route (K3 + K4 + K5)
    times = {}
    with torch.no_grad():
        for bb in (32, TRAIN_BATCH):
            for ss in CROSSOVER_SEQS:
                q, k, v, do = (rand(bb, ss, 12, 64, dtype=torch.bfloat16) for _ in range(4))
                _, lse1 = fused_mha(q, k, v)
                o3, lse3 = flash_attention(q, k, v)
                times[f"B{bb}_S{ss}"] = (
                    cuda_graph_ms(lambda: fused_mha_bwd(q, k, v, None, lse1, do), calls=10, replays=5),
                    cuda_graph_ms(lambda: flash_attention_bwd(q, k, v, None, o3, lse3, do), calls=10, replays=5))
                del q, k, v, do, lse1, o3, lse3
    print("phase 11 K2 vs K4+K5 (H=12, D=64, bf16, device ms from CUDA-graph replays): " + " ".join(
        f"{key} K2 {k2:.4f} K4+K5 {k45:.4f}" for key, (k2, k45) in times.items()))
    if forward_times is not None:
        print("phase 11 fused route K1+K2 vs flash route K3+K4+K5 (forward and backward, device ms): " + " ".join(
            f"{key} {forward_times[key][0] + k2:.4f} vs {forward_times[key][1] + k45:.4f}"
            for key, (k2, k45) in times.items() if key in forward_times))
    torch.cuda.synchronize()
    return results, times


def randomize_(model, seed: int) -> None:
    """Seeded noise in every parameter, so the adaLN-zero blocks are live."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if p.ndim >= 2:
                noise = torch.randn(p.shape, generator=gen) * math.prod(p.shape[1:]) ** -0.5
            elif name.endswith("bias"):
                noise = 0.1 * torch.randn(p.shape, generator=gen)
            else:
                noise = 1.0 + 0.1 * torch.randn(p.shape, generator=gen)
            p.copy_(noise)


def build_models():
    import torch

    from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT

    kw = dict(DIT_B2, dtype=torch.bfloat16, stream_dtype=torch.bfloat16)
    model = MMDiT(**kw)  # no device: the card
    randomize_(model, seed=0)
    plain = MMDiT(**kw, attention_impl="xla")
    plain.load_state_dict(model.state_dict(), strict=True)
    return model.eval(), plain.eval()


def phase_forward(model, plain):
    import torch

    from diffulab_tpu_torch.ops.fused_mha import LAUNCHES

    gen = torch.Generator(device="cuda").manual_seed(1)
    b = 2 * SAMPLE_BATCH
    x = torch.randn(b, *LATENT, generator=gen, device="cuda").bfloat16()
    t = torch.rand(b, generator=gen, device="cuda")
    y = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    drop = torch.arange(b, device="cuda") >= SAMPLE_BATCH
    with torch.no_grad():
        before = LAUNCHES["fused_mha_fwd"]
        out = model(x, t, {"y": y}, drop)["x"]
        launches = LAUNCHES["fused_mha_fwd"] - before
        ref = plain(x, t, {"y": y}, drop)["x"]
    torch.cuda.synchronize()
    if out.shape != (b, *LATENT) or not bool(torch.isfinite(out).all()):
        fail("DiT-B/2 forward: bad shape or non-finite output")
    rel = float((out.float() - ref.float()).abs().max() / ref.float().abs().max())
    if rel > DIT_REL_TOL or launches != DIT_B2["depth"]:
        fail(f"DiT-B/2 forward: rel err {rel:.3e} (tol {DIT_REL_TOL}), launches {launches}")
    print(f"phase 3 DiT-B/2 forward B={b} bf16: kernel path vs plain attention max rel err {rel:.3e} "
          f"(tol {DIT_REL_TOL}); {launches} kernel launches; output max |x| {float(ref.float().abs().max()):.3f}")


def phase_generate(model, plain):
    import torch

    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.ops.fused_mha import LAUNCHES

    diffuser = Diffuser(model, "euler", model_type="rectified_flow", n_steps=STEPS,
                        extra_args={"logits_normal": True})
    per_request = STEPS * DIT_B2["depth"]
    times, first = [], None
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    labels = torch.Generator(device="cuda").manual_seed(99)
    for r in range(N_REQUESTS):
        y = torch.randint(0, 1000, (SAMPLE_BATCH,), generator=labels, device="cuda")
        noise = torch.Generator(device="cuda").manual_seed(100 + r)
        before = LAUNCHES["fused_mha_fwd"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = diffuser.generate({"y": y}, data_shape=(SAMPLE_BATCH, *LATENT), generator=noise,
                                guidance_scale=CFG, dtype=torch.bfloat16)["x"]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launched = LAUNCHES["fused_mha_fwd"] - before
        if out.shape != (SAMPLE_BATCH, *LATENT) or out.dtype != torch.bfloat16:
            fail(f"request {r}: output {tuple(out.shape)} {out.dtype}")
        if not bool(torch.isfinite(out).all()):
            fail(f"request {r}: non-finite output")
        if launched != per_request:
            fail(f"request {r}: {launched} fused_mha_fwd launches, expected {per_request}")
        if first is None:
            first = (y, out)
    counts = launch_counts()
    total_launches = counts["fused_mha_fwd"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # request 0 again with the plain attention, from the same starting noise
    y, out = first
    noise = torch.Generator(device="cuda").manual_seed(100)
    ref = Diffuser(plain, "euler", n_steps=STEPS).generate(
        {"y": y}, data_shape=(SAMPLE_BATCH, *LATENT), generator=noise, guidance_scale=CFG,
        dtype=torch.bfloat16)["x"]
    rel = float((out.float() - ref.float()).abs().max() / ref.float().abs().max())
    if rel > GEN_REL_TOL:
        fail(f"request 0 against its plain-attention rerun: rel err {rel:.3e} (tol {GEN_REL_TOL})")
    ms = [t * 1e3 for t in times]
    print(f"phase 4 generate x{N_REQUESTS}: batch {SAMPLE_BATCH} {LATENT} Euler-{STEPS} CFG {CFG} bf16: "
          f"ms/request {[round(m, 2) for m in ms]} (median {statistics.median(ms):.2f}), imgs/s "
          f"{[round(SAMPLE_BATCH / t, 2) for t in times]}; fused_mha_fwd launches {per_request}/request "
          f"({total_launches} total); peak mem {peak_gib:.2f} GiB; request 0 vs plain-attention rerun "
          f"max rel err {rel:.3e} (tol {GEN_REL_TOL})")
    return counts, ms


def phase_kernel_bwd():
    """K2 against its plain version on the same CUDA inputs, from the lse K1 gives."""
    import torch
    import torch.nn.functional as F

    from diffulab_tpu_torch.ops import dot_product_attention
    from diffulab_tpu_torch.ops.attention import FUSED_MAX_SEQ
    from diffulab_tpu_torch.ops.fused_mha import fused_mha, fused_mha_bwd, fused_mha_bwd_reference

    gen = torch.Generator(device="cuda").manual_seed(5)
    mark = len(TOL_FRACTIONS)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)

    def both(q, k, v, do, mask=None):
        _, lse = fused_mha(q, k, v, mask)
        return fused_mha_bwd(q, k, v, mask, lse, do), fused_mha_bwd_reference(q, k, v, mask, lse, do)

    with torch.no_grad():
        # the training shape, q/k/v as views of one packed qkv projection output
        b, s, h, d = TRAIN_BATCH, 256, 12, 64
        qkv = rand(b, s, 3 * h * d, dtype=torch.bfloat16)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.chunk(3, dim=-1))
        do = rand(b, s, h, d, dtype=torch.bfloat16)
        _, lse = fused_mha(q, k, v)
        ours = fused_mha_bwd(q, k, v, None, lse, do)
        err = check_grads("main bf16", ours, fused_mha_bwd_reference(q, k, v, None, lse, do), BWD_TOL["bfloat16"])
        kernel_ms = cuda_time_ms(lambda: fused_mha_bwd(q, k, v, None, lse, do), iters=100)
        device_ms = profiled_kernels(lambda: fused_mha_bwd(q, k, v, None, lse, do))[0]
        plain_ms = cuda_time_ms(lambda: fused_mha_bwd_reference(q, k, v, None, lse, do), iters=10)
    with torch.enable_grad():
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        library_ms = cuda_time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True),
                                  iters=100)
        library_device_ms = profiled_kernels(
            lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))[0]
        del out
    elem = q.element_size()
    bytes_moved = 7 * b * s * h * d * elem + b * s * h * 4  # q, k, v, do, dq, dk, dv once each + lse
    flops = 10 * b * h * s * s * d  # the recomputed s and four products
    bound_ms = max(bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3
    bound_by = "bytes" if bytes_moved / PEAK_BYTES_PER_S >= flops / PEAK_BF16_FLOPS else "operations"
    print(f"phase 5 kernel K2 main B={b} S={s} H={h} D={d} bf16: max_abs_err {err:.3e} "
          f"(tol {BWD_TOL['bfloat16']} * (max|ref| + |ref|)); wall ms per call back to back kernel {kernel_ms:.4f} "
          f"SDPA backward {library_ms:.4f}; device ms (kernels summed by torch.profiler) kernel {device_ms:.4f} SDPA "
          f"backward {library_device_ms:.4f}; plain_ms {plain_ms:.4f}; bound_us {bound_ms * 1e3:.2f} "
          f"({bound_by}: {bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    result = dict(max_abs_err=err, ms=device_ms, plain_ms=plain_ms, library_ms=library_device_ms,
                  bound_ms=bound_ms, bound_by=bound_by, wall_ms=kernel_ms, library_wall_ms=library_ms,
                  timing="ms and library_ms: device time per call, kernels summed by torch.profiler; wall_ms and "
                         "library_wall_ms: wall time per call back to back")

    with torch.no_grad():
        # fp32 at the training shape (the library's default dtype=None trains in fp32)
        q32, k32, v32, do32 = (rand(b, s, h, d, dtype=torch.float32) for _ in range(4))
        err32 = check_grads("main fp32", *both(q32, k32, v32, do32), BWD_TOL["float32"])
        _, lse32 = fused_mha(q32, k32, v32)
        ms32 = cuda_time_ms(lambda: fused_mha_bwd(q32, k32, v32, None, lse32, do32), iters=10)
        del q32, k32, v32, do32, lse32
        # the fp32 K2 sums dq over every key and dk, dv over every query in the tensor cores' accumulator:
        # its longest rows, Sq = Skv = FUSED_MAX_SEQ, at D = 64 and 128, on inputs drawn in fp32
        for hd in (64, 128):
            check_grads(f"fp32 {FUSED_MAX_SEQ} keys D={hd}", *both(
                *(rand(4, FUSED_MAX_SEQ, 4, hd, dtype=torch.float32) for _ in range(4))), BWD_TOL["float32"])
    print(f"phase 5 kernel K2 main fp32: max_abs_err {err32:.3e} (tol {BWD_TOL['float32']} * (max|ref| + |ref|)); "
          f"kernel_ms {ms32:.4f}")

    for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        tol = BWD_TOL[name]
        with torch.no_grad():
            # ragged key mask
            q, k, v, do = (rand(4, 256, 4, 64, dtype=dtype) for _ in range(4))
            lengths = torch.tensor([256, 200, 77, 1], device="cuda")
            mask = torch.arange(256, device="cuda")[None, :] < lengths[:, None]
            e_mask = check_grads(f"mask {name}", *both(q, k, v, do, mask), tol)
            # cross-attention 256 queries / 128 keys
            q, do = rand(2, 256, 4, 64, dtype=dtype), rand(2, 256, 4, 64, dtype=dtype)
            k, v = rand(2, 128, 4, 64, dtype=dtype), rand(2, 128, 4, 64, dtype=dtype)
            e_cross = check_grads(f"cross {name}", *both(q, k, v, do), tol)
            # head dims of the other instances
            e_dims = max(check_grads(f"D={hd} {name}", *both(*(rand(2, 128, 2, hd, dtype=dtype) for _ in range(4))), tol)
                         for hd in (16, 32, 128))
            # a fully-masked row: its gradients exactly 0
            q, k, v, do = (rand(2, 128, 2, 64, dtype=dtype) for _ in range(4))
            mask = torch.stack([torch.zeros(128, dtype=torch.bool, device="cuda"),
                                torch.ones(128, dtype=torch.bool, device="cuda")])
            ours, ref = both(q, k, v, do, mask)
            if not all(bool((g[0] == 0).all()) for g in ours):
                fail(f"fully-masked row {name}: gradients not exactly 0")
            e_full = check_grads(f"fully-masked other row {name}", [g[1] for g in ours], [g[1] for g in ref], tol)
            # the Hopper K2's edges: key counts of one tile (64, 128), of tiles that K and V stay resident in
            # for both passes (320: 192 + 128 at D = 64), and of tiles streamed through the ring twice (640, 768)
            e_skv = {}
            for skv in (64, 128, 320, 640, 768):
                q, do = rand(2, 192, 4, 64, dtype=dtype), rand(2, 192, 4, 64, dtype=dtype)
                k, v = rand(2, skv, 4, 64, dtype=dtype), rand(2, skv, 4, 64, dtype=dtype)
                kmask = torch.arange(skv, device="cuda")[None, :] < torch.tensor([[skv], [skv // 2 + 1]], device="cuda")
                e_skv[skv] = check_grads(f"Skv={skv} {name}", *both(q, k, v, do, kmask), tol)
            # a 64-key masked block in the middle: its keys get exactly zero dk and dv
            q, k, v, do = (rand(2, 256, 4, 64, dtype=dtype) for _ in range(4))
            hmask = torch.ones(2, 256, dtype=torch.bool, device="cuda")
            hmask[:, 64:128] = False
            ours, ref = both(q, k, v, do, hmask)
            if not all(bool((g[:, 64:128] == 0).all()) for g in ours[1:]):
                fail(f"K2 64-key masked block {name}: dk or dv of a masked key not exactly 0")
            e_hole = check_grads(f"64-key masked block {name}", ours, ref, tol)
            # D = 128 past one tile, with a mask (resident at 256 keys, streamed at 320)
            e_d128 = max(check_grads(f"D=128 Skv={skv} {name}", *both(
                rand(2, 128, 2, 128, dtype=dtype), rand(2, skv, 2, 128, dtype=dtype), rand(2, skv, 2, 128, dtype=dtype),
                rand(2, 128, 2, 128, dtype=dtype),
                torch.arange(skv, device="cuda")[None, :] < torch.tensor([[skv], [70]], device="cuda")), tol)
                for skv in (256, 320))
            # q/k/v as strided views of one packed qkv projection output, at 384 tokens
            qkv = rand(2, 384, 3 * 4 * 64, dtype=dtype)
            q, k, v = (t.reshape(2, 384, 4, 64) for t in qkv.chunk(3, dim=-1))
            e_packed = check_grads(f"packed views {name}", *both(q, k, v, rand(2, 384, 4, 64, dtype=dtype)), tol)
        # unaligned 100 / 300 with grad through the padding entry point
        qs, ks, vs = rand(2, 100, 4, 64, dtype=dtype), rand(2, 300, 4, 64, dtype=dtype), rand(2, 300, 4, 64, dtype=dtype)
        do = rand(2, 100, 4, 64, dtype=dtype)
        grads = []
        for impl in ("auto", "xla"):
            leaves = [t.clone().requires_grad_() for t in (qs, ks, vs)]
            out = dot_product_attention(*leaves, impl=impl)
            grads.append(torch.autograd.grad(out, leaves, do))
        e_unal = check_grads(f"unaligned {name}", *grads, GRAD_PATH_TOL[name])
        print(f"phase 5 kernel K2 edge cases {name} (tol {tol} * (max|ref| + |ref|)): max_abs_err "
              f"mask {e_mask:.3e} cross_256_128 {e_cross:.3e} D16/32/128 {e_dims:.3e} fully_masked_row "
              f"grads==0 other_row {e_full:.3e} "
              + " ".join(f"skv_{skv} {e:.3e}" for skv, e in e_skv.items())
              + f" masked_block_64 {e_hole:.3e} (dk, dv == 0 there) D128_256/320 {e_d128:.3e} packed_views_384 "
              f"{e_packed:.3e}; unaligned_100_300 autograd vs plain-forward autograd "
              f"{e_unal:.3e} (tol {GRAD_PATH_TOL[name]})")
    torch.cuda.synchronize()
    print(f"phase 5 fp32 errors as a fraction of the tolerance (above 1 fails): {fp32_fractions(mark)}")
    return result


def build_txt2img(attention_dtype=None):
    """The txt2img MMDiT with seeded random weights (and a twin with the plain
    attention, ``attention_impl="xla"``), its Flux2 tower, and a seeded
    request ``cond`` of TXT_BATCH prompts, all on the card. ``attention_dtype``:
    the dual-stream blocks' attention dtype (the reference's fp32-attention
    option), the same seeded weights."""
    import torch

    from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT

    embedder, tower, cond = txt2img_context()
    model = MMDiT(**TXT, context_embedder=embedder, dtype=torch.bfloat16, attention_dtype=attention_dtype)  # the card
    randomize_(model, seed=10)
    plain = MMDiT(**TXT, context_embedder=embedder, dtype=torch.bfloat16, attention_dtype=attention_dtype,
                  attention_impl="xla")
    plain.load_state_dict(model.state_dict(), strict=True)
    return model.eval(), plain.eval(), tower, cond


def txt2img_context():
    """The txt2img paths' PrecomputedEmbedder (a seeded [128, 2048] null
    embedding), their Flux2 tower with seeded weights, and a seeded request
    ``cond`` of TXT_BATCH prompts with the TEXT_LENGTHS mask, on the card."""
    import numpy as np
    import torch

    from diffulab_tpu_torch.networks.embedders import PrecomputedEmbedder
    from diffulab_tpu_torch.networks.vision_towers import Flux2VAE

    rng = np.random.default_rng(9)
    null = rng.standard_normal((TEXT_LEN, TEXT_DIM)).astype(np.float32)
    embedder = PrecomputedEmbedder(null_embedding=null, null_embedding_seq_len=NULL_SEQ_LEN)
    tower = Flux2VAE(latent_channels=TXT_LATENT[2] // 4)
    randomize_(tower, seed=11)
    gen = torch.Generator(device="cuda").manual_seed(12)
    emb = torch.randn(TXT_BATCH, TEXT_LEN, TEXT_DIM, generator=gen, device="cuda")
    lengths = torch.tensor(TEXT_LENGTHS, device="cuda")
    mask = torch.arange(TEXT_LEN, device="cuda")[None, :] < lengths[:, None]
    return embedder, tower.eval(), {"context": {"embeddings": emb, "attn_mask": mask}}


def launch_counts() -> dict[str, int]:
    from diffulab_tpu_torch.ops.flash_attention import LAUNCHES as FLASH
    from diffulab_tpu_torch.ops.fused_mha import LAUNCHES as FUSED

    return {**FUSED, **FLASH}


def launch_keys() -> dict[tuple[str, str, int], int]:
    """The launches by (kernel, dtype, Skv): the padded key length each took."""
    from diffulab_tpu_torch.ops.flash_attention import LAUNCHES_BY_KEYS as FLASH
    from diffulab_tpu_torch.ops.fused_mha import LAUNCHES_BY_KEYS as FUSED

    return {**FUSED, **FLASH}


def key_diff(after: dict, before: dict) -> dict:
    """The launches by (kernel, dtype, Skv) between two :func:`launch_keys` readings, zeros left out."""
    return {key: n - before.get(key, 0) for key, n in after.items() if n != before.get(key, 0)}


def reset_launch_counts() -> None:
    from diffulab_tpu_torch.ops.flash_attention import LAUNCHES as FLASH
    from diffulab_tpu_torch.ops.flash_attention import LAUNCHES_BY_KEYS as FLASH_KEYS
    from diffulab_tpu_torch.ops.fused_mha import LAUNCHES as FUSED
    from diffulab_tpu_torch.ops.fused_mha import LAUNCHES_BY_KEYS as FUSED_KEYS

    for counts in (FUSED, FLASH):
        for key in counts:
            counts[key] = 0
    FUSED_KEYS.clear()
    FLASH_KEYS.clear()


def phase_txt2img_forward(model, plain, cond):
    """One forward of the txt2img MMDiT at the slice shape (fused-CFG batch),
    kernel path against plain attention."""
    import torch

    from diffulab_tpu_torch.diffuse.flow import _tree_cat2

    gen = torch.Generator(device="cuda").manual_seed(13)
    b = 2 * TXT_BATCH
    x = torch.randn(b, *TXT_LATENT, generator=gen, device="cuda")
    t = torch.rand(b, generator=gen, device="cuda")
    cond2 = _tree_cat2(cond)
    drop = torch.arange(b, device="cuda") >= TXT_BATCH
    with torch.no_grad():
        reset_launch_counts()
        out = model(x, t, cond2, drop)["x"]
        launches = launch_counts()
        ref = plain(x, t, cond2, drop)["x"]
    torch.cuda.synchronize()
    if out.shape != (b, *TXT_LATENT) or not bool(torch.isfinite(out).all()):
        fail("txt2img forward: bad shape or non-finite output")
    rel = float((out.float() - ref.float()).abs().max() / ref.float().abs().max())
    depth = TXT["depth"]
    if rel > TXT_REL_TOL or launches["flash_attn_fwd"] != depth or launches["fused_mha_fwd"] != 0:
        fail(f"txt2img forward: rel err {rel:.3e} (tol {TXT_REL_TOL}), launches {launches}")
    print(f"phase 9 txt2img MMDiT forward B={b} S={TXT_SEQ} mixed bf16: kernel path vs plain attention max rel "
          f"err {rel:.3e} (tol {TXT_REL_TOL}); {launches['flash_attn_fwd']} K3 launches, "
          f"{launches['fused_mha_fwd']} K1; output max |x| {float(ref.abs().max()):.3f}")


def txt2img_request(diffuser, cond, seed: int, **kwargs):
    """One txt2img ``generate`` request: TXT_BATCH prompts, Euler with fused
    CFG, clamped decoded pixels (or latents with ``return_latents``)."""
    import torch

    noise = torch.Generator(device="cuda").manual_seed(seed)
    return diffuser.generate(cond, data_shape=(TXT_BATCH, *TXT_LATENT), generator=noise, guidance_scale=CFG,
                             clamp_x=True, **kwargs)["x"]


def phase_txt2img_generate(model, plain, tower, cond):
    """TXT_REQUESTS ``generate`` requests with the Flux2 decode, the launch
    counts set to 0 just before each and read just after; then a short
    trajectory of the kernel path against the plain path from the same noise."""
    import torch

    from diffulab_tpu_torch.diffuse import Diffuser

    diffuser = Diffuser(model, "euler", n_steps=STEPS, vision_tower=tower, extra_args=TXT_EXTRA)
    per_request = STEPS * TXT["depth"]
    image_shape = (TXT_BATCH, TXT_LATENT[0] * tower.compression_factor, TXT_LATENT[1] * tower.compression_factor, 3)
    times, total = [], {"flash_attn_fwd": 0, "fused_mha_fwd": 0, "flash_attn_fwd_f32": 0}
    torch.cuda.reset_peak_memory_stats()
    for r in range(TXT_REQUESTS):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        images = txt2img_request(diffuser, cond, seed=200 + r)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launched = launch_counts()
        if launched["flash_attn_fwd"] != per_request or launched["fused_mha_fwd"] != 0:
            fail(f"txt2img request {r}: launches {launched}, expected {per_request} K3 and 0 K1")
        for key in total:
            total[key] += launched[key]
        if images.shape != image_shape or not bool(torch.isfinite(images).all()):
            fail(f"txt2img request {r}: images {tuple(images.shape)}, expected {image_shape}, all finite")
        if float(images.abs().max()) > 1.0:
            fail(f"txt2img request {r}: decoded pixels outside [-1, 1]")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # a short trajectory, kernel path against plain attention, from the same noise
    short = [Diffuser(m, "euler", n_steps=TRAJ_STEPS, vision_tower=tower, extra_args=TXT_EXTRA) for m in (model, plain)]
    ours, ref = (txt2img_request(d, cond, seed=300, return_latents=True) for d in short)
    rel = float((ours.float() - ref.float()).abs().max() / ref.float().abs().max())
    if rel > TXT_REL_TOL:
        fail(f"txt2img {TRAJ_STEPS}-step trajectory against plain attention: rel err {rel:.3e} (tol {TXT_REL_TOL})")
    ms = [t * 1e3 for t in times]
    print(f"phase 10 txt2img generate x{TXT_REQUESTS}: {TXT_BATCH} prompts, latents {TXT_LATENT} ({TXT_SEQ} tokens), "
          f"Euler-{STEPS} shift {TXT_EXTRA['shift']} CFG {CFG}, Flux2 decode to {image_shape[1:]}: ms/request "
          f"{[round(m, 2) for m in ms]}, imgs/s {[round(TXT_BATCH / t, 3) for t in times]}; K3 launches "
          f"{per_request}/request, K1 0 ({total['flash_attn_fwd']} K3, {total['fused_mha_fwd']} K1 in all); peak mem {peak_gib:.2f} GiB; images finite, in [-1, 1]; "
          f"{TRAJ_STEPS}-step latents vs plain attention max rel err {rel:.3e} (tol {TXT_REL_TOL})")
    return total, ms


def phase_gradients(model, plain):
    """One compute_loss at the training batch through the kernel path (K1 and
    K2) against the same weights through the plain attention."""
    import torch

    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.networks.nn import make_drop_mask
    from diffulab_tpu_torch.ops.fused_mha import LAUNCHES

    gen = torch.Generator(device="cuda").manual_seed(6)
    b = TRAIN_BATCH
    x0 = torch.randn(b, *LATENT, generator=gen, device="cuda").bfloat16()
    y = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    diffusers = [Diffuser(m, "euler", extra_args={"logits_normal": True}) for m in (model, plain)]
    t = diffusers[0].draw_timesteps(gen, b)
    noise = torch.randn(x0.shape, generator=gen, device="cuda", dtype=x0.dtype)
    drop = make_drop_mask(gen, P_CFG, b)
    grads, losses = [], []
    for diffuser in diffusers:
        diffuser.denoiser.zero_grad(set_to_none=True)
        before = dict(LAUNCHES)
        loss = diffuser.compute_loss(x0, {"y": y}, t, noise, drop=drop)["loss"]
        loss.backward()
        torch.cuda.synchronize()
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        grads.append({n: p.grad for n, p in diffuser.denoiser.named_parameters()})
        losses.append(float(loss.detach()))
        if diffuser.denoiser is model and launched != {"fused_mha_fwd": DIT_B2["depth"], "fused_mha_bwd": DIT_B2["depth"],
                                                        **dict.fromkeys(BF16_COUNTERS, DIT_B2["depth"]),
                                                        **dict.fromkeys(F32_ONLY_COUNTERS, 0)}:
            fail(f"DiT-B/2 gradients: kernel path launched {launched}, expected {DIT_B2['depth']} of each")
    worst, worst_name = 0.0, None
    for name, g in grads[0].items():
        r = grads[1][name]
        if g is None or r is None or not bool(torch.isfinite(g).all()):
            fail(f"DiT-B/2 gradients: {name} missing or non-finite")
        rel = float((g.float() - r.float()).norm() / r.float().norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    if worst > DIT_GRAD_TOL or not math.isfinite(losses[0]):
        fail(f"DiT-B/2 gradients: worst relative error {worst:.3e} at {worst_name} (tol {DIT_GRAD_TOL}), "
             f"loss {losses[0]}")
    for m in (model, plain):
        m.zero_grad(set_to_none=True)
    print(f"phase 6 DiT-B/2 gradients B={b} bf16: loss kernel path {losses[0]:.6f} plain {losses[1]:.6f}; "
          f"{len(grads[0])} parameter gradients, worst ||kernel - plain|| / ||plain|| {worst:.3e} at {worst_name} "
          f"(tol {DIT_GRAD_TOL}); {DIT_B2['depth']} K1 + {DIT_B2['depth']} K2 launches")


class TimedLoader:
    """An in-memory loader that waits for the card and stamps the time and
    the kernels' launch counts each time the trainer asks for a batch, and
    once after the last: the differences are the steps."""

    def __init__(self, batches):
        self.batches = batches
        self.marks: list[tuple[float, dict[str, int]]] = []
        self.key_marks: list[dict] = []  # launch_keys() at each mark

    def __len__(self) -> int:
        return len(self.batches)

    def _mark(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.marks.append((time.perf_counter(), launch_counts()))
        self.key_marks.append(launch_keys())

    def __iter__(self):
        for batch in self.batches:
            self._mark()
            yield batch
        self._mark()


def phase_train(model):
    """BaseTrainer.train, one epoch of TRAIN_STEPS batches plus validation on
    the EMA weights and the best-val checkpoint."""
    import torch

    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.training.optim import adamw
    from diffulab_tpu_torch.training.trainer import BaseTrainer

    # the tracker takes its JSONL path: wandb, where it is installed, is neither
    # imported nor contacted
    sys.modules["wandb"] = None
    gen = torch.Generator(device="cuda").manual_seed(7)

    def batch():
        return {"model_inputs": {"x": torch.randn(TRAIN_BATCH, *LATENT, generator=gen, device="cuda").bfloat16(),
                                 "y": torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device="cuda")}}

    loader = TimedLoader([batch() for _ in range(TRAIN_STEPS)])
    val = [batch()]
    diffuser = Diffuser(model, "euler", n_steps=STEPS, extra_args={"logits_normal": True})
    depth = DIT_B2["depth"]
    with tempfile.TemporaryDirectory() as tmp:
        trainer = BaseTrainer(n_epoch=1, save_path=tmp, project_name="chip_smoke", use_ema=True)  # the card
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        trainer.train(diffuser, adamw(lr=1e-4, weight_decay=1e-4), loader, val,
                      p_classifier_free_guidance=P_CFG, log_validation_images=False, seed=0)
        launches = launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        run = Path(tmp) / "chip_smoke"
        rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        losses = [r["train/loss"] for r in rows if "train/loss" in r]
        val_losses = [r["val/loss"] for r in rows if "val/loss" in r]
        for part in ("denoiser", "optimizer", "ema", "scheduler"):
            if not (run / "checkpoints" / part / "state.pt").is_file():
                fail(f"train: no best-val checkpoint entry {part}")
        check_restores(run, model, "train")
    if trainer.step != TRAIN_STEPS or len(losses) != 1 or not math.isfinite(losses[0]) \
            or not all(math.isfinite(v) for v in val_losses):
        fail(f"train: step counter {trainer.step}, train losses {losses}, val losses {val_losses}")
    times, per_step = [], []
    for (t0, c0), (t1, c1) in zip(loader.marks[:-1], loader.marks[1:]):
        times.append((t1 - t0) * 1e3)
        per_step.append((c1["fused_mha_fwd"] - c0["fused_mha_fwd"], c1["fused_mha_bwd"] - c0["fused_mha_bwd"]))
    if per_step != [(depth, depth)] * TRAIN_STEPS:
        fail(f"train: kernel launches per step (K1, K2) {per_step}, expected ({depth}, {depth}) each")
    steady = statistics.median(times[2:])
    print(f"phase 7 BaseTrainer.train DiT-B/2 bf16 batch {TRAIN_BATCH} AdamW(lr 1e-4, wd 1e-4) EMA p_cfg {P_CFG}: "
          f"{TRAIN_STEPS} steps, ms/step {[round(m, 2) for m in times]} (median after the first two "
          f"{steady:.2f}), samples/s {TRAIN_BATCH / steady * 1e3:.1f}; train loss {losses[0]:.5f}, val loss "
          f"(EMA) {val_losses[0]:.5f}; launches per step {depth} K1 + {depth} K2, in the run {launches} "
          f"(K1 includes the validation forward); peak mem {peak_gib:.2f} GiB; best-val checkpoint written "
          f"and restored")
    return launches, times


def check_restores(run: Path, model, label: str) -> None:
    """The run's best-val denoiser entry (trainable params and the rest of the
    state) holds exactly the model's trained state."""
    import torch

    from diffulab_tpu_torch.training.checkpoint import restore_checkpoint

    entry = restore_checkpoint(run / "checkpoints" / "denoiser")
    saved = {**entry["params"], **entry["rest"]}
    live = model.state_dict()
    if set(saved) != set(live) or not all(torch.equal(saved[k], live[k].cpu()) for k in live):
        fail(f"{label}: the best-val denoiser checkpoint does not restore to the trained weights")


def phase_txt2img_gradients(model, plain):
    """One compute_loss of the txt2img MMDiT at 4224 tokens through the kernel
    path (K3, K4, K5) against the same weights through the plain attention,
    with injected t, noise and CFG drop and a ragged text mask."""
    import torch

    from diffulab_tpu_torch.diffuse import Diffuser

    gen = torch.Generator(device="cuda").manual_seed(14)
    b = TXT_GRAD_BATCH
    x0 = torch.randn(b, *TXT_LATENT, generator=gen, device="cuda")
    emb = torch.randn(b, TEXT_LEN, TEXT_DIM, generator=gen, device="cuda")
    mask = torch.arange(TEXT_LEN, device="cuda")[None, :] < torch.tensor([77, 9], device="cuda")[:, None]
    cond = {"context": {"embeddings": emb, "attn_mask": mask}}
    diffusers = [Diffuser(m, "euler", extra_args=TXT_EXTRA) for m in (model, plain)]
    t = diffusers[0].draw_timesteps(gen, b)
    noise = torch.randn(x0.shape, generator=gen, device="cuda")
    drop = torch.tensor([False, True], device="cuda")  # the second row takes the null embedding
    # the plain path recomputes each block in the backward (use_checkpoint), so
    # that one block's fp32 score matrices are held at a time
    plain.use_checkpoint = True
    grads, losses, launched = [], [], []
    for diffuser in diffusers:
        diffuser.denoiser.zero_grad(set_to_none=True)
        reset_launch_counts()
        loss = diffuser.compute_loss(x0, cond, t, noise, drop=drop)["loss"]
        loss.backward()
        torch.cuda.synchronize()
        launched.append(launch_counts())
        grads.append({n: p.grad for n, p in diffuser.denoiser.named_parameters()})
        losses.append(float(loss.detach()))
    plain.use_checkpoint = False
    depth = TXT["depth"]
    expected = {"fused_mha_fwd": 0, "fused_mha_bwd": 0, "flash_attn_fwd": depth, "flash_attn_bwd_dkv": depth,
                "flash_attn_bwd_dq": depth, "flash_attn_fwd_f32": 0, "flash_attn_bwd_dkv_f32": 0,
                "flash_attn_bwd_dq_f32": 0, **dict.fromkeys((*BF16_COUNTERS, *F32_ONLY_COUNTERS), 0)}
    if launched[0] != expected or any(launched[1].values()):
        fail(f"txt2img gradients: launches kernel path {launched[0]}, expected {expected}; plain path {launched[1]}")
    worst, worst_name = 0.0, None
    for name, g in grads[0].items():
        r = grads[1][name]
        if g is None or r is None or not bool(torch.isfinite(g).all()):
            fail(f"txt2img gradients: {name} missing or non-finite")
        rel = float((g.float() - r.float()).norm() / r.float().norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    if worst > TXT_GRAD_TOL or not math.isfinite(losses[0]):
        fail(f"txt2img gradients: worst relative error {worst:.3e} at {worst_name} (tol {TXT_GRAD_TOL}), "
             f"loss {losses[0]}")
    for m in (model, plain):
        m.zero_grad(set_to_none=True)
    print(f"phase 12 txt2img MMDiT gradients B={b} (cut from 8: the plain path's fp32 score matrices) S={TXT_SEQ} "
          f"mixed bf16, text lengths [77, 9], row 1 dropped: loss kernel path {losses[0]:.6f} plain {losses[1]:.6f}; "
          f"{len(grads[0])} parameter gradients, worst ||kernel - plain|| / ||plain|| {worst:.3e} at {worst_name} "
          f"(tol {TXT_GRAD_TOL}); launches {depth} K3 + {depth} K4 + {depth} K5, 0 K1/K2")


def write_txt2img_shards(root: Path) -> tuple[Path, Path]:
    """Seeded train and val shards in the reference's format, written by the
    port's ShardedDatasetWriter: per sample vision_latents [H, W, 128] of
    TXT_BUCKETS' sizes, caption_embeddings [128, 2048], a ragged caption_mask
    and the caption string."""
    import numpy as np

    from diffulab_tpu_torch.data.streaming import ShardedDatasetWriter

    rng = np.random.default_rng(15)

    def sample(hw, i):
        length = int(rng.integers(1, TEXT_LEN + 1))
        return {"vision_latents": rng.standard_normal((*hw, TXT_LATENT[2]), dtype=np.float32),
                "caption_embeddings": rng.standard_normal((TEXT_LEN, TEXT_DIM), dtype=np.float32),
                "caption_mask": np.arange(TEXT_LEN) < length,
                "caption": f"caption {i} of {hw[0]}x{hw[1]} latents, {length} tokens"}

    train, val = root / "train", root / "val"
    with ShardedDatasetWriter(train, shard_size=32) as writer:
        i = 0
        for hw, n_batches in TXT_BUCKETS.items():
            for _ in range(n_batches * TXT_TRAIN_BATCH):
                writer.write(sample(hw, i))
                i += 1
    with ShardedDatasetWriter(val, shard_size=32) as writer:
        for j in range(TXT_TRAIN_BATCH):
            writer.write(sample(TXT_LATENT[:2], i + j))
    return train, val


def txt2img_train_run(model, tower, project: str, label: str) -> dict[str, Any]:
    """BaseTrainer.train on a txt2img model at batch 8 over both buckets of
    seeded shards (:func:`write_txt2img_shards`), AdamW, EMA, validation loss
    on the EMA weights, validation images decoded by the Flux2 tower, and the
    best-val checkpoint, written and restored; the launch counts set to 0
    just before. Checks the step counter, the losses and the validation
    images; returns the loader (its marks time each step), the run's
    launches, losses, peak memory and data set-up seconds."""
    import torch

    from diffulab_tpu_torch.data.imagenet import ImageNetmultiAR, MultiARBatchSampler, collate_fn
    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.training.optim import adamw
    from diffulab_tpu_torch.training.trainer import BaseTrainer

    sys.modules["wandb"] = None  # metrics go to metrics.jsonl; wandb is neither imported nor contacted
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train_dir, val_dir = write_txt2img_shards(Path(tmp) / "data")
        datasets = [ImageNetmultiAR(str(d), cache_dir=Path(tmp) / "cache") for d in (train_dir, val_dir)]
        for ds in datasets:
            ds.set_latent_scale(1.0)
        train_ds, val_ds = datasets
        loader = TimedLoader([collate_fn([train_ds[i] for i in idx])
                              for idx in MultiARBatchSampler(train_ds, TXT_TRAIN_BATCH, seed=0)])
        val = [collate_fn([val_ds[i] for i in idx])
               for idx in MultiARBatchSampler(val_ds, TXT_TRAIN_BATCH, shuffle=False)]
        data_s = time.perf_counter() - t0
        diffuser = Diffuser(model, "euler", n_steps=STEPS, vision_tower=tower, extra_args=TXT_EXTRA)
        trainer = BaseTrainer(n_epoch=1, save_path=tmp, project_name=project, use_ema=True)  # the card
        logged = []
        log_images = trainer.tracker.log_images

        def record(images, step, key="val/images", captions=None):
            logged.append((images.shape, captions, bool(((images >= 0) & (images <= 1)).all())))
            log_images(images, step, key=key, captions=captions)

        trainer.tracker.log_images = record
        model.train()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        trainer.train(diffuser, adamw(**TXT_ADAMW), loader, val, p_classifier_free_guidance=P_CFG,
                      val_steps=TXT_VAL_STEPS, val_step_shift=TXT_VAL_SHIFT, seed=0)
        launches = launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        run = Path(tmp) / project
        rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        losses = [r["train/loss"] for r in rows if "train/loss" in r]
        val_losses = [r["val/loss"] for r in rows if "val/loss" in r]
        for part in ("denoiser", "optimizer", "ema", "scheduler"):
            if not (run / "checkpoints" / part / "state.pt").is_file():
                fail(f"{label}: no best-val checkpoint entry {part}")
        check_restores(run, model, label)
    model.eval()
    n_steps = len(loader)
    if trainer.step != n_steps or len(losses) != 1 or not math.isfinite(losses[0]) \
            or not all(math.isfinite(v) for v in val_losses):
        fail(f"{label}: step counter {trainer.step}, train losses {losses}, val losses {val_losses}")
    image_shape = (TXT_TRAIN_BATCH, TXT_LATENT[0] * tower.compression_factor,
                   TXT_LATENT[1] * tower.compression_factor, 3)
    if len(logged) != 1 or logged[0][0] != image_shape or not logged[0][2] or logged[0][1] is None \
            or len(logged[0][1]) != TXT_TRAIN_BATCH:
        fail(f"{label}: validation images {logged}, expected {image_shape} in [0, 1] with captions")
    return dict(loader=loader, launches=launches, peak_gib=peak_gib, losses=losses, val_losses=val_losses,
                n_steps=n_steps, image_shape=image_shape, captions=len(logged[0][1]), data_s=data_s)


def phase_txt2img_train(model, tower):
    """BaseTrainer.train on the txt2img MMDiT at batch 8 over both buckets,
    AdamW, EMA, validation loss on the EMA weights, validation images decoded
    by the Flux2 tower, and the best-val checkpoint."""
    depth = TXT["depth"]
    tr = txt2img_train_run(model, tower, "chip_smoke_txt2img", "txt2img train")
    loader, launches = tr["loader"], tr["launches"]
    expected = {"fused_mha_fwd": 0, "fused_mha_bwd": 0, "flash_attn_fwd": depth, "flash_attn_bwd_dkv": depth,
                "flash_attn_bwd_dq": depth, "flash_attn_fwd_f32": 0, "flash_attn_bwd_dkv_f32": 0,
                "flash_attn_bwd_dq_f32": 0, **dict.fromkeys((*BF16_COUNTERS, *F32_ONLY_COUNTERS), 0)}
    per_bucket: dict[tuple[int, int], list[float]] = {}
    for batch, (t0, c0), (t1, c1) in zip(loader.batches, loader.marks[:-1], loader.marks[1:]):
        step = {key: c1[key] - c0[key] for key in c1}
        if step != expected:
            fail(f"txt2img train: kernel launches in a step {step}, expected {expected}")
        per_bucket.setdefault(tuple(batch["model_inputs"]["x"].shape[1:3]), []).append((t1 - t0) * 1e3)
    steady = statistics.median([m for times in per_bucket.values() for m in times[2:]])
    print(f"phase 13 BaseTrainer.train txt2img MMDiT mixed bf16 batch {TXT_TRAIN_BATCH} AdamW(lr 1e-4, wd 0.01, "
          f"betas 0.9/0.999, eps 1e-8) EMA p_cfg {P_CFG}, shift {TXT_EXTRA['shift']}: {tr['n_steps']} steps over buckets "
          + ", ".join(f"{h}x{w}x{TXT_LATENT[2]} ({TEXT_LEN + h * w} tokens) ms/step {[round(m, 2) for m in times]}"
                      for (h, w), times in per_bucket.items())
          + f"; median after the first two of each bucket {steady:.2f} ms, samples/s "
          f"{TXT_TRAIN_BATCH / steady * 1e3:.2f}; train loss {tr['losses'][0]:.5f}, val loss (EMA) "
          f"{tr['val_losses'][0]:.5f}; "
          f"launches per step {depth} K3 + {depth} K4 + {depth} K5, 0 K1/K2, in the run {launches} (K3 includes "
          f"validation); validation images {tr['image_shape'][1:]} with {tr['captions']} captions ({TXT_VAL_STEPS} "
          f"steps, shift {TXT_VAL_SHIFT}); peak mem {tr['peak_gib']:.2f} GiB; data set-up {tr['data_s']:.1f} s; "
          f"best-val checkpoint written and restored")
    return launches, steady


def phase_txt2img_fp32_attention():
    """Phase 13b: the txt2img MMDiT of phases 9-13 (build_txt2img's seeded
    weights) with fp32 attention in its dual-stream blocks
    (``attention_dtype=float32``, the reference's stability option): one
    forward at the request's fused-CFG batch against its plain twin, one
    Euler request of TXT_BATCH prompts at TXT32_STEPS steps with the Flux2
    decode, and TXT32_TRAIN_STEPS train steps (``train_step``: loss, backward,
    AdamW) at TXT_TRAIN_BATCH, each with the launch counts set to 0 just
    before and read just after."""
    import torch

    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.diffuse.flow import _tree_cat2
    from diffulab_tpu_torch.training.optim import adamw
    from diffulab_tpu_torch.training.trainer import MultiStepOptimizer, train_step

    model, plain, tower, cond = build_txt2img(attention_dtype=torch.float32)
    dual = TXT["depth"] - TXT["n_single_stream_blocks"]
    single = TXT["n_single_stream_blocks"]
    windows: dict[str, dict[str, int]] = {}

    def counted(name, fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        windows[name] = launch_counts()
        return out, (time.perf_counter() - t0) * 1e3

    def expect(name, f32, bf16, backward):
        """f32 and bf16 K3 launches, and as many K4 and K5 of each when ``backward``"""
        got, bwd_f32, bwd_all = windows[name], f32 * backward, (f32 + bf16) * backward
        want = {"flash_attn_fwd": f32 + bf16, "flash_attn_fwd_f32": f32,
                "flash_attn_bwd_dkv": bwd_all, "flash_attn_bwd_dkv_f32": bwd_f32,
                "flash_attn_bwd_dq": bwd_all, "flash_attn_bwd_dq_f32": bwd_f32, "fused_mha_fwd": 0, "fused_mha_bwd": 0}
        if any(got[key] != n for key, n in want.items()):
            fail(f"txt2img fp32 attention {name}: launches {got}, expected {want}")

    gen = torch.Generator(device="cuda").manual_seed(16)
    b = 2 * TXT_BATCH
    x = torch.randn(b, *TXT_LATENT, generator=gen, device="cuda")
    t = torch.rand(b, generator=gen, device="cuda")
    cond2 = _tree_cat2(cond)
    drop = torch.arange(b, device="cuda") >= TXT_BATCH
    with torch.no_grad():
        out, _ = counted("forward", lambda: model(x, t, cond2, drop)["x"])
        ref = plain(x, t, cond2, drop)["x"]
    del plain
    torch.cuda.empty_cache()
    expect("forward", dual, single, False)
    if out.shape != (b, *TXT_LATENT) or not bool(torch.isfinite(out).all()):
        fail("txt2img fp32 attention forward: bad shape or non-finite output")
    rel = float((out.float() - ref.float()).abs().max() / ref.float().abs().max())
    if rel > TXT_REL_TOL:
        fail(f"txt2img fp32 attention forward: rel err {rel:.3e} (tol {TXT_REL_TOL})")
    del out, ref

    diffuser = Diffuser(model, "euler", n_steps=TXT32_STEPS, vision_tower=tower, extra_args=TXT_EXTRA)
    images, request_ms = counted("generate", lambda: txt2img_request(diffuser, cond, seed=400))
    expect("generate", TXT32_STEPS * dual, TXT32_STEPS * single, False)
    image_shape = (TXT_BATCH, TXT_LATENT[0] * tower.compression_factor, TXT_LATENT[1] * tower.compression_factor, 3)
    if images.shape != image_shape or not bool(torch.isfinite(images).all()) or float(images.abs().max()) > 1.0:
        fail(f"txt2img fp32 attention request: images {tuple(images.shape)}, expected {image_shape}, finite, "
             "in [-1, 1]")
    del images, tower
    torch.cuda.empty_cache()

    # train steps at the training batch: the batch's text lengths, the dropped rows on the null embedding
    x0 = torch.randn(TXT_TRAIN_BATCH, *TXT_LATENT, generator=gen, device="cuda")
    emb = torch.randn(TXT_TRAIN_BATCH, TEXT_LEN, TEXT_DIM, generator=gen, device="cuda")
    lengths = torch.tensor(TRAIN_TEXT_LENGTHS, device="cuda")
    text_mask = torch.arange(TEXT_LEN, device="cuda")[None, :] < lengths[:, None]
    batch = {"model_inputs": {"x": x0, "context": {"embeddings": emb, "attn_mask": text_mask}}}
    drop = torch.zeros(TXT_TRAIN_BATCH, dtype=torch.bool, device="cuda")
    drop[list(TRAIN_DROPPED)] = True
    model.train()
    optimizer = MultiStepOptimizer(adamw(**TXT_ADAMW)(model.parameters()))
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for step in range(TXT32_TRAIN_STEPS):
        tt = diffuser.draw_timesteps(gen, TXT_TRAIN_BATCH)
        noise = torch.randn(x0.shape, generator=gen, device="cuda")
        loss, ms = counted(f"train_step_{step}", lambda: train_step(diffuser, optimizer, None, batch, tt, noise, drop,
                                                                   step)["loss"])
        expect(f"train_step_{step}", dual, single, True)
        losses.append(float(loss))
        step_ms.append(ms)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    model.eval()
    if not all(math.isfinite(v) for v in losses):
        fail(f"txt2img fp32 attention train: losses {losses}")
    print(f"phase 13b txt2img MMDiT, bf16 with fp32 attention in its {dual} dual-stream blocks: forward B={b} "
          f"S={TXT_SEQ} kernel path vs plain attention max rel err {rel:.3e} (tol {TXT_REL_TOL}), {dual} fp32 K3 + "
          f"{single} bf16 K3; Euler-{TXT32_STEPS} request of {TXT_BATCH} prompts with the Flux2 decode "
          f"{request_ms:.2f} ms, {TXT32_STEPS * dual} fp32 K3 + {TXT32_STEPS * single} bf16 K3, images finite, in "
          f"[-1, 1]; {TXT32_TRAIN_STEPS} train steps at batch {TXT_TRAIN_BATCH} (AdamW, the training text mask): "
          f"ms/step {[round(m, 2) for m in step_ms]}, losses {[round(v, 5) for v in losses]}; a step {dual} fp32 K3 + "
          f"{dual} fp32 K4 + {dual} fp32 K5, {single} bf16 K3 + {single} K4 + {single} K5, 0 K1/K2; peak mem "
          f"{peak_gib:.2f} GiB")
    del model, diffuser, optimizer
    torch.cuda.empty_cache()
    windows["train"] = {key: sum(w[key] for name, w in windows.items() if name.startswith("train_step"))
                        for key in windows["forward"]}
    return {"forward": windows["forward"], "generate": windows["generate"], "train": windows["train"],
            "request_ms": request_ms, "step_ms": step_ms, "rel_err": rel}


def phase_c1_kernels():
    """Phase 14a: the fp32 instances of K1 (B=128 and B=32) and K2 (B=128)
    at the C1 config's attention shape (S=256, H=8, D=64) against their plain
    versions. Each kernel and its PyTorch call timed the same way, by CUDA-graph
    replays: K1 against fp32 SDPA, K2 against SDPA's fp32 backward as its
    memory-efficient backward op (:func:`sdpa_fp32_backward`, its gradients
    held to the plain version too). Beside them, K2's and the SDPA autograd
    backward's kernels summed by ``torch.profiler``, each in a session of its
    own over the same calls, with the number of device activities it saw (K2
    must show its two kernels a call). Bounds at the 3xTF32 rate (three TF32
    products at 495 TFLOP/s, what the kernels run) and, beside them, at the
    fp32 CUDA-core peak; the [S x S x D] products each design runs (K2's from
    the built library, by the rule its launch follows) beside the bound's."""
    import torch
    import torch.nn.functional as F

    from diffulab_tpu_torch.ops import _build
    from diffulab_tpu_torch.ops.fused_mha import (
        fused_mha,
        fused_mha_bwd,
        fused_mha_bwd_reference,
        fused_mha_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(14)
    s, h, d = C1_SEQ, C1_HEADS, 64

    def rand(b):
        return torch.randn(b, s, h, d, generator=gen, device="cuda", dtype=torch.float32)

    results = {}
    with torch.no_grad():
        for b in (C1_BATCH, 2 * C1_SAMPLES):
            q, k, v = rand(b), rand(b), rand(b)
            o, lse = fused_mha(q, k, v)
            ro, rlse = fused_mha_reference(q, k, v)
            err = check_close(f"C1 K1 fp32 B={b} o", o, ro, *TOL["float32"])
            check_close(f"C1 K1 fp32 B={b} lse", lse, rlse, *LSE_TOL)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            bound_ms, bound_by, mb, gflop = attention_bound(b, s, h, d, b * s, 4, mask=False,
                                                            peak_flops=PEAK_TF32_FLOPS / 3)
            results[f"fwd_b{b}"] = dict(
                max_abs_err=err, ms=cuda_graph_ms(lambda: fused_mha(q, k, v)),
                plain_ms=cuda_time_ms(lambda: fused_mha_reference(q, k, v), iters=5),
                library_ms=cuda_graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
                bound_ms=bound_ms, bound_by=bound_by, mb=mb, gflop=gflop,
                ffma_ms=attention_bound(b, s, h, d, b * s, 4, mask=False, peak_flops=PEAK_FP32_FLOPS)[0])
            del q, k, v, o, ro, qt, kt, vt
        b = C1_BATCH
        q, k, v, do = rand(b), rand(b), rand(b), rand(b)
        _, lse = fused_mha(q, k, v)
        refs = fused_mha_bwd_reference(q, k, v, None, lse, do)
        err = check_grads("C1 K2 fp32", fused_mha_bwd(q, k, v, None, lse, do), refs, BWD_TOL["float32"])
        sdpa_bwd = sdpa_fp32_backward(q, k, v, do)
        check_grads("C1 SDPA fp32 backward op", [g.transpose(1, 2) for g in sdpa_bwd()], refs, BWD_TOL["float32"])
        del refs
        ms = cuda_graph_ms(lambda: fused_mha_bwd(q, k, v, None, lse, do), calls=10, replays=5)
        library_ms = cuda_graph_ms(sdpa_bwd, calls=10, replays=5)
        plain_ms = cuda_time_ms(lambda: fused_mha_bwd_reference(q, k, v, None, lse, do), iters=3)
        profiled = {"kernel": complete_sessions(lambda: fused_mha_bwd(q, k, v, None, lse, do),
                                                lambda seen: seen == 2 * 10)}
    with torch.enable_grad():
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        profiled["SDPA autograd"] = complete_sessions(
            lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), lambda seen: seen % 10 == 0)
        del out
    if any(len(kept) < 2 for kept, _ in profiled.values()):
        fail(f"C1 K2 fp32: torch.profiler saw {profiled} (ms, device activities) over 10 calls in the sessions that "
             "saw every call's activities (K2 runs 2 a call), fewer than 2 of 4 for one of them")
    products = _build.load("fused_mha_bwd").fused_mha_bwd_f32_products(d, s)
    if products not in (7, 9):
        fail(f"C1 K2 fp32: the library counts {products} products at D={d}, Skv={s}")
    bytes_moved = 7 * b * s * h * d * 4 + b * s * h * 4  # q, k, v, do, dq, dk, dv once each + lse
    flops = 10 * b * h * s * s * d  # the recomputed s and four products
    t_bytes, t_tf32, t_ffma = bytes_moved / PEAK_BYTES_PER_S, 3 * flops / PEAK_TF32_FLOPS, flops / PEAK_FP32_FLOPS
    results["bwd_b128"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                               bound_ms=max(t_bytes, t_tf32) * 1e3,
                               bound_by="bytes" if t_bytes >= t_tf32 else "operations")
    del q, k, v, do, lse, qt, kt, vt, sdpa_bwd
    torch.cuda.synchronize()
    bw = results["bwd_b128"]
    print(f"phase 14 kernels fp32 at the C1 shape (S={s} H={h} D={d}; bounds at 3xTF32 = "
          f"{PEAK_TF32_FLOPS / 1e12:.0f}/3 TFLOP/s and, as ffma, at the fp32 CUDA-core peak "
          f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s, with {PEAK_BYTES_PER_S / 1e12} TB/s; device ms from CUDA-graph "
          f"replays): "
          + " ".join(f"K1 B={bb} max_abs_err {r['max_abs_err']:.3e} kernel {r['ms']:.4f} SDPA fp32 "
                     f"{r['library_ms']:.4f} plain {r['plain_ms']:.4f} bound {r['bound_ms']:.4f} ({r['bound_by']}: "
                     f"{r['mb']:.1f} MB, {r['gflop']:.2f} GFLOP) ffma {r['ffma_ms']:.4f}; products 2 (bound 2);"
                     for bb, r in ((C1_BATCH, results[f"fwd_b{C1_BATCH}"]),
                                   (2 * C1_SAMPLES, results[f"fwd_b{2 * C1_SAMPLES}"])))
          + f" K2 B={C1_BATCH} max_abs_err {bw['max_abs_err']:.3e} (tol {BWD_TOL['float32']} * (max|ref| + |ref|)) "
          f"kernel {bw['ms']:.4f} SDPA fp32 backward op {bw['library_ms']:.4f} plain {bw['plain_ms']:.4f} bound "
          f"{bw['bound_ms']:.4f} ({bw['bound_by']}: {bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) ffma "
          f"{max(t_bytes, t_ffma) * 1e3:.4f}; products {products} (bound 5); torch.profiler over 10 calls, "
          f"(ms, device activities) of two sessions each, then of the sessions that lost activities: "
          + "; ".join(f"{name} {[(round(t, 4), n) for t, n in kept]} lost {[(round(t, 4), n) for t, n in lost]}"
                      for name, (kept, lost) in profiled.items())
          + f"; K1 tol atol {TOL['float32'][0]} rtol {TOL['float32'][1]}")
    return results


def _run_cli(fn, argv, log: Path):
    """One CLI's ``main(argv)`` in this process (the launch counters see it),
    its printed output kept in ``log`` and shown only if it fails."""
    import contextlib

    with open(log, "a") as f, contextlib.redirect_stdout(f):
        try:
            return fn(argv)
        except BaseException:
            f.flush()
            sys.stderr.write(log.read_text()[-4000:])
            raise


def _timed_train_cli(main, argv, log: Path, run: Path, n_epochs: int, steps_per_epoch: int, label: str,
                     val_images: bool = True, before_first_step=None):
    """A training CLI's ``main(argv)`` (``train_diffusion`` or ``reflow``) in
    process, writing its run to ``run``, with every train step timed (the
    card synchronised at both ends) and its launch counts read at both ends;
    the counts are set to 0 just before. Checks the step counter, one finite
    train and validation loss an epoch, and, with ``val_images``, one
    validation grid an epoch. Returns the trainer, the per-step launches (K1,
    K2, K3, and by kernel, dtype and key length), the step times and the
    run's totals. ``before_first_step`` is called with the first step's
    arguments before that step runs."""
    import torch

    from diffulab_tpu_torch.training import trainer as trainer_mod

    marks, step_keys = [], []
    original = trainer_mod.train_step

    def timed_step(*args, **kwargs):
        if before_first_step is not None and not marks:
            before_first_step(*args, **kwargs)
        torch.cuda.synchronize()
        start, keys = (time.perf_counter(), launch_counts()), launch_keys()
        out = original(*args, **kwargs)
        torch.cuda.synchronize()
        marks.append((start, (time.perf_counter(), launch_counts())))
        step_keys.append(key_diff(launch_keys(), keys))
        return out

    trainer_mod.train_step = timed_step
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = _run_cli(main, argv, log)
        (trainer,) = out if isinstance(out, list) else (out,)  # train_diffusion returns one trainer a sweep entry
        train_s = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        trainer_mod.train_step = original
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    val_losses = [r["val/loss"] for r in rows if "val/loss" in r]
    if trainer.step != n_epochs * steps_per_epoch or len(marks) != trainer.step or len(losses) != n_epochs \
            or not all(math.isfinite(v) for v in losses + val_losses) or len(val_losses) != n_epochs:
        fail(f"{label} train: step counter {trainer.step}, {len(marks)} steps timed, train losses {losses}, "
             f"val losses {val_losses}")
    images = sorted((run / "images").glob("val_images_step*.png"))
    if len(images) != (n_epochs if val_images else 0):
        fail(f"{label} train: validation image grids {images}, one an epoch expected")
    per_step = [(c1["fused_mha_fwd"] - c0["fused_mha_fwd"], c1["fused_mha_bwd"] - c0["fused_mha_bwd"],
                 c1["flash_attn_fwd"] - c0["flash_attn_fwd"]) for (_, c0), (_, c1) in marks]
    # start to start within an epoch: the host's batch and draws included
    starts = [t for (t, _), _ in marks]
    step_ms = [(b - a) * 1e3 for i, (a, b) in enumerate(zip(starts[:-1], starts[1:])) if (i + 1) % steps_per_epoch]
    kernel_ms = [(t1 - t0) * 1e3 for (t0, _), (t1, _) in marks]
    return dict(trainer=trainer, per_step=per_step, step_keys=step_keys, step_ms=step_ms,
                steady=statistics.median(step_ms[2:]),
                kernel_ms=statistics.median(kernel_ms[2:]), train_s=train_s, launches=launches,
                peak_gib=peak_gib, losses=losses, val_losses=val_losses)


def _sample_request(argv, log: Path):
    """One ``sample`` CLI request in process, the launch counts set to 0 just
    before and read just after; its images finite."""
    import numpy as np

    from diffulab_tpu_torch.examples import sample

    reset_launch_counts()
    result = _run_cli(sample.main, argv, log)
    result["launches"] = launch_counts()
    if not np.isfinite(result["images"]).all():
        fail(f"sample {argv}: non-finite images")
    return result


def phase_c1_cli(root: Path):
    """Phase 14b: train_synthetic_flow_matching through the port's three CLIs,
    in process, under ``root``: train_diffusion (post-hoc EMA, validation
    images every epoch), reconstruct_ema, sample. The counts are set to 0 just
    before the training and read at each train step, and set to 0 again just
    before the sample request. The run stays for phase 16."""
    import numpy as np
    from PIL import Image

    from diffulab_tpu_torch.data import native
    from diffulab_tpu_torch.examples import reconstruct_ema, train_diffusion
    from diffulab_tpu_torch.training.posthoc_ema import list_snapshots

    sys.modules["wandb"] = None  # metrics go to metrics.jsonl; wandb is neither imported nor contacted
    log = root / "cli.log"
    overrides = [f"{key}={new}" for key, (_, new) in C1_CUTS.items()] + [f"trainer.save_path={root}"]
    run = root / "synthetic_flow_matching"
    n_epochs = C1_CUTS["trainer.n_epoch"][1]
    steps_per_epoch = C1_CUTS["dataset.train.n_samples"][1] // C1_BATCH
    tr = _timed_train_cli(train_diffusion.main, ["--config-name", C1_CONFIG, *overrides], log, run, n_epochs,
                          steps_per_epoch, "C1")
    trainer, train_launches = tr["trainer"], tr["launches"]
    if tr["per_step"] != [(C1_DEPTH, C1_DEPTH, 0)] * trainer.step:
        fail(f"C1 train: kernel launches per step (K1, K2, K3) {sorted(set(tr['per_step']))}, "
             f"expected ({C1_DEPTH}, {C1_DEPTH}, 0) each")
    snaps = list_snapshots(run / "checkpoints" / "phema")
    if len(snaps) != n_epochs * 2:
        fail(f"C1 train: post-hoc EMA snapshots {[(s, g) for s, g, _ in snaps]}, expected {n_epochs} x 2")
    if not native.HAS_NATIVE:
        fail("C1 train: the native collate library did not load on this machine")

    t0 = time.perf_counter()
    results = _run_cli(reconstruct_ema.main, ["--run-dir", str(run), "--sigma-rel", *C1_SIGMA_RELS], log)
    reconstruct_s = time.perf_counter() - t0
    sums = [float(r["weights"].sum()) for r in results]
    if not all(np.isfinite(r["weights"]).all() for r in results) or any(abs(x - 1) > 5e-2 for x in sums):
        fail(f"C1 reconstruct: weights {[r['weights'].tolist() for r in results]}")
    ckpt = run / "checkpoints" / f"phema_sr{float(C1_SIGMA_RELS[0]):g}"
    labels = ",".join(str(i) for i in range(10))
    out = root / "samples.png"
    result = _sample_request(["--config-name", C1_CONFIG, "--ckpt", str(ckpt), "--n", str(C1_SAMPLES),
                              "--guidance", str(C1_GUIDANCE), "--labels", labels, "--out", str(out), *overrides], log)
    sample_launches = result["launches"]
    grid = np.asarray(Image.open(out))
    if sample_launches["fused_mha_fwd"] != C1_STEPS * C1_DEPTH or sample_launches["flash_attn_fwd"] \
            or sample_launches["fused_mha_bwd"]:
        fail(f"C1 sample: launches {sample_launches}, expected {C1_STEPS * C1_DEPTH} K1 and no other")
    images = result["images"]
    grid_shape = (2 + 2 * 34, 2 + 8 * 34, 3)  # 16 images of 32x32, 8 a row, 2 pixels apart
    if images.shape != (C1_SAMPLES, 32, 32, 3) or grid.shape != grid_shape:
        fail(f"C1 sample: images {images.shape}, grid {grid.shape}")
    step_ms = tr["step_ms"]
    cuts = ", ".join(f"{key} {old} -> {new}" for key, (old, new) in C1_CUTS.items())
    print(f"phase 14 CLIs {C1_CONFIG} (cut: {cuts}; else the config's: batch {C1_BATCH}, fp32, DiT depth {C1_DEPTH} "
          f"width 512, {C1_HEADS} heads, AdamW lr 3e-4, p_cfg 0.1, post-hoc EMA gammas 6.94/16.97, 50 validation "
          f"steps, Euler-{C1_STEPS}): train {trainer.step} steps in {tr['train_s']:.1f} s, ms/step start to start "
          f"median after the first two {tr['steady']:.2f} (min {min(step_ms):.2f} max {max(step_ms):.2f}; train_step "
          f"alone median {tr['kernel_ms']:.2f}), samples/s {C1_BATCH / tr['steady'] * 1e3:.1f}, peak mem "
          f"{tr['peak_gib']:.2f} GiB; train losses {[round(x, 5) for x in tr['losses']]}, val losses (EMA) "
          f"{[round(x, 5) for x in tr['val_losses']]}; launches per step {C1_DEPTH} K1 + {C1_DEPTH} K2, 0 K3, in the "
          f"run {train_launches} (K1 includes validation); {len(snaps)} phema snapshots; native collate loaded; "
          f"reconstruct sigma_rel {' '.join(C1_SIGMA_RELS)} in {reconstruct_s:.2f} s, weight sums "
          f"{[round(x, 6) for x in sums]}; sample {C1_SAMPLES} images (labels 0-9 tiled) CFG {C1_GUIDANCE}: "
          f"generate {result['generate_ms']:.1f} ms, {sample_launches['fused_mha_fwd']} K1 and 0 K3 launches; PNG "
          f"grid {grid.shape}, pixels finite")
    return {"train": train_launches, "sample": sample_launches, "step_ms": tr["steady"],
            "generate_ms": result["generate_ms"], "run": run}


def phase_dit_arms():
    """Phase 15: bench.py's two sampling arms the earlier phases do not run
    (bench.py:128-150), on DiT-B/2 at the bench's bf16 cast, batch 16, CFG
    4.0 (a model batch of 32): DPM-Solver++(2M) at 15 steps and Euler-50
    with ``set_block_cache(2, span=(2, 10))``. K1 at the arms' shape against
    its plain version; per arm a warm-up and three requests, the counts set to
    0 just before each and read just after (180 and 400 K1 launches), and
    request 0 against the plain-attention model's from the same noise. Then
    the caching protocol: step 0 refreshes, so the cached request's first
    step (``xt[:, 1]``) equals the uncached request's bit for bit, and
    ``set_block_cache(1, ...)`` turns caching off (600 launches)."""
    import torch

    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.ops.fused_mha import fused_mha, fused_mha_reference

    model, plain = build_models()
    depth = DIT_B2["depth"]
    gen = torch.Generator(device="cuda").manual_seed(15)
    b, s, h, d = 2 * SAMPLE_BATCH, 256, DIT_B2["num_heads"], DIT_B2["inner_dim"] // DIT_B2["num_heads"]
    with torch.no_grad():
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16() for _ in range(3))
        (o, lse), (ro, rlse) = fused_mha(q, k, v), fused_mha_reference(q, k, v)
        k1_err = check_close("phase 15 K1 bf16 o", o, ro, *TOL["bfloat16"])
        check_close("phase 15 K1 bf16 lse", lse, rlse, *LSE_TOL)
        del q, k, v, o, lse, ro, rlse
    labels = torch.randint(0, 1000, (SAMPLE_BATCH,), generator=gen, device="cuda")

    def request(diffuser, seed, **kw):
        noise = torch.Generator(device="cuda").manual_seed(seed)
        return diffuser.generate({"y": labels}, data_shape=(SAMPLE_BATCH, *LATENT), generator=noise,
                                 guidance_scale=CFG, dtype=torch.bfloat16, **kw)

    arms, totals = {}, {"fused_mha_fwd": 0, "flash_attn_fwd_f32": 0}
    for name, sampler, steps, cache, expected in (
            ("dpmpp_2m", "dpmpp_2m", C2_DPM_STEPS, None, C2_DPM_STEPS * depth),
            ("euler_cached", "euler", STEPS, C2_DIT_CACHE, C2_DIT_CACHED_K1)):
        diffusers = []
        for m in (model, plain):
            dif = Diffuser(m, sampler, n_steps=steps, extra_args={"logits_normal": True})
            if cache:
                dif.set_block_cache(*cache)
            diffusers.append(dif)
        request(diffusers[0], 199)  # warm-up
        times, outs = [], []
        for r in range(N_REQUESTS):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = request(diffusers[0], 200 + r)["x"]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launched = launch_counts()
            if launched["fused_mha_fwd"] != expected or launched["flash_attn_fwd"]:
                fail(f"phase 15 {name} request {r}: launches {launched}, expected {expected} K1")
            for key in totals:
                totals[key] += launched[key]
            if out.shape != (SAMPLE_BATCH, *LATENT) or not bool(torch.isfinite(out).all()):
                fail(f"phase 15 {name} request {r}: bad shape or non-finite output")
            outs.append(out)
        ref = request(diffusers[1], 200)["x"]
        rel = float((outs[0].float() - ref.float()).abs().max() / ref.float().abs().max())
        if rel > GEN_REL_TOL:
            fail(f"phase 15 {name}: request 0 against its plain-attention rerun rel err {rel:.3e} (tol {GEN_REL_TOL})")
        arms[name] = dict(ms=times, median_ms=statistics.median(times), launches=expected, rel_err=rel)
        if cache:
            cached = request(diffusers[0], 300, return_intermediates=True)["xt"]
            diffusers[0].set_block_cache(1, cache[1])  # interval 1 disables, as in the reference
            if model.cache_span is not None or diffusers[0]._block_cache is not None:
                fail("phase 15: set_block_cache(1, ...) left caching on")
            reset_launch_counts()
            uncached = request(diffusers[0], 300, return_intermediates=True)["xt"]
            if launch_counts()["fused_mha_fwd"] != STEPS * depth:
                fail(f"phase 15: the uncached request launched {launch_counts()['fused_mha_fwd']} K1")
            if not torch.equal(cached[:, 1], uncached[:, 1]):
                fail("phase 15: the cached request's refresh step differs from the uncached one's "
                     f"(max {float((cached[:, 1].float() - uncached[:, 1].float()).abs().max()):.3e})")
            arms[name]["refresh_step_bitwise"] = True
            arms[name]["final_vs_uncached_rel"] = float((cached[:, -1].float() - uncached[:, -1].float()).abs().max()
                                                        / uncached[:, -1].float().abs().max())
        del diffusers
    del model, plain
    torch.cuda.empty_cache()
    dpm, cached = arms["dpmpp_2m"], arms["euler_cached"]
    print(f"phase 15 DiT-B/2 sampling arms, batch {SAMPLE_BATCH} {LATENT} CFG {CFG} bf16 (model batch {b}): K1 bf16 "
          f"at B={b} S={s} H={h} D={d} max_abs_err {k1_err:.3e} (tol atol {TOL['bfloat16'][0]} rtol "
          f"{TOL['bfloat16'][1]}); dpmpp_2m-{C2_DPM_STEPS}: ms/request {[round(t, 2) for t in dpm['ms']]} (median "
          f"{dpm['median_ms']:.2f}), {dpm['launches']} K1 a request, request 0 vs plain attention rel err "
          f"{dpm['rel_err']:.3e}; Euler-{STEPS} block cache interval {C2_DIT_CACHE[0]} span {C2_DIT_CACHE[1]}: "
          f"ms/request {[round(t, 2) for t in cached['ms']]} (median {cached['median_ms']:.2f}), "
          f"{cached['launches']} K1 a request ({STEPS * depth} uncached), request 0 vs plain attention rel err "
          f"{cached['rel_err']:.3e} (tol {GEN_REL_TOL}); refresh step xt[:, 1] bitwise equal to the uncached "
          f"request's; final sample vs uncached rel diff {cached['final_vs_uncached_rel']:.3e}; set_block_cache(1) "
          f"disables ({STEPS * depth} K1)")
    return {"k1_err": k1_err, "launches": totals, "arms": arms}


def edm_k1(sampler: str, n_steps: int, depth: int, start_idx: int = 0, cache=None, models: int = 1) -> int:
    """K1 launches of one EDM request: the solver's evals over the Karras
    pairs from ``start_idx`` (Heun 2 a step, the others 1), each running
    ``depth`` blocks (``depth - (hi - lo)`` on a reuse step of ``cache =
    (interval, (lo, hi))``), then the uncached collapse; ``models`` = 2 with
    an autoguidance model."""
    evals = 2 if sampler == "heun" else 1
    total = 0
    for i in range(n_steps - 1 - start_idx):
        blocks = depth
        if cache and i % cache[0]:
            blocks -= cache[1][1] - cache[1][0]
        total += evals * blocks
    return models * (total + depth)


def phase_c2_cli(root: Path, c1_run: Path):
    """Phase 16: slice C2. K1 and K2 fp32 at the EDM config's attention shapes
    against their plain versions; train_synthetic_edm through train_diffusion
    (the counts set to 0 before and read at each step), reconstruct_ema and a
    Heun-18 sample request; one request each of DPM++-15, UniPC-10, block
    caching, autoguidance with the epoch-1 post-hoc EMA snapshot, an inpaint
    box (the known region back exactly) and img2img at strength 0.6, each
    with its K1 count; then on phase 14's flow run: a UniPC-10 request,
    one epoch of train_synthetic_flow_distill from its checkpoint, and the
    reflow CLI on 512 pairs for one epoch."""
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from diffulab_tpu_torch.examples import reconstruct_ema, reflow, train_diffusion
    from diffulab_tpu_torch.ops.fused_mha import fused_mha, fused_mha_bwd, fused_mha_bwd_reference, fused_mha_reference

    sys.modules["wandb"] = None
    gen = torch.Generator(device="cuda").manual_seed(16)
    s, h, d = C1_SEQ, C1_HEADS, 64
    errs = {}
    with torch.no_grad():
        # the train step's, the distillation teacher's guided forward (one 2x call), a CFG request's, and
        # autoguidance's (main and guide model, one conditional call each)
        for b in (C1_BATCH, 2 * C1_BATCH, 2 * C1_SAMPLES, C1_SAMPLES):
            q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device="cuda") for _ in range(4))
            (o, lse), (ro, rlse) = fused_mha(q, k, v), fused_mha_reference(q, k, v)
            errs[f"K1 B={b}"] = check_close(f"phase 16 K1 fp32 B={b} o", o, ro, *TOL["float32"])
            check_close(f"phase 16 K1 fp32 B={b} lse", lse, rlse, *LSE_TOL)
            if b == C1_BATCH:
                errs[f"K2 B={b}"] = check_grads("phase 16 K2 fp32", fused_mha_bwd(q, k, v, None, lse, do),
                                                fused_mha_bwd_reference(q, k, v, None, lse, do), BWD_TOL["float32"])
            del q, k, v, do, o, lse, ro, rlse

    log = root / "c2.log"
    cuts = [f"{key}={new}" for key, (_, new) in C1_CUTS.items()]
    overrides = cuts + [f"trainer.save_path={root}"]
    run = root / "synthetic_edm"
    n_epochs = C1_CUTS["trainer.n_epoch"][1]
    steps_per_epoch = C1_CUTS["dataset.train.n_samples"][1] // C1_BATCH
    tr = _timed_train_cli(train_diffusion.main, ["--config-name", C2_CONFIG, *overrides], log, run, n_epochs,
                          steps_per_epoch, "C2")
    if tr["per_step"] != [(C1_DEPTH, C1_DEPTH, 0)] * tr["trainer"].step:
        fail(f"C2 train: kernel launches per step (K1, K2, K3) {sorted(set(tr['per_step']))}")
    _run_cli(reconstruct_ema.main, ["--run-dir", str(run), "--sigma-rel", *C1_SIGMA_RELS], log)
    ckpts = run / "checkpoints"
    # the epoch-1 post-hoc EMA snapshot (gamma 6.94, the shorter horizon) as an entry the restore reads
    # (params only): the guide
    first = sorted((ckpts / "phema").glob("step*_g6.94"))[0]
    shutil.copytree(first, ckpts / "phema_epoch1")
    labels = ",".join(str(i) for i in range(10))
    base = ["--config-name", C2_CONFIG, "--ckpt", str(ckpts / f"phema_sr{float(C1_SIGMA_RELS[0]):g}"), "--n",
            str(C1_SAMPLES), "--guidance", str(C1_GUIDANCE), "--labels", labels, *overrides]
    requests = {}
    main = _sample_request([*base, "--out", str(root / "edm.png"), "--separate"], log)
    requests["heun-18"] = (main, edm_k1("heun", C2_STEPS, C1_DEPTH))
    png = root / "edm_000.png"  # the first generated image: the inpaint and img2img source
    strength = 0.6
    start_idx = C2_STEPS - min(max(int(round(strength * C2_STEPS)), 1), C2_STEPS)
    for name, flags, expected in (
            ("dpmpp_2m-15", ["--sampler", "dpmpp_2m", "--steps", "15"], edm_k1("dpmpp_2m", 15, C1_DEPTH)),
            ("unipc-10", ["--sampler", "unipc", "--steps", "10"], edm_k1("unipc", 10, C1_DEPTH)),
            ("heun-18 cached", ["--cache-interval", str(C2_EDM_CACHE[0]), "--cache-span",
                                *map(str, C2_EDM_CACHE[1])], edm_k1("heun", C2_STEPS, C1_DEPTH, cache=C2_EDM_CACHE)),
            ("autoguidance", ["--guide-ckpt", str(ckpts / "phema_epoch1")], edm_k1("heun", C2_STEPS, C1_DEPTH, models=2)),
            ("inpaint", ["--inpaint-image", str(png), "--inpaint-box", "8:24,8:24"], edm_k1("heun", C2_STEPS, C1_DEPTH)),
            ("img2img", ["--img2img-image", str(png), "--strength", str(strength)],
             edm_k1("heun", C2_STEPS, C1_DEPTH, start_idx=start_idx))):
        requests[name] = (_sample_request([*base, "--out", str(root / f"{name}.png"), *flags], log), expected)
    for name, (result, expected) in requests.items():
        got = result["launches"]
        if got["fused_mha_fwd"] != expected or got["flash_attn_fwd"] or got["fused_mha_bwd"]:
            fail(f"C2 sample {name}: launches {got}, expected {expected} K1 and no other")
        if result["images"].shape != (C1_SAMPLES, 32, 32, 3):
            fail(f"C2 sample {name}: images {result['images'].shape}")
    ip = requests["inpaint"][0]
    keep = np.broadcast_to(ip["inpaint"]["mask"], ip["images"].shape) > 0
    expected = np.clip(ip["inpaint"]["known"] * 0.5 + 0.5, 0, 1)
    if not np.array_equal(ip["images"][keep], expected[keep]):
        fail(f"C2 inpaint: the known region changed (max {np.abs(ip['images'][keep] - expected[keep]).max():.3e})")
    src = np.asarray(Image.open(png), np.float32) / 255.0
    img2img_diff = float(np.abs(requests["img2img"][0]["images"] - src).mean())

    # phase 14's flow run: UniPC-10 (the rectified_flow_fast setting), distillation, reflow
    c1_ckpt = c1_run / "checkpoints" / f"phema_sr{float(C1_SIGMA_RELS[0]):g}"
    fast = _sample_request(["--config-name", C1_CONFIG, "--ckpt", str(c1_ckpt), "--n", str(C1_SAMPLES), "--guidance",
                            str(C1_GUIDANCE), "--labels", labels, "--sampler", "unipc", "--steps", "10", "--out",
                            str(root / "unipc.png"), *overrides], log)
    if fast["launches"]["fused_mha_fwd"] != 10 * C1_DEPTH:
        fail(f"C1 UniPC-10: launches {fast['launches']}, expected {10 * C1_DEPTH} K1")
    distill_run = root / "synthetic_flow_distill"
    dist = _timed_train_cli(train_diffusion.main, ["--config-name", "train_synthetic_flow_distill", *cuts,
                                                   "trainer.n_epoch=1", f"trainer.distill_from={c1_ckpt}",
                                                   f"trainer.save_path={root}"], log, distill_run, 1,
                            steps_per_epoch, "distill")
    # the student's forward and backward, and the teacher's guided forward (one 2x call)
    if dist["per_step"] != [(2 * C1_DEPTH, C1_DEPTH, 0)] * dist["trainer"].step:
        fail(f"distill train: kernel launches per step (K1, K2, K3) {sorted(set(dist['per_step']))}")
    # the reflow CLI: pair generation, then one epoch (validation logs no images, as in the reference)
    rf = _timed_train_cli(reflow.main, ["--ckpt", str(c1_ckpt), "--n-pairs", str(C2_REFLOW_PAIRS), "--val-pairs",
                                        str(C2_REFLOW_VAL), "--epochs", "1", *overrides], log,
                          root / "synthetic_flow_matching_reflow", 1, C2_REFLOW_PAIRS // C1_BATCH, "reflow",
                          val_images=False)
    if rf["per_step"] != [(C1_DEPTH, C1_DEPTH, 0)] * rf["trainer"].step:
        fail(f"reflow train: kernel launches per step (K1, K2, K3) {sorted(set(rf['per_step']))}")
    reflow_launches = rf["launches"]

    def ms(name):
        return round(requests[name][0]["generate_ms"], 1)

    cut_text = ", ".join(f"{key} {old} -> {new}" for key, (old, new) in C1_CUTS.items())
    print(f"phase 16 slice C2 {C2_CONFIG} (cut: {cut_text}; else the config's: batch {C1_BATCH}, fp32, DiT depth "
          f"{C1_DEPTH} width 512, {C1_HEADS} heads, EDM sigma_data 0.5 sigma 0.002-80 rho 7, AdamW lr 3e-4, p_cfg 0.1, "
          f"post-hoc EMA): kernels fp32 vs plain max_abs_err " + " ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (K1 tol atol {TOL['float32'][0]} rtol {TOL['float32'][1]}, K2 {BWD_TOL['float32']} * (max|ref| + "
          f"|ref|)); train {tr['trainer'].step} steps in {tr['train_s']:.1f} s, ms/step start to start median after "
          f"the first two {tr['steady']:.2f} (min {min(tr['step_ms']):.2f} max {max(tr['step_ms']):.2f}; train_step "
          f"alone {tr['kernel_ms']:.2f}), samples/s {C1_BATCH / tr['steady'] * 1e3:.1f}, peak mem {tr['peak_gib']:.2f} "
          f"GiB, train losses {[round(x, 5) for x in tr['losses']]}, val losses {[round(x, 5) for x in tr['val_losses']]}, "
          f"{C1_DEPTH} K1 + {C1_DEPTH} K2 a step, in the run {tr['launches']}; requests of {C1_SAMPLES} images CFG "
          f"{C1_GUIDANCE}, generate ms and K1 launches: "
          + "; ".join(f"{name} {ms(name)} ms {requests[name][1]} K1" for name in requests)
          + f"; inpaint known region exact; img2img mean |image - source| {img2img_diff:.4f}; on the C1 flow run: "
          f"UniPC-10 {fast['generate_ms']:.1f} ms {fast['launches']['fused_mha_fwd']} K1; distill 1 epoch "
          f"{dist['trainer'].step} steps, ms/step {dist['steady']:.2f}, {2 * C1_DEPTH} K1 + {C1_DEPTH} K2 a step, "
          f"losses {[round(x, 6) for x in dist['losses']]}; reflow {C2_REFLOW_PAIRS} + {C2_REFLOW_VAL} pairs, 1 epoch "
          f"({rf['trainer'].step} steps) in {rf['train_s']:.1f} s with the pairs' generation, ms/step "
          f"{rf['steady']:.2f}, {C1_DEPTH} K1 + {C1_DEPTH} K2 a step, losses {[round(x, 6) for x in rf['losses']]}, "
          f"{reflow_launches['fused_mha_fwd']} K1 and {reflow_launches['fused_mha_bwd']} K2 in all")
    windows = [tr["launches"], *(r["launches"] for r, _ in requests.values()), fast["launches"], dist["launches"],
               reflow_launches]
    totals = {key: sum(w[key] for w in windows) for key in windows[0]}
    return {**totals, "errs": errs}


def phase_d1_kernels():
    """Phase 17a: the fp32 K1 and K2 instances at head dims 192 and 384 (the
    D1 UNet's: 64 and 16 tokens, keys padded to 128, H=2) against their plain
    versions, as the fused route hands them over: the unpadded query rows, k,
    v and the padding mask at 128 keys; K1 at B=128 and at the CFG sample's
    B=32, K2 at B=128. The edge cases, timings and bounds of phase 19a
    (:func:`valid_rows_kernels`). First the libraries' tile rules against the
    ones the emulation in ``ops/fused_mha.py`` mirrors, at every fused head
    dim, and the head dims whose instances take the unpadded query rows
    against its ``VALID_ROWS_HEAD_DIMS``."""
    from diffulab_tpu_torch.ops import _build
    from diffulab_tpu_torch.ops.fused_mha import FUSED_HEAD_DIMS, VALID_ROWS_HEAD_DIMS, f32_groups, f32_keys

    fwd_lib, bwd_lib = _build.load("fused_mha_fwd"), _build.load("fused_mha_bwd")
    tiles = {d: (fwd_lib.fused_mha_fwd_f32_tiles(d, 0), fwd_lib.fused_mha_fwd_f32_tiles(d, 1),
                 bwd_lib.fused_mha_bwd_f32_groups(d)) for d in FUSED_HEAD_DIMS}
    mirrored = {d: (f32_keys(d), f32_groups(d), f32_groups(d)) for d in FUSED_HEAD_DIMS}
    if tiles != mirrored:
        fail(f"D1 fp32 tile rules: the libraries' (K1 keys, K1 groups, K2 groups) {tiles} differ from "
             f"ops/fused_mha.py's {mirrored}")
    valid_rows = tuple(d for d in FUSED_HEAD_DIMS if fwd_lib.fused_mha_fwd_f32_tiles(d, 2))
    if valid_rows != VALID_ROWS_HEAD_DIMS:
        fail(f"the libraries take the unpadded query rows at head dims {valid_rows}, ops/fused_mha.py's "
             f"VALID_ROWS_HEAD_DIMS is {VALID_ROWS_HEAD_DIMS}")
    products = {d: bwd_lib.fused_mha_bwd_f32_products(d, D1_PADDED) for d, _, _ in D1_ATTN}
    if set(products.values()) != {9}:
        fail(f"D1 K2: the library counts {products} products at D = 192/384, expected 5 + 4 over the live tiles")

    results, edges = valid_rows_kernels("D1", D1_ATTN, D1_BATCH, D1_HEADS, 17, sample_batch=2 * D1_SAMPLES)
    print(f"phase 17 kernels fp32 at the D1 UNet's attention shapes (B={D1_BATCH}, K1 also at the CFG sample's "
          f"B={2 * D1_SAMPLES}, H={D1_HEADS}, the unpadded query rows, keys padded to {D1_PADDED} with the padding "
          f"mask; tile rules (K1 keys, K1 groups, K2 groups) {tiles}, as the emulation's; the "
          f"unpadded query rows at head dims {valid_rows}; K2 products {products}; {VALID_ROWS_TIMING}): "
          + valid_rows_line(results, edges))
    return results


def _d1_unet(seed: int):
    """The config's UNet at full width, seeded noise in every parameter (its
    out convs are zero-initialised), on the card."""
    from diffulab_tpu_torch.config import compose_config, instantiate
    from diffulab_tpu_torch.examples.train_diffusion import CONFIG_DIR

    model = instantiate(compose_config(CONFIG_DIR, D1_CONFIG)["model"], device="cuda")
    randomize_(model, seed)
    return model


def phase_d1_model():
    """Phase 17b: the config's UNet at full width (155.7M parameters), fp32:
    one forward at the CFG sample's batch 32 and the parameter gradients of
    one epsilon loss at batch 16, each on the kernel path against the same
    model with the plain attention (K1/K2's plain versions, ``impl="xla"``),
    the launch counts set to 0 just before and read just after: 11 K1 a
    forward (5 at D=192, 6 at D=384), 11 K2 a backward."""
    import functools

    import torch

    import diffulab_tpu_torch.networks.denoisers.unet as unet_mod
    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.ops import dot_product_attention

    model = _d1_unet(171)
    gen = torch.Generator(device="cuda").manual_seed(172)

    def both_paths(fn):
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launched = launch_counts()
        unet_mod.dot_product_attention = functools.partial(dot_product_attention, impl="xla")
        try:
            ref = fn()
        finally:
            unet_mod.dot_product_attention = dot_product_attention
        return out, ref, launched

    b = 2 * D1_SAMPLES
    x = torch.randn(b, 32, 32, 3, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    y = torch.randint(0, 10, (b,), generator=gen, device="cuda")
    drop = torch.arange(b, device="cuda") >= D1_SAMPLES
    with torch.no_grad():
        out, ref, fwd = both_paths(lambda: model(x, t, {"y": y}, drop)["x"])
    rel = float((out - ref).abs().max() / ref.abs().max())
    want = {"fused_mha_fwd": D1_CALLS, "fused_mha_fwd_f32_d192": 5, "fused_mha_fwd_f32_d384": 6, "fused_mha_bwd": 0}
    if not bool(torch.isfinite(out).all()) or rel > 1e-4 or any(fwd[k] != v for k, v in want.items()):
        fail(f"D1 UNet forward: rel err {rel:.3e} (tol 1e-4), launches {fwd}, expected {want}")

    b = 16
    diffuser = Diffuser(model, "ddim", model_type="gaussian_diffusion")
    x0 = torch.randn(b, 32, 32, 3, generator=gen, device="cuda")
    noise = torch.randn(b, 32, 32, 3, generator=gen, device="cuda")
    t, y = torch.randint(0, 1000, (b,), generator=gen, device="cuda"), torch.randint(0, 10, (b,), generator=gen,
                                                                                        device="cuda")
    drop = torch.arange(b, device="cuda") % 5 == 0

    def grads():
        model.zero_grad(set_to_none=True)
        diffuser.compute_loss(x0, {"y": y}, t, noise, drop=drop)["loss"].backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    ours, plain, bwd = both_paths(grads)
    worst = max(float((ours[n] - plain[n]).norm() / plain[n].norm().clamp_min(1e-30)) for n in plain
                if float(plain[n].norm()) > 0)
    want = {"fused_mha_fwd": D1_CALLS, "fused_mha_bwd": D1_CALLS, "fused_mha_bwd_f32_d192": 5,
            "fused_mha_bwd_f32_d384": 6}
    if worst > 1e-3 or any(bwd[k] != v for k, v in want.items()):
        fail(f"D1 UNet gradients: worst per-parameter rel err {worst:.3e} (tol 1e-3), launches {bwd}")
    model.zero_grad(set_to_none=True)
    del model, diffuser, ours, plain
    torch.cuda.empty_cache()
    print(f"phase 17 D1 UNet (155.7M parameters, fp32) forward B={2 * D1_SAMPLES}: kernel path vs plain attention "
          f"max rel err {rel:.3e} (tol 1e-4), launches {fwd['fused_mha_fwd_f32_d192']} K1 D=192 + "
          f"{fwd['fused_mha_fwd_f32_d384']} K1 D=384; epsilon-loss gradients B={b}: worst per-parameter "
          f"||kernel - plain|| / ||plain|| {worst:.3e} (tol 1e-3), {bwd['fused_mha_bwd']} K2 "
          f"({bwd['fused_mha_bwd_f32_d192']} at D=192, {bwd['fused_mha_bwd_f32_d384']} at D=384)")


def phase_d1_cli(root: Path):
    """Phase 17c: train_synthetic_ddpm through the port's three CLIs, in
    process, under ``root``: train_diffusion (post-hoc EMA on, validation
    images by DDIM-50 every epoch), reconstruct_ema, and two DDIM-50 sample
    requests of 16 images at CFG 1.5. The counts are set to 0 just before the
    training and read at each train step (11 K1 + 11 K2), and set to 0 again
    just before each of two sample requests (550 K1 each; every K1 and K2
    launch of these runs an instance at D=192 or D=384)."""
    import numpy as np
    from PIL import Image

    from diffulab_tpu_torch.examples import reconstruct_ema, train_diffusion
    from diffulab_tpu_torch.training.posthoc_ema import list_snapshots

    sys.modules["wandb"] = None
    log = root / "d1.log"
    overrides = [f"{key}={new}" for key, (_, new) in D1_CUTS.items()] + [*D1_ON, f"trainer.save_path={root}"]
    run = root / "synthetic_ddpm"
    n_epochs = D1_CUTS["trainer.n_epoch"][1]
    steps_per_epoch = D1_CUTS["dataset.train.n_samples"][1] // D1_BATCH
    tr = _timed_train_cli(train_diffusion.main, ["--config-name", D1_CONFIG, *overrides], log, run, n_epochs,
                          steps_per_epoch, "D1")
    trainer, train_launches = tr["trainer"], tr["launches"]
    if tr["per_step"] != [(D1_CALLS, D1_CALLS, 0)] * trainer.step:
        fail(f"D1 train: kernel launches per step (K1, K2, K3) {sorted(set(tr['per_step']))}, "
             f"expected ({D1_CALLS}, {D1_CALLS}, 0) each")

    def check_instances(launches, label):
        for kind in ("fwd", "bwd"):
            by_dim = [launches[f"fused_mha_{kind}_f32_d{d}"] for d, _, _ in D1_ATTN]
            if sum(by_dim) != launches[f"fused_mha_{kind}"] or by_dim[0] * 6 != by_dim[1] * 5:
                fail(f"D1 {label}: {kind} launches {launches}: every one an instance at D=192 (5 a model call) "
                     "or D=384 (6)")

    check_instances(train_launches, "train")
    snaps = list_snapshots(run / "checkpoints" / "phema")
    if len(snaps) != n_epochs * 2:
        fail(f"D1 train: post-hoc EMA snapshots {[(s, g) for s, g, _ in snaps]}, expected {n_epochs} x 2")
    t0 = time.perf_counter()
    results = _run_cli(reconstruct_ema.main, ["--run-dir", str(run), "--sigma-rel", *C1_SIGMA_RELS], log)
    reconstruct_s = time.perf_counter() - t0
    sums = [float(r["weights"].sum()) for r in results]
    if not all(np.isfinite(r["weights"]).all() for r in results) or any(abs(x - 1) > 5e-2 for x in sums):
        fail(f"D1 reconstruct: weights {[r['weights'].tolist() for r in results]}")
    ckpt = run / "checkpoints" / f"phema_sr{float(C1_SIGMA_RELS[0]):g}"
    out = root / "ddpm_samples.png"
    requests, sample_total = [], {}
    for seed in (0, 1):  # two requests: the first one's time includes the process's first calls at their shapes
        result = _sample_request(["--config-name", D1_CONFIG, "--ckpt", str(ckpt), "--n", str(D1_SAMPLES),
                                  "--guidance", str(D1_GUIDANCE), "--labels", ",".join(str(i) for i in range(10)),
                                  "--steps", str(D1_STEPS), "--seed", str(seed), "--out", str(out), *overrides], log)
        sample_launches = result["launches"]
        if sample_launches["fused_mha_fwd"] != D1_STEPS * D1_CALLS or sample_launches["fused_mha_bwd"] \
                or sample_launches["flash_attn_fwd"]:
            fail(f"D1 sample: launches {sample_launches}, expected {D1_STEPS * D1_CALLS} K1 and no other")
        check_instances(sample_launches, "sample")
        requests.append(result["generate_ms"])
        sample_total = {key: sample_total.get(key, 0) + n for key, n in sample_launches.items()}
    grid = np.asarray(Image.open(out))
    if result["images"].shape != (D1_SAMPLES, 32, 32, 3) or grid.shape != (2 + 2 * 34, 2 + 8 * 34, 3):
        fail(f"D1 sample: images {result['images'].shape}, grid {grid.shape}")
    step_ms = tr["step_ms"]
    cuts = ", ".join(f"{key} {old} -> {new}" for key, (old, new) in D1_CUTS.items())
    print(f"phase 17 CLIs {D1_CONFIG} (cut: {cuts}; on: {', '.join(D1_ON)}; else the config's: batch {D1_BATCH}, fp32, ADM UNet "
          f"model_channels 96 channel_mult 1,2,4,8, {D1_HEADS} heads, Gaussian diffusion 1000 steps, AdamW lr 2e-4, "
          f"p_cfg 0.1, DDIM-{D1_STEPS} validation): train {trainer.step} steps in {tr['train_s']:.1f} s, ms/step start "
          f"to start median after the first two {tr['steady']:.2f} (min {min(step_ms):.2f} max {max(step_ms):.2f}; "
          f"train_step alone median {tr['kernel_ms']:.2f}), samples/s {D1_BATCH / tr['steady'] * 1e3:.1f}, peak mem "
          f"{tr['peak_gib']:.2f} GiB; train losses {[round(x, 5) for x in tr['losses']]}, val losses (EMA) "
          f"{[round(x, 5) for x in tr['val_losses']]}; launches per step {D1_CALLS} K1 + {D1_CALLS} K2, 0 K3, in the "
          f"run {train_launches}; {len(snaps)} phema snapshots; reconstruct in {reconstruct_s:.2f} s, weight sums "
          f"{[round(x, 6) for x in sums]}; sample {D1_SAMPLES} images DDIM-{D1_STEPS} CFG {D1_GUIDANCE}, two requests: "
          f"generate {' and '.join(f'{ms:.1f}' for ms in requests)} ms, launches each {sample_launches}; PNG grid "
          f"{grid.shape}, pixels finite")
    return {"train": train_launches, "sample": sample_total, "step_ms": tr["steady"],
            "generate_ms": requests, "peak_gib": tr["peak_gib"]}


def phase_e1_kernels():
    """Phase 18a's kernels: the bf16 K1 and K2 instances at D=64 at slice
    E1's attention shape (the hard configs' DiT: B=128, S=256, H=8; K1 also
    at the distillation teacher's 2x batch), against their plain versions.
    K1 timed from CUDA-graph replays beside bf16 SDPA, its plain version and
    its bound at the bf16 peak; K2 beside its bound and SDPA's bf16 autograd
    backward (dq, dk and dv; its kernels summed by torch.profiler, as phases 5
    and 11 time it: a CUDA graph cannot capture autograd). The fp32 instances at
    E1's other shapes are phase 14a's (D=64: colorize, flow_repa, edm_repa)
    and phase 17a's (D=192, 384: ddpm_repa)."""
    import torch
    import torch.nn.functional as F

    from diffulab_tpu_torch.ops.fused_mha import fused_mha, fused_mha_bwd, fused_mha_bwd_reference, fused_mha_reference

    gen = torch.Generator(device="cuda").manual_seed(18)
    s, h, d = E1_SEQ, C1_HEADS, 64

    def rand(b):
        return torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()

    with torch.no_grad():
        q, k, v = rand(2 * E1_BATCH), rand(2 * E1_BATCH), rand(2 * E1_BATCH)
        teacher_err = check_close("E1 K1 bf16 B=256 o", fused_mha(q, k, v)[0], fused_mha_reference(q, k, v)[0],
                                  *TOL["bfloat16"])
        b = E1_BATCH
        q, k, v, do = q[:b], k[:b], v[:b], rand(b)
        o, lse = fused_mha(q, k, v)
        ro, rlse = fused_mha_reference(q, k, v)
        err = check_close("E1 K1 bf16 o", o, ro, *TOL["bfloat16"])
        check_close("E1 K1 bf16 lse", lse, rlse, *LSE_TOL)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        bound_ms, bound_by, mb, gflop = attention_bound(b, s, h, d, b * s, 2, mask=False)
        fwd = dict(max_abs_err=err, ms=cuda_graph_ms(lambda: fused_mha(q, k, v)),
                   plain_ms=cuda_time_ms(lambda: fused_mha_reference(q, k, v), iters=5),
                   library_ms=cuda_graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
                   bound_ms=bound_ms, bound_by=bound_by)
        bwd_err = check_grads("E1 K2 bf16", fused_mha_bwd(q, k, v, None, lse, do),
                              fused_mha_bwd_reference(q, k, v, None, lse, do), BWD_TOL["bfloat16"])
        bwd_ms = cuda_graph_ms(lambda: fused_mha_bwd(q, k, v, None, lse, do), calls=10, replays=5)
    with torch.enable_grad():
        leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves)
        dot = do.transpose(1, 2)
        sdpa_bwd_ms = profiled_kernels(lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True))[0]
        del out, leaves, dot, q, k, v, do, o, lse, ro, rlse, qt, kt, vt
    bytes_moved = 7 * b * s * h * d * 2 + b * s * h * 4
    flops = 10 * b * h * s * s * d
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    torch.cuda.synchronize()
    print(f"phase 18 kernels bf16 at the E1 shape (B={b} S={s} H={h} D={d}; device ms from CUDA-graph replays, bound "
          f"at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s and {PEAK_BYTES_PER_S / 1e12} TB/s): K1 max_abs_err "
          f"{fwd['max_abs_err']:.3e} (B={2 * b}: {teacher_err:.3e}) kernel {fwd['ms']:.4f} SDPA bf16 "
          f"{fwd['library_ms']:.4f} plain {fwd['plain_ms']:.4f} bound {fwd['bound_ms']:.4f} ({fwd['bound_by']}: "
          f"{mb:.1f} MB, {gflop:.2f} GFLOP); K2 max_abs_err {bwd_err:.3e} kernel {bwd_ms:.4f} SDPA bf16 backward "
          f"{sdpa_bwd_ms:.4f} (autograd's kernels summed by torch.profiler) bound "
          f"{max(t_bytes, t_ops) * 1e3:.4f} ({'bytes' if t_bytes >= t_ops else 'operations'}: "
          f"{bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); tol K1 atol {TOL['bfloat16'][0]} rtol "
          f"{TOL['bfloat16'][1]}, K2 {BWD_TOL['bfloat16']} * (max|ref| + |ref|)")
    bwd = dict(max_abs_err=bwd_err, ms=bwd_ms, library_ms=sdpa_bwd_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    return fwd, bwd


def _e1_overrides(config: str, root: Path) -> tuple[list[str], list[tuple[str, Any, Any]]]:
    """The E1 cuts of ``config`` as CLI overrides (and as (key, old, new) for the phase line)."""
    from diffulab_tpu_torch.config import compose_config
    from diffulab_tpu_torch.examples.train_diffusion import CONFIG_DIR

    cuts = [("trainer.n_epoch", compose_config(CONFIG_DIR, config)["trainer"]["n_epoch"], 1),
            *((key, old, new) for key, (old, new) in E1_DATA.items())]
    return [f"{key}={new}" for key, _, new in cuts] + [f"trainer.save_path={root}"], cuts


def _e1_instances(label: str, launches: dict, kind: str) -> None:
    """Every K1/K2 launch of a window ran the ``kind`` instances: "bf16"
    (D=64), "fp32" (D=64) or "unet" (fp32 at D=192, 5 a model call, and
    D=384, 6), by the instances' own counters."""
    for op in ("fwd", "bwd"):
        total, bf16 = launches[f"fused_mha_{op}"], launches[f"fused_mha_{op}_bf16"]
        by_dim = [launches[f"fused_mha_{op}_f32_d{d}"] for d, _, _ in D1_ATTN]
        ok = {"bf16": bf16 == total and not any(by_dim),
              "fp32": bf16 == 0 and not any(by_dim),
              "unet": bf16 == 0 and sum(by_dim) == total and by_dim[0] * 6 == by_dim[1] * 5}[kind]
        if not ok:
            fail(f"E1 {label}: {op} launches {launches}: every one expected on the {kind} instances")


def _e1_train(config: str, root: Path, log: Path, kind: str, extra=()):
    """One E1 config through train_diffusion (timed, launch counts per step)."""
    from diffulab_tpu_torch.examples import train_diffusion

    overrides, cuts = _e1_overrides(config, root)
    run = root / config.removeprefix("train_")
    tr = _timed_train_cli(train_diffusion.main, ["--config-name", config, *overrides, *extra], log, run, 1,
                          E1_STEPS_PER_EPOCH, config)
    expected = E1_RUNS[config][0]
    if tr["per_step"] != [expected] * tr["trainer"].step:
        fail(f"{config} train: kernel launches per step (K1, K2, K3) {sorted(set(tr['per_step']))}, expected {expected}")
    _e1_instances(f"{config} train", tr["launches"], kind)
    return {**tr, "overrides": overrides, "cuts": cuts, "run": run}


def _e1_request(config: str, ckpt: Path, out: Path, overrides, log: Path, expected_k1: int, kind: str, *flags):
    result = _sample_request(["--config-name", config, "--ckpt", str(ckpt), "--n", str(E1_SAMPLES), "--out",
                              str(out), *E1_RUNS[config][2], *flags, *overrides], log)
    got = result["launches"]
    if got["fused_mha_fwd"] != expected_k1 or got["fused_mha_bwd"] or got["flash_attn_fwd"]:
        fail(f"{config} sample: launches {got}, expected {expected_k1} K1 and no other")
    _e1_instances(f"{config} sample", got, kind)
    return result


def _e1_line(tr) -> str:
    cuts = ", ".join(f"{key} {old} -> {new}" for key, old, new in tr["cuts"])
    return (f"(cut: {cuts}): {tr['trainer'].step} steps in {tr['train_s']:.1f} s, ms/step start to start median after "
            f"the first two {tr['steady']:.2f} (min {min(tr['step_ms']):.2f} max {max(tr['step_ms']):.2f}; train_step "
            f"alone {tr['kernel_ms']:.2f}), samples/s {E1_BATCH / tr['steady'] * 1e3:.1f}, peak mem "
            f"{tr['peak_gib']:.2f} GiB, train loss {[round(x, 5) for x in tr['losses']]}, val loss "
            f"{[round(x, 5) for x in tr['val_losses']]}")


def phase_e1_hard(root: Path):
    """Phase 18a: train_synthetic_hard_flow (bf16) through train_diffusion,
    reconstruct_ema to phema_sr0.05, train_synthetic_hard_distill from that
    snapshot, then its post-hoc EMA reconstruction and a 16-image Euler-50
    request at CFG 1.5 from the distilled student, the labels and captions of
    the first 16 validation scenes; the samples' caption consistency
    (reported, not a gate). Every K1/K2 launch of the train runs (their
    validation images included) a bf16 instance; the request's fp32: the
    sample CLI builds the model without the trainer's precision, as the
    reference's examples/sample.py does."""
    import numpy as np

    from diffulab_tpu_torch.config import compose_config, instantiate
    from diffulab_tpu_torch.data.synthetic_txt2img import caption_consistency
    from diffulab_tpu_torch.examples import reconstruct_ema
    from diffulab_tpu_torch.examples.train_diffusion import CONFIG_DIR

    sys.modules["wandb"] = None
    log = root / "e1_hard.log"
    flow = _e1_train("train_synthetic_hard_flow", root, log, "bf16")
    _run_cli(reconstruct_ema.main, ["--run-dir", str(flow["run"]), "--sigma-rel", "0.05"], log)
    teacher = flow["run"] / "checkpoints" / "phema_sr0.05"
    distill = _e1_train("train_synthetic_hard_distill", root, log, "bf16", [f"trainer.distill_from={teacher}"])
    # each run's K1: the train steps, the validation batches (the distillation loss's teacher as in a
    # step) and one bf16 request, the validation images (8 of them, Euler-50 at CFG 4.0, one 2x call a step)
    val_batches = E1_DATA["dataset.val.n_samples"][1] // E1_BATCH
    for tr in (flow, distill):
        k1_step = E1_RUNS[f"train_{tr['run'].name}"][0][0]
        want = (E1_STEPS_PER_EPOCH + val_batches) * k1_step + 50 * C1_DEPTH
        if tr["launches"]["fused_mha_fwd_bf16"] != want:
            fail(f"{tr['run'].name}: {tr['launches']['fused_mha_fwd_bf16']} bf16 K1 in the run, expected {want} "
                 f"({E1_STEPS_PER_EPOCH} steps and {val_batches} validation batches of {k1_step}, and the "
                 f"validation images' {50 * C1_DEPTH})")
    _run_cli(reconstruct_ema.main, ["--run-dir", str(distill["run"]), "--sigma-rel", "0.05"], log)
    config = "train_synthetic_hard_distill"
    val = instantiate(compose_config(CONFIG_DIR, config, distill["overrides"])["dataset"]["val"])
    labels, captions = val.labels[:E1_SAMPLES], val.captions[:E1_SAMPLES]
    result = _e1_request(config, distill["run"] / "checkpoints" / "phema_sr0.05", root / "hard.png",
                         distill["overrides"], log, E1_RUNS[config][1], "fp32",
                         "--labels", ",".join(str(int(y)) for y in labels))
    images = result["images"]
    if images.shape != (E1_SAMPLES, 64, 64, 3):
        fail(f"{config} sample: images {images.shape}")
    consistency = caption_consistency(images * 2.0 - 1.0, captions)
    print(f"phase 18a hard_flow (bf16, DiT depth {C1_DEPTH} width 512, patch 4 on 64x64) {_e1_line(flow)}, "
          f"{C1_DEPTH} bf16 K1 + {C1_DEPTH} bf16 K2 a step, in the run {flow['launches']} (the validation images' "
          f"request {50 * C1_DEPTH} bf16 K1); hard_distill from its "
          f"phema_sr0.05 {_e1_line(distill)}, {2 * C1_DEPTH} bf16 K1 (the teacher's guided forward one 2x call) + "
          f"{C1_DEPTH} bf16 K2 a step, in the run {distill['launches']}; the student's phema_sr0.05: {E1_SAMPLES} "
          f"images Euler-50 CFG {E1_GUIDANCE} (fp32, as the reference's sample CLI builds the model) generate "
          f"{result['generate_ms']:.1f} ms, {result['launches']['fused_mha_fwd']} fp32 K1; caption "
          f"consistency against the first {E1_SAMPLES} validation captions (their labels asked; reported only) "
          f"{ {k: round(v, 3) for k, v in consistency.items()} }")
    return {"hard_flow": flow, "hard_distill": distill, "sample": result}


def phase_e1_colorize(root: Path):
    """Phase 18b: train_synthetic_colorize (fp32, the luma as x_context)
    through train_diffusion, one epoch, and a 16-image Euler-50 request
    conditioned on the validation images' luma."""
    sys.modules["wandb"] = None
    log = root / "e1_colorize.log"
    config = "train_synthetic_colorize"
    tr = _e1_train(config, root, log, "fp32")
    result = _e1_request(config, tr["run"] / "checkpoints" / "denoiser", root / "colorize.png", tr["overrides"], log,
                         E1_RUNS[config][1], "fp32")
    if result["images"].shape != (E1_SAMPLES, 32, 32, 3):
        fail(f"{config} sample: images {result['images'].shape}")
    print(f"phase 18b colorize (fp32, the C1 DiT on RGB + luma, gradient accumulation 2) {_e1_line(tr)}, "
          f"{C1_DEPTH} fp32 K1 + {C1_DEPTH} fp32 K2 a step; {E1_SAMPLES} images Euler-50 on the validation luma "
          f"generate {result['generate_ms']:.1f} ms, {result['launches']['fused_mha_fwd']} K1")
    return {"train": tr, "sample": result}


def _repa_step_on_both(config: str, overrides, run: Path):
    """One REPA compute_loss (train mode, capture on) of the run's best-val
    checkpoint on the card and on the host, the same weights, the first
    validation rows and the same t, noise and drop mask; and whether the
    card's FixedViT holds jax_prng's draw bit for bit. The extra losses are
    built (drawn) once, on the host, and copied to the card."""
    import copy

    import torch

    from diffulab_tpu_torch.config import compose_config, instantiate
    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.examples.train_diffusion import CONFIG_DIR
    from diffulab_tpu_torch.networks.nn import make_drop_mask
    from diffulab_tpu_torch.training.checkpoint import restore_train_modules
    from diffulab_tpu_torch.training.losses import build_extra_losses

    cfg = compose_config(CONFIG_DIR, config, overrides)
    batch = instantiate(cfg["dataset"]["val"]).get_batch(range(E1_CPU_BATCH))["model_inputs"]
    gen = torch.Generator(device="cuda").manual_seed(181)
    host_losses = build_extra_losses(cfg, device="cpu")
    fresh = {k: v.clone() for k, v in host_losses[0].repa_encoder.state_dict().items()}  # jax_prng's draw
    out, draws = {}, None
    for device in ("cuda", "cpu"):
        denoiser = instantiate(cfg["model"], device=device)
        losses = host_losses if device == "cpu" else [copy.deepcopy(loss).to(device) for loss in host_losses]
        restore_train_modules(run / "checkpoints" / "denoiser", denoiser, losses)
        d = cfg["diffuser"]
        diffuser = Diffuser(denoiser, d["sampling_method"], model_type=d["model_type"], n_steps=d["n_steps"],
                            extra_args=d.get("extra_args", {}), extra_losses=losses)
        losses[0].set_model(denoiser)
        if draws is None:
            x0 = torch.as_tensor(batch["x"], device="cuda")
            draws = (x0, torch.as_tensor(batch["y"], device="cuda"), diffuser.draw_timesteps(gen, E1_CPU_BATCH),
                     torch.randn(x0.shape, generator=gen, device="cuda"), make_drop_mask(gen, 0.1, E1_CPU_BATCH))
            held = losses[0].repa_encoder.state_dict()  # the checkpoint's, as restored on the card
            vit_equal = set(fresh) == set(held) and all(torch.equal(held[k].cpu(), fresh[k]) for k in fresh)
        x0, y, t, noise, drop = (a.to(device) for a in draws)
        with torch.no_grad():
            out[device] = {k: float(v) for k, v in diffuser.compute_loss(x0, {"y": y}, t, noise, drop=drop).items()}
        del denoiser, diffuser
    torch.cuda.empty_cache()
    return out["cuda"], out["cpu"], vit_equal


def phase_e1_repa(root: Path):
    """Phase 18c: train_synthetic_{flow,edm,ddpm}_repa through train_diffusion
    (one epoch each; the REPA loss beside the diffusion loss, the seed-4321
    FixedViT as the frozen target), then a sample request through ``sample``
    with the run's checkpoint restored with its extra losses; one REPA
    compute_loss recomputed on the host with the same weights, rows and
    draws (rtol E1_LOSS_RTOL a loss entry); the card's FixedViT against
    jax_prng's draw, bit for bit."""
    sys.modules["wandb"] = None
    log = root / "e1_repa.log"
    results = {}
    for config, kind in (("train_synthetic_flow_repa", "fp32"), ("train_synthetic_edm_repa", "fp32"),
                         ("train_synthetic_ddpm_repa", "unet")):
        tr = _e1_train(config, root, log, kind)
        rows = [json.loads(line) for line in (tr["run"] / "metrics.jsonl").read_text().splitlines()]
        repa = {key: [r[key] for r in rows if key in r] for key in ("train/RepaLoss", "val/RepaLoss")}
        if any(len(v) != 1 or not math.isfinite(v[0]) for v in repa.values()):
            fail(f"{config} train: REPA loss rows {repa}")
        expected = edm_k1("heun", C2_STEPS, C1_DEPTH) if "edm" in config else E1_RUNS[config][1]
        result = _e1_request(config, tr["run"] / "checkpoints" / "denoiser", root / f"{config}.png", tr["overrides"],
                             log, expected, kind, "--labels", ",".join(str(i) for i in range(10)))
        card, host, vit_equal = _repa_step_on_both(config, tr["overrides"], tr["run"])
        worst = max(abs(card[k] - host[k]) / abs(host[k]) for k in host)
        if set(card) != {"loss", "RepaLoss"} or set(host) != set(card) or worst > E1_LOSS_RTOL:
            fail(f"{config}: the card's loss dict {card} against the host's {host} (rtol {E1_LOSS_RTOL})")
        if not vit_equal:
            fail(f"{config}: the card's FixedViT differs from jax_prng's draw of seed 4321")
        per_step = E1_RUNS[config][0]
        print(f"phase 18c {config.removeprefix('train_synthetic_')} ({'D1 UNet' if kind == 'unet' else 'C1 DiT'}, fp32, "
              f"FixedViT seed 4321) {_e1_line(tr)}, RepaLoss train {repa['train/RepaLoss'][0]:.5f} val "
              f"{repa['val/RepaLoss'][0]:.5f}, {per_step[0]} K1 + {per_step[1]} K2 a step "
              + ("(5 at D=192, 6 at D=384)" if kind == "unet" else "(D=64)")
              + f"; sample {E1_SAMPLES} images CFG {E1_GUIDANCE} from the restored checkpoint generate "
              f"{result['generate_ms']:.1f} ms, {result['launches']['fused_mha_fwd']} K1; one loss dict on the card "
              f"{ {k: round(v, 6) for k, v in card.items()} } vs the host {'{'}"
              + ", ".join(f"'{k}': {v:.6f}" for k, v in host.items())
              + f"{'}'} (B={E1_CPU_BATCH}, worst rel {worst:.2e}, rtol {E1_LOSS_RTOL}); FixedViT on the card bitwise "
              f"jax_prng's draw")
        results[config] = {"train": tr, "sample": result, "card": card, "host": host}
    return results


#: the keys of phase 14a's results that its JSON rows carry
C1_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def d2_mask(kind: str, b: int, tokens: int):
    """[b, 128] key mask: the UNet's padding mask (its first ``tokens`` keys);
    or ``"hole"``: batch row 0 with keys 8-15 masked and as many valid keys
    after them (an empty 8-key tile between live ones), row 1 fully masked,
    the others padded."""
    import torch

    keys = torch.arange(D2_PADDED, device="cuda")
    mask = (keys < tokens)[None].expand(b, -1).clone()
    if kind == "hole":
        mask[0] = (keys < 8) | ((keys >= 16) & (keys < tokens + 8))
        mask[1] = False
    return mask


def d2_bounds(b: int, tokens: int, h: int, d: int, backward: bool, padded: bool) -> dict[str, Any]:
    """The bound of one fp32 K1 (or, ``backward``, K2) call at the MNIST
    UNet's shape, keys padded to 128, at 3xTF32 (:func:`padded_bounds`)."""
    return padded_bounds(b, tokens, D2_PADDED, h, d, backward, padded)


def padded_bounds(b: int, tokens: int, s: int, h: int, d: int, backward: bool, padded: bool, elem: int = 4,
                  peak_flops: float = PEAK_TF32_FLOPS, passes: int = 3, valid_keys=None) -> dict[str, Any]:
    """The bound of one K1 (or, ``backward``, K2) call on ``tokens`` valid
    query rows a sample and keys padded to ``s``, at ``passes`` products of
    ``peak_flops`` (fp32: 3xTF32; bf16: one pass at the bf16 peak) and 3.35
    TB/s, elements of ``elem`` bytes. ``valid_keys[i]``: the keys sample i
    attends where a key mask varies by sample (default ``tokens`` each). The
    valid rows of q and o (K2: q, do and dq), the valid keys of k and v (K2:
    and of dk and dv, the gradients the route keeps: its pad's backward
    drops the padded keys'), lse over the valid rows, the mask, and the
    products over each sample's valid rows and keys; ``padded``: the padded
    contract, q and o (do, dq), lse, dk and dv over the ``s`` padded rows
    (the zero rows the kernel writes included) and the products over the
    padded rows and valid keys."""
    rows = s if padded else tokens
    keys = b * tokens if valid_keys is None else int(sum(valid_keys))
    if backward:
        elems = (3 * b * rows + 2 * keys + 2 * (b * rows if padded else keys)) * h * d
        flops = 10 * h * d * rows * keys
    else:
        elems = (2 * b * rows + 2 * keys) * h * d
        flops = 4 * h * d * rows * keys
    bytes_moved = elems * elem + b * rows * h * 4 + b * s * 4
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, passes * flops / peak_flops
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
                mb=bytes_moved / 1e6, gflop=flops / 1e9)


def valid_rows_kernels(tag: str, attn, b: int, h: int, seed: int, sample_batch: int | None = None):
    """The fp32 K1 and K2 instances built around the valid rows at the head
    dims and token counts of ``attn`` against their plain versions, as the
    fused route hands them over: the unpadded query rows, k, v and the
    padding mask at 128 keys. First two edge cases each (an empty key tile
    between live ones beside a fully masked row: o = 0, lse = +inf and zero
    gradients there; a ragged Sq). Then each kernel timed from CUDA-graph
    replays at batch ``b`` (K1 also at ``sample_batch``) beside fp32 SDPA on
    the same inputs (the yardstick), on the padded q, k, v with the mask, and
    on the unpadded q, k, v; SDPA's backward as its memory-efficient backward
    op (:func:`sdpa_fp32_backward`); the plain version's time; two bounds
    (:func:`d2_bounds`). Returns (results by ``{fwd,bwd}_d{D}`` and, at
    ``sample_batch``, ``fwd_d{D}_b{B}``; the edge cases' errors)."""
    import torch
    import torch.nn.functional as F

    from diffulab_tpu_torch.ops.fused_mha import (
        fused_mha,
        fused_mha_bwd,
        fused_mha_bwd_reference,
        fused_mha_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    s = D2_PADDED
    results, edges = {}, {}
    for d, tokens, _ in attn:
        def rand(bb, n):
            return torch.randn(bb, n, h, d, generator=gen, device="cuda", dtype=torch.float32)

        for label, sq, mask in (("hole", tokens, d2_mask("hole", b, tokens)),
                                ("ragged", tokens // 2 + 5, d2_mask("padded", b, tokens))):
            q, k, v, do = rand(b, sq), rand(b, s), rand(b, s), rand(b, sq)
            with torch.no_grad():
                o, lse = fused_mha(q, k, v, mask)
                ro, rlse = fused_mha_reference(q, k, v, mask)
                err = check_close(f"{tag} K1 fp32 D={d} {label} o", o, ro, *TOL["float32"])
                check_close(f"{tag} K1 fp32 D={d} {label} lse", lse, rlse, *LSE_TOL)
                grads = fused_mha_bwd(q, k, v, mask, lse, do)
                bwd_err = check_grads(f"{tag} K2 fp32 D={d} {label}", grads,
                                      fused_mha_bwd_reference(q, k, v, mask, lse, do), BWD_TOL["float32"])
            if label == "hole" and (bool(o[1].any()) or not bool((lse[1] == math.inf).all())
                                    or any(bool(g[1].any()) for g in grads)):
                fail(f"{tag} D={d}: the fully masked row's o {float(o[1].abs().max())}, lse {lse[1].min().item()}, "
                     "gradients not 0, +inf and 0")
            edges[f"d{d}_{label}_sq{sq}"] = (err, bwd_err)

        for bb in (b,) if sample_batch is None else (b, sample_batch):
            key = f"d{d}" if bb == b else f"d{d}_b{bb}"
            mask = d2_mask("padded", bb, tokens)
            q, k, v, do = rand(bb, tokens), rand(bb, s), rand(bb, s), rand(bb, tokens)
            qp, dop = (F.pad(t, (0, 0, 0, 0, 0, s - tokens)) for t in (q, do))  # the padded route's q and do
            kv = [t[:, :tokens].contiguous() for t in (k, v)]  # the unpadded keys
            attn_mask = mask[:, None, None, :]
            qt, kt, vt, qpt = (t.transpose(1, 2) for t in (q, k, v, qp))
            kvt = [t.transpose(1, 2) for t in kv]
            with torch.no_grad():
                o, lse = fused_mha(q, k, v, mask)
                ro, rlse = fused_mha_reference(q, k, v, mask)
                err = check_close(f"{tag} K1 fp32 D={d} B={bb} o", o, ro, *TOL["float32"])
                check_close(f"{tag} K1 fp32 D={d} B={bb} lse", lse, rlse, *LSE_TOL)
                sdpa_err = float((F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask).transpose(1, 2)
                                  - ro).abs().max())
                results[f"fwd_{key}"] = dict(
                    max_abs_err=err, sdpa_err=sdpa_err, ms=cuda_graph_ms(lambda: fused_mha(q, k, v, mask)),
                    plain_ms=cuda_time_ms(lambda: fused_mha_reference(q, k, v, mask), iters=5),
                    library_ms=cuda_graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask)),
                    sdpa_padded_ms=cuda_graph_ms(
                        lambda: F.scaled_dot_product_attention(qpt, kt, vt, attn_mask=attn_mask)),
                    sdpa_unpadded_ms=cuda_graph_ms(lambda: F.scaled_dot_product_attention(qt, *kvt)),
                    **d2_bounds(bb, tokens, h, d, False, False),
                    padded=d2_bounds(bb, tokens, h, d, False, True))
                if bb == b:
                    refs = fused_mha_bwd_reference(q, k, v, mask, lse, do)
                    err = check_grads(f"{tag} K2 fp32 D={d}", fused_mha_bwd(q, k, v, mask, lse, do), refs,
                                      BWD_TOL["float32"])
                    sdpa_bwd = sdpa_fp32_backward(q, k, v, do, mask)
                    op_grads = [g.transpose(1, 2) for g in sdpa_bwd()]
                    sdpa_err = max(float((g - r).abs().max()) for g, r in zip(op_grads, refs))
                    with torch.enable_grad():  # the timed op computes what SDPA's autograd does with the mask
                        leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
                        out = F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask)
                        sdpa_grads = torch.autograd.grad(out, leaves, do.transpose(1, 2))
                        check_grads(f"{tag} SDPA fp32 backward op D={d} vs its autograd", op_grads,
                                    [g.transpose(1, 2) for g in sdpa_grads], BWD_TOL["float32"])
                        del out, sdpa_grads, op_grads
                    results[f"bwd_{key}"] = dict(
                        max_abs_err=err, sdpa_err=sdpa_err,
                        ms=cuda_graph_ms(lambda: fused_mha_bwd(q, k, v, mask, lse, do), calls=10, replays=5),
                        plain_ms=cuda_time_ms(lambda: fused_mha_bwd_reference(q, k, v, mask, lse, do), iters=3),
                        library_ms=cuda_graph_ms(sdpa_bwd, calls=10, replays=5),
                        sdpa_padded_ms=cuda_graph_ms(sdpa_fp32_backward(qp, k, v, dop, mask), calls=10, replays=5),
                        sdpa_unpadded_ms=cuda_graph_ms(sdpa_fp32_backward(q, *kv, do), calls=10, replays=5),
                        **d2_bounds(bb, tokens, h, d, True, False),
                        padded=d2_bounds(bb, tokens, h, d, True, True))
                    del refs, sdpa_bwd
            del q, k, v, do, qp, dop, kv, o, lse, ro, rlse
    torch.cuda.synchronize()
    return results, edges


#: how :func:`valid_rows_kernels` measures, for the lines of phases 17a and 19a
VALID_ROWS_TIMING = (f"device ms from CUDA-graph replays; SDPA fp32 on the same inputs, on the padded q/k/v with the "
                     f"mask, and on the unpadded q/k/v, its backward as its memory-efficient backward op (held to "
                     f"SDPA's autograd); bounds at 3xTF32 = {PEAK_TF32_FLOPS / 1e12:.0f}/3 TFLOP/s and "
                     f"{PEAK_BYTES_PER_S / 1e12} TB/s over the valid rows and keys, and over the padded contract's "
                     f"{D2_PADDED} rows")


def valid_rows_line(results, edges) -> str:
    """The edge cases and timings of :func:`valid_rows_kernels` as text."""
    return ("edge cases (max_abs_err K1 o, K2) "
            + ", ".join(f"{key} {e1:.3e} {e2:.3e}" for key, (e1, e2) in edges.items()) + "; "
            + "; ".join(f"{key} max_abs_err {r['max_abs_err']:.3e} (SDPA's {r['sdpa_err']:.3e}) kernel {r['ms']:.4f} "
                        f"SDPA fp32 {r['library_ms']:.4f} (padded {r['sdpa_padded_ms']:.4f}, unpadded "
                        f"{r['sdpa_unpadded_ms']:.4f}) plain {r['plain_ms']:.4f} bound {r['bound_ms']:.4f} "
                        f"({r['bound_by']}: {r['mb']:.1f} MB, {r['gflop']:.2f} GFLOP), padded "
                        f"{r['padded']['bound_ms']:.4f} ({r['padded']['bound_by']}: {r['padded']['mb']:.1f} MB)"
                        for key, r in results.items())
            + f"; tol K1 atol {TOL['float32'][0]} rtol {TOL['float32'][1]}, K2 {BWD_TOL['float32']} * "
              "(max|ref| + |ref|)")


def phase_d2_kernels():
    """Phase 19a: the fp32 K1 and K2 instances at head dims 256 and 512 (the
    MNIST UNet's: 64 and 16 tokens, keys padded to 128, B=128, H=2) against
    their plain versions, as the fused route hands them over, with the edge
    cases, timings and bounds of :func:`valid_rows_kernels`."""
    results, edges = valid_rows_kernels("D2", D2_ATTN, D2_BATCH, D2_HEADS, 19)
    print(f"phase 19 kernels fp32 at the MNIST UNet's attention shapes (B={D2_BATCH}, H={D2_HEADS}, the unpadded "
          f"query rows, keys padded to {D2_PADDED} with the padding mask; {VALID_ROWS_TIMING}): "
          + valid_rows_line(results, edges))
    return results


def _d2_unet(config: str, seed: int):
    """The config's UNet at full width, seeded noise in every parameter (its
    out convs are zero-initialised), on the card."""
    from diffulab_tpu_torch.config import compose_config, instantiate
    from diffulab_tpu_torch.examples.train_diffusion import CONFIG_DIR

    model = instantiate(compose_config(CONFIG_DIR, config)["model"], device="cuda")
    randomize_(model, seed)
    return model


def _d2_instances(launches: dict, label: str) -> None:
    """Every K1 and K2 launch of a run an instance at D=256 (5 a model call)
    or D=512 (6), by their own counters, and no other attention kernel."""
    for kind in ("fwd", "bwd"):
        by_dim = [launches[f"fused_mha_{kind}_f32_d{d}"] for d, _, _ in D2_ATTN]
        if sum(by_dim) != launches[f"fused_mha_{kind}"] or by_dim[0] * 6 != by_dim[1] * 5:
            fail(f"D2 {label}: {kind} launches {launches}: every one an instance at D=256 (5 a model call) "
                 "or D=512 (6)")
    if any(launches[key] for key in ("flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq")):
        fail(f"D2 {label}: flash launches {launches}")


def phase_d2_model():
    """Phase 19b: the MNIST UNet at full width (276.7M parameters), fp32:
    one forward at B=32 and the parameter gradients of one epsilon loss at
    B=16, each on the kernel path against the same model with the plain
    attention (``impl="xla"``), the launch counts set to 0 just before and
    read just after: 11 K1 a forward (5 at D=256, 6 at D=512), 11 K2 a
    backward."""
    import functools

    import torch

    import diffulab_tpu_torch.networks.denoisers.unet as unet_mod
    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.ops import dot_product_attention

    model = _d2_unet("train_mnist_ddpm", 191)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != D2_PARAMS:
        fail(f"D2 UNet: {n_params} parameters, expected {D2_PARAMS}")
    gen = torch.Generator(device="cuda").manual_seed(192)

    def both_paths(fn):
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launched = launch_counts()
        unet_mod.dot_product_attention = functools.partial(dot_product_attention, impl="xla")
        try:
            ref = fn()
        finally:
            unet_mod.dot_product_attention = dot_product_attention
        return out, ref, launched

    b = 32
    x = torch.randn(b, 32, 32, 1, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    y = torch.randint(0, 10, (b,), generator=gen, device="cuda")
    with torch.no_grad():
        out, ref, fwd = both_paths(lambda: model(x, t, {"y": y})["x"])
    rel = float((out - ref).abs().max() / ref.abs().max())
    want = {"fused_mha_fwd": D2_CALLS, "fused_mha_fwd_f32_d256": 5, "fused_mha_fwd_f32_d512": 6, "fused_mha_bwd": 0}
    if not bool(torch.isfinite(out).all()) or rel > 1e-4 or any(fwd[k] != v for k, v in want.items()):
        fail(f"D2 UNet forward: rel err {rel:.3e} (tol 1e-4), launches {fwd}, expected {want}")

    gb = 16
    diffuser = Diffuser(model, "ddpm", model_type="gaussian_diffusion")
    x0, noise = (torch.randn(gb, 32, 32, 1, generator=gen, device="cuda") for _ in range(2))
    t, y = torch.randint(0, 1000, (gb,), generator=gen, device="cuda"), y[:gb]

    def grads():
        model.zero_grad(set_to_none=True)
        diffuser.compute_loss(x0, {"y": y}, t, noise)["loss"].backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    ours, plain, bwd = both_paths(grads)
    worst = max(float((ours[n] - plain[n]).norm() / plain[n].norm().clamp_min(1e-30)) for n in plain
                if float(plain[n].norm()) > 0)
    want = {"fused_mha_fwd": D2_CALLS, "fused_mha_bwd": D2_CALLS, "fused_mha_bwd_f32_d256": 5,
            "fused_mha_bwd_f32_d512": 6}
    if worst > 1e-3 or any(bwd[k] != v for k, v in want.items()):
        fail(f"D2 UNet gradients: worst per-parameter rel err {worst:.3e} (tol 1e-3), launches {bwd}")
    model.zero_grad(set_to_none=True)
    del model, diffuser, ours, plain
    torch.cuda.empty_cache()
    print(f"phase 19 D2 MNIST UNet ({n_params} parameters, fp32, in_channels 1, no CFG null class) forward B={b}: "
          f"kernel path vs plain attention max rel err {rel:.3e} (tol 1e-4), launches "
          f"{fwd['fused_mha_fwd_f32_d256']} K1 D=256 + {fwd['fused_mha_fwd_f32_d512']} K1 D=512; epsilon-loss "
          f"gradients B={gb}: worst per-parameter ||kernel - plain|| / ||plain|| {worst:.3e} (tol 1e-3), "
          f"{bwd['fused_mha_bwd']} K2 ({bwd['fused_mha_bwd_f32_d256']} at D=256, {bwd['fused_mha_bwd_f32_d512']} "
          "at D=512)")


def write_mnist(root: Path, seed: int = 0) -> None:
    """MNIST idx files of D2_IMAGES' cut sizes from a seed (valid idx
    headers, uniform uint8 pixels and labels): no download."""
    import struct

    import numpy as np

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for prefix, (_, n) in D2_IMAGES.items():
        with open(root / f"{prefix}-images-idx3-ubyte", "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28))
            f.write(rng.integers(0, 256, (n, 28, 28), dtype=np.uint8).tobytes())
        with open(root / f"{prefix}-labels-idx1-ubyte", "wb") as f:
            f.write(struct.pack(">II", 2049, n))
            f.write(rng.integers(0, 10, n, dtype=np.uint8).tobytes())


def phase_d2_cli(root: Path):
    """Phase 19c: both MNIST configs through the port's CLIs, in process,
    under ``root``, on idx files written from a seed: train_diffusion (the
    validation grid of 8 images by the config's sampler at val_steps 50
    every epoch) and two sample requests of 16 images at 50 steps (DDPM
    ancestral for the Gaussian config, Euler for the flow one) from the EMA
    checkpoint. The counts are set to 0 just before the training and read at
    each train step (11 K1 + 11 K2), and set to 0 again just before each
    request (550 K1); every K1 and K2 launch of these runs an instance at
    D=256 or D=512 by their own counters."""
    import numpy as np
    from PIL import Image

    from diffulab_tpu_torch.examples import train_diffusion

    sys.modules["wandb"] = None
    data = root / "mnist"
    write_mnist(data)
    log = root / "d2.log"
    n_epochs = D2_CUTS["trainer.n_epoch"][1]
    steps_per_epoch = D2_IMAGES["train"][1] // D2_BATCH
    cuts = ", ".join([f"{key} {old} -> {new}" for key, (old, new) in D2_CUTS.items()]
                     + [f"{prefix} images {old} -> {new}" for prefix, (old, new) in D2_IMAGES.items()])
    results = {}
    for config, (project, sampler) in D2_CONFIGS.items():
        overrides = [f"{key}={new}" for key, (_, new) in D2_CUTS.items()] + [
            f"dataset.train.data_path={data}", f"dataset.val.data_path={data}", f"trainer.save_path={root}"]
        run = root / project
        tr = _timed_train_cli(train_diffusion.main, ["--config-name", config, *overrides], log, run, n_epochs,
                              steps_per_epoch, f"D2 {config}")
        if tr["per_step"] != [(D2_CALLS, D2_CALLS, 0)] * tr["trainer"].step:
            fail(f"D2 {config} train: kernel launches per step (K1, K2, K3) {sorted(set(tr['per_step']))}, "
                 f"expected ({D2_CALLS}, {D2_CALLS}, 0) each")
        _d2_instances(tr["launches"], f"{config} train")
        out = root / f"{project}_samples.png"
        requests, sample_total = [], {}
        for seed in (0, 1):  # the first request's time includes the process's first calls at its shapes
            result = _sample_request(["--config-name", config, "--ckpt", str(run / "checkpoints" / "ema"), "--n",
                                      str(D2_SAMPLES), "--labels", ",".join(str(i) for i in range(10)), "--steps",
                                      str(D2_STEPS), "--seed", str(seed), "--out", str(out), *overrides], log)
            launches = result["launches"]
            if launches["fused_mha_fwd"] != D2_STEPS * D2_CALLS or launches["fused_mha_bwd"]:
                fail(f"D2 {config} sample: launches {launches}, expected {D2_STEPS * D2_CALLS} K1 and no K2")
            _d2_instances(launches, f"{config} sample")
            requests.append(result["generate_ms"])
            sample_total = {key: sample_total.get(key, 0) + n for key, n in launches.items()}
        grid = np.asarray(Image.open(out))
        if result["images"].shape != (D2_SAMPLES, 32, 32, 1) or grid.shape != (2 + 2 * 34, 2 + 8 * 34):
            fail(f"D2 {config} sample: images {result['images'].shape}, grid {grid.shape}")
        step_ms = tr["step_ms"]
        print(f"phase 19 CLIs {config} (cut: {cuts}; else the config's: batch {D2_BATCH}, gradient accumulation 2, "
              f"fp32, UNet model_channels 128 channel_mult 1,2,4,8, {D2_HEADS} heads, {sampler}-{D2_STEPS} "
              f"validation): train {tr['trainer'].step} steps in {tr['train_s']:.1f} s, ms/step start to start "
              f"median after the first two {tr['steady']:.2f} (min {min(step_ms):.2f} max {max(step_ms):.2f}; "
              f"train_step alone median {tr['kernel_ms']:.2f}), samples/s {D2_BATCH / tr['steady'] * 1e3:.1f}, peak "
              f"mem {tr['peak_gib']:.2f} GiB; train losses {[round(x, 5) for x in tr['losses']]}, val losses (EMA) "
              f"{[round(x, 5) for x in tr['val_losses']]}; launches per step {D2_CALLS} K1 + {D2_CALLS} K2, 0 K3, "
              f"in the run {tr['launches']}; sample {D2_SAMPLES} images {sampler}-{D2_STEPS} from the EMA "
              f"checkpoint, two requests: generate {' and '.join(f'{ms:.1f}' for ms in requests)} ms, launches each "
              f"{launches}; PNG grid {grid.shape}, pixels finite")
        results[config] = {"train": tr["launches"], "sample": sample_total, "step_ms": tr["steady"],
                           "generate_ms": requests, "peak_gib": tr["peak_gib"]}
    return results


def padded_keys(n: int) -> int:
    """The fused route's padded length of ``n`` keys (MIN_BLOCK = 128)."""
    return -(-n // 128) * 128


def f1_deep_kernels():
    """Phase 20's kernels: the bf16 K3, K4 and K5 at the txt2img SprintDiT's
    deep-path shape in training (B=8, 128 text + 1024 kept image tokens =
    1152, H=12, D=64, the training text mask), by :func:`flash_kernel_rows`."""
    import torch

    b, h = TXT_TRAIN_BATCH, TXT["num_heads"]
    image = TXT_LATENT[0] * TXT_LATENT[1] // 4  # int(4096 * 0.25) kept
    lengths = torch.tensor(TRAIN_TEXT_LENGTHS, device="cuda")
    lengths[list(TRAIN_DROPPED)] = NULL_SEQ_LEN
    mask = torch.cat([torch.arange(TEXT_LEN, device="cuda")[None, :] < lengths[:, None],
                      torch.ones(b, image, dtype=torch.bool, device="cuda")], dim=1)
    return flash_kernel_rows("phase 20 kernels bf16 at the txt2img SprintDiT's deep shape in training", "F1 deep",
                             h, mask, seed=23, shape=f"B={b} S={TEXT_LEN + image} (128 text + {image} kept image "
                                                         f"tokens) H={h} D=64 bf16, the training text mask")


def flash_kernel_rows(line: str, label: str, h: int, mask, seed: int, shape: str) -> dict[str, Any]:
    """The bf16 K3, K4 and K5 at D=64, H=``h`` and the key mask ``mask``
    (bool [B, S] on the card, True = attend; S query rows and keys a sample)
    against their plain versions on inputs drawn from ``seed``, each timed
    from CUDA-graph replays beside its bound and masked SDPA (the backward:
    SDPA's bf16 autograd backward, its kernels summed by torch.profiler, dq,
    dk and dv together, as phase 11 times it); prints one line starting with
    ``line``. Returns the three rows by kernel name."""
    import torch
    import torch.nn.functional as F

    from diffulab_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    (b, s), d = mask.shape, 64
    scale = d ** -0.5
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16() for _ in range(4))
    out = {}
    with torch.no_grad():
        o, lse = flash_attention(q, k, v, mask)
        ro, rlse = flash_attention_reference(q, k, v, mask)
        fwd_err = check_close(f"{label} K3 bf16 o", o, ro, *TOL["bfloat16"])
        check_close(f"{label} K3 bf16 lse", lse, rlse, *LSE_TOL)
        grads = flash_attention_bwd(q, k, v, mask, o, lse, do)
        refs = flash_attention_bwd_reference(q, k, v, mask, o, lse, do)
        errs = {name: check_grads(f"{label} bf16 {name}", [g], [r], BWD_TOL["bfloat16"])
                for name, g, r in zip(("dq", "dk", "dv"), grads, refs)}
        del grads, refs
        _, _, di = flash_attention_bwd_dkv(q, k, v, mask, o, lse, do, scale)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_mask = mask[:, None, None, :]
        out["flash_attn_fwd"] = dict(
            max_abs_err=fwd_err, ms=cuda_graph_ms(lambda: flash_attention(q, k, v, mask), calls=10, replays=5),
            plain_ms=cuda_time_ms(lambda: flash_attention_reference(q, k, v, mask), iters=2, warmup=1),
            library_ms=cuda_graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask),
                                     calls=10, replays=5))
        out["flash_attn_bwd_dkv"] = dict(
            max_abs_err=max(errs["dk"], errs["dv"]),
            ms=cuda_graph_ms(lambda: flash_attention_bwd_dkv(q, k, v, mask, o, lse, do, scale), calls=10, replays=5))
        out["flash_attn_bwd_dq"] = dict(
            max_abs_err=errs["dq"],
            ms=cuda_graph_ms(lambda: flash_attention_bwd_dq(q, k, v, mask, lse, di, do, scale), calls=10, replays=5))
        bwd_plain = cuda_time_ms(lambda: flash_attention_bwd_reference(q, k, v, mask, o, lse, do), iters=2, warmup=1)
    with torch.enable_grad():
        leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask)
        dot = do.transpose(1, 2)
        sdpa_bwd = profiled_kernels(lambda: torch.autograd.grad(sdpa_out, leaves, dot, retain_graph=True))[0]
        del sdpa_out, leaves
    valid = int(mask.sum())
    bounds = {"flash_attn_fwd": attention_bound(b, s, h, d, valid, 2), **flash_bwd_bounds(b, s, h, d, valid, 2)}
    for name in FLASH_KERNELS[1:]:
        out[name].update(plain_ms=bwd_plain, library_ms=sdpa_bwd)
    for name, (bound_ms, bound_by, mb, gflop) in bounds.items():
        out[name].update(bound_ms=bound_ms, bound_by=bound_by, mb=mb, gflop=gflop, shape=shape)
    del q, k, v, do, o, lse, ro, rlse, di, qt, kt, vt
    torch.cuda.synchronize()
    print(f"{line} ({shape}; device ms from CUDA-graph replays; library: masked SDPA, its backward SDPA's bf16 "
          f"autograd backward summed by torch.profiler, dq, dk and dv together; plain: wall ms, the backward K4 and "
          f"K5 together): "
          + "; ".join(f"{name} max_abs_err {r['max_abs_err']:.3e} kernel {r['ms']:.4f} library {r['library_ms']:.4f} "
                      f"plain {r['plain_ms']:.2f} bound {r['bound_ms']:.4f} ({r['bound_by']}: {r['mb']:.1f} MB, "
                      f"{r['gflop']:.1f} GFLOP)" for name, r in out.items())
          + f"; tol K3 atol {TOL['bfloat16'][0]} rtol {TOL['bfloat16'][1]}, K4/K5 {BWD_TOL['bfloat16']} * "
            "(max|ref| + |ref|)")
    return out


def phase_f1_txt2img_sprint():
    """Phase 20: the txt2img SprintDiT (F1_TXT_CONFIG's model block, bf16,
    seeded weights; txt2img_context's embedder, tower and prompts): (a) a
    forward at the fused-CFG batch of 8 against its plain-attention twin,
    12 K3 at 4224 tokens; (b) F1_TXT_REQUESTS 4-prompt Euler-50 requests
    with fused CFG 4.0, shift 4.63 and the Flux2 decode, 600 K3 each, the
    null half's deep output all mask tokens at every step (path drop);
    (c) the gradients of one loss at batch 2 against the plain twin, the
    same token drop on both (generators of one seed): 4 K3, K4 and K5 at
    4224 tokens and 8 at 1152; (d) BaseTrainer.train at batch 8 over phase
    13's shards, both buckets: per step 12 K3, K4 and K5, 4 at 4224 / 3968
    tokens and 8 at 1152 / 1088 (the deep path's kept 1024 / 960 and the
    text); then its deep-path kernels (:func:`f1_deep_kernels`). Each count
    window set to 0 just before and read just after."""
    import torch

    from diffulab_tpu_torch.config import compose_config, instantiate
    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.diffuse.flow import _tree_cat2
    from diffulab_tpu_torch.examples.train_diffusion import CONFIG_DIR
    from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiTBlock, MMDiTSingleStreamBlock

    cfg = compose_config(CONFIG_DIR, F1_TXT_CONFIG)
    embedder, tower, cond = txt2img_context()
    kw = dict(context_embedder=embedder, dtype=torch.bfloat16)  # the config's precision_type bf16
    model = instantiate(cfg["model"], **kw).eval()
    randomize_(model, seed=20)
    plain = instantiate({**cfg["model"], "attention_impl": "xla"}, **kw).eval()
    plain.load_state_dict(model.state_dict(), strict=True)
    encoder, deep, decoder = (len(m) for m in (model.layers, model.deep_layers, model.decoder_layers))
    if (encoder, deep, decoder) != (2, 8, 2) or not all(isinstance(m, MMDiTSingleStreamBlock)
                                                         for m in model.deep_layers) \
            or not all(isinstance(m, MMDiTBlock) for m in (*model.layers, *model.decoder_layers)):
        fail(f"txt2img SprintDiT: blocks {encoder} + {deep} + {decoder}, expected 2 dual + 8 single-stream + 2 dual")
    blocks = encoder + deep + decoder
    windows: dict[str, dict[str, int]] = {}

    # (a) the eval forward: every block at the full length, nothing dropped
    gen = torch.Generator(device="cuda").manual_seed(20)
    b = 2 * TXT_BATCH
    x = torch.randn(b, *TXT_LATENT, generator=gen, device="cuda")
    t = torch.rand(b, generator=gen, device="cuda")
    cond2 = _tree_cat2(cond)
    drop = torch.arange(b, device="cuda") >= TXT_BATCH
    with torch.no_grad():
        reset_launch_counts()
        out = model(x, t, cond2, drop)["x"]
        fwd_keys = launch_keys()
        ref = plain(x, t, cond2, drop)["x"]
    torch.cuda.synchronize()
    rel = float((out.float() - ref.float()).abs().max() / ref.float().abs().max())
    if out.shape != (b, *TXT_LATENT) or not bool(torch.isfinite(out).all()) or rel > TXT_REL_TOL \
            or fwd_keys != {("flash_attn_fwd", "bfloat16", TXT_SEQ): blocks}:
        fail(f"txt2img SprintDiT forward: rel err {rel:.3e} (tol {TXT_REL_TOL}), launches {fwd_keys}")
    del out, ref, x

    # (b) requests; the fuse's input holds the restored deep output: the null half's is all mask tokens
    diffuser = Diffuser(model, "euler", n_steps=STEPS, vision_tower=tower, extra_args=TXT_EXTRA)
    inner = model.mask_token.shape[-1]
    mask_token = model.mask_token.detach()[0, 0]
    null_rows = []
    hook = model.fuse.register_forward_hook(
        lambda m, args, out: null_rows.append((args[0][TXT_BATCH:, :, :inner] == mask_token).all()))
    image_shape = (TXT_BATCH, TXT_LATENT[0] * tower.compression_factor, TXT_LATENT[1] * tower.compression_factor, 3)
    request_ms, totals = [], {}
    torch.cuda.reset_peak_memory_stats()
    for r in range(F1_TXT_REQUESTS):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        images = txt2img_request(diffuser, cond, seed=500 + r)
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        keys, launched = launch_keys(), launch_counts()
        if keys != {("flash_attn_fwd", "bfloat16", TXT_SEQ): STEPS * blocks}:
            fail(f"txt2img SprintDiT request {r}: launches {keys}, expected {STEPS * blocks} bf16 K3 at {TXT_SEQ}")
        totals = {key: totals.get(key, 0) + n for key, n in launched.items()}
        if images.shape != image_shape or not bool(torch.isfinite(images).all()) or float(images.abs().max()) > 1:
            fail(f"txt2img SprintDiT request {r}: images {tuple(images.shape)}, expected {image_shape}, finite, in "
                 "[-1, 1]")
    hook.remove()
    request_peak = torch.cuda.max_memory_allocated() / 2**30
    if len(null_rows) != F1_TXT_REQUESTS * STEPS or not bool(torch.stack(null_rows).all()):
        fail(f"txt2img SprintDiT requests: the null half's restored deep output is not all mask tokens "
             f"({len(null_rows)} steps seen)")
    windows["generate"] = totals
    del images, null_rows

    # (c) gradients of one loss, the kernel path against the plain twin with the same kept tokens
    gen = torch.Generator(device="cuda").manual_seed(21)
    x0 = torch.randn(TXT_GRAD_BATCH, *TXT_LATENT, generator=gen, device="cuda")
    emb = torch.randn(TXT_GRAD_BATCH, TEXT_LEN, TEXT_DIM, generator=gen, device="cuda")
    text_mask = torch.arange(TEXT_LEN, device="cuda")[None, :] < torch.tensor([77, 9], device="cuda")[:, None]
    gcond = {"context": {"embeddings": emb, "attn_mask": text_mask}}
    diffusers = [Diffuser(m, "euler", extra_args=TXT_EXTRA) for m in (model, plain)]
    t = diffusers[0].draw_timesteps(gen, TXT_GRAD_BATCH)
    noise = torch.randn(x0.shape, generator=gen, device="cuda")
    gdrop = torch.tensor([False, True], device="cuda")  # the second row: null context and path drop
    plain.use_checkpoint = True  # one block's fp32 score matrices at a time
    grads, losses, keys = [], [], []
    for d in diffusers:
        d.denoiser.zero_grad(set_to_none=True)
        reset_launch_counts()
        loss = d.compute_loss(x0, gcond, t, noise, drop=gdrop,
                              generator=torch.Generator(device="cuda").manual_seed(22))["loss"]
        loss.backward()
        torch.cuda.synchronize()
        keys.append(launch_keys())
        grads.append({n: p.grad for n, p in d.denoiser.named_parameters()})
        losses.append(float(loss.detach()))
    kept = TEXT_LEN + model.kept_tokens(TXT_LATENT[0] * TXT_LATENT[1])
    want = {(name, "bfloat16", n): c for name in FLASH_KERNELS for n, c in ((TXT_SEQ, encoder + decoder), (kept, deep))}
    if keys[0] != want or keys[1]:
        fail(f"txt2img SprintDiT gradients: launches kernel path {keys[0]}, expected {want}; plain {keys[1]}")
    worst, worst_name, unused = 0.0, None, []
    for name, g in grads[0].items():
        r = grads[1][name]
        if g is None and r is None:  # the last decoder block's text-stream outputs reach no output
            unused.append(name)
            continue
        if g is None or r is None or not bool(torch.isfinite(g).all()):
            fail(f"txt2img SprintDiT gradients: {name} missing or non-finite")
        rel_g = float((g.float() - r.float()).norm() / r.float().norm().clamp_min(1e-30))
        if rel_g > worst:
            worst, worst_name = rel_g, name
    if not all(name.startswith(f"decoder_layers.{decoder - 1}.") for name in unused):
        fail(f"txt2img SprintDiT gradients: no gradient on both paths for {unused}")
    mask_grad = float(grads[0]["mask_token"].norm())
    if worst > TXT_GRAD_TOL or not math.isfinite(losses[0]) or not mask_grad > 0:
        fail(f"txt2img SprintDiT gradients: worst relative error {worst:.3e} at {worst_name} (tol {TXT_GRAD_TOL}), "
             f"loss {losses[0]}, |mask_token grad| {mask_grad}")
    del plain, diffusers, grads
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # (d) training over both buckets
    tr = txt2img_train_run(model, tower, "chip_smoke_txt2img_sprint", "txt2img SprintDiT train")
    loader = tr["loader"]
    expected = {"fused_mha_fwd": 0, "fused_mha_bwd": 0, **dict.fromkeys(FLASH_KERNELS, blocks),
                **{f"{name}_f32": 0 for name in FLASH_KERNELS}, **dict.fromkeys((*BF16_COUNTERS, *F32_ONLY_COUNTERS), 0)}
    per_bucket: dict[tuple[int, int], list[float]] = {}
    step_keys = {}
    for batch, (t0, c0), (t1, c1), k0, k1 in zip(loader.batches, loader.marks[:-1], loader.marks[1:],
                                                 loader.key_marks[:-1], loader.key_marks[1:]):
        hw = tuple(batch["model_inputs"]["x"].shape[1:3])
        full, kept = TEXT_LEN + hw[0] * hw[1], TEXT_LEN + model.kept_tokens(hw[0] * hw[1])
        want = {(name, "bfloat16", n): c for name in FLASH_KERNELS for n, c in ((full, encoder + decoder), (kept, deep))}
        step = {key: c1[key] - c0[key] for key in c1}
        if step != expected or key_diff(k1, k0) != want:
            fail(f"txt2img SprintDiT train: launches in a step {step} by length {key_diff(k1, k0)}, expected "
                 f"{expected}, {want}")
        step_keys[hw] = want
        per_bucket.setdefault(hw, []).append((t1 - t0) * 1e3)
    steady = statistics.median([m for times in per_bucket.values() for m in times[2:]])
    windows["train"] = tr["launches"]
    cuts = ", ".join(f"{key} {old} -> {new}" for key, (old, new) in F1_TXT_CUTS.items())
    print(f"phase 20 txt2img SprintDiT ({F1_TXT_CONFIG} model block as composed: {encoder} MMDiT + {deep} "
          f"single-stream deep + {decoder} MMDiT blocks, 768 wide, drop {model.drop_rate}; bf16; cut: {cuts}): "
          f"(a) forward B={b} S={TXT_SEQ} kernel path vs plain attention max rel err {rel:.3e} (tol {TXT_REL_TOL}), "
          f"{blocks} K3 at {TXT_SEQ}; (b) {F1_TXT_REQUESTS} requests of {TXT_BATCH} prompts Euler-{STEPS} shift "
          f"{TXT_EXTRA['shift']} CFG {CFG} with the Flux2 decode to {image_shape[1:]}: ms/request "
          f"{[round(m, 2) for m in request_ms]}, {STEPS * blocks} K3 at {TXT_SEQ} each, the null half's deep output "
          f"all mask tokens at every step, images finite in [-1, 1], peak mem {request_peak:.2f} GiB; (c) gradients "
          f"B={TXT_GRAD_BATCH} (row 1 dropped, the same kept tokens on both paths): loss kernel path {losses[0]:.6f} "
          f"plain {losses[1]:.6f}, worst ||kernel - plain|| / ||plain|| {worst:.3e} at {worst_name} (tol "
          f"{TXT_GRAD_TOL}), |mask_token grad| {mask_grad:.3e}, {len(unused)} parameters of the last block's text "
          f"stream without a gradient on both paths; (d) BaseTrainer.train batch {TXT_TRAIN_BATCH}: "
          f"{tr['n_steps']} steps, "
          + ", ".join(f"{h}x{w} ms/step {[round(m, 2) for m in times]}" for (h, w), times in per_bucket.items())
          + f"; median after the first two of each bucket {steady:.2f} ms, samples/s "
          f"{TXT_TRAIN_BATCH / steady * 1e3:.2f}; per step {blocks} K3 + {blocks} K4 + {blocks} K5, by length "
          + ", ".join(f"{h}x{w}: {encoder + decoder} at {TEXT_LEN + h * w} and {deep} at "
                      f"{TEXT_LEN + model.kept_tokens(h * w)}" for h, w in step_keys)
          + f"; train loss {tr['losses'][0]:.5f}, val loss (EMA) {tr['val_losses'][0]:.5f}; validation images "
          f"{tr['image_shape'][1:]}; peak mem {tr['peak_gib']:.2f} GiB; best-val checkpoint written and restored")
    del model, diffuser, tower, loader
    torch.cuda.empty_cache()
    kernels = f1_deep_kernels()
    return {"windows": windows, "request_ms": request_ms, "step_ms": steady, "peak_gib": tr["peak_gib"],
            "kernels": kernels}


def phase_f1_hard():
    """Phase 21: the hard-txt2img SprintDiT and DDT (F1_HARD's model blocks,
    bf16, seeded weights) on F1_HARD_LATENT latents with captions embedded
    by the caption table: per model an eval forward at the fused-CFG batch
    of 32 against its plain-attention twin, one 16-image Euler-50 request at
    CFG 1.5, and two train steps at batch 64 (train_step: loss, backward,
    AdamW; p_cfg 0.1), each with exact bf16 K1/K2 counts by key length: the
    SprintDiT 8 a forward (its 264 tokens padded to 384; in training 4 at
    384 and its 4 deep blocks at 8 + 64 kept = 72, padded to 128), the DDT 9
    (6 encoder blocks at 384, 3 decoder blocks over the 256 image tokens)."""
    import numpy as np
    import torch

    from diffulab_tpu_torch.config import compose_config, instantiate
    from diffulab_tpu_torch.config.instantiate import model_dtype_kwargs
    from diffulab_tpu_torch.data.synthetic_txt2img import (
        EMB_LEN,
        SyntheticCompositionalDataset,
        caption_embedding_table,
        embed_captions,
    )
    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.diffuse.flow import _tree_cat2
    from diffulab_tpu_torch.examples.train_diffusion import CONFIG_DIR
    from diffulab_tpu_torch.networks.embedders import PrecomputedEmbedder
    from diffulab_tpu_torch.networks.nn import make_drop_mask
    from diffulab_tpu_torch.training.trainer import MultiStepOptimizer, train_step

    if EMB_LEN != F1_HARD_TEXT[0]:
        fail(f"hard txt2img: captions of {EMB_LEN} tokens, expected {F1_HARD_TEXT[0]}")
    captions = SyntheticCompositionalDataset(train=True, n_samples=F1_HARD_BATCH, image_size=64, seed=0).captions
    emb, text_mask = (torch.as_tensor(a, device="cuda")
                      for a in embed_captions(captions, caption_embedding_table(F1_HARD_TEXT[1])))
    text, image = F1_HARD_TEXT[0], F1_HARD_LATENT[0] * F1_HARD_LATENT[1]
    results = {}
    for kind, config in F1_HARD.items():
        cfg = compose_config(CONFIG_DIR, config)
        model_cfg = {k: v for k, v in cfg["model"].items() if not (kind == "ddt" and k == "simple_dit")}
        null = np.zeros(F1_HARD_TEXT, np.float32)  # what build_hard_txt2img.py writes
        embedder = PrecomputedEmbedder(null_embedding=null,
                                       null_embedding_seq_len=cfg["embedder"]["null_embedding_seq_len"])
        kw = dict(context_embedder=embedder, **model_dtype_kwargs(cfg["trainer"]))
        model = instantiate(model_cfg, **kw).eval()
        randomize_(model, seed=24)
        plain = instantiate({**model_cfg, "attention_impl": "xla"}, **kw).eval()
        plain.load_state_dict(model.state_dict(), strict=True)
        full = padded_keys(text + image)
        if kind == "sprint":
            outer, deep = len(model.layers) + len(model.decoder_layers), len(model.deep_layers)
            eval_keys = {full: outer + deep}
            train_keys = {full: outer, padded_keys(text + model.kept_tokens(image)): deep}
        else:
            eval_keys = train_keys = {full: len(model.layers), padded_keys(image): len(model.decoder_layers)}
        per_forward = sum(eval_keys.values())

        gen = torch.Generator(device="cuda").manual_seed(25)
        b = 2 * F1_HARD_SAMPLES
        x = torch.randn(b, *F1_HARD_LATENT, generator=gen, device="cuda")
        t = torch.rand(b, generator=gen, device="cuda")
        cond = {"context": {"embeddings": emb[:F1_HARD_SAMPLES], "attn_mask": text_mask[:F1_HARD_SAMPLES]}}
        drop = torch.arange(b, device="cuda") >= F1_HARD_SAMPLES
        with torch.no_grad():
            reset_launch_counts()
            out = model(x, t, _tree_cat2(cond), drop)["x"]
            fwd_keys = launch_keys()
            ref = plain(x, t, _tree_cat2(cond), drop)["x"]
        rel = float((out.float() - ref.float()).abs().max() / ref.float().abs().max())
        want = {("fused_mha_fwd", "bfloat16", n): c for n, c in eval_keys.items()}
        if out.shape != (b, *F1_HARD_LATENT) or not bool(torch.isfinite(out).all()) or rel > TXT_REL_TOL \
                or fwd_keys != want:
            fail(f"hard {kind} forward: rel err {rel:.3e} (tol {TXT_REL_TOL}), launches {fwd_keys}, expected {want}")
        del plain, out, ref

        diffuser = Diffuser(model, "euler", n_steps=STEPS, extra_args=cfg["diffuser"].get("extra_args", {}))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        latents = diffuser.generate(cond, data_shape=(F1_HARD_SAMPLES, *F1_HARD_LATENT),
                                    generator=torch.Generator(device="cuda").manual_seed(26),
                                    guidance_scale=F1_HARD_GUIDANCE)["x"]
        torch.cuda.synchronize()
        request_ms = (time.perf_counter() - t0) * 1e3
        sample, sample_keys = launch_counts(), launch_keys()
        want = {("fused_mha_fwd", "bfloat16", n): STEPS * c for n, c in eval_keys.items()}
        if sample_keys != want or latents.shape != (F1_HARD_SAMPLES, *F1_HARD_LATENT) \
                or not bool(torch.isfinite(latents).all()):
            fail(f"hard {kind} request: launches {sample_keys}, expected {want}; latents {tuple(latents.shape)}")

        model.train()
        optimizer = MultiStepOptimizer(instantiate(cfg["optimizer"])(model.parameters()))
        p_cfg = cfg["trainer"]["p_classifier_free_guidance"]
        batch = {"model_inputs": {"x": None, "context": {"embeddings": emb, "attn_mask": text_mask}}}
        step_ms, losses, train = [], [], {}
        want = {(name, "bfloat16", n): c for name in ("fused_mha_fwd", "fused_mha_bwd") for n, c in train_keys.items()}
        torch.cuda.reset_peak_memory_stats()
        for step in range(F1_HARD_STEPS):
            x0 = torch.randn(F1_HARD_BATCH, *F1_HARD_LATENT, generator=gen, device="cuda")
            batch["model_inputs"]["x"] = x0
            tt = diffuser.draw_timesteps(gen, F1_HARD_BATCH)
            noise = torch.randn(x0.shape, generator=gen, device="cuda")
            drop = make_drop_mask(gen, p_cfg, F1_HARD_BATCH)
            model_gen = torch.Generator(device="cuda").manual_seed(27 + step) if model.draws_in_training else None
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            losses.append(float(train_step(diffuser, optimizer, None, batch, tt, noise, drop, step,
                                           generator=model_gen)["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if launch_keys() != want:
                fail(f"hard {kind} train step {step}: launches {launch_keys()}, expected {want}")
            train = {key: train.get(key, 0) + n for key, n in launch_counts().items()}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if not all(math.isfinite(v) for v in losses):
            fail(f"hard {kind} train: losses {losses}")
        n_params = sum(p.numel() for p in model.parameters())
        print(f"phase 21 hard txt2img {kind} ({config} model block, {n_params / 1e6:.1f}M parameters, bf16; "
              f"{F1_HARD_LATENT} latents of 64x64 images, captions of {text} tokens of {F1_HARD_TEXT[1]}; no decode): "
              f"forward B={b} vs plain attention max rel err {rel:.3e} (tol {TXT_REL_TOL}), bf16 K1 by padded "
              f"length {eval_keys}; request of {F1_HARD_SAMPLES} Euler-{STEPS} CFG {F1_HARD_GUIDANCE} "
              f"{request_ms:.1f} ms, {STEPS * per_forward} bf16 K1; {F1_HARD_STEPS} train steps at batch "
              f"{F1_HARD_BATCH} (AdamW lr {cfg['optimizer']['lr']}, p_cfg {p_cfg}): ms/step "
              f"{[round(m, 2) for m in step_ms]}, losses {[round(v, 5) for v in losses]}, bf16 K1 and K2 a step by "
              f"padded length {train_keys}; peak mem {peak_gib:.2f} GiB")
        results[kind] = {"sample": sample, "train": train, "request_ms": request_ms, "step_ms": step_ms}
        model.eval()
        del model, diffuser, optimizer, latents
        torch.cuda.empty_cache()
    return results


def write_cifar10(root: Path, seed: int = 0) -> None:
    """CIFAR-10 python pickles of F1_CIFAR_IMAGES' cut sizes from a seed
    (uint8 rows of 3072 in CHW order, integer labels): data_batch_1-4
    share the training images, data_batch_5 holds the validation ones."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    sizes = [F1_CIFAR_IMAGES["train"][1] // 4] * 4 + [F1_CIFAR_IMAGES["val"][1]]
    for i, n in enumerate(sizes, start=1):
        with open(root / f"data_batch_{i}", "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         "labels": rng.integers(0, 10, n).tolist()}, f)


def f1_cli_kernels():
    """Phase 22's kernels: the fp32 K2 at the CIFAR config's micro-batch
    (B=32, S=256, H=8, D=64), and the fp32 K1 and K2 at the SprintDiT CLI
    run's deep shape as the fused route hands it over (B=128, 64 kept tokens
    padded to 128 query rows and keys, the padding mask, H=8, D=64), against
    their plain versions; each timed from CUDA-graph replays beside fp32
    SDPA (the backward: its memory-efficient backward op) on the same
    inputs and, for the padded shape, on the unpadded 64-token tensors too;
    bounds at 3xTF32 (:func:`d2_bounds`: over the valid rows and keys, and
    over the padded contract's 128 rows)."""
    import torch
    import torch.nn.functional as F

    from diffulab_tpu_torch.ops.fused_mha import fused_mha, fused_mha_bwd, fused_mha_bwd_reference, fused_mha_reference

    gen = torch.Generator(device="cuda").manual_seed(28)
    h, d = C1_HEADS, 64

    def rand(b, n):
        return torch.randn(b, n, h, d, generator=gen, device="cuda", dtype=torch.float32)

    out = {}
    b, s = F1_CIFAR_BATCH, C1_SEQ
    q, k, v, do = rand(b, s), rand(b, s), rand(b, s), rand(b, s)
    with torch.no_grad():
        _, lse = fused_mha(q, k, v)
        refs = fused_mha_bwd_reference(q, k, v, None, lse, do)
        err = check_grads("F1 K2 fp32 B=32", fused_mha_bwd(q, k, v, None, lse, do), refs, BWD_TOL["float32"])
        sdpa_bwd = sdpa_fp32_backward(q, k, v, do)
        bytes_moved = 7 * b * s * h * d * 4 + b * s * h * 4
        flops = 10 * b * h * s * s * d
        t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, 3 * flops / PEAK_TF32_FLOPS
        out["k2_b32"] = dict(max_abs_err=err, ms=cuda_graph_ms(lambda: fused_mha_bwd(q, k, v, None, lse, do),
                                                               calls=10, replays=5),
                             plain_ms=cuda_time_ms(lambda: fused_mha_bwd_reference(q, k, v, None, lse, do), iters=3),
                             library_ms=cuda_graph_ms(sdpa_bwd, calls=10, replays=5),
                             bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
                             mb=bytes_moved / 1e6, gflop=flops / 1e9,
                             shape=f"B={b} S={s} H={h} D={d} fp32 (the CIFAR config's micro-batch)")
        del q, k, v, do, lse, refs, sdpa_bwd

        b, tokens, s = C1_BATCH, C1_SEQ // 4, D2_PADDED
        q, k, v, do = rand(b, tokens), rand(b, tokens), rand(b, tokens), rand(b, tokens)
        qp, kp, vp, dop = (F.pad(t, (0, 0, 0, 0, 0, s - tokens)) for t in (q, k, v, do))  # the fused route's padding
        mask = d2_mask("padded", b, tokens)
        o, lse = fused_mha(qp, kp, vp, mask)
        ro, rlse = fused_mha_reference(qp, kp, vp, mask)
        err = check_close("F1 K1 fp32 64 padded to 128 o", o, ro, *TOL["float32"])
        check_close("F1 K1 fp32 64 padded to 128 lse", lse, rlse, *LSE_TOL)
        qpt, kpt, vpt, qt, kt, vt = (t.transpose(1, 2) for t in (qp, kp, vp, q, k, v))
        attn_mask = mask[:, None, None, :]
        shape = f"B={b} Sq=Skv={s} padded from {tokens} (the padding mask) H={h} D={d} fp32 (the SprintDiT deep path)"
        out["k1_pad64"] = dict(
            max_abs_err=err, ms=cuda_graph_ms(lambda: fused_mha(qp, kp, vp, mask)),
            plain_ms=cuda_time_ms(lambda: fused_mha_reference(qp, kp, vp, mask), iters=5),
            library_ms=cuda_graph_ms(lambda: F.scaled_dot_product_attention(qpt, kpt, vpt, attn_mask=attn_mask)),
            sdpa_unpadded_ms=cuda_graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            **d2_bounds(b, tokens, h, d, False, False), padded=d2_bounds(b, tokens, h, d, False, True), shape=shape)
        refs = fused_mha_bwd_reference(qp, kp, vp, mask, lse, dop)
        err = check_grads("F1 K2 fp32 64 padded to 128", fused_mha_bwd(qp, kp, vp, mask, lse, dop), refs,
                          BWD_TOL["float32"])
        out["k2_pad64"] = dict(
            max_abs_err=err, ms=cuda_graph_ms(lambda: fused_mha_bwd(qp, kp, vp, mask, lse, dop), calls=10, replays=5),
            plain_ms=cuda_time_ms(lambda: fused_mha_bwd_reference(qp, kp, vp, mask, lse, dop), iters=3),
            library_ms=cuda_graph_ms(sdpa_fp32_backward(qp, kp, vp, dop, mask), calls=10, replays=5),
            sdpa_unpadded_ms=cuda_graph_ms(sdpa_fp32_backward(q, k, v, do), calls=10, replays=5),
            **d2_bounds(b, tokens, h, d, True, False), padded=d2_bounds(b, tokens, h, d, True, True), shape=shape)
        del q, k, v, do, qp, kp, vp, dop, o, lse, ro, rlse, refs
    torch.cuda.synchronize()
    print("phase 22 kernels fp32 (device ms from CUDA-graph replays; library: fp32 SDPA on the same inputs, the "
          "backward its memory-efficient backward op; bounds at 3xTF32 and 3.35 TB/s, over the valid rows and keys "
          "and over the padded contract's 128 rows): "
          + "; ".join(f"{key} ({r['shape']}) max_abs_err {r['max_abs_err']:.3e} kernel {r['ms']:.4f} SDPA fp32 "
                      f"{r['library_ms']:.4f}"
                      + (f" (unpadded {r['sdpa_unpadded_ms']:.4f})" if "sdpa_unpadded_ms" in r else "")
                      + f" plain {r['plain_ms']:.4f} bound {r['bound_ms']:.4f} ({r['bound_by']}: {r['mb']:.1f} MB, "
                      f"{r['gflop']:.2f} GFLOP)"
                      + (f", padded {r['padded']['bound_ms']:.4f} ({r['padded']['bound_by']})" if "padded" in r else "")
                      for key, r in out.items())
          + f"; tol K1 atol {TOL['float32'][0]} rtol {TOL['float32'][1]}, K2 {BWD_TOL['float32']} * (max|ref| + |ref|)")
    return out


def phase_f1_cli(root: Path):
    """Phase 22: F1_CLI's three runs through train_diffusion (one epoch of
    the cut set, every step timed, its K1/K2 launches by key length), then
    one 16-image sample request at CFG 1.5 from each EMA checkpoint, every
    launch an fp32 instance at D=64: a SprintDiT step 12 K1 + 12 K2 (its 2 +
    2 outer blocks at 256 tokens, its 8 deep blocks at 64 kept, padded to
    128), a DDT step 12 + 12 at 256, a CIFAR step 10 + 10 at 256 (B=32); a
    request the blocks a forward times the config's steps (50; CIFAR 100).
    Then their kernels (:func:`f1_cli_kernels`)."""
    from diffulab_tpu_torch.config import compose_config
    from diffulab_tpu_torch.examples import train_diffusion
    from diffulab_tpu_torch.examples.train_diffusion import CONFIG_DIR

    sys.modules["wandb"] = None
    log = root / "f1_cli.log"
    data = root / "cifar-10-batches-py"
    write_cifar10(data)
    results = {}
    labels = ",".join(str(i) for i in range(10))
    for kind, (config, group) in F1_CLI.items():
        save = root / f"f1_{kind}"
        if kind == "cifar10":
            cuts = {**F1_CIFAR_CUTS, **{f"dataset.{split}.data_path": ("data/cifar-10-batches-py", data)
                                        for split in ("train", "val")}}
            steps_per_epoch = F1_CIFAR_IMAGES["train"][1] // F1_CIFAR_BATCH
        else:
            cuts = C1_CUTS
            steps_per_epoch = C1_CUTS["dataset.train.n_samples"][1] // C1_BATCH
        overrides = [*group, *(f"{key}={new}" for key, (_, new) in cuts.items())]
        cfg = compose_config(CONFIG_DIR, config, overrides)
        model = cfg["model"]
        tokens = (32 // model["patch_size"]) ** 2
        if kind == "sprint":
            kept = max(1, int(tokens * (1.0 - model["drop_rate"])))
            by_len = {tokens: model["encoder_depth"] + model["decoder_depth"], padded_keys(kept): model["deep_layers_depth"]}
            eval_blocks = sum(by_len.values())
        elif kind == "ddt":
            by_len = {tokens: model["encoder_depth"] + model["decoder_depth"]}
            eval_blocks = by_len[tokens]
        else:
            by_len = {tokens: model["depth"]}
            eval_blocks = model["depth"]
        run = save / cfg["trainer"]["project_name"]
        tr = _timed_train_cli(train_diffusion.main, ["--config-name", config, *overrides,
                                                     f"trainer.save_path={save}"], log, run, 1, steps_per_epoch,
                              f"F1 {kind}")
        per_step = sum(by_len.values())
        want = {(name, "float32", n): c for name in ("fused_mha_fwd", "fused_mha_bwd") for n, c in by_len.items()}
        if tr["per_step"] != [(per_step, per_step, 0)] * tr["trainer"].step or any(k != want for k in tr["step_keys"]):
            fail(f"F1 {kind} train: launches per step (K1, K2, K3) {sorted(set(tr['per_step']))}, by length "
                 f"{[k for k in tr['step_keys'] if k != want][:1]}, expected {per_step} each, {want}")
        _e1_instances(f"F1 {kind} train", tr["launches"], "fp32")
        n_steps = cfg["diffuser"]["n_steps"]
        result = _sample_request(["--config-name", config, "--ckpt", str(run / "checkpoints" / "ema"), "--n",
                                  str(F1_SAMPLES), "--guidance", str(F1_GUIDANCE), "--labels", labels, "--out",
                                  str(root / f"f1_{kind}.png"), *overrides], log)
        keys = launch_keys()
        if keys != {("fused_mha_fwd", "float32", tokens): n_steps * eval_blocks} \
                or result["images"].shape != (F1_SAMPLES, 32, 32, 3):
            fail(f"F1 {kind} sample: launches {keys}, expected {n_steps * eval_blocks} fp32 K1 at {tokens}; images "
                 f"{result['images'].shape}")
        _e1_instances(f"F1 {kind} sample", result["launches"], "fp32")
        batch = cfg["dataloader"]["batch_size"]
        cut_text = ", ".join(f"{key} {old} -> {new}" for key, (old, new) in cuts.items())
        print(f"phase 22 CLIs {config}{' ' + ' '.join(group) if group else ''} (cut: {cut_text}"
              + (f", images {F1_CIFAR_IMAGES} written from a seed" if kind == "cifar10" else "")
              + f"; batch {batch}, accumulation {cfg['trainer']['gradient_accumulation_step']}, fp32, "
              f"classifier_free {model['classifier_free']}): {tr['trainer'].step} steps in {tr['train_s']:.1f} s, "
              f"ms/step start to start median after the first two {tr['steady']:.2f} (min {min(tr['step_ms']):.2f} "
              f"max {max(tr['step_ms']):.2f}; train_step alone {tr['kernel_ms']:.2f}), samples/s "
              f"{batch / tr['steady'] * 1e3:.1f}, peak mem {tr['peak_gib']:.2f} GiB; train loss "
              f"{[round(x, 5) for x in tr['losses']]}, val loss {[round(x, 5) for x in tr['val_losses']]}; fp32 K1 + "
              f"K2 a step by padded length {by_len}, in the run {tr['launches']}; sample {F1_SAMPLES} images "
              f"Euler-{n_steps} CFG {F1_GUIDANCE}: generate {result['generate_ms']:.1f} ms, "
              f"{n_steps * eval_blocks} fp32 K1 at {tokens}")
        results[kind] = {"train": tr["launches"], "sample": result["launches"], "step_ms": tr["steady"],
                         "generate_ms": result["generate_ms"]}
    results["kernels"] = f1_cli_kernels()
    return results


def write_g1_images(root: Path, seed: int = 0) -> dict[str, Any]:
    """Phase 23a: G1_IMAGES' cut counts of seeded 256x256 RGB uint8 images
    with labels in 0-999, through the port's ShardedDatasetWriter (npz
    shards of 1024), and the validation split once more through its
    MDSDatasetWriter (``image`` as ``ndarray:uint8:256,256,3``, ``label`` as
    ``int``); ShardedDataset must read the same samples from both. Returns
    the source directories and the seconds."""
    import numpy as np

    from diffulab_tpu_torch.data.mds import MDSDatasetWriter
    from diffulab_tpu_torch.data.streaming import ShardedDataset, ShardedDatasetWriter

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    for split, (_, n) in G1_IMAGES.items():
        images = rng.integers(0, 256, (n, G1_PX, G1_PX, 3), dtype=np.uint8)
        labels = rng.integers(0, 1000, n)
        with ShardedDatasetWriter(root / "raw" / split) as writer:
            for image, label in zip(images, labels):
                writer.write({"image": image, "label": int(label)})
        if split == "val":
            columns = {"image": f"ndarray:uint8:{G1_PX},{G1_PX},3", "label": "int"}
            with MDSDatasetWriter(root / "raw_mds" / split, columns, shard_size=64) as writer:
                for image, label in zip(images, labels):
                    writer.write({"image": image, "label": int(label)})
    npz, mds = ShardedDataset(root / "raw" / "val"), ShardedDataset(root / "raw_mds" / "val")
    same = len(npz) == len(mds) == G1_IMAGES["val"][1] and all(
        np.array_equal(npz[i]["image"], mds[i]["image"]) and int(npz[i]["label"]) == mds[i]["label"]
        for i in range(len(npz)))
    if not same:
        fail("G1 data: the npz and MDS copies of the validation split differ")
    return {"train": root / "raw" / "train", "val": root / "raw_mds" / "val", "s": time.perf_counter() - t0}


def _timed_cli(main, argv, log: Path) -> dict[str, Any]:
    """A CLI's ``main(argv)`` in process, timed with the card synchronised at
    both ends, its peak memory and its K1-K5 launches (the counts set to 0
    just before)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = _run_cli(main, argv, log)
    torch.cuda.synchronize()
    return {"out": out, "s": time.perf_counter() - t0, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launch_counts()}


def g1_kernel_cases() -> list[tuple]:
    """Phase 23g's cases of :func:`padded_kernels`: the bf16 K1 and K2 at
    slice G1's training shape (B=128, 64 tokens padded to 128 query rows and
    keys with the padding mask, H=12, D=64), K1 also at its request's B=32
    in fp32 (the sample CLI builds the model in fp32, as the reference's
    does), and the bf16 K1/K2 instances of the hard txt2img pair (phase 21:
    H=6, D=64; 264 tokens padded to 384 at B=32 in a request and B=64 in
    training, 256 unpadded (the DDT decoder), 72 padded to 128 (the
    SprintDiT's deep path in training))."""
    import torch

    return [("g1_train", G1_BATCH, G1_HEADS, G1_TOKENS, torch.bfloat16, True, None),
            ("g1_sample", 2 * G1_SAMPLES, G1_HEADS, G1_TOKENS, torch.float32, False, None),
            ("hard_request_384", 2 * F1_HARD_SAMPLES, 6, 264, torch.bfloat16, False, None),
            ("hard_request_256", 2 * F1_HARD_SAMPLES, 6, 256, torch.bfloat16, False, None),
            ("hard_train_384", F1_HARD_BATCH, 6, 264, torch.bfloat16, True, None),
            ("hard_train_256", F1_HARD_BATCH, 6, 256, torch.bfloat16, True, None),
            ("hard_train_128", F1_HARD_BATCH, 6, 72, torch.bfloat16, True, None)]


def padded_kernels(phase: str, cases, seed: int) -> dict[str, Any]:
    """The K1 (and, where a case says ``backward``, K2) instances of
    ``cases`` against their plain versions, at D=64 on inputs drawn from
    ``seed``. A case is (tag, B, H, tokens, dtype, backward, key_mask):
    ``tokens`` query rows and keys a sample, padded to 128s as the fused
    route pads them, with the padding mask, or with ``key_mask`` (bool [B,
    tokens] on the card, True = attend: the keys each sample attends) padded
    with False. Each is timed from CUDA-graph replays beside SDPA on the same
    padded inputs with the mask and on the unpadded tensors (with
    ``key_mask``); the backward beside SDPA's backward (bf16: its autograd
    backward, its kernels summed by torch.profiler; fp32: its memory-efficient
    backward op, :func:`sdpa_fp32_backward`), with bounds over the valid rows
    and the attended keys and over the padded contract
    (:func:`padded_bounds`). Returns ``k1_<tag>`` and ``k2_<tag>``."""
    import torch
    import torch.nn.functional as F

    from diffulab_tpu_torch.ops.fused_mha import fused_mha, fused_mha_bwd, fused_mha_bwd_reference, fused_mha_reference

    gen = torch.Generator(device="cuda").manual_seed(seed)
    d = 64
    out = {}
    for tag, b, h, tokens, dtype, backward, key_mask in cases:
        s = padded_keys(tokens)
        bf16 = dtype == torch.bfloat16
        kind = "bfloat16" if bf16 else "float32"
        bounds = dict(elem=2, peak_flops=PEAK_BF16_FLOPS, passes=1) if bf16 else {}
        valid = None if key_mask is None else [int(n) for n in key_mask.sum(dim=1).tolist()]
        if valid is not None:
            bounds["valid_keys"] = valid
        q, k, v, do = (torch.randn(b, tokens, h, d, generator=gen, device="cuda").to(dtype) for _ in range(4))
        qp, kp, vp, dop = (F.pad(t, (0, 0, 0, 0, 0, s - tokens)) for t in (q, k, v, do))  # the fused route's padding
        if key_mask is not None:
            mask = F.pad(key_mask, (0, s - tokens))
        else:
            mask = (torch.arange(s, device="cuda") < tokens)[None].expand(b, -1).contiguous() if s != tokens else None
        attn_mask = None if mask is None else mask[:, None, None, :]
        unpadded_mask = None if key_mask is None else key_mask[:, None, None, :]
        shape = f"B={b} Sq=Skv={s}" + (f" padded from {tokens}" if s != tokens else "") \
            + (" (the padding mask)" if s != tokens and key_mask is None else "") \
            + (f" (a key mask by sample: {min(valid)}-{max(valid)} keys, {sum(valid)} in all)" if valid else "") \
            + f" H={h} D={d} {kind}"
        with torch.no_grad():
            o, lse = fused_mha(qp, kp, vp, mask)
            ro, rlse = fused_mha_reference(qp, kp, vp, mask)
            err = check_close(f"{phase} {tag} K1 o", o, ro, *TOL[kind])
            check_close(f"{phase} {tag} K1 lse", lse, rlse, *LSE_TOL)
            qpt, kpt, vpt, qt, kt, vt = (t.transpose(1, 2) for t in (qp, kp, vp, q, k, v))
            fwd = dict(max_abs_err=err, ms=cuda_graph_ms(lambda: fused_mha(qp, kp, vp, mask)),
                       plain_ms=cuda_time_ms(lambda: fused_mha_reference(qp, kp, vp, mask), iters=5),
                       library_ms=cuda_graph_ms(lambda: F.scaled_dot_product_attention(qpt, kpt, vpt,
                                                                                       attn_mask=attn_mask)),
                       sdpa_unpadded_ms=cuda_graph_ms(lambda: F.scaled_dot_product_attention(
                           qt, kt, vt, attn_mask=unpadded_mask)),
                       **padded_bounds(b, tokens, s, h, d, False, False, **bounds),
                       padded=padded_bounds(b, tokens, s, h, d, False, True, **bounds), shape=shape)
            out[f"k1_{tag}"] = fwd
            if backward:
                refs = fused_mha_bwd_reference(qp, kp, vp, mask, lse, dop)
                err = check_grads(f"{phase} {tag} K2", fused_mha_bwd(qp, kp, vp, mask, lse, dop), refs, BWD_TOL[kind])
                bwd = dict(max_abs_err=err, ms=cuda_graph_ms(lambda: fused_mha_bwd(qp, kp, vp, mask, lse, dop),
                                                             calls=10, replays=5),
                           plain_ms=cuda_time_ms(lambda: fused_mha_bwd_reference(qp, kp, vp, mask, lse, dop), iters=3),
                           **padded_bounds(b, tokens, s, h, d, True, False, **bounds),
                           padded=padded_bounds(b, tokens, s, h, d, True, True, **bounds), shape=shape)
                del refs
                if not bf16:
                    bwd.update(library_ms=cuda_graph_ms(sdpa_fp32_backward(qp, kp, vp, dop, mask), calls=10, replays=5),
                               sdpa_unpadded_ms=cuda_graph_ms(sdpa_fp32_backward(q, k, v, do, key_mask), calls=10,
                                                              replays=5))
        if backward and bf16:
            for name, (tq, tk, tv, tdo, m) in (("library_ms", (qp, kp, vp, dop, attn_mask)),
                                               ("sdpa_unpadded_ms", (q, k, v, do, unpadded_mask))):
                with torch.enable_grad():
                    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (tq, tk, tv)]
                    sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=m)
                    dot = tdo.transpose(1, 2)
                    bwd[name] = profiled_kernels(
                        lambda: torch.autograd.grad(sdpa_out, leaves, dot, retain_graph=True))[0]
                    del sdpa_out, leaves
        if backward:
            out[f"k2_{tag}"] = bwd
        del q, k, v, do, qp, kp, vp, dop, o, lse, ro, rlse
    torch.cuda.synchronize()
    print(f"{phase} kernels (device ms from CUDA-graph replays; library: SDPA on the same padded inputs with the "
          "mask, beside SDPA on the unpadded tensors; the backward SDPA's backward: bf16 its autograd backward, its "
          "kernels summed by torch.profiler, fp32 its memory-efficient backward op; bounds at 3.35 TB/s and the bf16 "
          "peak (fp32: 3xTF32), over the valid rows and attended keys and over the padded contract): "
          + "; ".join(f"{key} ({r['shape']}) max_abs_err {r['max_abs_err']:.3e} kernel {r['ms']:.4f} SDPA "
                      f"{r['library_ms']:.4f} (unpadded {r['sdpa_unpadded_ms']:.4f}) plain {r['plain_ms']:.4f} bound "
                      f"{r['bound_ms']:.4f} ({r['bound_by']}: {r['mb']:.1f} MB, {r['gflop']:.2f} GFLOP), padded "
                      f"{r['padded']['bound_ms']:.4f} ({r['padded']['bound_by']})" for key, r in out.items())
          + f"; tol K1 bf16 atol/rtol {TOL['bfloat16'][0]}, fp32 {TOL['float32'][0]}; K2 bf16 {BWD_TOL['bfloat16']}, "
            f"fp32 {BWD_TOL['float32']} * (max|ref| + |ref|)")
    return out


def _g1_twin_checks(cfg: dict, shards: Path, scale) -> dict[str, Any]:
    """Phase 23f: the config's DiT (bf16, seeded noise weights) against its
    plain-attention twin: an eval forward at B=G1_BATCH on the first
    validation latents (12 bf16 K1 at 128 padded keys), and the gradients of
    one compute_loss at B=G1_GRAD_BATCH with the precomputed RepaLoss and its
    resampler (the same weights on both paths), the batch's dst_features
    passed as the trainer passes them (12 K1 + 12 K2), every parameter's
    ||kernel - plain|| / ||plain|| against DIT_GRAD_TOL."""
    import copy

    import numpy as np
    import torch

    from diffulab_tpu_torch.config import instantiate
    from diffulab_tpu_torch.config.instantiate import model_dtype_kwargs
    from diffulab_tpu_torch.data.streaming import ShardedDataset
    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.networks.nn import make_drop_mask
    from diffulab_tpu_torch.training.checkpoint import TrainModules
    from diffulab_tpu_torch.training.losses import build_extra_losses

    kw = model_dtype_kwargs(cfg["trainer"])
    model = instantiate(cfg["model"], **kw).eval()
    randomize_(model, seed=30)
    plain = instantiate({**cfg["model"], "attention_impl": "xla"}, **kw).eval()
    plain.load_state_dict(model.state_dict(), strict=True)
    val = ShardedDataset(shards / "val")
    rows = [val[i] for i in range(G1_BATCH)]
    x = torch.as_tensor(np.stack([r["vision_latents"] for r in rows]) * np.float32(scale), device="cuda")
    feats = torch.as_tensor(np.stack([r["dst_features"] for r in rows]), device="cuda")
    y = torch.as_tensor([int(r["label"]) for r in rows], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(31)
    t = torch.rand(G1_BATCH, generator=gen, device="cuda")
    drop = torch.zeros(G1_BATCH, dtype=torch.bool, device="cuda")
    want_fwd = {("fused_mha_fwd", "bfloat16", padded_keys(G1_TOKENS)): G1_DEPTH}
    with torch.no_grad():
        reset_launch_counts()
        out = model(x, t, {"y": y}, drop)["x"]
        fwd_keys = launch_keys()
        ref = plain(x, t, {"y": y}, drop)["x"]
    rel = float((out.float() - ref.float()).abs().max() / ref.float().abs().max())
    if out.shape != x.shape or not bool(torch.isfinite(out).all()) or rel > DIT_REL_TOL or fwd_keys != want_fwd:
        fail(f"G1 forward vs plain: rel err {rel:.3e} (tol {DIT_REL_TOL}), launches {fwd_keys}, expected {want_fwd}")
    del out, ref

    (loss,) = build_extra_losses(cfg, device="cuda")
    losses = [loss, copy.deepcopy(loss)]
    b = G1_GRAD_BATCH
    d = cfg["diffuser"]
    tt = torch.rand(b, generator=gen, device="cuda")
    noise = torch.randn((b, *x.shape[1:]), generator=gen, device="cuda")
    drop = make_drop_mask(gen, cfg["trainer"]["p_classifier_free_guidance"], b)
    grads, values = [], []
    want = {(name, "bfloat16", padded_keys(G1_TOKENS)): G1_DEPTH for name in ("fused_mha_fwd", "fused_mha_bwd")}
    for m, repa in ((model, losses[0]), (plain, losses[1])):
        m.train()
        repa.set_model(m)
        diffuser = Diffuser(m, d["sampling_method"], model_type=d["model_type"], n_steps=d["n_steps"],
                            extra_args=d.get("extra_args", {}), extra_losses=[repa])
        reset_launch_counts()
        parts = diffuser.compute_loss(x[:b], {"y": y[:b]}, tt, noise, drop=drop,
                                      extra_args={"dst_features": feats[:b]})
        sum(parts.values()).backward()
        torch.cuda.synchronize()
        if m is model and launch_keys() != want:
            fail(f"G1 gradients: kernel path launched {launch_keys()}, expected {want}")
        grads.append({n: p.grad for n, p in TrainModules(m, [repa]).named_parameters()})
        values.append({k: float(v.detach()) for k, v in parts.items()})
    worst, worst_name = 0.0, None
    for name, g in grads[0].items():
        r = grads[1][name]
        if g is None or r is None or not bool(torch.isfinite(g).all()):
            fail(f"G1 gradients: {name} missing or non-finite")
        rel_g = float((g.float() - r.float()).norm() / r.float().norm().clamp_min(1e-30))
        if rel_g > worst:
            worst, worst_name = rel_g, name
    if worst > DIT_GRAD_TOL or set(values[0]) != {"loss", "RepaLoss"} or values[0]["RepaLoss"] == 0 \
            or not all(math.isfinite(v) for v in values[0].values()):
        fail(f"G1 gradients: worst relative error {worst:.3e} at {worst_name} (tol {DIT_GRAD_TOL}), losses {values}")
    del model, plain, losses, grads
    torch.cuda.empty_cache()
    return {"forward_rel": rel, "grad_worst": worst, "grad_worst_name": worst_name, "losses": values}


def phase_g1(root: Path) -> dict[str, Any]:
    """Phase 23: slice G1 through the port's CLIs, in process, under ``root``:
    (a) the seeded images (:func:`write_g1_images`); (b) ``precompute
    latents`` with the full DC-AE f32c32 tower (seeded random weights), the
    latents [8, 8, 32], images/s and peak memory, and one batch of 16
    decoded back to finite [16, 256, 256, 3] pixels; (c) ``precompute
    features`` with dinov2_vitl14_reg at resolution 256 ([256, 1024] a row),
    images/s; neither launches K1-K5 (the towers' attention is not Pallas in
    the reference); (d) ``train_repa`` for one epoch of 8 steps at batch 128
    over (b)-(c)'s shards: 12 bf16 K1 + 12 bf16 K2 at 128 padded keys every
    step, 12 K1 a validation forward and 600 for the validation images
    (Euler-50 at CFG 4.0, 8 images), the loss finite and the REPA term
    non-zero, the step time start to start after the first two, peak memory;
    (e) ``sample`` from its EMA checkpoint: 16 images Euler-50 at CFG 4.0
    with the DC-AE decode, exactly 600 K1 at 128 padded keys (fp32: the
    sample CLI builds the model without the trainer's precision, as the
    reference's does), the request's ms; (f) :func:`_g1_twin_checks`; (g)
    :func:`padded_kernels` on :func:`g1_kernel_cases`."""
    import numpy as np
    import torch

    from diffulab_tpu_torch.config import compose_config
    from diffulab_tpu_torch.data.streaming import ShardedDataset
    from diffulab_tpu_torch.examples import precompute, train_repa

    sys.modules["wandb"] = None
    t_phase = time.perf_counter()
    log = root / "g1.log"
    src = write_g1_images(root)
    shards = root / "imagenet"
    pre = {}
    for mode, args in (("latents", ["--vision-tower", "dcae"]), ("features", ["--encoder", "dinov2", "--encoder-args",
                                                                             G1_DINO])):
        pre[mode] = {"s": 0.0, "peak_gib": 0.0, "launches": {}}
        for split in ("train", "val"):
            source = src[split] if mode == "latents" else root / "latents" / split
            dst = (root / "latents" if mode == "latents" else shards) / split
            r = _timed_cli(precompute.main, [mode, *args, "--src", str(source), "--dst", str(dst), "--batch-size",
                                             str(G1_PRECOMPUTE_BATCH)], log)
            pre[mode]["s"] += r["s"]
            pre[mode]["peak_gib"] = max(pre[mode]["peak_gib"], r["peak_gib"])
            if any(r["launches"].values()):
                fail(f"G1 precompute {mode}: K1-K5 launches {r['launches']}, expected none")
    n_images = sum(n for _, n in G1_IMAGES.values())
    row = ShardedDataset(shards / "train")[0]
    latent_shape = (G1_PX // 32, G1_PX // 32, 32)
    if row["vision_latents"].shape != latent_shape or row["dst_features"].shape != (256, 1024) \
            or not (np.isfinite(row["vision_latents"]).all() and np.isfinite(row["dst_features"]).all()):
        fail(f"G1 shards: latents {row['vision_latents'].shape}, features {row['dst_features'].shape}")
    # the tower the latents CLI built (the same seed), decoding one batch of the latents back to pixels
    tower = precompute.build(precompute.parse_args(["latents", "--vision-tower", "dcae", "--src", "-", "--dst", "-"]),
                             torch.device("cuda"))
    n_params = sum(p.numel() for p in tower.parameters())
    val = ShardedDataset(shards / "val")
    z = torch.as_tensor(np.stack([val[i]["vision_latents"] for i in range(G1_SAMPLES)]), device="cuda")
    with torch.no_grad():
        pixels = tower.decode(z)
    if pixels.shape != (G1_SAMPLES, G1_PX, G1_PX, 3) or not bool(torch.isfinite(pixels).all()):
        fail(f"G1 decode: pixels {tuple(pixels.shape)}, finite {bool(torch.isfinite(pixels).all())}")
    scale = tower.latent_scale
    del tower, pixels, z
    torch.cuda.empty_cache()

    cfg = compose_config(train_repa.CONFIG_DIR, G1_CONFIG)
    save = root / "g1_runs"
    overrides = [f"dataset.{split}.data_path={shards}" for split in ("train", "val")] \
        + [f"{key}={new}" for key, (_, new) in G1_CUTS.items()]
    run = save / cfg["trainer"]["project_name"]
    steps_per_epoch = G1_IMAGES["train"][1] // G1_BATCH
    tr = _timed_train_cli(train_repa.main, ["--config-name", G1_CONFIG, *overrides, f"trainer.save_path={save}"], log,
                          run, 1, steps_per_epoch, "G1 train_repa")
    padded = padded_keys(G1_TOKENS)
    want_step = {(name, "bfloat16", padded): G1_DEPTH for name in ("fused_mha_fwd", "fused_mha_bwd")}
    val_batches = G1_IMAGES["val"][1] // G1_BATCH
    val_steps = cfg["trainer"]["val_steps"]
    want_k1 = (steps_per_epoch + val_batches) * G1_DEPTH + val_steps * G1_DEPTH
    if tr["per_step"] != [(G1_DEPTH, G1_DEPTH, 0)] * tr["trainer"].step or any(k != want_step for k in tr["step_keys"]):
        fail(f"G1 train_repa: launches per step (K1, K2, K3) {sorted(set(tr['per_step']))}, by length "
             f"{[k for k in tr['step_keys'] if k != want_step][:1]}, expected {want_step}")
    if tr["launches"]["fused_mha_fwd_bf16"] != want_k1 or tr["launches"]["fused_mha_fwd"] != want_k1 \
            or tr["launches"]["fused_mha_bwd_bf16"] != steps_per_epoch * G1_DEPTH:
        fail(f"G1 train_repa: run launches {tr['launches']}, expected {want_k1} bf16 K1 ({steps_per_epoch} steps and "
             f"{val_batches} validation batches of {G1_DEPTH}, the validation images' {val_steps * G1_DEPTH}) and "
             f"{steps_per_epoch * G1_DEPTH} bf16 K2")
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    repa = {key: [r[key] for r in rows if key in r] for key in ("train/RepaLoss", "val/RepaLoss")}
    if any(len(v) != 1 or not math.isfinite(v[0]) or v[0] == 0 for v in repa.values()):
        fail(f"G1 train_repa: REPA loss rows {repa}")

    labels = ",".join(str(i) for i in range(0, 1000, 1000 // G1_SAMPLES))
    request = _sample_request(["--config-name", G1_CONFIG, "--ckpt", str(run / "checkpoints" / "ema"), "--n",
                               str(G1_SAMPLES), "--guidance", str(G1_GUIDANCE), "--image-size", str(G1_PX), "--labels",
                               labels, "--out", str(root / "g1.png"), *overrides], log)
    want = {("fused_mha_fwd", "float32", padded): STEPS * G1_DEPTH}
    if launch_keys() != want or request["images"].shape != (G1_SAMPLES, G1_PX, G1_PX, 3):
        fail(f"G1 sample: launches {launch_keys()}, expected {want}; images {request['images'].shape}")

    twin = _g1_twin_checks(cfg, shards, scale)
    kernels = padded_kernels("phase 23", g1_kernel_cases(), seed=29)
    cuts = ", ".join([f"{key} {old} -> {new}" for key, (old, new) in G1_CUTS.items()]
                     + [f"ImageNet {split} images {old} -> {new} seeded 256x256" for split, (old, new) in
                        G1_IMAGES.items()] + ["pretrained DC-AE f32c32 and DINOv2-L weights -> seeded random"])
    print(f"phase 23 G1 {G1_CONFIG} (cut: {cuts}): (a) {n_images} images written in {src['s']:.1f} s, the validation "
          f"split's npz and MDS copies read the same, the latents precomputed from the MDS copy; (b) precompute latents "
          f"DC-AE f32c32 ({n_params / 1e6:.1f}M parameters, fp32) {n_images} images in {pre['latents']['s']:.1f} s "
          f"({n_images / pre['latents']['s']:.1f} images/s, the tower's init included), peak mem "
          f"{pre['latents']['peak_gib']:.2f} GiB, latents {latent_shape}, {G1_SAMPLES} decoded to "
          f"[{G1_SAMPLES}, {G1_PX}, {G1_PX}, 3] finite; (c) precompute features dinov2_vitl14_reg at 224 px {n_images} "
          f"images in {pre['features']['s']:.1f} s ({n_images / pre['features']['s']:.1f} images/s), peak mem "
          f"{pre['features']['peak_gib']:.2f} GiB, features (256, 1024), no K1-K5 in (b)-(c); (d) train_repa "
          f"(DiT-B at patch 1, bf16, batch {G1_BATCH}, RepaLoss through the 3-deep resampler) {tr['trainer'].step} "
          f"steps in {tr['train_s']:.1f} s, ms/step start to start median after the first two {tr['steady']:.2f} (min "
          f"{min(tr['step_ms']):.2f} max {max(tr['step_ms']):.2f}; train_step alone {tr['kernel_ms']:.2f}), samples/s "
          f"{G1_BATCH / tr['steady'] * 1e3:.1f}, peak mem {tr['peak_gib']:.2f} GiB, train loss "
          f"{[round(x, 5) for x in tr['losses']]} val loss {[round(x, 5) for x in tr['val_losses']]}, RepaLoss train "
          f"{repa['train/RepaLoss'][0]:.5f} val {repa['val/RepaLoss'][0]:.5f}; bf16 K1 + K2 a step by padded length "
          f"{ {padded: G1_DEPTH} }, in the run {tr['launches']}; (e) sample {G1_SAMPLES} images Euler-{STEPS} CFG "
          f"{G1_GUIDANCE} with the DC-AE decode: generate {request['generate_ms']:.1f} ms, {STEPS * G1_DEPTH} fp32 K1 "
          f"at {padded}; (f) forward B={G1_BATCH} vs plain attention max rel err {twin['forward_rel']:.3e} (tol "
          f"{DIT_REL_TOL}), {G1_DEPTH} bf16 K1; gradients B={G1_GRAD_BATCH} with the precomputed RepaLoss and resampler "
          f"worst ||kernel - plain|| / ||plain|| {twin['grad_worst']:.3e} at {twin['grad_worst_name']} (tol "
          f"{DIT_GRAD_TOL}), losses kernel {twin['losses'][0]} plain {twin['losses'][1]}; phase {time.perf_counter() - t_phase:.1f} s")
    return {"train": tr["launches"], "sample": request["launches"], "step_ms": tr["steady"],
            "generate_ms": request["generate_ms"], "kernels": kernels}


def _h1_train(config: str, extra, log: Path, save: Path, project: str, label: str, want_step: dict,
              before_first_step=None) -> dict[str, Any]:
    """One ``train_repa_txt_to_img`` run of a hard config for one epoch over
    the builder's shards, its launches by padded key length held every step
    to ``want_step`` (``before_first_step``: :func:`_timed_train_cli`'s)."""
    from diffulab_tpu_torch.examples import train_repa_txt_to_img

    cuts = [f"{key}={new}" for key, (_, new) in H1_CUTS.items()]
    argv = ["--config-name", config, *cuts, *extra, f"trainer.save_path={save}", f"trainer.project_name={project}"]
    steps = H1_BUILD["--n-train"][1] // H1_BATCH
    tr = _timed_train_cli(train_repa_txt_to_img.main, argv, log, save / project, 1, steps, label,
                          before_first_step=before_first_step)
    if any(k != want_step for k in tr["step_keys"]):
        fail(f"{label}: launches a step by (kernel, dtype, padded keys) {[k for k in tr['step_keys'] if k != want_step][:1]}, "
             f"expected {want_step}")
    return tr


def phase_h1(root: Path, c1_run: Path) -> dict[str, Any]:
    """Phase 24: slice H1, the hard text-to-image benchmark's chain
    (``scripts/r5_*.sh``) through the port, in process, from ``root`` as the
    working directory (the configs' ``data/hard_txt2img`` paths unedited):
    (a) ``diffulab_tpu_torch.scripts.build_hard_txt2img`` at 64 px from a
    seed: the tower trained for one epoch at batch 64, its report (recon
    MSE, PSNR, the judge on reconstructions), the shards; no K1-K5 (the
    tower's attention is not Pallas in the reference); (b)
    ``train_repa_txt_to_img --config-name train_hard_txt2img_mmdit`` as
    composed (384 wide, 6 heads, 4 dual + 2 single-stream blocks, bf16,
    batch 64, post-hoc EMA) one epoch of 32 steps: 6 bf16 K1 + 6 bf16 K2 at
    384 padded keys every step, ms a step, peak memory; (c) the same with
    ``embedder=trainable trainer.train_embedder=true``: 4 fp32 K1 + 4 fp32
    K2 at 128 keys (the embedder, built without the trainer's precision) and
    6 + 6 bf16 at 384 (320 tokens) every step, the encoder's parameters
    moved from those the first train step found and held in the
    checkpoint's ``params``, then :func:`padded_kernels` at the embedder's
    fp32 K1/K2 shape and at (e)'s fp32 K1 request shape, with their key
    masks; (d) ``train_hard_txt2img_sprint`` one
    epoch (4 + 4 bf16 at 384 and at 128 a step), and
    ``train_hard_txt2img_ddt`` refused with the reference's ``TypeError``
    (fault F3); (e) ``reconstruct_ema`` at sigma_rel 0.05 and
    ``evaluate_txt2img`` on ``ema`` and ``phema_sr0.05``: 200 samples each
    at batch 100, Euler-50, CFG 1.5, the fp32 model (1200 fp32 K1 at 384),
    the ``txt2img`` JSON lines, images/s; (f) ``evaluate_fid`` on phase 14's
    C1 run's ``ema`` with 256 samples at CFG 1.5 (1000 fp32 K1 at 256), the
    ``fid_synthetic`` line with its floor and ceiling; the frozen ViT's
    weights on the card bitwise ``jax_prng``'s draw and its features of 16
    validation images within ``H1_FEATURE_TOL`` of the port's on the CPU."""
    import os

    import numpy as np
    import torch

    from diffulab_tpu_torch.config import compose_config, instantiate
    from diffulab_tpu_torch.data.streaming import ShardedDataset
    from diffulab_tpu_torch.data.synthetic_txt2img import (
        SyntheticCompositionalDataset,
        caption_embedding_table,
        embed_captions,
    )
    from diffulab_tpu_torch.examples import evaluate_fid, evaluate_txt2img, reconstruct_ema, train_repa_txt_to_img
    from diffulab_tpu_torch.networks.embedders.trainable import byte_tokenize
    from diffulab_tpu_torch.scripts import build_hard_txt2img
    from diffulab_tpu_torch.training.checkpoint import restore_checkpoint
    from diffulab_tpu_torch.training.evaluation import frozen_vit_features
    from diffulab_tpu_torch.weights import state_dict_from_jax

    sys.modules["wandb"] = None
    t_phase = time.perf_counter()
    log = root / "h1.log"
    cwd = os.getcwd()
    os.chdir(root)
    try:
        # (a) the builder
        build = _timed_cli(build_hard_txt2img.main, [*(x for key, (_, new) in H1_BUILD.items() for x in (key, str(new))),
                                                     "--batch", str(H1_BATCH), "--image-size", str(H1_PX)], log)
        data = root / "data" / "hard_txt2img"
        report = build["out"]["report"]
        row = ShardedDataset(data / "train")[0]
        if any(build["launches"].values()) or not math.isfinite(report["mse"]) \
                or row["vision_latents"].shape != (16, 16, 32) or row["caption_embeddings"].shape != (8, 512):
            fail(f"H1 build: launches {build['launches']}, report {report}, a row's latents "
                 f"{row['vision_latents'].shape} embeddings {row['caption_embeddings'].shape}")
        captions = [str(ShardedDataset(data / "train")[i]["caption"]) for i in range(H1_BATCH)]

        # (b) the MMDiT arm
        save = root / "runs"
        bf16 = {(name, "bfloat16", padded_keys(H1_TOKENS)): H1_DEPTH for name in ("fused_mha_fwd", "fused_mha_bwd")}
        mmdit = _h1_train(H1_CONFIGS["mmdit"], (), log, save, "hard_txt2img_mmdit", "H1 mmdit", bf16)
        steps = mmdit["trainer"].step
        val_batches = -(-H1_BUILD["--n-val"][1] // H1_BATCH)
        cfg = compose_config(train_repa_txt_to_img.CONFIG_DIR, H1_CONFIGS["mmdit"])
        want_k1 = (steps + val_batches + cfg["trainer"]["val_steps"]) * H1_DEPTH
        if mmdit["launches"]["fused_mha_fwd_bf16"] != want_k1 or mmdit["launches"]["fused_mha_fwd"] != want_k1 \
                or mmdit["launches"]["fused_mha_bwd_bf16"] != steps * H1_DEPTH:
            fail(f"H1 mmdit: run launches {mmdit['launches']}, expected {want_k1} bf16 K1 and {steps * H1_DEPTH} K2")

        # (c) the trainable embedder, trained with the denoiser
        emb_keys = {(name, "float32", padded_keys(H1_EMB_TOKENS)): H1_EMB_DEPTH
                    for name in ("fused_mha_fwd", "fused_mha_bwd")}
        initial = {}  # the embedder's parameters as the first train step finds them

        def keep_initial(diffuser, *args, **kwargs):
            initial.update({name: value.detach().cpu().clone()
                            for name, value in diffuser.denoiser.context_embedder.named_parameters()})

        trainable = _h1_train(H1_CONFIGS["mmdit"], H1_TRAINABLE, log, save, "hard_txt2img_mmdit_trainable",
                              "H1 mmdit trainable embedder", {**bf16, **emb_keys}, before_first_step=keep_initial)
        entry = restore_checkpoint(save / "hard_txt2img_mmdit_trainable" / "checkpoints" / "denoiser")
        held = {k.removeprefix("context_embedder."): v for k, v in entry["params"].items()
                if k.startswith("context_embedder.")}
        moved = [name for name, value in initial.items() if name in held and not torch.equal(held[name], value)]
        if not initial or set(held) != set(initial) or len(moved) != len(initial) \
                or any(k.startswith("context_embedder.") for k in entry["rest"]):
            fail(f"H1 trainable embedder: {len(held)} of {len(initial)} parameters in the checkpoint's params, "
                 f"{len(moved)} moved from the first step's")

        # the fp32 K1/K2 at the embedder's shape (the first 64 training captions' byte-token mask), and the fp32
        # K1 at evaluate_txt2img's request shape (the 100 validation captions' embedding mask, then the null
        # embedding's, as fused CFG stacks them, each beside 256 image keys)
        byte_mask = torch.as_tensor(byte_tokenize(captions, H1_EMB_TOKENS)["attn_mask"], device="cuda").bool()
        n_val_eval = max(H1_EVAL["--n-val"][1], H1_EVAL["--n-samples"][1])
        eval_captions = SyntheticCompositionalDataset(train=False, n_samples=n_val_eval, image_size=H1_PX,
                                                      seed=0).captions[:H1_EVAL_BATCH]
        caption_mask = torch.as_tensor(embed_captions(eval_captions, caption_embedding_table())[1], device="cuda")
        null_mask = instantiate(compose_config(train_repa_txt_to_img.CONFIG_DIR, H1_CONFIGS["mmdit"])["embedder"],
                                device="cuda").null_embedding_mask
        text_mask = torch.cat([caption_mask.bool(), null_mask[None].expand(H1_EVAL_BATCH, -1)])
        joint_mask = torch.cat([text_mask, torch.ones(2 * H1_EVAL_BATCH, H1_TOKENS - text_mask.shape[1],
                                                      dtype=torch.bool, device="cuda")], dim=1)
        h1_kernels = padded_kernels("phase 24", [
            ("h1_embedder", H1_BATCH, H1_EMB_HEADS, H1_EMB_TOKENS, torch.float32, True, byte_mask),
            ("h1_eval_384", 2 * H1_EVAL_BATCH, 6, H1_TOKENS, torch.float32, False, joint_mask)], seed=32)

        # (d) the SprintDiT arm; the DDT arm's config fault
        deep = padded_keys(H1_TOKENS - 256 + 256 // 4)  # 64 of 256 image tokens kept past the encoder
        sprint_keys = {(name, "bfloat16", n): 4 for name in ("fused_mha_fwd", "fused_mha_bwd")
                       for n in (padded_keys(H1_TOKENS), deep)}
        sprint = _h1_train(H1_CONFIGS["sprint"], (), log, save, "hard_txt2img_sprint", "H1 sprint", sprint_keys)
        try:
            _run_cli(train_repa_txt_to_img.main, ["--config-name", H1_CONFIGS["ddt"], f"trainer.save_path={save}"], log)
        except TypeError as e:
            ddt_error = str(e)
            if "simple_dit" not in ddt_error:
                raise
        else:
            fail("H1 ddt: train_hard_txt2img_ddt trained; its config's simple_dit (F3) should raise TypeError")

        # (e) post-hoc EMA, then evaluate_txt2img on ema and phema_sr0.05
        run = save / "hard_txt2img_mmdit"
        _run_cli(reconstruct_ema.main, ["--run-dir", str(run), "--sigma-rel", "0.05"], log)
        ckpts = [str(run / "checkpoints" / "ema"), str(run / "checkpoints" / "phema_sr0.05")]
        evaluation = _timed_cli(evaluate_txt2img.main, [
            "--config-name", H1_CONFIGS["mmdit"], "--ckpt", *ckpts, "--batch-size", str(H1_EVAL_BATCH),
            "--guidance", str(H1_GUIDANCE), "--image-size", str(H1_PX),
            *(x for key, (_, new) in H1_EVAL.items() for x in (key, str(new)))], log)
        n_eval = H1_EVAL["--n-samples"][1]
        want = {("fused_mha_fwd", "float32", padded_keys(H1_TOKENS)): len(ckpts) * -(-n_eval // H1_EVAL_BATCH)
                * STEPS * H1_DEPTH}
        eval_keys = launch_keys()
        rows = evaluation["out"]["rows"]
        if eval_keys != want or len(rows) != 2 or any(r["fake"].shape != (n_eval, H1_PX, H1_PX, 3)
                                                      or not np.isfinite(r["fake"]).all() for r in rows):
            fail(f"H1 evaluate_txt2img: launches {eval_keys}, expected {want}; "
                 f"samples {[r['fake'].shape for r in rows]}")

        # (f) evaluate_fid on the C1 run, and the feature ViT on the card against the CPU
        c1_cuts = [f"{key}={new}" for key, (_, new) in C1_CUTS.items()]
        fid = _timed_cli(evaluate_fid.main, [
            "--config-name", C1_CONFIG, "--ckpt", str(c1_run / "checkpoints" / "ema"), "--n-samples",
            str(H1_FID_SAMPLES), "--batch-size", str(H1_FID_BATCH), "--guidance", str(H1_GUIDANCE),
            "--cache-dir", str(root / "fid_cache"), *c1_cuts], log)
        want_fid = {("fused_mha_fwd", "float32", C1_SEQ): -(-H1_FID_SAMPLES // H1_FID_BATCH) * C1_STEPS * C1_DEPTH}
        fid_keys = launch_keys()
        (fid_row,) = fid["out"]["rows"]
        if fid_keys != want_fid or not all(math.isfinite(fid_row[k]) for k in ("value", "floor", "ceiling")):
            fail(f"H1 evaluate_fid: launches {fid_keys}, expected {want_fid}; row {fid_row}")
        encoder = fid["out"]["feature_fn"].encoder
        drawn = state_dict_from_jax(encoder.jax_params(1234), encoder)
        card = {name: value.cpu() for name, value in encoder.state_dict().items()}
        unequal = [name for name in drawn if not torch.equal(card[name], drawn[name])]
        val = instantiate({**compose_config(train_repa_txt_to_img.CONFIG_DIR, C1_CONFIG, c1_cuts)["dataset"]["val"]})
        batch = np.stack([val.preprocess_image(img) for img in val.images[:16]])
        on_card = fid["out"]["feature_fn"](batch)
        on_cpu = frozen_vit_features(batch.shape[1], device="cpu")(batch)
        feature_err = float(np.max(np.abs(on_card - on_cpu)) / np.max(np.abs(on_cpu)))
        if set(drawn) != set(card) or unequal or not feature_err <= H1_FEATURE_TOL:
            fail(f"H1 feature ViT: {len(unequal)} arrays differ from the jax_prng draw {unequal[:3]}; features card "
                 f"vs CPU {feature_err:.3e} (tol {H1_FEATURE_TOL})")
    finally:
        os.chdir(cwd)

    def train_line(tag: str, tr: dict) -> str:
        return (f"{tag} {tr['trainer'].step} steps in {tr['train_s']:.1f} s, ms/step start to start median after the "
                f"first two {tr['steady']:.2f} (min {min(tr['step_ms']):.2f} max {max(tr['step_ms']):.2f}; train_step "
                f"alone {tr['kernel_ms']:.2f}), samples/s {H1_BATCH / tr['steady'] * 1e3:.1f}, peak mem "
                f"{tr['peak_gib']:.2f} GiB, train loss {[round(x, 5) for x in tr['losses']]} val loss "
                f"{[round(x, 5) for x in tr['val_losses']]}, launches a step {tr['step_keys'][0]}, in the run "
                f"{ {k: v for k, v in tr['launches'].items() if v} }")

    cuts = ", ".join([f"{key} {old} -> {new}" for key, (old, new) in {**H1_BUILD, **H1_CUTS, **H1_EVAL}.items()])
    seconds = {k: round(v, 1) for k, v in build["out"]["seconds"].items()}
    print(f"phase 24 H1 the hard txt2img benchmark (cut: {cuts}; widths, batch 64 and the configs as composed): "
          f"(a) build_hard_txt2img at {H1_PX} px: seconds {seconds} ({build['s']:.1f} in all, peak mem "
          f"{build['peak_gib']:.2f} GiB), tower recon mse {report['mse']:.5f} psnr {report['psnr']:.2f} dB, "
          f"judge-on-recons {report['judge']}, shard bytes {build['out']['shard_bytes']}, no K1-K5; "
          + train_line("(b) train_hard_txt2img_mmdit", mmdit)
          + f"; (c) " + train_line("embedder=trainable trainer.train_embedder=true", trainable)
          + f", {len(moved)} encoder parameters moved and held in the checkpoint's params; (d) "
          + train_line("train_hard_txt2img_sprint", sprint)
          + f"; train_hard_txt2img_ddt refused: TypeError {ddt_error!r} (F3); (e) evaluate_txt2img "
          + "; ".join(f"{Path(r['ckpt']).name}: {r['generate_s']:.1f} s to sample and decode {n_eval} "
                      f"({r['images_per_s']:.2f} images/s)" for r in rows)
          + f", floor {evaluation['out']['floor']:.3f}, tower ceiling {evaluation['out']['ceiling']:.3f}, judge on "
          f"recons {evaluation['out']['recon_judge']}, launches {eval_keys}, {evaluation['s']:.1f} s in all; (f) "
          f"evaluate_fid {C1_CONFIG} ema {H1_FID_SAMPLES} samples CFG {H1_GUIDANCE}: {fid_row['generate_s']:.1f} s "
          f"({fid_row['images_per_s']:.2f} images/s), launches {fid_keys}, {fid['s']:.1f} s in all; feature ViT on the "
          f"card bitwise the jax_prng draw ({len(drawn)} arrays), features card vs CPU max rel {feature_err:.3e} (tol "
          f"{H1_FEATURE_TOL}); phase {time.perf_counter() - t_phase:.1f} s")
    for r in rows:
        print(json.dumps({k: v for k, v in r.items() if k not in ("fake", "images_per_s", "generate_s")}))
    print(json.dumps({k: v for k, v in fid_row.items() if k not in ("images_per_s", "generate_s")}))
    return {"mmdit": mmdit["launches"], "trainable": trainable["launches"], "sprint": sprint["launches"],
            "evaluate_txt2img": evaluation["launches"], "evaluate_fid": fid["launches"], "kernels": h1_kernels,
            "step_ms": {"mmdit": mmdit["steady"], "trainable": trainable["steady"], "sprint": sprint["steady"]}}


@contextlib.contextmanager
def uncounted():
    """Launches inside the block leave every counter as it was (a check's
    own forwards are not the main path's)."""
    from diffulab_tpu_torch.ops.flash_attention import LAUNCHES as FLASH
    from diffulab_tpu_torch.ops.flash_attention import LAUNCHES_BY_KEYS as FLASH_KEYS
    from diffulab_tpu_torch.ops.fused_mha import LAUNCHES as FUSED
    from diffulab_tpu_torch.ops.fused_mha import LAUNCHES_BY_KEYS as FUSED_KEYS

    saved = [(counts, dict(counts)) for counts in (FUSED, FLASH, FUSED_KEYS, FLASH_KEYS)]
    try:
        yield
    finally:
        for counts, values in saved:
            counts.clear()
            counts.update(values)


def trace_breakdown(trace_file: Path) -> dict[str, float]:
    """Device ms of a Chrome trace's kernels by group: the flash kernels
    (K3-K5), the GEMMs (cuBLAS's ``nvjet``, ``gemm`` and CUTLASS kernels),
    the rest; and the copies and fills. Read from the trace file: building
    ``key_averages()`` of a learn step's session takes longer than the step."""
    out = {"flash": 0.0, "gemm": 0.0, "other": 0.0, "copies": 0.0}
    for event in json.loads(trace_file.read_text())["traceEvents"]:
        cat, name = event.get("cat"), event.get("name", "").lower()
        if cat == "kernel":
            group = "flash" if "flash_" in name else "gemm" if any(
                k in name for k in ("nvjet", "gemm", "xmma", "cutlass")) else "other"
        elif cat in ("gpu_memcpy", "gpu_memset"):
            group = "copies"
        else:
            continue
        out[group] += event.get("dur", 0) / 1e3
    return out


def write_grpo_data(root: Path) -> None:
    """``ImageNetmultiAR`` shards under ``root/data/grpo/{train,val}``, written
    from a seed by the port's ShardedDatasetWriter, one sample a prompt of
    I1_PROMPTS: 32x32x128 latents, a caption of the hard dataset's caption
    table, ``caption_embeddings`` [128, 2048] and the prompt's length as its
    ``caption_mask``; and ``root/data/null_embedding.npy`` [128, 2048], which
    the config's PrecomputedEmbedder reads."""
    import numpy as np

    from diffulab_tpu_torch.data.streaming import ShardedDatasetWriter
    from diffulab_tpu_torch.data.synthetic_txt2img import SyntheticCompositionalDataset

    rng = np.random.default_rng(25)
    captions = iter(SyntheticCompositionalDataset(n_samples=sum(map(len, I1_PROMPTS.values())), seed=0).captions)
    for split, lengths in I1_PROMPTS.items():
        with ShardedDatasetWriter(root / "data" / "grpo" / split, shard_size=8) as writer:
            for length in lengths:
                writer.write({"vision_latents": rng.standard_normal((32, 32, 128), dtype=np.float32),
                              "caption": next(captions),
                              "caption_embeddings": rng.standard_normal((TEXT_LEN, TEXT_DIM), dtype=np.float32),
                              "caption_mask": np.arange(TEXT_LEN) < length})
    np.save(root / "data" / "null_embedding.npy", rng.standard_normal((TEXT_LEN, TEXT_DIM), dtype=np.float32))


def _i1_gradients(captured: dict, cfg: dict) -> dict[str, Any]:
    """One learn step's parameter gradients on the kernel path and on the
    plain path (the same model with ``attention_impl="xla"``, autograd of
    the plain forward), on the first learn step's trajectory, advantages and
    indices, with the trained weights."""
    import torch

    from diffulab_tpu_torch.config import instantiate
    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.training.checkpoint import map_tensors

    diffuser = captured["diffuser"]
    model = diffuser.denoiser
    plain = instantiate({**cfg["model"], "attention_impl": "xla"}, context_embedder=model.context_embedder,
                        dtype=torch.bfloat16)
    plain.load_state_dict(model.state_dict(), strict=True)
    sampling = map_tensors(captured["sampling"], lambda t: t.cuda())
    grads, losses, keys = [], [], []
    for m in (model, plain):
        m.train().zero_grad(set_to_none=True)
        reset_launch_counts()
        out = diffuser.diffusion.compute_loss_grpo(
            Diffuser._model_fn(m, train=True), captured["cond"], sampling, captured["advantages"],
            indices=captured["indices"], eps=0.1, timestep_fraction=0.6, guidance_scale=captured["guidance"],
            backward=True)
        torch.cuda.synchronize()
        keys.append(launch_keys())
        losses.append({k: float(v) for k, v in out.items()})
        grads.append({n: p.grad for n, p in m.named_parameters()})
    want = {(name, "bfloat16", I1_SEQ): I1_K * I1_BLOCKS for name in FLASH_KERNELS}
    worst, worst_name, unused = 0.0, None, []
    for name, g in grads[0].items():
        r = grads[1][name]
        if g is None and r is None:
            unused.append(name)
            continue
        if g is None or r is None or not bool(torch.isfinite(g).all()):
            fail(f"I1 gradients: {name} missing or non-finite")
        rel = float((g.float() - r.float()).norm() / r.float().norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    if keys[0] != want or keys[1] or worst > TXT_GRAD_TOL \
            or not all(name.startswith(f"layers.{I1_BLOCKS - 1}.") for name in unused):
        fail(f"I1 gradients: launches kernel path {keys[0]} (expected {want}), plain {keys[1]}; worst "
             f"||kernel - plain|| / ||plain|| {worst:.3e} at {worst_name} (tol {TXT_GRAD_TOL}); no gradient {unused}")
    model.zero_grad(set_to_none=True)
    del plain
    torch.cuda.empty_cache()
    return {"worst": worst, "worst_name": worst_name, "unused": len(unused), "losses": losses}


def _i1_lora(root: Path, c1: dict, log: Path) -> dict[str, Any]:
    """Phase 25b: ``train_diffusion`` on C1's config with LoRA and DoRA
    adapters of rank 8 on phase 14's run (``trainer.lora_from`` its
    ``denoiser``), phase 14's cuts, one epoch each: at step 0 the wrapped
    model's output bitwise the base's and the optimizer holding the adapters
    alone; 10 fp32 K1 + 10 fp32 K2 a step at 256 keys; after training,
    ``merge_lora`` against the adapted forward; then a 16-image ``sample``
    request from the LoRA run's ``ema`` onto the base (500 K1)."""
    import copy

    import numpy as np
    import torch

    from diffulab_tpu_torch.config import compose_config, instantiate
    from diffulab_tpu_torch.examples import train_diffusion
    from diffulab_tpu_torch.training.checkpoint import restore_train_modules
    from diffulab_tpu_torch.training.lora import count_lora_params, is_lora_param, merge_lora

    base_ckpt = c1["run"] / "checkpoints" / "denoiser"
    c1_cuts = [f"{key}={new}" for key, (_, new) in C1_CUTS.items()]
    cfg = compose_config(train_diffusion.CONFIG_DIR, C1_CONFIG, c1_cuts)
    steps = C1_CUTS["dataset.train.n_samples"][1] // C1_BATCH
    want_step = {(name, "float32", C1_SEQ): C1_DEPTH for name in ("fused_mha_fwd", "fused_mha_bwd")}
    out = {}
    for variant in ("lora", "dora"):
        lora_cfg = [f"trainer.lora_rank={I1_LORA_RANK}", f"trainer.lora_from={base_ckpt}",
                    f"trainer.lora_variant={variant}"]
        checks: dict[str, Any] = {}

        def first_step(diffuser, optimizer, ema, batch, t, *args, **kwargs):
            model = diffuser.denoiser
            in_opt = {id(p) for group in optimizer.optimizer.param_groups for p in group["params"]}
            adapters = {id(p) for n, p in model.named_parameters() if is_lora_param(n)}
            checks.update(model=model, adapters=len(adapters), optimizer_holds_adapters=bool(in_opt) and in_opt == adapters)
            mi = batch["model_inputs"]
            inputs = dict(x=mi["x"][:16], timesteps=t[:16], cond={"y": mi["y"][:16]},
                          drop=torch.zeros(16, dtype=torch.bool, device="cuda"), train=False)
            with uncounted(), torch.no_grad():
                base = instantiate(cfg["model"], device="cuda")
                restore_train_modules(base_ckpt, base)
                checks["identity"] = torch.equal(model(**inputs)["x"], base(**inputs)["x"])
                checks["inputs"] = inputs
            del base

        project = f"i1_c1_{variant}"
        tr = _timed_train_cli(train_diffusion.main, ["--config-name", C1_CONFIG, *c1_cuts, *lora_cfg,
                                                     f"trainer.save_path={root}", f"trainer.project_name={project}"],
                              log, root / project, 1, steps, f"I1 {variant}", before_first_step=first_step)
        if not checks.get("identity") or not checks.get("optimizer_holds_adapters") \
                or any(k != want_step for k in tr["step_keys"]):
            fail(f"I1 {variant}: step 0 output bitwise the base's {checks.get('identity')}, the optimizer holding the "
                 f"{checks.get('adapters')} adapters alone {checks.get('optimizer_holds_adapters')}, launches a step "
                 f"{tr['step_keys'][:1]} (expected {want_step})")
        model = checks["model"]
        with uncounted(), torch.no_grad():
            model.eval()
            adapted = model(**checks["inputs"])["x"]
            merged_model = copy.deepcopy(model)
            n_merged = merge_lora(merged_model)
            merged = merged_model(**checks["inputs"])["x"]
        merge_rel = float((merged - adapted).abs().max() / adapted.abs().max())
        if n_merged * (3 if variant == "dora" else 2) != checks["adapters"] or count_lora_params(merged_model) \
                or not merge_rel <= I1_MERGE_TOL:
            fail(f"I1 {variant}: merge_lora folded {n_merged} adapters, merged vs adapted rel {merge_rel:.3e} "
                 f"(tol {I1_MERGE_TOL})")
        del merged_model
        result = _sample_request(["--config-name", C1_CONFIG, "--ckpt", str(root / project / "checkpoints" / "ema"),
                                  "--n", str(C1_SAMPLES), "--guidance", str(C1_GUIDANCE), "--labels",
                                  ",".join(str(i) for i in range(10)), "--out", str(root / f"{project}.png"), *c1_cuts,
                                  *lora_cfg], log)
        if result["launches"]["fused_mha_fwd"] != C1_STEPS * C1_DEPTH or result["images"].shape != (
                C1_SAMPLES, 32, 32, 3) or not np.isfinite(result["images"]).all():
            fail(f"I1 {variant} sample: launches {result['launches']}, images {result['images'].shape}")
        out[variant] = dict(tr=tr, adapters=checks["adapters"], merge_rel=merge_rel, n_merged=n_merged,
                            sample=result)
        del model, checks
        torch.cuda.empty_cache()
    return out


def phase_i1(root: Path, c1: dict) -> dict[str, Any]:
    """Phase 25: slice I1. (a) ``train_grpo --config-name train_grpo_alignment
    --luma-judge`` in process from a working directory of its own (the
    config's ``data/null_embedding.npy`` unedited), the model block as
    composed at full width in bf16, the Flux2 tower at full width with its
    seeded init, cut by I1_CUTS, the faults of I1_FAULTS overridden, on
    :func:`write_grpo_data`'s 4 train and 2 validation prompts: per sampled
    group 300 bf16 K3 at 1152 keys (12 blocks x 25 EM steps under fused
    CFG), per learn step 180 K3, 180 K4 and 180 K5 (12 x 15 trajectory
    indices), the first group of each train batch at ``ratio_dev`` within
    I1_RATIO_TOL, every loss finite, the best-val checkpoint restoring to the
    trained weights; the sampled group, learn step, decode and batch timed
    (the card synchronised), the learn steps by ``profiling.StepTimer``, the
    last train learn step inside ``profiling.trace`` (its Chrome trace
    written); then one learn step's gradients on the kernel path against the
    plain path (:func:`_i1_gradients`) and the bf16 K3/K4/K5 at GRPO's shape
    (:func:`flash_kernel_rows`: B=4 under CFG, H=10, S=1152, the train
    prompts' caption mask and the null embedding's); (b) :func:`_i1_lora`.
    Each count window set to 0 just before and read just after."""
    import os

    import torch

    from diffulab_tpu_torch.config import compose_config
    from diffulab_tpu_torch.examples import train_grpo
    from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiTBlock
    from diffulab_tpu_torch.networks.vision_towers.flux2 import Flux2VAE
    from diffulab_tpu_torch.training import profiling
    from diffulab_tpu_torch.training.checkpoint import to_cpu
    from diffulab_tpu_torch.training.grpo_trainer import GRPOTrainer

    sys.modules["wandb"] = None
    t_phase = time.perf_counter()
    work = root / "i1"
    work.mkdir()
    log = root / "i1.log"
    overrides = [f"{key}={new}" for key, (_, new) in I1_CUTS.items()] + [
        f"dataset.{split}.{key}={value}" for split in ("train", "val") for key, value in (
            ("_target_", "diffulab_tpu.data.imagenet.ImageNetmultiAR"), ("data_path", "data/grpo"),
            ("cache_dir", "cache"))] + [f"vision_tower.latent_channels={I1_FAULTS['vision_tower.latent_channels'][1]}"]
    cfg = compose_config(train_grpo.CONFIG_DIR, I1_CONFIG, overrides)
    n_train_learn = len(I1_PROMPTS["train"]) // I1_BATCH * I1_IMAGES
    samples, learns, decodes, batches, captured = [], [], [], [], {}
    timer = profiling.StepTimer(warmup=1)
    trace_dir = root / "i1_trace"
    originals = (GRPOTrainer.sample_group, GRPOTrainer.learn_step, GRPOTrainer._run_batch, Flux2VAE.decode)

    def sample_group(*args, **kwargs):
        torch.cuda.synchronize()
        keys, t0 = launch_keys(), time.perf_counter()
        out = originals[0](*args, **kwargs)
        torch.cuda.synchronize()
        samples.append(((time.perf_counter() - t0) * 1e3, key_diff(launch_keys(), keys)))
        return out

    def learn_step(self, *args):
        if not captured:
            captured.update(diffuser=args[0], cond=args[5], sampling=to_cpu(args[6]), advantages=args[7].clone(),
                            indices=list(args[8]), guidance=args[10])
        traced = len(learns) == n_train_learn - 1
        torch.cuda.synchronize()
        keys, t0 = launch_keys(), time.perf_counter()
        if traced:
            with profiling.trace(trace_dir):
                losses = originals[1](self, *args)
        else:
            with timer.step():
                losses = originals[1](self, *args)
        torch.cuda.synchronize()
        learns.append(((time.perf_counter() - t0) * 1e3, key_diff(launch_keys(), keys),
                       {k: float(v) for k, v in losses.items()}, traced))
        return losses

    def run_batch(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = originals[2](self, *args, **kwargs)
        torch.cuda.synchronize()
        batches.append(((time.perf_counter() - t0) * 1e3, kwargs["train"]))
        return step

    def decode(self, z):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = originals[3](self, z)
        torch.cuda.synchronize()
        decodes.append((time.perf_counter() - t0) * 1e3)
        return out

    cwd = os.getcwd()
    os.chdir(work)
    try:
        write_grpo_data(work)
        GRPOTrainer.sample_group, GRPOTrainer.learn_step = staticmethod(sample_group), learn_step
        GRPOTrainer._run_batch, Flux2VAE.decode = run_batch, decode
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        (trainer,) = _run_cli(train_grpo.main, ["--config-name", I1_CONFIG, "--luma-judge", *overrides,
                                                "trainer.save_path=runs"], log)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches, run_keys = launch_counts(), launch_keys()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        GRPOTrainer.sample_group = staticmethod(originals[0])
        GRPOTrainer.learn_step, GRPOTrainer._run_batch, Flux2VAE.decode = originals[1:]
        os.chdir(cwd)
    run = work / "runs" / "grpo_alignment"
    model = captured["diffuser"].denoiser
    blocks = len(model.layers)
    sample_keys = {("flash_attn_fwd", "bfloat16", I1_SEQ): I1_STEPS * I1_BLOCKS}
    learn_keys = {(name, "bfloat16", I1_SEQ): I1_K * I1_BLOCKS for name in FLASH_KERNELS}
    n_val = len(I1_PROMPTS["val"]) // I1_BATCH
    n_groups = (len(I1_PROMPTS["train"]) // I1_BATCH + n_val) * I1_IMAGES
    want_k3 = (n_groups * I1_STEPS + (n_train_learn + n_val * I1_IMAGES) * I1_K + I1_STEPS) * I1_BLOCKS
    want = {"flash_attn_fwd": want_k3, "flash_attn_bwd_dkv": n_train_learn * I1_K * I1_BLOCKS,
            "flash_attn_bwd_dq": n_train_learn * I1_K * I1_BLOCKS}
    if blocks != I1_BLOCKS or not all(isinstance(m, MMDiTBlock) for m in model.layers):
        fail(f"I1: the model has {blocks} blocks, expected {I1_BLOCKS} dual-stream blocks")
    if len(samples) != n_groups or any(k != sample_keys for _, k in samples) or len(learns) != n_train_learn \
            or any(k != learn_keys for _, k, _, _ in learns) or {k: launches[k] for k in want} != want \
            or any(launches[k] for k in ("fused_mha_fwd", "fused_mha_bwd", *(f"{name}_f32" for name in FLASH_KERNELS))) \
            or any(n for (name, _, _), n in run_keys.items() if name.startswith("fused")):
        fail(f"I1 GRPO: {len(samples)} sampled groups, launches {[k for _, k in samples][:1]} (expected "
             f"{sample_keys}); {len(learns)} learn steps, launches {[k for _, k, _, _ in learns][:1]} (expected "
             f"{learn_keys}); run {launches} (expected {want} and no K1/K2)")
    first = [learns[i][2]["ratio_dev"] for i in range(0, n_train_learn, I1_IMAGES)]
    metrics = {k: v for line in (run / "metrics.jsonl").read_text().splitlines()
               for k, v in json.loads(line).items()}
    if trainer.step != n_train_learn or not all(r <= I1_RATIO_TOL for r in first) \
            or not all(math.isfinite(m["loss"]) for _, _, m, _ in learns) or not math.isfinite(metrics["val/loss"]):
        fail(f"I1 GRPO: step counter {trainer.step}, first-group ratio_dev {first} (tol {I1_RATIO_TOL}), losses "
             f"{[m['loss'] for _, _, m, _ in learns]}, val/loss {metrics.get('val/loss')}")
    check_restores(run, model, "I1 GRPO")
    n_steps = trainer.step
    trace_file = trace_dir / profiling.TRACE_FILE
    if not trace_file.is_file() or trace_file.stat().st_size == 0:
        fail(f"I1 profiling: no Chrome trace at {trace_file}")
    breakdown = trace_breakdown(trace_file)
    grads = _i1_gradients(captured, cfg)
    del captured, model, trainer
    torch.cuda.empty_cache()

    lengths = torch.tensor(I1_PROMPTS["train"][:I1_BATCH], device="cuda")
    text = torch.cat([torch.arange(TEXT_LEN, device="cuda")[None, :] < lengths[:, None],
                      (torch.arange(TEXT_LEN, device="cuda") < NULL_SEQ_LEN)[None].expand(I1_BATCH, -1)])
    mask = torch.cat([text, torch.ones(2 * I1_BATCH, I1_SEQ - TEXT_LEN, dtype=torch.bool, device="cuda")], dim=1)
    kernels = flash_kernel_rows("phase 25 kernels bf16 at GRPO's shape", "I1", I1_HEADS, mask, seed=25,
                                shape=f"B={2 * I1_BATCH} (2 prompts under fused CFG) S={I1_SEQ} (128 caption + 1024 "
                                      f"image tokens) H={I1_HEADS} D=64 bf16, the prompts' caption mask and the null "
                                      "embedding's")
    lora = _i1_lora(root, c1, log)

    sampled = [ms for ms, _ in samples]
    per_step = {key: [m[key] for _, _, m, _ in learns] for key in ("loss", "ratio_dev", "grad_norm", "tr_reject")}
    first_s = ", ".join(f"{r:.3e}" for r in first)
    ratio_s = ", ".join(f"{r:.2e}" for r in per_step["ratio_dev"])
    grad_s = ", ".join(f"{g:.3e}" for g in per_step["grad_norm"])
    steps = timer.summary
    traced_ms = next(ms for ms, _, _, traced in learns if traced)
    cuts = ", ".join(f"{key} {old} -> {new}" for key, (old, new) in I1_CUTS.items())
    faults = ", ".join(f"{key} {old} -> {new}" for key, (old, new) in I1_FAULTS.items())
    print(f"phase 25 I1 GRPO {I1_CONFIG} through train_grpo --luma-judge (the model block as composed: {blocks} "
          f"dual-stream blocks of 640, {I1_HEADS} heads of 64, patch 1, 128 channels, bf16; the Flux2 tower at full "
          f"width, seeded init; 512x512, EM-{I1_STEPS} CFG 4.0, timestep_fraction 0.6, eps 0.1, trust region 0.3, EMA; "
          f"cut: {cuts}; data {len(I1_PROMPTS['train'])} train + {len(I1_PROMPTS['val'])} validation prompts; config "
          f"faults overridden: {faults}): run {run_s:.1f} s, {n_steps} learn steps; ms a sampled group "
          f"(P={I1_BATCH}, model batch {2 * I1_BATCH} x {I1_SEQ} tokens) median {statistics.median(sampled):.1f} (min "
          f"{min(sampled):.1f} max {max(sampled):.1f}, {len(sampled)} groups, the decode included); ms a learn step "
          f"({I1_K} indices, one backward each) StepTimer p50 {steps['p50_s'] * 1e3:.1f} mean {steps['mean_s'] * 1e3:.1f} "
          f"over {steps['steps']} (the first excluded), traced step {traced_ms:.1f}; decode ms median "
          f"{statistics.median(decodes):.1f} ({len(decodes)} decodes of {I1_BATCH} or fewer 512x512 images); ms a batch "
          + ", ".join(f"{'train' if train else 'val'} {ms:.0f}" for ms, train in batches)
          + f"; peak mem {peak_gib:.2f} GiB; launches a sampled group {sample_keys}, a learn step {learn_keys}, in the run "
          f"{ {k: launches[k] for k in want} } and no K1/K2; first-group ratio_dev [{first_s}] (tol "
          f"{I1_RATIO_TOL}); losses {[round(x, 5) for x in per_step['loss']]}, ratio_dev [{ratio_s}], grad_norm "
          f"[{grad_s}], tr_reject {per_step['tr_reject']}; "
          f"val/loss {metrics['val/loss']:.5f}, val/judge_score {metrics.get('val/judge_score', float('nan')):.4f}; "
          f"best-val checkpoint restores; gradients of the first learn step, kernel path vs plain path, worst "
          f"||kernel - plain|| / ||plain|| {grads['worst']:.3e} at {grads['worst_name']} (tol {TXT_GRAD_TOL}), "
          f"{grads['unused']} parameters of the last block's text stream without a gradient on both, loss kernel "
          f"{grads['losses'][0]['loss']:.6f} plain {grads['losses'][1]['loss']:.6f}; profiling.trace wrote "
          f"{trace_file.stat().st_size} bytes, the traced step's device time by torch.profiler "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in breakdown.items())
          + f" ({sum(breakdown.values()):.1f} busy, {sum(breakdown.values()) / steps['p50_s'] / 1e3:.1%} of the "
          f"untraced p50 step)")
    print(f"phase 25b LoRA {C1_CONFIG} (phase 14's cuts, rank {I1_LORA_RANK}, trainer.lora_from phase 14's denoiser): "
          + "; ".join(f"{variant}: {r['adapters']} adapter tensors, step 0 output bitwise the base's, the optimizer "
                      f"holding the adapters alone, {r['tr']['trainer'].step} steps ms/step median "
                      f"{r['tr']['steady']:.2f} (C1's {c1['step_ms']:.2f}), peak mem {r['tr']['peak_gib']:.2f} GiB, "
                      f"train loss {[round(x, 5) for x in r['tr']['losses']]}, {C1_DEPTH} fp32 K1 + {C1_DEPTH} fp32 K2 "
                      f"a step; merge_lora folded {r['n_merged']}, merged vs adapted max rel {r['merge_rel']:.2e} (tol "
                      f"{I1_MERGE_TOL}); sample {C1_SAMPLES} images from the run's ema onto the base "
                      f"{r['sample']['generate_ms']:.1f} ms, {r['sample']['launches']['fused_mha_fwd']} K1"
                      for variant, r in lora.items())
          + f"; phase {time.perf_counter() - t_phase:.1f} s")
    lora_windows = {f"i1_{variant}_{w}": (r["tr"]["launches"] if w == "train" else r["sample"]["launches"])
                    for variant, r in lora.items() for w in ("train", "sample")}
    return {"grpo": {k: launches[k] for k in want}, "kernels": kernels, "lora": lora_windows,
            "sampled_ms": statistics.median(sampled), "learn_ms": steps["p50_s"] * 1e3, "peak_gib": peak_gib}


def _dit_b2_sampler():
    """Phases 2-4's DiT-B/2 (the seed-0 weights of :func:`build_models`) and
    phase 4's diffuser (Euler-50, rectified flow)."""
    import torch

    from diffulab_tpu_torch.diffuse import Diffuser
    from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT

    model = MMDiT(**DIT_B2, dtype=torch.bfloat16, stream_dtype=torch.bfloat16)
    randomize_(model, seed=0)
    return Diffuser(model.eval(), "euler", model_type="rectified_flow", n_steps=STEPS,
                    extra_args={"logits_normal": True})


def phase_j1_deploy(root: Path) -> dict[str, Any]:
    """Phase 26a: phase 4's request (DiT-B/2, batch 16, Euler-50, CFG 4.0,
    bf16) exported with ``deploy.export_generate`` and loaded back by
    ``DeployedSampler`` on the card. Each of J1_REQUESTS seeds runs the
    artifact, then the live ``generate`` from ``torch.Generator("cuda")`` with
    that seed and the same labels: the images equal (J1_DEPLOY_TOL), the
    artifact's request exactly 600 K1 and no other kernel (the counts set to
    0 just before it and read just after); export and load seconds, the
    artifact's bytes, and each path's ms a request, the minimum over the
    interleaved calls (the card synchronised, the images copied to the host
    on both)."""
    import numpy as np
    import torch

    from diffulab_tpu_torch.deploy import DeployedSampler, TensorSpec, export_generate

    diffuser = _dit_b2_sampler()
    art = root / "dit_b2_artifact"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export_generate(diffuser, {"y": TensorSpec((), torch.int64)}, SAMPLE_BATCH, LATENT, art, guidance_scale=CFG,
                    clamp_x=False, dtype=torch.bfloat16)
    export_s = time.perf_counter() - t0
    art_bytes = {p.name: p.stat().st_size for p in art.iterdir()}
    t0 = time.perf_counter()
    sampler = DeployedSampler(art)
    load_s = time.perf_counter() - t0
    y = torch.randint(0, 1000, (SAMPLE_BATCH,), generator=torch.Generator(device="cuda").manual_seed(99),
                      device="cuda")
    per_request = STEPS * DIT_B2["depth"]
    art_ms, live_ms, diffs, windows = [], [], [], []
    for r in range(J1_REQUESTS):
        seed = 100 + r
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sampler(seed=seed, y=y.cpu().numpy())
        art_ms.append((time.perf_counter() - t0) * 1e3)
        windows.append(launch_counts())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = diffuser.generate({"y": y}, data_shape=(SAMPLE_BATCH, *LATENT),
                                generator=torch.Generator(device="cuda").manual_seed(seed), guidance_scale=CFG,
                                dtype=torch.bfloat16, device="cuda")["x"].float().cpu().numpy()
        live_ms.append((time.perf_counter() - t0) * 1e3)
        if out.shape != (SAMPLE_BATCH, *LATENT) or not np.isfinite(out).all():
            fail(f"DiT-B/2 artifact request {r}: output {out.shape}, finite {np.isfinite(out).all()}")
        diffs.append(float(np.abs(out - ref).max()))
    for w in windows:
        others = {k: n for k, n in w.items() if n and not k.startswith("fused_mha_fwd")}
        if w["fused_mha_fwd"] != per_request or w["fused_mha_fwd_bf16"] != per_request or others:
            fail(f"DiT-B/2 artifact request: launches {w}, expected {per_request} bf16 K1 and no other kernel")
    if max(diffs) > J1_DEPLOY_TOL:
        fail(f"DiT-B/2 artifact against the live generate: max |diff| {diffs} (tol {J1_DEPLOY_TOL})")
    print(f"phase 26a DiT-B/2 artifact (batch {SAMPLE_BATCH} {LATENT} Euler-{STEPS} CFG {CFG} bf16): export "
          f"{export_s:.2f} s, {sum(art_bytes.values())} bytes {art_bytes}, load {load_s:.2f} s; {J1_REQUESTS} "
          f"requests interleaved, artifact ms {[round(m, 2) for m in art_ms]} (min {min(art_ms):.2f}) vs live "
          f"generate ms {[round(m, 2) for m in live_ms]} (min {min(live_ms):.2f}); images vs live, same seed and "
          f"labels: max |diff| {diffs} (tol {J1_DEPLOY_TOL}); {per_request} bf16 K1 a request, no other kernel")
    return {"launches": windows[0], "export_s": export_s, "bytes": sum(art_bytes.values()), "load_s": load_s,
            "artifact_ms": min(art_ms), "live_ms": min(live_ms), "max_abs_diff": max(diffs)}


def phase_j1_serve(root: Path, c1_run: Path) -> dict[str, Any]:
    """Phase 26b: phase 14's C1 run (its ``ema`` entry) through the port's
    ``export_sampler --smoke`` (a batch of C1_SAMPLES at CFG C1_GUIDANCE,
    Euler-C1_STEPS, fp32), then ``serve.make_handler`` on 127.0.0.1, port 0,
    in a thread after one warm call: a ``POST /generate`` of J1_SERVE_ROWS
    labels (padded to the batch with the last one, trimmed on the way out;
    its decoded uint8 images equal to ``DeployedSampler``'s first rows for
    that seed and the padded labels), a ``GET /healthz`` (the manifest) and
    a malformed request (a 400). The counts set to 0 just before the smoke
    batch and before the served request, read just after: 500 fp32 K1 each."""
    import base64
    import threading
    from http.server import HTTPServer
    from urllib import error, request

    import numpy as np

    from diffulab_tpu_torch.deploy import DeployedSampler
    from diffulab_tpu_torch.examples import export_sampler, serve

    log = root / "j1.log"
    overrides = [f"{key}={new}" for key, (_, new) in C1_CUTS.items()]
    art = root / "c1_artifact"
    per_request = C1_STEPS * C1_DEPTH
    reset_launch_counts()
    t0 = time.perf_counter()
    result = _run_cli(export_sampler.main, ["--config-name", C1_CONFIG, "--ckpt", str(c1_run / "checkpoints" / "ema"),
                                            "--out", str(art), "--batch-size", str(C1_SAMPLES), "--guidance",
                                            str(C1_GUIDANCE), "--smoke", *overrides], log)
    cli_s = time.perf_counter() - t0
    smoke = launch_counts()
    if smoke["fused_mha_fwd"] != per_request or smoke["fused_mha_fwd_bf16"] or smoke["flash_attn_fwd"]:
        fail(f"C1 export_sampler --smoke: launches {smoke}, expected {per_request} fp32 K1 and no K3")
    if result["smoke"].shape != (C1_SAMPLES, 32, 32, 3) or not np.isfinite(result["smoke"]).all():
        fail(f"C1 export_sampler --smoke: batch {result['smoke'].shape}")
    sampler = DeployedSampler(art)
    serve.warm(sampler)
    server = HTTPServer(("127.0.0.1", 0), serve.make_handler(sampler))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def call(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        try:
            with request.urlopen(request.Request(url + path, data=data), timeout=120) as r:
                return r.status, json.loads(r.read())
        except error.HTTPError as e:
            return e.code, json.loads(e.read())

    labels = list(range(J1_SERVE_ROWS))
    with open(log, "a") as f, contextlib.redirect_stdout(f):
        thread.start()
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            status, body = call("/generate", {"seed": 7, "y": labels})
            served_ms = (time.perf_counter() - t0) * 1e3
            served = launch_counts()
            health_status, health = call("/healthz")
            bad_status, bad = call("/generate", {"seed": 7, "y": [[1, 2]]})
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
    if status != 200 or body["shape"] != [J1_SERVE_ROWS, 32, 32, 3]:
        fail(f"C1 serve: POST /generate {status} {body.get('error', body.get('shape'))}")
    images = np.frombuffer(base64.b64decode(body["images"]), np.uint8).reshape(body["shape"])
    padded = np.array(labels + [labels[-1]] * (C1_SAMPLES - J1_SERVE_ROWS))
    direct = sampler(seed=7, y=padded)[:J1_SERVE_ROWS]
    if not np.array_equal(images, ((np.clip(direct, -1, 1) + 1) * 127.5).astype(np.uint8)):
        fail("C1 serve: the served images differ from DeployedSampler's first rows for that seed")
    if health_status != 200 or health["manifest"] != sampler.manifest or bad_status != 400 or not bad.get("error"):
        fail(f"C1 serve: /healthz {health_status}, malformed request {bad_status} {bad}")
    if served["fused_mha_fwd"] != per_request or served["fused_mha_fwd_bf16"] or served["flash_attn_fwd"]:
        fail(f"C1 serve: launches of the served request {served}, expected {per_request} fp32 K1 and no K3")
    print(f"phase 26b C1 CLIs: export_sampler --smoke on {C1_CONFIG}'s ema (batch {C1_SAMPLES}, CFG {C1_GUIDANCE}, "
          f"Euler-{C1_STEPS}, fp32) in {cli_s:.2f} s, {result['bytes']} bytes, {per_request} fp32 K1 in the smoke "
          f"batch; serve: POST /generate of {J1_SERVE_ROWS} labels {served_ms:.1f} ms, {body['shape']} uint8 images "
          f"equal to DeployedSampler's first rows, {per_request} fp32 K1; GET /healthz the manifest; a malformed "
          f"request {bad_status} ({bad['error']!r})")
    return {"smoke": smoke, "served": served, "served_ms": served_ms}


def phase_j1_ops():
    """Phase 26c: each kernel's custom op (``torch.ops.diffulab_tpu_torch``)
    once on CUDA tensors, against its direct wrapper (the op's CUDA
    implementation) on the same inputs: the kernel's counter up by exactly
    one and no other kernel's, the outputs bit for bit. K1/K2 at phase 2's
    sampling shape cut to B=2 (S=256, H=12, D=64, bf16); K3/K4/K5 at phase
    8's txt2img shape cut to B=2 (S=4224, the fused-CFG text mask)."""
    import torch

    from diffulab_tpu_torch.ops import flash_attention as fa
    from diffulab_tpu_torch.ops import fused_mha as fm

    ops = torch.ops.diffulab_tpu_torch
    gen = torch.Generator(device="cuda").manual_seed(26)

    def draw(s):
        return torch.randn(2, s, 12, 64, generator=gen, device="cuda").bfloat16()

    scale = 64 ** -0.5
    q, k, v, do = (draw(256) for _ in range(4))
    o, lse = fm.fused_mha_fwd_cuda(q, k, v, None, scale)
    cases = [("fused_mha_fwd", lambda: ops.fused_mha_fwd(q, k, v, None, scale), (o, lse)),
             ("fused_mha_bwd", lambda: ops.fused_mha_bwd(q, k, v, None, lse, do, scale),
              fm.fused_mha_bwd_cuda(q, k, v, None, lse, do, scale))]
    tq, tk, tv, tdo = (draw(TXT_SEQ) for _ in range(4))
    mask = txt2img_mask(1, TEXT_LENGTHS[:1])
    to, tlse = fa.flash_attention_fwd_cuda(tq, tk, tv, mask, scale)
    dk, dv, di = fa.flash_attention_bwd_dkv(tq, tk, tv, mask, to, tlse, tdo, scale)
    cases += [("flash_attn_fwd", lambda: ops.flash_attn_fwd(tq, tk, tv, mask, scale), (to, tlse)),
              ("flash_attn_bwd_dkv", lambda: ops.flash_attn_bwd_dkv(tq, tk, tv, mask, to, tlse, tdo, scale),
               (dk, dv, di)),
              ("flash_attn_bwd_dq", lambda: ops.flash_attn_bwd_dq(tq, tk, tv, mask, tlse, di, tdo, scale),
               fa.flash_attention_bwd_dq(tq, tk, tv, mask, tlse, di, tdo, scale))]
    kernels = ("fused_mha_fwd", "fused_mha_bwd", *FLASH_KERNELS)
    for name, call, direct in cases:
        before = launch_counts()
        out = call()
        torch.cuda.synchronize()
        rose = {kname: launch_counts()[kname] - before[kname] for kname in kernels}
        out, direct = (t if isinstance(t, tuple) else (t,) for t in (out, direct))
        if rose != {kname: int(kname == name) for kname in kernels}:
            fail(f"op {name}: counters rose {rose}, expected its own by one")
        if len(out) != len(direct) or not all(torch.equal(a, b) for a, b in zip(out, direct)):
            fail(f"op {name}: outputs differ from the direct wrapper's")
    print(f"phase 26c ops: {', '.join(f'torch.ops.diffulab_tpu_torch.{n}' for n, _, _ in cases)} each once on CUDA "
          f"tensors (K1/K2 B=2 S=256 H=12 D=64 bf16; K3-K5 B=2 S={TXT_SEQ} with the text mask): its counter up by "
          f"one, no other, outputs bitwise the direct wrapper's")


def _j1_stub_encode(texts):
    """A deterministic stand-in for Qwen3-VL-2B's encode (no transformers and
    no weights on the card): [B, J1_TEXT_LEN, 2048] normals seeded by the
    text's bytes, a padding mask of the prompt's valid tokens (1 for "")."""
    import numpy as np

    emb = np.stack([np.random.default_rng(sum(t.encode()) + 7).standard_normal((J1_TEXT_LEN, TEXT_DIM))
                    for t in texts]).astype(np.float32)
    lengths = [J1_TEXT_LENGTHS[J1_PROMPTS.index(t)] if t in J1_PROMPTS else 1 for t in texts]
    mask = np.arange(J1_TEXT_LEN)[None, :] < np.asarray(lengths)[:, None]
    return {"embeddings": emb, "attn_mask": mask}


def phase_j1_prompts() -> dict[str, Any]:
    """Phase 27: ``--prompts`` on the card. ``configs/embedder/qwen.yaml``'s
    ``QwenTextEmbedder`` through the port's ``instantiate`` with
    :func:`_j1_stub_encode`; the DDT of ``configs/train_imagenet_repa_txt_to_img.yaml``
    as composed (640 wide, 10 heads of 64, 8 + 4 blocks, 128 latent
    channels, bf16 by its precision_type) with seeded random weights; the 4
    prompts embedded on the host (the "" null cached), then (a) one fused-CFG
    model call whose null half is held bitwise against the same call with the
    null embedding and mask passed explicitly in those rows (no drop), (b) a
    request on J1_LATENT (Euler-50, the config's shift, CFG 4.0) held
    bitwise against the same request built from the explicit nulls, each
    request's launches by kernel and key length 50 times one call's (the
    counts set to 0 just before and read just after)."""
    import torch

    from diffulab_tpu_torch.config import compose_config, instantiate, load_yaml
    from diffulab_tpu_torch.config.instantiate import model_dtype_kwargs
    from diffulab_tpu_torch.diffuse import Diffuser

    configs = ROOT / "configs"
    embedder = instantiate(load_yaml(configs / "embedder" / "qwen.yaml"), device="cuda", encode_fn=_j1_stub_encode)
    cfg = compose_config(configs, J1_TXT_CONFIG, [])
    model = instantiate(cfg["model"], context_embedder=embedder, device="cuda", **model_dtype_kwargs(cfg["trainer"]))
    randomize_(model, seed=27)
    model.eval()
    context = {k: torch.as_tensor(v, device="cuda") for k, v in embedder.embed_host(list(J1_PROMPTS)).items()}
    null = _j1_stub_encode([""])
    null_emb, null_mask = (torch.as_tensor(null[k][0], device="cuda") for k in ("embeddings", "attn_mask"))
    b = len(J1_PROMPTS)

    def explicit(x, timesteps, cond, drop):
        ctx = cond["context"]
        emb = torch.cat([ctx["embeddings"][:b], null_emb.expand(b, -1, -1)])
        mask = torch.cat([ctx["attn_mask"][:b], null_mask.expand(b, -1)])
        return model(x=x, timesteps=timesteps, cond={"context": {"embeddings": emb, "attn_mask": mask}},
                     drop=torch.zeros_like(drop), train=False)

    def swapped(x, timesteps, cond, drop):
        return model(x=x, timesteps=timesteps, cond=cond, drop=drop, train=False)

    gen = torch.Generator(device="cuda").manual_seed(27)
    x = torch.randn(2 * b, *J1_LATENT, generator=gen, device="cuda")
    t = torch.full((2 * b,), 0.7, device="cuda")
    cond2 = {"context": {k: torch.cat([v, v]) for k, v in context.items()}}
    drop = torch.arange(2 * b, device="cuda") >= b
    with torch.no_grad():
        keys0 = launch_keys()
        out = swapped(x, t, cond2, drop)["x"]
        call_keys = key_diff(launch_keys(), keys0)
        ref = explicit(x, t, cond2, drop)["x"]
    if not torch.equal(out[b:], ref[b:]) or not torch.equal(out, ref):
        fail(f"--prompts: the CFG null half differs from the explicit null embeddings' "
             f"(max |diff| {float((out.float() - ref.float()).abs().max())})")
    n_steps = cfg["diffuser"]["n_steps"]
    diffuser = Diffuser(model, cfg["diffuser"]["sampling_method"], model_type=cfg["diffuser"]["model_type"],
                        n_steps=n_steps, extra_args=cfg["diffuser"]["extra_args"])
    requests = (lambda g: diffuser.generate({"context": context}, data_shape=(b, *J1_LATENT), generator=g,
                                            guidance_scale=CFG, device="cuda")["x"],
                lambda g: diffuser.diffusion.denoise(explicit, {"context": context}, g, data_shape=(b, *J1_LATENT),
                                                     guidance_scale=CFG, use_cfg=True,
                                                     device=torch.device("cuda"))["x"])
    windows, outs, ms = [], [], []
    for request in requests:
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            outs.append(request(torch.Generator(device="cuda").manual_seed(28)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        windows.append(launch_keys())
    if not torch.equal(outs[0], outs[1]) or not bool(torch.isfinite(outs[0]).all()):
        fail("--prompts: the request differs from the one built from the explicit null embeddings")
    want = {key: n_steps * n for key, n in call_keys.items()}
    if any(dict(w) != want for w in windows):
        fail(f"--prompts: launches by (kernel, dtype, Skv) {windows}, expected {want}")
    counts = {name: sum(n for (kname, _, _), n in windows[0].items() if kname == name)
              for name in ("fused_mha_fwd", "flash_attn_fwd")}
    print(f"phase 27 --prompts: {J1_TXT_CONFIG}'s DDT ({cfg['model']['inner_dim']} wide, "
          f"{cfg['model']['num_heads']} heads, {cfg['model']['encoder_depth']} + {cfg['model']['decoder_depth']} "
          f"blocks, bf16) with configs/embedder/qwen.yaml's QwenTextEmbedder (a stub encode_fn, [B, {J1_TEXT_LEN}, "
          f"{TEXT_DIM}], valid {list(J1_TEXT_LENGTHS)}): one CFG call's null half bitwise the explicit null "
          f"embeddings'; a {b}-prompt request on {J1_LATENT} Euler-{n_steps} (shift "
          f"{cfg['diffuser']['extra_args'].get('shift')}) CFG {CFG} in {ms[0]:.1f} ms, bitwise the explicit-null "
          f"request ({ms[1]:.1f} ms); launches a request {dict(windows[0])}, {n_steps} x one call's")
    return {"launches": counts, "keys": dict(windows[0]), "request_ms": ms[0]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    if not (ROOT / "diffulab_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the diffulab_tpu_torch package is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from diffulab_tpu_torch.utils import full_fp32_products

    full_fp32_products()  # the port's fp32 policy, as its CLIs set it: no TF32 in cuBLAS or cuDNN
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    seconds: dict[str, float] = {}
    mark = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal mark
        now = time.perf_counter()
        seconds[name] = round(now - mark, 1)
        mark = now

    phase_build()
    lap("1 build")
    kernel = phase_kernel()
    model, plain = build_models()
    phase_forward(model, plain)
    gen_counts, _ = phase_generate(model, plain)
    gen_launches = gen_counts["fused_mha_fwd"]
    lap("2-4 DiT-B/2 serving")
    k2 = phase_kernel_bwd()
    phase_gradients(model, plain)
    del plain
    train_launches, _ = phase_train(model)
    del model
    lap("5-7 DiT-B/2 training")
    k3 = phase_flash_kernel()
    crossover = k3.pop("crossover")
    txt_model, txt_plain, tower, cond = build_txt2img()
    phase_txt2img_forward(txt_model, txt_plain, cond)
    txt_totals, _ = phase_txt2img_generate(txt_model, txt_plain, tower, cond)
    lap("8-10 txt2img serving")
    k45, bwd_crossover = phase_flash_bwd_kernel(crossover)
    phase_txt2img_gradients(txt_model, txt_plain)
    del txt_plain
    txt_train_launches, _ = phase_txt2img_train(txt_model, tower)
    del txt_model, tower, cond
    torch.cuda.empty_cache()
    lap("11-13 txt2img training")
    txt32 = phase_txt2img_fp32_attention()
    lap("13b txt2img fp32 attention")
    c1_kernels = phase_c1_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        c1 = phase_c1_cli(Path(tmp))
        lap("14 C1")
        arms = phase_dit_arms()
        lap("15 DiT arms")
        c2 = phase_c2_cli(Path(tmp), c1["run"])
        lap("16 C2")
        d1_kernels = phase_d1_kernels()
        phase_d1_model()
        d1 = phase_d1_cli(Path(tmp))
        lap("17 D1")
        e1_fwd, e1_bwd = phase_e1_kernels()
        e1_hard = phase_e1_hard(Path(tmp))
        e1_color = phase_e1_colorize(Path(tmp))
        e1_repa = phase_e1_repa(Path(tmp))
        lap("18 E1")
        d2_kernels = phase_d2_kernels()
        phase_d2_model()
        d2 = phase_d2_cli(Path(tmp))
        lap("19 D2")
        f1_txt = phase_f1_txt2img_sprint()
        lap("20 F1 txt2img SprintDiT")
        f1_hard = phase_f1_hard()
        lap("21 F1 hard SprintDiT/DDT")
        f1_cli = phase_f1_cli(Path(tmp))
        lap("22 F1 CLIs")
        g1 = phase_g1(Path(tmp))
        lap("23 G1")
        h1 = phase_h1(Path(tmp), c1["run"])
        lap("24 H1")
        i1 = phase_i1(Path(tmp), c1)
        lap("25 I1")
        j1_deploy = phase_j1_deploy(Path(tmp))
        j1_serve = phase_j1_serve(Path(tmp), c1["run"])
        phase_j1_ops()
        lap("26 J1 serving")
        j1_prompts = phase_j1_prompts()
        lap("27 J1 --prompts")
    e1_windows = {"e1_hard_flow_train": e1_hard["hard_flow"]["launches"],
                  "e1_hard_distill_train": e1_hard["hard_distill"]["launches"],
                  "e1_hard_sample": e1_hard["sample"]["launches"],
                  "e1_colorize_train": e1_color["train"]["launches"], "e1_colorize_sample": e1_color["sample"]["launches"],
                  **{f"e1_{c.removeprefix('train_synthetic_')}_{w}": r[w]["launches"] for c, r in e1_repa.items()
                     for w in ("train", "sample")}}
    e1_bf16 = {k: v for k, v in e1_windows.items() if k.startswith("e1_hard")}
    e1_d64 = {k: v for k, v in e1_windows.items() if not k.startswith(("e1_hard", "e1_ddpm"))}
    e1_unet = {k: v for k, v in e1_windows.items() if k.startswith("e1_ddpm")}
    d2_windows = {f"d2_{D2_CONFIGS[c][0].removeprefix('mnist_')}_{w}": r[w] for c, r in d2.items()
                  for w in ("train", "sample")}
    k3_fp32 = k3.pop("fp32")
    k45_fp32 = {name: k45[name].pop("fp32") for name in ("flash_attn_bwd_dkv", "flash_attn_bwd_dq")}
    # the fp32 flash instances' launches in every main-path run that reads all the counts
    txt32_windows = {f"txt2img_fp32_attention_{w}": txt32[w] for w in ("forward", "generate", "train")}
    windows = {"generate": gen_counts, "train": train_launches, "txt2img_generate": txt_totals,
               "txt2img_train": txt_train_launches, **txt32_windows, "c1_train": c1["train"], "c1_sample": c1["sample"],
               "dit_sampling_arms": arms["launches"], "c2": c2, "d1_train": d1["train"], "d1_sample": d1["sample"],
               **e1_windows, **d2_windows}
    # slice F1's windows: the hard pair's bf16 K1/K2, the CLI runs' fp32 K1/K2 at D=64, the txt2img SprintDiT's K3-K5
    f1_bf16 = {f"f1_hard_{kind}_{w}": r[w] for kind, r in f1_hard.items() for w in ("sample", "train")}
    f1_fp32 = {f"f1_{kind}_{w}": f1_cli[kind][w] for kind in F1_CLI for w in ("train", "sample")}
    f1_flash = {f"f1_txt2img_sprint_{w}": counts for w, counts in f1_txt["windows"].items()}
    # slice H1's windows: the hard arms' bf16 K1/K2 at 384 and 128 keys, the trainable embedder's fp32 K1/K2 at
    # 128, the fp32 model's K1 in evaluate_txt2img (384) and evaluate_fid (256); fp32 = all less bf16 (D = 64)
    h1_windows = {f"h1_{k}": h1[k] for k in ("mmdit", "trainable", "sprint", "evaluate_txt2img", "evaluate_fid")}
    h1_fp32 = {k: {name: w[name] - w[f"{name}_bf16"] for name in ("fused_mha_fwd", "fused_mha_bwd")}
               for k, w in h1_windows.items()}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"phase seconds: {seconds}")
    print(f"card: {smi}")
    main_case = kernel["main"]
    print(json.dumps({"kernels": [{
        "name": "fused_mha_fwd",
        "route": "cuda",
        "source": "diffulab_tpu_torch/csrc/fused_mha_fwd.cu",
        "replaces": "diffulab_tpu/ops/fused_mha.py:50",
        "launches": gen_launches + train_launches["fused_mha_fwd"] + txt_totals["fused_mha_fwd"]
        + txt_train_launches["fused_mha_fwd"] + arms["launches"]["fused_mha_fwd"]
        + sum(w["fused_mha_fwd_bf16"] for w in (*e1_bf16.values(), *f1_bf16.values(), g1["train"],
                                                *h1_windows.values()))
        + j1_deploy["launches"]["fused_mha_fwd"] + j1_prompts["launches"]["fused_mha_fwd"],
        "launches_by_path": {"generate": gen_launches, "train": train_launches["fused_mha_fwd"],
                             "txt2img_generate": txt_totals["fused_mha_fwd"],
                             "txt2img_train": txt_train_launches["fused_mha_fwd"],
                             "dit_sampling_arms": arms["launches"]["fused_mha_fwd"],
                             **{k: w["fused_mha_fwd_bf16"] for k, w in {**e1_bf16, **f1_bf16}.items()},
                             "g1_train_repa": g1["train"]["fused_mha_fwd_bf16"],
                             **{k: w["fused_mha_fwd_bf16"] for k, w in h1_windows.items() if w["fused_mha_fwd_bf16"]},
                             "j1_deploy_dit_b2": j1_deploy["launches"]["fused_mha_fwd"],
                             **({"j1_prompts": j1_prompts["launches"]["fused_mha_fwd"]}
                                if j1_prompts["launches"]["fused_mha_fwd"] else {})},
        "j1_deploy": {key: j1_deploy[key] for key in ("export_s", "bytes", "load_s", "artifact_ms", "live_ms",
                                                      "max_abs_diff")},
        "g1_shape": g1["kernels"]["k1_g1_train"],
        "hard_pair_shapes": {k: v for k, v in g1["kernels"].items() if k.startswith("k1_hard")},
        "e1_shape": {**e1_fwd, "shape": f"B={E1_BATCH} S={E1_SEQ} H={C1_HEADS} D=64 bf16 (the hard configs' DiT)",
                     "timing": "device time per call from CUDA-graph replays"},
        "dit_sampling_arms_max_abs_err": arms["k1_err"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "timing": "ms and library_ms: device time per call from CUDA-graph replays; wall_ms: per call back to back",
        "wall_ms": main_case["wall_ms"],
        "library_wall_ms": main_case["library_wall_ms"],
        "train_shape_ms": main_case["train_shape_ms"],
    }, {
        "name": "fused_mha_fwd (fp32 instance, slice C1)",
        "route": "cuda",
        "source": "diffulab_tpu_torch/csrc/fused_mha_fwd.cu",
        "replaces": "diffulab_tpu/ops/fused_mha.py:50",
        "launches": c1["train"]["fused_mha_fwd"] + c1["sample"]["fused_mha_fwd"] + c2["fused_mha_fwd"]
        + sum(w["fused_mha_fwd"] for w in (*e1_d64.values(), *f1_fp32.values(), g1["sample"]))
        + sum(w["fused_mha_fwd"] for w in (*h1_fp32.values(), *i1["lora"].values()))
        + j1_serve["smoke"]["fused_mha_fwd"] + j1_serve["served"]["fused_mha_fwd"],
        "launches_by_path": {"c1_train": c1["train"]["fused_mha_fwd"], "c1_sample": c1["sample"]["fused_mha_fwd"],
                             "c2": c2["fused_mha_fwd"],
                             **{k: w["fused_mha_fwd"] for k, w in {**e1_d64, **f1_fp32}.items()},
                             "g1_sample": g1["sample"]["fused_mha_fwd"],
                             **{k: w["fused_mha_fwd"] for k, w in h1_fp32.items() if w["fused_mha_fwd"]},
                             **{k: w["fused_mha_fwd"] for k, w in i1["lora"].items()},
                             "j1_c1_export_smoke": j1_serve["smoke"]["fused_mha_fwd"],
                             "j1_c1_served": j1_serve["served"]["fused_mha_fwd"]},
        "h1_embedder_shape": h1["kernels"]["k1_h1_embedder"],
        "h1_eval_384_shape": h1["kernels"]["k1_h1_eval_384"],
        "f1_padded64": f1_cli["kernels"]["k1_pad64"],
        "g1_sample_padded64": g1["kernels"]["k1_g1_sample"],
        "c2_max_abs_err": {key: value for key, value in c2["errs"].items() if key.startswith("K1")},
        **{key: c1_kernels[f"fwd_b{C1_BATCH}"][key] for key in C1_KEYS},
        "shape": f"B={C1_BATCH} S={C1_SEQ} H={C1_HEADS} D=64 fp32",
        "sample_shape_b32": {key: c1_kernels[f"fwd_b{2 * C1_SAMPLES}"][key] for key in C1_KEYS},
        "timing": "ms and library_ms (fp32 SDPA): device time per call from CUDA-graph replays; bound_ms at "
                  "3xTF32 (three TF32 products at 495 TFLOP/s)",
    }, {
        "name": "fused_mha_bwd",
        "route": "cuda",
        "source": "diffulab_tpu_torch/csrc/fused_mha_bwd.cu",
        "replaces": "diffulab_tpu/ops/fused_mha.py:87",
        "launches": train_launches["fused_mha_bwd"] + txt_train_launches["fused_mha_bwd"]
        + sum(w["fused_mha_bwd_bf16"] for w in (*e1_bf16.values(), *f1_bf16.values(), g1["train"],
                                                *h1_windows.values())),
        "launches_by_path": {"train": train_launches["fused_mha_bwd"],
                             "txt2img_train": txt_train_launches["fused_mha_bwd"],
                             **{k: w["fused_mha_bwd_bf16"] for k, w in {**e1_bf16, **f1_bf16}.items()},
                             "g1_train_repa": g1["train"]["fused_mha_bwd_bf16"],
                             **{k: w["fused_mha_bwd_bf16"] for k, w in h1_windows.items() if w["fused_mha_bwd_bf16"]}},
        "g1_shape": g1["kernels"]["k2_g1_train"],
        "hard_pair_shapes": {k: v for k, v in g1["kernels"].items() if k.startswith("k2_hard")},
        "e1_shape": {**e1_bwd, "shape": f"B={E1_BATCH} S={E1_SEQ} H={C1_HEADS} D=64 bf16 (the hard configs' DiT)",
                     "timing": "ms: device time per call from CUDA-graph replays; library_ms: device time per call "
                               "of SDPA's bf16 autograd backward, kernels summed by torch.profiler"},
        **k2,
    }, {
        "name": "fused_mha_bwd (fp32 instance, slice C1)",
        "route": "cuda",
        "source": "diffulab_tpu_torch/csrc/fused_mha_bwd.cu",
        "replaces": "diffulab_tpu/ops/fused_mha.py:87",
        "launches": c1["train"]["fused_mha_bwd"] + c2["fused_mha_bwd"]
        + sum(w["fused_mha_bwd"] for w in (*e1_d64.values(), *f1_fp32.values(), *h1_fp32.values(),
                                           *i1["lora"].values())),
        "launches_by_path": {"c1_train": c1["train"]["fused_mha_bwd"], "c2": c2["fused_mha_bwd"],
                             **{k: w["fused_mha_bwd"] for k, w in {**e1_d64, **f1_fp32}.items()},
                             **{k: w["fused_mha_bwd"] for k, w in h1_fp32.items() if w["fused_mha_bwd"]},
                             **{k: w["fused_mha_bwd"] for k, w in i1["lora"].items() if w["fused_mha_bwd"]}},
        "h1_embedder_shape": h1["kernels"]["k2_h1_embedder"],
        "cifar_b32": f1_cli["kernels"]["k2_b32"],
        "f1_padded64": f1_cli["kernels"]["k2_pad64"],
        "c2_max_abs_err": c2["errs"][f"K2 B={C1_BATCH}"],
        **{key: c1_kernels["bwd_b128"][key] for key in C1_KEYS},
        "shape": f"B={C1_BATCH} S={C1_SEQ} H={C1_HEADS} D=64 fp32",
        "timing": "ms and library_ms (SDPA's fp32 backward, its memory-efficient backward op): device time per "
                  "call from CUDA-graph replays; bound_ms at 3xTF32 (three TF32 products at 495 TFLOP/s)",
    }] + [{
        "name": f"fused_mha_{kind} (fp32 instance D={d}, slice {slice_name})",
        "route": "cuda",
        "source": f"diffulab_tpu_torch/csrc/fused_mha_{kind}.cu",
        "replaces": f"diffulab_tpu/ops/fused_mha.py:{50 if kind == 'fwd' else 87}",
        "launches": sum(w[f"fused_mha_{kind}_f32_d{d}"] for w in paths.values()),
        "launches_by_path": {k: w[f"fused_mha_{kind}_f32_d{d}"] for k, w in paths.items()},
        **{key: numbers[f"{kind}_d{d}"][key] for key in C1_KEYS},
        "bound_padded_ms": numbers[f"{kind}_d{d}"]["padded"]["bound_ms"],
        "sdpa_padded_ms": numbers[f"{kind}_d{d}"]["sdpa_padded_ms"],
        "sdpa_unpadded_ms": numbers[f"{kind}_d{d}"]["sdpa_unpadded_ms"],
        "shape": f"B={batch} Sq={tokens} (unpadded) Skv={D2_PADDED} (padded from {tokens} keys, the padding key "
                 f"mask) H=2 D={d} fp32",
        **({"sample_shape_b32": {key: numbers[f"fwd_d{d}_b{2 * D1_SAMPLES}"][key] for key in C1_KEYS}}
           if f"{kind}_d{d}_b{2 * D1_SAMPLES}" in numbers else {}),
        "timing": "ms and library_ms (fp32 SDPA on the same inputs): device time per call from CUDA-graph replays"
                  + ("" if kind == "fwd" else " (SDPA's backward: its memory-efficient backward op)")
                  + "; bound_ms at 3xTF32 and 3.35 TB/s over the valid rows and keys; bound_padded_ms with q, o "
                    "and lse (K2: q, do, dq, lse, dk and dv) padded to 128 rows; sdpa_padded_ms and sdpa_unpadded_ms: "
                    "SDPA on the padded q/k/v with the mask and on the unpadded q/k/v",
    } for slice_name, attn, batch, numbers, paths in (
        ("D1", D1_ATTN, D1_BATCH, d1_kernels, {"d1_train": d1["train"], "d1_sample": d1["sample"], **e1_unet}),
        ("D2", D2_ATTN, D2_BATCH, d2_kernels, d2_windows))
      for kind in ("fwd", "bwd") for d, tokens, _ in attn] + [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "diffulab_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "diffulab_tpu/ops/flash_attention.py:81",
        "launches": txt_totals["flash_attn_fwd"] + txt_train_launches["flash_attn_fwd"]
        + sum(w["flash_attn_fwd"] - w["flash_attn_fwd_f32"] for w in (*txt32_windows.values(), *f1_flash.values()))
        + i1["grpo"]["flash_attn_fwd"] + j1_prompts["launches"]["flash_attn_fwd"],
        "launches_by_path": {"txt2img_generate": txt_totals["flash_attn_fwd"],
                             "txt2img_train": txt_train_launches["flash_attn_fwd"],
                             **{k: w["flash_attn_fwd"] - w["flash_attn_fwd_f32"]
                                for k, w in {**txt32_windows, **f1_flash}.items()},
                             "i1_grpo": i1["grpo"]["flash_attn_fwd"],
                             "j1_prompts": j1_prompts["launches"]["flash_attn_fwd"]},
        **k3,
        "f1_deep_shape": f1_txt["kernels"]["flash_attn_fwd"],
        "i1_grpo_shape": i1["kernels"]["flash_attn_fwd"],
        "vs_fused_ms": {key: {"fused_mha_fwd": k1, "flash_attn_fwd": k3_ms, "sdpa": sdpa_ms}
                        for key, (k1, k3_ms, sdpa_ms) in crossover.items()},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "diffulab_tpu_torch/csrc/flash_attn_bwd.cu",
        "replaces": replaces,
        "launches": txt_train_launches[name] + txt32["train"][name] - txt32["train"][f"{name}_f32"]
        + f1_txt["windows"]["train"][name] + i1["grpo"][name],
        "launches_by_path": {"txt2img_train": txt_train_launches[name],
                             "txt2img_fp32_attention_train": txt32["train"][name] - txt32["train"][f"{name}_f32"],
                             "f1_txt2img_sprint_train": f1_txt["windows"]["train"][name],
                             "i1_grpo": i1["grpo"][name]},
        **k45[name],
        "f1_deep_shape": f1_txt["kernels"][name],
        "i1_grpo_shape": i1["kernels"][name],
        "library_computes": "dq, dk and dv together (SDPA masked backward)",
        "vs_fused_bwd_ms": {key: {"fused_mha_bwd": k2, "flash_attn_bwd": k45_ms}
                            for key, (k2, k45_ms) in bwd_crossover.items()},
    } for name, replaces in (("flash_attn_bwd_dkv", "diffulab_tpu/ops/flash_attention.py:196"),
                             ("flash_attn_bwd_dq", "diffulab_tpu/ops/flash_attention.py:237"))] + [{
        "name": f"{name} (fp32 instance, {kernel})",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": sum(counts.get(f"{name}_f32", 0) for counts in windows.values()),
        "launches_by_path": {path: counts[f"{name}_f32"] for path, counts in windows.items() if f"{name}_f32" in counts},
        **{key: numbers[key] for key in C1_KEYS},
        **{key: numbers[key] for key in ("of_tol", "query_tiles", "key_tiles") if key in numbers},
        "shape": shape,
        "timing": "ms and library_ms (fp32 SDPA; the backward's: its memory-efficient backward op, dq, dk and dv "
                  "together): device time per call from CUDA-graph replays; plain_ms: wall time per call; bound_ms "
                  "at 3xTF32; launches: the fp32 instance's own count (fp32 above 512 tokens)",
        "path_times_ms": {"txt2img_fp32_attention_request": txt32["request_ms"],
                          "txt2img_fp32_attention_steps": txt32["step_ms"]},
    } for name, kernel, source, replaces, numbers, shape in (
        ("flash_attn_fwd", "flash_fwd_tf32x3", "diffulab_tpu_torch/csrc/flash_attn_fwd.cu",
         "diffulab_tpu/ops/flash_attention.py:81", k3_fp32,
         f"B={2 * TXT_BATCH} S={TXT_SEQ} H=12 D=64 fp32, the phase 8 text mask"),
        ("flash_attn_bwd_dkv", "flash_bwd_dkv_tf32x3", "diffulab_tpu_torch/csrc/flash_attn_bwd.cu",
         "diffulab_tpu/ops/flash_attention.py:196", k45_fp32["flash_attn_bwd_dkv"],
         f"B={TXT_TRAIN_BATCH} S={TXT_SEQ} H=12 D=64 fp32, the training mask"),
        ("flash_attn_bwd_dq", "flash_bwd_dq_tf32x3", "diffulab_tpu_torch/csrc/flash_attn_bwd.cu",
         "diffulab_tpu/ops/flash_attention.py:237", k45_fp32["flash_attn_bwd_dq"],
         f"B={TXT_TRAIN_BATCH} S={TXT_SEQ} H=12 D=64 fp32, the training mask"))]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
