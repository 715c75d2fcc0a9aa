"""diffulab_tpu_torch — the PyTorch/CUDA port of :mod:`diffulab_tpu`.

The JAX package stays the reference; this package mirrors its file layout
(one port module per reference module) and computes the same functions in
PyTorch, with every Pallas TPU kernel on a ported path rewritten by hand for
Hopper (``csrc/``, built at first use by :mod:`diffulab_tpu_torch.ops._build`).

It imports ``torch`` and ``numpy`` only — never ``jax``, ``flax``, ``optax``
or ``diffulab_tpu``. Entry points run on CUDA unless the caller passes
``device="cpu"``; on a machine without a card they raise instead of falling
back to the CPU.

Ported so far: slice A1, serving — class-conditional DiT sampling with
:class:`~diffulab_tpu_torch.networks.denoisers.mmdit.MMDiT` (``simple_dit=True``),
the rectified-flow :class:`~diffulab_tpu_torch.diffuse.flow.Flow` with the
Euler sampler and fused 2x CFG, and
:meth:`~diffulab_tpu_torch.diffuse.diffuser.Diffuser.generate` in pixel mode;
slice A2, training — the flow-matching loss and
:class:`~diffulab_tpu_torch.training.trainer.BaseTrainer` with AdamW, EMA,
accumulation and torch-format checkpoints; slice B1, latent text-to-image
serving — the multimodal ``MMDiT(simple_dit=False)`` with a
:class:`~diffulab_tpu_torch.networks.embedders.PrecomputedEmbedder`, and
``Diffuser.generate`` in latent mode with the
:class:`~diffulab_tpu_torch.networks.vision_towers.Flux2VAE` decode; slice
B2, latent text-to-image training — text batches from
:mod:`diffulab_tpu_torch.data.imagenet` through ``BaseTrainer`` with the
trainable split of ``training.checkpoint.trainable_filter``; slice C1, the
main path end to end from its config — :mod:`diffulab_tpu_torch.config`
(the JAX package's YAML tree, ``_target_`` remapped to this package), the
in-memory datasets and the threaded ``data.loader.DataLoader`` with the
native uint8 batch path, post-hoc EMA (``training.posthoc_ema``) and the
``examples.{train_diffusion,reconstruct_ema,sample}`` CLIs.
Attention runs in the fused multi-head kernels, forward
(``csrc/fused_mha_fwd.cu``) and backward (``csrc/fused_mha_bwd.cu``), up to
512 tokens, and in the flash-attention kernels, forward
(``csrc/flash_attn_fwd.cu``) and backward (``csrc/flash_attn_bwd.cu``),
beyond.
"""

__version__ = "0.1.0"
