"""SprintDiT: the token-dropping DiT (SPRINT, arXiv:2510.21986) — port of
diffulab_tpu/networks/denoisers/sprint.py.

A shallow encoder of ``encoder_depth`` blocks; in training, ``drop_rate``
of the image tokens dropped (top-k of uniform scores, the kept indices
sorted, RoPE's cos/sin gathered with them); the deep blocks on the kept
tokens (``deep_layers_depth - n_single_stream_blocks`` DiT or dual-stream
blocks, then the single-stream ones); a scatter back into a learned
``mask_token``; then **path drop**: every sample the CFG ``drop`` mask
selects takes mask tokens for the whole deep output, whether or not the
model is ``classifier_free`` (sprint.py:212-222); the ``fuse`` of
``[restored, encoder output]`` (and ``fuse_context`` of the text streams in
multimodal mode), cast back to the stream dtype; a decoder of
``decoder_depth`` blocks; the modulated last layer.

The token-drop scores are drawn from the ``generator`` the caller passes
(the trainer's, seeded per step; the reference reads its call-time
``rngs.token_drop()``), or given as ``token_scores`` (the parity tests feed
the JAX draw). Sampling and validation (``train=False``) drop nothing.

Blocks, precision policy and attention are the port's MMDiT's
(:mod:`.mmdit`): on the card the fused kernels K1/K2 up to 512 padded tokens
(the deep path's few kept tokens pad to 128), the flash kernels K3/K4/K5
beyond. Parameter names follow the reference's module paths, so that
:mod:`diffulab_tpu_torch.weights` maps a JAX state one to one. ``layers``
(the encoder) holds the REPA capture points (``feature_layers``).
``attention_impl`` is the port's: ``"xla"`` builds the plain-attention twin.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from diffulab_tpu_torch.networks.denoisers.common import Denoiser, ModelOutput
from diffulab_tpu_torch.networks.denoisers.mmdit import (
    DiTBlock,
    MMDiTBlock,
    MMDiTSingleStreamBlock,
    ModulatedLastLayer,
    PatchEmbed,
    PatchGridMixin,
    PooledContextMlp,
    TimeEmbedMlp,
)
from diffulab_tpu_torch.networks.embedders.common import ContextEmbedder
from diffulab_tpu_torch.networks.nn import LabelEmbed, Linear, get_cos_sin_ndim_grid, stable_dtype, timestep_embedding
from diffulab_tpu_torch.utils import resolve_device, resolve_dtype


def _gather_tokens(x: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """``x[b, kept[b]]`` for [B, S, C] ``x`` and [B, k] ``kept``."""
    return torch.gather(x, 1, kept[..., None].expand(-1, -1, x.shape[-1]))


class SprintDiT(PatchGridMixin, Denoiser):
    """SPRINT encoder / token-dropped deep / decoder DiT (sprint.py:45).

    ``simple_dit=True``: class-conditional DiT blocks, 2-axis RoPE;
    ``simple_dit=False``: dual-stream MMDiT blocks over ``[context; image]``
    with 3-axis RoPE, the deep path ending in ``n_single_stream_blocks``
    single-stream blocks; it needs a ``context_embedder``.
    """

    draws_in_training = True

    def __init__(
        self,
        simple_dit: bool = False,
        input_channels: int = 3,
        output_channels: int | None = None,
        inner_dim: int = 768,
        embedding_dim: int = 768,
        num_heads: int = 12,
        mlp_ratio: int = 4,
        patch_size: int = 16,
        encoder_depth: int = 2,
        deep_layers_depth: int = 8,
        n_single_stream_blocks: int = 0,
        decoder_depth: int = 2,
        rope_base: int = 10_000,
        partial_rotary_factor: float = 1.0,
        rope_axes_dim: Sequence[int] | None = None,
        frequency_embedding: int = 256,
        n_classes: int | None = None,
        classifier_free: bool = False,
        context_embedder: ContextEmbedder | None = None,
        use_checkpoint: bool = False,
        drop_rate: float = 0.75,
        feature_layers: Sequence[int] = (),
        attention_impl: str = "auto",
        *,
        dtype: Any = None,
        param_dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        if n_classes is not None and context_embedder is not None:
            raise ValueError("n_classes and context_embedder cannot both be specified")
        if not simple_dit and context_embedder is None:
            raise ValueError("the multimodal SprintDiT (simple_dit=False) needs a context embedder")
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        self.simple_dit = simple_dit
        self.patch_size = patch_size
        self.input_channels = input_channels
        self.output_channels = output_channels or input_channels
        self.frequency_embedding = frequency_embedding
        self.rope_base = rope_base
        self.n_classes = n_classes
        self.classifier_free = classifier_free
        self.use_checkpoint = use_checkpoint
        self.drop_rate = drop_rate
        self.feature_layers = tuple(feature_layers)
        # the conditioning path and the residual stream stay fp32 under a half dtype (mmdit.MMDiT)
        cond_dtype = self.stream_dtype = stable_dtype(dtype)
        kw = dict(device=device, param_dtype=param_dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, inner_dim, device=device, dtype=param_dtype))

        heads_dim = inner_dim // num_heads
        self.pooled_embedding = False
        self.context_embedder = self.mlp_pooled_context = self.context_embed = None
        self.label_embed = self.fuse_context = None
        if simple_dit:
            self.label_embed = (LabelEmbed(n_classes, embedding_dim, classifier_free, dtype=cond_dtype, **kw)
                                if n_classes is not None else None)
            if rope_axes_dim is None:
                d2 = int((partial_rotary_factor * heads_dim) // 2)
                d2 -= d2 % 2
                rope_axes_dim = [d2, d2]
            n_single_stream_blocks = 0  # the single-stream swap is unreachable in simple mode (mmdit.py)
        else:
            self.context_embedder = context_embedder.to(device)
            sizes = context_embedder.output_size
            if context_embedder.n_output == 2:
                self.pooled_embedding = True
                self.mlp_pooled_context = PooledContextMlp(sizes[0], embedding_dim, dtype=cond_dtype, **kw)
                self.context_embed = Linear(sizes[1], inner_dim, bias=False, dtype=dtype, **kw)
            elif context_embedder.n_output == 1:
                self.context_embed = Linear(sizes[0], inner_dim, bias=False, dtype=dtype, **kw)
            else:
                raise ValueError(f"a context embedder gives 1 or 2 outputs, not {context_embedder.n_output}")
            self.fuse_context = Linear(2 * inner_dim, inner_dim, bias=False, dtype=dtype, **kw)
            if rope_axes_dim is None:
                d3 = int((partial_rotary_factor * heads_dim) // 3)
                d3 -= d3 % 2
                rope_axes_dim = [d3, d3, d3]
        self.rope_axes_dim = list(rope_axes_dim)
        self.fuse = Linear(2 * inner_dim, inner_dim, bias=False, dtype=dtype, **kw)
        self.last_layer = ModulatedLastLayer(embedding_dim, inner_dim, patch_size, self.output_channels,
                                             dtype=cond_dtype, **kw)
        self.time_embed = TimeEmbedMlp(frequency_embedding, embedding_dim, dtype=cond_dtype, **kw)
        self.conv_proj = PatchEmbed(input_channels, inner_dim, patch_size, dtype=cond_dtype, **kw)

        block_cls = DiTBlock if simple_dit else MMDiTBlock
        block_args = (inner_dim, embedding_dim, num_heads, mlp_ratio, self.rope_axes_dim)
        block_kw = dict(dtype=dtype, attention_impl=attention_impl, **kw)
        self.layers = nn.ModuleList([block_cls(*block_args, **block_kw) for _ in range(encoder_depth)])
        self.deep_layers = nn.ModuleList(
            [block_cls(*block_args, **block_kw) for _ in range(deep_layers_depth - n_single_stream_blocks)]
            + [MMDiTSingleStreamBlock(*block_args, **block_kw) for _ in range(n_single_stream_blocks)]
        )
        self.decoder_layers = nn.ModuleList([block_cls(*block_args, **block_kw) for _ in range(decoder_depth)])

    # --- token drop / restore (sprint.py:195-222) ------------------------------
    def kept_tokens(self, seq_len: int) -> int:
        """Image tokens the deep path keeps in training: ``max(1, int(s * (1 - drop_rate)))``."""
        return max(1, int(seq_len * (1.0 - float(self.drop_rate))))

    def drop_tokens(
        self, x: torch.Tensor, cos_sin_img: tuple[torch.Tensor, torch.Tensor], train: bool,
        generator: torch.Generator | None = None, scores: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor | None, tuple[torch.Tensor, torch.Tensor]]:
        """In training, the top-k image tokens of ``scores`` ([B, S] uniform,
        drawn from ``generator`` unless given), their sorted indices and
        their cos/sin; else everything, and None for the indices."""
        if not train:
            return x, None, cos_sin_img
        b, s, _ = x.shape
        if scores is None:
            if generator is None:
                raise ValueError("a training forward of SprintDiT drops tokens: pass generator= (the trainer "
                                 "does) or token_scores=")
            scores = torch.rand((b, s), generator=generator, device=x.device)
        kept = torch.topk(scores, self.kept_tokens(s), dim=1).indices.sort(dim=1).values
        return _gather_tokens(x, kept), kept, tuple(_gather_tokens(r, kept) for r in cos_sin_img)

    def restore_tokens(self, x_dropped: torch.Tensor, kept: torch.Tensor | None, seq_len: int,
                       path_drop: torch.Tensor | None) -> torch.Tensor:
        """The deep output scattered into the mask token at the kept
        positions; the samples of ``path_drop`` all mask tokens."""
        b, _, d = x_dropped.shape
        mask_token = self.mask_token.to(x_dropped.dtype)
        x_full = x_dropped
        if kept is not None:
            x_full = mask_token.expand(b, seq_len, d).scatter(1, kept[..., None].expand(-1, -1, d), x_dropped)
        if path_drop is not None:
            x_full = torch.where(path_drop[:, None, None], mask_token, x_full)
        return x_full

    # --- forward paths ---------------------------------------------------------
    def _forward_mmdit(self, x, grid_size, timesteps, context_raw, drop, train, generator, scores,
                       capture_features):
        b, s_img = x.shape[:2]
        emb = self.time_embed(timestep_embedding(timesteps, self.frequency_embedding).to(x.dtype))
        context_output = self.context_embedder(context_raw, drop)
        if self.pooled_embedding:
            emb = self.mlp_pooled_context(context_output["pooled_embeddings"].to(x.dtype)) + emb
        context = self.context_embed(context_output["embeddings"].to(x.dtype))
        if self.stream_dtype is not None:
            context = context.to(self.stream_dtype)
        attn_mask = context_output.get("attn_mask")
        s_txt = context.shape[1]
        pos_ids = torch.cat([self._text_pos_ids(b, s_txt, x.device),
                             self._image_pos_ids(b, grid_size, 3, x.device)], dim=1)
        cos_sin = get_cos_sin_ndim_grid(pos_ids, self.rope_base, self.rope_axes_dim)

        features = []
        for i, layer in enumerate(self.layers):
            x, context = self._run_block(layer, x, emb, context, cos_sin, attn_mask)
            if capture_features and i in self.feature_layers:
                features.append(x)
        encoder_context = context

        x_dropped, kept, cs_img = self.drop_tokens(x, tuple(r[:, s_txt:] for r in cos_sin), train, generator, scores)
        cos_sin_dropped = tuple(torch.cat([r[:, :s_txt], c], dim=1) for r, c in zip(cos_sin, cs_img))
        for layer in self.deep_layers:
            x_dropped, context = self._run_block(layer, x_dropped, emb, context, cos_sin_dropped, attn_mask)
        x_restored = self.restore_tokens(x_dropped, kept, s_img, drop)

        x_fused = self.fuse(torch.cat([x_restored, x], dim=-1))
        context_fused = self.fuse_context(torch.cat([context, encoder_context], dim=-1))
        if self.stream_dtype is not None:  # the fuse linears emit the matmul dtype
            x_fused, context_fused = x_fused.to(self.stream_dtype), context_fused.to(self.stream_dtype)
        for layer in self.decoder_layers:
            x_fused, context_fused = self._run_block(layer, x_fused, emb, context_fused, cos_sin, attn_mask)
        return self.last_layer(x_fused, emb), features

    def _forward_dit(self, x, grid_size, timesteps, y, drop, train, generator, scores, capture_features):
        s_img = x.shape[1]
        emb = self.time_embed(timestep_embedding(timesteps, self.frequency_embedding).to(x.dtype))
        if self.label_embed is not None:
            if y is None:
                raise ValueError("class labels y required for label-conditional SprintDiT")
            emb = emb + self.label_embed(y, drop if self.classifier_free else None)
        pos_ids = self._image_pos_ids(x.shape[0], grid_size, 2, x.device)
        cos_sin = get_cos_sin_ndim_grid(pos_ids, self.rope_base, self.rope_axes_dim)

        features = []
        for i, layer in enumerate(self.layers):
            x = self._run_block(layer, x, emb, cos_sin, None)
            if capture_features and i in self.feature_layers:
                features.append(x)

        x_dropped, kept, cos_sin_dropped = self.drop_tokens(x, cos_sin, train, generator, scores)
        for layer in self.deep_layers:
            x_dropped = self._run_block(layer, x_dropped, emb, cos_sin_dropped, None)
        x_restored = self.restore_tokens(x_dropped, kept, s_img, drop)

        x_fused = self.fuse(torch.cat([x_restored, x], dim=-1))
        if self.stream_dtype is not None:
            x_fused = x_fused.to(self.stream_dtype)
        for layer in self.decoder_layers:
            x_fused = self._run_block(layer, x_fused, emb, cos_sin, None)
        return self.last_layer(x_fused, emb), features

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        cond: dict[str, Any] | None = None,
        drop: torch.Tensor | None = None,
        train: bool = False,
        capture_features: bool = False,
        generator: torch.Generator | None = None,
        token_scores: torch.Tensor | None = None,
    ) -> ModelOutput:
        """``token_scores`` ([B, image tokens]) replaces the draw from
        ``generator`` in a training forward."""
        cond = cond or {}
        y, context_raw, x_context = cond.get("y"), cond.get("context"), cond.get("x_context")
        if context_raw is not None and y is not None:
            raise ValueError("context and y cannot both be specified")
        if x_context is not None:
            x = torch.cat([x, x_context], dim=-1)  # NHWC channel concat
        tokens, grid_size = self.patchify(x)
        if self.simple_dit:
            out, features = self._forward_dit(tokens, grid_size, timesteps, y, drop, train, generator, token_scores,
                                              capture_features)
        else:
            if context_raw is None:
                raise ValueError("the multimodal SprintDiT needs cond['context']")
            out, features = self._forward_mmdit(tokens, grid_size, timesteps, context_raw, drop, train, generator,
                                                token_scores, capture_features)
        result: ModelOutput = {"x": self.unpatchify(out, grid_size)}
        if capture_features:
            result["features"] = features
        return result
