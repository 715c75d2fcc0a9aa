"""DDT: the encoder-decoder diffusion transformer (arXiv:2504.05741) — port
of diffulab_tpu/networks/denoisers/ddt.py.

Two stride-P patchifiers read the same input, ``conv_proj_encoder`` and
``conv_proj_decoder``. The encoder is a DiT stack (``simple_ddt``,
class-conditional) or dual-stream MMDiT blocks over ``[context; image]``
followed by ``n_single_stream_blocks`` single-stream ones, conditioned on
the time embedding (plus the labels or the pooled context). The decoder is
a DiT stack over the image tokens alone whose adaLN input is **per token**,
``silu(encoder output + time embedding)`` (ddt.py:229-242): the blocks'
``Modulation`` applies SiLU once more, and the modulated last layer takes
the same per-token vector. In multimodal mode the decoder's RoPE is the
3-axis image grid, with no text and no mask. ``embedding_dim`` is
``inner_dim`` throughout.

Blocks, precision policy and attention are the port's MMDiT's (:mod:`.mmdit`);
the forward draws nothing, so ``train`` and ``generator`` are taken and
ignored (ddt.py:254). Parameter names follow the reference's module paths.
``attention_impl`` is the port's: ``"xla"`` builds the plain-attention twin.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
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


class DDT(PatchGridMixin, Denoiser):
    """Encoder-decoder DDT (ddt.py:45)."""

    def __init__(
        self,
        simple_ddt: bool = False,
        input_channels: int = 3,
        output_channels: int | None = None,
        inner_dim: int = 768,
        num_heads: int = 12,
        mlp_ratio: int = 4,
        patch_size: int = 16,
        encoder_depth: int = 8,
        n_single_stream_blocks: int = 0,
        decoder_depth: int = 4,
        rope_base: int = 10_000,
        partial_rotary_factor: float = 1.0,
        rope_axes_dim: Sequence[int] | None = None,
        frequency_embedding: int = 256,
        n_classes: int | None = None,
        classifier_free: bool = False,
        context_embedder: ContextEmbedder | None = None,
        use_checkpoint: bool = False,
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
        if n_single_stream_blocks >= encoder_depth:
            raise ValueError("n_single_stream_blocks must be less than encoder_depth")
        if not simple_ddt and context_embedder is None:
            raise ValueError("the multimodal DDT (simple_ddt=False) needs a context embedder")
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        self.simple_ddt = simple_ddt
        self.patch_size = patch_size
        self.input_channels = input_channels
        self.output_channels = output_channels or input_channels
        self.frequency_embedding = frequency_embedding
        self.rope_base = rope_base
        self.n_classes = n_classes
        self.classifier_free = classifier_free
        self.use_checkpoint = use_checkpoint
        self.feature_layers = tuple(feature_layers)
        cond_dtype = self.stream_dtype = stable_dtype(dtype)
        kw = dict(device=device, param_dtype=param_dtype)

        heads_dim = inner_dim // num_heads
        self.pooled_embedding = False
        self.context_embedder = self.mlp_pooled_context = self.context_embed = self.label_embed = None
        if simple_ddt:
            self.label_embed = (LabelEmbed(n_classes, inner_dim, classifier_free, dtype=cond_dtype, **kw)
                                if n_classes is not None else None)
            if rope_axes_dim is None:
                d2 = int((partial_rotary_factor * heads_dim) // 2)
                d2 -= d2 % 2
                rope_axes_dim = [d2, d2]
            n_single_stream_blocks = 0
        else:
            self.context_embedder = context_embedder.to(device)
            sizes = context_embedder.output_size
            if context_embedder.n_output == 2:
                self.pooled_embedding = True
                self.mlp_pooled_context = PooledContextMlp(sizes[0], inner_dim, dtype=cond_dtype, **kw)
                self.context_embed = Linear(sizes[1], inner_dim, bias=False, dtype=dtype, **kw)
            elif context_embedder.n_output == 1:
                self.context_embed = Linear(sizes[0], inner_dim, bias=False, dtype=dtype, **kw)
            else:
                raise ValueError(f"a context embedder gives 1 or 2 outputs, not {context_embedder.n_output}")
            if rope_axes_dim is None:
                d3 = int((partial_rotary_factor * heads_dim) // 3)
                d3 -= d3 % 2
                rope_axes_dim = [d3, d3, d3]
        self.rope_axes_dim = list(rope_axes_dim)
        self.last_layer = ModulatedLastLayer(inner_dim, inner_dim, patch_size, self.output_channels,
                                             dtype=cond_dtype, **kw)
        self.time_embed = TimeEmbedMlp(frequency_embedding, inner_dim, dtype=cond_dtype, **kw)
        self.conv_proj_encoder = PatchEmbed(input_channels, inner_dim, patch_size, dtype=cond_dtype, **kw)
        self.conv_proj_decoder = PatchEmbed(input_channels, inner_dim, patch_size, dtype=cond_dtype, **kw)

        block_cls = DiTBlock if simple_ddt else MMDiTBlock
        block_args = (inner_dim, inner_dim, num_heads, mlp_ratio, self.rope_axes_dim)
        block_kw = dict(dtype=dtype, attention_impl=attention_impl, **kw)
        self.layers = nn.ModuleList(
            [block_cls(*block_args, **block_kw) for _ in range(encoder_depth - n_single_stream_blocks)]
            + [MMDiTSingleStreamBlock(*block_args, **block_kw) for _ in range(n_single_stream_blocks)]
        )
        self.decoder_layers = nn.ModuleList([DiTBlock(*block_args, **block_kw) for _ in range(decoder_depth)])

    def patchify(self, x: torch.Tensor, encoder: bool = True) -> tuple[torch.Tensor, tuple[int, int]]:
        """The encoder's (or the decoder's) tokens of the NHWC input."""
        tokens, grid_size = (self.conv_proj_encoder if encoder else self.conv_proj_decoder)(x)
        if self.stream_dtype is not None:
            tokens = tokens.to(self.stream_dtype)
        return tokens, grid_size

    # --- encoder / decoder ---------------------------------------------------
    def encode_mmddt(self, x, grid_size, t_emb, context_raw, drop, capture_features):
        """MMDiT encoder over [context; image] (ddt.py:188)."""
        b = x.shape[0]
        emb = t_emb
        context_output = self.context_embedder(context_raw, drop)
        if self.pooled_embedding:
            emb = self.mlp_pooled_context(context_output["pooled_embeddings"].to(x.dtype)) + emb
        context = self.context_embed(context_output["embeddings"].to(x.dtype))
        if self.stream_dtype is not None:
            context = context.to(self.stream_dtype)
        attn_mask = context_output.get("attn_mask")
        pos_ids = torch.cat([self._text_pos_ids(b, context.shape[1], x.device),
                             self._image_pos_ids(b, grid_size, 3, x.device)], dim=1)
        cos_sin = get_cos_sin_ndim_grid(pos_ids, self.rope_base, self.rope_axes_dim)
        features = []
        for i, layer in enumerate(self.layers):
            x, context = self._run_block(layer, x, emb, context, cos_sin, attn_mask)
            if capture_features and i in self.feature_layers:
                features.append(x)
        return x, features

    def encode_ddt(self, x, grid_size, t_emb, y, drop, capture_features):
        """DiT encoder with label conditioning (ddt.py:212)."""
        emb = t_emb
        if self.label_embed is not None:
            if y is None:
                raise ValueError("class labels y required for label-conditional DDT")
            emb = emb + self.label_embed(y, drop if self.classifier_free else None)
        cos_sin = get_cos_sin_ndim_grid(self._image_pos_ids(x.shape[0], grid_size, 2, x.device), self.rope_base,
                                        self.rope_axes_dim)
        features = []
        for i, layer in enumerate(self.layers):
            x = self._run_block(layer, x, emb, cos_sin, None)
            if capture_features and i in self.feature_layers:
                features.append(x)
        return x, features

    def decode(self, x, encoder_output, grid_size, t_emb):
        """DiT decoder conditioned per token on ``silu(enc + t_emb)`` (ddt.py:229)."""
        cond_tokens = F.silu(encoder_output + t_emb[:, None, :])
        pos_ids = self._image_pos_ids(x.shape[0], grid_size, 2 if self.simple_ddt else 3, x.device)
        cos_sin = get_cos_sin_ndim_grid(pos_ids, self.rope_base, self.rope_axes_dim)
        for layer in self.decoder_layers:
            x = self._run_block(layer, x, cond_tokens, cos_sin, None)
        return self.last_layer(x, cond_tokens)

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        cond: dict[str, Any] | None = None,
        drop: torch.Tensor | None = None,
        train: bool = False,
        capture_features: bool = False,
        generator: torch.Generator | None = None,
    ) -> ModelOutput:
        del train, generator  # nothing random in the forward
        cond = cond or {}
        y, context_raw, x_context = cond.get("y"), cond.get("context"), cond.get("x_context")
        if context_raw is not None and y is not None:
            raise ValueError("context and y cannot both be specified")
        if x_context is not None:
            x = torch.cat([x, x_context], dim=-1)  # NHWC channel concat
        enc_tokens, grid_size = self.patchify(x, encoder=True)
        # the time embedding of the encoder (before the labels or pooled context join it) and the decoder
        t_emb = self.time_embed(timestep_embedding(timesteps, self.frequency_embedding).to(enc_tokens.dtype))
        if self.simple_ddt:
            enc, features = self.encode_ddt(enc_tokens, grid_size, t_emb, y, drop, capture_features)
        else:
            if context_raw is None:
                raise ValueError("the multimodal DDT needs cond['context']")
            enc, features = self.encode_mmddt(enc_tokens, grid_size, t_emb, context_raw, drop, capture_features)
        dec_tokens, _ = self.patchify(x, encoder=False)
        result: ModelOutput = {"x": self.unpatchify(self.decode(dec_tokens, enc, grid_size, t_emb), grid_size)}
        if capture_features:
            result["features"] = features
        return result
