"""ADM-style UNet denoiser (port of diffulab_tpu/networks/denoisers/unet.py),
NHWC at every module boundary.

- ``ResBlock``: GroupNorm32 + SiLU + 3x3 conv, FiLM scale-shift (or
  additive) timestep conditioning, in-block up/down sampling, a
  zero-initialised out conv, a 1x1 or 3x3 skip projection;
- ``AttentionBlock``: GroupNorm'd token self/cross attention with a
  residual, through :func:`diffulab_tpu_torch.ops.dot_product_attention`
  (on the card the fused kernels K1/K2: ``train_synthetic_ddpm.yaml`` attends
  over 64 and 16 tokens at head dims 192 and 384, the MNIST configs at 256
  and 512);
- ``FeedForward`` (GEGLU), ``TransformerAttentionBlock`` (self + cross +
  ff) and ``TransformerBlock`` (proj_in/out around them) for a context
  embedder;
- encoder, middle and decoder with skip concatenation, attention at the
  configured downsample factors, class-label (with a CFG null class) or
  context conditioning, and the non-leaky augmentation labels.

The precision policy is the reference's: ``dtype`` is the compute dtype of
the convs and matmuls (None = fp32); the time embedding, the FiLM layers and
the residual sums stay fp32 under a half ``dtype``; norms compute in fp32.
``use_checkpoint`` recomputes each block in the backward
(``torch.utils.checkpoint``). Sampling-time DeepCache
(arXiv:2312.00858; unet.py:402-594): with a split ``k`` set through
``set_block_cache_span((k, N))``, a call given ``block_cache`` and
``cache_refresh`` runs the deep segment (encoder groups ``[k, N)``, the
middle block and the matching decoder groups) and returns its output on a
refresh, or splices in the cached one otherwise (a host bool). U-REPA
feature capture (``capture_features=True``; unet.py:517-547): the output of
each input group, of the middle block and of each output group is a capture
point, flat-indexed in that order (:attr:`UNetModel.layers`), and the
points listed in ``feature_layers`` come back as ``[B, H*W, C]`` tokens in
``out["features"]``.

Parameter names follow the reference's module paths, so that
:func:`diffulab_tpu_torch.weights.state_dict_from_jax` (given this module,
for GroupNorm's ``scale``) maps a JAX state one to one.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from diffulab_tpu_torch.networks.denoisers.common import Denoiser, ModelOutput
from diffulab_tpu_torch.networks.embedders.common import ContextEmbedder
from diffulab_tpu_torch.networks.nn import (
    Conv2d,
    Downsample,
    GroupNorm32,
    LabelEmbed,
    Linear,
    Upsample,
    accum_dtype_kwargs,
    geglu,
    stable_dtype,
    timestep_embedding,
    zero_conv,
)
from diffulab_tpu_torch.ops import dot_product_attention
from diffulab_tpu_torch.utils import resolve_device, resolve_dtype


def _conv3(cin: int, cout: int, **kw) -> Conv2d:
    return Conv2d(cin, cout, 3, padding=1, **kw)


class ResBlock(nn.Module):
    """Residual block with FiLM timestep conditioning (unet.py:51)."""

    def __init__(self, channels: int, emb_channels: int, dropout: float = 0.0, out_channels: int | None = None,
                 use_conv: bool = False, use_scale_shift_norm: bool = False, up: bool = False, down: bool = False,
                 *, dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        if up and down:
            raise ValueError("a ResBlock samples up or down, not both")
        self.channels = channels
        self.out_channels = out_channels or channels
        self.use_scale_shift_norm = use_scale_shift_norm
        self.updown = up or down
        self.dropout = dropout
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        norm_kw = dict(device=device, param_dtype=param_dtype)
        self.in_norm = GroupNorm32(32, channels, **norm_kw)
        self.in_conv = _conv3(channels, self.out_channels, **kw)
        self.h_upd = self.x_upd = None
        if up:
            self.h_upd, self.x_upd = Upsample(channels, False), Upsample(channels, False)
        elif down:
            self.h_upd, self.x_upd = Downsample(channels, False), Downsample(channels, False)
        emb_out_dim = 2 * self.out_channels if use_scale_shift_norm else self.out_channels
        # FiLM conditioning stays fp32 under mixed precision
        self.emb_layer = Linear(emb_channels, emb_out_dim, dtype=stable_dtype(dtype), **norm_kw)
        self.stream_dtype = stable_dtype(dtype)
        self.out_norm = GroupNorm32(32, self.out_channels, **norm_kw)
        self.out_conv = zero_conv(self.out_channels, self.out_channels, 3, **kw)
        if self.out_channels == channels:
            self.skip = None
        elif use_conv:
            self.skip = _conv3(channels, self.out_channels, **kw)
        else:
            self.skip = Conv2d(channels, self.out_channels, 1, **kw)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.updown:
            h = self.h_upd(F.silu(self.in_norm(x)))
            x = self.x_upd(x)
            h = self.in_conv(h)
        else:
            h = self.in_conv(F.silu(self.in_norm(x)))
        emb_out = self.emb_layer(F.silu(emb))[:, None, None, :]  # broadcast over H, W
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = self.out_norm(h) * (1 + scale) + shift
        else:
            h = self.out_norm(h + emb_out)
        h = self.out_conv(F.dropout(F.silu(h), self.dropout, training=train))
        out = (self.skip(x) if self.skip is not None else x) + h
        return out if self.stream_dtype is None else out.to(self.stream_dtype)


class AttentionBlock(nn.Module):
    """Token self/cross attention with a residual (unet.py:130)."""

    def __init__(self, channels: int, context_channels: int | None = None, num_heads: int = 8,
                 inner_channels: int = -1, dropout: float = 0.0, q_bias: bool = True, kv_bias: bool = True,
                 *, dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        self.channels = channels
        self.context_channels = context_channels or channels
        self.inner_channels = channels if inner_channels == -1 else inner_channels
        self.num_heads = num_heads
        if self.inner_channels % num_heads:
            raise ValueError(f"{self.inner_channels} channels do not split into {num_heads} heads")
        self.dim_head = self.inner_channels // num_heads
        self.scale = self.dim_head ** -0.5
        self.kernel_dtype = dtype
        self.dropout = dropout
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype, **accum_dtype_kwargs(dtype))
        norm_kw = dict(device=device, param_dtype=param_dtype)
        self.norm_x = GroupNorm32(32, channels, **norm_kw)
        self.norm_context = GroupNorm32(32, self.context_channels, **norm_kw)
        self.to_q = Linear(channels, self.inner_channels, bias=q_bias, **kw)
        self.to_kv = Linear(self.context_channels, self.inner_channels * 2, bias=kv_bias, **kw)
        self.to_out = Linear(self.inner_channels, channels, **kw)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None, attn_mask: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        b, h_, w_, c = x.shape
        tokens = x.reshape(b, h_ * w_, c)
        ctx = context if context is not None else tokens
        q = self.to_q(self.norm_x(tokens))
        k, v = self.to_kv(self.norm_context(ctx)).chunk(2, dim=-1)
        q = q.reshape(b, -1, self.num_heads, self.dim_head)
        k = k.reshape(b, -1, self.num_heads, self.dim_head)
        v = v.reshape(b, -1, self.num_heads, self.dim_head)
        if self.kernel_dtype is not None:
            q, k, v = (t.to(self.kernel_dtype) for t in (q, k, v))
        out = dot_product_attention(q, k, v, kv_mask=attn_mask, scale=self.scale)
        out = self.to_out(out.reshape(b, -1, self.inner_channels))
        out = F.dropout(out, self.dropout, training=train)
        return (tokens + out).reshape(b, h_, w_, c)


class FeedForward(nn.Module):
    """GEGLU feed-forward with GroupNorm and a residual (unet.py:192)."""

    def __init__(self, channels: int, inner_channels: int, dropout: float = 0.0, *, dtype=None, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype, **accum_dtype_kwargs(dtype))
        self.dropout = dropout
        self.norm = GroupNorm32(32, channels, device=device, param_dtype=param_dtype)
        self.proj_in = Linear(channels, inner_channels * 2, **kw)
        self.proj_out = Linear(inner_channels, channels, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, h_, w_, c = x.shape
        tokens = x.reshape(b, h_ * w_, c)
        h = geglu(self.proj_in(self.norm(tokens)))
        h = self.proj_out(F.dropout(h, self.dropout, training=train))
        return (tokens + h).reshape(b, h_, w_, c)


class TransformerAttentionBlock(nn.Module):
    """self-attention -> cross-attention -> feed-forward (unet.py:211)."""

    def __init__(self, channels: int, context_channels: int | None = None, num_heads: int = 8,
                 inner_channels: int = -1, dropout: float = 0.0, q_bias: bool = True, kv_bias: bool = True,
                 mlp_ratio: int = 4, *, dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.self_attn = AttentionBlock(channels, None, num_heads, inner_channels, dropout, q_bias, kv_bias, **kw)
        self.cross_attn = AttentionBlock(channels, context_channels, num_heads, inner_channels, dropout, q_bias,
                                         kv_bias, **kw)
        self.ff = FeedForward(channels, channels * mlp_ratio, dropout, **kw)

    def forward(self, x, context=None, attn_mask=None, train: bool = False):
        h = self.self_attn(x, train=train)
        h = self.cross_attn(h, context=context, attn_mask=attn_mask, train=train)
        return self.ff(h, train=train)


class TransformerBlock(nn.Module):
    """GroupNorm + proj_in, ``depth`` attention blocks, proj_out, residual (unet.py:231)."""

    def __init__(self, channels: int, context_channels: int | None = None, num_heads: int = 8,
                 inner_channels: int = -1, dropout: float = 0.0, mlp_ratio: int = 4, depth: int = 1, *,
                 dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        self.inner_channels = channels if inner_channels == -1 else inner_channels
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype, **accum_dtype_kwargs(dtype))
        self.norm_x = GroupNorm32(32, channels, device=device, param_dtype=param_dtype)
        self.proj_in = Linear(channels, self.inner_channels, **kw)
        self.attn_blocks = nn.ModuleList([
            TransformerAttentionBlock(self.inner_channels, context_channels, num_heads, -1, dropout,
                                      mlp_ratio=mlp_ratio, dtype=dtype, device=device, param_dtype=param_dtype)
            for _ in range(depth)])
        self.proj_out = Linear(self.inner_channels, channels, **kw)

    def forward(self, x, context=None, attn_mask=None, train: bool = False):
        if context is None:
            raise ValueError("TransformerBlock requires context input")
        h = self.proj_in(self.norm_x(x))
        for block in self.attn_blocks:
            h = block(h, context=context, attn_mask=attn_mask, train=train)
        return x + self.proj_out(h)


def _parse_channel_mult(channel_mult: str | Sequence[int]) -> list[int]:
    if isinstance(channel_mult, str):
        return [int(v.strip()) for v in channel_mult.split(",")]
    return list(channel_mult)


class UNetModel(Denoiser):
    """Configurable ADM UNet (unet.py:274), NHWC."""

    def __init__(
        self,
        image_size: Sequence[int],
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int,
        attention_resolutions: Sequence[int],
        dropout: float = 0.0,
        channel_mult: str | Sequence[int] = "1, 2, 4, 8",
        conv_resample: bool = True,
        use_checkpoint: bool = False,
        num_heads: int = 1,
        use_scale_shift_norm: bool = False,
        resblock_updown: bool = False,
        n_classes: int | None = None,
        classifier_free: bool = False,
        context_embedder: ContextEmbedder | None = None,
        transformer_depth: int = 1,
        augment_dim: int = 0,
        *,
        dtype: Any = None,
        param_dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        if n_classes is not None and context_embedder is not None:
            raise ValueError("n_classes and context_embedder cannot both be specified")
        if context_embedder is not None and context_embedder.n_output != 1:
            raise ValueError("for UNet please provide a context embedder with n_output=1")
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        self.context_embedder = None if context_embedder is None else context_embedder.to(device)
        self.context_channels = None if context_embedder is None else context_embedder.output_size[0]
        self.image_size = list(image_size)
        self.in_channels = in_channels
        self.model_channels = model_channels
        self.out_channels = out_channels
        self.n_classes = n_classes
        self.classifier_free = classifier_free
        self.use_checkpoint = use_checkpoint
        channel_mult = _parse_channel_mult(channel_mult)
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        cond_kw = dict(dtype=stable_dtype(dtype), device=device, param_dtype=param_dtype)

        self.time_embed_dim = model_channels * 4
        # the per-sample time-embedding MLP stays fp32 under mixed precision
        self.time_fc1 = Linear(model_channels, self.time_embed_dim, **cond_kw)
        self.time_fc2 = Linear(self.time_embed_dim, self.time_embed_dim, **cond_kw)
        self.label_embed = (LabelEmbed(n_classes, self.time_embed_dim, classifier_free, **cond_kw)
                            if n_classes is not None else None)
        # non-leaky augmentation conditioning: zero-init and bias-free, so absent labels are the zero-label path
        self.augment_embed = (Linear(augment_dim, self.time_embed_dim, bias=False, zero_init=True, **cond_kw)
                              if augment_dim > 0 else None)

        def make_attention(ch: int) -> nn.Module:
            if self.context_channels is not None:
                return TransformerBlock(ch, self.context_channels, num_heads, dropout=dropout,
                                        depth=transformer_depth, **kw)
            return AttentionBlock(ch, None, num_heads, dropout=dropout, **kw)

        res_kw = dict(use_scale_shift_norm=use_scale_shift_norm, **kw)
        ch = input_ch = int(channel_mult[0] * model_channels)
        input_blocks: list[list[nn.Module]] = [[_conv3(in_channels, ch, **kw)]]
        input_block_chans = [ch]
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers: list[nn.Module] = [ResBlock(ch, self.time_embed_dim, dropout, int(mult * model_channels),
                                                    **res_kw)]
                ch = int(mult * model_channels)
                if ds in attention_resolutions:
                    layers.append(make_attention(ch))
                input_blocks.append(layers)
                input_block_chans.append(ch)
            if level != len(channel_mult) - 1:
                if resblock_updown:
                    down: nn.Module = ResBlock(ch, self.time_embed_dim, dropout, ch, down=True, **res_kw)
                else:
                    down = Downsample(ch, conv_resample, ch, **kw)
                input_blocks.append([down])
                input_block_chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList([nn.ModuleList(b) for b in input_blocks])

        self.middle_block = nn.ModuleList([
            ResBlock(ch, self.time_embed_dim, dropout, **res_kw),
            make_attention(ch),
            ResBlock(ch, self.time_embed_dim, dropout, **res_kw),
        ])

        output_blocks: list[list[nn.Module]] = []
        out_group_meta: list[tuple[int, int]] = []  # (channels, ds) after each decoder group
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                ich = input_block_chans.pop()
                layers = [ResBlock(ch + ich, self.time_embed_dim, dropout, int(model_channels * mult), **res_kw)]
                ch = int(model_channels * mult)
                if ds in attention_resolutions:
                    layers.append(make_attention(ch))
                if level and i == num_res_blocks:
                    if resblock_updown:
                        layers.append(ResBlock(ch, self.time_embed_dim, dropout, ch, up=True, **res_kw))
                    else:
                        layers.append(Upsample(ch, conv_resample, ch, **kw))
                    ds //= 2
                output_blocks.append(layers)
                out_group_meta.append((ch, ds))
        self.output_blocks = nn.ModuleList([nn.ModuleList(b) for b in output_blocks])
        self._out_group_meta = out_group_meta
        self._compute_dtype = dtype
        self.cache_split: int | None = None  # DeepCache: set through set_block_cache_span
        # U-REPA feature capture (arXiv:2503.18414; RepaLoss.set_model writes this): flat capture-point
        # indices over the input groups (0..N-1), the middle block (N) and the output groups (N+1..2N)
        self.feature_layers: tuple[int, ...] = ()

        self.out_norm = GroupNorm32(32, ch, device=device, param_dtype=param_dtype)
        self.out_conv = zero_conv(input_ch, out_channels, 3, **kw)

    @property
    def layers(self) -> list[nn.Module]:
        """The flat capture points, in the forward's capture order: the input
        groups, the middle block, the output groups (unet.py:416-420)."""
        return list(self.input_blocks) + [self.middle_block] + list(self.output_blocks)

    # --- blocks -----------------------------------------------------------------
    def _apply_block(self, block: nn.Module, h, emb, context, attn_mask, train: bool):
        """Dispatch like the reference's EmbedSequential (unet.py:263); with
        ``use_checkpoint`` and under grad, a ResBlock or attention block is
        recomputed in the backward instead of keeping its activations."""
        if isinstance(block, ResBlock):
            args = (h, emb, train)
        elif isinstance(block, (AttentionBlock, TransformerBlock)):
            args = (h, context, attn_mask, train)
        else:
            return block(h)
        if self.use_checkpoint and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def _run_group(self, group, h, emb, context, attn_mask, train):
        for block in group:
            h = self._apply_block(block, h, emb, context, attn_mask, train)
        return h

    # --- sampling-time deep-feature caching (DeepCache) ----------------------------
    def set_block_cache_span(self, span: tuple[int, int] | None) -> None:
        """``span = (k, N)`` with ``N = len(input_blocks)``: encoder groups
        ``[0, k)`` and the matching decoder suffix keep running, everything
        deeper is cached; None turns caching off (unet.py:402)."""
        if span is None:
            self.cache_split = None
            return
        k, hi = int(span[0]), int(span[1])
        n = len(self.input_blocks)
        if hi != n:
            raise ValueError(f"UNet deep-caching spans reach the U bottom: span must be (k, {n}), got ({k}, {hi})")
        if not 1 <= k <= n - 1:
            raise ValueError(f"cache split k={k} out of range [1, {n - 1}]")
        self.cache_split = k

    def _cache_dtype(self) -> torch.dtype:
        return stable_dtype(self._compute_dtype) or torch.float32

    @torch.no_grad()
    def init_block_cache(self, data_shape, cond, use_cfg: bool) -> tuple[torch.Tensor]:
        """A zero cache shaped like the decoder feature after output group
        ``N - k - 1``, 2x-batched under fused CFG; never read (the first step
        refreshes)."""
        if self.cache_split is None:
            raise ValueError("call set_block_cache_span first")
        del cond
        ch, ds = self._out_group_meta[len(self.input_blocks) - self.cache_split - 1]
        b = data_shape[0] * (2 if use_cfg else 1)
        return (torch.zeros((b, data_shape[1] // ds, data_shape[2] // ds, ch), dtype=self._cache_dtype(),
                            device=self.out_conv.weight.device),)

    # --- forward ------------------------------------------------------------------
    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        cond: dict[str, Any] | None = None,
        drop: torch.Tensor | None = None,
        train: bool = False,
        capture_features: bool = False,
        block_cache: Any = None,
        cache_refresh: bool | None = None,
        generator: torch.Generator | None = None,
    ) -> ModelOutput:
        del generator  # dropout draws from torch's global generator, as nn.Dropout does
        cond = cond or {}
        y, context_raw, x_context = cond.get("y"), cond.get("context"), cond.get("x_context")
        if list(x.shape[1:3]) != self.image_size:
            raise ValueError(f"Input shape {list(x.shape[1:3])} does not match model image size {self.image_size}")
        if (y is not None) != (self.n_classes is not None):
            raise ValueError("must specify y if and only if the model is class-conditional")
        if (context_raw is not None) != (self.context_embedder is not None):
            raise ValueError("must specify context if and only if the model is context-conditional")

        emb = self.time_fc2(F.silu(self.time_fc1(timestep_embedding(timesteps, self.model_channels).to(x.dtype))))
        if self.label_embed is not None:
            emb = emb + self.label_embed(y, drop if self.classifier_free else None)
        aug = cond.get("augment_labels")
        if aug is not None:
            if self.augment_embed is None:
                raise ValueError("augment labels need augment_dim > 0")
            emb = emb + self.augment_embed(aug.to(emb.dtype))
        context = attn_mask = None
        if self.context_embedder is not None:
            context_output = self.context_embedder(context_raw, drop)
            context = context_output["embeddings"]
            attn_mask = context_output.get("attn_mask")
        if x_context is not None:
            x = torch.cat([x, x_context], dim=-1)

        if self.cache_split is not None and block_cache is not None and cache_refresh is not None:
            if capture_features:
                raise ValueError("block caching is a sampling-time feature; feature capture (REPA) is a "
                                 "training-time one: they don't compose")
            return self._cached_forward(x, emb, context, attn_mask, train, block_cache, cache_refresh)

        # U-REPA capture points (unet.py:517-547): each group's (and the middle block's) output,
        # flattened to [B, H*W, C] tokens
        points = iter(range(len(self.input_blocks) + 1 + len(self.output_blocks)))
        capture = set(self.feature_layers) if capture_features else set()
        features: list[torch.Tensor] = []

        def tap(t: torch.Tensor) -> None:
            if next(points) in capture:
                features.append(t.reshape(t.shape[0], -1, t.shape[-1]))

        hs: list[torch.Tensor] = []
        h = x
        for group in self.input_blocks:
            h = self._run_group(group, h, emb, context, attn_mask, train)
            hs.append(h)
            tap(h)
        h = self._run_group(self.middle_block, h, emb, context, attn_mask, train)
        tap(h)
        for group in self.output_blocks:
            h = self._run_group(group, torch.cat([h, hs.pop()], dim=-1), emb, context, attn_mask, train)
            tap(h)
        out: ModelOutput = {"x": self.out_conv(F.silu(self.out_norm(h)))}
        if capture_features:
            out["features"] = features
        return out

    def _cached_forward(self, x, emb, context, attn_mask, train, block_cache, cache_refresh: bool) -> ModelOutput:
        """DeepCache forward (unet.py:551): the deep segment (encoder groups
        ``[k:]``, the middle block, decoder groups ``[:N-k]``) on a refresh,
        the cached deep decoder feature otherwise."""
        k, n = self.cache_split, len(self.input_blocks)
        dt = self._cache_dtype()
        hs: list[torch.Tensor] = []
        h = x
        for group in list(self.input_blocks)[:k]:
            h = self._run_group(group, h, emb, context, attn_mask, train)
            hs.append(h)
        if cache_refresh:
            deep_hs: list[torch.Tensor] = []
            for group in list(self.input_blocks)[k:]:
                h = self._run_group(group, h, emb, context, attn_mask, train)
                deep_hs.append(h)
            h = self._run_group(self.middle_block, h, emb, context, attn_mask, train)
            for group in list(self.output_blocks)[:n - k]:
                h = self._run_group(group, torch.cat([h, deep_hs.pop()], dim=-1), emb, context, attn_mask, train)
            h = h.to(dt)
        else:
            h = block_cache[0].to(dt)
        new_cache = (h,)
        for group in list(self.output_blocks)[n - k:]:
            h = self._run_group(group, torch.cat([h, hs.pop()], dim=-1), emb, context, attn_mask, train)
        return {"x": self.out_conv(F.silu(self.out_norm(h))), "block_cache": new_cache}
