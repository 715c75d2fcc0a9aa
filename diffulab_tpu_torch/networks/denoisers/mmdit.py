"""DiT denoiser, simple (class-conditional single-stream) path — port of
diffulab_tpu/networks/denoisers/mmdit.py.

NHWC patchify -> adaLN-zero ``DiTBlock`` stack with QKNorm and 2-axis planar
RoPE -> modulated last layer -> unpatchify. Attention goes through
:func:`diffulab_tpu_torch.ops.dot_product_attention` (the fused CUDA kernel
on the card). Parameter names follow the reference's module paths so that
:mod:`diffulab_tpu_torch.weights` maps a JAX state one to one.

The patchify convolution (stride = kernel = patch) is written as a reshape
plus a matmul over non-overlapping patches: the same function, and on the
card a float32 matmul stays full fp32 where cuDNN would run the conv in TF32.

Not ported yet (they raise ``NotImplementedError``): the multimodal MMDiT
(``simple_dit=False``), MoE MLPs, ring attention, GPipe pipelining, block
caching, REPA feature capture and augmentation labels.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diffulab_tpu_torch.networks.denoisers.common import Denoiser, ModelOutput
from diffulab_tpu_torch.networks.nn import (
    LabelEmbed,
    Linear,
    Modulation,
    QKNorm,
    apply_rope_ndim_planar,
    get_cos_sin_ndim_grid,
    modulate,
    packed_swiglu,
    stable_dtype,
    timestep_embedding,
)
from diffulab_tpu_torch.ops import dot_product_attention
from diffulab_tpu_torch.utils import resolve_device, resolve_dtype


class LayerNormFP32(nn.Module):
    """LayerNorm computed in fp32, cast back to the input dtype (mmdit.py:77)."""

    def __init__(self, dim: int, use_affine: bool = True, eps: float = 1e-5, *,
                 device=None, param_dtype=torch.float32):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=eps, elementwise_affine=use_affine,
                                 device=device, dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.norm
        weight = None if n.weight is None else n.weight.float()
        bias = None if n.bias is None else n.bias.float()
        return F.layer_norm(x.float(), n.normalized_shape, weight, bias, n.eps).to(x.dtype)


class SwiGLUMlp(nn.Module):
    """Packed SwiGLU MLP, no bias (mmdit.py:91)."""

    def __init__(self, dim: int, mlp_ratio: int, *, dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device, param_dtype=param_dtype)
        self.fc_in = Linear(dim, mlp_ratio * dim * 2, **kw)
        self.fc_out = Linear(mlp_ratio * dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_out(packed_swiglu(self.fc_in(x)))


class DiTAttention(nn.Module):
    """Self-attention with QKNorm (over the full inner dim, before the head
    split) and N-D planar RoPE (mmdit.py:132)."""

    def __init__(self, inner_dim: int, num_heads: int, rope_axes_dim: Sequence[int], *,
                 dtype=None, device=None, param_dtype=torch.float32, attention_impl: str = "auto"):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = inner_dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.rotary_dim = int(sum(rope_axes_dim))
        self.attention_impl = attention_impl
        self.kernel_dtype = dtype
        kw = dict(bias=False, dtype=dtype, device=device, param_dtype=param_dtype)
        self.qkv = Linear(inner_dim, 3 * inner_dim, **kw)
        self.qk_norm = QKNorm(inner_dim, device=device, param_dtype=param_dtype)
        self.proj_out = Linear(inner_dim, inner_dim, **kw)

    def forward(self, x: torch.Tensor, cos_sin_rope, attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        b, s, _ = x.shape
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        q, k = self.qk_norm(q, k, v)
        q = q.reshape(b, s, self.num_heads, self.head_dim)
        k = k.reshape(b, s, self.num_heads, self.head_dim)
        v = v.reshape(b, s, self.num_heads, self.head_dim)
        cos, sin = cos_sin_rope
        q, k = apply_rope_ndim_planar(q, k, cos, sin, self.rotary_dim)
        if self.kernel_dtype is not None:
            q, k, v = (t.to(self.kernel_dtype) for t in (q, k, v))
        out = dot_product_attention(q, k, v, kv_mask=attn_mask, scale=self.scale,
                                    impl=self.attention_impl)
        return self.proj_out(out.reshape(b, s, -1))


class DiTBlock(nn.Module):
    """adaLN-zero DiT block: 6-param modulation around attention + SwiGLU MLP
    (mmdit.py:244)."""

    def __init__(self, inner_dim: int, embedding_dim: int, num_heads: int, mlp_ratio: int,
                 rope_axes_dim: Sequence[int], *, dtype=None, stable_conditioning: bool = True,
                 device=None, param_dtype=torch.float32, attention_impl: str = "auto"):
        super().__init__()
        kw = dict(device=device, param_dtype=param_dtype)
        self.modulation = Modulation(embedding_dim, inner_dim,
                                     dtype=stable_dtype(dtype, stable_conditioning), **kw)
        self.norm_1 = LayerNormFP32(inner_dim, **kw)
        self.attention = DiTAttention(inner_dim, num_heads, rope_axes_dim, dtype=dtype,
                                      attention_impl=attention_impl, **kw)
        self.norm_2 = LayerNormFP32(inner_dim, **kw)
        self.mlp_input = SwiGLUMlp(inner_dim, mlp_ratio, dtype=dtype, **kw)

    def forward(self, x: torch.Tensor, y: torch.Tensor, cos_sin_rope, attn_mask=None) -> torch.Tensor:
        mod = self.modulation(y)
        x = x + self.attention(
            modulate(self.norm_1(x), scale=mod.alpha, shift=mod.beta),
            cos_sin_rope=cos_sin_rope, attn_mask=attn_mask,
        ) * mod.gamma
        x = x + self.mlp_input(modulate(self.norm_2(x), scale=mod.delta, shift=mod.epsilon)) * mod.zeta
        return x


class ModulatedLastLayer(nn.Module):
    """adaLN-zero final projection to patch*patch*C_out (mmdit.py:356); it and
    its modulation run at the conditioning dtype."""

    def __init__(self, embedding_dim: int, hidden_size: int, patch_size: int, out_channels: int,
                 *, dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.norm_final = LayerNormFP32(hidden_size, use_affine=False, eps=1e-6,
                                        device=device, param_dtype=param_dtype)
        self.linear = Linear(hidden_size, patch_size * patch_size * out_channels, **kw)
        self.adaLN_modulation = Modulation(embedding_dim, hidden_size, n_chunks=2, **kw)

    def forward(self, x: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
        alpha, beta = self.adaLN_modulation(vec)
        x = modulate(self.norm_final(x), scale=alpha, shift=beta)
        return self.linear(x)


class TimeEmbedMlp(nn.Module):
    """Linear -> SiLU -> Linear time-embedding MLP (mmdit.py:376)."""

    def __init__(self, in_dim: int, dim: int, *, dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.fc1 = Linear(in_dim, dim, **kw)
        self.fc2 = Linear(dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(x)))


class PatchEmbed(nn.Module):
    """Stride-P, P x P, bias-free patch convolution as a matmul over
    non-overlapping patches; ``weight`` is the OIHW conv kernel."""

    def __init__(self, in_channels: int, out_channels: int, patch_size: int, *,
                 dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, patch_size, patch_size,
                                               device=device, dtype=param_dtype))
        nn.init.xavier_uniform_(self.weight)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
        """NHWC [B, H, W, C] -> ([B, Hp*Wp, out_channels], (Hp, Wp))."""
        b, h, w, c = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"image size {(h, w)} is not a multiple of the patch size {p}")
        hp, wp = h // p, w // p
        patches = x.reshape(b, hp, p, wp, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp * wp, p * p * c)
        kernel = self.weight.permute(0, 2, 3, 1).reshape(self.weight.shape[0], p * p * c)
        dt = self.dtype or torch.promote_types(x.dtype, kernel.dtype)
        return F.linear(patches.to(dt), kernel.to(dt)), (hp, wp)


class MMDiT(Denoiser):
    """DiT top-level model, ``simple_dit=True`` path (mmdit.py:407).

    The precision policy is the reference's: ``dtype`` is the compute dtype of
    the block matmuls (None = fp32); with ``stable_conditioning`` the
    conditioning path and the residual stream stay fp32 under a half
    ``dtype``; ``stream_dtype`` overrides the residual stream's dtype.
    The bench configuration is the whole-model bf16 cast:
    ``dtype=torch.bfloat16, stable_conditioning=False, stream_dtype=torch.bfloat16``.
    """

    def __init__(
        self,
        simple_dit: bool = False,
        input_channels: int = 3,
        output_channels: int | None = None,
        inner_dim: int = 4096,
        embedding_dim: int = 4096,
        num_heads: int = 16,
        mlp_ratio: int = 4,
        patch_size: int = 16,
        depth: int = 38,
        rope_base: int = 10_000,
        partial_rotary_factor: float = 1.0,
        rope_axes_dim: Sequence[int] | None = None,
        frequency_embedding: int = 256,
        n_classes: int | None = None,
        classifier_free: bool = False,
        attention_impl: str = "auto",
        mlp_type: str = "swiglu",
        pipeline_microbatches: int | None = None,
        stable_conditioning: bool = True,
        stream_dtype: Any = None,
        *,
        dtype: Any = None,
        param_dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        if not simple_dit:
            raise NotImplementedError("the multimodal MMDiT (simple_dit=False) is ROADMAP slice B")
        if mlp_type != "swiglu":
            raise NotImplementedError(f"mlp_type={mlp_type!r} (MoE) is not ported yet")
        if attention_impl == "ring":
            raise NotImplementedError("ring attention is not ported yet (ROADMAP queue 1, item 17)")
        if pipeline_microbatches is not None:
            raise NotImplementedError("pipeline parallelism is not ported yet (ROADMAP queue 1, item 17)")
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        stream_dtype = resolve_dtype(stream_dtype)
        self.simple_dit = simple_dit
        self.patch_size = patch_size
        self.input_channels = input_channels
        self.output_channels = output_channels or input_channels
        self.frequency_embedding = frequency_embedding
        self.rope_base = rope_base
        self.n_classes = n_classes
        self.classifier_free = classifier_free
        self.inner_dim = inner_dim
        self.attention_impl = attention_impl
        cond_dtype = stable_dtype(dtype, stable_conditioning)
        self.stream_dtype = stream_dtype if stream_dtype is not None else cond_dtype

        kw = dict(device=device, param_dtype=param_dtype)
        heads_dim = inner_dim // num_heads
        if rope_axes_dim is None:
            d2 = int((partial_rotary_factor * heads_dim) // 2)
            d2 -= d2 % 2
            rope_axes_dim = [d2, d2]  # (H, W)
        self.rope_axes_dim = list(rope_axes_dim)
        self.label_embed = (LabelEmbed(n_classes, embedding_dim, classifier_free, dtype=cond_dtype, **kw)
                            if n_classes is not None else None)
        self.last_layer = ModulatedLastLayer(embedding_dim, inner_dim, patch_size, self.output_channels,
                                             dtype=cond_dtype, **kw)
        self.time_embed = TimeEmbedMlp(frequency_embedding, embedding_dim, dtype=cond_dtype, **kw)
        self.conv_proj = PatchEmbed(self.input_channels, inner_dim, patch_size, dtype=cond_dtype, **kw)
        self.layers = nn.ModuleList([
            DiTBlock(inner_dim, embedding_dim, num_heads, mlp_ratio, self.rope_axes_dim, dtype=dtype,
                     stable_conditioning=stable_conditioning, attention_impl=attention_impl, **kw)
            for _ in range(depth)
        ])

    # --- patch ops ---------------------------------------------------------
    def patchify(self, x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
        """NHWC image -> [B, Hp*Wp, inner_dim]; returns the token grid size."""
        tokens, grid_size = self.conv_proj(x)
        if self.stream_dtype is not None:
            tokens = tokens.to(self.stream_dtype)
        return tokens, grid_size

    def unpatchify(self, x: torch.Tensor, grid_size: tuple[int, int]) -> torch.Tensor:
        hp, wp = grid_size
        p = self.patch_size
        b = x.shape[0]
        x = x.reshape(b, hp, wp, p, p, self.output_channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, hp * p, wp * p, self.output_channels)

    def _image_pos_ids(self, batch: int, grid_size: tuple[int, int], device) -> torch.Tensor:
        hp, wp = grid_size
        hh, ww = torch.meshgrid(torch.arange(hp, device=device), torch.arange(wp, device=device),
                                indexing="ij")
        pos = torch.stack([hh.reshape(-1), ww.reshape(-1)], dim=-1)
        return pos[None].expand(batch, hp * wp, 2)

    def set_block_cache_span(self, span: tuple[int, int] | None) -> None:
        if span is not None:
            raise NotImplementedError("block caching is not ported yet (ROADMAP queue 1, item 7)")

    def _simple_dit_forward(self, x, grid_size, timesteps, y, drop):
        emb = self.time_embed(timestep_embedding(timesteps, self.frequency_embedding).to(x.dtype))
        if self.label_embed is not None:
            if y is None:
                raise ValueError("class labels y required for label-conditional DiT")
            emb = emb + self.label_embed(y, drop if self.classifier_free else None)
        pos_ids = self._image_pos_ids(x.shape[0], grid_size, x.device)
        cos_sin = get_cos_sin_ndim_grid(pos_ids, self.rope_base, self.rope_axes_dim)
        for layer in self.layers:
            x = layer(x, emb, cos_sin, None)
        return self.last_layer(x, emb)

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        cond: dict[str, Any] | None = None,
        drop: torch.Tensor | None = None,
        train: bool = False,
        capture_features: bool = False,
    ) -> ModelOutput:
        del train
        if capture_features:
            raise NotImplementedError("REPA feature capture is not ported yet (ROADMAP queue 1, item 13)")
        cond = cond or {}
        if cond.get("augment_labels") is not None:
            raise NotImplementedError("augmentation conditioning is not ported yet (ROADMAP queue 1, item 15)")
        x_context = cond.get("x_context")
        if x_context is not None:
            x = torch.cat([x, x_context], dim=-1)  # NHWC channel concat
        tokens, grid_size = self.patchify(x)
        out = self._simple_dit_forward(tokens, grid_size, timesteps, cond.get("y"), drop)
        return {"x": self.unpatchify(out, grid_size)}
