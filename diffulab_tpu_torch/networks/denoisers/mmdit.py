"""DiT / MMDiT denoiser — port of diffulab_tpu/networks/denoisers/mmdit.py.

NHWC patchify -> adaLN-zero blocks with QKNorm and planar RoPE -> modulated
last layer -> unpatchify. Two forms:

- ``simple_dit=True``: class-conditional ``DiTBlock`` stack, 2-axis RoPE;
- ``simple_dit=False``: the multimodal MMDiT over ``[context; image]`` tokens,
  dual-stream ``MMDiTBlock``s then ``n_single_stream_blocks`` Flux-style
  ``MMDiTSingleStreamBlock``s, 3-axis RoPE with text positions ``(l, 0, 0)``
  from l = 1 and image positions ``(0, h, w)``; the context comes from a
  :class:`~diffulab_tpu_torch.networks.embedders.ContextEmbedder`, whose key
  mask is extended with ones over the image tokens.

Attention goes through :func:`diffulab_tpu_torch.ops.dot_product_attention`
(on the card: the fused kernels K1/K2 up to 512 tokens, the flash kernels
K3/K4/K5 beyond). ``use_checkpoint`` recomputes each block in the backward
(``torch.utils.checkpoint``, where the reference applies ``nnx.remat``),
so a block's forward, attention included, runs twice under grad. Parameter
names follow the reference's module paths so that
:mod:`diffulab_tpu_torch.weights` maps a JAX state one to one.

The patchify convolution (stride = kernel = patch) is written as a reshape
plus a matmul over non-overlapping patches: the same function, and on the
card a float32 matmul stays full fp32 where cuDNN would run the conv in TF32.

Sampling-time block caching (Delta-DiT, arXiv:2406.01125; mmdit.py:641-700):
with a ``cache_span`` set, a call given ``block_cache`` and
``cache_refresh`` runs the span's blocks and returns their residual delta on
a refresh, or skips them and adds the cached delta otherwise (a host bool:
the branch is picked in Python). ``augment_dim > 0`` adds the non-leaky
augmentation labels (``cond["augment_labels"]``, :mod:`..diffuse.augment`)
to the time embedding through a zero-initialised, bias-free Linear.

REPA feature capture (mmdit.py:712-819): with ``capture_features=True`` the
forward also returns ``out["features"]``, the image tokens after each block
whose index is in ``feature_layers`` (``RepaLoss.set_model`` writes it), on
the ``use_checkpoint`` path too, where gradients reach them through the
recomputed blocks. Capture and block caching do not compose (a training and
a sampling feature; the reference asserts it).

The parallel paths (mmdit.py:105-128, 143-158, 794-860) follow the mesh
that :meth:`MMDiT.set_parallel_mesh` injects (the trainers do):
``mlp_type="moe"`` builds DiT blocks with :class:`MoEMlp` (switch-routed
experts, expert-parallel over the ``expert`` axis, dense without one);
``attention_impl="ring"`` runs ring attention over ``sp`` once a mesh is
set, even of one block, and the attention kernels without one;
``pipeline_microbatches`` runs the DiT block stack as GPipe stages over
``pipe`` when that axis is larger than 1, without feature capture,
``use_checkpoint`` or a block cache, and in sequence otherwise.
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
from diffulab_tpu_torch.ops.ring_attention import sequence_parallel_attention
from diffulab_tpu_torch.parallel.mesh import axis_group, mesh_shape
from diffulab_tpu_torch.parallel.moe import ExpertMlp, expert_parallel_mlp, moe_mlp_local
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

    #: tensor parallelism (parallel/sharding.py; the reference's "hidden" axis, :97-99): the packed
    #: [x; gate] input column-parallel by channel pair, the output row-parallel
    tp_plan = {"fc_in": ("column", 2), "fc_out": ("row", 1)}

    def __init__(self, dim: int, mlp_ratio: int, *, dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device, param_dtype=param_dtype)
        self.fc_in = Linear(dim, mlp_ratio * dim * 2, **kw)
        self.fc_out = Linear(mlp_ratio * dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_out(packed_swiglu(self.fc_in(x)))


class MoEMlp(nn.Module):
    """Switch-routed mixture-of-experts MLP (mmdit.py:105): expert-parallel
    over the mesh's ``expert`` axis once a mesh with that axis larger than 1
    is set, dense otherwise. The router's load-balance loss of the last call
    is kept in ``load_balance_loss`` (the reference sows it as
    ``moe_load_balance``; nothing adds it to the loss)."""

    def __init__(self, dim: int, mlp_ratio: int, n_experts: int, capacity_factor: float, *, dtype=None,
                 device=None, param_dtype=torch.float32):
        super().__init__()
        self.experts = ExpertMlp(n_experts, dim, mlp_ratio * dim, dtype=dtype, device=device, param_dtype=param_dtype)
        self.capacity_factor = capacity_factor
        self.mesh = None
        self.load_balance_loss: torch.Tensor | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if mesh_shape(self.mesh)["expert"] > 1:
            y, aux = expert_parallel_mlp(self.experts, x, group=axis_group(self.mesh, "expert"),
                                         capacity_factor=self.capacity_factor)
        else:
            y, aux = moe_mlp_local(self.experts, x, self.capacity_factor)
        self.load_balance_loss = aux["load_balance_loss"]
        return y


def _attend(module: nn.Module, q, k, v, attn_mask):
    """Ring attention over the mesh's ``sp`` axis for ``attention_impl="ring"``
    with a mesh set (mmdit.py:143-158), else the attention kernels."""
    if module.attention_impl == "ring" and module.mesh is not None:
        return sequence_parallel_attention(module.mesh, "sp")(q, k, v, kv_mask=attn_mask, scale=module.scale)
    impl = "auto" if module.attention_impl == "ring" else module.attention_impl
    return dot_product_attention(q, k, v, kv_mask=attn_mask, scale=module.scale, impl=impl)


class DiTAttention(nn.Module):
    """Self-attention with QKNorm (over the full inner dim, before the head
    split) and N-D planar RoPE (mmdit.py:132)."""

    #: tensor parallelism by head (parallel/sharding.py, T27): the fused qkv column-parallel in 3 parts
    tp_plan = {"qkv": ("column", 3), "proj_out": ("row", 1)}

    def __init__(self, inner_dim: int, num_heads: int, rope_axes_dim: Sequence[int], *,
                 dtype=None, device=None, param_dtype=torch.float32, attention_impl: str = "auto"):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = inner_dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.rotary_dim = int(sum(rope_axes_dim))
        self.attention_impl = attention_impl
        self.mesh = None  # set by MMDiT.set_parallel_mesh, for "ring"
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
        out = _attend(self, q, k, v, attn_mask)
        return self.proj_out(out.reshape(b, s, -1))


class DiTBlock(nn.Module):
    """adaLN-zero DiT block: 6-param modulation around attention + SwiGLU MLP
    (mmdit.py:244)."""

    def __init__(self, inner_dim: int, embedding_dim: int, num_heads: int, mlp_ratio: int,
                 rope_axes_dim: Sequence[int], *, dtype=None, stable_conditioning: bool = True,
                 device=None, param_dtype=torch.float32, attention_impl: str = "auto",
                 attention_dtype=None, mlp_dtype=None, mlp_type: str = "swiglu", n_experts: int = 8,
                 capacity_factor: float = 2.0):
        super().__init__()
        kw = dict(device=device, param_dtype=param_dtype)
        # per-component precision overrides, defaulting to the block's compute dtype (mmdit.py:253)
        attention_dtype = attention_dtype if attention_dtype is not None else dtype
        mlp_dtype = mlp_dtype if mlp_dtype is not None else dtype
        self.modulation = Modulation(embedding_dim, inner_dim,
                                     dtype=stable_dtype(dtype, stable_conditioning), **kw)
        self.norm_1 = LayerNormFP32(inner_dim, **kw)
        self.attention = DiTAttention(inner_dim, num_heads, rope_axes_dim, dtype=attention_dtype,
                                      attention_impl=attention_impl, **kw)
        self.norm_2 = LayerNormFP32(inner_dim, **kw)
        if mlp_type == "moe":
            self.mlp_input = MoEMlp(inner_dim, mlp_ratio, n_experts, capacity_factor, dtype=mlp_dtype, **kw)
        elif mlp_type == "swiglu":
            self.mlp_input = SwiGLUMlp(inner_dim, mlp_ratio, dtype=mlp_dtype, **kw)
        else:
            raise ValueError(f"unknown mlp_type {mlp_type!r}")

    def forward(self, x: torch.Tensor, y: torch.Tensor, cos_sin_rope, attn_mask=None) -> torch.Tensor:
        mod = self.modulation(y)
        x = x + self.attention(
            modulate(self.norm_1(x), scale=mod.alpha, shift=mod.beta),
            cos_sin_rope=cos_sin_rope, attn_mask=attn_mask,
        ) * mod.gamma
        x = x + self.mlp_input(modulate(self.norm_2(x), scale=mod.delta, shift=mod.epsilon)) * mod.zeta
        return x


class MMDiTAttention(nn.Module):
    """Dual-stream concat attention (mmdit.py:180): separate qkv/QKNorm/out
    projections per stream; q/k/v concatenated ``[context; input]`` along the
    sequence, RoPE'd with the 3-axis grid, attended jointly, split back."""

    #: tensor parallelism by head (parallel/sharding.py; mmdit.py:199-204)
    tp_plan = {"qkv_input": ("column", 3), "qkv_context": ("column", 3), "input_proj_out": ("row", 1),
               "context_proj_out": ("row", 1)}

    def __init__(self, inner_dim: int, num_heads: int, rope_axes_dim: Sequence[int], *,
                 dtype=None, device=None, param_dtype=torch.float32, attention_impl: str = "auto"):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = inner_dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.rotary_dim = int(sum(rope_axes_dim))
        self.attention_impl = attention_impl
        self.mesh = None  # set by MMDiT.set_parallel_mesh, for "ring"
        self.kernel_dtype = dtype
        kw = dict(bias=False, dtype=dtype, device=device, param_dtype=param_dtype)
        self.qkv_input = Linear(inner_dim, 3 * inner_dim, **kw)
        self.qkv_context = Linear(inner_dim, 3 * inner_dim, **kw)
        self.qk_norm_input = QKNorm(inner_dim, device=device, param_dtype=param_dtype)
        self.qk_norm_context = QKNorm(inner_dim, device=device, param_dtype=param_dtype)
        self.input_proj_out = Linear(inner_dim, inner_dim, **kw)
        self.context_proj_out = Linear(inner_dim, inner_dim, **kw)

    def forward(self, x: torch.Tensor, context: torch.Tensor, cos_sin_rope,
                attn_mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        b, s_img, _ = x.shape
        s_ctx = context.shape[1]
        iq, ik, iv = self.qkv_input(x).chunk(3, dim=-1)
        cq, ck, cv = self.qkv_context(context).chunk(3, dim=-1)
        iq, ik = self.qk_norm_input(iq, ik, iv)
        cq, ck = self.qk_norm_context(cq, ck, cv)

        def heads(t):
            return t.reshape(b, t.shape[1], self.num_heads, self.head_dim)

        q = heads(torch.cat([cq, iq], dim=1))
        k = heads(torch.cat([ck, ik], dim=1))
        v = heads(torch.cat([cv, iv], dim=1))
        cos, sin = cos_sin_rope
        q, k = apply_rope_ndim_planar(q, k, cos, sin, self.rotary_dim)
        if self.kernel_dtype is not None:
            q, k, v = (t.to(self.kernel_dtype) for t in (q, k, v))
        kv_mask = None
        if attn_mask is not None:
            kv_mask = torch.cat([attn_mask.bool(), torch.ones((b, s_img), dtype=torch.bool, device=x.device)], dim=1)
        out = _attend(self, q, k, v, kv_mask)
        out = out.reshape(b, s_ctx + s_img, -1)
        return self.input_proj_out(out[:, s_ctx:]), self.context_proj_out(out[:, :s_ctx])


class MMDiTBlock(nn.Module):
    """Dual-stream MMDiT block with per-stream modulation, norms and MLPs
    (mmdit.py:279)."""

    def __init__(self, inner_dim: int, embedding_dim: int, num_heads: int, mlp_ratio: int,
                 rope_axes_dim: Sequence[int], *, dtype=None, stable_conditioning: bool = True,
                 device=None, param_dtype=torch.float32, attention_impl: str = "auto",
                 attention_dtype=None, mlp_dtype=None):
        super().__init__()
        kw = dict(device=device, param_dtype=param_dtype)
        attention_dtype = attention_dtype if attention_dtype is not None else dtype
        mlp_dtype = mlp_dtype if mlp_dtype is not None else dtype
        mod_dtype = stable_dtype(dtype, stable_conditioning)
        self.modulation_context = Modulation(embedding_dim, inner_dim, dtype=mod_dtype, **kw)
        self.modulation_input = Modulation(embedding_dim, inner_dim, dtype=mod_dtype, **kw)
        self.context_norm_1 = LayerNormFP32(inner_dim, **kw)
        self.input_norm_1 = LayerNormFP32(inner_dim, **kw)
        self.attention = MMDiTAttention(inner_dim, num_heads, rope_axes_dim, dtype=attention_dtype,
                                        attention_impl=attention_impl, **kw)
        self.context_norm_2 = LayerNormFP32(inner_dim, **kw)
        self.input_norm_2 = LayerNormFP32(inner_dim, **kw)
        self.mlp_context = SwiGLUMlp(inner_dim, mlp_ratio, dtype=mlp_dtype, **kw)
        self.mlp_input = SwiGLUMlp(inner_dim, mlp_ratio, dtype=mlp_dtype, **kw)

    def forward(self, x, y, context, cos_sin_rope, attn_mask=None):
        mod_i = self.modulation_input(y)
        mod_c = self.modulation_context(y)
        mi = modulate(self.input_norm_1(x), scale=mod_i.alpha, shift=mod_i.beta)
        mc = modulate(self.context_norm_1(context), scale=mod_c.alpha, shift=mod_c.beta)
        mi, mc = self.attention(mi, mc, cos_sin_rope=cos_sin_rope, attn_mask=attn_mask)
        x = x + mi * mod_i.gamma
        context = context + mc * mod_c.gamma
        x = x + self.mlp_input(modulate(self.input_norm_2(x), scale=mod_i.delta, shift=mod_i.epsilon)) * mod_i.zeta
        context = context + self.mlp_context(
            modulate(self.context_norm_2(context), scale=mod_c.delta, shift=mod_c.epsilon)
        ) * mod_c.zeta
        return x, context


class MMDiTSingleStreamBlock(nn.Module):
    """Flux-style fused single-stream block: 3-param modulation, parallel
    attention + MLP on the concatenated ``[context; input]`` stream
    (mmdit.py:319)."""

    def __init__(self, inner_dim: int, embedding_dim: int, num_heads: int, mlp_ratio: int,
                 rope_axes_dim: Sequence[int], *, dtype=None, stable_conditioning: bool = True,
                 device=None, param_dtype=torch.float32, attention_impl: str = "auto",
                 attention_dtype=None, mlp_dtype=None):
        super().__init__()
        kw = dict(device=device, param_dtype=param_dtype)
        attention_dtype = attention_dtype if attention_dtype is not None else dtype
        mlp_dtype = mlp_dtype if mlp_dtype is not None else dtype
        self.mlp = SwiGLUMlp(inner_dim, mlp_ratio, dtype=mlp_dtype, **kw)
        self.attention = DiTAttention(inner_dim, num_heads, rope_axes_dim, dtype=attention_dtype,
                                      attention_impl=attention_impl, **kw)
        self.modulation = Modulation(embedding_dim, inner_dim, n_chunks=3,
                                     dtype=stable_dtype(dtype, stable_conditioning), **kw)
        self.norm = LayerNormFP32(inner_dim, **kw)

    def forward(self, x, y, context, cos_sin_rope, attn_mask=None):
        b, s_ctx = x.shape[0], context.shape[1]
        latents = torch.cat([context, x], dim=1)
        kv_mask = None
        if attn_mask is not None:
            kv_mask = torch.cat([attn_mask.bool(), torch.ones((b, x.shape[1]), dtype=torch.bool, device=x.device)],
                                dim=1)
        alpha, beta, gamma = self.modulation(y)
        modulated = modulate(self.norm(latents), scale=alpha, shift=beta)
        latents = latents + (
            self.attention(modulated, cos_sin_rope=cos_sin_rope, attn_mask=kv_mask) + self.mlp(modulated)
        ) * gamma
        return latents[:, s_ctx:], latents[:, :s_ctx]


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


class PooledContextMlp(nn.Module):
    """Linear -> SiLU -> Linear pooled-context MLP (mmdit.py:388)."""

    def __init__(self, in_dim: int, dim: int, *, dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.fc1 = Linear(in_dim, dim * 2, **kw)
        self.fc2 = Linear(dim * 2, dim, **kw)

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


class PatchGridMixin:
    """Patchify / unpatchify, the RoPE position ids and the block call with
    ``use_checkpoint``, shared by the DiT-family denoisers (:class:`MMDiT`,
    SprintDiT, DDT). Needs ``conv_proj``, ``stream_dtype``, ``patch_size``,
    ``output_channels`` and ``use_checkpoint``."""

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

    def _image_pos_ids(self, batch: int, grid_size: tuple[int, int], n_axes: int, device) -> torch.Tensor:
        """(h, w) per image token; (0, h, w) with a text axis (mmdit.py:613)."""
        hp, wp = grid_size
        hh, ww = torch.meshgrid(torch.arange(hp, device=device), torch.arange(wp, device=device),
                                indexing="ij")
        axes = [hh.reshape(-1), ww.reshape(-1)]
        if n_axes == 3:
            axes = [torch.zeros_like(axes[0])] + axes
        pos = torch.stack(axes, dim=-1)
        return pos[None].expand(batch, hp * wp, n_axes)

    def _text_pos_ids(self, batch: int, seq_len: int, device) -> torch.Tensor:
        """(l, 0, 0) per text token, l from 1 (mmdit.py:622)."""
        zeros = torch.zeros((seq_len,), dtype=torch.long, device=device)
        pos = torch.stack([torch.arange(1, seq_len + 1, device=device), zeros, zeros], dim=-1)
        return pos[None].expand(batch, seq_len, 3)

    def _run_block(self, layer: nn.Module, *args):
        """One block; with ``use_checkpoint`` and under grad, recomputed in the
        backward instead of keeping its activations (mmdit.py:627-630)."""
        if self.use_checkpoint and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(layer, *args, use_reentrant=False)
        return layer(*args)


class MMDiT(PatchGridMixin, Denoiser):
    """DiT/MMDiT top-level model (mmdit.py:407).

    ``simple_dit=True``: class-conditional single-stream DiT (2-axis RoPE);
    ``simple_dit=False``: the multimodal MMDiT over ``[context; image]``
    (3-axis RoPE) with ``n_single_stream_blocks`` trailing fused blocks; it
    needs a ``context_embedder`` and reads ``cond["context"]``.

    The precision policy is the reference's: ``dtype`` is the compute dtype of
    the block matmuls (None = fp32); with ``stable_conditioning`` the
    conditioning path and the residual stream stay fp32 under a half
    ``dtype``; ``stream_dtype`` overrides the residual stream's dtype, and
    ``attention_dtype`` / ``mlp_dtype`` the attention's and the MLP's compute
    dtype in the DiT and dual-stream blocks.
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
        n_single_stream_blocks: int = 0,
        rope_base: int = 10_000,
        partial_rotary_factor: float = 1.0,
        rope_axes_dim: Sequence[int] | None = None,
        frequency_embedding: int = 256,
        n_classes: int | None = None,
        classifier_free: bool = False,
        context_embedder: ContextEmbedder | None = None,
        use_checkpoint: bool = False,
        attention_impl: str = "auto",
        mlp_type: str = "swiglu",
        n_experts: int = 8,
        capacity_factor: float = 2.0,
        pipeline_microbatches: int | None = None,
        augment_dim: int = 0,
        stable_conditioning: bool = True,
        attention_dtype: Any = None,
        mlp_dtype: Any = None,
        stream_dtype: Any = None,
        feature_layers: Sequence[int] = (),
        *,
        dtype: Any = None,
        param_dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        if n_classes is not None and context_embedder is not None:
            raise ValueError("n_classes and context_embedder cannot both be specified")
        if not simple_dit and context_embedder is None:
            raise ValueError("the multimodal MMDiT (simple_dit=False) needs a context embedder")
        if pipeline_microbatches is not None and not simple_dit:
            raise ValueError("pipeline_microbatches requires simple_dit=True (the dual/single-stream MMDiT stack "
                             "is heterogeneous and runs sequentially)")
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        # per-component precision overrides of the dual-stream / DiT blocks ("float32" accepted from YAML)
        attention_dtype = resolve_dtype(attention_dtype)
        mlp_dtype = resolve_dtype(mlp_dtype)
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
        self.use_checkpoint = use_checkpoint
        self.attention_impl = attention_impl
        #: GPipe microbatches of the DiT block stack over the mesh's "pipe" axis (None: in sequence)
        self.pipeline_microbatches = pipeline_microbatches
        self.mesh = None  # set by set_parallel_mesh
        #: 0-based block indices whose output a capturing forward returns (REPA)
        self.feature_layers = tuple(feature_layers)
        cond_dtype = stable_dtype(dtype, stable_conditioning)
        self.stream_dtype = stream_dtype if stream_dtype is not None else cond_dtype

        kw = dict(device=device, param_dtype=param_dtype)
        heads_dim = inner_dim // num_heads
        self.pooled_embedding = False
        self.context_embedder = self.mlp_pooled_context = self.context_embed = self.label_embed = None
        if simple_dit:
            if rope_axes_dim is None:
                d2 = int((partial_rotary_factor * heads_dim) // 2)
                d2 -= d2 % 2
                rope_axes_dim = [d2, d2]  # (H, W)
            self.label_embed = (LabelEmbed(n_classes, embedding_dim, classifier_free, dtype=cond_dtype, **kw)
                                if n_classes is not None else None)
            # every block is a single-stream DiT block already (mmdit.py:529-533)
            n_single_stream_blocks = 0
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
            if rope_axes_dim is None:
                d3 = int((partial_rotary_factor * heads_dim) // 3)
                d3 -= d3 % 2  # each axis dim must be even
                rope_axes_dim = [d3, d3, d3]  # (L text, H, W)
        # non-leaky augmentation conditioning (diffuse/augment.py): zero-init and
        # bias-free, so an absent label vector is exactly the zero-label path
        self.augment_embed = (Linear(augment_dim, embedding_dim, bias=False, dtype=dtype, zero_init=True, **kw)
                              if augment_dim > 0 else None)
        # the (lo, hi) block span of sampling-time block caching; None = off
        self.cache_span: tuple[int, int] | None = None
        self.rope_axes_dim = list(rope_axes_dim)
        self.last_layer = ModulatedLastLayer(embedding_dim, inner_dim, patch_size, self.output_channels,
                                             dtype=cond_dtype, **kw)
        self.time_embed = TimeEmbedMlp(frequency_embedding, embedding_dim, dtype=cond_dtype, **kw)
        self.conv_proj = PatchEmbed(self.input_channels, inner_dim, patch_size, dtype=cond_dtype, **kw)
        block_kw = dict(dtype=dtype, stable_conditioning=stable_conditioning, attention_impl=attention_impl, **kw)
        block_cls = DiTBlock if simple_dit else MMDiTBlock
        # the overrides reach the DiT / dual-stream blocks only, as in the reference (mmdit.py:566-575);
        # the MLP type the DiT blocks alone (the reference's MMDiTBlock takes and ignores it)
        moe_kw = dict(mlp_type=mlp_type, n_experts=n_experts, capacity_factor=capacity_factor) if simple_dit else {}
        self.layers = nn.ModuleList(
            [block_cls(inner_dim, embedding_dim, num_heads, mlp_ratio, self.rope_axes_dim,
                       attention_dtype=attention_dtype, mlp_dtype=mlp_dtype, **moe_kw, **block_kw)
             for _ in range(depth - n_single_stream_blocks)]
            + [MMDiTSingleStreamBlock(inner_dim, embedding_dim, num_heads, mlp_ratio, self.rope_axes_dim, **block_kw)
               for _ in range(n_single_stream_blocks)]
        )

    def set_parallel_mesh(self, mesh) -> None:
        """Give the blocks that shard at call time the mesh (mmdit.py:584):
        ring attention (``sp``), MoE MLPs (``expert``) and the pipelined
        block stack (``pipe``). The trainers call it; a mesh of one device
        is harmless."""
        self.mesh = mesh
        for block in self.layers:
            attn = getattr(block, "attention", None)
            if attn is not None and hasattr(attn, "mesh"):
                attn.mesh = mesh
            for attr in ("mlp_input", "mlp_context", "mlp"):
                mlp = getattr(block, attr, None)
                if isinstance(mlp, MoEMlp):
                    mlp.mesh = mesh

    # --- sampling-time block caching (Delta-DiT-style) -----------------------
    def set_block_cache_span(self, span: tuple[int, int] | None) -> None:
        """Set (or, with None, clear) the ``[lo, hi)`` block span whose combined
        residual delta is cached across denoise steps (mmdit.py:641)."""
        if span is None:
            self.cache_span = None
            return
        lo, hi = int(span[0]), int(span[1])
        if not 0 <= lo < hi <= len(self.layers):
            raise ValueError(f"cache span [{lo}, {hi}) out of range for depth {len(self.layers)}")
        self.cache_span = (lo, hi)

    def _cache_dtype(self) -> torch.dtype:
        return self.stream_dtype if self.stream_dtype is not None else torch.float32

    @torch.no_grad()
    def init_block_cache(self, data_shape, cond: dict[str, Any], use_cfg: bool) -> tuple[torch.Tensor, ...]:
        """Zero-filled block cache for the denoise loop (mmdit.py:654): one
        [B, tokens, inner_dim] delta per token stream, 2x-batched under fused
        CFG. The first step always refreshes, so the zeros are never read."""
        if self.cache_span is None:
            raise ValueError("call set_block_cache_span first")
        b = data_shape[0] * (2 if use_cfg else 1)
        t = (data_shape[1] // self.patch_size) * (data_shape[2] // self.patch_size)
        kw = dict(dtype=self._cache_dtype(), device=self.conv_proj.weight.device)
        x_delta = torch.zeros((b, t, self.inner_dim), **kw)
        if self.simple_dit:
            return (x_delta,)
        # the context length is the embedder's output length
        ctx = self.context_embedder(cond["context"], torch.zeros((data_shape[0],), dtype=torch.bool,
                                                                  device=kw["device"]))["embeddings"]
        return (x_delta, torch.zeros((b, ctx.shape[1], self.inner_dim), **kw))

    def _cached_block_stack(self, streams, run, block_cache, cache_refresh: bool):
        """The block stack with the ``cache_span`` segment computed and its
        delta stored (refresh: the streams pass through unchanged, bit-exact
        with the uncached stack) or skipped with the cached delta added
        (mmdit.py:678). Returns (streams, new_cache)."""
        lo, hi = self.cache_span
        dt = self._cache_dtype()
        for i in range(lo):
            streams = run(i, streams)
        if cache_refresh:
            s_in = streams
            for i in range(lo, hi):
                streams = run(i, streams)
            deltas = tuple(a.to(dt) - b.to(dt) for a, b in zip(streams, s_in))
        else:
            deltas = tuple(c.to(dt) for c in block_cache)
            streams = tuple(a + d.to(a.dtype) for a, d in zip(streams, deltas))
        for i in range(hi, len(self.layers)):
            streams = run(i, streams)
        return streams, deltas

    def _use_cache(self, block_cache, cache_refresh, capture_features: bool) -> bool:
        use = self.cache_span is not None and block_cache is not None and cache_refresh is not None
        if use and capture_features:
            raise ValueError("block caching is a sampling-time feature; feature capture (REPA) is a training-time "
                             "one: they don't compose")
        return use

    def _add_augment(self, emb, aug):
        if aug is None:
            return emb
        if self.augment_embed is None:
            raise ValueError("augment labels need augment_dim > 0")
        return emb + self.augment_embed(aug.to(emb.dtype))

    def _simple_dit_forward(self, x, grid_size, timesteps, y, drop, capture_features, aug=None, block_cache=None,
                            cache_refresh=None):
        emb = self.time_embed(timestep_embedding(timesteps, self.frequency_embedding).to(x.dtype))
        if self.label_embed is not None:
            if y is None:
                raise ValueError("class labels y required for label-conditional DiT")
            emb = emb + self.label_embed(y, drop if self.classifier_free else None)
        emb = self._add_augment(emb, aug)
        pos_ids = self._image_pos_ids(x.shape[0], grid_size, 2, x.device)
        cos_sin = get_cos_sin_ndim_grid(pos_ids, self.rope_base, self.rope_axes_dim)
        new_cache, features = None, []
        use_cache = self._use_cache(block_cache, cache_refresh, capture_features)
        pipe_n = mesh_shape(self.mesh)["pipe"]
        if self.pipeline_microbatches and pipe_n > 1 and not (capture_features or self.use_checkpoint or use_cache):
            x = self._pipelined_blocks(x, emb, cos_sin)
        elif use_cache:
            def run(i, s):
                return (self._run_block(self.layers[i], s[0], emb, cos_sin, None),)

            (x,), new_cache = self._cached_block_stack((x,), run, block_cache, cache_refresh)
        else:
            for i, layer in enumerate(self.layers):
                x = self._run_block(layer, x, emb, cos_sin, None)
                if capture_features and i in self.feature_layers:
                    features.append(x)
        return self.last_layer(x, emb), new_cache, features

    def _pipelined_blocks(self, x, emb, cos_sin):
        """The DiT block stack through the GPipe engine over the mesh's
        ``pipe`` axis (mmdit.py:821-860): the blocks' parameters stacked by
        layer, each stage applying ``layers[0]`` with a layer's slice swapped
        in; the conditioning and the RoPE tables ride the resident stream."""
        from torch.func import functional_call

        from diffulab_tpu_torch.parallel.pipeline import pipeline_apply, stack_block_params

        template = self.layers[0]

        def stage(layer_params, state):
            out = functional_call(template, layer_params, (state["x"], state["y"], (state["cos"], state["sin"])))
            return {**state, "x": out}

        cos, sin = cos_sin
        return pipeline_apply(stage, stack_block_params(self.layers), {"x": x}, mesh=self.mesh, axis="pipe",
                              n_microbatches=self.pipeline_microbatches,
                              stream={"y": emb, "cos": cos, "sin": sin})["x"]

    def _mmdit_forward(self, x, grid_size, timesteps, context_raw, drop, capture_features, aug=None,
                       block_cache=None, cache_refresh=None):
        b = x.shape[0]
        emb = self.time_embed(timestep_embedding(timesteps, self.frequency_embedding).to(x.dtype))
        emb = self._add_augment(emb, aug)
        context_output = self.context_embedder(context_raw, drop)
        if self.pooled_embedding:
            if "pooled_embeddings" not in context_output:
                raise ValueError("the context embedder gave no pooled embeddings")
            emb = self.mlp_pooled_context(context_output["pooled_embeddings"].to(x.dtype)) + emb
        context = self.context_embed(context_output["embeddings"].to(x.dtype))
        if self.stream_dtype is not None:
            context = context.to(self.stream_dtype)
        attn_mask = context_output.get("attn_mask")
        pos_ids = torch.cat([self._text_pos_ids(b, context.shape[1], x.device),
                             self._image_pos_ids(b, grid_size, 3, x.device)], dim=1)
        cos_sin = get_cos_sin_ndim_grid(pos_ids, self.rope_base, self.rope_axes_dim)
        new_cache, features = None, []
        if self._use_cache(block_cache, cache_refresh, capture_features):
            def run(i, s):
                return self._run_block(self.layers[i], s[0], emb, s[1], cos_sin, attn_mask)

            (x, context), new_cache = self._cached_block_stack((x, context), run, block_cache, cache_refresh)
        else:
            for i, layer in enumerate(self.layers):
                x, context = self._run_block(layer, x, emb, context, cos_sin, attn_mask)
                if capture_features and i in self.feature_layers:
                    features.append(x)
        return self.last_layer(x, emb), new_cache, features

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
        del train, generator  # nothing random in the forward
        cond = cond or {}
        if cond.get("context") is not None and cond.get("y") is not None:
            raise ValueError("context and y cannot both be specified")
        x_context = cond.get("x_context")
        if x_context is not None:
            x = torch.cat([x, x_context], dim=-1)  # NHWC channel concat
        aug = cond.get("augment_labels")
        extra = dict(aug=aug, block_cache=block_cache, cache_refresh=cache_refresh)
        tokens, grid_size = self.patchify(x)
        if self.simple_dit:
            out, new_cache, features = self._simple_dit_forward(tokens, grid_size, timesteps, cond.get("y"), drop,
                                                                capture_features, **extra)
        else:
            if cond.get("context") is None:
                raise ValueError("the multimodal MMDiT needs cond['context']")
            out, new_cache, features = self._mmdit_forward(tokens, grid_size, timesteps, cond["context"], drop,
                                                           capture_features, **extra)
        result: ModelOutput = {"x": self.unpatchify(out, grid_size)}
        if capture_features:
            result["features"] = features
        if new_cache is not None:
            result["block_cache"] = new_cache
        return result
