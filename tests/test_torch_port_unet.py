"""The port's ADM UNet (diffulab_tpu_torch.networks.denoisers.unet) and the
nn.py primitives it uses, against the JAX package on the CPU in fp32.

Every module is built on both sides with the same arguments, its JAX
parameters overwritten by seeded noise (the out convs are zero-initialised,
trap T9) and bridged by ``state_dict_from_jax(params, module)``, which keeps
GroupNorm's ``scale`` name (trap T16). Outputs are held to atol 1e-5 + rtol
1e-5: GroupNorm32, Upsample, Downsample (conv and average pool), ResBlock
(scale-shift and additive FiLM, down and up, 1x1 skip), AttentionBlock (self
and cross with a key mask), the GEGLU feed-forward (tanh GELU, trap T2), the
context TransformerBlock, and a 2-level UNet (model_channels 32: the JAX
GroupNorm32 needs the decoder's concatenated widths divisible by 32) with
attention at both levels, its gradients within 1e-4 of each parameter's
largest (or of a hundredth of the model's largest, for a gradient of
rounding noise), and its DeepCache
forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import _randomize
from flax import nnx

import diffulab_tpu.networks.denoisers.unet as jax_unet
import diffulab_tpu.networks.nn as jax_nn
import diffulab_tpu_torch.networks.denoisers.unet as port_unet
import diffulab_tpu_torch.networks.nn as port_nn
from diffulab_tpu_torch.weights import state_dict_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
#: 2 levels of 32 / 64 channels on 16x16 images, attention at ds 1 and 2 (head dims 16 and 32)
UNET = dict(image_size=[16, 16], in_channels=3, model_channels=32, out_channels=3, num_res_blocks=1,
            attention_resolutions=[1, 2], channel_mult="1, 2", num_heads=2, resblock_updown=True,
            use_scale_shift_norm=True, n_classes=10, classifier_free=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(jax_cls, port_cls, *args, seed=0, **kwargs):
    """The JAX module (parameters randomised) and its port twin with the bridged weights."""
    jax_module = jax_cls(*args, **kwargs, rngs=nnx.Rngs(0))
    params = _randomize(jax_module, seed)
    port = port_cls(*args, **kwargs)
    port.load_state_dict(state_dict_from_jax(params, port), strict=True)
    return jax_module, port


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _check(ours, ref):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(ref, np.float32), **TOL)


@pytest.mark.parametrize("channels", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm32_matches_jax(channels, dtype):
    jm, tm = _pair(jax_nn.GroupNorm32, port_nn.GroupNorm32, 32, channels)
    x = _x((2, 4, 4, channels))
    tdt, jdt = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    ours, ref = tm(torch.from_numpy(x).to(tdt)), jm(jnp.asarray(x, jdt))
    assert ours.dtype == tdt and tm.norm.num_groups == min(32, channels) and tm.norm.eps == 1e-5
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(ref, np.float32),
                               **(TOL if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)))


@pytest.mark.parametrize("use_conv", [True, False])
def test_upsample_matches_jax(use_conv):
    jm, tm = _pair(jax_nn.Upsample, port_nn.Upsample, 8, use_conv, 16 if use_conv else None)
    x = _x((2, 4, 4, 8))
    _check(tm(torch.from_numpy(x)), jm(jnp.asarray(x)))


@pytest.mark.parametrize("use_conv", [True, False])
def test_downsample_matches_jax(use_conv):
    jm, tm = _pair(jax_nn.Downsample, port_nn.Downsample, 8, use_conv, 16 if use_conv else None)
    x = _x((2, 8, 6, 8))
    out = tm(torch.from_numpy(x))
    assert out.shape == (2, 4, 3, 16 if use_conv else 8)
    _check(out, jm(jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["scale_shift", "additive", "down", "up", "skip_1x1", "skip_3x3"])
def test_resblock_matches_jax(kind):
    kwargs = dict(use_scale_shift_norm=kind != "additive", down=kind == "down", up=kind == "up",
                  use_conv=kind == "skip_3x3")
    out_ch = 64 if kind.startswith("skip") else 32
    jm, tm = _pair(jax_unet.ResBlock, port_unet.ResBlock, 32, 48, 0.0, out_ch, **kwargs)
    x, emb = _x((2, 8, 8, 32)), _x((2, 48), seed=2)
    out = tm(torch.from_numpy(x), torch.from_numpy(emb))
    side = {"down": 4, "up": 16}.get(kind, 8)
    assert out.shape == (2, side, side, out_ch)
    _check(out, jm(jnp.asarray(x), jnp.asarray(emb)))


@pytest.mark.parametrize("cross", [False, True])
def test_attention_block_matches_jax(cross):
    ctx_ch = 24 if cross else None
    jm, tm = _pair(jax_unet.AttentionBlock, port_unet.AttentionBlock, 32, ctx_ch, 2)
    x = _x((2, 4, 4, 32))
    args_j, args_t = {}, {}
    if cross:
        ctx = _x((2, 8, 24), seed=3)
        mask = np.arange(8)[None, :] < np.asarray([8, 3])[:, None]
        args_j = dict(context=jnp.asarray(ctx), attn_mask=jnp.asarray(mask))
        args_t = dict(context=torch.from_numpy(ctx), attn_mask=torch.from_numpy(mask))
    assert tm.dim_head == 16
    _check(tm(torch.from_numpy(x), **args_t), jm(jnp.asarray(x), **args_j))


def test_transformer_block_with_geglu_matches_jax():
    jm, tm = _pair(jax_unet.TransformerBlock, port_unet.TransformerBlock, 32, 24, 2, depth=2)
    x, ctx = _x((2, 4, 4, 32)), _x((2, 8, 24), seed=3)
    mask = np.arange(8)[None, :] < np.asarray([8, 5])[:, None]
    _check(tm(torch.from_numpy(x), torch.from_numpy(ctx), torch.from_numpy(mask)),
           jm(jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(mask)))


def test_geglu_is_the_tanh_gelu_and_the_small_primitives_match():
    x = _x((3, 10), seed=4) * 3
    _check(port_nn.geglu(torch.from_numpy(x)), jax_nn.geglu(jnp.asarray(x)))
    exact = torch.nn.functional.gelu(torch.from_numpy(x[:, 5:]), approximate="none") * torch.from_numpy(x[:, :5])
    assert (port_nn.geglu(torch.from_numpy(x)) - exact).abs().max() > 1e-4  # not the exact GELU (trap T2)
    jm, tm = _pair(jax_nn.TimestepEmbedder, port_nn.TimestepEmbedder, 32, 16)
    t = np.array([0.0, 3.5, 999.0], np.float32)
    _check(tm(torch.from_numpy(t)), jm(jnp.asarray(t)))
    assert port_nn.accum_dtype_kwargs(torch.bfloat16) == {} and port_nn.accum_dtype_kwargs(None) == {}
    zc, zl = port_nn.zero_conv(4, 8, 3), port_nn.zero_linear(4, 8)
    assert not zc.weight.any() and not zc.bias.any() and zc.padding == 1 and not zl.weight.any()
    assert port_nn.normalization(64).norm.num_groups == 32


@pytest.fixture(scope="module")
def unet_pair():
    jm = jax_unet.UNetModel(**UNET, rngs=nnx.Rngs(0))
    params = _randomize(jm, 7)
    tm = port_unet.UNetModel(**UNET, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, tm), strict=True)
    return jm, tm, params


def _unet_inputs(b=3):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((b, 16, 16, 3)).astype(np.float32)
    t = np.array([0, 431, 999][:b], np.int32)
    return x, t, rng.integers(0, 10, b), np.array([False, True, False][:b])


def test_unet_bridge_keeps_group_norm_scale_names(unet_pair):
    _, tm, params = unet_pair
    assert any(k.endswith("in_norm/norm/scale") for k in params)
    sd = state_dict_from_jax(params, tm)
    assert "input_blocks.1.0.in_norm.norm.scale" in sd and "input_blocks.0.0.weight" in sd
    assert sd["input_blocks.0.0.weight"].shape == (32, 3, 3, 3)  # HWIO -> OIHW
    # without the module the name alone reads a GroupNorm's norm/scale as a LayerNorm's (trap T16)
    with pytest.raises(RuntimeError, match="norm.weight"):
        port_unet.UNetModel(**UNET, device="cpu").load_state_dict(state_dict_from_jax(params), strict=True)


def test_unet_forward_matches_jax(unet_pair):
    jm, tm, _ = unet_pair
    x, t, y, drop = _unet_inputs()
    ref = jm(jnp.asarray(x), jnp.asarray(t), {"y": jnp.asarray(y)}, jnp.asarray(drop))["x"]
    out = tm(torch.from_numpy(x), torch.from_numpy(t), {"y": torch.from_numpy(y)}, torch.from_numpy(drop))["x"]
    assert out.shape == (3, 16, 16, 3)
    _check(out, ref)


def test_unet_gradients_match_jax(unet_pair):
    jm, tm, _ = unet_pair
    x, t, y, drop = _unet_inputs(2)
    w = _x((2, 16, 16, 3), seed=9)
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def loss(p):
        out = nnx.merge(graphdef, p, rest)(jnp.asarray(x), jnp.asarray(t), {"y": jnp.asarray(y)}, jnp.asarray(drop))
        return jnp.sum(out["x"] * jnp.asarray(w))

    ref_grads = jax.grad(loss)(params)
    tm.zero_grad(set_to_none=True)
    torch.sum(tm(torch.from_numpy(x), torch.from_numpy(t), {"y": torch.from_numpy(y)},
                 torch.from_numpy(drop))["x"] * torch.from_numpy(w)).backward()
    flat = {"/".join(str(p) for p in path): np.asarray(v.get_value()) for path, v in ref_grads.flat_state()}
    live = dict(tm.named_parameters())
    ref = state_dict_from_jax(flat, tm)
    # a conv bias right before a GroupNorm of one channel a group has a gradient of rounding
    # noise only (the norm removes it): such a gradient is held to the model's gradient scale
    floor = 1e-2 * max(float(g.abs().max()) for g in ref.values())
    for name, g in ref.items():
        ours = live[name].grad
        assert ours is not None, name
        err = float((ours - g).abs().max())
        assert err <= 1e-4 * max(float(g.abs().max()), floor), (name, err)


@pytest.mark.parametrize("split", [1, 3])
def test_unet_deepcache_forward_matches_jax(unet_pair, split):
    jm, tm, _ = unet_pair
    x, t, y, drop = _unet_inputs(2)
    n = len(tm.input_blocks)
    for m in (jm, tm):
        m.set_block_cache_span((split, n))
    try:
        cache_j = jm.init_block_cache((2, 16, 16, 3), {}, False)
        cache_t = tm.init_block_cache((2, 16, 16, 3), {}, False)
        assert cache_t[0].shape == cache_j[0].shape
        args_j = (jnp.asarray(x), jnp.asarray(t), {"y": jnp.asarray(y)}, jnp.asarray(drop))
        args_t = (torch.from_numpy(x), torch.from_numpy(t), {"y": torch.from_numpy(y)}, torch.from_numpy(drop))
        ref = jm(*args_j, block_cache=cache_j, cache_refresh=True)
        out = tm(*args_t, block_cache=cache_t, cache_refresh=True)
        _check(out["x"], ref["x"])
        _check(out["block_cache"][0], ref["block_cache"][0])
        # a refresh is the uncached forward exactly; a reuse step splices the cached deep feature in
        torch.testing.assert_close(out["x"], tm(*args_t)["x"], rtol=0, atol=0)
        x2 = _x((2, 16, 16, 3), seed=10)
        reuse_j = jm(jnp.asarray(x2), *args_j[1:], block_cache=ref["block_cache"], cache_refresh=False)
        reuse_t = tm(torch.from_numpy(x2), *args_t[1:], block_cache=out["block_cache"], cache_refresh=False)
        _check(reuse_t["x"], reuse_j["x"])
        torch.testing.assert_close(reuse_t["block_cache"][0], out["block_cache"][0], rtol=0, atol=0)
    finally:
        for m in (jm, tm):
            m.set_block_cache_span(None)
    with pytest.raises(ValueError, match="reach the U bottom"):
        tm.set_block_cache_span((1, n - 1))
