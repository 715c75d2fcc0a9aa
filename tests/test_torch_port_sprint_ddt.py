"""The port's SprintDiT and DDT against the JAX package's, in both modes
(class-conditional and multimodal over a precomputed context), at toy widths.

Every JAX parameter is seeded noise (trap T9), bridged by
``state_dict_from_jax``; both sides get the same numpy inputs, attention on
the plain route. SprintDiT's token drop takes the JAX draw: the JAX model
reads ``rngs.token_drop()``, the port the same scores as ``token_scores``
(trap T4). Cases: an eval forward with a mixed CFG drop mask (label or
context dropped; SprintDiT's path drop) and the captured features; a train
forward; ``x_context``; gradients of every parameter, SprintDiT's
``mask_token`` included; a 3-step Euler request with fused CFG; DDT's
per-token decoder conditioning; the full-width configs' parameter trees.

Tolerances, max |port - JAX| over max |JAX|: 1e-5 in fp32 (measured
2e-7-1.1e-6 on the CPU: summation order), 4e-2 under the mixed bf16 policy
(measured 7e-4-9e-3), as ``tests/test_torch_port_dit.py``; each gradient
within 1e-5 of its tensor's largest |JAX| value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import NULL_SEQ_LEN, _randomize, context_inputs, null_embedding, rel_err
from flax import nnx

from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.networks.denoisers.ddt import DDT as JaxDDT
from diffulab_tpu.networks.denoisers.sprint import SprintDiT as JaxSprint
from diffulab_tpu.networks.embedders.precomputed import PrecomputedEmbedder as JaxEmbedder
from diffulab_tpu_torch.config import compose_config
from diffulab_tpu_torch.config.instantiate import instantiate
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.examples.train_diffusion import CONFIG_DIR
from diffulab_tpu_torch.networks.denoisers import DDT, SprintDiT
from diffulab_tpu_torch.networks.embedders import PrecomputedEmbedder
from diffulab_tpu_torch.weights import state_dict_from_jax

TOL = {"fp32": 1e-5, "bf16": 4e-2}
DTYPES = {"fp32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}
B = 4
LATENT = (8, 8, 4)
#: the CFG drop mask of every forward: rows 1 and 3 take the null condition (and, in SprintDiT, path drop)
DROP = np.array([False, True, False, True])
#: (JAX class, port class, toy config): 8x8x4 inputs, 16 image tokens at patch 2, 64 at patch 1 (+ 8 text)
KINDS = {
    "sprint_simple": (JaxSprint, SprintDiT, dict(
        simple_dit=True, input_channels=4, inner_dim=64, embedding_dim=64, num_heads=4, mlp_ratio=2, patch_size=2,
        encoder_depth=1, deep_layers_depth=2, decoder_depth=1, n_classes=10, classifier_free=True,
        feature_layers=(0,))),
    "sprint_mm": (JaxSprint, SprintDiT, dict(
        simple_dit=False, input_channels=4, inner_dim=64, embedding_dim=64, num_heads=4, mlp_ratio=2, patch_size=1,
        encoder_depth=1, deep_layers_depth=2, n_single_stream_blocks=1, decoder_depth=1, rope_axes_dim=[4, 6, 6],
        classifier_free=True, feature_layers=(0,))),
    "ddt_simple": (JaxDDT, DDT, dict(
        simple_ddt=True, input_channels=4, inner_dim=64, num_heads=4, mlp_ratio=2, patch_size=2, encoder_depth=2,
        decoder_depth=1, n_classes=10, classifier_free=True, feature_layers=(1,))),
    "ddt_mm": (JaxDDT, DDT, dict(
        simple_ddt=False, input_channels=4, inner_dim=64, num_heads=4, mlp_ratio=2, patch_size=1, encoder_depth=2,
        n_single_stream_blocks=1, decoder_depth=2, rope_axes_dim=[4, 6, 6], classifier_free=True,
        feature_layers=(0,))),
}
SPRINTS = [k for k in KINDS if k.startswith("sprint")]
DDTS = [k for k in KINDS if k.startswith("ddt")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_PAIRS: dict = {}


def pair(kind: str, policy: str = "fp32", x_context: bool = False):
    """(JAX model, port model) of ``kind`` with the same seeded weights; with
    ``x_context``, 2 more input channels than output ones."""
    key = (kind, policy, x_context)
    if key not in _PAIRS:
        jax_cls, port_cls, cfg = KINDS[kind]
        if x_context:
            cfg = {**cfg, "input_channels": LATENT[2] + 2, "output_channels": LATENT[2]}
        jkw, tkw = {}, {}
        if kind.endswith("mm"):
            jkw["context_embedder"] = JaxEmbedder(null_embedding=null_embedding(), null_embedding_seq_len=NULL_SEQ_LEN)
            tkw["context_embedder"] = PrecomputedEmbedder(null_embedding=null_embedding(),
                                                          null_embedding_seq_len=NULL_SEQ_LEN, device="cpu")
        jdt, tdt = DTYPES[policy]
        jm = jax_cls(**cfg, **jkw, dtype=jdt, rngs=nnx.Rngs(0))
        params = _randomize(jm, 3)
        tm = port_cls(**cfg, **tkw, dtype=tdt, device="cpu")
        tm.load_state_dict(state_dict_from_jax(params, tm), strict=True)
        _PAIRS[key] = (jm, tm, params)
    return _PAIRS[key]


def inputs(kind: str, seed: int = 1, x_context: bool = False):
    """Seeded x, t and the conditioning on both sides (labels, or a ragged context)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, *LATENT)).astype(np.float32)
    t = rng.uniform(size=B).astype(np.float32)
    if kind.endswith("mm"):
        emb, mask = context_inputs(B)
        jc = {"context": {"embeddings": jnp.asarray(emb), "attn_mask": jnp.asarray(mask)}}
        tc = {"context": {"embeddings": torch.from_numpy(emb), "attn_mask": torch.from_numpy(mask)}}
    else:
        y = rng.integers(0, 10, B)
        jc, tc = {"y": jnp.asarray(y)}, {"y": torch.from_numpy(y)}
    if x_context:
        xc = rng.standard_normal((B, *LATENT[:2], 2)).astype(np.float32)
        jc, tc = {**jc, "x_context": jnp.asarray(xc)}, {**tc, "x_context": torch.from_numpy(xc)}
    return x, t, jc, tc


def image_tokens(kind: str) -> int:
    p = KINDS[kind][2]["patch_size"]
    return (LATENT[0] // p) * (LATENT[1] // p)


def jax_scores(key, kind: str) -> np.ndarray:
    """The scores the JAX SprintDiT draws from ``nnx.Rngs(token_drop=key)``."""
    return np.asarray(jax.random.uniform(nnx.Rngs(token_drop=key).token_drop(), (B, image_tokens(kind))))


def _jax_forward(jm, x, t, cond, drop, key=None):
    """The JAX model's output and features, jitted; a training forward with ``key``."""
    def fn(m, x, t, cond, drop, key):
        kw = {} if key is None else dict(train=True, rngs=nnx.Rngs(token_drop=key))
        out = m(x, t, cond, drop, capture_features=True, **kw)
        return out["x"], out["features"]
    return nnx.jit(fn)(jm, jnp.asarray(x), jnp.asarray(t), cond, jnp.asarray(drop), key)


def _port_forward(tm, x, t, cond, drop, scores=None):
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t), cond, torch.from_numpy(drop), capture_features=True,
                 **({} if scores is None else dict(train=True, token_scores=torch.from_numpy(scores))))
    return out["x"], out["features"]


def _check(ours, ref, tol):
    out, feats = ours
    ref_out, ref_feats = ref
    assert out.shape == ref_out.shape and torch.isfinite(out).all()
    assert rel_err(out.float().numpy(), np.asarray(ref_out, np.float32)) < tol
    assert len(feats) == len(ref_feats) == 1
    assert rel_err(feats[0].float().numpy(), np.asarray(ref_feats[0], np.float32)) < tol


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_bridge_loads_strict_with_every_key_consumed(kind):
    _, tm, params = pair(kind)
    sd = state_dict_from_jax(params, tm)
    assert len(sd) == len(params) and set(sd) == set(tm.state_dict())
    if kind.startswith("sprint"):
        np.testing.assert_array_equal(tm.mask_token.detach().numpy(), params["mask_token"])
        assert tm.mask_token.shape == (1, 1, 64)
    else:
        np.testing.assert_array_equal(tm.conv_proj_decoder.weight.detach().numpy(),
                                      params["conv_proj_decoder/kernel"].transpose(3, 2, 0, 1))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_eval_forward_matches_jax_in_bf16(kind):
    """Rows 1 and 3 take the null condition: in SprintDiT also the path drop
    (the fp32 eval forward: test_x_context_matches_jax, and the requests)."""
    jm, tm, _ = pair(kind, "bf16")
    x, t, jc, tc = inputs(kind)
    _check(_port_forward(tm, x, t, tc, DROP), _jax_forward(jm, x, t, jc, DROP), TOL["bf16"])


@pytest.mark.parametrize("policy", sorted(DTYPES))
@pytest.mark.parametrize("kind", SPRINTS)
def test_train_forward_with_the_jax_token_drop_matches_jax(kind, policy):
    jm, tm, _ = pair(kind, policy)
    x, t, jc, tc = inputs(kind, seed=2)
    key = jax.random.key(5)
    ours = _port_forward(tm, x, t, tc, DROP, scores=jax_scores(key, kind))
    _check(ours, _jax_forward(jm, x, t, jc, DROP, key), TOL[policy])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_x_context_matches_jax(kind):
    """The fp32 eval forward with 2 channels of ``x_context``, rows 1 and 3 dropped."""
    jm, tm, _ = pair(kind, x_context=True)
    x, t, jc, tc = inputs(kind, seed=3, x_context=True)
    ours = _port_forward(tm, x, t, tc, DROP)
    assert ours[0].shape == (B, *LATENT)
    _check(ours, _jax_forward(jm, x, t, jc, DROP), TOL["fp32"])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_gradients_match_jax(kind):
    """Every parameter's gradient of one squared error, SprintDiT in training
    (the JAX draw's kept tokens) with rows 1 and 3 path-dropped: its
    mask_token's gradient comes from the dropped tokens of rows 0 and 2 and
    from every token of rows 1 and 3."""
    jm, tm, _ = pair(kind)
    x, t, jc, tc = inputs(kind, seed=4)
    target = np.random.default_rng(5).standard_normal((B, *LATENT)).astype(np.float32)
    sprint = kind.startswith("sprint")
    key = jax.random.key(6)
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def jax_loss(p):
        m = nnx.merge(graphdef, p, rest)
        kw = dict(train=True, rngs=nnx.Rngs(token_drop=key)) if sprint else {}
        out = m(jnp.asarray(x), jnp.asarray(t), jc, jnp.asarray(DROP), **kw)["x"]
        return jnp.mean((out - target) ** 2)

    ref, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    tm.zero_grad(set_to_none=True)
    kw = dict(train=True, token_scores=torch.from_numpy(jax_scores(key, kind))) if sprint else {}
    out = tm(torch.from_numpy(x), torch.from_numpy(t), tc, torch.from_numpy(DROP), **kw)["x"]
    loss = ((out - torch.from_numpy(target)) ** 2).mean()
    loss.backward()
    assert abs(float(loss.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    flat = {"/".join(str(p) for p in path): np.asarray(v.get_value()) for path, v in ref_grads.flat_state()}
    grads = state_dict_from_jax(flat, tm)
    assert set(grads) == {name for name, _ in tm.named_parameters()}
    for name, param in tm.named_parameters():
        # the last multimodal decoder block's text-stream outputs reach no output: no gradient (JAX: zeros)
        grad = torch.zeros_like(param) if param.grad is None else param.grad
        err = float((grad - grads[name]).abs().max())
        assert err <= TOL["fp32"] * float(grads[name].abs().max()), (name, err)
    if sprint:
        assert float(grads["mask_token"].abs().max()) > 0
    tm.zero_grad(set_to_none=True)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cfg_request_matches_jax(kind):
    """A 3-step Euler request at CFG 1.5 as one 2x call a step: the null half
    drops the condition (SprintDiT: and the deep path)."""
    jm, tm, _ = pair(kind)
    x, _, jc, tc = inputs(kind, seed=7)
    jd, td = JaxDiffuser(jm, "euler", n_steps=3), Diffuser(tm, "euler", n_steps=3)
    ref = jd.generate(jax.random.key(8), jc, x=jnp.asarray(x), guidance_scale=1.5)["x"]
    out = td.generate(tc, x=torch.from_numpy(x), guidance_scale=1.5, device="cpu")["x"]
    assert out.shape == (B, *LATENT) and torch.isfinite(out).all()
    assert rel_err(out.numpy(), np.asarray(ref)) < TOL["fp32"]


# --- SprintDiT's token drop and path drop --------------------------------------------------------

@pytest.mark.parametrize("kind", SPRINTS)
def test_path_drop_replaces_the_deep_output_by_mask_tokens(kind):
    """What ``fuse`` takes as the restored deep output: rows 1 and 3
    (dropped) all mask tokens, in eval and in training, although no
    condition needs it (path drop is not tied to ``classifier_free``);
    rows 0 and 2 mask tokens exactly at the tokens the draw did not keep."""
    _, tm, _ = pair(kind)
    x, t, _, tc = inputs(kind, seed=9)
    s = image_tokens(kind)
    scores = torch.rand((B, s), generator=torch.Generator().manual_seed(0))
    kept = torch.topk(scores, tm.kept_tokens(s), dim=1).indices
    seen = []
    hook = tm.fuse.register_forward_hook(lambda m, args, out: seen.append(args[0][..., :64]))
    for kw in ({}, dict(train=True, token_scores=scores)):
        with torch.no_grad():
            tm(torch.from_numpy(x), torch.from_numpy(t), tc, torch.from_numpy(DROP), **kw)
    hook.remove()
    mask_token = tm.mask_token.detach()[0, 0]
    for restored, train in zip(seen, (False, True)):
        is_mask = (restored == mask_token).all(-1)
        assert bool(is_mask[1::2].all())
        want = torch.zeros((2, s), dtype=torch.bool)
        if train:
            want = torch.ones((2, s), dtype=torch.bool).scatter(1, kept[0::2], False)
        assert torch.equal(is_mask[0::2], want)


def test_drop_tokens_keeps_the_sorted_top_k_and_their_rope():
    _, tm, _ = pair("sprint_simple")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 8, generator=gen)
    cos_sin = (torch.randn(2, 16, 3, generator=gen), torch.randn(2, 16, 3, generator=gen))
    scores = torch.rand(2, 16, generator=gen)
    kept_x, kept, (cos, sin) = tm.drop_tokens(x, cos_sin, True, scores=scores)
    assert kept.shape == (2, 4) and bool((kept[:, 1:] > kept[:, :-1]).all())
    for b in range(2):
        want = sorted(np.argsort(-scores[b].numpy())[:4].tolist())
        assert kept[b].tolist() == want
        assert torch.equal(kept_x[b], x[b, want]) and torch.equal(cos[b], cos_sin[0][b, want])
        assert torch.equal(sin[b], cos_sin[1][b, want])
    # eval keeps everything; the txt2img config's 48x80 bucket keeps int(3840 * 0.25) tokens
    assert tm.drop_tokens(x, cos_sin, False)[1] is None
    assert tm.kept_tokens(3840) == 960 and tm.kept_tokens(4096) == 1024 and tm.kept_tokens(3) == 1
    with pytest.raises(ValueError, match="generator"):
        tm.drop_tokens(x, cos_sin, True)


def test_the_generator_decides_the_kept_tokens():
    """A training forward draws its scores from the generator it is given:
    one seed, one output; another seed, other kept tokens."""
    _, tm, _ = pair("sprint_simple")
    x, t, _, tc = inputs("sprint_simple", seed=10)

    def run(seed):
        with torch.no_grad():
            return tm(torch.from_numpy(x), torch.from_numpy(t), tc, train=True,
                      generator=torch.Generator().manual_seed(seed))["x"]

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))


def test_mask_token_gradient_needs_a_dropped_token():
    """With nothing dropped (eval, no drop mask) mask_token takes no
    gradient; a training forward gives it one."""
    _, tm, _ = pair("sprint_simple")
    x, t, _, tc = inputs("sprint_simple", seed=11)
    for kw, nonzero in (({}, False), (dict(train=True, generator=torch.Generator().manual_seed(0)), True)):
        tm.zero_grad(set_to_none=True)
        tm(torch.from_numpy(x), torch.from_numpy(t), tc, **kw)["x"].square().mean().backward()
        grad = tm.mask_token.grad
        assert (grad is not None and bool(grad.abs().max() > 0)) == nonzero
    tm.zero_grad(set_to_none=True)


# --- DDT's decoder ------------------------------------------------------------------------------

@pytest.mark.parametrize("kind", DDTS)
def test_ddt_decoder_is_conditioned_per_token(kind):
    """Each decoder block's and the last layer's adaLN input is
    silu(encoder output + time embedding), one vector a token."""
    _, tm, _ = pair(kind)
    x, t, _, tc = inputs(kind, seed=12)
    seen = {}
    hooks = [tm.layers[-1].register_forward_hook(lambda m, a, out: seen.__setitem__("enc", out)),
             tm.time_embed.register_forward_hook(lambda m, a, out: seen.__setitem__("t", out))]
    for i, block in enumerate([*tm.decoder_layers, tm.last_layer]):
        mod = block.modulation if hasattr(block, "modulation") else block.adaLN_modulation
        hooks.append(mod.register_forward_hook(lambda m, a, out, i=i: seen.__setitem__(i, a[0])))
    with torch.no_grad():
        tm(torch.from_numpy(x), torch.from_numpy(t), tc, torch.from_numpy(DROP))
    for h in hooks:
        h.remove()
    enc = seen["enc"] if kind == "ddt_simple" else seen["enc"][0]  # a dual-stream block gives (x, context)
    want = torch.nn.functional.silu(enc + seen["t"][:, None, :])
    s = image_tokens(kind)
    for i in range(len(tm.decoder_layers) + 1):
        assert seen[i].shape == (B, s, 64) and torch.equal(seen[i], want)
    assert float((want - want[:, :1]).abs().max()) > 0  # the tokens' vectors differ


# --- the full-width configs ----------------------------------------------------------------------

FULL = {
    "train_synthetic_flow_matching model=sprint": ("train_synthetic_flow_matching", ["model=sprint"]),
    "train_synthetic_flow_matching model=ddt": ("train_synthetic_flow_matching", ["model=ddt"]),
    "train_hard_txt2img_sprint": ("train_hard_txt2img_sprint", []),
    "train_hard_txt2img_ddt": ("train_hard_txt2img_ddt", []),
    "train_imagenet_repa_txt_to_img_sprint": ("train_imagenet_repa_txt_to_img_sprint", []),
    "train_cifar10_moe": ("train_cifar10_moe", []),
}


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_models_have_the_jax_parameter_tree(name):
    """Each config's model block, built abstractly in JAX and on the meta
    device in the port: the same parameters, bridged, of the same shapes.
    The hard DDT config carries ``simple_dit: false`` from its MMDiT
    sibling, which neither DDT takes: dropped here (phase 21 builds it so).
    ``train_cifar10_moe`` is the MoE DiT of ``model=dit_moe`` (slice P1)."""
    from diffulab_tpu.networks.denoisers.mmdit import MMDiT as JaxMMDiT
    from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT

    config, overrides = FULL[name]
    cfg = compose_config(CONFIG_DIR, config, overrides)["model"]
    kwargs = {k: v for k, v in cfg.items() if k != "_target_" and not (k == "simple_dit" and "ddt" in cfg["_target_"])}
    simple = kwargs.get("simple_dit", kwargs.get("simple_ddt"))
    jax_cls = {"sprint": JaxSprint, "ddt": JaxDDT, "mmdit": JaxMMDiT}[cfg["_target_"].split(".")[-2]]
    jkw, tkw = {}, {}
    if not simple:
        null = np.zeros((8, 512), np.float32)
        jkw["context_embedder"] = JaxEmbedder(null_embedding=null)
        tkw["context_embedder"] = PrecomputedEmbedder(null_embedding=null, device="cpu")
    jm = nnx.eval_shape(lambda: jax_cls(**kwargs, **jkw, rngs=nnx.Rngs(0)))
    shapes = {"/".join(str(p) for p in path): np.zeros(np.shape(v.get_value()), np.float32)
              for path, v in nnx.state(jm, nnx.Param).flat_state()}
    tm = instantiate({**kwargs, "_target_": cfg["_target_"]}, device="meta", **tkw)
    assert type(tm) is {JaxSprint: SprintDiT, JaxDDT: DDT, JaxMMDiT: MMDiT}[jax_cls]
    bridged = {k: tuple(v.shape) for k, v in state_dict_from_jax(shapes, tm).items()}
    assert bridged == {k: tuple(v.shape) for k, v in tm.state_dict().items()}
