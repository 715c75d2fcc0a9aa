"""The K1 and K2 instances built around the valid rows at head dim 64, which
take the DiTs' short sequences that the fused route pads (64 or 72 tokens to
128 keys, 264 to 384), emulated on the CPU at their designs' arithmetic and
tiles, fp32 and bf16, against the JAX kernels run in interpret mode; the
route's rule that picks them; and three tiny models that attend there
against the JAX package.

The instances take the unpadded q, do and lse rows, while k, v and the key
mask stay padded (``takes_valid_rows``: at D = 64 where Sq is not a multiple
of 128). One column group holds the whole head (``f32_groups(64) == 1``).
fp32: 3xTF32 products (``matmul_3xtf32``), K1 an online softmax over tiles
of ``f32_keys(64, valid_rows=True)`` = 32 keys, K2's dq kernel forming s and
dp again for dq (``kept=False``). bf16: ``mma.sync`` m16n8k16 over tiles of
``bf16_keys(64, valid_rows=True)`` = 64 keys, K1 in two passes (m and l over
the whole row, then ``p = exp(s - m) / l`` rounded to bf16 before PV), K2
rounding p before dv and ds before dq and dk, di from the fp32 p. A key tile
whose mask is all 0 is skipped by the kernels, which changes no value, so
the emulations walk every tile (a masked key inside a live tile gets the
mask value, its p exactly 0: the 16-key hole below is such keys). The
JAX kernels take the reference's padded q (its ``_fused_path``): the rows
are independent, so the valid rows are compared. Cases: 64 and 72 tokens
padded to 128 keys with the padding mask; 264 to 384 with a caption-style
key mask (row 0 with an all-0 16-key tile between live ones, row 1 fully
masked: o = 0, lse = +inf and zero gradients there, row 2 a ragged caption
before its image keys); no mask with a ragged Sq of 37 over 128 keys.

Tolerances: bf16 those of ``tests/test_torch_port_d3_tiles.py`` (o within
atol 1e-2 + rtol 1e-2, lse within atol 1e-4 + rtol 1e-5, each gradient
within 1e-2·(max|ref| + |ref|)), and K1's o bitwise its plain version's on
at least 99% of its elements; fp32 the tighter ones of
``tests/test_torch_port_fp32_tiles.py`` (o 2e-5 + 2e-5, lse 1e-4 + 1e-5,
gradients 2e-5·(max|ref| + |ref|)). The models, in fp32, within the
tolerances of their own parity tests: a forward within 1e-5 of the JAX
output's largest value, gradients within 1e-4 of each tensor's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import _randomize, rel_err
from flax import nnx

import diffulab_tpu_torch.ops.attention as attention
from diffulab_tpu.networks.denoisers.mmdit import MMDiT as JaxMMDiT
from diffulab_tpu.networks.denoisers.sprint import SprintDiT as JaxSprint
from diffulab_tpu.networks.embedders.trainable import TrainableTextEmbedder as JaxEmbedder
from diffulab_tpu.ops.fused_mha import _mha_backward, _mha_forward
from diffulab_tpu_torch.networks.denoisers import SprintDiT
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.networks.embedders import TrainableTextEmbedder, byte_tokenize
from diffulab_tpu_torch.ops import dot_product_attention
from diffulab_tpu_torch.ops.fused_mha import (
    BF16_KEPT_TILES,
    MIN_BLOCK,
    SHORT_ROWS_MAX_SQ,
    bf16_keys,
    f32_groups,
    f32_keys,
    fused_mha,
    fused_mha_bf16_valid_emulation,
    fused_mha_bwd_bf16_valid_emulation,
    fused_mha_bwd_reference,
    fused_mha_bwd_tf32x3_emulation,
    fused_mha_reference,
    fused_mha_tf32x3_emulation,
    route_takes_valid_rows,
    takes_valid_rows,
)
from diffulab_tpu_torch.weights import state_dict_from_jax

TOLS = {"fp32": ((2e-5, 2e-5), (1e-4, 1e-5), 2e-5), "bf16": ((1e-2, 1e-2), (1e-4, 1e-5), 1e-2)}
D = 64

#: (valid query rows Sq, padded keys, mask kind)
CASES = {
    "sq64_padded": (64, 128, "padded"),
    "sq72_padded": (72, 128, "padded"),
    "sq264_caption_hole_and_dead_row": (264, 384, "caption"),
    "sq37_unmasked": (37, 128, None),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mask(kind, sq, b, skv):
    """The padding mask (the first sq keys), or ``caption``: row 0 with keys
    16-31 masked and as many valid keys after them (an all-0 16-key tile
    between live ones), row 1 fully masked, row 2 five of 8 caption keys and
    then its sq - 8 image keys."""
    if kind is None:
        return None
    keys = np.arange(skv)
    mask = np.repeat((keys < sq)[None], b, axis=0)
    if kind == "caption":
        mask[0] = (keys < 16) | ((keys >= 32) & (keys < sq + 16))
        mask[1] = False
        mask[2] = (keys < 5) | ((keys >= 8) & (keys < sq))
    return mask


def _inputs(case, dtype):
    sq, skv, kind = CASES[case]
    rng = np.random.default_rng(sq + skv + len(case))
    b, h = 3, 2
    q, do = (rng.standard_normal((b, sq, h, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, skv, h, D)).astype(np.float32) for _ in range(2))
    tensors = [torch.from_numpy(a) for a in (q, k, v, do)]
    if dtype == "bf16":  # drawn in the kernel's dtype: both sides see the same bf16 values
        tensors = [t.bfloat16() for t in tensors]
        q, k, v, do = (t.float().numpy() for t in tensors)
    return (q, k, v, do), tensors, _mask(kind, sq, b, skv), D ** -0.5


def _jnp(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _pad_rows(x, rows):
    return np.pad(x, ((0, 0), (0, rows - x.shape[1])) + ((0, 0),) * (x.ndim - 2))


def _close(ours, ref, atol, rtol, label):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    finite = np.isfinite(ref)
    assert np.array_equal(np.isfinite(ours), finite), f"{label}: non-finite values differ"
    err = np.abs(ours[finite] - ref[finite])
    assert np.all(err <= atol + rtol * np.abs(ref[finite])), f"{label}: max err {err.max():.3e}"


def _within(ours, ref, tol, label):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    bound = tol * (np.abs(ref).max() + np.abs(ref))
    assert np.all(np.abs(ours - ref) <= bound), f"{label}: max err {np.abs(ours - ref).max():.3e}"


def _jax_forward(q, k, v, mask, scale, dtype):
    """The interpret-mode K1 on the reference's padded q, cut to the valid rows."""
    jmask = None if mask is None else jnp.asarray(mask)
    o, lse = _mha_forward(_jnp(_pad_rows(q, k.shape[1]), dtype), _jnp(k, dtype), _jnp(v, dtype), jmask, scale, True)
    sq = q.shape[1]
    return np.asarray(o.astype(jnp.float32))[:, :sq], np.asarray(lse)[:, :sq], lse


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_k1_valid_rows_tiles_at_d64_match_the_jax_kernel(case, dtype):
    (q, k, v, _), (tq, tk, tv, _), mask, scale = _inputs(case, dtype)
    assert takes_valid_rows(q.shape[1], D)
    o_tol, lse_tol, _ = TOLS[dtype]
    jo, jlse, _ = _jax_forward(q, k, v, mask, scale, dtype)
    tmask = None if mask is None else torch.from_numpy(mask)
    emulation = fused_mha_bf16_valid_emulation if dtype == "bf16" else fused_mha_tf32x3_emulation
    o, lse = emulation(tq, tk, tv, tmask, scale)
    assert o.dtype == tq.dtype and o.shape == tq.shape and lse.shape == tq.shape[:3]
    _close(o.float().numpy(), jo, *o_tol, "o vs JAX")
    _close(lse.numpy(), jlse, *lse_tol, "lse vs JAX")
    ro, rlse = fused_mha_reference(tq, tk, tv, tmask, scale)
    _close(o.float().numpy(), ro.float().numpy(), *o_tol, "o vs plain")
    _close(lse.numpy(), rlse.numpy(), *lse_tol, "lse vs plain")
    if dtype == "bf16":  # p normalised, then rounded, before PV: o bitwise the plain version's almost everywhere
        assert float((o == ro).float().mean()) >= 0.99
    if CASES[case][2] == "caption":  # the fully masked row: o = 0, lse = +inf
        assert (o[1] == 0).all() and torch.isinf(lse[1]).all() and (lse[1] > 0).all()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_k2_valid_rows_split_at_d64_matches_the_jax_kernel(case, dtype):
    (q, k, v, do), (tq, tk, tv, tdo), mask, scale = _inputs(case, dtype)
    sq, skv = q.shape[1], k.shape[1]
    _, _, grad_tol = TOLS[dtype]
    _, _, jlse = _jax_forward(q, k, v, mask, scale, dtype)
    jmask = None if mask is None else jnp.asarray(mask)
    jgrads = _mha_backward(_jnp(_pad_rows(q, skv), dtype), _jnp(k, dtype), _jnp(v, dtype), jmask, jlse,
                           _jnp(_pad_rows(do, skv), dtype), scale, True)
    jdq, jdk, jdv = (np.asarray(g.astype(jnp.float32)) for g in jgrads)
    tmask = None if mask is None else torch.from_numpy(mask)
    lse = torch.from_numpy(np.array(jlse)[:, :sq])
    if dtype == "bf16":
        *grads, _ = fused_mha_bwd_bf16_valid_emulation(tq, tk, tv, tmask, lse, tdo, scale)
    else:
        *grads, _ = fused_mha_bwd_tf32x3_emulation(tq, tk, tv, tmask, lse, tdo, scale, kept=False)
    assert all(g.dtype == tq.dtype for g in grads)
    plain = fused_mha_bwd_reference(tq, tk, tv, tmask, lse, tdo, scale)
    for label, g, r, pr in zip(("dq", "dk", "dv"), grads, (jdq[:, :sq], jdk, jdv), plain):
        _within(g.float().numpy(), r, grad_tol, f"{label} vs JAX")
        _within(g.float().numpy(), pr.float().numpy(), grad_tol, f"{label} vs plain")
    if mask is not None:  # masked keys, and every key of a fully masked row, get exactly zero dk and dv
        dead = ~torch.from_numpy(mask)
        assert all((g[dead] == 0).all() for g in grads[1:])
    if CASES[case][2] == "caption":
        assert (grads[0][1] == 0).all()


def test_the_d64_valid_rows_tile_rules():
    # 32-key tiles in fp32 and 64-key ones in bf16, one column group, 1 live tile (a 64-token row) kept between
    # bf16 K1's passes; the padded instances keep theirs (32-key fp32 slots, no bf16 tiles)
    assert (f32_keys(D, valid_rows=True), bf16_keys(D, valid_rows=True), f32_groups(D), BF16_KEPT_TILES) \
        == (32, 64, 1, 1)
    assert (f32_keys(D), bf16_keys(D)) == (32, 0)
    assert [takes_valid_rows(sq, D) for sq in (64, 72, 264, 37, 128, 256, 384)] == [True] * 4 + [False] * 3
    assert not any(takes_valid_rows(72, d) for d in (16, 32, 128))


def _recording(monkeypatch):
    calls = []

    def record(q, k, v, mask, scale):
        calls.append((q.shape[1], k.shape[1]))
        return fused_mha(q, k, v, mask, scale)

    monkeypatch.setattr(attention, "fused_mha", record)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d,sq", [(64, 64), (64, 72), (64, 264), (64, 256), (64, 384), (128, 72), (32, 264)])
def test_the_route_hands_the_unpadded_rows_at_d64_where_sq_is_not_whole_blocks(monkeypatch, d, sq, dtype):
    """At D = 64 the route hands the kernels the unpadded q where Sq is not a
    whole number of 128-row blocks and at most ``SHORT_ROWS_MAX_SQ`` rows in
    the dtype (the measured crossover), else the padded one; k, v and the
    mask are padded either way; other head dims pad q as before."""
    rng = np.random.default_rng(sq + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, sq, 2, d)).astype(np.float32)).to(dtype) for _ in range(3))
    calls = _recording(monkeypatch)
    out = dot_product_attention(q, k, v)
    padded = -(-sq // MIN_BLOCK) * MIN_BLOCK
    unpadded = d == 64 and sq % MIN_BLOCK != 0 and sq <= SHORT_ROWS_MAX_SQ[dtype]
    assert route_takes_valid_rows(sq, d, dtype) == unpadded
    assert takes_valid_rows(sq, d) == (d == 64 and sq % MIN_BLOCK != 0)
    assert calls == [(sq if unpadded else padded, padded)]
    # the rows are independent: the same o as the padded route
    pad = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, padded - sq)) for t in (q, k, v)]
    ref = fused_mha_reference(*pad, torch.arange(padded)[None].expand(2, -1) < sq)[0][:, :sq]
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


# --- three models that attend at D = 64 on short sequences, against the JAX package ------------------

#: a SprintDiT and a class-conditional DiT (G1's patch 1 on 8x8 latents: 64 tokens) at 2 heads of 64
SPRINT = dict(simple_dit=True, input_channels=4, inner_dim=128, embedding_dim=128, num_heads=2, mlp_ratio=2,
              patch_size=1, encoder_depth=1, deep_layers_depth=1, decoder_depth=1, n_classes=10,
              classifier_free=True)
DIT = dict(simple_dit=True, input_channels=4, inner_dim=128, embedding_dim=128, num_heads=2, mlp_ratio=2,
           patch_size=1, depth=2, n_classes=10, classifier_free=True)
#: the trainable embedder at 2 heads of 64 over 64 byte tokens
EMB = dict(dim=128, depth=1, num_heads=2, max_len=64)
LATENT = (8, 8, 4)
B = 4
DROP = np.array([False, True, False, False])


def _flat(tree) -> dict[str, np.ndarray]:
    return {"/".join(str(p) for p in path): np.asarray(v.get_value(), np.float32) for path, v in tree.flat_state()}


def _model_pair(kind: str):
    jax_cls, port_cls, cfg = {"sprint": (JaxSprint, SprintDiT, SPRINT), "dit": (JaxMMDiT, MMDiT, DIT),
                              "embedder": (JaxEmbedder, TrainableTextEmbedder, EMB)}[kind]
    jm = jax_cls(**cfg, rngs=nnx.Rngs(0))
    params = _randomize(jm, 11)
    tm = port_cls(**cfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, tm), strict=True)
    return jm, tm


def _model_inputs(kind: str):
    rng = np.random.default_rng(12)
    if kind == "embedder":
        captions = ["a red square on a grey field", "", "two blue rings and a small yellow star", "ok"]
        tokens = byte_tokenize(captions, EMB["max_len"])
        return ({k: jnp.asarray(v) for k, v in tokens.items()}, jnp.asarray(DROP)), \
            ({k: torch.from_numpy(v) for k, v in tokens.items()}, torch.from_numpy(DROP))
    x = rng.standard_normal((B, *LATENT)).astype(np.float32)
    t = rng.uniform(size=B).astype(np.float32)
    y = rng.integers(0, 10, B)
    return (jnp.asarray(x), jnp.asarray(t), {"y": jnp.asarray(y)}, jnp.asarray(DROP)), \
        (torch.from_numpy(x), torch.from_numpy(t), {"y": torch.from_numpy(y)}, torch.from_numpy(DROP))


@pytest.mark.parametrize("kind", ["sprint", "dit", "embedder"])
def test_models_at_d64_short_sequences_match_jax(monkeypatch, kind):
    """The output and every parameter's gradient of a weighted sum of it
    (SprintDiT in training with the JAX draw's kept tokens), the port's
    attention through the route, which hands the kernels the unpadded rows."""
    jm, tm = _model_pair(kind)
    jargs, targs = _model_inputs(kind)
    key = jax.random.key(13)
    sprint = kind == "sprint"
    out_key = "embeddings" if kind == "embedder" else "x"
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def jax_out(p):
        m = nnx.merge(graphdef, p, rest)
        kw = dict(train=True, rngs=nnx.Rngs(token_drop=key)) if sprint else {}
        return m(*jargs, **kw)[out_key]

    ref = np.asarray(jax.jit(jax_out)(params))
    weights = np.random.default_rng(14).standard_normal(ref.shape).astype(np.float32)
    ref_grads = state_dict_from_jax(_flat(jax.jit(jax.grad(lambda p: jnp.sum(jax_out(p) * weights)))(params)), tm)

    calls = _recording(monkeypatch)
    kw = {}
    if sprint:
        s = LATENT[0] * LATENT[1]
        kw = dict(train=True, token_scores=torch.from_numpy(
            np.array(jax.random.uniform(nnx.Rngs(token_drop=key).token_drop(), (B, s)))))
    out = tm(*targs, **kw)[out_key]
    assert rel_err(out.detach().numpy(), ref) < 1e-5
    (out * torch.from_numpy(weights)).sum().backward()
    for name, p in tm.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        assert rel_err(grad.numpy(), ref_grads[name].numpy()) < 1e-4, name
    # every attention call took the unpadded query rows of a short sequence (64 tokens; SprintDiT's deep
    # path its kept 16) against keys padded to 128
    assert calls and all(sq % MIN_BLOCK and sq < skv == MIN_BLOCK for sq, skv in calls), calls
