"""The port's flash attention backward (K4/K5's plain version) against the JAX
flash backward kernels.

On the CPU the port's ``flash_attention_bwd`` runs ``flash_attention_bwd_reference``,
K4's and K5's arithmetic over 64-key tiles. It is held against the Pallas
kernels ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel`` run in interpret mode
through ``_flash_backward``, fed the same q, k, v, mask, o, lse and do (the
layouts swapped: [B, H, S, D] and lse [B, H, Sq, 1] on the JAX side).
Tolerances, per gradient as ``|port - JAX| <= tol * (max|JAX| + |JAX|)``:
1e-5 in fp32, where only the summation order differs; 1e-2 in bf16, where p
and ds are rounded to bf16 at the same places on both sides but an fp32 score
summed in another order can flip one rounding, and the gradient's own bf16
cast is one step of 2^-8. Through the entry point (padding, layouts, K3's
forward) against ``jax.vjp`` of ``_flash_path``: 1e-4 in fp32; 5e-2 in bf16,
where the forward's p is also rounded relative to other tiles' running max
(trap T15). The CUDA kernels are held against the same plain version on the
card by chip_smoke.py phase 11.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffulab_tpu.ops.attention import _flash_path
from diffulab_tpu.ops.flash_attention import _flash_backward, _flash_forward
from diffulab_tpu_torch.ops import dot_product_attention
from diffulab_tpu_torch.ops import flash_attention as tflash
from diffulab_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
PATH_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _arrays(seed, b=2, sq=128, skv=128, h=2, d=64):
    """q, k, v, do [B, S, H, D] from numpy."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d), (b, sq, h, d)))


def _assert_grads(ours, refs, tol):
    for label, o, r in zip(("dq", "dk", "dv"), ours, refs):
        o, r = np.asarray(o, np.float32), np.asarray(r, np.float32)
        bound = tol * (np.abs(r).max() + np.abs(r))
        assert np.all(np.abs(o - r) <= bound), f"{label}: max err {np.abs(o - r).max():.3e}"


def _both(q, k, v, do, mask, dtype, scale=None):
    """(port grads, JAX interpret-mode grads) as fp32 numpy [B, S, H, D], from
    the JAX forward's o and lse fed to both backwards."""
    tdt, jdt = DTYPES[dtype]
    d = q.shape[-1]
    sm_scale = d ** -0.5 if scale is None else scale
    jq, jk, jv, jdo = (jnp.asarray(np.swapaxes(a, 1, 2), jdt) for a in (q, k, v, do))
    jmask = None if mask is None else jnp.asarray(mask)
    o, lse = _flash_forward(jq, jk, jv, jmask, sm_scale, 128, 128, True)
    ref = _flash_backward(jq, jk, jv, jmask, o, lse, jdo, sm_scale, 128, 128, True)
    ref = [np.swapaxes(np.asarray(g, np.float32), 1, 2) for g in ref]

    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    to = torch.from_numpy(np.swapaxes(np.asarray(o.astype(jnp.float32)), 1, 2).copy()).to(tdt)
    tlse = torch.from_numpy(np.asarray(lse)[..., 0].copy())  # [B, H, Sq, 1] -> [B, H, Sq]
    tmask = None if mask is None else torch.from_numpy(mask)
    ours = flash_attention_bwd(tq, tk, tv, tmask, to, tlse, tdo, scale)
    for g, t in zip(ours, (tq, tk, tv)):
        assert g.dtype == tdt and g.shape == t.shape
    return [g.float().numpy() for g in ours], ref


def _lengths_mask(skv, lengths):
    return np.arange(skv)[None, :] < np.asarray(lengths)[:, None]


CASES = {
    "unmasked": dict(),
    "ragged_mask": dict(skv=256, lengths=(200, 77)),
    "cross_attention_256_128": dict(sq=256, skv=128),
    "scale_override": dict(scale=0.3, lengths=(128, 50)),
    "head_dim_16": dict(d=16, lengths=(128, 65)),
    "head_dim_32": dict(d=32),
    "head_dim_128": dict(d=128, lengths=(90, 128)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_bwd_matches_jax_flash_backward_kernels(case, dtype):
    cfg = dict(CASES[case])
    lengths = cfg.pop("lengths", None)
    scale = cfg.pop("scale", None)
    q, k, v, do = _arrays(len(case), **cfg)
    mask = None if lengths is None else _lengths_mask(k.shape[1], lengths)
    ours, ref = _both(q, k, v, do, mask, dtype, scale)
    _assert_grads(ours, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_row_has_exactly_zero_gradients(dtype):
    q, k, v, do = _arrays(3)
    mask = np.stack([np.zeros(128, bool), np.ones(128, bool)])
    ours, ref = _both(q, k, v, do, mask, dtype)
    for g, r in zip(ours, ref):
        np.testing.assert_array_equal(g[0], 0.0)
        np.testing.assert_array_equal(r[0], 0.0)
    _assert_grads([g[1] for g in ours], [r[1] for r in ref], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ["unaligned_100_300", "masked_600"])
def test_entry_point_grads_match_jax_vjp_of_flash_path(shape, dtype):
    """dot_product_attention(impl="flash") under autograd (FlashAttention:
    the plain K3 forward, the plain K4/K5 backward) against jax.vjp of the
    reference's padded interpret-mode flash path."""
    tdt, jdt = DTYPES[dtype]
    if shape == "unaligned_100_300":
        q, k, v, do = _arrays(20, b=1, sq=100, skv=300)
        mask = _lengths_mask(300, (211,))
    else:
        q, k, v, do = _arrays(21, b=1, sq=600, skv=600)
        mask = _lengths_mask(600, (450,))
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = dot_product_attention(*leaves, kv_mask=torch.from_numpy(mask), impl="flash")
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    ours = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(tdt))
    jax_flash = functools.partial(_flash_path, interpret=True)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash(q_, k_, v_, jnp.asarray(mask), None),
                     *(jnp.asarray(a, jdt) for a in (q, k, v)))
    ref = vjp(jnp.asarray(do, jdt))
    _assert_grads([g.float().numpy() for g in ours], [np.asarray(r, np.float32) for r in ref], PATH_TOL[dtype])


def test_cpu_backward_runs_the_plain_backward_not_autograd_of_the_forward(monkeypatch):
    """On the CPU the backward runs the plain K4 (dk, dv) and the plain K5 (dq)
    through their ops, each once, from the forward's lse and the di of its
    saved o; the gradients are the plain backward's bit for bit."""
    calls = []
    plain = tflash.flash_attention_bwd_from_di

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return plain(*args, **kwargs)

    monkeypatch.setattr(tflash, "flash_attention_bwd_from_di", spy)
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(30, b=1, sq=70, skv=90))
    mask = torch.from_numpy(_lengths_mask(90, (61,)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = FlashAttention.apply(*leaves, mask, 64 ** -0.5)
    assert not lse.requires_grad
    grads = torch.autograd.grad(o, leaves, do)
    assert [kwargs for _, kwargs in calls] == [{"want_dq": False}, {"want_dkv": False}]
    di = (o.detach().float() * do.float()).sum(dim=-1).permute(0, 2, 1)  # from the forward's o, as _flash_fwd_rule saves it
    for args, _ in calls:
        torch.testing.assert_close(args[4], lse, rtol=0, atol=0)
        torch.testing.assert_close(args[5], di, rtol=0, atol=0)
    for g, r in zip(grads, tflash.flash_attention_bwd_reference(q, k, v, mask, o.detach(), lse, do, 64 ** -0.5)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    # without grad the forward alone runs and nothing is saved
    with torch.no_grad():
        o2, _ = flash_attention(*leaves, mask)
    assert o2.grad_fn is None


def test_bf16_backward_rounds_p_and_ds_before_the_products():
    """The plain version's roundings, rebuilt by hand over one tile of all keys:
    dv from bf16(p), dk and dq from bf16(ds), di from the stored o."""
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _arrays(31, b=1, sq=64, skv=64, h=1, d=16))
    o, lse = flash_attention(q, k, v)
    dq, dk, dv = flash_attention_bwd_reference(q, k, v, None, o, lse, do, block_k=64)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * 16 ** -0.5
    p = torch.exp(s - lse[..., None])
    di = (o.float() * do.float()).sum(-1).permute(0, 2, 1)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float()) - di[..., None]) * 16 ** -0.5
    torch.testing.assert_close(dv, torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), do.float()).bfloat16(),
                               rtol=0, atol=0)
    torch.testing.assert_close(dk, torch.einsum("bhqk,bqhd->bkhd", ds.bfloat16().float(), q.float()).bfloat16(),
                               rtol=0, atol=0)
    torch.testing.assert_close(dq, torch.einsum("bhqk,bkhd->bqhd", ds.bfloat16().float(), k.float()).bfloat16(),
                               rtol=0, atol=0)
    # and the rounding matters: without it dv differs
    assert not torch.equal(dv, torch.einsum("bhqk,bqhd->bkhd", p, do.float()).bfloat16())


def test_flash_backward_has_no_fallback_off_the_cpu():
    # a tensor on neither the CPU nor a card is refused rather than computed
    q = torch.zeros(1, 64, 1, 64, device="meta")
    lse = torch.zeros(1, 1, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention_bwd(q, q, q, None, q, lse, q)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention(q.requires_grad_(), q, q)
