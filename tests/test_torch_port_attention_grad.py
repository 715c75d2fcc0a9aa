"""The port's attention backward (diffulab_tpu_torch.ops) against the JAX kernels.

On the CPU the port's backward runs its plain PyTorch version
(``fused_mha_bwd_reference``), which follows K2's op order; it is held
against the Pallas kernel ``_mha_bwd_kernel`` run in interpret mode, on the
same q/k/v/do and on the lse of the interpret-mode forward — not against
``_xla_path``, whose fully-masked rows differ (trap T1). Tolerances are
those of tests/test_fused_mha.py: 2e-5 in fp32 and 3e-2 in bf16 for the
kernel, 2e-3 in fp32 for gradients through the entry point
(``test_gradients_match_xla``). The CUDA kernel is held against the same
plain version on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffulab_tpu.ops.attention import _fused_path
from diffulab_tpu.ops.fused_mha import _mha_backward, _mha_forward
from diffulab_tpu_torch.ops import dot_product_attention
from diffulab_tpu_torch.ops.fused_mha import (
    LAUNCHES,
    FusedMHA,
    fused_mha,
    fused_mha_bwd,
    fused_mha_bwd_reference,
    fused_mha_reference,
)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _arrays(seed, b=2, sq=128, skv=128, h=4, d=64):
    rng = np.random.default_rng(seed)
    shapes = ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d), (b, sq, h, d))
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


def _both_bwd(q, k, v, do, mask, dtype):
    """(port dq/dk/dv, JAX interpret-mode K2 dq/dk/dv) as fp32 numpy; both
    sides take the lse of the JAX interpret-mode forward."""
    tdt, jdt = DTYPES[dtype]
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    jmask = None if mask is None else jnp.asarray(mask)
    scale = q.shape[-1] ** -0.5
    _, jlse = _mha_forward(jq, jk, jv, jmask, scale, True)
    ref = _mha_backward(jq, jk, jv, jmask, jlse, jdo, scale, True)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    tmask = None if mask is None else torch.from_numpy(mask)
    ours = fused_mha_bwd_reference(tq, tk, tv, tmask, torch.from_numpy(np.array(jlse)), tdo, scale)
    for o, t in zip(ours, (tq, tk, tv)):
        assert o.dtype == tdt and o.shape == t.shape
    return [o.float().numpy() for o in ours], [np.asarray(r, np.float32) for r in ref]


CASES = {
    "unmasked": dict(),
    "key_mask": dict(skv=256, lengths=(200, 77)),
    "cross_256_128": dict(sq=256, skv=128),
    "head_dim_16": dict(d=16),
    "head_dim_32": dict(d=32),
}


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_reference_matches_jax_kernel(case, dtype):
    cfg = dict(CASES[case])
    lengths = cfg.pop("lengths", None)
    q, k, v, do = _arrays(len(case), **cfg)
    mask = None
    if lengths is not None:
        mask = np.arange(k.shape[1])[None, :] < np.asarray(lengths)[:, None]
    ours, ref = _both_bwd(q, k, v, do, mask, dtype)
    for name, o, r in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(o, r, atol=TOL[dtype], rtol=TOL[dtype], err_msg=name)


def test_fully_masked_row_has_exactly_zero_grads():
    q, k, v, do = _arrays(11, h=2)
    mask = np.stack([np.zeros(128, bool), np.ones(128, bool)])
    ours, ref = _both_bwd(q, k, v, do, mask, "float32")
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o[0], 0.0)
        np.testing.assert_array_equal(r[0], 0.0)
        np.testing.assert_allclose(o[1], r[1], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", ["unaligned_100_300", "masked_self"])
def test_entry_point_grads_match_jax_grad(case):
    """autograd through the port's dot_product_attention (pad, FusedMHA,
    slice) against jax.grad of the reference's _fused_path in interpret mode."""
    if case == "unaligned_100_300":
        q, k, v, do = _arrays(13, sq=100, skv=300)
        do = do[:, :100]
        mask = None
    else:
        q, k, v, do = _arrays(17, sq=128, skv=128)
        mask = np.arange(128)[None, :] < np.array([[128], [50]])

    def jax_loss(q, k, v):
        o = _fused_path(q, k, v, None if mask is None else jnp.asarray(mask), None, interpret=True)
        return jnp.sum(o * jnp.asarray(do))

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = dot_product_attention(tq, tk, tv, kv_mask=None if mask is None else torch.from_numpy(mask))
    ours = torch.autograd.grad(out, (tq, tk, tv), grad_outputs=torch.from_numpy(do))
    for name, o, r in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-3, rtol=2e-3, err_msg=name)


def test_entry_point_grads_bf16_match_jax_grad():
    q, k, v, do = _arrays(19, sq=128, skv=128, h=2)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))

    def jax_loss(q, k, v):
        o = _fused_path(q, k, v, None, None, interpret=True).astype(jnp.float32)
        return jnp.sum(o * jnp.asarray(do))

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v))
    out = dot_product_attention(tq, tk, tv).float()
    ours = torch.autograd.grad(out, (tq, tk, tv), grad_outputs=torch.from_numpy(do))
    for name, o, r in zip(("dq", "dk", "dv"), ours, ref):
        assert o.dtype == torch.bfloat16
        np.testing.assert_allclose(o.float().numpy(), np.asarray(r, np.float32), atol=3e-2, rtol=3e-2,
                                   err_msg=name)


def test_autograd_function_saves_no_output_and_uses_the_plain_versions_on_cpu():
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(23, h=2))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    before = dict(LAUNCHES)
    o, lse = FusedMHA.apply(tq, tk, tv, None, 0.125)
    assert not lse.requires_grad
    saved = o.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[3] is None  # q, k, v, no mask, lse — not o
    assert saved[4] is not None and saved[4].shape == (2, 128, 2)
    dq, dk, dv = torch.autograd.grad(o, (tq, tk, tv), grad_outputs=do)
    ro, rlse = fused_mha_reference(q, k, v, None, 0.125)
    torch.testing.assert_close(o, ro, rtol=0, atol=0)
    for ours, ref in zip((dq, dk, dv), fused_mha_bwd_reference(q, k, v, None, rlse, do, 0.125)):
        torch.testing.assert_close(ours, ref, rtol=0, atol=0)
    assert LAUNCHES == before  # the CPU runs the plain versions, no kernel


def test_no_grad_forward_builds_no_graph():
    q = torch.zeros(1, 64, 1, 16, requires_grad=True)
    with torch.no_grad():
        o, _ = fused_mha(q, q, q)
    assert o.grad_fn is None
    o, _ = fused_mha(q, q, q)
    assert isinstance(o.grad_fn, torch.autograd.function.BackwardCFunction)


def test_plain_impl_differentiates_through_the_reference():
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(29, sq=100, skv=100, h=2))
    grads = []
    for impl in ("xla", "auto"):
        tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
        out = dot_product_attention(tq, tk, tv, impl=impl)
        grads.append(torch.autograd.grad(out, (tq, tk, tv), grad_outputs=do))
    for plain, fused in zip(*grads):
        torch.testing.assert_close(plain, fused, atol=2e-5, rtol=2e-5)


def test_bwd_wrapper_refuses_other_devices():
    q = torch.zeros(1, 64, 1, 64, device="meta")
    lse = torch.zeros(1, 64, 1, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_mha_bwd(q, q, q, None, lse, q)

