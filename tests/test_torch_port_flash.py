"""The port's flash attention (K3's plain version) against the JAX flash kernel.

On the CPU the port's wrapper runs ``flash_attention_reference``, the kernel's
online recurrence over 128-key tiles. It is held against the Pallas kernel
``_fwd_kernel`` run in interpret mode through the reference's ``_flash_path``,
as tests/test_flash_attention.py runs it. Tolerances: 2e-5 in fp32, where the
tiles change only the summation order; 3e-2 in bf16, where p is rounded to
bf16 relative to the running max of the tiles seen so far, and the JAX
kernel's tiles (512 x up to 1536 keys) start elsewhere than the port's. The
CUDA kernel is held against the same plain version on the card by
chip_smoke.py phase 8.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffulab_tpu.ops.attention import _flash_path
from diffulab_tpu.ops.attention import use_fused as jax_use_fused
from diffulab_tpu.ops.flash_attention import _flash_forward
from diffulab_tpu_torch.ops import dot_product_attention
from diffulab_tpu_torch.ops.attention import FUSED_MAX_SEQ, use_fused
from diffulab_tpu_torch.ops.flash_attention import KERNEL_BLOCK_N, flash_attention, flash_attention_reference
from diffulab_tpu_torch.ops.fused_mha import KERNEL_HEAD_DIMS, MIN_BLOCK, SMEM_LIMIT, forward_instance, fused_mha_reference

jax_flash = functools.partial(_flash_path, interpret=True)
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _qkv(seed, b=2, sq=128, skv=128, h=4, d=64):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d)))


def _both(q, k, v, mask, dtype, scale=None):
    """(port output through impl="flash", JAX interpret-mode flash output) as fp32 numpy."""
    tdt, jdt = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    ours = dot_product_attention(tq, tk, tv, kv_mask=tmask, scale=scale, impl="flash")
    assert ours.dtype == tdt and ours.shape == tq.shape
    jmask = None if mask is None else jnp.asarray(mask)
    ref = jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)), jmask, scale)
    return ours.float().numpy(), np.asarray(ref, np.float32)


def _lengths_mask(skv, lengths):
    return np.arange(skv)[None, :] < np.asarray(lengths)[:, None]


CASES = {
    "unmasked": dict(),
    "key_mask": dict(skv=256, lengths=(200, 77)),
    "unaligned_100_300": dict(sq=100, skv=300),
    "unaligned_masked_300": dict(sq=300, skv=300, lengths=(300, 131)),
    "cross_attention_256_128": dict(sq=256, skv=128),
    "seq_600_padded_to_1024": dict(sq=600, skv=600, lengths=(600, 450)),
    "head_dim_16": dict(d=16, skv=192, lengths=(192, 65)),
    "scale_override": dict(scale=0.3),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_matches_jax_flash_kernel(case, dtype):
    cfg = dict(CASES[case])
    lengths = cfg.pop("lengths", None)
    scale = cfg.pop("scale", None)
    q, k, v = _qkv(len(case), **cfg)
    mask = None if lengths is None else _lengths_mask(k.shape[1], lengths)
    ours, ref = _both(q, k, v, mask, dtype, scale)
    np.testing.assert_allclose(ours, ref, atol=TOL[dtype], rtol=TOL[dtype])


def test_fully_masked_row_is_exactly_zero_with_infinite_lse():
    q, k, v = _qkv(5, sq=200, skv=200, h=2)
    mask = np.stack([np.zeros(200, bool), np.ones(200, bool)])
    ours, ref = _both(q, k, v, mask, "float32")
    np.testing.assert_array_equal(ours[0], 0.0)
    np.testing.assert_array_equal(ref[0], 0.0)
    np.testing.assert_allclose(ours[1], ref[1], atol=2e-5, rtol=2e-5)
    _, lse = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
    assert torch.isposinf(lse[0]).all() and torch.isfinite(lse[1]).all()


def test_lse_matches_jax_kernel_in_the_backward_layout():
    q, k, v = _qkv(7, sq=256, skv=256)
    mask = _lengths_mask(256, (200, 77))
    o, lse = flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
    # the JAX kernel on [B, H, S, D] returns lse [B, H, Sq, 1]; the port's is [B, H, Sq]
    jo, jlse = _flash_forward(*(jnp.asarray(np.swapaxes(a, 1, 2)) for a in (q, k, v)), jnp.asarray(mask),
                              64 ** -0.5, 128, 128, True)
    assert lse.shape == (2, 4, 256) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(o.numpy(), np.swapaxes(np.asarray(jo), 1, 2), atol=2e-5, rtol=2e-5)


def test_bf16_rounds_unnormalised_p_unlike_the_fused_kernel():
    # trap T15: K3 rounds exp(s - m) before PV and divides by l after; K1
    # rounds the normalised p. In fp32 both are the softmax; in bf16 they differ.
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, sq=128, skv=256))
    o32 = flash_attention_reference(q, k, v)[0]
    torch.testing.assert_close(o32, fused_mha_reference(q, k, v)[0], atol=2e-5, rtol=2e-5)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    flash, fused = flash_attention_reference(qb, kb, vb)[0], fused_mha_reference(qb, kb, vb)[0]
    assert not torch.equal(flash, fused)
    # the flash recurrence, rebuilt by hand for one tile of all keys: p rounded before 1/l
    s = torch.einsum("bqhd,bkhd->bhqk", qb.float(), kb.float()) * 64 ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), vb.float()) / p.sum(-1).permute(0, 2, 1)[..., None]
    torch.testing.assert_close(flash_attention_reference(qb, kb, vb, block_k=256)[0], o.bfloat16(), atol=0, rtol=0)


def test_dispatch_takes_fused_to_512_and_flash_beyond():
    assert KERNEL_BLOCK_N == 128 and FUSED_MAX_SEQ == 512
    assert use_fused((8, 512, 12, 64), 512)  # padded to 512: K1
    assert use_fused((32, 256, 12, 64), 256)  # DiT-B/2 stays on K1
    assert not use_fused((8, 513, 12, 64), 513)  # padded to 640: K3
    assert not use_fused((8, 4224, 12, 64), 4224)  # the txt2img MMDiT
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, b=1, sq=520, skv=520, h=2))
    torch.testing.assert_close(dot_product_attention(q, k, v), flash_attention_reference(q, k, v)[0], rtol=0, atol=0)
    q, k, v = (t[:, :500] for t in (q, k, v))
    torch.testing.assert_close(dot_product_attention(q, k, v), dot_product_attention(q, k, v, impl="fused"),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl must be"):
        dot_product_attention(q, k, v, impl="sdpa")


#: (S, H, D) -> whether the reference's VMEM budget and the port's 512-token
#: line disagree (trap T21): the budget admits K1 to 640 padded tokens at
#: H=12, D=64 and to 768 at H=6-8, and refuses it from 384 tokens at H=16,
#: D=128 (512 at H=12); the port keeps its line, since on the H100 the flash kernels
#: are as fast as K1 and K2 from 384 tokens and faster beyond (PERF.md §6)
DISPATCH_CASES = {
    (256, 12, 64): False,  # DiT-B/2: K1 on both sides
    (512, 12, 64): False,
    (513, 12, 64): True,  # 640 padded: the reference's K1, the port's K3
    (640, 12, 64): True,
    (641, 12, 64): False,  # 768 padded: past both
    (768, 8, 64): True,
    (768, 6, 64): True,
    (896, 6, 64): False,
    (1024, 1, 64): True,
    (1024, 1, 16): True,
    (384, 16, 128): True,  # the budget refuses, the port takes K1
    (256, 16, 128): False,
    (512, 12, 128): True,
    (384, 12, 128): False,
    (512, 16, 64): False,
    (4224, 12, 64): False,  # the txt2img MMDiT: flash on both sides
}


@pytest.mark.parametrize("s,h,d", sorted(DISPATCH_CASES))
def test_dispatch_divergence_from_the_reference_budget_is_pinned(s, h, d):
    shape = (2, s, h, d)
    padded = -(-s // MIN_BLOCK) * MIN_BLOCK
    ours, ref = use_fused(shape, s), jax_use_fused(shape, s, backend="tpu")
    assert ours == (padded <= FUSED_MAX_SEQ)
    assert (ours != ref) == DISPATCH_CASES[(s, h, d)]
    # any shape either rule sends to the fused route has a K1 instance (and K2 takes any multiple of 64)
    if ours or ref:
        assert d in KERNEL_HEAD_DIMS and forward_instance(padded, d).smem <= SMEM_LIMIT


def test_cpu_grad_through_flash_matches_jax_flash_backward():
    q, k, v = _qkv(10, b=1, sq=200, skv=200, h=2)
    mask = _lengths_mask(200, (150,))
    do = np.random.default_rng(11).standard_normal(q.shape).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = dot_product_attention(*leaves, kv_mask=torch.from_numpy(mask), impl="flash")
    ours = torch.autograd.grad(out, leaves, torch.from_numpy(do))

    def loss(q_, k_, v_):
        return jnp.sum(jax_flash(q_, k_, v_, jnp.asarray(mask), None) * jnp.asarray(do))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for g, r in zip(ours, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)


def test_flash_wrapper_has_no_fallback_off_the_cpu():
    # a tensor on neither the CPU nor a card is refused rather than computed
    q = torch.zeros(1, 64, 1, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention(q, q, q)
