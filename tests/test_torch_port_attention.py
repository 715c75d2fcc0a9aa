"""The port's attention (diffulab_tpu_torch.ops) against the JAX fused kernel.

On the CPU the port's wrapper runs its plain PyTorch version
(``fused_mha_reference``), which follows the kernel's op order; it is held
against the Pallas kernel ``_mha_fwd_kernel`` run in interpret mode through
the reference's ``_fused_path`` — not against ``_xla_path``, which returns
mean(V) on a fully-masked row where the kernels return 0 (trap T1). The
cases copy tests/test_fused_mha.py, with the same tolerances: 2e-5 in fp32
and 3e-2 in bf16. The CUDA kernel itself is held against the same plain
version on the card by chip_smoke.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffulab_tpu.ops.attention import _fused_path
from diffulab_tpu.ops.fused_mha import _mha_forward
from diffulab_tpu_torch.ops import dot_product_attention
from diffulab_tpu_torch.ops.attention import FUSED_MAX_SEQ, use_fused
from diffulab_tpu_torch.ops.flash_attention import flash_attention_reference
from diffulab_tpu_torch.ops.fused_mha import (
    KERNEL_CHUNKS,
    KERNEL_HEAD_DIMS,
    SMEM_LIMIT,
    STREAM_CHUNK,
    FwdInstance,
    forward_instance,
    fused_mha,
    fused_mha_reference,
)

jax_fused = functools.partial(_fused_path, interpret=True)


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


def _both(q, k, v, mask, dtype):
    """(port output, JAX interpret-mode kernel output) as fp32 numpy."""
    tdt, jdt = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    ours = dot_product_attention(tq, tk, tv, kv_mask=tmask, impl="auto")
    assert ours.dtype == tdt and ours.shape == tq.shape
    jmask = None if mask is None else jnp.asarray(mask)
    ref = jax_fused(*(jnp.asarray(a, jdt) for a in (q, k, v)), jmask, None)
    return ours.float().numpy(), np.asarray(ref, np.float32)


CASES = {
    "unmasked": dict(),
    "key_mask": dict(skv=256, lengths=(200, 77)),
    "unaligned_100_300": dict(sq=100, skv=300),
    "cross_attention": dict(sq=256, skv=128),
}


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_matches_jax_fused_kernel(case, dtype, tol):
    cfg = dict(CASES[case])
    lengths = cfg.pop("lengths", None)
    q, k, v = _qkv(len(case), **cfg)
    mask = None
    if lengths is not None:
        mask = np.arange(k.shape[1])[None, :] < np.asarray(lengths)[:, None]
    ours, ref = _both(q, k, v, mask, dtype)
    np.testing.assert_allclose(ours, ref, atol=tol, rtol=tol)


def test_lse_matches_jax_kernel_with_mask():
    q, k, v = _qkv(7, skv=256)
    mask = np.arange(256)[None, :] < np.array([[200], [77]])
    o, lse = fused_mha_reference(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
    jo, jlse = _mha_forward(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask), 64 ** -0.5, True)
    assert lse.shape == (2, 128, 4) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5, rtol=2e-5)


def test_fully_masked_row_is_zero_with_infinite_lse():
    q, k, v = _qkv(5, h=2)
    mask = np.stack([np.zeros(128, bool), np.ones(128, bool)])
    ours, ref = _both(q, k, v, mask, "float32")
    np.testing.assert_array_equal(ours[0], 0.0)
    np.testing.assert_array_equal(ref[0], 0.0)
    np.testing.assert_allclose(ours[1], ref[1], atol=2e-5, rtol=2e-5)
    _, lse = fused_mha_reference(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
    assert torch.isinf(lse[0]).all() and (lse[0] > 0).all()
    assert torch.isfinite(lse[1]).all()


def test_plain_impl_equals_auto_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, sq=100, skv=300))
    torch.testing.assert_close(dot_product_attention(q, k, v, impl="xla"),
                               dot_product_attention(q, k, v, impl="auto"), rtol=0, atol=0)


def test_dispatch_limits():
    assert use_fused((32, 256, 12, 64), 256)  # DiT-B/2
    assert use_fused((2, 100, 4, 16), 300)
    assert not use_fused((2, 256, 4, 48), 256)  # head dim without a kernel instance
    assert not use_fused((2, FUSED_MAX_SEQ + 1, 4, 64), 128)
    # past FUSED_MAX_SEQ the flash kernel K3 takes over (its plain version on the CPU)
    q, k, v = (torch.from_numpy(a) for a in _qkv(11, b=1, sq=1024, skv=1024, h=2))
    torch.testing.assert_close(dot_product_attention(q, k, v), flash_attention_reference(q, k, v)[0],
                               rtol=0, atol=0)
    torch.testing.assert_close(dot_product_attention(q, k, v, impl="xla"),  # the plain version takes any shape
                               dot_product_attention(q, k, v), atol=2e-5, rtol=2e-5)
    with pytest.raises(NotImplementedError, match="head dim 48"):
        dot_product_attention(*(t[..., :48] for t in (q, k, v)))


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_dit_b2_packed_head_layout_matches_jax_fused_kernel(dtype, tol):
    # DiT-B/2's attention: q/k/v are strided views of the packed qkv projection
    # output [B, S, 3·H·D] (row stride 3·H·D), the layout the kernel reads in place
    b, s, h, d = 2, 256, 12, 64
    qkv = np.random.default_rng(21).standard_normal((b, s, 3 * h * d)).astype(np.float32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    q, k, v = (t.reshape(b, s, h, d) for t in torch.from_numpy(qkv).to(tdt).chunk(3, dim=-1))
    assert q.stride() == (s * 3 * h * d, 3 * h * d, d, 1) and not v.is_contiguous()
    ours = dot_product_attention(q, k, v)
    ref = jax_fused(*(jnp.asarray(a.reshape(b, s, h, d), jdt) for a in np.split(qkv, 3, axis=-1)), None, None)
    assert ours.shape == (b, s, h, d) and ours.dtype == tdt
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)


def test_forward_instance_is_pinned_by_shape():
    # DiT-B/2 (256 keys, D=64): K and V resident with a second buffer, the whole
    # 256-key row in one score product (one pass over the keys)
    assert forward_instance(256, 64) == FwdInstance(resident=True, chunk=256, buffers=2, smem=164992)
    # the other lengths the fused route pads to: one pass up to 256 keys, two passes beyond
    assert forward_instance(128, 64).chunk == 128 and forward_instance(384, 64).chunk == 192
    assert forward_instance(512, 64)[:3] == (True, 256, 1)  # two 256-key chunks; no room for a second buffer
    assert forward_instance(384, 128)[:3] == (True, 128, 1)
    assert forward_instance(320, 64).chunk == 64  # 320 keys: five 64-key chunks
    # K + V beyond shared memory: streamed through the ring of 64-key slots
    assert forward_instance(448, 128)[:3] == (False, STREAM_CHUNK, 2)
    assert forward_instance(4224, 64)[:3] == (False, STREAM_CHUNK, 2)
    for skv in range(64, 4097, 64):
        for d in KERNEL_HEAD_DIMS:
            inst = forward_instance(skv, d)
            assert inst.smem <= SMEM_LIMIT and skv % inst.chunk == 0 and inst.chunk in KERNEL_CHUNKS[d]


def test_wrapper_has_no_fallback_off_the_cpu():
    # a tensor on neither the CPU nor a card is refused rather than computed
    q = torch.zeros(1, 64, 1, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_mha(q, q, q)
