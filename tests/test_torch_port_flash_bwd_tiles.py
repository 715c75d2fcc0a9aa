"""The flash backward's plain version at the tile sizes of the Hopper K4/K5
kernels, against the JAX flash backward kernels run with the same tiles.

The Hopper kernels walk 64-query tiles (32 at D = 128) with 128 keys a CTA
(K4) and 64-key tiles with 128 queries a CTA (K5). The backward has no online
rescale, so its result depends on the tiling only through the fp32 summation
order: ``flash_attention_bwd_reference`` with ``block_k`` 64 or 128 is held
against ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel`` in interpret mode with
block_q = block_k = 64 or 128, at lengths that leave ragged tiles on both
axes (Sq 65 and 130, Skv 130 and 300), in fp32 and bf16. The JAX side runs on
inputs zero-padded to whole tiles with the padding keys masked, as
``_flash_path`` pads them (to an odd number of 64-row tiles, since the
reference takes 128-row tiles wherever they divide); its padding rows are
dropped. Tolerances as
tests/test_torch_port_flash_grad.py: per gradient
``|port - JAX| <= tol * (max|JAX| + |JAX|)``, 1e-5 in fp32 (summation order
only) and 1e-2 in bf16 (p and ds are rounded to bf16 at the same places, but
an fp32 score summed in another order can flip one rounding). The CUDA
kernels are held against the same plain version on the card by
chip_smoke.py phase 11, at the tile edges these shapes exercise.

Also here: the kernel libraries' build key covers the header the sources
share (``csrc/hopper.cuh``), so that an edited header is rebuilt.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffulab_tpu.ops.flash_attention import _block_sizes, _flash_backward, _flash_forward
from diffulab_tpu_torch.ops import _build
from diffulab_tpu_torch.ops.flash_attention import flash_attention_bwd_reference

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
#: (Sq, Skv, valid keys of the second batch row): ragged on both axes at 64 and 128
SHAPES = {"sq65_skv130": (65, 130, 129), "sq130_skv300": (130, 300, 131)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pad(a: np.ndarray, axis: int, n: int) -> np.ndarray:
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, n - a.shape[axis])
    return np.pad(a, widths)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_backward_matches_jax_at_the_kernel_tiles(shape, block, dtype):
    sq, skv, valid = SHAPES[shape]
    b, h, d = 2, 2, 64
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(block + sq)
    q, do = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, skv, h, d)).astype(np.float32) for _ in range(2))
    mask = np.arange(skv)[None, :] < np.asarray([skv, valid])[:, None]
    scale = d ** -0.5

    # JAX: whole tiles of `block` rows on both axes, the padding keys masked; the
    # reference tiles a multiple of 128 with 128, so 64-row tiles need an odd count
    def padded(n):
        tiles = -(-n // block)
        return (tiles + (block == 64 and tiles % 2 == 0)) * block

    sq_p, skv_p = padded(sq), padded(skv)
    assert _block_sizes(sq_p, skv_p, block, block, d) == (block, block)
    jq, jdo = (jnp.asarray(np.swapaxes(_pad(a, 1, sq_p), 1, 2), jdt) for a in (q, do))
    jk, jv = (jnp.asarray(np.swapaxes(_pad(a, 1, skv_p), 1, 2), jdt) for a in (k, v))
    jmask = jnp.asarray(_pad(mask, 1, skv_p))
    o, lse = _flash_forward(jq, jk, jv, jmask, scale, block, block, True)
    ref = _flash_backward(jq, jk, jv, jmask, o, lse, jdo, scale, block, block, True)
    ref = [np.swapaxes(np.asarray(g, np.float32), 1, 2)[:, :n] for g, n in zip(ref, (sq, skv, skv))]

    # the port's plain backward over key tiles of `block`, from the JAX forward's o and lse
    to = torch.from_numpy(np.swapaxes(np.asarray(o.astype(jnp.float32)), 1, 2)[:, :sq].copy()).to(tdt)
    tlse = torch.from_numpy(np.asarray(lse)[:, :, :sq, 0].copy())
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    ours = flash_attention_bwd_reference(tq, tk, tv, torch.from_numpy(mask), to, tlse, tdo, scale, block_k=block)

    for label, g, r in zip(("dq", "dk", "dv"), ours, ref):
        assert g.dtype == tdt
        g = g.float().numpy()
        bound = TOL[dtype] * (np.abs(r).max() + np.abs(r))
        assert np.all(np.abs(g - r) <= bound), f"{label}: max err {np.abs(g - r).max():.3e}"
    # the masked keys of the second row get exactly zero gradients on both sides
    for g, r in zip(ours[1:], ref[1:]):
        np.testing.assert_array_equal(g[1, valid:].float().numpy(), 0.0)
        np.testing.assert_array_equal(r[1, valid:], 0.0)


def test_build_target_covers_the_shared_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kernel.cu").write_text('#include "hopper.cuh"\n')
    header = csrc / "hopper.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(_build, "_PKG", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "KERNELS", {"kernel": ("csrc/kernel.cu", {})})
    first = _build._target("kernel")
    assert first == _build._target("kernel")  # the same files: the same library
    assert first.parent == tmp_path / "_build" and first.name.startswith("kernel-")
    header.write_text("// v2\n")
    edited = _build._target("kernel")
    assert edited != first
    (csrc / "other.cuh").write_text("// a new header\n")
    assert _build._target("kernel") != edited
