"""The port's DiT (diffulab_tpu_torch) against the JAX MMDiT(simple_dit=True).

Randomised weights (trap T9) are bridged with ``state_dict_from_jax`` and both
models see the same numpy inputs. Tolerances, as max |port - JAX| over
max |JAX|: 1e-5 in fp32 (measured ~6e-7 on the CPU: summation order only);
4e-2 under a bf16 compute dtype (measured ~1.6% for the whole-model cast,
~0.5% for the mixed policy: bf16 rounds at the same places, but XLA's CPU
backend may keep excess precision between fused bf16 ops).
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import LATENT, POLICIES, TINY, port_model, randomized_jax_model, rel_err
from flax import nnx

from diffulab_tpu.networks import nn as jnn
from diffulab_tpu_torch.networks import nn as tnn
from diffulab_tpu_torch.networks.denoisers.mmdit import LayerNormFP32, MMDiT
from diffulab_tpu_torch.networks.embedders import PrecomputedEmbedder
from diffulab_tpu_torch.weights import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
TOL = {"fp32": 1e-5, "bf16_full": 4e-2, "bf16_mixed": 4e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_dit_forward_matches_jax(policy):
    jax_model, params = randomized_jax_model(policy)
    model = port_model(policy, params)
    jdt = POLICIES[policy][0].get("dtype", jnp.float32)
    tdt = POLICIES[policy][1].get("dtype", torch.float32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, *LATENT)).astype(np.float32)
    t = rng.uniform(size=4).astype(np.float32)
    y = rng.integers(0, TINY["n_classes"], 4)
    drop = np.array([False, True, False, True])  # some rows take the null class

    ref = jax_model(jnp.asarray(x, jdt), jnp.asarray(t), {"y": jnp.asarray(y)}, jnp.asarray(drop))["x"]
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(tdt), torch.from_numpy(t), {"y": torch.from_numpy(y)},
                    torch.from_numpy(drop))["x"]
    assert out.shape == ref.shape == (4, *LATENT)
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    assert rel_err(out.float().numpy(), np.asarray(ref, np.float32)) < TOL[policy]


def test_bridge_loads_strict_with_every_key_consumed():
    _, params = randomized_jax_model("fp32")
    sd = state_dict_from_jax(params)
    assert len(sd) == len(params)
    model = MMDiT(**TINY, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    qkv = params["layers/0/attention/qkv/kernel"]
    np.testing.assert_array_equal(model.layers[0].attention.qkv.weight.detach().numpy(), qkv.T)
    conv = params["conv_proj/kernel"]  # HWIO -> OIHW
    np.testing.assert_array_equal(model.conv_proj.weight.detach().numpy(), conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(model.layers[1].norm_2.norm.weight.detach().numpy(),
                                  params["layers/1/norm_2/norm/scale"])


def test_bridge_rejects_an_unknown_leaf():
    with pytest.raises(ValueError, match="no port mapping"):
        state_dict_from_jax({"layers/0/foo/weird": np.zeros(3, np.float32)})


def test_model_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MMDiT(**TINY)


def _jax_tree(**kwargs) -> dict[str, tuple[int, ...]]:
    """The JAX MMDiT's parameters of these options, bridged to port names, by shape (built abstractly)."""
    from diffulab_tpu.networks.denoisers.mmdit import MMDiT as JaxMMDiT

    jm = nnx.eval_shape(lambda: JaxMMDiT(**kwargs, rngs=nnx.Rngs(0)))
    shapes = {"/".join(str(p) for p in path): np.zeros(np.shape(v.get_value()), np.float32)
              for path, v in nnx.state(jm, nnx.Param).flat_state()}
    return {k: tuple(v.shape) for k, v in state_dict_from_jax(shapes).items()}


@pytest.mark.parametrize("kwargs", [
    dict(simple_dit=False), dict(mlp_type="moe"), dict(attention_impl="ring"),
    dict(pipeline_microbatches=2),
])
def test_unported_options_raise(kwargs):
    """Every option builds since slice P1, with the JAX model's parameter
    tree: the multimodal MMDiT (it needs a context embedder instead of class
    labels, and with one it builds; ``mlp_type="moe"`` reaches the DiT
    blocks alone, as the reference's MMDiTBlock takes and ignores it), MoE
    (stacked expert weights and a router in every block), ring attention and
    pipelining (no parameters of their own)."""
    if kwargs.get("simple_dit") is False:
        from diffulab_tpu.networks.embedders.precomputed import PrecomputedEmbedder as JaxEmbedder

        with pytest.raises(ValueError, match="context embedder"):
            MMDiT(**{**TINY, **kwargs}, device="cpu")
        null = np.zeros((8, 32), np.float32)
        mm = dict(TINY, simple_dit=False, n_classes=None, mlp_type="moe", n_single_stream_blocks=1)
        model = MMDiT(**mm, context_embedder=PrecomputedEmbedder(null_embedding=null, device="cpu"), device="cpu")
        assert len(model.layers) == TINY["depth"]
        ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert ours == _jax_tree(**mm, context_embedder=JaxEmbedder(null_embedding=null))
        return
    model = MMDiT(**{**TINY, **kwargs}, device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == _jax_tree(**TINY, **kwargs)


def test_moe_refusal_names_its_queue_item():
    """MoE (the JAX package's parallel/moe.py) is ported (slice P1): the DiT
    with ``mlp_type="moe"`` builds a ``MoEMlp`` in every block, the
    reference's stacked ``w_in`` [E, d, h], ``w_out`` [E, h, d] and router
    ``w_gate`` [d, E], and its dense forward runs."""
    from diffulab_tpu_torch.networks.denoisers.mmdit import MoEMlp

    model = MMDiT(**TINY, mlp_type="moe", n_experts=4, device="cpu")
    d = TINY["inner_dim"]
    for block in model.layers:
        assert isinstance(block.mlp_input, MoEMlp)
        experts = block.mlp_input.experts
        assert (experts.w_in.shape, experts.w_out.shape, experts.w_gate.shape) == ((4, d, 4 * d), (4, 4 * d, d),
                                                                                   (d, 4))
    x, t, y = torch.zeros(2, *LATENT), torch.zeros(2), torch.zeros(2, dtype=torch.long)
    with torch.no_grad():
        assert torch.isfinite(model(x, t, {"y": y})["x"]).all()


def test_unported_call_paths_raise():
    """REPA feature capture (ROADMAP item 13, ported: tests/test_torch_port_repa.py)
    does not compose with block caching and raises with it; block caching and
    augmentation labels are ported (tests/test_torch_port_{caching,edm}.py)."""
    model = MMDiT(**TINY, device="cpu")
    x, t, y = torch.zeros(1, *LATENT), torch.zeros(1), torch.zeros(1, dtype=torch.long)
    with torch.no_grad():
        assert model(x, t, {"y": y}, capture_features=True)["features"] == []  # no feature_layers set
    model.set_block_cache_span((0, 1))
    cache = model.init_block_cache((1, *LATENT), {"y": y}, use_cfg=False)
    with pytest.raises(ValueError, match="don't compose"):
        model(x, t, {"y": y}, block_cache=cache, cache_refresh=True, capture_features=True)
    with torch.no_grad():
        out = model(x, t, {"y": y}, block_cache=cache, cache_refresh=True)
    assert out["x"].shape == (1, *LATENT) and out["block_cache"][0].shape == cache[0].shape
    with pytest.raises(ValueError, match="augment_dim"):
        model(x, t, {"y": y, "augment_labels": torch.zeros(1, 6)})


# --- primitives, each against its JAX counterpart --------------------------


def test_timestep_embedding():
    t = np.random.default_rng(2).uniform(size=6).astype(np.float32)
    for dim in (256, 33):
        ours = tnn.timestep_embedding(torch.from_numpy(t), dim).numpy()
        np.testing.assert_allclose(ours, np.asarray(jnn.timestep_embedding(jnp.asarray(t), dim)),
                                   atol=1e-6, rtol=1e-6)


def test_rope_grid_and_planar_rotation():
    pos = np.stack(np.meshgrid(np.arange(4), np.arange(4), indexing="ij"), -1).reshape(1, 16, 2)
    cos, sin = tnn.get_cos_sin_ndim_grid(torch.from_numpy(pos), 10_000, [8, 8])
    jcos, jsin = jnn.get_cos_sin_ndim_grid(jnp.asarray(pos), 10_000, [8, 8])
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    rng = np.random.default_rng(3)
    q, k = (rng.standard_normal((1, 16, 2, 16)).astype(np.float32) for _ in range(2))
    # bf16 inputs: cos/sin are cast to the q/k dtype before the multiply
    tq, tk = tnn.apply_rope_ndim_planar(torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
                                        cos, sin, 16)
    jq, jk = jnn.apply_rope_ndim_planar(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                                        jcos, jsin, 16)
    assert tq.dtype == torch.bfloat16
    np.testing.assert_allclose(tq.float().numpy(), np.asarray(jq, np.float32), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(tk.float().numpy(), np.asarray(jk, np.float32), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_rounds_before_the_scale(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jnorm = jnn.RMSNorm(64, rngs=nnx.Rngs(0))
    jnorm.scale.set_value(jnp.asarray(scale))
    tnorm = tnn.RMSNorm(64)
    with torch.no_grad():
        tnorm.scale.copy_(torch.from_numpy(scale))
        ours = tnorm(torch.from_numpy(x).to(getattr(torch, dtype)))
    ref = jnorm(jnp.asarray(x, getattr(jnp, dtype)))
    tol = 1e-6 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)


def test_final_layernorm_is_fp32_without_affine():
    norm = LayerNormFP32(64, use_affine=False, eps=1e-6)
    assert not list(norm.parameters())
    x = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(5)).bfloat16()
    out = norm(x)
    assert out.dtype == torch.bfloat16
    ref = torch.nn.functional.layer_norm(x.float(), (64,), eps=1e-6).bfloat16()
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


# --- the import rule ---------------------------------------------------------


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            roots.add(node.module)
    return roots


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((REPO / "diffulab_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10 and all(f.exists() for f in files)
    training = REPO / "diffulab_tpu_torch" / "training"
    assert {training / f"{m}.py" for m in ("trainer", "optim", "ema", "checkpoint", "meters", "logging")} <= set(files)
    networks = REPO / "diffulab_tpu_torch" / "networks"
    assert {networks / "embedders" / f"{m}.py" for m in ("common", "precomputed")} <= set(files)
    assert {networks / "vision_towers" / f"{m}.py" for m in ("common", "vae", "flux2")} <= set(files)
    assert REPO / "diffulab_tpu_torch" / "ops" / "flash_attention.py" in set(files)
    data = REPO / "diffulab_tpu_torch" / "data"
    assert {data / f"{m}.py" for m in ("base", "streaming", "imagenet", "synthetic", "loader", "native", "mnist",
                                       "cifar10", "folder")} <= set(files)
    assert training / "posthoc_ema.py" in set(files)
    config, examples = REPO / "diffulab_tpu_torch" / "config", REPO / "diffulab_tpu_torch" / "examples"
    assert {config / f"{m}.py" for m in ("compose", "instantiate", "sweep")} <= set(files)
    assert {examples / f"{m}.py" for m in ("train_diffusion", "reconstruct_ema", "sample")} <= set(files)
    # the serving path (slice J1): the export module, its CLIs and the HF text embedders
    deploy = REPO / "diffulab_tpu_torch" / "deploy"
    assert {deploy / "__init__.py", deploy / "export.py", examples / "export_sampler.py", examples / "serve.py",
            networks / "embedders" / "hf_text.py"} <= set(files)
    # the flash backward's CUDA source is bound by the module the scan reads
    assert (REPO / "diffulab_tpu_torch" / "csrc" / "flash_attn_bwd.cu").is_file()
    assert "flash_attn_bwd_dkv" in (REPO / "diffulab_tpu_torch" / "ops" / "flash_attention.py").read_text()
    for f in files:
        for name in _imported_roots(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "diffulab_tpu"), f"{f}: imports {name}"
    # the scan sees the imports it should, relative ones included
    assert "torch" in _imported_roots(REPO / "diffulab_tpu_torch" / "ops" / "fused_mha.py")
    assert "diffulab_tpu_torch.ops" in _imported_roots(REPO / "diffulab_tpu_torch" / "networks" / "denoisers" / "mmdit.py")
    assert "diffulab_tpu_torch.training.checkpoint" in _imported_roots(training / "trainer.py")
    assert "diffulab_tpu_torch.networks.vision_towers.vae" in _imported_roots(networks / "vision_towers" / "flux2.py")
    assert "diffulab_tpu_torch.data.streaming" in _imported_roots(data / "imagenet.py")
    assert "diffulab_tpu_torch.training.trainer" in _imported_roots(examples / "train_diffusion.py")
    assert "diffulab_tpu_torch.ops" in _imported_roots(deploy / "export.py")
