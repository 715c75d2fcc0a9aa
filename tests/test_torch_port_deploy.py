"""The port's serving path (diffulab_tpu_torch/deploy, the export_sampler and
serve CLIs) and its kernels' custom ops, on the CPU.

The tiny DiT of tests/test_deploy.py (depth 1, inner dim 64, 4 heads, 10
classes, patch 2 on 8x8x3) with every parameter overwritten by seeded noise
(adaLN-zero would leave the blocks idle, trap T9) and bridged from the JAX
model. An artifact is held to the port's live ``generate`` for one seed
(1e-5; both draw their noise from one generator in one order, and the
artifact's loop is the live loop traced, so the difference is 0 here), and,
fed the same numpy x_T, to the JAX ``generate`` on the same weights (1e-4 in
fp32; measured ~1e-6).
"""

import base64
import json
import threading
from http.server import HTTPServer
from urllib import error, request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import TINY_TOWER, _randomize, diffusers_vae_state_dict, tower_pair
from flax import nnx
from torch._subclasses.fake_tensor import FakeTensorMode

from diffulab_tpu.deploy import export_generate as jax_export_generate
from diffulab_tpu.diffuse.diffuser import Diffuser as JaxDiffuser
from diffulab_tpu.networks.denoisers.mmdit import MMDiT as JaxMMDiT
from diffulab_tpu_torch.deploy import DeployedSampler, TensorSpec, export_generate
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.ops import fused_mha as fm
from diffulab_tpu_torch.ops import flash_attention as fa
from diffulab_tpu_torch.weights import state_dict_from_jax

TINY_DEPLOY = dict(simple_dit=True, input_channels=3, inner_dim=64, embedding_dim=64, num_heads=4, mlp_ratio=2,
                   patch_size=2, depth=1, n_classes=10, classifier_free=True)
SHAPE = (8, 8, 3)
Y_SPEC = {"y": TensorSpec((), torch.int64)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    """(the JAX tiny DiT, its port twin), the same seeded weights."""
    jax_model = JaxMMDiT(**TINY_DEPLOY, rngs=nnx.Rngs(0))
    params = _randomize(jax_model, seed=5)
    model = MMDiT(**TINY_DEPLOY, device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return jax_model, model.eval()


def _live(diffuser, y, seed, guidance=1.5, shape=SHAPE):
    gen = torch.Generator("cpu").manual_seed(seed)
    return diffuser.generate({"y": torch.as_tensor(y)}, data_shape=(len(y), *shape), generator=gen,
                             guidance_scale=guidance, clamp_x=True, device="cpu")["x"].float().numpy()


@pytest.mark.parametrize("sampler,model_type,n_steps", [
    ("euler", "rectified_flow", 4), ("euler_maruyama", "rectified_flow", 3), ("dpmpp_2m", "rectified_flow", 3),
    ("heun", "edm", 3), ("ddpm", "gaussian_diffusion", 1000)])
def test_export_roundtrip_matches_live_generate(models, tmp_path, sampler, model_type, n_steps):
    """Every sampler family: deterministic ones, the stochastic Euler-Maruyama and
    DDPM (one noise input a step), the multistep DPM++(2M) (its state in the
    traced loop), EDM's Heun (two model calls a step)."""
    _, model = models
    diffuser = Diffuser(model, sampler, model_type=model_type, n_steps=n_steps)
    if model_type == "gaussian_diffusion":
        diffuser.set_steps(3)
    art = export_generate(diffuser, Y_SPEC, batch_size=2, image_shape=SHAPE, out_dir=tmp_path / "art",
                          guidance_scale=1.5)
    for name in ("sampler.pt2", "denoiser.pt2", "manifest.json"):
        assert (art / name).exists()
    deployed = DeployedSampler(art, device="cpu")
    assert deployed.batch_size == 2
    stochastic = sampler in ("euler_maruyama", "ddpm")
    kinds = [n["kind"] for n in deployed.manifest["noise"]]
    assert kinds == ["init"] + ["step"] * (diffuser.diffusion.steps if stochastic else 0)
    y = np.array([3, 7])
    out = deployed(seed=0, y=y)
    assert out.shape == (2, *SHAPE) and out.dtype == np.float32
    np.testing.assert_allclose(out, _live(diffuser, y, 0), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out, deployed(seed=0, y=y))
    assert not np.allclose(out, deployed(seed=1, y=y))


def test_artifact_matches_jax_generate(models, tmp_path):
    """The artifact's program on a numpy x_T against the JAX ``generate`` from the same x."""
    jax_model, model = models
    art = export_generate(Diffuser(model, "euler", n_steps=4), Y_SPEC, batch_size=2, image_shape=SHAPE,
                          out_dir=tmp_path / "art", guidance_scale=1.5)
    deployed = DeployedSampler(art, device="cpu")
    rng = np.random.default_rng(9)
    x_t = rng.standard_normal((2, *SHAPE)).astype(np.float32)
    y = np.array([1, 8])
    with torch.no_grad():
        ours = deployed._program([torch.from_numpy(x_t)], [torch.from_numpy(y)]).numpy()
    ref = JaxDiffuser(jax_model, sampling_method="euler", model_type="rectified_flow", n_steps=4).generate(
        jax.random.key(0), {"y": jnp.asarray(y)}, x=jnp.asarray(x_t), guidance_scale=1.5, clamp_x=True)["x"]
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=1e-4)


def test_deployed_sampler_validates_inputs(models, tmp_path):
    _, model = models
    art = export_generate(Diffuser(model, "euler", n_steps=2), Y_SPEC, batch_size=2, image_shape=SHAPE,
                          out_dir=tmp_path / "a")
    deployed = DeployedSampler(art, device="cpu")
    with pytest.raises(ValueError, match="missing conditioning"):
        deployed(seed=0)
    with pytest.raises(ValueError, match="shape"):
        deployed(seed=0, y=np.zeros((5,), np.int64))
    # an artifact serves on the device type it was exported on, and nowhere else
    with pytest.raises(ValueError, match="exported for"):
        DeployedSampler(art, device="cuda")
    manifest = json.loads((art / "manifest.json").read_text())
    (art / "manifest.json").write_text(json.dumps({**manifest, "version": 2}))
    with pytest.raises(ValueError, match="version"):
        DeployedSampler(art, device="cpu")


def test_export_edm_manifest(models, tmp_path):
    """EDM's manifest: ``n_steps`` from ``diffusion.steps`` and the JAX manifest's
    keys, plus the noise inputs and the artifact's id."""
    jax_model, model = models
    jax_art = jax_export_generate(
        JaxDiffuser(jax_model, sampling_method="heun", model_type="edm", n_steps=4),
        {"y": jax.ShapeDtypeStruct((), jnp.int32)}, batch_size=2, image_shape=SHAPE, out_dir=tmp_path / "jax",
        guidance_scale=1.5)
    jax_manifest = json.loads((jax_art / "manifest.json").read_text())
    diffuser = Diffuser(model, "heun", model_type="edm", n_steps=4)
    art = export_generate(diffuser, Y_SPEC, batch_size=2, image_shape=SHAPE, out_dir=tmp_path / "edm",
                          guidance_scale=1.5)
    manifest = json.loads((art / "manifest.json").read_text())
    assert manifest["n_steps"] == jax_manifest["n_steps"] == 4
    assert set(manifest) - set(jax_manifest) == {"noise", "artifact"} and set(jax_manifest) <= set(manifest)
    for key in ("version", "batch_size", "image_shape", "guidance_scale"):
        assert manifest[key] == jax_manifest[key]
    assert manifest["platforms"] == ["cpu"] and manifest["cond"]["y"]["shape"] == []
    out = DeployedSampler(art, device="cpu")(seed=0, y=np.array([1, 2]))
    assert out.shape == (2, *SHAPE) and np.isfinite(out).all()
    np.testing.assert_allclose(out, _live(diffuser, np.array([1, 2]), 0), rtol=0, atol=1e-5)


def test_latent_artifact_decodes_like_live_generate(tmp_path):
    """Latent mode: the tiny Flux2 tower's decode of ``x / latent_scale +
    latent_bias`` inside the artifact, the decoded pixels clipped, as the live
    latent-mode ``generate``."""
    _, tower = tower_pair(diffusers_vae_state_dict(), bn_stats=True)
    packed = TINY_TOWER["latent_channels"] * 4
    torch.manual_seed(3)
    model = MMDiT(**{**TINY_DEPLOY, "input_channels": packed}, device="cpu").eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    diffuser = Diffuser(model, "euler", n_steps=3, vision_tower=tower.eval())
    latent = (4, 4, packed)
    art = export_generate(diffuser, Y_SPEC, batch_size=2, image_shape=latent, out_dir=tmp_path / "latent",
                          guidance_scale=2.0)
    y = np.array([4, 0])
    out = DeployedSampler(art, device="cpu")(seed=3, y=y)
    live = _live(diffuser, y, 3, guidance=2.0, shape=latent)
    assert out.shape == live.shape == (2, 16, 16, 3) and np.abs(out).max() <= 1.0
    np.testing.assert_allclose(out, live, rtol=0, atol=1e-5)
    assert json.loads((art / "manifest.json").read_text())["n_tower_params"] == len(tower.state_dict())


# --- the kernels' custom ops --------------------------------------------------------


def _attn_inputs(dtype, b=2, s=128, h=2, d=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen).to(dtype) for _ in range(4))
    mask = torch.rand(b, s, generator=gen) > 0.3
    return q, k, v, do, mask


def _op_args(name, dtype):
    q, k, v, do, mask = _attn_inputs(dtype)
    scale = 16 ** -0.5
    if name in ("fused_mha_fwd", "flash_attn_fwd"):
        return (q, k, v, mask, scale)
    if name == "fused_mha_bwd":
        _, lse = fm.fused_mha_reference(q, k, v, mask, scale)
        return (q, k, v, mask, lse, do, scale)
    o, lse = fa.flash_attention_reference(q, k, v, mask, scale)
    if name == "flash_attn_bwd_dkv":
        return (q, k, v, mask, o, lse, do, scale)
    di = (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()
    return (q, k, v, mask, lse, di, do, scale)


OPS = ("fused_mha_fwd", "fused_mha_bwd", "flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", OPS)
def test_op_fake_gives_the_real_shapes(name, dtype):
    """Each op's fake implementation states its real outputs' shapes and
    dtypes (o and lse for K1/K3, dq, dk and dv for K2, dk, dv and di for K4, dq
    for K5); on the CPU the op runs the plain version and launches nothing."""
    op = getattr(torch.ops.diffulab_tpu_torch, name)
    args = _op_args(name, dtype)
    before = {**fm.LAUNCHES, **fa.LAUNCHES}
    real = op(*args)
    assert {**fm.LAUNCHES, **fa.LAUNCHES} == before
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = op(*args)
    real, fake = (r if isinstance(r, tuple) else (r,) for r in (real, fake))
    assert [(tuple(t.shape), t.dtype) for t in fake] == [(tuple(t.shape), t.dtype) for t in real]


def test_ops_run_the_plain_versions_on_cpu():
    """The entry points go through the ops, and on CPU tensors the ops are
    today's plain versions, bit for bit."""
    q, k, v, do, mask = _attn_inputs(torch.float32, seed=2)
    for ours, ref in ((fm.fused_mha(q, k, v, mask), fm.fused_mha_reference(q, k, v, mask)),
                      (fa.flash_attention(q, k, v, mask), fa.flash_attention_reference(q, k, v, mask))):
        for a, b in zip(ours, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    o, lse = fa.flash_attention_reference(q, k, v, mask)
    for a, b in zip(fa.flash_attention_bwd(q, k, v, mask, o, lse, do),
                    fa.flash_attention_bwd_reference(q, k, v, mask, o, lse, do)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


class _TwoRoutes(torch.nn.Module):
    def forward(self, q, k, v, mask):
        return fm.fused_mha(q, k, v, mask)[0] + fa.flash_attention(q, k, v, mask)[0]


def test_export_keeps_each_kernel_one_node():
    q, k, v, _, mask = _attn_inputs(torch.float32)
    with torch.no_grad():
        ep = torch.export.export(_TwoRoutes(), (q, k, v, mask), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("diffulab_tpu_torch.fused_mha_fwd.default") == 1
    assert targets.count("diffulab_tpu_torch.flash_attn_fwd.default") == 1
    assert not any("einsum" in t or "exp" in t for t in targets)  # no plain version traced into the graph
    torch.testing.assert_close(ep.module()(q, k, v, mask), _TwoRoutes()(q, k, v, mask), rtol=0, atol=0)


# --- the CLIs -------------------------------------------------------------------------


CLI_OVERRIDES = ["model.depth=1", "model.inner_dim=64", "model.embedding_dim=64", "model.num_heads=4",
                 "dataset.train.n_samples=32", "dataset.val.n_samples=16", "dataloader.batch_size=16",
                 "trainer.n_epoch=1", "trainer.val_steps=2", "diffuser.n_steps=2"]


@pytest.fixture(scope="module")
def cli_artifact(tmp_path_factory):
    """A toy train_synthetic_flow_matching run's ``ema``, exported through the CLI with --smoke."""
    from diffulab_tpu_torch.examples import export_sampler, train_diffusion

    root = tmp_path_factory.mktemp("cli")
    config = ["--config-name", "train_synthetic_flow_matching", *CLI_OVERRIDES]
    train_diffusion.main(["--device", "cpu", *config, f"trainer.save_path={root}"])
    result = export_sampler.main(["--device", "cpu", *config[:2], "--ckpt",
                                  str(root / "synthetic_flow_matching" / "checkpoints" / "ema"),
                                  "--out", str(root / "art"), "--batch-size", "4", "--guidance", "1.5",
                                  "--smoke", *CLI_OVERRIDES])
    return result


def test_export_sampler_cli(cli_artifact):
    manifest = json.loads((cli_artifact["artifact"] / "manifest.json").read_text())
    assert manifest["batch_size"] == 4 and manifest["n_steps"] == 2 and manifest["guidance_scale"] == 1.5
    assert manifest["cond"] == {"y": {"shape": [], "dtype": "int64"}} and manifest["image_shape"] == [32, 32, 3]
    smoke = cli_artifact["smoke"]
    assert smoke.shape == (4, 32, 32, 3) and np.isfinite(smoke).all() and np.abs(smoke).max() <= 1.0
    assert cli_artifact["bytes"] == sum(p.stat().st_size for p in cli_artifact["artifact"].iterdir())


def test_serve_handler_pads_trims_and_rejects(cli_artifact):
    from diffulab_tpu_torch.examples import serve

    sampler = DeployedSampler(cli_artifact["artifact"], device="cpu")
    serve.warm(sampler)
    server = HTTPServer(("127.0.0.1", 0), serve.make_handler(sampler))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def call(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        try:
            with request.urlopen(request.Request(url + path, data=data), timeout=60) as r:
                return r.status, json.loads(r.read())
        except error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        status, health = call("/healthz")
        assert status == 200 and health["manifest"] == sampler.manifest
        status, body = call("/generate", {"seed": 3, "y": [2, 5]})
        assert status == 200 and body["shape"] == [2, 32, 32, 3]
        images = np.frombuffer(base64.b64decode(body["images"]), np.uint8).reshape(body["shape"])
        # the two rows were padded with the last one to the artifact's batch of 4, then trimmed
        full = sampler(seed=3, y=np.array([2, 5, 5, 5]))[:2]
        np.testing.assert_array_equal(images, ((np.clip(full, -1, 1) + 1) * 127.5).astype(np.uint8))
        for bad in ({"seed": 0}, {"seed": 0, "y": [[1, 2]]}, {"seed": 0, "y": list(range(5))}):
            status, body = call("/generate", bad)
            assert status == 400 and body["error"]
        assert call("/nowhere")[0] == 404
    finally:
        server.shutdown()
        server.server_close()
