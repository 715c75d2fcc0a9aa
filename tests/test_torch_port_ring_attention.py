"""The port's ring attention (diffulab_tpu_torch/ops/ring_attention.py)
against the JAX package's ops/ring_attention.py.

Two and four gloo processes (tests/_torch_port_ranks.py) run
``sequence_parallel_attention`` over an ``sp`` axis of 2 and of 4, against
the JAX function on a mesh of the same size here: without a mask, with a
key mask, and with rows whose keys are all masked; the output and dq, dk,
dv (the port's gradient comes from the ring run backwards). One process:
the ring of one block (what ``sp=1`` runs) and the tiny DiT with
``attention_impl="ring"``; two processes: that DiT on an ``sp=2`` mesh,
every parameter's gradient (the weights outside the attention are
replicated over ``sp``: T30).

T1 in the ring: a masked score is -0.7 finfo.max and l == 0 becomes 1, so a
row with every key masked scores all keys alike and gives the mean of v in
both packages (not 0), and its dq/dk are 0.

Tolerances: outputs 1e-5 of max |ref|, gradients 1e-4 of each tensor's max
|ref| (fp32; blockwise online softmax in another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import LATENT, TINY, _randomize
from _torch_port_ranks import collect, launch_ranks
from flax import nnx
from jax.sharding import Mesh

from diffulab_tpu.networks.denoisers.mmdit import MMDiT as JaxMMDiT
from diffulab_tpu.ops.ring_attention import sequence_parallel_attention as jax_spa
from diffulab_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from diffulab_tpu.parallel.mesh import make_mesh as jax_make_mesh
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.ops.ring_attention import ring_attention_local
from diffulab_tpu_torch.weights import state_dict_from_jax

OUT_TOL, GRAD_TOL = 1e-5, 1e-4
B, S, H, D = 2, 16, 2, 8
RING = dict(TINY, attention_impl="ring")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(ours, ref, tol):
    ref = np.asarray(ref, np.float32)
    assert np.max(np.abs(np.asarray(ours) - ref)) <= tol * max(np.max(np.abs(ref)), 1e-6)


def _qkv(seed, mask_kind):
    rng = np.random.default_rng(seed)
    q, k, v, r = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(4))
    mask = None
    if mask_kind != "none":
        mask = rng.uniform(size=(B, S)) < 0.6
        mask[:, 0] = True
        if mask_kind == "dead_row":
            mask[1] = False  # every key of batch row 1 masked
    return {"q": q, "k": k, "v": v, "r": r, "mask": mask, "scale": D ** -0.5}


def _jax_ring(p, n):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))
    ring = jax_spa(mesh, axis="sp")
    mask = None if p["mask"] is None else jnp.asarray(p["mask"])

    def loss(q, k, v):
        out = ring(q, k, v, kv_mask=mask, scale=p["scale"])
        return jnp.sum(out * p["r"]), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(p[k]) for k in ("q", "k", "v")))
    return {"out": np.asarray(out), "dq": np.asarray(g[0]), "dk": np.asarray(g[1]), "dv": np.asarray(g[2])}


def _model_inputs(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((4, *LATENT)).astype(np.float32), "t": rng.uniform(size=4).astype(np.float32),
            "y": rng.integers(0, 10, 4), "r": rng.standard_normal((4, *LATENT)).astype(np.float32)}


def _jax_model(jm, sp, inp):
    """The JAX ring DiT ``jm`` on a mesh with ``sp`` devices: output and gradients by port name."""
    jm.set_parallel_mesh(jax_make_mesh(JaxMeshConfig(data=1, sp=sp), jax.devices()[:sp]))
    graphdef, jparams, rest = nnx.split(jm, nnx.Param, ...)

    def loss(jparams):
        out = nnx.merge(graphdef, jparams, rest)(jnp.asarray(inp["x"]), jnp.asarray(inp["t"]),
                                                {"y": jnp.asarray(inp["y"])})["x"]
        return jnp.sum(out * inp["r"]), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams)
    flat = {"/".join(str(k) for k in path): np.asarray(v.get_value()) for path, v in g.flat_state()}
    return np.asarray(out), {k: v.numpy() for k, v in state_dict_from_jax(flat).items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    refs, results, launched = {}, {}, {}
    inp = _model_inputs(3)
    jm = nnx.eval_shape(lambda: JaxMMDiT(**RING, rngs=nnx.Rngs(0)))
    params = _randomize(jm, 4)
    for n in (2, 4):  # both worlds run at once, while the ring references are computed here
        cases = {f"ring_{kind}": {"case": "ring", "mesh": {"sp": n}, **_qkv(10 * n + i, kind)}
                 for i, kind in enumerate(("none", "mask", "dead_row"))}
        if n == 2:
            cases["model"] = {"case": "model", "mesh": {"sp": 2}, "config": RING, "params": params, **inp}
        launched[n] = launch_ranks(n, cases, tmp_path_factory.mktemp(f"ring{n}"))
    refs["model"] = _jax_model(jm, 2, inp)
    for n in (2, 4):
        for i, kind in enumerate(("none", "mask", "dead_row")):
            refs[(n, kind)] = _jax_ring(_qkv(10 * n + i, kind), n)
    for n, handle in launched.items():
        res = collect(handle)
        results.update({(n, k.removeprefix("ring_")) if k.startswith("ring_") else k: v for k, v in res.items()})
    return refs, results


@pytest.mark.parametrize("kind", ["none", "mask", "dead_row"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_forward_and_gradients(ranks, n, kind):
    refs, results = ranks
    ref = refs[(n, kind)]
    for res in results[(n, kind)]:  # every rank holds the whole output and gradients
        for key in ("out", "dq", "dk", "dv"):
            _close(res[key], ref[key], OUT_TOL if key == "out" else GRAD_TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_fully_masked_row_gives_the_mean_of_v(ranks, n):
    """T1 in the ring: the dead row's output is mean(v) over all keys in
    both packages, and it gives q and k no gradient."""
    refs, results = ranks
    p = _qkv(10 * n + 2, "dead_row")
    mean_v = p["v"][1].mean(axis=0)
    np.testing.assert_allclose(refs[(n, "dead_row")]["out"][1], np.broadcast_to(mean_v, (S, H, D)), atol=1e-5)
    res = results[(n, "dead_row")][0]
    np.testing.assert_allclose(res["out"][1], np.broadcast_to(mean_v, (S, H, D)), atol=1e-5)
    assert np.abs(res["dq"][1]).max() == 0 and np.abs(res["dk"][1]).max() == 0


@pytest.mark.parametrize("kind", ["none", "mask", "dead_row"])
def test_ring_of_one_block_matches_jax(kind):
    """``sp=1``: the ring body with one block (no transfer), against the
    JAX ring on a 1-device mesh; gradients through the ring Function."""
    p = _qkv(7, kind)
    ref = _jax_ring(p, 1)
    q, k, v = (torch.from_numpy(p[n]).requires_grad_() for n in ("q", "k", "v"))
    mask = None if p["mask"] is None else torch.from_numpy(p["mask"])
    out = ring_attention_local(q, k, v, None, mask, p["scale"])
    (out * torch.from_numpy(p["r"])).sum().backward()
    for key, ours in (("out", out.detach()), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        _close(ours.numpy(), ref[key], OUT_TOL if key == "out" else GRAD_TOL)


def test_ring_dit_without_and_with_a_one_device_mesh():
    """attention_impl="ring" without a mesh runs the attention kernels'
    route (JAX: impl "auto"); with a mesh of one device, the ring body. Both
    equal the JAX model's output with the same mesh setting."""
    inp = _model_inputs(5)
    jm = nnx.eval_shape(lambda: JaxMMDiT(**RING, rngs=nnx.Rngs(0)))
    params = _randomize(jm, 6)
    graphdef, state = nnx.split(jm)
    args = (jnp.asarray(inp["x"]), jnp.asarray(inp["t"]))
    ref_plain = np.asarray(jax.jit(lambda st: nnx.merge(graphdef, st)(*args, {"y": jnp.asarray(inp["y"])})["x"])(state))
    tm = MMDiT(**RING, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    x, t, y = (torch.from_numpy(inp[k]) for k in ("x", "t", "y"))
    with torch.no_grad():
        _close(tm(x, t, {"y": y})["x"].numpy(), ref_plain, OUT_TOL)
        from diffulab_tpu_torch.parallel.mesh import make_mesh

        tm.set_parallel_mesh(make_mesh({"sp": 1}))
        _close(tm(x, t, {"y": y})["x"].numpy(), ref_plain, OUT_TOL)


def test_ring_dit_on_sp2_matches_jax(ranks):
    refs, results = ranks
    out, grads = refs["model"]
    for res in results["model"]:
        _close(res["out"], out, OUT_TOL)
        assert set(res["grads"]) == set(grads)
        for name, g in grads.items():
            _close(res["grads"][name], g, GRAD_TOL)
