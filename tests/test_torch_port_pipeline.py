"""The port's GPipe engine (diffulab_tpu_torch/parallel/pipeline.py) and the
MMDiT's pipelined blocks against the JAX package's parallel/pipeline.py.

Two gloo processes (tests/_torch_port_ranks.py) on a ``pipe=2`` mesh:
``pipeline_apply`` on a toy stack of tanh layers (8 layers, 4 and 1
microbatches: the bubble's clamped fill and drain) against the JAX engine
on a 2-device mesh and against the layers in sequence, forward and the
gradients of the input and of every stacked parameter; its divisibility
errors (layers by stages, batch by microbatches); and the tiny DiT with
``pipeline_microbatches=2`` against the JAX model on the same mesh and
against its own blocks in sequence. One process: the stacked parameters and
the sequential path the model keeps without a ``pipe`` axis.

Tolerances: outputs 1e-5 of max |ref|, gradients 1e-4 of each tensor's max
|ref| (fp32).
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
from diffulab_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from diffulab_tpu.parallel.mesh import make_mesh as jax_make_mesh
from diffulab_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.parallel.mesh import make_mesh
from diffulab_tpu_torch.parallel.pipeline import pipeline_apply, stack_block_params
from diffulab_tpu_torch.weights import state_dict_from_jax

OUT_TOL, GRAD_TOL = 1e-5, 1e-4
PIPE = dict(TINY, pipeline_microbatches=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(ours, ref, tol):
    ref = np.asarray(ref, np.float32)
    assert np.max(np.abs(np.asarray(ours) - ref)) <= tol * max(np.max(np.abs(ref)), 1e-6)


def _toy(layers, d, batch, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(scale=0.3, size=(layers, d, d)).astype(np.float32),
            "b": rng.normal(scale=0.1, size=(layers, d)).astype(np.float32),
            "x": rng.normal(size=(batch, d)).astype(np.float32),
            "r": rng.normal(size=(batch, d)).astype(np.float32)}


def _toy_stage(layer, state):
    return {**state, "x": jnp.tanh(state["x"] @ layer["w"] + layer["b"])}


def _jax_toy(p, m, pipe):
    """(out, dx, dw, db) of the JAX engine on ``pipe`` devices, or of the sequential layers (pipe=None)."""
    def run(w, b, x):
        if pipe is None:
            for i in range(w.shape[0]):
                x = _toy_stage({"w": w[i], "b": b[i]}, {"x": x})["x"]
            return x
        mesh = Mesh(np.asarray(jax.devices()[:pipe]), ("pipe",))
        return jax_pipeline_apply(_toy_stage, {"w": w, "b": b}, {"x": x}, mesh=mesh, axis="pipe",
                                  n_microbatches=m)["x"]

    def loss(w, b, x):
        out = run(w, b, x)
        return jnp.sum(out * p["r"]), out

    (_, out), (dw, db, dx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(p["w"]), jnp.asarray(p["b"]), jnp.asarray(p["x"]))
    return {"out": np.asarray(out), "dx": np.asarray(dx), "dw": np.asarray(dw), "db": np.asarray(db)}


def _model_inputs(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((4, *LATENT)).astype(np.float32), "t": rng.uniform(size=4).astype(np.float32),
            "y": rng.integers(0, 10, 4), "r": rng.standard_normal((4, *LATENT)).astype(np.float32)}


def _jax_model(jm, mesh, inp):
    if mesh is not None:
        jm.set_parallel_mesh(mesh)
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
    refs, cases, toys = {}, {}, {}
    for m in (4, 1):
        toys[m] = _toy(8, 16, 8, seed=m)
        cases[f"toy{m}"] = {"case": "pipeline", "mesh": {"pipe": 2}, **toys[m], "m": m}
    cases["bad_layers"] = {"case": "pipeline", "mesh": {"pipe": 2}, **_toy(3, 4, 4, 0), "m": 2}
    cases["bad_batch"] = {"case": "pipeline", "mesh": {"pipe": 2}, **_toy(4, 4, 6, 0), "m": 4}
    jm = nnx.eval_shape(lambda: JaxMMDiT(**PIPE, rngs=nnx.Rngs(0)))
    params = _randomize(jm, 5)
    inp = _model_inputs(6)
    cases["model"] = {"case": "model", "mesh": {"pipe": 2}, "config": PIPE, "params": params, **inp}
    handle = launch_ranks(2, cases, tmp_path_factory.mktemp("pipe_ranks"))  # the ranks run while JAX does
    for m, p in toys.items():
        refs[f"toy{m}"] = (_jax_toy(p, m, 2), _jax_toy(p, m, None))
    refs["model_sequential"] = _jax_model(jm, None, inp)
    refs["model"] = _jax_model(jm, jax_make_mesh(JaxMeshConfig(data=1, pipe=2), jax.devices()[:2]), inp)
    return refs, collect(handle), params, inp


@pytest.mark.parametrize("m", [4, 1])
def test_pipeline_apply_matches_jax_and_sequential(ranks, m):
    refs, results, _, _ = ranks
    piped, sequential = refs[f"toy{m}"]
    for key in ("out", "dx", "dw", "db"):
        _close(piped[key], sequential[key], OUT_TOL if key == "out" else GRAD_TOL)  # the JAX engine itself
    for res in results[f"toy{m}"]:  # every rank holds the output and every gradient, the input's too
        for key in ("out", "dx", "dw", "db"):
            _close(res[key], piped[key], OUT_TOL if key == "out" else GRAD_TOL)


@pytest.mark.parametrize("case, message", [("bad_layers", "L=3 not divisible by pipe=2"),
                                           ("bad_batch", "B=6 not divisible by M")])
def test_pipeline_divisibility_errors(ranks, case, message):
    _, results, _, _ = ranks
    for res in results[case]:
        assert message in res["error"]
    p = _toy(3, 4, 4, 0) if case == "bad_layers" else _toy(4, 4, 6, 0)
    with pytest.raises(ValueError, match=message.split(" not")[0]):
        jax_pipeline_apply(_toy_stage, {"w": jnp.asarray(p["w"]), "b": jnp.asarray(p["b"])}, {"x": jnp.asarray(p["x"])},
                           mesh=Mesh(np.asarray(jax.devices()[:2]), ("pipe",)), axis="pipe",
                           n_microbatches=2 if case == "bad_layers" else 4)


def test_pipelined_dit_matches_jax_and_its_sequential_blocks(ranks):
    refs, results, _, _ = ranks
    out, grads = refs["model"]
    seq_out, seq_grads = refs["model_sequential"]
    _close(out, seq_out, OUT_TOL)
    for res in results["model"]:
        _close(res["out"], out, OUT_TOL)
        _close(res["out"], seq_out, OUT_TOL)
        assert set(res["grads"]) == set(grads)
        for name, g in grads.items():
            _close(res["grads"][name], g, GRAD_TOL)
            _close(res["grads"][name], seq_grads[name], GRAD_TOL)


def test_one_process_runs_the_blocks_in_sequence(ranks):
    """Without a mesh, or with pipe=1, the pipelined DiT runs its blocks in
    sequence (the reference's condition pipe > 1); the stacked parameters
    take each block's gradient back."""
    refs, _, params, inp = ranks
    seq_out, seq_grads = refs["model_sequential"]
    model = MMDiT(**PIPE, device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.set_parallel_mesh(make_mesh({"pipe": 1}))
    x, t, y = (torch.from_numpy(inp[k]) for k in ("x", "t", "y"))
    out = model(x, t, {"y": y})["x"]
    (out * torch.from_numpy(inp["r"])).sum().backward()
    _close(out.detach().numpy(), seq_out, OUT_TOL)
    for name, q in model.named_parameters():
        _close(q.grad.numpy(), seq_grads[name], GRAD_TOL)
    stacked = stack_block_params(model.layers)
    assert stacked["attention.qkv.weight"].shape == (2, 192, 64)
    before = model.layers[1].attention.qkv.weight.grad.clone()
    stacked["attention.qkv.weight"].sum().backward()
    torch.testing.assert_close(model.layers[1].attention.qkv.weight.grad - before, torch.ones(192, 64))


def test_pipeline_apply_in_one_process_is_the_sequence():
    """pipeline_apply on a one-process mesh (S = 1) is the layers in sequence."""
    p = _toy(4, 8, 4, seed=9)
    ref = _jax_toy(p, 2, None)
    params = {k: torch.from_numpy(p[k]).requires_grad_() for k in ("w", "b")}
    x = torch.from_numpy(p["x"]).requires_grad_()

    def stage(layer, state):
        return {**state, "x": torch.tanh(state["x"] @ layer["w"] + layer["b"])}

    out = pipeline_apply(stage, params, {"x": x}, mesh=make_mesh({"pipe": 1}), n_microbatches=2)["x"]
    (out * torch.from_numpy(p["r"])).sum().backward()
    for key, ours in (("out", out.detach()), ("dx", x.grad), ("dw", params["w"].grad), ("db", params["b"].grad)):
        _close(ours.numpy(), ref[key], OUT_TOL if key == "out" else GRAD_TOL)
