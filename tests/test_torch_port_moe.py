"""The port's switch-MoE (diffulab_tpu_torch/parallel/moe.py, the MMDiT's
MoEMlp) against the JAX package's parallel/moe.py.

Single process: ``route_top1`` (dispatch and combine exact), ``moe_mlp_local``
(output, aux, every gradient) and the MoE DiT with its parameter tree.
Two gloo processes (tests/_torch_port_ranks.py): ``expert_parallel_mlp`` at
``expert=2`` and the tiny MoE DiT on an ``expert=2`` mesh, each against the
JAX function on a 2-device mesh of the same shape, run here.

Traps pinned: T2 (the experts' GELU is the tanh one; the erf GELU misses by
far more than the tolerance), T29 (the capacity comes from each rank's 1/n
of the tokens: at capacity factor 0.5 the two-rank run drops other tokens
than one device would, and matches JAX's), T30 (the router's and the
replicated weights' gradients, summed over the ranks' token shards; the
experts' whole on every rank).

Tolerances: fp32 outputs 1e-5 of max |ref| (one-hot sums against gathers:
the same terms, summed in another order in the FFN's matmuls; measured
~1e-7), gradients 1e-4 of each tensor's max |ref| (the JAX gradient through
the dense [T, E, C] einsums sums its zeros too); routing exact.
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
from diffulab_tpu.parallel import moe as jmoe
from diffulab_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from diffulab_tpu.parallel.mesh import make_mesh as jax_make_mesh
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT, MoEMlp
from diffulab_tpu_torch.parallel import moe as tmoe
from diffulab_tpu_torch.weights import state_dict_from_jax

OUT_TOL, GRAD_TOL = 1e-5, 1e-4
E, D, H = 4, 8, 16
MOE = dict(TINY, mlp_type="moe", n_experts=4, capacity_factor=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return {"w_in": (rng.standard_normal((E, D, H)) * D ** -0.5).astype(np.float32),
            "w_out": (rng.standard_normal((E, H, D)) * H ** -0.5).astype(np.float32),
            "w_gate": rng.standard_normal((D, E)).astype(np.float32)}


def _jax_mlp(w):
    mlp = jmoe.ExpertMlp(E, D, H, rngs=nnx.Rngs(0))
    for k, v in w.items():
        getattr(mlp, k)[...] = jnp.asarray(v)
    return mlp


def _port_mlp(w):
    mlp = tmoe.ExpertMlp(E, D, H, device="cpu")
    with torch.no_grad():
        for k, v in w.items():
            getattr(mlp, k).copy_(torch.from_numpy(v))
    return mlp


def _inputs(seed, b=4, s=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, D)).astype(np.float32), rng.standard_normal((b, s, D)).astype(np.float32))


def _close(ours, ref, tol):
    ref = np.asarray(ref, np.float32)
    assert np.max(np.abs(np.asarray(ours) - ref)) <= tol * max(np.max(np.abs(ref)), 1e-6)


def _jax_moe(fn, w, x, r, lb_coeff):
    """(y, aux, grads) of a JAX MoE call ``fn(mlp, x)``, the loss sum(y r) + c lb."""
    mlp = _jax_mlp(w)
    graphdef, state = nnx.split(mlp)

    def loss(state, x):
        y, aux = fn(nnx.merge(graphdef, state), x)
        return jnp.sum(y * r) + lb_coeff * aux["load_balance_loss"], (y, aux)

    (_, (y, aux)), (gs, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(state, jnp.asarray(x))
    grads = {k: np.asarray(gs[k].get_value()) for k in ("w_in", "w_out", "w_gate")}
    return np.asarray(y), {k: float(v) for k, v in aux.items()}, {**grads, "x": np.asarray(gx)}


# --- single process ---------------------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [1, 3, 8])
def test_route_top1_matches_jax_exactly(capacity):
    logits = np.random.default_rng(capacity).standard_normal((16, E)).astype(np.float32)
    logits[3] = logits[5]  # equal rows and a tie: the first maximum wins on both sides
    logits[7, :2] = logits[7].max() + 1.0
    jd, jc = jmoe.route_top1(jnp.asarray(logits), capacity)
    td, tc = tmoe.route_top1(torch.from_numpy(logits), capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-7)
    assert td.sum() == min(16, capacity * E) or td.sum() < 16  # dropped tokens have no slot


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_moe_mlp_local_output_aux_and_gradients(capacity_factor):
    w = _weights(1)
    x, r = _inputs(2)
    y, aux, grads = _jax_moe(lambda m, x: jmoe.moe_mlp_local(m, x, capacity_factor), w, x, r, 0.3)
    mlp = _port_mlp(w)
    xt = torch.from_numpy(x).requires_grad_()
    ty, taux = tmoe.moe_mlp_local(mlp, xt, capacity_factor)
    ((ty * torch.from_numpy(r)).sum() + 0.3 * taux["load_balance_loss"]).backward()
    _close(ty.detach().numpy(), y, OUT_TOL)
    for k, v in aux.items():
        assert abs(float(taux[k].detach()) - v) <= 1e-5 * max(abs(v), 1.0), k
    tgrads = {"x": xt.grad, **{k: getattr(mlp, k).grad for k in ("w_in", "w_out", "w_gate")}}
    for k, g in grads.items():
        _close(tgrads[k].numpy(), g, GRAD_TOL)


def test_expert_gelu_is_the_tanh_one():
    """T2: jax.nn.gelu defaults to the tanh approximation; the exact (erf)
    GELU would miss the reference by more than the tolerance."""
    w = _weights(3)
    bins = np.random.default_rng(4).standard_normal((E, 5, D)).astype(np.float32) * 3
    ref = np.asarray(_jax_mlp(w).ffn(jnp.asarray(w["w_in"]), jnp.asarray(w["w_out"]), jnp.asarray(bins)))
    ours = tmoe.ExpertMlp.ffn(*(torch.from_numpy(w[k]) for k in ("w_in", "w_out")), torch.from_numpy(bins))
    _close(ours.numpy(), ref, OUT_TOL)
    h = torch.bmm(torch.from_numpy(bins), torch.from_numpy(w["w_in"]))
    erf = torch.bmm(torch.nn.functional.gelu(h), torch.from_numpy(w["w_out"]))
    assert float((erf - torch.from_numpy(ref)).abs().max()) > 10 * OUT_TOL * float(np.abs(ref).max())


def test_moe_dit_parameter_tree_and_forward():
    """The MoE DiT (model=dit_moe's options at a tiny width): the JAX
    parameter tree bridged one to one, MoEMlp in every block, the dense
    forward equal to JAX's, the load-balance loss kept as the reference sows it."""
    jm = nnx.eval_shape(lambda: JaxMMDiT(**MOE, rngs=nnx.Rngs(0)))
    params = _randomize(jm, 5)
    tm = MMDiT(**MOE, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    assert all(isinstance(b.mlp_input, MoEMlp) for b in tm.layers)
    assert tm.layers[0].mlp_input.experts.w_in.shape == (4, 64, 256)
    rng = np.random.default_rng(6)
    x, t = rng.standard_normal((4, *LATENT)).astype(np.float32), rng.uniform(size=4).astype(np.float32)
    y = rng.integers(0, 10, 4)
    graphdef, state = nnx.split(jm)
    ref = np.asarray(jax.jit(lambda st, *a: nnx.merge(graphdef, st)(a[0], a[1], {"y": a[2]})["x"])(
        state, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t), {"y": torch.from_numpy(y)})["x"]
    _close(out.numpy(), ref, OUT_TOL)
    assert all(float(b.mlp_input.load_balance_loss) >= 1.0 - 1e-6 for b in tm.layers)  # E sum f P >= 1


# --- two processes ----------------------------------------------------------------------------------


def _model_inputs(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((4, *LATENT)).astype(np.float32), "t": rng.uniform(size=4).astype(np.float32),
            "y": rng.integers(0, 10, 4), "r": rng.standard_normal((4, *LATENT)).astype(np.float32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX references and the two-rank results of every case."""
    devices = jax.devices()[:2]
    refs, cases = {}, {}
    w = _weights(7)
    x, r = _inputs(8)
    for cf in (2.0, 0.5):
        cases[f"ep{cf}"] = {"case": "moe", "mesh": {"expert": 2}, **w, "x": x, "r": r, "capacity_factor": cf,
                            "lb_coeff": 0.3}
    jm = nnx.eval_shape(lambda: JaxMMDiT(**MOE, rngs=nnx.Rngs(0)))
    params = _randomize(jm, 9)
    inp = _model_inputs(10)
    cases["model"] = {"case": "model", "mesh": {"expert": 2}, "config": MOE, "params": params, **inp}
    handle = launch_ranks(2, cases, tmp_path_factory.mktemp("moe_ranks"))  # the ranks run while JAX does
    for cf in (2.0, 0.5):
        mesh = Mesh(np.asarray(devices), ("expert",))
        refs[f"ep{cf}"] = _jax_moe(lambda m, x: jmoe.expert_parallel_mlp(m, x, mesh=mesh, axis="expert",
                                                                          capacity_factor=cf), w, x, r, 0.3)
        refs[f"local{cf}"] = _jax_moe(lambda m, x: jmoe.moe_mlp_local(m, x, cf), w, x, r, 0.3)
    jm.set_parallel_mesh(jax_make_mesh(JaxMeshConfig(data=1, expert=2), devices))
    graphdef, jparams, rest = nnx.split(jm, nnx.Param, ...)

    def loss(jparams):
        out = nnx.merge(graphdef, jparams, rest)(jnp.asarray(inp["x"]), jnp.asarray(inp["t"]),
                                                {"y": jnp.asarray(inp["y"])})["x"]
        return jnp.sum(out * inp["r"]), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams)
    flat = {"/".join(str(k) for k in path): np.asarray(v.get_value()) for path, v in g.flat_state()}
    refs["model"] = (np.asarray(out), {k: v.numpy() for k, v in state_dict_from_jax(flat).items()})
    return refs, collect(handle)


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_expert_parallel_matches_jax(ranks, cf):
    refs, results = ranks
    y, aux, grads = refs[f"ep{cf}"]
    for res in results[f"ep{cf}"]:  # every rank holds the whole output and every gradient
        _close(res["y"], y, OUT_TOL)
        for k, v in aux.items():
            assert abs(float(res["aux"][k]) - v) <= 1e-5 * max(abs(v), 1.0), k
        for k, g in grads.items():
            _close(res["grads"][k], g, GRAD_TOL)


def test_capacity_is_local_under_expert_parallelism(ranks):
    """T29: at capacity factor 0.5 each rank's capacity is that of its 16 of
    32 tokens, so the two-rank output differs from the one-device one (other
    tokens dropped) and equals the JAX expert-parallel one; at 2.0 nothing
    is dropped either way and the two agree."""
    refs, results = ranks
    assert np.max(np.abs(refs["ep0.5"][0] - refs["local0.5"][0])) > 1e-3
    _close(results["ep0.5"][0]["y"], refs["ep0.5"][0], OUT_TOL)
    _close(refs["ep2.0"][0], refs["local2.0"][0], OUT_TOL)


def test_moe_dit_on_expert_mesh_matches_jax(ranks):
    """T30: the tiny MoE DiT at expert=2 (capacity factor 1.0), every
    parameter's gradient (router, experts, replicated weights) against JAX's
    on the same mesh, on both ranks."""
    refs, results = ranks
    out, grads = refs["model"]
    for res in results["model"]:
        _close(res["out"], out, OUT_TOL)
        assert set(res["grads"]) == set(grads)
        for name, g in grads.items():
            _close(res["grads"][name], g, GRAD_TOL)
