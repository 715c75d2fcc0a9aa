"""The port's flow samplers (diffulab_tpu_torch.diffuse.samplers) against the
JAX package's, through ``Diffuser.generate`` on the randomised tiny DiT.

Each sampler runs a 6-step grid from the same injected ``x``, with and
without fused CFG (scale 4.0), in fp32 and in the whole-model bf16 cast.
Euler-Maruyama's per-step noise is the reference's own draws (the keys its
scan splits), passed through ``draw_noise`` (trap T4). Tolerances, as max
|port - JAX| over max |JAX|: 1e-5 in fp32, and ``test_torch_port_sampling``'s
4e-2 in bf16. The multistep samplers' rounding points (trap T8: the fp32
data prediction, the state's x0 rounded back to the input dtype, the carry
cast back each step) and ``unipc_bh2_correction`` are held on their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import (
    LATENT,
    POLICIES,
    TINY,
    injected,
    jax_scan_noise,
    port_model,
    randomized_jax_model,
    rel_err,
)

from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.diffuse.samplers.common import unipc_bh2_correction as jax_bh2
from diffulab_tpu.diffuse.samplers.flow import DPMSolverPP2M as JaxDPM
from diffulab_tpu.diffuse.samplers.flow import UniPC as JaxUniPC
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.diffuse.flow import SAMPLER_REGISTRY
from diffulab_tpu_torch.diffuse.samplers import DPMSolverPP2M, UniPC, unipc_bh2_correction

TOL = {"fp32": 1e-5, "bf16_full": 4e-2}
STEPS = 6
SAMPLERS = ("euler_maruyama", "heun", "dpmpp_2m", "unipc")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    out = {}
    for policy in TOL:
        jax_model, params = randomized_jax_model(policy, seed=3)
        out[policy] = (jax_model, port_model(policy, params))
    return out


def _inputs(seed: int = 6):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((3, *LATENT)).astype(np.float32), rng.integers(0, TINY["n_classes"], 3)


@pytest.mark.parametrize("policy", sorted(TOL))
@pytest.mark.parametrize("guidance", [0.0, 4.0])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_sampler_trajectory_matches_jax(models, sampler, guidance, policy):
    jax_model, model = models[policy]
    jdt = POLICIES[policy][0].get("dtype", jnp.float32)
    tdt = POLICIES[policy][1].get("dtype", torch.float32)
    x, y = _inputs()
    key = jax.random.key(5)
    ref = JaxDiffuser(jax_model, sampler, n_steps=STEPS).generate(
        key, {"y": jnp.asarray(y)}, x=jnp.asarray(x, jdt), guidance_scale=guidance, dtype=jdt,
        return_intermediates=True)
    draws = jax_scan_noise(key, STEPS, x.shape, jdt)
    out = Diffuser(model, sampler, n_steps=STEPS).generate(
        {"y": torch.from_numpy(y)}, x=torch.from_numpy(x), guidance_scale=guidance, dtype=tdt, device="cpu",
        return_intermediates=True, draw_noise=injected(draws))
    assert out["x"].dtype == tdt and out["x"].shape == (3, *LATENT)
    assert set(out) == set(ref), (set(out), set(ref))
    for name, value in ref.items():
        value = np.asarray(value, np.float32)
        assert tuple(out[name].shape) == value.shape, name
        assert rel_err(out[name].float().numpy(), value) < TOL[policy], name


def test_euler_maruyama_intermediates_match_jax(models):
    """logprob, xt_mean and xt_std of a stochastic trajectory, fp32, at the
    reference's draws; the layout is batch-major with xt_std per step."""
    jax_model, model = models["fp32"]
    x, y = _inputs(7)
    key = jax.random.key(8)
    ref = JaxDiffuser(jax_model, "euler_maruyama", n_steps=STEPS).generate(
        key, {"y": jnp.asarray(y)}, x=jnp.asarray(x), guidance_scale=4.0, return_intermediates=True)
    out = Diffuser(model, "euler_maruyama", n_steps=STEPS).generate(
        {"y": torch.from_numpy(y)}, x=torch.from_numpy(x), guidance_scale=4.0, device="cpu",
        return_intermediates=True, draw_noise=injected(jax_scan_noise(key, STEPS, x.shape, jnp.float32)))
    assert out["xt"].shape == (3, STEPS + 1, *LATENT) and out["logprob"].shape == (3, STEPS, *LATENT)
    assert out["xt_std"].shape == (STEPS,) and out["xt_mean"].shape == (3, STEPS, *LATENT)
    for name in ("logprob", "xt_mean", "xt_std", "xt", "estimated_x0"):
        assert rel_err(out[name].numpy(), np.asarray(ref[name])) < 1e-5, name
    # re-evaluating the stored transitions gives the stored log-densities (the GRPO ratio is 1)
    sampler = Diffuser(model, "euler_maruyama", n_steps=STEPS).diffusion.sampler
    ts = Diffuser(model, "euler_maruyama", n_steps=STEPS).diffusion.timesteps
    v = torch.from_numpy(np.asarray(ref["xt"][:, 0] - ref["xt"][:, 1], np.float32)) / float(ts[0] - ts[1])
    step = sampler.step(out["xt"][:, 0], v, ts[0], ts[1], x_prev=out["xt"][:, 1])
    assert torch.equal(step["x_prev"], out["xt"][:, 1])


@pytest.mark.parametrize("n_prev", [0, 1, 2])
def test_unipc_bh2_correction_matches_jax(n_prev):
    rng = np.random.default_rng(9 + n_prev)
    m0, m_last, m_last2 = (rng.standard_normal((2, 4, 4, 3)).astype(np.float32) for _ in range(3))
    hh_c, r0c = np.float32(-0.37), np.float32(-0.8)
    ref_phi, ref_corr = jax_bh2(jnp.float32(hh_c), jnp.float32(r0c), jnp.int32(n_prev), jnp.asarray(m0),
                                jnp.asarray(m_last), jnp.asarray(m_last2))
    phi, corr = unipc_bh2_correction(hh_c, r0c, n_prev, *(torch.from_numpy(a) for a in (m0, m_last, m_last2)))
    assert isinstance(phi, np.float32) and corr.dtype == torch.float32
    np.testing.assert_allclose(float(phi), float(ref_phi), rtol=1e-6)
    np.testing.assert_allclose(corr.numpy(), np.asarray(ref_corr), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cls,jax_cls", [(DPMSolverPP2M, JaxDPM), (UniPC, JaxUniPC)])
def test_multistep_state_dtypes_like_jax(cls, jax_cls):
    """bf16 in, over three steps and the final one: the data prediction in
    fp32, the state's tensors rounded back to bf16, the scalars fp32, and the
    step's x_prev cast to the input dtype, each equal to the reference's."""
    rng = np.random.default_rng(12)
    x, v = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    ts = np.array([1.0, 0.8, 0.45, 0.0], np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    jax_s, ours = jax_cls(), cls()
    jstate, tstate = jax_s.init_state(jx), ours.init_state(tx)
    for i in range(3):
        jv, tv = jnp.asarray(v * (i + 1), jnp.bfloat16), torch.from_numpy(v * (i + 1)).bfloat16()
        ref = jax_s.step(jx, jv, jnp.float32(ts[i]), jnp.float32(ts[i + 1]), state=jstate)
        out = ours.step(tx, tv, ts[i], ts[i + 1], state=tstate)
        assert out["x_prev"].dtype == torch.bfloat16 and ref["x_prev"].dtype == jnp.bfloat16
        assert out["estimated_x0"].dtype == {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[
            ref["estimated_x0"].dtype.type]
        for key, value in ref["state"].items():
            if isinstance(out["state"][key], torch.Tensor):
                assert out["state"][key].dtype == torch.bfloat16 and value.dtype == jnp.bfloat16, key
                np.testing.assert_allclose(out["state"][key].float().numpy(), np.asarray(value, np.float32),
                                           rtol=1e-2, atol=1e-2, err_msg=key)
            else:
                np.testing.assert_allclose(float(out["state"][key]), float(value), rtol=1e-6, err_msg=key)
        np.testing.assert_allclose(out["x_prev"].float().numpy(), np.asarray(ref["x_prev"], np.float32),
                                   rtol=1e-2, atol=1e-2)
        jx, tx, jstate, tstate = ref["x_prev"], out["x_prev"], ref["state"], out["state"]
    # the final step (t_prev = 0) is first order and returns the data prediction exactly
    assert torch.equal(out["x_prev"], out["estimated_x0"].to(torch.bfloat16))


def test_registry_has_every_sampler_of_the_reference():
    from diffulab_tpu.diffuse.flow import SAMPLER_REGISTRY as JAX_REGISTRY

    assert set(SAMPLER_REGISTRY) == set(JAX_REGISTRY)
    for name, cls in SAMPLER_REGISTRY.items():
        assert cls.name == JAX_REGISTRY[name].name == name
