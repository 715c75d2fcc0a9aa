"""The port's mesh, sharding and multi-process training
(diffulab_tpu_torch/parallel/{mesh,sharding}.py, the trainers on a mesh,
the loader's process slices) against the JAX package.

One process: ``MeshConfig.resolve`` and its errors; each parameter's mesh
axes against ``get_param_shardings``; the loader's slices against the JAX
loader's ``process_index``/``process_count``.

Two and four gloo processes (tests/_torch_port_ranks.py):

- one train step of the tiny DiT at ``data=2``, ``fsdp=2``, ``tensor=2``
  and ``fsdp=2 x tensor=2``, against the JAX step on a mesh of the same
  shape (the same injected global draws, AdamW under a global-norm clip that
  binds: trap T11 under shards): the loss and every updated parameter,
  gathered whole, and each weight's placement (FSDP2 along "embed", the
  tensor shards by head: T27);
- ``BaseTrainer.train`` (2 steps, EMA, a validation epoch and its
  checkpoints) at ``data=2`` and at ``fsdp=2 x tensor=2`` against the same
  run in one process: each process draws t, noise and the drop mask for the
  global batch and keeps its rows (T28), so the parameters agree; the loader
  gives each process its ``(data, fsdp)`` slice; the checkpoint, written
  whole by rank 0, loads bitwise into a one-process model, and its EMA entry
  goes back into the shards and gathers back bitwise;
- one ``GRPOTrainer`` batch (4 prompts x 2 images, the luma judge, two
  learn steps) at ``data=2`` and in one process, both against the JAX
  ``GRPOTrainer`` on a ``data=2`` mesh of 2 devices with the same bridged
  weights and prompts; the port is handed the JAX trainer's draws for the
  global batch (``x_init``, each step's SDE noise, the learn indices, from
  its keys), of which each process keeps its rows (T28): the parameters and
  every ``train/*`` mean, ``ratio_dev`` and ``grad_norm`` included.

Tolerances: the loss 1e-5 relative; parameters after AdamW updates at lr
1e-3 within 2e-5 absolute (2% of lr, as tests/test_torch_port_training.py:
where |g| is near Adam's eps, fp32 summation order moves the first update),
5e-5 after the GRPO batch against JAX and the logged means within 1e-4
relative (tests/test_torch_port_grpo.py's tolerances for the same trainer).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_port_common import (
    LATENT,
    TINY,
    TINY_MM,
    _randomize,
    jax_scan_noise,
    null_embedding,
    port_mmdit,
    randomized_jax_mmdit,
)
from _torch_port_ranks import collect, launch_ranks, run_grpo
from flax import nnx

from diffulab_tpu.data.loader import DataLoader as JaxDataLoader
from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.networks.denoisers.mmdit import MMDiT as JaxMMDiT
from diffulab_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from diffulab_tpu.parallel.mesh import make_mesh as jax_make_mesh
from diffulab_tpu.parallel.sharding import batch_sharding as jax_batch_sharding
from diffulab_tpu.networks.rewards import grpo as jgrpo
from diffulab_tpu.parallel.sharding import get_param_shardings
from diffulab_tpu.training import optim as joptim
from diffulab_tpu.training.grpo_trainer import GRPOTrainer as JaxGRPOTrainer
from diffulab_tpu_torch.data.loader import DataLoader
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.parallel.mesh import MeshConfig
from diffulab_tpu_torch.parallel.sharding import param_specs
from diffulab_tpu_torch.training import optim as toptim
from diffulab_tpu_torch.training.checkpoint import restore_checkpoint, restore_train_modules
from diffulab_tpu_torch.training.trainer import BaseTrainer
from diffulab_tpu_torch.weights import state_dict_from_jax

LOSS_TOL, UPDATE_ATOL = 1e-5, 2e-5
GRPO_UPDATE_ATOL, METRIC_TOL = 5e-5, 1e-4
#: train_grpo_alignment's block layout (dual-stream only) at the tiny widths, on 8x8 RGB images
GRPO_CFG = dict(depth=2, n_single_stream_blocks=0, input_channels=3, patch_size=2)
GRPO_PROMPTS, GRPO_IMAGES, GRPO_STEPS, GRPO_FRACTION, GRPO_SEED = 4, 2, 4, 0.5, 5
LR, CLIP, GLOBAL_BATCH = 1e-3, 0.5, 8
STEP_MESHES = {"data2": (2, {"data": 2}), "fsdp2": (2, {"data": 1, "fsdp": 2}),
               "tensor2": (2, {"data": 1, "tensor": 2}), "fsdp2_tensor2": (4, {"data": 1, "fsdp": 2, "tensor": 2})}
TRAINER_MESHES = {"data2": (2, {"data": 2}), "fsdp2_tensor2": (4, {"data": 1, "fsdp": 2, "tensor": 2})}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _no_wandb():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "wandb", None)
        yield


# --- one process ------------------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs, n", [(dict(data=-1, fsdp=2, tensor=2), 8), (dict(data=8), 8),
                                       (dict(data=-1, expert=2), 4), (dict(sp=2, pipe=2), 4), (dict(), 1)])
def test_mesh_config_resolves_like_jax(kwargs, n):
    assert MeshConfig(**kwargs).resolve(n) == JaxMeshConfig(**kwargs).resolve(n)


@pytest.mark.parametrize("kwargs, n", [(dict(fsdp=3), 8), (dict(data=3, fsdp=2), 8), (dict(tensor=2), 1),
                                       (dict(data=2), 1)])
def test_mesh_config_errors_like_jax(kwargs, n):
    with pytest.raises(AssertionError) as ref:
        JaxMeshConfig(**kwargs).resolve(n)
    with pytest.raises(AssertionError) as ours:
        MeshConfig(**kwargs).resolve(n)
    assert str(ours.value) == str(ref.value)


def _jax_spec(sharding, ndim):
    spec = tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))
    return tuple(a if a is None or isinstance(a, str) else a[0] for a in spec)


@pytest.mark.parametrize("shape", [dict(fsdp=2, tensor=2), dict(tensor=2), dict(fsdp=2), dict(data=4),
                                   dict(fsdp=2, tensor=2, mm=True)])
def test_param_placements_follow_get_param_shardings(shape):
    """Every parameter's mesh axes (the reference's [in, out] kernel
    layout, size-1 axes dropped) equal the JAX NamedShardings', the DiT's
    and the multimodal MMDiT's (dual- and single-stream blocks)."""
    shape = dict(shape)
    mm = shape.pop("mm", False)
    n = int(np.prod(list(shape.values())))
    cfg = {k: shape.get(k, 1) for k in ("data", "fsdp", "tensor")}
    if mm:
        from diffulab_tpu.networks.embedders.precomputed import PrecomputedEmbedder as JaxEmbedder
        from diffulab_tpu_torch.networks.embedders import PrecomputedEmbedder

        jm = nnx.eval_shape(lambda: JaxMMDiT(**TINY_MM, context_embedder=JaxEmbedder(null_embedding=null_embedding()),
                                             rngs=nnx.Rngs(0)))
        tm = MMDiT(**TINY_MM, context_embedder=PrecomputedEmbedder(null_embedding=null_embedding(), device="meta"), device="meta")
    else:
        jm = nnx.eval_shape(lambda: JaxMMDiT(**TINY, rngs=nnx.Rngs(0)))
        tm = MMDiT(**TINY, device="meta")
    _, params, _ = nnx.split(jm, nnx.Param, ...)
    shardings = get_param_shardings(params, jax_make_mesh(JaxMeshConfig(**cfg), jax.devices()[:n]))
    ref = {"/".join(str(k) for k in path): _jax_spec(sh, np.ndim(v.get_value()))
           for (path, v), (_, sh) in zip(params.flat_state(), jax.tree_util.tree_flatten_with_path(shardings)[0])}
    ours = param_specs(tm, cfg)
    names = {k: n for k, n in zip(ref, state_dict_from_jax({k: np.zeros((1,) * len(v)) for k, v in ref.items()}))}
    assert {names[k]: v for k, v in ref.items()} == {k: v for k, v in ours.items() if k in names.values()}
    sharded = [k for k, v in ours.items() if any(v)]
    assert sharded and all(k.endswith(("qkv.weight", "qkv_input.weight", "qkv_context.weight", "proj_out.weight",
                                       "fc_in.weight", "fc_out.weight")) for k in sharded) or cfg["fsdp"] == cfg[
        "tensor"] == 1


def test_a_dtensor_never_reaches_an_attention_kernel():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from diffulab_tpu_torch.ops import dot_product_attention

    q = torch.zeros(1, 4, 2, 16)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("tensor",))
        with pytest.raises(TypeError, match="local tensors"):
            dot_product_attention(distribute_tensor(q, mesh["tensor"], [Replicate()]), q, q)
    finally:
        dist.destroy_process_group()
    assert dot_product_attention(q, q, q).shape == q.shape


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("count", [1, 2, 4])
def test_loader_slices_match_the_jax_loader(count, drop_last):
    """batch_size is global; each process draws the same order and keeps
    its contiguous slice, a short last batch trimmed to a multiple of the
    process count (and dropped below it)."""
    class Idx:
        def __len__(self):
            return 22

        def __getitem__(self, i):
            return {"i": np.int64(i)}

    for index in range(count):
        kw = dict(batch_size=8, shuffle=True, seed=3, drop_last=drop_last, prefetch=0, process_index=index,
                  process_count=count)
        ours, ref = DataLoader(Idx(), **kw), JaxDataLoader(Idx(), **kw)
        got = [b["i"].tolist() for b in ours]
        assert got == [b["i"].tolist() for b in ref] and len(ours) == len(ref) == len(got)


# --- the JAX step on a mesh -------------------------------------------------------------------------


def _step_inputs(seed):
    rng = np.random.default_rng(seed)
    return {"x0": rng.standard_normal((GLOBAL_BATCH, *LATENT)).astype(np.float32),
            "y": rng.integers(0, 10, GLOBAL_BATCH), "t": rng.uniform(size=GLOBAL_BATCH).astype(np.float32),
            "noise": rng.standard_normal((GLOBAL_BATCH, *LATENT)).astype(np.float32),
            "drop": rng.uniform(size=GLOBAL_BATCH) < 0.3}


def _jax_step(jm, mesh_kw, n, inp):
    """The loss, the global gradient norm and the updated parameters of one
    AdamW step (under the clip) of the JAX model on a mesh of n devices."""
    mesh = jax_make_mesh(JaxMeshConfig(**mesh_kw), jax.devices()[:n])
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)
    params = jax.tree.map(jax.device_put, params, get_param_shardings(params, mesh))
    opt = joptim.adamw(lr=LR, grad_clip_norm=CLIP)
    opt_state = opt.init(params)
    diffusion = JaxDiffuser(jm, "euler", n_steps=4).diffusion
    batch = {k: jax.device_put(jnp.asarray(v), jax_batch_sharding(mesh)) for k, v in inp.items()}

    def step(params, opt_state, batch):
        def loss_fn(params):
            model = nnx.merge(graphdef, params, rest)
            return diffusion.compute_loss(lambda **kw: model(**kw, train=True), batch["x0"], {"y": batch["y"]},
                                          batch["t"], batch["noise"], drop=batch["drop"])["loss"]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), loss, optax.global_norm(grads)

    params, loss, norm = jax.jit(step)(params, opt_state, batch)
    flat = {"/".join(str(k) for k in path): np.asarray(v.get_value()) for path, v in params.flat_state()}
    return float(loss), float(norm), {k: v.numpy() for k, v in state_dict_from_jax(flat).items()}


class _Data:
    def __init__(self, x, y):
        self.x, self.y = x, y

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"model_inputs": {"x": self.x[i], "y": self.y[i]}}


def _trainer_payload(params, save):
    rng = np.random.default_rng(21)
    return {"case": "trainer", "config": TINY, "params": params, "x": rng.standard_normal((16, *LATENT)).astype(
        np.float32), "y": rng.integers(0, 10, 16), "epochs": 1, "batch": GLOBAL_BATCH, "accum": 1, "seed": 4,
        "clip": CLIP, "images": False, "save": str(save)}


def _one_process_trainer(p):
    model = MMDiT(**TINY, device="cpu")
    model.load_state_dict(state_dict_from_jax(p["params"]), strict=True)
    trainer = BaseTrainer(n_epoch=p["epochs"], save_path=p["save"], device="cpu", use_ema=True, ema_update_every=1,
                          async_checkpointing=False, posthoc_ema=True)
    trainer.train(Diffuser(model, "euler", n_steps=2), toptim.adamw(lr=1e-3, grad_clip_norm=p["clip"]),
                  DataLoader(_Data(p["x"], p["y"]), batch_size=p["batch"], seed=p["seed"], prefetch=0),
                  DataLoader(_Data(p["x"], p["y"]), batch_size=p["batch"], shuffle=False, prefetch=0),
                  log_validation_images=False, val_steps=2, seed=p["seed"])
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _jax_grpo_draws(shape, k):
    """The JAX trainer's draws for its first train batch (key ``fold_in(key(seed), 0)``): ``x_init`` under
    0, each group's SDE noise under ``100 + g * 4096`` (its one chunk) and its learn indices under ``200 + g``."""
    rng = jax.random.fold_in(jax.random.key(GRPO_SEED), 0)
    return {"x_init": np.asarray(jax.random.normal(jax.random.fold_in(rng, 0), shape), np.float32),
            "noise": [jax_scan_noise(jax.random.fold_in(rng, 100 + g * 4096), GRPO_STEPS, shape, jnp.float32)
                      for g in range(GRPO_IMAGES)],
            "indices": [np.asarray(jax.random.choice(jax.random.fold_in(rng, 200 + g), GRPO_STEPS, shape=(k,),
                                                     replace=False)).tolist() for g in range(GRPO_IMAGES)]}


def _grpo_case():
    """The JAX model with seeded weights and the port's payload: the same
    weights bridged, the prompts, and the JAX trainer's draws."""
    jm, params = randomized_jax_mmdit("fp32", seed=31, **GRPO_CFG)
    state = {k: v.numpy() for k, v in port_mmdit("fp32", params, **GRPO_CFG).state_dict().items()}
    rng = np.random.default_rng(31)
    emb = rng.standard_normal((GRPO_PROMPTS, 8, 32)).astype(np.float32)
    mask = np.arange(8)[None, :] < (np.arange(GRPO_PROMPTS) * 3 % 8 + 2)[:, None]
    payload = {"case": "grpo", "mesh": {"data": 2}, "config": {**TINY_MM, **GRPO_CFG}, "state": state,
               "null": null_embedding(), "emb": emb, "mask": mask,
               "captions": [f"prompt {i}" for i in range(GRPO_PROMPTS)],
               "draws": _jax_grpo_draws((GRPO_PROMPTS, 8, 8, 3), round(GRPO_STEPS * GRPO_FRACTION))}
    return jm, payload


def _jax_grpo(jm, p, save):
    """The JAX GRPOTrainer's batch on a data=2 mesh of 2 devices: the parameters (the port's names) and
    the logged train/* means."""
    trainer = JaxGRPOTrainer(n_epoch=1, save_path=save, project_name="grpo", use_ema=False,
                             timestep_fraction=GRPO_FRACTION, kl_beta=0.1, eps=0.1, trust_region=0.3,
                             async_checkpointing=False)
    trainer.mesh = jax_make_mesh(JaxMeshConfig(data=2), jax.devices()[:2])
    batch = {"model_inputs": {"context": {"embeddings": jnp.asarray(p["emb"]), "attn_mask": jnp.asarray(p["mask"])}},
             "extra": {"captions": p["captions"]}}
    trainer.train(JaxDiffuser(jm, "euler_maruyama", n_steps=GRPO_STEPS),
                  reward_model=jgrpo.PrefGRPORewardModel(n_image_per_prompt=GRPO_IMAGES, judge=jgrpo.LumaJudge()),
                  optimizer=joptim.adamw(lr=1e-3, weight_decay=1e-2), train_dataloader=[batch], val_dataloader=None,
                  n_image_per_prompt=GRPO_IMAGES, guidance_scale=1.5, image_resolution=(8, 8),
                  log_validation_images=False, seed=GRPO_SEED)
    _, params, _ = nnx.split(jm, nnx.Param, ...)
    flat = {"/".join(str(k) for k in path): np.asarray(v.get_value()) for path, v in params.flat_state()}
    rows = [json.loads(line) for line in (Path(save) / "grpo" / "metrics.jsonl").read_text().splitlines()]
    return {"params": {k: v.numpy() for k, v in state_dict_from_jax(flat).items()},
            "metrics": {k: v for row in rows for k, v in row.items() if k.startswith("train/")}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jm = nnx.eval_shape(lambda: JaxMMDiT(**TINY, rngs=nnx.Rngs(0)))
    params = _randomize(jm, 11)
    inp = _step_inputs(12)
    grpo_jm, grpo_payload = _grpo_case()
    launched = []
    for world in (2, 4):  # both worlds run at once, while the references are computed here
        cases = {name: {"case": "train_step", "mesh": kw, "config": TINY, "params": params, "lr": LR, "clip": CLIP,
                        **inp} for name, (n, kw) in STEP_MESHES.items() if n == world}
        for name, (n, kw) in TRAINER_MESHES.items():
            if n == world:
                cases[f"trainer_{name}"] = {**_trainer_payload(params, tmp_path_factory.mktemp(name)), "mesh": kw}
        if world == 2:
            cases["grpo"] = {**grpo_payload, "save": str(tmp_path_factory.mktemp("grpo2"))}
        launched.append(launch_ranks(world, cases, tmp_path_factory.mktemp(f"parallel{world}")))
    refs = {name: _jax_step(jm, kw, n, inp) for name, (n, kw) in STEP_MESHES.items()}
    refs["grpo"] = _jax_grpo(grpo_jm, grpo_payload, tmp_path_factory.mktemp("grpo_jax"))
    one_payload = _trainer_payload(params, tmp_path_factory.mktemp("one"))
    one = {"params": _one_process_trainer(one_payload), "save": one_payload["save"]}
    grpo_one = run_grpo({**grpo_payload, "mesh": None, "save": str(tmp_path_factory.mktemp("grpo1"))})
    results = {}
    for handle in launched:
        results.update(collect(handle))
    return refs, results, one, grpo_one


@pytest.mark.parametrize("name", sorted(STEP_MESHES))
def test_sharded_train_step_matches_jax(ranks, name):
    refs, results, _, _ = ranks
    loss, norm, params = refs[name]
    assert norm > CLIP  # the clip binds, over the whole gradient (T11)
    for res in results[name]:
        assert abs(res["loss"] - loss) <= LOSS_TOL * abs(loss)
        assert set(res["params"]) == set(params)
        for k, v in params.items():
            np.testing.assert_allclose(res["params"][k], v, atol=UPDATE_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", sorted(STEP_MESHES))
def test_weights_are_placed_on_their_axes(ranks, name):
    """FSDP2 shards "embed" (a column-parallel weight's input columns, a
    row-parallel one's output rows) over (data, fsdp); tensor parallelism
    shards the output rows of qkv and MLP-in (by head, T27) and the input
    columns of the projections and MLP-out; everything else is a plain,
    replicated tensor."""
    _, results, _, _ = ranks
    _, kw = STEP_MESHES[name]
    for res in results[name]:
        for k, placement in res["placements"].items():
            col = k.endswith(("qkv.weight", "fc_in.weight"))
            row = k.endswith(("proj_out.weight", "fc_out.weight"))
            want = []
            if kw.get("fsdp", 1) > 1 and (col or row):
                want += ["Replicate()", f"Shard(dim={1 if col else 0})"]
            if kw.get("tensor", 1) > 1 and (col or row):
                want += [f"Shard(dim={0 if col else 1})"]
            assert placement == ("plain" if not want else f"({', '.join(want)}{',' if len(want) == 1 else ''})"), k


@pytest.mark.parametrize("name", sorted(TRAINER_MESHES))
def test_sharded_trainer_equals_one_process(ranks, name):
    """T28: every process draws for the global batch and keeps its rows; the
    loader gives it its (data, fsdp) slice of the same shuffled order."""
    _, results, one, _ = ranks
    n, kw = TRAINER_MESHES[name]
    count = kw.get("data", 1) * kw.get("fsdp", 1)
    firsts = set()
    for rank, res in enumerate(results[f"trainer_{name}"]):
        assert res["step"] == 2
        index = rank // kw.get("tensor", 1)  # the (data, fsdp) coordinate: the tensor ranks share a slice
        assert res["slice"] == [index, count] or res["slice"] == (index, count)
        assert len(res["first_batch"]) == GLOBAL_BATCH // count
        firsts.add(tuple(res["first_batch"]))
        for k, v in one["params"].items():
            np.testing.assert_allclose(res["params"][k], v, atol=UPDATE_ATOL, rtol=0, err_msg=k)
    assert len(firsts) == count and len(set().union(*firsts)) == GLOBAL_BATCH


@pytest.mark.parametrize("name", sorted(TRAINER_MESHES))
def test_sharded_checkpoint_round_trip(ranks, name):
    """Rank 0 writes the checkpoints whole: the denoiser entry loads bitwise
    into a one-process model; the EMA entry and the optimizer's moments,
    put back into the shards as a resume does and gathered, are bitwise
    what was written."""
    _, results, _, _ = ranks
    res = results[f"trainer_{name}"][0]
    path = Path(res["save"]) / "my_project" / "checkpoints"
    model = MMDiT(**TINY, device="cpu")
    restore_train_modules(path / "denoiser", model)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), res["params"][k], err_msg=k)
    ema = restore_checkpoint(path / "ema")["params"]
    assert set(ema) == set(res["ema_restored"])
    for k, v in ema.items():
        np.testing.assert_array_equal(v.numpy(), res["ema_restored"][k], err_msg=k)
    moments = restore_checkpoint(path / "optimizer")["opt_state"]["optimizer"]["state"]
    names = [n for n, _ in model.named_parameters()]
    assert [tuple(m["exp_avg"].shape) for _, m in sorted(moments.items())] == [tuple(q.shape)
                                                                               for q in model.parameters()]
    for i, m in moments.items():  # a resume puts them back into the shards: gathered again, bitwise
        np.testing.assert_array_equal(res["moments_restored"][names[int(i)]], m["exp_avg"].numpy())


@pytest.mark.parametrize("name", sorted(TRAINER_MESHES))
def test_sharded_posthoc_ema_snapshots_equal_one_process(ranks, name):
    """The post-hoc EMA tracks live on the shards; their fp16 snapshots,
    written whole by rank 0, are the one-process run's (within fp16's
    rounding of values the updates moved by up to 2e-5)."""
    _, results, one, _ = ranks
    ours = sorted((Path(results[f"trainer_{name}"][0]["save"]) / "my_project" / "checkpoints" / "phema").iterdir())
    ref = sorted((Path(one["save"]) / "my_project" / "checkpoints" / "phema").iterdir())
    assert [p.name for p in ours] == [p.name for p in ref] and len(ours) == 2  # one snapshot a gamma
    for a, b in zip(ours, ref):
        sa, sb = restore_checkpoint(a)["params"], restore_checkpoint(b)["params"]
        assert set(sa) == set(sb)
        for k in sa:
            assert sa[k].dtype == torch.float16
            np.testing.assert_allclose(sa[k].float().numpy(), sb[k].float().numpy(), atol=2e-3, rtol=0, err_msg=k)


def test_grpo_batch_at_data2_equals_one_process(ranks):
    """Each process samples, rewards and learns on its 2 of the 4 prompts,
    with its rows of the global draws; gradients and ratio_dev are the global
    batch's, so two learn steps end where one process ends."""
    _, results, _, grpo_one = ranks
    for res in results["grpo"]:
        assert res["step"] == grpo_one["step"] == 2
        for k, v in grpo_one["params"].items():
            np.testing.assert_allclose(res["params"][k], v, atol=UPDATE_ATOL, rtol=0, err_msg=k)
    ours = {k: v for row in results["grpo"][0]["metrics"] for k, v in row.items() if k.startswith("train/")}
    ref = {k: v for row in grpo_one["metrics"] for k, v in row.items() if k.startswith("train/")}
    assert ours.keys() == ref.keys() and all(abs(ours[k] - ref[k]) <= 1e-4 * max(abs(ref[k]), 1.0) for k in ref)
    # the tracker is rank 0's: one process's rows in the run's metrics.jsonl
    assert len(results["grpo"][0]["metrics"]) == len(grpo_one["metrics"])


@pytest.mark.parametrize("run", ["one_process", "data2"])
def test_grpo_batch_matches_the_jax_trainer_on_a_data2_mesh(ranks, run):
    """The port's GRPO batch, in one process and at data=2, against the JAX
    GRPOTrainer on a data=2 mesh: the updated parameters and every train/*
    mean (the loss, clip_frac, ratio_dev, grad_norm, the reward means)."""
    refs, results, _, grpo_one = ranks
    ref = refs["grpo"]
    runs = [grpo_one] if run == "one_process" else results["grpo"]
    for res in runs:
        assert set(res["params"]) == set(ref["params"])
        for k, v in ref["params"].items():
            np.testing.assert_allclose(res["params"][k], v, atol=GRPO_UPDATE_ATOL, rtol=0, err_msg=k)
    ours = {k: v for row in runs[0]["metrics"] for k, v in row.items() if k.startswith("train/")}
    assert ours.keys() == ref["metrics"].keys() and {"train/ratio_dev", "train/grad_norm"} <= set(ours)
    for k, v in ref["metrics"].items():
        assert abs(ours[k] - v) <= METRIC_TOL * max(abs(v), 1.0), (k, ours[k], v)
