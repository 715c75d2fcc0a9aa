"""Ahead-of-time sampler export for deployment and serving (port of
diffulab_tpu/deploy/export.py).

The artifact is the traced reverse process: ``torch.export`` traces the
whole sampling loop of :meth:`Diffuser.generate` (the sampler's steps
unrolled, classifier-free guidance as one fused 2x batch, the optional
vision-tower decode), and serving loads it back with ``torch``, ``numpy``
and the port's op registrations: no model code, no config, no
checkpoint-restore logic.

Layout of an artifact directory:

    sampler.pt2     the reverse process: every step, the CFG batch and
                    combine, the decode (with the tower's parameters)
    denoiser.pt2    the denoiser's forward at the loop's call shape, with
                    its parameters
    manifest.json   the cond inputs' shapes and dtypes, the noise inputs in
                    draw order, and the sampling configuration

The loop calls the denoiser through one op, ``torch.ops.diffulab_tpu_torch.
denoiser``, which runs the loaded ``denoiser.pt2``. Unrolled into the loop,
the denoiser's graph would be traced, written and read back once a step:
DiT-B/2 at Euler-50 under CFG is ~80k nodes, minutes of export and of load
at about 5 ms a node, against one trace of ~1.6k nodes this way. The images
are the same: the loop's arithmetic is traced as it runs live, and each
step's model call runs the same forward.

Two things differ from the JAX artifact.

- **The ops.** Every attention launch is one node of the denoiser's graph, a
  ``torch.ops.diffulab_tpu_torch.*`` custom op (``ops/fused_mha.py``,
  ``ops/flash_attention.py``), and the loop reaches the denoiser through the
  ``denoiser`` op (this module). Loading the artifact needs those ops
  registered, which importing this module does: that is the one dependency
  of serving on the port. The JAX artifact needs no registration: the
  Pallas kernels lower into its program.
- **The noise.** A ``torch.export`` graph draws no random numbers, so the
  program takes its noise as inputs: the initial x_T and, for a stochastic
  sampler, one tensor a step (the manifest's ``noise``, in the order the
  loop draws them). :class:`DeployedSampler` draws them from
  ``torch.Generator(device).manual_seed(seed)``, in the order and shapes the
  live ``Diffuser.generate(generator=...)`` draws them
  (``diffuse/flow.py::generator_noise``), so an artifact and the live path
  give the same images for one seed.

The parameters are inside the two programs (``torch.export.save``), not
beside them as the JAX artifact's ``params.npz``. An artifact runs on the
device type it was exported on (the manifest's ``platforms``): the graphs
hold that device, and any other raises. Export on the card to serve on the
card.

In latent mode the decode is ``tower.decode(x / latent_scale +
latent_bias)`` and ``clamp_x`` clips the decoded pixels, as the port's live
``generate`` does (the reference's clip of the latents before the decode is
a residue the port does not copy, ROADMAP trap T5).
"""

from __future__ import annotations

import json
import uuid
import weakref
from pathlib import Path
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

import diffulab_tpu_torch.ops  # noqa: F401  (registers the kernels' ops the denoiser's graph calls)

MANIFEST_VERSION = 1
PROGRAM_FILE = "sampler.pt2"
DENOISER_FILE = "denoiser.pt2"

#: the loaded denoiser programs the ``denoiser`` op runs, by artifact id: an op
#: reaches no object but through its arguments, so each DeployedSampler
#: registers its own here (and holds it; the entry goes when the sampler does)
_DENOISERS: weakref.WeakValueDictionary = weakref.WeakValueDictionary()


def _denoiser_op_impl(artifact: str, x, timesteps, cond, drop, out_shape, out_dtype):
    program = _DENOISERS.get(artifact)
    if program is None:
        raise RuntimeError(f"the denoiser of artifact {artifact} is not loaded: load the artifact through "
                           "DeployedSampler")
    return program(x, timesteps, list(cond), drop)


def _denoiser_op_fake(artifact, x, timesteps, cond, drop, out_shape, out_dtype):
    return x.new_empty(out_shape, dtype=out_dtype)


#: the loop's model call: runs the loaded ``denoiser.pt2`` of ``artifact`` on
#: (x, timesteps, the cond leaves, drop) and returns its prediction
denoiser_op = torch.library.custom_op(
    "diffulab_tpu_torch::denoiser", _denoiser_op_impl, mutates_args=(),
    schema="(str artifact, Tensor x, Tensor timesteps, Tensor[] cond, Tensor drop, int[] out_shape, "
           "ScalarType out_dtype) -> Tensor")
denoiser_op.register_fake(_denoiser_op_fake)


class TensorSpec(NamedTuple):
    """The shape and dtype of one input (``jax.ShapeDtypeStruct``'s role)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in the manifest")
    return dtype


class _Call(NamedTuple):
    """The shapes of one model call of the loop: x, timesteps, the cond
    leaves (and the cond's tree) and drop."""

    x: TensorSpec
    timesteps: TensorSpec
    cond: tuple[TensorSpec, ...]
    tree: Any
    drop: TensorSpec


def _spec(t: torch.Tensor) -> TensorSpec:
    return TensorSpec(tuple(t.shape), t.dtype)


def _record_request(diffusion: Any, cond: dict[str, torch.Tensor], data_shape: tuple[int, ...],
                   dtype: torch.dtype, guidance_scale: float) -> tuple[list[dict[str, Any]], _Call]:
    """What ``diffusion.denoise`` draws and calls for one request: the noise
    draws in order (``{"kind", "step", "shape", "dtype"}`` each) and the
    shapes of its model calls. The loop runs once on the ``meta`` device
    (``cond`` there too) with a model that returns zeros: both depend on the
    sampler, its configuration and the shapes, never on the values. Every
    model call of a request must have one shape."""
    draws: list[dict[str, Any]] = []
    calls: set[_Call] = set()

    def draw(kind: str, step: int, shape: tuple, dtype_: torch.dtype) -> torch.Tensor:
        draws.append({"kind": kind, "step": int(step), "shape": [int(n) for n in shape],
                      "dtype": _dtype_name(dtype_)})
        return torch.zeros(shape, dtype=dtype_, device="meta")

    def model_fn(x, timesteps, cond, drop, **kwargs):
        if kwargs:
            raise NotImplementedError(f"export runs the plain loop; the model call got {sorted(kwargs)}")
        leaves, tree = pytree.tree_flatten(cond)
        calls.add(_Call(_spec(x), _spec(timesteps), tuple(_spec(t) for t in leaves), tree, _spec(drop)))
        return {"x": torch.zeros_like(x)}

    diffusion.denoise(model_fn, cond, None, data_shape=tuple(data_shape), guidance_scale=guidance_scale,
                      use_cfg=guidance_scale > 0, dtype=dtype, device=torch.device("meta"), draw_noise=draw)
    if len(calls) != 1:
        raise NotImplementedError(f"the loop calls the model at {len(calls)} shapes; export takes one")
    return draws, calls.pop()


class _DenoiserProgram(torch.nn.Module):
    """The denoiser's sampling forward on (x, timesteps, the cond leaves, drop)."""

    def __init__(self, denoiser: torch.nn.Module, tree: Any):
        super().__init__()
        self.denoiser = denoiser
        self.tree = tree

    def forward(self, x, timesteps, cond: list[torch.Tensor], drop):
        return self.denoiser(x=x, timesteps=timesteps, cond=pytree.tree_unflatten(cond, self.tree), drop=drop,
                             train=False)["x"]


class _SamplerProgram(torch.nn.Module):
    """The reverse process as one module: inputs the noise tensors (in draw
    order) and the cond tensors (in sorted key order), output the images.
    The model calls go through the ``denoiser`` op."""

    def __init__(self, diffuser: Any, artifact: str, cond_keys: Sequence[str], noise: list[dict[str, Any]],
                 data_shape: tuple[int, ...], guidance_scale: float, clamp_x: bool, dtype: torch.dtype,
                 out: TensorSpec):
        super().__init__()
        self.vision_tower = diffuser.vision_tower
        self.diffusion = diffuser.diffusion
        self.artifact = artifact
        self.cond_keys = list(cond_keys)
        self.noise = noise
        self.data_shape = tuple(data_shape)
        self.guidance_scale = float(guidance_scale)
        self.clamp_x = clamp_x
        self.dtype = dtype
        self.out = out
        if self.vision_tower is not None:
            self.latent_scale = diffuser.latent_scale
            self.latent_bias = diffuser.latent_bias

    def forward(self, noise: list[torch.Tensor], cond: list[torch.Tensor]) -> torch.Tensor:
        inputs = iter(noise)
        order = iter(self.noise)

        def draw(kind: str, step: int, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
            spec = next(order)
            if (kind, step, list(shape)) != (spec["kind"], spec["step"], spec["shape"]):
                raise RuntimeError(f"draw {kind}/{step} {list(shape)} is not the recorded {spec}")
            return next(inputs)

        def model_fn(x, timesteps, cond, drop):
            leaves = pytree.tree_leaves(cond)
            return {"x": denoiser_op(self.artifact, x, timesteps, leaves, drop, list(self.out.shape),
                                     self.out.dtype)}

        latent = self.vision_tower is not None
        x = self.diffusion.denoise(
            model_fn, dict(zip(self.cond_keys, cond)), None, data_shape=self.data_shape,
            clamp_x=self.clamp_x and not latent, guidance_scale=self.guidance_scale,
            use_cfg=self.guidance_scale > 0, dtype=self.dtype, device=noise[0].device, draw_noise=draw,
        )["x"]
        if latent:
            x = self.vision_tower.decode(x / self.latent_scale + self.latent_bias)
            if self.clamp_x:
                x = torch.clamp(x, -1.0, 1.0)
        return x


def _drop_host_checks(exported: torch.export.ExportedProgram) -> torch.export.ExportedProgram:
    """``exported`` without the nodes that do no device work: ``torch.export``
    records each ``.to(dtype)`` as an ``_assert_tensor_metadata`` check and a
    cast, also where the tensor already has that dtype (the cast then returns
    its input). A request runs host-bound, one Python call a node, and
    DiT-B/2's forward holds 430 of each; the checks go, and each identity cast
    that is not an output is replaced by its input. The graph computes the
    same values."""
    graph = exported.graph_module.graph
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target is torch.ops.aten.to.dtype and len(node.args) == 2 and not node.kwargs
              and node.args[0].meta["val"].dtype == node.args[1]
              and all(user.op != "output" for user in node.users)):  # the signature names the outputs
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    exported.graph_module.recompile()
    return exported


def _zeros(spec: TensorSpec, device: torch.device) -> torch.Tensor:
    return torch.zeros(spec.shape, dtype=spec.dtype, device=device)


def _n_tensors(module: torch.nn.Module | None) -> int:
    return 0 if module is None else len(module.state_dict())


def export_generate(
    diffuser: Any,
    cond_spec: dict[str, TensorSpec],
    batch_size: int,
    image_shape: tuple[int, ...],
    out_dir: str | Path,
    guidance_scale: float = 0.0,
    clamp_x: bool = True,
    dtype: torch.dtype = torch.float32,
) -> Path:
    """Export ``diffuser.generate`` for fixed shapes into ``out_dir``.

    ``cond_spec`` maps conditioning keys to per-sample :class:`TensorSpec`\\ s
    (without the batch dim), e.g. ``{"y": TensorSpec((), torch.int64)}`` for
    class labels. ``image_shape`` is the per-sample shape the reverse process
    integrates over (the latent shape in latent mode). The programs are
    traced on the device of the denoiser's parameters, and serve there.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = next(diffuser.denoiser.parameters()).device
    data_shape = (batch_size, *image_shape)
    cond_keys = sorted(cond_spec)
    cond_specs = [TensorSpec((batch_size, *cond_spec[k].shape), cond_spec[k].dtype) for k in cond_keys]
    meta_cond = {k: _zeros(s, torch.device("meta")) for k, s in zip(cond_keys, cond_specs)}
    noise, call = _record_request(diffuser.diffusion, meta_cond, data_shape, dtype, float(guidance_scale))
    artifact = uuid.uuid4().hex

    modules = [m for m in (diffuser.denoiser, diffuser.vision_tower) if m is not None]
    training = [m.training for m in modules]
    for m in modules:
        m.eval()
    try:
        with torch.no_grad():
            denoiser = torch.export.export(
                _DenoiserProgram(diffuser.denoiser, call.tree),
                (_zeros(call.x, device), _zeros(call.timesteps, device), [_zeros(s, device) for s in call.cond],
                 _zeros(call.drop, device)), strict=False)
            out = next(n for n in denoiser.graph.nodes if n.op == "output").args[0][0].meta["val"]
            program = _SamplerProgram(diffuser, artifact, cond_keys, noise, data_shape, guidance_scale, clamp_x,
                                      dtype, TensorSpec(tuple(out.shape), out.dtype))
            sampler = torch.export.export(
                program, ([_zeros(TensorSpec(tuple(n["shape"]), _torch_dtype(n["dtype"])), device) for n in noise],
                          [_zeros(s, device) for s in cond_specs]), strict=False)
    finally:
        for m, mode in zip(modules, training):
            m.train(mode)
    torch.export.save(_drop_host_checks(denoiser), out_dir / DENOISER_FILE)
    torch.export.save(_drop_host_checks(sampler), out_dir / PROGRAM_FILE)

    manifest = {
        "version": MANIFEST_VERSION,
        "n_params": _n_tensors(diffuser.denoiser),
        "n_tower_params": _n_tensors(diffuser.vision_tower),
        "batch_size": batch_size,
        "image_shape": list(image_shape),
        "guidance_scale": guidance_scale,
        "n_steps": int(diffuser.diffusion.steps),
        "cond": {k: {"shape": list(cond_spec[k].shape), "dtype": _dtype_name(cond_spec[k].dtype)}
                 for k in cond_keys},
        "noise": noise,
        "artifact": artifact,
        "platforms": [device.type],
    }
    (out_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return out_dir


class DeployedSampler:
    """Serve an exported artifact with ``torch``, ``numpy`` and the port's
    op registrations (this module imports them).

    >>> sampler = DeployedSampler("artifact/")          # on the card
    >>> images = sampler(seed=0, y=np.array([1, 2, 3, 4]))
    """

    def __init__(self, artifact_dir: str | Path, device: str | torch.device = "cuda"):
        artifact_dir = Path(artifact_dir)
        self.manifest = json.loads((artifact_dir / "manifest.json").read_text())
        if self.manifest["version"] != MANIFEST_VERSION:
            raise ValueError(f"unsupported artifact version {self.manifest['version']}")
        self.device = torch.device(device)
        if self.device.type not in self.manifest["platforms"]:
            raise ValueError(f"the artifact was exported for {self.manifest['platforms']}, not {self.device.type}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; an artifact exported on the card serves on the card")
        self._denoiser = torch.export.load(artifact_dir / DENOISER_FILE).module()
        _DENOISERS[self.manifest["artifact"]] = self._denoiser
        self._program = torch.export.load(artifact_dir / PROGRAM_FILE).module()
        self._cond_keys = sorted(self.manifest["cond"])

    @property
    def batch_size(self) -> int:
        return self.manifest["batch_size"]

    def __call__(self, seed: int = 0, **cond: Any) -> np.ndarray:
        missing = set(self._cond_keys) - set(cond)
        if missing:
            raise ValueError(f"missing conditioning inputs: {sorted(missing)}")
        cond_arrays = []
        for k in self._cond_keys:
            spec = self.manifest["cond"][k]
            arr = torch.as_tensor(np.asarray(cond[k])).to(device=self.device, dtype=_torch_dtype(spec["dtype"]))
            want = (self.batch_size, *spec["shape"])
            if tuple(arr.shape) != want:
                raise ValueError(f"cond '{k}' must have shape {want}, got {tuple(arr.shape)}")
            cond_arrays.append(arr)
        generator = torch.Generator(self.device).manual_seed(seed)
        noise = [torch.randn(n["shape"], generator=generator, dtype=_torch_dtype(n["dtype"]), device=self.device)
                 for n in self.manifest["noise"]]
        with torch.no_grad():
            out = self._program(noise, cond_arrays)
        return out.float().cpu().numpy()
