"""Import a checkpoint of the JAX package (an orbax directory) into the
PyTorch port's format, one entry directory at a time.

Two kinds of entry are read, told apart by their keys:

- a trained tower (``scripts/build_hard_txt2img.py``'s ``tower``:
  ``encoder``, ``decoder``, ``latent_scale``, ``latent_bias``) becomes the
  directory that ``Flux2VAE(flax_ckpt=...)`` of ``diffulab_tpu_torch``
  reads, written by the port's own ``save_tower_checkpoint``;
- a training run's ``denoiser`` (``{"params", "rest"}``), ``ema`` or
  post-hoc EMA ``phema*`` entry (``{"params"}``) becomes the entry the
  port's ``restore_train_modules`` reads: the same split, every parameter
  through the port's weight bridge (``diffulab_tpu_torch.weights``). The
  JAX trainer's ``_TrainModules`` paths ``denoiser/...`` and
  ``extra_losses/<i>/...`` keep their prefixes where the run has extra
  losses, as the port's ``TrainModules`` names them, and lose the
  ``denoiser/`` one where it has none, as the port's trainer then saves the
  denoiser alone. The ``nnx.Variable`` s that the port keeps as
  non-persistent buffers, outside any checkpoint (the
  ``PrecomputedEmbedder``'s ``null_embedding`` and ``null_embedding_mask``),
  are dropped by name; any other leaf the bridge cannot name raises.

Run it where the JAX package runs (it needs ``orbax.checkpoint``; it does
not import the JAX package), then give the port the output:

    python scripts/import_orbax_checkpoint.py data/hard_txt2img_jax/tower data/hard_txt2img/tower
    python scripts/import_orbax_checkpoint.py runs/x/checkpoints/ema runs_torch/x/checkpoints/ema

A tower is built at ``--tower-kw`` (JSON; default the builder's
``TOWER_KW``) to name its GroupNorm scales (trap T16) and checked against
it. The port's way back (port to JAX) is not written yet.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: nnx.Variables the port holds as non-persistent buffers (networks/embedders/precomputed.py)
DROPPED = frozenset({"null_embedding", "null_embedding_mask"})


def read_orbax(path: str | Path) -> dict[str, Any]:
    """The saved tree of an orbax checkpoint directory, as nested dicts of numpy arrays."""
    import orbax.checkpoint as ocp

    with ocp.StandardCheckpointer() as ckptr:
        return ckptr.restore(Path(path).absolute())


def flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """``{"a/b/c": array}`` of a nested tree; an ``nnx.Variable``'s ``value`` level is dropped."""
    if isinstance(tree, dict):
        out: dict[str, np.ndarray] = {}
        for key, value in tree.items():
            path = prefix if str(key) == "value" and not isinstance(value, dict) else f"{prefix}/{key}".lstrip("/")
            out.update(flatten(value, path))
        return out
    return {prefix: np.asarray(tree)}


def _bridge(flat: dict[str, np.ndarray], module=None) -> tuple[dict[str, Any], list[str]]:
    """The port's state dict of a flat JAX tree, and the dropped paths."""
    import torch

    from diffulab_tpu_torch.weights import state_dict_from_jax

    keep = {p: v for p, v in flat.items() if p.rsplit("/", 1)[-1] not in DROPPED}
    dropped = sorted(set(flat) - set(keep))
    state = state_dict_from_jax(keep, module)
    return {k: torch.as_tensor(v) for k, v in state.items()}, dropped


def import_tower(tree: dict[str, Any], dst: str | Path, tower_kw: dict[str, Any]) -> dict[str, Any]:
    from diffulab_tpu_torch.networks.vision_towers.flux2 import Flux2VAE, save_tower_checkpoint

    tower = Flux2VAE(**tower_kw, device="cpu")
    encoder, _ = _bridge(flatten(tree["encoder"]), tower.encoder)
    decoder, _ = _bridge(flatten(tree["decoder"]), tower.decoder)
    tower.encoder.load_state_dict(encoder, strict=True)  # names and shapes checked here
    tower.decoder.load_state_dict(decoder, strict=True)
    save_tower_checkpoint(dst, encoder, decoder, np.asarray(tree["latent_scale"]), np.asarray(tree["latent_bias"]))
    return {"kind": "tower", "encoder": len(encoder), "decoder": len(decoder)}


def _strip_denoiser(flat: dict[str, np.ndarray], has_extra_losses: bool) -> dict[str, np.ndarray]:
    if has_extra_losses:
        return flat
    return {p.removeprefix("denoiser/"): v for p, v in flat.items()}


def import_run_entry(tree: dict[str, Any], dst: str | Path) -> dict[str, Any]:
    from diffulab_tpu_torch.training.checkpoint import save_checkpoint

    flats = {part: flatten(tree[part]) for part in ("params", "rest") if part in tree}
    has_extra = any(p.startswith("extra_losses/") for flat in flats.values() for p in flat)
    payload, dropped = {}, []
    for part, flat in flats.items():
        payload[part], lost = _bridge(_strip_denoiser(flat, has_extra))
        dropped += lost
    save_checkpoint(dst, payload)
    return {"kind": "run", **{part: len(v) for part, v in payload.items()}, "dropped": dropped}


def import_checkpoint(src: str | Path, dst: str | Path, tower_kw: dict[str, Any] | None = None) -> dict[str, Any]:
    """Read the orbax entry ``src`` and write the port's entry ``dst``; returns what was written."""
    tree = read_orbax(src)
    if {"encoder", "decoder", "latent_scale", "latent_bias"} <= set(tree):
        if tower_kw is None:
            from diffulab_tpu_torch.scripts.build_hard_txt2img import TOWER_KW

            tower_kw = TOWER_KW
        return import_tower(tree, dst, tower_kw)
    if "params" in tree:
        return import_run_entry(tree, dst)
    raise ValueError(f"{src}: neither a tower (encoder, decoder, latent stats) nor a run entry (params); "
                     f"keys {sorted(tree)}")


def main(argv: list[str] | None = None) -> dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("src", help="orbax entry directory of the JAX package")
    p.add_argument("dst", help="entry directory to write in the port's format")
    p.add_argument("--tower-kw", type=json.loads, default=None,
                   help='a tower\'s Flux2VAE arguments as JSON, e.g. \'{"base_channels": 32, "ch_mult": [1, 2], '
                        '"num_res_blocks": 1, "latent_channels": 8}\' (the default)')
    args = p.parse_args(argv)
    result = import_checkpoint(args.src, args.dst, args.tower_kw)
    print(f"imported {args.src} -> {args.dst}: {result}")
    return result


if __name__ == "__main__":
    main()
