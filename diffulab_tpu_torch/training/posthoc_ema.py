"""Post-hoc EMA: power-function averaging with offline horizon selection
(port of diffulab_tpu/training/posthoc_ema.py; Karras et al., *Analyzing and
Improving the Training Dynamics of Diffusion Models*, arXiv:2312.02696,
appendix on post-hoc EMA).

During training the trainer keeps two power-function averages of the
trainable parameters with fixed exponents (fp32 tensors, updated in place
after every train step) and snapshots them in fp16 every epoch; afterwards a
least-squares combination of the snapshots reconstructs the EMA of *any*
target profile width, so the horizon sweep becomes an offline sweep over one
training run.

Math (all public, from the paper):

- the power-function average with exponent ``gamma`` weighs the weight
  trajectory by ``w(tau) ∝ tau**gamma`` on ``[0, t]``; its online update at
  integer step ``t`` (1-indexed) is
  ``ema_t = beta_t * ema_{t-1} + (1 - beta_t) * theta_t`` with
  ``beta_t = (1 - 1/t) ** (gamma + 1)``;
- the profile's relative stddev (the "width" users select) is
  ``sigma_rel(gamma) = sqrt((gamma + 1) / ((gamma + 2)**2 * (gamma + 3)))``;
- reconstruction solves ``A x = b`` over the stored snapshots, where
  ``A_ij`` / ``b_i`` are L2 inner products of normalized profiles
  ``p(tau) = (gamma + 1) * tau**gamma / t**(gamma + 1)``:
  ``<p_a, p_b> = (ga + 1)(gb + 1) r**e / ((ga + gb + 1) * max(ta, tb))``
  with ``r = min(ta, tb) / max(ta, tb)`` raised to the *other* profile's
  exponent (``e = gb`` if ``ta < tb`` else ``ga``).

The snapshots are torch-format checkpoint entries (:mod:`.checkpoint`) in
directories named as the reference names its orbax ones
(:func:`snapshot_dir`), so :func:`list_snapshots` parses both alike. The
solve and the combination run on the host in fp64, as the reference's.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from diffulab_tpu_torch.training.checkpoint import STATE_FILE, restore_checkpoint, save_checkpoint

# Paper-standard track exponents: gamma=6.94 <-> sigma_rel 0.10,
# gamma=16.97 <-> sigma_rel 0.05. Two tracks bracket the useful range; the
# reconstruction interpolates (and mildly extrapolates) between them.
DEFAULT_GAMMAS: tuple[float, float] = (6.94, 16.97)


def gamma_to_sigma_rel(gamma: float) -> float:
    g = float(gamma)
    return float(np.sqrt((g + 1.0) / ((g + 2.0) ** 2 * (g + 3.0))))


def sigma_rel_to_gamma(sigma_rel: float) -> float:
    """Invert sigma_rel(gamma): the largest real root of the cubic
    ``g**3 + 7 g**2 + (16 - s) g + (12 - s) = 0`` with ``s = sigma_rel**-2``
    (the expansion of ``(g+2)**2 (g+3) / (g+1) = s``)."""
    s = float(sigma_rel) ** -2
    roots = np.roots([1.0, 7.0, 16.0 - s, 12.0 - s])
    real = roots[np.abs(roots.imag) < 1e-9].real
    gamma = float(real.max())
    if gamma <= 0:
        raise ValueError(f"sigma_rel={sigma_rel} out of range (gamma={gamma})")
    return gamma


# --------------------------------------------------------------------------- #
# online update (after every train step)
# --------------------------------------------------------------------------- #
def power_ema_beta(step: int, gamma: float) -> np.float32:
    """``beta_t = (1 - 1/t) ** (gamma + 1)`` in fp32 from the raw step
    (1-indexed; ``beta_1 = 0``), as the reference forms it in its step."""
    t = np.float32(max(int(step), 1))
    return np.float32((np.float32(1.0) - np.float32(1.0) / t) ** np.float32(gamma + 1.0))


@torch.no_grad()
def power_ema_update(ema: dict[str, torch.Tensor], params: dict[str, torch.Tensor], step: int,
                     gamma: float) -> None:
    """One power-function EMA update in place at raw train-step ``step``
    (step 1 copies the online params since ``beta_1 = 0``). ``ema`` holds
    fp32 tensors by parameter name; the update accumulates in fp32 whatever
    the parameters' dtype: ``e * beta + p * (1 - beta)``. Sharded tracks
    (DTensors, placed as their parameters) update shard by shard."""
    beta = power_ema_beta(step, gamma)
    names = list(ema)
    local = lambda t: t.to_local() if hasattr(t, "to_local") else t  # noqa: E731
    tracks = [local(ema[n]) for n in names]
    online = [local(params[n].detach()).float() for n in names]
    torch._foreach_mul_(tracks, float(beta))
    torch._foreach_add_(tracks, torch._foreach_mul(online, float(np.float32(1.0) - beta)))


def init_tracks(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A fresh track: fp32 copies of ``params`` (distinct buffers)."""
    return {name: p.detach().float().clone() for name, p in params.items()}


def cast_tree_f16(tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """fp16 snapshot cast (halves the bytes written; fp16's 11 mantissa bits
    are the paper's validated snapshot precision)."""
    return {name: t.detach().to(torch.float16) for name, t in tree.items()}


# --------------------------------------------------------------------------- #
# snapshot store
# --------------------------------------------------------------------------- #
def snapshot_dir(base: Path, step: int, gamma: float) -> Path:
    # %.10g keeps custom high-precision gammas roundtrippable through the
    # dirname (resume matches tracks by the parsed value)
    return Path(base) / f"step{step:08d}_g{gamma:.10g}"


_SNAPSHOT_RE = re.compile(r"^step(\d+)_g([0-9.eE+-]+)$")


def list_snapshots(base: Path) -> list[tuple[int, float, Path]]:
    """(step, gamma, path) for every stored snapshot, sorted by step.

    Only complete entries with a cleanly parseable name count: a save cut
    off by preemption leaves a directory without its ``state.pt`` (the file
    is renamed into place last), which must not crash (or pollute) the
    reconstruction that runs right after that preemption."""
    out = []
    for p in sorted(Path(base).glob("step*_g*")):
        m = _SNAPSHOT_RE.match(p.name)
        if m is None or not (p / STATE_FILE).is_file():
            continue
        try:
            out.append((int(m.group(1)), float(m.group(2)), p))
        except ValueError:
            continue
    out.sort(key=lambda r: (r[0], r[1]))
    return out


# --------------------------------------------------------------------------- #
# reconstruction
# --------------------------------------------------------------------------- #
def _profile_dot(ta, ga, tb, gb):
    ta, ga, tb, gb = (np.asarray(v, np.float64) for v in (ta, ga, tb, gb))
    t_max = np.maximum(ta, tb)
    ratio = np.minimum(ta, tb) / t_max
    exponent = np.where(ta < tb, gb, ga)
    return (ga + 1.0) * (gb + 1.0) * ratio**exponent / ((ga + gb + 1.0) * t_max)


def solve_weights(
    ts: Sequence[int], gammas: Sequence[float], t_out: int, gamma_out: float
) -> np.ndarray:
    """Least-squares coefficients combining snapshots ``(ts[i], gammas[i])``
    into the target profile ``(t_out, gamma_out)`` (fp64 normal equations,
    as in the paper)."""
    ts_a = np.asarray(ts, np.float64)
    gs_a = np.asarray(gammas, np.float64)
    A = _profile_dot(ts_a[:, None], gs_a[:, None], ts_a[None, :], gs_a[None, :])
    b = _profile_dot(ts_a, gs_a, np.float64(t_out), np.float64(gamma_out))
    # lstsq, not solve: with many snapshots A is near-singular (neighboring
    # profiles overlap almost completely)
    x, *_ = np.linalg.lstsq(A, b, rcond=None)
    return x


def combine_snapshots(trees: Sequence[dict[str, torch.Tensor]], weights: np.ndarray) -> dict[str, torch.Tensor]:
    """fp32 weighted sum of parameter dicts, accumulated in fp64 on the host
    (fp16 round-off would otherwise pile up across alternating-sign
    coefficients)."""
    acc = {name: torch.zeros(t.shape, dtype=torch.float64) for name, t in trees[0].items()}
    for w, tree in zip(weights, trees):
        for name, a in acc.items():
            a += tree[name].detach().cpu().double() * float(w)
    return {name: a.float() for name, a in acc.items()}


def reconstruct_from_dir(
    base: str | Path,
    sigma_rel: float,
    t_out: int | None = None,
    max_snapshots: int | None = None,
) -> dict[str, Any]:
    """Reconstruct the post-hoc EMA with target width ``sigma_rel`` from a
    run's ``phema/`` snapshot directory. Returns ``{"params": dict, "weights":
    x, "t_out": t, "gamma_out": g}``; the params dict holds the trainable
    parameters by name (the layout of an ``ema`` checkpoint)."""
    snaps = list_snapshots(Path(base))
    if not snaps:
        raise FileNotFoundError(f"no phema snapshots under {base}")
    if t_out is None:
        t_out = max(s for s, _, _ in snaps)
    if max_snapshots is not None and len(snaps) > max_snapshots:
        # thin evenly to AT MOST max_snapshots total, always keeping the
        # final snapshot step of every track
        keep_steps = sorted({s for s, _, _ in snaps})
        n_tracks = max(len({g for _, g, _ in snaps}), 1)
        target_steps = max(max_snapshots // n_tracks, 1)
        if len(keep_steps) > target_steps:
            idx = np.linspace(0, len(keep_steps) - 1, target_steps).round().astype(int)
            chosen = {keep_steps[i] for i in idx} | {keep_steps[-1]}
        else:
            chosen = set(keep_steps)
        snaps = [r for r in snaps if r[0] in chosen]
    gamma_out = sigma_rel_to_gamma(sigma_rel)
    ts = [s for s, _, _ in snaps]
    gs = [g for _, g, _ in snaps]
    weights = solve_weights(ts, gs, t_out, gamma_out)
    trees = [restore_checkpoint(p)["params"] for _, _, p in snaps]
    params = combine_snapshots(trees, weights)
    return {"params": params, "weights": weights, "t_out": t_out, "gamma_out": gamma_out}


def save_reconstruction(out_dir: str | Path, params: dict[str, torch.Tensor]) -> None:
    """Write the reconstructed average in the ``ema`` checkpoint layout
    (``{"params": ...}``) so the sampling CLI restores it directly."""
    save_checkpoint(Path(out_dir), {"params": params})
