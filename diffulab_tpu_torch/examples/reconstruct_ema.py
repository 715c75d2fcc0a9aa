"""Offline EMA-horizon selection: reconstruct post-hoc EMA checkpoints (port
of examples/reconstruct_ema.py).

The companion CLI to ``trainer.posthoc_ema``
(:mod:`diffulab_tpu_torch.training.posthoc_ema`, Karras et al.
arXiv:2312.02696). A run trained with ``posthoc_ema: true`` leaves per-epoch
fp16 snapshots of two power-function EMA tracks under
``<run>/checkpoints/phema/``; this tool least-squares-combines them into the
EMA of any target relative width ``sigma_rel`` and writes each result as a
params-only checkpoint (``phema_sr<val>``, the layout of ``ema``, which the
sampling CLI restores directly):

    python -m diffulab_tpu_torch.examples.reconstruct_ema \\
        --run-dir runs/synthetic_flow_matching --sigma-rel 0.05 0.10
    python -m diffulab_tpu_torch.examples.sample \\
        --ckpt runs/synthetic_flow_matching/checkpoints/phema_sr0.05 ...

The solve and the weighted sum run on the host in fp64, as the
reference's, so this CLI takes no device.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any

from diffulab_tpu_torch.training.posthoc_ema import (
    list_snapshots,
    reconstruct_from_dir,
    save_reconstruction,
)
from diffulab_tpu_torch.utils import full_fp32_products


def main(argv: list[str] | None = None) -> list[dict[str, Any]]:
    """Reconstruct and write each ``--sigma-rel``; returns the results
    (``reconstruct_from_dir``'s dicts, each with its ``out`` directory)."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--run-dir", required=True, help="training run dir (contains checkpoints/phema)")
    parser.add_argument("--sigma-rel", type=float, nargs="+", required=True,
                        help="target EMA relative width(s), e.g. 0.05 0.10 0.15")
    parser.add_argument("--t-out", type=int, default=None,
                        help="reconstruction step (default: last snapshot)")
    parser.add_argument("--max-snapshots", type=int, default=None,
                        help="thin the basis to at most this many snapshots")
    args = parser.parse_args(argv)
    full_fp32_products()

    ckpt_dir = Path(args.run_dir) / "checkpoints"
    phema_dir = ckpt_dir / "phema"
    snaps = list_snapshots(phema_dir)
    if not snaps:
        raise SystemExit(f"no phema snapshots under {phema_dir} — "
                         "was the run trained with trainer.posthoc_ema=true?")
    print(f"{len(snaps)} snapshots, steps {snaps[0][0]}..{snaps[-1][0]}, "
          f"gammas {sorted({g for _, g, _ in snaps})}")

    results = []
    for sigma_rel in args.sigma_rel:
        result = reconstruct_from_dir(
            phema_dir, sigma_rel, t_out=args.t_out, max_snapshots=args.max_snapshots
        )
        out = ckpt_dir / f"phema_sr{sigma_rel:g}"
        save_reconstruction(out, result["params"])
        w = result["weights"]
        print(f"sigma_rel={sigma_rel:g} (gamma={result['gamma_out']:.2f}, "
              f"t_out={result['t_out']}): |coeffs| max {abs(w).max():.3f}, "
              f"sum {w.sum():.6f} -> {out}")
        results.append({**result, "out": out})
    return results


if __name__ == "__main__":
    main()
