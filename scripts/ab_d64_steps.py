#!/usr/bin/env python3
"""The end-to-end paths that the K1/K2 instances built around the valid rows
at head dim 64 serve, of two checkouts of the port, timed on one card.

``--root DIR`` runs DIR's own ``chip_smoke.py`` phases 22 and 23 in a
temporary directory (``phase_f1_cli``: ``train_synthetic_flow_matching`` with
``model=sprint`` and ``model=ddt`` and ``train_cifar10_flow_matching`` through
the CLIs; ``phase_g1``: G1's precompute, ``train_repa`` and ``sample``) and
prints one JSON line: each run's ms a train step (start to start, the median
after the first two) and G1's request's ``generate`` ms. The Sprint step's
deep path (64 kept tokens of 256, fp32) and G1's step (64 tokens, bf16) and
request (fp32) attend at 64 of 128 keys; the DDT and CIFAR steps (256
tokens) are the control.

``--ab PARENT`` runs ``--root PARENT``, ``--root`` this checkout, this
checkout again, and PARENT again, each in its own process, and prints the
four lines and their medians. Unpack the parent commit into a directory that
git ignores (``git archive HEAD~1 | tar -x -C _parent``), then run from the
repository root on the card: ``python3 scripts/ab_d64_steps.py --ab _parent``.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
from ab_flash_attn_bwd import ab_main  # noqa: E402


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    sys.modules["wandb"] = None  # metrics go to metrics.jsonl; no service is contacted
    import chip_smoke  # the tree's own

    from diffulab_tpu_torch.utils import full_fp32_products

    assert Path(chip_smoke.__file__).resolve().is_relative_to(root.resolve())
    assert Path(sys.modules["diffulab_tpu_torch"].__file__).resolve().is_relative_to(root.resolve())
    full_fp32_products()
    with tempfile.TemporaryDirectory() as tmp:
        f1 = chip_smoke.phase_f1_cli(Path(tmp))
        g1 = chip_smoke.phase_g1(Path(tmp))
    return {"root": str(root), **{f"{kind}_step_ms": f1[kind]["step_ms"] for kind in chip_smoke.F1_CLI},
            "g1_step_ms": g1["step_ms"], "g1_generate_ms": g1["generate_ms"]}


def main() -> int:
    return ab_main(__doc__, __file__, measure, {})


if __name__ == "__main__":
    sys.exit(main())
