#!/usr/bin/env python3
"""The end-to-end paths that the fp32 K1/K2 at head dims 256 and 512 serve
(the MNIST UNet's attention), of two checkouts of the port, timed on one
card.

``--root DIR`` runs DIR's own ``chip_smoke.py`` phase 19c in a temporary
directory (``phase_d2_cli``: ``train_mnist_ddpm`` and
``train_mnist_flow_matching`` through the training CLI on MNIST idx files
written from a seed, then two 16-image requests of each at 50 steps through
the sample CLI, DDPM ancestral and Euler) and prints one JSON line: each
config's ms a train step (start to start, the median after the first two)
and its requests' ``generate`` ms. A step runs 11 K1 and 11 K2 (5 at D =
256, 6 at 512), a request 550 K1.

``--ab PARENT`` runs ``--root PARENT``, ``--root`` this checkout, this
checkout again, and PARENT again, each in its own process, and prints the
four lines and their medians. Unpack the parent commit into a directory that
git ignores (``git archive HEAD~1 | tar -x -C _parent``), then run from the
repository root on the card: ``python3 scripts/ab_d2_steps.py --ab _parent``.
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
        d2 = chip_smoke.phase_d2_cli(Path(tmp))
    out = {"root": str(root)}
    for config, result in d2.items():
        tag = config.removeprefix("train_")
        out[f"{tag}_step_ms"] = result["step_ms"]
        for i, ms in enumerate(result["generate_ms"]):
            out[f"{tag}_request{i}_ms"] = ms
    return out


def main() -> int:
    return ab_main(__doc__, __file__, measure, {})


if __name__ == "__main__":
    sys.exit(main())
