"""Build textual variants of the port's CUDA sources side by side, for the
``scripts/*_variants.py`` tile and design sweeps.

A variant is a list of ``(file under csrc/, text, its replacement)``; each
text must be in its file, and every occurrence is replaced. A header it edits
is written as ``{stem}_{variant}.cuh`` and the variant's sources include that
copy. Each source is built with the port's ``nvcc`` flags into
``diffulab_tpu_torch/_build/variants/``, all at once, and bound as
``diffulab_tpu_torch.ops._build.load`` binds the port's own library, so a
sweep can call it directly or put it in ``_build._loaded`` for the wrappers.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "diffulab_tpu_torch/csrc"


def build_variants(variants: dict, names, sources, usage_key: str | tuple[str, ...]) -> dict:
    """{(variant, source): its loaded library} for each name in ``names`` and
    each source stem in ``sources``; prints ptxas's registers and spills of the
    kernels whose names hold ``usage_key`` (or one of them)."""
    keys = (usage_key,) if isinstance(usage_key, str) else usage_key
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from diffulab_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        texts = {f"{src}.cu": (CSRC / f"{src}.cu").read_text() for src in sources}
        for f, old, new in variants[name]:
            if f not in texts:
                texts[f] = (CSRC / f).read_text()
            assert old in texts[f], f"{name}: {f} no longer holds {old[:60]!r}"
            texts[f] = texts[f].replace(old, new)
        for header in [f for f in texts if f.endswith(".cuh")]:
            copy = f"{header.removesuffix('.cuh')}_{name}.cuh"
            (out / copy).write_text(texts[header])
            for src in sources:
                texts[f"{src}.cu"] = texts[f"{src}.cu"].replace(f'#include "{header}"', f'#include "{copy}"')
        for src in sources:
            (out / f"{src}_{name}.cu").write_text(texts[f"{src}.cu"])
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-o", str(out / f"{src}_{name}.so"),
                   str(out / f"{src}_{name}.cu")]
            procs[name, src] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (name, src), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} {src}: nvcc failed\n{log[-3000:]}")
        print(name, src, json.dumps({k: v for k, v in chip_smoke.ptxas_usage(log).items()
                                     if any(key in k for key in keys)}))
        lib = ctypes.CDLL(str(out / f"{src}_{name}.so"))
        for entry, argtypes in _build.KERNELS[src][1].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.dl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl_cuda_error_string.restype = ctypes.c_char_p
        libs[name, src] = lib
    return libs


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
