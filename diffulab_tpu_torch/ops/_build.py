"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each source under ``diffulab_tpu_torch/csrc/`` becomes a shared library with
a plain C interface, compiled by ``nvcc`` for ``sm_90a`` into
``diffulab_tpu_torch/_build/`` (ignored by git) under a name keyed by a hash
of the source, the headers beside it (``csrc/*.cuh``) and the flags, so
an edited source or header is rebuilt and an unchanged one is loaded as it
is. Nothing here runs at import: the CPU tests import every
module on machines without ``nvcc``.

:func:`build_library` does the same for a host library with another
compiler (``data/native.py`` builds its ``g++`` library through it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Sequence

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: kernel library name -> (source, {C entry point: its argtypes})
KERNELS = {
    "fused_mha_fwd": (
        "csrc/fused_mha_fwd.cu",
        {"fused_mha_fwd": [_P] * 6 + [_I] * 5 + [_L] * 6 + [ctypes.c_float] + [_I] * 6 + [_P],
         "fused_mha_fwd_f32_tiles": [_I, _I], "fused_mha_fwd_bf16_tiles": [_I, _I],
         "fused_mha_fwd_valid_tiles": [_I, _I, _I]},
    ),
    "fused_mha_bwd": (
        "csrc/fused_mha_bwd.cu",
        {"fused_mha_bwd": [_P] * 10 + [_I] * 5 + [_L] * 8 + [ctypes.c_float, _I, _I, _P],
         "fused_mha_bwd_f32_products": [_I, _I], "fused_mha_bwd_f32_groups": [_I],
         "fused_mha_bwd_bf16_tiles": [_I, _I], "fused_mha_bwd_valid_tiles": [_I, _I, _I]},
    ),
    "flash_attn_fwd": (
        "csrc/flash_attn_fwd.cu",
        {"flash_attn_fwd": [_P] * 6 + [_I] * 5 + [_L] * 6 + [ctypes.c_float, _I, _P],
         "flash_attn_fwd_f32_tiles": [_I]},
    ),
    "flash_attn_bwd": (
        "csrc/flash_attn_bwd.cu",
        {"flash_attn_bwd_dkv": [_P] * 10 + [_I] * 6 + [_L] * 10 + [ctypes.c_float, _I, _P],
         "flash_attn_bwd_dq": [_P] * 8 + [_I] * 6 + [_L] * 8 + [ctypes.c_float, _I, _P],
         "flash_attn_bwd_f32_tiles": [_I, _I]},
    ),
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path(stem: str, source: Path, flags: Sequence[str]) -> Path:
    """The library built from ``source``, keyed by the source, every header
    beside it (a source may include any of them) and the flags."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def _target(name: str) -> Path:
    return library_path(name, _PKG / KERNELS[name][0], NVCC_FLAGS)


def _tmp(so: Path) -> Path:
    return so.with_suffix(f".{os.getpid()}.tmp")


def _start_build(stem: str, source: Path, compiler: Callable[[], str], flags: Sequence[str]
                 ) -> tuple[Path, subprocess.Popen | None]:
    """Start compiling ``source`` unless its library is built."""
    so = library_path(stem, source, flags)
    if so.exists():
        return so, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [compiler(), *flags, "-o", str(_tmp(so)), str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return so, proc


def _start(name: str) -> tuple[Path, subprocess.Popen | None]:
    """Start ``nvcc`` for kernel ``name`` unless its library is built."""
    return _start_build(name, _PKG / KERNELS[name][0], _nvcc, NVCC_FLAGS)


def _finish(name: str, so: Path, proc: subprocess.Popen | None) -> str:
    """Wait for one build, move it into place, and return the compiler's log."""
    log = so.with_suffix(".log")
    if proc is None:
        return log.read_text() if log.exists() else ""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        _tmp(so).unlink(missing_ok=True)
        raise RuntimeError(f"{proc.args[0]} failed for {name} (exit {proc.returncode}):\n{out}")
    log.write_text(out)
    os.replace(_tmp(so), so)
    return out


def build_library(stem: str, source: Path, compiler: Callable[[], str], flags: Sequence[str]) -> Path:
    """Build ``source`` with ``compiler()`` and ``flags`` into ``BUILD_DIR``
    unless it is built, and return the library's path. A failed build raises
    ``RuntimeError``, a missing compiler ``OSError``."""
    so, proc = _start_build(stem, source, compiler, flags)
    _finish(stem, so, proc)
    return so


def build_all() -> tuple[float, dict[str, str]]:
    """Build every kernel library, one ``nvcc`` per source, all started at
    once. Returns (wall seconds, compiler log per kernel)."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in KERNELS}
    logs = {name: _finish(name, so, proc) for name, (so, proc) in started.items()}
    return time.perf_counter() - t0, logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(build_library(name, _PKG / KERNELS[name][0], _nvcc, NVCC_FLAGS)))
    for entry, argtypes in KERNELS[name][1].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dl_cuda_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def error_string(err: int) -> str:
    lib = next(iter(_loaded.values()), None)
    if lib is None:
        return "unknown"
    return lib.dl_cuda_error_string(err).decode()
