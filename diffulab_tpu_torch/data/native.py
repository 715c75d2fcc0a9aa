"""ctypes binding for the native host data-path helper (port of
diffulab_tpu/data/native.py; the C++ source is the port's own copy,
``data/_native/collate.cpp``, cut to the one entry point the port calls:
``gather_normalize_u8``).

The shared library builds with ``g++`` at first use through
:func:`diffulab_tpu_torch.ops._build.build_library`, into the git-ignored
``diffulab_tpu_torch/_build/`` under a name keyed by a hash of the source
and the flags. The reference's NumPy path stays for a machine where the
build fails: this is host code beside the input pipeline, not a device
kernel. ``HAS_NATIVE`` reports which path is active once
:func:`gather_normalize_u8` (or :func:`load`) has been called.
"""

from __future__ import annotations

import ctypes
import logging
import os
from pathlib import Path

import numpy as np

from diffulab_tpu_torch.ops import _build

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "_native" / "collate.cpp"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_N_THREADS = min(8, os.cpu_count() or 1)

_lib: ctypes.CDLL | None = None
HAS_NATIVE = False
_tried = False


def _lib_path() -> Path:
    return _build.library_path("collate", _SRC, _FLAGS)


def load() -> bool:
    """Build (once) and load the library; returns ``HAS_NATIVE``."""
    global _lib, HAS_NATIVE, _tried
    if _tried:
        return HAS_NATIVE
    _tried = True
    try:
        lib = ctypes.CDLL(str(_build.build_library("collate", _SRC, lambda: "g++", _FLAGS)))
    except (RuntimeError, OSError) as e:
        logger.warning("native collate build or load failed (%s); using NumPy fallback", e)
        return False
    lib.gather_normalize_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ]
    lib.gather_normalize_u8.restype = None
    _lib = lib
    HAS_NATIVE = True
    return True


def gather_normalize_u8(store: np.ndarray, indices: np.ndarray,
                        scale: float = 1.0 / 127.5, bias: float = -1.0) -> np.ndarray:
    """Fused ``store[indices].astype(f32) * scale + bias`` for uint8 stores."""
    load()
    store = np.ascontiguousarray(store, dtype=np.uint8)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    if _lib is None:
        return store[indices].astype(np.float32) * scale + bias
    if indices.size and (indices.min() < 0 or indices.max() >= len(store)):
        raise IndexError(f"indices out of range for a store of {len(store)} samples")
    sample_elems = int(np.prod(store.shape[1:]))
    dst = np.empty((len(indices), *store.shape[1:]), np.float32)
    _lib.gather_normalize_u8(
        store.ctypes.data, indices.ctypes.data, dst.ctypes.data,
        len(indices), sample_elems, ctypes.c_float(scale), ctypes.c_float(bias), _N_THREADS,
    )
    return dst
