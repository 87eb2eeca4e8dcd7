"""The host engine: ``csrc/hostengine.cpp`` built with g++ at first use and
bound with ``ctypes``.

It runs the data loader's voxel quantization on the host (unique rows in
first-occurrence order, label votes).  The library goes beside the CUDA
kernel library, in ``build/hostengine`` of a source checkout (the user's
cache for an installed package, as ``kernels/build.py`` decides), under a
name keyed on a hash of the source and flags; it is written to a temporary
name and renamed, so processes that build at once never load half a file.
If g++ fails, ``load()`` warns once with the compiler's output and returns
None, and quantization takes the numpy versions
(``utils/quantization.py``).  Nothing is compiled when this module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

from ..kernels.build import BUILD_DIR as _KERNEL_BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "hostengine.cpp"
BUILD_DIR = _KERNEL_BUILD_DIR.parent / "hostengine"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Path of the built library, building it if the source changed.
    Raises RuntimeError with the compiler's output if g++ fails."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + SOURCE.read_bytes())
    out = BUILD_DIR / f"libme_hostengine-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first call; None (after one warning) if
    it cannot be built or loaded."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(library_path()))
        except (RuntimeError, OSError) as e:
            warnings.warn(
                f"the native host engine did not build or load; quantization uses numpy: {e}",
                RuntimeWarning, stacklevel=2,
            )
            return None
        i64, i32p, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
        lib.me_quantize_i32.restype = i64
        lib.me_quantize_i32.argtypes = [i32p, i64, i64, i64p, i64p]
        lib.me_quantize_label_i32.restype = i64
        lib.me_quantize_label_i32.argtypes = [i32p, i32p, i64, i64, ctypes.c_int32, i64p, i64p, i32p]
        _lib = lib
        return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def quantize_i32(lib: ctypes.CDLL, coords: np.ndarray):
    """(unique_map, inverse_map) int64 over (N, D) int32 rows."""
    coords = np.ascontiguousarray(coords, np.int32)
    n, d = coords.shape
    unique_map, inverse = np.empty(n, np.int64), np.empty(n, np.int64)
    nu = lib.me_quantize_i32(
        _ptr(coords, ctypes.c_int32), n, d, _ptr(unique_map, ctypes.c_int64),
        _ptr(inverse, ctypes.c_int64),
    )
    return unique_map[:nu], inverse


def quantize_label_i32(lib: ctypes.CDLL, coords: np.ndarray, labels: np.ndarray, ignore_label: int):
    """(unique_map, inverse_map, labels of the unique rows)."""
    coords = np.ascontiguousarray(coords, np.int32)
    labels = np.ascontiguousarray(labels, np.int32)
    n, d = coords.shape
    unique_map, inverse = np.empty(n, np.int64), np.empty(n, np.int64)
    out_labels = np.empty(n, np.int32)
    nu = lib.me_quantize_label_i32(
        _ptr(coords, ctypes.c_int32), _ptr(labels, ctypes.c_int32), n, d, int(ignore_label),
        _ptr(unique_map, ctypes.c_int64), _ptr(inverse, ctypes.c_int64),
        _ptr(out_labels, ctypes.c_int32),
    )
    return unique_map[:nu], inverse, out_labels[:nu]
