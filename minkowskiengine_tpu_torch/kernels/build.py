"""Build the port's CUDA sources into one shared library at first use.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into ``build/kernels/`` at the root of a source checkout, under a name keyed
on a hash of the sources and flags, and loaded with ``ctypes``.  An
installed package (no ``setup.py`` beside it) builds into the user's cache,
``$XDG_CACHE_HOME/minkowskiengine_tpu_torch/kernels`` (default
``~/.cache``), so environments that share an interpreter do not share a
build directory.  The sources
have a plain C interface (no PyTorch headers), which keeps the build to
seconds.  Nothing is compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
_ROOT = Path(__file__).resolve().parents[2]
if (_ROOT / "setup.py").is_file():
    BUILD_DIR = _ROOT / "build" / "kernels"
else:
    _CACHE = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    BUILD_DIR = Path(_CACHE) / "minkowskiengine_tpu_torch" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to the build log
)

# exported C functions: (argument types, result type); pointers and the
# stream are c_void_p so ctypes passes them at full width
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # (x, w, idx, out, n_in, n_out, k_vol, cin, cout, stream) -> cudaError_t
    "me_gather_gemm_f32": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
}

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [
        str(Path(home) / "bin" / "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    """Path of the built library, building it if the sources changed."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(p.name.encode() + b"\0" + p.read_bytes())
    out = BUILD_DIR / f"libme_torch_kernels-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(library_path()))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib
