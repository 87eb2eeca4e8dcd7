"""Build the port's CUDA sources into one shared library at first use.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all at once (the shared ``csrc/*.cuh`` headers they include
count in the build key too), and the objects are linked into one library in
``build/kernels/`` at the root of a source checkout, under a name keyed on a
hash of the sources and flags, and loaded with ``ctypes``.  An
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to the build log
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

# exported C functions: (argument types, result type); pointers and the
# stream are c_void_p so ctypes passes them at full width
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # (x, w, idx, out, workspace, n_in, n_out, k_vol, cin, cout, splits, vec,
    #  stream) -> cudaError_t
    "me_gather_gemm_f32": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "me_gather_gemm_bf16": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    # (x, g, idx, out, workspace, n_in, n_out, k_vol, cin, cout, splits,
    #  cin_tile, cout_tile, vec, stream)
    "me_conv_dw_f32": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "me_conv_dw_bf16": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    # the bf16 bodies on wgmma: (x, w or g, idx, out, workspace, n_in, n_out,
    # k_vol, cin, cout, splits, bn, bm (K1's row tile) or bc (K2's Cin tile),
    # stream); the bf16 stem of K2: (..., splits, vec, stream)
    "me_gather_gemm_bf16_wgmma": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "me_conv_dw_bf16_wgmma": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "me_conv_dw_bf16_stem": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    # K1's float32 body on wgmma, as K1's bf16 one
    "me_gather_gemm_f32_wgmma": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    # serialized attention: (qkv, rows, bounds, out, lse, positions, windows,
    # max_len, heads, d, scale, stream); its backward (qkv, rows, bounds,
    # out, dout, lse, delta, dqkv, positions, windows, max_len, heads, d,
    # scale, stream)
    "me_attention_fwd_f32": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P], _I),
    "me_attention_bwd_f32": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P], _I),
    # the kernel-map grid probe: (halves, count, k_vol, dim, stream), halves
    # a host array of kernels/grid_probe.py::_Half
    "me_grid_probe": ([_P, _I, _I, _I, _P], _I),
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(p.name.encode() + b"\0" + p.read_bytes())
    out = BUILD_DIR / f"libme_torch_kernels-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objects = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    nvcc = _nvcc()
    # one nvcc per source, all running at once; then one link
    commands = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(sources, objects)]
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in commands
    ]
    log, failed = [], []
    for cmd, proc in zip(commands, procs):
        output = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + output)
        if proc.returncode != 0:
            failed.append(f"exit code {proc.returncode}:\n{output[-4000:]}")
    if not failed:
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append(f"link exit code {proc.returncode}:\n{proc.stdout[-4000:]}")
    for o in objects:
        o.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(log))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed with " + "\n".join(failed))
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
