"""Environment diagnostics (reference: MinkowskiEngine/diagnostics.py:19-70
and the backend queries of pybind/extern.hpp:808-838).

Counterpart of ``minkowskiengine_tpu/diagnostics.py``, which asks JAX for
its devices; the port asks CUDA through torch, ``nvidia-smi`` and the CUDA
runtime that torch loaded.  Without a card ``is_cuda_available()`` is
False, the versions are -1 and ``get_gpu_memory_info()`` raises.
"""

from __future__ import annotations

import ctypes
import os
import platform
import shutil
import subprocess
import sys

import torch


def is_cuda_available() -> bool:
    return torch.cuda.is_available()


def _version_int(text) -> int:
    """"12.8" → 12080, the CUDA_VERSION encoding."""
    major, minor = (int(v) for v in str(text).split(".")[:2])
    return major * 1000 + minor * 10


def cuda_version() -> int:
    """The CUDA toolkit torch was built with, as CUDA_VERSION (12080 for
    12.8); -1 for a build without CUDA."""
    return _version_int(torch.version.cuda) if torch.version.cuda else -1


def cudart_version() -> int:
    """``cudaRuntimeGetVersion`` of the CUDA runtime loaded in this process;
    -1 without a card or where no runtime library is loaded."""
    if not is_cuda_available():
        return -1
    torch.cuda.init()
    with open("/proc/self/maps") as f:
        paths = {line.split()[-1] for line in f if "libcudart" in line}
    for path in sorted(paths):
        version = ctypes.c_int()
        if ctypes.CDLL(path).cudaRuntimeGetVersion(ctypes.byref(version)) == 0:
            return int(version.value)
    return -1


def get_gpu_memory_info(device=None):
    """(free, total) bytes of the card (``cudaMemGetInfo``)."""
    if not is_cuda_available():
        raise RuntimeError("no CUDA device is available")
    return torch.cuda.mem_get_info(device)


def get_device_memory_info():
    """(free, total) bytes of the first card, as the JAX package's function of
    the same name gives them for its first device."""
    return get_gpu_memory_info(0)


def _nvidia_smi() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    proc = subprocess.run(
        [smi, "--query-gpu=name,driver_version,power.limit,memory.total", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return (proc.stdout or proc.stderr).strip()


def print_diagnostics():
    print("==========System==========")
    print(platform.platform())
    print(sys.version)
    print("==========PyTorch==========")
    print(f"torch=={torch.__version__}, built with CUDA {torch.version.cuda}")
    print("==========CUDA==========")
    print(f"is_cuda_available: {is_cuda_available()}")
    print(f"cuda_version: {cuda_version()}, cudart_version: {cudart_version()}")
    if is_cuda_available():
        for i in range(torch.cuda.device_count()):
            print(f"  cuda:{i} {torch.cuda.get_device_name(i)}, capability "
                  f"{torch.cuda.get_device_capability(i)}")
        free, total = get_gpu_memory_info()
        print(f"  memory free {free:,} of {total:,} bytes")
    print(f"nvidia-smi: {_nvidia_smi()}")
    print(f"nvcc: {os.environ.get('CUDA_HOME') or shutil.which('nvcc') or 'not found'}")
    print("==========minkowskiengine_tpu_torch==========")
    from .utils import hostengine

    print(f"native host engine: {'loaded' if hostengine.load() is not None else 'unavailable'}")
