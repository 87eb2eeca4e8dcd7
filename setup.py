"""Package setup.

The compute path is pure JAX/Pallas (no build step).  The native host
engine (minkowskiengine_tpu/cpp/hostengine.cpp) compiles itself on first
use via the system g++; building it here is optional and failure-tolerant.
"""

import subprocess
import sys
from pathlib import Path

from setuptools import find_packages, setup


def try_build_hostengine():
    src = Path(__file__).parent / "minkowskiengine_tpu" / "cpp" / "hostengine.cpp"
    lib = src.parent / "_hostengine.so"
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(lib), str(src)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        print(f"built native host engine: {lib}")
    except Exception as e:  # numpy fallback exists
        print(f"native host engine not built ({e}); numpy fallback will be used")


if "build_ext" in sys.argv or "install" in sys.argv or "develop" in sys.argv:
    try_build_hostengine()

setup(
    name="minkowskiengine-tpu",
    version="0.1.0",
    description=(
        "TPU-native spatially sparse tensor framework "
        "(generalized sparse convolution networks on JAX/XLA/Pallas)"
    ),
    packages=find_packages(include=["minkowskiengine_tpu*"]),
    package_data={
        "minkowskiengine_tpu.cpp": ["hostengine.cpp"],
        "minkowskiengine_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
    },
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy"],
    extras_require={"ckpt": ["orbax-checkpoint"]},
)
