"""Core enums and helpers of the PyTorch port.

Counterpart of ``minkowskiengine_tpu/types.py``.  The reference's memory and
backend enums (``MinkowskiAlgorithm``, ``GPUMemoryAllocatorType``,
``CUDAKernelMapMode``, ``CoordinateMapType``) are kept for API parity and
select nothing: the port has one coordinate engine, which runs on the
tensors' device.  Also the port's device rule: state goes on the card unless
the caller asks for the CPU.
"""

from __future__ import annotations

import enum
from typing import Sequence, Tuple, Union

import torch


class RegionType(enum.IntEnum):
    """Kernel region shapes (reference: src/types.hpp:152-156)."""

    HYPER_CUBE = 0
    HYPER_CROSS = 1
    CUSTOM = 2
    HYBRID = 3  # Python-level only; expanded to CUSTOM at region build time


class MinkowskiAlgorithm(enum.IntEnum):
    """Strategy hint (reference: src/types.hpp:124-130); no effect here."""

    DEFAULT = 0
    MEMORY_EFFICIENT = 1
    SPEED_OPTIMIZED = 2


class ConvolutionMode(enum.IntEnum):
    """Conv algorithm hint (reference: src/types.hpp:164-170).  The port has
    one sparse-conv path, so every value runs the gather-GEMM."""

    DEFAULT = 0
    DIRECT_GEMM = 1
    COPY_GEMM = 2


class PoolingMode(enum.IntEnum):
    """Pooling reduction modes (reference: src/types.hpp:134-150)."""

    LOCAL_SUM_POOLING = 0
    LOCAL_AVG_POOLING = 1
    LOCAL_MAX_POOLING = 2
    GLOBAL_SUM_POOLING_DEFAULT = 3
    GLOBAL_AVG_POOLING_DEFAULT = 4
    GLOBAL_MAX_POOLING_DEFAULT = 5
    GLOBAL_SUM_POOLING_KERNEL = 6
    GLOBAL_AVG_POOLING_KERNEL = 7
    GLOBAL_MAX_POOLING_KERNEL = 8
    GLOBAL_SUM_POOLING_PYTORCH_INDEX = 9
    GLOBAL_AVG_POOLING_PYTORCH_INDEX = 10
    GLOBAL_MAX_POOLING_PYTORCH_INDEX = 11


class BroadcastMode(enum.IntEnum):
    """Broadcast binary ops (reference: src/types.hpp:157-162; the reference
    spells ADDITON so)."""

    ELEMENTWISE_ADDITON = 0
    ELEMENTWISE_MULTIPLICATION = 1


class GPUMemoryAllocatorType(enum.IntEnum):
    """Allocator selector (reference: src/types.hpp:116-119); PyTorch's
    caching allocator serves every tensor here."""

    PYTORCH = 0
    CUDA = 1


class CUDAKernelMapMode(enum.IntEnum):
    """Kernel-map memory mode (reference: src/types.hpp:121-123); the port's
    kernel maps are always the dense per-offset matchings."""

    MEMORY_EFFICIENT = 0
    SPEED_OPTIMIZED = 1


class CoordinateMapType(enum.IntEnum):
    """Backend selector (reference: CPU/CUDA); one engine serves both."""

    CPU = 0
    CUDA = 1


class SparseTensorOperationMode(enum.IntEnum):
    """Coordinate-manager sharing modes (reference: MinkowskiTensor.py:33-70)."""

    SEPARATE_COORDINATE_MANAGER = 0
    SHARE_COORDINATE_MANAGER = 1


class SparseTensorQuantizationMode(enum.IntEnum):
    """Duplicate-coordinate feature reduction (reference: MinkowskiTensor.py:47-61)."""

    RANDOM_SUBSAMPLE = 0
    UNWEIGHTED_AVERAGE = 1
    UNWEIGHTED_SUM = 2
    NO_QUANTIZATION = 3
    MAX_POOL = 4
    SPLAT_LINEAR_INTERPOLATION = 5


StrideLike = Union[int, Sequence[int]]


def convert_to_int_list(value: StrideLike, dimension: int):
    """Int-or-sequence → length-D list of ints (reference:
    MinkowskiCommon.py:39-55)."""
    return list(as_tuple(value, dimension))


def convert_to_int_tensor(value: StrideLike, dimension: int) -> torch.Tensor:
    """Int-or-sequence → length-D ``torch.IntTensor`` (reference:
    MinkowskiCommon.py:57-74; the JAX package returns numpy)."""
    return torch.tensor(as_tuple(value, dimension), dtype=torch.int32)


def as_tuple(value: StrideLike, dimension: int) -> Tuple[int, ...]:
    """Normalize an int-or-sequence stride-like argument to a D-tuple."""
    if isinstance(value, int):
        return (int(value),) * dimension
    value = tuple(int(v) for v in value)
    if len(value) != dimension:
        raise ValueError(
            f"Expected a sequence of length {dimension}, got {value!r}"
        )
    return value


def resolve_device(device=None) -> torch.device:
    """The device a constructor places its state on: ``device`` when given,
    else the CUDA card.  There is no silent CPU fallback: without a card the
    default raises, and CPU callers pass ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; minkowskiengine_tpu_torch places its "
            "state on the card by default: pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
