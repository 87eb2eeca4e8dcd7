"""minkowskiengine_tpu_torch: the PyTorch/CUDA port of minkowskiengine_tpu.

Sparse tensors, the coordinate engine, batch collation and the MinkUNet
family on PyTorch, for inference and training.  The sparse convolution runs
on two hand-written Hopper kernels: the gather-GEMM for the forward and the
input gradient (``kernels/gather_gemm.py``, ``csrc/gather_gemm.cu``) and the
weight gradient (``kernels/conv_dw.py``, ``csrc/conv_dw.cu``).  Imports torch
and numpy only.
"""

from .coords.kernel_map import KernelMap
from .coords.manager import CoordinateManager, CoordinateMapKey
from .kernel_generator import KernelGenerator, KernelRegion
from .nn import (
    MinkowskiBatchNorm,
    MinkowskiConvolution,
    MinkowskiConvolutionTranspose,
    MinkowskiReLU,
    cat,
)
from .sparse_tensor import SparseTensor
from .tensor import (
    clear_global_coordinate_manager,
    global_coordinate_manager,
    set_global_coordinate_manager,
    set_sparse_tensor_operation_mode,
    sparse_tensor_operation_mode,
)
from .types import (
    ConvolutionMode,
    RegionType,
    SparseTensorOperationMode,
    SparseTensorQuantizationMode,
)

__all__ = [
    "ConvolutionMode",
    "CoordinateManager",
    "CoordinateMapKey",
    "KernelGenerator",
    "KernelMap",
    "KernelRegion",
    "MinkowskiBatchNorm",
    "MinkowskiConvolution",
    "MinkowskiConvolutionTranspose",
    "MinkowskiReLU",
    "RegionType",
    "SparseTensor",
    "SparseTensorOperationMode",
    "SparseTensorQuantizationMode",
    "cat",
    "clear_global_coordinate_manager",
    "global_coordinate_manager",
    "set_global_coordinate_manager",
    "set_sparse_tensor_operation_mode",
    "sparse_tensor_operation_mode",
]
