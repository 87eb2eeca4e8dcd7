"""minkowskiengine_tpu_torch: the PyTorch/CUDA port of minkowskiengine_tpu.

Sparse tensors, tensor fields, the coordinate engine, batch collation,
pooling, pruning, union, broadcast, interpolation and splatting, and the
MinkUNet, ResNet, point-cloud classification and generative (CompletionNet,
VAE) models on PyTorch, for inference and training.  The sparse
convolution runs on two hand-written Hopper kernels: the gather-GEMM for the forward and the input
gradient (``kernels/gather_gemm.py``, ``csrc/gather_gemm.cu``) and the
weight gradient (``kernels/conv_dw.py``, ``csrc/conv_dw.cu``).  State goes
on the CUDA card unless the caller passes ``device="cpu"``.  Imports torch
and numpy only.
"""

from .coords.kernel_map import KernelMap
from .coords.manager import CoordinateManager, CoordinateMapKey
from .kernel_generator import KernelGenerator, KernelRegion
from . import nn
from .nn import *  # noqa: F401,F403 (the reference exports every layer at the top level)
from .nn.ops import _sum
from .nn.ops import _sum as sum  # noqa: A001 (the reference's name)
from .sparse_tensor import SparseTensor
from .tensor_field import TensorField
from .tensor import (
    clear_global_coordinate_manager,
    global_coordinate_manager,
    set_global_coordinate_manager,
    set_sparse_tensor_operation_mode,
    sparse_tensor_operation_mode,
)
from .types import (
    BroadcastMode,
    ConvolutionMode,
    PoolingMode,
    RegionType,
    SparseTensorOperationMode,
    SparseTensorQuantizationMode,
)

__all__ = nn.__all__ + [
    "BroadcastMode",
    "ConvolutionMode",
    "CoordinateManager",
    "CoordinateMapKey",
    "KernelGenerator",
    "KernelMap",
    "KernelRegion",
    "PoolingMode",
    "RegionType",
    "SparseTensor",
    "SparseTensorOperationMode",
    "SparseTensorQuantizationMode",
    "TensorField",
    "_sum",
    "clear_global_coordinate_manager",
    "global_coordinate_manager",
    "set_global_coordinate_manager",
    "set_sparse_tensor_operation_mode",
    "sparse_tensor_operation_mode",
    "sum",
]
