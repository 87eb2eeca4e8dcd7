"""minkowskiengine_tpu_torch: the PyTorch/CUDA port of minkowskiengine_tpu.

Sparse tensors, tensor fields, the coordinate engine, batch collation,
pooling, pruning, union, and the MinkUNet, ResNet, point-cloud
classification and generative (CompletionNet, VAE) models on PyTorch, for
inference and training.  The sparse convolution runs on two
hand-written Hopper kernels: the gather-GEMM for the forward and the input
gradient (``kernels/gather_gemm.py``, ``csrc/gather_gemm.cu``) and the
weight gradient (``kernels/conv_dw.py``, ``csrc/conv_dw.cu``).  State goes
on the CUDA card unless the caller passes ``device="cpu"``.  Imports torch
and numpy only.
"""

from .coords.kernel_map import KernelMap
from .coords.manager import CoordinateManager, CoordinateMapKey
from .kernel_generator import KernelGenerator, KernelRegion
from .nn import (
    MinkowskiAvgPooling,
    MinkowskiBatchNorm,
    MinkowskiConvolution,
    MinkowskiConvolutionTranspose,
    MinkowskiDropout,
    MinkowskiELU,
    MinkowskiGELU,
    MinkowskiGenerativeConvolutionTranspose,
    MinkowskiGlobalAvgPooling,
    MinkowskiGlobalMaxPooling,
    MinkowskiGlobalPooling,
    MinkowskiGlobalSumPooling,
    MinkowskiInstanceNorm,
    MinkowskiLeakyReLU,
    MinkowskiLinear,
    MinkowskiMaxPooling,
    MinkowskiPoolingTranspose,
    MinkowskiPruning,
    MinkowskiReLU,
    MinkowskiStableInstanceNorm,
    MinkowskiSumPooling,
    MinkowskiToFeature,
    MinkowskiUnion,
    cat,
)
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
    ConvolutionMode,
    PoolingMode,
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
    "MinkowskiAvgPooling",
    "MinkowskiBatchNorm",
    "MinkowskiConvolution",
    "MinkowskiConvolutionTranspose",
    "MinkowskiDropout",
    "MinkowskiELU",
    "MinkowskiGELU",
    "MinkowskiGenerativeConvolutionTranspose",
    "MinkowskiGlobalAvgPooling",
    "MinkowskiGlobalMaxPooling",
    "MinkowskiGlobalPooling",
    "MinkowskiGlobalSumPooling",
    "MinkowskiInstanceNorm",
    "MinkowskiLeakyReLU",
    "MinkowskiLinear",
    "MinkowskiMaxPooling",
    "MinkowskiPoolingTranspose",
    "MinkowskiPruning",
    "MinkowskiReLU",
    "MinkowskiStableInstanceNorm",
    "MinkowskiSumPooling",
    "MinkowskiToFeature",
    "MinkowskiUnion",
    "PoolingMode",
    "RegionType",
    "SparseTensor",
    "SparseTensorOperationMode",
    "SparseTensorQuantizationMode",
    "TensorField",
    "cat",
    "clear_global_coordinate_manager",
    "global_coordinate_manager",
    "set_global_coordinate_manager",
    "set_sparse_tensor_operation_mode",
    "sparse_tensor_operation_mode",
]
