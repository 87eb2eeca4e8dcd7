"""minkowskiengine_tpu_torch: the PyTorch/CUDA port of minkowskiengine_tpu.

Sparse tensors, tensor fields, the coordinate engine, the data loader's
quantization (a native host engine, ``csrc/hostengine.cpp``) and batch
collation; the bf16 compute path (``config.set_compute_dtype``);
convolution (with channelwise convolution and the Function
shims), pooling, normalization, the nonlinearities and
``MinkowskiFunctional``, pruning, union, broadcast, interpolation and
splatting, SPMM; the MinkUNet, ResNet, point-cloud classification and
generative (CompletionNet, VAE) models, for inference and training; and
geometry replay for training on fresh point clouds (``Geometry``,
``GeometryReplayer``, ``CompiledReplayer``: the coordinate phase recorded
once and replayed per batch, on the card as one CUDA graph); and data,
spatial and tensor parallelism over a ``torch.distributed`` device mesh
(``parallel``, ``spatial_execution``).  The
sparse convolution runs on two hand-written Hopper kernels: the gather-GEMM
for the forward and the input gradient (``kernels/gather_gemm.py``,
``csrc/gather_gemm.cu``) and the weight gradient (``kernels/conv_dw.py``,
``csrc/conv_dw.cu``).  State goes on the CUDA card unless the caller passes
``device="cpu"``.  Imports torch and numpy only.
"""

from .coords.kernel_map import KernelMap
from .coords.manager import (
    CoordinateManager,
    CoordinateMapKey,
    set_coordinate_map_type,
    set_gpu_allocator,
    set_memory_manager_backend,
)
from .coords.map import CoordinateMap
from .coords.geometry import CompiledReplayer, Geometry, GeometryReplayer, stack_geometries
from .kernel_generator import KernelGenerator, KernelRegion, convert_region_type, get_kernel_volume
from . import nn
from .nn import *  # noqa: F401,F403 (the reference exports every layer at the top level)
from .nn import functional as MinkowskiFunctional
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
    CoordinateMapType,
    CUDAKernelMapMode,
    GPUMemoryAllocatorType,
    MinkowskiAlgorithm,
    PoolingMode,
    RegionType,
    SparseTensorOperationMode,
    SparseTensorQuantizationMode,
    convert_to_int_list,
    convert_to_int_tensor,
)
from .sparse_matrix_functions import (
    MinkowskiSPMMAverageFunction,
    MinkowskiSPMMFunction,
    spmm,
    spmm_average,
)
from .diagnostics import (
    cuda_version,
    cudart_version,
    get_gpu_memory_info,
    is_cuda_available,
    print_diagnostics,
)
from . import config
from .config import compute_dtype, set_compute_dtype, set_spatial_execution, spatial_execution
from . import utils
from . import models
from . import parallel

CoordsManager = CoordinateManager  # the reference keeps the v0.4 name

__all__ = nn.__all__ + [
    "BroadcastMode",
    "CUDAKernelMapMode",
    "CompiledReplayer",
    "ConvolutionMode",
    "CoordinateManager",
    "CoordinateMap",
    "CoordinateMapKey",
    "CoordinateMapType",
    "CoordsManager",
    "GPUMemoryAllocatorType",
    "Geometry",
    "GeometryReplayer",
    "KernelGenerator",
    "KernelMap",
    "KernelRegion",
    "MinkowskiAlgorithm",
    "MinkowskiFunctional",
    "MinkowskiSPMMAverageFunction",
    "MinkowskiSPMMFunction",
    "PoolingMode",
    "RegionType",
    "SparseTensor",
    "SparseTensorOperationMode",
    "SparseTensorQuantizationMode",
    "TensorField",
    "_sum",
    "clear_global_coordinate_manager",
    "compute_dtype",
    "config",
    "convert_region_type",
    "convert_to_int_list",
    "convert_to_int_tensor",
    "cuda_version",
    "cudart_version",
    "get_gpu_memory_info",
    "get_kernel_volume",
    "global_coordinate_manager",
    "is_cuda_available",
    "models",
    "parallel",
    "print_diagnostics",
    "set_compute_dtype",
    "set_coordinate_map_type",
    "set_global_coordinate_manager",
    "set_gpu_allocator",
    "set_memory_manager_backend",
    "set_sparse_tensor_operation_mode",
    "set_spatial_execution",
    "sparse_tensor_operation_mode",
    "spatial_execution",
    "spmm",
    "spmm_average",
    "stack_geometries",
    "sum",
    "utils",
]
