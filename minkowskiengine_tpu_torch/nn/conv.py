"""Convolution modules.

Counterpart of ``minkowskiengine_tpu/nn/conv.py`` (reference:
MinkowskiEngine/MinkowskiConvolution.py:204-634 and
MinkowskiChannelwiseConvolution.py).  The coordinate work (output map,
kernel map) runs in the cached manager; the feature work is
``ops.functional.sparse_conv_kmap``, a plain product for stride-1 volume-1
kernels, or ``ops.functional.channelwise_conv`` for the depthwise conv.
The ``.apply`` shims of the reference's autograd Functions build the same
kernel map as the modules and run the same ``sparse_conv_kmap``.  Under
``config.set_compute_dtype`` the conv modules cast their input features to
that dtype, as JAX's do (nn/conv.py:273-318); the float32 weight goes into
the conv's autograd Function, which casts it (its gradient stays float32),
and the volume-1 product and the bias run in the features' dtype.  The
channelwise conv casts nothing, as in JAX.

The dense-grid route (``ops/dense_conv.py``): a stride-1 HYPER_CUBE conv
whose output is its input map may run as one cuDNN conv over the map's
bbox grid, when the gate (``dense_conv_beneficial``, fitted on the H100)
says it costs less than K1 and K2.  ``_dense_dispatch`` keeps JAX's
conditions (JAX nn/conv.py:177-240), with "the backend is a TPU" read as
"the features are on the card": on the CPU the port never routes dense,
as JAX on the CPU does not.  ``ConvolutionMode.COPY_GEMM`` keeps a conv
off the route and changes nothing else; transposed, strided and
non-cube convs and spatial execution stay sparse.

Parallel execution (``parallel/``): on a row block (spatial execution) a
conv runs the halo path (``sparse_conv_kmap``), or, at volume 1, its
row-local product; the kernel of that product and the bias enter through
``RowBlock.replicated`` so their gradients sum over the group, and the
output keeps the block.  The channelwise conv takes no row block.
``apply_tensor_parallelism`` cuts a conv's Cout and wraps its calls in
hooks of its own; the conv computes whatever slice its kernel holds.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from ..config import compute_dtype, spatial_execution_ctx
from ..coords.manager import CoordinateManager, CoordinateMapKey
from ..kernel_generator import KernelGenerator
from ..ops import functional as F
from ..ops.dense_conv import dense_conv, dense_conv_beneficial
from ..sparse_tensor import SparseTensor, whole_rows
from ..types import ConvolutionMode, RegionType, resolve_device


def _resolve_out_key(input: SparseTensor, coordinates, out_tensor_stride):
    """Explicit output coordinates: a key, a SparseTensor, or raw coordinates
    inserted at the layer's output tensor stride."""
    if coordinates is None:
        return None
    if isinstance(coordinates, CoordinateMapKey):
        return coordinates
    if isinstance(coordinates, SparseTensor):
        return coordinates.coordinate_map_key
    key, _ = input.coordinate_manager.insert_and_map(coordinates, out_tensor_stride)
    return key


def _expected_out_ts(in_key, kernel_generator, is_transpose):
    """Output tensor stride of a (transposed) conv layer."""
    in_ts = in_key.get_tensor_stride()
    stride = kernel_generator.kernel_stride
    if is_transpose:
        return tuple(t // s for t, s in zip(in_ts, stride))
    return tuple(t * s for t, s in zip(in_ts, stride))


def _conv_out_key(
    manager: CoordinateManager,
    in_key: CoordinateMapKey,
    kernel_generator: KernelGenerator,
    is_transpose: bool,
    expand_coordinates: bool,
) -> CoordinateMapKey:
    """Create or reuse the output coordinate map (reference:
    src/convolution_cpu.cpp:70-108, src/convolution_transpose_cpu.cpp:70-99)."""
    in_ts = in_key.get_tensor_stride()
    stride = kernel_generator.kernel_stride
    if not is_transpose:
        if expand_coordinates:
            out_ts = tuple(t * s for t, s in zip(in_ts, stride))
            region = kernel_generator.get_kernel(in_ts, False)
            return manager.stride_region(
                in_key, region, out_ts, expand_coordinates=True, is_transpose=False
            )
        return manager.stride(in_key, stride)
    for t, s in zip(in_ts, stride):
        if t % s != 0:
            raise ValueError(f"Invalid up stride {stride} for tensor stride {in_ts}")
    out_ts = tuple(t // s for t, s in zip(in_ts, stride))
    region = kernel_generator.get_kernel(in_ts, True)
    return manager.stride_region(
        in_key, region, out_ts, expand_coordinates=expand_coordinates, is_transpose=True
    )


def _kernel_map_between(kernel_generator, in_key, out_key, manager, is_transpose):
    """The kernel map a conv module builds between the two maps."""
    kg = kernel_generator
    region = kg.get_kernel(in_key.get_tensor_stride(), is_transpose)
    custom = region.offsets if region.region_type == RegionType.CUSTOM else None
    return manager.kernel_map(
        in_key, out_key, stride=kg.kernel_stride, kernel_size=kg.kernel_size,
        dilation=kg.kernel_dilation, region_type=region.region_type,
        region_offsets=custom, is_transpose=is_transpose, is_pool=False,
    )


class MinkowskiConvolutionBase(nn.Module):
    """Shared logic of convolution and transposed convolution.

    Parameters: ``kernel`` (K, Cin, Cout), or (Cin, Cout) for a stride-1
    volume-1 kernel, and an optional ``bias`` stored (1, Cout).  Both are
    drawn from U(±1/√(fan·K)) (reference: MinkowskiConvolution.py:330-339)
    with ``generator`` on the CPU, then moved to ``device`` (default: the
    CUDA card).
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size=-1,
        stride=1,
        dilation=1,
        bias: bool = False,
        kernel_generator: Optional[KernelGenerator] = None,
        is_transpose: bool = False,
        expand_coordinates: bool = False,
        convolution_mode: ConvolutionMode = ConvolutionMode.DEFAULT,
        dimension: int = -1,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if dimension <= 0:
            raise ValueError(f"Invalid dimension {dimension}")
        if kernel_generator is None:
            kernel_generator = KernelGenerator(
                kernel_size=kernel_size,
                stride=stride,
                dilation=dilation,
                is_transpose=is_transpose,
                expand_coordinates=expand_coordinates,
                dimension=dimension,
            )
        else:
            kernel_generator.expand_coordinates = expand_coordinates
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.is_transpose = bool(is_transpose)
        self.expand_coordinates = bool(expand_coordinates)
        self.kernel_generator = kernel_generator
        self.dimension = int(dimension)
        self.convolution_mode = ConvolutionMode(convolution_mode)

        # volume-1 stride-1 kernels collapse to a plain product
        # (reference: MinkowskiConvolution.py:262-285)
        self.use_mm = (
            kernel_generator.kernel_volume == 1
            and kernel_generator.requires_strided_coordinates
        )
        if self.use_mm:
            kernel_shape = (self.in_channels, self.out_channels)
        else:
            kernel_shape = (kernel_generator.kernel_volume, self.in_channels, self.out_channels)
        fan = self.out_channels if is_transpose else self.in_channels
        stdv = 1.0 / math.sqrt(fan * kernel_generator.kernel_volume)
        dev = resolve_device(device)

        def uniform(shape):
            t = torch.empty(shape, dtype=torch.float32)
            return nn.Parameter(t.uniform_(-stdv, stdv, generator=generator).to(dev))

        self.kernel = uniform(kernel_shape)
        self.bias = uniform((1, self.out_channels)) if bias else None

    def _dense_dispatch(self, input: SparseTensor, coordinates, feats) -> bool:
        """Whether this call takes the dense-grid route (module docstring)."""
        kg = self.kernel_generator
        if (
            spatial_execution_ctx() is not None  # the halo path needs the kernel map
            or input.row_block is not None
            or coordinates is not None
            or self.is_transpose
            or self.expand_coordinates
            or not kg.requires_strided_coordinates  # stride != 1
            or kg.region_type != RegionType.HYPER_CUBE
            or kg.axis_types is not None
            or not feats.is_cuda
            or self.convolution_mode == ConvolutionMode.COPY_GEMM
        ):
            return False
        key, mgr = input.coordinate_map_key, input.coordinate_manager
        plan = mgr.dense_plan(key)
        cached = mgr.has_kernel_map(
            key, key, stride=kg.kernel_stride, kernel_size=kg.kernel_size,
            dilation=kg.kernel_dilation, region_type=RegionType.HYPER_CUBE,
        )
        return dense_conv_beneficial(
            plan, feats.shape[0], kg.kernel_volume, self.kernel.shape[-2], self.kernel.shape[-1],
            map_cached=cached,
        )

    def _kernel_map(self, input: SparseTensor, out_key: CoordinateMapKey):
        return _kernel_map_between(
            self.kernel_generator, input.coordinate_map_key, out_key,
            input.coordinate_manager, self.is_transpose,
        )

    def forward(
        self,
        input: SparseTensor,
        coordinates: Union[None, torch.Tensor, CoordinateMapKey, SparseTensor] = None,
    ) -> SparseTensor:
        if not isinstance(input, SparseTensor):
            raise TypeError("input must be a SparseTensor")
        if input.D != self.dimension:
            raise ValueError(f"input dimension {input.D} != layer dimension {self.dimension}")
        if input.F.shape[1] != self.in_channels:
            raise ValueError(f"input channels {input.F.shape[1]} != {self.in_channels}")

        feats = input.F
        cdt = compute_dtype()
        if cdt is not None and feats.dtype != cdt:
            feats = feats.to(cdt)
        block, bias = input.row_block, self.bias
        if block is not None and bias is not None:
            bias = block.replicated(bias)
        if self.use_mm and coordinates is None:
            kernel = self.kernel if block is None else block.replicated(self.kernel)
            outfeat = feats @ kernel.to(feats.dtype)
            out_key = input.coordinate_map_key
        elif self._dense_dispatch(input, coordinates, feats):
            kg = self.kernel_generator
            out_key = input.coordinate_map_key
            plan = input.coordinate_manager.dense_plan(out_key)
            outfeat = dense_conv(
                feats, self.kernel.to(feats.dtype), plan, kg.kernel_size, kg.kernel_dilation
            )
        else:
            if block is not None and spatial_execution_ctx() != (block.mesh, block.axis_name):
                raise ValueError(
                    "a row block's convs run under MT.spatial_execution of its own mesh axis"
                )
            out_key = _resolve_out_key(
                input,
                coordinates,
                _expected_out_ts(input.coordinate_map_key, self.kernel_generator, self.is_transpose),
            )
            if out_key is None:
                out_key = _conv_out_key(
                    input.coordinate_manager,
                    input.coordinate_map_key,
                    self.kernel_generator,
                    self.is_transpose,
                    self.expand_coordinates,
                )
            kmap = self._kernel_map(input, out_key)
            kernel = self.kernel if self.kernel.ndim == 3 else self.kernel[None]
            outfeat = F.sparse_conv_kmap(feats.contiguous(), kernel.contiguous(), kmap)
        if bias is not None:
            outfeat = outfeat + bias.to(outfeat.dtype)
        return SparseTensor(
            outfeat, coordinate_map_key=out_key, coordinate_manager=input.coordinate_manager,
            row_block=block,
        )

    def extra_repr(self):
        kg = self.kernel_generator
        return (
            f"in={self.in_channels}, out={self.out_channels}, "
            f"kernel_size={kg.kernel_size}, stride={kg.kernel_stride}, "
            f"dilation={kg.kernel_dilation}, mode={self.convolution_mode.name}"
        )


class MinkowskiConvolution(MinkowskiConvolutionBase):
    """Generalized sparse convolution (reference: MinkowskiConvolution.py:360-451)."""

    def __init__(
        self,
        in_channels,
        out_channels,
        kernel_size=-1,
        stride=1,
        dilation=1,
        bias=False,
        kernel_generator=None,
        expand_coordinates=False,
        convolution_mode=ConvolutionMode.DEFAULT,
        dimension=-1,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__(
            in_channels, out_channels, kernel_size, stride, dilation, bias,
            kernel_generator, is_transpose=False,
            expand_coordinates=expand_coordinates,
            convolution_mode=convolution_mode,
            dimension=dimension,
            generator=generator, device=device,
        )


class MinkowskiConvolutionTranspose(MinkowskiConvolutionBase):
    """Transposed (upsampling) sparse convolution (reference:
    MinkowskiConvolution.py:454-536)."""

    def __init__(
        self,
        in_channels,
        out_channels,
        kernel_size=-1,
        stride=1,
        dilation=1,
        bias=False,
        kernel_generator=None,
        expand_coordinates=False,
        convolution_mode=ConvolutionMode.DEFAULT,
        dimension=-1,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__(
            in_channels, out_channels, kernel_size, stride, dilation, bias,
            kernel_generator, is_transpose=True,
            expand_coordinates=expand_coordinates,
            convolution_mode=convolution_mode,
            dimension=dimension,
            generator=generator, device=device,
        )


class MinkowskiGenerativeConvolutionTranspose(MinkowskiConvolutionBase):
    """Transposed convolution that always generates new coordinates: every
    input voxel spreads to each offset of the kernel at the finer stride,
    even where a map of that stride exists (reference:
    MinkowskiConvolution.py:539-634).  Its output map takes a fresh string
    id, ``map-N``, when the input's lineage id is taken at that stride."""

    def __init__(
        self,
        in_channels,
        out_channels,
        kernel_size=-1,
        stride=1,
        dilation=1,
        bias=False,
        kernel_generator=None,
        convolution_mode=ConvolutionMode.DEFAULT,
        dimension=-1,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__(
            in_channels, out_channels, kernel_size, stride, dilation, bias,
            kernel_generator, is_transpose=True, expand_coordinates=True,
            convolution_mode=convolution_mode, dimension=dimension,
            generator=generator, device=device,
        )


class MinkowskiConvolutionFunction:
    """The reference's autograd Function (MinkowskiConvolution.py:42-121)
    for code that calls ``.apply`` directly: ``apply(input_features,
    kernel_weights (K, Cin, Cout), kernel_generator, convolution_mode,
    in_coordinate_map_key, out_coordinate_map_key, coordinate_manager)``
    returns the output features.  ``convolution_mode`` selects nothing."""

    _is_transpose = False

    @classmethod
    def apply(
        cls,
        input_features,
        kernel_weights,
        kernel_generator: KernelGenerator,
        convolution_mode,
        in_coordinate_map_key: CoordinateMapKey,
        out_coordinate_map_key: CoordinateMapKey,
        coordinate_manager: CoordinateManager,
    ):
        kmap = _kernel_map_between(
            kernel_generator, in_coordinate_map_key, out_coordinate_map_key,
            coordinate_manager, is_transpose=cls._is_transpose,
        )
        return F.sparse_conv_kmap(input_features.contiguous(), kernel_weights.contiguous(), kmap)


class MinkowskiConvolutionTransposeFunction(MinkowskiConvolutionFunction):
    """Transposed counterpart (reference: MinkowskiConvolution.py:124-201)."""

    _is_transpose = True


class MinkowskiChannelwiseConvolution(nn.Module):
    """Depthwise sparse convolution: each channel has its own (K,) filter
    (reference: MinkowskiChannelwiseConvolution.py:47-215).

    Parameters: ``kernel`` (K, C) and an optional ``bias`` (1, C), drawn
    from U(±1/√(C·K)) with ``generator`` on the CPU, kernel first, then
    moved to ``device`` (default: the CUDA card).  The output map is the
    input's strided map, or the given ``coordinates``, as for the conv."""

    def __init__(
        self,
        in_channels: int,
        kernel_size=-1,
        stride=1,
        dilation=1,
        bias: bool = False,
        kernel_generator: Optional[KernelGenerator] = None,
        dimension: int = -1,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if dimension <= 0:
            raise ValueError(f"Invalid dimension {dimension}")
        if kernel_generator is None:
            kernel_generator = KernelGenerator(
                kernel_size=kernel_size, stride=stride, dilation=dilation, dimension=dimension,
            )
        self.in_channels = self.out_channels = int(in_channels)
        self.kernel_generator = kernel_generator
        self.dimension = int(dimension)
        stdv = 1.0 / math.sqrt(self.in_channels * kernel_generator.kernel_volume)
        dev = resolve_device(device)

        def uniform(shape):
            t = torch.empty(shape, dtype=torch.float32)
            return nn.Parameter(t.uniform_(-stdv, stdv, generator=generator).to(dev))

        self.kernel = uniform((kernel_generator.kernel_volume, self.in_channels))
        self.bias = uniform((1, self.in_channels)) if bias else None

    def forward(
        self,
        input: SparseTensor,
        coordinates: Union[None, torch.Tensor, CoordinateMapKey, SparseTensor] = None,
    ) -> SparseTensor:
        if input.F.shape[1] != self.in_channels:
            raise ValueError(f"input channels {input.F.shape[1]} != {self.in_channels}")
        whole_rows(input, "the channelwise convolution")
        kg = self.kernel_generator
        manager = input.coordinate_manager
        out_key = _resolve_out_key(
            input, coordinates, _expected_out_ts(input.coordinate_map_key, kg, False)
        )
        if out_key is None:
            out_key = manager.stride(input.coordinate_map_key, kg.kernel_stride)
        kmap = _kernel_map_between(kg, input.coordinate_map_key, out_key, manager, is_transpose=False)
        outfeat = F.channelwise_conv(input.F, self.kernel, kmap.in_idx)
        if self.bias is not None:
            outfeat = outfeat + self.bias
        return SparseTensor(outfeat, coordinate_map_key=out_key, coordinate_manager=manager)

    def extra_repr(self):
        kg = self.kernel_generator
        return (
            f"in={self.in_channels}, kernel_size={kg.kernel_size}, "
            f"stride={kg.kernel_stride}, dilation={kg.kernel_dilation}"
        )
