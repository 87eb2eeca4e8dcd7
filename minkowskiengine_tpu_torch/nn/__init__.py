"""Sparse-tensor layers."""

from .conv import (
    MinkowskiConvolution,
    MinkowskiConvolutionBase,
    MinkowskiConvolutionTranspose,
)
from .nonlinearity import MinkowskiDropout, MinkowskiGELU, MinkowskiLeakyReLU, MinkowskiReLU
from .norm import MinkowskiBatchNorm, MinkowskiInstanceNorm, MinkowskiStableInstanceNorm
from .ops import MinkowskiLinear, MinkowskiToFeature, cat
from .pooling import (
    MinkowskiAvgPooling,
    MinkowskiGlobalAvgPooling,
    MinkowskiGlobalMaxPooling,
    MinkowskiGlobalPooling,
    MinkowskiGlobalSumPooling,
    MinkowskiMaxPooling,
    MinkowskiPoolingTranspose,
    MinkowskiSumPooling,
)

__all__ = [
    "MinkowskiAvgPooling",
    "MinkowskiBatchNorm",
    "MinkowskiConvolution",
    "MinkowskiConvolutionBase",
    "MinkowskiConvolutionTranspose",
    "MinkowskiDropout",
    "MinkowskiGELU",
    "MinkowskiGlobalAvgPooling",
    "MinkowskiGlobalMaxPooling",
    "MinkowskiGlobalPooling",
    "MinkowskiGlobalSumPooling",
    "MinkowskiInstanceNorm",
    "MinkowskiLeakyReLU",
    "MinkowskiLinear",
    "MinkowskiMaxPooling",
    "MinkowskiPoolingTranspose",
    "MinkowskiReLU",
    "MinkowskiStableInstanceNorm",
    "MinkowskiSumPooling",
    "MinkowskiToFeature",
    "cat",
]
