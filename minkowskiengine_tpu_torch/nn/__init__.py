"""Sparse-tensor layers."""

from .conv import (
    MinkowskiConvolution,
    MinkowskiConvolutionBase,
    MinkowskiConvolutionTranspose,
    MinkowskiGenerativeConvolutionTranspose,
)
from .nonlinearity import (
    MinkowskiDropout,
    MinkowskiELU,
    MinkowskiGELU,
    MinkowskiLeakyReLU,
    MinkowskiReLU,
)
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
from .pruning import MinkowskiPruning, MinkowskiPruningFunction
from .union import MinkowskiUnion, MinkowskiUnionFunction

__all__ = [
    "MinkowskiAvgPooling",
    "MinkowskiBatchNorm",
    "MinkowskiConvolution",
    "MinkowskiConvolutionBase",
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
    "MinkowskiPruningFunction",
    "MinkowskiReLU",
    "MinkowskiStableInstanceNorm",
    "MinkowskiSumPooling",
    "MinkowskiToFeature",
    "MinkowskiUnion",
    "MinkowskiUnionFunction",
    "cat",
]
