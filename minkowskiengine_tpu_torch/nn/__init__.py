"""Sparse-tensor layers."""

from .conv import (
    MinkowskiConvolution,
    MinkowskiConvolutionBase,
    MinkowskiConvolutionTranspose,
)
from .nonlinearity import MinkowskiReLU
from .norm import MinkowskiBatchNorm
from .ops import cat

__all__ = [
    "MinkowskiBatchNorm",
    "MinkowskiConvolution",
    "MinkowskiConvolutionBase",
    "MinkowskiConvolutionTranspose",
    "MinkowskiReLU",
    "cat",
]
