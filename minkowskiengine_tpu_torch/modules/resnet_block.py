"""ResNet blocks for sparse tensors.

Counterpart of ``minkowskiengine_tpu/modules/resnet_block.py`` (reference:
MinkowskiEngine/modules/resnet_block.py:1-121).  Attribute names follow the
reference, so state-dict keys match its checkpoints.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.conv import MinkowskiConvolution
from ..nn.nonlinearity import MinkowskiReLU
from ..nn.norm import MinkowskiBatchNorm


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(
        self,
        inplanes: int,
        planes: int,
        stride: int = 1,
        dilation: int = 1,
        downsample: Optional[nn.Module] = None,
        bn_momentum: float = 0.1,
        dimension: int = -1,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if dimension <= 0:
            raise ValueError("dimension must be positive")
        self.conv1 = MinkowskiConvolution(
            inplanes, planes, kernel_size=3, stride=stride, dilation=dilation,
            dimension=dimension, generator=generator, device=device,
        )
        self.norm1 = MinkowskiBatchNorm(planes, momentum=bn_momentum, device=device)
        self.conv2 = MinkowskiConvolution(
            planes, planes, kernel_size=3, stride=1, dilation=dilation,
            dimension=dimension, generator=generator, device=device,
        )
        self.norm2 = MinkowskiBatchNorm(planes, momentum=bn_momentum, device=device)
        self.relu = MinkowskiReLU()
        self.downsample = downsample

    def forward(self, x):
        residual = x
        out = self.relu(self.norm1(self.conv1(x)))
        out = self.norm2(self.conv2(out))
        if self.downsample is not None:
            residual = self.downsample(x)
        out = out + residual
        return self.relu(out)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(
        self,
        inplanes: int,
        planes: int,
        stride: int = 1,
        dilation: int = 1,
        downsample: Optional[nn.Module] = None,
        bn_momentum: float = 0.1,
        dimension: int = -1,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if dimension <= 0:
            raise ValueError("dimension must be positive")
        self.conv1 = MinkowskiConvolution(
            inplanes, planes, kernel_size=1, dimension=dimension,
            generator=generator, device=device,
        )
        self.norm1 = MinkowskiBatchNorm(planes, momentum=bn_momentum, device=device)
        self.conv2 = MinkowskiConvolution(
            planes, planes, kernel_size=3, stride=stride, dilation=dilation,
            dimension=dimension, generator=generator, device=device,
        )
        self.norm2 = MinkowskiBatchNorm(planes, momentum=bn_momentum, device=device)
        self.conv3 = MinkowskiConvolution(
            planes, planes * self.expansion, kernel_size=1, dimension=dimension,
            generator=generator, device=device,
        )
        self.norm3 = MinkowskiBatchNorm(
            planes * self.expansion, momentum=bn_momentum, device=device
        )
        self.relu = MinkowskiReLU()
        self.downsample = downsample

    def forward(self, x):
        residual = x
        out = self.relu(self.norm1(self.conv1(x)))
        out = self.relu(self.norm2(self.conv2(out)))
        out = self.norm3(self.conv3(out))
        if self.downsample is not None:
            residual = self.downsample(x)
        out = out + residual
        return self.relu(out)
