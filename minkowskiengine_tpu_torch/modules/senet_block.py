"""Squeeze-and-excitation blocks.

Counterpart of ``minkowskiengine_tpu/modules/senet_block.py`` (reference:
MinkowskiEngine/modules/senet_block.py:31-129).  The SE layer pools each
batch item to one row, passes it through two linears, and scales every
row of the item by the result.  Its linears are named ``fc1`` and ``fc2``,
as in the JAX package, so weights cross through its exporter one to one;
the reference holds them in an ``nn.Sequential`` named ``fc`` (ROADMAP
queue 3).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.broadcast import MinkowskiBroadcastMultiplication
from ..nn.nonlinearity import MinkowskiReLU, MinkowskiSigmoid
from ..nn.ops import MinkowskiLinear
from ..nn.pooling import MinkowskiGlobalPooling
from .resnet_block import BasicBlock, Bottleneck


class SELayer(nn.Module):
    """x * sigmoid(fc2(relu(fc1(global_avg_pool(x))))), per batch item."""

    def __init__(
        self,
        channel: int,
        reduction: int = 16,
        D: int = -1,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        g = dict(generator=generator, device=device)
        self.fc1 = MinkowskiLinear(channel, channel // reduction, **g)
        self.relu = MinkowskiReLU()
        self.fc2 = MinkowskiLinear(channel // reduction, channel, **g)
        self.sigmoid = MinkowskiSigmoid()
        self.pooling = MinkowskiGlobalPooling()
        self.broadcast_mul = MinkowskiBroadcastMultiplication()

    def forward(self, x):
        y = self.sigmoid(self.fc2(self.relu(self.fc1(self.pooling(x)))))
        return self.broadcast_mul(x, y)


class SEBasicBlock(BasicBlock):
    """``BasicBlock`` with an SE layer on the second conv's normalized output."""

    def __init__(
        self,
        inplanes: int,
        planes: int,
        stride: int = 1,
        dilation: int = 1,
        downsample: Optional[nn.Module] = None,
        reduction: int = 16,
        dimension: int = -1,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        g = dict(generator=generator, device=device)
        super().__init__(inplanes, planes, stride=stride, dilation=dilation, downsample=downsample,
                         dimension=dimension, **g)
        self.se = SELayer(planes, reduction=reduction, D=dimension, **g)

    def forward(self, x):
        residual = x
        out = self.relu(self.norm1(self.conv1(x)))
        out = self.se(self.norm2(self.conv2(out)))
        if self.downsample is not None:
            residual = self.downsample(x)
        return self.relu(out + residual)


class SEBottleneck(Bottleneck):
    """``Bottleneck`` with an SE layer on the third conv's normalized output."""

    def __init__(
        self,
        inplanes: int,
        planes: int,
        stride: int = 1,
        dilation: int = 1,
        downsample: Optional[nn.Module] = None,
        dimension: int = 3,
        reduction: int = 16,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        g = dict(generator=generator, device=device)
        super().__init__(inplanes, planes, stride=stride, dilation=dilation, downsample=downsample,
                         dimension=dimension, **g)
        self.se = SELayer(planes * self.expansion, reduction=reduction, D=dimension, **g)

    def forward(self, x):
        residual = x
        out = self.relu(self.norm1(self.conv1(x)))
        out = self.relu(self.norm2(self.conv2(out)))
        out = self.se(self.norm3(self.conv3(out)))
        if self.downsample is not None:
            residual = self.downsample(x)
        return self.relu(out + residual)
