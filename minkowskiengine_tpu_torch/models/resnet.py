"""Sparse ResNet classifiers, and the ``_make_layer`` that the MinkUNet
family shares.

Counterpart of ``minkowskiengine_tpu/models/resnet.py`` (reference:
examples/resnet.py:53-200): the same INIT_DIM, PLANES, LAYERS and block
structure.  A ResNet takes a SparseTensor (for point clouds, a
``TensorField(...).sparse()``) and returns one row of logits per batch
item, as a SparseTensor on the origin map.
"""

from __future__ import annotations

from typing import Optional, Type

import torch
from torch import nn

from ..modules.resnet_block import BasicBlock, Bottleneck
from ..nn.conv import MinkowskiConvolution
from ..nn.nonlinearity import MinkowskiDropout, MinkowskiGELU, MinkowskiReLU
from ..nn.norm import MinkowskiBatchNorm, MinkowskiInstanceNorm
from ..nn.ops import MinkowskiLinear
from ..nn.pooling import MinkowskiGlobalMaxPooling, MinkowskiMaxPooling
from ..types import resolve_device


class _Seq(nn.Sequential):
    """Sequential container for sparse-tensor modules; its children are
    numbered like the reference's ``nn.Sequential`` (``block1.0``)."""


class ResNetBase(nn.Module):
    BLOCK: Optional[Type] = None
    LAYERS = ()
    INIT_DIM = 64
    PLANES = (64, 128, 256, 512)

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        D: int = 3,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        """Weights are drawn with ``generator`` on the CPU (reproducible
        across devices), then placed on ``device`` (default: the CUDA card)."""
        super().__init__()
        if self.BLOCK is None:
            raise ValueError("BLOCK is not defined")
        self.D = int(D)
        self.network_initialization(
            in_channels, out_channels, D, generator, resolve_device(device)
        )

    def network_initialization(self, in_channels, out_channels, D, generator, device):
        g = dict(generator=generator, device=device)
        self.inplanes = self.INIT_DIM
        self.conv1 = _Seq(
            MinkowskiConvolution(
                in_channels, self.inplanes, kernel_size=3, stride=2, dimension=D, **g
            ),
            MinkowskiInstanceNorm(self.inplanes, device=device),
            MinkowskiReLU(),
            MinkowskiMaxPooling(kernel_size=2, stride=2, dimension=D),
        )
        for i in range(4):
            layer = self._make_layer(self.BLOCK, self.PLANES[i], self.LAYERS[i], stride=2, **g)
            setattr(self, f"layer{i + 1}", layer)
        self.conv5 = _Seq(
            MinkowskiDropout(),
            MinkowskiConvolution(
                self.inplanes, self.inplanes, kernel_size=3, stride=3, dimension=D, **g
            ),
            MinkowskiInstanceNorm(self.inplanes, device=device),
            MinkowskiGELU(),
        )
        self.glob_pool = MinkowskiGlobalMaxPooling()
        self.final = MinkowskiLinear(self.inplanes, out_channels, bias=True, **g)

    def forward(self, x):
        x = self.conv1(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.conv5(x)
        return self.final(self.glob_pool(x))

    def _make_layer(
        self, block, planes, blocks, stride=1, dilation=1, generator=None, device=None
    ):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = _Seq(
                MinkowskiConvolution(
                    self.inplanes, planes * block.expansion, kernel_size=1,
                    stride=stride, dimension=self.D, generator=generator,
                    device=device,
                ),
                MinkowskiBatchNorm(planes * block.expansion, device=device),
            )
        layers = [
            block(
                self.inplanes, planes, stride=stride, dilation=dilation,
                downsample=downsample, dimension=self.D,
                generator=generator, device=device,
            )
        ]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(
                block(
                    self.inplanes, planes, stride=1, dilation=dilation,
                    dimension=self.D, generator=generator, device=device,
                )
            )
        return _Seq(*layers)


class ResNet14(ResNetBase):
    BLOCK = BasicBlock
    LAYERS = (1, 1, 1, 1)


class ResNet18(ResNetBase):
    BLOCK = BasicBlock
    LAYERS = (2, 2, 2, 2)


class ResNet34(ResNetBase):
    BLOCK = BasicBlock
    LAYERS = (3, 4, 6, 3)


class ResNet50(ResNetBase):
    BLOCK = Bottleneck
    LAYERS = (3, 4, 6, 3)


class ResNet101(ResNetBase):
    BLOCK = Bottleneck
    LAYERS = (3, 4, 23, 3)
