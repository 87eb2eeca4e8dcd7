"""ResNet base: ``_make_layer``, which the MinkUNet family shares.

Counterpart of ``minkowskiengine_tpu/models/resnet.py`` (reference:
examples/resnet.py:53-200).  The classification ResNets themselves need
InstanceNorm, pooling and a linear head, which are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Type

import torch
from torch import nn

from ..nn.conv import MinkowskiConvolution
from ..nn.norm import MinkowskiBatchNorm


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
        across devices), then placed on ``device``."""
        super().__init__()
        if self.BLOCK is None:
            raise ValueError("BLOCK is not defined")
        self.D = int(D)
        self.network_initialization(in_channels, out_channels, D, generator, device)

    def network_initialization(self, in_channels, out_channels, D, generator, device):
        raise NotImplementedError(
            "classification ResNets (InstanceNorm, pooling, linear head) are "
            "not ported yet"
        )

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
