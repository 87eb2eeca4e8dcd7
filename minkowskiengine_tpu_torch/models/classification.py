"""Point-cloud classification models (the ModelNet40 family).

Counterpart of ``minkowskiengine_tpu/models/classification.py`` (reference:
examples/classification_modelnet40.py:68-258): ``MinkowskiFCNN``,
``MinkowskiSplatFCNN``, ``MinkowskiPointNet`` and ``GlobalMaxAvgPool``, with
the reference's channel schedules, pooling layout and field↔sparse hops,
and its state-dict names (``mlp1.0.linear.weight``, ``conv5.0.0.kernel``,
``final.3.linear.bias``).  The models take a TensorField and return (batch
size, classes) logits.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.conv import MinkowskiConvolution
from ..nn.network import MinkowskiNetwork
from ..nn.nonlinearity import MinkowskiDropout, MinkowskiLeakyReLU
from ..nn.norm import MinkowskiBatchNorm
from ..nn.ops import MinkowskiLinear, cat
from ..nn.pooling import MinkowskiGlobalAvgPooling, MinkowskiGlobalMaxPooling, MinkowskiMaxPooling
from ..tensor_field import TensorField
from ..types import resolve_device
from .resnet import _Seq


def _mlp_block(cin, cout, generator, device):
    return _Seq(
        MinkowskiLinear(cin, cout, bias=False, generator=generator, device=device),
        MinkowskiBatchNorm(cout, device=device),
        MinkowskiLeakyReLU(),
    )


class MinkowskiFCNN(MinkowskiNetwork):
    """Fully convolutional classifier over a TensorField.  Weights are drawn
    with ``generator`` on the CPU, then placed on ``device`` (default: the
    CUDA card)."""

    def __init__(
        self,
        in_channel: int,
        out_channel: int,
        embedding_channel: int = 1024,
        channels=(32, 48, 64, 96, 128),
        D: int = 3,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__(D)
        device = resolve_device(device)
        self.channels = tuple(channels)
        self.embedding_channel = int(embedding_channel)

        def mlp_block(cin, cout):
            return _mlp_block(cin, cout, generator, device)

        def conv_block(cin, cout, kernel_size, stride):
            return _Seq(
                MinkowskiConvolution(
                    cin, cout, kernel_size=kernel_size, stride=stride, dimension=D,
                    generator=generator, device=device,
                ),
                MinkowskiBatchNorm(cout, device=device),
                MinkowskiLeakyReLU(),
            )

        self.mlp1 = mlp_block(in_channel, channels[0])
        self.conv1 = conv_block(channels[0], channels[1], 3, 1)
        self.conv2 = conv_block(channels[1], channels[2], 3, 2)
        self.conv3 = conv_block(channels[2], channels[3], 3, 2)
        self.conv4 = conv_block(channels[3], channels[4], 3, 2)
        self.conv5 = _Seq(
            conv_block(sum(channels[1:5]), embedding_channel // 4, 3, 2),
            conv_block(embedding_channel // 4, embedding_channel // 2, 3, 2),
            conv_block(embedding_channel // 2, embedding_channel, 3, 2),
        )
        self.pool = MinkowskiMaxPooling(kernel_size=3, stride=2, dimension=D)
        self.global_max_pool = MinkowskiGlobalMaxPooling()
        self.global_avg_pool = MinkowskiGlobalAvgPooling()
        self.final = _Seq(
            mlp_block(embedding_channel * 2, 512),
            MinkowskiDropout(),
            mlp_block(512, 512),
            MinkowskiLinear(512, out_channel, bias=True, generator=generator, device=device),
        )

    def _voxelize(self, x: TensorField):
        return x.sparse()

    def forward(self, x: TensorField) -> torch.Tensor:
        x = self.mlp1(x)
        y = self._voxelize(x)

        y = self.conv1(y)
        y1 = self.pool(y)
        y = self.conv2(y1)
        y2 = self.pool(y)
        y = self.conv3(y2)
        y3 = self.pool(y)
        y = self.conv4(y3)
        y4 = self.pool(y)

        x = cat(y1.slice(x), y2.slice(x), y3.slice(x), y4.slice(x))

        y = self.conv5(x.sparse())
        return self.final(cat(self.global_max_pool(y), self.global_avg_pool(y))).F


class MinkowskiSplatFCNN(MinkowskiFCNN):
    """``MinkowskiFCNN`` that voxelizes by multilinear splatting
    (``TensorField.splat``) instead of averaging (reference:
    classification_modelnet40.py:231-258); the same modules and state-dict
    names."""

    def _voxelize(self, x: TensorField):
        return x.splat()


class GlobalMaxAvgPool(nn.Module):
    """Global max and average pooling, concatenated."""

    def __init__(self):
        super().__init__()
        self.global_max_pool = MinkowskiGlobalMaxPooling()
        self.global_avg_pool = MinkowskiGlobalAvgPooling()

    def forward(self, tensor):
        return cat(self.global_max_pool(tensor), self.global_avg_pool(tensor))


class MinkowskiPointNet(MinkowskiNetwork):
    """PointNet-style per-point MLP, global max pooling and an MLP head over a
    TensorField (the reference example's "minkpointnet")."""

    def __init__(
        self,
        in_channel: int,
        out_channel: int,
        embedding_channel: int = 1024,
        dimension: int = 3,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__(dimension)
        device = resolve_device(device)

        def block(cin, cout):
            return _mlp_block(cin, cout, generator, device)

        self.conv1 = block(in_channel, 64)
        self.conv2 = block(64, 64)
        self.conv3 = block(64, 64)
        self.conv4 = block(64, 128)
        self.conv5 = block(128, embedding_channel)
        self.max_pool = MinkowskiGlobalMaxPooling()
        self.linear1 = block(embedding_channel, 512)
        self.dp1 = MinkowskiDropout()
        self.linear2 = MinkowskiLinear(
            512, out_channel, bias=True, generator=generator, device=device
        )

    def forward(self, x: TensorField) -> torch.Tensor:
        x = self.conv5(self.conv4(self.conv3(self.conv2(self.conv1(x)))))
        x = self.max_pool(x.sparse())
        return self.linear2(self.dp1(self.linear1(x))).F
