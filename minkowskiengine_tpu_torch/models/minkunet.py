"""MinkUNet family: the segmentation models.

Counterpart of ``minkowskiengine_tpu/models/minkunet.py`` (reference:
examples/minkunet.py:35-246): same block counts, plane widths, kernel
sizes, strides and skip concatenations.
"""

from __future__ import annotations

from ..modules.resnet_block import BasicBlock, Bottleneck
from ..nn.conv import MinkowskiConvolution, MinkowskiConvolutionTranspose
from ..nn.nonlinearity import MinkowskiReLU
from ..nn.norm import MinkowskiBatchNorm
from ..nn.ops import cat
from .resnet import ResNetBase


class MinkUNetBase(ResNetBase):
    """The U-Net: ``forward(x)`` is the per-row classifier ``final`` on the
    last of ``feature_levels(x)``, the decoder's five levels (block4 at
    tensor stride 16 through block8 at stride 1) that a query decoder such
    as ``Mask3D``'s reads."""

    BLOCK = None
    PLANES = (32, 64, 128, 256, 256, 128, 96, 96)
    DILATIONS = (1, 1, 1, 1, 1, 1, 1, 1)
    LAYERS = (2, 2, 2, 2, 2, 2, 2, 2)
    INIT_DIM = 32
    OUT_TENSOR_STRIDE = 1

    def network_initialization(self, in_channels, out_channels, D, generator, device):
        g = dict(generator=generator, device=device)

        def down(ch):  # k=2 s=2 encoder conv
            return MinkowskiConvolution(ch, ch, kernel_size=2, stride=2, dimension=D, **g)

        def up(cin, cout):  # k=2 s=2 decoder transposed conv
            return MinkowskiConvolutionTranspose(
                cin, cout, kernel_size=2, stride=2, dimension=D, **g
            )

        def bn(ch):
            return MinkowskiBatchNorm(ch, device=device)

        self.inplanes = self.INIT_DIM
        self.conv0p1s1 = MinkowskiConvolution(
            in_channels, self.inplanes, kernel_size=5, dimension=D, **g
        )
        self.bn0 = bn(self.inplanes)

        self.conv1p1s2 = down(self.inplanes)
        self.bn1 = bn(self.inplanes)
        self.block1 = self._make_layer(self.BLOCK, self.PLANES[0], self.LAYERS[0], **g)

        self.conv2p2s2 = down(self.inplanes)
        self.bn2 = bn(self.inplanes)
        self.block2 = self._make_layer(self.BLOCK, self.PLANES[1], self.LAYERS[1], **g)

        self.conv3p4s2 = down(self.inplanes)
        self.bn3 = bn(self.inplanes)
        self.block3 = self._make_layer(self.BLOCK, self.PLANES[2], self.LAYERS[2], **g)

        self.conv4p8s2 = down(self.inplanes)
        self.bn4 = bn(self.inplanes)
        self.block4 = self._make_layer(self.BLOCK, self.PLANES[3], self.LAYERS[3], **g)

        self.convtr4p16s2 = up(self.inplanes, self.PLANES[4])
        self.bntr4 = bn(self.PLANES[4])
        self.inplanes = self.PLANES[4] + self.PLANES[2] * self.BLOCK.expansion
        self.block5 = self._make_layer(self.BLOCK, self.PLANES[4], self.LAYERS[4], **g)

        self.convtr5p8s2 = up(self.inplanes, self.PLANES[5])
        self.bntr5 = bn(self.PLANES[5])
        self.inplanes = self.PLANES[5] + self.PLANES[1] * self.BLOCK.expansion
        self.block6 = self._make_layer(self.BLOCK, self.PLANES[5], self.LAYERS[5], **g)

        self.convtr6p4s2 = up(self.inplanes, self.PLANES[6])
        self.bntr6 = bn(self.PLANES[6])
        self.inplanes = self.PLANES[6] + self.PLANES[0] * self.BLOCK.expansion
        self.block7 = self._make_layer(self.BLOCK, self.PLANES[6], self.LAYERS[6], **g)

        self.convtr7p2s2 = up(self.inplanes, self.PLANES[7])
        self.bntr7 = bn(self.PLANES[7])
        self.inplanes = self.PLANES[7] + self.INIT_DIM
        self.block8 = self._make_layer(self.BLOCK, self.PLANES[7], self.LAYERS[7], **g)

        self.final = MinkowskiConvolution(
            self.PLANES[7] * self.BLOCK.expansion, out_channels, kernel_size=1,
            bias=True, dimension=D, **g,
        )
        self.relu = MinkowskiReLU()

    def feature_levels(self, x):
        """Yields the decoder's five levels, coarsest first: block4 (tensor
        stride 16), block5 (8), block6 (4), block7 (2) and block8 (1), the
        features a query decoder such as Mask3D's reads."""
        out = self.conv0p1s1(x)
        out = self.bn0(out)
        out_p1 = self.relu(out)

        out = self.conv1p1s2(out_p1)
        out = self.bn1(out)
        out = self.relu(out)
        out_b1p2 = self.block1(out)

        out = self.conv2p2s2(out_b1p2)
        out = self.bn2(out)
        out = self.relu(out)
        out_b2p4 = self.block2(out)

        out = self.conv3p4s2(out_b2p4)
        out = self.bn3(out)
        out = self.relu(out)
        out_b3p8 = self.block3(out)

        out = self.conv4p8s2(out_b3p8)  # tensor_stride=16
        out = self.bn4(out)
        out = self.relu(out)
        out = self.block4(out)
        yield out

        out = self.convtr4p16s2(out)  # tensor_stride=8
        out = self.bntr4(out)
        out = self.relu(out)
        out = cat(out, out_b3p8)
        out = self.block5(out)
        yield out

        out = self.convtr5p8s2(out)  # tensor_stride=4
        out = self.bntr5(out)
        out = self.relu(out)
        out = cat(out, out_b2p4)
        out = self.block6(out)
        yield out

        out = self.convtr6p4s2(out)  # tensor_stride=2
        out = self.bntr6(out)
        out = self.relu(out)
        out = cat(out, out_b1p2)
        out = self.block7(out)
        yield out

        out = self.convtr7p2s2(out)  # tensor_stride=1
        out = self.bntr7(out)
        out = self.relu(out)
        out = cat(out, out_p1)
        out = self.block8(out)
        yield out

    def forward(self, x):
        levels = self.feature_levels(x)
        for _ in range(4):
            next(levels)  # dropped as it comes: no coarser level outlives its use
        return self.final(next(levels))


class MinkUNet14(MinkUNetBase):
    BLOCK = BasicBlock
    LAYERS = (1, 1, 1, 1, 1, 1, 1, 1)


class MinkUNet18(MinkUNetBase):
    BLOCK = BasicBlock
    LAYERS = (2, 2, 2, 2, 2, 2, 2, 2)


class MinkUNet34(MinkUNetBase):
    BLOCK = BasicBlock
    LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)


class MinkUNet50(MinkUNetBase):
    BLOCK = Bottleneck
    LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)


class MinkUNet101(MinkUNetBase):
    BLOCK = Bottleneck
    LAYERS = (2, 3, 4, 23, 2, 2, 2, 2)


class MinkUNet14A(MinkUNet14):
    PLANES = (32, 64, 128, 256, 128, 128, 96, 96)


class MinkUNet14B(MinkUNet14):
    PLANES = (32, 64, 128, 256, 128, 128, 128, 128)


class MinkUNet14C(MinkUNet14):
    PLANES = (32, 64, 128, 256, 192, 192, 128, 128)


class MinkUNet14D(MinkUNet14):
    PLANES = (32, 64, 128, 256, 384, 384, 384, 384)


class MinkUNet18A(MinkUNet18):
    PLANES = (32, 64, 128, 256, 128, 128, 96, 96)


class MinkUNet18B(MinkUNet18):
    PLANES = (32, 64, 128, 256, 128, 128, 128, 128)


class MinkUNet18D(MinkUNet18):
    PLANES = (32, 64, 128, 256, 384, 384, 384, 384)


class MinkUNet34A(MinkUNet34):
    PLANES = (32, 64, 128, 256, 256, 128, 64, 64)


class MinkUNet34B(MinkUNet34):
    PLANES = (32, 64, 128, 256, 256, 128, 64, 32)


class MinkUNet34C(MinkUNet34):
    PLANES = (32, 64, 128, 256, 256, 128, 96, 96)
