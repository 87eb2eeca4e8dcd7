"""Building blocks of the models."""

from .resnet_block import BasicBlock, Bottleneck
from .senet_block import SEBasicBlock, SEBottleneck, SELayer

__all__ = ["BasicBlock", "Bottleneck", "SEBasicBlock", "SEBottleneck", "SELayer"]
