"""Building blocks of the models."""

from .resnet_block import BasicBlock, Bottleneck

__all__ = ["BasicBlock", "Bottleneck"]
