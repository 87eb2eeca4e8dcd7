"""Model zoo (the MinkUNet family so far)."""

from .minkunet import (
    MinkUNet14,
    MinkUNet14A,
    MinkUNet14B,
    MinkUNet14C,
    MinkUNet14D,
    MinkUNet18,
    MinkUNet18A,
    MinkUNet18B,
    MinkUNet18D,
    MinkUNet34,
    MinkUNet34A,
    MinkUNet34B,
    MinkUNet34C,
    MinkUNet50,
    MinkUNet101,
    MinkUNetBase,
)

__all__ = [
    "MinkUNetBase",
    "MinkUNet14",
    "MinkUNet14A",
    "MinkUNet14B",
    "MinkUNet14C",
    "MinkUNet14D",
    "MinkUNet18",
    "MinkUNet18A",
    "MinkUNet18B",
    "MinkUNet18D",
    "MinkUNet34",
    "MinkUNet34A",
    "MinkUNet34B",
    "MinkUNet34C",
    "MinkUNet50",
    "MinkUNet101",
]
