"""Model zoo: the MinkUNet family, the classification ResNets, the
point-cloud classifiers and the generative models (CompletionNet, VAE)."""

from .classification import GlobalMaxAvgPool, MinkowskiFCNN, MinkowskiPointNet, MinkowskiSplatFCNN
from .completion import CompletionNet
from .mask3d import HungarianMatcher, InstanceTargets, Mask3D, Mask3DDecoder, SetCriterion

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
from .ptv3 import PointTransformerV3
from .resnet import ResNet14, ResNet18, ResNet34, ResNet50, ResNet101, ResNetBase
from .vae import VAE, Decoder, Encoder

VAEDecoder, VAEEncoder = Decoder, Encoder  # the JAX package's names

__all__ = [
    "CompletionNet",
    "Decoder",
    "Encoder",
    "VAE",
    "VAEDecoder",
    "VAEEncoder",
    "HungarianMatcher",
    "InstanceTargets",
    "Mask3D",
    "Mask3DDecoder",
    "SetCriterion",
    "GlobalMaxAvgPool",
    "MinkowskiFCNN",
    "MinkowskiPointNet",
    "MinkowskiSplatFCNN",
    "PointTransformerV3",
    "ResNetBase",
    "ResNet14",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
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
