"""Kaiming initialisation of sparse-convolution kernels (reference:
MinkowskiEngine/utils/init.py).

Counterpart of ``minkowskiengine_tpu/utils/init.py``: the same fans and
gains; a (K, Cin, Cout) kernel has fan_in Cin·K and fan_out Cout·K.  The
port fills a tensor in place, as the reference does, drawing from
``generator`` on the CPU (the JAX package returns a new array drawn from a
key).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _calculate_fan_in_and_fan_out(shape):
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) == 3:  # (kernel_volume, C_in, C_out)
        return shape[1] * shape[0], shape[2] * shape[0]
    raise ValueError(f"Unsupported kernel shape {tuple(shape)}")


def _calculate_correct_fan(shape, mode: str):
    mode = mode.lower()
    if mode not in ("fan_in", "fan_out"):
        raise ValueError(f"Mode {mode} not supported")
    fan_in, fan_out = _calculate_fan_in_and_fan_out(shape)
    return fan_in if mode == "fan_in" else fan_out


def _gain(nonlinearity: str, a: float) -> float:
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1 + a**2))
    if nonlinearity in ("sigmoid", "linear"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3
    raise ValueError(f"Unsupported nonlinearity {nonlinearity}")


def kaiming_normal_(tensor: torch.Tensor, a: float = 0.0, mode: str = "fan_in",
                    nonlinearity: str = "leaky_relu",
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill ``tensor`` from N(0, gain² / fan); returns it."""
    std = _gain(nonlinearity, a) / math.sqrt(_calculate_correct_fan(tensor.shape, mode))
    with torch.no_grad():
        return tensor.copy_(torch.randn(tensor.shape, generator=generator) * std)


def kaiming_uniform_(tensor: torch.Tensor, a: float = 0.0, mode: str = "fan_in",
                     nonlinearity: str = "leaky_relu",
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill ``tensor`` from U(±gain · √(3 / fan)); returns it."""
    bound = _gain(nonlinearity, a) * math.sqrt(3.0 / _calculate_correct_fan(tensor.shape, mode))
    with torch.no_grad():
        return tensor.copy_(torch.empty(tensor.shape).uniform_(-bound, bound, generator=generator))
