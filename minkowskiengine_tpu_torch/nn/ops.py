"""Linear layer and tensor combinators.

Counterpart of ``minkowskiengine_tpu/nn/ops.py`` (reference:
MinkowskiEngine/MinkowskiOps.py:40-128, 460-479): ``MinkowskiLinear``,
``MinkowskiToFeature`` and ``cat``.  Each takes a SparseTensor or a
TensorField.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..types import resolve_device


class MinkowskiLinear(nn.Module):
    """A dense linear layer over the features.  Wraps ``torch.nn.Linear`` as
    ``.linear``, as the reference does, so the state-dict names are
    ``linear.weight`` (out, in) and ``linear.bias`` (out,).  Both are drawn
    from U(±1/√in) with ``generator`` on the CPU, then moved to ``device``."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.linear = nn.Linear(in_features, out_features, bias=bias, device=dev)
        stdv = 1.0 / math.sqrt(in_features)
        with torch.no_grad():
            for p in (self.linear.weight, self.linear.bias):
                if p is not None:
                    t = torch.empty(p.shape).uniform_(-stdv, stdv, generator=generator)
                    p.copy_(t)

    def forward(self, input):
        return input._wrap(self.linear(input.F))


class MinkowskiToFeature(nn.Module):
    """The feature matrix of a SparseTensor or TensorField."""

    def forward(self, input):
        return input.F


def _tensor_key(t):
    key = getattr(t, "coordinate_map_key", None)
    return key if key is not None else t.coordinate_field_map_key


def _check_same_key(*tensors):
    """Every tensor must sit on the same coordinate map (SparseTensor) or
    field map (TensorField)."""
    key = _tensor_key(tensors[0])
    for t in tensors[1:]:
        if _tensor_key(t) != key:
            raise ValueError(
                "All inputs must share the same coordinate_map_key; use "
                "MinkowskiUnion for mixed-coordinate combination"
            )


def cat(*tensors):
    """Concatenate the features of same-coordinate tensors
    (reference: MinkowskiOps.py:70-128)."""
    if len(tensors) == 1 and isinstance(tensors[0], (list, tuple)):
        tensors = tuple(tensors[0])
    _check_same_key(*tensors)
    return tensors[0]._wrap(torch.cat([t.F for t in tensors], dim=1))
