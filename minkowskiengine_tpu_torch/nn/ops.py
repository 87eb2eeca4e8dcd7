"""Linear layer, tensor combinators and dense↔sparse converters.

Counterpart of ``minkowskiengine_tpu/nn/ops.py`` (reference:
MinkowskiEngine/MinkowskiOps.py:40-497): ``MinkowskiLinear``,
``MinkowskiToFeature``, ``cat``, ``_sum``, ``mean`` and ``var`` (each takes
SparseTensors or TensorFields), ``to_sparse``, ``to_sparse_all``,
``dense_coordinates``, the module forms of the converters, and the
``MinkowskiStack*`` containers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..sparse_tensor import SparseTensor
from ..types import resolve_device
from ..utils import profiling as P


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
        # in the features' dtype, as JAX's Linear casts its weight (bf16
        # features give bf16 outputs; the parameters stay float32)
        feats = input.F
        w, b = self.linear.weight, self.linear.bias
        block = getattr(input, "row_block", None)
        if block is not None:  # a row block: the gradients sum over the group
            w = block.replicated(w)
            b = None if b is None else block.replicated(b)
        return input._wrap(torch.nn.functional.linear(
            feats, w.to(feats.dtype), None if b is None else b.to(feats.dtype)
        ))


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


def _unpack(tensors):
    """``f(a, b)`` and ``f([a, b])`` alike; every tensor on one map."""
    if len(tensors) == 1 and isinstance(tensors[0], (list, tuple)):
        tensors = tuple(tensors[0])
    _check_same_key(*tensors)
    return tensors


def cat(*tensors):
    """Concatenate the features of same-coordinate tensors
    (reference: MinkowskiOps.py:70-128)."""
    tensors = _unpack(tensors)
    with P.span("nn.cat"):
        return tensors[0]._wrap(torch.cat([t.F for t in tensors], dim=1))


def _sum(*tensors):
    """Elementwise sum of same-coordinate tensors (reference:
    MinkowskiOps.py:130-170; exported as ``sum`` too)."""
    tensors = _unpack(tensors)
    out = tensors[0].F
    for t in tensors[1:]:
        out = out + t.F
    return tensors[0]._wrap(out)


def mean(*tensors):
    """Elementwise mean (reference: MinkowskiOps.py:172-208)."""
    tensors = _unpack(tensors)
    s = _sum(*tensors)
    return s._wrap(s.F / len(tensors))


def var(*tensors):
    """Elementwise variance, the mean of squared deviations (reference:
    MinkowskiOps.py:210-245)."""
    tensors = _unpack(tensors)
    mu = mean(*tensors).F
    acc = None
    for t in tensors:
        d = t.F - mu
        acc = d * d if acc is None else acc + d * d
    return tensors[0]._wrap(acc / len(tensors))


def dense_coordinates(shape, device=None) -> torch.Tensor:
    """(B * prod(spatial), D+1) int32 coordinates of every cell of a dense
    (B, ch, *spatial) tensor, batch-major (reference: MinkowskiOps.py:246-278)."""
    sizes = [int(shape[0])] + [int(s) for s in shape[2:]]
    dev = resolve_device(device)
    grids = torch.meshgrid(*[torch.arange(s, device=dev) for s in sizes], indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=1).to(torch.int32)


def _as_dense(x, device):
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(x, device=resolve_device(device))


def to_sparse(x, format: Optional[str] = None, coordinates=None, device=None) -> SparseTensor:
    """A dense batched tensor's cells where any channel is nonzero, as a
    SparseTensor (reference: MinkowskiOps.py:279-321).  ``format`` names the
    axes: ``B`` (batch, first), one ``C`` (channels, anywhere), ``X`` for the
    rest; default ``"BCX...X"``, e.g. ``"BXXC"`` for channels-last images.
    ``coordinates`` is accepted for the reference's signature and unused: the
    kept cells' coordinates are their grid indices."""
    x = _as_dense(x, device)
    if x.ndim <= 2:
        raise ValueError("Input has 0 spatial dimension.")
    if format is None:
        format = "BC" + "X" * (x.ndim - 2)
    if len(format) != x.ndim:
        raise ValueError(f"Invalid format: {format}. len(format) != x.ndim")
    if format.count("B") != 1 or format[0] != "B":
        raise ValueError("format must start with the batch axis 'B'")
    if format.count("C") != 1:
        raise ValueError("format must indicate one channel axis 'C'")
    ch_dim = format.index("C")
    moved = torch.movedim(x, ch_dim, -1).reshape(-1, x.shape[ch_dim])
    nz = torch.nonzero(moved.ne(0).any(dim=1)).flatten()
    grid = [s for i, s in enumerate(x.shape) if i != ch_dim]
    coords = torch.stack(torch.unravel_index(nz, grid), dim=1).to(torch.int32)
    return SparseTensor(moved[nz], coords)


def to_sparse_all(dense_tensor, coordinates=None, device=None) -> SparseTensor:
    """Every cell of a dense (B, ch, *spatial) tensor as a SparseTensor row,
    at ``coordinates`` when given (reference: MinkowskiOps.py:322-350)."""
    x = _as_dense(dense_tensor, device)
    moved = torch.movedim(x, 1, -1).reshape(-1, x.shape[1])
    if coordinates is None:
        coordinates = dense_coordinates(x.shape, device=x.device)
    return SparseTensor(moved, coordinates)


class MinkowskiToSparseTensor(nn.Module):
    """Module form of ``to_sparse`` (``remove_zeros``) or ``to_sparse_all``
    (reference: MinkowskiOps.py:351-413)."""

    def __init__(self, remove_zeros: bool = True, coordinates=None):
        super().__init__()
        self.remove_zeros = bool(remove_zeros)
        self.coordinates = coordinates

    def forward(self, input) -> SparseTensor:
        if self.remove_zeros:
            return to_sparse(input, coordinates=self.coordinates)
        return to_sparse_all(input, coordinates=self.coordinates)

    def extra_repr(self):
        return f"remove_zeros={self.remove_zeros}"


class MinkowskiToDenseTensor(nn.Module):
    """A SparseTensor as a dense (B, ch, *spatial) tensor, of ``shape`` when
    given (reference: MinkowskiOps.py:414-459)."""

    def __init__(self, shape=None):
        super().__init__()
        self.shape = shape

    def forward(self, input: SparseTensor) -> torch.Tensor:
        return input.dense(shape=self.shape)[0]


class MinkowskiStackCat(nn.Sequential):
    """Runs its modules side by side on one input and concatenates their
    outputs, which must share a map (reference: MinkowskiOps.py:480-484)."""

    def forward(self, x):
        return cat([layer(x) for layer in self])


class MinkowskiStackSum(nn.Sequential):
    """As ``MinkowskiStackCat``, summing the outputs."""

    def forward(self, x):
        return _sum([layer(x) for layer in self])


class MinkowskiStackMean(nn.Sequential):
    """As ``MinkowskiStackCat``, averaging the outputs."""

    def forward(self, x):
        return mean([layer(x) for layer in self])


class MinkowskiStackVar(nn.Sequential):
    """As ``MinkowskiStackCat``, the outputs' elementwise variance."""

    def forward(self, x):
        return var([layer(x) for layer in self])
