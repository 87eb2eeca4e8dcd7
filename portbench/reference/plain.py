"""Plain PyTorch sparse convolution: the yardstick's own coordinate code.

Written from the published semantics of MinkowskiEngine v0.5.4 (Choy et
al., CVPR 2019), not from the port: coordinates are (batch, x, y, z) int32
rows; a map is its rows in ascending packed-key order; a kernel's offsets
run with axis 0 fastest, even kernels one-sided ``0..k-1``, odd kernels
centred, scaled by the input's tensor stride (a transposed conv's by its
output's); a conv sums ``W[k]`` times the input row at ``out + offset_k``;
a transposed conv sums ``W[k]`` times the input row at ``out - offset_k``.

``Sparse`` holds one tensor's coordinates, features and tensor stride;
``Maps`` caches each stride's map and each kernel's pairs for one cloud.
The conv is an autograd Function that saves its inputs and recomputes the
per-offset gathers in its backward, so a full-size reference fits beside
nothing else.  ``precision="tf32"`` rounds every product's operands to
TF32 (10-bit mantissa), the control of the comparison.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

BIAS = 1 << 17  # coordinates lie in (-2^17, 2^17)
BITS = 18


def pack(coords: torch.Tensor) -> torch.Tensor:
    """(N, 4) int batch-first coordinates -> (N,) int64 keys, ascending in
    (batch, x, y, z)."""
    c = coords.to(torch.int64)
    key = c[:, 0]
    for d in (1, 2, 3):
        key = (key << BITS) | (c[:, d] + BIAS)
    return key


def unpack(keys: torch.Tensor) -> torch.Tensor:
    mask = (1 << BITS) - 1
    cols = [((keys >> (BITS * (3 - d))) & mask) - BIAS for d in (1, 2, 3)]
    return torch.stack([keys >> (3 * BITS), *cols], 1).to(torch.int32)


def check_range(coords: torch.Tensor) -> None:
    if coords.numel() and (coords[:, 1:].abs().max() >= BIAS or coords[:, 0].min() < 0):
        raise ValueError("coordinates outside the packed range")


def unique(coords: torch.Tensor):
    """(sorted unique coordinates, their keys, inverse of each input row)."""
    check_range(coords)
    keys, inverse = torch.unique(pack(coords), sorted=True, return_inverse=True)
    return unpack(keys), keys, inverse


def lookup(sorted_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Row of each query key in ``sorted_keys``, or -1."""
    if sorted_keys.numel() == 0:
        return torch.full_like(queries, -1)
    pos = torch.searchsorted(sorted_keys, queries).clamp_(max=sorted_keys.numel() - 1)
    return torch.where(sorted_keys[pos] == queries, pos, -1)


def cube_offsets(kernel_size: int, device) -> torch.Tensor:
    """(k^3, 3) int64 offsets in units of the tensor stride, axis 0 fastest."""
    r = torch.arange(kernel_size, device=device)
    if kernel_size % 2:
        r = r - kernel_size // 2
    z, y, x = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], 1)


@dataclass
class Map:
    coords: torch.Tensor  # (N, 4) int32, ascending keys
    keys: torch.Tensor  # (N,) int64
    stride: int

    @property
    def n(self) -> int:
        return self.coords.shape[0]


def strided(m: Map, stride: int) -> Map:
    """The map at ``stride``: each row floored to the stride, unique."""
    c = m.coords.clone()
    c[:, 1:] = torch.div(c[:, 1:], stride, rounding_mode="floor") * stride
    coords, keys, _ = unique(c)
    return Map(coords, keys, stride)


def pairs(in_map: Map, out_map: Map, offsets: torch.Tensor, sign: int) -> List[Tuple]:
    """Per offset k, (input rows, output rows) with in = out + sign * offset_k."""
    out = []
    zero = torch.zeros((offsets.shape[0], 1), dtype=offsets.dtype, device=offsets.device)
    delta = torch.cat([zero, offsets], 1) * sign
    for k in range(offsets.shape[0]):
        rows = lookup(in_map.keys, pack(out_map.coords.to(torch.int64) + delta[k]))
        hit = rows >= 0
        out_rows = torch.nonzero(hit).squeeze(1)
        out.append((rows[hit], out_rows))
    return out


def count_pairs(in_coords, out_coords, kernel_size, scale, transposed) -> int:
    """Pairs of one conv call from its input and output coordinates."""
    in_map = Map(*unique(in_coords)[:2], 0)
    out_map = Map(*unique(out_coords)[:2], 0)
    offs = cube_offsets(kernel_size, in_coords.device) * scale
    return sum(int(i.numel()) for i, _ in pairs(in_map, out_map, offs, -1 if transposed else 1))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (nearest, ties to even) in the bits."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def matmul(a, b, precision):
    """``a @ b``; in TF32, of the rounded operands, with the gradient
    passed through the rounding."""
    if precision == "tf32":
        a = a + (tf32(a.detach()) - a.detach())
        b = b + (tf32(b.detach()) - b.detach())
    return a @ b


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, plist, n_out, precision):
        ctx.save_for_backward(x, w)
        ctx.plist, ctx.precision = plist, precision
        out = x.new_zeros((n_out, w.shape[2]))
        for k, (i, o) in enumerate(plist):
            if i.numel():
                out.index_add_(0, o, matmul(x.index_select(0, i), w[k], precision))
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        dw = torch.zeros_like(w) if ctx.needs_input_grad[1] else None
        for k, (i, o) in enumerate(ctx.plist):
            if not i.numel():
                continue
            gk = g.index_select(0, o)
            if dx is not None:
                dx.index_add_(0, i, matmul(gk, w[k].t(), ctx.precision))
            if dw is not None:
                dw[k] += matmul(x.index_select(0, i).t(), gk, ctx.precision)
        return dx, dw, None, None, None


@dataclass
class Sparse:
    """Features on a map of one cloud's ``Maps``."""

    map: Map
    feats: torch.Tensor


@dataclass
class Maps:
    """A cloud's maps by stride, and the pairs of each conv between them."""

    base: Map
    precision: str = "float32"
    by_stride: Dict[int, Map] = field(default_factory=dict)
    cache: Dict[tuple, list] = field(default_factory=dict)

    def __post_init__(self):
        self.by_stride[self.base.stride] = self.base

    def at(self, stride: int) -> Map:
        if stride not in self.by_stride:
            self.by_stride[stride] = strided(self.at(stride // 2), stride)
        return self.by_stride[stride]

    def conv(self, x: Sparse, w, kernel_size: int, stride: int = 1, out_map: Map = None):
        """Conv (stride 1 or strided): output on ``x``'s map, the strided
        map, or ``out_map``."""
        if w.dim() == 2:  # volume-1, stride-1: a product
            return Sparse(x.map, matmul(x.feats, w, self.precision))
        if out_map is None:
            out_map = x.map if stride == 1 else self.at(x.map.stride * stride)
        plist = self._pairs(x.map, out_map, kernel_size, x.map.stride, 1)
        return Sparse(out_map, _Conv.apply(x.feats, w, plist, out_map.n, self.precision))

    def conv_tr(self, x: Sparse, w, kernel_size: int, out_map: Map):
        """Transposed conv onto ``out_map`` (a finer stride)."""
        plist = self._pairs(x.map, out_map, kernel_size, out_map.stride, -1)
        return Sparse(out_map, _Conv.apply(x.feats, w, plist, out_map.n, self.precision))

    def _pairs(self, in_map, out_map, kernel_size, scale, sign):
        key = (id(in_map), id(out_map), kernel_size, scale, sign)
        if key not in self.cache:
            offs = cube_offsets(kernel_size, in_map.coords.device) * scale
            self.cache[key] = (in_map, out_map, pairs(in_map, out_map, offs, sign))
        return self.cache[key][2]


def generate(m: Map, kernel_size: int, out_stride: int) -> Map:
    """A generative transposed conv's output map: every row plus every
    offset at the output stride, unique."""
    offs = cube_offsets(kernel_size, m.coords.device) * out_stride
    cand = m.coords[None, :, 1:].to(torch.int64) + offs[:, None, :]
    batch = m.coords[None, :, :1].expand(offs.shape[0], -1, -1).to(torch.int64)
    coords, keys, _ = unique(torch.cat([batch, cand], 2).reshape(-1, 4))
    return Map(coords, keys, out_stride)


def union(a: Sparse, b: Sparse) -> Sparse:
    """Sum of two tensors at one stride over the union of their rows."""
    coords, keys, inv = unique(torch.cat([a.map.coords, b.map.coords]))
    feats = a.feats.new_zeros((coords.shape[0], a.feats.shape[1]))
    feats = feats.index_add(0, inv[: a.map.n], a.feats).index_add(0, inv[a.map.n:], b.feats)
    return Sparse(Map(coords, keys, a.map.stride), feats)


def batch_norm(x: Sparse, p: dict, name: str, training: bool, momentum: float = 0.1):
    f = torch.nn.functional.batch_norm(
        x.feats, p[f"{name}.running_mean"], p[f"{name}.running_var"], p[f"{name}.weight"],
        p[f"{name}.bias"], training=training, momentum=momentum, eps=1e-5,
    )
    return Sparse(x.map, f)


def cat(a: Sparse, b: Sparse) -> Sparse:
    """Channel concatenation of two tensors on one map."""
    if a.map is not b.map:
        raise ValueError("cat of tensors on different maps")
    return Sparse(a.map, torch.cat([a.feats, b.feats], 1))
