"""Serialization of a coordinate map along space-filling curves, and the
window plan of serialized patch attention (Point Transformer V3, Wu et
al., CVPR 2024, arXiv:2312.10035; Pointcept's ``serialization`` package).

A map's rows are ordered along one of four curves: ``z`` (Morton order),
``z-trans`` (Morton order of (y, x, z)), ``hilbert`` (Skilling's
transpose algorithm, most significant bit first, x first, as the
``numpy-hilbert-curve`` encoder that Pointcept vendors) and
``hilbert-trans``.  A row's code is ``batch << 3·depth | curve_code(g)`` of
its grid cell ``g = coords // tensor_stride``; the grid must be
non-negative (each scene's grid relative to its room's minimum, as
Pointcept's ``GridSample`` makes it), and ``depth`` is the bit length of
the largest grid coordinate of the map.  On such a grid the code of a
pooled map is the finer map's code shifted right by 3, as Pointcept's
``SerializedPooling`` takes it: ``curve_code(g, d) >> 3 ==
curve_code(g >> 1, d - 1)`` for both kinds of curve.

The window plan cuts each scene's sorted sequence of n rows into windows of
K rows, ``[jK, (j+1)K)``; where ``n % K != 0`` and ``n > K`` the last
window is ``[n - K, n)`` instead, so every window of such a scene has K
rows, and a row that two windows hold takes its output from the first.  A
scene of ``n <= K`` rows is one short window of n rows.  That is the
padding of Pointcept's flash path (``get_padding_and_inverse``), built here
on the device from the scenes' row counts with no loop over scenes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

CURVES = ("z", "z-trans", "hilbert", "hilbert-trans")
MAX_DEPTH = 16  # Pointcept's bound: 16 bits a coordinate


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """The low 21 bits of ``v`` moved to every third bit (bit i to 3i)."""
    v = v & 0x1FFFFF
    v = (v | (v << 32)) & 0x1F00000000FFFF
    v = (v | (v << 16)) & 0x1F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    return (v | (v << 2)) & 0x1249249249249249


def _interleave(x, y, z) -> torch.Tensor:
    """Bit i of x to bit 3i + 2, of y to 3i + 1, of z to 3i."""
    return (_spread3(x) << 2) | (_spread3(y) << 1) | _spread3(z)


def morton_code(grid: torch.Tensor, depth: int) -> torch.Tensor:
    """(N,) int64 Morton codes of (N, 3) non-negative cells below ``2**depth``."""
    g = grid.to(torch.int64)
    return _interleave(g[:, 0], g[:, 1], g[:, 2])


def _undo(x0, xi, bit, low):
    """One step of Skilling's inverse undo for axis i at ``bit``: where
    axis i has the bit, invert the lower bits of axis 0, else exchange the
    lower bits of the two."""
    on = (xi & bit) != 0
    t = (x0 ^ xi) & low
    return torch.where(on, x0 ^ low, x0 ^ t), torch.where(on, xi, xi ^ t)


def hilbert_code(grid: torch.Tensor, depth: int) -> torch.Tensor:
    """(N,) int64 Hilbert indices of (N, 3) non-negative cells below
    ``2**depth`` on the curve of that order: Skilling's transpose (the
    inverse undo from the most significant bit, x first), the transposed
    bits interleaved x first, then read from Gray code."""
    g = grid.to(torch.int64)
    x, y, z = g[:, 0], g[:, 1], g[:, 2]
    for q in range(depth - 1, 0, -1):
        bit, low = 1 << q, (1 << q) - 1
        x = torch.where((x & bit) != 0, x ^ low, x)
        x, y = _undo(x, y, bit, low)
        x, z = _undo(x, z, bit, low)
    h = _interleave(x, y, z)
    for s in (1, 2, 4, 8, 16, 32):  # Gray to binary: each bit the XOR of those above it
        h = h ^ (h >> s)
    return h


def curve_code(grid: torch.Tensor, depth: int, curve: str) -> torch.Tensor:
    """The code of each cell along ``curve`` (one of ``CURVES``)."""
    if curve not in CURVES:
        raise ValueError(f"unknown curve {curve!r}; expected one of {CURVES}")
    if curve.endswith("-trans"):  # columns by slicing: a list index would be a host copy
        grid = torch.stack([grid[:, 1], grid[:, 0], grid[:, 2]], 1)
    return (hilbert_code if curve.startswith("hilbert") else morton_code)(grid, depth)


@dataclasses.dataclass(frozen=True)
class Serialization:
    """A map's rows along one curve: ``order`` (the rows in curve order)
    and ``inverse`` (each row's place in it), both (N,) int64."""

    order: torch.Tensor
    inverse: torch.Tensor


def serialize_rows(coords: torch.Tensor, tensor_stride, depth: int, curve: str) -> Serialization:
    """Sort the rows of one map (batch-first int coordinates) along ``curve``."""
    grid = torch.stack([torch.div(coords[:, 1 + d].to(torch.int64), int(s), rounding_mode="floor")
                        for d, s in enumerate(tensor_stride)], 1)
    code = (coords[:, 0].to(torch.int64) << (3 * depth)) | curve_code(grid, depth, curve)
    order = torch.argsort(code)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=order.device)
    return Serialization(order, inverse)


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """Where serialized attention reads and writes, for one map, curve and
    window size K.

    ``rows``: the map rows of every window, the full windows' first (``n_full``
    windows of K rows, flattened), then each short window's; ``select``: for
    each map row, its place in that sequence in the first window that holds
    it; ``short``: the lengths of the short windows, on the host.  What the
    attention kernel reads (``kernels/attention.py``): ``bounds``, (windows
    + 1,) int32, window w at places ``bounds[w]`` to ``bounds[w + 1] - 1``
    of ``rows``; ``kernel_rows``, ``rows`` as int32, with ``~row`` at each
    place that does not own its row (``select[rows[p]] != p``).
    """

    rows: torch.Tensor
    select: torch.Tensor
    n_full: int
    patch_size: int
    short: Tuple[int, ...]
    bounds: torch.Tensor
    kernel_rows: torch.Tensor


def _ranges(lengths: torch.Tensor, total: int):
    """(owner, place) of each of ``total`` items laid out as consecutive runs
    of ``lengths``: the run that holds it and its place in that run."""
    dev = lengths.device
    owner = torch.repeat_interleave(torch.arange(lengths.numel(), device=dev), lengths,
                                    output_size=total)
    first = torch.cumsum(lengths, 0) - lengths
    return owner, torch.arange(total, device=dev) - first[owner]


def build_window_plan(ser: Serialization, offsets: torch.Tensor, offsets_host: List[int],
                      patch_size: int) -> WindowPlan:
    """The window plan of a map from its rows along a curve and the row offsets
    of its scenes, ``offsets`` ((B + 1,), on the device) and the same numbers
    on the host, which fix the plan's sizes."""
    K = int(patch_size)
    order = ser.order
    dev = order.device
    counts_host = [b - a for a, b in zip(offsets_host, offsets_host[1:])]
    n_full = sum(-(-n // K) for n in counts_host if n > K)
    short = tuple(n for n in counts_host if 0 < n <= K)
    n_short = sum(short)

    n = offsets[1:] - offsets[:-1]
    full = n > K
    windows = torch.where(full, (n + K - 1) // K, 0)
    first_window = torch.cumsum(windows, 0) - windows
    scene, j = _ranges(windows, n_full)  # each full window's scene and index in it
    start = offsets[scene] + torch.minimum(j * K, n[scene] - K)
    positions = [(start[:, None] + torch.arange(K, device=dev)).reshape(-1)]
    short_n = torch.where(full, 0, n)
    short_first = torch.cumsum(short_n, 0) - short_n
    scene_s, p_s = _ranges(short_n, n_short)
    positions.append(offsets[scene_s] + p_s)
    rows = order[torch.cat(positions)]

    # each sorted position's place in ``rows``: the first window that holds it
    total = int(offsets_host[-1])
    scene_q, p = _ranges(n, total)
    w = n[scene_q]
    j_q = torch.minimum(p // K, windows[scene_q] - 1)
    in_full = (first_window[scene_q] + j_q) * K + p - torch.minimum(j_q * K, w - K)
    in_short = n_full * K + short_first[scene_q] + p
    place = torch.where(w > K, in_full, in_short)
    select = place[ser.inverse]

    # the short windows' scenes, in order (a stable sort puts them first)
    short_scenes = torch.argsort((short_n == 0).to(torch.int8), stable=True)[:len(short)]
    places = n_full * K + n_short
    bounds = torch.cat([torch.arange(n_full, device=dev) * K, n_full * K + short_first[short_scenes],
                        torch.full((1,), places, device=dev, dtype=order.dtype)]).to(torch.int32)
    owned = torch.zeros(places, dtype=torch.bool, device=dev).index_fill_(0, select, True)
    kernel_rows = torch.where(owned, rows, ~rows).to(torch.int32)
    return WindowPlan(rows, select, n_full, K, short, bounds, kernel_rows)
