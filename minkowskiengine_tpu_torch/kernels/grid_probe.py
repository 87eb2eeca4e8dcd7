"""The kernel-map grid probe: both halves of a kernel map in one launch.

``grid_probe(*halves)`` launches the hand-written CUDA kernel
(``csrc/grid_probe.cu``) on CUDA tensors.  Each ``Half`` asks for the rows
of ``coords[i] + offsets[k]`` in a probed map's dense bbox row grid
(``coords/grid.py::build_row_grid``), as a (K, N) int32 matrix with -1
where the query is absent, off the map's lattice or out of its grid, and
in every slot of a row whose ``valid`` flag is false.  A kernel map's
``in_idx`` is the half that adds the offsets to the output rows and probes
the input map; its ``out_idx_t`` the half that subtracts them from the
input rows and probes the output map.

The kernel takes CUDA tensors only and raises on anything else: the route
is chosen by ``coords/kernel_map.py::build_kernel_map``, where a CPU tensor
takes the plain version (``_build_in_idx_grid``, whole-array ATen ops)
and a map without a grid the key search.  It replaces no kernel of the JAX
package, which builds kernel maps in XLA ops (the source says what it
replaces, its bound and its design).  ``grid_probe.launches`` counts its
launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from . import build

MAX_DIMENSION = 6  # csrc/grid_probe.cu's MAX_D: the widest grid the cell cap admits


class Half(NamedTuple):
    """One (K, N) half: the rows of ``coords[i] + offsets[k]`` in the probed
    map."""

    probe: tuple  # the probed map's (row_grid, mins, grid_shape, tensor_stride)
    coords: torch.Tensor  # (N, D+1) int32 base rows
    offsets: torch.Tensor  # (K, D+1) int32 on the device, added to each row
    valid: Optional[torch.Tensor] = None  # (N,) bool, or None: every row valid


class _Half(ctypes.Structure):
    """``MeGridHalf`` of csrc/grid_probe.cu."""

    _fields_ = [
        ("coords", ctypes.c_void_p), ("valid", ctypes.c_void_p), ("offsets", ctypes.c_void_p),
        ("grid", ctypes.c_void_p), ("mins", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("n", ctypes.c_int32), ("blocks", ctypes.c_int32),
        ("shape", ctypes.c_int32 * (MAX_DIMENSION + 1)),
        ("stride", ctypes.c_int32 * MAX_DIMENSION),
    ]


def _tensor(name: str, t, dtype, ndim: int, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype or t.ndim != ndim:
        raise TypeError(f"{name} must be a {ndim}-d {dtype} tensor, got {t.ndim}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the first half's rows on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check(*halves: Half) -> tuple:
    """(K, D) of a launch, after refusing what the kernel does not take: no
    half or more than two; tensors of other types, not contiguous or not on
    one device; D outside 1..6; offsets not (K, D+1), or halves of
    different K or D; a row grid whose length is not its shape's cells and
    the sentinel (or does not fit int32); a tensor stride below 1; and last,
    tensors that are not on the card."""
    if not 1 <= len(halves) <= 2:
        raise ValueError(f"the grid-probe kernel takes one or two halves, got {len(halves)}")
    dims = set()
    dev = halves[0].coords.device if isinstance(halves[0].coords, torch.Tensor) else None
    for i, h in enumerate(halves):
        _tensor(f"half {i}'s coords", h.coords, torch.int32, 2, dev)
        n, D = h.coords.shape[0], h.coords.shape[1] - 1
        if not 1 <= D <= MAX_DIMENSION:
            raise ValueError(f"the grid-probe kernel takes D = 1..{MAX_DIMENSION}, got D = {D}")
        if n >= 2**31:
            raise ValueError(f"half {i}: {n} rows do not fit int32")
        _tensor(f"half {i}'s offsets", h.offsets, torch.int32, 2, dev)
        if h.offsets.shape[1] != D + 1:
            raise ValueError(f"half {i}'s offsets are {tuple(h.offsets.shape)}, not (K, {D + 1})")
        if h.valid is not None:
            _tensor(f"half {i}'s valid", h.valid, torch.bool, 1, dev)
            if h.valid.shape[0] != n:
                raise ValueError(f"half {i}'s valid has {h.valid.shape[0]} rows, coords {n}")
        row_grid, mins, grid_shape, ts = h.probe
        _tensor(f"half {i}'s row grid", row_grid, torch.int32, 1, dev)
        _tensor(f"half {i}'s minima", mins, torch.int32, 1, dev)
        if mins.shape[0] != D + 1 or len(grid_shape) != D + 1 or len(ts) != D:
            raise ValueError(f"half {i}: a {D}-D probe needs {D + 1} minima and grid extents and "
                             f"{D} strides, got {mins.shape[0]}, {len(grid_shape)}, {len(ts)}")
        cells = math.prod(int(e) for e in grid_shape)
        if row_grid.shape[0] != cells + 1 or cells + 1 >= 2**31:
            raise ValueError(f"half {i}: a row grid of {row_grid.shape[0]} cells for grid "
                             f"{tuple(grid_shape)} ({cells} cells and the sentinel, under 2^31)")
        if min(int(t) for t in ts) < 1:
            raise ValueError(f"half {i}: tensor stride {tuple(ts)} below 1")
        dims.add((h.offsets.shape[0], D))
    if len(dims) != 1:
        raise ValueError(f"the halves of one launch share K and D, got {sorted(dims)}")
    if dev.type != "cuda":
        raise ValueError(f"the grid-probe kernel takes CUDA tensors, got {dev} "
                         "(coords/kernel_map.py builds a CPU map's halves in plain ops)")
    return dims.pop()


def grid_probe(*halves: Half) -> tuple:
    """One (K, N) int32 matrix per half (one or two), in one launch:
    ``out[k, i]`` = row of ``coords[i] + offsets[k]`` in the half's probed
    map, or -1 (absent, off its lattice or grid, or ``valid[i]`` false)."""
    k_vol, D = check(*halves)
    dev = halves[0].coords.device
    outs = tuple(torch.empty((k_vol, h.coords.shape[0]), dtype=torch.int32, device=dev)
                 for h in halves)
    structs = (_Half * len(halves))()
    for s, h, out in zip(structs, halves, outs):
        row_grid, mins, grid_shape, ts = h.probe
        s.coords, s.offsets, s.grid, s.mins, s.out = (
            t.data_ptr() for t in (h.coords, h.offsets, row_grid, mins, out))
        s.valid = None if h.valid is None else h.valid.data_ptr()
        s.n = h.coords.shape[0]
        s.shape[: D + 1] = [int(e) for e in grid_shape]
        s.stride[:D] = [int(t) for t in ts]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().me_grid_probe(structs, len(halves), k_vol, D, stream)
    if err != 0:
        raise RuntimeError(f"grid_probe kernel launch failed: cudaError {err}")
    grid_probe.launches += 1
    return outs


grid_probe.launches = 0
