"""Spatial sharding: one point cloud split across the ranks of a mesh axis.

Counterpart of ``minkowskiengine_tpu/parallel/spatial.py``.  Data
parallelism scales the batch; this scales a single cloud too large for one
card.  Every rank holds the same coordinate maps and kernel maps (the same
cloud through the same manager calls); each holds one contiguous **row
block** of every map's features.

**The block rule** (``block_bounds``): the N rows of a map split as
``torch.tensor_split`` splits N over n: the first ``N % n`` blocks hold
``N // n + 1`` rows, the rest ``N // n``.  The same rule cuts a map's
feature rows and a kernel map's output columns, so rank r's conv computes
the output rows of its own block.  (JAX splits padded power-of-two
capacities, which divide by n; the port keeps exact row counts.)

**The halo.**  Rows are in canonical key order, so consecutive rows are a
spatially local slab, and the input rows an output block reads cluster
around the matching input block.  ``required_halo`` measures, per map, the
widest reach past a block's edge, in one host sync, cached per map; every
rank holds the same maps, so every rank measures the same halo with no
collective.  The conv then gathers a window of ``B + 2·halo`` rows: its
block and ``halo`` rows of each neighbour.  The bands come from one
``all_gather`` of each rank's two edge bands (``2 × halo`` rows), rather
than from ``send``/``recv``, so the same code runs on NCCL and on gloo
(whose point-to-point calls take CPU tensors only).  A halo wider than the
shortest block of its map would need a second hop: that map falls back to
an ``all_gather`` of every block (padded to the longest block), as JAX's
does when the halo exceeds a block.  Strided and transposed maps on the
coarse levels take it.

**The conv** (``spatial_conv_apply``, a ``torch.autograd.Function``, as
JAX's ``_spatial_conv``): K1 runs on the window with the block's columns
of ``in_idx`` re-based by ``base = start − halo``; a pair outside the
window becomes -1 and is counted in ``dropped`` (summed over the group),
so a halo too narrow shows, never silently.  The input gradient runs K1
on the window of G with the block's columns of ``out_idx_t`` and
``W[k]ᵀ``; the weight gradient runs K2 on the saved window, then an
all-reduce (sum) over the group, so every rank holds the whole dW.

Under ``MT.spatial_execution(mesh)`` every sparse conv of a model takes
this path (``ops.functional.sparse_conv_kmap``); batch norm sums its
statistics over the group; a parameter used on the rows (batch norm's
affine, a volume-1 conv's kernel, a bias, ``MinkowskiLinear``) enters
through ``RowBlock.replicated``, whose gradient is summed over the group;
row-wise ops stay local; ops that need every row raise (see
``sparse_tensor.py``).  So after ``loss.backward()`` of each rank's share
of the loss, every rank holds the whole model's gradient::

    mesh = make_spatial_mesh(2)
    xs = shard_sparse_tensor(x, mesh)        # every rank: the same x
    with MT.spatial_execution(mesh):
        y = net(xs)                          # y.F: this rank's block
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..coords.kernel_map import KernelMap
from ..kernels.conv_dw import conv_dw
from ..kernels.gather_gemm import gather_gemm
from ..ops.functional import batch_moments, segment_count, segment_sum
from . import comm
from .data_parallel import make_mesh, rank_device

__all__ = [
    "RowBlock",
    "block_bounds",
    "gather_rows",
    "make_spatial_mesh",
    "required_halo",
    "shard_rows",
    "shard_sparse_tensor",
    "spatial_conv_apply",
    "spatial_global_avg",
    "spatial_global_sum",
    "spatial_masked_moments",
]


def make_spatial_mesh(n_devices: Optional[int] = None, axis_name: str = "space",
                      device=None) -> DeviceMesh:
    """1-D mesh named ``axis_name`` over the first ``n_devices`` ranks."""
    return make_mesh(n_devices, axis_name, device)


def block_bounds(n_rows: int, n: int, r: int) -> Tuple[int, int]:
    """[lo, hi) of block r of n over ``n_rows`` rows (``torch.tensor_split``)."""
    q, m = divmod(n_rows, n)
    lo = r * q + min(r, m)
    return lo, lo + q + (1 if r < m else 0)


class RowBlock(NamedTuple):
    """This rank's row block of every map: block ``rank`` of ``size`` over
    the ranks of ``mesh``'s ``axis_name``."""

    mesh: DeviceMesh
    axis_name: str

    @property
    def group(self):
        return self.mesh.get_group(self.axis_name)

    @property
    def rank(self) -> int:
        return comm.axis(self.mesh, self.axis_name)[2]

    @property
    def size(self) -> int:
        return comm.axis(self.mesh, self.axis_name)[1]

    def bounds(self, n_rows: int) -> Tuple[int, int]:
        return block_bounds(n_rows, self.size, self.rank)

    def replicated(self, p: torch.Tensor) -> torch.Tensor:
        """``p`` (a parameter every rank holds) for use on this block: its
        gradient is summed over the group."""
        return comm.SumGradient.apply(p, self.group) if self.size > 1 else p


def shard_rows(arr, mesh: DeviceMesh, axis_name: str = "space") -> torch.Tensor:
    """This rank's block of the rows of ``arr``, on this rank's device."""
    lo, hi = RowBlock(mesh, axis_name).bounds(arr.shape[0])
    return torch.as_tensor(arr)[lo:hi].to(rank_device(mesh.device_type))


def shard_sparse_tensor(x, mesh: DeviceMesh, axis_name: str = "space"):
    """``x`` with this rank's row block of its features, on the same map and
    manager; run models on it under ``MT.spatial_execution(mesh)``::

        xs = shard_sparse_tensor(x, mesh)
        with MT.spatial_execution(mesh):
            y = net(xs)          # every conv runs the halo path
    """
    from ..sparse_tensor import SparseTensor

    return SparseTensor(
        shard_rows(x.F, mesh, axis_name),
        coordinate_map_key=x.coordinate_map_key,
        coordinate_manager=x.coordinate_manager,
        row_block=RowBlock(mesh, axis_name),
    )


def _gather_blocks(block: torch.Tensor, n_rows: int, group, n: int) -> torch.Tensor:
    """Every rank's block of an ``n_rows``-row tensor, whole, in row order:
    one ``all_gather`` of the blocks padded to the longest."""
    pad = block.new_zeros((-(-n_rows // n) - block.shape[0],) + tuple(block.shape[1:]))
    parts = comm.all_gather(torch.cat([block, pad]), group)
    return torch.cat([p[: hi - lo] for p, (lo, hi) in
                      zip(parts, (block_bounds(n_rows, n, r) for r in range(n)))])


def gather_rows(block: torch.Tensor, n_rows: int, mesh: DeviceMesh,
                axis_name: str = "space") -> torch.Tensor:
    """Every rank's block of an ``n_rows``-row tensor, whole, in row order,
    on every rank (one ``all_gather``); not differentiable."""
    group, n, _ = comm.axis(mesh, axis_name)
    return _gather_blocks(block, n_rows, group, n)


# measured halos per kernel map, keyed by the identity of its two index
# tensors (maps are immutable); a weak reference detects a reused id
_HALO_CACHE: dict = {}


def _reach(idx: torch.Tensor, n_ref: int, n: int) -> torch.Tensor:
    """Widest distance, past its block's edge, of a valid reference in
    ``idx`` (K, C): column c lies in block b(c) of C, its references
    should lie in block b(c) of ``n_ref`` rows."""
    K, C = idx.shape
    if K == 0 or C == 0:
        return idx.new_zeros((), dtype=torch.int64)
    q, m = divmod(C, n)
    col = torch.arange(C, device=idx.device)
    edge = m * (q + 1)
    blk = torch.where(col < edge, col // (q + 1), m + (col - edge) // max(q, 1))
    rq, rm = divmod(n_ref, n)
    lo = blk * rq + torch.clamp(blk, max=rm)
    hi = lo + rq + (blk < rm).long()
    i = idx.long()
    reach = torch.maximum(lo[None] - i, i - (hi[None] - 1))
    return torch.where(idx >= 0, reach, 0).max().clamp_min(0)


def required_halo(kmap: KernelMap, n_dev: int) -> Tuple[int, int]:
    """(halo_fwd, halo_bwd): the narrowest halos that put every valid pair
    of the map inside its block's window.  halo_fwd covers ``in_idx``
    (output blocks reading input rows), halo_bwd ``out_idx_t`` (the input
    gradient reading output rows).  A halo wider than the shortest block
    of the rows it reads cannot be served by one hop: ``spatial_conv_apply``
    then gathers every block.  One host sync for both, cached per map."""
    ck = (id(kmap.in_idx), id(kmap.out_idx_t), n_dev)
    hit = _HALO_CACHE.get(ck)
    if hit is not None and hit[0]() is kmap.in_idx and hit[1]() is kmap.out_idx_t:
        return hit[2]
    hf, hb = torch.stack([
        _reach(kmap.in_idx, kmap.n_in, n_dev), _reach(kmap.out_idx_t, kmap.n_out, n_dev),
    ]).tolist()
    out = (int(hf), int(hb))
    if len(_HALO_CACHE) > 256:
        _HALO_CACHE.clear()
    _HALO_CACHE[ck] = (weakref.ref(kmap.in_idx), weakref.ref(kmap.out_idx_t), out)
    return out


class _Plan(NamedTuple):
    group: object
    n: int
    rank: int
    n_in: int
    n_out: int
    halo_f: int
    halo_b: int
    gather_all: bool


def _window(block: torch.Tensor, n_rows: int, halo: int, plan: _Plan):
    """(rows around this rank's block, index of the window's first row)."""
    lo, _ = block_bounds(n_rows, plan.n, plan.rank)
    if plan.n == 1:
        return block, lo
    if plan.gather_all:
        return _gather_blocks(block, n_rows, plan.group, plan.n), 0
    if halo == 0:
        return block, lo
    bands = comm.all_gather(torch.stack([block[:halo], block[-halo:]]), plan.group)
    zeros = block.new_zeros((halo,) + tuple(block.shape[1:]))
    below = bands[plan.rank - 1][1] if plan.rank > 0 else zeros
    above = bands[plan.rank + 1][0] if plan.rank < plan.n - 1 else zeros
    return torch.cat([below, block, above]), lo - halo


def _rebase(idx_blk: torch.Tensor, base: int, rows: int):
    """The block's columns of a map, re-based to a window of ``rows`` rows
    starting at row ``base``: (int32 map, -1 where the pair falls outside;
    the number of valid pairs that fell outside)."""
    local = idx_blk - base
    valid = idx_blk >= 0
    inside = (local >= 0) & (local < rows)
    dropped = (valid & ~inside).sum()
    return torch.where(valid & inside, local, -1).to(torch.int32), dropped


class _SpatialConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, kernel, in_idx, out_idx_t, plan: _Plan):
        w = kernel
        if feats.dtype == torch.bfloat16 and kernel.dtype == torch.float32:
            w = kernel.to(torch.bfloat16)
        o_lo, o_hi = block_bounds(plan.n_out, plan.n, plan.rank)
        x_win, base = _window(feats, plan.n_in, plan.halo_f, plan)
        idx, dropped = _rebase(in_idx[:, o_lo:o_hi], base, x_win.shape[0])
        out = gather_gemm(x_win, w.contiguous(), idx)
        if plan.n > 1:
            dropped = comm.all_reduce(dropped, plan.group)
        ctx.plan = plan
        ctx.save_for_backward(x_win, w, idx, out_idx_t)
        ctx.mark_non_differentiable(dropped)
        return out, dropped

    @staticmethod
    def backward(ctx, grad_out, _):
        x_win, w, idx, out_idx_t = ctx.saved_tensors
        plan = ctx.plan
        g = grad_out.contiguous()
        d_feats = d_kernel = None
        if ctx.needs_input_grad[0]:
            i_lo, i_hi = block_bounds(plan.n_in, plan.n, plan.rank)
            g_win, base = _window(g, plan.n_out, plan.halo_b, plan)
            idx_t, _ = _rebase(out_idx_t[:, i_lo:i_hi], base, g_win.shape[0])
            d_feats = gather_gemm(g_win, w.transpose(1, 2).contiguous(), idx_t)
        if ctx.needs_input_grad[1]:
            d_kernel = conv_dw(x_win, g, idx)
            if plan.n > 1:
                d_kernel = comm.all_reduce(d_kernel, plan.group)
        return d_feats, d_kernel, None, None, None


def spatial_conv_apply(
    feats: torch.Tensor,
    kernel: torch.Tensor,
    kmap: KernelMap,
    *,
    mesh: DeviceMesh,
    axis_name: str = "space",
    halo: Optional[int] = None,
    force_all_gather: bool = False,
):
    """Sparse convolution of this rank's row block of ``feats``.

    feats: this rank's block of the (``kmap.n_in``, Cin) input rows;
    kernel: (K, Cin, Cout), the whole kernel on every rank.  Returns
    (this rank's block of the (``kmap.n_out``, Cout) output, ``dropped``:
    the valid pairs, summed over the group, whose input row fell outside
    its window).  ``halo=None`` measures it (``required_halo``), and so
    cannot drop; a given ``halo`` that exceeds a block, or
    ``force_all_gather``, gathers every block instead.  Differentiable in
    ``feats`` and ``kernel``; the kernel's gradient is the whole one,
    summed over the group."""
    group, n, r = comm.axis(mesh, axis_name)
    lo, hi = block_bounds(kmap.n_in, n, r)
    if feats.shape[0] != hi - lo:
        raise ValueError(f"rank {r} of {n} holds rows {lo}..{hi} of {kmap.n_in}, "
                         f"got {feats.shape[0]} feature rows")
    shortest_in, shortest_out = kmap.n_in // n, kmap.n_out // n
    gather_all = bool(force_all_gather)
    if halo is None:
        hf, hb = required_halo(kmap, n)
        gather_all |= hf > shortest_in or hb > shortest_out
    else:
        hf = hb = int(halo)
        gather_all |= hf > min(shortest_in, shortest_out)
    plan = _Plan(group, n, r, kmap.n_in, kmap.n_out, hf, hb, gather_all)
    return _SpatialConv.apply(feats, kernel, kmap.in_idx, kmap.out_idx_t, plan)


def spatial_masked_moments(feats, valid, *, mesh: DeviceMesh, axis_name: str = "space"):
    """(mean, biased var) over the valid rows of every rank's block: this
    rank passes its block of the features and of the (N,) mask.  The
    synchronized batch-norm statistics of one sharded cloud."""
    group = mesh.get_group(axis_name)
    mean, var, _ = batch_moments(feats[valid.bool()],
                                 lambda stats: comm.AllReduceSum.apply(stats, group))
    return mean, var


def spatial_global_sum(feats, batch_ids, n_batches: int, *, mesh: DeviceMesh,
                       axis_name: str = "space"):
    """Per-batch sums of every rank's rows: this rank passes its block of
    the features and of the (N,) batch ids (-1: no batch)."""
    return comm.AllReduceSum.apply(segment_sum(feats, batch_ids, n_batches),
                                   mesh.get_group(axis_name))


def spatial_global_avg(feats, batch_ids, n_batches: int, *, mesh: DeviceMesh,
                       axis_name: str = "space"):
    """Per-batch means of every rank's rows."""
    s = spatial_global_sum(feats, batch_ids, n_batches, mesh=mesh, axis_name=axis_name)
    cnt = segment_count(batch_ids, n_batches).to(s.dtype)
    cnt = comm.all_reduce(cnt, mesh.get_group(axis_name))
    return s / cnt.clamp_min(1.0)[:, None]
