"""Data parallelism over a ``torch.distributed`` device mesh.

Counterpart of ``minkowskiengine_tpu/parallel/data_parallel.py``, and the
reference's own multi-GPU regime (examples/multigpu_ddp.py): one process
per rank, each on its own batch, gradients averaged over the ranks.  A mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` (PyTorch's counterpart
of ``jax.sharding.Mesh``), and ``mesh.get_group(axis)`` gives every
collective its group.  Rank r computes on ``cuda:(LOCAL_RANK %
device_count)`` (``rank_device``), or on the CPU for a mesh made with
``device="cpu"``.

Two regimes, as in JAX:

- **Shared geometry** (``make_data_parallel_step``): each rank computes
  ``loss_fn(model, *batch)`` on its own batch.
- **Per-device geometry** (``make_per_device_geometry_step``): each rank
  trains on its own point cloud through its own ``Geometry`` (a stacked
  one of one is squeezed first, as JAX's ``_inner`` does), rebuilt inside
  ``loss_fn`` by ``CoordinateManager.from_geometry``.

The gradient average (JAX's ``lax.pmean``) is one explicit all-reduce of
every gradient and the loss, packed into one buffer in the parameters'
dtype (a model's parameters share one), then a division by the group's
size.  The port does not wrap the model in
``DistributedDataParallel``: DDP needs ``find_unused_parameters=True``
wherever a forward leaves a parameter without a gradient, and then makes
an extra pass over the graph every step; here a parameter without a
gradient takes zeros, as JAX's gradient of an unused parameter is zero,
and every rank sends the same buffer.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..coords.geometry import Geometry, slice_geometry, squeeze_geometry
from ..types import resolve_device
from . import comm


def rank_device(device_type: str) -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count)`` (``LOCAL_RANK``
    unset: the global rank), or the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data", device=None) -> DeviceMesh:
    """1-D mesh over the first ``n_devices`` ranks (default: the world),
    on the card unless ``device="cpu"``.  The process group must be
    initialized, or ``init_device_mesh`` initializes it from the
    environment."""
    device_type = resolve_device(device).type
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis_name,))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def replicate(tree, mesh: DeviceMesh):
    """Every tensor of ``tree`` (tensors, a module's parameters and buffers,
    in dicts, lists and tuples) as the mesh's first rank holds it.  A
    module is updated in place; a tensor is broadcast into a copy on this
    rank's device."""
    groups = [mesh.get_group(d) for d in range(mesh.ndim)]
    dev = rank_device(mesh.device_type)

    def bcast(t):
        for g in groups:  # along each axis in turn from coordinate 0
            comm.broadcast(t, g)
        return t

    def leaf(x):
        if isinstance(x, nn.Module):
            with torch.no_grad():
                for t in list(x.parameters()) + list(x.buffers()):
                    bcast(t.data)
            return x
        if isinstance(x, torch.Tensor):
            return bcast(x.detach().to(dev, copy=True))
        return x

    return _map(leaf, tree)


def shard_batch(tree, mesh: DeviceMesh, axis_name: str = "data"):
    """This rank's slice of the leading axis of every leaf (tensors, numpy
    arrays, stacked Geometries), on this rank's device.  The leading axis
    must divide by the axis size."""
    _, n, r = comm.axis(mesh, axis_name)
    dev = rank_device(mesh.device_type)

    def bounds(length):
        if length % n:
            raise ValueError(f"leading axis {length} does not divide over {n} ranks")
        per = length // n
        return r * per, (r + 1) * per

    def leaf(x):
        if isinstance(x, Geometry):
            return slice_geometry(x, *bounds(len(next(iter(x.row_shapes.values()))))).to(dev)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor):
            lo, hi = bounds(x.shape[0])
            return x[lo:hi].to(dev)
        return x

    return _map(leaf, tree)


def average_gradients(model: nn.Module, group, loss: torch.Tensor) -> torch.Tensor:
    """Replace every parameter's gradient by its mean over ``group`` (a
    missing gradient counts as zeros) and return the loss's mean: one
    all-reduce of one buffer in the parameters' dtype, which they share."""
    params = [p for p in model.parameters() if p.requires_grad]
    dtype = params[0].dtype
    if any(p.dtype != dtype for p in params):
        raise TypeError("average_gradients takes a model whose parameters share one dtype")
    parts = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([t.reshape(-1) for t in parts] + [loss.detach().to(dtype).reshape(1)])
    flat = comm.all_reduce(flat, group).div_(dist.get_world_size(group))
    offset = 0
    for p in params:
        g = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
        if p.grad is None:
            p.grad = g.clone()
        else:
            p.grad.copy_(g)
    return flat[-1]


def make_data_parallel_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable,
    mesh: DeviceMesh,
    axis_name: str = "data",
):
    """A data-parallel training step.

    ``loss_fn(model, *local_batch) -> scalar`` runs on this rank's batch
    (``shard_batch`` keeps a leading axis of ``global // n``, usually 1);
    its gradients are averaged over ``axis_name`` (on a 2-D ("data",
    "model") mesh, over the data axis only), then the optimizer steps.
    Returns ``step(model, optimizer, *batch) -> loss``, the loss averaged
    over the ranks.  ``MinkowskiSyncBatchNorm`` layers built with
    ``process_group=mesh`` share their statistics over the same axis."""
    group = mesh.get_group(axis_name)

    def step(model, optimizer, *batch):
        optimizer.zero_grad()
        loss = loss_fn(model, *batch)
        loss.backward()
        mean_loss = average_gradients(model, group, loss)
        optimizer.step()
        return mean_loss

    return step


def make_per_device_geometry_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable,
    mesh: DeviceMesh,
    axis_name: str = "data",
):
    """A data-parallel step in which each rank trains on its own geometry.

    ``loss_fn(model, geo, *local_batch) -> scalar`` takes this rank's
    ``Geometry`` (squeezed when a stacked one of one comes in, as
    ``shard_batch`` of ``stack_geometries`` gives) and rebuilds the input::

        mgr = MT.CoordinateManager.from_geometry(geo)
        xt = MT.SparseTensor(feats, coordinate_map_key=geo.entry_key,
                             coordinate_manager=mgr)

    Returns ``step(model, optimizer, geo, *batch) -> loss``, the loss
    averaged over the ranks."""
    group = mesh.get_group(axis_name)

    def step(model, optimizer, geo, *batch):
        if geo.row_shapes is not None:
            geo = squeeze_geometry(geo)
        optimizer.zero_grad()
        loss = loss_fn(model, geo, *batch)
        loss.backward()
        mean_loss = average_gradients(model, group, loss)
        optimizer.step()
        return mean_loss

    return step


def all_reduce_metrics(tree, mesh: DeviceMesh, axis_name: str = "data"):
    """Each rank's own metric values (tensors or numbers), averaged over
    the ranks of ``axis_name``: the reference's explicit ``dist.all_reduce``
    (examples/multigpu_ddp.py:119).  JAX's takes one host array with a
    leading device axis and means over it; here every rank passes its own
    value and gets the mean back as a float64 tensor on its device."""
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    dev = rank_device(mesh.device_type)

    def leaf(v):
        t = torch.as_tensor(v).detach().to(dev, torch.float64, copy=True)
        return comm.all_reduce(t, group).div_(n)

    return _map(leaf, tree)
