"""Normalization over sparse-tensor rows.

Counterpart of ``minkowskiengine_tpu/nn/norm.py``.

``MinkowskiBatchNorm``: rows are exact-size, so no padding mask is needed,
and the module wraps ``torch.nn.BatchNorm1d`` as ``.bn`` the way the
reference does (MinkowskiNormalization.py:51-98): its state-dict names
(``bn.weight``, ``bn.running_mean``, ...) are the reference's.  Train mode
normalizes with the biased batch variance and updates the running variance
with the unbiased one; eval mode uses the running statistics.  It takes a
SparseTensor or a TensorField.  bf16 features are normalized in float32 and
cast back, as JAX's ``_apply`` does (JAX nn/norm.py:88-111); the running
statistics stay float32.

``axis_name`` (JAX's keyword, nn/norm.py:41): under a ``torch.distributed``
mesh entered as a context (``with mesh:``; the data-parallel steps enter
theirs) that has this axis, train-mode statistics are (count, sum, sum of
squares) in float32 all-reduced over the axis's group and normalized as
``MinkowskiSyncBatchNorm`` does; elsewhere, and on a group of one rank (as
``torch.nn.SyncBatchNorm``), it is the plain batch norm, as JAX's is
outside a ``shard_map`` binding the axis.

Under spatial execution (an input that holds a row block of its cloud,
``parallel/spatial.py``) batch norm in train mode takes its statistics
over every row of the cloud, not over the block: each rank's (count, sum,
sum of squares), in float32, are all-reduced over the block's group, as
JAX's ``spatial_masked_moments`` does and as its partitioner does for a
sharded batch norm; the normalization then follows
``MinkowskiSyncBatchNorm``'s sums.  The affine parameters enter through
``RowBlock.replicated``, so their gradients are summed over the group.

``MinkowskiSyncBatchNorm``: batch norm whose (count, sum, sum of squares),
taken in float32, are all-reduced over a ``torch.distributed`` process group
(the default one unless ``process_group`` names another, or a mesh's
``axis_name`` group when ``process_group`` is a ``DeviceMesh``, as JAX's
``axis_name`` names a mesh axis) when one is initialized, with a gradient
(JAX: ``lax.psum`` over a mesh axis, nn/norm.py:122-180).  Outside a group
it normalizes with the same sums, unreduced.
``convert_sync_batchnorm`` swaps a model's batch norms for it in place,
keeping each ``.bn`` (parameters, buffers, names).

``MinkowskiInstanceNorm``: per batch item (point cloud), the mean and the
biased variance over the item's rows (its origin-map segment), then
``weight`` and ``bias`` of shape (1, C) under the reference's names
(MinkowskiNormalization.py:361-399).

``MinkowskiInstanceNormFunction``: the reference's autograd Function
(MinkowskiNormalization.py:194-310) as an ``.apply`` shim, the same global
pooling and broadcast written in torch ops; autograd gives its backward.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..ops import functional as F
from ..parallel import comm
from ..sparse_tensor import whole_rows
from ..types import resolve_device


class MinkowskiBatchNorm(nn.Module):
    def __init__(
        self,
        num_features: int,
        eps: float = 1e-5,
        momentum: float = 0.1,
        affine: bool = True,
        track_running_stats: bool = True,
        axis_name=None,
        device=None,
    ):
        super().__init__()
        self.axis_name = axis_name
        self.bn = nn.BatchNorm1d(
            num_features,
            eps=eps,
            momentum=momentum,
            affine=affine,
            track_running_stats=track_running_stats,
            device=resolve_device(device),
        )

    def forward(self, input):
        block = getattr(input, "row_block", None)
        if block is not None:
            reduce = None
            if block.size > 1:
                def reduce(stats):
                    return comm.AllReduceSum.apply(stats, block.group)
            return self._normalize(input, reduce, block)
        reduce = self._reduce()
        if reduce is None:
            feats = input.F
            work = torch.promote_types(feats.dtype, torch.float32)  # f32 statistics under bf16
            return input._wrap(self.bn(feats.to(work)).to(feats.dtype))
        return self._normalize(input, reduce)

    def _reduce(self):
        """How this step's (count, sum, sum of squares) are summed over the
        ranks: a function for ``_normalize``, or None for the plain batch
        norm.  Here, in train mode, the all-reduce over the group of
        ``axis_name`` on the mesh entered as a context (``with mesh:``, as
        the data-parallel steps enter theirs); None outside such a mesh, or
        on one without that axis, as JAX's is plain outside a ``shard_map``
        binding the axis, and on a group of one rank, whose sum is its own,
        as ``torch.nn.SyncBatchNorm`` takes the plain path there."""
        if self.axis_name is None or not (self.training or not self.bn.track_running_stats):
            return None
        if not (dist.is_available() and dist.is_initialized()):
            return None
        mesh = comm.current_mesh()
        if mesh is None or self.axis_name not in (mesh.mesh_dim_names or ()):
            return None
        group = mesh.get_group(self.axis_name)
        if dist.get_world_size(group) == 1:
            return None
        return lambda stats: comm.AllReduceSum.apply(stats, group)

    def _normalize(self, input, reduce=None, block=None):
        """Normalize with (count, sum, sum of squares) in float32, summed by
        ``reduce`` (over the ranks) where given: ``mean = sum / count``, the
        biased ``var = max(sq / count - mean², 0)``, and the running variance
        takes the unbiased ``var · count / (count - 1)``, as JAX computes
        them.  Eval mode uses the running statistics.  On a row block the
        affine parameters' gradients sum over its group."""
        feats = input.F
        x = feats.to(torch.promote_types(feats.dtype, torch.float32))
        bn = self.bn
        if self.training or not bn.track_running_stats:
            mean, var, count = F.batch_moments(x, reduce)
            if self.training and bn.track_running_stats:
                with torch.no_grad():
                    bn.num_batches_tracked.add_(1)
                    m = bn.momentum
                    unbiased = var * count / (count - 1.0).clamp_min(1.0)
                    bn.running_mean.mul_(1 - m).add_(m * mean.to(bn.running_mean.dtype))
                    bn.running_var.mul_(1 - m).add_(m * unbiased.to(bn.running_var.dtype))
        else:
            mean, var = bn.running_mean, bn.running_var
        out = (x - mean) * torch.rsqrt(var + bn.eps)
        if bn.affine:
            w, b = bn.weight, bn.bias
            if block is not None:
                w, b = block.replicated(w), block.replicated(b)
            out = out * w + b
        return input._wrap(out.to(feats.dtype))


def _own(stats):
    """This rank's sums, unreduced."""
    return stats


class _AllReduceSum(comm.AllReduceSum):
    """``comm.AllReduceSum`` that adds each all-reduce, forward or
    backward, to ``MinkowskiSyncBatchNorm.all_reduces``."""

    @staticmethod
    def forward(ctx, x, group):
        MinkowskiSyncBatchNorm.all_reduces += 1
        return comm.AllReduceSum.forward(ctx, x, group)

    @staticmethod
    def backward(ctx, grad):
        MinkowskiSyncBatchNorm.all_reduces += 1
        return comm.AllReduceSum.backward(ctx, grad)


class MinkowskiSyncBatchNorm(MinkowskiBatchNorm):
    """Cross-replica batch norm (reference: MinkowskiNormalization.py:101-191).

    In train mode (or without running statistics) each rank sums its rows'
    count, sum and sum of squares in float32; with ``torch.distributed``
    initialized the three are all-reduced over ``process_group`` (default:
    the world; a ``DeviceMesh``: its ``axis_name`` group), then normalize
    as ``MinkowskiBatchNorm._normalize`` says.  Eval mode uses the running
    statistics.  ``MinkowskiSyncBatchNorm.all_reduces`` counts the
    all-reduces of every instance, forward and backward.  On a row block
    (spatial execution) it sums over the block's group, as batch norm does.
    """

    all_reduces = 0

    def __init__(
        self,
        num_features: int,
        eps: float = 1e-5,
        momentum: float = 0.1,
        affine: bool = True,
        track_running_stats: bool = True,
        process_group=None,
        device=None,
        axis_name: str = "data",
    ):
        super().__init__(num_features, eps, momentum, affine, track_running_stats,
                         axis_name=axis_name, device=device)
        self.process_group = process_group

    def _reduce(self):
        """The all-reduce over ``process_group`` (its ``axis_name`` group for
        a ``DeviceMesh``) once ``torch.distributed`` is initialized, else
        this rank's own sums: ``_normalize`` in every mode."""
        if not (dist.is_available() and dist.is_initialized()):
            return _own
        group = self.process_group
        if isinstance(group, DeviceMesh):
            group = group.get_group(self.axis_name)
        return lambda stats: _AllReduceSum.apply(stats, group)

    @classmethod
    def convert_sync_batchnorm(cls, module: nn.Module, process_group=None,
                               axis_name: str = "data") -> nn.Module:
        """Replace every ``MinkowskiBatchNorm`` in ``module`` (itself
        included) by a ``MinkowskiSyncBatchNorm`` holding the same ``.bn``,
        so parameters, buffers and state-dict names stay as they were; in
        place, returning ``module`` or its replacement (reference:
        MinkowskiNormalization.py:139-191)."""
        if isinstance(module, MinkowskiBatchNorm) and not isinstance(module, cls):
            bn = module.bn
            out = cls(bn.num_features, bn.eps, bn.momentum, bn.affine, bn.track_running_stats,
                      process_group=process_group, device="meta", axis_name=axis_name)
            out.bn = bn
            return out.train(module.training)
        for name, child in module.named_children():
            new = cls.convert_sync_batchnorm(child, process_group, axis_name)
            if new is not child:
                setattr(module, name, new)
        return module


def _instance_normalize(feats, origin_rows, num, eps):
    mean = F.segment_mean(feats, origin_rows, num)
    centered = feats - F.take_rows(mean, origin_rows)
    var = F.segment_mean(centered * centered, origin_rows, num)
    return centered * F.take_rows(torch.rsqrt(var + eps), origin_rows)


class MinkowskiInstanceNormFunction:
    """``apply(in_feat, in_coords_key, glob_coords_key=None,
    coords_manager=None, gpooling_mode=None)``: each batch item's rows
    centred on their mean and scaled by 1/√(biased variance + 1e-8), as
    JAX's shim computes it; an unset ``glob_coords_key`` is set to the
    origin map's key."""

    @staticmethod
    def apply(in_feat, in_coords_key, glob_coords_key=None, coords_manager=None, gpooling_mode=None):
        origin_key, origin_rows = coords_manager.origin_map(in_coords_key)
        if glob_coords_key is not None and not glob_coords_key.is_key_set():
            glob_coords_key.set_key(*origin_key.get_key())
        out = _instance_normalize(in_feat, origin_rows, coords_manager.size(origin_key), 1e-8)
        return torch.where((origin_rows >= 0)[:, None], out, 0.0)


class MinkowskiInstanceNorm(nn.Module):
    def __init__(self, num_features: int, device=None):
        super().__init__()
        self.num_features = int(num_features)
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.ones((1, num_features), device=dev))
        self.bias = nn.Parameter(torch.zeros((1, num_features), device=dev))
        self.eps = 1e-6

    def forward(self, input):
        whole_rows(input, "instance norm")
        manager = input.coordinate_manager
        origin_key, origin_rows = manager.origin_map(input.coordinate_map_key)
        out = _instance_normalize(input.F, origin_rows, manager.size(origin_key), self.eps)
        return input._wrap(out * self.weight + self.bias)

    def extra_repr(self):
        return f"nchannels={self.num_features}"


class MinkowskiStableInstanceNorm(MinkowskiInstanceNorm):
    """The reference's numerically stabilized form (MinkowskiNormalization.py:
    313-360); the base class already centers before it squares."""
