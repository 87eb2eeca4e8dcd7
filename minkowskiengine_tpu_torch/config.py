"""Global framework configuration.

Counterpart of ``minkowskiengine_tpu/config.py``.  ``compute_dtype``: the
mixed-precision policy of the feature path.  Set to ``torch.bfloat16``, every
convolution module casts its input features and its weight view to bf16 and
runs the bf16 instances of the gather-GEMM and the weight-gradient kernels;
parameters stay float32 (the master weights), the weight gradient comes
back in float32, and batch norm computes its statistics in float32.
``None``, the default, follows the input's dtype.

``spatial_execution``: one cloud split over the ranks of a mesh axis, every
conv run on its rank's row block with a halo (``parallel/spatial.py``).
The JAX package's ``set_force_xla_conv`` is not carried over: its tensor
parallelism needs XLA's partitioner, while the port's runs K1 and K2 on each
rank's column slice (``parallel/tensor_parallel.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

_compute_dtype: Optional[torch.dtype] = None


def set_compute_dtype(dtype: Optional[torch.dtype]) -> None:
    """Set the activation compute dtype (``None``: follow the input)."""
    global _compute_dtype
    if dtype is not None and not (isinstance(dtype, torch.dtype) and dtype.is_floating_point):
        raise TypeError(f"compute dtype must be a floating torch.dtype or None, got {dtype!r}")
    _compute_dtype = dtype


def compute_dtype() -> Optional[torch.dtype]:
    return _compute_dtype


_spatial_ctx = None


def set_spatial_execution(mesh, axis_name: str = "space") -> None:
    """Route every sparse convolution through the halo-exchange spatial
    path (``parallel/spatial.py``): each rank of ``mesh``'s ``axis_name``
    group holds one row block of every map's features
    (``parallel.shard_sparse_tensor``), the conv gathers one halo band per
    side, and its weight gradient is summed over the group.  Pass
    ``mesh=None`` to clear.  Every rank must hold the same maps (the same
    cloud, the same manager calls)."""
    global _spatial_ctx
    _spatial_ctx = None if mesh is None else (mesh, axis_name)


def spatial_execution_ctx():
    """``(mesh, axis_name)`` under spatial execution, else ``None``."""
    return _spatial_ctx


class spatial_execution:
    """Context manager: ``with MT.spatial_execution(mesh): net(xs)`` runs
    every conv spatially sharded (see ``set_spatial_execution``)."""

    def __init__(self, mesh, axis_name: str = "space"):
        self.mesh = mesh
        self.axis_name = axis_name

    def __enter__(self):
        set_spatial_execution(self.mesh, self.axis_name)
        return self

    def __exit__(self, *exc):
        set_spatial_execution(None)
        return False
