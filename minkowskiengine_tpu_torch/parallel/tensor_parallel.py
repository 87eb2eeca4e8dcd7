"""Tensor parallelism: column-parallel sparse convs and linears.

Counterpart of ``minkowskiengine_tpu/parallel/tensor_parallel.py``.  A
sparse conv is a gather → GEMM per offset with a (K, Cin, Cout) kernel, so
splitting Cout over a ``"model"`` mesh axis splits each GEMM by columns
(Megatron's column parallelism).  JAX leaves the collectives to XLA's
partitioner, which cannot split a Pallas kernel, and so forces its XLA
conv path; the port runs K1 and K2 on each rank's slice itself:

- forward: K1 computes this rank's Cout slice of the output (with its
  bias slice); an ``all_gather`` over the model group rebuilds every
  column, because batch norm and the next layer read all channels;
- backward: the gather's gradient is this rank's slice of G; K2 gives the
  dW slice; K1 on ``out_idx_t`` with ``W[:, :, slice]ᵀ`` gives this rank's
  share of the input gradient, which an all-reduce (sum) over the model
  group makes whole.

So every activation between layers is whole on every rank, every
parameter that is not sharded (batch norm's, a layer whose Cout does not
divide) gets the same whole gradient on every rank, and a sharded one its
slice's.  On a 2-D ("data", "model") mesh, ``make_data_parallel_step(...,
axis_name="data")`` averages the gradients over the data axis only.

Usage (every rank builds the same weights, from one seed or through
``replicate``)::

    mesh = make_tp_mesh(tp=2)                     # or make_tp_mesh(2, dp=2)
    net = MinkUNet34(3, 20, D=3, generator=torch.Generator().manual_seed(0))
    apply_tensor_parallelism(net, mesh)           # slices the parameters in place
    y = net(x)                                    # every conv column-parallel
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..nn.conv import MinkowskiConvolutionBase
from ..nn.ops import MinkowskiLinear
from ..types import resolve_device
from . import comm
from .data_parallel import rank_device


def make_tp_mesh(
    tp: int,
    dp: Optional[int] = None,
    data_axis: str = "data",
    model_axis: str = "model",
    device=None,
) -> DeviceMesh:
    """Mesh with a trailing tensor-parallel axis: ("model",) of ``tp``
    ranks when ``dp`` is 1, else ("data", "model") of ``dp × tp`` (``dp``
    defaults to the world size over ``tp``)."""
    device_type = resolve_device(device).type
    if dp is None:
        dp = dist.get_world_size() // tp
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    if dp == 1:
        return init_device_mesh(device_type, (tp,), mesh_dim_names=(model_axis,))
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=(data_axis, model_axis))


class ColumnParallel(NamedTuple):
    """How a module runs column-parallel: its model group, and each sharded
    parameter's name and the dimension it is cut along.  Its two hooks wrap
    the module's calls: the input's features enter whole, with their
    gradient summed over the model group; the output's columns (this rank's
    slice) leave as every column."""

    group: object
    sharded: Tuple[Tuple[str, int], ...]

    def enter(self, module, args):
        x = args[0]
        return (x._wrap(comm.SumGradient.apply(x.F, self.group)),) + tuple(args[1:])

    def leave(self, module, args, out):
        return out._wrap(comm.GatherColumns.apply(out.F.contiguous(), self.group))

    def whole(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole parameter from each rank's slice ``t`` (not
        differentiable)."""
        return torch.cat(comm.all_gather(t.detach(), self.group), dim=dim)


def _column_params(m: nn.Module):
    """(Cout, ((path of each parameter cut by Cout, dim), ...)) of a conv or
    a linear, else None.  Conv kernels are (K, Cin, Cout) or (Cin, Cout)
    and biases (1, Cout); ``torch.nn.Linear``'s weight is (Cout, Cin) and
    its bias (Cout,)."""
    if isinstance(m, MinkowskiConvolutionBase):
        return m.out_channels, (("kernel", -1),) + ((("bias", -1),) if m.bias is not None else ())
    if isinstance(m, MinkowskiLinear):
        lin = m.linear
        return lin.out_features, (("linear.weight", 0),) + (
            (("linear.bias", 0),) if lin.bias is not None else ())
    return None


def apply_tensor_parallelism(net: nn.Module, mesh: DeviceMesh,
                             model_axis: str = "model") -> nn.Module:
    """Cut every conv's and linear's output channels over ``model_axis`` in
    place, where Cout divides by the axis size (the others stay whole, as
    do every norm's parameters), and make those layers run column-parallel
    through ``ColumnParallel``'s hooks; each cut module's
    ``column_parallel`` names its cut parameters.  Returns ``net``."""
    group, size, rank = comm.axis(mesh, model_axis)
    for m in list(net.modules()):
        spec = _column_params(m)
        if spec is None or spec[0] % size:
            continue
        cout, sharded = spec
        width = cout // size
        for path, dim in sharded:
            owner, _, name = path.rpartition(".")
            holder = m.get_submodule(owner) if owner else m
            p = getattr(holder, name)
            cut = p.detach().narrow(dim % p.ndim, rank * width, width).clone()
            setattr(holder, name, nn.Parameter(cut, requires_grad=p.requires_grad))
        m.column_parallel = cp = ColumnParallel(group, sharded)
        m.register_forward_pre_hook(cp.enter)
        m.register_forward_hook(cp.leave)
    return net
