"""Feature-phase primitives: row gathers, segment reductions, pooling,
pruning, union, broadcast, interpolation, splatting, the channelwise and the
sparse convolution.

Counterpart of ``minkowskiengine_tpu/ops/functional.py``.  Rows are
exact-size; index -1 means "no pair" and gathers a zero row.  The segment
reductions, pooling, broadcast, interpolation, splatting and the channelwise
convolution are XLA ops in the JAX package and plain torch here (``index_add``, ``scatter_reduce``);
only the sparse convolution runs on hand-written kernels.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..coords.kernel_map import KernelMap
from ..kernels.conv_dw import conv_dw
from ..kernels.gather_gemm import gather_gemm
from ..utils import profiling as P


def take_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows; any index < 0 or >= N yields a zero row."""
    n = feats.shape[0]
    padded = torch.cat([feats, feats.new_zeros((1,) + tuple(feats.shape[1:]))])
    safe = torch.where((idx >= 0) & (idx < n), idx, n).long()
    return padded.index_select(0, safe)


# ---------------------------------------------------------------------------
# segment reductions (quantization, global pooling, instance norm)
# ---------------------------------------------------------------------------


def _segment_ids(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """ids < 0 go to one spare segment past the end, which is dropped."""
    return torch.where(seg_ids >= 0, seg_ids.long(), num_segments)


def segment_sum(feats: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum rows by segment id; ids < 0 are dropped.  bf16 rows are summed
    in float32 and the sums rounded to bf16 once, on the CPU and under
    CUDA's atomics alike; JAX's CPU scatter rounds after every add, which
    stalls a long sum (26,115 rows of 0.5 stop at 128)."""
    acc = torch.float32 if feats.dtype == torch.bfloat16 else feats.dtype
    out = feats.new_zeros((num_segments + 1,) + tuple(feats.shape[1:]), dtype=acc)
    out = out.index_add(0, _segment_ids(seg_ids, num_segments), feats.to(acc))[:num_segments]
    return out.to(feats.dtype)


def segment_count(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Rows per segment (int64); ids < 0 are dropped."""
    ids = _segment_ids(seg_ids, num_segments)
    with P.host_read("segment_count", reads=2):  # bincount reads the ids' least and largest
        counts = torch.bincount(ids, minlength=num_segments + 1)
    return counts[:num_segments]


def segment_mean(feats: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    s = segment_sum(feats, seg_ids, num_segments)
    c = segment_count(seg_ids, num_segments)
    return s / c.clamp_min(1).to(s.dtype)[:, None]


def segment_max(feats: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Max rows by segment id; an empty segment gives 0.  The gradient of a
    tie is split evenly among the tied rows, as JAX's ``.at[].max`` does."""
    ids = _segment_ids(seg_ids, num_segments)[:, None].expand_as(feats)
    out = feats.new_full((num_segments + 1,) + tuple(feats.shape[1:]), -torch.inf)
    out = out.scatter_reduce(0, ids, feats, "amax", include_self=False)[:num_segments]
    return torch.where(torch.isneginf(out), 0.0, out)


def batch_moments(x: torch.Tensor, reduce=None):
    """(mean, biased var, count) of the rows of ``x`` from (count, sum, sum
    of squares), summed over the ranks by ``reduce`` where given: batch
    norm's statistics, as JAX computes them."""
    c = x.shape[1]
    stats = torch.cat([x.new_full((1,), float(x.shape[0])), x.sum(0), (x * x).sum(0)])
    if reduce is not None:
        stats = reduce(stats)
    count = stats[0].clamp_min(1.0)
    mean = stats[1:1 + c] / count
    var = (stats[1 + c:] / count - mean * mean).clamp_min(0.0)
    return mean, var, count


def channelwise_conv(feats: torch.Tensor, kernel: torch.Tensor, in_idx: torch.Tensor) -> torch.Tensor:
    """Depthwise convolution ``out[o] = Σ_k feats[in_idx[k, o]] * kernel[k]``;
    kernel (K, ch), a slot -1 adds nothing (reference:
    MinkowskiChannelwiseConvolution.py:142-191).  One gather and one
    multiply-add per offset into an (N_out, ch) sum, as JAX's scan runs it;
    the zero row and the safe indices are made once for all offsets, so an
    offset costs two launches.  Autograd gives the backward.  A kernel
    whose dtype would widen the sum (bf16 features, a float32 kernel)
    raises ``TypeError``, as JAX's scan does on the changed carry type."""
    if torch.promote_types(feats.dtype, kernel.dtype) != feats.dtype:
        raise TypeError(
            f"channelwise_conv: {kernel.dtype} kernel would widen the {feats.dtype} features' sum"
        )
    n = feats.shape[0]
    padded = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])
    safe = torch.where((in_idx >= 0) & (in_idx < n), in_idx, n).long()
    acc = feats.new_zeros((in_idx.shape[1], feats.shape[1]))
    for idx_k, w_k in zip(safe, kernel):
        acc = acc.addcmul_(padded.index_select(0, idx_k), w_k[None, :])
    return acc


# ---------------------------------------------------------------------------
# local pooling over a kernel map's in_idx (K, N_out)
# ---------------------------------------------------------------------------


def local_pool_sum(feats: torch.Tensor, in_idx: torch.Tensor):
    """Returns (pooled (N_out, ch), pairs per output row (N_out,)), summed
    over the kernel slots in order, as JAX's scan does."""
    n_out = in_idx.shape[1]
    acc = feats.new_zeros((n_out, feats.shape[1]))
    cnt = feats.new_zeros((n_out,))
    for idx_k in in_idx:
        acc = acc + take_rows(feats, idx_k)
        cnt = cnt + (idx_k >= 0).to(feats.dtype)
    return acc, cnt


def local_pool_avg(feats: torch.Tensor, in_idx: torch.Tensor):
    acc, cnt = local_pool_sum(feats, in_idx)
    return acc / cnt.clamp_min(1.0)[:, None], cnt


def local_pool_max(feats: torch.Tensor, in_idx: torch.Tensor) -> torch.Tensor:
    """Max pooling; rows with no pairs give 0.

    The gradient goes whole to the stored argmax, and the first maximum in
    slot order wins a tie (a strict comparison per slot), as in JAX's
    ``local_pool_max`` and the reference's max_index mask
    (src/pooling_max_kernel.hpp:35-117).  ``torch.amax`` over the slots, or
    a chain of ``torch.maximum``, would split a tie's gradient.
    """
    n_out = in_idx.shape[1]
    with torch.no_grad():
        best = feats.new_full((n_out, feats.shape[1]), -torch.inf)
        best_k = torch.full(best.shape, -1, dtype=torch.int64, device=feats.device)
        for k, idx_k in enumerate(in_idx):
            g = take_rows(feats, idx_k).masked_fill_((idx_k < 0)[:, None], -torch.inf)
            better = g > best
            best = torch.where(better, g, best)
            best_k.masked_fill_(better, k)
        # the winning input row of each (output row, channel); -1 for none
        win_row = in_idx.T.long().gather(1, best_k.clamp_min(0))
        win_row = torch.where(best_k >= 0, win_row, -1)
    gathered = feats.gather(0, win_row.clamp_min(0))
    return torch.where(win_row >= 0, gathered, 0.0)


def global_pool(feats: torch.Tensor, origin_rows: torch.Tensor, num_batches: int, mode: str):
    """Pool the rows of each batch item into one row; returns (pooled
    (num_batches, ch), rows per batch item).  ``mode``: sum, avg or max
    (reference: src/global_pooling_cpu.cpp:44-227)."""
    cnt = segment_count(origin_rows, num_batches)
    if mode == "sum":
        return segment_sum(feats, origin_rows, num_batches), cnt
    if mode == "avg":
        return segment_mean(feats, origin_rows, num_batches), cnt
    if mode == "max":
        return segment_max(feats, origin_rows, num_batches), cnt
    raise ValueError(f"unknown mode {mode}")


# ---------------------------------------------------------------------------
# pruning and union: row gathers, so autograd gives their gradients
# ---------------------------------------------------------------------------


def prune_features(feats: torch.Tensor, out_from_in: torch.Tensor) -> torch.Tensor:
    """The kept rows, gathered by the pruning map (reference:
    src/pruning_cpu.cpp:43-140)."""
    return take_rows(feats, out_from_in)


def union_features(feats_list, out_from_in_list) -> torch.Tensor:
    """Sum several tensors' features onto the union map's rows.  Each map is
    (N_union,) int32: the source row of each union row, -1 where the tensor
    has none (reference: MinkowskiUnion.py:33-83 scatter-adds; the rows of
    one tensor are unique, so a gather per tensor and a sum is the same)."""
    acc = None
    for feats, idx in zip(feats_list, out_from_in_list):
        g = take_rows(feats, idx)
        acc = g if acc is None else acc + g
    return acc


# ---------------------------------------------------------------------------
# broadcast, and interpolation and splatting over (N, 2^D) neighbour rows
# ---------------------------------------------------------------------------


def broadcast(feats: torch.Tensor, glob: torch.Tensor, origin_rows: torch.Tensor, op: str):
    """Combine each row with its batch item's global row (``glob`` at the
    row's origin row): ``op`` is ``"add"`` or ``"mul"``; a row whose origin
    row is < 0 gives 0 (reference: src/broadcast_cpu.cpp:43-150; autograd
    gives the backward)."""
    g = take_rows(glob, origin_rows)
    if op == "add":
        out = feats + g
    elif op == "mul":
        out = feats * g
    else:
        raise ValueError(f"unknown op {op}")
    return torch.where((origin_rows >= 0)[:, None], out, 0.0)


def interpolate_features(feats: torch.Tensor, neighbor_rows: torch.Tensor, weights: torch.Tensor):
    """Multilinear interpolation ``Σ_c w_c · feats[row_c]``; a row -1 (weight
    0) adds nothing (reference: src/interpolation_kernel.hpp:40-124)."""
    n, c = neighbor_rows.shape
    g = take_rows(feats, neighbor_rows.reshape(-1)).reshape(n, c, feats.shape[1])
    return torch.einsum("nc,ncf->nf", weights.to(g.dtype), g)


def splat_features(field_feats: torch.Tensor, neighbor_rows: torch.Tensor, weights: torch.Tensor,
                   num_rows: int) -> torch.Tensor:
    """The transpose of interpolation: each point adds its features, times
    each corner's weight, to the corner's row (TensorField.splat,
    MinkowskiTensorField.py:381-406)."""
    contrib = field_feats[:, None, :] * weights.to(field_feats.dtype)[:, :, None]
    return segment_sum(contrib.reshape(-1, field_feats.shape[1]), neighbor_rows.reshape(-1), num_rows)


class _SparseConv(torch.autograd.Function):
    """The conv and its hand-written VJP (JAX: ``_conv_vjp_bwd``).

    ``kernel`` comes in as the parameter itself (float32 under bf16
    compute) and is cast to the features' dtype here, not before the call:
    the weight gradient then leaves in float32, the sum K2 computes, as the
    TPU path returns it (``sparse_conv_dw_pallas``).  Cast outside, autograd
    would round it to bf16 on the way out of this Function and back up in
    the cast's backward."""

    @staticmethod
    def forward(ctx, feats, kernel, in_idx, out_idx_t):
        with P.conv_part("fwd"):
            w = kernel
            if feats.dtype == torch.bfloat16 and kernel.dtype == torch.float32:
                w = kernel.to(torch.bfloat16)
            ctx.save_for_backward(feats, w, in_idx, out_idx_t)
            return gather_gemm(feats, w.contiguous(), in_idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        feats, w, in_idx, out_idx_t = ctx.saved_tensors
        # torch.cat's backward hands its inputs column slices
        g = grad_out.contiguous()
        d_feats = d_kernel = None
        if ctx.needs_input_grad[0]:
            # d_feats[i] = Σ_k g[out_idx_t[k, i]] @ W[k]ᵀ: the forward kernel
            # on the transposed matching
            with P.conv_part("dx"):
                d_feats = gather_gemm(g, w.transpose(1, 2).contiguous(), out_idx_t)
        if ctx.needs_input_grad[1]:
            with P.conv_part("dw"):
                d_kernel = conv_dw(feats, g, in_idx)  # float32 for bf16 inputs
        return d_feats, d_kernel, None, None


def sparse_conv(
    feats: torch.Tensor,
    kernel: torch.Tensor,
    in_idx: torch.Tensor,
    out_idx_t: Optional[torch.Tensor],
) -> torch.Tensor:
    """Generalized sparse convolution:
    ``out[o] = Σ_k feats[in_idx[k, o]] @ kernel[k]``.

    Args:
      feats: (N_in, ch_in) input features: float32, bf16 (with a float32
        or bf16 ``kernel``), or float64 on the CPU.
      kernel: (K, ch_in, ch_out) weights, offset-major as in the reference
        (MinkowskiConvolution.py:262-285).
      in_idx: (K, N_out) int32 gather map, -1 = no pair.
      out_idx_t: (K, N_in) int32 inverse matching, read by the input
        gradient only; may be None when ``feats`` needs no gradient.

    Differentiable in ``feats`` and ``kernel``.  The forward and the input
    gradient run the gather-GEMM (on ``in_idx``, and on ``out_idx_t`` with
    ``kernel[k]ᵀ``), the weight gradient runs ``conv_dw``: the hand-written
    kernels for CUDA tensors, their plain versions for CPU tensors.  bf16
    features run the bf16 instances: the output and the input gradient are
    bf16, each rounded once from a float32 sum, and the weight gradient is
    float32.  Any other pairing of dtypes raises.
    """
    if out_idx_t is None and feats.requires_grad and torch.is_grad_enabled():
        raise ValueError("sparse_conv needs out_idx_t for the input gradient")
    return _SparseConv.apply(feats, kernel, in_idx, out_idx_t)


def sparse_conv_kmap(feats: torch.Tensor, kernel: torch.Tensor, kmap: KernelMap):
    """Sparse convolution through a cached kernel map.  Under
    ``config.spatial_execution`` ``feats`` is this rank's row block and the
    halo-exchange conv runs (``parallel.spatial.spatial_conv_apply``, with
    the halo measured per map, so no pair drops), as JAX's does."""
    from ..config import spatial_execution_ctx

    sp = spatial_execution_ctx()
    if sp is not None:
        from ..parallel.spatial import spatial_conv_apply

        out, _dropped = spatial_conv_apply(feats, kernel, kmap, mesh=sp[0], axis_name=sp[1])
        return out
    return sparse_conv(feats, kernel, kmap.in_idx, kmap.out_idx_t)
