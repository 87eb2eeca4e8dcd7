"""Sparse-matrix × dense-feature products (SPMM).

Counterpart of ``minkowskiengine_tpu/sparse_matrix_functions.py``
(reference: MinkowskiEngine/sparse_matrix_functions.py:32-213, which calls
cuSPARSE).  A COO product is a row gather, a scale and a segment sum: an
``index_select`` and an ``index_add_`` in plain torch, with autograd for
the transposed product of the backward.  An entry whose row or column is
-1 adds nothing.
"""

from __future__ import annotations

import torch

from .ops.functional import segment_count, segment_sum, take_rows


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(a, device=device).long()


def spmm(rows, cols, vals, size, mat: torch.Tensor, is_sorted: bool = False) -> torch.Tensor:
    """``out[r] = Σ_{(r, c, v)} v · mat[c]``, out (size[0], ch)
    (reference: sparse_matrix_functions.py:32-77)."""
    rows, cols = _index(rows, mat.device), _index(cols, mat.device)
    vals = torch.as_tensor(vals, device=mat.device).to(mat.dtype)
    return segment_sum(take_rows(mat, cols) * vals[:, None], rows, int(size[0]))


def spmm_average(rows, cols, size, mat: torch.Tensor, is_sorted: bool = False):
    """``out[r]`` = the mean of ``mat[c]`` over the entries of row r, and
    the entries per row (reference: sparse_matrix_functions.py:80-121)."""
    rows, cols = _index(rows, mat.device), _index(cols, mat.device)
    num_rows = int(size[0])
    s = segment_sum(take_rows(mat, cols), rows, num_rows)
    c = segment_count(rows, num_rows)
    return s / c.clamp_min(1).to(s.dtype)[:, None], c


class MinkowskiSPMMFunction:
    """The reference's autograd Function (sparse_matrix_functions.py:124-170)
    as an ``.apply`` shim."""

    @staticmethod
    def apply(rows, cols, vals, size, mat):
        return spmm(rows, cols, vals, size, mat)


class MinkowskiSPMMAverageFunction:
    """``.apply(rows, cols, size, mat)``: the averaged product alone."""

    @staticmethod
    def apply(rows, cols, size, mat):
        return spmm_average(rows, cols, size, mat)[0]
