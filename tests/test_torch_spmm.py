"""Port parity for ``spmm``, ``spmm_average`` and their Function shims.

Seeded COO matrices (duplicate entries and -1 rows and columns included)
times seeded dense features go through the JAX package's functions and the
port's; products, row counts and the gradients with respect to the dense
matrix and the values agree within rtol 1e-5 / atol 1e-6 (sums of a few
float32 products in another order).  A -1 row or column adds nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minkowskiengine_tpu as ME
import minkowskiengine_tpu_torch as MT

RTOL, ATOL = 1e-5, 1e-6


def _coo(seed, n_rows=40, n_cols=30, nnz=200, holes=True):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, n_rows, nnz).astype(np.int64)
    cols = rng.randint(0, n_cols, nnz).astype(np.int64)
    if holes:
        rows[rng.rand(nnz) < 0.1] = -1
        cols[rng.rand(nnz) < 0.1] = -1
    vals = rng.randn(nnz).astype(np.float32)
    mat = rng.randn(n_cols, 5).astype(np.float32)
    return rows, cols, vals, (n_rows, n_cols), mat


def _dense(rows, cols, vals, size):
    keep = (rows >= 0) & (cols >= 0)
    a = np.zeros(size, np.float64)
    np.add.at(a, (rows[keep], cols[keep]), vals[keep])
    return a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spmm_matches_jax_and_the_dense_product(seed):
    rows, cols, vals, size, mat = _coo(seed)
    want, vjp = jax.vjp(lambda v, m: ME.spmm(jnp.asarray(rows), jnp.asarray(cols), v, size, m),
                        jnp.asarray(vals), jnp.asarray(mat))
    g = np.random.RandomState(seed + 10).randn(size[0], 5).astype(np.float32)
    want_dv, want_dm = vjp(jnp.asarray(g))
    tv = torch.from_numpy(vals).requires_grad_()
    tm = torch.from_numpy(mat).requires_grad_()
    got = MT.spmm(torch.from_numpy(rows), torch.from_numpy(cols), tv, size, tm)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.detach().numpy(), _dense(rows, cols, vals, size) @ mat,
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(want_dv), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(want_dm), rtol=RTOL, atol=ATOL)
    shim = MT.MinkowskiSPMMFunction.apply(rows, cols, vals, size, torch.from_numpy(mat))
    assert torch.equal(shim, got.detach())


def test_spmm_matches_torch_sparse():
    rows, cols, vals, size, mat = _coo(3, holes=False)
    a = torch.sparse_coo_tensor(np.stack([rows, cols]), vals, size)
    got = MT.spmm(rows, cols, vals, size, torch.from_numpy(mat))
    torch.testing.assert_close(got, torch.sparse.mm(a, torch.from_numpy(mat)), rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_spmm_average_matches_jax(seed):
    rows, cols, _, size, mat = _coo(seed)
    (want, want_count), vjp = jax.vjp(
        lambda m: ME.spmm_average(jnp.asarray(rows), jnp.asarray(cols), size, m), jnp.asarray(mat))
    g = np.random.RandomState(seed + 20).randn(size[0], 5).astype(np.float32)
    (want_dm,) = vjp((jnp.asarray(g), jnp.zeros_like(want_count)))
    tm = torch.from_numpy(mat).requires_grad_()
    got, count = MT.spmm_average(torch.from_numpy(rows), torch.from_numpy(cols), size, tm)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(count.numpy(), np.asarray(want_count))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(want_dm), rtol=RTOL, atol=ATOL)
    shim = MT.MinkowskiSPMMAverageFunction.apply(rows, cols, size, torch.from_numpy(mat))
    assert torch.equal(shim, got.detach())
    assert np.asarray(ME.MinkowskiSPMMAverageFunction.apply(
        jnp.asarray(rows), jnp.asarray(cols), size, jnp.asarray(mat))).shape == tuple(shim.shape)


def test_holes_add_nothing():
    mat = torch.arange(6.0).reshape(3, 2)
    out = MT.spmm([0, -1, 1, 1], [2, 0, -1, 1], [2.0, 5.0, 7.0, 1.0], (2, 3), mat)
    torch.testing.assert_close(out, torch.tensor([[8.0, 10.0], [2.0, 3.0]]))
    avg, count = MT.spmm_average([0, 0, 1, -1], [0, 2, 1, 0], (3, 3), mat)
    torch.testing.assert_close(avg, torch.tensor([[2.0, 3.0], [2.0, 3.0], [0.0, 0.0]]))
    assert count.tolist() == [2, 1, 0]
