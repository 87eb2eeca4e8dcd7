"""Port parity: the sparse conv's plain versions equal the JAX sparse conv.

The gather-GEMM is held against both JAX forms of
``out[o] = Σ_k X[in_idx[k,o]] @ W[k]``: ``ops/functional.py::sparse_conv``
(the XLA path) and ``sparse_conv_pallas`` (the Pallas slab kernel plus its
outlier correction), the latter run in Pallas interpret mode on a map with
outlier pairs.  The weight gradient ``conv_dw_reference`` is held against
the d_kernel of ``jax.vjp`` of ``sparse_conv`` and against
``sparse_conv_dw_pallas`` + ``_outlier_dw`` in interpret mode; the port's
``sparse_conv`` autograd Function against JAX's VJP, forward and on the
swapped (transposed) map.
Tolerance: f32, rtol 1e-5 (the sums run in another order), atol 1e-6 for
forward entries that cancel to near zero.  Gradients sum up to ~700
products of unit-variance values, so their entries reach ~30 and a sum in
another order moves them by up to ~30 · 2^-24 · sqrt(700) ≈ 5e-5: atol 1e-4
for entries that cancel to near zero.  The CUDA kernels themselves are held against the
same plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from minkowskiengine_tpu.ops import functional as JF
from minkowskiengine_tpu.ops.pallas.conv_kernel import (
    build_slab_map_from_span,
    measure_spans,
    slab_ladder,
    slab_tile,
    sparse_conv_dw_pallas,
    sub_ladder,
)
from minkowskiengine_tpu_torch.coords.kernel_map import KernelMap, _invert_matching
from minkowskiengine_tpu_torch.kernels.conv_dw import conv_dw, conv_dw_reference
from minkowskiengine_tpu_torch.kernels.gather_gemm import (
    gather_gemm,
    gather_gemm_reference,
)
from minkowskiengine_tpu_torch.ops import functional as TF

RTOL, ATOL = 1e-5, 1e-6
GRAD_ATOL = 1e-4


def _matching(K, n_out, n_in, seed, density=0.7, dead_rows=8):
    """Injective per-offset map with -1 holes and output rows with no pair."""
    rng = np.random.RandomState(seed)
    idx = np.stack([rng.permutation(n_in)[:n_out] for _ in range(K)]).astype(np.int32)
    idx[rng.rand(K, n_out) > density] = -1
    idx[:, rng.choice(n_out, dead_rows, replace=False)] = -1
    return idx


@pytest.mark.parametrize("cout", [3, 32])
@pytest.mark.parametrize("cin", [3, 32])
@pytest.mark.parametrize("K", [8, 27, 125])
def test_reference_matches_jax_sparse_conv(K, cin, cout):
    n_in, n_out = 300, 260
    rng = np.random.RandomState(K + cin + cout)
    x = rng.randn(n_in, cin).astype(np.float32)
    w = (rng.randn(K, cin, cout) / np.sqrt(K * cin)).astype(np.float32)
    idx = _matching(K, n_out, n_in, seed=K)
    want = np.asarray(JF.sparse_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx), None))
    got = gather_gemm_reference(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the public entry points take the plain version for CPU tensors
    via_op = TF.sparse_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(idx), None)
    np.testing.assert_array_equal(via_op.numpy(), got.numpy())
    dead = (idx < 0).all(0)
    assert dead.any() and np.all(got.numpy()[dead] == 0)


def _slab_map(cap, K, n, seed, span=300):
    """A slab map built the way tests/test_ntef.py::_mk_map builds one; the
    wide ±span index jitter leaves pairs outside their slab windows, which
    ride the outlier list."""
    rng = np.random.RandomState(seed)
    base = np.arange(cap)[None, :].repeat(K, 0)
    idx = np.clip(base + rng.randint(-span, span, (K, cap)), 0, n - 1)
    mask = (rng.rand(K, cap) < 0.5) & (np.arange(cap)[None, :] < n)
    in_idx = np.where(mask, idx, -1).astype(np.int32)
    ji = jnp.asarray(in_idx)
    tile = slab_tile(cap)
    sp = np.asarray(measure_spans(ji, tile, cap, slab_ladder(tile), sub_ladder(tile)))
    sm = build_slab_map_from_span(
        ji, cap, int(sp[0]), union_extra=int(sp[1]),
        outlier_counts=sp[3:], total_pairs=int(sp[2]),
    )
    return in_idx, sm


@pytest.mark.parametrize("cin,cout", [(3, 32), (32, 32)])
@pytest.mark.parametrize("K", [8, 27])
def test_reference_matches_jax_pallas_interpret(K, cin, cout):
    cap, n = 1024, 700
    in_idx, sm = _slab_map(cap, K, n, seed=K)
    assert sm.ov_src is not None and int(sm.ov_count) > 0  # outliers present
    rng = np.random.RandomState(cin)
    x = rng.randn(cap, cin).astype(np.float32)
    x[n:] = 0
    w = (rng.randn(K, cin, cout) / np.sqrt(K * cin)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            JF.sparse_conv_pallas(jnp.asarray(x), jnp.asarray(w), sm, sm, jnp.int32(n), jnp.int32(n))
        )[:n]
    got = gather_gemm_reference(
        torch.from_numpy(x[:n]), torch.from_numpy(w), torch.from_numpy(in_idx[:, :n])
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_gather_gemm_checks_inputs():
    x, w = torch.zeros(4, 3), torch.zeros(2, 3, 5)
    idx = torch.zeros(2, 6, dtype=torch.int32)
    assert gather_gemm(x, w, idx).shape == (6, 5)
    with pytest.raises(TypeError):
        gather_gemm(x.double(), w, idx)
    with pytest.raises(TypeError):
        gather_gemm(x, w, idx.long())
    with pytest.raises(ValueError):
        gather_gemm(x, w[:, :2], idx)
    with pytest.raises(ValueError):
        gather_gemm(x, w, idx[:1])
    before = gather_gemm.launches
    gather_gemm(x, w, idx)
    assert gather_gemm.launches == before  # CPU calls launch no kernel


def test_take_rows_gathers_zero_for_missing():
    f = torch.arange(6.0).reshape(3, 2) + 1
    out = TF.take_rows(f, torch.tensor([2, -1, 0, 3]))
    np.testing.assert_array_equal(out.numpy(), [[5, 6], [0, 0], [1, 2], [0, 0]])


@pytest.mark.parametrize("cout", [3, 32])
@pytest.mark.parametrize("cin", [3, 32])
@pytest.mark.parametrize("K", [8, 27, 125])
def test_dw_reference_matches_jax_vjp(K, cin, cout):
    n_in, n_out = 300, 260
    rng = np.random.RandomState(K * cin + cout)
    x = rng.randn(n_in, cin).astype(np.float32)
    w = (rng.randn(K, cin, cout) / np.sqrt(K * cin)).astype(np.float32)
    g = rng.randn(n_out, cout).astype(np.float32)
    idx = _matching(K, n_out, n_in, seed=K + 1)
    ji = jnp.asarray(idx)
    jt = jnp.asarray(_invert_matching(torch.from_numpy(idx), n_in).numpy())
    _, vjp = jax.vjp(lambda f, k: JF.sparse_conv(f, k, ji, jt), jnp.asarray(x), jnp.asarray(w))
    want = np.asarray(vjp(jnp.asarray(g))[1])
    got = conv_dw_reference(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(idx))
    assert got.shape == (K, cin, cout)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=GRAD_ATOL)
    # the public entry point takes the plain version for CPU tensors
    before = conv_dw.launches
    via = conv_dw(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(idx))
    np.testing.assert_array_equal(via.numpy(), got.numpy())
    assert conv_dw.launches == before


@pytest.mark.parametrize("cin,cout", [(3, 32), (32, 32)])
@pytest.mark.parametrize("K", [8, 27])
def test_dw_reference_matches_jax_pallas_interpret(K, cin, cout):
    cap, n = 1024, 700
    in_idx, sm = _slab_map(cap, K, n, seed=K + 7)
    assert sm.ov_src is not None and int(sm.ov_count) > 0  # outliers present
    rng = np.random.RandomState(cin + cout)
    x = rng.randn(cap, cin).astype(np.float32)
    g = rng.randn(cap, cout).astype(np.float32)
    x[n:], g[n:] = 0, 0
    jx, jg = jnp.asarray(x), jnp.asarray(g)
    with pltpu.force_tpu_interpret_mode():
        dw = sparse_conv_dw_pallas(jx, jg, sm, (K, cin, cout), n_valid_out=jnp.int32(n))
        want = np.asarray(JF._outlier_dw(dw, jx, jg, sm))
    got = conv_dw_reference(
        torch.from_numpy(x[:n]), torch.from_numpy(g[:n]), torch.from_numpy(in_idx[:, :n])
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=GRAD_ATOL)


def test_conv_dw_checks_inputs():
    x, g = torch.zeros(4, 3), torch.zeros(6, 5)
    idx = torch.zeros(2, 6, dtype=torch.int32)
    assert conv_dw(x, g, idx).shape == (2, 3, 5)
    with pytest.raises(TypeError):
        conv_dw(x.double(), g, idx)
    with pytest.raises(TypeError):
        conv_dw(x, g, idx.long())
    with pytest.raises(ValueError):
        conv_dw(x, g[:5], idx)
    with pytest.raises(ValueError):
        conv_dw(x, g, idx[0])


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("K", [8, 27, 125])
def test_sparse_conv_grads_match_jax_vjp(K, transposed):
    """dX through the inverse matching and dW, against JAX's hand-written
    VJP; ``transposed`` runs both on ``KernelMap.swap()``."""
    n_in, n_out, cin, cout = 300, 260, 16, 24
    in_idx = _matching(K, n_out, n_in, seed=K + 3)
    kmap = KernelMap(
        torch.from_numpy(in_idx), _invert_matching(torch.from_numpy(in_idx), n_in), n_in, n_out
    )
    if transposed:
        kmap = kmap.swap()
    rng = np.random.RandomState(K)
    x = rng.randn(kmap.n_in, cin).astype(np.float32)
    w = (rng.randn(K, cin, cout) / np.sqrt(K * cin)).astype(np.float32)
    g = rng.randn(kmap.n_out, cout).astype(np.float32)

    ji, jt = jnp.asarray(kmap.in_idx.numpy()), jnp.asarray(kmap.out_idx_t.numpy())
    want, vjp = jax.vjp(lambda f, k: JF.sparse_conv(f, k, ji, jt), jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = TF.sparse_conv_kmap(tx, tw, kmap)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), rtol=RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw), rtol=RTOL, atol=GRAD_ATOL)


def test_sparse_conv_input_grad_needs_the_inverse_map():
    x = torch.zeros(4, 3, requires_grad=True)
    with pytest.raises(ValueError):
        TF.sparse_conv(x, torch.zeros(2, 3, 5), torch.zeros(2, 6, dtype=torch.int32), None)


@pytest.mark.parametrize("transposed", [False, True])
def test_sparse_conv_gradcheck(transposed):
    """Finite differences in float64 (the CPU path takes it) agree with the
    hand-written backward, both directions of the map."""
    in_idx = torch.from_numpy(_matching(8, 20, 24, seed=5))
    kmap = KernelMap(in_idx, _invert_matching(in_idx, 24), 24, 20)
    if transposed:
        kmap = kmap.swap()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(kmap.n_in, 3, dtype=torch.float64, generator=gen).requires_grad_()
    w = torch.randn(8, 3, 4, dtype=torch.float64, generator=gen).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: TF.sparse_conv_kmap(a, b, kmap), (x, w))
