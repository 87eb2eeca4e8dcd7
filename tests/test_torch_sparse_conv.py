"""Port parity: the gather-GEMM's plain version equals the JAX sparse conv.

Held against both JAX forms of ``out[o] = Σ_k X[in_idx[k,o]] @ W[k]``:
``ops/functional.py::sparse_conv`` (the XLA path) and
``sparse_conv_pallas`` (the Pallas slab kernel plus its outlier correction),
the latter run in Pallas interpret mode on a map with outlier pairs.
Tolerance: f32, rtol 1e-5 (the sums run in another order), atol 1e-6 for
entries that cancel to near zero.  The CUDA kernel itself is held against
the same plain version on the card by ``chip_smoke.py``.
"""

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
    sub_ladder,
)
from minkowskiengine_tpu_torch.kernels.gather_gemm import (
    gather_gemm,
    gather_gemm_reference,
)
from minkowskiengine_tpu_torch.ops import functional as TF

RTOL, ATOL = 1e-5, 1e-6


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
    via_op = TF.sparse_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(idx))
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
