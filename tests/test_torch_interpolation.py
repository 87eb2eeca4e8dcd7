"""Port parity for interpolation: ``interpolation_map_weight``,
``interpolate_features``, ``SparseTensor.features_at_coordinates`` and
``interpolate``, and ``MinkowskiInterpolation`` equal JAX's on the CPU.

Maps are lattices at tensor stride 1 or 2 with about 30% of the points
missing, at D = 2, 3 and 4.  The sample cases are those of JAX's
``tests/test_interpolation_stress.py``: random samples, negative and mixed
coordinates (floor, not truncation), exact corner hits, samples outside
the map, and duplicated samples.

Tolerance: corner rows bit-equal, weights within 1e-7 absolute (the same
float32 operations in the same order; only the product of the D factors
may round in another order).  Features and their gradients within
max|Δ|/max|ref| <= 1e-6: sums of 2^D products.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.ops import functional as JF
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.ops import functional as F

W_ATOL = 1e-7
REL = 1e-6
CASES = ["random", "negative", "corners", "outside", "duplicates"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _lattice(D, stride, seed, keep=0.7, lo=-3, hi=3):
    """Two batch items of a [lo, hi)^D lattice at ``stride``, thinned."""
    rng = np.random.RandomState(seed)
    lat = np.array(list(itertools.product(range(2), *[range(lo, hi)] * D)), np.int32)
    lat = lat[rng.rand(len(lat)) < keep]
    lat[:, 1:] *= stride
    return lat


def _samples(case, D, stride, lattice, seed, n=64):
    rng = np.random.RandomState(seed)
    batch = rng.randint(0, 2, (n, 1)).astype(np.float32)
    if case == "random":
        xyz = rng.uniform(-3 * stride, 3 * stride, (n, D))
    elif case == "negative":  # negative and mixed signs, with fractions like -0.5
        xyz = rng.uniform(-3 * stride, 0.5 * stride, (n, D))
        xyz[:8] = -0.5 * stride
    elif case == "corners":  # the map's own points, and lattice points it lacks
        missing = np.array(list(itertools.product(range(2), *[range(-3, 3)] * D)), np.float32)
        missing[:, 1:] *= stride
        pts = np.concatenate([lattice.astype(np.float32), missing[:n]])
        return pts[rng.permutation(len(pts))[:n]]
    elif case == "outside":  # beyond the lattice, or in a batch item it lacks
        xyz = rng.uniform(10 * stride, 100 * stride, (n, D)) * rng.choice([-1, 1], (n, D))
        batch[: n // 4] = 5
        xyz[: n // 4] = rng.uniform(-2 * stride, 2 * stride, (n // 4, D))
    else:  # one sample, repeated
        xyz = np.repeat(rng.uniform(-3 * stride, 3 * stride, (1, D)), n, axis=0)
        batch[:] = 1
    return np.concatenate([batch, xyz.astype(np.float32)], axis=1)


def _maps(coords, stride, D, ch=3, seed=0):
    """The same map in both packages, with the same features in map order."""
    jmgr = ME.CoordinateManager(D=D)
    jkey, _ = jmgr.insert_and_map(jnp.asarray(coords), stride)
    tmgr = MT.CoordinateManager(D=D, device="cpu")
    tkey, _ = tmgr.insert_and_map(torch.from_numpy(coords), stride)
    np.testing.assert_array_equal(tmgr.get_coordinates(tkey).numpy(), np.asarray(jmgr.get_coordinates(jkey)))
    feats = np.random.RandomState(seed).randn(tmgr.size(tkey), ch).astype(np.float32)
    jx = ME.SparseTensor(jnp.asarray(feats), coordinate_map_key=jkey, coordinate_manager=jmgr)
    tx = MT.SparseTensor(torch.from_numpy(feats), coordinate_map_key=tkey, coordinate_manager=tmgr)
    return jx, tx, feats


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("D", [2, 3, 4])
def test_interpolation_map_weight_matches_jax(D, stride, case):
    lattice = _lattice(D, stride, seed=D)
    samples = _samples(case, D, stride, lattice, seed=10 * D + stride)
    jx, tx, _ = _maps(lattice, stride, D)
    jrows, jw = jx.coordinate_manager.interpolation_map_weight(jx.coordinate_map_key, jnp.asarray(samples))
    trows, tw = tx.coordinate_manager.interpolation_map_weight(tx.coordinate_map_key, torch.from_numpy(samples))
    assert trows.dtype == torch.int32 and tw.dtype == torch.float32
    assert trows.shape == tw.shape == (len(samples), 2**D)
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=W_ATOL)
    assert (tw[trows < 0] == 0).all()
    if case == "outside":
        assert (trows[: len(samples) // 4] == -1).all()
    if case == "duplicates":
        assert (trows == trows[0]).all() and (tw == tw[0]).all()
    if case == "corners":  # a hit takes weight 1 on its own row, 0 elsewhere
        hit = (tw == 1).any(1)
        assert hit.any() and ((tw[hit] == 1).sum(1) == 1).all()


@pytest.mark.parametrize("D", [2, 3, 4])
def test_interpolate_features_and_gradient_match_jax(D):
    lattice = _lattice(D, 1, seed=20 + D)
    samples = _samples("random", D, 1, lattice, seed=D)
    jx, tx, feats = _maps(lattice, 1, D, ch=5)
    rows, w = tx.coordinate_manager.interpolation_map_weight(tx.coordinate_map_key, torch.from_numpy(samples))
    g = np.random.RandomState(1).randn(len(samples), 5).astype(np.float32)
    want, vjp = jax.vjp(
        lambda f: JF.interpolate_features(f, jnp.asarray(rows.numpy()), jnp.asarray(w.numpy())),
        jnp.asarray(feats),
    )
    (want_grad,) = vjp(jnp.asarray(g))
    f = torch.from_numpy(feats).requires_grad_()
    got = F.interpolate_features(f, rows, w)
    got.backward(torch.from_numpy(g))
    assert _rel(got.detach(), want) <= REL
    assert _rel(f.grad, want_grad) <= REL


def test_features_at_coordinates_and_interpolate_match_jax():
    """On a field's points, with a gradient to the sparse features and none
    to the coordinates."""
    lattice = _lattice(3, 2, seed=30)
    samples = _samples("negative", 3, 2, lattice, seed=31)
    jx, tx, feats = _maps(lattice, 2, 3, ch=4)
    jtf = ME.TensorField(jnp.ones((len(samples), 1)), jnp.asarray(samples),
                         coordinate_manager=jx.coordinate_manager)
    q = torch.from_numpy(samples).requires_grad_()
    ttf = MT.TensorField(torch.ones(len(samples), 1), q.detach(), coordinate_manager=tx.coordinate_manager)
    want = np.asarray(jx.features_at_coordinates(jnp.asarray(samples)))
    np.testing.assert_allclose(np.asarray(jx.interpolate(jtf))[: len(samples)], want, rtol=0, atol=0)
    f = torch.from_numpy(feats).requires_grad_()
    tx = MT.SparseTensor(f, coordinate_map_key=tx.coordinate_map_key, coordinate_manager=tx.coordinate_manager)
    got = tx.features_at_coordinates(q)
    assert _rel(got.detach(), want) <= REL
    torch.testing.assert_close(tx.interpolate(ttf), got, rtol=0, atol=0)
    got.sum().backward()
    assert q.grad is None and f.grad is not None
    with pytest.raises(TypeError):
        tx.interpolate(tx)


@pytest.mark.parametrize("return_kernel_map", [False, True])
@pytest.mark.parametrize("return_weights", [False, True])
def test_interpolation_module_matches_jax(return_kernel_map, return_weights):
    """The module's outputs, the (in_map, out_map) pair with its -1 rows,
    the weights, and the feature gradient against JAX's VJP."""
    lattice = _lattice(3, 1, seed=40)
    samples = _samples("random", 3, 1, lattice, seed=41)
    jx, tx, feats = _maps(lattice, 1, 3, ch=3)
    kw = dict(return_kernel_map=return_kernel_map, return_weights=return_weights)
    g = np.random.RandomState(2).randn(len(samples), 3).astype(np.float32)

    def jfun(fe):
        x = ME.SparseTensor(fe, coordinate_map_key=jx.coordinate_map_key,
                            coordinate_manager=jx.coordinate_manager)
        out = ME.MinkowskiInterpolation(**kw)(x, jnp.asarray(samples))
        return out if isinstance(out, tuple) else (out,)

    want, vjp = jax.vjp(lambda fe: jfun(fe)[0], jnp.asarray(feats))
    (want_grad,) = vjp(jnp.asarray(g))
    jall = jfun(jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_()
    x = MT.SparseTensor(f, coordinate_map_key=tx.coordinate_map_key, coordinate_manager=tx.coordinate_manager)
    out = MT.MinkowskiInterpolation(**kw)(x, torch.from_numpy(samples))
    tall = out if isinstance(out, tuple) else (out,)
    assert len(tall) == len(jall) == 1 + return_kernel_map + return_weights
    assert _rel(tall[0].detach(), want) <= REL
    if return_kernel_map:
        (tin, tout), (jin, jout) = tall[1], jall[1]
        np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        assert (tin == -1).any()  # the missing corners are kept, as in JAX
    if return_weights:
        np.testing.assert_allclose(tall[-1].numpy(), np.asarray(jall[-1]), rtol=0, atol=W_ATOL)
    tall[0].backward(torch.from_numpy(g))
    assert _rel(f.grad, want_grad) <= REL


def test_interpolation_function_matches_the_module():
    lattice = _lattice(2, 1, seed=50)
    samples = _samples("random", 2, 1, lattice, seed=51)
    _, tx, _ = _maps(lattice, 1, 2)
    out, in_map, out_map, w = MT.MinkowskiInterpolationFunction.apply(
        tx.F, torch.from_numpy(samples), tx.coordinate_map_key, tx.coordinate_manager
    )
    mod, (m_in, m_out), m_w = MT.MinkowskiInterpolation(True, True)(tx, samples)
    for a, b in ((out, mod), (in_map, m_in), (out_map, m_out), (w, m_w)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert out_map.tolist() == [i for i in range(len(samples)) for _ in range(4)]


def test_interpolation_gradcheck_float64():
    """float64 numerical gradient of the interpolation in the features, as
    JAX's ``tests/test_ops.py`` checks its own."""
    lattice = _lattice(2, 1, seed=60)
    samples = _samples("random", 2, 1, lattice, seed=61, n=20)
    _, tx, _ = _maps(lattice, 1, 2)
    rows, w = tx.coordinate_manager.interpolation_map_weight(tx.coordinate_map_key, samples)
    f = torch.randn(tx.size, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    assert torch.autograd.gradcheck(
        lambda x: F.interpolate_features(x, rows, w), (f.requires_grad_(),), atol=1e-6, rtol=1e-6
    )


def test_overflowing_samples_find_no_row():
    """A corner beyond the packed-key range is absent, not a wrapped key."""
    mgr = MT.CoordinateManager(D=3, device="cpu")
    key, _ = mgr.insert_and_map(torch.tensor([[0, 0, 0, 0], [0, 32767, 0, 0]], dtype=torch.int32))
    rows, w = mgr.interpolation_map_weight(key, torch.tensor([[0, 32767.5, 0.0, 0.0]]))
    assert rows[0, 0] == 1 and (rows[0, 1:] == -1).all()
    assert w[0, 0] == 0.5 and (w[0, 1:] == 0).all()
