"""Port parity for pooling: local, transposed and global pooling equal JAX's.

The same sparse tensor (two batch items, negative coordinates) goes
through each package's pooling module; outputs, input gradients and the
pooling kernel maps are compared.  ``tied`` inputs take three values only,
so most max-pooling windows hold ties: the port must send the whole
gradient to JAX's argmax (the first maximum in slot order) in local max
pooling, and split it evenly, as JAX's ``.at[].max`` does, in global max
pooling.

Tolerance: maps, max-pooling outputs and their gradients are bit-equal
(selection and routing, no arithmetic).  Sums and means: rtol 1e-6, the
rounding of f32 sums of at most 27 rows taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minkowskiengine_tpu as ME
import minkowskiengine_tpu_torch as MT

RTOL = ATOL = 1e-6


def _cloud(seed=0, n=1000, span=6):
    rng = np.random.RandomState(seed)
    coords = np.concatenate(
        [rng.randint(0, 2, (n, 1)), rng.randint(-span, span, (n, 3))], 1
    ).astype(np.int32)
    return np.unique(coords, axis=0)


def _feats(n, tied, seed=1, ch=4):
    rng = np.random.RandomState(seed)
    if tied:
        return rng.randint(0, 3, (n, ch)).astype(np.float32)
    return rng.randn(n, ch).astype(np.float32)


class _Both:
    """A sparse tensor in both packages, on the same coordinates."""

    def __init__(self, coords, feats):
        self.feats = feats
        self.jx = ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords))
        self.tx = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords))

    def run(self, jmod, tmod, grad_seed=2):
        """Outputs and input gradients of both modules for one cotangent."""
        jx, tx = self.jx, self.tx

        def f(feats):
            x = ME.SparseTensor(
                feats, coordinate_map_key=jx.coordinate_map_key,
                coordinate_manager=jx.coordinate_manager,
            )
            return jmod(x).F

        want, vjp = jax.vjp(f, jnp.asarray(self.feats))
        g = np.random.RandomState(grad_seed).randn(*want.shape).astype(np.float32)
        (want_grad,) = vjp(jnp.asarray(g))
        feats = torch.from_numpy(self.feats).requires_grad_()
        out = tmod(MT.SparseTensor(
            feats, coordinate_map_key=tx.coordinate_map_key,
            coordinate_manager=tx.coordinate_manager,
        ))
        out.F.backward(torch.from_numpy(g))
        return out, np.asarray(want), feats.grad.numpy(), np.asarray(want_grad)


LOCAL = {
    "avg": (ME.MinkowskiAvgPooling, MT.MinkowskiAvgPooling),
    "sum": (ME.MinkowskiSumPooling, MT.MinkowskiSumPooling),
    "max": (ME.MinkowskiMaxPooling, MT.MinkowskiMaxPooling),
}


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("ks", [(3, 2), (2, 2)], ids=["general_k3s2", "fast_path_k2s2"])
@pytest.mark.parametrize("mode", sorted(LOCAL))
def test_local_pooling_matches_jax(mode, ks, tied):
    coords = _cloud()
    both = _Both(coords, _feats(len(coords), tied))
    kernel_size, stride = ks
    jcls, tcls = LOCAL[mode]
    jmod = jcls(kernel_size=kernel_size, stride=stride, dimension=3)
    tmod = tcls(kernel_size=kernel_size, stride=stride, dimension=3)
    out, want, grad, want_grad = both.run(jmod, tmod)

    # the pooling map, slot order included
    jkey, jkmap = jmod._out_key_and_kmap(both.jx, None)
    tkey, tkmap = tmod._out_key_and_kmap(both.tx, None)
    assert tkey.get_key() == jkey.get_key()
    n_out = out.size
    np.testing.assert_array_equal(tkmap.in_idx.numpy(), np.asarray(jkmap.in_idx)[:, :n_out])
    np.testing.assert_array_equal(
        tkmap.out_idx_t.numpy(), np.asarray(jkmap.out_idx_t)[:, : both.tx.size]
    )
    if ks == (2, 2):
        assert tkmap.kernel_volume <= 8  # collision slots, not 27 offsets
    np.testing.assert_array_equal(out.C.numpy(), np.asarray(ME.SparseTensor(
        jnp.asarray(want), coordinate_map_key=jkey,
        coordinate_manager=both.jx.coordinate_manager).C))
    if mode == "max":
        np.testing.assert_array_equal(out.F.detach().numpy(), want)
        np.testing.assert_array_equal(grad, want_grad)
        if tied:  # the windows do hold ties
            idx = tkmap.in_idx.long()
            vals = np.where((idx >= 0)[..., None], both.feats[idx.clamp_min(0)], -np.inf)
            assert ((vals == vals.max(0)).sum(0) > 1).sum() > n_out // 4
    else:
        np.testing.assert_allclose(out.F.detach().numpy(), want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(grad, want_grad, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ks", [(2, 2), (3, 2)], ids=["fast_path_k2s2", "general_k3s2"])
@pytest.mark.parametrize("cached", [True, False], ids=["after_pool", "fresh"])
def test_pooling_transpose_matches_jax(ks, cached):
    """Unpooling back onto the stride-1 map: through the swapped pooling map
    when the forward pooling is cached, else built anew."""
    coords = _cloud(seed=3)
    kernel_size, stride = ks
    fine = _Both(coords, _feats(len(coords), False))
    if cached:
        jc = ME.MinkowskiAvgPooling(kernel_size=kernel_size, stride=stride, dimension=3)(fine.jx)
        tc = MT.MinkowskiAvgPooling(kernel_size=kernel_size, stride=stride, dimension=3)(fine.tx)
        jkey, tkey = jc.coordinate_map_key, tc.coordinate_map_key
    else:
        jkey = fine.jx.coordinate_manager.stride(fine.jx.coordinate_map_key, stride)
        tkey = fine.tx.coordinate_manager.stride(fine.tx.coordinate_map_key, stride)
    n = fine.tx.coordinate_manager.size(tkey)
    coarse = _Both.__new__(_Both)
    coarse.feats = _feats(n, False, seed=4)
    coarse.jx = ME.SparseTensor(jnp.asarray(coarse.feats), coordinate_map_key=jkey,
                                coordinate_manager=fine.jx.coordinate_manager)
    coarse.tx = MT.SparseTensor(torch.from_numpy(coarse.feats), coordinate_map_key=tkey,
                                coordinate_manager=fine.tx.coordinate_manager)
    jmod = ME.MinkowskiPoolingTranspose(kernel_size=kernel_size, stride=stride, dimension=3)
    tmod = MT.MinkowskiPoolingTranspose(kernel_size=kernel_size, stride=stride, dimension=3)
    out, want, grad, want_grad = coarse.run(jmod, tmod)
    assert out.coordinate_map_key == fine.tx.coordinate_map_key
    np.testing.assert_allclose(out.F.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad, want_grad, rtol=RTOL, atol=ATOL)


GLOBAL = {
    "sum": (ME.MinkowskiGlobalSumPooling, MT.MinkowskiGlobalSumPooling),
    "avg": (ME.MinkowskiGlobalAvgPooling, MT.MinkowskiGlobalAvgPooling),
    "max": (ME.MinkowskiGlobalMaxPooling, MT.MinkowskiGlobalMaxPooling),
}


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("mode", sorted(GLOBAL))
def test_global_pooling_on_a_sparse_tensor_matches_jax(mode, tied):
    coords = _cloud(seed=5)
    both = _Both(coords, _feats(len(coords), tied))
    jcls, tcls = GLOBAL[mode]
    out, want, grad, want_grad = both.run(jcls(), tcls())
    assert out.F.shape == (2, 4)
    np.testing.assert_array_equal(out.C.numpy(), [[0, 0, 0, 0], [1, 0, 0, 0]])
    np.testing.assert_allclose(out.F.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad, want_grad, rtol=RTOL, atol=ATOL)
    if mode == "max" and tied:  # ties share the gradient, as in JAX
        assert np.any((grad != 0) & (np.abs(grad) < np.abs(grad).max() / 1.5))


@pytest.mark.parametrize("mode", sorted(GLOBAL))
def test_global_pooling_on_a_tensor_field_matches_jax(mode):
    rng = np.random.RandomState(6)
    n = 300
    coords = np.concatenate(
        [rng.randint(0, 3, (n, 1)), rng.uniform(-4, 4, (n, 3))], 1
    ).astype(np.float32)
    feats = rng.randint(0, 3, (n, 5)).astype(np.float32)
    g = rng.randn(3, 5).astype(np.float32)
    jcls, tcls = GLOBAL[mode]

    def f(fe):
        return jcls()(ME.TensorField(fe, jnp.asarray(coords))).F

    want, vjp = jax.vjp(f, jnp.asarray(feats))
    (want_grad,) = vjp(jnp.asarray(g))
    tf = torch.from_numpy(feats).requires_grad_()
    out = tcls()(MT.TensorField(tf, torch.from_numpy(coords)))
    out.F.backward(torch.from_numpy(g))
    assert out.F.shape == (3, 5)
    np.testing.assert_allclose(out.F.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=ATOL)


def test_functional_shims_match_jax():
    """The reference-style functional entry points: local pooling (three
    modes), transposed pooling, global pooling and direct max pooling."""
    from minkowskiengine_tpu.nn import pooling as JP
    from minkowskiengine_tpu.types import PoolingMode as JMode
    from minkowskiengine_tpu_torch.nn import pooling as TP

    coords = _cloud(seed=7)
    both = _Both(coords, _feats(len(coords), False))
    jm, tm = both.jx.coordinate_manager, both.tx.coordinate_manager
    jin, tin = both.jx.coordinate_map_key, both.tx.coordinate_map_key
    jout, tout = jm.stride(jin, 2), tm.stride(tin, 2)
    jkg = ME.KernelGenerator(kernel_size=3, stride=2, dimension=3)
    tkg = MT.KernelGenerator(kernel_size=3, stride=2, dimension=3)
    jf, tf = jnp.asarray(both.feats), torch.from_numpy(both.feats)
    n_out = tm.size(tout)
    for mode in ("LOCAL_AVG_POOLING", "LOCAL_SUM_POOLING", "LOCAL_MAX_POOLING"):
        want = JP.MinkowskiLocalPoolingFunction.apply(jf, JMode[mode], jkg, jin, jout, jm)
        got = TP.MinkowskiLocalPoolingFunction.apply(tf, MT.PoolingMode[mode], tkg, tin, tout, tm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:n_out], rtol=RTOL, atol=ATOL)
    coarse = np.random.RandomState(8).randn(n_out, 4).astype(np.float32)
    want = JP.MinkowskiLocalPoolingTransposeFunction.apply(
        jnp.asarray(coarse), JMode.LOCAL_AVG_POOLING, jkg, jout, jin, jm
    )
    got = TP.MinkowskiLocalPoolingTransposeFunction.apply(
        torch.from_numpy(coarse), MT.PoolingMode.LOCAL_AVG_POOLING, tkg, tout, tin, tm
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[: both.tx.size], rtol=RTOL, atol=ATOL)
    # JAX's global pooling reads rows up to the map's capacity
    jpad = jnp.pad(jf, ((0, jm.capacity(jin) - both.tx.size), (0, 0)))
    for mode in ("GLOBAL_SUM_POOLING_DEFAULT", "GLOBAL_MAX_POOLING_KERNEL",
                 "GLOBAL_AVG_POOLING_PYTORCH_INDEX"):
        want = JP.MinkowskiGlobalPoolingFunction.apply(jpad, JMode[mode], jin, None, jm)
        got = TP.MinkowskiGlobalPoolingFunction.apply(tf, MT.PoolingMode[mode], tin, None, tm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:2], rtol=RTOL, atol=ATOL)
    in_map = np.array([0, 3, 5, 2, -1, 7], np.int32)
    out_map = np.array([0, 0, 1, 1, 1, 2], np.int32)
    want = JP.MinkowskiDirectMaxPoolingFunction.apply(in_map, out_map, jf, 3)
    got = TP.MinkowskiDirectMaxPoolingFunction.apply(
        torch.from_numpy(in_map), torch.from_numpy(out_map), tf, 3
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_global_max_avg_pool_and_batch_count_match_jax():
    from minkowskiengine_tpu.models.classification import GlobalMaxAvgPool as JPool
    from minkowskiengine_tpu_torch.models import GlobalMaxAvgPool as TPool

    coords = _cloud(seed=9)
    both = _Both(coords, _feats(len(coords), False))
    out, want, grad, want_grad = both.run(JPool(), TPool())
    assert out.F.shape == (2, 8)
    np.testing.assert_allclose(out.F.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad, want_grad, rtol=RTOL, atol=ATOL)
    tm, tkey = both.tx.coordinate_manager, both.tx.coordinate_map_key
    jm, jkey = both.jx.coordinate_manager, both.jx.coordinate_map_key
    assert tm.number_of_unique_batch_indices(tkey) == jm.number_of_unique_batch_indices(jkey) == 2
    assert torch.equal(MT.MinkowskiToFeature()(both.tx), both.tx.F)
