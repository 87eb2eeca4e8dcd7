"""Port parity for the layers around the kernel: convolution modules,
batch norm, ReLU, ``cat`` and SparseTensor arithmetic, against the JAX
package on a room-scan cloud with copied weights.

Tolerance: f32, rtol 1e-5 / atol 1e-6 per conv layer (sums in another
order), rtol 1e-4 / atol 1e-5 through a conv + BN stack.  Gradients: rtol
1e-5 / atol 1e-4; a kernel gradient sums ~1.4k products of unit-variance
values, so its entries reach ~40 and another summation order moves them by
~40 · 2^-24 · sqrt(1400) ≈ 1e-4 at most.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import minkowskiengine_tpu as ME
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.utils.datasets import room_scan_voxels


@pytest.fixture(scope="module")
def cloud():
    coords, _ = room_scan_voxels(
        voxel_size=0.2, n_points=120_000, extent=(2.0, 2.0, 2.2), n_objects=4, seed=1
    )
    feats = np.random.RandomState(0).randn(len(coords), 8).astype(np.float32)
    return coords, feats


def _pair(cls_j, cls_t, cin, cout, seed, **kw):
    j = cls_j(cin, cout, dimension=3, rngs=nnx.Rngs(seed), **kw)
    t = cls_t(cin, cout, dimension=3, device="cpu", **kw)
    with torch.no_grad():
        t.kernel.copy_(torch.tensor(np.asarray(j.kernel[...])))
        if kw.get("bias"):
            t.bias.copy_(torch.tensor(np.asarray(j.bias[...])))
    return j, t


def _inputs(cloud):
    coords, feats = cloud
    jx = ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords))
    tx = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords))
    return jx, tx


def _same(jy, ty, rtol=1e-5, atol=1e-6):
    assert ty.tensor_stride == tuple(jy.tensor_stride)
    np.testing.assert_array_equal(ty.C.numpy(), np.asarray(jy.C))
    np.testing.assert_allclose(ty.F.detach().numpy(), np.asarray(jy.F), rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "k,s,bias", [(3, 1, False), (5, 1, True), (2, 2, False), (3, 2, True), (1, 1, True)]
)
def test_convolution_matches_jax(cloud, k, s, bias):
    j, t = _pair(ME.MinkowskiConvolution, MT.MinkowskiConvolution, 8, 16, seed=k + s,
                 kernel_size=k, stride=s, bias=bias)
    assert t.use_mm == (k == 1 and s == 1)
    jx, tx = _inputs(cloud)
    with torch.no_grad():
        _same(j(jx), t(tx))


@pytest.mark.parametrize("bias", [False, True])
def test_transposed_convolution_returns_to_encoder_map(cloud, bias):
    jd, td = _pair(ME.MinkowskiConvolution, MT.MinkowskiConvolution, 8, 8, seed=1,
                   kernel_size=2, stride=2)
    ju, tu = _pair(ME.MinkowskiConvolutionTranspose, MT.MinkowskiConvolutionTranspose,
                   8, 16, seed=2, kernel_size=2, stride=2, bias=bias)
    jx, tx = _inputs(cloud)
    with torch.no_grad():
        jy, ty = ju(jd(jx)), tu(td(tx))
    _same(jy, ty)
    assert ty.coordinate_map_key == tx.coordinate_map_key  # back on the input map


def test_convolution_to_explicit_coordinates(cloud):
    j, t = _pair(ME.MinkowskiConvolution, MT.MinkowskiConvolution, 8, 4, seed=5, kernel_size=3)
    jx, tx = _inputs(cloud)
    target = cloud[0][::3]
    with torch.no_grad():
        _same(j(jx, jnp.asarray(target)), t(tx, torch.from_numpy(target)))


@pytest.mark.parametrize("training", [False, True])
def test_batchnorm_relu_cat_match_jax(cloud, training):
    jx, tx = _inputs(cloud)
    jbn, tbn = ME.MinkowskiBatchNorm(8), MT.MinkowskiBatchNorm(8, device="cpu")
    rng = np.random.RandomState(3)
    w, b = rng.rand(8).astype(np.float32) + 0.5, rng.randn(8).astype(np.float32)
    mu, var = rng.randn(8).astype(np.float32), rng.rand(8).astype(np.float32) + 0.5
    jbn.weight[...], jbn.bias[...] = jnp.asarray(w[None]), jnp.asarray(b[None])
    jbn.running_mean[...], jbn.running_var[...] = jnp.asarray(mu), jnp.asarray(var)
    with torch.no_grad():
        for name, v in (("weight", w), ("bias", b), ("running_mean", mu), ("running_var", var)):
            getattr(tbn.bn, name).copy_(torch.from_numpy(v))
    jbn.train(training)
    tbn.train(training)
    jy = ME.MinkowskiReLU()(jbn(jx))
    with torch.no_grad():
        ty = MT.MinkowskiReLU()(tbn(tx))
    _same(jy, ty, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        tbn.bn.running_var.numpy(), np.asarray(jbn.running_var[...]), rtol=1e-5
    )
    _same(ME.cat(jy, jx), MT.cat(ty, tx), rtol=1e-4, atol=1e-5)
    _same(jy + jx, ty + tx, rtol=1e-4, atol=1e-5)


def test_mixed_coordinates_are_refused(cloud):
    _, tx = _inputs(cloud)
    down = MT.MinkowskiConvolution(8, 8, kernel_size=2, stride=2, dimension=3, device="cpu")
    with torch.no_grad():
        ty = down(tx)
    with pytest.raises(ValueError):
        MT.cat(tx, ty)
    with pytest.raises(ValueError, match="identical tensor strides"):  # a union needs one stride
        tx + ty
    _, other = _inputs(cloud)  # same key value, another manager
    with pytest.raises(ValueError):
        tx + other


def test_shared_manager_mode(cloud):
    coords, feats = cloud
    MT.set_sparse_tensor_operation_mode(MT.SparseTensorOperationMode.SHARE_COORDINATE_MANAGER)
    try:
        a = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords))
        b = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords[::-1].copy()))
        assert a.coordinate_manager is b.coordinate_manager is MT.global_coordinate_manager()
        assert a.coordinate_map_key != b.coordinate_map_key  # second insert: a new id
    finally:
        MT.set_sparse_tensor_operation_mode(
            MT.SparseTensorOperationMode.SEPARATE_COORDINATE_MANAGER
        )
        MT.clear_global_coordinate_manager()


@pytest.mark.parametrize(
    "case", ["k3s1", "k2s2", "k1_bias", "transpose_k2s2"]
)
def test_gradients_match_jax(cloud, case):
    """Input, kernel and bias gradients of conv modules, against the JAX
    modules' with the same weights, by the reference parameter names."""
    coords, feats = cloud
    if case == "transpose_k2s2":
        pairs = [
            _pair(ME.MinkowskiConvolution, MT.MinkowskiConvolution, 8, 8, seed=1,
                  kernel_size=2, stride=2),
            _pair(ME.MinkowskiConvolutionTranspose, MT.MinkowskiConvolutionTranspose,
                  8, 16, seed=2, kernel_size=2, stride=2, bias=True),
        ]
    else:
        k, s, bias = {"k3s1": (3, 1, False), "k2s2": (2, 2, False), "k1_bias": (1, 1, True)}[case]
        pairs = [_pair(ME.MinkowskiConvolution, MT.MinkowskiConvolution, 8, 16, seed=k + s,
                       kernel_size=k, stride=s, bias=bias)]
    jmods = tuple(j for j, _ in pairs)
    tmods = [t for _, t in pairs]

    tf = torch.from_numpy(feats).requires_grad_()
    ty = MT.SparseTensor(tf, torch.from_numpy(coords))
    for m in tmods:
        ty = m(ty)
    cot = np.random.RandomState(7).randn(*ty.F.shape).astype(np.float32)
    (ty.F * torch.from_numpy(cot)).sum().backward()

    def loss(mods, f):
        y = ME.SparseTensor(f, jnp.asarray(coords))
        for m in mods:
            y = m(y)
        return jnp.sum(y.F * jnp.asarray(cot))

    jgrads, jgf = nnx.grad(loss, argnums=(0, 1))(jmods, jnp.asarray(feats))
    tol = dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jgf), **tol)
    for t, jg in zip(tmods, jgrads):
        names = dict(t.named_parameters())
        assert set(names) == set(jg.keys())
        for name, p in names.items():
            assert p.grad is not None and p.grad.shape == p.shape
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[name][...]), **tol)
