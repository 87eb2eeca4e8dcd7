"""Port parity for the rest of the SparseTensor API and ``nn/ops.py`` on the CPU.

``SparseTensor``'s properties, batch decomposition, ``dense`` and
``sparse`` export (the cases of JAX's ``tests/test_ops.py``); ``_sum``,
``mean``, ``var``, ``to_sparse`` in its formats, ``to_sparse_all``,
``dense_coordinates`` and the converter modules (JAX's
``tests/test_dense_roundtrip.py``); the ``MinkowskiStack*`` containers
(JAX's ``tests/test_stack.py``, with conv weights carried from JAX);
``MinkowskiNetwork``; and the one-line nonlinearity family.

Tolerance: coordinates, maps and exported layouts exact; features and
gradients within max|Δ|/max|ref| <= 1e-6 (elementwise ops and a few
short sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from torch import nn

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.nn.ops import dense_coordinates as jdense_coordinates
from minkowskiengine_tpu.nn.ops import to_sparse_all as jto_sparse_all
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.models import MinkowskiFCNN, MinkowskiPointNet

REL = 1e-6
NONLINEARITIES = [
    ("MinkowskiReLU6", {}), ("MinkowskiSELU", {}), ("MinkowskiCELU", {}),
    ("MinkowskiCELU", {"alpha": 0.5}), ("MinkowskiSiLU", {}), ("MinkowskiTanh", {}),
    ("MinkowskiSigmoid", {}), ("MinkowskiLogSigmoid", {}), ("MinkowskiSoftplus", {}),
    ("MinkowskiSoftsign", {}), ("MinkowskiHardsigmoid", {}), ("MinkowskiHardswish", {}),
]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _coords(n=60, batch=3, lo=-5, hi=5, seed=0, D=3):
    rng = np.random.RandomState(seed)
    c = np.concatenate([rng.randint(0, batch, (n, 1)), rng.randint(lo, hi, (n, D))], 1)
    return np.unique(c.astype(np.int32), axis=0)


def _pair(coords, ch=3, seed=0, **kw):
    feats = np.random.RandomState(seed).randn(len(coords), ch).astype(np.float32)
    return (ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords), **kw),
            MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords), **kw), feats)


def test_properties():
    _, tx, feats = _pair(_coords(), ch=4)
    assert tx.dimension == tx.D == 3 and tx.shape == (len(feats), 4) and len(tx) == len(feats)
    assert tx.dtype == torch.float32 and not tx.requires_grad
    f = torch.from_numpy(feats).requires_grad_()
    y = MT.SparseTensor(f, coordinate_map_key=tx.coordinate_map_key, coordinate_manager=tx.coordinate_manager)
    assert y.requires_grad and not y.detach().requires_grad
    assert y.detach().coordinate_map_key == y.coordinate_map_key


def test_decomposition_matches_jax():
    jx, tx, _ = _pair(_coords(n=80, batch=4, seed=1))
    jc, jf = jx.decomposed_coordinates_and_features
    tc, tf = tx.decomposed_coordinates_and_features
    assert len(tc) == len(tf) == len(jc) == 4
    for a, b in zip(tc + tf, jc + jf):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for b in range(4):
        np.testing.assert_array_equal(tx.coordinates_at(b).numpy(), np.asarray(jx.coordinates_at(b)))
        np.testing.assert_array_equal(tx.features_at(b).numpy(), np.asarray(jx.features_at(b)))
    assert tx.coordinates_at(7).shape == (0, 3)


@pytest.mark.parametrize("case", ["default", "min_coordinate", "shape", "stride2", "stride2-uncontracted"])
def test_dense_matches_jax(case):
    """``dense`` and its gradient; the (dense, min_coordinate,
    tensor_stride) triple as JAX returns it."""
    coords = _coords(seed=2)
    kw, call = {}, {}
    if case.startswith("stride2"):
        coords = np.unique(np.concatenate([coords[:, :1], coords[:, 1:] * 2], 1), axis=0)
        kw = dict(tensor_stride=2)
        call = dict(contract_stride=case == "stride2")
    elif case == "min_coordinate":
        call = dict(min_coordinate=np.array([-7, -6, -5], np.int32))
    elif case == "shape":
        call = dict(shape=(4, 3, 12, 12, 12))
    jx, tx, feats = _pair(coords, **kw)

    def jfun(f):
        x = ME.SparseTensor(f, coordinate_map_key=jx.coordinate_map_key, coordinate_manager=jx.coordinate_manager)
        return x.dense(**call)[0]

    want, vjp = jax.vjp(jfun, jnp.asarray(feats))
    _, jmin, jts = jx.dense(**call)
    f = torch.from_numpy(feats).requires_grad_()
    x = MT.SparseTensor(f, coordinate_map_key=tx.coordinate_map_key, coordinate_manager=tx.coordinate_manager)
    got, tmin, tts = x.dense(**call)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    assert tmin.dtype == torch.int32 and tts == tuple(jts)
    cot = np.random.RandomState(3).randn(*want.shape).astype(np.float32)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(f.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]))


def test_dense_round_trip_and_bad_min_coordinate():
    """dense → to_sparse gives back every (coordinate, feature) pair (JAX's
    ``tests/test_ops.py`` round trip); a min_coordinate above a coordinate
    raises, in both packages."""
    jx, tx, _ = _pair(_coords(n=40, batch=2, lo=0, hi=6, seed=13))
    back = MT.to_sparse(tx.dense()[0])
    np.testing.assert_array_equal(back.C.numpy(), tx.C.numpy())
    np.testing.assert_array_equal(back.F.numpy(), tx.F.numpy())
    for x in (jx, tx):
        with pytest.raises(ValueError, match="min_coordinate"):
            x.dense(min_coordinate=np.array([1, 1, 1], np.int32))


@pytest.mark.parametrize("case", ["window", "default", "stride2"])
def test_sparse_export_matches_jax(case):
    """The hybrid COO tensor (B, *spatial, ch) holds JAX's BCOO values."""
    call, kw = {}, {}
    if case == "window":  # JAX's test_sparse_export_honors_min_max
        coords = np.array([[0, 0, 0], [0, 1, 2], [0, 3, 3], [1, 2, 2]], np.int32)
        call = dict(min_coords=np.array([0, 0]), max_coords=np.array([3, 3]))
    elif case == "default":
        coords = _coords(seed=4, D=2)
    else:
        coords = np.unique(np.concatenate([_coords(seed=5, D=2)[:, :1], _coords(seed=5, D=2)[:, 1:] * 2], 1),
                           axis=0)
        kw = dict(tensor_stride=2)
        call = dict(min_coords=np.array([-10, -10]), max_coords=np.array([10, 10]))
    jx, tx, _ = _pair(coords, ch=2, **kw)
    jb, jmin, jts = jx.sparse(**call)
    tb, tmin, tts = tx.sparse(**call)
    assert tb.is_sparse and tb.shape == tuple(jb.shape) and tb.dense_dim() == 1
    np.testing.assert_array_equal(tb.to_dense().numpy(), np.asarray(jb.todense()))
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    assert tts == tuple(jts)
    if case == "window":
        assert tb.shape == (2, 4, 4, 2)


def test_sparse_export_checks_raise_like_jax():
    for pkg, arr in ((ME, jnp.asarray), (MT, torch.as_tensor)):
        x = pkg.SparseTensor(arr(np.ones((1, 1), np.float32)), arr(np.array([[0, 2, 2]], np.int32)),
                             tensor_stride=2)
        with pytest.raises(ValueError, match="divisible"):
            x.sparse(min_coords=np.array([1, 1]))
        with pytest.raises(ValueError, match="divisible"):
            x.sparse(max_coords=np.array([3, 4]))
        with pytest.raises(ValueError, match="elements"):
            x.sparse(min_coords=np.array([0, 0, 0]))


def test_sum_mean_var_match_jax():
    jx, tx, _ = _pair(_coords(seed=6))
    jy, ty = jx * 2.0, tx * 2.0
    jz, tz = jx + 1.0, tx + 1.0
    for name in ("_sum", "mean", "var"):
        want = getattr(ME, name)(jx, jy, jz)
        got = getattr(MT, name)([tx, ty, tz])  # a list, as the reference allows
        assert got.coordinate_map_key == tx.coordinate_map_key
        assert _rel(got.F, want.F) <= REL, name
    assert MT.sum is MT._sum
    mgr = tx.coordinate_manager
    key2 = mgr.stride(tx.coordinate_map_key, 2)
    coarse = MT.SparseTensor(torch.ones(mgr.size(key2), 3), coordinate_map_key=key2, coordinate_manager=mgr)
    with pytest.raises(ValueError, match="same coordinate_map_key"):
        MT.mean(tx, coarse)


@pytest.mark.parametrize("format", [None, "BCXX", "BXXC"])
def test_to_sparse_matches_jax(format):
    dense = np.random.RandomState(1).rand(3, 4, 5, 6).astype(np.float32)
    dense[dense < 0.3] = 0  # cells whose channels are all 0 drop out
    dense[:, :, 1, 2] = 0
    want = ME.to_sparse(dense, format=format)
    got = MT.to_sparse(torch.from_numpy(dense), format=format)
    np.testing.assert_array_equal(got.C.numpy(), np.asarray(want.C))
    np.testing.assert_array_equal(got.F.numpy(), np.asarray(want.F))


@pytest.mark.parametrize("shape,format", [((2, 3, 4, 4), "XBXC"), ((2, 3, 4, 4), "BXX"), ((2, 3), None)],
                         ids=["batch-not-first", "no-channel", "no-spatial"])
def test_to_sparse_bad_formats(shape, format):
    for to_sparse in (ME.to_sparse, MT.to_sparse):
        with pytest.raises(ValueError):
            to_sparse(np.zeros(shape, np.float32) if to_sparse is ME.to_sparse
                      else torch.zeros(shape), format=format)


def test_converter_modules_and_empty_round_trip():
    x = torch.zeros(4, 1, 34, 34)
    s = MT.MinkowskiToSparseTensor()(x)
    assert s.F.shape == (0, 1)
    d = MT.MinkowskiToDenseTensor(tuple(x.shape))(s)
    assert d.shape == x.shape and not d.any()
    full = MT.MinkowskiToSparseTensor(remove_zeros=False)(x)
    assert full.F.shape == (4 * 34 * 34, 1)
    np.testing.assert_array_equal(MT.dense_coordinates(x.shape, device="cpu").numpy(),
                                  np.asarray(jdense_coordinates(x.shape)))


def test_to_sparse_all_network_gradient_matches_jax():
    """dense → to_sparse_all (cached coordinates) → conv → sum of squares,
    differentiated in the dense input (JAX's test_to_sparse_all_network_grad)."""
    dense = np.random.RandomState(2).rand(2, 3, 7, 7).astype(np.float32)
    jconv = ME.MinkowskiConvolution(3, 4, kernel_size=3, dimension=2, rngs=nnx.Rngs(0))
    tconv = MT.MinkowskiConvolution(3, 4, kernel_size=3, dimension=2, device="cpu")
    with torch.no_grad():
        tconv.kernel.copy_(torch.from_numpy(np.asarray(jconv.kernel[...])))
    jcoords = jdense_coordinates(dense.shape)

    def jf(d):
        out = jconv(jto_sparse_all(d, coordinates=jcoords))
        return jnp.sum(out.F * out.F)

    want, want_grad = jax.value_and_grad(jf)(jnp.asarray(dense))
    d = torch.from_numpy(dense).requires_grad_()
    out = tconv(MT.to_sparse_all(d, coordinates=MT.dense_coordinates(dense.shape, device="cpu")))
    loss = (out.F * out.F).sum()
    loss.backward()
    assert abs(loss.item() - float(want)) <= REL * abs(float(want))
    assert _rel(d.grad, want_grad) <= REL


def _stack_pair(kind, seed):
    """The same stack in both packages: a k3 conv beside (k3 s2 conv,
    unpooling), and for ``nested`` JAX's test_stack_sum_nested layout."""
    rngs = nnx.Rngs(seed)
    jconvs = [ME.MinkowskiConvolution(3, 8, kernel_size=3, stride=s, dimension=3, rngs=rngs) for s in (1, 2)]
    tconvs = [MT.MinkowskiConvolution(3, 8, kernel_size=3, stride=s, dimension=3, device="cpu") for s in (1, 2)]
    if kind == "nested":
        jconvs += [ME.MinkowskiConvolution(8, 16, kernel_size=3, stride=2, dimension=3, rngs=rngs),
                   ME.MinkowskiConvolutionTranspose(16, 8, kernel_size=2, stride=2, dimension=3, rngs=rngs)]
        tconvs += [MT.MinkowskiConvolution(8, 16, kernel_size=3, stride=2, dimension=3, device="cpu"),
                   MT.MinkowskiConvolutionTranspose(16, 8, kernel_size=2, stride=2, dimension=3, device="cpu")]
    for j, t in zip(jconvs, tconvs):
        with torch.no_grad():
            t.kernel.copy_(torch.from_numpy(np.asarray(j.kernel[...])))
    junpool = ME.MinkowskiPoolingTranspose(kernel_size=2, stride=2, dimension=3)
    tunpool = MT.MinkowskiPoolingTranspose(kernel_size=2, stride=2, dimension=3)
    if kind == "nested":
        jinner = ME.MinkowskiStackSum(_JIdentity(), nnx.Sequential(jconvs[2], jconvs[3]))
        tinner = MT.MinkowskiStackSum(nn.Identity(), nn.Sequential(tconvs[2], tconvs[3]))
        return (ME.MinkowskiStackSum(jconvs[0], nnx.Sequential(jconvs[1], jinner, junpool)),
                MT.MinkowskiStackSum(tconvs[0], nn.Sequential(tconvs[1], tinner, tunpool)))
    name = f"MinkowskiStack{kind}"
    return (getattr(ME, name)(jconvs[0], nnx.Sequential(jconvs[1], junpool)),
            getattr(MT, name)(tconvs[0], nn.Sequential(tconvs[1], tunpool)))


class _JIdentity(nnx.Module):
    def __call__(self, x):
        return x


@pytest.mark.parametrize("kind", ["Cat", "Sum", "Mean", "Var", "nested"])
def test_stack_modules_match_jax(kind):
    """Branches at other strides rejoin the input's map and combine there."""
    coords = _coords(n=400, batch=2, lo=-20, hi=20, seed=8)
    jx, tx, _ = _pair(coords, seed=9)
    jstack, tstack = _stack_pair(kind, seed=10)
    want, got = jstack(jx), tstack(tx)
    assert isinstance(tstack, nn.Sequential)
    assert got.coordinate_map_key == tx.coordinate_map_key
    assert got.F.shape == (len(coords), 16 if kind == "Cat" else 8)
    assert _rel(got.F.detach(), want.F) <= REL


def test_stack_with_mixed_keys_raises():
    _, tx, _ = _pair(_coords(n=100, seed=11))
    conv = MT.MinkowskiConvolution(3, 3, kernel_size=3, stride=2, dimension=3, device="cpu")
    with pytest.raises(ValueError, match="same coordinate_map_key"):
        MT.MinkowskiStackSum(nn.Identity(), conv)(tx)


def test_minkowski_network():
    with pytest.raises(TypeError):
        MT.MinkowskiNetwork(3)

    class Net(MT.MinkowskiNetwork):
        def forward(self, x):
            return x

    assert Net(2).D == 2 and isinstance(Net(2), nn.Module)
    fcnn = MinkowskiFCNN(3, 4, embedding_channel=16, channels=(8,) * 5, device="cpu")
    pointnet = MinkowskiPointNet(3, 4, embedding_channel=16, device="cpu")
    for net in (fcnn, pointnet):
        assert isinstance(net, MT.MinkowskiNetwork) and isinstance(net, MT.MinkowskiModuleBase)
        assert net.D == 3
    assert "mlp1.0.linear.weight" in fcnn.state_dict() and "D" not in fcnn.state_dict()


@pytest.mark.parametrize("name,kwargs", NONLINEARITIES,
                         ids=[n + ("-" + "-".join(map(str, k.values())) if k else "") for n, k in NONLINEARITIES])
def test_nonlinearities_match_jax(name, kwargs):
    """Forward and gradient, on features spread over each function's
    bends (|x| up to ~9: hard sigmoid's ±3, ReLU6's 6)."""
    jx, tx, feats = _pair(_coords(seed=12), ch=5)
    feats = feats * 3.0
    cot = np.random.RandomState(13).randn(*feats.shape).astype(np.float32)

    def jfun(f):
        x = ME.SparseTensor(f, coordinate_map_key=jx.coordinate_map_key, coordinate_manager=jx.coordinate_manager)
        return getattr(ME, name)(**kwargs)(x).F

    want, vjp = jax.vjp(jfun, jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_()
    out = getattr(MT, name)(**kwargs)(tx._wrap(f))
    assert out.coordinate_map_key == tx.coordinate_map_key
    assert _rel(out.F.detach(), want) <= REL
    out.F.backward(torch.from_numpy(cot))
    assert _rel(f.grad, vjp(jnp.asarray(cot))[0]) <= REL
