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
            t.kernel.copy_(torch.from_numpy(np.array(j.kernel[...])))
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


# ---------------------------------------------------------------------------
# the reference's accessors and keywords (ROADMAP queue 3, F1 and F2)
# ---------------------------------------------------------------------------


def test_accessors_match_jax():
    """``SparseTensor.features``, ``.coordinates`` and ``.coordinate_map`` and
    ``TensorField.features``, ``.coordinates`` and ``.dtype`` give what JAX's
    give on one cloud: ``F``, ``C``, the manager's map, the features' dtype."""
    coords = _coords()
    jx, tx, feats = _pair(coords, ch=4)
    assert tx.features is tx.F and tx.coordinates.equal(tx.C)
    np.testing.assert_array_equal(tx.features.numpy(), np.asarray(jx.features))
    np.testing.assert_array_equal(tx.coordinates.numpy(), np.asarray(jx.coordinates))
    jm, tm = jx.coordinate_map, tx.coordinate_map
    assert tm is tx.coordinate_manager.get_coordinate_map(tx.coordinate_map_key)
    assert tm.size == jm.size and tm.tensor_stride == tuple(jm.tensor_stride)
    np.testing.assert_array_equal(tm.coordinates.numpy(), np.asarray(jm.coordinates)[: jm.size])

    pts = np.random.RandomState(1).rand(50, 3).astype(np.float32) * 4
    fc = np.concatenate([np.zeros((50, 1), np.float32), pts], 1)
    ff = np.random.RandomState(2).randn(50, 2).astype(np.float32)
    jf, tf = ME.TensorField(ff, fc), MT.TensorField(torch.from_numpy(ff), torch.from_numpy(fc))
    assert tf.features is tf.F and tf.coordinates.equal(tf.C)
    np.testing.assert_array_equal(tf.features.numpy(), np.asarray(jf.features))
    np.testing.assert_array_equal(tf.coordinates.numpy(), np.asarray(jf.coordinates))
    assert tf.dtype == torch.float32 and np.dtype(jf.dtype) == np.float32
    assert MT.TensorField(torch.from_numpy(ff).double(), torch.from_numpy(fc)).dtype == torch.float64


_MANAGER_KEYWORDS = [
    ("allocator_type", "PYTORCH"), ("minkowski_algorithm", "SPEED_OPTIMIZED"),
    ("minkowski_algorithm", "MEMORY_EFFICIENT"),
]


def _enum(package, keyword, value):
    cls = {"allocator_type": "GPUMemoryAllocatorType",
           "minkowski_algorithm": "MinkowskiAlgorithm"}[keyword]
    return getattr(getattr(package, cls), value)


def _manager_state(mgr):
    return (int(mgr.allocator_type) if mgr.allocator_type is not None else None,
            int(mgr.minkowski_algorithm), mgr.coordinate_map_type)


@pytest.mark.parametrize("cls", ["SparseTensor", "TensorField"])
@pytest.mark.parametrize("keyword,value", _MANAGER_KEYWORDS)
def test_tensor_keywords_match_jax(cls, keyword, value):
    """A tensor built with a backend keyword gives JAX's rows, and its new
    manager keeps what JAX's keeps: a SparseTensor's keeps the keyword, a
    TensorField's does not see it."""
    coords = _coords(seed=3)
    feats = np.random.RandomState(3).randn(len(coords), 2).astype(np.float32)
    c = coords if cls == "SparseTensor" else coords.astype(np.float32)
    j = getattr(ME, cls)(feats, c, **{keyword: _enum(ME, keyword, value)})
    t = getattr(MT, cls)(torch.from_numpy(feats), torch.from_numpy(c),
                         **{keyword: _enum(MT, keyword, value)})
    np.testing.assert_array_equal(t.F.numpy(), np.asarray(j.F))
    np.testing.assert_array_equal(t.C.numpy(), np.asarray(j.C))
    assert _manager_state(t.coordinate_manager) == _manager_state(j.coordinate_manager)
    if cls == "SparseTensor":
        assert getattr(t.coordinate_manager, keyword) == _enum(MT, keyword, value)


@pytest.mark.parametrize("cls", ["SparseTensor", "TensorField"])
@pytest.mark.parametrize("flag", [True, False, None])
def test_requires_grad_sets_the_features_flag(cls, flag):
    """``requires_grad`` sets the features' flag, as the reference's tensors
    do (JAX takes it and ignores it: ROADMAP queue 3, Kept on purpose);
    None leaves the flag as it was."""
    coords = _coords(seed=4)
    c = torch.from_numpy(coords if cls == "SparseTensor" else coords.astype(np.float32))
    feats = torch.randn(len(coords), 3, generator=torch.Generator().manual_seed(0))
    t = getattr(MT, cls)(feats, c, requires_grad=flag)
    assert t.F.requires_grad is bool(flag) and feats.requires_grad is bool(flag)
    j = getattr(ME, cls)(feats.detach().numpy(), c.numpy(), requires_grad=flag)
    np.testing.assert_array_equal(t.F.detach().numpy(), np.asarray(j.F))
    if flag:  # a gradient reaches the features the caller passed
        t.F.sum().backward()
        assert feats.grad is not None and feats.grad.shape == feats.shape


@pytest.mark.parametrize("keyword,value", [
    ("num_threads", 4), ("coordinate_map_type", "CUDA"), *_MANAGER_KEYWORDS,
])
def test_coordinate_manager_keywords_match_jax(keyword, value):
    """``CoordinateManager`` and ``CoordsManager`` take the reference's four
    backend keywords beside ``device``; the maps they build and the
    attributes they keep are JAX's."""
    coords = _coords(seed=5)
    if keyword in ("allocator_type", "minkowski_algorithm"):
        jv, tv = _enum(ME, keyword, value), _enum(MT, keyword, value)
    else:
        jv = tv = value
    for name in ("CoordinateManager", "CoordsManager"):
        jm = getattr(ME, name)(D=3, **{keyword: jv})
        tm = getattr(MT, name)(D=3, **{keyword: tv}, device="cpu")
        jkey, _ = jm.insert_and_map(jnp.asarray(coords))
        tkey, _ = tm.insert_and_map(torch.from_numpy(coords))
        assert tkey.get_key() == jkey.get_key()
        np.testing.assert_array_equal(tm.get_coordinates(tkey).numpy(),
                                      np.asarray(jm.get_coordinates(jkey)))
        assert _manager_state(tm) == _manager_state(jm)


def _conv_pair(name, mode, cin=3, cout=5):
    """(JAX module, port module with JAX's weights, input stride) of one conv
    class at ``mode``."""
    kw = dict(kernel_size=3, stride=1) if name == "MinkowskiConvolution" else dict(
        kernel_size=2, stride=2)
    j = getattr(ME, name)(cin, cout, dimension=3, convolution_mode=_enum_mode(ME, mode),
                          rngs=nnx.Rngs(0), **kw)
    t = getattr(MT, name)(cin, cout, dimension=3, convolution_mode=_enum_mode(MT, mode),
                          device="cpu", **kw)
    with torch.no_grad():
        t.kernel.copy_(torch.from_numpy(np.array(j.kernel[...])))
    return j, t, 1 if name == "MinkowskiConvolution" else 2


def _enum_mode(package, mode):
    return getattr(package.ConvolutionMode, mode)


CONVS = ["MinkowskiConvolution", "MinkowskiConvolutionTranspose",
         "MinkowskiGenerativeConvolutionTranspose"]


@pytest.mark.parametrize("name", CONVS)
@pytest.mark.parametrize("mode", ["DEFAULT", "DIRECT_GEMM", "COPY_GEMM"])
def test_convolution_mode_matches_jax_and_changes_nothing(name, mode):
    """Every ``convolution_mode`` builds the module JAX builds, is kept and
    shown in the repr, and gives JAX's output, bit-equal to DEFAULT's: the
    port has one sparse-conv path (K1/K2 on the card)."""
    j, t, ts = _conv_pair(name, mode)
    assert t.convolution_mode == _enum_mode(MT, mode) and f"mode={mode}" in repr(t)
    coords = _coords(seed=6)
    coords[:, 1:] *= ts
    feats = np.random.RandomState(6).randn(len(coords), 3).astype(np.float32)
    jy = j(ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords), tensor_stride=ts))
    x = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords), tensor_stride=ts)
    ty = t(x)
    np.testing.assert_array_equal(ty.C.numpy(), np.asarray(jy.C))
    assert _rel(ty.F.detach().numpy(), np.asarray(jy.F)) <= REL
    _, default, _ = _conv_pair(name, "DEFAULT")
    with torch.no_grad():
        default.kernel.copy_(t.kernel)
    assert torch.equal(default(x).F, ty.F)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batch_norm_axis_name_outside_a_mesh_matches_jax(training):
    """``MinkowskiBatchNorm(axis_name=...)`` outside any mesh is batch norm,
    as JAX's is outside a ``shard_map``; the name is kept (inside a mesh:
    ``tests/test_torch_parallel_data.py`` and
    ``tests/test_torch_sync_batchnorm.py``)."""
    coords = _coords(seed=7)
    feats = (np.random.RandomState(7).randn(len(coords), 4) + 1.0).astype(np.float32)
    j, t = ME.MinkowskiBatchNorm(4, axis_name="data"), MT.MinkowskiBatchNorm(
        4, axis_name="data", device="cpu")
    assert t.axis_name == j.axis_name == "data"
    j.train(training)
    t.train(training)
    jy = j(ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords)))
    ty = t(MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords)))
    assert _rel(ty.F.detach().numpy(), np.asarray(jy.F)) <= 1e-5


def test_reference_named_params_takes_a_prefix_as_jax():
    """``utils.reference_named_params(module, prefix)`` names every
    parameter and buffer as JAX's does, after ``prefix.``."""
    from minkowskiengine_tpu.utils.torch_import import reference_named_params as jnamed

    j = ME.MinkowskiConvolution(3, 4, kernel_size=3, bias=True, dimension=3, rngs=nnx.Rngs(0))
    t = MT.MinkowskiConvolution(3, 4, kernel_size=3, bias=True, dimension=3, device="cpu")
    for prefix in ("", "block.conv"):
        want = jnamed(j, prefix)
        got = MT.utils.reference_named_params(t, prefix=prefix)
        assert set(got) == set(want), prefix
        assert all(k.startswith(prefix + ".") for k in got) if prefix else "kernel" in got
    named = MT.utils.reference_named_params(t, "p")
    assert named["p.bias"].shape == (4,) and named["p.kernel"] is t.kernel
