"""Port parity for TensorField: quantization, field maps, slicing, keys.

The same float points and features go into each package's TensorField.
``sparse()`` in its four quantization modes, the field-to-sparse row maps
at tensor strides 1-16, ``slice`` and ``cat_slice`` are compared with
JAX's.  The points include voxel boundaries: integral coordinates, -0.0,
and the float32 just below an integer, at strides 1-16 and 3.

Tolerance: coordinates, row maps and keys bit-equal; features rtol 1e-6,
the rounding of f32 means over the few points of a voxel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minkowskiengine_tpu as ME
import minkowskiengine_tpu_torch as MT

RTOL = ATOL = 1e-6
Q = MT.SparseTensorQuantizationMode


def _points(seed=0, n=600):
    rng = np.random.RandomState(seed)
    batch = rng.randint(0, 2, (n, 1)).astype(np.float32)
    xyz = rng.uniform(-9, 9, (n, 3)).astype(np.float32)
    xyz[:60] = np.round(xyz[:60])  # integral: on voxel boundaries at every stride
    xyz[60:70, 0] = -0.0
    k = np.round(xyz[70:80, 1])
    k[k == 0] = 1  # below 0 lies a denormal, which XLA on the CPU flushes to 0
    xyz[70:80, 1] = np.nextafter(k, np.float32(-np.inf))
    coords = np.concatenate([batch, xyz], 1)
    feats = rng.randint(0, 4, (n, 3)).astype(np.float32)  # ties for MAX_POOL
    return coords, feats


def _fields(coords, feats, **kw):
    return (
        ME.TensorField(jnp.asarray(feats), jnp.asarray(coords), **kw),
        MT.TensorField(torch.from_numpy(feats), torch.from_numpy(coords), **kw),
    )


@pytest.mark.parametrize(
    "mode", [Q.UNWEIGHTED_AVERAGE, Q.UNWEIGHTED_SUM, Q.MAX_POOL, Q.RANDOM_SUBSAMPLE],
    ids=lambda m: m.name,
)
def test_sparse_matches_jax(mode):
    coords, feats = _points()
    jtf, ttf = _fields(coords, feats)
    js = jtf.sparse(quantization_mode=ME.SparseTensorQuantizationMode(int(mode)))
    ts = ttf.sparse(quantization_mode=mode)
    assert ts.coordinate_map_key.get_key() == js.coordinate_map_key.get_key()
    np.testing.assert_array_equal(ts.C.numpy(), np.asarray(js.C))
    np.testing.assert_allclose(ts.F.numpy(), np.asarray(js.F), rtol=RTOL, atol=ATOL)
    assert ts.size < ttf.size  # points did share voxels


def test_sparse_tensor_quantization_modes_match_jax():
    """``SparseTensor(features, coordinates, quantization_mode=...)`` reduces
    the rows of a duplicate coordinate as JAX does."""
    coords, feats = _points(seed=1)
    icoords = np.floor(coords).astype(np.int32)
    for mode in (Q.UNWEIGHTED_AVERAGE, Q.UNWEIGHTED_SUM, Q.MAX_POOL, Q.RANDOM_SUBSAMPLE):
        js = ME.SparseTensor(jnp.asarray(feats), jnp.asarray(icoords),
                             quantization_mode=ME.SparseTensorQuantizationMode(int(mode)))
        ts = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(icoords),
                             quantization_mode=mode)
        np.testing.assert_array_equal(ts.C.numpy(), np.asarray(js.C))
        np.testing.assert_allclose(ts.F.numpy(), np.asarray(js.F), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stride", [1, 2, 3, 4, 8, 16])
def test_field_to_sparse_map_matches_jax(stride):
    coords, feats = _points(seed=2)
    jtf, ttf = _fields(coords, feats)
    js, ts = jtf.sparse(tensor_stride=stride), ttf.sparse(tensor_stride=stride)
    jmap = np.asarray(jtf.inverse_mapping(js.coordinate_map_key))[: len(coords)]
    tmap = ttf.inverse_mapping(ts.coordinate_map_key)
    assert tmap.dtype == torch.int32
    np.testing.assert_array_equal(tmap.numpy(), jmap)
    np.testing.assert_array_equal(ts.C.numpy(), np.asarray(js.C))
    # on fresh fields: the map of the stride-1 voxels strided by the
    # manager, which the field has not been quantized to, looked up afresh
    jtf, ttf = _fields(coords, feats)
    jk = jtf.coordinate_manager.stride(jtf.sparse().coordinate_map_key, stride)
    tk = ttf.coordinate_manager.stride(ttf.sparse().coordinate_map_key, stride)
    assert ttf.coordinate_manager.exists_field_to_sparse(ttf.coordinate_field_map_key, tk) == (
        stride == 1
    )
    np.testing.assert_array_equal(
        ttf.inverse_mapping(tk).numpy(), np.asarray(jtf.inverse_mapping(jk))[: len(coords)]
    )


def test_second_sparse_gets_jax_key():
    """A second ``.sparse()`` of the same field finds (stride, "") taken and
    registers ``map-N``, in both packages; strided maps inherit the id."""
    coords, feats = _points(seed=3)
    jtf, ttf = _fields(coords, feats)
    keys = []
    for tf in (jtf, ttf):
        a = tf.sparse().coordinate_map_key
        b = tf.sparse().coordinate_map_key
        c = tf.coordinate_manager.stride(b, 2)
        o = tf.coordinate_manager.origin(c)
        keys.append([k.get_key() for k in (a, b, c, o)])
    assert keys[1] == keys[0]
    assert keys[1][1][1].startswith("map-") and keys[1][2][1] == keys[1][1][1]


def test_slice_and_cat_slice_match_jax():
    coords, feats = _points(seed=4)
    jtf, ttf = _fields(coords, feats)
    g = np.random.RandomState(5).randn(len(coords), 6).astype(np.float32)

    def jfun(f):
        tf = ME.TensorField(f, coordinate_field_map_key=jtf.coordinate_field_map_key,
                            coordinate_manager=jtf.coordinate_manager)
        y = ME.MinkowskiMaxPooling(kernel_size=2, stride=2, dimension=3)(tf.sparse())
        return y.cat_slice(tf).F, y.slice(tf).F

    (want, want_sliced), vjp = jax.vjp(jfun, jnp.asarray(feats))
    (want_grad,) = vjp((jnp.asarray(g), jnp.zeros_like(want_sliced)))
    f = torch.from_numpy(feats).requires_grad_()
    tf = ttf._wrap(f)
    y = MT.MinkowskiMaxPooling(kernel_size=2, stride=2, dimension=3)(tf.sparse())
    got, sliced = y.cat_slice(tf), y.slice(tf)
    assert got.coordinate_field_map_key == ttf.coordinate_field_map_key
    np.testing.assert_allclose(got.F.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sliced.F.detach().numpy(), np.asarray(want_sliced),
                               rtol=RTOL, atol=ATOL)
    got.F.backward(torch.from_numpy(g))
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=ATOL)


def test_field_arithmetic_and_cat_keep_the_field():
    coords, feats = _points(seed=6, n=50)
    _, ttf = _fields(coords, feats)
    both = MT.cat(ttf + 1.0, ttf * ttf)
    assert both.coordinate_field_map_key == ttf.coordinate_field_map_key
    torch.testing.assert_close(both.F, torch.cat([ttf.F + 1.0, ttf.F * ttf.F], 1))
    assert ttf.shape == (50, 3) and ttf.C.dtype == torch.float32 and ttf.D == 3

