"""Port parity for splatting: ``TensorField.splat``, SPLAT_LINEAR_INTERPOLATION
in ``TensorField.sparse`` and the ``SparseTensor`` constructor, and
``MinkowskiSplatFCNN`` equal JAX's on the CPU.

Points include negative and mixed coordinates, integral points (all mass
on one corner) and two batch items.  The narrow SplatFCNN runs on four
synthetic shapes of 256 points (``modelnet_batch``), with weights exported
from the JAX model.

Tolerance: map keys and coordinates bit-equal; splatted features within
max|Δ|/max|ref| <= 1e-6 (each corner sums a few weighted points); the
SplatFCNN's logits, loss and every parameter gradient within 1e-4 per
tensor, as ``tests/test_torch_classification.py`` holds the FCNN.  JAX's
own float32 gradients stray up to 2e-4 of max from its float64 run at
some seeds, so a gradient that misses 1e-4 is judged as chip_smoke.py
judges the card's: its distance from JAX's float64 run may be at most
GRAD_FACTOR times JAX's float32 distance from it (that tensor's or the
median tensor's, whichever is larger).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.models.classification import MinkowskiSplatFCNN as JSplatFCNN
from minkowskiengine_tpu.nn.nonlinearity import MinkowskiDropout as JDropout
from minkowskiengine_tpu.nn.norm import MinkowskiBatchNorm as JBatchNorm
from minkowskiengine_tpu.utils.torch_import import export_reference_state_dict
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.models import MinkowskiFCNN, MinkowskiSplatFCNN
from minkowskiengine_tpu_torch.utils.datasets import modelnet_batch
from minkowskiengine_tpu_torch.utils.torch_import import load_state_dict_from_reference

REL = 1e-6
NET_REL = 1e-4
GRAD_FACTOR = 10.0
Q = MT.SparseTensorQuantizationMode
NARROW = dict(embedding_channel=32, channels=(8, 16, 8, 16, 8), D=3)
NCLS = 8


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _points(seed=0, n=300, D=3, lo=-4.0, hi=4.0):
    rng = np.random.RandomState(seed)
    coords = np.concatenate(
        [rng.randint(0, 2, (n, 1)), rng.uniform(lo, hi, (n, D))], axis=1
    ).astype(np.float32)
    coords[: n // 10, 1:] = np.round(coords[: n // 10, 1:])  # integral: weight 1 on one corner
    return coords, rng.randn(n, 3).astype(np.float32)


def _fields(coords, feats, **kw):
    return (
        ME.TensorField(jnp.asarray(feats), jnp.asarray(coords), **kw),
        MT.TensorField(torch.from_numpy(feats), torch.from_numpy(coords), **kw),
    )


def _same(js, ts):
    assert ts.coordinate_map_key.get_key() == js.coordinate_map_key.get_key()
    np.testing.assert_array_equal(ts.C.numpy(), np.asarray(js.C))
    assert _rel(ts.F.detach(), js.F) <= REL


@pytest.mark.parametrize("D", [2, 3])
def test_splat_matches_jax(D):
    coords, feats = _points(seed=D, D=D)
    jtf, ttf = _fields(coords, feats)
    js, ts = jtf.splat(), ttf.splat()
    _same(js, ts)
    assert ts.tensor_stride == (1,) * D
    # mass is conserved: the weights of each point sum to 1
    np.testing.assert_allclose(ts.F.sum(0).numpy(), feats.sum(0), rtol=1e-5, atol=1e-5)


def test_splat_gradient_matches_jax():
    coords, feats = _points(seed=4)
    jtf, ttf = _fields(coords, feats)
    g = np.random.RandomState(5).randn(ttf.splat().size, 3).astype(np.float32)

    def jfun(f):
        return ME.TensorField(f, coordinate_field_map_key=jtf.coordinate_field_map_key,
                              coordinate_manager=jtf.coordinate_manager).splat().F

    _, vjp = jax.vjp(jfun, jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(g))
    f = torch.from_numpy(feats).requires_grad_()
    ttf._wrap(f).splat().F.backward(torch.from_numpy(g))
    assert _rel(f.grad, want) <= REL


def test_integral_points_put_all_mass_on_one_corner():
    coords = np.array([[0, 1.0, 2.0], [0, -3.0, 0.0]], np.float32)
    _, ttf = _fields(coords, np.array([[1.0], [2.0]], np.float32))
    st = ttf.splat()
    got = {tuple(c.tolist()): float(f) for c, f in zip(st.C, st.F[:, 0])}
    assert got.pop((0, 1, 2)) == 1.0 and got.pop((0, -3, 0)) == 2.0
    assert len(got) == 6 and all(v == 0.0 for v in got.values())


def test_sparse_in_splat_mode_matches_jax():
    """``TensorField.sparse`` in SPLAT mode is ``splat()`` on the unit
    lattice, and raises ValueError at any other tensor stride, in both
    packages (the reference asserts and asks for ``.splat()``)."""
    coords, feats = _points(seed=6)
    jtf, ttf = _fields(coords, feats)
    jq = ME.SparseTensorQuantizationMode.SPLAT_LINEAR_INTERPOLATION
    _same(jtf.sparse(quantization_mode=jq), ttf.sparse(quantization_mode=Q.SPLAT_LINEAR_INTERPOLATION))
    for tf, q in ((jtf, jq), (ttf, Q.SPLAT_LINEAR_INTERPOLATION)):
        with pytest.raises(ValueError, match="unit lattice"):
            tf.sparse(tensor_stride=2, quantization_mode=q)
    _, ttf = _fields(coords, feats, quantization_mode=Q.SPLAT_LINEAR_INTERPOLATION)
    assert ttf.sparse().coordinate_map_key.get_key() == ((1, 1, 1), "")


def test_sparse_tensor_splat_constructor_matches_jax():
    coords, feats = _points(seed=7)
    js = ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords),
                         quantization_mode=ME.SparseTensorQuantizationMode.SPLAT_LINEAR_INTERPOLATION)
    ts = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords),
                         quantization_mode=Q.SPLAT_LINEAR_INTERPOLATION)
    _same(js, ts)
    assert ts.quantization_mode == Q.SPLAT_LINEAR_INTERPOLATION


def test_second_splat_gets_jax_key():
    """The splat map takes ``(1, 1, 1), ""``; a second splat, or a
    ``sparse()`` after it, finds that taken and gets ``map-N``, as in JAX."""
    coords, feats = _points(seed=8, n=50)
    keys = []
    for tf in _fields(coords, feats):
        keys.append([t.coordinate_map_key.get_key() for t in (tf.splat(), tf.splat(), tf.sparse())])
    assert keys[1] == keys[0]
    assert keys[1][0] == ((1, 1, 1), "") and keys[1][1][1].startswith("map-")


@pytest.mark.parametrize("stride", [1, 2, 4, 8, 16])
def test_every_point_finds_its_voxel_after_a_splat(stride):
    """The floor corner of every point is in the splat set, so the field's
    row map into the splat map strided by the manager (as the SplatFCNN's
    pooling strides it) has no -1, and equals JAX's."""
    coords, feats = _points(seed=9, lo=-40.0, hi=40.0)
    jtf, ttf = _fields(coords, feats)
    jk = jtf.coordinate_manager.stride(jtf.splat().coordinate_map_key, stride)
    tk = ttf.coordinate_manager.stride(ttf.splat().coordinate_map_key, stride)
    rows = ttf.inverse_mapping(tk)
    assert (rows >= 0).all()
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jtf.inverse_mapping(jk))[: len(coords)])


@pytest.fixture(scope="module")
def batch():
    return modelnet_batch(4, n_points=256, seed=1, voxel_size=0.05)


@pytest.fixture(scope="module")
def splat_fcnn():
    jnet = JSplatFCNN(3, NCLS, rngs=nnx.Rngs(1), **NARROW)
    tnet = MinkowskiSplatFCNN(3, NCLS, device="cpu", **NARROW)
    sd = export_reference_state_dict(jnet)
    rng = np.random.RandomState(0)
    for k in sd:  # random running statistics, so eval mode is a real test
        if k.endswith("running_mean"):
            sd[k] = rng.randn(*sd[k].shape).astype(np.float32) * 0.1
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, sd[k].shape).astype(np.float32)
    ME.utils.torch_import.load_reference_state_dict(jnet, sd)
    load_state_dict_from_reference(tnet, sd)
    return jnet, tnet, sd


def _jax_modes(net, bn_training):
    for _, m in nnx.iter_graph(net):
        if isinstance(m, JBatchNorm):
            m.train(bn_training)
        elif isinstance(m, JDropout):
            m.train(False)


def _jfield(batch, dtype=jnp.float32):
    return ME.TensorField(jnp.asarray(batch[1], dtype), jnp.asarray(batch[0]))


def _jax_float64(net):
    """A float64 copy of a JAX model, for use under ``jax.enable_x64()``."""
    net = nnx.clone(net)
    nnx.update(net, jax.tree.map(
        lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, nnx.state(net)))
    return net


def _judge_gradients(grads, want32, want64):
    """Each gradient within NET_REL of JAX's float32 one, or else within
    GRAD_FACTOR times JAX's own float32 error of its float64 run."""
    jax_err = {k: _rel(want32[k], want64[k]) for k in grads}
    median = float(np.median(list(jax_err.values())))
    for name, g in grads.items():
        if _rel(g, want32[name]) > NET_REL:
            assert _rel(g, want64[name]) <= GRAD_FACTOR * max(jax_err[name], median), name


def _tfield(batch):
    return MT.TensorField(torch.from_numpy(batch[1]), torch.from_numpy(batch[0]))


def test_splat_fcnn_state_dict_is_the_fcnn_state_dict(splat_fcnn):
    _, tnet, sd = splat_fcnn
    assert set(tnet.state_dict()) == set(sd) == set(MinkowskiFCNN(3, NCLS, device="cpu", **NARROW).state_dict())
    assert isinstance(tnet, MT.MinkowskiNetwork) and tnet.D == 3


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_splat_fcnn_logits_match_jax(splat_fcnn, batch, train):
    """Eval mode (running statistics) and train mode (batch statistics),
    dropout off in both."""
    jnet, tnet, _ = splat_fcnn
    _jax_modes(jnet, train)
    tnet.train(train)
    tnet.final[1].eval()
    want = np.asarray(jnet(_jfield(batch)))
    with torch.no_grad():
        got = tnet(_tfield(batch))
    assert got.shape == want.shape == (4, NCLS) and torch.isfinite(got).all()
    assert _rel(got, want) <= NET_REL


def test_splat_fcnn_gradients_match_jax(splat_fcnn, batch):
    """Loss and every parameter gradient, train-mode batch norm, dropout off."""
    jnet, tnet, _ = splat_fcnn
    _jax_modes(jnet, True)
    tnet.train()
    tnet.final[1].eval()

    def jax_grads(net, dtype):
        def loss_fn(m):
            logits = m(_jfield(batch, dtype))
            return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(batch[2])).mean()

        jloss, jgrads = nnx.value_and_grad(loss_fn)(net)
        named = nnx.clone(net)
        nnx.update(named, jgrads)
        return float(jloss), export_reference_state_dict(named)

    jloss, want = jax_grads(jnet, jnp.float32)
    with jax.enable_x64():
        _, want64 = jax_grads(_jax_float64(jnet), jnp.float64)
    tnet.zero_grad()
    loss = torch.nn.functional.cross_entropy(tnet(_tfield(batch)), torch.from_numpy(batch[2]).long())
    loss.backward()
    assert abs(loss.item() - jloss) <= NET_REL * abs(jloss)
    grads = {k: p.grad.numpy().reshape(np.shape(want[k])) for k, p in tnet.named_parameters()}
    assert len(grads) == len([k for k in want if "running" not in k and "num_batches" not in k])
    for name in grads:
        assert np.abs(want[name]).max() > 0, name  # every parameter is reached
    _judge_gradients(grads, want, want64)
