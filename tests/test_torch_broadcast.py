"""Port parity for broadcast and the squeeze-and-excitation blocks on the CPU.

The four broadcast modules and ``MinkowskiBroadcastFunction`` against
JAX's, forward and the gradients to both inputs; ``SELayer``,
``SEBasicBlock`` and ``SEBottleneck`` with weights carried from JAX; and a
narrow SE-ResNet (each package's ``ResNetBase`` with ``BLOCK =
SEBasicBlock``) on four synthetic shapes.

Tolerance, max|Δ|/max|ref| per tensor: 1e-6 for broadcast (one add or
product per entry); 1e-5 for the SE blocks (two convs, batch norms and the
SE layer's linears, pooling and sigmoid, each ~1e-6 relative); 1e-4 for
the SE-ResNet's logits and gradients, as the classification tests hold
the ResNets.  JAX's own float32 gradients stray up to 1.6e-4 of max from
its float64 run at some seeds, so a gradient that misses 1e-4 is judged
as chip_smoke.py judges the card's: its distance from JAX's float64 run
may be at most GRAD_FACTOR times JAX's float32 distance from it (that
tensor's or the median tensor's, whichever is larger).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.models import ResNetBase as JResNetBase
from minkowskiengine_tpu.modules import senet_block as jse
from minkowskiengine_tpu.nn.nonlinearity import MinkowskiDropout as JDropout
from minkowskiengine_tpu.nn.norm import MinkowskiBatchNorm as JBatchNorm
from minkowskiengine_tpu.ops import functional as JF
from minkowskiengine_tpu.utils.torch_import import export_reference_state_dict
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.models import ResNetBase
from minkowskiengine_tpu_torch.modules import SEBasicBlock, SEBottleneck, SELayer
from minkowskiengine_tpu_torch.ops import functional as F
from minkowskiengine_tpu_torch.utils.datasets import modelnet_batch
from minkowskiengine_tpu_torch.utils.torch_import import load_state_dict_from_reference

REL = 1e-6
SE_REL = 1e-5
NET_REL = 1e-4
GRAD_FACTOR = 10.0
MODULES = ["MinkowskiBroadcastAddition", "MinkowskiBroadcastMultiplication",
           "MinkowskiBroadcast", "MinkowskiBroadcastConcatenation"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _coords(seed=0, n=200, batches=3):
    rng = np.random.RandomState(seed)
    c = np.concatenate([rng.randint(0, batches, (n, 1)), rng.randint(-6, 6, (n, 3))], 1)
    return np.unique(c.astype(np.int32), axis=0)


def _setup(ch, seed=0):
    """One map and its origin map in each package; features and global rows."""
    coords = _coords(seed)
    jmgr, tmgr = ME.CoordinateManager(D=3), MT.CoordinateManager(D=3, device="cpu")
    jkey, _ = jmgr.insert_and_map(jnp.asarray(coords))
    tkey, _ = tmgr.insert_and_map(torch.from_numpy(coords))
    jokey, jrows = jmgr.origin_map(jkey)
    tokey, trows = tmgr.origin_map(tkey)
    assert tokey.get_key() == jokey.get_key()
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows)[: len(coords)])
    rng = np.random.RandomState(seed + 1)
    feats = rng.randn(len(coords), ch).astype(np.float32)
    glob = rng.randn(tmgr.size(tokey), ch).astype(np.float32)
    return (jmgr, jkey, jokey), (tmgr, tkey, tokey), feats, glob


@pytest.mark.parametrize("name", MODULES)
def test_broadcast_modules_match_jax(name):
    (jmgr, jkey, jokey), (tmgr, tkey, tokey), feats, glob = _setup(4)
    width = 8 if name.endswith("Concatenation") else 4
    cot = np.random.RandomState(2).randn(len(feats), width).astype(np.float32)

    def jfun(f, g):
        x = ME.SparseTensor(f, coordinate_map_key=jkey, coordinate_manager=jmgr)
        y = ME.SparseTensor(g, coordinate_map_key=jokey, coordinate_manager=jmgr)
        out = getattr(ME, name)()(x, y)
        assert out.coordinate_map_key == jkey
        return out.F

    want, vjp = jax.vjp(jfun, jnp.asarray(feats), jnp.asarray(glob))
    want_f, want_g = vjp(jnp.asarray(cot))
    f = torch.from_numpy(feats).requires_grad_()
    g = torch.from_numpy(glob).requires_grad_()
    x = MT.SparseTensor(f, coordinate_map_key=tkey, coordinate_manager=tmgr)
    y = MT.SparseTensor(g, coordinate_map_key=tokey, coordinate_manager=tmgr)
    out = getattr(MT, name)()(x, y)
    assert out.coordinate_map_key == tkey and out.F.shape == (len(feats), width)
    assert _rel(out.F.detach(), want) <= REL
    out.F.backward(torch.from_numpy(cot))
    assert _rel(g.grad, want_g) <= REL
    if name == "MinkowskiBroadcast":  # the input's features do not enter
        assert f.grad is None and np.abs(np.asarray(want_f)).max() == 0
    else:
        assert _rel(f.grad, want_f) <= REL


@pytest.mark.parametrize("op", ["add", "mul"])
def test_functional_broadcast_matches_jax(op):
    """A row whose origin row is -1 gives 0, with no gradient."""
    _, (tmgr, tkey, _), feats, glob = _setup(3, seed=3)
    rows = tmgr.origin_map(tkey)[1].clone()
    rows[::5] = -1
    want, vjp = jax.vjp(lambda a, b: JF.broadcast(a, b, jnp.asarray(rows.numpy()), op),
                        jnp.asarray(feats), jnp.asarray(glob))
    cot = np.ones_like(feats)
    want_f, want_g = vjp(jnp.asarray(cot))
    f = torch.from_numpy(feats).requires_grad_()
    g = torch.from_numpy(glob).requires_grad_()
    got = F.broadcast(f, g, rows, op)
    assert (got[::5] == 0).all()
    assert _rel(got.detach(), want) <= REL
    got.backward(torch.from_numpy(cot))
    assert _rel(f.grad, want_f) <= REL and _rel(g.grad, want_g) <= REL
    with pytest.raises(ValueError, match="unknown op"):
        F.broadcast(f, g, rows, "max")


@pytest.mark.parametrize("mode", ["ELEMENTWISE_ADDITON", "ELEMENTWISE_MULTIPLICATION"])
def test_broadcast_function_matches_jax(mode):
    (jmgr, jkey, jokey), (tmgr, tkey, tokey), feats, glob = _setup(5, seed=4)
    padded = np.zeros((jmgr.capacity(jkey), feats.shape[1]), np.float32)  # JAX pads rows
    padded[: len(feats)] = feats
    want = ME.MinkowskiBroadcastFunction.apply(
        jnp.asarray(padded), jnp.asarray(glob), getattr(ME.BroadcastMode, mode), jkey, jokey, jmgr
    )
    got = MT.MinkowskiBroadcastFunction.apply(
        torch.from_numpy(feats), torch.from_numpy(glob), getattr(MT.BroadcastMode, mode), tkey, tokey, tmgr
    )
    assert int(getattr(MT.BroadcastMode, mode)) == int(getattr(ME.BroadcastMode, mode))
    assert _rel(got, np.asarray(want)[: len(feats)]) <= REL


def test_broadcast_checks_raise_like_jax():
    """A channel mismatch, and a global tensor that is neither on the
    input's origin map nor one row per batch item, raise ValueError."""
    (jmgr, jkey, jokey), (tmgr, tkey, tokey), feats, glob = _setup(4, seed=5)
    jx = ME.SparseTensor(jnp.asarray(feats), coordinate_map_key=jkey, coordinate_manager=jmgr)
    tx = MT.SparseTensor(torch.from_numpy(feats), coordinate_map_key=tkey, coordinate_manager=tmgr)
    jnarrow = ME.SparseTensor(jnp.asarray(glob[:, :2]), coordinate_map_key=jokey, coordinate_manager=jmgr)
    tnarrow = MT.SparseTensor(torch.from_numpy(glob[:, :2]), coordinate_map_key=tokey, coordinate_manager=tmgr)
    jk2, tk2 = jmgr.stride(jkey, 4), tmgr.stride(tkey, 4)
    n2 = tmgr.size(tk2)
    assert n2 != len(glob)
    other = np.ones((n2, 4), np.float32)
    jother = ME.SparseTensor(jnp.asarray(other), coordinate_map_key=jk2, coordinate_manager=jmgr)
    tother = MT.SparseTensor(torch.from_numpy(other), coordinate_map_key=tk2, coordinate_manager=tmgr)
    for pkg, x, narrow, wrong in ((ME, jx, jnarrow, jother), (MT, tx, tnarrow, tother)):
        with pytest.raises(ValueError, match="channel mismatch"):
            pkg.MinkowskiBroadcastAddition()(x, narrow)
        with pytest.raises(ValueError, match="one row per batch index"):
            pkg.MinkowskiBroadcastMultiplication()(x, wrong)


def _sparse_pair(ch, seed):
    coords = _coords(seed, n=300, batches=2)
    feats = np.random.RandomState(seed).randn(len(coords), ch).astype(np.float32)
    return (ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords)),
            lambda f: MT.SparseTensor(f, torch.from_numpy(coords))), feats


def _modes(net, bn_training):
    """Batch norms in train or eval mode; dropout off."""
    for _, m in nnx.iter_graph(net):
        if isinstance(m, JBatchNorm):
            m.train(bn_training)
        elif isinstance(m, JDropout):
            m.train(False)


@pytest.mark.parametrize("block", ["SELayer", "SEBasicBlock", "SEBottleneck"])
def test_se_blocks_match_jax(block):
    """Weights exported from JAX under the same names (``se.fc1``,
    ``se.fc2``); forward and the input gradient, the batch norms in eval
    mode with random running statistics (JAX's VJP cannot update them)."""
    if block == "SELayer":
        ch, jm = 32, jse.SELayer(32, reduction=16, D=3, rngs=nnx.Rngs(0))
        tm = SELayer(32, reduction=16, D=3, device="cpu")
    elif block == "SEBasicBlock":
        ch, jm = 32, jse.SEBasicBlock(32, 32, dimension=3, rngs=nnx.Rngs(0))
        tm = SEBasicBlock(32, 32, dimension=3, device="cpu")
    else:
        ch, jm = 64, jse.SEBottleneck(64, 16, dimension=3, rngs=nnx.Rngs(0))
        tm = SEBottleneck(64, 16, dimension=3, device="cpu")
    sd = export_reference_state_dict(jm)
    assert any(k.endswith("fc1.linear.weight") for k in sd) and any(k.endswith("fc2.linear.bias") for k in sd)
    rng = np.random.RandomState(1)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = rng.randn(*sd[k].shape).astype(np.float32) * 0.1
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, sd[k].shape).astype(np.float32)
    ME.utils.torch_import.load_reference_state_dict(jm, sd)
    load_state_dict_from_reference(tm, sd)
    _modes(jm, False)
    tm.eval()
    (jx, make), feats = _sparse_pair(ch, seed=6)
    cot = np.random.RandomState(7).randn(len(feats), ch).astype(np.float32)

    def jfun(f):
        return jm(ME.SparseTensor(f, coordinate_map_key=jx.coordinate_map_key,
                                  coordinate_manager=jx.coordinate_manager)).F

    want, vjp = jax.vjp(jfun, jnp.asarray(feats))
    (want_grad,) = vjp(jnp.asarray(cot))
    f = torch.from_numpy(feats).requires_grad_()
    out = tm(make(f))
    assert _rel(out.F.detach(), want) <= SE_REL
    out.F.backward(torch.from_numpy(cot))
    assert _rel(f.grad, want_grad) <= SE_REL


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


def _se_resnet(base, block):
    return type("NarrowSE", (base,), dict(
        BLOCK=block, LAYERS=(1, 1, 1, 1), INIT_DIM=16, PLANES=(16, 16, 32, 32)
    ))


def test_se_resnet_matches_jax():
    """Logits in eval mode; loss and every parameter gradient with
    train-mode batch norm (dropout off)."""
    coords, feats, labels = modelnet_batch(4, n_points=256, seed=1, voxel_size=0.05)
    jnet = _se_resnet(JResNetBase, jse.SEBasicBlock)(3, 8, D=3, rngs=nnx.Rngs(1))
    tnet = _se_resnet(ResNetBase, SEBasicBlock)(3, 8, D=3, device="cpu")
    sd = export_reference_state_dict(jnet)
    assert "layer1.0.se.fc1.linear.weight" in sd
    load_state_dict_from_reference(tnet, sd)

    def jx(dtype=jnp.float32):
        return ME.TensorField(jnp.asarray(feats, dtype), jnp.asarray(coords)).sparse()

    def tx():
        return MT.TensorField(torch.from_numpy(feats), torch.from_numpy(coords)).sparse()

    _modes(jnet, False)
    tnet.eval()
    with torch.no_grad():
        got = tnet(tx())
    assert got.F.shape == (4, 8)
    assert _rel(got.F, np.asarray(jnet(jx()).F)) <= NET_REL

    _modes(jnet, True)
    tnet.train()
    tnet.conv5[0].eval()

    def jax_grads(net, dtype):
        def loss_fn(m):
            return optax.softmax_cross_entropy_with_integer_labels(m(jx(dtype)).F, jnp.asarray(labels)).mean()

        jloss, jgrads = nnx.value_and_grad(loss_fn)(net)
        named = nnx.clone(net)
        nnx.update(named, jgrads)
        return float(jloss), export_reference_state_dict(named)

    jloss, want = jax_grads(jnet, jnp.float32)
    with jax.enable_x64():
        _, want64 = jax_grads(_jax_float64(jnet), jnp.float64)
    loss = torch.nn.functional.cross_entropy(tnet(tx()).F, torch.from_numpy(labels).long())
    loss.backward()
    assert abs(loss.item() - jloss) <= NET_REL * abs(jloss)
    _judge_gradients({k: p.grad.numpy().reshape(np.shape(want[k])) for k, p in tnet.named_parameters()},
                     want, want64)
