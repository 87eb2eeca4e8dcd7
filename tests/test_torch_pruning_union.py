"""Port parity for pruning, union and mixed-key arithmetic, and MinkowskiELU.

The same seeded numpy coordinates and features go through the JAX package
and the port on the CPU.  Coordinate maps, keys, string ids and row maps
are compared bit for bit; features and their gradients (against
``jax.vjp``) at rtol 1e-6: they are gathers and at most one sum per row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.ops import functional as JF
from minkowskiengine_tpu.nn.nonlinearity import MinkowskiELU as JELU
from minkowskiengine_tpu.nn.pruning import MinkowskiPruning as JPruning
from minkowskiengine_tpu.nn.union import MinkowskiUnion as JUnion
from minkowskiengine_tpu.sparse_tensor import _invert_union_map as j_invert
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.coords.manager import CoordinateMapKey
from minkowskiengine_tpu_torch.nn.pruning import MinkowskiPruningFunction
from minkowskiengine_tpu_torch.nn.union import MinkowskiUnionFunction
from minkowskiengine_tpu_torch.ops import functional as TF
from minkowskiengine_tpu_torch.sparse_tensor import _invert_union_map

RTOL = 1e-6


def _coords(n, seed, res=6, batch=2):
    rng = np.random.RandomState(seed)
    c = np.concatenate([rng.randint(0, batch, (n, 1)), rng.randint(0, res, (n, 3))], 1)
    return np.unique(c.astype(np.int32), axis=0)


def _feats(n, ch, seed):
    return np.random.RandomState(seed).randn(n, ch).astype(np.float32)


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * max(np.abs(want).max(), 1.0))


@pytest.fixture(scope="module")
def managers():
    """Both packages' managers with the same two maps at stride 1 (their
    ids '' and 'map-0') and a keep mask over the first."""
    a, b = _coords(40, 0), _coords(30, 1)
    jm, tm = ME.CoordinateManager(D=3), MT.CoordinateManager(D=3, device="cpu")
    jk = [jm.insert_and_map(c, 1)[0] for c in (a, b)]
    tk = [tm.insert_and_map(torch.from_numpy(c), 1)[0] for c in (a, b)]
    keep = np.random.RandomState(2).rand(len(a)) < 0.5
    return jm, tm, jk, tk, keep


def test_prune_matches_jax(managers):
    jm, tm, jk, tk, keep = managers
    for _ in range(2):  # the second prune of a stride takes 'pruned-N'
        jkey, jin_out, jout_in = jm.prune(jk[0], jnp.asarray(keep))
        tkey, tin_out, tout_in = tm.prune(tk[0], torch.from_numpy(keep))
        assert tkey.get_key() == jkey.get_key()
        n = int(keep.sum())
        assert tout_in.dtype == tin_out.dtype == torch.int32 and tout_in.shape == (n,)
        np.testing.assert_array_equal(tout_in.numpy(), np.asarray(jout_in)[:n])
        np.testing.assert_array_equal(tin_out.numpy(), np.asarray(jin_out)[: len(keep)])
        np.testing.assert_array_equal(tm.get_coordinates(tkey).numpy(), np.asarray(jm.get_coordinates(jkey)))
    assert [k[1] for k in tm._maps] == [k[1] for k in jm.get_keys()]
    assert tkey.get_key()[1].startswith("pruned-")


def test_merge_and_union_map_match_jax(managers):
    jm, tm, jk, tk, _ = managers
    ju, tu = jm.merge(jk), tm.merge(tk)
    assert tu.get_key() == ju.get_key() == ((1, 1, 1), "merged")
    np.testing.assert_array_equal(tm.get_coordinates(tu).numpy(), np.asarray(jm.get_coordinates(ju)))
    for t, j, key in zip(tm.union_map(tk, tu), jm.union_map(jk, ju), tk):
        n = tm.size(key)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j)[:n])
        inv = _invert_union_map(t, tm.size(tu))
        want = j_invert(j, jm.capacity(ju))[: tm.size(tu)]
        np.testing.assert_array_equal(inv.numpy(), np.asarray(want))
    assert tm.merge(tk).get_key()[1].startswith("merged-")  # 'merged' is taken
    with pytest.raises(ValueError, match="identical tensor strides"):
        tm.merge([tk[0], tm.stride(tk[0], 2)])


def test_prune_and_union_features_and_gradients_match_jax():
    x = _feats(12, 3, 0)
    y = _feats(9, 3, 1)
    out_from_in = np.array([0, 2, 3, 7, 11], np.int32)
    inv_x = np.array([0, -1, 1, 2, -1, 3, 4, 5, 6, 7, 8, 9, 10, 11], np.int32)
    inv_y = np.array([-1, 0, 1, -1, 2, 3, -1, 4, 5, 6, 7, -1, 8, -1], np.int32)
    g_p = _feats(5, 3, 2)
    g_u = _feats(14, 3, 3)

    jp, jvjp = jax.vjp(lambda a: JF.prune_features(a, jnp.asarray(out_from_in)), jnp.asarray(x))
    ju, jvjp_u = jax.vjp(
        lambda a, b: JF.union_features([a, b], [jnp.asarray(inv_x), jnp.asarray(inv_y)]),
        jnp.asarray(x), jnp.asarray(y),
    )
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    tp = TF.prune_features(tx, torch.from_numpy(out_from_in))
    tu = TF.union_features([tx, ty], [torch.from_numpy(inv_x), torch.from_numpy(inv_y)])
    _close(tp.detach().numpy(), jp)
    _close(tu.detach().numpy(), ju)
    (gx,) = torch.autograd.grad(tp, tx, torch.from_numpy(g_p))
    _close(gx.numpy(), jvjp(jnp.asarray(g_p))[0])
    gx, gy = torch.autograd.grad(tu, (tx, ty), torch.from_numpy(g_u))
    jgx, jgy = jvjp_u(jnp.asarray(g_u))
    _close(gx.numpy(), jgx)
    _close(gy.numpy(), jgy)


def _pair(coords, feats, jm, tm, ts=1):
    j = ME.SparseTensor(jnp.asarray(feats), coords, coordinate_manager=jm, tensor_stride=ts)
    t = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords), coordinate_manager=tm,
                        tensor_stride=ts)
    return j, t


def _same(j, t):
    assert t.coordinate_map_key.get_key() == j.coordinate_map_key.get_key()
    np.testing.assert_array_equal(t.C.numpy(), np.asarray(j.C))
    _close(t.F.detach().numpy(), np.asarray(j.F))


def test_pruning_module_matches_jax():
    c = _coords(50, 3)
    f = _feats(len(c), 4, 3)
    jm, tm = ME.CoordinateManager(D=3), MT.CoordinateManager(D=3, device="cpu")
    jx, tx = _pair(c, f, jm, tm)
    keep = np.random.RandomState(4).rand(len(c)) < 0.4
    _same(JPruning()(jx, keep), MT.MinkowskiPruning()(tx, torch.from_numpy(keep)))


def test_pruning_function_fills_or_checks_the_out_key():
    c = _coords(30, 5)
    tm = MT.CoordinateManager(D=3, device="cpu")
    tx = MT.SparseTensor(torch.from_numpy(_feats(len(c), 2, 5)), torch.from_numpy(c), coordinate_manager=tm)
    keep = torch.from_numpy(np.random.RandomState(6).rand(len(c)) < 0.5)
    out_key = CoordinateMapKey(3)
    assert not out_key.is_key_set()
    feats = MinkowskiPruningFunction.apply(tx.F, keep, tx.coordinate_map_key, out_key, tm)
    assert out_key.get_key() == ((1, 1, 1), "pruned")
    assert feats.shape == (int(keep.sum()), 2)
    torch.testing.assert_close(feats, tx.F[keep])
    with pytest.raises(ValueError, match="does not match the pruned map"):
        MinkowskiPruningFunction.apply(tx.F, keep, tx.coordinate_map_key, out_key, tm)


def test_union_module_matches_jax():
    jm, tm = ME.CoordinateManager(D=3), MT.CoordinateManager(D=3, device="cpu")
    pairs = [_pair(_coords(n, s), _feats(len(_coords(n, s)), 3, s), jm, tm)
             for n, s in ((40, 7), (35, 8), (20, 9))]
    _same(JUnion()(*[j for j, _ in pairs]), MT.MinkowskiUnion()(*[t for _, t in pairs]))


def test_union_checks_its_inputs():
    tm, other = MT.CoordinateManager(D=3, device="cpu"), MT.CoordinateManager(D=3, device="cpu")
    c = torch.from_numpy(_coords(20, 10))
    a = MT.SparseTensor(torch.ones(len(c), 2), c, coordinate_manager=tm)
    union = MT.MinkowskiUnion()
    with pytest.raises(ValueError, match="at least one input"):
        union()
    with pytest.raises(TypeError, match="SparseTensors"):
        union(a, a.F)
    with pytest.raises(ValueError, match="coordinate manager"):
        union(a, MT.SparseTensor(torch.ones(len(c), 2), c, coordinate_manager=other))
    with pytest.raises(ValueError, match="tensor stride"):
        union(a, MT.SparseTensor(torch.ones(len(c), 2), c * 2, tensor_stride=2, coordinate_manager=tm))
    with pytest.raises(ValueError, match="channel size"):
        union(a, MT.SparseTensor(torch.ones(len(c), 3), c, coordinate_manager=tm))
    with pytest.raises(ValueError, match="same length"):
        MinkowskiUnionFunction.apply([a.coordinate_map_key], a.coordinate_map_key, tm, a.F, a.F)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "radd", "rmul", "neg", "pow"])
def test_mixed_key_arithmetic_matches_jax(op):
    """Two tensors on overlapping maps meet on their union: each has rows
    the other lacks, which take 0 for the absent operand (so ``a * b`` is 0
    and ``a / b`` is a / 0 there, as in JAX)."""
    jm, tm = ME.CoordinateManager(D=3), MT.CoordinateManager(D=3, device="cpu")
    ca, cb = _coords(40, 11), _coords(40, 12)
    fa = _feats(len(ca), 3, 11)
    fb = np.abs(_feats(len(cb), 3, 12)) + 0.5
    (ja, ta), (jb, tb) = _pair(ca, fa, jm, tm), _pair(cb, fb, jm, tm)
    fn = {
        "add": lambda a, b: a + b, "sub": lambda a, b: a - b, "mul": lambda a, b: a * b,
        "div": lambda a, b: a / b, "radd": lambda a, b: 2.0 + a, "rmul": lambda a, b: 3.0 * a,
        "neg": lambda a, b: -a, "pow": lambda a, b: a**2,
    }[op]
    j, t = fn(ja, jb), fn(ta, tb)
    assert t.coordinate_map_key.get_key() == j.coordinate_map_key.get_key()
    np.testing.assert_array_equal(t.C.numpy(), np.asarray(j.C))
    want, got = np.asarray(j.F), t.F.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin])
    if op in ("add", "sub", "mul", "div"):
        only_a = tm.union_map([tb.coordinate_map_key], t.coordinate_map_key)[0]
        rows_a = np.setdiff1d(np.arange(t.size), only_a.numpy())
        assert len(rows_a) > 0  # rows found only in the left operand are checked


def test_mixed_key_rows_only_in_the_left_take_zero_for_the_right():
    """Pins the queue-3 divergence: where only the left operand has a row,
    ``a * b`` gives 0 and ``a / b`` gives a / 0 (JAX's result); the
    reference leaves the left value untouched there."""
    tm = MT.CoordinateManager(D=3, device="cpu")
    a = MT.SparseTensor(torch.tensor([[2.0], [3.0]]), torch.tensor([[0, 0, 0, 0], [0, 0, 0, 1]]),
                        coordinate_manager=tm)
    b = MT.SparseTensor(torch.tensor([[4.0], [5.0]]), torch.tensor([[0, 0, 0, 1], [0, 0, 0, 2]]),
                        coordinate_manager=tm)
    assert (a * b).F.flatten().tolist() == [0.0, 12.0, 0.0]
    assert (a / b).F.flatten().tolist() == [float("inf"), 0.75, 0.0]
    assert (a + b).F.flatten().tolist() == [2.0, 7.0, 5.0]
    assert (a - b).F.flatten().tolist() == [2.0, -1.0, -5.0]


def test_elu_matches_jax():
    c = _coords(30, 13)
    f = _feats(len(c), 5, 13) * 3
    jm, tm = ME.CoordinateManager(D=3), MT.CoordinateManager(D=3, device="cpu")
    jx, tx = _pair(c, f, jm, tm)
    _close(MT.MinkowskiELU()(tx).F.numpy(), np.asarray(JELU()(jx).F))
    g = _feats(len(c), 5, 14)
    _, jvjp = jax.vjp(jax.nn.elu, jnp.asarray(f))
    x = torch.from_numpy(f).requires_grad_()
    (gx,) = torch.autograd.grad(MT.MinkowskiELU()._fn(x), x, torch.from_numpy(g))
    _close(gx.numpy(), jvjp(jnp.asarray(g))[0])
