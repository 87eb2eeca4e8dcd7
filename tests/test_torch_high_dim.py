"""Port parity above D = 6: multi-word keys against the JAX package's lanes.

The port packs a key into int64 words, (N,) for D <= 6 and (N, L) above
(``coords/keys.py``); the JAX package packs uint32 lanes.  Both must give
the same bit budget, accept and reject the same rows, sort rows into the
same canonical order and so build the same maps index for index, at every D
the JAX package takes.  Clouds are small and made from a seed with numpy;
the 7-D net is the one ``chip_smoke.py`` phase 39 trains, at ~2 x 300 rows
of a room scan lifted to (x, y, z, r, g, b, t).

Tolerance: keys, rows, maps and masks bit-equal; a single conv's output
and gradients within 1e-5 of max|ref| (float32 sums over up to 128 offsets
taken in another order); the 7-D net's logits, loss and every gradient
within 1e-4 of max|ref|, as ``tests/test_torch_train.py`` holds a
train-mode net (batch norm's statistics over ~600 rows, sums in another
order through four convs); interpolation weights within 1e-7.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.coords import keys as jkeys
from minkowskiengine_tpu.utils import quantization as JQ
from minkowskiengine_tpu.utils.torch_import import export_reference_state_dict
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.coords import keys as tkeys
from minkowskiengine_tpu_torch.coords.unique import unique_from_keys, unique_padded
from minkowskiengine_tpu_torch.utils.datasets import make_room_scan
from minkowskiengine_tpu_torch.utils.torch_import import load_state_dict_from_reference

from test_torch_replay import no_host_sync

CONV_REL = 1e-5
NET_REL = 1e-4
W_ATOL = 1e-7


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _rand(D, n, lo, hi, batches, seed):
    """(n, D+1) int32 rows, batch first, with duplicates."""
    rng = np.random.RandomState(seed)
    b = rng.randint(0, batches, (n, 1))
    x = rng.randint(lo, hi + 1, (n, D))
    return np.concatenate([b, x], 1).astype(np.int32)


def _edges(D, seed, n=400):
    """Rows over every field's whole range, its extremes, the maximal tuple,
    and one row past each end of each field."""
    rng = np.random.RandomState(seed)
    ranges = jkeys.field_ranges(D)
    c = np.stack([rng.randint(lo, hi + 1, n) for lo, hi in ranges], 1)
    c[:4] = [[lo for lo, _ in ranges], [hi for _, hi in ranges]] * 2
    c[4:8, 1:] = rng.choice([-1, 0, 1], (4, D))
    past = []
    for f, (lo, hi) in enumerate(ranges):
        for v in (lo - 1, hi + 1):
            row = c[8].copy()
            row[f] = v
            past.append(row)
    c = np.concatenate([c, np.stack(past), c[:60]])  # duplicates
    return c.astype(np.int64).clip(-(2**31), 2**31 - 1).astype(np.int32)


@pytest.mark.parametrize("D", range(1, 21))
def test_bit_budget_and_overflow_match_jax(D):
    assert tkeys.bit_allocation(D) == jkeys.bit_allocation(D)
    assert tkeys.field_ranges(D) == jkeys.field_ranges(D)
    c = _edges(D, seed=D)
    want = np.asarray(jkeys.overflow_mask(jnp.asarray(c)))
    tc = torch.from_numpy(c)
    np.testing.assert_array_equal(tkeys.overflow_mask(tc).numpy(), want)
    maximal = np.array([[hi for _, hi in jkeys.field_ranges(D)]], np.int32)
    full = sum(jkeys.bit_allocation(D)) == 32 * jkeys.n_lanes(D)
    assert bool(np.asarray(jkeys.overflow_mask(jnp.asarray(maximal)))[0]) == full
    assert bool(tkeys.overflow_mask(torch.from_numpy(maximal))[0]) == full
    # the per-offset form equals the mask of the sums
    offs = torch.from_numpy(np.random.RandomState(D).randint(-1, 2, (3, D + 1)).astype(np.int32))
    offs[:, 0] = 0
    sums = tc[None, :, :].long() + offs[:, None, :].long()
    np.testing.assert_array_equal(tkeys.overflow_mask_of_sum(tc, offs).numpy(),
                                  tkeys.overflow_mask(sums).numpy())
    # one word up to D = 6, no word wider than 63 bits of fields above
    key = tkeys.pack(tc)
    assert key.dtype == torch.int64
    assert key.shape == ((len(c),) if D <= 6 else (len(c), tkeys.n_words(D)))
    ok = ~tkeys.overflow_mask(tc)
    assert not tkeys.is_pad(key[ok]).any()
    if D > 6:
        assert (key[ok] < 2**62).all() and (key[ok] >= -(2**62)).all()


def test_one_word_keys_are_unchanged():
    """D <= 6 keys are today's int64 keys, in closed form: the batch field
    shifted down by half its range in the top bits, each coordinate biased
    by half its range below."""
    c = torch.tensor([[3, -2, 5, 7], [0, 0, 0, 0], [65535, 32767, -32768, 1]], dtype=torch.int32)
    want = [
        ((3 - 2**15) << 48) | ((-2 + 2**15) << 32) | ((5 + 2**15) << 16) | (7 + 2**15),
        (-(2**15) << 48) | (2**15 << 32) | (2**15 << 16) | 2**15,
        ((65535 - 2**15) << 48) | ((32767 + 2**15) << 32) | (0 << 16) | (1 + 2**15),
    ]
    assert tkeys.pack(c).tolist() == want
    c5 = torch.tensor([[7, -512, 511, 0, 3, -1]], dtype=torch.int32)
    want5 = (7 - 2**11) << 50
    for f, v in enumerate([-512, 511, 0, 3, -1]):
        want5 |= (v + 512) << (40 - 10 * f)
    assert tkeys.pack(c5).tolist() == [want5]
    assert tkeys.pack_offsets(torch.tensor([[0, 1, -1, 2]])).tolist() == [
        (1 << 32) - (1 << 16) + 2]


@pytest.mark.parametrize("D", [7, 9, 13, 14, 16])
def test_key_order_matches_jax_lanes(D):
    c = _edges(D, seed=100 + D)
    c = c[~np.asarray(jkeys.overflow_mask(jnp.asarray(c)))]
    lanes = [np.asarray(l) for l in jkeys.pack(jnp.asarray(c))]
    j_order = np.lexsort(lanes[::-1])  # stable; lanes most significant first
    s_keys, order = tkeys.sort_keys(tkeys.pack(torch.from_numpy(c)))
    np.testing.assert_array_equal(order.numpy(), j_order)
    j_new = np.ones(len(c), bool)
    j_new[1:] = np.any(np.stack(lanes, 1)[j_order][1:] != np.stack(lanes, 1)[j_order][:-1], 1)
    np.testing.assert_array_equal(tkeys.keys_differ(s_keys).numpy(), j_new[1:])
    assert j_new.sum() == len(np.unique(c, axis=0)) < len(c)


@pytest.mark.parametrize("D", [7, 8, 13, 16])
def test_insert_and_map_matches_jax(D):
    lo, hi = jkeys.field_ranges(D)[1]
    c = np.concatenate([_rand(D, 250, -2, 2, 3, seed=D), _rand(D, 50, lo, hi, 2, seed=D + 1)])
    c = np.concatenate([c, c[::7]])
    jm, tm = ME.CoordinateManager(D=D), MT.CoordinateManager(D=D, device="cpu")
    jk, (ju, ji) = jm.insert_and_map(c)
    tk, (tu, ti) = tm.insert_and_map(torch.from_numpy(c))
    assert jk.get_key() == tk.get_key()
    np.testing.assert_array_equal(tm.get_coordinates(tk).numpy(), np.asarray(jm.get_coordinates(jk)))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(c[tu.numpy()][ti.numpy()], c)
    bad = c.copy()
    bad[3, 2] = hi + 1
    with pytest.raises(ValueError):
        ME.CoordinateManager(D=D).insert_and_map(bad)
    with pytest.raises(ValueError, match=f"\\[{lo}, {hi}\\]"):
        MT.CoordinateManager(D=D, device="cpu").insert_and_map(torch.from_numpy(bad))


def _same_kmap(jkm, tkm):
    np.testing.assert_array_equal(tkm.in_idx.numpy(), np.asarray(jkm.in_idx)[:, : tkm.n_out])
    np.testing.assert_array_equal(tkm.out_idx_t.numpy(), np.asarray(jkm.out_idx_t)[:, : tkm.n_in])


def _managers(D, seed, n=300):
    c = _rand(D, n, -2, 2, 2, seed)
    jm, tm = ME.CoordinateManager(D=D), MT.CoordinateManager(D=D, device="cpu")
    jk, _ = jm.insert_and_map(c)
    tk, _ = tm.insert_and_map(torch.from_numpy(c))
    return (jm, jk), (tm, tk)


CROSS = ME.RegionType.HYPER_CROSS


@pytest.mark.parametrize("D,k,s,region", [
    (7, 2, 1, ME.RegionType.HYPER_CUBE), (7, 2, 2, ME.RegionType.HYPER_CUBE), (7, 3, 1, CROSS),
    (16, 3, 1, CROSS),
])
def test_kernel_and_stride_maps_match_jax(D, k, s, region):
    (jm, jk), (tm, tk) = _managers(D, seed=30 + D)
    jo, to = jm.stride(jk, s), tm.stride(tk, s)
    np.testing.assert_array_equal(tm.get_coordinates(to).numpy(), np.asarray(jm.get_coordinates(jo)))
    kw = dict(stride=s, kernel_size=k, region_type=region)
    jkm = jm.kernel_map(jk, jo, **kw)
    tkm = tm.kernel_map(tk, to, **dict(kw, region_type=MT.RegionType(int(region))))
    assert tkm.kernel_volume == {(2, "HYPER_CUBE"): 128, (3, "HYPER_CROSS"): 2 * D + 1}[
        (k, region.name)]
    _same_kmap(jkm, tkm)
    assert (tkm.in_idx >= 0).any()
    if s > 1:
        np.testing.assert_array_equal(tm.stride_map(tk, to).numpy(),
                                      np.asarray(jm.stride_map(jk, jo))[: tm.size(tk)])
        jt = jm.kernel_map(jo, jk, is_transpose=True, **kw)
        _same_kmap(jt, tm.kernel_map(to, tk, is_transpose=True, **dict(
            kw, region_type=MT.RegionType(int(region)))))


def test_prune_merge_union_and_origin_maps_match_jax():
    D = 7
    a, b = _rand(D, 200, -2, 2, 2, seed=90), _rand(D, 200, -2, 2, 2, seed=91)
    jm, tm = ME.CoordinateManager(D=D), MT.CoordinateManager(D=D, device="cpu")
    jk = [jm.insert_and_map(c)[0] for c in (a, b)]
    tk = [tm.insert_and_map(torch.from_numpy(c))[0] for c in (a, b)]
    keep = np.random.RandomState(92).rand(tm.size(tk[0])) < 0.5
    jp, _, jout_in = jm.prune(jk[0], jnp.asarray(keep))
    tp, _, tout_in = tm.prune(tk[0], torch.from_numpy(keep))
    np.testing.assert_array_equal(tout_in.numpy(), np.asarray(jout_in)[: int(keep.sum())])
    np.testing.assert_array_equal(tm.get_coordinates(tp).numpy(), np.asarray(jm.get_coordinates(jp)))
    assert torch.equal(tm.get_coordinate_map(tp).keys,
                       tm.get_coordinate_map(tk[0]).keys[torch.from_numpy(keep)])
    ju, tu = jm.merge(jk), tm.merge(tk)
    np.testing.assert_array_equal(tm.get_coordinates(tu).numpy(), np.asarray(jm.get_coordinates(ju)))
    for t, j, key in zip(tm.union_map(tk, tu), jm.union_map(jk, ju), tk):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j)[: tm.size(key)])
    (jo, jrows), (to, trows) = jm.origin_map(jk[1]), tm.origin_map(tk[1])
    np.testing.assert_array_equal(tm.get_coordinates(to).numpy(), np.asarray(jm.get_coordinates(jo)))
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows)[: tm.size(tk[1])])


def _pair(cls_j, cls_t, cin, cout, D, seed, cross=False, **kw):
    """A JAX module and the port's with its weights; ``cross``: a
    HYPER_CROSS kernel generator at the module's kernel size and stride."""
    jkw, tkw = dict(kw), dict(kw)
    if cross:
        gen = dict(kernel_size=kw["kernel_size"], stride=kw.get("stride", 1), dimension=D)
        jkw["kernel_generator"] = ME.KernelGenerator(region_type=CROSS, **gen)
        tkw["kernel_generator"] = MT.KernelGenerator(region_type=MT.RegionType.HYPER_CROSS, **gen)
    j = cls_j(cin, cout, dimension=D, rngs=nnx.Rngs(seed), **jkw)
    t = cls_t(cin, cout, dimension=D, device="cpu", **tkw)
    with torch.no_grad():
        t.kernel.copy_(torch.tensor(np.asarray(j.kernel[...])))
        if kw.get("bias"):
            t.bias.copy_(torch.tensor(np.asarray(j.bias[...])))
    return j, t


def _cross(D):
    return ME.KernelGenerator(kernel_size=3, region_type=CROSS, dimension=D)


@pytest.mark.parametrize("D,case", [
    (7, "k2s2"), (7, "cross"), (7, "transpose_k2s2"), (7, "generative_cross"),
    (8, "cross"), (13, "cross"), (16, "cross"),
])
def test_conv_and_gradients_match_jax(D, case):
    c = np.unique(_rand(D, 300, -2, 2, 2, seed=40), axis=0)
    feats = np.random.RandomState(41).randn(len(c), 4).astype(np.float32)
    if case == "k2s2":
        pairs = [_pair(ME.MinkowskiConvolution, MT.MinkowskiConvolution, 4, 8, D, 1,
                       kernel_size=2, stride=2)]
    elif case == "cross":
        pairs = [_pair(ME.MinkowskiConvolution, MT.MinkowskiConvolution, 4, 8, D, 2,
                       cross=True, kernel_size=3, bias=True)]
    else:
        up_cls, kw = {
            "transpose_k2s2": ((ME.MinkowskiConvolutionTranspose, MT.MinkowskiConvolutionTranspose),
                               dict(kernel_size=2, stride=2)),
            "generative_cross": ((ME.MinkowskiGenerativeConvolutionTranspose,
                                  MT.MinkowskiGenerativeConvolutionTranspose),
                                 dict(kernel_size=3, stride=2, cross=True)),
        }[case]
        pairs = [_pair(ME.MinkowskiConvolution, MT.MinkowskiConvolution, 4, 4, D, 3,
                       kernel_size=2, stride=2),
                 _pair(*up_cls, 4, 8, D, 4, **kw)]
    jmods, tmods = tuple(j for j, _ in pairs), [t for _, t in pairs]
    tf = torch.from_numpy(feats).requires_grad_()
    ty = MT.SparseTensor(tf, torch.from_numpy(c))
    for m in tmods:
        ty = m(ty)
    cot = np.random.RandomState(7).randn(*ty.F.shape).astype(np.float32)
    (ty.F * torch.from_numpy(cot)).sum().backward()

    def run(mods, f):
        y = ME.SparseTensor(f, jnp.asarray(c))
        for m in mods:
            y = m(y)
        return y

    jy = run(jmods, jnp.asarray(feats))
    np.testing.assert_array_equal(ty.C.numpy(), np.asarray(jy.C))
    assert ty.tensor_stride == tuple(jy.tensor_stride)
    assert _rel(ty.F.detach(), jy.F) <= CONV_REL
    jgrads, jgf = nnx.grad(lambda m, f: jnp.sum(run(m, f).F * jnp.asarray(cot)),
                           argnums=(0, 1))(jmods, jnp.asarray(feats))
    assert _rel(tf.grad, jgf) <= CONV_REL
    for t, jg in zip(tmods, jgrads):
        for name, p in t.named_parameters():
            assert _rel(p.grad, jg[name][...]) <= CONV_REL, name


@pytest.mark.parametrize("D", range(7, 21))
def test_cross_conv_at_every_dimension_matches_a_brute_force_sum(D):
    """At every D from 7 to 20, a SparseTensor and a HYPER_CROSS conv run in
    the port and equal the sum over offsets found by a dict of rows."""
    c = np.unique(_rand(D, 120, -1, 1, 2, seed=80 + D), axis=0)
    feats = np.random.RandomState(D).randn(len(c), 2).astype(np.float32)
    conv = MT.MinkowskiConvolution(2, 3, kernel_size=3, dimension=D, device="cpu",
                                   generator=torch.Generator().manual_seed(D),
                                   kernel_generator=MT.KernelGenerator(
                                       kernel_size=3, region_type=MT.RegionType.HYPER_CROSS,
                                       dimension=D))
    with torch.no_grad():
        y = conv(MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(c)))
    offsets = MT.KernelGenerator(kernel_size=3, region_type=MT.RegionType.HYPER_CROSS,
                                 dimension=D).get_kernel((1,) * D, False).offsets
    row = {tuple(r): i for i, r in enumerate(c.tolist())}
    w = conv.kernel.detach().numpy()
    want = np.zeros((len(c), 3), np.float64)
    for o, r in enumerate(y.C.numpy().tolist()):
        for k, off in enumerate(offsets.tolist()):
            i = row.get((r[0], *(a + b for a, b in zip(r[1:], off))))
            if i is not None:
                want[o] += feats[i] @ w[k]
    assert len(offsets) == 2 * D + 1 and y.C.shape == (len(c), D + 1)
    assert _rel(y.F, want) <= CONV_REL


@pytest.mark.parametrize("pool", ["max", "avg", "global_avg", "global_max"])
def test_pooling_matches_jax(pool):
    D = 7
    c = _rand(D, 300, 0, 4, 2, seed=50)
    feats = np.random.RandomState(51).randn(len(c), 3).astype(np.float32)
    jx = ME.SparseTensor(jnp.asarray(feats), jnp.asarray(c))
    tx = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(c))
    make = {
        "max": lambda P: P.MinkowskiMaxPooling(kernel_size=2, stride=2, dimension=D),
        "avg": lambda P: P.MinkowskiAvgPooling(kernel_size=2, stride=2, dimension=D),
        "global_avg": lambda P: P.MinkowskiGlobalAvgPooling(),
        "global_max": lambda P: P.MinkowskiGlobalMaxPooling(),
    }[pool]
    jy, ty = make(ME)(jx), make(MT)(tx)
    np.testing.assert_array_equal(ty.C.numpy(), np.asarray(jy.C))
    np.testing.assert_allclose(ty.F.numpy(), np.asarray(jy.F), rtol=1e-6, atol=1e-6)


def _field_points(D, seed, n=400):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.randint(0, 2, (n, 1)), rng.uniform(-3, 3, (n, D))], 1)
    pts[:40, 1:] = np.round(pts[:40, 1:])  # on voxel boundaries
    pts[n // 2:] = pts[: n - n // 2] + rng.uniform(-0.05, 0.05, (n - n // 2, D + 1))
    pts[n // 2:, 0] = pts[: n - n // 2, 0]  # near neighbours, some in the same voxel
    return pts.astype(np.float32), rng.randn(n, 3).astype(np.float32)


def test_tensor_field_sparse_slice_and_interpolation_match_jax():
    D = 7
    pts, feats = _field_points(D, seed=60)
    jtf = ME.TensorField(jnp.asarray(feats), jnp.asarray(pts))
    ttf = MT.TensorField(torch.from_numpy(feats), torch.from_numpy(pts))
    js, ts = jtf.sparse(), ttf.sparse()
    np.testing.assert_array_equal(ts.C.numpy(), np.asarray(js.C))
    np.testing.assert_allclose(ts.F.numpy(), np.asarray(js.F), rtol=1e-6, atol=1e-6)
    assert ts.size < ttf.size
    jy = ME.MinkowskiMaxPooling(kernel_size=2, stride=2, dimension=D)(js)
    ty = MT.MinkowskiMaxPooling(kernel_size=2, stride=2, dimension=D)(ts)
    np.testing.assert_allclose(ty.slice(ttf).F.numpy(), np.asarray(jy.slice(jtf).F),
                               rtol=1e-6, atol=1e-6)
    samples = pts[::4] + np.float32(0.25)
    jrows, jw = js.coordinate_manager.interpolation_map_weight(js.coordinate_map_key,
                                                                jnp.asarray(samples))
    trows, tw = ts.coordinate_manager.interpolation_map_weight(ts.coordinate_map_key,
                                                                torch.from_numpy(samples))
    assert trows.shape == (len(samples), 2**D) and (trows >= 0).any()
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=W_ATOL)


def test_sparse_quantize_matches_jax():
    pts, feats = _field_points(7, seed=61, n=2000)
    pts = pts[:, 1:] * np.float32(2.0)
    labels = np.random.RandomState(62).randint(0, 5, len(pts))
    kw = dict(features=feats, labels=labels, return_index=True, return_inverse=True,
              quantization_size=0.5, ignore_label=-100)
    got, want = MT.utils.sparse_quantize(pts, **kw), JQ.sparse_quantize(pts, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert len(got[0]) < len(pts)


def test_unique_padded_equals_unique_from_keys():
    c = torch.from_numpy(_rand(7, 500, -1000, 1000, 3, seed=70)[
        np.random.RandomState(71).randint(0, 80, 500)])
    keys = tkeys.pack(c)
    valid = torch.from_numpy(np.random.RandomState(72).rand(500) < 0.8)
    with no_host_sync():
        got = unique_padded(keys, valid, 128)
    want = unique_from_keys(keys[valid])
    n = int(got.count)
    assert n == len(want.sorted_keys) <= 80
    assert torch.equal(got.sorted_keys[:n], want.sorted_keys)
    assert torch.equal(got.unique_map[:n], valid.nonzero().flatten()[want.unique_map])
    assert torch.equal(got.inverse_map[valid], want.inverse_map)
    assert tkeys.is_pad(got.sorted_keys[n:]).all() and (got.sorted_keys[n:] == tkeys.PAD_KEY).all()
    assert (got.unique_map[n:] == -1).all() and (got.inverse_map[~valid] == -1).all()


# the 7-D net of chip_smoke.py phase 39, in both packages, from public modules
class JHighDimUNet(nnx.Module):
    def __init__(self, cin, cout, D, rngs):
        conv = ME.MinkowskiConvolution
        self.conv1 = conv(cin, 32, kernel_size=2, dimension=D, rngs=rngs)
        self.bn1 = ME.MinkowskiBatchNorm(32)
        self.conv2 = conv(32, 64, kernel_size=2, stride=2, dimension=D, rngs=rngs)
        self.bn2 = ME.MinkowskiBatchNorm(64)
        self.conv3 = conv(64, 64, kernel_size=3, kernel_generator=_cross(D), dimension=D,
                          rngs=rngs)
        self.bn3 = ME.MinkowskiBatchNorm(64)
        self.up = ME.MinkowskiConvolutionTranspose(64, 32, kernel_size=2, stride=2, dimension=D,
                                                   rngs=rngs)
        self.bn4 = ME.MinkowskiBatchNorm(32)
        self.final = conv(64, cout, kernel_size=1, bias=True, dimension=D, rngs=rngs)
        self.relu = ME.MinkowskiReLU()

    def __call__(self, x):
        a = self.relu(self.bn1(self.conv1(x)))
        b = self.relu(self.bn2(self.conv2(a)))
        b = self.relu(self.bn3(self.conv3(b)))
        u = self.relu(self.bn4(self.up(b)))
        return self.final(ME.cat(u, a))


class THighDimUNet(torch.nn.Module):
    def __init__(self, cin, cout, D):
        super().__init__()
        conv = MT.MinkowskiConvolution
        cross = MT.KernelGenerator(kernel_size=3, region_type=MT.RegionType.HYPER_CROSS,
                                   dimension=D)
        self.conv1 = conv(cin, 32, kernel_size=2, dimension=D, device="cpu")
        self.bn1 = MT.MinkowskiBatchNorm(32, device="cpu")
        self.conv2 = conv(32, 64, kernel_size=2, stride=2, dimension=D, device="cpu")
        self.bn2 = MT.MinkowskiBatchNorm(64, device="cpu")
        self.conv3 = conv(64, 64, kernel_size=3, kernel_generator=cross, dimension=D, device="cpu")
        self.bn3 = MT.MinkowskiBatchNorm(64, device="cpu")
        self.up = MT.MinkowskiConvolutionTranspose(64, 32, kernel_size=2, stride=2, dimension=D,
                                                   device="cpu")
        self.bn4 = MT.MinkowskiBatchNorm(32, device="cpu")
        self.final = conv(64, cout, kernel_size=1, bias=True, dimension=D, device="cpu")
        self.relu = MT.MinkowskiReLU()

    def forward(self, x):
        a = self.relu(self.bn1(self.conv1(x)))
        b = self.relu(self.bn2(self.conv2(a)))
        b = self.relu(self.bn3(self.conv3(b)))
        u = self.relu(self.bn4(self.up(b)))
        return self.final(MT.cat(u, a))


def lifted_cloud(seed, frames=2, voxel=0.4, points=200):
    """A room scan lifted to 7-D: per frame t, the scan's points moved a
    few voxels, voxelized, each voxel with its color quantized to 8 levels
    per channel and t: rows (x, y, z, r, g, b, t), colors (N, 3)."""
    rows, colors = [], []
    for t in range(frames):
        rng = np.random.RandomState(1000 * seed + t)
        pts = make_room_scan(n_points=points, extent=(2.0, 2.0, 2.2), n_objects=4,
                             seed=1000 * seed + t)
        pts = pts + rng.randint(-2, 3, 3) * voxel
        col = np.stack([pts[:, 2] / 2.5, 0.5 + 0.5 * np.sin(pts[:, 0] * 2.1),
                        0.5 + 0.5 * np.cos(pts[:, 1] * 1.7)], 1).clip(0, 0.999)
        lifted = np.concatenate([np.floor(pts / voxel), np.floor(col * 8),
                                 np.full((len(pts), 1), t)], 1).astype(np.int32)
        _, first = np.unique(lifted, axis=0, return_index=True)
        rows.append(lifted[np.sort(first)])
        colors.append(col[np.sort(first)].astype(np.float32) - 0.5)
    return np.concatenate(rows), np.concatenate(colors)


def test_high_dim_net_step_matches_jax():
    scans = [lifted_cloud(s) for s in (0, 1)]
    coords, feats = MT.utils.sparse_collate([c for c, _ in scans], [f for _, f in scans])
    coords, feats = coords.numpy(), feats.numpy()
    assert coords.shape[1] == 8 and 500 <= len(coords) <= 800
    labels = np.random.RandomState(0).randint(0, 20, len(coords))
    jnet = JHighDimUNet(3, 20, 7, rngs=nnx.Rngs(0))
    tnet = THighDimUNet(3, 20, 7)
    load_state_dict_from_reference(tnet, export_reference_state_dict(jnet))
    jnet.train()
    tnet.train()

    def jloss(m):
        logits = m(ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords))).F
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean(), logits

    (jl, jlogits), jgrads = nnx.value_and_grad(jloss, has_aux=True)(jnet)
    named = nnx.clone(jnet)
    nnx.update(named, jgrads)
    jg = export_reference_state_dict(named)
    out = tnet(MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords)))
    loss = torch.nn.functional.cross_entropy(out.F, torch.from_numpy(labels).long())
    loss.backward()
    assert _rel(out.F.detach(), jlogits) <= NET_REL
    assert abs(loss.item() - float(jl)) <= NET_REL * abs(float(jl))
    for name, p in tnet.named_parameters():
        want = jg[name]
        assert np.abs(want).max() > 0, name
        assert _rel(p.grad.numpy().reshape(np.shape(want)), want) <= NET_REL, name
    kmap = out.coordinate_manager.kernel_map(
        out.coordinate_map_key, out.coordinate_map_key, kernel_size=2)
    assert kmap.kernel_volume == 128


def test_geometry_replay_equals_eager_at_d7():
    from test_torch_replay import assert_same_maps

    net = THighDimUNet(3, 20, 7).eval()

    def eager(c):
        x = MT.SparseTensor(torch.zeros(len(c), 3), torch.from_numpy(c))
        with torch.no_grad():
            net(x)
        return x.coordinate_manager

    clouds = [np.pad(lifted_cloud(s)[0], ((0, 0), (1, 0))) for s in range(5)]  # batch 0
    replayer = MT.GeometryReplayer(eager(clouds[0]))
    for c in clouds[1:3]:
        replayer(torch.from_numpy(c))
    crep = MT.CompiledReplayer(eager(clouds[0])).adopt(replayer)
    c = clouds[3]
    padded = torch.zeros(MT.coords.bucket_capacity(len(c)), 8, dtype=torch.int32)
    padded[: len(c)] = torch.from_numpy(c)
    crep.trace(padded, torch.tensor(len(c)))  # the device constants, once
    with no_host_sync():
        _, _, ok = crep.trace(padded, torch.tensor(len(c)))
    assert bool(ok)
    geos = []
    for c in clouds[3:]:
        want = eager(c)
        assert_same_maps(replayer(torch.from_numpy(c)), want)
        geo, _, ok = crep.run(torch.from_numpy(c))
        assert ok and geo.maps[geo.entry_key_tuple].keys.shape[1] == tkeys.n_words(7) == 2
        assert_same_maps(MT.CoordinateManager.from_geometry(geo), want)
        geos.append((geo, want))
    # stacking pads (N, L) keys with PAD_KEY rows; indexing cuts them back
    stacked = MT.stack_geometries([g for g, _ in geos])
    keys = stacked.maps[stacked.entry_key_tuple].keys
    rows = [g.maps[g.entry_key_tuple].keys.shape[0] for g, _ in geos]
    assert keys.shape == (len(geos), max(rows), 2)
    for i, (_, want) in enumerate(geos):
        assert int(tkeys.is_pad(keys[i]).sum()) == max(rows) - rows[i]
        got = MT.coords.index_geometry(stacked, i)
        assert_same_maps(MT.CoordinateManager.from_geometry(got), want)
