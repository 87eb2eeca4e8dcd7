"""Port parity for replay itself: the sync, deferred and traced modes
against the JAX package's replay and the port's eager manager, the
fixed-capacity unique, the capacity and Kmax floors, and every op kind the
oplog records.

Clouds as in ``tests/test_torch_geometry.py`` (~300 points from a seed),
MinkUNet14A(3, 4, D=3).  Every comparison is exact: coordinates, packed
keys and index maps index for index (the kernels' results depend on the
row order, so equal within a tolerance would not do).  "No host sync" is
checked on the CPU by running the code with every tensor-to-host read
(``bool``, ``int``, ``item``, ``tolist``, ``nonzero``, boolean-mask
indexing, ``unique``) patched to fail.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch
from flax import nnx

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.models import MinkUNet14A as JMinkUNet14A
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.coords import CapacityFloorExceeded, UntraceableReplay
from minkowskiengine_tpu_torch.coords.keys import PAD_KEY
from minkowskiengine_tpu_torch.coords.unique import unique_from_keys, unique_padded
from minkowskiengine_tpu_torch.models import MinkUNet14A

from test_torch_geometry import cloud, recorded

CPU = torch.device("cpu")


@contextlib.contextmanager
def no_host_sync():
    """Fail on any read of a tensor's value by the host."""

    def fail(*args, **kwargs):
        raise AssertionError("host sync")

    getitem = torch.Tensor.__getitem__

    def checked_getitem(self, index):
        parts = index if isinstance(index, tuple) else (index,)
        if any(isinstance(p, torch.Tensor) and p.dtype == torch.bool for p in parts):
            fail()
        return getitem(self, index)

    with contextlib.ExitStack() as stack:
        for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "nonzero"):
            stack.enter_context(mock.patch.object(torch.Tensor, name, fail))
        stack.enter_context(mock.patch.object(torch.Tensor, "__getitem__", checked_getitem))
        for name in ("nonzero", "unique", "masked_select", "argwhere"):
            stack.enter_context(mock.patch.object(torch, name, fail))
        yield


@pytest.fixture(scope="module")
def warm():
    jnet = JMinkUNet14A(3, 4, D=3, rngs=nnx.Rngs(0))
    tnet = MinkUNet14A(3, 4, D=3, device="cpu").eval()
    jmgr, tmgr = recorded(jnet, tnet)
    replayer = MT.GeometryReplayer(tmgr)
    for s in (1, 2, 3):  # settle the floors
        replayer(torch.from_numpy(cloud(s)[0]))
    return tnet, jmgr, tmgr, replayer


def eager(tnet, c):
    """The port's eager manager after a forward on ``c``."""
    x = MT.SparseTensor(torch.zeros(len(c), 3), torch.from_numpy(c), device="cpu")
    with torch.no_grad():
        tnet(x)
    return x.coordinate_manager


def assert_same_maps(got, want):
    """Port managers: same keys, coordinates, packed keys, kernel maps and
    stride maps, index for index."""
    assert list(got._maps) == list(want._maps)
    for k, m in want._maps.items():
        assert torch.equal(got._maps[k].coordinates, m.coordinates), k
        assert torch.equal(got._maps[k].keys, m.keys), k
    assert set(got._kernel_maps) == set(want._kernel_maps)
    for k, km in want._kernel_maps.items():
        g = got._kernel_maps[k]
        assert torch.equal(g.in_idx, km.in_idx) and torch.equal(g.out_idx_t, km.out_idx_t), k[:2]
        assert (g.n_in, g.n_out) == (km.n_in, km.n_out)
    assert set(got._stride_maps) == set(want._stride_maps)
    for k, sm in want._stride_maps.items():
        assert torch.equal(got._stride_maps[k], sm), k
    assert got._origin_keys == want._origin_keys


def replay(mode, log, floors, c, tmgr):
    """A port manager replayed in ``mode`` on ``c`` (the traced mode through
    CompiledReplayer, whose finalized geometry comes back as a view)."""
    c = torch.from_numpy(c)
    if mode == "sync":
        return MT.CoordinateManager.replay(log, c, deferred=False, device=CPU)
    if mode == "deferred":  # no fallback to the sync replay: floors must hold
        return MT.CoordinateManager._replay_once(log, c, floors, True, None, 1.0, CPU)
    crep = MT.CompiledReplayer(tmgr)
    crep.cap_floors = dict(floors)
    geo, _, ok = crep.run(c)
    assert ok and crep.captures == 0  # no graph on the CPU
    return MT.CoordinateManager.from_geometry(geo)


@pytest.mark.parametrize("mode", ["sync", "deferred", "traced"])
def test_replayed_maps_match_jax_and_eager(warm, mode):
    tnet, jmgr, tmgr, replayer = warm
    jlog = jmgr.oplog()
    for seed in (4, 5):
        c, _ = cloud(seed)
        got = replay(mode, tmgr.oplog(), replayer.cap_floors, c, tmgr)
        assert_same_maps(got, eager(tnet, c))
        jm = ME.CoordinateManager.replay(jlog, c)
        assert list(got._maps) == list(jm._maps)
        for k, m in got._maps.items():
            np.testing.assert_array_equal(m.coordinates.numpy(), np.asarray(jm.get_coordinates(
                ME.CoordinateMapKey(*k))))
        for k, km in got._kernel_maps.items():
            jk = jm._kernel_maps[k]
            np.testing.assert_array_equal(km.in_idx.numpy(), np.asarray(jk.in_idx)[:, : km.n_out])
            np.testing.assert_array_equal(km.out_idx_t.numpy(),
                                          np.asarray(jk.out_idx_t)[:, : km.n_in])


@pytest.mark.parametrize("valid_rows", ["prefix", "scattered"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unique_padded_equals_unique_from_keys(seed, valid_rows):
    rng = np.random.RandomState(seed)
    keys = torch.from_numpy(rng.randint(-(2**62), 2**62, 60)[rng.randint(0, 60, 500)])
    if valid_rows == "prefix":
        valid = torch.arange(500) < 420
    else:
        valid = torch.from_numpy(rng.rand(500) < 0.8)
    with no_host_sync():
        got = unique_padded(keys, valid, 64)
    want = unique_from_keys(keys[valid])
    n = int(got.count)
    rows = valid.nonzero().flatten()
    assert n == len(want.sorted_keys) <= 60
    assert torch.equal(got.sorted_keys[:n], want.sorted_keys)
    assert torch.equal(got.unique_map[:n], rows[want.unique_map])
    assert torch.equal(got.inverse_map[valid], want.inverse_map)
    assert (got.sorted_keys[n:] == PAD_KEY).all() and (got.unique_map[n:] == -1).all()
    assert (got.inverse_map[~valid] == -1).all()


def test_unique_padded_reports_a_count_past_its_capacity():
    keys = torch.arange(300, 0, -1)
    got = unique_padded(keys, torch.ones(300, dtype=torch.bool), 128)
    assert int(got.count) == 300
    assert torch.equal(got.sorted_keys, torch.arange(1, 129))
    assert torch.equal(got.unique_map, torch.arange(299, 171, -1))


def test_traced_replay_makes_no_host_sync(warm):
    _, _, tmgr, replayer = warm
    crep = MT.CompiledReplayer(tmgr).adopt(replayer)
    c, f = cloud(6)
    cap = MT.coords.bucket_capacity(len(c))
    cp = torch.zeros(cap, 4, dtype=torch.int32)
    cp[: len(c)] = torch.from_numpy(c)
    fp = torch.zeros(cap, 3)
    fp[: len(c)] = torch.from_numpy(f)
    crep.trace(cp, torch.tensor(len(c)), fp)  # the device constants, once
    with no_host_sync():
        mgr, feats, ok = crep.trace(cp, torch.tensor(len(c)), fp)
    assert bool(ok) and feats.shape == (cap, 3)
    assert all(isinstance(m, MT.coords.map.PaddedCoordinateMap) for m in mgr._maps.values())


def test_traced_replay_needs_floors(warm):
    _, _, tmgr, _ = warm
    crep = MT.CompiledReplayer(tmgr)
    crep.cap_floors = {}
    c = torch.from_numpy(cloud(6)[0])
    with pytest.raises(UntraceableReplay):
        crep.run(c)
    geo, _ = crep(c)  # __call__ recovers through the sync replay
    assert crep.recoveries == 1 and crep.cap_floors and geo.entry_key == tmgr._entry_key


def test_capacity_floor_ratchets_across_a_larger_cloud(warm):
    _, _, tmgr, replayer = warm
    rep = MT.GeometryReplayer(tmgr)
    rep.cap_floors = dict(replayer.cap_floors)
    entry = tmgr._entry_key.get_key()
    big, _ = cloud(9, n=3000, hi=28)
    assert len(big) > rep.cap_floors[entry]
    mgr = rep(torch.from_numpy(big))  # the deferred floor fails; the sync replay ratchets
    assert mgr.size(mgr._entry_key) == len(big)
    assert rep.cap_floors[entry] >= len(big)
    small = torch.from_numpy(cloud(10)[0])
    deferred = MT.CoordinateManager._replay_once(rep.oplog, small, rep.cap_floors, True, None,
                                                1.0, CPU)
    assert deferred.size(deferred._entry_key) == len(small)
    with pytest.raises(CapacityFloorExceeded):
        MT.CoordinateManager._replay_once(rep.oplog, torch.from_numpy(big), replayer.cap_floors,
                                          True, None, 1.0, CPU)


def test_lowered_floor_fails_the_check_and_recover_equals_eager(warm):
    """The port's counterpart of TestFloorViolationRecovery: a strided
    level's floor below its count makes ``traced_ok()`` false; ``recover``
    ratchets, bumps the version and the next run holds."""
    tnet, _, tmgr, replayer = warm
    crep = MT.CompiledReplayer(tmgr).adopt(replayer)
    level = ((2, 2, 2), "")
    crep.cap_floors[level] = 16
    c = torch.from_numpy(cloud(7)[0])
    mgr, _, ok = crep.trace(c, torch.tensor(len(c)))
    assert not bool(ok)
    assert crep.run(c) == (None, None, False)
    version = crep._version
    geo, _ = crep.recover(c)
    assert crep._version == version + 1 and crep.recoveries == 1
    want = eager(tnet, c.numpy())
    assert crep.cap_floors[level] >= want.size(MT.CoordinateMapKey(*level))
    assert_same_maps(MT.CoordinateManager.from_geometry(geo), want)
    geo, _, ok = crep.run(c)
    assert ok
    assert_same_maps(MT.CoordinateManager.from_geometry(geo), want)


def op_kinds(pkg, mgr, coords):
    """Every op kind the oplog knows: stride, both pooling fast paths
    (stride_map + kernel_map), stride_region forward and transposed
    (expanding), origin, origin_map, merge, and the dense plans their
    grid probes record."""
    key, _ = mgr.insert_and_map(coords)
    s2 = mgr.stride(key, 2)
    mgr.kernel_map(key, s2, stride=2, kernel_size=2, is_pool=True)
    mgr.kernel_map(s2, key, stride=2, kernel_size=2, is_transpose=True, is_pool=True)
    kg = pkg.KernelGenerator(kernel_size=3, stride=2, dimension=3)
    down = mgr.stride_region(key, kg.get_kernel((1, 1, 1), False), (2, 2, 2), True, False)
    up = mgr.stride_region(s2, kg.get_kernel((2, 2, 2), True), (1, 1, 1), True, True)
    mgr.origin_map(up)
    merged = mgr.merge([key, up])
    mgr.kernel_map(merged, down, stride=2, kernel_size=3)
    return mgr


@pytest.fixture(scope="module")
def op_recipe():
    c, _ = cloud(0, n=200, hi=12)
    tmgr = op_kinds(MT, MT.CoordinateManager(D=3, device="cpu"), c)
    jmgr = op_kinds(ME, ME.CoordinateManager(D=3), c)
    replayer = MT.GeometryReplayer(tmgr)
    for s in (1, 2, 3, 4):  # the floors of the clouds replayed below
        replayer(torch.from_numpy(cloud(s, n=200, hi=12)[0]))
    return tmgr, jmgr, replayer


def test_op_kinds_record_jax_entries(op_recipe):
    tmgr, jmgr, _ = op_recipe
    assert tmgr.oplog() == jmgr.oplog()
    assert {e[0] for e in tmgr.oplog()} == {
        "insert", "stride", "stride_map", "kernel_map", "stride_region", "origin", "origin_map",
        "merge", "dense_plan",
    }


@pytest.mark.parametrize("mode", ["sync", "deferred", "traced"])
def test_op_kinds_replay_equals_eager(op_recipe, mode):
    tmgr, _, replayer = op_recipe
    for seed in (3, 4):
        c, _ = cloud(seed, n=200, hi=12)
        want = op_kinds(MT, MT.CoordinateManager(D=3, device="cpu"), c)
        assert_same_maps(replay(mode, tmgr.oplog(), replayer.cap_floors, c, tmgr), want)


def test_kmax_floor_is_checked(op_recipe):
    """A pooling map's Kmax floor below this cloud's most inputs per voxel:
    the traced check fails, the deferred replay raises, and the sync
    replay (``replay``'s fallback) equals eager."""
    tmgr, _, replayer = op_recipe
    floors = dict(replayer.cap_floors)
    kmax_keys = [k for k in floors if k[0] == "kmax"]
    assert len(kmax_keys) == 1  # the transposed pooling map is the forward one swapped
    for k in kmax_keys:
        floors[k] = 1
    c = torch.from_numpy(cloud(5, n=200, hi=12)[0])
    crep = MT.CompiledReplayer(tmgr)
    crep.cap_floors = floors
    assert not bool(crep.trace(c, torch.tensor(len(c)))[2])
    with pytest.raises(CapacityFloorExceeded):
        MT.CoordinateManager._replay_once(tmgr.oplog(), c, floors, True, None, 1.0, CPU)
    got = MT.CoordinateManager.replay(tmgr.oplog(), c, cap_floors=floors, device=CPU)
    assert_same_maps(got, op_kinds(MT, MT.CoordinateManager(D=3, device="cpu"), c.numpy()))
    assert all(got._cap_floors[k] > 1 for k in kmax_keys)


def test_replay_rejects_a_diverging_recipe(warm):
    _, _, tmgr, _ = warm
    log = tmgr.oplog()
    log[0] = ("insert", (1, 1, 1), "", ((1, 1, 1), "other"))
    with pytest.raises(RuntimeError, match="diverged"):
        MT.CoordinateManager.replay(log, torch.from_numpy(cloud(1)[0]), device=CPU)
