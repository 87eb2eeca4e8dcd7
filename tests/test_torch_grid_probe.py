"""Port parity for the dense bbox grid's probe: every map built through a
row grid equals the map the key search builds and the JAX package's, index
for index.

The manager looks coordinates up in any map whose grid fits
``_MAX_GRID_CELLS`` (``coords/manager.py::_probe_grid_for``), on the CPU as
on the card, as JAX's does; setting the cap to 0 leaves every lookup to the
search.  Clouds are a few hundred rows from a seed with numpy, with
negative coordinates; a "misaligned" cloud has an odd minimum, so strided
and transposed bases fall below the probed map's bbox.  Every comparison
is exact: rows, index maps, plans, grid shapes (interpolation weights
within 1e-7, as ``tests/test_torch_interpolation.py`` holds them).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import minkowskiengine_tpu as ME
import minkowskiengine_tpu_torch as MT
import minkowskiengine_tpu_torch.coords.manager as TM
from minkowskiengine_tpu_torch.coords import CapacityFloorExceeded, UntraceableReplay
from minkowskiengine_tpu_torch.coords import grid as G
from minkowskiengine_tpu_torch.coords import kernel_map as KM
from minkowskiengine_tpu_torch.kernels import grid_probe as GP

from test_torch_replay import no_host_sync

CPU = torch.device("cpu")
W_ATOL = 1e-7
CUBE, CROSS = MT.RegionType.HYPER_CUBE, MT.RegionType.HYPER_CROSS


def cloud(D, seed, n=300, lo=-12, hi=12, misaligned=False, batches=2):
    rng = np.random.RandomState(seed)
    c = np.concatenate([rng.randint(0, batches, (n, 1)), rng.randint(lo, hi, (n, D))], 1)
    if misaligned:  # an odd minimum: no tested stride divides it
        c = np.concatenate([c, [[0] + [lo - 1] * D]])
    return np.unique(c.astype(np.int32), axis=0)


def port_manager(D):
    return MT.CoordinateManager(D=D, device="cpu")


def build(pkg, mgr, c, ks, stride, dil, transpose, region):
    """One kernel map through a manager of either package: stride-``stride``
    maps, then the map between them (the transposed map from the coarse
    map back to the fine one, built without its forward map)."""
    k1, _ = mgr.insert_and_map(c)
    k2 = mgr.stride(k1, stride)
    kw = dict(stride=stride, kernel_size=ks, dilation=dil, region_type=pkg.RegionType(int(region)))
    if transpose:
        return mgr, (k1, k2), mgr.kernel_map(k2, k1, is_transpose=True, **kw)
    return mgr, (k1, k2), mgr.kernel_map(k1, k2, **kw)


CASES = [
    # D, kernel size, stride, dilation, transposed, region, misaligned
    (3, 5, 1, 1, False, CUBE, True),
    (3, 1, 1, 1, False, CUBE, False),
    (3, 3, 1, 2, False, CUBE, True),
    (3, 2, 2, 1, False, CUBE, False),
    (3, 3, 2, 1, True, CUBE, True),
    (3, 3, 3, 1, False, CUBE, True),
    (3, 4, 4, 1, True, CUBE, False),
    (3, 3, 1, 1, False, CROSS, False),
    (2, 2, 2, 1, True, CUBE, True),
    (4, 3, 1, 1, False, CUBE, True),
]


@pytest.mark.parametrize("D,ks,stride,dil,transpose,region,misaligned", CASES)
def test_probe_maps_equal_search_and_jax(monkeypatch, D, ks, stride, dil, transpose, region,
                                         misaligned):
    c = cloud(D, seed=D, misaligned=misaligned, n=200 if D == 4 else 300)
    args = (c, ks, stride, dil, transpose, region)
    mgr, keys, got = build(MT, port_manager(D), *args)
    for k in keys:  # both maps went through their grids
        assert mgr._probe_grid_for(k) is not None
    monkeypatch.setattr(TM, "_MAX_GRID_CELLS", 0)
    smgr, _, search = build(MT, port_manager(D), *args)
    assert not smgr._row_grids
    _, _, jk = build(ME, ME.CoordinateManager(D=D), *args)
    assert torch.equal(got.in_idx, search.in_idx) and torch.equal(got.out_idx_t, search.out_idx_t)
    np.testing.assert_array_equal(got.in_idx.numpy(), np.asarray(jk.in_idx)[:, : got.n_out])
    np.testing.assert_array_equal(got.out_idx_t.numpy(), np.asarray(jk.out_idx_t)[:, : got.n_in])
    assert smgr.oplog() == mgr.oplog()


def _maps_of(pkg, mgr, c, samples):
    """Stride maps, an origin map, union maps and an interpolation map."""
    k1, _ = mgr.insert_and_map(c)
    k2 = mgr.stride(k1, 2)
    k4 = mgr.stride(k2, 2)
    ca = c[::2].copy()
    ca[:, 1:] *= 2
    ka, _ = mgr.insert_and_map(ca, tensor_stride=2, string_id="a")
    merged = mgr.merge([k2, ka])
    n1, n2, na = (mgr.size(k) for k in (k1, k2, ka))
    out = {
        "stride 1->4": mgr.stride_map(k1, k4)[:n1],
        "stride 2->4": mgr.stride_map(k2, k4)[:n2],
        "origin": mgr.origin_map(k2)[1][:n2],
    }
    ua, ub = mgr.union_map([k2, ka], merged)
    out["union"] = np.concatenate([np.asarray(ua)[:n2], np.asarray(ub)[:na]])
    out["interp rows"], out["interp weights"] = mgr.interpolation_map_weight(k2, samples)
    return mgr, out


def test_stride_origin_union_and_interpolation_maps_equal_search_and_jax(monkeypatch):
    c = cloud(3, seed=5, misaligned=True)
    rng = np.random.RandomState(1)
    samples = np.concatenate(
        [rng.randint(0, 2, (80, 1)), rng.uniform(-14, 14, (80, 3))], 1).astype(np.float32)
    mgr, got = _maps_of(MT, port_manager(3), c, samples)
    assert len(mgr._row_grids) >= 4  # strides 2 and 4, the origin and the merged map
    monkeypatch.setattr(TM, "_MAX_GRID_CELLS", 0)
    _, search = _maps_of(MT, port_manager(3), c, samples)
    _, want = _maps_of(ME, ME.CoordinateManager(D=3), c, samples)
    for name in got:
        g, s, w = (np.asarray(m) for m in (got[name], search[name], want[name]))
        if name == "interp weights":
            np.testing.assert_allclose(g, w, rtol=0, atol=W_ATOL)
            np.testing.assert_array_equal(g, s)
        else:
            np.testing.assert_array_equal(g, s, err_msg=name)
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_field_maps_through_the_grid_equal_search(monkeypatch):
    rng = np.random.RandomState(3)
    pts = np.concatenate([rng.randint(0, 2, (400, 1)), rng.uniform(-9, 9, (400, 3))], 1)

    def field_maps():
        mgr = port_manager(3)
        fk = mgr.insert_field(torch.from_numpy(pts.astype(np.float32)))
        sk, _ = mgr.field_to_sparse_insert_and_map(fk, 1)
        sk2, _ = mgr.field_to_sparse_insert_and_map(fk, 2)
        return mgr, mgr.field_to_sparse_map(fk, sk2), mgr.origin_field_map(fk)[1]

    mgr, f2s, origin = field_maps()
    assert mgr._row_grids
    monkeypatch.setattr(TM, "_MAX_GRID_CELLS", 0)
    _, f2s_s, origin_s = field_maps()
    assert torch.equal(f2s, f2s_s) and torch.equal(origin, origin_s)


def test_plans_equal_jax():
    """Grid shapes, row cells and minima of every map's plan, at strides 1-4
    and on a pruned map."""
    c = cloud(3, seed=7, misaligned=True)
    tm, jm = port_manager(3), ME.CoordinateManager(D=3)
    keys = []
    for mgr in (tm, jm):
        k1, _ = mgr.insert_and_map(c)
        ks = [k1, mgr.stride(k1, 2), mgr.stride(k1, 3), mgr.stride(k1, 4)]
        ks.append(mgr.origin(k1))
        keys.append(ks)
    for tk, jk in zip(*keys):
        tp, jp = tm.dense_plan(tk), jm.dense_plan(jk)
        n = tm.size(tk)
        assert tp.grid_shape == jp.grid_shape and tp.cells == jp.cells
        np.testing.assert_array_equal(tp.flat_idx.numpy(), np.asarray(jp.flat_idx)[:n])
        np.testing.assert_array_equal(tp.mins.numpy(), np.asarray(jp.mins))
    assert tm.oplog() == jm.oplog()
    keep = np.random.RandomState(0).rand(tm.size(keys[0][0])) < 0.5
    pk, _, _ = tm.prune(keys[0][0], torch.from_numpy(keep))
    jpk, _, _ = jm.prune(keys[1][0], keep)
    tp, jp = tm.dense_plan(pk), jm.dense_plan(jpk)
    assert tp.grid_shape == jp.grid_shape
    np.testing.assert_array_equal(tp.flat_idx.numpy(), np.asarray(jp.flat_idx)[: tm.size(pk)])


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_grid_module_plan_and_row_grid_equal_jax(D):
    """``coords/grid.py`` on a map, without the manager, against the plan
    and row grid the JAX manager builds: grid shape, cells and minima, and
    the row grid cell for cell."""
    c = cloud(D, seed=40 + D, n=150, misaligned=True)
    stride = 1 if D % 2 else 2
    tm, jm = port_manager(D), ME.CoordinateManager(D=D)
    tk, jk = (mgr.stride(mgr.insert_and_map(c)[0], stride) for mgr in (tm, jm))
    tmap = tm._get_map(tk)
    tp, jp = G.build_dense_plan(tmap), jm.dense_plan(jk)
    assert tp.grid_shape == jp.grid_shape and tp.cells == jp.cells
    np.testing.assert_array_equal(tp.flat_idx.numpy(), np.asarray(jp.flat_idx)[: tmap.size])
    np.testing.assert_array_equal(tp.mins.numpy(), np.asarray(jp.mins))
    grid = G.build_row_grid(tp.flat_idx, tp.cells)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jm._probe_grid_for(jk)[0]))
    assert grid[-1] == -1 and int((grid >= 0).sum()) == tmap.size


def test_grid_module_gives_an_empty_map_no_plan():
    tm, jm = port_manager(3), ME.CoordinateManager(D=3)
    c = cloud(3, seed=45)
    tk, _ = tm.insert_and_map(c)
    jk, _ = jm.insert_and_map(c)
    none = np.zeros(len(c), bool)
    tpk, _, _ = tm.prune(tk, torch.from_numpy(none))
    jpk, _, _ = jm.prune(jk, none)
    assert tm.size(tpk) == 0
    assert G.build_dense_plan(tm._get_map(tpk)) is None and tm.dense_plan(tpk) is None
    assert jm.dense_plan(jpk) is None


def test_grid_module_traced_plan_at_the_eager_floor_equals_the_eager_plan():
    """At a floor equal to the eager grid shape, the traced plan is the
    eager plan and its check holds; a floor one cell short fails it."""
    c = cloud(3, seed=46, misaligned=True)
    mgr = port_manager(3)
    key = mgr.stride(mgr.insert_and_map(c)[0], 2)
    m = mgr._get_map(key)
    eager = G.build_dense_plan(m)
    bbox = G.bbox_values(m.coordinates, m.valid_mask()).view(2, -1)
    traced, ok = G.build_dense_plan_traced(m, bbox, eager.grid_shape)
    assert bool(ok) and traced.grid_shape == eager.grid_shape
    assert torch.equal(traced.flat_idx, eager.flat_idx) and torch.equal(traced.mins, eager.mins)
    extents = (np.asarray(bbox[1, 1:]) - np.asarray(bbox[0, 1:])) // 2 + 1
    short = (eager.grid_shape[0], int(extents[0]) - 1) + eager.grid_shape[2:]
    assert not bool(G.build_dense_plan_traced(m, bbox, short)[1])


def test_seven_dimensional_cloud_keeps_the_search():
    """At D = 7 the smallest grid (16 cells a side) is over the cap: no
    probe in either package, the plans still equal and recorded, the maps
    equal JAX's."""
    c = cloud(7, seed=2, n=120, lo=-3, hi=3)
    tm, jm = port_manager(7), ME.CoordinateManager(D=7)
    out = []
    for mgr in (tm, jm):
        k1, _ = mgr.insert_and_map(c)
        k2 = mgr.stride(k1, 2)
        out.append((mgr, k1, k2, mgr.kernel_map(k1, k2, stride=2, kernel_size=2)))
    (_, tk1, tk2, tkm), (_, jk1, jk2, jkm) = out
    assert tm._probe_grid_for(tk1) is None and jm._probe_grid_for(jk1) is None
    assert not tm._row_grids and tm.oplog() == jm.oplog()
    np.testing.assert_array_equal(tkm.in_idx.numpy(), np.asarray(jkm.in_idx)[:, : tkm.n_out])
    np.testing.assert_array_equal(tkm.out_idx_t.numpy(), np.asarray(jkm.out_idx_t)[:, : tkm.n_in])
    tp, jp = tm.dense_plan(tk2), jm.dense_plan(jk2)
    assert tp.grid_shape == jp.grid_shape
    np.testing.assert_array_equal(tp.flat_idx.numpy(), np.asarray(jp.flat_idx)[: tm.size(tk2)])


def recipe(mgr, c):
    """A coordinate phase touching every probe: kernel maps (stride 1, 2,
    transposed), a pooling fast path, an origin map."""
    k1, _ = mgr.insert_and_map(c)
    k2 = mgr.stride(k1, 2)
    mgr.kernel_map(k1, k1, kernel_size=3)
    mgr.kernel_map(k1, k2, stride=2, kernel_size=2)
    mgr.kernel_map(k2, k2, kernel_size=3)
    mgr.kernel_map(k2, k1, stride=2, kernel_size=2, is_transpose=True)
    k4 = mgr.stride(k2, 2)
    mgr.kernel_map(k2, k4, stride=2, kernel_size=2, is_pool=True)
    mgr.origin_map(k4)
    return mgr


@pytest.fixture(scope="module")
def recorded():
    c = cloud(3, seed=20)
    tmgr = recipe(port_manager(3), c)
    jmgr = recipe(ME.CoordinateManager(D=3), c)
    replayer = MT.GeometryReplayer(tmgr)
    for s in (21, 22, 23):
        replayer(torch.from_numpy(cloud(3, seed=s)))
    return tmgr, jmgr, replayer


def same_plans(got, want_plans, rows):
    assert set(got) == set(want_plans)
    for k, p in want_plans.items():
        g = got[k]
        assert g.grid_shape == p.grid_shape, k
        np.testing.assert_array_equal(g.flat_idx.numpy(), np.asarray(p.flat_idx)[: rows[k]])
        np.testing.assert_array_equal(g.mins.numpy(), np.asarray(p.mins))


@pytest.mark.parametrize("mode", ["sync", "deferred", "traced"])
def test_replay_with_grid_floors_equals_eager_and_jax(recorded, mode):
    """Each mode's maps equal the eager manager's; its plans (at the
    floors' grid shapes) equal JAX's sync replay with the same floors."""
    from test_torch_replay import assert_same_maps

    tmgr, jmgr, replayer = recorded
    assert tmgr.oplog() == jmgr.oplog()
    assert {e[0] for e in tmgr.oplog()} >= {"dense_plan", "stride_map", "origin_map"}
    for seed in (24, 25):
        c = cloud(3, seed=seed)
        tc = torch.from_numpy(c)
        if mode == "sync":
            got = MT.CoordinateManager.replay(tmgr.oplog(), tc, deferred=False, device=CPU)
        elif mode == "deferred":  # no fallback: the floors must hold
            got = MT.CoordinateManager._replay_once(
                tmgr.oplog(), tc, replayer.cap_floors, True, None, 1.0, CPU, replayer.grid_floors)
        else:
            crep = MT.CompiledReplayer(tmgr).adopt(replayer)
            geo, _, ok = crep.run(tc)
            assert ok
            got = MT.CoordinateManager.from_geometry(geo)
        assert_same_maps(got, recipe(port_manager(3), c))
        if mode == "sync":
            continue
        rows = {k: m.size for k, m in got._maps.items()}
        jm = ME.CoordinateManager.replay(
            jmgr.oplog(), c, grid_floors=dict(replayer.grid_floors), deferred=False)
        want = {k: jm.dense_plan(ME.CoordinateMapKey(*k)) for k in got._dense_plans}
        same_plans(got._dense_plans, want, rows)


def test_traced_replay_with_grids_makes_no_host_sync(recorded):
    tmgr, _, replayer = recorded
    crep = MT.CompiledReplayer(tmgr).adopt(replayer)
    c = torch.from_numpy(cloud(3, seed=26))
    cp = torch.zeros(MT.coords.bucket_capacity(len(c)), 4, dtype=torch.int32)
    cp[: len(c)] = c
    crep.trace(cp, torch.tensor(len(c)))  # the device constants, once
    with no_host_sync():
        mgr, _, ok = crep.trace(cp, torch.tensor(len(c)))
    assert bool(ok) and mgr._row_grids and mgr._deferred["grid_checks"]


def test_grid_floor_below_the_extent_fails_the_check_and_recovers(recorded):
    tmgr, _, replayer = recorded
    entry = tmgr._entry_key.get_key()
    c = torch.from_numpy(cloud(3, seed=27))
    want = recipe(port_manager(3), c.numpy())
    low = dict(replayer.grid_floors)
    low[entry] = (2, 16, 16, 16)
    crep = MT.CompiledReplayer(tmgr).adopt(replayer)
    crep.grid_floors = dict(low)
    assert not bool(crep.trace(c, torch.tensor(len(c)))[2])
    with pytest.raises(CapacityFloorExceeded):
        MT.CoordinateManager._replay_once(
            tmgr.oplog(), c, replayer.cap_floors, True, None, 1.0, CPU, low)
    geo, _ = crep(c)  # run fails its check; recover ratchets the floor
    assert crep.recoveries == 1 and crep.grid_floors[entry] > low[entry]
    from test_torch_replay import assert_same_maps

    assert_same_maps(MT.CoordinateManager.from_geometry(geo), want)
    geo, _, ok = crep.run(c)
    assert ok


def test_traced_replay_needs_grid_floors(recorded):
    tmgr, _, replayer = recorded
    c = torch.from_numpy(cloud(3, seed=28))
    with pytest.raises(UntraceableReplay):
        MT.CoordinateManager.replay(tmgr.oplog(), c, cap_floors=replayer.cap_floors, traced=True,
                                    n_valids=[torch.tensor(len(c))], device=CPU)


def test_geometry_dense_plans_round_trip(recorded):
    tmgr, _, _ = recorded
    replayer = MT.GeometryReplayer(tmgr)
    geos = [replayer(torch.from_numpy(cloud(3, seed=s, hi=12 + 4 * i))).export_geometry()
            for i, s in enumerate((30, 31))]
    geo = geos[0]
    assert geo.dense_plans and all(p is not None for p in geo.dense_plans.values())
    view = MT.CoordinateManager.from_geometry(geo)
    for k, p in geo.dense_plans.items():
        assert view.dense_plan(MT.CoordinateMapKey(*k)) is p
    moved = geo.to("cpu")
    stacked = MT.coords.stack_geometries(geos)
    for i, g in enumerate(geos):
        back = MT.coords.index_geometry(stacked, i)
        for k, p in g.dense_plans.items():
            for other in (back.dense_plans[k], moved.dense_plans[k] if i == 0 else p):
                assert other.grid_shape == p.grid_shape
                assert torch.equal(other.flat_idx, p.flat_idx) and torch.equal(other.mins, p.mins)


def count_host_reads(fn):
    """How often ``fn`` reads a tensor's value on the host."""
    n = [0]
    saved = {name: getattr(torch.Tensor, name) for name in ("tolist", "item", "__bool__", "nonzero")}

    def counting(name):
        def call(*a, **k):
            n[0] += 1
            return saved[name](*a, **k)
        return call

    try:
        for name in saved:
            setattr(torch.Tensor, name, counting(name))
        fn()
    finally:
        for name, f in saved.items():
            setattr(torch.Tensor, name, f)
    return n[0]


def test_the_grid_adds_no_host_read(monkeypatch):
    """The bbox comes in the transfer that reads each map's count."""
    c = cloud(3, seed=40, misaligned=True)

    def phase():
        mgr = recipe(port_manager(3), c)
        keep = torch.arange(mgr.size(mgr._entry_key)) % 3 > 0
        pk, _, _ = mgr.prune(mgr._entry_key, keep)
        mgr.kernel_map(pk, pk, kernel_size=3)

    with_grid = count_host_reads(phase)
    monkeypatch.setattr(TM, "_MAX_GRID_CELLS", 0)
    assert count_host_reads(phase) == with_grid


# --- the route each half of a kernel map takes (build_kernel_map) --------


def route_deltas(fn):
    """(fn's result, the halves built by each route, kernel launches)."""
    before, launches = dict(KM.build_kernel_map.route_builds), GP.grid_probe.launches
    out = fn()
    routes = {k: v - before[k] for k, v in KM.build_kernel_map.route_builds.items()}
    return out, routes, GP.grid_probe.launches - launches


def test_a_cpu_map_takes_the_plain_version_and_launches_nothing():
    c = cloud(3, seed=50, misaligned=True)
    mgr, (k1, k2), km = route_deltas(lambda: build(MT, port_manager(3), c, 3, 2, 1, False, CUBE))[0]
    _, routes, launches = route_deltas(lambda: mgr.kernel_map(k1, k1, kernel_size=3))
    assert routes == {"kernel": 0, "ops": 2, "search": 0} and launches == 0
    a, b = mgr._get_map(k1), mgr._get_map(k2)
    offs = TM.region_offsets_for(CUBE, (3,) * 3, (1,) * 3, a.tensor_stride, None)
    offs = np.concatenate([np.zeros((len(offs), 1), np.int64), offs], 1)
    assert torch.equal(km.in_idx, KM._build_in_idx_grid(mgr._probe_grid_for(k1), b.coordinates, offs))
    assert torch.equal(km.out_idx_t,
                       KM._build_in_idx_grid(mgr._probe_grid_for(k2), a.coordinates, -offs))


@pytest.mark.parametrize("probes", ["both", "in", "out", "none"])
def test_each_half_takes_its_route(probes):
    """A half with a grid takes the plain version on the CPU; a half
    without one the search (``in_idx``) or the inverted matching
    (``out_idx_t``); every route gives the search's map."""
    mgr = port_manager(3)
    k1, _ = mgr.insert_and_map(cloud(3, seed=51, misaligned=True))
    k2 = mgr.stride(k1, 2)
    a, b = mgr._get_map(k1), mgr._get_map(k2)
    offs = TM.region_offsets_for(CUBE, (2,) * 3, (1,) * 3, a.tensor_stride, None)
    pa = mgr._probe_grid_for(k1) if probes in ("both", "in") else None
    pb = mgr._probe_grid_for(k2) if probes in ("both", "out") else None
    km, routes, launches = route_deltas(lambda: KM.build_kernel_map(a, b, offs, pa, pb))
    ops = (pa is not None) + (pb is not None)
    assert routes == {"kernel": 0, "ops": ops, "search": 2 - ops} and launches == 0
    want = KM.build_kernel_map(a, b, offs)
    assert torch.equal(km.in_idx, want.in_idx) and torch.equal(km.out_idx_t, want.out_idx_t)


def test_smoke_phase_47_rebuilds_each_forward_map_equal_to_the_managers():
    """``chip_smoke.py``'s phase 47 builds each cached forward map again
    through ``build_kernel_map`` and through the plain version; on the CPU
    both are the plain route and give the manager's map index for index,
    and the bound counts 2 K N int32 written and D + 1 read a row."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    mgr = port_manager(3)
    k1, _ = mgr.insert_and_map(cloud(3, seed=53, misaligned=True))
    k2 = mgr.stride(k1, 2)
    mgr.kernel_map(k1, k1, kernel_size=5)
    mgr.kernel_map(k1, k2, stride=2, kernel_size=2)
    mgr.kernel_map(k2, k1, stride=2, kernel_size=2, is_transpose=True)
    mgr.kernel_map(k2, k2, kernel_size=3)
    forward = [ck for ck in mgr._kernel_maps if not ck[6]]
    assert len(forward) == 3
    for ck in forward:
        km = mgr._kernel_maps[ck]
        kernel, plain, bound_ms = cs.probe_routes(mgr, ck)
        for got in (kernel(), plain()):
            assert torch.equal(got[0], km.in_idx) and torch.equal(got[1], km.out_idx_t)
        rows = km.n_in + km.n_out
        assert bound_ms == pytest.approx((4 * km.kernel_volume + 16) * rows / cs.HBM_BYTES_PER_MS)


def test_maps_over_the_cap_take_the_search(monkeypatch):
    monkeypatch.setattr(TM, "_MAX_GRID_CELLS", 0)
    c = cloud(3, seed=52)
    _, routes, launches = route_deltas(lambda: build(MT, port_manager(3), c, 3, 1, 1, False, CUBE))
    assert routes == {"kernel": 0, "ops": 0, "search": 2} and launches == 0


def probe_half(D=3, n=10, K=4, cells=(2, 16, 16, 16), ts=(1, 1, 1)):
    """A well-formed half on the CPU, which the kernel refuses only for its
    device."""
    grid = torch.full((int(np.prod(cells)) + 1,), -1, dtype=torch.int32)
    return GP.Half((grid, torch.zeros(D + 1, dtype=torch.int32), cells, ts),
                   torch.zeros(n, D + 1, dtype=torch.int32),
                   torch.zeros(K, D + 1, dtype=torch.int32), torch.ones(n, dtype=torch.bool))


def _swap(h, **kw):
    return h._replace(**kw)


def _probe(h, i, value):
    p = list(h.probe)
    p[i] = value
    return h._replace(probe=tuple(p))


REFUSALS = {
    "no half": (lambda h: (), ValueError, "one or two halves"),
    "three halves": (lambda h: (h, h, h), ValueError, "one or two halves"),
    "int64 rows": (lambda h: (_swap(h, coords=h.coords.long()),), TypeError, "int32"),
    "rows not contiguous": (lambda h: (_swap(h, coords=torch.zeros(4, 10, dtype=torch.int32).T),),
                            ValueError, "contiguous"),
    "D = 7": (lambda h: (_swap(h, coords=torch.zeros(10, 8, dtype=torch.int32)),), ValueError,
              "D = 1..6"),
    "offsets of D = 2": (lambda h: (_swap(h, offsets=torch.zeros(4, 3, dtype=torch.int32)),),
                         ValueError, "not \\(K, 4\\)"),
    "valid of 9 rows": (lambda h: (_swap(h, valid=torch.ones(9, dtype=torch.bool)),), ValueError,
                        "valid has 9 rows"),
    "valid as int": (lambda h: (_swap(h, valid=torch.ones(10, dtype=torch.int32)),), TypeError,
                     "bool"),
    "three minima": (lambda h: (_probe(h, 1, torch.zeros(3, dtype=torch.int32)),), ValueError,
                     "4 minima"),
    "a short row grid": (lambda h: (_probe(h, 0, h.probe[0][:-1]),), ValueError, "sentinel"),
    "stride 0": (lambda h: (_probe(h, 3, (1, 0, 1)),), ValueError, "below 1"),
    "halves of K 4 and 5": (lambda h: (h, _swap(h, offsets=torch.zeros(5, 4, dtype=torch.int32))),
                            ValueError, "share K and D"),
    "CPU tensors": (lambda h: (h, h), ValueError, "takes CUDA tensors"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_the_kernel_refuses_what_it_does_not_take(case):
    """``grid_probe`` checks every argument before it builds or launches
    anything: a CPU half is refused last, after its shapes and types."""
    make, error, message = REFUSALS[case]
    launches = GP.grid_probe.launches
    with pytest.raises(error, match=message):
        GP.grid_probe(*make(probe_half()))
    assert GP.grid_probe.launches == launches
