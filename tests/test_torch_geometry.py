"""Port parity for geometry replay: the recorded oplog, Geometry, the frozen
view, reduce_features and stacking, against the JAX package.

The clouds are ``tests/test_geometry.py``'s: ~300 points in two batches of
a 20^3 box, made with numpy from a seed, fed to both packages.  The models
are MinkUNet14A(3, 4, D=3) and a narrow MinkUNet34, with the JAX weights
carried to the port by ``export_reference_state_dict`` /
``load_state_dict_from_reference``.

Tolerances: recorded entries, string ids, coordinates and index maps are
compared exactly; logits through a Geometry against JAX's replayed step
within 2e-5 (rtol and atol), the bound ``tests/test_geometry.py`` holds
JAX's own replay to; reduce_features against JAX's within 1e-6 (a mean
of at most a few float32 rows, summed in another order).
"""

import jax
import numpy as np
import pytest
import torch
from flax import nnx

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.models import MinkUNet14A as JMinkUNet14A
from minkowskiengine_tpu.models import MinkUNet34 as JMinkUNet34
from minkowskiengine_tpu.types import SparseTensorQuantizationMode as JQ
from minkowskiengine_tpu.utils.torch_import import export_reference_state_dict
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.coords import index_geometry, squeeze_geometry
from minkowskiengine_tpu_torch.models import MinkUNet14A, MinkUNet34
from minkowskiengine_tpu_torch.types import SparseTensorQuantizationMode as Q
from minkowskiengine_tpu_torch.utils.torch_import import load_state_dict_from_reference

NARROW = dict(PLANES=(8, 16, 16, 16, 16, 16, 8, 8), INIT_DIM=8)


class JNarrow34(JMinkUNet34):
    PLANES, INIT_DIM = NARROW["PLANES"], NARROW["INIT_DIM"]


class TNarrow34(MinkUNet34):
    PLANES, INIT_DIM = NARROW["PLANES"], NARROW["INIT_DIM"]


def cloud(seed, n=300, hi=20):
    """``tests/test_geometry.py``'s cloud: unique (batch, x, y, z) rows and
    float32 features."""
    rng = np.random.RandomState(seed)
    c = np.unique(
        np.concatenate([rng.randint(0, 2, (n, 1)), rng.randint(0, hi, (n, 3))], axis=1)
        .astype(np.int32),
        axis=0,
    )
    return c, rng.randn(len(c), 3).astype(np.float32)


def recorded(jnet, tnet, seed=0):
    """Both packages' managers after one forward on ``cloud(seed)``."""
    c, f = cloud(seed)
    jx = ME.SparseTensor(f, c)
    jnet(jx)
    tx = MT.SparseTensor(torch.from_numpy(f), torch.from_numpy(c), device="cpu")
    with torch.no_grad():
        tnet(tx)
    return jx.coordinate_manager, tx.coordinate_manager


@pytest.fixture(scope="module")
def warm():
    jnet = JMinkUNet14A(3, 4, D=3, rngs=nnx.Rngs(0))
    tnet = MinkUNet14A(3, 4, D=3, device="cpu")
    load_state_dict_from_reference(tnet, export_reference_state_dict(jnet))
    jmgr, tmgr = recorded(jnet, tnet)
    return jnet, tnet, jmgr, tmgr


def test_oplog_records_jax_entries_minkunet14a(warm):
    _, _, jmgr, tmgr = warm
    want = jmgr.oplog()
    assert tmgr.oplog() == want
    assert tmgr.oplog()[0] == ("insert", (1, 1, 1), "", ((1, 1, 1), ""))
    assert {e[0] for e in want} == {"insert", "stride", "kernel_map", "dense_plan"}


def test_oplog_records_jax_entries_minkunet34():
    jnet = JNarrow34(3, 4, D=3, rngs=nnx.Rngs(0))
    tnet = TNarrow34(3, 4, D=3, device="cpu")
    jmgr, tmgr = recorded(jnet, tnet)
    want = jmgr.oplog()
    assert tmgr.oplog() == want
    kinds = [e[0] for e in want]
    assert (kinds.count("insert"), kinds.count("stride"), kinds.count("kernel_map"),
            kinds.count("dense_plan")) == (1, 4, 14, 5)


def test_model_outputs_from_a_geometry_match_jax_replay(warm):
    """JAX's ``test_replay_matches_eager_single_trace`` step (its replayed
    Geometry through one jitted step) against the port's model on its own
    replayed Geometry's frozen view."""
    jnet, tnet, jmgr, tmgr = warm
    tnet.train()  # JAX's batch norms default to batch statistics
    jrep, trep = ME.GeometryReplayer(jmgr), MT.GeometryReplayer(tmgr)
    graphdef, state = nnx.split(jnet)

    @jax.jit
    def step(state, feats, geo):
        model = nnx.merge(graphdef, state)
        mgr = ME.CoordinateManager.from_geometry(geo)
        return model(ME.SparseTensor(
            feats, coordinate_map_key=geo.entry_key, coordinate_manager=mgr)).padded_features

    for seed in (1, 2):
        c, f = cloud(seed)
        jm = jrep(c)
        jgeo = jm.export_geometry()
        want = np.asarray(step(state, jm.reduce_features(jgeo.entry_key, f), jgeo))[: len(c)]
        tm = trep(torch.from_numpy(c))
        geo = tm.export_geometry()
        fp = tm.reduce_features(geo.entry_key, torch.from_numpy(f))
        view = MT.CoordinateManager.from_geometry(geo)
        with torch.no_grad():
            out = tnet(MT.SparseTensor(fp, coordinate_map_key=geo.entry_key,
                                       coordinate_manager=view))
        assert out.F.shape == want.shape
        np.testing.assert_allclose(out.F.numpy(), want, rtol=2e-5, atol=2e-5)
        # the step built nothing: every map it used came from the geometry
        assert len(view._maps) == len(geo.maps) and len(view._kernel_maps) == len(geo.kernel_maps)


def test_frozen_view_rejects_builds(warm):
    _, _, _, tmgr = warm
    geo = tmgr.export_geometry()
    view = MT.CoordinateManager.from_geometry(geo)
    key = geo.entry_key
    builds = [
        lambda: view.insert_and_map(np.array([[0, 1, 1, 1]], np.int32)),
        lambda: view.stride(key, 32),
        lambda: view.kernel_map(key, key, kernel_size=7),
        lambda: view.origin_map(key),
        lambda: view.merge([key, key]),
        lambda: view.prune(key, torch.ones(view.size(key), dtype=torch.bool)),
    ]
    for build in builds:
        with pytest.raises(RuntimeError, match="frozen"):
            build()
    # lookups of recorded maps still work, and the view records nothing
    assert view.stride(key, 2) == MT.CoordinateMapKey((2, 2, 2), "")
    assert view.oplog() == []


def test_sparse_tensor_on_a_view_checks_rows(warm):
    _, _, _, tmgr = warm
    geo = tmgr.export_geometry()
    view = MT.CoordinateManager.from_geometry(geo)
    n = view.size(geo.entry_key)
    x = MT.SparseTensor(torch.zeros(n, 3), coordinate_map_key=geo.entry_key,
                        coordinate_manager=view)
    assert x.F.shape == (n, 3)
    with pytest.raises(ValueError, match="rows"):
        MT.SparseTensor(torch.zeros(n + 1, 3), coordinate_map_key=geo.entry_key,
                        coordinate_manager=view)


def test_sparse_tensor_insert_records_the_entry_key():
    c, f = cloud(3)
    x = MT.SparseTensor(torch.from_numpy(f), torch.from_numpy(c), device="cpu")
    mgr = x.coordinate_manager
    assert mgr.export_geometry().entry_key == x.coordinate_map_key
    assert mgr.oplog() == [("insert", (1, 1, 1), "", ((1, 1, 1), ""))]


@pytest.mark.parametrize("mode", ["RANDOM_SUBSAMPLE", "UNWEIGHTED_AVERAGE", "UNWEIGHTED_SUM",
                                  "MAX_POOL", "NO_QUANTIZATION"])
def test_reduce_features_matches_jax(mode):
    """Every quantization mode on a cloud with duplicate voxels (the rows
    of 600 points in an 8^3 box), against JAX's ``reduce_features``."""
    rng = np.random.RandomState(5)
    c = np.concatenate([rng.randint(0, 2, (600, 1)), rng.randint(0, 8, (600, 3))], 1)
    c = c.astype(np.int32)
    f = rng.randn(600, 5).astype(np.float32)
    jmgr = ME.CoordinateManager(D=3)
    jkey, _, _, _, n_unique = jmgr.insert_and_map_padded(c)
    want = np.asarray(jmgr.reduce_features(jkey, f, getattr(JQ, mode)))[:n_unique]
    tmgr = MT.CoordinateManager(D=3, device="cpu")
    tkey, _ = tmgr.insert_and_map(c)
    got = tmgr.reduce_features(tkey, torch.from_numpy(f), getattr(Q, mode))
    assert got.shape == want.shape and n_unique < 600
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_reduce_features_keeps_float32_sums_in_bf16():
    """2,000 bf16 rows of 0.5 in one voxel: the sum stays 1000 (float32
    accumulation, rounded to bf16 once), where bf16 accumulation stalls."""
    mgr = MT.CoordinateManager(D=3, device="cpu")
    key, _ = mgr.insert_and_map(np.zeros((2000, 4), np.int32))
    got = mgr.reduce_features(key, torch.full((2000, 1), 0.5, dtype=torch.bfloat16),
                              Q.UNWEIGHTED_SUM)
    assert got.dtype == torch.bfloat16 and got.item() == 1000.0


def test_reduce_features_needs_an_insert(warm):
    _, _, _, tmgr = warm
    with pytest.raises(KeyError):
        tmgr.reduce_features(MT.CoordinateMapKey((2, 2, 2), ""), torch.zeros(1, 3))


def test_stack_and_index_round_trip(warm):
    _, _, _, tmgr = warm
    rep = MT.GeometryReplayer(tmgr)
    geos = [rep(torch.from_numpy(cloud(s)[0])).export_geometry() for s in (11, 12, 13)]
    stacked = MT.stack_geometries(geos)
    entry = stacked.maps[geos[0].entry_key_tuple]
    assert entry.keys.shape[0] == 3
    assert entry.keys.shape[1] == max(g.maps[g.entry_key_tuple].size for g in geos)
    for i, g in enumerate(geos):
        back = index_geometry(stacked, i)
        assert list(back.maps) == list(g.maps) and back.entry_key == g.entry_key
        for k, m in g.maps.items():
            assert torch.equal(back.maps[k].coordinates, m.coordinates)
            assert torch.equal(back.maps[k].keys, m.keys)
        for k, km in g.kernel_maps.items():
            b = back.kernel_maps[k]
            assert torch.equal(b.in_idx, km.in_idx) and torch.equal(b.out_idx_t, km.out_idx_t)
            assert (b.n_in, b.n_out) == (km.n_in, km.n_out) and b.in_idx.is_contiguous()
        assert back.origin_keys == g.origin_keys
    one = squeeze_geometry(MT.stack_geometries(geos[:1]))
    assert all(torch.equal(one.maps[k].keys, m.keys) for k, m in geos[0].maps.items())
    with pytest.raises(ValueError):
        squeeze_geometry(stacked)
    with pytest.raises(ValueError):
        MT.CoordinateManager.from_geometry(stacked)


def test_stack_rejects_different_keys(warm):
    _, _, _, tmgr = warm
    geo = tmgr.export_geometry()
    mgr = MT.CoordinateManager(D=3, device="cpu")
    mgr.insert_and_map(cloud(4)[0])
    with pytest.raises(ValueError, match="same keys"):
        MT.stack_geometries([geo, mgr.export_geometry()])


def test_geometry_to_moves_every_tensor(warm):
    _, _, _, tmgr = warm
    geo = tmgr.export_geometry()
    moved = geo.to("cpu")
    assert moved.device == torch.device("cpu") and moved.entry_key == geo.entry_key
    assert set(moved.kernel_maps) == set(geo.kernel_maps)
