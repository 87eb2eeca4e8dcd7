"""Geometry replay on the card: the traced replay makes no host sync, and
``CompiledReplayer``'s CUDA graph gives the eager manager's maps with one
host sync per batch, recovering from a violated floor by recapturing.

These tests need an NVIDIA GPU and nvcc (the recording forward runs the
kernels); elsewhere they skip.  Run them on the card with
``python -m pytest --noconftest tests/test_torch_geometry_cuda.py``.
Comparisons are exact: maps index for index and the logits through the
graph's geometry bit-equal to the eager forward's (the same kernels on the
same maps).
"""

import warnings

import numpy as np
import pytest
import torch

import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.models import MinkUNet14A

pytestmark = pytest.mark.cuda


def cloud(seed, n=4000, hi=40):
    rng = np.random.RandomState(seed)
    c = np.unique(
        np.concatenate([rng.randint(0, 2, (n, 1)), rng.randint(0, hi, (n, 3))], axis=1)
        .astype(np.int32),
        axis=0,
    )
    return torch.from_numpy(c), torch.from_numpy(rng.randn(len(c), 3).astype(np.float32))


@pytest.fixture(scope="module")
def warm():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    net = MinkUNet14A(3, 4, D=3, generator=torch.Generator().manual_seed(0), device=dev).eval()
    c, f = cloud(0)
    x = MT.SparseTensor(f.to(dev), c.to(dev))
    with torch.no_grad():
        net(x)
    replayer = MT.GeometryReplayer(x.coordinate_manager)
    for s in (1, 2, 3):
        replayer(cloud(s)[0].to(dev))
    return dev, net, x.coordinate_manager, replayer


def eager(net, c, f, dev):
    x = MT.SparseTensor(f.to(dev), c.to(dev))
    with torch.no_grad():
        out = net(x)
    return x.coordinate_manager, out.F


def assert_same(geo, mgr):
    assert list(geo.maps) == list(mgr._maps)
    for k, m in mgr._maps.items():
        assert torch.equal(geo.maps[k].coordinates, m.coordinates)
        assert torch.equal(geo.maps[k].keys, m.keys)
    assert set(geo.kernel_maps) == set(mgr._kernel_maps)
    for k, km in mgr._kernel_maps.items():
        assert torch.equal(geo.kernel_maps[k].in_idx, km.in_idx)
        assert torch.equal(geo.kernel_maps[k].out_idx_t, km.out_idx_t)


def syncs(fn):
    """(fn's result, host syncs it made), by torch's sync debug mode."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def test_traced_replay_makes_no_host_sync(warm):
    dev, _, mgr, replayer = warm
    crep = MT.CompiledReplayer(mgr).adopt(replayer)
    c, f = cloud(4)
    cap = MT.coords.bucket_capacity(len(c))
    cp = torch.zeros(cap, 4, dtype=torch.int32, device=dev)
    cp[: len(c)] = c.to(dev)
    fp = torch.zeros(cap, 3, device=dev)
    fp[: len(c)] = f.to(dev)
    n = torch.tensor(len(c), device=dev)
    crep.trace(cp, n, fp)  # the device constants, once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, ok = crep.trace(cp, n, fp)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ok.item()


def test_compiled_replay_equals_eager_with_one_sync(warm):
    dev, net, mgr, replayer = warm
    crep = MT.CompiledReplayer(mgr).adopt(replayer)
    crep(*(t.to(dev) for t in cloud(5)))  # capture
    assert crep.captures == 1
    for seed in (6, 7, 8):
        c, f = (t.to(dev) for t in cloud(seed))
        (geo, fp, ok), n_syncs = syncs(lambda: crep.run(c, f))
        assert ok and n_syncs == 1
        want_mgr, want = eager(net, c, f, dev)
        assert_same(geo, want_mgr)
        view = MT.CoordinateManager.from_geometry(geo)
        with torch.no_grad():
            out = net(MT.SparseTensor(fp, coordinate_map_key=geo.entry_key,
                                      coordinate_manager=view))
        assert torch.equal(out.F, want)
    assert crep.captures == 1 and crep.recoveries == 0


def test_violated_floor_recovers_and_recaptures(warm):
    dev, net, mgr, replayer = warm
    rep = MT.GeometryReplayer(mgr)
    rep.cap_floors = dict(replayer.cap_floors)
    level = ((4, 4, 4), "")
    rep.cap_floors[level] = 16
    crep = MT.CompiledReplayer(mgr).adopt(rep)
    c, f = (t.to(dev) for t in cloud(9))
    assert crep.run(c, f) == (None, None, False)
    version = crep._version
    crep.recover(c, f)
    assert crep._version == version + 1 and crep.cap_floors[level] > 16
    geo, fp, ok = crep.run(c, f)
    assert ok and crep.captures == 2 and crep.recoveries == 1
    assert_same(geo, eager(net, c, f, dev)[0])
