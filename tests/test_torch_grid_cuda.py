"""The dense bbox grid on the card: maps built through the row grids
(``coords/grid.py``) equal the CPU's, and the grid-probe kernel
(``kernels/grid_probe.py``, ``csrc/grid_probe.cu``) equals its plain
version, ``coords/kernel_map.py::_build_in_idx_grid``, index for index.

The kernel is held to the plain version on the CPU and on the card at D =
1..6, K = 1, 8, 27 and 125, tensor strides 1, 2 and 4 (rows on a lattice
with a random phase, so the minima are misaligned; negative coordinates;
dilated offsets and offsets off the lattice; batch deltas), with and
without valid masks, both halves in one launch, empty halves and queries
off the grid or at the int32 limits.  The manager's maps on the card, one
half alone and a traced replay's maps (one CUDA graph) equal the CPU's.

These tests need an NVIDIA GPU; elsewhere they skip.  Run them on the card
with ``python -m pytest --noconftest tests/test_torch_grid_cuda.py``.
Maps are compared index for index (interpolation weights within 1e-6).
"""

import numpy as np
import pytest
import torch

import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.coords import grid as G
from minkowskiengine_tpu_torch.coords.kernel_map import ROUTES, _build_in_idx_grid, build_kernel_map
from minkowskiengine_tpu_torch.coords.manager import region_offsets_for
from minkowskiengine_tpu_torch.kernels import grid_probe as GP

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def cloud(seed, n=6000, hi=48):
    rng = np.random.RandomState(seed)
    c = np.concatenate([rng.randint(0, 2, (n, 1)), rng.randint(-hi, hi, (n, 3))], 1)
    return torch.from_numpy(np.unique(c.astype(np.int32), axis=0))


def maps(c, device):
    mgr = MT.CoordinateManager(D=3, device=device)
    k1, _ = mgr.insert_and_map(c)
    k2 = mgr.stride(k1, 2)
    out = [mgr.kernel_map(k1, k1, kernel_size=5), mgr.kernel_map(k1, k2, stride=2, kernel_size=2),
           mgr.kernel_map(k2, k2, kernel_size=3),
           mgr.kernel_map(k2, k1, stride=2, kernel_size=2, is_transpose=True)]
    idx = [t for km in out for t in (km.in_idx, km.out_idx_t)]
    idx.append(mgr.stride_map(k1, k2))
    samples = c.float()[:500] + 0.37
    idx += list(mgr.interpolation_map_weight(k2, samples))
    return mgr, idx


def test_probe_maps_on_the_card_equal_the_cpu(dev):
    c = cloud(0)
    before = dict(build_kernel_map.route_builds)
    mgr, got = maps(c.to(dev), dev)
    assert mgr._row_grids
    routes = {k: v - before[k] for k, v in build_kernel_map.route_builds.items()}
    assert routes == {"kernel": 6, "ops": 0, "search": 0}  # 3 maps built, the transpose swapped
    _, want = maps(c, "cpu")
    for g, w in zip(got[:-1], want[:-1]):
        assert torch.equal(g.cpu(), w)
    # the interpolation weights: products of float32 fractions, which the
    # card may contract into FMAs; within 1e-6, chip_smoke.py's SPLAT_RTOL
    torch.testing.assert_close(got[-1].cpu(), want[-1], rtol=0, atol=1e-6)


# --- the kernel against its plain version ------------------------------------


def lattice_map(D, ts, seed, dev, n=500, batches=2):
    """A map at tensor stride ``ts`` whose rows lie on ``phase + ts·Z`` (a
    random phase an axis: minima off the multiples of ts), with negative
    coordinates, 16 lattice steps an axis (so D = 6 fits); its probe."""
    rng = np.random.RandomState(seed)
    phase = rng.randint(0, ts, D)
    u = rng.randint(-8, 8, (n, D))
    c = np.concatenate([rng.randint(0, batches, (n, 1)), u * ts + phase], 1).astype(np.int32)
    mgr = MT.CoordinateManager(D=D, device=dev)
    key, _ = mgr.insert_and_map(torch.from_numpy(np.unique(c, axis=0)).to(dev), tensor_stride=ts)
    m = mgr._get_map(key)
    plan = G.build_dense_plan(m)
    return (G.build_row_grid(plan.flat_idx, plan.cells), plan.mins, plan.grid_shape,
            m.tensor_stride), m


def queries(m, D, ts, K, seed, dil=1, n=700):
    """Base rows (half of them the map's own rows, half of those shifted
    along its lattice; the rest anywhere near its bbox, most off the
    lattice, batches 0..2) and (K, D+1) offsets: 0 first, then dilated
    lattice steps, a quarter of them one off the lattice, a tenth with a
    batch delta of ±1."""
    rng = np.random.RandomState(seed)
    own = m.coordinates.cpu().numpy()
    own = own[rng.randint(0, len(own), n // 2)].copy()
    own[: n // 4, 1:] += rng.randint(-2, 3, (n // 4, D)) * ts
    far = np.concatenate([rng.randint(0, 3, (n - n // 2, 1)),
                          rng.randint(-11 * ts, 11 * ts, (n - n // 2, D))], 1)
    base = np.concatenate([own, far]).astype(np.int32)
    offs = np.zeros((K, D + 1), np.int64)
    offs[1:, 1:] = rng.randint(-2, 3, (K - 1, D)) * ts * dil
    offs[1:][rng.rand(K - 1) < 0.25, 1] += 1
    offs[1:][rng.rand(K - 1) < 0.1, 0] = rng.choice([-1, 1])
    return torch.from_numpy(base), offs


def plain(probe, base, offs, valid=None, device="cpu"):
    """``_build_in_idx_grid`` with every tensor on ``device``."""
    grid, mins, shape, ts = probe
    on = lambda t: None if t is None else t.to(device)  # noqa: E731
    return _build_in_idx_grid((on(grid), on(mins), shape, ts), on(base), offs, on(valid))


def kernel(probe, base, offs, valid=None):
    dev = probe[0].device
    half = GP.Half(probe, base.to(dev), torch.from_numpy(offs).to(dev, torch.int32),
                   None if valid is None else valid.to(dev))
    (out,) = GP.grid_probe(half)
    return out


@pytest.mark.parametrize("ts", [1, 2, 4])
@pytest.mark.parametrize("K", [1, 8, 27, 125])
@pytest.mark.parametrize("D", [1, 2, 3, 4, 5, 6])
def test_kernel_equals_the_plain_version(dev, D, K, ts):
    probe, m = lattice_map(D, ts, seed=10 * D + ts, dev=dev)
    base, offs = queries(m, D, ts, K, seed=K + D, dil=1 + (D + K) % 2)
    valid = None
    if (D + ts) % 2:  # a padded map's mask: a valid head, an invalid tail and holes
        valid = torch.from_numpy(np.random.RandomState(D).rand(len(base)) < 0.8)
        valid[-50:] = False
    launches = GP.grid_probe.launches
    got = kernel(probe, base, offs, valid)
    assert GP.grid_probe.launches == launches + 1
    want = plain(probe, base, offs, valid)
    assert got.shape == (K, len(base)) and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, plain(probe, base, offs, valid, dev))
    assert (want >= 0).any() and (want < 0).any()  # the queries hit and miss
    if valid is not None:
        assert (got[:, ~valid.to(dev)] == -1).all()


def test_both_halves_in_one_launch_equal_each_alone(dev):
    pa, ma = lattice_map(3, 2, seed=1, dev=dev)
    pb, mb = lattice_map(3, 1, seed=2, dev=dev, n=300)
    base_a, offs = queries(ma, 3, 2, 27, seed=3)
    base_b, _ = queries(mb, 3, 1, 27, seed=4, n=333)
    valid_b = torch.from_numpy(np.arange(333) < 300)
    halves = (GP.Half(pa, base_a.to(dev), torch.from_numpy(offs).to(dev, torch.int32)),
              GP.Half(pb, base_b.to(dev), torch.from_numpy(-offs).to(dev, torch.int32),
                      valid_b.to(dev)))
    launches = GP.grid_probe.launches
    a, b = GP.grid_probe(*halves)
    assert GP.grid_probe.launches == launches + 1
    assert torch.equal(a, GP.grid_probe(halves[0])[0]) and torch.equal(b, GP.grid_probe(halves[1])[0])
    assert torch.equal(a.cpu(), plain(pa, base_a, offs))
    assert torch.equal(b.cpu(), plain(pb, base_b, -offs, valid_b))


def test_empty_halves_and_queries_off_the_grid(dev):
    probe, m = lattice_map(3, 1, seed=5, dev=dev)
    base, offs = queries(m, 3, 1, 8, seed=6)
    none = base[:0]
    a, b = GP.grid_probe(GP.Half(probe, none.to(dev), torch.from_numpy(offs).to(dev, torch.int32)),
                         GP.Half(probe, base.to(dev), torch.from_numpy(offs).to(dev, torch.int32)))
    assert a.shape == (8, 0) and torch.equal(b.cpu(), plain(probe, base, offs))
    (k0,) = GP.grid_probe(GP.Half(probe, base.to(dev), torch.zeros(0, 4, dtype=torch.int32,
                                                                   device=dev)))
    assert k0.shape == (0, len(base))
    # rows far off the grid and at the int32 limits, where the sums wrap as
    # the plain version's int32 ops wrap
    edge = torch.tensor([[0, 2**31 - 2, 0, 0], [1, -2**31 + 1, 5, -5], [0, 3, 2**31 - 1, 4],
                         [-2**31, 0, 0, 0], [2**31 - 1, 1, 1, 1], [5, 0, 0, 0]], dtype=torch.int32)
    wide = np.array([[0, 3, 0, 0], [0, -3, 0, 0], [0, 0, 2, 0], [1, 0, 0, 0], [-1, 0, 0, -3]])
    got = kernel(probe, edge, wide)
    assert torch.equal(got.cpu(), plain(probe, edge, wide))
    assert torch.equal(got, plain(probe, edge, wide, device=dev))


# --- the manager's maps -------------------------------------------------------


def test_one_half_alone_takes_the_kernel_and_the_other_the_search(dev):
    c = cloud(1, n=3000)
    out = {}
    for device in ("cpu", dev):
        mgr = MT.CoordinateManager(D=3, device=device)
        k1, _ = mgr.insert_and_map(c.to(device))
        k2 = mgr.stride(k1, 2)
        a, b = mgr._get_map(k1), mgr._get_map(k2)
        offs = region_offsets_for(MT.RegionType.HYPER_CUBE, (3, 3, 3), (1, 1, 1), a.tensor_stride,
                                  None)
        pa, pb = mgr._probe_grid_for(k1), mgr._probe_grid_for(k2)
        before = dict(build_kernel_map.route_builds)
        out[str(device)] = [build_kernel_map(a, b, offs, probe=pa), build_kernel_map(
            a, b, offs, probe_out=pb), build_kernel_map(a, b, offs)]
        routes = {k: v - before[k] for k, v in build_kernel_map.route_builds.items()}
        card = device != "cpu"
        assert routes == {"kernel": 2 if card else 0, "ops": 0 if card else 2, "search": 4}
    for got, want in zip(out[str(dev)], out["cpu"]):
        assert torch.equal(got.in_idx.cpu(), want.in_idx)
        assert torch.equal(got.out_idx_t.cpu(), want.out_idx_t)
    assert torch.equal(out[str(dev)][0].in_idx, out[str(dev)][2].in_idx)


def recipe(mgr, c):
    """Kernel maps at strides 1 and 2, a transposed one built alone, a
    pooling map."""
    k1, _ = mgr.insert_and_map(c)
    k2 = mgr.stride(k1, 2)
    mgr.kernel_map(k1, k1, kernel_size=5)
    mgr.kernel_map(k1, k2, stride=2, kernel_size=2)
    mgr.kernel_map(k2, k2, kernel_size=3)
    k4 = mgr.stride(k2, 2)
    mgr.kernel_map(k4, k2, stride=2, kernel_size=3, is_transpose=True)
    mgr.kernel_map(k2, k4, stride=2, kernel_size=2, is_pool=True)
    return mgr


def test_traced_replay_maps_equal_the_eager_ones(dev):
    """The traced replay, captured in one CUDA graph, builds its padded
    maps with the kernel; cut to their rows they equal an eager CPU
    manager's, index for index."""
    rec = recipe(MT.CoordinateManager(D=3, device=dev), cloud(10, n=3000).to(dev))
    replayer = MT.GeometryReplayer(rec)
    for s in (11, 12, 13):
        replayer(cloud(s, n=3000).to(dev))
    crep = MT.CompiledReplayer(rec).adopt(replayer)
    routes = dict.fromkeys(ROUTES, 0)
    for s in (14, 15):
        c = cloud(s, n=3000)
        before = dict(build_kernel_map.route_builds)
        geo, _, ok = crep.run(c.to(dev))
        for k, v in build_kernel_map.route_builds.items():
            routes[k] += v - before[k]
        assert ok
        want = recipe(MT.CoordinateManager(D=3, device="cpu"), c)
        assert set(geo.kernel_maps) == set(want._kernel_maps)
        for k, km in want._kernel_maps.items():
            assert torch.equal(geo.kernel_maps[k].in_idx.cpu(), km.in_idx), k[:2]
            assert torch.equal(geo.kernel_maps[k].out_idx_t.cpu(), km.out_idx_t), k[:2]
    assert crep.captures == 1
    # the 4 maps' 8 halves, built by the warm-up and by the capture; the
    # second batch replays the graph and builds nothing in Python
    assert routes == {"kernel": 16, "ops": 0, "search": 0}
