"""``MinkowskiSyncBatchNorm`` across processes, against one-process batch norm
and against the JAX package's, and ``convert_sync_batchnorm``.

Two gloo processes each hold half of the rows of a batch; sync BN must give
each row what batch norm gives it on the concatenated rows: the output, the
input gradient, the summed weight and bias gradients and the running
statistics.  A one-process gloo group must give bit for bit what the module
gives outside any group.  JAX's ``MinkowskiSyncBatchNorm`` runs under
``shard_map`` on two of the eight CPU devices.

Tolerance: max |Δ| / max |ref| <= 1e-5 in float32: sync BN takes the
variance as E[x²] - mean² from (count, sum, sum of squares) summed per rank
and then across ranks, as JAX does, where ``torch.nn.BatchNorm1d`` takes
its own two-pass kernel; with features of mean 2 and unit variance the
cancellation costs a few float32 ulps.  bf16 features are normalized in
float32 by both and rounded once: one bf16 ulp (2^-7).
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from flax import nnx
from torch.distributed.device_mesh import init_device_mesh
from jax.sharding import PartitionSpec as P

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.parallel import make_mesh, shard_batch
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.models import MinkUNet34
from minkowskiengine_tpu_torch.nn.norm import MinkowskiSyncBatchNorm

RTOL = 1e-5
ULP = 2.0**-7
C = 6


def _data():
    """(coordinates, features, output gradient, weight, bias): two batch
    items of the same ~180 voxels, in canonical row order; rank r holds
    item r, rows r·n .. (r + 1)·n - 1."""
    rng = np.random.RandomState(0)
    xyz = np.unique(rng.randint(0, 8, (200, 3)), axis=0)
    coords = np.concatenate([np.concatenate([np.full((len(xyz), 1), b), xyz], 1)
                             for b in (0, 1)]).astype(np.int32)
    feats = (rng.randn(len(coords), C) + 2.0).astype(np.float32)
    g = rng.randn(len(coords), C).astype(np.float32)
    w = rng.uniform(0.5, 2.0, C).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    return coords, feats, g, w, b


def _step(bn, coords, feats, g, dtype):
    """One train-mode forward and backward, then an eval forward."""
    f = torch.from_numpy(feats).to(dtype).requires_grad_()
    out = bn.train()(MT.SparseTensor(f, torch.from_numpy(coords)))
    out.F.backward(torch.from_numpy(g).to(dtype))
    ev = bn.eval()(MT.SparseTensor(f.detach(), torch.from_numpy(coords))).F
    return {
        "out": out.F.detach().float(), "dx": f.grad.float(), "dw": bn.bn.weight.grad.clone(),
        "db": bn.bn.bias.grad.clone(), "mean": bn.bn.running_mean.clone(),
        "var": bn.bn.running_var.clone(), "eval": ev.float(),
    }


def _make(cls, w, b):
    bn = cls(C, device="cpu")
    with torch.no_grad():
        bn.bn.weight.copy_(torch.from_numpy(w))
        bn.bn.bias.copy_(torch.from_numpy(b))
    return bn


def _worker(rank, world, path):
    dist.init_process_group("gloo", init_method=f"file://{path}/store", rank=rank,
                            world_size=world)
    try:
        coords, feats, g, w, b = _data()
        mine = coords[:, 0] == rank if world == 2 else np.ones(len(coords), bool)
        res = {}
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            bn = _make(MinkowskiSyncBatchNorm, w, b)
            res[name] = _step(bn, coords[mine], feats[mine], g[mine], dtype)
        res["all_reduces"] = MinkowskiSyncBatchNorm.all_reduces
        if world == 1:  # batch norm with JAX's axis_name inside a one-rank mesh
            with init_device_mesh("cpu", (1,), mesh_dim_names=("data",)):
                bn = _make(partial(MT.MinkowskiBatchNorm, axis_name="data"), w, b)
                res["axis_name"] = _step(bn, coords, feats, g, torch.float32)
        torch.save(res, f"{path}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(world, path):
    mp.start_processes(_worker, args=(world, str(path)), nprocs=world, start_method="spawn")
    return [torch.load(f"{path}/rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _spawn(2, tmp_path_factory.mktemp("sync2"))


def _rel(got, want):
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_two_ranks_equal_batch_norm_on_all_rows(two_ranks, dtype):
    coords, feats, g, w, b = _data()
    ref = _step(_make(MT.MinkowskiBatchNorm, w, b), coords, feats, g,
                torch.float32 if dtype == "f32" else torch.bfloat16)
    tol = RTOL if dtype == "f32" else ULP
    rows = [np.flatnonzero(coords[:, 0] == r) for r in range(2)]
    for r, res in enumerate(two_ranks):
        got = res[dtype]
        for k in ("out", "dx", "eval"):
            assert _rel(got[k], ref[k][rows[r]]) <= tol, (r, k)
        for k in ("mean", "var"):
            assert got[k].dtype is torch.float32
            assert _rel(got[k], ref[k]) <= RTOL, (r, k)
        # forward: one all-reduce per step; backward: one more
        assert res["all_reduces"] == 4
    for k in ("dw", "db"):  # each rank's share; a data-parallel step sums them
        assert _rel(two_ranks[0][dtype][k] + two_ranks[1][dtype][k], ref[k]) <= RTOL, k


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    return _spawn(1, tmp_path_factory.mktemp("sync1"))[0]


def test_one_rank_group_is_bit_equal_to_no_group(one_rank):
    res = one_rank
    assert res["all_reduces"] == 4
    coords, feats, g, w, b = _data()
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        before = MinkowskiSyncBatchNorm.all_reduces
        alone = _step(_make(MinkowskiSyncBatchNorm, w, b), coords, feats, g, dtype)
        assert MinkowskiSyncBatchNorm.all_reduces == before  # no group: no all-reduce
        for k, v in alone.items():
            assert torch.equal(v, res[name][k]), (name, k)


def test_batch_norm_axis_name_on_a_one_rank_group_is_bit_equal_to_no_group(one_rank):
    """``MinkowskiBatchNorm(axis_name="data")`` inside a one-rank mesh, whose
    sum over the group is its own, gives the plain batch norm's numbers
    outside any group, to the bit, in train and eval mode."""
    coords, feats, g, w, b = _data()
    alone = _step(_make(MT.MinkowskiBatchNorm, w, b), coords, feats, g, torch.float32)
    for k, v in alone.items():
        assert torch.equal(v, one_rank["axis_name"][k]), k


def test_two_ranks_match_jax_under_shard_map(two_ranks):
    """JAX's sync BN on two CPU devices, each with one batch item's rows,
    in train mode."""
    coords, feats, g, w, b = _data()
    n = len(coords) // 2
    sync = ME.MinkowskiSyncBatchNorm(C, axis_name="data", track_running_stats=False)
    sync.weight[...] = jnp.asarray(w)[None]
    sync.bias[...] = jnp.asarray(b)[None]
    mesh = make_mesh(2)
    sharded = nnx.shard_map(lambda f: sync._apply(f[0], n), mesh=mesh, in_specs=P("data"),
                            out_specs=P("data"), check_vma=False)
    want = np.asarray(sharded(shard_batch(jnp.asarray(feats.reshape(2, n, C)), mesh)))
    want = want.reshape(2, n, C)
    for r in range(2):
        assert _rel(two_ranks[r]["f32"]["out"], torch.from_numpy(want[r])) <= RTOL, r


def test_convert_keeps_parameters_buffers_and_names():
    class Narrow(MinkUNet34):
        PLANES, INIT_DIM = (8, 8, 8, 8, 8, 8, 8, 8), 8

    net = Narrow(3, 5, D=3, generator=torch.Generator().manual_seed(0), device="cpu")
    before = {k: v for k, v in net.state_dict(keep_vars=True).items()}
    n_bn = sum(isinstance(m, MT.MinkowskiBatchNorm) for m in net.modules())
    out = MinkowskiSyncBatchNorm.convert_sync_batchnorm(net)
    assert out is net
    after = net.state_dict(keep_vars=True)
    assert list(after) == list(before)
    assert all(after[k] is before[k] for k in before)  # the same tensors
    syncs = [m for m in net.modules() if isinstance(m, MT.MinkowskiBatchNorm)]
    assert len(syncs) == n_bn and all(isinstance(m, MinkowskiSyncBatchNorm) for m in syncs)
    assert {id(p) for p in net.parameters()} == {id(v) for k, v in before.items()
                                                 if isinstance(v, torch.nn.Parameter)}
    # a lone batch norm converts into its replacement, in its mode
    lone = MT.MinkowskiBatchNorm(4, device="cpu").eval()
    conv = MinkowskiSyncBatchNorm.convert_sync_batchnorm(lone)
    assert isinstance(conv, MinkowskiSyncBatchNorm) and conv.bn is lone.bn and not conv.training


@pytest.mark.parametrize("track", [True, False])
def test_outside_a_group_it_is_batch_norm(track):
    coords, feats, g, w, b = _data()
    assert not (dist.is_available() and dist.is_initialized())
    sync = MinkowskiSyncBatchNorm(C, track_running_stats=track, device="cpu")
    plain = MT.MinkowskiBatchNorm(C, track_running_stats=track, device="cpu")
    for m in (sync, plain):
        with torch.no_grad():
            m.bn.weight.copy_(torch.from_numpy(w))
            m.bn.bias.copy_(torch.from_numpy(b))
    x = torch.from_numpy(feats)
    for mode in ("train", "eval"):
        outs = [getattr(m, mode)()(MT.SparseTensor(x, torch.from_numpy(coords))).F.detach()
                for m in (sync, plain)]
        assert _rel(outs[0], outs[1]) <= RTOL, mode
    if track:
        for k in ("running_mean", "running_var", "num_batches_tracked"):
            a, b_ = getattr(sync.bn, k), getattr(plain.bn, k)
            assert torch.allclose(a.double(), b_.double(), rtol=RTOL, atol=1e-7), k


def test_jax_name_and_export():
    assert MT.MinkowskiSyncBatchNorm is MinkowskiSyncBatchNorm
    assert MT.nn.MinkowskiSyncBatchNorm is MinkowskiSyncBatchNorm
    assert "MinkowskiSyncBatchNorm" in MT.nn.__all__
