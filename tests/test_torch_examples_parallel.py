"""The multi-process examples (``examples_torch/multigpu.py``,
``multigpu_ddp.py``, ``spatial_sharding.py``, ``tensor_parallel.py``) on the
CPU, against the JAX package's.

- One gloo world of 2 processes, spawned once through the scripts' own
  launcher (``common.run_world``) on one torch thread each, runs the four
  scripts' rank functions in turn at small sizes (``_all_four``; the
  workers import torch, numpy and the port only).  In it: both ranks'
  parameters bit-equal after every step of ``multigpu.py`` and
  ``multigpu_ddp.py``, with finite averaged losses; ``spatial_sharding.py``
  drops no pair, and its loss, weight gradient and input gradient agree
  with the single-process conv (``ops.functional.sparse_conv_kmap``) within
  1e-4 of max|ref| (float32 sums over a few thousand rows per rank, taken
  in another order); ``tensor_parallel.py`` within 1e-4 of max|single|.
- One JAX subprocess, started first and running meanwhile, is the slice's
  reference: JAX's ``examples/multigpu.py`` step 0 at one device on its own
  cloud with ``MinkUNet14A(3, 10)``, whose weights the port takes
  (``export_reference_state_dict`` → ``--weights``): the port's world-1
  run gives the same loss within 1e-5 relative and, for every parameter
  tensor, the same SGD update (after - before) within 1e-4 of JAX's
  largest entry plus one float32 spacing of the parameter (float32 sums
  through 20 convs and 20 batch norms in another order); an update 1%
  off, and so a skipped one, fails that limit on every tensor.  The same subprocess
  measures JAX's ``required_halo`` on the small scan's k = 3 map; it must
  equal the port script's halo at 2 ranks (JAX's map cut to its N rows,
  N even, so that both block rules cut at N / 2, and JAX's rounding up to
  64 rows taken off).
- The scripts' generators draw JAX's numbers: ``multigpu_ddp.make_cloud``
  against JAX's script, the 600- and 2000-point clouds against the lines
  of JAX's ``multigpu.py`` and ``tensor_parallel.py`` in the subprocess.
- Without a card and without ``--cpu``, each script raises.
"""

import argparse
import math
import os
import runpy
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"
SCRIPTS = ("multigpu", "multigpu_ddp", "spatial_sharding", "tensor_parallel")
WORLD = 2
RTOL = 1e-4
LOSS_RTOL = 1e-5
SCAN_POINTS, SCAN_VOXEL = 20_000, 0.1
# each script's arguments in the world
ARGV = {
    "multigpu": ["--steps", "2"],
    "multigpu_ddp": ["--steps", "2"],
    "spatial_sharding": ["--n_points", str(SCAN_POINTS), "--voxel_size", str(SCAN_VOXEL)],
    "tensor_parallel": [],
}

common = SimpleNamespace(**runpy.run_path(str(EXAMPLES / "common.py")))


def _script(name):
    return common._load_script(EXAMPLES / f"{name}.py", f"examples_torch_{name}")


def _all_four(rank, world, args):
    """Every script's rank function in turn, on this rank of the world."""
    out = {}
    for name in SCRIPTS:
        mod = _script(name)
        out[name] = mod.run_rank(rank, world, mod.arguments(ARGV[name] + ["--cpu"]))
    return out


# JAX's side, in its own interpreter: examples/multigpu.py step 0 at one
# device, and required_halo on the small scan
_JAX = r"""
import sys, types
from pathlib import Path

import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import optax
from flax import nnx

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.models import MinkUNet14A
from minkowskiengine_tpu.parallel import make_data_parallel_step, make_mesh, required_halo, shard_batch
from minkowskiengine_tpu.parallel import spatial as jax_spatial
from minkowskiengine_tpu.utils.datasets import room_scan_voxels
from minkowskiengine_tpu.utils.torch_import import export_reference_state_dict

out = Path(sys.argv[1])
points, voxel = int(sys.argv[2]), float(sys.argv[3])

# examples/tensor_parallel.py:62-69
rng = np.random.RandomState(0)
coords = np.unique(np.concatenate(
    [rng.randint(0, 2, (2000, 1)), rng.randint(0, 32, (2000, 3))], axis=1).astype(np.int32), axis=0)
np.savez(out / "tp_cloud.npz", coords=coords, feats=rng.randn(len(coords), 3).astype(np.float32))

# examples/multigpu.py:52-88 at one device, step 0
rng = np.random.RandomState(0)
coords = np.unique(np.concatenate(
    [rng.randint(0, 2, (600, 1)), rng.randint(0, 32, (600, 3))], axis=1).astype(np.int32), axis=0)
x = ME.SparseTensor(rng.randn(len(coords), 3).astype(np.float32), coords)
net = MinkUNet14A(3, 10, D=3, rngs=nnx.Rngs(0))
np.savez(out / "weights.tmp.npz", **export_reference_state_dict(net))
Path(out / "weights.tmp.npz").rename(out / "weights.npz")
np.savez(out / "cloud.npz", coords=coords, feats=np.asarray(x.features))
_ = net(x)
net = ME.MinkowskiSyncBatchNorm.convert_sync_batchnorm(net)
optimizer = nnx.Optimizer(net, optax.sgd(1e-2), wrt=nnx.Param)
cap, n = x.capacity, x.size
manager, key = x.coordinate_manager, x.coordinate_map_key
mesh = make_mesh(1)

def loss_fn(model, feats_shard, labels_shard):
    xt = ME.SparseTensor(feats_shard[0], coordinate_map_key=key, coordinate_manager=manager)
    logits = model(xt).padded_features
    mask = (jnp.arange(cap) < n).astype(jnp.float32)
    losses = optax.softmax_cross_entropy_with_integer_labels(logits, labels_shard[0])
    return jnp.sum(losses * mask) / jnp.sum(mask)

step = make_data_parallel_step(net, optimizer, loss_fn, mesh)
feats = np.zeros((1, cap, 3), np.float32)
labels = np.zeros((1, cap), np.int32)
feats[:, :n] = rng.randn(1, n, 3)  # the port's (world, N) draws: its rows, no padding
labels[:, :n] = rng.randint(0, 10, (1, n))
loss = float(step(net, optimizer, shard_batch(jnp.asarray(feats), mesh),
                  shard_batch(jnp.asarray(labels), mesh)))
after = {k: v for k, v in export_reference_state_dict(net).items()
         if "running" not in k and "num_batches" not in k}
np.savez(out / "after.npz", loss=loss, **{"p/" + k: v for k, v in after.items()})

# required_halo on the small scan's k = 3 map, cut to its N rows, unrounded
c, f = room_scan_voxels(voxel_size=voxel, n_points=points, seed=0)
s = ME.SparseTensor(f, c)
mgr, key = s.coordinate_manager, s.coordinate_map_key
km = mgr.kernel_map(key, mgr.stride(key, 1), kernel_size=3, stride=1)
n = s.size
cut = types.SimpleNamespace(in_idx=km.in_idx[:, :n], out_idx_t=km.out_idx_t[:, :n],
                            capacity_in=n, capacity_out=n)
jax_spatial._round_up = lambda v, m: v
np.savez(out / "halo.npz", halo=np.array(required_halo(cut, 2)), rows=n)
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this process, and so in each rank the launcher
    spawns: inside a loaded multi-worker test run, a thread pool spinning
    against the other workers' costs these runs many times their time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):
    """JAX's subprocess first; then the 2-rank world, and the port's world-1
    step from JAX's weights, meanwhile."""
    out = tmp_path_factory.mktemp("examples_parallel")
    # XLA's backend optimizations and its CPU fusion emitters off: JAX's
    # eager MinkUNet14A compiles each op on first use, and that compile
    # time, not the run, is this file's critical path (the subprocess alone
    # ~82 s with both on, ~64 s with the optimizations off, ~40 s with both
    # off; the same loss, parameters and halo, bit for bit)
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + (
        " --xla_backend_optimization_level=0 --xla_cpu_use_fusion_emitters=false")).strip())
    proc = subprocess.Popen([sys.executable, "-c", _JAX, str(out), str(SCAN_POINTS), str(SCAN_VOXEL)],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        world = common.run_world(Path(__file__), "_all_four",
                                 argparse.Namespace(cpu=True, world=WORLD, backend=None))
        deadline = time.monotonic() + 600
        while not (out / "weights.npz").exists():
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            assert time.monotonic() < deadline
            time.sleep(0.5)
        one = _script("multigpu").main(["--cpu", "--world", "1", "--steps", "1", "--weights",
                                        str(out / "weights.npz"), "--save", str(out / "port.npz")])
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return SimpleNamespace(world=world, one=one, out=out)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# the world's own checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["multigpu", "multigpu_ddp"])
def test_data_parallel_ranks_stay_bit_equal(runs, name):
    ranks = [r[name] for r in runs.world]
    steps = len(ranks[0]["losses"])
    assert steps == 2 and all(len(r["digests"]) == steps for r in ranks)
    for r in ranks[1:]:
        assert r["digests"] == ranks[0]["digests"]
        assert r["losses"] == ranks[0]["losses"]  # the loss averaged over the ranks
    for r in ranks:
        assert all(math.isfinite(v) for v in r["losses"])
        # one all-reduce of the gradients per step, beside sync batch norm's
        assert all(c["all_reduce"] - bn == 1 for c, bn in zip(r["collectives"], r["bn_all_reduces"]))
        assert all(bn > 0 for bn in r["bn_all_reduces"])


def test_multigpu_ddp_ranks_train_on_their_own_clouds(runs):
    rows = [r["multigpu_ddp"]["rows"] for r in runs.world]
    ddp = _script("multigpu_ddp")
    for r, got in enumerate(rows):
        assert got == [len(common.random_cloud(1 + it * WORLD + r, ddp.POINTS, ddp.HI)[0])
                       for it in range(len(got))]


def test_spatial_sharding_matches_the_single_process_conv(runs):
    from minkowskiengine_tpu_torch.ops.functional import sparse_conv_kmap
    from minkowskiengine_tpu_torch.utils.datasets import room_scan_voxels

    import minkowskiengine_tpu_torch as MT

    ranks = [r["spatial_sharding"] for r in runs.world]
    coords, feats = room_scan_voxels(voxel_size=SCAN_VOXEL, n_points=SCAN_POINTS, seed=0)
    x = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords), device="cpu")
    mgr, key = x.coordinate_manager, x.coordinate_map_key
    km = mgr.kernel_map(key, mgr.stride(key, 1), kernel_size=3, stride=1)
    f = x.F.clone().requires_grad_()
    w = _script("spatial_sharding").weight("cpu").requires_grad_()
    out = sparse_conv_kmap(f, w, km)
    loss = (out * out).sum()
    loss.backward()
    assert [r["block"] for r in ranks] == [(0, x.size // 2), (x.size // 2, x.size)]
    for r in ranks:
        assert r["rows"] == x.size and r["dropped"] == 0
        assert r["halo"] == ranks[0]["halo"] and 0 < r["halo"][0] <= x.size // 2
        assert abs(r["loss"] - loss.item()) <= RTOL * loss.item()
        assert _rel(r["d_weight"], w.grad) <= RTOL
        assert _rel(r["pooled"], x.F.mean(0, keepdim=True)) <= RTOL
        assert r["collectives"]["all_gather"] >= 2  # the edge bands, forward and backward
    assert _rel(ranks[0]["d_feats"], f.grad) <= RTOL


def test_tensor_parallel_matches_the_single_device_forward(runs):
    for r in runs.world:
        got = r["tensor_parallel"]
        assert got["err"] <= RTOL * got["scale"] and got["cut"] > 0
        assert got["collectives"]["all_gather"] >= got["cut"]


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------


def test_clouds_are_jaxs(runs):
    jax_ddp = common._load_script(ROOT / "examples" / "multigpu_ddp.py", "examples_jax_multigpu_ddp")
    mine = _script("multigpu_ddp")
    for seed in (0, 1, 1000, 7):
        for got, want in zip(common.random_cloud(seed, mine.POINTS, mine.HI),
                             jax_ddp.make_cloud(seed)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    cloud = np.load(runs.out / "cloud.npz")
    coords, feats, _ = common.random_cloud(**_script("multigpu").CLOUD)
    np.testing.assert_array_equal(coords, cloud["coords"])
    np.testing.assert_array_equal(feats, cloud["feats"][: len(coords)])
    tp = np.load(runs.out / "tp_cloud.npz")
    for got, want in zip(common.random_cloud(**_script("tensor_parallel").CLOUD),
                         (tp["coords"], tp["feats"])):
        np.testing.assert_array_equal(got, want)


def test_multigpu_step_matches_jaxs(runs):
    want = np.load(runs.out / "after.npz")
    got = dict(np.load(runs.out / "port.npz"))
    loss = float(want["loss"])
    assert runs.one["world"] == 1 and len(runs.one["losses"]) == 1
    assert abs(runs.one["losses"][0] - loss) <= LOSS_RTOL * abs(loss)
    before = np.load(runs.out / "weights.npz")
    params = {k[2:]: want[k] for k in want.files if k.startswith("p/")}
    assert params and set(params) <= set(got)
    for k, v in params.items():
        # the step's update, held against JAX's: within 1e-4 of its largest
        # entry, plus one float32 spacing of the parameter (where both sides
        # round before - lr·grad)
        step_ref = v.astype(np.float64) - before[k]
        step = got[k].astype(np.float64) - before[k]
        limit = RTOL * np.abs(step_ref).max() + np.spacing(np.abs(v))
        assert np.all(np.abs(step - step_ref) <= limit), (k, np.abs(step - step_ref).max(),
                                                          np.abs(step_ref).max())
        # the limit is tight enough to fail an update 1% off, and so a skipped one
        assert np.any(0.01 * np.abs(step_ref) > limit), k


def test_spatial_halo_is_jaxs(runs):
    want = np.load(runs.out / "halo.npz")
    ranks = [r["spatial_sharding"] for r in runs.world]
    assert int(want["rows"]) == ranks[0]["rows"] and ranks[0]["rows"] % 2 == 0
    assert tuple(int(h) for h in want["halo"]) == tuple(ranks[0]["halo"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: the default runs on it")
@pytest.mark.parametrize("name", SCRIPTS)
def test_without_a_card_a_script_raises_unless_asked_for_the_cpu(name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _script(name).main([])
