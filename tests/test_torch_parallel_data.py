"""``parallel.data_parallel`` across processes, against the JAX package.

Gloo worlds of 2 and 4 processes (``torch.multiprocessing`` spawn, as
``tests/test_torch_sync_batchnorm.py`` runs them; one spawn per world runs
every case; the workers import torch, numpy and the port only).  The parent
feeds the same seeded numpy clouds, features, labels and JAX-exported
weights to the JAX package, single-device, as ``tests/test_multichip.py``
judges its mesh: the averaged gradient of a data-parallel step equals the
mean of independent single-device gradients over the ranks' batches.

- ``make_data_parallel_step``: one cloud, each rank its own features and
  labels; conv (k = 3) → batch norm → ReLU → conv (k = 1), cross-entropy.
- ``make_per_device_geometry_step``: each rank its own cloud, replayed by a
  ``GeometryReplayer``, stacked (``stack_geometries``), cut by
  ``shard_batch`` and squeezed by the step; JAX's reference runs each cloud
  eagerly on a fresh manager.
- ``all_reduce_metrics`` (a kept divergence: each rank passes its own value;
  JAX means a host array over its leading device axis), ``replicate``,
  ``shard_batch``, and ``MinkowskiSyncBatchNorm`` with ``process_group`` a
  mesh.
- ``average_gradients``: one all-reduce of one buffer; parameters of two
  dtypes are refused.
- ``MinkowskiBatchNorm(axis_name="data")``: inside the entered mesh, the
  sync batch norm bit for bit; outside it, plain batch norm.

Tolerance: per tensor, max|Δ| / max|ref| <= 1e-5: float32 sums over a few
hundred rows per rank, and the mean over the ranks taken in another order.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.parallel import (
    all_reduce_metrics,
    make_data_parallel_step,
    make_mesh,
    make_per_device_geometry_step,
    replicate,
    shard_batch,
)
from minkowskiengine_tpu_torch.parallel import comm
from minkowskiengine_tpu_torch.parallel.data_parallel import average_gradients

RTOL = 1e-5
LR = 0.01
CLASSES = 4
WORLDS = (2, 4)


def _cloud(seed, n=300, hi=20):
    """The per-device clouds of ``tests/test_multichip.py``."""
    rng = np.random.RandomState(seed)
    c = np.unique(np.concatenate([rng.randint(0, 2, (n, 1)), rng.randint(0, hi, (n, 3))],
                                 axis=1).astype(np.int32), axis=0)
    return c, rng.randn(len(c), 3).astype(np.float32)


def _shared_batch(world, n_rows):
    """Each rank's features and labels over the shared cloud (seed 0)."""
    rng = np.random.RandomState(1)
    return (rng.randn(world, n_rows, 3).astype(np.float32),
            rng.randint(0, CLASSES, (world, n_rows)).astype(np.int64))


def _labels(seed, n):
    return np.random.RandomState(100 + seed).randint(0, CLASSES, n).astype(np.int64)


class TNet(MT.MinkowskiNetwork):
    def __init__(self):
        super().__init__(3)
        self.conv = MT.MinkowskiConvolution(3, 8, kernel_size=3, dimension=3, device="cpu")
        self.bn = MT.MinkowskiBatchNorm(8, device="cpu")
        self.relu = MT.MinkowskiReLU()
        self.head = MT.MinkowskiConvolution(8, CLASSES, kernel_size=1, dimension=3, device="cpu")

    def forward(self, x):
        return self.head(self.relu(self.bn(self.conv(x))))


def _tnet(state):
    from minkowskiengine_tpu_torch.utils.torch_import import load_state_dict_from_reference

    net = TNet()
    load_state_dict_from_reference(net, state)
    return net


def _grads(net):
    return {k: p.grad.numpy().copy() for k, p in net.named_parameters()}


def _cases(world, rank, state):
    """Every case of one rank; returns numpy results."""
    out = {}
    mesh = make_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data",) and mesh.device_type == "cpu"
    ce = torch.nn.functional.cross_entropy

    # shared geometry, each rank its own features and labels
    coords, _ = _cloud(0)
    x0 = MT.SparseTensor(torch.zeros(len(coords), 3), torch.from_numpy(coords), device="cpu")
    mgr, key = x0.coordinate_manager, x0.coordinate_map_key
    feats, labels = shard_batch(_shared_batch(world, len(coords)), mesh)
    assert feats.shape == (1, len(coords), 3)

    def loss_fn(model, f, lab):
        xt = MT.SparseTensor(f[0], coordinate_map_key=key, coordinate_manager=mgr)
        return ce(model(xt).F, lab[0])

    net = _tnet(state)
    opt = torch.optim.SGD(net.parameters(), lr=LR)
    step = make_data_parallel_step(net, opt, loss_fn, mesh)
    loss = step(net, opt, feats, labels)
    out["shared"] = (loss.item(), _grads(net),
                     {k: p.detach().numpy().copy() for k, p in net.named_parameters()})

    # per-device geometry: every rank builds every cloud's geometry, as the
    # host of a JAX mesh stacks them; shard_batch leaves each its own
    warm_c, warm_f = _cloud(99)
    net = _tnet(state)
    xw = MT.SparseTensor(torch.from_numpy(warm_f), torch.from_numpy(warm_c), device="cpu")
    net(xw)
    replayer = MT.GeometryReplayer(xw.coordinate_manager)
    clouds = [_cloud(s) for s in range(1, 1 + world)]
    geos, fps = [], []
    for c, f in clouds:
        m = replayer(torch.from_numpy(c))
        geo = m.export_geometry()
        geos.append(geo)
        fps.append(m.reduce_features(geo.entry_key, torch.from_numpy(f)))
    mine = shard_batch(MT.stack_geometries(geos), mesh)
    assert len(next(iter(mine.row_shapes.values()))) == 1

    def geo_loss(model, geo, f, lab):
        view = MT.CoordinateManager.from_geometry(geo)
        xt = MT.SparseTensor(f, coordinate_map_key=geo.entry_key, coordinate_manager=view)
        return ce(model(xt).F, lab)

    opt = torch.optim.SGD(net.parameters(), lr=LR)
    step = make_per_device_geometry_step(net, opt, geo_loss, mesh)
    n_rows = len(clouds[rank][0])
    loss = step(net, opt, mine, fps[rank], torch.from_numpy(_labels(1 + rank, n_rows)))
    out["geometry"] = (loss.item(), _grads(net))

    # each rank its own metrics, averaged
    got = all_reduce_metrics({"loss": float(rank + 1), "acc": torch.tensor([rank, 2.0 * rank])},
                             mesh)
    out["metrics"] = {k: v.numpy() for k, v in got.items()}

    # replicate: rank-dependent values become rank 0's
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(rank)
        lin.bias.fill_(-rank)
    t = replicate({"m": lin, "t": torch.full((2,), float(rank))}, mesh)
    out["replicate"] = (lin.weight.detach().numpy().copy(), lin.bias.detach().numpy().copy(),
                        t["t"].numpy())
    out["shard"] = shard_batch([np.arange(2 * world * 3).reshape(2 * world, 3)], mesh)[0].numpy()

    # sync batch norm over the mesh's axis: this rank's block of the rows
    rows = np.random.RandomState(3).randn(8 * world, 5).astype(np.float32) + 2.0
    c = np.stack([np.zeros(8 * world), np.arange(8 * world), np.zeros(8 * world),
                  np.zeros(8 * world)], 1).astype(np.int32)
    sync = MT.MinkowskiSyncBatchNorm(5, process_group=mesh, axis_name="data", device="cpu")
    mine_rows = slice(8 * rank, 8 * rank + 8)
    y = sync(MT.SparseTensor(torch.from_numpy(rows[mine_rows]), torch.from_numpy(c[mine_rows])))
    out["sync_bn"] = (y.F.detach().numpy(), sync.bn.running_var.numpy().copy())

    # batch norm with JAX's axis_name, inside the entered mesh and outside it,
    # beside the sync batch norm: forward and backward on this rank's rows
    g = np.random.RandomState(4).randn(8 * world, 5).astype(np.float32)
    runs = {}
    for name, bn, entered in (
        ("axis", MT.MinkowskiBatchNorm(5, axis_name="data", device="cpu"), True),
        ("sync", MT.MinkowskiSyncBatchNorm(5, process_group=mesh, axis_name="data", device="cpu"),
         True),
        ("outside", MT.MinkowskiBatchNorm(5, axis_name="data", device="cpu"), False),
        ("plain", MT.MinkowskiBatchNorm(5, device="cpu"), False),
    ):
        f = torch.from_numpy(rows[mine_rows]).requires_grad_()
        with mesh if entered else contextlib.nullcontext():
            y = bn(MT.SparseTensor(f, torch.from_numpy(c[mine_rows])))
            y.F.backward(torch.from_numpy(g[mine_rows]))
        runs[name] = [y.F.detach().numpy(), f.grad.numpy(), bn.bn.running_mean.numpy().copy(),
                      bn.bn.running_var.numpy().copy(), bn.bn.weight.grad.numpy().copy(),
                      bn.bn.bias.grad.numpy().copy()]
    out["axis_bn"] = runs

    # one buffer in the parameters' dtype; two dtypes are refused
    lin = torch.nn.Linear(3, 2)
    for p in lin.parameters():
        p.grad = torch.full_like(p, float(rank + 1))
    comm.reset_counts()
    loss = average_gradients(lin, mesh.get_group("data"),
                             torch.tensor(float(rank), dtype=torch.float64))
    mixed = torch.nn.Module()
    mixed.a = torch.nn.Parameter(torch.zeros(3))
    mixed.b = torch.nn.Parameter(torch.zeros(2, dtype=torch.float64))
    try:
        average_gradients(mixed, mesh.get_group("data"), loss)
        refused = False
    except TypeError:
        refused = True
    out["average"] = ([p.grad.numpy().copy() for p in lin.parameters()], loss.item(),
                      loss.dtype, comm.counts["all_reduce"], refused)
    return out


def _worker(rank, world, path):
    torch.set_num_threads(1)
    state = dict(np.load(f"{path}/state.npz"))
    dist.init_process_group("gloo", init_method=f"file://{path}/store", rank=rank,
                            world_size=world)
    try:
        torch.save(_cases(world, rank, state), f"{path}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _jax_net():
    from flax import nnx

    import minkowskiengine_tpu as ME

    class JNet(ME.MinkowskiNetwork):
        def __init__(self, rngs):
            super().__init__(3)
            self.conv = ME.MinkowskiConvolution(3, 8, kernel_size=3, dimension=3, rngs=rngs)
            self.bn = ME.MinkowskiBatchNorm(8)
            self.relu = ME.MinkowskiReLU()
            self.head = ME.MinkowskiConvolution(8, CLASSES, kernel_size=1, dimension=3,
                                                rngs=rngs)

        def __call__(self, x):
            return self.head(self.relu(self.bn(self.conv(x))))

    return JNet(nnx.Rngs(0))


def _jax_grad(jnet, coords, feats, labels):
    """Loss and gradients (reference names) of one single-device step on a
    fresh manager, in train mode."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import nnx

    import minkowskiengine_tpu as ME
    from minkowskiengine_tpu.utils.torch_import import export_reference_state_dict

    def loss(model):
        xt = ME.SparseTensor(feats, coords)
        logits = model(xt).padded_features[: xt.size]
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, labels))

    value, grads = nnx.value_and_grad(loss)(jnet)
    nnx.update(jnet, jax.tree.map(np.asarray, grads))  # the gradients, named as parameters
    named = export_reference_state_dict(jnet)
    return float(value), {k: v for k, v in named.items() if "running" not in k
                          and "num_batches" not in k}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds run while the parent computes JAX's references."""
    from minkowskiengine_tpu.utils.torch_import import export_reference_state_dict

    jnet = _jax_net()
    state = export_reference_state_dict(jnet)
    ctxs = {}
    for world in WORLDS:
        path = tmp_path_factory.mktemp(f"dp{world}")
        np.savez(path / "state.npz", **state)  # a file: spawn args block on a full pipe
        ctxs[world] = (path, mp.start_processes(_worker, args=(world, str(path)),
                                                nprocs=world, join=False, start_method="spawn"))
    ref = {"state": state, "shared": {}, "geometry": {}}
    coords, _ = _cloud(0)
    for world in WORLDS:
        feats, labels = _shared_batch(world, len(coords))
        ref["shared"][world] = [_jax_grad(_jax_net(), coords, feats[r], labels[r])
                                for r in range(world)]
    for s in range(1, 1 + max(WORLDS)):
        c, f = _cloud(s)
        ref["geometry"][s] = _jax_grad(_jax_net(), c, f, _labels(s, len(c)))
    out = {}
    for world, (path, ctx) in ctxs.items():
        while not ctx.join(timeout=300):
            pass
        out[world] = [torch.load(f"{path}/rank{r}.pt", weights_only=False) for r in range(world)]
    return out, ref


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _mean(runs):
    return float(np.mean([r[0] for r in runs])), {
        k: np.mean([r[1][k] for r in runs], axis=0) for k in runs[0][1]}


@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_step_is_the_mean_of_single_device_steps(worlds, world):
    res, ref = worlds
    loss, grads = _mean(ref["shared"][world])
    for r, got in enumerate(res[world]):
        g_loss, g_grads, params = got["shared"]
        assert abs(g_loss - loss) <= RTOL * abs(loss), r
        assert set(g_grads) == set(grads)
        for k, g in grads.items():
            assert _rel(g_grads[k], g) <= RTOL, (r, k)
            # SGD stepped on the averaged gradient, the same on every rank
            assert _rel(params[k], ref["state"][k] - LR * g_grads[k]) <= 1e-6, (r, k)
            assert np.array_equal(params[k], res[world][0]["shared"][2][k]), (r, k)


@pytest.mark.parametrize("world", WORLDS)
def test_per_device_geometry_step_is_the_mean_of_eager_jax_steps(worlds, world):
    res, ref = worlds
    loss, grads = _mean([ref["geometry"][s] for s in range(1, 1 + world)])
    for r, got in enumerate(res[world]):
        g_loss, g_grads = got["geometry"]
        assert abs(g_loss - loss) <= RTOL * abs(loss), r
        for k, g in grads.items():
            assert _rel(g_grads[k], g) <= RTOL, (r, k)


@pytest.mark.parametrize("world", WORLDS)
def test_all_reduce_metrics_means_each_ranks_own_value(worlds, world):
    """The kept divergence: JAX's ``all_reduce_metrics`` takes one array
    with a leading device axis; the port's takes each rank's own value.
    Both give the mean over the devices."""
    import jax.numpy as jnp

    from minkowskiengine_tpu.parallel import all_reduce_metrics as j_all_reduce_metrics
    from minkowskiengine_tpu.parallel import make_mesh as j_make_mesh

    res, _ = worlds
    stacked = {"loss": jnp.asarray([r + 1.0 for r in range(world)]),
               "acc": jnp.asarray([[r, 2.0 * r] for r in range(world)])}
    want = j_all_reduce_metrics(stacked, j_make_mesh(world))
    for got in res[world]:
        for k in ("loss", "acc"):
            np.testing.assert_allclose(got["metrics"][k], np.asarray(want[k]), rtol=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_replicate_and_shard_batch(worlds, world):
    res, _ = worlds
    for r, got in enumerate(res[world]):
        w, b, t = got["replicate"]
        assert (w == 0).all() and (b == 0).all() and (t == 0).all(), r
        np.testing.assert_array_equal(
            got["shard"], np.arange(2 * world * 3).reshape(2 * world, 3)[2 * r:2 * r + 2])


@pytest.mark.parametrize("world", WORLDS)
def test_sync_batch_norm_over_a_mesh_axis(worlds, world):
    res, _ = worlds
    rows = np.random.RandomState(3).randn(8 * world, 5).astype(np.float32) + 2.0
    c = np.stack([np.zeros(8 * world), np.arange(8 * world), np.zeros(8 * world),
                  np.zeros(8 * world)], 1).astype(np.int32)
    bn = MT.MinkowskiBatchNorm(5, device="cpu")
    want = bn(MT.SparseTensor(torch.from_numpy(rows), torch.from_numpy(c))).F.detach().numpy()
    for r, got in enumerate(res[world]):
        out, running_var = got["sync_bn"]
        assert _rel(out, want[8 * r:8 * r + 8]) <= RTOL, r
        assert _rel(running_var, bn.bn.running_var.numpy()) <= RTOL, r


@pytest.mark.parametrize("world", WORLDS)
def test_batch_norm_with_an_axis_name_is_the_sync_batch_norm_inside_the_mesh(worlds, world):
    """``MinkowskiBatchNorm(axis_name="data")`` inside the entered mesh
    equals ``MinkowskiSyncBatchNorm`` over the same axis, bit for bit
    (output, input gradient, running statistics, this rank's share of the
    affine gradients); outside any mesh it is batch norm on the rank's own
    rows, as JAX's is outside a ``shard_map``."""
    res, _ = worlds
    for got in res[world]:
        runs = got["axis_bn"]
        for a, b in zip(runs["axis"], runs["sync"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(runs["outside"], runs["plain"]):
            np.testing.assert_array_equal(a, b)
        assert not np.array_equal(runs["axis"][0], runs["plain"][0])  # the mesh's rows count


@pytest.mark.parametrize("world", WORLDS)
def test_average_gradients_takes_one_buffer(worlds, world):
    res, _ = worlds
    mean = (world + 1) / 2
    for r, got in enumerate(res[world]):
        grads, loss, loss_dtype, all_reduces, refused = got["average"]
        for g in grads:
            np.testing.assert_array_equal(g, np.full(g.shape, mean, np.float32))
        assert loss == (world - 1) / 2 and loss_dtype == torch.float32, r
        assert all_reduces == 1 and refused, r
