"""``parallel.spatial``: one cloud split across processes, against JAX.

Gloo worlds of 2 and 4 processes (spawned once per world; the workers
import torch, numpy and the port only), each rank holding one row block of
every map (``torch.tensor_split``'s rule).  The parent runs the JAX
package single-device on the same seeded clouds and weights:

- ``spatial_conv_apply`` forward, input gradient and weight gradient of
  Σ out² (k = 3) against JAX's ``sparse_conv`` and its VJP, the all-gather
  fallback, a strided (k = 2, s = 2) map, the dropped count of a halo too
  narrow (the valid pairs that leave their window, counted in numpy from
  the block rule), and the small conv → batch norm → ReLU → strided conv →
  global-average network of ``tests/test_spatial_sharding.py`` through
  ``spatial_masked_moments`` and ``spatial_global_avg``: within 1e-5 of
  max|ref| (float32 sums of at most 27 products per row, in the same
  order; the weight gradient and the pooled sums over a few thousand rows
  in another).
- ``MinkowskiBatchNorm`` in train mode on a row block: the whole cloud's
  statistics (a kept divergence, ROADMAP queue 3: summed (count, Σx, Σx²)
  over the group) against JAX's batch norm on every row, 1e-5.
- MinkUNet14A in eval mode (every batch norm's running statistics, which
  JAX's ``nnx`` ``eval()`` leaves untouched, so the JAX model's batch norms
  are switched one by one) under ``MT.spatial_execution``: forward and the
  backward of Σ out², at the JAX test's tolerances (rtol 1e-4, atol 1e-4;
  gradients rtol 2e-3, atol 2e-4 · max|grad|).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.parallel import comm
from minkowskiengine_tpu_torch.parallel.spatial import (
    block_bounds,
    gather_rows,
    make_spatial_mesh,
    required_halo,
    shard_rows,
    shard_sparse_tensor,
    spatial_conv_apply,
    spatial_global_avg,
    spatial_masked_moments,
)

RTOL = 1e-5
WORLDS = (2, 4)
UNET_CLASSES = 4


def _cloud(seed=0, n=1500, lo=-25, hi=25, batches=2):
    """The cloud of ``tests/test_spatial_sharding.py``."""
    rng = np.random.RandomState(seed)
    coords = np.unique(np.concatenate(
        [rng.randint(0, batches, (n * 2, 1)), rng.randint(lo, hi, (n * 2, 3))], axis=1,
    ).astype(np.int32), axis=0)[:n]
    return coords, rng.randn(len(coords), 3).astype(np.float32)


def _weights():
    rng = np.random.RandomState(0)
    return {"W": rng.randn(27, 3, 16).astype(np.float32),
            "W2": rng.randn(8, 3, 4).astype(np.float32),
            "W3": rng.randn(8, 16, 8).astype(np.float32),
            "bn_x": (rng.randn(1500, 16) * 3 + 1).astype(np.float32)}


def _room():
    from minkowskiengine_tpu_torch.utils.datasets import room_scan_voxels

    return room_scan_voxels(voxel_size=0.12, n_points=8_000, extent=(1.2, 1.2, 1.4),
                            n_objects=2, seed=5)


def _cases(world, rank, unet_state):
    mesh = make_spatial_mesh(device="cpu")
    wts = {k: torch.from_numpy(v) for k, v in _weights().items()}
    coords, feats = _cloud()
    x = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords), device="cpu")
    mgr, key = x.coordinate_manager, x.coordinate_map_key
    km = mgr.kernel_map(key, key, kernel_size=3, stride=1)
    n = km.n_in
    out = {"halo": required_halo(km, world), "in_idx": km.in_idx.numpy()}

    # forward, input gradient and weight gradient of sum(out^2)
    f = shard_rows(x.F, mesh).requires_grad_()
    w = wts["W"].clone().requires_grad_()
    before = dict(comm.counts)
    y, dropped = spatial_conv_apply(f, w, km, mesh=mesh)
    (y * y).sum().backward()
    out["conv_collectives"] = {k: comm.counts[k] - before[k] for k in before}
    out["conv"] = (gather_rows(y.detach(), n, mesh).numpy(), int(dropped),
                   gather_rows(f.grad, n, mesh).numpy(), w.grad.numpy())
    y_fb, d_fb = spatial_conv_apply(f.detach(), wts["W"], km, mesh=mesh, force_all_gather=True)
    out["fallback"] = (gather_rows(y_fb, n, mesh).numpy(), int(d_fb))
    _, d0 = spatial_conv_apply(f.detach(), wts["W"], km, mesh=mesh, halo=0)
    out["narrow"] = int(d0)

    # a strided map: out rows differ from in rows
    okey = mgr.stride(key, 2)
    km2 = mgr.kernel_map(key, okey, kernel_size=2, stride=2)
    f2 = shard_rows(x.F, mesh).requires_grad_()
    w2 = wts["W2"].clone().requires_grad_()
    y2, d2 = spatial_conv_apply(f2, w2, km2, mesh=mesh)
    (y2 * y2).sum().backward()
    out["strided"] = (gather_rows(y2.detach(), km2.n_out, mesh).numpy(), int(d2),
                      gather_rows(f2.grad, n, mesh).numpy(), w2.grad.numpy())

    # conv -> batch norm (space) -> relu -> strided conv -> global average
    h, d1 = spatial_conv_apply(shard_rows(x.F, mesh), wts["W"], km, mesh=mesh)
    mean, var = spatial_masked_moments(h, torch.ones(h.shape[0], dtype=torch.bool), mesh=mesh)
    h = torch.relu((h - mean) * torch.rsqrt(var + 1e-5))
    h2, d3 = spatial_conv_apply(h, wts["W3"], km2, mesh=mesh)
    lo, hi = block_bounds(km2.n_out, world, rank)
    bids = mgr.get_coordinates(okey)[lo:hi, 0]
    out["net"] = (spatial_global_avg(h2, bids, 2, mesh=mesh).numpy(), int(d1 + d3))

    # train-mode batch norm on a row block: the whole cloud's statistics
    bn = MT.MinkowskiBatchNorm(16, device="cpu")
    xb = shard_sparse_tensor(MT.SparseTensor(wts["bn_x"][:n], coordinate_map_key=key,
                                             coordinate_manager=mgr), mesh)
    yb = bn.train()(xb)
    out["bn"] = (gather_rows(yb.F.detach(), n, mesh).numpy(),
                 bn.bn.running_mean.numpy().copy(), bn.bn.running_var.numpy().copy())

    # MinkUNet14A in eval mode under spatial execution
    from minkowskiengine_tpu_torch.models import MinkUNet14A
    from minkowskiengine_tpu_torch.utils.torch_import import load_state_dict_from_reference

    rc, rf = _room()
    net = MinkUNet14A(3, UNET_CLASSES, D=3, device="cpu").eval()
    load_state_dict_from_reference(net, unet_state)
    xr = MT.SparseTensor(torch.from_numpy(rf), torch.from_numpy(rc), device="cpu")
    net(xr)  # every map built, as on every rank
    xs = shard_sparse_tensor(xr, mesh)
    with MT.spatial_execution(mesh):
        yu = net(xs)
        (yu.F ** 2).sum().backward()
    grads = {k: p.grad.numpy().copy() for k, p in net.named_parameters()}
    flat = torch.cat([torch.from_numpy(g).double().reshape(-1) for g in grads.values()])
    first = flat.clone()
    dist.broadcast(first, src=0)  # every rank holds the whole gradient: rank 0 returns it
    out["unet"] = (gather_rows(yu.F.detach(), xr.size, mesh).numpy(),
                   grads if rank == 0 else None, bool(torch.equal(flat, first)))
    out["unet_row_block"] = yu.row_block is not None and yu.F.shape[0] == len(yu.C)
    try:
        yu.dense()
        out["dense_raises"] = False
    except ValueError:
        out["dense_raises"] = True
    return out


def _worker(rank, world, path):
    torch.set_num_threads(1)
    unet_state = dict(np.load(f"{path}/state.npz"))
    dist.init_process_group("gloo", init_method=f"file://{path}/store", rank=rank,
                            world_size=world)
    try:
        torch.save(_cases(world, rank, unet_state), f"{path}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _jax_eval(net):
    """Every JAX batch norm in eval mode (``nnx``'s ``eval()`` does not
    reach their own ``training`` flag)."""
    from flax import nnx

    import minkowskiengine_tpu as ME

    for _, m in nnx.iter_graph(net):
        if isinstance(m, ME.MinkowskiBatchNorm):
            m.eval()
    return net


def _jax_refs():
    import jax
    import jax.numpy as jnp
    from flax import nnx

    import minkowskiengine_tpu as ME
    from minkowskiengine_tpu.ops.functional import sparse_conv

    wts = {k: jnp.asarray(v) for k, v in _weights().items()}
    coords, feats = _cloud()
    x = ME.SparseTensor(feats, coords)
    n = x.size
    mgr, key = x.coordinate_manager, x.coordinate_map_key
    km = mgr.kernel_map(key, key, kernel_size=3, stride=1)
    okey = mgr.stride(key, 2)
    km2 = mgr.kernel_map(key, okey, kernel_size=2, stride=2)
    n2 = mgr.size(okey)

    def conv_loss(f, w, k):
        o = sparse_conv(f, w, k.in_idx, k.out_idx_t)
        return jnp.sum(o * o), o

    ref = {}
    for name, w, k, n_out in (("conv", wts["W"], km, n), ("strided", wts["W2"], km2, n2)):
        (_, o), (df, dw) = jax.value_and_grad(conv_loss, argnums=(0, 1), has_aux=True)(
            x.padded_features, w, k)
        ref[name] = (np.asarray(o)[:n_out], np.asarray(df)[:n], np.asarray(dw))

    valid = jnp.asarray(np.arange(x.capacity) < n)
    h = sparse_conv(x.padded_features, wts["W"], km.in_idx, km.out_idx_t)
    m = valid.astype(jnp.float32)[:, None]
    mean = jnp.sum(h * m, 0) / n
    var = jnp.sum(h * h * m, 0) / n - mean * mean
    h = jnp.where(valid[:, None], jax.nn.relu((h - mean) * jax.lax.rsqrt(var + 1e-5)), 0.0)
    h2 = np.asarray(sparse_conv(h, wts["W3"], km2.in_idx, km2.out_idx_t))[:n2]
    bids = np.asarray(mgr.get_coordinate_map(okey).coordinates)[:n2, 0]
    ref["net"] = np.stack([h2[bids == b].mean(0) for b in range(2)])

    bn = ME.MinkowskiBatchNorm(16)
    xb = ME.SparseTensor(np.asarray(wts["bn_x"])[:n], coordinate_map_key=key,
                         coordinate_manager=mgr)
    ref["bn"] = (np.asarray(bn(xb).padded_features)[:n], np.asarray(bn.running_mean[...]),
                 np.asarray(bn.running_var[...]))
    return ref


def _jax_unet():
    """JAX's MinkUNet14A in eval mode on the room cloud, and its exported
    weights."""
    from flax import nnx

    import minkowskiengine_tpu as ME
    from minkowskiengine_tpu.models import MinkUNet14A
    from minkowskiengine_tpu.utils.torch_import import export_reference_state_dict

    rc, rf = _room()
    net = _jax_eval(MinkUNet14A(3, UNET_CLASSES, D=3, rngs=nnx.Rngs(0)))
    return net, ME.SparseTensor(rf, rc), export_reference_state_dict(net)


def _jax_unet_run(net, x, state):
    """Its output rows and reference-named gradients of Σ out²."""
    import jax
    import jax.numpy as jnp
    from flax import nnx

    import minkowskiengine_tpu as ME
    from minkowskiengine_tpu.utils.torch_import import export_reference_state_dict

    net(x)  # the coordinate phase, eagerly

    def loss(model, feats):
        xt = ME.SparseTensor(feats, coordinate_map_key=x.coordinate_map_key,
                             coordinate_manager=x.coordinate_manager)
        o = model(xt).padded_features
        return jnp.sum(jnp.where(xt.valid_row_mask[:, None], o, 0.0) ** 2), o

    (_, o), grads = nnx.jit(nnx.value_and_grad(loss, has_aux=True))(net, x.padded_features)
    nnx.update(net, jax.tree.map(np.asarray, grads))
    named = export_reference_state_dict(net)
    return np.asarray(o)[: x.size], {k: v for k, v in named.items() if k in state
                                     and "running" not in k and "num_batches" not in k}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds run while the parent computes JAX's references."""
    jnet, jx, state = _jax_unet()
    ctxs = {}
    for world in WORLDS:
        path = tmp_path_factory.mktemp(f"sp{world}")
        np.savez(path / "state.npz", **state)  # a file: spawn args block on a full pipe
        ctxs[world] = (path, mp.start_processes(_worker, args=(world, str(path)),
                                                nprocs=world, join=False, start_method="spawn"))
    ref = _jax_refs()
    ref["unet"] = _jax_unet_run(jnet, jx, state)
    out = {}
    for world, (path, ctx) in ctxs.items():
        while not ctx.join(timeout=300):
            pass
        out[world] = [torch.load(f"{path}/rank{r}.pt", weights_only=False) for r in range(world)]
    return out, ref


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("world", WORLDS)
def test_conv_forward_and_gradients_match_jax(worlds, world):
    res, ref = worlds
    want_out, want_df, want_dw = ref["conv"]
    for r, got in enumerate(res[world]):
        out, dropped, df, dw = got["conv"]
        assert dropped == 0, r
        assert _rel(out, want_out) <= RTOL and _rel(df, want_df) <= RTOL, r
        assert _rel(dw, want_dw) <= RTOL, r
        assert got["halo"] == res[world][0]["halo"] and 0 < got["halo"][0] <= 1500 // world
        # forward: one all-gather of the edge bands and one all-reduce of
        # the dropped count; backward: the bands of G and dW's all-reduce
        c = got["conv_collectives"]
        assert (c["all_gather"], c["all_reduce"]) == (2, 2), c


@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_fallback_matches_jax(worlds, world):
    res, ref = worlds
    for got in res[world]:
        out, dropped = got["fallback"]
        assert dropped == 0 and _rel(out, ref["conv"][0]) <= RTOL


@pytest.mark.parametrize("world", WORLDS)
def test_narrow_halo_counts_every_dropped_pair(worlds, world):
    res, _ = worlds
    in_idx = res[world][0]["in_idx"]
    n = in_idx.shape[1]
    want = 0
    for r in range(world):
        lo, hi = block_bounds(n, world, r)
        cols = in_idx[:, lo:hi]
        want += int(((cols >= 0) & ((cols < lo) | (cols >= hi))).sum())
    assert want > 0
    assert all(got["narrow"] == want for got in res[world])


@pytest.mark.parametrize("world", WORLDS)
def test_strided_map_matches_jax(worlds, world):
    res, ref = worlds
    for got in res[world]:
        out, dropped, df, dw = got["strided"]
        assert dropped == 0
        for a, b in zip((out, df, dw), ref["strided"]):
            assert _rel(a, b) <= RTOL


@pytest.mark.parametrize("world", WORLDS)
def test_small_network_matches_jax(worlds, world):
    res, ref = worlds
    for got in res[world]:
        pooled, dropped = got["net"]
        assert dropped == 0 and _rel(pooled, ref["net"]) <= RTOL


@pytest.mark.parametrize("world", WORLDS)
def test_batch_norm_on_a_row_block_takes_the_whole_clouds_statistics(worlds, world):
    res, ref = worlds
    for got in res[world]:
        for a, b in zip(got["bn"], ref["bn"]):
            assert _rel(a, b) <= RTOL


@pytest.mark.parametrize("world", WORLDS)
def test_minkunet14a_under_spatial_execution_matches_jax(worlds, world):
    res, ref = worlds
    want_out, want_grads = ref["unet"]
    scale = max(1.0, max(np.abs(g).max() for g in want_grads.values()))
    grads = res[world][0]["unet"][1]
    assert set(grads) == set(want_grads)
    for k, g in want_grads.items():
        np.testing.assert_allclose(grads[k].reshape(g.shape), g, rtol=2e-3, atol=2e-4 * scale,
                                   err_msg=k)
    for got in res[world]:
        out, _, same = got["unet"]
        np.testing.assert_allclose(out, want_out, rtol=1e-4, atol=1e-4)
        assert same and got["unet_row_block"] and got["dense_raises"]
