"""``parallel.tensor_parallel``: column-parallel convs across processes,
against the JAX package.

Gloo worlds of 2 and 4 processes (spawned once per world; the workers
import torch, numpy and the port only) run MinkUNet14A(3, 4) with JAX's
exported weights on the cloud of ``tests/test_tensor_parallel.py``: at tp =
2 and 4 on a ("model",) mesh, and on a 2 × 2 ("data", "model") mesh whose
two data replicas take the same batch.  Each rank's K1 computes its Cout
slice, an all-gather rebuilds the columns, and the input gradient's shares
are all-reduced.  The parent runs JAX's unsharded model single-device.
As in JAX's test, batch norm is in train mode: the forward logits within
rtol 2e-5, atol 2e-5; after one SGD step (lr 1e-2, mean cross-entropy) the
loss within 2e-5 and every parameter within rtol 2e-4, atol 1e-4.  Each
rank's gradients are also held to the port's unsharded step in the same
process: within 1e-4 of max|ref| per tensor, the column split changes only
the order of the input gradient's sum.  A conv whose Cout does not divide
by the axis stays whole; the sharded model's exported state dict equals
JAX's.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.models import MinkUNet14A
from minkowskiengine_tpu_torch.parallel import (
    apply_tensor_parallelism,
    make_data_parallel_step,
    make_tp_mesh,
)
from minkowskiengine_tpu_torch.utils.torch_import import (
    export_reference_state_dict,
    load_state_dict_from_reference,
)

LR = 1e-2
CLASSES = 4
# (world, tp, dp); a world of 4 runs both of its meshes
MESHES = ((2, 2, 1), (4, 4, 1), (4, 2, 2))
WORLDS = (2, 4)


def _cloud(seed=0, n=300, hi=20):
    rng = np.random.RandomState(seed)
    c = np.unique(np.concatenate([rng.randint(0, 2, (n, 1)), rng.randint(0, hi, (n, 3))],
                                 axis=1).astype(np.int32), axis=0)
    return c, rng.randn(len(c), 3).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _labels(n):
    return np.random.RandomState(0).randint(0, CLASSES, n).astype(np.int64)


def _same_on_every_rank(named) -> bool:
    """Whether every rank holds rank 0's values (the results stay small:
    rank 0 alone returns the arrays)."""
    flat = torch.cat([torch.as_tensor(v).double().reshape(-1) for v in named.values()])
    first = flat.clone()
    dist.broadcast(first, src=0)
    return bool(torch.equal(flat, first))


def _step(net, x, labels, mesh=None):
    """Forward logits, then one SGD step of the mean cross-entropy:
    (logits, loss, gradients, parameters after the step)."""
    opt = torch.optim.SGD(net.parameters(), lr=LR)

    def loss_fn(model, lab):
        return torch.nn.functional.cross_entropy(model(x).F, lab)

    with torch.no_grad():
        logits = net(x).F.numpy()
    if mesh is None:
        opt.zero_grad()
        loss = loss_fn(net, labels)
        loss.backward()
        opt.step()
    else:  # averaged over the data axis of a 2-D mesh, as a user trains it
        loss = make_data_parallel_step(net, opt, loss_fn, mesh)(net, opt, labels)
    grads = {k: p.grad for k, p in net.named_parameters()}
    for name, m in net.named_modules():  # each cut gradient gathered whole
        cp = getattr(m, "column_parallel", None)
        for path, dim in (cp.sharded if cp is not None else ()):
            grads[f"{name}.{path}"] = cp.whole(grads[f"{name}.{path}"], dim)
    return (logits, loss.item(), {k: g.numpy().copy() for k, g in grads.items()},
            export_reference_state_dict(net))


def _cases(tp, dp, state):
    out = {}
    mesh = make_tp_mesh(tp, dp=dp, device="cpu")
    out["axes"] = mesh.mesh_dim_names
    c, f = _cloud()
    x = MT.SparseTensor(torch.from_numpy(f), torch.from_numpy(c), device="cpu")
    labels = torch.from_numpy(_labels(len(c)))

    plain = MinkUNet14A(3, CLASSES, D=3, device="cpu")
    load_state_dict_from_reference(plain, state)
    _, p_loss, p_grads, _ = _step(plain, x, labels)

    net = MinkUNet14A(3, CLASSES, D=3, device="cpu")
    load_state_dict_from_reference(net, state)
    apply_tensor_parallelism(net, mesh)
    out["cut"] = {k: tuple(p.shape) for k, p in net.named_parameters()}
    # gathered whole, as the unsharded model's
    out["export_differs"] = [k for k, v in export_reference_state_dict(net).items()
                             if not np.array_equal(v, state[k])]
    logits, loss, grads, after = _step(net, x, labels, mesh if dp > 1 else None)
    out["logits"], out["loss"], out["plain_loss"] = logits, loss, p_loss
    out["grad_vs_plain"] = {k: _rel(grads[k], g) for k, g in p_grads.items()}
    out["same_on_every_rank"] = _same_on_every_rank(after)
    out["after"] = after if dist.get_rank() == 0 else None

    # Cout 6: cut at tp = 2, whole at tp = 4
    conv = MT.MinkowskiConvolution(3, 6, kernel_size=3, dimension=3, device="cpu")
    apply_tensor_parallelism(conv, mesh)
    out["conv6"] = (tuple(conv.kernel.shape), hasattr(conv, "column_parallel"))
    return out


def _worker(rank, world, path):
    torch.set_num_threads(1)
    state = dict(np.load(f"{path}/state.npz"))
    dist.init_process_group("gloo", init_method=f"file://{path}/store", rank=rank,
                            world_size=world)
    try:
        res = {(w, tp, dp): _cases(tp, dp, state) for w, tp, dp in MESHES if w == world}
        torch.save(res, f"{path}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _jax_net():
    from flax import nnx

    from minkowskiengine_tpu.models import MinkUNet14A as JMinkUNet14A

    return JMinkUNet14A(3, CLASSES, D=3, rngs=nnx.Rngs(0))


def _jax_step(net):
    """Logits, then loss and parameters after one SGD step, train mode."""
    import jax.numpy as jnp
    import optax
    from flax import nnx

    import minkowskiengine_tpu as ME
    from minkowskiengine_tpu.utils.torch_import import export_reference_state_dict as j_export

    c, f = _cloud()
    x = ME.SparseTensor(f, c)
    logits = np.asarray(net(x).padded_features)[: x.size]
    labels = jnp.asarray(np.pad(_labels(x.size), (0, x.capacity - x.size)))
    mgr, key = x.coordinate_manager, x.coordinate_map_key

    def loss_fn(model, feats):
        xt = ME.SparseTensor(feats, coordinate_map_key=key, coordinate_manager=mgr)
        losses = optax.softmax_cross_entropy_with_integer_labels(model(xt).padded_features,
                                                                 labels)
        mask = xt.valid_row_mask.astype(jnp.float32)
        return jnp.sum(losses * mask) / jnp.sum(mask)

    opt = nnx.Optimizer(net, optax.sgd(LR), wrt=nnx.Param)

    @nnx.jit
    def step(model, opt, feats):
        loss, grads = nnx.value_and_grad(loss_fn)(model, feats)
        opt.update(model, grads)
        return loss

    loss = float(step(net, opt, x.padded_features))
    return logits, loss, j_export(net)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Every mesh runs while the parent computes JAX's step."""
    from minkowskiengine_tpu.utils.torch_import import export_reference_state_dict as j_export

    jnet = _jax_net()
    state = j_export(jnet)
    out = {}
    for world in WORLDS:
        path = tmp_path_factory.mktemp(f"tp{world}")
        np.savez(path / "state.npz", **state)  # a file: spawn args block on a full pipe
        ctx = mp.start_processes(_worker, args=(world, str(path)), nprocs=world,
                                 join=False, start_method="spawn")
        out[world] = (path, ctx)
    ref = (state,) + _jax_step(jnet)
    res = {}
    for world, (path, ctx) in out.items():
        while not ctx.join(timeout=300):
            pass
        ranks = [torch.load(f"{path}/rank{r}.pt", weights_only=False) for r in range(world)]
        res.update({m: [got[m] for got in ranks] for m in ranks[0]})
    return res, ref


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"world{m[0]}-tp{m[1]}-dp{m[2]}")
def test_forward_matches_jax(meshes, mesh):
    res, (_, logits, _, _) = meshes
    for got in res[mesh]:
        assert got["axes"] == (("model",) if mesh[2] == 1 else ("data", "model"))
        np.testing.assert_allclose(got["logits"], logits, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"world{m[0]}-tp{m[1]}-dp{m[2]}")
def test_training_step_matches_jax(meshes, mesh):
    res, (_, _, loss, after) = meshes
    params = res[mesh][0]["after"]
    for k, v in after.items():
        if "running" not in k and "num_batches" not in k:  # the parameters
            np.testing.assert_allclose(params[k].reshape(v.shape), v, rtol=2e-4, atol=1e-4,
                                       err_msg=k)
    for got in res[mesh]:
        assert abs(got["loss"] - loss) < 2e-5
        assert abs(got["loss"] - got["plain_loss"]) <= 1e-6 * abs(got["plain_loss"])
        worst = max(got["grad_vs_plain"], key=got["grad_vs_plain"].get)
        assert got["grad_vs_plain"][worst] <= 1e-4, worst
        assert got["same_on_every_rank"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"world{m[0]}-tp{m[1]}-dp{m[2]}")
def test_sharded_parameters_and_export(meshes, mesh):
    res, _ = meshes
    tp = mesh[1]
    for got in res[mesh]:
        assert got["export_differs"] == []
        assert got["cut"]["final.kernel"] == (96, CLASSES // tp)  # (Cin, Cout) of the k = 1 head
        assert got["cut"]["conv0p1s1.kernel"] == (125, 3, 32 // tp)
        assert got["cut"]["bn0.bn.weight"] == (32,)  # norms stay whole
        assert got["conv6"] == (((27, 3, 3), True) if tp == 2 else ((27, 3, 6), False))
