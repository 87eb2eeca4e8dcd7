"""Port parity for the training slice: MinkUNet34 gradients and SGD steps
equal JAX's.

The narrow MinkUNet34 of ``tests/test_torch_minkunet.py`` (full depth,
narrow widths) in train mode, on a collated batch of two ~1.4k-voxel room
scans, with weights exported from the JAX model.  The loss is the mean
cross-entropy against labels drawn with numpy; JAX differentiates it with
``nnx.value_and_grad`` (its conv VJP), the port with ``loss.backward()``
through the ``sparse_conv`` autograd Function (plain versions of K1 and K2
on the CPU).

Tolerance: per tensor, max|Δ| / max|ref| <= 1e-4 for the loss, every
parameter gradient and, after two SGD steps, every weight and BN running
statistic: f32 sums over up to ~2.8k rows, taken in another order in each
of 55 conv layers and 33 batch norms, each ~1e-6 relative.
"""

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.models import MinkUNet34 as JMinkUNet34
from minkowskiengine_tpu.utils.collation import sparse_collate as j_sparse_collate
from minkowskiengine_tpu.utils.torch_import import export_reference_state_dict
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.models import MinkUNet34
from minkowskiengine_tpu_torch.utils.collation import sparse_collate
from minkowskiengine_tpu_torch.utils.datasets import room_scan_voxels
from minkowskiengine_tpu_torch.utils.torch_import import load_state_dict_from_reference

REL = 1e-4
LR = 0.1
NARROW = dict(PLANES=(8, 16, 16, 16, 16, 16, 8, 8), INIT_DIM=8)


class JNarrow(JMinkUNet34):
    PLANES, INIT_DIM = NARROW["PLANES"], NARROW["INIT_DIM"]


class TNarrow(MinkUNet34):
    PLANES, INIT_DIM = NARROW["PLANES"], NARROW["INIT_DIM"]


def _scan(seed):
    """(spatial coordinates (N, 3), features (N, 3)) of one scan."""
    coords, feats = room_scan_voxels(
        voxel_size=0.2, n_points=120_000, extent=(2.0, 2.0, 2.2), n_objects=4, seed=seed
    )
    return coords[:, 1:], feats


def _batch(seeds):
    scans = [_scan(s) for s in seeds]
    coords, feats = sparse_collate([c for c, _ in scans], [f for _, f in scans])
    labels = np.random.RandomState(seeds[0]).randint(0, 5, len(coords))
    return coords.numpy(), feats.numpy(), labels


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def nets():
    jnet = JNarrow(3, 5, D=3, rngs=nnx.Rngs(1))
    tnet = TNarrow(3, 5, D=3, device="cpu")
    load_state_dict_from_reference(tnet, export_reference_state_dict(jnet))
    return jnet, tnet


def _jax_step(jnet, opt, batch):
    coords, feats, labels = batch

    def loss_fn(m):
        logits = m(ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords))).F
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)
        ).mean()

    loss, grads = nnx.value_and_grad(loss_fn)(jnet)
    named = nnx.clone(jnet)
    nnx.update(named, grads)
    opt.update(jnet, grads)
    return float(loss), export_reference_state_dict(named)


def _torch_step(tnet, opt, batch):
    coords, feats, labels = batch
    out = tnet(MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords)))
    loss = torch.nn.functional.cross_entropy(out.F, torch.from_numpy(labels).long())
    opt.zero_grad()
    loss.backward()
    grads = {k: p.grad.clone() for k, p in tnet.named_parameters()}
    opt.step()
    return loss.item(), grads


def test_two_sgd_steps_match_jax(nets):
    jnet, tnet = nets
    for m in (jnet, tnet):
        m.train()
    jopt = nnx.Optimizer(jnet, optax.sgd(LR), wrt=nnx.Param)
    topt = torch.optim.SGD(tnet.parameters(), lr=LR)
    for step, seeds in enumerate([(0, 1), (2, 3)]):
        batch = _batch(seeds)
        jloss, jgrads = _jax_step(jnet, jopt, batch)
        tloss, tgrads = _torch_step(tnet, topt, batch)
        assert abs(tloss - jloss) <= REL * abs(jloss), (step, tloss, jloss)
        stats = ("running_mean", "running_var", "num_batches_tracked")
        assert set(tgrads) == {k for k in jgrads if not k.endswith(stats)}
        for name, g in tgrads.items():
            want = jgrads[name]
            assert g.shape == torch.Size(np.shape(want)) or g.numel() == np.size(want), name
            assert np.abs(want).max() > 0, name  # every parameter is reached
            assert _rel(g.numpy().reshape(np.shape(want)), want) <= REL, (step, name)
    jsd = export_reference_state_dict(jnet)
    for name, v in tnet.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        assert _rel(v.numpy().reshape(np.shape(jsd[name])), jsd[name]) <= REL, name


def test_step_does_not_keep_the_graph_alive(nets):
    """The manager's caches hold no feature tensor: once the step's outputs
    are dropped, their graph is freed while the manager lives on."""
    _, tnet = nets
    tnet.train()
    coords, feats, labels = _batch((4,))
    x = MT.SparseTensor(torch.from_numpy(feats).requires_grad_(), torch.from_numpy(coords))
    out = tnet(x)
    loss = torch.nn.functional.cross_entropy(out.F, torch.from_numpy(labels).long())
    loss.backward()
    assert x.F.grad_fn is not None  # gathered from the leaf, which has its gradient
    assert x.unique_index is not None
    ref = weakref.ref(out.F)
    manager = out.coordinate_manager
    del out, loss
    gc.collect()
    assert ref() is None
    cached = list(manager._kernel_maps.values())
    assert cached and all(not t.requires_grad for km in cached for t in (km.in_idx, km.out_idx_t))
    tnet.zero_grad()


def test_batchnorm_on_one_row():
    """Train-mode batch norm on a single row: the port raises as
    torch.nn.BatchNorm1d (and the reference MinkowskiEngine) does; the JAX
    package returns the bias (zero batch variance)."""
    coords = np.array([[0, 0, 0, 0]], np.int32)
    feats = np.array([[1.0, -2.0]], np.float32)
    tbn = MT.MinkowskiBatchNorm(2, device="cpu").train()
    with pytest.raises(ValueError):
        tbn(MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords)))
    jbn = ME.MinkowskiBatchNorm(2)
    jbn.train()
    out = jbn(ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords)))
    np.testing.assert_array_equal(np.asarray(out.F), np.zeros((1, 2), np.float32))


def test_collate_matches_jax():
    scans = [_scan(s) for s in (0, 1)]
    labels = [np.arange(len(c)) % 5 for c, _ in scans]
    want = j_sparse_collate([c for c, _ in scans], [f for _, f in scans], labels)
    got = sparse_collate([torch.from_numpy(c) for c, _ in scans], [f for _, f in scans], labels)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[0].dtype == torch.int32 and set(got[0][:, 0].tolist()) == {0, 1}
