"""Port parity for the classification slice: MinkowskiFCNN, MinkowskiPointNet
and the ResNet classifiers equal JAX's on the CPU.

Narrow models on a batch of four synthetic shapes (``modelnet_batch``, 256
points each at 5 cm voxels), weights exported from the JAX model and loaded
through the port's loader.  Batch norms carry random running statistics, so
eval mode is a real test.

Tolerance: per tensor, max|Δ| / max|ref| <= 1e-4 for logits, the loss and
every parameter gradient: f32 sums taken in another order through ~10
layers of convs, linears, batch and instance norms, each ~1e-6 relative,
amplified by the normalizations.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.models import ResNetBase as JResNetBase
from minkowskiengine_tpu.models.classification import MinkowskiFCNN as JFCNN
from minkowskiengine_tpu.models.classification import MinkowskiPointNet as JPointNet
from minkowskiengine_tpu.modules.resnet_block import BasicBlock as JBasic
from minkowskiengine_tpu.modules.resnet_block import Bottleneck as JBottleneck
from minkowskiengine_tpu.nn.nonlinearity import MinkowskiDropout as JDropout
from minkowskiengine_tpu.nn.norm import MinkowskiBatchNorm as JBatchNorm
from minkowskiengine_tpu.utils.torch_import import export_reference_state_dict
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.models import MinkowskiFCNN, MinkowskiPointNet, ResNetBase
from minkowskiengine_tpu_torch.modules.resnet_block import BasicBlock, Bottleneck
from minkowskiengine_tpu_torch.utils.datasets import (
    SHAPE_CLASSES,
    CoordinateTransformation,
    modelnet_batch,
)
from minkowskiengine_tpu_torch.utils.torch_import import load_state_dict_from_reference

REL = 1e-4
NARROW_FCNN = dict(embedding_channel=32, channels=(8, 8, 8, 8, 8), D=3)
NCLS = 8  # the synthetic shape classes


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def batch():
    return modelnet_batch(4, n_points=256, seed=0, voxel_size=0.05)


def _with_random_stats(sd, seed=0):
    rng = np.random.RandomState(seed)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = rng.randn(*sd[k].shape).astype(np.float32) * 0.1
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, sd[k].shape).astype(np.float32)
    return sd


def _pair(jnet, tnet):
    """Load the JAX net's weights, with random BN statistics, into both."""
    sd = _with_random_stats(export_reference_state_dict(jnet))
    ME.utils.torch_import.load_reference_state_dict(jnet, sd)
    load_state_dict_from_reference(tnet, sd)
    return sd


def _jax_modes(net, bn_training, dropout_training):
    for _, m in nnx.iter_graph(net):
        if isinstance(m, JBatchNorm):
            m.train(bn_training)
        elif isinstance(m, JDropout):
            m.train(dropout_training)


def _jax_field(batch):
    coords, feats, _ = batch
    return ME.TensorField(jnp.asarray(feats), jnp.asarray(coords))


def _torch_field(batch):
    coords, feats, _ = batch
    return MT.TensorField(torch.from_numpy(feats), torch.from_numpy(coords))


@pytest.fixture(scope="module")
def fcnn():
    jnet = JFCNN(3, NCLS, rngs=nnx.Rngs(0), **NARROW_FCNN)
    tnet = MinkowskiFCNN(3, NCLS, device="cpu", **NARROW_FCNN)
    sd = _pair(jnet, tnet)
    return jnet, tnet, sd


def test_fcnn_state_dict_names_are_the_reference_names(fcnn):
    _, tnet, sd = fcnn
    assert set(tnet.state_dict()) == set(sd)
    for name in ("mlp1.0.linear.weight", "conv5.0.0.kernel", "final.0.0.linear.weight",
                 "final.3.linear.bias", "conv5.2.1.bn.running_var"):
        assert name in sd, name
    assert tnet.final[3].linear.weight.shape == (NCLS, 512)  # (out, in)


def test_fcnn_logits_match_jax(fcnn, batch):
    jnet, tnet, _ = fcnn
    _jax_modes(jnet, False, False)
    tnet.eval()
    want = np.asarray(jnet(_jax_field(batch)))
    with torch.no_grad():
        got = tnet(_torch_field(batch))
    assert got.shape == want.shape == (4, NCLS)
    assert torch.isfinite(got).all()
    assert _rel(got.numpy(), want) <= REL


def test_fcnn_gradients_match_jax(fcnn, batch):
    """Train-mode batch norm, dropout off (the identity) in both packages."""
    jnet, tnet, _ = fcnn
    labels = batch[2]
    _jax_modes(jnet, True, False)
    tnet.train()
    tnet.final[1].eval()

    def loss_fn(m):
        logits = m(_jax_field(batch))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)
        ).mean()

    jloss, jgrads = nnx.value_and_grad(loss_fn)(jnet)
    named = nnx.clone(jnet)
    nnx.update(named, jgrads)
    want = export_reference_state_dict(named)

    tnet.zero_grad()
    loss = torch.nn.functional.cross_entropy(
        tnet(_torch_field(batch)), torch.from_numpy(labels).long()
    )
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= REL * abs(float(jloss))
    grads = {k: p.grad for k, p in tnet.named_parameters()}
    assert len(grads) == len([k for k in want if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))])
    for name, g in grads.items():
        assert np.abs(want[name]).max() > 0, name  # every parameter is reached
        assert _rel(g.numpy().reshape(np.shape(want[name])), want[name]) <= REL, name


def test_pointnet_logits_match_jax(batch):
    jnet = JPointNet(3, NCLS, embedding_channel=32, rngs=nnx.Rngs(1))
    tnet = MinkowskiPointNet(3, NCLS, embedding_channel=32, device="cpu")
    _pair(jnet, tnet)
    _jax_modes(jnet, False, False)
    tnet.eval()
    want = np.asarray(jnet(_jax_field(batch)))
    with torch.no_grad():
        got = tnet(_torch_field(batch))
    assert got.shape == want.shape == (4, NCLS)
    assert _rel(got.numpy(), want) <= REL


def _narrow_resnet(base, block):
    return type("Narrow", (base,), dict(
        BLOCK=block, LAYERS=(1, 1, 1, 1), INIT_DIM=8, PLANES=(8, 8, 16, 16)
    ))


@pytest.mark.parametrize("blocks", [(JBasic, BasicBlock), (JBottleneck, Bottleneck)],
                         ids=["basic", "bottleneck"])
def test_resnet_logits_match_jax(batch, blocks):
    """conv1 (k3 s2) → instance norm → max pool (k2 s2, the stride-map fast
    path) → four stride-2 layers with k1 s2 downsamples → the stride-3 conv5
    (tensor stride 64 → 192, floor division of negative coordinates) →
    global max pool → linear."""
    jnet = _narrow_resnet(JResNetBase, blocks[0])(3, NCLS, D=3, rngs=nnx.Rngs(2))
    tnet = _narrow_resnet(ResNetBase, blocks[1])(3, NCLS, D=3, device="cpu")
    _pair(jnet, tnet)
    _jax_modes(jnet, False, False)
    tnet.eval()
    want = jnet(_jax_field(batch).sparse())
    with torch.no_grad():
        got = tnet(_torch_field(batch).sparse())
    assert got.tensor_stride == tuple(want.tensor_stride) == (1, 1, 1)  # the origin map
    np.testing.assert_array_equal(got.C.numpy(), np.asarray(want.C))
    assert got.F.shape == (4, NCLS)
    assert _rel(got.F.numpy(), np.asarray(want.F)) <= REL


def _examples_common():
    path = Path(__file__).resolve().parents[1] / "examples" / "common.py"
    spec = importlib.util.spec_from_file_location("examples_common", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augmented"])
def test_modelnet_batch_is_the_examples_batch(augment):
    """The port's copy of the synthetic ModelNet batch draws the same numbers:
    a seed gives the same points, features and labels, bit for bit, in both
    packages, with and without the train-time augmentation."""
    ex = _examples_common()
    assert SHAPE_CLASSES == ex.SHAPE_CLASSES
    for seed in (0, 5):
        want = ex.modelnet_batch(
            9, n_points=300, seed=seed, voxel_size=0.025,
            transform=ex.CoordinateTransformation() if augment else None,
        )
        got = modelnet_batch(
            9, n_points=300, seed=seed, voxel_size=0.025,
            transform=CoordinateTransformation() if augment else None,
        )
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_no_device_means_the_card():
    """With no ``device``, models, managers and host-data tensors go to the
    CUDA card; without one they raise instead of falling back to the CPU."""
    coords, feats, _ = modelnet_batch(1, n_points=8, seed=0)
    builders = [
        lambda: MinkowskiFCNN(3, NCLS, **NARROW_FCNN),
        lambda: MT.models.ResNet14(3, NCLS, D=3),
        lambda: MT.CoordinateManager(D=3),
        lambda: MT.MinkowskiLinear(3, 4),
        lambda: MT.TensorField(feats, coords),
        lambda: MT.SparseTensor(feats, np.floor(coords).astype(np.int32)),
    ]
    if torch.cuda.is_available():
        for build in builders[:3]:
            obj = build()
            dev = obj.device if isinstance(obj, MT.CoordinateManager) else next(obj.parameters()).device
            assert dev.type == "cuda"
        return
    for build in builders:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    # a tensor keeps its device; device="cpu" asks for the CPU
    assert MT.TensorField(torch.from_numpy(feats), coords).device.type == "cpu"
    assert MT.CoordinateManager(D=3, device="cpu").device.type == "cpu"
