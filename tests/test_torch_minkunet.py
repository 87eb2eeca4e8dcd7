"""Port parity for the slice as a whole: MinkUNet34 logits equal JAX's.

The model keeps MinkUNet34's depth (LAYERS 2,3,4,6,2,2,2,2) at narrow
widths, on a ~1.4k-voxel room scan, with weights exported from the JAX
model and loaded through the port's loader.  Tolerance rtol 1e-4 /
atol 1e-5: 55 f32 conv layers and 33 batch norms, each summing in another
order than XLA.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.models import MinkUNet34 as JMinkUNet34
from minkowskiengine_tpu.nn.norm import MinkowskiBatchNorm as JBatchNorm
from minkowskiengine_tpu.utils.collation import sparse_collate as j_sparse_collate
from minkowskiengine_tpu.utils.torch_import import export_reference_state_dict
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.models import MinkUNet34
from minkowskiengine_tpu_torch.utils.collation import sparse_collate
from minkowskiengine_tpu_torch.utils.datasets import room_scan_voxels
from minkowskiengine_tpu_torch.utils.torch_import import load_state_dict_from_reference

RTOL, ATOL = 1e-4, 1e-5
NARROW = dict(PLANES=(8, 16, 16, 16, 16, 16, 8, 8), INIT_DIM=8)


class JNarrow(JMinkUNet34):
    PLANES, INIT_DIM = NARROW["PLANES"], NARROW["INIT_DIM"]


class TNarrow(MinkUNet34):
    PLANES, INIT_DIM = NARROW["PLANES"], NARROW["INIT_DIM"]


@pytest.fixture(scope="module")
def setup():
    coords, feats = room_scan_voxels(
        voxel_size=0.2, n_points=120_000, extent=(2.0, 2.0, 2.2), n_objects=4, seed=0
    )
    jnet = JNarrow(3, 5, D=3, rngs=nnx.Rngs(0))
    sd = export_reference_state_dict(jnet)
    rng = np.random.RandomState(0)
    for k in sd:  # random running statistics, so eval mode is a real test
        if k.endswith("running_mean"):
            sd[k] = rng.randn(*sd[k].shape).astype(np.float32) * 0.1
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, sd[k].shape).astype(np.float32)
    ME.utils.torch_import.load_reference_state_dict(jnet, sd)
    tnet = TNarrow(3, 5, D=3, device="cpu")
    load_state_dict_from_reference(tnet, sd)
    return coords, feats, jnet, tnet, sd


def _jax_bn_mode(net, training):
    for _, m in nnx.iter_graph(net):
        if isinstance(m, JBatchNorm):
            m.train(training)


def _run_both(setup, training):
    coords, feats, jnet, tnet, _ = setup
    _jax_bn_mode(jnet, training)
    tnet.train(training)
    want = np.asarray(jnet(ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords))).F)
    with torch.no_grad():
        out = tnet(MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords)))
    return out, want


@pytest.mark.parametrize("training", [False, True])
def test_logits_match_jax(setup, training):
    out, want = _run_both(setup, training)
    assert out.F.shape == want.shape == (len(setup[0]), 5)
    assert out.tensor_stride == (1, 1, 1)
    assert torch.isfinite(out.F).all()
    np.testing.assert_allclose(out.F.numpy(), want, rtol=RTOL, atol=ATOL)
    if training:  # the running-statistics update matches too
        jsd = export_reference_state_dict(setup[2])
        tsd = setup[3].state_dict()
        for k in ("bn0.bn.running_mean", "block4.1.norm2.bn.running_var"):
            np.testing.assert_allclose(tsd[k].numpy(), jsd[k], rtol=RTOL, atol=ATOL)


def test_batch_of_two_scans_matches_jax(setup):
    """Two scans collated by each package's ``sparse_collate``: batch field 0
    and 1 in the keys, logits in the same rows."""
    _, _, jnet, tnet, _ = setup
    _jax_bn_mode(jnet, False)
    tnet.eval()
    scans = [
        room_scan_voxels(voxel_size=0.2, n_points=120_000, extent=(2.0, 2.0, 2.2),
                         n_objects=4, seed=s)
        for s in (3, 4)
    ]
    jc, jf = j_sparse_collate([c[:, 1:] for c, _ in scans], [f for _, f in scans])
    tc, tf = sparse_collate([torch.from_numpy(c[:, 1:]) for c, _ in scans], [f for _, f in scans])
    want = jnet(ME.SparseTensor(jnp.asarray(jf), jnp.asarray(jc)))
    with torch.no_grad():
        out = tnet(MT.SparseTensor(tf, tc))
    np.testing.assert_array_equal(out.C.numpy(), np.asarray(want.C))
    assert set(out.C[:, 0].tolist()) == {0, 1}
    np.testing.assert_allclose(out.F.numpy(), np.asarray(want.F), rtol=RTOL, atol=ATOL)


def test_state_dict_names_are_the_reference_names(setup):
    _, _, _, tnet, sd = setup
    assert set(tnet.state_dict()) == set(sd)
    assert tnet.final.bias.shape == (1, 5)  # the reference stores (5,)
    assert tnet.block2[0].downsample[0].use_mm


@pytest.mark.parametrize("fault", ["missing", "unknown", "shape"])
def test_strict_load_rejects(setup, fault):
    sd = dict(setup[4])
    if fault == "missing":
        del sd["block3.2.conv1.kernel"]
        err = KeyError
    elif fault == "unknown":
        sd["block9.0.conv1.kernel"] = sd["block3.2.conv1.kernel"]
        err = KeyError
    else:
        sd["bn0.bn.weight"] = np.ones(7, np.float32)
        err = ValueError
    with pytest.raises(err):
        load_state_dict_from_reference(TNarrow(3, 5, D=3, device="cpu"), sd)


def test_port_does_not_import_jax():
    code = (
        "import sys, minkowskiengine_tpu_torch, minkowskiengine_tpu_torch.models, "
        "minkowskiengine_tpu_torch.utils.torch_import, minkowskiengine_tpu_torch.nn.interpolation, "
        "minkowskiengine_tpu_torch.nn.broadcast, minkowskiengine_tpu_torch.modules.senet_block; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'minkowskiengine_tpu')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_generator_seeds_the_weights():
    a = TNarrow(3, 5, D=3, generator=torch.Generator().manual_seed(3), device="cpu")
    b = TNarrow(3, 5, D=3, generator=torch.Generator().manual_seed(3), device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
