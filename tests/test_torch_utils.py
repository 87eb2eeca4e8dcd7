"""Port parity for the utils the slice adds: ``kaiming_*_``,
``gradcheck``, checkpoints, ``summary``, the profiling helpers, the
diagnostics, ``MinkowskiInstanceNormFunction`` and the weight functions
under the JAX package's names (``export_reference_state_dict``,
``load_reference_state_dict``, ``reference_named_params``).

Fans and gains equal JAX's exactly; samples are held to their standard
deviation or bound within 3% (about ten times their sampling error at
these sizes); a narrow UNet's logits after a checkpoint round trip equal
JAX's within 1e-4 of max|ref| (the UNet parity tests' bound: ~20 layers of
float32 sums in another order); the instance-norm shim agrees with JAX's
within rtol 1e-5 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.models import MinkUNet14 as JMinkUNet14
from minkowskiengine_tpu.nn.norm import MinkowskiBatchNorm as JBatchNorm
from minkowskiengine_tpu.utils.gradcheck import gradcheck as jgradcheck
from minkowskiengine_tpu.utils import init as jinit
from minkowskiengine_tpu.utils.summary import summary as jsummary
from minkowskiengine_tpu.utils.torch_import import export_reference_state_dict as jexport
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.models import MinkUNet14
from minkowskiengine_tpu_torch.ops import functional as TF
from minkowskiengine_tpu_torch.utils import init as tinit

NARROW = dict(PLANES=(8, 8, 8, 8, 8, 8, 8, 8), INIT_DIM=8)


class JNarrow(JMinkUNet14):
    PLANES, INIT_DIM = NARROW["PLANES"], NARROW["INIT_DIM"]


class TNarrow(MinkUNet14):
    PLANES, INIT_DIM = NARROW["PLANES"], NARROW["INIT_DIM"]


def _cloud(seed=0, n=300, ch=3):
    rng = np.random.RandomState(seed)
    coords = np.unique(np.concatenate(
        [rng.randint(0, 2, (n, 1)), rng.randint(-6, 6, (n, 3))], 1).astype(np.int32), axis=0)
    return coords, rng.randn(len(coords), ch).astype(np.float32)


@pytest.mark.parametrize("shape", [(8, 16), (27, 4, 8), (125, 3, 32)])
@pytest.mark.parametrize("mode", ["fan_in", "fan_out"])
@pytest.mark.parametrize("nonlinearity,a", [("relu", 0.0), ("leaky_relu", 0.1), ("tanh", 0.0),
                                            ("linear", 0.0)])
def test_kaiming_fans_and_gains_match_jax(shape, mode, nonlinearity, a):
    assert tinit._calculate_correct_fan(shape, mode) == jinit._calculate_correct_fan(shape, mode)
    assert tinit._gain(nonlinearity, a) == jinit._gain(nonlinearity, a)


def test_kaiming_samples_match_jax():
    shape = (27, 64, 64)
    t = MT.utils.kaiming_normal_(torch.empty(shape), nonlinearity="relu",
                                 generator=torch.Generator().manual_seed(0))
    j = np.asarray(jinit.kaiming_normal_(jax.random.PRNGKey(0), shape, nonlinearity="relu"))
    want_std = np.sqrt(2.0) / np.sqrt(27 * 64)
    assert abs(t.std().item() / want_std - 1) < 0.03 and abs(j.std() / want_std - 1) < 0.03
    u = MT.utils.kaiming_uniform_(torch.empty(shape), mode="fan_out",
                                  generator=torch.Generator().manual_seed(0))
    ju = np.asarray(jinit.kaiming_uniform_(jax.random.PRNGKey(0), shape, mode="fan_out"))
    bound = np.sqrt(2.0) * np.sqrt(3.0 / (27 * 64))
    assert u.abs().max().item() <= bound and np.abs(ju).max() <= bound
    assert abs(u.abs().max().item() / bound - 1) < 0.03
    again = MT.utils.kaiming_uniform_(torch.empty(shape), mode="fan_out",
                                      generator=torch.Generator().manual_seed(0))
    assert torch.equal(u, again)
    with pytest.raises(ValueError):
        MT.utils.kaiming_normal_(torch.empty(2, 3, 4, 5))


class _WrongBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * x

    @staticmethod
    def backward(ctx, g):
        return g


def test_gradcheck():
    coords, feats = _cloud(1)
    mgr = MT.CoordinateManager(D=3, device="cpu")
    key, _ = mgr.insert_and_map(torch.from_numpy(coords))
    kmap = mgr.kernel_map(key, key, kernel_size=3)
    w = np.random.RandomState(0).randn(27, 3, 2).astype(np.float32) * 0.3

    def port(f, k):
        return TF.sparse_conv(f, k, kmap.in_idx, kmap.out_idx_t)

    assert MT.utils.gradcheck(port, (torch.from_numpy(feats), torch.from_numpy(w)))
    # JAX's gradcheck on the same function passes too
    jm = ME.CoordinateManager(D=3)
    jk, _ = jm.insert_and_map(coords)
    jmap = jm.kernel_map(jk, jk, kernel_size=3)
    fpad = np.zeros((jm.capacity(jk), 3), np.float32)
    fpad[: len(feats)] = feats
    from minkowskiengine_tpu.ops import functional as JF
    assert jgradcheck(lambda f, k: JF.sparse_conv(f, k, jmap.in_idx, jmap.out_idx_t),
                                (jnp.asarray(fpad), jnp.asarray(w)), atol=2e-2, rtol=2e-2)
    with pytest.raises(RuntimeError):  # torch's GradcheckError
        MT.utils.gradcheck(_WrongBackward.apply, torch.randn(4))


def _jax_narrow_and_port():
    jnet = JNarrow(3, 5, D=3, rngs=nnx.Rngs(0))
    tnet = TNarrow(3, 5, D=3, device="cpu")
    report = MT.utils.load_reference_state_dict(tnet, jexport(jnet))
    assert not report["missing"] and not report["skipped"]
    return jnet, tnet


def test_reference_names_round_trip_with_jax():
    jnet, tnet = _jax_narrow_and_port()
    want = jexport(jnet)
    got = MT.utils.export_reference_state_dict(tnet)
    assert set(got) == set(want) == set(MT.utils.reference_named_params(tnet))
    for k, v in want.items():
        assert got[k].shape == np.asarray(v).shape, k
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    assert got["final.bias"].shape == (5,)  # the reference's (C,) conv bias
    partial = {"final.kernel": got["final.kernel"], "not.a.key": np.zeros(3)}
    with pytest.raises(KeyError):
        MT.utils.load_reference_state_dict(tnet, partial)
    report = MT.utils.load_reference_state_dict(tnet, partial, strict=False)
    assert report["loaded"] == ["final.kernel"] and report["skipped"] == ["not.a.key"]
    assert "final.bias" in report["missing"]
    with pytest.raises(ValueError):
        MT.utils.load_reference_state_dict(tnet, {"final.kernel": np.zeros((1, 1))}, strict=False)


def test_reference_names_cover_the_new_parameters():
    net = torch.nn.ModuleDict(dict(
        cw=MT.MinkowskiChannelwiseConvolution(4, kernel_size=3, bias=True, dimension=3, device="cpu"),
        prelu=MT.MinkowskiPReLU(4, device="cpu"),
        sin=MT.MinkowskiSinusoidal(4, 3, device="cpu"),
        asm=MT.MinkowskiAdaptiveLogSoftmaxWithLoss(8, 12, cutoffs=[4], device="cpu"),
    ))
    sd = MT.utils.export_reference_state_dict(net)
    assert {k: v.shape for k, v in sd.items()} == {
        "cw.kernel": (27, 4), "cw.bias": (1, 4), "prelu.weight": (4,), "sin.kernel": (4, 3),
        "asm.head.weight": (5, 8), "asm.tail.0.0.weight": (2, 8), "asm.tail.0.1.weight": (8, 2),
    }
    other = torch.nn.ModuleDict(dict(
        cw=MT.MinkowskiChannelwiseConvolution(4, kernel_size=3, bias=True, dimension=3, device="cpu"),
        prelu=MT.MinkowskiPReLU(4, init=0.1, device="cpu"),
        sin=MT.MinkowskiSinusoidal(4, 3, device="cpu"),
        asm=MT.MinkowskiAdaptiveLogSoftmaxWithLoss(8, 12, cutoffs=[4], device="cpu"),
    ))
    MT.utils.load_reference_state_dict(other, sd)
    for k, v in MT.utils.export_reference_state_dict(other).items():
        np.testing.assert_array_equal(v, sd[k])


def test_checkpoint_round_trip_keeps_jaxs_logits(tmp_path):
    jnet, tnet = _jax_narrow_and_port()
    for _, m in nnx.iter_graph(jnet):
        if isinstance(m, JBatchNorm):
            m.train(False)
    coords, feats = _cloud(2)
    want = np.asarray(jnet(ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords))).F)
    path = MT.utils.save_checkpoint(str(tmp_path / "net.pt"), tnet, extra={"epoch": 3, "lr": 0.01})
    fresh = TNarrow(3, 5, D=3, generator=torch.Generator().manual_seed(9), device="cpu").eval()
    assert MT.utils.load_checkpoint(path, fresh) == {"epoch": 3, "lr": 0.01}
    with torch.no_grad():
        got = fresh(MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords), device="cpu")).F
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    for k, v in tnet.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def _total_trainable(text):
    line = next(ln for ln in text.splitlines() if ln.startswith("total trainable params"))
    return int(line.split()[-1].replace(",", ""))


def test_summary_counts_match_jax(capsys):
    jconv = ME.MinkowskiConvolution(3, 8, kernel_size=3, dimension=2)
    tconv = MT.MinkowskiConvolution(3, 8, kernel_size=3, dimension=2, device="cpu")
    assert _total_trainable(MT.utils.summary(tconv)) == _total_trainable(jsummary(jconv)) == 216
    jnet, tnet = _jax_narrow_and_port()
    assert _total_trainable(MT.utils.summary(tnet)) == _total_trainable(jsummary(jnet))
    with torch.no_grad():
        tnet.final.kernel.zero_()
    coords, feats = _cloud(3)
    text = MT.utils.summary(tnet, MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords),
                                                  device="cpu"))
    final = next(ln for ln in text.splitlines() if ln.startswith("final.kernel "))
    assert final.split()[-1] == "100.0%"
    assert "((1, 1, 1), '')" in text and f"output: {len(coords):,} rows x 5 ch" in text


def test_profiling_helpers(tmp_path):
    x = torch.randn(64, 64)
    with MT.utils.trace(str(tmp_path)) as prof:
        with MT.utils.named_scope("me-scope"):
            (x @ x).sum()
    assert any(e.key == "me-scope" for e in prof.key_averages())
    assert list(tmp_path.glob("*.json"))
    with MT.utils.timer() as out:
        (x @ x).sum()
    assert out["seconds"] > 0
    t = MT.utils.Timer()
    for _ in range(3):
        t.tic()
        (x @ x).sum()
        t.toc()
    assert t.count == 3 and t.average > 0 and abs(t.total - 3 * t.average) < 1e-12


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the answers without a card; "
                    "tests/test_torch_diagnostics_cuda.py checks them on one")
def test_diagnostics_without_a_card(capsys):
    from minkowskiengine_tpu_torch.diagnostics import _version_int

    assert MT.is_cuda_available() is False
    assert MT.cuda_version() == (-1 if torch.version.cuda is None else _version_int(torch.version.cuda))
    assert MT.cudart_version() == -1
    assert ME.is_cuda_available() is False  # the JAX package says so too
    with pytest.raises(RuntimeError):
        MT.get_gpu_memory_info()
    MT.print_diagnostics()
    text = capsys.readouterr().out
    assert "is_cuda_available: False" in text and "native host engine: loaded" in text


def test_version_encoding():
    from minkowskiengine_tpu_torch.diagnostics import _version_int

    assert _version_int("12.8") == 12080 and _version_int("11.1") == 11010


def test_instance_norm_function_matches_jax():
    coords, feats = _cloud(4, ch=6)
    g = np.random.RandomState(5).randn(*feats.shape).astype(np.float32)
    jx = ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords))
    jglob = ME.CoordinateMapKey(3)

    def f(fe):
        return ME.MinkowskiInstanceNormFunction.apply(fe, jx.coordinate_map_key, jglob,
                                                      jx.coordinate_manager)

    want, vjp = jax.vjp(f, jx.padded_features)
    (want_dx,) = vjp(jnp.zeros_like(want).at[: len(coords)].set(jnp.asarray(g)))
    tf = torch.from_numpy(feats).requires_grad_()
    tx = MT.SparseTensor(tf, torch.from_numpy(coords), device="cpu")
    tglob = MT.CoordinateMapKey(3)
    out = MT.MinkowskiInstanceNormFunction.apply(tf, tx.coordinate_map_key, tglob, tx.coordinate_manager)
    out.backward(torch.from_numpy(g))
    assert tglob.get_key() == jglob.get_key()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want)[: len(coords)], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_dx)[: len(coords)], rtol=1e-5, atol=1e-5)
