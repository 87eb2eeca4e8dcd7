"""The port's bf16 compute policy against the JAX package's, module by module.

``set_compute_dtype(bf16)`` in both packages, then the same numpy inputs
(rounded to bf16 where a module takes bf16 features) and the same weights
go through each JAX module and its port.  Each output must have JAX's
dtype, and its values must agree within the module's stated tolerance,
max |Δ| / max |ref|:

* 0 (bit-equal) where both only move or compare values (ReLU, max
  pooling, cat);
* 2^-7 (one bf16 ulp at the largest value) where both compute in float32
  and round once, in another order (batch norm, Linear, the TensorField's
  average), or round a product once from operands rounded otherwise
  (LeakyReLU's slope);
* 2^-5 for the convolutions and the kernel-map pooling sums: JAX's CPU
  path keeps a bf16 running sum and rounds after each of up to 27 offsets
  (ops/functional.py:105-116), the port sums in float32 and rounds once,
  as the TPU kernel does; test_torch_sparse_conv_bf16.py holds the
  convolution to one ulp of JAX's float32 function instead;
* 2^-5 for the global sums and means: bf16 running sums over ~250 rows
  per batch item, rounded at every add in both packages, in another order.

Both packages' compute dtype is process-global: every test that sets it
goes through the ``bf16`` fixture, which resets both to None.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.utils.torch_import import export_reference_state_dict
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.utils.torch_import import load_state_dict_from_reference

ULP = 2.0**-7
SUMS = 2.0**-5

JDT = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}


@pytest.fixture
def bf16():
    ME.set_compute_dtype(jnp.bfloat16)
    MT.set_compute_dtype(torch.bfloat16)
    yield
    ME.set_compute_dtype(None)
    MT.set_compute_dtype(None)


@pytest.fixture(scope="module")
def data():
    """Two batch items of ~250 voxels at tensor stride 2, six channels."""
    rng = np.random.RandomState(0)
    coords = np.unique(np.concatenate(
        [rng.randint(0, 2, (600, 1)), 2 * rng.randint(-4, 4, (600, 3))], 1
    ).astype(np.int32), axis=0)
    feats = (rng.randn(len(coords), 6) * 2.0).astype(np.float32)
    return coords, feats


def _bf16(a):
    """numpy float32 rounded to bf16 and back (round to nearest even, as
    both jnp and torch round)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_config_api():
    assert MT.compute_dtype() is None and MT.config.compute_dtype() is None
    assert MT.set_compute_dtype is MT.config.set_compute_dtype
    try:
        MT.set_compute_dtype(torch.bfloat16)
        assert MT.compute_dtype() is torch.bfloat16
        with pytest.raises(TypeError):
            MT.set_compute_dtype("bfloat16")
        with pytest.raises(TypeError):
            MT.set_compute_dtype(torch.int32)
        assert MT.compute_dtype() is torch.bfloat16  # a refused value changes nothing
    finally:
        MT.set_compute_dtype(None)
    assert MT.compute_dtype() is None


def _convs():
    return {
        "conv k3": (lambda: ME.MinkowskiConvolution(6, 8, kernel_size=3, dimension=3),
                    lambda: MT.MinkowskiConvolution(6, 8, kernel_size=3, dimension=3, device="cpu")),
        "conv k3 s2 bias": (
            lambda: ME.MinkowskiConvolution(6, 8, kernel_size=3, stride=2, bias=True, dimension=3),
            lambda: MT.MinkowskiConvolution(6, 8, kernel_size=3, stride=2, bias=True, dimension=3,
                                            device="cpu")),
        "conv k1 bias": (
            lambda: ME.MinkowskiConvolution(6, 8, kernel_size=1, bias=True, dimension=3),
            lambda: MT.MinkowskiConvolution(6, 8, kernel_size=1, bias=True, dimension=3,
                                            device="cpu")),
        "conv transpose k2 s2": (
            lambda: ME.MinkowskiConvolutionTranspose(6, 8, kernel_size=2, stride=2, dimension=3),
            lambda: MT.MinkowskiConvolutionTranspose(6, 8, kernel_size=2, stride=2, dimension=3,
                                                     device="cpu")),
        "generative transpose k2 s2": (
            lambda: ME.MinkowskiGenerativeConvolutionTranspose(6, 8, kernel_size=2, stride=2,
                                                               dimension=3),
            lambda: MT.MinkowskiGenerativeConvolutionTranspose(6, 8, kernel_size=2, stride=2,
                                                               dimension=3, device="cpu")),
    }


def _run(jmod, tmod, data, jfeats, tfeats):
    coords, _ = data
    jout = jmod(ME.SparseTensor(jfeats, jnp.asarray(coords), tensor_stride=2))
    tout = tmod(MT.SparseTensor(tfeats, torch.from_numpy(coords), tensor_stride=2))
    return jout, tout


@pytest.mark.parametrize("in_dtype", ["float32", "bf16"])
@pytest.mark.parametrize("name", list(_convs()))
def test_convs_cast_to_the_compute_dtype(bf16, data, name, in_dtype):
    """Every module on the conv base casts its input features to bf16 and
    gives bf16, whatever the input's dtype; its kernel stays float32."""
    jmake, tmake = _convs()[name]
    jmod, tmod = jmake(), tmake()
    load_state_dict_from_reference(tmod, export_reference_state_dict(jmod))
    feats = data[1] if in_dtype == "float32" else _bf16(data[1])
    jf = jnp.asarray(feats) if in_dtype == "float32" else jnp.asarray(feats).astype(jnp.bfloat16)
    tf = torch.from_numpy(feats)
    if in_dtype == "bf16":
        tf = tf.bfloat16()
    jout, tout = _run(jmod, tmod, data, jf, tf)
    assert JDT[jout.F.dtype] is tout.F.dtype is torch.bfloat16
    assert tmod.kernel.dtype is torch.float32
    np.testing.assert_array_equal(tout.C.numpy(), np.asarray(jout.C))
    assert _rel(tout.F.float().detach().numpy(), np.asarray(jout.F, np.float32)) <= SUMS


# (JAX module, port module, input channels, tolerance) on bf16 features
def _layers():
    return {
        "batch norm": (lambda: ME.MinkowskiBatchNorm(6),
                       lambda: MT.MinkowskiBatchNorm(6, device="cpu"), ULP),
        "relu": (ME.MinkowskiReLU, MT.MinkowskiReLU, 0.0),
        # torch scales by the float32 slope and rounds once; JAX by the
        # slope rounded to bf16, then rounds: one ulp apart
        "leaky relu": (ME.MinkowskiLeakyReLU, MT.MinkowskiLeakyReLU, ULP),
        "linear": (lambda: ME.MinkowskiLinear(6, 5),
                   lambda: MT.MinkowskiLinear(6, 5, device="cpu"), ULP),
        "max pool k3 s2": (
            lambda: ME.MinkowskiMaxPooling(kernel_size=3, stride=2, dimension=3),
            lambda: MT.MinkowskiMaxPooling(kernel_size=3, stride=2, dimension=3), 0.0),
        "avg pool k3 s2": (
            lambda: ME.MinkowskiAvgPooling(kernel_size=3, stride=2, dimension=3),
            lambda: MT.MinkowskiAvgPooling(kernel_size=3, stride=2, dimension=3), SUMS),
        "sum pool k2 s2": (
            lambda: ME.MinkowskiSumPooling(kernel_size=2, stride=2, dimension=3),
            lambda: MT.MinkowskiSumPooling(kernel_size=2, stride=2, dimension=3), SUMS),
        "global max": (ME.MinkowskiGlobalMaxPooling, MT.MinkowskiGlobalMaxPooling, 0.0),
        "global avg": (ME.MinkowskiGlobalAvgPooling, MT.MinkowskiGlobalAvgPooling, SUMS),
        "global sum": (ME.MinkowskiGlobalSumPooling, MT.MinkowskiGlobalSumPooling, SUMS),
    }


@pytest.mark.parametrize("name", list(_layers()))
def test_layers_keep_jaxs_dtype_on_bf16_features(bf16, data, name):
    jmake, tmake, tol = _layers()[name]
    jmod, tmod = jmake(), tmake()
    if list(tmod.state_dict()):
        load_state_dict_from_reference(tmod, export_reference_state_dict(jmod))
    feats = _bf16(data[1])
    jout, tout = _run(jmod, tmod, data, jnp.asarray(feats).astype(jnp.bfloat16),
                      torch.from_numpy(feats).bfloat16())
    assert JDT[jout.F.dtype] is tout.F.dtype is torch.bfloat16, name
    rel = float(_rel(tout.F.float().detach().numpy(), np.asarray(jout.F, np.float32)))
    assert rel <= tol, (name, rel)


def test_batch_norm_statistics_are_float32(bf16, data):
    """bf16 features are normalized in float32: the running statistics
    stay float32 and equal JAX's, the state-dict names stay ``bn.*``."""
    jbn, tbn = ME.MinkowskiBatchNorm(6), MT.MinkowskiBatchNorm(6, device="cpu")
    feats = _bf16(data[1])
    _run(jbn, tbn, data, jnp.asarray(feats).astype(jnp.bfloat16), torch.from_numpy(feats).bfloat16())
    assert set(tbn.state_dict()) == {"bn.weight", "bn.bias", "bn.running_mean", "bn.running_var",
                                     "bn.num_batches_tracked"}
    assert tbn.bn.running_mean.dtype is tbn.bn.running_var.dtype is torch.float32
    jsd = export_reference_state_dict(jbn)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(tbn.bn, k).numpy(), jsd[f"bn.{k}"], rtol=1e-6, atol=1e-7)
    # the same values in float32 give the same statistics: the cast is exact
    tbn32 = MT.MinkowskiBatchNorm(6, device="cpu")
    coords = torch.from_numpy(data[0])
    out32 = tbn32(MT.SparseTensor(torch.from_numpy(feats), coords, tensor_stride=2))
    torch.testing.assert_close(tbn32.bn.running_var, tbn.bn.running_var, rtol=0, atol=0)
    assert out32.F.dtype is torch.float32


def test_linear_casts_its_weight_to_the_features(bf16, data):
    """bf16 features: the product and the bias in bf16; float32 features
    under the bf16 policy stay float32 (Linear casts nothing itself), as in
    JAX."""
    jlin, tlin = ME.MinkowskiLinear(6, 5), MT.MinkowskiLinear(6, 5, device="cpu")
    load_state_dict_from_reference(tlin, export_reference_state_dict(jlin))
    jout, tout = _run(jlin, tlin, data, jnp.asarray(data[1]), torch.from_numpy(data[1]))
    assert JDT[jout.F.dtype] is tout.F.dtype is torch.float32
    np.testing.assert_allclose(tout.F.detach().numpy(), np.asarray(jout.F), rtol=1e-5, atol=1e-5)
    assert tlin.linear.weight.dtype is torch.float32
    feats = _bf16(data[1])
    tf = torch.from_numpy(feats).bfloat16()
    out = tlin(MT.SparseTensor(tf, torch.from_numpy(data[0]), tensor_stride=2))
    out.F.float().sum().backward()
    assert out.F.dtype is torch.bfloat16 and tlin.linear.weight.grad.dtype is torch.float32


def test_to_feature_cat_and_tensor_field(bf16, data):
    coords, feats = data
    feats = _bf16(feats)
    jx = ME.SparseTensor(jnp.asarray(feats).astype(jnp.bfloat16), jnp.asarray(coords), tensor_stride=2)
    tx = MT.SparseTensor(torch.from_numpy(feats).bfloat16(), torch.from_numpy(coords), tensor_stride=2)
    assert JDT[ME.MinkowskiToFeature()(jx).dtype] is MT.MinkowskiToFeature()(tx).dtype
    jc, tc = ME.cat(jx, jx), MT.cat(tx, tx)
    assert JDT[jc.F.dtype] is tc.F.dtype is torch.bfloat16
    np.testing.assert_array_equal(tc.F.float().numpy(), np.asarray(jc.F, np.float32))
    # a TensorField of bf16 features: sparse() averages in bf16, slice() gathers
    pts = coords[:, 1:].astype(np.float32) / 2 + 0.25
    fcoords = np.concatenate([coords[:, :1].astype(np.float32), pts], 1)
    jt = ME.TensorField(jnp.asarray(feats).astype(jnp.bfloat16), jnp.asarray(fcoords))
    tt = MT.TensorField(torch.from_numpy(feats).bfloat16(), torch.from_numpy(fcoords), device="cpu")
    js, ts = jt.sparse(), tt.sparse()
    assert JDT[js.F.dtype] is ts.F.dtype is torch.bfloat16
    assert _rel(ts.F.float().numpy(), np.asarray(js.F, np.float32)) <= ULP
    assert JDT[js.slice(jt).F.dtype] is ts.slice(tt).F.dtype is torch.bfloat16


def test_channelwise_conv_casts_nothing(bf16, data):
    """As JAX's: float32 features stay float32 under the bf16 policy, and
    bf16 features with its float32 kernel raise TypeError (JAX's scan
    refuses the widened carry)."""
    coords, feats = data
    jcw = ME.MinkowskiChannelwiseConvolution(6, kernel_size=3, dimension=3)
    tcw = MT.MinkowskiChannelwiseConvolution(6, kernel_size=3, dimension=3, device="cpu")
    with torch.no_grad():
        tcw.kernel.copy_(torch.from_numpy(np.asarray(jcw.kernel[...])))
    jout, tout = _run(jcw, tcw, data, jnp.asarray(feats), torch.from_numpy(feats))
    assert JDT[jout.F.dtype] is tout.F.dtype is torch.float32
    np.testing.assert_allclose(tout.F.detach().numpy(), np.asarray(jout.F), rtol=1e-5, atol=1e-5)
    fb = _bf16(feats)
    with pytest.raises(TypeError):
        _run(jcw, tcw, data, jnp.asarray(fb).astype(jnp.bfloat16), torch.from_numpy(fb))
    with pytest.raises(TypeError):
        tcw(MT.SparseTensor(torch.from_numpy(fb).bfloat16(), torch.from_numpy(coords),
                            tensor_stride=2))


def test_without_a_policy_the_input_dtype_rules(data):
    """compute_dtype None: a float32 model on float32 features is the float32
    path, and a bf16 input runs the conv in bf16."""
    assert MT.compute_dtype() is None
    coords, feats = data
    conv = MT.MinkowskiConvolution(6, 8, kernel_size=3, dimension=3, device="cpu")
    x = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords), tensor_stride=2)
    assert conv(x).F.dtype is torch.float32
    xb = MT.SparseTensor(torch.from_numpy(feats).bfloat16(), torch.from_numpy(coords), tensor_stride=2)
    assert conv(xb).F.dtype is torch.bfloat16


# --- the plain feature ops on bf16, against JAX's: dtype at each step --------


def _ops_data():
    rng = np.random.RandomState(3)
    n, c = 600, 5
    feats = _bf16(rng.randn(n, c).astype(np.float32))
    seg = rng.randint(-1, 4, n).astype(np.int32)  # -1: dropped
    in_idx = rng.randint(-1, n, (27, 200)).astype(np.int32)
    return feats, seg, in_idx


# (name, JAX call, port call, tolerance): every op's outputs in order
_OPS = {
    "take_rows": (lambda F, f, s, i: (F.take_rows(f, i[0]),), 0.0),
    "segment_sum": (lambda F, f, s, i: (F.segment_sum(f, s, 4),), SUMS),
    "segment_mean": (lambda F, f, s, i: (F.segment_mean(f, s, 4),), SUMS),
    "segment_max": (lambda F, f, s, i: (F.segment_max(f, s, 4),), 0.0),
    "local_pool_sum": (lambda F, f, s, i: F.local_pool_sum(f, i), SUMS),
    "local_pool_avg": (lambda F, f, s, i: F.local_pool_avg(f, i), SUMS),
    "local_pool_max": (lambda F, f, s, i: (F.local_pool_max(f, i),), 0.0),
    "global_avg": (lambda F, f, s, i: F.global_pool(f, s, 4, "avg"), SUMS),
    "global_max": (lambda F, f, s, i: F.global_pool(f, s, 4, "max"), 0.0),
}


@pytest.mark.parametrize("name", list(_OPS))
def test_plain_ops_follow_jaxs_dtypes(name):
    """bf16 features through each op of ``ops/functional.py``: every output
    has JAX's dtype (bf16 sums, bf16 kernel-slot counts, int32 or int64
    row counts) and its values within the op's tolerance."""
    from minkowskiengine_tpu.ops import functional as JF
    from minkowskiengine_tpu_torch.ops import functional as TF

    fn, tol = _OPS[name]
    feats, seg, in_idx = _ops_data()
    want = fn(JF, jnp.asarray(feats).astype(jnp.bfloat16), jnp.asarray(seg), jnp.asarray(in_idx))
    got = fn(TF, torch.from_numpy(feats).bfloat16(), torch.from_numpy(seg), torch.from_numpy(in_idx))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if jnp.issubdtype(w.dtype, jnp.integer):
            assert not g.dtype.is_floating_point
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            continue
        assert JDT[w.dtype] is g.dtype, (name, w.dtype, g.dtype)
        rel = float(_rel(g.float().numpy(), np.asarray(w, np.float32)))
        assert rel <= tol, (name, rel)


def test_segment_sums_of_bf16_accumulate_in_float32():
    """A segment of 26,115 rows of 0.5.  The port sums bf16 rows in float32
    and rounds the sum once (13,057.5 -> 13,056), then divides by the count
    cast to bf16, as JAX casts it (26,115 -> 26,112: bf16 keeps 8
    significant bits), giving 0.5.  JAX's CPU scatter rounds its bf16 sum
    after every add, which stops at 128 once 0.5 is half an ulp: a mean of
    0.0049.  Kept on purpose: the port's sums agree across the CPU and
    CUDA's atomics, and keep the float32 accumulation of the TPU kernels."""
    from minkowskiengine_tpu.ops import functional as JF
    from minkowskiengine_tpu_torch.ops import functional as TF

    n = 26_115
    feats = torch.full((n, 2), 0.5).bfloat16()
    seg = torch.zeros(n, dtype=torch.int32)
    assert float(torch.tensor(float(n)).bfloat16()) == 26_112.0
    s = TF.segment_sum(feats, seg, 1)
    assert s.dtype is torch.bfloat16 and torch.equal(s, torch.full((1, 2), 13_056.0).bfloat16())
    got = TF.segment_mean(feats, seg, 1)
    assert got.dtype is torch.bfloat16
    assert torch.equal(got, s / torch.tensor(26_112.0).bfloat16())
    want = JF.segment_mean(jnp.asarray(feats.float().numpy()).astype(jnp.bfloat16),
                           jnp.asarray(seg.numpy()), 1)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(want, np.float32), 128 / 26_112, rtol=2.0**-7)
