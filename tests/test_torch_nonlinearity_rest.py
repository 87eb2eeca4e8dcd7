"""Port parity for the nonlinearities below the ``_make`` family: Hardtanh,
Threshold, Hardshrink, Softshrink, Tanhshrink, PReLU, RReLU, Softmax,
Softmin, LogSoftmax, AlphaDropout, Sinusoidal and
AdaptiveLogSoftmaxWithLoss.

The same numpy features, on a sparse tensor of two batch items, go through
the JAX layer and the port's (parameters carried across through
``utils/torch_import.py``); outputs and input and parameter gradients agree
within rtol 1e-5 / atol 1e-6 (one elementwise function, or one softmax over
a row, in float32).  AlphaDropout's masks come from different generators
in the two packages, so one numpy mask is injected into both; its
self-normalizing statistics are checked as the JAX package's own test does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import minkowskiengine_tpu as ME
import minkowskiengine_tpu_torch as MT

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    coords = np.unique(np.concatenate(
        [rng.randint(0, 2, (400, 1)), rng.randint(-5, 5, (400, 3))], 1
    ).astype(np.int32), axis=0)
    feats = rng.randn(len(coords), 6).astype(np.float32) * 2.0
    g = rng.randn(len(coords), 6).astype(np.float32)
    return coords, feats, g


def _jx(coords, feats):
    return ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords))


def _run(jmod, tmod, data, out_ch=6, atol=ATOL):
    """Outputs and input gradients of both layers; returns the port's output."""
    coords, feats, g = data
    g = g[:, :out_ch]
    jx = _jx(coords, feats)

    def f(fe):
        return jmod(ME.SparseTensor(fe, coordinate_map_key=jx.coordinate_map_key,
                                    coordinate_manager=jx.coordinate_manager)).F

    want, vjp = jax.vjp(f, jnp.asarray(feats))
    (want_grad,) = vjp(jnp.asarray(g))
    tf = torch.from_numpy(feats).requires_grad_()
    out = tmod(MT.SparseTensor(tf, torch.from_numpy(coords), device="cpu"))
    out.F.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.C.numpy(), np.asarray(jx.C))
    np.testing.assert_allclose(out.F.detach().numpy(), np.asarray(want), rtol=RTOL, atol=atol)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=atol)
    return out


ELEMENTWISE = {
    "hardtanh": (lambda: ME.MinkowskiHardtanh(), lambda: MT.MinkowskiHardtanh()),
    "hardtanh-0.5-2": (lambda: ME.MinkowskiHardtanh(-0.5, 2.0), lambda: MT.MinkowskiHardtanh(-0.5, 2.0)),
    "threshold": (lambda: ME.MinkowskiThreshold(0.3, -1.0), lambda: MT.MinkowskiThreshold(0.3, -1.0)),
    "threshold-zero": (lambda: ME.MinkowskiThreshold(-0.2, 0.0), lambda: MT.MinkowskiThreshold(-0.2, 0.0)),
    "hardshrink": (lambda: ME.MinkowskiHardshrink(), lambda: MT.MinkowskiHardshrink()),
    "hardshrink-1": (lambda: ME.MinkowskiHardshrink(1.0), lambda: MT.MinkowskiHardshrink(1.0)),
    "softshrink": (lambda: ME.MinkowskiSoftshrink(), lambda: MT.MinkowskiSoftshrink()),
    "softshrink-1": (lambda: ME.MinkowskiSoftshrink(1.0), lambda: MT.MinkowskiSoftshrink(1.0)),
    "tanhshrink": (lambda: ME.MinkowskiTanhshrink(), lambda: MT.MinkowskiTanhshrink()),
    "softmax": (lambda: ME.MinkowskiSoftmax(), lambda: MT.MinkowskiSoftmax()),
    "softmax-dim1": (lambda: ME.MinkowskiSoftmax(dim=1), lambda: MT.MinkowskiSoftmax(dim=1)),
    "softmin": (lambda: ME.MinkowskiSoftmin(), lambda: MT.MinkowskiSoftmin()),
    "logsoftmax": (lambda: ME.MinkowskiLogSoftmax(), lambda: MT.MinkowskiLogSoftmax()),
}


@pytest.mark.parametrize("name", list(ELEMENTWISE))
def test_elementwise_matches_jax(data, name):
    jmake, tmake = ELEMENTWISE[name]
    _run(jmake(), tmake(), data)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_rrelu_uses_the_mean_slope_as_jax(data, mode):
    """JAX's RReLU uses (lower + upper) / 2 in train mode too; torch's samples
    a slope per entry there (ROADMAP queue 3)."""
    tm = MT.MinkowskiRReLU(0.1, 0.3)
    tm.train(mode == "train")
    out = _run(ME.MinkowskiRReLU(0.1, 0.3), tm, data)
    x = torch.from_numpy(data[1])
    torch.testing.assert_close(out.F.detach(), torch.where(x >= 0, x, 0.2 * x), rtol=0, atol=0)


@pytest.mark.parametrize("num_parameters", [1, 6])
def test_prelu_matches_jax(data, num_parameters):
    jm = ME.MinkowskiPReLU(num_parameters, init=0.25)
    tm = MT.MinkowskiPReLU(num_parameters, device="cpu")
    assert tm.weight.shape == (num_parameters,) and torch.all(tm.weight == 0.25)
    w = np.random.RandomState(1).uniform(0.05, 0.5, num_parameters).astype(np.float32)
    jm.weight[...] = jnp.asarray(w)
    MT.utils.load_reference_state_dict(tm, {"weight": w})
    _run(jm, tm, data)
    coords, feats, g = data
    grads = nnx.grad(lambda m: (m(_jx(coords, feats)).F * jnp.asarray(g)).sum())(jm)
    np.testing.assert_allclose(tm.weight.grad.numpy(), np.asarray(grads.weight[...]),
                               rtol=RTOL, atol=1e-4)


def test_sinusoidal_matches_jax(data):
    """atol 2e-5: cos of arguments up to ~15, each a 6-term float32 sum in
    another order (~1e-6 of rounding, times the slope)."""
    jm = ME.MinkowskiSinusoidal(6, 4, rngs=nnx.Rngs(0))
    tm = MT.MinkowskiSinusoidal(6, 4, generator=torch.Generator().manual_seed(0), device="cpu")
    assert set(tm.state_dict()) == {"kernel"} and tm.kernel.shape == (6, 4)
    MT.utils.load_reference_state_dict(tm, {"kernel": np.asarray(jm.kernel[...])})
    _run(jm, tm, data, out_ch=4, atol=2e-5)
    coords, feats, g = data
    grads = nnx.grad(lambda m: (m(_jx(coords, feats)).F * jnp.asarray(g[:, :4])).sum())(jm)
    np.testing.assert_allclose(tm.kernel.grad.numpy(), np.asarray(grads.kernel[...]),
                               rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("p", [0.2, 0.5])
def test_alpha_dropout_with_one_mask_matches_jax(monkeypatch, data, p):
    """One numpy mask injected into both packages (JAX draws its own inside
    the module, so its output is compared without a VJP; the port's input
    gradient is a · mask · g)."""
    coords, feats, g = data
    jx = _jx(coords, feats)
    mask = np.random.RandomState(2).rand(jx.capacity, 6) >= p
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, q, shape: jnp.asarray(mask[: shape[0]]))
    want = ME.MinkowskiAlphaDropout(p, rngs=nnx.Rngs(1))(jx).F
    tm = MT.MinkowskiAlphaDropout(p)
    tm._keep_mask = lambda x: torch.from_numpy(mask[: x.shape[0]])
    tf = torch.from_numpy(feats).requires_grad_()
    x = MT.SparseTensor(tf, torch.from_numpy(coords), device="cpu")
    out = tm(x)
    out.F.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.F.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    a = ((1 - p) * (1 + p * 1.7580993408473766**2)) ** -0.5
    np.testing.assert_allclose(tf.grad.numpy(), a * mask[: len(coords)] * g, rtol=RTOL, atol=ATOL)
    tm.eval()
    assert torch.equal(tm(x).F, x.F)


def test_alpha_dropout_keeps_self_normalizing_statistics():
    rng = np.random.RandomState(0)
    coords = np.unique(np.concatenate(
        [np.zeros((8000, 1), np.int32), rng.randint(0, 40, (8000, 3)).astype(np.int32)], 1),
        axis=0)[:4000]
    x = MT.SparseTensor(torch.from_numpy(rng.randn(len(coords), 8).astype(np.float32)),
                        torch.from_numpy(coords), device="cpu")
    ad = MT.MinkowskiAlphaDropout(0.3, generator=torch.Generator().manual_seed(1))
    v = ad(x).F
    assert abs(v.mean().item()) < 0.05
    assert abs(v.std().item() - 1.0) < 0.1
    # the same generator state gives the same mask
    again = MT.MinkowskiAlphaDropout(0.3, generator=torch.Generator().manual_seed(1))
    assert torch.equal(again(x).F, v)


def _adaptive_pair(head_bias=False, div_value=4.0):
    kw = dict(cutoffs=[4, 12], div_value=div_value, head_bias=head_bias)
    jm = ME.MinkowskiAdaptiveLogSoftmaxWithLoss(6, 30, rngs=nnx.Rngs(0), **kw)
    tm = MT.MinkowskiAdaptiveLogSoftmaxWithLoss(6, 30, device="cpu", **kw)
    # JAX holds the tail in an nnx.List, which its exporter cannot name:
    # the leaves are named here, as torch.nn.AdaptiveLogSoftmaxWithLoss names them
    sd = {"head.weight": np.asarray(jm.head.kernel[...]).T}
    if head_bias:
        sd["head.bias"] = np.asarray(jm.head.bias[...])
    for i, (proj, out) in enumerate(jm.tail):
        sd[f"tail.{i}.0.weight"] = np.asarray(proj.kernel[...]).T
        sd[f"tail.{i}.1.weight"] = np.asarray(out.kernel[...]).T
    assert set(sd) == set(tm.state_dict())
    MT.utils.load_reference_state_dict(tm, sd)
    return jm, tm


@pytest.mark.parametrize("head_bias", [False, True])
def test_adaptive_log_softmax_matches_jax(data, head_bias):
    coords, feats, _ = data
    jm, tm = _adaptive_pair(head_bias=head_bias)
    jx = _jx(coords, feats)
    n = len(coords)
    target = np.random.RandomState(3).randint(0, 30, jx.capacity).astype(np.int32)

    def f(fe):
        x = ME.SparseTensor(fe, coordinate_map_key=jx.coordinate_map_key,
                            coordinate_manager=jx.coordinate_manager)
        return jm(x, jnp.asarray(target))

    (want_out, want_loss), vjp = jax.vjp(f, jnp.asarray(feats))
    (want_dx,) = vjp((jnp.zeros_like(want_out), jnp.ones_like(want_loss)))
    tf = torch.from_numpy(feats).requires_grad_()
    x = MT.SparseTensor(tf, torch.from_numpy(coords), device="cpu")
    out, loss = tm(x, torch.from_numpy(target[:n]).long())
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out)[:n], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_dx)[:n], rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        lp = tm.log_prob(x)
        pred = tm.predict(x)
    assert lp.shape == (n, 30)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jm.log_prob(jx))[:n], rtol=RTOL, atol=1e-5)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jm.predict(jx))[:n])
    torch.testing.assert_close(lp.exp().sum(1), torch.ones(n), rtol=0, atol=1e-5)


def test_adaptive_log_softmax_matches_torch_module(data):
    """Named as torch's, it loads into torch.nn.AdaptiveLogSoftmaxWithLoss and
    agrees with it (at div_value 2, where no tail projection rounds to width
    0 in torch; JAX and the port keep at least 1)."""
    coords, feats, _ = data
    _, tm = _adaptive_pair(div_value=2.0)
    ref = torch.nn.AdaptiveLogSoftmaxWithLoss(6, 30, cutoffs=[4, 12], div_value=2.0)
    ref.load_state_dict(tm.state_dict())
    target = torch.from_numpy(np.random.RandomState(4).randint(0, 30, len(coords)))
    out, loss = tm(MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords), device="cpu"),
                   target)
    want = ref(torch.from_numpy(feats), target)
    torch.testing.assert_close(out, want.output, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(loss, want.loss, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cutoffs", [[5, 3], [0, 4], [4, 4], [4, 30]])
def test_adaptive_log_softmax_refuses_bad_cutoffs_as_jax(cutoffs):
    with pytest.raises(ValueError):
        ME.MinkowskiAdaptiveLogSoftmaxWithLoss(6, 30, cutoffs=cutoffs)
    with pytest.raises(ValueError):
        MT.MinkowskiAdaptiveLogSoftmaxWithLoss(6, 30, cutoffs=cutoffs, device="cpu")
