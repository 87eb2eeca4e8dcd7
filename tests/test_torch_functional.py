"""Port parity for ``MinkowskiFunctional``: every unary wrapper, ``prelu``,
``normalize``, ``linear``, ``dropout``, ``alpha_dropout`` and the five
losses.

The same numpy features, on a sparse tensor of two batch items, go through
``minkowskiengine_tpu.MinkowskiFunctional`` and the port's; values agree
within rtol 1e-6 / atol 1e-6 (one float32 function per entry, or one
reduction over a row or over all entries).  The dropout masks come from
different generators in the two packages, so one numpy mask is injected
into both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import minkowskiengine_tpu as ME
import minkowskiengine_tpu_torch as MT

JF, TF = ME.MinkowskiFunctional, MT.MinkowskiFunctional
RTOL, ATOL = 1e-6, 1e-6


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    coords = np.unique(np.concatenate(
        [rng.randint(0, 2, (300, 1)), rng.randint(-5, 5, (300, 3))], 1
    ).astype(np.int32), axis=0)
    feats = rng.randn(len(coords), 6).astype(np.float32) * 2.0
    return coords, feats


def _pair(coords, feats):
    return (ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords)),
            MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords), device="cpu"))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.F if hasattr(got, "F") else got
    want = want.F if hasattr(want, "F") else want
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


UNARY = [
    ("relu", (), {}), ("relu6", (), {}), ("elu", (), {}), ("selu", (), {}), ("celu", (), {}),
    ("gelu", (), {}), ("silu", (), {}), ("leaky_relu", (), {}), ("leaky_relu", (0.2,), {}),
    ("tanh", (), {}), ("sigmoid", (), {}), ("logsigmoid", (), {}), ("softplus", (), {}),
    ("softsign", (), {}), ("hardsigmoid", (), {}), ("hardswish", (), {}),
    ("hardtanh", (), {}), ("hardtanh", (), dict(min_val=-0.5, max_val=2.0)),
    ("softmax", (), {}), ("softmax", (), dict(dim=1)), ("softmin", (), {}),
    ("log_softmax", (), {}), ("glu", (), {}), ("tanhshrink", (), {}),
    ("hardshrink", (), {}), ("hardshrink", (), dict(lambd=1.0)),
    ("softshrink", (), {}), ("softshrink", (), dict(lambd=1.0)),
    ("threshold", (0.1, -2.0), {}),
]


@pytest.mark.parametrize("name,args,kwargs", UNARY,
                         ids=[f"{n}{i}" for i, (n, _, _) in enumerate(UNARY)])
def test_unary_matches_jax(data, name, args, kwargs):
    jx, tx = _pair(*data)
    want = getattr(JF, name)(jx, *args, **kwargs)
    got = getattr(TF, name)(tx, *args, **kwargs)
    assert got.coordinate_map_key == tx.coordinate_map_key
    _close(got, want)


def test_prelu_normalize_linear_match_jax(data):
    jx, tx = _pair(*data)
    rng = np.random.RandomState(1)
    w = rng.uniform(0.05, 0.5, 6).astype(np.float32)
    _close(TF.prelu(tx, torch.from_numpy(w)), JF.prelu(jx, jnp.asarray(w)))
    for p in (2.0, 1.0):
        _close(TF.normalize(tx, p=p), JF.normalize(jx, p=p))
    weight = rng.randn(4, 6).astype(np.float32)
    bias = rng.randn(4).astype(np.float32)
    _close(TF.linear(tx, torch.from_numpy(weight), torch.from_numpy(bias)),
           JF.linear(jx, jnp.asarray(weight), jnp.asarray(bias)), rtol=1e-5, atol=1e-5)
    _close(TF.linear(tx, torch.from_numpy(weight)), JF.linear(jx, jnp.asarray(weight)),
           rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_losses_match_jax(data, reduction):
    coords, feats = data
    rng = np.random.RandomState(2)
    other = rng.randn(*feats.shape).astype(np.float32)
    probs = rng.uniform(0.01, 0.99, feats.shape).astype(np.float32)
    targets = (rng.rand(*feats.shape) > 0.5).astype(np.float32)
    labels = rng.randint(0, 6, len(feats))
    jx, tx = _pair(coords, feats)
    jy, ty = _pair(coords, other)
    jp, tp = _pair(coords, probs)
    tol = dict(rtol=1e-6, atol=1e-6 * (len(feats) * 6 if reduction == "sum" else 1))
    _close(TF.mse_loss(tx, ty, reduction), JF.mse_loss(jx, jy, reduction), **tol)
    _close(TF.l1_loss(tx, ty, reduction), JF.l1_loss(jx, jy, reduction), **tol)
    _close(TF.binary_cross_entropy_with_logits(tx, torch.from_numpy(targets), reduction),
           JF.binary_cross_entropy_with_logits(jx, jnp.asarray(targets), reduction), **tol)
    _close(TF.binary_cross_entropy(tp, torch.from_numpy(targets), reduction),
           JF.binary_cross_entropy(jp, jnp.asarray(targets), reduction), **tol)
    _close(TF.cross_entropy(tx, torch.from_numpy(labels), reduction),
           JF.cross_entropy(jx, jnp.asarray(labels), reduction), **tol)


def test_loss_gradients_match_jax(data):
    coords, feats = data
    labels = np.random.RandomState(3).randint(0, 6, len(feats))
    want = jax.grad(lambda f: JF.cross_entropy(f, jnp.asarray(labels)))(jnp.asarray(feats))
    tf = torch.from_numpy(feats).requires_grad_()
    TF.cross_entropy(tf, torch.from_numpy(labels)).backward()
    _close(tf.grad, want)


@pytest.fixture()
def one_mask(monkeypatch, data):
    """Both packages draw this numpy keep mask (p = 0.3)."""
    coords, feats = data
    cap = ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords)).capacity
    mask = np.random.RandomState(4).rand(cap, 6) >= 0.3
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, q, shape: jnp.asarray(mask[: shape[0]]))
    monkeypatch.setattr(MT.nn.functional, "keep_mask",
                        lambda x, p, generator: torch.from_numpy(mask[: x.shape[0]]))
    return mask


def test_dropout_with_one_mask_matches_jax(data, one_mask):
    jx, tx = _pair(*data)
    got = TF.dropout(tx, 0.3, generator=torch.Generator())
    _close(got, JF.dropout(jx, 0.3, key=jax.random.PRNGKey(0)))
    assert (got.F == 0).sum() == (~one_mask[: len(data[0])]).sum()


def test_alpha_dropout_is_the_modules_not_jaxs_plain_dropout(data, one_mask):
    """The port's ``alpha_dropout`` computes ``MinkowskiAlphaDropout``; JAX's
    ``MF.alpha_dropout`` is plain dropout (ROADMAP queue 3)."""
    jx, tx = _pair(*data)
    got = TF.alpha_dropout(tx, 0.3, generator=torch.Generator())
    _close(got, ME.MinkowskiAlphaDropout(0.3, rngs=nnx.Rngs(0))(jx))
    plain = JF.alpha_dropout(jx, 0.3, key=jax.random.PRNGKey(0))
    assert np.abs(got.F.numpy() - np.asarray(plain.F)).max() > 0.1


@pytest.mark.parametrize("fn", ["dropout", "alpha_dropout"])
def test_dropout_needs_a_generator_in_training(data, fn):
    jx, tx = _pair(*data)
    with pytest.raises(ValueError):
        getattr(JF, fn)(jx, 0.5)
    with pytest.raises(ValueError):
        getattr(TF, fn)(tx, 0.5)
    assert getattr(TF, fn)(tx, 0.5, training=False) is tx
    assert getattr(TF, fn)(tx, 0.0, generator=torch.Generator()) is tx
    a = getattr(TF, fn)(tx, 0.5, generator=torch.Generator().manual_seed(0)).F
    b = getattr(TF, fn)(tx, 0.5, generator=torch.Generator().manual_seed(0)).F
    assert torch.equal(a, b)


def test_every_jax_function_exists():
    names = [n for n in dir(JF) if not n.startswith("_") and callable(getattr(JF, n))
             and getattr(getattr(JF, n), "__module__", "").startswith("minkowskiengine_tpu")]
    assert names and all(hasattr(TF, n) for n in names)
