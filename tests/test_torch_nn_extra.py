"""Port parity for the layers the classification slice adds: MinkowskiLinear,
MinkowskiInstanceNorm, LeakyReLU, GELU and Dropout, and batch norm on a
TensorField.

The same numpy features, on a sparse tensor of two batch items, go through
the JAX layer and the port's; outputs and input and parameter gradients
are compared.  Tolerance rtol 1e-5 / atol 1e-6: one f32 product or one
normalization over a few hundred rows, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.utils.torch_import import (
    export_reference_state_dict,
    load_reference_state_dict,
)
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.utils.torch_import import load_state_dict_from_reference

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    coords = np.unique(np.concatenate(
        [rng.randint(0, 2, (500, 1)), rng.randint(-5, 5, (500, 3))], 1
    ).astype(np.int32), axis=0)
    feats = rng.randn(len(coords), 6).astype(np.float32) * 3.0
    g = rng.randn(len(coords), 6).astype(np.float32)
    return coords, feats, g


def _run(jmod, tmod, data, out_ch=6, grad_atol=ATOL):
    """Outputs, input gradients and the port's tensor of both layers."""
    coords, feats, g = data
    g = g[:, :out_ch]
    jx = ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords))

    def f(fe):
        return jmod(ME.SparseTensor(fe, coordinate_map_key=jx.coordinate_map_key,
                                    coordinate_manager=jx.coordinate_manager)).F

    want, vjp = jax.vjp(f, jnp.asarray(feats))
    (want_grad,) = vjp(jnp.asarray(g))
    tf = torch.from_numpy(feats).requires_grad_()
    out = tmod(MT.SparseTensor(tf, torch.from_numpy(coords)))
    out.F.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.F.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=grad_atol)
    return out


@pytest.mark.parametrize("bias", [True, False])
def test_linear_matches_jax(data, bias):
    jlin = ME.MinkowskiLinear(6, 5, bias=bias)
    tlin = MT.MinkowskiLinear(6, 5, bias=bias, device="cpu")
    sd = export_reference_state_dict(jlin)
    assert sd["linear.weight"].shape == (5, 6)  # the reference's (out, in)
    load_state_dict_from_reference(tlin, sd)
    _run(jlin, tlin, data, out_ch=5)


def test_linear_init_is_reproducible_and_uniform():
    a = MT.MinkowskiLinear(64, 8, generator=torch.Generator().manual_seed(0), device="cpu")
    b = MT.MinkowskiLinear(64, 8, generator=torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(a.linear.weight, b.linear.weight)
    assert a.linear.weight.abs().max() <= 1 / 8 and a.linear.bias.abs().max() <= 1 / 8


@pytest.mark.parametrize("stable", [False, True], ids=["instance", "stable"])
def test_instance_norm_matches_jax(data, stable):
    rng = np.random.RandomState(1)
    sd = {"weight": rng.uniform(0.5, 2, (1, 6)).astype(np.float32),
          "bias": rng.randn(1, 6).astype(np.float32)}
    jcls = ME.MinkowskiStableInstanceNorm if stable else ME.MinkowskiInstanceNorm
    tcls = MT.MinkowskiStableInstanceNorm if stable else MT.MinkowskiInstanceNorm
    jin, tin = jcls(6), tcls(6, device="cpu")
    load_reference_state_dict(jin, sd)
    load_state_dict_from_reference(tin, sd)
    assert set(tin.state_dict()) == {"weight", "bias"} and tin.eps == 1e-6
    out = _run(jin, tin, data)
    # each batch item is normalized on its own
    for b in (0, 1):
        rows = out.C[:, 0] == b
        y = (out.F[rows] - tin.bias) / tin.weight
        torch.testing.assert_close(y.mean(0), torch.zeros(6), atol=1e-5, rtol=0)
    # the parameters' gradients match JAX's too
    coords, feats, g = data

    def loss(m):
        return (m(ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords))).F
                * jnp.asarray(g)).sum()

    grads = nnx.grad(loss)(jin)
    np.testing.assert_allclose(tin.weight.grad.numpy(), np.asarray(grads.weight[...]),
                               rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(tin.bias.grad.numpy(), np.asarray(grads.bias[...]),
                               rtol=RTOL, atol=1e-4)


def test_leaky_relu_matches_jax(data):
    _run(ME.MinkowskiLeakyReLU(), MT.MinkowskiLeakyReLU(), data)


def test_gelu_is_the_tanh_form_as_in_jax(data):
    """JAX's MinkowskiGELU is ``jax.nn.gelu`` (tanh form); the port matches it,
    not the reference's exact erf form (ROADMAP queue 3).  The input
    gradient gets atol 1e-5: torch and XLA evaluate the tanh form's
    derivative in different operation orders, which differ by up to 4e-6
    at |x| ~ 10 before the upstream gradient scales it."""
    out = _run(ME.MinkowskiGELU(), MT.MinkowskiGELU(), data, grad_atol=1e-5)
    exact = torch.nn.functional.gelu(torch.from_numpy(data[1]))
    assert (out.F.detach() - exact).abs().max() > 1e-5


def test_dropout_eval_is_the_identity_and_train_scales_the_kept(data):
    coords, feats, _ = data
    x = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords))
    drop = MT.MinkowskiDropout(p=0.25, generator=torch.Generator().manual_seed(0))
    assert torch.equal(drop.eval()(x).F, x.F)
    jd = ME.MinkowskiDropout(p=0.25)
    jd.eval()
    np.testing.assert_array_equal(
        np.asarray(jd(ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords))).F), feats
    )
    y = drop.train()(x).F
    kept = y != 0
    torch.testing.assert_close(y[kept], x.F[kept] / 0.75)
    assert 0.65 < kept.float().mean().item() < 0.85
    # the same generator state gives the same mask
    again = MT.MinkowskiDropout(p=0.25, generator=torch.Generator().manual_seed(0)).train()
    assert torch.equal(again(x).F, y)
    # JAX's train mode has the same structure: zeros, and x / (1 - p) elsewhere
    jd.train()
    jy = np.asarray(jd(ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords))).F)
    np.testing.assert_allclose(jy[jy != 0], feats[jy != 0] / 0.75, rtol=1e-6)


def test_batch_norm_on_a_tensor_field_matches_jax():
    rng = np.random.RandomState(2)
    coords = np.concatenate([rng.randint(0, 2, (200, 1)), rng.uniform(-3, 3, (200, 3))], 1)
    coords = coords.astype(np.float32)
    feats = rng.randn(200, 4).astype(np.float32)
    jbn, tbn = ME.MinkowskiBatchNorm(4), MT.MinkowskiBatchNorm(4, device="cpu").train()
    jbn.train()
    want = jbn(ME.TensorField(jnp.asarray(feats), jnp.asarray(coords)))
    got = tbn(MT.TensorField(torch.from_numpy(feats), torch.from_numpy(coords)))
    assert isinstance(got, MT.TensorField)
    np.testing.assert_allclose(got.F.detach().numpy(), np.asarray(want.F), rtol=RTOL, atol=ATOL)
