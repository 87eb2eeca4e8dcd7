"""Port parity for the dense-grid conv route (``ops/dense_conv.py``) and its
gate.

``dense_conv`` scatters a map's rows into its bbox grid, runs one
``F.conv{1,2,3}d`` and gathers the rows back; JAX's runs
``lax.conv_general_dilated`` (outside any Pallas kernel, so its CPU run is
the reference as it is).  The same numpy features, weights and output
gradient go through both, at D = 1-3, odd and even kernels, dilation 2,
Cin <= 8 and wider.  Tolerance: forward within 1e-5 of max|JAX| (float32
sums over up to 125 offsets in another order), input and weight gradients
within 1e-4 (sums over every row of the grid).  In float64 the route
equals the port's sparse conv within 1e-12.

The gate: the route is taken on the card only (never on the CPU, as JAX
takes it on the TPU only), and never by a COPY_GEMM, transposed, strided,
non-cube, explicitly targeted or spatially executed conv.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.ops.dense_conv import build_dense_plan as jax_plan
from minkowskiengine_tpu.ops.dense_conv import dense_conv as jax_dense_conv
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch import config
from minkowskiengine_tpu_torch.nn import conv as tconv
from minkowskiengine_tpu_torch.ops import dense_conv as D
from minkowskiengine_tpu_torch.ops import functional as TF

FWD_REL, GRAD_REL = 1e-5, 1e-4


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def points(dim, seed, n=120, lo=-6, hi=6):
    rng = np.random.RandomState(seed)
    c = np.concatenate([rng.randint(0, 2, (n, 1)), rng.randint(lo, hi, (n, dim))], 1)
    return np.unique(c.astype(np.int32), axis=0)


CASES = [
    # D, kernel size, dilation, Cin, Cout
    (1, 3, 1, 3, 4),
    (1, 2, 2, 12, 8),
    (2, 3, 1, 3, 5),
    (2, 4, 1, 8, 6),
    (3, 5, 1, 3, 8),
    (3, 2, 1, 16, 8),
    (3, 3, 2, 24, 16),
]


@pytest.mark.parametrize("dim,ks,dil,cin,cout", CASES)
def test_dense_conv_and_gradients_match_jax(dim, ks, dil, cin, cout):
    c = points(dim, seed=ks + 10 * dim, n=60 * dim)
    rng = np.random.RandomState(cin + cout)
    K = ks**dim
    w = (rng.randn(K, cin, cout) * 0.3).astype(np.float32)
    x = ME.SparseTensor(rng.randn(len(c), cin).astype(np.float32), c)
    n = x.size
    g = rng.randn(x.capacity, cout).astype(np.float32)
    plan_j = jax_plan(x.coordinate_map)

    def loss(f, ww):
        return jnp.sum(jax_dense_conv(f, ww, plan_j, (ks,) * dim, (dil,) * dim) * g)

    out_j = jax_dense_conv(x.padded_features, jnp.asarray(w), plan_j, (ks,) * dim, (dil,) * dim)
    dx_j, dw_j = jax.grad(loss, argnums=(0, 1))(x.padded_features, jnp.asarray(w))

    mgr = MT.CoordinateManager(D=dim, device="cpu")
    key, _ = mgr.insert_and_map(torch.from_numpy(c))
    plan = mgr.dense_plan(key)
    assert plan.grid_shape == plan_j.grid_shape
    feats = torch.from_numpy(np.array(x.F)).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = D.dense_conv(feats, wt, plan, (ks,) * dim, (dil,) * dim)
    out.backward(torch.from_numpy(g[:n]))
    assert rel(out.detach(), np.asarray(out_j)[:n]) <= FWD_REL
    assert rel(feats.grad, np.asarray(dx_j)[:n]) <= GRAD_REL
    assert rel(wt.grad, dw_j) <= GRAD_REL


@pytest.mark.parametrize("dim,ks,dil", [(3, 3, 1), (2, 4, 2), (1, 5, 1)])
def test_dense_conv_equals_the_sparse_conv_in_float64(dim, ks, dil):
    """The route against the port's own plain sparse conv, on the map the
    manager builds, in float64, forward and both gradients."""
    c = points(dim, seed=dim + ks, n=80)
    mgr = MT.CoordinateManager(D=dim, device="cpu")
    key, _ = mgr.insert_and_map(torch.from_numpy(c))
    kmap = mgr.kernel_map(key, key, kernel_size=ks, dilation=dil)
    rng = np.random.RandomState(5)
    K, n = ks**dim, mgr.size(key)
    x = torch.from_numpy(rng.randn(n, 4)).requires_grad_()
    w = torch.from_numpy(rng.randn(K, 4, 3)).requires_grad_()
    g = torch.from_numpy(rng.randn(n, 3))
    dense = D.dense_conv(x, w, mgr.dense_plan(key), (ks,) * dim, (dil,) * dim)
    dx, dw = torch.autograd.grad(dense, (x, w), g)
    sparse = TF.sparse_conv(x, w, kmap.in_idx, kmap.out_idx_t)
    sx, sw = torch.autograd.grad(sparse, (x, w), g)
    for a, b in ((dense, sparse), (dx, sx), (dw, sw)):
        assert rel(a.detach(), b.detach()) <= 1e-12


def test_dense_conv_gradcheck_float64():
    c = points(2, seed=3, n=30, lo=-3, hi=3)
    mgr = MT.CoordinateManager(D=2, device="cpu")
    key, _ = mgr.insert_and_map(torch.from_numpy(c))
    plan = mgr.dense_plan(key)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(mgr.size(key), 2)).requires_grad_()
    w = torch.from_numpy(rng.randn(4, 2, 3)).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: D.dense_conv(a, b, plan, (2, 2), (1, 1)), (x, w))


def test_dense_conv_raises_above_three_dimensions():
    mgr = MT.CoordinateManager(D=4, device="cpu")
    key, _ = mgr.insert_and_map(torch.from_numpy(points(4, seed=0, n=20, lo=-2, hi=2)))
    x = torch.zeros(mgr.size(key), 2)
    with pytest.raises(NotImplementedError):
        D.dense_conv(x, torch.zeros(81, 2, 2), mgr.dense_plan(key), (3,) * 4, (1,) * 4)


def test_cost_model_refuses_empty_and_oversized_grids():
    small = D.DensePlan(torch.zeros(8, dtype=torch.int32), (1, 16, 16, 16))
    assert not D.dense_conv_beneficial(None, 1000, 27, 3, 32)
    huge = D.DensePlan(torch.zeros(8, dtype=torch.int32), (1, 4096, 4096, 64))
    assert not D.dense_conv_beneficial(huge, 30000, 125, 3, 32)
    big = D.DensePlan(torch.zeros(8, dtype=torch.int32), (2, 64, 64, 64))
    decisions = 0
    for rows in (100, 4096, 60000):
        for K, cin, cout in ((27, 3, 32), (27, 128, 128), (125, 3, 32), (8, 64, 64)):
            for plan in (small, big):
                decisions += D.dense_conv_beneficial(plan, rows, K, cin, cout)
            # a fresh map can only push the decision toward the grid, a
            # larger grid only away from it
            if D.dense_conv_beneficial(small, rows, K, cin, cout):
                assert D.dense_conv_beneficial(small, rows, K, cin, cout, map_cached=False)
            if D.dense_conv_beneficial(big, rows, K, cin, cout):
                assert D.dense_conv_beneficial(small, rows, K, cin, cout)
    assert 0 < decisions < 48  # the shapes above fall on both sides
    four = D.DensePlan(torch.zeros(8, dtype=torch.int32), (1, 16, 16, 16, 16))
    assert not D.dense_conv_beneficial(four, 10**6, 81, 256, 256)  # dense_conv takes D <= 3


def conv_input(dim=3, cin=3, seed=0):
    c = points(dim, seed=seed, n=150)
    rng = np.random.RandomState(seed)
    return MT.SparseTensor(torch.from_numpy(rng.randn(len(c), cin).astype(np.float32)),
                           torch.from_numpy(c), device="cpu")


def on_card(x):
    """Features that report the card, for the gate's device test alone."""
    return types.SimpleNamespace(is_cuda=True, shape=x.F.shape)


def test_the_gate_never_routes_on_the_cpu(monkeypatch):
    monkeypatch.setattr(tconv, "dense_conv_beneficial", lambda *a, **k: True)
    x = conv_input()
    conv = MT.MinkowskiConvolution(3, 4, kernel_size=3, dimension=3, device="cpu")
    assert not conv._dense_dispatch(x, None, x.F)
    assert conv._dense_dispatch(x, None, on_card(x))
    called = []
    monkeypatch.setattr(tconv, "dense_conv", lambda *a, **k: called.append(1))
    conv(x)
    assert not called


@pytest.mark.parametrize("why", [
    "copy_gemm", "transposed", "strided", "cross", "coordinates", "spatial",
])
def test_the_gate_keeps_these_convs_sparse(monkeypatch, why):
    monkeypatch.setattr(tconv, "dense_conv_beneficial", lambda *a, **k: True)
    x = conv_input()
    kw = dict(kernel_size=3, dimension=3, device="cpu")
    coords = None
    if why == "copy_gemm":
        conv = MT.MinkowskiConvolution(3, 4, convolution_mode=MT.ConvolutionMode.COPY_GEMM, **kw)
    elif why == "transposed":
        conv = MT.MinkowskiConvolutionTranspose(3, 4, **kw)
    elif why == "strided":
        conv = MT.MinkowskiConvolution(3, 4, stride=2, **kw)
    elif why == "cross":
        kg = MT.KernelGenerator(kernel_size=3, region_type=MT.RegionType.HYPER_CROSS, dimension=3)
        conv = MT.MinkowskiConvolution(3, 4, kernel_generator=kg, **kw)
    else:
        conv = MT.MinkowskiConvolution(3, 4, **kw)
        coords = x.coordinate_map_key if why == "coordinates" else None
    if why == "spatial":
        monkeypatch.setattr(tconv, "spatial_execution_ctx", lambda: ("mesh", "space"))
    assert not conv._dense_dispatch(x, coords, on_card(x))


@pytest.mark.parametrize("bias", [False, True])
def test_a_conv_module_on_the_route_equals_its_sparse_run(monkeypatch, bias):
    """The module's dense branch, forced on the CPU: output and gradients
    as the sparse conv's, and the same output map; the route builds the
    plan and no kernel map."""
    x0 = conv_input(cin=3, seed=1)
    conv = MT.MinkowskiConvolution(3, 5, kernel_size=3, bias=bias, dimension=3, device="cpu",
                                   generator=torch.Generator().manual_seed(0))

    def run(route):
        f = x0.F.clone().requires_grad_()
        x = MT.SparseTensor(f, x0.C, device="cpu")
        monkeypatch.setattr(tconv.MinkowskiConvolutionBase, "_dense_dispatch",
                            lambda self, *a: route)
        conv.zero_grad()
        out = conv(x)
        (out.F * torch.linspace(-1, 1, out.F.numel()).view_as(out.F)).sum().backward()
        grads = [f.grad] + [p.grad.clone() for p in conv.parameters()]
        return out, grads, x.coordinate_manager

    dense, dgrads, dmgr = run(True)
    sparse, sgrads, _ = run(False)
    assert dense.coordinate_map_key == sparse.coordinate_map_key
    assert not dmgr._kernel_maps and dmgr._dense_plans
    assert rel(dense.F.detach(), sparse.F.detach()) <= FWD_REL
    for a, b in zip(dgrads, sgrads):
        assert rel(a, b) <= GRAD_REL


def test_the_route_under_bf16_compute(monkeypatch):
    """bf16 features through the route: bf16 out, the float32 weight's
    gradient float32, within two bf16 ulps of the float32 route."""
    x = conv_input(cin=4, seed=2)
    conv = MT.MinkowskiConvolution(4, 4, kernel_size=3, dimension=3, device="cpu",
                                   generator=torch.Generator().manual_seed(1))
    monkeypatch.setattr(tconv.MinkowskiConvolutionBase, "_dense_dispatch", lambda self, *a: True)
    want = conv(x).F.detach()
    config.set_compute_dtype(torch.bfloat16)
    try:
        out = conv(x)
        out.F.float().sum().backward()
    finally:
        config.set_compute_dtype(None)
    assert out.F.dtype == torch.bfloat16 and conv.kernel.grad.dtype == torch.float32
    assert rel(out.F.float().detach(), want) <= 2 * 2.0**-7
