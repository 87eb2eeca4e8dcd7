"""The bf16 sparse convolution's plain versions against the JAX package.

The port's bf16 kernels, and so their plain versions, compute what the TPU
kernel computes: bf16 X and W, each product exact in float32, a float32 sum
over every offset, one rounding to bf16 (``sparse_conv_fwd_pallas``,
conv_kernel.py:797-820), and a float32 dW (``sparse_conv_dw_pallas``,
:1460).  JAX's CPU path differs on purpose: its XLA scan keeps a bf16
accumulator and rounds after every offset, and its dW is bf16
(ops/functional.py:105-142).  So the plain versions are held two ways:

* tight: within one bf16 ulp at the output's largest value (max |Δ| /
  max |ref| <= 2^-7) of JAX's float32 ``sparse_conv`` on the same
  bf16-rounded inputs and weights, rounded once, and of the Pallas kernel
  itself run on bf16 in interpret mode; the float32 dW within 1e-5 of
  JAX's float32 dW and of the Pallas dW (float32 sums in another order);
* loose: within sqrt(K) · 2^-8 of JAX under ``set_compute_dtype(bf16)``,
  whose bf16 running sum rounds after each of K offsets: K roundings of up
  to half an ulp (2^-9 of the sum) that add as a random walk, times two
  (measured on these inputs: 4.4e-3, 1.3e-2 and 2.5e-2 at K = 8, 27 and
  125, against bounds of 1.1e-2, 2.0e-2 and 4.4e-2).

The Pallas path also adds its outlier pairs (the slab map's dropped pairs)
to the already-rounded bf16 output, a second rounding the port, with no
slabs, does not have: on a map with outliers the tight bound is two ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.experimental.pallas import tpu as pltpu

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.ops import functional as JF
from minkowskiengine_tpu.ops.pallas.conv_kernel import sparse_conv_dw_pallas
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.coords.kernel_map import KernelMap, _invert_matching
from minkowskiengine_tpu_torch.kernels.conv_dw import conv_dw, conv_dw_reference
from minkowskiengine_tpu_torch.kernels.gather_gemm import gather_gemm, gather_gemm_reference
from minkowskiengine_tpu_torch.ops import functional as TF
from test_torch_sparse_conv import _matching, _slab_map

ULP = 2.0**-7
DW_RTOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _round(a):
    """numpy float32 rounded to bf16 (nearest even) and back."""
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float().numpy()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16()


def _once(a):
    """A float32 JAX result rounded to bf16 once, as numpy float32."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _case(K, cin, cout, seed, n_in=300, n_out=260):
    rng = np.random.RandomState(seed)
    x = _round(rng.randn(n_in, cin).astype(np.float32))
    w = _round((rng.randn(K, cin, cout) / np.sqrt(K * cin)).astype(np.float32))
    g = _round(rng.randn(n_out, cout).astype(np.float32))
    idx = _matching(K, n_out, n_in, seed=seed)
    return x, w, g, idx


@pytest.fixture
def jax_bf16():
    ME.set_compute_dtype(jnp.bfloat16)
    MT.set_compute_dtype(torch.bfloat16)
    yield
    ME.set_compute_dtype(None)
    MT.set_compute_dtype(None)


@pytest.mark.parametrize("cin,cout", [(3, 32), (32, 32), (16, 24)])
@pytest.mark.parametrize("K", [8, 27, 125])
def test_plain_is_jaxs_float32_conv_rounded_once(K, cin, cout):
    x, w, _, idx = _case(K, cin, cout, seed=K + cin)
    want = _once(JF.sparse_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx), None))
    got = gather_gemm_reference(_t(x), _t(w), torch.from_numpy(idx))
    assert got.dtype is torch.bfloat16
    assert _rel(got.float().numpy(), want) <= ULP
    via = TF.sparse_conv(_t(x), torch.from_numpy(w), torch.from_numpy(idx), None)
    assert via.dtype is torch.bfloat16 and torch.equal(via, got)  # the f32 weight, cast inside


@pytest.mark.parametrize("K,cin,cout,span", [(8, 3, 32, 8), (27, 32, 32, 8), (27, 32, 32, 300)],
                         ids=["k8-stem", "k27", "k27-outliers"])
def test_plain_is_the_pallas_kernel_on_bf16(K, cin, cout, span):
    """The TPU kernels on bf16 in interpret mode: the forward rounds once
    (twice with outlier pairs), the dW is float32."""
    cap, n = 1024, 700
    in_idx, sm = _slab_map(cap, K, n, seed=K, span=span)
    outliers = sm.ov_src is not None and int(sm.ov_count) > 0
    assert outliers == (span > 100)
    rng = np.random.RandomState(cin)
    x = _round(rng.randn(cap, cin).astype(np.float32))
    w = _round((rng.randn(K, cin, cout) / np.sqrt(K * cin)).astype(np.float32))
    g = _round(rng.randn(cap, cout).astype(np.float32))
    x[n:], g[n:] = 0, 0
    jx, jw, jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, g))
    with pltpu.force_tpu_interpret_mode():
        out = JF.sparse_conv_pallas(jx, jw, sm, sm, jnp.int32(n), jnp.int32(n))
        dw = JF._outlier_dw(
            sparse_conv_dw_pallas(jx, jg, sm, (K, cin, cout), n_valid_out=jnp.int32(n)), jx, jg, sm
        )
    assert out.dtype == jnp.bfloat16 and dw.dtype == jnp.float32
    idx = torch.from_numpy(in_idx[:, :n].copy())
    got = gather_gemm_reference(_t(x[:n]), _t(w), idx)
    assert _rel(got.float().numpy(), np.asarray(out[:n], np.float32)) <= (2 if outliers else 1) * ULP
    got_dw = conv_dw_reference(_t(x[:n]), _t(g[:n]), idx)
    assert got_dw.dtype is torch.float32
    assert _rel(got_dw.numpy(), np.asarray(dw)) <= DW_RTOL


@pytest.mark.parametrize("K,cin,cout", [(8, 16, 24), (27, 32, 32), (125, 3, 32)])
def test_plain_is_near_jax_under_bf16(jax_bf16, K, cin, cout):
    """JAX's CPU bf16 path, which rounds its sum after every offset."""
    x, w, g, idx = _case(K, cin, cout, seed=K)
    jx, jw = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16)
    want = JF.sparse_conv(jx, jw, jnp.asarray(idx), None)
    assert want.dtype == jnp.bfloat16
    got = gather_gemm_reference(_t(x), _t(w), torch.from_numpy(idx))
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= np.sqrt(K) * 2.0**-8


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("K", [8, 27])
def test_grads_through_the_function(K, transposed):
    """bf16 features and the float32 weight through ``sparse_conv``: the
    input gradient is bf16, one ulp from JAX's float32 VJP rounded once; the
    weight gradient is float32, the float32 sum (within 1e-5 of JAX's
    float32 dW, bit-equal to the plain version's), not its bf16 rounding."""
    n_in, n_out, cin, cout = 300, 260, 16, 24
    in_idx = _matching(K, n_out, n_in, seed=K + 3)
    kmap = KernelMap(torch.from_numpy(in_idx), _invert_matching(torch.from_numpy(in_idx), n_in),
                     n_in, n_out)
    if transposed:
        kmap = kmap.swap()
    rng = np.random.RandomState(K)
    x = _round(rng.randn(kmap.n_in, cin).astype(np.float32))
    w = _round((rng.randn(K, cin, cout) / np.sqrt(K * cin)).astype(np.float32))
    g = _round(rng.randn(kmap.n_out, cout).astype(np.float32))
    ji, jt = jnp.asarray(kmap.in_idx.numpy()), jnp.asarray(kmap.out_idx_t.numpy())
    want, vjp = jax.vjp(lambda f, k: JF.sparse_conv(f, k, ji, jt), jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))

    tx = _t(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()  # the float32 parameter
    before = (gather_gemm.launches, gather_gemm.bf16_launches, conv_dw.bf16_launches)
    out = TF.sparse_conv_kmap(tx, tw, kmap)
    out.backward(_t(g))
    assert (gather_gemm.launches, gather_gemm.bf16_launches, conv_dw.bf16_launches) == before
    assert out.dtype is tx.grad.dtype is torch.bfloat16 and tw.grad.dtype is torch.float32
    assert _rel(out.detach().float().numpy(), _once(want)) <= ULP
    assert _rel(tx.grad.float().numpy(), _once(want_dx)) <= ULP
    assert _rel(tw.grad.numpy(), np.asarray(want_dw)) <= DW_RTOL
    assert torch.equal(tw.grad, conv_dw_reference(_t(x), _t(g), kmap.in_idx))
    assert not torch.equal(tw.grad, tw.grad.bfloat16().float())


def test_module_weight_gradient_is_float32_under_the_policy(jax_bf16):
    """A conv module under ``set_compute_dtype(bf16)``: bf16 output, a
    float32 kernel gradient equal to the float32 sum of its bf16 products;
    JAX's is that sum rounded to bf16, one ulp away."""
    rng = np.random.RandomState(0)
    coords = np.unique(np.concatenate([rng.randint(0, 2, (400, 1)), rng.randint(-4, 4, (400, 3))],
                                      1).astype(np.int32), axis=0)
    feats = rng.randn(len(coords), 8).astype(np.float32)
    jconv = ME.MinkowskiConvolution(8, 16, kernel_size=3, dimension=3)
    tconv = MT.MinkowskiConvolution(8, 16, kernel_size=3, dimension=3, device="cpu")
    with torch.no_grad():
        tconv.kernel.copy_(torch.from_numpy(np.asarray(jconv.kernel[...])))
    g = _round(rng.randn(len(coords), 16).astype(np.float32))

    jx = ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords))

    def loss(m):
        return jnp.sum(m(jx).F.astype(jnp.float32) * jnp.asarray(g))

    grads = nnx.grad(loss)(jconv)
    named = nnx.clone(jconv)
    nnx.update(named, grads)
    want = np.asarray(named.kernel[...])
    tx = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords))
    out = tconv(tx)
    assert out.F.dtype is torch.bfloat16
    out.F.backward(_t(g))
    assert tconv.kernel.grad.dtype is torch.float32
    kmap = tconv._kernel_map(tx, out.coordinate_map_key)
    assert torch.equal(tconv.kernel.grad, conv_dw_reference(tx.F.bfloat16(), _t(g), kmap.in_idx))
    assert _rel(tconv.kernel.grad.numpy(), want) <= ULP


def test_dtypes_the_kernels_lack_raise():
    x, w = torch.zeros(4, 3), torch.zeros(2, 3, 5)
    idx = torch.zeros(2, 6, dtype=torch.int32)
    for feats, kernel in [(x.half(), w.half()), (x.half(), w), (x.bfloat16(), w.double()),
                          (x, w.bfloat16())]:
        with pytest.raises(TypeError):
            TF.sparse_conv(feats, kernel, idx, None)
    with pytest.raises(TypeError):
        conv_dw(x.bfloat16(), torch.zeros(6, 5), idx)  # g must match x
    assert TF.sparse_conv(x.bfloat16(), w.bfloat16(), idx, None).dtype is torch.bfloat16
