"""Port parity for the channelwise (depthwise) convolution and the two conv
Function shims.

``MinkowskiChannelwiseConvolution`` at D = 2 and 3, strides 1 and 2, with
and without bias: the same numpy coordinates, features, weights and output
gradient go through the JAX module and the port's; outputs, the input
gradient and the weight and bias gradients agree within rtol 1e-5 / atol
1e-5 (sums of at most 27 float32 products, in another order), and a
float64 ``gradcheck`` holds the port's backward.  The shims
``MinkowskiConvolutionFunction`` and ``MinkowskiConvolutionTransposeFunction``
must be bit-equal to the modules on the CPU (same map, same product), and
within 1e-5 of JAX's shims.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import minkowskiengine_tpu as ME
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.ops import functional as TF

RTOL, ATOL = 1e-5, 1e-5


def _cloud(D, seed=0, ch=5):
    rng = np.random.RandomState(seed)
    n = 60 if D == 2 else 150
    coords = np.unique(np.concatenate(
        [rng.randint(0, 2, (n, 1)), rng.randint(-5, 5, (n, D))], 1).astype(np.int32), axis=0)
    return coords, rng.randn(len(coords), ch).astype(np.float32)


def _jax_channelwise(jconv, coords, feats, g):
    jx = ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords))

    def apply(m, fe):
        return m(ME.SparseTensor(fe, coordinate_map_key=jx.coordinate_map_key,
                                 coordinate_manager=jx.coordinate_manager))

    y = apply(jconv, jnp.asarray(feats))
    d_feats = jax.grad(lambda fe: (apply(jconv, fe).F * g).sum())(jnp.asarray(feats))
    d_mod = nnx.grad(lambda m: (apply(m, jnp.asarray(feats)).F * g).sum())(jconv)
    return y, d_feats, d_mod


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("D", [2, 3])
def test_channelwise_matches_jax(D, stride, bias):
    coords, feats = _cloud(D, seed=D * 10 + stride)
    jconv = ME.MinkowskiChannelwiseConvolution(5, kernel_size=3, stride=stride, bias=bias,
                                              dimension=D, rngs=nnx.Rngs(0))
    tconv = MT.MinkowskiChannelwiseConvolution(5, kernel_size=3, stride=stride, bias=bias,
                                              dimension=D, device="cpu")
    assert tconv.kernel.shape == (3**D, 5)
    assert tconv.kernel.abs().max() <= 1 / np.sqrt(5 * 3**D)
    sd = {"kernel": np.asarray(jconv.kernel[...])}
    if bias:
        sd["bias"] = np.asarray(jconv.bias[...])
    MT.utils.load_state_dict_from_reference(tconv, sd)
    n_out = ME.MinkowskiChannelwiseConvolution(5, kernel_size=3, stride=stride, dimension=D)(
        ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords))).F.shape[0]
    g = np.random.RandomState(1).randn(n_out, 5).astype(np.float32)

    want, want_dx, want_dmod = _jax_channelwise(jconv, coords, feats, g)
    tf = torch.from_numpy(feats).requires_grad_()
    out = tconv(MT.SparseTensor(tf, torch.from_numpy(coords), device="cpu"))
    out.F.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.C.numpy(), np.asarray(want.C))
    assert out.tensor_stride == (stride,) * D
    np.testing.assert_allclose(out.F.detach().numpy(), np.asarray(want.F), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_dx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tconv.kernel.grad.numpy(), np.asarray(want_dmod.kernel[...]),
                               rtol=RTOL, atol=ATOL)
    if bias:
        np.testing.assert_allclose(tconv.bias.grad.numpy(), np.asarray(want_dmod.bias[...]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("D", [2, 3])
def test_channelwise_gradcheck_float64(D):
    coords, feats = _cloud(D, seed=7, ch=3)
    mgr = MT.CoordinateManager(D=D, device="cpu")
    key, _ = mgr.insert_and_map(torch.from_numpy(coords))
    out_key = mgr.stride(key, 2)
    kmap = mgr.kernel_map(key, out_key, stride=2, kernel_size=3)
    w = torch.randn(3**D, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(feats)
    assert MT.utils.gradcheck(lambda f, k: TF.channelwise_conv(f, k, kmap.in_idx), (x, w))


def test_channelwise_explicit_output_coordinates():
    coords, feats = _cloud(2, seed=3)
    tconv = MT.MinkowskiChannelwiseConvolution(5, kernel_size=3, dimension=2, device="cpu")
    x = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords), device="cpu")
    y = tconv(x, coordinates=x.coordinate_map_key)
    assert y.coordinate_map_key == x.coordinate_map_key and y.F.shape == x.F.shape
    # an offset slot with no input row adds nothing: one isolated voxel
    # gets only the centre weight
    single = MT.SparseTensor(torch.ones(1, 5), torch.tensor([[0, 0, 0]], dtype=torch.int32),
                             device="cpu")
    torch.testing.assert_close(tconv(single).F[0], tconv.kernel[4].detach(), rtol=0, atol=0)


def _shim_inputs(seed, D=3):
    coords, feats = _cloud(D, seed=seed, ch=4)
    return coords, feats


@pytest.mark.parametrize("transpose", [False, True], ids=["conv", "transpose"])
def test_conv_function_shims_equal_the_modules(transpose):
    coords, feats = _shim_inputs(5)
    gen = torch.Generator().manual_seed(0)
    x = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords), device="cpu")
    if transpose:
        down = MT.MinkowskiConvolution(4, 4, kernel_size=2, stride=2, dimension=3,
                                       generator=gen, device="cpu")
        x = down(x)
        x = MT.SparseTensor(x.F.detach(), coordinate_map_key=x.coordinate_map_key,
                            coordinate_manager=x.coordinate_manager)
        conv = MT.MinkowskiConvolutionTranspose(4, 6, kernel_size=2, stride=2, dimension=3,
                                                generator=gen, device="cpu")
        shim = MT.MinkowskiConvolutionTransposeFunction
    else:
        conv = MT.MinkowskiConvolution(4, 6, kernel_size=3, stride=2, dimension=3,
                                       generator=gen, device="cpu")
        shim = MT.MinkowskiConvolutionFunction
    xf = x.F.clone().requires_grad_()
    y = conv(MT.SparseTensor(xf, coordinate_map_key=x.coordinate_map_key,
                             coordinate_manager=x.coordinate_manager))
    g = torch.randn(y.F.shape, generator=gen)
    y.F.backward(g)
    d_x, d_w = xf.grad.clone(), conv.kernel.grad.clone()
    xf.grad = None
    conv.kernel.grad = None
    out = shim.apply(xf, conv.kernel, conv.kernel_generator, MT.ConvolutionMode.DEFAULT,
                     x.coordinate_map_key, y.coordinate_map_key, x.coordinate_manager)
    out.backward(g)
    assert torch.equal(out, y.F)
    assert torch.equal(xf.grad, d_x) and torch.equal(conv.kernel.grad, d_w)


@pytest.mark.parametrize("transpose", [False, True], ids=["conv", "transpose"])
def test_conv_function_shims_match_jax(transpose):
    coords, feats = _shim_inputs(6)
    rng = np.random.RandomState(2)
    jm, tm = ME.CoordinateManager(D=3), MT.CoordinateManager(D=3, device="cpu")
    jk, _ = jm.insert_and_map(coords)
    tk, _ = tm.insert_and_map(torch.from_numpy(coords))
    jo, to = jm.stride(jk, 2), tm.stride(tk, 2)
    kg_args = dict(kernel_size=2, stride=2, dimension=3)
    if transpose:
        jkg = ME.KernelGenerator(is_transpose=True, **kg_args)
        tkg = MT.KernelGenerator(is_transpose=True, **kg_args)
        src_j, dst_j, src_t, dst_t = jo, jk, to, tk
        n_src = tm.size(to)
        jshim, tshim = ME.MinkowskiConvolutionTransposeFunction, MT.MinkowskiConvolutionTransposeFunction
    else:
        jkg, tkg = ME.KernelGenerator(**kg_args), MT.KernelGenerator(**kg_args)
        src_j, dst_j, src_t, dst_t = jk, jo, tk, to
        n_src = len(coords)
        jshim, tshim = ME.MinkowskiConvolutionFunction, MT.MinkowskiConvolutionFunction
    f = rng.randn(n_src, 4).astype(np.float32)
    w = rng.randn(8, 4, 3).astype(np.float32)
    cap = jm.capacity(src_j)
    fpad = np.zeros((cap, 4), np.float32)
    fpad[:n_src] = f
    want = jshim.apply(jnp.asarray(fpad), jnp.asarray(w), jkg, None, src_j, dst_j, jm)
    got = tshim.apply(torch.from_numpy(f), torch.from_numpy(w), tkg, None, src_t, dst_t, tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[: tm.size(dst_t)], rtol=RTOL, atol=ATOL)
