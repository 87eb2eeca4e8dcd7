"""K1 and K2 on the parallel package's maps, on the card.

The spatial conv hands K1 a window of ``B + 2·halo`` rows and the block's
columns of ``in_idx`` re-based to it (``parallel.spatial._rebase``: -1
outside the window), and K2 the same window with the block's rows of G;
tensor parallelism hands K1 a Cout slice of W (32 of 64, 48 of 96: K1's
Cout tile is 64, so a slice pads) and K2 a column slice of G.  Each call
is held to its plain version on the same CUDA inputs (K1 within 1e-5 of
max|ref|, K2 within 1e-4, as ``chip_smoke.py`` judges them) and, for the
windows, to the same rows of the call on the whole map.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  Run them on
the card with ``python -m pytest --noconftest tests/test_torch_parallel_cuda.py``.
"""

import pytest
import torch

import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.kernels.conv_dw import conv_dw, conv_dw_reference
from minkowskiengine_tpu_torch.kernels.gather_gemm import gather_gemm, gather_gemm_reference
from minkowskiengine_tpu_torch.parallel.spatial import _rebase, block_bounds, required_halo
from minkowskiengine_tpu_torch.utils.datasets import room_scan_voxels

pytestmark = pytest.mark.cuda

K1_RTOL, K2_RTOL = 1e-5, 1e-4


def _rel(got, want):
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


@pytest.fixture(scope="module")
def maps():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    coords, _ = room_scan_voxels(voxel_size=0.05, n_points=60_000, extent=(2.0, 2.0, 2.2),
                                 n_objects=4, seed=0)
    mgr = MT.CoordinateManager(D=3, device=dev)
    key, _ = mgr.insert_and_map(torch.from_numpy(coords).to(dev))
    key2 = mgr.stride(key, 2)
    return dev, {
        "k3": mgr.kernel_map(key, key, kernel_size=3),
        "k2s2": mgr.kernel_map(key, key2, kernel_size=2, stride=2),
        "k2s2_transposed": mgr.kernel_map(key, key2, kernel_size=2, stride=2).swap(),
    }


def _window(x, lo, hi, halo):
    """Rows lo - halo .. hi + halo of x, zeros past either end."""
    pad = x.new_zeros((halo, x.shape[1]))
    return torch.cat([pad, x, pad])[lo:hi + 2 * halo]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["k3", "k2s2", "k2s2_transposed"])
def test_k1_and_k2_on_a_rebased_window(maps, name, n):
    dev, kmaps = maps
    km = kmaps[name]
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(km.n_in, 64, device=dev, generator=gen)
    w = torch.randn(km.kernel_volume, 64, 96, device=dev, generator=gen)
    g = torch.randn(km.n_out, 96, device=dev, generator=gen)
    whole = gather_gemm(x, w, km.in_idx)
    halo, _ = required_halo(km, n)
    for r in range(n):
        lo, hi = block_bounds(km.n_in, n, r)
        o_lo, o_hi = block_bounds(km.n_out, n, r)
        win = _window(x, lo, hi, halo)
        idx, dropped = _rebase(km.in_idx[:, o_lo:o_hi], lo - halo, win.shape[0])
        assert int(dropped) == 0 and idx.is_contiguous() and idx.dtype == torch.int32
        out = gather_gemm(win, w, idx)
        assert _rel(out, gather_gemm_reference(win, w, idx)) <= K1_RTOL
        assert _rel(out, whole[o_lo:o_hi]) <= K1_RTOL
        g_blk = g[o_lo:o_hi].contiguous()
        dw = conv_dw(win, g_blk, idx)
        assert _rel(dw, conv_dw_reference(win, g_blk, idx)) <= K2_RTOL


@pytest.mark.parametrize("cout, width", [(64, 32), (96, 48)])
def test_k1_and_k2_on_column_slices(maps, cout, width):
    dev, kmaps = maps
    km = kmaps["k3"]
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(km.n_in, 64, device=dev, generator=gen)
    w = torch.randn(km.kernel_volume, 64, cout, device=dev, generator=gen)
    g = torch.randn(km.n_out, cout, device=dev, generator=gen)
    whole = gather_gemm(x, w, km.in_idx)
    for lo in range(0, cout, width):
        w_s = w[:, :, lo:lo + width].contiguous()
        out = gather_gemm(x, w_s, km.in_idx)
        assert _rel(out, gather_gemm_reference(x, w_s, km.in_idx)) <= K1_RTOL
        assert _rel(out, whole[:, lo:lo + width]) <= K1_RTOL
        g_s = g[:, lo:lo + width].contiguous()
        assert _rel(conv_dw(x, g_s, km.in_idx), conv_dw_reference(x, g_s, km.in_idx)) <= K2_RTOL
        # the input gradient's share of this slice: K1 on out_idx_t with W[:, :, slice]ᵀ
        dx = gather_gemm(g_s, w_s.transpose(1, 2).contiguous(), km.out_idx_t)
        ref = gather_gemm_reference(g_s, w_s.transpose(1, 2).contiguous(), km.out_idx_t)
        assert _rel(dx, ref) <= K1_RTOL
