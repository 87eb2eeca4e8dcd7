"""The dense bbox grid on the card: maps built through the row grids
(``coords/grid.py``) equal the CPU's.

These tests need an NVIDIA GPU; elsewhere they skip.  Run them on the card
with ``python -m pytest --noconftest tests/test_torch_grid_cuda.py``.
Maps are compared index for index (interpolation weights within 1e-6).
"""

import numpy as np
import pytest
import torch

import minkowskiengine_tpu_torch as MT

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def cloud(seed, n=6000, hi=48):
    rng = np.random.RandomState(seed)
    c = np.concatenate([rng.randint(0, 2, (n, 1)), rng.randint(-hi, hi, (n, 3))], 1)
    return torch.from_numpy(np.unique(c.astype(np.int32), axis=0))


def maps(c, device):
    mgr = MT.CoordinateManager(D=3, device=device)
    k1, _ = mgr.insert_and_map(c)
    k2 = mgr.stride(k1, 2)
    out = [mgr.kernel_map(k1, k1, kernel_size=5), mgr.kernel_map(k1, k2, stride=2, kernel_size=2),
           mgr.kernel_map(k2, k2, kernel_size=3),
           mgr.kernel_map(k2, k1, stride=2, kernel_size=2, is_transpose=True)]
    idx = [t for km in out for t in (km.in_idx, km.out_idx_t)]
    idx.append(mgr.stride_map(k1, k2))
    samples = c.float()[:500] + 0.37
    idx += list(mgr.interpolation_map_weight(k2, samples))
    return mgr, idx


def test_probe_maps_on_the_card_equal_the_cpu(dev):
    c = cloud(0)
    mgr, got = maps(c.to(dev), dev)
    assert mgr._row_grids
    _, want = maps(c, "cpu")
    for g, w in zip(got[:-1], want[:-1]):
        assert torch.equal(g.cpu(), w)
    # the interpolation weights: products of float32 fractions, which the
    # card may contract into FMAs; within 1e-6, chip_smoke.py's SPLAT_RTOL
    torch.testing.assert_close(got[-1].cpu(), want[-1], rtol=0, atol=1e-6)
