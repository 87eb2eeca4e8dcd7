"""``tools/profile_request.py``: its interval union, its refusal to run
without a CUDA device, and its host clock over the port's counters."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TOOL = ROOT / "tools" / "profile_request.py"


def _load():
    spec = importlib.util.spec_from_file_location("profile_request", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize(
    "intervals, expected",
    [
        ([], 0.0),
        ([(0.0, 2.0), (3.0, 4.0)], 3.0),  # disjoint
        ([(0.0, 2.0), (1.0, 4.0)], 4.0),  # overlapping
        ([(0.0, 5.0), (1.0, 2.0), (3.0, 4.0)], 5.0),  # nested
        ([(3.0, 4.0), (0.0, 1.0), (0.5, 3.5)], 4.0),  # unsorted chain
    ],
)
def test_busy_us_is_the_union_length(intervals, expected):
    assert _load().busy_us(iter(intervals)) == pytest.approx(expected)


def test_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would run for real")
    proc = subprocess.run(
        [sys.executable, str(TOOL)], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "voxels" not in proc.stdout


def test_host_clock_times_the_coordinate_calls_and_keep_any_syncs():
    """On a narrow CompletionNet on the CPU, read from the port's counters:
    one timed ``keep.any()`` per decoder level, time inside the manager's
    calls, and neither the manager nor ``Tensor.__bool__`` patched."""
    import minkowskiengine_tpu_torch as MT
    from minkowskiengine_tpu_torch.models import CompletionNet
    from minkowskiengine_tpu_torch.utils.datasets import completion_batch

    tool = _load()
    partial, feats, full = completion_batch(2, 16, seed=0, n_points=2000)
    net = CompletionNet(resolution=16, enc_channels=(4, 8, 8), dec_channels=(4, 8, 8), device="cpu")
    saved = MT.CoordinateManager.kernel_map, torch.Tensor.__bool__
    with tool.HostClock() as clock:
        assert (MT.CoordinateManager.kernel_map, torch.Tensor.__bool__) == saved
        mgr = MT.CoordinateManager(D=3, device="cpu")
        x = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(partial), coordinate_manager=mgr)
        target, _ = mgr.insert_and_map(torch.from_numpy(full), 1)
        out_cls, _, _ = net(x, target)
        assert bool(torch.tensor(True))  # a sync outside the level loop is not counted
    assert clock.keep_any_n == len(out_cls) == 2
    assert clock.coordinate_s > 0 and clock.keep_any_s >= 0
    assert (MT.CoordinateManager.kernel_map, torch.Tensor.__bool__) == saved
