"""``tools/profile_request.py``: its interval union, and its refusal to run
without a CUDA device."""

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
