"""The cells at sizes a CPU test run can hold: the same configurations at
their full widths, on fewer and smaller rooms or shapes."""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness  # noqa: E402

SEED = 2**31 + 12345  # above 32 signed bits, as a driver's seeds are
SMALL = {
    "seg_train": dict(pool=2, n_points=8000, extent=[2.0, 2.0, 2.2], n_objects=2,
                      voxel_size=0.05, shift=8),
    "seg_infer": dict(pool=2, n_points=6000, extent=[2.0, 2.0, 2.2], n_objects=2,
                      voxel_size=0.05, shift=0.3, sample=2),
    "completion_train": dict(shapes=2, resolution=32, n_points=50000, shift=4),
}


def cell(name):
    c = harness.load_cell(name)
    c["traffic"].update(SMALL[c["kind"]])
    return c


def run(name, fault=None, trace=0, seconds=1.0):
    """One run of the small cell on the CPU, the look for a card skipped."""
    import minkowskiengine_tpu_torch as mt

    t0 = time.perf_counter()
    return harness.run_cell(cell(name), SEED, seconds, trace, "cpu", t0, harness.benchmark(), mt,
                            fault=fault)[:2]
