"""The PTv3 cell at a size a CPU test run can hold: the published widths and
window size on two small rooms (about 1,500 voxels each, so that the first
level cuts each scene into two overlapping windows and the coarser levels
hold fewer rows than a window).  A sound run is correct; a run with the
timed path broken underneath is not, once for each fault; the reference in
TF32 put in the program's place fails at least one limit.  ``small.py``'s
table has no entry for this kind, so the sizes are set here."""

import pytest
import torch

from small import SEED, harness

NAME = "ptv3.train.room2cm"
SMALL = dict(pool=2, n_points=8000, extent=[2.0, 2.0, 2.2], n_objects=2, voxel_size=0.05,
             batch=2, crop=1500)


def cell():
    c = harness.load_cell(NAME)
    c["traffic"].update(SMALL)
    return c


def run(fault=None):
    import time

    import minkowskiengine_tpu_torch as mt

    return harness.run_cell(cell(), SEED, 1.0, 0, "cpu", time.perf_counter(), harness.benchmark(),
                            mt, fault=fault)[:2]


def test_sound_run_is_correct():
    result, checks = run()
    assert result["correct"] is True, checks
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_faults_are_not_correct(fault):
    result, checks = run(fault)
    assert result["correct"] is False, checks


def test_tf32_control_fails():
    from portbench.control import control_numbers

    c = cell()
    numbers = control_numbers(c, SEED, "tf32", torch.device("cpu"))
    assert any(numbers[k] > lim for k, lim in c["limits"].items()), numbers


def test_attention_reader_gives_nothing_for_a_cut_list():
    read = harness.reader("attn_device_ms.train")
    fwd, bwd = ["fmha_cutlassF_f32_aligned_64x64_rf_sm80(...)", 0.3], ["fmha_cutlassB_f32(...)", 0.6]
    other = [[f"kernel{i}", 0.01] for i in range(8)]
    summary = dict(role="train", profiled_steps=3)
    # the whole list, both kernels in it: their sum per step
    summary["breakdown"] = {"device_ops": [bwd, fwd] + other}
    assert read(summary) == pytest.approx(300.0)
    # a full list that lacks one of them: the part cut away is unknown
    summary["breakdown"] = {"device_ops": [fwd] + other + [["kernel8", 0.01]]}
    assert read(summary) is None
    # a list shorter than the cut holds every operation
    summary["breakdown"] = {"device_ops": [fwd] + other[:3]}
    assert read(summary) == pytest.approx(100.0)
    # other kernels named for attention are not the fused kernels
    summary["breakdown"] = {"device_ops": [["my_attention_kernel", 0.5]] + other[:3]}
    assert read(summary) is None
