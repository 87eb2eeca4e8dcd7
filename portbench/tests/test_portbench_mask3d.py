"""The Mask3D cell at a size a CPU test run can hold: the published widths,
queries and sample sizes on two small rooms at 10 cm (about 1,800 voxels
each, so that every level's scene holds fewer rows than its sample and is
padded).  A sound run is correct; a run with the timed path broken
underneath is not, once for each fault; the reference in TF32 put in the
program's place fails at least one limit.  ``small.py``'s table has no
entry for this kind, so the sizes are set here."""

import numpy as np
import pytest
import torch

from small import SEED, harness

NAME = "mask3d.train.room2cm"
SMALL = dict(pool=2, n_points=8000, extent=[2.0, 2.0, 2.2], n_objects=3, voxel_size=0.1,
             batch=2, shift=8)


def cell():
    c = harness.load_cell(NAME)
    c["traffic"].update(SMALL)
    return c


def run(fault=None):
    import time

    import minkowskiengine_tpu_torch as mt

    return harness.run_cell(cell(), SEED, 1.0, 0, "cpu", time.perf_counter(), harness.benchmark(),
                            mt, fault=fault)[:2]


def test_the_room_replays_the_frozen_generator():
    from portbench.traffic import data
    from portbench.traffic.mask3d_train import room_with_faces

    pts, face = room_with_faces(5000, (2.0, 2.0, 2.2), 3, 7)
    assert np.array_equal(pts, data.make_room_scan(5000, extent=(2.0, 2.0, 2.2), n_objects=3,
                                                   seed=7))
    assert face.min() >= 0 and face.max() < 6 + 5 * 3


def test_sound_run_is_correct():
    result, checks = run()
    assert result["correct"] is True, checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert dict((k, v) for k, v, _ in checks)["fps_mismatch"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_faults_are_not_correct(fault):
    result, checks = run(fault)
    assert result["correct"] is False, checks


def test_tf32_control_fails():
    from portbench.control import control_numbers

    c = cell()
    numbers = control_numbers(c, SEED, "tf32", torch.device("cpu"))
    assert any(numbers[k] > lim for k, lim in c["limits"].items()), numbers


@pytest.mark.parametrize("metric,label", [("decoder_idle_ms.train", "decoder"),
                                          ("match_idle_ms.train", "match")])
def test_idle_readers_give_nothing_for_a_cut_list(metric, label):
    read = harness.reader(metric)
    other = [[f"label{i}", 0.01] for i in range(9)]
    summary = dict(role="train", profiled_steps=3)
    summary["breakdown"] = {"idle_gaps": [[label, 0.3]] + other}
    assert read(summary) == pytest.approx(100.0)
    # a full list that lacks the label: the part cut away is unknown
    summary["breakdown"] = {"idle_gaps": other + [["label9", 0.01]]}
    assert read(summary) is None
    # a list shorter than the cut holds every label: none left idle
    summary["breakdown"] = {"idle_gaps": other[:3]}
    assert read(summary) == 0.0
    summary["breakdown"] = None
    assert read(summary) is None
