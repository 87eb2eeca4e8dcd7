"""The plain reference agrees with the program on the CPU at small inputs
at full width; the program in a lower precision, and the reference in
TF32 put in the program's place, fail the comparison."""

import pytest
import torch

from small import SEED, cell, run

CELLS = ["minkunet34.train.scan5cm", "completionnet.train", "minkunet34.infer.room2cm"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, checks = run(name)
    assert result["correct"] is True, checks
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_bf16_program_fails(name):
    import minkowskiengine_tpu_torch as mt

    mt.set_compute_dtype(torch.bfloat16)
    try:
        result, checks = run(name)
    finally:
        mt.set_compute_dtype(None)
    assert result["correct"] is False, checks


@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_fails(name):
    from portbench.control import control_numbers

    c = cell(name)
    numbers = control_numbers(c, SEED, "tf32", torch.device("cpu"))
    assert any(numbers[k] > lim for k, lim in c["limits"].items()), numbers


def test_traced_run_keys():
    result, _ = run("minkunet34.train.scan5cm", trace=1, seconds=2.0)
    assert set(result) <= {"correct", "attempted", "failed", "metrics", "device", "breakdown",
                           "checks"}
    assert list(result)[-1] == "checks"
    # no device on the CPU: no device metric is reported
    assert not {"mfu.train", "conv_roofline.train", "device_idle_pct.train",
                "launches_per_step.train"} & set(result["metrics"])
