"""A run with the timed path broken underneath comes out not correct:
once for each fault the cell can have.  On the CPU, at the small sizes of
``small.py``, the look for a card skipped."""

import pytest

from small import run

TRAINING = ["minkunet34.train.scan5cm", "completionnet.train"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("name", TRAINING)
def test_training_faults_are_not_correct(name, fault):
    result, checks = run(name, fault=fault)
    assert result["correct"] is False, checks


def test_an_altered_answer_is_not_correct():
    result, checks = run("minkunet34.infer.room2cm", fault="altered")
    assert result["correct"] is False, checks
