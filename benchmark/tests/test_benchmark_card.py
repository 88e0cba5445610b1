"""On the card: one request of each mix, the sound answers correct and the
control (the same answers at TF32 precision, with the program's claims and
with the claims worked out again) not correct.  The full-size control over
three seeds is ``control.py``."""

import pytest

import run
from control import honest, judge, rounded
from harness import check
from harness.spec import reference
from tiny import any_cell


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["s10_batch", "g7_replan", "g7_batch",
                                      "s10_sweep"])
def test_control_is_not_correct(card, workload):
    cell = any_cell(workload)
    result, rec = run.run_cell(cell, 2 ** 31 + 101, 0.0, False, card)
    assert result["correct"] is True, result["check"]
    ref = reference(cell)
    low = rounded(rec["requests"])
    for reqs in (low, honest(cell, ref, low)):
        numbers = judge(cell, ref, rec, reqs, card)
        assert check.verdict(numbers, cell.checks)[0] is False, numbers
