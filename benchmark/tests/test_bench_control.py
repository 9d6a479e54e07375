"""The control -- the reference computed in bfloat16 in the program's
place -- comes out as not correct at the SE cells' own sizes (the
paired-end cell's replica needs the card: call it there with
``benchmark/control.py``)."""
import pytest

import check
import control
import run


@pytest.mark.parametrize("name", ["se_events.stock",
                                  "se_events.deep_summary"])
def test_the_bfloat16_control_fails_the_limits(name):
    cell = run.load_cell(name)
    for seed in (101, 2 ** 31 + 3):
        nums = control.control_numbers(cell, seed)
        assert not check.within(nums, cell["limits"]), nums
