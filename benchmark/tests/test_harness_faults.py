"""A run with the timed path broken underneath comes out not correct: each fault that a cell can have (its
route's ``FAULTS``), planted in the port at a small size on the CPU (one card: no exchange between chips to
leave out)."""

import json

import pytest

from toy import CELLS, run_toy, toy_cell


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered", "frame_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_is_not_correct(monkeypatch, name, fault):
    cell = toy_cell(name)
    cell["route"].FAULTS[fault](monkeypatch.setattr, cell["cfg"])
    out = run_toy(name, cell=cell)
    assert not out["result"]["correct"], out["numbers"]
    json.dumps(out["result"], allow_nan=False)  # the line stays JSON whatever the fault made of the numbers
    if fault == "frame_altered":  # the frames compared are those the timed path handed to get_piv
        assert out["numbers"]["frames_gap"] >= 1, out["numbers"]
