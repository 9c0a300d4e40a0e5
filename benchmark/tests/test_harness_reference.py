"""At a small size on the CPU the plain reference agrees with the port's plain route within the cells'
limits, and the reference in bfloat16 in the program's place (the control) fails them."""

import math

import pytest

from toy import CELLS, run_toy, toy_cell


@pytest.mark.parametrize("name", CELLS)
def test_the_port_agrees_with_the_reference(name):
    out = run_toy(name)
    assert out["result"]["correct"], out["numbers"]
    assert out["numbers"]["frames_gap"] == 0
    assert out["info"]["videos"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    cell = toy_cell(name)
    out = run_toy(name, program=cell["route"].control_program(), cell=cell)
    assert not out["result"]["correct"], out["numbers"]
    limits = {k: c["limit"] for k, c in out["result"]["checks"].items()}
    failed = [k for k, v in out["numbers"].items() if not (math.isfinite(v) and v <= limits[k])]
    assert failed
