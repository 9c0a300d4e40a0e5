"""The command itself: without a card it fails and prints no result; on a card (``-m cuda``) each cell runs
a short window from this checkout and prints its result line with ``correct`` true."""

import json
import subprocess
import sys

import pytest

from toy import CELLS, ROOT


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", str(2**33 + 5),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == "", out.stdout[-2000:]
    assert "CUDA" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_window_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", str(2**33 + 11),
                          "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and "setup_s" in line["metrics"]
    assert list(line)[-1] == "checks"
