"""The port's self-contained examples (``examples/torch_*.py``) run on the CPU with their own checks,
as ``tests/test_examples.py`` runs the JAX package's."""

import os
import runpy
import sys

import pytest
import torch

import pyorc_tpu_torch

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)
    monkeypatch.setenv("PYORC_TPU_SHARD", "0")


def _run(script, *argv):
    old = sys.argv
    sys.argv = [script, *argv]
    try:
        return runpy.run_path(os.path.join(EXAMPLES, script), run_name="__main__")
    finally:
        sys.argv = old


def _main(script, *args):
    """The example's ``main`` called with ``args``; returns what it returns."""
    return runpy.run_path(os.path.join(EXAMPLES, script))["main"](*args)


def test_torch_demo(tmp_path, capsys):
    out = _main("torch_demo.py", str(tmp_path))
    assert "demo OK" in capsys.readouterr().out
    assert out["netcdf_written"] and 0 < out["v_measured"] < out["v_expected"]
    for name in ("piv_masked.nc", "transect.nc", "service/piv.nc", "service/piv_mask.nc",
                 "service/transect_transect_1.nc"):
        assert (tmp_path / name).is_file(), name
    ds = pyorc_tpu_torch.open_dataset(str(tmp_path / "transect.nc"))
    assert ds["river_flow"].values.shape == (5,)


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_torch_06_water_level(capsys):
    out = _main("torch_06_water_level_optical.py")
    assert "water level example OK" in capsys.readouterr().out
    assert abs(out["h_grid"] - 92.8) < 0.25 and abs(out["h_s2n"] - 92.8) < 0.25


def test_torch_07_stiv(capsys):
    _run("torch_07_stiv_velocimetry.py")
    assert "STIV example OK" in capsys.readouterr().out
