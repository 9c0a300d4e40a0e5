"""The open multipass fault (ROADMAP.md, queue C), bounded: on chip_smoke's
texture multipass PIV reads one velocity component a few per cent low and the
other high. The bias belongs to the displacement's size, not to an axis."""

import numpy as np
import pytest
import torch

import pyorc_tpu_torch

import chip_smoke

H_IMG, W_IMG, N_FRAMES = 480, 640, 10


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)


@pytest.mark.parametrize(
    "shift", [(2.3, -1.4), (-1.4, 2.3), (-2.3, 1.4)], ids=["as-shipped", "components-swapped", "signs-flipped"]
)
def test_multipass_bias_follows_the_displacement_not_the_axis(monkeypatch, shift):
    """get_piv(window_size=25, passes=3) on the slice's stack with the per-frame shift as
    shipped, with its components swapped, and with its signs flipped. The 2.3 px component
    reads 1-3 % high and the 1.4 px component 2-4 % low (about +-0.04 px) whichever axis
    carries it and whatever its sign: neither the row paths of the deformation nor the
    y-flipped grid single out v_y. The JAX package gives the same medians (its cascade is
    held to the port's in tests/test_torch_multipass.py)."""
    monkeypatch.setattr(chip_smoke, "SHIFT", shift)
    cc = chip_smoke.nadir_camera_config(H_IMG, W_IMG)
    stack = chip_smoke.advected_stack(H_IMG, W_IMG, N_FRAMES, "cpu")
    proj = chip_smoke.frames_dataarray(stack, cc).frames.normalize(samples=15).frames.project()
    piv = proj.frames.get_piv(window_size=25, overlap=(13, 13), passes=3)
    truth = dict(zip(("v_x", "v_y"), chip_smoke.expected_velocity(cc)))
    rel = {name: float(np.nanmedian(piv[name].values)) / truth[name] - 1 for name in truth}
    large, small = ("v_x", "v_y") if abs(shift[0]) > abs(shift[1]) else ("v_y", "v_x")
    assert 0.01 < rel[large] < 0.03, rel
    assert -0.04 < rel[small] < -0.02, rel
