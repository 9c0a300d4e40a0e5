"""The port's benchmark scripts (``bench_torch.py``, ``bench_e2e_torch.py``) on the CPU at tiny
sizes: each prints one JSON line with the keys its docstring names, the plain versions run
where the card's kernels would, and no number is named as a card's."""

import json

import numpy as np
import pytest
import torch

import pyorc_tpu_torch

import bench_e2e_torch
import bench_torch


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)
    monkeypatch.setenv("PYORC_TPU_SHARD", "0")


def _line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_bench_torch_full_and_chain(capsys):
    assert bench_torch.main(["--device", "cpu", "--height", "96", "--width", "160", "--frames", "5", "--reps", "2",
                             "--full", "--chain", "--chain-size", "384x216"]) == 0
    out = _line(capsys)
    assert out["metric"] == bench_torch.METRIC + "_cpu_rehearsal" and out["unit"] == "pairs/s"
    assert out["card"].startswith("not measured") and out["timing"] == "host clock" and out["route"] == "plain_cpu"
    for key in ("value", "best", "ms_median", "ms_min", "plain_pairs_per_sec", "bound_ms"):
        assert out[key] > 0, key
    assert out["bound_by"] in ("operations", "bytes") and out["bound_share"] is None
    assert "vs_baseline" not in out and "fp32_tflops" not in out  # the TPU's figures
    assert set(out["configs"]) == {"16px_1080p", "26px_1080p", "32px_1080p"}
    assert set(out["ensemble"]) == {"16px_1080p", "26px_1080p", "32px_1080p", "64px_1080p"}
    assert {row["route"] for row in out["ensemble"].values()} == {"plain_cpu"}
    assert set(out["parity_px"]) == {"16px", "26px", "32px"}
    for row in out["parity_px"].values():  # the plain version against itself on the CPU
        assert set(row) >= {"q95", "max", "frac_gt_0.5px", "cond_max"} and row["max"] == 0.0
    assert out["chain_4k"]["projected"] == [156, 324] and out["chain_4k_pairs_per_sec"] > 0


def test_bench_torch_bound_is_the_smoke_runs():
    """One definition of the kernels' bound: chip_smoke.py's is the port's."""
    import chip_smoke
    from pyorc_tpu_torch.ops import roofline

    frames = torch.zeros((9, 1088, 1920), dtype=torch.uint8)
    args = bench_torch._grid(1088, 1920, 16)
    assert chip_smoke.pairs_bound(frames, args) == roofline.pairs_bound(frames, args)
    assert chip_smoke.ensemble_bound(frames, args) == roofline.ensemble_bound(frames, args)
    assert roofline.pairs_bound(frames, args)[1] == "operations"


def test_bench_e2e_torch_tiny(capsys):
    assert bench_e2e_torch.main(["--device", "cpu", "--seconds", "0.5", "--size", "768x432", "--samples", "15"]) == 0
    out = _line(capsys)
    assert out["metric"] == "e2e_768x432_0.5s_single_chip_seconds_cpu_rehearsal" and out["unit"] == "s"
    assert out["card"].startswith("not measured") and out["route"] == "plain_cpu" and out["correct"] is True
    assert set(out["stages_s"]) == {"video_open", "lazy_chain_setup", "decode_ortho_piv", "transect_discharge"}
    assert abs(out["value"] - sum(out["stages_s"].values())) < 1e-9
    assert abs(out["surface_speed_rel_err"]) <= bench_e2e_torch.SPEED_RTOL
    assert np.isclose(out["surface_speed_truth_m_s"], np.hypot(1.8, 0.9) * 0.01 * 30)
    assert out["n_frames"] == 15 and out["upload_gb"] > 0 and np.isfinite(out["river_flow_m3s_median"])
    assert "vs_baseline" not in out and "est_v5e8_seconds_extrapolated" not in out


def test_bench_e2e_torch_nadir_config_is_bench_e2e_s():
    """The 4K default is bench_e2e.nadir_config's camera, point for point."""
    import pyorc_tpu
    from bench_e2e import nadir_config

    want, got = nadir_config(), bench_e2e_torch.nadir_config()
    assert got.gcps == want.gcps and (got.height, got.width, got.resolution) == (want.height, want.width, want.resolution)
    np.testing.assert_array_equal(np.asarray(got.camera_matrix), np.asarray(want.camera_matrix))
    np.testing.assert_allclose(np.asarray(got.bbox.exterior.coords), np.asarray(want.bbox.exterior.coords))
    assert isinstance(want, pyorc_tpu.CameraConfig)

