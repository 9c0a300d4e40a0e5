"""The port runs without JAX, the JAX package, OpenCV, h5py, tqdm, click, yaml
or matplotlib (the GPU machine lacks h5py and matplotlib, and the port must
not lean on the others). Without a decoder the lazy frame chain is driven from
a host frame source, and ``Video`` says that it needs cv2."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import pyorc_tpu_torch
from pyorc_tpu_torch import _device

ROOT = Path(__file__).resolve().parents[1]
ABSENT = ("jax", "jaxlib", "cv2", "h5py", "tqdm", "click", "yaml", "matplotlib")


def test_slice_runs_without_jax_and_host_libraries():
    script = textwrap.dedent(
        f"""
        import sys
        for name in {ABSENT!r}:
            sys.modules[name] = None  # any import of these raises ImportError
        import torch
        torch.set_num_threads(2)
        import pyorc_tpu_torch
        import chip_smoke
        from pyorc_tpu_torch.ops import piv_kernels

        stack = chip_smoke.advected_stack(480, 640, 12, "cpu")
        results, _, proj, pivs = chip_smoke.slice_phase(480, 640, 12, "cpu", stack=stack)
        assert set(results) == {{16, 26}}, results
        assert piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] == "plain_cpu"
        results, _, rows, _ = chip_smoke.lazy_phase(stack, chip_smoke.nadir_camera_config(480, 640), pivs, "cpu")
        assert set(results) == {{16, 26}}, results
        assert all(d == 0.0 for r in results.values() for d in r["max_abs_diff_vs_in_memory"].values()), results
        assert rows["get_piv[lazy 16px]"]["h2d"] == stack.nbytes, rows
        probe = chip_smoke.decoder_probe()
        assert set(probe) == {{"cv2", "native_compiler", "native_decoder", "libnvcuvid", "libavcodec"}}, probe
        assert probe["cv2"].startswith("absent"), probe
        try:
            pyorc_tpu_torch.Video("clip.mp4")
        except ImportError as err:
            assert "cv2" in str(err), err
        else:
            raise AssertionError("Video opened a file without cv2")
        results, *_ = chip_smoke.multipass_phase(proj[:6], 480, 640)
        assert set(results) == {{32, 26}}, results
        results, _ = chip_smoke.filters_phase(proj, 480, 640, "cpu")
        assert set(results) == {{"smooth", "edge_detect", "minmax", "time_diff", "reduce_rolling", "range",
                                "project[rgb]"}}, results
        assert pyorc_tpu_torch.get_device().type == "cpu"
        results, _ = chip_smoke.stiv_phase(proj, 480, 640, n_lines=(2, 3))
        assert set(results) >= {{"along", "against", "profile"}}, results
        try:
            proj.frames.get_piv(window_size=16)[["v_x"]].to_netcdf("never_written.nc")
        except ImportError as err:
            assert "h5py" in str(err), err
        else:
            raise AssertionError("to_netcdf wrote a file without h5py")
        camera = {{"f": 1000.0, "gcp_px": 60, "aoi_px": 100}}
        stack = chip_smoke.advected_stack(480, 640, 8, "cpu")
        results, _, _, piv = chip_smoke.ensemble_slice_phase(480, 640, 8, "cpu", camera=camera, stack=stack)
        assert piv_kernels.KERNEL_ROUTE["piv_ensemble_fused"] == "plain_cpu"
        cc = chip_smoke.nadir_camera_config(480, 640, window_size=chip_smoke.ENS_WINDOW, **camera)
        results, _, _, lazy_proj = chip_smoke.lazy_phase(
            stack, cc, {{chip_smoke.ENS_WINDOW: piv}}, "cpu", fps=chip_smoke.ENS_FPS, ensemble=True, aoi_px=100,
            tag="lazy ens",
        )
        assert set(results) == {{chip_smoke.ENS_WINDOW}}, results
        designs = chip_smoke.upload_designs(stack, "cpu", port=lazy_proj.data, chunk=3, camera=camera)
        up = {{name: d["uploaded_bytes"] for name, d in designs.items()}}
        assert up["device_extrema"] == stack.nbytes > up["host_extrema_crop"], up
        leaked = sorted(m for m in sys.modules if m == "pyorc_tpu" or m.startswith("pyorc_tpu."))
        assert not leaked, leaked
        print("SLICE_OK")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SLICE_OK" in proc.stdout


def test_no_module_imports_jax_or_the_jax_package():
    """Source check: no module of the port, and not chip_smoke.py, imports jax or pyorc_tpu."""
    offenders = []
    for path in [*sorted((ROOT / "pyorc_tpu_torch").rglob("*.py")), ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.strip().replace(",", " ").split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0]
                if root in ("jax", "jaxlib", "pyorc_tpu"):
                    offenders.append(f"{path.relative_to(ROOT)}: {line.strip()}")
    assert not offenders, offenders


def test_device_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    """No quiet CPU fallback: without CUDA and without set_device('cpu'), device use raises."""
    monkeypatch.setattr(_device, "_device", None)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="set_device"):
        pyorc_tpu_torch.get_device()
    pyorc_tpu_torch.set_device("cpu")
    assert pyorc_tpu_torch.get_device().type == "cpu"


@pytest.mark.parametrize(
    "stack,call",
    [
        ("gray", lambda f: f.smooth()),
        ("gray", lambda f: f.edge_detect()),
        ("gray", lambda f: f.minmax(min=10.0)),
        ("gray", lambda f: f.time_diff()),
        ("gray", lambda f: f.reduce_rolling(samples=2)),
        ("gray", lambda f: f.range()),
        ("rgb", lambda f: f.project()),
        ("projected", lambda f: f.get_stiv([[1.0, 1.0]], angle=0.0, length=0.5)),
    ],
    ids=["smooth", "edge_detect", "minmax", "time_diff", "reduce_rolling", "range", "project-rgb", "get_stiv"],
)
def test_filters_and_stiv_refuse_to_run_without_the_card(monkeypatch, stack, call):
    """The entry points of the second velocimetry path compute on the selected device only:
    with CUDA absent and no set_device('cpu') they raise, as the earlier ones do."""
    import numpy as np

    import chip_smoke

    pyorc_tpu_torch.set_device("cpu")
    cc = chip_smoke.nadir_camera_config(240, 320, gcp_px=30, aoi_px=40)
    da = chip_smoke.frames_dataarray(np.zeros((3, 240, 320), np.uint8), cc)
    if stack == "rgb":
        da = pyorc_tpu_torch.DataArray(
            np.zeros((3, 240, 320, 3), np.uint8), dims=("time", "y", "x", "rgb"),
            coords={k: da[k].values for k in ("time", "y", "x")}, attrs=dict(da.attrs), name="frames",
        )
    elif stack == "projected":
        da = da.frames.project()
    monkeypatch.setattr(_device, "_device", None)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="set_device"):
        call(da.frames)
