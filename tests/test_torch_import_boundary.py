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
        assert set(probe) == {{"cv2", "native_compiler", "native_decoder", "libnvcuvid", "nvdec_h264",
                              "libavcodec_yuv", "cv2_swscale", "libavcodec"}}, probe
        assert probe["nvdec_h264"] == "no card", probe
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
        results, _, _, _ = chip_smoke.lazy_phase(
            stack, cc, {{chip_smoke.ENS_WINDOW: piv}}, "cpu", fps=chip_smoke.ENS_FPS, ensemble=True, aoi_px=100,
            tag="lazy ens",
        )
        assert set(results) == {{chip_smoke.ENS_WINDOW}}, results
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


def _run_without(absent, body):
    """Run ``body`` in a child interpreter with the modules ``absent`` blocked; it must print OK."""
    script = f"import sys\nfor name in {tuple(absent)!r}:\n    sys.modules[name] = None\n" + textwrap.dedent(body)
    script += "\nleaked = sorted(m for m in sys.modules if m == 'pyorc_tpu' or m.startswith('pyorc_tpu.'))"
    script += "\nassert not leaked, leaked\nprint('OK')\n"
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stdout[-3000:] + proc.stderr[-3000:]


def test_cross_section_and_scorer_run_without_host_libraries():
    """``api.cross_section`` and ``ops.waterlevel`` need none of ABSENT: the Geul scene's
    water level on the CPU, and the per-candidate host score (the port's polygon fill)."""
    _run_without(ABSENT, """
        import torch
        torch.set_num_threads(2)
        import pyorc_tpu_torch
        from pyorc_tpu_torch.api import cross_section
        from pyorc_tpu_torch.ops import waterlevel
        import chip_smoke

        pyorc_tpu_torch.set_device("cpu")
        cs = chip_smoke.geul_cross_section(chip_smoke.geul_camera_config())
        img = chip_smoke.waterline_scene(cs)
        h, s2n = cs.detect_water_level_s2n(img, dz_max=0.1, ds_max=1.0)
        assert abs(h - chip_smoke.GEUL_H) < chip_smoke.GEUL_TOL and s2n > chip_smoke.GEUL_S2N_MIN, (h, s2n)
        assert cs.get_histogram_score([6.0], img) < 2.0
    """)


def test_service_and_cli_import_without_jax_and_host_libraries():
    """The service and the CLI import click and yaml (as the JAX package does) and none of
    jax, cv2, h5py, matplotlib or tqdm."""
    _run_without(("jax", "jaxlib", "cv2", "h5py", "matplotlib", "tqdm"), """
        import pyorc_tpu_torch.service
        import pyorc_tpu_torch.cli.main
        from pyorc_tpu_torch.service.velocimetry import VelocityFlowProcessor, get_water_level
    """)


def test_chip_smoke_service_step_without_jax(tmp_path):
    """chip_smoke's service step (steps 5d and 5e) at a small size on the CPU, without jax,
    h5py or matplotlib (the card's machine has neither of the last two): the service
    in-process on a 480x640, 12-frame clip, the CLI as a child process, and the optical
    water level on the 1920x1080 Geul scene with the scorer's CPU result held to itself."""
    _run_without(("jax", "jaxlib", "h5py", "matplotlib"), f"""
        import json
        from pathlib import Path
        import torch
        torch.set_num_threads(2)
        import chip_smoke
        from pyorc_tpu_torch.ops import piv_kernels

        folder = Path({str(tmp_path)!r})
        stack = chip_smoke.advected_stack(480, 640, 12, "cpu")
        clip = chip_smoke.write_clip(stack, folder / "clip.avi")
        results, walls = chip_smoke.service_phase(clip, chip_smoke.nadir_camera_config(480, 640), folder, "cpu")
        assert set(walls) == set(chip_smoke.SERVICE_STAGES), walls
        assert piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] == "plain_cpu"
        wall, walls = chip_smoke.cli_phase(clip, folder, "cpu")
        assert set(walls) == set(chip_smoke.SERVICE_STAGES), walls
        assert sorted(p.name for p in (folder / "service_out").iterdir()) == [".pyorc", "pyorc_tpu.log"]
        wl = chip_smoke.water_level_phase(folder, "cpu")
        assert abs(wl["level"] - chip_smoke.GEUL_H) < chip_smoke.GEUL_TOL and wl["s2n"] > chip_smoke.GEUL_S2N_MIN, wl
        assert wl["max_abs_diff_vs_cpu"] == 0.0 and wl["s2n_scorer"]["candidates"] > 100, wl
        assert wl["s2n_scorer"]["device_ms"] == "not measured", wl
        json.dumps(wl)
    """)


def test_outputs_without_host_libraries(tmp_path):
    """The output modules (``api/plot.py``, ``plot_helpers.py``, ``io/basemap.py``, ``io/ugrid.py``,
    ``io/geotiff.py``, ``project.py``, ``sample_data.py``) import with jax, cv2, h5py, tqdm,
    matplotlib, requests and PIL blocked; there ``to_geotiff``, ``to_ugrid``'s Dataset and step
    5f's CPU functions run at a small size, and a plot says that it needs matplotlib."""
    _run_without(ABSENT + ("requests", "PIL"), f"""
        from pathlib import Path
        import numpy as np
        import torch
        torch.set_num_threads(2)
        import pyorc_tpu_torch
        from pyorc_tpu_torch import plot_helpers, project, sample_data  # noqa: F401
        from pyorc_tpu_torch.api import plot
        from pyorc_tpu_torch.io import basemap, geotiff, ugrid  # noqa: F401
        from pyorc_tpu_torch.ops import filters as flt
        import chip_smoke

        pyorc_tpu_torch.set_device("cpu")
        folder = Path({str(tmp_path)!r})
        cc = chip_smoke.nadir_camera_config(240, 320, gcp_px=30, aoi_px=40)
        stack = chip_smoke.advected_stack(240, 320, 8, "cpu")
        reference = chip_smoke.outputs_reference(stack, cc, folder, samples=2, batch=3)
        proj = chip_smoke.frames_dataarray(stack, cc).frames.normalize(samples=2).frames.project()
        frames = list(flt.video_uint8(torch.from_numpy(np.asarray(proj.values))).numpy())
        assert chip_smoke.hold_video_frames(frames, reference) == 8
        proj.frames.to_geotiff(folder / "frame_0000.tif", frame=0)
        assert chip_smoke.hold_geotiff(folder / "frame_0000.tif", folder / "reference_frame_0000.tif") == "byte-equal"
        x, y = proj["x"].values, proj["y"].values
        np.testing.assert_array_equal(project.project_numpy(stack[0], cc, x, y, 0.0, reducer="nearest"),
                                      project.project_cv(stack[:1], cc, x, y, 0.0)[0])
        piv = proj.frames.get_piv(window_size=32)
        wall, moved, shape = chip_smoke.ugrid_arrays_equal(piv, "cpu")
        assert moved == {{"h2d": 0, "d2h": 0}} and shape[0] == 7, (moved, shape)
        assert "matplotlib absent, h5py absent" in chip_smoke.host_only_outputs()
        try:
            plot.frames_plot(proj.isel(time=0))
        except ImportError as err:
            assert "matplotlib" in str(err), err
        else:
            raise AssertionError("a frame was plotted without matplotlib")
    """)


def test_parallel_runs_without_jax_and_starts_no_process_group():
    """``pyorc_tpu_torch.parallel`` imports and runs with jax, cv2 and h5py blocked; importing the
    package starts no ``torch.distributed`` process group, nor does a one-process ``init_distributed``."""
    _run_without(("jax", "jaxlib", "cv2", "h5py"), """
        import numpy as np
        import torch
        torch.set_num_threads(2)
        import pyorc_tpu_torch
        import pyorc_tpu_torch.parallel
        from pyorc_tpu_torch.parallel import distributed, piv
        import chip_smoke

        assert not torch.distributed.is_initialized()
        pyorc_tpu_torch.set_device("cpu")
        stack = chip_smoke.advected_stack(96, 128, 5, "cpu")
        mesh = piv.make_mesh([torch.device("cpu")] * 3)
        u, v, cmax, s2n = piv.piv_pairs_sharded(stack, (32, 32), (16, 16), mesh=mesh)
        assert u.shape == (4, 5, 7) and np.isfinite(cmax).all()
        assert distributed.init_distributed() == (0, 1) and not torch.distributed.is_initialized()
    """)


def _jax_imports(path):
    """The lines of ``path`` that import jax, jaxlib or the JAX package."""
    offenders = []
    for line in path.read_text().splitlines():
        words = line.strip().replace(",", " ").split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            root = words[1].split(".")[0]
            if root in ("jax", "jaxlib", "pyorc_tpu"):
                offenders.append(f"{path.relative_to(ROOT)}: {line.strip()}")
    return offenders


def test_no_module_imports_jax_or_the_jax_package():
    """Source check: no module of the port, not chip_smoke.py and no docs/torch_* file (the API page's
    generator, and the user guide's code) imports jax or pyorc_tpu."""
    offenders = []
    docs = [ROOT / "docs" / "torch_gen_api.py", ROOT / "docs" / "torch-user-guide.md"]
    assert all(path.is_file() for path in docs)
    for path in [*sorted((ROOT / "pyorc_tpu_torch").rglob("*.py")), ROOT / "chip_smoke.py", *docs]:
        offenders += _jax_imports(path)
    assert not offenders, offenders


@pytest.mark.parametrize("name", [
    "examples/torch_demo.py", "examples/torch_06_water_level_optical.py", "examples/torch_07_stiv_velocimetry.py",
])
def test_benchmarks_and_examples_import_neither_jax_nor_the_jax_package(name):
    """Source check: the port's examples import neither jax nor pyorc_tpu."""
    assert (ROOT / name).is_file()
    assert not _jax_imports(ROOT / name)


def test_device_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    """No quiet CPU fallback: without CUDA and without set_device('cpu'), device use raises."""
    monkeypatch.setattr(_device, "_device", None)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="set_device"):
        pyorc_tpu_torch.get_device()
    pyorc_tpu_torch.set_device("cpu")
    assert pyorc_tpu_torch.get_device().type == "cpu"


def test_device_from_the_environment(monkeypatch):
    """Without set_device, PYORC_TPU_TORCH_DEVICE names the device (the CLI's child process
    reads it); unset it is still "cuda" and refused without a card; a bad name raises."""
    monkeypatch.setattr(_device, "_device", None)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    monkeypatch.delenv("PYORC_TPU_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="PYORC_TPU_TORCH_DEVICE=cpu"):
        pyorc_tpu_torch.get_device()
    monkeypatch.setenv("PYORC_TPU_TORCH_DEVICE", "cuda:0")
    with pytest.raises(RuntimeError, match="set_device"):
        pyorc_tpu_torch.get_device()
    monkeypatch.setenv("PYORC_TPU_TORCH_DEVICE", "cpu")
    assert pyorc_tpu_torch.get_device().type == "cpu"
    monkeypatch.setenv("PYORC_TPU_TORCH_DEVICE", "gpu0")
    with pytest.raises(ValueError, match="gpu0"):
        pyorc_tpu_torch.get_device()
    pyorc_tpu_torch.set_device("cpu")  # set_device wins over the environment
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
