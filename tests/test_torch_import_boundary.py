"""The port runs where the GPU machine runs it: without JAX, the JAX package,
OpenCV, h5py, tqdm, click, yaml or matplotlib."""

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

        results, _, proj, _ = chip_smoke.slice_phase(480, 640, 12, "cpu")
        assert set(results) == {{16, 26}}, results
        assert piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] == "plain_cpu"
        results, *_ = chip_smoke.multipass_phase(proj[:6], 480, 640)
        assert set(results) == {{32, 26}}, results
        camera = {{"f": 1000.0, "gcp_px": 60, "aoi_px": 100}}
        results, *_ = chip_smoke.ensemble_slice_phase(480, 640, 8, "cpu", camera=camera)
        assert piv_kernels.KERNEL_ROUTE["piv_ensemble_fused"] == "plain_cpu"
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
