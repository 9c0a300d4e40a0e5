"""pyorc_tpu_torch — the PyTorch/CUDA port of pyorc_tpu.

River videos or frame stacks in, surface velocity fields and discharge out,
on an NVIDIA GPU: video decode runs on the host (:class:`Video`), the frame
filters, orthorectification and STIV run as PyTorch ops on the device, and the PIV correlation runs as hand-written CUDA kernels
(:mod:`pyorc_tpu_torch.ops.piv_kernels`). The geometry core (camera model,
PnP, CRS) is host-side float64 numpy, as in the JAX package.

The package mirrors ``pyorc_tpu``'s layout and names module for module, and
imports neither JAX nor ``pyorc_tpu``. Work runs on the device that
:func:`set_device` selects, "cuda" by default.
"""

__version__ = "0.1.0"

from . import ndx
from ._device import get_device, set_device
from .ndx import DataArray, Dataset, open_dataset
from . import api as _api  # registers .frames/.velocimetry/.transect accessors  # noqa: E402
from .api.cameraconfig import CameraConfig, get_camera_config, load_camera_config  # noqa: E402
from .api.cross_section import CrossSection  # noqa: E402
from .api.video import LazyFrames, Video  # noqa: E402

__all__ = [
    "DataArray",
    "Dataset",
    "ndx",
    "open_dataset",
    "CameraConfig",
    "CrossSection",
    "get_camera_config",
    "load_camera_config",
    "LazyFrames",
    "Video",
    "get_device",
    "set_device",
    "project_numpy",
    "project_cv",
    "sample_data",
    "plot_helpers",
    "__version__",
]


def __getattr__(name):
    # modules and functions that import matplotlib or urllib, or build ortho maps, when used
    if name in ("project_numpy", "project_cv"):
        from . import project

        return getattr(project, name)
    if name in ("project", "sample_data", "plot_helpers"):
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
