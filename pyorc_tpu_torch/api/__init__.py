"""Public object/accessor API: CameraConfig, CrossSection + ndx accessors."""

from .cameraconfig import CameraConfig, get_camera_config, load_camera_config

# importing these modules registers the ndx accessors (.frames/.velocimetry/.transect)
from . import frames as _frames  # noqa: F401, E402
from . import transect as _transect  # noqa: F401, E402
from . import velocimetry as _velocimetry  # noqa: F401, E402
from .cross_section import CrossSection  # noqa: E402

__all__ = ["CameraConfig", "CrossSection", "get_camera_config", "load_camera_config"]
