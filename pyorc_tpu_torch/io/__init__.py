"""IO backends: netCDF-4 over h5py, video decode (the native FFmpeg pump, OpenCV), chessboard lens calibration."""

from .netcdf import read_netcdf, write_netcdf

__all__ = ["read_netcdf", "write_netcdf", "Video"]


def __getattr__(name):
    # Video lives in api/ and imports this package's readers: resolved on first use
    if name == "Video":
        from ..api.video import Video

        return Video
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
