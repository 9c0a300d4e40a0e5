"""IO backends: netCDF-4 over h5py, GeoTIFF, UGRID, video decode (the native FFmpeg pump, OpenCV), chessboard lens calibration."""

from .netcdf import read_netcdf, write_netcdf

__all__ = ["read_netcdf", "write_netcdf", "to_geotiff", "to_ugrid", "Video"]


def to_geotiff(fn, data, transform, crs=None, **kwargs):
    """Write a raster as GeoTIFF (reference ``pyorc/io.py:141-163``; pure-Python
    writer here, see :mod:`pyorc_tpu_torch.io.geotiff`)."""
    from .geotiff import write_geotiff

    return write_geotiff(fn, data, transform, crs=crs, **kwargs)


def to_ugrid(*args, **kwargs):
    """Write a velocimetry Dataset as a UGRID-1.0 mesh for QGIS (reference
    ``pyorc/io.py:166-312``; see :mod:`pyorc_tpu_torch.io.ugrid`)."""
    from .ugrid import to_ugrid as _impl

    return _impl(*args, **kwargs)


def __getattr__(name):
    # Video lives in api/ and imports this package's readers: resolved on first use
    if name == "Video":
        from ..api.video import Video

        return Video
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
