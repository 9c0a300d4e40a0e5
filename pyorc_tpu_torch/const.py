"""Variable names, CF attributes and encodings carried on results.

Mirrors the reference's constants (reference ``pyorc/const.py``) so outputs
are drop-in compatible (same variable names, units, int16/scale-0.01 netCDF
encoding).
"""

GEOGRAPHICAL_ATTRS = {
    "xs": {"axis": "X", "long_name": "x-coordinate in projected coordinate system", "units": "m"},
    "ys": {"axis": "Y", "long_name": "y-coordinate in projected coordinate system", "units": "m"},
    "lon": {"long_name": "longitude", "units": "degrees_east"},
    "lat": {"long_name": "latitude", "units": "degrees_north"},
}

PERSPECTIVE_ATTRS = {
    "xp": {"axis": "X", "long_name": "column coordinate in camera perspective", "units": "-"},
    "yp": {"axis": "Y", "long_name": "row coordinate in camera perspective", "units": "-"},
}

VARS_ATTRS = {
    "v_x": {
        "standard_name": "sea_water_x_velocity",
        "long_name": "Flow element center velocity vector, x-component",
        "units": "m s-1",
    },
    "v_y": {
        "standard_name": "sea_water_y_velocity",
        "long_name": "Flow element center velocity vector, y-component",
        "units": "m s-1",
    },
    "s2n": {
        "standard_name": "ratio",
        "long_name": "signal to noise ratio",
        "units": "",
    },
    "corr": {
        "standard_name": "correlation_coefficient",
        "long_name": "correlation coefficient between frames",
        "units": "",
    },
}

COORD_ATTRS = {
    "time": {"standard_name": "time", "long_name": "time from start of video", "units": "seconds since video start"},
    "x": {"axis": "X", "long_name": "x-coordinate in local grid", "units": "m"},
    "y": {"axis": "Y", "long_name": "y-coordinate in local grid", "units": "m"},
}

ENCODE_VARS = ["v_x", "v_y", "s2n", "corr"]
ENCODING_PARAMS = {"dtype": "int16", "scale_factor": 0.01, "zlib": True, "_FillValue": -32768}

FIGURE_ARGS = {"figsize": (16, 9), "frameon": False}
VIDEO_ARGS = {"fps": 25, "extra_args": ["-vcodec", "libx264"], "dpi": 120}
ANIM_ARGS = {"interval": 40, "blit": False}

WATER_LEVEL_MAX_DIFF = 20.0
