"""Grid/axis helpers shared by accessors (reference pyorc/helpers.py subset)."""

from __future__ import annotations

import numpy as np

from .geom import affine as aff
from .geom import crs as crs_mod
from .geom.affine import affine_from_grid, map_to_pixel, pixel_to_map  # noqa: F401  (re-exports)

__all__ = [
    "get_axes",
    "get_xs_ys",
    "get_lons_lats",
    "deserialize_attr",
    "stack_window",
    "stack_window_cells",
    "xy_equidistant",
    "xy_angle",
    "rotate_u_v",
]


def stack_window(ds, wdw=1, wdw_x_min=None, wdw_x_max=None, wdw_y_min=None, wdw_y_max=None, dim="stride"):
    """Stack spatially shifted copies over a new "stride" dimension.

    Reference pyorc/helpers.py:638-679 — NB the reference iterates y strides
    over ``range(wdw_y_min, wdw_y_max)`` (exclusive upper bound, unlike x);
    replicated verbatim for output parity.
    """
    from . import ndx

    wdw_x_min = -wdw if wdw_x_min is None else wdw_x_min
    wdw_x_max = wdw if wdw_x_max is None else wdw_x_max
    wdw_y_min = -wdw if wdw_y_min is None else wdw_y_min
    wdw_y_max = wdw if wdw_y_max is None else wdw_y_max
    return ndx.concat(
        [
            ds.shift(x=x_stride, y=y_stride)
            for x_stride in range(wdw_x_min, wdw_x_max + 1)
            for y_stride in range(wdw_y_min, wdw_y_max)
        ],
        dim=dim,
    )


def stack_window_cells(ds, cells, wdw=1, wdw_x_min=None, wdw_x_max=None, wdw_y_min=None, wdw_y_max=None):
    """:func:`stack_window` read at the grid cells ``cells`` only.

    ``cells`` maps "y" and "x" to the cells' row and column indices (as
    ``DataArray.interp_cells`` gives them). Each variable's y and x dims
    become one dim "cell" in the order of ``cells``; stride ``(sx, sy)``
    reads cell ``(iy - sy, ix - sx)``, NaN where that leaves the grid, and
    the strides come in :func:`stack_window`'s order (its exclusive y range
    included) along "stride", with ``shift``'s dtypes, so a reduction over it gives
    each cell the value it has in the whole stacked field.
    """
    from . import ndx

    wdw_x_min = -wdw if wdw_x_min is None else wdw_x_min
    wdw_x_max = wdw if wdw_x_max is None else wdw_x_max
    wdw_y_min = -wdw if wdw_y_min is None else wdw_y_min
    wdw_y_max = wdw if wdw_y_max is None else wdw_y_max
    iy = np.asarray(cells["y"], dtype=np.int64)
    ix = np.asarray(cells["x"], dtype=np.int64)

    def shifted(v, x_stride, y_stride):
        data = np.moveaxis(v.values, (v.dims.index("y"), v.dims.index("x")), (-2, -1))
        ny, nx = data.shape[-2:]
        sy, sx = iy - y_stride, ix - x_stride
        out = data[..., np.clip(sy, 0, ny - 1), np.clip(sx, 0, nx - 1)]
        if x_stride or y_stride:
            if not ndx._is_float(out.dtype):
                out = out.astype(np.float64)
            out[..., (sy < 0) | (sy >= ny) | (sx < 0) | (sx >= nx)] = np.nan
        dims = tuple(d for d in v.dims if d not in ("y", "x")) + ("cell",)
        return ndx.DataArray(out, dims=dims, name=v.name, attrs=dict(v.attrs))

    return ndx.concat(
        [
            ndx.Dataset({k: shifted(v, x_stride, y_stride) for k, v in ds.data_vars.items()}, attrs=dict(ds.attrs))
            for x_stride in range(wdw_x_min, wdw_x_max + 1)
            for y_stride in range(wdw_y_min, wdw_y_max)
        ],
        dim="stride",
    )


def xy_equidistant(x, y, distance, z=None):
    """Resample ordered (x, y[, z]) coordinates equidistantly along the line.

    Reference pyorc/helpers.py:801-851.
    """
    from scipy.interpolate import interp1d

    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    x_diff = np.concatenate((np.array([0]), np.diff(x)))
    y_diff = np.concatenate((np.array([0]), np.diff(y)))
    s = np.cumsum((x_diff**2 + y_diff**2) ** 0.5)
    f_x = interp1d(s, x, fill_value="extrapolate")
    f_y = interp1d(s, y, fill_value="extrapolate")
    s_sample = np.arange(s.min(), np.ceil((1 + s.max() / distance) * distance), distance)
    x_sample = f_x(s_sample)
    y_sample = f_y(s_sample)
    if z is None:
        return x_sample, y_sample, s_sample
    f_z = interp1d(s, np.asarray(z, dtype=np.float64), fill_value="extrapolate")
    return x_sample, y_sample, f_z(s_sample), s_sample


def xy_angle(x, y):
    """Flow-line angle per point from neighbours. Reference pyorc/helpers.py:854-875."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    angles = np.zeros(len(x))
    angles[1:-1] = np.arctan2(x[2:] - x[0:-2], y[2:] - y[0:-2])
    angles[0] = np.arctan2(x[1] - x[0], y[1] - y[0])
    angles[-1] = np.arctan2(x[-1] - x[-2], y[-1] - y[-2])
    return angles


def rotate_u_v(u, v, theta, deg=False):
    """Rotate vector components counterclockwise. Reference pyorc/helpers.py:602-630."""
    theta = np.radians(theta) if deg else theta
    c, s = np.cos(theta), np.sin(theta)
    u2 = c * u + (-s) * v
    v2 = s * u + c * v
    return u2, v2


def depth_integrate(depth, v, v_corr=0.85, name="q"):
    """Surface velocity -> depth-integrated velocity [m2 s-1]. Reference pyorc/helpers.py:82-111."""
    q = v * v_corr * depth
    q.attrs = {
        "standard_name": "velocity_depth",
        "long_name": "velocity averaged over depth",
        "units": "m2 s-1",
    }
    q.name = name
    return q


def log_profile(x, z0, k_max, s0=0.0, s1=0.0):
    """Log-profile velocity model v = k(s) * max(ln(z/z0), 0). Reference pyorc/helpers.py:336-362."""
    z, s = x
    with np.errstate(divide="ignore", invalid="ignore"):
        k = k_max * np.minimum(np.maximum((s - s0) / max(s1 - s0, 1e-12) if np.isscalar(s1) else (s - s0) / (s1 - s0), 0), 1)
        v = k * np.maximum(np.log(np.maximum(z, 1e-6) / z0), 0)
    return v


def _log_profile_cost(pars, z, dist_bank, v):
    """Module-level cost so differential_evolution can pickle it for workers."""
    pred = log_profile((z, dist_bank), *pars)
    return np.sum((pred - v) ** 2)


def optimize_log_profile(
    z,
    v,
    dist_bank=None,
    bounds=([0.001, 0.1], [-20, 20], [0.0, 5], [0.0, 100]),
    workers=1,
    popsize=100,
    updating="deferred",
    seed=0,
    **kwargs,
):
    """Fit the log-profile parameters with differential evolution.

    Reference pyorc/helpers.py:518-578 (reference defaults workers=2; we
    default to in-process evaluation — identical optimum for the same seed,
    and robust in embedded/subprocess contexts).
    """
    from scipy.optimize import differential_evolution

    dist_bank = np.ones(len(v)) * np.inf if dist_bank is None else np.asarray(dist_bank, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)

    result = differential_evolution(
        _log_profile_cost,
        args=(z, dist_bank, v),
        bounds=bounds,
        workers=workers,
        popsize=popsize,
        updating=updating,
        seed=seed,
        **kwargs,
    )
    z0, k_max, s0, s1 = result.x
    return {"z0": z0, "k_max": k_max, "s0": s0, "s1": s1}


def velocity_log_fit(v, depth, dist_shore, dim="quantile"):
    """Fill missing surface velocities with a fitted log-depth model. Reference pyorc/helpers.py:716-750."""
    depth = np.asarray(depth, dtype=np.float64)
    dist_shore = np.asarray(dist_shore, dtype=np.float64)
    out = v.copy(deep=True)
    vals = out.values.astype(np.float64)
    ax = out.dims.index(dim)
    vals = np.moveaxis(vals, ax, 0)
    for i in range(vals.shape[0]):
        row = vals[i]
        idx_finite = np.isfinite(row)
        if idx_finite.sum() >= 4:
            pars = optimize_log_profile(depth[idx_finite], row[idx_finite], dist_shore[idx_finite])
            idx_miss = np.where(~idx_finite)[0]
            row[idx_miss] = log_profile((depth[idx_miss], dist_shore[idx_miss]), **pars)
        row[depth <= 0] = 0.0
        vals[i] = np.maximum(row, 0)
    out = out._replace(np.moveaxis(vals, 0, ax).astype(np.float64))
    return out


def velocity_log_interp(v, dist_wall, d_0=0.1, dim="quantile"):
    """Fill missing velocities via log-scaled linear interpolation. Reference pyorc/helpers.py:753-793."""
    dist_wall = np.asarray(dist_wall, dtype=np.float64)
    out = v.copy(deep=True)
    vals = out.values.astype(np.float64)
    ax = out.dims.index(dim)
    vals = np.moveaxis(vals, ax, 0)
    logterm = np.log(np.maximum(dist_wall, d_0) / d_0)
    for i in range(vals.shape[0]):
        row = vals[i]
        with np.errstate(divide="ignore", invalid="ignore"):
            c = row / logterm
        # fill dry (dist_wall==0) points with the nearest valid c, then linear interp
        pts = np.arange(len(c))
        good = np.isfinite(c)
        if good.sum() >= 1:
            dry = np.where(dist_wall == 0)[0]
            if len(dry) and good.sum() > 0:
                gi = np.where(good)[0]
                nearest = gi[np.argmin(np.abs(dry[:, None] - gi[None, :]), axis=1)]
                c[dry] = c[nearest]
                good = np.isfinite(c)
            if good.sum() >= 2:
                c[~good] = np.interp(pts[~good], pts[good], c[good])
        miss = np.isnan(row)
        row[miss] = (logterm * c)[miss]
        vals[i] = row
    return out._replace(np.moveaxis(vals, 0, ax))


def densify_points(points, sample_size=1000):
    """Interpolate a point sequence to `sample_size` points along its index."""
    points = np.asarray(points, dtype=np.float64)
    idx = np.linspace(0, len(points) - 1, sample_size)
    if points.ndim == 1:
        return np.interp(idx, np.arange(len(points)), points)
    return np.stack([np.interp(idx, np.arange(len(points)), points[:, k]) for k in range(points.shape[1])], axis=-1)


def get_axes(cols, rows, x, y):
    """Sample frame axes at window-centre indices. Reference pyorc/helpers.py:142-168."""
    return np.asarray(x)[np.asarray(cols)], np.asarray(y)[np.asarray(rows)]


def get_xs_ys(cols, rows, transform):
    """Projected x/y rasters at (cols, rows) cell centres.

    Reference pyorc/helpers.py:271-296 uses rasterio's ``xy`` which applies
    the half-cell centre offset — replicated here.
    """
    cols = np.asarray(cols, dtype=np.float64)
    rows = np.asarray(rows, dtype=np.float64)
    xs, ys = aff.pixel_to_map(cols + 0.5, rows + 0.5, transform)
    return xs.reshape(rows.shape), ys.reshape(rows.shape)


def get_lons_lats(xs, ys, src_crs, dst_crs=4326):
    """Lon/lat rasters from projected coordinates. Reference pyorc/helpers.py:299-333."""
    lons, lats = crs_mod.transform_points(src_crs, dst_crs, np.asarray(xs).flatten(), np.asarray(ys).flatten())
    return lons.reshape(np.shape(xs)), lats.reshape(np.shape(ys))


def deserialize_attr(data_array, attr, dtype=np.array, args_parse=False):
    """Deserialize a JSON-encoded attribute."""
    import json

    value = data_array.attrs[attr]
    if args_parse:
        return dtype(*json.loads(value))
    return dtype(json.loads(value))


# -- public-API compat helpers (reference pyorc/helpers.py) -------------------


def round_to_multiple(number, multiple):
    """Round number to the nearest multiple. Reference helpers.py (AOI grid snapping)."""
    from .geom.aoi import round_to_multiple as _impl

    return _impl(number, multiple)


def get_rotation_code(rotation):
    """Rotation degrees -> cv2 rotation code. Reference helpers.py:245."""
    from .io.video_reader import get_rotation_code as _impl

    return _impl(rotation)


def staggered_index(start=0, end=100):
    """Staggered (bisection-ordered) frame index. Reference helpers.py:682-713."""
    from .io.calibration import staggered_index as _impl

    return _impl(start=start, end=end)


def xyz_transform(points, crs_from, crs_to):
    """Transform [x, y(, z)] points between CRSs. Reference helpers.py:916-954."""
    from .api.cameraconfig import xyz_transform as _impl

    return _impl(points, crs_from, crs_to)


def read_shape_safe_crs(fn):
    """Read a GeoJSON shape with CRS=None preserved (geopandas defaults missing
    CRS to EPSG:4326; this keeps it unset). Reference helpers.py:581-599.
    Returns (coords, crs) rather than a GeoDataFrame (geopandas-free build)."""
    from .cli.cli_utils import read_shape as _impl

    return _impl(fn=fn)


def get_geo_axes(tiles=None, extent=None, zoom_level=19, **kwargs):
    """Geographical plot axes with an optional XYZ basemap.

    Reference helpers.py:171-204 builds cartopy GeoAxes with image tilers;
    here the tiles render through the self-contained Web-Mercator fetcher
    (:mod:`pyorc_tpu_torch.io.basemap`) onto a plain lon/lat axes — offline runs
    degrade gracefully to no background.
    """
    import matplotlib.pyplot as plt

    ax = plt.axes()
    if tiles is not None and extent is not None:
        from .io import basemap

        basemap.add_basemap(ax, extent, tiles=tiles, zoom_level=min(int(zoom_level), 19))
    if extent is not None:
        ax.set_xlim(extent[0], extent[1])
        ax.set_ylim(extent[2], extent[3])
    ax.set_aspect("equal")
    return ax


def mse(pars, func, x, y):
    """Sum of squared errors of func(x, *pars) vs y. Reference helpers.py:459-481."""
    y_pred = func(x, *pars)
    return np.sum((y_pred - y) ** 2)


def wrap_mse(pars_iter, *args):
    """Optimizer-friendly wrapper of :func:`mse`. Reference helpers.py:796-798."""
    return mse(pars_iter, *args)


def neighbour_stack(array, stride=1, missing=-9999.0):
    """Stack of spatially-shifted copies of a 2-D array ((2*stride+1)^2 layers);
    NaNs replaced by ``missing`` so the stack is convolution-safe.
    Reference helpers.py:484-515."""
    array = np.array(array, dtype=float)
    array[np.isnan(array)] = missing
    shifted = []
    for vert in range(-stride, stride + 1):
        for horz in range(-stride, stride + 1):
            conv_arr = np.full_like(array, missing)
            src = conv_arr[
                max(vert, 0) : array.shape[0] + min(vert, 0),
                max(horz, 0) : array.shape[1] + min(horz, 0),
            ]
            src[:] = array[
                max(-vert, 0) : array.shape[0] + min(-vert, 0),
                max(-horz, 0) : array.shape[1] + min(-horz, 0),
            ]
            shifted.append(conv_arr)
    return np.stack(shifted)


def get_enclosed_mask(data, stride=2):
    """Binary mask of cells that are finite OR lie in NaN holes fully enclosed
    by finite values (NaN regions touching the border stay 0).
    Reference helpers.py:207-242."""
    from scipy.ndimage import label

    finite = np.isfinite(np.asarray(data, dtype=float))
    holes, n = label(~finite)
    mask = finite.astype(float)
    for k in range(1, n + 1):
        region = holes == k
        rows, cols = np.where(region)
        touches_border = (
            rows.min() < stride
            or cols.min() < stride
            or rows.max() >= data.shape[0] - stride
            or cols.max() >= data.shape[1] - stride
        )
        if not touches_border:
            mask[region] = 1.0
    return mask


def mask_fill(data, mask, radius=5):
    """Fill NaN cells where ``mask == 1`` from nearby finite values (iterative
    neighbour-mean within ``radius`` passes; cells with mask != 1 stay NaN).
    Reference helpers.py:432-456 (rasterio fillnodata equivalent)."""
    data = np.array(data, dtype=float)
    mask = np.array(mask)
    mask[np.isfinite(data)] = 1
    out = data.copy()
    for _ in range(int(radius)):
        nan_fill = ~np.isfinite(out) & (mask == 1)
        if not nan_fill.any():
            break
        stack = neighbour_stack(out, stride=1, missing=np.nan)
        with np.errstate(invalid="ignore"):
            nbr_mean = np.nanmean(stack, axis=0)
        out[nan_fill] = nbr_mean[nan_fill]
    out[mask != 1] = np.nan
    return out


def xy_to_perspective(x, y, resolution, trans_mat, reverse_y=None):
    """Back-project local grid axes to camera-perspective pixel coordinates via
    the 3x3 homography ``trans_mat``. Reference helpers.py:878-913."""
    cols = np.asarray(x, dtype=np.float64) / resolution - 0.5
    rows = np.asarray(y, dtype=np.float64) / resolution - 0.5
    if reverse_y is not None:
        rows = reverse_y - rows
    cols, rows = np.broadcast_arrays(cols, rows)
    pts = np.stack([cols.ravel(), rows.ravel(), np.ones(cols.size)])
    m = np.asarray(trans_mat, dtype=np.float64)
    if m.shape == (2, 3):
        m = np.vstack([m, [0.0, 0.0, 1.0]])
    out = m @ pts
    xp = (out[0] / out[2]).reshape(cols.shape)
    yp = (out[1] / out[2]).reshape(cols.shape)
    return xp, yp
