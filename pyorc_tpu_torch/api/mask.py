"""Composable mask chain for velocimetry vector fields.

Parity port of the reference's 11 masks (reference ``pyorc/api/mask.py``),
expressed as vectorized ndx/numpy operations. Masks are boolean DataArrays
applied with ``ds.velocimetry.mask(mask_list, inplace=True)``.
"""

from __future__ import annotations

import copy
import functools
import warnings

import numpy as np

from .. import _trace, helpers, ndx

V_X, V_Y, S2N, CORR = "v_x", "v_y", "s2n", "corr"

commondoc = """
        Returns
        -------
        mask : ndx.DataArray
            boolean mask; with ``inplace=True`` the dataset is masked directly.
"""


def _base_mask(time_allowed=False, time_required=False, multi_timestep_required=False):
    """Shared mask plumbing: time-dim requirements, reduce_time, inplace application.

    Mirrors reference pyorc/api/mask.py:22-89.
    """

    def decorator_func(mask_func):
        mask_func.__doc__ = f"{mask_func.__doc__}{commondoc}"

        @functools.wraps(mask_func)
        def wrapper_func(ref, inplace=False, reduce_time=False, *args, **kwargs):
            if reduce_time and "time" in ref._obj.sizes:
                ds = ref._obj.mean(dim="time")
                ds.attrs = dict(ref._obj.attrs)
            else:
                ds = ref._obj
            if not ds.velocimetry.is_velocimetry:
                raise AssertionError("Dataset is not a valid velocimetry dataset")
            if time_required:
                if "time" not in ds.sizes:
                    raise AssertionError(
                        'This mask requires dimension "time". The dataset does not contain dimension "time" '
                        "or you have set `reduce_time=True`."
                    )
                if multi_timestep_required and ds.sizes["time"] < 2:
                    warnings.warn(
                        "This mask requires multiple timesteps to have an effect (e.g. after "
                        "`Frames.get_piv(ensemble_corr=True)` only one time step exists).",
                        stacklevel=2,
                    )
            if multi_timestep_required and "time" in ds.sizes and ds.sizes["time"] < 2:
                mask = ndx.DataArray(
                    np.ones((ds.sizes["y"], ds.sizes["x"]), dtype=bool),
                    dims=("y", "x"),
                    coords={"y": ds["y"].values, "x": ds["x"].values},
                )
            else:
                # spatial-window masks apply independently per time step, so a
                # direct whole-dataset application is equivalent to the
                # reference's groupby("time").map
                mask = mask_func(ds, **kwargs)
            if inplace:
                for var in list(ref._obj.data_vars):
                    ref._obj[var] = ref._obj[var].where(mask)
            return mask

        return _trace.spanned(f"mask:{mask_func.__name__}")(wrapper_func)

    return decorator_func


class _Velocimetry_MaskMethods:
    """``ds.velocimetry.mask.<method>`` masks + ``ds.velocimetry.mask([m1, m2])`` application."""

    def __init__(self, velocimetry):
        self.velocimetry = velocimetry
        self._obj = velocimetry._obj

    @_trace.spanned("mask:apply")
    def __call__(self, mask, inplace=False, *args, **kwargs):
        if not isinstance(mask, list):
            mask = [mask]
        if inplace:
            for m in mask:
                for var in (V_X, V_Y, CORR, S2N):
                    self._obj[var] = self._obj[var].where(m)
            return None
        ds = self._obj.copy(deep=True)
        for m in mask:
            for var in (V_X, V_Y, CORR, S2N):
                ds[var] = ds[var].where(m)
        return ds

    @_base_mask(time_allowed=True)
    def minmax(self, s_min=0.1, s_max=5.0):
        """Mask velocity magnitudes outside [s_min, s_max]."""
        s = (self[V_X] ** 2 + self[V_Y] ** 2) ** 0.5
        return (s > s_min) & (s < s_max)

    @_base_mask(time_allowed=True)
    def angle(self, angle_expected=0.5 * np.pi, angle_tolerance=0.25 * np.pi):
        """Mask vectors outside the expected flow direction +/- tolerance."""
        angle = np.arctan2(self[V_X].values, self[V_Y].values)
        mask_vals = np.abs(angle - angle_expected) < angle_tolerance
        return self[V_X]._replace(mask_vals)

    @_base_mask(time_required=True, multi_timestep_required=True)
    def count(self, tolerance=0.33):
        """Mask locations with too few valid velocities in time."""
        return self[V_X].count(dim="time") > tolerance * self.sizes["time"]

    @_base_mask(time_allowed=True)
    def corr(self, tolerance=0.1):
        """Mask values with too low correlation."""
        return self[CORR] > tolerance

    @_base_mask(time_allowed=True)
    def s2n(self, tolerance=10):
        """Mask values with too low signal-to-noise ratio."""
        return self[S2N] > tolerance

    @_base_mask(time_required=True, multi_timestep_required=True)
    def outliers(self, tolerance=1.0, mode="or"):
        """Mask values more than `tolerance` standard deviations from the temporal mean."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            x_std = self[V_X].std(dim="time")
            y_std = self[V_Y].std(dim="time")
            x_mean = self[V_X].mean(dim="time")
            y_mean = self[V_Y].mean(dim="time")
            x_condition = abs((self[V_X] - x_mean) / x_std) < tolerance
            y_condition = abs((self[V_Y] - y_mean) / y_std) < tolerance
        return (x_condition | y_condition) if mode == "or" else (x_condition & y_condition)

    @_base_mask(time_required=True, multi_timestep_required=True)
    def variance(self, tolerance=5, mode="and"):
        """Mask locations whose temporal std/mean ratio exceeds tolerance."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            x_std = self[V_X].std(dim="time")
            y_std = self[V_Y].std(dim="time")
            # NB reference pyorc/api/mask.py:274-275 clamps the mean UP to 1e30
            # (making the variance ratio ~0 and the mask pass everywhere);
            # replicated for parity
            x_mean = self[V_X].mean(dim="time")
            y_mean = self[V_Y].mean(dim="time")
            x_mean = x_mean._replace(np.maximum(x_mean.values, 1e30))
            y_mean = y_mean._replace(np.maximum(y_mean.values, 1e30))
            x_condition = abs(x_std / x_mean) < tolerance
            y_condition = abs(y_std / y_mean) < tolerance
        return (x_condition | y_condition) if mode == "or" else (x_condition & y_condition)

    @_base_mask(time_required=True, multi_timestep_required=True)
    def rolling(self, wdw=5, tolerance=0.5):
        """Mask values deviating strongly from the rolling temporal maximum."""
        s = (self[V_X] ** 2 + self[V_Y] ** 2) ** 0.5
        s_rolling = s.fillna(0.0).rolling(time=wdw, center=True).max()
        return s > tolerance * s_rolling

    @_base_mask()
    def window_nan(self, tolerance=0.7, wdw=1, **kwargs):
        """Mask values whose neighbourhood contains too many NaNs."""
        ds_wdw = helpers.stack_window(self, wdw=wdw, **kwargs)
        valid_neighbours = ds_wdw[V_X].count(dim="stride")
        return valid_neighbours >= tolerance * ds_wdw.sizes["stride"]

    @_base_mask()
    def window_mean(self, tolerance=0.7, wdw=1, mode="or", **kwargs):
        """Mask values deviating too much from their neighbourhood mean."""
        ds_wdw = helpers.stack_window(self, wdw=wdw, **kwargs)
        ds_mean = ds_wdw.mean(dim="stride")
        x_condition = abs(self[V_X] - ds_mean[V_X]) / ds_mean[V_X] < tolerance
        y_condition = abs(self[V_Y] - ds_mean[V_Y]) / ds_mean[V_Y] < tolerance
        return (x_condition | y_condition) if mode == "or" else (x_condition & y_condition)

    @_base_mask()
    def window_replace(self, wdw=1, iter=1, **kwargs):
        """Infill NaNs with neighbourhood means; returns a Dataset, not a mask."""
        ds = copy.deepcopy(self)
        for _ in range(iter):
            ds_wdw = helpers.stack_window(ds, wdw=wdw, **kwargs)
            ds_mean = ds_wdw.mean(dim="stride")
            ds = ds.fillna(ds_mean)
        return ds
