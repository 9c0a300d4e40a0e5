"""ndx — a minimal, dependency-free labeled N-D array data model.

This is the framework's native replacement for the xarray DataArray/Dataset
data model the reference library (pyorc) builds on (reference: pyorc uses
``xr.DataArray``/``xr.Dataset`` throughout, e.g. ``pyorc/api/video.py:503-534``,
``pyorc/velocimetry/ffpiv.py:325-337``). Rather than pulling in xarray+dask, we
implement the small subset of semantics the pipeline needs:

- named dimensions + coordinate variables + attrs, carried through operations
- NaN-skipping reductions over named dims (xarray's ``skipna=True`` default)
- dim-name based broadcasting for arithmetic
- isel/sel/interp/rolling/shift/quantile/where/fillna
- accessor registration (``.frames``, ``.velocimetry``, ``.transect``)

The PyTorch port keeps its own copy of this module so that its accessor
registry is separate from the JAX package's. Data are numpy arrays: the
device work of the port happens inside the ops, which take and return host
arrays at this boundary. netCDF-4 reading and writing go through h5py
(:mod:`pyorc_tpu_torch.io.netcdf`), imported when first used.
"""

from __future__ import annotations

import copy as _copy
from collections import OrderedDict
from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "DataArray",
    "Dataset",
    "register_dataarray_accessor",
    "register_dataset_accessor",
    "concat",
    "broadcast_arrays",
    "open_dataset",
]


def _xp(arr):
    return np


def _to_numpy(arr):
    return np.asarray(arr)


def _is_float(dtype) -> bool:
    return np.issubdtype(np.dtype(dtype), np.floating)


# --------------------------------------------------------------------------------------
# Coordinates
# --------------------------------------------------------------------------------------


class Coordinates(Mapping):
    """Mapping of coordinate name -> DataArray, tied to a parent object's dims."""

    def __init__(self, variables: Optional[Dict[str, "DataArray"]] = None):
        self._variables: "OrderedDict[str, DataArray]" = OrderedDict(variables or {})

    def __getitem__(self, key) -> "DataArray":
        return self._variables[key]

    def __iter__(self):
        return iter(self._variables)

    def __len__(self):
        return len(self._variables)

    def __contains__(self, key):
        return key in self._variables

    def __repr__(self):
        lines = ["Coordinates:"]
        for k, v in self._variables.items():
            lines.append(f"  * {k} {v.dims} {v.shape} {v.dtype}")
        return "\n".join(lines)

    def copy(self):
        return Coordinates(OrderedDict(self._variables))


def _normalize_coords(coords, dims, shape) -> "OrderedDict[str, DataArray]":
    """Normalize user coords into name -> DataArray with explicit dims."""
    out: "OrderedDict[str, DataArray]" = OrderedDict()
    if coords is None:
        return out
    if isinstance(coords, Coordinates):
        coords = coords._variables
    dim_sizes = dict(zip(dims, shape))
    for name, val in coords.items():
        if isinstance(val, DataArray):
            out[name] = DataArray(val.data, dims=val.dims, attrs=dict(val.attrs), name=name, fastpath=True)
        elif isinstance(val, tuple) and len(val) in (2, 3) and isinstance(val[0], (tuple, list, str)):
            cdims = (val[0],) if isinstance(val[0], str) else tuple(val[0])
            cdata = val[1]
            cattrs = dict(val[2]) if len(val) == 3 else {}
            if not hasattr(cdata, "ndim"):
                cdata = np.asarray(cdata)
            out[name] = DataArray(cdata, dims=cdims, attrs=cattrs, name=name, fastpath=True)
        else:
            cdata = val if hasattr(val, "ndim") else np.asarray(val)
            if cdata.ndim == 0:
                out[name] = DataArray(cdata, dims=(), name=name, fastpath=True)
            else:
                # 1-D coord named after its dim, or matching a dim of same size
                if name in dim_sizes:
                    out[name] = DataArray(cdata, dims=(name,), name=name, fastpath=True)
                else:
                    cand = [d for d, s in dim_sizes.items() if s == cdata.shape[0]]
                    if cdata.ndim == 1 and len(cand) >= 1:
                        out[name] = DataArray(cdata, dims=(cand[0],), name=name, fastpath=True)
                    else:
                        raise ValueError(
                            f"cannot infer dims for coordinate {name!r} with shape {cdata.shape}; "
                            f"pass a (dims, data) tuple"
                        )
    return out


# --------------------------------------------------------------------------------------
# Accessor registration (mirrors xarray's register_*_accessor used at
# reference pyorc/api/frames.py:23, velocimetry.py:20, transect.py:15)
# --------------------------------------------------------------------------------------

_DATAARRAY_ACCESSORS: Dict[str, type] = {}
_DATASET_ACCESSORS: Dict[str, type] = {}


def register_dataarray_accessor(name: str) -> Callable[[type], type]:
    def decorator(cls):
        _DATAARRAY_ACCESSORS[name] = cls
        return cls

    return decorator


def register_dataset_accessor(name: str) -> Callable[[type], type]:
    def decorator(cls):
        _DATASET_ACCESSORS[name] = cls
        return cls

    return decorator


class _AccessorMixin:
    _accessor_registry: Dict[str, type] = {}

    def __getattr__(self, name):
        # only called when normal lookup fails
        registry = object.__getattribute__(self, "_accessor_registry")
        if name in registry:
            cache = self.__dict__.setdefault("_accessor_cache", {})
            if name not in cache:
                cache[name] = registry[name](self)
            return cache[name]
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")


# --------------------------------------------------------------------------------------
# DataArray
# --------------------------------------------------------------------------------------


class DataArray(_AccessorMixin):
    """Labeled N-D array: data + named dims + coords + attrs."""

    _accessor_registry = _DATAARRAY_ACCESSORS

    __array_priority__ = 50  # win over numpy in mixed binary ops

    def __init__(self, data, coords=None, dims=None, name=None, attrs=None, fastpath=False):
        if isinstance(data, DataArray):
            coords = coords if coords is not None else data._coords
            dims = dims if dims is not None else data.dims
            attrs = attrs if attrs is not None else dict(data.attrs)
            name = name if name is not None else data.name
            data = data.data
        if not hasattr(data, "ndim"):
            data = np.asarray(data)
        if dims is None:
            dims = tuple(f"dim_{i}" for i in range(data.ndim))
        elif isinstance(dims, str):
            dims = (dims,)
        else:
            dims = tuple(dims)
        if len(dims) != data.ndim:
            raise ValueError(f"dims {dims} do not match data ndim {data.ndim}")
        self._data = data
        self._dims = dims
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        if fastpath:
            self._coords = OrderedDict()
        else:
            self._coords = _normalize_coords(coords, dims, data.shape)
            self._check_coords()

    # -- basics ------------------------------------------------------------------

    def _check_coords(self):
        sizes = self.sizes
        for name, c in self._coords.items():
            for d, s in zip(c.dims, c.shape):
                if d in sizes and sizes[d] != s:
                    raise ValueError(
                        f"coordinate {name!r} dim {d!r} has size {s}, conflicting with data size {sizes[d]}"
                    )

    @property
    def data(self):
        return self._data

    @property
    def values(self) -> np.ndarray:
        return _to_numpy(self._data)

    @property
    def dims(self) -> Tuple[str, ...]:
        return self._dims

    @property
    def shape(self):
        return self._data.shape

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def size(self):
        return int(np.prod(self._data.shape)) if self._data.ndim else 1

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self._dims, self._data.shape))

    @property
    def coords(self) -> Coordinates:
        return Coordinates(self._coords)

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        header = f"<ndx.DataArray {self.name or ''} {tuple(zip(self.dims, self.shape))} dtype={self.dtype}>"
        coord_lines = [f"  * {k}: dims={v.dims}" for k, v in self._coords.items()]
        body = np.array2string(self.values, threshold=20)
        return "\n".join([header, *coord_lines, body])

    def copy(self, deep=False):
        data = self._data.copy() if (deep and isinstance(self._data, np.ndarray)) else self._data
        new = DataArray(data, dims=self._dims, name=self.name, attrs=_copy.deepcopy(self.attrs), fastpath=True)
        new._coords = OrderedDict(
            (k, v.copy(deep=deep)) for k, v in self._coords.items()
        )
        return new

    def rename(self, name=None, **dim_renames):
        new = self.copy()
        if isinstance(name, str) or name is None:
            if name is not None:
                new.name = name
        elif isinstance(name, dict):
            dim_renames = {**name, **dim_renames}
        if dim_renames:
            new._dims = tuple(dim_renames.get(d, d) for d in self._dims)
            newc = OrderedDict()
            for k, v in new._coords.items():
                v = v.copy()
                v._dims = tuple(dim_renames.get(d, d) for d in v._dims)
                newc[dim_renames.get(k, k)] = v
            new._coords = newc
        return new

    def item(self):
        return self.values.item()

    def astype(self, dtype):
        return self._replace(self._data.astype(dtype))

    def _replace(self, data, dims=None, drop_dims: Sequence[str] = ()) -> "DataArray":
        """New DataArray with same metadata; coords on dropped dims removed."""
        dims = self._dims if dims is None else tuple(dims)
        new = DataArray(data, dims=dims, name=self.name, attrs=dict(self.attrs), fastpath=True)
        keep = set(dims)
        for k, v in self._coords.items():
            if set(v.dims) <= keep and not (set(v.dims) & set(drop_dims)):
                new._coords[k] = v
            elif v.ndim == 0 and k not in drop_dims:
                new._coords[k] = v
        return new

    # -- numpy interop ------------------------------------------------------------

    def __array__(self, dtype=None, copy=None):
        v = self.values
        return v.astype(dtype) if dtype is not None else v

    # -- indexing ------------------------------------------------------------------

    def get_index(self, dim):
        if dim in self._coords and self._coords[dim].dims == (dim,):
            return self._coords[dim].values
        return np.arange(self.sizes[dim])

    def isel(self, indexers: Optional[Mapping[str, object]] = None, drop=False, **kw) -> "DataArray":
        indexers = {**(indexers or {}), **kw}
        key = []
        new_dims = []
        for d in self._dims:
            if d in indexers:
                idx = indexers[d]
                if isinstance(idx, DataArray):
                    idx = idx.values
                key.append(idx)
                if isinstance(idx, slice) or (hasattr(idx, "ndim") and np.ndim(idx) >= 1) or isinstance(idx, (list, tuple)):
                    new_dims.append(d)
            else:
                key.append(slice(None))
                new_dims.append(d)
        # use orthogonal (outer) indexing semantics like xarray
        data = self._data
        # apply one dim at a time to keep semantics orthogonal
        out = data
        axis_offset = 0
        result_dims = []
        for ax, (d, k) in enumerate(zip(self._dims, key)):
            cur_ax = ax - axis_offset
            if isinstance(k, slice):
                if k != slice(None):
                    sl = [slice(None)] * out.ndim
                    sl[cur_ax] = k
                    out = out[tuple(sl)]
                result_dims.append(d)
            elif np.ndim(k) == 0 and not isinstance(k, (list, tuple)):
                out = _take(out, int(k), cur_ax)
                axis_offset += 1
            else:
                kk = np.asarray(k)
                out = _take_arr(out, kk, cur_ax)
                result_dims.append(d)
        new = DataArray(out, dims=result_dims, name=self.name, attrs=dict(self.attrs), fastpath=True)
        # subset coords
        for cname, c in self._coords.items():
            if any(d in indexers and d not in result_dims for d in c.dims) and (drop or c.ndim > 0):
                # coord loses a dim -> index it; scalar coords kept unless drop
                pass
            sub_idx = {d: indexers[d] for d in c.dims if d in indexers}
            if sub_idx:
                csub = c.isel(**sub_idx)
                if cname in indexers and np.ndim(indexers[cname]) == 0 and drop:
                    continue
                new._coords[cname] = csub
            else:
                new._coords[cname] = c
        # drop scalar coords from dropped dims if drop=True
        if drop:
            new._coords = OrderedDict(
                (k, v) for k, v in new._coords.items() if v.ndim > 0 or k not in indexers
            )
        return new

    def sel(self, indexers=None, method=None, tolerance=None, **kw) -> "DataArray":
        indexers = {**(indexers or {}), **kw}
        iidx = {}
        for d, val in indexers.items():
            coord = self.get_index(d)
            if isinstance(val, slice):
                start, stop = val.start, val.stop
                lo = 0 if start is None else int(np.searchsorted(coord, start, side="left"))
                hi = len(coord) if stop is None else int(np.searchsorted(coord, stop, side="right"))
                iidx[d] = slice(lo, hi)
            else:
                vals = np.atleast_1d(np.asarray(val))
                if method in ("nearest", None):
                    pos = np.array([int(np.argmin(np.abs(coord - v))) for v in vals])
                    if method is None:
                        # require (near-)exact
                        for p, v in zip(pos, vals):
                            if not np.isclose(coord[p], v):
                                raise KeyError(f"value {v} not found in coord {d}")
                else:
                    raise NotImplementedError(f"sel method {method}")
                iidx[d] = pos if np.ndim(val) else int(pos[0])
        return self.isel(**iidx)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._coords[key]
        if isinstance(key, dict):
            return self.isel(**key)
        if not isinstance(key, tuple):
            key = (key,)
        indexers = {}
        for d, k in zip(self._dims, key):
            indexers[d] = k
        return self.isel(**indexers)

    # -- reductions ------------------------------------------------------------------

    def _axes(self, dim) -> Optional[Tuple[int, ...]]:
        if dim is None or dim is Ellipsis:
            return None
        if isinstance(dim, str):
            dim = (dim,)
        for d in dim:
            if d not in self._dims:
                raise ValueError(
                    f"Dimension {d!r} not found; this array has dimensions {tuple(self._dims)}"
                )
        return tuple(self._dims.index(d) for d in dim)

    def _reduce(self, func_nan, func, dim=None, skipna=None, keep_attrs=True, **kw) -> "DataArray":
        axes = self._axes(dim)
        xp = _xp(self._data)
        use_nan = skipna if skipna is not None else _is_float(self.dtype)
        f = getattr(xp, func_nan if use_nan else func)
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            data = f(self._data, axis=axes, **kw)
        if axes is None:
            rdims = ()
        else:
            rdims = tuple(d for i, d in enumerate(self._dims) if i not in axes)
        dropped = [d for d in self._dims if d not in rdims]
        out = self._replace(data, dims=rdims, drop_dims=dropped)
        if not keep_attrs:
            out.attrs = {}
        return out

    def mean(self, dim=None, skipna=None, **kw):
        return self._reduce("nanmean", "mean", dim, skipna, **kw)

    def std(self, dim=None, skipna=None, **kw):
        return self._reduce("nanstd", "std", dim, skipna, **kw)

    def var(self, dim=None, skipna=None, **kw):
        return self._reduce("nanvar", "var", dim, skipna, **kw)

    def min(self, dim=None, skipna=None, **kw):
        return self._reduce("nanmin", "min", dim, skipna, **kw)

    def max(self, dim=None, skipna=None, **kw):
        return self._reduce("nanmax", "max", dim, skipna, **kw)

    def sum(self, dim=None, skipna=None, **kw):
        return self._reduce("nansum", "sum", dim, skipna, **kw)

    def median(self, dim=None, skipna=None, **kw):
        return self._reduce("nanmedian", "median", dim, skipna, **kw)

    def count(self, dim=None):
        xp = _xp(self._data)
        if _is_float(self.dtype):
            valid = ~xp.isnan(self._data)
        else:
            valid = xp.ones(self.shape, dtype=bool)
        axes = self._axes(dim)
        data = valid.sum(axis=axes)
        rdims = () if axes is None else tuple(d for i, d in enumerate(self._dims) if i not in axes)
        return self._replace(data, dims=rdims, drop_dims=[d for d in self._dims if d not in rdims])

    def quantile(self, q, dim=None, skipna=None, **kw) -> "DataArray":
        axes = self._axes(dim)
        xp = _xp(self._data)
        use_nan = skipna if skipna is not None else _is_float(self.dtype)
        f = xp.nanquantile if use_nan else xp.quantile
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            data = f(self._data.astype(np.float64), np.asarray(q), axis=axes)
        qscalar = np.ndim(q) == 0
        if axes is None:
            rdims = ()
        else:
            rdims = tuple(d for i, d in enumerate(self._dims) if i not in axes)
        if qscalar:
            out_dims = rdims
        else:
            out_dims = ("quantile",) + tuple(rdims)
        dropped = [d for d in self._dims if d not in rdims]
        out = self._replace(data, dims=out_dims, drop_dims=dropped)
        out._coords["quantile"] = DataArray(
            np.asarray(q), dims=() if qscalar else ("quantile",), name="quantile", fastpath=True
        )
        return out

    def argmax(self, dim=None):
        axes = self._axes(dim)
        ax = axes[0] if axes else None
        data = _xp(self._data).argmax(self._data, axis=ax)
        rdims = tuple(d for d in self._dims if axes is None or self._dims.index(d) != ax) if ax is not None else ()
        return self._replace(data, dims=rdims, drop_dims=[d for d in self._dims if d not in rdims])

    def cumsum(self, dim=None, skipna=None):
        axes = self._axes(dim)
        ax = axes[0] if axes else None
        xp = _xp(self._data)
        use_nan = skipna if skipna is not None else _is_float(self.dtype)
        f = xp.nancumsum if use_nan else xp.cumsum
        return self._replace(f(self._data, axis=ax))

    # -- elementwise / conditional -----------------------------------------------------

    def where(self, cond, other=np.nan) -> "DataArray":
        cond_da = cond if isinstance(cond, DataArray) else DataArray(cond, dims=self._dims[: np.ndim(cond)])
        a, c = broadcast_arrays(self, cond_da)
        xp = _xp(a._data)
        oth = other.data if isinstance(other, DataArray) else other
        data = xp.where(c._data.astype(bool), a._data, oth)
        return a._replace(data)

    def fillna(self, value) -> "DataArray":
        xp = _xp(self._data)
        val = value.data if isinstance(value, DataArray) else value
        if not _is_float(self.dtype):
            return self.copy()
        return self._replace(xp.where(xp.isnan(self._data), val, self._data))

    def isnull(self) -> "DataArray":
        xp = _xp(self._data)
        if _is_float(self.dtype):
            return self._replace(xp.isnan(self._data))
        return self._replace(np.zeros(self.shape, dtype=bool))

    def notnull(self) -> "DataArray":
        out = self.isnull()
        return out._replace(~out._data)

    def clip(self, min=None, max=None):
        return self._replace(_xp(self._data).clip(self._data, min, max))

    def round(self, decimals=0):
        return self._replace(_xp(self._data).round(self._data, decimals))

    # -- shaping ------------------------------------------------------------------

    def transpose(self, *dims) -> "DataArray":
        if not dims:
            dims = tuple(reversed(self._dims))
        dims = tuple(dims)
        if Ellipsis in dims:
            listed = [d for d in dims if d is not Ellipsis]
            rest = [d for d in self._dims if d not in listed]
            pos = dims.index(Ellipsis)
            dims = tuple(listed[:pos]) + tuple(rest) + tuple(listed[pos:])
        axes = [self._dims.index(d) for d in dims]
        xp = _xp(self._data)
        return self._replace(xp.transpose(self._data, axes), dims=dims)

    def expand_dims(self, dim, axis=0) -> "DataArray":
        if isinstance(dim, str):
            dim = {dim: 1}
        elif isinstance(dim, (list, tuple)):
            dim = {d: 1 for d in dim}
        new = self
        for d, n in dim.items():
            xp = _xp(new._data)
            data = xp.expand_dims(new._data, axis)
            if n != 1:
                data = xp.repeat(data, n, axis=axis)
            dims = new._dims[:axis] + (d,) + new._dims[axis:]
            out = DataArray(data, dims=dims, name=new.name, attrs=dict(new.attrs), fastpath=True)
            out._coords = OrderedDict(new._coords)
            new = out
        return new

    def squeeze(self, dim=None) -> "DataArray":
        if dim is None:
            drop = [d for d, s in self.sizes.items() if s == 1]
        else:
            drop = [dim] if isinstance(dim, str) else list(dim)
        out = self
        for d in drop:
            out = out.isel(**{d: 0})
        return out

    def broadcast_like(self, other: "DataArray") -> "DataArray":
        a, _ = broadcast_arrays(self, other)
        return a

    def shift(self, shifts: Optional[Mapping[str, int]] = None, fill_value=np.nan, **kw) -> "DataArray":
        shifts = {**(shifts or {}), **kw}
        data = self._data
        xp = _xp(data)
        if _is_float(self.dtype) or not np.isnan(fill_value):
            pass
        for d, k in shifts.items():
            if k == 0:
                continue
            ax = self._dims.index(d)
            data = xp.roll(data, k, axis=ax)
            sl = [slice(None)] * data.ndim
            if k > 0:
                sl[ax] = slice(0, k)
            else:
                sl[ax] = slice(data.shape[ax] + k, None)
            if isinstance(data, np.ndarray):
                data = data.astype(np.float64) if not _is_float(data.dtype) else data.copy()
                data[tuple(sl)] = fill_value
            else:
                data = data.astype(xp.float32) if not _is_float(data.dtype) else data
                data = data.at[tuple(sl)].set(fill_value)
        return self._replace(data)

    def rolling(self, dim: Optional[Mapping[str, int]] = None, min_periods=None, center=False, **kw):
        windows = {**(dim or {}), **kw}
        if len(windows) != 1:
            raise NotImplementedError("rolling over exactly one dim supported")
        (d, w), = windows.items()
        return _Rolling(self, d, w, min_periods=min_periods, center=center)

    def interp(self, coords=None, method="linear", kwargs=None, **kw) -> "DataArray":
        """Pointwise/orthogonal linear interpolation along 1-D indexed dims.

        If all requested coords are DataArrays sharing the same dims, performs
        vectorized (pointwise) interpolation like xarray (used for transect
        sampling, reference pyorc/api/velocimetry.py:202).
        """
        targets = {**(coords or {}), **kw}
        fill = (kwargs or {}).get("fill_value", np.nan)
        da_targets = {k: v for k, v in targets.items() if isinstance(v, DataArray)}
        if da_targets and len(da_targets) == len(targets):
            tdims = next(iter(da_targets.values())).dims
            if all(v.dims == tdims for v in da_targets.values()):
                return self._interp_pointwise(targets, tdims, fill)
        out = self
        for d, tgt in targets.items():
            out = out._interp_orthogonal(d, tgt, fill)
        return out

    def _interp_orthogonal(self, dim, target, fill) -> "DataArray":
        coord = self.get_index(dim).astype(np.float64)
        tgt = np.atleast_1d(np.asarray(target, dtype=np.float64))
        scalar = np.ndim(target) == 0
        ax = self._dims.index(dim)
        vals = self.values.astype(np.float64)
        if len(coord) > 1 and coord[1] < coord[0]:
            # descending coordinate: flip data + coord to ascending
            coord = coord[::-1]
            vals = np.flip(vals, axis=ax)
        idx = np.clip(np.searchsorted(coord, tgt) - 1, 0, len(coord) - 2)
        x0, x1 = coord[idx], coord[idx + 1]
        wdenom = np.where(x1 > x0, x1 - x0, 1.0)
        w = (tgt - x0) / wdenom
        v0 = np.take(vals, idx, axis=ax)
        v1 = np.take(vals, idx + 1, axis=ax)
        shape = [1] * vals.ndim
        shape[ax] = len(tgt)
        wb = w.reshape(shape)
        out = v0 * (1 - wb) + v1 * wb
        oob = (tgt < coord[0]) | (tgt > coord[-1])
        if np.any(oob) and fill is not None and not (isinstance(fill, str) and fill == "extrapolate"):
            mask = oob.reshape(shape) & np.ones_like(out, dtype=bool)
            out = np.where(mask, fill, out)
        new = self._replace(out)
        new._coords[dim] = DataArray(tgt, dims=(dim,), name=dim, fastpath=True)
        if scalar:
            new = new.isel(**{dim: 0})
        return new

    def _interp_pointwise(self, targets, tdims, fill) -> "DataArray":
        # bilinear interpolation at scattered points over the indexed dims
        sample_dims = list(targets.keys())
        out_tpl = next(iter(targets.values()))
        vals = self.values.astype(np.float64)
        # move sample dims to the back
        other = [d for d in self._dims if d not in sample_dims]
        arr = np.transpose(vals, [self._dims.index(d) for d in other + sample_dims])
        frac = []
        for d in sample_dims:
            coord = self.get_index(d).astype(np.float64)
            t = np.asarray(targets[d].values, dtype=np.float64).ravel()
            # fractional index; np.interp needs ascending support points
            if len(coord) > 1 and coord[1] < coord[0]:
                fi = np.interp(t, coord[::-1], np.arange(len(coord))[::-1].astype(np.float64))
            else:
                fi = np.interp(t, coord, np.arange(len(coord), dtype=np.float64))
            lo = (t < coord.min()) | (t > coord.max())
            fi[lo] = np.nan
            frac.append(fi)
        out = _multilinear(arr, frac)  # shape other_dims + (npts,)
        out_shape = [self.sizes[d] for d in other] + list(out_tpl.shape)
        out = out.reshape(out_shape)
        new_dims = tuple(other) + tuple(out_tpl.dims)
        new = DataArray(out, dims=new_dims, name=self.name, attrs=dict(self.attrs), fastpath=True)
        for k, v in self._coords.items():
            if set(v.dims) <= set(other):
                new._coords[k] = v
        for k, v in out_tpl._coords.items():
            if set(v.dims) <= set(out_tpl.dims):
                new._coords[k] = v
        for k, t in targets.items():
            if k not in self._dims or True:
                new._coords[k] = DataArray(np.asarray(t.values), dims=t.dims, name=k, fastpath=True)
        return new

    def interpolate_na(self, dim, method="linear", fill_value=None) -> "DataArray":
        coord = self.get_index(dim).astype(np.float64)
        ax = self._dims.index(dim)
        vals = np.moveaxis(self.values.astype(np.float64), ax, -1)
        flat = vals.reshape(-1, vals.shape[-1])
        for row in flat:
            good = np.isfinite(row)
            if good.sum() >= 2:
                row[~good] = np.interp(coord[~good], coord[good], row[good])
            elif good.sum() == 1:
                row[~good] = row[good][0]
        out = np.moveaxis(flat.reshape(vals.shape), -1, ax)
        return self._replace(out)

    def ffill(self, dim) -> "DataArray":
        ax = self._dims.index(dim)
        vals = np.moveaxis(self.values.astype(np.float64), ax, -1)
        idx = np.where(np.isfinite(vals), np.arange(vals.shape[-1]), -1)
        idx = np.maximum.accumulate(idx, axis=-1)
        filled = np.where(idx >= 0, np.take_along_axis(vals, np.maximum(idx, 0), axis=-1), np.nan)
        return self._replace(np.moveaxis(filled, -1, ax))

    def bfill(self, dim) -> "DataArray":
        ax = self._dims.index(dim)
        rev = self.isel(**{dim: slice(None, None, -1)})
        out = rev.ffill(dim)
        return out.isel(**{dim: slice(None, None, -1)})._replace_coords_from(self)

    def _replace_coords_from(self, other: "DataArray") -> "DataArray":
        self._coords = OrderedDict(other._coords)
        return self

    def diff(self, dim, n=1) -> "DataArray":
        ax = self._dims.index(dim)
        xp = _xp(self._data)
        data = xp.diff(self._data, n=n, axis=ax)
        out = self._replace(data)
        # re-slice coords along dim
        for k, c in list(out._coords.items()):
            if dim in c.dims:
                out._coords[k] = c.isel(**{dim: slice(n, None)})
        return out

    def integrate(self, coord) -> "DataArray":
        # coord may be a dimension or a 1-D non-dimension coordinate (e.g.
        # "scoords" over dim "points", used for discharge integration)
        if coord in self._dims:
            dim = coord
            c = self.get_index(coord).astype(np.float64)
        else:
            cvar = self._coords[coord]
            dim = cvar.dims[0]
            c = cvar.values.astype(np.float64)
        ax = self._dims.index(dim)
        data = np.trapezoid(self.values, x=c, axis=ax)
        rdims = tuple(d for d in self._dims if d != dim)
        return self._replace(data, dims=rdims, drop_dims=[dim])

    def assign_coords(self, coords=None, **kw) -> "DataArray":
        new = self.copy()
        allc = {**(coords or {}), **kw}
        norm = _normalize_coords(allc, new._dims, new.shape)
        for k, v in norm.items():
            new._coords[k] = v
        return new

    def drop_vars(self, names, errors="raise") -> "DataArray":
        if isinstance(names, str):
            names = [names]
        new = self.copy()
        for n in names:
            if n in new._coords:
                del new._coords[n]
            elif errors == "raise":
                raise KeyError(n)
        return new

    # -- binary ops ------------------------------------------------------------------

    def _binop(self, other, op, reflexive=False):
        if isinstance(other, Dataset):
            return NotImplemented
        if isinstance(other, DataArray):
            a, b = broadcast_arrays(self, other)
            lhs, rhs = (b._data, a._data) if reflexive else (a._data, b._data)
            data = op(lhs, rhs)
            out = a._replace(data)
            out.name = self.name
            out.attrs = {}
            return out
        else:
            val = other
            lhs, rhs = (val, self._data) if reflexive else (self._data, val)
            data = op(lhs, rhs)
            out = self._replace(data)
            out.attrs = {}
            return out

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._binop(o, lambda a, b: a + b, True)

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: a - b, True)

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._binop(o, lambda a, b: a * b, True)

    def __truediv__(self, o):
        return self._binop(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._binop(o, lambda a, b: a / b, True)

    def __pow__(self, o):
        return self._binop(o, lambda a, b: a**b)

    def __rpow__(self, o):
        return self._binop(o, lambda a, b: a**b, True)

    def __mod__(self, o):
        return self._binop(o, lambda a, b: a % b)

    def __lt__(self, o):
        return self._binop(o, lambda a, b: a < b)

    def __le__(self, o):
        return self._binop(o, lambda a, b: a <= b)

    def __gt__(self, o):
        return self._binop(o, lambda a, b: a > b)

    def __ge__(self, o):
        return self._binop(o, lambda a, b: a >= b)

    def __eq__(self, o):  # noqa: D105
        return self._binop(o, lambda a, b: a == b)

    def __ne__(self, o):
        return self._binop(o, lambda a, b: a != b)

    __hash__ = None

    def __and__(self, o):
        return self._binop(o, lambda a, b: a & b)

    def __or__(self, o):
        return self._binop(o, lambda a, b: a | b)

    def __xor__(self, o):
        return self._binop(o, lambda a, b: a ^ b)

    def __invert__(self):
        return self._replace(~self._data)

    def __neg__(self):
        return self._replace(-self._data)

    def __abs__(self):
        return self._replace(abs(self._data))


def _take(arr, idx: int, axis: int):
    sl = [slice(None)] * arr.ndim
    sl[axis] = idx
    return arr[tuple(sl)]


def _take_arr(arr, idx: np.ndarray, axis: int):
    xp = _xp(arr)
    return xp.take(arr, idx, axis=axis)


def _multilinear(arr: np.ndarray, frac: Sequence[np.ndarray]) -> np.ndarray:
    """Multi-linear interpolation of `arr`'s last len(frac) axes at fractional indices."""
    nd = len(frac)
    npts = len(frac[0])
    out = np.zeros(arr.shape[: arr.ndim - nd] + (npts,), dtype=np.float64)
    i0s, ws, valid = [], [], np.ones(npts, dtype=bool)
    for k, f in enumerate(frac):
        n = arr.shape[arr.ndim - nd + k]
        valid &= np.isfinite(f)
        fi = np.where(np.isfinite(f), f, 0.0)
        i0 = np.clip(np.floor(fi).astype(int), 0, n - 2) if n > 1 else np.zeros(npts, int)
        w = fi - i0
        i0s.append(i0)
        ws.append(w)
    for corner in range(2**nd):
        weight = np.ones(npts)
        idx = []
        for k in range(nd):
            bit = (corner >> k) & 1
            n = arr.shape[arr.ndim - nd + k]
            ik = np.minimum(i0s[k] + bit, n - 1)
            idx.append(ik)
            weight = weight * (ws[k] if bit else (1 - ws[k]))
        gathered = arr[(...,) + tuple(idx)]
        out += gathered * weight
    out[..., ~valid] = np.nan
    return out


class _Rolling:
    def __init__(self, obj: DataArray, dim: str, window: int, min_periods=None, center=False):
        self.obj = obj
        self.dim = dim
        self.window = window
        self.min_periods = min_periods if min_periods is not None else window
        self.center = center

    def _apply(self, func_nan: str) -> DataArray:
        ax = self.obj._dims.index(self.dim)
        vals = np.moveaxis(self.obj.values.astype(np.float64), ax, -1)
        n = vals.shape[-1]
        w = self.window
        pad = np.full(vals.shape[:-1] + (w - 1,), np.nan)
        padded = np.concatenate([pad, vals], axis=-1)
        windows = np.lib.stride_tricks.sliding_window_view(padded, w, axis=-1)
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            out = getattr(np, func_nan)(windows, axis=-1)
            cnt = np.isfinite(windows).sum(axis=-1)
        out = np.where(cnt >= self.min_periods, out, np.nan)
        if self.center:
            shift = (w - 1) // 2 + ((w - 1) % 2)
            out = np.concatenate([out[..., shift:], np.full(vals.shape[:-1] + (shift,), np.nan)], axis=-1)
        out = np.moveaxis(out, -1, ax)
        return self.obj._replace(out)

    def mean(self):
        return self._apply("nanmean")

    def max(self):
        return self._apply("nanmax")

    def min(self):
        return self._apply("nanmin")

    def median(self):
        return self._apply("nanmedian")

    def sum(self):
        return self._apply("nansum")

    def count(self):
        ax = self.obj._dims.index(self.dim)
        vals = np.moveaxis(self.obj.values.astype(np.float64), ax, -1)
        w = self.window
        pad = np.full(vals.shape[:-1] + (w - 1,), np.nan)
        padded = np.concatenate([pad, vals], axis=-1)
        windows = np.lib.stride_tricks.sliding_window_view(padded, w, axis=-1)
        cnt = np.isfinite(windows).sum(axis=-1).astype(np.float64)
        cnt = np.moveaxis(cnt, -1, ax)
        return self.obj._replace(cnt)


def broadcast_arrays(a: DataArray, b: DataArray) -> Tuple[DataArray, DataArray]:
    """Broadcast two DataArrays against each other by dim names (xarray semantics)."""
    out_dims = tuple(a.dims) + tuple(d for d in b.dims if d not in a.dims)
    sizes = {**b.sizes, **a.sizes}

    def expand(x: DataArray) -> DataArray:
        xp = _xp(x._data)
        # insert missing dims as size-1, ordered per out_dims
        data = x._data
        cur = list(x.dims)
        for d in out_dims:
            if d not in cur:
                data = xp.expand_dims(data, axis=len(cur))
                cur.append(d)
        perm = [cur.index(d) for d in out_dims]
        data = xp.transpose(data, perm)
        data = xp.broadcast_to(data, tuple(sizes[d] for d in out_dims))
        out = DataArray(data, dims=out_dims, name=x.name, attrs=dict(x.attrs), fastpath=True)
        for k, v in {**b._coords, **a._coords, **x._coords}.items():
            if set(v.dims) <= set(out_dims):
                out._coords[k] = v
        return out

    return expand(a), expand(b)


def concat(objs: Sequence[Union[DataArray, "Dataset"]], dim: str) -> Union[DataArray, "Dataset"]:
    objs = list(objs)
    if isinstance(objs[0], Dataset):
        names = list(objs[0].data_vars)
        return Dataset(
            {n: concat([o[n] for o in objs], dim) for n in names},
            attrs=dict(objs[0].attrs),
        )
    first = objs[0]
    xp = _xp(first._data)
    if dim in first.dims:
        ax = first.dims.index(dim)
        data = xp.concatenate([o._data for o in objs], axis=ax)
        out = first._replace(data)
        coord_vals = []
        has_coord = all(dim in o._coords for o in objs)
        if has_coord:
            coord_vals = np.concatenate([np.atleast_1d(o._coords[dim].values) for o in objs])
            out._coords[dim] = DataArray(coord_vals, dims=(dim,), name=dim, fastpath=True)
        for k, c in first._coords.items():
            if k != dim and dim in c.dims:
                cax = c.dims.index(dim)
                out._coords[k] = DataArray(
                    np.concatenate([o._coords[k].values for o in objs], axis=cax),
                    dims=c.dims,
                    name=k,
                    fastpath=True,
                )
        return out
    else:
        data = xp.stack([o._data for o in objs], axis=0)
        out = DataArray(data, dims=(dim,) + first.dims, name=first.name, attrs=dict(first.attrs), fastpath=True)
        out._coords = OrderedDict(first._coords)
        if all(dim in o._coords for o in objs):
            out._coords[dim] = DataArray(
                np.array([o._coords[dim].values for o in objs]), dims=(dim,), name=dim, fastpath=True
            )
        return out


# --------------------------------------------------------------------------------------
# Dataset
# --------------------------------------------------------------------------------------


class Dataset(_AccessorMixin):
    """Dict of DataArrays sharing dims/coords (mini xr.Dataset)."""

    _accessor_registry = _DATASET_ACCESSORS

    def __init__(self, data_vars=None, coords=None, attrs=None):
        self._variables: "OrderedDict[str, DataArray]" = OrderedDict()
        self.attrs = dict(attrs) if attrs else {}
        self.encoding: Dict[str, dict] = {}
        data_vars = data_vars or {}
        for name, v in data_vars.items():
            if isinstance(v, DataArray):
                da = v.copy()
                da.name = name
            elif isinstance(v, tuple):
                dims = (v[0],) if isinstance(v[0], str) else tuple(v[0])
                da = DataArray(v[1], dims=dims, name=name, attrs=dict(v[2]) if len(v) > 2 else None)
            else:
                da = DataArray(v, name=name)
            self._variables[name] = da
        self._coords: "OrderedDict[str, DataArray]" = OrderedDict()
        if coords:
            sizes = self.sizes
            norm = _normalize_coords(coords, tuple(sizes.keys()), tuple(sizes.values()))
            self._coords.update(norm)
        # hoist coords present on member arrays
        for da in self._variables.values():
            for k, c in da._coords.items():
                self._coords.setdefault(k, c)
        # push shared coords back down
        self._sync_coords()

    def _sync_coords(self):
        for da in self._variables.values():
            for k, c in self._coords.items():
                if set(c.dims) <= set(da.dims):
                    da._coords[k] = c
                elif c.ndim == 0:
                    da._coords[k] = c

    # -- dict-ish ------------------------------------------------------------------

    @property
    def data_vars(self):
        return dict(self._variables)

    @property
    def coords(self) -> Coordinates:
        return Coordinates(self._coords)

    @property
    def dims(self) -> Dict[str, int]:
        return self.sizes

    @property
    def sizes(self) -> Dict[str, int]:
        sizes: Dict[str, int] = {}
        for da in self._variables.values():
            sizes.update(da.sizes)
        for c in self._coords.values():
            sizes.update(c.sizes)
        return sizes

    def __getitem__(self, key) -> DataArray:
        if isinstance(key, (list, tuple)):
            return Dataset({k: self._variables[k] for k in key}, attrs=dict(self.attrs))
        if key in self._variables:
            return self._variables[key]
        if key in self._coords:
            return self._coords[key]
        raise KeyError(key)

    def __setitem__(self, key, value):
        if isinstance(value, DataArray):
            da = value.copy()
            da.name = key
        elif isinstance(value, tuple):
            dims = (value[0],) if isinstance(value[0], str) else tuple(value[0])
            da = DataArray(value[1], dims=dims, name=key, attrs=dict(value[2]) if len(value) > 2 else None)
        else:
            da = DataArray(value, name=key)
        self._variables[key] = da
        for k, c in da._coords.items():
            self._coords.setdefault(k, c)
        self._sync_coords()

    def __delitem__(self, key):
        del self._variables[key]

    def __contains__(self, key):
        return key in self._variables or key in self._coords

    def __iter__(self):
        return iter(self._variables)

    def __len__(self):
        return len(self._variables)

    def __repr__(self):
        lines = [f"<ndx.Dataset> dims={self.sizes}"]
        lines.append("Coordinates:")
        for k, c in self._coords.items():
            lines.append(f"  * {k} {c.dims} {c.shape}")
        lines.append("Data variables:")
        for k, v in self._variables.items():
            lines.append(f"    {k} {v.dims} {v.shape} {v.dtype}")
        if self.attrs:
            lines.append(f"Attributes: {list(self.attrs)}")
        return "\n".join(lines)

    def keys(self):
        return self._variables.keys()

    def values(self):
        return self._variables.values()

    def items(self):
        return self._variables.items()

    def copy(self, deep=False) -> "Dataset":
        new = Dataset(attrs=_copy.deepcopy(self.attrs))
        new._variables = OrderedDict((k, v.copy(deep=deep)) for k, v in self._variables.items())
        new._coords = OrderedDict((k, v.copy(deep=deep)) for k, v in self._coords.items())
        new.encoding = _copy.deepcopy(self.encoding)
        new._sync_coords()
        return new

    # -- ops applied per-variable ------------------------------------------------------

    def _map(self, fn: Callable[[DataArray], DataArray], coord_fn=None) -> "Dataset":
        new = Dataset(attrs=dict(self.attrs))
        new._variables = OrderedDict((k, fn(v)) for k, v in self._variables.items())
        if coord_fn is None:
            # keep coords consistent with mapped variables
            alldims = set()
            for v in new._variables.values():
                alldims |= set(v.dims)
            for k, c in self._coords.items():
                if set(c.dims) <= alldims:
                    new._coords[k] = c
            for v in new._variables.values():
                for k, c in v._coords.items():
                    new._coords.setdefault(k, c)
        else:
            new._coords = OrderedDict((k, coord_fn(v)) for k, v in self._coords.items())
        new.encoding = _copy.deepcopy(self.encoding)
        new._sync_coords()
        return new

    def isel(self, indexers=None, drop=False, **kw) -> "Dataset":
        indexers = {**(indexers or {}), **kw}

        def f(v: DataArray) -> DataArray:
            sub = {d: i for d, i in indexers.items() if d in v.dims}
            return v.isel(**sub, drop=drop) if sub else v.copy()

        new = self._map(f, coord_fn=f)
        if drop:
            new._coords = OrderedDict((k, v) for k, v in new._coords.items() if v.ndim > 0 or k not in indexers)
        new._sync_coords()
        return new

    def sel(self, indexers=None, method=None, **kw) -> "Dataset":
        indexers = {**(indexers or {}), **kw}
        iidx = {}
        for d, val in indexers.items():
            ref = None
            for v in list(self._variables.values()) + list(self._coords.values()):
                if d in v.dims:
                    ref = v
                    break
            coord = self._coords[d].values if d in self._coords else np.arange(ref.sizes[d])
            if isinstance(val, slice):
                lo = 0 if val.start is None else int(np.searchsorted(coord, val.start, "left"))
                hi = len(coord) if val.stop is None else int(np.searchsorted(coord, val.stop, "right"))
                iidx[d] = slice(lo, hi)
            else:
                vals = np.atleast_1d(np.asarray(val))
                pos = np.array([int(np.argmin(np.abs(coord - v))) for v in vals])
                iidx[d] = pos if np.ndim(val) else int(pos[0])
        return self.isel(**iidx)

    def mean(self, dim=None, skipna=None, **kw) -> "Dataset":
        return self._reduce("mean", dim, skipna, **kw)

    def std(self, dim=None, skipna=None, **kw) -> "Dataset":
        return self._reduce("std", dim, skipna, **kw)

    def min(self, dim=None, skipna=None, **kw) -> "Dataset":
        return self._reduce("min", dim, skipna, **kw)

    def max(self, dim=None, skipna=None, **kw) -> "Dataset":
        return self._reduce("max", dim, skipna, **kw)

    def sum(self, dim=None, skipna=None, **kw) -> "Dataset":
        return self._reduce("sum", dim, skipna, **kw)

    def median(self, dim=None, skipna=None, **kw) -> "Dataset":
        return self._reduce("median", dim, skipna, **kw)

    def count(self, dim=None) -> "Dataset":
        return self._map(lambda v: v.count(dim=dim if (dim is None or dim in v.dims) else None))

    def _reduce(self, op, dim, skipna, **kw) -> "Dataset":
        # unknown dims fail loudly (variables merely lacking the dim are
        # skipped, matching xarray); a silent no-op hides typos
        for d in (dim,) if isinstance(dim, str) else (dim or ()):
            if d is not Ellipsis and d not in self.sizes:
                raise ValueError(
                    f"Dimension {d!r} not found; this dataset has dimensions {tuple(self.sizes)}"
                )

        def f(v: DataArray) -> DataArray:
            if dim is None or (isinstance(dim, str) and dim in v.dims) or (
                isinstance(dim, (list, tuple)) and all(d in v.dims for d in dim)
            ):
                return getattr(v, op)(dim=dim, skipna=skipna, **kw)
            return v.copy()

        return self._map(f)

    def quantile(self, q, dim=None, skipna=None, **kw) -> "Dataset":
        def f(v: DataArray) -> DataArray:
            return v.quantile(q, dim=dim, skipna=skipna, **kw)

        return self._map(f)

    def rolling(self, dim=None, min_periods=None, center=False, **kw):
        return _DatasetRolling(self, {**(dim or {}), **kw}, min_periods, center)

    def where(self, cond, other=np.nan) -> "Dataset":
        return self._map(lambda v: v.where(cond if not isinstance(cond, Dataset) else cond[v.name], other))

    def _binop(self, other, op) -> "Dataset":
        if isinstance(other, Dataset):
            return self._map(lambda v: op(v, other[v.name]))
        return self._map(lambda v: op(v, other))

    def __gt__(self, o):
        return self._binop(o, lambda a, b: a > b)

    def __ge__(self, o):
        return self._binop(o, lambda a, b: a >= b)

    def __lt__(self, o):
        return self._binop(o, lambda a, b: a < b)

    def __le__(self, o):
        return self._binop(o, lambda a, b: a <= b)

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b)

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b)

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b)

    def __truediv__(self, o):
        return self._binop(o, lambda a, b: a / b)

    def fillna(self, value) -> "Dataset":
        if isinstance(value, Dataset):
            return self._map(lambda v: v.fillna(value[v.name]) if v.name in value else v.copy())
        return self._map(lambda v: v.fillna(value))

    def interp(self, coords=None, method="linear", kwargs=None, **kw) -> "Dataset":
        targets = {**(coords or {}), **kw}

        def f(v: DataArray) -> DataArray:
            sub = {d: t for d, t in targets.items() if d in v.dims}
            return v.interp(sub, method=method, kwargs=kwargs) if sub else v.copy()

        return self._map(f)

    def shift(self, shifts=None, fill_value=np.nan, **kw) -> "Dataset":
        shifts = {**(shifts or {}), **kw}

        def f(v: DataArray) -> DataArray:
            sub = {d: s for d, s in shifts.items() if d in v.dims}
            return v.shift(sub, fill_value=fill_value) if sub else v.copy()

        return self._map(f)

    def transpose(self, *dims) -> "Dataset":
        def f(v: DataArray) -> DataArray:
            sub = [d for d in dims if d in v.dims]
            return v.transpose(*sub) if sub else v.copy()

        return self._map(f)

    def assign_coords(self, coords=None, **kw) -> "Dataset":
        new = self.copy()
        allc = {**(coords or {}), **kw}
        sizes = new.sizes
        norm = _normalize_coords(allc, tuple(sizes.keys()), tuple(sizes.values()))
        for k, v in norm.items():
            new._coords[k] = v
        new._sync_coords()
        return new

    def drop_vars(self, names, errors="raise") -> "Dataset":
        if isinstance(names, str):
            names = [names]
        new = self.copy()
        for n in names:
            if n in new._variables:
                del new._variables[n]
            elif n in new._coords:
                del new._coords[n]
                for v in new._variables.values():
                    v._coords.pop(n, None)
            elif errors == "raise":
                raise KeyError(n)
        return new

    def rename(self, renames=None, **kw) -> "Dataset":
        renames = {**(renames or {}), **kw}
        new = Dataset(attrs=dict(self.attrs))
        for k, v in self._variables.items():
            nv = v.rename({d: renames[d] for d in v.dims if d in renames}) if any(
                d in renames for d in v.dims
            ) else v.copy()
            nv.name = renames.get(k, k)
            new._variables[renames.get(k, k)] = nv
        for k, c in self._coords.items():
            nc = c.rename({d: renames[d] for d in c.dims if d in renames}) if any(
                d in renames for d in c.dims
            ) else c.copy()
            new._coords[renames.get(k, k)] = nc
        new._sync_coords()
        return new

    def merge(self, other: "Dataset") -> "Dataset":
        new = self.copy()
        for k, v in other._variables.items():
            new._variables[k] = v.copy()
        for k, c in other._coords.items():
            new._coords.setdefault(k, c)
        new._sync_coords()
        return new

    # netCDF round-trip -----------------------------------------------------------

    def to_netcdf(self, path, mode="w", encoding=None):
        from .io.netcdf import write_netcdf

        write_netcdf(self, path, mode=mode, encoding=encoding)

    def close(self):
        pass

    def load(self):
        return self

    def compute(self):
        return self


class _DatasetRolling:
    def __init__(self, ds: Dataset, windows, min_periods, center):
        self.ds = ds
        self.windows = windows
        self.min_periods = min_periods
        self.center = center

    def _apply(self, op: str) -> Dataset:
        def f(v: DataArray) -> DataArray:
            sub = {d: w for d, w in self.windows.items() if d in v.dims}
            if not sub:
                return v.copy()
            return getattr(v.rolling(sub, min_periods=self.min_periods, center=self.center), op)()

        return self.ds._map(f)

    def mean(self):
        return self._apply("mean")

    def max(self):
        return self._apply("max")

    def min(self):
        return self._apply("min")

    def median(self):
        return self._apply("median")

    def sum(self):
        return self._apply("sum")


def open_dataset(path, **kw) -> Dataset:
    from .io.netcdf import read_netcdf

    return read_netcdf(path, **kw)
