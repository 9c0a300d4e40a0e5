"""netCDF-4 reader/writer over h5py.

netCDF-4 files are HDF5 files following conventions (dimension scales,
``_NCProperties``, CF attributes). The reference stack uses the netCDF4/xarray
libraries for this (e.g. reference ``pyorc/api/velocimetry.py:239-253`` sets
int16 + scale_factor encoding, written via ``Dataset.to_netcdf``); neither is
in this image, so we speak the format directly through h5py (imported inside
the functions: the package imports without it). Reading handles
CF ``scale_factor``/``add_offset``/``_FillValue`` decoding; writing produces
files that netCDF4/xarray (and QGIS, for UGRID) can open.
"""

from __future__ import annotations

import numpy as np

from .. import ndx

# attrs that are HDF5 bookkeeping, not user metadata
_HIDDEN_ATTRS = {
    "DIMENSION_LIST",
    "REFERENCE_LIST",
    "CLASS",
    "NAME",
    "_Netcdf4Dimid",
    "_Netcdf4Coordinates",
    "_NCProperties",
}

_CF_ENCODING_ATTRS = {"scale_factor", "add_offset", "_FillValue", "dtype", "zlib", "complevel"}


def _decode_attr(v):
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="replace")
    if isinstance(v, np.bytes_):
        return bytes(v).decode("utf-8", errors="replace")
    if isinstance(v, np.ndarray) and v.dtype.kind == "S":
        return [bytes(x).decode("utf-8") for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def _get_dims(h5ds, f) -> tuple:
    """Resolve dimension names for a dataset via DIMENSION_LIST / dimension scales."""
    dims = []
    if "DIMENSION_LIST" in h5ds.attrs:
        import h5py

        refs = h5ds.attrs["DIMENSION_LIST"]
        for i, reflist in enumerate(refs):
            name = None
            for ref in reflist:
                try:
                    scale = f[ref]
                    name = scale.name.lstrip("/")
                    break
                except Exception:
                    continue
            dims.append(name if name else f"phony_dim_{i}")
    else:
        dims = [f"phony_dim_{i}" for i in range(h5ds.ndim)]
    return tuple(dims)


def read_netcdf(path, decode_cf=True, group=None) -> "ndx.Dataset":
    import h5py

    with h5py.File(path, "r") as f:
        root = f[group] if group else f
        ds = ndx.Dataset(attrs={k: _decode_attr(v) for k, v in root.attrs.items() if k not in _HIDDEN_ATTRS})
        # First pass: find coordinate variables (dimension scales)
        names = [k for k in root.keys() if isinstance(root[k], h5py.Dataset)]
        is_scale = {}
        for k in names:
            obj = root[k]
            is_scale[k] = obj.attrs.get("CLASS", b"") == b"DIMENSION_SCALE"
        arrays = {}
        for k in names:
            obj = root[k]
            raw = obj[()]
            attrs = {ak: _decode_attr(av) for ak, av in obj.attrs.items() if ak not in _HIDDEN_ATTRS}
            if is_scale[k] and obj.ndim == 1:
                dims = (k,)  # a 1-D dimension scale indexes itself
            else:
                dims = _get_dims(obj, f)
            encoding = {}
            if decode_cf and ("scale_factor" in attrs or "add_offset" in attrs or "_FillValue" in attrs):
                scale = attrs.pop("scale_factor", 1.0)
                offset = attrs.pop("add_offset", 0.0)
                fill = attrs.pop("_FillValue", None)
                encoding = {"scale_factor": scale, "add_offset": offset, "_FillValue": fill, "dtype": str(raw.dtype)}
                if scale != 1.0 or offset != 0.0 or (fill is not None and np.issubdtype(raw.dtype, np.integer)):
                    data = raw.astype(np.float64) * scale + offset
                    if fill is not None:
                        data = np.where(raw == fill, np.nan, data)
                    raw = data.astype(np.float32) if raw.dtype.itemsize <= 4 else data
                elif fill is not None and np.issubdtype(raw.dtype, np.floating):
                    raw = np.where(raw == fill, np.nan, raw) if not np.isnan(fill) else raw
            if raw.dtype.kind == "S":
                raw = raw.astype(str)
            arrays[k] = (dims, raw, attrs, encoding)
        # coordinates: dimension scales + anything listed in "coordinates" attrs
        aux_coords = set()
        for k, (dims, raw, attrs, enc) in arrays.items():
            c = attrs.get("coordinates", "")
            if isinstance(c, str):
                aux_coords.update(c.split())
        for k, (dims, raw, attrs, enc) in arrays.items():
            da = ndx.DataArray(raw, dims=dims, attrs=attrs, name=k)
            if is_scale.get(k) or k in aux_coords:
                ds._coords[k] = da
            else:
                ds._variables[k] = da
            if enc:
                ds.encoding[k] = enc
        ds._sync_coords()
        return ds


def write_netcdf(ds: "ndx.Dataset", path, mode="w", encoding=None):
    """Write an ndx.Dataset as a netCDF-4 (HDF5) file."""
    import h5py

    encoding = {**ds.encoding, **(encoding or {})}
    with h5py.File(path, mode) as f:
        f.attrs["_NCProperties"] = np.bytes_(b"version=2,netcdf=4.8.1,hdf5=1.12.2")
        for k, v in ds.attrs.items():
            _write_attr(f, k, v)
        # collect all dims & sizes
        sizes = ds.sizes
        # coordinate variables that index a dim get written as dimension scales
        dim_coords = {k: c for k, c in ds._coords.items() if c.dims == (k,)}
        created = {}
        for d, n in sizes.items():
            if d in dim_coords:
                c = dim_coords[d]
                h = f.create_dataset(d, data=c.values)
                for ak, av in c.attrs.items():
                    _write_attr(h, ak, av)
            else:
                # phony dimension: pure scale without data
                h = f.create_dataset(d, shape=(n,), dtype="f4")
                h.attrs["NAME"] = np.bytes_(
                    f"This is a netCDF dimension but not a netCDF variable.{n:10d}".encode()
                )
            h.make_scale(d)
            created[d] = h
        aux_coords = {k: c for k, c in ds._coords.items() if k not in dim_coords}

        def write_var(name, da, extra_attrs=None):
            enc = encoding.get(name, {})
            data = da.values
            attrs = dict(da.attrs)
            if extra_attrs:
                attrs.update(extra_attrs)
            fill = enc.get("_FillValue")
            if "scale_factor" in enc or "add_offset" in enc:
                scale = enc.get("scale_factor", 1.0)
                offset = enc.get("add_offset", 0.0)
                tgt = np.dtype(enc.get("dtype", "int16"))
                packed = (data - offset) / scale
                if fill is None and np.issubdtype(tgt, np.integer):
                    fill = np.iinfo(tgt).min
                packed = np.where(np.isfinite(data), packed, fill)
                data = np.round(packed).astype(tgt)
                attrs["scale_factor"] = scale
                if offset:
                    attrs["add_offset"] = offset
                attrs["_FillValue"] = np.dtype(tgt).type(fill)
            elif fill is not None:
                attrs["_FillValue"] = fill
            kw = {}
            if enc.get("zlib"):
                kw = dict(compression="gzip", compression_opts=enc.get("complevel", 4), chunks=True)
            h = f.create_dataset(name, data=data, **kw)
            for i, d in enumerate(da.dims):
                h.dims[i].attach_scale(created[d])
            for ak, av in attrs.items():
                _write_attr(h, ak, av)
            return h

        for name, c in aux_coords.items():
            write_var(name, c)
        for name, da in ds._variables.items():
            extra = {}
            cnames = [k for k, c in aux_coords.items() if set(c.dims) <= set(da.dims)]
            if cnames and "coordinates" not in da.attrs:
                extra["coordinates"] = " ".join(cnames)
            write_var(name, da, extra)


def _write_attr(h, key, val):
    if isinstance(val, str):
        h.attrs[key] = np.bytes_(val.encode("utf-8"))
    elif isinstance(val, (list, tuple)) and val and isinstance(val[0], str):
        h.attrs[key] = np.array([np.bytes_(s.encode()) for s in val])
    elif val is None:
        h.attrs[key] = np.bytes_(b"None")
    else:
        h.attrs[key] = val
