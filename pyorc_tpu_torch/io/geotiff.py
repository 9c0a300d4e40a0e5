"""Minimal GeoTIFF writer in pure Python (struct-level), replacing rasterio: a copy of
:mod:`pyorc_tpu.io.geotiff`, so that both packages write the same bytes.

Writes striped, uncompressed (or deflate) GeoTIFFs with a full
ModelTransformation tag (supports the rotated grids our AOIs produce) and a
GeoKeyDirectory referencing the CRS EPSG code. Readable by GDAL/QGIS/rasterio.
Reference counterpart: ``pyorc/io.py:141-163`` (to_geotiff via rasterio).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

__all__ = ["write_geotiff"]

# TIFF tag ids
_TAGS = {
    "ImageWidth": 256,
    "ImageLength": 257,
    "BitsPerSample": 258,
    "Compression": 259,
    "PhotometricInterpretation": 262,
    "StripOffsets": 273,
    "SamplesPerPixel": 277,
    "RowsPerStrip": 278,
    "StripByteCounts": 279,
    "PlanarConfiguration": 284,
    "SampleFormat": 339,
    "ModelPixelScale": 33550,
    "ModelTiepoint": 33922,
    "ModelTransformation": 34264,
    "GeoKeyDirectory": 34735,
    "GDALNodata": 42113,
}

_SAMPLE_FORMAT = {"u": 1, "i": 2, "f": 3}


def write_geotiff(fn, data: np.ndarray, transform, crs=None, nodata: Optional[float] = None, compress=None):
    """Write (rows, cols[, bands]) array as GeoTIFF.

    transform: Affine in our (dx_col, dy_col, x0, dx_row, dy_row, y0) layout
    (see geom.affine); crs: anything CRS.from_user_input accepts.
    """
    data = np.atleast_3d(np.asarray(data))
    rows, cols, bands = data.shape
    dt = data.dtype
    bits = dt.itemsize * 8
    fmt = _SAMPLE_FORMAT[dt.kind]

    t = tuple(transform)
    # GDAL-style geotransform: x = x0 + col*dx_col + row*dx_row (corner-based)
    model_transformation = [
        t[0], t[1], 0.0, t[2],
        t[3], t[4], 0.0, t[5],
        0.0, 0.0, 0.0, 0.0,
        0.0, 0.0, 0.0, 1.0,
    ]
    # NB our affine layout stores (dx_col, dy_col, x0, dx_row, dy_row, y0) with
    # x depending on t[0](col) and t[1](row): the matrix rows above must map
    # (col,row,0,1) -> (x,y): x = t0*col + t1*row + t2 ; y = t3*col + t4*row + t5
    epsg = None
    if crs is not None:
        from ..geom.crs import CRS

        c = CRS.from_user_input(crs)
        epsg = c.epsg

    # interleave bands (chunky)
    pix = np.ascontiguousarray(np.moveaxis(data, -1, -1))  # (rows, cols, bands)
    raw = pix.tobytes()
    if compress in ("deflate", "zlib"):
        strips = [zlib.compress(raw)]
        compression = 8
    else:
        strips = [raw]
        compression = 1

    entries = []

    def entry(tag, typ, count, value_or_offset):
        entries.append((tag, typ, count, value_or_offset))

    extra_chunks = []  # (placeholder_index, bytes) appended after IFD

    header_size = 8
    # we will assemble: header | IFD | extra data | strip data
    # first pass to build entries with deferred offsets
    def defer(data_bytes):
        extra_chunks.append(bytearray(data_bytes))
        return len(extra_chunks) - 1

    TYPE_SHORT, TYPE_LONG, TYPE_DOUBLE, TYPE_ASCII = 3, 4, 12, 2

    entry(_TAGS["ImageWidth"], TYPE_LONG, 1, cols)
    entry(_TAGS["ImageLength"], TYPE_LONG, 1, rows)
    if bands == 1:
        entry(_TAGS["BitsPerSample"], TYPE_SHORT, 1, bits)
    else:
        entry(_TAGS["BitsPerSample"], TYPE_SHORT, bands, ("defer", defer(struct.pack(f"<{bands}H", *([bits] * bands)))))
    entry(_TAGS["Compression"], TYPE_SHORT, 1, compression)
    entry(_TAGS["PhotometricInterpretation"], TYPE_SHORT, 1, 1)
    entry(_TAGS["StripOffsets"], TYPE_LONG, 1, ("strip", 0))
    entry(_TAGS["SamplesPerPixel"], TYPE_SHORT, 1, bands)
    entry(_TAGS["RowsPerStrip"], TYPE_LONG, 1, rows)
    entry(_TAGS["StripByteCounts"], TYPE_LONG, 1, len(strips[0]))
    entry(_TAGS["PlanarConfiguration"], TYPE_SHORT, 1, 1)
    if bands == 1:
        entry(_TAGS["SampleFormat"], TYPE_SHORT, 1, fmt)
    else:
        entry(_TAGS["SampleFormat"], TYPE_SHORT, bands, ("defer", defer(struct.pack(f"<{bands}H", *([fmt] * bands)))))
    entry(
        _TAGS["ModelTransformation"],
        TYPE_DOUBLE,
        16,
        ("defer", defer(struct.pack("<16d", *model_transformation))),
    )
    if epsg is not None:
        # GeoKeyDirectory: version 1.1.0, 3 keys: model type (projected), raster type, ProjectedCSType
        keys = [
            (1, 1, 0, 3),
            (1024, 0, 1, 1),  # GTModelTypeGeoKey = projected
            (1025, 0, 1, 1),  # GTRasterTypeGeoKey = PixelIsArea
            (3072, 0, 1, epsg),  # ProjectedCSTypeGeoKey
        ]
        flat = [v for k in keys for v in k]
        entry(_TAGS["GeoKeyDirectory"], TYPE_SHORT, len(flat), ("defer", defer(struct.pack(f"<{len(flat)}H", *flat))))
    if nodata is not None:
        s = (f"{nodata}").encode() + b"\x00"
        entry(_TAGS["GDALNodata"], TYPE_ASCII, len(s), ("defer", defer(s)))

    entries.sort(key=lambda e: e[0])
    ifd_size = 2 + len(entries) * 12 + 4
    extra_offset = header_size + ifd_size
    # compute offsets of extra chunks
    chunk_offsets = []
    off = extra_offset
    for ch in extra_chunks:
        chunk_offsets.append(off)
        off += len(ch)
        if off % 2:
            off += 1
    strip_offset = off

    out = bytearray()
    out += struct.pack("<2sHI", b"II", 42, header_size)
    out += struct.pack("<H", len(entries))
    type_sizes = {TYPE_SHORT: 2, TYPE_LONG: 4, TYPE_DOUBLE: 8, TYPE_ASCII: 1}
    for tag, typ, count, val in entries:
        total = type_sizes[typ] * count
        if isinstance(val, tuple):
            kind, idx = val
            if kind == "defer":
                out += struct.pack("<HHII", tag, typ, count, chunk_offsets[idx])
            else:  # strip
                out += struct.pack("<HHII", tag, typ, count, strip_offset)
        elif total <= 4:
            if typ == TYPE_SHORT:
                out += struct.pack("<HHIHH", tag, typ, count, val, 0)
            else:
                out += struct.pack("<HHII", tag, typ, count, val)
        else:
            raise AssertionError("inline value too large without defer")
    out += struct.pack("<I", 0)  # next IFD
    pos = len(out)
    for ch, choff in zip(extra_chunks, chunk_offsets):
        if pos < choff:
            out += b"\x00" * (choff - pos)
        out += ch
        pos = len(out)
    if pos < strip_offset:
        out += b"\x00" * (strip_offset - pos)
    out += strips[0]
    with open(fn, "wb") as f:
        f.write(bytes(out))
