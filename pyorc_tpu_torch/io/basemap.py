"""Self-contained XYZ basemap tiles for geographic plots and CLI selectors: a copy of
:mod:`pyorc_tpu.io.basemap`, with the same tile cache.

The reference renders satellite/map backgrounds through cartopy's image
tilers (reference ``pyorc/helpers.py:171-204``,
``pyorc/cli/cli_elements.py:33-235``). cartopy is not bundled here, so this
module implements the needed subset directly: Web-Mercator tile math, an XYZ
tile fetcher with an on-disk cache, and a mosaic composer that resamples the
tiles onto a lon/lat extent with plain numpy — no GEOS/proj dependencies.

Offline behaviour is graceful: fetch failures fall back to whatever tiles the
cache holds, and a fully-empty mosaic simply skips the background (with a
warning), so recipes with ``tiles:`` keep working in air-gapped deployments.
"""

from __future__ import annotations

import hashlib
import io
import math
import os
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["TILE_PROVIDERS", "tile_mosaic", "add_basemap"]

# cartopy img_tiles class names (reference recipes use these) -> URL templates
TILE_PROVIDERS = {
    "GoogleTiles": "https://mt1.google.com/vt/lyrs=s&x={x}&y={y}&z={z}",
    "GoogleWTS": "https://mt1.google.com/vt/lyrs=s&x={x}&y={y}&z={z}",
    "OSM": "https://tile.openstreetmap.org/{z}/{x}/{y}.png",
    "QuadtreeTiles": "https://ecn.t3.tiles.virtualearth.net/tiles/a{q}.jpeg?g=1",
}

_TILE = 256


def _cache_dir() -> Path:
    d = Path(os.environ.get("PYORC_TPU_TILE_CACHE", Path.home() / ".cache" / "pyorc_tpu" / "tiles"))
    d.mkdir(parents=True, exist_ok=True)
    return d


def _quadkey(x: int, y: int, z: int) -> str:
    q = ""
    for i in range(z, 0, -1):
        d = 0
        mask = 1 << (i - 1)
        if x & mask:
            d += 1
        if y & mask:
            d += 2
        q += str(d)
    return q


def _lonlat_to_tilef(lon: float, lat: float, z: int) -> Tuple[float, float]:
    lat = np.clip(lat, -85.05112878, 85.05112878)
    n = 2.0**z
    xt = (lon + 180.0) / 360.0 * n
    yt = (1.0 - math.asinh(math.tan(math.radians(lat))) / math.pi) / 2.0 * n
    return xt, yt


def _tilef_to_lonlat(xt: float, yt: float, z: int) -> Tuple[float, float]:
    n = 2.0**z
    lon = xt / n * 360.0 - 180.0
    lat = math.degrees(math.atan(math.sinh(math.pi * (1 - 2 * yt / n))))
    return lon, lat


def _fetch_tile(provider: str, x: int, y: int, z: int) -> Optional[np.ndarray]:
    """One RGB tile [256, 256, 3] from cache or network; None if unavailable."""
    from PIL import Image

    url_t = TILE_PROVIDERS.get(provider, provider)  # unknown names = raw templates
    n = 2**z
    x %= n
    if y < 0 or y >= n:
        return None
    key = hashlib.md5(url_t.encode()).hexdigest()[:8]  # stable across processes
    cache = _cache_dir() / f"{key}_{z}_{x}_{y}.png"
    if cache.is_file():
        try:
            return np.asarray(Image.open(cache).convert("RGB"))
        except Exception:
            pass
    url = url_t.format(x=x, y=y, z=z, q=_quadkey(x, y, z))
    try:
        import requests

        r = requests.get(url, timeout=10, headers={"User-Agent": "pyorc-tpu/0.1"})
        r.raise_for_status()
        img = Image.open(io.BytesIO(r.content)).convert("RGB")
        try:
            img.save(cache)
        except Exception:
            pass
        return np.asarray(img)
    except Exception:
        return None


def tile_mosaic(
    extent: Tuple[float, float, float, float],
    zoom: int = 18,
    provider: str = "GoogleTiles",
    fetch=None,
) -> Optional[Tuple[np.ndarray, Tuple[float, float, float, float]]]:
    """(rgb image, lon/lat extent) covering ``extent`` = (lon0, lon1, lat0, lat1).

    The Web-Mercator tile rows are resampled onto an equirectangular lat grid
    (nearest row) so the image can be drawn directly on a lon/lat axes.
    ``fetch`` overrides the tile source (tests inject synthetic tiles).
    Returns None when no tile could be obtained (offline, empty cache).
    """
    lon0, lon1, lat0, lat1 = extent
    fetch = fetch or _fetch_tile
    x0f, y1f = _lonlat_to_tilef(lon0, lat0, zoom)  # south -> larger y
    x1f, y0f = _lonlat_to_tilef(lon1, lat1, zoom)
    tx0, tx1 = int(np.floor(x0f)), int(np.floor(x1f))
    ty0, ty1 = int(np.floor(y0f)), int(np.floor(y1f))
    nx, ny = tx1 - tx0 + 1, ty1 - ty0 + 1
    if nx * ny > 16 * 16:
        raise ValueError(f"extent needs {nx * ny} tiles at zoom {zoom}; lower the zoom")
    mosaic = np.zeros((ny * _TILE, nx * _TILE, 3), np.uint8)
    got = 0
    for iy in range(ny):
        for ix in range(nx):
            t = fetch(provider, tx0 + ix, ty0 + iy, zoom)
            if t is not None:
                mosaic[iy * _TILE : (iy + 1) * _TILE, ix * _TILE : (ix + 1) * _TILE] = t
                got += 1
    if got == 0:
        return None
    # crop to the requested extent in tile space
    px0 = int((x0f - tx0) * _TILE)
    px1 = int((x1f - tx0) * _TILE)
    py0 = int((y0f - ty0) * _TILE)
    py1 = int((y1f - ty0) * _TILE)
    px1 = max(px1, px0 + 1)
    py1 = max(py1, py0 + 1)
    crop = mosaic[py0 : py1 + 1, px0 : px1 + 1]
    # resample mercator rows onto a uniform latitude grid (numpy gather)
    h = crop.shape[0]
    lats = np.linspace(lat1, lat0, h)  # top row = north
    ys = np.array([_lonlat_to_tilef(lon0, la, zoom)[1] for la in lats])
    rows = np.clip(((ys - ty0) * _TILE - py0).astype(int), 0, h - 1)
    warped = crop[rows]
    return warped, (lon0, lon1, lat0, lat1)


def add_basemap(ax, extent, tiles="GoogleTiles", zoom_level: int = 18, fetch=None) -> bool:
    """Draw an XYZ basemap under ``ax`` for a lon/lat extent; returns success."""
    try:
        out = tile_mosaic(extent, zoom=zoom_level, provider=tiles, fetch=fetch)
    except Exception as e:
        warnings.warn(f"Basemap tiles unavailable ({e}); plotting without.", stacklevel=2)
        return False
    if out is None:
        warnings.warn(
            "Basemap tiles unavailable (offline and no cached tiles); plotting without.",
            stacklevel=2,
        )
        return False
    img, ext = out
    ax.imshow(img, extent=(ext[0], ext[1], ext[2], ext[3]), origin="upper", zorder=0)
    return True
