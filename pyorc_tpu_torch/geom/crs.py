"""Coordinate reference systems without pyproj.

The reference delegates CRS handling to pyproj/rasterio (reference
``pyorc/helpers.py:299-333,916-954``); neither python package is available
here, so we implement the projection MATH ourselves for the families river
cameras actually use:

- Transverse Mercator on arbitrary ellipsoids (Karney's 6th-order Krüger
  series, sub-millimetre) — WGS84/UTM (326xx/327xx), ETRS89/UTM (258xx),
  NAD83/UTM (269xx), GDA94/MGA (283xx), OSGB36/British National Grid (27700),
  NZTM2000 (2193), and every other EPSG TM grid
- Oblique Stereographic (EPSG method 9809, e.g. Dutch RD New / EPSG:28992)
- Lambert Conformal Conic 1SP/2SP (EPSG methods 9801/9802, e.g. RGF93 /
  Lambert-93 EPSG:2154, Belgian Lambert 72 EPSG:31370, the NAD83 US State
  Plane LCC zones incl. US-survey-foot units)
- Polar Stereographic variants A/B (EPSG methods 9810/9829, e.g. UPS
  EPSG:5041/5042, Antarctic Polar Stereographic EPSG:3031)

EPSG-code resolution is registry-driven: a compact built-in table covers the
common European/US/AU grids offline, and ANY other EPSG code resolves through
the system PROJ database when present (``projinfo -o PROJJSON``, data lookup
only — all projection/datum math stays in this module). Non-metre axis units
(US survey foot, foot) are handled via a per-CRS unit factor. 7-parameter
Helmert datum shifts bridge non-WGS84-equivalent datums; WKT/EPSG/proj4
string parsing reads reference camera-config JSONs unchanged. Unknown
projected WKTs still parse (the pipeline runs entirely in projected
coordinates); only lon/lat conversion raises for them.
"""

from __future__ import annotations

import functools
import json
import math
import re
import subprocess
from typing import Optional, Tuple, Union

import numpy as np

__all__ = ["CRS", "transform_points", "utm_zone_from_lonlat"]

# WGS84
_A = 6378137.0
_F = 1 / 298.257223563

_KRUGER_CACHE = {}


def _kruger_coeffs(a: float, f: float):
    """A-bar, alpha, beta Krüger series coefficients (6th order in n) for an ellipsoid."""
    key = (a, f)
    if key in _KRUGER_CACHE:
        return _KRUGER_CACHE[key]
    n = f / (2 - f)
    a_bar = a / (1 + n) * (1 + n**2 / 4 + n**4 / 64 + n**6 / 256)
    alpha = np.array(
        [
            n / 2 - 2 * n**2 / 3 + 5 * n**3 / 16 + 41 * n**4 / 180 - 127 * n**5 / 288 + 7891 * n**6 / 37800,
            13 * n**2 / 48 - 3 * n**3 / 5 + 557 * n**4 / 1440 + 281 * n**5 / 630 - 1983433 * n**6 / 1935360,
            61 * n**3 / 240 - 103 * n**4 / 140 + 15061 * n**5 / 26880 + 167603 * n**6 / 181440,
            49561 * n**4 / 161280 - 179 * n**5 / 168 + 6601661 * n**6 / 7257600,
            34729 * n**5 / 80640 - 3418889 * n**6 / 1995840,
            212378941 * n**6 / 319334400,
        ]
    )
    beta = np.array(
        [
            n / 2 - 2 * n**2 / 3 + 37 * n**3 / 96 - n**4 / 360 - 81 * n**5 / 512 + 96199 * n**6 / 604800,
            n**2 / 48 + n**3 / 15 - 437 * n**4 / 1440 + 46 * n**5 / 105 - 1118711 * n**6 / 3870720,
            17 * n**3 / 480 - 37 * n**4 / 840 - 209 * n**5 / 4480 + 5569 * n**6 / 90720,
            4397 * n**4 / 161280 - 11 * n**5 / 504 - 830251 * n**6 / 7257600,
            4583 * n**5 / 161280 - 108847 * n**6 / 3991680,
            20648693 * n**6 / 638668800,
        ]
    )
    _KRUGER_CACHE[key] = (a_bar, alpha, beta)
    return a_bar, alpha, beta


def _tm_meridian_arc(lat0_deg: float, a: float, f: float) -> float:
    """Meridian arc length from the equator to lat0 (the Krüger xi at lam=0)."""
    if lat0_deg == 0.0:
        return 0.0
    a_bar, alpha, _ = _kruger_coeffs(a, f)
    e = math.sqrt(f * (2 - f))
    s = math.sin(math.radians(lat0_deg))
    t = math.sinh(math.atanh(s) - e * math.atanh(e * s))
    xi_p = math.atan(t)
    xi = xi_p + sum(alpha[j - 1] * math.sin(2 * j * xi_p) for j in range(1, 7))
    return a_bar * xi


def _tm_forward(lon, lat, lon0, k0, fe, fn_, a=_A, f=_F, lat0=0.0) -> Tuple[np.ndarray, np.ndarray]:
    a_bar, alpha, _ = _kruger_coeffs(a, f)
    e = math.sqrt(f * (2 - f))
    lon = np.radians(np.asarray(lon, dtype=np.float64))
    lat = np.radians(np.asarray(lat, dtype=np.float64))
    lam = lon - math.radians(lon0)
    s = np.sin(lat)
    # conformal latitude via Gauss-Schreiber tau
    t = np.sinh(np.arctanh(s) - e * np.arctanh(e * s))
    xi_p = np.arctan2(t, np.cos(lam))
    eta_p = np.arcsinh(np.sin(lam) / np.sqrt(t * t + np.cos(lam) ** 2))
    j = np.arange(1, 7)
    xi = xi_p + np.sum(alpha * np.sin(2 * j * xi_p[..., None]) * np.cosh(2 * j * eta_p[..., None]), axis=-1)
    eta = eta_p + np.sum(alpha * np.cos(2 * j * xi_p[..., None]) * np.sinh(2 * j * eta_p[..., None]), axis=-1)
    E = fe + k0 * a_bar * eta
    N = fn_ + k0 * (a_bar * xi - _tm_meridian_arc(lat0, a, f))
    return E, N


def _tm_reverse(E, N, lon0, k0, fe, fn_, a=_A, f=_F, lat0=0.0) -> Tuple[np.ndarray, np.ndarray]:
    a_bar, _, beta = _kruger_coeffs(a, f)
    e2 = f * (2 - f)
    e = math.sqrt(e2)
    E = np.asarray(E, dtype=np.float64)
    N = np.asarray(N, dtype=np.float64)
    xi = (N - fn_ + k0 * _tm_meridian_arc(lat0, a, f)) / (k0 * a_bar)
    eta = (E - fe) / (k0 * a_bar)
    j = np.arange(1, 7)
    xi_p = xi - np.sum(beta * np.sin(2 * j * xi[..., None]) * np.cosh(2 * j * eta[..., None]), axis=-1)
    eta_p = eta - np.sum(beta * np.cos(2 * j * xi[..., None]) * np.sinh(2 * j * eta[..., None]), axis=-1)
    t = np.sin(xi_p) / np.sqrt(np.sinh(eta_p) ** 2 + np.cos(xi_p) ** 2)
    lam = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    # invert conformal latitude: Newton on phi with tau(phi) = t
    phi = np.arctan(t)
    for _ in range(8):
        s = np.sin(phi)
        tau = np.sinh(np.arcsinh(np.tan(phi)) - e * np.arctanh(e * s))
        dtau = np.sqrt(1 + tau * tau) * (1 - e2) / ((1 - e2 * s * s) * np.cos(phi))
        phi = phi - (tau - t) / dtau
    lon = np.degrees(lam + math.radians(lon0))
    lat = np.degrees(phi)
    return lon, lat


def utm_zone_from_lonlat(lon: float, lat: float) -> int:
    """EPSG code of the UTM zone containing (lon, lat)."""
    zone = int((lon + 180) // 6) + 1
    return (32600 if lat >= 0 else 32700) + zone


# -- Oblique Stereographic (EPSG 9809) on arbitrary ellipsoid ------------------------
# Formulas per EPSG Guidance Note 7-2 (double stereographic via conformal sphere).


class _ObliqueStereo:
    def __init__(self, a: float, inv_f: float, lat0: float, lon0: float, k0: float, fe: float, fn_: float):
        self.a = a
        self.f = 1.0 / inv_f
        self.e2 = self.f * (2 - self.f)
        self.e = math.sqrt(self.e2)
        self.lat0 = math.radians(lat0)
        self.lon0 = math.radians(lon0)
        self.k0 = k0
        self.fe = fe
        self.fn = fn_
        e, e2 = self.e, self.e2
        sp0 = math.sin(self.lat0)
        rho0 = a * (1 - e2) / (1 - e2 * sp0**2) ** 1.5
        nu0 = a / math.sqrt(1 - e2 * sp0**2)
        self.R = math.sqrt(rho0 * nu0)
        self.n = math.sqrt(1 + (e2 * math.cos(self.lat0) ** 4) / (1 - e2))
        S1 = (1 + sp0) / (1 - sp0)
        S2 = (1 - e * sp0) / (1 + e * sp0)
        w1 = (S1 * S2**e) ** self.n
        sin_chi0 = (w1 - 1) / (w1 + 1)
        self.c = (self.n + sp0) * (1 - sin_chi0) / ((self.n - sp0) * (1 + sin_chi0))
        w2 = self.c * w1
        self.chi0 = math.asin((w2 - 1) / (w2 + 1))
        self.Lam0 = self.lon0

    def forward(self, lon, lat):
        lon = np.radians(np.asarray(lon, dtype=np.float64))
        lat = np.radians(np.asarray(lat, dtype=np.float64))
        e, n, c = self.e, self.n, self.c
        Lam = n * (lon - self.Lam0) + self.Lam0
        sp = np.sin(lat)
        Sa = (1 + sp) / (1 - sp)
        Sb = (1 - e * sp) / (1 + e * sp)
        w = c * (Sa * Sb**e) ** n
        chi = np.arcsin((w - 1) / (w + 1))
        B = 1 + np.sin(chi) * math.sin(self.chi0) + np.cos(chi) * math.cos(self.chi0) * np.cos(Lam - self.Lam0)
        E = self.fe + 2 * self.R * self.k0 * np.cos(chi) * np.sin(Lam - self.Lam0) / B
        N = self.fn + 2 * self.R * self.k0 * (
            np.sin(chi) * math.cos(self.chi0) - np.cos(chi) * math.sin(self.chi0) * np.cos(Lam - self.Lam0)
        ) / B
        return E, N

    def reverse(self, E, N):
        E = np.asarray(E, dtype=np.float64)
        N = np.asarray(N, dtype=np.float64)
        e, n, c = self.e, self.n, self.c
        Rk2 = 2 * self.R * self.k0
        g = Rk2 * math.tan(math.pi / 4 - self.chi0 / 2)
        h = 2 * Rk2 * math.tan(self.chi0) + g
        i = np.arctan2(E - self.fe, h + (N - self.fn))
        j = np.arctan2(E - self.fe, g - (N - self.fn)) - i
        chi = self.chi0 + 2 * np.arctan(((N - self.fn) - (E - self.fe) * np.tan(j / 2)) / Rk2)
        Lam = j + 2 * i + self.Lam0
        lon = (Lam - self.Lam0) / n + self.Lam0
        # isometric latitude from conformal latitude
        psi = 0.5 * np.log((1 + np.sin(chi)) / (c * (1 - np.sin(chi)))) / n
        phi = 2 * np.arctan(np.exp(psi)) - math.pi / 2
        for _ in range(8):
            sp = np.sin(phi)
            psi_i = np.log(np.tan(phi / 2 + math.pi / 4) * ((1 - e * sp) / (1 + e * sp)) ** (e / 2))
            phi = phi - (psi_i - psi) * np.cos(phi) * (1 - e2_of(e) * sp**2) / (1 - e2_of(e))
        return np.degrees(lon), np.degrees(phi)


def e2_of(e):
    return e * e


# -- Lambert Conformal Conic (EPSG methods 9801 1SP / 9802 2SP) -----------------------
# Formulas per EPSG Guidance Note 7-2 §3.1.1. Covers the European national grids the
# reference handles through pyproj (e.g. RGF93/Lambert-93, Belgian Lambert 72).


class _LambertConformal:
    def __init__(
        self,
        a: float,
        inv_f: float,
        lat0: float,
        lon0: float,
        fe: float,
        fn_: float,
        sp1: Optional[float] = None,
        sp2: Optional[float] = None,
        k0: float = 1.0,
    ):
        """2SP when sp1/sp2 are given (k0 ignored, EPSG 9802); 1SP otherwise (EPSG 9801)."""
        self.a = a
        self.f = 1.0 / inv_f
        self.e2 = self.f * (2 - self.f)
        self.e = math.sqrt(self.e2)
        self.lat0, self.lon0 = lat0, lon0
        self.fe, self.fn = fe, fn_
        self.sp1, self.sp2, self.k0 = sp1, sp2, k0
        e = self.e

        def m(phi):
            s = math.sin(phi)
            return math.cos(phi) / math.sqrt(1 - self.e2 * s * s)

        def t_of(phi):
            s = math.sin(phi)
            return math.tan(math.pi / 4 - phi / 2) / ((1 - e * s) / (1 + e * s)) ** (e / 2)

        phi0 = math.radians(lat0)
        t0 = t_of(phi0)
        if sp1 is not None and sp2 is not None:
            p1, p2 = math.radians(sp1), math.radians(sp2)
            m1, m2 = m(p1), m(p2)
            t1, t2 = t_of(p1), t_of(p2)
            if abs(p1 - p2) < 1e-12:
                self.n = math.sin(p1)
            else:
                self.n = (math.log(m1) - math.log(m2)) / (math.log(t1) - math.log(t2))
            self.F = m1 / (self.n * t1**self.n)
            self.r0 = a * self.F * t0**self.n  # t0 = 0 at lat0 = 90 deg (Belgian grid): r0 = 0
        else:
            self.n = math.sin(phi0)
            self.F = m(phi0) / (self.n * t0**self.n) * k0
            self.r0 = a * self.F * t0**self.n

    def _t(self, lat):
        s = np.sin(lat)
        return np.tan(math.pi / 4 - lat / 2) / ((1 - self.e * s) / (1 + self.e * s)) ** (self.e / 2)

    def forward(self, lon, lat):
        lon = np.radians(np.asarray(lon, dtype=np.float64))
        lat = np.radians(np.asarray(lat, dtype=np.float64))
        t = self._t(lat)
        r = self.a * self.F * t**self.n
        theta = self.n * (lon - math.radians(self.lon0))
        E = self.fe + r * np.sin(theta)
        N = self.fn + self.r0 - r * np.cos(theta)
        return E, N

    def reverse(self, E, N):
        E = np.asarray(E, dtype=np.float64) - self.fe
        dN = self.r0 - (np.asarray(N, dtype=np.float64) - self.fn)
        sgn = 1.0 if self.n >= 0 else -1.0
        r = sgn * np.sqrt(E * E + dN * dN)
        t = (r / (self.a * self.F)) ** (1.0 / self.n)
        theta = np.arctan2(sgn * E, sgn * dN)
        lon = theta / self.n + math.radians(self.lon0)
        phi = math.pi / 2 - 2 * np.arctan(t)
        for _ in range(8):
            s = np.sin(phi)
            phi = math.pi / 2 - 2 * np.arctan(t * ((1 - self.e * s) / (1 + self.e * s)) ** (self.e / 2))
        return np.degrees(lon), np.degrees(phi)


class _Mercator:
    """Mercator: EPSG methods 9804 (variant A, scale factor), 9805 (variant B,
    standard parallel), and 1024 (Popular Visualisation Pseudo Mercator, the
    Web-Mercator sphere-on-ellipsoid used by EPSG:3857)."""

    def __init__(self, a: float, inv_f: float, lon0: float, fe: float, fn_: float,
                 k0: float = 1.0, lat_ts: Optional[float] = None, spherical: bool = False):
        self.a, self.inv_f = a, inv_f
        f = 1.0 / inv_f
        self.e = 0.0 if spherical else math.sqrt(f * (2 - f))
        self.lon0, self.fe, self.fn = lon0, fe, fn_
        self.spherical = spherical
        self.lat_ts = lat_ts
        if lat_ts is not None:  # variant B
            pf = math.radians(lat_ts)
            sf = math.sin(pf)
            k0 = math.cos(pf) / math.sqrt(1 - self.e * self.e * sf * sf)
        self.k0 = k0

    def forward(self, lon, lat):
        lon = np.radians(np.asarray(lon, dtype=np.float64))
        lat = np.radians(np.asarray(lat, dtype=np.float64))
        e, s = self.e, np.sin(lat)
        E = self.fe + self.a * self.k0 * (lon - math.radians(self.lon0))
        iso = np.log(np.tan(math.pi / 4 + lat / 2))
        if e:
            iso = iso - (e / 2) * np.log((1 + e * s) / (1 - e * s))
        return E, self.fn + self.a * self.k0 * iso

    def reverse(self, E, N):
        lon = math.radians(self.lon0) + (np.asarray(E, dtype=np.float64) - self.fe) / (self.a * self.k0)
        t = np.exp(-(np.asarray(N, dtype=np.float64) - self.fn) / (self.a * self.k0))
        phi = math.pi / 2 - 2 * np.arctan(t)
        e = self.e
        if e:
            for _ in range(8):
                s = np.sin(phi)
                phi = math.pi / 2 - 2 * np.arctan(t * ((1 - e * s) / (1 + e * s)) ** (e / 2))
        return np.degrees(lon), np.degrees(phi)


class _PolarStereo:
    """Polar Stereographic, EPSG methods 9810 (variant A: scale factor at the
    pole) and 9829 (variant B: standard parallel). IOGP Guidance Note 7-2
    §3.2.3 formulas; the pole aspect follows the sign of ``lat0``
    (variant A: ±90) or ``lat_ts`` (variant B)."""

    def __init__(self, a: float, inv_f: float, lon0: float, fe: float, fn_: float,
                 lat0: float = 90.0, k0: Optional[float] = None, lat_ts: Optional[float] = None):
        self.a, self.inv_f = a, inv_f
        f = 1.0 / inv_f
        self.e = math.sqrt(f * (2 - f))
        self.lon0, self.fe, self.fn = lon0, fe, fn_
        self.lat_ts = lat_ts
        self.north = (lat_ts if lat_ts is not None else lat0) >= 0
        self.lat0 = 90.0 if self.north else -90.0
        e = self.e
        self._c = math.sqrt((1 + e) ** (1 + e) * (1 - e) ** (1 - e))
        if k0 is None:
            # variant B: k0 implied by the standard parallel
            pf = math.radians(lat_ts)
            sf = math.sin(pf)
            mf = math.cos(pf) / math.sqrt(1 - e * e * sf * sf)
            if self.north:
                tf = math.tan(math.pi / 4 - pf / 2) * ((1 + e * sf) / (1 - e * sf)) ** (e / 2)
            else:
                tf = math.tan(math.pi / 4 + pf / 2) / ((1 + e * sf) / (1 - e * sf)) ** (e / 2)
            k0 = mf * self._c / (2 * tf)
        self.k0 = k0

    def _t(self, lat):
        s = np.sin(lat)
        if self.north:
            return np.tan(math.pi / 4 - lat / 2) * ((1 + self.e * s) / (1 - self.e * s)) ** (self.e / 2)
        return np.tan(math.pi / 4 + lat / 2) / ((1 + self.e * s) / (1 - self.e * s)) ** (self.e / 2)

    def forward(self, lon, lat):
        lon = np.radians(np.asarray(lon, dtype=np.float64))
        lat = np.radians(np.asarray(lat, dtype=np.float64))
        t = self._t(lat)
        rho = 2 * self.a * self.k0 * t / self._c
        dlon = lon - math.radians(self.lon0)
        E = self.fe + rho * np.sin(dlon)
        N = self.fn - rho * np.cos(dlon) if self.north else self.fn + rho * np.cos(dlon)
        return E, N

    def reverse(self, E, N):
        dE = np.asarray(E, dtype=np.float64) - self.fe
        dN = np.asarray(N, dtype=np.float64) - self.fn
        rho = np.sqrt(dE * dE + dN * dN)
        t = rho * self._c / (2 * self.a * self.k0)
        if self.north:
            chi = math.pi / 2 - 2 * np.arctan(t)
            lon = math.radians(self.lon0) + np.arctan2(dE, -dN)
        else:
            chi = 2 * np.arctan(t) - math.pi / 2
            lon = math.radians(self.lon0) + np.arctan2(dE, dN)
        e2 = self.e * self.e
        e4, e6, e8 = e2 * e2, e2**3, e2**4
        phi = (
            chi
            + (e2 / 2 + 5 * e4 / 24 + e6 / 12 + 13 * e8 / 360) * np.sin(2 * chi)
            + (7 * e4 / 48 + 29 * e6 / 240 + 811 * e8 / 11520) * np.sin(4 * chi)
            + (7 * e6 / 120 + 81 * e8 / 1120) * np.sin(6 * chi)
            + (4279 * e8 / 161280) * np.sin(8 * chi)
        )
        return np.degrees(lon), np.degrees(phi)


# -- geocentric conversions + Helmert (position-vector convention) --------------------


def _geodetic_to_geocentric(lon_deg, lat_deg, a, f, h=0.0):
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    e2 = f * (2 - f)
    N = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    X = (N + h) * np.cos(lat) * np.cos(lon)
    Y = (N + h) * np.cos(lat) * np.sin(lon)
    Z = (N * (1 - e2) + h) * np.sin(lat)
    return X, Y, Z


def _geocentric_to_geodetic(X, Y, Z, a, f):
    e2 = f * (2 - f)
    lon = np.arctan2(Y, X)
    p = np.sqrt(X**2 + Y**2)
    lat = np.arctan2(Z, p * (1 - e2))
    for _ in range(6):
        N = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
        lat = np.arctan2(Z + e2 * N * np.sin(lat), p)
    return np.degrees(lon), np.degrees(lat)


def _helmert(X, Y, Z, p, inverse=False):
    """7-parameter Helmert (position-vector): tx ty tz [m], rx ry rz [arcsec], s [ppm]."""
    tx, ty, tz, rx, ry, rz, s = p
    rx, ry, rz = (np.radians(v / 3600.0) for v in (rx, ry, rz))
    m = 1 + s * 1e-6
    if not inverse:
        X2 = m * (X - rz * Y + ry * Z) + tx
        Y2 = m * (rz * X + Y - rx * Z) + ty
        Z2 = m * (-ry * X + rx * Y + Z) + tz
        return X2, Y2, Z2
    Xs, Ys, Zs = X - tx, Y - ty, Z - tz
    X1 = (Xs + rz * Ys - ry * Zs) / m
    Y1 = (-rz * Xs + Ys + rx * Zs) / m
    Z1 = (ry * Xs - rx * Ys + Zs) / m
    return X1, Y1, Z1


# well-known datum shifts to WGS84 (position-vector towgs84 parameters)
_TOWGS84 = {
    "Amersfoort": (565.2369, 50.0087, 465.658, -0.406857, 0.350733, -1.87035, 4.0812),
    # Belgian Datum 72 (NGI standard transformation, EPSG:15929)
    "Reseau National Belge 1972": (-106.8686, 52.2978, -103.7239, 0.3366, -0.457, 1.8422, -1.2747),
    # OSGB36 -> WGS84 (EPSG:1314 position-vector)
    "OSGB 1936": (446.448, -125.157, 542.06, 0.15, 0.247, 0.842, -20.489),
    "OSGB36": (446.448, -125.157, 542.06, 0.15, 0.247, 0.842, -20.489),
    # the PROJJSON spelling of the OSGB36 datum (projinfo EPSG:27700)
    "Ordnance Survey of Great Britain 1936": (446.448, -125.157, 542.06, 0.15, 0.247, 0.842, -20.489),
}

# datums whose EPSG-canonical transformation to WGS84 is the null
# transformation at the GCP accuracy floor (<~1-2 m): modern geocentric
# ITRF-aligned frames. Matched as name PREFIXES against PROJJSON datum /
# datum-ensemble names (which carry realization suffixes like "(2011)").
_NULL_DATUM_PREFIXES = (
    "World Geodetic System 1984",
    "European Terrestrial Reference System 1989",
    "North American Datum 1983",  # incl. (2011)/(CSRS...) realizations
    "Geocentric Datum of Australia",
    "New Zealand Geodetic Datum 2000",
    "Japanese Geodetic Datum 2000",
    "Japanese Geodetic Datum 2011",
    "Reseau Geodesique Francais 1993",
    "China 2000",
    "Korean Geodetic Datum 2002",
    "SIRGAS 2000",
    "Sistema de Referencia Geocentrico para las AmericaS 2000",  # SIRGAS 2000
    "Sistema de Referencia Geocentrico para America del Sur 1995",  # SIRGAS 1995
    "ETRS89",
)

_ELLIPSOIDS = {
    "Bessel 1841": (6377397.155, 299.1528128),
    "WGS 84": (6378137.0, 298.257223563),
    "GRS 1980": (6378137.0, 298.257222101),
    "International 1924": (6378388.0, 297.0),
    "Clarke 1880 (IGN)": (6378249.2, 293.4660212936269),
    "Clarke 1866": (6378206.4, 294.978698213898),
    "Airy 1830": (6377563.396, 299.3249646),
}


@functools.lru_cache(maxsize=256)
def _projinfo_json(code: int) -> Optional[dict]:
    """PROJJSON for an EPSG code from the system PROJ database (``projinfo``,
    shipped with PROJ ≥ 6). Registry-data lookup only — every projection and
    datum computation stays in this module. None when projinfo or the code
    is unavailable (deployments without PROJ keep the built-in registry)."""
    try:
        out = subprocess.run(
            ["projinfo", f"EPSG:{int(code)}", "-o", "PROJJSON", "-q"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0 or not out.stdout.strip():
        return None
    try:
        return json.loads(out.stdout)
    except ValueError:
        return None


@functools.lru_cache(maxsize=256)
def _projinfo_wkt(code: int) -> Optional[str]:
    """Authoritative WKT2:2019 for an EPSG code from the system PROJ database."""
    try:
        out = subprocess.run(
            ["projinfo", f"EPSG:{int(code)}", "-o", "WKT2:2019", "-q", "--single-line"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    s = out.stdout.strip()
    return s if out.returncode == 0 and s else None


def _unit_factor(unit) -> float:
    """Multiplier to SI (metres for lengths, degrees for angles)."""
    if isinstance(unit, dict):
        f = float(unit.get("conversion_factor", 1.0))
        if unit.get("type") == "AngularUnit":
            return math.degrees(f)  # conversion_factor is to radians
        return f
    return {
        "metre": 1.0, "meter": 1.0, "degree": 1.0, "unity": 1.0,
        "US survey foot": 1200.0 / 3937.0, "foot": 0.3048,
        "grad": 0.9,
    }.get(unit, 1.0)


def _param_si(prm: dict) -> float:
    """A PROJJSON conversion parameter in SI units (m / degrees / unitless)."""
    return float(prm["value"]) * _unit_factor(prm.get("unit", "unity"))


def _datum_towgs84(datum_name: str) -> Optional[tuple]:
    """Helmert parameters to WGS84 for a PROJJSON datum name.

    None (the null transformation) for modern ITRF-aligned frames, a table
    entry for classical datums we know, and None-with-a-warning otherwise —
    matching the WKT parser's silent-null for unknown datums, but observable.
    """
    if not datum_name:
        return None
    if datum_name in _TOWGS84:
        return _TOWGS84[datum_name]
    for prefix in _NULL_DATUM_PREFIXES:
        if datum_name.startswith(prefix):
            return None
    import warnings

    warnings.warn(
        f"datum {datum_name!r} has no known transformation to WGS84; assuming the "
        f"null transformation (projected coordinates are unaffected; lon/lat may be "
        f"offset by the datum difference)",
        stacklevel=3,
    )
    return None


class CRS:
    """A coordinate reference system: WGS84 geographic or WGS84/UTM (TM) projected."""

    def __init__(
        self,
        epsg: Optional[int] = None,
        wkt: Optional[str] = None,
        lon0: Optional[float] = None,
        k0: float = 0.9996,
        false_easting: float = 500000.0,
        false_northing: float = 0.0,
        geographic: bool = False,
        stereo: Optional["_ObliqueStereo"] = None,
        lcc: Optional["_LambertConformal"] = None,
        polar: Optional["_PolarStereo"] = None,
        mercator: Optional["_Mercator"] = None,
        towgs84: Optional[tuple] = None,
        ellipsoid: tuple = (6378137.0, 298.257223563),
        opaque_projected: bool = False,
        lat0: float = 0.0,
        name: Optional[str] = None,
        unit: float = 1.0,  # metres per CRS axis unit (US survey foot: 1200/3937)
    ):
        self.epsg = epsg
        self.wkt = wkt
        self.lon0 = lon0
        self.lat0 = lat0
        self.k0 = k0
        self.false_easting = false_easting
        self.false_northing = false_northing
        self.geographic = geographic
        self.stereo = stereo
        self.lcc = lcc
        self.polar = polar
        self.mercator = mercator
        self.towgs84 = towgs84
        self.ellipsoid = ellipsoid
        self.opaque_projected = opaque_projected
        self.name = name
        self.unit = unit

    # -- constructors ------------------------------------------------------------

    @classmethod
    def from_user_input(cls, value: Union["CRS", int, str, None]) -> Optional["CRS"]:
        if value is None:
            return None
        if isinstance(value, CRS):
            return value
        if isinstance(value, (int, np.integer)):
            return cls.from_epsg(int(value))
        if isinstance(value, str):
            s = value.strip()
            m = re.match(r"^EPSG:(\d+)$", s, re.I)
            if m:
                return cls.from_epsg(int(m.group(1)))
            if s.isdigit():
                return cls.from_epsg(int(s))
            if s.startswith("+") or "proj=" in s:
                return cls._from_proj4(s)
            if "[" in s:  # WKT
                return cls._from_wkt(s)
        raise ValueError(f"cannot interpret CRS from {value!r}")

    @classmethod
    def from_epsg(cls, code: int) -> "CRS":
        if code == 4326:
            return cls(epsg=4326, geographic=True)
        if 32601 <= code <= 32660:
            zone = code - 32600
            return cls(epsg=code, lon0=zone * 6 - 183, false_northing=0.0)
        if 32701 <= code <= 32760:
            zone = code - 32700
            return cls(epsg=code, lon0=zone * 6 - 183, false_northing=10000000.0)
        if code == 28992:  # Amersfoort / RD New (Dutch national grid)
            a, inv_f = _ELLIPSOIDS["Bessel 1841"]
            stereo = _ObliqueStereo(
                a, inv_f, lat0=52.1561605555556, lon0=5.38763888888889, k0=0.9999079, fe=155000.0, fn_=463000.0
            )
            return cls(epsg=code, stereo=stereo, ellipsoid=(a, inv_f), towgs84=_TOWGS84["Amersfoort"])
        # ETRS89 / UTM zones 28N-38N (standard in European hydrology). ETRS89 and
        # WGS84 agree to well under the GCP accuracy floor; EPSG's canonical
        # transformation between them is the null transformation (EPSG:1149).
        if 25828 <= code <= 25838:
            zone = code - 25800
            return cls(epsg=code, lon0=zone * 6 - 183, false_northing=0.0,
                       ellipsoid=_ELLIPSOIDS["GRS 1980"], name=f"ETRS89 / UTM zone {zone}N")
        if 26901 <= code <= 26923:  # NAD83 / UTM (null transformation to WGS84, EPSG:1188)
            zone = code - 26900
            return cls(epsg=code, lon0=zone * 6 - 183, false_northing=0.0,
                       ellipsoid=_ELLIPSOIDS["GRS 1980"], name=f"NAD83 / UTM zone {zone}N")
        if 28348 <= code <= 28358:  # GDA94 / MGA (southern hemisphere)
            zone = code - 28300
            return cls(epsg=code, lon0=zone * 6 - 183, false_northing=10000000.0,
                       ellipsoid=_ELLIPSOIDS["GRS 1980"], name=f"GDA94 / MGA zone {zone}")
        if code == 2154:  # RGF93 v1 / Lambert-93 (French national grid, LCC 2SP)
            a, inv_f = _ELLIPSOIDS["GRS 1980"]
            lcc = _LambertConformal(a, inv_f, lat0=46.5, lon0=3.0, fe=700000.0, fn_=6600000.0, sp1=49.0, sp2=44.0)
            return cls(epsg=code, lcc=lcc, ellipsoid=(a, inv_f), name="RGF93 v1 / Lambert-93")
        if code == 31370:  # BD72 / Belgian Lambert 72 (LCC 2SP, lat0 at the pole)
            a, inv_f = _ELLIPSOIDS["International 1924"]
            lcc = _LambertConformal(
                a, inv_f, lat0=90.0, lon0=4.367486666666666, fe=150000.013, fn_=5400088.438,
                sp1=51.16666723333333, sp2=49.8333339,
            )
            return cls(epsg=code, lcc=lcc, ellipsoid=(a, inv_f),
                       towgs84=_TOWGS84["Reseau National Belge 1972"], name="BD72 / Belgian Lambert 72")
        if code == 27700:  # OSGB36 / British National Grid (TM with non-zero lat0)
            a, inv_f = _ELLIPSOIDS["Airy 1830"]
            return cls(epsg=code, lon0=-2.0, lat0=49.0, k0=0.9996012717, false_easting=400000.0,
                       false_northing=-100000.0, ellipsoid=(a, inv_f),
                       towgs84=_TOWGS84["OSGB 1936"], name="OSGB36 / British National Grid")
        # anything else resolves through the system PROJ EPSG database (data
        # lookup only; the projection math stays in this module)
        d = _projinfo_json(code)
        if d is not None:
            return cls._from_projjson(d, code)
        raise NotImplementedError(
            f"EPSG:{code} not in the built-in registry and the system PROJ database "
            f"(projinfo) is unavailable — built-in CRS: EPSG:4326 (WGS84), WGS84/UTM "
            f"(EPSG:326xx/327xx), ETRS89/UTM (258xx), NAD83/UTM (269xx), GDA94/MGA (283xx), "
            f"RD New (28992), Lambert-93 (2154), Belgian Lambert 72 (31370), British National "
            f"Grid (27700), plus any Transverse Mercator / Oblique Stereographic / Lambert "
            f"Conformal Conic / Polar Stereographic CRS given as WKT"
        )

    @classmethod
    def _from_projjson(cls, d: dict, code: int) -> "CRS":
        """Build a CRS from a PROJJSON document (EPSG registry data; the
        projection and datum math is this module's own — parity contract:
        reference accepts any pyproj CRS, pyorc/helpers.py:299-333)."""
        typ = d.get("type")
        name = d.get("name")
        if typ == "BoundCRS":
            # source CRS + an explicit transformation to WGS84 (towgs84-style)
            inner = cls._from_projjson(d["source_crs"], code)
            par = {p["name"]: p["value"] for p in d.get("transformation", {}).get("parameters", [])}
            keys = ("X-axis translation", "Y-axis translation", "Z-axis translation",
                    "X-axis rotation", "Y-axis rotation", "Z-axis rotation", "Scale difference")
            if par:
                inner.towgs84 = tuple(float(par.get(k, 0.0)) for k in keys)
            return inner
        if typ == "GeographicCRS":
            crs = cls(epsg=code, geographic=True, name=name)
            datum = d.get("datum") or d.get("datum_ensemble") or {}
            ell = datum.get("ellipsoid", {})
            if "semi_major_axis" in ell:
                crs.ellipsoid = (float(ell["semi_major_axis"]),
                                 float(ell.get("inverse_flattening", 298.257223563)))
            crs.towgs84 = _datum_towgs84(datum.get("name", ""))
            return crs
        if typ != "ProjectedCRS":
            raise NotImplementedError(f"EPSG:{code}: unsupported PROJJSON CRS type {typ!r}")

        base = d["base_crs"]
        datum = base.get("datum") or base.get("datum_ensemble") or {}
        ell = datum.get("ellipsoid", {})
        if "inverse_flattening" not in ell:
            raise NotImplementedError(f"EPSG:{code}: non-ellipsoidal base ({ell.get('name')})")
        a = float(ell["semi_major_axis"])
        inv_f = float(ell["inverse_flattening"])
        towgs84 = _datum_towgs84(datum.get("name", ""))

        conv = d["conversion"]
        method = conv["method"]
        mcode = int(method.get("id", {}).get("code", 0))
        mname = method.get("name", "")
        p = {}
        for prm in conv["parameters"]:
            p[prm["name"]] = _param_si(prm)
        # axis unit: metres per unit (EPSG projected CRSs never mix axis units)
        factors = [_unit_factor(ax.get("unit", "metre"))
                   for ax in d.get("coordinate_system", {}).get("axis", [])]
        unit = factors[0] if factors and all(f == factors[0] for f in factors) else 1.0

        common = dict(epsg=code, ellipsoid=(a, inv_f), towgs84=towgs84, name=name, unit=unit)
        if mcode == 9807 or mname == "Transverse Mercator":
            return cls(
                lon0=p.get("Longitude of natural origin", 0.0),
                lat0=p.get("Latitude of natural origin", 0.0),
                k0=p.get("Scale factor at natural origin", 1.0),
                false_easting=p.get("False easting", 0.0),
                false_northing=p.get("False northing", 0.0),
                **common,
            )
        if mcode == 9802 or mname.startswith("Lambert Conic Conformal (2SP"):
            lcc = _LambertConformal(
                a, inv_f,
                lat0=p.get("Latitude of false origin", 0.0),
                lon0=p.get("Longitude of false origin", 0.0),
                fe=p.get("Easting at false origin", 0.0),
                fn_=p.get("Northing at false origin", 0.0),
                sp1=p.get("Latitude of 1st standard parallel"),
                sp2=p.get("Latitude of 2nd standard parallel"),
            )
            return cls(lcc=lcc, **common)
        if mcode == 9801 or mname == "Lambert Conic Conformal (1SP)":
            lcc = _LambertConformal(
                a, inv_f,
                lat0=p.get("Latitude of natural origin", 0.0),
                lon0=p.get("Longitude of natural origin", 0.0),
                fe=p.get("False easting", 0.0),
                fn_=p.get("False northing", 0.0),
                k0=p.get("Scale factor at natural origin", 1.0),
            )
            return cls(lcc=lcc, **common)
        if mcode == 9809 or mname == "Oblique Stereographic":
            st = _ObliqueStereo(
                a, inv_f,
                lat0=p.get("Latitude of natural origin", 0.0),
                lon0=p.get("Longitude of natural origin", 0.0),
                k0=p.get("Scale factor at natural origin", 1.0),
                fe=p.get("False easting", 0.0),
                fn_=p.get("False northing", 0.0),
            )
            return cls(stereo=st, **common)
        if mcode == 9810 or mname == "Polar Stereographic (variant A)":
            ps = _PolarStereo(
                a, inv_f,
                lat0=p.get("Latitude of natural origin", 90.0),
                lon0=p.get("Longitude of natural origin", 0.0),
                k0=p.get("Scale factor at natural origin", 1.0),
                fe=p.get("False easting", 0.0),
                fn_=p.get("False northing", 0.0),
            )
            return cls(polar=ps, **common)
        if mcode == 9829 or mname == "Polar Stereographic (variant B)":
            ps = _PolarStereo(
                a, inv_f,
                lat_ts=p.get("Latitude of standard parallel", -90.0),
                lon0=p.get("Longitude of origin", 0.0),
                fe=p.get("False easting", 0.0),
                fn_=p.get("False northing", 0.0),
            )
            return cls(polar=ps, **common)
        if mcode == 1024 or "Popular Visualisation Pseudo Mercator" in mname:
            merc = _Mercator(
                a, inv_f,
                lon0=p.get("Longitude of natural origin", 0.0),
                fe=p.get("False easting", 0.0),
                fn_=p.get("False northing", 0.0),
                spherical=True,  # sphere of radius a, geodetic latitude
            )
            return cls(mercator=merc, **common)
        if mcode == 9804 or mname == "Mercator (variant A)":
            merc = _Mercator(
                a, inv_f,
                lon0=p.get("Longitude of natural origin", 0.0),
                k0=p.get("Scale factor at natural origin", 1.0),
                fe=p.get("False easting", 0.0),
                fn_=p.get("False northing", 0.0),
            )
            return cls(mercator=merc, **common)
        if mcode == 9805 or mname == "Mercator (variant B)":
            merc = _Mercator(
                a, inv_f,
                lon0=p.get("Longitude of natural origin", 0.0),
                lat_ts=p.get("Latitude of 1st standard parallel", 0.0),
                fe=p.get("False easting", 0.0),
                fn_=p.get("False northing", 0.0),
            )
            return cls(mercator=merc, **common)
        raise NotImplementedError(
            f"EPSG:{code} uses projection method {mname!r} (EPSG:{mcode}), which this "
            f"framework does not implement (supported: Transverse Mercator, Lambert "
            f"Conformal Conic 1SP/2SP, Oblique Stereographic, Polar Stereographic A/B, "
            f"Mercator A/B incl. Web Mercator)"
        )

    @classmethod
    def _from_proj4(cls, s: str) -> "CRS":
        if "proj=utm" in s:
            zone = int(re.search(r"zone=(\d+)", s).group(1))
            south = "+south" in s
            return cls.from_epsg((32700 if south else 32600) + zone)
        if "proj=longlat" in s or "proj=latlong" in s:
            return cls.from_epsg(4326)
        raise NotImplementedError(f"proj4 string not supported: {s}")

    @classmethod
    def _from_wkt(cls, wkt: str) -> "CRS":
        # the authority ID of the whole CRS is the LAST top-level ID/AUTHORITY entry
        ids = re.findall(r'(?:ID|AUTHORITY)\s*\[\s*"EPSG"\s*,\s*"?(\d+)"?\s*\]', wkt)
        if ids:
            try:
                crs = cls.from_epsg(int(ids[-1]))
                crs.wkt = wkt
                return crs
            except NotImplementedError:
                pass
        def param(names, default):
            for name in names:
                m = re.search(rf'PARAMETER\s*\[\s*"{name}"\s*,\s*([-\d.eE+]+)', wkt, re.I)
                if m:
                    return float(m.group(1))
            return default

        def ellipsoid_of():
            m = re.search(r'ELLIPSOID\s*\[\s*"([^"]+)"\s*,\s*([-\d.eE+]+)\s*,\s*([-\d.eE+]+)', wkt)
            if m:
                return float(m.group(2)), float(m.group(3))
            m = re.search(r'SPHEROID\s*\[\s*"([^"]+)"\s*,\s*([-\d.eE+]+)\s*,\s*([-\d.eE+]+)', wkt)
            if m:
                return float(m.group(2)), float(m.group(3))
            return 6378137.0, 298.257223563

        def datum_shift():
            m = re.search(r'DATUM\s*\[\s*"([^"]+)"', wkt)
            if m and m.group(1) in _TOWGS84:
                return _TOWGS84[m.group(1)]
            m = re.search(r"TOWGS84\s*\[([^\]]+)\]", wkt)
            if m:
                vals = [float(v) for v in m.group(1).split(",")]
                return tuple(vals + [0.0] * (7 - len(vals)))
            return None

        # generic transverse mercator: parse projection parameters
        if re.search(r"Transverse\s*_?Mercator", wkt, re.I):
            lon0 = param([r"Longitude of natural origin", r"central_meridian"], 0.0)
            lat0 = param([r"Latitude of natural origin", r"latitude_of_origin"], 0.0)
            k0 = param([r"Scale factor at natural origin", r"scale_factor"], 0.9996)
            fe = param([r"False easting", r"false_easting"], 500000.0)
            fn_ = param([r"False northing", r"false_northing"], 0.0)
            return cls(
                wkt=wkt,
                lon0=lon0,
                lat0=lat0,
                k0=k0,
                false_easting=fe,
                false_northing=fn_,
                ellipsoid=ellipsoid_of(),
                towgs84=datum_shift(),
            )
        # Lambert Conformal Conic, 2SP (EPSG 9802) or 1SP (EPSG 9801)
        if re.search(r"Lambert[\s_]*Coni?c[\s_]*Conformal|Lambert[\s_]*Conformal[\s_]*Conic", wkt, re.I):
            a, inv_f = ellipsoid_of()
            lat0 = param([r"Latitude of (?:false|natural) origin", r"latitude_of_origin"], 0.0)
            lon0 = param([r"Longitude of (?:false|natural) origin", r"central_meridian",
                          r"Longitude of origin"], 0.0)
            sp1 = param([r"Latitude of 1st standard parallel", r"standard_parallel_1"], None)
            sp2 = param([r"Latitude of 2nd standard parallel", r"standard_parallel_2"], None)
            k0 = param([r"Scale factor at natural origin", r"scale_factor"], 1.0)
            fe = param([r"Easting at false origin", r"False easting", r"false_easting"], 0.0)
            fn_ = param([r"Northing at false origin", r"False northing", r"false_northing"], 0.0)
            lcc = _LambertConformal(a, inv_f, lat0=lat0, lon0=lon0, fe=fe, fn_=fn_, sp1=sp1, sp2=sp2, k0=k0)
            ids = re.findall(r'(?:ID|AUTHORITY)\s*\[\s*"EPSG"\s*,\s*"?(\d+)"?\s*\]', wkt)
            return cls(
                epsg=int(ids[-1]) if ids else None,
                wkt=wkt,
                lcc=lcc,
                ellipsoid=(a, inv_f),
                towgs84=datum_shift(),
            )
        if re.search(r"Oblique[\s_]*Stereographic", wkt, re.I):
            a, inv_f = ellipsoid_of()
            stereo = _ObliqueStereo(
                a,
                inv_f,
                lat0=param([r"Latitude of natural origin", r"latitude_of_origin"], 0.0),
                lon0=param([r"Longitude of natural origin", r"central_meridian"], 0.0),
                k0=param([r"Scale factor at natural origin", r"scale_factor"], 1.0),
                fe=param([r"False easting", r"false_easting"], 0.0),
                fn_=param([r"False northing", r"false_northing"], 0.0),
            )
            ids = re.findall(r'(?:ID|AUTHORITY)\s*\[\s*"EPSG"\s*,\s*"?(\d+)"?\s*\]', wkt)
            return cls(
                epsg=int(ids[-1]) if ids else None,
                wkt=wkt,
                stereo=stereo,
                ellipsoid=(a, inv_f),
                towgs84=datum_shift(),
            )
        if re.search(r"Polar[\s_]*Stereographic", wkt, re.I):
            a, inv_f = ellipsoid_of()
            lat_ts = param([r"Latitude of standard parallel", r"standard_parallel_1"], None)
            if lat_ts is not None:  # variant B
                ps = _PolarStereo(
                    a, inv_f, lat_ts=lat_ts,
                    lon0=param([r"Longitude of origin", r"central_meridian"], 0.0),
                    fe=param([r"False easting", r"false_easting"], 0.0),
                    fn_=param([r"False northing", r"false_northing"], 0.0),
                )
            else:  # variant A
                ps = _PolarStereo(
                    a, inv_f,
                    lat0=param([r"Latitude of natural origin", r"latitude_of_origin"], 90.0),
                    lon0=param([r"Longitude of natural origin", r"central_meridian"], 0.0),
                    k0=param([r"Scale factor at natural origin", r"scale_factor"], 1.0),
                    fe=param([r"False easting", r"false_easting"], 0.0),
                    fn_=param([r"False northing", r"false_northing"], 0.0),
                )
            ids = re.findall(r'(?:ID|AUTHORITY)\s*\[\s*"EPSG"\s*,\s*"?(\d+)"?\s*\]', wkt)
            return cls(
                epsg=int(ids[-1]) if ids else None,
                wkt=wkt,
                polar=ps,
                ellipsoid=(a, inv_f),
                towgs84=datum_shift(),
            )
        if re.search(r"GEOGCR?S", wkt) and not re.search(r"PROJCR?S", wkt):
            crs = cls.from_epsg(4326)
            crs.wkt = wkt
            return crs
        if re.search(r"PROJCR?S", wkt):
            # unknown projection family: the pipeline runs entirely in projected
            # coordinates; only lon/lat conversion is unavailable.
            return cls(wkt=wkt, opaque_projected=True)
        raise NotImplementedError("unsupported WKT CRS")

    # -- properties ------------------------------------------------------------

    @property
    def is_geographic(self) -> bool:
        return self.geographic

    @property
    def is_projected(self) -> bool:
        return not self.geographic

    def to_wkt(self) -> str:
        if self.wkt:
            return self.wkt
        if self.polar is not None or self.mercator is not None or self.unit != 1.0:
            # families the built-in WKT renderers don't cover: use the
            # authoritative registry WKT (these CRSs were themselves resolved
            # through projinfo, so it is present whenever they exist)
            w = _projinfo_wkt(self.epsg) if self.epsg else None
            if w:
                self.wkt = w
                return w
            raise NotImplementedError(
                f"WKT serialization for {self!r} needs the system PROJ database (projinfo)"
            )
        if self.geographic:
            return (
                'GEOGCRS["WGS 84",DATUM["World Geodetic System 1984",'
                'ELLIPSOID["WGS 84",6378137,298.257223563,LENGTHUNIT["metre",1]]],'
                'PRIMEM["Greenwich",0,ANGLEUNIT["degree",0.0174532925199433]],'
                "CS[ellipsoidal,2],"
                'AXIS["geodetic latitude (Lat)",north,ORDER[1],ANGLEUNIT["degree",0.0174532925199433]],'
                'AXIS["geodetic longitude (Lon)",east,ORDER[2],ANGLEUNIT["degree",0.0174532925199433]],'
                'ID["EPSG",4326]]'
            )
        if self.stereo is not None or self.lcc is not None or self.lat0 != 0.0 \
                or self.towgs84 is not None or self.ellipsoid != (6378137.0, 298.257223563):
            return self._to_wkt1()
        name = f"WGS 84 / UTM zone {self._zone_name()}" if self.epsg else "WGS 84 / custom TM"
        idtail = f',ID["EPSG",{self.epsg}]' if self.epsg else ""
        return (
            f'PROJCRS["{name}",BASEGEOGCRS["WGS 84",DATUM["World Geodetic System 1984",'
            f'ELLIPSOID["WGS 84",6378137,298.257223563,LENGTHUNIT["metre",1]]],'
            f'PRIMEM["Greenwich",0,ANGLEUNIT["degree",0.0174532925199433]],ID["EPSG",4326]],'
            f'CONVERSION["Transverse Mercator",METHOD["Transverse Mercator",ID["EPSG",9807]],'
            f'PARAMETER["Latitude of natural origin",0,ANGLEUNIT["degree",0.0174532925199433],ID["EPSG",8801]],'
            f'PARAMETER["Longitude of natural origin",{self.lon0},ANGLEUNIT["degree",0.0174532925199433],ID["EPSG",8802]],'
            f'PARAMETER["Scale factor at natural origin",{self.k0},SCALEUNIT["unity",1],ID["EPSG",8805]],'
            f'PARAMETER["False easting",{self.false_easting},LENGTHUNIT["metre",1],ID["EPSG",8806]],'
            f'PARAMETER["False northing",{self.false_northing},LENGTHUNIT["metre",1],ID["EPSG",8807]]],'
            f'CS[Cartesian,2],AXIS["(E)",east,ORDER[1],LENGTHUNIT["metre",1]],'
            f'AXIS["(N)",north,ORDER[2],LENGTHUNIT["metre",1]]{idtail}]'
        )

    def _to_wkt1(self) -> str:
        """WKT1 (PROJCS) for non-WGS84-TM families: carries the real ellipsoid,
        TOWGS84 datum shift and projection parameters so downstream GIS tools
        (QGIS via the GeoTIFF/UGRID writers) and our own parser both read it."""
        a, inv_f = self.ellipsoid
        ell_name = next((k for k, v in _ELLIPSOIDS.items() if v == (a, inv_f)), "unnamed")
        datum_name = (self.name or "unnamed").replace(" / ", "_").replace(" ", "_")
        towgs = f",TOWGS84[{','.join(repr(float(v)) for v in self.towgs84)}]" if self.towgs84 else ""
        geogcs = (
            f'GEOGCS["{datum_name}",DATUM["{datum_name}",'
            f'SPHEROID["{ell_name}",{a!r},{inv_f!r}]{towgs}],'
            f'PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433]]'
        )
        if self.stereo is not None:
            s = self.stereo
            proj = (
                f'PROJECTION["Oblique_Stereographic"],'
                f'PARAMETER["latitude_of_origin",{math.degrees(s.lat0)!r}],'
                f'PARAMETER["central_meridian",{math.degrees(s.lon0)!r}],'
                f'PARAMETER["scale_factor",{s.k0!r}],'
                f'PARAMETER["false_easting",{s.fe!r}],PARAMETER["false_northing",{s.fn!r}]'
            )
        elif self.lcc is not None:
            p = self.lcc
            if p.sp1 is not None and p.sp2 is not None:
                proj = (
                    f'PROJECTION["Lambert_Conformal_Conic_2SP"],'
                    f'PARAMETER["latitude_of_origin",{p.lat0!r}],'
                    f'PARAMETER["central_meridian",{p.lon0!r}],'
                    f'PARAMETER["standard_parallel_1",{p.sp1!r}],'
                    f'PARAMETER["standard_parallel_2",{p.sp2!r}],'
                    f'PARAMETER["false_easting",{p.fe!r}],PARAMETER["false_northing",{p.fn!r}]'
                )
            else:
                proj = (
                    f'PROJECTION["Lambert_Conformal_Conic_1SP"],'
                    f'PARAMETER["latitude_of_origin",{p.lat0!r}],'
                    f'PARAMETER["central_meridian",{p.lon0!r}],'
                    f'PARAMETER["scale_factor",{p.k0!r}],'
                    f'PARAMETER["false_easting",{p.fe!r}],PARAMETER["false_northing",{p.fn!r}]'
                )
        else:
            proj = (
                f'PROJECTION["Transverse_Mercator"],'
                f'PARAMETER["latitude_of_origin",{self.lat0!r}],'
                f'PARAMETER["central_meridian",{self.lon0!r}],'
                f'PARAMETER["scale_factor",{self.k0!r}],'
                f'PARAMETER["false_easting",{self.false_easting!r}],'
                f'PARAMETER["false_northing",{self.false_northing!r}]'
            )
        auth = f',AUTHORITY["EPSG","{self.epsg}"]' if self.epsg else ""
        return (
            f'PROJCS["{self.name or datum_name}",{geogcs},{proj},'
            f'UNIT["metre",1],AXIS["Easting",EAST],AXIS["Northing",NORTH]{auth}]'
        )

    def _zone_name(self) -> str:
        if self.epsg and 32601 <= self.epsg <= 32660:
            return f"{self.epsg - 32600}N"
        if self.epsg and 32701 <= self.epsg <= 32760:
            return f"{self.epsg - 32700}S"
        return "?"

    def __eq__(self, other) -> bool:
        if not isinstance(other, CRS):
            try:
                other = CRS.from_user_input(other)
            except Exception:
                return NotImplemented
        if self.geographic and other.geographic:
            return True
        if self.epsg is not None and other.epsg is not None:
            return self.epsg == other.epsg
        if self.opaque_projected or other.opaque_projected:
            return self.wkt == other.wkt
        if (
            (self.stereo is None) != (other.stereo is None)
            or (self.lcc is None) != (other.lcc is None)
            or (self.polar is None) != (other.polar is None)
            or (self.mercator is None) != (other.mercator is None)
            or self.unit != other.unit
        ):
            return False
        if self.polar is not None:
            s, o = self.polar, other.polar
            return (s.lat0, s.lon0, s.k0, s.fe, s.fn, s.a, s.inv_f) == (
                o.lat0, o.lon0, o.k0, o.fe, o.fn, o.a, o.inv_f)
        if self.mercator is not None:
            s, o = self.mercator, other.mercator
            return (s.lon0, s.k0, s.fe, s.fn, s.a, s.inv_f, s.spherical) == (
                o.lon0, o.k0, o.fe, o.fn, o.a, o.inv_f, o.spherical)
        if self.stereo is not None:
            s, o = self.stereo, other.stereo
            return (s.lat0, s.lon0, s.k0, s.fe, s.fn, s.a, s.f) == (o.lat0, o.lon0, o.k0, o.fe, o.fn, o.a, o.f)
        if self.lcc is not None:
            s, o = self.lcc, other.lcc
            return (s.lat0, s.lon0, s.sp1, s.sp2, s.k0, s.fe, s.fn, s.a, s.f) == (
                o.lat0, o.lon0, o.sp1, o.sp2, o.k0, o.fe, o.fn, o.a, o.f)
        return (
            self.geographic == other.geographic
            and self.lon0 == other.lon0
            and self.lat0 == other.lat0
            and self.k0 == other.k0
            and self.false_easting == other.false_easting
            and self.false_northing == other.false_northing
            and self.ellipsoid == other.ellipsoid
        )

    def __repr__(self):
        if self.geographic:
            return f"CRS(EPSG:{self.epsg or 4326}, geographic)"
        if self.opaque_projected:
            return "CRS(projected, unknown method)"
        kind = (
            "oblique-stereo" if self.stereo is not None
            else "LCC" if self.lcc is not None
            else "polar-stereo" if self.polar is not None
            else ("web-mercator" if self.mercator.spherical else "mercator") if self.mercator is not None
            else f"TM lon0={self.lon0}"
        )
        unit = "" if self.unit == 1.0 else f", unit={self.unit:.6g} m"
        return f"CRS(EPSG:{self.epsg or '?'}, {kind}{unit})"

    # -- transforms ------------------------------------------------------------
    # to_lonlat / from_lonlat speak WGS84 lon/lat; non-WGS84 datums are bridged
    # with a 7-parameter Helmert shift when known.

    def _datum_to_wgs84(self, lon, lat):
        if self.towgs84 is None:
            return lon, lat
        a, inv_f = self.ellipsoid
        X, Y, Z = _geodetic_to_geocentric(lon, lat, a, 1.0 / inv_f)
        X, Y, Z = _helmert(X, Y, Z, self.towgs84)
        return _geocentric_to_geodetic(X, Y, Z, _A, _F)

    def _datum_from_wgs84(self, lon, lat):
        if self.towgs84 is None:
            return np.asarray(lon, dtype=np.float64), np.asarray(lat, dtype=np.float64)
        X, Y, Z = _geodetic_to_geocentric(lon, lat, _A, _F)
        X, Y, Z = _helmert(X, Y, Z, self.towgs84, inverse=True)
        a, inv_f = self.ellipsoid
        return _geocentric_to_geodetic(X, Y, Z, a, 1.0 / inv_f)

    def to_lonlat(self, x, y) -> Tuple[np.ndarray, np.ndarray]:
        if self.geographic:
            return np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
        if self.opaque_projected:
            raise NotImplementedError(
                "lon/lat conversion for this projected CRS is not supported (unknown projection "
                "method in WKT); the velocimetry pipeline itself runs fully in projected coordinates"
            )
        if self.unit != 1.0:  # axis units (e.g. US survey foot) -> metres
            x = np.asarray(x, dtype=np.float64) * self.unit
            y = np.asarray(y, dtype=np.float64) * self.unit
        if self.stereo is not None:
            lon, lat = self.stereo.reverse(x, y)
        elif self.lcc is not None:
            lon, lat = self.lcc.reverse(x, y)
        elif self.polar is not None:
            lon, lat = self.polar.reverse(x, y)
        elif self.mercator is not None:
            lon, lat = self.mercator.reverse(x, y)
        else:
            a, inv_f = self.ellipsoid
            lon, lat = _tm_reverse(
                x, y, self.lon0, self.k0, self.false_easting, self.false_northing,
                a=a, f=1.0 / inv_f, lat0=self.lat0,
            )
        return self._datum_to_wgs84(lon, lat)

    def from_lonlat(self, lon, lat) -> Tuple[np.ndarray, np.ndarray]:
        if self.geographic:
            return np.asarray(lon, dtype=np.float64), np.asarray(lat, dtype=np.float64)
        if self.opaque_projected:
            raise NotImplementedError(
                "lon/lat conversion for this projected CRS is not supported (unknown projection "
                "method in WKT)"
            )
        lon, lat = self._datum_from_wgs84(lon, lat)
        if self.stereo is not None:
            E, N = self.stereo.forward(lon, lat)
        elif self.lcc is not None:
            E, N = self.lcc.forward(lon, lat)
        elif self.polar is not None:
            E, N = self.polar.forward(lon, lat)
        elif self.mercator is not None:
            E, N = self.mercator.forward(lon, lat)
        else:
            a, inv_f = self.ellipsoid
            E, N = _tm_forward(lon, lat, self.lon0, self.k0, self.false_easting,
                               self.false_northing, a=a, f=1.0 / inv_f, lat0=self.lat0)
        if self.unit != 1.0:  # metres -> axis units (e.g. US survey foot)
            return E / self.unit, N / self.unit
        return E, N


def transform_points(src: Union[CRS, int, str], dst: Union[CRS, int, str], x, y) -> Tuple[np.ndarray, np.ndarray]:
    """Transform coordinate arrays between two CRSs (always-xy axis order)."""
    src = CRS.from_user_input(src)
    dst = CRS.from_user_input(dst)
    if src == dst:
        return np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
    lon, lat = src.to_lonlat(x, y)
    return dst.from_lonlat(lon, lat)
