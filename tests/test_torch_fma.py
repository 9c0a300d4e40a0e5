"""The port's emulated fused multiply-adds (``pyorc_tpu_torch/_fma.py``) against exact rational arithmetic.

``fma32`` is what lets ``ops/interp.map_linear`` round as XLA's CPU build
rounds the JAX package's jitted deformation; the float64 ``fma`` (held in
``tests/test_torch_ortho_maps.py``) is the ortho-map twins'. A float64
product plus a float64 add would round twice: the cases here include sums
whose float64 rounding lands exactly on a float32 midpoint.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from pyorc_tpu_torch._fma import fma32
from pyorc_tpu_torch.ops.interp import map_linear


def _round32(x: Fraction) -> np.float32:
    """``x`` rounded once to the nearest float32, ties to even."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    err = [abs(Fraction(float(c)) - x) for c in cands]
    best = min(err)
    ties = [c for c, e in zip(cands, err) if e == best]
    return min(ties, key=lambda c: int(np.array(c).view(np.int32)) & 1)


def _midpoint_cases(rng, n):
    """(a, b, c) float32 with a * b = 2^-24 * (1 + s 2^-47), 0 < s < 2^18, and c = 1: the exact sum sits a
    hair above the float32 midpoint 1 + 2^-24, where a float64 sum rounds onto the midpoint."""
    out = []
    while len(out) < n:
        A = int(rng.integers(1 << 23, 1 << 24))
        B = -(-(1 << 47) // A)
        if B < (1 << 24) and 0 < A * B - (1 << 47) < (1 << 18):
            out.append((A * 2.0**-36, B * 2.0**-35, 1.0))
    return [np.array(col, dtype=np.float32) for col in zip(*out)]


def test_fma32_rounds_once(rng):
    """Random magnitudes, sums that cancel to a few ulps, and sums just past a float32 midpoint (both
    signs, scaled): ``fma32`` equals the exact ``a * b + c`` rounded once to float32."""
    m = 1500
    a = (rng.uniform(1, 2, m) * 2.0 ** rng.integers(-20, 20, m) * rng.choice([-1, 1], m)).astype(np.float32)
    b = (rng.uniform(1, 2, m) * 2.0 ** rng.integers(-20, 20, m)).astype(np.float32)
    p = a.astype(np.float64) * b
    cases = [
        (a, b, (rng.standard_normal(m) * np.abs(p) * 2.0 ** rng.integers(-30, 30, m)).astype(np.float32)),
        (a, b, (-p).astype(np.float32)),
    ]
    ma, mb, mc = _midpoint_cases(rng, 64)
    scale = (2.0 ** rng.integers(-10, 10, 64)).astype(np.float32)
    sign = rng.choice([-1.0, 1.0], 64).astype(np.float32)
    cases.append((ma * scale * sign, mb * scale, mc * scale * scale * sign))
    for x, y, c in cases:
        want = np.array([_round32(Fraction(float(u)) * Fraction(float(v)) + Fraction(float(w)))
                         for u, v, w in zip(x, y, c)], dtype=np.float32)
        got = fma32(*(torch.as_tensor(t) for t in (x, y, c))).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    twice = (ma.astype(np.float64) * mb + mc).astype(np.float32)
    assert (twice != fma32(*(torch.as_tensor(t) for t in (ma, mb, mc))).numpy()).all()  # the cases bite


def test_map_linear_orders(rng):
    """``map_linear``'s three rounding orders sum the same four terms (within a float32 ulp of 255), the
    fused ones as their chains of ``fma32`` say, and an unknown order raises."""
    field = torch.as_tensor(rng.uniform(0, 255, (2, 30, 40)).astype(np.float32))
    rows = torch.as_tensor(rng.uniform(-3, 33, (25, 35)).astype(np.float32))
    cols = torch.as_tensor(rng.uniform(-3, 43, (25, 35)).astype(np.float32))
    plain, a, b = (map_linear(field, rows, cols, order=o) for o in ("plain", "fma_a", "fma_b"))
    r0, c0 = torch.floor(rows), torch.floor(cols)
    wr1, wc1 = rows - r0, cols - c0
    wr, wc = (1 - wr1, wr1), (1 - wc1, wc1)
    ri = [(r0.long() + k).clamp(0, 29) for k in (0, 1)]
    ci = [(c0.long() + k).clamp(0, 39) for k in (0, 1)]
    w = {(i, j): wr[i] * wc[j] for i in (0, 1) for j in (0, 1)}
    t = {(i, j): field[:, ri[i], ci[j]] for i in (0, 1) for j in (0, 1)}
    want_a = fma32(w[1, 1], t[1, 1], fma32(w[1, 0], t[1, 0], fma32(w[0, 0], t[0, 0], w[0, 1] * t[0, 1])))
    want_b = fma32(w[1, 1], t[1, 1], fma32(w[1, 0], t[1, 0], fma32(w[0, 1], t[0, 1], w[0, 0] * t[0, 0])))
    assert torch.equal(a, want_a) and torch.equal(b, want_b)
    assert not torch.equal(a, plain) and not torch.equal(b, plain) and not torch.equal(a, b)
    for got in (a, b):
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=255 * 2.0**-22)
    with pytest.raises(ValueError, match="order must be one of"):
        map_linear(field, rows, cols, order="fma")
