"""Fused multiply-adds emulated exactly with plain tensor operations.

The port reproduces two hosts' roundings that fuse a product into a sum: a
BLAS that rounds each term of a 3x3 product as a chain of fused
multiply-adds (the ortho maps' ``*_tensor`` twins in ``geom/camera.py``), and
XLA's CPU build, whose LLVM back end contracts the four-term sums of
``map_coordinates(order=1)`` into fused multiply-adds (the multipass
deformation, ``ops/interp.map_linear``). PyTorch has no elementwise FMA, so
each is written here from IEEE operations that round once each, on any
device.
"""

from __future__ import annotations

import math

import torch

__all__ = ["fma", "fma32"]

_SPLIT = 134217729.0  # 2**27 + 1, Veltkamp's constant: splits a float64 into two 26-bit halves


def _split(a):
    t = a * _SPLIT
    hi = t - (t - a)
    return hi, a - hi


def _two_sum(a, b):
    """(s, t) with s = a + b rounded and s + t = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_odd(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``v + w`` rounded to odd, where ``v`` is ``v + w`` rounded to nearest: ``v`` where the sum is
    exact or ``v``'s last bit is odd, else its neighbour toward ``w``."""
    even = (v.view(torch.int64) & 1) == 0
    return torch.where((w != 0) & even, torch.nextafter(v, torch.full_like(v, math.inf).copysign(w)), v)


def fma(a, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float64 rounded once, as a fused multiply-add rounds it.

    Boldo and Melquiond's emulated FMA: the product exactly as ``p + e``
    (Dekker), ``c + p`` exactly as ``s + t``, ``t + e`` rounded to odd, then
    one rounding of ``s`` plus that. Exact for finite values whose product
    neither overflows nor underflows.
    """
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s, t = _two_sum(c, p)
    return s + _round_odd(*_two_sum(t, e))


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once to float32, as ``fmaf`` rounds it.

    The product of two float32 values is exact in float64 and ``c + p`` is
    ``s + t`` exactly; ``s + t`` rounded to odd in float64 then rounds to
    float32 as the exact value does (53 >= 24 + 2 bits, Boldo and
    Melquiond). A float64 add alone would round twice.
    """
    p = a.double() * b.double()
    return _round_odd(*_two_sum(c.double(), p)).float()
