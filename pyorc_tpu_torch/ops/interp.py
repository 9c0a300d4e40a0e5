"""Bilinear resampling shared by multipass PIV and STIV.

``jax.scipy.ndimage.map_coordinates(order=1, mode="nearest")`` of the JAX
package written out as a gather from floor, weights and edge-clamped indices,
in JAX's order of operations (``grid_sample``'s normalised coordinates would
add rounding that JAX does not have).

The four-term sum ``w00 t00 + w01 t01 + w10 t10 + w11 t11`` (``w`` the weight
products ``wr * wc``, ``t`` the corner values) rounds as the caller names it:

- ``"plain"``: every product and every sum rounded, left to right, as JAX
  writes it and as its eager functions run it;
- ``"fma_a"``: ``fma(w00, t00, w01 t01)``, then ``fma(w10, t10, .)``, then
  ``fma(w11, t11, .)``;
- ``"fma_b"``: ``fma(w01, t01, w00 t00)``, then the same two.

The last two are how XLA's CPU build compiles JAX's jitted multipass
deformation (``_deform_stage``): its LLVM back end contracts the plain chain
into fused multiply-adds, one way round in the dense predictor's fusion
(A) and the other in the frame samples' (B). Each FMA is
:func:`pyorc_tpu_torch._fma.fma32`, exact on any device.
"""

from __future__ import annotations

import torch

from .._fma import fma32

__all__ = ["map_linear"]


_ORDERS = ("plain", "fma_a", "fma_b")


def map_linear(field: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, order: str = "plain") -> torch.Tensor:
    """``map_coordinates(field, [rows, cols], order=1, mode="nearest")`` over the
    last two axes of ``field`` [..., h, w] -> [..., h', w']. ``rows`` and
    ``cols`` broadcast to [h', w'] (the same points for every leading index
    of ``field``) or to [..., h', w'] (points of their own for each). A
    uint8 ``field`` is read as float32 after the gather. ``order`` is the
    four-term sum's rounding order (module docstring)."""
    if order not in _ORDERS:
        raise ValueError(f"map_linear: order must be one of {_ORDERS}, got {order!r}")
    h, w = field.shape[-2], field.shape[-1]
    r0 = torch.floor(rows)
    c0 = torch.floor(cols)
    wr1, wc1 = rows - r0, cols - c0
    wr0, wc0 = 1 - wr1, 1 - wc1
    ri0 = r0.long()
    ci0 = c0.long()
    ri = (ri0.clamp(0, h - 1), (ri0 + 1).clamp(0, h - 1))
    ci = (ci0.clamp(0, w - 1), (ci0 + 1).clamp(0, w - 1))
    flat = field.flatten(-2)

    def take(a, b):
        idx = a * w + b
        out_shape = field.shape[:-2] + idx.shape[-2:]
        # a broadcast (stride-0) index: the points are not copied per leading index
        idx = idx.flatten(-2).expand(out_shape[:-2] + (-1,))
        return torch.gather(flat, -1, idx).view(out_shape).to(wr1.dtype)

    wr, wc = (wr0, wr1), (wc0, wc1)

    def product(i, j):
        return (wr[i] * wc[j]) * take(ri[i], ci[j])

    def fused(i, j, acc):
        return fma32(wr[i] * wc[j], take(ri[i], ci[j]), acc)

    if order == "plain":
        out = product(0, 0) + product(0, 1)
        out = out + product(1, 0)
        return out + product(1, 1)
    out = fused(0, 0, product(0, 1)) if order == "fma_a" else fused(0, 1, product(0, 0))
    return fused(1, 1, fused(1, 0, out))
