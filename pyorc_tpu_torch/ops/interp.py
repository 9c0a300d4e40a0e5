"""Bilinear resampling shared by multipass PIV and STIV.

``jax.scipy.ndimage.map_coordinates(order=1, mode="nearest")`` of the JAX
package written out as a gather from floor, weights and edge-clamped indices,
in JAX's order of operations (``grid_sample``'s normalised coordinates would
add rounding that JAX does not have).
"""

from __future__ import annotations

import torch

__all__ = ["map_linear"]


def map_linear(field: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``map_coordinates(field, [rows, cols], order=1, mode="nearest")`` over the
    last two axes of ``field`` [..., h, w] -> [..., h', w']. ``rows`` and
    ``cols`` broadcast to [h', w'] (the same points for every leading index
    of ``field``) or to [..., h', w'] (points of their own for each). A
    uint8 ``field`` is read as float32 after the gather."""
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

    out = (wr0 * wc0) * take(ri[0], ci[0])
    out = out + (wr0 * wc1) * take(ri[0], ci[1])
    out = out + (wr1 * wc0) * take(ri[1], ci[0])
    return out + (wr1 * wc1) * take(ri[1], ci[1])
