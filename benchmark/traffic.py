"""The benchmark's traffic: river videos made on the device from the seed, and the frame source that hands them out.

A configuration (``configs/<name>.json``) fixes the camera frame, the frame rate, the particle texture and its
motion in pixels a frame; a traffic mix (``workloads/<name>.json``) fixes the frames a video has and the ring
of frames the videos are cut from. :func:`make_ring` draws a particle texture from the seed, blurs it and
Fourier-shifts it by the motion times the frame's position in the ring: every frame of a video moves exactly
that many pixels from the last, at sub-pixel precision. The ring stays on the device as uint8;
:class:`DeviceFrameSource` answers the port's frame-source protocol (``_decode_frames``) with device tensors,
as a decoder on the card hands over its frames, so the port's chain runs from there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FIXED_POINT = float(1 << 24)  # splat weights summed as int64 fixed point: the same sums in any order
RING_BATCH = 8  # frames shifted at a time (complex128 spectra: ~1 GB a batch at 4K)


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def texture_spectrum(seed: int, h: int, w: int, density: float, sigma: float, device) -> torch.Tensor:
    """The 2-D spectrum (complex128 [h, w]) of a periodic particle texture drawn from ``seed`` on ``device``.

    ``density * h * w`` particles at uniform sub-pixel positions with amplitudes in [0.5, 1], splatted
    bilinearly (as integers in fixed point, so that the sums do not depend on the order of the device's
    atomic adds), blurred by a periodic Gaussian of width ``sigma`` px (its transfer function on the
    spectrum) and scaled to intensities in [20, 240].
    """
    gen = _generator(seed, device)
    n = int(density * h * w)
    xs = torch.rand(n, generator=gen, device=device, dtype=torch.float64) * (w - 1)
    ys = torch.rand(n, generator=gen, device=device, dtype=torch.float64) * (h - 1)
    amp = 0.5 + 0.5 * torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    x0, y0 = xs.floor(), ys.floor()
    fx, fy = xs - x0, ys - y0
    x0, y0 = x0.long(), y0.long()
    img = torch.zeros(h * w, dtype=torch.int64, device=device)
    for dy in (0, 1):
        for dx in (0, 1):
            wgt = (fy if dy else 1 - fy) * (fx if dx else 1 - fx)
            idx = torch.clamp(y0 + dy, max=h - 1) * w + torch.clamp(x0 + dx, max=w - 1)
            img.index_add_(0, idx, torch.round(amp * wgt * FIXED_POINT).long())
    spec = torch.fft.fft2(img.view(h, w).to(torch.float64) / FIXED_POINT)
    fy_ = torch.fft.fftfreq(h, dtype=torch.float64, device=device)[:, None]
    fx_ = torch.fft.fftfreq(w, dtype=torch.float64, device=device)[None, :]
    spec *= torch.exp(-2.0 * math.pi**2 * sigma**2 * (fy_**2 + fx_**2))
    base = torch.fft.ifft2(spec).real
    lo, hi = float(base.min()), float(base.max())
    scale = 220.0 / (hi - lo)
    spec *= scale
    spec[0, 0] += (20.0 - lo * scale) * h * w
    return spec


def make_ring(config: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The ring of frames (uint8 [ring_frames, h, w] on ``device``) that the traffic's videos are cut from.

    Frame ``i`` is the texture shifted by ``i`` times the configuration's ``shift_px`` (x, y) [px], by a
    phase ramp on the spectrum, in float64, truncated to uint8 after clamping to [0, 255].
    """
    h, w = config["height"], config["width"]
    sx, sy = config["shift_px"]
    tex = config["texture"]
    spec = texture_spectrum(seed, h, w, tex["density"], tex["sigma"], device)
    fy = torch.fft.fftfreq(h, dtype=torch.float64, device=device)
    fx = torch.fft.fftfreq(w, dtype=torch.float64, device=device)
    n = traffic["ring_frames"]
    ring = torch.empty((n, h, w), dtype=torch.uint8, device=device)
    for i0 in range(0, n, RING_BATCH):
        k = torch.arange(i0, min(i0 + RING_BATCH, n), dtype=torch.float64, device=device)
        py = torch.exp(-2j * math.pi * fy[None, :] * (sy * k[:, None]))
        px = torch.exp(-2j * math.pi * fx[None, :] * (sx * k[:, None]))
        frames = torch.fft.ifft2(spec[None] * py[:, :, None] * px[:, None, :]).real
        ring[i0 : i0 + len(k)] = frames.clamp_(0, 255).to(torch.uint8)
        del frames, py, px
    return ring


def video_starts(traffic: dict) -> list:
    """The first ring frame of each distinct video: the ring is cut into ``ring_frames // frames_per_video``
    consecutive videos, served in turn."""
    per = traffic["frames_per_video"]
    return [k * per for k in range(traffic["ring_frames"] // per)]


def transect_points(cfg: dict):
    """The cross-section (x, y, z) [m]: ``n_points`` from the left bank (+y) to the right bank at the frame's
    middle column, ``margin_px`` inside the area of interest, over a bed 0.1 m above the water at the banks
    and 1.4 m below it mid-channel."""
    h, w, res = cfg["height"], cfg["width"], cfg["resolution"]
    tr, a = cfg["transect"], cfg["camera"]["aoi_px"]
    y = np.linspace(res * (h - a - tr["margin_px"]), res * (a + tr["margin_px"]), tr["n_points"])
    x = np.full(tr["n_points"], res * w / 2)
    t = np.linspace(-1.0, 1.0, tr["n_points"])
    z = 0.1 - 1.5 * (1.0 - t**2)
    return x, y, z


class DeviceFrameSource:
    """One video of the ring as the port's frame source: ``_decode_frames(positions, method)`` gives the
    frames at ``positions`` of the video as a device tensor (a view where the positions are consecutive,
    else a gathered copy), as a decoder on the card hands over a batch."""

    def __init__(self, ring: torch.Tensor, start: int, n_frames: int, fn: str = "device ring"):
        self.ring = ring
        self.start = start
        self.n_frames = n_frames
        self.fn = fn

    def _decode_frames(self, positions, method, **_uploader):
        if method != "grayscale":
            raise ValueError(f"the benchmark's frames are gray, not {method!r}")
        pos = np.atleast_1d(np.asarray(positions, dtype=np.int64))
        if pos.size and (pos.min() < 0 or pos.max() >= self.n_frames):
            raise IndexError(f"frames {pos.min()}..{pos.max()} of a {self.n_frames}-frame video")
        if pos.size and np.all(np.diff(pos) == 1):
            return self.ring.narrow(0, self.start + int(pos[0]), int(pos.size))
        idx = torch.as_tensor(self.start + pos, device=self.ring.device)
        return self.ring.index_select(0, idx)
