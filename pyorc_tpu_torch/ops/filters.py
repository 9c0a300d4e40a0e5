"""Frame preprocessing filters as PyTorch ops on [T, H, W] batches.

Port of :mod:`pyorc_tpu.ops.filters`: device-side replacements for the
reference's per-frame dask/OpenCV filters (reference
``pyorc/api/frames.py:279-467`` + ``pyorc/cv.py:142-183``). Every filter is
float32 in the JAX version's order of operations. The separable Gaussian
convolutions are written out as sums over the taps of shifted slices, not as
``F.conv2d``: cuDNN runs float32 convolutions in TF32 unless a global flag is
changed, and a 10-bit mantissa on a 0-255 image misses the velocity bar.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "gaussian_kernel_cv",
    "gaussian_blur",
    "edge_detect",
    "normalize_with_mean",
    "normalize_with_stats",
    "time_diff",
    "minmax",
    "saturating_cast",
    "numpy_uint8_cast",
    "video_uint8",
    "frame_range",
    "reduce_rolling",
]


def gaussian_kernel_cv(ksize: int) -> np.ndarray:
    """1-D Gaussian kernel identical to OpenCV's getGaussianKernel(ksize, 0).

    OpenCV uses fixed binomial kernels for ksize <= 7 with sigma<=0, else
    sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8.
    """
    fixed = {
        1: [1.0],
        3: [0.25, 0.5, 0.25],
        5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
        7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    }
    if ksize in fixed:
        return np.asarray(fixed[ksize], dtype=np.float32)
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    k = k / k.sum()
    # OpenCV uses a bit-exact kernel quantized to multiples of 1/256, with the
    # rounding residual folded into the centre tap — replicate for parity
    q = np.round(k * 256)
    q[ksize // 2] -= q.sum() - 256
    return (q / 256).astype(np.float32)


def _sep_conv(frames: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable 2-D convolution with REFLECT_101 borders on float32 [T, H, W].

    Rows then columns, each a sum over the taps of shifted slices of the
    reflect-padded batch in IEEE float32.
    """
    taps = [float(k) for k in kernel]
    pad = len(taps) // 2
    if pad == 0:
        return frames
    t, h, w = frames.shape
    x = F.pad(frames[:, None], (pad, pad, pad, pad), mode="reflect")[:, 0]
    rows = taps[0] * x[:, 0:h]
    for i in range(1, len(taps)):
        rows = rows + taps[i] * x[:, i : i + h]
    out = taps[0] * rows[:, :, 0:w]
    for i in range(1, len(taps)):
        out = out + taps[i] * rows[:, :, i : i + w]
    return out


def gaussian_blur(frames: torch.Tensor, ksize: int) -> torch.Tensor:
    """cv2.GaussianBlur-equivalent smooth (reference pyorc/cv.py:142-159)."""
    return _sep_conv(frames.to(torch.float32), gaussian_kernel_cv(ksize))


def edge_detect(frames: torch.Tensor, ksize_1: int, ksize_2: int) -> torch.Tensor:
    """Difference-of-Gaussians band filter (reference pyorc/cv.py:162-183)."""
    f = frames.to(torch.float32)
    blur1 = _sep_conv(f, gaussian_kernel_cv(ksize_1))
    blur2 = _sep_conv(f, gaussian_kernel_cv(ksize_2))
    return blur2 - blur1


def normalize_with_mean(frames: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Subtract the temporal mean and rescale each frame to [0, 255] uint8.

    Core of Frames.normalize (reference pyorc/api/frames.py:279-306). The
    float32 operation order and the truncating uint8 cast follow the JAX
    version, so both give the same bytes.
    """
    reduce = frames.to(torch.float32) - mean
    fmin = reduce.amin(dim=(-2, -1), keepdim=True)
    fmax = reduce.amax(dim=(-2, -1), keepdim=True)
    return ((reduce - fmin) / (fmax - fmin) * 255).to(torch.uint8)


def normalize_with_stats(frames: torch.Tensor, mean: torch.Tensor, fmin: torch.Tensor, fmax: torch.Tensor):
    """``normalize_with_mean`` with the per-frame extrema supplied by the caller."""
    reduce = frames.to(torch.float32) - mean
    return ((reduce - fmin) / (fmax - fmin) * 255).to(torch.uint8)


def time_diff(frames: torch.Tensor, thres: float = 0.0, abs: bool = False) -> torch.Tensor:
    """Temporal differencing (reference pyorc/api/frames.py:409-436): the
    threshold is applied to the signed difference, ``abs`` after it."""
    d = torch.diff(frames.to(torch.float32), dim=0)
    d = torch.where(d > thres, d, 0.0)
    return torch.abs(d) if abs else d


def minmax(frames: torch.Tensor, min: float = -np.inf, max: float = np.inf) -> torch.Tensor:
    """Clip to [min, max] in float32 (integer frames are promoted against the
    float bounds, as in the JAX version; NaN stays NaN). The caller casts back."""
    f = frames.to(torch.float32)
    lo = torch.tensor(min, dtype=torch.float32, device=f.device)
    hi = torch.tensor(max, dtype=torch.float32, device=f.device)
    return torch.maximum(torch.minimum(f, hi), lo)


def saturating_cast(frames: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``frames`` cast to ``dtype``; to an integer dtype out-of-range values saturate
    and NaN becomes 0, as XLA converts (a plain ``.to`` wraps: 300.0 -> 44 in uint8)."""
    if dtype.is_floating_point or dtype == torch.bool:
        return frames.to(dtype)
    info = torch.iinfo(dtype)
    return torch.nan_to_num(frames, nan=0.0).clamp(info.min, info.max).to(dtype)


def numpy_uint8_cast(values: torch.Tensor) -> torch.Tensor:
    """``values`` as uint8 by the rule that numpy's ``astype(np.uint8)`` follows for floats on
    x86-64, on any device: truncate toward zero to int32, where NaN, +-inf and anything outside
    the int32 range become INT_MIN, then keep the low byte (NaN -> 0, -5.0 -> 251, 300.0 -> 44,
    1e10 -> 0). Integers keep their low byte, as numpy wraps them. ``.to(torch.uint8)`` of an
    out-of-range float is undefined behaviour in C++, and a CUDA card is not bound to match."""
    if values.dtype == torch.uint8:
        return values
    if values.dtype.is_floating_point:
        valid = values.abs() < 2.0**31  # False for NaN and +-inf
        values = torch.where(valid, values, torch.zeros_like(values)).to(torch.int32)
    return (values.to(torch.int64) & 0xFF).to(torch.uint8)


def video_uint8(frames: torch.Tensor) -> torch.Tensor:
    """Frames [T, H, W] or RGB [T, H, W, 3] as the uint8 frames of a video, as the JAX
    package's ``Frames.to_video`` makes them frame by frame: a gray frame in float32 becomes
    ``(f - nanmin) / (nanmax - nanmin) * 255`` when nanmax > nanmin and stays as it is
    otherwise (an all-NaN or constant frame), then goes through :func:`numpy_uint8_cast`;
    RGB frames are cast as they are. Every step is an IEEE float32 op, so the bytes are the
    same on the CPU and on the card."""
    if frames.ndim == 4:
        return numpy_uint8_cast(frames)
    f = frames.to(torch.float32)
    nan = torch.isnan(f)
    fmin = torch.where(nan, torch.inf, f).amin(dim=(1, 2), keepdim=True)
    fmax = torch.where(nan, -torch.inf, f).amax(dim=(1, 2), keepdim=True)
    scaled = (f - fmin) / (fmax - fmin) * 255
    return numpy_uint8_cast(torch.where(fmax > fmin, scaled, f))


def frame_range(frames: torch.Tensor) -> torch.Tensor:
    """Temporal min-max range per pixel (reference pyorc/api/frames.py:364-379)."""
    return frames.amax(dim=0) - frames.amin(dim=0)


def reduce_rolling(frames: torch.Tensor, samples: int) -> torch.Tensor:
    """Remove rolling temporal mean (reference pyorc/api/frames.py:381-407).

    The rolling window is trailing with min_periods == samples (xarray
    default), so the first samples-1 frames have undefined rolling mean; the
    reference's ``where(roll_mean != 0, 0)`` + uint8 cast zeroes them.
    """
    f = frames.to(torch.float32)
    csum = torch.cumsum(f, dim=0)
    roll_sum = csum - torch.cat([torch.zeros_like(csum[:samples]), csum[:-samples]], dim=0)
    del csum
    roll_mean = roll_sum / samples
    del roll_sum
    t = f.shape[0]
    valid = (torch.arange(t, device=f.device) >= samples - 1)[:, None, None]
    thres = (f - roll_mean).clamp(min=0.0)
    denom = thres.amax(dim=(-2, -1), keepdim=True)
    norm = thres * 255 / denom.clamp(min=1e-10)
    norm = torch.where(valid & (roll_mean != 0), norm, 0.0)
    return norm.to(torch.uint8)
