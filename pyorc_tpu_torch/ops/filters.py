"""Frame preprocessing filters as PyTorch ops on [T, H, W] batches.

Port of :mod:`pyorc_tpu.ops.filters`. Only the normalization that the main
path runs is ported so far; the other filters (Gaussian blur, edge
detection, time differencing, rolling reduction) are listed in ROADMAP.md.
"""

from __future__ import annotations

import torch

__all__ = ["normalize_with_mean", "normalize_with_stats"]


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
