"""Interrogation-window grid math and memory planning (host-side, static).

Replaces the external ``ffpiv.window`` API surface the reference imports
(reference call sites ``pyorc/api/frames.py:85,167`` and
``pyorc/velocimetry/ffpiv.py:120,129``): window-centre grids, even rounding,
and the memory model used to plan batch sizes. All shapes here are resolved
on the host before any kernel launches.

Grid convention (documented because the external ffpiv package is not
available to verify bit-for-bit): OpenPIV-compatible —
``n = (dim - search_area) // (search_area - overlap) + 1`` windows per axis,
window k starting at ``k * (search_area - overlap)`` with its centre at
``start + search_area // 2``. ``round_to_even`` keeps centres integral.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

__all__ = [
    "round_to_even",
    "get_field_shape",
    "get_rect_coordinates",
    "get_window_starts",
    "required_memory",
    "available_memory",
]


def round_to_even(window_size: Union[int, Sequence[int]]) -> Union[int, Tuple[int, ...]]:
    """Round window size(s) up to the nearest even integer."""
    if np.ndim(window_size) == 0:
        w = int(window_size)
        return w if w % 2 == 0 else w + 1
    return tuple(int(w) if int(w) % 2 == 0 else int(w) + 1 for w in window_size)


def _as2(v) -> Tuple[int, int]:
    if np.ndim(v) == 0:
        return int(v), int(v)
    return int(v[0]), int(v[1])


def get_field_shape(dim_size, search_area_size, overlap) -> Tuple[int, int]:
    """(n_rows, n_cols) of the interrogation-window grid."""
    dim = _as2(dim_size)
    sas = _as2(search_area_size)
    ov = _as2(overlap)
    n_rows = (dim[0] - sas[0]) // (sas[0] - ov[0]) + 1
    n_cols = (dim[1] - sas[1]) // (sas[1] - ov[1]) + 1
    return n_rows, n_cols


def get_rect_coordinates(dim_size, window_size, search_area_size, overlap) -> Tuple[np.ndarray, np.ndarray]:
    """Window-centre (cols_vector, rows_vector) as integer pixel indices."""
    sas = _as2(search_area_size)
    ov = _as2(overlap)
    n_rows, n_cols = get_field_shape(dim_size, search_area_size, overlap)
    rows = np.arange(n_rows) * (sas[0] - ov[0]) + sas[0] // 2
    cols = np.arange(n_cols) * (sas[1] - ov[1]) + sas[1] // 2
    return cols, rows


def get_window_starts(dim_size, search_area_size, overlap) -> Tuple[np.ndarray, np.ndarray]:
    """Top-left (row0s, col0s) of each window row/column band."""
    sas = _as2(search_area_size)
    ov = _as2(overlap)
    n_rows, n_cols = get_field_shape(dim_size, search_area_size, overlap)
    row0 = np.arange(n_rows) * (sas[0] - ov[0])
    col0 = np.arange(n_cols) * (sas[1] - ov[1])
    return row0, col0


def required_memory(n_frames, dim_size, window_size, overlap, search_area_size) -> int:
    """Bytes needed for the windowed correlation problem (fp32 + FFT temporaries).

    Mirrors the role of ``ffpiv.window.required_memory`` (memory-driven
    chunking, reference ``pyorc/velocimetry/ffpiv.py:118-139``): the window
    stack, its rFFT (complex64, ~half+1 columns x2 for both frames), and the
    correlation planes.
    """
    sas = _as2(search_area_size)
    n_rows, n_cols = get_field_shape(dim_size, search_area_size, overlap)
    n_windows = n_rows * n_cols
    win_bytes = n_frames * n_windows * sas[0] * sas[1] * 4
    fft_bytes = 2 * n_frames * n_windows * sas[0] * (sas[1] // 2 + 1) * 8
    corr_bytes = (n_frames - 1) * n_windows * sas[0] * sas[1] * 4
    return int(win_bytes + fft_bytes + corr_bytes)


def available_memory(device=None) -> int:
    """Free device memory in bytes on CUDA, else available host memory."""
    import torch

    from .._device import get_device

    device = torch.device(device) if device is not None else get_device()
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free)
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 8 << 30
