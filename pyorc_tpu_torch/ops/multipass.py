"""Multi-pass adaptive PIV with symmetric window deformation (WIDIM).

Port of :mod:`pyorc_tpu.ops.multipass`, on its kernel route
(``_piv_multipass_fused``): coarse-to-fine interrogation where each pass
warps the frame pair by the previous pass's displacement field before
correlating. Central (symmetric) deformation -- frame A sampled at
``x - d/2`` and frame B at ``x + d/2`` -- cancels the first-order truncation
bias of single-pass PIV (the pull toward zero on uniform shifts) and keeps
correlation valid under shear. Between passes the Westerweel-Scarano
normalized median test replaces outliers and NaNs by their neighbourhood
median, so the predictor field stays smooth.

Each pass's correlation is :func:`pyorc_tpu_torch.ops.piv_kernels.piv_pairs_routed`
on the interleaved deformed pairs (a0, b0, a1, b1, ...) with
``pair_stride=2``: the CUDA kernel on the GPU for windows with sides of
8-128 px (every pass of ``window_size`` 32 or 25 with ``passes=3``), its
plain version on the CPU. A coarser pass (256 px for ``window_size`` 64 and
``passes=3``) goes by plan to the XLA-semantics pipeline
:func:`pyorc_tpu_torch.ops.piv.piv_pairs`, as the JAX package's kernel route
sends it to its XLA pipeline. The deformation of every pass after the first
is :func:`deformed_pairs`: on the GPU one launch of the hand-written CUDA
kernel ``deform_pairs`` (``csrc/deform.cu``; it replaces the XLA gather
fusion of the JAX package's ``_deform_stage``), whose pairs equal its plain
version :func:`_deformed_pairs` bit for bit; on the CPU that plain version.
The kernel stages each frame once in shared memory for a run of pairs; a
(tile, pair) whose predictor could take a sample past the staged halo reads
the frames in device memory instead, with the same bits, and is counted
(:func:`deform_halo_misses`; the tile, halo and run: :func:`deform_geometry`).
The median test and the predictor's resampling are plain tensor ops in
float32. The deformation rounds as XLA's CPU build compiles the JAX
package's jitted ``_deform_stage``, so that its pairs are JAX's bit for bit:
the dense predictor's coordinates are multiplied by the step's float32
reciprocal (:func:`_dense_coords`), and its bilinear sums and the frame
samples' are chains of fused multiply-adds, A and B of
:func:`~pyorc_tpu_torch.ops.interp.map_linear`.

``map_coordinates(order=1, mode="nearest")`` of the JAX package is
:func:`pyorc_tpu_torch.ops.interp.map_linear`. ``jnp.nanmedian`` averages the two middle
values of an even count; ``torch.nanmedian`` returns the lower one, so the
median here is written out too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import piv_kernels
from . import windows as win
from .interp import map_linear

__all__ = ["piv_multipass", "multipass_window_sizes", "deformed_pairs"]

# pixels of one block of pairs that the plain version deforms at a time (bounds
# its gathers' int64 index tensors and its FMAs' float64 temporaries to ~0.5 GB
# each); the kernel takes a chunk in one launch
_DEFORM_BLOCK_PX = 1 << 26

# per device, the kernel's count of (tile, pair)s whose predictor could reach past the staged halo
# (each ran through device memory; same bits): a uint64 the kernel adds to and only the checks read
_HALO_MISSES: dict = {}


def multipass_window_sizes(window_size: Tuple[int, int], passes: int) -> list:
    """Coarse-to-fine window-size schedule ending at ``window_size``.

    Each earlier pass doubles the window (64 -> 32 -> 16 for passes=3,
    window_size=16), rounded to even.
    """
    ws = []
    for k in range(passes):
        f = 2 ** (passes - 1 - k)
        ws.append(tuple(win.round_to_even((window_size[0] * f, window_size[1] * f))))
    return ws


def _neighbor_stack(f: torch.Tensor) -> torch.Tensor:
    """Stack the 8 edge-padded neighbours of each grid cell: [..., 8, R, C]."""
    r, c = f.shape[-2], f.shape[-1]
    rows = torch.arange(-1, r + 1, device=f.device).clamp(0, r - 1)
    cols = torch.arange(-1, c + 1, device=f.device).clamp(0, c - 1)
    fp = f.index_select(-2, rows).index_select(-1, cols)
    stacks = [
        fp[..., 1 + dy : 1 + dy + r, 1 + dx : 1 + dx + c]
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
        if (dy, dx) != (0, 0)
    ]
    return torch.stack(stacks, dim=-3)


def _nanmedian(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.nanmedian`` over ``dim``: the NaN-skipping median, with the two
    middle values of an even count weighted 0.5 each; NaN where all are NaN."""
    nan = torch.isnan(x)
    count = (~nan).sum(dim, keepdim=True).to(x.dtype)
    ordered = torch.sort(torch.where(nan, torch.inf, x), dim=dim).values
    q = 0.5 * (count - 1)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1 - high_w
    low = torch.clamp(torch.minimum(low, count - 1), min=0).long()
    high = torch.clamp(torch.minimum(high, count - 1), min=0).long()
    med = torch.gather(ordered, dim, low) * low_w + torch.gather(ordered, dim, high) * high_w
    med = torch.where(count == 0, torch.nan, med)
    return med.squeeze(dim)


def _median_validate(u: torch.Tensor, v: torch.Tensor, eps: float = 0.1, thresh: float = 2.0):
    """Normalized median test (Westerweel & Scarano 2005); outliers and NaNs
    are replaced by the neighbourhood median so the predictor field stays
    smooth for the next deformation pass."""

    def fix(f):
        nbrs = _neighbor_stack(f)
        med = _nanmedian(nbrs, -3)
        resid = _nanmedian(torch.abs(nbrs - med.unsqueeze(-3)), -3)
        r = torch.abs(f - med) / (resid + eps)
        bad = (r > thresh) | ~torch.isfinite(f)
        return torch.nan_to_num(torch.where(bad, med, f))

    return fix(u), fix(v)


def _step(src: np.ndarray) -> np.float32:
    return np.float32(float(src[1] - src[0]) if len(src) > 1 else 1.0)


def _grid_coords(src: np.ndarray, dst, device) -> torch.Tensor:
    """Positions ``dst`` (pixels) in the index space of the window centres ``src``, clipped to it.

    A float32 division made on the host, the same on every device: XLA folds
    the JAX package's constant coordinates of ``_grid_to_grid`` so (on a CUDA
    tensor PyTorch would multiply by the reciprocal instead).
    """
    pos = (np.asarray(dst, dtype=np.float32) - np.float32(src[0])) / _step(src)
    return torch.as_tensor(np.clip(pos, 0.0, len(src) - 1.0), device=device)


def _dense_coords(rows: np.ndarray, cols: np.ndarray, h: int, w: int, device):
    """(rr [h], cc [w]): each pixel row and column in the index space of the window grid (rows, cols),
    clipped to it.

    ``(x - src[0]) * r`` with ``r`` the step's float32 reciprocal, rounded in
    float32: XLA's CPU build rewrites the JAX package's division by the
    constant step in ``_grid_to_dense`` so (at a step that is not a power of
    two, a division would differ in the last bit).
    """

    def axis(src, n):
        pos = (np.arange(n, dtype=np.float32) - np.float32(src[0])) * (np.float32(1.0) / _step(src))
        return torch.as_tensor(np.clip(pos, 0.0, len(src) - 1.0), device=device)

    return axis(rows, h), axis(cols, w)


def _grid_to_dense(field: torch.Tensor, rows: np.ndarray, cols: np.ndarray, h: int, w: int, coords=None):
    """Bilinear interpolation of a window-grid field onto the pixel grid.

    field: [..., n_rows, n_cols] at window centres (rows, cols); edge cells
    extend to the frame border (clamped index space). ``coords`` are
    :func:`_dense_coords` made by the caller (by default made here). The
    four-term sums round as chain A of :func:`~pyorc_tpu_torch.ops.interp.map_linear`,
    as XLA's CPU build compiles the JAX package's jitted deformation.
    """
    rr, cc = _dense_coords(rows, cols, h, w, field.device) if coords is None else coords
    return map_linear(field, rr[:, None], cc[None, :], order="fma_a")


def _grid_to_grid(field: torch.Tensor, src_rows, src_cols, dst_rows, dst_cols) -> torch.Tensor:
    """Resample a window-grid field onto a (finer) window grid, bilinear.

    The same interpolant as :func:`_grid_to_dense`, evaluated at the
    destination window centres, so the predictor added back to the residual
    is exactly the field the pair was deformed with at those points.
    """
    rr = _grid_coords(src_rows, dst_rows, field.device)
    cc = _grid_coords(src_cols, dst_cols, field.device)
    return map_linear(field, rr[:, None], cc[None, :])


def _deform_pair(img_a: torch.Tensor, img_b: torch.Tensor, dr: torch.Tensor, dc: torch.Tensor):
    """Symmetric deformation: A sampled at x - d/2, B at x + d/2 (bilinear).

    img_a, img_b, dr, dc: [..., h, w] float32 (dr rows down, dc columns right).
    The samples' sums round as chain B of
    :func:`~pyorc_tpu_torch.ops.interp.map_linear`, as XLA's CPU build
    compiles the JAX package's jitted deformation.
    """
    h, w = img_a.shape[-2], img_a.shape[-1]
    base_r = torch.arange(h, dtype=torch.float32, device=img_a.device)[:, None]
    base_c = torch.arange(w, dtype=torch.float32, device=img_a.device)[None, :]
    a_def = map_linear(img_a, base_r - dr / 2, base_c - dc / 2, order="fma_b")
    b_def = map_linear(img_b, base_r + dr / 2, base_c + dc / 2, order="fma_b")
    return a_def, b_def


def _deformed_pairs(frames, u, v, rows_prev, cols_prev, coords):
    """The plain version of :func:`deformed_pairs`: the pairs of ``frames``
    [T, H, W] deformed by the predictor (u, v) [T - 1, n_rows, n_cols] on the
    window grid (rows_prev, cols_prev), interleaved (a0, b0, a1, b1, ...) into
    [2 (T - 1), H, W]. ``coords`` are the caller's :func:`_dense_coords`, the
    ones the kernel reads.

    Works through blocks of pairs so the dense fields, the gather indices and
    the emulated fused multiply-adds' float64 temporaries of one block stay
    near ``_DEFORM_BLOCK_PX`` pixels.
    """
    n_pairs, h, w = frames.shape[0] - 1, frames.shape[1], frames.shape[2]
    a_stack, b_stack = frames[:-1], frames[1:]
    out = torch.empty((n_pairs, 2, h, w), dtype=torch.float32, device=frames.device)
    block = max(1, _DEFORM_BLOCK_PX // (h * w))
    for p0 in range(0, n_pairs, block):
        sl = slice(p0, p0 + block)
        # dense per-pixel predictor (dr = -v rows-down, dc = u cols-right)
        dr = _grid_to_dense(-v[sl], rows_prev, cols_prev, h, w, coords)
        dc = _grid_to_dense(u[sl], rows_prev, cols_prev, h, w, coords)
        out[sl, 0], out[sl, 1] = _deform_pair(a_stack[sl], b_stack[sl], dr, dc)
    return out.view(2 * n_pairs, h, w)


def _check_deform(frames, u, v, rows_prev, cols_prev):
    """Raise unless ``frames`` is a contiguous float32 [T, H, W] stack (T >= 2) and ``u``, ``v`` are
    contiguous float32 [T - 1, n_rows, n_cols] on its device, the grid of ``rows_prev`` x ``cols_prev``."""
    if frames.dim() != 3 or frames.shape[0] < 2:
        raise ValueError(f"deformed_pairs: frames must be [T, H, W] with T >= 2, got shape {tuple(frames.shape)}")
    want = (frames.shape[0] - 1, len(rows_prev), len(cols_prev))
    for name, t in (("frames", frames), ("u", u), ("v", v)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != frames.device:
            raise ValueError(f"deformed_pairs: {name} must be contiguous float32 on {frames.device}, got "
                             f"{t.dtype} on {t.device} (contiguous: {t.is_contiguous()})")
        if name != "frames" and tuple(t.shape) != want:
            raise ValueError(f"deformed_pairs: {name} must be [T - 1, n_rows, n_cols] = {want}, got {tuple(t.shape)}")


def _halo_misses(device) -> torch.Tensor:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _HALO_MISSES:
        _HALO_MISSES[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return _HALO_MISSES[device]


def deform_halo_misses(device) -> int:
    """The ``deform_pairs`` kernel's (tile, pair)s on ``device`` so far whose predictor could take a tap
    past the tile's staged halo, so that they sampled the frames in device memory (a check's count:
    it waits for the device)."""
    return int(_halo_misses(device).item())


def deform_geometry() -> dict:
    """The ``deform_pairs`` kernel's tile (rows, columns), halo and run of pairs, its threads, dynamic
    shared memory and resident blocks per SM on the current device, as the library reports them."""
    import ctypes

    out = (ctypes.c_int * 7)()
    err = piv_kernels._library().deform_pairs_geometry(out)
    if err != 0:
        raise RuntimeError(f"deform_pairs_geometry failed (cudaError {err})")
    keys = ("tile_rows", "tile_cols", "halo", "run", "threads", "smem_bytes", "blocks_per_sm")
    return dict(zip(keys, out))


def _launch_deform(frames, u, v, rr, cc):
    """One launch of the ``deform_pairs`` kernel: the checked inputs of :func:`deformed_pairs` -> pairs."""
    t, h, w = frames.shape
    n_rows, n_cols = u.shape[1:]
    if h * w >= 1 << 31:
        raise ValueError(f"deformed_pairs: a frame of {h} x {w} pixels is past the kernel's 32-bit plane offsets")
    out = torch.empty((2 * (t - 1), h, w), dtype=torch.float32, device=frames.device)
    misses = _halo_misses(frames.device)
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    with torch.cuda.device(frames.device):
        err = piv_kernels._library().deform_pairs_launch(
            frames.data_ptr(), t - 1, h, w, u.data_ptr(), v.data_ptr(), n_rows, n_cols, rr.data_ptr(),
            cc.data_ptr(), out.data_ptr(), misses.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"deform_pairs: CUDA kernel launch failed (cudaError {err})")
    piv_kernels.LAUNCHES["deform_pairs"] += 1
    return out


def deformed_pairs(frames, u, v, rows_prev, cols_prev):
    """Symmetric deformation of every pair of ``frames`` by the previous pass's predictor.

    frames [T, H, W] contiguous float32; u, v [T - 1, n_rows, n_cols] float32
    on the window grid with centres ``rows_prev`` x ``cols_prev`` (pixels).
    Returns the interleaved pairs [2 (T - 1), H, W]: pair p is frame p sampled
    at x - d/2 and frame p + 1 at x + d/2, bilinear with edge clamping, d the
    predictor interpolated to the pixel. A CUDA tensor launches the
    ``deform_pairs`` kernel once; a CPU tensor runs :func:`_deformed_pairs`.
    Both read the pixel grid's coordinates in the window grid made here once,
    on the frames' device, so the kernel gives the plain version's bits. The
    predictor must be finite, as the median test leaves it.
    """
    _check_deform(frames, u, v, rows_prev, cols_prev)
    rr, cc = _dense_coords(rows_prev, cols_prev, frames.shape[1], frames.shape[2], frames.device)
    if frames.device.type == "cuda":
        out = _launch_deform(frames, u, v, rr, cc)
        piv_kernels.KERNEL_ROUTE["deform_pairs"] = "cuda"
        return out
    if frames.device.type != "cpu":
        raise ValueError(f"deformed_pairs: no kernel for device {frames.device}")
    piv_kernels.KERNEL_ROUTE["deform_pairs"] = "plain_cpu"
    return _deformed_pairs(frames, u, v, rows_prev, cols_prev, (rr, cc))


def piv_multipass(
    imgs: torch.Tensor,
    dim_size: Tuple[int, int],
    window_size: Tuple[int, int],
    overlap: Tuple[int, int],
    n_rows: int,
    n_cols: int,
    passes: int = 2,
    signal_threshold: Optional[float] = None,
    corr_method: str = "auto",
    engine: str = "auto",
):
    """Multi-pass PIV: frames [T, H, W] -> (u, v, corr_max, s2n), each [T-1, n_rows, n_cols].

    The schedule doubles the window for each earlier pass
    (:func:`multipass_window_sizes`); earlier passes run at 50 % overlap,
    the last at ``overlap``. ``corr_max`` and ``s2n`` are the last pass's.
    NaN ``u``/``v`` of the last pass (zero-variance or below-threshold
    windows) stay NaN.

    With ``signal_threshold`` the JAX package always runs its XLA cascade,
    whose NaN-filled planes give each below-threshold (or zero-variance)
    window the placeholder displacement of an all-NaN plane,
    ``(1 - wx // 2, wy // 2 - 1)``. The earlier passes here give those
    windows the same placeholder before the median test, so the predictor is
    the cascade's; the last pass keeps NaN where the cascade reports the
    placeholder (ROADMAP.md, queue C).

    ``engine`` picks each pass's correlation by the JAX package's names
    (:func:`pyorc_tpu_torch.ops.piv_kernels.piv_pairs_engine`): ``"auto"``
    is :func:`~pyorc_tpu_torch.ops.piv_kernels.piv_pairs_routed`. A
    ``corr_method`` other than ``"auto"`` ("fft" or "matmul") runs every
    pass on the plain tensor ops in that formulation, the JAX package's XLA
    cascade, whose below-threshold and zero-variance windows carry the
    all-NaN plane's placeholder displacement in the last pass too; with
    ``engine="fused"`` or ``"fused-interpret"`` it raises ValueError.
    """
    correlate = piv_kernels.piv_pairs_engine(engine, corr_method)
    dim_size = tuple(dim_size)
    h, w = dim_size
    schedule = multipass_window_sizes(tuple(win._as2(window_size)), passes)
    overlaps = [tuple(s // 2 for s in ws) for ws in schedule[:-1]] + [tuple(win._as2(overlap))]
    if win.get_field_shape(dim_size, schedule[-1], overlaps[-1]) != (n_rows, n_cols):
        raise ValueError(
            f"(n_rows, n_cols)={(n_rows, n_cols)} is not the last pass's grid of {schedule[-1]} px windows"
        )
    frames = imgs.to(torch.float32).contiguous()
    n_pairs = frames.shape[0] - 1
    u = v = cmax = s2n = None
    rows_prev = cols_prev = None
    for k, (ws, ov) in enumerate(zip(schedule, overlaps)):
        cols_k, rows_k = win.get_rect_coordinates(dim_size, ws, ws, ov)
        nr_k, nc_k = len(rows_k), len(cols_k)
        if k == 0:
            pairs = torch.stack([frames[:-1], frames[1:]], dim=1).view(2 * n_pairs, h, w)
            u_pred = torch.zeros((n_pairs, nr_k, nc_k), dtype=torch.float32, device=frames.device)
            v_pred = torch.zeros_like(u_pred)
        else:
            pairs = deformed_pairs(frames, u, v, rows_prev, cols_prev)
            u_pred = _grid_to_grid(u, rows_prev, cols_prev, rows_k, cols_k)
            v_pred = _grid_to_grid(v, rows_prev, cols_prev, rows_k, cols_k)
        du, dv, cmax, s2n = correlate(pairs, dim_size, ws, ov, nr_k, nc_k, signal_threshold, pair_stride=2)
        del pairs
        last = k == len(schedule) - 1
        if signal_threshold is not None and not last:
            du = torch.nan_to_num(du, nan=float(1 - ws[1] // 2))
            dv = torch.nan_to_num(dv, nan=float(ws[0] // 2 - 1))
        u = u_pred + du
        v = v_pred + dv
        if not last:
            # keep the predictor smooth for the next deformation
            u, v = _median_validate(u, v)
        rows_prev, cols_prev = rows_k, cols_k
    return u, v, cmax, s2n
