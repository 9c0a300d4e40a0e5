#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``pyorc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi``), the torch and CUDA versions, and builds
   the CUDA kernels from ``pyorc_tpu_torch/csrc/`` into one library under
   ``build/``; then one line ``decoder_probe {...}``: what the machine offers
   for video decode (cv2, its FFmpeg and whether it round-trips a lossless
   FFV1 clip; the port's native FFmpeg decoder built from
   ``native/decoder.cpp``; NVDEC's ``libnvcuvid.so.1``; libavcodec). A
   missing decoder is reported, not a failure.
2. Per-pair kernel phase: particle frames of 1088x1920, 9 frames with a
   known sub-pixel shift, at 16, 26, 52, 64, 96, 104 and 128 px windows and
   the non-square 64x128, 128x64 and 32x64 px (8 consecutive pairs, 50 %
   overlap), and at 32 and 128 px with ``pair_stride=2`` (4 explicit pairs,
   as multipass PIV gives them). The kernel is held against its plain
   PyTorch version on the card and both are timed (CUDA events, median of 10
   runs after warm-up). At 64 and 128 px the card's SM clock and power draw
   are read while the kernel runs back to back.
3. Ensemble kernel phase: the same texture, 65 frames (64 pairs), at 16, 26,
   32, 64, 104 and 128 px at 50 % overlap, 32 px at step 12, 64x128 px at
   step (32, 64), and 64 px at 64 frames (an odd number of pairs); the
   ensemble kernel against its plain version, both timed, the clock read as
   in step 2.
4. Per-pair slice, at the geul recipe's scale: a 1920x1080, 126-frame
   in-memory stack advected (2.3, -1.4) px/frame through normalize ->
   project -> get_piv (16 and 26 px) -> mask -> get_transect -> get_q ->
   get_river_flow, checked against the analytic velocity and discharge.
   The per-pair kernel's launches in this run are counted.
5. Per-pair main-path check: the projected stack the slice gave the kernel
   is run through the kernel and its plain version again, at the slice's
   window grids; the kernel's output must also be the velocity field the
   slice produced. Both are timed, and so is the kernel on the same pairs
   given explicitly (``pair_stride=2``: one pair per block, no shared frames).
5b. Lazy per-pair chain: the slice's host uint8 stack wrapped in the port's
   ``LazyFrames`` through :class:`HostFrameSource` (the source hands out
   batches as ``Video``'s decode does, without a decoder's cost) with the coords
   and attrs of ``Video.get_frames``, then normalize -> project -> get_piv
   (16 and 26 px) -> mask -> get_transect -> get_q -> get_river_flow, the
   frames decoded, uploaded once and run through the chain per batch in a
   prefetch thread. Held to the slice's bars and to the in-memory slice's
   v_x, v_y, corr and s2n (equal, or within 1e-5); normalize and project may
   download nothing, get_piv only its outputs, and upload at most one stack.
   Prints per stage the wall, bytes up and down and the source's share.
5c. Video chain, where the probe found that OpenCV round-trips a lossless
   clip: that stack written as an FFV1 clip under ``build/``, opened with
   ``pyorc_tpu_torch.Video`` (OpenCV decode) and driven as in step 5b at
   16 px, with the same checks (v_x and v_y may differ from the in-memory
   slice's by a float32 ulp: ``Video``'s times are ``n * 1000 / fps * 0.001``).
5d. The recipe entry point, on that clip: (a) ``VelocityFlowProcessor(...).process()``
   in-process with a camera-config JSON, a cross-section GeoJSON with z and
   ngwerere's recipe shape (normalize -> project -> get_piv(window_size=25) at
   the default overlap, 26 px at a 14 px step -> a corr mask -> transect with
   get_q and get_river_flow; no write flags: that machine has no h5py), all
   written under ``build/``; it must launch the per-pair kernel and meet the
   26 px velocity and Q bars; each stage's wall is read from the service's own
   log lines. (b) The same inputs through ``python3 -m pyorc_tpu_torch.cli.main
   velocimetry ... -h 0.0 --cross ... -vvv build/service_out`` in a child
   process: exit 0 and every stage logged, its wall printed.
5f. The recipe's outputs, on that clip before it is removed: the service in-process
   with step 5d's recipe plus ``frames.to_video`` (``video_format="FFV1"``, an .avi)
   and ``frames.to_geotiff`` (frame 0). It must launch the per-pair kernel and meet
   step 5d's bars; the uint8 frames handed to the video writer, and where the writer
   is OpenCV's lossless FFV1 the decoded file too, must equal the frames the port
   gives on the CPU for the same stack (``outputs_reference``); every frame goes up
   once and only uint8 frames (1 B a projected pixel) come down; the GeoTIFF must be
   the CPU's file, byte for byte. Then ``cli_utils.parse_geotiff`` on the clip's first
   frame as RGB (nearest) on the card and on the CPU (byte-equal files), and
   ``to_ugrid`` of the masked result (arrays equal to the CPU's). Each new stage's
   wall and bytes, and the writer chosen, are printed; one line from
   ``importlib.util.find_spec`` says which outputs need matplotlib or h5py and are
   held on the CPU only.
5e. The optical water level: a 3-frame 1920x1080 FFV1 clip of the Geul
   fixture's synthetic scene (``tests/test_cross_section.py``; the camera and
   bathymetry are copied here) through the service's ``get_water_level``: the
   level within 0.25 m of 92.8 m with s2n above 1.2; the scorer's scores on
   the card equal to the port's CPU scores on the same mean frame; its device
   time (CUDA events), candidates and bytes up, and those of the grid search.
5g. Multi-device (it runs after step 13, on the stacks the earlier steps hold):
   (a) a mesh of every card where the machine has more than one, else 4
   virtual shards of ``cuda:0``, printed with ``torch.cuda.device_count()``
   and the card's name and power limit; (b) ``piv_pairs_sharded`` on the
   1080p projected stack at 16 and 26 px (125 pairs as 32/32/32/29) equal to
   the unsharded kernel, bitwise or within 1e-5 px (on windows whose top-2
   peak gap exceeds 5e-3, at least 95 % of the finite ones; near-tie flips
   elsewhere on at most 1e-5 of the windows), one launch a shard;
   (c) ``piv_ensemble_sharded`` on the projected 4K stack at 64 px: counts
   equal to the unsharded kernel's, ``corr_sum`` within 1e-5 relative, the
   mean-plane displacements within 1e-3 px of step 12's, one launch a shard;
   (d) ``piv_multipass_sharded`` (32 px, ``passes=3``) equal to step 6's
   fields; (e) ``piv_pairs_sharded_2d`` on a (2, 2) mesh at 32 px on the
   first 9 frames equal to the unsharded kernel; (f) ``get_piv`` with the
   engine's mesh handed those shards (``_device.local_devices`` patched in
   this script only) equal to step 4's 26 px dataset; (g) two processes
   sharing the card: ``chip_smoke.py --segment-worker`` twice
   (``process_segments_multihost`` over gloo on 127.0.0.1; the .npz segments
   stitched in pair order equal the single-process kernel) and ``python3 -m
   pyorc_tpu_torch.cli.main velocimetry ... --num-hosts 2 --host-id {0,1}
   --coordinator 127.0.0.1:<port>`` on step 5d's clip and inputs (exit 0,
   frames [0, 64) and [63, 126) in the logs, the per-pair kernel launched
   in each host, host 0's ``manifest.json`` in the JAX package's schema);
   (h) ``normalize`` -> ``project`` of step 4's 1080p camera frames with
   ``local_devices`` handed the shards: batches split along time over them,
   frames equal to step 4's projected stack.
   Each sharded call's wall is printed beside the unsharded call's.
6. Multipass slice: the same projected stack through get_piv(passes=3) at
   window sizes 32 (128 -> 64 -> 32 px) and 25 (104 -> 52 -> 26 px) -> mask
   -> get_transect -> get_q -> get_river_flow, checked against the analytic
   velocity and discharge; the per-pair kernel's launches are counted, and
   must be a whole number of launches per pass.
7. Multipass main-path check: each cascade on that stack once with the
   kernel and once with ``piv_pairs_fused`` swapped for its plain version
   (in this script only), held to each other and to the slice's velocities;
   each pass's kernel and plain version are timed beside the bound.
8. Non-square slice: the same projected stack through get_piv with 64x128 px
   windows at overlap (32, 64) -> mask -> get_transect -> get_q ->
   get_river_flow, held to the analytic velocity (0.02 m/s) and discharge;
   then the main-path check of step 5 on its grid.
9. Filters phase: every other frame filter through its ``Frames`` method on
   the card, on that projected stack (126 x 880 x 1720 uint8): smooth,
   edge_detect, minmax, time_diff, reduce_rolling (25 frames) and range, and
   ``project`` of 4 RGB frames of 1920x1080. Each result is held against
   the same method of the port run on the CPU on the stack's leading frames
   (range and the RGB projection: all of them), with the tolerance printed:
   1e-3 for the two blurs (a TF32 convolution would miss by ~0.1), exact for
   the rest, one count on under 1e-4 of the pixels for reduce_rolling.
10. STIV phase, the second velocimetry path: the projected stack through
   smooth(wdw=2) -> get_stiv on 32 lines of 2 m (101 samples, a 2 px step)
   laid inside the AOI along the analytic flow direction. The median v must
   lie within 5 % of the analytic speed hypot(v_x, v_y) with every line's
   coherence above 0.5; along angle + pi it must read the opposite sign; a
   profile call (window=21) must meet the bar in the median of its interior
   points. Runs under ``torch.profiler``: each stage's wall and device time
   are printed.
11. Ensemble slice, the headline workload of BASELINE.md (a 4K@30 fps video,
   the nadir camera of ``bench_e2e.py``) cut to 10 s: a 3840x2160, 300-frame
   stack through normalize -> project -> get_piv(64 px, ensemble_corr=True)
   -> spatial masks -> get_transect -> get_q -> get_river_flow, checked
   against the analytic velocity (5 %) and discharge (10 %). The ensemble
   kernel's launches in this run are counted.
12. Ensemble main-path check: the projected 4K stack through the ensemble
   kernel and its plain version again, held to each other, and the slice's
   velocities held to the kernel's mean-plane displacements; both timed,
   and beside them ``torch.fft.rfft2`` + ``irfft2`` alone over those windows.
12b. Lazy ensemble chain: step 5b on the 4K host stack (64 px, ensemble).
   Then normalize -> project of that chain streamed two ways and held equal
   batch by batch, timed in turns (port, JAX, port): whole frames up with each
   frame's extrema taken on the card (the port's design), and the JAX
   package's (extrema over the whole frame on the host, then only the ortho
   source box cropped and uploaded).
13. Wide ensemble slice: the projected 4K stack through get_piv(128 px,
   ensemble_corr=True) -> masks -> get_transect -> get_q -> get_river_flow
   (Pallas B5's geometry, the kernel's largest plane), held to the truth as
   step 11, then the main-path check of step 12 at 128 px.
14. Prints one JSON line about the kernels, then the last line
   ``{"ok": true, "device": {...}}``.

Each PIV slice runs with every launch count at 0 and must launch its kernel;
every call of the engine's entry point in it must take the CUDA kernel. The
filters and STIV phases run PyTorch ops only, as the JAX package runs these
stages outside any hand-written kernel.

    python3 chip_smoke.py --kernels-only

stops after steps 1-3 (to compare two trees' kernels on one card).

    python3 chip_smoke.py --profile

instead runs the five slices (per-pair, multipass, non-square, ensemble,
wide ensemble), both lazy chains and the filters and STIV phases once under
``torch.profiler`` (all host threads) and prints, per stage, the wall time,
the device's busy time (kernels and copies), its idle share and the bytes
moved each way, and the host time of the lazy chains' spans (``lazy:decode``,
``lazy:upload`` and one per op); the raw numbers go to
``build/profile_slice.json``.

Every phase raises on failure. Without CUDA, or without the package beside
it, the script exits with an error and prints no result. The functions
below also run on the CPU at small sizes, which is how the test suite
rehearses the slices without a card.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

FPS = 6.25
RES = 0.01  # m/px at the water plane
SHIFT = (2.3, -1.4)  # image-space displacement per frame (x, y) in px
H_A = 0.0
KERNEL_SIZES = (16, 26, 52, 64, 96, 104, 128, (64, 128), (128, 64), (32, 64))
STRIDE2_SIZES = (32, 128)  # pair_stride=2 runs of the kernel phase
CLOCK_SIZES = (64, 128)  # kernel-phase windows at which the SM clock and power draw are read under load
SLICE_WINDOWS = (15, 25)  # recipe window sizes; rounded to 16 and 26 px, run at 50 % overlap
# multipass PIV on the per-pair slice's stack: (window_size, passes), at 50 % overlap
MULTIPASS = ((32, 3), (25, 3))
# the non-square per-pair path on that stack: window (y, x) and overlap
NS_WINDOW, NS_OVERLAP = (64, 128), (32, 64)
NS_VEL_TOL = 0.02  # median velocity [m/s] against the truth
# Tolerances against the analytic truth. Two effects bias the medians low
# (check_chain): on this input about 6 % (16 px) and 4 % (26 px) in v_x.
VEL_TOL = {16: 0.03, 26: 0.02}  # median velocity [m/s], as tests/test_velocity_parity.py:136
Q_TOL = 0.10  # relative, median discharge against 0.9 * v_perp * wetted area

# The ensemble slice: bench_e2e.py's 4K nadir camera at 30 fps, 300 frames
# (bench_e2e.py --seconds 10), 64 px windows at 50 % overlap.
ENS_SHAPE = (2160, 3840)
ENS_FPS = 30.0
ENS_FRAMES = 300
ENS_WINDOW = 64
ENS_WIDE_WINDOW = 128  # the second ensemble path on the 4K stack: the largest window the kernels take
ENS_CAMERA = {"f": 6000.0, "gcp_px": 200, "aoi_px": 300}
ENS_VEL_RTOL = 0.05  # median v_x, v_y against the analytic values, relative
# (window, step, frames) of the ensemble kernel phase: 50 % overlap, 32 px at
# step 12 (a step that does not divide the window), 104 / 128 px and 64x128
# (Pallas B5's geometry) at 64 pairs, and 64 px at 63 pairs (the kernel takes
# two frames a step: an odd count ends on half a step)
ENS_KERNEL_CASES = (
    (16, 8, 65), (26, 13, 65), (32, 16, 65), (64, 32, 65), (32, 12, 65), (104, 52, 65), (128, 64, 65),
    ((64, 128), (32, 64), 65), (64, 32, 64),
)
CORR_MIN, S2N_MIN, COUNT_MIN = 0.2, 3.0, 0.2  # get_piv's ensemble defaults

# The filters phase on the per-pair slice's projected stack: a trailing window of
# 25 frames for reduce_rolling (the reference's default), and the leading frames
# that the port's CPU run repeats for the comparison (SAMPLE per-frame, ROLL_SAMPLE
# for reduce_rolling, which needs a full window before its first non-zero frame)
ROLL_SAMPLES = 25
FILTER_SAMPLE, ROLL_SAMPLE = 4, 32
BLUR_TOL = 1e-3  # smooth / edge_detect, card against CPU, on a 0-255 image (TF32 would miss by ~0.1)
RGB_FRAMES = 4  # RGB frames projected at full width

# The STIV phase on that stack: the particles (sigma 0.8 px, 2.69 px/frame) are
# blurred by smooth(wdw=2) (a 5-tap binomial, sigma 1 px) and sampled every 2 px
# along lines laid along the analytic flow direction, so the streaks move 1.35
# samples a frame; the default two shear refinements take it from there
STIV_SMOOTH_WDW = 2
STIV_LENGTH = 2.0  # m: 200 px, 101 samples
STIV_STEP_PX = 2.0
STIV_LINES = (4, 8)  # line centres, rows x columns of a grid inside the AOI
STIV_WINDOW = 21  # samples of the profile call's box
STIV_RTOL = 0.05  # median |v| against the analytic speed
STIV_COH_MIN = 0.5

# The recipe entry point (step 5d): ngwerere's recipe shape as written, normalize ->
# project -> get_piv(window_size=25) at get_piv's default overlap (26 px windows at a
# 14 px step, a grid the JAX package sends to XLA and the CUDA kernel takes) -> a
# corr mask -> transect with get_q and get_river_flow; no write flags (the card's
# machine has no h5py)
SERVICE_WINDOW = 25
SERVICE_STAGES = ("video", "frames", "velocimetry", "mask", "transect")
_STAGE_DONE = re.compile(r'stage "(\w+)" done in ([0-9.]+) s')

# The optical water level (step 5e): tests/test_cross_section.py's Geul fixture, its
# camera and bathymetry copied here (this script imports no test module), and its
# synthetic scene: bright noisy land, dark water up to GEUL_H
GEUL_H = 92.8  # m, local datum
GEUL_TOL = 0.25  # m, the detected level against GEUL_H
GEUL_S2N_MIN = 1.2  # the detection's signal-to-noise must exceed it
GEUL_CAMERA = {
    "height": 1080,
    "width": 1920,
    "crs": 28992,
    "resolution": 0.01,
    "gcps": {
        "src": [[158, 314], [418, 245], [655, 162], [948, 98], [1587, 321], [1465, 747]],
        "dst": [
            [192102.50255553858, 313157.5882846481, 150.831],
            [192101.3882378415, 313160.1101843005, 150.717],
            [192099.77023223988, 313163.2868999007, 150.807],
            [192096.8922817797, 313169.2557434712, 150.621],
            [192105.2958125107, 313172.0257530752, 150.616],
            [192110.35620407888, 313162.5371485311, 150.758],
        ],
        "h_ref": 92.45,
        "z_0": 150.49,
    },
    "window_size": 64,
    "is_nadir": False,
    "camera_matrix": [[1750.3084716796875, 0.0, 960.0], [0.0, 1750.3084716796875, 540.0], [0.0, 0.0, 1.0]],
    "dist_coeffs": [[-0.48456448702008914], [0.44089348828121366], [0.0], [0.0], [0.0]],
    "bbox": (
        "POLYGON ((192102.55970673775 313154.1397356759, 192098.0727491934 313163.2664060433, "
        "192108.81475944887 313168.5475153654, 192113.3017169932 313159.420844998, "
        "192102.55970673775 313154.1397356759))"
    ),
}
GEUL_ZS = [152.754, 152.436, 152.124, 151.65, 151.171, 150.959, 150.689, 150.215, 150.227, 150.204,
           150.148, 150.181, 150.114, 150.14, 150.096, 150.207, 150.474, 150.684, 150.931, 151.136,
           151.558, 151.943, 152.711, 153.016]
GEUL_LON = [5.913483043333334, 5.91350165, 5.913509225, 5.913517873333333, 5.913526728333333,
            5.913537678333333, 5.913544631666667, 5.913551016666665, 5.91356275, 5.913577963333334,
            5.913591855, 5.913605991666667, 5.91362158, 5.91362959, 5.913639568333333, 5.913647405,
            5.913650936666666, 5.91365698, 5.913666071666667, 5.913672016666667, 5.913678495,
            5.91368494, 5.913693873333334, 5.913725518333333]
GEUL_LAT = [50.807081403333335, 50.80708851833334, 50.80709163333333, 50.807093645, 50.807096580000014,
            50.807099555, 50.807102958333346, 50.80710621, 50.80710916, 50.807112763333336,
            50.80711691833334, 50.807121985, 50.80712629833334, 50.807129086666656, 50.807132803333324,
            50.80713549666667, 50.807136676666666, 50.807138608333325, 50.80714141666667,
            50.80714368666667, 50.80714608333333, 50.80714834333333, 50.80715788, 50.807162983333335]

# H100 SXM peaks for the bound: fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def make_texture(rng, h, w, density=0.03, sigma=0.8):
    """Gaussian-blurred particle field, intensities in [20, 240].

    ``sigma=0.8`` gives particle images about 3 px across (4 sigma), the
    size PIV seeding aims for; larger particles widen the correlation peak
    and with it the estimator's bias toward zero (check_chain).
    """
    from scipy.ndimage import gaussian_filter

    n = int(density * h * w)
    img = np.zeros((h, w))
    xs = rng.uniform(0, w - 1, n)
    ys = rng.uniform(0, h - 1, n)
    amp = rng.uniform(0.5, 1.0, n)
    x0, y0 = np.floor(xs).astype(int), np.floor(ys).astype(int)
    fx, fy = xs - x0, ys - y0
    for dy in (0, 1):
        for dx in (0, 1):
            wgt = (fy if dy else 1 - fy) * (fx if dx else 1 - fx)
            np.add.at(img, (np.minimum(y0 + dy, h - 1), np.minimum(x0 + dx, w - 1)), amp * wgt)
    img = gaussian_filter(img, sigma, mode="wrap")
    return img / img.max() * 220 + 20


def advected_stack(h, w, n_frames, device, seed=7):
    """uint8 [n_frames, h, w]: a texture Fourier-shifted by SHIFT per frame.

    The shifts run on ``device`` in float64, one frame at a time.
    """
    import torch

    base = torch.as_tensor(make_texture(np.random.default_rng(seed), h, w), device=device)
    spec = torch.fft.fft2(base)
    fy = torch.fft.fftfreq(h, dtype=torch.float64, device=device)[:, None]
    fx = torch.fft.fftfreq(w, dtype=torch.float64, device=device)[None, :]
    out = np.empty((n_frames, h, w), dtype=np.uint8)
    for i in range(n_frames):
        phase = torch.exp(-2j * np.pi * (fy * SHIFT[1] * i + fx * SHIFT[0] * i))
        frame = torch.fft.ifft2(spec * phase).real
        out[i] = frame.clamp(0, 255).to(torch.uint8).cpu().numpy()
    return out


def nadir_camera_config(h, w, f=1000.0, gcp_px=60, aoi_px=100, window_size=32):
    """Overhead camera, no distortion, RES m/px at z=0; GCPs ``gcp_px`` and
    the AOI ``aoi_px`` inside the frame's edges. ``f=6000, gcp_px=200,
    aoi_px=300, window_size=64`` at 2160x3840 is ``bench_e2e.nadir_config``."""
    from pyorc_tpu_torch import CameraConfig

    src = [[gcp_px, gcp_px], [w - gcp_px, gcp_px], [w - gcp_px, h - gcp_px], [gcp_px, h - gcp_px]]
    dst = [[RES * c, RES * (h - r)] for c, r in src]
    cc = CameraConfig(
        height=h,
        width=w,
        resolution=RES,
        window_size=window_size,
        gcps={"src": src, "dst": dst, "h_ref": 0.0, "z_0": 0.0},
        camera_matrix=[[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]],
        dist_coeffs=[[0.0]] * 5,
        stabilize=None,
    )
    a = aoi_px
    cc.set_bbox_from_corners([[a, a], [w - a, a], [w - a, h - a], [a, h - a]])
    return cc


def frames_dataarray(stack, cc, pkg=None, fps=FPS):
    """The in-memory frame stack as ``Video.get_frames`` builds it, as an
    ``ndx.DataArray`` of ``pkg`` (default ``pyorc_tpu_torch``; the tests pass
    the JAX package to build its twin)."""
    if pkg is None:
        import pyorc_tpu_torch as pkg

    n, h, w = stack.shape
    y = np.flipud(np.arange(h)).astype(np.float64)
    x = np.arange(w).astype(np.float64)
    xp, yp = np.meshgrid(x, y)
    coords = {"time": np.arange(n) / fps, "y": y, "x": x}
    attrs = {
        "camera_shape": str([h, w]),
        "camera_config": cc.to_json(),
        "h_a": json.dumps(H_A),
    }
    da = pkg.ndx.DataArray(stack, dims=("time", "y", "x"), coords=coords, attrs=attrs, name="frames")
    da = da.frames.add_xy_coords({"xp": xp, "yp": yp}, coords, pkg.const.PERSPECTIVE_ATTRS)
    da.name = "frames"
    return da


def expected_velocity(cc, fps=FPS):
    """Analytic (v_x, v_y) [m/s]: a displaced pixel pair unprojected to the water plane."""
    p0 = np.array([[cc.width / 2, cc.height / 2]])
    p1 = p0 + np.array([SHIFT])
    w0 = cc.unproject_points(p0, zs=0.0)[0]
    w1 = cc.unproject_points(p1, zs=0.0)[0]
    return (w1[0] - w0[0]) * fps, (w1[1] - w0[1]) * fps


def transect_points(cc, n_points=25, margin_px=64, aoi_px=100):
    """A cross-section across the flow, left bank (+y) to right bank, over a parabolic bed.

    Every point lies at least ``margin_px`` inside the AOI (``aoi_px`` inside
    the frame's edges); the bed rises 0.1 m above the water level at both
    banks and is 1.4 m deep mid-channel.
    """
    h, w = cc.height, cc.width
    x_mid = RES * w / 2
    y_top = RES * (h - aoi_px - margin_px)
    y_bot = RES * (aoi_px + margin_px)
    y = np.linspace(y_top, y_bot, n_points)
    x = np.full(n_points, x_mid)
    t = np.linspace(-1.0, 1.0, n_points)
    z = 0.1 - 1.5 * (1.0 - t**2)
    return x, y, z


# Bytes each stage moved host -> device and device -> host (the port's
# COPY_BYTES counters read around the stage), by stage name
MOVED = {}


@contextlib.contextmanager
def _stage(times, name):
    """Time a stage into ``times[name]``, its copies into ``MOVED[name]``, and mark it for ``torch.profiler``."""
    import torch

    from pyorc_tpu_torch._device import COPY_BYTES

    t0 = time.perf_counter()
    before = dict(COPY_BYTES)
    with torch.profiler.record_function(name):
        yield
    times[name] = time.perf_counter() - t0
    MOVED[name] = {k: COPY_BYTES[k] - before[k] for k in before}


def run_chain(frames_proj, window_size, cc, times, tag="", aoi_px=100, ensemble=False, passes=1, overlap=None):
    """get_piv at ``overlap`` (default 50 %) -> mask -> get_transect -> get_q -> get_river_flow.

    With ``ensemble=True`` get_piv averages the correlation planes of all
    pairs (one time step), and the masks are the spatial ones that act on a
    single step (minmax, corr, window_mean) instead of minmax, corr, count.
    ``passes`` goes to get_piv (multipass PIV for passes > 1). Returns the
    PIV (before masking) and discharge datasets; the stage times go into
    ``times`` under their names plus ``tag``.
    """
    if overlap is None:
        w_px = window_size + window_size % 2
        overlap = (w_px // 2, w_px // 2)
    with _stage(times, "get_piv" + tag):
        piv = frames_proj.frames.get_piv(
            window_size=window_size, overlap=overlap, ensemble_corr=ensemble, passes=passes
        )
    with _stage(times, "mask" + tag):
        mask = piv.velocimetry.mask
        masks = [mask.minmax(), mask.corr(), mask.window_mean() if ensemble else mask.count()]
        piv_masked = piv.velocimetry.mask(masks)
    with _stage(times, "transect_q_flow" + tag):
        transect = piv_masked.velocimetry.get_transect(*transect_points(cc, aoi_px=aoi_px))
        q = transect.transect.get_q(fill_method="interpolate")
        q.transect.get_river_flow()
    return piv, q


def check_chain(piv, q, cc, w_px, rel_tol=None, fps=FPS, abs_tol=None):
    """Check one window size's chain against the analytic truth; returns the numbers checked.

    The median velocities are held to the truth within ``abs_tol`` or
    ``VEL_TOL[w_px]`` [m/s] or, with ``rel_tol``, within that share of each
    true component.

    The per-pair estimator reads displacements low: two un-padded windows
    share fewer particles the further they are shifted, which tilts the
    correlation peak toward zero by about 2 (sigma^2 + 1/6) / (w - |d|) px
    for particle images of width sigma. normalize's mean of 15 sampled
    frames leaves a static residual that correlates at zero displacement
    and adds to it. Both are properties of the method, shared by the JAX
    package; VEL_TOL and Q_TOL hold the medians to the truth with that bias
    inside. The median discharge is held against ``0.9 * v_perp * wetted
    area`` with ``v_perp`` from the analytic velocity, which also pins the
    sign convention.
    """
    vx_true, vy_true = expected_velocity(cc, fps)
    for name in ("v_x", "v_y", "corr", "s2n"):
        if piv[name].values.shape != piv["v_x"].values.shape or piv[name].values.ndim != 3:
            raise AssertionError(f"{name}: unexpected shape {piv[name].values.shape}")
    vx = float(np.nanmedian(piv["v_x"].values))
    vy = float(np.nanmedian(piv["v_y"].values))
    if rel_tol is None:
        tol_x = tol_y = VEL_TOL[w_px] if abs_tol is None else abs_tol
    else:
        tol_x, tol_y = rel_tol * abs(vx_true), rel_tol * abs(vy_true)
    if not (abs(vx - vx_true) < tol_x and abs(vy - vy_true) < tol_y):
        raise AssertionError(f"{w_px} px: median velocity ({vx}, {vy}) vs truth ({vx_true}, {vy_true})")
    xs, ys = q["xcoords"].values, q["ycoords"].values
    tx, ty = xs[-1] - xs[0], ys[-1] - ys[0]
    depth = cc.get_depth(q["zcoords"].values, H_A)
    s = q["scoords"].values
    area = float(np.sum(0.5 * (depth[1:] + depth[:-1]) * np.diff(s)))
    # positive discharge crosses the section from its left to its right side:
    # v_perp is the velocity on the section direction turned +90 deg
    q_truth = 0.9 * (-vx_true * ty + vy_true * tx) / np.hypot(tx, ty) * area
    flow = q["river_flow"]
    q_median = float(flow.sel(quantile=0.5).values) if "quantile" in flow.dims else float(flow.values)
    if not np.isfinite(q_median) or abs(q_median - q_truth) > Q_TOL * abs(q_truth):
        raise AssertionError(f"{w_px} px: median Q {q_median} vs truth {q_truth} m3/s")
    return {"v_x": vx, "v_y": vy, "v_x_true": float(vx_true), "v_y_true": float(vy_true),
            "Q": q_median, "Q_truth": float(q_truth)}


def slice_phase(h, w, n_frames, device, stack=None):
    """Drive the port's main path on an in-memory stack (``stack``, default
    ``advected_stack(h, w, n_frames)``).

    Returns (per-window results, stage times, projected frames, per-window
    PIV datasets before masking).
    """
    import pyorc_tpu_torch

    pyorc_tpu_torch.set_device(device)
    cc = nadir_camera_config(h, w)
    if stack is None:
        stack = advected_stack(h, w, n_frames, device)
    da = frames_dataarray(stack, cc)
    times = {}
    with _stage(times, "normalize"):
        norm = da.frames.normalize(samples=15)
    with _stage(times, "project"):
        proj = norm.frames.project()
    results, pivs = {}, {}
    for ws in SLICE_WINDOWS:
        w_px = ws + ws % 2
        pivs[w_px], q = run_chain(proj, ws, cc, times, f"[{w_px}px]")
        results[w_px] = check_chain(pivs[w_px], q, cc, w_px)
    return results, times, proj, pivs


def multipass_phase(proj, h, w):
    """Drive multipass PIV on the per-pair slice's projected stack ``proj``
    (camera frames h x w): each MULTIPASS configuration through get_piv ->
    mask -> get_transect -> get_q -> get_river_flow, held to the analytic
    truth within VEL_TOL[26] and Q_TOL.

    Returns (per-configuration results with the per-pair kernel's launches,
    stage times, PIV datasets before masking), keyed by the last window [px].
    """
    from pyorc_tpu_torch.ops import piv_kernels

    cc = nadir_camera_config(h, w)
    times, results, pivs = {}, {}, {}
    for ws, passes in MULTIPASS:
        w_px = ws + ws % 2
        before = piv_kernels.LAUNCHES["piv_pairs"]
        pivs[w_px], q = run_chain(proj, ws, cc, times, f"[{w_px}px x{passes}]", passes=passes)
        results[w_px] = check_chain(pivs[w_px], q, cc, w_px, abs_tol=VEL_TOL[26])
        results[w_px]["launches"] = piv_kernels.LAUNCHES["piv_pairs"] - before
        results[w_px]["passes"] = passes
    return results, times, pivs


def non_square_phase(proj, h, w):
    """Drive non-square per-pair PIV on the per-pair slice's projected stack
    ``proj`` (camera frames h x w): NS_WINDOW windows at NS_OVERLAP through
    get_piv -> mask -> get_transect -> get_q -> get_river_flow, held to the
    analytic truth within NS_VEL_TOL and Q_TOL. Returns (results, stage
    times, PIV dataset before masking)."""
    cc = nadir_camera_config(h, w)
    times = {}
    piv, q = run_chain(proj, NS_WINDOW, cc, times, f"[{_fmt(NS_WINDOW)}px]", overlap=NS_OVERLAP)
    return check_chain(piv, q, cc, _fmt(NS_WINDOW), abs_tol=NS_VEL_TOL), times, piv


def wide_ensemble_phase(proj, h, w, camera=ENS_CAMERA):
    """Drive ensemble PIV at ENS_WIDE_WINDOW px (the largest window the kernel takes) on
    the ensemble slice's projected stack ``proj`` (camera frames h x w):
    get_piv -> spatial masks -> get_transect -> get_q -> get_river_flow, held
    to the truth as the ensemble slice is. Returns (results, stage times,
    PIV dataset before masking)."""
    cc = nadir_camera_config(h, w, window_size=ENS_WINDOW, **camera)
    times = {}
    tag = f"[ens {ENS_WIDE_WINDOW}px]"
    piv, q = run_chain(proj, ENS_WIDE_WINDOW, cc, times, tag, aoi_px=camera["aoi_px"], ensemble=True)
    if piv["v_x"].values.shape[0] != 1:
        raise AssertionError(f"ensemble PIV has {piv['v_x'].values.shape[0]} time steps, not 1")
    return check_chain(piv, q, cc, ENS_WIDE_WINDOW, rel_tol=ENS_VEL_RTOL, fps=ENS_FPS), times, piv


def ensemble_slice_phase(h, w, n_frames, device, camera=ENS_CAMERA, stack=None):
    """Drive the port's ensemble path: the nadir camera ``camera`` (see
    nadir_camera_config) at ENS_FPS, ENS_WINDOW px windows at 50 % overlap, on
    ``stack`` (default ``advected_stack(h, w, n_frames)``).

    Returns (results, stage times, projected frames, PIV dataset before masking).
    """
    import pyorc_tpu_torch

    pyorc_tpu_torch.set_device(device)
    cc = nadir_camera_config(h, w, window_size=ENS_WINDOW, **camera)
    if stack is None:
        stack = advected_stack(h, w, n_frames, device)
    da = frames_dataarray(stack, cc, fps=ENS_FPS)
    times = {}
    with _stage(times, "normalize[ens]"):
        norm = da.frames.normalize(samples=15)
    del da
    with _stage(times, "project[ens]"):
        proj = norm.frames.project()
    del norm
    piv, q = run_chain(proj, ENS_WINDOW, cc, times, "[ens]", aoi_px=camera["aoi_px"], ensemble=True)
    if piv["v_x"].values.shape[0] != 1:
        raise AssertionError(f"ensemble PIV has {piv['v_x'].values.shape[0]} time steps, not 1")
    results = check_chain(piv, q, cc, ENS_WINDOW, rel_tol=ENS_VEL_RTOL, fps=ENS_FPS)
    return results, times, proj, piv


class HostFrameSource:
    """The lazy chain's frame source on a machine without a video decoder.

    ``LazyFrames`` reads a video through ``_decode_frames(positions,
    method)`` and ``fn``; this source answers from a host uint8 stack
    [T, H, W] with a new array per call, as a decoder writes each batch into
    a new buffer, and adds the seconds it took to ``seconds``.
    """

    def __init__(self, stack, fn="host uint8 stack"):
        import threading

        self.stack = stack
        self.fn = fn
        self.seconds = 0.0
        self._lock = threading.Lock()

    def _decode_frames(self, positions, method):
        if method != "grayscale":
            raise ValueError(f"HostFrameSource holds gray frames, not {method!r}")
        t0 = time.perf_counter()
        out = self.stack[np.atleast_1d(positions)]
        with self._lock:
            self.seconds += time.perf_counter() - t0
        return out


def _timed_decode(video):
    """``video`` with ``seconds``: the time its ``_decode_frames`` has taken, as
    :class:`HostFrameSource` counts it (the method is wrapped on the instance)."""
    import threading

    decode, lock = video._decode_frames, threading.Lock()
    video.seconds = 0.0

    def timed(positions, method):
        t0 = time.perf_counter()
        out = decode(positions, method)
        with lock:
            video.seconds += time.perf_counter() - t0
        return out

    video._decode_frames = timed
    return video


def write_clip(stack, path, fps=FPS):
    """Write the gray uint8 ``stack`` [T, H, W] to ``path`` (.avi) as a lossless FFV1 clip with OpenCV."""
    import cv2

    n, h, w = stack.shape
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"FFV1"), float(fps), (w, h), isColor=False)
    if not out.isOpened():
        raise RuntimeError(f"OpenCV cannot write FFV1 to {path}")
    try:
        for frame in stack:
            out.write(np.ascontiguousarray(frame))
    finally:
        out.release()
    return path


def _cv2_roundtrip():
    """Whether OpenCV writes and reads back a lossless FFV1 clip (8 random frames of 64x96), as a string."""
    import cv2

    stack = np.random.default_rng(0).integers(0, 256, (8, 64, 96), dtype=np.uint8)
    (ROOT / "build").mkdir(exist_ok=True)
    path = ROOT / "build" / "decoder_probe.avi"
    try:
        write_clip(stack, path)
        cap = cv2.VideoCapture(str(path))
        frames = []
        while True:
            ok, img = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
        cap.release()
    except (RuntimeError, cv2.error) as err:
        return f"fails: {err}"
    finally:
        path.unlink(missing_ok=True)
    if len(frames) == len(stack) and np.array_equal(np.asarray(frames), stack):
        return "FFV1 round trip exact"
    return f"FFV1 round trip read {len(frames)} of {len(stack)} frames, not equal"


def lazy_dataarray(source, cc, fps=FPS):
    """The frames ``Video.get_frames`` gives, backed by a ``LazyFrames`` over ``source``
    (a :class:`HostFrameSource`): the coords and attrs of :func:`frames_dataarray`, and
    the video's ``chunksize`` attribute (``Video``'s default)."""
    from pyorc_tpu_torch import LazyFrames

    n, h, w = source.stack.shape
    lazy = LazyFrames(source, "grayscale", np.arange(n), (h, w), dtype=np.uint8)
    da = frames_dataarray(lazy, cc, fps=fps)
    da.attrs["chunksize"] = 20
    return da


def _piv_output_bytes(piv, n_pairs, w_px, ensemble):
    """Bytes get_piv downloads: per pair u, v, cmax, s2n; for the ensemble the summed
    w_px x w_px planes and counts once, and cmax, s2n per pair (float32 each)."""
    n_rows, n_cols = piv["v_x"].shape[1:]
    n_win = n_rows * n_cols
    if not ensemble:
        return 4 * 4 * n_pairs * n_win
    return 4 * (n_win * w_px * w_px + n_win + 2 * n_pairs * n_win)


def lazy_phase(stack, cc, ref_pivs, device, fps=FPS, ensemble=False, aoi_px=100, tag="lazy", video_file=None):
    """Drive the port's lazy chain: ``stack`` (host uint8 [T, H, W]) wrapped in a
    ``LazyFrames`` through a :class:`HostFrameSource` (or, with ``video_file``, a
    lossless clip of ``stack`` opened with ``pyorc_tpu_torch.Video``: see
    :func:`write_clip`), then normalize -> project -> get_piv -> mask ->
    get_transect -> get_q -> get_river_flow at each window of ``ref_pivs``
    (window px -> the in-memory slice's PIV dataset on the same frames).

    Checks, for each window: the slice's bars (``check_chain``: VEL_TOL per pair,
    ENS_VEL_RTOL for the ensemble, Q_TOL); v_x, v_y, corr and s2n against the
    in-memory slice's, equal or within 1e-5 (the largest differences are
    returned); that normalize and project moved no frames, that get_piv
    downloaded its outputs and nothing else and uploaded at most one stack.
    Returns (per-window results, stage times, per-stage rows: wall, bytes up and
    down, the frame source's seconds and share of the wall; the projected lazy frames).
    """
    import pyorc_tpu_torch

    pyorc_tpu_torch.set_device(device)
    if video_file is None:
        source = HostFrameSource(stack)
        da = lazy_dataarray(source, cc, fps)
    else:
        video = pyorc_tpu_torch.Video(str(video_file), camera_config=cc, h_a=H_A, fps=fps, progress=False)
        source = _timed_decode(video)
        da = source.get_frames()
        if da.shape != stack.shape:
            raise AssertionError(f"Video gave frames {da.shape} of the clip of {stack.shape}")
    times, rows, results = {}, {}, {}

    def row(name, source_s):
        rows[name] = {"wall_s": times[name], **MOVED[name], "source_s": source_s,
                      "source_share": source_s / times[name]}

    t_src = source.seconds
    with _stage(times, f"normalize[{tag}]"):
        norm = da.frames.normalize(samples=15)
    row(f"normalize[{tag}]", source.seconds - t_src)
    with _stage(times, f"project[{tag}]"):
        proj = norm.frames.project()
    row(f"project[{tag}]", 0.0)
    for name in (f"normalize[{tag}]", f"project[{tag}]"):
        if MOVED[name]["d2h"]:
            raise AssertionError(f"{name} downloaded {MOVED[name]['d2h']} bytes")
    for w_px, ref in ref_pivs.items():
        sub = tag if ensemble else f"{tag} {_fmt(w_px)}px"
        t_src = source.seconds
        piv, q = run_chain(proj, w_px, cc, times, f"[{sub}]", aoi_px=aoi_px, ensemble=ensemble)
        row(f"get_piv[{sub}]", source.seconds - t_src)
        if ensemble:
            res = check_chain(piv, q, cc, w_px, rel_tol=ENS_VEL_RTOL, fps=fps)
        else:
            res = check_chain(piv, q, cc, w_px)
        moved = MOVED[f"get_piv[{sub}]"]
        want_d2h = _piv_output_bytes(piv, stack.shape[0] - 1, w_px, ensemble)
        if moved["d2h"] != want_d2h or moved["h2d"] > stack.nbytes:
            raise AssertionError(
                f"get_piv[{sub}] moved {moved}; outputs are {want_d2h} bytes, the stack {stack.nbytes}"
            )
        res["max_abs_diff_vs_in_memory"] = {}
        for name in ("v_x", "v_y", "corr", "s2n"):
            got, want = piv[name].values, ref[name].values
            if got.shape != want.shape or not np.array_equal(np.isnan(got), np.isnan(want)):
                raise AssertionError(f"lazy {sub} {name}: shape or NaN mask differs from the in-memory slice")
            diff = float(np.nanmax(np.abs(got - want))) if np.isfinite(got).any() else 0.0
            res["max_abs_diff_vs_in_memory"][name] = diff
            if diff > 1e-5:
                raise AssertionError(f"lazy {sub} {name}: differs from the in-memory slice by {diff}")
        res["uploaded_bytes"], res["downloaded_bytes"] = moved["h2d"], moved["d2h"]
        results[w_px] = res
    return results, times, rows, proj


def _host_extrema(batch, mean):
    """Each frame's extrema of (frame - mean) in float32 over the whole frame, one frame at a
    time: the JAX package's ``host_stats`` of normalize (``pyorc_tpu/api/frames.py:130-140``)."""
    mins, maxs = [], []
    for f in batch:
        red = np.asarray(f, dtype=np.float32) - mean
        mins.append(red.min(axis=(-2, -1), keepdims=True))
        maxs.append(red.max(axis=(-2, -1), keepdims=True))
    return np.stack(mins), np.stack(maxs)


class _HostExtremaSource(HostFrameSource):
    """A :class:`HostFrameSource` that also takes each batch's normalize extrema on the host
    before the batch is cropped, as the JAX package's upload crop does."""

    def __init__(self, stack, mean):
        super().__init__(stack)
        self.mean = mean
        self.extrema = None

    def _decode_frames(self, positions, method):
        out = super()._decode_frames(positions, method)
        self.extrema = _host_extrema(out, self.mean)
        return out


def upload_designs(stack, device, port=None, fps=ENS_FPS, chunk=40, camera=ENS_CAMERA):
    """normalize -> project of the lazy chain over ``stack``, streamed by two designs and held equal batch by batch.

    ``device_extrema``, the port's (``port``: the projected ``LazyFrames`` of
    :func:`lazy_phase` on ``stack``, else built here): whole frames go up, and
    normalize takes each frame's extrema on the device. ``host_extrema_crop``, the JAX package's
    (``pyorc_tpu/api/frames.py:130-140, 253-334``): each frame's extrema are
    taken on the host over the whole frame, then only the source box of the
    ortho maps is cropped and uploaded. The designs run in turns (port, JAX,
    port; JAX's took 6x the port's on the card, PERF.md §6), each consuming
    ``chunk``-frame batches and waiting for the card. Returns {design: {"walls_s": [..], "uploaded_bytes": n}}.
    """
    import torch

    import pyorc_tpu_torch
    from pyorc_tpu_torch import LazyFrames
    from pyorc_tpu_torch._device import COPY_BYTES, to_device
    from pyorc_tpu_torch.ops import filters as flt

    pyorc_tpu_torch.set_device(device)
    cc = nadir_camera_config(*stack.shape[1:], window_size=ENS_WINDOW, **camera)
    da = lazy_dataarray(HostFrameSource(stack), cc, fps)
    if port is None:
        port = da.frames.normalize(samples=15).frames.project().data
    raw = da.frames.project().data  # no op before project: its maps are cropped to the source box
    r0, r1, c0, c1 = raw._crop
    mean = stack[:: round(len(stack) / 15)].astype(np.float32).mean(axis=0).astype(np.float32)
    source = _HostExtremaSource(stack, mean)
    mean_crop = to_device(np.ascontiguousarray(mean[r0:r1, c0:c1]))

    def normalize_crop(batch):
        fmin, fmax = source.extrema  # the worker thread decodes and runs the ops of one batch in turn
        return flt.normalize_with_stats(batch, mean_crop, to_device(fmin), to_device(fmax))

    jax_design = LazyFrames(source, "grayscale", np.arange(len(stack)), port.shape[1:],
                            ops=[normalize_crop, raw._ops[-1]], crop=raw._crop)
    designs = {"device_extrema": port, "host_extrema_crop": jax_design}
    out = {name: {"walls_s": []} for name in designs}
    first = {}
    for name in ("device_extrema", "host_extrema_crop", "device_extrema"):
        h2d = COPY_BYTES["h2d"]
        t0 = time.perf_counter()
        batches = [b for _, b in designs[name].iter_batches(chunk)]
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        out[name]["walls_s"].append(time.perf_counter() - t0)
        out[name]["uploaded_bytes"] = COPY_BYTES["h2d"] - h2d
        first.setdefault(name, batches)
    for a, b in zip(first["device_extrema"], first["host_extrema_crop"]):
        if not torch.equal(a, b):
            raise AssertionError("the two upload designs give different projected frames")
    return out


def decoder_probe():
    """What this machine offers for video decode, as one dict: cv2 (its FFmpeg, and whether it
    round-trips a lossless clip), the port's native decoder build (compiler, and the first error
    line if it fails), ``libnvcuvid.so.1`` (NVDEC's library, installed beside libcuda) and the libavcodec
    that ``ldconfig -p`` lists. A missing decoder is an answer."""
    import ctypes
    import shutil

    from pyorc_tpu_torch.io import native_decoder

    out = {}
    try:
        import cv2

        out["cv2"] = cv2.__version__
        ffmpeg = [line.split(":", 1)[1].strip() for line in cv2.getBuildInformation().splitlines()
                  if line.strip().startswith("FFMPEG:")]
        out["cv2_ffmpeg"] = ffmpeg[0] if ffmpeg else "not listed"
        out["cv2_video_io"] = _cv2_roundtrip()
    except ImportError as err:
        out["cv2"] = f"absent ({err})"
    out["native_compiler"] = native_decoder._compiler()
    err = native_decoder.load_error()
    if err is None:
        out["native_decoder"] = "built"
    else:
        lines = err.splitlines()
        first = next((line for line in lines[1:] if "error" in line), lines[0])
        out["native_decoder"] = f"unavailable: {first.strip()}"
    try:
        ctypes.CDLL("libnvcuvid.so.1")
        out["libnvcuvid"] = "loads"
    except OSError as err:
        out["libnvcuvid"] = f"absent ({err})"
    ldconfig = shutil.which("ldconfig") or "/sbin/ldconfig"
    if Path(ldconfig).exists():
        listed = subprocess.run([ldconfig, "-p"], capture_output=True, text=True)
        out["libavcodec"] = sorted({line.split()[0] for line in listed.stdout.splitlines() if "libavcodec" in line})
        if listed.returncode:
            out["libavcodec"] = f"ldconfig -p exited {listed.returncode}: {listed.stderr.strip()[:200]}"
    else:
        out["libavcodec"] = "ldconfig not found"
    return out


def service_inputs(cc, folder, aoi_px=100):
    """Write the recipe entry point's inputs under ``folder``: the camera config (JSON),
    a cross-section with z (GeoJSON, :func:`transect_points`) and the recipe (as JSON,
    which a YAML reader reads). Returns (camera config, cross-section, recipe) paths
    and the recipe."""
    folder.mkdir(parents=True, exist_ok=True)
    fn_cc, fn_cross, fn_recipe = folder / "camera_config.json", folder / "cross_section.geojson", folder / "recipe.yml"
    cc.to_file(str(fn_cc))
    points = zip(*transect_points(cc, aoi_px=aoi_px))
    fn_cross.write_text(json.dumps({"type": "FeatureCollection", "features": [
        {"type": "Feature", "properties": {}, "geometry": {"type": "Point", "coordinates": [float(v) for v in p]}}
        for p in points
    ]}))
    recipe = {
        "video": {},
        "frames": {"normalize": {"samples": 15}, "project": {}},
        "velocimetry": {"get_piv": {"window_size": SERVICE_WINDOW}},
        "mask": {"mask_corr": {"corr": {}}},
        "transect": {"transect_1": {"get_q": {"fill_method": "interpolate"}, "get_river_flow": {}}},
    }
    fn_recipe.write_text(json.dumps(recipe, indent=1))
    return fn_cc, fn_cross, fn_recipe, recipe


def _stage_walls(lines):
    """{stage: seconds} from the service's ``stage "<name>" done in <s> s`` log lines; every
    stage of SERVICE_STAGES must be there."""
    walls = {m.group(1): float(m.group(2)) for m in map(_STAGE_DONE.search, lines) if m}
    missing = [s for s in SERVICE_STAGES if s not in walls]
    if missing:
        raise AssertionError(f"the service logged no end of the stages {missing}: {walls}")
    return walls


class _Lines(logging.Handler):
    """A logging handler that keeps each record's message."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def service_phase(clip, cc, folder, device, aoi_px=100):
    """Step 5d (a): the recipe entry point in-process, ``VelocityFlowProcessor(...).process()``
    on ``clip`` (a lossless clip of the advected stack seen by ``cc``) with the inputs of
    :func:`service_inputs` and ``h_a`` given, as ``-h`` gives it. The velocities (before the
    mask) and Q are held to the analytic truth (VEL_TOL at 26 px, Q_TOL).

    Returns (the numbers checked, {stage: wall [s]} from the service's own log lines).
    """
    import pyorc_tpu_torch
    from pyorc_tpu_torch.cli import cli_utils
    from pyorc_tpu_torch.service.velocimetry import VelocityFlowProcessor

    pyorc_tpu_torch.set_device(device)
    fn_cc, fn_cross, _, recipe = service_inputs(cc, folder, aoi_px)
    logger = logging.getLogger("chip_smoke.service")
    logger.setLevel(logging.INFO)
    handler = _Lines()
    logger.addHandler(handler)
    try:
        proc = VelocityFlowProcessor(
            recipe=cli_utils.validate_recipe(recipe), videofile=str(clip),
            cameraconfig=cli_utils.parse_camconfig(None, None, str(fn_cc)), prefix="",
            output=str(folder / "service_in_process"), h_a=H_A, cross=str(fn_cross), logger=logger,
        )
        proc.process()
    finally:
        logger.removeHandler(handler)
    results = check_chain(proc.velocimetry_obj, proc.transects["transect_1"], cc, SERVICE_WINDOW + 1)
    return results, _stage_walls(handler.lines)


def cli_phase(clip, folder, device):
    """Step 5d (b): ``python3 -m pyorc_tpu_torch.cli.main velocimetry`` on the inputs
    :func:`service_phase` wrote under ``folder``, output to ``folder / "service_out"``,
    as a child process (``PYORC_TPU_TORCH_DEVICE`` names ``device`` for it). It must
    exit 0 and log every stage's end. Returns (wall [s], {stage: wall [s]} from its log)."""
    out = folder / "service_out"
    argv = [
        sys.executable, "-m", "pyorc_tpu_torch.cli.main", "velocimetry", "-V", str(clip),
        "-c", str(folder / "camera_config.json"), "-r", str(folder / "recipe.yml"), "-h", str(H_A),
        "--cross", str(folder / "cross_section.geojson"), "-vvv", str(out),
    ]
    env = dict(os.environ, PYORC_TPU_TORCH_DEVICE=str(device))
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"the CLI exited {proc.returncode}: {proc.stdout[-1500:]} {proc.stderr[-3000:]}")
    return wall, _stage_walls((out / "pyorc_tpu.log").read_text().splitlines())


def outputs_reference(stack, cc, folder, samples=15, batch=16):
    """The frames the port gives on the CPU for the outputs of step 5f: ``stack`` (the host
    uint8 frames of the clip) through normalize(``samples``) -> project on the CPU, as a lazy
    chain over a :class:`HostFrameSource`. Returns the (start, uint8 video frames) of each
    batch, and writes frame 0 with the CPU's ``to_geotiff`` to ``folder /
    "reference_frame_0000.tif"``. Needs neither cv2 nor a card."""
    import pyorc_tpu_torch
    from pyorc_tpu_torch.ops import filters as flt

    previous = pyorc_tpu_torch.get_device()
    pyorc_tpu_torch.set_device("cpu")
    try:
        proj = lazy_dataarray(HostFrameSource(stack), cc).frames.normalize(samples=samples).frames.project()
        out = [(start, flt.video_uint8(chunk).numpy()) for start, chunk in proj.data.iter_batches(batch)]
        proj.frames.to_geotiff(folder / "reference_frame_0000.tif", frame=0)
    finally:
        pyorc_tpu_torch.set_device(previous)
    return out


def hold_video_frames(read_frames, reference):
    """Hold the frames ``read_frames`` yields (a decoded video, uint8 [h, w] each) to the
    ``(start, batch)`` pairs of ``reference``, exactly. Returns the number of frames."""
    n = 0
    frames = iter(read_frames)
    for start, batch in reference:
        for k, want in enumerate(batch):
            got = next(frames, None)
            if got is None:
                raise AssertionError(f"the video ends after {n} frames; the reference has frame {start + k}")
            if got.shape != want.shape or not np.array_equal(got, want):
                bad = int((got != want).sum()) if got.shape == want.shape else f"shape {got.shape} != {want.shape}"
                raise AssertionError(f"video frame {start + k} differs from the CPU's: {bad}")
            n += 1
    if next(frames, None) is not None:
        raise AssertionError(f"the video holds more than the reference's {n} frames")
    return n


def hold_geotiff(got_fn, want_fn):
    """Byte-equal GeoTIFFs: the uint8 frames of normalize -> project are exact on the card (the
    filters phase's bar for them). Returns "byte-equal"."""
    got, want = Path(got_fn).read_bytes(), Path(want_fn).read_bytes()
    if got != want:
        diff = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
        raise AssertionError(f"{got_fn} differs from the CPU's {want_fn} in {diff} bytes")
    return "byte-equal"


def ugrid_arrays_equal(ds, device):
    """``to_ugrid`` of ``ds`` on ``device`` and on the CPU: every array, its dims and attributes equal
    (the global attributes but ``date_created`` and ``history``). Returns (wall [s], bytes moved,
    the [time, faces] shape of ``mesh2d_ucx``)."""
    from pyorc_tpu_torch._device import COPY_BYTES

    before = dict(COPY_BYTES)
    t0 = time.perf_counter()
    got = ds.velocimetry.to_ugrid()
    wall = time.perf_counter() - t0
    moved = {k: COPY_BYTES[k] - before[k] for k in before}
    want = _on_cpu(device, lambda: ds.velocimetry.to_ugrid())
    names = list(want.data_vars) + list(want.coords)
    if set(got.data_vars) != set(want.data_vars) or set(got.coords) != set(want.coords):
        raise AssertionError("to_ugrid: different variables on the card and on the CPU")
    for k in names:
        a, b = np.asarray(got[k].values), np.asarray(want[k].values)
        if a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
            raise AssertionError(f"to_ugrid: {k} differs between the card and the CPU")
    stamps = ("date_created", "history")
    if {k: v for k, v in got.attrs.items() if k not in stamps} != {k: v for k, v in want.attrs.items() if k not in stamps}:
        raise AssertionError("to_ugrid: global attributes differ")
    if got["mesh2d_ucx"].shape[1] != ds.sizes["y"] * ds.sizes["x"]:
        raise AssertionError(f"to_ugrid: {got['mesh2d_ucx'].shape} faces for a {ds.sizes['y']}x{ds.sizes['x']} grid")
    return wall, moved, list(got["mesh2d_ucx"].shape)


def host_only_outputs():
    """One line: the outputs that need matplotlib or h5py, and whether this machine has them
    (``importlib.util.find_spec``)."""
    import importlib.util

    have = {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "h5py")}
    state = ", ".join(f"{m} {'present' if ok else 'absent'}" for m, ok in have.items())
    return (f"outputs held on the CPU only ({state} here): the plot stage, Frames.to_ani and the camera-config "
            "selectors need matplotlib, the UGRID file (to_netcdf) needs h5py; tests/test_torch_plot.py, "
            "test_torch_exports.py, test_torch_cli_elements.py and test_torch_service.py hold them against JAX")


def outputs_phase(clip, stack, cc, folder, device, aoi_px=100):
    """Step 5f, the recipe's outputs, on ``clip`` (the lossless clip of ``stack``): the service
    in-process with step 5d's inputs plus ``frames.to_video`` (FFV1 in an .avi) and
    ``frames.to_geotiff`` (frame 0). It must meet step 5d's bars; the video must decode to the
    uint8 frames the port gives on the CPU (:func:`outputs_reference`), every frame uploaded
    once and only uint8 frames downloaded; the GeoTIFF must be the CPU's file. Then
    ``parse_geotiff`` (the clip's first frame as RGB, nearest) against its CPU file, and
    ``to_ugrid`` of the masked result against the CPU's arrays.

    Returns (the numbers checked, per new stage {wall_s, h2d, d2h, ...; for to_video the
    writer chosen and the seconds spent in its ``write``}, {stage: wall [s]} from the
    service's log)."""
    import cv2
    import torch
    from unittest import mock

    import pyorc_tpu_torch
    from pyorc_tpu_torch import _device
    from pyorc_tpu_torch.api import frames as frames_mod
    from pyorc_tpu_torch.api.frames import Frames
    from pyorc_tpu_torch.cli import cli_utils
    from pyorc_tpu_torch.service.velocimetry import VelocityFlowProcessor

    pyorc_tpu_torch.set_device(device)
    out_dir = folder / "outputs"
    out_dir.mkdir(parents=True, exist_ok=True)
    fn_cc, fn_cross, _, recipe = service_inputs(cc, folder, aoi_px)
    fn_video = out_dir / "processed_frames.avi"
    recipe["frames"]["to_video"] = {"fn": str(fn_video), "video_format": "FFV1"}
    recipe["frames"]["to_geotiff"] = {"frame": 0}
    rows, written, write_s = {}, [], [0.0]
    make_writer = frames_mod._video_writer

    def recording_writer(*args, **kwargs):
        writer = make_writer(*args, **kwargs)
        write = writer.write

        def record(frame):
            written.append(np.array(frame))
            t0 = time.perf_counter()
            write(frame)
            write_s[0] += time.perf_counter() - t0

        writer.write = record
        return writer

    def measured(name, method):
        def run(*args, **kwargs):
            before = dict(_device.COPY_BYTES)
            t0 = time.perf_counter()
            out = method(*args, **kwargs)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            rows[name] = {"wall_s": time.perf_counter() - t0,
                          **{k: _device.COPY_BYTES[k] - before[k] for k in before}}
            return out

        return run

    logger = logging.getLogger("chip_smoke.outputs")
    logger.setLevel(logging.INFO)
    frames_log = logging.getLogger("pyorc_tpu_torch.api.frames")
    frames_log.setLevel(logging.INFO)
    handler, writer_lines = _Lines(), _Lines()
    logger.addHandler(handler)
    frames_log.addHandler(writer_lines)
    try:
        with mock.patch.object(Frames, "to_video", measured("to_video", Frames.to_video)), \
                mock.patch.object(Frames, "to_geotiff", measured("to_geotiff", Frames.to_geotiff)), \
                mock.patch.object(frames_mod, "_video_writer", recording_writer):
            proc = VelocityFlowProcessor(
                recipe=cli_utils.validate_recipe(recipe), videofile=str(clip),
                cameraconfig=cli_utils.parse_camconfig(None, None, str(fn_cc)), prefix="",
                output=str(out_dir), h_a=H_A, cross=str(fn_cross), logger=logger,
            )
            proc.process()
    finally:
        logger.removeHandler(handler)
        frames_log.removeHandler(writer_lines)
    results = check_chain(proc.velocimetry_obj, proc.transects["transect_1"], cc, SERVICE_WINDOW + 1)
    n, out_h, out_w = proc.da_frames.shape
    video = rows["to_video"]
    video["writer"] = next((line for line in writer_lines.lines if line.startswith("to_video:")), "not logged")
    video["writer_write_s"] = write_s[0]  # the host encoder's share of the wall
    if video["h2d"] != stack.nbytes or video["d2h"] != n * out_h * out_w:
        raise AssertionError(f"to_video moved {video['h2d']} B up and {video['d2h']} B down; each of the {n} frames "
                             f"up once is {stack.nbytes} B, their uint8 frames down {n * out_h * out_w} B")
    video["bytes_per_projected_pixel_down"] = video["d2h"] / (n * out_h * out_w)

    def decoded():
        cap = cv2.VideoCapture(str(fn_video))
        try:
            while True:
                ok, img = cap.read()
                if not ok:
                    return
                yield cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        finally:
            cap.release()

    reference = outputs_reference(stack, cc, folder)
    results["written_frames"] = hold_video_frames(written, reference)
    if results["written_frames"] != n:
        raise AssertionError(f"to_video wrote {results['written_frames']} of {n} frames")
    if "cv2.VideoWriter, fourcc 'FFV1'" in video["writer"]:  # lossless: the file decodes to the same bytes
        results["video_frames"] = hold_video_frames(decoded(), reference)
    else:  # the native H.264 writer is lossy: the frames handed to it are what is held
        results["video_frames"] = f"not decoded: {video['writer']}"
    results["geotiff"] = hold_geotiff(out_dir / "frame_0000.tif", folder / "reference_frame_0000.tif")

    sample = {}
    for dev in (device, "cpu"):
        fn = out_dir / f"sample_rgb_{dev}.tif"
        before = dict(_device.COPY_BYTES)
        t0 = time.perf_counter()
        pyorc_tpu_torch.set_device(dev)
        try:
            cli_utils.parse_geotiff(str(clip), str(fn_cc), str(fn), frame_sample=0, logger=logger)
        finally:
            pyorc_tpu_torch.set_device(device)
        sample[dev] = {"wall_s": time.perf_counter() - t0, **{k: _device.COPY_BYTES[k] - before[k] for k in before}}
        if not fn.exists():
            raise AssertionError(f"parse_geotiff on {dev} wrote no file (it logs its error instead of raising)")
    rows["parse_geotiff"] = sample[device]
    results["parse_geotiff"] = hold_geotiff(out_dir / f"sample_rgb_{device}.tif", out_dir / "sample_rgb_cpu.tif")
    wall, moved, shape = ugrid_arrays_equal(proc.velocimetry_mask_obj, device)
    rows["to_ugrid"] = {"wall_s": wall, **moved, "time_faces": shape}
    results["to_ugrid"] = "arrays equal to the CPU's"
    return results, rows, _stage_walls(handler.lines)


def geul_camera_config():
    """The Geul fixture's camera (GEUL_CAMERA) as the port's ``CameraConfig``."""
    import copy

    from pyorc_tpu_torch import CameraConfig

    return CameraConfig(**copy.deepcopy(GEUL_CAMERA))


def geul_cross_section(cc):
    """The Geul fixture's bathymetry (24 points, WGS84 -> EPSG:28992) as the port's ``CrossSection``."""
    from pyorc_tpu_torch import CrossSection
    from pyorc_tpu_torch.geom import crs as crs_mod

    x, y = crs_mod.transform_points(4326, 28992, np.array(GEUL_LON), np.array(GEUL_LAT))
    return CrossSection(camera_config=cc, cross_section=[[float(a), float(b), float(c)] for a, b, c in zip(x, y, GEUL_ZS)])


def waterline_scene(cs, seed=3, h=GEUL_H):
    """uint8 camera frame of the cross-section ``cs``'s scene: bright noisy land (N(170, 30)),
    dark water (N(60, 8)) over the wet part of its camera's bbox at level ``h``. For the Geul
    fixture with the default seed it is ``tests/test_cross_section.py``'s ``synth_img``, drawn
    with the port's fill in place of ``cv2.fillPoly``."""
    from pyorc_tpu_torch.geom import shapes

    cc = cs.camera_config
    rng = np.random.default_rng(seed)
    img = np.zeros((cc.height, cc.width), dtype=np.uint8)
    img[:] = rng.normal(170, 30, size=img.shape).clip(0, 255)
    for pol in cs.get_bbox_dry_wet(h=h, camera=True).geoms:
        ring = np.asarray(pol.exterior.coords)[:, :2]
        ring = ring[np.isfinite(ring).all(axis=1)]
        if len(ring) >= 3:
            mask = shapes.fill_polygon(img.shape, np.round(ring).astype(np.int32))
            noise = rng.normal(60, 8, size=img.shape).clip(0, 255)
            img = np.where(mask, noise.astype(np.uint8), img)
    return img


def water_level_phase(folder, device, n_frames=3):
    """Step 5e: the optical water level through the service's ``get_water_level`` on an
    FFV1 clip (``n_frames`` frames of 1920x1080, :func:`waterline_scene` with seeds 3, 4, ...)
    opened with ``pyorc_tpu_torch.Video``: the level must lie within GEUL_TOL of GEUL_H
    with s2n above GEUL_S2N_MIN. Then the scorer alone on the mean frame the detection
    read, on ``device`` and on the CPU: the scores must be equal (to 1e-12: integer
    counts through the same float64 host arithmetic). Returns the numbers and times:
    the scorer's device time (CUDA events around its batches), its bytes up, the
    number of candidates and polygon slots, and the same for the grid search.
    """
    import torch

    import pyorc_tpu_torch
    from pyorc_tpu_torch._device import COPY_BYTES
    from pyorc_tpu_torch.ops import waterlevel
    from pyorc_tpu_torch.service.velocimetry import get_water_level

    pyorc_tpu_torch.set_device(device)
    cc = geul_camera_config()
    cs = geul_cross_section(cc)
    clip = write_clip(np.stack([waterline_scene(cs, seed=3 + i) for i in range(n_frames)]), folder / "geul.avi")
    video = pyorc_tpu_torch.Video(str(clip), camera_config=cc, progress=False)
    seen = {}
    detect = cs.detect_water_level_s2n

    def recorded(img, **kwargs):
        seen["img"] = img
        seen["level"], seen["s2n"] = detect(img, **kwargs)
        return seen["level"], seen["s2n"]

    cs.detect_water_level_s2n = recorded
    t0 = time.perf_counter()
    level = get_water_level(video, cs, n_start=0, n_end=n_frames, s2n_thres=GEUL_S2N_MIN)
    out = {"get_water_level_s": time.perf_counter() - t0, "level": level, "s2n": seen["s2n"]}
    if level is None or abs(level - GEUL_H) >= GEUL_TOL:
        raise AssertionError(f"optical water level {seen['level']} (s2n {seen['s2n']}) vs {GEUL_H} m")
    img = seen["img"]

    counts = waterlevel._counts
    cuda = torch.device(device).type == "cuda"

    def scorer(run):
        """run() with the scorer's batches timed by CUDA events and its uploads counted."""
        events, slots = [], []

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True) if cuda else None
            if cuda:
                start.record()
            result = counts(*args)
            slots.append(args[2].shape[0])
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                events.append((start, end))
            return result

        waterlevel._counts = timed
        h2d = COPY_BYTES["h2d"]
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        try:
            result = run()
        finally:
            waterlevel._counts = counts
        if cuda:
            torch.cuda.synchronize()
        stats = {
            "wall_s": time.perf_counter() - t0, "slots": int(sum(slots)), "batches": len(slots),
            "device_ms": sum(a.elapsed_time(b) for a, b in events) if cuda else "not measured",
            "h2d_bytes": COPY_BYTES["h2d"] - h2d,
            "peak_bytes": torch.cuda.max_memory_allocated() - base if cuda else "not measured",
        }
        # the batch budget holds: temporaries within BATCH_BYTES beside the padded frame
        if cuda and stats["peak_bytes"] > waterlevel.BATCH_BYTES + stats["h2d_bytes"]:
            raise AssertionError(f"water-level scorer peaked at {stats['peak_bytes']} B of device memory, "
                                 f"over BATCH_BYTES {waterlevel.BATCH_BYTES} + {stats['h2d_bytes']} B up")
        return result, stats

    (l_range, _, scores), out["s2n_scorer"] = scorer(lambda: cs._water_level_score_range(img))
    out["s2n_scorer"]["candidates"] = len(l_range)
    cpu_scores = _on_cpu(device, lambda: cs._water_level_score_range(img)[2])
    out["max_abs_diff_vs_cpu"] = float(np.max(np.abs(np.asarray(scores) - np.asarray(cpu_scores))))
    if out["max_abs_diff_vs_cpu"] > 1e-12:
        raise AssertionError(f"water-level scores on {device} differ from the CPU's by {out['max_abs_diff_vs_cpu']}")
    out["grid_level"], out["grid_scorer"] = scorer(lambda: cs.detect_water_level(img, method="grid"))
    return out


def _on_cpu(device, run):
    """``run()`` with the port's device set to the CPU, then set back to ``device``."""
    import pyorc_tpu_torch

    pyorc_tpu_torch.set_device("cpu")
    try:
        return run()
    finally:
        pyorc_tpu_torch.set_device(device)


def rgb_stack(h, w, n_frames, device):
    """uint8 [n_frames, h, w, 3]: the advected texture, its negative and its half as the three bands."""
    gray = advected_stack(h, w, n_frames, device)
    return np.stack([gray, 255 - gray, gray // 2], axis=-1)


def filters_phase(proj, h, w, device):
    """Drive every frame filter through its ``Frames`` method on ``device``, on the per-pair
    slice's projected stack ``proj`` (camera frames h x w), and ``project`` on an RGB stack of
    RGB_FRAMES camera frames; hold each result against the same method of the port run on the
    CPU on the stack's leading frames (``range`` and the RGB projection: on all of them).

    smooth and edge_detect must agree within BLUR_TOL, minmax, time_diff, range and the RGB
    projection exactly, reduce_rolling (uint8 frames) within one count on fewer than 1e-4 of
    the pixels. Returns (per-filter results with the tolerance held, stage times).
    """
    n = proj.shape[0]
    roll = min(ROLL_SAMPLES, n)
    # (method, kwargs, leading frames the CPU repeats, tolerance): time_diff's first k
    # differences need k + 1 frames
    cases = [
        ("smooth", {"wdw": STIV_SMOOTH_WDW}, FILTER_SAMPLE, BLUR_TOL),
        ("edge_detect", {"wdw_1": 1, "wdw_2": 2}, FILTER_SAMPLE, BLUR_TOL),
        ("minmax", {"min": 40.0, "max": 200.0}, FILTER_SAMPLE, 0),
        ("time_diff", {"thres": 2.0, "abs": True}, FILTER_SAMPLE + 1, 0),
        ("reduce_rolling", {"samples": roll}, min(ROLL_SAMPLE, n), 1),
        ("range", {}, n, 0),
    ]
    times, results = {}, {}
    for method, kwargs, n_cpu, tol in cases:
        with _stage(times, method):
            got = getattr(proj.frames, method)(**kwargs)
        head = proj[:n_cpu]
        want = _on_cpu(device, lambda: getattr(head.frames, method)(**kwargs))
        if method == "time_diff" and (got.shape[0] != n - 1 or got["time"].values[0] != proj["time"].values[1]):
            raise AssertionError("time_diff: the first time coordinate was not dropped")
        got_v = got.values if method == "range" else got.values[: want.shape[0]]
        if got_v.shape != want.values.shape or got_v.dtype != want.values.dtype or got.dims != want.dims:
            raise AssertionError(f"{method}: {got_v.shape} {got_v.dtype} on the card, {want.shape} {want.dtype} on the CPU")
        diff = np.abs(got_v.astype(np.float64) - want.values.astype(np.float64))
        row = {"shape": list(got.shape), "dtype": str(got.values.dtype), "cpu_frames": n_cpu,
               "max_abs_diff": float(diff.max()), "tolerance": tol}
        if method == "reduce_rolling":
            row["differing_share"] = float((diff > 0).mean())
            if not got.values[roll - 1 :].any() or got.values[: roll - 1].any():
                raise AssertionError("reduce_rolling: the first samples - 1 frames are not the zero ones")
            if row["differing_share"] > 1e-4:
                raise AssertionError(f"reduce_rolling: {row}")
        if not diff.max() <= tol:
            raise AssertionError(f"{method} on {device} against the CPU: {row}")
        results[method] = row
    from pyorc_tpu_torch import ndx

    cc = nadir_camera_config(h, w)
    stack = rgb_stack(h, w, RGB_FRAMES, device)
    gray = frames_dataarray(stack[..., 0], cc)
    rgb = ndx.DataArray(
        stack, dims=("time", "y", "x", "rgb"), coords={k: gray[k].values for k in ("time", "y", "x")},
        attrs=dict(gray.attrs), name="frames",
    )
    with _stage(times, "project[rgb]"):
        got = rgb.frames.project()
    want = _on_cpu(device, lambda: rgb.frames.project())
    if got.dims != ("time", "y", "x", "rgb") or got.shape != (RGB_FRAMES, *proj.shape[1:], 3):
        raise AssertionError(f"RGB project: dims {got.dims}, shape {got.shape}")
    diff = np.abs(got.values.astype(np.int16) - want.values.astype(np.int16))
    results["project[rgb]"] = {"shape": list(got.shape), "dtype": str(got.values.dtype), "cpu_frames": RGB_FRAMES,
                               "max_abs_diff": float(diff.max()), "tolerance": 0}
    if diff.max() != 0 or not got.values.any():
        raise AssertionError(f"RGB project on {device} against the CPU: {results['project[rgb]']}")
    return results, times


def stiv_lines_inside(proj, angle, length, n_lines=STIV_LINES):
    """[n, 2] centres (x, y) [m] of a grid of lines of ``length`` at ``angle``, every end inside ``proj``."""
    x, y = proj["x"].values, proj["y"].values
    half_x = abs(np.cos(angle)) * length / 2 + 0.1
    half_y = abs(np.sin(angle)) * length / 2 + 0.1
    cx = np.linspace(x.min() + half_x, x.max() - half_x, n_lines[1])
    cy = np.linspace(y.min() + half_y, y.max() - half_y, n_lines[0])
    return np.array([[a, b] for b in cy for a in cx])


def stiv_phase(proj, h, w, n_lines=STIV_LINES):
    """Drive the port's second velocimetry path on the per-pair slice's projected stack ``proj``
    (camera frames h x w): smooth -> get_stiv on lines along the analytic flow direction.

    The median v must lie within STIV_RTOL of the analytic speed ``hypot(v_x, v_y)`` with
    every line's coherence above STIV_COH_MIN; along ``angle + pi`` it must read the opposite
    sign; and a profile call (``window=STIV_WINDOW``) must meet the same bar in the median of
    its interior points. Returns (results, stage times).
    """
    cc = nadir_camera_config(h, w)
    vx, vy = expected_velocity(cc)
    speed, angle = float(np.hypot(vx, vy)), float(np.arctan2(vy, vx))
    centers = stiv_lines_inside(proj, angle, STIV_LENGTH, n_lines)
    n_samples = int(round(STIV_LENGTH / RES / STIV_STEP_PX)) + 1
    times = {}
    with _stage(times, "smooth[stiv]"):
        smooth = proj.frames.smooth(wdw=STIV_SMOOTH_WDW)
    with _stage(times, "get_stiv"):
        along = smooth.frames.get_stiv(centers, angle, STIV_LENGTH, n_samples=n_samples)
    with _stage(times, "get_stiv[reverse]"):
        against = smooth.frames.get_stiv(centers, angle + np.pi, STIV_LENGTH, n_samples=n_samples)
    with _stage(times, "get_stiv[profile]"):
        profile = smooth.frames.get_stiv(centers, angle, STIV_LENGTH, n_samples=n_samples, window=STIV_WINDOW)
    results = {"speed_true": speed, "angle": angle, "n_lines": len(centers), "n_samples": n_samples,
               "frames": proj.shape[0]}
    margin = STIV_WINDOW  # profile points whose box and shear margin lie inside the line
    for name, ds, sign in (("along", along, 1.0), ("against", against, -1.0), ("profile", profile, 1.0)):
        v, coh = ds["v"].values, ds["coherence"].values
        want_dims = ("line", "points") if name == "profile" else ("line",)
        if ds["v"].dims != want_dims or v.shape[0] != len(centers) or v.dtype != np.float32:
            raise AssertionError(f"STIV {name}: dims {ds['v'].dims}, shape {v.shape}, dtype {v.dtype}")
        if name == "profile":
            if v.shape[1] != n_samples:
                raise AssertionError(f"STIV profile: {v.shape[1]} points, not {n_samples}")
            v, coh = v[:, margin:-margin], coh[:, margin:-margin]
        median, coh_min = float(np.nanmedian(v)), float(np.nanmin(coh))
        results[name] = {"v_median": median, "v_min": float(np.nanmin(v)), "v_max": float(np.nanmax(v)),
                         "coherence_min": coh_min, "coherence_median": float(np.nanmedian(coh))}
        if not abs(median - sign * speed) <= STIV_RTOL * speed:
            raise AssertionError(f"STIV {name}: median v {median} vs {sign * speed} m/s; {results[name]}")
        # a profile's single points may dip; its lines and the whole-line calls may not
        low = float(np.nanmedian(coh)) if name == "profile" else coh_min
        if not low > STIV_COH_MIN:
            raise AssertionError(f"STIV {name}: coherence {low} not above {STIV_COH_MIN}; {results[name]}")
    return results, times


def _median_ms(fn, reps=10):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _n_pairs(frames, pair_stride):
    return frames.shape[0] - 1 if pair_stride == 1 else frames.shape[0] // pair_stride


def _pieces(frames, pair_stride, piece=25):
    """``frames`` cut into stacks of at most ``piece`` pairs each (pairs at ``pair_stride``)."""
    n_pairs = _n_pairs(frames, pair_stride)
    for p0 in range(0, n_pairs, piece):
        p1 = min(p0 + piece, n_pairs)
        yield frames[p0 * pair_stride : (p1 - 1) * pair_stride + 2]


def _plain_pairs(frames, args, pair_stride=1):
    """The per-pair plain version over ``frames``, 25 pairs at a time to bound its memory."""
    import torch

    from pyorc_tpu_torch.ops import piv_kernels

    pieces = [
        piv_kernels.piv_pairs_fused_plain(f, *args, pair_stride=pair_stride) for f in _pieces(frames, pair_stride)
    ]
    return [torch.cat(p) for p in zip(*pieces)]


def _pairs_gap(frames, args, pair_stride=1):
    """Top-2 peak gap of each window pair's plane, [n_pairs, n_rows, n_cols], 25 pairs at a time."""
    import torch

    from pyorc_tpu_torch.ops import piv as piv_ops

    gaps = [piv_ops.top2_gap(f, *args[:3], pair_stride) for f in _pieces(frames, pair_stride)]
    return torch.cat(gaps).reshape(-1, args[3], args[4])


def work_bound(frames, args, n_pairs, out_bytes, per_pair_extra=0):
    """The least time the card could take for a PIV kernel's work on these inputs.

    Operations are those of the FFT algorithm, whatever implements them:
    per frame window one real 2-D FFT (2.5 N log2 N for N = w^2 points) plus
    the demean and variance (3 N); per window pair one inverse real FFT, the
    spectral product (3 N) and the plane's normalization, clip, max and sum
    (4 N), plus ``per_pair_extra`` N. Bytes: the frames read once and
    ``out_bytes`` written once. Returns (bound_ms, "operations" or "bytes").
    """
    import math

    _, sas, _, n_rows, n_cols = args
    n_pix = sas[0] * sas[1]
    fft = 2.5 * n_pix * math.log2(n_pix)
    n_win = n_rows * n_cols
    flops = n_win * (frames.shape[0] * (fft + 3 * n_pix) + n_pairs * (fft + (7 + per_pair_extra) * n_pix))
    n_bytes = frames.numel() * frames.element_size() + out_bytes
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def pairs_bound(frames, args, pair_stride=1):
    n_pairs = _n_pairs(frames, pair_stride)
    return work_bound(frames, args, n_pairs, 4 * 4 * n_pairs * args[3] * args[4])


def ensemble_bound(frames, args):
    n_pairs, n_win = frames.shape[0] - 1, args[3] * args[4]
    out_bytes = 4 * (n_win * args[1][0] * args[1][1] + n_win + 2 * n_pairs * n_win)
    return work_bound(frames, args, n_pairs, out_bytes, per_pair_extra=1)


def compare_kernel(frames, args, label, pair_stride=1):
    """The per-pair kernel against its plain version on the same frames; returns (kernel outputs, errors).

    The kernel runs in one launch over all of ``frames``, as the engine calls
    it. ``args`` are ``(dim_size, sas, overlap, n_rows, n_cols)``. Raises
    unless the outputs agree as :func:`hold_pairs` requires.
    """
    from pyorc_tpu_torch.ops import piv_kernels

    kern = piv_kernels.piv_pairs_fused(frames, *args, pair_stride=pair_stride)
    if piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] != "cuda":
        raise AssertionError("piv_pairs_fused did not take the CUDA kernel")
    plain = _plain_pairs(frames, args, pair_stride)
    return kern, hold_pairs(kern, plain, _pairs_gap(frames, args, pair_stride), label)


def hold_pairs(kern, plain, gap, label):
    """Per-pair outputs (u, v, cmax, s2n) of the kernel against the plain version's; returns the errors.

    Raises unless the NaN masks are equal, |d cmax| <= 1e-4, s2n agrees to
    1e-3 relative and |d u|, |d v| <= 1e-3 px on windows whose top-2 peak
    gap ``gap`` exceeds 5e-3.
    """
    import torch

    u_k, v_k, c_k, s_k = kern
    u_p, v_p, c_p, s_p = plain
    for name, a, b in (("u", u_k, u_p), ("v", v_k, v_p), ("cmax", c_k, c_p), ("s2n", s_k, s_p)):
        if a.shape != b.shape or not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"{label} {name}: shapes or NaN masks differ")
    d_cmax = float(torch.nan_to_num((c_k - c_p).abs()).max())
    rel_s2n = float(torch.nan_to_num((s_k - s_p).abs() / s_p.abs().clamp(min=1e-6)).max())
    confident = (gap.reshape(u_p.shape) > 5e-3) & ~torch.isnan(u_p)
    d_uv = float(torch.maximum((u_k - u_p).abs(), (v_k - v_p).abs())[confident].max())
    if d_cmax > 1e-4 or rel_s2n > 1e-3 or d_uv > 1e-3:
        raise AssertionError(f"{label}: kernel vs plain |dcmax|={d_cmax} rel ds2n={rel_s2n} |duv|={d_uv}")
    return {
        "n_pairs": u_k.shape[0], "n_windows": u_k.shape[1] * u_k.shape[2],
        "max_abs_dcmax": d_cmax, "max_rel_ds2n": rel_s2n, "max_abs_duv_px": d_uv,
        "confident_share": float(confident.float().mean()),
    }


def _mean_plane_uv(corr_sum, count, n_rows, n_cols):
    """(u, v) [n_rows, n_cols] of the mean planes, and each mean plane's top-2 peak gap."""
    import torch

    from pyorc_tpu_torch.ops import piv as piv_ops

    mean = corr_sum / count.clamp(min=1)[:, None, None]
    u, v = piv_ops.u_v_displacement(mean[None], n_rows, n_cols)
    top2 = torch.topk(mean.flatten(-2), 2, dim=-1).values
    return u[0], v[0], (top2[:, 0] - top2[:, 1]).reshape(n_rows, n_cols)


def compare_ensemble(frames, args, label, corr_min=CORR_MIN, s2n_min=S2N_MIN):
    """The ensemble kernel against its plain version on the same frames; returns (kernel outputs, errors).

    A window pair whose cmax lies within 1e-5 of ``corr_min``, or whose s2n
    within 1e-4 relative of ``s2n_min``, may pass the gate in one version and
    not the other (a gate flip); any other flip raises. On windows without a
    flip, the counts must be equal and |d corr_sum| <= 1e-4 * max(count, 1).
    On pairs gated alike, |d cmax| <= 1e-4 and s2n agrees to 1e-3 relative.
    The mean planes' u/v agree to 1e-3 px where their top-2 peak gap exceeds
    5e-3. ``corr_min`` must be positive: a pair is ok where its gated cmax is.
    """
    import torch

    from pyorc_tpu_torch.ops import piv_kernels

    if corr_min <= 0:
        raise ValueError(f"compare_ensemble needs corr_min > 0, got {corr_min}")
    kern = piv_kernels.piv_ensemble_fused(frames, *args, corr_min, s2n_min)
    if piv_kernels.KERNEL_ROUTE["piv_ensemble_fused"] != "cuda":
        raise AssertionError("piv_ensemble_fused did not take the CUDA kernel")
    plain = piv_kernels.piv_ensemble_fused_plain(frames, *args, corr_min, s2n_min)
    for name, a, b in zip(("corr_sum", "count", "cmax", "s2n"), kern, plain):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{label} {name}: shape {tuple(a.shape)} vs {tuple(b.shape)}, or not finite")
    (sum_k, n_k, c_k, s_k), (sum_p, n_p, c_p, s_p) = kern, plain
    ok_k, ok_p = c_k > 0, c_p > 0
    flip = ok_k != ok_p
    cm, sn = torch.where(ok_k, c_k, c_p), torch.where(ok_k, s_k, s_p)
    near = ((cm - corr_min).abs() <= 1e-5) | ((sn - s2n_min).abs() <= 1e-4 * s2n_min)
    if (flip & ~near).any():
        raise AssertionError(f"{label}: {int((flip & ~near).sum())} gate flips away from the thresholds")
    steady = ~flip.flatten(1).any(0)  # windows without a flip
    d_sum = (sum_k - sum_p).abs().flatten(1).amax(1)
    same = ~flip & ok_p
    d_cmax = float((c_k - c_p).abs()[same].max())
    rel_s2n = float(((s_k - s_p).abs() / s_p.clamp(min=1e-6))[same].max())
    n_rows, n_cols = args[3], args[4]
    u_k, v_k, _ = _mean_plane_uv(sum_k, n_k, n_rows, n_cols)
    u_p, v_p, gap = _mean_plane_uv(sum_p, n_p, n_rows, n_cols)
    confident = (gap > 5e-3) & (n_p > 0).reshape(gap.shape) & steady.reshape(gap.shape)
    if not confident.any():
        raise AssertionError(f"{label}: no window with a confident mean-plane peak")
    d_uv = float(torch.maximum((u_k - u_p).abs(), (v_k - v_p).abs())[confident].max())
    if not torch.equal(n_k[steady], n_p[steady]) or (d_sum > 1e-4 * n_p.clamp(min=1))[steady].any():
        raise AssertionError(f"{label}: counts or corr_sum differ, max |d sum| {float(d_sum[steady].max())}")
    if d_cmax > 1e-4 or rel_s2n > 1e-3 or d_uv > 1e-3:
        raise AssertionError(f"{label}: kernel vs plain |dcmax|={d_cmax} rel ds2n={rel_s2n} |duv|={d_uv}")
    errors = {
        "n_pairs": c_k.shape[0], "n_windows": n_rows * n_cols, "gate_flips": int(flip.sum()),
        "ok_share": float(ok_p.float().mean()), "max_abs_dsum": float(d_sum[steady].max()),
        "max_abs_dcmax": d_cmax, "max_rel_ds2n": rel_s2n, "max_abs_duv_px": d_uv,
        "confident_share": float(confident.float().mean()),
    }
    return kern, errors


def _fmt(size):
    """A window (int, or (y, x)) as it appears in labels: "16" or "64x128"."""
    return "x".join(map(str, size)) if isinstance(size, tuple) else str(size)


def _grid(dim_size, w_px, step=None):
    """(dim_size, sas, overlap, n_rows, n_cols) of windows ``w_px`` (an int for
    square ones, or (y, x)) at ``step`` (the same; default half the window)."""
    from pyorc_tpu_torch.ops import windows as win

    sas = tuple(win._as2(w_px))
    steps = tuple(s // 2 for s in sas) if step is None else tuple(win._as2(step))
    overlap = (sas[0] - steps[0], sas[1] - steps[1])
    return (tuple(dim_size), sas, overlap, *win.get_field_shape(dim_size, sas, overlap))


def kernel_phase(device):
    """Per-pair kernel vs plain version on the card at KERNEL_SIZES (consecutive pairs)
    and STRIDE2_SIZES (pair_stride=2), both timed; returns numbers keyed by (size, pair_stride)."""
    import torch

    from pyorc_tpu_torch.ops import piv_kernels

    h, w, n_frames = 1088, 1920, 9
    frames = torch.as_tensor(advected_stack(h, w, n_frames, device), device=device)
    out = {}
    for size, stride in [(s, 1) for s in KERNEL_SIZES] + [(s, 2) for s in STRIDE2_SIZES]:
        args = _grid((h, w), size)
        label = f"kernel {_fmt(size)} px" + ("" if stride == 1 else f", pair_stride {stride}")
        _, row = compare_kernel(frames, args, label, stride)
        row["ms"] = _median_ms(lambda: piv_kernels.piv_pairs_fused(frames, *args, pair_stride=stride))
        if size in CLOCK_SIZES and stride == 1:
            clocks_under_load(lambda: piv_kernels.piv_pairs_fused(frames, *args), row["ms"], label)
        row["plain_ms"] = _median_ms(lambda: piv_kernels.piv_pairs_fused_plain(frames, *args, pair_stride=stride))
        row["bound_ms"], row["bound_by"] = pairs_bound(frames, args, stride)
        out[size, stride] = row
        print(f"{label}: {json.dumps(row)}", flush=True)
    return out


def ensemble_kernel_phase(device):
    """Ensemble kernel vs plain version at 1088x1920, 65 frames, ENS_KERNEL_CASES, both timed."""
    import torch

    from pyorc_tpu_torch.ops import piv_kernels

    h, w, n_frames = 1088, 1920, 65
    stack = torch.as_tensor(advected_stack(h, w, n_frames, device), device=device)
    out = {}
    for size, step, n in ENS_KERNEL_CASES:
        frames = stack[:n]
        args = _grid((h, w), size, step)
        half = args[2] == tuple(s // 2 for s in args[1])  # the overlap is half the window
        label = (f"ensemble kernel {_fmt(size)} px" + ("" if half else f", step {_fmt(step)}")
                 + ("" if n == n_frames else f", {n - 1} pairs"))
        _, row = compare_ensemble(frames, args, label)
        row["ms"] = _median_ms(lambda: piv_kernels.piv_ensemble_fused(frames, *args))
        if size in CLOCK_SIZES and n == n_frames:
            clocks_under_load(lambda: piv_kernels.piv_ensemble_fused(frames, *args), row["ms"], label)
        row["plain_ms"] = _median_ms(lambda: piv_kernels.piv_ensemble_fused_plain(frames, *args))
        row["bound_ms"], row["bound_by"] = ensemble_bound(frames, args)
        out[size, step, n] = row
        print(f"{label}: {json.dumps(row)}", flush=True)
    return out


def clocks_under_load(fn, ms, label, busy_ms=400.0):
    """Print the card's SM clock and power draw while ``fn`` (one launch of ``ms``) runs back to back.

    Enough launches for ``busy_ms`` are queued without waiting; ``nvidia-smi``
    reads the card while they run."""
    import torch

    for _ in range(max(2, int(busy_ms / max(ms, 1e-3)))):
        fn()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    print(f"SM clock, power draw under {label}: {smi}", flush=True)


def fft_alone_ms(proj, device, window=ENS_WINDOW, chunk=10):
    """Time [ms] of ``torch.fft.rfft2`` of every window of every frame of the
    projected stack plus ``irfft2`` of as many planes as there are pairs, and
    nothing else of the contract (no statistics, product, gate or sum): the
    library's transforms alone, for context beside the ensemble kernel."""
    import torch

    from pyorc_tpu_torch.ops import piv as piv_ops
    from pyorc_tpu_torch.ops import windows as win

    frames = torch.as_tensor(np.ascontiguousarray(proj.values)).to(device)
    dims, sas, overlap, _, _ = _grid(frames.shape[1:], window)
    row0, col0 = win.get_window_starts(dims, sas, overlap)
    total = 0.0
    for f0 in range(0, frames.shape[0], chunk):
        wins = piv_ops.extract_windows(frames[f0 : f0 + chunk].float(), row0, col0, *sas).contiguous()
        n_planes = wins.shape[0] - (1 if f0 + chunk >= frames.shape[0] else 0)  # one plane per pair
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        spec = torch.fft.rfft2(wins)
        torch.fft.irfft2(spec[:n_planes], s=sas)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
        del wins, spec
    return total


def main_path_check(proj, pivs, device, reps=10):
    """The per-pair kernel against its plain version on the stack and grids the slice gave it.

    Also checks that the slice's (unmasked) velocities are the kernel's
    displacements scaled by the resolution and the frame interval, and
    times kernel and plain version on that stack (median of ``reps``), and
    the kernel without its runs of consecutive pairs (``one_pair_per_block_ms``).
    """
    import torch

    from pyorc_tpu_torch.ops import piv_kernels

    frames = torch.as_tensor(np.ascontiguousarray(proj.values)).to(device)
    dt = np.diff(proj["time"].values)[:, None, None]
    out = {}
    for w_px, piv in pivs.items():
        args = _grid(frames.shape[1:], w_px)
        label = f"main path {_fmt(w_px)} px"
        (u, v, _, _), out[w_px] = compare_kernel(frames, args, label)
        for name, disp in (("v_x", u), ("v_y", v)):
            want = (disp.cpu().numpy() * RES / dt).astype(np.float32)
            np.testing.assert_allclose(piv[name].values, want, rtol=1e-6, atol=0, err_msg=f"{label} {name}")
        if device != "cpu":
            out[w_px]["ms"] = _median_ms(lambda: piv_kernels.piv_pairs_fused(frames, *args), reps)
            out[w_px]["plain_ms"] = _median_ms(lambda: _plain_pairs(frames, args), reps)
            # the same pairs given explicitly (frames 0 1 1 2 2 3 ... at pair_stride=2): one pair per
            # block and every frame transformed twice, where consecutive frames let a block walk a run
            explicit = frames.repeat_interleave(2, dim=0)[1:-1]
            out[w_px]["one_pair_per_block_ms"] = _median_ms(
                lambda: piv_kernels.piv_pairs_fused(explicit, *args, pair_stride=2), reps
            )
            del explicit
        out[w_px]["bound_ms"], out[w_px]["bound_by"] = pairs_bound(frames, args)
        print(f"{label} ({tuple(frames.shape)} uint8): {json.dumps(out[w_px])}", flush=True)
    return out


def multipass_main_path_check(proj, piv, device, window_size=32, passes=3, reps=5):
    """The multipass cascade on the stack the slice gave it, with the kernel and with its plain version.

    Runs :func:`pyorc_tpu_torch.ops.multipass.piv_multipass` over the whole
    projected stack twice: once as the engine runs it, once with
    ``piv_kernels.piv_pairs_fused`` swapped for the plain version (here
    only, with ``unittest.mock.patch``). Every pass of the first run must
    take the CUDA kernel. The last pass's outputs of the two runs are held to
    each other as :func:`hold_pairs` requires (the gap from the plain run's
    last deformed pairs), and the slice's unmasked v_x / v_y to the first
    run's displacements times RES / dt. On the card each pass's kernel and
    plain version are timed on that pass's interleaved deformed pairs
    (median of ``reps``), beside the bound. Returns the errors and a row per pass.
    """
    from unittest import mock

    import torch

    from pyorc_tpu_torch.ops import multipass, piv_kernels

    frames = torch.as_tensor(np.ascontiguousarray(proj.values)).to(device)
    w_px = window_size + window_size % 2
    dims, sas, ov, n_rows, n_cols = _grid(frames.shape[1:], w_px)
    kernel = piv_kernels.piv_pairs_fused
    calls = {"kernel": [], "plain": []}

    def recorded(name, fn):
        def run(pairs, *args, **kwargs):
            out = fn(pairs, *args, **kwargs)
            calls[name].append((pairs, args[:5], piv_kernels.KERNEL_ROUTE.get("piv_pairs_fused")))
            return out
        return run

    def plain(pairs, *args, pair_stride=1):
        return _plain_pairs(pairs, args[:5], pair_stride)

    label = f"multipass main path {w_px} px x{passes}"
    with mock.patch.object(piv_kernels, "piv_pairs_fused", recorded("kernel", kernel)):
        kern = multipass.piv_multipass(frames, dims, sas, ov, n_rows, n_cols, passes=passes)
    routes = [route for _, _, route in calls["kernel"]]
    if len(routes) != passes or set(routes) != {"cuda"}:
        raise AssertionError(f"{label}: the passes took {routes}, not the CUDA kernel each")
    with mock.patch.object(piv_kernels, "piv_pairs_fused", recorded("plain", plain)):
        ref = multipass.piv_multipass(frames, dims, sas, ov, n_rows, n_cols, passes=passes)
    last_pairs, last_args, _ = calls["plain"][-1]
    out = hold_pairs(kern, ref, _pairs_gap(last_pairs, last_args, 2), label)
    dt = np.diff(proj["time"].values)[:, None, None]
    for name, disp in (("v_x", kern[0]), ("v_y", kern[1])):
        want = (disp.cpu().numpy() * RES / dt).astype(np.float32)
        np.testing.assert_allclose(piv[name].values, want, rtol=1e-6, atol=0, err_msg=f"{label} {name}")
    out["passes"] = []
    for pairs, args, _ in calls["kernel"]:
        row = {"window": args[1][0], "n_pairs": pairs.shape[0] // 2, "n_windows": args[3] * args[4]}
        if device != "cpu":
            row["ms"] = _median_ms(lambda: kernel(pairs, *args, pair_stride=2), reps)
            row["plain_ms"] = _median_ms(lambda: _plain_pairs(pairs, args, 2), 3)
        row["bound_ms"], row["bound_by"] = pairs_bound(pairs, args, 2)
        out["passes"].append(row)
    print(f"{label} ({tuple(frames.shape)} uint8): {json.dumps(out)}", flush=True)
    return out


def ensemble_main_path_check(proj, piv, device, window=ENS_WINDOW, reps=3):
    """The ensemble kernel against its plain version on the projected stack the slice gave it.

    The kernel runs in one launch over the whole stack (the engine may have
    cut it into chunks, which changes only the order of the float sums), so
    the slice's unmasked v_x / v_y are held to the kernel's mean-plane
    displacements times RES / mean dt within 1e-3 px where the mean plane's
    top-2 gap exceeds 5e-3, and low-count cells must be NaN. Times kernel
    and plain version on the stack (median of ``reps``).
    """
    import torch

    from pyorc_tpu_torch.ops import piv_kernels

    frames = torch.as_tensor(np.ascontiguousarray(proj.values)).to(device)
    args = _grid(frames.shape[1:], window)
    label = f"ensemble main path {window} px"
    (corr_sum, count, _, _), out = compare_ensemble(frames, args, label)
    u, v, gap = _mean_plane_uv(corr_sum, count, args[3], args[4])
    low = (count < COUNT_MIN * (frames.shape[0] - 1)).reshape(gap.shape).cpu().numpy()
    confident = ((gap > 5e-3).cpu().numpy()) & ~low
    scale = RES / float(np.diff(proj["time"].values).mean())
    for name, disp in (("v_x", u), ("v_y", v)):
        got = piv[name].values[0]
        want = disp.cpu().numpy() * scale
        if not np.isnan(got[low]).all() or np.isnan(got[~low]).any():
            raise AssertionError(f"{label} {name}: NaN cells are not the low-count cells")
        d = float(np.abs(got - want)[confident].max())
        if d > 1e-3 * scale:
            raise AssertionError(f"{label} {name}: slice vs kernel mean-plane velocity differ by {d} m/s")
    if device != "cpu":
        out["ms"] = _median_ms(lambda: piv_kernels.piv_ensemble_fused(frames, *args), reps)
        clocks_under_load(lambda: piv_kernels.piv_ensemble_fused(frames, *args), out["ms"], label)
        out["plain_ms"] = _median_ms(lambda: piv_kernels.piv_ensemble_fused_plain(frames, *args), reps)
    out["bound_ms"], out["bound_by"] = ensemble_bound(frames, args)
    out["low_count_share"] = float(low.mean())
    print(f"{label} ({tuple(frames.shape)} uint8): {json.dumps(out)}", flush=True)
    return out


def _union_ms(intervals, rng):
    """Length [ms] of the union of sorted (start, end) intervals [us] inside ``rng``."""
    total, cursor = 0.0, rng.start
    for start, end in intervals:
        start, end = max(start, cursor), min(end, rng.end)
        if end > start:
            total += end - start
            cursor = end
    return total / 1e3


def _profiler(device):
    """A ``torch.profiler.profile`` that records the host's threads (the lazy chain runs in a
    prefetch thread), and the card when ``device`` is one."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    try:
        config = _ExperimentalConfig(profile_all_threads=True)
    except TypeError:  # a torch without the option records the calling thread only
        config = None
    return profile(activities=activities, experimental_config=config)


def _stage_rows(prof, times):
    """Per-stage wall and device times [ms] and idle share of the stages ``times`` names, from a finished profile.

    A stage's device time is the union of the device events (kernels and
    copies) that fall inside its host time range; every stage ends with a
    copy to the host, so its device work finishes inside that range.
    ``copy_ms`` is the part spent in host<->device copies.
    """
    events = prof.events()
    ranges = {e.name: e.time_range for e in events if e.name in times and e.device_type.name == "CPU"}
    device_events = [e for e in events if e.device_type.name == "CUDA" and e.name not in times]
    busy = sorted((e.time_range.start, e.time_range.end) for e in device_events)
    copies = sorted((e.time_range.start, e.time_range.end) for e in device_events if e.name.startswith("Memcpy"))
    out = {}
    for name, rng in ranges.items():
        wall = (rng.end - rng.start) / 1e3
        device_ms = _union_ms(busy, rng)
        out[name] = {"wall_ms": wall, "device_ms": device_ms, "copy_ms": _union_ms(copies, rng),
                     "idle": 1.0 - device_ms / wall}
    return out


def _span_rows(prof, prefix="lazy:"):
    """Calls and host time [ms] of the spans named ``prefix``... (the lazy chain's decode,
    upload and ops, recorded in its prefetch thread), from a finished profile."""
    rows = {}
    for e in prof.events():
        if e.name.startswith(prefix) and e.device_type.name == "CPU":
            row = rows.setdefault(e.name, {"calls": 0, "host_ms": 0.0})
            row["calls"] += 1
            row["host_ms"] += (e.time_range.end - e.time_range.start) / 1e3
    return rows


def profile_slice(device, slice_shape, ens_shape, ens_camera=ENS_CAMERA, stiv_lines=STIV_LINES):
    """Run the slices under ``torch.profiler``; returns (per-stage times [ms] and idle share
    (:func:`_stage_rows`), per-op spans of the lazy chains (:func:`_span_rows`)).

    ``slice_shape`` and ``ens_shape`` are the (h, w, n_frames) of the
    per-pair slice (whose projected stack the multipass, non-square, filters
    and STIV phases reuse, and whose host stack the lazy per-pair chain
    streams) and the ensemble slice (whose projected stack the wide ensemble
    slice reuses, and whose host stack the lazy ensemble chain streams).
    """
    stack = advected_stack(*slice_shape, device)
    ens_stack = advected_stack(*ens_shape, device)
    ens_cc = nadir_camera_config(*ens_shape[:2], window_size=ENS_WINDOW, **ens_camera)
    with _profiler(device) as prof:
        _, times, proj, pivs = slice_phase(*slice_shape, device, stack=stack)
        _, lazy_times, _, _ = lazy_phase(stack, nadir_camera_config(*slice_shape[:2]), pivs, device)
        del pivs
        _, mp_times, _ = multipass_phase(proj, *slice_shape[:2])
        _, ns_times, _ = non_square_phase(proj, *slice_shape[:2])
        _, flt_times = filters_phase(proj, *slice_shape[:2], device)
        _, stiv_times = stiv_phase(proj, *slice_shape[:2], stiv_lines)
        del proj
        _, ens_times, ens_proj, ens_piv = ensemble_slice_phase(*ens_shape, device, camera=ens_camera, stack=ens_stack)
        _, lazy_ens_times, _, _ = lazy_phase(
            ens_stack, ens_cc, {ENS_WINDOW: ens_piv}, device, fps=ENS_FPS, ensemble=True,
            aoi_px=ens_camera["aoi_px"], tag="lazy ens",
        )
        del ens_piv
        _, wide_times, _ = wide_ensemble_phase(ens_proj, *ens_shape[:2], camera=ens_camera)
    for more in (lazy_times, mp_times, ns_times, flt_times, stiv_times, ens_times, lazy_ens_times, wide_times):
        times.update(more)
    return _stage_rows(prof, times), _span_rows(prof)


# Step 5g, multi-device: virtual shards of one card where the machine has one
MESH_SHARDS = 4
SHARD_WINDOWS = (16, 26)  # per-pair windows of the sharded check (b), 50 % overlap
MESH2D, MESH2D_WINDOW, MESH2D_FRAMES = (2, 2), 32, 9
SHARD_TOL = 1e-5  # px where two runs are not bitwise equal
# Gap-conditioned holds: the near-tie windows (top-2 peak gap at most 5e-3) may differ by
# more than SHARD_TOL on at most SHARD_FLIPS_MAX of all windows, and the confident ones
# must be at least SHARD_CONFIDENT_MIN of the finite windows, so the hold is never empty
# (16 px windows read ~0.989 in the kernel check, ~0.967 on the tests' 240x320 stack)
SHARD_CONFIDENT_MIN = 0.95
SHARD_FLIPS_MAX = 1e-5


def mesh_devices(device):
    """Step 5g (a): the mesh's devices and what they are: every card where the machine
    has more than one, else MESH_SHARDS virtual shards of ``device``."""
    import torch

    from pyorc_tpu_torch import _device

    cards = _device.local_devices()
    if len(cards) > 1:
        return cards, f"{len(cards)} cards"
    return [torch.device(device)] * MESH_SHARDS, f"{MESH_SHARDS} virtual shards of {device}"


def _launched(kernel, run):
    """(run(), the launches of ``kernel`` in that run), every launch count set to 0 just before it."""
    from pyorc_tpu_torch.ops import piv_kernels

    for name in piv_kernels.LAUNCHES:
        piv_kernels.LAUNCHES[name] = 0
    out = run()
    return out, piv_kernels.LAUNCHES[kernel]


def _wall_ms(fn, reps=3):
    """Median host wall [ms] of ``fn`` over ``reps`` runs after one warm-up; ``fn`` ends on the host."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(walls))


def hold_sharded(got, want, label, gap=None, scale=1.0, tol=SHARD_TOL):
    """Per-pair outputs (u, v, cmax, s2n; numpy) of a sharded run against the unsharded kernel's.

    The per-pair kernel walks runs of consecutive pairs whose length follows
    the launch's grid, and packs two frames into one transform, so a pair's
    plane may round differently when the pairs are split another way, and a
    near-tie peak may then flip. So: NaN masks equal; u, v (in px after
    dividing by ``scale``) within ``tol`` on windows whose top-2 peak gap
    ``gap`` exceeds 5e-3 (everywhere without ``gap``), and those confident
    windows at least SHARD_CONFIDENT_MIN of the finite ones; at most
    SHARD_FLIPS_MAX of all windows off by more than ``tol`` among the others;
    cmax within ``tol``; s2n within ``tol`` relative. Returns what held;
    raises otherwise.
    """
    got, want = [np.asarray(a) for a in got], [np.asarray(a) for a in want]
    for k, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not np.array_equal(np.isnan(g), np.isnan(w)):
            raise AssertionError(f"{label} output {k}: shapes {g.shape} vs {w.shape} or NaN masks differ")
    d_uv = np.nan_to_num(np.maximum(np.abs(got[0] - want[0]), np.abs(got[1] - want[1])) / scale)
    confident = np.ones(d_uv.shape, bool) if gap is None else np.asarray(gap).reshape(d_uv.shape) > 5e-3
    finite = ~np.isnan(want[0])
    out = {
        "bitwise": all(np.array_equal(g, w, equal_nan=True) for g, w in zip(got, want)),
        "max_abs_duv_px": float(d_uv[confident].max(initial=0.0)),
        "confident_share": float((confident & finite).sum() / max(int(finite.sum()), 1)),
        "near_tie_flips": int((d_uv[~confident] > tol).sum()),
        "flips_allowed": int(SHARD_FLIPS_MAX * d_uv.size),
        "max_abs_dcmax": float(np.nanmax(np.abs(got[2] - want[2]), initial=0.0)) if len(got) > 2 else 0.0,
        "max_rel_ds2n": float(np.nanmax(np.abs(got[3] - want[3]) / np.maximum(1.0, np.abs(want[3])),
                                        initial=0.0)) if len(got) > 3 else 0.0,
    }
    if (max(out["max_abs_duv_px"], out["max_abs_dcmax"], out["max_rel_ds2n"]) > tol
            or out["confident_share"] < SHARD_CONFIDENT_MIN or out["near_tie_flips"] > out["flips_allowed"]):
        raise AssertionError(f"{label}: sharded vs unsharded {out}")
    return out


def hold_sharded_ensemble(got, want, label, n_rows, n_cols, tol=SHARD_TOL):
    """Ensemble outputs (corr_sum, corr_count, cmax, s2n) of a sharded run against the unsharded kernel's.

    A shard's first frame may be transformed packed with another frame than
    in one launch, so a pair's cmax or s2n may round differently and flip a
    gate where it lies within 1e-5 of ``CORR_MIN`` (1e-4 relative of
    ``S2N_MIN``); any other flip raises. On windows without a flip the counts
    must be equal and corr_sum within ``tol`` of the largest sum (relative);
    cmax and s2n within ``tol`` (s2n relative) on pairs gated alike, and the
    mean-plane displacements within 1e-3 px where the plane's top-2 gap
    exceeds 5e-3 and the count reaches ``COUNT_MIN`` of the pairs.
    """
    import torch

    cs, cc, c_s, s_s = (torch.as_tensor(np.asarray(a)) for a in got)
    sum_k, n_k, c_k, s_k = want
    ok_s, ok_k = c_s > 0, c_k > 0
    flip = ok_s != ok_k
    cm, sn = torch.where(ok_k, c_k, c_s), torch.where(ok_k, s_k, s_s)
    near = ((cm - CORR_MIN).abs() <= 1e-5) | ((sn - S2N_MIN).abs() <= 1e-4 * S2N_MIN)
    if (flip & ~near).any():
        raise AssertionError(f"{label}: {int((flip & ~near).sum())} gate flips away from the thresholds")
    steady = ~flip.flatten(1).any(0)
    d_sum = float((cs - sum_k).abs().flatten(1).amax(1)[steady].max() / sum_k.abs().max())
    same = ~flip & ok_k
    d_cmax = float((c_s - c_k).abs()[same].max())
    rel_s2n = float(((s_s - s_k).abs() / s_k.clamp(min=1.0))[same].max())
    u_s, v_s, _ = _mean_plane_uv(cs, cc, n_rows, n_cols)
    u_k, v_k, gap = _mean_plane_uv(sum_k, n_k, n_rows, n_cols)
    enough = (n_k >= COUNT_MIN * c_k.shape[0]).reshape(gap.shape)
    confident = (gap > 5e-3) & enough & steady.reshape(gap.shape)
    d_uv = float(torch.maximum((u_s - u_k).abs(), (v_s - v_k).abs())[confident].max())
    if not torch.equal(cc[steady], n_k[steady]) or max(d_sum, d_cmax, rel_s2n) > tol or d_uv > 1e-3:
        raise AssertionError(f"{label}: counts differ, or |d sum| {d_sum} rel, |d cmax| {d_cmax}, "
                             f"rel d s2n {rel_s2n}, |d uv| {d_uv} px")
    return {"counts": "equal" if torch.equal(cc, n_k) else "equal on windows without a gate flip",
            "gate_flips": int(flip.sum()), "max_rel_dsum": d_sum, "max_abs_dcmax": d_cmax,
            "max_rel_ds2n": rel_s2n, "max_abs_duv_px": d_uv}


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_together(argvs, folder, device, timeout=300, extra_logs=()):
    """Start every argv at once as a child process (output to ``folder/<i>.out``) and wait for all;
    returns (wall [s], outputs). As soon as one child fails, or after ``timeout`` s, every child still
    running is killed, and this raises with each child's exit code and the end of its output and of
    each file of ``extra_logs`` (a process that waits at a barrier for a failed one would wait on)."""
    env = dict(os.environ, PYORC_TPU_TORCH_DEVICE=str(device))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every process is on this machine
    folder.mkdir(parents=True, exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    with contextlib.ExitStack() as files:
        outs = [files.enter_context(open(folder / f"{i}.out", "w+")) for i in range(len(argvs))]
        try:
            for argv, out in zip(argvs, outs):
                procs.append(subprocess.Popen(argv, cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT))
            while any(p.poll() is None for p in procs):
                if any(p.poll() for p in procs) or time.perf_counter() - t0 > timeout:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        texts = []
        for out in outs:
            out.seek(0)
            texts.append(out.read())
    codes = [p.returncode for p in procs]
    if any(codes):
        report = [f"children exited {codes} after {wall:.1f} s (timeout {timeout} s)"]
        report += [f"--- child {i}: {' '.join(map(str, argv[3:]))}\n{text[-2500:]}"
                   for i, (argv, text) in enumerate(zip(argvs, texts))]
        report += [f"--- {path}\n{Path(path).read_text()[-2500:]}" for path in extra_logs if Path(path).exists()]
        print("\n".join(report), flush=True)
        raise AssertionError(report[0])
    return wall, texts


def multihost_cli(clip, fn_cc, fn_recipe, out, device, n_hosts=2, extra=()):
    """``python3 -m pyorc_tpu_torch.cli.main velocimetry ... --num-hosts N --host-id I --coordinator
    127.0.0.1:<port>`` for every I at once. Each must exit 0 and log its frame range; host 0's manifest
    must be the JAX package's schema for the clip's frame count. Returns (wall [s], each host's log
    text, the manifest)."""
    import shutil

    import cv2

    from pyorc_tpu_torch.parallel import distributed

    shutil.rmtree(out, ignore_errors=True)
    port = _free_port()
    argvs = [
        [sys.executable, "-m", "pyorc_tpu_torch.cli.main", "velocimetry", "-V", str(clip), "-c", str(fn_cc),
         "-r", str(fn_recipe), *extra, "--num-hosts", str(n_hosts), "--host-id", str(i),
         "--coordinator", f"127.0.0.1:{port}", str(out)]
        for i in range(n_hosts)
    ]
    wall, _ = _run_together(argvs, Path(str(out) + "_children"), device,
                            extra_logs=[Path(out) / f"host{i:03d}_pyorc_tpu.log" for i in range(n_hosts)])
    cap = cv2.VideoCapture(str(clip))
    n_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    segs = distributed.segment_frame_ranges(n_frames, n_hosts)
    logs = []
    for i, (s, e) in enumerate(segs):
        text = (Path(out) / f"host{i:03d}_pyorc_tpu.log").read_text()
        if f"Host {i}/{n_hosts}: frames [{s}, {e})" not in text:
            raise AssertionError(f"host {i}'s log names no frame range [{s}, {e}): {text[-2000:]}")
        logs.append(text)
    manifest = json.loads((Path(out) / "manifest.json").read_text())
    want = {"num_processes": n_hosts, "n_frames": n_frames, "segments": {
        str(i): {"start_frame": s, "end_frame": e, "prefix": f"host{i:03d}_", "artifact": f"host{i:03d}_piv.nc"}
        for i, (s, e) in enumerate(segs)
    }}
    if manifest != want:
        raise AssertionError(f"manifest {manifest} is not {want}")
    return wall, logs, manifest


def host_launches(log_text):
    """The kernel launches a ``--num-hosts`` host logged after its pipeline."""
    found = re.search(r"kernel launches (\{.*\})", log_text)
    if not found:
        raise AssertionError("the host logged no kernel launches")
    return json.loads(found.group(1))


def segment_worker(argv):
    """Worker mode, one process of :func:`two_process_segments`:

        python3 chip_smoke.py --segment-worker PID NPROC PORT FRAMES.npy OUTDIR WINDOW DEVICE

    joins the gloo group at 127.0.0.1:PORT, runs the per-pair kernel (``piv_pairs_fused``) at
    WINDOW px, 50 % overlap, on its segment of FRAMES.npy through
    ``distributed.process_segments_multihost`` and writes u, v, cmax, s2n as .npz."""
    import torch

    import pyorc_tpu_torch
    from pyorc_tpu_torch.ops import piv_kernels
    from pyorc_tpu_torch.parallel import distributed

    pid, nproc, port = int(argv[0]), int(argv[1]), argv[2]
    frames_npy, outdir, window, device = argv[3], argv[4], int(argv[5]), argv[6]
    pyorc_tpu_torch.set_device(device)
    got = distributed.init_distributed(f"127.0.0.1:{port}", nproc, pid)
    if got != (pid, nproc):
        raise AssertionError(f"init_distributed gave {got}, not {(pid, nproc)}")
    frames = np.load(frames_npy, mmap_mode="r")
    args = _grid(frames.shape[1:], window)

    def run_segment(start, end, out_path):
        seg = torch.from_numpy(np.array(frames[start:end])).to(device)  # a copy: the memory map is read-only
        out = [o.cpu().numpy() for o in piv_kernels.piv_pairs_fused(seg, *args)]
        with open(out_path, "wb") as f:
            np.savez(f, u=out[0], v=out[1], cmax=out[2], s2n=out[3], launches=piv_kernels.LAUNCHES["piv_pairs"])

    out = distributed.process_segments_multihost(frames.shape[0], run_segment, outdir)
    print(f"segment worker {pid}/{nproc}: {out}", flush=True)
    return 0


def two_process_segments(frames, folder, window, device, n_proc=2):
    """Two processes of :func:`segment_worker` on ``frames`` (a host [T, H, W] stack) at once; their
    segments stitched in pair order. Returns (wall [s], (u, v, cmax, s2n), launches per process, manifest)."""
    import shutil

    folder = Path(folder)
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    np.save(folder / "frames.npy", np.ascontiguousarray(frames))
    port = _free_port()
    argvs = [
        [sys.executable, str(ROOT / "chip_smoke.py"), "--segment-worker", str(i), str(n_proc), str(port),
         str(folder / "frames.npy"), str(folder / "out"), str(window), str(device)]
        for i in range(n_proc)
    ]
    wall, _ = _run_together(argvs, folder / "children", device)
    manifest = json.loads((folder / "out" / "manifest.json").read_text())
    if manifest["num_processes"] != n_proc or manifest["n_frames"] != frames.shape[0]:
        raise AssertionError(f"segments manifest {manifest}")
    parts, launches = [], []
    for i in range(n_proc):
        seg = manifest["segments"][str(i)]
        with np.load(folder / "out" / seg["artifact"]) as z:
            parts.append([z[k] for k in ("u", "v", "cmax", "s2n")])
            launches.append(int(z["launches"]))
        if parts[-1][0].shape[0] != seg["end_frame"] - 1 - seg["start_frame"]:
            raise AssertionError(f"segment {i} holds {parts[-1][0].shape[0]} pairs for frames {seg}")
    stitched = tuple(np.concatenate(column, axis=0) for column in zip(*parts))
    return wall, stitched, launches, manifest


def multidevice_phase(proj, piv26, mp_piv32, ens_proj, device, folder, clip=None, cli_wall=None, raw=None,
                      samples=15):
    """Step 5g: the sharded paths of :mod:`pyorc_tpu_torch.parallel` on the stacks the earlier steps
    hold, each held to the unsharded kernel's result, and (with ``raw``, the camera frames that
    ``normalize(samples)`` and ``project`` made ``proj`` from) the in-memory filters split along time;
    returns (results, walls [ms or s], launches)."""
    from unittest import mock

    import torch

    from pyorc_tpu_torch import _device, parallel
    from pyorc_tpu_torch.api import frames as frames_api
    from pyorc_tpu_torch.ops import piv_kernels

    on_card = torch.device(device).type == "cuda"
    route = "cuda" if on_card else "plain_cpu"
    devices, kind = mesh_devices(device)
    print(f"multi-device mesh: {kind} (torch.cuda.device_count() {torch.cuda.device_count()}); "
          f"{_card_line()}", flush=True)
    mesh = parallel.make_mesh(devices)
    results, walls, launches = {"mesh": kind}, {}, {}

    def unsharded_pairs(frames, args):
        return [o.cpu().numpy() for o in piv_kernels.piv_pairs_fused(frames, *args)]

    frames = torch.as_tensor(np.ascontiguousarray(proj.values)).to(device)
    n_shards = len(parallel.piv._pair_shards(frames.shape[0] - 1, len(devices)))
    for w_px in SHARD_WINDOWS:  # (b) per-pair
        args = _grid(frames.shape[1:], w_px)
        label = f"sharded per-pair {w_px} px"
        want = unsharded_pairs(frames, args)
        got, n = _launched("piv_pairs", lambda: parallel.piv_pairs_sharded(frames, args[1], args[2], mesh=mesh))
        if n != n_shards * on_card or piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] != route:
            raise AssertionError(f"{label}: {n} launches for {n_shards} shards")
        results[label] = hold_sharded(got, want, label, gap=_pairs_gap(frames, args).cpu().numpy())
        launches[label] = n
        walls[label] = {
            "sharded_ms": _wall_ms(lambda: parallel.piv_pairs_sharded(frames, args[1], args[2], mesh=mesh)),
            "unsharded_ms": _wall_ms(lambda: unsharded_pairs(frames, args)),
        }

    dt = np.diff(proj["time"].values)[:, None, None]  # (d) multipass, against step 6's fields
    label = "sharded multipass 32 px x3"
    args = _grid(frames.shape[1:], 32)
    (u, v, _, _), n = _launched("piv_pairs", lambda: parallel.piv_multipass_sharded(
        frames, args[1], args[2], mesh=mesh, passes=3))
    if n != 3 * n_shards * on_card:
        raise AssertionError(f"{label}: {n} launches for 3 passes on {n_shards} shards")
    scale = RES / dt
    got = [(u * scale).astype(np.float32), (v * scale).astype(np.float32)]
    # every pass runs one pair a block (pair_stride 2), however the pairs are split: held on every window
    results[label] = hold_sharded(got, [mp_piv32["v_x"].values, mp_piv32["v_y"].values], label, scale=scale)
    launches[label] = n
    walls[label] = {"sharded_ms": _wall_ms(lambda: parallel.piv_multipass_sharded(
        frames, args[1], args[2], mesh=mesh, passes=3), reps=1)}

    label = f"sharded 2-D {MESH2D} {MESH2D_WINDOW} px"  # (e)
    head = frames[:MESH2D_FRAMES]
    args = _grid(head.shape[1:], MESH2D_WINDOW)
    mesh2d = parallel.piv.Mesh(np.asarray((devices * MESH_SHARDS)[:MESH2D[0] * MESH2D[1]], dtype=object)
                               .reshape(MESH2D), ("pairs", "rows"))
    want = unsharded_pairs(head, args)
    got, n = _launched("piv_pairs", lambda: parallel.piv_pairs_sharded_2d(head, args[1], args[2], mesh=mesh2d))
    if n != MESH2D[0] * MESH2D[1] * on_card:
        raise AssertionError(f"{label}: {n} launches on a {MESH2D} mesh")
    results[label] = hold_sharded(got, want, label, gap=_pairs_gap(head, args).cpu().numpy())
    launches[label] = n
    walls[label] = {
        "sharded_ms": _wall_ms(lambda: parallel.piv_pairs_sharded_2d(head, args[1], args[2], mesh=mesh2d)),
        "unsharded_ms": _wall_ms(lambda: unsharded_pairs(head, args)),
    }

    if raw is not None:  # (h) the in-memory filters: each batch split along time over the shards
        label = "time-sharded normalize -> project"
        splits = {"normalize": [], "project": []}
        real = frames_api._time_sharded

        def counted(op):
            def run(fn, chunk, devs):
                splits[op].append(len(devs))
                return real(fn, chunk, devs)

            return mock.patch.object(frames_api, "_time_sharded", run)

        t0 = time.perf_counter()
        with mock.patch.object(_device, "local_devices", lambda: list(devices)):
            with counted("normalize"):
                norm = raw.frames.normalize(samples=samples)
            with counted("project"):
                got = norm.frames.project()
        sharded_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        raw.frames.normalize(samples=samples).frames.project()
        walls[label] = {"sharded_s": sharded_s, "unsharded_s": time.perf_counter() - t0}
        if not all(len(devices) in n for n in splits.values()):
            raise AssertionError(f"{label}: a filter split no batch over the {len(devices)} shards: {splits}")
        if got.dims != proj.dims or not np.array_equal(got.values, proj.values):
            raise AssertionError(f"{label}: the frames differ from the unsharded ones")
        results[label] = {"frames": "equal", "shards_per_batch": splits}
        del norm, got

    label = "engine route get_piv 26 px"  # (f): the engine's mesh is these shards, here only
    t0 = time.perf_counter()
    with mock.patch.object(_device, "local_devices", lambda: list(devices)):
        run = lambda: proj.frames.get_piv(window_size=25, overlap=(13, 13))  # noqa: E731
        piv, n = _drive(piv_kernels, "piv_pairs", run) if on_card else _launched("piv_pairs", run)
    walls[label] = {"sharded_s": time.perf_counter() - t0}
    if n < n_shards * on_card:
        raise AssertionError(f"{label}: {n} launches for {n_shards} shards")
    names = ("v_x", "v_y", "corr", "s2n")
    results[label] = hold_sharded([piv[k].values for k in names], [piv26[k].values for k in names], label,
                                  gap=_pairs_gap(frames, _grid(frames.shape[1:], 26)).cpu().numpy(), scale=RES / dt)
    launches[label] = n
    del frames, head

    if ens_proj is not None:  # (c) ensemble
        frames = torch.as_tensor(np.ascontiguousarray(ens_proj.values)).to(device)
        args = _grid(frames.shape[1:], ENS_WINDOW)
        label = f"sharded ensemble {ENS_WINDOW} px"
        n_ens_shards = len(parallel.piv._pair_shards(frames.shape[0] - 1, len(devices)))
        want = piv_kernels.piv_ensemble_fused(frames, *args, CORR_MIN, S2N_MIN)
        got, n = _launched("piv_ensemble", lambda: parallel.piv_ensemble_sharded(
            frames, args[1], args[2], mesh=mesh, corr_min=CORR_MIN, s2n_min=S2N_MIN))
        if n != n_ens_shards * on_card or piv_kernels.KERNEL_ROUTE["piv_ensemble_fused"] != route:
            raise AssertionError(f"{label}: {n} launches for {n_ens_shards} shards")
        results[label] = hold_sharded_ensemble(got, [w.cpu() for w in want], label, args[3], args[4])
        launches[label] = n
        walls[label] = {
            "sharded_ms": _wall_ms(lambda: parallel.piv_ensemble_sharded(
                frames, args[1], args[2], mesh=mesh, corr_min=CORR_MIN, s2n_min=S2N_MIN)),
            "unsharded_ms": _wall_ms(lambda: [o.cpu() for o in piv_kernels.piv_ensemble_fused(
                frames, *args, CORR_MIN, S2N_MIN)]),
        }
        del frames, want

    # (g) two processes sharing the card: the CLI, and the segments' velocities
    label = "two processes: segments 26 px"
    frames = torch.as_tensor(np.ascontiguousarray(proj.values)).to(device)
    args = _grid(frames.shape[1:], 26)
    wall, stitched, seg_launches, _ = two_process_segments(proj.values, folder / "multihost_segments", 26, device)
    if min(seg_launches) < on_card:
        raise AssertionError(f"{label}: a process launched no kernel ({seg_launches})")
    results[label] = hold_sharded(stitched, unsharded_pairs(frames, args), label,
                                  gap=_pairs_gap(frames, args).cpu().numpy())
    launches[label] = sum(seg_launches)
    walls[label] = {"two_processes_s": wall, "unsharded_ms": _wall_ms(lambda: unsharded_pairs(frames, args))}
    del frames
    if clip is not None:
        label = "two processes: CLI --num-hosts 2"
        wall, logs, manifest = multihost_cli(clip, folder / "camera_config.json", folder / "recipe.yml",
                                             folder / "multihost_out", device, extra=("-h", str(H_A), "--cross",
                                             str(folder / "cross_section.geojson")))
        host = [host_launches(text)["piv_pairs"] for text in logs]
        if min(host) < on_card:
            raise AssertionError(f"{label}: a host launched no per-pair kernel ({host})")
        results[label] = {"segments": {k: [v["start_frame"], v["end_frame"]] for k, v in manifest["segments"].items()},
                          "launches_per_host": host}
        launches[label] = sum(host)
        walls[label] = {"two_processes_s": wall, "one_process_cli_s": cli_wall}
    else:
        print("two-process CLI not run: no lossless clip (see step 5c)")
    return results, walls, launches


def _card_line():
    """The card's name and power limit as ``nvidia-smi`` gives them ("nvidia-smi absent" without it)."""
    import shutil

    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi absent"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _print_card(torch):
    print(_card_line())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)


def _drive(piv_kernels, kernel, run):
    """Run one main path with every launch count at 0; returns (its result, the kernel's launches).

    Every call of the engine's entry point (``piv_pairs_routed`` or
    ``piv_ensemble_routed``) in the run must have taken the CUDA kernel."""
    from unittest import mock

    routed = getattr(piv_kernels, f"{kernel}_routed")
    routes = []

    def recorded(*args, **kwargs):
        out = routed(*args, **kwargs)
        routes.append(piv_kernels.KERNEL_ROUTE.get(f"{kernel}_fused"))
        return out

    for name in piv_kernels.LAUNCHES:
        piv_kernels.LAUNCHES[name] = 0
    with mock.patch.object(piv_kernels, f"{kernel}_routed", recorded):
        out = run()
    launches = piv_kernels.LAUNCHES[kernel]
    if launches <= 0 or not routes or set(routes) != {"cuda"}:
        raise AssertionError(f"main path did not run the {kernel} CUDA kernel (launches={launches}, routes={routes})")
    return out, launches


def main(argv) -> int:
    import torch

    if argv[:1] == ["--segment-worker"]:
        return segment_worker(argv[1:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU.", file=sys.stderr)
        return 1
    from pyorc_tpu_torch.ops import piv_kernels

    _print_card(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda"

    t0 = time.perf_counter()
    lib = piv_kernels.build_library()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s -> {lib.relative_to(ROOT)}")
    log_file = lib.with_suffix(".log")
    if log_file.exists():
        print(log_file.read_text().strip())
    probe = decoder_probe()
    print("decoder_probe " + json.dumps(probe), flush=True)

    if "--profile" in argv:
        stages, spans = profile_slice(device, (1080, 1920, 126), (*ENS_SHAPE, ENS_FRAMES))
        for name, row in stages.items():
            row.update({f"{k}_bytes": v for k, v in MOVED.get(name, {}).items()})
        (ROOT / "build").mkdir(exist_ok=True)
        profile = {"stages": stages, "lazy_spans": spans}
        (ROOT / "build" / "profile_slice.json").write_text(json.dumps(profile, indent=1))
        for name, row in stages.items():
            print(f"profile {name}: wall {row['wall_ms']:.1f} ms, device {row['device_ms']:.1f} ms "
                  f"(copies {row['copy_ms']:.1f} ms), idle {row['idle']:.3f}, "
                  f"bytes up {row.get('h2d_bytes')}, down {row.get('d2h_bytes')}")
        spans = {k: {m: round(x, 3) for m, x in r.items()} for k, r in spans.items()}
        print("profile lazy chain spans (host ms, calls; the prefetch thread's): "
              + (json.dumps(spans) if spans else "none recorded"))
        return 0

    kern = kernel_phase(device)
    ens_kern = ensemble_kernel_phase(device)
    if "--kernels-only" in argv:
        return 0

    stack = advected_stack(1080, 1920, 126, device)
    t0 = time.perf_counter()
    (results, times, proj, pivs), pairs_launches = _drive(
        piv_kernels, "piv_pairs", lambda: slice_phase(1080, 1920, 126, device, stack=stack)
    )
    wall = time.perf_counter() - t0
    print(f"slice 1920x1080x126: wall {wall:.3f} s; stages " + json.dumps({k: round(v, 4) for k, v in times.items()}))
    print("slice results " + json.dumps(results))
    main_errs = main_path_check(proj, pivs, device)

    t0 = time.perf_counter()
    (lazy_results, _, lazy_rows, _), lazy_launches = _drive(
        piv_kernels, "piv_pairs", lambda: lazy_phase(stack, nadir_camera_config(1080, 1920), pivs, device)
    )
    wall = time.perf_counter() - t0
    print(f"lazy chain 1920x1080x126 from a host frame source: wall {wall:.3f} s; {lazy_launches} launches; "
          "stages " + json.dumps(lazy_rows))
    print("lazy chain results " + json.dumps(lazy_results), flush=True)
    video_launches = service_launches = outputs_launches = 0
    clip = cli_wall = None
    if probe.get("cv2_video_io") == "FFV1 round trip exact":
        clip = write_clip(stack, ROOT / "build" / "smoke_1080p.avi")
        t0 = time.perf_counter()
        (video_results, _, video_rows, _), video_launches = _drive(
            piv_kernels, "piv_pairs",
            lambda: lazy_phase(stack, nadir_camera_config(1080, 1920), {16: pivs[16]}, device, tag="video",
                               video_file=clip),
        )
        wall = time.perf_counter() - t0
        print(f"video chain: pyorc_tpu_torch.Video on a lossless FFV1 clip of that stack (OpenCV decode): wall "
              f"{wall:.3f} s; {video_launches} launches; stages " + json.dumps(video_rows))
        print("video chain results " + json.dumps(video_results), flush=True)

        t0 = time.perf_counter()
        (svc_results, svc_walls), service_launches = _drive(
            piv_kernels, "piv_pairs",
            lambda: service_phase(clip, nadir_camera_config(1080, 1920), ROOT / "build", device),
        )
        wall = time.perf_counter() - t0
        print(f"service in-process on that clip (normalize -> project -> get_piv({SERVICE_WINDOW}) at the default "
              f"overlap -> corr mask -> transect, get_q, get_river_flow): wall {wall:.3f} s; {service_launches} "
              "launches; stage walls [s] from its log " + json.dumps(svc_walls))
        print("service results " + json.dumps(svc_results), flush=True)
        cli_wall, cli_walls = cli_phase(clip, ROOT / "build", device)
        print(f"CLI (python3 -m pyorc_tpu_torch.cli.main velocimetry ... build/service_out) on that clip: exit 0, "
              f"wall {cli_wall:.3f} s; stage walls [s] from its log " + json.dumps(cli_walls), flush=True)

        t0 = time.perf_counter()
        (out_results, out_rows, out_walls), outputs_launches = _drive(
            piv_kernels, "piv_pairs",
            lambda: outputs_phase(clip, stack, nadir_camera_config(1080, 1920), ROOT / "build", device),
        )
        wall = time.perf_counter() - t0
        print(f"recipe outputs on that clip (step 5d's recipe + frames.to_video FFV1 .avi + frames.to_geotiff "
              f"frame 0; parse_geotiff; to_ugrid): wall {wall:.3f} s; {outputs_launches} launches; stage walls [s] "
              f"from its log " + json.dumps(out_walls))
        print("recipe outputs per new stage (wall_s, bytes h2d / d2h) " + json.dumps(out_rows))
        print("recipe outputs results " + json.dumps(out_results), flush=True)
        wl = water_level_phase(ROOT / "build", device)
        print("optical water level on a 1920x1080 FFV1 clip of the Geul scene (service.get_water_level): "
              + json.dumps(wl), flush=True)
    else:
        why = probe.get("cv2_video_io", probe["cv2"])
        print(f"video chain, service, CLI, recipe outputs and optical water level not run: OpenCV cannot "
              f"round-trip a lossless clip here ({why})")
    print(host_only_outputs(), flush=True)
    piv26 = pivs[26]  # for step 5g
    del pivs  # the stack stays for step 5g (h)

    t0 = time.perf_counter()
    (mp_results, mp_times, mp_pivs), mp_launches = _drive(
        piv_kernels, "piv_pairs", lambda: multipass_phase(proj, 1080, 1920)
    )
    wall = time.perf_counter() - t0
    for w_px, res in mp_results.items():
        if res["launches"] <= 0 or res["launches"] % res["passes"]:
            raise AssertionError(f"multipass {w_px} px: {res['launches']} kernel launches for {res['passes']} passes")
    print(f"multipass slice on the projected stack: wall {wall:.3f} s; {mp_launches} launches; stages "
          + json.dumps({k: round(v, 4) for k, v in mp_times.items()}))
    print("multipass slice results " + json.dumps(mp_results))
    print("single-pass slice results beside them " + json.dumps(results))
    mp_main = {w_px: multipass_main_path_check(proj, mp_pivs[w_px], device, w_px) for w_px in mp_pivs}
    mp_piv32 = mp_pivs[32]  # for step 5g
    del mp_pivs

    t0 = time.perf_counter()
    (ns_results, ns_times, ns_piv), ns_launches = _drive(
        piv_kernels, "piv_pairs", lambda: non_square_phase(proj, 1080, 1920)
    )
    wall = time.perf_counter() - t0
    print(f"non-square slice {_fmt(NS_WINDOW)} px on the projected stack: wall {wall:.3f} s; {ns_launches} launches; "
          "stages " + json.dumps({k: round(v, 4) for k, v in ns_times.items()}))
    print("non-square slice results " + json.dumps(ns_results))
    ns_main = main_path_check(proj, {NS_WINDOW: ns_piv}, device)[NS_WINDOW]
    del ns_piv

    t0 = time.perf_counter()
    flt_results, flt_times = filters_phase(proj, 1080, 1920, device)
    wall = time.perf_counter() - t0
    print(f"filters phase on the projected stack {tuple(proj.shape)} and {RGB_FRAMES} RGB frames 1920x1080 "
          f"(card against the port on the CPU): wall {wall:.3f} s; stages "
          + json.dumps({k: round(v, 4) for k, v in flt_times.items()}))
    print("filters results " + json.dumps(flt_results), flush=True)

    t0 = time.perf_counter()
    with _profiler(device) as prof:
        stiv_results, stiv_times = stiv_phase(proj, 1080, 1920)
    wall = time.perf_counter() - t0
    print(f"STIV phase on the projected stack: wall {wall:.3f} s; stages [ms] "
          + json.dumps({k: {m: round(x, 3) for m, x in row.items()} for k, row in _stage_rows(prof, stiv_times).items()}))
    print("STIV results " + json.dumps(stiv_results), flush=True)
    del prof

    h, w = ENS_SHAPE
    ens_stack = advected_stack(h, w, ENS_FRAMES, device)
    t0 = time.perf_counter()
    (ens_results, ens_times, ens_proj, ens_piv), ens_launches = _drive(
        piv_kernels, "piv_ensemble", lambda: ensemble_slice_phase(h, w, ENS_FRAMES, device, stack=ens_stack)
    )
    wall = time.perf_counter() - t0
    print(f"ensemble slice {w}x{h}x{ENS_FRAMES}: wall {wall:.3f} s; {ens_launches} launches; stages "
          + json.dumps({k: round(v, 4) for k, v in ens_times.items()}))
    print("ensemble slice results " + json.dumps(ens_results))
    ens_main = ensemble_main_path_check(ens_proj, ens_piv, device)

    t0 = time.perf_counter()
    ens_cc = nadir_camera_config(h, w, window_size=ENS_WINDOW, **ENS_CAMERA)
    (lazy_ens_results, _, lazy_ens_rows, lazy_ens_proj), lazy_ens_launches = _drive(
        piv_kernels, "piv_ensemble",
        lambda: lazy_phase(ens_stack, ens_cc, {ENS_WINDOW: ens_piv}, device, fps=ENS_FPS, ensemble=True,
                           aoi_px=ENS_CAMERA["aoi_px"], tag="lazy ens"),
    )
    wall = time.perf_counter() - t0
    print(f"lazy ensemble chain {w}x{h}x{ENS_FRAMES} from a host frame source: wall {wall:.3f} s; "
          f"{lazy_ens_launches} launches; stages " + json.dumps(lazy_ens_rows))
    print("lazy ensemble chain results " + json.dumps(lazy_ens_results), flush=True)
    del ens_piv
    designs = upload_designs(ens_stack, device, port=lazy_ens_proj.data)
    del lazy_ens_proj
    print(f"lazy 4K normalize -> project, whole frames up with the extrema on the card against the JAX package's "
          f"host extrema and cropped upload (same frames out): {json.dumps(designs)}", flush=True)
    del ens_stack
    print(f"torch.fft.rfft2 + irfft2 alone over the {ENS_WINDOW} px windows of that stack "
          f"(context, not the kernel's contract): {fft_alone_ms(ens_proj, device):.3f} ms", flush=True)

    t0 = time.perf_counter()
    (wide_results, wide_times, wide_piv), wide_launches = _drive(
        piv_kernels, "piv_ensemble", lambda: wide_ensemble_phase(ens_proj, h, w)
    )
    wall = time.perf_counter() - t0
    print(f"wide ensemble slice {ENS_WIDE_WINDOW} px on the projected 4K stack: wall {wall:.3f} s; "
          f"{wide_launches} launches; stages " + json.dumps({k: round(v, 4) for k, v in wide_times.items()}))
    print("wide ensemble slice results " + json.dumps(wide_results))
    wide_main = ensemble_main_path_check(ens_proj, wide_piv, device, ENS_WIDE_WINDOW)
    del wide_piv

    t0 = time.perf_counter()
    md_results, md_walls, md_launches = multidevice_phase(
        proj, piv26, mp_piv32, ens_proj, device, ROOT / "build", clip=clip, cli_wall=cli_wall,
        raw=frames_dataarray(stack, nadir_camera_config(1080, 1920)),
    )
    print(f"multi-device step 5g: wall {time.perf_counter() - t0:.3f} s; launches " + json.dumps(md_launches))
    print("multi-device walls (virtual shards of one card run one after another: the split's cost, not a "
          "speed-up) " + json.dumps(md_walls))
    print("multi-device results " + json.dumps(md_results), flush=True)
    if clip is not None:
        clip.unlink()
    del ens_proj, proj, piv26, mp_piv32, stack
    md_pairs = sum(n for k, n in md_launches.items() if "ensemble" not in k)
    md_ens = sum(n for k, n in md_launches.items() if "ensemble" in k)

    main_size = 16
    coarse = mp_main[32]["passes"][0]  # the 128 px pass
    ns = _fmt(NS_WINDOW)
    record = {"kernels": [
        {
            "name": "piv_pairs", "route": "cuda", "source": "pyorc_tpu_torch/csrc/piv_pairs.cu",
            "replaces": "pyorc_tpu/ops/piv_pallas.py:957",
            "launches": pairs_launches + mp_launches + ns_launches + lazy_launches + video_launches + service_launches
            + outputs_launches + md_pairs,
            "max_abs_err": max(
                e["max_abs_duv_px"] for e in [*kern.values(), *main_errs.values(), *mp_main.values(), ns_main]
            ),
            "ms": main_errs[main_size]["ms"], "plain_ms": main_errs[main_size]["plain_ms"],
            "bound_ms": main_errs[main_size]["bound_ms"], "bound_by": main_errs[main_size]["bound_by"],
            "library_ms": None,
            "multipass_launches": mp_launches, "ms_128px": coarse["ms"], "plain_ms_128px": coarse["plain_ms"],
            "bound_ms_128px": coarse["bound_ms"], "bound_by_128px": coarse["bound_by"],
            f"launches_{ns}px": ns_launches, f"ms_{ns}px": ns_main["ms"], f"plain_ms_{ns}px": ns_main["plain_ms"],
            f"bound_ms_{ns}px": ns_main["bound_ms"], f"bound_by_{ns}px": ns_main["bound_by"],
            "launches_lazy": lazy_launches, "launches_video": video_launches, "launches_service": service_launches,
            "launches_outputs": outputs_launches, "launches_multidevice": md_pairs,
        },
        {
            "name": "piv_ensemble", "route": "cuda", "source": "pyorc_tpu_torch/csrc/piv_ensemble.cu",
            "replaces": "pyorc_tpu/ops/piv_pallas.py:1297",
            "launches": ens_launches + wide_launches + lazy_ens_launches + md_ens, "launches_lazy": lazy_ens_launches,
            "launches_multidevice": md_ens,
            "max_abs_err": max(e["max_abs_duv_px"] for e in [*ens_kern.values(), ens_main, wide_main]),
            "ms": ens_main["ms"], "plain_ms": ens_main["plain_ms"],
            "bound_ms": ens_main["bound_ms"], "bound_by": ens_main["bound_by"], "library_ms": None,
            f"launches_{ENS_WIDE_WINDOW}px": wide_launches, f"ms_{ENS_WIDE_WINDOW}px": wide_main["ms"],
            f"plain_ms_{ENS_WIDE_WINDOW}px": wide_main["plain_ms"],
            f"bound_ms_{ENS_WIDE_WINDOW}px": wide_main["bound_ms"],
            f"bound_by_{ENS_WIDE_WINDOW}px": wide_main["bound_by"],
        },
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
