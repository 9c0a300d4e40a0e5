#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``pyorc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi``), the torch and CUDA versions, and builds
   the CUDA kernel from ``pyorc_tpu_torch/csrc/`` into ``build/``.
2. Kernel phase: particle frames of 1088x1920, 9 frames with a known
   sub-pixel shift, at 16, 26 and 64 px windows. The kernel is held against
   its plain PyTorch version on the card and both are timed (CUDA events,
   median of 10 runs after warm-up).
3. Slice phase, at the geul recipe's scale: a 1920x1080, 126-frame
   in-memory stack advected (2.3, -1.4) px/frame through normalize ->
   project -> get_piv (16 and 26 px) -> mask -> get_transect -> get_q ->
   get_river_flow, checked against the analytic velocity and discharge.
   The kernel's launches in this run are counted.
4. Main-path kernel check: the projected stack the slice gave the kernel is
   run through the kernel and its plain version again, at the slice's window
   grids, and the two are held to each other; the kernel's output must also
   be the velocity field the slice produced.
5. Prints one JSON line about the kernel, then the last line
   ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --profile

instead runs the slice once under ``torch.profiler`` and prints, per stage,
the wall time, the device's busy time (kernels and copies) and its idle
share; the raw per-stage numbers go to ``build/profile_slice.json``.

Every phase raises on failure. Without CUDA, or without the package beside
it, the script exits with an error and prints no result. The functions
below also run on the CPU at small sizes, which is how the test suite
rehearses the slice without a card.
"""

from __future__ import annotations

import contextlib
import json
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
KERNEL_SIZES = (16, 26, 64)
SLICE_WINDOWS = (15, 25)  # recipe window sizes; rounded to 16 and 26 px, run at 50 % overlap
# Tolerances against the analytic truth. Two effects bias the medians low
# (check_chain): on this input about 6 % (16 px) and 4 % (26 px) in v_x.
VEL_TOL = {16: 0.03, 26: 0.02}  # median velocity [m/s], as tests/test_velocity_parity.py:136
Q_TOL = 0.10  # relative, median discharge against 0.9 * v_perp * wetted area


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


def nadir_camera_config(h, w):
    """Overhead camera, no distortion, RES m/px at z=0; AOI 100 px inside the frame."""
    from pyorc_tpu_torch import CameraConfig

    f = 1000.0
    src = [[60, 60], [w - 60, 60], [w - 60, h - 60], [60, h - 60]]
    dst = [[RES * c, RES * (h - r)] for c, r in src]
    cc = CameraConfig(
        height=h,
        width=w,
        resolution=RES,
        window_size=32,
        gcps={"src": src, "dst": dst, "h_ref": 0.0, "z_0": 0.0},
        camera_matrix=[[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]],
        dist_coeffs=[[0.0]] * 5,
        stabilize=None,
    )
    cc.set_bbox_from_corners([[100, 100], [w - 100, 100], [w - 100, h - 100], [100, h - 100]])
    return cc


def frames_dataarray(stack, cc, pkg=None):
    """The in-memory frame stack as ``Video.get_frames`` builds it, as an
    ``ndx.DataArray`` of ``pkg`` (default ``pyorc_tpu_torch``; the tests pass
    the JAX package to build its twin)."""
    if pkg is None:
        import pyorc_tpu_torch as pkg

    n, h, w = stack.shape
    y = np.flipud(np.arange(h)).astype(np.float64)
    x = np.arange(w).astype(np.float64)
    xp, yp = np.meshgrid(x, y)
    coords = {"time": np.arange(n) / FPS, "y": y, "x": x}
    attrs = {
        "camera_shape": str([h, w]),
        "camera_config": cc.to_json(),
        "h_a": json.dumps(H_A),
    }
    da = pkg.ndx.DataArray(stack, dims=("time", "y", "x"), coords=coords, attrs=attrs, name="frames")
    da = da.frames.add_xy_coords({"xp": xp, "yp": yp}, coords, pkg.const.PERSPECTIVE_ATTRS)
    da.name = "frames"
    return da


def expected_velocity(cc):
    """Analytic (v_x, v_y) [m/s]: a displaced pixel pair unprojected to the water plane."""
    p0 = np.array([[cc.width / 2, cc.height / 2]])
    p1 = p0 + np.array([SHIFT])
    w0 = cc.unproject_points(p0, zs=0.0)[0]
    w1 = cc.unproject_points(p1, zs=0.0)[0]
    return (w1[0] - w0[0]) * FPS, (w1[1] - w0[1]) * FPS


def transect_points(cc, n_points=25, margin_px=64):
    """A cross-section across the flow, left bank (+y) to right bank, over a parabolic bed.

    Every point lies at least ``margin_px`` inside the AOI; the bed rises
    0.1 m above the water level at both banks and is 1.4 m deep mid-channel.
    """
    h, w = cc.height, cc.width
    x_mid = RES * w / 2
    y_top = RES * (h - 100 - margin_px)
    y_bot = RES * (100 + margin_px)
    y = np.linspace(y_top, y_bot, n_points)
    x = np.full(n_points, x_mid)
    t = np.linspace(-1.0, 1.0, n_points)
    z = 0.1 - 1.5 * (1.0 - t**2)
    return x, y, z


@contextlib.contextmanager
def _stage(times, name):
    """Time a stage into ``times[name]`` and mark it for ``torch.profiler``."""
    import torch

    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    times[name] = time.perf_counter() - t0


def run_chain(frames_proj, window_size, cc, times, tag=""):
    """get_piv at 50 % overlap -> mask -> get_transect -> get_q -> get_river_flow.

    Returns the PIV (before masking) and discharge datasets; the stage
    times go into ``times`` under their names plus ``tag``.
    """
    w_px = window_size + window_size % 2
    with _stage(times, "get_piv" + tag):
        piv = frames_proj.frames.get_piv(window_size=window_size, overlap=(w_px // 2, w_px // 2))
    with _stage(times, "mask" + tag):
        masks = [
            piv.velocimetry.mask.minmax(),
            piv.velocimetry.mask.corr(),
            piv.velocimetry.mask.count(),
        ]
        piv_masked = piv.velocimetry.mask(masks)
    with _stage(times, "transect_q_flow" + tag):
        transect = piv_masked.velocimetry.get_transect(*transect_points(cc))
        q = transect.transect.get_q(fill_method="interpolate")
        q.transect.get_river_flow()
    return piv, q


def check_chain(piv, q, cc, w_px):
    """Check one window size's chain against the analytic truth; returns the numbers checked.

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
    vx_true, vy_true = expected_velocity(cc)
    for name in ("v_x", "v_y", "corr", "s2n"):
        if piv[name].values.shape != piv["v_x"].values.shape or piv[name].values.ndim != 3:
            raise AssertionError(f"{name}: unexpected shape {piv[name].values.shape}")
    vx = float(np.nanmedian(piv["v_x"].values))
    vy = float(np.nanmedian(piv["v_y"].values))
    tol = VEL_TOL[w_px]
    if not (abs(vx - vx_true) < tol and abs(vy - vy_true) < tol):
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


def slice_phase(h, w, n_frames, device):
    """Drive the port's main path.

    Returns (per-window results, stage times, projected frames, per-window
    PIV datasets before masking).
    """
    import pyorc_tpu_torch

    pyorc_tpu_torch.set_device(device)
    cc = nadir_camera_config(h, w)
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


def compare_kernel(frames, args, label, piece=25):
    """The kernel against its plain version on the same frames; returns (kernel outputs, errors).

    The kernel runs in one launch over all of ``frames``, as the engine calls
    it; the plain version runs ``piece`` pairs at a time to bound its memory.
    ``args`` are ``(dim_size, sas, overlap, n_rows, n_cols)``. Raises unless
    the NaN masks are equal, |d cmax| <= 1e-4, s2n agrees to 1e-3 relative
    and |d u|, |d v| <= 1e-3 px on windows whose top-2 peak gap exceeds 5e-3.
    """
    import torch

    from pyorc_tpu_torch.ops import piv as piv_ops
    from pyorc_tpu_torch.ops import piv_kernels

    kern = piv_kernels.piv_pairs_fused(frames, *args)
    if piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] != "cuda":
        raise AssertionError("piv_pairs_fused did not take the CUDA kernel")
    pieces, gaps = [], []
    for start in range(0, frames.shape[0] - 1, piece):
        sub = frames[start : start + piece + 1]
        pieces.append(piv_kernels.piv_pairs_fused_plain(sub, *args))
        gaps.append(piv_ops.top2_gap(sub, *args[:3]))
    plain = [torch.cat(p) for p in zip(*pieces)]
    u_k, v_k, c_k, s_k = kern
    u_p, v_p, c_p, s_p = plain
    for name, a, b in (("u", u_k, u_p), ("v", v_k, v_p), ("cmax", c_k, c_p), ("s2n", s_k, s_p)):
        if a.shape != b.shape or not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"{label} {name}: shapes or NaN masks differ")
    d_cmax = float(torch.nan_to_num((c_k - c_p).abs()).max())
    rel_s2n = float(torch.nan_to_num((s_k - s_p).abs() / s_p.abs().clamp(min=1e-6)).max())
    confident = (torch.cat(gaps).reshape(u_p.shape) > 5e-3) & ~torch.isnan(u_p)
    d_uv = float(torch.maximum((u_k - u_p).abs(), (v_k - v_p).abs())[confident].max())
    if d_cmax > 1e-4 or rel_s2n > 1e-3 or d_uv > 1e-3:
        raise AssertionError(f"{label}: kernel vs plain |dcmax|={d_cmax} rel ds2n={rel_s2n} |duv|={d_uv}")
    errors = {
        "n_pairs": u_k.shape[0], "n_windows": u_k.shape[1] * u_k.shape[2],
        "max_abs_dcmax": d_cmax, "max_rel_ds2n": rel_s2n, "max_abs_duv_px": d_uv,
        "confident_share": float(confident.float().mean()),
    }
    return kern, errors


def _grid(dim_size, w_px):
    """(dim_size, sas, overlap, n_rows, n_cols) of square w_px windows at 50 % overlap."""
    from pyorc_tpu_torch.ops import windows as win

    sas, overlap = (w_px, w_px), (w_px // 2, w_px // 2)
    return (tuple(dim_size), sas, overlap, *win.get_field_shape(dim_size, sas, overlap))


def kernel_phase(device):
    """Kernel vs plain version on the card at 16/26/64 px, both timed; returns per-size numbers."""
    import torch

    from pyorc_tpu_torch.ops import piv_kernels

    h, w, n_frames = 1088, 1920, 9
    frames = torch.as_tensor(advected_stack(h, w, n_frames, device), device=device)
    out = {}
    for size in KERNEL_SIZES:
        args = _grid((h, w), size)
        _, out[size] = compare_kernel(frames, args, f"kernel phase {size} px")
        out[size]["ms"] = _median_ms(lambda: piv_kernels.piv_pairs_fused(frames, *args))
        out[size]["plain_ms"] = _median_ms(lambda: piv_kernels.piv_pairs_fused_plain(frames, *args))
        print(f"kernel {size} px: {json.dumps(out[size])}", flush=True)
    return out


def main_path_check(proj, pivs, device):
    """The kernel against its plain version on the stack and grids the slice gave it.

    Also checks that the slice's (unmasked) velocities are the kernel's
    displacements scaled by the resolution and the frame interval.
    """
    import torch

    frames = torch.as_tensor(np.ascontiguousarray(proj.values)).to(device)
    dt = np.diff(proj["time"].values)[:, None, None]
    out = {}
    for w_px, piv in pivs.items():
        args = _grid(frames.shape[1:], w_px)
        label = f"main path {w_px} px"
        (u, v, _, _), out[w_px] = compare_kernel(frames, args, label)
        for name, disp in (("v_x", u), ("v_y", v)):
            want = (disp.cpu().numpy() * RES / dt).astype(np.float32)
            np.testing.assert_allclose(piv[name].values, want, rtol=1e-6, atol=0, err_msg=f"{label} {name}")
        print(f"{label} ({tuple(frames.shape)} uint8): {json.dumps(out[w_px])}", flush=True)
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


def profile_slice(h, w, n_frames, device):
    """Run the slice under ``torch.profiler``; returns per-stage times [ms] and idle share.

    A stage's device time is the union of the device events (kernels and
    copies) that fall inside its host time range; every stage ends with a
    copy to the host, so its device work finishes inside that range.
    ``copy_ms`` is the part spent in host<->device copies.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        _, times, _, _ = slice_phase(h, w, n_frames, device)
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


def _print_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)


def main(argv) -> int:
    import torch

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

    if "--profile" in argv:
        stages = profile_slice(1080, 1920, 126, device)
        (ROOT / "build").mkdir(exist_ok=True)
        (ROOT / "build" / "profile_slice.json").write_text(json.dumps(stages, indent=1))
        for name, row in stages.items():
            print(f"profile {name}: wall {row['wall_ms']:.1f} ms, device {row['device_ms']:.1f} ms "
                  f"(copies {row['copy_ms']:.1f} ms), idle {row['idle']:.3f}")
        return 0

    kern = kernel_phase(device)

    piv_kernels.LAUNCHES = 0
    t0 = time.perf_counter()
    results, times, proj, pivs = slice_phase(1080, 1920, 126, device)
    wall = time.perf_counter() - t0
    launches = piv_kernels.LAUNCHES
    if launches <= 0 or piv_kernels.KERNEL_ROUTE.get("piv_pairs_fused") != "cuda":
        raise AssertionError(f"main path did not run the CUDA kernel (launches={launches})")
    print(f"slice 1920x1080x126: wall {wall:.3f} s; stages " + json.dumps({k: round(v, 4) for k, v in times.items()}))
    print("slice results " + json.dumps(results))

    main_errs = main_path_check(proj, pivs, device)

    main_size = 16
    record = {
        "kernels": [{
            "name": "piv_pairs",
            "route": "cuda",
            "source": "pyorc_tpu_torch/csrc/piv_pairs.cu",
            "replaces": "pyorc_tpu/ops/piv_pallas.py:957",
            "launches": launches,
            "max_abs_err": max(e["max_abs_duv_px"] for e in [*kern.values(), *main_errs.values()]),
            "ms": kern[main_size]["ms"],
            "plain_ms": kern[main_size]["plain_ms"],
        }]
    }
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
