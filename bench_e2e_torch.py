"""End-to-end benchmark of the PyTorch/CUDA port: decode -> orthorectify -> ensemble PIV -> discharge.

The port's counterpart of ``bench_e2e.py``: the headline workload of
BASELINE.md, a 4K@30fps river video through the whole pipeline of
``pyorc_tpu_torch`` on ONE card, with the decode probe beside it (the lazy
frame chain decodes, uploads and runs normalize and project in its prefetch
thread while the ensemble kernel runs on the card).

The clip is synthesized once (``bench_e2e.py``'s particle texture with its
seed, advected at a known speed by a Fourier shift on the card) and cached
under ``build/``, written
then renamed so that an interrupted render leaves no truncated clip. It is
lossless FFV1 through OpenCV: the native H.264 writer needs FFmpeg's headers,
which a card's machine may lack. The line carries the card (``nvidia-smi``'s
name and power limit) and the median surface speed against the analytic
``hypot(DX_PIX, DY_PIX) * RES * FPS``, which must lie within 5 % (the
ensemble's bar), so that a fast wrong answer shows: the script exits 1 when
it does not.

    python3 bench_e2e_torch.py                 # the headline: 60 s of 4K
    python3 bench_e2e_torch.py --seconds 2 --samples 30
    python3 bench_e2e_torch.py --device cpu --seconds 0.5 --size 768x432 --samples 15   # plain versions, tiny

normalize's mean of ``--samples`` frames (8, as ``bench_e2e.py``) is the
moving texture's background only when the samples lie far apart: on a 2 s
cut, 8 samples 8 frames apart keep a static copy of the texture that pulls
the ensemble's peak toward zero (9 % low, against 3 % without normalize, on
the CPU at 768x432), so a short cut takes more samples.

Prints ONE JSON line. It imports ``pyorc_tpu_torch`` and never JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
W_IMG, H_IMG = 3840, 2160
FPS = 30.0
RES = 0.01  # m/px at the water plane
DX_PIX, DY_PIX = 1.8, -0.9  # px/frame advection -> |v| ~ 0.6 m/s
SPEED_RTOL = 0.05  # the median surface speed against the analytic one (the ensemble's bar)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or why there is none."""
    import shutil

    if shutil.which("nvidia-smi") is None:
        return "no card: nvidia-smi absent"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "no card"


def render_frames(n_frames: int, height: int = H_IMG, width: int = W_IMG, device="cpu"):
    """Yield the advecting particle frames (uint8 [height, width]).

    ``bench_e2e.synth_clip``'s texture (its seed, particle density and blur),
    moved (DX_PIX, DY_PIX) px a frame by a Fourier shift on ``device``: exact
    sub-pixel motion, where a bilinear slide would blur each frame by its own
    fractional offset and bias the measured speed low.
    """
    import torch
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(11)
    n_particles = int(height * width * 0.006)
    img = np.zeros((height, width), np.float32)
    xs = rng.uniform(0, width - 1, n_particles)
    ys = rng.uniform(0, height - 1, n_particles)
    np.add.at(img, (ys.astype(int), xs.astype(int)), rng.uniform(0.5, 1.0, n_particles))
    img = gaussian_filter(img, 1.2, mode="wrap")
    img = img / img.max() * 235 + 15
    spec = torch.fft.rfft2(torch.as_tensor(img, dtype=torch.float64, device=device))
    fy = torch.fft.fftfreq(height, dtype=torch.float64, device=device)[:, None]
    fx = torch.fft.rfftfreq(width, dtype=torch.float64, device=device)[None, :]
    for i in range(n_frames):
        phase = torch.exp(-2j * np.pi * (fy * DY_PIX * i + fx * DX_PIX * i))
        frame = torch.fft.irfft2(spec * phase, s=(height, width))
        yield frame.clamp(0, 255).to(torch.uint8).cpu().numpy()


def synth_clip(path: Path, n_frames: int, height: int = H_IMG, width: int = W_IMG, device="cpu") -> float:
    """Render the clip and write it as lossless FFV1 (OpenCV) to ``path``; returns seconds."""
    import cv2

    t0 = time.perf_counter()
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"FFV1"), FPS, (width, height), isColor=False)
    if not out.isOpened():
        raise RuntimeError(f"OpenCV cannot write FFV1 to {path}")
    try:
        for frame in render_frames(n_frames, height, width, device):
            out.write(np.ascontiguousarray(frame))
    finally:
        out.release()
    return time.perf_counter() - t0


def nadir_config(height: int = H_IMG, width: int = W_IMG, window_size: int = 64):
    """``bench_e2e.nadir_config``'s nadir camera as the port's ``CameraConfig``; other frame
    sizes scale its control points and AOI with the frame (the 4K default is that camera)."""
    import pyorc_tpu_torch

    sy, sx = height / H_IMG, width / W_IMG
    f = 6000.0 * sx
    src = [[200 * sx, 200 * sy], [3640 * sx, 200 * sy], [3640 * sx, 1960 * sy], [200 * sx, 1960 * sy]]
    dst = [[RES * c, RES * (height - r)] for c, r in src]
    cc = pyorc_tpu_torch.CameraConfig(
        height=height,
        width=width,
        resolution=RES,
        window_size=window_size,
        gcps={"src": src, "dst": dst, "h_ref": 0.0, "z_0": 0.0},
        camera_matrix=[[f, 0.0, width / 2], [0.0, f, height / 2], [0.0, 0.0, 1.0]],
        dist_coeffs=[[0.0]] * 5,
        stabilize=None,
    )
    cc.set_bbox_from_corners([[300 * sx, 300 * sy], [3540 * sx, 300 * sy], [3540 * sx, 1860 * sy],
                              [300 * sx, 1860 * sy]])
    return cc


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--samples", type=int, default=8,
                    help="frames of normalize's mean (bench_e2e.py's 8; a short cut needs more, see PERF.md §4)")
    ap.add_argument("--size", default=f"{W_IMG}x{H_IMG}", help="frame WIDTHxHEIGHT (default the 4K headline)")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--no-cache", action="store_true")
    args = ap.parse_args(argv)

    import torch

    import pyorc_tpu_torch
    from pyorc_tpu_torch import _device
    from pyorc_tpu_torch.ops import piv_kernels

    width, height = (int(v) for v in args.size.lower().split("x"))
    pyorc_tpu_torch.set_device(args.device)
    device = pyorc_tpu_torch.get_device()
    n_frames = max(int(args.seconds * FPS), 3)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    clip = build / f"pyorc_tpu_torch_e2e_{n_frames}f_{width}x{height}.avi"
    t_render = 0.0
    if args.no_cache or not clip.is_file():
        tmp = clip.with_name(clip.stem + f".{os.getpid()}.tmp.avi")
        t_render = synth_clip(tmp, n_frames, height, width, device)
        os.replace(tmp, clip)

    cc = nadir_config(height, width, args.window)
    stages = {}
    t0 = time.perf_counter()
    video = pyorc_tpu_torch.Video(str(clip), camera_config=cc, start_frame=0, end_frame=n_frames - 1, h_a=0.0,
                                  progress=False)
    stages["video_open"] = time.perf_counter() - t0

    # decode-only throughput on a probe slice, reported beside the pipeline and
    # not counted in its total (the lazy chain decodes these frames again)
    t0 = time.perf_counter()
    probe_n = min(64, n_frames)
    _ = np.asarray(video.get_frames().data[:probe_n])
    probe_s = time.perf_counter() - t0
    decode_fps = probe_n / probe_s

    t0 = time.perf_counter()
    proj = video.get_frames().frames.normalize(samples=args.samples).frames.project()
    stages["lazy_chain_setup"] = time.perf_counter() - t0  # incl. the sampled mean's decode and the ortho maps

    for name in piv_kernels.LAUNCHES:
        piv_kernels.LAUNCHES[name] = 0
    up0 = _device.COPY_BYTES["h2d"]
    t0 = time.perf_counter()
    piv = proj.frames.get_piv(window_size=args.window, ensemble_corr=True)
    _sync(device)
    stages["decode_ortho_piv"] = time.perf_counter() - t0
    upload_gb = (_device.COPY_BYTES["h2d"] - up0) / 1e9

    # discharge over a synthetic parabolic cross-section spanning the bbox
    t0 = time.perf_counter()
    coords = np.asarray(cc.bbox.exterior.coords)
    p_left = (coords[0] + coords[1]) / 2
    p_right = (coords[2] + coords[3]) / 2
    n = 31
    xs = np.linspace(p_left[0], p_right[0], n)
    ys = np.linspace(p_left[1], p_right[1], n)
    t = np.linspace(-1, 1, n)
    zs = -0.05 - 0.4 * (1 - t**2)
    tr = piv.velocimetry.get_transect(xs, ys, zs, wdw=1)
    tr = tr.transect.get_q(fill_method="interpolate")
    tr.transect.get_river_flow()
    q_med = float(np.nanmedian(tr["river_flow"].values))
    stages["transect_discharge"] = time.perf_counter() - t0

    total = sum(stages.values())
    speed = float(np.nanmedian(np.hypot(piv["v_x"].values, piv["v_y"].values)))
    truth = float(np.hypot(DX_PIX, DY_PIX) * RES * FPS)
    rel_err = (speed - truth) / truth
    correct = bool(np.isfinite(speed) and abs(rel_err) <= SPEED_RTOL and np.isfinite(q_med))
    size = "4k" if (width, height) == (W_IMG, H_IMG) else f"{width}x{height}"
    print(json.dumps({
        # a CPU run times the plain versions on the host: its numbers are no card's
        "metric": f"e2e_{size}_{args.seconds:g}s_single_chip_seconds" + ("" if device.type == "cuda" else "_cpu_rehearsal"),
        "value": total,
        "unit": "s",
        "device": str(device),
        "card": card_line() if device.type == "cuda" else "not measured: the CPU run",
        "stages_s": stages,
        "decode_fps": decode_fps,
        "probe_decode_s_excluded": probe_s,
        "pairs_per_sec_e2e": (n_frames - 1) / stages["decode_ortho_piv"],
        "kernel_launches": dict(piv_kernels.LAUNCHES),
        "route": piv_kernels.KERNEL_ROUTE.get("piv_ensemble_fused"),
        "surface_speed_m_s_median": speed,
        "surface_speed_truth_m_s": truth,
        "surface_speed_rel_err": rel_err,
        "correct": correct,
        "river_flow_m3s_median": q_med,
        "clip_render_s": t_render,
        "n_frames": n_frames,
        "host_cores": os.cpu_count(),
        "upload_gb": upload_gb,
        "torch": torch.__version__,
    }))
    return 0 if correct else 1


if __name__ == "__main__":
    sys.exit(main())
