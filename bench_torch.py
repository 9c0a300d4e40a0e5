"""Benchmark of the PyTorch/CUDA port: PIV frame pairs a second on one card at 64x64-px windows.

The port's counterpart of ``bench.py``. Prints ONE JSON line shaped like
``bench.py``'s: the same headline metric,
``piv_frame_pairs_per_sec_per_chip_64x64_1080p``, the per-pair kernel
(``pyorc_tpu_torch/csrc/piv_pairs.cu``) at 64 px and 50 % overlap on 65
frames of 1088x1920 made on the card from an explicit ``torch.Generator``
(``bench.py:30-66``). Times are CUDA events around single launches after a
warm-up: ``value`` is the rate at the median of ``--reps`` launches, ``best``
at the fastest. Beside it stand the plain PyTorch version's rate (the same
contract through ``torch.fft``), the kernel's least possible time on the card
(``pyorc_tpu_torch.ops.roofline``, the definition ``chip_smoke.py`` uses) and
its share of it, and ``card``: the name and power limit ``nvidia-smi`` gives.
``bench.py``'s TPU figures (``vs_baseline`` against a TPU round, the
matmul-DFT ``fp32_tflops``) have no counterpart here.

``--full`` adds the per-pair rates at 16, 26 and 32 px; the ensemble kernel's
rates at 16, 26, 32 and 64 px with the route that ran; and at 16, 26 and 32
px the kernel's displacements against the plain version's on ``bench.py``'s
particle image and sub-pixel shift (``_parity_config``): ``q95``, ``max``,
``frac_gt_0.5px`` and ``cond_max``, the largest difference where the top-2
correlation peaks are more than 5e-3 apart. ``--chain`` adds the 4K
normalize -> project -> ensemble chain of ``bench.py:199-256`` through the
port's ops, with the real index maps of ``bench_e2e_torch.nadir_config``.

    python3 bench_torch.py [--full] [--chain]
    python3 bench_torch.py --device cpu --height 96 --width 160 --frames 5 --full --chain --chain-size 384x216

``--device cpu`` runs the plain versions on the host clock, for the tests:
its metric is named ``..._cpu_rehearsal`` and no number of it is a card's.
It imports ``pyorc_tpu_torch`` and never JAX.
"""

import argparse
import json
import sys
import time

import numpy as np

METRIC = "piv_frame_pairs_per_sec_per_chip_64x64_1080p"
PEAK_GAP_CONFIDENT = 5e-3  # bench.py's: a window whose top-2 peaks are closer may flip its argmax


def _times_ms(fn, device, reps):
    """``fn``'s time [ms] in each of ``reps`` runs after one warm-up: CUDA events on the card, else the host clock."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return times


def _share(bound_ms, ms, device):
    """The kernel's share of its bound on the card; none for a CPU run (its time is no card's)."""
    return bound_ms / ms if device.type == "cuda" else None


def _grid(h, w, window):
    from pyorc_tpu_torch.ops import windows as win

    sas, overlap = (window, window), (window // 2, window // 2)
    return ((h, w), sas, overlap, *win.get_field_shape((h, w), sas, overlap))


def _random_frames(n_frames, h, w, device, seed=0):
    """float32 [n_frames, h, w] uniform in [0, 255), made on ``device`` from an explicit generator."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.rand((n_frames, h, w), generator=gen, device=device) * 255.0


def bench_pairs(window, h, w, n_frames, device, reps):
    """The per-pair kernel (the plain version on the CPU) at ``window`` px: rates, times and the bound."""
    from pyorc_tpu_torch.ops import piv_kernels, roofline

    frames = _random_frames(n_frames, h, w, device)
    args = _grid(h, w, window)
    n_pairs = n_frames - 1
    kernel = _times_ms(lambda: piv_kernels.piv_pairs_fused(frames, *args), device, reps)
    plain = _times_ms(lambda: piv_kernels.piv_pairs_fused_plain(frames, *args), device, max(reps // 3, 1))
    bound_ms, bound_by = roofline.pairs_bound(frames, args)
    med = float(np.median(kernel))
    return {
        "pairs_per_sec": n_pairs / med * 1e3, "pairs_per_sec_best": n_pairs / min(kernel) * 1e3,
        "ms_median": med, "ms_min": min(kernel), "plain_pairs_per_sec": n_pairs / float(np.median(plain)) * 1e3,
        "plain_ms_median": float(np.median(plain)), "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_share": _share(bound_ms, med, device), "route": piv_kernels.KERNEL_ROUTE.get("piv_pairs_fused"),
    }


def bench_ensemble(window, h, w, n_frames, device, reps):
    """The ensemble kernel at ``window`` px: its rate and the route that ran (``bench.py:121``)."""
    from pyorc_tpu_torch.ops import piv_kernels, roofline

    frames = _random_frames(n_frames, h, w, device, seed=1)
    args = _grid(h, w, window)
    times = _times_ms(lambda: piv_kernels.piv_ensemble_fused(frames, *args, 0.2, 3.0, None), device, reps)
    bound_ms, bound_by = roofline.ensemble_bound(frames, args)
    med = float(np.median(times))
    return {"pairs_per_sec": (n_frames - 1) / med * 1e3, "ms_median": med, "ms_min": min(times),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": _share(bound_ms, med, device),
            "route": piv_kernels.KERNEL_ROUTE.get("piv_ensemble_fused")}


def parity(window, h, w, device):
    """Kernel against plain version on ``bench.py``'s particle image shifted (2.4, -1.2) px by a Fourier shift."""
    import torch
    from scipy.ndimage import gaussian_filter

    from pyorc_tpu_torch.ops import piv as piv_ops
    from pyorc_tpu_torch.ops import piv_kernels

    rng = np.random.default_rng(7)
    img = np.zeros((h, w), np.float32)
    n_p = h * w // 40
    ys = rng.integers(0, h, n_p)
    xs = rng.integers(0, w, n_p)
    img[ys, xs] = rng.uniform(100, 255, n_p)
    img = gaussian_filter(img, 1.5, mode="wrap")
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    shifted = np.real(np.fft.ifft2(np.fft.fft2(img) * np.exp(-2j * np.pi * (fy * -1.2 + fx * 2.4))))
    frames = torch.as_tensor(np.stack([img, shifted]).astype(np.float32), device=device)
    args = _grid(h, w, window)
    u_k, v_k, *_ = piv_kernels.piv_pairs_fused(frames, *args)
    u_p, v_p, *_ = piv_kernels.piv_pairs_fused_plain(frames, *args)
    d = torch.hypot(u_k - u_p, v_k - v_p).cpu().numpy()
    gap = piv_ops.top2_gap(frames, *args[:3]).reshape(d.shape).cpu().numpy()
    ok = ~np.isnan(d)
    confident = ok & (gap > PEAK_GAP_CONFIDENT)
    return {
        "q95": float(np.quantile(d[ok], 0.95)), "max": float(d[ok].max()),
        "frac_gt_0.5px": float((d[ok] > 0.5).mean()), "cond_max": float(d[confident].max(initial=0.0)),
        "confident_share": float(confident.sum() / max(int(ok.sum()), 1)),
    }


def chain_4k(device, reps, n_frames=33, window=64, size=None):
    """normalize -> project -> ensemble over ``n_frames`` uint8 4K frames made on the card: pairs/s.

    The lazy chain's ops per batch (``Frames.normalize``'s ``normalize_with_mean``,
    the extrema on the card; ``ortho.project_batch`` with ``bench_e2e_torch.nadir_config``'s
    maps; ``piv_ensemble_fused``), so the rate is the whole workload's minus decode.
    """
    import torch

    from bench_e2e_torch import H_IMG, W_IMG, nadir_config
    from pyorc_tpu_torch.ops import filters as flt
    from pyorc_tpu_torch.ops import ortho as ortho_ops
    from pyorc_tpu_torch.ops import piv_kernels

    width, height = size or (W_IMG, H_IMG)
    cc = nadir_config(height, width, window)
    shape = cc.shape
    y = np.flipud(np.linspace(cc.resolution / 2, cc.resolution * (shape[0] - 0.5), shape[0]))
    x = np.linspace(cc.resolution / 2, cc.resolution * (shape[1] - 0.5), shape[1])
    maps = ortho_ops.build_ortho_maps(cc, x, y, 0.0, reducer="mean")
    dmaps = ortho_ops.device_maps(maps, device)
    oh, ow = maps.shape_out
    args = _grid(oh, ow, window)
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    frames = torch.randint(0, 255, (n_frames, height, width), generator=gen, device=device, dtype=torch.uint8)
    mean = torch.full((height, width), 127.0, device=device)

    def chain():
        f = flt.normalize_with_mean(frames, mean)
        f = ortho_ops.project_batch(f, maps, dmaps)
        return piv_kernels.piv_ensemble_fused(torch.nan_to_num(f).to(torch.uint8), *args, 0.2, 3.0, None)

    times = _times_ms(chain, device, reps)
    med = float(np.median(times))
    return {"pairs_per_sec": (n_frames - 1) / med * 1e3, "ms_median": med, "ms_min": min(times),
            "frames": [n_frames, height, width], "projected": [oh, ow],
            "route": piv_kernels.KERNEL_ROUTE.get("piv_ensemble_fused")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--chain", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--frames", type=int, default=65)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--chain-size", default=None, help="WIDTHxHEIGHT of the chain's frames (default 3840x2160)")
    args = ap.parse_args(argv)

    import torch

    import pyorc_tpu_torch
    from bench_e2e_torch import card_line

    pyorc_tpu_torch.set_device(args.device)
    device = pyorc_tpu_torch.get_device()
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    h, w = args.height, args.width
    head = bench_pairs(64, h, w, args.frames, device, args.reps)
    out = {
        # a CPU run times the plain versions on the host: its numbers are no card's
        "metric": METRIC if device.type == "cuda" else METRIC + "_cpu_rehearsal",
        "value": head["pairs_per_sec"],
        "unit": "pairs/s",
        "best": head["pairs_per_sec_best"],
        "ms_median": head["ms_median"], "ms_min": head["ms_min"],
        "plain_pairs_per_sec": head["plain_pairs_per_sec"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "bound_share": head["bound_share"],
        "route": head["route"],
        "device": str(device),
        "card": card_line() if device.type == "cuda" else "not measured: the CPU run",
        "shape": [args.frames, h, w],
        "timing": "CUDA events" if device.type == "cuda" else "host clock",
        "torch": torch.__version__,
    }
    if args.full:
        out["configs"] = {f"{win}px_1080p": bench_pairs(win, h, w, args.frames, device, args.reps) for win in (16, 26, 32)}
        out["ensemble"] = {f"{win}px_1080p": bench_ensemble(win, h, w, args.frames, device, args.reps)
                           for win in (16, 26, 32, 64)}
        out["parity_px"] = {f"{win}px": parity(win, h, w, device) for win in (16, 26, 32)}
    if args.chain:
        size = tuple(int(v) for v in args.chain_size.lower().split("x")) if args.chain_size else None
        out["chain_4k"] = chain_4k(device, max(args.reps // 3, 1), size=size)
        out["chain_4k_pairs_per_sec"] = out["chain_4k"]["pairs_per_sec"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
