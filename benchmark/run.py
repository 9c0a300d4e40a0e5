#!/usr/bin/env python3
"""The benchmark of ``pyorc_tpu_torch``: one cell, run once, one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``: its route, camera, frames, motion,
PIV settings, masks, cross-section, the limits of the comparison) and a traffic mix (``workloads/<traffic>.json``:
frames a video, the ring the videos are cut from). The configuration's route (``routes/<route>.py``, whose
docstring sets out what a route gives) makes the videos, runs the port's chain, gives the projected grid its
camera and area of interest make (``grid_shape``: the shape the work of the PIV kernels is counted on) and holds
the chain to the plain reference; nothing here reads the camera. The run

1. makes the cell's distinct videos from ``--seed`` (the route's ``make_videos``) and runs one warm-up video
   (set-up, ``setup_s``, from the process's start);
2. measures for ``--seconds``: one client, closed loop, each video submitted when the previous one has given
   its discharge, through the port's chain (the route's ``run_video``);
3. with ``--trace 1`` records the window with ``torch.profiler``;
4. once the window has closed and the program's state is freed, works every distinct video out again with
   the plain reference (the route's ``reference_video``) and compares every completed video's outputs with it,
   and the projected frames that the timed path handed on at positions drawn from the seed;
5. prints each number compared beside its limit on standard error, and the result as the last line of
   standard output: the cell's end-to-end metrics (``--trace 0``) or its per-layer metrics (``--trace 1``),
   each taken by the reader ``metrics/<name>.py`` that ``BENCHMARK.json`` names.

It needs a CUDA card (it never falls back to the CPU) and the port beside ``benchmark/``; every build and
kernel cache stays inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pyorc_tpu")  # whole top-level module names the run may not load
FRAME_CHECKS = 4  # projected frames of each distinct video held to the reference, drawn from the seed
HOST_THREADS = 4  # host threads of torch's and the BLAS/OpenMP pools, whatever the machine's core count
# what a route module gives, the one list of the contract (``routes/nadir_piv.py``'s docstring says what each
# is); FAULTS may be empty
ROUTE_GIVES = ("make_videos", "setup", "run_video", "grid_shape", "SPANS", "NUMBERS", "video_answers",
               "reference_video", "compare", "verdict", "control_program", "FAULTS")


def _caches(root: Path) -> None:
    """Every build and kernel cache of the program at a fixed path inside the checkout."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def steady_host() -> None:
    """The host's thread pools at a fixed size, before numpy or torch is imported: the client is one process,
    whose main thread and the lazy chain's prefetch thread keep cores of their own beside the pools."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)


def host_clock() -> dict:
    """The process's CPU seconds and involuntary context switches, and the machine's CPU seconds stolen by
    its hypervisor (``/proc/stat``; nothing where it is not there): readings of the host's part in a window."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": ru.ru_utime + ru.ru_stime, "involuntary_switches": ru.ru_nivcsw}
    try:
        fields = Path("/proc/stat").read_text().split("\n", 1)[0].split()
        out["steal_s"] = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


def _module(path: Path, name: str):
    """The module of the file ``path``, loaded by its path as ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_route(bench_dir: Path, cfg: dict):
    """The route module ``routes/<route>.py`` that the configuration ``cfg`` names; a configuration that names
    no route, or one that is not there, is refused, and so is a route that lacks a part of the contract."""
    present = sorted(p.stem for p in (bench_dir / "routes").glob("*.py"))
    route = cfg.get("route")
    if route not in present:
        said = "no route" if route is None else f"the route {route!r}, which is not there"
        raise SystemExit(f"configuration {cfg.get('name')!r} names {said}; the routes present: {present}")
    module = _module(bench_dir / "routes" / f"{route}.py", f"bench_route_{route}")
    missing = [name for name in ROUTE_GIVES if not hasattr(module, name)]
    if missing:
        raise SystemExit(f"the route {route!r} of configuration {cfg.get('name')!r} does not give "
                         f"{', '.join(missing)}: a route gives {', '.join(ROUTE_GIVES)}")
    return module


def load_cell(root: Path, name: str) -> dict:
    """The cell ``name`` of ``root/BENCHMARK.json``: its entry, configuration, route, traffic and metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[entry["config"]]["file"]).read_text())
    route = load_route(root / bench["paths"][0], cfg)
    traffic = json.loads((root / bench["paths"][0] / "workloads" / f"{entry['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return {"entry": entry, "cfg": cfg, "route": route, "traffic": traffic, "end_to_end": e2e, "per_layer": layer,
            "metrics_dir": root / bench["paths"][0] / "metrics"}


def reader(metrics_dir: Path, name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    return _module(metrics_dir / f"{name}.py", f"bench_metric_{name.replace('.', '_')}").read


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _counters():
    from pyorc_tpu_torch import _device
    from pyorc_tpu_torch.ops import piv_kernels

    return dict(_device.COPY_BYTES), dict(piv_kernels.LAUNCHES)


def _quartiles(values) -> list:
    """Least, quartiles and largest of ``values`` (nothing for an empty list)."""
    import statistics

    if len(values) < 2:
        return list(values)
    return [min(values), *statistics.quantiles(values, n=4), max(values)]


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str, program=None,
             min_passes: int = 0) -> dict:
    """Run one cell once on ``device``; returns the result line's fields and the numbers compared.

    ``program`` replaces the route's ``run_video`` (a run with a fault planted, or with the plain reference in
    the program's place); every distinct video is measured ``min_passes`` times however short the window (the
    readings of ``readings.py``).
    """
    import numpy as np
    import torch

    import devtrace

    cfg, traffic, route = cell["cfg"], cell["traffic"], cell["route"]
    run_video = route.run_video if program is None else program
    distinct = route.make_videos(cfg, traffic, seed, device)
    setup = route.setup(cfg)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    # the projected frames held to the reference: FRAME_CHECKS positions of each distinct video, from the seed
    rng = random.Random(seed)
    sample = [sorted(rng.sample(range(n), min(FRAME_CHECKS, n)))
              for n in (distinct.n_frames(slot) for slot in range(len(distinct)))]
    warm = run_video(distinct.source(0), setup, cfg, sample[0])
    del warm
    sync()
    setup_s = time.perf_counter() - T_START
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way: a collection in the window walks the window's own

    videos, answers, kept = [], [], {}
    prof = devtrace.profiler(device) if trace else None
    if prof is not None:
        prof.start()
    host0 = host_clock()
    t0 = time.perf_counter()
    with devtrace.window():
        k = 0
        while time.perf_counter() - t0 < seconds or k < min_passes * len(distinct):
            slot = k % len(distinct)
            n = distinct.n_frames(slot)
            copy0, launch0 = _counters()
            tv = time.perf_counter()
            out = run_video(distinct.source(slot), setup, cfg, sample[slot])
            end = time.perf_counter()
            copy1, launch1 = _counters()
            videos.append({"slot": slot, "n_frames": n, "wall_s": end - tv, "end_s": end - t0,
                           "spans": out["spans"], "copy": _delta(copy1, copy0), "launches": _delta(launch1, launch0)})
            answers.append((slot, route.video_answers(out)))
            kept[slot] = out["frames"]
            del out
            k += 1
    sync()
    host = {k: v - host0[k] for k, v in host_clock().items()}
    gc.unfreeze()
    trace_data = None
    if prof is not None:
        prof.stop()
        trace_data = devtrace.read(prof)
        del prof
    on_card = torch.device(device).type == "cuda"
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0

    # the check: the program's state freed, the reference in blocks on the same device
    checks = [(slot, sample[slot], None if frames is None else frames.cpu()) for slot, frames in kept.items()]
    del kept
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    refs, frame_checks = {}, []
    for slot, idx, got in checks:
        ref = route.reference_video(distinct.frames(slot), cfg)
        proj = ref.pop("proj")
        frame_checks.append((got, proj[torch.as_tensor(idx, device=proj.device)].cpu()))
        refs[slot] = ref
        del proj
    numbers = route.compare(answers, refs, frame_checks, cfg)
    reference_s = time.perf_counter() - t_ref
    correct = bool(answers) and route.verdict(numbers, cfg["limits"])

    ctx = {"cfg": cfg, "traffic": traffic, "grid": tuple(route.grid_shape(cfg)), "videos": videos,
           "trace": trace_data, "setup_s": setup_s, "window_s": seconds}
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in wanted:
        value = reader(cell["metrics_dir"], m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(torch.device(device)) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    if trace_data is not None:
        dev.update(busy_s=trace_data["busy_s"], window_s=trace_data["window_s"])
    result = {"correct": correct, "attempted": len(videos), "failed": 0, "metrics": metrics, "device": dev}
    if trace_data is not None:
        result["breakdown"] = devtrace.breakdown(trace_data)
    walls = [v["wall_s"] for v in videos]
    if trace_data is not None:  # the lazy chain's spans run in its prefetch thread: two threads or more
        host["span_threads"] = trace_data["span_threads"]
    info = {"videos": len(videos), "frames": sum(v["n_frames"] for v in videos), "setup_s": setup_s, "host": host,
            "video_s_median": float(np.median(walls)) if walls else math.nan, "reference_s": reference_s,
            "window_end_s": videos[-1]["end_s"] if videos else math.nan,
            "spans": {k: _quartiles([v[k] if k == "wall_s" else v["spans"][k] for v in videos])
                      for k in ("wall_s",) + route.SPANS}}
    # a number that is not finite (an answer missing, a mask that differs) goes out as null: the line stays JSON
    result["checks"] = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else None, "limit": cfg["limits"][k]}
                        for k in route.NUMBERS}
    return {"result": result, "numbers": numbers, "info": info}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    _caches(ROOT)
    steady_host()
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    cell = load_cell(ROOT, args.workload)
    import torch

    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s); torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found", file=sys.stderr)
        return 2
    import pyorc_tpu_torch

    pyorc_tpu_torch.set_device("cuda")
    torch.set_num_threads(HOST_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}: the port may not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    info = out["info"]
    print(f"benchmark: {args.workload} seed {args.seed}: {info['videos']} videos ({info['frames']} frames), "
          f"setup {info['setup_s']:.3f} s, median video {info['video_s_median']:.4f} s, last completion "
          f"{info['window_end_s']:.3f} s, reference and comparison {info['reference_s']:.3f} s", file=sys.stderr)
    print("benchmark: host over the window: " + ", ".join(f"{k} {v:.6g}" for k, v in info["host"].items()),
          file=sys.stderr)
    for name, q in info["spans"].items():
        print(f"benchmark: {name} quartiles [s] {' '.join(f'{v:.4f}' for v in q)}", file=sys.stderr)
    for name, value in out["numbers"].items():
        print(f"check {name} {value!r} limit {out['result']['checks'][name]['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"], allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
