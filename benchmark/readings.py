#!/usr/bin/env python3
"""The readings that the limits of the comparison are set from, on the card, in one process.

    python3 benchmark/readings.py --workload <cell> --seeds 12 --control-seeds 3 [--first-seed N] [--fault NAME]

For each of ``--seeds`` seeds the cell runs as ``run.py`` runs it, with a window of one pass over its
distinct videos, and prints the numbers compared (the lower readings: sound runs of the program). For each of
``--control-seeds`` seeds the plain reference in bfloat16 takes the program's place (the route's
``control_program``): the upper readings, which a limit must stay under. With ``--fault`` the program's seeds run
with that fault of the route's ``FAULTS`` planted (the readings of a fault at the cell's own size). Each reading is
one JSON line on standard output and in ``build/readings/<cell>.jsonl``. The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import faults  # noqa: E402
import run  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=3_000_000_000)
    parser.add_argument("--fault", default=None)
    args = parser.parse_args(argv)
    run._caches(run.ROOT)
    run.steady_host()
    cell = run.load_cell(run.ROOT, args.workload)
    route = cell["route"]
    if args.fault is not None and args.fault not in route.FAULTS:
        parser.error(f"--fault: the route's faults are {sorted(route.FAULTS)}")
    import torch

    import pyorc_tpu_torch

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    pyorc_tpu_torch.set_device("cuda")
    torch.set_num_threads(run.HOST_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = run.ROOT / "build" / "readings"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{args.workload}.jsonl", "a") as log:
        plan = [(args.fault or "program", args.first_seed + k) for k in range(args.seeds)]
        plan += [("control", args.first_seed + 1000 + k) for k in range(args.control_seeds)]
        for kind, seed in plan:
            t0 = time.perf_counter()
            program = route.control_program() if kind == "control" else None
            patches = faults.Patches()
            if kind == args.fault:
                route.FAULTS[kind](patches, cell["cfg"])
            try:
                out = run.run_cell(cell, seed, 0.0, False, "cuda", program=program, min_passes=1)
            finally:
                patches.undo()
            line = {"workload": args.workload, "kind": kind, "seed": seed, "numbers": out["numbers"],
                    "correct": out["result"]["correct"],
                    "videos": out["info"]["videos"], "seconds": time.perf_counter() - t0,
                    "card": torch.cuda.get_device_name(0)}
            print(json.dumps(line), flush=True)
            log.write(json.dumps(line) + "\n")
            del out
            torch.cuda.empty_cache()
    found = run.forbidden_modules()
    if found:
        print(f"readings: loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
