"""The control of the comparison: the plain reference put in the program's place, in a lower precision.

:func:`program` stands in for a route's ``run_video`` whose answers are the port's PIV chain's: it works a video
out with the route's ``reference_video`` at ``PRECISION`` (bfloat16: the step below the configuration's float32),
from the frames that the route reads out of the video's source, and answers as the port's chain does, so that
``run.run_cell`` holds it to the float32 reference exactly as it holds the port. A route hands it out as its
``control_program()``. Its numbers have to fail a limit; ``readings.py`` reads them on the card and
``tests/test_harness_reference.py`` at a small size on the CPU.
"""

from __future__ import annotations

import time

import numpy as np

PRECISION = "bfloat16"


def program(reference_video, frames_of):
    """A ``run_video`` that answers with ``reference_video(frames_of(source), cfg, PRECISION)``."""

    def run_video(source, setup, cfg, sample=()):
        t0 = time.perf_counter()
        ref = reference_video(frames_of(source), cfg, PRECISION)
        res, dt = cfg["resolution"], ref["dt"][:, None, None]
        vx = (ref["u"].astype(np.float32) * np.float32(res) / dt).astype(np.float32)
        vy = (ref["v"].astype(np.float32) * np.float32(res) / dt).astype(np.float32)
        keep = np.broadcast_to(ref["keep"], vx.shape)
        answers = {"v_x": vx, "v_y": vy, "corr": ref["corr"].astype(np.float32), "s2n": ref["s2n"].astype(np.float32),
                   "masked_v_x": np.where(keep, vx, np.nan), "masked_v_y": np.where(keep, vy, np.nan),
                   "v_eff": ref["v_eff"], "river_flow": ref["river_flow"]}
        spans = {"chain_setup": 0.0, "get_piv": time.perf_counter() - t0, "mask_transect": 0.0}
        kept = ref["proj"][list(sample)] if len(sample) else None
        return {"answers": answers, "frames": kept, "spans": spans}

    return run_video
