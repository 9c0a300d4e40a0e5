"""The control of the comparison: the plain reference put in the program's place, in a lower precision.

:func:`program` stands in for ``chain.run_video``: it works a video out with the reference at ``precision``
(``PRECISION``, bfloat16: the step below the configuration's float32) and answers as the port's chain does, so that
``run.run_cell`` holds it to the float32 reference exactly as it holds the port. Its numbers have to fail a
limit; ``readings.py`` reads them on the card and ``tests/test_control.py`` at a small size on the CPU.
"""

from __future__ import annotations

import time

import numpy as np

from reference import compare
from traffic import transect_points


PRECISION = "bfloat16"


def program():
    def run_video(source, cc, cfg, sample=()):
        t0 = time.perf_counter()
        frames = source.ring.narrow(0, source.start, source.n_frames)
        ref = compare.reference_video(frames, cfg, transect_points(cfg), PRECISION)
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
