"""The work one video of a configuration asks of each hand-written kernel, as the frozen bounds count it.

Bounds [ms] for a video of ``n_frames`` projected frames of the route's grid (``grid_shape``): the per-pair kernel's at each pass, the deformation
kernel's at each pass after the first, and the ensemble kernel's over the uint8 stack. They count the work
these inputs need, whatever implements it: a chunked or split launch does the same work. A pass over
undeformed frames (the single pass, and multipass's first) needs each frame's windows once and the uint8
stack read once (consecutive pairs at ``pair_stride=1``), however the program stacks its pairs; only a
deformed pass needs two float32 frames a pair (``pair_stride=2``), since each pair's frames are deformed by
that pair's own predictor.
"""

from __future__ import annotations

import torch

import roofline

KERNELS = {"piv_pairs": "piv_pairs_kernel", "piv_ensemble": "piv_ensemble_kernel", "deform_pairs": "deform_pairs_kernel"}


def _axis(n_px: int, ws: int, ov: int) -> int:
    return (n_px - ws) // (ws - ov) + 1


def video_bounds(cfg: dict, n_frames: int, grid) -> dict:
    """{kernel: bound [ms]} for one video of ``n_frames`` projected frames of ``grid`` (rows, cols); a kernel
    the configuration does not run is left out."""
    h, w = grid
    p = cfg["piv"]
    ws = p["window_size"] + p["window_size"] % 2
    n_pairs = n_frames - 1
    meta = dict(device="meta")
    frames = torch.empty((n_frames, h, w), dtype=torch.uint8, **meta)
    if p["ensemble_corr"]:
        ov = tuple(p["overlap"])
        args = ((h, w), (ws, ws), ov, _axis(h, ws, ov[0]), _axis(w, ws, ov[1]))
        return {"piv_ensemble": roofline.ensemble_bound(frames, args)[0]}
    pairs = torch.empty((2 * n_pairs, h, w), dtype=torch.float32, **meta)
    out = {"piv_pairs": 0.0}
    prev = None
    for k in range(p["passes"]):
        size = ws * 2 ** (p["passes"] - 1 - k)
        size += size % 2
        ov = tuple(p["overlap"]) if k == p["passes"] - 1 else (size // 2, size // 2)
        args = ((h, w), (size, size), ov, _axis(h, size, ov[0]), _axis(w, size, ov[1]))
        if prev is None:  # undeformed: consecutive pairs of the uint8 stack
            out["piv_pairs"] += roofline.pairs_bound(frames, args)[0]
        else:
            out["piv_pairs"] += roofline.pairs_bound(pairs, args, pair_stride=2)[0]
            u = torch.empty((n_pairs, prev[3], prev[4]), dtype=torch.float32, **meta)
            deform_in = torch.empty((n_frames, h, w), dtype=torch.float32, **meta)
            out["deform_pairs"] = out.get("deform_pairs", 0.0) + roofline.deform_bound(deform_in, u)[0]
        prev = args
    return out
