"""The comparison that decides ``correct``: what the port's timed chain produced against the plain reference.

For each distinct video of the traffic the reference works the chain out again from the ring's frames
(:func:`reference_video`); :func:`compare` then holds every completed video's outputs to its video's
reference, and the projected frames at positions drawn from the seed, as the timed path handed them to
``get_piv`` (``chain.keep_frames``). The numbers, each held to its
limit in the configuration's ``limits``:

- ``frames_gap``: the largest difference of a projected frame's pixel [uint8 levels];
- ``uv_gap_px``: the largest difference of a displacement [px] over the windows whose reference plane has a
  clear peak (its largest value at least ``CONFIDENT_GAP`` above its second);
- ``corr_gap``: the largest difference of ``corr`` there; ``s2n_gap``: of ``s2n``, relative;
- ``masked_gap_px``: ``uv_gap_px`` of the masked fields, infinite where one side masks a window the other
  keeps, or has no number where the other has one;
- ``transect_gap``: the largest difference of the cross-section's ``v_eff`` [m/s] over points and quantiles;
- ``q_gap``: the largest difference of the discharge over quantiles, relative to the reference's.

A video that never completed is not an answer; one that completed is judged by what it says.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import plain

CONFIDENT_GAP = 5e-3
NUMBERS = ("frames_gap", "uv_gap_px", "corr_gap", "s2n_gap", "masked_gap_px", "transect_gap", "q_gap")


def final_grid(cfg: dict, shape):
    """Window centres (rows, cols) [px of the projected frame of ``shape`` (rows, cols)] of the last pass."""
    ws = cfg["piv"]["window_size"]
    ws += ws % 2
    ov = cfg["piv"]["overlap"]
    return plain.grid(shape[0], ws, ov[0])[1], plain.grid(shape[1], ws, ov[1])[1]


def reference_video(frames: torch.Tensor, cfg: dict, view, points, precision: str = "float32") -> dict:
    """The chain's outputs for one video, uint8 ``frames`` [T, H, W] on the device, by the plain reference,
    through the nadir pinhole ``view`` (its focal length [px], and its area of interest's inset (rows, cols)
    [px] from the frame's edges) and across the cross-section ``points`` (x, y, z) [m].

    Returns the projected frames (uint8 [T, ny, nx] on the device), the PIV fields ``u``, ``v`` [px] and
    ``corr``, ``s2n`` with each window's top-2 ``gap`` ([T-1 or 1, nr, nc], host), the masks' ``keep``,
    and the cross-section's ``v_eff``, ``q`` and ``river_flow``.
    """
    f, inset = view
    rnd = plain.rounder(precision)
    n = frames.shape[0]
    mean = torch.as_tensor(plain.sampled_mean(frames, cfg["normalize_samples"]), device=frames.device)
    index = plain.ortho_index(cfg, f, inset)
    proj = torch.cat([plain.project(plain.normalize(frames[i : i + 64], mean, rnd), index) for i in range(0, n, 64)])
    p = cfg["piv"]
    ws = p["window_size"] + p["window_size"] % 2
    if p["ensemble_corr"]:
        u, v, cmax, s2n, gap = plain.piv_ensemble(proj, ws, tuple(p["overlap"]), rnd)
        dt = np.array([np.diff(np.arange(n) / cfg["fps"]).mean()])
    else:
        out = plain.piv_multipass(proj, ws, tuple(p["overlap"]), p["passes"], rnd)
        u, v, cmax, s2n, gap = (t.cpu().numpy() for t in out)
        dt = np.diff(np.arange(n) / cfg["fps"])
    res = cfg["resolution"]
    field = {
        "v_x": (u.astype(np.float32) * np.float32(res) / dt[:, None, None]).astype(np.float32),
        "v_y": (v.astype(np.float32) * np.float32(res) / dt[:, None, None]).astype(np.float32),
        "corr": cmax.astype(np.float32), "s2n": s2n.astype(np.float32),
    }
    keep = plain.masks(field, cfg["masks"])
    masked = {k: np.where(keep, a, np.nan) for k, a in field.items()}
    rows, cols = final_grid(cfg, proj.shape[-2:])
    tr = plain.transect(masked, cfg, rows, cols, points, inset)
    return {"proj": proj, "u": u, "v": v, "corr": cmax, "s2n": s2n, "gap": gap, "keep": keep, "dt": dt, **tr}


def video_answers(out: dict) -> dict:
    """What one completed video of the port said, as host arrays: the PIV fields, the masked ones, the
    cross-section's ``v_eff`` and the discharge by quantile (``out["answers"]`` where a stand-in for the
    program gives them as such)."""
    if "answers" in out:
        return out["answers"]
    piv, masked, tr = out["piv"], out["masked"], out["transect"]
    return {
        **{k: np.asarray(piv[k].values) for k in ("v_x", "v_y", "corr", "s2n")},
        "masked_v_x": np.asarray(masked["v_x"].values), "masked_v_y": np.asarray(masked["v_y"].values),
        "v_eff": np.asarray(tr["v_eff"].values), "river_flow": np.asarray(out["river_flow"], dtype=np.float64),
    }


def _gap_px(got_x, got_y, ref_u, ref_v, px_per_ms, sel) -> float:
    """The largest displacement difference [px] over ``sel``; infinite where the port gives no number."""
    gx = np.abs(got_x * px_per_ms - ref_u)[sel]
    gy = np.abs(got_y * px_per_ms - ref_v)[sel]
    g = np.maximum(gx, gy)
    return float(np.max(np.where(np.isfinite(g), g, np.inf))) if g.size else 0.0


def compare_video(ans: dict, ref: dict, cfg: dict) -> dict:
    """The numbers of one completed video against its reference."""
    px_per_ms = ref["dt"][:, None, None] / cfg["resolution"]
    sure = np.isfinite(ref["gap"]) & (ref["gap"] >= CONFIDENT_GAP) & np.isfinite(ref["u"])
    if ans["v_x"].shape != ref["u"].shape:
        return {k: math.inf for k in NUMBERS[1:]}
    with np.errstate(invalid="ignore", divide="ignore"):
        s2n_rel = np.abs(ans["s2n"] - ref["s2n"]) / np.abs(ref["s2n"])
        corr_abs = np.abs(ans["corr"] - ref["corr"])
        out = {
            "uv_gap_px": _gap_px(ans["v_x"], ans["v_y"], ref["u"], ref["v"], px_per_ms, sure),
            "corr_gap": float(np.max(np.where(np.isfinite(corr_abs), corr_abs, np.inf)[sure], initial=0.0)),
            "s2n_gap": float(np.max(np.where(np.isfinite(s2n_rel), s2n_rel, np.inf)[sure], initial=0.0)),
        }
        kept = np.isfinite(ans["masked_v_x"])
        if np.any(kept[sure] != np.broadcast_to(ref["keep"], kept.shape)[sure]):
            out["masked_gap_px"] = math.inf
        else:
            out["masked_gap_px"] = _gap_px(ans["masked_v_x"], ans["masked_v_y"], ref["u"], ref["v"], px_per_ms,
                                           sure & kept)
        dv = np.abs(ans["v_eff"] - ref["v_eff"])
        out["transect_gap"] = float(np.max(np.where(np.isfinite(dv), dv, np.inf))) if dv.shape == ref[
            "v_eff"].shape else math.inf
        dq = np.abs(ans["river_flow"] - ref["river_flow"]) / np.abs(ref["river_flow"])
        out["q_gap"] = float(np.max(np.where(np.isfinite(dq), dq, np.inf))) if dq.shape == ref[
            "river_flow"].shape else math.inf
    return out


def frames_gap(program_frames: torch.Tensor, ref_frames: torch.Tensor) -> float:
    """The largest difference of a pixel [levels] between two uint8 stacks of projected frames (infinite
    where the program's are missing)."""
    if program_frames is None or program_frames.shape != ref_frames.shape:
        return math.inf
    diff = (program_frames.to(torch.int16) - ref_frames.to(torch.int16)).abs()
    return float(diff.max()) if diff.numel() else 0.0


def compare(answers: list, refs: dict, frame_checks: list, cfg: dict) -> dict:
    """The cell's numbers: the largest over every completed video (``answers``: (video key, answers)), and
    over the projected frames sampled (``frame_checks``: (program frames, reference frames))."""
    numbers = {k: 0.0 for k in NUMBERS}
    for key, ans in answers:
        for k, v in compare_video(ans, refs[key], cfg).items():
            numbers[k] = max(numbers[k], v)
    numbers["frames_gap"] = max((frames_gap(p, r) for p, r in frame_checks), default=0.0)
    return numbers


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (a number that is not finite is not)."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in NUMBERS)
