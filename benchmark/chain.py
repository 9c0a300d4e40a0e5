"""One video's chain through the port, exactly as the service's stages call it, with the benchmark's spans.

The frames ``DataArray`` is built as the port's ``Video.get_frames`` builds it, over a ``LazyFrames`` on the
benchmark's device frame source; then ``normalize`` -> ``project`` -> ``get_piv`` -> ``mask`` ->
``get_transect`` -> ``get_q`` -> ``get_river_flow`` (:func:`run_chain`, which a route whose frames, camera or
cross-section come from elsewhere runs on its own frames ``DataArray`` and its own cross-section's points). The
nadir route's camera (:func:`camera_config`) is a pinhole whose ground control points and area of interest sit
``gcp_px`` and ``aoi_px`` inside the frame, so that a pixel is ``resolution`` m on the water plane; its
cross-section (``traffic.transect_points``) runs across the flow over a parabolic bed.
"""

from __future__ import annotations

import contextlib
import json
import time

import numpy as np
import torch

from traffic import transect_points

SPANS = ("chain_setup", "get_piv", "mask_transect")  # the benchmark's spans around the port's layers


def camera_config(cfg: dict):
    """The port's ``CameraConfig`` of the configuration's nadir camera."""
    from pyorc_tpu_torch import CameraConfig

    h, w, res = cfg["height"], cfg["width"], cfg["resolution"]
    cam = cfg["camera"]
    f, g, a = cam["f"], cam["gcp_px"], cam["aoi_px"]
    src = [[g, g], [w - g, g], [w - g, h - g], [g, h - g]]
    dst = [[res * c, res * (h - r)] for c, r in src]
    cc = CameraConfig(
        height=h,
        width=w,
        resolution=res,
        window_size=cfg["piv"]["window_size"],
        gcps={"src": src, "dst": dst, "h_ref": 0.0, "z_0": 0.0},
        camera_matrix=[[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]],
        dist_coeffs=[[0.0]] * 5,
        stabilize=None,
    )
    cc.set_bbox_from_corners([[a, a], [w - a, a], [w - a, h - a], [a, h - a]])
    return cc


def frames_dataarray(source, cc, fps: float):
    """The frames ``Video.get_frames`` gives: a ``LazyFrames`` over ``source`` with its coords and attrs."""
    import pyorc_tpu_torch as pkg

    n, h, w = source.n_frames, cc.height, cc.width
    lazy = pkg.LazyFrames(source, "grayscale", np.arange(n), (h, w), dtype=np.uint8)
    y = np.flipud(np.arange(h)).astype(np.float64)
    x = np.arange(w).astype(np.float64)
    xp, yp = np.meshgrid(x, y)
    coords = {"time": np.arange(n) / fps, "y": y, "x": x}
    attrs = {"camera_shape": str([h, w]), "camera_config": cc.to_json(), "h_a": json.dumps(0.0)}
    da = pkg.ndx.DataArray(lazy, dims=("time", "y", "x"), coords=coords, attrs=attrs, name="frames")
    da = da.frames.add_xy_coords({"xp": xp, "yp": yp}, coords, pkg.const.PERSPECTIVE_ATTRS)
    da.name = "frames"
    da.attrs["chunksize"] = 20
    return da


@contextlib.contextmanager
def span(record: dict, name: str):
    """Time ``name`` into ``record`` [s] and mark it for ``torch.profiler`` as ``bench:<name>``."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(f"bench:{name}"):
        yield
    record[name] = time.perf_counter() - t0


@contextlib.contextmanager
def keep_frames(proj, positions, kept: dict):
    """While open, copy into ``kept`` ({position in the video: frame}) each frame at ``positions`` as any view
    of the projected lazy stack ``proj`` reads it: the batches that ``get_piv`` consumes, whichever view or
    thread reads them (copied on the device, in the reading thread's stream order). The port's
    ``LazyFrames.read_batch`` is wrapped for as long as the block runs."""
    cls = type(proj)
    read = cls.read_batch
    wanted = {int(p) for p in positions}

    def read_batch(view, i0, i1, uploader=None):
        out = read(view, i0, i1, uploader)
        if view._video is proj._video and view._ops == proj._ops and view._crop == proj._crop:
            for j, p in enumerate(view._indices[i0:i1]):
                if int(p) in wanted:
                    kept[int(p)] = out[j].clone()
        return out

    cls.read_batch = read_batch
    try:
        yield
    finally:
        cls.read_batch = read


def run_video(source, cc, cfg: dict, sample=()) -> dict:
    """One video of a frame source through the port's chain: :func:`run_chain` over the frames that
    :func:`frames_dataarray` gives, across the nadir route's cross-section."""
    return run_chain(lambda: frames_dataarray(source, cc, cfg["fps"]), cfg, transect_points(cfg), sample)


def run_chain(get_frames, cfg: dict, points, sample=()) -> dict:
    """The chain from the frames ``DataArray`` that ``get_frames()`` gives (called inside the span
    ``chain_setup``) to the discharge across the cross-section ``points`` ((x, y, z) [m] in the camera's
    coordinates, ``get_transect``'s arguments); returns its outputs and the spans' seconds.

    Outputs: ``frames`` (the projected frames at the positions ``sample``, as ``get_piv`` read them;
    a frame it never read is missing), ``piv`` and ``masked`` (Datasets with ``v_x``, ``v_y``, ``corr``,
    ``s2n``), ``transect`` (the quantile Dataset with ``v_eff`` and ``q``) and ``river_flow`` [m3/s] by
    quantile.
    """
    piv_cfg = cfg["piv"]
    spans, kept = {}, {}
    with span(spans, "chain_setup"):
        da = get_frames()
        proj = da.frames.normalize(samples=cfg["normalize_samples"]).frames.project()
    with span(spans, "get_piv"), keep_frames(proj.data, sample, kept):
        piv = proj.frames.get_piv(
            window_size=piv_cfg["window_size"], overlap=tuple(piv_cfg["overlap"]),
            ensemble_corr=piv_cfg["ensemble_corr"], passes=piv_cfg["passes"],
        )
    with span(spans, "mask_transect"):
        mask = piv.velocimetry.mask
        masked = piv.velocimetry.mask([getattr(mask, name)() for name in cfg["masks"]])
        transect = masked.velocimetry.get_transect(*points)
        q = transect.transect.get_q(fill_method=cfg["fill_method"])
        q.transect.get_river_flow()
    frames = [kept[i] for i in sample if i in kept]
    return {"frames": torch.stack(frames) if frames else None, "piv": piv, "masked": masked, "transect": q, "river_flow": q["river_flow"].values,
            "spans": spans}
