"""A toy route off the nadir route's geometry: its configuration has no ``camera``; its ``view`` is a nadir
pinhole whose area of interest lies ``inset_rows`` px inside the frame's top and bottom edges and
``inset_cols`` px inside its left and right ones, so that its projected grid is no ``(h - 2a, w - 2a)``; its
cross-section runs diagonally across that area. The tests copy it into a benchmark's ``routes/``."""

import chain
import control
import numpy as np
from reference.compare import NUMBERS, compare, verdict, video_answers
from reference.compare import reference_video as _reference_video
from routes.nadir_piv import make_videos  # noqa: F401  the nadir route's ring of frames on the card

SPANS = chain.SPANS
FAULTS = {}


def _inset(cfg):
    return cfg["view"]["inset_rows"], cfg["view"]["inset_cols"]


def grid_shape(cfg):
    r, c = _inset(cfg)
    return cfg["height"] - 2 * r, cfg["width"] - 2 * c


def setup(cfg):
    """The nadir route's camera with no inset, its area of interest then set to this route's."""
    view = cfg["view"]
    cc = chain.camera_config({**cfg, "camera": {"f": view["f"], "gcp_px": view["gcp_px"], "aoi_px": 0}})
    (r, c), h, w = _inset(cfg), cfg["height"], cfg["width"]
    cc.set_bbox_from_corners([[c, r], [w - c, r], [w - c, h - r], [c, h - r]])
    return cc


def points(cfg):
    """From the area of interest's north-west to its south-east, ``margin_px`` inside it, over a parabolic bed."""
    (r, c), h, w, res = _inset(cfg), cfg["height"], cfg["width"], cfg["resolution"]
    m, n = cfg["transect"]["margin_px"], cfg["transect"]["n_points"]
    x = np.linspace(res * (c + m), res * (w - c - m), n)
    y = np.linspace(res * (h - r - m), res * (r + m), n)
    t = np.linspace(-1.0, 1.0, n)
    return x, y, 0.1 - 1.5 * (1.0 - t**2)


def run_video(source, cc, cfg, sample=()):
    return chain.run_chain(lambda: chain.frames_dataarray(source, cc, cfg["fps"]), cfg, points(cfg), sample)


def reference_video(frames, cfg, precision="float32"):
    return _reference_video(frames, cfg, (cfg["view"]["f"], _inset(cfg)), points(cfg), precision)


def control_program():
    return control.program(reference_video, lambda source: source.ring.narrow(0, source.start, source.n_frames))
