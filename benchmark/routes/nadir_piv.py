"""The route ``nadir_piv``: river videos made on the card from the seed, through the port's PIV chain, held to
the plain reference.

A configuration names its route (``"route"`` in ``configs/<name>.json``); ``run.load_cell`` loads
``routes/<route>.py`` by its path and puts the module in the cell (``cell["route"]``). ``run.run_cell``,
``readings.py`` and the tests reach the traffic, the chain and the reference only through it, so a deployment on
another path of the port (frames from video files, a camera with a pose and distortion, STIV) is a new route module
beside this one, with its configuration, traffic and readers, and no file that is there edited. A route gives
what ``run.ROUTE_GIVES`` names (``run.load_route`` refuses one that lacks a name), each set out here:

- ``make_videos(cfg, traffic, seed, device)``: the traffic's distinct videos, made from the seed during set-up: an
  object with ``len()``; ``n_frames(slot)``; ``source(slot)``, what the chain reads (a new one each call); and
  ``frames(slot)``, the uint8 frames [T, H, W] on ``device`` that the reference starts from, asked for only
  after the window (a route that reads files decodes them there with a decoder of its own);
- ``setup(cfg)``: what the chain needs once a run;
- ``run_video(source, setup, cfg, sample)``: one video through the port: a dict with ``spans`` (seconds by the
  names of ``SPANS``), ``frames`` (the projected frames at the positions ``sample`` as the timed path handed them
  on, or None) and what ``video_answers`` reads. A route on the port's PIV chain runs ``chain.run_chain`` with
  its own frames and its own cross-section's points;
- ``grid_shape(cfg)``: (rows, cols) of the projected frame that the route's camera and area of interest give,
  worked out from the configuration, not read off the program's output: ``run.run_cell`` hands it to the
  readers as ``ctx["grid"]``, and ``work.video_bounds`` counts the PIV kernels' work on it;
- ``SPANS``: the benchmark's spans of a video, reported by their quartiles;
- ``NUMBERS``: the numbers compared, each held to its limit in the configuration's ``limits``;
- ``video_answers(out)``: what one completed video said, as host arrays, kept through the window;
- ``reference_video(frames, cfg, precision="float32")``: one video by the plain reference, a dict whose ``proj``
  are the projected frames that ``sample``'s positions index and whose rest ``compare`` reads;
- ``compare(answers, refs, frame_checks, cfg)``: the numbers, from (slot, answers) of every completed video,
  the references by slot and (program frames, reference frames) pairs; ``verdict(numbers, limits)``: correct;
- ``control_program()``: a ``run_video`` with the plain reference in the program's place, a precision lower
  (``control.py``): its numbers have to fail a limit;
- ``FAULTS``: ``{name: plant(setattr_, cfg)}``, the faults planted in the timed path that this route's cells can
  have (``faults.py``).

Here the videos are consecutive slices of one ring of frames on the card (``traffic.make_ring``,
``traffic.video_starts``), each handed to the chain as a ``traffic.DeviceFrameSource``; the camera is
``chain.camera_config``'s nadir pinhole, whose area of interest lies ``aoi_px`` inside each edge of the frame; the
chain ``chain.run_video``, which runs ``chain.run_chain`` across the cross-section of ``traffic.transect_points``;
the reference ``reference/`` through the same camera and across the same points.
"""

from __future__ import annotations

import chain
import control
import faults
import traffic
from reference.compare import NUMBERS, compare, verdict, video_answers  # noqa: F401  parts of the route
from reference.compare import reference_video as _reference_video

SPANS = chain.SPANS
setup = chain.camera_config
run_video = chain.run_video


class RingVideos:
    """The distinct videos of a traffic mix: ``n`` consecutive frames of ``ring`` from each of ``starts``."""

    def __init__(self, ring, starts: list, n: int):
        self.ring, self.starts, self.n = ring, starts, n

    def __len__(self) -> int:
        return len(self.starts)

    def n_frames(self, slot: int) -> int:
        return self.n

    def source(self, slot: int) -> traffic.DeviceFrameSource:
        return traffic.DeviceFrameSource(self.ring, self.starts[slot], self.n)

    def frames(self, slot: int):
        return self.ring[self.starts[slot] : self.starts[slot] + self.n]


def make_videos(cfg: dict, mix: dict, seed: int, device) -> RingVideos:
    return RingVideos(traffic.make_ring(cfg, mix, seed, device), traffic.video_starts(mix), mix["frames_per_video"])


def _view(cfg: dict):
    """(f [px], (rows, cols) [px]): the camera's focal length and its area of interest's inset from the frame's
    edges, ``aoi_px`` on every side."""
    cam = cfg["camera"]
    return cam["f"], (cam["aoi_px"], cam["aoi_px"])


def grid_shape(cfg: dict) -> tuple:
    """The projected frame: the area of interest inside the frame's edges, a pixel a cell."""
    _, (r, c) = _view(cfg)
    return cfg["height"] - 2 * r, cfg["width"] - 2 * c


def reference_video(frames, cfg: dict, precision: str = "float32") -> dict:
    return _reference_video(frames, cfg, _view(cfg), traffic.transect_points(cfg), precision)


def control_program():
    return control.program(reference_video, lambda source: source.ring.narrow(0, source.start, source.n_frames))


def _for_cfg(plant):
    def planted(setattr_, cfg: dict):
        plant(setattr_, ensemble=cfg["piv"]["ensemble_corr"])

    planted.__doc__ = plant.__doc__
    return planted


FAULTS = {name: _for_cfg(plant) for name, plant in faults.FAULTS.items()}
