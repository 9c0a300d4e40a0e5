"""A configuration, a traffic mix, a per-layer metric and a route added as new files plus new BENCHMARK.json
entries, with no file that is there edited, are found and run by name; a configuration that names no route, one
that is not there, or one that lacks a part of the route contract, is refused."""

import json

import pytest

from toy import BENCH, add_cell, copy_bench, digests, run_toy, toy_cell

# A route whose videos are uint8 stacks in host memory, handed to the port's chain through the frame-source
# protocol (the port uploads each batch it reads), from which its reference reads them back.
HOST_STACK_ROUTE = '''"""A toy route: the ring's frames as numpy stacks in host memory."""

import numpy as np
import torch

import chain
import control
import traffic
from reference.compare import NUMBERS, compare, verdict, video_answers
from reference.compare import reference_video as _reference_video

SPANS = chain.SPANS
setup = chain.camera_config
FAULTS = {}
READS = []  # frames of each batch the chain read from a stack


class HostStack:
    fn = "host uint8 stack"

    def __init__(self, stack):
        self.stack, self.n_frames = stack, len(stack)

    def _decode_frames(self, positions, method, **_uploader):
        READS.append(len(np.atleast_1d(positions)))
        return self.stack[np.atleast_1d(positions)]


class HostVideos:
    def __init__(self, stacks, device):
        self.stacks, self.device = stacks, device

    def __len__(self):
        return len(self.stacks)

    def n_frames(self, slot):
        return len(self.stacks[slot])

    def source(self, slot):
        return HostStack(self.stacks[slot])

    def frames(self, slot):
        return torch.from_numpy(self.stacks[slot]).to(self.device)


def make_videos(cfg, mix, seed, device):
    ring = traffic.make_ring(cfg, mix, seed, "cpu").numpy()
    n = mix["frames_per_video"]
    return HostVideos([ring[s : s + n].copy() for s in traffic.video_starts(mix)], device)


def grid_shape(cfg):
    a = cfg["camera"]["aoi_px"]
    return cfg["height"] - 2 * a, cfg["width"] - 2 * a


def run_video(source, cc, cfg, sample=()):
    return chain.run_chain(lambda: chain.frames_dataarray(source, cc, cfg["fps"]), cfg, traffic.transect_points(cfg),
                           sample)


def reference_video(frames, cfg, precision="float32"):
    view = cfg["camera"]["f"], (cfg["camera"]["aoi_px"], cfg["camera"]["aoi_px"])
    return _reference_video(frames, cfg, view, traffic.transect_points(cfg), precision)


def control_program():
    return control.program(reference_video, lambda source: torch.from_numpy(source.stack))
'''


def _config(name: str, **changes) -> dict:
    cfg = json.loads((BENCH / "configs" / "ngwerere_1080p_mp26.json").read_text())
    return {**cfg, "name": name, **changes}


def test_new_files_are_found_without_an_edit(tmp_path):
    before = copy_bench(tmp_path)

    # the new files: a configuration, a traffic mix and a metric's reader
    cfg = _config("toy_single")
    cfg["piv"] = {**cfg["piv"], "passes": 1}
    (tmp_path / "benchmark" / "workloads" / "toy_pairs.json").write_text(
        json.dumps({"frames_per_video": 8, "ring_frames": 16, "clients": 1, "loop": "closed"}))
    (tmp_path / "benchmark" / "metrics" / "toy_frames.py").write_text(
        "def read(ctx):\n    return float(sum(v['n_frames'] for v in ctx['videos']))\n")
    name = add_cell(tmp_path, cfg, "toy_pairs", {"name": "toy_frames", "unit": "frames", "better": "higher",
                                                 "source": "host_clock", "layer": "accessors",
                                                 "moves": "frames_per_s"})

    cell = toy_cell(name, root=tmp_path)
    cell["traffic"].update(frames_per_video=8, ring_frames=16)
    assert cell["cfg"]["piv"]["passes"] == 1
    assert "toy_frames" in {m["name"] for m in cell["per_layer"]}
    out = run_toy(name, root=tmp_path, trace=True, cell=cell)
    assert out["result"]["correct"], out["numbers"]
    assert out["result"]["metrics"]["toy_frames"]["value"] == 8.0 * out["result"]["attempted"]
    after = digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_route_is_added_as_new_files(tmp_path):
    before = copy_bench(tmp_path)

    # the new files: a route whose frames come from host memory, and a configuration that names it
    (tmp_path / "benchmark" / "routes" / "host_stack.py").write_text(HOST_STACK_ROUTE)
    name = add_cell(tmp_path, _config("toy_host", route="host_stack"), "video126")

    cell = toy_cell(name, root=tmp_path)
    route = cell["route"]
    assert route.__name__ == "bench_route_host_stack" and not route.READS
    out = run_toy(name, root=tmp_path, cell=cell)
    assert out["result"]["correct"], out["numbers"]
    assert out["numbers"]["frames_gap"] == 0 and out["info"]["videos"] == 2
    assert sum(route.READS) >= out["info"]["frames"]  # every frame of every video came from a host stack
    control = run_toy(name, root=tmp_path, cell=cell, program=route.control_program())
    assert not control["result"]["correct"], control["numbers"]
    after = digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("route", [None, "no_such_route", "no_grid"])
def test_a_configuration_without_its_route_is_refused(tmp_path, route):
    """A configuration with no route, with one that is not there, or with one that lacks a part of the contract
    (here ``grid_shape``), is refused at load, saying what is missing."""
    import run

    copy_bench(tmp_path)
    if route == "no_grid":
        source = (BENCH / "routes" / "nadir_piv.py").read_text()
        (tmp_path / "benchmark" / "routes" / "no_grid.py").write_text(source + "\ndel grid_shape\n")
    cfg = _config("toy_lost", route=route)
    if route is None:
        del cfg["route"]
    name = add_cell(tmp_path, cfg, "video126")
    said = {None: "names no route; the routes present: ['nadir_piv']",
            "no_such_route": "names the route 'no_such_route', which is not there; the routes present: ['nadir_piv']",
            "no_grid": "the route 'no_grid' of configuration 'toy_lost' does not give grid_shape: a route gives "
                       + ", ".join(run.ROUTE_GIVES)}[route]
    with pytest.raises(SystemExit) as refused:
        run.load_cell(tmp_path, name)
    assert said in str(refused.value)
