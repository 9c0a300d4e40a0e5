"""Multi-host outer parallelism: one video, or one frame segment of a video, per process.

Port of :mod:`pyorc_tpu.parallel.distributed`. The reference's outermost
parallelism is process isolation, one video per subprocess (reference
``pyorc/service/velocimetry.py:796-884``). Across hosts the data stays off
the network: every process decodes and processes its own video (or its own
frame segment of one long video) on its local devices, and
``torch.distributed`` serves for coordination only, over the ``gloo``
backend: a barrier, and host 0 writing the manifest through the shared
filesystem. Frame pairs are independent, so segments need a one-frame halo
and nothing else. Gloo needs no card (NCCL would want one card per process),
so several processes may share one card, or run on the CPU.

Nothing here puts a collective on the hot path; the ensemble reduction
inside a host's mesh (:mod:`pyorc_tpu_torch.parallel.piv`) stays the only
reduction across devices.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

__all__ = [
    "init_distributed",
    "host_video_assignment",
    "segment_frame_ranges",
    "barrier",
    "process_videos_multihost",
    "process_segments_multihost",
]

_ENV_CONTRACT = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _rank_world() -> Tuple[int, int]:
    """(this process's rank, the process count): (0, 1) without a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join the process group (a no-op for one process, or when a group is already up).

    With ``num_processes > 1`` this is
    ``torch.distributed.init_process_group("gloo", init_method=f"tcp://{coordinator_address}", ...)``
    (``coordinator_address`` is ``host:port``; without it, torch's ``env://``
    contract). Without arguments, a group is formed only where torch's
    ``env://`` variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``) are all set. Returns (process_id, num_processes).
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return _rank_world()
    if num_processes is not None and num_processes > 1:
        init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
        dist.init_process_group("gloo", init_method=init_method, world_size=num_processes, rank=process_id)
    elif num_processes is None and all(os.environ.get(k) for k in _ENV_CONTRACT):
        dist.init_process_group("gloo", init_method="env://")
    return _rank_world()


def barrier(tag: str = "sync") -> None:
    """A barrier over every process of the group (nothing for one process); ``tag`` names it for readers."""
    import torch.distributed as dist

    if _rank_world()[1] > 1:
        dist.barrier()


def host_video_assignment(videos: Sequence[str], process_id: int, num_processes: int) -> List[str]:
    """Round-robin assignment of whole videos to hosts (reference's
    one-video-per-subprocess model, scaled out)."""
    return [v for i, v in enumerate(videos) if i % num_processes == process_id]


def segment_frame_ranges(
    n_frames: int, num_processes: int, halo: int = 1
) -> List[Tuple[int, int]]:
    """Per-host (start, end) frame ranges for ONE long video.

    Consecutive segments overlap by ``halo`` frames so every frame pair is
    owned by exactly one host (pair i lives with frame i's owner).
    """
    n_pairs = n_frames - 1
    per = -(-n_pairs // num_processes)
    out = []
    for p in range(num_processes):
        s = p * per
        e = min(s + per + halo, n_frames)
        if s >= n_frames - 1:
            out.append((n_frames - 1, n_frames))
        else:
            out.append((s, e))
    return out


def process_videos_multihost(
    videos: Sequence[str],
    run_one,
    output_dir: str,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
) -> List[str]:
    """Run ``run_one(video_path, out_path)`` for this host's share of videos.

    Results land in ``output_dir`` as one artifact per video; a manifest
    (host -> videos) is written by host 0 after the closing barrier so the
    caller can assemble. Returns this host's output paths.
    """
    rank, world = _rank_world()
    pid = rank if process_id is None else process_id
    nproc = world if num_processes is None else num_processes
    mine = host_video_assignment(videos, pid, nproc)
    outdir = Path(output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    outputs = []
    for v in mine:
        out = outdir / f"{Path(v).stem}_piv.nc"
        run_one(v, str(out))
        outputs.append(str(out))
    barrier("videos-done")
    if pid == 0:
        manifest = {
            "num_processes": nproc,
            "videos": {str(i): host_video_assignment(videos, i, nproc) for i in range(nproc)},
        }
        (outdir / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return outputs


def process_segments_multihost(
    n_frames: int,
    run_segment,
    output_dir: str,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
    halo: int = 1,
) -> str:
    """Run this host's frame segment of ONE long video.

    ``run_segment(start_frame, end_frame, out_path)`` processes frames
    [start, end) — segments share a ``halo``-frame overlap so every frame
    pair is owned by exactly one host. After the closing barrier, host 0
    writes ``manifest.json`` mapping hosts to their (segment, artifact), so
    a consumer can stitch results in pair order. Returns this host's output
    path.
    """
    rank, world = _rank_world()
    pid = rank if process_id is None else process_id
    nproc = world if num_processes is None else num_processes
    segs = segment_frame_ranges(n_frames, nproc, halo=halo)
    start, end = segs[pid]
    outdir = Path(output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    out = str(outdir / f"segment_{pid:03d}_piv.nc")
    run_segment(start, end, out)
    barrier("segments-done")
    if pid == 0:
        write_segments_manifest(
            outdir, n_frames, segs, lambda i, s, e: {"artifact": f"segment_{i:03d}_piv.nc"}
        )
    return out


def write_segments_manifest(output_dir, n_frames: int, segs, entry) -> None:
    """Write the stitch manifest: per-segment frame range + ``entry(i, s, e)``
    payload (artifact path, per-host prefix, ...). ONE schema for every
    multi-host writer — the CLI and :func:`process_segments_multihost` share
    this, so consumers never see divergent manifests."""
    manifest = {
        "num_processes": len(segs),
        "n_frames": n_frames,
        "segments": {
            str(i): {"start_frame": int(s), "end_frame": int(e), **entry(i, s, e)}
            for i, (s, e) in enumerate(segs)
        },
    }
    (Path(output_dir) / "manifest.json").write_text(json.dumps(manifest, indent=2))
