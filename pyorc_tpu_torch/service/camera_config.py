"""Camera configuration service: build config from video + GCPs, write JSON + overview JPGs.

A copy of :mod:`pyorc_tpu.service.camera_config` (reference
``pyorc/service/camera_config.py:10-67``); matplotlib is imported when the
overview images are drawn.
"""

from __future__ import annotations

import os.path

from ..api.cameraconfig import CameraConfig
from ..api.video import Video

__all__ = ["camera_config"]


def camera_config(
    video_file, cam_config_file, lens_position=None, corners=None, frame_sample=0, rotation=None, **kwargs
):
    """Create a camera configuration file plus geographical/camera overview images."""
    import matplotlib.pyplot as plt

    fn_geo = f"{os.path.splitext(cam_config_file)[0]}_geo.jpg"
    fn_cam = f"{os.path.splitext(cam_config_file)[0]}_cam.jpg"
    video = Video(
        video_file, start_frame=int(frame_sample), end_frame=int(frame_sample) + 1, rotation=rotation, progress=False
    )
    img = video.get_frame(0)
    img_rgb = video.get_frame(0, method="rgb")
    kwargs["height"], kwargs["width"] = int(img.shape[0]), int(img.shape[1])
    gcps = kwargs.get("gcps")
    if gcps is not None and "crs" in gcps and gcps["crs"] is None:
        gcps = dict(gcps)
        gcps.pop("crs")
        kwargs["gcps"] = gcps
    cam_config = CameraConfig(rotation=rotation, **kwargs)
    if lens_position is not None:
        crs_gcps = (kwargs.get("gcps") or {}).get("crs")
        cam_config.set_lens_position(*lens_position, crs=crs_gcps)
    if corners is not None:
        cam_config.set_bbox_from_corners(corners)
    cam_config.to_file(cam_config_file)

    # geographical overview: bbox + gcps in world coordinates
    fig, ax = plt.subplots(figsize=(8, 8))
    bx, by = cam_config.bbox.exterior.xy
    ax.plot(bx, by, "k-", label="bbox")
    import numpy as np

    dst = np.asarray(cam_config.gcps_dest)
    ax.plot(dst[:, 0], dst[:, 1], "r+", markersize=12, label="GCPs")
    if cam_config.lens_position is not None:
        ax.plot(cam_config.lens_position[0], cam_config.lens_position[1], "b^", label="lens")
    ax.legend()
    ax.axis("equal")
    fig.savefig(fn_geo)
    plt.close(fig)

    # camera-perspective overview
    fig = plt.figure(figsize=(10, 6))
    ax = plt.axes()
    ax.imshow(img_rgb)
    src = np.asarray(cam_config.gcps["src"], dtype=np.float64)
    ax.plot(src[:, 0], src[:, 1], "r+", markersize=12, label="GCPs (src)")
    bbox_cam = cam_config.get_bbox(mode="camera", within_image=True)
    cx, cy = bbox_cam.exterior.xy
    ax.plot(cx, cy, "c-", label="AOI")
    ax.legend()
    fig.savefig(fn_cam)
    plt.close(fig)
