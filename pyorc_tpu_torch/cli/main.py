"""Click CLI: ``pyorc-tpu-torch camera-config`` and ``pyorc-tpu-torch velocimetry``.

The JAX package's CLI (:mod:`pyorc_tpu.cli.main`, a port of reference
``pyorc/cli/main.py:41-402``) on the port's service. ``camera-config`` opens
the interactive selectors (:mod:`pyorc_tpu_torch.cli.cli_elements`, matplotlib)
for GCPs without ``--src``, AOI corners without ``--corners`` on an oblique
camera, and ``--stabilize``. The commands compute on
``pyorc_tpu_torch.get_device()``: the card, unless ``PYORC_TPU_TORCH_DEVICE``
names another device.

``velocimetry --num-hosts N --host-id I --coordinator HOST:PORT`` runs one of
N cooperating processes (one a host, or one a card): each takes its own frame
segment of the video (a one-frame halo, :func:`pyorc_tpu_torch.parallel.distributed.segment_frame_ranges`),
writes its outputs and log under the prefix ``host000_``, ``host001_``, ..., and
``torch.distributed`` (gloo, TCP to the coordinator) serves for the closing
barrier only; host 0 then writes ``manifest.json``, the segments and their
artifacts in pair order.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import click

from .. import __version__
from . import cli_utils, log


def print_info(ctx, param, value):
    if not value:
        return {}
    click.echo(f"pyorc-tpu-torch version: {__version__} — river velocimetry on PyTorch and CUDA")
    ctx.exit()


def print_license(ctx, param, value):
    if not value:
        return {}
    click.echo("AGPL-3.0-or-later — see repository for details")
    ctx.exit()


video_opt = click.option(
    "-V",
    "--videofile",
    type=click.Path(resolve_path=True, dir_okay=False, file_okay=True),
    help="video file with required objective and resolution and control points in view",
    callback=cli_utils.validate_file,
)

verbose_opt = click.option("--verbose", "-v", count=True, help="Increase verbosity.")


@click.group(context_settings={"max_content_width": 120})
@click.version_option(__version__, message="pyorc-tpu-torch version: %(version)s")
@click.option("--info", default=False, is_flag=True, is_eager=True, help="Print version info", callback=print_info)
@click.option(
    "--license", default=False, is_flag=True, is_eager=True, help="Print license information", callback=print_license
)
@click.pass_context
def cli(ctx, info, license):  # noqa: A002
    """Command line interface for pyorc-tpu-torch (river velocimetry on PyTorch and CUDA)."""
    if ctx.obj is None:
        ctx.obj = {}


@cli.command(short_help="Prepare Camera Configuration file")
@click.argument("OUTPUT", type=click.Path(resolve_path=True, dir_okay=False, file_okay=True), required=True)
@video_opt
@click.option("--crs", type=str, callback=cli_utils.parse_str_num, help="CRS for the camera configuration")
@click.option("-f", "--frame-sample", type=int, default=0, help="Frame number for configuration background")
@click.option("--src", type=str, callback=cli_utils.parse_src, help="Source control points [[col, row], ...]")
@click.option(
    "--dst",
    type=str,
    callback=cli_utils.parse_dst,
    help="Destination control points: 2 or 4 [x, y] pairs, or 6+ [x, y, z].",
)
@click.option("--z_0", type=float, help="Water level [m] +CRS (e.g. geoid or ellipsoid of GPS)")
@click.option("--h_ref", type=float, help="Water level [m] +local datum (e.g. staff or pressure gauge)")
@click.option("--crs_gcps", type=str, callback=cli_utils.parse_str_num, help="CRS of destination GCPs")
@click.option("--resolution", type=float, help="Target resolution [m] for ortho-projection.")
@click.option("--focal_length", type=float, help="Focal length [pix] of lens.")
@click.option("--k1", type=float, help="First radial distortion coefficient k1 [-]")
@click.option("--k2", type=float, help="Second radial distortion coefficient k2 [-]")
@click.option("--window_size", type=int, help="Interrogation window size [px] for PIV")
@click.option(
    "--shapefile",
    type=click.Path(resolve_path=True, dir_okay=False, file_okay=True),
    help="GeoJSON file containing dst GCP points [x, y] or [x, y, z]",
    callback=cli_utils.validate_file,
)
@click.option("--lens_position", type=str, help="Lens position as [x, y, z]", callback=cli_utils.parse_json)
@click.option("--corners", type=str, callback=cli_utils.parse_corners, help="AOI corners: 4 [column, row] points")
@click.option("--stabilize", "-s", is_flag=True, default=False, help="Enable interactive stabilization region")
@click.option("--rotation", type=int, required=False, callback=cli_utils.validate_rotation, help="90/180/270 rotation")
@verbose_opt
@click.pass_context
def camera_config(
    ctx,
    output: str,
    videofile: str,
    crs,
    frame_sample: Optional[int],
    src,
    dst,
    z_0: Optional[float],
    h_ref: Optional[float],
    crs_gcps,
    focal_length: Optional[float],
    k1: Optional[float],
    k2: Optional[float],
    resolution: Optional[float],
    window_size: Optional[int],
    lens_position,
    shapefile: Optional[str],
    corners,
    stabilize: bool,
    rotation: Optional[int],
    verbose: int,
):
    """Prepare a camera configuration file from a video + ground control information."""
    import numpy as np

    from .. import service
    from ..api.video import Video

    log_level = max(10, 20 - 10 * verbose)
    logger = log.setuplog("cameraconfig", os.path.abspath("pyorc_tpu.log"), append=False, log_level=log_level)
    logger.info(f"Preparing your cameraconfig file in {output}")
    logger.info(f"Found video file {videofile}")
    if z_0 is None:
        z_0 = click.prompt("--z_0 not provided, please enter a number, or Enter for default", default=0.0, type=float)
    if h_ref is None:
        h_ref = click.prompt(
            "--h_ref not provided, please enter a number, or Enter for default", default=0.0, type=float
        )
    if resolution is None:
        resolution = click.prompt(
            "--resolution not provided, please enter a number, or Enter for default", default=0.05, type=float
        )
    if window_size is None:
        window_size = click.prompt(
            "--window_size not provided, please enter a number, or Enter for default", default=64, type=int
        )
    if shapefile is not None:
        if dst is None:
            dst, crs_gcps = cli_utils.read_shape(shapefile)
            dst = cli_utils.validate_dst(dst)
        else:
            logger.warning(f"Shapefile {shapefile} not used because --dst was provided explicitly.")
    frame_sample = frame_sample if frame_sample is not None else 0
    if dst is None:
        raise click.UsageError("No destination control points found; provide --dst or --shapefile")
    nadir = len(dst) == 2
    if nadir:
        logger.warning("Only 2 destination GCPs provided: assuming a nadir (straight-down) video.")
    camera_matrix = None
    dist_coeffs = None
    if src is None:
        from .cli_elements import GcpSelect

        logger.warning("No source control points provided; select them interactively.")
        vid = Video(videofile, start_frame=frame_sample, end_frame=frame_sample + 1, rotation=rotation, progress=False)
        img = vid.get_frame(0, method="rgb")
        selector = GcpSelect(img, dst, crs=crs, lens_position=lens_position, logger=logger)
        src = selector.run()
        camera_matrix = selector.camera_matrix_fit
        dist_coeffs = selector.dist_coeffs_fit
    elif focal_length is not None or k1 is not None or k2 is not None:
        if focal_length is not None:
            vid = Video(videofile, start_frame=frame_sample, end_frame=frame_sample + 1, rotation=rotation, progress=False)
            from ..geom.calibrate import get_cam_mtx

            camera_matrix = get_cam_mtx(vid.height, vid.width, focal_length=focal_length).tolist()
        if k1 is not None or k2 is not None:
            dist_coeffs = [[k1 or 0.0], [k2 or 0.0], [0.0], [0.0], [0.0]]
    if crs is None and crs_gcps is not None:
        raise click.UsageError(f"--crs is None while --crs_gcps is {crs_gcps}, please supply --crs.")
    gcps = {"src": src, "dst": dst, "z_0": z_0, "h_ref": h_ref, "crs": crs_gcps}
    if not corners:
        if nadir:
            vid = Video(videofile, start_frame=frame_sample, end_frame=frame_sample + 1, rotation=rotation, progress=False)
            corners = [[0, 0], [vid.width, 0], [vid.width, vid.height], [0, vid.height]]
        else:
            logger.warning("No corner points provided; select them interactively.")
            corners = cli_utils.get_corners_interactive(
                videofile, gcps, crs=crs, frame_sample=frame_sample,
                camera_matrix=camera_matrix, dist_coeffs=dist_coeffs, rotation=rotation, logger=logger,
            )
            if len(corners) != 4:
                raise click.UsageError("4 corner points are required; provide --corners.")
    stabilize_pol = None
    if stabilize:
        from .cli_elements import StabilizeSelect

        vid = Video(videofile, start_frame=frame_sample, end_frame=frame_sample + 1, rotation=rotation, progress=False)
        img = vid.get_frame(0, method="rgb")
        stabilize_pol = StabilizeSelect(img, logger=logger).run()
    service.camera_config(
        video_file=videofile,
        cam_config_file=output,
        gcps=gcps,
        crs=crs,
        frame_sample=frame_sample,
        resolution=resolution,
        window_size=window_size,
        lens_position=lens_position,
        corners=corners,
        camera_matrix=camera_matrix.tolist() if isinstance(camera_matrix, np.ndarray) else camera_matrix,
        dist_coeffs=dist_coeffs.tolist() if isinstance(dist_coeffs, np.ndarray) else dist_coeffs,
        stabilize=stabilize_pol,
        rotation=rotation,
    )
    logger.info(f"Camera configuration created and stored in {output}")


@cli.command(short_help="Estimate velocimetry")
@click.argument("OUTPUT", type=click.Path(resolve_path=True, dir_okay=True, file_okay=False), required=True,
                callback=cli_utils.validate_dir)
@video_opt
@click.option(
    "-r",
    "--recipe",
    type=click.Path(resolve_path=True, dir_okay=False, file_okay=True),
    help="Options file (.yml)",
    callback=cli_utils.parse_recipe,
)
@click.option(
    "-c",
    "--cameraconfig",
    type=click.Path(resolve_path=True, dir_okay=False, file_okay=True),
    help="Camera config file (.json)",
    callback=cli_utils.parse_camconfig,
)
@click.option("-p", "--prefix", type=str, default="", help="Prefix for produced output files")
@click.option("-h", "--h_a", type=float, help="Actual water level measured in local datum [m]")
@click.option(
    "--cross",
    type=click.Path(resolve_path=True, dir_okay=False, file_okay=True),
    help="Cross-section GeoJSON for discharge estimation",
    callback=cli_utils.validate_file,
)
@click.option(
    "--cross_wl",
    type=click.Path(resolve_path=True, dir_okay=False, file_okay=True),
    help="Cross-section GeoJSON for optical water level detection",
    callback=cli_utils.validate_file,
)
@click.option("-u", "--update", is_flag=True, default=False, help="Only update changed stages (hash cache)")
@click.option(
    "--num-hosts",
    type=int,
    default=1,
    help="Multi-host run: total number of cooperating hosts. Each host "
    "processes its own frame segment (one-frame halo) of the video; host 0 "
    "writes a manifest for stitching.",
)
@click.option("--host-id", type=int, default=None, help="This host's id (0-based) in a --num-hosts run")
@click.option(
    "--coordinator",
    type=str,
    default=None,
    help="torch.distributed (gloo) coordinator address (host:port) for --num-hosts runs",
)
@verbose_opt
@click.pass_context
def velocimetry(
    ctx, output, videofile, recipe, cameraconfig, prefix, h_a, cross, cross_wl, update,
    num_hosts, host_id, coordinator, verbose,
):
    """Estimate surface velocities and discharge from a video using a recipe."""
    from .. import service

    log_level = max(10, 20 - 10 * verbose)
    user_prefix = prefix
    if num_hosts > 1:
        # outer parallelism: this host runs the standard pipeline on its own
        # frame segment; torch.distributed coordinates only
        import cv2

        from ..parallel import distributed as dist

        pid, nproc = dist.init_distributed(coordinator, num_hosts, host_id)
        cap = cv2.VideoCapture(videofile)
        n_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        start, end = dist.segment_frame_ranges(n_frames, nproc)[pid]
        recipe.setdefault("video", {})
        recipe["video"]["start_frame"] = int(start)
        recipe["video"]["end_frame"] = int(end) - 1
        prefix = f"{user_prefix}host{pid:03d}_"
    # hosts share the output dir, so the log file carries the host prefix too
    logger = log.setuplog(
        "velocimetry", os.path.join(output, f"{prefix if num_hosts > 1 else ''}pyorc_tpu.log"),
        append=False, log_level=log_level,
    )
    logger.info(f"Preparing your velocimetry result in {output}")
    if num_hosts > 1:
        logger.info(f"Host {pid}/{nproc}: frames [{start}, {end}) -> prefix {prefix}")
    service.velocity_flow(
        recipe=recipe,
        videofile=videofile,
        cameraconfig=cameraconfig,
        prefix=prefix,
        output=output,
        h_a=h_a,
        cross=cross,
        cross_wl=cross_wl,
        update=update,
        logger=logger,
    )
    if num_hosts > 1:
        from ..ops import piv_kernels

        logger.info(f"Host {pid}/{nproc}: kernel launches {json.dumps(piv_kernels.LAUNCHES)}")
        dist.barrier("pipeline-done")
        if pid == 0:
            segs = dist.segment_frame_ranges(n_frames, num_hosts)
            dist.write_segments_manifest(
                output, n_frames, segs,
                lambda i, s, e: {
                    "prefix": f"{user_prefix}host{i:03d}_",
                    "artifact": f"{user_prefix}host{i:03d}_piv.nc",
                },
            )
            logger.info("Multi-host manifest written to manifest.json")


if __name__ == "__main__":
    cli()
