"""Recipe-driven pipeline service: one video in, velocity/discharge artifacts out.

A copy of :mod:`pyorc_tpu.service.velocimetry` on the port's classes: the
video's frames stay a ``LazyFrames`` stack, so the frames and velocimetry
stages stream decode -> filters -> project -> PIV on the device, and the
frames section's ``to_video`` and ``to_geotiff`` read that chain as well
(``Frames.to_video`` streams it once, with only uint8 frames coming down).
``write_ugrid`` and the ``plot`` stage are host code over the Dataset's
arrays; the plot stage needs matplotlib where it runs.

The JAX package's service has the same *contract* as the reference service layer (reference
``pyorc/service/velocimetry.py``): the YAML recipe's sections run in the fixed
order video -> [optical water level] -> frames -> velocimetry -> mask ->
transect -> plot, intermediate results land as netCDF next to a ``.pyorc/``
ledger directory that lets ``--update`` re-runs skip stages whose recipe
slice and file fingerprints are unchanged, and a subprocess launcher allows
embedding.  The *implementation* is this framework's own: stages are entries
in a declarative table (:data:`PIPELINE`), the incremental-skip bookkeeping
lives in one :class:`StageLedger` object rather than a decorator, and stage
bodies are plain methods wrapped by a single failure handler.

Ledger file layout (compatible with prior runs of this tool):
``<output>/.pyorc/<prefix><stage>.yml`` holds the recipe slice the stage last
ran with; ``<output>/.pyorc/<basename>.hash`` holds the SHA-256 hexdigest of
each tracked input/output file.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import subprocess
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import click
import numpy as np
import yaml

from .. import const, helpers, ndx
from ..api.cameraconfig import CameraConfig, xyz_transform
from ..api.cross_section import CrossSection
from ..api.video import Video
from ..cli import cli_utils

__all__ = ["velocity_flow", "velocity_flow_subprocess", "VelocityFlowProcessor", "get_water_level"]

logger = logging.getLogger(__name__)

# color methods the optical water-level detector accepts
WATER_LEVEL_COLOR_METHODS = ("grayscale", "hue", "sat", "val")


# ---------------------------------------------------------------------------
# incremental re-run ledger
# ---------------------------------------------------------------------------


class StageLedger:
    """Fingerprint store deciding whether a cached stage may be skipped.

    A stage is *current* when (a) the YAML dump of its recipe slice equals the
    stored one and (b) every tracked file still exists with an unchanged
    SHA-256.  ``commit`` records both after a successful run.
    """

    def __init__(self, root: str, prefix: str, log: logging.Logger):
        self.dir = os.path.join(root, ".pyorc")
        self.prefix = prefix
        self.log = log
        os.makedirs(self.dir, exist_ok=True)

    def _slice_path(self, stage: str) -> str:
        return os.path.join(self.dir, f"{self.prefix}{stage}.yml")

    def _digest_path(self, fn: str) -> str:
        return os.path.join(self.dir, f"{os.path.basename(fn)}.hash")

    @staticmethod
    def _dump_slice(recipe: Dict, keys: Sequence[str]) -> str:
        part = {k: recipe[k] for k in keys if k in recipe}
        return yaml.dump(part, default_flow_style=False, sort_keys=False)

    def is_current(self, stage: str, recipe: Dict, keys: Sequence[str], files: Sequence[str]) -> bool:
        slice_fn = self._slice_path(stage)
        if not os.path.isfile(slice_fn):
            return False
        with open(slice_fn) as f:
            if f.read() != self._dump_slice(recipe, keys):
                self.log.debug(f"[{stage}] recipe slice differs from the ledger; stage is stale")
                return False
        for fn in files:
            digest_fn = self._digest_path(fn)
            if not (os.path.isfile(fn) and os.path.isfile(digest_fn)):
                return False
            with open(digest_fn) as f:
                stored = f.read()
            if cli_utils.get_file_hash(fn).hexdigest() != stored:
                self.log.debug(f"[{stage}] fingerprint of {fn} changed; stage is stale")
                return False
        return True

    def commit(self, stage: str, recipe: Dict, keys: Sequence[str], files: Sequence[str]) -> None:
        """Record the stage's recipe slice and the fingerprints of those ``files`` that exist: an
        artifact the recipe did not ask to write has none, and its stage never counts as current
        (the JAX package's ledger raises on it: ROADMAP.md, queue C)."""
        with open(self._slice_path(stage), "w") as f:
            f.write(self._dump_slice(recipe, keys))
        for fn in filter(os.path.isfile, files):
            with open(self._digest_path(fn), "w") as f:
                f.write(cli_utils.get_file_hash(fn).hexdigest())


# ---------------------------------------------------------------------------
# recipe dispatch helpers
# ---------------------------------------------------------------------------


def apply_methods(obj, accessor: str, logger=logger, skip_args=None, **sections):
    """Chain accessor method calls named by recipe keys onto ``obj``."""
    skip = set(skip_args or ())
    for name, params in sections.items():
        if name in skip:
            continue
        ns = getattr(obj, accessor)
        if not hasattr(ns, name):
            raise ValueError(f'Recipe names "{name}", which is not a method of .{accessor}')
        logger.debug(f"recipe step .{accessor}.{name}({params or {}})")
        obj = getattr(ns, name)(**(params or {}))
    return obj


def get_masks(obj, **mask_methods) -> List:
    """Evaluate one recipe mask group into a list of boolean masks."""
    return [
        getattr(obj.velocimetry.mask, name)(**(params or {}))
        for name, params in mask_methods.items()
    ]


def vmin_vmax_to_norm(opts: Dict) -> Dict:
    """Fold plain vmin/vmax plot options into a matplotlib Normalize."""
    if "vmin" in opts or "vmax" in opts:
        from matplotlib.colors import Normalize

        opts["norm"] = Normalize(vmin=opts.pop("vmin", None), vmax=opts.pop("vmax", None))
    return opts


def get_water_level(
    video: Video,
    cross_section: CrossSection,
    n_start: int = 0,
    n_end: int = 1,
    method: str = "grayscale",
    s2n_thres: float = 3.0,
    frames_options: Optional[Dict] = None,
    water_level_options: Optional[Dict] = None,
    logger: logging.Logger = logger,
):
    """Optical water level: walk preprocessing option sets, keep the first
    detection whose signal-to-noise clears the threshold.

    Each entry of ``frames_options`` may carry its own ``method`` /
    ``s2n_thres`` overrides; the frame slice [n_start, n_end) is averaged
    over time before scoring. Returns the detected level or None when no
    option set produces a confident detection.
    """
    option_sets = frames_options if isinstance(frames_options, list) else [frames_options or {}]
    for options in option_sets:
        color = options.pop("method", method)
        threshold = options.pop("s2n_thres", s2n_thres)
        if color not in WATER_LEVEL_COLOR_METHODS:
            raise ValueError(
                f'Color method "{color}" cannot drive water-level detection; '
                f"pick one of {list(WATER_LEVEL_COLOR_METHODS)}"
            )
        stack = video.get_frames(method=color).isel(time=slice(n_start, n_end))
        logger.debug(f"water level attempt with preprocessing {options}")
        stack = apply_methods(stack, "frames", logger=logger, skip_args=["to_video"], **options)
        mean_img = stack.mean(dim="time") if "time" in stack.dims else stack
        level, s2n = cross_section.detect_water_level_s2n(
            np.uint8(mean_img.values), **(water_level_options or {})
        )
        if s2n > threshold:
            logger.debug(f"water level accepted: h={level:.3f} m (s2n {s2n:.2f} > {threshold:.2f})")
            return level
        logger.debug(f"water level rejected: h={level:.3f} m (s2n {s2n:.2f} <= {threshold:.2f})")
    return None


# ---------------------------------------------------------------------------
# the processor
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StageSpec:
    """One pipeline stage: when it runs, what the ledger tracks, what it restores."""

    name: str
    recipe_key: Optional[str] = None  # recipe section driving the stage (None: always-on)
    optional: bool = False  # skip entirely when recipe_key is absent
    cached: bool = False  # eligible for ledger-based skipping under --update
    config_keys: Sequence[str] = ()  # recipe slices recorded in the ledger after a run
    tracked_files: Sequence[str] = ()  # processor attributes naming files to fingerprint
    reload_attr: Optional[str] = None  # attribute restored from reload_file on skip
    reload_file: Optional[str] = None


PIPELINE: List[StageSpec] = [
    StageSpec("video", recipe_key="video"),
    StageSpec("water_level", recipe_key="water_level", optional=True),
    StageSpec("frames", recipe_key="frames"),
    StageSpec(
        "velocimetry",
        recipe_key="velocimetry",
        cached=True,
        config_keys=("video", "frames", "velocimetry"),
        tracked_files=("fn_video", "fn_piv"),
        reload_attr="velocimetry_obj",
        reload_file="fn_piv",
    ),
    StageSpec(
        "mask",
        recipe_key="mask",
        optional=True,
        cached=True,
        config_keys=("video", "frames", "velocimetry", "mask"),
        tracked_files=("fn_piv", "fn_piv_mask"),
        reload_attr="velocimetry_mask_obj",
        reload_file="fn_piv_mask",
    ),
    StageSpec(
        "transect",
        recipe_key="transect",
        optional=True,
        config_keys=("transect",),
        tracked_files=("fn_piv_mask",),
    ),
    StageSpec("stiv", recipe_key="stiv", optional=True),
    StageSpec(
        "plot",
        recipe_key="plot",
        optional=True,
        config_keys=("video", "frames", "velocimetry", "transect", "plot"),
        tracked_files=("fn_video", "fn_piv_mask"),
    ),
]


class VelocityFlowProcessor:
    """Drives the recipe through the accessor API, stage by stage."""

    def __init__(
        self,
        recipe: Dict,
        videofile: str,
        cameraconfig: Dict,
        prefix: str,
        output: str,
        h_a: Optional[float] = None,
        cross: Optional[str] = None,
        cross_wl: Optional[str] = None,
        update: bool = False,
        fn_piv: str = "piv.nc",
        fn_piv_mask: str = "piv_mask.nc",
        fn_transect_template: str = "transect_{:s}.nc",
        logger: logging.Logger = logging,
    ):
        logger.debug("setting up the velocity-flow pipeline")
        self.logger = logger
        self.recipe = recipe
        self.output = output
        self.prefix = prefix
        self.update = update
        self.fn_video = videofile
        self.cross_section_fn = cross

        self.cam_config = CameraConfig(**_parse_camconfig_dict(cameraconfig))
        self.cross_section_wl = self._resolve_water_level_source(h_a, cross, cross_wl)

        # output artifact paths (unmasked PIV doubles as the mask artifact
        # when the recipe has no mask section)
        self.fn_piv = os.path.join(output, prefix + fn_piv)
        self.fn_piv_mask = os.path.join(output, prefix + fn_piv_mask) if "mask" in recipe else self.fn_piv
        if "transect" in recipe:
            template = os.path.join(output, prefix + fn_transect_template)
            self.fn_transect_template = template.format
            self.fn_transects = [template.format(t) for t in recipe["transect"] if t != "write"]
        else:
            self.fn_transect_template = None

        self.ledger = StageLedger(output, prefix, logger)
        self.logger.info("velocity-flow pipeline ready")

    def _resolve_water_level_source(self, h_a, cross, cross_wl) -> Optional[CrossSection]:
        """Decide where h_a comes from: argument, recipe, or optical detection.

        Returns the water-level cross-section when optical detection is to
        run, mutating the recipe so downstream stages see a consistent view.
        """
        recipe_h_a = self.recipe["video"].get("h_a")
        if h_a is not None:
            gap = abs(h_a - self.cam_config.gcps["h_ref"])
            if gap > const.WATER_LEVEL_MAX_DIFF:
                self.logger.warning(
                    f"supplied water level sits {gap:.2f} m from h_ref — verify the datum"
                )
            self.recipe["video"]["h_a"] = h_a
            self.logger.info(f"water level from argument: h = {h_a} m")
            return None
        if cross_wl is not None:
            self.logger.info("water level will be detected optically on the supplied cross-section")
            coords, crs = cli_utils.read_shape(fn=cross_wl)
            if crs is not None and getattr(self.cam_config, "crs", None) is not None:
                from ..api.cameraconfig import xyz_transform
                from ..geom import crs as crs_mod

                coords = xyz_transform(coords, crs, crs_mod.CRS.from_user_input(self.cam_config.crs))
            self.recipe.setdefault("water_level", {})
            return CrossSection(camera_config=self.cam_config, cross_section=coords)
        if recipe_h_a is not None:
            self.logger.info(f"water level from recipe: h = {recipe_h_a} m")
            return None
        if cross is None:
            raise click.UsageError(
                "A water level is required: pass --h_a, put h_a in the recipe's video "
                "section, or supply --cross_wl for optical detection."
            )
        self.logger.error(
            "no water level available — as a fallback you may reuse the camera config's "
            f"reference level: --h_a {self.cam_config.gcps['h_ref']}"
        )
        raise click.Abort()

    # -- orchestration ---------------------------------------------------

    def process(self):
        """Run the stage table in order, honoring the ledger under --update."""
        self.logger.info("pipeline start")
        for spec in PIPELINE:
            if spec.name == "water_level" and self.cross_section_wl is None:
                continue
            if spec.optional and spec.name != "water_level" and spec.recipe_key not in self.recipe:
                if spec.name == "mask":
                    # downstream stages read the masked object; alias it
                    self.velocimetry_mask_obj = self.velocimetry_obj
                continue
            if spec.name == "transect" and self.cross_section_fn is not None:
                group = self.recipe["transect"].setdefault("transect_1", {})
                group["shapefile"] = self.cross_section_fn
            params = self.recipe.get(spec.recipe_key, {}) if spec.recipe_key else {}
            self._run_stage(spec, params)
        self.logger.info("pipeline finished")

    def _run_stage(self, spec: StageSpec, params: Dict):
        import time as _time

        tracked = [getattr(self, a) for a in spec.tracked_files]
        if spec.cached and self.update and self.ledger.is_current(
            spec.name, self.recipe, spec.config_keys, tracked
        ):
            # the literal word "skipping" is part of the log contract
            self.logger.info(f'stage "{spec.name}" unchanged since the last run — skipping')
            if spec.reload_attr is not None:
                fn = getattr(self, spec.reload_file)
                self.logger.info(f'stage "{spec.name}" restored from {os.path.abspath(fn)}')
                setattr(self, spec.reload_attr, ndx.open_dataset(fn))
            return
        if spec.name == "mask" and self.recipe.get("velocimetry", {}).get("get_piv", {}).get(
            "ensemble_corr", False
        ):
            self.logger.warning(
                "masking an ensemble-correlation result: time-dependent masks are inert"
            )
        self.logger.info(f'stage "{spec.name}" running')
        t0 = _time.perf_counter()
        try:
            getattr(self, spec.name)(**params)
        except (click.UsageError, click.Abort):
            raise
        except Exception as err:
            self.logger.error(f'stage "{spec.name}" failed: {err}')
            raise RuntimeError(f'Pipeline stage "{spec.name}" failed: {err}') from err
        if spec.config_keys:
            self.ledger.commit(spec.name, self.recipe, spec.config_keys, tracked)
        self.logger.info(f'stage "{spec.name}" done in {_time.perf_counter() - t0:.2f} s')

    # -- stage bodies ----------------------------------------------------

    def video(self, **kwargs):
        self.video_obj = Video(self.fn_video, camera_config=self.cam_config, **kwargs)
        self.logger.info(f"opened {self.fn_video}")

    def water_level(self, **kwargs):
        level = get_water_level(
            self.video_obj, cross_section=self.cross_section_wl, logger=self.logger, **kwargs
        )
        if level is None:
            self.logger.error("optical detection found no confident water level; supply --h_a")
            raise click.Abort()
        self.logger.info(f"optical water level: h = {level:1.3f} m (local datum)")
        self.video_obj.h_a = float(level)

    def frames(self, **kwargs):
        self.da_frames = self.video_obj.get_frames()
        self.logger.debug(f"{len(self.da_frames)} frames available")
        kwargs.setdefault("project", {})
        self.da_frames = apply_methods(
            self.da_frames, "frames", logger=self.logger,
            skip_args=["to_video", "to_geotiff"], **kwargs,
        )
        if "to_video" in kwargs:
            opts = kwargs["to_video"] or {}
            opts.setdefault("fn", os.path.join(self.output, self.prefix + "processed_frames.mp4"))
            self.logger.info(f"encoding preprocessed frames -> {opts['fn']}")
            self.da_frames.frames.to_video(**opts)
        if "to_geotiff" in kwargs:
            opts = kwargs["to_geotiff"] or {}
            opts.setdefault("frame", 0)
            opts.setdefault(
                "fn",
                os.path.join(self.output, self.prefix + "frame_{:04d}.tif".format(opts["frame"])),
            )
            self.logger.info(f"writing frame {opts['frame']} -> {opts['fn']}")
            self.da_frames.frames.to_geotiff(**opts)

    def velocimetry(self, method="get_piv", write=False, write_ugrid=False, fill_na=None, **kwargs):
        if len(kwargs) > 1:
            raise ValueError(
                f"The velocimetry section takes a single method; {len(kwargs)} were given."
            )
        call = kwargs or {method: {}}
        self.velocimetry_obj = apply_methods(self.da_frames, "frames", logger=self.logger, **call)
        name, params = next(iter(call.items()))
        self.logger.info(f"velocity field computed via {name}({params or {}})")
        if write:
            self.velocimetry_obj.to_netcdf(self.fn_piv)
            self.logger.info(f"velocity field -> {self.fn_piv}")
            self.velocimetry_obj = ndx.open_dataset(self.fn_piv)
        if write_ugrid:
            fn = self.fn_piv.replace(".nc", "_ugrid.nc")
            self.velocimetry_obj.velocimetry.to_ugrid(fill_na=fill_na).to_netcdf(fn)
            self.logger.info(f"UGRID mesh -> {fn}")

    def mask(self, write=False, write_ugrid=False, fill_na=None, **mask_groups):
        self.velocimetry_mask_obj = copy.deepcopy(self.velocimetry_obj)
        for group, methods in mask_groups.items():
            self.logger.debug(f"mask group {group}: {methods}")
            self.velocimetry_mask_obj.velocimetry.mask(
                get_masks(self.velocimetry_mask_obj, **(methods or {})), inplace=True
            )
        self.velocimetry_mask_obj.velocimetry.set_encoding()
        self.logger.info(f"{len(mask_groups)} mask group(s) applied")
        if write:
            self.velocimetry_mask_obj.to_netcdf(self.fn_piv_mask)
            self.logger.info(f"masked field -> {self.fn_piv_mask}")
        if write_ugrid:
            fn = self.fn_piv_mask.replace(".nc", "_ugrid.nc")
            self.velocimetry_mask_obj.velocimetry.to_ugrid(fill_na=fill_na).to_netcdf(fn)
            self.logger.info(f"masked UGRID mesh -> {fn}")

    def transect(self, write=False, **transect_groups):
        self.transects = {}
        for name, group in copy.deepcopy(transect_groups).items():
            self.logger.debug(f"transect {name}")
            source = group.get("geojson") or group.get("shapefile")
            if source is None:
                raise click.UsageError(
                    f'Transect "{name}" needs a "shapefile" or "geojson" entry.'
                )
            if "geojson" in group:
                coords, crs = cli_utils.read_shape(geojson=group["geojson"])
            else:
                coords, crs = cli_utils.read_shape(fn=group["shapefile"])
            if len(coords[0]) == 2:
                raise click.UsageError(
                    f'Transect "{name}" carries only (x, y); bathymetry needs z as well.'
                )
            x, y, z = zip(*coords)
            ds = self.velocimetry_mask_obj.velocimetry.get_transect(
                x=x, y=y, z=z, crs=crs, **(group.get("get_transect") or {})
            )
            if "get_q" in group:
                ds = ds.transect.get_q(**(group.get("get_q") or {}))
            if "get_river_flow" in group:
                if "get_q" not in group:
                    raise click.UsageError(
                        f'Transect "{name}" requests get_river_flow without get_q.'
                    )
                ds.transect.get_river_flow(**(group.get("get_river_flow") or {}))
            self.transects[name] = ds
            if write:
                fn = os.path.abspath(self.fn_transect_template(name))
                ds.to_netcdf(fn)
                self.logger.info(f"transect {name} -> {fn}")

    def stiv(self, write=False, **stiv_groups):
        """Space-Time Image Velocimetry groups (beyond-reference capability;
        the reference lists STIV as wished-for, reference ``README.md:22``).

        Each group names either explicit ``centers`` (projected-local metres,
        with a mandatory ``angle`` in radians from +x toward +y) or a
        ``shapefile``/``geojson`` line in CRS coordinates, which is resampled
        every ``distance`` metres (default: ``length``); the flow direction
        then defaults to the line's local perpendicular (to the right when
        walking the line) unless ``angle`` overrides it. Remaining keys pass
        through to :meth:`Frames.get_stiv` (length, n_samples, window,
        refine, min_coherence).
        """
        from ..geom import affine as aff

        self.stivs = {}
        frames = self.da_frames
        x = frames["x"].values
        y = frames["y"].values
        for name, group in copy.deepcopy(stiv_groups).items():
            group = group or {}
            if "length" not in group:
                raise click.UsageError(f'STIV group "{name}" needs a "length" entry (metres).')
            angle = group.pop("angle", None)
            if "centers" in group:
                centers = np.atleast_2d(np.asarray(group.pop("centers"), dtype=np.float64))
                if angle is None:
                    raise click.UsageError(
                        f'STIV group "{name}" gives explicit centers and must also give "angle".'
                    )
            else:
                source = group.pop("geojson", None) or group.pop("shapefile", None)
                if source is None:
                    raise click.UsageError(
                        f'STIV group "{name}" needs "centers", "shapefile" or "geojson".'
                    )
                if isinstance(source, dict):
                    coords, crs = cli_utils.read_shape(geojson=source)
                else:
                    coords, crs = cli_utils.read_shape(fn=source)
                xs = np.asarray([c[0] for c in coords], dtype=np.float64)
                ys = np.asarray([c[1] for c in coords], dtype=np.float64)
                if crs is not None and getattr(self.cam_config, "crs", None) is not None:
                    from ..geom import crs as crs_mod

                    pts = xyz_transform(
                        list(zip(xs, ys)), crs, crs_mod.CRS.from_user_input(self.cam_config.crs)
                    )
                    xs = np.asarray([p[0] for p in pts])
                    ys = np.asarray([p[1] for p in pts])
                distance = group.pop("distance", None) or float(group["length"])
                xs, ys, _ = helpers.xy_equidistant(xs, ys, distance)
                rows, cols = aff.map_to_pixel_float(xs, ys, self.cam_config.transform)
                cx = x[0] + cols * (x[1] - x[0])
                cy = y[0] + rows * (y[1] - y[0])
                centers = np.stack([cx, cy], axis=1)
                if angle is None:
                    direction = np.arctan2(cy[-1] - cy[0], cx[-1] - cx[0])
                    angle = float(direction - np.pi / 2)
            self.logger.debug(f"STIV group {name}: {len(centers)} lines, angle {angle:.3f} rad")
            ds = frames.frames.get_stiv(centers, angle=float(angle), **group)
            self.stivs[name] = ds
            n_ok = int(np.isfinite(np.asarray(ds["v"].values)).sum())
            self.logger.info(f"STIV {name}: {n_ok} finite velocities over {len(centers)} lines")
            if write:
                fn = os.path.abspath(os.path.join(self.output, self.prefix + f"stiv_{name}.nc"))
                ds.to_netcdf(fn)
                self.logger.info(f"STIV {name} -> {fn}")

    def plot(self, **plot_recipes):
        """One figure per entry: frames, velocimetry and transect layers over one axes.

        A layer's own ``mode`` wins over the entry's (default ``"local"``), as
        ``examples/recipe_template.yml`` writes it; the JAX package passes both
        and raises (ROADMAP.md, queue C)."""
        for name, params in copy.deepcopy(plot_recipes).items():
            if not isinstance(params, dict):
                continue
            self.logger.debug(f"composing figure {name}")
            mode = params.get("mode", "local")
            ax = None
            if "frames" in params:
                opts = params["frames"] or {}
                layer_mode = opts.pop("mode", mode)
                n = params.get("frame_number", 0)
                rgb = self.video_obj.get_frames(method="rgb")
                if layer_mode == "camera":
                    layer = rgb.isel(time=n)
                else:
                    layer = rgb.isel(time=slice(n, n + 1)).frames.project().isel(time=0)
                ax = layer.frames.plot(ax=ax, mode=layer_mode, **opts)
            if "velocimetry" in params:
                opts = vmin_vmax_to_norm(params["velocimetry"] or {})
                layer_mode = opts.pop("mode", mode)
                reducer = params.get("reducer", "mean")
                reduced = getattr(self.velocimetry_mask_obj, reducer)(
                    dim="time", **params.get("reducer_params", {})
                )
                reduced.attrs = dict(self.velocimetry_mask_obj.attrs)
                ax = reduced.velocimetry.plot(ax=ax, mode=layer_mode, **opts)
            if "transect" in params:
                for tname, topts in params["transect"].items():
                    topts = vmin_vmax_to_norm(topts or {})
                    layer_mode = topts.pop("mode", mode)
                    ds = ndx.open_dataset(self.fn_transect_template(tname))
                    dsq = ds.isel(quantile=topts.pop("quantile", 2))
                    dsq.attrs = dict(ds.attrs)
                    ax = dsq.transect.plot(ax=ax, mode=layer_mode, **topts)
            fn_jpg = os.path.join(self.output, self.prefix + name + ".jpg")
            ax.figure.savefig(fn_jpg, **params.get("write_pars", {}))
            self.logger.info(f"figure {name} -> {fn_jpg}")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _parse_camconfig_dict(cameraconfig: Dict) -> Dict:
    """Decode a camera-config dict whose values may arrive stringified."""
    literal_keys = {
        "height", "width", "resolution", "window_size", "is_nadir", "lens_position",
        "gcps", "rvec", "tvec", "dist_coeffs", "camera_matrix", "stabilize", "rotation",
    }
    out = {}
    for k, v in cameraconfig.items():
        if not (isinstance(v, str) and k in literal_keys):
            out[k] = v
            continue
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            import ast

            try:
                out[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                out[k] = v
    return out


def velocity_flow(**kwargs):
    """Build a processor from the kwargs and run the full pipeline."""
    VelocityFlowProcessor(**kwargs).process()


def velocity_flow_subprocess(
    videofile,
    recipe: dict,
    cameraconfig: dict,
    output: str,
    prefix: Optional[str] = None,
    h_a: Optional[float] = None,
    cross: Optional[dict] = None,
    cross_wl: Optional[dict] = None,
    update: bool = False,
    logger: logging.Logger = logging,
):
    """Run the pipeline in a child ``python -m pyorc_tpu_torch.cli.main velocimetry`` process.

    Inputs are serialized into ``output`` first (recipe YAML, camera-config
    JSON, optional cross-section GeoJSONs) so the child is fully
    self-contained — the embedding pattern external applications use.
    """
    logger.info(f"spawning pipeline subprocess for {videofile}")
    os.makedirs(output, exist_ok=True)
    fn_recipe = os.path.join(output, "recipe.yml")
    fn_cam_config = os.path.join(output, "camera_config.json")
    with open(fn_recipe, "w") as f:
        yaml.dump(recipe, f, default_flow_style=False, sort_keys=False)
    CameraConfig(**_parse_camconfig_dict(cameraconfig)).to_file(fn_cam_config)
    # the child runs this very package, installed or not: its root goes first on PYTHONPATH
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    argv = [sys.executable, "-m", "pyorc_tpu_torch.cli.main",
            "velocimetry", "-V", videofile, "-c", fn_cam_config, "-r", fn_recipe]
    if h_a is not None:
        argv += ["-h", str(h_a)]
    for flag, payload, fname in (("--cross", cross, "cross.geojson"),
                                 ("--cross_wl", cross_wl, "cross_wl.geojson")):
        if payload is None or (flag == "--cross_wl" and h_a is not None):
            continue
        fn = os.path.join(output, fname)
        with open(fn, "w") as f:
            json.dump(payload, f, indent=4)
        argv += [flag, fn]
    if update:
        argv.append("-u")
    if prefix:
        argv += ["-p", prefix]
    argv += ["-vvv", output]
    return subprocess.run(argv, cwd=os.path.dirname(output) or ".", capture_output=True, text=True, env=env)
