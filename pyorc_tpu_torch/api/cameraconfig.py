"""CameraConfig: the geometric core relating image pixels to world coordinates.

Re-implementation of the reference's camera configuration semantics
(reference ``pyorc/api/cameraconfig.py:24-1654``) on our own geometry stack
(:mod:`pyorc_tpu_torch.geom`): intrinsics, extrinsics via PnP on GCPs, water-level
datum conversions (z_0 / h_ref / h_a), AOI bounding box, orthorectification
index maps, and JSON (de)serialization. Reference camera-config JSON files
load unchanged.
"""

from __future__ import annotations

import copy
import json
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ..geom import affine as aff
from ..geom import aoi as aoi_mod
from ..geom import calibrate as calib
from ..geom import camera as cam
from ..geom import crs as crs_mod
from ..geom import shapes

__all__ = ["CameraConfig", "get_camera_config", "load_camera_config"]


def xyz_transform(points, crs_from, crs_to):
    """Transform [x, y(, z)] point lists between CRSs (z rides along). Reference pyorc/helpers.py:916-954."""
    points = np.array(points, dtype=np.float64)
    x_trans, y_trans = crs_mod.transform_points(crs_from, crs_to, points[:, 0], points[:, 1])
    assert not np.all(np.isinf(x_trans)), (
        "Transformation did not give valid results; check the provided crs of input coordinates."
    )
    points[:, 0] = np.atleast_1d(x_trans)
    points[:, 1] = np.atleast_1d(y_trans)
    return points.tolist()


class CameraConfig:
    """Camera configuration: perspective relating 2-D image to 3-D world coordinates."""

    def __init__(
        self,
        height: int,
        width: int,
        crs: Optional[Any] = None,
        window_size: Union[int, List[int]] = 10,
        resolution: float = 0.05,
        bbox: Optional[Union[shapes.Polygon, str]] = None,
        camera_matrix: Optional[List[List[float]]] = None,
        dist_coeffs: Optional[List[List[float]]] = None,
        lens_position: Optional[List[float]] = None,
        corners: Optional[List[List[float]]] = None,
        gcps: Optional[Dict[str, Union[List, float]]] = None,
        calibration_video: Optional[str] = None,
        is_nadir: Optional[bool] = False,
        stabilize: Optional[List[List]] = None,
        rotation: Optional[int] = None,
        rvec: Optional[List[float]] = None,
        tvec: Optional[List[float]] = None,
    ):
        assert isinstance(height, int), 'height must be provided as type "int"'
        assert isinstance(width, int), 'width must be provided as type "int"'
        # an int, or the (y, x) pair that get_piv with a non-square window writes
        # into its dataset's camera_config (the JAX package refuses that on reload:
        # ROADMAP.md, queue C)
        pair = isinstance(window_size, (list, tuple)) and len(window_size) == 2
        assert isinstance(window_size, int) or (pair and all(isinstance(w, int) for w in window_size)), (
            'window_size must be of type "int" or a pair of them'
        )
        self.height = height
        self.width = width
        self.is_nadir = is_nadir
        self.camera_matrix = camera_matrix
        self.dist_coeffs = dist_coeffs
        self.rvec = rvec
        self.tvec = tvec
        if crs is not None:
            crs_obj = crs_mod.CRS.from_user_input(crs)
            assert not crs_obj.is_geographic, "Provided crs must be projected with units like [m]"
            self.crs = crs_obj.to_wkt()
        if resolution is not None:
            self.resolution = resolution
        if lens_position is not None:
            self.set_lens_position(*lens_position)
        else:
            self.lens_position = None
        if gcps is not None:
            self.set_gcps(**gcps)
        if self.is_nadir:
            self.camera_matrix = calib.get_cam_mtx(self.height, self.width)
            self.dist_coeffs = calib.DIST_COEFFS
        else:
            self.calibrate()
        if calibration_video is not None:
            self.set_lens_calibration(calibration_video, plot=False)
        if bbox is not None:
            self.bbox = bbox
        if window_size is not None:
            self.window_size = window_size
        if corners is not None:
            self.set_bbox_from_corners(corners)
        if stabilize is not None:
            self.stabilize = stabilize
        if rotation is not None:
            self.rotation = rotation

    def __str__(self):
        return str(self.to_json())

    def __repr__(self):
        return self.to_json()

    # -- properties ----------------------------------------------------------------

    @property
    def bbox(self):
        return self._bbox

    @bbox.setter
    def bbox(self, pol):
        self._bbox = shapes.loads(pol) if isinstance(pol, str) else pol

    @property
    def camera_matrix(self):
        return self._camera_matrix

    @camera_matrix.setter
    def camera_matrix(self, camera_matrix):
        self._camera_matrix = camera_matrix.tolist() if isinstance(camera_matrix, np.ndarray) else camera_matrix

    @property
    def dist_coeffs(self):
        return self._dist_coeffs

    @dist_coeffs.setter
    def dist_coeffs(self, dist_coeffs):
        self._dist_coeffs = dist_coeffs.tolist() if isinstance(dist_coeffs, np.ndarray) else dist_coeffs

    @property
    def focal_length(self):
        if not self.camera_matrix:
            return None
        return self.camera_matrix[0][0]

    @property
    def k1(self):
        return self.dist_coeffs[0] if self.dist_coeffs else None

    @property
    def k2(self):
        return self.dist_coeffs[1] if self.dist_coeffs else None

    @property
    def gcps_dest(self) -> Optional[np.ndarray]:
        if hasattr(self, "gcps") and "dst" in self.gcps:
            return np.array(
                self.gcps["dst"]
                if len(self.gcps["dst"][0]) == 3
                else np.c_[self.gcps["dst"], np.ones(4) * self.gcps["z_0"]],
                dtype=np.float64,
            )
        return None

    @property
    def gcps_dest_bbox(self) -> np.ndarray:
        return np.array(aoi_mod.transform_to_bbox(self.gcps_dest, self.bbox, self.resolution))

    @property
    def gcps_bbox_reduced(self) -> np.ndarray:
        return self.gcps_dest_bbox - self.gcps_dest_bbox.mean(axis=0)

    @property
    def gcps_reduced(self) -> np.ndarray:
        return np.array(self.gcps_dest - self.gcps_mean)

    @property
    def gcps_mean(self) -> np.ndarray:
        return np.array([0.0, 0.0, 0.0]) if self.gcps_dest is None else np.array(self.gcps_dest).mean(axis=0)

    @property
    def gcps_dims(self) -> Optional[int]:
        return len(self.gcps["dst"][0]) if hasattr(self, "gcps") else None

    @property
    def is_nadir(self) -> bool:
        return self._is_nadir

    @is_nadir.setter
    def is_nadir(self, nadir_prop: bool):
        self._is_nadir = nadir_prop

    @property
    def pnp(self) -> Tuple[np.ndarray, np.ndarray]:
        """Pose from GCPs: PnP in reduced coordinates, shifted back to world (stable)."""
        _, rvec, tvec = cam.solve_pnp(self.gcps_reduced, self.gcps["src"], self.camera_matrix, self.dist_coeffs)
        rvec_cam, tvec_cam = cam.pose_world_to_camera(rvec, tvec)
        tvec_cam = tvec_cam + self.gcps_mean
        rvec, tvec = cam.pose_world_to_camera(rvec_cam, tvec_cam)
        return rvec, tvec

    @property
    def rvec(self):
        return self.pnp[0].tolist() if self._rvec is None else self._rvec

    @rvec.setter
    def rvec(self, _rvec):
        self._rvec = _rvec.tolist() if isinstance(_rvec, np.ndarray) else _rvec

    @property
    def tvec(self):
        return self.pnp[1].tolist() if self._tvec is None else self._tvec

    @tvec.setter
    def tvec(self, _tvec):
        self._tvec = _tvec.tolist() if isinstance(_tvec, np.ndarray) else _tvec

    @property
    def shape(self) -> Tuple[int, int]:
        """(rows, cols) of the projected frames."""
        cols, rows = aoi_mod.get_shape(self.bbox, resolution=self.resolution, round=1)
        return rows, cols

    @property
    def stabilize(self):
        return self._stabilize

    @stabilize.setter
    def stabilize(self, coords: List[List[float]]):
        self._stabilize = coords

    @property
    def rotation(self):
        return self._rotation if hasattr(self, "_rotation") else None

    @rotation.setter
    def rotation(self, rotation_code: int):
        self._rotation = rotation_code

    @property
    def transform(self) -> aff.Affine:
        return aoi_mod.get_transform(self.bbox, resolution=self.resolution)

    # -- calibration ----------------------------------------------------------------

    def set_lens_calibration(
        self,
        fn: str,
        chessboard_size: Tuple = (9, 6),
        max_imgs: int = 30,
        plot: bool = True,
        progress_bar: bool = True,
        **kwargs,
    ):
        """Calibrate camera_matrix/dist_coeffs from a chessboard video (Zhang's method)."""
        import os

        from ..io.calibration import calibrate_camera

        if not os.path.isfile(fn):
            raise FileNotFoundError(f"Video calibration file {fn} not found")
        camera_matrix, dist_coeffs = calibrate_camera(
            fn, chessboard_size, max_imgs, plot=plot, progress_bar=progress_bar, **kwargs
        )
        self.camera_matrix = camera_matrix
        self.dist_coeffs = dist_coeffs

    def estimate_lens_position(self):
        """Lens (camera centre) position in world coordinates from pose."""
        return cam.camera_position(np.array(self.rvec), np.array(self.tvec))

    def calibrate(self):
        """Derive camera_matrix/dist_coeffs from GCP reprojection fit; then pose."""
        if hasattr(self, "gcps") and (self.camera_matrix is None or self.dist_coeffs is None):
            if len(self.gcps["src"]) >= 4:
                self.camera_matrix, self.dist_coeffs, err = calib.optimize_intrinsic(
                    self.gcps["src"],
                    self.gcps_dest,
                    self.height,
                    self.width,
                    lens_position=self.lens_position,
                    camera_matrix=self.camera_matrix,
                    dist_coeffs=self.dist_coeffs,
                )
        if self.camera_matrix is not None and self.dist_coeffs is not None:
            rvec, tvec = self.get_extrinsic()
            self.rvec = rvec
            self.tvec = tvec

    def get_extrinsic(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.pnp

    # -- GCPs / lens ------------------------------------------------------------------

    def set_gcps(self, src: List[List], dst: List[List], z_0: float, h_ref: Optional[float] = None, crs=None):
        assert isinstance(src, list), "src must be a list of (x, y) or (x, y, z) coordinates"
        assert isinstance(dst, list), "dst must be a list of (x, y) or (x, y, z) coordinates"
        if np.array(dst).shape[1] == 2:
            assert len(src) in [2, 4], f"2 or 4 source points are expected in src, but {len(src)} were found"
            if len(src) == 4:
                assert len(dst) == 4, f"4 destination points are expected in dst, but {len(dst)} were found"
            else:
                assert len(dst) == 2, f"2 destination points are expected in dst, but {len(dst)} were found"
        else:
            assert len(src) == len(dst), f"src ({len(src)}) and dst ({len(dst)}) must be equal length"
            assert len(src) >= 6, f"for (x, y, z) points, at least 6 pairs must be available, got {len(src)}"
        if h_ref is not None:
            assert isinstance(h_ref, (float, int)), "h_ref must contain a float number"
        if z_0 is not None:
            assert isinstance(z_0, (float, int)), "z_0 must be provided as type float"
        if crs is not None:
            if not hasattr(self, "crs"):
                raise ValueError(
                    "CameraConfig does not contain a crs, so gcps also cannot contain a crs."
                )
            dst = xyz_transform(dst, crs, crs_mod.CRS.from_user_input(self.crs))
        if len(src) == 2:
            self.is_nadir = True
            src, dst = _gcps_2_to_4(src, dst, self.width, self.height)
        if h_ref is None:
            h_ref = 0.0
        self.gcps = {"src": src, "dst": dst, "h_ref": h_ref, "z_0": z_0}

    def set_lens_position(self, x: float, y: float, z: float, crs=None):
        if crs is not None:
            if getattr(self, "crs", None) is None:
                raise ValueError("CameraConfig does not contain a crs")
            x, y = xyz_transform([[x, y]], crs, crs_mod.CRS.from_user_input(self.crs))[0]
        self.lens_position = [x, y, z]

    # -- water level datum ------------------------------------------------------------

    def z_to_h(self, z: float) -> float:
        h_ref = 0 if self.gcps["h_ref"] is None else self.gcps["h_ref"]
        return z + h_ref - self.gcps["z_0"]

    def h_to_z(self, h_a: float) -> float:
        h_ref = 0 if self.gcps["h_ref"] is None else self.gcps["h_ref"]
        return h_a - h_ref + self.gcps["z_0"]

    def get_z_a(self, h_a: Optional[float] = None) -> float:
        if h_a is None:
            return self.gcps["z_0"]
        return self.gcps["z_0"] + (h_a - self.gcps["h_ref"])

    def get_depth(self, z, h_a: Optional[float] = None) -> np.ndarray:
        if h_a is None:
            h_a = self.gcps["h_ref"]
        z = np.asarray(z, dtype=np.float64)
        z_pressure = np.maximum(self.gcps["z_0"] - self.gcps["h_ref"] + h_a, z)
        return z_pressure - z

    def get_dist_shore(self, x, y, z, h_a: Optional[float] = None) -> np.ndarray:
        depth = self.get_depth(z, h_a=h_a)
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        z_dry = depth <= 0
        z_dry[[0, -1]] = True
        return np.array(
            [(((x[z_dry] - _x) ** 2 + (y[z_dry] - _y) ** 2) ** 0.5).min() for _x, _y in zip(x, y)]
        )

    def get_dist_wall(self, x, y, z, h_a: Optional[float] = None) -> np.ndarray:
        depth = self.get_depth(z, h_a=h_a)
        dist_shore = self.get_dist_shore(x, y, z, h_a=h_a)
        return (dist_shore**2 + depth**2) ** 0.5

    # -- projection ------------------------------------------------------------------

    def project_points(self, points, within_image=False, swap_y_coords=False) -> np.ndarray:
        """World [x, y, z] -> image [col, row], NaN behind camera if within_image."""
        rvec, tvec = np.array(self.rvec, dtype=np.float64), np.array(self.tvec, dtype=np.float64)
        points = np.array(points, dtype=np.float64).reshape(-1, 3)
        points_proj = cam.project_points(points, rvec, tvec, np.array(self.camera_matrix), np.array(self.dist_coeffs))
        if within_image:
            points_proj[points_proj[:, 0] < 0, 0] = -1.0
            points_proj[points_proj[:, 0] > self.width - 1, 0] = self.width
            points_proj[points_proj[:, 1] < 0, 1] = -1.0
            points_proj[points_proj[:, 1] > self.height - 1, 1] = self.height
            points_camera = cam.world_to_camera(points, rvec, tvec)
            behind_camera = points_camera[:, 2] <= 0.0
            points_proj[behind_camera, :] = np.nan
        if swap_y_coords:
            points_proj[:, 1] = self.height - points_proj[:, 1]
        return points_proj

    def project_grid(self, xs, ys, zs, swap_y_coords=False) -> Tuple[np.ndarray, np.ndarray]:
        points = np.column_stack([xs.flatten(), ys.flatten(), zs.flatten()])
        points_proj = self.project_points(points, swap_y_coords=swap_y_coords)
        xp = np.reshape(points_proj[:, 0], (len(xs), -1))
        yp = np.reshape(points_proj[:, 1], (len(xs), -1))
        return xp, yp

    def unproject_points(self, points, zs) -> np.ndarray:
        rvec, tvec = np.array(self.rvec, dtype=np.float64), np.array(self.tvec, dtype=np.float64)
        return cam.unproject_to_plane(
            np.array(points, dtype=np.float64),
            zs,
            rvec,
            tvec,
            np.asarray(self.camera_matrix, dtype=np.float64),
            np.asarray(self.dist_coeffs, dtype=np.float64) if self.dist_coeffs is not None else None,
        )

    # -- bbox ------------------------------------------------------------------

    def get_bbox(
        self,
        camera: bool = False,
        mode: str = "geographical",
        h_a: Optional[float] = None,
        z_a: Optional[float] = None,
        within_image: bool = False,
        expand_exterior: bool = True,
        exterior_split: int = 400,
    ) -> shapes.Polygon:
        """Bounding box in geographical, camera, or 3-D perspective."""
        if camera:
            warnings.warn(
                "The camera=True option is deprecated, use mode='camera' instead.",
                DeprecationWarning,
                stacklevel=2,
            )
            mode = "camera"
        bbox = self.bbox
        coords = np.array(bbox.exterior.coords)
        if within_image:
            expand_exterior = True
        if expand_exterior:
            coords_expand = np.zeros((0, 2))
            for n in range(0, len(coords) - 1):
                new_coords = np.linspace(coords[n], coords[n + 1], exterior_split // 4)
                coords_expand = np.r_[coords_expand, new_coords]
            coords = coords_expand
        if not z_a:
            z_a = self.get_z_a(h_a)
        coords = np.c_[coords, np.ones(len(coords)) * z_a]
        corners = self.project_points(coords, within_image=within_image)
        corners = corners[np.isfinite(corners[:, 0])]
        if not mode == "camera":
            corners = self.unproject_points(corners, z_a)
        if mode == "3d":
            return shapes.Polygon(corners[np.isfinite(corners[:, 0])])
        return shapes.Polygon(corners[np.isfinite(corners[:, 0])][:, 0:2])

    def set_bbox_from_corners(self, corners: List[List[float]]):
        assert np.array(corners).shape == (4, 2), (
            f"a list of lists of 4 coordinates must be given, resulting in (4, 2) shape. "
            f"Current shape is {np.array(corners).shape}"
        )
        assert self.gcps["z_0"] is not None, "The water level must be set before the bounding box."
        corners_xyz = self.unproject_points(corners, np.ones(4) * self.gcps["z_0"])
        self.bbox = aoi_mod.get_aoi(corners_xyz, resolution=self.resolution)

    def set_bbox_from_width_length(self, points: List[List[float]]):
        assert np.array(points).shape == (3, 2), (
            f"a list of lists of 3 coordinates must be given, resulting in (3, 2) shape. "
            f"Current shape is {np.array(points).shape}"
        )
        assert self.gcps["z_0"] is not None, "The water level must be set before the bounding box."
        points_xyz = self.unproject_points(points, np.ones(3) * self.gcps["z_0"])
        self.bbox = aoi_mod.get_aoi(points_xyz, resolution=self.resolution, method="width_length")

    def rotate_translate_bbox(
        self,
        angle: Optional[float] = None,
        xoff: Optional[float] = None,
        yoff: Optional[float] = None,
        x_add: Optional[float] = None,
        y_add: Optional[float] = None,
    ) -> "CameraConfig":
        """Rotate/translate/grow the bounding box; returns a new config."""
        new_config = copy.deepcopy(self)
        bbox = new_config.bbox
        if bbox is None:
            return new_config
        if angle is not None:
            bbox = shapes.rotate(bbox, angle, origin="centroid", use_radians=True)
        coords = list(bbox.exterior.coords)
        p1 = np.array(coords[0])
        p2 = np.array(coords[1])
        p3 = np.array(coords[2])
        x_vec = (p2 - p1) / np.linalg.norm(p2 - p1)
        y_vec = (p3 - p2) / np.linalg.norm(p3 - p2)
        dx = 0 if xoff is None else xoff * x_vec[0]
        dy = 0 if xoff is None else xoff * x_vec[1]
        dx -= 0 if yoff is None else yoff * y_vec[0]
        dy -= 0 if yoff is None else yoff * y_vec[1]
        bbox = shapes.translate(bbox, xoff=dx, yoff=dy)
        if x_add is not None:
            coords = list(bbox.exterior.coords)
            l1 = shapes.LineString(coords[0:2])
            l2 = shapes.LineString(coords[2:4])
            fact = (l1.length + x_add) / l1.length
            l1_s = shapes.scale(l1, xfact=fact, yfact=fact, origin="center")
            l2_s = shapes.scale(l2, xfact=fact, yfact=fact, origin="center")
            bbox = shapes.Polygon(list(l1_s.coords) + list(l2_s.coords))
        if y_add is not None:
            coords = list(bbox.exterior.coords)
            l1 = shapes.LineString([coords[0], coords[3]])
            l2 = shapes.LineString([coords[1], coords[2]])
            fact = (l1.length + y_add) / l1.length
            l1_s = shapes.scale(l1, xfact=fact, yfact=fact, origin="center")
            l2_s = shapes.scale(l2, xfact=fact, yfact=fact, origin="center")
            new_coords = list(l1_s.coords) + list(l2_s.coords)
            new_coords = [new_coords[0], new_coords[2], new_coords[3], new_coords[1]]
            bbox = shapes.Polygon(new_coords)
        new_config.bbox = bbox
        return new_config

    def rotate(self, pts_old, pts_new) -> Tuple["CameraConfig", np.ndarray]:
        """Correct pose for a small camera rotation from matched point pairs."""
        rvec_increment, error = calib.find_rotation_points(
            pts_old, pts_new, np.asarray(self.camera_matrix), self.dist_coeffs
        )
        rvec_new, tvec_new = calib.rotate_pose(self.rvec, self.tvec, rvec_increment)
        new_config = copy.deepcopy(self)
        new_config.rvec = rvec_new
        new_config.tvec = tvec_new
        dst = new_config.gcps["dst"]
        dst3 = np.asarray(new_config.gcps_dest, dtype=np.float64)
        src_new = new_config.project_points(dst3)
        new_config.gcps["src"] = src_new.tolist()
        del dst
        return new_config, error

    # -- homographies / ortho maps ------------------------------------------------------

    def get_M(self, h_a: Optional[float] = None, to_bbox_grid: bool = False, reverse: bool = False) -> np.ndarray:
        """Plane homography for water level h_a (on undistorted image coords)."""
        src = cam.undistort_points(self.gcps["src"], np.asarray(self.camera_matrix), self.dist_coeffs)
        dst_a = self.gcps_bbox_reduced if to_bbox_grid else self.gcps_reduced
        z_a = self.get_z_a(h_a) - self.gcps_mean[-1]
        _, rvec, tvec = cam.solve_pnp(dst_a, src, np.asarray(self.camera_matrix), np.zeros(5))
        return cam.homography_from_pose(rvec, tvec, np.asarray(self.camera_matrix), z=z_a, reverse=reverse)

    def map_idx_img_ortho(self, x, y, z) -> Tuple[np.ndarray, np.ndarray]:
        """Nearest-neighbour index map world grid <- image. Reference cameraconfig.py:739-791."""
        cols, rows = np.meshgrid(np.arange(len(x)), np.arange(len(y)))
        xs, ys = aff.pixel_to_map(cols.flatten(), rows.flatten(), self.transform)
        points_cam = self.project_points(np.column_stack([xs, ys, np.ones(len(xs)) * z]))
        points_cam = np.int64(np.round(points_cam))
        idx_ortho = np.all(
            [
                points_cam[:, 0] > 0,
                points_cam[:, 0] < self.width,
                points_cam[:, 1] > 0,
                points_cam[:, 1] < self.height,
            ],
            axis=0,
        )
        if idx_ortho.sum() == 0:
            warnings.warn(
                f"The water level is either very low or high compared to the reference water level. "
                f"No pixels in the objective fit in the area of interest "
                f"(water level difference: {z - self.gcps['z_0']}).",
                stacklevel=2,
            )
        idx_img = np.array(points_cam[idx_ortho, 1]) * self.width + np.array(points_cam[idx_ortho, 0])
        return idx_img, idx_ortho

    def map_mean_idx_img_ortho(self, x, y, z) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Group-mean index map for oversampled ortho cells. Reference cameraconfig.py:793-860."""
        coli, rowi = np.meshgrid(np.arange(self.width), np.arange(self.height))
        poly = self.get_bbox(mode="camera", z_a=z)
        ring = np.asarray(poly.exterior.coords, dtype=np.float64)
        ring = ring[np.isfinite(ring).all(axis=1)]
        mask = shapes.fill_polygon((self.height, self.width), np.round(ring).astype(np.int32))
        src_pix = np.column_stack([coli[mask], rowi[mask]])
        if len(src_pix) == 0:
            return np.array([], dtype=np.int64), np.array([], dtype=np.int64), np.array([], dtype=np.int64)
        dst_pix = self.unproject_points(src_pix, z)
        x_pix, y_pix = dst_pix[:, 0], dst_pix[:, 1]
        idx_y, idx_x = aff.map_to_pixel(x_pix, y_pix, self.transform)
        idx_inside = np.all([idx_y >= 0, idx_y < len(y), idx_x >= 0, idx_x < len(x)], axis=0)
        idx_x = idx_x[idx_inside]
        idx_y = idx_y[idx_inside]
        idx = np.array(idx_y) * len(x) + np.array(idx_x)
        src_pix_sel = src_pix[idx_inside]
        uidx, counts = np.unique(idx, return_counts=True)
        valid_idx = uidx[counts > 1]
        sel_mask = np.isin(idx, valid_idx)
        src_pix_sel = src_pix_sel[sel_mask]
        src_idx = src_pix_sel[:, 1] * self.width + src_pix_sel[:, 0]
        filtered_idx = idx[sel_mask]
        uidx, norm_idx = np.unique(filtered_idx, return_inverse=True)
        return src_idx, uidx, norm_idx

    # -- serialization ------------------------------------------------------------------

    # -- plotting (reference cameraconfig.py:1297-1599) ------------------------------

    def plot_bbox(
        self, ax=None, camera: bool = False, mode: str = "geographical",
        transformer=None, h_a: Optional[float] = None, within_image: bool = True, **kwargs,
    ):
        """Plot the area-of-interest bounding box in geographical or camera view."""
        import matplotlib.pyplot as plt

        if camera:
            mode = "camera"
        if ax is None:
            _, ax = plt.subplots()
        if mode == "camera":
            bbox = self.get_bbox(mode="camera", h_a=h_a, within_image=within_image)
        else:
            bbox = self.bbox
        bx, by = bbox.exterior.xy
        bx, by = np.asarray(bx), np.asarray(by)
        if transformer is not None:
            bx, by = transformer(bx, by)
        ax.plot(bx, by, **({"color": "k"} | kwargs))
        return ax

    def plot(
        self, figsize=(13, 8), ax=None, tiles=None, buffer: float = 0.0005,
        zoom_level: int = 19, camera: bool = False, mode: str = "geographical",
        pose_length: float = 1.0, tiles_kwargs=None,
    ):
        """Overview plot of the camera configuration: GCPs, bbox, lens position.

        ``mode``: "geographical" (world x/y), "camera" (image pixels) or "3d"
        (world with camera pose axes). Basemap ``tiles`` need cartopy, which is
        not bundled; the argument is accepted and ignored with a warning.
        """
        import matplotlib.pyplot as plt

        if camera:
            mode = "camera"
        if tiles is not None:
            warnings.warn("Basemap tiles require cartopy, which is not available; plotting without.", stacklevel=2)
        if mode == "3d":
            if ax is None:
                fig = plt.figure(figsize=figsize)
                ax = fig.add_subplot(projection="3d")
            dst = np.asarray(self.gcps["dst"], dtype=np.float64)
            zs = dst[:, 2] if dst.shape[1] > 2 else np.full(len(dst), self.gcps.get("z_0") or 0.0)
            ax.scatter(dst[:, 0], dst[:, 1], zs, c="r", marker="+", label="GCPs")
            self.plot_3d_pose(ax=ax, length=pose_length)
            ax.legend()
            return ax
        if ax is None:
            _, ax = plt.subplots(figsize=figsize)
        if mode == "camera":
            src = np.asarray(self.gcps["src"], dtype=np.float64)
            ax.plot(src[:, 0], src[:, 1], "r+", markersize=12, label="GCPs (src)")
            self.plot_bbox(ax=ax, mode="camera", color="c", label="AOI")
            ax.set_xlim(0, self.width)
            ax.set_ylim(self.height, 0)
        else:
            dst = self.gcps_dest
            if dst is not None:
                dst = np.asarray(dst)
                ax.plot(dst[:, 0], dst[:, 1], "r+", markersize=12, label="GCPs")
            self.plot_bbox(ax=ax, label="bbox")
            if self.lens_position is not None:
                ax.plot(self.lens_position[0], self.lens_position[1], "b^", label="lens position")
            ax.axis("equal")
        ax.legend()
        return ax

    def plot_3d_pose(self, ax=None, length: float = 1):
        """Draw the camera's pose axes (x red, y green, z blue) in world coords."""
        import matplotlib.pyplot as plt

        if ax is None:
            fig = plt.figure()
            ax = fig.add_subplot(projection="3d")
        rvec = np.asarray(self.rvec, dtype=np.float64).reshape(3)
        tvec = np.asarray(self.tvec, dtype=np.float64).reshape(3)
        rot = cam.rodrigues(rvec)
        # camera centre in world coordinates: C = -R^T t
        center = -rot.T @ tvec
        handles = []
        for axis_vec, color in zip(np.eye(3), ("r", "g", "b")):
            world_dir = rot.T @ axis_vec
            handles.append(
                ax.quiver(
                    center[0], center[1], center[2],
                    world_dir[0], world_dir[1], world_dir[2],
                    length=length, color=color,
                )
            )
        ax.scatter(*center, c="k", marker="^")
        return handles

    def to_dict(self) -> Dict:
        d = copy.deepcopy(self.__dict__)
        for k in list(d.keys()):
            if k[0] == "_":
                d[k[1:]] = d.pop(k)
        return d

    def to_dict_str(self) -> Dict:
        d = self.to_dict()
        return {k: v if not isinstance(v, shapes.Polygon) else str(v) for k, v in d.items()}

    def to_file(self, fn: str):
        with open(fn, "w") as f:
            f.write(self.to_json())

    def to_json(self) -> str:
        return json.dumps(self, default=lambda o: o.to_dict_str(), indent=4)


def _gcps_2_to_4(src, dst, img_width, img_height):
    """Expand 2 nadir GCPs into 4 corner GCPs via a similarity fit. Reference pyorc/cv.py:372-408."""
    _src = [[x, img_height - y] for x, y in src]
    M = cam.estimate_affine_partial_2d(np.array(_src), np.array(dst))
    M3 = np.vstack([M, [0, 0, 1]])
    corners = [[0, 0], [img_width, 0], [img_width, img_height], [0, img_height]]
    dst = cam.perspective_transform(np.float64(corners), M3).tolist()
    src = [[x, img_height - y] for x, y in corners]
    return src, dst


_DEPR_WARNING = """
Your camera configuration does not have a property "height" and/or "width"; it is probably
from an older < 0.3.0 format. Add "height" and "width" keys to the .json config file.
"""


def get_camera_config(s: str) -> CameraConfig:
    """Construct a CameraConfig from a JSON string (reference format, unchanged)."""
    d = json.loads(s)
    if "height" not in d or "width" not in d:
        raise IOError(_DEPR_WARNING)
    if "bbox" in d and isinstance(d["bbox"], str):
        d["bbox"] = shapes.loads(d["bbox"])
    return CameraConfig(**d)


def load_camera_config(fn: str) -> CameraConfig:
    """Load a CameraConfig from a JSON file."""
    with open(fn, "r") as f:
        return get_camera_config(f.read())
