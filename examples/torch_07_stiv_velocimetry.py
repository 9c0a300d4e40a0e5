"""Space-Time Image Velocimetry (STIV) with the PyTorch/CUDA port.

The port's counterpart of ``07_stiv_velocimetry.py``: pixels are sampled
along flow-aligned search lines, stacked over time into space-time images,
and the dominant streak angle, from a closed-form structure-tensor
eigen-analysis, gives the streamwise velocity per line
(:mod:`pyorc_tpu_torch.ops.stiv`, PyTorch ops on the card).

This example renders a synthetic river whose surface texture advects at a
KNOWN velocity, then recovers it three ways:

1. ``Frames.get_stiv`` with one velocity per search line,
2. the windowed profile mode (velocity as a function of position along
   each line),
3. the recipe/service route of ``python -m pyorc_tpu_torch.cli.main
   velocimetry``, with a ``stiv:`` section, on the reference's Geul sample
   clip when its folder is given (``dk_control.mp4`` and
   ``dk_cam_config.json``; the clip is not in this repository).

Run:  python examples/torch_07_stiv_velocimetry.py [geul_sample_dir]
(``PYORC_TPU_TORCH_DEVICE=cpu`` runs it without a card.)
"""

import json
import os
import sys

import numpy as np

RES = 0.02  # m/px of the projected grid
FPS = 25.0
V_TRUE = 0.5  # m/s, toward +x


def synthetic_projected_frames():
    """A projected frames DataArray whose texture advects at V_TRUE m/s."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    from pyorc_tpu_torch import ndx

    rng = np.random.default_rng(7)
    h, w, t_len = 128, 256, 40
    base = gaussian_filter(rng.normal(size=(h, w * 2)), 2.0)
    yy, xg = np.mgrid[0:h, 0:w].astype(float)
    vpx = V_TRUE / RES / FPS  # px/frame
    frames = np.stack(
        [map_coordinates(base, [yy, xg - vpx * t + w / 2], order=1, mode="wrap") for t in range(t_len)]
    ).astype(np.float32)

    x = (np.arange(w) + 0.5) * RES
    y = ((np.arange(h) + 0.5) * RES)[::-1]
    xs, ys = np.meshgrid(x, y)
    cc = {"height": h, "width": w, "resolution": RES, "window_size": 32}
    return ndx.DataArray(
        frames,
        dims=("time", "y", "x"),
        coords={"time": np.arange(t_len) / FPS, "y": y, "x": x,
                "xs": (("y", "x"), xs), "ys": (("y", "x"), ys)},
        attrs={"camera_config": json.dumps(cc), "camera_shape": str([h, w])},
        name="frames",
    )


def main(geul_dir=None) -> dict:
    da = synthetic_projected_frames()
    w_m = float(da["x"].values[-1] + RES / 2)
    h_m = float(da["y"].values[0] + RES / 2)

    # 1. one velocity per search line, lines spread across the "river"
    centers = np.array([[w_m / 2, h_m * f] for f in (0.3, 0.5, 0.7)])
    ds = da.frames.get_stiv(centers, angle=0.0, length=3.0, min_coherence=0.4)
    v = np.asarray(ds["v"].values)
    coh = np.asarray(ds["coherence"].values)
    print(f"true velocity        : {V_TRUE:.3f} m/s")
    print(f"STIV per-line        : {np.round(v, 3)} m/s  (coherence {np.round(coh, 2)})")
    assert np.all(np.abs(v - V_TRUE) < 0.05 * V_TRUE), "STIV missed the synthetic truth"

    # 2. profile mode: velocity along each line, averaged over 16-sample boxes
    prof = da.frames.get_stiv(centers[:1], angle=0.0, length=4.0, window=16)
    vp = np.asarray(prof["v"].values)
    print(f"STIV profile         : {vp.shape[1]} points, spread {np.nanstd(vp):.4f} m/s")
    assert np.nanstd(vp) < 0.1 * V_TRUE

    # 3. the service/recipe route on the Geul sample clip, with a `stiv:` recipe
    #    section resampling search lines along a cross-section geojson
    run_stiv_recipe(geul_dir)
    print("STIV example OK")
    return {"v": v.tolist(), "coherence": coh.tolist(), "profile_std": float(np.nanstd(vp))}


def run_stiv_recipe(geul_dir):
    """Execute the `stiv:` recipe stage through the port's service pipeline."""
    import tempfile

    import pyorc_tpu_torch
    from pyorc_tpu_torch.cli import cli_utils
    from pyorc_tpu_torch.service import velocity_flow

    video = os.path.join(geul_dir or "", "dk_control.mp4")
    cfg = os.path.join(geul_dir or "", "dk_cam_config.json")
    if geul_dir is None or not os.path.isfile(video):
        print("geul sample data not given — skipping the recipe run")
        return

    # a straight cross-section spanning the AOI, written as geojson the way a
    # user would supply one (`shapefile:` in the YAML recipe)
    cc = pyorc_tpu_torch.load_camera_config(cfg)
    corners = np.asarray(cc.bbox.exterior.coords)
    p_left, p_right = (corners[0] + corners[1]) / 2, (corners[2] + corners[3]) / 2
    xs, ys = np.linspace(p_left[0], p_right[0], 9), np.linspace(p_left[1], p_right[1], 9)
    gj = {
        "type": "FeatureCollection",
        "crs": {"type": "name", "properties": {"name": "urn:ogc:def:crs:EPSG::28992"}},
        "features": [
            {"type": "Feature", "properties": {},
             "geometry": {"type": "Point", "coordinates": [float(x), float(y), float(cc.gcps["z_0"])]}}
            for x, y in zip(xs, ys)
        ],
    }
    with tempfile.TemporaryDirectory() as out:
        cross_fn = os.path.join(out, "cross.geojson")
        with open(cross_fn, "w") as f:
            json.dump(gj, f)
        recipe = cli_utils.validate_recipe({
            "video": {"start_frame": 0, "end_frame": 6, "h_a": 92.36},
            "frames": {"normalize": {"samples": 2}},
            "velocimetry": {"get_piv": {"window_size": 32}, "write": True},
            "stiv": {
                "write": True,
                "left_to_right": {"shapefile": cross_fn, "length": 2.0, "distance": 1.0},
            },
        })
        camconfig = cli_utils.parse_camconfig(None, None, cfg)
        velocity_flow(
            recipe=recipe, videofile=video, cameraconfig=camconfig,
            prefix="", output=out, h_a=92.36,
        )
        fn = os.path.join(out, "stiv_left_to_right.nc")
        assert os.path.isfile(fn), "stiv recipe stage wrote no netCDF"
        ds = pyorc_tpu_torch.open_dataset(fn)
        v = np.asarray(ds["v"].values)
        coh = np.asarray(ds["coherence"].values)
        assert np.isfinite(v).any(), "stiv recipe produced no finite velocities"
        print(f"recipe `stiv:` stage -> {os.path.basename(fn)}: "
              f"{np.isfinite(v).sum()}/{v.size} finite v, coherence "
              f"{np.nanmin(coh):.2f}-{np.nanmax(coh):.2f}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
