"""Self-contained end-to-end demo with the PyTorch/CUDA port: synthetic river video -> discharge.

The port's counterpart of ``demo.py``. It GENERATES a video: a
particle-textured "river" advecting at a known speed, georeferenced with a
nadir camera, and pushes it through the full pipeline of
``pyorc_tpu_torch`` — decode, normalization, orthorectification, PIV,
masking, transect sampling, discharge — through the Python API and through
the recipe-driven service, with ``demo.py``'s recipe.

The clip is written as ``Frames.to_video`` chooses its writer: H.264 through
the native writer where it builds (``native/decoder.cpp`` needs FFmpeg's
headers), else lossless FFV1 through OpenCV. The netCDF files are written
where h5py is installed; without it the results stay in memory.

Run:  python examples/torch_demo.py [output_dir]
(``PYORC_TPU_TORCH_DEVICE=cpu`` runs it without a card.)
"""

import importlib.util
import json
import os
import sys

import numpy as np

H_IMG, W_IMG = 480, 640
FPS = 6.25
RES = 0.01  # m/px at the water plane
DX_PIX, DY_PIX = 2.0, -1.0  # image-space advection per frame
N_FRAMES = 16


def render_frames() -> np.ndarray:
    """uint8 [N_FRAMES, H_IMG, W_IMG]: a particle texture Fourier-shifted (DX_PIX, DY_PIX) px a frame."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(7)
    img = np.zeros((H_IMG, W_IMG))
    n_particles = 9000
    xs = rng.uniform(0, W_IMG - 1, n_particles)
    ys = rng.uniform(0, H_IMG - 1, n_particles)
    np.add.at(img, (ys.astype(int), xs.astype(int)), rng.uniform(0.5, 1.0, n_particles))
    img = gaussian_filter(img, 1.2, mode="wrap")
    img = img / img.max() * 220 + 20
    fy = np.fft.fftfreq(H_IMG)[:, None]
    fx = np.fft.fftfreq(W_IMG)[None, :]
    F = np.fft.fft2(img)
    frames = []
    for i in range(N_FRAMES):
        shift = np.exp(-2j * np.pi * (fy * DY_PIX * i + fx * DX_PIX * i))
        frames.append(np.clip(np.real(np.fft.ifft2(F * shift)), 0, 255).astype(np.uint8))
    return np.stack(frames)


def make_video(out_dir: str) -> str:
    """Write the clip into ``out_dir``; returns its path."""
    from pyorc_tpu_torch.io import native_decoder

    frames = render_frames()
    if native_decoder.encoder_available():
        fn = os.path.join(out_dir, "demo.mp4")
        with native_decoder.NativeVideoWriter(fn, W_IMG, H_IMG, fps=FPS, channels=1, crf=14) as wr:
            for frame in frames:
                wr.write(frame)
        return fn
    import cv2

    fn = os.path.join(out_dir, "demo.avi")
    out = cv2.VideoWriter(fn, cv2.VideoWriter_fourcc(*"FFV1"), FPS, (W_IMG, H_IMG), isColor=False)
    if not out.isOpened():
        raise IOError(f"neither the native writer nor OpenCV's FFV1 can write {fn}")
    try:
        for frame in frames:
            out.write(np.ascontiguousarray(frame))
    finally:
        out.release()
    return fn


def make_camera_config():
    import pyorc_tpu_torch

    f = 1000.0
    src = [[60, 60], [580, 60], [580, 420], [60, 420]]
    dst = [[RES * c, RES * (H_IMG - r)] for c, r in src]
    cc = pyorc_tpu_torch.CameraConfig(
        height=H_IMG,
        width=W_IMG,
        resolution=RES,
        window_size=32,
        gcps={"src": src, "dst": dst, "h_ref": 0.0, "z_0": 0.0},
        camera_matrix=[[f, 0.0, W_IMG / 2], [0.0, f, H_IMG / 2], [0.0, 0.0, 1.0]],
        dist_coeffs=[[0.0]] * 5,
        stabilize=None,
    )
    cc.set_bbox_from_corners([[100, 100], [540, 100], [540, 380], [100, 380]])
    return cc


def main(out_dir: str = "demo_out") -> dict:
    import pyorc_tpu_torch

    write = importlib.util.find_spec("h5py") is not None
    os.makedirs(out_dir, exist_ok=True)
    cam_fn = os.path.join(out_dir, "camera_config.json")
    print("rendering synthetic river video...")
    video_fn = make_video(out_dir)
    cc = make_camera_config()
    cc.to_file(cam_fn)

    print(f"running the API pipeline on {pyorc_tpu_torch.get_device()}...")
    video = pyorc_tpu_torch.Video(video_fn, camera_config=cc, start_frame=0, end_frame=N_FRAMES - 2, h_a=0.0)
    da = video.get_frames().frames.normalize(samples=4)
    proj = da.frames.project()
    piv = proj.frames.get_piv(window_size=32)
    masked = piv.velocimetry.mask([piv.velocimetry.mask.corr(), piv.velocimetry.mask.count()])

    # transect across the flow with a parabolic bed
    coords = np.asarray(cc.bbox.exterior.coords)
    p_left = (coords[0] + coords[1]) / 2
    p_right = (coords[2] + coords[3]) / 2
    n = 15
    xs = np.linspace(p_left[0], p_right[0], n)
    ys = np.linspace(p_left[1], p_right[1], n)
    t = np.linspace(-1, 1, n)
    zs = -0.05 - 0.3 * (1 - t**2)
    tr = masked.velocimetry.get_transect(xs, ys, zs, wdw=1)
    tr = tr.transect.get_q(fill_method="interpolate")
    tr.transect.get_river_flow()
    q = np.asarray(tr["river_flow"].values)
    v_expected = float(np.hypot(DX_PIX, DY_PIX) * RES * FPS)
    v_measured = float(np.nanmedian(np.hypot(masked["v_x"].values, masked["v_y"].values)))
    print(f"surface speed: measured {v_measured:.3f} m/s (true {v_expected:.3f} m/s)")
    print(f"discharge quantiles [m3/s]: {np.round(q, 3)}")
    # single-pass PIV reads this lossy clip low (demo.py reads the same 0.117 m/s); the checks are that
    # the chain gives a forward flow with a finite discharge, and that the service reproduces the API
    assert 0 < v_measured < v_expected and np.isfinite(q).all() and np.all(q > 0), (v_measured, q)
    if write:
        masked.to_netcdf(os.path.join(out_dir, "piv_masked.nc"))
        tr.to_netcdf(os.path.join(out_dir, "transect.nc"))
    else:
        print("h5py is not installed: no netCDF files written")

    print("running the recipe-driven service (CLI equivalent)...")
    feats = [
        {"type": "Feature", "properties": {}, "geometry": {"type": "Point", "coordinates": [float(a), float(b), float(c)]}}
        for a, b, c in zip(xs, ys, zs)
    ]
    cross_fn = os.path.join(out_dir, "cross.geojson")
    with open(cross_fn, "w") as fh:
        json.dump({"type": "FeatureCollection", "features": feats}, fh)
    recipe = {
        "video": {"start_frame": 0, "end_frame": N_FRAMES - 2, "h_a": 0.0},
        "frames": {"normalize": {"samples": 4}},
        "velocimetry": {"get_piv": {"window_size": 32}, "write": write},
        "mask": {"write": write, "mask_group1": {"corr": None}},
        "transect": {
            "write": write,
            "transect_1": {
                "shapefile": cross_fn,
                "get_transect": {"wdw": 1},
                "get_q": {"fill_method": "interpolate"},
                "get_river_flow": None,
            },
        },
    }
    from pyorc_tpu_torch.cli import cli_utils
    from pyorc_tpu_torch.service import VelocityFlowProcessor

    recipe = cli_utils.validate_recipe(recipe)
    camconfig = cli_utils.parse_camconfig(None, None, cam_fn)
    proc = VelocityFlowProcessor(
        recipe=recipe, videofile=video_fn, cameraconfig=camconfig, prefix="",
        output=os.path.join(out_dir, "service"), h_a=0.0,
    )
    proc.process()
    # the same clip and get_piv call: the API's field, to the bit, or (read back from piv.nc) to the file's
    # int16 encoding with a 0.01 scale
    step = 0.005 + 1e-6 if write else 0.0
    for name in ("v_x", "v_y", "corr"):
        got, want = proc.velocimetry_obj[name].values, piv[name].values
        assert np.array_equal(np.isnan(got), np.isnan(want)) and np.nanmax(np.abs(got - want)) <= step, name
    print("service: the API's velocity field" + (" (read back from piv.nc)" if write else ", to the bit"))
    print(f"done — outputs in {out_dir}/" + (" (piv_masked.nc, transect.nc, service/)" if write else ""))
    print("demo OK")
    return {"video": os.path.basename(video_fn), "v_measured": v_measured, "v_expected": v_expected,
            "q": q.tolist(), "netcdf_written": write}


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "demo_out")
