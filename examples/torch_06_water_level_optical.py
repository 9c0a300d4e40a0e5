"""Optical water-level estimation from a cross-section, with the PyTorch/CUDA port.

The port's counterpart of ``06_water_level_optical.py`` (the reference tutorial
``06_Estimating_water_levels_optically.ipynb``): attach the Geul river's
surveyed bathymetry to its camera configuration, hypothesize waterline
positions along the section, and find the level whose wet and dry pixel
intensity histograms separate best. The scene is rendered with a known
level: land bright and noisy, water dark and smooth below it, the wet
polygons filled with the port's own even-odd fill
(``pyorc_tpu_torch.geom.shapes.fill_polygon``). Both the batched grid scan
(one scorer call over every candidate, on the card) and the s2n-quality
variant must find the level within 0.25 m.

Run:  python examples/torch_06_water_level_optical.py
(``PYORC_TPU_TORCH_DEVICE=cpu`` runs it without a card.)
"""

import numpy as np

H_TRUE = 92.8  # m, local datum
ZS = [152.754, 152.436, 152.124, 151.65, 151.171, 150.959, 150.689, 150.215, 150.227, 150.204,
      150.148, 150.181, 150.114, 150.14, 150.096, 150.207, 150.474, 150.684, 150.931, 151.136,
      151.558, 151.943, 152.711, 153.016]
XS_LON = [5.913483043333334, 5.91350165, 5.913509225, 5.913517873333333, 5.913526728333333,
          5.913537678333333, 5.913544631666667, 5.913551016666665, 5.91356275, 5.913577963333334,
          5.913591855, 5.913605991666667, 5.91362158, 5.91362959, 5.913639568333333, 5.913647405,
          5.913650936666666, 5.91365698, 5.913666071666667, 5.913672016666667, 5.913678495,
          5.91368494, 5.913693873333334, 5.913725518333335]
YS_LAT = [50.807081403333335, 50.80708851833334, 50.80709163333333, 50.807093645, 50.807096580000014,
          50.807099555, 50.807102958333346, 50.80710621, 50.80710916, 50.807112763333336,
          50.80711691833334, 50.807121985, 50.80712629833334, 50.807129086666656, 50.807132803333324,
          50.80713549666667, 50.807136676666666, 50.807138608333325, 50.80714141666667,
          50.80714368666667, 50.80714608333333, 50.80714834333333, 50.80715788, 50.807162983333335]


def geul_camera_config():
    """The reference test suite's Geul camera configuration (real site)."""
    from pyorc_tpu_torch import CameraConfig

    return CameraConfig(
        height=1080, width=1920, crs=28992, resolution=0.01,
        gcps={
            "src": [[158, 314], [418, 245], [655, 162], [948, 98], [1587, 321], [1465, 747]],
            "dst": [
                [192102.50255553858, 313157.5882846481, 150.831],
                [192101.3882378415, 313160.1101843005, 150.717],
                [192099.77023223988, 313163.2868999007, 150.807],
                [192096.8922817797, 313169.2557434712, 150.621],
                [192105.2958125107, 313172.0257530752, 150.616],
                [192110.35620407888, 313162.5371485311, 150.758],
            ],
            "h_ref": 92.45, "z_0": 150.49,
        },
        window_size=64, is_nadir=False,
        camera_matrix=[[1750.3084716796875, 0.0, 960.0], [0.0, 1750.3084716796875, 540.0], [0.0, 0.0, 1.0]],
        dist_coeffs=[[-0.48456448702008914], [0.44089348828121366], [0.0], [0.0], [0.0]],
        bbox=(
            "POLYGON ((192102.55970673775 313154.1397356759, 192098.0727491934 313163.2664060433, "
            "192108.81475944887 313168.5475153654, 192113.3017169932 313159.420844998, "
            "192102.55970673775 313154.1397356759))"
        ),
    )


def render_scene(cs, h_true=H_TRUE, seed=3):
    """uint8 camera frame: land N(170, 30), water N(60, 8) over the wet part of the bbox at ``h_true``."""
    from pyorc_tpu_torch.geom import shapes

    rng = np.random.default_rng(seed)
    img = rng.normal(170, 30, size=(cs.camera_config.height, cs.camera_config.width)).clip(0, 255).astype(np.uint8)
    for pol in cs.get_bbox_dry_wet(h=h_true, camera=True).geoms:
        ring = np.asarray(pol.exterior.coords)[:, :2]
        ring = ring[np.isfinite(ring).all(axis=1)]
        if len(ring) >= 3:
            mask = shapes.fill_polygon(img.shape, np.round(ring).astype(np.int32))
            water = rng.normal(60, 8, size=img.shape).clip(0, 255).astype(np.uint8)
            img = np.where(mask, water, img)
    return img


def main() -> dict:
    from pyorc_tpu_torch import CrossSection
    from pyorc_tpu_torch.geom import crs as crs_mod

    cc = geul_camera_config()
    x, y = crs_mod.transform_points(4326, 28992, np.array(XS_LON), np.array(YS_LAT))
    cs = CrossSection(camera_config=cc, cross_section=[[float(a), float(b), float(c)] for a, b, c in zip(x, y, ZS)])
    print(f"cross-section: {len(ZS)} survey points, z range {min(ZS):.2f}-{max(ZS):.2f} m")

    img = render_scene(cs)
    h_grid = cs.detect_water_level(img, bank="far", length=2.0, padding=0.5)
    h_s2n, s2n = cs.detect_water_level_s2n(img, bank="far", length=2.0, padding=0.5)
    print(f"true level:            h = {H_TRUE:.3f} m")
    print(f"batched grid scan:     h = {h_grid:.3f} m (err {abs(h_grid - H_TRUE):.3f})")
    print(f"s2n-quality variant:   h = {h_s2n:.3f} m (s2n = {s2n:.2f})")
    assert abs(h_grid - H_TRUE) < 0.25
    assert abs(h_s2n - H_TRUE) < 0.25
    print("water level example OK")
    return {"h_grid": float(h_grid), "h_s2n": float(h_s2n), "s2n": float(s2n)}


if __name__ == "__main__":
    main()
