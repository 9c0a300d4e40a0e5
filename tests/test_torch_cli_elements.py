"""The port's interactive camera-config (``cli/cli_elements.py``, the ``cli_utils`` functions
behind it and ``camera-config``'s branches) against the JAX package's, on Agg.

The selectors are driven with synthetic matplotlib mouse and key events, as
``tests/test_basemap.py`` drives JAX's: the same clicks must give the same points,
the same fitted camera matrix and distortion (1e-9) and the same live previews. Then
``camera-config`` without ``--src``, without ``--corners`` and with ``--stabilize`` runs
through ``CliRunner`` with each selector's ``run`` patched to return those clicks: the
written JSON must equal JAX's.
"""

import json
import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from click.testing import CliRunner  # noqa: E402
from matplotlib.backend_bases import KeyEvent, MouseButton, MouseEvent  # noqa: E402

import pyorc_tpu  # noqa: E402
from pyorc_tpu.cli import cli_elements as jel  # noqa: E402
from pyorc_tpu.cli import cli_utils as jcli  # noqa: E402
from pyorc_tpu.cli.main import cli as jmain  # noqa: E402

import pyorc_tpu_torch  # noqa: E402
from pyorc_tpu_torch.cli import cli_elements as tel  # noqa: E402
from pyorc_tpu_torch.cli import cli_utils as tcli  # noqa: E402
from pyorc_tpu_torch.cli.main import cli as tmain  # noqa: E402

import chip_smoke  # noqa: E402

H, W = 240, 320
G = 30  # GCPs this many px inside the frame's edges
SRC = [[G, G], [W - G, G], [W - G, H - G], [G, H - G]]
CLICKS = [[G + 0.4, G - 0.3], [W - G - 0.2, G + 0.6], [W - G + 0.5, H - G - 0.1], [G - 0.6, H - G + 0.2]]
CORNERS = [[40, 40], [W - 40, 40], [W - 40, H - 40], [40, H - 40]]
POLYGON = [[10, 10], [W - 10, 15], [W - 20, H - 10], [12, H - 14], [8, H // 2]]
X0, Y0 = 500000.0, 5700000.0
MODULES = {"torch": (tel, tcli, pyorc_tpu_torch), "jax": (jel, jcli, pyorc_tpu)}


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)
    yield
    plt.close("all")


def _dst(offset=(0.0, 0.0), z=None):
    out = [[offset[0] + chip_smoke.RES * c, offset[1] + chip_smoke.RES * (H - r)] for c, r in SRC]
    return [p + [z] for p in out] if z is not None else out


def _click(sel, x, y, button=MouseButton.LEFT):
    event = MouseEvent("button_press_event", sel.fig.canvas, 0, 0, button=button)
    event.inaxes = sel.ax
    event.xdata, event.ydata = float(x), float(y)
    sel.on_click(event)


def _key(sel, key):
    sel.on_key(KeyEvent("key_press_event", sel.fig.canvas, key=key))


def _image(rgb=True):
    img = np.random.default_rng(4).integers(0, 256, (H, W, 3) if rgb else (H, W), dtype=np.uint8)
    return img


def test_base_select_clicks_keys_and_undo():
    """Clicks add points up to ``max_points``, a right click and Escape undo, Enter completes."""
    out = {}
    for name, (el, _, _) in MODULES.items():
        sel = el.BaseSelect(_image(rgb=False), max_points=3, title="t")
        _click(sel, 5, 6)
        _click(sel, 7, 8)
        _click(sel, 0, 0, button=MouseButton.RIGHT)
        _click(sel, 9, 10)
        _key(sel, "escape")
        assert not sel.done
        _key(sel, "enter")
        assert sel.done
        outside = MouseEvent("button_press_event", sel.fig.canvas, 0, 0, button=MouseButton.LEFT)
        sel.on_click(outside)  # not in the axes: ignored
        out[name] = (sel.src, np.asarray(sel.pts_plot.get_data()).tolist())
    assert out["torch"] == out["jax"] == ([[5.0, 6.0]], [[5.0], [6.0]])


def test_gcp_select_fit_equals_jax(monkeypatch):
    """GcpSelect: the fourth click fits intrinsics and pose; points, camera matrix, distortion
    and the reprojected points equal JAX's (1e-9). With a CRS the geographic panel is drawn
    (offline: the tile fetchers are patched to find nothing, so no request is made)."""
    from pyorc_tpu.io import basemap as jbasemap

    from pyorc_tpu_torch.io import basemap as tbasemap

    for mod in (tbasemap, jbasemap):
        monkeypatch.setattr(mod, "_fetch_tile", lambda provider, x, y, z: None)
    out = {}
    for name, (el, _, _) in MODULES.items():
        sel = el.GcpSelect(_image(), _dst())
        for x, y in CLICKS:
            _click(sel, x, y)
        assert sel.done and sel.camera_matrix_fit is not None, name
        out[name] = sel
    got, want = out["torch"], out["jax"]
    assert got.src == want.src == CLICKS
    for attr in ("camera_matrix_fit", "dist_coeffs_fit"):
        np.testing.assert_allclose(getattr(got, attr), getattr(want, attr), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(got.est_plot.get_data()), np.asarray(want.est_plot.get_data()),
                               rtol=1e-9, atol=1e-9)
    assert got.ax.get_title() == want.ax.get_title()
    for name, (el, _, _) in MODULES.items():
        sel = el.GcpSelect(_image(), _dst((X0, Y0)), crs=32631)
        assert sel.ax_geo is not None, name  # offline: the points without tiles


def _crs_camera_config(pkg):
    cc = chip_smoke.nadir_camera_config(H, W, gcp_px=G, aoi_px=40)
    d = json.loads(cc.to_json())
    d["crs"] = 32631
    d["gcps"]["dst"] = _dst((X0, Y0))
    for k in ("bbox", "is_nadir"):
        d.pop(k, None)
    return pkg.api.cameraconfig.CameraConfig(**d)


def test_aoi_select_preview_equals_jax():
    """AoiSelect: four corners draw the bbox in the camera view and the geographic panel, as JAX's."""
    out = {}
    for name, (el, _, pkg) in MODULES.items():
        sel = el.AoiSelect(_image(), camera_config=_crs_camera_config(pkg))
        assert sel.ax_geo is not None, name
        for x, y in CORNERS:
            _click(sel, x, y)
        out[name] = sel
    got, want = out["torch"], out["jax"]
    assert got.src == want.src == [[float(x), float(y)] for x, y in CORNERS]
    for plot in ("bbox_plot", "bbox_geo_plot"):
        a = np.asarray(getattr(got, plot).get_data())
        b = np.asarray(getattr(want, plot).get_data())
        assert a.shape == b.shape and a.shape[1] >= 5, plot
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)
    _click(got, 0, 0, button=MouseButton.RIGHT)
    assert len(got.bbox_plot.get_data()[0]) == 0


def test_stabilize_select_polygon_equals_jax():
    """StabilizeSelect: the clicked polygon and its patch, as JAX's."""
    out = {}
    for name, (el, _, _) in MODULES.items():
        sel = el.StabilizeSelect(_image())
        _click(sel, *POLYGON[0])
        _click(sel, *POLYGON[1])
        assert not sel.poly_patch.get_visible()
        for p in POLYGON[2:]:
            _click(sel, *p)
        assert sel.poly_patch.get_visible()
        out[name] = sel
    assert out["torch"].src == out["jax"].src == [[float(x), float(y)] for x, y in POLYGON]
    np.testing.assert_array_equal(out["torch"].poly_patch.get_xy(), out["jax"].poly_patch.get_xy())


def test_interactive_cli_utils_equal_jax(monkeypatch):
    """``get_gcps_interactive``, ``get_corners_interactive`` (with the interim camera config from
    the clicked GCPs) and ``get_stabilize_pol`` on a patched sample frame, clicks driven through
    each selector's ``run``."""
    img = _image()
    out = {}
    for name, (el, cli_utils, _) in MODULES.items():
        monkeypatch.setattr(cli_utils, "_sample_rgb_frame", lambda fn, frame_sample=0, rotation=None: img)
        made = []

        def clicking(points):
            def run(self):
                made.append(self)
                for x, y in points:
                    _click(self, x, y)
                return self.src

            return run

        monkeypatch.setattr(el.GcpSelect, "run", clicking(CLICKS))
        monkeypatch.setattr(el.AoiSelect, "run", clicking(CORNERS))
        monkeypatch.setattr(el.StabilizeSelect, "run", clicking(POLYGON))
        src, cam, dist = cli_utils.get_gcps_interactive("unused.avi", _dst())
        gcps = {"src": src, "dst": _dst(), "z_0": 0.0, "h_ref": 0.0, "crs": None}
        corners = cli_utils.get_corners_interactive("unused.avi", gcps, camera_matrix=cam, dist_coeffs=dist)
        assert made[1].camera_config is not None and len(made[1].bbox_plot.get_data()[0]) > 4, name
        pol = cli_utils.get_stabilize_pol("unused.avi")
        out[name] = (src, cam, dist, corners, pol, np.asarray(made[1].bbox_plot.get_data()))
    for a, b in zip(out["torch"], out["jax"]):
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float), rtol=1e-9, atol=1e-9)
    bad = {"src": [[1, 2]], "dst": [[0, 0]], "z_0": 0.0, "crs": None}
    for _, cli_utils, _ in MODULES.values():  # a config that cannot be built gives no preview, and no error
        log = _Warnings()
        assert cli_utils._interim_camera_config(img, bad, logger=log) is None
        assert len(log.lines) == 1 and "source points" in log.lines[0]


class _Warnings:
    def __init__(self):
        self.lines = []

    def warning(self, msg):
        self.lines.append(msg)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    folder = tmp_path_factory.mktemp("cli_elements")
    return str(chip_smoke.write_clip(chip_smoke.advected_stack(H, W, 3, "cpu"), folder / "clip.avi"))


def _hold_json(got, want, key="camera config"):
    """Equal JSON values, numbers to 1e-9."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), key
        for k in want:
            _hold_json(got[k], want[k], f"{key}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), key
        for i, (a, b) in enumerate(zip(got, want)):
            _hold_json(a, b, f"{key}[{i}]")
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        assert isinstance(got, (int, float)) and abs(got - want) <= 1e-9 * max(1.0, abs(want)), (key, got, want)
    else:
        assert got == want, (key, got, want)


def test_camera_config_cli_interactive_equals_jax(clip, tmp_path, monkeypatch):
    """``camera-config`` without ``--src`` and ``--corners`` and with ``--stabilize``: the
    selectors open on the clip's frame (their ``run`` patched to return the clicks) and the
    written JSON is JAX's."""
    monkeypatch.chdir(tmp_path)  # the command logs to ./pyorc_tpu.log
    shapes = {}
    for el, _, _ in MODULES.values():
        for cls, points in ((el.GcpSelect, CLICKS), (el.AoiSelect, CORNERS), (el.StabilizeSelect, POLYGON)):
            def run(self, points=points, cls=cls):
                shapes.setdefault(cls.__module__, []).append(np.asarray(self.img).shape)
                return [list(p) for p in points]

            monkeypatch.setattr(cls, "run", run)
    args = ["camera-config", "-V", clip, "--dst", json.dumps(_dst()), "--z_0", "0.0", "--h_ref", "0.0",
            "--resolution", "0.01", "--window_size", "32", "--stabilize"]
    outs = {}
    for name, main in (("torch", tmain), ("jax", jmain)):
        fn = str(tmp_path / f"{name}.json")
        result = CliRunner().invoke(main, args + [fn])
        assert result.exit_code == 0, result.output
        assert os.path.isfile(fn.replace(".json", "_cam.jpg"))
        outs[name] = json.loads(open(fn).read())
    _hold_json(outs["torch"], outs["jax"])
    assert outs["torch"]["gcps"]["src"] == CLICKS and outs["torch"]["stabilize"] == POLYGON
    assert shapes["pyorc_tpu_torch.cli.cli_elements"] == shapes["pyorc_tpu.cli.cli_elements"] == [(H, W, 3)] * 3
