"""The port's recipe entry point (service and CLI) against the JAX package on the CPU.

A module fixture writes a small lossless clip (240x320, 8 frames of
``chip_smoke.advected_stack``, FFV1 through OpenCV), its nadir camera config
and a cross-section with z, and runs the recipe of
``tests/test_cli_service.py:56-85`` with every ``write`` flag through
``pyorc_tpu.service.velocity_flow`` and ``pyorc_tpu_torch.service.velocity_flow``.
The STIV group's line length and spacing are scaled to the 2.4 m wide scene.
The written v_x, v_y, corr and s2n must agree within 2e-3 (m/s for the
velocities) and Q within 1 %: the north star's check. Then the port alone:
``--update`` skips, ``validate_recipe`` / ``read_shape`` against JAX's, the CLI
through ``CliRunner`` and as a child process (``PYORC_TPU_TORCH_DEVICE=cpu``),
``camera-config`` against JAX's JSON, the optical water level (``--cross_wl``)
on a small scene against JAX's, ``examples/recipe_template.yml`` with every output entry
(the figure, UGRID, the video, a GeoTIFF) against JAX's files, and ``--num-hosts 2`` as two
processes whose segments stitch to the one-host result.
"""

import copy
import json
import logging
import os

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import pyorc_tpu
import pyorc_tpu_torch
from pyorc_tpu.cli import cli_utils as jcli
from pyorc_tpu.service import velocimetry as jsvc
from pyorc_tpu_torch.cli import cli_utils as tcli
from pyorc_tpu_torch.cli.main import cli as tcli_main
from pyorc_tpu_torch.service import velocimetry as tsvc

import chip_smoke

H, W, N = 240, 320, 8
CAMERA = {"gcp_px": 30, "aoi_px": 40}
VEL_TOL = 2e-3  # m/s; corr and s2n alike
Q_RTOL = 0.01


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)
    monkeypatch.setenv("PYORC_TPU_SHARD", "0")  # conftest gives JAX 8 CPU devices


def _geojson(x, y, z):
    return {"type": "FeatureCollection", "features": [
        {"type": "Feature", "properties": {}, "geometry": {"type": "Point", "coordinates": [float(a), float(b), float(c)]}}
        for a, b, c in zip(x, y, z)
    ]}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Paths of the clip, the camera config and the cross-section, and the recipe."""
    folder = tmp_path_factory.mktemp("service_inputs")
    stack = chip_smoke.advected_stack(H, W, N, "cpu")
    clip = chip_smoke.write_clip(stack, folder / "clip.avi")
    cc = chip_smoke.nadir_camera_config(H, W, **CAMERA)
    cc.to_file(str(folder / "camera_config.json"))
    fn_cross = folder / "cross.geojson"
    fn_cross.write_text(json.dumps(_geojson(*chip_smoke.transect_points(cc, n_points=15, margin_px=16, aoi_px=40))))
    recipe = {
        "video": {"start_frame": 0, "end_frame": 6, "h_a": 0.0},
        "frames": {
            "normalize": {"samples": 2},
            "edge_detect": {"wdw_1": 1, "wdw_2": 2},
            "minmax": {"min": -5, "max": 5},
        },
        "velocimetry": {"get_piv": {"window_size": 32}, "write": True},
        "mask": {"write": True, "mask_group1": {"corr": None}},
        "transect": {
            "write": True,
            "transect_1": {
                "shapefile": str(fn_cross),
                "get_transect": {"wdw": 1},
                "get_q": {"fill_method": "zeros"},
                "get_river_flow": None,
            },
        },
        "stiv": {"write": True, "stiv_1": {"shapefile": str(fn_cross), "length": 0.5, "distance": 0.1}},
    }
    return {"clip": str(clip), "cc": str(folder / "camera_config.json"), "cross": str(fn_cross), "recipe": recipe}


def _run(svc, cli_utils, inputs, out, recipe=None, **kwargs):
    recipe = cli_utils.validate_recipe(copy.deepcopy(recipe or inputs["recipe"]))
    kwargs.setdefault("h_a", 0.0)
    svc.velocity_flow(
        recipe=recipe, videofile=inputs["clip"], cameraconfig=cli_utils.parse_camconfig(None, None, inputs["cc"]),
        prefix="", output=str(out), **kwargs,
    )
    return str(out)


@pytest.fixture(scope="module")
def outputs(inputs, tmp_path_factory):
    """Output folders of the recipe through the port's service and through JAX's."""
    torch.set_num_threads(2)
    pyorc_tpu_torch.set_device("cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYORC_TPU_SHARD", "0")
        return {
            "torch": _run(tsvc, tcli, inputs, tmp_path_factory.mktemp("torch_out")),
            "jax": _run(jsvc, jcli, inputs, tmp_path_factory.mktemp("jax_out")),
        }


def _hold_outputs(got_dir, want_dir):
    """The PIV, masked PIV, transect and STIV files of two output folders agree."""
    for fn in ("piv.nc", "piv_mask.nc"):
        got, want = pyorc_tpu_torch.open_dataset(os.path.join(got_dir, fn)), pyorc_tpu.open_dataset(os.path.join(want_dir, fn))
        for name in ("v_x", "v_y", "corr", "s2n"):
            a, b = np.asarray(got[name].values, float), np.asarray(want[name].values, float)
            assert a.shape == b.shape and a.shape[0] == 6, (fn, name)
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{fn} {name}")
            assert np.nanmax(np.abs(a - b)) <= VEL_TOL, (fn, name)
    fn = "transect_transect_1.nc"
    got, want = pyorc_tpu_torch.open_dataset(os.path.join(got_dir, fn)), pyorc_tpu.open_dataset(os.path.join(want_dir, fn))
    q_got, q_want = got["river_flow"].values, np.asarray(want["river_flow"].values)
    assert q_got.shape == q_want.shape == (5,)
    assert np.all(np.abs(q_got - q_want) <= Q_RTOL * np.abs(q_want)) and np.median(q_want) > 0.01
    fn = "stiv_stiv_1.nc"
    got, want = pyorc_tpu_torch.open_dataset(os.path.join(got_dir, fn)), pyorc_tpu.open_dataset(os.path.join(want_dir, fn))
    for name, tol in (("v", 1e-3), ("coherence", 1e-4)):  # the bars of tests/test_torch_stiv.py
        a, b = got[name].values, np.asarray(want[name].values)
        assert a.shape == b.shape and len(a) >= 3
        np.testing.assert_allclose(a, b, rtol=tol if name == "v" else 0, atol=0 if name == "v" else tol)


def test_service_matches_jax(outputs):
    """The north star's check: one recipe, one clip, both services, the same fields and Q."""
    _hold_outputs(outputs["torch"], outputs["jax"])
    files = set(os.listdir(outputs["torch"]))
    assert files == set(os.listdir(outputs["jax"]))
    assert {"piv.nc", "piv_mask.nc", "transect_transect_1.nc", "stiv_stiv_1.nc", ".pyorc"} <= files
    ledger = os.listdir(os.path.join(outputs["torch"], ".pyorc"))
    assert "velocimetry.yml" in ledger and any(f.endswith(".hash") for f in ledger)


class _Lines(logging.Logger):
    def __init__(self):
        super().__init__("lines")
        self.lines = []

    def _log(self, level, msg, args, **kwargs):
        self.lines.append(str(msg))


def test_update_skips(inputs, outputs):
    """A second run with ``update=True`` on unchanged inputs skips velocimetry and mask
    and restores them from their files."""
    logger = _Lines()
    proc = tsvc.VelocityFlowProcessor(
        recipe=tcli.validate_recipe(copy.deepcopy(inputs["recipe"])), videofile=inputs["clip"],
        cameraconfig=tcli.parse_camconfig(None, None, inputs["cc"]), prefix="", output=outputs["torch"],
        h_a=0.0, update=True, logger=logger,
    )
    proc.process()
    skipped = [m for m in logger.lines if "skipping" in m]
    assert [m.split('"')[1] for m in skipped] == ["velocimetry", "mask"], logger.lines
    assert isinstance(proc.velocimetry_mask_obj, pyorc_tpu_torch.Dataset)


def test_validate_recipe_and_read_shape(inputs):
    """The same recipe checks and GeoJSON reading as the JAX package's."""
    got = tcli.validate_recipe(copy.deepcopy(inputs["recipe"]))
    assert got == jcli.validate_recipe(copy.deepcopy(inputs["recipe"]))
    for bad, match in (({"bogus_section": {}}, "not allowed"), ({"frames": {"not_a_method": {}}}, "does not have a method"),
                       ({"frames": {"minmax": {"lo": 1}}}, "does not have input argument")):
        for mod in (tcli, jcli):
            with pytest.raises(ValueError, match=match):
                mod.validate_recipe(copy.deepcopy(bad))
    assert tcli.read_shape(fn=inputs["cross"]) == jcli.read_shape(fn=inputs["cross"])
    gj = json.loads(open(inputs["cross"]).read())
    gj["crs"] = {"type": "name", "properties": {"name": "urn:ogc:def:crs:EPSG::28992"}}
    coords, crs = tcli.read_shape(geojson=gj)
    assert crs == 28992 and len(coords) == 15 and len(coords[0]) == 3
    for got, want in zip(tcli.parse_lens_params(1080, 1920, focal_length=1500.0, k1=-0.1),
                         jcli.parse_lens_params(1080, 1920, focal_length=1500.0, k1=-0.1)):
        np.testing.assert_array_equal(got, want)


def test_cli_velocimetry(inputs, outputs, tmp_path):
    """``pyorc-tpu-torch velocimetry`` through CliRunner writes what the service wrote."""
    fn_recipe = tmp_path / "recipe.yml"
    fn_recipe.write_text(json.dumps(inputs["recipe"]))
    out = str(tmp_path / "out")
    result = CliRunner().invoke(
        tcli_main, ["velocimetry", "-V", inputs["clip"], "-c", inputs["cc"], "-r", str(fn_recipe), "-h", "0.0", out],
    )
    assert result.exit_code == 0, result.output
    _hold_outputs(out, outputs["jax"])
    log = open(os.path.join(out, "pyorc_tpu.log")).read()
    assert all(f'stage "{s}" done' in log for s in ("video", "frames", "velocimetry", "mask", "transect", "stiv"))


def test_cli_help_and_info():
    runner = CliRunner()
    result = runner.invoke(tcli_main, ["velocimetry", "--help"])
    assert result.exit_code == 0 and "--cross_wl" in result.output
    result = runner.invoke(tcli_main, ["--info"])
    assert result.exit_code == 0 and "pyorc-tpu-torch" in result.output


def test_velocity_flow_subprocess(inputs, outputs, tmp_path, monkeypatch):
    """The child ``velocimetry`` process runs the recipe on the CPU when
    ``PYORC_TPU_TORCH_DEVICE=cpu`` is set, and writes what the service wrote."""
    monkeypatch.setenv("PYORC_TPU_TORCH_DEVICE", "cpu")
    out = str(tmp_path / "sub_out")
    result = tsvc.velocity_flow_subprocess(
        videofile=inputs["clip"], recipe=copy.deepcopy(inputs["recipe"]),
        cameraconfig=tcli.parse_camconfig(None, None, inputs["cc"]), output=out, h_a=0.0,
    )
    assert result.returncode == 0, result.stdout[-2000:] + result.stderr[-2000:]
    assert os.path.isfile(os.path.join(out, "recipe.yml")) and os.path.isfile(os.path.join(out, "camera_config.json"))
    _hold_outputs(out, outputs["jax"])


def test_camera_config_cli_equals_jax(inputs, tmp_path, monkeypatch):
    """``camera-config`` with GCPs and corners given: the port's JSON is JAX's (floats to 1e-9)."""
    from pyorc_tpu.cli.main import cli as jcli_main

    monkeypatch.chdir(tmp_path)  # the command logs to ./pyorc_tpu.log
    g, a = CAMERA["gcp_px"], CAMERA["aoi_px"]
    src = [[g, g], [W - g, g], [W - g, H - g], [g, H - g]]
    dst = [[chip_smoke.RES * c, chip_smoke.RES * (H - r)] for c, r in src]
    args = [
        "camera-config", "-V", inputs["clip"], "--src", json.dumps(src), "--dst", json.dumps(dst),
        "--z_0", "0.0", "--h_ref", "0.0", "--resolution", "0.01", "--window_size", "32",
        "--corners", json.dumps([[a, a], [W - a, a], [W - a, H - a], [a, H - a]]),
    ]
    outs = {}
    for name, main in (("torch", tcli_main), ("jax", jcli_main)):
        fn = str(tmp_path / f"{name}.json")
        result = CliRunner().invoke(main, args + [fn])
        assert result.exit_code == 0, result.output
        assert os.path.isfile(fn.replace(".json", "_geo.jpg")) and os.path.isfile(fn.replace(".json", "_cam.jpg"))
        outs[name] = json.loads(open(fn).read())
    _hold_json(outs["torch"], outs["jax"])


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


@pytest.fixture(scope="module")
def water_scene(tmp_path_factory):
    """A small scene for the optical water level: the nadir camera over a V-shaped bed
    (banks +0.3 m, bottom -0.3 m) at a true level of 0.0 m; 2 frames of land and water."""
    folder = tmp_path_factory.mktemp("water_scene")
    cc = chip_smoke.nadir_camera_config(H, W, **CAMERA)
    x, y, _ = chip_smoke.transect_points(cc, n_points=21, margin_px=10, aoi_px=40)
    t = np.linspace(-1.0, 1.0, len(x))
    z = 0.3 - 0.6 * (1.0 - t**2)
    fn_cross = folder / "cross_wl.geojson"
    fn_cross.write_text(json.dumps(_geojson(x, y, z)))
    cs = pyorc_tpu_torch.CrossSection(cc, [[a, b, c] for a, b, c in zip(x, y, z)])
    clip = chip_smoke.write_clip(np.stack([chip_smoke.waterline_scene(cs, seed=s, h=0.0) for s in (3, 4)]),
                                 folder / "scene.avi")
    cc.to_file(str(folder / "camera_config.json"))
    recipe = {
        "video": {},
        "water_level": {"n_end": 2, "s2n_thres": 1.5, "water_level_options": {"length": 1.0, "padding": 0.2}},
        "frames": {},
        "velocimetry": {"get_piv": {"window_size": 32}, "write": True},  # JAX's ledger needs the file
    }
    return {"clip": str(clip), "cc": str(folder / "camera_config.json"), "cross": str(fn_cross), "recipe": recipe}


def test_cross_wl_equals_jax(water_scene, tmp_path):
    """``--cross_wl``: the level detected on the scene's mean frame is JAX's, within 0.05 m of the truth."""
    levels = {}
    for name, svc, cli_utils in (("torch", tsvc, tcli), ("jax", jsvc, jcli)):
        proc = svc.VelocityFlowProcessor(
            recipe=cli_utils.validate_recipe(copy.deepcopy(water_scene["recipe"])), videofile=water_scene["clip"],
            cameraconfig=cli_utils.parse_camconfig(None, None, water_scene["cc"]), prefix="",
            output=str(tmp_path / name), cross_wl=water_scene["cross"], logger=_Lines(),
        )
        proc.process()
        levels[name] = proc.video_obj.h_a
    assert levels["torch"] == levels["jax"]
    assert abs(levels["torch"]) < 0.05


def test_get_water_level_decodes_only_its_frames(water_scene):
    """``isel(time=slice(n_start, n_end))`` and the mean over time decode those frames only
    (and frame 0, which ``get_frames`` reads for the frames' shape)."""
    cc = pyorc_tpu_torch.load_camera_config(water_scene["cc"])
    video = pyorc_tpu_torch.Video(water_scene["clip"], camera_config=cc, progress=False)
    cs = pyorc_tpu_torch.CrossSection(cc, tcli.read_shape(fn=water_scene["cross"])[0])
    decoded = []
    decode = video._decode_frames

    def spy(positions, method):
        decoded.extend(np.atleast_1d(positions).tolist())
        return decode(positions, method)

    video._decode_frames = spy
    level = tsvc.get_water_level(video, cs, n_start=1, n_end=2, s2n_thres=1.5,
                                 water_level_options={"length": 1.0, "padding": 0.2})
    assert sorted(set(decoded)) == [0, 1] and decoded.count(1) == 1
    assert level is not None and abs(level) < 0.05


def test_mask_deepcopy_copies_host_arrays(inputs, tmp_path):
    """The mask stage deep-copies the velocimetry dataset: its variables are host arrays,
    not device tensors or the lazy frame stack."""
    recipe = copy.deepcopy(inputs["recipe"])
    for section in ("velocimetry", "mask", "transect", "stiv"):
        recipe[section].pop("write", None)
    recipe.pop("stiv")
    proc = tsvc.VelocityFlowProcessor(
        recipe=tcli.validate_recipe(recipe), videofile=inputs["clip"],
        cameraconfig=tcli.parse_camconfig(None, None, inputs["cc"]), prefix="", output=str(tmp_path), h_a=0.0,
        logger=_Lines(),
    )
    proc.process()
    for ds in (proc.velocimetry_obj, proc.velocimetry_mask_obj):
        for name in ds.data_vars:
            assert type(ds[name].values) is np.ndarray and type(ds[name].data) is np.ndarray, name
    assert proc.velocimetry_mask_obj["v_x"].data is not proc.velocimetry_obj["v_x"].data
    assert np.isfinite(proc.transects["transect_1"]["river_flow"].values).all()


def test_recipe_without_write_runs(inputs, tmp_path):
    """A recipe without ``write`` flags runs to its end in the port, and under ``update`` its
    cached stages never count as current (nothing was written to restore them from); the JAX
    package's ledger fingerprints the unwritten piv.nc and raises (ROADMAP.md, queue C)."""
    recipe = {k: v for k, v in copy.deepcopy(inputs["recipe"]).items() if k in ("video", "frames", "velocimetry", "mask")}
    for section in ("velocimetry", "mask"):
        recipe[section].pop("write")
    _run(tsvc, tcli, inputs, tmp_path / "torch", recipe=recipe)
    assert os.listdir(tmp_path / "torch") == [".pyorc"]
    logger = _Lines()
    _run(tsvc, tcli, inputs, tmp_path / "torch", recipe=recipe, update=True, logger=logger)
    assert not [m for m in logger.lines if "skipping" in m], logger.lines
    assert all(any(f'stage "{s}" done' in m for m in logger.lines) for s in ("velocimetry", "mask")), logger.lines
    with pytest.raises(FileNotFoundError, match="piv.nc"):
        _run(jsvc, jcli, inputs, tmp_path / "jax", recipe=recipe)


X0, Y0 = 500000.0, 5700000.0  # the template's scene in EPSG:32631, for its geographical figure
JPG_TOL = {"mean": 0.5, "share_over_64": 0.002}  # see test_not_ported_recipe_entries_refused


@pytest.fixture(scope="module")
def template_outputs(inputs, tmp_path_factory):
    """``examples/recipe_template.yml`` on the clip, with ``frames.to_video``, ``frames.to_geotiff``
    and ``write_ugrid`` in the velocimetry and mask sections, through the port's service, the
    port's CLI and JAX's service. The scene is the fixture's, placed in EPSG:32631 (the template
    plots in geographical mode). The frames handed to each package's video writer are recorded.

    The template gives its plot layer a ``mode`` of its own, which JAX's plot stage passes on
    beside its plot-level ``mode`` and raises on (ROADMAP.md, queue C); JAX runs the same figure
    with ``mode`` at the plot level, and the port runs the template as written."""
    import yaml

    folder = tmp_path_factory.mktemp("template_inputs")
    cc = json.loads(open(inputs["cc"]).read())
    cc["crs"] = 32631
    cc["gcps"]["dst"] = [[X0 + x, Y0 + y] for x, y in cc["gcps"]["dst"]]
    for k in ("is_nadir", "bbox"):
        cc.pop(k, None)
    cam = pyorc_tpu_torch.CameraConfig(**cc)
    a = CAMERA["aoi_px"]
    cam.set_bbox_from_corners([[a, a], [W - a, a], [W - a, H - a], [a, H - a]])
    cam.to_file(str(folder / "camera_config.json"))
    cross = json.loads(open(inputs["cross"]).read())
    for feat in cross["features"]:
        x, y, z = feat["geometry"]["coordinates"]
        feat["geometry"]["coordinates"] = [X0 + x, Y0 + y, z]
    (folder / "cross.geojson").write_text(json.dumps(cross))
    recipe = yaml.safe_load(open(os.path.join(os.path.dirname(chip_smoke.__file__), "examples", "recipe_template.yml")))
    recipe["video"] = {"start_frame": 0, "h_a": 0.0}  # the clip's frames and level
    recipe["transect"]["transect_1"]["shapefile"] = str(folder / "cross.geojson")
    recipe["frames"].update(to_video={}, to_geotiff={})
    recipe["velocimetry"]["write_ugrid"] = True
    recipe["mask"]["write_ugrid"] = True
    jax_recipe = copy.deepcopy(recipe)
    layer = jax_recipe["plot"]["plot_1"]
    layer["mode"] = layer["velocimetry"].pop("mode")
    fn_recipe = folder / "recipe.yml"
    fn_recipe.write_text(json.dumps(recipe))
    out = {"recipe": recipe, "frames": {}}
    torch.set_num_threads(2)
    pyorc_tpu_torch.set_device("cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYORC_TPU_SHARD", "0")
        mp.chdir(folder)
        for name, native in (("torch", "pyorc_tpu_torch.io.native_decoder"), ("jax", "pyorc_tpu.io.native_decoder")):
            out["frames"][name] = frames = []
            real = __import__(native, fromlist=["NativeVideoWriter"]).NativeVideoWriter

            class Spy(real):
                def write(self, frame, frames=frames):
                    frames.append(np.array(frame))
                    super().write(frame)

            mp.setattr(f"{native}.NativeVideoWriter", Spy)
        cameraconfig = tcli.parse_camconfig(None, None, str(folder / "camera_config.json"))
        for name, svc, cli_utils, rec in (("torch", tsvc, tcli, recipe), ("jax", jsvc, jcli, jax_recipe)):
            out[name] = str(tmp_path_factory.mktemp(f"template_{name}"))
            proc = svc.VelocityFlowProcessor(
                recipe=cli_utils.validate_recipe(copy.deepcopy(rec)), videofile=inputs["clip"], cameraconfig=cameraconfig,
                prefix="", output=out[name], h_a=0.0, logger=_Lines(),
            )
            proc.process()
            out[f"{name}_proc"] = proc
        out["cli"] = str(tmp_path_factory.mktemp("template_cli"))
        result = CliRunner().invoke(tcli_main, ["velocimetry", "-V", inputs["clip"], "-c", str(folder / "camera_config.json"),
                                                "-r", str(fn_recipe), "-h", "0.0", out["cli"]])
        assert result.exit_code == 0, result.output
    return out


def _jpg_difference(a, b):
    """(mean absolute difference, share of values more than 64 apart) of two JPEG figures' pixels."""
    from PIL import Image

    x = np.asarray(Image.open(a).convert("RGBA"), dtype=np.int16)
    y = np.asarray(Image.open(b).convert("RGBA"), dtype=np.int16)
    assert x.shape == y.shape and x.shape[0] > 100, (x.shape, y.shape)
    d = np.abs(x - y)
    return float(d.mean()), float((d > 64).mean())


def _decode(fn):
    import cv2

    cap = cv2.VideoCapture(fn)
    frames = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        frames.append(img)
    cap.release()
    return np.asarray(frames)


@pytest.mark.parametrize(
    "section,key,value",
    [("plot", None, {"plot_1": {"mode": "local"}}), ("velocimetry", "write_ugrid", True),
     ("mask", "write_ugrid", True), ("frames", "to_video", {}), ("frames", "to_geotiff", {})],
    ids=["plot", "velocimetry-write_ugrid", "mask-write_ugrid", "to_video", "to_geotiff"],
)
def test_not_ported_recipe_entries_refused(template_outputs, section, key, value):
    """The recipe entries the port once refused now run: ``examples/recipe_template.yml`` with
    each of them (``template_outputs``), through the port's service and its CLI, writes JAX's
    files. GeoTIFF: the same bytes. Video: the same uint8 frames handed to the H.264 writer and
    a file that decodes to JAX's shape (x264's output for the same frames may vary from one
    encoder run to the next, so the decoded pixels are not compared). UGRID: arrays within
    2e-3 (m/s for the velocities; the two services' PIV fields agree to that, not to the bit),
    NaNs in the same places, attributes equal but for the timestamps. The figure (a JPEG of
    quivers over the time-mean field) may differ where an arrow's end moves by a fraction of a
    pixel: its RGBA values within a mean of 0.5 of 255, and under 0.2 % of them more than 64
    apart (``JPG_TOL``)."""
    want_dir = template_outputs["jax"]
    for got_dir in (template_outputs["torch"], template_outputs["cli"]):
        files = set(os.listdir(got_dir)) - {"pyorc_tpu.log", "recipe.yml", "camera_config.json"}
        assert files == set(os.listdir(want_dir)), (files, os.listdir(want_dir))
        if section == "plot":
            mean, share = _jpg_difference(os.path.join(got_dir, "plot_1.jpg"), os.path.join(want_dir, "plot_1.jpg"))
            assert mean <= JPG_TOL["mean"] and share <= JPG_TOL["share_over_64"], (mean, share)
        elif key == "write_ugrid":
            fn = "piv_ugrid.nc" if section == "velocimetry" else "piv_mask_ugrid.nc"
            got = pyorc_tpu_torch.open_dataset(os.path.join(got_dir, fn))
            want = pyorc_tpu.open_dataset(os.path.join(want_dir, fn))
            assert set(got.data_vars) == set(want.data_vars) and set(got.coords) == set(want.coords)
            for k in list(want.data_vars) + list(want.coords):
                a, b = np.asarray(got[k].values), np.asarray(want[k].values)
                assert a.shape == b.shape and got[k].attrs == want[k].attrs, k
                if a.dtype.kind == "f":
                    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
                    assert np.nanmax(np.abs(a - b), initial=0.0) <= VEL_TOL, k
                else:
                    np.testing.assert_array_equal(a, b, err_msg=k)
            stamps = ("date_created", "history")
            assert {k: v for k, v in got.attrs.items() if k not in stamps} == {
                k: v for k, v in want.attrs.items() if k not in stamps}
        elif key == "to_video":  # H.264 files: the decoded shape here, the frames written below
            got, want = _decode(os.path.join(got_dir, "processed_frames.mp4")), _decode(os.path.join(want_dir, "processed_frames.mp4"))
            assert got.shape == want.shape and got.shape[0] >= 7, (got.shape, want.shape)
        else:
            got = open(os.path.join(got_dir, "frame_0000.tif"), "rb").read()
            assert got == open(os.path.join(want_dir, "frame_0000.tif"), "rb").read()
    if key == "to_video":  # the frames the port's service and CLI handed their writer: JAX's, byte for byte
        recorded = template_outputs["frames"]
        assert len(recorded["torch"]) == 16 and len(recorded["jax"]) == 8
        for frames in (recorded["torch"][:8], recorded["torch"][8:]):
            np.testing.assert_array_equal(np.stack(frames), np.stack(recorded["jax"]))
    if section == "plot":  # the template's layer mode: the port runs it, JAX's stage raises
        layer = template_outputs["recipe"]["plot"]["plot_1"]
        assert layer["velocimetry"]["mode"] == "geographical"
        with pytest.raises(TypeError, match="multiple values for keyword argument 'mode'"):
            template_outputs["jax_proc"].plot(plot_1=copy.deepcopy(layer))


def test_validate_dir_when_hosts_race(tmp_path, monkeypatch):
    """The processes of a ``--num-hosts`` run start together on one output directory: one may create it
    between another's check and its own ``makedirs``. The port's ``validate_dir`` then goes on (the JAX
    package's raises FileExistsError: ROADMAP.md, queue C)."""
    real = os.makedirs

    def racing(path, *args, **kwargs):
        real(path, exist_ok=True)  # the other host creates the directory first
        return real(path, *args, **kwargs)

    monkeypatch.setattr(os, "makedirs", racing)
    assert tcli.validate_dir(None, None, str(tmp_path / "port")) == str(tmp_path / "port")
    with pytest.raises(FileExistsError):
        jcli.validate_dir(None, None, str(tmp_path / "jax"))


def test_cli_refusals(inputs, tmp_path, monkeypatch):
    """``--num-hosts 2 --host-id {0,1} --coordinator 127.0.0.1:<port>``: two CLI processes on the CPU
    (``PYORC_TPU_TORCH_DEVICE=cpu``, gloo) each run their frame segment of the clip and write
    ``host00<i>_piv.nc``; stitched in pair order they equal the one-host ``piv.nc`` of the whole clip,
    and host 0's ``manifest.json`` is what JAX's CLI writes. ``--lowmem`` is still not an option of the
    port. (The name is kept from when ``--num-hosts`` > 1 was refused.) The recipe has no ``normalize``:
    its mean image is taken over a host's own segment, so the segments would not stitch to one run."""
    from pyorc_tpu.cli import main as jmain
    from pyorc_tpu.parallel import distributed as jdist

    monkeypatch.chdir(tmp_path)
    recipe = copy.deepcopy(inputs["recipe"])
    recipe["video"] = {"start_frame": 0, "end_frame": N - 1, "h_a": 0.0}
    del recipe["frames"]["normalize"]
    for section in ("mask", "transect", "stiv"):
        recipe.pop(section, None)
    fn_recipe = tmp_path / "recipe.yml"
    fn_recipe.write_text(json.dumps(recipe))
    one = tmp_path / "one"
    result = CliRunner().invoke(tcli_main, [
        "velocimetry", "-V", inputs["clip"], "-c", inputs["cc"], "-r", str(fn_recipe), str(one),
    ])
    assert result.exit_code == 0, result.output
    out = tmp_path / "two"
    _, logs, manifest = chip_smoke.multihost_cli(inputs["clip"], inputs["cc"], fn_recipe, out, "cpu")
    assert [chip_smoke.host_launches(text) for text in logs] == [{"piv_pairs": 0, "piv_ensemble": 0}] * 2  # the CPU
    assert [seg["end_frame"] for seg in manifest["segments"].values()] == [5, N]
    want = tmp_path / "jax_manifest"
    want.mkdir()
    segs = jdist.segment_frame_ranges(N, 2)  # the entry of pyorc_tpu/cli/main.py:299-307
    jdist.write_segments_manifest(want, N, segs, lambda i, s, e: {"prefix": f"host{i:03d}_", "artifact": f"host{i:03d}_piv.nc"})
    assert (out / "manifest.json").read_text() == (want / "manifest.json").read_text()
    helps = [CliRunner().invoke(cli, ["velocimetry", "--help"]).output for cli in (tcli_main, jmain.cli)]
    for option in ("--num-hosts", "--host-id", "--coordinator"):
        assert all(option in text for text in helps), option
    whole = pyorc_tpu_torch.open_dataset(str(one / "piv.nc"))
    parts = [pyorc_tpu_torch.open_dataset(str(out / f"host{i:03d}_piv.nc")) for i in range(2)]
    assert [p["v_x"].shape[0] for p in parts] == [4, 3]
    for name in ("v_x", "v_y", "corr", "s2n"):
        stitched = np.concatenate([p[name].values for p in parts], axis=0)
        np.testing.assert_array_equal(stitched, whole[name].values, err_msg=name)
    result = CliRunner().invoke(tcli_main, [
        "velocimetry", "-V", inputs["clip"], "-c", inputs["cc"], "-r", str(fn_recipe), "--lowmem", str(tmp_path / "x"),
    ])
    assert result.exit_code == 2 and "No such option" in result.output, result.output
