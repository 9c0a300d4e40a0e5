"""The port's decode for the card, held on the CPU: the MP4 demuxer, the access units it hands a
decoder, the YUV conversion's plain version against libswscale and OpenCV, the decode plan, and the
libavcodec-to-YUV route end to end (its conversion through the plain version on CPU tensors).

The clips are ``tests/data/*.mp4`` (``tests/data/make_h264_clips.py``). The card's side (the
conversion kernel, NVDEC, the routes on CUDA tensors) is in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``'s ``nvdec_phase``; the kernel's own code runs here through the host-thread
stand-in of ``tests/test_torch_kernel_emulation.py``.
"""

import ctypes
import re
import shutil
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import pyorc_tpu_torch
from pyorc_tpu_torch.api import video as video_api
from pyorc_tpu_torch.io import mp4, native_decoder, nvdec
from pyorc_tpu_torch.ops import piv_kernels

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
CLIPS = ["particles_1080p.mp4", "gradient_4k.mp4", "color_322x242.mp4"]
SMALL = str(DATA / "color_322x242.mp4")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    pyorc_tpu_torch.set_device("cpu")
    monkeypatch.delenv("PYORC_TPU_NATIVE_DECODE", raising=False)


def _cv2_frames(path, gray=False):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames, times = [], []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if gray else img)
        times.append(cap.get(cv2.CAP_PROP_POS_MSEC))
    cap.release()
    return np.asarray(frames), np.asarray(times)


def _video(path, route=None, **kwargs):
    """A ``Video`` of ``path`` on ``route`` (None: the plan's; a card route here converts through the
    plain version on CPU tensors)."""
    with chip_smoke.decode_route(route), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "End frame ... cannot be read": the clips' edit list hides the last sample
        return pyorc_tpu_torch.Video(str(path), progress=False, **kwargs)


@pytest.mark.parametrize("name", CLIPS)
def test_demuxer_numbers_and_times_frames_as_cv2_and_the_native_scan(name):
    path = DATA / name
    track = mp4.open_mp4(str(path))
    assert track.refusal() is None
    _, cv2_ms = _cv2_frames(path, gray=True)
    assert track.n_frames == len(cv2_ms)
    assert np.array_equal(track.timestamps_ms(), cv2_ms)  # CAP_PROP_POS_MSEC's order of operations
    native = _video(path, "native")
    card = _video(path, "libav")
    host = _video(path, "cv2")
    assert card._decode_route == "libav" and native._decode_route == "native" and host._decode_route == "cv2"
    assert card.frame_number == native.frame_number == host.frame_number
    assert card.time == host.time
    # the pump multiplies by 1000 / timescale, cv2 and the demuxer divide, then multiply: the last bit
    np.testing.assert_allclose(card.time, native.time, rtol=1e-15, atol=0)
    assert card.fps == host.fps == native.fps and card.end_frame == host.end_frame
    # display order: presentation-time ranks, hidden samples (past the edit's end) are not frames
    ranks = track.rank[track.shown]
    assert sorted(ranks) == list(range(track.n_frames))
    assert np.all(np.diff(track.pts[track.display]) > 0)


def test_sps_and_layouts():
    track = mp4.open_mp4(str(DATA / "particles_1080p.mp4"))
    sps = track.profile
    assert (sps.coded_width, sps.coded_height, sps.crop, sps.width, sps.height) == (1920, 1088, (0, 0, 0, 8), 1920, 1080)
    assert (sps.profile_idc, sps.chroma_format_idc, sps.bit_depth_luma, sps.frame_mbs_only, sps.full_range) == (
        100, 1, 8, True, False)
    small = mp4.open_mp4(SMALL)
    assert (small.profile.coded_width, small.profile.coded_height, small.profile.crop) == (336, 256, (0, 14, 0, 14))
    assert small.mdat and small.mdat[0][0] > 0  # moov before mdat (faststart) ...
    kinds = [k for k, *_ in mp4._top_level(open(DATA / "particles_1080p.mp4", "rb"), track.file_size)]
    assert kinds.index("moov") > kinds.index("mdat")  # ... and after it
    assert np.flatnonzero(track.sync).tolist() == [0, 30, 60] and not track.leading
    assert track.nal_length_size == 4 and len(track.sps) == len(track.pps) == 1


def test_decode_span_and_open_gops():
    track = mp4.open_mp4(str(DATA / "particles_1080p.mp4"))
    assert track.decode_span(0, 1)[0] == 0
    assert track.decode_span(31, 2)[0] == 30
    d0, d1 = track.decode_span(29, 3)  # across a GOP boundary: from the first GOP's sync sample
    assert d0 == 0 and d1 == int(track.display[29:32].max()) + 1
    out = track.output_frames(d0, d1)
    assert set(range(29, 32)) <= set(out.tolist())
    # an open GOP: sample 4 is a sync sample, sample 5 (a leading picture) shows before it
    pts = np.array([0, 3, 1, 2, 5, 4, 6], np.int64)
    sync = np.array([1, 0, 0, 0, 1, 0, 0], bool)
    n = pts.size
    open_gop = mp4.Mp4Track(
        path="-", file_size=0, codec="avc1", width=2, height=2, matrix=mp4._IDENTITY, timescale=1,
        offset=np.zeros(n, np.int64), size=np.ones(n, np.int64), dts=np.arange(n), pts=pts, sync=sync,
        shown=np.ones(n, bool),
    )
    assert open_gop.leading
    assert open_gop.decode_span(int(open_gop.rank[4]), 1)[0] == 0  # one GOP earlier
    with pytest.raises(IndexError):
        open_gop.decode_span(6, 2)


@pytest.mark.parametrize("start,count", [(0, 5), (30, 4), (7, 3), (58, 6)])
def test_access_units_decode_to_the_pumps_frames(start, count, tmp_path):
    """The Annex-B bytes of a span, written as a raw .h264 stream and decoded by libav (OpenCV), give
    the native pump's frames at those positions: the bytes a card decoder gets."""
    import cv2

    path = str(DATA / "particles_1080p.mp4")
    track = mp4.open_mp4(path)
    d0, d1 = track.decode_span(start, count)
    data, sizes = track.access_units(d0, d1)
    assert sizes.sum() == data.size and data[:4].tobytes() == mp4.START_CODE
    raw = tmp_path / "span.h264"
    raw.write_bytes(data.tobytes())
    cap = cv2.VideoCapture(str(raw))
    got = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        got.append(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    cap.release()
    frames = track.output_frames(d0, d1)
    assert len(got) == len(frames)
    want = native_decoder.NativeVideoReader(path).read(start, count, gray=True)
    pos = {int(f): i for i, f in enumerate(frames)}
    assert np.array_equal(np.asarray([got[pos[f]] for f in range(start, start + count)]), want)


@pytest.mark.parametrize("case", ["exhaustive", "random 242x322", "random 18x34"])
def test_conversion_plain_equals_swscale_and_cv2_gray(case):
    import cv2

    lib, version = chip_smoke.swscale_library()  # OpenCV's bundled libswscale, else the system's
    if lib is None:
        pytest.skip(f"needs a libswscale to hold the conversion to: {version}")
    if case == "exhaustive":
        y, u, v = chip_smoke.exhaustive_planes()
    else:
        h, w = map(int, case.split()[1].split("x"))
        rng = np.random.default_rng(h)
        y = rng.integers(0, 256, (h, w), dtype=np.uint8)
        u, v = (rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8) for _ in range(2))
    want = chip_smoke.swscale_bgr(lib, y, u, v)
    planes = [torch.as_tensor(p)[None] for p in (y, u, v)]
    assert np.array_equal(nvdec.yuv420_to_frames(*planes, gray=False)[0].numpy(), want[..., ::-1])
    assert piv_kernels.KERNEL_ROUTE[nvdec.KERNEL] == "plain_cpu"
    assert np.array_equal(nvdec.yuv420_to_frames(*planes, gray=True)[0].numpy(), cv2.cvtColor(want, cv2.COLOR_BGR2GRAY))


def test_conversion_checks_its_inputs():
    y = torch.zeros(1, 4, 6, dtype=torch.uint8)
    with pytest.raises(ValueError, match="4:2:0"):
        nvdec.yuv420_to_frames(y, torch.zeros(1, 2, 2, dtype=torch.uint8), torch.zeros(1, 2, 2, dtype=torch.uint8), True)
    with pytest.raises(ValueError, match="uint8"):
        c = torch.zeros(1, 2, 3, dtype=torch.int32)
        nvdec.yuv420_to_frames(y, c, c, True)


def test_plan_routes(monkeypatch, tmp_path):
    # the CPU never takes NVDEC; the caps probe needs the kernels' library (no nvcc here) and says so
    assert nvdec.plan(SMALL, "cpu") == "the device is cpu, not a card"
    assert nvdec.plan(SMALL, "cuda") != "nvdec"
    clip = chip_smoke.write_clip(chip_smoke.advected_stack(64, 96, 6, "cpu"), tmp_path / "clip.avi")
    assert nvdec.plan(str(clip), "cuda").startswith("not an MP4/MOV")
    # routing by plan on a card (its device faked): libav, with NVDEC's answer in the reason; NVDEC is not
    # taken while its frames are not held to OpenCV's on a card
    monkeypatch.setattr(video_api, "get_device", lambda: torch.device("cuda"))
    monkeypatch.setattr(nvdec, "plan", lambda path, device: "nvdec")
    v = _video(SMALL)
    assert v._decode_route == "libav" and "NVDEC takes it, but" in v._decode_reason
    monkeypatch.setattr(nvdec, "plan", lambda path, device: "NVDEC unavailable: cuvidGetDecoderCaps: CUDA_ERROR_X")
    v = _video(SMALL)
    assert v._decode_route == "libav" and "CUDA_ERROR_X" in v._decode_reason
    # FFV1 and rotation stay on the host, with the reason
    v = _video(clip)
    assert v._decode_route in ("native", "cv2") and v._decode_reason.startswith("not an MP4/MOV")
    v = _video(SMALL, rotation=90)
    assert v._decode_route in ("native", "cv2") and "rotation" in v._decode_reason
    v = _video(SMALL, lazy=False)
    assert v._decode_route in ("native", "cv2") and "eager" in v._decode_reason
    # the checks' route override: NVDEC on a file the demuxer does not take raises
    with pytest.raises(RuntimeError, match="cannot take the nvdec route: not an MP4/MOV"):
        _video(clip, "nvdec")
    assert _video(SMALL, "cv2")._decode_route == "cv2" and _video(SMALL)._decode_route == "libav"


def test_refusals():
    track = mp4.open_mp4(SMALL)
    assert track.refusal() is None
    for change, why in [
        (dict(fragmented=True), "fragmented"),
        (dict(codec="hvc1"), "not H.264"),
        (dict(matrix=(0, 0x10000, 0, -0x10000, 0, 0, 0, 0, 0x40000000)), "rotates"),
        (dict(edit_trims=True), "hides the first samples"),
    ]:
        saved = {k: getattr(track, k) for k in change}
        for k, v in change.items():
            setattr(track, k, v)
        assert why in track.refusal()
        for k, v in saved.items():
            setattr(track, k, v)
    track.profile = track.profile.__class__(**{**track.profile.__dict__, "full_range": True})
    assert "full-range" in track.refusal()


@pytest.mark.parametrize("method", ["grayscale", "rgb", "bgr", "hsv"])
def test_libav_route_frames_equal_cv2(method):
    card, host = _video(SMALL, "libav"), _video(SMALL, "cv2")
    assert card._decode_route == "libav"
    positions = np.array([0, 1, 2, 5, 29, 30, 31, 39, 3])
    got, want = card._decode_frames(positions, method), host._decode_frames(positions, method)
    assert torch.is_tensor(got) == (method != "hsv")  # hsv is not the card's: the host converts it
    assert np.array_equal(np.asarray(got), want)
    assert np.array_equal(card.get_frame(7, method), host.get_frame(7, method))


def test_libav_route_lazy_chain_equals_cv2_route():
    """normalize -> project -> get_piv on the card route (decoded frames as tensors, the crop a view)
    bit for bit the cv2 route's, with the YUV bytes counted as the upload."""
    cc = chip_smoke.nadir_camera_config(242, 322, gcp_px=20, aoi_px=40, window_size=32)
    out = {}
    for route in ("libav", "cv2"):
        video = _video(SMALL, route, camera_config=cc, h_a=0.0)
        frames = video.get_frames()
        before = dict(pyorc_tpu_torch._device.COPY_BYTES)
        piv = frames.frames.normalize(samples=5).frames.project().frames.get_piv(window_size=32)
        moved = pyorc_tpu_torch._device.COPY_BYTES["h2d"] - before["h2d"]
        out[route] = (piv, moved)
    for name in ("v_x", "v_y", "corr", "s2n"):
        a, b = out["libav"][0][name].values, out["cv2"][0][name].values
        assert np.array_equal(a, b, equal_nan=True), name
    n_frames = len(video.frame_number)
    assert out["libav"][1] >= n_frames * 242 * 322 * 3 // 2  # YUV planes up (1.5 B a pixel), not gray frames


def test_truncated_clip_raises_on_the_card_route(tmp_path):
    short = chip_smoke.truncated_copy(DATA / "particles_1080p.mp4", tmp_path / "short.mp4")
    video = _video(short, "libav")
    assert video._decode_route == "libav" and len(video.frame_number) == 64  # the index lists every frame
    assert video._decode_frames(np.array([0]), "grayscale").shape == (1, 1080, 1920)
    with pytest.raises(IOError, match="truncated"):
        video._decode_frames(np.arange(60, 64), "grayscale")


def test_video_pickles_without_its_decoders():
    import pickle

    video = _video(SMALL, "libav")
    video._decode_frames(np.array([0]), "grayscale")
    assert video._card_reader_cache is not None
    clone = pickle.loads(pickle.dumps(video))
    assert getattr(clone, "_card_reader_cache", None) is None
    assert np.array_equal(clone.get_frame(3), video.get_frame(3))


def test_decode_modules_import_without_cv2():
    script = textwrap.dedent(
        """
        import sys
        for name in ("cv2", "jax", "jaxlib"):
            sys.modules[name] = None
        from pyorc_tpu_torch.io import libav, mp4, nvdec
        track = mp4.open_mp4(sys.argv[1])
        assert track.refusal() is None and track.n_frames == 40
        assert nvdec.plan(sys.argv[1], "cpu") == "the device is cpu, not a card"
        print("ok", libav.available())
        """
    )
    proc = subprocess.run([sys.executable, "-c", script, SMALL], capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.fixture(scope="module")
def host_nv12(tmp_path_factory):
    """``csrc/nv12.cu`` compiled as host C++ against the emulation's stand-in runtime, in which a vector
    load or store off its size's boundary fails the launch as on the card."""
    from test_torch_kernel_emulation import CUDA_RUNTIME_SHIM

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA source as host C++")
    tmp_path = tmp_path_factory.mktemp("nv12")
    (tmp_path / "cuda_runtime.h").write_text(CUDA_RUNTIME_SHIM)
    src = (ROOT / "pyorc_tpu_torch" / "csrc" / "nv12.cu").read_text()
    src, n = re.subn(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);", r"emu_launch(\2, [&]() { \1(\3); });", src, flags=re.S)
    assert n == 1
    (tmp_path / "nv12.cpp").write_text(src)
    lib_path = tmp_path / "libnv12.so"
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w", "-I", str(tmp_path),
                           "-o", str(lib_path), str(tmp_path / "nv12.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(lib_path))
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.yuv420_convert_launch.argtypes = [vp, i64, i, vp, vp, i64, i, i, i, i, i, vp, i, vp]
    lib.yuv420_convert_path.argtypes = [vp, i64, i, vp, vp, i64, i, i, i, vp]
    return lib


def _layout(kind, rng, n, h, w):
    """(y, u, v, c_frame, c_pitch, c_step) of random planes laid out as ``kind``."""
    def rand(*shape):
        return torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8))

    if kind.startswith("i420 batch"):  # libavcodec's planes back to back, as LibavVideoReader uploads them
        pad = 8 if kind.endswith("offset") else 0
        y, u, v = nvdec.i420_planes(rand(n, h * w * 3 // 2 + pad)[:, pad:], h, w)
        return y, u, v, u.stride(0), u.stride(1), 1
    if kind == "i420 odd pitch":
        y = rand(n, h, w + 3)[:, :, :w]
        u, v = rand(n, h // 2, w // 2 + 1)[..., : w // 2], rand(n, h // 2, w // 2 + 1)[..., : w // 2]
        return y, u, v, u.stride(0), u.stride(1), 1
    uv = rand(n, h // 2, w)  # NV12: U, V interleaved
    y = rand(n, h + 2, w + 6)[:, 1 : h + 1, 2 : w + 2] if kind == "nv12 offset view" else rand(n, h, w)
    return y, uv[:, :, 0::2], uv[:, :, 1::2], uv.stride(0), uv.stride(1), 2


@pytest.mark.parametrize(
    "kind,h,w,path",
    [
        ("i420 batch", 18, 32, 1),
        ("i420 batch", 6, 4128, 1),  # 258 strips a row: two blocks span it
        ("nv12", 18, 48, 1),
        ("i420 batch", 18, 34, 0),  # a partial last strip
        ("i420 batch", 18, 40, 0),
        ("i420 batch", 242, 322, 0),  # clip (c)'s size
        ("i420 batch offset", 18, 32, 0),
        ("i420 odd pitch", 18, 32, 0),
        ("nv12 offset view", 18, 34, 0),
    ],
)
def test_kernel_code_on_host_threads(host_nv12, kind, h, w, path):
    """The kernel's code through its C entry point on CPU tensors: the access path the layout takes
    (1: 16-byte vectors, 0: bytes), and bit for bit its plain version, gray and RGB."""
    n = 2
    y, u, v, c_frame, c_pitch, c_step = _layout(kind, np.random.default_rng(h * w), n, h, w)
    for gray in (True, False):
        out = torch.empty((n, h, w) if gray else (n, h, w, 3), dtype=torch.uint8)
        planes = (y.data_ptr(), y.stride(0), y.stride(1), u.data_ptr(), v.data_ptr(), c_frame, c_pitch, c_step)
        assert host_nv12.yuv420_convert_path(*planes, w, out.data_ptr()) == path
        assert host_nv12.yuv420_convert_launch(*planes, n, h, w, out.data_ptr(), int(gray), None) == 0
        assert torch.equal(out, nvdec.yuv420_to_frames_plain(y, u, v, gray))
    bad = torch.empty((1, 3, 4), dtype=torch.uint8)
    assert host_nv12.yuv420_convert_launch(y.data_ptr(), 0, 4, u.data_ptr(), v.data_ptr(), 0, 2, 1, 1, 3, 4,
                                           bad.data_ptr(), 1, None) != 0  # an odd height is refused


@pytest.mark.parametrize("h,w", [(1080, 1920), (2160, 3840)])
def test_kernel_path_of_the_main_paths_batches(host_nv12, h, w):
    """``i420_planes`` of a fresh batch at 1080p and 4K (frame strides 3,110,400 and 12,441,600 B) takes
    the 16-byte path; the same planes moved by 8 B, an output off 16 B, or NV12 chroma whose V is not
    U + 1, take the scalar one."""
    batch = torch.empty((2, h * w * 3 // 2), dtype=torch.uint8)  # its strides only: no frame is converted
    ys, us, vs = nvdec.i420_planes(batch, h, w)
    assert ys.stride() == us.stride()[:1] + (w, 1) and us.stride() == (h * w * 3 // 2, w // 2, 1)
    assert ys.stride(0) == {1080: 3_110_400, 2160: 12_441_600}[h]
    base, out = 1 << 20, 1 << 30  # the caching allocator's blocks start on 512 B

    def path(y=base, u=base + h * w, v=base + h * w * 5 // 4, o=out, c_step=1, c_pitch=w // 2):
        return host_nv12.yuv420_convert_path(y, ys.stride(0), w, u, v, us.stride(0), c_pitch, c_step, w, o)

    assert path() == 1
    assert path(y=base + 8, u=base + 8 + h * w, v=base + 8 + h * w * 5 // 4) == 0
    assert path(o=out + 8) == 0
    assert path(u=base + h * w, v=base + h * w + 1, c_step=2, c_pitch=w) == 1
    assert path(u=base + h * w, v=base + h * w + 2, c_step=2, c_pitch=w) == 0


SASS_LISTING = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_123yuv420_to_frames_kernelEPKhliS1_S1_liiiiPhiiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   ISETP.GE.AND P0, PT, R0, UR4, PT ;
        /*0020*/               @P0 EXIT ;
        /*0030*/              @!P1 BRA `(.L_x_0) ;
        /*0040*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0050*/                   LDG.E.64 R8, desc[UR4][R6.64] ;
        /*0060*/              @!P2 BRA `(.L_x_1) ;
        /*0070*/                   IMAD R10, R4, R5, R6 ;
        /*0080*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*0090*/                   STG.E.128 desc[UR4][R12.64], R8 ;
        /*00a0*/                   EXIT ;
.L_x_1:
        /*00b0*/                   IMAD R10, R4, R5, R6 ;
        /*00c0*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*00d0*/                   STG.E.128 desc[UR4][R2.64+0x10], R4 ;
        /*00e0*/                   STG.E.128 desc[UR4][R2.64+0x20], R4 ;
        /*00f0*/                   STG.E.128 desc[UR4][R12.64], R4 ;
        /*0100*/                   STG.E.128 desc[UR4][R12.64+0x10], R4 ;
        /*0110*/                   STG.E.128 desc[UR4][R12.64+0x20], R4 ;
        /*0120*/                   EXIT ;
.L_x_0:
        /*0130*/                   LDG.E.U8 R4, desc[UR4][R2.64] ;
        /*0140*/                   STG.E.U8 desc[UR4][R6.64], R4 ;
        /*0150*/                   EXIT ;
        /*0160*/                   BRA 0x160;
        /*0170*/                   NOP;
		Function : _Z5otherPf
        /*0000*/                   STG.E.128 desc[UR4][R4.64], R2 ;
        /*0010*/                   EXIT ;
"""


def test_chip_smoke_sass_vector_paths():
    """chip_smoke's count of the conversion's 16-byte path: only the named kernel; basic blocks from labels,
    branches and exits (a predicated EXIT or BRA falls through); for each number of 16-byte stores on a
    path (gray 2, RGB 6), the fewest instructions from the entry through such a store to an EXIT, and
    those over the strip's 32 pixels; the byte path and the self-branch after the last EXIT left out."""
    (got,) = chip_smoke.sass_vector_paths(SASS_LISTING)
    assert got == {"function_instructions": 23, "vector_paths": [
        {"stores": 2, "instructions": 11, "per_pixel": 0.34}, {"stores": 6, "instructions": 15, "per_pixel": 0.47}]}


@pytest.mark.parametrize("gray,ms", [(True, 0.0464), (False, 0.0836)])
def test_conversion_bound_is_the_bytes(gray, ms):
    """The conversion's bound at the lazy chain's batch (30 frames of 1080p): the bytes, 2.5 B a pixel
    gray and 4.5 B RGB at the card's memory rate, above its integer instructions' time."""
    from pyorc_tpu_torch.ops import roofline

    bound, by = roofline.yuv420_bound(30, 1080, 1920, gray)
    assert by == "bytes" and bound == pytest.approx(ms, abs=5e-5)
    assert bound == pytest.approx(1e3 * 30 * 1080 * 1920 * (2.5 if gray else 4.5) / roofline.PEAK_HBM_BYTES)
