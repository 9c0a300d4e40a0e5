"""The port's per-pair PIV (pyorc_tpu_torch.ops.piv / piv_kernels) against the
JAX package on the CPU: window gathers, correlation planes, the Pallas
per-pair contract (kernels run in interpret mode) and the signal threshold.
Inputs are made with numpy from seeds and handed to both packages."""

import numpy as np
import pytest
import torch

from pyorc_tpu.ops import piv as jpiv
from pyorc_tpu.ops import piv_pallas
from pyorc_tpu.ops import windows as jwin

import pyorc_tpu_torch
from pyorc_tpu_torch.ops import piv as tpiv
from pyorc_tpu_torch.ops import piv_kernels
from pyorc_tpu_torch.ops import windows as twin

from test_piv import make_particle_image, shift_image


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)


def _stack(rng, h, w, shifts):
    img = make_particle_image(rng, h, w)
    return np.stack([shift_image(img, dx, dy) for dx, dy in shifts]).astype(np.float32)


@pytest.mark.parametrize(
    "dims,sas,overlap",
    [((64, 96), (16, 16), (8, 8)), ((117, 208), (26, 26), (13, 13)), ((90, 100), (20, 12), (5, 4))],
)
def test_windows_and_field_shape_exact(rng, dims, sas, overlap):
    assert twin.get_field_shape(dims, sas, overlap) == jwin.get_field_shape(dims, sas, overlap)
    for a, b in zip(twin.get_window_starts(dims, sas, overlap), jwin.get_window_starts(dims, sas, overlap)):
        np.testing.assert_array_equal(a, b)
    frames = rng.normal(size=(2,) + dims).astype(np.float32)
    row0, col0 = jwin.get_window_starts(dims, sas, overlap)
    want = np.asarray(jpiv.extract_windows(frames, row0, col0, sas[0], sas[1]))
    got = tpiv.extract_windows(torch.as_tensor(frames), row0, col0, sas[0], sas[1]).numpy()
    np.testing.assert_array_equal(got, want)
    # an irregular grid takes the index_select gather
    row0 = np.array([0, 3, 11, 20])
    got = tpiv.extract_windows(torch.as_tensor(frames), row0, col0, sas[0], sas[1]).numpy()
    want = np.asarray(jpiv.extract_windows(frames, row0, col0, sas[0], sas[1]))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sas,dims", [((16, 16), (64, 96)), ((26, 26), (78, 104)), ((64, 64), (128, 160))])
def test_corr_planes_match_jax(rng, sas, dims):
    """fp32 rfft2 planes vs the JAX XLA pipeline (atol 1e-4: fp32 FFTs of
    different libraries on coefficients <= 1)."""
    overlap = (sas[0] // 2, sas[1] // 2)
    imgs = _stack(rng, dims[0], dims[1], [(0, 0), (1.5, -0.75), (2.25, 1.0)])
    want = np.asarray(jpiv._cross_corr_jit(imgs, dims, sas, overlap, False, None, "fft"))
    got = tpiv.cross_corr(torch.as_tensor(imgs), dims, sas, overlap).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def _gap(imgs, dims, sas, overlap, n_rows, n_cols, pair_stride=1):
    gap = tpiv.top2_gap(torch.as_tensor(imgs), dims, sas, overlap, pair_stride)
    return gap.reshape(-1, n_rows, n_cols).numpy()


def _assert_contract_close(got, want, gap):
    """Gap-conditioned parity (tests/test_piv.py:248-269): NaN masks equal,
    stats close, and windows whose top-2 peaks differ by > 5e-3 agree to
    0.1 px; only near-tie double peaks may flip."""
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (np.isnan(g) == np.isnan(w)).all()
    for g, w in zip(got[:2], want[:2]):  # u, v
        d = np.abs(g - w)[~np.isnan(w)]
        if d.size:
            assert np.quantile(d, 0.95) < 0.02
            assert d.max() < 1.0
    np.testing.assert_allclose(got[2], want[2], atol=5e-3)  # cmax
    du = np.hypot(got[0] - want[0], got[1] - want[1])
    confident = ~np.isnan(du) & (gap > 5e-3)
    if confident.any():
        assert du[confident].max() < 0.1
    np.testing.assert_allclose(got[3], want[3], atol=0.15)  # s2n


@pytest.mark.parametrize(
    "sas,dims,n_frames,pair_stride,zero_band,route",
    [
        ((16, 16), (72, 160), 3, 1, False, "tileband_sf"),  # B1, geul's 16 px
        ((26, 26), (117, 208), 3, 1, False, "tileband_sf"),  # B1, ngwerere's 26 px
        ((32, 32), (96, 192), 3, 1, True, "tileband_sf"),  # B1 with a zero-variance band
        ((16, 16), (72, 160), 3, 1, True, "tileband_sf"),
        ((64, 64), (160, 224), 3, 1, False, "sliced"),  # B2
        ((26, 26), (117, 208), 2, 1, False, "tileband"),  # B3: a two-frame tail chunk
        ((16, 16), (72, 160), 4, 2, False, "tileband"),  # B3: interleaved pairs
        ((64, 64), (160, 224), 4, 2, True, "sliced"),  # B2: interleaved pairs
    ],
    ids=["16", "26", "32-zero", "16-zero", "64", "26-two-frames", "16-stride2", "64-stride2-zero"],
)
def test_plain_matches_pallas_interpret(rng, sas, dims, n_frames, pair_stride, zero_band, route):
    shifts = [(0, 0), (2.0, -1.0), (3.5, 1.25), (1.0, 2.5)][:n_frames]
    imgs = _stack(rng, dims[0], dims[1], shifts) * 200.0
    if zero_band:
        imgs[:, dims[0] // 2 :, :] = 0.0  # windows there have zero variance
    overlap = (sas[0] // 2, sas[1] // 2)
    n_rows, n_cols = jwin.get_field_shape(dims, sas, overlap)
    want = [
        np.asarray(x)
        for x in piv_pallas.piv_pairs_fused(
            imgs, dims, sas, overlap, n_rows, n_cols, interpret=True, pair_stride=pair_stride
        )
    ]
    assert piv_pallas.KERNEL_ROUTE["piv_pairs_fused"] == route
    got = [
        x.numpy()
        for x in piv_kernels.piv_pairs_fused(
            torch.as_tensor(imgs), dims, sas, overlap, n_rows, n_cols, pair_stride=pair_stride
        )
    ]
    assert piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] == "plain_cpu"
    n_pairs = n_frames - 1 if pair_stride == 1 else n_frames // 2
    assert got[0].shape == (n_pairs, n_rows, n_cols)
    if zero_band:
        # the Pallas contract where a window has zero variance: NaN u/v, 0 stats
        dead = np.isnan(want[0])
        assert dead.any() and (got[2][dead] == 0).all() and (got[3][dead] == 0).all()
    _assert_contract_close(got, want, _gap(imgs, dims, sas, overlap, n_rows, n_cols, pair_stride))


def test_signal_threshold_matches_xla(rng):
    """Pairs below the signal threshold: NaN corr_max and s2n as in the XLA
    pipeline (piv.py:290-293); the port's contract also NaNs u and v there,
    where XLA leaves the placeholder 1 - w//2."""
    dims, sas, overlap = (96, 128), (16, 16), (8, 8)
    imgs = _stack(rng, dims[0], dims[1], [(0, 0), (1.5, 0.5), (2.0, -1.0)]) * 200.0 + 5.0
    imgs[:, :40, :48] = 0.0  # fully dark: below any threshold
    imgs[1, 40:72, 48:80] = 0.0  # dark in one frame of both pairs
    imgs[:, 72:, 100:] *= rng.uniform(size=(3, 24, 28)) > 0.6  # sparse texture
    n_rows, n_cols = jwin.get_field_shape(dims, sas, overlap)
    thr = 0.5
    want = [np.asarray(x) for x in jpiv.piv_pairs(imgs, dims, sas, overlap, n_rows, n_cols, thr, "fft")]
    got = [
        x.numpy()
        for x in piv_kernels.piv_pairs_fused(torch.as_tensor(imgs), dims, sas, overlap, n_rows, n_cols, thr)
    ]
    low = np.isnan(want[2])
    assert low.any() and (~low).any()
    for g, w in zip(got[2:], want[2:]):
        assert (np.isnan(g) == np.isnan(w)).all()
    np.testing.assert_allclose(got[2][~low], want[2][~low], atol=1e-4)
    np.testing.assert_allclose(got[3][~low], want[3][~low], rtol=1e-3)
    for g, w in zip(got[:2], want[:2]):
        assert np.isnan(g[low]).all()
        np.testing.assert_allclose(g[~low], w[~low], atol=1e-3)


def test_plain_piv_pairs_matches_xla(rng):
    """The port's XLA-semantics piv_pairs (NaN-skipping stats) against JAX."""
    dims, sas, overlap = (72, 160), (16, 16), (8, 8)
    imgs = _stack(rng, dims[0], dims[1], [(0, 0), (2.0, -1.0), (3.5, 1.25)])
    n_rows, n_cols = jwin.get_field_shape(dims, sas, overlap)
    want = [np.asarray(x) for x in jpiv.piv_pairs(imgs, dims, sas, overlap, n_rows, n_cols, None, "fft")]
    got = [x.numpy() for x in tpiv.piv_pairs(torch.as_tensor(imgs), dims, sas, overlap, n_rows, n_cols)]
    _assert_contract_close(got, want, _gap(imgs, dims, sas, overlap, n_rows, n_cols))


def test_subpixel_ties_break_on_first_index():
    plane = np.zeros((2, 8, 8), np.float32)
    plane[0, 2, 5] = plane[0, 6, 1] = 1.0  # tie: the row-major first wins
    plane[1, 3, 3] = plane[1, 3, 6] = 0.5
    want = [np.asarray(x) for x in jpiv.subpixel_peak(plane)]
    got = [x.numpy() for x in tpiv.subpixel_peak(torch.as_tensor(plane))]
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[0], [2.0, 3.0], atol=1e-6)


def test_kernel_wrapper_rejects_unsupported_geometry():
    """Geometries the CUDA kernel does not take (a side under 8 or over 128 px) raise before any launch."""
    frames = torch.zeros((3, 64, 64))
    for sas in ((6, 6), (130, 130), (136, 64)):
        assert not piv_kernels.kernel_takes(sas)
        with pytest.raises(ValueError, match="sides of 8-128 px.*ROADMAP.md, queue B"):
            piv_kernels._launch(frames, sas, (sas[0] // 2, sas[1] // 2), 3, 3, None, 1)
    assert all(piv_kernels.kernel_takes(sas) for sas in ((8, 8), (128, 128), (64, 128), (8, 128), (75, 66)))
    with pytest.raises(ValueError, match="does not match"):
        piv_kernels.piv_pairs_fused(frames, (64, 64), (16, 16), (8, 8), 5, 7)
    with pytest.raises(ValueError, match="pair_stride"):
        piv_kernels.piv_pairs_fused(frames, (64, 64), (16, 16), (8, 8), 7, 7, pair_stride=3)
    with pytest.raises(ValueError, match="dim_size"):  # windows would read past the frames
        piv_kernels.piv_pairs_fused(frames, (96, 64), (16, 16), (8, 8), 11, 7)


@pytest.mark.parametrize(
    "sas,dims,zero_band",
    [((64, 128), (192, 416), False), ((32, 64), (112, 288), True), ((128, 64), (320, 224), False)],
    ids=["64x128", "32x64-zero", "128x64"],
)
def test_plain_non_square_matches_xla(rng, sas, dims, zero_band):
    """The kernel's plain version at non-square windows (50 % overlap) against
    JAX's XLA pipeline ``ops/piv.piv_pairs``, which is what JAX computes for
    them correctly (its Pallas route raises, see below). The two documented
    Pallas-vs-XLA differences are masked: a zero-variance window gives NaN u/v
    and s2n 0 in the port where XLA gives a placeholder and NaN s2n (ROADMAP
    C). Elsewhere the gap-conditioned contract bounds of
    ``_assert_contract_close`` hold."""
    imgs = _stack(rng, dims[0], dims[1], [(0, 0), (2.0, -1.0), (3.5, 1.25)]) * 200.0
    if zero_band:
        imgs[:, dims[0] // 2 :, :] = 0.0
    overlap = (sas[0] // 2, sas[1] // 2)
    n_rows, n_cols = jwin.get_field_shape(dims, sas, overlap)
    assert twin.get_field_shape(dims, sas, overlap) == (n_rows, n_cols) and n_rows * n_cols >= 9
    want = [np.array(x) for x in jpiv.piv_pairs(imgs, dims, sas, overlap, n_rows, n_cols, None, "fft")]
    got = [
        x.numpy()
        for x in piv_kernels.piv_pairs_fused(torch.as_tensor(imgs), dims, sas, overlap, n_rows, n_cols)
    ]
    assert piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] == "plain_cpu"
    dead = np.isnan(got[0])
    assert dead.any() == zero_band
    if zero_band:
        assert np.isnan(got[1][dead]).all() and (got[2][dead] == 0).all() and (got[3][dead] == 0).all()
        assert (want[2][dead] == 0).all() and np.isnan(want[3][dead]).all()
        for g, w in zip(got, want):
            g[dead] = w[dead] = 0.0
    _assert_contract_close(got, want, _gap(imgs, dims, sas, overlap, n_rows, n_cols))


def test_jax_pallas_non_square_fault():
    """Pins a fault of the JAX package: on the geometry its Pallas route takes
    for non-square windows (both sides >= 64 px, 8-aligned), ``_packed_mats``
    ``np.stack``s the wx x wx and wy x wy DFT matrices and raises, and
    ``_recoverable`` lets that ValueError through (ROADMAP C). The port holds
    its non-square kernels against JAX's XLA pipeline instead. When JAX is
    fixed, this test fails and says so."""
    dims, sas, overlap = (128, 256), (64, 128), (32, 64)
    n_rows, n_cols = jwin.get_field_shape(dims, sas, overlap)
    imgs = np.random.default_rng(0).uniform(0, 200, (3,) + dims).astype(np.float32)
    assert piv_pallas._fused_geometry_ok(64, 128, 32, 64)
    with pytest.raises(ValueError, match="same shape") as err:
        piv_pallas.piv_pairs_fused(imgs, dims, sas, overlap, n_rows, n_cols, interpret=True)
    assert "_packed_mats" in {entry.name for entry in err.traceback}
