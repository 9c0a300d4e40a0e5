"""The CUDA kernels against their plain versions on the card (skipped without one).

Run on a GPU machine with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from pyorc_tpu_torch.ops import piv as piv_ops
from pyorc_tpu_torch.ops import piv_kernels
from pyorc_tpu_torch.ops import windows as win

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _frames(rng, n_frames, h, w, zero_band=False, dtype=np.uint8):
    from scipy.ndimage import gaussian_filter, shift

    base = gaussian_filter(rng.uniform(0, 1, (h, w)) ** 8, 1.2, mode="wrap")
    base = base / base.max() * 220 + 20
    stack = np.stack([shift(base, (-1.4 * i, 2.3 * i), order=3, mode="wrap") for i in range(n_frames)])
    if zero_band:
        stack[:, h // 2 :, :] = 0
    return np.clip(stack, 0, 255).astype(dtype)


def _compare(out_k, out_p, gap):
    """NaN masks equal, |dcmax| <= 1e-4, s2n within 1e-3 relative, and u/v
    within 1e-3 px where the top-2 peak gap exceeds 5e-3."""
    for a, b in zip(out_k, out_p):
        assert a.shape == b.shape
        assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.nan_to_num((out_k[2] - out_p[2]).abs()).max() <= 1e-4
    assert torch.nan_to_num((out_k[3] - out_p[3]).abs() / out_p[3].abs().clamp(min=1e-6)).max() <= 1e-3
    confident = (gap > 5e-3) & ~torch.isnan(out_p[0])
    for a, b in zip(out_k[:2], out_p[:2]):
        assert (a - b).abs()[confident].max() <= 1e-3


def _gap(frames, dims, sas, overlap, pair_stride, shape):
    return piv_ops.top2_gap(frames, dims, sas, overlap, pair_stride).reshape(shape)


# every class of the transform's plan: powers of two, 2^a * 13, other odd parts up to 15, odd parts over 15
@pytest.mark.parametrize("size", [8, 12, 13, 14, 16, 17, 22, 24, 26, 32, 40, 48, 52, 64, 66, 72, 75, 96, 104, 120, 127, 128])
@pytest.mark.parametrize("pair_stride", [1, 2])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_kernel_matches_plain(cuda, size, pair_stride, dtype):
    rng = np.random.default_rng(size)
    h, w = 4 * size + 20, 6 * size + 8
    frames = torch.as_tensor(_frames(rng, 6, h, w, zero_band=size == 32, dtype=dtype), device=cuda)
    sas, overlap = (size, size), (size // 2, size // 2)
    n_rows, n_cols = win.get_field_shape((h, w), sas, overlap)
    args = ((h, w), sas, overlap, n_rows, n_cols)
    before = piv_kernels.LAUNCHES["piv_pairs"]
    out_k = piv_kernels.piv_pairs_fused(frames, *args, pair_stride=pair_stride)
    assert piv_kernels.LAUNCHES["piv_pairs"] == before + 1
    assert piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] == "cuda"
    out_p = piv_kernels.piv_pairs_fused_plain(frames, *args, pair_stride=pair_stride)
    torch.cuda.synchronize()
    _compare(out_k, out_p, _gap(frames, (h, w), sas, overlap, pair_stride, out_p[0].shape))


def test_kernel_signal_threshold(cuda):
    rng = np.random.default_rng(1)
    h, w = 96, 128
    stack = _frames(rng, 3, h, w)
    stack[:, :40, :48] = 0
    stack[1, 40:72, 48:80] = 0
    frames = torch.as_tensor(stack, device=cuda)
    sas, overlap = (16, 16), (8, 8)
    n_rows, n_cols = win.get_field_shape((h, w), sas, overlap)
    args = ((h, w), sas, overlap, n_rows, n_cols, 0.5)
    out_k = piv_kernels.piv_pairs_fused(frames, *args)
    out_p = piv_kernels.piv_pairs_fused_plain(frames, *args)
    assert torch.isnan(out_k[2]).any()
    _compare(out_k, out_p, _gap(frames, (h, w), sas, overlap, 1, out_p[0].shape))


@pytest.mark.parametrize("sas", [(64, 128), (128, 64), (32, 64), (16, 40), (72, 24), (75, 66), (26, 64), (75, 64), (128, 66)])
@pytest.mark.parametrize("pair_stride", [1, 2])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_kernel_matches_plain_non_square(cuda, sas, pair_stride, dtype):
    """Non-square windows, the FFT and the table DFT mixed per axis among them, 50 % overlap."""
    wy, wx = sas
    rng = np.random.default_rng(wy * 1000 + wx)
    h, w = 4 * wy + 20, 5 * wx + 8
    frames = torch.as_tensor(_frames(rng, 6, h, w, zero_band=sas == (32, 64), dtype=dtype), device=cuda)
    overlap = (wy // 2, wx // 2)
    n_rows, n_cols = win.get_field_shape((h, w), sas, overlap)
    args = ((h, w), sas, overlap, n_rows, n_cols)
    before = piv_kernels.LAUNCHES["piv_pairs"]
    out_k = piv_kernels.piv_pairs_fused(frames, *args, pair_stride=pair_stride)
    assert piv_kernels.LAUNCHES["piv_pairs"] == before + 1
    assert piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] == "cuda"
    out_p = piv_kernels.piv_pairs_fused_plain(frames, *args, pair_stride=pair_stride)
    torch.cuda.synchronize()
    _compare(out_k, out_p, _gap(frames, (h, w), sas, overlap, pair_stride, out_p[0].shape))


def test_kernel_raises_on_unsupported_geometry(cuda):
    frames = torch.zeros((3, 300, 300), device=cuda)
    for sas in ((130, 130), (6, 6), (136, 64)):
        overlap = (sas[0] // 2, sas[1] // 2)
        n_rows, n_cols = win.get_field_shape((300, 300), sas, overlap)
        before = piv_kernels.LAUNCHES["piv_pairs"]
        with pytest.raises(ValueError, match="sides of 8-128 px.*ROADMAP.md, queue B"):
            piv_kernels.piv_pairs_fused(frames, (300, 300), sas, overlap, n_rows, n_cols)
        assert piv_kernels.LAUNCHES["piv_pairs"] == before


def _compare_ensemble(out_k, out_p, corr_min):
    """Gates equal (no pair of these frames lies at a threshold), |d corr_sum| <=
    1e-4 * max(count, 1), counts equal, |d cmax| <= 1e-4, s2n within 1e-3 relative."""
    (sum_k, n_k, c_k, s_k), (sum_p, n_p, c_p, s_p) = out_k, out_p
    for a, b in zip(out_k, out_p):
        assert a.shape == b.shape and torch.isfinite(a).all()
    assert torch.equal(c_k > 0, c_p > 0) and torch.equal(n_k, n_p)
    assert ((sum_k - sum_p).abs().flatten(1).amax(1) <= 1e-4 * n_p.clamp(min=1)).all()
    assert (c_k - c_p).abs().max() <= 1e-4
    assert ((s_k - s_p).abs() / s_p.clamp(min=1e-6)).max() <= 1e-3


@pytest.mark.parametrize(
    "size,step",
    [
        (8, 4), (16, 8), (26, 13), (32, 16), (32, 12), (64, 32), (75, 37), (104, 52), (128, 64),
        (12, 6), (13, 6), (17, 8), (24, 12), (40, 20), (48, 24), (52, 26), (66, 33), (96, 48), (127, 63), (14, 7), (22, 11), (72, 36), (120, 60),
        ((64, 128), (32, 64)), ((16, 40), (8, 12)), ((128, 72), (40, 36)),
        ((26, 64), (13, 32)), ((75, 64), (37, 32)), ((128, 66), (64, 33)),
    ],
    ids=lambda v: "x".join(map(str, win._as2(v))),
)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("n_frames", [7, 8], ids=["6-pairs", "7-pairs"])
def test_ensemble_kernel_matches_plain(cuda, size, step, dtype, n_frames):
    """Every class of side of 8-128 px, square and not, with an even and an odd number of pairs."""
    sas, steps = win._as2(size), win._as2(step)
    rng = np.random.default_rng(sas[0] + sas[1] + steps[0])
    h, w = 4 * sas[0] + 20, 6 * sas[1] + 8
    frames = torch.as_tensor(_frames(rng, n_frames, h, w, zero_band=sas[0] == 32, dtype=dtype), device=cuda)
    overlap = (sas[0] - steps[0], sas[1] - steps[1])
    n_rows, n_cols = win.get_field_shape((h, w), sas, overlap)
    args = ((h, w), sas, overlap, n_rows, n_cols, 0.1, 1.5)
    before = piv_kernels.LAUNCHES["piv_ensemble"]
    out_k = piv_kernels.piv_ensemble_fused(frames, *args)
    assert piv_kernels.LAUNCHES["piv_ensemble"] == before + 1
    assert piv_kernels.KERNEL_ROUTE["piv_ensemble_fused"] == "cuda"
    out_p = piv_kernels.piv_ensemble_fused_plain(frames, *args)
    torch.cuda.synchronize()
    assert (out_p[1] > 0).any()
    _compare_ensemble(out_k, out_p, 0.1)


def test_ensemble_kernel_signal_threshold(cuda):
    rng = np.random.default_rng(2)
    h, w = 96, 128
    stack = _frames(rng, 4, h, w)
    stack[:, :40, :48] = 0
    stack[1, 40:72, 48:80] = 0
    frames = torch.as_tensor(stack, device=cuda)
    sas, overlap = (16, 16), (8, 8)
    n_rows, n_cols = win.get_field_shape((h, w), sas, overlap)
    args = ((h, w), sas, overlap, n_rows, n_cols, 0.1, 1.5, 0.5)
    out_k = piv_kernels.piv_ensemble_fused(frames, *args)
    out_p = piv_kernels.piv_ensemble_fused_plain(frames, *args)
    assert (out_p[1] == 0).any() and (out_p[1] > 0).any()
    _compare_ensemble(out_k, out_p, 0.1)


def test_ensemble_kernel_raises_on_unsupported_geometry(cuda):
    frames = torch.zeros((3, 300, 300), device=cuda)
    for sas in ((130, 130), (6, 6), (136, 64)):
        overlap = (sas[0] // 2, sas[1] // 2)
        n_rows, n_cols = win.get_field_shape((300, 300), sas, overlap)
        before = piv_kernels.LAUNCHES["piv_ensemble"]
        with pytest.raises(ValueError, match="sides of 8-128 px.*ROADMAP.md, queue B"):
            piv_kernels.piv_ensemble_fused(frames, (300, 300), sas, overlap, n_rows, n_cols)
        assert piv_kernels.LAUNCHES["piv_ensemble"] == before


def test_copies_are_counted_where_they_happen(cuda):
    """A tensor already on the card is neither copied nor counted, whether the card is named
    "cuda" or "cuda:0"; a pinned upload of a strided host view equals it and counts its bytes."""
    from pyorc_tpu_torch import _device

    host = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    view = host[:, 1:, 1:]
    before = _device.COPY_BYTES["h2d"]
    on_card = _device.to_device(host, cuda)
    assert _device.to_device(on_card, cuda) is on_card
    assert _device.to_device(on_card, "cuda:0") is on_card
    up = _device.PinnedUploader(cuda).upload(view)
    torch.cuda.synchronize()
    assert torch.equal(up.cpu(), torch.as_tensor(np.ascontiguousarray(view)))
    assert _device.COPY_BYTES["h2d"] - before == host.nbytes + view.nbytes
