"""The CUDA kernels' own code on the CPU, held to their plain versions.

``pyorc_tpu_torch/csrc/*.cu`` are compiled with g++ as host C++ against a
small stand-in for ``cuda_runtime.h`` that runs every CUDA thread of a block
as a host thread (``__syncthreads`` and the warp shuffles are barriers), and
the port's launch helpers call the result through ctypes on CPU tensors. This
checks the kernels' indexing, synchronisation and arithmetic where no card
and no nvcc exist; what only the card's compiler decides (registers, shared
memory limits, speed) stays with ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import contextlib
import re
import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from pyorc_tpu_torch.ops import piv_kernels
from pyorc_tpu_torch.ops import windows as win

from test_torch_cuda import _compare, _compare_ensemble, _frames, _gap

CSRC = Path(piv_kernels.__file__).resolve().parent.parent / "csrc"

# what the kernels use of the CUDA runtime, on host threads
CUDA_RUNTIME_SHIM = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <limits>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
using std::max;
using std::min;

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
const int cudaSuccess = 0;
typedef struct CUstream_st* cudaStream_t;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
const size_t emu_max_smem = 232448;  // a Hopper block's dynamic shared memory limit
inline int emu_error = 0;
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int bytes) { return bytes > (int)emu_max_smem ? 1 : 0; }
inline cudaError_t cudaGetLastError() { int e = emu_error; emu_error = 0; return e; }

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::vector<float> emu_smem;
inline std::barrier<>* emu_block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
inline std::vector<float> emu_lanes_f;
inline std::vector<int> emu_lanes_i;

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

template <class T>
inline T emu_shfl_xor(std::vector<T>& lanes, T v, int o) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    lanes[warp * 32 + lane] = v;
    emu_warp_barriers[warp]->arrive_and_wait();
    T r = lanes[warp * 32 + (lane ^ o)];
    emu_warp_barriers[warp]->arrive_and_wait();
    return r;
}
inline float __shfl_xor_sync(unsigned, float v, int o) { return emu_shfl_xor(emu_lanes_f, v, o); }
inline int __shfl_xor_sync(unsigned, int v, int o) { return emu_shfl_xor(emu_lanes_i, v, o); }

// Runs kernel() for every block of the grid, one host thread per CUDA thread;
// shared memory starts as NaN, so a read before a write shows in the results.
template <class F>
void emu_launch(dim3 grid, int threads, size_t smem, cudaStream_t, F kernel) {
    if (threads % 32 || threads > 1024 || smem > emu_max_smem) { emu_error = 9; return; }
    emu_smem.assign(smem / sizeof(float) + 1, std::numeric_limits<float>::quiet_NaN());
    blockDim = dim3(threads);
    gridDim = grid;
    std::barrier<> block_barrier(threads);
    emu_block_barrier = &block_barrier;
    emu_warp_barriers.clear();
    for (int w = 0; w < threads / 32; ++w) emu_warp_barriers.emplace_back(new std::barrier<>(32));
    emu_lanes_f.assign(threads, 0.f);
    emu_lanes_i.assign(threads, 0);
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) {
        pool.emplace_back([&, t] {
            threadIdx = dim3(t);
            for (unsigned by = 0; by < grid.y; ++by)
                for (unsigned bx = 0; bx < grid.x; ++bx) {
                    blockIdx = dim3(bx, by);
                    kernel();
                    block_barrier.arrive_and_wait();
                }
        });
    }
    for (auto& t : pool) t.join();
}
"""


@pytest.fixture(scope="module")
def emulated_library(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources as host C++")
    out = tmp_path_factory.mktemp("kernel_emulation")
    (out / "cuda_runtime.h").write_text(CUDA_RUNTIME_SHIM)
    shared = ("extern __shared__ float smem[];", "float* smem = emu_smem.data();")
    for header in CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text().replace(*shared))
    sources = []
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text().replace(*shared)
        # kernel<T><<<grid, block, smem, stream>>>(args); -> emu_launch(grid, block, smem, stream, [&] { kernel<T>(args); });
        text, n = re.subn(
            r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);", r"emu_launch(\2, [&]() { \1(\3); });", text, flags=re.S
        )
        assert n == 1, f"{src.name}: expected one kernel launch, found {n}"
        sources.append(out / (src.stem + ".cpp"))
        sources[-1].write_text(text)
    lib = out / "libpiv_emulated.so"
    proc = subprocess.run(
        # PIV_SMS=0: no grid is too small for the per-pair kernel to walk runs of pairs
        [gxx, "-std=c++20", "-O2", "-DPIV_SMS=0", "-shared", "-fPIC", "-pthread", "-w", "-I", str(out), "-o", str(lib),
         *map(str, sources)],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    return lib


@pytest.fixture
def kernels(emulated_library, monkeypatch):
    """piv_kernels with its launch helpers bound to the emulated library."""
    monkeypatch.setattr(piv_kernels, "build_library", lambda: emulated_library)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    piv_kernels._library.cache_clear()
    torch.set_num_threads(2)
    yield piv_kernels
    piv_kernels._library.cache_clear()


def _grid(h, w, size, step):
    """(dim_size, sas, overlap, n_rows, n_cols); ``size`` and ``step`` are ints (square) or (y, x) pairs."""
    sas, steps = win._as2(size), win._as2(step)
    overlap = (sas[0] - steps[0], sas[1] - steps[1])
    return ((h, w), sas, overlap, *win.get_field_shape((h, w), sas, overlap))


def _dark(stack):
    """Dark corners (below a 0.5 signal threshold) and a band dark in one frame."""
    h, w = stack.shape[1:]
    stack[:, : h // 3, : w // 3] = 0
    stack[1, h // 3 : 2 * h // 3, w // 3 : 2 * w // 3] = 0
    return stack


@pytest.mark.parametrize(
    "size,dtype,threshold,zero_band",
    [(16, np.uint8, None, False), (26, np.float32, None, True), (16, np.uint8, 0.5, False)],
    ids=["16-u8", "26-f32-zero", "16-threshold"],
)
def test_pairs_kernel_code_matches_plain(kernels, size, dtype, threshold, zero_band):
    rng = np.random.default_rng(size)
    h, w = 3 * size + 10, 4 * size + 6
    stack = _frames(rng, 3, h, w, zero_band=zero_band, dtype=dtype)
    frames = torch.as_tensor(_dark(stack) if threshold else stack)
    args = _grid(h, w, size, size // 2)
    out_k = kernels._launch(frames, args[1], (size // 2, size // 2), *args[3:], threshold, 1)
    out_p = kernels.piv_pairs_fused_plain(frames, *args, threshold)
    if threshold:
        assert torch.isnan(out_p[2]).any()
    _compare(out_k, out_p, _gap(frames, *args[:3], 1, out_p[0].shape))


@pytest.mark.parametrize(
    "size,pair_stride,dtype,zero_band",
    [
        (104, 1, np.uint8, False),
        (104, 2, np.float32, True),
        (128, 1, np.float32, False),
        (128, 2, np.uint8, False),
        (75, 1, np.float32, False),
    ],
    ids=["104-u8", "104-stride2-zero", "128-f32", "128-stride2", "75-odd"],
)
def test_pairs_kernel_code_large_windows(kernels, size, pair_stride, dtype, zero_band):
    """Sides over 64 px (104 = 8 x 13 and 128 on the FFT, 75 on the table DFT) on six windows of two pairs."""
    rng = np.random.default_rng(size + pair_stride)
    h, w = size + size // 2 + 3, 2 * size + 1
    stack = _frames(rng, 2 + pair_stride, h, w, dtype=dtype)
    if zero_band:
        stack[:, size // 2 :, :] = 0  # the second row of windows has zero variance
    frames = torch.as_tensor(stack)
    args = _grid(h, w, size, size // 2)
    assert args[3] * args[4] == 6
    out_k = kernels._launch(frames, args[1], (size // 2, size // 2), *args[3:], None, pair_stride)
    out_p = kernels.piv_pairs_fused_plain(frames, *args, pair_stride=pair_stride)
    assert out_p[0].shape[0] == 2 and torch.isnan(out_p[0]).any() == zero_band
    _compare(out_k, out_p, _gap(frames, *args[:3], pair_stride, out_p[0].shape))


@pytest.mark.parametrize(
    "size,step,dtype,threshold,zero_band",
    [
        (8, 4, np.float32, None, False),
        (16, 8, np.uint8, None, False),
        (26, 13, np.float32, None, True),
        (32, 12, np.uint8, None, False),
        (64, 32, np.uint8, None, False),
        (16, 8, np.uint8, 0.5, False),
    ],
    ids=["8-f32", "16-u8", "26-f32-zero", "32-step12", "64-u8", "16-threshold"],
)
def test_ensemble_kernel_code_matches_plain(kernels, size, step, dtype, threshold, zero_band):
    rng = np.random.default_rng(size + step)
    h, w = 3 * size + 10, 4 * size + 6
    stack = _frames(rng, 5, h, w, zero_band=zero_band, dtype=dtype)
    frames = torch.as_tensor(_dark(stack) if threshold else stack)
    args = _grid(h, w, size, step)
    out_k = kernels._launch_ensemble(frames, args[1], (step, step), *args[3:], 0.1, 1.5, threshold)
    out_p = kernels.piv_ensemble_fused_plain(frames, *args, 0.1, 1.5, threshold)
    assert (out_p[1] > 0).any()
    if zero_band or threshold:
        assert (out_p[1] == 0).any()
    _compare_ensemble(out_k, out_p, 0.1)


@pytest.mark.parametrize(
    "sas,pair_stride,dtype,zero_band",
    [
        ((16, 40), 1, np.float32, False),
        ((40, 16), 2, np.uint8, True),
        ((72, 24), 2, np.float32, False),
        ((24, 80), 1, np.uint8, True),
        ((75, 66), 1, np.float32, False),
    ],
    ids=["16x40", "40x16-stride2-zero", "72x24-packed-stride2", "24x80-packed-zero", "75x66-packed-odd"],
)
def test_pairs_kernel_code_non_square(kernels, sas, pair_stride, dtype, zero_band):
    """Non-square windows, each axis on its own plan (72 = 8 x 9 and 24, 80, 40,
    16 on the FFT; 75 and 66 on the table DFT), on four to six windows of two
    pairs, at 50 % overlap."""
    wy, wx = sas
    rng = np.random.default_rng(wy * 1000 + wx)
    h, w = wy + wy // 2 + 3, 2 * wx + 1
    stack = _frames(rng, 2 + pair_stride, h, w, dtype=dtype)
    if zero_band:
        stack[:, wy // 2 :, :] = 0  # the second row of windows has zero variance
    frames = torch.as_tensor(stack)
    steps = (wy // 2, wx // 2)
    args = _grid(h, w, sas, steps)
    assert args[3] * args[4] in (4, 6)
    out_k = kernels._launch(frames, sas, steps, *args[3:], None, pair_stride)
    out_p = kernels.piv_pairs_fused_plain(frames, *args, pair_stride=pair_stride)
    assert out_p[0].shape[0] == 2 and torch.isnan(out_p[0]).any() == zero_band
    _compare(out_k, out_p, _gap(frames, *args[:3], pair_stride, out_p[0].shape))


@pytest.mark.parametrize(
    "sas,steps,dtype,threshold,zero_band",
    [
        ((16, 32), (8, 12), np.float32, None, False),
        ((80, 80), (40, 40), np.uint8, None, False),
        ((72, 96), (36, 48), np.float32, None, True),
        ((66, 24), (33, 12), np.uint8, 0.5, False),
    ],
    ids=["16x32-small", "80-packed", "72x96-packed-zero", "66x24-packed-threshold"],
)
def test_ensemble_kernel_code_large_and_non_square(kernels, sas, steps, dtype, threshold, zero_band):
    """The ensemble kernel at sides over 64 px and non-square windows (66 on
    the table DFT, the rest on the FFT), five frames: two steps and half a step."""
    wy, wx = sas
    rng = np.random.default_rng(wy + wx)
    h, w = wy + 2 * steps[0] + 5, wx + 2 * steps[1] + 3
    stack = _frames(rng, 5, h, w, dtype=dtype)
    if zero_band:
        stack[:, 2 * steps[0] :, :] = 0  # the last row of windows has zero variance
    frames = torch.as_tensor(_dark(stack) if threshold else stack)
    args = _grid(h, w, sas, steps)
    assert args[3] * args[4] == 9
    out_k = kernels._launch_ensemble(frames, sas, steps, *args[3:], 0.1, 1.5, threshold)
    out_p = kernels.piv_ensemble_fused_plain(frames, *args, 0.1, 1.5, threshold)
    assert (out_p[1] > 0).any()
    if zero_band:
        assert (out_p[1] == 0).any()
    if threshold:
        assert (out_p[1] < 4).any()  # the band dark in frame 1 takes out two pairs
    _compare_ensemble(out_k, out_p, 0.1)


# One side of every class of the transform's plan: powers of two, 2^a * 13,
# other odd parts up to 15 (all on the in-block FFT), odd parts over 15 (the
# table DFT along that axis), and windows that mix the classes per axis.
PLAN_SIDES = [
    8, 16, 32, 64, 128, 26, 52, 104, 12, 13, 24, 40, 48, 96, 17, 66, 75, 127,
    (64, 128), (26, 64), (75, 64), (128, 66), (13, 17), 14, 22, 72, 120,
]


def _plan_id(size):
    return "x".join(map(str, win._as2(size)))


@pytest.mark.parametrize("size", PLAN_SIDES, ids=_plan_id)
def test_pairs_kernel_code_plan_classes(kernels, size):
    """The per-pair kernel at every class of side, four to six windows of two
    pairs; dtype, pair_stride and a zero-variance row of windows alternate."""
    wy, wx = win._as2(size)
    case = PLAN_SIDES.index(size)
    pair_stride, dtype, zero_band = 1 + case % 2, (np.uint8, np.float32)[case // 2 % 2], case % 3 == 0
    rng = np.random.default_rng(1000 * wy + wx)
    h, w = wy + wy // 2 + 3, 2 * wx + 1
    stack = _frames(rng, 2 + pair_stride, h, w, dtype=dtype)
    if zero_band:
        stack[:, wy // 2 :, :] = 0  # the second row of windows has zero variance
    frames = torch.as_tensor(stack)
    steps = (wy // 2, wx // 2)
    args = _grid(h, w, (wy, wx), steps)
    assert args[3] * args[4] in (4, 6)
    out_k = kernels._launch(frames, (wy, wx), steps, *args[3:], None, pair_stride)
    out_p = kernels.piv_pairs_fused_plain(frames, *args, pair_stride=pair_stride)
    assert out_p[0].shape[0] == 2 and torch.isnan(out_p[0]).any() == zero_band
    _compare(out_k, out_p, _gap(frames, *args[:3], pair_stride, out_p[0].shape))


@pytest.mark.parametrize("n_frames", [4, 5], ids=["3-pairs", "4-pairs"])
@pytest.mark.parametrize("size", PLAN_SIDES, ids=_plan_id)
def test_ensemble_kernel_code_plan_classes(kernels, size, n_frames):
    """The ensemble kernel at every class of side with an odd and an even
    number of pairs (a step takes two frames: the tail is half a step), four
    windows; dtype, a signal threshold and a zero-variance row alternate."""
    wy, wx = win._as2(size)
    case = PLAN_SIDES.index(size)
    dtype, threshold = (np.uint8, np.float32)[case % 2], (None, 0.5)[case % 4 == 3]
    zero_band = case % 3 == 0 and not threshold
    rng = np.random.default_rng(wy + 1000 * wx + n_frames)
    steps = (wy // 2, wx // 2)
    h, w = wy + steps[0] + 2, wx + steps[1] + 3
    stack = _frames(rng, n_frames, h, w, dtype=dtype)
    if zero_band:
        stack[:, steps[0] :, :] = 0  # the second row of windows has zero variance
    if threshold:
        stack[:, : 3 * wy // 4, : 3 * wx // 4] = 0  # window (0, 0) falls below the signal threshold
    frames = torch.as_tensor(stack)
    args = _grid(h, w, (wy, wx), steps)
    assert args[3] * args[4] == 4
    out_k = kernels._launch_ensemble(frames, (wy, wx), steps, *args[3:], 0.1, 1.5, threshold)
    out_p = kernels.piv_ensemble_fused_plain(frames, *args, 0.1, 1.5, threshold)
    assert (out_p[1] > 0).any()
    if zero_band or threshold:
        assert (out_p[1] < n_frames - 1).any()
    _compare_ensemble(out_k, out_p, 0.1)


@pytest.mark.parametrize("n_frames", [5, 6], ids=["4-pairs", "5-pairs"])
@pytest.mark.parametrize("size", [16, 26, 64, 24, 75, (26, 64), (66, 16)], ids=_plan_id)
def test_pairs_kernel_code_runs_of_pairs(kernels, size, n_frames):
    """Consecutive pairs in runs (a block walks up to 15 pairs of its window,
    each frame transformed once, two planes per inverse): 4 pairs are a run of
    3 and one of 1, 5 pairs one run of 5; a zero-variance row of windows."""
    wy, wx = win._as2(size)
    rng = np.random.default_rng(wy + 1000 * wx + n_frames)
    steps = (wy // 2, wx // 2)
    h, w = wy + steps[0] + 2, wx + steps[1] + 3
    stack = _frames(rng, n_frames, h, w, dtype=(np.uint8, np.float32)[n_frames % 2])
    stack[:, steps[0] :, :] = 0  # the second row of windows has zero variance
    frames = torch.as_tensor(stack)
    args = _grid(h, w, (wy, wx), steps)
    assert args[3] * args[4] == 4
    out_k = kernels._launch(frames, (wy, wx), steps, *args[3:], None, 1)
    out_p = kernels.piv_pairs_fused_plain(frames, *args)
    assert out_p[0].shape[0] == n_frames - 1 and torch.isnan(out_p[0]).any()
    _compare(out_k, out_p, _gap(frames, *args[:3], 1, out_p[0].shape))
