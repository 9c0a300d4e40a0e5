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
import functools
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

from test_torch_cuda import (
    DEFORM_CASES, _compare, _compare_ensemble, _frames, _gap, check_halo_misses, deform_inputs,
)

CSRC = Path(piv_kernels.__file__).resolve().parent.parent / "csrc"

# what the kernels use of the CUDA runtime, on host threads
CUDA_RUNTIME_SHIM = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
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

struct alignas(8) float2 {
    float x, y;
};
struct alignas(16) float4 {
    float x, y, z, w;
};
struct alignas(8) uint2 {
    unsigned x, y;
};
struct alignas(16) uint4 {
    unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
const int cudaSuccess = 0, cudaErrorInvalidConfiguration = 9;
typedef struct CUstream_st* cudaStream_t;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaFuncAttributePreferredSharedMemoryCarveout = 9 };
enum { cudaSharedmemCarveoutMaxShared = 100 };
const size_t emu_max_smem = 232448;  // a Hopper block's dynamic shared memory limit
const size_t emu_sm_smem = 233472;   // an SM's shared memory, 1 KB of it reserved a block
inline int emu_error = 0;
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int attr, int value) {
    return attr == cudaFuncAttributeMaxDynamicSharedMemorySize && value > (int)emu_max_smem ? 1 : 0;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int threads, size_t smem) {
    *n = (int)std::min<size_t>(2048 / threads, emu_sm_smem / (smem + 1024));
    return 0;
}
inline cudaError_t cudaGetLastError() { int e = emu_error; emu_error = 0; return e; }

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::vector<float> emu_smem;
inline std::barrier<>* emu_block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
inline std::vector<float> emu_lanes_f;
inline std::vector<int> emu_lanes_i;

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

// __syncthreads_or: call k ORs into accumulator k % 3 and reads it after the
// barrier; thread 0 clears accumulator (k + 2) % 3, whose readers (call k - 1)
// are past this barrier and whose writers (call k + 2) are behind the next
inline std::atomic<int> emu_or[3];
inline thread_local unsigned emu_or_calls = 0;
inline int __syncthreads_or(int p) {
    const unsigned k = emu_or_calls++;
    if (p) emu_or[k % 3] |= 1;
    emu_block_barrier->arrive_and_wait();
    const int r = emu_or[k % 3].load();
    if (threadIdx.x == 0) emu_or[(k + 2) % 3] = 0;
    return r;
}

inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline unsigned __float_as_uint(float f) { unsigned i; std::memcpy(&i, &f, 4); return i; }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
    return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}

// IEEE float32 operations that the card's compiler never contracts; g++ runs
// with -ffp-contract=off, so neither does the host; the fused multiply-add
// rounds once, as the card's does
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
// a load or store of a T on an address that is not a multiple of its size fails the launch, as on the
// card (cudaErrorMisalignedAddress)
inline bool emu_aligned(const void* p, size_t n) {
    if (reinterpret_cast<uintptr_t>(p) % n == 0) return true;
    emu_error = 716;
    return false;
}
template <class T>
inline T __ldg(const T* p) {
    T v{};
    if (emu_aligned(p, alignof(T))) std::memcpy(&v, p, sizeof(T));
    return v;
}
template <class T>
inline void __stwb(T* p, T v) {
    if (emu_aligned(p, alignof(T))) std::memcpy(p, &v, sizeof(T));
}

// prmt's default mode: byte n of the result is byte (s >> 4n) & 7 of (y << 32 | x)
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
    const uint64_t b = (uint64_t)y << 32 | x;
    unsigned r = 0;
    for (int n = 0; n < 4; ++n) r |= (unsigned)(b >> 8 * ((s >> 4 * n) & 7) & 255) << 8 * n;
    return r;
}
// Hopper's DPX add-min-relu on each s16 half: max(min(a + b, c), 0)
inline unsigned __viaddmin_s16x2_relu(unsigned a, unsigned b, unsigned c) {
    unsigned r = 0;
    for (int i = 0; i < 2; ++i) {
        const int x = (int16_t)(a >> 16 * i) + (int16_t)(b >> 16 * i), m = (int16_t)(c >> 16 * i);
        r |= (unsigned)(uint16_t)std::max(std::min(x, m), 0) << 16 * i;
    }
    return r;
}
// dp2a: the u16 halves of a by two bytes of b (its low two: lo, its high two: hi), plus c
inline unsigned emu_dp2a(unsigned a, unsigned b, unsigned c) {
    return c + (a & 0xffff) * (b & 0xff) + (a >> 16) * ((b >> 8) & 0xff);
}
inline unsigned __dp2a_lo(unsigned a, unsigned b, unsigned c) { return emu_dp2a(a, b, c); }
inline unsigned __dp2a_hi(unsigned a, unsigned b, unsigned c) { return emu_dp2a(a, b >> 16, c); }

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

// cp.async as __pipeline_memcpy_async / commit / wait_prior: each thread's
// copies are held in their commit groups and made only when a wait releases
// the group, so a staged read before its wait sees stale data (or the NaN
// that shared memory starts as); a copy must be 4, 8 or 16 bytes, aligned to
// its size, into shared memory
struct EmuCopy {
    void* dst;
    const void* src;
    size_t n;
};
inline thread_local std::vector<EmuCopy> emu_open_group;
inline thread_local std::deque<std::vector<EmuCopy>> emu_groups;
inline void emu_pipeline_reset() {
    emu_open_group.clear();
    emu_groups.clear();
}
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n, size_t = 0) {
    const auto d = reinterpret_cast<uintptr_t>(dst), s = reinterpret_cast<uintptr_t>(src);
    const auto lo = reinterpret_cast<uintptr_t>(emu_smem.data());
    if ((n != 4 && n != 8 && n != 16) || d % n || s % n || d < lo || d + n > lo + emu_smem.size() * sizeof(float)) {
        emu_error = 10;
        return;
    }
    emu_open_group.push_back({dst, src, n});
}
inline void __pipeline_commit() {
    emu_groups.push_back(std::move(emu_open_group));
    emu_open_group.clear();
}
inline void __pipeline_wait_prior(size_t prior) {
    while (emu_groups.size() > prior) {
        for (const EmuCopy& c : emu_groups.front()) std::memcpy(c.dst, c.src, c.n);
        emu_groups.pop_front();
    }
}

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
    for (auto& a : emu_or) a = 0;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) {
        pool.emplace_back([&, t] {
            threadIdx = dim3(t);
            emu_or_calls = 0;
            for (unsigned by = 0; by < grid.y; ++by)
                for (unsigned bx = 0; bx < grid.x; ++bx) {
                    blockIdx = dim3(bx, by);
                    emu_pipeline_reset();
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
    (out / "cuda_pipeline.h").write_text('#pragma once\n#include "cuda_runtime.h"\n')
    def shared(text):
        return re.sub(r"extern __shared__ (?:__align__\(\d+\) )?float smem\[\];", "float* smem = emu_smem.data();", text)

    for header in CSRC.glob("*.cuh"):
        (out / header.name).write_text(shared(header.read_text()))
    sources = []
    for src in sorted(CSRC.glob("*.cu")):
        if "__global__" not in src.read_text():
            continue  # host code with no kernel (csrc/nvdec.cu drives NVDEC through libnvcuvid)
        text = shared(src.read_text())
        # kernel<T><<<grid, block, smem, stream>>>(args); -> emu_launch(grid, block, smem, stream, [&] { kernel<T>(args); });
        text, n = re.subn(
            r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);", r"emu_launch(\2, [&]() { \1(\3); });", text, flags=re.S
        )
        assert n == 1, f"{src.name}: expected one kernel launch, found {n}"
        sources.append(out / (src.stem + ".cpp"))
        sources[-1].write_text(text)
    lib = out / "libpiv_emulated.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-pthread", "-w", "-I", str(out),
         "-o", str(lib),
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


# (size, frames): 4 and 5 pairs at every class of side; 18 and 19 pairs at 16, 26 and 64 px
RUN_CASES = [(size, n) for size in (16, 26, 64, 24, 75, (26, 64), (66, 16)) for n in (5, 6)]
RUN_CASES += [(size, n) for size in (16, 26, 64) for n in (19, 20)]


@pytest.mark.parametrize("size,n_frames", RUN_CASES, ids=[f"{_plan_id(s)}-{n - 1}-pairs" for s, n in RUN_CASES])
def test_pairs_kernel_code_runs_of_pairs(kernels, size, n_frames):
    """Consecutive pairs in runs (a block walks a run of 15 pairs of its
    window, each frame transformed once, two planes per inverse): 4 and 5
    pairs are the first run cut short by the stack's end, with an even and
    an odd tail; 18 and 19 pairs cross into a second run at pair 15 (its
    first step, its cached spectrum, its frames), held to the plain version
    there; a zero-variance row of windows."""
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


# ---------------------------------------------------------------- multipass deformation


@pytest.mark.parametrize("case", list(DEFORM_CASES))
def test_deform_kernel_code_bitwise_plain(kernels, case, monkeypatch):
    """The deformation kernel's pairs equal the plain version's bit for bit, on the cases held to
    JAX in tests/test_torch_deform.py (the plain version in blocks where the case says so); the
    (tile, pair)s whose predictor could reach past the staged halo are counted: none on a small
    spread, all past every edge, some where a few cells are past it (one launch on both paths)."""
    from pyorc_tpu_torch.ops import multipass

    frames, u, v, rows, cols, block_px = deform_inputs(case)
    if block_px:
        monkeypatch.setattr(multipass, "_DEFORM_BLOCK_PX", block_px)
    f, ut, vt = (torch.as_tensor(x) for x in (frames, u, v))
    coords = multipass._dense_coords(rows, cols, *frames.shape[1:], f.device)
    before, misses = kernels.LAUNCHES["deform_pairs"], multipass.deform_halo_misses("cpu")
    got = multipass._launch_deform(f, ut, vt, *coords)
    assert kernels.LAUNCHES["deform_pairs"] == before + 1
    check_halo_misses(case, multipass.deform_halo_misses("cpu") - misses, multipass.deform_geometry())
    want = multipass._deformed_pairs(f, ut, vt, rows, cols, coords)
    assert got.shape == want.shape and np.array_equal(_bits(got), _bits(want))


def test_deform_kernel_code_geometry(kernels):
    """The kernel reports its tile, halo, run and shared memory; three blocks fit an SM's shared memory."""
    from pyorc_tpu_torch.ops import multipass

    geometry = multipass.deform_geometry()
    assert geometry == {"tile_rows": 32, "tile_cols": 128, "halo": 4, "run": 12, "threads": 256,
                        "smem_bytes": geometry["smem_bytes"], "blocks_per_sm": 3}
    assert 3 * (geometry["smem_bytes"] + 1024) <= 233472


def test_multipass_through_the_deform_kernel_code_is_bitwise_plain(kernels, monkeypatch):
    """piv_multipass (passes=3) with every deformation launched on the kernel's code gives the plain
    cascade's u, v, cmax and s2n bit for bit, one launch a deformed pass."""
    from pyorc_tpu_torch.ops import multipass

    frames = torch.as_tensor(_frames(np.random.default_rng(3), 4, 96, 128))
    args = ((96, 128), (16, 16), (8, 8), *win.get_field_shape((96, 128), (16, 16), (8, 8)))
    want = multipass.piv_multipass(frames, *args, passes=3)

    def launched(frames, u, v, rows_prev, cols_prev):
        multipass._check_deform(frames, u, v, rows_prev, cols_prev)
        coords = multipass._dense_coords(rows_prev, cols_prev, *frames.shape[1:], frames.device)
        return multipass._launch_deform(frames, u, v, *coords)

    monkeypatch.setattr(multipass, "deformed_pairs", launched)
    before = kernels.LAUNCHES["deform_pairs"]
    got = multipass.piv_multipass(frames, *args, passes=3)
    assert kernels.LAUNCHES["deform_pairs"] == before + 2
    assert torch.isfinite(want[0]).all()
    for a, b in zip(got, want):
        assert np.array_equal(_bits(a), _bits(b))


# ---------------------------------------------------------------- split launches
# A pair's outputs are a function of the stack and its absolute index alone:
# any split of a stack into launches, each a Span with its absolute first frame
# and halo, gives the whole stack's per-pair outputs bit for bit.


def _bits(t):
    return t.numpy().view(np.int32)


def _split_stack(size, n_frames, dtype, seed):
    rng = np.random.default_rng(seed)
    stack = _frames(rng, n_frames, size, size + size // 2, dtype=dtype)
    stack[n_frames // 3, :, :size] = 0  # a zero-variance window in one frame
    frames = torch.as_tensor(stack)
    return frames, _grid(size, size + size // 2, size, size // 2)


def _pieces(n_pairs, cuts):
    """(first, end) pair bounds of the pieces that ``cuts`` make of ``n_pairs`` pairs."""
    bounds = [0, *cuts, n_pairs]
    return list(zip(bounds[:-1], bounds[1:]))


def _launch_span(kernels, span, args, threshold=None):
    sas, steps = args[1], (args[1][0] - args[2][0], args[1][1] - args[2][1])
    return kernels._launch(span.frames, sas, steps, *args[3:], threshold, 1, span.frame0, span.halo, span.total)


# 19 and 20 frames: 18 and 19 pairs, past the first run of 15 (an even and an odd
# tail); cuts at every pair, so inside runs, on the run boundary (15) and next to it
SPLIT_CASES = [(16, 19, np.uint8), (16, 20, np.float32), (26, 20, np.uint8), (26, 19, np.float32)]


@pytest.mark.parametrize("size,n_frames,dtype", SPLIT_CASES, ids=lambda v: getattr(v, "__name__", str(v)))
def test_pairs_kernel_split_launches_are_bitwise_whole(kernels, size, n_frames, dtype):
    frames, args = _split_stack(size, n_frames, dtype, size + n_frames)
    whole_span = kernels.Span(frames)
    whole = _launch_span(kernels, whole_span, args)
    n_pairs = n_frames - 1
    assert torch.isnan(whole[0]).any()
    for cut in range(1, n_pairs):
        parts = [_launch_span(kernels, whole_span.cut(a, b), args) for a, b in _pieces(n_pairs, [cut])]
        for k in range(4):
            joined = torch.cat([p[k] for p in parts])
            assert np.array_equal(_bits(joined), _bits(whole[k])), (cut, k)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_pairs_kernel_split_launches_64px(kernels, dtype):
    """64 px, a split in three and nested cuts (a piece of a piece, as an
    out-of-memory half of an engine chunk cuts it)."""
    frames, args = _split_stack(64, 19, dtype, 64)
    whole_span = kernels.Span(frames)
    whole = _launch_span(kernels, whole_span, args)
    for cuts in ([1, 16], [7, 15], [14, 17]):
        parts = [_launch_span(kernels, whole_span.cut(a, b), args) for a, b in _pieces(18, cuts)]
        for k in range(4):
            assert np.array_equal(_bits(torch.cat([p[k] for p in parts])), _bits(whole[k])), (cuts, k)
    chunk = whole_span.cut(3, 17)
    halves = [_launch_span(kernels, chunk.cut(a, b), args) for a, b in ((0, 7), (7, 14))]
    for k in range(4):
        assert np.array_equal(_bits(torch.cat([p[k] for p in halves])), _bits(whole[k][3:17])), k


@pytest.mark.parametrize("size,n_frames,dtype", [(16, 9, np.uint8), (26, 10, np.float32), (64, 9, np.float32)],
                         ids=["16-8pairs-u8", "26-9pairs-f32", "64-8pairs-f32"])
def test_ensemble_kernel_split_launches(kernels, size, n_frames, dtype):
    """Per-pair cmax, s2n and gates bitwise, counts equal, corr_sum a sum of
    partial sums within 1e-6 relative, at every cut."""
    frames, args = _split_stack(size, n_frames, dtype, 7 * size + n_frames)
    sas, steps = args[1], (size // 2, size // 2)
    whole_span = kernels.Span(frames)

    def run(span):
        return kernels._launch_ensemble(span.frames, sas, steps, *args[3:], 0.1, 1.5, None, **span.place())

    whole = run(whole_span)
    assert (whole[1] > 0).all() and (whole[1] < n_frames - 1).any()
    for cut in range(1, n_frames - 1):
        parts = [run(whole_span.cut(a, b)) for a, b in _pieces(n_frames - 1, [cut])]
        for k in (2, 3):
            assert np.array_equal(_bits(torch.cat([p[k] for p in parts])), _bits(whole[k])), (cut, k)
        assert torch.equal(sum(p[1] for p in parts), whole[1]), cut
        corr_sum = sum(p[0] for p in parts)
        assert ((corr_sum - whole[0]).abs() <= 1e-6 * whole[0].abs().amax()).all(), cut


@pytest.mark.parametrize("size", [32, 104])
def test_stride2_launches_unchanged(kernels, size):
    """Explicit pairs (pair_stride=2, multipass) run one pair a block: split
    launches equal the whole launch, and both hold to the plain version."""
    rng = np.random.default_rng(size)
    h, w = size + size // 2 + 3, 2 * size + 1
    frames = torch.as_tensor(_frames(rng, 6, h, w, dtype=np.float32))
    args = _grid(h, w, size, size // 2)
    steps = (size // 2, size // 2)
    whole = kernels._launch(frames, args[1], steps, *args[3:], None, 2)
    parts = [kernels._launch(frames[a:b], args[1], steps, *args[3:], None, 2) for a, b in ((0, 2), (2, 6))]
    for k in range(4):
        assert np.array_equal(_bits(torch.cat([p[k] for p in parts])), _bits(whole[k])), k
    out_p = kernels.piv_pairs_fused_plain(frames, *args, pair_stride=2)
    _compare(whole, out_p, _gap(frames, *args[:3], 2, out_p[0].shape))


@pytest.mark.parametrize("route", ["pairs_kernel", "ensemble_kernel", "pairs_plain", "ensemble_plain"])
def test_launch_halo_checked_on_both_sides(kernels, route):
    """A launch placed in a stack must hold the halo the stack has on both
    sides: the cuts of :meth:`Span.cut` run, a piece without its right halo
    or without the stack's frame count raises, and the stack's last piece
    needs no right halo."""
    frames, args = _split_stack(16, 12, np.uint8, 5)
    sas, steps = args[1], (8, 8)
    run = {
        "pairs_kernel": lambda f, **kw: kernels._launch(f, sas, steps, *args[3:], None, 1, **kw),
        "ensemble_kernel": lambda f, **kw: kernels._launch_ensemble(f, sas, steps, *args[3:], 0.1, 1.5, None, **kw),
        "pairs_plain": lambda f, **kw: kernels.piv_pairs_fused_plain(f, *args, **kw),
        "ensemble_plain": lambda f, **kw: kernels.piv_ensemble_fused_plain(f, *args, 0.1, 1.5, **kw),
    }[route]
    whole = kernels.Span(frames)
    middle, last = whole.cut(3, 7), whole.cut(7, 11)
    assert (middle.halo, middle.total, last.halo, last.total) == ((2, 1), 12, (2, 0), 12)
    assert middle.cut(1, 3).place() == {"frame0": 2, "halo": (2, 1), "n_total": 12}
    run(middle.frames, **middle.place())
    run(last.frames, **last.place())
    with pytest.raises(ValueError, match="halo after"):  # the middle piece's frames without its right halo
        run(middle.frames[:-1], frame0=middle.frame0, halo=(2, 0), n_total=12)
    with pytest.raises(ValueError, match="halo before"):
        run(middle.frames[1:], frame0=middle.frame0 + 1, halo=(1, 1), n_total=12)
    with pytest.raises(ValueError, match="needs n_total"):
        run(middle.frames, frame0=middle.frame0, halo=middle.halo)
    with pytest.raises(ValueError, match="outside a stack"):
        run(last.frames, frame0=last.frame0, halo=last.halo, n_total=11)


def test_automatic_chunks_leave_room_for_the_halo(monkeypatch):
    """The automatic chunk size counts a chunk's halo where the memory model
    splits the stack; a stack that fits is one chunk; a given size is kept."""
    from pyorc_tpu_torch.velocimetry import engine

    monkeypatch.setattr(win, "required_memory", lambda *a: 4000)
    monkeypatch.setattr(win, "available_memory", lambda: 1000)  # 4000 / (1000 / 2) + 1 = 9 chunks
    plan = functools.partial(engine._chunk_plan, 90, (64, 64), (16, 16), (8, 8), (16, 16))
    assert plan(None, 2) == 90 // 9 - sum(piv_kernels.HALO)
    assert plan(17, 2) == 17
    monkeypatch.setattr(win, "available_memory", lambda: 10**6)
    assert plan(None, 2) == 90


@pytest.fixture
def emulated_routes(kernels, monkeypatch):
    """The wrappers' CPU route swapped for the emulated kernels, so that the
    engine's chunks and the sharded functions' shards launch kernel code."""

    def pairs(imgs, dim_size, sas, overlap, n_rows, n_cols, signal_threshold=None, pair_stride=1, frame0=0,
              halo=(0, 0), n_total=None):
        sas, overlap = win._as2(sas), win._as2(overlap)
        steps = kernels._grid_steps(dim_size, sas, overlap, n_rows, n_cols)
        return kernels._launch(imgs, sas, steps, n_rows, n_cols, signal_threshold, pair_stride, frame0, halo, n_total)

    def ensemble(imgs, dim_size, sas, overlap, n_rows, n_cols, corr_min=0.2, s2n_min=3.0, signal_threshold=None,
                 frame0=0, halo=(0, 0), n_total=None):
        sas, overlap = win._as2(sas), win._as2(overlap)
        steps = kernels._grid_steps(dim_size, sas, overlap, n_rows, n_cols)
        return kernels._launch_ensemble(
            imgs, sas, steps, n_rows, n_cols, corr_min, s2n_min, signal_threshold, frame0, halo, n_total
        )

    monkeypatch.setattr(kernels, "piv_pairs_fused", pairs)
    monkeypatch.setattr(kernels, "piv_ensemble_fused", ensemble)
    return kernels


def test_engine_chunks_and_shards_launch_bitwise_whole(emulated_routes):
    """The engine's chunks (automatic sizes 3, 5, 17 frames), a chunk's
    out-of-memory halves and the sharded functions' pair shards give the
    whole stack's per-pair bits; the ensemble's per-pair cmax and s2n too."""
    from pyorc_tpu_torch import parallel
    from pyorc_tpu_torch.velocimetry import engine

    kernels = emulated_routes
    rng = np.random.default_rng(11)
    frames = torch.as_tensor(_frames(rng, 20, 32, 24))
    frames[6, :16, :16] = 0  # a zero-variance window in one frame
    args = _grid(32, 24, 16, 8)
    dims, sas, overlap = args[:3]
    whole = [x.numpy() for x in kernels.piv_pairs_routed(frames, *args)]

    def same(out, want):
        for k in range(len(want)):
            assert np.array_equal(np.asarray(out[k]).view(np.int32), want[k].view(np.int32)), k

    def run(span):
        return tuple(x.numpy() for x in kernels.piv_pairs_routed(span.frames, *args, **span.place()))

    for chunksize in (3, 5, 17):
        joined = [run(span) for span in engine._iter_chunks(frames, chunksize)]
        same([np.concatenate(column) for column in zip(*joined)], whole)
    failed = []

    def half_only(span):
        if span.n_pairs > 6:
            failed.append(span.n_pairs)
            raise torch.cuda.OutOfMemoryError("too large")
        return run(span)

    with pytest.warns(UserWarning, match="two halves"):
        same(engine._run_chunk_oom_backoff(half_only, kernels.Span(frames)), whole)
    assert failed == [19, 9, 10]
    cpu = torch.device("cpu")
    mesh = parallel.piv.Mesh([cpu] * 3, ("pairs",))
    same(parallel.piv_pairs_sharded(frames, sas, overlap, mesh=mesh), whole)
    mesh2d = parallel.piv.Mesh(np.asarray([cpu] * 4, dtype=object).reshape(2, 2), ("pairs", "rows"))
    same(parallel.piv_pairs_sharded_2d(frames, sas, overlap, mesh=mesh2d), whole)
    chunk = kernels.Span(frames).cut(4, 13)  # an engine chunk, sharded
    sharded = parallel.piv_pairs_sharded(chunk.frames, sas, overlap, mesh=mesh, **chunk.place())
    same(sharded, [w[4:13] for w in whole])
    ens_whole = [x.numpy() for x in kernels.piv_ensemble_routed(frames, *args, 0.1, 1.5)]
    ens = parallel.piv_ensemble_sharded(frames, sas, overlap, mesh=mesh, corr_min=0.1, s2n_min=1.5)
    same(ens[2:], ens_whole[2:])
    assert np.array_equal(ens[1], ens_whole[1])
    np.testing.assert_allclose(ens[0], ens_whole[0], rtol=0, atol=1e-6 * np.abs(ens_whole[0]).max())
