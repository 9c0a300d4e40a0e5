// Per-pair PIV correlation for Hopper (sm_90a): frames -> (u, v, corr_max, s2n).
//
// Replaces the three Pallas TPU kernels of the per-pair contract
// `piv_pairs_fused` (pyorc_tpu/ops/piv_pallas.py:1482):
//   B1 `_tb_ens_kernel(mode="pairs")` (piv_pallas.py:957), launched by
//      `_piv_pairs_sf_jit` (:1400): shared-forward tileband, 8-32 px windows;
//   B2 `_kernel` (:314), launched by `_piv_pairs_fused_jit` (:1786): band
//      kernel, every other window of 8-128 px on a uniform grid, square or
//      not (multipass PIV's coarse passes: 128 and 64 px for window_size 32);
//   B3 `_tb_kernel` (:561), launched by `_piv_pairs_tb_jit` (:889): tileband
//      without frame sharing, two-frame chunks and pair_stride=2 stacks.
// They compute one function, so this is one entry point. It computes what
// `_finish_corr` (:218-283) and the NaN stores (:445-446, :844-845) compute,
// for wy x wx windows with sides of 8-128 px on any uniform step.
//
// Design: one layout for every side (piv_common.cuh). Two real windows go
// into one complex plane z = a + i b in shared memory; one forward 2-D
// transform, the Hermitian separation of the two spectra and their product,
// one inverse transform, then the normalization, the first maximum and the
// sub-pixel fit. Along an axis whose length has an odd part of at most 15 the
// transform is the in-block FFT (register butterflies, one shared-memory
// exchange per pass), else the table DFT along that axis.
//   - pair_stride 1 (consecutive frames): a block walks a run of up to 15
//     consecutive pairs of its window as the ensemble kernel walks a stack:
//     frames f and f + 1 in one forward transform, the last frame's half
//     spectrum cached, the planes of pairs (f - 1, f) and (f, f + 1) in the
//     real and imaginary parts of one inverse. Each frame is transformed once
//     (what B1 does on the TPU); 8 transforms for 15 pairs instead of 30. The
//     grid is windows x runs, the run shortened while that leaves fewer than
//     two waves of blocks.
//   - pair_stride 2 (multipass PIV's deformed pairs share no frame): one pair
//     per block, its plane in the imaginary part of the inverse.
// Shared memory is the plane (8 wy wx bytes), 2 n twiddles per axis and, for
// runs, the cached half spectrum: 131 KB (196 KB with the cache) at 128 x 128,
// 33 KB (50 KB) at 64 x 64. What bounds it is shared-memory traffic (every
// FFT pass reads and writes the plane once) and, at 16-32 px, the block's
// chain of barriers, reductions and the serial peak fit; each frame byte is
// read from device memory about four times (the overlapping windows; eight at
// pair_stride 2), far below its rate.
//
// ops/piv_kernels.py::build_library compiles every csrc/*.cu with nvcc
// -gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC and links them
// into one shared library. Entry point `piv_pairs_launch` has a plain C
// interface (loaded with ctypes); it launches on the given stream, allocates
// nothing and returns cudaGetLastError().

#include "piv_common.cuh"

namespace {

using namespace piv;

// Gaussian 3-point sub-pixel offset, as ops/piv.py::subpixel_peak.
__device__ __forceinline__ float gauss3(float lo, float c0, float hi) {
    const float eps = 1e-10f;
    const float ll = logf(fmaxf(lo, eps)), l0 = logf(fmaxf(c0, eps)), lh = logf(fmaxf(hi, eps));
    float den = 2.f * ll - 4.f * l0 + 2.f * lh;
    if (fabsf(den) < eps) den = -eps;
    return fminf(fmaxf((ll - lh) / den, -1.f), 1.f);
}

// First row-major position of the maximum `cmax` of the fftshifted wy x wx
// plane, where `at(ys, xs)` reads it; every thread gets it.
template <typename At>
__device__ __forceinline__ int first_peak(int wy, int wx, float cmax, At at, float* red) {
    int first = wy * wx;
    for (PixelWalk p(wx, blockDim.x); p.y < wy; p.next()) {
        if (at(p.y, p.x) >= cmax) {
            first = p.y * wx + p.x;
            break;
        }
    }
    return block_min_int(first, reinterpret_cast<int*>(red));
}

// Thread 0 fits the sub-pixel peak around `first`, with the stencil clamped
// to rows [1, wy - 2] and columns [1, wx - 2], and writes the pair's outputs:
// u = ix + dx - wx/2, v = -(iy + dy - wy/2).
template <typename At>
__device__ __forceinline__ void store_pair(int wy, int wx, int first, float cmax, float s2n,
                                           bool valid, bool low_signal, At at, size_t o,
                                           float* u_out, float* v_out, float* cmax_out,
                                           float* s2n_out) {
    if (threadIdx.x != 0) return;
    const int iy = min(max(first / wx, 1), wy - 2);
    const int ix = min(max(first - (first / wx) * wx, 1), wx - 2);
    const float c0 = at(iy, ix);
    const float dx = gauss3(at(iy, ix - 1), c0, at(iy, ix + 1));
    const float dy = gauss3(at(iy - 1, ix), c0, at(iy + 1, ix));
    float u = valid ? (static_cast<float>(ix) + dx) - static_cast<float>(wx / 2) : NAN;
    float v = valid ? -((static_cast<float>(iy) + dy) - static_cast<float>(wy / 2)) : NAN;
    float cm = cmax, sn = s2n;
    if (low_signal) u = v = cm = sn = NAN;
    u_out[o] = u;
    v_out[o] = v;
    cmax_out[o] = cm;
    s2n_out[o] = sn;
}

// Window (r, c) of frame f starts at frames[f][r * step_y][c * step_x]; pair p
// correlates frames p * pair_stride and p * pair_stride + 1. Block (win, j)
// takes pairs j run .. min((j + 1) run, n_pairs) - 1 of window win. run == 1:
// one pair, z = a + i b, its plane in the imaginary part of the inverse. run >
// 1 (pair_stride 1 only): the ensemble kernel's walk over frames j run .. , two
// frames a step, the last spectrum cached in S.extra, two pairs' planes per
// inverse. WY > 0: L is the constant layout of WY x WX windows.
template <typename T, int WY, int WX>
__device__ __forceinline__ void pairs_block(
    const T* __restrict__ frames, int H, int W, const Layout& L, int step_y, int step_x, int n_cols,
    int n_pairs, int pair_stride, int run, int has_thr, float thr, const float* __restrict__ cos_y,
    const float* __restrict__ sin_y, const float* __restrict__ cos_x,
    const float* __restrict__ sin_x, float* __restrict__ u_out, float* __restrict__ v_out,
    float* __restrict__ cmax_out, float* __restrict__ s2n_out) {
    extern __shared__ float smem[];
    const Smem S(smem, L);
    const int wy = L.wy, wx = L.wx, ld = L.ld;

    const int win = blockIdx.x, n_win = gridDim.x;
    const int r = win / n_cols, c = win - r * n_cols;
    const size_t frame_px = static_cast<size_t>(H) * W;
    const T* src = frames + static_cast<size_t>(r) * step_y * W + static_cast<size_t>(c) * step_x;

    load_twiddles(cos_y, sin_y, cos_x, sin_x, smem, S, L);  // ordered by load_windows' first reduction

    // finishes the raw plane of pair `pair` (windows a, b), fits its peak and stores the pair
    const auto finish_store = [&](float* plane, int pair, const WinStat& a, const WinStat& b) {
        const bool valid = a.sd > 1e-6f && b.sd > 1e-6f;
        float cmax, s2n;
        finish_plane(plane, L, S.red, a, b, valid, cmax, s2n);
        const auto at = [&](int ys, int xs) { return plane[unshift(ys, wy) * ld + unshift(xs, wx)]; };
        const int first = first_peak(wy, wx, cmax, at, S.red);
        store_pair(wy, wx, first, cmax, s2n, valid, has_thr && fminf(a.signal, b.signal) < thr, at,
                   static_cast<size_t>(pair) * n_win + win, u_out, v_out, cmax_out, s2n_out);
    };

    // frames f and f + 1 a step; the run's last frame is p1 (run == 1: one step, frames p0 stride and the next)
    const int p0 = blockIdx.y * run, p1 = min(p0 + run, n_pairs);
    float* Pr = run > 1 ? S.extra : nullptr;
    float* Pi = run > 1 ? Pr + wy * (wx / 2 + 1) : nullptr;
    WinStat prev{0.f, 0.f};
    for (int f = p0; f <= p1; f += 2) {
        const T* fa = src + static_cast<size_t>(f) * pair_stride * frame_px;
        const bool has_b = f + 1 <= p1, use_prev = f > p0;
        WinStat a, b;
        load_windows(fa, has_b ? fa + frame_px : nullptr, W, S, L, a, b);
        transform_2d<WY, WX>(false);
        cross_spectra(S, L, Pr, Pi, use_prev, has_b);
        transform_2d<WY, WX>(true);  // the inverse: the planes unshifted in Zr and Zi
        if (use_prev) finish_store(S.Zr, f - 1, prev, a);
        if (has_b) finish_store(S.Zi, f, a, b);
        prev = b;
        __syncthreads();  // the peaks are read before the next step overwrites the planes
    }
}

// WY x WX windows, the layout a constant of the kernel (the sizes of the main
// paths); WY = 0: any size, the layout `Lp` as the launch made it.
template <typename T, int WY, int WX>
__global__ void __launch_bounds__(
    WY ? make_layout(WY ? WY : 8, WX ? WX : 8, 0).nt : kMaxThreads,
    WY ? blocks_per_sm(make_layout(WY ? WY : 8, WX ? WX : 8, half_spectrum(WY, WX))) : 1)
    piv_pairs_kernel(const T* __restrict__ frames, int H, int W, Layout Lp, int step_y, int step_x,
                     int n_cols, int n_pairs, int pair_stride, int run, int has_thr, float thr,
                     const float* __restrict__ cos_y, const float* __restrict__ sin_y,
                     const float* __restrict__ cos_x, const float* __restrict__ sin_x,
                     float* __restrict__ u_out, float* __restrict__ v_out,
                     float* __restrict__ cmax_out, float* __restrict__ s2n_out) {
    if constexpr (WY != 0) {
        constexpr Layout L = make_layout(WY, WX, 0);
        pairs_block<T, WY, WX>(frames, H, W, L, step_y, step_x, n_cols, n_pairs, pair_stride, run, has_thr,
                             thr, cos_y, sin_y, cos_x, sin_x, u_out, v_out, cmax_out, s2n_out);
    } else {
        pairs_block<T, 0, 0>(frames, H, W, Lp, step_y, step_x, n_cols, n_pairs, pair_stride, run, has_thr,
                              thr, cos_y, sin_y, cos_x, sin_x, u_out, v_out, cmax_out, s2n_out);
    }
}

constexpr int kMaxRun = 15;  // pairs a block walks at most (pair_stride 1)

template <typename T>
cudaError_t launch(const void* frames, int H, int W, int wy, int wx, int step_y, int step_x,
                   int n_rows, int n_cols, int n_pairs, int pair_stride, int has_thr, float thr,
                   const float* cos_y, const float* sin_y, const float* cos_x, const float* sin_x,
                   float* u, float* v, float* cmax, float* s2n, cudaStream_t stream) {
    // Consecutive pairs share frames: a block that walks a run of them transforms
    // each frame once. The longest odd run (an even number of frames: whole
    // steps) up to kMaxRun that leaves the grid two waves of blocks, if the
    // cached spectrum fits.
    Layout L = make_layout(wy, wx, half_spectrum(wy, wx));
    int run = 1;
    if (pair_stride == 1 && L.bytes() <= kMaxSmem) {
        const int wave = kSMs * blocks_per_sm(L);
        for (int r = 3; r <= kMaxRun && r <= n_pairs; r += 2) {
            if (n_rows * n_cols * ((n_pairs + r - 1) / r) >= 2 * wave) run = r;
        }
    }
    if (run == 1) L.extra = 0;
    const size_t smem = L.bytes();
    auto kernel = piv_pairs_kernel<T, 0, 0>;
    PIV_FIXED_SIZES(PIV_PICK_KERNEL, piv_pairs_kernel)
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    dim3 grid(n_rows * n_cols, (n_pairs + run - 1) / run);
    kernel<<<grid, L.nt, smem, stream>>>(
        static_cast<const T*>(frames), H, W, L, step_y, step_x, n_cols, n_pairs, pair_stride, run,
        has_thr, thr, cos_y, sin_y, cos_x, sin_x, u, v, cmax, s2n);
    return cudaGetLastError();
}

}  // namespace

extern "C" int piv_pairs_launch(const void* frames, int is_u8, int H, int W, int wy, int wx,
                                int step_y, int step_x, int n_rows, int n_cols, int n_pairs,
                                int pair_stride, int has_thr, float thr, const void* cos_y,
                                const void* sin_y, const void* cos_x, const void* sin_x, void* u,
                                void* v, void* cmax, void* s2n, void* stream) {
    const float* tabs[4] = {static_cast<const float*>(cos_y), static_cast<const float*>(sin_y),
                            static_cast<const float*>(cos_x), static_cast<const float*>(sin_x)};
    float* out[4] = {static_cast<float*>(u), static_cast<float*>(v), static_cast<float*>(cmax),
                     static_cast<float*>(s2n)};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err =
        is_u8 ? launch<uint8_t>(frames, H, W, wy, wx, step_y, step_x, n_rows, n_cols, n_pairs,
                                pair_stride, has_thr, thr, tabs[0], tabs[1], tabs[2], tabs[3],
                                out[0], out[1], out[2], out[3], s)
              : launch<float>(frames, H, W, wy, wx, step_y, step_x, n_rows, n_cols, n_pairs,
                              pair_stride, has_thr, thr, tabs[0], tabs[1], tabs[2], tabs[3],
                              out[0], out[1], out[2], out[3], s);
    return static_cast<int>(err);
}
