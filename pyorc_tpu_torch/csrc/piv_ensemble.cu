// Ensemble PIV correlation for Hopper (sm_90a):
// frames -> (corr_sum, corr_count, corr_max, s2n).
//
// Replaces the two Pallas TPU kernels of the ensemble contract
// `piv_ensemble_fused` (pyorc_tpu/ops/piv_pallas.py:2042):
//   B4 `_tb_ens_kernel(mode="ens")` (piv_pallas.py:957, ens branch
//      :1190-1211), launched by `_piv_ensemble_tb_jit` (:1297, pallas_call
//      :1350): tileband ensemble, square 8-64 px windows at 50 % overlap,
//      column-split for 4K grids;
//   B5 `_ens_kernel` (:1901), launched by `_piv_ensemble_fused_jit` (:2166,
//      pallas_call :2230): sliced accumulator for the other uniform grids,
//      square windows of 8-128 px and non-square ones.
// Both compute `piv_ensemble_scan` (pyorc_tpu/ops/piv.py:442-498), so this is
// one entry point: per window pair the normalized, clipped, fftshifted plane
// of `_finish_corr`; ok = valid && cmax >= corr_min && s2n >= s2n_min (and
// the pair's non-zero fraction >= signal_threshold when one is given);
// corr_sum += ok * plane, count += ok; per pair ok * cmax and ok * s2n, with
// s2n = cmax / max(mean, 1e-10). It takes wy x wx windows with sides of
// 8-128 px on any uniform step.
//
// Design: one thread block per window, looping over the launch's frames in
// order, one layout for every side (piv_common.cuh). The work is that of the
// FFT the bound counts, one forward and one inverse complex 2-D transform per
// two pairs:
//   - two real windows per forward transform: frames f and f + 1 go in as
//     z = a + i b and their spectra A, B are separated by Hermitian symmetry;
//     B (a half spectrum, wy (wx / 2 + 1) complex values in shared memory) is
//     cached as P for the pair that straddles two steps, so each frame is
//     transformed once (what B4's `share_fwd` does on the TPU, :1117-1148);
//   - two correlation planes per inverse transform: X1 = conj(P) A and X2 =
//     conj(A) B are Hermitian, so the inverse of X1 + i X2 has pair (f - 1,
//     f)'s plane in its real part and pair (f, f + 1)'s in its imaginary part.
//     The first step has no P and an odd tail no b: that plane is skipped.
//   - statistics, gate and sum run per plane in pair order, as the scan's do.
//     Each thread owns fixed elements of the window (tid, tid + threads, ...)
//     and keeps their gated sum in registers for the whole launch (32 floats
//     a thread at 128 x 128); corr_sum is written once at the end. No
//     atomics, a deterministic sum, no accumulator traffic in device memory.
// Shared memory is the complex plane (8 wy wx bytes), the cached half
// spectrum and 2 n twiddles per axis: 196 KB at 128 x 128, 50 KB at 64 x 64;
// blocks of 512 threads at both, one per SM within 128 registers a thread
// (launch bounds: fewer registers cost spills in the passes). What bounds it
// from 64 px up is shared-memory traffic (every pass of the FFT reads and
// writes the plane once) together with the barrier between a pass's reads and
// writes; at 16-32 px a block is one to four warps and its chain of barriers
// and reductions, not bandwidth, sets the time. Each frame byte is read from
// device memory about four times (the overlapping windows), far below its
// rate. A geometry whose cache does not
// fit beside the staging strip and quarter tables of a table-DFT axis (a
// side over 64 px with an odd part over 15) runs the same loop one pair per
// step, without the cache: each frame is then transformed twice.
//
// Entry point `piv_ensemble_launch` has a plain C interface (loaded with
// ctypes); it launches on the given stream, allocates nothing and returns
// cudaGetLastError().

#include "piv_common.cuh"

namespace {

using namespace piv;

// Window (r, c) of frame f starts at frames[f][r * step_y][c * step_x];
// pair p correlates frames p and p + 1. Outputs: sum_out [n_win, wy, wx]
// (fftshifted), count_out [n_win], cmax_out and s2n_out [n_frames - 1, n_win].
// kAcc: the window pixels a thread owns, at most. With `cached` a step takes
// two frames and L.extra holds the half spectrum; without, one pair. WY > 0: L
// is the constant layout of WY x WX windows.
template <typename T, int kAcc, int WY, int WX>
__device__ __forceinline__ void ensemble_block(
    const T* __restrict__ frames, int H, int W, const Layout& L, bool cached, int step_y, int step_x,
    int n_cols, int n_frames, float corr_min, float s2n_min, int has_thr, float thr,
    const float* __restrict__ cos_y, const float* __restrict__ sin_y, const float* __restrict__ cos_x,
    const float* __restrict__ sin_x, float* __restrict__ sum_out, float* __restrict__ count_out,
    float* __restrict__ cmax_out, float* __restrict__ s2n_out) {
    extern __shared__ float smem[];
    const Smem S(smem, L);
    const int wy = L.wy, wx = L.wx, ld = L.ld, N = wy * wx;
    float* Pr = cached ? S.extra : nullptr;
    float* Pi = cached ? Pr + wy * (wx / 2 + 1) : nullptr;

    const int win = blockIdx.x, n_win = gridDim.x;
    const int r = win / n_cols, c = win - r * n_cols;
    const size_t frame_px = static_cast<size_t>(H) * W;
    const T* src = frames + static_cast<size_t>(r) * step_y * W + static_cast<size_t>(c) * step_x;
    const int tid = threadIdx.x, nt = L.nt;

    load_twiddles(cos_y, sin_y, cos_x, sin_x, smem, S, L);  // ordered by load_windows' first reduction
    // the thread owns elements tid + k nt of the fftshifted window, their gated sums in acc[k]
    float acc[kAcc];
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
    float count = 0.f;

    // gates the finished plane of pair `pair` (windows a, b) and adds it
    const auto gate_add = [&](float* plane, int pair, const WinStat& a, const WinStat& b) {
        const bool valid = a.sd > 1e-6f && b.sd > 1e-6f;
        float cmax, s2n;
        finish_plane(plane, L, S.red, a, b, valid, cmax, s2n);
        const bool ok = valid && cmax >= corr_min && s2n >= s2n_min &&
                        !(has_thr && fminf(a.signal, b.signal) < thr);
        if (ok) {
            PixelWalk p(wx, nt);
#pragma unroll
            for (int k = 0; k < kAcc; ++k) {
                if (p.y < wy) acc[k] += plane[unshift(p.y, wy) * ld + unshift(p.x, wx)];
                p.next();
            }
            count += 1.f;
        }
        if (tid == 0) {
            const size_t o = static_cast<size_t>(pair) * n_win + win;
            cmax_out[o] = ok ? cmax : 0.f;
            s2n_out[o] = ok ? s2n : 0.f;
        }
    };

    WinStat prev{0.f, 0.f};
    for (int f = 0; f + (cached ? 0 : 1) < n_frames; f += cached ? 2 : 1) {
        const T* fa = src + static_cast<size_t>(f) * frame_px;
        const bool has_b = f + 1 < n_frames, use_prev = cached && f > 0;
        WinStat a, b;
        load_windows(fa, has_b ? fa + frame_px : nullptr, W, S, L, a, b);
        transform_2d<WY, WX>(false);
        cross_spectra(S, L, Pr, Pi, use_prev, has_b);
        transform_2d<WY, WX>(true);  // the inverse: the planes unshifted in Zr and Zi
        if (use_prev) gate_add(S.Zr, f - 1, prev, a);
        if (has_b) gate_add(S.Zi, f, a, b);
        prev = b;
        __syncthreads();  // the planes are accumulated before the next step overwrites them
    }

    float* dst = sum_out + static_cast<size_t>(win) * N;
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
        if (tid + k * nt < N) dst[tid + k * nt] = acc[k];
    }
    if (tid == 0) count_out[win] = count;
}

// WY x WX windows, the layout a constant of the kernel (the sizes of the main
// paths); WY = 0: any size, the layout `Lp` and `cached` as the launch made them.
template <typename T, int WY, int WX>
__global__ void __launch_bounds__(
    WY ? make_layout(WY ? WY : 8, WX ? WX : 8, 0).nt : kMaxThreads,
    WY ? blocks_per_sm(make_layout(WY ? WY : 8, WX ? WX : 8, half_spectrum(WY, WX))) : 1)
    piv_ensemble_kernel(const T* __restrict__ frames, int H, int W, Layout Lp, int cached, int step_y,
                        int step_x, int n_cols, int n_frames, float corr_min, float s2n_min,
                        int has_thr, float thr, const float* __restrict__ cos_y,
                        const float* __restrict__ sin_y, const float* __restrict__ cos_x,
                        const float* __restrict__ sin_x, float* __restrict__ sum_out,
                        float* __restrict__ count_out, float* __restrict__ cmax_out,
                        float* __restrict__ s2n_out) {
    if constexpr (WY != 0) {
        constexpr Layout L = make_layout(WY, WX, half_spectrum(WY, WX));
        static_assert(L.bytes() <= kMaxSmem, "the cached half spectrum must fit");
        ensemble_block<T, (WY * WX + L.nt - 1) / L.nt, WY, WX>(
            frames, H, W, L, true, step_y, step_x, n_cols, n_frames, corr_min, s2n_min, has_thr, thr,
            cos_y, sin_y, cos_x, sin_x, sum_out, count_out, cmax_out, s2n_out);
    } else {
        ensemble_block<T, 32, 0, 0>(frames, H, W, Lp, cached != 0, step_y, step_x, n_cols, n_frames,
                                     corr_min, s2n_min, has_thr, thr, cos_y, sin_y, cos_x, sin_x,
                                     sum_out, count_out, cmax_out, s2n_out);
    }
}

template <typename T>
cudaError_t launch(const void* frames, int H, int W, int wy, int wx, int step_y, int step_x,
                   int n_rows, int n_cols, int n_frames, float corr_min, float s2n_min,
                   int has_thr, float thr, const float* cos_y, const float* sin_y,
                   const float* cos_x, const float* sin_x, float* corr_sum, float* count,
                   float* cmax, float* s2n, cudaStream_t stream) {
    Layout L = make_layout(wy, wx, half_spectrum(wy, wx));
    const int cached = L.bytes() <= kMaxSmem;
    if (!cached) L.extra = 0;
    const size_t smem = L.bytes();
    auto kernel = piv_ensemble_kernel<T, 0, 0>;
    PIV_FIXED_SIZES(PIV_PICK_KERNEL, piv_ensemble_kernel)
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<n_rows * n_cols, L.nt, smem, stream>>>(
        static_cast<const T*>(frames), H, W, L, cached, step_y, step_x, n_cols, n_frames, corr_min,
        s2n_min, has_thr, thr, cos_y, sin_y, cos_x, sin_x, corr_sum, count, cmax, s2n);
    return cudaGetLastError();
}

}  // namespace

extern "C" int piv_ensemble_launch(const void* frames, int is_u8, int H, int W, int wy, int wx,
                                   int step_y, int step_x, int n_rows, int n_cols, int n_frames,
                                   float corr_min, float s2n_min, int has_thr, float thr,
                                   const void* cos_y, const void* sin_y, const void* cos_x,
                                   const void* sin_x, void* corr_sum, void* count, void* cmax,
                                   void* s2n, void* stream) {
    const float* tabs[4] = {static_cast<const float*>(cos_y), static_cast<const float*>(sin_y),
                            static_cast<const float*>(cos_x), static_cast<const float*>(sin_x)};
    float* out[4] = {static_cast<float*>(corr_sum), static_cast<float*>(count),
                     static_cast<float*>(cmax), static_cast<float*>(s2n)};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err =
        is_u8 ? launch<uint8_t>(frames, H, W, wy, wx, step_y, step_x, n_rows, n_cols, n_frames,
                                corr_min, s2n_min, has_thr, thr, tabs[0], tabs[1], tabs[2],
                                tabs[3], out[0], out[1], out[2], out[3], s)
              : launch<float>(frames, H, W, wy, wx, step_y, step_x, n_rows, n_cols, n_frames,
                              corr_min, s2n_min, has_thr, thr, tabs[0], tabs[1], tabs[2],
                              tabs[3], out[0], out[1], out[2], out[3], s);
    return static_cast<int>(err);
}
