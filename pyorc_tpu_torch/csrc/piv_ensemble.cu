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
// Design, both sides <= 64 px (`piv_ensemble_kernel`): one thread block per
// window, looping over the launch's frames in order. The accumulator plane
// stays in shared memory for the whole launch: no atomics, and the sum runs
// in pair order 0, 1, ... as the scan's does. Each frame's window is loaded,
// demeaned and transformed once; its spectrum is kept in shared memory as the
// first member of the next pair (what B4's `share_fwd` does on the TPU,
// :1117-1148), and the cross spectrum of the current pair overwrites the
// previous spectrum in place. The DFT stages are those of the per-pair kernel
// (piv_common.cuh): separable fp32 products on the CUDA cores against
// float64-made tables; no TF32 or tensor cores, which miss the 0.01 m/s
// velocity bar. Per window pair wy wx (4 wx + 8 wy) FMAs (12 w^3 square),
// nearly all with an operand in shared memory, so shared-memory bandwidth
// bounds it, not HBM: each frame byte is read about four times (the
// overlapping windows) per launch. Shared memory is 8 wy wx floats (window/
// plane 1, row transform 2, the two spectra 4, accumulator 1) plus the tables:
// 160 KB at 64 px, one block per SM; 512 threads at 64 px keep 16 warps on
// each SM.
//
// Design, a side over 64 px (`piv_ensemble_large_kernel`): 8 wy wx floats and
// a cached spectrum do not fit a block's 227 KB at 128 px, so each pair (f,
// f + 1) runs the per-pair kernel's packed layout (piv_common.cuh:
// packed_corr, ~224 KB at 128 x 128, wy wx (3 wx + 4 wy) FMAs per pair): both
// demeaned windows as one complex plane, in-place strip DFTs, Hermitian
// separation. Each frame is transformed twice (once per pair it belongs to).
// The accumulator (64 KB at 128 px) has no room either: it lives in the
// block's own slice of corr_sum in device memory, which each thread reads,
// adds to and writes back at its own elements for every accepted pair, in
// pair order (no atomics, deterministic). That is ~128 KB of traffic per
// window pair (~43 GB over the 4K path, ~13 ms at 3.35 TB/s, against ~1 s of
// arithmetic); the live slices (~8 MB) stay in L2. 512 threads per block, one
// block per SM.
//
// Register tiling of the DFT products and the FFT's O(w^2 log w) work are
// later work. Entry point `piv_ensemble_launch` has a plain C interface
// (loaded with ctypes); it launches on the given stream, allocates nothing
// and returns cudaGetLastError().

#include "piv_common.cuh"

namespace {

using namespace piv;

// Window (r, c) of frame f starts at frames[f][r * step_y][c * step_x];
// pair p correlates frames p and p + 1. Outputs: sum_out [n_win, wy, wx]
// (fftshifted), count_out [n_win], cmax_out and s2n_out [n_frames - 1, n_win].
template <typename T>
__device__ __forceinline__ void ensemble_small(
    const T* __restrict__ frames, int H, int W, int wy, int wx, int step_y, int step_x, int n_cols,
    int n_frames, float corr_min, float s2n_min, int has_thr, float thr,
    const float* __restrict__ cos_y, const float* __restrict__ sin_y,
    const float* __restrict__ cos_x, const float* __restrict__ sin_x, float* __restrict__ sum_out,
    float* __restrict__ count_out, float* __restrict__ cmax_out, float* __restrict__ s2n_out) {
    extern __shared__ float smem[];
    const int N = wy * wx;
    float* w = smem;         // the frame's window; then the pair's correlation plane
    float* pr = w + N;       // row transform; then the inverse column transform
    float* pi = pr + N;
    float* fa_r = pi + N;    // spectrum of the pair's first frame; then the cross spectrum
    float* fa_i = fa_r + N;
    float* fb_r = fa_i + N;  // spectrum of the pair's second frame
    float* fb_i = fb_r + N;
    float* acc = fb_i + N;   // the gated plane sum
    float* red = acc + N;    // 2 * kMaxWarps floats
    float* Cx = red + 2 * kMaxWarps;
    float* Sx = Cx + wx * wx;
    float* Cy = wy == wx ? Cx : Sx + wx * wx;
    float* Sy = wy == wx ? Sx : Cy + wy * wy;

    const int win = blockIdx.x, n_win = gridDim.x;
    const int r = win / n_cols, c = win - r * n_cols;
    const size_t frame_px = static_cast<size_t>(H) * W;
    const T* src = frames + static_cast<size_t>(r) * step_y * W + static_cast<size_t>(c) * step_x;
    const int tid = threadIdx.x, nt = blockDim.x;
    const float nf = static_cast<float>(N);

    load_tables(cos_y, sin_y, cos_x, sin_x, wy, wx, Cy, Sy, Cx, Sx);
    const Tables tab{Cy, Sy, Cx, Sx};
    for (int i = tid; i < N; i += nt) acc[i] = 0.f;
    float count = 0.f, sd_prev = 0.f, sig_prev = 0.f;

    for (int f = 0; f < n_frames; ++f) {
        __syncthreads();  // the last pair's plane in w is accumulated
        // load the window; its sum and non-zero count
        const T* fw = src + static_cast<size_t>(f) * frame_px;
        float st[2] = {0.f, 0.f};
        for (int i = tid; i < N; i += nt) {
            const int y = i / wx, x = i - y * wx;
            const float v = load_px(fw + static_cast<size_t>(y) * W + x);
            w[i] = v;
            st[0] += v;
            st[1] += v > 0.f ? 1.f : 0.f;
        }
        block_sum<2>(st, red);
        const float mean = st[0] / nf, sig = st[1] / nf;

        // demean; standard deviation
        float ss[1] = {0.f};
        for (int i = tid; i < N; i += nt) {
            const float d = w[i] - mean;
            w[i] = d;
            ss[0] += d * d;
        }
        block_sum<1>(ss, red);
        const float sd = sqrtf(ss[0] / nf);

        // forward DFT of the window into fb; from the second frame on, the
        // cross spectrum conj(fa) * fb of pair (f - 1, f) replaces fa
        const bool is_pair = f > 0;
        const float* const win_in[1] = {w};
        float* const row_re[1] = {pr};
        float* const row_im[1] = {pi};
        dft_rows<1>(win_in, row_re, row_im, tab, wy, wx);
        const float* const col_re[1] = {pr};
        const float* const col_im[1] = {pi};
        dft_cols<1>(col_re, col_im, tab, wy, wx, [&](int i, const float (&re)[1], const float (&im)[1]) {
            fb_r[i] = re[0];
            fb_i[i] = im[0];
            if (is_pair) {
                const float ar = fa_r[i], ai = fa_i[i];
                fa_r[i] = ar * re[0] + ai * im[0];
                fa_i[i] = ar * im[0] - ai * re[0];
            }
        });

        if (is_pair) {
            // inverse DFT (real part), normalize, clip, fftshift into w
            idft_cols(fa_r, fa_i, pr, pi, tab, wy, wx);
            const bool valid = sd_prev > 1e-6f && sd > 1e-6f;
            const float denom = corr_denom(nf, sd_prev, sd);
            float vmax = 0.f, vsum = 0.f;
            idft_rows_real(pr, pi, tab, wy, wx, [&](int y, int x, float raw) {
                const float val = valid ? fmaxf(raw / denom, 0.f) : 0.f;
                w[shifted_index(y, x, wy, wx)] = val;
                vmax = fmaxf(vmax, val);
                vsum += val;
            });
            float tot[1] = {vsum};
            block_sum<1>(tot, red);  // also orders the plane's stores before the reads below
            const float cmax = block_max(vmax, red);
            const float s2n = cmax / fmaxf(tot[0] / nf, 1e-10f);
            const bool ok = valid && cmax >= corr_min && s2n >= s2n_min &&
                            !(has_thr && fminf(sig_prev, sig) < thr);
            if (ok) {
                for (int i = tid; i < N; i += nt) acc[i] += w[i];
                count += 1.f;
            }
            if (tid == 0) {
                const size_t o = static_cast<size_t>(f - 1) * n_win + win;
                cmax_out[o] = ok ? cmax : 0.f;
                s2n_out[o] = ok ? s2n : 0.f;
            }
        }
        // this frame's spectrum is the first member of the next pair
        float* t = fa_r;
        fa_r = fb_r;
        fb_r = t;
        t = fa_i;
        fa_i = fb_i;
        fb_i = t;
        sd_prev = sd;
        sig_prev = sig;
    }
    float* dst = sum_out + static_cast<size_t>(win) * N;
    for (int i = tid; i < N; i += nt) dst[i] = acc[i];
    if (tid == 0) count_out[win] = count;
}

// kSquare passes one size for both axes, so the compiler folds the planes'
// row stride and the tables' stride into one (the column stage runs ~10 %
// fewer instructions than with two), and each instance gets its own
// register allocation.
template <typename T, bool kSquare>
__global__ void __launch_bounds__(512)
    piv_ensemble_kernel(const T* __restrict__ frames, int H, int W, int wy, int wx, int step_y,
                        int step_x, int n_cols, int n_frames, float corr_min, float s2n_min,
                        int has_thr, float thr, const float* __restrict__ cos_y,
                        const float* __restrict__ sin_y, const float* __restrict__ cos_x,
                        const float* __restrict__ sin_x, float* __restrict__ sum_out,
                        float* __restrict__ count_out, float* __restrict__ cmax_out,
                        float* __restrict__ s2n_out) {
    ensemble_small(frames, H, W, kSquare ? wx : wy, wx, step_y, step_x, n_cols, n_frames, corr_min,
                   s2n_min, has_thr, thr, cos_y, sin_y, cos_x, sin_x, sum_out, count_out,
                   cmax_out, s2n_out);
}

// A side over 64 px: the contract of piv_ensemble_kernel, one packed window
// pair at a time, the accumulator in the block's slice of sum_out.
template <typename T>
__global__ void __launch_bounds__(kLargeThreads)
    piv_ensemble_large_kernel(const T* __restrict__ frames, int H, int W, int wy, int wx,
                              int step_y, int step_x, int n_cols, int n_frames, float corr_min,
                              float s2n_min, int has_thr, float thr,
                              const float* __restrict__ cos_y, const float* __restrict__ sin_y,
                              const float* __restrict__ cos_x, const float* __restrict__ sin_x,
                              float* __restrict__ sum_out, float* __restrict__ count_out,
                              float* __restrict__ cmax_out, float* __restrict__ s2n_out) {
    extern __shared__ float smem[];
    const LargeLayout L(wy, wx);
    const LargeSmem M(smem, L);
    const int N = wy * wx, ld = L.ld;

    const int win = blockIdx.x, n_win = gridDim.x;
    const int r = win / n_cols, c = win - r * n_cols;
    const size_t frame_px = static_cast<size_t>(H) * W;
    const T* src = frames + static_cast<size_t>(r) * step_y * W + static_cast<size_t>(c) * step_x;
    const int tid = threadIdx.x, nt = blockDim.x;

    // each thread owns elements tid, tid + nt, ... of the block's fftshifted slice
    float* dst = sum_out + static_cast<size_t>(win) * N;
    for (int i = tid; i < N; i += nt) dst[i] = 0.f;
    load_quarter_tables(cos_y, sin_y, cos_x, sin_x, M, L);  // ordered by packed_corr's first reduction
    float count = 0.f;

    for (int p = 0; p + 1 < n_frames; ++p) {
        const T* fa = src + static_cast<size_t>(p) * frame_px;
        const PairCorr pc = packed_corr(fa, fa + frame_px, W, M, L);
        const bool ok = pc.valid && pc.cmax >= corr_min && pc.s2n >= s2n_min &&
                        !(has_thr && pc.signal < thr);
        if (ok) {
            for (int i = tid; i < N; i += nt) {
                const int ys = i / wx, xs = i - ys * wx;
                dst[i] += M.Zr[unshift(ys, wy) * ld + unshift(xs, wx)];
            }
            count += 1.f;
        }
        if (tid == 0) {
            const size_t o = static_cast<size_t>(p) * n_win + win;
            cmax_out[o] = ok ? pc.cmax : 0.f;
            s2n_out[o] = ok ? pc.s2n : 0.f;
        }
        __syncthreads();  // the plane is accumulated before the next pair overwrites it
    }
    if (tid == 0) count_out[win] = count;
}

template <typename T>
cudaError_t launch(const void* frames, int H, int W, int wy, int wx, int step_y, int step_x,
                   int n_rows, int n_cols, int n_frames, float corr_min, float s2n_min,
                   int has_thr, float thr, const float* cos_y, const float* sin_y,
                   const float* cos_x, const float* sin_x, float* corr_sum, float* count,
                   float* cmax, float* s2n, cudaStream_t stream) {
    const int N = wy * wx;
    const bool small = wy <= kSmallMax && wx <= kSmallMax;
    const auto kernel = !small       ? piv_ensemble_large_kernel<T>
                        : wy == wx ? piv_ensemble_kernel<T, true>
                                   : piv_ensemble_kernel<T, false>;
    const size_t smem =
        small ? (8 * static_cast<size_t>(N) + 2 * kMaxWarps + table_floats(wy, wx)) * sizeof(float)
              : LargeLayout(wy, wx).bytes();
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const int threads = small ? (N >= 4096 ? 512 : block_threads(N)) : kLargeThreads;
    kernel<<<n_rows * n_cols, threads, smem, stream>>>(
        static_cast<const T*>(frames), H, W, wy, wx, step_y, step_x, n_cols, n_frames, corr_min,
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
