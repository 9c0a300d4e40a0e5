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
// Design, both sides <= 64 px (`piv_pairs_kernel`): one thread block per
// (pair, window). Both windows live in shared memory; the circular
// cross-correlation is a separable DFT done as small fp32 matrix products on
// the CUDA cores against cos/sin tables made in float64 on the host (no TF32,
// no tensor cores: they miss the 0.01 m/s velocity bar). Per window pair that
// is wy wx (6 wx + 12 wy) fp32 FMAs (18 w^3 square) over 6 wy wx floats of
// planes plus the tables of both axes (one set when square: 128 KB at 64 px,
// hence dynamic shared memory above 48 KB); each FMA reads two shared-memory
// operands, so the kernel is bound by shared-memory bandwidth, not by HBM
// (each frame byte is read by ~4 overlapping windows and twice as a pair
// member). Tables are read transposed where that keeps a warp's accesses on
// distinct banks.
//
// Design, a side over 64 px (`piv_pairs_large_kernel`): 6 wy wx floats would
// be 384 KB at 128 px against a block's 227 KB, so both demeaned windows are
// packed into one complex plane z = a + i b and every DFT stage runs in place,
// a strip of rows or columns at a time through a small staging buffer, with
// outputs k and n - k of a line computed together and the spectra separated
// by Hermitian symmetry (piv_common.cuh: LargeLayout, dft_strips,
// packed_corr). Per window pair that is wy wx (3 wx + 4 wy) FMAs (7 w^3
// square) with about one shared-memory load each, over 224 KB at 128 x 128:
// one block of 512 threads per SM, bound by shared-memory bandwidth as above.
// An FFT, register tiling and computing each frame's forward transform once
// for the two pairs that use it (what B1 does on the TPU) are later work.
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
    const int N = wy * wx;
    int first = N;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const int ys = i / wx;
        if (at(ys, i - ys * wx) >= cmax) {
            first = i;
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

// Shared memory: six wy*wx work planes, the reduction scratch, and the cos/sin
// tables (table_floats). Window (r, c) of frame f starts at
// frames[f][r * step_y][c * step_x]; pair p correlates frames
// p * pair_stride and p * pair_stride + 1.
template <typename T>
__device__ __forceinline__ void pairs_small(
    const T* __restrict__ frames, int H, int W, int wy, int wx, int step_y, int step_x, int n_cols,
    int pair_stride, int has_thr, float thr, const float* __restrict__ cos_y,
    const float* __restrict__ sin_y, const float* __restrict__ cos_x,
    const float* __restrict__ sin_x, float* __restrict__ u_out, float* __restrict__ v_out,
    float* __restrict__ cmax_out, float* __restrict__ s2n_out) {
    extern __shared__ float smem[];
    const int N = wy * wx;
    float* b0 = smem;
    float* b1 = b0 + N;
    float* b2 = b1 + N;
    float* b3 = b2 + N;
    float* b4 = b3 + N;
    float* b5 = b4 + N;
    float* red = b5 + N;  // 4 * kMaxWarps floats
    float* Cx = red + 4 * kMaxWarps;
    float* Sx = Cx + wx * wx;
    float* Cy = wy == wx ? Cx : Sx + wx * wx;
    float* Sy = wy == wx ? Sx : Cy + wy * wy;

    const int win = blockIdx.x, pair = blockIdx.y;
    const int n_win = gridDim.x;
    const int r = win / n_cols, c = win - r * n_cols;
    const size_t frame_px = static_cast<size_t>(H) * W;
    const T* fa = frames + static_cast<size_t>(pair) * pair_stride * frame_px +
                  static_cast<size_t>(r) * step_y * W + static_cast<size_t>(c) * step_x;
    const T* fb = fa + frame_px;
    const int tid = threadIdx.x, nt = blockDim.x;

    // load both windows and the tables; sums and non-zero counts
    load_tables(cos_y, sin_y, cos_x, sin_x, wy, wx, Cy, Sy, Cx, Sx);
    const Tables tab{Cy, Sy, Cx, Sx};
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = tid; i < N; i += nt) {
        const int y = i / wx, x = i - y * wx;
        const float va = load_px(fa + static_cast<size_t>(y) * W + x);
        const float vb = load_px(fb + static_cast<size_t>(y) * W + x);
        b0[i] = va;
        b1[i] = vb;
        acc[0] += va;
        acc[1] += vb;
        acc[2] += va > 0.f ? 1.f : 0.f;
        acc[3] += vb > 0.f ? 1.f : 0.f;
    }
    block_sum<4>(acc, red);
    const float nf = static_cast<float>(N);
    const float mean_a = acc[0] / nf, mean_b = acc[1] / nf;
    const float signal = fminf(acc[2] / nf, acc[3] / nf);

    // demean; standard deviations
    float ss[2] = {0.f, 0.f};
    for (int i = tid; i < N; i += nt) {
        const float da = b0[i] - mean_a, db = b1[i] - mean_b;
        b0[i] = da;
        b1[i] = db;
        ss[0] += da * da;
        ss[1] += db * db;
    }
    block_sum<2>(ss, red);
    const float sa = sqrtf(ss[0] / nf), sb = sqrtf(ss[1] / nf);
    const bool valid = sa > 1e-6f && sb > 1e-6f;

    // 1-2. forward DFT of both windows, then the spectral product conj(A) * B
    // into b0/b1 (the windows are dead after stage 1)
    const float* const wins[2] = {b0, b1};
    float* const rows_re[2] = {b2, b4};
    float* const rows_im[2] = {b3, b5};
    dft_rows<2>(wins, rows_re, rows_im, tab, wy, wx);
    const float* const spec_re[2] = {b2, b4};
    const float* const spec_im[2] = {b3, b5};
    dft_cols<2>(spec_re, spec_im, tab, wy, wx, [&](int i, const float (&re)[2], const float (&im)[2]) {
        b0[i] = re[0] * re[1] + im[0] * im[1];
        b1[i] = re[0] * im[1] - im[0] * re[1];
    });

    // 3-4. inverse DFT (real part), normalize, clip, fftshift into b4
    idft_cols(b0, b1, b2, b3, tab, wy, wx);
    const float denom = corr_denom(nf, sa, sb);
    float vmax = 0.f, vsum = 0.f;
    idft_rows_real(b2, b3, tab, wy, wx, [&](int y, int x, float raw) {
        const float val = valid ? fmaxf(raw / denom, 0.f) : 0.f;
        b4[shifted_index(y, x, wy, wx)] = val;
        vmax = fmaxf(vmax, val);
        vsum += val;
    });
    float tot[1] = {vsum};
    block_sum<1>(tot, red);  // also orders the b4 stores before the reads below
    const float cmax = block_max(vmax, red);
    const float s2n = cmax / fmaxf(tot[0] / nf, 1e-10f);

    const auto at = [&](int y, int x) { return b4[y * wx + x]; };
    const int first = first_peak(wy, wx, cmax, at, red);
    store_pair(wy, wx, first, cmax, s2n, valid, has_thr && signal < thr, at,
               static_cast<size_t>(pair) * n_win + win, u_out, v_out, cmax_out, s2n_out);
}

// kSquare passes one size for both axes, so the compiler folds the planes'
// row stride and the tables' stride into one (the column stage runs ~10 %
// fewer instructions than with two), and each instance gets its own
// register allocation.
template <typename T, bool kSquare>
__global__ void piv_pairs_kernel(const T* __restrict__ frames, int H, int W, int wy, int wx,
                                 int step_y, int step_x, int n_cols, int pair_stride, int has_thr,
                                 float thr, const float* __restrict__ cos_y,
                                 const float* __restrict__ sin_y, const float* __restrict__ cos_x,
                                 const float* __restrict__ sin_x, float* __restrict__ u_out,
                                 float* __restrict__ v_out, float* __restrict__ cmax_out,
                                 float* __restrict__ s2n_out) {
    pairs_small(frames, H, W, kSquare ? wx : wy, wx, step_y, step_x, n_cols, pair_stride, has_thr,
                thr, cos_y, sin_y, cos_x, sin_x, u_out, v_out, cmax_out, s2n_out);
}

// A side over 64 px: the contract of piv_pairs_kernel in the packed layout.
template <typename T>
__global__ void __launch_bounds__(kLargeThreads)
    piv_pairs_large_kernel(const T* __restrict__ frames, int H, int W, int wy, int wx, int step_y,
                           int step_x, int n_cols, int pair_stride, int has_thr, float thr,
                           const float* __restrict__ cos_y, const float* __restrict__ sin_y,
                           const float* __restrict__ cos_x, const float* __restrict__ sin_x,
                           float* __restrict__ u_out, float* __restrict__ v_out,
                           float* __restrict__ cmax_out, float* __restrict__ s2n_out) {
    extern __shared__ float smem[];
    const LargeLayout L(wy, wx);
    const LargeSmem M(smem, L);

    const int win = blockIdx.x, pair = blockIdx.y;
    const int n_win = gridDim.x;
    const int r = win / n_cols, c = win - r * n_cols;
    const size_t frame_px = static_cast<size_t>(H) * W;
    const T* fa = frames + static_cast<size_t>(pair) * pair_stride * frame_px +
                  static_cast<size_t>(r) * step_y * W + static_cast<size_t>(c) * step_x;

    load_quarter_tables(cos_y, sin_y, cos_x, sin_x, M, L);  // ordered by packed_corr's first reduction
    const PairCorr pc = packed_corr(fa, fa + frame_px, W, M, L);

    const int ld = L.ld;
    const auto at = [&](int ys, int xs) { return M.Zr[unshift(ys, wy) * ld + unshift(xs, wx)]; };
    const int first = first_peak(wy, wx, pc.cmax, at, M.red);
    store_pair(wy, wx, first, pc.cmax, pc.s2n, pc.valid, has_thr && pc.signal < thr, at,
               static_cast<size_t>(pair) * n_win + win, u_out, v_out, cmax_out, s2n_out);
}

template <typename T>
cudaError_t launch(const void* frames, int H, int W, int wy, int wx, int step_y, int step_x,
                   int n_rows, int n_cols, int n_pairs, int pair_stride, int has_thr, float thr,
                   const float* cos_y, const float* sin_y, const float* cos_x, const float* sin_x,
                   float* u, float* v, float* cmax, float* s2n, cudaStream_t stream) {
    const bool small = wy <= kSmallMax && wx <= kSmallMax;
    const auto kernel = !small       ? piv_pairs_large_kernel<T>
                        : wy == wx ? piv_pairs_kernel<T, true>
                                   : piv_pairs_kernel<T, false>;
    const size_t smem =
        small ? (6 * static_cast<size_t>(wy) * wx + 4 * kMaxWarps + table_floats(wy, wx)) * sizeof(float)
              : LargeLayout(wy, wx).bytes();
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    dim3 grid(n_rows * n_cols, n_pairs);
    kernel<<<grid, small ? block_threads(wy * wx) : kLargeThreads, smem, stream>>>(
        static_cast<const T*>(frames), H, W, wy, wx, step_y, step_x, n_cols, pair_stride, has_thr,
        thr, cos_y, sin_y, cos_x, sin_x, u, v, cmax, s2n);
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
