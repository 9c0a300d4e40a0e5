// Per-pair PIV correlation for Hopper (sm_90a): frames -> (u, v, corr_max, s2n).
//
// Replaces the three Pallas TPU kernels of the per-pair contract
// `piv_pairs_fused` (pyorc_tpu/ops/piv_pallas.py:1482):
//   B1 `_tb_ens_kernel(mode="pairs")` (piv_pallas.py:957), launched by
//      `_piv_pairs_sf_jit` (:1400): shared-forward tileband, 8-32 px windows;
//   B2 `_kernel` (:314), launched by `_piv_pairs_fused_jit` (:1786): band
//      kernel, every other square window of 8-128 px on a uniform grid
//      (multipass PIV's coarse passes: 128 and 64 px for window_size 32);
//   B3 `_tb_kernel` (:561), launched by `_piv_pairs_tb_jit` (:889): tileband
//      without frame sharing, two-frame chunks and pair_stride=2 stacks.
// They compute one function, so this is one entry point. It computes what
// `_finish_corr` (:218-283) and the NaN stores (:445-446, :844-845) compute,
// for square windows of 8-128 px on any uniform step; non-square windows
// raise in the wrapper (ROADMAP.md, queue B).
//
// Design, windows of 8-64 px (`piv_pairs_kernel`): one thread block per
// (pair, window). Both windows live in shared memory; the circular
// cross-correlation is a separable DFT done as small fp32 matrix products on
// the CUDA cores against cos/sin tables made in float64 on the host (no TF32,
// no tensor cores: they miss the 0.01 m/s velocity bar). Per window pair that
// is ~18 w^3 fp32 FMAs (O(w^3)) over 8 w^2 floats of shared memory (128 KB at
// 64 px, hence dynamic shared memory above 48 KB); each FMA reads two
// shared-memory operands, so the kernel is bound by shared-memory bandwidth,
// not by HBM (each frame byte is read by ~4 overlapping windows and twice as a
// pair member). Tables are read transposed where that keeps a warp's accesses
// on distinct banks.
//
// Design, windows of 65-128 px (`piv_pairs_large_kernel`): 8 w^2 floats would
// be 512 KB at 128 px against a block's 227 KB, so both demeaned windows are
// packed into one complex plane z = a + i b (2 w^2 floats) and every DFT stage
// runs in place, a strip of rows or columns at a time through a small staging
// buffer. Each thread computes outputs k and w - k of one line together:
// their twiddles differ only in the sign of the sine, so four running sums
// serve both. The two spectra are separated by Hermitian symmetry,
// A = (Z[k] + conj Z[-k]) / 2 and B = (Z[k] - conj Z[-k]) / 2i, and one thread
// writes X = conj(A) B to k and -k (X is Hermitian). Only the first w/2 + 1
// columns of the tables are kept (cos is even and sin odd in k). Per window
// pair that is ~7 w^3 FMAs with about one shared-memory load each, over
// ~218 KB at 128 px: one block of 512 threads per SM, bound by shared-memory
// bandwidth as above. An FFT, register tiling and computing each frame's
// forward transform once for the two pairs that use it (what B1 does on the
// TPU) are later work.
//
// The small kernel's DFT stages, the reductions and the normalization live in
// piv_common.cuh, shared with piv_ensemble.cu; ops/piv_kernels.py::build_library
// compiles every csrc/*.cu with nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -Xcompiler -fPIC and links them into one shared library. Entry point
// `piv_pairs_launch` has a plain C interface (loaded with ctypes); it
// launches on the given stream, allocates nothing and returns
// cudaGetLastError().

#include "piv_common.cuh"

namespace {

using namespace piv;

constexpr int kSmallMax = 64;        // largest window of piv_pairs_kernel
constexpr int kLargeThreads = 512;   // threads of piv_pairs_large_kernel
constexpr int kStripTasks = 3 * kLargeThreads;  // (line, k) tasks of one staged strip

// Gaussian 3-point sub-pixel offset, as ops/piv.py::subpixel_peak.
__device__ __forceinline__ float gauss3(float lo, float c0, float hi) {
    const float eps = 1e-10f;
    const float ll = logf(fmaxf(lo, eps)), l0 = logf(fmaxf(c0, eps)), lh = logf(fmaxf(hi, eps));
    float den = 2.f * ll - 4.f * l0 + 2.f * lh;
    if (fabsf(den) < eps) den = -eps;
    return fminf(fmaxf((ll - lh) / den, -1.f), 1.f);
}

// First row-major position of the maximum `cmax` of the fftshifted n x n
// plane, where `at(ys, xs)` reads it; every thread gets it.
template <typename At>
__device__ __forceinline__ int first_peak(int n, float cmax, At at, float* red) {
    const int N = n * n;
    int first = N;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const int ys = i / n;
        if (at(ys, i - ys * n) >= cmax) {
            first = i;
            break;
        }
    }
    return block_min_int(first, reinterpret_cast<int*>(red));
}

// Thread 0 fits the sub-pixel peak around `first` and writes the pair's outputs.
template <typename At>
__device__ __forceinline__ void store_pair(int n, int first, float cmax, float s2n, bool valid,
                                           bool low_signal, At at, size_t o, float* u_out,
                                           float* v_out, float* cmax_out, float* s2n_out) {
    if (threadIdx.x != 0) return;
    const int iy = min(max(first / n, 1), n - 2);
    const int ix = min(max(first - (first / n) * n, 1), n - 2);
    const float c0 = at(iy, ix);
    const float dx = gauss3(at(iy, ix - 1), c0, at(iy, ix + 1));
    const float dy = gauss3(at(iy - 1, ix), c0, at(iy + 1, ix));
    const float h2 = static_cast<float>(n / 2);
    float u = valid ? (static_cast<float>(ix) + dx) - h2 : NAN;
    float v = valid ? -((static_cast<float>(iy) + dy) - h2) : NAN;
    float cm = cmax, sn = s2n;
    if (low_signal) u = v = cm = sn = NAN;
    u_out[o] = u;
    v_out[o] = v;
    cmax_out[o] = cm;
    s2n_out[o] = sn;
}

// Shared memory: cos and sin tables (n*n each), six n*n work planes, and the
// reduction scratch. Window (r, c) of frame f starts at
// frames[f][r * step_y][c * step_x]; pair p correlates frames
// p * pair_stride and p * pair_stride + 1.
template <typename T>
__global__ void piv_pairs_kernel(const T* __restrict__ frames, int H, int W, int n, int step_y,
                                 int step_x, int n_cols, int pair_stride, int has_thr, float thr,
                                 const float* __restrict__ cos_tab, const float* __restrict__ sin_tab,
                                 float* __restrict__ u_out, float* __restrict__ v_out,
                                 float* __restrict__ cmax_out, float* __restrict__ s2n_out) {
    extern __shared__ float smem[];
    const int N = n * n;
    float* C = smem;
    float* S = C + N;
    float* b0 = S + N;
    float* b1 = b0 + N;
    float* b2 = b1 + N;
    float* b3 = b2 + N;
    float* b4 = b3 + N;
    float* b5 = b4 + N;
    float* red = b5 + N;  // 4 * kMaxWarps floats

    const int win = blockIdx.x, pair = blockIdx.y;
    const int n_win = gridDim.x;
    const int r = win / n_cols, c = win - r * n_cols;
    const size_t frame_px = static_cast<size_t>(H) * W;
    const T* fa = frames + static_cast<size_t>(pair) * pair_stride * frame_px +
                  static_cast<size_t>(r) * step_y * W + static_cast<size_t>(c) * step_x;
    const T* fb = fa + frame_px;
    const int tid = threadIdx.x, nt = blockDim.x;

    // load both windows and the tables; sums and non-zero counts
    load_tables(cos_tab, sin_tab, C, S, N);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = tid; i < N; i += nt) {
        const int y = i / n, x = i - y * n;
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
    dft_rows<2>(wins, rows_re, rows_im, C, S, n);
    const float* const spec_re[2] = {b2, b4};
    const float* const spec_im[2] = {b3, b5};
    dft_cols<2>(spec_re, spec_im, C, S, n, [&](int i, const float (&re)[2], const float (&im)[2]) {
        b0[i] = re[0] * re[1] + im[0] * im[1];
        b1[i] = re[0] * im[1] - im[0] * re[1];
    });

    // 3-4. inverse DFT (real part), normalize, clip, fftshift into b4
    idft_cols(b0, b1, b2, b3, C, S, n);
    const float denom = corr_denom(nf, sa, sb);
    float vmax = 0.f, vsum = 0.f;
    idft_rows_real(b2, b3, C, S, n, [&](int y, int x, float raw) {
        const float val = valid ? fmaxf(raw / denom, 0.f) : 0.f;
        b4[shifted_index(y, x, n)] = val;
        vmax = fmaxf(vmax, val);
        vsum += val;
    });
    float tot[1] = {vsum};
    block_sum<1>(tot, red);  // also orders the b4 stores before the reads below
    const float cmax = block_max(vmax, red);
    const float s2n = cmax / fmaxf(tot[0] / nf, 1e-10f);

    const auto at = [&](int y, int x) { return b4[y * n + x]; };
    const int first = first_peak(n, cmax, at, red);
    store_pair(n, first, cmax, s2n, valid, has_thr && signal < thr, at,
               static_cast<size_t>(pair) * n_win + win, u_out, v_out, cmax_out, s2n_out);
}

// Shared-memory layout of piv_pairs_large_kernel for n x n windows: the
// packed plane (Zr, Zi: n rows of ld = n + 1 floats, an odd stride that keeps
// a warp's column accesses on distinct banks), the staging strip (Tr, Ti:
// `strip` lines of n + 1 floats), the first kh = n/2 + 1 columns of the
// cos/sin tables (Ch, Sh: n rows of kh), and the reduction scratch.
struct LargeLayout {
    int n, ld, kh, strip;
    __device__ __host__ explicit LargeLayout(int n_)
        : n(n_), ld(n_ + 1), kh(n_ / 2 + 1), strip(kStripTasks / (n_ / 2 + 1)) {
        if (strip > n) strip = n;
    }
    __device__ __host__ size_t plane() const { return static_cast<size_t>(n) * ld; }
    __device__ __host__ size_t staging() const { return static_cast<size_t>(strip) * ld; }
    __device__ __host__ size_t table() const { return static_cast<size_t>(n) * kh; }
    __device__ __host__ size_t bytes() const {
        return (2 * plane() + 2 * staging() + 2 * table() + 4 * kMaxWarps) * sizeof(float);
    }
};

// One in-place DFT stage of the packed plane, strip by strip: along rows
// (kRows: line y, out[y][k] = sum_x Z[y][x] W[x][k]) or along columns (line x,
// out[k][x] = sum_y W[k][y] Z[y][x]), with W = C + i sg S (sg = 1 forward,
// -1 inverse). Each strip of lines is copied to (Tr, Ti), then each thread
// computes outputs k and n - k of a line from four sums and hands them to
// `store(line, k, re, im)`, which may write only that line's outputs. With
// kComplex false only the real parts are formed (im is 0).
template <bool kRows, bool kComplex, typename Store>
__device__ __forceinline__ void dft_strips(const float* Zr, const float* Zi, float* Tr, float* Ti,
                                           const float* Ch, const float* Sh, const LargeLayout& L,
                                           float sg, Store store) {
    const int n = L.n, ld = L.ld, kh = L.kh;
    for (int l0 = 0; l0 < n; l0 += L.strip) {
        const int lines = min(L.strip, n - l0);
        for (int i = threadIdx.x; i < lines * n; i += blockDim.x) {
            int l, j, src;
            if (kRows) {
                l = i / n;
                j = i - l * n;
                src = (l0 + l) * ld + j;
            } else {
                j = i / lines;
                l = i - j * lines;
                src = j * ld + l0 + l;
            }
            Tr[l * ld + j] = Zr[src];
            Ti[l * ld + j] = Zi[src];
        }
        __syncthreads();
        for (int i = threadIdx.x; i < lines * kh; i += blockDim.x) {
            const int l = i / kh, k = i - l * kh;
            const float* tr = Tr + l * ld;
            const float* ti = Ti + l * ld;
            float pc = 0.f, qs = 0.f, ps = 0.f, qc = 0.f;
            for (int j = 0; j < n; ++j) {
                const float p = tr[j], q = ti[j];
                const float c = Ch[j * kh + k], s = Sh[j * kh + k];
                pc = fmaf(p, c, pc);
                qs = fmaf(q, s, qs);
                if (kComplex) {
                    ps = fmaf(p, s, ps);
                    qc = fmaf(q, c, qc);
                }
            }
            store(l0 + l, k, pc - sg * qs, sg * ps + qc);
            if (k != 0 && 2 * k != n) store(l0 + l, n - k, pc + sg * qs, qc - sg * ps);
        }
        __syncthreads();
    }
}

// Row index of the unshifted plane that holds row (or column) `s` of the fftshifted one.
__device__ __forceinline__ int unshift(int s, int n) {
    const int y = s - n / 2;
    return y < 0 ? y + n : y;
}

// Windows of 65-128 px: the contract of piv_pairs_kernel, with the layout of LargeLayout.
template <typename T>
__global__ void __launch_bounds__(kLargeThreads)
    piv_pairs_large_kernel(const T* __restrict__ frames, int H, int W, int n, int step_y,
                           int step_x, int n_cols, int pair_stride, int has_thr, float thr,
                           const float* __restrict__ cos_tab, const float* __restrict__ sin_tab,
                           float* __restrict__ u_out, float* __restrict__ v_out,
                           float* __restrict__ cmax_out, float* __restrict__ s2n_out) {
    extern __shared__ float smem[];
    const LargeLayout L(n);
    const int N = n * n, ld = L.ld, kh = L.kh;
    float* Zr = smem;
    float* Zi = Zr + L.plane();
    float* Tr = Zi + L.plane();
    float* Ti = Tr + L.staging();
    float* Ch = Ti + L.staging();
    float* Sh = Ch + L.table();
    float* red = Sh + L.table();  // 4 * kMaxWarps floats

    const int win = blockIdx.x, pair = blockIdx.y;
    const int n_win = gridDim.x;
    const int r = win / n_cols, c = win - r * n_cols;
    const size_t frame_px = static_cast<size_t>(H) * W;
    const T* fa = frames + static_cast<size_t>(pair) * pair_stride * frame_px +
                  static_cast<size_t>(r) * step_y * W + static_cast<size_t>(c) * step_x;
    const T* fb = fa + frame_px;
    const int tid = threadIdx.x, nt = blockDim.x;

    // the tables' first kh columns; both windows, their sums and non-zero counts
    for (int i = tid; i < n * kh; i += nt) {
        const int x = i / kh, k = i - x * kh;
        Ch[i] = cos_tab[x * n + k];
        Sh[i] = sin_tab[x * n + k];
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = tid; i < N; i += nt) {
        const int y = i / n, x = i - y * n;
        const float va = load_px(fa + static_cast<size_t>(y) * W + x);
        const float vb = load_px(fb + static_cast<size_t>(y) * W + x);
        Zr[y * ld + x] = va;
        Zi[y * ld + x] = vb;
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
        const int e = (i / n) * ld + i % n;
        const float da = Zr[e] - mean_a, db = Zi[e] - mean_b;
        Zr[e] = da;
        Zi[e] = db;
        ss[0] += da * da;
        ss[1] += db * db;
    }
    block_sum<2>(ss, red);
    const float sa = sqrtf(ss[0] / nf), sb = sqrtf(ss[1] / nf);
    const bool valid = sa > 1e-6f && sb > 1e-6f;

    const auto to_row = [&](int y, int k, float re, float im) {
        Zr[y * ld + k] = re;
        Zi[y * ld + k] = im;
    };
    const auto to_col = [&](int x, int k, float re, float im) {
        Zr[k * ld + x] = re;
        Zi[k * ld + x] = im;
    };
    // 1-2. forward DFT of z = a + i b: rows, then columns
    dft_strips<true, true>(Zr, Zi, Tr, Ti, Ch, Sh, L, 1.f, to_row);
    dft_strips<false, true>(Zr, Zi, Tr, Ti, Ch, Sh, L, 1.f, to_col);

    // 3. the two spectra, and X = conj(A) * B at k and -k
    for (int i = tid; i < N; i += nt) {
        const int ky = i / n, kx = i - ky * n;
        const int my = ky ? n - ky : 0, mx = kx ? n - kx : 0;
        const int j = my * n + mx;
        if (j < i) continue;
        const int e = ky * ld + kx, f = my * ld + mx;
        const float zr1 = Zr[e], zi1 = Zi[e], zr2 = Zr[f], zi2 = Zi[f];
        const float ar = 0.5f * (zr1 + zr2), ai = 0.5f * (zi1 - zi2);
        const float br = 0.5f * (zi1 + zi2), bi = 0.5f * (zr2 - zr1);
        const float xr = ar * br + ai * bi, xi = ar * bi - ai * br;
        Zr[e] = xr;
        Zi[e] = xi;
        if (j != i) {
            Zr[f] = xr;
            Zi[f] = -xi;
        }
    }
    __syncthreads();

    // 4-5. inverse DFT: columns, then rows (real part), normalized and
    // clipped into the rows of Zr (unshifted)
    dft_strips<false, true>(Zr, Zi, Tr, Ti, Ch, Sh, L, -1.f, to_col);
    const float denom = corr_denom(nf, sa, sb);
    float vmax = 0.f, vsum = 0.f;
    dft_strips<true, false>(Zr, Zi, Tr, Ti, Ch, Sh, L, -1.f, [&](int y, int x, float raw, float) {
        const float val = valid ? fmaxf(raw / denom, 0.f) : 0.f;
        Zr[y * ld + x] = val;
        vmax = fmaxf(vmax, val);
        vsum += val;
    });
    float tot[1] = {vsum};
    block_sum<1>(tot, red);
    const float cmax = block_max(vmax, red);
    const float s2n = cmax / fmaxf(tot[0] / nf, 1e-10f);

    const auto at = [&](int ys, int xs) { return Zr[unshift(ys, n) * ld + unshift(xs, n)]; };
    const int first = first_peak(n, cmax, at, red);
    store_pair(n, first, cmax, s2n, valid, has_thr && signal < thr, at,
               static_cast<size_t>(pair) * n_win + win, u_out, v_out, cmax_out, s2n_out);
}

template <typename T>
cudaError_t launch(const void* frames, int H, int W, int n, int step_y, int step_x, int n_rows,
                   int n_cols, int n_pairs, int pair_stride, int has_thr, float thr,
                   const float* cos_tab, const float* sin_tab, float* u, float* v, float* cmax,
                   float* s2n, cudaStream_t stream) {
    const bool small = n <= kSmallMax;
    const auto kernel = small ? piv_pairs_kernel<T> : piv_pairs_large_kernel<T>;
    const size_t smem = small ? (8 * static_cast<size_t>(n) * n + 4 * kMaxWarps) * sizeof(float)
                              : LargeLayout(n).bytes();
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    dim3 grid(n_rows * n_cols, n_pairs);
    kernel<<<grid, small ? block_threads(n) : kLargeThreads, smem, stream>>>(
        static_cast<const T*>(frames), H, W, n, step_y, step_x, n_cols, pair_stride, has_thr, thr,
        cos_tab, sin_tab, u, v, cmax, s2n);
    return cudaGetLastError();
}

}  // namespace

extern "C" int piv_pairs_launch(const void* frames, int is_u8, int H, int W, int n, int step_y,
                                int step_x, int n_rows, int n_cols, int n_pairs, int pair_stride,
                                int has_thr, float thr, const void* cos_tab, const void* sin_tab,
                                void* u, void* v, void* cmax, void* s2n, void* stream) {
    const float* ct = static_cast<const float*>(cos_tab);
    const float* st = static_cast<const float*>(sin_tab);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err =
        is_u8 ? launch<uint8_t>(frames, H, W, n, step_y, step_x, n_rows, n_cols, n_pairs,
                                pair_stride, has_thr, thr, ct, st, static_cast<float*>(u),
                                static_cast<float*>(v), static_cast<float*>(cmax),
                                static_cast<float*>(s2n), s)
              : launch<float>(frames, H, W, n, step_y, step_x, n_rows, n_cols, n_pairs,
                              pair_stride, has_thr, thr, ct, st, static_cast<float*>(u),
                              static_cast<float*>(v), static_cast<float*>(cmax),
                              static_cast<float*>(s2n), s);
    return static_cast<int>(err);
}
