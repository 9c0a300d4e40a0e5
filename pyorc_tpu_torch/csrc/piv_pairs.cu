// Per-pair PIV correlation for Hopper (sm_90a): frames -> (u, v, corr_max, s2n).
//
// Replaces the three Pallas TPU kernels of the per-pair contract
// `piv_pairs_fused` (pyorc_tpu/ops/piv_pallas.py:1482):
//   B1 `_tb_ens_kernel(mode="pairs")` (piv_pallas.py:957), launched by
//      `_piv_pairs_sf_jit` (:1400): shared-forward tileband, 8-32 px windows;
//   B2 `_kernel` (:314), launched by `_piv_pairs_fused_jit` (:1786): band
//      kernel, 64 px windows;
//   B3 `_tb_kernel` (:561), launched by `_piv_pairs_tb_jit` (:889): tileband
//      without frame sharing, two-frame chunks and pair_stride=2 stacks.
// They compute one function, so this is one kernel. It computes what
// `_finish_corr` (:218-283) and the NaN stores (:445-446, :844-845) compute.
//
// Design: one thread block per (pair, window). Both windows live in shared
// memory; the circular cross-correlation is a separable DFT done as small
// fp32 matrix products on the CUDA cores against cos/sin tables made in
// float64 on the host (no TF32, no tensor cores: they miss the 0.01 m/s
// velocity bar). Per window pair that is ~18 w^3 fp32 FMAs (O(w^3)) over
// 8 w^2 floats of shared memory (128 KB at 64 px, hence dynamic shared
// memory above 48 KB); each FMA reads two shared-memory operands, so the
// kernel is bound by shared-memory bandwidth, not by HBM (each frame byte is
// read by ~4 overlapping windows and twice as a pair member). Tables are
// read transposed where that keeps a warp's accesses on distinct banks.
// Computing each frame's forward transform once for the two pairs that use
// it (what B1 does on the TPU) and register tiling are later work.
//
// The DFT stages, reductions and normalization live in piv_common.cuh, shared
// with piv_ensemble.cu; ops/piv_kernels.py::build_library compiles every
// csrc/*.cu with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler
// -fPIC and links them into one shared library. Entry point
// `piv_pairs_launch` has a plain C interface (loaded with ctypes); it
// launches on the given stream, allocates nothing and returns
// cudaGetLastError().

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

    // first row-major position of the maximum
    int first = N;
    for (int i = tid; i < N; i += nt) {
        if (b4[i] >= cmax) {
            first = i;
            break;
        }
    }
    first = block_min_int(first, reinterpret_cast<int*>(red));

    if (tid == 0) {
        const size_t o = static_cast<size_t>(pair) * n_win + win;
        const int iy = min(max(first / n, 1), n - 2);
        const int ix = min(max(first - (first / n) * n, 1), n - 2);
        const float c0 = b4[iy * n + ix];
        const float dx = gauss3(b4[iy * n + ix - 1], c0, b4[iy * n + ix + 1]);
        const float dy = gauss3(b4[(iy - 1) * n + ix], c0, b4[(iy + 1) * n + ix]);
        const float h2 = static_cast<float>(n / 2);
        float u = valid ? (static_cast<float>(ix) + dx) - h2 : NAN;
        float v = valid ? -((static_cast<float>(iy) + dy) - h2) : NAN;
        float cm = cmax, sn = s2n;
        if (has_thr && signal < thr) u = v = cm = sn = NAN;
        u_out[o] = u;
        v_out[o] = v;
        cmax_out[o] = cm;
        s2n_out[o] = sn;
    }
}

template <typename T>
cudaError_t launch(const void* frames, int H, int W, int n, int step_y, int step_x, int n_rows,
                   int n_cols, int n_pairs, int pair_stride, int has_thr, float thr,
                   const float* cos_tab, const float* sin_tab, float* u, float* v, float* cmax,
                   float* s2n, cudaStream_t stream) {
    const size_t smem = (8 * static_cast<size_t>(n) * n + 4 * kMaxWarps) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(piv_pairs_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    dim3 grid(n_rows * n_cols, n_pairs);
    piv_pairs_kernel<T><<<grid, block_threads(n), smem, stream>>>(
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
