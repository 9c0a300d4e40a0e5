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
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Entry point `piv_pairs_launch` has a plain C interface (loaded with ctypes);
// it launches on the given stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 32;

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ int warp_min(int v) {
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// Sums K values over the block; every thread gets the totals, added in one
// fixed order. `red` holds K * kMaxWarps floats.
template <int K>
__device__ void block_sum(float (&v)[K], float* red) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) red[k * kMaxWarps + wid] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
        float t = 0.f;
        for (int j = 0; j < nw; ++j) t += red[k * kMaxWarps + j];
        v[k] = t;
    }
    __syncthreads();
}

__device__ float block_max(float v, float* red) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
    v = warp_max(v);
    if (lane == 0) red[wid] = v;
    __syncthreads();
    float t = red[0];
    for (int j = 1; j < nw; ++j) t = fmaxf(t, red[j]);
    __syncthreads();
    return t;
}

__device__ int block_min_int(int v, int* red) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
    v = warp_min(v);
    if (lane == 0) red[wid] = v;
    __syncthreads();
    int t = red[0];
    for (int j = 1; j < nw; ++j) t = min(t, red[j]);
    __syncthreads();
    return t;
}

__device__ __forceinline__ float load_px(const uint8_t* p) { return static_cast<float>(*p); }
__device__ __forceinline__ float load_px(const float* p) { return *p; }

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
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = tid; i < N; i += nt) {
        C[i] = cos_tab[i];
        S[i] = sin_tab[i];
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

    // 1. row DFT of both windows: P[y][k] = sum_x w[y][x] F[x][k]
    for (int i = tid; i < N; i += nt) {
        const int y = i / n, k = i - y * n;
        const float* wa = b0 + y * n;
        const float* wb = b1 + y * n;
        float ar = 0.f, ai = 0.f, br = 0.f, bi = 0.f;
        for (int x = 0; x < n; ++x) {
            const float cx = C[x * n + k], sx = S[x * n + k];
            ar = fmaf(wa[x], cx, ar);
            ai = fmaf(wa[x], sx, ai);
            br = fmaf(wb[x], cx, br);
            bi = fmaf(wb[x], sx, bi);
        }
        b2[i] = ar;
        b3[i] = ai;
        b4[i] = br;
        b5[i] = bi;
    }
    __syncthreads();

    // 2. column DFT of both, then the spectral product conj(A) * B
    for (int i = tid; i < N; i += nt) {
        const int ky = i / n, kx = i - ky * n;
        float ar = 0.f, ai = 0.f, br = 0.f, bi = 0.f;
        for (int y = 0; y < n; ++y) {
            const float cy = C[ky * n + y], sy = S[ky * n + y];
            const int j = y * n + kx;
            const float pr = b2[j], pi = b3[j], qr = b4[j], qi = b5[j];
            ar += cy * pr - sy * pi;
            ai += cy * pi + sy * pr;
            br += cy * qr - sy * qi;
            bi += cy * qi + sy * qr;
        }
        b0[i] = ar * br + ai * bi;
        b1[i] = ar * bi - ai * br;
    }
    __syncthreads();

    // 3. inverse column DFT: U[y][kx] = sum_ky conj(F)[y][ky] S[ky][kx]
    for (int i = tid; i < N; i += nt) {
        const int y = i / n, kx = i - y * n;
        float ur = 0.f, ui = 0.f;
        for (int ky = 0; ky < n; ++ky) {
            const float cy = C[y * n + ky], sy = S[y * n + ky];
            const float sr = b0[ky * n + kx], si = b1[ky * n + kx];
            ur += cy * sr + sy * si;
            ui += cy * si - sy * sr;
        }
        b2[i] = ur;
        b3[i] = ui;
    }
    __syncthreads();

    // 4. inverse row DFT (real part), normalize, clip, fftshift into b4
    const float denom = nf * fmaxf(nf * sa * sb, 1e-10f);
    const int h2 = n / 2;
    float vmax = 0.f, vsum = 0.f;
    for (int i = tid; i < N; i += nt) {
        const int y = i / n, x = i - y * n;
        const float* ur = b2 + y * n;
        const float* ui = b3 + y * n;
        float raw = 0.f;
        for (int kx = 0; kx < n; ++kx) raw += ur[kx] * C[kx * n + x] + ui[kx] * S[kx * n + x];
        float val = valid ? fmaxf(raw / denom, 0.f) : 0.f;
        int ys = y + h2, xs = x + h2;
        ys -= ys >= n ? n : 0;
        xs -= xs >= n ? n : 0;
        b4[ys * n + xs] = val;
        vmax = fmaxf(vmax, val);
        vsum += val;
    }
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
        float u = valid ? (static_cast<float>(ix) + dx) - static_cast<float>(h2) : NAN;
        float v = valid ? -((static_cast<float>(iy) + dy) - static_cast<float>(h2)) : NAN;
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
    const int N = n * n;
    const size_t smem = (8 * static_cast<size_t>(N) + 4 * kMaxWarps) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(piv_pairs_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int threads = N >= 256 ? 256 : ((N + 31) / 32) * 32;
    dim3 grid(n_rows * n_cols, n_pairs);
    piv_pairs_kernel<T><<<grid, threads, smem, stream>>>(
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
