// Device code shared by the PIV correlation kernels (piv_pairs.cu,
// piv_ensemble.cu): block reductions, window loads, the four stages of the
// separable fp32 DFT, and the normalization of a correlation value.
//
// The DFT runs on n x n planes in shared memory against the cos/sin tables
// C[k][x] = cos(-2 pi k x / n), S[k][x] = sin(-2 pi k x / n), made in float64
// on the host and stored as float32. One thread computes one output element
// per loop step; the tables are read in whichever orientation keeps a warp on
// consecutive (or broadcast) addresses. Each stage is O(n^3) FMAs.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace piv {

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
// fixed order. `red` holds K * kMaxWarps floats. Starts and ends with the
// block in step, so it also orders shared-memory stores before later reads.
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

__device__ inline float block_max(float v, float* red) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
    v = warp_max(v);
    if (lane == 0) red[wid] = v;
    __syncthreads();
    float t = red[0];
    for (int j = 1; j < nw; ++j) t = fmaxf(t, red[j]);
    __syncthreads();
    return t;
}

__device__ inline int block_min_int(int v, int* red) {
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

// Threads per block for n x n windows: a whole number of warps, at most 256.
inline int block_threads(int n) {
    const int N = n * n;
    return N >= 256 ? 256 : ((N + 31) / 32) * 32;
}

// Copies the two n*n DFT tables into shared memory.
__device__ __forceinline__ void load_tables(const float* __restrict__ cos_tab,
                                            const float* __restrict__ sin_tab, float* C, float* S,
                                            int N) {
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        C[i] = cos_tab[i];
        S[i] = sin_tab[i];
    }
}

// 1. Forward row DFT of K real planes: P[y][k] = sum_x w[y][x] F[x][k].
template <int K>
__device__ __forceinline__ void dft_rows(const float* const (&w)[K], float* const (&pr)[K],
                                         float* const (&pi)[K], const float* C, const float* S,
                                         int n) {
    const int N = n * n;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const int y = i / n, k = i - y * n;
        float re[K], im[K];
#pragma unroll
        for (int j = 0; j < K; ++j) re[j] = im[j] = 0.f;
        for (int x = 0; x < n; ++x) {
            const float cx = C[x * n + k], sx = S[x * n + k];
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const float v = w[j][y * n + x];
                re[j] = fmaf(v, cx, re[j]);
                im[j] = fmaf(v, sx, im[j]);
            }
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
            pr[j][i] = re[j];
            pi[j][i] = im[j];
        }
    }
    __syncthreads();
}

// 2. Forward column DFT of K complex planes: A[ky][kx] = sum_y F[ky][y] P[y][kx].
// `store(i, re, im)` receives the K spectra at element i; it may write only
// element i of buffers that this stage does not read.
template <int K, typename Store>
__device__ __forceinline__ void dft_cols(const float* const (&pr)[K], const float* const (&pi)[K],
                                         const float* C, const float* S, int n, Store store) {
    const int N = n * n;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const int ky = i / n, kx = i - ky * n;
        float re[K], im[K];
#pragma unroll
        for (int j = 0; j < K; ++j) re[j] = im[j] = 0.f;
        for (int y = 0; y < n; ++y) {
            const float cy = C[ky * n + y], sy = S[ky * n + y];
            const int e = y * n + kx;
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const float p = pr[j][e], q = pi[j][e];
                re[j] += cy * p - sy * q;
                im[j] += cy * q + sy * p;
            }
        }
        store(i, re, im);
    }
    __syncthreads();
}

// 3. Inverse column DFT: U[y][kx] = sum_ky conj(F)[y][ky] X[ky][kx].
__device__ __forceinline__ void idft_cols(const float* xr, const float* xi, float* ur, float* ui,
                                          const float* C, const float* S, int n) {
    const int N = n * n;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const int y = i / n, kx = i - y * n;
        float a = 0.f, b = 0.f;
        for (int ky = 0; ky < n; ++ky) {
            const float cy = C[y * n + ky], sy = S[y * n + ky];
            const float sr = xr[ky * n + kx], si = xi[ky * n + kx];
            a += cy * sr + sy * si;
            b += cy * si - sy * sr;
        }
        ur[i] = a;
        ui[i] = b;
    }
    __syncthreads();
}

// 4. Inverse row DFT, real part: raw[y][x] = Re sum_kx U[y][kx] conj(F)[kx][x].
// `emit(y, x, raw)` receives each unnormalized correlation value; the caller
// orders its stores with a block reduction before they are read.
template <typename Emit>
__device__ __forceinline__ void idft_rows_real(const float* ur, const float* ui, const float* C,
                                               const float* S, int n, Emit emit) {
    const int N = n * n;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const int y = i / n, x = i - y * n;
        const float* a = ur + y * n;
        const float* b = ui + y * n;
        float raw = 0.f;
        for (int kx = 0; kx < n; ++kx) raw += a[kx] * C[kx * n + x] + b[kx] * S[kx * n + x];
        emit(y, x, raw);
    }
}

// The correlation-plane denominator of `_finish_corr`: the inverse DFT's n^2
// times max(n^2 sigma_a sigma_b, 1e-10).
__device__ __forceinline__ float corr_denom(float nf, float sa, float sb) {
    return nf * fmaxf(nf * sa * sb, 1e-10f);
}

// Row-major index of (y, x) after fftshift.
__device__ __forceinline__ int shifted_index(int y, int x, int n) {
    const int h2 = n / 2;
    int ys = y + h2, xs = x + h2;
    ys -= ys >= n ? n : 0;
    xs -= xs >= n ? n : 0;
    return ys * n + xs;
}

}  // namespace piv
