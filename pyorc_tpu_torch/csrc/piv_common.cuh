// Device code shared by the PIV correlation kernels (piv_pairs.cu,
// piv_ensemble.cu): block reductions, window loads, the separable fp32 DFT of
// wy x wx windows in its two shared-memory layouts, and the normalization of
// a correlation value.
//
// The DFT runs against the cos/sin tables of each axis,
// C[k][x] = cos(-2 pi k x / n), S[k][x] = sin(-2 pi k x / n) for n = wy or wx,
// made in float64 on the host and stored as float32. Along a row a line has
// wx points and uses the x tables; along a column wy points and the y tables.
//
// Small layout (both sides <= 64): whole wy x wx planes and the full tables in
// shared memory; one thread computes one output element per loop step and the
// tables are read in whichever orientation keeps a warp on consecutive (or
// broadcast) addresses. Forward rows cost 2 wx, forward columns 4 wy, inverse
// columns 4 wy and real inverse rows 2 wx FMAs per window pixel.
//
// Packed layout (a side over 64): see LargeLayout and dft_strips.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace piv {

constexpr int kMaxWarps = 32;
constexpr int kSmallMax = 64;                   // largest side of the small layout
constexpr int kLargeThreads = 512;              // threads of a packed-layout block
constexpr int kStripTasks = 3 * kLargeThreads;  // (line, k) tasks of one staged strip

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

// Threads per block for windows of n_pix pixels: a whole number of warps, at most 256.
inline int block_threads(int n_pix) {
    return n_pix >= 256 ? 256 : ((n_pix + 31) / 32) * 32;
}

// ---------------------------------------------------------------- small layout

// The DFT tables of both axes in shared memory: (Cy, Sy) wy x wy and (Cx, Sx)
// wx x wx. A square window keeps one pair (Cy = Cx, Sy = Sx).
struct Tables {
    const float *Cy, *Sy, *Cx, *Sx;
};

// Floats of the small layout's tables for wy x wx windows.
__host__ __device__ inline int table_floats(int wy, int wx) {
    return 2 * wx * wx + (wy == wx ? 0 : 2 * wy * wy);
}

// Copies the DFT tables into shared memory: the x tables to (Cx, Sx) and,
// for a non-square window, the y tables to (Cy, Sy). The kernels derive all
// four pointers from their shared array themselves, so the compiler keeps
// them in the shared address space (LDS, not generic loads).
__device__ inline void load_tables(const float* __restrict__ cos_y, const float* __restrict__ sin_y,
                                   const float* __restrict__ cos_x, const float* __restrict__ sin_x,
                                   int wy, int wx, float* Cy, float* Sy, float* Cx, float* Sx) {
    for (int i = threadIdx.x; i < wx * wx; i += blockDim.x) {
        Cx[i] = cos_x[i];
        Sx[i] = sin_x[i];
    }
    if (wy == wx) return;
    for (int i = threadIdx.x; i < wy * wy; i += blockDim.x) {
        Cy[i] = cos_y[i];
        Sy[i] = sin_y[i];
    }
}

// 1. Forward row DFT of K real wy x wx planes: P[y][k] = sum_x w[y][x] Fx[x][k].
template <int K>
__device__ __forceinline__ void dft_rows(const float* const (&w)[K], float* const (&pr)[K],
                                         float* const (&pi)[K], const Tables& t, int wy, int wx) {
    const int N = wy * wx;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const int y = i / wx, k = i - y * wx;
        float re[K], im[K];
#pragma unroll
        for (int j = 0; j < K; ++j) re[j] = im[j] = 0.f;
        for (int x = 0; x < wx; ++x) {
            const float cx = t.Cx[x * wx + k], sx = t.Sx[x * wx + k];
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const float v = w[j][y * wx + x];
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

// 2. Forward column DFT of K complex planes: A[ky][kx] = sum_y Fy[ky][y] P[y][kx].
// `store(i, re, im)` receives the K spectra at element i; it may write only
// element i of buffers that this stage does not read.
template <int K, typename Store>
__device__ __forceinline__ void dft_cols(const float* const (&pr)[K], const float* const (&pi)[K],
                                         const Tables& t, int wy, int wx, Store store) {
    const int N = wy * wx;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const int ky = i / wx, kx = i - ky * wx;
        float re[K], im[K];
#pragma unroll
        for (int j = 0; j < K; ++j) re[j] = im[j] = 0.f;
        for (int y = 0; y < wy; ++y) {
            const float cy = t.Cy[ky * wy + y], sy = t.Sy[ky * wy + y];
            const int e = y * wx + kx;
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

// 3. Inverse column DFT: U[y][kx] = sum_ky conj(Fy)[y][ky] X[ky][kx].
__device__ __forceinline__ void idft_cols(const float* xr, const float* xi, float* ur, float* ui,
                                          const Tables& t, int wy, int wx) {
    const int N = wy * wx;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const int y = i / wx, kx = i - y * wx;
        float a = 0.f, b = 0.f;
        for (int ky = 0; ky < wy; ++ky) {
            const float cy = t.Cy[y * wy + ky], sy = t.Sy[y * wy + ky];
            const float sr = xr[ky * wx + kx], si = xi[ky * wx + kx];
            a += cy * sr + sy * si;
            b += cy * si - sy * sr;
        }
        ur[i] = a;
        ui[i] = b;
    }
    __syncthreads();
}

// 4. Inverse row DFT, real part: raw[y][x] = Re sum_kx U[y][kx] conj(Fx)[kx][x].
// `emit(y, x, raw)` receives each unnormalized correlation value; the caller
// orders its stores with a block reduction before they are read.
template <typename Emit>
__device__ __forceinline__ void idft_rows_real(const float* ur, const float* ui, const Tables& t,
                                               int wy, int wx, Emit emit) {
    const int N = wy * wx;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const int y = i / wx, x = i - y * wx;
        const float* a = ur + y * wx;
        const float* b = ui + y * wx;
        float raw = 0.f;
        for (int kx = 0; kx < wx; ++kx) raw += a[kx] * t.Cx[kx * wx + x] + b[kx] * t.Sx[kx * wx + x];
        emit(y, x, raw);
    }
}

// The correlation-plane denominator of `_finish_corr`: the inverse DFT's
// N = wy wx times max(N sigma_a sigma_b, 1e-10).
__device__ __forceinline__ float corr_denom(float nf, float sa, float sb) {
    return nf * fmaxf(nf * sa * sb, 1e-10f);
}

// Row-major index of (y, x) of a wy x wx plane after fftshift.
__device__ __forceinline__ int shifted_index(int y, int x, int wy, int wx) {
    int ys = y + wy / 2, xs = x + wx / 2;
    ys -= ys >= wy ? wy : 0;
    xs -= xs >= wx ? wx : 0;
    return ys * wx + xs;
}

// Index of the unshifted axis of n points that holds index `s` of the fftshifted one.
__device__ __forceinline__ int unshift(int s, int n) {
    const int y = s - n / 2;
    return y < 0 ? y + n : y;
}

// --------------------------------------------------------------- packed layout

// An odd stride of at least n floats: a warp walking down a column of rows
// this far apart touches distinct banks.
__host__ __device__ inline int odd_stride(int n) { return n | 1; }

// Shared-memory layout of the packed kernels (windows with a side over 64 px),
// wy x wx windows: the packed complex plane (Zr, Zi: wy rows of ld =
// odd_stride(wx) floats), the staging strip (Tr, Ti: the larger of a strip of
// rows, strip_rows lines of odd_stride(wx) floats, and a strip of columns,
// strip_cols lines of odd_stride(wy)), a quarter of each axis's tables (rows
// and columns 0..n/2 of C and S: cos is even and sin odd in both k and x), and
// the reduction scratch. 223,944 bytes at 128 x 128, the largest geometry.
struct LargeLayout {
    int wy, wx, ld, strip_rows, strip_cols;
    __device__ __host__ LargeLayout(int wy_, int wx_) : wy(wy_), wx(wx_), ld(odd_stride(wx_)) {
        strip_rows = kStripTasks / (wx / 2 + 1);
        if (strip_rows > wy) strip_rows = wy;
        strip_cols = kStripTasks / (wy / 2 + 1);
        if (strip_cols > wx) strip_cols = wx;
    }
    __device__ __host__ size_t plane() const { return static_cast<size_t>(wy) * ld; }
    __device__ __host__ size_t staging() const {
        const size_t r = static_cast<size_t>(strip_rows) * odd_stride(wx);
        const size_t c = static_cast<size_t>(strip_cols) * odd_stride(wy);
        return r > c ? r : c;
    }
    static __device__ __host__ size_t table(int n) {
        return static_cast<size_t>(n / 2 + 1) * (n / 2 + 1);
    }
    __device__ __host__ size_t bytes() const {
        return (2 * plane() + 2 * staging() + 2 * table(wy) + 2 * table(wx) + 4 * kMaxWarps) *
               sizeof(float);
    }
};

// Pointers into a block's shared memory laid out as LargeLayout says.
struct LargeSmem {
    float *Zr, *Zi, *Tr, *Ti, *Cy, *Sy, *Cx, *Sx, *red;
    __device__ LargeSmem(float* smem, const LargeLayout& L) {
        Zr = smem;
        Zi = Zr + L.plane();
        Tr = Zi + L.plane();
        Ti = Tr + L.staging();
        Cy = Ti + L.staging();
        Sy = Cy + LargeLayout::table(L.wy);
        Cx = Sy + LargeLayout::table(L.wy);
        Sx = Cx + LargeLayout::table(L.wx);
        red = Sx + LargeLayout::table(L.wx);  // 4 * kMaxWarps floats
    }
};

// Copies rows and columns 0..n/2 of each axis's n x n tables into shared memory.
__device__ inline void load_quarter_tables(const float* __restrict__ cos_y,
                                           const float* __restrict__ sin_y,
                                           const float* __restrict__ cos_x,
                                           const float* __restrict__ sin_x, const LargeSmem& M,
                                           const LargeLayout& L) {
    const int hy = L.wy / 2 + 1, hx = L.wx / 2 + 1;
    for (int i = threadIdx.x; i < hy * hy; i += blockDim.x) {
        const int j = i / hy, k = i - j * hy;
        M.Cy[i] = cos_y[j * L.wy + k];
        M.Sy[i] = sin_y[j * L.wy + k];
    }
    for (int i = threadIdx.x; i < hx * hx; i += blockDim.x) {
        const int j = i / hx, k = i - j * hx;
        M.Cx[i] = cos_x[j * L.wx + k];
        M.Sx[i] = sin_x[j * L.wx + k];
    }
}

// One in-place DFT stage of the packed plane, strip by strip: along rows
// (kRows: line y of n = wx points, out[y][k] = sum_x Z[y][x] W[x][k]) or along
// columns (line x of n = wy points, out[k][x] = sum_y W[k][y] Z[y][x]), with
// W = C + i sg S of that axis (sg = 1 forward, -1 inverse). Each strip of lines
// is copied to (Tr, Ti), then each thread computes outputs k and n - k of a
// line from four sums (their twiddles differ only in the sign of the sine)
// and hands them to `store(line, k, re, im)`, which may write only that
// line's outputs. Points j <= n/2 read table row j, points j > n/2 row n - j
// with the sine negated. With kComplex false only the real parts are formed
// (im is 0).
template <bool kRows, bool kComplex, typename Store>
__device__ __forceinline__ void dft_strips(const LargeSmem& M, const LargeLayout& L, float sg,
                                           Store store) {
    const int n = kRows ? L.wx : L.wy;
    const int n_lines = kRows ? L.wy : L.wx;
    const int strip = kRows ? L.strip_rows : L.strip_cols;
    const int kh = n / 2 + 1, ld = L.ld, lds = odd_stride(n);
    const float* Ch = kRows ? M.Cx : M.Cy;
    const float* Sh = kRows ? M.Sx : M.Sy;
    for (int l0 = 0; l0 < n_lines; l0 += strip) {
        const int lines = min(strip, n_lines - l0);
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
            M.Tr[l * lds + j] = M.Zr[src];
            M.Ti[l * lds + j] = M.Zi[src];
        }
        __syncthreads();
        for (int i = threadIdx.x; i < lines * kh; i += blockDim.x) {
            const int l = i / kh, k = i - l * kh;
            const float* tr = M.Tr + l * lds;
            const float* ti = M.Ti + l * lds;
            float pc = 0.f, qs = 0.f, ps = 0.f, qc = 0.f;
            for (int j = 0; j < kh; ++j) {
                const float p = tr[j], q = ti[j];
                const float c = Ch[j * kh + k], s = Sh[j * kh + k];
                pc = fmaf(p, c, pc);
                qs = fmaf(q, s, qs);
                if (kComplex) {
                    ps = fmaf(p, s, ps);
                    qc = fmaf(q, c, qc);
                }
            }
            for (int j = kh; j < n; ++j) {
                const float p = tr[j], q = ti[j];
                const float c = Ch[(n - j) * kh + k], s = -Sh[(n - j) * kh + k];
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

// What the packed layout knows of a window pair after packed_corr.
struct PairCorr {
    float cmax, s2n, signal;  // signal: the smaller non-zero fraction of the two windows
    bool valid;               // both windows have variance
};

// One window pair in the packed layout: windows a (at fa) and b (at fb), rows
// W elements apart, are loaded as z = a + i b, demeaned, and transformed
// (rows, then columns); the two spectra are separated by Hermitian symmetry,
// A = (Z[k] + conj Z[-k]) / 2 and B = (Z[k] - conj Z[-k]) / 2i with -k =
// (-ky mod wy, -kx mod wx), and one thread writes X = conj(A) B to k and -k
// (X is Hermitian); the inverse (columns, then rows, real part) leaves the
// normalized, clipped correlation plane of `_finish_corr`, unshifted, in the
// rows of M.Zr. Needs the quarter tables in place; the block must be in step
// on entry (its first stores overwrite the plane) and is in step on return.
template <typename T>
__device__ PairCorr packed_corr(const T* fa, const T* fb, int W, const LargeSmem& M,
                                const LargeLayout& L) {
    const int wy = L.wy, wx = L.wx, ld = L.ld, N = wy * wx;
    const int tid = threadIdx.x, nt = blockDim.x;
    float* Zr = M.Zr;
    float* Zi = M.Zi;

    // both windows, their sums and non-zero counts
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = tid; i < N; i += nt) {
        const int y = i / wx, x = i - y * wx;
        const float va = load_px(fa + static_cast<size_t>(y) * W + x);
        const float vb = load_px(fb + static_cast<size_t>(y) * W + x);
        Zr[y * ld + x] = va;
        Zi[y * ld + x] = vb;
        acc[0] += va;
        acc[1] += vb;
        acc[2] += va > 0.f ? 1.f : 0.f;
        acc[3] += vb > 0.f ? 1.f : 0.f;
    }
    block_sum<4>(acc, M.red);
    const float nf = static_cast<float>(N);
    const float mean_a = acc[0] / nf, mean_b = acc[1] / nf;
    PairCorr out;
    out.signal = fminf(acc[2] / nf, acc[3] / nf);

    // demean; standard deviations
    float ss[2] = {0.f, 0.f};
    for (int i = tid; i < N; i += nt) {
        const int e = (i / wx) * ld + i % wx;
        const float da = Zr[e] - mean_a, db = Zi[e] - mean_b;
        Zr[e] = da;
        Zi[e] = db;
        ss[0] += da * da;
        ss[1] += db * db;
    }
    block_sum<2>(ss, M.red);
    const float sa = sqrtf(ss[0] / nf), sb = sqrtf(ss[1] / nf);
    out.valid = sa > 1e-6f && sb > 1e-6f;

    const auto to_row = [&](int y, int k, float re, float im) {
        Zr[y * ld + k] = re;
        Zi[y * ld + k] = im;
    };
    const auto to_col = [&](int x, int k, float re, float im) {
        Zr[k * ld + x] = re;
        Zi[k * ld + x] = im;
    };
    // 1-2. forward DFT of z = a + i b: rows, then columns
    dft_strips<true, true>(M, L, 1.f, to_row);
    dft_strips<false, true>(M, L, 1.f, to_col);

    // 3. the two spectra, and X = conj(A) * B at k and -k
    for (int i = tid; i < N; i += nt) {
        const int ky = i / wx, kx = i - ky * wx;
        const int my = ky ? wy - ky : 0, mx = kx ? wx - kx : 0;
        const int j = my * wx + mx;
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
    dft_strips<false, true>(M, L, -1.f, to_col);
    const float denom = corr_denom(nf, sa, sb);
    const bool valid = out.valid;
    float vmax = 0.f, vsum = 0.f;
    dft_strips<true, false>(M, L, -1.f, [&](int y, int x, float raw, float) {
        const float val = valid ? fmaxf(raw / denom, 0.f) : 0.f;
        Zr[y * ld + x] = val;
        vmax = fmaxf(vmax, val);
        vsum += val;
    });
    float tot[1] = {vsum};
    block_sum<1>(tot, M.red);
    out.cmax = block_max(vmax, M.red);
    out.s2n = out.cmax / fmaxf(tot[0] / nf, 1e-10f);
    return out;
}

}  // namespace piv
