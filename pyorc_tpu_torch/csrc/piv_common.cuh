// Device code shared by the PIV correlation kernels (piv_pairs.cu,
// piv_ensemble.cu): block reductions, the in-block 2-D transform of a complex
// wy x wx plane in shared memory, the packing of two real windows into one
// complex plane, their cross spectra, and the normalization of a correlation
// plane.
//
// One layout for every side of 8-128 px. The block keeps one complex plane
// (Zr, Zi: wy rows of ld = odd_stride(wx) floats) and transforms it in place,
// along rows, then along columns. The transform is separable, so each axis has
// its own plan (plan_axis), made on the host from its length n = 2^a m (m odd):
//
// - m <= 15 (8, 16, 26, 32, 52, 64, 104, 128, 12, 24, 40, 48, 96, ...): a
//   Stockham FFT whose butterflies live in registers (fft_lines). The passes
//   are the odd part first (an m-point DFT of the 2^a interleaved subsequences,
//   its m x m table a strided view of the twiddles) and then radices 8, 4 or 2
//   with hard-coded constants. `tpl` threads share a line; each holds up to 16
//   points, multiplies them by twiddles W_n^j read from row 1 of the axis's
//   n x n table (2 n floats in shared memory), and the line is exchanged
//   through shared memory once per pass. O(n log n) per line, where the table
//   DFT this replaces was O(n^2).
// - m > 15 (17, 66, 75, 127, ...): the table DFT along that axis (dft_strips):
//   a strip of lines at a time through a staging buffer, outputs k and n - k
//   of a line together, against a quarter of the axis's cos/sin tables.
//
// Bank conflicts. Rows are an odd number of floats apart. In fft_lines
// consecutive threads of a warp hold the same points of consecutive lines:
// along rows their addresses differ by ld (odd, so 32 lines fall on 32 banks),
// along columns by 1. Both reads and writes of every pass follow this pattern,
// so they are conflict-free where a warp's 32 threads hold 32 lines (windows
// of 32 px and more); a warp that spans two positions of a 16-line round can
// meet a two-way conflict. The twiddle of a pass depends on the thread's
// position in its line only, which such a warp shares: a broadcast. In
// dft_strips the staged lines keep an odd stride for the same reason.
//
// A kernel calls the 2-D transform through transform_2d<WY, WX>: the window
// sizes of the main paths (PIV_FIXED_SIZES) have a kernel and a transform
// built for that size, its plan a constant, so the passes unroll and the
// index arithmetic folds; every other size runs one kernel whose layout is a
// run-time value kept at the start of shared memory.
//
// The inverse transform is the forward one with real and imaginary parts
// swapped on the way in and out, so no stage takes a sign. Twiddles and tables
// are made in float64 on the host and stored as float32; no fast intrinsics,
// no TF32, no tensor cores (the 0.01 m/s velocity bar).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace piv {

constexpr int kMaxWarps = 32;
constexpr int kMaxThreads = 512;     // threads of the largest block
constexpr int kMaxOdd = 15;          // largest odd part of a side that the FFT takes
constexpr int kStripTasks = 1536;    // (line, k) tasks of one staged strip of a table axis
constexpr int kPlanFloats = 32;      // start of a block's shared memory, kept for a run-time Layout
constexpr int kMaxSmem = 232448;     // dynamic shared memory a Hopper block may have
constexpr int kPointsPerThread = 8;  // of a line, where the block has threads for that
constexpr int kThreadsPerSM = 512;   // that share an SM: 128 registers a thread (fewer cost spills at 26-64 px)

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

// The correlation-plane denominator of `_finish_corr`: the inverse DFT's
// N = wy wx times max(N sigma_a sigma_b, 1e-10).
__device__ __forceinline__ float corr_denom(float nf, float sa, float sb) {
    return nf * fmaxf(nf * sa * sb, 1e-10f);
}

// Index of the unshifted axis of n points that holds index `s` of the fftshifted one.
__device__ __forceinline__ int unshift(int s, int n) {
    const int y = s - n / 2;
    return y < 0 ? y + n : y;
}

// An odd stride of at least n floats: a warp walking down a column of rows
// this far apart touches distinct banks.
__host__ __device__ constexpr int odd_stride(int n) { return n | 1; }

// ------------------------------------------------------------------ the plan

// How lines of n points are transformed. n_pass > 0: the FFT, radix(s) its
// passes in order (an odd radix only first; four bits each, so that a plan
// passed to a kernel stays in registers), `tpl` threads to a line. n_pass ==
// 0: the table DFT (the odd part of n exceeds kMaxOdd).
struct AxisPlan {
    int n, n_pass, tpl, radices;
    __host__ __device__ constexpr int radix(int s) const { return (radices >> (4 * s)) & 15; }
    __host__ __device__ constexpr void add(int r) { radices |= r << (4 * n_pass++); }
};

// Butterflies of radix r that one thread holds in a pass: at most 16 points.
__host__ __device__ constexpr int butterflies_per_thread(int r) { return r <= 8 ? 16 / r : 1; }

// The plan of lines of n points, `lines` of them in the plane. A thread gets
// about kPointsPerThread points of a line where the block has threads for
// that, and never more than the pass's butterflies_per_thread.
__host__ __device__ constexpr AxisPlan plan_axis(int n, int lines) {
    AxisPlan a{};
    a.n = n;
    int m = n;
    while (m % 2 == 0) m /= 2;
    if (m > kMaxOdd) return a;
    if (m > 1) a.add(m);
    int pow2 = n / m;
    while (pow2 >= 8 && pow2 != 16) {
        a.add(8);
        pow2 /= 8;
    }
    if (pow2 == 16) {
        a.add(4);
        a.add(4);
    } else if (pow2 > 1) {
        a.add(pow2);
    }
    int least = 1;
    for (int s = 0; s < a.n_pass; ++s) {
        const int b = butterflies_per_thread(a.radix(s)), nb = n / a.radix(s);
        if ((nb + b - 1) / b > least) least = (nb + b - 1) / b;
    }
    int want = (n + kPointsPerThread - 1) / kPointsPerThread;
    const int room = kMaxThreads / lines;
    if (want > room) want = room;
    if (m > 1 && want > n / m) want = n / m;  // the odd pass has n / m butterflies to a line
    a.tpl = want > least ? want : least;
    return a;
}

// Shared-memory layout of a block, wy x wx windows: kPlanFloats floats that
// hold this Layout itself where it is a run-time value, the complex plane, each
// axis's twiddles (FFT: row 1 of its tables, 2 n floats; table DFT: rows and
// columns 0..n/2 of C and S, cos being even and sin odd in both indices; one
// set when square), the staging strip of the table axes (the larger of
// strip_rows lines of odd_stride(wx) floats and strip_cols lines of
// odd_stride(wy)), the reduction scratch and `extra` floats of the kernel's
// own. 200,320 bytes for the ensemble kernel at 128 x 128, the largest FFT
// geometry (its `extra` the cached half spectrum). `nt` is the block's
// threads: every line of a round of either axis has its tpl threads (a table
// axis wants one thread per (line, k) task), and no thread owns more than 32
// pixels of the window.
struct Layout {
    int wy, wx, ld, nt;
    AxisPlan py, px;  // along columns (wy points), along rows (wx points)
    int strip_rows, strip_cols;
    int extra;

    __device__ __host__ constexpr int plane() const { return wy * ld; }
    __device__ __host__ constexpr int staging() const {
        const int r = strip_rows * odd_stride(wx), c = strip_cols * odd_stride(wy);
        return r > c ? r : c;
    }
    static __device__ __host__ constexpr int twiddles(const AxisPlan& a) {
        return a.n_pass ? a.n : (a.n / 2 + 1) * (a.n / 2 + 1);
    }
    __device__ __host__ constexpr size_t bytes() const {
        return sizeof(float) * (kPlanFloats + 2 * plane() + 2 * twiddles(px) +
                                (wy == wx ? 0 : 2 * twiddles(py)) + 2 * staging() + 4 * kMaxWarps + extra);
    }
};

// Floats of a cached half spectrum: columns kx <= wx / 2, real and imaginary.
__host__ __device__ constexpr int half_spectrum(int wy, int wx) { return 2 * wy * (wx / 2 + 1); }

__host__ __device__ constexpr Layout make_layout(int wy, int wx, int extra) {
    Layout L{};
    L.wy = wy;
    L.wx = wx;
    L.ld = odd_stride(wx);
    L.extra = extra;
    L.px = plan_axis(wx, wy);
    L.py = plan_axis(wy, wx);
    L.strip_rows = L.px.n_pass ? 0 : kStripTasks / (wx / 2 + 1);
    if (L.strip_rows > wy) L.strip_rows = wy;
    L.strip_cols = L.py.n_pass ? 0 : kStripTasks / (wy / 2 + 1);
    if (L.strip_cols > wx) L.strip_cols = wx;
    const int tx = L.px.n_pass ? wy * L.px.tpl : wy * (wx / 2 + 1);
    const int ty = L.py.n_pass ? wx * L.py.tpl : wx * (wy / 2 + 1);
    L.nt = ((tx > ty ? tx : ty) + 31) / 32 * 32;
    if (L.nt > kMaxThreads) L.nt = kMaxThreads;
    while (32 * L.nt < wy * wx) L.nt += 32;
    return L;
}

// Pointers into a block's shared memory laid out as Layout says.
struct Smem {
    float *Zr, *Zi, *Wxc, *Wxs, *Wyc, *Wys, *Tr, *Ti, *red, *extra;
    __device__ Smem(float* smem, const Layout& L) {
        Zr = smem + kPlanFloats;
        Zi = Zr + L.plane();
        Wxc = Zi + L.plane();
        Wxs = Wxc + Layout::twiddles(L.px);
        const bool square = L.wy == L.wx;
        Wyc = square ? Wxc : Wxs + Layout::twiddles(L.px);
        Wys = square ? Wxs : Wyc + Layout::twiddles(L.py);
        Tr = Wys + Layout::twiddles(L.py);
        Ti = Tr + L.staging();
        red = Ti + L.staging();  // 4 * kMaxWarps floats
        extra = red + 4 * kMaxWarps;
    }
};

// Copies one axis's twiddles from its n x n tables into shared memory.
__device__ inline void load_axis_twiddles(const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                                          const AxisPlan& a, float* Wc, float* Ws) {
    const int n = a.n;
    if (a.n_pass) {
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            Wc[i] = cos_t[n + i];
            Ws[i] = sin_t[n + i];
        }
        return;
    }
    const int h = n / 2 + 1;
    for (int i = threadIdx.x; i < h * h; i += blockDim.x) {
        const int j = i / h, k = i - j * h;
        Wc[i] = cos_t[j * n + k];
        Ws[i] = sin_t[j * n + k];
    }
}

// Both axes' twiddles and, for transform_2d_any, the layout itself into the
// start of shared memory; the caller orders them before the first transform (a
// block reduction does).
__device__ inline void load_twiddles(const float* __restrict__ cos_y, const float* __restrict__ sin_y,
                                     const float* __restrict__ cos_x, const float* __restrict__ sin_x,
                                     float* smem, const Smem& S, const Layout& L) {
    static_assert(sizeof(Layout) <= kPlanFloats * sizeof(float), "the layout fits its slot");
    if (threadIdx.x == 0) *reinterpret_cast<Layout*>(smem) = L;
    load_axis_twiddles(cos_x, sin_x, L.px, S.Wxc, S.Wxs);
    if (L.wy != L.wx) load_axis_twiddles(cos_y, sin_y, L.py, S.Wyc, S.Wys);
}

// ------------------------------------------------------------------- the FFT

// Forward 4-point DFT (W_4 = -i) of a0..a3, in place, outputs in natural order.
__device__ __forceinline__ void dft4(float& r0, float& i0, float& r1, float& i1, float& r2, float& i2,
                                     float& r3, float& i3) {
    const float s0r = r0 + r2, s0i = i0 + i2, s1r = r0 - r2, s1i = i0 - i2;
    const float s2r = r1 + r3, s2i = i1 + i3, s3r = r1 - r3, s3i = i1 - i3;
    r0 = s0r + s2r;
    i0 = s0i + s2i;
    r1 = s1r + s3i;
    i1 = s1i - s3r;
    r2 = s0r - s2r;
    i2 = s0i - s2i;
    r3 = s1r - s3i;
    i3 = s1i + s3r;
}

// Forward R-point DFT of (r, i) in registers, outputs in natural order.
template <int R>
__device__ __forceinline__ void butterfly(float (&r)[R], float (&i)[R]);

template <>
__device__ __forceinline__ void butterfly<2>(float (&r)[2], float (&i)[2]) {
    const float ar = r[0], ai = i[0];
    r[0] = ar + r[1];
    i[0] = ai + i[1];
    r[1] = ar - r[1];
    i[1] = ai - i[1];
}

template <>
__device__ __forceinline__ void butterfly<4>(float (&r)[4], float (&i)[4]) {
    dft4(r[0], i[0], r[1], i[1], r[2], i[2], r[3], i[3]);
}

// Even and odd points as two 4-point DFTs E and O, then U[t] = E[t] + W_8^t O[t]
// and U[t + 4] = E[t] - W_8^t O[t], W_8^t = 1, (1 - i) / sqrt 2, -i, (-1 - i) / sqrt 2.
template <>
__device__ __forceinline__ void butterfly<8>(float (&r)[8], float (&i)[8]) {
    const float h = 0.70710678118654752440f;
    dft4(r[0], i[0], r[2], i[2], r[4], i[4], r[6], i[6]);
    dft4(r[1], i[1], r[3], i[3], r[5], i[5], r[7], i[7]);
    const float er[4] = {r[0], r[2], r[4], r[6]}, ei[4] = {i[0], i[2], i[4], i[6]};
    const float wr[4] = {r[1], h * (r[3] + i[3]), i[5], h * (i[7] - r[7])};
    const float wi[4] = {i[1], h * (i[3] - r[3]), -r[5], -h * (r[7] + i[7])};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        r[t] = er[t] + wr[t];
        i[t] = ei[t] + wi[t];
        r[t + 4] = er[t] - wr[t];
        i[t + 4] = ei[t] - wi[t];
    }
}

// One thread's share of one Stockham pass of radix R over one line (xr, xi)
// whose points lie `ps` floats apart: butterflies i = sub, sub + tpl, ... < T
// = n / R. Butterfly i reads points i + t T, turns point t by W_n^(k t tw)
// with k = i mod p (p the product of the earlier radices, tw = T / p), and
// after the block is in step writes output t to j + t p, j = (i - k) R + k.
template <int R>
__device__ __forceinline__ void radix_pass(float* xr, float* xi, int ps, int n, int p, int sub, int tpl,
                                           bool active, const float* Wc, const float* Ws) {
    constexpr int B = butterflies_per_thread(R);
    const int T = n / R, tw = T / p;
    float ur[B][R], ui[B][R];
    int out[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
        const int i = sub + b * tpl;
        out[b] = -1;
        if (active && i < T) {
            const int k = i % p;
            out[b] = (i - k) * R + k;
#pragma unroll
            for (int t = 0; t < R; ++t) {
                ur[b][t] = xr[(i + t * T) * ps];
                ui[b][t] = xi[(i + t * T) * ps];
            }
            if (p > 1) {
#pragma unroll
                for (int t = 1; t < R; ++t) {
                    const float c = Wc[t * k * tw], s = Ws[t * k * tw];
                    const float a = ur[b][t], d = ui[b][t];
                    ur[b][t] = a * c - d * s;
                    ui[b][t] = a * s + d * c;
                }
            }
            butterfly<R>(ur[b], ui[b]);
        }
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < B; ++b) {
        if (out[b] >= 0) {
#pragma unroll
            for (int t = 0; t < R; ++t) {
                xr[(out[b] + t * p) * ps] = ur[b][t];
                xi[(out[b] + t * p) * ps] = ui[b][t];
            }
        }
    }
}

// The odd part M of n, always the first pass (p = 1): butterfly i takes the
// subsequence i + s T, s < M (T = n / M), into registers and, once the block
// is in step, writes its M-point DFT to i M + t. Points s and M - s are
// paired, a_s = x_s + x_(M-s) and b_s = x_s - x_(M-s), so that with P = x_0 +
// sum_s cos(2 pi s t / M) a_s and Q = sum_s sin(2 pi s t / M) b_s (s = 1..
// (M-1)/2) outputs t and M - t are P - i Q and P + i Q: a quarter of the
// products of the plain M-point DFT. The (M-1)/2 cosines and sines are W_n^(j
// T), a strided view of the line's own twiddles, held in registers.
template <int M>
__device__ __forceinline__ void odd_pass(float* xr, float* xi, int ps, int n, int sub, int tpl, bool active,
                                         const float* Wc, const float* Ws) {
    constexpr int B = butterflies_per_thread(M), Hf = (M - 1) / 2;
    const int T = n / M;
    float ur[B][M], ui[B][M], c[Hf + 1], sn[Hf + 1];
    c[0] = 1.f;  // s t is a multiple of M where M is composite (9, 15)
    sn[0] = 0.f;
#pragma unroll
    for (int j = 1; j <= Hf; ++j) {
        c[j] = Wc[j * T];
        sn[j] = -Ws[j * T];  // sin(2 pi j / M)
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
        const int i = sub + b * tpl;
        if (active && i < T) {
#pragma unroll
            for (int s = 0; s < M; ++s) {
                ur[b][s] = xr[(i + s * T) * ps];
                ui[b][s] = xi[(i + s * T) * ps];
            }
        }
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < B; ++b) {
        const int i = sub + b * tpl;
        if (!(active && i < T)) continue;
        float(&vr)[M] = ur[b];
        float(&vi)[M] = ui[b];
        float sr = vr[0], si = vi[0];
#pragma unroll
        for (int s = 1; s <= Hf; ++s) {
            const float ar = vr[s] + vr[M - s], ai = vi[s] + vi[M - s];
            vr[M - s] = vr[s] - vr[M - s];  // b_s
            vi[M - s] = vi[s] - vi[M - s];
            vr[s] = ar;  // a_s
            vi[s] = ai;
            sr += ar;
            si += ai;
        }
        float* yr = xr + i * M * ps;
        float* yi = xi + i * M * ps;
        yr[0] = sr;
        yi[0] = si;
#pragma unroll
        for (int t = 1; t <= Hf; ++t) {
            float pr = vr[0], pi = vi[0], qr = 0.f, qi = 0.f;
#pragma unroll
            for (int s = 1; s <= Hf; ++s) {
                const int j = (s * t) % M;
                const float cj = j <= Hf ? c[j] : c[M - j];
                const float sj = j <= Hf ? sn[j] : -sn[M - j];
                pr = fmaf(cj, vr[s], pr);
                pi = fmaf(cj, vi[s], pi);
                qr = fmaf(sj, vr[M - s], qr);
                qi = fmaf(sj, vi[M - s], qi);
            }
            yr[t * ps] = pr + qi;
            yi[t * ps] = pi - qr;
            yr[(M - t) * ps] = pr - qi;
            yi[(M - t) * ps] = pi + qr;
        }
    }
}

// One pass of radix R (an odd R: the odd pass) as a function of its own, the
// line and its twiddles given as offsets into the block's shared memory. The
// kernel that takes any size calls its passes this way: inlined side by side,
// the passes of every radix share one register allocation, and the spills of
// the widest (the odd parts) then slow every size (PERF.md, findings of this redesign).
template <int R>
static __device__ __noinline__ void pass_call(int xr, int xi, int ps, int n, int p, int sub, int tpl, bool active,
                                              int wc, int ws) {
    extern __shared__ float smem[];
    if constexpr (R % 2 == 0) {
        radix_pass<R>(smem + xr, smem + xi, ps, n, p, sub, tpl, active, smem + wc, smem + ws);
    } else {
        odd_pass<R>(smem + xr, smem + xi, ps, n, sub, tpl, active, smem + wc, smem + ws);
    }
}

// One pass of radix R over the thread's line: inlined, or (kCall) through pass_call.
template <bool kCall, int R>
__device__ __forceinline__ void one_pass(float* xr, float* xi, int ps, int n, int p, int sub, int tpl, bool active,
                                         const float* Wc, const float* Ws) {
    if constexpr (kCall) {
        extern __shared__ float smem[];
        pass_call<R>(static_cast<int>(xr - smem), static_cast<int>(xi - smem), ps, n, p, sub, tpl, active,
                     static_cast<int>(Wc - smem), static_cast<int>(Ws - smem));
    } else if constexpr (R % 2 == 0) {
        radix_pass<R>(xr, xi, ps, n, p, sub, tpl, active, Wc, Ws);
    } else {
        odd_pass<R>(xr, xi, ps, n, sub, tpl, active, Wc, Ws);
    }
}

// Forward FFT, in place, of every line of the plane (re, im) along rows (kRows:
// n_lines = wy lines of wx points) or columns. Lines are taken a round of
// nt / tpl (nt the block's threads) at a time; a step (pass, round) reads into
// registers, brings the block in step and writes, so consecutive steps are one
// __syncthreads apart: a round's lines are next read a whole pass later,
// which with two rounds or more is past another step's barrier. The plane
// must be in place and the block in step on entry; it is in step on return.
template <bool kRows, bool kCall>
__device__ __forceinline__ void fft_lines(float* re, float* im, int ld, int n_lines, int nt, const AxisPlan& a,
                                          const float* Wc, const float* Ws) {
    const int n = a.n, tpl = a.tpl;
    const int per_round = nt / tpl;
    const int sub = threadIdx.x / per_round, lane_line = threadIdx.x - sub * per_round;
    const int rounds = (n_lines + per_round - 1) / per_round;
    const int ls = kRows ? ld : 1, ps = kRows ? 1 : ld;
    int p = 1;
    for (int s = 0; s < a.n_pass; ++s) {
        const int r = a.radix(s);
        for (int rd = 0; rd < rounds; ++rd) {
            const int line = rd * per_round + lane_line;
            const bool active = sub < tpl && line < n_lines;
            float* xr = re + line * ls;
            float* xi = im + line * ls;
            switch (r) {
#define PIV_PASS(R)                                                           \
    case R:                                                                   \
        one_pass<kCall, R>(xr, xi, ps, n, p, sub, tpl, active, Wc, Ws); \
        break;
                PIV_PASS(8) PIV_PASS(4) PIV_PASS(2) PIV_PASS(13) PIV_PASS(3) PIV_PASS(5) PIV_PASS(7) PIV_PASS(9)
                PIV_PASS(11) PIV_PASS(15)
#undef PIV_PASS
            }
        }
        if (rounds == 1) __syncthreads();
        p *= r;
    }
    if (rounds > 1) __syncthreads();
}

// ------------------------------------------------------------- the table DFT

// Forward DFT, in place, of every line of the plane (re, im) along rows (kRows:
// line y of n = wx points, out[y][k] = sum_x Z[y][x] W[x][k]) or columns (line
// x of n = wy points), W = C + i S of that axis, for an axis the FFT does not
// take. Each strip of lines is copied to (Tr, Ti); then each thread computes
// outputs k and n - k of a line from four sums (their twiddles differ only in
// the sign of the sine) and writes them back. Points j <= n/2 read row j of
// the quarter tables (Ch, Sh), points j > n/2 row n - j with the sine negated.
template <bool kRows>
__device__ __forceinline__ void dft_strips(float* re, float* im, int ld, int n, int n_lines, int strip,
                                           float* Tr, float* Ti, const float* Ch, const float* Sh) {
    const int kh = n / 2 + 1, lds = odd_stride(n);
    const int ls = kRows ? ld : 1, ps = kRows ? 1 : ld;
    for (int l0 = 0; l0 < n_lines; l0 += strip) {
        const int lines = min(strip, n_lines - l0);
        for (int i = threadIdx.x; i < lines * n; i += blockDim.x) {
            int l, j;
            if (kRows) {
                l = i / n;
                j = i - l * n;
            } else {
                j = i / lines;
                l = i - j * lines;
            }
            Tr[l * lds + j] = re[(l0 + l) * ls + j * ps];
            Ti[l * lds + j] = im[(l0 + l) * ls + j * ps];
        }
        __syncthreads();
        for (int i = threadIdx.x; i < lines * kh; i += blockDim.x) {
            const int l = i / kh, k = i - l * kh;
            const float* tr = Tr + l * lds;
            const float* ti = Ti + l * lds;
            float pc = 0.f, qs = 0.f, ps_ = 0.f, qc = 0.f;
            for (int j = 0; j < kh; ++j) {
                const float p = tr[j], q = ti[j];
                const float c = Ch[j * kh + k], s = Sh[j * kh + k];
                pc = fmaf(p, c, pc);
                qs = fmaf(q, s, qs);
                ps_ = fmaf(p, s, ps_);
                qc = fmaf(q, c, qc);
            }
            for (int j = kh; j < n; ++j) {
                const float p = tr[j], q = ti[j];
                const float c = Ch[(n - j) * kh + k], s = -Sh[(n - j) * kh + k];
                pc = fmaf(p, c, pc);
                qs = fmaf(q, s, qs);
                ps_ = fmaf(p, s, ps_);
                qc = fmaf(q, c, qc);
            }
            float* orr = re + (l0 + l) * ls;
            float* oi = im + (l0 + l) * ls;
            orr[k * ps] = pc - qs;
            oi[k * ps] = ps_ + qc;
            if (k != 0 && 2 * k != n) {
                orr[(n - k) * ps] = pc + qs;
                oi[(n - k) * ps] = qc - ps_;
            }
        }
        __syncthreads();
    }
}

// Forward 2-D transform of the block's plane, in place: rows, then columns,
// each axis by its plan; `inverse`: with the real and imaginary parts swapped,
// which makes it the unnormalized inverse. Block in step on entry and on
// return. The two functions below are not inlined: a kernel calls the
// transform twice per step, and one copy of the passes keeps the code, and
// the time to build it, small. They take the plane from the block's shared
// memory themselves, so that its loads and stores stay shared-memory
// instructions.
template <bool kCall>
__device__ __forceinline__ void transform_2d_inline(bool inverse, const Smem& S, const Layout& L) {
    float* re = inverse ? S.Zi : S.Zr;
    float* im = inverse ? S.Zr : S.Zi;
    if (L.px.n_pass) {
        fft_lines<true, kCall>(re, im, L.ld, L.wy, L.nt, L.px, S.Wxc, S.Wxs);
    } else {
        dft_strips<true>(re, im, L.ld, L.wx, L.wy, L.strip_rows, S.Tr, S.Ti, S.Wxc, S.Wxs);
    }
    if (L.py.n_pass) {
        fft_lines<false, kCall>(re, im, L.ld, L.wx, L.nt, L.py, S.Wyc, S.Wys);
    } else {
        dft_strips<false>(re, im, L.ld, L.wy, L.wx, L.strip_cols, S.Tr, S.Ti, S.Wyc, S.Wys);
    }
}

// Any size: the layout is the run-time value that load_twiddles left at the
// start of shared memory.
static __device__ __noinline__ void transform_2d_any(bool inverse) {
    extern __shared__ float smem[];
    const Layout L = *reinterpret_cast<const Layout*>(smem);
    transform_2d_inline<true>(inverse, Smem(smem, L), L);
}

// WY x WX windows: the layout is a constant, so the passes unroll, only the
// radices of that size remain and the index arithmetic folds. One copy per
// size, shared by a kernel's uint8 and float32 instances.
template <int WY, int WX>
static __device__ __noinline__ void transform_2d_fixed(bool inverse) {
    extern __shared__ float smem[];
    constexpr Layout L = make_layout(WY, WX, 0);
    static_assert(L.px.n_pass > 0 && L.py.n_pass > 0, "a fixed size runs the FFT along both axes");
    transform_2d_inline<false>(inverse, Smem(smem, L), L);
}

// WY > 0: the block's windows are WY x WX.
template <int WY, int WX>
__device__ __forceinline__ void transform_2d(bool inverse) {
    if constexpr (WY != 0) {
        transform_2d_fixed<WY, WX>(inverse);
    } else {
        transform_2d_any(inverse);
    }
}

// Blocks of a kernel that should share an SM, for its launch bounds: as many
// as keep kThreadsPerSM threads there, but no more than shared memory holds.
__host__ __device__ constexpr int blocks_per_sm(const Layout& L) {
    int b = kThreadsPerSM / L.nt;
    const int room = static_cast<int>(kMaxSmem / L.bytes());
    if (b > room) b = room;
    return b < 1 ? 1 : b;
}

// ------------------------------------------------------------ window pairs

// Walks the pixels tid, tid + nt, ... of a wy x wx window as (y, x); next()
// moves nt pixels on. (A division per pixel: with wx a constant of the kernel
// it folds, and measured faster than carrying (y, x) along.)
struct PixelWalk {
    int i, y, x, nt, wx;
    __device__ __forceinline__ PixelWalk(int wx_, int nt_) : i(threadIdx.x), nt(nt_), wx(wx_) { split(); }
    __device__ __forceinline__ void split() {
        y = i / wx;
        x = i - y * wx;
    }
    __device__ __forceinline__ void next() {
        i += nt;
        split();
    }
};

// What the block knows of one window: its standard deviation and its
// fraction of non-zero pixels.
struct WinStat {
    float sd, signal;
};

// Loads windows a (at fa) and b (at fb; none if null: the plane's imaginary
// part is then 0), rows W elements apart, as z = a + i b into the plane, each
// less its mean. The block must be in step on entry (the stores overwrite the
// plane) and is in step on return.
template <typename T>
__device__ __forceinline__ void load_windows(const T* fa, const T* fb, int W, const Smem& S, const Layout& L,
                                             WinStat& a, WinStat& b) {
    const int wy = L.wy, wx = L.wx, ld = L.ld, N = wy * wx;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (PixelWalk p(wx, L.nt); p.y < wy; p.next()) {
        const float va = load_px(fa + p.y * W + p.x);
        const float vb = fb ? load_px(fb + p.y * W + p.x) : 0.f;
        S.Zr[p.y * ld + p.x] = va;
        S.Zi[p.y * ld + p.x] = vb;
        acc[0] += va;
        acc[1] += vb;
        acc[2] += va > 0.f ? 1.f : 0.f;
        acc[3] += vb > 0.f ? 1.f : 0.f;
    }
    block_sum<4>(acc, S.red);
    const float nf = static_cast<float>(N);
    const float mean_a = acc[0] / nf, mean_b = acc[1] / nf;
    a.signal = acc[2] / nf;
    b.signal = acc[3] / nf;
    float ss[2] = {0.f, 0.f};
    for (PixelWalk p(wx, L.nt); p.y < wy; p.next()) {
        const int e = p.y * ld + p.x;
        const float da = S.Zr[e] - mean_a, db = S.Zi[e] - mean_b;
        S.Zr[e] = da;
        S.Zi[e] = db;
        ss[0] += da * da;
        ss[1] += db * db;
    }
    block_sum<2>(ss, S.red);
    a.sd = sqrtf(ss[0] / nf);
    b.sd = sqrtf(ss[1] / nf);
}

// The plane holds Z, the transform of z = a + i b. Separates the two spectra
// by Hermitian symmetry, A = (Z[k] + conj Z[-k]) / 2 and B = (Z[k] - conj
// Z[-k]) / 2i with -k = (-ky mod wy, -kx mod wx), and overwrites the plane
// with Y = X1 + i X2, where X1 = conj(P) A (0 unless use_prev; P the spectrum
// cached in (Pr, Pi)) and X2 = conj(A) B (0 unless has_b). X1 and X2 are
// Hermitian, so the inverse transform of Y has the correlation plane of (p, a)
// in its real part and that of (a, b) in its imaginary part. With a cache, B
// then replaces P. One thread handles k and -k; the cache keeps columns kx <=
// wx / 2 of a spectrum ([wy][wx / 2 + 1]), the entry of k or its conjugate
// at -k. Ends with the block in step.
__device__ __forceinline__ void cross_spectra(const Smem& S, const Layout& L, float* Pr, float* Pi,
                                              bool use_prev, bool has_b) {
    const int wy = L.wy, wx = L.wx, ld = L.ld, hx = wx / 2 + 1;
    for (PixelWalk p(wx, L.nt); p.y < wy; p.next()) {
        const int ky = p.y, kx = p.x;
        const int my = ky ? wy - ky : 0, mx = kx ? wx - kx : 0;
        const int i = ky * wx + kx, j = my * wx + mx;
        if (j < i) continue;
        const int e = ky * ld + kx, f = my * ld + mx;
        const float zr1 = S.Zr[e], zi1 = S.Zi[e], zr2 = S.Zr[f], zi2 = S.Zi[f];
        const float ar = 0.5f * (zr1 + zr2), ai = 0.5f * (zi1 - zi2);
        const float br = 0.5f * (zi1 + zi2), bi = 0.5f * (zr2 - zr1);
        const bool at_k = kx < hx;  // the cache holds k itself, else -k
        const int c = at_k ? ky * hx + kx : my * hx + mx;
        float x1r = 0.f, x1i = 0.f, x2r = 0.f, x2i = 0.f;
        if (use_prev) {
            const float pr = Pr[c], pi = at_k ? Pi[c] : -Pi[c];
            x1r = pr * ar + pi * ai;
            x1i = pr * ai - pi * ar;
        }
        if (has_b) {
            x2r = ar * br + ai * bi;
            x2i = ar * bi - ai * br;
        }
        if (Pr) {
            Pr[c] = br;
            Pi[c] = at_k ? bi : -bi;
        }
        S.Zr[e] = x1r - x2i;
        S.Zi[e] = x1i + x2r;
        if (j != i) {
            S.Zr[f] = x1r + x2i;
            S.Zi[f] = x2r - x1i;
        }
    }
    __syncthreads();
}

// Turns a raw correlation plane (the unnormalized inverse transform, unshifted,
// rows ld apart) into the normalized, clipped plane of `_finish_corr` in
// place, and gives every thread its maximum and s2n = max / max(mean, 1e-10).
// Ends with the block in step.
__device__ __forceinline__ void finish_plane(float* plane, const Layout& L, float* red, const WinStat& a,
                                             const WinStat& b, bool valid, float& cmax, float& s2n) {
    const int wy = L.wy, wx = L.wx, ld = L.ld;
    const float nf = static_cast<float>(wy * wx);
    const float denom = corr_denom(nf, a.sd, b.sd);
    float vmax = 0.f, vsum = 0.f;
    for (PixelWalk p(wx, L.nt); p.y < wy; p.next()) {
        const int e = p.y * ld + p.x;
        const float val = valid ? fmaxf(plane[e] / denom, 0.f) : 0.f;
        plane[e] = val;
        vmax = fmaxf(vmax, val);
        vsum += val;
    }
    float tot[1] = {vsum};
    block_sum<1>(tot, red);
    cmax = block_max(vmax, red);
    s2n = cmax / fmaxf(tot[0] / nf, 1e-10f);
}

}  // namespace piv

// The window sizes (wy, wx) that get a kernel of their own, the layout a
// constant in it: the sides of the main paths (geul's 16 px, ngwerere's 26 px,
// the multipass cascades 128 / 64 / 32 and 104 / 52 / 26 px, the ensemble's 64
// and 128 px, the 64 x 128 px windows). Every other size runs the kernel that
// takes the layout as a run-time value.
#define PIV_FIXED_SIZES(X, name) \
    X(name, 16, 16) X(name, 26, 26) X(name, 32, 32) X(name, 52, 52) X(name, 64, 64) X(name, 104, 104) \
    X(name, 128, 128) X(name, 64, 128)
#define PIV_PICK_KERNEL(name, WY, WX) \
    if (wy == WY && wx == WX) kernel = name<T, WY, WX>;
