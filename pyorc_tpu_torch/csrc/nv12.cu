// 4:2:0 YUV (NVDEC's NV12, or libavcodec's planar I420) -> the native pump's gray or RGB frames.
//
// Replaces no Pallas kernel: it replaces the host conversion of the JAX
// package's decode pump, native/decoder.cpp:83-91 and :250-272 (swscale's
// YUV420P -> BGR24 at the same size, then OpenCV's fixed-point BGR2GRAY, or
// the channel swap to RGB), so that frames decoded on the card (NVDEC), or
// uploaded as YUV (1.5 B a pixel), become the pixels cv2.VideoCapture gives,
// bit for bit, without leaving the card.
//
// The arithmetic is swscale's unscaled converter as its x86 SIMD code runs it
// (libswscale/x86/yuv_2_rgb.asm with the coefficients of
// ff_yuv2rgb_c_init_tables: BT.601, limited range, the defaults, since OpenCV
// sets no colorspace details), held to libswscale 6.7, 9.1 and 9.5 on every
// (Y, U, V) triple and on random planes, odd widths among them: each chroma
// sample serves its 2x2 block of luma, and in 16-bit fixed point
//     y' = ((Y << 3) - 128) * 9539 >> 16,  u' = (U << 3) - 1024,  v' = (V << 3) - 1024
//     B = sat(y' + (u' * 16525 >> 16))
//     G = sat(y' + (u' * -3209 >> 16) + (v' * -6660 >> 16))
//     R = sat(y' + (v' * 13075 >> 16))
// (>> an arithmetic shift, as pmulhw's high half; no 16-bit sum saturates on
// 8-bit inputs), then OpenCV's BGR2GRAY of those pixels, in its 15-bit fixed
// point since OpenCV 4 (held to OpenCV 4.13 and 5.0):
//     gray = (B * 3735 + G * 19235 + R * 9798 + 16384) >> 15.
// (native/decoder.cpp:83-91 keeps OpenCV 3's 14-bit weights, 1868 / 9617 /
// 4899: equal on gray video, where B = G = R, and one level off on about 0.3 %
// of colored pixels; the port follows OpenCV, whose frames both packages' other
// decode route gives.)
//
// A thread converts a strip of 16 luma columns by 2 rows and the 8 chroma
// samples the strip shares. On the 16-byte path it loads each luma row as one
// 16-byte vector and the chroma as 8 B of U and 8 B of V (I420) or 16 B of
// interleaved UV (NV12), computes each chroma sample's three terms once for
// its 4 pixels, works on the two pixels of a row that share a chroma sample
// as the two 16-bit halves of a word (one DPX add-min-relu clamps a channel of
// both; gray's weighted sum is two 16-by-8-bit dot products a pixel), packs
// the output bytes in registers (prmt) and stores each row as one 16-byte
// vector (gray) or three (RGB, 48 B). The host takes that path when every row
// of the planes and of the output starts on its vector's boundary
// (yuv420_convert_path); any other layout takes the scalar path of the same
// kernel, byte loads and stores around the same arithmetic, as does the last
// strip of a row whose width is not a multiple of 16. The block is 1-D: a power
// of two of its threads along a row's strips, the rest along the rows, so a
// thread finds its strip by shifts and masks; each frame sits on grid.y. What
// bounds it on the H100 is device memory: it reads 1.5 B and writes 1 or 3 B a
// pixel, 1.55 us a 1080p gray frame at 3.35 TB/s; its integer instructions take
// 40 % (gray) and 18 % (RGB) of that time at the SM's issue rate
// (ops/roofline.py, yuv420_bound).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLogThreads = 8;
constexpr int kThreads = 1 << kLogThreads;
constexpr int kStrip = 16;  // luma columns a thread converts on each of its two rows

// byte k of w, zero-extended
__device__ __forceinline__ int byte_of(uint32_t w, int k) { return (int)__byte_perm(w, 0u, 0x4440u | k); }

// swscale's luma term with its offset folded in, exact in int32: ((Y << 3) - 128) * 9539 = 76312 Y -
// 1220992; the term y' is its high half
__device__ __forceinline__ int luma_term(int y) { return y * 76312 - 1220992; }

// one byte of each of a, b, c, d packed into a word, picked by sel: 0x0062 takes each value's byte 2
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d, uint32_t sel) {
    return __byte_perm(__byte_perm(a, b, sel), __byte_perm(c, d, sel), 0x5410u);
}

// One row of a strip, its pixels in pairs that share a chroma sample: the 16 luma bytes ly and the
// strip's chroma terms, each as two equal s16 halves (ub, uvg, vr) -> o, 4 words of gray or 12 of
// R G B R G B ... (48 bytes). A pair's y' terms share a word as s16 halves, so one add-min-relu of
// two halves (Hopper's DPX) clamps a channel of both pixels.
template <bool kGray>
__device__ __forceinline__ void convert_row(const uint32_t (&ly)[4], const uint32_t (&ub)[8],
                                            const uint32_t (&uvg)[8], const uint32_t (&vr)[8],
                                            uint32_t (&o)[kGray ? 4 : 12]) {
    uint32_t b[8], g[8], r[8];  // pair j's channels, pixel 2j in the low half, 2j + 1 in the high
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int t0 = luma_term(byte_of(ly[j >> 1], 2 * (j & 1))), t1 = luma_term(byte_of(ly[j >> 1], 2 * (j & 1) + 1));
        const uint32_t yy = __byte_perm((uint32_t)t0, (uint32_t)t1, 0x7632u);  // (t0 >> 16, t1 >> 16)
        b[j] = __viaddmin_s16x2_relu(yy, ub[j], 0x00ff00ffu);
        g[j] = __viaddmin_s16x2_relu(yy, uvg[j], 0x00ff00ffu);
        r[j] = __viaddmin_s16x2_relu(yy, vr[j], 0x00ff00ffu);
    }
    if (kGray) {
        // OpenCV's (B 3735 + G 19235 + R 9798 + 16384) >> 15 doubled, as two 16-by-8-bit dot products
        // (B and G, then R with the rounding term): the gray level is byte 2 of the sum
        constexpr uint32_t kBG = 7470u | 38470u << 16, kR = 19596u;
        uint32_t s[16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const uint32_t bg = __byte_perm(b[j], g[j], 0x6240u);  // B0 G0 B1 G1
            s[2 * j] = __dp2a_lo(kBG, bg, __dp2a_lo(kR, r[j], 32768u));
            s[2 * j + 1] = __dp2a_hi(kBG, bg, __dp2a_hi(kR, r[j], 32768u));
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) o[q] = pack4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3], 0x0062u);
    } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // pixels 4q .. 4q + 3, pairs 2q and 2q + 1 -> 12 bytes
            const uint32_t rg0 = __byte_perm(r[2 * q], g[2 * q], 0x6240u);  // R0 G0 R1 G1
            const uint32_t rg1 = __byte_perm(r[2 * q + 1], g[2 * q + 1], 0x6240u);  // R2 G2 R3 G3
            o[3 * q] = __byte_perm(rg0, b[2 * q], 0x2410u);  // R0 G0 B0 R1
            o[3 * q + 1] = __byte_perm(__byte_perm(rg0, b[2 * q], 0x0063u), rg1, 0x5410u);  // G1 B1 R2 G2
            o[3 * q + 2] = __byte_perm(b[2 * q + 1], rg1, 0x2760u);  // B2 R3 G3 B3
        }
    }
}

// The strip at luma column x0 of row pair r (rows 2r, 2r + 1) of frame f, on the 16-byte path (vec)
// or the scalar one.
template <bool kGray>
__device__ __forceinline__ void convert_strip(const uint8_t* __restrict__ y, int64_t y_frame, int y_pitch,
                                              const uint8_t* __restrict__ u, const uint8_t* __restrict__ v,
                                              int64_t c_frame, int c_pitch, int c_step, int h, int w,
                                              uint8_t* __restrict__ out, bool vec, int64_t f, int r, int x0) {
    constexpr int kWords = kGray ? 4 : 12, kCh = kGray ? 1 : 3;
    const uint8_t* yp = y + f * y_frame + (int64_t)(2 * r) * y_pitch + x0;
    const int64_t c = f * c_frame + (int64_t)r * c_pitch + (int64_t)(x0 >> 1) * c_step;
    uint8_t* op = out + ((f * h + 2 * r) * (int64_t)w + x0) * kCh;
    uint32_t ly[2][4] = {}, cu[2] = {}, cv[2] = {};
    const int nx = min(kStrip, w - x0);  // the strip's pixels in each row: 16, or the row's even rest
    if (vec) {
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
            const uint4 l = __ldg(reinterpret_cast<const uint4*>(yp + (int64_t)dy * y_pitch));
            ly[dy][0] = l.x, ly[dy][1] = l.y, ly[dy][2] = l.z, ly[dy][3] = l.w;
        }
        if (c_step == 1) {
            const uint2 a = __ldg(reinterpret_cast<const uint2*>(u + c));
            const uint2 b = __ldg(reinterpret_cast<const uint2*>(v + c));
            cu[0] = a.x, cu[1] = a.y, cv[0] = b.x, cv[1] = b.y;
        } else {  // NV12: U V U V ..., v = u + 1
            const uint4 q = __ldg(reinterpret_cast<const uint4*>(u + c));
            cu[0] = __byte_perm(q.x, q.y, 0x6420u), cv[0] = __byte_perm(q.x, q.y, 0x7531u);
            cu[1] = __byte_perm(q.z, q.w, 0x6420u), cv[1] = __byte_perm(q.z, q.w, 0x7531u);
        }
    } else {
#pragma unroll
        for (int k = 0; k < kStrip; ++k)
            if (k < nx)
#pragma unroll
                for (int dy = 0; dy < 2; ++dy)
                    ly[dy][k >> 2] |= (uint32_t)yp[(int64_t)dy * y_pitch + k] << 8 * (k & 3);
#pragma unroll
        for (int j = 0; j < kStrip / 2; ++j)
            if (2 * j < nx) {
                cu[j >> 2] |= (uint32_t)u[c + (int64_t)j * c_step] << 8 * (j & 3);
                cv[j >> 2] |= (uint32_t)v[c + (int64_t)j * c_step] << 8 * (j & 3);
            }
    }
    uint32_t ub[8], uvg[8], vr[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // each chroma sample's terms, once for its 2x2 pixels, as two s16 halves
        const int cu_j = byte_of(cu[j >> 2], j & 3), cv_j = byte_of(cv[j >> 2], j & 3);
        const int tu = cu_j * 132200 - 16921600, tv = cv_j * 104600 - 13388800;  // u' k, v' k: the terms
        const int tg = ((cu_j * -25672 + 3286016) >> 16) + ((cv_j * -53280 + 6819840) >> 16);
        ub[j] = __byte_perm((uint32_t)tu, (uint32_t)tu, 0x3232u);  // are their high halves
        vr[j] = __byte_perm((uint32_t)tv, (uint32_t)tv, 0x3232u);
        uvg[j] = __byte_perm((uint32_t)tg, (uint32_t)tg, 0x1010u);
    }
    uint32_t o[2][kWords];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) convert_row<kGray>(ly[dy], ub, uvg, vr, o[dy]);
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
        uint8_t* row = op + dy * (int64_t)w * kCh;
        if (vec) {
#pragma unroll
            for (int q = 0; q < kWords; q += 4)
                __stwb(reinterpret_cast<uint4*>(row + 4 * q),
                       make_uint4(o[dy][q], o[dy][q + 1], o[dy][q + 2], o[dy][q + 3]));
        } else {
#pragma unroll
            for (int i = 0; i < kStrip * kCh; ++i)
                if (i < nx * kCh) row[i] = (uint8_t)(o[dy][i >> 2] >> 8 * (i & 3));
        }
    }
}

// frames [n] of h x w (h, w even): luma at y + f * y_frame + row * y_pitch, chroma sample (row, col)
// at u / v + f * c_frame + row * c_pitch + col * c_step (c_step 2 for NV12's interleaved pairs,
// v = u + 1; 1 for planar I420); out is [n, h, w] gray or [n, h, w, 3] RGB, contiguous. A block holds
// 1 << lx threads along a row's strips (gx blocks span a row) by kThreads >> lx row pairs. Gray and RGB
// are two instances with registers of their own: gray held to 5 blocks an SM, RGB left as the compiler
// has it (fewer blocks, and faster on an H100: PERF.md).
template <bool kGray>
__global__ void __launch_bounds__(kThreads, kGray ? 5 : 1) yuv420_to_frames_kernel(
    const uint8_t* __restrict__ y, int64_t y_frame, int y_pitch, const uint8_t* __restrict__ u,
    const uint8_t* __restrict__ v, int64_t c_frame, int c_pitch, int c_step, int h, int w,
    uint8_t* __restrict__ out, int vec, int lx, int gx) {
    const int by = blockIdx.x / gx;  // the block's one division, uniform
    const int x0 = (((blockIdx.x - by * gx) << lx) + (threadIdx.x & ((1 << lx) - 1))) * kStrip;
    const int r = (by << (kLogThreads - lx)) + (threadIdx.x >> lx);
    if (x0 >= w || r >= h >> 1) return;
    convert_strip<kGray>(y, y_frame, y_pitch, u, v, c_frame, c_pitch, c_step, h, w, out, vec, blockIdx.y, r, x0);
}

bool aligned(const void* p, int64_t a) { return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0; }
bool multiple(int64_t x, int64_t a) { return (x & (a - 1)) == 0; }

}  // namespace

// 1 (the 16-byte path) when every strip's loads and stores fall on their vectors' boundaries: the width a
// multiple of 16, luma and output 16-B aligned with row pitches and frame strides that keep them so, the
// chroma 8-B aligned likewise (I420) or 16-B aligned with v = u + 1 (NV12); else 0 (the scalar path)
extern "C" int yuv420_convert_path(const uint8_t* y, int64_t y_frame, int y_pitch, const uint8_t* u,
                                   const uint8_t* v, int64_t c_frame, int c_pitch, int c_step, int w,
                                   const uint8_t* out) {
    const bool luma = multiple(w, kStrip) && aligned(y, 16) && multiple(y_pitch, 16) && multiple(y_frame, 16) &&
                      aligned(out, 16);
    const bool chroma = c_step == 1   ? aligned(u, 8) && aligned(v, 8) && multiple(c_pitch, 8) && multiple(c_frame, 8)
                        : c_step == 2 ? v == u + 1 && aligned(u, 16) && multiple(c_pitch, 16) && multiple(c_frame, 16)
                                      : false;
    return luma && chroma ? 1 : 0;
}

extern "C" int yuv420_convert_launch(const uint8_t* y, int64_t y_frame, int y_pitch, const uint8_t* u,
                                     const uint8_t* v, int64_t c_frame, int c_pitch, int c_step, int n, int h,
                                     int w, uint8_t* out, int gray, void* stream) {
    // odd sizes, an empty or too long batch (grid.y), an odd output address: refused before any launch
    if (n <= 0 || h <= 0 || w <= 0 || (h | w) & 1 || n > 65535 || reinterpret_cast<uintptr_t>(out) & 1)
        return static_cast<int>(cudaErrorInvalidConfiguration);
    const int vec = yuv420_convert_path(y, y_frame, y_pitch, u, v, c_frame, c_pitch, c_step, w, out);
    const int strips = (w + kStrip - 1) / kStrip;
    int lx = 0;  // log2 of a block's threads along a row: the least power of two covering its strips, at most all
    while ((1 << lx) < strips && lx < kLogThreads) ++lx;
    const int gx = (strips + (1 << lx) - 1) >> lx, rows = kThreads >> lx;
    const dim3 grid(gx * ((h / 2 + rows - 1) / rows), n);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto kernel = gray ? yuv420_to_frames_kernel<true> : yuv420_to_frames_kernel<false>;
    kernel<<<grid, kThreads, 0, s>>>(y, y_frame, y_pitch, u, v, c_frame, c_pitch, c_step, h, w, out, vec, lx, gx);
    return static_cast<int>(cudaGetLastError());
}
