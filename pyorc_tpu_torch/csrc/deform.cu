// Multipass PIV's symmetric window deformation for Hopper (sm_90a):
// frames + the previous pass's window-grid predictor -> the deformed pairs.
//
// Replaces no Pallas kernel. On the TPU the JAX package runs this stage as the
// jitted XLA program `_deform_stage` (pyorc_tpu/ops/multipass.py:181): the
// dense predictor and both bilinear samplings lower to XLA gathers that fuse.
// The port's plain version (ops/multipass.py::_deformed_pairs) runs it as
// dozens of eager PyTorch ops a block of pairs, with every intermediate (dense
// predictor fields, sample coordinates, int64 gather indices) in device
// memory. This kernel is that stage in one launch for a chunk's frames:
//
//   dr = bilinear(-v[p], rr[y], cc[x]),  dc = bilinear(u[p], rr[y], cc[x])
//   out[2 p]     = bilinear(frame[p],     y - dr * 0.5, x - dc * 0.5)
//   out[2 p + 1] = bilinear(frame[p + 1], y + dr * 0.5, x + dc * 0.5)
//
// `bilinear` is ops/interp.py::map_linear (map_coordinates(order=1,
// mode="nearest")): weights from the unclamped floor, the two indices of each
// axis clamped to the edge on their own, the four products summed in
// map_linear's order. Every operation is one IEEE float32 operation, written
// with __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts into a
// fused multiply-add; so the pairs equal the plain version's on the same card
// bit for bit. rr [H] and cc [W] (each pixel row and column in the window
// grid's index space) come from the caller, the same tensors the plain
// version reads: the kernel never recomputes them (a CUDA tensor divided by a
// Python scalar is a reciprocal multiply, other last bits than a division).
// The predictor must be finite; the median test before each pass makes it so.
//
// What bounds it is bytes: per pair pixel it writes two floats and reads
// about two frame values from device memory, against some 75 float32
// operations, far below the card's ~20 operations a byte. So the design moves
// each byte once: nothing between the predictor and the pairs goes to device
// memory; a warp writes 32 consecutive columns of a row of both outputs
// (coalesced); the frames and the predictor grid (a few KB a pair) are read
// through the read-only cache (__ldg), the four taps of a sample falling in
// two neighbouring rows; and blocks run pair-fastest (blockIdx.x is the pair),
// so the blocks that read frame p + 1 as pair p's B and as pair p + 1's A run
// close together and the second read comes from L2. Shared-memory tiles of
// the frames are later work.
//
// ops/piv_kernels.py::build_library compiles it with the other csrc/*.cu into
// one library. Entry point `deform_pairs_launch` has a plain C interface
// (loaded with ctypes); it launches on the given stream, allocates nothing and
// returns cudaGetLastError(). Offsets are 64-bit: a 4K chunk of 300 frames
// writes ~3e9 floats.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // a block: 8 warps across the columns of its rows
constexpr int kRows = 4;            // rows of a block's strip
constexpr int kMaxStrips = 65535;   // gridDim.y; a block walks strips gridDim.y apart

// map_linear at (r, c) of the h x w row-major plane `f`; kNegate reads -f.
template <bool kNegate>
__device__ __forceinline__ float bilinear(const float* __restrict__ f, int h, int w, float r, float c) {
    const float r0 = floorf(r), c0 = floorf(c);
    const float wr1 = __fsub_rn(r, r0), wc1 = __fsub_rn(c, c0);
    const float wr0 = __fsub_rn(1.f, wr1), wc0 = __fsub_rn(1.f, wc1);
    // the floor's index and the next, each clamped to the edge; the floor is
    // clamped to [-1, n - 1] first so that its conversion stays in range, which
    // changes neither clamped index
    const int ri = static_cast<int>(fminf(fmaxf(r0, -1.f), static_cast<float>(h - 1)));
    const int ci = static_cast<int>(fminf(fmaxf(c0, -1.f), static_cast<float>(w - 1)));
    const int64_t r_lo = max(ri, 0), r_hi = min(ri + 1, h - 1);
    const int c_lo = max(ci, 0), c_hi = min(ci + 1, w - 1);
    const float* lo = f + r_lo * w;
    const float* hi = f + r_hi * w;
    float f00 = __ldg(lo + c_lo), f01 = __ldg(lo + c_hi), f10 = __ldg(hi + c_lo), f11 = __ldg(hi + c_hi);
    if (kNegate) {
        f00 = -f00;
        f01 = -f01;
        f10 = -f10;
        f11 = -f11;
    }
    float out = __fmul_rn(__fmul_rn(wr0, wc0), f00);
    out = __fadd_rn(out, __fmul_rn(__fmul_rn(wr0, wc1), f01));
    out = __fadd_rn(out, __fmul_rn(__fmul_rn(wr1, wc0), f10));
    return __fadd_rn(out, __fmul_rn(__fmul_rn(wr1, wc1), f11));
}

// Block (p, s): pair p, row strips s, s + gridDim.y, ...; a thread per column, kThreads apart.
__global__ void __launch_bounds__(kThreads) deform_pairs_kernel(
    const float* __restrict__ frames, int H, int W, const float* __restrict__ u, const float* __restrict__ v,
    int nr, int nc, const float* __restrict__ rr, const float* __restrict__ cc, float* __restrict__ out) {
    const int64_t p = blockIdx.x;
    const int64_t plane = static_cast<int64_t>(H) * W;
    const float* fa = frames + p * plane;
    const float* fb = fa + plane;
    const float* up = u + p * nr * nc;
    const float* vp = v + p * nr * nc;
    float* oa = out + 2 * p * plane;
    float* ob = oa + plane;
    const int n_strips = (H + kRows - 1) / kRows;
    for (int s = blockIdx.y; s < n_strips; s += gridDim.y) {
        const int y_end = min(H, (s + 1) * kRows);
        for (int y = s * kRows; y < y_end; ++y) {
            const float ry = __ldg(rr + y), fy = static_cast<float>(y);
            for (int x = threadIdx.x; x < W; x += blockDim.x) {
                const float cx = __ldg(cc + x), fx = static_cast<float>(x);
                // half the dense predictor: dr = -v rows down, dc = u columns right
                const float hr = __fmul_rn(bilinear<true>(vp, nr, nc, ry, cx), 0.5f);
                const float hc = __fmul_rn(bilinear<false>(up, nr, nc, ry, cx), 0.5f);
                const int64_t at = static_cast<int64_t>(y) * W + x;
                oa[at] = bilinear<false>(fa, H, W, __fsub_rn(fy, hr), __fsub_rn(fx, hc));
                ob[at] = bilinear<false>(fb, H, W, __fadd_rn(fy, hr), __fadd_rn(fx, hc));
            }
        }
    }
}

}  // namespace

extern "C" int deform_pairs_launch(const void* frames, int n_pairs, int H, int W, const void* u, const void* v,
                                   int nr, int nc, const void* rr, const void* cc, void* out, void* stream) {
    const float* f = static_cast<const float*>(frames);
    const float* up = static_cast<const float*>(u);
    const float* vp = static_cast<const float*>(v);
    const float* rp = static_cast<const float*>(rr);
    const float* cp = static_cast<const float*>(cc);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_strips = (H + kRows - 1) / kRows;
    dim3 grid(n_pairs, n_strips < kMaxStrips ? n_strips : kMaxStrips);
    deform_pairs_kernel<<<grid, kThreads, 0, s>>>(f, H, W, up, vp, nr, nc, rp, cp, o);
    return static_cast<int>(cudaGetLastError());
}
