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
// map_linear's rounding orders, as XLA's CPU build compiles `_deform_stage`:
// the predictor's sums as chain A, fma(w00, t00, w01 t01) -> fma(w10, t10, .)
// -> fma(w11, t11, .), the frame samples' as chain B, fma(w01, t01, w00 t00)
// -> the same two. Every operation is written with __fmul_rn / __fadd_rn /
// __fsub_rn / __fmaf_rn, which nvcc neither contracts nor splits; so the pairs
// equal the plain version's on the same card bit for bit, and both equal JAX's.
// rr [H] and cc [W] (each pixel row and column in the window grid's index
// space, multiplied by the step's float32 reciprocal as XLA's CPU build
// rewrites JAX's division) come from the caller, the same tensors the plain
// version reads: the kernel never recomputes them.
//
// What bounds it. The work must move ~12 bytes a pair pixel (two floats
// written, about one frame value read), against ~62 float32 instructions (12
// of them fused multiply-adds) in the orders above. A first design (a thread a
// pixel, every tap through the read-only cache, every bilinear sample
// recomputed from its coordinates) issued ~220 instructions a pair pixel and
// ran at ~41 % of the bytes bound: issue and load latency held it, not bytes.
// This design takes out of the pair loop what no pair changes, and reads each
// frame from device memory once for a run of pairs, which leaves ~85
// instructions a pair pixel (97 before the sums were fused) and makes bytes
// the bound again: the frames it reads again for the halos
// and the runs' shared ends (~1.44x the frames, ~1.15x the bound's bytes in
// all) at close to the card's sustained memory rate.
//
// - A block owns a tile of kTileRows x kTileCols pixels and walks a run of
//   kRun consecutive pairs (grid: tiles x runs, ~11 waves of three blocks an
//   SM at 1080p; shorter runs than the frames would allow measured faster:
//   more blocks in flight). A pair's bits depend on its own frames and
//   predictor only, so runs change no bits.
// - Each frame of the run is staged once in shared memory, in a ring of three
//   (frames p and p + 1 in use while p + 2 loads with cp.async: 16 B where a
//   row is 16-byte aligned, 4 B otherwise), so frame p + 1 serves as pair p's
//   B and pair p + 1's A from one read of device memory. A frame is staged
//   through clamped coordinates, staged(r, c) = frame[clamp(r, 0, H - 1),
//   clamp(c, 0, W - 1)], over the tile and a kHalo-pixel halo: every tap in
//   that region reads what map_linear's edge rule reads, so no sample clamps
//   and edge tiles run the code of interior ones.
// - The pair's predictor cells over the tile are staged with the frame (again
//   through clamped indices, so a cell's right and lower neighbours sit one
//   column and one row further) and checked: where a staged cell's |u| or |v|
//   reaches 2 kHalo - 0.01, a half-displacement could take a tap past the
//   halo, and that (tile, pair) runs the first design's path through device
//   memory (same operations, same bits). Each such (tile, pair) adds one to
//   the wrapper's counter, which only the checks read.
// - The predictor's row terms (floor, weights, cell row) sit in shared memory,
//   made once a tile and read as a broadcast; its column terms stay in
//   registers for the block's life. A thread owns a column and walks rows, a
//   warp 32 consecutive columns of a row: coalesced stores and staged reads on
//   distinct banks. A staged tap's index comes from the floor's float bits
//   (floor + 1.5 * 2^23, exact for |floor| < 2^22) instead of a conversion.
// - Offsets are 32-bit within a plane, plane bases 64-bit: a 4K chunk of 300
//   frames writes ~3e9 floats.
//
// ops/piv_kernels.py::build_library compiles it with the other csrc/*.cu into
// one library. Entry point `deform_pairs_launch` has a plain C interface
// (loaded with ctypes); it launches on the given stream, allocates nothing and
// returns the CUDA error; `deform_pairs_geometry` reports the tile, halo, run
// and occupancy.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                            // a block: 8 warps, a thread a column of the tile
constexpr int kTileRows = 32, kTileCols = 128;           // pixels of a block's tile
constexpr int kHalo = 4;                                 // staged pixels around the tile on each side
constexpr int kRun = 12;                                 // consecutive pairs a block walks
constexpr int kStageRows = kTileRows + 2 * kHalo;
constexpr int kPitch = kTileCols + 2 * kHalo;            // floats of a staged row (16-byte multiple)
constexpr int kStage = kStageRows * kPitch;              // floats of a staged frame
constexpr int kRowStep = kThreads / kTileCols;           // rows between a thread's pixels
constexpr int kCellPitch = 40;                           // (u, v) cells of a staged predictor row
constexpr int kCellCap = 512;                            // (u, v) cells of a staged predictor
constexpr int kCellsPerThread = (kCellCap + kThreads - 1) / kThreads;
constexpr float kFastCell = 2.f * kHalo - 0.01f;         // a cell below this in |u| and |v| keeps taps in the halo
constexpr float kMagic = 12582912.f;                     // 1.5 * 2^23: floor + kMagic holds the floor in its low bits
constexpr unsigned kMagicBits = 0x4B400000u;
// shared memory (floats): the frame ring, two predictor buffers (u, v interleaved), the row terms
// (wr0, wr1, y, cell offset), the tile's cell rows and cell columns
constexpr int kCellsAt = 3 * kStage, kRowsAt = kCellsAt + 2 * 2 * kCellCap, kLoAt = kRowsAt + 4 * kTileRows;
constexpr int kSmemFloats = kLoAt + kTileRows + kTileCols;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
// the largest plane side whose coordinates round by less than the check's 0.005 px margin
constexpr int kMaxFastSide = 32768;

// map_linear at (r, c) of the h x w row-major plane `f` in device memory.
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
    float out = __fmaf_rn(__fmul_rn(wr0, wc1), __ldg(lo + c_hi), __fmul_rn(__fmul_rn(wr0, wc0), __ldg(lo + c_lo)));
    out = __fmaf_rn(__fmul_rn(wr1, wc0), __ldg(hi + c_lo), out);
    return __fmaf_rn(__fmul_rn(wr1, wc1), __ldg(hi + c_hi), out);
}

// map_linear at (r, c) of a frame staged at `s` + (the staged index): `at0` is the staged index of
// (0, 0) in the floor's bit space less the frame's offset from `s`, so the tap's index is its two
// floors' bits alone. The taps lie in the staged region.
__device__ __forceinline__ float staged_bilinear(const float* __restrict__ s, unsigned at0, float r, float c) {
    const float r0 = floorf(r), c0 = floorf(c);
    const float wr1 = __fsub_rn(r, r0), wc1 = __fsub_rn(c, c0);
    const float wr0 = __fsub_rn(1.f, wr1), wc0 = __fsub_rn(1.f, wc1);
    const unsigned at = __float_as_uint(__fadd_rn(r0, kMagic)) * kPitch + __float_as_uint(__fadd_rn(c0, kMagic)) - at0;
    const float* t = s + at;
    float out = __fmaf_rn(__fmul_rn(wr0, wc1), t[1], __fmul_rn(__fmul_rn(wr0, wc0), t[0]));
    out = __fmaf_rn(__fmul_rn(wr1, wc0), t[kPitch], out);
    return __fmaf_rn(__fmul_rn(wr1, wc1), t[kPitch + 1], out);
}

// bilinear's terms of one axis of the predictor grid (n cells) at r: the two weights and the floor's
// index clamped to [-1, n - 1], whose cells are max(i, 0) and min(i + 1, n - 1)
struct Terms {
    float w0, w1;
    int i;
};

__device__ __forceinline__ Terms grid_terms(float r, int n) {
    const float r0 = floorf(r);
    const float w1 = __fsub_rn(r, r0);
    return {__fsub_rn(1.f, w1), w1, static_cast<int>(fminf(fmaxf(r0, -1.f), static_cast<float>(n - 1)))};
}

// Stage frame `f` (h x w) over the tile whose staged origin is (r0, c0) into `s`, through clamped coordinates.
__device__ __forceinline__ void stage_frame(float* s, const float* __restrict__ f, int h, int w, int r0, int c0,
                                            bool vec) {
    constexpr int kChunks = kPitch / 4;
    for (int k = threadIdx.x; k < kStageRows * kChunks; k += kThreads) {
        const int sr = k / kChunks, q = k - sr * kChunks;
        const float* row = f + min(max(r0 + sr, 0), h - 1) * w;
        const int c = c0 + 4 * q;
        float* dst = s + sr * kPitch + 4 * q;
        if (vec && c >= 0 && c + 3 < w) {
            __pipeline_memcpy_async(dst, row + c, 16);
        } else {
            for (int e = 0; e < 4; ++e) __pipeline_memcpy_async(dst + e, row + min(max(c + e, 0), w - 1), 4);
        }
    }
}

// Block (tile, run): the tile's pixels of pairs kRun * blockIdx.y ... of `frames` [n_pairs + 1, H, W].
__global__ void __launch_bounds__(kThreads, 3) deform_pairs_kernel(
    const float* __restrict__ frames, int n_pairs, int H, int W, const float* __restrict__ u,
    const float* __restrict__ v, int nr, int nc, const float* __restrict__ rr, const float* __restrict__ cc,
    float* __restrict__ out, unsigned long long* __restrict__ misses) {
    extern __shared__ __align__(16) float smem[];
    float* ring = smem;
    float* rows = smem + kRowsAt;  // per tile row: wr0, wr1, y, offset of its cell row in the staged cells
    int* cell_i = reinterpret_cast<int*>(smem + kLoAt);  // per tile row, then per tile column: Terms::i
    const int tiles_x = (W + kTileCols - 1) / kTileCols;
    const int rbase = (blockIdx.x / tiles_x) * kTileRows, cbase = (blockIdx.x % tiles_x) * kTileCols;
    const int p0 = blockIdx.y * kRun, n = min(kRun, n_pairs - p0);
    const int64_t plane = static_cast<int64_t>(H) * W;
    const int tx = threadIdx.x % kTileCols, x = cbase + tx;

    // the predictor's terms: rows in shared memory, this thread's column in registers
    if (threadIdx.x < kTileRows) {
        const int y = min(rbase + static_cast<int>(threadIdx.x), H - 1);
        const Terms t = grid_terms(__ldg(rr + y), nr);
        rows[4 * threadIdx.x] = t.w0;
        rows[4 * threadIdx.x + 1] = t.w1;
        rows[4 * threadIdx.x + 2] = static_cast<float>(rbase + static_cast<int>(threadIdx.x));
        cell_i[threadIdx.x] = t.i;
    }
    const Terms col = grid_terms(__ldg(cc + min(x, W - 1)), nc);
    if (threadIdx.x < kTileCols) cell_i[kTileRows + threadIdx.x] = col.i;
    __syncthreads();
    // the staged cells: grid rows clamp(r_first ... r_last + 1), columns clamp(c_first ... c_last + 1),
    // so that a pixel's cells max(i, 0) and min(i + 1, n - 1) are staged (i - first) and the one after
    int r_first = nr, r_last = -1, c_first = nc, c_last = -1;
    for (int k = 0; k < kTileRows; ++k) {
        r_first = min(r_first, cell_i[k]);
        r_last = max(r_last, cell_i[k]);
    }
    for (int k = 0; k < kTileCols; ++k) {
        c_first = min(c_first, cell_i[kTileRows + k]);
        c_last = max(c_last, cell_i[kTileRows + k]);
    }
    const int n_cell_rows = r_last - r_first + 2, n_cell_cols = c_last - c_first + 2;
    const bool fits = n_cell_rows * kCellPitch <= kCellCap && n_cell_cols <= kCellPitch && H <= kMaxFastSide &&
                      W <= kMaxFastSide;
    if (threadIdx.x < kTileRows) {
        rows[4 * threadIdx.x + 3] = __int_as_float((cell_i[threadIdx.x] - r_first) * kCellPitch);
    }
    const int c_off = col.i - c_first;
    const int sr0 = rbase - kHalo, sc0 = cbase - kHalo;  // the staged region's origin in the frame
    const unsigned at0 = (kMagicBits + static_cast<unsigned>(sr0)) * kPitch + kMagicBits + static_cast<unsigned>(sc0);
    const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(frames) % 16 == 0;
    const float fx = static_cast<float>(x);

    // this thread's staged cells: where each lies in the grid, and in a staged predictor (-1: none)
    int cell_at[kCellsPerThread], cell_to[kCellsPerThread];
    for (int m = 0; m < kCellsPerThread; ++m) {
        const int k = threadIdx.x + m * kThreads, j = k / n_cell_cols, i = k - j * n_cell_cols;
        const bool mine = fits && k < n_cell_rows * n_cell_cols;
        cell_at[m] = mine ? min(max(r_first + j, 0), nr - 1) * nc + min(max(c_first + i, 0), nc - 1) : 0;
        cell_to[m] = mine ? 2 * (j * kCellPitch + i) : -1;
    }
    auto stage_cells = [&](int64_t p, float* dst) {
        for (int m = 0; m < kCellsPerThread; ++m) {
            if (cell_to[m] >= 0) {
                __pipeline_memcpy_async(dst + cell_to[m], u + p * nr * nc + cell_at[m], 4);
                __pipeline_memcpy_async(dst + cell_to[m] + 1, v + p * nr * nc + cell_at[m], 4);
            }
        }
    };
    // a staged cell (this thread's) that could take a tap past the halo; NaN counts as one
    auto cells_past_halo = [&](const float* cells) {
        bool past = false;
        for (int m = 0; m < kCellsPerThread; ++m) {
            if (cell_to[m] >= 0) {
                past |= !(fabsf(cells[cell_to[m]]) < kFastCell) || !(fabsf(cells[cell_to[m] + 1]) < kFastCell);
            }
        }
        return past;
    };
    const int ty0 = threadIdx.x / kTileCols, ty_end = min(kTileRows, H - rbase);  // this thread's rows

    if (fits) {
        stage_frame(ring, frames + p0 * plane, H, W, sr0, sc0, vec);
        __pipeline_commit();
        stage_frame(ring + kStage, frames + (p0 + 1) * plane, H, W, sr0, sc0, vec);
        stage_cells(p0, smem + kCellsAt);
    }
    __pipeline_commit();
    for (int i = 0; i < n; ++i) {
        const int64_t p = p0 + i;
        float* cells = smem + kCellsAt + 2 * kCellCap * (i & 1);
        if (fits) {
            if (i + 2 <= n) stage_frame(ring + kStage * ((i + 2) % 3), frames + (p + 2) * plane, H, W, sr0, sc0, vec);
            if (i + 1 < n) stage_cells(p + 1, smem + kCellsAt + 2 * kCellCap * ((i + 1) & 1));
        }
        __pipeline_commit();
        __pipeline_wait_prior(1);  // frames p and p + 1 and pair p's cells have landed
        const bool past = __syncthreads_or(!fits || cells_past_halo(cells));
        float* oa = out + 2 * p * plane + (rbase + ty0) * W + x;  // this thread's first pixel of the pair
        float* ob = oa + plane;
        if (!past && x < W) {
            const unsigned at_a = at0 - kStage * (i % 3), at_b = at0 - kStage * ((i + 1) % 3);
            for (int ty = ty0; ty < ty_end; ty += kRowStep, oa += kRowStep * W, ob += kRowStep * W) {
                const float4 rt = reinterpret_cast<const float4*>(rows)[ty];  // wr0, wr1, y, cell offset
                const float w00 = __fmul_rn(rt.x, col.w0), w01 = __fmul_rn(rt.x, col.w1);
                const float w10 = __fmul_rn(rt.y, col.w0), w11 = __fmul_rn(rt.y, col.w1);
                // (u, v) of the four cells
                const float2* t = reinterpret_cast<const float2*>(cells) + __float_as_int(rt.w) + c_off;
                const float2 t00 = t[0], t01 = t[1], t10 = t[kCellPitch], t11 = t[kCellPitch + 1];
                const float fy = rt.z;
                // half the dense predictor: dr = -v rows down, dc = u columns right
                float hr = __fmaf_rn(w00, -t00.y, __fmul_rn(w01, -t01.y));
                hr = __fmaf_rn(w10, -t10.y, hr);
                hr = __fmul_rn(__fmaf_rn(w11, -t11.y, hr), 0.5f);
                float hc = __fmaf_rn(w00, t00.x, __fmul_rn(w01, t01.x));
                hc = __fmaf_rn(w10, t10.x, hc);
                hc = __fmul_rn(__fmaf_rn(w11, t11.x, hc), 0.5f);
                *oa = staged_bilinear(ring, at_a, __fsub_rn(fy, hr), __fsub_rn(fx, hc));
                *ob = staged_bilinear(ring, at_b, __fadd_rn(fy, hr), __fadd_rn(fx, hc));
            }
        } else if (x < W) {
            // the first design's path: every tap from device memory, clamped
            const float* fa = frames + p * plane;
            const float* up = u + p * nr * nc;
            const float* vp = v + p * nr * nc;
            const int c_lo = max(col.i, 0), c_hi = min(col.i + 1, nc - 1);
            for (int ty = ty0; ty < ty_end; ty += kRowStep, oa += kRowStep * W, ob += kRowStep * W) {
                const float* rt = rows + 4 * ty;
                const float wr0 = rt[0], wr1 = rt[1], fy = rt[2];
                const float w00 = __fmul_rn(wr0, col.w0), w01 = __fmul_rn(wr0, col.w1);
                const float w10 = __fmul_rn(wr1, col.w0), w11 = __fmul_rn(wr1, col.w1);
                const int lo = max(cell_i[ty], 0) * nc, hi = min(cell_i[ty] + 1, nr - 1) * nc;
                float hr = __fmaf_rn(w00, -__ldg(vp + lo + c_lo), __fmul_rn(w01, -__ldg(vp + lo + c_hi)));
                hr = __fmaf_rn(w10, -__ldg(vp + hi + c_lo), hr);
                hr = __fmul_rn(__fmaf_rn(w11, -__ldg(vp + hi + c_hi), hr), 0.5f);
                float hc = __fmaf_rn(w00, __ldg(up + lo + c_lo), __fmul_rn(w01, __ldg(up + lo + c_hi)));
                hc = __fmaf_rn(w10, __ldg(up + hi + c_lo), hc);
                hc = __fmul_rn(__fmaf_rn(w11, __ldg(up + hi + c_hi), hc), 0.5f);
                *oa = bilinear(fa, H, W, __fsub_rn(fy, hr), __fsub_rn(fx, hc));
                *ob = bilinear(fa + plane, H, W, __fadd_rn(fy, hr), __fadd_rn(fx, hc));
            }
        }
        if (past && threadIdx.x == 0) atomicAdd(misses, 1ull);
        __syncthreads();  // the ring slot of frame p and these cells are staged again next
    }
}

// Shared memory beyond 48 KB, and the carveout that lets three blocks share an SM.
cudaError_t set_attributes() {
    cudaError_t err = cudaFuncSetAttribute(deform_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(deform_pairs_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" int deform_pairs_launch(const void* frames, int n_pairs, int H, int W, const void* u, const void* v,
                                   int nr, int nc, const void* rr, const void* cc, void* out, void* misses,
                                   void* stream) {
    const cudaError_t err = set_attributes();
    if (err != cudaSuccess) return static_cast<int>(err);
    const float* f = static_cast<const float*>(frames);
    const float* up = static_cast<const float*>(u);
    const float* vp = static_cast<const float*>(v);
    const float* rp = static_cast<const float*>(rr);
    const float* cp = static_cast<const float*>(cc);
    float* o = static_cast<float*>(out);
    auto* m = static_cast<unsigned long long*>(misses);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int tiles = ((H + kTileRows - 1) / kTileRows) * ((W + kTileCols - 1) / kTileCols);
    dim3 grid(tiles, (n_pairs + kRun - 1) / kRun);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);  // over ~786k pairs a launch
    deform_pairs_kernel<<<grid, kThreads, kSmemBytes, s>>>(f, n_pairs, H, W, up, vp, nr, nc, rp, cp, o, m);
    return static_cast<int>(cudaGetLastError());
}

// out[7]: tile rows, tile columns, halo, run, threads, dynamic shared memory bytes, resident blocks per SM.
extern "C" int deform_pairs_geometry(int* out) {
    cudaError_t err = set_attributes();
    int blocks = 0;
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, deform_pairs_kernel, kThreads, kSmemBytes);
    }
    const int geometry[7] = {kTileRows, kTileCols, kHalo, kRun, kThreads, static_cast<int>(kSmemBytes), blocks};
    for (int i = 0; i < 7; ++i) out[i] = geometry[i];
    return static_cast<int>(err);
}
