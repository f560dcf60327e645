// Face crop + bilinear resize for Hopper (sm_90a), kernel C1.
//
// Not the port of a TPU kernel: the JAX package crops in XLA
// (synergynet_tpu/pipeline/device_crop.py: crop_resize_bilinear, a four-tap
// gather; crop_resize_matmul, two products with per-roi interpolation
// matrices for the MXU). The port computed the crop as those two dense f32
// products, which spend ~2,000 times the crop's own operations building and
// multiplying matrices that hold two non-zeros a row. C1 samples the four
// bilinear taps of each output value directly from the f32 frame.
//
// What it computes (pipeline/device_crop.py, whose plain twin repeats this
// arithmetic op for op): frames (B, H, W, C) f32, rois (B, N, 4) f32
// [sx, sy, ex, ey] -> crops (B, N, S, S, C) f32. Per roi and axis: start =
// rint(s), extent = rint(e) - start, scale = extent / S, hi = max(extent -
// 1, 0); output index o samples c = min(max((o + 0.5) * scale - 0.5, 0),
// hi), taps i0 = floor(c) + start and i1 = min(floor(c) + 1, hi) + start,
// weight f = c - floor(c). A tap outside [0, size) reads 0. Each value is
// the two rows' blend at each column tap, then the two columns' blend:
// ((1 - fy) v00 + fy v10) (1 - fx) + ((1 - fy) v01 + fy v11) fx. Every
// operation is written with a round-to-nearest intrinsic, so nvcc contracts
// nothing into an FMA: the taps equal the twin's bit for bit (a contracted
// (o + 0.5) * scale - 0.5 could flip a floor at an exact boundary and move a
// sample by a whole pixel), and so do the values.
//
// What bounds it on this card: bytes. At 128 frames x 8 faces of 120 x 120
// x 3 the crops are 177 MB written once (0.053 ms at 3.35 TB/s); the taps
// read at most two source rows and two source columns per output row and
// column, 4 x 4 bytes a value from L1/L2 and each source pixel of a face
// once from device memory. The operations (four multiplies and three adds a
// value) are ~0.36 GFLOP, far below the f32 peak.
//
// Design. One block per (face, band of BAND output rows), 256 threads:
// - the block computes its face's S column taps (offsets and weights) and
//   its band's row taps once, into shared memory;
// - threads walk the band's rows as one contiguous run of BAND x S x C
//   floats, four consecutive floats each, and store them as one 16-byte
//   vector (S x C a multiple of 4: 360 at S = 120, C = 3), so a warp's
//   stores are 512 contiguous bytes;
// - the taps go through the read-only path (__ldg); neighbouring threads
//   read neighbouring source pixels of the same two rows, so a face's source
//   rows are served from L1/L2 after their first read;
// - one launch on the caller's stream, nothing allocated, no host read: a
//   CUDA graph records it as it records N1.
// crop_taps_kernel writes the taps alone, from the same function, so the
// tests can hold them against the twin's.

#include <cuda_runtime.h>

namespace {

constexpr int BAND = 8;         // output rows per block
constexpr int THREADS = 256;
constexpr int MAX_S = 512;      // largest output side (shared tap arrays)

// One axis of one roi: the two source taps of output index o (-1 when the
// tap lies outside [0, size)) and the weight of the second.
__device__ __forceinline__ void axis_tap(float start, float extent,
                                         float scale, int o, int size,
                                         int& i0, int& i1, float& f) {
    const float hi = fmaxf(__fsub_rn(extent, 1.0f), 0.0f);
    const float d = __fadd_rn(static_cast<float>(o), 0.5f);
    const float c = fminf(fmaxf(__fsub_rn(__fmul_rn(d, scale), 0.5f), 0.0f),
                          hi);
    const float c0 = floorf(c);
    f = __fsub_rn(c, c0);
    const float x0 = __fadd_rn(c0, start);
    const float x1 = __fadd_rn(fminf(__fadd_rn(c0, 1.0f), hi), start);
    const float lim = static_cast<float>(size);
    i0 = (x0 >= 0.0f && x0 < lim) ? static_cast<int>(x0) : -1;
    i1 = (x1 >= 0.0f && x1 < lim) ? static_cast<int>(x1) : -1;
}

// start, extent and scale of the roi's x (axis 0) or y (axis 1).
__device__ __forceinline__ void roi_axis(const float* roi, int axis, int s,
                                         float& start, float& extent,
                                         float& scale) {
    start = rintf(__ldg(roi + axis));
    extent = __fsub_rn(rintf(__ldg(roi + 2 + axis)), start);
    scale = __fdiv_rn(extent, static_cast<float>(s));
}

// The source value at row offset y and column offset x; 0 where either
// is -1 (outside the image).
__device__ __forceinline__ float tap(const float* p, long long y, int x) {
    return (y >= 0 && x >= 0) ? __ldg(p + y + x) : 0.0f;
}

__device__ __forceinline__ float lerp2(float g, float a, float f, float b) {
    return __fadd_rn(__fmul_rn(g, a), __fmul_rn(f, b));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) crop_bilinear_kernel(
        const float* __restrict__ frames, const float* __restrict__ rois,
        float* __restrict__ out, int n, int h, int w, int c, int s) {
    __shared__ int col0[MAX_S], col1[MAX_S];
    __shared__ float colf[MAX_S];
    __shared__ long long row0[BAND], row1[BAND];
    __shared__ float rowf[BAND];

    const int bands = (s + BAND - 1) / BAND;
    const int face = blockIdx.x / bands;
    const int r0 = (blockIdx.x - face * bands) * BAND;
    const int nr = min(BAND, s - r0);
    const float* roi = rois + 4 * static_cast<size_t>(face);
    const long long row_stride = static_cast<long long>(w) * c;

    float start, extent, scale;
    roi_axis(roi, 0, s, start, extent, scale);
    for (int o = threadIdx.x; o < s; o += THREADS) {
        int i0, i1;
        float f;
        axis_tap(start, extent, scale, o, w, i0, i1, f);
        col0[o] = i0 < 0 ? -1 : i0 * c;
        col1[o] = i1 < 0 ? -1 : i1 * c;
        colf[o] = f;
    }
    roi_axis(roi, 1, s, start, extent, scale);
    if (static_cast<int>(threadIdx.x) < nr) {
        int i0, i1;
        float f;
        axis_tap(start, extent, scale, r0 + threadIdx.x, h, i0, i1, f);
        row0[threadIdx.x] = i0 < 0 ? -1 : i0 * row_stride;
        row1[threadIdx.x] = i1 < 0 ? -1 : i1 * row_stride;
        rowf[threadIdx.x] = f;
    }
    __syncthreads();

    const float* img =
        frames + static_cast<long long>(face / n) * h * row_stride;
    const int rowlen = s * c;
    float* dst = out + (static_cast<size_t>(face) * s + r0) * rowlen;

    // Output value e of the band: row e / rowlen, column and channel from
    // the rest.
    auto value = [&](int e) -> float {
        const int r = e / rowlen;
        const int rem = e - r * rowlen;
        const int ox = rem / c;
        const int ch = rem - ox * c;
        const long long y0 = row0[r], y1 = row1[r];
        const int x0 = col0[ox], x1 = col1[ox];
        const float fy = rowf[r], fx = colf[ox];
        const float gy = __fsub_rn(1.0f, fy), gx = __fsub_rn(1.0f, fx);
        const float* p = img + ch;
        const float a = lerp2(gy, tap(p, y0, x0), fy, tap(p, y1, x0));
        const float b = lerp2(gy, tap(p, y0, x1), fy, tap(p, y1, x1));
        return lerp2(gx, a, fx, b);
    };

    const int total = nr * rowlen;
    if (VEC) {
        float4* dst4 = reinterpret_cast<float4*>(dst);
        for (int q = threadIdx.x; q < total / 4; q += THREADS) {
            const int e = 4 * q;
            dst4[q] = make_float4(value(e), value(e + 1), value(e + 2),
                                  value(e + 3));
        }
    } else {
        for (int e = threadIdx.x; e < total; e += THREADS) dst[e] = value(e);
    }
}

// The taps alone, for the tests: per face, axis (0: rows, 1: columns) and
// output index, idx[.., 2] (i0, i1; -1 outside) and f.
__global__ void crop_taps_kernel(const float* __restrict__ rois,
                                 int* __restrict__ idx,
                                 float* __restrict__ wgt, int faces, int h,
                                 int w, int s) {
    const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
    if (t >= static_cast<long long>(faces) * 2 * s) return;
    const int o = static_cast<int>(t % s);
    const int axis = static_cast<int>((t / s) % 2);
    const long long face = t / (2 * s);
    float start, extent, scale;
    roi_axis(rois + 4 * face, 1 - axis, s, start, extent, scale);
    int i0, i1;
    float f;
    axis_tap(start, extent, scale, o, axis == 0 ? h : w, i0, i1, f);
    idx[2 * t] = i0;
    idx[2 * t + 1] = i1;
    wgt[t] = f;
}

}  // namespace

// frames (faces / n frames of h x w x c f32), rois (faces x 4 f32), out
// (faces x s x s x c f32), all contiguous on the device; 1 <= s <= MAX_S.
// Returns cudaGetLastError() after the launch.
extern "C" int synergy_crop_bilinear(const void* frames, const void* rois,
                                     void* out, int faces, int n, int h,
                                     int w, int c, int s, void* stream) {
    if (faces <= 0) return 0;
    if (s < 1 || s > MAX_S || n < 1 || c < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = static_cast<long long>(faces) *
                             ((s + BAND - 1) / BAND);
    if (blocks > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidConfiguration);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* f = static_cast<const float*>(frames);
    const float* r = static_cast<const float*>(rois);
    float* o = static_cast<float*>(out);
    if ((s * c) % 4 == 0)
        crop_bilinear_kernel<true><<<static_cast<unsigned>(blocks), THREADS, 0,
                                      st>>>(f, r, o, n, h, w, c, s);
    else
        crop_bilinear_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0,
                                       st>>>(f, r, o, n, h, w, c, s);
    return static_cast<int>(cudaGetLastError());
}

// rois (faces x 4 f32) -> idx (faces x 2 x s x 2 int32), wgt (faces x 2 x s
// f32): the taps C1 samples, axis 0 the rows, axis 1 the columns.
extern "C" int synergy_crop_taps(const void* rois, void* idx, void* wgt,
                                 int faces, int h, int w, int s,
                                 void* stream) {
    const long long total = static_cast<long long>(faces) * 2 * s;
    if (total <= 0) return 0;
    crop_taps_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rois), static_cast<int*>(idx),
        static_cast<float*>(wgt), faces, h, w, s);
    return static_cast<int>(cudaGetLastError());
}
