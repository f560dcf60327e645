// Z-buffer rasterizer of plane records for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of synergynet_tpu/render/raster_tiled.py:
// _raster_kernel (entry synergy_raster_tiled: depth and payloads) and
// _raster_kernel_compact (entry synergy_raster_ids: depth and winning
// triangle id, for the deferred-payload path). Input: one record per
// triangle (f32, row width 13 + 3 * npay; 13 for the ids entry), as
// synergynet_tpu_torch/render/raster_tiled.py::plane_records and
// compact_records lay it out:
//
//   0-8   u, v, depth planes (a, b, c): value(x, y) = (a*x + b*y) + c
//   9-12  x_min x_max y_min y_max      clamped inclusive bbox, integers
//   13-   npay payload planes (a, b, c)
//
// A pixel (x, y) -- the integer column and row as floats, no +0.5 -- is
// covered when u >= 0, v >= 0 and u + v < 1 inside the bbox, and draws when
// its depth is strictly above the z-buffer, which starts at DEPTH_INIT;
// among equal depths the lowest triangle index wins. Outputs: zbuf (h, w)
// (DEPTH_INIT where undrawn) and the winner's payloads (h, w, npay) (0
// where undrawn).
//
// Three launches on one stream, no host sync:
// 1. fill the (h*w) int64 key scratch with EMPTY_KEY;
// 2. one thread per triangle walks its bbox; every covered fragment with
//    depth > DEPTH_INIT does a 64-bit atomicMax of the key
//    (orderable depth bits << 32 | 0xFFFFFFFF - triangle). Max depth wins;
//    on equal depth the lowest index wins: the JAX kernel's max-depth /
//    min-index merge, deterministic whatever order the atomics land in.
//    -0.0 is mapped to +0.0 first (the JAX merge treats them as a tie);
//    a NaN depth fails the depth test, as it fails JAX's strictly-greater
//    update;
// 3. one thread per pixel decodes the winner: the depth from the key, the
//    payload planes evaluated at the pixel (synergy_raster_tiled), or the
//    depth and the triangle id, -1 where undrawn (synergy_raster_ids). The
//    id is the key's low 32 bits, so the compact record carries none.
//
// Planes are evaluated as __fadd_rn(__fadd_rn(__fmul_rn(a, x),
// __fmul_rn(b, y)), c): nvcc would otherwise contract them into FMAs, and
// the plain PyTorch twin rounds every multiply and add on its own. With the
// explicit rounding the kernel and the twin agree bit for bit.
//
// What bounds it on this card: at the overlay's 846,720 triangles of
// 2-18 px, the record reads (52 B a triangle, ~44 MB) and one 8-byte atomic
// to L2 per covered fragment; the walk itself is a few dozen instructions a
// pixel. Warps diverge on unequal bbox sizes and one canvas-spanning
// triangle keeps its thread for its whole bbox. Tile-local resolve in
// shared memory is the lever for a later version.
//
// The ids entry reads 52 B a triangle (~44 MB at 846,720 triangles) and
// writes 8 B a pixel (6.3 MB at 720x1088): bound by bytes, ~0.015 ms at
// 3.35 TB/s, and in practice by the same atomics as the payload entry.

#include <cuda_runtime.h>

namespace {

constexpr int BBOX0 = 9;
constexpr int PAYLOAD0 = 13;
constexpr float DEPTH_INIT = -1e8f;
constexpr long long EMPTY_KEY = -0x7FFFFFFFFFFFFFFFLL - 1;  // INT64_MIN
constexpr int THREADS = 256;

__device__ __forceinline__ float plane(float a, float b, float c, float x,
                                       float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// Signed int32 whose order is the float order (d is not NaN).
__device__ __forceinline__ int order_bits(float d) {
  const int s = __float_as_int(d == 0.0f ? 0.0f : d);
  return s < 0 ? s ^ 0x7FFFFFFF : s;
}

__global__ void fill_keys(long long* __restrict__ keys, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = EMPTY_KEY;
}

__global__ void __launch_bounds__(THREADS)
raster_kernel(const float* __restrict__ rec, long long* __restrict__ keys,
              int ntri, int rec_w, int w) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= ntri) return;
  const float* r = rec + (size_t)t * rec_w;
  const int x0 = (int)r[BBOX0], x1 = (int)r[BBOX0 + 1];
  const int y0 = (int)r[BBOX0 + 2], y1 = (int)r[BBOX0 + 3];
  if (x1 < x0 || y1 < y0) return;
  const float au = r[0], bu = r[1], cu = r[2];
  const float av = r[3], bv = r[4], cv = r[5];
  const float ad = r[6], bd = r[7], cd = r[8];
  const unsigned long long low = 0xFFFFFFFFull - (unsigned)t;
  for (int y = y0; y <= y1; ++y) {
    const float fy = (float)y;
    long long* row = keys + (size_t)y * w;
    for (int x = x0; x <= x1; ++x) {
      const float fx = (float)x;
      const float u = plane(au, bu, cu, fx, fy);
      const float v = plane(av, bv, cv, fx, fy);
      if (!(u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) < 1.0f)) continue;
      const float d = plane(ad, bd, cd, fx, fy);
      if (!(d > DEPTH_INIT)) continue;
      const unsigned long long key =
          ((unsigned long long)(unsigned)order_bits(d) << 32) | low;
      atomicMax(row + x, (long long)key);
    }
  }
}

__global__ void resolve_kernel(const float* __restrict__ rec,
                               const long long* __restrict__ keys,
                               float* __restrict__ zbuf,
                               float* __restrict__ pay, int rec_w, int npay,
                               int npix, int w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npix) return;
  const long long key = keys[i];
  float* out = pay + (size_t)i * npay;
  if (key == EMPTY_KEY) {
    zbuf[i] = DEPTH_INIT;
    for (int k = 0; k < npay; ++k) out[k] = 0.0f;
    return;
  }
  const int s = (int)(key >> 32);
  zbuf[i] = __int_as_float(s < 0 ? s ^ 0x7FFFFFFF : s);
  const unsigned tri = 0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFLL);
  const float* r = rec + (size_t)tri * rec_w + PAYLOAD0;
  const float fx = (float)(i % w), fy = (float)(i / w);
  for (int k = 0; k < npay; ++k)
    out[k] = plane(r[3 * k], r[3 * k + 1], r[3 * k + 2], fx, fy);
}

__global__ void resolve_ids_kernel(const long long* __restrict__ keys,
                                   float* __restrict__ zbuf,
                                   int* __restrict__ ids, int npix) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npix) return;
  const long long key = keys[i];
  if (key == EMPTY_KEY) {
    zbuf[i] = DEPTH_INIT;
    ids[i] = -1;
    return;
  }
  const int s = (int)(key >> 32);
  zbuf[i] = __int_as_float(s < 0 ? s ^ 0x7FFFFFFF : s);
  ids[i] = (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFLL));
}

// Steps 1 and 2: fill the keys, then scatter every triangle's fragments.
cudaError_t resolve_keys(const float* rec, long long* keys, int ntri,
                         int rec_w, int npix, int w, cudaStream_t s) {
  fill_keys<<<(npix + THREADS - 1) / THREADS, THREADS, 0, s>>>(keys, npix);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ntri <= 0) return err;
  raster_kernel<<<(ntri + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      rec, keys, ntri, rec_w, w);
  return cudaGetLastError();
}

}  // namespace

// rec (ntri, 13 + 3 * npay) f32, keys (h * w) int64 scratch, zbuf (h, w)
// f32, pay (h, w, npay) f32: contiguous, on the current device. Launches
// on `stream` and returns the first launch error, or cudaGetLastError().
extern "C" int synergy_raster_tiled(const float* rec, long long* keys,
                                    float* zbuf, float* pay, int ntri,
                                    int npay, int h, int w, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npix = h * w;
  const int rec_w = PAYLOAD0 + 3 * npay;
  if (npix <= 0) return (int)cudaSuccess;
  const cudaError_t err = resolve_keys(rec, keys, ntri, rec_w, npix, w, s);
  if (err != cudaSuccess) return (int)err;
  resolve_kernel<<<(npix + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      rec, keys, zbuf, pay, rec_w, npay, npix, w);
  return (int)cudaGetLastError();
}

// rec (ntri, rec_w) f32 with rec_w >= 13 (payload planes, if any, are not
// read), keys (h * w) int64 scratch, zbuf (h, w) f32, ids (h, w) int32:
// contiguous, on the current device. Launches on `stream` and returns the
// first launch error, or cudaGetLastError().
extern "C" int synergy_raster_ids(const float* rec, long long* keys,
                                  float* zbuf, int* ids, int ntri, int rec_w,
                                  int h, int w, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npix = h * w;
  if (npix <= 0) return (int)cudaSuccess;
  if (rec_w < PAYLOAD0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = resolve_keys(rec, keys, ntri, rec_w, npix, w, s);
  if (err != cudaSuccess) return (int)err;
  resolve_ids_kernel<<<(npix + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      keys, zbuf, ids, npix);
  return (int)cudaGetLastError();
}
