// Z-buffer rasterizer of triangle meshes for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of synergynet_tpu/render/raster_tiled.py:
// _raster_kernel (entry synergy_raster_mesh: depth and 1-5 payloads) and
// _raster_kernel_compact (entry synergy_raster_mesh_ids: depth, winning
// triangle id and, where asked, the barycentric w0 of the winner). Input:
// the mesh itself -- vertices (V, 3) f32, triangles (T, 3) int32 or int64
// and, for the payload entry, per-vertex payloads (V, P) f32. The TPU
// kernels read per-triangle plane records because they gather tiles into
// VMEM; here the lane that walks a triangle builds its planes in registers,
// and the resolve rebuilds them for the winner, so no record reaches device
// memory.
//
// Setup, per triangle, in the operation order of
// synergynet_tpu_torch/render/raster_tiled.py::_bary_setup / _clamp_bbox
// (v0 = p2 - p0, v1 = p1 - p0):
//
//   u(p) = (Au*x + Bu*y) + Cu, v(p) likewise, and an attribute plane
//   value(p) = a0 + (a2 - a0) * u + (a1 - a0) * v for depth and payloads;
//   |den| <= 1e-6 * dot00 * dot11 is degenerate: u = v = 0 on the whole
//   bbox, which then paints vertex 0's attributes;
//   bbox = floor/ceil of the vertex extremes, clamped to the canvas and to
//   +-2^24, empty when a coordinate is NaN.
//
// A pixel (x, y) -- the integer column and row as floats, no +0.5 -- is
// covered when u >= 0, v >= 0 and u + v < 1 inside the bbox, and draws when
// its depth is strictly above the z-buffer, which starts at DEPTH_INIT;
// among equal depths the lowest triangle index wins. Outputs: zbuf (h, w)
// (DEPTH_INIT where undrawn) and the winner's payloads (h, w, P), or its id
// (-1 where undrawn) and w0 = 1 - u - v (0 where undrawn).
//
// Three launches on one stream, no host sync:
// 1. fill the (h*w) int64 key scratch with EMPTY_KEY;
// 2. one thread per triangle gathers its three vertices, builds the planes
//    and walks its bbox; every covered fragment with depth > DEPTH_INIT
//    does a 64-bit atomicMax of the key (orderable depth bits << 32 |
//    0xFFFFFFFF - triangle). Max depth wins; on equal depth the lowest
//    index wins: the JAX kernel's max-depth / min-index merge,
//    deterministic whatever order the atomics land in. -0.0 is mapped to
//    +0.0 first (the JAX merge treats them as a tie); a NaN depth fails the
//    depth test, as it fails JAX's strictly-greater update. A triangle
//    index outside [0, V) traps, as PyTorch's own gather asserts: the
//    kernel never reads outside the vertices;
// 3. one thread per pixel decodes the winner from the key's low 32 bits,
//    gathers its vertices (and payload rows), rebuilds its planes and
//    evaluates them at the pixel.
//
// Every multiply, add, subtract and divide of the setup and of the plane
// evaluation is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn): nvcc would otherwise contract them into FMAs, and the plain
// PyTorch twin (plane_records, then the record resolve) rounds each
// operation. With the explicit rounding the kernel and the twin agree bit
// for bit, and the resolve's rebuilt planes equal the walk's.
//
// What bounds it on this card: at the overlay's 846,720 triangles of 2-18 px
// the inputs are ~20 MB (vertices, payloads, int32 triangles) and the
// outputs ~12.5 MB, so the bytes bound is ~0.010 ms; in practice the walk
// (one 8-byte atomic to L2 per covered fragment, ~12M bbox pixels) takes
// half the time and the payload resolve, whose three dependent gathers a
// pixel (key, triangle, vertex and payload rows) wait on memory, a third.
// The setup adds ~80 rounded flops and six row gathers a triangle and
// takes away the 52-88 B record read a triangle of the record form. One
// thread per triangle keeps its lanes busy here because a face mesh's
// neighbouring triangles have bboxes of similar size; a warp-cooperative
// walk (a scan of the 32 bbox sizes, each lane finding its fragment's
// triangle by a shuffle search) spent ~18 shuffles per 32 fragments and
// walked 2.3x slower on these meshes (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr float DEPTH_INIT = -1e8f;
constexpr long long EMPTY_KEY = -0x7FFFFFFFFFFFFFFFLL - 1;  // INT64_MIN
constexpr int THREADS = 256;
constexpr int MAX_PAYLOAD = 5;
// Bbox limits beyond the canvas: integers exact in f32 and in int32.
constexpr float FAR = 16777216.0f;  // 2^24
// The degeneracy tolerance as the twin's f32 scalar: the double 1e-6
// rounded to float.
constexpr float DEGENERATE_TOL = (float)1e-6;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

__device__ __forceinline__ float plane(float a, float b, float c, float x,
                                       float y) {
  return add(add(mul(a, x), mul(b, y)), c);
}

// Signed int32 whose order is the float order (d is not NaN).
__device__ __forceinline__ int order_bits(float d) {
  const int s = __float_as_int(d == 0.0f ? 0.0f : d);
  return s < 0 ? s ^ 0x7FFFFFFF : s;
}

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ Vec3 vertex(const float* __restrict__ verts,
                                       int i) {
  const float* p = verts + 3 * (size_t)i;
  return {p[0], p[1], p[2]};
}

// Triangle t's vertex indices; traps on an index outside [0, nver).
template <typename Idx>
__device__ __forceinline__ void triangle(const Idx* __restrict__ tris, int t,
                                         int nver, int (&idx)[3]) {
  for (int j = 0; j < 3; ++j) {
    const Idx k = tris[3 * (size_t)t + j];
    if (k < 0 || k >= (Idx)nver) __trap();
    idx[j] = (int)k;
  }
}

// The u and v planes of _bary_setup, op for op.
struct Planes {
  float au, bu, cu, av, bv, cv;

  __device__ __forceinline__ Planes(const Vec3& p0, const Vec3& p1,
                                    const Vec3& p2) {
    const float v0x = sub(p2.x, p0.x), v0y = sub(p2.y, p0.y);
    const float v1x = sub(p1.x, p0.x), v1y = sub(p1.y, p0.y);
    const float dot00 = add(mul(v0x, v0x), mul(v0y, v0y));
    const float dot01 = add(mul(v0x, v1x), mul(v0y, v1y));
    const float dot11 = add(mul(v1x, v1x), mul(v1y, v1y));
    const float den = sub(mul(dot00, dot11), mul(dot01, dot01));
    const bool degenerate =
        fabsf(den) <= mul(mul(DEGENERATE_TOL, dot00), dot11);
    const float inv = degenerate ? 0.0f : __fdiv_rn(1.0f, den);
    au = mul(sub(mul(dot11, v0x), mul(dot01, v1x)), inv);
    bu = mul(sub(mul(dot11, v0y), mul(dot01, v1y)), inv);
    cu = -add(mul(au, p0.x), mul(bu, p0.y));
    av = mul(sub(mul(dot00, v1x), mul(dot01, v0x)), inv);
    bv = mul(sub(mul(dot00, v1y), mul(dot01, v0y)), inv);
    cv = -add(mul(av, p0.x), mul(bv, p0.y));
  }

  // attr_plane: a per-vertex attribute's (a, b, c).
  __device__ __forceinline__ void attr(float a0, float a1, float a2,
                                       float& a, float& b, float& c) const {
    const float du = sub(a2, a0), dv = sub(a1, a0);
    a = add(mul(du, au), mul(dv, av));
    b = add(mul(du, bu), mul(dv, bv));
    c = add(add(a0, mul(du, cu)), mul(dv, cv));
  }
};

// The clamped inclusive bbox of _clamp_bbox; x1 < x0 or y1 < y0 is empty.
struct Bbox {
  int x0, x1, y0, y1;

  __device__ __forceinline__ Bbox(const Vec3& p0, const Vec3& p1,
                                  const Vec3& p2, int h, int w) {
    if (isnan(p0.x) || isnan(p1.x) || isnan(p2.x) || isnan(p0.y) ||
        isnan(p1.y) || isnan(p2.y)) {
      x0 = y0 = 1;
      x1 = y1 = 0;
      return;
    }
    const float xmin = floorf(fminf(fminf(p0.x, p1.x), p2.x));
    const float xmax = ceilf(fmaxf(fmaxf(p0.x, p1.x), p2.x));
    const float ymin = floorf(fminf(fminf(p0.y, p1.y), p2.y));
    const float ymax = ceilf(fmaxf(fmaxf(p0.y, p1.y), p2.y));
    x0 = (int)fminf(fmaxf(xmin, 0.0f), FAR);
    x1 = (int)fminf(fmaxf(xmax, -FAR), (float)(w - 1));
    y0 = (int)fminf(fmaxf(ymin, 0.0f), FAR);
    y1 = (int)fminf(fmaxf(ymax, -FAR), (float)(h - 1));
  }

  __device__ __forceinline__ bool empty() const {
    return x1 < x0 || y1 < y0;
  }
};

__global__ void fill_keys(long long* __restrict__ keys, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = EMPTY_KEY;
}

template <typename Idx>
__global__ void __launch_bounds__(THREADS)
raster_mesh_kernel(const float* __restrict__ verts,
                   const Idx* __restrict__ tris, long long* __restrict__ keys,
                   int nver, int ntri, int h, int w) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= ntri) return;
  int idx[3];
  triangle(tris, t, nver, idx);
  const Vec3 p0 = vertex(verts, idx[0]), p1 = vertex(verts, idx[1]),
             p2 = vertex(verts, idx[2]);
  const Bbox bb(p0, p1, p2, h, w);
  if (bb.empty()) return;
  const Planes pl(p0, p1, p2);
  float ad, bd, cd;
  pl.attr(p0.z, p1.z, p2.z, ad, bd, cd);
  const unsigned long long low = 0xFFFFFFFFull - (unsigned)t;
  for (int y = bb.y0; y <= bb.y1; ++y) {
    const float fy = (float)y;
    long long* row = keys + (size_t)y * w;
    for (int x = bb.x0; x <= bb.x1; ++x) {
      const float fx = (float)x;
      const float u = plane(pl.au, pl.bu, pl.cu, fx, fy);
      const float v = plane(pl.av, pl.bv, pl.cv, fx, fy);
      if (!(u >= 0.0f && v >= 0.0f && add(u, v) < 1.0f)) continue;
      const float d = plane(ad, bd, cd, fx, fy);
      if (!(d > DEPTH_INIT)) continue;
      const unsigned long long key =
          ((unsigned long long)(unsigned)order_bits(d) << 32) | low;
      atomicMax(row + x, (long long)key);
    }
  }
}

// The winner of pixel i, or -1; writes the pixel's depth.
__device__ __forceinline__ int winner(const long long* __restrict__ keys,
                                      float* __restrict__ zbuf, int i) {
  const long long key = keys[i];
  if (key == EMPTY_KEY) {
    zbuf[i] = DEPTH_INIT;
    return -1;
  }
  const int s = (int)(key >> 32);
  zbuf[i] = __int_as_float(s < 0 ? s ^ 0x7FFFFFFF : s);
  return (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFLL));
}

template <typename Idx>
__global__ void resolve_mesh_kernel(const float* __restrict__ verts,
                                    const Idx* __restrict__ tris,
                                    const float* __restrict__ pay,
                                    const long long* __restrict__ keys,
                                    float* __restrict__ zbuf,
                                    float* __restrict__ out, int nver,
                                    int npay, int npix, int w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npix) return;
  float* o = out + (size_t)i * npay;
  const int t = winner(keys, zbuf, i);
  if (t < 0) {
    for (int k = 0; k < npay; ++k) o[k] = 0.0f;
    return;
  }
  int idx[3];
  triangle(tris, t, nver, idx);
  const Planes pl(vertex(verts, idx[0]), vertex(verts, idx[1]),
                  vertex(verts, idx[2]));
  const float* r0 = pay + (size_t)idx[0] * npay;
  const float* r1 = pay + (size_t)idx[1] * npay;
  const float* r2 = pay + (size_t)idx[2] * npay;
  const float fx = (float)(i % w), fy = (float)(i / w);
  for (int k = 0; k < npay; ++k) {
    float a, b, c;
    pl.attr(r0[k], r1[k], r2[k], a, b, c);
    o[k] = plane(a, b, c, fx, fy);
  }
}

// w0 (nullable): 1 - u - v as the plane (-(Au + Av), -(Bu + Bv),
// 1 - (Cu + Cv)), _visibility_records' order.
template <typename Idx>
__global__ void resolve_mesh_ids_kernel(const float* __restrict__ verts,
                                        const Idx* __restrict__ tris,
                                        const long long* __restrict__ keys,
                                        float* __restrict__ zbuf,
                                        int* __restrict__ ids,
                                        float* __restrict__ w0, int nver,
                                        int npix, int w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npix) return;
  const int t = winner(keys, zbuf, i);
  ids[i] = t;
  if (w0 == nullptr) return;
  if (t < 0) {
    w0[i] = 0.0f;
    return;
  }
  int idx[3];
  triangle(tris, t, nver, idx);
  const Planes pl(vertex(verts, idx[0]), vertex(verts, idx[1]),
                  vertex(verts, idx[2]));
  w0[i] = plane(-add(pl.au, pl.av), -add(pl.bu, pl.bv),
                sub(1.0f, add(pl.cu, pl.cv)), (float)(i % w),
                (float)(i / w));
}

// Steps 1 and 2: fill the keys, then scatter every triangle's fragments.
template <typename Idx>
cudaError_t resolve_keys(const float* verts, const Idx* tris,
                         long long* keys, int nver, int ntri, int h, int w,
                         cudaStream_t s) {
  const int npix = h * w;
  fill_keys<<<(npix + THREADS - 1) / THREADS, THREADS, 0, s>>>(keys, npix);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ntri <= 0) return err;
  raster_mesh_kernel<Idx><<<(ntri + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      verts, tris, keys, nver, ntri, h, w);
  return cudaGetLastError();
}

template <typename Idx>
int raster_mesh(const float* verts, const Idx* tris, const float* pay,
                long long* keys, float* zbuf, float* out, int nver, int ntri,
                int npay, int h, int w, cudaStream_t s) {
  const cudaError_t err = resolve_keys(verts, tris, keys, nver, ntri, h, w, s);
  if (err != cudaSuccess) return (int)err;
  const int npix = h * w;
  resolve_mesh_kernel<Idx><<<(npix + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      verts, tris, pay, keys, zbuf, out, nver, npay, npix, w);
  return (int)cudaGetLastError();
}

template <typename Idx>
int raster_mesh_ids(const float* verts, const Idx* tris, long long* keys,
                    float* zbuf, int* ids, float* w0, int nver, int ntri,
                    int h, int w, cudaStream_t s) {
  const cudaError_t err = resolve_keys(verts, tris, keys, nver, ntri, h, w, s);
  if (err != cudaSuccess) return (int)err;
  const int npix = h * w;
  resolve_mesh_ids_kernel<Idx>
      <<<(npix + THREADS - 1) / THREADS, THREADS, 0, s>>>(
          verts, tris, keys, zbuf, ids, w0, nver, npix, w);
  return (int)cudaGetLastError();
}

}  // namespace

// verts (nver, 3) f32, tris (ntri, 3) int64 when tri64 else int32, pay
// (nver, npay) f32 with 1 <= npay <= 5, keys (h * w) int64 scratch, zbuf
// (h, w) f32, out (h, w, npay) f32: contiguous, on the current device.
// Launches on `stream` and returns the first launch error, or
// cudaGetLastError().
extern "C" int synergy_raster_mesh(const float* verts, const void* tris,
                                   const float* pay, long long* keys,
                                   float* zbuf, float* out, int tri64,
                                   int nver, int ntri, int npay, int h, int w,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npay < 1 || npay > MAX_PAYLOAD) return (int)cudaErrorInvalidValue;
  if (h <= 0 || w <= 0) return (int)cudaSuccess;
  return tri64 ? raster_mesh(verts, static_cast<const long long*>(tris), pay,
                             keys, zbuf, out, nver, ntri, npay, h, w, s)
               : raster_mesh(verts, static_cast<const int*>(tris), pay, keys,
                             zbuf, out, nver, ntri, npay, h, w, s);
}

// verts and tris as above, keys (h * w) int64 scratch, zbuf (h, w) f32, ids
// (h, w) int32, w0 (h, w) f32 or null: contiguous, on the current device.
// Launches on `stream` and returns the first launch error, or
// cudaGetLastError().
extern "C" int synergy_raster_mesh_ids(const float* verts, const void* tris,
                                       long long* keys, float* zbuf, int* ids,
                                       float* w0, int tri64, int nver,
                                       int ntri, int h, int w, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 0 || w <= 0) return (int)cudaSuccess;
  return tri64
             ? raster_mesh_ids(verts, static_cast<const long long*>(tris),
                               keys, zbuf, ids, w0, nver, ntri, h, w, s)
             : raster_mesh_ids(verts, static_cast<const int*>(tris), keys,
                               zbuf, ids, w0, nver, ntri, h, w, s);
}
