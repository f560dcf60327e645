// Fused dense 3DMM decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel synergynet_tpu/ops/fused_decode.py::
// _decode_kernel. For every face b and vertex v < nver:
//
//   [x y z] = u[:, v] + w[:, v, :] @ alpha[b]          (50 coefficients)
//   out[b, c, v] = p9[b, 3c:3c+3] . [x y z] + off[b, c]
//   out[b, 1, v] = 121 - out[b, 1, v]                  (image-space y flip)
//
// w is the coordinate-split basis (3, npad, 50) and u its means (3, npad),
// both f32; out is (b, 3, nver) f32 at the true vertex count.
//
// What bounds it on this card: per launch the kernel reads the whole basis,
// 3 * 53248 * 50 * 4 B = 32 MB, and writes b * 3 * 53215 * 4 B. At b = 8
// faces (one frame) the basis read dominates (32 MB in, 5 MB out); at
// b = 1024 (128 frames) the 654 MB output write does, and the 159 FMAs per
// output vertex (8.7 GFMA) are of the same order as the write time.
//
// Design: one block owns a tile of 32 vertices. It stages that tile's
// 3 x 50 basis rows in shared memory once, so the basis crosses device
// memory once per launch (the TPU kernel streamed it once per batch tile).
// The block then walks the faces in chunks of 16, whose alpha, rotation
// and offset sit in shared memory. Each of its 4 warps takes 4 faces of a
// chunk and each lane one vertex: one 16-byte broadcast read of 4 faces'
// alpha and three conflict-free basis reads feed 12 FMAs, and each warp's
// stores cover 32 consecutive vertices of one output row. Sums accumulate
// in fp32 FMA; the ragged last tile is masked.

#include <cuda_runtime.h>

namespace {

constexpr int K = 50;              // [shape | exp] coefficients
constexpr int VT = 32;             // vertices per block, one per lane
constexpr int WARPS = 4;           // warps per block, each a face group
constexpr int FPW = 4;             // faces per warp per chunk
constexpr int FC = WARPS * FPW;    // faces per chunk
constexpr int THREADS = VT * WARPS;
constexpr int WS = VT + 1;         // padded row stride of the staged basis
constexpr float Y_FLIP = 121.0f;   // STD_SIZE + 1

__global__ void __launch_bounds__(THREADS)
decode_kernel(const float* __restrict__ alpha, const float* __restrict__ p9,
              const float* __restrict__ off, const float* __restrict__ w,
              const float* __restrict__ u, float* __restrict__ out,
              int nface, int nver, int npad) {
  __shared__ float s_w[3 * K * WS];               // [c][k][v]
  __shared__ __align__(16) float s_alpha[K * FC]; // [k][f]
  __shared__ float s_p[FC * 9];
  __shared__ float s_off[FC * 3];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int v0 = blockIdx.x * VT;

  // Stage the tile: w[c, v0:v0+VT, :] is VT*K contiguous floats per c,
  // read coalesced and stored transposed to [c][k][v].
  for (int i = tid; i < 3 * VT * K; i += THREADS) {
    const int c = i / (VT * K);
    const int r = i - c * (VT * K);
    const int v = r / K;
    const int k = r - v * K;
    float val = 0.0f;
    if (v0 + v < npad) val = w[((size_t)c * npad + v0 + v) * K + k];
    s_w[(c * K + k) * WS + v] = val;
  }
  const int vtx = v0 + lane;
  const bool live = vtx < nver;
  float ux = 0.0f, uy = 0.0f, uz = 0.0f;
  if (vtx < npad) {
    ux = u[vtx];
    uy = u[npad + vtx];
    uz = u[2 * (size_t)npad + vtx];
  }

  for (int f0 = 0; f0 < nface; f0 += FC) {
    __syncthreads();   // the previous chunk is consumed; the tile is staged
    const int nf = min(FC, nface - f0);
    for (int i = tid; i < FC * K; i += THREADS) {
      const int f = i / K;
      const int k = i - f * K;
      s_alpha[k * FC + f] = f < nf ? alpha[(size_t)(f0 + f) * K + k] : 0.0f;
    }
    for (int i = tid; i < FC * 9; i += THREADS)
      s_p[i] = i < nf * 9 ? p9[(size_t)f0 * 9 + i] : 0.0f;
    for (int i = tid; i < FC * 3; i += THREADS)
      s_off[i] = i < nf * 3 ? off[(size_t)f0 * 3 + i] : 0.0f;
    __syncthreads();

    const int fl = warp * FPW;     // this warp's first face in the chunk
    if (fl >= nf) continue;        // every thread still meets the barrier above

    float ax[FPW], ay[FPW], az[FPW];
#pragma unroll
    for (int j = 0; j < FPW; ++j) {
      ax[j] = ux;
      ay[j] = uy;
      az[j] = uz;
    }
#pragma unroll 10
    for (int k = 0; k < K; ++k) {
      const float wx = s_w[(0 * K + k) * WS + lane];
      const float wy = s_w[(1 * K + k) * WS + lane];
      const float wz = s_w[(2 * K + k) * WS + lane];
      const float4 a = *reinterpret_cast<const float4*>(&s_alpha[k * FC + fl]);
      const float av[FPW] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < FPW; ++j) {
        ax[j] = fmaf(av[j], wx, ax[j]);
        ay[j] = fmaf(av[j], wy, ay[j]);
        az[j] = fmaf(av[j], wz, az[j]);
      }
    }
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < FPW; ++j) {
      const int f = fl + j;
      if (f < nf) {
        const float* p = &s_p[f * 9];
        const float* o = &s_off[f * 3];
        const float rx = fmaf(p[0], ax[j], fmaf(p[1], ay[j], fmaf(p[2], az[j], o[0])));
        const float ry = fmaf(p[3], ax[j], fmaf(p[4], ay[j], fmaf(p[5], az[j], o[1])));
        const float rz = fmaf(p[6], ax[j], fmaf(p[7], ay[j], fmaf(p[8], az[j], o[2])));
        float* dst = out + (size_t)(f0 + f) * 3 * nver + vtx;
        dst[0] = rx;
        dst[nver] = Y_FLIP - ry;
        dst[2 * (size_t)nver] = rz;
      }
    }
  }
}

}  // namespace

// alpha (nface, 50), p9 (nface, 9), off (nface, 3), w (3, npad, 50),
// u (3, npad), out (nface, 3, nver): all f32, contiguous, on the current
// device. Launches on `stream` and returns cudaGetLastError().
extern "C" int synergy_fused_decode(const float* alpha, const float* p9,
                                    const float* off, const float* w,
                                    const float* u, float* out, int nface,
                                    int nver, int npad, void* stream) {
  if (nface <= 0 || nver <= 0) return (int)cudaSuccess;
  const dim3 grid((nver + VT - 1) / VT);
  decode_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      alpha, p9, off, w, u, out, nface, nver, npad);
  return (int)cudaGetLastError();
}
