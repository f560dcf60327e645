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
// What bounds it on this card depends on the face count b. The basis is
// 3 * 53248 * 50 * 4 B = 32 MB; the output b * 3 * 53215 * 4 B; the work
// b * 53215 * 325 FLOP in f32 FMAs outside the tensor cores.
// - Few faces (b = 8, one frame): the basis read, 32 MB at 3.35 TB/s.
// - Many faces (b = 1024, 128 frames): the FMAs (17.7 GFLOP at 67 TFLOP/s,
//   0.264 ms) just ahead of the 654 MB output write (0.195 ms); the two
//   overlap across blocks.
//
// Design: one kernel template, two compile-time tilings that the wrapper
// picks from b (ops/fused_decode.py::decode_variant). A block owns a tile of
// VT = 64 vertices (grid y) and walks face tiles of FT faces (grid x of at
// most 4 blocks per vertex tile; blocks of one vertex tile run together and
// share its basis through L2).
// - The basis tile is staged once per block and stays in the layout of
//   device memory: w[c, v0:v0+64, :] is one contiguous 12.8 KB run per
//   coordinate, copied with 16-byte cp.async and no index arithmetic beyond
//   the chunk number. A lane reads its vertex's coefficients k, k+1 as one
//   float2: vertex rows are 200 B apart, so the 16 lanes of a half-warp hit
//   16 distinct 8-byte bank pairs (25 v mod 16 is a permutation), with no
//   conflict.
// - The face operands (alpha, p9, off) of a face tile are staged with
//   4-byte cp.async into one of two buffers, the next tile's while this one
//   multiplies. alpha sits [k][f] with 4-face groups XOR-swizzled by k, so
//   each read is a warp-wide float4 broadcast and the staging stores spread
//   over the banks.
// - Each thread owns NV vertices x NF faces x 3 coordinates of
//   accumulators. Many faces: 2 x 8 x 3 = 48 accumulators; per pair of
//   coefficients 6 float2 basis reads and 4 float4 alpha broadcasts feed
//   96 FMAs (9.6 FMAs per shared load); 128 threads, 32-face tiles, three
//   blocks per SM, 3,328 blocks at 1024 faces (8.4 waves). Few faces:
//   1 x 8 x 3 = 24 accumulators, 64 threads, one 8-face tile, 832 blocks of
//   38.4 KB in flight, five per SM, so the basis read has ~190 KB
//   outstanding per SM.
// The k loop is unrolled whole, so the basis and alpha reads of later
// coefficients are issued ahead of the FMAs that wait on earlier ones.
// Sums accumulate in f32 FMA in k order; the rotation and offset use the
// same FMA order for both tilings; ragged vertex and face tiles are masked.

#include <cuda_runtime.h>

namespace {

constexpr int K = 50;              // [shape | exp] coefficients
constexpr float Y_FLIP = 121.0f;   // STD_SIZE + 1

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;   // 0 bytes read: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

// VW warps across vertices, FW warps across faces; each thread NV vertices
// (32 apart) x NF faces.
template <int VW, int FW, int NV, int NF>
struct Tiling {
  static constexpr int THREADS = 32 * VW * FW;
  static constexpr int VT = 32 * NV * VW;          // vertices per block
  static constexpr int FT = NF * FW;               // faces per block
  static constexpr int SLAB = VT * K;              // floats per coordinate
  static constexpr int GROUPS = FT / 4;            // float4 face groups
  static constexpr int FACE_BUF = K * FT + 12 * FT;  // floats per face tile
  static constexpr int SMEM = (3 * SLAB + 2 * FACE_BUF) * 4;
  static_assert(NF % 4 == 0 && (GROUPS & (GROUPS - 1)) == 0, "face groups");
  static_assert(SLAB % 4 == 0, "the slab is whole 16-byte chunks");
};

template <int VW, int FW, int NV, int NF, int MINB>
__global__ void __launch_bounds__(32 * VW * FW, MINB)
decode_kernel(const float* __restrict__ alpha, const float* __restrict__ p9,
              const float* __restrict__ off, const float* __restrict__ w,
              const float* __restrict__ u, float* __restrict__ out,
              int nface, int nver, int npad) {
  using T = Tiling<VW, FW, NV, NF>;
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                          // [c][v][k], 3 slabs
  float* s_face = s_w + 3 * T::SLAB;          // 2 x {alpha, p9 | off}

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wv = warp % VW, wf = warp / VW;
  const int v0 = blockIdx.y * T::VT;
  const int nftiles = (nface + T::FT - 1) / T::FT;

  // The basis tile: three contiguous runs of 16-byte chunks. npad is even,
  // so a chunk lies wholly inside the basis or wholly past its end.
  const int live_floats = (npad - v0) * K;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* src = w + ((size_t)c * npad + v0) * K;
    const unsigned dst = smem_addr(s_w + c * T::SLAB);
    for (int i = tid; i < T::SLAB / 4; i += T::THREADS) {
      const bool ok = 4 * i < live_floats;
      cp_async16(dst + 16 * i, ok ? src + 4 * i : w, ok);
    }
  }

  // A face tile's operands into buffer `buf`, zero past the last face:
  // alpha [k][swizzled f], then [f][p9 | off] (12 floats a face).
  auto stage_faces = [&](int ft, int buf) {
    float* s_alpha = s_face + buf * T::FACE_BUF;
    float* s_p = s_alpha + K * T::FT;
    for (int f = warp; f < T::FT; f += T::THREADS / 32) {
      const int g = ft * T::FT + f;
      const bool ok = g < nface;
      for (int k = lane; k < K; k += 32) {
        const int sw = (((f >> 2) ^ (k & (T::GROUPS - 1))) << 2) | (f & 3);
        cp_async4(smem_addr(s_alpha + k * T::FT + sw),
                  ok ? alpha + (size_t)g * K + k : alpha, ok);
      }
      if (lane < 12) {
        const float* src = lane < 9 ? p9 + (size_t)g * 9 + lane
                                    : off + (size_t)g * 3 + lane - 9;
        cp_async4(smem_addr(s_p + f * 12 + lane), ok ? src : p9, ok);
      }
    }
  };
  stage_faces(blockIdx.x, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  int vtx[NV];
  float mean[NV][3];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    vtx[i] = v0 + (wv * NV + i) * 32 + lane;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      mean[i][c] = vtx[i] < npad ? u[(size_t)c * npad + vtx[i]] : 0.0f;
  }
  const float* sw0 = s_w + (wv * NV * 32 + lane) * K;
  const int g0 = wf * (NF / 4);                // this warp's first group

  // The block keeps its basis tile and walks face tiles blockIdx.x,
  // blockIdx.x + gridDim.x, ...; the next tile's operands load while this
  // one multiplies.
  int it = 0;
  for (int ft = blockIdx.x; ft < nftiles; ft += gridDim.x, ++it) {
    const int buf = it & 1;
    if (ft + (int)gridDim.x < nftiles) {
      stage_faces(ft + gridDim.x, buf ^ 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* s_alpha = s_face + buf * T::FACE_BUF;
    const float* s_p = s_alpha + K * T::FT;

    float acc[NF][NV][3];
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[j][i][c] = mean[i][c];

#pragma unroll
    for (int k = 0; k < K; k += 2) {
      float2 b[NV][3];
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          b[i][c] = *reinterpret_cast<const float2*>(
              sw0 + c * T::SLAB + i * 32 * K + k);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float* arow = s_alpha + (k + kk) * T::FT;
        const int swz = (k + kk) & (T::GROUPS - 1);
#pragma unroll
        for (int t = 0; t < NF / 4; ++t) {
          const float4 a = *reinterpret_cast<const float4*>(
              arow + (((g0 + t) ^ swz) << 2));
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < NV; ++i)
#pragma unroll
              for (int c = 0; c < 3; ++c) {
                const float bv = kk ? b[i][c].y : b[i][c].x;
                acc[4 * t + q][i][c] = fmaf(av[q], bv, acc[4 * t + q][i][c]);
              }
        }
      }
    }

    // Rotation + offset + y flip; each warp store covers 32 consecutive
    // vertices of one output row.
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = wf * NF + j;
      const int g = ft * T::FT + f;
      if (g >= nface) continue;
      const float4 pa = *reinterpret_cast<const float4*>(s_p + f * 12);
      const float4 pb = *reinterpret_cast<const float4*>(s_p + f * 12 + 4);
      const float4 pc = *reinterpret_cast<const float4*>(s_p + f * 12 + 8);
      float* dst = out + (size_t)g * 3 * nver;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (vtx[i] >= nver) continue;
        const float x = acc[j][i][0], y = acc[j][i][1], z = acc[j][i][2];
        const float rx = fmaf(pa.x, x, fmaf(pa.y, y, fmaf(pa.z, z, pc.y)));
        const float ry = fmaf(pa.w, x, fmaf(pb.x, y, fmaf(pb.y, z, pc.z)));
        const float rz = fmaf(pb.z, x, fmaf(pb.w, y, fmaf(pc.x, z, pc.w)));
        dst[vtx[i]] = rx;
        dst[nver + vtx[i]] = Y_FLIP - ry;
        dst[2 * (size_t)nver + vtx[i]] = rz;
      }
    }
    __syncthreads();   // this buffer is read before it is staged again
  }
}

template <int VW, int FW, int NV, int NF, int MINB, int FSPLIT>
int launch(const float* alpha, const float* p9, const float* off,
           const float* w, const float* u, float* out, int nface, int nver,
           int npad, cudaStream_t stream) {
  using T = Tiling<VW, FW, NV, NF>;
  auto kernel = decode_kernel<VW, FW, NV, NF, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nftiles = (nface + T::FT - 1) / T::FT;
  const dim3 grid(nftiles < FSPLIT ? nftiles : FSPLIT,
                  (nver + T::VT - 1) / T::VT);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(alpha, p9, off, w, u, out,
                                                nface, nver, npad);
  return (int)cudaGetLastError();
}

}  // namespace

// alpha (nface, 50), p9 (nface, 9), off (nface, 3), w (3, npad, 50) with
// npad even and w 16-byte aligned, u (3, npad), out (nface, 3, nver): all
// f32, contiguous, on the current device. variant 0 is the few-faces
// tiling (8-face tiles), 1 the many-faces one (32-face tiles). Launches
// on `stream` and returns cudaGetLastError().
extern "C" int synergy_fused_decode(const float* alpha, const float* p9,
                                    const float* off, const float* w,
                                    const float* u, float* out, int nface,
                                    int nver, int npad, int variant,
                                    void* stream) {
  if (nface <= 0 || nver <= 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0)
    return launch<2, 1, 1, 8, 5, 1>(alpha, p9, off, w, u, out, nface, nver,
                                 npad, s);
  if (variant == 1)
    return launch<1, 4, 2, 8, 3, 4>(alpha, p9, off, w, u, out, nface, nver,
                                  npad, s);
  return (int)cudaErrorInvalidValue;
}
