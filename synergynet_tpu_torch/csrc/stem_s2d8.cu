// Fused FaceBoxes s2d8 stem (conv1 + 3x3/2 max-pool) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel synergynet_tpu/detect/stem_pallas.py::
// _stem_kernel. Inputs, all contiguous on the current device:
//
//   x     (B, H8, W8, 192) bf16   mean-subtracted frames packed s2d8
//   w4    (4, 192, 192)    bf16   tap 2a+b, input channel, conv channel
//   bias  (192,)           f32
//   out   (B, H8, W8, 48)  bf16
//
// Conv channel (2p+q)*48 + o is the stride-4 output phase (p, q) of pooled
// channel o. Over x padded by one zero row on top and one zero column on the
// left (F.pad(x, (1, 0, 1, 0))), conv(r, c) = sum over taps (a, b) of
// x[r+a-1, c+b-1] . w4[2a+b], accumulated in f32, + bias, ReLU. Pooled
// output (i, j) is the max over conv rows {(i-1, p1), (i, p0), (i, p1)} x
// conv columns {(j-1, q1), (j, q0), (j, q1)}; conv row or column -1 counts
// as 0, which is exact past the ReLU. The result is rounded to bf16 once,
// at the end.
//
// What bounds it on this card: one 720x1088 frame is 90 x 136 positions x
// (4 taps x 192 x 192) MACs = 3.61 GFLOP against 4.7 MB in and 1.2 MB out
// (5.9 MB of HBM traffic): ~610 FLOP per byte, twice the H100's bf16 ridge
// of ~295, so it is compute-bound and the products go to the tensor cores.
//
// Design: a block owns 16 of the 48 pooled channels (so 64 conv channels,
// all four phases of each, which the pool needs), stages that slice of the
// weights in shared memory once (768 x 64 bf16 = 96 KB; the whole 288 KB
// would not fit the 227 KB a block can use) and walks output tiles of 15 x 17
// positions (W8 = 136 = 8 x 17, H8 = 90 = 6 x 15). Per tile it loads the
// 17 x 19 x 192 input window (two halo rows and columns) with cp.async,
// recomputes the 16 x 18 conv window (one halo row and column) as a
// (288 x 768) x (768 x 64) product with mma.sync m16n8k16 bf16 -> f32 fed by
// ldmatrix (XOR-swizzled rows, conflict-free), adds the bias, applies ReLU
// and zeroes the pool's top and left pad, keeps the f32 conv tile in shared
// memory (over the input window) and pools from there: the 4x-phase
// activation never reaches device memory. Ragged bottom and right tiles are
// masked. The halo recompute costs 13% more products; wgmma, TMA and
// overlapping the next tile's load with this tile's math are left for a
// later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CIN = 192;
constexpr int COUT = 48;                 // pooled channels
constexpr int CG = 16;                   // pooled channels per block
constexpr int GROUPS = COUT / CG;        // 3
constexpr int NB = 4 * CG;               // conv channels per block: 64
constexpr int KTOT = 4 * CIN;            // 768: tap-major, then input channel
constexpr int TR = 15, TC = 17;          // pooled output tile
constexpr int CR = TR + 1, CC = TC + 1;  // conv tile with its halo: 16 x 18
constexpr int XR = TR + 2, XC = TC + 2;  // input window: 17 x 19
constexpr int M = CR * CC;               // 288 conv positions = 18 m16 tiles
constexpr int WARPS = 9;                 // two m16 tiles each
constexpr int THREADS = WARPS * 32;
constexpr int XCHUNKS = CIN / 8;         // 16-byte chunks per position: 24
constexpr int CS = NB + 8;               // padded row of the f32 conv tile

constexpr int W_BYTES = KTOT * NB * 2;          // 98,304
constexpr int BIAS_BYTES = NB * 4;              // 256
constexpr int X_BYTES = XR * XC * CIN * 2;      // 124,032
constexpr int C_BYTES = M * CS * 4;             // 82,944, aliases the window
constexpr int SMEM_BYTES = W_BYTES + BIAS_BYTES + X_BYTES;
static_assert(C_BYTES <= X_BYTES, "conv tile must fit over the window");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;   // 0 bytes read: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned& r0,
                                            unsigned& r1, unsigned& r2,
                                            unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr, unsigned& r0,
                                                  unsigned& r1, unsigned& r2,
                                                  unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory layouts (byte offsets), 16-byte chunks XOR-swizzled so that
// the 8 rows an ldmatrix phase reads fall in 8 different bank groups:
//   weights  row k (0..767), chunk nc (0..7):  k*128 + ((nc ^ (k & 7)) << 4)
//   window   position xi = row*XC + col, chunk kc (0..23):
//            xi*384 + ((kc ^ (xi & 7)) << 4)
// The XOR keeps kc inside its aligned group of 8, so it stays below 24.

__global__ void __launch_bounds__(THREADS, 1)
stem_kernel(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ w4,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
            int nb, int h8, int w8) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_w = smem;
  float* s_bias = reinterpret_cast<float*>(smem + W_BYTES);
  unsigned char* s_x = smem + W_BYTES + BIAS_BYTES;
  float* s_c = reinterpret_cast<float*>(s_x);   // the conv tile, after the MMAs

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = blockIdx.y;                     // pooled channels 16g..16g+15

  // Block n = ph*16 + o holds conv channel ph*48 + 16g + o.
  for (int i = tid; i < KTOT * (NB / 8); i += THREADS) {
    const int k = i >> 3, nc = i & 7;
    const __nv_bfloat16* src =
        w4 + (size_t)k * (4 * COUT) + (nc >> 1) * COUT + g * CG + (nc & 1) * 8;
    cp_async16(smem_addr(s_w + k * 128 + ((nc ^ (k & 7)) << 4)), src, true);
  }
  if (tid < NB) s_bias[tid] = bias[(tid >> 4) * COUT + g * CG + (tid & 15)];
  cp_async_wait_all();

  // Per-lane ldmatrix rows. A: conv position m = mt*16 + (lane & 15) of this
  // warp's two m16 tiles, input chunk offset (lane >> 4). B: k row
  // (lane & 7) + 8*((lane >> 3) & 1) of the k16 step, n chunk 2*np + (lane >> 4).
  int xi0[2];
  for (int t = 0; t < 2; ++t) {
    const int m = (2 * warp + t) * 16 + (lane & 15);
    xi0[t] = (m / CC) * XC + (m % CC);
  }
  const int a_hi = lane >> 4;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8;
  const unsigned w_base = smem_addr(s_w) + b_k * 128;
  const unsigned x_base = smem_addr(s_x);
  const int gid = lane >> 2, tig = lane & 3;

  const int ntr = (h8 + TR - 1) / TR, ntc = (w8 + TC - 1) / TC;
  const int ntiles = nb * ntr * ntc;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / (ntr * ntc);
    const int rem = tile - b * ntr * ntc;
    const int i0 = (rem / ntc) * TR, j0 = (rem % ntc) * TC;

    __syncthreads();   // the previous tile's pool has read the conv tile
    // Input window rows i0-2 .. i0+14, columns j0-2 .. j0+16; zero outside.
    for (int i = tid; i < XR * XC * XCHUNKS; i += THREADS) {
      const int xi = i / XCHUNKS, kc = i - xi * XCHUNKS;
      const int gr = i0 - 2 + xi / XC, gc = j0 - 2 + xi % XC;
      const bool ok = gr >= 0 && gr < h8 && gc >= 0 && gc < w8;
      const __nv_bfloat16* src =
          ok ? x + (((size_t)b * h8 + gr) * w8 + gc) * CIN + kc * 8 : x;
      cp_async16(x_base + xi * (CIN * 2) + ((kc ^ (xi & 7)) << 4), src, ok);
    }
    cp_async_wait_all();
    __syncthreads();

    float acc[2][8][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][n][e] = 0.0f;

    // conv(m) reads window position xi0 + a*XC + b for tap (a, b).
#pragma unroll 1
    for (int tap = 0; tap < 4; ++tap) {
      const int shift = (tap >> 1) * XC + (tap & 1);
      const int xa = xi0[0] + shift, xb = xi0[1] + shift;
      const unsigned rowa = x_base + xa * (CIN * 2);
      const unsigned rowb = x_base + xb * (CIN * 2);
      const int swa = xa & 7, swb = xb & 7;
#pragma unroll 2
      for (int kk = 0; kk < CIN / 16; ++kk) {
        const int kc = kk * 2 + a_hi;
        unsigned fa[2][4];
        ldmatrix_x4(rowa + ((kc ^ swa) << 4), fa[0][0], fa[0][1], fa[0][2],
                    fa[0][3]);
        ldmatrix_x4(rowb + ((kc ^ swb) << 4), fa[1][0], fa[1][1], fa[1][2],
                    fa[1][3]);
        const unsigned wrow = w_base + (tap * CIN + kk * 16) * 128;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned b0, b1, b2, b3;
          const int nc = 2 * np + a_hi;
          ldmatrix_x4_trans(wrow + ((nc ^ (lane & 7)) << 4), b0, b1, b2, b3);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            mma_bf16(acc[t][2 * np], fa[t], b0, b1);
            mma_bf16(acc[t][2 * np + 1], fa[t], b2, b3);
          }
        }
      }
    }
    __syncthreads();   // every warp is done reading the window

    // + bias, ReLU, zero the pool pad (conv row -1, conv column -1), and
    // keep the f32 conv tile in shared memory: s_c[m * CS + n].
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = (2 * warp + t) * 16 + gid + half * 8;
        const int rr = m / CC, cc = m % CC;
        const bool pad = (i0 - 1 + rr < 0) || (j0 - 1 + cc < 0);
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int n = n8 * 8 + tig * 2;
          float v0 = fmaxf(acc[t][n8][2 * half] + s_bias[n], 0.0f);
          float v1 = fmaxf(acc[t][n8][2 * half + 1] + s_bias[n + 1], 0.0f);
          if (pad) v0 = v1 = 0.0f;
          *reinterpret_cast<float2*>(s_c + m * CS + n) = make_float2(v0, v1);
        }
      }
    }
    __syncthreads();

    // Pool: output (ii, jj) of the tile reads conv rows ii (p1) and ii+1
    // (p0, p1), conv columns jj (q1) and jj+1 (q0, q1) of the conv tile.
    for (int i = tid; i < TR * TC * (CG / 2); i += THREADS) {
      const int pos = i >> 3, pr = i & 7;
      const int ii = pos / TC, jj = pos - ii * TC;
      const int oi = i0 + ii, oj = j0 + jj;
      if (oi >= h8 || oj >= w8) continue;
      const float* c = s_c + pr * 2;
      auto at = [&](int ph, int r, int col) {
        return *reinterpret_cast<const float2*>(c + (r * CC + col) * CS +
                                                ph * CG);
      };
      const float2 cand[9] = {at(2, ii, jj + 1),     at(0, ii + 1, jj + 1),
                              at(2, ii + 1, jj + 1), at(3, ii, jj + 1),
                              at(1, ii + 1, jj + 1), at(3, ii + 1, jj + 1),
                              at(3, ii, jj),         at(1, ii + 1, jj),
                              at(3, ii + 1, jj)};
      float v0 = cand[0].x, v1 = cand[0].y;
#pragma unroll
      for (int k = 1; k < 9; ++k) {
        v0 = fmaxf(v0, cand[k].x);
        v1 = fmaxf(v1, cand[k].y);
      }
      *reinterpret_cast<__nv_bfloat162*>(
          out + (((size_t)b * h8 + oi) * w8 + oj) * COUT + g * CG + pr * 2) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

}  // namespace

// x (nb, h8, w8, 192) bf16, w4 (4, 192, 192) bf16, bias (192,) f32, out
// (nb, h8, w8, 48) bf16: contiguous, 16-byte aligned, on the current
// device. Launches on `stream` and returns cudaGetLastError().
extern "C" int synergy_stem_s2d8(const void* x, const void* w4,
                                 const float* bias, void* out, int nb, int h8,
                                 int w8, void* stream) {
  if (nb <= 0 || h8 <= 0 || w8 <= 0) return (int)cudaSuccess;
  int dev = 0, nsm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(stem_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = (long long)nb * ((h8 + TR - 1) / TR) *
                           ((w8 + TC - 1) / TC);
  // One block per SM (its shared memory takes the SM): each channel group
  // gets a third of the SMs, and every block walks tiles until none is left.
  long long per_group = nsm / GROUPS > 0 ? nsm / GROUPS : 1;
  if (per_group > ntiles) per_group = ntiles;
  const dim3 grid((unsigned)per_group, GROUPS);
  stem_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w4), bias,
      static_cast<__nv_bfloat16*>(out), nb, h8, w8);
  return (int)cudaGetLastError();
}
