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
// A second entry, synergy_stem_s2d8_f32, takes x, w4 and out in f32 (the
// JAX kernel runs in its input's dtype); its design is at stem_kernel_f32.
//
// Conv channel (2p+q)*48 + o is the stride-4 output phase (p, q) of pooled
// channel o. Over x padded by one zero row on top and one zero column on the
// left (F.pad(x, (1, 0, 1, 0))), conv(r, c) = sum over taps (a, b) of
// x[r+a-1, c+b-1] . w4[2a+b], accumulated in f32, + bias, ReLU. Pooled
// output (i, j) is the max over conv rows {(i-1, p1), (i, p0), (i, p1)} x
// conv columns {(j-1, q1), (j, q0), (j, q1)}; conv row or column -1 counts
// as 0, which is exact past the ReLU. The result is rounded to bf16 once.
//
// What bounds it on this card: one 720x1088 frame is 90 x 136 positions x
// (4 taps x 192 x 192) MACs = 3.61 GFLOP against 4.7 MB in and 1.2 MB out
// (5.9 MB of HBM traffic): ~610 FLOP per byte, twice the H100's bf16 ridge
// of ~295, so the products bound it and they go to the tensor cores (462
// GFLOP at B = 128 frames, 0.468 ms at 989 TFLOP/s). The tensor cores
// wait on everything else: a tile's window load if it precedes the
// products, the issue slots that per-thread copies and their address
// arithmetic take from them, and the epilogue and pool. The design below
// removes the first two; the epilogue and pool still stall them.
//
// Design: a block owns 16 of the 48 pooled channels (so 64 conv channels,
// all four phases of each, which the pool needs), stages that slice of the
// weights in shared memory once (768 x 64 bf16 = 96 KB; the whole 288 KB
// would not fit the 227 KB a block can use) and walks output tiles of 15 x 17
// positions (W8 = 136 = 8 x 17, H8 = 90 = 6 x 15) on a persistent grid, one
// block per SM, recomputing the 16 x 18 conv window (one halo row and
// column, 13% more products) as a (288 x 768) x (768 x 64) product with
// mma.sync m16n8k16 bf16 -> f32 fed by ldmatrix from XOR-swizzled rows
// (conflict-free), two m16 tiles a warp.
// - Loads overlap the products. The 17 x 19 input window streams in three
//   64-channel K-chunks (17 x 19 x 64 bf16 = 41 KB) through a ring of three
//   slots, chunk c of every tile in slot c, each slot with an mbarrier that
//   the TMA unit completes. One thread issues each chunk as one TMA load
//   from a 4-D tensor map over (C, W8, H8, B) with box {64, 19, 17, 1} and
//   the 128-byte swizzle, which is the XOR layout the ldmatrix reads; the
//   window's rows and columns outside the frame, the top and left halo
//   included, arrive as zeros. As soon as every warp has multiplied chunk c
//   of this tile, the next tile's chunk c starts loading into its slot, so
//   two of the next tile's chunks load while this tile's last chunk
//   multiplies and its epilogue runs, and the third while the next tile's
//   first two multiply.
// - The epilogue adds the bias, applies ReLU, zeroes the pool's top and left
//   pad and keeps the conv tile in shared memory as bf16, in the third
//   slot; the pool takes bf16 maxes from there, 16 bytes a lane. Rounding to
//   nearest is monotonic, so max(round(x)) = round(max(x)): the output is
//   exactly the f32 pool rounded once. The 4x-phase activation never
//   reaches HBM.
// Shared memory: weights 96 KB + 3 slots x 41 KB (each the larger of a
// window chunk, 41,344 B, and the bf16 conv tile, 288 rows x 144 B =
// 41,472 B, rounded to the swizzle's 1 KB) + bias and barriers = 220 KB of
// 227. cuTensorMapEncodeTiled comes from libcuda.so.1, which the CUDA
// runtime has loaded, through dlopen/dlsym, so the build needs no -lcuda.
//
// Tried and not kept: the three channel-group blocks as a thread block
// cluster sharing each window chunk by TMA multicast, multiplying with
// wgmma m64n64k16 (A from ldmatrix registers, since the tap shift breaks
// wgmma's canonical A layout; B the resident weights), ran slower than
// this design at 128 frames on the H100: with N = 64 per block, the A
// fragments and B's descriptor reads take the whole shared-memory bandwidth
// at the tensor cores' rate, and its epilogue stalled both warpgroups.
// Each block here reads its own window, three reads of each input byte
// that the L2 serves under the products.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

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
constexpr int MT = 2;                    // m16 tiles per warp
constexpr int WARPS = M / 16 / MT;       // 9
constexpr int THREADS = WARPS * 32;
constexpr int KC = 64;                   // input channels per K-chunk
constexpr int NCHUNK = CIN / KC;         // 3 chunks, one ring slot each
constexpr int CS = NB + 8;               // padded bf16 row of the conv tile
// Pool work items: two 8-channel halves of each output, 16 outputs a warp.
constexpr int POOL_ITEMS = (TR * TC + 15) / 16 * 32;

constexpr int W_BYTES = KTOT * NB * 2;           // 98,304
constexpr int BIAS_BYTES = NB * 4;               // 256
constexpr int BOX_BYTES = XR * XC * KC * 2;      // 41,344: one window chunk
constexpr int C_BYTES = M * CS * 2;              // 41,472: the conv tile
// The 128-byte swizzle repeats every 1024 bytes: slots start 1024-aligned.
constexpr int SLOT_BYTES =
    ((C_BYTES > BOX_BYTES ? C_BYTES : BOX_BYTES) + 1023) / 1024 * 1024;
constexpr int OFF_RING = W_BYTES;
constexpr int OFF_BIAS = OFF_RING + NCHUNK * SLOT_BYTES;
constexpr int OFF_BAR = OFF_BIAS + BIAS_BYTES;
constexpr int SMEM_BYTES = OFF_BAR + NCHUNK * 8 + 1024;  // + base alignment
static_assert(W_BYTES % 1024 == 0, "the ring starts 1024-aligned");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;   // 0 bytes read: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// Spin until the barrier's phase with this parity completes. A wait that
// lasts seconds traps (the launch fails with an error) instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned long long start = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (start == 0)
      start = now;
    else if (now - start > 4000000000ull)
      __trap();
  }
}

// The box at (channel c0, column, row, frame) of the tensor map into `dst`,
// completing `bar`; the box's parts outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, unsigned dst,
                                         unsigned bar, int c0, int col,
                                         int row, int frame) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(col),
      "r"(row), "r"(frame), "r"(bar) : "memory");
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

// Shared memory layouts (byte offsets), 16-byte pieces XOR-swizzled so that
// the 8 rows an ldmatrix phase reads fall in 8 different bank groups:
//   weights  row k (0..767), piece nc (0..7):  k*128 + ((nc ^ (k & 7)) << 4)
//   window   chunk slot, position xi = row*XC + col, piece kc (0..7):
//            xi*128 + ((kc ^ (xi & 7)) << 4), which is the layout TMA's
//            128-byte swizzle writes for a box of 128-byte rows

struct Tile {
  int b, i0, j0;
};

__device__ __forceinline__ Tile tile_at(int tile, int ntr, int ntc) {
  const int b = tile / (ntr * ntc);
  const int rem = tile - b * ntr * ntc;
  return {b, (rem / ntc) * TR, (rem % ntc) * TC};
}

// Channels 64ch .. 64ch+63 of the input window of tile t (rows i0-2 ..
// i0+14, columns j0-2 .. j0+16; zero outside the frame) into `slot`.
__device__ __forceinline__ void load_chunk(const CUtensorMap* xmap,
                                           unsigned slot, unsigned bar,
                                           Tile t, int ch) {
  mbar_expect_tx(bar, BOX_BYTES);
  tma_load(xmap, slot, bar, ch * KC, t.j0 - 2, t.i0 - 2, t.b);
}

__global__ void __launch_bounds__(THREADS, 1)
stem_kernel(const __grid_constant__ CUtensorMap xmap,
            const __nv_bfloat16* __restrict__ w4,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
            int nb, int h8, int w8) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(smem_raw) + 1023) & ~size_t(1023));
  unsigned char* s_w = smem;
  float* s_bias = reinterpret_cast<float*>(smem + OFF_BIAS);
  const unsigned ring = smem_addr(smem + OFF_RING);
  const unsigned full = smem_addr(smem + OFF_BAR);   // a barrier per slot
  // The conv tile takes the last chunk's slot once every warp has read it.
  __nv_bfloat16* s_c = reinterpret_cast<__nv_bfloat16*>(
      smem + OFF_RING + (NCHUNK - 1) * SLOT_BYTES);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = blockIdx.y;                     // pooled channels 16g..16g+15
  const int ntr = (h8 + TR - 1) / TR, ntc = (w8 + TC - 1) / TC;
  const int ntiles = nb * ntr * ntc;

  // Thread 0 issues every window load; the first tile's three chunks load
  // while the block stages its weight slice.
  int tile = blockIdx.x;
  if (tid == 0) {
    for (int ch = 0; ch < NCHUNK; ++ch) mbar_init(full + 8 * ch, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int ch = 0; ch < NCHUNK && tile < ntiles; ++ch)
      load_chunk(&xmap, ring + ch * SLOT_BYTES, full + 8 * ch,
                 tile_at(tile, ntr, ntc), ch);
  }
  // Block n = ph*16 + o holds conv channel ph*48 + 16g + o.
  for (int i = tid; i < KTOT * (NB / 8); i += THREADS) {
    const int k = i >> 3, nc = i & 7;
    const __nv_bfloat16* src =
        w4 + (size_t)k * (4 * COUT) + (nc >> 1) * COUT + g * CG + (nc & 1) * 8;
    cp_async16(smem_addr(s_w + k * 128 + ((nc ^ (k & 7)) << 4)), src, true);
  }
  if (tid < NB) s_bias[tid] = bias[(tid >> 4) * COUT + g * CG + (tid & 15)];
  cp_async_wait_all();
  __syncthreads();   // weights, bias and barriers are ready

  // Per-lane ldmatrix rows. A: conv position m = mt*16 + (lane & 15) of this
  // warp's two m16 tiles, input piece offset (lane >> 4). B: k row
  // (lane & 7) + 8*((lane >> 3) & 1) of the k16 step, n piece
  // 2*np + (lane >> 4).
  int xi0[MT];
  for (int t = 0; t < MT; ++t) {
    const int m = (MT * warp + t) * 16 + (lane & 15);
    xi0[t] = (m / CC) * XC + (m % CC);
  }
  const int a_hi = lane >> 4;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8;
  const unsigned w_base = smem_addr(s_w) + b_k * 128;
  const int gid = lane >> 2, tig = lane & 3;

  for (unsigned use = 0; tile < ntiles; tile += gridDim.x, ++use) {
    const Tile cur = tile_at(tile, ntr, ntc);
    const int next = tile + gridDim.x;
    const Tile nxt = tile_at(next < ntiles ? next : tile, ntr, ntc);

    float acc[MT][8][4];
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][n][e] = 0.0f;

#pragma unroll 1
    for (int ch = 0; ch < NCHUNK; ++ch) {
      // Each slot's barrier completes once per tile.
      mbar_wait(full + 8 * ch, use & 1);
      if (ch > 0) {
        // Every warp is done with chunk ch-1: its slot takes the next
        // tile's chunk ch-1.
        __syncthreads();
        if (tid == 0 && next < ntiles)
          load_chunk(&xmap, ring + (ch - 1) * SLOT_BYTES, full + 8 * (ch - 1),
                     nxt, ch - 1);
      }
      // conv(m) reads window position xi0 + a*XC + b for tap (a, b).
      const unsigned slot = ring + ch * SLOT_BYTES;
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const int shift = (tap >> 1) * XC + (tap & 1);
        unsigned row[MT];
        int sw[MT];
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          const int xa = xi0[t] + shift;
          row[t] = slot + xa * (KC * 2);
          sw[t] = xa & 7;
        }
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          const int kc = kk * 2 + a_hi;
          unsigned fa[MT][4];
#pragma unroll
          for (int t = 0; t < MT; ++t)
            ldmatrix_x4(row[t] + ((kc ^ sw[t]) << 4), fa[t][0], fa[t][1],
                        fa[t][2], fa[t][3]);
          const unsigned wrow = w_base + (tap * CIN + ch * KC + kk * 16) * 128;
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            unsigned b0, b1, b2, b3;
            const int nc = 2 * np + a_hi;
            ldmatrix_x4_trans(wrow + ((nc ^ (lane & 7)) << 4), b0, b1, b2,
                              b3);
#pragma unroll
            for (int t = 0; t < MT; ++t) {
              mma_bf16(acc[t][2 * np], fa[t], b0, b1);
              mma_bf16(acc[t][2 * np + 1], fa[t], b2, b3);
            }
          }
        }
      }
    }
    __syncthreads();   // every warp is done reading the last chunk

    // + bias, ReLU, zero the pool pad (conv row -1, conv column -1), and
    // keep the bf16 conv tile in shared memory: s_c[m * CS + n].
#pragma unroll
    for (int t = 0; t < MT; ++t) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = (MT * warp + t) * 16 + gid + half * 8;
        const int rr = m / CC, cc = m % CC;
        const bool pad = (cur.i0 - 1 + rr < 0) || (cur.j0 - 1 + cc < 0);
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int n = n8 * 8 + tig * 2;
          float v0 = fmaxf(acc[t][n8][2 * half] + s_bias[n], 0.0f);
          float v1 = fmaxf(acc[t][n8][2 * half + 1] + s_bias[n + 1], 0.0f);
          if (pad) v0 = v1 = 0.0f;
          *reinterpret_cast<__nv_bfloat162*>(s_c + m * CS + n) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncthreads();

    // Pool: output (ii, jj) of the tile reads conv rows ii (p1) and ii+1
    // (p0, p1), conv columns jj (q1) and jj+1 (q0, q1) of the conv tile. A
    // lane takes 8 channels (16 bytes) of one output; lanes 0-15 and 16-31
    // of a warp take the two halves of the same 16 outputs, so the 8 lanes
    // of each 16-byte access phase read rows 144 bytes apart, conflict-free.
    for (int i = tid; i < POOL_ITEMS; i += THREADS) {
      const int pos = (i >> 5) * 16 + (i & 15), half = (i >> 4) & 1;
      const int ii = pos / TC, jj = pos - ii * TC;
      const int oi = cur.i0 + ii, oj = cur.j0 + jj;
      if (pos >= TR * TC || oi >= h8 || oj >= w8) continue;
      const __nv_bfloat16* c = s_c + half * 8;
      auto at = [&](int ph, int r, int col) {
        return *reinterpret_cast<const uint4*>(c + (r * CC + col) * CS +
                                               ph * CG);
      };
      const uint4 cand[9] = {at(2, ii, jj + 1),     at(0, ii + 1, jj + 1),
                             at(2, ii + 1, jj + 1), at(3, ii, jj + 1),
                             at(1, ii + 1, jj + 1), at(3, ii + 1, jj + 1),
                             at(3, ii, jj),         at(1, ii + 1, jj),
                             at(3, ii + 1, jj)};
      uint4 v = cand[0];
      __nv_bfloat162* vh = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int k = 1; k < 9; ++k) {
        const __nv_bfloat162* ch = reinterpret_cast<const __nv_bfloat162*>(
            &cand[k]);
#pragma unroll
        for (int e = 0; e < 4; ++e) vh[e] = __hmax2(vh[e], ch[e]);
      }
      *reinterpret_cast<uint4*>(out + (((size_t)cur.b * h8 + oi) * w8 + oj) *
                                          COUT + g * CG + half * 8) = v;
    }
    // The conv tile's generic writes come before the next TMA write into
    // its slot, and the pool is done with it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0 && next < ntiles)
      load_chunk(&xmap, ring + (NCHUNK - 1) * SLOT_BYTES,
                 full + 8 * (NCHUNK - 1), nxt, NCHUNK - 1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// already loaded, so the build needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// ---------------------------------------------------------------------------
// The f32 entry: the same function on f32 frames, taps and output, with f32
// products and an f32 accumulator, as the JAX Pallas stem computes on an f32
// input. TF32 would keep 10 of the 23 mantissa bits, so the products stay on
// the FMA units: at B = 128 frames the 462 GFLOP take at least 6.9 ms at
// the card's 67 TFLOP/s f32 peak, against 0.3 ms for the 4x bytes, so the
// FMA units' rate bounds it. A simple SIMT tiling: a block computes one 8 x 16
// conv tile (7 x 15 pooled outputs with their halo row and column) for 16
// pooled channels (64 conv channels), K streamed in 16-channel chunks of
// the 9 x 17 window and of the four taps' weights through shared memory;
// each thread holds 8 conv rows of one column x 8 conv channels in
// registers, so each k step reads 18 window values and 4 x 8 weights for
// 256 FMAs. The epilogue (+ bias, ReLU, the pool's zero pad) writes the f32
// conv tile into the same shared memory and the pool reads it there: the
// 4x-phase activation never reaches HBM.

constexpr int F_TR = 7, F_TC = 15;          // pooled output tile
constexpr int F_CR = F_TR + 1, F_CC = F_TC + 1;   // conv tile: 8 x 16
constexpr int F_XR = F_TR + 2, F_XC = F_TC + 2;   // input window: 9 x 17
constexpr int F_M = F_CR * F_CC;            // 128 conv positions
constexpr int F_KC = 16;                    // input channels per K-chunk
constexpr int F_XS = F_KC + 1;              // padded window row, in words
constexpr int F_THREADS = F_CC * (NB / 8);  // 16 columns x 8 channel octets
constexpr int F_CS = NB + 1;                // padded conv tile row, in words
constexpr int F_X_WORDS = (F_XR * F_XC * F_XS + 3) / 4 * 4;  // 16-byte end
constexpr int F_W_WORDS = 4 * F_KC * NB;
constexpr int F_C_WORDS = F_M * F_CS;
constexpr int F_SMEM_WORDS = F_X_WORDS + F_W_WORDS > F_C_WORDS
                                 ? F_X_WORDS + F_W_WORDS
                                 : F_C_WORDS;
static_assert(CIN % F_KC == 0, "K-chunks tile the input channels");

__global__ void __launch_bounds__(F_THREADS)
stem_kernel_f32(const float* __restrict__ x, const float* __restrict__ w4,
                const float* __restrict__ bias, float* __restrict__ out,
                int h8, int w8) {
  // Window chunk s_x[pos * F_XS + k] and taps s_w[(tap * F_KC + k) * NB + n]
  // while the products run; the conv tile s_c[m * F_CS + n] after them.
  __shared__ __align__(16) float smem[F_SMEM_WORDS];
  float* s_x = smem;
  float* s_w = smem + F_X_WORDS;
  float* s_c = smem;

  const int tid = threadIdx.x;
  const int col = tid % F_CC;        // this thread's conv column
  const int oct = tid / F_CC;        // its conv channels 8 oct .. 8 oct + 7
  const int g = blockIdx.y;          // pooled channels 16g .. 16g + 15
  const int ntr = (h8 + F_TR - 1) / F_TR, ntc = (w8 + F_TC - 1) / F_TC;
  const int b = blockIdx.x / (ntr * ntc);
  const int rem = blockIdx.x - b * ntr * ntc;
  const int i0 = (rem / ntc) * F_TR, j0 = (rem % ntc) * F_TC;

  float acc[F_CR][8];
#pragma unroll
  for (int r = 0; r < F_CR; ++r)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[r][n] = 0.0f;

#pragma unroll 1
  for (int c0 = 0; c0 < CIN; c0 += F_KC) {
    __syncthreads();   // every thread is done with the previous chunk
    // Window rows i0-2 .. i0+6, columns j0-2 .. j0+14; zero off the frame.
    for (int i = tid; i < F_XR * F_XC * (F_KC / 4); i += F_THREADS) {
      const int pos = i / (F_KC / 4), q = i % (F_KC / 4);
      const int xr = pos / F_XC, xc = pos - xr * F_XC;
      const int r = i0 - 2 + xr, c = j0 - 2 + xc;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r >= 0 && r < h8 && c >= 0 && c < w8)
        v = *reinterpret_cast<const float4*>(
            x + (((size_t)b * h8 + r) * w8 + c) * CIN + c0 + 4 * q);
      float* d = s_x + pos * F_XS + 4 * q;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
    // Block channel n = ph*16 + o is conv channel ph*48 + 16g + o.
    for (int i = tid; i < 4 * F_KC * NB / 4; i += F_THREADS) {
      const int q = i % 4, ph = (i / 4) % 4, tk = i / 16;
      const int tap = tk / F_KC, k = tk % F_KC;
      *reinterpret_cast<float4*>(s_w + tk * NB + ph * CG + 4 * q) =
          *reinterpret_cast<const float4*>(
              w4 + ((size_t)tap * CIN + c0 + k) * (4 * COUT) + ph * COUT +
              g * CG + 4 * q);
    }
    __syncthreads();
    // conv(rr, col) reads window (rr + a, col + b) for tap (a, b).
#pragma unroll 2
    for (int k = 0; k < F_KC; ++k) {
      float a[F_XR][2];
#pragma unroll
      for (int r = 0; r < F_XR; ++r)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb)
          a[r][bb] = s_x[(r * F_XC + col + bb) * F_XS + k];
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const float* wp = s_w + (tap * F_KC + k) * NB + oct * 8;
        const float4 w0 = *reinterpret_cast<const float4*>(wp);
        const float4 w1 = *reinterpret_cast<const float4*>(wp + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int r = 0; r < F_CR; ++r)
#pragma unroll
          for (int n = 0; n < 8; ++n)
            acc[r][n] = fmaf(a[r + (tap >> 1)][tap & 1], wv[n], acc[r][n]);
      }
    }
  }
  __syncthreads();   // the conv tile overwrites the last chunk

  // + bias, ReLU, zero the pool pad (conv row -1, conv column -1).
  float bv[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int nn = oct * 8 + n;
    bv[n] = bias[(nn / CG) * COUT + g * CG + nn % CG];
  }
  const bool pad_col = j0 - 1 + col < 0;
#pragma unroll
  for (int r = 0; r < F_CR; ++r) {
    const bool pad = pad_col || i0 - 1 + r < 0;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      s_c[(r * F_CC + col) * F_CS + oct * 8 + n] =
          pad ? 0.0f : fmaxf(acc[r][n] + bv[n], 0.0f);
  }
  __syncthreads();

  // Pool: output (ii, jj) reads conv rows ii (p1) and ii+1 (p0, p1), conv
  // columns jj (q1) and jj+1 (q0, q1) of the tile; lanes take consecutive
  // channels of one output.
  for (int i = tid; i < F_TR * F_TC * CG; i += F_THREADS) {
    const int o = i % CG, pos = i / CG;
    const int ii = pos / F_TC, jj = pos - ii * F_TC;
    const int oi = i0 + ii, oj = j0 + jj;
    if (oi >= h8 || oj >= w8) continue;
    auto at = [&](int ph, int r, int c) {
      return s_c[(r * F_CC + c) * F_CS + ph * CG + o];
    };
    float v = at(2, ii, jj + 1);
    v = fmaxf(v, at(0, ii + 1, jj + 1));
    v = fmaxf(v, at(2, ii + 1, jj + 1));
    v = fmaxf(v, at(3, ii, jj + 1));
    v = fmaxf(v, at(1, ii + 1, jj + 1));
    v = fmaxf(v, at(3, ii + 1, jj + 1));
    v = fmaxf(v, at(3, ii, jj));
    v = fmaxf(v, at(1, ii + 1, jj));
    v = fmaxf(v, at(3, ii + 1, jj));
    out[(((size_t)b * h8 + oi) * w8 + oj) * COUT + g * CG + o] = v;
  }
}

}  // namespace

// x (nb, h8, w8, 192) bf16, w4 (4, 192, 192) bf16, bias (192,) f32, out
// (nb, h8, w8, 48) bf16: contiguous, 16-byte aligned, on the current
// device. Launches on `stream` and returns cudaGetLastError() (or the
// error of building the input's tensor map).
extern "C" int synergy_stem_s2d8(const void* x, const void* w4,
                                 const float* bias, void* out, int nb, int h8,
                                 int w8, void* stream) {
  if (nb <= 0 || h8 <= 0 || w8 <= 0) return (int)cudaSuccess;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  // x as a 4-D tensor (C, W8, H8, B); a box is one window chunk, 64
  // channels (128 bytes) x 19 columns x 17 rows of one frame.
  CUtensorMap xmap;
  const cuuint64_t dims[4] = {(cuuint64_t)CIN, (cuuint64_t)w8, (cuuint64_t)h8,
                              (cuuint64_t)nb};
  const cuuint64_t strides[3] = {(cuuint64_t)CIN * 2,
                                 (cuuint64_t)w8 * CIN * 2,
                                 (cuuint64_t)h8 * w8 * CIN * 2};
  const cuuint32_t box[4] = {KC, XC, XR, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(x), dims, strides, box, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
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
      xmap, static_cast<const __nv_bfloat16*>(w4), bias,
      static_cast<__nv_bfloat16*>(out), nb, h8, w8);
  return (int)cudaGetLastError();
}

// x (nb, h8, w8, 192) f32, w4 (4, 192, 192) f32, bias (192,) f32, out
// (nb, h8, w8, 48) f32: contiguous, 16-byte aligned, on the current device.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int synergy_stem_s2d8_f32(const float* x, const float* w4,
                                     const float* bias, float* out, int nb,
                                     int h8, int w8, void* stream) {
  if (nb <= 0 || h8 <= 0 || w8 <= 0) return (int)cudaSuccess;
  const long long ntiles = (long long)nb * ((h8 + F_TR - 1) / F_TR) *
                           ((w8 + F_TC - 1) / F_TC);
  if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ntiles, GROUPS);
  stem_kernel_f32<<<grid, F_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w4, bias, out, h8, w8);
  return (int)cudaGetLastError();
}
