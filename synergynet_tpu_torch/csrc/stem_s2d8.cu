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
// The f32 entry: the same function on f32 frames, taps and output, with an
// f32 accumulator, as the JAX Pallas stem computes on an f32 input.
//
// What bounds it: the same 462 GFLOP at B = 128 frames, now f32-accurate.
// One TF32 pass keeps 10 of the 23 mantissa bits, ~1e-3 of each product,
// which breaks f32 parity; on the FMA units (67 TFLOP/s) the work takes
// 6.9 ms. The tensor cores give f32-accurate products in three TF32 passes
// (3xTF32): with a_hi = tf32(a) and a_lo = tf32(a - a_hi) (a - a_hi is exact
// in f32), a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the dropped a_lo.b_lo
// and the roundings of the lo parts leaving ~3 x 2^-22 of each product. At
// 495 / 3 TFLOP/s that bounds B = 128 at 2.80 ms; the 1.5 GB of HBM
// traffic take 0.45.
//
// Design: stem_kernel's persistent TMA ring and pool, retiled for 4-byte
// values. A block owns 8 of the 48 pooled channels (32 conv channels, all
// four phases of each), so six channel groups, and walks 15 x 17 output
// tiles, the 16 x 18 conv window a (288 x 768) x (768 x 32) product with
// mma.sync m16n8k8 tf32 -> f32, three MMAs (lo.hi, hi.lo, hi.hi) a pair.
// - The shared-memory budget sets the tiling. The block's 768 x 32 f32
//   taps stay resident (98,304 B), in rows of one conv channel, k
//   contiguous, 16-byte pieces XOR-swizzled, so that ldmatrix (8 rows of
//   16 bytes = 4 f32 each) gives the col-major B fragment without a
//   transpose. 64 conv channels would take 196,608 B and leave no ring;
//   taps streamed with the window could not be laid out k-contiguous by
//   TMA. The cost: each window is read 6 times from L2 instead of 3.
// - The window streams in six 32-channel K-chunks (17 x 19 x 128 bytes =
//   41,344 B, the 128-byte swizzle's row) through a ring of three slots,
//   each slot filled twice a tile, one TMA load of the f32 tensor map per
//   chunk; chunk c+3 loads as soon as every warp has multiplied chunk c, so
//   two chunks are in flight under the products, and the next tile's first
//   two load under this tile's last two. The A fragment (m16 x k8 f32) is
//   one ldmatrix x4 from the swizzled window, conflict-free.
// - Both operands are split in registers as they leave shared memory, not
//   on the host: the wrapper keeps the (4, 192, 192) taps it is given, with
//   no second tensor to cache per weight version, and every warp splits
//   its window fragments in any case. The split is bound by the rate of
//   instructions, so tf32_rna does cvt.rna.tf32.f32's rounding in two
//   integer operations.
// - The 18 m16 tiles go to 8 warps, two a scheduler: 2 each, and the two
//   left over, each as two n8 pairs, to warps 0-3. Nine warps of 2 tiles
//   would put three on one scheduler, with 1.5x the others' work.
// - The tensor cores truncate the accumulator's low bits at each MMA, so a
//   running sum over a tile's 288 MMAs drifts toward zero by a share of
//   its magnitude that grows with their count; each K-chunk (48 MMAs)
//   sums from zero instead, and is added to the total in f32.
// - The epilogue keeps the f32 conv tile (288 rows x 36 words = 41,472 B)
//   in the last chunk's slot; the pool reads it 16 bytes a lane.
// Shared memory: taps 96 KB + 3 slots x 41 KB (41,984 B each, the larger
// of a chunk and the conv tile rounded to the swizzle's 1 KB) + bias and
// barriers = 220 KB of 227.

constexpr int F_CG = 8;                      // pooled channels per block
constexpr int F_GROUPS = COUT / F_CG;        // 6
constexpr int F_NB = 4 * F_CG;               // conv channels per block: 32
constexpr int F_NT = F_NB / 8;               // n8 tiles: 4
constexpr int F_WARPS = 8;                   // two a scheduler
constexpr int F_THREADS = F_WARPS * 32;
constexpr int F_MT = M / 16;                 // 18 m16 tiles of conv positions
constexpr int F_KC = 32;                     // input channels per K-chunk
constexpr int F_NCHUNK = CIN / F_KC;         // 6 chunks a tile
constexpr int F_SLOTS = 3;                   // ring slots
constexpr int F_CS = F_NB + 4;               // padded f32 row of the conv tile
constexpr int F_W_ROW = KTOT * 4;            // bytes of one conv channel's taps
constexpr int F_W_BYTES = F_NB * F_W_ROW;    // 98,304
constexpr int F_BOX_BYTES = XR * XC * F_KC * 4;  // 41,344: one window chunk
constexpr int F_C_BYTES = M * F_CS * 4;      // 41,472: the conv tile
constexpr int F_SLOT_BYTES =
    ((F_C_BYTES > F_BOX_BYTES ? F_C_BYTES : F_BOX_BYTES) + 1023) / 1024 * 1024;
constexpr int F_OFF_RING = F_W_BYTES;
constexpr int F_OFF_BIAS = F_OFF_RING + F_SLOTS * F_SLOT_BYTES;
constexpr int F_OFF_BAR = F_OFF_BIAS + F_NB * 4;
constexpr int F_SMEM_BYTES = F_OFF_BAR + F_SLOTS * 8 + 1024;
// Per warp, with stamps on: cycles waiting for a chunk (its barrier and the
// block barrier before it), in the products, in epilogue + pool, and in all.
constexpr int F_STAMPS = 4;
static_assert(F_MT == 2 * F_WARPS + 2, "two m16 tiles a warp, two left over");
static_assert(F_NCHUNK % F_SLOTS == 0, "a chunk's slot is ch % F_SLOTS");
static_assert(F_W_BYTES % 1024 == 0, "the ring starts 1024-aligned");
static_assert(F_SMEM_BYTES <= 232448, "fits a block's shared memory");

// cvt.rna.tf32.f32 on the bit pattern: round the magnitude to 10 mantissa
// bits, ties away from zero. Equal to the PTX instruction on finite and
// infinite values (a NaN's lo part stays NaN); ptxas expands the
// instruction to four SASS operations (a NaN test and a select around the
// same add and mask), which the split, bound by the rate of instructions,
// cannot afford.
__device__ __forceinline__ unsigned tf32_rna(unsigned v) {
  return (v + 0x1000u) & 0xFFFFE000u;
}

// f32 bits v -> TF32 operands hi, lo with v ~ hi + lo (v - hi is exact).
__device__ __forceinline__ void split_tf32(unsigned v, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__float_as_uint(__uint_as_float(v) - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of an m16 x k8 tile (ldmatrix x4 at `addr`), split.
__device__ __forceinline__ void load_a(unsigned addr, unsigned* hi,
                                       unsigned* lo) {
  unsigned r[4];
  ldmatrix_x4(addr, r[0], r[1], r[2], r[3]);
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(r[e], hi[e], lo[e]);
}

// The three 3xTF32 products of one (m16, n8) pair into d.
__device__ __forceinline__ void mma_3x(float* d, const unsigned* ah,
                                       const unsigned* al, const unsigned* bh,
                                       const unsigned* bl) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// Channels 32ch .. 32ch+31 of tile t's input window into `slot`.
__device__ __forceinline__ void load_chunk_f32(const CUtensorMap* xmap,
                                               unsigned slot, unsigned bar,
                                               Tile t, int ch) {
  mbar_expect_tx(bar, F_BOX_BYTES);
  tma_load(xmap, slot, bar, ch * F_KC, t.j0 - 2, t.i0 - 2, t.b);
}

// One K-chunk's products of a warp: its two m16 tiles x the four n8 tiles
// into acc and, with XTRA, one of the two left-over m16 tiles x two n8
// tiles into xacc, each through a partial sum from zero (see the header).
// `xi` holds the lane's A row (window position) per tile, `wrow` its B row
// per n16 pair (already at the pair this warp's logical pair 0 maps to).
template <bool XTRA>
__device__ __forceinline__ void chunk_products(
    float (&acc)[2][F_NT][4], float (&xacc)[2][4], unsigned slot,
    const int (&xi)[3], const unsigned (&wrow)[2], int ch, int a_po,
    int b_po, int b_sw) {
  float part[2][F_NT][4] = {};
  float xpart[2][4] = {};
#pragma unroll
  for (int tap = 0; tap < 4; ++tap) {
    // conv(m) reads window position xi + a*XC + b for tap (a, b).
    const int shift = (tap >> 1) * XC + (tap & 1);
    unsigned row[3];
    int sw[3];
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int xa = xi[t] + shift;
      row[t] = slot + xa * (F_KC * 4);
      sw[t] = xa & 7;
    }
    // Pieces (tap*192 + ch*32)/4 + 0..7 of the tap rows: a multiple of 8
    // plus the swizzled 0..7.
    const int wk = (tap * CIN + ch * F_KC) * 4;
#pragma unroll
    for (int kk = 0; kk < F_KC / 8; ++kk) {
      unsigned ah[3][4], al[3][4];
#pragma unroll
      for (int t = 0; t < (XTRA ? 3 : 2); ++t)
        load_a(row[t] + (((2 * kk + a_po) ^ sw[t]) << 4), ah[t], al[t]);
      unsigned bh[F_NT][2], bl[F_NT][2];
#pragma unroll
      for (int np = 0; np < F_NT / 2; ++np) {
        unsigned r[4];
        ldmatrix_x4(wrow[np] + wk + (((2 * kk + b_po) ^ b_sw) << 4), r[0],
                    r[1], r[2], r[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(r[e], bh[2 * np + e / 2][e & 1],
                     bl[2 * np + e / 2][e & 1]);
      }
      // Pair by pair, the MMAs into one accumulator lie 8 apart.
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int n = 0; n < F_NT; ++n)
          mma_tf32(part[t][n], al[t], bh[n][0], bh[n][1]);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int n = 0; n < F_NT; ++n)
          mma_tf32(part[t][n], ah[t], bl[n][0], bl[n][1]);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int n = 0; n < F_NT; ++n)
          mma_tf32(part[t][n], ah[t], bh[n][0], bh[n][1]);
      if (XTRA) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mma_3x(xpart[n], ah[2], al[2], bh[n], bl[n]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int n = 0; n < F_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][n][e] += part[t][n][e];
  if (XTRA) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xacc[n][e] += xpart[n][e];
  }
}

// + bias, ReLU, zero the pool pad (conv row -1, conv column -1) of the
// accumulator fragment of m16 tile mt and n8 tile nt into the conv tile
// s_c[m * F_CS + n].
__device__ __forceinline__ void store_conv(float* s_c, const float* s_bias,
                                           const float* d, int mt, int nt,
                                           int lane, Tile cur) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = mt * 16 + (lane >> 2) + half * 8;
    const int n = nt * 8 + (lane & 3) * 2;
    const int rr = m / CC, cc = m % CC;
    const bool pad = (cur.i0 - 1 + rr < 0) || (cur.j0 - 1 + cc < 0);
    float v0 = fmaxf(d[2 * half] + s_bias[n], 0.0f);
    float v1 = fmaxf(d[2 * half + 1] + s_bias[n + 1], 0.0f);
    if (pad) v0 = v1 = 0.0f;
    *reinterpret_cast<float2*>(s_c + m * F_CS + n) = make_float2(v0, v1);
  }
}

// STAMP: lane 0 of every warp adds clock64 intervals into
// stamps[(block * F_WARPS + warp) * F_STAMPS + ...] (block = y*gridDim.x + x).
template <bool STAMP>
__global__ void __launch_bounds__(F_THREADS, 1)
stem_kernel_f32(const __grid_constant__ CUtensorMap xmap,
                const float* __restrict__ w4, const float* __restrict__ bias,
                float* __restrict__ out, int nb, int h8, int w8,
                unsigned long long* __restrict__ stamps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(smem_raw) + 1023) & ~size_t(1023));
  float* s_bias = reinterpret_cast<float*>(smem + F_OFF_BIAS);
  const unsigned ring = smem_addr(smem + F_OFF_RING);
  const unsigned full = smem_addr(smem + F_OFF_BAR);   // a barrier per slot
  // The conv tile takes the last chunk's slot once every warp has read it.
  float* s_c = reinterpret_cast<float*>(smem + F_OFF_RING +
                                        (F_SLOTS - 1) * F_SLOT_BYTES);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = blockIdx.y;                     // pooled channels 8g..8g+7
  const int ntr = (h8 + TR - 1) / TR, ntc = (w8 + TC - 1) / TC;
  const int ntiles = nb * ntr * ntc;
  long long t_all = 0, t_wait = 0, t_mma = 0, t_tail = 0, t0 = 0;
  if (STAMP) t_all = clock64();

  int tile = blockIdx.x;
  if (tid == 0) {
    for (int s = 0; s < F_SLOTS; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int ch = 0; ch < F_SLOTS && tile < ntiles; ++ch)
      load_chunk_f32(&xmap, ring + ch * F_SLOT_BYTES, full + 8 * ch,
                     tile_at(tile, ntr, ntc), ch);
  }
  // Row n = ph*8 + o holds conv channel ph*48 + 8g + o: its taps k =
  // tap*192 + cin, 16-byte piece p = k/4 at n*F_W_ROW + ((p ^ (n&7)) << 4).
  // Four items a thread at a time, their eight 16-byte loads in flight.
#pragma unroll 1
  for (int i0 = tid; i0 < KTOT * 4; i0 += 4 * F_THREADS) {
    float4 v[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * F_THREADS;
      if (i < KTOT * 4) {
        const float4* src = reinterpret_cast<const float4*>(
            w4 + (size_t)(i >> 2) * (4 * COUT) + (i & 3) * COUT + g * F_CG);
        v[u][0] = src[0];
        v[u][1] = src[1];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * F_THREADS;
      if (i < KTOT * 4) {
        const int k = i >> 2, ph = i & 3;
        const float* f = reinterpret_cast<const float*>(v[u]);
#pragma unroll
        for (int o = 0; o < 8; ++o)
          *reinterpret_cast<float*>(smem + (ph * 8 + o) * F_W_ROW +
                                    (((k >> 2) ^ o) << 4) + (k & 3) * 4) = f[o];
      }
    }
  }
  if (tid < F_NB) s_bias[tid] = bias[(tid >> 3) * COUT + g * F_CG + (tid & 7)];
  __syncthreads();   // taps, bias and barriers are ready

  // Work split, balanced over the SM's four schedulers (warp w runs on
  // scheduler w % 4): warp w takes m16 tiles 2w and 2w+1 with all four n8
  // tiles; warps 0-3 also take left-over m16 tile 16 + (w >> 1) with the
  // n8 pair w & 1. A warp reads its B pairs in the order (np ^ (w & 1)),
  // so that the left-over pair is its logical pair 0.
  // Per-lane ldmatrix rows. A (m16 x k8, row-major): conv position m =
  // mt*16 + (lane & 7) + 8*((lane >> 3) & 1), piece offset lane >> 4, so
  // the four matrices are a0..a3. B (k8 x n8, col-major, from the n rows):
  // n = (lane & 7) + 8*(lane >> 4) of each n16 pair, piece offset
  // (lane >> 3) & 1, so the four matrices are b0, b1 of two n8 tiles.
  const bool xtra = warp < (F_MT - 2 * F_WARPS) * 2;
  const int flip = warp & 1;
  int xi[3];
  for (int t = 0; t < 3; ++t) {
    const int mt = t < 2 ? 2 * warp + t : (xtra ? 2 * F_WARPS + (warp >> 1)
                                               : 0);
    const int m = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    xi[t] = (m / CC) * XC + (m % CC);
  }
  const int a_po = lane >> 4, b_po = (lane >> 3) & 1, b_sw = lane & 7;
  unsigned wrow[2];
  for (int np = 0; np < 2; ++np)
    wrow[np] = smem_addr(smem) +
               (((np ^ flip) * 16) + (lane & 7) + (lane >> 4) * 8) * F_W_ROW;

  for (unsigned use = 0; tile < ntiles; tile += gridDim.x, ++use) {
    const Tile cur = tile_at(tile, ntr, ntc);
    const int next = tile + gridDim.x;
    const Tile nxt = tile_at(next < ntiles ? next : tile, ntr, ntc);

    float acc[2][F_NT][4] = {};
    float xacc[2][4] = {};
#pragma unroll 1
    for (int ch = 0; ch < F_NCHUNK; ++ch) {
      if (STAMP) t0 = clock64();
      // Chunk q of this block's sequence is slot q % 3's (q / 3)-th load.
      const unsigned q = use * F_NCHUNK + ch;
      const int s = ch % F_SLOTS;
      mbar_wait(full + 8 * s, (q / F_SLOTS) & 1);
      if (ch > 0) {
        // Every warp is done with chunk ch-1: its slot takes chunk
        // ch-1+3, of this tile or of the next (the next tile's last slot
        // loads after the pool, which reads the conv tile there).
        __syncthreads();
        const int c = ch - 1 + F_SLOTS;
        const unsigned prev = ring + ((ch - 1) % F_SLOTS) * F_SLOT_BYTES;
        const unsigned pbar = full + 8 * ((ch - 1) % F_SLOTS);
        if (tid == 0) {
          if (c < F_NCHUNK)
            load_chunk_f32(&xmap, prev, pbar, cur, c);
          else if (next < ntiles)
            load_chunk_f32(&xmap, prev, pbar, nxt, c - F_NCHUNK);
        }
      }
      if (STAMP) {
        const long long t1 = clock64();
        t_wait += t1 - t0;
        t0 = t1;
      }
      const unsigned slot = ring + s * F_SLOT_BYTES;
      if (xtra)
        chunk_products<true>(acc, xacc, slot, xi, wrow, ch, a_po, b_po,
                             b_sw);
      else
        chunk_products<false>(acc, xacc, slot, xi, wrow, ch, a_po, b_po,
                              b_sw);
      if (STAMP) t_mma += clock64() - t0;
    }
    if (STAMP) t0 = clock64();
    __syncthreads();   // every warp is done reading the last chunk

    // Logical n8 tile n of this warp is n ^ 2*flip.
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int n = 0; n < F_NT; ++n)
        store_conv(s_c, s_bias, acc[t][n], 2 * warp + t, n ^ (2 * flip), lane,
                   cur);
    if (xtra) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
        store_conv(s_c, s_bias, xacc[n], 2 * F_WARPS + (warp >> 1),
                   n ^ (2 * flip), lane, cur);
    }
    __syncthreads();

    // Pool: as stem_kernel's, a lane taking 4 channels (16 bytes) of one
    // output; rows 144 bytes apart keep each 8-lane access phase
    // conflict-free.
    for (int i = tid; i < POOL_ITEMS; i += F_THREADS) {
      const int pos = (i >> 5) * 16 + (i & 15), half = (i >> 4) & 1;
      const int ii = pos / TC, jj = pos - ii * TC;
      const int oi = cur.i0 + ii, oj = cur.j0 + jj;
      if (pos >= TR * TC || oi >= h8 || oj >= w8) continue;
      const float* c = s_c + half * 4;
      auto at = [&](int ph, int r, int col) {
        return *reinterpret_cast<const float4*>(c + (r * CC + col) * F_CS +
                                                ph * F_CG);
      };
      const float4 cand[9] = {at(2, ii, jj + 1),     at(0, ii + 1, jj + 1),
                              at(2, ii + 1, jj + 1), at(3, ii, jj + 1),
                              at(1, ii + 1, jj + 1), at(3, ii + 1, jj + 1),
                              at(3, ii, jj),         at(1, ii + 1, jj),
                              at(3, ii + 1, jj)};
      float4 v = cand[0];
#pragma unroll
      for (int k = 1; k < 9; ++k) {
        v.x = fmaxf(v.x, cand[k].x);
        v.y = fmaxf(v.y, cand[k].y);
        v.z = fmaxf(v.z, cand[k].z);
        v.w = fmaxf(v.w, cand[k].w);
      }
      *reinterpret_cast<float4*>(out + (((size_t)cur.b * h8 + oi) * w8 + oj) *
                                           COUT + g * F_CG + half * 4) = v;
    }
    // The conv tile's generic writes come before the next TMA write into
    // its slot, and the pool is done with it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0 && next < ntiles)
      load_chunk_f32(&xmap, ring + (F_SLOTS - 1) * F_SLOT_BYTES,
                     full + 8 * (F_SLOTS - 1), nxt, F_SLOTS - 1);
    if (STAMP) t_tail += clock64() - t0;
  }
  if (STAMP && lane == 0) {
    unsigned long long* st =
        stamps + ((blockIdx.y * gridDim.x + blockIdx.x) * F_WARPS + warp) *
                     F_STAMPS;
    st[0] = t_wait;
    st[1] = t_mma;
    st[2] = t_tail;
    st[3] = clock64() - t_all;
  }
}

// x as a 4-D tensor (C, W8, H8, B) of `esize`-byte values; a box is one
// window chunk, `kc` channels (128 bytes) x 19 columns x 17 rows of one
// frame, with the 128-byte swizzle. Returns a cudaError_t.
int encode_window(CUtensorMap* map, CUtensorMapDataType type, int esize,
                  const void* x, int kc, int nb, int h8, int w8) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)CIN, (cuuint64_t)w8, (cuuint64_t)h8,
                              (cuuint64_t)nb};
  const cuuint64_t strides[3] = {(cuuint64_t)CIN * esize,
                                 (cuuint64_t)w8 * CIN * esize,
                                 (cuuint64_t)h8 * w8 * CIN * esize};
  const cuuint32_t box[4] = {(cuuint32_t)kc, XC, XR, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  if (encode(map, type, 4, const_cast<void*>(x), dims, strides, box, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// One block per SM (its shared memory takes the SM): each of `groups`
// channel groups gets its share of the SMs, and every block walks tiles
// until none is left. Returns a cudaError_t.
int persistent_grid(int groups, int nb, int h8, int w8, dim3* grid) {
  int dev = 0, nsm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = (long long)nb * ((h8 + TR - 1) / TR) *
                           ((w8 + TC - 1) / TC);
  long long per_group = nsm / groups > 0 ? nsm / groups : 1;
  if (per_group > ntiles) per_group = ntiles;
  *grid = dim3((unsigned)per_group, groups);
  return (int)cudaSuccess;
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
  CUtensorMap xmap;
  int err = encode_window(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, KC,
                          nb, h8, w8);
  if (err != (int)cudaSuccess) return err;
  dim3 grid;
  err = persistent_grid(GROUPS, nb, h8, w8, &grid);
  if (err != (int)cudaSuccess) return err;
  err = (int)cudaFuncSetAttribute(
      stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != (int)cudaSuccess) return err;
  stem_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      xmap, static_cast<const __nv_bfloat16*>(w4), bias,
      static_cast<__nv_bfloat16*>(out), nb, h8, w8);
  return (int)cudaGetLastError();
}

// x (nb, h8, w8, 192) f32, w4 (4, 192, 192) f32, bias (192,) f32, out
// (nb, h8, w8, 48) f32: contiguous, 16-byte aligned, on the current device.
// `stamps`, if not null, takes the clock64 stamps of stem_kernel_f32
// (F_STAMPS per warp, F_WARPS per block, for at most one block per SM:
// room for SMs x 8 x 4 values, zeroed by the caller). Launches on `stream` and
// returns cudaGetLastError() (or the error of building the tensor map).
extern "C" int synergy_stem_s2d8_f32(const float* x, const float* w4,
                                     const float* bias, float* out, int nb,
                                     int h8, int w8,
                                     unsigned long long* stamps,
                                     void* stream) {
  if (nb <= 0 || h8 <= 0 || w8 <= 0) return (int)cudaSuccess;
  CUtensorMap xmap;
  int err = encode_window(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, F_KC,
                          nb, h8, w8);
  if (err != (int)cudaSuccess) return err;
  dim3 grid;
  err = persistent_grid(F_GROUPS, nb, h8, w8, &grid);
  if (err != (int)cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stamps == nullptr) {
    err = (int)cudaFuncSetAttribute(stem_kernel_f32<false>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    F_SMEM_BYTES);
    if (err != (int)cudaSuccess) return err;
    stem_kernel_f32<false><<<grid, F_THREADS, F_SMEM_BYTES, st>>>(
        xmap, w4, bias, out, nb, h8, w8, nullptr);
  } else {
    err = (int)cudaFuncSetAttribute(stem_kernel_f32<true>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    F_SMEM_BYTES);
    if (err != (int)cudaSuccess) return err;
    stem_kernel_f32<true><<<grid, F_THREADS, F_SMEM_BYTES, st>>>(
        xmap, w4, bias, out, nb, h8, w8, stamps);
  }
  return (int)cudaGetLastError();
}
