// Greedy NMS keep-mask for Hopper (sm_90a), kernel N1.
//
// Not the port of a TPU kernel: the JAX package computes this step in XLA,
// as the fixpoint of masked matrix-vector products under a lax.while_loop
// (synergynet_tpu/detect/nms.py::greedy_nms_mask). N1 is the port's
// counterpart of that loop, so that greedy NMS runs on the device with no
// host read and a CUDA graph can capture it.
//
// For each frame f of nb, over k score-sorted boxes [x1 y1 x2 y2] (f32) and
// a valid flag per box (one byte, 0 or 1): box i is kept iff valid[i] and no
// kept box j < i has IoU(i, j) >= thr, the IoU with the reference's +1
// pixel-inclusive areas. That is the sequential greedy result, which the
// fixpoint reaches (detect/nms.py's module docstring); the two agree bit for
// bit as long as every IoU test decides as the plain twin's
// pairwise_iou(...) >= thr does (below: "The IoU test").
//
// What bounds it on this card. The walk is a chain of dependent keep
// decisions, one per box up to the frame's last valid box (2,048 on the
// serving path): latency, and one warp's instruction stream. The
// suppression bits are ~k^2 / 2 IoU tests a frame (268M at 128 frames of
// 2,048), ~30 instructions each with their share of the row's loads and
// ballots: the instruction issue rate. Their bytes (k^2 / 16 a frame,
// 34.6 MB at 128 frames) are written once and read once, mostly from L2.
//
// Design, two kernels on the caller's stream. Boxes are cut into tiles of
// 64 (T = ceil(k / 64)); row r's suppression word w holds bit c - 64 w for
// each column c > r, in word w, whose IoU with r is >= thr: the boxes that
// r suppresses once kept, the transpose of the fixpoint's A (A[i, j] = iou
// >= thr, j < i, valid[j]; pairwise_iou is symmetric bit for bit). Let L be
// the frame's last valid box and LT = L / 64 its tile. Only tiles t <= LT
// and words t <= w <= LT exist: that is all the walk reads.
//
// Layout of the words (the scratch, CAP = 64 T (T + 1) / 2 words a frame):
// tile t starts at word 64 (t T - t (t - 1) / 2) of its frame and holds its
// W_t = LT - t + 1 words per row in column chunks of up to CW = 32 words
// (chunk j at + 64 CW j, words t + CW j ...), each chunk 64 rows x its
// width, row-major. So a chunk is one contiguous block with no hole, which
// the walk stages with one bulk copy; everything it stages was written.
//
// 1. nms_tile_bits_kernel, one block per (frame, tile t, pair g of words
//    t + 2 g, t + 2 g + 1), over the triangle's (t, g) pairs only, small
//    blocks so that few warps idle where a tile's last pair holds one
//    word: the tile's 64 row boxes go to shared memory; each of 4 warps
//    takes 16 rows, holds the pair's 128 column boxes in registers (four
//    per lane) and, for each valid row, decides the four IoU tests of each
//    lane (the fast path unconditionally, the rare general path behind one
//    warp vote) and gathers the row's two words by four ballots, which
//    lane 0 puts in shared memory. The block's 64 x 2 words are stored row
//    by row. Invalid rows (and rows past k) are stored as zero words;
//    columns past k are zero bits; the diagonal word keeps only c > r.
// 2. nms_tile_walk_kernel, one warp per frame, walks the tiles t = 0 .. LT
//    with the removed-mask of LT + 1 words in shared memory (each word
//    starts as the tile's invalid rows). A ring of STAGES chunk buffers is
//    fed by cp.async.bulk copies (lane 0, one mbarrier per stage), STAGES
//    chunks ahead of the walk, so the device-memory latency is paid once
//    per chunk, behind the chunks before it. For tile t:
//    - resolve: the 64 in-order keep decisions need only the rows' diagonal
//      words, read from the staged chunk by broadcast: R = removed[t]; for
//      i = 0 .. 63, if bit i of R is clear, R |= diag[i]. A diagonal word
//      only sets bits above its row, so bit i of the final R is bit i at
//      step i, and the tile's keep word is ~R: 64 register steps, the only
//      dependent chain left;
//    - then one lane per word ORs the kept rows' words right of the
//      diagonal into removed[]: 64 independent shared-memory loads each.
//    The copies never hold the walk up (2 stages time as 3 or 6 do): each
//    tile is ~1,000 of the warp's instructions, the 64-step chain included.
// Shared memory: the walk takes STAGES x 16 KB + 8 T + 8 STAGES bytes
// (51,224 at MAX_K), above the 48 KB a block gets without an opt-in, so the
// attribute is set once per device at the first call (before any capture:
// the captured programs run their bodies eagerly first).
//
// The IoU test. Each test decides exactly as pairwise_iou(...) >= thr,
// whose operations are, per pair: xx1 = max(x1), yy1 = max(y1), xx2 =
// min(x2), yy2 = min(y2) (NaN-propagating), w = clamp(xx2 - xx1 + 1, 0), h
// likewise, inter = w h, union = (area_a + area_b) - inter, iou = inter /
// union, each rounded to nearest f32 (the _rn intrinsics: nvcc contracts
// nothing into an FMA), compared with >= in f32.
// - The general path is that sequence, with NaN-propagating max, min and
//   clamp. It decides every pair that the fast path does not.
// - The fast path serves pairs of "plain" boxes (all four coordinates
//   finite with |c| <= 2^60) when 2^-126 <= thr <= 1.
//   (a) Its w, h, inter and union equal the general path's bit for bit. No
//   NaN arises (finite operands, and |xx2 - xx1| <= 2^61 cannot overflow),
//   so fminf / fmaxf give the same values as the NaN-propagating forms (a
//   different sign of a zero coordinate cancels in xx2 - xx1 + 1), and
//   fmaxf(x, 0) equals clamp(x, 0) since x = RN(d + 1) is never -0 (an
//   exact zero sum rounds to +0). Every intermediate is finite: w, h <=
//   2^61, inter <= 2^122, |area| <= 2^122, |union| < 2^124.
//   (b) With p = RN(thr union): if p >= 2^-80, p is normal, union > 0, and
//   hi = RN(p (1 + 2^-20)), lo = RN(p (1 - 2^-20)) are normal and finite,
//   so each of the three products has relative error at most 2^-24. Then
//   hi >= thr union (1 + 2^-20)(1 - 2^-24)^2 > thr union, so inter >= hi
//   gives q = inter / union > thr and RN(q) >= thr (RN is monotone and thr
//   is a float): the test is true. And lo <= thr union (1 - 2^-20)(1 +
//   2^-24)^2 < thr union (1 - 2^-21), so inter <= lo gives q < thr (1 -
//   2^-21) < pred(thr) (pred(thr) >= thr (1 - 2^-23) for a normal thr),
//   and RN(q) <= pred(thr) < thr: the test is false. Between lo and hi,
//   and when p < 2^-80, the pair takes the general path. So a pair far
//   from the threshold (no overlap included: inter = 0 <= lo) costs no
//   division and no NaN test.
//   nms.py::iou_at_least is this arithmetic in plain PyTorch; the CPU tests
//   hold it against pairwise_iou(...) >= thr on ties, on pairs one ulp
//   either side of the threshold, and on NaN, inf and huge coordinates.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int WORD = 64;        // boxes a tile, bits a word
constexpr int MAX_K = 16384;
constexpr int MAX_T = MAX_K / WORD;
constexpr int CW = 32;          // words a chunk row (the walk's staging unit)
constexpr int G = 2;            // words a bits block
constexpr int BITS_WARPS = 4;   // each the block's two words x 16 rows
constexpr int BITS_THREADS = 32 * BITS_WARPS;
constexpr int WARP_ROWS = WORD / BITS_WARPS;
constexpr int STAGES = 3;
constexpr int STAGE_WORDS = WORD * CW;                  // 16 KB
constexpr int WALK_SMEM_MAX = 8 * (STAGES * STAGE_WORDS + MAX_T + STAGES);
static_assert(G == 2 && CW % G == 0,
              "a bits block is one word pair, inside one chunk");

// Word offset of tile t in its frame's layout.
__device__ __forceinline__ long long tile_base(int t, int nt) {
  return (long long)WORD * ((long long)t * nt - (long long)t * (t - 1) / 2);
}

// torch.maximum / torch.minimum propagate NaN; fmaxf / fminf drop it.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fminf(a, b);
}

// (x2 - x1 + 1) * (y2 - y1 + 1), each operation rounded.
__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// clamp(x, min=0) as torch computes it: NaN stays NaN.
__device__ __forceinline__ float clamp0(float x) {
  return x < 0.0f ? 0.0f : x;
}

// All four coordinates finite with |c| <= 2^60 (NaN fails the test).
__device__ __forceinline__ bool plain_box(float4 b) {
  const float m = 0x1p60f;
  return fabsf(b.x) <= m && fabsf(b.y) <= m && fabsf(b.z) <= m &&
         fabsf(b.w) <= m;
}

// The fast path (the header's "The IoU test", (a) and (b)) for two plain
// boxes at 2^-126 <= thr <= 1: returns whether it decides IoU(a, b) >= thr
// without dividing, and then sets `yes` to the decision.
__device__ __forceinline__ bool iou_decided(float4 a, float aa, float4 b,
                                            float ba, float thr, bool& yes) {
  const float w = fmaxf(
      __fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.0f), 0.0f);
  const float h = fmaxf(
      __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.0f), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float p = __fmul_rn(thr, __fsub_rn(__fadd_rn(aa, ba), inter));
  const bool above = inter >= __fmul_rn(p, 1.0f + 0x1p-20f);
  const bool below = inter <= __fmul_rn(p, 1.0f - 0x1p-20f);
  yes = above;
  return (p >= 0x1p-80f) & (above | below);
}

// IoU(a, b) >= thr in pairwise_iou's operations, NaN-propagating: the
// general path, right for every pair.
__device__ __forceinline__ bool iou_at_least(float4 a, float aa, float4 b,
                                             float ba, float thr) {
  const float w = clamp0(
      __fadd_rn(__fsub_rn(nan_min(a.z, b.z), nan_max(a.x, b.x)), 1.0f));
  const float h = clamp0(
      __fadd_rn(__fsub_rn(nan_min(a.w, b.w), nan_max(a.y, b.y)), 1.0f));
  const float inter = __fmul_rn(w, h);
  return __fdiv_rn(inter, __fsub_rn(__fadd_rn(aa, ba), inter)) >= thr;
}

__global__ void __launch_bounds__(BITS_THREADS)
nms_tile_bits_kernel(const float4* __restrict__ boxes,
                     const unsigned char* __restrict__ valid,
                     u64* __restrict__ sup, int k, int nt, long long cap,
                     float thr) {
  // blockIdx.x enumerates the (tile, word pair) blocks of the frame's
  // whole triangle, tile by tile: tile t has ceil((nt - t) / G) of them.
  int t = 0, g = blockIdx.x;
  for (;;) {
    const int groups = (nt - t + G - 1) / G;
    if (g < groups) break;
    g -= groups;
    ++t;
  }
  const int f = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ float4 s_box[WORD];
  __shared__ float2 s_ap[WORD];               // area, plain (1) or not (0)
  __shared__ unsigned s_vrows[2];             // the tile's valid rows
  __shared__ u64 s_out[WORD][G];
  __shared__ int s_last[BITS_WARPS];

  // Words w0, w0 + 1; warp i takes rows WARP_ROWS i ..; lane l holds
  // columns 32 q + l of the two words (q = 0, 1 the first, 2, 3 the
  // second). Every load of the block is issued before any is waited on:
  // the valid flags (for the frame's last valid box, which every block
  // finds alike), the tile's row boxes and this lane's column boxes.
  const int w0 = t + g * G;
  const unsigned char* vf = valid + (size_t)f * k;
  const float4* bf = boxes + (size_t)f * k;
  int last = -1;
#pragma unroll 8
  for (int i = tid; i < k; i += BITS_THREADS)
    if (vf[i]) last = i;
  const int r = t * WORD + tid;
  const bool row_in = tid < WORD && r < k;
  const float4 rbox = row_in ? bf[r] : make_float4(0.f, 0.f, 0.f, 0.f);
  const bool row_valid = row_in && vf[r];
  float4 cb[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = w0 * WORD + q * 32 + lane;
    cb[q] = c < k ? bf[c] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) s_last[warp] = last;
  __syncthreads();
  last = s_last[0];
#pragma unroll
  for (int i = 1; i < BITS_WARPS; ++i) last = max(last, s_last[i]);
  const int lt = last < 0 ? -1 : last / WORD;
  if (w0 > lt) return;                      // never read by the walk
  const int nwords = min(G, lt - w0 + 1);
  const bool thr_fast = thr >= 0x1p-126f && thr <= 1.0f;
  if (tid < WORD) {
    s_box[tid] = rbox;
    s_ap[tid] = make_float2(box_area(rbox),
                            thr_fast && plain_box(rbox) ? 1.0f : 0.0f);
    s_out[tid][0] = s_out[tid][1] = 0;      // invalid rows stay zero
    const unsigned vb = __ballot_sync(0xffffffffu, row_valid);
    if (lane == 0) s_vrows[warp] = vb;
  }
  __syncthreads();

  float ca[4];
  bool cin[4], cfast[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    cin[q] = w0 * WORD + q * 32 + lane < k && (q >> 1) < nwords;
    ca[q] = box_area(cb[q]);
    cfast[q] = cin[q] && plain_box(cb[q]);
  }
  const unsigned rows = (WARP_ROWS * warp < 32
                             ? s_vrows[0] >> (WARP_ROWS * warp)
                             : s_vrows[1] >> (WARP_ROWS * warp - 32)) &
                        (~0u >> (32 - WARP_ROWS));
#pragma unroll 2
  for (int ii = 0; ii < WARP_ROWS; ++ii) {
    if (!((rows >> ii) & 1u)) continue;     // uniform across the warp
    const int i = WARP_ROWS * warp + ii;
    const float4 rb = s_box[i];
    const float2 ap = s_ap[i];
    // The fast path on all four pairs, unconditionally (no branch between
    // them); its answers count where it settles a pair of plain boxes.
    bool yes[4], open[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bool y;
      const bool settled = (ap.y != 0.0f) & cfast[q] &
                           iou_decided(rb, ap.x, cb[q], ca[q], thr, y);
      yes[q] = settled & y;
      open[q] = cin[q] & !settled;
    }
    // Near the threshold, or a box that is not plain: rare.
    if (__any_sync(0xffffffffu, open[0] | open[1] | open[2] | open[3])) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (open[q]) yes[q] = iou_at_least(rb, ap.x, cb[q], ca[q], thr);
    }
    u64 wa = (u64)__ballot_sync(0xffffffffu, yes[0]) |
             (u64)__ballot_sync(0xffffffffu, yes[1]) << 32;
    const u64 wb = (u64)__ballot_sync(0xffffffffu, yes[2]) |
                   (u64)__ballot_sync(0xffffffffu, yes[3]) << 32;
    if (w0 == t) wa &= i == WORD - 1 ? 0ull : ~0ull << (i + 1);  // diagonal
    if (lane == 0) {
      s_out[i][0] = wa;
      s_out[i][1] = wb;
    }
  }
  __syncthreads();

  // Rows of this chunk are `width` words long; the block's words start at
  // column `col` of chunk `j`.
  const int j = (w0 - t) / CW, col = (w0 - t) % CW;
  const int width = min(CW, lt - t + 1 - j * CW);
  u64* dst = sup + (size_t)f * cap + tile_base(t, nt) +
             (long long)WORD * CW * j + col;
  for (int e = tid; e < WORD * nwords; e += BITS_THREADS) {
    const int r = e / nwords, c = e % nwords;
    dst[(size_t)r * width + c] = s_out[r][c];
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global memory into shared memory, completing `bar` with the bytes.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar) : "memory");
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

__global__ void __launch_bounds__(32)
nms_tile_walk_kernel(const u64* __restrict__ sup,
                     const unsigned char* __restrict__ valid,
                     unsigned char* __restrict__ keep, int k, int nt,
                     long long cap) {
  extern __shared__ __align__(128) u64 smem[];
  u64* ring = smem;                                  // STAGES chunks
  u64* removed = ring + STAGES * STAGE_WORDS;        // nt words
  u64* bars = removed + nt;                          // STAGES mbarriers
  const int f = blockIdx.x, lane = threadIdx.x;
  const unsigned char* vf = valid + (size_t)f * k;
  unsigned char* kf = keep + (size_t)f * k;

  // Each tile's removed word starts as its invalid rows (and rows past k);
  // lane l reads tiles l, l + 32, ... whole, 64 loads in flight.
  int last = -1;
  for (int t = lane; t < nt; t += 32) {
    u64 vb = 0;
#pragma unroll
    for (int i = 0; i < WORD; ++i) {
      const int r = t * WORD + i;
      if (r < k && vf[r]) vb |= 1ull << i;
    }
    removed[t] = ~vb;
    if (vb) last = t * WORD + 63 - __clzll(vb);
  }
  last = __reduce_max_sync(0xffffffffu, last);
  const int lt = last < 0 ? -1 : last / WORD;
  if (lane == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_addr(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // The chunk sequence: tile t = 0 .. lt, chunk j of its W_t = lt - t + 1
  // words; the producer cursor (pt, pj) runs STAGES chunks ahead.
  const u64* sf = sup + (size_t)f * cap;
  int pt = 0, pj = 0;
  auto issue = [&](int slot) {
    if (pt > lt) return;
    const int width = min(CW, lt - pt + 1 - pj * CW);
    if (lane == 0)
      bulk_load(smem_addr(ring + slot * STAGE_WORDS),
                sf + tile_base(pt, nt) + (long long)WORD * CW * pj,
                8u * WORD * width, smem_addr(bars + slot));
    if (++pj * CW >= lt - pt + 1) {
      ++pt;
      pj = 0;
    }
  };
  for (int s = 0; s < STAGES; ++s) issue(s);

  int n = 0;
  for (int t = 0; t <= lt; ++t) {
    u64 keepw = 0;
    for (int j = 0; j * CW < lt - t + 1; ++j, ++n) {
      const int slot = n % STAGES;
      mbar_wait(smem_addr(bars + slot), (n / STAGES) & 1);
      const u64* c = ring + slot * STAGE_WORDS;
      const int width = min(CW, lt - t + 1 - j * CW);
      if (j == 0) {
        // On 32-bit halves: row i's diagonal word has bits above i only,
        // so rows 32-63 touch the high half alone.
        const u64 r = removed[t];
        unsigned lo = (unsigned)r, hi = (unsigned)(r >> 32);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const u64 d = c[i * width];               // broadcast
          if (!(lo & (1u << i))) {
            lo |= (unsigned)d;
            hi |= (unsigned)(d >> 32);
          }
        }
#pragma unroll
        for (int i = 32; i < WORD; ++i) {
          const unsigned d = (unsigned)(c[i * width] >> 32);
          if (!(hi & (1u << (i - 32)))) hi |= d;
        }
        keepw = ~((u64)hi << 32 | lo);
        const int r0 = t * WORD + lane;
        if (r0 < k) kf[r0] = (keepw >> lane) & 1ull;
        if (r0 + 32 < k) kf[r0 + 32] = (keepw >> (lane + 32)) & 1ull;
      }
      // Words right of the diagonal, one lane each.
      if (lane < width && (j > 0 || lane > 0)) {
        u64 acc = 0;
#pragma unroll
        for (int i = 0; i < WORD; ++i)
          if ((keepw >> i) & 1ull) acc |= c[i * width + lane];
        removed[t + j * CW + lane] |= acc;
      }
      __syncwarp();          // every read of this slot before its refill
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(slot);
    }
  }
  for (int i = WORD * (lt + 1) + lane; i < k; i += 32) kf[i] = 0;
}

int walk_smem_attribute() {
  static volatile int done[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && done[dev]) return (int)cudaSuccess;
  err = cudaFuncSetAttribute(nms_tile_walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WALK_SMEM_MAX);
  if (err == cudaSuccess && dev < 64) done[dev] = 1;
  return (int)err;
}

}  // namespace

// boxes (nb, k, 4) f32 (16-byte aligned), valid (nb, k) bool (one byte
// each), sup the scratch of nb x 64 T (T + 1) / 2 64-bit words (T = ceil(k /
// 64), 16-byte aligned), keep (nb, k) bool out: contiguous, on the current
// device, 1 <= k <= 16384, nb <= 65535. Launches both kernels on `stream`
// and returns the first error (of the shared-memory attribute or a
// launch), or cudaGetLastError(). No allocation, no synchronisation: safe
// inside a CUDA graph capture once a first call has set the attribute.
extern "C" int synergy_nms_greedy(const float* boxes,
                                  const unsigned char* valid, u64* sup,
                                  unsigned char* keep, int nb, int k,
                                  float thr, void* stream) {
  if (k < 0 || k > MAX_K || nb < 0 || nb > 65535)
    return (int)cudaErrorInvalidValue;
  if (nb == 0 || k == 0) return (int)cudaSuccess;
  int err = walk_smem_attribute();
  if (err != (int)cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = (k + WORD - 1) / WORD;
  const long long cap = (long long)WORD * nt * (nt + 1) / 2;
  int groups = 0;                       // (tile, word group) pairs
  for (int t = 0; t < nt; ++t) groups += (nt - t + G - 1) / G;
  nms_tile_bits_kernel<<<dim3(groups, nb), BITS_THREADS, 0, s>>>(
      reinterpret_cast<const float4*>(boxes), valid, sup, k, nt, cap, thr);
  err = (int)cudaGetLastError();
  if (err != (int)cudaSuccess) return err;
  const size_t smem = 8 * ((size_t)STAGES * STAGE_WORDS + nt + STAGES);
  nms_tile_walk_kernel<<<nb, 32, smem, s>>>(sup, valid, keep, k, nt, cap);
  return (int)cudaGetLastError();
}
