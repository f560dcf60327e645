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
// bit as long as every IoU rounds as the plain twin's pairwise_iou does, so
// each one is computed in the twin's operation order with the _rn
// intrinsics (nvcc contracts nothing into an FMA) and compared with >=.
//
// What bounds it on this card: latency. The walk is k dependent steps per
// frame (k = 2,048 on the serving path), each a shared-memory read and a
// branch, plus one row load from device memory per kept box; frames run in
// parallel, one block each. The suppression bits are b * k * k / 8 bytes
// (64 MB at 128 frames of 2,048), written once and read only for kept
// rows.
//
// Design, two kernels on the caller's stream:
// 1. nms_bits_kernel: one thread per (frame, row r, 64-column word): the
//    64 columns' boxes and areas are staged in shared memory, and the
//    thread sets bit c - 64 * word for every column c > r whose IoU with r
//    is >= thr. Row r is the set of boxes that r suppresses once kept, the
//    transpose of the fixpoint's A (A[i, j] = iou >= thr, j < i, valid[j]);
//    pairwise_iou is symmetric bit for bit (max, min and the sum of the two
//    areas commute). Rows of invalid boxes and words left of the diagonal
//    are never read by the walk, and are not written.
// 2. nms_walk_kernel: one warp per frame keeps the removed-bitmask (k / 64
//    words), the valid flags and the keep flags in shared memory and walks
//    i = 0 .. last valid box in order: a valid box that is not removed is
//    kept, and its row's words from i's word on are ORed into the mask.
// The shared memory is sized from k: 8 * ceil(k / 64) + 2 * k bytes, at
// most 34,816 at MAX_K = 16384, under the 48 KB a block takes without an
// opt-in.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int WORD = 64;
constexpr int MAX_K = 16384;

// torch.maximum / torch.minimum propagate NaN; fmaxf / fminf drop it.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fminf(a, b);
}

// (x2 - x1 + 1) * (y2 - y1 + 1), each operation rounded.
__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f),
                   __fadd_rn(__fsub_rn(y2, y1), 1.0f));
}

// clamp(x, min=0) as torch computes it: NaN stays NaN.
__device__ __forceinline__ float clamp0(float x) {
  return x < 0.0f ? 0.0f : x;
}

__global__ void __launch_bounds__(WORD)
nms_bits_kernel(const float* __restrict__ boxes,
                const unsigned char* __restrict__ valid,
                u64* __restrict__ sup, int k, int nw, float thr) {
  const int cb = blockIdx.x, rb = blockIdx.y, f = blockIdx.z;
  if (cb < rb) return;                      // left of the diagonal: unread
  __shared__ float cx1[WORD], cy1[WORD], cx2[WORD], cy2[WORD], carea[WORD];
  const int t = threadIdx.x;
  const float* bf = boxes + (size_t)f * k * 4;
  const int c0 = cb * WORD;
  if (c0 + t < k) {
    const float* b = bf + (size_t)(c0 + t) * 4;
    cx1[t] = b[0];
    cy1[t] = b[1];
    cx2[t] = b[2];
    cy2[t] = b[3];
    carea[t] = box_area(b[0], b[1], b[2], b[3]);
  }
  __syncthreads();
  const int r = rb * WORD + t;
  if (r >= k || !valid[(size_t)f * k + r]) return;   // never read
  const float* b = bf + (size_t)r * 4;
  const float x1 = b[0], y1 = b[1], x2 = b[2], y2 = b[3];
  const float area = box_area(x1, y1, x2, y2);
  const int end = min(WORD, k - c0);
  u64 bits = 0;
  for (int j = (cb == rb ? t + 1 : 0); j < end; ++j) {
    const float w = clamp0(__fadd_rn(
        __fsub_rn(nan_min(x2, cx2[j]), nan_max(x1, cx1[j])), 1.0f));
    const float h = clamp0(__fadd_rn(
        __fsub_rn(nan_min(y2, cy2[j]), nan_max(y1, cy1[j])), 1.0f));
    const float inter = __fmul_rn(w, h);
    const float iou =
        __fdiv_rn(inter, __fsub_rn(__fadd_rn(carea[j], area), inter));
    if (iou >= thr) bits |= 1ull << j;
  }
  sup[((size_t)f * k + r) * nw + cb] = bits;
}

__global__ void __launch_bounds__(32)
nms_walk_kernel(const u64* __restrict__ sup,
                const unsigned char* __restrict__ valid,
                unsigned char* __restrict__ keep, int k, int nw) {
  extern __shared__ u64 smem[];
  u64* removed = smem;                                   // nw words
  unsigned char* vs = reinterpret_cast<unsigned char*>(removed + nw);
  unsigned char* ks = vs + k;
  const int f = blockIdx.x, lane = threadIdx.x;
  const unsigned char* vf = valid + (size_t)f * k;
  for (int w = lane; w < nw; w += 32) removed[w] = 0;
  int last = -1;
  for (int i = lane; i < k; i += 32) {
    const unsigned char v = vf[i] != 0;
    vs[i] = v;
    ks[i] = 0;
    if (v) last = i;
  }
  for (int off = 16; off > 0; off >>= 1)
    last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
  __syncwarp();
  const u64* sf = sup + (size_t)f * k * nw;
  for (int i = 0; i <= last; ++i) {
    // Every lane reads the same words, so the branch is uniform.
    if (!vs[i] || ((removed[i >> 6] >> (i & 63)) & 1ull)) continue;
    __syncwarp();                 // all reads of this step before any write
    const u64* row = sf + (size_t)i * nw;
    for (int w = (i >> 6) + lane; w < nw; w += 32) removed[w] |= row[w];
    if (lane == 0) ks[i] = 1;
    __syncwarp();
  }
  __syncwarp();
  unsigned char* kf = keep + (size_t)f * k;
  for (int i = lane; i < k; i += 32) kf[i] = ks[i];
}

}  // namespace

// boxes (nb, k, 4) f32, valid (nb, k) bool (one byte each), sup (nb, k,
// ceil(k / 64)) 64-bit scratch, keep (nb, k) bool out: contiguous, on the
// current device, 1 <= k <= 16384. Launches both kernels on `stream` and
// returns the first launch error, or cudaGetLastError(). No allocation, no
// synchronisation: safe inside a CUDA graph capture.
extern "C" int synergy_nms_greedy(const float* boxes,
                                  const unsigned char* valid, u64* sup,
                                  unsigned char* keep, int nb, int k,
                                  float thr, void* stream) {
  if (k < 0 || k > MAX_K || nb < 0 || nb > 65535)
    return (int)cudaErrorInvalidValue;
  if (nb == 0 || k == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nw = (k + WORD - 1) / WORD;
  nms_bits_kernel<<<dim3(nw, nw, nb), WORD, 0, s>>>(boxes, valid, sup, k, nw,
                                                    thr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)nw * sizeof(u64) + 2 * (size_t)k;
  nms_walk_kernel<<<nb, 32, smem, s>>>(sup, valid, keep, k, nw);
  return (int)cudaGetLastError();
}
