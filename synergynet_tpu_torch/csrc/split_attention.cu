// ResNeSt split-attention radix combine for Hopper (sm_90a), kernel R1.
//
// Not the port of a TPU kernel: the JAX package leaves this combine to XLA
// (synergynet_tpu/nn/backbones/resnest.py: SplAtConv2d, a radix sum, a
// spatial mean, an rSoftmax and a broadcast product summed over radix,
// which XLA fuses). In eager PyTorch the same expressions run as four
// full-size passes over strided 5-D views of the channels-last radix
// tensor: two reduces over radix, a reduce over H x W, and a broadcast
// product written out whole. R1 computes the function in two passes.
//
// What it computes (nn/backbones/resnest.py; its plain twins are
// ops/split_attention.py's radix_pool_reference / radix_combine_reference).
// y is the block's radix tensor, (B, r c, H, W) channels-last in bf16 or
// f32: at each position r branches of c contiguous channels.
// - splat_pool_kernel: out (B, c) = the spatial mean of the radix sum. Per
//   position the r branches are summed in f32 and rounded to the working
//   type (the twin's split.sum(1)); those sums are accumulated over H x W
//   in f32, multiplied by 1 / (H W) and rounded once (spatial_mean).
// - splat_combine_kernel: logits (B, r c) are Conv_2's output in the
//   (cardinality, radix, c / cardinality) channel layout. Per face and
//   channel the weights are the softmax over radix (radix > 1: max, the
//   sum of exp(x - max) in f32, exp(x - max) / sum) or the sigmoid 1 /
//   (1 + exp(-x)) (radix 1), each rounded to the working type as
//   torch.softmax / torch.sigmoid round them. out (B, c, H, W) channels-last
//   = the sum over radix in f32 of each branch times its weight, every
//   product rounded to the working type (split * atten) and the sum
//   rounded once. Products and sums are written with round-to-nearest
//   intrinsics, so nvcc contracts nothing into an FMA.
//
// What bounds it on this card: bytes. At ResNeSt-50's served shapes (1,024
// faces of 120 pixels, radix 2, 16 blocks) the radix tensors are 1.13 M
// values a face, and reading them once and writing the combined tensors
// once is 3.46 GB in bf16: 1.03 ms at 3.35 TB/s. The two passes read the
// radix tensor twice (5.77 GB, 1.72 ms); the pooled vector must pass
// through Conv_1, BatchNorm_1 and Conv_2 before the combine can start. The
// operations (a few a value, r c exps a face) are far below any peak.
//
// Design. 256 threads a block; each thread moves 16 bytes at a time (8
// bf16 or 4 f32 channels of one branch at one position), so a warp's loads
// and stores are contiguous runs of a position's channels. The tiling
// follows the two observed extents, H x W (900 to 16) and r c (128 to
// 1,024), with one code path for every shape:
// - pool: one block per face and channel tile (at most 32 vectors of a
//   branch); the block's other threads take other positions, so a block
//   keeps 256 / tile positions in flight, and each thread sums its
//   positions serially. The lanes' partial sums meet in shared memory and
//   are added in lane order: no atomics, the result is deterministic.
// - combine: one block per face and tile of positions, sized to ~2,048
//   vectors; each block computes its face's r c weights into shared memory
//   first (r c exps, trivial beside the tile's bytes), then streams its
//   positions.
// One launch per entry on the caller's stream, nothing allocated, no host
// read: a CUDA graph records both as it records C1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TILE = 32;            // pool: vectors of a branch a block
constexpr int COMBINE_VECTORS = 2048;   // combine: vectors a block, ~8 each
// r c floats in 48 KB of shared memory; ops/split_attention.py's
// R1_MAX_WEIGHTS holds the same number (a card test checks both).
constexpr int MAX_WEIGHTS = 12288;

template <typename T>
struct Io;

template <>
struct Io<float> {
    static constexpr int V = 4;
    __device__ __forceinline__ static void load(const float* p, float* v) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = x.x;
        v[1] = x.y;
        v[2] = x.z;
        v[3] = x.w;
    }
    __device__ __forceinline__ static void store(float* p, const float* v) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
    __device__ __forceinline__ static float round(float x) { return x; }
    __device__ __forceinline__ static float get(const float* p) {
        return __ldg(p);
    }
    __device__ __forceinline__ static void put(float* p, float x) { *p = x; }
};

template <>
struct Io<__nv_bfloat16> {
    static constexpr int V = 8;
    __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                                float* v) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            v[2 * i] = f.x;
            v[2 * i + 1] = f.y;
        }
    }
    __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                                 const float* v) {
        uint4 raw;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i)
            h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        *reinterpret_cast<uint4*>(p) = raw;
    }
    __device__ __forceinline__ static float round(float x) {
        return __bfloat162float(__float2bfloat16_rn(x));
    }
    __device__ __forceinline__ static float get(const __nv_bfloat16* p) {
        return __bfloat162float(p[0]);
    }
    __device__ __forceinline__ static void put(__nv_bfloat16* p, float x) {
        *p = __float2bfloat16_rn(x);
    }
};

// y (B, hw, r c) -> out (B, c). Block (face, channel tile of `tile`
// vectors); thread = (lane, vector), lanes = THREADS / tile positions in
// flight.
template <typename T>
__global__ void __launch_bounds__(THREADS) splat_pool_kernel(
        const T* __restrict__ y, T* __restrict__ out, int hw, int radix,
        int c, int tile, float inv_hw) {
    constexpr int V = Io<T>::V;
    __shared__ float part[THREADS * V];

    const int cv = c / V;
    const int lanes = THREADS / tile;
    const int lane = threadIdx.x / tile;
    const int j = threadIdx.x - lane * tile;
    const int vec = blockIdx.y * tile + j;
    const size_t row = static_cast<size_t>(radix) * c;

    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    if (lane < lanes && vec < cv) {
        const T* base = y + static_cast<size_t>(blockIdx.x) * hw * row +
                        static_cast<size_t>(vec) * V;
#pragma unroll 4
        for (int p = lane; p < hw; p += lanes) {
            const T* q = base + p * row;
            float s[V], t[V];
            Io<T>::load(q, s);
            for (int r = 1; r < radix; ++r) {
                Io<T>::load(q + r * c, t);
#pragma unroll
                for (int i = 0; i < V; ++i) s[i] = __fadd_rn(s[i], t[i]);
            }
#pragma unroll
            for (int i = 0; i < V; ++i)
                acc[i] = __fadd_rn(acc[i], Io<T>::round(s[i]));
        }
    }
    // Lane l's sums of the tile's channel k at part[l * tile V + k].
    const int width = tile * V;
    if (lane < lanes) {
#pragma unroll
        for (int i = 0; i < V; ++i) part[lane * width + j * V + i] = acc[i];
    }
    __syncthreads();
    const int k = threadIdx.x;
    const int ch = blockIdx.y * width + k;
    if (k < width && ch < c) {
        float sum = 0.0f;
        for (int l = 0; l < lanes; ++l)
            sum = __fadd_rn(sum, part[l * width + k]);
        Io<T>::put(out + static_cast<size_t>(blockIdx.x) * c + ch,
                   __fmul_rn(sum, inv_hw));
    }
}

// y (B, hw, r c), logits (B, r c) -> out (B, hw, c). Block (face, tile of
// `ppt` positions).
template <typename T>
__global__ void __launch_bounds__(THREADS) splat_combine_kernel(
        const T* __restrict__ y, const T* __restrict__ logits,
        T* __restrict__ out, int hw, int radix, int c, int groups, int ppt) {
    constexpr int V = Io<T>::V;
    extern __shared__ float4 smem[];
    float* wgt = reinterpret_cast<float*>(smem);     // wgt[r c + channel]

    const size_t face = blockIdx.x;
    const int cg = c / groups;
    const T* lg = logits + face * radix * c;
    for (int k = threadIdx.x; k < c; k += THREADS) {
        const int g = k / cg;
        const T* l = lg + g * radix * cg + (k - g * cg);
        if (radix == 1) {
            const float x = Io<T>::get(l);
            wgt[k] = Io<T>::round(1.0f / __fadd_rn(1.0f, expf(-x)));
        } else {
            float m = Io<T>::get(l);
            for (int r = 1; r < radix; ++r)
                m = fmaxf(m, Io<T>::get(l + r * cg));
            float s = 0.0f;
            for (int r = 0; r < radix; ++r)
                s = __fadd_rn(s, expf(__fsub_rn(Io<T>::get(l + r * cg), m)));
            for (int r = 0; r < radix; ++r)
                wgt[r * c + k] = Io<T>::round(
                    expf(__fsub_rn(Io<T>::get(l + r * cg), m)) / s);
        }
    }
    __syncthreads();

    const int cv = c / V;
    const int p0 = blockIdx.y * ppt;
    const int n = min(ppt, hw - p0) * cv;
    const size_t row = static_cast<size_t>(radix) * c;
    const T* src = y + (face * hw + p0) * row;
    T* dst = out + (face * hw + p0) * c;
#pragma unroll 4
    for (int v = threadIdx.x; v < n; v += THREADS) {
        const int p = v / cv;
        const int k = (v - p * cv) * V;
        const T* q = src + p * row + k;
        float acc[V], t[V], w[V];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = 0.0f;
        for (int r = 0; r < radix; ++r) {
            Io<T>::load(q + r * c, t);
            const float4* w4 =
                reinterpret_cast<const float4*>(wgt + r * c + k);
#pragma unroll
            for (int i = 0; i < V / 4; ++i) {
                const float4 x = w4[i];
                w[4 * i] = x.x;
                w[4 * i + 1] = x.y;
                w[4 * i + 2] = x.z;
                w[4 * i + 3] = x.w;
            }
#pragma unroll
            for (int i = 0; i < V; ++i)
                acc[i] = __fadd_rn(acc[i],
                                   Io<T>::round(__fmul_rn(t[i], w[i])));
        }
        Io<T>::store(dst + static_cast<size_t>(p) * c + k, acc);
    }
}

template <typename T>
int pool(const void* y, void* out, int batch, int hw, int radix, int c,
         cudaStream_t stream) {
    constexpr int V = Io<T>::V;
    const int cv = c / V;
    const int tiles = (cv + MAX_TILE - 1) / MAX_TILE;
    const int tile = (cv + tiles - 1) / tiles;
    splat_pool_kernel<T><<<dim3(batch, tiles), THREADS, 0, stream>>>(
        static_cast<const T*>(y), static_cast<T*>(out), hw, radix, c, tile,
        1.0f / static_cast<float>(hw));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int combine(const void* y, const void* logits, void* out, int batch, int hw,
            int radix, int c, int groups, cudaStream_t stream) {
    constexpr int V = Io<T>::V;
    const long long vectors = static_cast<long long>(hw) * (c / V);
    const int tiles = static_cast<int>(
        (vectors + COMBINE_VECTORS - 1) / COMBINE_VECTORS);
    const int ppt = (hw + tiles - 1) / tiles;
    const int blocks_y = (hw + ppt - 1) / ppt;
    if (blocks_y > 65535)
        return static_cast<int>(cudaErrorInvalidConfiguration);
    const size_t smem = sizeof(float) * radix * c;
    splat_combine_kernel<T><<<dim3(batch, blocks_y), THREADS, smem, stream>>>(
        static_cast<const T*>(y), static_cast<const T*>(logits),
        static_cast<T*>(out), hw, radix, c, groups, ppt);
    return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int batch, int hw, int radix, int c, int elem) {
    const int v = 16 / elem;
    return batch < 1 || hw < 1 || radix < 1 || c < v || c % v != 0 ||
           radix > MAX_WEIGHTS / c;
}

}  // namespace

// y (batch, hw, radix c) channels-last radix tensor and out (batch, c),
// contiguous on the device, y 16-byte aligned; elem 2 (bf16) or 4 (f32);
// c a multiple of 16 / elem. Returns cudaGetLastError() after the launch.
extern "C" int synergy_splat_pool(const void* y, void* out, int batch,
                                  int hw, int radix, int c, int elem,
                                  void* stream) {
    if (bad_shape(batch, hw, radix, c, elem))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (elem == 2) return pool<__nv_bfloat16>(y, out, batch, hw, radix, c, s);
    if (elem == 4) return pool<float>(y, out, batch, hw, radix, c, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// y as above, logits (batch, radix c) in the (groups, radix, c / groups)
// layout, out (batch, hw, c); c a multiple of groups, radix c at most
// MAX_WEIGHTS.
extern "C" int synergy_splat_combine(const void* y, const void* logits,
                                     void* out, int batch, int hw, int radix,
                                     int c, int groups, int elem,
                                     void* stream) {
    if (bad_shape(batch, hw, radix, c, elem) || groups < 1 || c % groups)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (elem == 2)
        return combine<__nv_bfloat16>(y, logits, out, batch, hw, radix, c,
                                      groups, s);
    if (elem == 4)
        return combine<float>(y, logits, out, batch, hw, radix, c, groups, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
