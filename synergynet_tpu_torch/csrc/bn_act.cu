// Eval BatchNorm, residual add and ReLU / ReLU6 in one pass for Hopper
// (sm_90a), kernel BN1.
//
// Not the port of a TPU kernel: the JAX package leaves a convolution's
// BatchNorm, activation and residual add to XLA, which fuses them into the
// convolution's epilogue. In eager PyTorch the same expressions run as up
// to four full-size passes over the conv output: F.batch_norm's transform,
// then F.relu's clamp, torch.minimum's clamp at 6 (ReLU6) or the residual
// add. BN1 reads each operand once and writes the result once.
//
// What it computes (the blocks of nn/backbones/mobilenet_v2.py and
// nn/backbones/resnest.py in eval mode; the plain twin is
// ops/bn_act.py's bn_act_reference). x is a conv output, (B, C, H, W)
// channels-last in bf16 or f32: rows = B H W of C contiguous channels.
//   out = act(bn(x) [+ r])
// - bn(x) is F.batch_norm with the running statistics, as PyTorch's CUDA
//   channels-last transform computes it: invstd = rsqrtf(var + eps) once a
//   channel, then w (x - mean) invstd + bias in f32, the last product and
//   the add one fused multiply-add (nvcc contracts PyTorch's expression so),
//   rounded once to the tensor's type.
// - r, where present, is a channels-last tensor of x's shape and type: read
//   as it is (an identity shortcut), or under a BatchNorm of its own
//   computed as bn(x) and rounded to the type (a projected shortcut). The
//   add is taken in f32 and rounded once, as PyTorch's add rounds.
// - act is none, ReLU (NaN passes, else max(y, 0)) or ReLU6 (the same,
//   then NaN passes, else min(y, 6)), on the rounded value, as
//   torch.clamp_min and torch.minimum compute them. Both are exact.
// Every operation is a round-to-nearest intrinsic in the twin's order, so
// BN1 gives the twin's bits.
//
// What bounds it on this card: bytes. At the served shapes (1,024 faces of
// 120 pixels, bf16) MobileNetV2's 52 sites move 8.26 GB and ResNeSt-50's 51
// sites 18.9 GB when each operand is read once and the result written once:
// 2.47 ms and 5.64 ms at 3.35 TB/s. The operations, a few a value, are far
// below any peak.
//
// Design. 256 threads a block; a thread moves one vector of a row at a time,
// the widest of 16, 8 or 4 bytes that divides the row (C x element bytes):
// 16 bytes (8 bf16 or 4 f32 channels) wherever C is a multiple of 8 / 4, as
// at every MobileNetV2 and ResNeSt site; 8 or 4 bytes at narrower rows, as
// HRNet's 18, 36 and 270 channels in bf16. A warp's loads and stores are
// contiguous runs of a row's channels. A block takes a tile of at most 32
// such vectors of the channels and 256 / tile rows at a time; each thread
// keeps its channels' mean, invstd, weight and bias in registers, computed
// once, and walks the rows, 64 bytes of each operand in flight (four rows of
// 16-byte vectors, sixteen of 4-byte ones), over a grid sized to the card's
// SMs. No shared memory, nothing allocated, no host read: a CUDA graph
// records the launch as it records R1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TILE = 32;        // vectors of a row a block
constexpr int BYTES_IN_FLIGHT = 64; // of each operand a thread loads before
                                    // it stores: 4 rows of 16-byte vectors
constexpr int BLOCKS_PER_SM = 16;   // the grid: about two waves of blocks

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2 };
enum Res { RES_NONE = 0, RES_RAW = 1, RES_BN = 2 };

// A vector of VB bytes as one load or store.
template <int VB>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = unsigned int; };

template <typename T, int VB>
struct Io;

template <int VB>
struct Io<float, VB> {
    static constexpr int V = VB / 4;
    using R = typename Raw<VB>::type;
    __device__ __forceinline__ static void unpack(const R& raw, float* v) {
        const unsigned int* u = reinterpret_cast<const unsigned int*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = __uint_as_float(u[i]);
    }
    __device__ __forceinline__ static R pack(const float* v) {
        R raw;
        unsigned int* u = reinterpret_cast<unsigned int*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i) u[i] = __float_as_uint(v[i]);
        return raw;
    }
    __device__ __forceinline__ static float round(float x) { return x; }
};

template <int VB>
struct Io<__nv_bfloat16, VB> {
    static constexpr int V = VB / 2;
    using R = typename Raw<VB>::type;
    __device__ __forceinline__ static void unpack(const R& raw, float* v) {
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < V / 2; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            v[2 * i] = f.x;
            v[2 * i + 1] = f.y;
        }
    }
    __device__ __forceinline__ static R pack(const float* v) {
        R raw;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < V / 2; ++i)
            h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        return raw;
    }
    __device__ __forceinline__ static float round(float x) {
        return __bfloat162float(__float2bfloat16_rn(x));
    }
};

// A BatchNorm's running statistics and affine parameters, f32, C each.
struct Bn {
    const float* mean;
    const float* var;
    const float* weight;
    const float* bias;
    float eps;
};

// One thread's V channels of a BatchNorm, in registers.
template <int V>
struct Channels {
    float mean[V], invstd[V], weight[V], bias[V];

    __device__ __forceinline__ void load(const Bn& bn, int k) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
            mean[i] = __ldg(bn.mean + k + i);
            invstd[i] = rsqrtf(__fadd_rn(__ldg(bn.var + k + i), bn.eps));
            weight[i] = __ldg(bn.weight + k + i);
            bias[i] = __ldg(bn.bias + k + i);
        }
    }
    // F.batch_norm's w (x - mean) invstd + bias, unrounded.
    __device__ __forceinline__ float apply(int i, float x) const {
        return __fmaf_rn(__fmul_rn(weight[i], __fsub_rn(x, mean[i])),
                         invstd[i], bias[i]);
    }
};

// x, r, out (rows, c) row-major; block (channel tile, row slice), thread
// (lane, vector): lanes = THREADS / tile rows at a time.
template <typename T, int VB, int ACT, int RES>
__global__ void __launch_bounds__(THREADS) bnact_kernel(
        const T* __restrict__ x, const T* __restrict__ r,
        T* __restrict__ out, Bn bn, Bn rbn, long long rows, int c,
        int tile) {
    using IO = Io<T, VB>;
    using R = typename IO::R;
    constexpr int V = IO::V;
    constexpr int U = BYTES_IN_FLIGHT / VB;
    const int lanes = THREADS / tile;
    const int lane = threadIdx.x / tile;
    const int k = (blockIdx.x * tile + threadIdx.x - lane * tile) * V;
    if (lane >= lanes || k >= c) return;

    Channels<V> a, b;
    a.load(bn, k);
    if (RES == RES_BN) b.load(rbn, k);

    const long long step = static_cast<long long>(gridDim.y) * lanes * U;
    for (long long p0 = static_cast<long long>(blockIdx.y) * lanes * U + lane;
         p0 < rows; p0 += step) {
        R xs[U], rs[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long p = p0 + static_cast<long long>(u) * lanes;
            if (p < rows) {
                xs[u] = __ldg(reinterpret_cast<const R*>(x + p * c + k));
                if (RES != RES_NONE)
                    rs[u] = __ldg(reinterpret_cast<const R*>(r + p * c + k));
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long p = p0 + static_cast<long long>(u) * lanes;
            if (p >= rows) break;
            float v[V], s[V];
            IO::unpack(xs[u], v);
            if (RES != RES_NONE) IO::unpack(rs[u], s);
#pragma unroll
            for (int i = 0; i < V; ++i) {
                float y = IO::round(a.apply(i, v[i]));
                if (RES != RES_NONE) {
                    const float z =
                        RES == RES_BN ? IO::round(b.apply(i, s[i])) : s[i];
                    y = IO::round(__fadd_rn(z, y));
                }
                if (ACT != ACT_NONE) y = isnan(y) ? y : fmaxf(y, 0.0f);
                if (ACT == ACT_RELU6) y = isnan(y) ? y : fminf(y, 6.0f);
                v[i] = y;
            }
            *reinterpret_cast<R*>(out + p * c + k) = IO::pack(v);
        }
    }
}

template <typename T, int VB, int ACT, int RES>
int launch(const void* x, const void* r, void* out, const Bn& bn,
           const Bn& rbn, long long rows, int c, cudaStream_t stream) {
    constexpr int V = Io<T, VB>::V;
    constexpr int U = BYTES_IN_FLIGHT / VB;
    const int cv = c / V;
    const int tiles = (cv + MAX_TILE - 1) / MAX_TILE;
    const int tile = (cv + tiles - 1) / tiles;
    const long long lanes = THREADS / tile;
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    long long blocks_y = (rows + lanes * U - 1) / (lanes * U);
    const long long cap = (static_cast<long long>(sms) * BLOCKS_PER_SM +
                           tiles - 1) / tiles;
    if (blocks_y > cap) blocks_y = cap;
    if (blocks_y > 65535) blocks_y = 65535;
    bnact_kernel<T, VB, ACT, RES>
        <<<dim3(tiles, static_cast<unsigned>(blocks_y)), THREADS, 0,
           stream>>>(static_cast<const T*>(x), static_cast<const T*>(r),
                     static_cast<T*>(out), bn, rbn, rows, c, tile);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int VB, int ACT>
int by_res(int res, const void* x, const void* r, void* out, const Bn& bn,
           const Bn& rbn, long long rows, int c, cudaStream_t s) {
    if (res == RES_NONE)
        return launch<T, VB, ACT, RES_NONE>(x, r, out, bn, rbn, rows, c, s);
    if (res == RES_RAW)
        return launch<T, VB, ACT, RES_RAW>(x, r, out, bn, rbn, rows, c, s);
    return launch<T, VB, ACT, RES_BN>(x, r, out, bn, rbn, rows, c, s);
}

template <typename T, int VB>
int by_act(int act, int res, const void* x, const void* r, void* out,
           const Bn& bn, const Bn& rbn, long long rows, int c,
           cudaStream_t s) {
    if (act == ACT_NONE)
        return by_res<T, VB, ACT_NONE>(res, x, r, out, bn, rbn, rows, c, s);
    if (act == ACT_RELU)
        return by_res<T, VB, ACT_RELU>(res, x, r, out, bn, rbn, rows, c, s);
    return by_res<T, VB, ACT_RELU6>(res, x, r, out, bn, rbn, rows, c, s);
}

// The widest vector of 16, 8 or 4 bytes that divides a row of row_bytes.
template <typename T>
int by_vector(int row_bytes, int act, int res, const void* x, const void* r,
              void* out, const Bn& bn, const Bn& rbn, long long rows, int c,
              cudaStream_t s) {
    if (row_bytes % 16 == 0)
        return by_act<T, 16>(act, res, x, r, out, bn, rbn, rows, c, s);
    if (row_bytes % 8 == 0)
        return by_act<T, 8>(act, res, x, r, out, bn, rbn, rows, c, s);
    return by_act<T, 4>(act, res, x, r, out, bn, rbn, rows, c, s);
}

}  // namespace

// x, r (res 1 or 2; else unused) and out (rows, c) row-major on the device,
// 16-byte aligned, in bf16 (elem 2) or f32 (elem 4); a row of c x elem bytes
// a multiple of 4 (c even in bf16). mean, var, weight, bias: x's BatchNorm, f32, c each; mean2 ..
// bias2 and eps2: r's (res 2; else unused). act 0 none, 1 ReLU, 2 ReLU6;
// res 0 none, 1 r as it is, 2 r under its BatchNorm. Returns
// cudaGetLastError() after the launch.
extern "C" int synergy_bn_act(const void* x, const void* r, void* out,
                              const float* mean, const float* var,
                              const float* weight, const float* bias,
                              float eps, const float* mean2,
                              const float* var2, const float* weight2,
                              const float* bias2, float eps2, long long rows,
                              int c, int act, int res, int elem,
                              void* stream) {
    if ((elem != 2 && elem != 4) || rows < 1 || c < 1 ||
        (c * elem) % 4 != 0 || act < ACT_NONE ||
        act > ACT_RELU6 || res < RES_NONE || res > RES_BN ||
        (res != RES_NONE && r == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const Bn bn{mean, var, weight, bias, eps};
    const Bn rbn{mean2, var2, weight2, bias2, eps2};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (elem == 2)
        return by_vector<__nv_bfloat16>(c * elem, act, res, x, r, out, bn,
                                        rbn, rows, c, s);
    return by_vector<float>(c * elem, act, res, x, r, out, bn, rbn, rows, c,
                            s);
}
