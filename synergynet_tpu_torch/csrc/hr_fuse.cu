// HRNet's exchange unit in one pass for Hopper (sm_90a), kernel F1.
//
// Not the port of a TPU kernel: no HRNet exists in the JAX package, and XLA
// would fuse the unit's BatchNorms, upsamples, sum and ReLU into the
// convolutions around it. In eager PyTorch one output of a unit runs as a
// dozen full-size passes: a BatchNorm transform for each term, a nearest
// upsample for each lower-resolution term, an add for each term and a ReLU.
// F1 reads each operand once at its own resolution and writes the output
// once.
//
// What it computes (one output i of an exchange unit of
// nn/backbones/hrnet.py in eval mode; the plain twin is ops/hr_fuse.py's
// hr_fuse_reference). The identity x_i is (B, C, H, W) channels-last in
// bf16 or f32: rows = B H W of C contiguous channels. Each of 1 to 3 terms
// is a raw convolution output of C channels at (H / s, W / s), s = 1, 2, 4
// or 8, channels-last in x_i's type, with a BatchNorm of its own:
//   out = relu(z_0 + z_1 + ... + z_n), added left to right, where the z are
//   the scale-1 terms in their order, then x_i, then the upsampled terms in
//   their order (HRNet's order of j: the branches of higher resolution, the
//   identity, the branches of lower resolution), each term
//   z = up_s(bn(t)) with bn as F.batch_norm computes it (invstd =
//   rsqrtf(var + eps) once a channel, then w (t - mean) invstd + bias in f32,
//   the last product and the add one fused multiply-add) rounded once to the
//   type, and up_s the nearest upsample: output row h reads row h / s.
// Each add is taken in f32 and rounded once to the type, as PyTorch's add
// rounds, and the ReLU passes NaN (torch.clamp_min). Every operation is a
// round-to-nearest intrinsic in the twin's order, so F1 gives the twin's
// bits: bit for bit was chosen over one rounding of an f32 sum because the
// twin is the module's own expression, and F1 can follow it at no cost (the
// adds are a few operations a value; the kernel is bound by bytes).
//
// What bounds it on this card: bytes. HRNetV2-W18's 26 exchange outputs at
// 256 pixels move 6.12 GB a 1,024-face call in bf16 when each operand is
// read once at its resolution and each output written once: 1.83 ms at
// 3.35 TB/s (perfbench/counts/hr_fuse.py).
//
// Design. 256 threads a block; a thread moves one vector of a row at a time,
// the widest of 16, 8 or 4 bytes that divides the row (C x element bytes:
// 4 bytes at 18 bf16 channels, 8 at 36, 16 at 72 and 144). A block takes a
// tile of at most 32 vectors of the channels and 256 / tile rows at a time,
// consecutive rows on consecutive lanes, so a lower-resolution term's row is
// read by neighbouring lanes and served from L1 after its first read. Each
// thread keeps its channels' statistics of every term in registers, computed
// once, and walks the rows, 64 bytes of the identity and the same number of
// rows of every term in flight, over a grid sized to the card's SMs.
// Nothing allocated, no host read: a CUDA graph records the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TILE = 32;         // vectors of a row a block
constexpr int BYTES_IN_FLIGHT = 64;  // of the identity a thread loads first,
                                     // with as many rows of each term
constexpr int BLOCKS_PER_SM = 16;    // the grid: about two waves of blocks
constexpr int MAX_TERMS = 3;         // a unit of four branches

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

// A term: its raw conv output, its BatchNorm and log2 of its scale.
struct Term {
    const void* x;
    Bn bn;
    int shift;
};

struct Terms {
    Term t[MAX_TERMS];
    int before;     // terms added ahead of the identity (the scale-1 ones)
};

// n / d for n < 2^31 by a multiply-high, an add and a shift (PyTorch's
// IntDivider): a row's pixel and face without a division.
struct Divider {
    unsigned m, s;
    __device__ __forceinline__ unsigned div(unsigned n) const {
        return (__umulhi(n, m) + n) >> s;
    }
};

Divider make_divider(unsigned d) {
    unsigned s = 0;
    while (s < 31 && (1u << s) < d) ++s;
    const unsigned long long one = 1;
    const unsigned long long magic =
        ((one << 32) * ((one << s) - d)) / d + 1;
    return Divider{static_cast<unsigned>(magic), s};
}

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

// identity, out (rows, c) row-major, rows = b h w, and each term (b, h >>
// shift, w >> shift, c); block (channel tile, row slice), thread (lane,
// vector): lanes = THREADS / tile rows at a time.
template <typename T, int VB, int NT>
__global__ void __launch_bounds__(THREADS) hrfuse_kernel(
        const T* __restrict__ ident, T* __restrict__ out, Terms terms,
        long long rows, int h, int w, Divider by_h, Divider by_w, int c,
        int tile) {
    using IO = Io<T, VB>;
    using R = typename IO::R;
    constexpr int V = IO::V;
    constexpr int U = BYTES_IN_FLIGHT / VB;
    const int lanes = THREADS / tile;
    const int lane = threadIdx.x / tile;
    const int k = (blockIdx.x * tile + threadIdx.x - lane * tile) * V;
    if (lane >= lanes || k >= c) return;

    Channels<V> bn[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) bn[j].load(terms.t[j].bn, k);
    const int before = terms.before;

    const long long step = static_cast<long long>(gridDim.y) * lanes * U;
    for (long long p0 = static_cast<long long>(blockIdx.y) * lanes * U + lane;
         p0 < rows; p0 += step) {
        R xs[U], ts[U][NT];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long p = p0 + static_cast<long long>(u) * lanes;
            if (p >= rows) break;
            xs[u] = __ldg(reinterpret_cast<const R*>(ident + p * c + k));
            const unsigned pu = static_cast<unsigned>(p);
            const unsigned bh = by_w.div(pu);
            const unsigned x = pu - bh * w;
            const unsigned b = by_h.div(bh);
            const unsigned y = bh - b * h;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int sh = terms.t[j].shift;
                const long long q =
                    (b * (h >> sh) + (y >> sh)) * (w >> sh) + (x >> sh);
                ts[u][j] = __ldg(reinterpret_cast<const R*>(
                    static_cast<const T*>(terms.t[j].x) + q * c + k));
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long p = p0 + static_cast<long long>(u) * lanes;
            if (p >= rows) break;
            float z[NT][V], id[V], o[V];
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                IO::unpack(ts[u][j], z[j]);
#pragma unroll
                for (int i = 0; i < V; ++i)
                    z[j][i] = IO::round(bn[j].apply(i, z[j][i]));
            }
            IO::unpack(xs[u], id);
#pragma unroll
            for (int i = 0; i < V; ++i) {
                // slots 0 .. NT in the twin's order: the terms ahead of the
                // identity, the identity, the rest.
                float acc = before > 0 ? z[0][i] : id[i];
#pragma unroll
                for (int s = 1; s <= NT; ++s) {
                    const float e = s < before ? z[s < NT ? s : 0][i]
                                    : s == before ? id[i]
                                                  : z[s - 1][i];
                    acc = IO::round(__fadd_rn(acc, e));
                }
                o[i] = isnan(acc) ? acc : fmaxf(acc, 0.0f);
            }
            *reinterpret_cast<R*>(out + p * c + k) = IO::pack(o);
        }
    }
}

template <typename T, int VB, int NT>
int launch(const void* ident, void* out, const Terms& terms, long long rows,
           int h, int w, int c, cudaStream_t stream) {
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
    hrfuse_kernel<T, VB, NT>
        <<<dim3(tiles, static_cast<unsigned>(blocks_y)), THREADS, 0,
           stream>>>(static_cast<const T*>(ident), static_cast<T*>(out),
                     terms, rows, h, w, make_divider(h), make_divider(w), c,
                     tile);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int VB>
int by_terms(int n, const void* ident, void* out, const Terms& terms,
             long long rows, int h, int w, int c, cudaStream_t s) {
    if (n == 1) return launch<T, VB, 1>(ident, out, terms, rows, h, w, c, s);
    if (n == 2) return launch<T, VB, 2>(ident, out, terms, rows, h, w, c, s);
    return launch<T, VB, 3>(ident, out, terms, rows, h, w, c, s);
}

// The widest vector of 16, 8 or 4 bytes that divides a row of row_bytes.
template <typename T>
int by_vector(int row_bytes, int n, const void* ident, void* out,
              const Terms& terms, long long rows, int h, int w, int c,
              cudaStream_t s) {
    if (row_bytes % 16 == 0)
        return by_terms<T, 16>(n, ident, out, terms, rows, h, w, c, s);
    if (row_bytes % 8 == 0)
        return by_terms<T, 8>(n, ident, out, terms, rows, h, w, c, s);
    return by_terms<T, 4>(n, ident, out, terms, rows, h, w, c, s);
}

}  // namespace

// ident and out (b, h, w, c) channels-last on the device, 16-byte aligned,
// fewer than 2^31 rows b h w, in bf16 (elem 2) or f32 (elem 4), a row of c x elem bytes a multiple of 4
// (c even in bf16). Term j < n: xj (b, h / sj, w / sj, c) in the same form,
// sj = 1, 2, 4 or 8 dividing h and w, and its BatchNorm (meanj .. biasj f32,
// c each; epsj). The first `before` terms are added ahead of the identity
// and the rest after it. Returns cudaGetLastError() after the launch.
extern "C" int synergy_hr_fuse(
        const void* ident, void* out,
        const void* x0, const float* mean0, const float* var0,
        const float* weight0, const float* bias0, float eps0, int s0,
        const void* x1, const float* mean1, const float* var1,
        const float* weight1, const float* bias1, float eps1, int s1,
        const void* x2, const float* mean2, const float* var2,
        const float* weight2, const float* bias2, float eps2, int s2,
        int n, int before, int b, int h, int w, int c, int elem,
        void* stream) {
    if ((elem != 2 && elem != 4) || b < 1 || h < 1 || w < 1 || c < 1 ||
        (c * elem) % 4 != 0 || n < 1 || n > MAX_TERMS || before < 0 ||
        before > n || ident == nullptr || out == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    const void* xs[MAX_TERMS] = {x0, x1, x2};
    const int scales[MAX_TERMS] = {s0, s1, s2};
    const Bn bns[MAX_TERMS] = {{mean0, var0, weight0, bias0, eps0},
                               {mean1, var1, weight1, bias1, eps1},
                               {mean2, var2, weight2, bias2, eps2}};
    Terms terms{};
    terms.before = before;
    for (int j = 0; j < n; ++j) {
        int shift = -1;
        for (int q = 0; q <= 3; ++q)
            if (scales[j] == (1 << q)) shift = q;
        if (shift < 0 || h % scales[j] != 0 || w % scales[j] != 0 ||
            xs[j] == nullptr || bns[j].mean == nullptr ||
            bns[j].var == nullptr || bns[j].weight == nullptr ||
            bns[j].bias == nullptr)
            return static_cast<int>(cudaErrorInvalidValue);
        terms.t[j] = Term{xs[j], bns[j], shift};
    }
    const long long rows = static_cast<long long>(b) * h * w;
    if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (elem == 2)
        return by_vector<__nv_bfloat16>(c * elem, n, ident, out, terms, rows,
                                        h, w, c, s);
    return by_vector<float>(c * elem, n, ident, out, terms, rows, h, w, c, s);
}
