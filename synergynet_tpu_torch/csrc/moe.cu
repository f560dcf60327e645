// The sparse mixture-of-experts layer's routing and combine for Hopper
// (sm_90a): kernels M1 (route and dispatch) and M2 (combine).
//
// Not the port of a TPU kernel: the JAX package has no mixture of experts.
// The layer (nn/moe.py, V-MoE's "Every-2" MLP) sends each token to the two
// experts its router ranks highest and sums their outputs weighted by the
// router's probabilities. A CUDA graph replays the served call, so how many
// tokens each expert gets is known only on the device: M1 writes the
// per-expert row offsets there, kernel G1 (ops/moe_gemm_triton.py) reads
// them, and M2 reads M1's slots. Nothing here reads the host or allocates.
//
// What M1 computes (the plain twin is ops/moe.py's moe_dispatch_reference),
// for T tokens u (T, D) bf16 and the router's weight w (E, D) f32, E a
// power of two from 4 to 32, D a multiple of 8:
//   logit[t][e] = sum over k = 0 .. D - 1 of u[t][k] w[e][k], in f32, each
//     product and each add rounded once, in the order of k (no fused
//     multiply-add: the twin's torch ops round the same way);
//   p[t][e] = exp(logit - max_e logit) / s, expf as PyTorch's CUDA exp, and
//     s the sum over e folded in halves (e + E/2 onto e, then e + E/4 onto
//     e, ...), the twin's order, then one IEEE division;
//   the top two experts e1, e2 by p, a tie to the lower index (the twin's
//     stable sort), and their gates p[t][e1] >= p[t][e2], not renormalised.
// Then the dispatch, dropless: every (token, k) pair gets a row of the
// expert-contiguous buffer x (2T, D), expert e's rows from offsets[e] to
// offsets[e + 1], its tokens in ascending order; slot[t][k] is the row and
// x[slot] a copy of u[t]. offsets (E + 1) is the exclusive prefix of the
// per-expert counts, tiles (E + 1) the same of ceil(count / BLOCK_M) (the
// row tiles of G1), and stats (2, int64) the rows routed and the busiest
// expert's rows, which the layer adds to the program's tallies.
// M1 is two launches of one entry, synergy_moe_dispatch: phase 0 (route,
// moe_dispatch_route_kernel) writes each token's experts and gates and each
// segment's (256 tokens') per-expert counts; phase 1
// (moe_dispatch_scatter_kernel, a block a segment) gives the segment its
// rows past every earlier segment's, ranks its tokens in order (warp
// ballots, a prefix over the warps), and copies the rows. Counts are sums,
// so the shared-memory atomics that add them decide no order; every row
// and offset equals the twin's bit for bit.
//
// What M2 computes (synergy_moe_combine, moe_combine_kernel; the twin is
// moe_combine_reference): out[t] = z[t] + (g1 y[slot[t][0]] + g2
// y[slot[t][1]]) in f32 (two products, their sum, then the add of z, each
// rounded once), rounded once to bf16.
//
// What bounds them on this card. M1: the router's 2 T D E operations on the
// CUDA cores (no fused multiply-add, so each a separate instruction) and
// the bytes of u read and x written; M2: bytes (y's two rows, z and the
// output a token). perfbench/counts/moe.py counts both.
//
// Design. Route: 256 threads a block, two blocks a SM, a lane a token
// computing all E logits in registers; the router's weight sits in shared
// memory once a block as (D, E), so each weight load is one 16-byte
// broadcast to the warp, and each of the lane's 16-byte token loads feeds
// 8 x E multiply-adds; the softmax, fold and top 2 run in the lane's
// registers. A block takes whole segments, counted in shared memory.
// Scatter: a block of 256 threads a segment (enough blocks to keep the
// copies in flight), a thread a token for the ranks, then a warp a row for
// the copies (16-byte loads and stores). The route's grid is sized to the
// card's SMs at the call, fixed for a captured graph. Combine: a thread a
// 16-byte vector of a token's row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROUTE_THREADS = 256;
constexpr int SEG = 256;                 // tokens a scatter block
constexpr int SCATTER_WARPS = SEG / 32;
constexpr int COMBINE_THREADS = 256;
constexpr int MAX_EXPERTS = 32;
constexpr int BLOCK_M = 128;             // G1's row tile (ops/moe.py)

__device__ __forceinline__ float lo(unsigned int w) {
    return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi(unsigned int w) {
    return __uint_as_float(w & 0xffff0000u);
}

// acc[e] += x w[e] over the E experts, each product and add rounded once.
template <int E>
__device__ __forceinline__ void mac(float* acc, float x, const float* wk) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
        const float4 w = reinterpret_cast<const float4*>(wk)[q];
        acc[4 * q] = __fadd_rn(acc[4 * q], __fmul_rn(x, w.x));
        acc[4 * q + 1] = __fadd_rn(acc[4 * q + 1], __fmul_rn(x, w.y));
        acc[4 * q + 2] = __fadd_rn(acc[4 * q + 2], __fmul_rn(x, w.z));
        acc[4 * q + 3] = __fadd_rn(acc[4 * q + 3], __fmul_rn(x, w.w));
    }
}

template <int E>
__global__ void __launch_bounds__(ROUTE_THREADS, 2)
moe_dispatch_route_kernel(const __nv_bfloat16* __restrict__ u,
                          const float* __restrict__ w,
                          int* __restrict__ expert, float* __restrict__ gate,
                          int* __restrict__ seg_counts, int T, int D,
                          int segs_per_block, int nseg) {
    extern __shared__ float4 smem4[];
    float* ws = reinterpret_cast<float*>(smem4);      // [D][E]
    int* cnt = reinterpret_cast<int*>(ws + D * E);    // [segs_per_block][E]
    for (int i = threadIdx.x; i < E * D; i += blockDim.x) {
        const int k = i / E;
        ws[i] = w[(i - k * E) * D + k];
    }
    for (int i = threadIdx.x; i < segs_per_block * E; i += blockDim.x)
        cnt[i] = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const int t0 = blockIdx.x * segs_per_block * SEG;
    const int t1 = min(T, t0 + segs_per_block * SEG);
    for (int g = t0 + 32 * warp; g < t1; g += 32 * warps) {
        const int t = g + lane;
        const bool valid = t < t1;
        const uint4* row = reinterpret_cast<const uint4*>(
            u + static_cast<size_t>(valid ? t : t0) * D);
        float acc[E];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = 0.0f;
        for (int c = 0; c < D / 8; ++c) {
            const uint4 v = __ldg(row + c);
            const float* wk = ws + 8 * c * E;
            mac<E>(acc, lo(v.x), wk);
            mac<E>(acc, hi(v.x), wk + E);
            mac<E>(acc, lo(v.y), wk + 2 * E);
            mac<E>(acc, hi(v.y), wk + 3 * E);
            mac<E>(acc, lo(v.z), wk + 4 * E);
            mac<E>(acc, hi(v.z), wk + 5 * E);
            mac<E>(acc, lo(v.w), wk + 6 * E);
            mac<E>(acc, hi(v.w), wk + 7 * E);
        }
        float m = acc[0];
#pragma unroll
        for (int e = 1; e < E; ++e) m = fmaxf(m, acc[e]);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = expf(__fsub_rn(acc[e], m));
        float s[E / 2];
#pragma unroll
        for (int e = 0; e < E / 2; ++e)
            s[e] = __fadd_rn(acc[e], acc[e + E / 2]);
#pragma unroll
        for (int h = E / 4; h >= 1; h /= 2) {
#pragma unroll
            for (int e = 0; e < h; ++e) s[e] = __fadd_rn(s[e], s[e + h]);
        }
        float g1 = -1.0f, g2 = -1.0f;
        int e1 = 0, e2 = 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const float p = __fdiv_rn(acc[e], s[0]);
            if (p > g1) {
                g2 = g1;
                e2 = e1;
                g1 = p;
                e1 = e;
            } else if (p > g2) {
                g2 = p;
                e2 = e;
            }
        }
        if (valid) {
            reinterpret_cast<int2*>(expert)[t] = make_int2(e1, e2);
            reinterpret_cast<float2*>(gate)[t] = make_float2(g1, g2);
            const int local = (t - t0) / SEG * E;
            atomicAdd(cnt + local + e1, 1);
            atomicAdd(cnt + local + e2, 1);
        }
    }
    __syncthreads();
    const int first = blockIdx.x * segs_per_block;
    for (int i = threadIdx.x; i < segs_per_block * E; i += blockDim.x) {
        const int seg = first + i / E;
        if (seg < nseg) seg_counts[(i % E) * nseg + seg] = cnt[i];
    }
}

__global__ void __launch_bounds__(SEG)
moe_dispatch_scatter_kernel(const __nv_bfloat16* __restrict__ u,
                            const int* __restrict__ expert,
                            const int* __restrict__ seg_counts, int nseg,
                            int* __restrict__ offsets, int* __restrict__ tiles,
                            int* __restrict__ slot,
                            __nv_bfloat16* __restrict__ x,
                            long long* __restrict__ stats, int T, int D,
                            int E) {
    __shared__ int next[MAX_EXPERTS];   // this segment's first row of e
    __shared__ int total[MAX_EXPERTS];
    __shared__ int warp_count[SCATTER_WARPS][MAX_EXPERTS];
    __shared__ int row1[SEG];
    __shared__ int row2[SEG];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int seg = blockIdx.x;
    // Every expert's count and the earlier segments' share of it: a warp an
    // expert at a time, lanes over the segments.
    for (int e = warp; e < E; e += SCATTER_WARPS) {
        int all = 0, before = 0;
        for (int s = lane; s < nseg; s += 32) {
            const int c = seg_counts[e * nseg + s];
            all += c;
            if (s < seg) before += c;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            all += __shfl_xor_sync(FULL, all, o);
            before += __shfl_xor_sync(FULL, before, o);
        }
        if (lane == 0) {
            total[e] = all;
            next[e] = before;
        }
    }
    __syncthreads();
    if (warp == 0) {
        const int c = lane < E ? total[lane] : 0;
        const int n = lane < E ? (c + BLOCK_M - 1) / BLOCK_M : 0;
        int incl = c, nincl = n, busiest = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int a = __shfl_up_sync(FULL, incl, o);
            const int b = __shfl_up_sync(FULL, nincl, o);
            if (lane >= o) {
                incl += a;
                nincl += b;
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            busiest = max(busiest, __shfl_xor_sync(FULL, busiest, o));
        if (lane < E) next[lane] += incl - c;
        if (seg == 0) {
            if (lane < E) {
                offsets[lane] = incl - c;
                tiles[lane] = nincl - n;
            }
            if (lane == E - 1) {
                offsets[E] = incl;
                tiles[E] = nincl;
                stats[0] = incl;
                stats[1] = busiest;
            }
        }
    }
    __syncthreads();
    // Ranks in token order: within the warp by ballot, then past the
    // earlier warps' counts and the earlier segments' rows.
    const int t = seg * SEG + threadIdx.x;
    const bool valid = t < T;
    const int2 ee = valid ? reinterpret_cast<const int2*>(expert)[t]
                          : make_int2(-1, -1);
    const unsigned below = (1u << lane) - 1u;
    int r1 = 0, r2 = 0;
    for (int e = 0; e < E; ++e) {
        const unsigned bal = __ballot_sync(FULL, ee.x == e || ee.y == e);
        const int rank = __popc(bal & below);
        if (ee.x == e) r1 = rank;
        if (ee.y == e) r2 = rank;
        if (lane == 0) warp_count[warp][e] = __popc(bal);
    }
    __syncthreads();
    if (valid) {
        for (int v = 0; v < warp; ++v) {
            r1 += warp_count[v][ee.x];
            r2 += warp_count[v][ee.y];
        }
        r1 += next[ee.x];
        r2 += next[ee.y];
        reinterpret_cast<int2*>(slot)[t] = make_int2(r1, r2);
    }
    row1[threadIdx.x] = r1;
    row2[threadIdx.x] = r2;
    __syncthreads();
    // The copies: a warp a token's row, 16 bytes a lane.
    const int vecs = D / 8;
    const int n = min(SEG, T - seg * SEG);
    for (int i = warp; i < n; i += SCATTER_WARPS) {
        const uint4* src = reinterpret_cast<const uint4*>(
            u + static_cast<size_t>(seg * SEG + i) * D);
        uint4* d1 = reinterpret_cast<uint4*>(
            x + static_cast<size_t>(row1[i]) * D);
        uint4* d2 = reinterpret_cast<uint4*>(
            x + static_cast<size_t>(row2[i]) * D);
        for (int v = lane; v < vecs; v += 32) {
            const uint4 val = __ldg(src + v);
            d1[v] = val;
            d2[v] = val;
        }
    }
}

__device__ __forceinline__ unsigned int pack(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned int*>(&h);
}

// bf16(z + (g1 y1 + g2 y2)) for the two values of each word.
__device__ __forceinline__ unsigned int mix(unsigned int z, unsigned int y1,
                                            unsigned int y2, float g1,
                                            float g2) {
    const float a = __fadd_rn(
        lo(z), __fadd_rn(__fmul_rn(g1, lo(y1)), __fmul_rn(g2, lo(y2))));
    const float b = __fadd_rn(
        hi(z), __fadd_rn(__fmul_rn(g1, hi(y1)), __fmul_rn(g2, hi(y2))));
    return pack(a, b);
}

__global__ void __launch_bounds__(COMBINE_THREADS)
moe_combine_kernel(const __nv_bfloat16* __restrict__ z,
                   const __nv_bfloat16* __restrict__ y,
                   const int* __restrict__ slot,
                   const float* __restrict__ gate,
                   __nv_bfloat16* __restrict__ out, int T, int D) {
    const int vecs = D / 8;
    const long long n = static_cast<long long>(T) * vecs;
    const uint4* z4 = reinterpret_cast<const uint4*>(z);
    const uint4* y4 = reinterpret_cast<const uint4*>(y);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
         i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
        const int t = static_cast<int>(i / vecs);
        const int v = static_cast<int>(i - static_cast<long long>(t) * vecs);
        const int2 s = __ldg(reinterpret_cast<const int2*>(slot) + t);
        const float2 g = __ldg(reinterpret_cast<const float2*>(gate) + t);
        const uint4 a = __ldg(z4 + i);
        const uint4 p = __ldg(y4 + static_cast<long long>(s.x) * vecs + v);
        const uint4 q = __ldg(y4 + static_cast<long long>(s.y) * vecs + v);
        uint4 r;
        r.x = mix(a.x, p.x, q.x, g.x, g.y);
        r.y = mix(a.y, p.y, q.y, g.x, g.y);
        r.z = mix(a.z, p.z, q.z, g.x, g.y);
        r.w = mix(a.w, p.w, q.w, g.x, g.y);
        o4[i] = r;
    }
}

bool shapes_ok(int T, int D, int E) {
    return T >= 1 && D >= 8 && D % 8 == 0 && E >= 4 && E <= MAX_EXPERTS &&
           (E & (E - 1)) == 0 && 2LL * T < 0x7fffffffLL;
}

size_t route_smem(int D, int E, int segs_per_block) {
    return (static_cast<size_t>(D) * E + static_cast<size_t>(segs_per_block)
            * E) * sizeof(float);
}

// A route kernel's shared-memory limit, raised once per device and expert
// count at the first call (a warm-up, before any capture).
template <int E>
cudaError_t launch_route(const __nv_bfloat16* u, const float* w, int* expert,
                         float* gate, int* seg_counts, int T, int D,
                         int blocks, int segs_per_block, int nseg,
                         cudaStream_t s) {
    static size_t allowed[64] = {0};
    const size_t smem = route_smem(D, E, segs_per_block);
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || allowed[dev] < smem) {
        err = cudaFuncSetAttribute(moe_dispatch_route_kernel<E>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return err;
        if (dev < 64) allowed[dev] = smem;
    }
    moe_dispatch_route_kernel<E><<<blocks, ROUTE_THREADS, smem, s>>>(
        u, w, expert, gate, seg_counts, T, D, segs_per_block, nseg);
    return cudaGetLastError();
}

}  // namespace

// Kernel M1, phase 0 (route: ``blocks`` blocks of ``segs_per_block``
// segments of 256 consecutive tokens) or 1 (scatter: a block a segment).
// ``seg_counts`` (E, segments) holds each segment's per-expert counts
// between the two.
extern "C" int synergy_moe_dispatch(
        int phase, const void* u, const float* w, int* expert, float* gate,
        int* seg_counts, int* offsets, int* tiles, int* slot, void* x,
        long long* stats, int T, int D, int E, int blocks, int segs_per_block,
        void* stream) {
    const int nseg = (T + SEG - 1) / SEG;
    if (!shapes_ok(T, D, E) || blocks < 1 || segs_per_block < 1 ||
        static_cast<long long>(blocks) * segs_per_block < nseg ||
        u == nullptr || expert == nullptr ||
        seg_counts == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const __nv_bfloat16* ub = static_cast<const __nv_bfloat16*>(u);
    if (phase == 0) {
        if (w == nullptr || gate == nullptr ||
            route_smem(D, E, segs_per_block) > 227 * 1024)
            return static_cast<int>(cudaErrorInvalidValue);
        cudaError_t err;
        switch (E) {
            case 4: err = launch_route<4>(ub, w, expert, gate, seg_counts, T,
                                          D, blocks, segs_per_block, nseg, s);
                    break;
            case 8: err = launch_route<8>(ub, w, expert, gate, seg_counts, T,
                                          D, blocks, segs_per_block, nseg, s);
                    break;
            case 16: err = launch_route<16>(ub, w, expert, gate, seg_counts,
                                            T, D, blocks, segs_per_block,
                                            nseg, s);
                     break;
            default: err = launch_route<32>(ub, w, expert, gate, seg_counts,
                                            T, D, blocks, segs_per_block,
                                            nseg, s);
        }
        return static_cast<int>(err);
    }
    if (phase != 1 || offsets == nullptr || tiles == nullptr ||
        slot == nullptr || x == nullptr || stats == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    moe_dispatch_scatter_kernel<<<nseg, SEG, 0, s>>>(
        ub, expert, seg_counts, nseg, offsets, tiles, slot,
        static_cast<__nv_bfloat16*>(x), stats, T, D, E);
    return static_cast<int>(cudaGetLastError());
}

// Kernel M2 over ``blocks`` blocks (a grid-stride loop).
extern "C" int synergy_moe_combine(const void* z, const void* y,
                                   const int* slot, const float* gate,
                                   void* out, int T, int D, int blocks,
                                   void* stream) {
    if (T < 1 || D < 8 || D % 8 != 0 || blocks < 1 || z == nullptr ||
        y == nullptr || slot == nullptr || gate == nullptr || out == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    moe_combine_kernel<<<blocks, COMBINE_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(z),
        static_cast<const __nv_bfloat16*>(y), slot, gate,
        static_cast<__nv_bfloat16*>(out), T, D);
    return static_cast<int>(cudaGetLastError());
}
