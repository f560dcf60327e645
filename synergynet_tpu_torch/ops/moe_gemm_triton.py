"""Kernel G1, the grouped expert GEMM of the mixture-of-experts layer, in
Triton. This module imports Triton when it is imported, so only
:func:`synergynet_tpu_torch.ops.moe.moe_gemm` imports it, at its first
launch on a card; everything else reaches G1 through that function.

``moe_gemm_kernel`` computes, for each expert e, ``out[r] = act(x[r] @
w[e] + b[e])`` over expert e's rows ``offsets[e] <= r < offsets[e + 1]``,
accumulated in f32 (``tl.dot``, which lowers to ``wgmma`` on sm_90a),
the bias added in f32 and ``act`` the exact (erf) GELU or none, rounded
once to bf16. A program computes one tile of ``BM`` rows of one expert and
``BN`` output columns: program ``pid`` takes row tile ``pid // (N / BN)``
of the concatenated per-expert tiles (``tiles``, M1's exclusive prefix of
``ceil(count / BM)``) and column block ``pid % (N / BN)``, so that
neighbouring programs share a row tile and an expert's weights stay in L2.
The grid is fixed when a graph is captured: ``ceil(rows / BM) + E`` row
tiles, the most any routing needs; a program past ``tiles[E]`` returns at
once. An expert with no rows has no tile; rows past an expert's end are
masked, in the loads and in the store.
"""

import triton
import triton.language as tl


@triton.jit
def moe_gemm_kernel(x_ptr, w_ptr, b_ptr, out_ptr, off_ptr, tile_ptr, N, K,
                    E: tl.constexpr, EP: tl.constexpr, GELU: tl.constexpr,
                    BM: tl.constexpr, BN: tl.constexpr, BK: tl.constexpr):
    pid = tl.program_id(0)
    n_blocks = N // BN
    m_tile = pid // n_blocks
    nb = pid % n_blocks
    if m_tile >= tl.load(tile_ptr + E):
        return
    idx = tl.arange(0, EP)
    ends = tl.load(tile_ptr + 1 + idx, mask=idx < E, other=2 ** 30)
    e = tl.sum((ends <= m_tile).to(tl.int32), axis=0)
    r0 = tl.load(off_ptr + e) + (m_tile - tl.load(tile_ptr + e)) * BM
    r1 = tl.load(off_ptr + e + 1)
    rows = r0 + tl.arange(0, BM)
    rmask = rows < r1
    cols = nb * BN + tl.arange(0, BN)
    ks = tl.arange(0, BK)
    a_ptrs = x_ptr + rows[:, None].to(tl.int64) * K + ks[None, :]
    w_ptrs = (w_ptr + e.to(tl.int64) * K * N + ks[:, None].to(tl.int64) * N
              + cols[None, :])
    acc = tl.zeros((BM, BN), dtype=tl.float32)
    for _ in range(0, K, BK):
        a = tl.load(a_ptrs, mask=rmask[:, None], other=0.0)
        b = tl.load(w_ptrs)
        acc = tl.dot(a, b, acc)
        a_ptrs += BK
        w_ptrs += BK * N
    acc += tl.load(b_ptr + e * N + cols).to(tl.float32)[None, :]
    if GELU:
        acc = 0.5 * acc * (1.0 + tl.erf(acc * 0.7071067811865476))
    tl.store(out_ptr + rows[:, None].to(tl.int64) * N + cols[None, :],
             acc.to(tl.bfloat16), mask=rmask[:, None])
