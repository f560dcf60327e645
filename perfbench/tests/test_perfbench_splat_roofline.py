"""The ``splat_roofline.batch`` reader and its count: ResNeSt-50's
split-attention bytes at the served configuration, by hand at a small
one, and nothing read where the trace has no R1 (the program before it)."""

import os
from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.counts import split_attention

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
READ = harness.load_module(ROOT, "metrics", "splat_roofline.batch").read
CFG = harness.read_json(os.path.join(ROOT, "perfbench", "configs",
                                     "synergy_resnest50.json"))
POOL = ("void (anonymous namespace)::splat_pool_kernel<__nv_bfloat16>("
        "__nv_bfloat16 const*)")
COMBINE = POOL.replace("pool", "combine")


def test_served_resnest50_bytes():
    # Radix tensors: 3 blocks of 900 x 128, one 900 x 256, 3 of 225 x 256,
    # one 225 x 512, 5 of 64 x 512, one 64 x 1024, 2 of 16 x 1024 values;
    # the combined tensors half as many (radix 2).
    radix = (3 * 900 * 128 + 900 * 256 + 3 * 225 * 256 + 225 * 512
             + 5 * 64 * 512 + 64 * 1024 + 2 * 16 * 1024)
    assert radix == 1_126_144
    assert split_attention.nbytes(CFG["regressor"], CFG["dtype"]) \
        == 2 * (radix + radix // 2)
    # 1,024 faces: 3.46 GB, 1.03 ms at 3.35 TB/s.
    assert 1024 * 2 * radix * 3 // 2 == 3_459_514_368


def test_by_hand_at_a_small_configuration():
    # 32 pixels: stem 16, pool 8; one block a stage at radix 4,
    # cardinality 2, width 32 (c = 32 x 2 = 64, then 128): stage 0 at
    # 8 x 8, stage 1 pooled after the split attention (avd), so at 8 x 8
    # too; avd_first pools before it (4 x 4); without avd it strides.
    assert split_attention.values(32, (1, 1), 4, 2, 32) \
        == 5 * 64 * 64 + 5 * 128 * 64
    assert split_attention.values(32, (1, 1), 4, 2, 32, avd_first=True) \
        == 5 * 64 * 64 + 5 * 128 * 16
    assert split_attention.values(32, (1, 1), 4, 2, 32, avd=False) \
        == 5 * 64 * 64 + 5 * 128 * 16


def _rec(per_op_s, calls=10):
    return SimpleNamespace(trace={"per_op_s": per_op_s, "calls": calls},
                           traffic={"frames_per_call": 128}, cfg=CFG)


def test_splat_roofline_is_the_bytes_bound_over_the_kernels_time():
    t_bound = 3_459_514_368 / 3.35e12
    rec = _rec({POOL: 10 * t_bound, COMBINE: 10 * t_bound,
                "reduce_kernel": 1.0})
    assert READ(rec) == pytest.approx(50.0)


def test_splat_roofline_reads_nothing_without_the_kernel():
    assert READ(_rec({"void at::native::reduce_kernel<512, 1>": 0.18})) \
        is None
    assert READ(SimpleNamespace(trace=None, traffic={}, cfg={})) is None
