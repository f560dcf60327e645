"""The ``cudnn_pad_ms.batch`` reader: cuDNN's NHWC channel pad and slice
copies summed per traced call, 0 on a trace without them, nothing without
a trace."""

import os
from types import SimpleNamespace

import pytest

from perfbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
READ = harness.load_module(ROOT, "metrics", "cudnn_pad_ms.batch").read
PAD = ("void cudnn::engines_precompiled::nhwcAddPaddingKernel<__nv_bfloat16,"
       " __nv_bfloat16, float, true, cudnn::engines_precompiled::"
       "nhwc_pad_t>(cudnn::engines_precompiled::nhwcAddPaddingParams)")
SLICE = ("void cudnn::engines_precompiled::nhwcSliceCKernel<__nv_bfloat16, "
         "__nv_bfloat16, float>(cudnn::engines_precompiled::"
         "nhwcSliceCParams)")
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"


def _rec(per_op_s, calls=10):
    return SimpleNamespace(trace={"per_op_s": per_op_s, "calls": calls},
                           traffic={}, cfg={})


def test_sums_both_copies_per_traced_call():
    rec = _rec({PAD: 0.6913, SLICE: 0.004, CONV: 1.0, "memset32": 0.0862})
    assert READ(rec) == pytest.approx(1e3 * (0.6913 + 0.004) / 10)
    assert READ(_rec({PAD: 0.02}, calls=4)) == pytest.approx(5.0)


def test_reads_zero_on_a_trace_without_them():
    assert READ(_rec({CONV: 1.0, "memset32": 0.01})) == 0.0


def test_reads_nothing_without_a_trace():
    assert READ(SimpleNamespace(trace=None, traffic={}, cfg={})) is None
