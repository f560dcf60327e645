"""The ``crop_roofline.batch`` reader: kernel C1's bytes bound at 1,024
faces over the trace's time per call, and nothing where the trace has no
C1 (a program that crops otherwise)."""

import os
from types import SimpleNamespace

import pytest

from perfbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
READ = harness.load_module(ROOT, "metrics", "crop_roofline.batch").read
C1 = "void (anonymous namespace)::crop_bilinear_kernel<true>(float const*)"


def _rec(per_op_s, calls=10):
    return SimpleNamespace(trace={"per_op_s": per_op_s, "calls": calls},
                           traffic={"frames_per_call": 128},
                           cfg={"max_faces": 8,
                                "regressor": {"crop": 120}})


def test_crop_roofline_is_the_bytes_bound_over_the_kernel_time():
    # 1,024 faces of 120 x 120 x 3 floats out and 4 floats in: 176,963,584
    # bytes, 52.8 us at 3.35 TB/s (0.36 GFLOP: 5.3 us at the f32 peak).
    t_bound = 1024 * (120 * 120 * 3 + 4) * 4 / 3.35e12
    rec = _rec({C1: 10 * 2 * t_bound, "sm80_xmma_gemm": 1.0,
                "crop_taps_kernel": 1.0})
    assert READ(rec) == pytest.approx(50.0)


def test_crop_roofline_reads_nothing_without_the_kernel():
    assert READ(_rec({"sm80_xmma_gemm_f32f32": 0.12})) is None
    assert READ(SimpleNamespace(trace=None, traffic={}, cfg={})) is None
