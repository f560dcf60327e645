"""The V-MoE-B/16 cell's files and readers, on the CPU without running the
cell (its 965M-value regressor is the card's work): the cell reports the
ViT metrics and the MoE ones; the ``moe_`` readers on a synthetic trace
and on none; ``moe_load_max.batch`` on a program's tallies and on a
program without them; the call's FLOPs."""

import os
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness
from perfbench.counts import call_flops, moe, vit_b16, vmoe_b16

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "vmoe_b16.b128"
MOE = ("moe_ms.batch", "moe_gemm_roofline.batch",
       "moe_dispatch_roofline.batch", "moe_combine_roofline.batch")


def _read(name, rec):
    return harness.load_module(ROOT, "metrics", name).read(rec)


def test_cell_reports_the_vit_and_moe_metrics_and_reads_no_trace():
    bench, _, traffic, cfg = harness.load_cell(ROOT, CELL)
    names = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    assert names >= {"attn_ms.batch", "attn_roofline.batch", "mfu.batch",
                     "stage_regress_ms.batch", "moe_load_max.batch",
                     "cudnn_pad_ms.batch", *MOE}
    assert not names & {"bnact_roofline.batch", "hrfuse_ms.batch",
                        "splat_roofline.batch"}
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, False)} \
        == {"faces_per_s", "setup_s"}
    rec = SimpleNamespace(trace=None, cfg=cfg, traffic=traffic)
    for name in MOE:
        assert _read(name, rec) is None


def test_moe_readers_are_the_bounds_over_the_kernels_time():
    """A trace whose kernels each take four times their bound a call reads
    25% in each roofline; ``moe_ms.batch`` sums the three; ops of other
    names are not counted."""
    _, _, traffic, cfg = harness.load_cell(ROOT, CELL)
    t = 1024 * 197
    g1 = 6 * 4 * 2 * t * 768 * 3072 / 989e12
    m1 = 6 * moe.dispatch_bytes(t, 768, 32, 2, "bfloat16") / 3.35e12
    m2 = 6 * moe.combine_bytes(t, 768, 2, "bfloat16") / 3.35e12
    assert g1 == pytest.approx(23.0999e-3, rel=1e-4)
    rec = SimpleNamespace(trace={"per_op_s": {
        "moe_gemm_kernel": 10 * 4 * g1,
        "moe_dispatch_route_kernel(__nv_bfloat16 const*)": 10 * 2 * m1,
        "moe_dispatch_scatter_kernel(__nv_bfloat16 const*)": 10 * 2 * m1,
        "moe_combine_kernel(...)": 10 * 4 * m2,
        "nvjet_tst_192x192_bias_TNN": 5.0}, "calls": 10},
        traffic=traffic, cfg=cfg)
    for name in MOE[1:]:
        assert _read(name, rec) == pytest.approx(25.0, abs=1e-9), name
    assert _read("moe_ms.batch", rec) == pytest.approx(
        4e3 * (g1 + m1 + m2), abs=1e-9)


def test_load_max_reads_the_tallies_and_nothing_without_them():
    """Two calls of 6 MoE layers, each layer's busiest expert 3 times the
    mean of 32: 3.0; a program that tallies no routing reads nothing."""
    from synergynet_tpu_torch.core.profiling import recorder
    _, _, traffic, cfg = harness.load_cell(ROOT, CELL)
    rec = SimpleNamespace(trace=None, cfg=cfg, traffic=traffic)
    recorder.reset()
    rows = 2 * 1024 * 197
    st = recorder.program("process_batch.b128", "test#moe", "cpu",
                          ("copy_in", "clone_out"),
                          ("faces", "moe_rows", "moe_rows_max"), 128)
    st.calls = 2
    st.sequence.tallies.add_(torch.tensor([2048, 2 * 6 * rows,
                                           2 * 6 * 3 * rows // 32]))
    assert _read("moe_load_max.batch", rec) == pytest.approx(3.0)
    st.sequence.tallies.zero_()
    st.sequence.tallies[0] = 2048
    assert _read("moe_load_max.batch", rec) is None
    recorder._programs.remove(st)
    assert _read("moe_load_max.batch", rec) is None


def test_call_flops_are_vit_b16s_plus_the_second_expert_and_router():
    _, _, _, cfg = harness.load_cell(ROOT, CELL)
    per_face = vit_b16.flops(224) + 6 * (2 * 197 * 2 * 768 * 3072
                                         + 2 * 197 * 768 * 32)
    assert vmoe_b16.flops(224) == per_face
    assert per_face / 1e9 == pytest.approx(46.34, abs=0.01)
    assert call_flops(cfg, 128, 1024) > 1024 * per_face
