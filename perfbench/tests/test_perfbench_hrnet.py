"""The HRNetV2-W18 cell on the CPU, at its published widths and a traffic a
test can hold: the run is judged correct and its control is not; the
exchange unit's byte count by hand; the ``hrfuse_`` readers on a synthetic
trace and on none; the widths the configuration, the counts, the reference
and the port's ``hrnetv2_w18`` use are one set."""

import os
from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.counts import hr_fuse

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "hrnetv2_w18.b128"
SMALL = {"frames_per_call": 1, "ring": 1, "check_calls": 1,
         "check_rounds": 1}
KERNEL = ("void (anonymous namespace)::hrfuse_kernel<__nv_bfloat16, 4, 1>("
          "__nv_bfloat16 const*)")


def test_hrnet_cell_runs_correct_and_reads_no_trace():
    out = harness.run_cell(ROOT, CELL, 2147483700, 0.3, False, 0.0,
                           device="cpu", traffic_override=SMALL)
    assert out["result"]["correct"], out["check"]
    bench, _, traffic, cfg = harness.load_cell(ROOT, CELL)
    names = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    assert names >= {"hrfuse_ms.batch", "hrfuse_roofline.batch",
                     "mfu.batch", "stage_regress_ms.batch"}
    assert "bnact_roofline.batch" not in names
    rec = SimpleNamespace(trace=None, cfg=cfg, traffic=traffic)
    for name in ("hrfuse_ms.batch", "hrfuse_roofline.batch"):
        assert harness.load_module(ROOT, "metrics", name).read(rec) is None


def test_hrnet_control_fails_the_limits():
    """The reference in fp8 in the program's place fails at least one of
    the cell's numbers."""
    from perfbench.calibrate import control_numbers
    limits = harness.load_cell(ROOT, CELL)[2]["limits"]
    numbers = control_numbers(ROOT, CELL, 23, "cpu", SMALL)
    assert any(numbers[k] > v for k, v in limits.items()), numbers


def test_exchange_bytes_by_hand():
    # Stage 2's unit at 256: branches of 18 at 64 x 64 and 36 at 32 x 32.
    # Output 0: the identity and the output (2 x 18 x 64^2) and branch 1's
    # 1x1 conv output before its upsample (18 x 32^2); output 1: the
    # identity, the output and branch 0's stride-2 conv output (3 x 36 x
    # 32^2).
    assert hr_fuse.unit_values([64, 32], [18, 36]) == \
        2 * 18 * 64 ** 2 + 18 * 32 ** 2 + 3 * 36 * 32 ** 2 == 276_480
    cfg = harness.load_cell(ROOT, CELL)[3]
    per_face = hr_fuse.nbytes(cfg["regressor"], cfg["dtype"])
    assert per_face == 2 * 2_987_136
    assert hr_fuse.values(256, [18, 36, 72, 144], [1, 0, 0]) == 276_480
    # 1,024 faces: 6.12 GB, 1.83 ms at 3.35 TB/s.
    assert 1024 * per_face == 6_117_654_528
    assert hr_fuse.nbytes(cfg["regressor"], "float32") == 2 * per_face


def test_hrfuse_roofline_is_the_bytes_bound_over_the_kernels_time():
    """A trace whose F1 kernels take four times the bound a call reads 25%
    and the kernels' ms; ops of other names are not counted."""
    _, _, traffic, cfg = harness.load_cell(ROOT, CELL)
    t_bound = 6_117_654_528 / 3.35e12
    rec = SimpleNamespace(
        trace={"per_op_s": {KERNEL: 10 * 3 * t_bound,
                            KERNEL.replace(", 4, 1>", ", 16, 3>"):
                                10 * t_bound,
                            "void bnact_kernel<...>": 5.0}, "calls": 10},
        traffic=traffic, cfg=cfg)
    read = harness.load_module(ROOT, "metrics", "hrfuse_roofline.batch").read
    assert read(rec) == pytest.approx(25.0, abs=1e-9)
    ms = harness.load_module(ROOT, "metrics", "hrfuse_ms.batch").read(rec)
    assert ms == pytest.approx(4e3 * t_bound, abs=1e-9)


def test_hrnet_widths_agree_across_configuration_counts_and_port():
    """The configuration's widths, modules and blocks are the ones the FLOP
    count, the reference's tree and the port's ``hrnetv2_w18`` build, so
    ``mfu.batch`` and ``hrfuse_roofline.batch`` count the model the
    program runs."""
    import inspect

    from perfbench.counts import call_flops, hrnetv2_w18
    from perfbench.reference.regressors import hrnetv2_w18 as ref
    from synergynet_tpu_torch.nn.backbones.hrnet import HRNet
    cfg = harness.load_cell(ROOT, CELL)[3]
    r = cfg["regressor"]
    port = {k: p.default for k, p in inspect.signature(
        HRNet).parameters.items()}
    from synergynet_tpu_torch.nn.backbones import hrnet
    assert (tuple(r["widths"]), tuple(r["modules"]), r["blocks"],
            r["stem_width"], r["layer1_blocks"], r["crop"]) \
        == (hrnetv2_w18.WIDTHS, hrnetv2_w18.MODULES, hrnetv2_w18.BLOCKS,
            hrnetv2_w18.STEM, 4, 256) \
        == (ref.WIDTHS, ref.MODULES, ref.BLOCKS, ref.STEM, ref.LAYER1, 256) \
        == (hrnet.WIDTHS, tuple(port["modules"]), hrnet.BLOCKS, hrnet.STEM,
            hrnet.LAYER1, HRNet.input_size)
    assert r["head_width"] == sum(r["widths"]) == 270
    # ~4.59 G multiply-adds a face at 256 (the paper's 4.3 G leaves out the
    # 270 x 270 head conv, 0.30 G here).
    assert hrnetv2_w18.flops(256) == 9_170_574_024
    assert call_flops(cfg, 128, 1024) > 1024 * hrnetv2_w18.flops(256)
