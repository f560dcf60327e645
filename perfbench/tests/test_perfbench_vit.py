"""The ViT-B/16 cell on the CPU, at its published widths and a traffic a
test can hold: the run is judged correct, and its attention metrics read
nothing without a trace."""

import os
from types import SimpleNamespace

from perfbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "vit_b16.b128"
SMALL = {"frames_per_call": 1, "ring": 1, "check_calls": 1,
         "check_rounds": 1}


def test_vit_cell_runs_correct_and_reads_no_trace():
    out = harness.run_cell(ROOT, CELL, 2147483700, 0.3, False, 0.0,
                           device="cpu", traffic_override=SMALL)
    assert out["result"]["correct"], out["check"]
    bench, _, traffic, cfg = harness.load_cell(ROOT, CELL)
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, True)} >= {
        "attn_ms.batch", "attn_roofline.batch", "mfu.batch"}
    rec = SimpleNamespace(trace=None, cfg=cfg, traffic=traffic)
    for name in ("attn_ms.batch", "attn_roofline.batch"):
        assert harness.load_module(ROOT, "metrics", name).read(rec) is None


def test_vit_and_attention_counts_by_hand():
    from perfbench.counts import attention, call_flops, vit_b16
    # 196 patches of 16 x 16 x 3 into 768; 197 tokens through 12 blocks of
    # q/k/v (3 x 768), output (768) and MLP (2 x 3072) products and the
    # attention's two 197 x 197 x 64 products in 12 heads; the 12/40/10 head.
    blocks = 12 * (2 * 197 * 768 * (4 * 768 + 2 * 3072)
                   + 12 * 4 * 197 * 197 * 64)
    want = 2 * 196 * 768 * 768 + blocks + 2 * 768 * 62
    assert vit_b16.flops(224) == want == 35_126_215_680
    assert attention.nbytes(1024, 12, 12, 197, 64) == 14_873_001_984
    assert attention.flops(1024, 12, 12, 197, 64) == 1_464_990_695_424
    _, _, _, cfg = harness.load_cell(ROOT, CELL)
    assert call_flops(cfg, 128, 1024) > 1024 * want


def test_vit_widths_agree_across_configuration_counts_and_port():
    """The configuration's widths are the ones the FLOP count uses and the
    port's ``vit_b16`` builds, so mfu.batch and attn_roofline.batch count
    the model the program runs."""
    import inspect

    from perfbench.counts import vit_b16
    from synergynet_tpu_torch.nn.backbones.vit import VisionTransformer
    r = harness.load_cell(ROOT, CELL)[3]["regressor"]
    port = {k: p.default for k, p in inspect.signature(
        VisionTransformer).parameters.items()}
    assert (r["patch_size"], r["hidden_size"], r["num_layers"],
            r["num_heads"], r["mlp_dim"], r["crop"], r["layer_norm_eps"]) \
        == (vit_b16.PATCH, vit_b16.WIDTH, vit_b16.DEPTH, vit_b16.HEADS,
            vit_b16.MLP, 224, 1e-6) \
        == (port["patch"], port["width"], port["depth"], port["heads"],
            port["mlp_dim"], port["image_size"], port["eps"])
    assert r["head_dim"] * r["num_heads"] == r["hidden_size"]


def test_attention_roofline_is_the_bytes_bound_over_the_kernel_time():
    """At the cell's shape the attention is bound by its bytes: 14.87 GB
    at 3.35 TB/s; a trace whose flash kernels take four times that per
    call reads 25%, and ops of other names are not counted."""
    _, _, traffic, cfg = harness.load_cell(ROOT, CELL)
    t_bound = 14_873_001_984 / 3.35e12
    rec = SimpleNamespace(
        trace={"per_op_s": {
            "void pytorch_flash::flash_fwd_kernel<...>": 10 * 3 * t_bound,
            "void pytorch_flash::flash_fwd_splitkv_kernel<...>":
                10 * t_bound,
            "nvjet_tst_192x192_bias_TNN": 5.0}, "calls": 10},
        traffic=traffic, cfg=cfg)
    read = harness.load_module(ROOT, "metrics", "attn_roofline.batch").read
    assert abs(read(rec) - 25.0) < 1e-9
    ms = harness.load_module(ROOT, "metrics", "attn_ms.batch").read(rec)
    assert abs(ms - 4e3 * t_bound) < 1e-9


def test_vit_control_fails_the_limits():
    """The reference in fp8 in the program's place fails at least one of
    the cell's numbers."""
    from perfbench.calibrate import control_numbers
    limits = harness.load_cell(ROOT, CELL)[2]["limits"]
    numbers = control_numbers(ROOT, CELL, 23, "cpu", SMALL)
    assert any(numbers[k] > v for k, v in limits.items()), numbers
