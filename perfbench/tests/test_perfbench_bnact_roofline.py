"""The ``bnact_roofline.batch`` reader and its count: the bytes of the
served MobileNetV2's and ResNeSt-50's BatchNorm + activation + residual
sites against a tally of one forward of the program's backbones on the
CPU, by hand at small configurations, and nothing read where the trace has
no BN1 (the program before it)."""

import os
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness
from perfbench.counts import bn_act

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
READ = harness.load_module(ROOT, "metrics", "bnact_roofline.batch").read
CFGS = {name: harness.read_json(os.path.join(
    ROOT, "perfbench", "configs", f"{name}.json"))
    for name in ("synergy_mbv2", "synergy_resnest50", "synergy_vit_b16")}
KERNEL = ("void (anonymous namespace)::bnact_kernel<__nv_bfloat16, 2, 0>("
          "__nv_bfloat16 const*)")


def _tally(model, size):
    """Values the program's BN1 sites read and write in one forward of one
    face: each call's conv output, shortcut and result, from the tensors
    themselves."""
    from synergynet_tpu_torch.nn.backbones import mobilenet_v2, resnest
    from synergynet_tpu_torch.ops.bn_act import bn_act_reference
    seen = []

    def tally(x, bn, act="none", residual=None, residual_bn=None):
        out = bn_act_reference(x, bn, act, residual, residual_bn)
        seen.append(x.numel() + out.numel()
                    + (0 if residual is None else residual.numel()))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mobilenet_v2, "bn_act", tally)
        mp.setattr(resnest, "bn_act", tally)
        with torch.inference_mode():
            model.eval()(torch.zeros((1, size, size, 3)))
    return len(seen), sum(seen)


@pytest.mark.parametrize("config,sites,gb", [
    ("synergy_mbv2", 52, 8.263827456), ("synergy_resnest50", 51,
                                        18.904252416)])
def test_served_counts_equal_the_programs_tally(config, sites, gb):
    from synergynet_tpu_torch.nn.backbones.mobilenet_v2 import MobileNetV2
    from synergynet_tpu_torch.nn.backbones.resnest import make_resnest
    cfg = CFGS[config]
    r = cfg["regressor"]
    model = (MobileNetV2() if r["arch"] == "mobilenet_v2"
             else make_resnest(r["arch"]))
    n, values = _tally(model, r["crop"])
    assert n == sites
    assert bn_act.nbytes(r, "float32") == 4 * values
    assert bn_act.nbytes(r, cfg["dtype"]) == 2 * values
    # 1,024 faces: 8.26 GB (2.47 ms at 3.35 TB/s) and 18.9 GB (5.64 ms).
    assert 1024 * bn_act.nbytes(r, cfg["dtype"]) / 1e9 == pytest.approx(
        gb, abs=1e-9)


def test_resnest_by_hand_at_a_small_configuration():
    # ResNeSt, one block a stage for two stages at 32 pixels, radix 2,
    # stem 8: stem 16 x 16 (8, 8, 16 channels), pool 8 x 8; stage 0 width
    # 64: 2 x 64 x 64 + 2 x 128 x 64 + 3 x 256 x 64; stage 1 width 128,
    # stride 2 with avd: the split attention at 8 x 8, the end at 4 x 4.
    assert bn_act.resnest_values(32, (1, 1), 2, stem_width=8) == (
        2 * 32 * 256
        + 2 * 64 * 64 + 2 * 128 * 64 + 3 * 256 * 64
        + 2 * 128 * 64 + 2 * 256 * 64 + 3 * 512 * 16)
    # avd_first pools before the split attention; without avd it strides.
    for kw in ({"avd_first": True}, {"avd": False}):
        assert bn_act.resnest_values(32, (1, 1), 2, stem_width=8, **kw) == (
            2 * 32 * 256
            + 2 * 64 * 64 + 2 * 128 * 64 + 3 * 256 * 64
            + 2 * 128 * 64 + 2 * 256 * 16 + 3 * 512 * 16)


def test_no_sites_in_a_transformer():
    assert bn_act.nbytes(CFGS["synergy_vit_b16"]["regressor"],
                         "bfloat16") is None


def _rec(cfg, per_op_s, calls=10):
    return SimpleNamespace(trace={"per_op_s": per_op_s, "calls": calls},
                           traffic={"frames_per_call": 128}, cfg=cfg)


@pytest.mark.parametrize("config", ["synergy_mbv2", "synergy_resnest50"])
def test_bnact_roofline_is_the_bytes_bound_over_the_kernels_time(config):
    cfg = CFGS[config]
    t_bound = 1024 * bn_act.nbytes(cfg["regressor"], cfg["dtype"]) / 3.35e12
    rec = _rec(cfg, {KERNEL: 10 * t_bound,
                     KERNEL.replace("2, 0", "0, 1"): 10 * t_bound,
                     "batch_norm_transform_input": 1.0})
    assert READ(rec) == pytest.approx(50.0)


def test_bnact_roofline_reads_nothing_without_the_kernel():
    cfg = CFGS["synergy_mbv2"]
    assert READ(_rec(cfg, {
        "void at::native::batch_norm_transform_input_channels_last_kernel":
        4.92e-3})) is None
    assert READ(SimpleNamespace(trace=None, traffic={}, cfg={})) is None
    assert READ(_rec(CFGS["synergy_vit_b16"], {KERNEL: 1e-3})) is None
