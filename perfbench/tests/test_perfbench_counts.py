"""The work counts, by hand at small shapes and pinned at the cells'."""

import os

import pytest
import torch

from perfbench import harness
from perfbench.counts import (call_flops, conv, crop, decode, faceboxes,
                              mobilenet_v2, nms, raster, resnest50, stem)


def test_conv_and_pool_by_hand():
    # 2x2 output, 3x3 kernel, 4 -> 8 channels: 2 * 4 * 9 * 4 * 8
    assert conv.conv_flops(2, 2, 3, 4, 8) == 2304
    assert conv.conv_flops(2, 2, 3, 8, 8, groups=8) == 2 * 4 * 9 * 8
    assert conv.pool_flops(2, 3, 3, 5) == 270
    assert conv.out_size(720, 7, 4, 3) == 180
    assert conv.out_size(45, 3, 2, 1) == 23
    assert conv.out_size(3, 2, 2, 0, ceil=True) == 2


def test_published_regressor_sizes():
    # MobileNetV2 1.0: 300M multiply-adds at 224 (arXiv:1801.04381,
    # table 2); ResNeSt-50: 5.39G at 224 (arXiv:2004.08955, table 3).
    assert mobilenet_v2.flops(224) / 2 == pytest.approx(300e6, rel=0.01)
    assert resnest50.flops(224) / 2 == pytest.approx(5.39e9, rel=0.01)


def test_stem_counts_the_7x7_conv_not_the_folded_one():
    nbytes, ops = stem.work(1, 8, 8, elem=2)
    # conv out 2x2 (pad 3, stride 4), pool out 1x1.
    assert ops == 2 * 4 * 49 * 3 * 24 + 9 * 48
    assert nbytes == 2 * (8 * 8 * 3 + 48)
    nbytes, ops = stem.work(128, 720, 1088)
    assert (nbytes, ops) == (752_025_600, 44_895_928_320)


def test_decode_by_hand_and_at_1024_faces():
    assert decode.flops(2, 10) == 2 * 10 * 325
    nbytes, ops = decode.work(1, 100)
    assert nbytes == 4 * (62 + 3 * 128 * 51 + 300)
    assert decode.work(1024) == (686_747_648, 17_709_952_000)


def test_crop_is_bilinear_taps():
    assert crop.flops(2, 1) == 2 * 2 * 4 * 2 + 4 * 2 * 4
    assert crop.flops(120) == 347_520
    assert crop.nbytes(2, 1) == 2 * 2 * 4 + 4 * 4
    assert crop.nbytes(120) == 172_816


def test_nms_work_by_hand():
    valid = torch.tensor([[True, True, False, True]])
    keep = torch.tensor([[True, False, False, True]])
    nbytes, ious, steps = nms.work(torch, valid, keep)
    # box 0 kept against valid 1 and 3, box 3 kept against none after it.
    assert (nbytes, ious, steps) == (4 * 18, 2, 4)
    assert nms.bound_s(0, 1e6, 1, 1e3, 15e6, 1.0) == pytest.approx(1.0)


def test_raster_by_hand():
    nbytes, ops = raster.work(3, 1, 3, 5, 2, 2, 2, 4)
    assert nbytes == 4 * 3 * 6 + 4 * 3 + 2 * 2 * 4 * 4
    assert ops == 53 + 65 + 2 * (41 + 48)


def test_model_flops_of_a_call():
    cfg = {"canvas": [720, 1088],
           "regressor": {"arch": "mobilenet_v2", "crop": 120}}
    per_face = (crop.flops(120) + mobilenet_v2.flops(120)
                + decode.flops(1, decode.NVER) + decode.flops(1, 68))
    assert call_flops(cfg, 128, 1024) == 128 * faceboxes.flops(720, 1088) \
        + 1024 * per_face
    assert faceboxes.flops(720, 1088) == pytest.approx(1.425e9, rel=1e-3)


@pytest.mark.parametrize("config,flops", [
    ("synergy_mbv2", 391_378_615_296),
    ("synergy_resnest50", 3_553_748_401_152)])
def test_call_flops_of_the_configurations_pinned(config, flops):
    """The operations of a 128-frame call with 1,024 faces that
    ``mfu.batch`` divides by, as they stood before the crop size was read
    from the configuration."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfg = harness.read_json(os.path.join(root, "perfbench", "configs",
                                         f"{config}.json"))
    assert call_flops(cfg, 128, 1024) == flops
