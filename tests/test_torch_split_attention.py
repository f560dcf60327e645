"""ResNeSt's split-attention radix combine (``ops/split_attention.py``) on
the CPU: the wrappers run their plain twins on a CPU tensor and raise on a
device they do not serve, the shapes at every radix (1, 2, 4) and
cardinality (1, 2, 4) the registry builds, the gradient through the twins,
and kernel R1's order of operations (written out in torch) against the
twins at the tolerances ``tests/test_torch_gpu.py`` holds R1 to. R1 itself
runs only on a card (``tests/test_torch_gpu.py -k splat``)."""

import pytest
import torch

from synergynet_tpu_torch.nn.backbones.resnest import SplAtConv2d
from synergynet_tpu_torch.ops.cuda_build import launches
from synergynet_tpu_torch.ops.split_attention import (
    radix_combine, radix_combine_reference, radix_pool, radix_pool_reference)

torch.set_num_threads(2)

# (radix, cardinality) pairs that RESNEST_LAYERS and RESNEST_FAST_VARIANTS
# build.
VARIANTS = [(2, 1), (1, 1), (4, 1), (1, 2), (2, 2), (1, 4)]


def _inputs(b, radix, c, h, w, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    y = torch.relu(torch.randn((b, radix * c, h, w), generator=g)).to(dtype)
    logits = (2 * torch.randn((b, radix * c, 1, 1), generator=g)).to(dtype)
    return y.contiguous(memory_format=torch.channels_last), logits


@pytest.mark.parametrize("radix,groups", VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_run_the_twins_on_the_cpu(radix, groups, dtype):
    c = 8 * groups
    y, logits = _inputs(3, radix, c, 5, 7, dtype, seed=radix + groups)
    before = launches.copy()
    pooled = radix_pool(y, radix)
    out = radix_combine(y, logits, radix, groups)
    assert launches == before
    assert pooled.shape == (3, c, 1, 1) and pooled.dtype == dtype
    assert out.shape == (3, c, 5, 7) and out.dtype == dtype
    assert torch.equal(pooled, radix_pool_reference(y, radix))
    assert torch.equal(out, radix_combine_reference(y, logits, radix, groups))


def test_twins_are_the_blocks_expressions():
    """The pool is the mean of the radix sum; the combine's weights are a
    softmax over radix in the (cardinality, radix, c / cardinality) layout
    and sum to 1 for each channel; at radix 1 the weight is a sigmoid."""
    y, logits = _inputs(2, 2, 4, 3, 3, torch.float64)
    torch.testing.assert_close(
        radix_pool_reference(y, 2)[..., 0, 0],
        (y[:, :4] + y[:, 4:]).mean(dim=(2, 3)))
    ones = torch.ones_like(y)
    torch.testing.assert_close(radix_combine_reference(ones, logits, 2, 2),
                               torch.ones((2, 4, 3, 3), dtype=torch.float64))
    lg = logits.reshape(2, 2, 2, 2)              # (B, groups, radix, c/g)
    want_w0 = torch.softmax(lg, dim=2)[:, :, 0].reshape(2, 4, 1, 1)
    torch.testing.assert_close(
        radix_combine_reference(torch.cat([ones[:, :4], 0 * ones[:, 4:]], 1),
                                logits, 2, 2), want_w0.expand(2, 4, 3, 3))
    torch.testing.assert_close(
        radix_combine_reference(y[:, :4], logits[:, :4], 1, 4),
        y[:, :4] * torch.sigmoid(logits[:, :4]))


def test_wrappers_raise_on_other_devices():
    y = torch.empty((2, 16, 3, 3), device="meta")
    logits = torch.empty((2, 16, 1, 1), device="meta")
    with pytest.raises(ValueError):
        radix_pool(y, 2)
    with pytest.raises(ValueError):
        radix_combine(y, logits, 2, 1)
    with pytest.raises(ValueError):
        radix_combine(torch.zeros((2, 16, 3, 3)), logits, 2, 1)


@pytest.mark.parametrize("radix,groups", VARIANTS)
def test_block_gradient_flows_through_the_twins(radix, groups):
    blk = SplAtConv2d(16 * groups, 8 * groups, groups=groups, radix=radix)
    x = torch.randn((2, 16 * groups, 6, 5), requires_grad=True)
    out = blk(x)
    assert out.shape == (2, 8 * groups, 6, 5)
    out.square().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert blk.Conv_2.weight.grad.abs().sum() > 0


def _ulps(got, want):
    """Distance in bf16 steps between two bf16 tensors of one sign."""
    return (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()


def _r1_pool(y, radix, lanes):
    """R1's pool written out: per position the radix sum in f32, rounded to
    y's dtype; each lane (positions p = lane mod lanes) sums its positions
    in f32 in order; the lanes' sums are added in lane order, times
    1 / (H W) in f32, rounded once."""
    b, rc, h, w = y.shape
    c = rc // radix
    pos = y.float().permute(0, 2, 3, 1).reshape(b, h * w, radix, c)
    s = pos[:, :, 0]
    for r in range(1, radix):
        s = s + pos[:, :, r]
    s = s.to(y.dtype).float()
    part = torch.zeros((b, lanes, c))
    for p in range(h * w):
        part[:, p % lanes] += s[:, p]
    total = torch.zeros((b, c))
    for lane in range(lanes):
        total += part[:, lane]
    inv = torch.tensor(1.0 / (h * w), dtype=torch.float32)
    return (total * inv).to(y.dtype).reshape(b, c, 1, 1)


@pytest.mark.parametrize("radix,c,h,w,lanes", [
    (2, 64, 30, 30, 32), (2, 128, 15, 15, 16), (4, 64, 8, 8, 32),
    (1, 96, 15, 15, 21)])
def test_r1_pool_order_within_one_bf16_step_of_the_twin(radix, c, h, w,
                                                        lanes):
    """The order of R1's spatial sum moves the pooled mean by at most one
    bf16 step from the twin's (tests/test_torch_gpu.py's bf16 tolerance),
    and by f32 rounding alone in f32 (its rtol 1e-5)."""
    y, _ = _inputs(3, radix, c, h, w, torch.bfloat16, seed=c)
    got = _r1_pool(y, radix, lanes)
    assert _ulps(got, radix_pool_reference(y, radix)).max() <= 1
    y32 = y.float()
    torch.testing.assert_close(_r1_pool(y32, radix, lanes),
                               radix_pool_reference(y32, radix), rtol=1e-5,
                               atol=0)
