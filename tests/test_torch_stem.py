"""The port's fused s2d8 stem (the plain twin of kernel B4) against the JAX
package's Pallas stem in interpret mode, on the same seeded inputs.

Tolerances: f32 at rtol 1e-5 / atol 1e-4 (``tests/test_detect.py``'s own
Pallas-vs-XLA stem tolerance; the two sum the taps in other orders); bf16
at rtol 1.6e-2 / atol 1e-5, bf16's own tolerance, since both round the
f32 result to bf16 once and an order difference can flip the last bit;
the twin against the port's XLA stem at f32 at the same 1e-5 / 1e-4.

The f32 kernel's arithmetic (3xTF32 on the tensor cores) is emulated here:
its operand split on the bit pattern, and its three partial products per
tap summed in float64, meet the f32 tolerance against the JAX stem, where
one TF32 pass does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synergynet_tpu.detect.detector import FaceBoxes as JaxFaceBoxes
from synergynet_tpu.detect.net import FaceBoxesNet as JaxFaceBoxesNet
from synergynet_tpu.detect.net import space_to_depth as jax_s2d
from synergynet_tpu.detect.stem_pallas import fused_stem1_s2d8 as jax_stem
from synergynet_tpu.detect.torch_import import random_init_variables
from synergynet_tpu_torch.detect import FaceBoxes
from synergynet_tpu_torch.detect.net import StemS2D8, phase_maxpool_s2d8
from synergynet_tpu_torch.detect.stem_fused import (
    fused_stem1_s2d8, fused_stem1_s2d8_reference, taps_from_oihw)
from synergynet_tpu_torch.ops.cuda_build import launches

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-4)
BF16 = dict(rtol=1.6e-2, atol=1e-5)


def _stem_inputs(seed, b=1, h8=8, w8=136):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 30, (b, h8, w8, 192)).astype(np.float32)
    k = rng.normal(0, 0.05, (2, 2, 192, 192)).astype(np.float32)
    bias = rng.normal(0, 0.5, (192,)).astype(np.float32)
    return x, k, bias


def test_taps_match_jax_reshape():
    _, k, _ = _stem_inputs(0)
    oihw = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    got = taps_from_oihw(oihw)
    assert got.shape == (4, 192, 192) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), k.reshape(4, 192, 192))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_jax_pallas_stem(dtype):
    x, k, bias = _stem_inputs(1)
    jdt = jnp.dtype(dtype)
    want = jax_stem(jnp.asarray(x, jdt), jnp.asarray(k, jdt),
                    jnp.asarray(bias, jdt), interpret=True, hb=4)
    want = np.array(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    k4 = torch.from_numpy(k.reshape(4, 192, 192)).to(tdt)
    bt = torch.from_numpy(bias).to(tdt)
    got = fused_stem1_s2d8_reference(xt, k4, bt)
    assert got.shape == (1, 8, 136, 48) and got.dtype == tdt
    tol = F32 if dtype == "float32" else BF16
    torch.testing.assert_close(got.float(), torch.from_numpy(want), **tol)
    # On a CPU tensor the entry point is the twin and counts no launch.
    before = launches["synergy_stem_s2d8"]
    assert torch.equal(fused_stem1_s2d8(xt, k4, bt), got)
    assert launches["synergy_stem_s2d8"] == before


@pytest.mark.parametrize("shape", [(2, 5, 17), (1, 1, 3), (1, 16, 136)])
def test_twin_matches_xla_stem_f32(shape):
    b, h8, w8 = shape
    x, k, bias = _stem_inputs(2, b, h8, w8)
    stem = StemS2D8()
    with torch.no_grad():
        stem.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        stem.bias.copy_(torch.from_numpy(bias))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        want = stem(xt, "xla")
        got = stem(xt, "pallas")
    assert got.shape == want.shape == (b, 48, h8, w8)
    torch.testing.assert_close(got, want, **F32)


def test_tap_weights_follow_the_weight():
    stem = StemS2D8()
    with torch.no_grad():
        stem.weight.normal_()
    t1 = stem.tap_weights()
    assert stem.tap_weights() is t1                 # cached
    with torch.no_grad():
        stem.weight.mul_(2.0)
    t2 = stem.tap_weights()
    assert t2 is not t1 and torch.equal(t2, 2.0 * t1)
    stem.to(torch.bfloat16)
    assert stem.tap_weights().dtype == torch.bfloat16


def test_net_with_fused_stem_matches_jax(rng):
    h, w = 256, 384
    variables = random_init_variables()
    jax_det = JaxFaceBoxes(variables=variables)
    img = rng.uniform(-120, 140, (2, h, w, 3)).astype(np.float32)
    x = np.ascontiguousarray(jax_s2d(img, 8))
    jnet = JaxFaceBoxesNet(stem_s2d=True, folded=True, stem_r=8,
                           stem_mode="pallas")
    jloc, jconf = jnet.apply(jax_det.variables, jnp.asarray(x), train=False)
    det = FaceBoxes(variables=jax.device_get(jax_det.variables),
                    device="cpu", stem_mode="pallas")
    assert det.net.stem_mode == "pallas"
    with torch.no_grad():
        loc, conf = det.net(torch.from_numpy(x))
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_pool_of_rounded_conv_equals_rounded_pool(seed):
    """The invariant kernel B4's bf16 conv tile rests on: rounding to
    nearest is monotonic, so pooling the bf16-rounded ReLU output gives,
    bit for bit, the bf16 rounding of the f32 pool. Seeded data with exact
    ties, zeros, negatives (ReLU'd to 0) and values one f32 ulp apart."""
    rng = np.random.default_rng(seed)
    y = rng.normal(0, 3, (2, 4 * 48, 9, 11)).astype(np.float32)
    y[:, :, ::3] = 0.0                                    # zero rows
    y[0, 48:96] = y[0, :48]                               # tied phases
    flat = y.reshape(-1)
    near = rng.choice(flat.size, flat.size // 4, replace=False)
    flat[near] = np.nextafter(flat[near - 1], np.float32(np.inf))
    relu = torch.relu(torch.from_numpy(y))
    want = phase_maxpool_s2d8(relu, 48).to(torch.bfloat16)
    got = phase_maxpool_s2d8(relu.to(torch.bfloat16), 48)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def _tf32_rna(a):
    """cvt.rna.tf32.f32 on the bit pattern: add 0x1000, mask 0xFFFFE000."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split_tf32(a):
    """a -> (hi, lo), hi = tf32(a), lo = tf32(a - hi) (a - hi is exact)."""
    hi = _tf32_rna(a)
    return hi, _tf32_rna(a - hi)


def _stem_conv_tf32(x, k, bias, passes):
    """The stem's conv, + bias, on TF32 operands, each product and every sum
    in float64: ``passes`` 3 sums lo.hi + hi.lo + hi.hi (3xTF32), 1 sums
    hi.hi (one TF32 pass). (B, H8, W8, C) -> (B, 4*cout, H8, W8)."""
    (xh, xl), (kh, kl) = _split_tf32(x), _split_tf32(k)
    terms = [(xl, kh), (xh, kl), (xh, kh)] if passes == 3 else [(xh, kh)]
    b, h8, w8, _ = x.shape
    y = np.zeros((b, h8, w8, k.shape[-1]))
    for xa, ka in terms:
        xp = np.pad(xa.astype(np.float64), ((0, 0), (1, 0), (1, 0), (0, 0)))
        for a in range(2):
            for c in range(2):
                y += xp[:, a:a + h8, c:c + w8] @ ka[a, c].astype(np.float64)
    return torch.from_numpy(y + bias).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def jax_stem_f32():
    x, k, bias = _stem_inputs(1)
    want = jax_stem(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                    interpret=True, hb=4)
    return x, k, bias, torch.from_numpy(np.array(want, np.float32))


@pytest.mark.parametrize("passes", [3, 1])
def test_tf32_passes_against_the_f32_tolerance(jax_stem_f32, passes):
    """3xTF32, then the twin's ReLU and pool, meets the f32 tolerance
    against the JAX Pallas stem; one TF32 pass misses it."""
    x, k, bias, want = jax_stem_f32
    y = _stem_conv_tf32(x, k, bias, passes)
    got = phase_maxpool_s2d8(torch.relu(y), 48).permute(0, 2, 3, 1).float()
    assert got.shape == want.shape == (1, 8, 136, 48)
    if passes == 3:
        torch.testing.assert_close(got, want, **F32)
    else:
        assert not torch.allclose(got, want, **F32)
