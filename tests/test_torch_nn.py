"""The port's SynergyNet forward on the shipped trained weights, converted
from the flax tree, against JAX ``model.apply(..., train=False)``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synergynet_tpu.core.checkpoint import load_shipped_trained
from synergynet_tpu.nn import SynergyNet as JaxSynergyNet
from synergynet_tpu_torch.convert import synergy_state_dict
from synergynet_tpu_torch.core.checkpoint import (load_trained_variables,
                                                  shipped_trained_path)
from synergynet_tpu_torch.nn import SynergyNet

torch.set_num_threads(2)

# bf16 on both sides rounds every activation to 8 mantissa bits, in a
# different order per framework (XLA vs oneDNN convs). On these crops the
# params (|param62| up to ~6) differ by at most 0.018, a few bf16 ulps of
# their magnitude; the bound leaves ~4x room for other BLAS builds.
BF16_ATOL = 0.08


@pytest.fixture(scope="module")
def variables():
    return load_shipped_trained("mobilenet_v2")


@pytest.fixture(scope="module")
def crops():
    rng = np.random.default_rng(11)
    u8 = rng.integers(0, 256, (4, 120, 120, 3)).astype(np.float32)
    return (u8 - 127.5) / 128.0


def test_port_loader_matches_jax_loader(variables):
    got = load_trained_variables(shipped_trained_path("mobilenet_v2"))
    sd_got, sd_want = synergy_state_dict(got), synergy_state_dict(variables)
    assert sorted(sd_got) == sorted(sd_want)
    for k in sd_want:
        assert torch.equal(sd_got[k], sd_want[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype, variables, crops):
    want_p, want_f = JaxSynergyNet(dtype=getattr(jnp, dtype)).apply(
        variables, jnp.asarray(crops), train=False)
    model = SynergyNet(dtype=getattr(torch, dtype))
    model.load_state_dict(synergy_state_dict(variables))
    with torch.no_grad():
        p, f = model.eval()(torch.from_numpy(crops))
    assert p.dtype == f.dtype == torch.float32
    assert p.shape == (4, 62) and f.shape == (4, 1280)
    if dtype == "float32":
        np.testing.assert_allclose(p.numpy(), np.asarray(want_p), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(f.numpy(), np.asarray(want_f), rtol=0,
                                   atol=1e-4)
    else:
        np.testing.assert_allclose(p.numpy(), np.asarray(want_p), rtol=0,
                                   atol=BF16_ATOL)


def test_state_dict_covers_every_module_tensor(variables):
    """strict loading: each port tensor has a flax leaf, and back."""
    model = SynergyNet()
    sd = synergy_state_dict(variables)
    assert sorted(sd) == sorted(model.state_dict())
    assert sd["backbone.ConvBNReLU6_0.Conv_0.weight"].shape == (32, 3, 3, 3)
    assert sd["backbone.InvertedResidual_1.ConvBNReLU6_1.Conv_0.weight"
              ].shape == (96, 1, 3, 3)          # depthwise (C, 1, 3, 3)
    assert sd["backbone.ParamHead_0.fc_shape.weight"].shape == (40, 1280)

