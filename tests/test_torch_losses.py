"""The port's losses against the JAX package's: values and gradients of
``wing_loss`` and of ``param_loss`` in its three modes, on the same seeded
inputs.

Tolerance: both sides compute in fp32 with the same branch structure; the
means reduce in another order, so values and gradients are held to
rtol 1e-5 (a few fp32 ulps of a mean over a few hundred terms)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synergynet_tpu import losses as jl
from synergynet_tpu_torch import losses as tl

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-7)


def _pair(seed, shape, scale):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, scale, shape).astype(np.float32)
    b = rng.normal(0, scale, shape).astype(np.float32)
    return a, b


def _torch_value_and_grad(fn, a, b):
    ta = torch.tensor(a, requires_grad=True)
    out = fn(ta, torch.tensor(b))
    out.sum().backward()
    return out.detach().numpy(), ta.grad.numpy()


@pytest.mark.parametrize("scale", [1.0, 8.0, 30.0])
def test_wing_loss_matches(scale):
    """Scales that put the deltas in the log branch, across omega, and
    in the linear branch; one exact zero delta (abs's gradient is 0)."""
    a, b = _pair(1, (6, 3, 68), scale)
    b[0, 0, 0] = a[0, 0, 0]
    want, want_g = jax.value_and_grad(jl.wing_loss)(jnp.asarray(a),
                                                    jnp.asarray(b))
    got, got_g = _torch_value_and_grad(tl.wing_loss, a, b)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got_g, np.asarray(want_g), **TOL)


@pytest.mark.parametrize("mode", ["normal", "only_3dmm",
                                  "only_3dmm_aligned"])
def test_param_loss_matches(mode):
    a, b = _pair(2, (8, 62), 1.0)
    fn = lambda x, y: jl.param_loss(x, y, mode=mode)    # noqa: E731
    want = fn(jnp.asarray(a), jnp.asarray(b))
    want_g = jax.grad(lambda x: jnp.sum(fn(x, jnp.asarray(b))))(
        jnp.asarray(a))
    got, got_g = _torch_value_and_grad(
        lambda x, y: tl.param_loss(x, y, mode=mode), a, b)
    assert got.shape == (8,)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got_g, np.asarray(want_g), **TOL)


def test_only_3dmm_keeps_the_slice_asymmetry():
    """Quirk Q3: pred[:, :50] against target[:, 12:62]."""
    a, b = _pair(3, (4, 62), 1.0)
    b[:, 12:62] = a[:, :50]
    got = tl.param_loss(torch.tensor(a), torch.tensor(b), mode="only_3dmm")
    assert torch.equal(got, torch.zeros(4))
    with pytest.raises(ValueError):
        tl.param_loss(torch.tensor(a), torch.tensor(b), mode="other")
