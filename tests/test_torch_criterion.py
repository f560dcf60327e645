"""The port's ``synergy_criterion`` against the JAX package's: the five
weighted terms, the total, the gradients with respect to every parameter
of the backbone and both synergy MLPs, and the running statistics each
module leaves behind (each BatchNorm moved once), on the same
JAX-initialised weights and seeded batch.

The models are those of ``test_torch_train_step.py`` (dropout 0, a
three-stage MobileNetV2 at width 0.35; in float64 the JAX MLPs are float64
too). Tolerances:

- the terms and the total: rtol 1e-4 (one fp32 forward through some 30
  layers on the same weights; the losses are fp32 on both sides);
- running statistics: rtol 1e-4 / atol 1e-5 in fp32, rtol 1e-9 in float64;
- gradients, per leaf over the leaf's scale: float64 within 5e-3 (the
  fp32 losses' rounding amplified by the BatchNorm backward, as in the
  step test), fp32 within 5e-2 plus 10x JAX's own move for a batch moved
  by one part in 1e7 (the measured ill-conditioning at a random init).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synergynet_tpu.nn.synergy as jsyn
from synergynet_tpu.mm3d import load_param_pack as jax_load_pack
from synergynet_tpu_torch.convert import flax_from_state_dict
from synergynet_tpu_torch.convert import synergy_state_dict
from synergynet_tpu_torch.mm3d import load_param_pack
from synergynet_tpu_torch.nn.synergy import (LOSS_WEIGHTS, SynergyNet,
                                             synergy_criterion)
from tests.test_torch_train_step import (SETTING, WIDTH, _batches,
                                         _f64_pack, _leaves, _nudged,
                                         assert_close_rel,
                                         jax_model)  # noqa: F401

torch.set_num_threads(2)

GRAD_REL = {"float64": 5e-3, "float32": 5e-2}


def _jax_criterion(model, variables, pack):
    def f(params, images, target):
        total, losses, upd = jsyn.synergy_criterion(
            model, {"params": params,
                    "batch_stats": variables["batch_stats"]},
            images, target, pack, train=True)
        return total, (losses, upd)
    return jax.jit(jax.value_and_grad(f, has_aux=True))


def _jax_side(jax_model, dtype, img, tgt):
    jm = jax_model(getattr(jnp, dtype))
    variables = jax.device_get(jsyn.init_synergy_variables(
        jm, jax.random.PRNGKey(0)))
    if dtype == "float64":
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                 variables)
    fn = _jax_criterion(jm, variables, jax_load_pack())
    out = []
    for im in (img, _nudged([(img, tgt)])[0][0]):
        (total, (losses, upd)), g = fn(variables["params"],
                                       jnp.asarray(im), jnp.asarray(tgt))
        out.append(jax.device_get((total, losses, upd, g)))
    return variables, out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_criterion_matches_jax(jax_model, dtype):
    img, tgt = _batches(1)[0]
    if dtype == "float64":
        img, tgt = img.astype(np.float64), tgt.astype(np.float64)
        with jax.enable_x64(True):
            variables, runs = _jax_side(jax_model, dtype, img, tgt)
    else:
        variables, runs = _jax_side(jax_model, dtype, img, tgt)
    (jtotal, jlosses, jupd, jgrads), (_, _, _, jgrads_n) = runs

    tdt = torch.float64 if dtype == "float64" else torch.float32
    model = SynergyNet(dtype=getattr(torch, dtype), dropout=0.0,
                       width_mult=WIDTH, setting=SETTING)
    model.load_state_dict(synergy_state_dict(variables))
    model = model.to(tdt).train()
    pack = load_param_pack()
    if dtype == "float64":
        pack = _f64_pack(pack)
    total, losses = synergy_criterion(model, torch.from_numpy(img),
                                      torch.from_numpy(tgt), pack)
    total.backward()

    assert sorted(losses) == sorted(LOSS_WEIGHTS) == sorted(jlosses)
    for k in LOSS_WEIGHTS:
        np.testing.assert_allclose(losses[k].item(), float(jlosses[k]),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-4)
    np.testing.assert_allclose(total.item(), sum(
        v.item() for v in losses.values()), rtol=1e-6)

    stats = flax_from_state_dict(dict(model.named_buffers()))["batch_stats"]
    want = dict(_leaves(jupd["batch_stats"]))
    got = dict(_leaves(stats))
    assert sorted(got) == sorted(want)
    for k in want:
        tol = (dict(rtol=1e-9, atol=1e-12) if dtype == "float64"
               else dict(rtol=1e-4, atol=1e-5))
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)

    grads = flax_from_state_dict({k: p.grad for k, p in
                                  model.named_parameters()})["params"]
    assert_close_rel(grads, jgrads, GRAD_REL[dtype], "grad",
                     None if dtype == "float64" else jgrads_n)
