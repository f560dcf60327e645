"""The backbone families in train mode against flax's: one case per family
(MobileNetV1, ResNet, GhostNet, ResNeSt; MobileNetV2 is
``tests/test_torch_train_nn.py``'s), outputs and updated BatchNorm
statistics against ``apply(..., train=True, mutable=["batch_stats"])`` on
numpy-seeded weights and crops; and one SGD step of ``resnet18``
SynergyNet through ``train/step.py`` against the JAX step.

Tolerances:

- float64 on both sides (``jax.enable_x64``): outputs atol 1e-9 and
  running statistics rtol 1e-9 / atol 1e-12 (``test_torch_train_nn.py``'s
  float64 bound), which holds the math of the two implementations equal.
- fp32: the train-mode BatchNorm normalizes with the fast variance
  E[x^2] - E[x]^2 of each batch, and ResNeSt's attention BatchNorm does so
  over one pooled value per crop, so fp32 rounding in another order moves
  the result by more than the forward's 1e-4 (measured 3.6e-3 on the
  outputs of resnest50). The bound is ``test_torch_train_step.py``'s:
  the forward's tolerance (outputs atol 1e-4, statistics rtol 1e-4 /
  atol 1e-5) plus 10x the most JAX's own leaf moves when the crops move
  by one part in 1e7.
- The resnet18 step: ``test_torch_train_step.py``'s tolerances for one
  fp32 step (updates and momentum within 5e-2 of each leaf's scale plus
  10x JAX's own move under the nudge; the running statistics rtol 1e-4 /
  atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synergynet_tpu.nn.synergy as jsyn
from synergynet_tpu.mm3d import load_param_pack as jax_load_pack
from synergynet_tpu.nn.backbones import make_backbone as jax_backbone
from synergynet_tpu.nn.backbones.resnet import make_resnet as jax_resnet
from synergynet_tpu.train import step as jstep
from synergynet_tpu_torch.convert import (flax_from_state_dict,
                                          state_dict_from_flax,
                                          synergy_state_dict)
from synergynet_tpu_torch.mm3d import load_param_pack
from synergynet_tpu_torch.nn.backbones import make_backbone
from synergynet_tpu_torch.nn.synergy import SynergyNet
from synergynet_tpu_torch.train.step import TrainState, make_train_step
from tests.test_torch_backbones import backbone_tree
from tests.test_torch_train_step import (B, UPDATE_REL, _batches, _leaves,
                                         _nudged, _optimizers,
                                         assert_close_rel, minus)

torch.set_num_threads(2)

TRAIN_B = 8
OUT_TOL = {"float64": 1e-9, "float32": 1e-4}
STATS_TOL = {"float64": dict(rtol=1e-9, atol=1e-12),
             "float32": dict(rtol=1e-4, atol=1e-5)}


def _jax_train(arch, variables, x, dtype):
    """JAX's (param62, feat) and updated batch_stats leaves, float64."""
    m = jax_backbone(arch, dtype=getattr(jnp, dtype), dropout=0.0)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
    (p, f), upd = jax.jit(lambda v, x: m.apply(
        v, x, train=True, mutable=["batch_stats"]))(tree, jnp.asarray(
            x.astype(dtype)))
    return ([np.asarray(p, np.float64), np.asarray(f, np.float64)],
            dict(_leaves(jax.device_get(upd["batch_stats"]))))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("arch", ["mobilenet_1", "resnet18", "ghostnet",
                                  "resnest50_fast_2s2x40d"])
def test_train_mode_matches_flax(arch, dtype):
    variables = backbone_tree(jax_backbone(arch, dropout=0.0), seed=2)
    u8 = np.random.default_rng(5).integers(0, 256, (TRAIN_B, 120, 120, 3))
    x = (u8 - 127.5) / 128.0
    with jax.enable_x64(dtype == "float64"):
        want, want_stats = _jax_train(arch, variables, x, dtype)
        spread = None
        if dtype == "float32":
            nudged = x * (1 + 1e-7 * np.random.default_rng(99).normal(
                size=x.shape))
            spread = _jax_train(arch, variables, nudged, dtype)
    tdt = getattr(torch, dtype)
    tm = make_backbone(arch, dtype=tdt, dropout=0.0).to(tdt)
    tm.load_state_dict({k: v.to(tdt) for k, v in
                        state_dict_from_flax(variables).items()})
    tm.train()
    with torch.no_grad():
        got = [o.double().numpy() for o in tm(torch.from_numpy(
            x.astype(dtype)))]
    got_stats = dict(_leaves(flax_from_state_dict(
        dict(tm.named_buffers()))["batch_stats"]))
    assert sorted(got_stats) == sorted(want_stats)
    for i, (g, w) in enumerate(zip(got, want)):
        bound = OUT_TOL[dtype]
        if spread is not None:
            bound += 10 * np.abs(spread[0][i] - w).max()
        err = np.abs(g - w).max()
        assert err <= bound, f"output {i}: {err:.3e} > {bound:.3e}"
    tol = STATS_TOL[dtype]
    for k, w in want_stats.items():
        bound = tol["atol"] + tol["rtol"] * np.abs(w)
        if spread is not None:
            bound = bound + 10 * np.abs(spread[1][k] - w).max()
        err = np.abs(got_stats[k] - w)
        assert (err <= bound).all(), f"{k}: {err.max():.3e}"


@pytest.fixture
def jax_resnet18(monkeypatch):
    monkeypatch.setattr(jsyn, "make_backbone", lambda arch, dtype: jax_resnet(
        "resnet18", dropout=0.0, dtype=dtype))
    return jsyn.SynergyNet(arch="resnet18", dtype=jnp.float32)


def test_resnet18_sgd_step_matches_jax(jax_resnet18):
    """One fp32 step of the full SynergyNet criterion (the head's dropout
    at 0 on both sides) from the same JAX-initialised state, on the same
    seeded batch."""
    batches = _batches(1, seed=3)
    jopt, topt = _optimizers()
    jstate = jstep.create_train_state(jax_resnet18, jax.random.PRNGKey(0),
                                      jopt)
    init = jax.device_get({"params": jstate.params,
                           "batch_stats": jstate.batch_stats})
    jfn = jax.jit(jstep.make_train_step(jax_resnet18, jax_load_pack(), jopt))
    runs = []
    for bs in (batches, _nudged(batches)):
        (img, tgt), = bs
        st, _ = jfn(jstate, jnp.asarray(img), jnp.asarray(tgt),
                    jax.random.PRNGKey(1))
        runs.append(jax.device_get(st))
    want, spread = runs

    tm = SynergyNet(arch="resnet18", dtype=torch.float32, dropout=0.0)
    tm.load_state_dict(synergy_state_dict(init))
    tfn = make_train_step(load_param_pack(), topt, device="cpu")
    (img, tgt), = batches
    tstate, m = tfn(TrainState(tm, 5e-4), torch.from_numpy(img),
                    torch.from_numpy(tgt))
    assert img.shape[0] == B and float(m["skipped"]) == 0.0
    tree = tstate.tree()
    assert int(tree["step"]) == int(want.step) == 1
    rel = UPDATE_REL["float32"]
    assert_close_rel(minus(tree["params"], init["params"]),
                     minus(want.params, init["params"]), rel, "update",
                     minus(spread.params, init["params"]))
    assert_close_rel(tree["opt_state"]["1"]["trace"],
                     want.opt_state[1].trace, rel, "trace",
                     spread.opt_state[1].trace)
    got, ref = dict(_leaves(tree["batch_stats"])), dict(
        _leaves(want.batch_stats))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
