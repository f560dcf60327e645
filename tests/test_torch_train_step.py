"""The port's training step against the JAX package's ``make_train_step``:
1 and 3 SGD steps, the NaN skip, ``accum_steps=2``, the uint8 path and the
schedule, from the same JAX-initialised state on the same seeded batches.

Both sides run the full SynergyNet criterion with the head's dropout at 0
(the two packages cannot draw the same masks; the JAX model is built with
``MobileNetV2(dropout=0.0)`` through a monkeypatched ``make_backbone``;
the port's dropout is tested in ``test_torch_train_nn.py``), on a
MobileNetV2 cut to three stages at width 0.35.

Tolerances, per leaf, as max |difference| over the leaf's scale (its
largest |value|, at least 1e-2 of the tree's; see
``test_torch_train_nn.py``):

- float64 on both sides (``jax.enable_x64``, the JAX synergy MLPs built
  in float64 too by monkeypatching ``MLPFor``/``MLPRev``): the parameter
  updates, the momentum trace and the running statistics within 5e-3.
  The losses are fp32 on both sides (``losses.py`` casts), so the
  cotangent entering the float64 backward differs at fp32 rounding, which
  the BatchNorm backward's cancellations amplify (measured up to 1.5e-3
  after three steps); fp32 chaos is 1e-2 to 1e-1, so this still holds
  the step's math equal.
- fp32: a random-init BN network's gradient is ill-conditioned (see
  ``test_torch_train_nn.py``), and more so over several steps, so the
  bound is measured in the test: the port may differ from JAX by 10x the
  most JAX's own result moves when the batches move by one part in 1e7
  (one seeded nudge samples one direction of the chaos, hence 10x),
  plus 5e-2 of the leaf's scale (the single-step gradient bound of
  ``test_torch_train_nn.py``). The running statistics after one step
  (one forward on the same weights) hold to rtol 1e-4 / atol 1e-5.
- The learning-rate count, the step and the NaN skip are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synergynet_tpu.nn.synergy as jsyn
from synergynet_tpu.mm3d import load_param_pack as jax_load_pack
from synergynet_tpu.nn.backbones.mobilenet_v2 import MobileNetV2 as JaxMNV2
from synergynet_tpu.nn.pointnet import MLPFor as JaxMLPFor
from synergynet_tpu.nn.pointnet import MLPRev as JaxMLPRev
from synergynet_tpu.train import schedule as jschedule
from synergynet_tpu.train import step as jstep
from synergynet_tpu_torch.convert import synergy_state_dict
from synergynet_tpu_torch.mm3d import ParamPack, load_param_pack
from synergynet_tpu_torch.nn.synergy import SynergyNet
from synergynet_tpu_torch.train import schedule as tschedule
from synergynet_tpu_torch.train.step import (TrainState, make_optimizer,
                                             make_train_step)

torch.set_num_threads(2)

WIDTH = 0.35
SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 2, 2))
B = 8
UPDATE_REL = {"float64": 5e-3, "float32": 5e-2}
LR = dict(base_lr=0.08, milestones=(2, 3), warmup=1, steps_per_epoch=2)
WD = 5e-4


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float64)


def assert_close_rel(got, want, rel, what, spread=None):
    """Per leaf: max |got - want| <= rel x the leaf's scale (at least 1e-2
    of the tree's) + 10 x max |spread - want| (JAX's own move)."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    spread = None if spread is None else dict(_leaves(spread))
    assert sorted(got) == sorted(want), what
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        bound = rel * max(np.abs(w).max(), 1e-2 * top)
        if spread is not None:
            bound += 10 * np.abs(spread[k] - w).max()
        err = np.abs(got[k] - w).max()
        assert err <= bound, f"{what} {k}: {err:.3e} > {bound:.3e}"


def minus(a, b):
    b = dict(_leaves(b))
    return {k: v - b[k] for k, v in _leaves(a)}


@pytest.fixture
def jax_model(monkeypatch):
    def make(dtype):
        monkeypatch.setattr(
            jsyn, "make_backbone", lambda arch, dtype: JaxMNV2(
                width_mult=WIDTH, setting=SETTING, dropout=0.0,
                dtype=dtype))
        if dtype == jnp.float64:
            monkeypatch.setattr(jsyn, "MLPFor", lambda dtype: JaxMLPFor(
                dtype=jnp.float64))
            monkeypatch.setattr(jsyn, "MLPRev", lambda dtype: JaxMLPRev(
                dtype=jnp.float64))
        return jsyn.SynergyNet(dtype=dtype)
    return make


def _batches(n, seed=0, u8=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = rng.integers(0, 256, (B, 120, 120, 3), np.uint8)
        if not u8:
            img = ((img.astype(np.float32) - 127.5) / 128.0)
        tgt = rng.normal(0, 0.5, (B, 62)).astype(np.float32)
        out.append((img, tgt))
    return out


def _optimizers():
    jlr = jschedule.lr_per_step(**LR)
    tlr = tschedule.lr_per_step(**LR)
    return (jstep.make_optimizer(jlr, weight_decay=WD),
            make_optimizer(tlr, weight_decay=WD))


def _f64_pack(pack):
    return ParamPack(*(t.double() if t.is_floating_point() else t
                       for t in pack))


def _nudged(batches):
    rng = np.random.default_rng(99)
    return [(img if img.dtype == np.uint8 else
             (img * (1 + 1e-7 * rng.normal(size=img.shape))).astype(
                 img.dtype), tgt) for img, tgt in batches]


def _jax_run(jax_model, dtype, batches, accum, nan_at):
    jd = getattr(jnp, dtype)
    jopt, _ = _optimizers()
    jm = jax_model(jd)
    jstate = jstep.create_train_state(jm, jax.random.PRNGKey(0), jopt)
    if dtype == "float64":
        jstate = jax.tree.map(
            lambda a: a.astype(jnp.float64)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, jstate)
    init = jax.device_get({"params": jstate.params,
                           "batch_stats": jstate.batch_stats})
    jfn = jax.jit(jstep.make_train_step(jm, jax_load_pack(), jopt,
                                        accum_steps=accum))
    runs = []
    for bs in (batches, _nudged(batches)):
        st, met = jstate, []
        for i, (img, tgt) in enumerate(bs):
            if i == nan_at:
                img = img.copy()
                img[0, 5, 5, 0] = np.nan
            st, m = jfn(st, jnp.asarray(img), jnp.asarray(tgt),
                        jax.random.PRNGKey(1))
            met.append(jax.device_get(m))
        runs.append((jax.device_get(st), met))
    return init, runs


def _run(jax_model, dtype, batches, accum=1, nan_at=None):
    """-> (JAX state, port state, JAX metrics, port metrics, initial
    variables, JAX state on the nudged batches)."""
    if dtype == "float64":
        batches = [(img if img.dtype == np.uint8 else
                    img.astype(np.float64), tgt.astype(np.float64))
                   for img, tgt in batches]
        with jax.enable_x64(True):
            init, runs = _jax_run(jax_model, dtype, batches, accum, nan_at)
    else:
        init, runs = _jax_run(jax_model, dtype, batches, accum, nan_at)
    (jstate, jmet), (jnudge, _) = runs
    _, topt = _optimizers()
    tdt = getattr(torch, dtype)
    tm = SynergyNet(dtype=tdt, dropout=0.0, width_mult=WIDTH,
                    setting=SETTING)
    tm.load_state_dict(synergy_state_dict(init))
    tm = tm.to(torch.float64 if dtype == "float64" else torch.float32)
    tstate = TrainState(tm, WD)
    pack = load_param_pack()
    if dtype == "float64":
        pack = _f64_pack(pack)
    tfn = make_train_step(pack, topt, accum_steps=accum, device="cpu")
    tmet = []
    for i, (img, tgt) in enumerate(batches):
        if i == nan_at:
            img = img.copy()
            img[0, 5, 5, 0] = np.nan
        tstate, m = tfn(tstate, torch.from_numpy(img), torch.from_numpy(tgt))
        tmet.append({k: v.item() for k, v in m.items()})
    return jstate, tstate, jmet, tmet, init, jnudge


def _check(jstate, tstate, init, dtype, nsteps, jnudge=None):
    rel = UPDATE_REL[dtype]
    spread = None if dtype == "float64" else jnudge
    tree = tstate.tree()
    assert int(tree["step"]) == int(jstate.step) == nsteps
    assert int(tree["opt_state"]["2"]["count"]) == int(
        jstate.opt_state[2].count)
    assert_close_rel(minus(tree["params"], init["params"]),
                     minus(jstate.params, init["params"]), rel, "update",
                     None if spread is None else minus(spread.params,
                                                       init["params"]))
    assert_close_rel(tree["opt_state"]["1"]["trace"],
                     jstate.opt_state[1].trace, rel, "trace",
                     None if spread is None else spread.opt_state[1].trace)
    if dtype == "float32" and nsteps == 1:
        got, want = dict(_leaves(tree["batch_stats"])), dict(
            _leaves(jstate.batch_stats))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    else:
        assert_close_rel(tree["batch_stats"], jstate.batch_stats, rel,
                         "batch_stats",
                         None if spread is None else spread.batch_stats)


def _check_metrics(jmet, tmet, rel=1e-3):
    for jm_, tm_ in zip(jmet, tmet):
        assert sorted(jm_) == sorted(tm_)
        for k in jm_:
            assert abs(tm_[k] - float(jm_[k])) <= rel * max(
                abs(float(jm_[k])), 1e-3), k


@pytest.mark.parametrize("dtype,nsteps", [("float32", 1), ("float32", 3),
                                          ("float64", 3)])
def test_sgd_steps_match_jax(jax_model, dtype, nsteps):
    jstate, tstate, jmet, tmet, init, jn = _run(jax_model, dtype,
                                                _batches(nsteps))
    _check(jstate, tstate, init, dtype, nsteps, jn)
    # The first step's losses come from the same weights: fp32 forward.
    _check_metrics(jmet[:1], tmet[:1])
    assert all(m["skipped"] == 0.0 for m in tmet)


def test_nan_skip_is_atomic_and_keeps_the_lr_count(jax_model):
    """A NaN pixel in step 2 of 3: that step leaves the state bit for bit
    as it found it but for ``step``; the optimizer count does not move, so
    step 3 takes the learning rate step 2 would have, as in JAX."""
    batches = _batches(3)
    jstate, tstate, jmet, tmet, init, jn = _run(jax_model, "float32",
                                                batches, nan_at=1)
    assert [m["skipped"] for m in tmet] == [0.0, 1.0, 0.0]
    assert [float(m["skipped"]) for m in jmet] == [0.0, 1.0, 0.0]
    assert int(jstate.opt_state[2].count) == 2
    _check(jstate, tstate, init, "float32", 3, jn)

    # Bit identity across the skipped step, on the port alone.
    _, topt = _optimizers()
    tm = SynergyNet(dropout=0.0, width_mult=WIDTH, setting=SETTING)
    tm.load_state_dict(synergy_state_dict(init))
    st = TrainState(tm, WD)
    fn = make_train_step(load_param_pack(), topt, device="cpu")
    fn(st, torch.from_numpy(batches[0][0]), torch.from_numpy(batches[0][1]))
    before = [t.clone() for t in (st.params, st.stats, st.trace, st.count)]
    bad = batches[1][0].copy()
    bad[0, 5, 5, 0] = np.nan
    _, m = fn(st, torch.from_numpy(bad), torch.from_numpy(batches[1][1]))
    assert isinstance(m["skipped"], torch.Tensor) and m["skipped"] == 1.0
    for a, b in zip(before, (st.params, st.stats, st.trace, st.count)):
        assert torch.equal(a, b)
    assert int(st.step) == 2


def test_accum_steps_2_matches_jax(jax_model):
    """Two microbatches of 4: chained BatchNorm statistics and the mean of
    the gradients, as the JAX scan."""
    jstate, tstate, jmet, tmet, init, jn = _run(jax_model, "float32",
                                                _batches(1), accum=2)
    _check(jstate, tstate, init, "float32", 1, jn)
    _check_metrics(jmet, tmet)


def test_uint8_batches_normalize_on_the_device(jax_model):
    """uint8 crops: (x - 127.5) / 128 inside the step, on both sides, and
    the same step as the pre-normalized float batch."""
    u8 = _batches(1, u8=True)
    jstate, tstate, jmet, tmet, init, _ = _run(jax_model, "float32", u8)
    _check(jstate, tstate, init, "float32", 1)
    _check_metrics(jmet, tmet)
    f32 = [((u8[0][0].astype(np.float32) - 127.5) / 128.0, u8[0][1])]
    _, tstate_f, _, tmet_f, _, _ = _run(jax_model, "float32", f32)
    assert torch.equal(tstate.params, tstate_f.params)
    assert tmet == tmet_f


def test_schedule_matches_jax():
    """Warmup (flat 0.2x), base, then each milestone, on step counts as
    the optimizer passes them (int32 tensors) and as Python ints."""
    kw = dict(base_lr=0.08, milestones=(48, 64), warmup=5,
              steps_per_epoch=7)
    jf, tf = jschedule.lr_per_step(**kw), tschedule.lr_per_step(**kw)
    steps = np.array([0, 6, 7, 34, 35, 36, 335, 336, 337, 447, 448, 449,
                      700], np.int32)
    want = np.asarray(jax.vmap(jf)(jnp.asarray(steps)))
    got = tf(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert sorted(set(np.round(want / 0.08, 6))) == [0.04, 0.2, 1.0]
    assert [float(tf(int(s))) for s in steps] == got.tolist()
    je = jschedule.step_decay_lr(0.08, (48, 64), 5)
    te = tschedule.step_decay_lr(0.08, (48, 64), 5)
    for e in (1, 5, 6, 48, 49, 64, 65, 80):
        assert abs(float(te(e)) - float(je(e))) <= 1e-6 * float(je(e))


def test_bn_groups_is_not_ported_yet():
    _, topt = _optimizers()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(load_param_pack(), topt, bn_groups=2, device="cpu")
