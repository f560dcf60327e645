"""The port's detector training against the JAX package's, on the CPU.

- ``center_to_corner``, ``jaccard``, ``encode`` and ``match`` (padded
  rows, a padded row that argmaxes to anchor 0, two GTs that claim one
  anchor) on the detector's own anchors: labels exact, IoU and targets
  within 1e-6 (f32 arithmetic in a different order);
- ``multibox_loss``, with tied confidence losses so the hard-negative
  ranking's tie-break shows: within 1e-6 relative;
- ``make_synthetic_detection_batch``: the same draws, bit for bit;
- one ``DetectorTrainer`` step (256x256, batch 8) from the JAX trainer's
  own weights on the same batch: the losses within 1e-4 relative (one f32
  forward), the parameter update, the momentum trace and the running
  statistics per leaf within 5e-2 of the leaf's scale (the single-step
  gradient bound of a random-init BatchNorm net, ``test_torch_train_nn.py``);
- 20 port steps lower the loss; the folded net refuses train mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synergynet_tpu.detect import train_utils as jtu
from synergynet_tpu.detect.anchors import generate_anchors as jax_anchors
from synergynet_tpu.detect.trainer import DetectorTrainer as JaxTrainer
from synergynet_tpu.detect.trainer import \
    make_synthetic_detection_batch as jax_batch
from synergynet_tpu_torch.detect import (DetectorTrainer, FaceBoxesNet,
                                         center_to_corner, encode, jaccard,
                                         make_synthetic_detection_batch,
                                         match, multibox_loss)

torch.set_num_threads(2)

UPDATE_REL = 5e-2


def _boxes(rng, b, g):
    xy = rng.uniform(0, 0.7, (b, g, 2))
    wh = rng.uniform(0.05, 0.3, (b, g, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_math_matches_jax():
    rng = np.random.default_rng(0)
    anchors = np.asarray(jax_anchors(256, 256), np.float32)
    a = _boxes(rng, 1, 7)[0]
    np.testing.assert_allclose(
        center_to_corner(torch.from_numpy(anchors)).numpy(),
        np.asarray(jtu.center_to_corner(jnp.asarray(anchors))), atol=1e-7)
    corners = np.array(jtu.center_to_corner(jnp.asarray(anchors)))
    np.testing.assert_allclose(
        jaccard(torch.from_numpy(a), torch.from_numpy(corners)).numpy(),
        np.asarray(jtu.jaccard(jnp.asarray(a), jnp.asarray(corners))),
        rtol=1e-6, atol=1e-7)
    matched = corners + rng.normal(0, 0.01, corners.shape).astype(np.float32)
    np.testing.assert_allclose(
        encode(torch.from_numpy(matched), torch.from_numpy(anchors)).numpy(),
        np.asarray(jtu.encode(jnp.asarray(matched), jnp.asarray(anchors))),
        rtol=1e-5, atol=1e-5)


def test_match_matches_jax():
    rng = np.random.default_rng(1)
    anchors = np.asarray(jax_anchors(256, 256), np.float32)
    boxes = _boxes(rng, 6, 4)
    valid = rng.uniform(size=(6, 4)) < 0.7
    valid[:, 0] = True
    boxes[1, 3] = 0.0                  # a pad row that argmaxes to anchor 0
    valid[1, 3] = False
    boxes[2, 1] = boxes[2, 0]          # two GTs claim one anchor
    valid[2, :2] = True
    boxes[3] = [[0.0, 0.0, 0.05, 0.05]] * 4      # everything near anchor 0
    valid[3] = [True, False, True, False]
    want = jax.vmap(jtu.match, in_axes=(0, 0, None, None))(
        jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(anchors), 0.35)
    got = match(torch.from_numpy(boxes), torch.from_numpy(valid),
                torch.from_numpy(anchors), 0.35)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.int32 and int(got[1].sum()) > 6
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    # one sample at a time, as JAX's match takes it
    one = match(torch.from_numpy(boxes[2]), torch.from_numpy(valid[2]),
                torch.from_numpy(anchors))
    np.testing.assert_array_equal(one[1].numpy(), np.asarray(want[1])[2])


def test_multibox_loss_matches_jax_with_ties():
    rng = np.random.default_rng(2)
    b, a = 3, 500
    loc_pred = rng.normal(0, 0.5, (b, a, 4)).astype(np.float32)
    conf = rng.normal(0, 1, (b, a, 2)).astype(np.float32)
    conf[:, ::7] = conf[:, :1]             # many tied confidence losses
    loc_t = rng.normal(0, 0.5, (b, a, 4)).astype(np.float32)
    labels = (rng.uniform(size=(b, a)) < 0.03).astype(np.int32)
    labels[2] = 0                          # a sample with no positive
    want = jtu.multibox_loss(*map(jnp.asarray, (loc_pred, conf, loc_t,
                                                labels)))
    got = multibox_loss(*map(torch.from_numpy, (loc_pred, conf, loc_t,
                                                labels)))
    for k in ("loss_loc", "loss_conf", "loss_total"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-6, err_msg=k)
    for ratio in (1, 3):
        w = jtu.multibox_loss(*map(jnp.asarray, (loc_pred, conf, loc_t,
                                                 labels)),
                              neg_pos_ratio=ratio)
        g = multibox_loss(*map(torch.from_numpy, (loc_pred, conf, loc_t,
                                                  labels)),
                          neg_pos_ratio=ratio)
        np.testing.assert_allclose(float(g["loss_conf"]),
                                   float(w["loss_conf"]), rtol=1e-6)


def test_synthetic_detection_batch_is_jax_s():
    got = make_synthetic_detection_batch(np.random.default_rng(4), 3)
    want = jax_batch(np.random.default_rng(4), 3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float64)


def _assert_rel(got, want, what):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want), what
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        bound = UPDATE_REL * max(np.abs(w).max(), 1e-2 * top)
        err = np.abs(got[k] - w).max()
        assert err <= bound, f"{what} {k}: {err:.3e} > {bound:.3e}"


def _minus(a, b):
    b = dict(_leaves(b))
    return {k: v - b[k] for k, v in _leaves(a)}


def test_detector_trainer_step_matches_jax():
    jt = JaxTrainer(seed=0)
    init = jax.device_get(jt.variables)
    tt = DetectorTrainer(variables=init, device="cpu")
    batch = make_synthetic_detection_batch(np.random.default_rng(7), 8)
    want = jt.train_step(batch)
    got = tt.train_step(batch)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got, want)
    after = jax.device_get(jt.variables)
    mine = tt.variables
    _assert_rel(_minus(mine["params"], init["params"]),
                _minus(after["params"], init["params"]), "update")
    _assert_rel(mine["batch_stats"], after["batch_stats"], "batch_stats")
    jtrace = jax.device_get(jt.opt_state[0].trace)
    from synergynet_tpu_torch.convert import flax_from_state_dict
    _assert_rel(flax_from_state_dict(tt.state._trace_views())["params"],
                jtrace, "trace")
    assert int(tt.state.count) == 1


def test_detector_trainer_lowers_the_loss_and_folded_nets_refuse_train():
    tt = DetectorTrainer(seed=0, device="cpu")
    hist = tt.fit_synthetic(steps=20, batch=8, seed=0)
    losses = [h["loss_total"] for h in hist]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert tt.net.training and not tt.net.folded
    folded = FaceBoxesNet()
    assert not folded.training
    with pytest.raises(ValueError, match="inference-only"):
        folded.train()
    folded.eval()
