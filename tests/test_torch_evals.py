"""The port's eval harness against the JAX package's: the NME and FOE
math (numpy copies: equal), ``benchmark_params`` on the same parameters,
and ``benchmark_pipeline`` with the shipped trained weights on the
synthetic AFLW2000 pack.

Tolerances: the NME and FOE means of ``benchmark_params`` within 1e-4
(percent and degrees: the two packages' fp32 landmark and pose decodes
differ by ~1e-5 px and ~1e-6 deg); ``benchmark_pipeline`` within 1e-3
(fp32 MobileNetV2 forwards, param62 within the atol 1e-4 of
``test_torch_nn.py``).
"""

import jax
import numpy as np
import pytest
import torch

from synergynet_tpu import evals as jevals
from synergynet_tpu.core.checkpoint import load_shipped_trained
from synergynet_tpu.data import make_synthetic_aflw2000 as jax_aflw
from synergynet_tpu.data import TestTransform as JaxTestTransform
from synergynet_tpu.nn import SynergyNet as JaxSynergyNet
from synergynet_tpu_torch import evals as tevals
from synergynet_tpu_torch.convert import synergy_state_dict
from synergynet_tpu_torch.data import TestTransform, make_synthetic_aflw2000
from synergynet_tpu_torch.nn import SynergyNet

torch.set_num_threads(2)


def test_nme_and_foe_math_match():
    rng = np.random.default_rng(0)
    fit = rng.normal(60, 20, (20, 3, 68))
    gt = rng.normal(150, 40, (20, 3, 68))
    roi = np.concatenate([rng.uniform(0, 100, (20, 2)),
                          rng.uniform(200, 300, (20, 2))], 1)
    yaws = rng.uniform(-95, 95, 20)
    yaws[3] = 120.0
    want = jevals.calc_nme(fit, gt, roi)
    got = tevals.calc_nme(fit, gt, roi)
    np.testing.assert_array_equal(got, want)
    ja, ta = jevals.analyze_by_yaw(want, yaws), tevals.analyze_by_yaw(got,
                                                                      yaws)
    assert ta == ja
    assert tevals.format_nme_report(ta) == jevals.format_nme_report(ja)
    pred = rng.normal(0, 30, (20, 3))
    skip = np.array([3])
    pose = np.delete(rng.normal(0, 30, (20, 3)), skip, axis=0)
    jf = jevals.foe_mae(pred, pose, skip_indices=skip)
    tf = tevals.foe_mae(pred, pose, skip_indices=skip)
    assert tf == jf
    assert tevals.format_foe_report(tf) == jevals.format_foe_report(jf)


@pytest.fixture(scope="module")
def eval_pack():
    return make_synthetic_aflw2000(64, seed=11, device="cpu")


@pytest.mark.parametrize("which", ["gt", "noisy"])
def test_benchmark_params_matches(eval_pack, which):
    """The ground-truth parameters (the pack's self-check, ~0 NME) and a
    perturbed set."""
    jpack = jax_aflw(64, seed=11)
    params = eval_pack["params"]
    if which == "noisy":
        params = params + np.random.default_rng(1).normal(
            0, 0.05, params.shape).astype(np.float32)
    want = jevals.benchmark_params(params, jpack)
    got = tevals.benchmark_params(params, eval_pack)
    np.testing.assert_allclose(got["nme_mean"], want["nme_mean"], rtol=0,
                               atol=1e-4)
    for k in ("mae_mean", "mae_yaw", "mae_pitch", "mae_roll"):
        np.testing.assert_allclose(got["foe"][k], want["foe"][k], rtol=0,
                                   atol=1e-4)
    if which == "gt":
        assert got["nme_mean"] < 0.5 and got["foe"]["mae_mean"] < 0.5
    else:
        assert got["nme_mean"] > 0.5
    assert got["report"].splitlines()[1] == want["report"].splitlines()[1]


def test_benchmark_pipeline_matches(eval_pack):
    variables = load_shipped_trained("mobilenet_v2")
    want = jevals.benchmark_pipeline(JaxSynergyNet(), variables,
                                     jax_aflw(64, seed=11), std=130.0,
                                     batch=48, transform=JaxTestTransform())
    model = SynergyNet()
    model.load_state_dict(synergy_state_dict(variables))
    model.train()
    got = tevals.benchmark_pipeline(model, eval_pack, std=130.0, batch=48,
                                    transform=TestTransform())
    assert model.training                       # mode restored
    np.testing.assert_allclose(got["nme_mean"], want["nme_mean"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["foe"]["mae_mean"],
                               want["foe"]["mae_mean"], rtol=0, atol=1e-3)
    extract = tevals.make_param_extractor(model, std=130.0, batch=48)
    assert extract(eval_pack["images"][:0]).shape == (0, 62)
