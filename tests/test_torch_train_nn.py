"""The port's train-mode modules against flax's: MobileNetV2 (fp32 and
bf16) and the synergy point nets, on the same seeded inputs and weights
(the JAX init through ``convert.py``).

Each comparison holds the outputs, the updated running statistics and the
gradients of a fixed random projection of the outputs with respect to
every parameter. Tolerances:

- fp32 outputs: atol 1e-4, as ``tests/test_torch_nn.py`` holds the
  inference forward; bf16 outputs: its ``BF16_ATOL``.
- Running statistics: the batch mean and variance reduce in fp32 in
  another order (XLA against ATen), so rtol 1e-4 / atol 1e-5 in fp32. In
  bf16 the statistics are of bf16 activations, which differ by bf16 ulps
  between the frameworks: rtol and atol 2e-2.
- Gradients, per leaf, as max |difference| over the leaf's scale (its
  largest |gradient|, at least 1e-2 of the tree's largest):
  - float64 on both sides (``jax.enable_x64``): 1e-6. Rounding is out of
    the way here, so this holds the math of the two implementations
    equal; the head's fp32 pooled feature (fp32 on both sides) sets the
    floor, measured ~2e-7.
  - fp32: 5e-2. At a random init a BN network's gradient is
    ill-conditioned: a ReLU kink or a cancelling E[x^2] - E[x]^2 turns a
    last-bit difference into percents (``test_torch_train_step.py``
    measures JAX's own move for an input moved by one part in 1e7).
  - bf16: against the fp32 gradient, within 2x the distance of JAX's own
    bf16 gradient from it (the error bf16 itself makes) plus 5e-2.

The backbone is cut to its first three stages at width 0.35 (``SETTING``),
a few layers that hold every block kind: the expansion-1 block, stride-2
blocks and residual blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synergynet_tpu.nn.backbones.mobilenet_v2 import MobileNetV2 as JaxMNV2
from synergynet_tpu.nn.pointnet import MLPFor as JaxMLPFor
from synergynet_tpu.nn.pointnet import MLPRev as JaxMLPRev
from synergynet_tpu.nn.pointnet import PointEncoder as JaxPointEncoder
from synergynet_tpu_torch.convert import (flax_from_state_dict,
                                          state_dict_from_flax)
from synergynet_tpu_torch.nn.backbones.mobilenet_v2 import (MobileNetV2,
                                                            relu6)
from synergynet_tpu_torch.nn.heads import dropout
from synergynet_tpu_torch.nn.pointnet import MLPFor, MLPRev, PointEncoder

torch.set_num_threads(2)

BF16_ATOL = 0.08        # tests/test_torch_nn.py
FP32_ATOL = 1e-4
STATS = {"float64": dict(rtol=1e-9, atol=1e-12),
         "float32": dict(rtol=1e-4, atol=1e-5),
         "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRAD_REL = {"float64": 1e-6, "float32": 5e-2, "bfloat16": 5e-2}
WIDTH = 0.35
SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 2, 2))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def assert_trees_close(got, want, rel=None, spread=None, **tol):
    """Leaf by leaf: ``rel`` bounds max |got - want| by ``rel`` times the
    leaf's scale (its largest |value|, at least 1e-2 of the tree's), plus
    ``spread[leaf]`` where given; else ``assert_allclose(**tol)``."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if rel is not None:
            bound = rel * max(np.abs(w).max(), 1e-2 * top)
            if spread is not None:
                bound += spread[k]
            err = np.abs(g.astype(np.float64) - w).max()
            assert err <= bound, f"{k}: {err:.3e} > {bound:.3e}"
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **tol)


def _tree(named, col):
    """Named tensors -> a flax-shaped float64 numpy tree (``col``)."""
    out = flax_from_state_dict({k: t.double() for k, t in named})[col]
    return {k: v for k, v in out.items()}


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _run_jax(module, variables, args, proj):
    def f(params, *args):
        out, upd = module.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                *args, train=True, mutable=["batch_stats"])
        outs = out if isinstance(out, tuple) else (out,)
        loss = sum(jnp.sum(o.astype(p.dtype) * p)
                   for o, p in zip(outs, map(jnp.asarray, proj)))
        return loss, (outs, upd)
    (_, (outs, upd)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        variables["params"], *map(jnp.asarray, args))
    return ([np.asarray(o, np.float64) for o in outs],
            jax.device_get(upd["batch_stats"]), jax.device_get(g))


def _run_torch(module, variables, args, proj, dtype=torch.float32):
    module.load_state_dict({k: t.to(dtype) for k, t in
                            state_dict_from_flax(variables).items()})
    module.train()
    out = module(*(torch.from_numpy(np.asarray(a)) for a in args))
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o.to(dtype) * torch.from_numpy(p)).sum()
               for o, p in zip(outs, proj))
    loss.backward()
    return ([o.detach().double().numpy() for o in outs],
            _tree(module.named_buffers(), "batch_stats"),
            _tree(((k, p.grad) for k, p in module.named_parameters()),
                  "params"))


def _case(dtype, args, proj):
    """Inputs and projections cast to a comparison's dtype (bf16 runs take
    fp32 inputs, as the model casts them)."""
    np_dtype = np.float64 if dtype == "float64" else np.float32
    return ([a.astype(np_dtype) for a in args],
            [p.astype(np_dtype) for p in proj])


def _jax_mnv2(dtype):
    return JaxMNV2(width_mult=WIDTH, setting=SETTING, dropout=0.0,
                   dtype=getattr(jnp, dtype))


@pytest.fixture(scope="module")
def mnv2_case():
    """Inputs, fp32 weights from the flax init, and JAX's results in
    float64, fp32 and bf16."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (8, 120, 120, 3))
    proj = [rng.normal(0, 1, (8, 62)), rng.normal(0, 1, (8, 1280))]
    variables = jax.device_get(_jax_mnv2("float32").init(
        jax.random.PRNGKey(1), jnp.asarray(x, jnp.float32), train=False))
    want = {}
    for dtype in ("float32", "bfloat16"):
        want[dtype] = _run_jax(_jax_mnv2(dtype), variables,
                               *_case(dtype, [x], proj))
    with jax.enable_x64(True):
        want["float64"] = _run_jax(_jax_mnv2("float64"), _f64(variables),
                                   *_case("float64", [x], proj))
    return x, proj, variables, want


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_mobilenet_v2_train_mode_matches_flax(dtype, mnv2_case):
    x, proj, variables, want = mnv2_case
    jo, jstats, jgrads = want[dtype]
    param_dtype = torch.float64 if dtype == "float64" else torch.float32
    tm = MobileNetV2(width_mult=WIDTH, setting=SETTING, dropout=0.0,
                     dtype=getattr(torch, dtype)).to(param_dtype)
    to, tstats, tgrads = _run_torch(tm, variables, *_case(dtype, [x], proj),
                                    dtype=param_dtype)
    atol = BF16_ATOL if dtype == "bfloat16" else FP32_ATOL
    for g, w in zip(to, jo):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    assert_trees_close(tstats, jstats, **STATS[dtype])
    spread = None
    if dtype == "bfloat16":
        # Against the fp32 gradient, within 2x JAX's own bf16 distance.
        j16 = dict(_leaves(jgrads))
        j32 = dict(_leaves(want["float32"][2]))
        spread = {k: 2 * np.abs(j16[k] - j32[k]).max() for k in j32}
        jgrads = want["float32"][2]
    assert_trees_close(tgrads, jgrads, rel=GRAD_REL[dtype], spread=spread)
    assert all(p.dtype == param_dtype for p in tm.parameters())


def _points(rng, b=6, n=68, dup=False):
    pts = rng.normal(60, 25, (b, n, 3))
    if dup:     # every point twice: each channel's max ties
        pts[:, n // 2:] = pts[:, :n // 2]
    return pts


def _hold_pointnet(jax_cls, torch_cls, args, proj, seed, dtype):
    key = jax.random.PRNGKey(seed)
    variables = jax.device_get(jax_cls().init(
        key, *(jnp.asarray(a, jnp.float32) for a in args)))
    args, proj = _case(dtype, args, proj)
    if dtype == "float64":
        with jax.enable_x64(True):
            jo, jstats, jgrads = _run_jax(jax_cls(dtype=jnp.float64),
                                          _f64(variables), args, proj)
        to, tstats, tgrads = _run_torch(torch_cls().double(), variables,
                                        args, proj, dtype=torch.float64)
    else:
        jo, jstats, jgrads = _run_jax(jax_cls(), variables, args, proj)
        to, tstats, tgrads = _run_torch(torch_cls(), variables, args, proj)
    for g, w in zip(to, jo):
        np.testing.assert_allclose(g, w, rtol=0, atol=FP32_ATOL)
    assert_trees_close(tstats, jstats, **STATS[dtype])
    assert_trees_close(tgrads, jgrads, rel=GRAD_REL[dtype])
    return variables, to


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dup", [False, True])
def test_point_encoder_train_mode_matches_flax(dup, dtype):
    """With duplicated points every channel's global max is a tie, and
    ``torch.amax`` splits its gradient as ``jnp.max`` does (in float64 a
    one-index max would miss the 1e-6 bound by far)."""
    rng = np.random.default_rng(1)
    proj = [rng.normal(0, 1, (6, 68, 64)), rng.normal(0, 1, (6, 1024))]
    _hold_pointnet(JaxPointEncoder, PointEncoder, [_points(rng, dup=dup)],
                   proj, 2, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mlp_for_and_rev_train_mode_match_flax(dtype):
    """The point nets run fp32 inside SynergyNet; float64 holds their
    math."""
    rng = np.random.default_rng(2)
    lmk = _points(rng)
    args = [lmk, rng.normal(0, 1, (6, 1280)), rng.normal(0, 1, (6, 40)),
            rng.normal(0, 1, (6, 10))]
    variables, out = _hold_pointnet(JaxMLPFor, MLPFor, args,
                                    [rng.normal(0, 1, (6, 68, 3))], 3, dtype)
    assert variables["params"]["dec1_fc"]["kernel"].shape == (2418, 512)
    assert (out[0] >= 0).all()
    _hold_pointnet(JaxMLPRev, MLPRev, [lmk], [rng.normal(0, 1, (6, 62))], 4,
                   dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu6_tie_gradient_matches_jnp_minimum(dtype):
    """At exactly 6.0 ``jnp.minimum`` sends half the gradient to each
    side; ``F.relu6`` would send none."""
    x = np.array([-1.0, 0.0, 3.0, 6.0, 6.0, 7.5], np.float32)
    jd = getattr(jnp, dtype)
    want = jax.grad(lambda v: jnp.sum(jnp.minimum(
        jax.nn.relu(v), jnp.asarray(6.0, jd)).astype(jnp.float32)))(
        jnp.asarray(x, jd))
    t = torch.tensor(x, dtype=getattr(torch, dtype), requires_grad=True)
    relu6(t).float().sum().backward()
    np.testing.assert_array_equal(t.grad.float().numpy(),
                                  np.asarray(want, np.float32))
    assert t.grad[3].item() == 0.5


def test_dropout_statistics_and_generator():
    """The head's dropout: keep rate 0.8, kept values scaled by 1/0.8, and
    the same generator state gives the same mask."""
    x = torch.ones(256, 1280)
    g = torch.Generator().manual_seed(5)
    a = dropout(x, 0.2, g)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.01     # ~8 sigma
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.8))
    b = dropout(x, 0.2, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert not torch.equal(a, dropout(x, 0.2, g))
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError):
        dropout(x, 0.2, None)
    m = MobileNetV2(width_mult=WIDTH, setting=SETTING).train()
    with pytest.raises(ValueError):
        m(torch.zeros(2, 120, 120, 3))
