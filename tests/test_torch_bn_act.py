"""The conv backbones' BatchNorm + activation + residual pass
(``ops/bn_act.py``) on the CPU: the wrapper runs its plain twin, which is
the blocks' expressions as written before kernel BN1, for every activation
and residual form; MobileNetV2 and ResNeSt-50 in eval and in train mode
give what the chain before BN1 gave, outputs and running statistics bit
for bit; the sites each backbone routes through BN1; BN1's checks; and the
autograd Function's gradient plumbing, with the twin in the kernel's
place. BN1 itself runs only on a card (``tests/test_torch_gpu.py -k
bn1``)."""

import copy
import contextlib

import pytest
import torch
import torch.nn.functional as F

from synergynet_tpu_torch.nn.backbones import mobilenet_v2, resnest
from synergynet_tpu_torch.nn.backbones.mobilenet_v2 import (
    ConvBNReLU6, InvertedResidual, MobileNetV2)
from synergynet_tpu_torch.nn.backbones.resnest import (
    ResNeSt, ResNeStBottleneck, SplAtConv2d, make_resnest)
from synergynet_tpu_torch.nn.batchnorm import BatchNorm
from synergynet_tpu_torch.nn.layers import (cast_layers_, spatial_mean,
                                            to_nchw)
from synergynet_tpu_torch.ops import bn_act as bn_act_mod
from synergynet_tpu_torch.ops.bn_act import (ACTS, bn_act, bn_act_reference,
                                             bn_act_sites, check_bn_act)
from synergynet_tpu_torch.ops.cuda_build import launches
from synergynet_tpu_torch.ops.split_attention import (radix_combine,
                                                      radix_pool)

torch.set_num_threads(2)

RESIDUALS = ["none", "raw", "bn"]
DTYPES = [torch.float32, torch.bfloat16]


# -- the chain as the blocks wrote it before BN1 -----------------------------

def _relu6(x):
    return torch.minimum(F.relu(x), torch.tensor(6.0, dtype=x.dtype))


def _cbr6_before(self, x):
    return _relu6(self.BatchNorm_0(self.Conv_0(x)))


def _inverted_before(self, x):
    y = x
    for i in range(self._n_cbr):
        y = getattr(self, f"ConvBNReLU6_{i}")(y)
    y = self.BatchNorm_0(self.Conv_0(y))
    return x + y if self.use_res else y


def _splat_before(self, x):
    y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
    gap = radix_pool(y, self.radix)
    gap = F.relu(self.BatchNorm_1(self.Conv_1(gap)))
    return radix_combine(y, self.Conv_2(gap), self.radix, self.groups)


def _bottleneck_before(self, x):
    y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
    if self.avd and self.avd_first:
        y = self._avd_pool(y)
    y = self.SplAtConv2d_0(y)
    if self.avd and not self.avd_first:
        y = self._avd_pool(y)
    y = self.BatchNorm_1(self.Conv_1(y))
    if self.project:
        if self.stride != 1:
            x = F.avg_pool2d(x, self.stride, self.stride, ceil_mode=True,
                             count_include_pad=False)
        x = self.BatchNorm_2(self.Conv_2(x))
    return F.relu(x + y)


def _resnest_before(self, x, generator=None):
    x = to_nchw(x, self.dtype)
    for i in range(3):
        x = F.relu(getattr(self, f"BatchNorm_{i}")(
            getattr(self, f"Conv_{i}")(x)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for i in range(self._n_blocks):
        x = getattr(self, f"ResNeStBottleneck_{i}")(x)
    feat = spatial_mean(x).float()
    return self.ParamHead_0(feat, generator), feat


BEFORE = {ConvBNReLU6: _cbr6_before, InvertedResidual: _inverted_before,
          SplAtConv2d: _splat_before, ResNeStBottleneck: _bottleneck_before,
          ResNeSt: _resnest_before}


@contextlib.contextmanager
def chain_before_bn1():
    """The backbones' forwards as they were before BN1, for the block."""
    saved = {cls: cls.forward for cls in BEFORE}
    try:
        for cls, fn in BEFORE.items():
            cls.forward = fn
        yield
    finally:
        for cls, fn in saved.items():
            cls.forward = fn


# -- helpers -----------------------------------------------------------------

def _bn(c, seed):
    """An eval BatchNorm over c channels with drawn statistics and affine
    parameters (the init's would make it near the identity)."""
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(torch.rand(c, generator=g) * 2 + 0.05)
        bn.weight.copy_(torch.randn(c, generator=g))
        bn.bias.copy_(torch.randn(c, generator=g))
    return bn.eval()


def _act(c, dtype, seed, shape=(3, None, 5, 7)):
    g = torch.Generator().manual_seed(seed)
    b, _, h, w = shape
    x = (3 * torch.randn((b, c, h, w), generator=g)).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


def _drawn(model, seed):
    """Draw every BatchNorm's statistics and affine parameters (in place)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(0.2 * torch.randn(c, generator=g))
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
                m.weight.copy_(1 + 0.2 * torch.randn(c, generator=g))
                m.bias.copy_(0.2 * torch.randn(c, generator=g))
    return model


def _backbone(arch, dtype, seed=0):
    torch.manual_seed(seed)
    if arch == "mobilenet_v2":
        model = MobileNetV2(dtype=dtype)
    else:
        model = make_resnest(arch, dtype=dtype)
    return _drawn(model, seed + 1)


def _images(b, size, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, size, size, 3), generator=g)


def _equal(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


# -- the twin ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("residual", RESIDUALS)
@pytest.mark.parametrize("act", sorted(ACTS))
def test_wrapper_runs_the_twin_which_is_the_expressions(act, residual,
                                                        dtype):
    """On a CPU tensor ``bn_act`` launches nothing and gives the blocks'
    expressions bit for bit: ``F.batch_norm`` rounded to the dtype, the
    residual (as it is or under its own BatchNorm) added in the dtype,
    then ``F.relu`` or ``minimum(relu, 6)``."""
    bn, rbn = _bn(16, 1), _bn(16, 2)
    x = _act(16, dtype, 3)
    r = _act(16, dtype, 4) if residual != "none" else None
    rb = rbn if residual == "bn" else None
    y = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                     bn.bias, False, 0.0, bn.eps)
    if residual == "raw":
        y = r + y
    elif residual == "bn":
        y = F.batch_norm(r, rbn.running_mean, rbn.running_var, rbn.weight,
                         rbn.bias, False, 0.0, rbn.eps) + y
    want = {"none": y, "relu": F.relu(y), "relu6": _relu6(y)}[act]
    before = launches.copy()
    got = bn_act(x, bn, act, r, rb)
    assert launches == before
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(bn_act_reference(x, bn, act, r, rb), want)
    if act == "relu6":
        assert float(want.detach().max()) == 6.0    # the clamp at 6 acts


def test_train_mode_runs_the_modules():
    """A training BatchNorm normalises with the batch's statistics and moves
    its running ones, through ``bn_act`` as through the module."""
    bn, rbn = _bn(8, 5).train(), _bn(8, 6).train()
    x, r = _act(8, torch.float32, 7), _act(8, torch.float32, 8)
    twin_bn, twin_rbn = copy.deepcopy(bn), copy.deepcopy(rbn)
    got = bn_act(x, bn, "relu", r, rbn)
    want = F.relu(twin_rbn(r) + twin_bn(x))
    assert torch.equal(got, want)
    for a, b in ((bn, twin_bn), (rbn, twin_rbn)):
        assert torch.equal(a.running_mean, b.running_mean)
        assert torch.equal(a.running_var, b.running_var)


def test_wrapper_raises_on_other_devices():
    bn = _bn(16, 0)
    with pytest.raises(ValueError, match="no BatchNorm"):
        bn_act(torch.empty((2, 16, 3, 3), device="meta"), bn, "relu")


# -- the backbones -----------------------------------------------------------

ARCHS = ["mobilenet_v2", "resnest50"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_backbone_eval_equals_the_chain_before_bn1(arch, dtype):
    """The served backbones in eval mode on the CPU: param and feature bit
    for bit against the forwards as written before BN1."""
    model = cast_layers_(_backbone(arch, dtype), dtype).eval()
    x = _images(2, 64, seed=11)
    with torch.inference_mode():
        got = model(x)
        with chain_before_bn1():
            want = model(x)
    assert _equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_backbone_train_mode_equals_the_chain_before_bn1(arch):
    """Train mode: outputs, running statistics and gradients bit for bit
    against the chain before BN1, from one state and one dropout seed."""
    model = _backbone(arch, torch.float32).train()
    twin = copy.deepcopy(model)
    x = _images(4, 48, seed=12)

    def run(m):
        out = m(x, torch.Generator().manual_seed(3))
        (out[0].square().sum() + out[1].sum()).backward()
        return out

    got = run(model)
    with chain_before_bn1():
        want = run(twin)
    assert _equal(got, want)
    for (name, a), (_, b) in zip(model.named_buffers(),
                                 twin.named_buffers()):
        assert torch.equal(a, b), name
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 twin.named_parameters()):
        assert torch.equal(a.grad, b.grad), name


def _sites(model, x):
    """Every ``bn_act`` call of one forward: (C, H, W) with the act and the
    residual form."""
    return [(tuple(s[:3]), *s[3:]) for s in bn_act_sites(model, x)]


@pytest.mark.parametrize("arch,n,forms", [
    ("mobilenet_v2", 52, {("relu6", "none"): 35, ("none", "none"): 7,
                          ("none", "raw"): 10}),
    ("resnest50", 51, {("relu", "none"): 35, ("relu", "raw"): 12,
                       ("relu", "bn"): 4})])
def test_backbone_routes_every_bn_site_through_bn_act(arch, n, forms):
    """MobileNetV2: 35 conv + BN + ReLU6 sites, 7 projections, 10 with the
    identity residual. ResNeSt-50: 3 stem convs, 16 x 2 BN + ReLU (the
    bottleneck's first and the split attention's radix tensor), 16 ends
    with the shortcut, 4 of them under BatchNorm_2."""
    sites = _sites(_backbone(arch, torch.float32).eval(),
                   _images(1, 120, seed=0))
    assert len(sites) == n
    counts = {}
    for _, act, form in sites:
        counts[act, form] = counts.get((act, form), 0) + 1
    assert counts == forms
    assert all(shape[0] % 8 == 0 for shape, _, _ in sites)


def test_site_tally_runs_the_twin_and_puts_bn_act_back():
    """The tally gives the forward's own output, launches nothing, and
    leaves the backbones' ``bn_act`` as it found it, a patched one too."""
    model = _backbone("mobilenet_v2", torch.float32).eval()
    x = _images(1, 64, seed=1)
    with torch.inference_mode():
        want = model(x)
    before = dict(launches)
    seen = []

    def outer(*args, **kw):
        seen.append(1)
        return bn_act(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resnest, "bn_act", outer)
        got = []
        bn_act_sites(lambda t: got.append(model(t)), x)
        assert resnest.bn_act is outer and mobilenet_v2.bn_act is bn_act
    assert not seen and dict(launches) == before
    assert _equal(got[0], want)


# -- BN1's checks ------------------------------------------------------------

def _misaligned(c):
    flat = torch.zeros(2 * c * 9 + 1, dtype=torch.bfloat16)
    return torch.as_strided(flat, (2, c, 3, 3), (9 * c, 1, 3 * c, c), 1)


REFUSALS = {
    "float16": (lambda x, r: (x.half(), r), TypeError),
    "float64": (lambda x, r: (x.double(), r), TypeError),
    "not channels-last": (lambda x, r: (x.contiguous(), r), ValueError),
    "3-d": (lambda x, r: (x[0], r), ValueError),
    "misaligned": (lambda x, r: (_misaligned(16), r), ValueError),
    "residual shape": (lambda x, r: (x, r[:, :, :2]), ValueError),
    "residual dtype": (lambda x, r: (x, r.float()), ValueError),
    "residual layout": (lambda x, r: (x, r.contiguous()), ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_check_refuses_what_bn1_does_not_take(case):
    make, error = REFUSALS[case]
    x = _act(16, torch.bfloat16, 0, (2, None, 3, 3))
    r = _act(16, torch.bfloat16, 1, (2, None, 3, 3))
    assert check_bn_act(x, _bn(16, 0), "relu", r, _bn(16, 1)) == 16
    x, r = make(x, r)
    with pytest.raises(error):
        check_bn_act(x, _bn(16, 0), "relu", r, _bn(16, 1))


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 12),
                                     (torch.bfloat16, 4),
                                     (torch.float32, 6)])
def test_check_refuses_a_channel_count_off_16_bytes(dtype, c):
    """A row off 16 bytes (24 and 8 bytes in bf16, 24 in f32) is taken
    since BN1 moves 8- and 4-byte vectors too; one channel more makes an
    odd bf16 count, a row off 4 bytes, which BN1 refuses (f32 takes every
    count)."""
    assert check_bn_act(_act(c, dtype, 0), _bn(c, 0), "none") == c
    c += 1
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="multiple of"):
            check_bn_act(_act(c, dtype, 0), _bn(c, 0), "none")
    else:
        assert check_bn_act(_act(c, dtype, 0), _bn(c, 0), "none") == c


def test_check_refuses_other_parameters_and_arguments():
    x = _act(16, torch.float32, 0)
    with pytest.raises(ValueError, match="act"):
        check_bn_act(x, _bn(16, 0), "gelu")
    with pytest.raises(ValueError, match="without a residual"):
        check_bn_act(x, _bn(16, 0), "none", None, _bn(16, 1))
    with pytest.raises(ValueError):                 # 8 statistics for 16
        check_bn_act(x, _bn(8, 0), "none")
    half = _bn(16, 0)
    half.running_var = half.running_var.bfloat16()
    with pytest.raises(TypeError):
        check_bn_act(x, half, "none")
    points = BatchNorm(16, channel_dim=-1).eval()
    with pytest.raises(ValueError, match="dim"):
        check_bn_act(x, points, "none")


# -- the autograd Function, with the twin in BN1's place ---------------------

@pytest.mark.parametrize("residual", RESIDUALS)
def test_function_gradient_is_the_twins(residual, monkeypatch):
    """Under autograd BN1 runs in ``_BnAct``, whose backward recomputes the
    twin: with the twin standing in for the launch (on the CPU), the
    gradients of x, the residual and every affine parameter equal the
    twin's own bit for bit."""
    monkeypatch.setattr(bn_act_mod, "_launch", bn_act_reference)
    g = torch.Generator().manual_seed(9)
    grad = torch.randn((3, 16, 5, 7), generator=g)

    def grads(fn):
        bn, rbn = _bn(16, 1), _bn(16, 2)
        x = _act(16, torch.float32, 3).requires_grad_()
        r = (_act(16, torch.float32, 4).requires_grad_()
             if residual != "none" else None)
        rb = rbn if residual == "bn" else None
        (fn(x, bn, "relu6", r, rb) * grad).sum().backward()
        leaves = [x, r, bn.weight, bn.bias, rbn.weight, rbn.bias]
        return [None if t is None or t.grad is None else t.grad
                for t in leaves]

    def through_function(x, bn, act, r, rb):
        params = [bn.weight, bn.bias] + ([None, None] if rb is None
                                         else [rb.weight, rb.bias])
        return bn_act_mod._BnAct.apply(x, r, *params, bn, act, rb)

    got, want = grads(through_function), grads(bn_act_reference)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)
