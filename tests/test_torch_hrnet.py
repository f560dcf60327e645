"""The port's HRNetV2-W18 regressor and its exchange unit on the CPU.

- ``hrnetv2_w18`` at the W18 widths, one module a stage, 64-pixel crops,
  against the benchmark's plain float32 reference
  (``perfbench/reference/regressors/hrnetv2_w18.py``) on seeded trees
  whose running statistics are drawn: in float32 within 1e-5, in bf16
  within a rounding tolerance that the reference in fp8 exceeds;
- the registry entry, the 270-wide pooled feature, the tree the
  reference draws loading into the port, and the FLOP count against a
  hook count of the port's own convolutions;
- the exchange unit's wrapper (``ops/hr_fuse.py``): on the CPU it runs the
  twin, which is the module's expression as HRNet's released code writes
  it, bit for bit at scales 1/2/4/8 with 2-4 branches; train mode; F1's
  checks; the autograd Function's gradient plumbing;
- BN1's wrapper at HRNet's narrow channel counts (18, 36, 270) and its
  refusal of an odd count in bf16; the site tally of the HRNet;
- the served layout (``HRNet.pad_channels_``): the padded net against the
  published one on the same weights, its pad channels exactly 0, every
  conv at multiples of 8 channels but the stem's image input, padding once,
  the published shapes everywhere else, the API's serving hook.

F1 and BN1 themselves run only on a card (``tests/test_torch_gpu.py -k
'hrnet or f1 or bn1'``).
"""

import copy

import pytest
import torch
import torch.nn.functional as F

from perfbench import weights
from perfbench.counts import hrnetv2_w18 as counts
from perfbench.reference.nets import merge
from perfbench.reference.precision import Precision
from perfbench.reference.regressors import hrnetv2_w18 as ref
from synergynet_tpu_torch.convert import synergy_state_dict
from synergynet_tpu_torch.nn import SynergyNet, available_backbones
from synergynet_tpu_torch.nn.backbones import make_backbone
from synergynet_tpu_torch.nn.backbones import hrnet
from synergynet_tpu_torch.nn.backbones.hrnet import HRNet, stored
from synergynet_tpu_torch.nn.batchnorm import BatchNorm
from synergynet_tpu_torch.nn.layers import cast_layers_
from synergynet_tpu_torch.ops import hr_fuse as hr_fuse_mod
from synergynet_tpu_torch.ops.bn_act import bn_act_sites, check_bn_act
from synergynet_tpu_torch.ops.cuda_build import launches
from synergynet_tpu_torch.ops.hr_fuse import (check_hr_fuse, hr_fuse,
                                              hr_fuse_reference)

torch.set_num_threads(2)

WIDTHS = (18, 36, 72, 144)
SMALL = dict(modules=(1, 1, 1))          # one module a stage
CROP = 64
# Float32 on both sides, the same operations: what differs is the order of
# each convolution's sums (oneDNN in the port, the reference's own call)
# and the reference's BatchNorm as (x - mean) * (rsqrt(var + eps) scale) +
# bias against F.batch_norm's; over ~60 convs that reads ~4e-7 of the 62
# parameters' norm (seeds 3-5), so 1e-5 leaves 25x of room and still sees
# any wrong term or order of an exchange (a term off reads >1e-2).
F32_REL = 1e-5
# bf16 keeps 8 significant bits: every conv operand and output, each BN
# and each sum of the exchange units round at 2^-9 relative, which over
# ~60 convs and 3 exchanges reads 0.32-0.53% of the parameters' norm here
# (seeds 3-9); fp8 e4m3 (4 bits) in the reference reads 4.0-6.8%, so 2%
# tells the two apart with room on both sides.
BF16_REL = 0.02


def _tree(seed):
    return weights.draw(ref.spec(**SMALL), seed, "cpu")


def _crops(n, seed, side=CROP):
    g = torch.Generator().manual_seed(seed)
    u8 = torch.randint(0, 256, (n, side, side, 3), generator=g)
    return (u8.float() - 127.5) / 128.0


def _reference(tree, x, kind="f32"):
    t = merge(tree["params"], tree["batch_stats"])["backbone"]
    return ref.forward(Precision(kind), t, x)


def _port(tree, dtype):
    model = SynergyNet("hrnetv2_w18", dtype=dtype, **SMALL)
    model.load_state_dict(synergy_state_dict(weights.numpy_tree(tree)))
    return cast_layers_(model, dtype).eval()


def _rel(got, want):
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


@pytest.mark.parametrize("seed", [3, 4])
def test_hrnet_f32_matches_the_reference(seed):
    tree, x = _tree(seed), _crops(2, seed)
    with torch.no_grad():
        got, feat = _port(tree, torch.float32)(x)
    assert got.shape == (2, 62) and feat.shape == (2, 270)
    assert _rel(got, _reference(tree, x)) < F32_REL


@pytest.mark.parametrize("seed", [3, 5])
def test_hrnet_bf16_within_rounding_and_fp8_outside(seed):
    tree, x = _tree(seed), _crops(2, seed)
    with torch.no_grad():
        got, _ = _port(tree, torch.bfloat16)(x)
    want = _reference(tree, x)
    assert got.dtype == torch.float32
    assert _rel(got, want) < BF16_REL < _rel(_reference(tree, x, "fp8"),
                                              want)


def test_registry_builds_the_published_net():
    """``hrnetv2_w18`` builds HRNet at the W18 widths with 1/4/3 modules,
    names both kernel libraries for the engine to build, takes 256-pixel
    crops in the API, and pools the 270 channels of its head."""
    assert "hrnetv2_w18" in available_backbones()
    net = make_backbone("hrnetv2_w18")
    assert isinstance(net, HRNet) and net.widths == WIDTHS
    assert net.kernels == ("bn_act", "hr_fuse") and net.input_size == 256
    assert sum(k.startswith("HighResolutionModule_")
               for k, _ in net.named_children()) == 8
    assert net.ParamHead_0.fc_pose.in_features == 270
    with torch.no_grad():
        param, feat = net.eval()(_crops(1, 0))
    assert param.shape == (1, 62) and feat.shape == (1, 270)


def test_reference_tree_is_the_ports_at_the_published_depth():
    """The reference's seeded tree at 1/4/3 modules loads into the port
    leaf for leaf (a strict ``load_state_dict``), ~9.65M backbone values."""
    spec = ref.spec()
    model = SynergyNet("hrnetv2_w18")
    state = synergy_state_dict(weights.numpy_tree(
        weights.draw(spec, 0, "cpu")))
    model.load_state_dict(state)
    n = sum(p.numel() for p in model.backbone.parameters())
    assert n == 9_652_772


@pytest.mark.parametrize("modules", [(1, 1, 1), (1, 4, 3)])
def test_flop_count_equals_the_ports_convolutions(modules):
    """``counts/hrnetv2_w18.flops`` against the multiply-adds of every conv
    and dense layer that one forward of the port runs at 64 pixels,
    counted from the tensors by hooks."""
    model = HRNet(modules=modules).eval()
    macs = []

    def conv_hook(m, args, out):
        k = m.weight
        macs.append(out.numel() // out.shape[0] * k[0].numel())

    def dense_hook(m, args, out):
        macs.append(m.weight.numel())

    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(conv_hook)
        elif isinstance(m, torch.nn.Linear):
            m.register_forward_hook(dense_hook)
    with torch.no_grad():
        model(_crops(1, 0))
    assert counts.flops(CROP, modules=modules) == 2 * sum(macs)


# -- the exchange unit -------------------------------------------------------

def _bn(c, seed):
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(torch.rand(c, generator=g) * 2 + 0.05)
        bn.weight.copy_(torch.randn(c, generator=g))
        bn.bias.copy_(torch.randn(c, generator=g))
    return bn.eval()


def _act(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = 2 * torch.randn(shape, generator=g)
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _unit_inputs(n, i, dtype, b=2, side=16, seed=0):
    """Output i of an n-branch unit at branch 0's extent ``side``: the
    identity and, for each j != i in order, (raw, BatchNorm, scale)."""
    c = WIDTHS[i]
    h = side // 2 ** i
    ident = _act((b, c, h, h), dtype, seed)
    terms = []
    for j in range(n):
        if j != i:
            hj = side // 2 ** max(i, j)
            terms.append((_act((b, c, hj, hj), dtype, seed + 1 + j),
                          _bn(c, seed + 11 + j), 2 ** (j - i) if j > i
                          else 1))
    return ident, terms


def _released_expression(ident, terms, i):
    """Output i as HRNet's released ``HighResolutionModule.forward`` writes
    it: ``y = x[0] if i == 0 else f_i0(x[0])``, then ``y = y + x[j]`` or
    ``y = y + f_ij(x[j])`` for j = 1 ..., each f_ij ending in its
    BatchNorm, then ``nn.Upsample(scale_factor, mode='nearest')`` for
    j > i; ReLU."""
    up = torch.nn.Upsample
    by_j = [None] * (len(terms) + 1)
    k = 0
    for j in range(len(terms) + 1):
        if j == i:
            by_j[j] = ident
        else:
            raw, bn, s = terms[k]
            z = bn(raw)
            by_j[j] = up(scale_factor=s, mode="nearest")(z) if s > 1 else z
            k += 1
    y = by_j[0]
    for z in by_j[1:]:
        y = y + z
    return F.relu(y)


UNITS = [(n, i) for n in (2, 3, 4) for i in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,i", UNITS)
def test_twin_is_the_released_expression(n, i, dtype):
    """On a CPU tensor ``hr_fuse`` launches nothing and gives the released
    code's expression bit for bit, for every output of units of 2, 3 and 4
    branches (1 to 3 terms, scales 1, 2, 4 and 8)."""
    ident, terms = _unit_inputs(n, i, dtype, seed=n * 10 + i)
    want = _released_expression(ident, terms, i)
    before = dict(launches)
    got = hr_fuse(ident, terms)
    assert dict(launches) == before
    assert got.dtype == dtype and got.shape == ident.shape
    assert torch.equal(got, want)
    assert torch.equal(hr_fuse_reference(ident, terms), want)
    if n == 4 and i == 0:
        assert [s for _, _, s in terms] == [2, 4, 8]


def test_train_mode_runs_the_modules():
    """Training BatchNorms normalise with their batch's statistics at the
    term's own resolution and move their running ones."""
    ident, terms = _unit_inputs(3, 1, torch.float32, seed=4)
    terms = [(r, bn.train(), s) for r, bn, s in terms]
    twins = [(r, copy.deepcopy(bn), s) for r, bn, s in terms]
    got = hr_fuse(ident, terms)
    want = _released_expression(ident, twins, 1)
    assert torch.equal(got, want)
    for (_, a, _), (_, b, _) in zip(terms, twins):
        assert torch.equal(a.running_mean, b.running_mean)
        assert not torch.equal(a.running_var, torch.ones_like(a.running_var))


def _misaligned(c, h):
    flat = torch.zeros(2 * c * h * h + 1, dtype=torch.bfloat16)
    return torch.as_strided(flat, (2, c, h, h), (h * h * c, 1, h * c, c), 1)


F1_REFUSALS = {
    "float16": (lambda x, t: (x.half(), t), TypeError),
    "3-d": (lambda x, t: (x[0], t), ValueError),
    "odd channels": (lambda x, t: (x[:, :17].contiguous(
        memory_format=torch.channels_last), t), ValueError),
    "not channels-last": (lambda x, t: (x.contiguous(), t), ValueError),
    "misaligned": (lambda x, t: (_misaligned(18, 16), t), ValueError),
    "no terms": (lambda x, t: (x, []), ValueError),
    "four terms": (lambda x, t: (x, t + t[:1]), ValueError),
    "scale 16": (lambda x, t: (x, [(t[0][0][:, :, :1, :1], t[0][1], 16)]
                               + t[1:]), ValueError),
    "scale order": (lambda x, t: (x, [t[0], (x, t[0][1], 1)]),
                    ValueError),
    "term shape": (lambda x, t: (x, [(t[0][0][:, :, :4], t[0][1], 2)]
                                 + t[1:]), ValueError),
    "term dtype": (lambda x, t: (x, [(t[0][0].float(), t[0][1], 2)]
                                 + t[1:]), ValueError),
    "term layout": (lambda x, t: (x, [(t[0][0].contiguous(), t[0][1], 2)]
                                  + t[1:]), ValueError),
    "statistics": (lambda x, t: (x, [(t[0][0], _bn(36, 0), 2)] + t[1:]),
                   ValueError),
}


@pytest.mark.parametrize("case", sorted(F1_REFUSALS))
def test_check_refuses_what_f1_does_not_take(case):
    make, error = F1_REFUSALS[case]
    ident, terms = _unit_inputs(4, 0, torch.bfloat16)
    assert check_hr_fuse(ident, terms) == 0
    with pytest.raises(error):
        check_hr_fuse(*make(ident, terms))


def test_check_counts_the_terms_ahead_of_the_identity():
    """The scale-1 terms (branches of higher resolution) come first."""
    for i in range(4):
        ident, terms = _unit_inputs(4, i, torch.float32)
        assert check_hr_fuse(ident, terms) == i


@pytest.fixture
def one_thread():
    """One intra-op thread for the test, the count before restored after.
    BatchNorm's CPU backward sums each channel's gradient in per-thread
    partials, so the bits of the affine gradients follow how the thread
    team splits the batch (2, 3, 4 or 8 threads read other bits than 1);
    with one thread both sides sum in one order, whatever the rest of the
    process left the thread pool at."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_function_gradient_is_the_twins(monkeypatch, one_thread):
    """Under autograd F1 runs in ``_HrFuse``, whose backward recomputes the
    twin: with the twin standing in for the launch (on the CPU), the
    gradients of the identity, each raw term and each BatchNorm's affine
    parameters equal the twin's own bit for bit."""
    monkeypatch.setattr(hr_fuse_mod, "_launch", hr_fuse_reference)

    def grads(through):
        ident, terms = _unit_inputs(4, 1, torch.float32, seed=7)
        ident.requires_grad_()
        for raw, _, _ in terms:
            raw.requires_grad_()
        out = through(ident, terms)
        (out * out.detach().sin()).sum().backward()
        leaves = [ident] + [t for raw, bn, _ in terms
                            for t in (raw, bn.weight, bn.bias)]
        return [t.grad for t in leaves]

    def function(ident, terms):
        flat = [t for raw, bn, _ in terms for t in (raw, bn.weight, bn.bias)]
        return hr_fuse_mod._HrFuse.apply(
            ident, tuple(bn for _, bn, _ in terms),
            tuple(s for _, _, s in terms), *flat)

    got, want = grads(function), grads(hr_fuse_reference)
    assert len(got) == 10
    for a, b in zip(got, want):
        assert a is not None and torch.equal(a, b)


def test_wrapper_raises_on_other_devices():
    ident = torch.empty((2, 18, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no exchange unit"):
        hr_fuse(ident, [(ident, _bn(18, 0), 1)])


# -- BN1 at HRNet's widths and the site tally --------------------------------

@pytest.mark.parametrize("c", [18, 36, 270])
def test_bn1_check_takes_hrnets_narrow_rows(c):
    """Rows of 36, 72 and 540 bytes in bf16: multiples of 4 bytes, not of
    16; BN1 takes them (in f32 every count)."""
    for dtype in (torch.bfloat16, torch.float32):
        x = _act((2, c, 3, 3), dtype, 0)
        assert check_bn_act(x, _bn(c, 0), "relu", x, _bn(c, 1)) == c


@pytest.mark.parametrize("c", [17, 135])
def test_bn1_check_refuses_an_odd_count_in_bf16(c):
    with pytest.raises(ValueError, match="multiple of 2"):
        check_bn_act(_act((2, c, 3, 3), torch.bfloat16, 0), _bn(c, 0),
                     "relu")
    assert check_bn_act(_act((2, c, 3, 3), torch.float32, 0), _bn(c, 0),
                        "relu") == c


def test_every_bn_site_goes_through_bn_act_and_the_tally_puts_back():
    """243 sites at W18: stem 2, layer1 12 (one projected shortcut), the
    transitions 4, the BasicBlocks 208 (104 with the identity), the
    exchange units' inner stride-2 convs 16 (18 and 36 channels), the head
    1 at 270 channels. The tally runs the twins and leaves ``bn_act`` and
    ``hr_fuse`` as it found them."""
    model = HRNet().eval()
    x = _crops(1, 1)
    with torch.inference_mode():
        want = model(x)
    sites = bn_act_sites(model, x)
    assert hrnet.hr_fuse is hr_fuse and hrnet.bn_act.__name__ == "bn_act"
    assert len(sites) == 243
    forms = {}
    for *_, act, form in sites:
        forms[act, form] = forms.get((act, form), 0) + 1
    assert forms == {("relu", "none"): 135, ("relu", "raw"): 107,
                     ("relu", "bn"): 1}
    assert {s[0] for s in sites} == {64, 256, 18, 36, 72, 144, 270}
    assert sum(s[0] == 270 for s in sites) == 1
    with torch.inference_mode():
        assert all(torch.equal(a, b) for a, b in zip(model(x), want))


def test_served_tally_runs_the_stored_widths():
    """The served net's 243 sites at 24, 40, 72, 144 and 272 channels (and
    the stem's and layer1's 64 and 256): every site on 16-byte rows in
    bf16, the forms as published."""
    model = HRNet().eval().pad_channels_()
    sites = bn_act_sites(model, _crops(1, 1))
    assert len(sites) == 243
    assert {s[0] for s in sites} == {64, 256, 24, 40, 72, 144, 272}
    assert sum(s[0] == 272 for s in sites) == 1
    assert all(s[0] % 8 == 0 for s in sites)


# -- the served layout -------------------------------------------------------

# The padded net adds exact zeros to each conv's sums, so in float32 only
# the order of those sums moves (oneDNN blocks 24 input channels other than
# 18): each rounds at 2^-24 relative, which over ~60 convs reads 4e-8 to
# 8e-8 of the 62 parameters' norm (seeds 3-6); 1e-6 leaves 12x of room and
# still sees a pad channel or a head offset gone wrong (>1e-2).
PAD_F32_REL = 1e-6


def _served(model):
    served = copy.deepcopy(model)
    served.backbone.pad_channels_()
    return served


@pytest.mark.parametrize("seed", [3, 6])
def test_served_f32_equals_the_published_net(seed):
    tree, x = _tree(seed), _crops(2, seed)
    model = _port(tree, torch.float32)
    with torch.no_grad():
        want, wfeat = model(x)
        got, feat = _served(model)(x)
    assert got.shape == (2, 62) and feat.shape == (2, 270)
    assert _rel(got, want) < PAD_F32_REL
    assert _rel(feat, wfeat) < PAD_F32_REL


@pytest.mark.parametrize("seed", [3, 5])
def test_served_bf16_within_one_step_of_the_published_net(seed):
    """In bf16 each pooled feature within one bf16 step (2^-7 of its value)
    of the published net's, and so the 62 parameters within 2^-7 of their
    norm."""
    tree, x = _tree(seed), _crops(2, seed)
    model = _port(tree, torch.bfloat16)
    with torch.no_grad():
        want, wfeat = model(x)
        got, feat = _served(model)(x)
    step = torch.finfo(torch.bfloat16).eps
    assert feat.shape == (2, 270) and got.dtype == torch.float32
    assert ((feat - wfeat).abs() <= step * wfeat.abs()).all()
    assert _rel(got, want) <= step


def _pads(c):
    """The pad channels of a stored width, or None where ``c`` has none."""
    for width in WIDTHS + (sum(WIDTHS),):
        if c == stored(width) != width:
            return slice(width, c)
    return None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_pad_channel_stays_zero(dtype, monkeypatch):
    """Forward hooks on every conv, BatchNorm, BasicBlock and exchange unit
    of the served net, and the head's output where it is pooled: every
    channel past a published width is exactly 0, at each of the stored
    widths 24, 40 and 272."""
    model = _served(_port(_tree(4), dtype)).backbone
    seen = []

    def check(t):
        pads = _pads(t.shape[1]) if t.dim() == 4 else None
        if pads is not None:
            seen.append(t.shape[1])
            assert not t[:, pads].any()

    def hook(module, args, out):
        for t in out if isinstance(out, list) else [out]:
            check(t)

    for m in model.modules():
        if m is not model:
            m.register_forward_hook(hook)
    pooled = hrnet.spatial_mean

    def spy(y, *args):
        check(y)
        return pooled(y, *args)

    monkeypatch.setattr(hrnet, "spatial_mean", spy)
    with torch.no_grad():
        _, feat = model(_crops(2, 4))
    assert feat.shape == (2, 270)
    assert set(seen) == {24, 40, 272}


def test_every_served_conv_runs_multiples_of_8_channels():
    """Each conv of the served net takes and gives a multiple of 8
    channels, the stem's 3 image channels alone excepted; the head conv
    reads the 280-channel concatenation and gives 272."""
    model = HRNet(**SMALL).eval().pad_channels_()
    shapes = []

    def hook(module, args, out):
        shapes.append((args[0].shape[1], out.shape[1]))

    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model(_crops(1, 2))
    assert shapes[0] == (3, 64) and shapes[-1] == (280, 272)
    assert all(cin % 8 == 0 and cout % 8 == 0 for cin, cout in shapes[1:])
    assert {s for pair in shapes for s in pair} >= {24, 40, 72, 144}


def test_padding_is_once_and_the_published_shapes_stay_elsewhere():
    """A second ``pad_channels_`` changes nothing; the published tree still
    loads into an unserved net, and not into a served one."""
    state = synergy_state_dict(weights.numpy_tree(_tree(3)))
    model = SynergyNet("hrnetv2_w18", **SMALL)
    model.load_state_dict(state)
    net = model.backbone
    assert net.pad_channels_() is net and net.padded
    once = {k: v.clone() for k, v in model.state_dict().items()}
    net.pad_channels_()
    assert all(torch.equal(v, once[k])
               for k, v in model.state_dict().items())
    assert once["backbone.Conv_2.weight"].shape == (24, 256, 3, 3)
    fresh = SynergyNet("hrnetv2_w18", **SMALL)
    fresh.load_state_dict(state)
    assert not fresh.backbone.padded
    with pytest.raises(RuntimeError, match="size mismatch"):
        model.load_state_dict(state)


def test_api_serves_the_stored_widths_and_keeps_the_published_tree():
    """``SynergyNet3DMM`` pads an HRNet once it is loaded and cast, and
    keeps the published tree in ``variables``; another backbone has no
    such hook."""
    from synergynet_tpu_torch.pipeline import SynergyNet3DMM
    api = SynergyNet3DMM("hrnetv2_w18", dtype=torch.bfloat16, device="cpu")
    net = api.model.backbone
    head = getattr(net, f"Conv_{net._head}")
    assert net.padded
    assert head.weight.shape == (272, 280, 1, 1)
    assert head.weight.dtype == torch.bfloat16
    SynergyNet("hrnetv2_w18").load_state_dict(
        synergy_state_dict(api.variables))
    api = SynergyNet3DMM("mobilenet_v2", device="cpu")
    assert not hasattr(api.model.backbone, "pad_channels_")
