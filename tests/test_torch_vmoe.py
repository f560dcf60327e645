"""The port's V-MoE regressor and its mixture-of-experts layer on the CPU.

- ``vmoe_b16``'s family at a small size (width 64 in 4 heads of 16, MLP
  128, 8 experts, top 2, 4 blocks with MoE at 1 and 3, 32-pixel crops in
  patches of 8) against the benchmark's plain float32 reference
  (``perfbench/reference/regressors/vmoe_b16.py``) on seeded trees: in
  float32 within 1e-5 with identical expert choices, in bf16 within a
  rounding tolerance that the reference in fp8 exceeds;
- the twins of kernels M1, G1 and M2 (``ops/moe.py``) against the
  reference's per-expert loop, and at the edges: one expert taking every
  token, experts with no rows, exact ties (the lower expert wins), gates
  not renormalised, a G1 expert with every row;
- the tallies: ``moe_rows`` reads 2T a MoE layer, ``moe_rows_max`` the
  busiest expert's rows, through a stamped program and ``process_batch``;
- the weight bridge with the stacked experts, the seeded init, the serving
  cast (router f32, experts bf16), the configuration's widths against the
  factory and ``perfbench/counts``, and the counts by hand.

M1, G1 and M2 themselves run only on a card (``tests/test_torch_gpu.py -k
moe``).
"""

import inspect
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench import harness, weights
from perfbench.counts import moe as moe_counts
from perfbench.counts import vit_b16 as vit_counts
from perfbench.counts import vmoe_b16 as counts
from perfbench.reference.nets import merge
from perfbench.reference.precision import Precision
from perfbench.reference.regressors import vit_b16 as vit_ref
from perfbench.reference.regressors import vmoe_b16 as ref
from synergynet_tpu_torch.convert import (flax_from_state_dict,
                                          state_dict_from_flax,
                                          synergy_state_dict)
from synergynet_tpu_torch.core.profiling import recorder, tally
from synergynet_tpu_torch.nn import SynergyNet, available_backbones
from synergynet_tpu_torch.nn.layers import cast_layers_
from synergynet_tpu_torch.nn.moe import MoeMlp
from synergynet_tpu_torch.nn.synergy import init_synergy_variables
from synergynet_tpu_torch.ops import moe as ops
from synergynet_tpu_torch.pipeline.program import ProgramCache

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(patch=8, width=64, depth=4, heads=4, mlp_dim=128,
             image_size=32, moe_blocks=(1, 3), experts=8)
SMALL_SPEC = dict(width=64, depth=4, mlp=128, patch=8, crop=32, experts=8,
                  moe_blocks=(1, 3))
TOKENS = (32 // 8) ** 2 + 1
# Float32 on both sides and the same operations in the same order but the
# matrix products' sums (oneDNN's, the reference's own call) and the
# softmax (M1's fold against torch.softmax): ~1e-7 of the parameters' norm
# (seeds 3-5 read 0), so 1e-5 still sees a wrong gate or expert.
F32_REL = 1e-5
# bf16 keeps 8 significant bits: every GEMM operand, each block's output
# and the residual stream round at 2^-9 relative, and a token whose top two
# sit within that of a tie changes experts; over four blocks this reads
# 0.3-3% of the parameters' norm (seeds 3-5, 1-5 of the 102 tokens a MoE
# layer flipped). fp8 e4m3 (4 bits) in the reference reads 6.7-29%, so 5%
# tells the two apart.
BF16_REL = 0.05


@pytest.fixture
def heads_of_16(monkeypatch):
    """The reference's heads are 64 wide, as published; the small net has
    4 heads of 16."""
    monkeypatch.setattr(vit_ref, "HEAD_DIM", 16)


def _tree(seed):
    return weights.draw(ref.spec(**SMALL_SPEC), seed, "cpu")


def _crops(n, seed, side=32):
    g = torch.Generator().manual_seed(seed)
    u8 = torch.randint(0, 256, (n, side, side, 3), generator=g)
    return (u8.float() - 127.5) / 128.0


def _reference(tree, x, kind="f32", routes=None):
    t = merge(tree["params"], tree["batch_stats"])["backbone"]
    return ref.forward(Precision(kind), t, x, routes)


def _port(tree, dtype, routes=None):
    model = SynergyNet("vmoe_b16", dtype=dtype, **SMALL)
    model.load_state_dict(synergy_state_dict(weights.numpy_tree(tree)))
    for m in model.modules():
        if isinstance(m, MoeMlp):
            m.routes = routes
    return cast_layers_(model, dtype).eval()


def _rel(got, want):
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


@pytest.mark.parametrize("seed", [3, 4])
def test_vmoe_f32_matches_the_reference(seed, heads_of_16):
    tree, x = _tree(seed), _crops(6, seed)
    got_routes, want_routes = [], []
    with torch.no_grad():
        got, feat = _port(tree, torch.float32, got_routes)(x)
    want = _reference(tree, x, routes=want_routes)
    assert got.shape == (6, 62) and feat.shape == (6, 64)
    assert _rel(got, want) < F32_REL
    assert len(got_routes) == len(want_routes) == 2
    for g, w in zip(got_routes, want_routes):
        assert g.shape == (6 * TOKENS, 2)
        assert torch.equal(g.long(), w)


@pytest.mark.parametrize("seed", [3, 5])
def test_vmoe_bf16_within_rounding_and_fp8_outside(seed, heads_of_16):
    tree, x = _tree(seed), _crops(6, seed)
    with torch.no_grad():
        got, _ = _port(tree, torch.bfloat16)(x)
    want = _reference(tree, x)
    assert got.dtype == torch.float32
    assert _rel(got, want) < BF16_REL
    assert _rel(_reference(tree, x, "fp8"), want) > BF16_REL


# -- the twins of M1, G1 and M2 ----------------------------------------------

def _layer(seed, width=64, mlp=128, experts=8):
    """An MoeMlp drawn as the benchmark draws it, the reference's node of
    the same weights, and the layer's f32 tensors."""
    spec = [("params", ("Moe",) + path[3:], shape, kind)
            for _, path, shape, kind in ref.spec(**SMALL_SPEC)
            if path[1:3] == ("encoderblock_1", "Moe")]
    tree = weights.draw(spec, seed, "cpu")["params"]
    layer = MoeMlp(width, mlp, experts)
    layer.load_state_dict({k[len("Moe."):]: v for k, v in
                           state_dict_from_flax({"params": weights.numpy_tree(
                               tree)}).items()})
    return layer.eval(), tree["Moe"]


def _tokens(n, seed, width=64):
    return torch.randn(n, width, generator=torch.Generator().manual_seed(
        seed))


def _run(layer, z, u):
    w1, w2 = layer.Dense_0, layer.Dense_1
    return ops.moe_mlp(z, u, layer.Router.weight, w1.weight, w1.bias,
                       w2.weight, w2.bias)


@pytest.mark.parametrize("seed", [0, 1])
def test_dispatch_twin_routes_as_the_reference(seed):
    """M1's twin picks the reference's experts, with the reference's gates
    to f32 rounding; every (token, k) row of x is the token's row, each
    expert's rows contiguous from its offset, its tokens ascending."""
    layer, node = _layer(seed)
    u = _tokens(300, seed)
    with torch.no_grad():
        d = ops.moe_dispatch_reference(u, layer.Router.weight)
        gate, expert = ref.route(Precision("f32"), node["Router"], u)
    assert torch.equal(d.expert.long(), expert)
    torch.testing.assert_close(d.gate, gate, rtol=1e-6, atol=1e-7)
    counts = torch.bincount(d.expert.reshape(-1).long(), minlength=8)
    assert d.offsets.tolist() == [0] + counts.cumsum(0).tolist()
    assert d.tiles.tolist() == [0] + (
        (counts + ops.BLOCK_M - 1) // ops.BLOCK_M).cumsum(0).tolist()
    assert d.stats.tolist() == [600, counts.max().item()]
    slot = d.slot.long()
    assert sorted(slot.reshape(-1).tolist()) == list(range(600))
    assert torch.equal(d.x[slot[:, 0]], u) and torch.equal(d.x[slot[:, 1]],
                                                           u)
    for e in range(8):
        r0, r1 = d.offsets[e].item(), d.offsets[e + 1].item()
        mine = (d.expert == e).nonzero()
        rows = slot[mine[:, 0], mine[:, 1]]
        assert sorted(rows.tolist()) == list(range(r0, r1))
        assert torch.equal(rows, torch.arange(r0, r1))  # tokens ascending


@pytest.mark.parametrize("seed", [0, 1])
def test_gemm_and_combine_twins_are_the_reference_loop(seed):
    """G1's twin (twice) and M2's give the reference's per-expert sum,
    ``z + sum over the top two of g MLP(u)``, to f32 rounding."""
    layer, node = _layer(seed)
    u, z = _tokens(300, seed), _tokens(300, seed + 10)
    with torch.no_grad():
        out, d = _run(layer, z, u)
        want = z + ref.moe(Precision("f32"), node, u)
        h = ops.moe_gemm_reference(d.x, layer.Dense_0.weight,
                                   layer.Dense_0.bias, d.offsets, True)
        for e in range(8):
            r0, r1 = d.offsets[e].item(), d.offsets[e + 1].item()
            torch.testing.assert_close(
                h[r0:r1], F.gelu(d.x[r0:r1] @ layer.Dense_0.weight[e]
                                 + layer.Dense_0.bias[e]))
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


def test_combine_twin_sums_in_f32_and_rounds_once():
    z = torch.randn(5, 16).to(torch.bfloat16)
    y = torch.randn(10, 16).to(torch.bfloat16)
    slot = torch.tensor([[1, 0], [2, 3], [4, 5], [9, 6], [7, 8]],
                        dtype=torch.int32)
    gate = torch.rand(5, 2)
    got = ops.moe_combine_reference(z, y, slot, gate)
    s = slot.long()
    want = (z.double() + gate[:, :1].double() * y[s[:, 0]].double()
            + gate[:, 1:].double() * y[s[:, 1]].double())
    assert got.dtype == torch.bfloat16
    # One rounding to bf16 of a sum taken to f32: within half a bf16 step.
    assert ((got.double() - want).abs()
            <= want.abs() * 2 ** -8 + 1e-30).all()


def test_one_expert_takes_every_token_and_the_others_none():
    """A router that ranks expert 5 first and 2 second for every token:
    experts 5 and 2 hold T rows each, the six others none."""
    layer, node = _layer(0)
    with torch.no_grad():
        layer.Router.weight.zero_()
        layer.Router.weight[5, 0] = 2.0
        layer.Router.weight[2, 0] = 1.0
    u = _tokens(40, 3).abs() + 0.1
    z = _tokens(40, 4)
    with torch.no_grad():
        out, d = _run(layer, z, u)
        node["Router"]["kernel"] = layer.Router.weight.T
        want = z + ref.moe(Precision("f32"), node, u)
    assert (d.expert[:, 0] == 5).all() and (d.expert[:, 1] == 2).all()
    assert d.offsets.tolist() == [0, 0, 0, 40, 40, 40, 80, 80, 80]
    assert d.tiles.tolist() == [0, 0, 0, 1, 1, 1, 2, 2, 2]
    assert d.stats.tolist() == [80, 40]
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


def test_exact_ties_go_to_the_lower_expert_and_gates_stay_unnormalised():
    """All-zero tokens tie every expert: experts 0 and 1, each gate 1/E.
    Experts 3 and 6 sharing the router row that ranks first tie: 3
    first, 6 second, equal gates. The kept gates sum below 1: the top two
    of the softmax over all experts, not renormalised."""
    w = torch.randn(8, 64, generator=torch.Generator().manual_seed(0)) * 0.01
    w[6] = w[3] = 0.03
    u = torch.cat([torch.zeros(3, 64), _tokens(5, 1).abs()])
    d = ops.moe_dispatch_reference(u, w)
    assert d.expert[:3].tolist() == [[0, 1]] * 3
    assert (d.gate[:3] == 1 / 8).all()
    assert d.expert[3:].tolist() == [[3, 6]] * 5
    assert torch.equal(d.gate[3:, 0], d.gate[3:, 1])
    probs = ops.router_probs_reference(ops.router_logits_reference(u, w))
    torch.testing.assert_close(probs.sum(-1), torch.ones(8))
    assert torch.equal(d.gate, probs.gather(1, d.expert.long()))
    assert (d.gate.sum(-1) < 1).all()


@pytest.mark.parametrize("counts", [[0, 0, 37, 0], [37, 0, 0, 0],
                                    [0, 0, 0, 37], [5, 0, 32, 0]])
def test_gemm_twin_takes_empty_experts_and_one_with_every_row(counts):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(37, 16, generator=g)
    w = torch.randn(4, 16, 24, generator=g)
    b = torch.randn(4, 24, generator=g)
    offsets = torch.tensor([0] + np.cumsum(counts).tolist(),
                           dtype=torch.int32)
    out = ops.moe_gemm_reference(x, w, b, offsets, gelu=False)
    at = 0
    for e, n in enumerate(counts):
        torch.testing.assert_close(out[at:at + n], x[at:at + n] @ w[e] + b[e])
        at += n


def test_the_logits_sum_in_the_order_of_the_width():
    """M1's twin adds the products in the order of D, each rounded: the
    same as a float32 loop, and not in general the matrix product's
    bits."""
    u, w = _tokens(64, 5), torch.randn(8, 64)
    got = ops.router_logits_reference(u, w)
    want = np.zeros((64, 8), np.float32)
    un, wn = u.numpy(), w.numpy()
    for k in range(64):
        want = want + (un[:, k:k + 1] * wn[:, k]).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    torch.testing.assert_close(got, u @ w.T, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("experts", [1, 2, 3, 12, 64])
def test_expert_counts_the_kernels_do_not_take_raise(experts):
    with pytest.raises(ValueError, match="power of two"):
        ops.moe_dispatch_reference(torch.zeros(4, 8),
                                   torch.zeros(experts, 8))


def test_wrappers_raise_on_other_devices():
    meta = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no MoE dispatch"):
        ops.moe_dispatch(meta, torch.empty(4, 8, device="meta"))
    with pytest.raises(ValueError, match="no MoE combine"):
        ops.moe_combine(meta, meta, meta, meta)


def _layer_inputs(seed, t=40, d=16, e=8, h=32):
    g = torch.Generator().manual_seed(seed)
    shapes = ((t, d), (t, d), (e, d), (e, d, h), (e, h), (e, h, d), (e, d))
    return [torch.randn(s, generator=g) / s[-2 if len(s) == 3 else -1] ** .5
            for s in shapes]


@pytest.mark.parametrize("leaves", ["all", "weights"])
def test_autograd_layer_gives_the_twins_output_and_gradient(leaves):
    """The layer's autograd function, which a card runs where autograd
    records the call (the kernels forward, the twins' gradient
    recomputed), here on CPU tensors, where its forward runs the twins:
    its output, dispatch and every recorded input's gradient equal the
    twins' layer's, whether the tokens record or only the weights."""
    inputs = _layer_inputs(7)
    for i, x in enumerate(inputs):
        x.requires_grad_(leaves == "all" or i >= 2)
    wanted = [x for x in inputs if x.requires_grad]
    out, *disp = ops._MoeMlp.apply(*inputs)
    want, want_disp = ops.moe_mlp_reference(*inputs)
    assert torch.equal(out, want)
    for a, b in zip(disp, want_disp):
        assert torch.equal(a, b)
    grad = torch.randn_like(out)
    got = torch.autograd.grad(out, wanted, grad)
    for a, b in zip(got, torch.autograd.grad(want, wanted, grad)):
        assert torch.equal(a, b)
    assert all(g.abs().sum() > 0 for g in got)


# -- tallies -----------------------------------------------------------------

def test_a_stamped_body_tallies_the_rows_of_every_moe_layer():
    """Through a stamped program on the CPU, each call adds 2T rows a MoE
    layer to ``moe_rows`` and the busiest expert's rows to
    ``moe_rows_max``; a program that tallies other names is passed over,
    and ``tally`` by name takes a subset in the program's order."""
    model = SynergyNet("vmoe_b16", **SMALL).eval()
    routes = []
    for m in model.modules():
        if isinstance(m, MoeMlp):
            m.routes = routes
    x = _crops(3, 1)
    cache = ProgramCache(torch.device("cpu"), "test")
    tallies = ("a", "moe_rows", "moe_rows_max")

    def body(x):
        tally(lambda: (torch.tensor(7),), ("a",))
        with torch.no_grad():
            return model(x)

    recorder.reset()
    for _ in range(2):
        cache.run("test.moe", body, x, stages=("copy_in", "clone_out"),
                  tallies=tallies)
    c = recorder.counters("test.moe", cache.engine)
    rows = 2 * 3 * TOKENS
    busiest = sum(torch.bincount(r.reshape(-1).long()).max().item()
                  for r in routes)
    assert c["a"] == 14 and c["moe_rows"] == 2 * 2 * rows
    assert c["moe_rows_max"] == busiest and len(routes) == 4
    cache.run("test.other", body, x, stages=("copy_in", "clone_out"),
              tallies=("a",))
    assert recorder.counters("test.other", cache.engine)["a"] == 7


@pytest.fixture(scope="module")
def detector():
    from synergynet_tpu_torch.detect.detector import (FaceBoxes,
                                                      random_init_variables)
    return FaceBoxes(random_init_variables(0), device="cpu")


def test_process_batch_tallies_two_rows_a_token_a_moe_layer(detector,
                                                             monkeypatch):
    """``process_batch`` through a small V-MoE API: the program's
    ``moe_rows`` reads 2 x (face slots x tokens) x MoE layers a call, the
    dense tallies as before, the MoE layers' span under a profiler."""
    from synergynet_tpu_torch.detect.detector import prepare_frame
    from synergynet_tpu_torch.nn import backbones
    from synergynet_tpu_torch.nn.backbones.vit import vmoe_b16
    from synergynet_tpu_torch.pipeline import FusedFrameEngine, SynergyNet3DMM
    monkeypatch.setattr(backbones, "_REGISTRY", dict(backbones._REGISTRY))
    backbones.register_backbone("vmoe_small",
                                lambda **kw: vmoe_b16(**SMALL, **kw))
    api = SynergyNet3DMM("vmoe_small", dtype=torch.bfloat16, device="cpu")
    assert api.crop == 32
    engine = FusedFrameEngine(api, detector=detector, max_faces=2)
    img = np.random.default_rng(8).integers(0, 256, (720, 1088, 3),
                                            np.uint8)
    frames = [x[None] for x in prepare_frame(img, 8, "cpu")[:3]]
    recorder.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        out = engine.process_batch(*frames)
    c = recorder.counters("process_batch.b1", engine.programs.engine)
    assert engine.tallies == ("valid", "kept", "faces", "moe_rows",
                              "moe_rows_max")
    assert c["moe_rows"] == 2 * 2 * TOKENS * 2
    assert 2 * TOKENS // 8 <= c["moe_rows_max"] <= 2 * 2 * TOKENS
    assert c["valid"] >= c["kept"] >= c["faces"]
    assert sum(s.name == "synergy.moe" for s in recorder.spans()) == 2
    assert out[3].shape == (1, 2, 62) and torch.isfinite(out[3]).all()


# -- weights, widths and counts -----------------------------------------------

def test_weight_bridge_round_trip_seeded_init_and_serving_cast():
    """The stacked experts pass through the bridge both ways (flax kernel
    (in, E, out), the port's (E, in, out)); the seeded init draws each
    expert and the router lecun-normal; the serving cast rounds the
    experts to bf16 and leaves the router f32."""
    model = SynergyNet("vmoe_b16", **SMALL)
    variables = init_synergy_variables(model,
                                       torch.Generator().manual_seed(0))
    bb = variables["params"]["backbone"]
    moe = bb["encoderblock_1"]["Moe"]
    assert "Dense_0" not in bb["encoderblock_1"]
    assert "Moe" not in bb["encoderblock_0"]
    assert moe["Router"]["kernel"].shape == (64, 8)
    assert moe["Dense_0"]["kernel"].shape == (64, 8, 128)
    assert moe["Dense_1"]["kernel"].shape == (128, 8, 64)
    assert moe["Dense_1"]["bias"].shape == (8, 64) and not moe[
        "Dense_1"]["bias"].any()
    for e in range(8):
        assert 0.8 < moe["Dense_0"]["kernel"][:, e].std() * 8 < 1.2
    state = model.state_dict()
    back = state_dict_from_flax(flax_from_state_dict(state))
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    tree = weights.numpy_tree(_tree(3))
    port = SynergyNet("vmoe_b16", **SMALL)
    port.load_state_dict(synergy_state_dict(tree))
    again = flax_from_state_dict(port.state_dict())
    for name in ("Router", "Dense_0", "Dense_1"):
        np.testing.assert_array_equal(
            again["params"]["backbone"]["encoderblock_3"]["Moe"][name][
                "kernel"],
            tree["params"]["backbone"]["encoderblock_3"]["Moe"][name][
                "kernel"])
    cast_layers_(port, torch.bfloat16)
    layer = port.backbone.encoderblock_3.Moe
    assert layer.Router.weight.dtype == torch.float32
    assert {p.dtype for p in (layer.Dense_0.weight, layer.Dense_0.bias,
                              layer.Dense_1.weight, layer.Dense_1.bias)} \
        == {torch.bfloat16}


def test_registry_builds_the_published_net():
    assert "vmoe_b16" in available_backbones()
    net = SynergyNet("vmoe_b16").backbone
    moe = [i for i in range(12)
           if getattr(net, f"encoderblock_{i}").Moe is not None]
    assert moe == [1, 3, 5, 7, 9, 11] == list(counts.MOE_LAYERS)
    layer = net.encoderblock_1.Moe
    assert layer.Router.weight.shape == (32, 768)
    assert layer.Dense_0.weight.shape == (32, 768, 3072)
    assert layer.Dense_1.weight.shape == (32, 3072, 768)
    n = sum(p.numel() for p in net.parameters())
    assert 955e6 < n < 975e6                  # about 965M values


def test_widths_agree_across_configuration_counts_and_port():
    """The configuration's widths are the ones the counts use and the
    port's ``vmoe_b16`` builds, so mfu.batch and the MoE rooflines count
    the model the program runs."""
    from synergynet_tpu_torch.nn.backbones.vit import (VMOE_BLOCKS,
                                                       VisionTransformer)
    r = harness.load_cell(ROOT, "vmoe_b16.b128")[3]["regressor"]
    port = {k: p.default for k, p in inspect.signature(
        VisionTransformer).parameters.items()}
    assert (r["patch_size"], r["hidden_size"], r["num_layers"],
            r["num_heads"], r["mlp_dim"], r["crop"], r["layer_norm_eps"],
            r["num_experts"], r["top_k"], tuple(r["moe_layers"])) \
        == (vit_counts.PATCH, vit_counts.WIDTH, vit_counts.DEPTH,
            vit_counts.HEADS, vit_counts.MLP, 224, 1e-6, counts.EXPERTS,
            counts.TOP_K, counts.MOE_LAYERS) \
        == (port["patch"], port["width"], port["depth"], port["heads"],
            port["mlp_dim"], port["image_size"], port["eps"],
            port["experts"], ops.TOP_K, VMOE_BLOCKS)
    assert r["arch"] == "vmoe_b16" and r["head_dim"] * r["num_heads"] == 768


def test_moe_counts_by_hand():
    # 197 tokens, 2 experts each: both expert matrices (768 x 3072) per
    # routed row; the router 768 x 32 per token.
    assert moe_counts.gemm_flops(197, 768, 3072, 2) \
        == 2 * 2 * 197 * 2 * 768 * 3072
    assert moe_counts.router_flops(197, 768, 32) == 2 * 197 * 768 * 32
    t = 201_728
    assert moe_counts.dispatch_bytes(t, 768, 32, 2, "bfloat16") \
        == t * 768 * 2 + 32 * 768 * 4 + 2 * t * 768 * 2 + 2 * 2 * t * 4 \
        == 932_888_576
    assert moe_counts.combine_bytes(t, 768, 2, "bfloat16") \
        == 2 * t * 768 * 2 + 2 * t * 768 * 2 + 2 * 2 * t * 4 \
        == 1_242_644_480
    # A call: 6 layers of 2 x 201,728 rows through 768 x 3072 twice,
    # 22.85 TFLOP, 23.1 ms at the bf16 peak.
    assert 6 * moe_counts.gemm_flops(t, 768, 3072, 2) == 22_844_931_047_424
    per_face = vit_counts.flops(224) + 6 * (
        2 * 197 * 2 * 768 * 3072 + 2 * 197 * 768 * 32)
    assert counts.flops(224) == per_face == 46_339_064_832
