"""The port's reference-checkpoint importer for the regressor
(``nn/torch_import.py``) against the JAX package's, on reference-layout
state dicts made from a numpy seed (the released ``best.pth.tar`` is not in
the repository), and an imported tree served by ``SynergyNet3DMM``
against the JAX API on the same tree.

The JAX importer is read as the reference: ``expected_torch_shapes`` of
the port (from its own modules) equals the JAX name map over the JAX
init's shapes (``jax.eval_shape``), and the converted trees are equal leaf
for leaf, dtype included.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synergynet_tpu.nn import SynergyNet as JaxSynergyNet
from synergynet_tpu.nn import torch_import as jti
from synergynet_tpu.pipeline import SynergyNet3DMM as JaxApi
from synergynet_tpu_torch.core.checkpoint import save_checkpoint
from synergynet_tpu_torch.nn import torch_import as tti
from synergynet_tpu_torch.pipeline import SynergyNet3DMM

torch.set_num_threads(2)

CHAIN = dict(rtol=1e-4, atol=1e-2)     # tests/test_torch_api.py
# One name per family, both kinds of MobileNetV1 / ResNet block, and the
# ResNeSt ablations' layer map.
FAMILIES = ["mobilenet_v2", "mobilenet_1", "resnet18", "resnet50",
            "resnext50_32x4d", "ghostnet", "resnest50",
            "resnest50_fast_2s2x40d"]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert isinstance(g, np.ndarray) and g.dtype == np.asarray(w).dtype
        assert np.array_equal(g, np.asarray(w)), k


def _jax_init_shapes(arch):
    model = JaxSynergyNet(arch=arch)
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 120, 120, 3)),
        method=JaxSynergyNet.init_all))


def _reference_file(tmp_path, arch, seed=3):
    """A ``best.pth.tar`` as the reference saves it: ``{"state_dict":
    ...}`` with DataParallel ``module.`` prefixes and an unmapped 3DMM
    buffer and ``num_batches_tracked`` beside the mapped leaves."""
    sd = tti.seeded_torch_state_dict(tti.expected_torch_shapes(arch), seed)
    sd["param_mean"] = torch.zeros(62)
    sd["I2P.backbone.bn1.num_batches_tracked"] = torch.tensor(7)
    path = os.path.join(tmp_path, "best.pth.tar")
    torch.save({"epoch": 80, "state_dict": {"module." + k: v
                                            for k, v in sd.items()}}, path)
    return path


@pytest.mark.parametrize("arch", FAMILIES)
def test_expected_shapes_match_the_jax_map_over_its_init(arch):
    shapes = _jax_init_shapes(arch)
    want = {}
    for tname, fpath in jti._torch_to_flax_names(arch).items():
        node = shapes
        for k in fpath:
            node = node[k]
        s = tuple(node.shape)
        if tname.endswith(".weight") and len(s) == 4:
            s = (s[3], s[2], s[0], s[1])            # HWIO -> OIHW
        elif tname.endswith(".weight") and len(s) == 2:
            s = (s[1], s[0]) + ((1,) if "conv" in tname.split(".")[-2]
                                else ())            # Conv1d / Linear
        want[tname] = s
    assert tti.expected_torch_shapes(arch) == want


@pytest.mark.parametrize("arch", FAMILIES)
def test_converted_tree_equals_jax(arch, tmp_path):
    """``load_synergynet_variables`` on the same saved ``.pth.tar``: the
    port's tree equals the JAX importer's leaf for leaf."""
    path = _reference_file(tmp_path, arch)
    got = tti.load_synergynet_variables(path, arch=arch)
    _assert_trees_equal(got, jti.load_synergynet_variables(path, arch=arch))


@pytest.mark.parametrize("arch", ["mobilenet_1", "resnet18", "ghostnet"])
def test_texture_heads_convert_as_jax(arch):
    shapes = tti.expected_torch_shapes(arch)
    head = "I2P.backbone." + ("classifier_texture" if arch == "ghostnet"
                              else "fc_tex")
    feat = shapes["I2P.backbone." + ("classifier_ori" if arch == "ghostnet"
                                     else "fc_ori") + ".weight"][1]
    shapes[head + ".weight"], shapes[head + ".bias"] = (40, feat), (40,)
    sd = tti.seeded_torch_state_dict(shapes, 4)
    for tex in (False, True):
        got = tti.convert_synergynet_state_dict(sd, strict=True, arch=arch,
                                                with_texture=tex)
        want = jti.convert_synergynet_state_dict(sd, strict=True, arch=arch,
                                                 with_texture=tex)
        _assert_trees_equal(got, want)
        assert ("fc_texture" in got["params"]["backbone"]["ParamHead_0"]
                ) == tex


def test_strictness_and_errors(tmp_path):
    sd = tti.seeded_torch_state_dict(tti.expected_torch_shapes("resnet18"),
                                     0)
    sd.pop("I2P.backbone.layer1.0.conv1.weight")
    for mod in (tti, jti):
        with pytest.raises(KeyError, match="missing 1 leaves"):
            mod.convert_synergynet_state_dict(sd, strict=True,
                                              arch="resnet18")
        with pytest.raises(ValueError, match="no torch-import mapping"):
            mod.convert_synergynet_state_dict(sd, arch="densenet")
    path = _reference_file(tmp_path, "resnet18")
    (tmp_path / "v1").mkdir()
    other = tti.load_synergynet_variables(_reference_file(
        tmp_path / "v1", "mobilenet_1"), arch="mobilenet_1")
    with pytest.raises(ValueError, match="tree mismatch"):
        tti.load_synergynet_variables(path, arch="resnet18",
                                      validate_against=other)


def test_npz_branch_restores_either_package_checkpoint(tmp_path):
    """A framework ``.npz`` restores in the structure of SynergyNet(arch):
    the port's own save, and the JAX package's checkpoint format (leading
    dots on the state fields)."""
    path = _reference_file(tmp_path, "ghostnet")
    tree = tti.load_synergynet_variables(path, arch="ghostnet")
    npz = os.path.join(tmp_path, "ck.npz")
    save_checkpoint(npz, tree, step=3)
    _assert_trees_equal(tti.load_synergynet_variables(npz, arch="ghostnet"),
                        tree)
    flat = {"." + k: v for k, v in _leaves(tree)}
    jnpz = os.path.join(tmp_path, "jax.npz")
    np.savez(jnpz, **flat)
    _assert_trees_equal(tti.load_synergynet_variables(jnpz, arch="ghostnet"),
                        tree)


@pytest.mark.parametrize("arch", ["resnet50", "ghostnet", "resnest50"])
def test_imported_tree_serves_as_jax(arch, tmp_path):
    """The slice end to end on the CPU: an imported reference checkpoint in
    ``SynergyNet3DMM(variables=tree, arch=...)``, ``get_all_outputs`` with
    rects on a seeded frame against the JAX API on the same tree (f32)."""
    path = _reference_file(tmp_path, arch, seed=6)
    tree = tti.load_synergynet_variables(path, arch=arch)
    img = np.random.default_rng(8).integers(0, 256, (240, 320, 3), np.uint8)
    rects = [[40.0, 50.0, 140.0, 160.0, 0.99], [-20.5, 150.5, 60.5, 260.5],
             [250.0, -30.0, 340.0, 70.0]]
    want = JaxApi(arch=arch, variables=jax.tree_util.tree_map(
        jnp.asarray, tree)).get_all_outputs(img, rects=rects)
    got = SynergyNet3DMM(variables=tree, arch=arch,
                         device="cpu").get_all_outputs(img, rects=rects)
    assert [len(x) for x in got] == [len(rects)] * 3
    for i in range(len(rects)):
        np.testing.assert_allclose(got[0][i], want[0][i], **CHAIN)
        np.testing.assert_allclose(got[1][i], want[1][i], **CHAIN)
        for k in range(2):
            np.testing.assert_allclose(got[2][i][k], want[2][i][k], **CHAIN)


def test_trained_weights_stay_mobilenet_v2_only():
    for api in (SynergyNet3DMM, JaxApi):
        with pytest.raises(ValueError, match="no shipped trained weights"):
            if api is JaxApi:
                api(arch="resnet50", variables="trained")
            else:
                api(variables="trained", arch="resnet50", device="cpu")
