"""Public names of the JAX package in the port, on the CPU.

- ``get_decode_basis`` / ``decode_dense_fast`` against the JAX package's
  ``decode_dense_fast`` (its codec off the TPU) on the full 53,215-vertex
  pack, 9 faces, at the dense decode's tolerance (rtol 1e-4 / atol 1e-3);
  the cache gives the same basis object for the same pack, on the pack's
  device, and a new one for another pack;
- ``load_shipped_trained`` gives the JAX package's tree leaf for leaf;
- ``register_backbone``: a toy backbone registered in both packages
  builds a ``SynergyNet`` in each, the same weights give the same
  parameters, and the port's name lists and checkpoint loader take it;
- the name parity: every public name that a ``synergynet_tpu`` subpackage
  ``__init__`` exports is exported by the port's counterpart, except the
  names listed below as left out by design.
"""

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import synergynet_tpu
from synergynet_tpu.core.checkpoint import \
    load_shipped_trained as jax_load_shipped_trained
from synergynet_tpu.mm3d import load_param_pack as jax_load_param_pack
from synergynet_tpu.ops import decode_dense_fast as jax_decode_dense_fast
from synergynet_tpu_torch.mm3d import load_param_pack
from synergynet_tpu_torch.ops import (decode_dense_fast,
                                      decode_dense_fused_reference,
                                      fused_decode, get_decode_basis)
from synergynet_tpu_torch.ops.cuda_build import launches

torch.set_num_threads(2)

DENSE = dict(rtol=1e-4, atol=1e-3)      # tests/test_ops.py:20

# Names the port lacks on purpose, each left out by design (ROADMAP.md); a
# name missing from the port and not listed here fails the parity test.
NOT_PORTED = {
    # by design: jax.sharding's types; the port's shardings are
    # core.mesh.Sharding descriptors over a torch.distributed mesh
    "parallel": {"NamedSharding", "P"},
    # by design: the TPU compile-cache fingerprint; and ``measure``, which
    # nothing read: the port's serving path measures itself (the spans,
    # stage stamps and counters of ``core.profiling.recorder``)
    "core": {"enable_compile_cache", "measure"},
    # by design: the TPU binning and replication machinery and the
    # fragment window of the host z-buffer fallback
    "render": {"replication_for", "window_for"},
    # by design: synergynet_tpu/native imports JAX; the port's kernels are
    # its native layer
    "native": "*",
}


def _exported(path):
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")
            and n != "annotations"}


def _subpackages():
    root = os.path.dirname(synergynet_tpu.__file__)
    subs = [""]
    for name in sorted(os.listdir(root)):
        if os.path.isfile(os.path.join(root, name, "__init__.py")):
            subs.append(name)
    return root, subs


def test_every_public_name_is_ported_or_listed():
    root, subs = _subpackages()
    missing = {}
    for sub in subs:
        want = _exported(os.path.join(root, sub, "__init__.py"))
        skip = NOT_PORTED.get(sub, set())
        if skip == "*":
            continue
        mod = importlib.import_module(
            "synergynet_tpu_torch" + (f".{sub}" if sub else ""))
        lacks = {n for n in want - skip if not hasattr(mod, n)}
        if lacks:
            missing[sub or "<top>"] = sorted(lacks)
    assert not missing, f"names the port lacks: {missing}"


def test_listed_names_are_really_missing():
    """A listed name that the port has gained must leave the list."""
    for sub, names in NOT_PORTED.items():
        if names == "*":
            with pytest.raises(ModuleNotFoundError):
                importlib.import_module(f"synergynet_tpu_torch.{sub}")
            continue
        mod = importlib.import_module(f"synergynet_tpu_torch.{sub}")
        assert not [n for n in names if hasattr(mod, n)], sub


# -- the decode basis cache ---------------------------------------------------

def test_decode_dense_fast_matches_jax_on_the_full_pack():
    pack = load_param_pack()
    p = np.random.default_rng(4).normal(0, 1, (9, 62)).astype(np.float32)
    want = np.asarray(jax_decode_dense_fast(jnp.asarray(p),
                                            jax_load_param_pack()))
    before = launches["synergy_fused_decode"]
    got = decode_dense_fast(torch.from_numpy(p), pack)
    assert launches["synergy_fused_decode"] == before   # CPU: twin
    assert got.shape == (9, 3, 53215) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **DENSE)
    np.testing.assert_array_equal(got.numpy(), decode_dense_fused_reference(
        torch.from_numpy(p), get_decode_basis(pack), pack).numpy())


def test_decode_basis_is_cached_per_pack():
    pack = load_param_pack()
    b = get_decode_basis(pack)
    assert get_decode_basis(pack) is b
    assert b.w.device == pack.w_shp.device and b.nver == pack.nver
    assert b.w.shape == (3, 53248, 50) and b.u.shape == (3, 53248)
    other = pack._replace(w_shp=pack.w_shp.clone())
    b2 = get_decode_basis(other)
    assert b2 is not b and torch.equal(b2.w, b.w)
    key = id(other.w_shp)
    assert key in fused_decode._BASIS_CACHE
    del other
    assert key not in fused_decode._BASIS_CACHE    # dropped with the pack
    assert get_decode_basis(pack) is b


# -- shipped weights ----------------------------------------------------------

def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def test_load_shipped_trained_matches():
    from synergynet_tpu_torch.core import load_shipped_trained
    got = _leaves(load_shipped_trained("mobilenet_v2"))
    want = _leaves(jax_load_shipped_trained("mobilenet_v2"))
    assert got.keys() == want.keys() and len(got) > 100
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype == np.float32
        assert np.array_equal(got[k], w), k
    for fn in (load_shipped_trained, jax_load_shipped_trained):
        with pytest.raises(ValueError, match="no shipped trained weights"):
            fn("resnet50")


# -- register_backbone --------------------------------------------------------

class JaxToy(fnn.Module):
    """(B, 120, 120, 3) -> (param62, feat): the channel means through one
    Dense and the shared head."""
    dtype: jnp.dtype = jnp.float32

    @fnn.compact
    def __call__(self, x, train: bool = False):
        from synergynet_tpu.nn.heads import ParamHead
        feat = fnn.Dense(16)(x.mean(axis=(1, 2)))
        return ParamHead()(feat, train), feat


class TorchToy(torch.nn.Module):
    def __init__(self, dtype=torch.float32, dropout: float = 0.2):
        super().__init__()
        from synergynet_tpu_torch.nn.heads import ParamHead
        self.Dense_0 = torch.nn.Linear(3, 16)
        self.ParamHead_0 = ParamHead(16, dropout=dropout)

    def forward(self, x, generator=None):
        feat = self.Dense_0(x.mean(dim=(1, 2)))
        return self.ParamHead_0(feat, generator), feat


@pytest.fixture()
def toy_registered(monkeypatch):
    from synergynet_tpu.nn import backbones as jb
    from synergynet_tpu_torch.nn import backbones as tb
    monkeypatch.setattr(jb, "_REGISTRY", dict(jb._REGISTRY))
    monkeypatch.setattr(tb, "_REGISTRY", dict(tb._REGISTRY))
    jb.register_backbone("toy", JaxToy)
    from synergynet_tpu_torch.nn import register_backbone
    register_backbone("toy", TorchToy)


def test_register_backbone_builds_a_synergynet(toy_registered, tmp_path):
    from synergynet_tpu.nn import SynergyNet as JaxSynergyNet
    from synergynet_tpu.nn import init_synergy_variables as jax_init
    from synergynet_tpu_torch.convert import synergy_state_dict
    from synergynet_tpu_torch.core.checkpoint import save_checkpoint
    from synergynet_tpu_torch.nn import SynergyNet, available_backbones
    from synergynet_tpu_torch.nn.torch_import import \
        load_synergynet_variables
    assert "toy" in available_backbones()
    jmodel = JaxSynergyNet(arch="toy")
    variables = jax.device_get(jax_init(jmodel, jax.random.PRNGKey(0)))
    x = np.random.default_rng(0).normal(0, 1, (4, 120, 120, 3)).astype(
        np.float32)
    want, _ = jmodel.apply(variables, jnp.asarray(x))
    model = SynergyNet(arch="toy")
    model.load_state_dict(synergy_state_dict(variables))
    with torch.no_grad():
        got, feat = model.eval()(torch.from_numpy(x))
    assert feat.shape == (4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # a framework checkpoint of the toy loads through the importer
    path = str(tmp_path / "toy.npz")
    save_checkpoint(path, variables)
    back = _leaves(load_synergynet_variables(path, arch="toy"))
    want_leaves = _leaves(variables)
    assert back.keys() == want_leaves.keys()
    assert all(np.array_equal(back[k], want_leaves[k]) for k in back)


def test_unregistered_name_raises():
    from synergynet_tpu_torch.nn import SynergyNet
    with pytest.raises(ValueError, match="unknown backbone 'toy'"):
        SynergyNet(arch="toy")
