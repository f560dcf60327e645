"""The port's fused dense decode against the JAX Pallas kernel (interpret
mode) at the kernel's tolerance, rtol 1e-4 / atol 1e-3 (tests/test_ops.py).
The CUDA kernel against its plain twin is in tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synergynet_tpu.ops import build_decode_basis as jax_build_basis
from synergynet_tpu.ops import decode_dense_fused as jax_decode_fused
from synergynet_tpu_torch.mm3d import ParamPack
from synergynet_tpu_torch.ops import (build_decode_basis, decode_dense_fused,
                                      decode_dense_fused_reference)
from synergynet_tpu_torch.ops.cuda_build import launches
from synergynet_tpu_torch.ops.fused_decode import FEW_FACES, decode_variant

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-3


def to_torch_pack(pack):
    return ParamPack(*(torch.from_numpy(np.asarray(x)) for x in pack))


@pytest.mark.parametrize("which", ["small_pack", "pack"])
def test_basis_layout_equals_jax(which, request):
    jpack = request.getfixturevalue(which)
    want = jax_build_basis(jpack)
    got = build_decode_basis(to_torch_pack(jpack))
    assert got.nver == want.nver and got.npad == want.npad
    assert np.array_equal(got.w.numpy(), np.asarray(want.w))
    assert np.array_equal(got.u.numpy(), np.asarray(want.u))
    if which == "pack":
        assert tuple(got.w.shape) == (3, 53248, 50)


@pytest.mark.parametrize("which,b,vt", [("small_pack", 3, 128),
                                        ("small_pack", 48, 128),
                                        ("pack", 3, 1024)])
def test_matches_jax_pallas_interpret(which, b, vt, request, rng):
    """CPU tensors take the plain twin; the JAX side runs its Pallas kernel
    in interpret mode (B=48 exercises its padded batch tile)."""
    jpack = request.getfixturevalue(which)
    tpack = to_torch_pack(jpack)
    p = rng.normal(0, 1.0 if which == "small_pack" else 0.5,
                   (b, 62)).astype(np.float32)
    want = np.asarray(jax_decode_fused(jnp.asarray(p), jax_build_basis(jpack),
                                       jpack, vertex_tile=vt, interpret=True))
    before = launches["synergy_fused_decode"]
    got = decode_dense_fused(torch.from_numpy(p), build_decode_basis(tpack),
                             tpack).numpy()
    assert launches["synergy_fused_decode"] == before    # no kernel here
    assert got.shape == want.shape == (b, 3, jpack.nver)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_plain_twin_matches_codec(small_pack, rng):
    from synergynet_tpu_torch.mm3d import decode_dense
    tpack = to_torch_pack(small_pack)
    p = torch.from_numpy(rng.normal(0, 1, (4, 62)).astype(np.float32))
    got = decode_dense_fused_reference(p, build_decode_basis(tpack), tpack)
    np.testing.assert_allclose(got.numpy(), decode_dense(p, tpack).numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,want", [(1, 0), (FEW_FACES - 1, 0),
                                    (FEW_FACES, 0), (FEW_FACES + 1, 1),
                                    (64, 1), (1024, 1)])
def test_decode_variant(b, want):
    """The wrapper's tiling: few faces (one 8-face tile, the B=1 serving
    call) up to FEW_FACES, the register-tiled many-faces kernel above."""
    assert FEW_FACES == 8
    assert decode_variant(b) == want
