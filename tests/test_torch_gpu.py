"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the repo's conftest fixtures, so on a machine with a card
and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from synergynet_tpu_torch.mm3d import load_param_pack
from synergynet_tpu_torch.ops import (build_decode_basis, decode_dense_fused,
                                      decode_dense_fused_reference)

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-3     # the dense decode's tolerance (f32)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def full(cuda):
    pack = load_param_pack().to(cuda)
    return pack, build_decode_basis(pack).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8, 37, 1024])
def test_fused_decode_matches_plain_twin(cuda, full, b):
    pack, basis = full
    rng = np.random.default_rng(b)
    p = torch.tensor(rng.normal(0, 1, (b, 62)).astype(np.float32),
                     device=cuda)
    before = decode_dense_fused.launches
    got = decode_dense_fused(p, basis, pack)
    torch.cuda.synchronize()
    assert decode_dense_fused.launches == before + 1
    assert got.shape == (b, 3, 53215)
    torch.testing.assert_close(got, decode_dense_fused_reference(p, basis,
                                                                 pack),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_fused_decode_ragged_small_basis(cuda):
    """A vertex count that is not a tile multiple, with padding columns."""
    rng = np.random.default_rng(0)
    nver, npad = 97, 128
    w = torch.zeros((3, npad, 50))
    w[:, :nver] = torch.tensor(rng.normal(0, 3, (3, nver, 50)),
                               dtype=torch.float32)
    u = torch.zeros((3, npad))
    u[:, :nver] = torch.tensor(rng.normal(60, 20, (3, nver)),
                               dtype=torch.float32)
    from synergynet_tpu_torch.ops import DecodeBasis
    basis = DecodeBasis(w.to(cuda), u.to(cuda), nver)
    pack = load_param_pack().to(cuda)
    p = torch.tensor(rng.normal(0, 1, (19, 62)).astype(np.float32),
                     device=cuda)
    got = decode_dense_fused(p, basis, pack)
    torch.testing.assert_close(got, decode_dense_fused_reference(p, basis,
                                                                 pack),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_fused_decode_rejects_what_it_does_not_take(cuda, full):
    pack, basis = full
    p = torch.zeros((2, 62), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        decode_dense_fused(p, basis, pack)
    p = torch.zeros((2, 62), device=cuda)
    with pytest.raises(ValueError):
        decode_dense_fused(p, basis._replace(w=basis.w.cpu()), pack)
