"""Hand-written Hopper kernels for the hot ops, each beside its plain
PyTorch twin."""

from synergynet_tpu_torch.ops.fused_decode import (  # noqa: F401
    DecodeBasis, build_decode_basis, decode_dense_fast, decode_dense_fused,
    decode_dense_fused_reference, get_decode_basis,
)
