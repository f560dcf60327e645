"""SynergyNet on PyTorch + CUDA: the port of ``synergynet_tpu`` to one
NVIDIA H100.

The package mirrors the JAX package's module layout and names, so each
module's counterpart is easy to find (``synergynet_tpu/mm3d/codec.py`` ->
``synergynet_tpu_torch/mm3d/codec.py``). It imports ``torch`` and never
``jax``; the JAX package stays the reference that the tests hold the port
against.

Public functions keep the JAX package's layouts (NHWC images, ``(B, 3, N)``
vertices); modules run NCHW in ``channels_last`` memory inside. Every TPU
kernel on a ported path is a kernel written by hand for Hopper under
``csrc/``, built at first use; its plain PyTorch twin sits beside it and is
what runs on a CPU tensor.
"""

__version__ = "0.1.0"

from synergynet_tpu_torch.mm3d import (  # noqa: F401,E402
    ParamPack,
    load_param_pack,
    decode_param62,
    decode_landmarks,
    decode_dense,
    pose_from_param,
)

from synergynet_tpu_torch.pipeline.api import SynergyNet3DMM  # noqa: F401,E402
