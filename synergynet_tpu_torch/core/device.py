"""The device an entry point runs on: the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is available, rather than carrying on on the CPU. A bare "cuda"
    becomes the current card's index ("cuda:0"), the device that tensors
    moved there report, so devices compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA card is "
                           "available; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# (values, dtype, device) -> the tensor on that device.
_CONSTANTS: dict = {}


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, dtype, device) and reused: a tensor made on the host is a
    blocking copy to the card, which a call that a CUDA graph captures must
    not make. ``values`` is a number or a tuple of numbers; the result must
    not be written to."""
    key = (values, dtype, torch.device(device))
    hit = _CONSTANTS.get(key)
    if hit is None:
        hit = _CONSTANTS.setdefault(
            key, torch.tensor(values, dtype=dtype, device=device))
    return hit
