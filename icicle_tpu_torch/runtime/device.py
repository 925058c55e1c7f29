"""Device runtime on PyTorch (counterpart of icicle_tpu/runtime/device.py).

Reference layer L0 (include/icicle/{device,device_api,runtime}.h) hides
vendor runtimes behind set_device / synchronize calls. Here a device is a
`torch.device`: tensors carry theirs, and a function that takes a tensor
computes on that tensor's device. Functions that create tensors take an
explicit `device=`; when it is None they use `default_device()`.

The port runs on the card. `default_device()` is CUDA, and it raises when no
CUDA device exists unless the caller asked for the CPU with
`set_device("cpu")` (or passed `device="cpu"` where tensors are created).
There is no silent move to the CPU.
"""

from __future__ import annotations

import torch

from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException
from icicle_tpu_torch.runtime.log import logger

_device: torch.device | None = None


def set_device(device) -> None:
    """Select the default device, e.g. "cpu" or "cuda:0" (reference
    icicle_set_device, src/runtime.cpp:15)."""
    global _device
    _device = canonical(torch.device(device))
    logger.info("default device set to %s", _device)


def default_device() -> torch.device:
    """The device set with `set_device`, else CUDA; raises without CUDA."""
    if _device is not None:
        return _device
    if not torch.cuda.is_available():
        raise IcicleException(
            IcicleError.INVALID_DEVICE,
            "no CUDA device; pass device='cpu' or call set_device('cpu') "
            "to compute on the CPU")
    return canonical(torch.device("cuda"))


def canonical(device: torch.device) -> torch.device:
    """`cuda` -> `cuda:<current index>`, so equal devices compare equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def resolve(device=None) -> torch.device:
    """`device=` argument -> torch.device (None -> default_device())."""
    if device is None:
        return default_device()
    return canonical(torch.device(device))


def synchronize(device=None) -> None:
    """Block until queued work on `device` completes (reference
    icicle_device_synchronize). A no-op on the CPU."""
    dev = resolve(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
