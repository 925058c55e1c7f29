"""Per-op backend registry (counterpart of icicle_tpu/runtime/dispatcher.py).

Reference L3 (include/icicle/dispatcher.h) keys a per-API function table by
device-type string. Here a backend is a kernel implementation: "torch"
(plain tensor ops, any device) or "cuda" (hand-written CUDA kernels for
Hopper). "auto" picks "cuda" for a CUDA tensor and "torch" for a CPU tensor.

A backend that is not registered for an api raises: there is no fallback to
another backend.
"""

from __future__ import annotations

import threading
from typing import Callable

import torch

from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException
from icicle_tpu_torch.runtime.log import logger

TORCH = "torch"
CUDA = "cuda"
AUTO = "auto"

_registry: dict[str, dict[str, Callable]] = {}
_lock = threading.Lock()


def register_impl(api: str, backend: str, fn: Callable) -> Callable:
    """Register `fn` as the `backend` implementation of `api`
    (analog of REGISTER_<API>_BACKEND macros, include/icicle/backend/*.h)."""
    with _lock:
        _registry.setdefault(api, {})[backend] = fn
    logger.debug("registered %s backend for %s", backend, api)
    return fn


def dispatch(api: str, backend: str | None, x: torch.Tensor) -> Callable:
    """Resolve the implementation of `api` for input tensor `x`
    (reference dispatcher.h:38-50)."""
    impls = _registry.get(api)
    if not impls:
        raise IcicleException(IcicleError.API_NOT_IMPLEMENTED, api)
    choice = backend or AUTO
    if choice == AUTO:
        choice = CUDA if x.is_cuda else TORCH
    if choice not in impls:
        raise IcicleException(
            IcicleError.API_NOT_IMPLEMENTED, f"{api} has no {choice} backend")
    return impls[choice]
