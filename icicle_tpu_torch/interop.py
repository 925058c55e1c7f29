"""Carrying the JAX package's state across to the port.

The JAX package (icicle_tpu) keeps field elements as uint32 arrays; the port
keeps them as int32 tensors holding the same canonical value in [0, p).
Every single-limb modulus is below 2^31, so `astype(np.int32)` and back is
exact. These functions take and give numpy arrays only: the port imports
nothing of JAX, and a caller that holds a jax.Array passes
`np.asarray(array)`.
"""

from __future__ import annotations

import numpy as np
import torch

from icicle_tpu_torch.fields.field import Field
from icicle_tpu_torch.ops.ntt import NttDomain
from icicle_tpu_torch.runtime.device import resolve
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException


def elements_from_numpy(f: Field, arr_u32, device=None) -> torch.Tensor:
    """uint32 element array (canonical, < p) -> int32 element tensor."""
    a = np.asarray(arr_u32)
    if a.dtype != np.uint32:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"expected a uint32 element array, got {a.dtype}")
    if a.size and int(a.max()) >= f.modulus:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"element >= {f.name} modulus: not canonical")
    return torch.from_numpy(a.astype(np.int32)).to(resolve(device))


def elements_to_numpy(f: Field, t: torch.Tensor) -> np.ndarray:
    """int32 element tensor -> uint32 element array."""
    return t.cpu().numpy().astype(np.uint32)


def domain_from_numpy(f: Field, logn: int, twiddles_u32, twiddles_inv_u32,
                      device=None) -> NttDomain:
    """The JAX package's NttDomain tables (w^0..w^(n/2-1) in Montgomery form,
    forward and inverse) -> the port's NttDomain on `device`."""
    w = f.omega(logn)
    return NttDomain(f, logn, w, pow(w, -1, f.modulus),
                     elements_from_numpy(f, twiddles_u32, device),
                     elements_from_numpy(f, twiddles_inv_u32, device))
