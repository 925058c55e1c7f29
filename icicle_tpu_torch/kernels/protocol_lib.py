"""What the protocol kernels' wrappers share: K1 `keccak` (keccak_kernel.py),
K2 `fri_fold` (fri_kernel.py), K3 `sumcheck_round` (sumcheck_kernel.py)
and K4 `execute_program_kernel` (program_kernel.py), each a library of its
own in build.LIBRARIES with a plain C interface that returns a
cudaError_t, whose text the library's `icicle_error_string` gives.

K2-K4 are instantiated for the single-word Montgomery fields (mont32.cuh
ICICLE_M32_FIELDS); on a CUDA tensor of any other field they raise
API_NOT_IMPLEMENTED before a launch (`require_word_field`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icicle_tpu_torch.kernels import build
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

WORD_FIELDS = ("babybear", "koalabear", "m31")  # mont32.cuh ICICLE_M32_FIELDS
TWO_ADIC_FIELDS = ("babybear", "koalabear")     # m31 has no 2-adic domain


def invalid(kernel: str, msg: str) -> IcicleException:
    return IcicleException(IcicleError.INVALID_ARGUMENT, f"{kernel}: {msg}")


def require_word_field(kernel: str, f, fields=WORD_FIELDS) -> None:
    """Raises API_NOT_IMPLEMENTED unless the kernel is instantiated for f."""
    if f.name not in fields:
        raise IcicleException(
            IcicleError.API_NOT_IMPLEMENTED,
            f"{kernel}: no CUDA kernel for {f.name} ({f.nlimbs} limbs): the kernel is built for "
            f"{', '.join(fields)}; multi-limb fields wait for the limb-count template of "
            "ROADMAP.md queue A item 6")


def check_words(kernel: str, t: torch.Tensor, ndim: int) -> None:
    """t must be a contiguous int32 tensor of `ndim` dimensions on the CPU
    or CUDA."""
    if not isinstance(t, torch.Tensor) or t.device.type not in ("cpu", "cuda"):
        raise invalid(kernel, "expected a CPU or CUDA tensor")
    if t.dtype != torch.int32:
        raise invalid(kernel, f"expected int32, got {t.dtype}")
    if t.dim() != ndim:
        raise invalid(kernel, f"expected {ndim} dimensions, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise invalid(kernel, "input must be contiguous")


def mont_int(f, value: int) -> int:
    """value R mod p, R = 2^32: a scalar argument in Montgomery form."""
    return (int(value) << 32) % f.modulus


@functools.lru_cache(maxsize=None)
def entry(library: str, name: str, argtypes: tuple):
    """(the C entry `name` of `library`, built and loaded; the library's
    error-text function)."""
    lib = build.load(library)
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    lib.icicle_error_string.argtypes = [ctypes.c_int]
    lib.icicle_error_string.restype = ctypes.c_char_p
    return fn, lib.icicle_error_string


def raise_on(kernel: str, err: int, error_string) -> None:
    if err != 0:
        raise IcicleException(IcicleError.UNKNOWN_ERROR,
                              f"{kernel} launch failed: {error_string(err).decode()}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream
