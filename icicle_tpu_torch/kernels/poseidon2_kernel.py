"""Batched Poseidon2 over a hand-written CUDA kernel
(kernels/csrc/poseidon2.cu).

`poseidon2(h, x)` computes `h.hash_fields(x)` for a `Poseidon2` h: one
digest per row of x, the permutation or the sponge as the row length
chooses, in one kernel launch. No Pallas kernel is replaced: the JAX
package's permutation (icicle_tpu/ops/hash/poseidon2.py:211 permute_mont)
is one jitted XLA program whose rounds XLA fuses, where eager torch would
run every multiply of every round as separate passes over the whole batch.
The kernel keeps each row's state in one thread's registers from the
inputs to the digest. Its plain version is `Poseidon2.hash_fields_ref`.

Instantiated for single-word fields (p < 2^31: babybear, koalabear, m31)
at every width their constants have, t in {2, 3, 4, 8, 12, 16, 20, 24},
and for 8-limb fields below 2^255 (bn254_scalar, grumpkin_scalar,
bls12_377_scalar, bls12_381_scalar, stark252) at t in {2, 3, 4, 8}, over
ec_field.cuh's Montgomery arithmetic. Other fields (bw6_761_scalar, 12
limbs) raise on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icicle_tpu_torch.fields.field import field_params
from icicle_tpu_torch.kernels import build
from icicle_tpu_torch.math.params import limbs_of
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

# limbs -> the widths t the kernel is instantiated for
KERNEL_WIDTHS = {1: (2, 3, 4, 8, 12, 16, 20, 24), 8: (2, 3, 4, 8)}
MAX_BITS_8 = 255  # mont_mul<8>'s one final subtraction needs 2p < 2^256


def _invalid(msg: str) -> IcicleException:
    return IcicleException(IcicleError.INVALID_ARGUMENT, f"poseidon2: {msg}")


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("poseidon2")
    fn = lib.icicle_poseidon2_hash
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    # ec_field.cuh, which the source includes, exports the error text
    lib.icicle_msm_error_string.argtypes = [ctypes.c_int]
    lib.icicle_msm_error_string.restype = ctypes.c_char_p
    return fn, lib.icicle_msm_error_string


@functools.lru_cache(maxsize=None)
def field_consts(field_name: str):
    """{p[L], one[L], inv32, 0, r2[L]} as a host uint32 array: R mod p, the
    Montgomery unit (the sponge's padding one), and R^2 mod p (into
    Montgomery form), R = 2^(32 L); the 0 is ec_field.cuh CurveConsts' b3,
    unused."""
    fp = field_params(field_name)
    nl = fp.nlimbs
    values = (limbs_of(fp.modulus, nl) + limbs_of(fp.r, nl) + [fp.inv32, 0]
              + limbs_of(fp.r2, nl))
    return (ctypes.c_uint32 * len(values))(*values)


def _check(h, x: torch.Tensor) -> None:
    lim = h.field.limb_shape
    if x.device.type not in ("cpu", "cuda"):
        raise _invalid(f"expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise _invalid(f"expected int32, got {x.dtype}")
    if x.dim() != 2 + len(lim) or tuple(x.shape[2:]) != lim or x.shape[1] < 1:
        want = "(batch, n)" if not lim else f"(batch, n, {lim[0]})"
        raise _invalid(f"expected {want} elements, n >= 1, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise _invalid("input must be contiguous")


def supported_on_cuda(h) -> bool:
    """Whether the kernel is instantiated for h's field and width."""
    f = h.field
    nl = f.nlimbs
    return (h.t in KERNEL_WIDTHS.get(nl, ())
            and (nl == 1 or f.modulus.bit_length() <= MAX_BITS_8))


def poseidon2(h, x: torch.Tensor) -> torch.Tensor:
    """(batch, n)+lim int32 canonical elements -> (batch,)+lim canonical
    digests of the Poseidon2 hasher h.

    On a CUDA tensor this launches the kernel on the current stream (no
    synchronisation), counts the launch in `poseidon2.launches` and raises
    if the field or width has no instantiation or the launch is refused. On
    a CPU tensor it computes `h.hash_fields_ref`."""
    _check(h, x)
    if not x.is_cuda:
        return h.hash_fields_ref(x)
    f = h.field
    if not supported_on_cuda(h):
        raise IcicleException(
            IcicleError.API_NOT_IMPLEMENTED,
            f"poseidon2: no CUDA kernel for {f.name} ({f.nlimbs} limbs) at t={h.t}: the "
            f"kernel is built for single-word fields and 8-limb fields below 2^{MAX_BITS_8}; "
            "other limb counts wait for the limb-count template of ROADMAP.md queue A item 6")
    batch, n = x.shape[:2]
    out = torch.empty((batch,) + f.limb_shape, dtype=torch.int32, device=x.device)
    if batch == 0:
        return out
    c = h.constants(x.device)
    fn, error_string = _kernel()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), c.rc.data_ptr(), c.mds.data_ptr(),
                 c.diag_m1.data_ptr(), None if c.tag is None else c.tag.data_ptr(),
                 batch, n, h.t, f.nlimbs, h.half_full, h.partial_rounds, h.alpha,
                 ctypes.addressof(field_consts(f.name)),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise IcicleException(IcicleError.UNKNOWN_ERROR,
                              f"poseidon2 launch failed: {error_string(err).decode()}")
    poseidon2.launches += 1
    return out


poseidon2.launches = 0
