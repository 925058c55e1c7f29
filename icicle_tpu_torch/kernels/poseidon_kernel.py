"""Batched Poseidon over a hand-written CUDA kernel (kernels/csrc/
poseidon.cuh; its single-word instances in poseidon.cu, its 8-limb ones in
poseidon_limbs.cu, two libraries).

`poseidon(h, x)` computes `h.hash_fields(x)` for a `Poseidon` h: one
digest per row of x (t inputs, or t - 1 after a domain tag), in one kernel
launch. No Pallas kernel is replaced: the JAX package's permutation
(icicle_tpu/ops/hash/poseidon.py:143 permute_mont) is one jitted XLA
program whose rounds XLA fuses, where eager torch would run every multiply
of every round as separate passes over the whole batch. The kernel keeps
each row's state in one thread from the inputs to the digest. Its plain
version is `Poseidon.hash_fields_ref`.

Instantiated for the single-word fields babybear, koalabear and m31 and
for the 8-limb fields below 2^255 (bn254_scalar, grumpkin_scalar,
bls12_377_scalar, bls12_381_scalar, stark252), each at t in {3, 5, 9, 12},
every width their constants have. bw6_761_scalar (12 limbs) raises on a
CUDA tensor (`require_instance`). `needed_monts` counts the Montgomery
multiplies a hash needs, the kernel's bound.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from icicle_tpu_torch.kernels import protocol_lib as L
from icicle_tpu_torch.kernels.poseidon2_kernel import MAX_BITS_8, field_consts
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

WORD_FIELDS = ("babybear", "koalabear", "m31")  # the single-word instances' moduli
LIMB_FIELDS = ("bn254_scalar", "grumpkin_scalar", "bls12_377_scalar", "bls12_381_scalar",
               "stark252")
KERNEL_WIDTHS = (3, 5, 9, 12)
ALPHA = 5  # the S-box the kernel (and the JAX package) computes
LIBRARY = {1: "poseidon", 8: "poseidon_limbs"}  # by limbs

_WORD_ARGS = ((ctypes.c_void_p,) * 3 + (ctypes.c_longlong, ctypes.c_uint32)
              + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
_UPLOAD_ARGS = (ctypes.c_uint32,) + (ctypes.c_int,) * 3 + (ctypes.c_void_p, ctypes.c_longlong)
_LIMB_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.c_longlong,) + (ctypes.c_int,) * 3
              + (ctypes.c_void_p,) * 2)


def needed_monts(h) -> int:
    """Montgomery multiplies one hash needs (the bound's count): 3 a x^5,
    t^2 a full round's matrix product and t its last round's (only lane 1
    of it is the digest), 2t - 1 a partial round's sparse product, and one
    conversion a word in and one out. bls12_381_scalar t = 9 with a tag:
    7 (27 + 81) + 57 (3 + 17) + 27 + 9 + 9 = 1,941."""
    t = h.t
    return ((h.full - 1) * (3 * t + t * t) + h.partial * (3 + 2 * t - 1) + 3 * t + t
            + h.arity + 1)


def require_instance(h) -> None:
    """Raises API_NOT_IMPLEMENTED unless the kernel is instantiated for h's
    field and width and h's S-box is x^5: the pre-launch check, callable on
    the CPU."""
    f = h.field
    if f.nlimbs == 1:
        fits = f.name in WORD_FIELDS
    else:
        fits = f.nlimbs == 8 and f.modulus.bit_length() <= MAX_BITS_8
    if not fits or h.t not in KERNEL_WIDTHS:
        raise IcicleException(
            IcicleError.API_NOT_IMPLEMENTED,
            f"poseidon: no CUDA kernel for {f.name} ({f.nlimbs} limbs) at t={h.t}: the kernel "
            f"is built for {', '.join(WORD_FIELDS + LIMB_FIELDS)} (8-limb fields below "
            f"2^{MAX_BITS_8}) at t in {KERNEL_WIDTHS}; other limb counts wait for the "
            "limb-count template of ROADMAP.md queue A item 6")
    if h.alpha != ALPHA:
        raise IcicleException(
            IcicleError.API_NOT_IMPLEMENTED,
            f"poseidon: the constants of {f.name} t={h.t} give alpha {h.alpha}; the kernel "
            f"computes x^{ALPHA}, as the JAX package does for every field")


def _host_words(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.reshape(-1).numpy().view(np.uint32))


@functools.lru_cache(maxsize=None)
def _uploaded(field_name: str, t: int, device_index: int) -> None:
    """Writes a single-word instance's constant table into its __constant__
    array on the device, once per (field, t, device)."""
    from icicle_tpu_torch.ops.hash.poseidon import Poseidon
    h = Poseidon(field_name, t)
    table = _host_words(h.constants("cpu").table)
    fn, error_string = L.entry(LIBRARY[1], "icicle_poseidon_upload", _UPLOAD_ARGS)
    with torch.cuda.device(device_index):
        err = fn(h.field.modulus, t, h.half, h.partial, table.ctypes.data, table.size)
    if err != 0:
        raise IcicleException(IcicleError.UNKNOWN_ERROR, "poseidon constant upload failed: "
                              f"{error_string(err).decode()}")


def _check(h, x: torch.Tensor) -> None:
    lim = h.field.limb_shape
    if not isinstance(x, torch.Tensor) or x.device.type not in ("cpu", "cuda"):
        raise L.invalid("poseidon", "expected a CPU or CUDA tensor")
    if x.dtype != torch.int32:
        raise L.invalid("poseidon", f"expected int32, got {x.dtype}")
    if x.dim() != 2 + len(lim) or tuple(x.shape[2:]) != lim or x.shape[1] != h.arity:
        want = f"(batch, {h.arity})" + ("" if not lim else f"+({lim[0]},)")
        raise L.invalid("poseidon", f"expected {want} elements, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise L.invalid("poseidon", "input must be contiguous")


def poseidon(h, x: torch.Tensor) -> torch.Tensor:
    """(batch, arity)+lim int32 canonical elements -> (batch,)+lim canonical
    digests of the Poseidon hasher h.

    On a CUDA tensor this launches the kernel on the current stream (no
    synchronisation), counts the launch in `poseidon.launches` and raises
    if the field or width has no instantiation or the launch is refused. On
    a CPU tensor it computes `h.hash_fields_ref`."""
    _check(h, x)
    if not x.is_cuda:
        return h.hash_fields_ref(x)
    require_instance(h)
    f = h.field
    batch = x.shape[0]
    out = torch.empty((batch,) + f.limb_shape, dtype=torch.int32, device=x.device)
    if batch == 0:
        return out
    tag = h.tag_mont("cpu")
    tag_arr = None if tag is None else _host_words(tag)   # held through the call
    tag_words = None if tag_arr is None else tag_arr.ctypes.data
    with torch.cuda.device(x.device):
        if f.nlimbs == 1:
            _uploaded(f.name, h.t, x.device.index)
            fn, error_string = L.entry(LIBRARY[1], "icicle_poseidon_hash", _WORD_ARGS)
            err = fn(x.data_ptr(), out.data_ptr(), tag_words, batch, f.modulus, h.t, h.half,
                     h.partial, L.stream())
        else:
            fn, error_string = L.entry(LIBRARY[8], "icicle_poseidon_limbs_hash", _LIMB_ARGS)
            table = h.constants(x.device).table
            err = fn(x.data_ptr(), out.data_ptr(), table.data_ptr(), tag_words, batch, h.t,
                     h.half, h.partial, ctypes.addressof(field_consts(f.name)), L.stream())
    L.raise_on("poseidon", err, error_string)
    poseidon.launches += 1
    return out


poseidon.launches = 0
