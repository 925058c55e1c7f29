"""Batched Poseidon2 over a hand-written CUDA kernel
(kernels/csrc/poseidon2.cuh; its single-word instances in poseidon2.cu,
its 8-limb ones in poseidon2_limbs.cu, its goldilocks ones in
poseidon2_gl64.cu, three libraries).

`poseidon2(h, x)` computes `h.hash_fields(x)` for a `Poseidon2` h: one
digest per row of x, the permutation or the sponge as the row length
chooses, in one kernel launch. No Pallas kernel is replaced: the JAX
package's permutation (icicle_tpu/ops/hash/poseidon2.py:211 permute_mont)
is one jitted XLA program whose rounds XLA fuses, where eager torch would
run every multiply of every round as separate passes over the whole batch.
The kernel keeps each row's state in one thread's registers from the
inputs to the digest. Its plain version is `Poseidon2.hash_fields_ref`.

Instantiated for the single-word fields babybear, koalabear and m31 at
every width their constants have, t in {2, 3, 4, 8, 12, 16, 20, 24}; for
goldilocks at the same widths, every width of its constant file, over
gl64.cuh's lazy arithmetic (no Montgomery form; any 64-bit word congruent
to the value between the load and the digest's canonical store); and for
8-limb fields below 2^255 (bn254_scalar, grumpkin_scalar,
bls12_377_scalar, bls12_381_scalar, stark252) at t in {2, 3, 4, 8}, over
ec_field.cuh's Montgomery arithmetic. Other fields and widths
(bw6_761_scalar, 12 limbs) raise on a CUDA tensor.

The kernel applies the linear layers as add chains over their small
integer entries (`ext_chain`, `int_chain`; `ext_layer` and `int_layer` run
them on torch tensors, beside the plain version's Montgomery matrix
products) and takes each instance's round counts at compile time. Before
a launch, `check_linear_layers` holds the field's constants to exactly the
structure the kernel implements, and raises API_NOT_IMPLEMENTED otherwise:
no path takes a general multiply in their place. `mont_mul_model` is the
single-word Montgomery multiply's instruction sequence on Python ints, and
`needed_monts` counts the (Montgomery) multiplies a hash needs, the
kernel's bound.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from icicle_tpu_torch.fields.field import field_params
from icicle_tpu_torch.kernels import build
from icicle_tpu_torch.math.gl64 import GOLDILOCKS_P
from icicle_tpu_torch.math.params import limbs_of
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

# limbs -> the widths t the kernel is instantiated for (2: goldilocks)
KERNEL_WIDTHS = {1: (2, 3, 4, 8, 12, 16, 20, 24), 2: (2, 3, 4, 8, 12, 16, 20, 24), 8: (2, 3, 4, 8)}
WORD_FIELDS = ("babybear", "koalabear", "m31")  # the single-word instances' moduli
MAX_BITS_8 = 255  # mont_mul<8>'s one final subtraction needs 2p < 2^256
M4 = ((5, 7, 1, 3), (4, 6, 1, 1), (1, 3, 5, 7), (1, 1, 4, 6))  # the reference's 4x4 block
SMALL_DIAG_M1 = {2: (1, 2), 3: (1, 1, 2)}  # d - 1 that the kernel adds in, by width
SMALL_INT = 16  # a multiply by |k| <= SMALL_INT is an add chain, no Montgomery multiply
SBOX_MONTS = {3: 2, 5: 3, 7: 4, 9: 4, 11: 5}  # x^alpha's Montgomery multiplies
MASK32 = (1 << 32) - 1


def _invalid(msg: str) -> IcicleException:
    return IcicleException(IcicleError.INVALID_ARGUMENT, f"poseidon2: {msg}")


# -- the linear layers as the kernel computes them ---------------------------------

def ext_matrix(t: int) -> tuple:
    """The integer M_ext the kernel applies at width t: 2 on the diagonal
    and 1 elsewhere at t = 2, 3; M4 at t = 4; circ(2 M4, M4, ..., M4) at
    t = 8, 12, ...; None at other widths."""
    if t in (2, 3):
        return tuple(tuple(2 if i == j else 1 for j in range(t)) for i in range(t))
    if t < 4 or t % 4:
        return None
    return tuple(tuple(M4[i % 4][j % 4] * (2 if t > 4 and i // 4 == j // 4 else 1)
                       for j in range(t)) for i in range(t))


def _m4(x0, x1, x2, x3, add):
    dbl = lambda a: add(a, a)  # noqa: E731
    t0, t1 = add(x0, x1), add(x2, x3)
    t2, t3 = add(dbl(x1), t1), add(dbl(x3), t0)
    t4, t5 = add(dbl(dbl(t1)), t3), add(dbl(dbl(t0)), t2)
    return [add(t3, t5), t5, add(t2, t4), t4]


def ext_chain(s: list, add) -> list:
    """M_ext s (the t lanes s) by the kernel's add chain over `add` (a
    field's add, or ints mod p)."""
    t = len(s)
    if t <= 3:
        tot = s[0]
        for v in s[1:]:
            tot = add(tot, v)
        return [add(v, tot) for v in s]
    y = [v for q in range(t // 4) for v in _m4(*s[4 * q:4 * q + 4], add)]
    if t == 4:
        return y
    out = list(y)
    for k in range(4):
        col = y[k]
        for q in range(1, t // 4):
            col = add(col, y[4 * q + k])
        for q in range(t // 4):
            out[4 * q + k] = add(y[4 * q + k], col)
    return out


def int_chain(s: list, add, diag_mul) -> list:
    """M_int s = sum_j s_j + (d_i - 1) s_i by the kernel's chain: adds and a
    doubling at t = 2, 3 (SMALL_DIAG_M1), else diag_mul(i, s_i)."""
    t = len(s)
    tot = s[0]
    for v in s[1:]:
        tot = add(tot, v)
    if t in SMALL_DIAG_M1:
        return [add(tot, v if k == 1 else add(v, v)) for v, k in zip(s, SMALL_DIAG_M1[t])]
    return [add(tot, diag_mul(i, v)) for i, v in enumerate(s)]


def _lanes(f, s: torch.Tensor):
    d = -1 - len(f.limb_shape)
    return d, [s.select(d, j) for j in range(s.shape[d])]


def ext_layer(f, s: torch.Tensor) -> torch.Tensor:
    """M_ext of Montgomery-form states (..., t)+lim by `ext_chain` in plain
    torch: equal to the plain version's `Poseidon2._matmul_ext`."""
    d, lanes = _lanes(f, s)
    return torch.stack(ext_chain(lanes, f.add), d)


def int_layer(f, s: torch.Tensor, diag_m1: torch.Tensor) -> torch.Tensor:
    """M_int of Montgomery-form states (..., t)+lim by `int_chain` in plain
    torch (diag_m1 (t,)+lim in Montgomery form, read at t >= 4): equal to
    `Poseidon2._matmul_int`."""
    d, lanes = _lanes(f, s)
    return torch.stack(int_chain(lanes, f.add, lambda i, v: f.mul_mont(v, diag_m1[i])), d)


def check_linear_layers(t: int, mds, diag, modulus: int) -> None:
    """Raises API_NOT_IMPLEMENTED unless M_ext (`mds`, t x t canonical ints)
    is `ext_matrix(t)` and, at t = 2 and 3, d - 1 (`diag`, t canonical
    ints) is SMALL_DIAG_M1[t]: the structure the kernel's add chains
    implement."""
    want = ext_matrix(t)
    got = tuple(tuple(int(v) for v in row) for row in mds)
    if want is None or got != want:
        raise IcicleException(
            IcicleError.API_NOT_IMPLEMENTED,
            f"poseidon2: no CUDA kernel for an M_ext of {got} at t={t}: the kernel's add "
            f"chains implement {want}")
    dm1 = tuple((int(d) - 1) % modulus for d in diag)
    if t in SMALL_DIAG_M1 and dm1 != SMALL_DIAG_M1[t]:
        raise IcicleException(
            IcicleError.API_NOT_IMPLEMENTED,
            f"poseidon2: no CUDA kernel for diag - 1 = {dm1} at t={t}: the kernel adds in "
            f"{SMALL_DIAG_M1[t]}")


def field_linear_layers(field_name: str, t: int) -> tuple[list, list, int]:
    """(mds (t x t), diag (t), p) of a field's constant file as canonical
    ints (any of the files, goldilocks' too)."""
    from icicle_tpu_torch.ops.hash.poseidon2 import _load_constants
    data = _load_constants(field_name)
    ints = [sum(int(w) << (32 * i) for i, w in enumerate(row))
            for row in np.asarray(data[f"t{t}_mds"], dtype=np.uint64)]
    diag = [sum(int(w) << (32 * i) for i, w in enumerate(row))
            for row in np.asarray(data[f"t{t}_diag"], dtype=np.uint64)]
    return [ints[i * t:(i + 1) * t] for i in range(t)], diag, field_params(field_name).modulus


@functools.lru_cache(maxsize=None)
def _checked_structure(field_name: str, t: int) -> None:
    check_linear_layers(t, *field_linear_layers(field_name, t))


# -- the arithmetic -------------------------------------------------------------------

def mont_mul_model(a: int, b: int, p: int) -> int:
    """The single-word kernel's Montgomery multiply on Python ints, with its
    32-bit wraps: a b 2^-32 mod p for a < 2^32 and b < p."""
    pinv = pow(p, -1, 1 << 32)
    ab = a * b
    m = ((ab & MASK32) * pinv) & MASK32
    r = ((ab >> 32) - ((m * p) >> 32)) & MASK32
    return min(r, (r + p) & MASK32)


def _small(v: int, p: int) -> bool:
    return min(v % p, p - v % p) <= SMALL_INT


def needed_monts(h, n: int) -> int:
    """Montgomery multiplies one hash of n inputs needs (the bound's count):
    the S-boxes, the multiplies by constants of M_ext and M_int that are not
    small integers, and one conversion a word into and one out of
    Montgomery form, where the field has one (goldilocks has none; its
    multiplies are plain). babybear t = 2, n = 2: 12 * 2 * 4 + 24 * 4 + 3 =
    195."""
    t, sbox = h.t, SBOX_MONTS[h.alpha]
    mds, diag, p = field_linear_layers(h.field.name, t)
    ext = sum(not _small(v, p) for row in mds for v in row)
    int_ = sum(not _small(d - 1, p) for d in diag)
    perm = ((2 * h.half_full * t + h.partial_rounds) * sbox + (2 * h.half_full + 1) * ext
            + h.partial_rounds * int_)
    tagged = h.domain_tag is not None
    perms = 1 if n == t - tagged else max(1, -(-(n - 1 + tagged) // (t - 1)))
    return perms * perm + (0 if p == GOLDILOCKS_P else n + 1)


# -- the launch -----------------------------------------------------------------------

LIBRARY = {1: "poseidon2", 2: "poseidon2_gl64", 8: "poseidon2_limbs"}  # by limbs


@functools.lru_cache(maxsize=None)
def _kernel(nlimbs: int):
    """(hash entry, library) for single-word (1), goldilocks (2) or 8-limb
    (8) fields; the single-word library also has the constant upload."""
    lib = build.load(LIBRARY[nlimbs])
    if nlimbs == 1:
        fn = lib.icicle_poseidon2_hash
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_void_p])
        lib.icicle_poseidon2_upload.argtypes = ([ctypes.c_uint32] + [ctypes.c_int] * 4
                                                + [ctypes.c_void_p] * 2)
        lib.icicle_poseidon2_upload.restype = ctypes.c_int
    elif nlimbs == 2:
        fn = lib.icicle_poseidon2_gl64_hash
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
    else:
        fn = lib.icicle_poseidon2_limbs_hash
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    # ec_field.cuh, which the sources include, exports the error text
    lib.icicle_msm_error_string.argtypes = [ctypes.c_int]
    lib.icicle_msm_error_string.restype = ctypes.c_char_p
    return fn, lib


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


def _host_words(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.reshape(-1).numpy().view(np.uint32))


@functools.lru_cache(maxsize=None)
def _uploaded(field_name: str, t: int, device_index: int) -> None:
    """Writes a single-word instance's round constants and d - 1 into its
    __constant__ arrays on the device, once per (field, t, device)."""
    from icicle_tpu_torch.ops.hash.poseidon2 import Poseidon2
    _, lib = _kernel(1)
    h = Poseidon2(field_name, t)
    c = h.constants("cpu")
    rc, diag = _host_words(c.rc), _host_words(c.diag_m1)
    with torch.cuda.device(device_index):
        err = lib.icicle_poseidon2_upload(field_params(field_name).modulus, t, h.half_full,
                                          h.partial_rounds, h.alpha, rc.ctypes.data,
                                          diag.ctypes.data)
    if err != 0:
        raise IcicleException(IcicleError.UNKNOWN_ERROR, "poseidon2 constant upload failed: "
                              f"{lib.icicle_msm_error_string(err).decode()}")


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
    if nl == 1:
        fits = f.name in WORD_FIELDS
    elif nl == 2:
        fits = f.modulus == GOLDILOCKS_P
    else:
        fits = f.modulus.bit_length() <= MAX_BITS_8
    return fits and h.t in KERNEL_WIDTHS.get(nl, ())


def poseidon2(h, x: torch.Tensor) -> torch.Tensor:
    """(batch, n)+lim int32 canonical elements -> (batch,)+lim canonical
    digests of the Poseidon2 hasher h.

    On a CUDA tensor this launches the kernel on the current stream (no
    synchronisation), counts the launch in `poseidon2.launches` and raises
    if the field or width has no instantiation, its linear layers lack the
    kernel's structure, or the launch is refused. On a CPU tensor it
    computes `h.hash_fields_ref`."""
    _check(h, x)
    if not x.is_cuda:
        return h.hash_fields_ref(x)
    f = h.field
    if not supported_on_cuda(h):
        raise IcicleException(
            IcicleError.API_NOT_IMPLEMENTED,
            f"poseidon2: no CUDA kernel for {f.name} ({f.nlimbs} limbs) at t={h.t}: the "
            f"kernel is built for {', '.join(WORD_FIELDS)} (t in {KERNEL_WIDTHS[1]}), "
            f"goldilocks (t in {KERNEL_WIDTHS[2]}) and 8-limb fields below 2^{MAX_BITS_8} "
            f"(t in {KERNEL_WIDTHS[8]}); other limb counts wait for the limb-count template "
            "of ROADMAP.md queue A item 6")
    _checked_structure(f.name, h.t)
    batch, n = x.shape[:2]
    out = torch.empty((batch,) + f.limb_shape, dtype=torch.int32, device=x.device)
    if batch == 0:
        return out
    fn, lib = _kernel(f.nlimbs)
    tag = h.constants("cpu").tag
    tag_arr = None if tag is None else _host_words(tag)   # held through the call
    tag_words = None if tag_arr is None else tag_arr.ctypes.data
    consts = None if f.nlimbs == 2 else ctypes.addressof(field_consts(f.name))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if f.nlimbs == 1:
            _uploaded(f.name, h.t, x.device.index)
            err = fn(x.data_ptr(), out.data_ptr(), tag_words, batch, n, h.t, h.half_full,
                     h.partial_rounds, h.alpha, consts, stream)
        elif f.nlimbs == 2:
            c = h.constants(x.device)
            err = fn(x.data_ptr(), out.data_ptr(), c.rc.data_ptr(), c.diag_m1.data_ptr(),
                     tag_words, batch, n, h.t, h.half_full, h.partial_rounds, h.alpha, stream)
        else:
            c = h.constants(x.device)
            err = fn(x.data_ptr(), out.data_ptr(), c.rc.data_ptr(), c.diag_m1.data_ptr(),
                     tag_words, batch, n, h.t, h.half_full, h.partial_rounds, h.alpha, consts,
                     stream)
    if err != 0:
        raise IcicleException(IcicleError.UNKNOWN_ERROR, "poseidon2 launch failed: "
                              f"{lib.icicle_msm_error_string(err).decode()}")
    poseidon2.launches += 1
    return out


poseidon2.launches = 0
