"""Four-step NTT over a hand-written CUDA DIF row kernel for elements wider
than one word (kernels/csrc/ntt_wide.cu): goldilocks and the 8-limb fields
below 2^255.

`dif_rows_wide` is `dif_rows`' function (kernels/ntt_kernel.py) for
elements with a trailing limb axis: all logN radix-2 DIF stages of every
row of a matrix in one launch, natural order in and bit-reversed order
out, with the same layouts (`transpose_in`: rows read as columns;
`transpose_out`: the natural-order result written transposed) and
`factor` (a Montgomery-form multiplier applied on load).
`dif_rows_wide_ref` is the same function in plain torch.
`ntt_four_step_wide` mirrors `ntt_four_step_cuda`: two launches and no
glue, the inverse's n^-1 folded into pass B's factor.

No Pallas kernel is replaced: the JAX package computes the NTT of a limb
field as XLA (`_ntt_xla` -> `_ntt_four_step` / `_ntt_vecfirst`,
icicle_tpu/ops/ntt.py:223-329), since `_ntt_pallas` takes single-word
fields only (ntt.py:342-344).

Instances (`instance`): "gl64", goldilocks, one uint64 an element, whose
twiddles are plain values (the field has no Montgomery form); "fp8", every
8-limb field below 2^255 (bn254_scalar, bls12_381_scalar,
bls12_377_scalar, grumpkin_scalar, stark252; `MAX_BITS_8`, the rule of
kernels/poseidon2_kernel.py), with Montgomery twiddles (R = 2^256):
canonical times Montgomery gives canonical, as `BigField.mul_mont`. A
CUDA tensor of another field (the 12-limb bw6_761_scalar and
bls12_377_base) raises API_NOT_IMPLEMENTED. A row lies whole in one
block's shared memory, so N is at most 2^14 for gl64 and 2^12 for fp8
(`MAX_LOG_N`): NTTs up to 2^28 and 2^24.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icicle_tpu_torch.fields.field import Field
from icicle_tpu_torch.kernels import build
from icicle_tpu_torch.kernels.ntt_kernel import _stage_twiddles
from icicle_tpu_torch.kernels.poseidon2_kernel import MAX_BITS_8, field_consts
from icicle_tpu_torch.math.gl64 import GOLDILOCKS_P
from icicle_tpu_torch.ops.ntt import _bit_reverse_index, twiddle_matrix
from icicle_tpu_torch.runtime.config import NTTDir
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

ELEMENT_BYTES = {"gl64": 8, "fp8": 32}
KIND = {"gl64": 0, "fp8": 1}  # the C entry's instance argument
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use (H100)
# a row lies whole in shared memory: the largest log N whose row fits
MAX_LOG_N = {k: (SMEM_LIMIT // b).bit_length() - 1 for k, b in ELEMENT_BYTES.items()}
SECTOR = 32  # bytes: a tile's rows make whole sectors in the transposed layouts
MAX_THREADS = 256


def instance(f: Field) -> str | None:
    """The kernel instance that serves f, or None."""
    if f.modulus == GOLDILOCKS_P:
        return "gl64"
    if f.limb_shape == (8,) and f.modulus.bit_length() <= MAX_BITS_8:
        return "fp8"
    return None


def require_instance(f: Field, x: torch.Tensor, log_n: int | None = None) -> None:
    """Raises API_NOT_IMPLEMENTED for a CUDA tensor of a field that no
    instance serves, or with rows longer than the instance's 2^MAX_LOG_N
    (`log_n`, where given, is a four-step's: its longer pass has
    ceil(log_n / 2))."""
    if not x.is_cuda:
        return
    kind = instance(f)
    if kind is None:
        raise IcicleException(
            IcicleError.API_NOT_IMPLEMENTED,
            f"ntt: no CUDA kernel for {f.name} ({f.nlimbs} limbs): dif_rows_wide is built for "
            f"goldilocks and 8-limb fields below 2^{MAX_BITS_8}; other limb counts wait for "
            "the limb-count template of ROADMAP.md queue A item 6")
    if log_n is not None and log_n - log_n // 2 > MAX_LOG_N[kind]:
        raise IcicleException(
            IcicleError.API_NOT_IMPLEMENTED,
            f"ntt: {f.name} 2^{log_n} needs rows of 2^{log_n - log_n // 2}; dif_rows_wide "
            f"keeps a row in shared memory, at most 2^{MAX_LOG_N[kind]} elements "
            "(ROADMAP.md queue B, the dif_rows_wide redesign)")


def wide_plan(rows: int, log_n: int, kind: str) -> tuple[int, int]:
    """(TR, threads) of a launch. TR, the rows of a block's tile: the largest
    power of two that divides `rows`, whose TR elements fill at most a
    32-byte sector (4 for gl64, 1 for fp8: the transposed layouts read and
    write runs of TR elements) and whose tile fits SMEM_LIMIT. threads: one
    a butterfly of a stage, from 32 to MAX_THREADS."""
    eb = ELEMENT_BYTES[kind]
    tr = 1
    while (2 * tr * eb <= SECTOR and rows % (2 * tr) == 0
           and (2 * tr << log_n) * eb <= SMEM_LIMIT):
        tr *= 2
    return tr, min(MAX_THREADS, max(32, (tr << log_n) // 2))


def _invalid(msg: str) -> IcicleException:
    return IcicleException(IcicleError.INVALID_ARGUMENT, f"dif_rows_wide: {msg}")


def _check(f: Field, x, tw, factor, transpose_in, transpose_out) -> tuple[int, int]:
    """Validates a call; returns (rows, log_n)."""
    lim = f.limb_shape
    if lim == ():
        raise _invalid(f"{f.name} is a single-word field: use dif_rows")
    for name, flag in (("transpose_in", transpose_in), ("transpose_out", transpose_out)):
        if not isinstance(flag, bool):
            raise _invalid(f"{name} must be a bool, got {flag!r}")
    tensors = [("x", x), ("tw", tw)] + ([("factor", factor)] if factor is not None else [])
    for name, t in tensors:
        if t.dtype != torch.int32:
            raise _invalid(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise _invalid(f"{name} must be contiguous")
        if t.device != x.device:
            raise _invalid(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 2 + len(lim) or tuple(x.shape[2:]) != lim:
        want = "(N, rows)" if transpose_in else "(rows, N)"
        raise _invalid(f"x must be {want}+{lim}, got {tuple(x.shape)}")
    n, rows = x.shape[:2] if transpose_in else x.shape[1::-1]
    log_n = n.bit_length() - 1
    kind = instance(f)
    max_log_n = MAX_LOG_N[kind] if kind else max(MAX_LOG_N.values())
    if n != 1 << log_n or not 1 <= log_n <= max_log_n:
        raise _invalid(f"N must be a power of two from 2 to 2^{max_log_n}, got {n}")
    if rows < 1:
        raise _invalid("x has no rows")
    if tuple(tw.shape) != (log_n, n) + lim:
        raise _invalid(f"tw must be {(log_n, n) + lim}, got {tuple(tw.shape)}")
    if factor is not None and factor.shape != x.shape:
        raise _invalid(f"factor must be {tuple(x.shape)}, got {tuple(factor.shape)}")
    return rows, log_n


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("ntt_wide")
    fn = lib.icicle_ntt_dif_rows_wide
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    # ec_field.cuh, which the source includes, exports the error text
    lib.icicle_msm_error_string.argtypes = [ctypes.c_int]
    lib.icicle_msm_error_string.restype = ctypes.c_char_p
    return fn, lib.icicle_msm_error_string


def dif_rows_wide(f: Field, x: torch.Tensor, tw: torch.Tensor,
                  factor: torch.Tensor | None = None, *, transpose_in: bool = False,
                  transpose_out: bool = False) -> torch.Tensor:
    """All logN radix-2 DIF stages along each row, for goldilocks or an
    8-limb field.

    x: (rows, N)+lim int32 canonical elements (not checked), or with
    `transpose_in` (N, rows)+lim, row r being the column x[:, r];
    tw: the (logN, N)+lim `_stage_twiddles` table for the direction;
    factor: optional Montgomery-form multiplier in x's shape and layout,
    applied on load.
    Returns (rows, N)+lim with each row in bit-reversed order, or with
    `transpose_out` (N, rows)+lim holding each row's natural-order result as
    a column: out[bitrev(j), r] = dif_rows_wide(...)[r, j].

    On a CUDA tensor this launches the kernel on the current stream (no
    synchronisation) with `wide_plan`'s tile, counts the launch in
    `dif_rows_wide.launches` and raises if the field has no instance or the
    launch is refused. On a CPU tensor it computes `dif_rows_wide_ref`."""
    rows, log_n = _check(f, x, tw, factor, transpose_in, transpose_out)
    if not x.is_cuda:
        return dif_rows_wide_ref(f, x, tw, factor, transpose_in=transpose_in,
                                 transpose_out=transpose_out)
    require_instance(f, x)
    kind = instance(f)
    tr, threads = wide_plan(rows, log_n, kind)
    fn, error_string = _kernel()
    n = 1 << log_n
    out = torch.empty(((n, rows) if transpose_out else (rows, n)) + f.limb_shape,
                      dtype=torch.int32, device=x.device)
    # fp8: ec_field.cuh's {p[8], one[8], inv32, b3} lead poseidon2_kernel's
    # array; gl64's constants are compile-time
    consts = None if kind == "gl64" else ctypes.addressof(field_consts(f.name))
    with torch.cuda.device(x.device):
        err = fn(KIND[kind], x.data_ptr(), None if factor is None else factor.data_ptr(),
                 tw.data_ptr(), out.data_ptr(), rows, log_n, tr, threads, int(transpose_in),
                 int(transpose_out), consts, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise IcicleException(IcicleError.UNKNOWN_ERROR,
                              f"dif_rows_wide launch failed: {error_string(err).decode()}")
    dif_rows_wide.launches += 1
    return out


dif_rows_wide.launches = 0


def dif_rows_wide_ref(f: Field, x: torch.Tensor, tw: torch.Tensor,
                      factor: torch.Tensor | None = None, *, transpose_in: bool = False,
                      transpose_out: bool = False) -> torch.Tensor:
    """`dif_rows_wide` in plain torch, stage by stage: `dif_rows_ref`
    (kernels/ntt_kernel.py) over a trailing limb axis."""
    lim = f.limb_shape
    if transpose_in:
        x = x.transpose(0, 1)
        factor = None if factor is None else factor.transpose(0, 1)
    if factor is not None:
        x = f.mul_mont(x, factor)
    rows, n = x.shape[:2]
    for s in range(n.bit_length() - 1):
        m = n >> (s + 1)
        xr = x.reshape((rows, n // (2 * m), 2, m) + lim)
        top, bot = xr[:, :, 0], xr[:, :, 1]
        w = tw[s].reshape((n // (2 * m), 2, m) + lim)[:, 1]  # the bottom lanes' twiddles
        x = torch.stack([f.add(top, bot), f.mul_mont(f.sub(top, bot), w)],
                        dim=2).reshape((rows, n) + lim)
    if transpose_out:
        x = x.transpose(0, 1).index_select(0, _bit_reverse_index(n, x.device))
    return x.contiguous()


def ntt_four_step_wide(f: Field, x: torch.Tensor, dir: NTTDir) -> torch.Tensor:
    """Four-step NTT with two `dif_rows_wide` passes (natural in and out, one
    vector). x: (n,)+lim canonical; returns (n,)+lim on x's device. n = n1 n2
    with n1 = 2^floor(logn/2); x.view(n1, n2)[i1, i2] = x[n2 i1 + i2]."""
    lim = f.limb_shape
    n = x.shape[0]
    logn = n.bit_length() - 1
    require_instance(f, x, logn)
    log_n1 = logn // 2
    log_n2 = logn - log_n1
    n1, n2 = 1 << log_n1, 1 << log_n2
    fwd = dir == NTTDir.FORWARD
    dev = x.device
    # w^(k1*i2), times n^-1 for the inverse: the 1/n scale costs no pass
    fs_tw = twiddle_matrix(f, n1, n2, dir, dev, scale_n_inv=not fwd)
    twA = _stage_twiddles(f, log_n1, fwd, dev)
    twB = _stage_twiddles(f, log_n2, fwd, dev)
    # pass A: the n1-point transform of each column i2, written as [k1, i2]
    a = dif_rows_wide(f, x.contiguous().view((n1, n2) + lim), twA, transpose_in=True,
                      transpose_out=True)
    # pass B: the n2-point transform of each row k1 of a * fs_tw, written as
    # [k2, k1]: flat index n1*k2 + k1, the natural order
    return dif_rows_wide(f, a, twB, factor=fs_tw, transpose_out=True).view((n,) + lim)
