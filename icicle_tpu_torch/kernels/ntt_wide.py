"""Four-step NTT over a hand-written CUDA DIF row kernel for elements wider
than one word (kernels/csrc/ntt_wide.cu): goldilocks, the 8-limb fields
below 2^255 and the 12-limb fields with two spare bits.

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

Instances (`instance`), each a struct of ntt_wide.cu:
  * "gl64", goldilocks, one uint64 an element, lazy 64-bit words between
    load and store (gl64.cuh); twiddles are plain values (the field has no
    Montgomery form). Rows up to 2^17 (`MAX_LOG_N`): NTTs up to 2^34,
    beyond goldilocks' 2^32 domain and beyond the card (at 2^32 the
    four-step's four arrays of 8-byte elements -- x, the pass A output, the
    inter-pass twiddles, out -- are 128 GiB).
  * "fp8", every 8-limb field below 2^255 (bn254_scalar, bls12_381_scalar,
    bls12_377_scalar, grumpkin_scalar, stark252, bn254_base; `MAX_BITS_8`),
    over ec_wide.cuh's carry chains with Montgomery twiddles (R = 2^256):
    canonical times Montgomery gives canonical, as `BigField.mul_mont`.
    Lazy in [0, 2p) where 4p < 2^256, canonical after every operation on
    bls12_381_scalar (the C entry picks by the modulus). Rows up to 2^14:
    NTTs up to 2^28, bn254_scalar's whole domain; at 2^29 the four arrays
    of 32-byte elements are 64 GiB and the inter-pass twiddles' plain
    construction (ops/ntt.py `twiddle_matrix`: a table of 2^29 powers and
    the int64 temporaries of its multiplies) needs more than the card's 80
    GB beside them.
  * "fp12", the 12-limb fields with 4p < 2^384 (bw6_761_scalar =
    bls12_377_base, bls12_381_base; `MAX_BITS_12`), lazy, in
    libntt_wide_l12. Rows up to 2^14: NTTs up to 2^28; at 2^29 the four
    arrays of 48-byte elements are 96 GiB, more than the card's 80 GB.
A CUDA tensor of another limb field raises API_NOT_IMPLEMENTED: of the
registered fields only the 24-limb bw6_761_base, whose domain ends at 2^1
(no NTT reaches the four-step).

The launch plan (`wide_plan`: TR, threads, cluster): a tile of TR rows
(TR elements fill a 32-byte sector of a column in the transposed layouts:
4 for gl64, 1 for the wider ones) is split over a thread-block cluster of
1, 2, 4 or 8 blocks, each holding 1/cluster of every row in its shared
memory; the cluster is the least whose blocks fit two an SM, or else the
least that fits one; rows too long for one block (above 2^12 at every
instance, gl64 at TR 4) always span one. The stage groups (`group_sizes`:
at most GROUP index bits a group, 3 for gl64, 2 for fp8 and fp12) are
planned here and passed to the C entry, which checks them against the
instance it was built for (its kMaxGroup, which GROUP equals), as it
checks the plan's shared memory (`smem_bytes`, its `row_words`) and
cluster rule (the first group holds the log2(cluster) stages that cross
blocks).

The stage table's w^0 entries (k = 0) are never read: both the kernel
and the plain version take them as one.
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

MAX_BITS_12 = 382  # the lazy instance keeps values below 2p: 4p < 2^384
ELEMENT_BYTES = {"gl64": 8, "fp8": 32, "fp12": 48}
KIND = {"gl64": 0, "fp8": 1, "fp12": 2}  # the C entry's instance argument
LIBRARY = {"gl64": "ntt_wide", "fp8": "ntt_wide", "fp12": "ntt_wide_l12"}
GROUP = {"gl64": 3, "fp8": 2, "fp12": 2}  # index bits a stage group, at most (= kMaxGroup)
CLUSTERS = (1, 2, 4, 8)  # blocks a cluster, up to the portable limit (ntt_wide.cu kMaxCluster)
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use (H100)
SECTOR = 32  # bytes: a tile's rows make whole sectors in the transposed layouts
MAX_THREADS = 256    # ntt_wide.cu kThreads


def instance(f: Field) -> str | None:
    """The kernel instance that serves f, or None."""
    if f.modulus == GOLDILOCKS_P:
        return "gl64"
    if f.limb_shape == (8,) and f.modulus.bit_length() <= MAX_BITS_8:
        return "fp8"
    if f.limb_shape == (12,) and f.modulus.bit_length() <= MAX_BITS_12:
        return "fp12"
    return None


def group_sizes(log_n: int, kind: str) -> list[int]:
    """Index bits of each stage group, top first, as the C entry takes
    them: the last takes the low min(log_n, GROUP) bits, the others the
    rest, evenly, larger first."""
    k = GROUP[kind]
    low = min(log_n, k)
    upper = -(-(log_n - low) // k)
    return [(log_n - low) // upper + (g < (log_n - low) % upper) for g in range(upper)] + [low]


def smem_bytes(log_n: int, tr: int, cluster: int, kind: str) -> int:
    """Shared memory of one block (ntt_wide.cu `row_words`): TR rows, each
    its element's 32-bit words in planes of the block's 2^log_n / cluster
    elements, padded by one word in 32, rows skewed by 32/TR words."""
    s = (1 << log_n) // cluster
    words = ELEMENT_BYTES[kind] // 4
    return 4 * tr * (words * (s + s // 32) + (32 // tr if tr > 1 else 0))


def _cluster_ok(log_n: int, cluster: int, kind: str) -> bool:
    """The C side's check: the first stage group holds the cross-slice
    stages (at least log2(cluster) bits) and leaves every block a chunk."""
    if cluster == 1:
        return True
    c = cluster.bit_length() - 1
    sizes = group_sizes(log_n, kind)
    return len(sizes) >= 2 and sizes[0] >= c and log_n - sizes[0] >= c


def _clusters(log_n: int, tr: int, kind: str) -> list[int]:
    return [c for c in CLUSTERS if _cluster_ok(log_n, c, kind)
            and smem_bytes(log_n, tr, c, kind) <= SMEM_LIMIT]


def _threads(log_n: int, tr: int, cluster: int, kind: str) -> int:
    """One thread a chunk of the last stage group in a block's share of the
    tile, from 32 to MAX_THREADS."""
    chunks = (tr << log_n) // cluster >> group_sizes(log_n, kind)[-1]
    return min(MAX_THREADS, max(32, chunks))


def wide_plan(rows: int, log_n: int, kind: str) -> tuple[int, int, int] | None:
    """(TR, threads, cluster) of a launch, or None where no plan fits. TR,
    the rows of a tile: the largest power of two that divides `rows` whose
    TR elements fill at most a 32-byte sector (4 for gl64, 1 for fp8 and
    fp12: the transposed layouts read and write runs of TR elements), and
    for which some cluster fits (else half as many). cluster: the least
    whose blocks fit two an SM (half of SMEM_LIMIT each), else the least
    that fits. threads: `_threads`."""
    eb = ELEMENT_BYTES[kind]
    tr = 1
    while 2 * tr * eb <= SECTOR and rows % (2 * tr) == 0:
        tr *= 2
    while tr >= 1:
        fits = _clusters(log_n, tr, kind)
        if fits:
            two = [c for c in fits if 2 * smem_bytes(log_n, tr, c, kind) <= SMEM_LIMIT]
            cluster = (two or fits)[0]
            return tr, _threads(log_n, tr, cluster, kind), cluster
        tr //= 2
    return None


# the largest log N a plan exists for (at TR = 1)
MAX_LOG_N = {k: max(n for n in range(1, 25) if wide_plan(1, n, k) is not None)
             for k in ELEMENT_BYTES}


def require_instance(f: Field, x: torch.Tensor, log_n: int | None = None) -> None:
    """Raises API_NOT_IMPLEMENTED for a CUDA tensor of a field that no
    instance serves, or with rows longer than the instance's 2^MAX_LOG_N
    (`log_n`, where given, is a four-step's: its longer pass has
    ceil(log_n / 2)); each limit lies beyond what the field's domain or the
    card's memory allows (module docstring)."""
    if not x.is_cuda:
        return
    kind = instance(f)
    if kind is None:
        raise IcicleException(
            IcicleError.API_NOT_IMPLEMENTED,
            f"ntt: no CUDA kernel for {f.name} ({f.nlimbs} limbs): dif_rows_wide is built for "
            f"goldilocks, 8-limb fields below 2^{MAX_BITS_8} and 12-limb fields below "
            f"2^{MAX_BITS_12}")
    if log_n is not None and log_n - log_n // 2 > MAX_LOG_N[kind]:
        raise IcicleException(
            IcicleError.API_NOT_IMPLEMENTED,
            f"ntt: {f.name} 2^{log_n} needs rows of 2^{log_n - log_n // 2}; dif_rows_wide's "
            f"{kind} rows reach 2^{MAX_LOG_N[kind]}, past what the field's domain or the "
            "card's memory allows")


def _invalid(msg: str) -> IcicleException:
    return IcicleException(IcicleError.INVALID_ARGUMENT, f"dif_rows_wide: {msg}")


def launch_plan(rows: int, log_n: int, kind: str,
                plan: tuple[int, int] | None = None) -> tuple[int, int, int]:
    """(TR, threads, cluster) of a launch: `wide_plan`'s, or for `plan` =
    (TR, cluster) that tile, checked as the C entry checks it (TR a power
    of two dividing `rows`, a cluster the stage groups allow, within the
    shared memory), with `_threads`."""
    if plan is None:
        return wide_plan(rows, log_n, kind)
    tr, cluster = plan
    if tr < 1 or tr & (tr - 1) or rows % tr or cluster not in _clusters(log_n, tr, kind):
        raise _invalid(f"plan (TR {tr}, cluster {cluster}) must have a power of two TR dividing "
                       f"{rows} rows and a cluster of {_clusters(log_n, tr, kind)} at TR {tr}, "
                       f"N 2^{log_n}")
    return tr, _threads(log_n, tr, cluster, kind), cluster


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
def _kernel(library: str):
    lib = build.load(library)
    fn = lib.icicle_ntt_dif_rows_wide
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_int8), ctypes.c_int] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    # ec_field.cuh, which the source includes, exports the error text
    lib.icicle_msm_error_string.argtypes = [ctypes.c_int]
    lib.icicle_msm_error_string.restype = ctypes.c_char_p
    return fn, lib.icicle_msm_error_string


def dif_rows_wide(f: Field, x: torch.Tensor, tw: torch.Tensor,
                  factor: torch.Tensor | None = None, *, transpose_in: bool = False,
                  transpose_out: bool = False,
                  _plan: tuple[int, int] | None = None) -> torch.Tensor:
    """All logN radix-2 DIF stages along each row, for goldilocks, an
    8-limb or a 12-limb field.

    x: (rows, N)+lim int32 canonical elements (not checked), or with
    `transpose_in` (N, rows)+lim, row r being the column x[:, r];
    tw: the (logN, N)+lim `_stage_twiddles` table for the direction (its
    w^0 entries, k = 0, are not read: they stand for one);
    factor: optional Montgomery-form multiplier in x's shape and layout,
    applied on load.
    Returns (rows, N)+lim with each row in bit-reversed order, or with
    `transpose_out` (N, rows)+lim holding each row's natural-order result as
    a column: out[bitrev(j), r] = dif_rows_wide(...)[r, j].

    On a CUDA tensor this launches the kernel on the current stream (no
    synchronisation) with `wide_plan`'s tile (`_plan`: another (TR,
    cluster), checked by `launch_plan`, for timing only), counts the launch
    in `dif_rows_wide.launches` and raises if the field has no instance, the
    library does not build or the launch is refused. On a CPU tensor it
    computes `dif_rows_wide_ref`."""
    rows, log_n = _check(f, x, tw, factor, transpose_in, transpose_out)
    kind = instance(f)
    if kind is not None:
        tr, threads, cluster = launch_plan(rows, log_n, kind, _plan)
    if not x.is_cuda:
        return dif_rows_wide_ref(f, x, tw, factor, transpose_in=transpose_in,
                                 transpose_out=transpose_out)
    require_instance(f, x)
    sizes = group_sizes(log_n, kind)
    fn, error_string = _kernel(LIBRARY[kind])
    n = 1 << log_n
    out = torch.empty(((n, rows) if transpose_out else (rows, n)) + f.limb_shape,
                      dtype=torch.int32, device=x.device)
    # fp8, fp12: ec_field.cuh's {p[L], one[L], inv32, b3} lead poseidon2_kernel's
    # array (kept referenced through the call); gl64's constants are compile-time
    host = None if kind == "gl64" else field_consts(f.name)
    consts = None if host is None else ctypes.addressof(host)
    with torch.cuda.device(x.device):
        err = fn(KIND[kind], x.data_ptr(), None if factor is None else factor.data_ptr(),
                 tw.data_ptr(), out.data_ptr(), rows, log_n, tr, threads, cluster,
                 (ctypes.c_int8 * len(sizes))(*sizes), len(sizes), int(transpose_in),
                 int(transpose_out), consts,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise IcicleException(IcicleError.UNKNOWN_ERROR,
                              f"dif_rows_wide launch failed ({kind}, rows {rows}, N 2^{log_n}, "
                              f"TR {tr}, cluster {cluster}): {error_string(err).decode()}")
    dif_rows_wide.launches += 1
    return out


dif_rows_wide.launches = 0


def dif_rows_wide_ref(f: Field, x: torch.Tensor, tw: torch.Tensor,
                      factor: torch.Tensor | None = None, *, transpose_in: bool = False,
                      transpose_out: bool = False) -> torch.Tensor:
    """`dif_rows_wide` in plain torch, stage by stage: `dif_rows_ref`
    (kernels/ntt_kernel.py) over a trailing limb axis, the butterflies whose
    twiddle is w^0 (k = 0) left unmultiplied, as the kernel leaves them."""
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
        d = f.sub(top, bot)
        y = f.mul_mont(d, w)
        y[:, :, 0] = d[:, :, 0]   # k = 0: times w^0 = one
        x = torch.stack([f.add(top, bot), y], dim=2).reshape((rows, n) + lim)
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
