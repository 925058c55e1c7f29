"""Four-step NTT over a hand-written CUDA DIF row kernel (counterpart of
icicle_tpu/pallas/ntt_kernel.py).

`dif_rows` runs all logN radix-2 DIF stages of every row of a matrix in one
kernel launch (kernels/csrc/ntt_dif.cu): stage groups in registers, TR rows
a tile, the groups exchanged through shared memory. It stands in for both
Pallas kernels of the JAX NTT path, B1 `make_dif_kernel` and B2
`make_dif_kernel_mxu`, which compute one function; B2's `pre_mul` is
`factor` here. Besides the Pallas layout ((rows, N) in, bit-reversed rows
out) it reads rows as columns (`transpose_in`) and writes the natural-order
result transposed (`transpose_out`). `dif_rows_ref` is the same function in
plain torch; `dif_plan` picks the kernel's tile and block.

`ntt_four_step_cuda` (counterpart of `ntt_four_step_pallas`) is two
`dif_rows` launches and nothing else: pass A reads the columns of the
(n1, n2) input and writes [k1, i2]; pass B multiplies in the inter-pass
twiddles on load (B2's pre_mul; for the inverse they carry n^-1 too) and
writes [k2, k1], which is the natural order. The JAX path does the
transposes, gathers and the n^-1 scale as XLA ops outside its kernels.

Single-limb Mont32 fields only (p < 2^31).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icicle_tpu_torch.fields.field import Field
from icicle_tpu_torch.kernels import build
from icicle_tpu_torch.ops.ntt import _bit_reverse_index, get_domain, twiddle_matrix
from icicle_tpu_torch.runtime.config import NTTDir
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

MAX_LOG_N = 14  # shared memory: the stage rows and one row of 2^14 words, 132 KB
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use (H100)
MAX_TR = 32  # rows a tile
MIN_RUN_TR = 4  # rows a tile may keep below FILL_TILES tiles
FILL_TILES = 264  # tiles that fill the card twice (132 SMs)
STORE_ROWS = 8  # rows a transposed store spans: 32-byte runs
MAX_THREADS = 512


@functools.lru_cache(maxsize=None)
def _stage_twiddles(f: Field, logN: int, forward: bool, device) -> torch.Tensor:
    """(S, N) per-stage DIF twiddle vectors in Montgomery form, int32 on
    `device`. Stage s (half-block m = N >> (s+1)): lane i holds
    w^((i & (m-1)) << s), gathered from the domain's power table."""
    dom = get_domain(f, logN, device)
    tw = dom.twiddles if forward else dom.twiddles_inv
    lane = torch.arange(1 << logN, dtype=torch.int64, device=tw.device)
    return torch.stack([tw[(lane & ((1 << (logN - 1 - s)) - 1)) << s]
                        for s in range(logN)])


def dif_smem_bytes(log_n: int, tr: int) -> int:
    """Shared memory of one block (ntt_dif.cu `smem_bytes`): the compact
    stage rows (N words) and a tile of TR rows, each padded by one word in
    32 and skewed by 32/TR words."""
    n = 1 << log_n
    return 4 * (n + tr * (n + n // 32 + (32 // tr if tr < 32 else 1)))


def dif_plan(rows: int, log_n: int, transpose_in: bool = False,
             transpose_out: bool = False) -> tuple[int, int, int]:
    """(TR, threads, cluster) of a `dif_rows` launch. TR, the rows a block's
    tile: the largest power of two that divides `rows`, up to MAX_TR, whose
    block fits a third of SMEM_LIMIT (three blocks an SM: one loads while
    the others compute); in a transposed layout, up to STORE_ROWS rows
    within SMEM_LIMIT instead (runs of TR words in column reads, fewer
    blocks a transposed store); and that leaves FILL_TILES tiles, or
    MIN_RUN_TR rows where fewer tiles would follow. threads: one per 16
    elements of a tile, from 32 to MAX_THREADS. cluster: the blocks whose
    tiles make up one transposed store, until they hold STORE_ROWS rows
    (32-byte runs) where `rows` allows; 1 without `transpose_out`."""
    transposed = transpose_in or transpose_out
    smem_cap, tr_cap = (SMEM_LIMIT, STORE_ROWS) if transposed else (SMEM_LIMIT // 3, MAX_TR)
    tr = 1
    while True:
        t = 2 * tr
        if (t > tr_cap or rows % t or dif_smem_bytes(log_n, t) > smem_cap
                or (rows // t < FILL_TILES and t > MIN_RUN_TR)):
            break
        tr = t
    return tr, _block_threads(log_n, tr), _cluster(rows, log_n, tr, transpose_out)


def _block_threads(log_n: int, tr: int) -> int:
    return min(MAX_THREADS, max(32, (tr << log_n) // 16))


def _cluster(rows: int, log_n: int, tr: int, transpose_out: bool) -> int:
    c = 1
    while (transpose_out and tr * c < STORE_ROWS and rows % (2 * tr * c) == 0
           and 2 * c <= 1 << log_n):
        c *= 2
    return c


def _invalid(msg: str) -> IcicleException:
    return IcicleException(IcicleError.INVALID_ARGUMENT, f"dif_rows: {msg}")


def _check(f: Field, x, tw, factor, transpose_in, transpose_out) -> tuple[int, int]:
    """Validates a call; returns (rows, log_n)."""
    if f.modulus >= 1 << 31:
        raise _invalid(f"{f.name}: modulus must be below 2^31")
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
    if x.dim() != 2:
        raise _invalid(f"x must be {'(N, rows)' if transpose_in else '(rows, N)'}, "
                       f"got {tuple(x.shape)}")
    n, rows = x.shape if transpose_in else x.shape[::-1]
    log_n = n.bit_length() - 1
    if n != 1 << log_n or not 1 <= log_n <= MAX_LOG_N:
        raise _invalid(f"N must be a power of two from 2 to 2^{MAX_LOG_N}, got {n}")
    if rows < 1:
        raise _invalid("x has no rows")
    if tuple(tw.shape) != (log_n, n):
        raise _invalid(f"tw must be ({log_n}, {n}), got {tuple(tw.shape)}")
    if factor is not None and factor.shape != x.shape:
        raise _invalid(f"factor must be {tuple(x.shape)}, got {tuple(factor.shape)}")
    return rows, log_n


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("ntt")
    fn = lib.icicle_ntt_dif_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.icicle_cuda_error_string.argtypes = [ctypes.c_int]
    lib.icicle_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.icicle_cuda_error_string


def dif_rows(f: Field, x: torch.Tensor, tw: torch.Tensor,
             factor: torch.Tensor | None = None, *, transpose_in: bool = False,
             transpose_out: bool = False, _tr: int | None = None) -> torch.Tensor:
    """All logN radix-2 DIF stages along each row.

    x: (rows, N) int32, canonical values in [0, p) (not checked), or with
    `transpose_in` (N, rows), row r being the column x[:, r];
    tw: the (logN, N) `_stage_twiddles` table for the direction;
    factor: optional Montgomery-form multiplier in x's shape and layout,
    applied on load.
    Returns (rows, N) with each row in bit-reversed order, or with
    `transpose_out` (N, rows) holding each row's natural-order result as a
    column: out[bitrev(j), r] = dif_rows(...)[r, j].

    On a CUDA tensor this launches the kernel on the current stream (no
    synchronisation) with `dif_plan`'s tile (`_tr` overrides its TR, for
    timing), counts the launch in `dif_rows.launches` and raises if the
    launch is refused. On a CPU tensor it computes `dif_rows_ref`."""
    rows, log_n = _check(f, x, tw, factor, transpose_in, transpose_out)
    tr, threads, cluster = dif_plan(rows, log_n, transpose_in, transpose_out)
    if _tr is not None:
        if _tr < 1 or _tr & (_tr - 1) or rows % _tr or dif_smem_bytes(log_n, _tr) > SMEM_LIMIT:
            raise _invalid(f"TR {_tr} must be a power of two dividing {rows} rows within "
                           f"{SMEM_LIMIT} bytes of shared memory")
        tr, threads = _tr, _block_threads(log_n, _tr)
        cluster = _cluster(rows, log_n, _tr, transpose_out)
    if not x.is_cuda:
        return dif_rows_ref(f, x, tw, factor, transpose_in=transpose_in,
                            transpose_out=transpose_out)
    fn, error_string = _kernel()
    n = 1 << log_n
    out = torch.empty((n, rows) if transpose_out else (rows, n), dtype=torch.int32,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), None if factor is None else factor.data_ptr(),
                 tw.data_ptr(), out.data_ptr(), rows, log_n, f.modulus, f.params.inv32,
                 tr, threads, cluster, int(transpose_in), int(transpose_out),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise IcicleException(IcicleError.UNKNOWN_ERROR,
                              f"dif_rows launch failed: {error_string(err).decode()}")
    dif_rows.launches += 1
    return out


dif_rows.launches = 0


def dif_rows_ref(f: Field, x: torch.Tensor, tw: torch.Tensor,
                 factor: torch.Tensor | None = None, *, transpose_in: bool = False,
                 transpose_out: bool = False) -> torch.Tensor:
    """`dif_rows` in plain torch, stage by stage (the Pallas stage,
    icicle_tpu/pallas/ntt_kernel.py:97-106, as reshapes); the layouts are a
    transpose before and a transpose and row gather after."""
    if transpose_in:
        x = x.T
        factor = None if factor is None else factor.T
    if factor is not None:
        x = f.mul_mont(x, factor)
    rows, n = x.shape
    for s in range(n.bit_length() - 1):
        m = n >> (s + 1)
        xr = x.reshape(rows, n // (2 * m), 2, m)
        top, bot = xr[:, :, 0], xr[:, :, 1]
        w = tw[s].reshape(n // (2 * m), 2, m)[:, 1]  # the bottom lanes' twiddles
        x = torch.stack([f.add(top, bot), f.mul_mont(f.sub(top, bot), w)],
                        dim=2).reshape(rows, n)
    if transpose_out:
        x = x.T.index_select(0, _bit_reverse_index(n, x.device))
    return x.contiguous()


def ntt_four_step_cuda(f: Field, x: torch.Tensor, dir: NTTDir) -> torch.Tensor:
    """Four-step NTT with two `dif_rows` passes (natural in/out, one vector).

    x: (n,) canonical int32; returns (n,) canonical int32 on x's device.
    n = n1 * n2 with n1 = 2^floor(logn/2); x.view(n1, n2)[i1, i2] = x[n2*i1 + i2]."""
    n = x.shape[0]
    logn = n.bit_length() - 1
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
    a = dif_rows(f, x.contiguous().view(n1, n2), twA, transpose_in=True, transpose_out=True)
    # pass B: the n2-point transform of each row k1 of a * fs_tw, written as
    # [k2, k1]: flat index n1*k2 + k1, the natural order
    return dif_rows(f, a, twB, factor=fs_tw, transpose_out=True).view(n)
