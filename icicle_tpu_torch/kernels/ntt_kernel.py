"""Four-step NTT over a hand-written CUDA DIF row kernel (counterpart of
icicle_tpu/pallas/ntt_kernel.py).

`dif_rows` runs all logN radix-2 DIF stages of every row of a (rows, N)
matrix in one kernel launch (kernels/csrc/ntt_dif.cu), with the row held in
shared memory. It stands in for both Pallas kernels of the JAX NTT path,
B1 `make_dif_kernel` and B2 `make_dif_kernel_mxu`, which compute one
function; B2's `pre_mul` is `factor` here. `dif_rows_ref` is the same
function in plain torch.

`ntt_four_step_cuda` (counterpart of `ntt_four_step_pallas`) does the
transposes, the bit-reversal row gathers and the n^-1 scale as torch ops, as
the JAX path does them as XLA ops outside its kernels. It always folds the
inter-pass twiddle matrix into the second pass's load (B2's pre_mul), where
the JAX path does so only when that pass uses B2.

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

MAX_LOG_N = 14  # one row in shared memory: 2^14 * 4 B = 64 KB


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


def _invalid(msg: str) -> IcicleException:
    return IcicleException(IcicleError.INVALID_ARGUMENT, f"dif_rows: {msg}")


def _check(f: Field, x, tw, factor) -> None:
    if f.modulus >= 1 << 31:
        raise _invalid(f"{f.name}: modulus must be below 2^31")
    tensors = [("x", x), ("tw", tw)] + ([("factor", factor)] if factor is not None else [])
    for name, t in tensors:
        if t.dtype != torch.int32:
            raise _invalid(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise _invalid(f"{name} must be contiguous")
        if t.device != x.device:
            raise _invalid(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 2:
        raise _invalid(f"x must be (rows, N), got {tuple(x.shape)}")
    rows, n = x.shape
    log_n = n.bit_length() - 1
    if n != 1 << log_n or not 1 <= log_n <= MAX_LOG_N:
        raise _invalid(f"N must be a power of two from 2 to 2^{MAX_LOG_N}, got {n}")
    if tuple(tw.shape) != (log_n, n):
        raise _invalid(f"tw must be ({log_n}, {n}), got {tuple(tw.shape)}")
    if factor is not None and factor.shape != x.shape:
        raise _invalid(f"factor must be {tuple(x.shape)}, got {tuple(factor.shape)}")


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("ntt")
    fn = lib.icicle_ntt_dif_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.icicle_cuda_error_string.argtypes = [ctypes.c_int]
    lib.icicle_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.icicle_cuda_error_string


def dif_rows(f: Field, x: torch.Tensor, tw: torch.Tensor,
             factor: torch.Tensor | None = None) -> torch.Tensor:
    """All logN radix-2 DIF stages along each row: (rows, N) natural order in,
    bit-reversed order out.

    x: (rows, N) int32, canonical values in [0, p) (not checked);
    tw: the (logN, N) `_stage_twiddles` table for the direction;
    factor: optional (rows, N) Montgomery-form multiplier applied on load.

    On a CUDA tensor this launches the kernel on the current stream (no
    synchronisation), counts the launch in `dif_rows.launches` and raises if
    the launch is refused. On a CPU tensor it computes `dif_rows_ref`."""
    _check(f, x, tw, factor)
    if not x.is_cuda:
        return dif_rows_ref(f, x, tw, factor)
    fn, error_string = _kernel()
    rows, n = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), None if factor is None else factor.data_ptr(),
                 tw.data_ptr(), out.data_ptr(), rows, n.bit_length() - 1,
                 f.modulus, f.params.inv32, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise IcicleException(IcicleError.UNKNOWN_ERROR,
                              f"dif_rows launch failed: {error_string(err).decode()}")
    dif_rows.launches += 1
    return out


dif_rows.launches = 0


def dif_rows_ref(f: Field, x: torch.Tensor, tw: torch.Tensor,
                 factor: torch.Tensor | None = None) -> torch.Tensor:
    """`dif_rows` in plain torch, stage by stage (the Pallas stage,
    icicle_tpu/pallas/ntt_kernel.py:97-106, as reshapes)."""
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
    return x


def ntt_four_step_cuda(f: Field, x: torch.Tensor, dir: NTTDir) -> torch.Tensor:
    """Four-step NTT with `dif_rows` passes (natural in/out, one vector).

    x: (n,) canonical int32; returns (n,) canonical int32 on x's device."""
    n = x.shape[0]
    logn = n.bit_length() - 1
    log_n1 = logn // 2
    log_n2 = logn - log_n1
    n1, n2 = 1 << log_n1, 1 << log_n2
    fwd = dir == NTTDir.FORWARD
    dev = x.device
    dom = get_domain(f, logn, dev)
    fs_tw = twiddle_matrix(f, n1, n2, dir, dev)
    twA = _stage_twiddles(f, log_n1, fwd, dev)
    twB = _stage_twiddles(f, log_n2, fwd, dev)
    rev1 = _bit_reverse_index(n1, dev)
    rev2 = _bit_reverse_index(n2, dev)

    # Transpose first, then gather whole rows: a gather through the
    # transposed view reads with a stride, and at 8192 x 8192 on an H100
    # (700 W) it took 2.2 ms against 0.55 + 0.19 ms for the two steps
    # (chip_smoke.py's profile).
    a = x.reshape(n1, n2).T.contiguous()                # (n2, n1): rows i2
    a = dif_rows(f, a, twA)                             # [i2, bitrev(k1)]
    a = a.T.contiguous().index_select(0, rev1)          # (n1, n2): [k1, i2]
    a = dif_rows(f, a, twB, factor=fs_tw)               # [k1, bitrev(k2)], twiddled on load
    a = a.T.contiguous().index_select(0, rev2)          # (n2, n1): [k2, k1]
    out = a.reshape(n)                                  # flat p = n1*k2 + k1: natural
    if not fwd:
        out = f.mul_mont(out, dom.n_inv_mont)
    return out
