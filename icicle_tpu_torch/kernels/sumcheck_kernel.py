"""One sumcheck round over a hand-written CUDA kernel (kernels/csrc/
sumcheck.cu over program.cuh, kernel K3 of the port).

`sumcheck_round(f, combine, deg, mles, alpha, fold)` is the JAX package's
`_round_pass` (icicle_tpu/ops/sumcheck.py:145): with `fold`, every MLE of
the stacked (npolys, n) mles is first folded by alpha over its stride-2
halves (e + alpha (o - e)); then the round polynomial's deg + 1 values
are sum_i combine(even_i + k (odd_i - even_i)) for k = 0..deg. It returns
(the values (deg + 1,), the folded mles, or mles itself without the
fold). On CUDA tensors of a single-word field that is one call of two
kernel launches (the round, then the reduction of the blocks' partial
sums), each counted in `sumcheck_round.launches`; on CPU tensors the plain
version `sumcheck_round_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icicle_tpu_torch.kernels import build
from icicle_tpu_torch.kernels import protocol_lib as L
from icicle_tpu_torch.kernels.program_kernel import make_code
from icicle_tpu_torch.ops import vec_ops

LIBRARY = "sumcheck"
MAX_POLYS = 8   # sumcheck.cu kMaxPolys (the reference's MAX_NOF_POLYNOMIALS)
MAX_DEG = 6     # kMaxDeg (MAX_COMBINE_POLY_DEG)


def sumcheck_round_ref(f, combine, deg: int, mles: torch.Tensor, alpha: int,
                       fold: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version, in torch on mles' device."""
    if fold:
        ev, od = mles[:, 0::2], mles[:, 1::2]
        alpha_t = f.from_ints([alpha], mles.device)[0]
        mles = f.add(ev, f.mul(f.sub(od, ev), alpha_t))
    even, odd = mles[:, 0::2], mles[:, 1::2]
    diff = f.sub(odd, even)
    vals = []
    inp = even
    for k in range(deg + 1):
        if k == 1:
            inp = odd
        elif k > 1:
            inp = f.add(inp, diff)
        out = combine.execute(f, [inp[i] for i in range(inp.shape[0])])[0]
        vals.append(vec_ops.vector_sum(f, out))
    return torch.stack(vals), mles


def route(f, combine, npolys: int, deg: int):
    """(kind, Code) of the kernel route for these MLEs and this combine, or
    the exception it raises before a launch: API_NOT_IMPLEMENTED for a
    field the kernel is not built for or a program past program.cuh's
    limits, INVALID_ARGUMENT past its MLE and degree limits."""
    L.require_word_field("sumcheck_round", f)
    if npolys > MAX_POLYS or not 1 <= deg <= MAX_DEG:
        raise L.invalid("sumcheck_round", f"{npolys} MLEs of degree {deg}: the kernel takes "
                        f"at most {MAX_POLYS} MLEs and degrees 1..{MAX_DEG}")
    kind, code, reads = make_code("sumcheck_round", f, combine)
    if reads and max(reads) >= npolys:
        raise L.invalid("sumcheck_round", f"the combine reads input {max(reads)} of {npolys} "
                        "MLEs")
    return kind, code


_ARGTYPES = ((ctypes.c_uint32,) + (ctypes.c_void_p,) * 4 + (ctypes.c_longlong,)
             + (ctypes.c_int,) * 4 + (ctypes.c_uint32,) + (ctypes.c_void_p,) * 2)


@functools.lru_cache(maxsize=None)
def _max_blocks() -> int:
    lib = build.load(LIBRARY)
    lib.icicle_sumcheck_max_blocks.restype = ctypes.c_int
    return lib.icicle_sumcheck_max_blocks()


def sumcheck_round(f, combine, deg: int, mles: torch.Tensor, alpha: int,
                   fold: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(round values (deg + 1,)+lim, the mles after the fold) of one round.

    On a CUDA tensor this launches the two kernels on the current stream
    (no synchronisation), counts them in `sumcheck_round.launches` and
    raises if the field or program has no kernel route or the launch is
    refused; on a CPU tensor it computes `sumcheck_round_ref`."""
    L.check_words("sumcheck_round", mles, 2 + len(f.limb_shape))
    npolys, n = mles.shape[:2]
    if n < (4 if fold else 2) or n & (n - 1):
        raise L.invalid("sumcheck_round", f"n must be a power of two >= {4 if fold else 2}, "
                        f"got {n}")
    if not mles.is_cuda:
        return sumcheck_round_ref(f, combine, deg, mles, alpha, fold)
    kind, code = route(f, combine, npolys, deg)
    if mles.data_ptr() % 16:
        mles = mles.clone()                      # the kernel's 16-byte loads
    pairs = n // (4 if fold else 2)
    folded = torch.empty((npolys, n // 2), dtype=torch.int32, device=mles.device) if fold \
        else mles
    partials = torch.empty(_max_blocks() * (deg + 1), dtype=torch.int32, device=mles.device)
    out = torch.empty(deg + 1, dtype=torch.int32, device=mles.device)
    fn, error_string = L.entry(LIBRARY, "icicle_sumcheck_round", _ARGTYPES)
    with torch.cuda.device(mles.device):
        err = fn(f.modulus, mles.data_ptr(), folded.data_ptr(), partials.data_ptr(),
                 out.data_ptr(), pairs, npolys, deg, kind, int(fold), L.mont_int(f, alpha),
                 ctypes.addressof(code), L.stream())
    L.raise_on("sumcheck_round", err, error_string)
    sumcheck_round.launches += 2  # round_kernel and finish_kernel
    return out, folded


sumcheck_round.launches = 0
