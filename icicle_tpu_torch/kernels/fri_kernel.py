"""One FRI fold over a hand-written CUDA kernel (kernels/csrc/fri_fold.cu,
kernel K2 of the port).

`fri_fold(f, evals, alpha, inv_tw, stride)` is the JAX package's
`_fold_kernel` (icicle_tpu/ops/fri.py:275):
  out[i] = (e[i] + e[i+h]) / 2 + alpha (e[i] - e[i+h]) / 2 w^-i,
h = n / 2, with w^-i read from `inv_tw`, the inverse-twiddle table of the
first round's domain (ops/ntt.py `ntt_init_domain(f, log n0)`, w0^-j in
Montgomery form), at j = i stride, stride = 2^r in round r: w_r =
omega(log n0 - r) = w0^(2^r) because omega(k)^2 = omega(k - 1) for the
fields' root tables. On a CUDA tensor of babybear or koalabear one launch;
on a CPU tensor the plain version `fri_fold_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from icicle_tpu_torch.kernels import protocol_lib as L

LIBRARY = "fri_fold"


def fri_fold_ref(f, evals: torch.Tensor, alpha: int, inv_tw: torch.Tensor,
                 stride: int) -> torch.Tensor:
    """The plain version, in torch on evals' device."""
    h = evals.shape[0] // 2
    lo, hi = evals[:h], evals[h:]
    inv2 = f.from_ints([pow(2, -1, f.modulus)], evals.device)[0]
    even = f.mul(f.add(lo, hi), inv2)
    odd = f.mul_mont(f.mul(f.sub(lo, hi), inv2), inv_tw[::stride][:h])
    return f.add(even, f.mul(odd, f.from_ints([alpha], evals.device)[0]))


_ARGTYPES = ((ctypes.c_uint32,) + (ctypes.c_void_p,) * 3 + (ctypes.c_longlong,) * 2
             + (ctypes.c_uint32, ctypes.c_void_p))


def route(f) -> None:
    """Raises API_NOT_IMPLEMENTED, before a launch, for a field the kernel
    is not built for (it serves babybear and koalabear)."""
    L.require_word_field("fri_fold", f, L.TWO_ADIC_FIELDS)


def fri_fold(f, evals: torch.Tensor, alpha: int, inv_tw: torch.Tensor,
             stride: int) -> torch.Tensor:
    """(n,)+lim canonical evaluations -> (n / 2,)+lim folded by alpha;
    inv_tw may be a strided view.

    On a CUDA tensor this launches the kernel on the current stream (no
    synchronisation), counts the launch in `fri_fold.launches` and raises
    if the field has no instantiation or the launch is refused; on a CPU
    tensor it computes `fri_fold_ref`."""
    nd = 1 + len(f.limb_shape)
    L.check_words("fri_fold", evals, nd)
    if inv_tw.dim() != nd or inv_tw.dtype != torch.int32:
        raise L.invalid("fri_fold", f"the twiddle table must be int32 of {nd} dimensions")
    n = evals.shape[0]
    h = n // 2
    if n < 2 or n & (n - 1):
        raise L.invalid("fri_fold", f"n must be a power of two >= 2, got {n}")
    if stride < 1 or (h - 1) * stride >= inv_tw.shape[0] or inv_tw.device != evals.device:
        raise L.invalid("fri_fold", f"a twiddle table of {inv_tw.shape[0]} on {inv_tw.device} "
                        f"at stride {stride} does not cover {h} outputs on {evals.device}")
    if not evals.is_cuda:
        return fri_fold_ref(f, evals, alpha, inv_tw, stride)
    route(f)
    out = torch.empty(h, dtype=torch.int32, device=evals.device)
    fn, error_string = L.entry(LIBRARY, "icicle_fri_fold", _ARGTYPES)
    with torch.cuda.device(evals.device):
        # a table subsampled from a larger domain's (ops/ntt.py get_domain) is
        # a strided view: the kernel reads it at its element stride
        err = fn(f.modulus, evals.data_ptr(), inv_tw.data_ptr(), out.data_ptr(), h,
                 stride * inv_tw.stride(0), L.mont_int(f, alpha), L.stream())
    L.raise_on("fri_fold", err, error_string)
    fri_fold.launches += 1
    return out


fri_fold.launches = 0
