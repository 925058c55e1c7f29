"""GLV scalar decomposition for the MSM, on the scalars' device (counterpart
of icicle_tpu/ops/msm_glv.py).

Splits each scalar k into (k1, k2) with k = k1 + lambda k2 (mod r) and
|ki| ~ sqrt(r), then emits signed window digits for the DOUBLED point set
[P_i, phi(P_i)] (phi(x, y) = (beta x, y) = lambda (x, y)); an MSM over those
digits equals the original MSM. Constants come from curves/glv.py.

The rounding is the JAX package's, to the bit:
  c_i = round(k g_i / 2^m),  g_i = floor(2^m |n_i| / r)   (host constants)
  k1  = k - c1 a1 - c2 a2,   k2 = -(c1 b1 + c2 b2)      (mod 2^_MOD_BITS)
with the signs of n_i folded into the basis. The JAX package computes it
over lists of 16-bit digits in uint32 lanes; here the same integers come
from (n, digits) int64 tensors of 16-bit digits: a product by a constant is
one multiply-add a digit of the constant into signed column sums, then one
carry pass (math/bigint.py `carry_resolve`). Every step is exact modular
arithmetic, so both give the same digits.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from icicle_tpu_torch.curves.glv import _lattice_basis, glv_constants
from icicle_tpu_torch.curves.params import get_curve
from icicle_tpu_torch.math.bigint import carry_resolve, widen
from icicle_tpu_torch.math.params import limbs_of
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

_M_BITS = 400          # scaled-reciprocal shift (multiple of 16)
_MOD_BITS = 160        # two's-complement working width for k1/k2
_D = 16                # digit bits
_MASK = (1 << _D) - 1


@functools.lru_cache(maxsize=None)
def glv_msm_constants(curve_name: str):
    """Host-derived constants for the device split; all integers."""
    curve = get_curve(curve_name)
    r = curve.fr.modulus
    (a1, b1), (a2, b2) = _lattice_basis(curve_name)
    # normalize so det == +r (glv.py guarantees |det| == r)
    det = a1 * b2 - a2 * b1
    assert abs(det) == r
    if det < 0:
        a2, b2 = -a2, -b2
    # c1 = round(b2*k/r), c2 = round(-b1*k/r)
    n1, n2 = b2, -b1
    g1 = (abs(n1) << _M_BITS) // r
    g2 = (abs(n2) << _M_BITS) // r
    # |k1| = |k - c1*a1 - c2*a2|; exact Babai gives <= (|a1|+|a2|)/2, the
    # floor-reciprocal c_i error is < 1 each, adding < |a1|+|a2|
    bound = ((abs(a1) + abs(a2)) * 3) // 2 + 2
    bound2 = ((abs(b1) + abs(b2)) * 3) // 2 + 2
    nbits_g = max(bound.bit_length(), bound2.bit_length()) + 1
    if nbits_g + 2 >= _MOD_BITS:
        # bw6_761: 190-bit halves; the JAX package asserts here too
        raise IcicleException(IcicleError.API_NOT_IMPLEMENTED,
                              f"glv: {curve_name}'s split halves ({nbits_g} bits) do not fit "
                              f"the {_MOD_BITS}-bit working width")
    beta, lam = glv_constants(curve_name)
    return dict(a1=a1, b1=b1, a2=a2, b2=b2, s1=1 if n1 >= 0 else -1,
                s2=1 if n2 >= 0 else -1, g1=g1, g2=g2, nbits_g=nbits_g,
                beta=beta, lam=lam, r=r)


def glv_split_bound(curve_name: str) -> int:
    """Bit width the split halves are guaranteed to fit (digit planning)."""
    return glv_msm_constants(curve_name)["nbits_g"]


def _times_const(digits: torch.Tensor, value: int) -> torch.Tensor:
    """(n, D) int64 16-bit digits times a Python int value >= 0 -> the
    product's column sums (n, D + Dv - 1), not carried (each < 2^37): one
    multiply-add a digit of the constant."""
    d, dv = digits.shape[-1], max(1, -(-value.bit_length() // _D))
    cols = digits.new_zeros((digits.shape[0], d + dv - 1))
    for j, v in enumerate(limbs_of(value, dv, _D)):
        if v:
            cols[:, j:j + d] += digits * v
    return cols


def _digits(cols: torch.Tensor, count: int) -> torch.Tensor:
    """Signed column sums -> `count` 16-bit digits of their value mod
    2^(16 count) (columns past `count` cannot reach them: dropped)."""
    cols = F.pad(cols, (0, max(0, count - cols.shape[-1])))[:, :count]
    return carry_resolve(cols, _D)[0]


def glv_split_t(curve_name: str, scalars_t: torch.Tensor):
    """(Ls, n) int32 canonical limb-major scalars -> (mag1, sg1, mag2, sg2):
    magX (Lg, n) int32 limb-major |kX| with Lg = _MOD_BITS / 32, sgX (n,)
    int32 in {+1, -1}; k == sg1 mag1 + lam sg2 mag2 (mod r)."""
    cst = glv_msm_constants(curve_name)
    s = widen(scalars_t).T                                      # (n, Ls)
    k16 = torch.stack([s & _MASK, s >> _D], dim=-1).reshape(s.shape[0], -1)
    nd = _MOD_BITS // _D
    md = _M_BITS // _D
    cs = []
    for g in (cst["g1"], cst["g2"]):
        prod = _digits(_times_const(k16, g), md + nd)
        # round(prod / 2^m): the digits from m up, +1 when bit m - 1 is set
        hi = prod[:, md:].clone()
        hi[:, 0] += prod[:, md - 1] >> (_D - 1)
        cs.append(_digits(hi, nd))
    halves = []
    # k1 = k - s1 c1 a1 - s2 c2 a2;  k2 = -(s1 c1 b1 + s2 c2 b2)  (mod 2^MOD_BITS)
    for base, coefs in ((k16[:, :nd], (cst["s1"] * cst["a1"], cst["s2"] * cst["a2"])),
                        (torch.zeros_like(k16[:, :1]), (cst["s1"] * cst["b1"],
                                                        cst["s2"] * cst["b2"]))):
        acc = F.pad(base, (0, nd - base.shape[-1]))
        for coef, c in zip(coefs, cs):
            term = _times_const(c, abs(coef))[:, :nd]
            acc = acc - term if coef >= 0 else acc + term
        v = _digits(acc, nd)
        neg = (v[:, -1] >> (_D - 1)) == 1                       # bit MOD_BITS - 1
        comp = _MASK - v
        comp[:, 0] += 1                                         # two's complement
        mag16 = torch.where(neg.unsqueeze(-1), _digits(comp, nd), v)
        mag32 = mag16[:, 0::2] | (mag16[:, 1::2] << _D)         # (n, Lg)
        sg = torch.where(neg, -1, 1).to(torch.int32)
        halves.append((mag32.T.to(torch.int32).contiguous(), sg))
    (m1, s1), (m2, s2) = halves
    return m1, s1, m2, s2


def glv_digits_t(curve_name: str, scalars_t: torch.Tensor, c: int) -> torch.Tensor:
    """(Ls, n) scalars -> (Wg, 2n) int32 signed digits for the interleaved
    [P_i, phi(P_i)] base layout (column 2i = k1_i, 2i+1 = k2_i)."""
    from icicle_tpu_torch.ops.msm import _signed_digits_t, signed_window_count

    m1, s1, m2, s2 = glv_split_t(curve_name, scalars_t)
    nbits_g = glv_split_bound(curve_name)
    d1 = _signed_digits_t(m1, c, nbits_g) * s1                 # (Wg, n)
    d2 = _signed_digits_t(m2, c, nbits_g) * s2
    wg_n = signed_window_count(nbits_g, c)
    n = scalars_t.shape[1]
    return torch.stack([d1, d2], dim=2).reshape(wg_n, 2 * n)
