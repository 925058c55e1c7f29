"""GLV endomorphism acceleration for curves with j-invariant 0 (counterpart
of icicle_tpu/curves/glv.py; the port keeps its own copy).

Every curve in the reference's matrix with a=0, b!=0 (bn254, bls12-377/381,
grumpkin, bw6-761 — all of them) carries the cube-root endomorphism
phi(x, y) = (beta*x, y) with phi(P) = lambda*P, where beta^3 = 1 in Fq and
lambda^3 = 1 in Fr. A scalar k then splits as k = k1 + k2*lambda with
|k1|, |k2| ~ sqrt(r), halving the doubling chain of a scalar ladder.

The reference does not ship GLV (its scalar ladders live in the closed CUDA
backend). Here it feeds the MSM's GLV split (ops/msm_glv.py) and, as in the
JAX package, the ECNTT's twiddle ladders (ops/ecntt.py `_glv_rows`,
`_stage_glv`).

Constants are DERIVED at first use (no pasted tables): beta/lambda are
g^((q-1)/3) roots matched against the curve generator via the host EC oracle,
and the short lattice basis comes from the classic extended-Euclid truncation
(GLV'01, Algorithm in section 4).
"""

from __future__ import annotations

import functools

from icicle_tpu_torch.curves.host_ec import ec_mul
from icicle_tpu_torch.curves.params import get_curve


def _cube_roots_of_unity(p: int) -> list[int]:
    """Both primitive cube roots of 1 mod p (p == 1 mod 3)."""
    assert p % 3 == 1
    g = 2
    while True:
        w = pow(g, (p - 1) // 3, p)
        if w != 1:
            break
        g += 1
    return [w, w * w % p]


@functools.lru_cache(maxsize=None)
def glv_constants(curve_name: str) -> tuple[int, int]:
    """(beta, lam) with (beta*x, y) == lam * (x, y) for points of order r."""
    curve = get_curve(curve_name)
    q, r = curve.fq.modulus, curve.fr.modulus
    gen = (curve.gen_x, curve.gen_y)
    for lam in _cube_roots_of_unity(r):
        want = ec_mul(gen, lam, q)
        for beta in _cube_roots_of_unity(q):
            if (gen[0] * beta % q, gen[1]) == want:
                return beta, lam
    raise AssertionError(f"no matching (beta, lambda) for {curve_name}")


@functools.lru_cache(maxsize=None)
def _lattice_basis(curve_name: str) -> tuple[tuple[int, int], tuple[int, int]]:
    """Short vectors (a1, b1), (a2, b2) of the lattice {(a, b): a + b*lam == 0
    mod r} via the GLV extended-Euclid truncation."""
    curve = get_curve(curve_name)
    r = curve.fr.modulus
    _, lam = glv_constants(curve_name)
    # remainders s_i*r + t_i*lam = r_i; stop at the first r_i < sqrt(r)
    rs = [r, lam]
    ts = [0, 1]
    while rs[-1] * rs[-1] >= r:
        qout = rs[-2] // rs[-1]
        rs.append(rs[-2] - qout * rs[-1])
        ts.append(ts[-2] - qout * ts[-1])
    l = len(rs) - 1
    a1, b1 = rs[l], -ts[l]
    # candidates for the second vector: (r_{l-1}, -t_{l-1}) or (r_{l+1}, ...)
    qout = rs[l - 1] // rs[l]
    r_next = rs[l - 1] - qout * rs[l]
    t_next = ts[l - 1] - qout * ts[l]
    c1 = (rs[l - 1], -ts[l - 1])
    c2 = (r_next, -t_next)
    a2, b2 = min(c1, c2, key=lambda v: v[0] * v[0] + v[1] * v[1])
    return (a1, b1), (a2, b2)


def glv_decompose(curve_name: str, k: int) -> tuple[int, int]:
    """k (mod r) -> (k1, k2) with k == k1 + k2*lam (mod r), |ki| ~ sqrt(r).

    Babai rounding on the short basis; signs are carried in k1/k2."""
    curve = get_curve(curve_name)
    r = curve.fr.modulus
    (a1, b1), (a2, b2) = _lattice_basis(curve_name)
    k %= r
    # solve (k, 0) ~ c1*(a1,b1) + c2*(a2,b2) over Q, round to nearest int
    det = a1 * b2 - a2 * b1
    num1, num2 = b2 * k, -b1 * k
    c1 = (2 * num1 + (det if num1 * det > 0 else -det)) // (2 * det)
    c2 = (2 * num2 + (det if num2 * det > 0 else -det)) // (2 * det)
    k1 = k - c1 * a1 - c2 * a2
    k2 = -c1 * b1 - c2 * b2
    _, lam = glv_constants(curve_name)
    assert (k1 + k2 * lam) % r == k % r
    return k1, k2
