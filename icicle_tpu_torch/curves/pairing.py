"""Pairings (reference F20: include/icicle/pairing/pairing.h + models/{bn,bls12}.h);
the port's own copy of icicle_tpu/curves/pairing.py, plus `affine_ints`,
which reads the port's point tensors as the ints the pairings take.

Host-side python-int implementation — the reference's pairing is likewise a
frontend-only single-point computation (src/pairing.cpp:11-26, no dispatcher);
it feeds KZG-style verification where a handful of pairings gate a proof.

Tower: Fp2 = Fp[u]/(u^2 - nr), Fp12 = Fp2[w]/(w^6 - xi). G2 points untwist
into E(Fp12) via (x*cx, y*cy) with cx/cy per twist type (D: w^2/w^3,
M: w^-2/w^-3). The Miller loop is the Tate pairing f_{r,P}(psi(Q)) with P in
G1 (all loop point math in Fp), followed by the full final exponentiation
(p^12-1)/r computed as an integer power — value-stable and bilinear; pairing
EQUALITY checks (the KZG use-case) agree with any fixed choice of pairing.
"""

from __future__ import annotations

import dataclasses
import functools

from icicle_tpu_torch.curves.params import get_curve


# ---------------------------------------------------------------------------
# Fp2 / Fp12 tower over python ints
# ---------------------------------------------------------------------------

class Tower:
    """Fp12 = Fp2[w]/(w^6 - xi); elements are 6-tuples of Fp2 pairs."""

    def __init__(self, p: int, nr: int, xi: tuple[int, int]):
        self.p = p
        self.nr = nr % p if nr >= 0 else p + nr
        self.xi = (xi[0] % p, xi[1] % p)

    # -- Fp2 ---------------------------------------------------------------
    def e2_add(self, a, b):
        p = self.p
        return ((a[0] + b[0]) % p, (a[1] + b[1]) % p)

    def e2_sub(self, a, b):
        p = self.p
        return ((a[0] - b[0]) % p, (a[1] - b[1]) % p)

    def e2_mul(self, a, b):
        p, nr = self.p, self.nr
        return ((a[0] * b[0] + nr * a[1] * b[1]) % p,
                (a[0] * b[1] + a[1] * b[0]) % p)

    def e2_inv(self, a):
        p, nr = self.p, self.nr
        norm = (a[0] * a[0] - nr * a[1] * a[1]) % p
        ni = pow(norm, -1, p)
        return (a[0] * ni % p, (-a[1]) * ni % p)

    def e2_neg(self, a):
        p = self.p
        return ((-a[0]) % p, (-a[1]) % p)

    E2_ZERO = (0, 0)
    E2_ONE = (1, 0)

    # -- Fp12 as degree-6 poly in w over Fp2 ---------------------------------
    def one(self):
        return ((1, 0),) + ((0, 0),) * 5

    def zero(self):
        return ((0, 0),) * 6

    def from_e2(self, c0, pos: int = 0):
        out = [(0, 0)] * 6
        out[pos] = c0
        return tuple(out)

    def from_fp(self, v: int):
        return self.from_e2((v % self.p, 0))

    def add(self, a, b):
        return tuple(self.e2_add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        return tuple(self.e2_sub(x, y) for x, y in zip(a, b))

    def mul(self, a, b):
        acc = [(0, 0)] * 6
        for i in range(6):
            if a[i] == (0, 0):
                continue
            for j in range(6):
                if b[j] == (0, 0):
                    continue
                t = self.e2_mul(a[i], b[j])
                k = i + j
                if k < 6:
                    acc[k] = self.e2_add(acc[k], t)
                else:
                    acc[k - 6] = self.e2_add(acc[k - 6], self.e2_mul(t, self.xi))
        return tuple(acc)

    def sqr(self, a):
        return self.mul(a, a)

    def pow(self, a, e: int):
        result = self.one()
        base = a
        while e:
            if e & 1:
                result = self.mul(result, base)
            base = self.mul(base, base)
            e >>= 1
        return result

    def inv(self, a):
        """Inverse via the tower norm: N(a) = prod of conjugates.

        Uses a^(p^12-2)? No — too slow. Instead solve with the resultant
        trick: invert by mapping to Fp2[w] and using the extended-euclid-free
        norm chain: a^-1 = conj_prod / N where N in Fp2 is computed from
        Fp12 = Fp6[w]/(w^2 - v) structure. For simplicity and correctness use
        Gaussian elimination over Fp2 on the 6x6 multiplication matrix.
        """
        # Build matrix M where column j = w^j * a coefficients; solve M x = e0.
        cols = []
        for j in range(6):
            cols.append(self.mul(self.from_e2((1, 0), j), a))
        # 6x6 system over Fp2
        mat = [[cols[j][i] for j in range(6)] for i in range(6)]
        rhs = [self.E2_ONE if i == 0 else self.E2_ZERO for i in range(6)]
        # gaussian elimination
        for col in range(6):
            piv = None
            for r in range(col, 6):
                if mat[r][col] != (0, 0):
                    piv = r
                    break
            assert piv is not None, "non-invertible Fp12 element"
            mat[col], mat[piv] = mat[piv], mat[col]
            rhs[col], rhs[piv] = rhs[piv], rhs[col]
            pinv = self.e2_inv(mat[col][col])
            mat[col] = [self.e2_mul(v, pinv) for v in mat[col]]
            rhs[col] = self.e2_mul(rhs[col], pinv)
            for r in range(6):
                if r != col and mat[r][col] != (0, 0):
                    fac = mat[r][col]
                    mat[r] = [self.e2_sub(v, self.e2_mul(fac, w))
                              for v, w in zip(mat[r], mat[col])]
                    rhs[r] = self.e2_sub(rhs[r], self.e2_mul(fac, rhs[col]))
        return tuple(rhs)


@dataclasses.dataclass(frozen=True)
class PairingConfig:
    curve: str
    xi: tuple[int, int]        # sextic twist constant (w^6 = xi)
    twist: str                 # "D" (b' = b/xi) or "M" (b' = b*xi)


_PAIRINGS = {
    # bn254: Fp2 = Fp[u]/(u^2+1), xi = 9+u, D-twist (b_g2 = 3/(9+u))
    "bn254": PairingConfig("bn254", (9, 1), "D"),
    # bls12_381: Fp2 = Fp[u]/(u^2+1), xi = 1+u, M-twist (b_g2 = 4(1+u))
    "bls12_381": PairingConfig("bls12_381", (1, 1), "M"),
    # bls12_377: Fp2 = Fp[u]/(u^2+5), xi = u, D-twist (b_g2 = 1/u * ... )
    "bls12_377": PairingConfig("bls12_377", (0, 1), "D"),
}


@functools.lru_cache(maxsize=None)
def _setup(curve_name: str):
    from icicle_tpu_torch.fields.field import _PARAMS
    cfg = _PAIRINGS[curve_name]
    curve = get_curve(curve_name)
    p = curve.fq.modulus
    r = curve.fr.modulus
    nr = _PARAMS[curve.params.base_field].nonresidue
    tw = Tower(p, nr, cfg.xi)
    # untwist constants cx, cy in Fp12
    if cfg.twist == "D":
        cx = tw.from_e2((1, 0), 2)               # w^2
        cy = tw.from_e2((1, 0), 3)               # w^3
    else:
        # w^-2 = w^4/xi, w^-3 = w^3/xi
        xi_inv = tw.e2_inv(tw.xi)
        cx = tw.from_e2(xi_inv, 4)
        cy = tw.from_e2(xi_inv, 3)
    return tw, cx, cy, p, r


def _untwist(tw: Tower, cx, cy, q):
    """G2 affine (Fp2 pair coords) -> E(Fp12) affine."""
    xq = tw.mul(tw.from_e2(q[0]), cx)
    yq = tw.mul(tw.from_e2(q[1]), cy)
    return xq, yq


def _miller_tate(tw: Tower, p: int, r: int, P, Qx, Qy):
    """f_{r,P} evaluated at an E(Fp12) point; P in G1 (Fp affine)."""
    xp, yp = P
    f = tw.one()
    # current multiple of P, tracked in Fp affine
    tx, ty = xp, yp

    bits = bin(r)[3:]  # MSB already consumed (T starts at P)
    for b in bits:
        # doubling line at T: lam = 3x^2 / 2y
        lam = (3 * tx * tx) * pow(2 * ty, -1, p) % p
        # l(Q) = yQ - ty - lam*(xQ - tx)
        l = tw.sub(tw.sub(Qy, tw.from_fp(ty)),
                   tw.mul(tw.from_fp(lam),
                          tw.sub(Qx, tw.from_fp(tx))))
        f = tw.mul(tw.sqr(f), l)
        # T = 2T
        x3 = (lam * lam - 2 * tx) % p
        y3 = (lam * (tx - x3) - ty) % p
        tx, ty = x3, y3
        if b == "1":
            if tx == xp and (ty + yp) % p == 0:
                # T = -P: the line through T and P is the vertical x - tx and
                # T + P = O. This is necessarily the final loop step (r prime).
                l = tw.sub(Qx, tw.from_fp(tx))
                f = tw.mul(f, l)
                tx, ty = None, None
                continue
            if tx == xp and ty == yp:
                lam = (3 * tx * tx) * pow(2 * ty, -1, p) % p
            else:
                lam = (yp - ty) * pow(xp - tx, -1, p) % p
            l = tw.sub(tw.sub(Qy, tw.from_fp(ty)),
                       tw.mul(tw.from_fp(lam),
                              tw.sub(Qx, tw.from_fp(tx))))
            f = tw.mul(f, l)
            x3 = (lam * lam - tx - xp) % p
            y3 = (lam * (tx - x3) - ty) % p
            tx, ty = x3, y3
    assert tx is None, "Miller loop did not terminate at the identity"
    return f


def pairing(curve_name: str, p_affine: tuple[int, int],
            q_affine: tuple[tuple[int, int], tuple[int, int]]):
    """e(P, Q) in Fp12 (reference pairing.h:24-27 surface).

    Value-parity implementation: delegates to the optimal-ate pairing
    (curves/ate.py, byte-equal to the reference FFI) and converts from the
    nested Fp6[w]/(w^2-v) tower to this module's flat Fp2[w]/(w^6-xi) basis
    via v = w^2: flat coefficient a_{2i} = c0.c_i, a_{2i+1} = c1.c_i.

    P: G1 affine python-int pair; Q: G2 affine pair of Fp2 pairs.
    Returns the Fp12 element as a 6-tuple of Fp2 pairs.
    """
    from icicle_tpu_torch.curves.ate import ate_pairing
    c0, c1 = ate_pairing(curve_name, p_affine, q_affine)
    return (c0[0], c1[0], c0[1], c1[1], c0[2], c1[2])


def pairing_tate(curve_name: str, p_affine: tuple[int, int],
                 q_affine: tuple[tuple[int, int], tuple[int, int]]):
    """Tate pairing with the plain (p^12-1)/r final power — kept as an
    independent bilinear oracle for cross-checking the ate implementation."""
    tw, cx, cy, p, r = _setup(curve_name)
    Qx, Qy = _untwist(tw, cx, cy, q_affine)
    f = _miller_tate(tw, p, r, p_affine, Qx, Qy)
    exp = (p ** 12 - 1) // r
    return tw.pow(f, exp)


def target_one(curve_name: str):
    tw, *_ = _setup(curve_name)
    return tw.one()


def affine_ints(group, point):
    """A point of `group` (curves/group.py) as the affine Python ints the
    pairings take: `point` is Montgomery projective tensors (msm's result,
    one point) -> (x, y) ints for G1, ((x0, x1), (y0, y1)) for G2 over
    Fp2; the identity reads (0, 0) or ((0, 0), (0, 0))."""
    f = group.coord_field
    x, y = group.to_affine_canonical(point)
    xs, ys = f.to_ints(x), f.to_ints(y)
    if group.degree == 2:
        return (tuple(int(v) for v in xs), tuple(int(v) for v in ys))
    return int(xs), int(ys)
