"""Host-side python-int EC arithmetic for tiny point counts (counterpart of
icicle_tpu/curves/host_ec.py).

Used where a handful of point ops don't justify a device roundtrip (the MSM
window Horner combine, chip_smoke.py's oracle). a=0 short Weierstrass.
Over Fp a coordinate is an int (`ec_add`, ...); over Fp2 = Fp[u]/(u^2 - nr)
(G2 of bn254, bls12_377, bls12_381) a (c0, c1) pair (`ec2_add`, ...).
"""

from __future__ import annotations

INF = None


def ec_add(p, q, mod: int):
    if p is INF:
        return q
    if q is INF:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % mod == 0:
            return INF
        lam = (3 * x1 * x1) * pow(2 * y1, -1, mod) % mod
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, mod) % mod
    x3 = (lam * lam - x1 - x2) % mod
    y3 = (lam * (x1 - x3) - y1) % mod
    return (x3, y3)


def ec_dbl(p, mod: int):
    return ec_add(p, p, mod)


def ec_neg(p, mod: int):
    return INF if p is INF else (p[0], (-p[1]) % mod)


def ec_mul(p, k: int, mod: int):
    if k < 0:
        return ec_mul(ec_neg(p, mod), -k, mod)
    acc = INF
    while k:
        if k & 1:
            acc = ec_add(acc, p, mod)
        p = ec_add(p, p, mod)
        k >>= 1
    return acc


# -- Fp2 = Fp[u]/(u^2 - nr): elements (c0, c1) ------------------------------

def fp2_add(a, b, mod: int):
    return ((a[0] + b[0]) % mod, (a[1] + b[1]) % mod)


def fp2_sub(a, b, mod: int):
    return ((a[0] - b[0]) % mod, (a[1] - b[1]) % mod)


def fp2_mul(a, b, mod: int, nr: int):
    return ((a[0] * b[0] + nr * a[1] * b[1]) % mod, (a[0] * b[1] + a[1] * b[0]) % mod)


def fp2_inv(a, mod: int, nr: int):
    """(c0 - c1 u) / (c0^2 - nr c1^2); a != 0."""
    ninv = pow((a[0] * a[0] - nr * a[1] * a[1]) % mod, -1, mod)
    return (a[0] * ninv % mod, -a[1] * ninv % mod)


def ec2_add(p, q, mod: int, nr: int):
    if p is INF:
        return q
    if q is INF:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if fp2_add(y1, y2, mod) == (0, 0):
            return INF
        num = fp2_mul((3, 0), fp2_mul(x1, x1, mod, nr), mod, nr)
        den = fp2_add(y1, y1, mod)
    else:
        num = fp2_sub(y2, y1, mod)
        den = fp2_sub(x2, x1, mod)
    lam = fp2_mul(num, fp2_inv(den, mod, nr), mod, nr)
    x3 = fp2_sub(fp2_sub(fp2_mul(lam, lam, mod, nr), x1, mod), x2, mod)
    y3 = fp2_sub(fp2_mul(lam, fp2_sub(x1, x3, mod), mod, nr), y1, mod)
    return (x3, y3)


def ec2_dbl(p, mod: int, nr: int):
    return ec2_add(p, p, mod, nr)


def ec2_neg(p, mod: int):
    return INF if p is INF else (p[0], ((-p[1][0]) % mod, (-p[1][1]) % mod))


def host_ops(group):
    """(add, dbl, neg, identity's affine form) of `group`'s points as
    Python ints: G1 and bw6_761's G2 over Fp (ints, (0, 0)), G2 over Fp2
    ((c0, c1) pairs, ((0, 0), (0, 0)))."""
    mod = group.curve.fq.modulus
    if group.degree == 1:
        return (lambda p, q: ec_add(p, q, mod), lambda p: ec_dbl(p, mod),
                lambda p: ec_neg(p, mod), (0, 0))
    nr = group.coord_field.engine.w
    return (lambda p, q: ec2_add(p, q, mod, nr), lambda p: ec2_dbl(p, mod, nr),
            lambda p: ec2_neg(p, mod), ((0, 0), (0, 0)))


def scalar_mul(group, p, k: int):
    """k p on the host for a point of `group` (affine ints; INF the
    identity)."""
    add, dbl, neg, _ = host_ops(group)
    if k < 0:
        return scalar_mul(group, neg(p), -k)
    acc = INF
    while k:
        if k & 1:
            acc = add(acc, p)
        p = dbl(p)
        k >>= 1
    return acc
