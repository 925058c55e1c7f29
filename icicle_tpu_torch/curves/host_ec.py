"""Host-side python-int EC arithmetic for tiny point counts (counterpart of
icicle_tpu/curves/host_ec.py).

Used where a handful of point ops don't justify a device roundtrip (the MSM
window Horner combine, chip_smoke.py's oracle). a=0 short Weierstrass.
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
