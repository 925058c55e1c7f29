"""The port's pairings (icicle_tpu_torch/curves/ate.py and pairing.py, its
own copies of the JAX package's Python-int modules) against the JAX
package's on bn254, bls12_381 and bls12_377, the golden `bn254_pairing`
vector of the reference replayed byte for byte on the inputs of
tests/test_pairing_ate.py, and the pairing identity over the port's own
G1 and G2 MSM results (`affine_ints`)."""

import numpy as np
import pytest
import torch

from icicle_tpu.curves import ate as JA
from icicle_tpu.curves import pairing as JP
from icicle_tpu_torch import MSMConfig, msm
from icicle_tpu_torch.curves import ate as TA
from icicle_tpu_torch.curves import host_ec
from icicle_tpu_torch.curves import pairing as TP
from icicle_tpu_torch.curves.group import get_group
from icicle_tpu_torch.runtime import device


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))


def generators(cname: str):
    g1, g2 = get_group(cname), get_group(cname, g2=True)
    p = g2.curve.params
    return g1, g2, (g1.curve.gen_x, g1.curve.gen_y), (p.g2_gen_x, p.g2_gen_y)


@pytest.mark.parametrize("cname", ["bn254", "bls12_381", "bls12_377"])
def test_pairings_match_jax(cname):
    g1, g2, P, Q = generators(cname)
    P5 = host_ec.ec_mul(P, 5, g1.curve.fq.modulus)
    Q7 = host_ec.scalar_mul(g2, Q, 7)
    e = TA.ate_pairing(cname, P5, Q7)
    assert e == JA.ate_pairing(cname, P5, Q7)
    assert TA.fp12_to_ints(e) == JA.fp12_to_ints(e)
    assert TP.pairing(cname, P5, Q7) == JP.pairing(cname, P5, Q7)
    assert TP.pairing_tate(cname, P5, Q7) == JP.pairing_tate(cname, P5, Q7)
    assert TP.target_one(cname) == JP.target_one(cname)
    # bilinear: e(5P, 7Q) = e(35 P, Q)
    assert e == TA.ate_pairing(cname, host_ec.ec_mul(P, 35, g1.curve.fq.modulus), Q)


def test_bn254_pairing_golden_vector():
    """tests/test_pairing_ate.py's inputs (7 G1, 13 G2) through the golden
    `bn254_pairing` vector of the reference FFI: the port's optimal-ate
    pairing, as 12 Fp values of 8 limbs, is the reference's byte for byte."""
    from tests import ref_ffi
    if not ref_ffi.bn254_available():
        pytest.skip("bn254 reference build / golden store not present")
    g1, g2, P, Q = generators("bn254")
    p = g1.curve.fq.modulus
    P7 = host_ec.ec_mul(P, 7, p)
    Q13 = host_ec.scalar_mul(g2, tuple(tuple(v % p for v in c) for c in Q), 13)

    def limbs(v, n=8):
        return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]

    p_u32 = np.array(limbs(P7[0]) + limbs(P7[1]), dtype=np.uint32)
    q_u32 = np.array(limbs(Q13[0][0]) + limbs(Q13[0][1]) + limbs(Q13[1][0]) + limbs(Q13[1][1]),
                     dtype=np.uint32)
    got = np.array(sum((limbs(v) for v in TA.fp12_to_ints(TA.ate_pairing("bn254", P7, Q13))),
                       []), dtype=np.uint32)
    assert np.array_equal(got, ref_ffi.bn254_pairing(p_u32, q_u32))


def test_pairing_identity_over_the_port_msms():
    """A1 = sum s_i k_i G1 and A2 = sum s_i k_i G2 by the port's msm() of one
    set of scalars over k_i G1 and k_i G2, read by affine_ints: e(A1, G2)
    == e(G1, A2), by both pairings, and not the identity."""
    g1, g2, P, Q = generators("bn254")
    fr = g1.curve.fr
    ks = [5, 9, 14, 20]
    rng = np.random.default_rng(3)
    s = fr.from_ints([int.from_bytes(rng.bytes(40), "little") % fr.modulus for _ in ks], "cpu")
    p1 = [host_ec.ec_mul(P, k, g1.curve.fq.modulus) for k in ks]
    p2 = [host_ec.scalar_mul(g2, Q, k) for k in ks]
    x1, y1 = (g1.coord_field.from_ints([q[i] for q in p1], "cpu") for i in (0, 1))
    x2, y2 = (g2.coord_field.from_ints([q[i] for q in p2], "cpu") for i in (0, 1))
    A1 = TP.affine_ints(g1, msm("bn254", s, x1, y1, MSMConfig(c=8)))
    A2 = TP.affine_ints(g2, msm("bn254", s, x2, y2, MSMConfig(g2=True, c=8)))
    lhs = TP.pairing("bn254", A1, Q)
    assert lhs == TP.pairing("bn254", P, A2) != TP.target_one("bn254")
    assert TA.ate_pairing("bn254", A1, Q) == TA.ate_pairing("bn254", P, A2)
