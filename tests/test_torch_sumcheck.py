"""The port's sumcheck (icicle_tpu_torch/ops/sumcheck.py; kernel K3's plain
version `sumcheck_round_ref` on the CPU) against the JAX package's
(icicle_tpu/ops/sumcheck.py): one round against `_round_pass`; whole
proves (round polynomials, challenges, serialized bytes) for both
predefined combines and lambdas with constants and an inverse, n = 2^1 ..
2^10 on babybear and small n on bn254_scalar and goldilocks; verify round trips,
tampering, transcript labels and the extension-field refusal. Inputs come
from numpy seeds; tolerance: exact equality."""

import functools

import numpy as np
import pytest
import torch

from icicle_tpu.fields.field import get_field as jax_field
from icicle_tpu.ops import program as JP
from icicle_tpu.ops import sumcheck as JS
from icicle_tpu_torch import get_field
from icicle_tpu_torch.kernels.sumcheck_kernel import sumcheck_round_ref
from icicle_tpu_torch.ops import program as PP
from icicle_tpu_torch.ops import sumcheck as PS
from icicle_tpu_torch.runtime import device
from icicle_tpu_torch.runtime.config import SumcheckConfig
from icicle_tpu_torch.runtime.errors import IcicleException

torch.set_num_threads(1)

COMBINES = {"const_inv": (lambda v: v[0] * v[1].inverse() + 7 - v[2], 3),
            "const_deg3": (lambda v: v[0] * v[0] * v[1] - 2, 2)}


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))


def _combines(name):
    if name in ("AB_MINUS_C", "EQ_X_AB_MINUS_C"):
        return (JP.ReturningValueProgram(JP.PreDefined[name]),
                PP.ReturningValueProgram(PP.PreDefined[name]))
    func, k = COMBINES[name]
    return JP.ReturningValueProgram(func, nof_inputs=k), PP.ReturningValueProgram(func, nof_inputs=k)


def _npolys(name) -> int:
    return {"AB_MINUS_C": 3, "EQ_X_AB_MINUS_C": 4}.get(name) or COMBINES[name][1]


def _mles(fname, npolys, n, seed):
    """npolys MLEs of n elements (zeros among them) as python ints."""
    p = jax_field(fname).modulus
    rng = np.random.default_rng(seed)
    rows = [[int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)] for _ in range(npolys)]
    rows[0][0] = 0
    return rows


def _claimed(fname, name, rows):
    p = jax_field(fname).modulus
    func = {"AB_MINUS_C": lambda v: v[0] * v[1] - v[2],
            "EQ_X_AB_MINUS_C": lambda v: v[3] * (v[0] * v[1] - v[2])}.get(name)
    if func is None:
        return 0
    return sum(func([r[i] for r in rows]) for i in range(len(rows[0]))) % p


@functools.lru_cache(maxsize=None)
def _proves(fname, name, n, labels=False):
    """(JAX proof, JAX challenges, port proof, port challenges, claimed)."""
    rows = _mles(fname, _npolys(name), n, seed=n)
    claimed = _claimed(fname, name, rows)
    jc, pc = _combines(name)
    jtc, ptc = JS.SumcheckTranscriptConfig(), PS.SumcheckTranscriptConfig()
    if labels:
        kw = dict(domain_separator_label=b"dom", round_poly_label=b"poly",
                  round_challenge_label=b"chal", seed=99)
        jtc, ptc = JS.SumcheckTranscriptConfig(**kw), PS.SumcheckTranscriptConfig(**kw)
    jf, pf = jax_field(fname), get_field(fname)
    jproof, jch = JS.sumcheck_prove(jf, [jf.from_ints(r) for r in rows], claimed, jc, jtc)
    pproof, pch = PS.sumcheck_prove(pf, [pf.from_ints(r) for r in rows], claimed, pc, ptc)
    return jproof, jch, pproof, pch, claimed


PROVE_CASES = ([("babybear", "AB_MINUS_C", 1 << k) for k in range(1, 11)]
               + [("babybear", "EQ_X_AB_MINUS_C", n) for n in (2, 32)]
               + [("babybear", "const_inv", 4), ("babybear", "const_deg3", 16)]
               + [("bn254_scalar", "AB_MINUS_C", 4), ("bn254_scalar", "EQ_X_AB_MINUS_C", 2)]
               + [("goldilocks", "AB_MINUS_C", 16)])


@pytest.mark.parametrize("fname,name,n", PROVE_CASES)
def test_prove_matches_jax(fname, name, n):
    jproof, jch, pproof, pch, _ = _proves(fname, name, n)
    assert pproof.round_polys == jproof.round_polys
    assert pch == jch
    assert pproof.serialize(get_field(fname)) == jproof.serialize(jax_field(fname))
    assert PS.SumcheckProof.deserialize(get_field(fname), pproof.serialize(get_field(fname))) \
        == pproof


@pytest.mark.parametrize("fname,name,n", [c for c in PROVE_CASES if c[1] in
                                          ("AB_MINUS_C", "EQ_X_AB_MINUS_C")])
def test_verify_round_trip_and_tampering(fname, name, n):
    _, _, proof, _, claimed = _proves(fname, name, n)
    pf = get_field(fname)
    p = pf.modulus
    assert PS.sumcheck_verify(pf, proof, claimed)
    assert not PS.sumcheck_verify(pf, proof, (claimed + 1) % p)
    bad = PS.SumcheckProof([list(rp) for rp in proof.round_polys])
    bad.round_polys[-1][1] = (bad.round_polys[-1][1] + 1) % p
    if len(bad.round_polys) > 1:
        assert not PS.sumcheck_verify(pf, bad, claimed)
    bad.round_polys[0][0] = (bad.round_polys[0][0] + 1) % p
    assert not PS.sumcheck_verify(pf, bad, claimed)


def test_labels_match_jax_and_matter():
    jproof, jch, pproof, pch, claimed = _proves("babybear", "AB_MINUS_C", 16, labels=True)
    assert pproof.round_polys == jproof.round_polys and pch == jch
    plain = _proves("babybear", "AB_MINUS_C", 16)
    assert pch != plain[3]
    pf = get_field("babybear")
    kw = dict(domain_separator_label=b"dom", round_poly_label=b"poly",
              round_challenge_label=b"chal", seed=99)
    assert PS.sumcheck_verify(pf, pproof, claimed, PS.SumcheckTranscriptConfig(**kw))
    assert not PS.sumcheck_verify(pf, pproof, claimed)


@pytest.mark.parametrize("fname,fold", [("babybear", False), ("babybear", True),
                                        ("koalabear", True), ("bn254_scalar", True)])
def test_round_ref_matches_jax_round_pass(fname, fold):
    jf, pf = jax_field(fname), get_field(fname)
    jc, pc = _combines("EQ_X_AB_MINUS_C")
    rows = _mles(fname, 4, 16, seed=5)
    alpha = 123456789 % jf.modulus
    jrp, jm = JS._round_pass(jf, jc, 3)(np.stack([np.asarray(jf.from_ints(r)) for r in rows]),
                                        jf.from_ints([alpha])[0], fold)
    prp, pm = sumcheck_round_ref(pf, pc, 3, torch.stack([pf.from_ints(r) for r in rows]),
                                 alpha, fold)
    assert [int(v) for v in pf.to_ints(prp)] == [int(v) for v in jf.to_ints(jrp)]
    assert np.array_equal(pf.to_ints(pm), np.asarray(jf.to_ints(jm), dtype=object))


def test_extension_field_is_refused():
    pf = get_field("babybear")
    with pytest.raises(IcicleException, match="use_extension_field"):
        PS.sumcheck_prove(pf, [pf.from_ints([1, 2])] * 3, 0,
                          PP.ReturningValueProgram(PP.PreDefined.AB_MINUS_C),
                          cfg=SumcheckConfig(use_extension_field=True))


def test_torch_backend_is_the_plain_version():
    """SumcheckConfig(backend="torch") gives the same proof (the plain
    version on any device)."""
    _, _, proof, ch, claimed = _proves("babybear", "AB_MINUS_C", 64)
    pf = get_field("babybear")
    rows = _mles("babybear", 3, 64, seed=64)
    again, ch2 = PS.sumcheck_prove(pf, [pf.from_ints(r) for r in rows], claimed,
                                   PP.ReturningValueProgram(PP.PreDefined.AB_MINUS_C),
                                   cfg=SumcheckConfig(backend="torch"))
    assert again == proof and ch2 == ch
