"""The port's FRI (icicle_tpu_torch/ops/fri.py; kernel K2's plain version
`fri_fold_ref` and K1's `keccak_ref` on the CPU) and proof of work
(ops/pow.py) against the JAX package's (icicle_tpu/ops/fri.py, ops/pow.py):
MT19937 and uniform_int, one fold against `_fold_kernel`, the omega
identity behind the strided twiddles, whole proofs byte for byte (log n
3-8, stopping degree 0 and 3, pow_bits 0 and 4, labels), each package
verifying the other's bytes, tampering, the query helper against
`get_merkle_proof`, the PoW nonces, and the reference's golden
`babybear_fri_proof_reserialize` vector replayed from the port's blob
(tests/test_fri.py:94-109's inputs); proofs over Blake3 round trees (log n
5 and 8) and over goldilocks. Tolerance: exact equality."""

import functools

import numpy as np
import pytest
import torch

from icicle_tpu.fields.field import get_field as jax_field
from icicle_tpu.ops import fri as JF
from icicle_tpu.ops import ntt as JN
from icicle_tpu.ops import pow as JPOW
from icicle_tpu.ops.hash.blake3 import Blake3 as JaxBlake3
from icicle_tpu.ops.hash.keccak import Keccak256 as JaxKeccak256
from icicle_tpu.runtime.config import NTTConfig as JaxNTTConfig
from icicle_tpu.runtime.config import NTTDir as JaxNTTDir
from icicle_tpu_torch import Blake3, FriConfig, Keccak256, get_field, ntt
from icicle_tpu_torch.kernels.fri_kernel import fri_fold, fri_fold_ref
from icicle_tpu_torch.ops import fri as PF
from icicle_tpu_torch.ops import pow as PPOW
from icicle_tpu_torch.ops.ntt import ntt_init_domain
from icicle_tpu_torch.runtime import device

torch.set_num_threads(1)

JH = JaxKeccak256()   # one JAX hasher: each layer shape compiles once
PH = Keccak256()
LABELS = dict(domain_separator_label=b"fri-test", round_challenge_label=b"rc",
              commit_phase_label=b"cp", nonce_label=b"nl", public_state=b"ps", seed=7)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))


def _coeffs(rng, log_n, degree, p):
    n = 1 << log_n
    return [int(v) for v in rng.integers(0, p, size=degree + 1)] + [0] * (n - degree - 1)


@functools.lru_cache(maxsize=None)
def _evals(log_n, degree, seed, fname="babybear"):
    """(JAX evaluations, the port's) of a random polynomial of `degree` on
    the 2^log_n roots of unity: the JAX package's forward NTT and the
    port's."""
    jf, pf = jax_field(fname), get_field(fname)
    coeffs = _coeffs(np.random.default_rng(seed), log_n, degree, jf.modulus)
    JN.ntt_init_domain(jf, log_n)
    jev = JN.ntt_jit(jf, jf.from_ints(coeffs), JaxNTTDir.FORWARD, JaxNTTConfig())
    pev = ntt(pf, pf.from_ints(coeffs, "cpu"))
    assert np.array_equal(np.asarray(jev), pev.numpy().view(np.uint32))
    return jev, pev


# (log n, degree, stopping degree, pow bits, queries, labels)
CASES = [(3, 0, 0, 0, 4, False), (5, 3, 3, 4, 8, True), (6, 0, 0, 4, 10, True),
         (8, 0, 0, 0, 6, False), (8, 3, 3, 4, 5, True)]


@functools.lru_cache(maxsize=None)
def _proofs(case):
    log_n, degree, stop, pow_bits, queries, labels = case
    jev, pev = _evals(log_n, degree, seed=log_n + degree)
    kw = LABELS if labels else {}
    jcfg = JF.FriConfig(stopping_degree=stop, pow_bits=pow_bits, nof_queries=queries)
    pcfg = FriConfig(stopping_degree=stop, pow_bits=pow_bits, nof_queries=queries)
    jtc, ptc = JF.FriTranscriptConfig(**kw), PF.FriTranscriptConfig(**kw)
    jproof = JF.fri_prove(jax_field("babybear"), jev, jcfg, jtc, JH, JH)
    pproof = PF.fri_prove(get_field("babybear"), pev, pcfg, ptc, PH, PH)
    return jproof, pproof, (jcfg, jtc), (pcfg, ptc)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_proof_bytes_match_jax(case):
    jproof, pproof, _, _ = _proofs(case)
    assert pproof.serialize(get_field("babybear")) == jproof.serialize(jax_field("babybear"))
    assert len(pproof.final_poly) == case[2] + 1


@pytest.mark.parametrize("case", CASES, ids=str)
def test_port_verifies_and_refuses_tampering(case):
    _, pproof, _, (pcfg, ptc) = _proofs(case)
    f = get_field("babybear")
    assert PF.fri_verify(f, pproof, pcfg, ptc, PH, PH)
    bad = PF.FriProof.deserialize(f, pproof.serialize(f))
    bad.final_poly = [(v + 1) % f.modulus for v in bad.final_poly]  # each one a query reads
    assert not PF.fri_verify(f, bad, pcfg, ptc, PH, PH)
    bad = PF.FriProof.deserialize(f, pproof.serialize(f))
    bad.query_proofs[0][0][0].leaf[0] ^= 1
    assert not PF.fri_verify(f, bad, pcfg, ptc, PH, PH)
    other = PF.FriTranscriptConfig(domain_separator_label=b"other")
    assert not PF.fri_verify(f, pproof, pcfg, other, PH, PH)


@pytest.mark.parametrize("case", [CASES[1], CASES[3]], ids=str)
def test_each_package_verifies_the_others_bytes(case):
    jproof, pproof, (jcfg, jtc), (pcfg, ptc) = _proofs(case)
    jf, pf = jax_field("babybear"), get_field("babybear")
    assert JF.fri_verify(jf, JF.FriProof.deserialize(jf, pproof.serialize(pf)), jcfg, jtc, JH, JH)
    assert PF.fri_verify(pf, PF.FriProof.deserialize(pf, jproof.serialize(jf)), pcfg, ptc, PH, PH)


@pytest.mark.parametrize("log_n,stop,pow_bits", [(5, 3, 0), (8, 0, 4)])
def test_blake3_trees_match_jax(log_n, stop, pow_bits):
    """leaves_hash = compress_hash = Blake3: the round trees hash 4-byte
    leaves and 64-byte pairs; the proof's bytes equal JAX's and verify."""
    jev, pev = _evals(log_n, stop, seed=40 + log_n)
    jcfg = JF.FriConfig(stopping_degree=stop, pow_bits=pow_bits, nof_queries=5)
    pcfg = FriConfig(stopping_degree=stop, pow_bits=pow_bits, nof_queries=5)
    jh, ph = JaxBlake3(), Blake3()
    jproof = JF.fri_prove(jax_field("babybear"), jev, jcfg, JF.FriTranscriptConfig(), jh, jh)
    pproof = PF.fri_prove(get_field("babybear"), pev, pcfg, PF.FriTranscriptConfig(), ph, ph)
    f = get_field("babybear")
    assert pproof.serialize(f) == jproof.serialize(jax_field("babybear"))
    assert PF.fri_verify(f, pproof, pcfg, PF.FriTranscriptConfig(), ph, ph)
    bad = PF.FriProof.deserialize(f, pproof.serialize(f))
    bad.query_proofs[0][0][0].leaf[0] ^= 1
    assert not PF.fri_verify(f, bad, pcfg, PF.FriTranscriptConfig(), ph, ph)


def test_goldilocks_proof_matches_jax():
    """log n 5, stopping degree 3, 5 queries, Keccak-256 over goldilocks
    (two words an element)."""
    jf, pf = jax_field("goldilocks"), get_field("goldilocks")
    rng = np.random.default_rng(64)
    coeffs = [int.from_bytes(rng.bytes(16), "little") % jf.modulus for _ in range(4)] + [0] * 28
    JN.ntt_init_domain(jf, 5)
    jev = JN.ntt_jit(jf, jf.from_ints(coeffs), JaxNTTDir.FORWARD, JaxNTTConfig())
    pev = ntt(pf, pf.from_ints(coeffs, "cpu"))
    assert np.array_equal(np.asarray(jev), pev.numpy().view(np.uint32))
    jcfg = JF.FriConfig(stopping_degree=3, pow_bits=0, nof_queries=5)
    pcfg = FriConfig(stopping_degree=3, pow_bits=0, nof_queries=5)
    jproof = JF.fri_prove(jf, jev, jcfg, JF.FriTranscriptConfig(), JH, JH)
    pproof = PF.fri_prove(pf, pev, pcfg, PF.FriTranscriptConfig(), PH, PH)
    assert pproof.serialize(pf) == jproof.serialize(jf)
    assert PF.fri_verify(pf, pproof, pcfg, PF.FriTranscriptConfig(), PH, PH)


def test_golden_reference_reserialize_replays_the_ports_blob():
    """tests/test_fri.py:94-109's proof (seed 77, log n 6, 4 queries, no
    pow) made by the port: the golden store's reference round trip of that
    blob (keyed by the blob's bytes) replays and gives it back."""
    from tests import ref_ffi
    assert ref_ffi.available("babybear")
    f = get_field("babybear")
    rng = np.random.default_rng(77)
    coeffs = _coeffs(rng, 6, 0, f.modulus)
    evals = ntt(f, f.from_ints(coeffs, "cpu"))
    proof = PF.fri_prove(f, evals, FriConfig(stopping_degree=0, pow_bits=0, nof_queries=4),
                         PF.FriTranscriptConfig(), PH, PH)
    blob = proof.serialize(f)
    assert bytes(ref_ffi.babybear_fri_proof_reserialize(blob)) == blob


def test_mt19937_and_uniform_int_match_jax():
    g = PF.MT19937(5489)
    assert [g.next_u32(), g.next_u32()] == [3499211612, 581869302]
    for seed, lo, hi in ((1, 0, 10), (2, 1, 1 << 20), (3, 4, (1 << 32) - 2)):
        pg, jg = PF.MT19937(seed), JF.MT19937(seed)
        assert [PF.uniform_int(pg, lo, hi) for _ in range(700)] == \
            [JF.uniform_int(jg, lo, hi) for _ in range(700)]


@pytest.mark.parametrize("fname", ["babybear", "koalabear"])
def test_omega_identity_and_strided_twiddles(fname):
    """omega(k)^2 = omega(k - 1) for every k of the field's 2-adic tower, so
    round r's w^-i is the first domain's table at stride 2^r."""
    f = get_field(fname)
    p = f.modulus
    for k in range(1, f.two_adicity + 1):
        assert pow(f.omega(k), 2, p) == f.omega(k - 1)
    big = ntt_init_domain(f, 10, "cpu").twiddles_inv
    for r in (1, 3, 9):
        small = ntt_init_domain(f, 10 - r, "cpu").twiddles_inv
        assert torch.equal(big[::1 << r][:small.shape[0]], small)


@pytest.mark.parametrize("fname", ["babybear", "koalabear"])
def test_fold_matches_jax_fold_kernel(fname):
    jf, pf = jax_field(fname), get_field(fname)
    log_n0, r = 9, 2
    n = 1 << (log_n0 - r)
    vals = [int(v) for v in np.random.default_rng(11).integers(0, jf.modulus, size=n)]
    vals[:3] = [0, jf.modulus - 1, 0]
    alpha = 987654321 % jf.modulus
    want = JF._fold_kernel(jf, log_n0 - r)(jf.from_ints(vals), jf.from_ints([alpha])[0],
                                          JF._inv_twiddles(jf, log_n0 - r))
    tw = ntt_init_domain(pf, log_n0, "cpu").twiddles_inv
    got = fri_fold_ref(pf, pf.from_ints(vals, "cpu"), alpha, tw, 1 << r)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    assert torch.equal(fri_fold(pf, pf.from_ints(vals, "cpu"), alpha, tw, 1 << r), got)


def test_round_proofs_equal_get_merkle_proof():
    f = get_field("babybear")
    _, pev = _evals(6, 0, seed=6)
    tree = PF._make_round_trees(PH, PH, 1, 6)[1]
    cur = fri_fold_ref(f, pev, 5, ntt_init_domain(f, 6, "cpu").twiddles_inv, 1)
    tree.build(cur.reshape(-1, 1))
    idxs = [0, 31, 7, 16, 7]
    got = PF._round_proofs(tree, idxs)
    for i, p in zip(idxs, got):
        want = tree.get_merkle_proof(tree.layers[0], i, pruned=False)
        assert p.serialize() == want.serialize() and tree.verify(p)


def test_proof_of_work_nonce_matches_jax():
    challenge = b"icicle-pow-challenge"
    found, nonce, mined = PPOW.proof_of_work(PH, challenge, 10)
    assert (found, nonce, mined) == JPOW.proof_of_work(JH, challenge, 10)
    assert PPOW.proof_of_work_verify(PH, challenge, 10, nonce) == (True, mined)
    if nonce:
        assert not PPOW.proof_of_work_verify(PH, challenge, 10, nonce - 1)[0]
    with pytest.raises(ValueError):
        PPOW.proof_of_work(PH, challenge, 61)


def test_solve_pow_nonce_matches_jax():
    """The host grind (default Keccak-256) and the loop over another hasher
    find the JAX package's nonce."""
    jt = JF.FriTranscript(jax_field("babybear"), JF.FriTranscriptConfig(**LABELS), 12)
    pt = PF.FriTranscript(get_field("babybear"), PF.FriTranscriptConfig(**LABELS), 12)
    jt.prev_alpha = pt.prev_alpha = 123456
    want = jt.solve_pow(12)
    assert pt.solve_pow(12) == want and pt.verify_pow(want, 12)
    looped = PF.FriTranscript(get_field("babybear"), PF.FriTranscriptConfig(
        **LABELS, hasher=lambda b: PF._native.keccak_256(b)), 12)
    looped.prev_alpha = 123456
    assert looped.solve_pow(12) == want
