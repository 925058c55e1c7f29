"""FRI low-degree proof, prover and verifier (counterpart of
icicle_tpu/ops/fri.py; reference F12: include/icicle/fri/* with the CPU
prover in backend/cpu/include/cpu_fri_backend.h). folding_factor = 2.

Prover. Each commit round builds the round's Merkle tree over the
codeword on its device (one `hash_words` a layer: kernel K1 for the
default Keccak-256 layers) and folds it with kernel K2
(kernels/fri_kernel.py `fri_fold`), reading w^-i from the first round's
inverse-twiddle table at stride 2^r instead of the JAX package's Python
loop over w^-i each round. The codewords stay on the device: the query
phase gathers, for each round, every query's rows of every tree layer in
one device gather and one copy (`_round_proofs`), the proofs equal to
`MerkleTree.get_merkle_proof`'s. With the default host Keccak-256, the
proof of work is the host library's grind from nonce 0 (`host_pow`),
which finds the same nonce as the loop over nonces. The fold goes through
the dispatcher's api "fri_fold" (backend "cuda": kernel K2, "torch": its
plain version `fri_fold_ref`), the hashes through theirs, both with
`FriConfig.backend`.

Transcript bytes are the reference's (fri_transcript.h):
  entry_0 = domain_sep_label || u32(log_input_size) || public_state
  alpha_0 = H(entry_0 || seed || challenge_label || commit_label || root_0)
  alpha_i = H(entry_0 || alpha_{i-1} || challenge_label || commit_label || root_i)
  pow:     challenge = entry_0 || alpha_last || nonce_label; the hash input
           appends u64(nonce) and 24 zero bytes; the digest's first 8 bytes,
           little-endian, must be < 2^(64 - pow_bits)
  queries: seed = the first 8 bytes of H(entry_0 || nonce_label ||
           u32(nonce)) (or H(entry_0 || alpha_last) without pow), truncated
           to u32, into std::mt19937 and libstdc++'s
           uniform_int_distribution (replicated here bit for bit).
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import Callable

import numpy as np
import torch

from icicle_tpu_torch.fields.field import Field
from icicle_tpu_torch.kernels import fri_kernel
from icicle_tpu_torch.ops.hash.hash import Hash
from icicle_tpu_torch.ops.merkle import MerkleProof, MerkleTree
from icicle_tpu_torch.ops.ntt import ntt_init_domain
from icicle_tpu_torch.runtime import dispatcher
from icicle_tpu_torch.runtime.config import FriConfig, MerkleTreeConfig
from icicle_tpu_torch.utils import native as _native

__all__ = ["MT19937", "uniform_int", "FriConfig", "FriTranscriptConfig", "FriProof",
           "FriTranscript", "fri_prove", "fri_verify"]

FOLD_API = "fri_fold"


# -- std::mt19937 + libstdc++ uniform_int_distribution replica -----------------

class MT19937:
    """std::mt19937 with the single-u32 seed init (Knuth multiplier)."""

    def __init__(self, seed: int):
        self.mt = [0] * 624
        self.mt[0] = seed & 0xFFFFFFFF
        for i in range(1, 624):
            self.mt[i] = (1812433253 * (self.mt[i - 1] ^ (self.mt[i - 1] >> 30)) + i) & 0xFFFFFFFF
        self.idx = 624

    def _gen(self):
        for i in range(624):
            y = (self.mt[i] & 0x80000000) | (self.mt[(i + 1) % 624] & 0x7FFFFFFF)
            nxt = self.mt[(i + 397) % 624] ^ (y >> 1)
            if y & 1:
                nxt ^= 0x9908B0DF
            self.mt[i] = nxt
        self.idx = 0

    def next_u32(self) -> int:
        if self.idx >= 624:
            self._gen()
        y = self.mt[self.idx]
        self.idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y


def uniform_int(gen: MT19937, lo: int, hi: int) -> int:
    """libstdc++ std::uniform_int_distribution<size_t> over a 32-bit urng
    when the range fits (the FRI case: hi - lo < 2^32)."""
    urngrange = 0xFFFFFFFF
    urange = hi - lo
    assert urange < urngrange, "range too large for this replica"
    uerange = urange + 1
    scaling = urngrange // uerange
    past = uerange * scaling
    while True:
        r = gen.next_u32()
        if r < past:
            return lo + r // scaling


# -- configs / proof -------------------------------------------------------------

@dataclasses.dataclass
class FriTranscriptConfig:
    """Mirror of fri_transcript_config.h (defaults: keccak-256 on the host,
    empty labels)."""
    domain_separator_label: bytes = b""
    round_challenge_label: bytes = b""
    commit_phase_label: bytes = b""
    nonce_label: bytes = b""
    public_state: bytes = b""
    seed: int = 0
    hasher: Callable[[bytes], bytes] = _native.keccak_256


def _elem_bytes(f: Field) -> int:
    return max(f.nlimbs, 1) * 4


@dataclasses.dataclass
class FriProof:
    """Mirror of FriProof<F>: per query and round a pair of Merkle proofs
    (the query's and its symmetric element's), the final polynomial and the
    pow nonce. The roots ride inside the Merkle proofs."""
    query_proofs: list[list[tuple[MerkleProof, MerkleProof]]]  # [query][round]
    final_poly: list[int]
    pow_nonce: int

    @property
    def nof_rounds(self) -> int:
        return len(self.query_proofs[0]) if self.query_proofs else 0

    def round_root(self, round_idx: int) -> np.ndarray:
        return self.query_proofs[0][round_idx][0].root

    def serialize(self, f: Field) -> bytes:
        """The reference's BinarySerializer<FriProof> layout
        (fri_proof_serializer.h): u64 nof_query_rows (2 nof_queries; row 2q
        the query proofs, row 2q + 1 the symmetric ones), each row u64
        nof_rounds and that many MerkleProofs; u64 final_poly_size and the
        raw elements; u64 pow_nonce."""
        eb = _elem_bytes(f)
        out = bytearray(struct.pack("<Q", 2 * len(self.query_proofs)))
        for per_round in self.query_proofs:
            for slot in range(2):
                out += struct.pack("<Q", len(per_round))
                for pair in per_round:
                    out += pair[slot].serialize()
        out += struct.pack("<Q", len(self.final_poly))
        for v in self.final_poly:
            out += int(v).to_bytes(eb, "little")
        out += struct.pack("<Q", self.pow_nonce)
        return bytes(out)

    @classmethod
    def deserialize(cls, f: Field, data: bytes) -> "FriProof":
        eb = _elem_bytes(f)
        off = 0
        (nrows,) = struct.unpack_from("<Q", data, off)
        off += 8

        def read_proof():
            nonlocal off
            _pruned, _idx, nleaf = struct.unpack_from("<BQQ", data, off)
            ln = struct.calcsize("<BQQ") + nleaf
            (nroot,) = struct.unpack_from("<Q", data, off + ln)
            ln += 8 + nroot
            (npath,) = struct.unpack_from("<Q", data, off + ln)
            ln += 8 + npath
            p = MerkleProof.deserialize(data[off:off + ln])
            off += ln
            return p

        rows = []
        for _ in range(nrows):
            (nr,) = struct.unpack_from("<Q", data, off)
            off += 8
            rows.append([read_proof() for _ in range(nr)])
        qps = [[(rows[2 * q][r], rows[2 * q + 1][r]) for r in range(len(rows[2 * q]))]
               for q in range(nrows // 2)]
        (nf,) = struct.unpack_from("<Q", data, off)
        off += 8
        final = [int.from_bytes(data[off + i * eb:off + (i + 1) * eb], "little")
                 for i in range(nf)]
        off += nf * eb
        (nonce,) = struct.unpack_from("<Q", data, off)
        return cls(qps, final, nonce)


class FriTranscript:
    """Byte-exact mirror of FriTranscript<F> (fri_transcript.h)."""

    def __init__(self, f: Field, cfg: FriTranscriptConfig, log_input_size: int):
        self.f = f
        self.eb = _elem_bytes(f)
        self.cfg = cfg
        self.entry_0 = (cfg.domain_separator_label + np.uint32(log_input_size).tobytes()
                        + cfg.public_state)
        self.prev_alpha = 0
        self.pow_nonce = 0

    def _field_bytes(self, v: int) -> bytes:
        return (v % self.f.modulus).to_bytes(self.eb, "little")

    def get_alpha(self, merkle_root: bytes, is_first_round: bool) -> int:
        cfg = self.cfg
        hi = bytearray(self.entry_0)
        hi += self._field_bytes(cfg.seed if is_first_round else self.prev_alpha)
        hi += cfg.round_challenge_label
        hi += cfg.commit_phase_label
        hi += merkle_root
        digest = cfg.hasher(bytes(hi))
        self.prev_alpha = int.from_bytes(digest, "little") % self.f.modulus
        return self.prev_alpha

    def _pow_challenge(self) -> bytes:
        return self.entry_0 + self._field_bytes(self.prev_alpha) + self.cfg.nonce_label

    def solve_pow(self, pow_bits: int) -> int:
        """The first nonce from 0 that solves the challenge: the host
        library's grind for the default Keccak-256, else a loop."""
        challenge = self._pow_challenge()
        if self.cfg.hasher is _native.keccak_256:
            found, nonce, _ = _native.host_pow("keccak_256", challenge, pow_bits)
            assert found
            return nonce
        threshold = 1 << (64 - pow_bits)
        nonce = 0
        while True:
            digest = self.cfg.hasher(challenge + nonce.to_bytes(8, "little") + b"\x00" * 24)
            if int.from_bytes(digest[:8], "little") < threshold:
                return nonce
            nonce += 1

    def verify_pow(self, nonce: int, pow_bits: int) -> bool:
        digest = self.cfg.hasher(self._pow_challenge() + nonce.to_bytes(8, "little")
                                 + b"\x00" * 24)
        return int.from_bytes(digest[:8], "little") < (1 << (64 - pow_bits))

    def set_pow_nonce(self, nonce: int):
        self.pow_nonce = nonce

    def rand_queries(self, nof_queries: int, lo: int, hi: int, use_pow: bool) -> list[int]:
        if use_pow:
            hi_bytes = (self.entry_0 + self.cfg.nonce_label
                        + np.uint32(self.pow_nonce & 0xFFFFFFFF).tobytes())
        else:
            hi_bytes = self.entry_0 + self._field_bytes(self.prev_alpha)
        digest = self.cfg.hasher(hi_bytes)
        gen = MT19937(int.from_bytes(digest[:8], "little") & 0xFFFFFFFF)
        return [uniform_int(gen, lo, hi) for _ in range(nof_queries)]


# -- prover --------------------------------------------------------------------

def _make_round_trees(leaves_hash: Hash, compress_hash: Hash, elem_words: int,
                      log_input_size: int) -> list[MerkleTree]:
    """Per-round arity-2 trees (fri.cpp:347-352: layer 0 the leaves hash,
    then log2(size) compression layers; each round drops the top layer)."""
    trees = []
    for r in range(log_input_size):
        hashers = [leaves_hash.with_input_words(elem_words)]
        hashers += [compress_hash.with_input_words(2 * leaves_hash.digest_words)
                    for _ in range(log_input_size - r)]
        trees.append(MerkleTree(hashers, elem_words))
    return trees


def _round_proofs(tree: MerkleTree, leaf_idxs: list[int]) -> list[MerkleProof]:
    """Full (unpruned) proofs of the leaves `leaf_idxs` of a built tree, as
    `tree.get_merkle_proof(tree.layers[0], i, pruned=False)` gives them:
    every layer's groups of all the leaves in one device gather, and one
    copy to the host."""
    dev = tree.layers[0].device
    idx = np.asarray(leaf_idxs, dtype=np.int64)
    parts, widths = [tree.layers[0][torch.from_numpy(idx).to(dev)]], []
    for i, arity in enumerate(tree.arities):
        layer = tree._layer(i)
        rows = (idx // arity * arity)[:, None] + np.arange(arity)
        group = layer[torch.from_numpy(rows.reshape(-1)).to(dev)]
        parts.append(group.reshape(len(idx), -1))
        widths.append(parts[-1].shape[1])
        idx = idx // arity
    words = torch.cat(parts, dim=1).cpu().numpy().view(np.uint32)
    root = tree.get_root()
    bounds = np.cumsum([parts[0].shape[1]] + widths)
    proofs = []
    for k, leaf_idx in enumerate(leaf_idxs):
        row = words[k]
        path = [row[a:b].copy() for a, b in zip(bounds[:-1], bounds[1:])]
        proofs.append(MerkleProof(leaf=row[:bounds[0]].copy(), leaf_idx=int(leaf_idx),
                                  root=root, path=path, pruned=False))
    return proofs


def fri_prove(f: Field, evals: torch.Tensor, cfg: FriConfig,
              transcript_cfg: FriTranscriptConfig, leaves_hash: Hash, compress_hash: Hash,
              timings: dict | None = None) -> FriProof:
    """Prove proximity of `evals` ((2^k,)+lim canonical evaluations on the
    2^k roots of unity, natural order) to a polynomial of degree <=
    stopping_degree, on evals' device. `timings`, if given, receives the
    host-clock ms of the commit phase (to the final polynomial on the
    host), the proof of work and the query phase."""
    assert cfg.folding_factor == 2, "reference supports folding_factor=2 only"
    clock = time.perf_counter()
    n = evals.shape[0]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    final_size = cfg.stopping_degree + 1
    log_final = final_size.bit_length() - 1
    assert 1 << log_final == final_size, "stopping_degree+1 must be pow2"
    nof_rounds = log_n - log_final

    elem_words = max(f.nlimbs, 1)
    trees = _make_round_trees(leaves_hash, compress_hash, elem_words, log_n)[:nof_rounds]
    tr = FriTranscript(f, transcript_cfg, log_n)
    inv_tw = ntt_init_domain(f, log_n, evals.device).twiddles_inv if nof_rounds else None
    tree_cfg = MerkleTreeConfig(backend=cfg.backend)

    cur = evals
    for r in range(nof_rounds):
        root = trees[r].build(cur.reshape(cur.shape[0], elem_words), tree_cfg)
        alpha = tr.get_alpha(root.astype("<u4").tobytes(), r == 0)
        cur = dispatcher.dispatch(FOLD_API, cfg.backend, cur)(f, cur, alpha, inv_tw, 1 << r)
    final_poly = [int(v) for v in np.atleast_1d(f.to_ints(cur))]

    def lap(key: str) -> None:
        nonlocal clock
        now = time.perf_counter()
        if timings is not None:
            timings[key] = (now - clock) * 1e3
        clock = now

    lap("commit_ms")
    pow_nonce = 0
    if cfg.pow_bits:
        pow_nonce = tr.solve_pow(cfg.pow_bits)
        tr.set_pow_nonce(pow_nonce)
    lap("pow_ms")

    queries = tr.rand_queries(cfg.nof_queries, final_size, n, cfg.pow_bits != 0)
    per_round = []
    for r in range(nof_rounds):
        size = 1 << (log_n - r)
        idxs = [q % size for q in queries] + [(q + size // 2) % size for q in queries]
        per_round.append(_round_proofs(trees[r], idxs))
    nq = len(queries)
    query_proofs = [[(per_round[r][i], per_round[r][nq + i]) for r in range(nof_rounds)]
                    for i in range(nq)]
    lap("query_ms")
    return FriProof(query_proofs, final_poly, pow_nonce)


# -- verifier (mirror of src/fri/fri.cpp:41-320) ---------------------------------

def fri_verify(f: Field, proof: FriProof, cfg: FriConfig,
               transcript_cfg: FriTranscriptConfig, leaves_hash: Hash,
               compress_hash: Hash) -> bool:
    p = f.modulus
    final_size = cfg.stopping_degree + 1
    if len(proof.final_poly) != final_size:
        return False
    nof_rounds = proof.nof_rounds
    log_n = nof_rounds + (final_size.bit_length() - 1)
    n = 1 << log_n
    elem_words = max(f.nlimbs, 1)
    trees = _make_round_trees(leaves_hash, compress_hash, elem_words, log_n)[:nof_rounds]

    tr = FriTranscript(f, transcript_cfg, log_n)
    alphas = [tr.get_alpha(proof.round_root(r).astype("<u4").tobytes(), r == 0)
              for r in range(nof_rounds)]

    if cfg.pow_bits:
        if not tr.verify_pow(proof.pow_nonce, cfg.pow_bits):
            return False
        tr.set_pow_nonce(proof.pow_nonce)

    queries = tr.rand_queries(cfg.nof_queries, final_size, n, cfg.pow_bits != 0)
    w_inv = pow(f.omega(log_n), -1, p)
    inv2 = pow(2, -1, p)

    def words_to_int(words: np.ndarray) -> int:
        return sum(int(w) << (32 * i) for i, w in enumerate(words.astype(np.uint64)))

    for qi, q in enumerate(queries):
        for r in range(nof_rounds):
            round_size = 1 << (log_n - r)
            elem_idx = q % round_size
            elem_idx_sym = (q + round_size // 2) % round_size
            pr, prs = proof.query_proofs[qi][r]
            # index consistency (fri.cpp:156-176)
            if pr.leaf_idx != elem_idx or prs.leaf_idx != elem_idx_sym:
                return False
            # every query proof commits to the root the transcript saw
            if not np.array_equal(pr.root, proof.round_root(r)) or \
               not np.array_equal(prs.root, proof.round_root(r)):
                return False
            if not trees[r].verify(pr) or not trees[r].verify(prs):
                return False
            # collinearity (fri.cpp:192-236)
            lv, lvs = words_to_int(pr.leaf), words_to_int(prs.leaf)
            l_even = (lv + lvs) * inv2 % p
            l_odd = (lv - lvs) * inv2 % p * pow(w_inv, elem_idx * (1 << r), p) % p
            folded = (l_even + alphas[r] * l_odd) % p
            if r == nof_rounds - 1:
                if proof.final_poly[q % final_size] % p != folded:
                    return False
            elif words_to_int(proof.query_proofs[qi][r + 1][0].leaf) % p != folded:
                return False
    return True


dispatcher.register_impl(FOLD_API, dispatcher.TORCH, fri_kernel.fri_fold_ref)
dispatcher.register_impl(FOLD_API, dispatcher.CUDA, fri_kernel.fri_fold)
