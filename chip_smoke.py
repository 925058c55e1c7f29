"""Smoke test of the PyTorch/CUDA port (icicle_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a Hopper card (sm_90a), the
CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):
  1. card    -- nvidia-smi name and power limit, torch's device name;
  2. build   -- every kernel library from icicle_tpu_torch/kernels/csrc, one
               nvcc per source, all in parallel, with the compiler's report
               (registers, stack, spills);
  3. kernels -- each kernel against its plain torch version on the card,
               bit-exact, at the lane widths the main paths give it: dif_rows
               (NTT; every pass of the 2^26, 2^25, 2^24 and 2^16 NTTs and a
               log N 14 pass, each in all four layouts: rows or columns in,
               rows or columns out; then its tile heights TR timed at
               (8192, 2^13), and pass A's column reads against the
               transpose they replace), prefix_scan (MSM B3, C = 4096 lanes), ec_reduce (B4,
               2048, 3072 and 24 lanes; v2's 3712 and 29), prefix_scan_r12 (B5, 4096 lanes),
               suffix_fold (B6, 8192 lanes: random flags with dummy slots
               and run ends inside K, and v2's stream of sorted keys with a
               dummy slot a key) and bucket_accum (B7,
               12 windows x 1024 lanes). The MSM kernels' serial depth is
               cut for the comparison (K = 64, R = 64), since their plain
               versions are Python loops over it; B3-B6, which split that
               axis into segments, are also compared at a ragged depth
               (61) and against their serial plain version (segments=1) as
               projective points, B3 and B4 at full depth; then each
               kernel is timed alone at full depth, B3-B6 also at other
               segment counts, and B5 and B6
               at their plan are held against themselves at _segments=1 as
               projective points. Median ms from CUDA events beside the plain
               version's ms and the bound; then poseidon2 (the Poseidon2
               hash, no Pallas counterpart) against `hash_fields_ref` at
               every compiled instance, with rows of 0 and p - 1: batch
               2^16 for babybear, koalabear and m31 at every width, their
               sponge and a domain tag; 2^12 for the 8-limb fields
               (bn254_scalar, bls12_377_scalar, stark252 every width,
               grumpkin_scalar, bls12_381_scalar); then timed alone at the
               2^29 tree's leaf layer (babybear t = 2, batch 2^28);
  4. NTT     -- the NTT main path through icicle_tpu_torch.ntt on CUDA
               tensors: babybear 2^26, koalabear 2^24, babybear 2^16,
               forward and inverse. Forward must equal the kernel-free
               `_ntt_torch` on the card, inverse must give the input back,
               and each NTT must launch the DIF kernel twice; then a
               torch.profiler breakdown of device time by kernel for one
               forward and one inverse babybear NTT at 2^26 and 2^16, each
               of which must run two dif_rows launches and no other kernel;
  5. MSM     -- four routes of the bn254 G1 MSM on CUDA tensors, each through
               its entry point: the v3 pipeline (msm_affine; engine "u32",
               B3 + B4), v3 with engine "r12" (msm_affine under
               ICICLE_TPU_MSM_ENGINE=r12; B5 + B4), the v2 pipeline
               (msm_affine under ICICLE_TPU_MSM_PIPELINE=v2; B6, which
               calls B4 once, + B4) at
               2^24 with bench.py's inputs (one repeated point, so the
               answer is (sum of scalars) * P), and the v1 pipeline
               (msm_tpu, 1024 lanes; B7) at 2^20 with the same kind of
               inputs. Each must launch exactly the kernels its plan gives
               (counted) and equal the oracle; then points/s (host clock to
               synchronize, median of 3 after a warm-up: v3 over prepared
               bases, v2 and v1 over device-resident points, as bench.py
               times them); then each route on 2^16 distinct points
               (P_i = (i+1) P against (sum (i+1) s_i) P); torch.profiler
               breakdowns of one 2^24 MSM of the u32, r12 and v2 routes
               and one 2^20 MSM of the v1 route;
  6. Merkle  -- the Poseidon2 Merkle main path: MerkleTree([Poseidon2(babybear,
               2)] * 29) over bench.py's 2^29 leaves (bench.py:226-276),
               uploaded once; 29 poseidon2 launches a build and no other
               device kernel (counted and profiled); leaves/s on the host
               clock from build() to get_root() returning, median of 3
               after a warm-up; every layer checked at 4096 sampled
               parents against the plain version on the card; pruned and
               full proofs of 10 leaves verify, and fail with the leaf
               flipped; then 2^22 leaves (binary), 2^20 (Poseidon2 t = 4,
               arity 4) and a 2^12-leaf bn254_scalar tree, each equal,
               root and every layer, to the same build with backend
               "torch" (the plain version) on the card;
  7. FRI     -- fri_prove over 2^22 babybear evaluations (the port's forward
               NTT of a degree < 2^20 polynomial from default_rng(0)) with
               the reference's defaults and Keccak-256 layers: exactly 22
               fri_fold and 275 keccak launches, the proof verifies and a
               flipped leaf word is refused, every round's fold equals
               fri_fold_ref on the card, round 0's root the keccak_ref
               tree's; host-clock ms of the commit phase, the proof of work
               and the query phase (median of 3 after a warm-up), the
               proof's bytes, a profile; at 2^16 the serialized proof
               equals the one made with every kernel's plain version;
  8. sumcheck -- sumcheck_prove of AB_MINUS_C over 3 MLEs of 2^24 and of
               EQ_X_AB_MINUS_C over 4 of 2^22 (default_rng(0)), the claimed
               sum from execute_program (K4) and vector_sum, held to numpy:
               one program launch and two sumcheck_round launches a round
               (the round pass and the reduction of its partials), the proof
               verifies and a tampered round is refused, every round
               polynomial equals the plain path's; host-clock ms, a profile;
  9. field layer -- the NTT over goldilocks and 8-limb fields through
               icicle_tpu_torch.ntt on CUDA tensors: goldilocks 2^24
               (forward, inverse, a coset forward), bn254_scalar 2^22,
               stark252 and bls12_381_scalar 2^16; each NTT exactly two
               dif_rows_wide launches (counted), the forward equal to
               `_ntt_torch` on the card (at full size; bn254_scalar also at
               2^18), the inverse giving the input back, host-clock ms and
               butterflies/s, a profile of the two large forwards; then
               MerkleTree([Poseidon2(goldilocks, 2)] * 28, leaf_words=2) over
               2^28 leaves (2 GiB, the 2^29 babybear tree's bytes): 28
               poseidon2 launches and no other device kernel (counted and
               profiled), leaves/s, every layer at 4096 sampled parents
               against the plain version, proofs verify and fail flipped;
               then polynomials: a bn254_scalar Polynomial of 2^20
               coefficients times another (three 2^21 NTTs, 6 dif_rows_wide
               launches), a(r) b(r) == (ab)(r) at a random r by Python-int
               Horner on the host, divide_by_vanishing of q (x^N - 1) giving
               q back, eval_on_rou_domain of the product equal to the
               factors' evaluations multiplied; and a babybear multiply of
               2^21 x 2^21 (2^22 NTTs, 6 dif_rows launches), checked the
               same way;
  10. hashes -- P1: MerkleTree([Poseidon(bls12_381_scalar, 9,
               domain_tag=0)] * 8, leaf_words=8) over 2^24 leaves of 32
               bytes (the arity-8 tree Filecoin builds over a 512 MiB
               sector): 8 poseidon launches (counted, profiled), the build
               and its leaf layer timed, every layer at 4096 sampled parents
               against the plain version, proofs verify and fail flipped;
               the same tree shape over babybear; P2: binary Blake2s and
               Blake3 trees over 2^26 leaves of 32 bytes, 26 launches each,
               checked and timed the same way; P3: Blake3 over 2^14
               messages of 8 KiB, a chunk pass and 3 parent levels (4
               blake3 launches), equal to blake3_ref; P4: phase 7's FRI
               path over Blake3 round trees (22 fri_fold, 275 blake3
               launches; the replayed folds and round 0's root against
               blake3_ref's), at 2^10 byte-identical to the plain
               versions' proof;
  11. the main paths' JSON line (per-path launches, times, profiles,
     seconds a phase);
  12. the kernels JSON line; 13. the result JSON line, last.

Phase 3 also holds dif_rows_wide (the NTT row kernel for goldilocks and
8-limb fields, kernels/csrc/ntt_wide.cu) to dif_rows_wide_ref in both
instances: the passes of the goldilocks 2^24 and bn254_scalar 2^22 NTTs
in all four layouts, with and without the factor, 64 sampled rows (and
rows 0, 1 and the last) of each full-length pass compared, 0 and p - 1
among the inputs; and both passes of a whole 2^16 NTT for every 8-limb
field; the goldilocks poseidon2 instances at every width (batch 2^16,
one permutation, the sponge and a domain tag) against hash_fields_ref, and
t = 2 timed at the 2^28 tree's leaf layer. A goldilocks multiply counts as
8 integer multiplies (four 32 x 32 products, low and high words; no m p
terms), and goldilocks converts nothing into or out of Montgomery form.

Phase 3 also holds the protocol kernels to their plain versions, bit for
bit: keccak (all four variants, hash_words of 1, 8, 16, 34 and 35 words
at 2^16 rows, hash_bytes of 0-300 bytes against the host library and
hashlib; timed at the FRI round-0 leaf and compress layers), fri_fold
(babybear, koalabear, 2^22 -> 2^21 and a strided round, with 0 and p - 1
among the inputs), sumcheck_round and program (babybear, koalabear, m31
at 2^20: AB_MINUS_C, EQ_X_AB_MINUS_C, a lambda with a constant and an
inverse, zero inputs, with and without the fold; a program whose outputs
are not the tail parameters), both also checked and timed at the 2^24
prove's shapes (rounds 0 and 1, and the claimed sum's program).

Phase 3 also holds the hash kernels to their plain versions, bit for bit:
poseidon (kernels/csrc/poseidon.cu, poseidon_limbs.cu) at every
single-word instance and every 8-limb one (POSEIDON_CHECKS), with and
without a domain tag and at a ragged batch, rows of 0 and p - 1 among the
inputs, and timed alone at babybear t = 9 with a tag over 2^24 hashes;
blake2s (blake2s.cu) at 0, 1, 8, 16, 17 and 40 words and 13 and 130 bytes,
also against hashlib; blake3 (blake3.cu) at 0, 4, 64, 65, 1024, 1025,
3072, 4096 and 5120 bytes (5120: five chunks, an odd chaining value carried
up a level). A Poseidon hash counts poseidon_kernel.needed_monts Montgomery
multiplies; a BLAKE compression its integer instructions, the non-adds on
the ALU pipe (64 lanes a clock an SM) and all of them through the
schedulers (128), its adds free to issue on the FMA pipe as IMAD.IADD.

Launch counts: every kernel's count is set to 0 just before each checked
main-path call (one NTT forward + inverse, one MSM, one Merkle build, one
FRI prove, one claimed sum and sumcheck prove; one limb-field NTT forward +
inverse or coset forward, one goldilocks build, one polynomial product; one
oct-tree, Blake tree, long-message Blake3 hash or Blake3 FRI prove) and
read just after it; timing and profiling calls are not counted. A profile
counts its kernels from the host's launch calls, which it always records;
the device activities it keeps give the breakdown by kernel and can miss
some (see device_profile).

Bounds: the least time for the same work is the larger of the bytes the
call must move (each input read once, each output written once) over
3.35 TB/s, and its 32-bit integer multiplies over 16.7 T/s (H100 SXM:
132 SMs x 64 INT32 lanes x 1.98 GHz; half the FP32 lanes that give the
data sheet's 67 TFLOP/s). A one-word Montgomery multiply counts as three
integer multiplies (a*b wide, m = lo*inv32, m*p wide); an L-limb one as
4 L^2 + L (a*b and m*p, low and high words, and the L words of m): 264 at
L = 8. A mixed add (B3's slot, B7's slot) is 11 such multiplies and a
projective add (B4's row) 12, plus two multiplies by b3 = 3b each: add
chains with no integer multiply where b3 is a small integer (bn254: 9,
grumpkin: -51), as in the kernels and the Pallas bodies, else two more
Montgomery multiplies. B6 counts its own work on the run's flags: a
mixed add per real slot and a projective add per run end, the real slots'
points and every flag read (the Pallas body's both adds on every slot, the
figure before the split, is printed beside it). B5 computes B3's function, so
its bound is B3's; its own radix-12
multiply count (11 multiplies of 2 nw^2 + nw = 990 at nw = 22, plus 2 nw for
the two by b3) is printed beside it. B7 counts its own work on the run's
keys: a mixed add per slot that continues a run, every key and point read
and the rows it writes. A Poseidon2 hash counts the Montgomery multiplies
it needs (poseidon2_kernel.needed_monts): the S-boxes (x^alpha is 2, 3, 4,
4, 5 multiplies for alpha 3, 5, 7, 9, 11), the multiplies by constants of
M_ext and M_int that are not small integers (none in M_ext, t a partial
round in M_int at t >= 4), once a sponge block, plus one a word in and
one out of Montgomery form: babybear t = 2 is 192 + 3, 585 integer
multiplies. Beside it, the earlier bound, the plain version's
multiplies (its matrix products, the JAX body's): t^2 for the first M_ext,
per full round t S-boxes and t^2 for M_ext, per partial round one S-box
and t for M_int: babybear t = 2 is 292 + 3, 885 integer multiplies.

keccak is bound by the ALU pipe: keccak_kernel.PERMUTATION_OPS (4,309
three-input logic and shift instructions a permutation, counted from the
spec) a block, and an XOR a word absorbed into every block after the
first (the first is absorbed into a zero state, so it needs none), at 64
lanes a clock an SM x 132 SMs at nvidia-smi's max SM clock. fri_fold: n
words in, n / 2 twiddles, n / 2 out, two Montgomery multiplies an output. sumcheck_round: the MLEs in
(and the folded ones out), the fold's multiplies and deg + 1 combine
evaluations a pair at the program's multiplies (an inverse is 32
squarings and a multiply a set bit of p - 2); program: the parameters it
reads and its outputs, its multiplies an element.

The build report also gives the SASS instruction counts of the babybear
t = 2 single-permutation Poseidon2 kernel (kernels/sass.py over cuobjdump
-sass), its count per hash: the kernel has no loop; and those of the
Keccak-256 word-row kernel (one block's path and the loop around it).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
INT_MULS_PER_S = 132 * 64 * 1.98e9
MULS_PER_MONT = 3
REPS = 10
PROFILE_PAD_S = 1.0  # idle seconds before and after a profiled call, doubled a retry
PROFILE_TRIES = 3
PROFILE_KEPT = 0.99  # share of the launch calls a profile must keep, else retried
# the CUDA activity alone: it brings the device activities and the host's
# CUDA runtime calls that start them; the CPU activity's operator events add
# nothing a profile reads and cost its parsing about 0.4 ms a launch
PROFILE_ACTIVITIES = (torch.profiler.ProfilerActivity.CUDA,)
GL64_MULS = 8     # a goldilocks multiply: four 32x32 products, low and high words
MADD_MONTS = 11   # RCB15 Alg 8, not counting its two multiplies by b3
PADD_MONTS = 12   # RCB15 Alg 7, likewise


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median ms of fn() over `reps` runs after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 5):
    """(median ms of fn() + synchronize() on the host clock after a warm-up,
    the last call's result)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def dif_rows_bound(rows: int, log_n: int, factor: bool) -> tuple[float, str]:
    n = 1 << log_n
    # x and out (+ factor), plus the (log_n, N) stage-twiddle table
    nbytes = rows * n * 4 * (3 if factor else 2) + log_n * n * 4
    monts = rows * (log_n * n // 2 + (n if factor else 0))
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = monts * MULS_PER_MONT / INT_MULS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def bound(nbytes: float, muls: float) -> tuple[float, str]:
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = muls / INT_MULS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def big_mont_muls(nl: int) -> int:
    return 4 * nl * nl + nl


def add_muls(curve, monts: int) -> int:
    """Integer multiplies of one curve add of `monts` Montgomery multiplies
    plus two by b3 (none when b3 is a small integer: an add chain)."""
    from icicle_tpu_torch.kernels.msm_lib import b3_small
    b3_monts = 0 if b3_small(curve) is not None else 2
    return (monts + b3_monts) * big_mont_muls(curve.fq.nlimbs)


def prefix_scan_bound(K: int, C: int, curve) -> tuple[float, str]:
    return bound(K * C * 5 * curve.fq.nlimbs * 4, K * C * add_muls(curve, MADD_MONTS))


def ec_reduce_bound(R: int, C: int, curve) -> tuple[float, str]:
    return bound((R + 1) * C * 3 * curve.fq.nlimbs * 4, R * C * add_muls(curve, PADD_MONTS))


def suffix_fold_bound(flags: torch.Tensor, curve) -> tuple[float, str]:
    """B6's own work on these flags: a mixed add per real slot (bit 0) and a
    projective add per run end (bit 1); the real slots' points and every
    flag read, D written."""
    nl = curve.fq.nlimbs
    K, C = flags.shape
    real = int(((flags & 1) != 0).sum())
    ends = int(((flags & 2) != 0).sum())
    return bound((real * 2 * nl + K * C + 3 * nl * C) * 4,
                 real * add_muls(curve, MADD_MONTS) + ends * add_muls(curve, PADD_MONTS))


def suffix_fold_bound_all_slots(K: int, C: int, curve) -> tuple[float, str]:
    """The bound of the Pallas body's work, both adds on every slot (the
    figure before the split, kept for continuity)."""
    nl = curve.fq.nlimbs
    return bound((K * (2 * nl + 1) + 3 * nl) * C * 4,
                 K * C * (add_muls(curve, MADD_MONTS) + add_muls(curve, PADD_MONTS)))


def bucket_accum_bound(keys: torch.Tensor, curve) -> tuple[float, str]:
    """B7's own work on these keys: a mixed add per slot that continues a
    run (a slot that starts one takes its point as it is); every key and
    point read, and the rows B7 writes (run ends and lane ends)."""
    from icicle_tpu_torch.kernels.msm_kernel import contract_rows
    nl = curve.fq.nlimbs
    slots = keys.numel()
    adds = int((keys[:, 1:] == keys[:, :-1]).sum())
    rows = int(contract_rows(keys).sum())
    return bound((slots * (1 + 2 * nl) + rows * 3 * nl) * 4, adds * add_muls(curve, MADD_MONTS))


SBOX_MONTS = {3: 2, 5: 3, 7: 4, 9: 4, 11: 5}


def poseidon2_plain_monts(h, n: int) -> int:
    """Montgomery multiplies of one hash of n inputs as the plain version
    (and the JAX body) compute it: with M_ext and M_int as matrix products
    (the earlier bound; see the module docstring); goldilocks converts
    nothing."""
    t, sbox = h.t, SBOX_MONTS[h.alpha]
    perm = t * t + 2 * h.half_full * (t * sbox + t * t) + h.partial_rounds * (sbox + t)
    tagged = h.domain_tag is not None
    perms = 1 if n == t - tagged else max(1, -(-(n - 1 + tagged) // (t - 1)))
    return perms * perm + (0 if is_goldilocks(h.field) else n + 1)


def is_goldilocks(f) -> bool:
    return f.modulus == (1 << 64) - (1 << 32) + 1


def field_muls(f) -> int:
    """32-bit integer multiplies of one field multiply: 3 for a one-word
    Montgomery multiply, GL64_MULS for goldilocks, 4 L^2 + L for L limbs."""
    if is_goldilocks(f):
        return GL64_MULS
    return MULS_PER_MONT if f.nlimbs == 1 else big_mont_muls(f.nlimbs)


def poseidon2_bound(h, batch: int, n: int, plain: bool = False) -> tuple[float, str]:
    """Rows in and digests out once, the Montgomery-form constants once, at
    3 (one word) or 4 L^2 + L (L limbs) integer multiplies a multiply; the
    multiplies the hash needs (poseidon2_kernel.needed_monts), or with
    `plain` the plain version's."""
    from icicle_tpu_torch.kernels.poseidon2_kernel import needed_monts
    nl = h.field.nlimbs
    c = h.constants("cpu")
    const_words = (c.rc.numel() + c.diag_m1.numel() + (c.mds.numel() if plain else 0)) // nl
    nbytes = (batch * (n + 1) + const_words) * nl * 4
    monts = poseidon2_plain_monts(h, n) if plain else needed_monts(h, n)
    return bound(nbytes, batch * monts * field_muls(h.field))


def r12_madd_muls(nw: int) -> int:
    """32-bit multiplies of one radix-12 mixed add: 11 Montgomery multiplies
    of 2 nw^2 + nw and two wordwise multiplies by b3."""
    return MADD_MONTS * (2 * nw * nw + nw) + 2 * nw


def kernel_counters() -> dict:
    """Each kernel's wrapper; its `launches` attribute counts its launches."""
    from icicle_tpu_torch.kernels import ec_reduce as TR
    from icicle_tpu_torch.kernels import msm_fold2 as TF
    from icicle_tpu_torch.kernels import msm_kernel as TK
    from icicle_tpu_torch.kernels import msm_scan as TS
    from icicle_tpu_torch.kernels import msm_scan_r12 as TS12
    from icicle_tpu_torch.kernels import ntt_kernel as K
    from icicle_tpu_torch.kernels import ntt_wide as NW
    from icicle_tpu_torch.kernels import blake2s_kernel as B2
    from icicle_tpu_torch.kernels import blake3_kernel as B3
    from icicle_tpu_torch.kernels import fri_kernel as FK
    from icicle_tpu_torch.kernels import keccak_kernel as KK
    from icicle_tpu_torch.kernels import poseidon2_kernel as PK
    from icicle_tpu_torch.kernels import poseidon_kernel as PSK
    from icicle_tpu_torch.kernels import program_kernel as PGK
    from icicle_tpu_torch.kernels import sumcheck_kernel as SK
    return {"dif_rows": K.dif_rows, "dif_rows_wide": NW.dif_rows_wide,
            "prefix_scan": TS.prefix_scan, "ec_reduce": TR.ec_reduce,
            "prefix_scan_r12": TS12.prefix_scan_r12, "suffix_fold": TF.suffix_fold,
            "bucket_accum": TK.bucket_accum, "poseidon2": PK.poseidon2, "keccak": KK.keccak,
            "fri_fold": FK.fri_fold, "sumcheck_round": SK.sumcheck_round,
            "program": PGK.execute_program_kernel, "poseidon": PSK.poseidon,
            "blake2s": B2.blake2s, "blake3": B3.blake3}


def counted(path: str, fn, launches: dict):
    """fn() with every kernel's count set to 0 just before it and read just
    after it, synchronised: launches[path] = {kernel: count}."""
    wrappers = kernel_counters()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches[path] = {name: w.launches for name, w in wrappers.items()}
    return out


MSM_24 = "msm bn254 2^24 (repeated point)"
MSM_16 = "msm bn254 2^16 (distinct points)"
R12_24 = "msm r12 bn254 2^24 (repeated point)"
R12_16 = "msm r12 bn254 2^16 (distinct points)"
V2_24 = "msm v2 bn254 2^24 (repeated point)"
V2_16 = "msm v2 bn254 2^16 (distinct points)"
V1_20 = "msm v1 bn254 2^20 (repeated point)"
V1_16 = "msm v1 bn254 2^16 (distinct points)"
NTT_MAIN = "ntt babybear 2^26 fwd+inv"
MERKLE_LOG = 29
MERKLE_MAIN = f"merkle babybear poseidon2 t=2 2^{MERKLE_LOG}"


def bench_scalars(rng, n: int) -> np.ndarray:
    """bench.py's scalars (bench.py:53-59): (n, 8) uint32 limbs, 62 random
    bits in limbs 0-1 and random words above (not reduced mod r)."""
    scal_ints = rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
    scal = np.zeros((n, 8), dtype=np.uint32)
    scal[:, 0] = scal_ints & 0xFFFFFFFF
    scal[:, 1] = scal_ints >> 32
    scal[:, 2:] = rng.integers(0, 2**32, size=(n, 6), dtype=np.uint32)
    return scal


# (kernel, depth, lanes, role, options); the plain side runs every one,
# once (its time from CUDA events around that call); the serial plain
# version (segments=1) of the split kernels, a Python loop over the whole
# depth, runs where the depth is at most SERIAL_DEPTH. Options: "stream"
# (B6's flags: "random", or "v2", v2's sorted keys with M dummy slots),
# "M", and the wrapper's keyword runs.
SERIAL_DEPTH = 128
V2_CUT = {"stream": "v2", "M": 16}   # v2's stream at a cut depth: 16 keys a lane
MSM_CHECKS = [
    ("prefix_scan", 64, 4096, "B3, one 2^24 window group, K cut from 8192", {}),
    ("prefix_scan", 61, 4096, "B3, K 61: ragged last segment", {}),
    ("prefix_scan", 8192, 64, "B3, one 2^16 window group at full depth", {}),
    ("prefix_scan", 8192, 4096, "B3, one 2^24 window group at full depth", {}),
    ("ec_reduce", 64, 2048, "B4, 2^24 cross-tile fold, R cut from 2048", {}),
    ("ec_reduce", 61, 2048, "B4, R 61: ragged and empty segments", {}),
    ("ec_reduce", 8, 3072, "B4, 2^24 bucket pass 1", {}),
    ("ec_reduce", 128, 24, "B4, 2^24 bucket pass 2", {}),
    ("ec_reduce", 64, 3712, "B4, v2 2^24 cross-tile pass 1", {}),
    ("ec_reduce", 128, 29, "B4, v2 2^24 cross-tile pass 2", {}),
    ("ec_reduce", 2048, 2048, "B4, 2^24 cross-tile fold at full depth", {}),
    ("prefix_scan_r12", 64, 4096, "B5, one r12 2^24 window group, K cut from 8192", {}),
    ("prefix_scan_r12", 61, 4096, "B5, K 61: ragged last segment", {}),
    ("suffix_fold", 64, 8192, "B6, one v2 2^24 window, K cut from 2304, random flags",
     {"stream": "random"}),
    ("suffix_fold", 61, 8192, "B6, K 61: ragged, random flags", {"stream": "random"}),
    ("suffix_fold", 64, 8192, "B6, K 64: v2's stream, M 16", dict(V2_CUT, runs=16)),
    ("suffix_fold", 61, 8192, "B6, K 61: v2's stream, M 16", dict(V2_CUT, runs=16)),
    ("bucket_accum", 64, 1024, "B7, one v1 2^20 chunk of 12 windows, K cut from 1024", {}),
    ("bucket_accum", 61, 1024, "B7, K 61: ragged last segment", {}),
]
# (kernel, depth, lanes, role, options): timed only; `_segments` times the
# split kernels at another split than their plan's;
# "serial": also the kernel at _segments=1, compared with the plan's
# output as projective points
V2_FULL = {"stream": "v2", "M": 256, "runs": 256}   # v2 2^24: T 2048 + M 256 slots
MSM_FULL = [
    ("prefix_scan", 8192, 4096, "B3 at full depth (12 per 2^24 MSM)", {}),
    ("prefix_scan", 8192, 4096, "B3 variant", {"_segments": 8}),
    ("prefix_scan", 8192, 4096, "B3 variant", {"_segments": 32}),
    ("ec_reduce", 2048, 2048, "B4 cross-tile at full depth (12 per 2^24 MSM)", {}),
    ("ec_reduce", 2048, 2048, "B4 variant", {"_segments": 8}),
    ("ec_reduce", 2048, 2048, "B4 variant", {"_segments": 16}),
    ("prefix_scan_r12", 8192, 4096, "B5 at full depth (12 per r12 2^24 MSM)",
     {"serial": True}),
    *[("prefix_scan_r12", 8192, 4096, "B5 variant", {"_segments": S}) for S in (4, 16, 32)],
    ("suffix_fold", 2304, 8192, "B6 at full depth (29 per v2 2^24 MSM)",
     dict(V2_FULL, serial=True)),
    *[("suffix_fold", 2304, 8192, "B6 variant", dict(V2_FULL, _segments=S)) for S in (8, 16, 32)],
    ("bucket_accum", 1024, 1024, "B7 at full depth (2 per v1 2^20 MSM)", {"serial": True}),
    *[("bucket_accum", 1024, 1024, "B7 variant", {"_segments": S}) for S in (1, 2, 8)],
]
SAME_POINTS_ROWS = 256   # rows of a (K, 3L, C) output compared at a time


def same_points(curve, a: torch.Tensor, b: torch.Tensor) -> bool:
    """a, b (..., 3L, C) projective limbs on the card, Montgomery in any
    domain, values below 4p: equal as projective points (X1 Z2 = X2 Z1,
    Y1 Z2 = Y2 Z1, X1 Y2 = X2 Y1 by the port's BigField, whose multiply
    gives canonical products of such values) and neither (0, 0, 0). A
    (K, 3L, C) pair is compared SAME_POINTS_ROWS rows at a time."""
    from icicle_tpu_torch.curves.group import get_group
    from icicle_tpu_torch.kernels.msm_lib import split_point
    if a.dim() == 3 and a.shape[0] > SAME_POINTS_ROWS:
        return all(same_points(curve, a[i:i + SAME_POINTS_ROWS], b[i:i + SAME_POINTS_ROWS])
                   for i in range(0, a.shape[0], SAME_POINTS_ROWS))
    m = get_group(curve.name).f.mul_mont
    nl = curve.fq.nlimbs
    (x1, y1, z1), (x2, y2, z2) = (split_point(t.transpose(-1, -2), nl) for t in (a, b))
    zero = any(bool(((x == 0) & (y == 0) & (z == 0)).all(-1).any())
               for x, y, z in ((x1, y1, z1), (x2, y2, z2)))
    return (not zero and torch.equal(m(x1, z2), m(x2, z1)) and torch.equal(m(y1, z2), m(y2, z1))
            and torch.equal(m(x1, y2), m(x2, y1)))


def check_msm_kernels(dev, gen, smi: str) -> dict:
    """B3-B7 against their plain versions on the card at the MSM routes'
    lane widths (serial depth cut for the plain side), then timed alone at
    full depth. B3-B6 take curve points (a pool of 64 multiples of the
    generator and their negatives; B4's projective, sums of two, with one
    row of identities; B5's in the R' domain) and are held bit-exact
    against their plain versions at the plan's segment count, and against
    the serial plain version (segments=1) as projective points; at full
    depth the kernel at its plan against itself at _segments=1, as points,
    and the split's variants timed beside the plan's. B6 takes random flags
    with dummy slots and run ends, a lane with none and a lane with one at
    every slot, or v2's stream (sorted keys, one dummy slot a key, as
    ops/msm_tpu2.py builds it). B7 takes pool points and keys sorted along
    each lane (a lane with one run over every slot, a lane that restarts at
    every slot; at full depth v1 2^20's layout of sorted keys), and is
    compared at the rows it promises (run ends and lane ends)."""
    from icicle_tpu_torch.curves.group import Affine, Projective, get_group
    from icicle_tpu_torch.curves.host_ec import ec_mul
    from icicle_tpu_torch.curves.params import get_curve
    from icicle_tpu_torch.kernels import ec_reduce as TR
    from icicle_tpu_torch.kernels import msm_fold2 as TF
    from icicle_tpu_torch.kernels import msm_kernel as TK
    from icicle_tpu_torch.kernels import msm_scan as TS
    from icicle_tpu_torch.kernels import msm_scan_r12 as TS12

    curve = get_curve("bn254")
    fq = curve.fq
    g = get_group("bn254")
    nl = fq.nlimbs
    W1 = 12   # windows per B7 launch at the v1 2^20 shape

    pool = [ec_mul((curve.gen_x, curve.gen_y), 0x5EED + 977 * i, fq.modulus) for i in range(64)]
    pool_x = fq.to_mont(fq.from_ints([p[0] for p in pool] * 2, dev))
    pool_y = fq.to_mont(fq.from_ints([p[1] for p in pool], dev))
    pool_y = torch.cat([pool_y, fq.neg(pool_y)])                  # P and -P
    # the same points in B5's R' = 2^(12 nw) domain, canonical
    rp = TS12.r12_engine("bn254").R % fq.modulus
    r12_x = fq.from_ints([p[0] * rp % fq.modulus for p in pool] * 2, dev)
    r12_y = fq.from_ints([p[1] * rp % fq.modulus for p in pool], dev)
    r12_y = torch.cat([r12_y, fq.neg(r12_y)])
    pair = torch.randint(0, 128, (2, 128), generator=gen, device=dev)
    one = g.one_mont(dev).expand(128, nl)
    pool_proj = torch.cat(list(g.madd(Projective(pool_x[pair[0]], pool_y[pair[0]], one),
                                      Affine(pool_x[pair[1]], pool_y[pair[1]]))), -1)

    def lane_major(t: torch.Tensor) -> torch.Tensor:
        """(D, C, rows) -> (D, rows, C) contiguous."""
        return t.transpose(1, 2).contiguous()

    def curve_affine(depth: int, lanes: int, xs=pool_x, ys=pool_y) -> torch.Tensor:
        """(depth, 2L, lanes) Montgomery x || y of pool points."""
        i = torch.randint(0, 128, (depth, lanes), generator=gen, device=dev)
        return lane_major(torch.cat([xs[i], ys[i]], -1))

    def curve_proj(depth: int, lanes: int) -> torch.Tensor:
        """(depth, 3L, lanes) projective pool points, Z != 1, row 2 the
        identity where depth > 2."""
        pts = pool_proj[torch.randint(0, 128, (depth, lanes), generator=gen, device=dev)]
        if depth > 2:
            pts[2] = torch.cat(list(g.identity((lanes,), dev)), -1)
        return lane_major(pts)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def fold_flags(depth: int, lanes: int) -> torch.Tensor:
        real = rand(depth, lanes) < 0.9                  # ~10% dummy slots
        dacc = rand(depth, lanes) < 0.12                 # ~1 run end in 8
        dacc[-1] = True
        dacc[:, 0] = False                               # a lane with no run end
        dacc[:, 1] = True                                # one ending a run every slot
        return (real.to(torch.int32) * TF.IS_REAL) | (dacc.to(torch.int32) * TF.IS_DACC)

    def v2_flags(depth: int, lanes: int, M: int) -> torch.Tensor:
        """v2's stream (ops/msm_tpu2.py group_fn): a lane's depth - M digits
        |d| in [0, M] and one dummy slot for each key 1..M, sorted by key
        descending, each key's dummy last; bit 0 on the digits, bit 1 at the
        last slot of each key >= 1: exactly M run ends a lane."""
        T = depth - M
        key = torch.cat([torch.randint(0, M + 1, (lanes, T), generator=gen, device=dev),
                         torch.arange(1, M + 1, device=dev).expand(lanes, M)], 1)
        dummy = torch.arange(depth, device=dev).expand(lanes, depth) >= T
        order = torch.sort(((M - key) << 1) | dummy.to(torch.int64), dim=1).indices
        skey, sdummy = key.gather(1, order), dummy.gather(1, order)
        nxt = torch.cat([skey[:, 1:], skey.new_full((lanes, 1), -1)], 1)
        flags = ((~sdummy).to(torch.int32) * TF.IS_REAL
                 | ((skey != nxt) & (skey >= 1)).to(torch.int32) * TF.IS_DACC)
        return flags.T.contiguous()

    def fold_inputs(d, c, stream="random", M=None):
        flags = fold_flags(d, c) if stream == "random" else v2_flags(d, c, M)
        return curve_affine(d, c), flags

    def sorted_keys(depth: int, lanes: int) -> torch.Tensor:
        """(W1, depth, lanes) keys: at a cut depth random in [0, 24), sorted
        along each lane, window 0's lane 0 one run over every slot and its
        lane 1 a new key at every slot; at full depth as v1 2^20 lays them
        out (the window's depth * lanes keys in [0, 2048] sorted, lane c
        holding positions c depth .. (c + 1) depth - 1)."""
        if depth == 1024:
            k = torch.randint(0, 2049, (W1, depth * lanes), generator=gen, device=dev)
            k = k.sort(dim=1).values.view(W1, lanes, depth).transpose(1, 2)
            return k.to(torch.int32).contiguous()
        k = torch.randint(0, 24, (W1, depth, lanes), generator=gen, device=dev)
        k = k.sort(dim=1).values.to(torch.int32)
        k[0, :, 0] = 7
        k[0, :, 1] = torch.arange(depth, device=dev, dtype=torch.int32)
        return k.contiguous()

    def accum_inputs(depth: int, lanes: int):
        """B7's keys and (W1, depth, 2L, lanes) curve points."""
        return sorted_keys(depth, lanes), torch.stack([curve_affine(depth, lanes)
                                                       for _ in range(W1)])

    def contract(out: torch.Tensor, args) -> torch.Tensor:
        """B7's output at the rows it promises, as (3L, rows)."""
        return out.transpose(2, 3)[TK.contract_rows(args[0])].T.contiguous()

    # name -> (kernel, plain version, inputs(depth, lanes, **options),
    # bound(depth, lanes, inputs), segment plan or None[, the compared part
    # of an output: view(out, inputs)])
    kernels = {
        "prefix_scan": (TS.prefix_scan, TS.prefix_scan_ref,
                        lambda d, c: (curve_affine(d, c),),
                        lambda d, c, a: prefix_scan_bound(d, c, curve), TS.scan_segments),
        "ec_reduce": (TR.ec_reduce, TR.ec_reduce_ref,
                      lambda d, c: (curve_proj(d, c),),
                      lambda d, c, a: ec_reduce_bound(d, c, curve), TR.reduce_segments),
        "prefix_scan_r12": (TS12.prefix_scan_r12, TS12.prefix_scan_r12_ref,
                            lambda d, c: (curve_affine(d, c, r12_x, r12_y),),
                            lambda d, c, a: prefix_scan_bound(d, c, curve), TS12.r12_segments),
        "suffix_fold": (TF.suffix_fold, TF.suffix_fold_ref, fold_inputs,
                        lambda d, c, a: suffix_fold_bound(a[1], curve), TF.fold_segments),
        "bucket_accum": (TK.bucket_accum, TK.bucket_accum_ref, accum_inputs,
                         lambda d, c, a: bucket_accum_bound(a[0], curve),
                         lambda d, c: TK.accum_segments(d, W1 * c), contract),
    }
    input_opts = ("stream", "M")
    r12_nw = TS12.r12_engine("bn254").nw
    rows = {name: [] for name in kernels}
    for name, depth, lanes, role, opts in MSM_CHECKS:
        fn, ref, make, bnd, plan, *part = kernels[name]
        view = part[0] if part else (lambda out, args: out)
        args = make(depth, lanes, **{k: v for k, v in opts.items() if k in input_opts})
        kw = {k: v for k, v in opts.items() if k not in input_opts}
        got = view(fn(curve, *args, **kw), args)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = ref(curve, *args, **kw)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        want = view(want, args)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"{name} != its plain version at {role}: max abs err {err}")
        row = {"role": role, "depth": depth, "lanes": lanes, "options": opts, "checked": True,
               "max_abs_diff": err}
        extra = ""
        if plan is not None:
            row["segments"] = plan(depth, lanes)
            extra = f", S {row['segments']}"
            if depth <= SERIAL_DEPTH:
                # the kernel's association against the serial fold, as points
                if not same_points(curve, got, view(ref(curve, *args, segments=1, **kw), args)):
                    raise AssertionError(f"{name} != its serial plain version (segments=1) "
                                         f"as projective points at {role}")
                row["serial_equal_as_points"] = True
                extra += ", == serial as points"
        kernel_ms = cuda_ms(lambda: fn(curve, *args, **kw))
        bound_ms, bound_by = bnd(depth, lanes, args)
        row.update(kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        rows[name].append(row)
        log(f"  {name:15s} {tuple(args[0].shape)} exact{extra}; kernel {kernel_ms:.4f} ms, "
            f"plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by})  [{role}]")
        del args, got, want
    for name, depth, lanes, role, opts in MSM_FULL:
        fn, _, make, bnd, plan, *part = kernels[name]
        view = part[0] if part else (lambda out, args: out)
        args = make(depth, lanes, **{k: v for k, v in opts.items() if k in input_opts})
        kw = {k: v for k, v in opts.items() if k not in input_opts + ("serial",)}
        kernel_ms = cuda_ms(lambda: fn(curve, *args, **kw), reps=3)
        bound_ms, bound_by = bnd(depth, lanes, args)
        row = {"role": role, "depth": depth, "lanes": lanes, "options": opts, "checked": False,
               "kernel_ms": kernel_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        extra = ""
        if plan is not None:
            row["segments"] = kw.get("_segments", plan(depth, lanes))
            extra = f", S {row['segments']}"
        if opts.get("serial"):
            # the plan's split against the serial kernel (the JAX order), as points
            if not same_points(curve, view(fn(curve, *args, **kw), args),
                               view(fn(curve, *args, **dict(kw, _segments=1)), args)):
                raise AssertionError(f"{name} at its plan != itself at _segments=1 as "
                                     f"projective points at {role}")
            row["serial_equal_as_points"] = True
            extra += ", == _segments=1 as points"
        if name == "prefix_scan_r12":
            # its own arithmetic: radix-12 multiplies at the integer rate
            row["r12_muls"] = depth * lanes * r12_madd_muls(r12_nw)
            row["r12_muls_ms"] = row["r12_muls"] / INT_MULS_PER_S * 1e3
            extra += f", its radix-12 multiplies alone {row['r12_muls_ms']:.3f} ms"
        if name == "suffix_fold":
            row["bound_all_slots_ms"] = suffix_fold_bound_all_slots(depth, lanes, curve)[0]
            extra += (f"; both adds on every slot (the Pallas body) "
                      f"{row['bound_all_slots_ms']:.3f} ms")
        rows[name].append(row)
        log(f"  {name:15s} {tuple(args[0].shape)} kernel {kernel_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by}), {kernel_ms / bound_ms:.1f}x{extra}  [{role}] [{smi}]")
        del args
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def env(name: str, value: str):
    """os.environ[name] = value inside the block, restored after it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def expected_launches(route: str, n: int) -> dict:
    """Each kernel's launches in one MSM of `route` at n points, from the
    ported plan functions."""
    from icicle_tpu_torch.ops import msm_tpu as V1
    from icicle_tpu_torch.ops import msm_tpu2 as V2
    from icicle_tpu_torch.ops import msm_tpu3 as V3

    counts = dict.fromkeys(kernel_counters(), 0)
    nbits = 254
    if route in ("u32", "r12"):
        plan = V3._resolve_plan("bn254", n, None, None, None, route, 1)
        groups = -(-plan["n_windows"] // plan["wg"])
        counts["prefix_scan" if route == "u32" else "prefix_scan_r12"] = groups
        counts["ec_reduce"] = groups + (2 if plan["M"] > 128 else 1)
    elif route == "v2":
        _, _, _, tiles, n_windows, wg = V2._plan2(n, None, nbits, None)
        counts["suffix_fold"] = -(-n_windows // wg)
        # B6 sums its run ends with one B4 a call, then the cross-tile fold
        counts["ec_reduce"] = counts["suffix_fold"] + (2 if tiles > 128 else 1)
    else:
        _, n_windows, _, _ = V1._plan(n, None, nbits, 1024)
        per_chunk = V1._auto_wchunk(n, n_windows, 8) or n_windows
        counts["bucket_accum"] = -(-n_windows // per_chunk)
    return counts


def msm_main_paths(dev, smi: str, launches: dict) -> dict:
    """The MSM routes on CUDA tensors; records each checked MSM's kernel
    launches in `launches` and returns the measurements."""
    from icicle_tpu_torch import get_curve, msm_affine
    from icicle_tpu_torch.curves.host_ec import ec_add, ec_mul
    from icicle_tpu_torch.ops.msm_tpu import msm_tpu
    from icicle_tpu_torch.ops.msm_tpu2 import msm_tpu2
    from icicle_tpu_torch.ops.msm_tpu3 import msm_tpu3, msm_tpu3_prepare

    curve = get_curve("bn254")
    fr, fq = curve.fr, curve.fq
    mod = fq.modulus
    gen_pt = (curve.gen_x, curve.gen_y)

    def entry(route: str):
        """The route's entry point a user calls: (s, px, py) -> affine."""
        if route == "u32":
            return lambda s, x, y: msm_affine("bn254", s, x, y)
        if route == "r12":
            def run(s, x, y):
                with env("ICICLE_TPU_MSM_ENGINE", "r12"):
                    return msm_affine("bn254", s, x, y)
            return run
        if route == "v2":
            def run(s, x, y):
                with env("ICICLE_TPU_MSM_PIPELINE", "v2"):
                    return msm_affine("bn254", s, x, y)
            return run
        return lambda s, x, y: msm_tpu("bn254", s, x, y)

    def timed_call(route: str, s, x, y):
        """The call points/s is measured over: v3 over prepared bases (set-up
        outside the timed region, as bench.py), v2 and v1 over device points."""
        if route in ("u32", "r12"):
            prepared = msm_tpu3_prepare("bn254", x, y, engine=route)
            torch.cuda.synchronize()
            return lambda: msm_tpu3("bn254", s, prepared=prepared)
        if route == "v2":
            return lambda: msm_tpu2("bn254", s, x, y)
        return lambda: msm_tpu("bn254", s, x, y)

    def run_checked(route, label, n, scal, px, py, want, timed=True):
        s_dev = torch.from_numpy(scal.view(np.int32)).to(dev)
        got = counted(label, lambda: entry(route)(s_dev, px, py), launches)
        if launches[label] != expected_launches(route, n):
            raise AssertionError(f"{label}: launched {launches[label]}, expected "
                                 f"{expected_launches(route, n)}")
        want = want if want is not None else (0, 0)
        if got != want:
            raise AssertionError(f"{label}: MSM result {got} != oracle {want}")
        launched = {k: v for k, v in launches[label].items() if v}
        out = {"n": n, "route": route, "launches": launched}
        if timed:
            call = timed_call(route, s_dev, px, py)
            ms, last = host_ms(call, reps=3)
            if last != want:
                raise AssertionError(f"{label}: timed result {last} != oracle {want}")
            out.update(ms=ms, points_per_s=n / (ms * 1e-3))
            log(f"  {label}: == oracle, launches {launched}; timed == oracle, {ms:.1f} ms, "
                f"{n / (ms * 1e-3):.4g} points/s [{smi}]")
        else:
            log(f"  {label}: == oracle, launches {launched} [{smi}]")
        return s_dev, out

    def bench_inputs(n: int, seed: int):
        """bench.py's inputs (bench.py:48-59): one repeated point."""
        rng = np.random.default_rng(seed)
        P = ec_mul(gen_pt, 0xDEADBEEF, mod)
        scal = bench_scalars(rng, n)
        total = sum(int(np.sum(scal[:, limb], dtype=np.uint64)) << (32 * limb)
                    for limb in range(8)) % fr.modulus
        px = fq.from_ints([P[0]], dev).expand(n, fq.nlimbs)
        py = fq.from_ints([P[1]], dev).expand(n, fq.nlimbs)
        return scal, px, py, ec_mul(P, total, mod)

    def profile(label: str, call, want) -> dict:
        got, prof = device_profile(label, call, smi)
        if got != want:
            raise AssertionError(f"profiled {label}: {got} != oracle {want}")
        return prof

    out = {}
    # 2^24 with bench.py's inputs: v3 "u32", v3 "r12", v2
    n = 1 << 24
    scal, px, py, want24 = bench_inputs(n, 0)
    profiles = {}
    for route, label in (("u32", MSM_24), ("r12", R12_24), ("v2", V2_24)):
        s24, out[label] = run_checked(route, label, n, scal, px, py, want24)
        profiles[label] = profile(label, timed_call(route, s24, px, py), want24)
        del s24
        torch.cuda.empty_cache()
    del px, py

    # v1 at 2^20 with the same kind of inputs
    n = 1 << 20
    scal, px, py, want20 = bench_inputs(n, 2)
    s20, out[V1_20] = run_checked("v1", V1_20, n, scal, px, py, want20)
    profiles[V1_20] = profile(V1_20, timed_call("v1", s20, px, py), want20)
    del s20, px, py

    # bench.py's distinct-point check (bench.py:158-223) at 2^16, every route
    n2 = 1 << 16
    rng = np.random.default_rng(1)
    P = ec_mul(gen_pt, 0xC0FFEE, mod)
    pts, cur = [], P
    for _ in range(n2):
        pts.append(cur)
        cur = ec_add(cur, P, mod)
    scal = bench_scalars(rng, n2)
    total = sum((i + 1) * int.from_bytes(scal[i].astype("<u4").tobytes(), "little")
                for i in range(n2)) % fr.modulus
    px = fq.from_ints([p[0] for p in pts], dev)
    py = fq.from_ints([p[1] for p in pts], dev)
    want16 = ec_mul(P, total, mod)
    for route, label in (("u32", MSM_16), ("r12", R12_16), ("v2", V2_16), ("v1", V1_16)):
        _, out[label] = run_checked(route, label, n2, scal, px, py, want16,
                                    timed=route == "u32")
    del px, py
    torch.cuda.empty_cache()
    out["profiles"] = profiles
    return out


def field_elements(f, shape: tuple, gen, dev) -> torch.Tensor:
    """Random canonical elements on the card: int32 values below p, or (...,
    L) limbs whose top limb is below p's."""
    if f.limb_shape == ():
        return torch.randint(0, f.modulus, shape, generator=gen, device=dev, dtype=torch.int32)
    nl = f.nlimbs
    a = torch.randint(0, 1 << 32, shape + (nl,), generator=gen, device=dev, dtype=torch.int64)
    a[..., nl - 1] = torch.randint(0, f.modulus >> (32 * (nl - 1)), shape, generator=gen,
                                   device=dev, dtype=torch.int64)
    return a.to(torch.int32)


# (field, t, domain tag, n inputs a row, batch, role): every compiled
# instance (the single-word fields at every width, each 8-limb round count
# at every width), one permutation and the sponge
P2_WIDTHS = (2, 3, 4, 8, 12, 16, 20, 24)
POSEIDON2_CHECKS = (
    [(f, t, None, t, 1 << 16, f"{f} t={t}") for f in ("babybear", "koalabear", "m31")
     for t in P2_WIDTHS]
    + [("babybear", t, None, n, 1 << 16, f"babybear t={t} sponge n={n}")
       for t in (3, 8) for n in (1, 2 * (t - 1) + 1)]
    + [("babybear", 4, 1234567, 3, 1 << 16, "babybear t=4 domain tag"),
       ("babybear", 4, 1234567, 7, 1 << 16, "babybear t=4 domain tag, sponge n=7"),
       ("koalabear", 4, None, 5, 1 << 16, "koalabear t=4 sponge n=5"),
       ("m31", 16, None, 40, 1 << 16, "m31 t=16 sponge n=40")]
    + [(f, t, None, t, 1 << 12, f"{f} t={t}") for f in ("bn254_scalar", "bls12_377_scalar",
                                                       "stark252") for t in (2, 3, 4, 8)]
    + [("goldilocks", t, None, t, 1 << 16, f"goldilocks t={t}") for t in (2, 3, 4, 8, 12)]
    + [("goldilocks", 3, None, 7, 1 << 16, "goldilocks t=3 sponge n=7"),
       ("goldilocks", 4, 99, 3, 1 << 16, "goldilocks t=4 domain tag"),
       ("goldilocks", 8, 99, 20, 1 << 16, "goldilocks t=8 domain tag, sponge n=20")]
    + [("grumpkin_scalar", 3, None, 3, 1 << 12, "grumpkin_scalar t=3"),
       ("bls12_381_scalar", 8, None, 8, 1 << 12, "bls12_381_scalar t=8"),
       ("bn254_scalar", 3, None, 5, 1 << 12, "bn254_scalar t=3 sponge n=5")])
POSEIDON2_TIMED = 1 << (MERKLE_LOG - 1)  # the 2^29 tree's leaf layer
GL_MERKLE_LOG = 28   # goldilocks leaves: 2 GiB, the bytes of the 2^29 babybear tree
GL_POSEIDON2_TIMED = 1 << (GL_MERKLE_LOG - 1)  # its leaf layer
GL_POSEIDON2_ROLE = f"goldilocks t=2, the 2^{GL_MERKLE_LOG} tree's leaf layer"
P2_SASS_KERNEL = "babybear_t2ELb0E"  # poseidon2_kernel<babybear_t2, false>
KECCAK_SASS_KERNEL = "keccak_kernelILi34ELj1ELi8ELb0E"  # keccak_kernel<34, 0x01, 8, false>
# (field, width, log2 leaves): trees held against the torch backend's build
MERKLE_SMALLER = (("babybear", 2, 22), ("babybear", 4, 20), ("bn254_scalar", 2, 12))


def check_poseidon2_kernel(dev, gen, smi: str) -> list:
    """poseidon2 against Poseidon2.hash_fields_ref on the card at every
    POSEIDON2_CHECKS shape, bit for bit, the kernel timed (median CUDA-event
    ms after a warm-up) and the plain version at the first shape; then the
    kernel timed alone at babybear t = 2, batch 2^28."""
    from icicle_tpu_torch import Poseidon2, get_field
    from icicle_tpu_torch.kernels import poseidon2_kernel as PK

    rows = []
    for fname, t, tag, n, batch, role in POSEIDON2_CHECKS:
        h = Poseidon2(fname, t, domain_tag=tag)
        f = get_field(fname)
        x = field_elements(f, (batch, n), gen, dev)
        x[0] = f.zeros((n,), dev)                                  # edge rows: 0 and p - 1
        x[1] = f.from_ints([f.modulus - 1] * n, dev)
        got = PK.poseidon2(h, x)
        want = h.hash_fields_ref(x)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"poseidon2 != hash_fields_ref at {role}: max abs err {err}")
        kernel_ms = cuda_ms(lambda: PK.poseidon2(h, x))
        # the plain version is timed at the first shape and at goldilocks t = 2
        # (the kernels line's)
        plain_ms = cuda_ms(lambda: h.hash_fields_ref(x), reps=3) \
            if not rows or role == "goldilocks t=2" else None
        bound_ms, bound_by = poseidon2_bound(h, batch, n)
        plain_bound_ms = poseidon2_bound(h, batch, n, plain=True)[0]
        rows.append({"role": role, "field": fname, "t": t, "n": n, "batch": batch,
                     "domain_tag": tag, "checked": True, "edge_rows": True,
                     "max_abs_diff": err, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_plain_monts_ms": plain_bound_ms})
        plain = "" if plain_ms is None else f", plain {plain_ms:.1f} ms"
        log(f"  poseidon2 {role:34s} ({batch}, {n}) exact, edge rows too; kernel "
            f"{kernel_ms:.4f} ms{plain}, bound {bound_ms:.4f} ms ({bound_by}; "
            f"the plain version's multiplies: {plain_bound_ms:.4f})")
        del x, got, want
    h = Poseidon2("babybear", 2)
    x = field_elements(get_field("babybear"), (POSEIDON2_TIMED, 2), gen, dev)
    kernel_ms = cuda_ms(lambda: PK.poseidon2(h, x))
    bound_ms, bound_by = poseidon2_bound(h, POSEIDON2_TIMED, 2)
    plain_bound_ms = poseidon2_bound(h, POSEIDON2_TIMED, 2, plain=True)[0]
    rows.append({"role": "babybear t=2, the 2^29 tree's leaf layer", "field": "babybear",
                 "t": 2, "n": 2, "batch": POSEIDON2_TIMED, "domain_tag": None,
                 "checked": False, "kernel_ms": kernel_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "bound_plain_monts_ms": plain_bound_ms})
    log(f"  poseidon2 babybear t=2 ({POSEIDON2_TIMED}, 2): kernel {kernel_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}), {kernel_ms / bound_ms:.2f}x; against the plain "
        f"version's multiplies {plain_bound_ms:.3f} ms; "
        f"{POSEIDON2_TIMED / (kernel_ms * 1e-3):.4g} hashes/s [{smi}]")
    del x
    # goldilocks t = 2 at the 2^28 tree's leaf layer
    h = Poseidon2("goldilocks", 2)
    x = field_elements(get_field("goldilocks"), (GL_POSEIDON2_TIMED, 2), gen, dev)
    kernel_ms = cuda_ms(lambda: PK.poseidon2(h, x))
    bound_ms, bound_by = poseidon2_bound(h, GL_POSEIDON2_TIMED, 2)
    rows.append({"role": GL_POSEIDON2_ROLE, "field": "goldilocks", "t": 2, "n": 2,
                 "batch": GL_POSEIDON2_TIMED, "domain_tag": None, "checked": False,
                 "kernel_ms": kernel_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                 "bound_plain_monts_ms": poseidon2_bound(h, GL_POSEIDON2_TIMED, 2, plain=True)[0]})
    log(f"  poseidon2 goldilocks t=2 ({GL_POSEIDON2_TIMED}, 2): kernel {kernel_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}), {kernel_ms / bound_ms:.2f}x; "
        f"{GL_POSEIDON2_TIMED / (kernel_ms * 1e-3):.4g} hashes/s [{smi}]")
    del x
    torch.cuda.empty_cache()
    return rows


def device_profile(label: str, fn, smi: str):
    """fn() under torch.profiler: (its result, {wall_ms, busy_ms, launch_calls,
    copy_calls, kernels: [(name, count, ms)], copies: [(name, count, ms)],
    complete, tries, profile_s}); copies are memcpy and memset activities,
    kernels every other device activity, launch_calls and copy_calls the
    host's calls that start them; profile_s the seconds the profile took in
    all, pads and parsing included.

    The host's calls are always in the profile, its device activities not:
    on the H100 machines the profiler drops the first kernels of a profiled
    call, more of them the longer the process has run (none at its start, the
    first 16 of a 2^29 build's 29 kernels eight minutes in). So what a caller
    checks is counted from the host's calls, and a profile that kept fewer
    device activities than PROFILE_KEPT of those calls started is taken again,
    with a longer idle pad before and after the call, up to PROFILE_TRIES
    times; `complete` says whether the last one kept them all, and busy_ms is
    its kept time."""
    t_start = time.perf_counter()
    for tries in range(1, PROFILE_TRIES + 1):
        pad_s = PROFILE_PAD_S * 2 ** (tries - 1)
        with torch.profiler.profile(activities=list(PROFILE_ACTIVITIES)) as prof:
            time.sleep(pad_s)
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(pad_s)
        averages = prof.key_averages()
        events = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
        calls = [e for e in averages if e.device_type == torch.autograd.DeviceType.CPU]
        launch_calls = sum(e.count for e in calls if "LaunchKernel" in e.key)
        copy_calls = sum(e.count for e in calls
                         if e.key.startswith(("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")))
        split = {"kernels": [], "copies": []}
        for e in sorted(events, key=lambda e: -e.self_device_time_total):
            kind = "copies" if e.key.startswith(("Memcpy", "Memset")) else "kernels"
            split[kind].append((e.key[:120], e.count, e.self_device_time_total / 1e3))
        kept = sum(c for _, c, _ in split["kernels"])
        kept_copies = sum(c for _, c, _ in split["copies"])
        complete = kept >= launch_calls and kept_copies >= copy_calls
        if complete:
            break
        log(f"  profile, one {label} (pad {pad_s:g} s): the profiler kept {kept} kernels of "
            f"{launch_calls} launch calls, {kept_copies} copies of {copy_calls} copy calls")
        if kept >= PROFILE_KEPT * launch_calls and kept_copies >= PROFILE_KEPT * copy_calls:
            break
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    profile_s = time.perf_counter() - t_start
    log(f"  profile, one {label}: wall {wall_ms:.1f} ms (profiled), {launch_calls} launch "
        f"calls, {copy_calls} copy calls; device busy {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}{'' if complete else ' (of the kept activities only)'}; "
        f"profiled in {profile_s:.1f} s [{smi}]")
    for kind in ("kernels", "copies"):
        for key, count, ms in split[kind]:
            log(f"    {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    return out, dict(wall_ms=wall_ms, busy_ms=busy_ms, launch_calls=launch_calls,
                     copy_calls=copy_calls, complete=complete, tries=tries,
                     profile_s=profile_s, **split)


def merkle_main_path(dev, gen, smi: str, launches: dict) -> dict:
    """The Poseidon2 Merkle main path on CUDA tensors (bench.py's
    _bench_merkle); records the checked builds' launches in `launches`."""
    from icicle_tpu_torch import MerkleTree, MerkleTreeConfig, Poseidon2, get_field
    from icicle_tpu_torch.kernels.poseidon2_kernel import needed_monts
    from icicle_tpu_torch.ops.merkle import MerkleProof

    f = get_field("babybear")
    n = 1 << MERKLE_LOG
    h = Poseidon2(f, 2)
    tree = MerkleTree([h] * MERKLE_LOG, leaf_words=1)
    rng = np.random.default_rng(0)
    leaves = torch.from_numpy(rng.integers(0, f.modulus, size=(n,), dtype=np.uint32)
                              .view(np.int32)).to(dev)   # one upload, outside the timing
    torch.cuda.synchronize()

    def expect(count: int) -> dict:
        return dict(dict.fromkeys(kernel_counters(), 0), poseidon2=count)

    main_root = counted(MERKLE_MAIN, lambda: tree.build(leaves), launches)
    if launches[MERKLE_MAIN] != expect(MERKLE_LOG):
        raise AssertionError(f"{MERKLE_MAIN}: launched {launches[MERKLE_MAIN]}, expected "
                             f"{MERKLE_LOG} poseidon2 and nothing else")
    ms, last = host_ms(lambda: tree.build(leaves), reps=3)
    if not np.array_equal(last, main_root):
        raise AssertionError(f"{MERKLE_MAIN}: timed root {last} != {main_root}")
    hashes = n - 1
    nbytes = 4 * (n + 2 * (n - 2) + 1)  # leaves, internal layers out and in, root
    bound_ms, bound_by = bound(nbytes, hashes * needed_monts(h, 2) * MULS_PER_MONT)
    plain_bound_ms = bound(nbytes, hashes * poseidon2_plain_monts(h, 2) * MULS_PER_MONT)[0]
    log(f"  {MERKLE_MAIN}: {MERKLE_LOG} poseidon2 launches and nothing else; build "
        f"{ms:.3f} ms, {n / (ms * 1e-3):.4g} leaves/s; bound {bound_ms:.3f} ms ({bound_by}; "
        f"the plain version's multiplies: {plain_bound_ms:.3f}) [{smi}]")
    _, prof = device_profile(f"2^{MERKLE_LOG} build", lambda: tree.build(leaves), smi)
    if (any("poseidon2" not in k for k, _, _ in prof["kernels"])
            or prof["launch_calls"] != MERKLE_LOG):
        raise AssertionError(f"the 2^{MERKLE_LOG} build ran device kernels other than "
                             f"{MERKLE_LOG} poseidon2 launches: {prof['launch_calls']} launch "
                             f"calls, kept kernels {prof['kernels']}")

    # every layer: 4096 sampled parents against the plain version on the card
    for i in range(1, MERKLE_LOG + 1):
        below, layer = tree.layers[i - 1], tree.layers[i]
        m = layer.shape[0]
        pick = torch.randint(0, m, (min(m, 4096),), generator=gen, device=dev)
        want = h.hash_fields_ref(below.reshape(m, 2)[pick])
        if not torch.equal(layer[pick, 0], want):
            raise AssertionError(f"2^{MERKLE_LOG} tree, layer {i}: sampled parents != "
                                 "hash_fields_ref of their children")
    proved = [0, n - 1] + [int(i) for i in rng.integers(0, n, size=8)]
    for idx in proved:
        for pruned in (True, False):
            proof = tree.get_merkle_proof(leaves, idx, pruned=pruned)
            bad = MerkleProof(proof.leaf ^ 1, idx, proof.root, proof.path, pruned)
            if not tree.verify(proof) or tree.verify(bad):
                raise AssertionError(f"2^{MERKLE_LOG} tree: the proof of leaf {idx} (pruned "
                                     f"{pruned}) does not verify, or verifies flipped")
    log(f"  2^{MERKLE_LOG} tree: every layer == hash_fields_ref at 4096 sampled parents; "
        f"pruned and full proofs of leaves {proved} verify, and fail flipped; root "
        f"{int(main_root[0])}")
    del leaves
    tree.layers = []
    torch.cuda.empty_cache()

    # smaller trees against the same build by the plain version on the card
    smaller = []
    for fname, t, log_n in MERKLE_SMALLER:
        g = get_field(fname)
        ht = Poseidon2(g, t)
        depth = log_n if t == 2 else log_n // 2
        lw = 1 if g.limb_shape == () else g.nlimbs
        x = field_elements(g, (1 << log_n,), gen, dev).reshape(1 << log_n, lw)
        label = f"merkle {fname} poseidon2 t={t} 2^{log_n}"
        kernel_tree = MerkleTree([ht] * depth, leaf_words=lw)
        plain_tree = MerkleTree([ht] * depth, leaf_words=lw)
        root = counted(label, lambda: kernel_tree.build(x), launches)
        if launches[label] != expect(depth):
            raise AssertionError(f"{label}: launched {launches[label]}, expected {depth}")
        t0 = time.perf_counter()
        plain_root = plain_tree.build(x, MerkleTreeConfig(backend="torch"))
        plain_s = time.perf_counter() - t0
        if not np.array_equal(root, plain_root) or not all(
                torch.equal(a, b) for a, b in zip(kernel_tree.layers, plain_tree.layers)):
            raise AssertionError(f"{label}: kernel tree != the torch backend's tree")
        smaller.append({"label": label, "layers": depth, "root": [int(w) for w in root],
                        "plain_s": plain_s})
        log(f"  {label}: root and all {depth} layers == backend 'torch' on the card "
            f"({plain_s:.1f} s), {depth} launches")
        del x, kernel_tree, plain_tree
    torch.cuda.empty_cache()
    return {"leaves": n, "build_ms": ms, "leaves_per_s": n / (ms * 1e-3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_plain_monts_ms": plain_bound_ms, "root": int(main_root[0]),
            "profile": prof, "proved_leaves": proved, "smaller": smaller, "card": smi}


# -- the protocol layer: K1-K4, FRI and sumcheck ---------------------------------

FRI_LOG = 22
FRI_MAIN = f"fri babybear 2^{FRI_LOG}"
FRI_SMALL_LOG = 16
SUMCHECK_LOG = 24
SUMCHECK_MAIN = f"sumcheck babybear AB_MINUS_C 2^{SUMCHECK_LOG}"
SUMCHECK_EQ_LOG = 22
SUMCHECK_EQ = f"sumcheck babybear EQ_X_AB_MINUS_C 2^{SUMCHECK_EQ_LOG}"
KECCAK_WORDS = (1, 8, 16, 34, 35)          # hash_words row widths checked
KECCAK_CHECK_BATCH = 1 << 16               # their rows
PROTOCOL_CHECK_LOG = 20                    # K3's and K4's checked vectors
KECCAK_BYTES = (0, 1, 135, 136, 137, 300)  # hash_bytes lengths checked
PROTOCOL_FIELDS = ("babybear", "koalabear", "m31")


def alu_ops_per_s(clock_mhz: float) -> float:
    """32-bit logic and shift instructions a second: the ALU pipe's 64
    lanes a clock an SM, 132 SMs, at the SM clock nvidia-smi reports."""
    return 132 * 64 * clock_mhz * 1e6


def keccak_bound(h, batch: int, in_words: int, clock_mhz: float,
                 padded: bool = False) -> tuple[float, str]:
    """Rows in and digests out once, against the permutations' logic and
    shift instructions (keccak_kernel.PERMUTATION_OPS a block, plus an XOR
    a word absorbed into each block after the first: the first block is
    absorbed into a zero state) on the ALU pipe."""
    from icicle_tpu_torch.kernels.keccak_kernel import PERMUTATION_OPS, nof_blocks
    rate_words = h.rate_bytes // 4
    blocks = nof_blocks(in_words, rate_words, padded)
    byte_ms = batch * (in_words + h.digest_words) * 4 / HBM_BYTES_PER_S * 1e3
    ops = blocks * PERMUTATION_OPS + (blocks - 1) * rate_words
    op_ms = batch * ops / alu_ops_per_s(clock_mhz) * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def fold_bound(n: int) -> tuple[float, str]:
    """n words in, n / 2 twiddles, n / 2 out; two Montgomery multiplies an
    output."""
    return bound((n + n // 2 + n // 2) * 4, n // 2 * 2 * MULS_PER_MONT)


def sumcheck_bound(f, program, npolys: int, n: int, fold: bool) -> tuple[float, str]:
    """The MLEs in once (and the folded ones out), against the fold's
    Montgomery multiplies and deg + 1 combine evaluations a pair."""
    from icicle_tpu_torch.kernels.program_kernel import program_monts
    pairs = n // (4 if fold else 2)
    nbytes = npolys * n * 4 + (npolys * n // 2 * 4 if fold else 0)
    monts = (npolys * 2 * pairs if fold else 0) + pairs * (program.poly_degree + 1) * \
        program_monts(f, program)
    return bound(nbytes, monts * MULS_PER_MONT)


def program_bound(f, program, n: int) -> tuple[float, str]:
    """The parameters the program reads and its outputs, once each, against
    its Montgomery multiplies an element."""
    from icicle_tpu_torch.kernels.program_kernel import make_code, program_monts
    _, code, reads = make_code("program", f, program)
    n_out = 1 if program.predef is not None else code.n_out
    return bound((len(reads) + n_out) * n * 4, n * program_monts(f, program) * MULS_PER_MONT)


def _exact(label: str, got: torch.Tensor, want: torch.Tensor) -> int:
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
    if got.shape != want.shape or err != 0 or not torch.equal(got, want):
        raise AssertionError(f"{label}: kernel != plain version, max abs err {err}")
    return err


def _combines():
    """(name, program, MLEs) of the combines the kernels are held to."""
    from icicle_tpu_torch.ops.program import PreDefined, ReturningValueProgram
    return (("AB_MINUS_C", ReturningValueProgram(PreDefined.AB_MINUS_C), 3),
            ("EQ_X_AB_MINUS_C", ReturningValueProgram(PreDefined.EQ_X_AB_MINUS_C), 4),
            ("lambda const+inv", ReturningValueProgram(
                lambda v: v[0] * v[1].inverse() + 7 - v[2] * 3, nof_inputs=3), 3))


def check_protocol_kernels(dev, gen, smi: str, clock_mhz: float) -> dict:
    """K1-K4 against their plain versions on the card, bit for bit, at
    Section 4's shapes; each timed (median CUDA-event ms after a warm-up) at
    the main paths' widest launch, its plain version once."""
    import hashlib

    from icicle_tpu_torch import Keccak256, Keccak512, Sha3_256, Sha3_512, get_field
    from icicle_tpu_torch.kernels import fri_kernel as FK
    from icicle_tpu_torch.kernels import keccak_kernel as KK
    from icicle_tpu_torch.kernels import program_kernel as PK
    from icicle_tpu_torch.kernels import sumcheck_kernel as SK
    from icicle_tpu_torch.ops.ntt import ntt_init_domain
    from icicle_tpu_torch.ops.program import PreDefined, Program
    from icicle_tpu_torch.utils import native

    rows = {"keccak": [], "fri_fold": [], "sumcheck_round": [], "program": []}

    # K1: hash_words and hash_bytes of all four variants
    for H in (Keccak256, Keccak512, Sha3_256, Sha3_512):
        h = H()
        for w in KECCAK_WORDS:
            x = torch.randint(-2 ** 31, 2 ** 31, (KECCAK_CHECK_BATCH, w), generator=gen, device=dev,
                              dtype=torch.int32)
            err = _exact(f"keccak {H.__name__} ({KECCAK_CHECK_BATCH}, {w})", KK.keccak(h, x),
                         KK.keccak_ref(h, x))
            rows["keccak"].append({"role": f"{H.__name__} hash_words", "batch": KECCAK_CHECK_BATCH,
                                   "in_words": w, "max_abs_diff": err, "checked": True})
        kind = {Keccak256: "keccak_256", Keccak512: "keccak_512", Sha3_256: "sha3_256",
                Sha3_512: "sha3_512"}[H]
        for nb in KECCAK_BYTES:
            chunks = [bytes(np.random.default_rng(nb + i).integers(0, 256, nb, dtype=np.uint8))
                      for i in range(4)]
            got = h.hash_bytes(b"".join(chunks), batch=4)
            want = b"".join(native.host_hash(kind, c) for c in chunks)
            if kind.startswith("sha3"):
                assert want == b"".join(hashlib.new(kind, c).digest() for c in chunks)
            if got != want:
                raise AssertionError(f"keccak {H.__name__} hash_bytes of {nb} bytes != the "
                                     "host library")
        log(f"  keccak {H.__name__}: hash_words of {KECCAK_WORDS} words x {KECCAK_CHECK_BATCH} rows == "
            f"keccak_ref on the card; hash_bytes of {KECCAK_BYTES} bytes == the host library"
            f"{' and hashlib' if H in (Sha3_256, Sha3_512) else ''}")
    h = Keccak256()
    for role, batch, w in ((f"FRI 2^{FRI_LOG} leaf layer", 1 << FRI_LOG, 1),
                           (f"FRI 2^{FRI_LOG} compress layer", 1 << (FRI_LOG - 1), 16)):
        x = torch.randint(-2 ** 31, 2 ** 31, (batch, w), generator=gen, device=dev,
                          dtype=torch.int32)
        err = _exact(f"keccak {role}", KK.keccak(h, x), KK.keccak_ref(h, x))
        kernel_ms = cuda_ms(lambda: KK.keccak(h, x))
        plain_ms = cuda_ms(lambda: KK.keccak_ref(h, x), reps=3) if w == 1 else None
        bound_ms, bound_by = keccak_bound(h, batch, w, clock_mhz)
        rows["keccak"].append({"role": role, "batch": batch, "in_words": w,
                               "max_abs_diff": err, "checked": True, "kernel_ms": kernel_ms,
                               "plain_ms": plain_ms, "bound_ms": bound_ms,
                               "bound_by": bound_by})
        plain = "" if plain_ms is None else f", plain {plain_ms:.1f} ms"
        log(f"  keccak {role} ({batch}, {w}) exact; kernel {kernel_ms:.4f} ms{plain}, bound "
            f"{bound_ms:.4f} ms ({bound_by}), {kernel_ms / bound_ms:.2f}x [{smi}]")
        del x
    torch.cuda.empty_cache()

    # K2: a fold at round 0 (stride 1) and at round 6 (stride 64)
    for fname in ("babybear", "koalabear"):
        f = get_field(fname)
        tw = ntt_init_domain(f, FRI_LOG, dev).twiddles_inv
        for log_n, stride in ((FRI_LOG, 1), (FRI_LOG - 6, 64)):
            e = field_elements(f, (1 << log_n,), gen, dev)
            e[:2] = 0
            e[2:4] = f.modulus - 1
            alpha = int(torch.randint(0, f.modulus, (1,), generator=gen, device=dev))
            err = _exact(f"fri_fold {fname} 2^{log_n}", FK.fri_fold(f, e, alpha, tw, stride),
                         FK.fri_fold_ref(f, e, alpha, tw, stride))
            row = {"role": f"{fname} 2^{log_n} -> 2^{log_n - 1}, stride {stride}",
                   "field": fname, "n": 1 << log_n, "max_abs_diff": err, "checked": True}
            if log_n == FRI_LOG:
                row["kernel_ms"] = cuda_ms(lambda: FK.fri_fold(f, e, alpha, tw, stride))
                row["plain_ms"] = cuda_ms(lambda: FK.fri_fold_ref(f, e, alpha, tw, stride),
                                          reps=3)
                row["bound_ms"], row["bound_by"] = fold_bound(1 << log_n)
                log(f"  fri_fold {row['role']} exact (0 and p - 1 among the inputs); kernel "
                    f"{row['kernel_ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}) [{smi}]")
            rows["fri_fold"].append(row)
            del e

    # K3 and K4 at 2^PROTOCOL_CHECK_LOG, every field, the three combines, zero inputs included
    for fname in PROTOCOL_FIELDS:
        f = get_field(fname)
        for cname, prog, npolys in _combines():
            m = field_elements(f, (npolys, 1 << PROTOCOL_CHECK_LOG), gen, dev)
            m[:, :5] = 0
            alpha = int(torch.randint(0, f.modulus, (1,), generator=gen, device=dev))
            for fold in (False, True):
                rp, mf = SK.sumcheck_round(f, prog, prog.poly_degree, m, alpha, fold)
                rp_ref, mf_ref = SK.sumcheck_round_ref(f, prog, prog.poly_degree, m, alpha, fold)
                label = f"sumcheck_round {fname} {cname} fold={fold}"
                err = max(_exact(label, rp, rp_ref), _exact(label + " folded", mf, mf_ref))
                rows["sumcheck_round"].append({"role": label, "n": 1 << PROTOCOL_CHECK_LOG, "npolys": npolys,
                                               "max_abs_diff": err, "checked": True})
            pp = prog if prog.predef is None else Program(PreDefined(int(prog.predef)))
            data = [m[i] for i in range(npolys)] + [torch.zeros_like(m[0])]
            data = data[:pp.nof_parameters]
            err = max(_exact(f"program {fname} {cname}", a, b) for a, b in zip(
                PK.execute_program_kernel(f, pp, data), PK.execute_program_ref(f, pp, data)))
            rows["program"].append({"role": f"program {fname} {cname}", "n": 1 << PROTOCOL_CHECK_LOG,
                                    "max_abs_diff": err, "checked": True})
            del m, data

        def non_tail(v):
            v[0] = v[1] * v[2] + 5
            v[2] = v[1]

        pp = Program(non_tail, 3)
        data = [field_elements(f, (1 << PROTOCOL_CHECK_LOG,), gen, dev) for _ in range(3)]
        err = max(_exact(f"program {fname} non-tail", a, b) for a, b in zip(
            PK.execute_program_kernel(f, pp, data), PK.execute_program_ref(f, pp, data)))
        rows["program"].append({"role": f"program {fname} non-tail outputs", "n": 1 << PROTOCOL_CHECK_LOG,
                                "max_abs_diff": err, "checked": True})
        log(f"  sumcheck_round and program {fname} at 2^{PROTOCOL_CHECK_LOG}: {', '.join(c for c, _, _ in _combines())}"
            " (with and without the fold), a non-tail program: exact")
        del data
    # checked and timed at the main paths' widest launches: sumcheck rounds 0
    # and 1 and the claimed sum's program over 3 MLEs of 2^24
    f = get_field("babybear")
    _, prog, _ = _combines()[0]
    m = field_elements(f, (3, 1 << SUMCHECK_LOG), gen, dev)
    for fold in (False, True):
        label = f"sumcheck_round AB_MINUS_C 3 x 2^{SUMCHECK_LOG} fold={fold}"
        rp, mf = SK.sumcheck_round(f, prog, 2, m, 5, fold)
        rp_ref, mf_ref = SK.sumcheck_round_ref(f, prog, 2, m, 5, fold)
        err = max(_exact(label, rp, rp_ref), _exact(label + " folded", mf, mf_ref))
        del rp, mf, rp_ref, mf_ref
        row = {"role": f"AB_MINUS_C 3 x 2^{SUMCHECK_LOG}, round {int(fold)}", "n": 1 << SUMCHECK_LOG,
               "npolys": 3, "fold": fold, "max_abs_diff": err, "checked": True,
               "kernel_ms": cuda_ms(lambda: SK.sumcheck_round(f, prog, 2, m, 5, fold)),
               "plain_ms": cuda_ms(lambda: SK.sumcheck_round_ref(f, prog, 2, m, 5, fold), reps=3)}
        row["bound_ms"], row["bound_by"] = sumcheck_bound(f, prog, 3, 1 << SUMCHECK_LOG, fold)
        rows["sumcheck_round"].append(row)
        log(f"  sumcheck_round {row['role']}: exact; kernel {row['kernel_ms']:.4f} ms, plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}) [{smi}]")
    pp = Program(PreDefined.AB_MINUS_C)
    data = [m[0], m[1], m[2], torch.zeros_like(m[0])]
    err = max(_exact(f"program AB_MINUS_C 2^{SUMCHECK_LOG}", a, b) for a, b in zip(
        PK.execute_program_kernel(f, pp, data), PK.execute_program_ref(f, pp, data)))
    row = {"role": f"AB_MINUS_C over 2^{SUMCHECK_LOG} (the claimed sum)", "n": 1 << SUMCHECK_LOG,
           "max_abs_diff": err, "checked": True,
           "kernel_ms": cuda_ms(lambda: PK.execute_program_kernel(f, pp, data)),
           "plain_ms": cuda_ms(lambda: PK.execute_program_ref(f, pp, data), reps=3)}
    row["bound_ms"], row["bound_by"] = program_bound(f, pp, 1 << SUMCHECK_LOG)
    rows["program"].append(row)
    log(f"  program {row['role']}: exact; kernel {row['kernel_ms']:.4f} ms, plain "
        f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}) [{smi}]")
    del m, data
    torch.cuda.empty_cache()
    return rows


def fri_main_path(dev, smi: str, launches: dict, h=None, label: str = FRI_MAIN,
                  kname: str = "keccak", small_log: int = FRI_SMALL_LOG) -> dict:
    """The FRI prover on the card: 2^22 babybear evaluations (a degree < 2^20
    polynomial at blow-up 4, the port's forward NTT), the reference's
    defaults, round trees of h (default Keccak-256, capi_shim._fri_setup),
    whose kernel is kname: launches counted, the proof verified and a
    flipped leaf refused, every round's fold and round 0's root replayed
    against the plain versions, the prove timed and profiled, and at
    2^small_log the proof byte-identical to the plain path's."""
    from icicle_tpu_torch import (FriConfig, FriTranscriptConfig, Keccak256, MerkleTreeConfig,
                                  fri_prove, fri_verify, get_field, ntt)
    from icicle_tpu_torch.kernels import fri_kernel as FK
    from icicle_tpu_torch.ops import fri as F
    from icicle_tpu_torch.ops.ntt import ntt_init_domain

    f = get_field("babybear")
    h = h or Keccak256()
    cfg, tcfg = FriConfig(), FriTranscriptConfig()

    def evals_of(log_n: int) -> torch.Tensor:
        rng = np.random.default_rng(0)
        coeffs = np.zeros(1 << log_n, dtype=np.uint32)
        coeffs[:1 << (log_n - 2)] = rng.integers(0, f.modulus, size=1 << (log_n - 2),
                                                  dtype=np.uint32)
        return ntt(f, torch.from_numpy(coeffs.view(np.int32)).to(dev))

    evals = evals_of(FRI_LOG)
    torch.cuda.synchronize()
    proof = counted(label, lambda: fri_prove(f, evals, cfg, tcfg, h, h), launches)
    want = dict(dict.fromkeys(kernel_counters(), 0), fri_fold=FRI_LOG,
                **{kname: sum(FRI_LOG + 1 - r for r in range(FRI_LOG))})
    if launches[label] != want:
        raise AssertionError(f"{label}: launched {launches[label]}, expected {want}")
    if not fri_verify(f, proof, cfg, tcfg, h, h):
        raise AssertionError(f"{label}: the proof does not verify")
    bad = F.FriProof.deserialize(f, proof.serialize(f))
    bad.query_proofs[0][0][0].leaf[0] ^= 1
    if fri_verify(f, bad, cfg, tcfg, h, h):
        raise AssertionError(f"{label}: a proof with a leaf word flipped verifies")
    size = len(proof.serialize(f))

    # each round's fold against the plain version on the card, replaying the
    # transcript's challenges from the proof's roots; the last equals the
    # final polynomial
    tr = F.FriTranscript(f, tcfg, FRI_LOG)
    tw = ntt_init_domain(f, FRI_LOG, dev).twiddles_inv
    cur = evals
    for r in range(FRI_LOG):
        alpha = tr.get_alpha(proof.round_root(r).astype("<u4").tobytes(), r == 0)
        nxt = FK.fri_fold(f, cur, alpha, tw, 1 << r)
        _exact(f"{label} round {r} fold", nxt, FK.fri_fold_ref(f, cur, alpha, tw, 1 << r))
        cur = nxt
    if [int(v) for v in f.to_ints(cur)] != proof.final_poly:
        raise AssertionError(f"{label}: the replayed folds end away from the final polynomial")
    plain_tree = F._make_round_trees(h, h, 1, FRI_LOG)[0]
    plain_root = plain_tree.build(evals.reshape(-1, 1), MerkleTreeConfig(backend="torch"))
    if not np.array_equal(plain_root, proof.round_root(0)):
        raise AssertionError(f"{label}: round 0's root != the {kname}_ref tree's root")
    del plain_tree, cur, nxt
    torch.cuda.empty_cache()

    runs = []
    for i in range(4):   # a warm-up, then 3 timed
        t = {}
        t0 = time.perf_counter()
        again = fri_prove(f, evals, cfg, tcfg, h, h, timings=t)
        torch.cuda.synchronize()
        t["total_ms"] = (time.perf_counter() - t0) * 1e3
        if i:
            runs.append(t)
        if again.serialize(f) != proof.serialize(f):
            raise AssertionError(f"{label}: a timed proof differs from the checked one")
    med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    log(f"  {label}: {want['fri_fold']} fri_fold and {want[kname]} {kname} launches in the "
        f"commit phase and nothing else of ours; verifies, "
        f"refuses a flipped leaf; every round's fold == fri_fold_ref, round 0's root == "
        f"{kname}_ref's; proof {size} bytes; prove {med['total_ms']:.2f} ms (commit "
        f"{med['commit_ms']:.2f}, pow {med['pow_ms']:.2f}, queries {med['query_ms']:.2f}) "
        f"[{smi}]")
    _, prof = device_profile(label, lambda: fri_prove(f, evals, cfg, tcfg, h, h), smi)

    small = evals_of(small_log)
    t0 = time.perf_counter()
    kernel_proof = fri_prove(f, small, cfg, tcfg, h, h)
    plain_proof = fri_prove(f, small, FriConfig(backend="torch"), tcfg, h, h)
    if kernel_proof.serialize(f) != plain_proof.serialize(f):
        raise AssertionError(f"{label} at 2^{small_log}: the proof != the plain path's")
    log(f"  {label} at 2^{small_log}: proof byte-identical to the plain versions' "
        f"({len(plain_proof.serialize(f))} bytes, {time.perf_counter() - t0:.1f} s)")
    del evals, small
    torch.cuda.empty_cache()
    return {"log_n": FRI_LOG, "proof_bytes": size, "ms": med, "runs": runs, "profile": prof,
            "small_identical": True, "card": smi}


def sumcheck_main_path(dev, smi: str, launches: dict) -> dict:
    """The sumcheck prover on the card: AB_MINUS_C over 3 MLEs of 2^24
    (capi_shim.sumcheck_prove_abc) and EQ_X_AB_MINUS_C over 4 of 2^22, each
    claimed sum from execute_program (K4) and vector_sum."""
    from icicle_tpu_torch import (Program, PreDefined, ReturningValueProgram, SumcheckConfig,
                                  execute_program, get_field, sumcheck_prove, sumcheck_verify)
    from icicle_tpu_torch.ops import sumcheck as S
    from icicle_tpu_torch.ops.vec_ops import vector_sum

    f = get_field("babybear")
    p = f.modulus
    out = {"card": smi}
    for label, pre, log_n, npolys in ((SUMCHECK_MAIN, PreDefined.AB_MINUS_C, SUMCHECK_LOG, 3),
                                      (SUMCHECK_EQ, PreDefined.EQ_X_AB_MINUS_C, SUMCHECK_EQ_LOG,
                                       4)):
        rng = np.random.default_rng(0)
        host = rng.integers(0, p, size=(npolys, 1 << log_n), dtype=np.uint32)
        mles = torch.from_numpy(host.view(np.int32)).to(dev)
        polys = [mles[i] for i in range(npolys)]
        prog, combine = Program(pre), ReturningValueProgram(pre)

        def prove():
            data = polys + [torch.zeros_like(polys[0])]
            claimed = int(vector_sum(f, execute_program(f, prog, data)[-1]))
            return claimed, sumcheck_prove(f, polys, claimed, combine)

        claimed, (proof, _) = counted(label, prove, launches)
        # each round is the round pass and the reduction of its partials
        want = dict(dict.fromkeys(kernel_counters(), 0), sumcheck_round=2 * log_n, program=1)
        if launches[label] != want:
            raise AssertionError(f"{label}: launched {launches[label]}, expected {want}")
        a = host.astype(np.int64)
        terms = (a[0] * a[1] % p - a[2]) % p
        if npolys == 4:
            terms = terms * a[3] % p
        if claimed != int(terms.sum() % p):
            raise AssertionError(f"{label}: claimed sum {claimed} != numpy's")
        if not sumcheck_verify(f, proof, claimed):
            raise AssertionError(f"{label}: the proof does not verify")
        bad = S.SumcheckProof([list(rp) for rp in proof.round_polys])
        bad.round_polys[3][0] = (bad.round_polys[3][0] + 1) % p
        if sumcheck_verify(f, bad, claimed):
            raise AssertionError(f"{label}: a tampered round polynomial verifies")
        plain, _ = sumcheck_prove(f, polys, claimed, combine, cfg=SumcheckConfig(backend="torch"))
        if plain.round_polys != proof.round_polys:
            raise AssertionError(f"{label}: round polynomials != the plain path's")
        prove_ms, _ = host_ms(lambda: sumcheck_prove(f, polys, claimed, combine), reps=3)
        sum_ms, _ = host_ms(lambda: int(vector_sum(f, execute_program(
            f, prog, polys + [torch.zeros_like(polys[0])])[-1])), reps=3)
        log(f"  {label}: {2 * log_n} sumcheck_round launches ({log_n} rounds) and 1 program; "
            f"claimed sum == numpy's; "
            f"verifies, refuses a tampered round; every round == the plain path's; prove "
            f"{prove_ms:.3f} ms, claimed sum {sum_ms:.3f} ms [{smi}]")
        entry = {"log_n": log_n, "npolys": npolys, "prove_ms": prove_ms,
                 "claimed_sum_ms": sum_ms, "rounds": len(proof.round_polys)}
        if label == SUMCHECK_MAIN:
            _, entry["profile"] = device_profile(f"2^{log_n} sumcheck prove", lambda: sumcheck_prove(
                f, polys, claimed, combine), smi)
        out[label] = entry
        del mles, polys, host, a, terms
        torch.cuda.empty_cache()
    return out


# -- the field layer: dif_rows_wide, the NTT over every field, polynomials -------

GL_NTT_LOG = 24
BN_NTT_LOG = 22
GL_NTT_MAIN = f"ntt goldilocks 2^{GL_NTT_LOG} fwd+inv"
BN_NTT_MAIN = f"ntt bn254_scalar 2^{BN_NTT_LOG} fwd+inv"
GL_MERKLE_MAIN = f"merkle goldilocks poseidon2 t=2 2^{GL_MERKLE_LOG}"
POLY_BN_LOG = 20      # coefficients of each factor: their product's NTTs are 2^21
POLY_BB_LOG = 21      # babybear: 2^22 NTTs, dif_rows
POLY_BN_MAIN = f"polynomial bn254_scalar 2^{POLY_BN_LOG} x 2^{POLY_BN_LOG}"
POLY_BB_MAIN = f"polynomial babybear 2^{POLY_BB_LOG} x 2^{POLY_BB_LOG}"
WIDE_SAMPLED_ROWS = 64  # rows of a full-length pass compared with the plain version
EIGHT_LIMB_FIELDS = ("bn254_scalar", "bls12_381_scalar", "bls12_377_scalar",
                     "grumpkin_scalar", "stark252")
# (field, rows, log_n, forward, factor, role): the passes of the goldilocks
# 2^24 and bn254_scalar 2^22 NTTs (pass A: columns in and out; pass B: rows
# in, columns out, times the inter-pass twiddles); each is checked in all
# four layouts at 64 sampled rows, with and without the factor, and timed
WIDE_SHAPES = [
    ("goldilocks", 4096, 12, True, "goldilocks 2^24 fwd pass A"),
    ("goldilocks", 4096, 12, False, "goldilocks 2^24 inv pass B"),
    ("bn254_scalar", 2048, 11, True, "bn254_scalar 2^22 fwd pass A"),
    ("bn254_scalar", 2048, 11, False, "bn254_scalar 2^22 inv pass B"),
]


def element_bytes(f) -> int:
    return 4 * max(1, f.nlimbs)


def dif_rows_wide_bound(f, rows: int, log_n: int, factor: bool) -> tuple[float, str]:
    """x and out (and the factor) once, the (log_n, N) stage table once;
    log_n N / 2 butterfly multiplies a row (and N by the factor), each
    `field_muls(f)` integer multiplies."""
    n = 1 << log_n
    eb = element_bytes(f)
    nbytes = rows * n * eb * (3 if factor else 2) + log_n * n * eb
    muls = rows * (log_n * n // 2 + (n if factor else 0)) * field_muls(f)
    return bound(nbytes, muls)


def wide_ntt_bound(f, logn: int) -> tuple[float, str]:
    """One four-step NTT as its two passes: pass A without the factor, pass B
    with it."""
    log_n1 = logn // 2
    a = dif_rows_wide_bound(f, 1 << (logn - log_n1), log_n1, False)
    b = dif_rows_wide_bound(f, 1 << log_n1, logn - log_n1, True)
    return a[0] + b[0], b[1]


def _with_edges(f, x: torch.Tensor, dev, count: int = 1) -> torch.Tensor:
    """x with its first `count` elements (in memory order) 0 and the next
    `count` p - 1."""
    flat = x.view(-1, *f.limb_shape)
    flat[:count] = 0
    flat[count:2 * count] = f.from_ints([f.modulus - 1], dev)[0]
    return x


def check_wide_kernel(dev, gen, smi: str) -> list:
    """dif_rows_wide against dif_rows_wide_ref on the card: WIDE_SHAPES in
    all four layouts with and without the factor (64 sampled rows of the
    full-length pass compared; rows are independent), then both passes of a
    whole 2^16 NTT for every 8-limb field (grumpkin_scalar, which has no
    root of unity, with a stage table built from random elements in place
    of the powers of w: the kernel reads tw[s, k], the plain version the
    bottom lanes' tw[s, k + m], equal only in a table of that structure). Each launch timed (median
    CUDA-event ms), the plain version at the sampled rows in the layout the
    four-step gives the pass."""
    from icicle_tpu_torch import get_field
    from icicle_tpu_torch.kernels import ntt_kernel as K
    from icicle_tpu_torch.kernels import ntt_wide as NW

    out = []

    def compare(f, x, tw, factor, tin, tout, rows, role, sampled: bool, main_layout: bool,
                log_n: int):
        got = NW.dif_rows_wide(f, x, tw, factor, transpose_in=tin, transpose_out=tout)
        torch.cuda.synchronize()
        if sampled:
            idx = torch.randperm(rows, generator=gen, device=dev)[:WIDE_SAMPLED_ROWS]
            idx = torch.cat([idx, torch.tensor([0, 1, rows - 1], device=dev)]).unique()
        else:
            idx = torch.arange(rows, device=dev)
        pick = (lambda t: t[:, idx].contiguous()) if tin else (lambda t: t[idx].contiguous())

        def plain():
            return NW.dif_rows_wide_ref(f, pick(x), tw, None if factor is None else pick(factor),
                                        transpose_in=tin, transpose_out=tout)

        want = plain()
        seen = got[:, idx] if tout else got[idx]
        err = int((seen.to(torch.int64) - want.to(torch.int64)).abs().max())
        layout = layout_name(tin, tout)
        if err != 0 or not torch.equal(seen, want):
            raise AssertionError(f"dif_rows_wide != dif_rows_wide_ref at {role}, {layout}, "
                                 f"factor {factor is not None}: max abs err {err}")
        kernel_ms = cuda_ms(lambda: NW.dif_rows_wide(f, x, tw, factor, transpose_in=tin,
                                                     transpose_out=tout))
        plain_ms = cuda_ms(plain, reps=3) if main_layout else None
        bound_ms, bound_by = dif_rows_wide_bound(f, rows, log_n, factor is not None)
        out.append({"role": role, "field": f.name, "instance": NW.instance(f), "rows": rows,
                    "N": 1 << log_n, "factor": factor is not None, "layout": layout,
                    "main_path": main_layout, "plan": NW.wide_plan(rows, log_n, NW.instance(f)),
                    "compared_rows": int(idx.numel()), "max_abs_diff": err,
                    "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by})
        plain_txt = "" if plain_ms is None else f", plain {plain_ms:.3f} ms ({idx.numel()} rows)"
        log(f"  {role:32s} {layout:9s} factor {factor is not None!s:5s} ({rows}, {1 << log_n}) "
            f"exact at {idx.numel()} rows; kernel {kernel_ms:.4f} ms{plain_txt}, bound "
            f"{bound_ms:.4f} ms ({bound_by})")

    for fname, rows, log_n, forward, role in WIDE_SHAPES:
        f = get_field(fname)
        tw = K._stage_twiddles(f, log_n, forward, dev)
        for tin, tout in LAYOUTS:
            shape = (1 << log_n, rows) if tin else (rows, 1 << log_n)
            x = _with_edges(f, field_elements(f, shape, gen, dev), dev)
            for with_factor in (False, True):
                factor = _with_edges(f, field_elements(f, shape, gen, dev), dev) \
                    if with_factor else None
                # the four-step's layouts: pass A columns in and out, pass B rows
                # in, columns out, times the factor
                main = (tin, tout, with_factor) == ((True, True, False) if "pass A" in role
                                                    else (False, True, True))
                compare(f, x, tw, factor, tin, tout, rows, role, True, main, log_n)
                del factor
            del x
        torch.cuda.empty_cache()
    for fname in EIGHT_LIMB_FIELDS:
        f = get_field(fname)
        for pass_b in (False, True):
            if f.params.rou is None:  # a stage table over random "powers"
                pw = field_elements(f, (128,), gen, dev)
                lane = torch.arange(256, device=dev)
                tw = torch.stack([pw[(lane & ((1 << (7 - s)) - 1)) << s] for s in range(8)])
            else:
                tw = K._stage_twiddles(f, 8, True, dev)
            x = _with_edges(f, field_elements(f, (256, 256), gen, dev), dev)
            factor = field_elements(f, (256, 256), gen, dev) if pass_b else None
            compare(f, x, tw, factor, not pass_b, True, 256, f"{fname} 2^16 pass "
                    f"{'B' if pass_b else 'A'}", False, fname == "bn254_scalar", 8)
    torch.cuda.empty_cache()
    return out


def wide_ntt_paths(dev, gen, smi: str, launches: dict) -> list:
    """The NTT over goldilocks and 8-limb fields through icicle_tpu_torch.ntt
    on CUDA tensors: goldilocks 2^24 (forward, inverse, a coset forward),
    bn254_scalar 2^22, stark252 and bls12_381_scalar 2^16; each NTT exactly
    two dif_rows_wide launches (counted), the forward equal to `_ntt_torch`
    on the card (goldilocks and bn254_scalar at full size, bn254_scalar also
    at 2^18), the inverse giving the input back; host-clock ms (median of 3
    after a warm-up) and butterflies/s; a profile of one forward goldilocks
    2^24 and bn254_scalar 2^22 NTT, two dif_rows_wide launches and no other
    device work."""
    from icicle_tpu_torch import NTTConfig, NTTDir, get_field, ntt
    from icicle_tpu_torch.ops import ntt as N

    def expect(count: int) -> dict:
        return dict(dict.fromkeys(kernel_counters(), 0), dif_rows_wide=count)

    paths = []
    for fname, logn, small_ref, coset, profiled in (
            ("goldilocks", GL_NTT_LOG, None, 7, True), ("bn254_scalar", BN_NTT_LOG, 18, None, True),
            ("stark252", 16, None, None, False), ("bls12_381_scalar", 16, None, None, False)):
        f = get_field(fname)
        n = 1 << logn
        x = _with_edges(f, field_elements(f, (n,), gen, dev), dev)
        label = f"ntt {fname} 2^{logn} fwd+inv"

        def fwd_inv():
            fwd = ntt(f, x, NTTDir.FORWARD)
            return fwd, ntt(f, fwd, NTTDir.INVERSE)

        y, z = counted(label, fwd_inv, launches)
        if launches[label] != expect(4):
            raise AssertionError(f"{label}: launched {launches[label]}, expected 4 dif_rows_wide "
                                 "for two NTTs and nothing else")
        if y.shape != x.shape or y.dtype != torch.int32 or not torch.equal(z, x):
            raise AssertionError(f"{label}: inverse(forward(x)) != x")
        t0 = time.perf_counter()
        if not torch.equal(y, N._ntt_torch(f, x, NTTDir.FORWARD, NTTConfig())):
            raise AssertionError(f"{label}: forward != _ntt_torch at 2^{logn}")
        plain_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        checked = [logn]
        if small_ref is not None:
            xs = x[:1 << small_ref].contiguous()
            if not torch.equal(ntt(f, xs), N._ntt_torch(f, xs, NTTDir.FORWARD, NTTConfig())):
                raise AssertionError(f"{fname}: forward != _ntt_torch at 2^{small_ref}")
            checked.append(small_ref)
        row = {"field": fname, "logn": logn, "checked_against_torch": checked,
               "plain_check_s": plain_s}
        if coset is not None:
            cfg = NTTConfig(coset_gen=coset)
            clabel = f"ntt {fname} 2^{logn} coset fwd"
            yc = counted(clabel, lambda: ntt(f, x, NTTDir.FORWARD, cfg), launches)
            if launches[clabel] != expect(2):
                raise AssertionError(f"{clabel}: launched {launches[clabel]}, expected 2")
            if not torch.equal(yc, N._ntt_torch(f, x, NTTDir.FORWARD, cfg)):
                raise AssertionError(f"{clabel}: != _ntt_torch")
            if not torch.equal(ntt(f, yc, NTTDir.INVERSE, cfg), x):
                raise AssertionError(f"{clabel}: the inverse coset NTT does not give x back")
            row["coset_gen"] = coset
            del yc
        fwd_ms, _ = host_ms(lambda: ntt(f, x, NTTDir.FORWARD), reps=3)
        inv_ms, _ = host_ms(lambda: ntt(f, y, NTTDir.INVERSE), reps=3)
        bfly = logn * (n >> 1)
        bound_ms, bound_by = wide_ntt_bound(f, logn)
        row.update(forward_ms=fwd_ms, inverse_ms=inv_ms,
                   butterflies_per_s=bfly / (fwd_ms * 1e-3), bound_ms=bound_ms,
                   bound_by=bound_by)
        log(f"  {fname} NTT 2^{logn}: 2 dif_rows_wide launches per NTT, fwd == _ntt_torch at "
            f"2^{checked} ({plain_s:.1f} s plain), inv round trip exact"
            f"{', coset fwd too' if coset else ''}; forward {fwd_ms:.3f} ms "
            f"({bfly / (fwd_ms * 1e-3):.4g} butterflies/s), inverse {inv_ms:.3f} ms; bound "
            f"{bound_ms:.3f} ms ({bound_by}) [{smi}]")
        if profiled:
            _, prof = device_profile(f"{fname} 2^{logn} forward NTT",
                                     lambda: ntt(f, x, NTTDir.FORWARD), smi)
            if (prof["copies"] or prof["copy_calls"] or prof["launch_calls"] != 2
                    or any("dif_rows_wide" not in k for k, _, _ in prof["kernels"])):
                raise AssertionError(f"{fname} 2^{logn} NTT ran device work other than two "
                                     f"dif_rows_wide launches: {prof}")
            row["profile"] = prof
        paths.append(row)
        del x, y, z
        torch.cuda.empty_cache()
    return paths


def gl_merkle_path(dev, gen, smi: str, launches: dict) -> dict:
    """MerkleTree([Poseidon2(goldilocks, 2)] * 28, leaf_words=2) over 2^28
    leaves made on the card (2 GiB, the 2^29 babybear tree's bytes): 28
    poseidon2 launches and no other device kernel (counted and profiled);
    leaves/s on the host clock, median of 3 after a warm-up; every layer at
    4096 sampled parents against the plain version on the card; pruned and
    full proofs verify, and fail with the leaf flipped (_tree_path)."""
    from icicle_tpu_torch import MerkleTree, Poseidon2, get_field
    from icicle_tpu_torch.kernels.poseidon2_kernel import needed_monts

    f = get_field("goldilocks")
    n = 1 << GL_MERKLE_LOG
    h = Poseidon2(f, 2)
    tree = MerkleTree([h] * GL_MERKLE_LOG, leaf_words=2)
    leaves = field_elements(f, (n,), gen, dev)
    torch.cuda.synchronize()
    nbytes = 8 * (n + 2 * (n - 2) + 1)  # leaves, internal layers out and in, root
    bound_ms, bound_by = bound(nbytes, (n - 1) * needed_monts(h, 2) * GL64_MULS)
    out = _tree_path(GL_MERKLE_MAIN, tree, leaves, "poseidon2", launches, smi, gen, dev,
                     lambda rows: h.hash_fields_ref(rows.reshape(-1, 2, 2)), bound_ms, bound_by)
    del leaves
    tree.layers = []
    torch.cuda.empty_cache()
    return out


def _horner(coeffs, x: int, p: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + int(c)) % p
    return acc


def polynomial_paths(dev, gen, smi: str, launches: dict) -> dict:
    """The polynomial API on CUDA tensors: a bn254_scalar Polynomial of 2^20
    coefficients times another (three 2^21 NTTs: 6 dif_rows_wide launches),
    checked at one random point on the host by Python-int Horner, a(r) b(r)
    == (ab)(r); divide_by_vanishing(2^20) of q (x^(2^20) - 1), built by
    shifting coefficients, gives q back; eval_on_rou_domain(21) of the
    product equals the pointwise product of the factors' evaluations; then
    a babybear multiply of 2^21 x 2^21 coefficients (2^22 NTTs: 6 dif_rows
    launches), checked the same way. Host-clock ms (median of 3 after a
    warm-up) and a profile of each multiply."""
    from icicle_tpu_torch import Polynomial, get_field

    out = {}
    for fname, log_m, label, kernel in ((("bn254_scalar", POLY_BN_LOG, POLY_BN_MAIN,
                                          "dif_rows_wide")),
                                        ("babybear", POLY_BB_LOG, POLY_BB_MAIN, "dif_rows")):
        f = get_field(fname)
        p = f.modulus
        m = 1 << log_m
        a = Polynomial.from_coeffs(f, field_elements(f, (m,), gen, dev))
        b = Polynomial.from_coeffs(f, field_elements(f, (m,), gen, dev))
        ab = counted(label, lambda: a * b, launches)
        want = dict(dict.fromkeys(kernel_counters(), 0), **{kernel: 6})
        if launches[label] != want:
            raise AssertionError(f"{label}: launched {launches[label]}, expected 6 {kernel}")
        if ab.size != 2 * m - 1:
            raise AssertionError(f"{label}: product size {ab.size}")
        t0 = time.perf_counter()
        r = int(np.random.default_rng(log_m).integers(1, 1 << 62)) % p
        lhs = _horner(a.to_ints(), r, p) * _horner(b.to_ints(), r, p) % p
        rhs = _horner(ab.to_ints(), r, p)
        horner_s = time.perf_counter() - t0
        if lhs != rhs:
            raise AssertionError(f"{label}: a(r) b(r) != (ab)(r) at r = {r}")
        ms, _ = host_ms(lambda: a * b, reps=3)
        _, prof = device_profile(f"{label} multiply", lambda: a * b, smi)
        if prof["launch_calls"] < 6:
            raise AssertionError(f"{label}: the profile saw {prof['launch_calls']} launch calls")
        row = {"coefficients": m, "product_size": ab.size, "multiply_ms": ms,
               "horner_check_s": horner_s, "point": r, "profile": prof}
        log(f"  {label}: {kernel} x 6, a(r) b(r) == (ab)(r) at a random r (Python-int Horner, "
            f"{horner_s:.1f} s); multiply {ms:.3f} ms [{smi}]")
        if fname == "bn254_scalar":
            q = a.coeffs[:m]
            shifted = Polynomial.from_coeffs(f, torch.cat([f.neg(q), q]))  # q x^m - q
            if not torch.equal(shifted.divide_by_vanishing(m).copy_coeffs(), q):
                raise AssertionError(f"{label}: divide_by_vanishing(2^{log_m}) of "
                                     "q (x^N - 1) != q")
            log_d = log_m + 1
            ev = ab.eval_on_rou_domain(log_d)
            if not torch.equal(ev, f.mul(a.eval_on_rou_domain(log_d),
                                         b.eval_on_rou_domain(log_d))):
                raise AssertionError(f"{label}: eval_on_rou_domain({log_d}) of ab != a's times b's")
            row["checks"] = ["divide_by_vanishing", "eval_on_rou_domain"]
            log(f"  {label}: divide_by_vanishing(2^{log_m}) of q (x^N - 1) == q; "
                f"eval_on_rou_domain({log_d}) of ab == the factors' evaluations multiplied")
        out[label] = row
        del a, b, ab
        torch.cuda.empty_cache()
    return out


# -- the other hashes: poseidon, blake2s, blake3; their trees; FRI over Blake3 ---------

POSEIDON_WORD_FIELDS = ("babybear", "koalabear", "m31")
POSEIDON_LIMB_FIELDS = ("bn254_scalar", "grumpkin_scalar", "bls12_377_scalar",
                        "bls12_381_scalar", "stark252")
POSEIDON_CHECK_BATCH = {1: 1 << 12, 8: 1 << 8}  # by limbs
POSEIDON_RAGGED = 37                            # rows past a multiple of the block
# (field, t, domain tag, ragged rows): every single-word instance with and
# without a tag; every 8-limb instance (each width and partial-round count)
# on bn254_scalar and bls12_381_scalar with and without a tag, the other
# three fields' constants at t = 3 and 12 (the 8-limb plain version takes
# about a second a call on the card); a ragged batch for each kind
POSEIDON_CHECKS = (
    [(f, t, tag, 0) for f in POSEIDON_WORD_FIELDS for t in (3, 5, 9, 12) for tag in (None, 0)]
    + [(f, 5, None, POSEIDON_RAGGED) for f in POSEIDON_WORD_FIELDS]
    + [(f, t, tag, 0) for f in ("bn254_scalar", "bls12_381_scalar") for t in (3, 5, 9, 12)
       for tag in (None, 0)]
    + [(f, t, tag, 0) for f in ("grumpkin_scalar", "bls12_377_scalar", "stark252")
       for t, tag in ((3, None), (3, 0), (12, None))]
    + [(f, 5, None, POSEIDON_RAGGED) for f in ("bn254_scalar", "bls12_381_scalar")])
POSEIDON_TIMED = 1 << 24                        # babybear t = 9 with a tag, timed alone
P1_LOG = 24          # leaves of the oct-trees: 2^24 of 32 bytes, a 512 MiB sector
P1_DEPTH = P1_LOG // 3
P1_MAIN = f"merkle bls12_381_scalar poseidon t=9 oct-tree 2^{P1_LOG}"
P1_WORD = f"merkle babybear poseidon t=9 oct-tree 2^{P1_LOG}"
P2_LOG = 26          # leaves of the binary Blake trees: 2^26 of 32 bytes, 2 GiB
P2_MAIN = {"blake2s": f"merkle blake2s 2^{P2_LOG}", "blake3": f"merkle blake3 2^{P2_LOG}"}
P3_LOG, P3_BYTES = 14, 8192  # Blake3 over 2^14 messages of 8 KiB
P3_MAIN = f"blake3 2^{P3_LOG} x {P3_BYTES} bytes"
P4_MAIN = f"fri babybear 2^{FRI_LOG} over blake3"
P4_SMALL_LOG = 10
BLAKE2S_WORDS = (16, 0, 1, 8, 17, 40)   # hash_words row widths checked; the first timed plain
BLAKE2S_BYTES = (13, 130)               # and byte lengths off a word
BLAKE3_BYTES = (64, 0, 4, 65, 1024, 1025, 3072, 4096, 5120)
BLAKE_CHECK_BATCH = 1 << 12
BLAKE_SASS = (("blake2s", "blake2s_kernelILb1E"), ("blake3", "blake3_chunksILb1E"),
              ("blake3", "blake3_parents"), ("poseidon", "babybear_t9E"),
              ("poseidon_limbs", "LimbsILi9ELi4ELi57E"))


def poseidon_bound(h, batch: int) -> tuple[float, str]:
    """Rows in and digests out once and the constant table once, against the
    multiplies a hash needs (poseidon_kernel.needed_monts) at 3 (one word)
    or 4 L^2 + L (L limbs) integer multiplies a Montgomery multiply."""
    from icicle_tpu_torch.kernels.poseidon_kernel import needed_monts
    nl = h.field.nlimbs
    table = h.constants("cpu").table.shape[0]
    return bound((batch * (h.arity + 1) + table) * nl * 4,
                 batch * needed_monts(h) * field_muls(h.field))


def blake_bound(module, compressions: int, nbytes: int, clock_mhz: float) -> tuple[float, str]:
    """The bytes moved against the integer instructions: a compression's
    non-add instructions on the ALU pipe (64 lanes a clock an SM), all of
    them through the four schedulers (128 lanes a clock an SM); its adds may
    issue on the FMA pipe (IMAD.IADD). module: blake2s_kernel or
    blake3_kernel (COMPRESS_OPS, COMPRESS_ADDS)."""
    alu = compressions * (module.COMPRESS_OPS - module.COMPRESS_ADDS) / alu_ops_per_s(clock_mhz)
    issue = compressions * module.COMPRESS_OPS / (2 * alu_ops_per_s(clock_mhz))
    byte_s = nbytes / HBM_BYTES_PER_S
    return (byte_s * 1e3, "bytes") if byte_s >= max(alu, issue) else \
        (max(alu, issue) * 1e3, "operations")


def check_hash_kernels(dev, gen, smi: str, clock_mhz: float) -> dict:
    """poseidon, blake2s and blake3 against their plain versions on the card,
    bit for bit: Poseidon at POSEIDON_CHECKS, 0 and p - 1 among the inputs;
    Blake2s at
    BLAKE2S_WORDS words and BLAKE2S_BYTES bytes, Blake3 at BLAKE3_BYTES
    bytes. Each timed (median CUDA-event ms), the plain version at the
    first shape of each kind; then poseidon alone at babybear t = 9 with a
    tag, POSEIDON_TIMED hashes."""
    import hashlib

    from icicle_tpu_torch import Poseidon, get_field
    from icicle_tpu_torch.kernels import blake2s_kernel as B2
    from icicle_tpu_torch.kernels import blake3_kernel as B3
    from icicle_tpu_torch.kernels import poseidon_kernel as PK

    rows = {"poseidon": [], "blake2s": [], "blake3": []}
    for fname, t, tag, ragged in POSEIDON_CHECKS:
        f = get_field(fname)
        h = Poseidon(f, t, domain_tag=tag)
        batch = POSEIDON_CHECK_BATCH[f.nlimbs] + ragged
        # the first row all 0, the second all p - 1
        x = _with_edges(f, field_elements(f, (batch, h.arity), gen, dev), dev, count=h.arity)
        role = f"{fname} t={t}{' tag' if tag is not None else ''}" + \
            (f" ragged {batch}" if ragged else "")
        err = _exact(f"poseidon {role}", PK.poseidon(h, x), h.hash_fields_ref(x))
        row = {"role": role, "field": fname, "t": t, "domain_tag": tag, "batch": batch,
               "checked": True, "edge_rows": True, "max_abs_diff": err,
               "kernel_ms": cuda_ms(lambda: PK.poseidon(h, x))}
        row["bound_ms"], row["bound_by"] = poseidon_bound(h, batch)
        if (fname, t, tag) in (("babybear", 9, 0), ("bls12_381_scalar", 9, 0)):
            row["plain_ms"] = cuda_ms(lambda: h.hash_fields_ref(x), reps=3)
        rows["poseidon"].append(row)
        log(f"  poseidon {role:32s} ({batch}, {h.arity}) exact, edge rows too; kernel "
            f"{row['kernel_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        del x
    for r in rows["poseidon"]:
        if "plain_ms" in r:
            log(f"  poseidon {r['role']} ({r['batch']}): kernel {r['kernel_ms']:.4f} ms, plain "
                f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{smi}]")
    h = Poseidon("babybear", 9, domain_tag=0)
    x = field_elements(get_field("babybear"), (POSEIDON_TIMED, 8), gen, dev)
    kernel_ms = cuda_ms(lambda: PK.poseidon(h, x))
    bound_ms, bound_by = poseidon_bound(h, POSEIDON_TIMED)
    rows["poseidon"].append({"role": f"babybear t=9 tag, {POSEIDON_TIMED} hashes", "t": 9,
                             "field": "babybear", "domain_tag": 0, "batch": POSEIDON_TIMED,
                             "checked": False, "kernel_ms": kernel_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by})
    log(f"  poseidon babybear t=9 tag ({POSEIDON_TIMED}, 8): kernel {kernel_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}), {kernel_ms / bound_ms:.2f}x; "
        f"{POSEIDON_TIMED / (kernel_ms * 1e-3):.4g} hashes/s [{smi}]")
    del x

    def rand_words(batch: int, w: int) -> torch.Tensor:
        return torch.randint(-2 ** 31, 2 ** 31, (batch, w), generator=gen, device=dev,
                             dtype=torch.int32)

    checks = ([(B2, w, 4 * w) for w in BLAKE2S_WORDS] + [(B2, -(-n // 4), n) for n in BLAKE2S_BYTES]
              + [(B3, -(-n // 4), n) for n in BLAKE3_BYTES])
    for mod, w, nbytes in checks:
        name = mod.LIBRARY
        kernel, ref = getattr(mod, name), getattr(mod, f"{name}_ref")
        x = rand_words(BLAKE_CHECK_BATCH, w)
        if nbytes % 4:     # the zero tail of a message that ends inside a word
            x[:, -1] &= (1 << (8 * (nbytes % 4))) - 1
        got = kernel(x, nbytes)
        err = _exact(f"{name} {nbytes} bytes", got, ref(x, nbytes))
        if name == "blake2s":
            for i in (0, BLAKE_CHECK_BATCH - 1):
                msg = x[i].cpu().numpy().view(np.uint32).astype("<u4").tobytes()[:nbytes]
                if got[i].cpu().numpy().view(np.uint32).astype("<u4").tobytes() != \
                        hashlib.blake2s(msg).digest():
                    raise AssertionError(f"blake2s {nbytes} bytes: row {i} != hashlib")
        comps = B3.compressions(nbytes) if mod is B3 else B2.nof_blocks(nbytes)
        row = {"role": f"{nbytes} bytes ({w} words)", "batch": BLAKE_CHECK_BATCH, "in_words": w,
               "nbytes": nbytes, "checked": True, "max_abs_diff": err,
               "kernel_ms": cuda_ms(lambda: kernel(x, nbytes))}
        row["bound_ms"], row["bound_by"] = blake_bound(mod, BLAKE_CHECK_BATCH * comps,
                                                       BLAKE_CHECK_BATCH * (w + 8) * 4, clock_mhz)
        if not rows[name]:
            row["plain_ms"] = cuda_ms(lambda: ref(x, nbytes), reps=3)
        rows[name].append(row)
        del x, got
    for name, also in (("blake2s", " and hashlib"), ("blake3", "")):
        log(f"  {name}: " + ", ".join(str(r["nbytes"]) for r in rows[name]) + f" bytes x "
            f"{BLAKE_CHECK_BATCH} rows == {name}_ref on the card{also}; kernel "
            + ", ".join(f"{r['kernel_ms']:.4f}" for r in rows[name]) + " ms; plain "
            f"{rows[name][0]['plain_ms']:.2f} ms at {rows[name][0]['nbytes']} bytes")
    torch.cuda.empty_cache()
    return rows


def _tree_path(label: str, tree, leaves, kname: str, launches: dict, smi: str, gen, dev,
               h_ref, bound_ms: float, bound_by: str, profile: bool = True) -> dict:
    """One counted build (`depth` launches of kname and nothing else), the
    build timed on the host clock (median of 3 after a warm-up), a profile
    that ran kname only (with `profile`); every layer at 4096 sampled
    parents against h_ref (the plain version: a (rows, in_words) -> (rows,
    digest) function) of their children on the card; proofs of the first,
    the last and 8 random leaves verify, and fail flipped."""
    from icicle_tpu_torch.ops.merkle import MerkleProof
    depth = len(tree.hashers)
    n = leaves.shape[0]
    root = counted(label, lambda: tree.build(leaves), launches)
    if launches[label] != dict(dict.fromkeys(kernel_counters(), 0), **{kname: depth}):
        raise AssertionError(f"{label}: launched {launches[label]}, expected {depth} {kname} and "
                             "nothing else")
    ms, last = host_ms(lambda: tree.build(leaves), reps=3)
    if not np.array_equal(last, root):
        raise AssertionError(f"{label}: timed root {last} != {root}")
    prof = None
    if profile:
        _, prof = device_profile(label, lambda: tree.build(leaves), smi)
        if prof["launch_calls"] != depth or any(kname not in k for k, _, _ in prof["kernels"]):
            raise AssertionError(f"{label}: ran device kernels other than {depth} {kname} "
                                 f"launches: {prof['launch_calls']} launch calls, kept "
                                 f"{prof['kernels']}")
    for i in range(1, depth + 1):
        below, layer = tree.layers[i - 1], tree.layers[i]
        m = layer.shape[0]
        pick = torch.randint(0, m, (min(m, 4096),), generator=gen, device=dev)
        if not torch.equal(layer[pick], h_ref(below.reshape(m, -1)[pick])):
            raise AssertionError(f"{label}, layer {i}: sampled parents != the plain version")
    rng = np.random.default_rng(1)
    proved = [0, n - 1] + [int(i) for i in rng.integers(0, n, size=8)]
    for idx in proved:
        for pruned in (True, False):
            proof = tree.get_merkle_proof(leaves, idx, pruned=pruned)
            bad = MerkleProof(proof.leaf ^ 1, idx, proof.root, proof.path, pruned)
            if not tree.verify(proof) or tree.verify(bad):
                raise AssertionError(f"{label}: the proof of leaf {idx} (pruned {pruned}) does "
                                     "not verify, or verifies flipped")
    log(f"  {label}: {depth} {kname} launches and nothing else; build {ms:.3f} ms, "
        f"{n / (ms * 1e-3):.4g} leaves/s, bound {bound_ms:.3f} ms ({bound_by}); every layer == "
        f"the plain version at 4096 sampled parents; proofs of {proved} verify, fail flipped "
        f"[{smi}]")
    return {"leaves": n, "layers": depth, "build_ms": ms, "leaves_per_s": n / (ms * 1e-3),
            "bound_ms": bound_ms, "bound_by": bound_by, "root": [int(w) for w in root],
            "profile": prof, "proved_leaves": proved, "card": smi}


def hash_paths(dev, gen, smi: str, launches: dict, clock_mhz: float) -> dict:
    """P1: Poseidon oct-trees (t = 9 with a tag: 8 children a hash) over 2^24
    leaves, bls12_381_scalar (Filecoin's tree over a 512 MiB sector) and
    babybear; P2: binary Blake2s and Blake3 trees over 2^26 leaves of 32
    bytes; P3: Blake3 over 2^14 messages of 8 KiB; P4: fri_prove at
    babybear 2^22 over Blake3 round trees. Each counted, timed and checked
    against the plain versions on the card."""
    from icicle_tpu_torch import Blake2s, Blake3, MerkleTree, Poseidon, get_field
    from icicle_tpu_torch.kernels import blake2s_kernel as B2
    from icicle_tpu_torch.kernels import blake3_kernel as B3
    from icicle_tpu_torch.kernels import poseidon_kernel as PK
    from icicle_tpu_torch.kernels import protocol_lib as L

    out = {}
    # P1: the oct-trees
    n = 1 << P1_LOG
    hashes = sum(n >> (3 * k) for k in range(1, P1_DEPTH + 1))
    for label, fname in ((P1_MAIN, "bls12_381_scalar"), (P1_WORD, "babybear")):
        f = get_field(fname)
        h = Poseidon(f, 9, domain_tag=0)
        lw = h.digest_words
        leaves = field_elements(f, (n,), gen, dev).reshape(n, lw)
        tree = MerkleTree([h] * P1_DEPTH, leaf_words=lw)
        torch.cuda.synchronize()
        bound_ms, bound_by = bound((n + 2 * hashes - 1) * lw * 4,
                                   hashes * PK.needed_monts(h) * field_muls(f))
        out[label] = _tree_path(label, tree, leaves, "poseidon", launches, smi, gen, dev,
                                lambda rows, h=h, lim=f.limb_shape: h.hash_fields_ref(
                                    rows.reshape((rows.shape[0], 8) + lim)).reshape(
                                        rows.shape[0], -1),
                                bound_ms, bound_by, profile=label == P1_MAIN)
        rows = tree.layers[0].reshape((n // 8, 8) + f.limb_shape)
        leaf_ms = cuda_ms(lambda: PK.poseidon(h, rows), reps=3)
        lb = poseidon_bound(h, n // 8)
        out[label]["leaf_layer"] = {"batch": n // 8, "kernel_ms": leaf_ms, "bound_ms": lb[0],
                                    "bound_by": lb[1]}
        log(f"  {label} leaf layer ({n // 8} hashes): kernel {leaf_ms:.3f} ms, bound "
            f"{lb[0]:.3f} ms ({lb[1]}), {leaf_ms / lb[0]:.2f}x [{smi}]")
        del leaves, rows
        tree.layers = []
        torch.cuda.empty_cache()

    # P2: binary Blake trees over the same 2^26 leaves
    n = 1 << P2_LOG
    leaves = torch.randint(-2 ** 31, 2 ** 31, (n, 8), generator=gen, device=dev,
                           dtype=torch.int32)
    for name, cls, mod in (("blake2s", Blake2s, B2), ("blake3", Blake3, B3)):
        h = cls().with_input_words(16)
        tree = MerkleTree([h] * P2_LOG, leaf_words=8)
        torch.cuda.synchronize()
        ref = getattr(mod, f"{name}_ref")
        bound_ms, bound_by = blake_bound(mod, n - 1, (n * 8 + 2 * (n - 2) * 8 + 8) * 4,
                                         clock_mhz)
        label = P2_MAIN[name]
        out[label] = _tree_path(label, tree, leaves, name, launches, smi, gen, dev,
                                lambda rows, ref=ref: ref(rows, 64), bound_ms, bound_by)
        pairs = leaves.view(n // 2, 16)
        kernel = getattr(mod, name)
        leaf_ms = cuda_ms(lambda: kernel(pairs, 64))
        lb = blake_bound(mod, n // 2, (n // 2) * 24 * 4, clock_mhz)
        out[label]["leaf_layer"] = {"batch": n // 2, "kernel_ms": leaf_ms, "bound_ms": lb[0],
                                    "bound_by": lb[1]}
        log(f"  {label} leaf layer ({n // 2} compressions): kernel {leaf_ms:.3f} ms, bound "
            f"{lb[0]:.3f} ms ({lb[1]}), {leaf_ms / lb[0]:.2f}x [{smi}]")
        tree.layers = []
        del pairs
        torch.cuda.empty_cache()
    del leaves
    torch.cuda.empty_cache()

    # P3: Blake3 over multi-chunk messages
    batch, w = 1 << P3_LOG, P3_BYTES // 4
    x = torch.randint(-2 ** 31, 2 ** 31, (batch, w), generator=gen, device=dev,
                      dtype=torch.int32)
    levels = B3.parent_levels(P3_BYTES)
    h = Blake3()
    got = counted(P3_MAIN, lambda: h.hash_words(x), launches)
    if launches[P3_MAIN] != dict(dict.fromkeys(kernel_counters(), 0), blake3=1 + levels):
        raise AssertionError(f"{P3_MAIN}: launched {launches[P3_MAIN]}, expected {1 + levels}")
    _exact(P3_MAIN, got, B3.blake3_ref(x, P3_BYTES))
    ms = cuda_ms(lambda: h.hash_words(x))
    # the chunk pass alone: its C entry into a scratch array, uncounted
    chunk_fn, _ = L.entry(B3.LIBRARY, "icicle_blake3_chunks", B3._CHUNK_ARGS)
    cvs = torch.empty((batch, B3.nof_chunks(P3_BYTES), 8), dtype=torch.int32, device=dev)
    chunk_ms = cuda_ms(lambda: chunk_fn(x.data_ptr(), cvs.data_ptr(), batch, w, P3_BYTES, 1,
                                        L.stream()))
    comps = batch * B3.compressions(P3_BYTES)
    bound_ms, bound_by = blake_bound(B3, comps, batch * (w + 8) * 4, clock_mhz)
    chunks = B3.nof_chunks(P3_BYTES)
    chunk_bound = blake_bound(B3, batch * P3_BYTES // 64, batch * (w + 8 * chunks) * 4, clock_mhz)
    out[P3_MAIN] = {"batch": batch, "nbytes": P3_BYTES, "launches": 1 + levels, "ms": ms,
                    "chunk_pass_ms": chunk_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "chunk_pass_bound_ms": chunk_bound[0], "card": smi}
    log(f"  {P3_MAIN}: 1 chunk pass + {levels} parent levels == blake3_ref on the card; "
        f"{ms:.4f} ms (chunk pass alone {chunk_ms:.4f} ms), bound {bound_ms:.4f} ms "
        f"({bound_by}; the chunk pass {chunk_bound[0]:.4f}) [{smi}]")
    del x, got, cvs

    # P4: FRI over Blake3 round trees
    out[P4_MAIN] = fri_main_path(dev, smi, launches, h=h, label=P4_MAIN, kname="blake3",
                                 small_log=P4_SMALL_LOG)
    return out


LAYOUTS = [(False, False), (False, True), (True, False), (True, True)]


def layout_name(tin: bool, tout: bool) -> str:
    return {(False, False): "rows", (False, True): "rows>cols", (True, False): "cols>rows",
            (True, True): "cols"}[(tin, tout)]


def time_dif_variants(f, dev, rand, K, smi: str) -> dict:
    """dif_rows at the 2^26 NTT's (8192, 2^13) with each tile height TR that
    fits (the plan's pick marked), in the two passes' layouts and the
    default one; and pass A's column reads against the transpose they
    replace (x.T.contiguous() and then a pass that reads rows)."""
    rows, log_n = 8192, 13
    tw = K._stage_twiddles(f, log_n, True, dev)
    out = {"shape": [rows, 1 << log_n], "card": smi, "tr": {}}
    for tin, tout, with_factor in ((True, True, False), (False, True, True),
                                   (False, False, False), (False, False, True)):
        shape = (1 << log_n, rows) if tin else (rows, 1 << log_n)
        x = rand(f, shape)
        factor = rand(f, shape) if with_factor else None
        plan_tr = K.dif_plan(rows, log_n, tin, tout)[0]
        times = {}
        for tr in (1, 2, 4, 8):
            if K.dif_smem_bytes(log_n, tr) <= K.SMEM_LIMIT:
                times[tr] = cuda_ms(lambda: K.dif_rows(f, x, tw, factor, transpose_in=tin,
                                                       transpose_out=tout, _tr=tr))
        key = layout_name(tin, tout) + (" factor" if with_factor else "")
        out["tr"][key] = {"plan_tr": plan_tr, "ms": times,
                          "bound_ms": dif_rows_bound(rows, log_n, with_factor)[0]}
        log(f"  TR variants, {key:15s}: " + ", ".join(
            f"TR {tr}{'*' if tr == plan_tr else ''} {ms:.4f} ms" for tr, ms in times.items())
            + f" (bound {out['tr'][key]['bound_ms']:.4f} ms) [{smi}]")
        del x, factor
    x = rand(f, (1 << log_n, rows))
    t_ms = cuda_ms(lambda: x.T.contiguous())
    via_t = cuda_ms(lambda: K.dif_rows(f, x.T.contiguous(), tw, transpose_out=True))
    cols = cuda_ms(lambda: K.dif_rows(f, x, tw, transpose_in=True, transpose_out=True))
    out["transpose_in"] = {"transpose_ms": t_ms, "transpose_then_rows_ms": via_t,
                           "cols_ms": cols}
    log(f"  pass A with column reads {cols:.4f} ms against x.T.contiguous() {t_ms:.4f} ms "
        f"then a row pass: {via_t:.4f} ms together")
    del x
    torch.cuda.empty_cache()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from icicle_tpu_torch import NTTConfig, NTTDir, get_field, ntt
    from icicle_tpu_torch.kernels import build, sass
    from icicle_tpu_torch.kernels.keccak_kernel import PERMUTATION_OPS
    from icicle_tpu_torch.kernels import ntt_kernel as K
    from icicle_tpu_torch.ops import ntt as N

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(20260816)

    def rand(f, shape):
        return torch.randint(0, f.modulus, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    # -- 1. card -------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log("== card")
    log(smi)
    sm_clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    log(f"max SM clock {sm_clock_mhz:g} MHz (the ALU-pipe bound's clock)")
    name = torch.cuda.get_device_name(0)
    log(f"torch: {name}, {torch.cuda.device_count()} device(s), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # seconds each phase took, from the start of the build
    phase_s = {}
    clock = [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now

    # -- 2. build ------------------------------------------------------------
    log("== build")
    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"built {sorted(reports) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib, text in reports.items():
        for line in text.splitlines():
            if ("ptxas info" in line and ("registers" in line or "Compiling" in line)) \
                    or "spill" in line or line.startswith("nvcc: "):
                log(f"  lib{lib}: {line.strip()}")
    p2_sass = sass.kernel_counts(build.lib_path("poseidon2"), P2_SASS_KERNEL)
    if len(p2_sass) != 1:
        raise AssertionError(f"libposeidon2: {len(p2_sass)} kernels match {P2_SASS_KERNEL}")
    p2_sass = next(iter(p2_sass.values()))["counts"]
    log(f"  libposeidon2 babybear t=2 single permutation, SASS per hash: {p2_sass}")
    keccak_sass = sass.kernel_counts(build.lib_path("keccak"), KECCAK_SASS_KERNEL)
    if len(keccak_sass) != 1:
        raise AssertionError(f"libkeccak: {len(keccak_sass)} kernels match {KECCAK_SASS_KERNEL}")
    keccak_sass = next(iter(keccak_sass.values()))["counts"]
    log(f"  libkeccak Keccak-256 word rows, SASS (one block's path and the loop around it; "
        f"the permutation needs {PERMUTATION_OPS} logic and shift instructions): {keccak_sass}")

    hash_sass = {}
    for lib, pattern in BLAKE_SASS:
        found = sass.kernel_counts(build.lib_path(lib), pattern)
        if len(found) != 1:
            raise AssertionError(f"lib{lib}: {len(found)} kernels match {pattern}")
        hash_sass[pattern] = next(iter(found.values()))["counts"]
        log(f"  lib{lib} {pattern} SASS (a static count; the kernels loop over blocks, and "
            f"poseidon_limbs over rounds): {hash_sass[pattern]}")

    phase_done("build")
    # -- 3. kernel versus plain ----------------------------------------------
    log("== kernels: dif_rows against dif_rows_ref on the card, every layout")
    # (field, rows, log_n, forward, factor, role on the main path); each pass
    # is checked in all four layouts, timed in each, and its plain version
    # timed in the layout the four-step gives it (pass A: columns in and
    # out, pass B: rows in, columns out)
    shapes = [
        ("babybear", 8192, 13, True, False, "2^26 fwd pass A"),
        ("babybear", 8192, 13, True, True, "2^26 fwd pass B"),
        ("babybear", 8192, 13, False, False, "2^26 inv pass A"),
        ("babybear", 8192, 13, False, True, "2^26 inv pass B"),
        ("koalabear", 4096, 12, True, False, "2^24 fwd pass A"),
        ("koalabear", 4096, 12, True, True, "2^24 fwd pass B"),
        ("babybear", 8192, 12, True, False, "2^25 fwd pass A (rows != N)"),
        ("babybear", 4096, 13, True, True, "2^25 fwd pass B (rows != N)"),
        ("babybear", 256, 8, True, False, "2^16 fwd pass A"),
        ("babybear", 256, 8, True, True, "2^16 fwd pass B"),
        ("babybear", 8192, 14, True, True, "2^27 fwd pass B (logN 14, 64 KB rows)"),
    ]
    shape_rows = []
    for fname, rows, log_n, forward, with_factor, role in shapes:
        f = get_field(fname)
        tw = K._stage_twiddles(f, log_n, forward, dev)
        main_layout = (False, True) if with_factor else (True, True)
        for tin, tout in LAYOUTS:
            shape = (1 << log_n, rows) if tin else (rows, 1 << log_n)
            x = rand(f, shape)
            factor = rand(f, shape) if with_factor else None

            def call(fn=K.dif_rows, x=x, factor=factor, tin=tin, tout=tout):
                return fn(f, x, tw, factor, transpose_in=tin, transpose_out=tout)

            got = call()
            torch.cuda.synchronize()
            want = call(K.dif_rows_ref)
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            layout = layout_name(tin, tout)
            if err != 0 or not torch.equal(got, want):
                raise AssertionError(f"dif_rows != dif_rows_ref at {role}, {layout}: "
                                     f"max abs err {err}")
            kernel_ms = cuda_ms(call)
            plain_ms = cuda_ms(lambda: call(K.dif_rows_ref), reps=3) \
                if (tin, tout) == main_layout else None
            bound_ms, bound_by = dif_rows_bound(rows, log_n, with_factor)
            shape_rows.append({"role": role, "field": fname, "rows": rows, "N": 1 << log_n,
                               "factor": with_factor, "layout": layout,
                               "main_path": (tin, tout) == main_layout,
                               "plan": K.dif_plan(rows, log_n, tin, tout),
                               "max_abs_diff": err, "kernel_ms": kernel_ms,
                               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by})
            plain = "" if plain_ms is None else f", plain {plain_ms:.3f} ms"
            log(f"  {role:38s} {layout:9s} {fname:9s} ({rows}, {1 << log_n}) exact; kernel "
                f"{kernel_ms:.4f} ms{plain}, bound {bound_ms:.4f} ms ({bound_by})")
            del x, factor, got, want
    torch.cuda.empty_cache()
    dif_variants = time_dif_variants(f=get_field("babybear"), dev=dev, rand=rand, K=K, smi=smi)
    phase_done("kernels: dif_rows")
    log("== kernels: dif_rows_wide against dif_rows_wide_ref on the card, both instances, "
        "every layout")
    wide_rows = check_wide_kernel(dev, gen, smi)
    phase_done("kernels: dif_rows_wide")
    log("== kernels: the MSM kernels B3-B7 against their plain versions on the card")
    msm_rows = check_msm_kernels(dev, gen, smi)
    phase_done("kernels: B3-B7")
    log("== kernels: poseidon2 against Poseidon2.hash_fields_ref on the card")
    p2_rows = check_poseidon2_kernel(dev, gen, smi)
    phase_done("kernels: poseidon2")
    log("== kernels: keccak, fri_fold, sumcheck_round, program against their plain versions "
        "on the card")
    protocol_rows = check_protocol_kernels(dev, gen, smi, sm_clock_mhz)
    phase_done("kernels: keccak, fri_fold, sumcheck_round, program")
    log("== kernels: poseidon, blake2s, blake3 against their plain versions on the card")
    hash_rows = check_hash_kernels(dev, gen, smi, sm_clock_mhz)
    phase_done("kernels: poseidon, blake2s, blake3")

    # -- 4. NTT main path -----------------------------------------------------
    log("== main path: icicle_tpu_torch.ntt on CUDA tensors")
    launches = {}  # main path -> {kernel: launches in that path's checked run}
    paths = []
    for fname, logn in (("babybear", 26), ("koalabear", 24), ("babybear", 16)):
        f = get_field(fname)
        x = rand(f, (1 << logn,))
        label = f"ntt {fname} 2^{logn} fwd+inv"

        def fwd_inv():
            fwd = ntt(f, x, NTTDir.FORWARD)
            return fwd, ntt(f, fwd, NTTDir.INVERSE)

        y, z = counted(label, fwd_inv, launches)
        if launches[label] != dict(dict.fromkeys(kernel_counters(), 0), dif_rows=4):
            raise AssertionError(f"{label}: launched {launches[label]}, expected 4 dif_rows "
                                 "for two NTTs and nothing else")
        ref = N._ntt_torch(f, x, NTTDir.FORWARD, NTTConfig())
        if y.shape != x.shape or y.dtype != torch.int32 or not torch.equal(y, ref):
            raise AssertionError(f"{fname} 2^{logn}: forward NTT != _ntt_torch")
        if not torch.equal(z, x):
            raise AssertionError(f"{fname} 2^{logn}: inverse(forward(x)) != x")
        if int(y.min()) < 0 or int(y.max()) >= f.modulus:
            raise AssertionError(f"{fname} 2^{logn}: output not canonical")
        del ref, z
        fwd_ms, _ = host_ms(lambda: ntt(f, x, NTTDir.FORWARD))
        inv_ms, _ = host_ms(lambda: ntt(f, y, NTTDir.INVERSE))
        bfly = logn * (1 << (logn - 1))
        paths.append({"field": fname, "logn": logn, "forward_ms": fwd_ms,
                      "inverse_ms": inv_ms, "butterflies_per_s": bfly / (fwd_ms * 1e-3)})
        log(f"  {fname} NTT 2^{logn}: fwd == _ntt_torch, inv round trip exact, 2 launches per "
            f"NTT; forward {fwd_ms:.3f} ms ({bfly / (fwd_ms * 1e-3):.4g} butterflies/s), "
            f"inverse {inv_ms:.3f} ms [{smi}]")
        del x, y

    # -- where the time goes: device time by kernel -------------------------
    log("== profile: device time by kernel, one forward and one inverse babybear NTT")
    f = get_field("babybear")
    for logn in (26, 16):
        x = rand(f, (1 << logn,))
        y = ntt(f, x, NTTDir.FORWARD)
        torch.cuda.synchronize()
        for direction, v in ((NTTDir.FORWARD, x), (NTTDir.INVERSE, y)):
            _, prof = device_profile(f"2^{logn} {direction.value} NTT",
                                     lambda: ntt(f, v, direction), smi)
            # the four-step is two dif_rows launches and no other device work
            if (prof["copies"] or prof["copy_calls"] or prof["launch_calls"] != 2
                    or any("dif_rows" not in k for k, _, _ in prof["kernels"])):
                raise AssertionError(f"2^{logn} {direction.value} NTT ran device work other "
                                     f"than two dif_rows launches: {prof}")
        del x, y
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    phase_done("main path: ntt")

    # -- 5. MSM main paths ----------------------------------------------------
    log("== main paths: the MSM routes (msm_affine, its r12 engine and v2 pipeline, msm_tpu) "
        "on CUDA tensors")
    msm = msm_main_paths(dev, smi, launches)
    phase_done("main path: msm")

    # -- 6. Merkle main path --------------------------------------------------
    log("== main path: the babybear Poseidon2 Merkle tree (MerkleTree.build) on CUDA tensors")
    merkle = merkle_main_path(dev, gen, smi, launches)
    phase_done("main path: merkle")

    # -- 7. FRI and sumcheck main paths -----------------------------------------
    log(f"== main path: the FRI prover (fri_prove) at babybear 2^{FRI_LOG} on CUDA tensors")
    fri = fri_main_path(dev, smi, launches)
    phase_done("main path: fri")
    log("== main path: the sumcheck prover (sumcheck_prove) on CUDA tensors")
    sumcheck = sumcheck_main_path(dev, smi, launches)
    phase_done("main path: sumcheck")
    log("== main paths: the field layer -- the NTT over goldilocks and 8-limb fields, a "
        "goldilocks Poseidon2 Merkle tree, polynomials -- on CUDA tensors")
    wide_ntt = wide_ntt_paths(dev, gen, smi, launches)
    phase_done("main path: ntt over limb fields")
    gl_merkle = gl_merkle_path(dev, gen, smi, launches)
    phase_done("main path: goldilocks merkle")
    polys = polynomial_paths(dev, gen, smi, launches)
    phase_done("main path: polynomials")
    log("== main paths: the other hashes -- Poseidon oct-trees, Blake2s and Blake3 trees, "
        "Blake3 over long messages, FRI over Blake3 -- on CUDA tensors")
    hashes = hash_paths(dev, gen, smi, launches, sm_clock_mhz)
    phase_done("main path: hashes (P1-P4)")
    log("seconds a phase: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))

    # -- 7. main paths line ---------------------------------------------------
    print(json.dumps({"main_paths": {"ntt": paths, "msm": msm, "merkle": merkle, "fri": fri,
                                     "sumcheck": sumcheck, "ntt_limb_fields": wide_ntt,
                                     "merkle_goldilocks": gl_merkle, "polynomials": polys,
                                     "hashes": hashes, "launches": launches, "phase_s": phase_s,
                                     "card": smi}}))

    # -- 8. kernels line ------------------------------------------------------
    # launches: the kernel's count in the checked run of its headline main
    # path (one babybear 2^26 NTT forward + inverse; one bn254 2^24 MSM of
    # its route, 2^20 for v1; one 2^29 Merkle build); launches_per_path: its
    # count in every main path's checked run
    def per_path(kname: str) -> dict:
        return {path: counts[kname] for path, counts in launches.items()}

    main_pair = [r for r in shape_rows if r["role"].startswith("2^26 fwd") and r["main_path"]]
    entry = {
        "name": "dif_rows",
        "route": "cuda",
        "source": "icicle_tpu_torch/kernels/csrc/ntt_dif.cu",
        "replaces": "icicle_tpu/pallas/ntt_kernel.py:53 (make_dif_kernel), "
                    "icicle_tpu/pallas/ntt_kernel.py:172 (make_dif_kernel_mxu)",
        "launches": launches[NTT_MAIN]["dif_rows"],
        "launches_per_path": per_path("dif_rows"),
        "max_abs_err": max(r["max_abs_diff"] for r in shape_rows),
        # ms, plain_ms, bound_ms: the two launches of one babybear 2^26 forward
        # NTT, each in its layout there (pass A columns, pass B rows>cols)
        "ms": sum(r["kernel_ms"] for r in main_pair),
        "plain_ms": sum(r["plain_ms"] for r in main_pair),
        "bound_ms": sum(r["bound_ms"] for r in main_pair),
        "bound_by": main_pair[1]["bound_by"],
        "library_ms": None,  # no PyTorch call computes a prime-field NTT
        "shapes": shape_rows,
        "variants": dif_variants,
        "card": smi,
    }

    def msm_entry(kname: str, source: str, replaces: str, main_role: str,
                  headline: str) -> dict:
        # ms and bound_ms: one launch at the main path's widest full-depth
        # shape; plain_ms: the plain version at the cut depth of the first
        # checked shape, beside the kernel's ms there ("checked_ms")
        rows = msm_rows[kname]
        main = next(r for r in rows if r["role"] == main_role)
        checked = rows[0]
        return {
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[headline][kname], "headline_path": headline,
            "launches_per_path": per_path(kname),
            "max_abs_err": max(r["max_abs_diff"] for r in rows if r["checked"]),
            "ms": main["kernel_ms"], "plain_ms": checked["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,  # no PyTorch call computes an elliptic-curve add
            "shape": [main["depth"], main["lanes"]],
            "plain_shape": [checked["depth"], checked["lanes"]],
            "checked_ms": checked["kernel_ms"],
            "shapes": rows, "card": smi,
        }

    entries = [
        entry,
        msm_entry("prefix_scan", "icicle_tpu_torch/kernels/csrc/msm_scan.cu",
                  "icicle_tpu/pallas/msm_scan.py:45 (make_prefix_scan)",
                  "B3 at full depth (12 per 2^24 MSM)", MSM_24),
        msm_entry("ec_reduce", "icicle_tpu_torch/kernels/csrc/ec_reduce.cu",
                  "icicle_tpu/pallas/ec_reduce.py:63 (make_ec_reduce)",
                  "B4 cross-tile at full depth (12 per 2^24 MSM)", MSM_24),
        msm_entry("prefix_scan_r12", "icicle_tpu_torch/kernels/csrc/msm_scan_r12.cu",
                  "icicle_tpu/pallas/msm_scan_r12.py:135 (make_prefix_scan_r12)",
                  "B5 at full depth (12 per r12 2^24 MSM)", R12_24),
        msm_entry("suffix_fold", "icicle_tpu_torch/kernels/csrc/msm_fold2.cu",
                  "icicle_tpu/pallas/msm_fold2.py:75 (make_suffix_fold)",
                  "B6 at full depth (29 per v2 2^24 MSM)", V2_24),
        msm_entry("bucket_accum", "icicle_tpu_torch/kernels/csrc/bucket_accum.cu",
                  "icicle_tpu/pallas/msm_kernel.py:125 (make_bucket_accum)",
                  "B7 at full depth (2 per v1 2^20 MSM)", V1_20),
    ]
    # ms and bound_ms: one launch at the 2^29 tree's leaf layer; plain_ms: the
    # plain version at babybear t = 2, batch 2^16, where it was checked, beside
    # the kernel's ms there ("checked_ms")
    def p2_row(role: str) -> dict:
        return next(r for r in p2_rows if r["role"] == role)

    p2_main, p2_checked = p2_row("babybear t=2, the 2^29 tree's leaf layer"), p2_rows[0]
    entries.append({
        "name": "poseidon2", "route": "cuda",
        "source": "icicle_tpu_torch/kernels/csrc/poseidon2.cu",
        "replaces": "none (XLA): icicle_tpu/ops/hash/poseidon2.py:211 permute_mont",
        "launches": launches[MERKLE_MAIN]["poseidon2"], "headline_path": MERKLE_MAIN,
        "launches_per_path": per_path("poseidon2"),
        "max_abs_err": max(r["max_abs_diff"] for r in p2_rows if r["checked"]),
        "ms": p2_main["kernel_ms"], "plain_ms": p2_checked["plain_ms"],
        "bound_ms": p2_main["bound_ms"], "bound_by": p2_main["bound_by"],
        "library_ms": None,  # no PyTorch call computes a Poseidon2 permutation
        "shape": [p2_main["batch"], p2_main["n"]],
        "plain_shape": [p2_checked["batch"], p2_checked["n"]],
        "bound_plain_monts_ms": p2_main["bound_plain_monts_ms"],
        "checked_ms": p2_checked["kernel_ms"], "sass_per_hash": p2_sass, "shapes": p2_rows,
        "card": smi,
    })
    # K1-K4: ms and bound_ms at the main path's widest launch (keccak: the
    # FRI round-0 leaf layer; fri_fold: round 0; sumcheck_round: round 1 of
    # the 2^24 prove, the fold of 3 x 2^24; program: the claimed sum's), the
    # plain version's ms there
    def protocol_entry(kname: str, source: str, replaces: str, headline: str, main_role) -> dict:
        rows = protocol_rows[kname]
        main = next(r for r in rows if main_role(r))
        return {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[headline][kname], "headline_path": headline,
                "launches_per_path": per_path(kname),
                "max_abs_err": max(r["max_abs_diff"] for r in rows if r["checked"]),
                "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": None,  # no PyTorch call computes it
                "main_role": main["role"], "shapes": rows, "card": smi}

    entries += [
        dict(protocol_entry("keccak", "icicle_tpu_torch/kernels/csrc/keccak.cu",
                            "none (XLA): icicle_tpu/ops/hash/keccak.py:90 keccak_f1600, "
                            ":108 _absorb_padded, :148 hash_words", FRI_MAIN,
                            lambda r: r["role"] == "FRI 2^22 leaf layer"),
             sass=keccak_sass, permutation_ops=PERMUTATION_OPS, sm_clock_mhz=sm_clock_mhz),
        protocol_entry("fri_fold", "icicle_tpu_torch/kernels/csrc/fri_fold.cu",
                       "none (XLA): icicle_tpu/ops/fri.py:275 _fold_kernel", FRI_MAIN,
                       lambda r: "kernel_ms" in r and r["field"] == "babybear"),
        protocol_entry("sumcheck_round", "icicle_tpu_torch/kernels/csrc/sumcheck.cu",
                       "none (XLA): icicle_tpu/ops/sumcheck.py:145 _round_pass", SUMCHECK_MAIN,
                       lambda r: r.get("fold") is True),
        protocol_entry("program", "icicle_tpu_torch/kernels/csrc/program.cu",
                       "none (XLA): icicle_tpu/ops/vec_ops.py:258 execute_program over "
                       "icicle_tpu/ops/program.py:149 Program.execute", SUMCHECK_MAIN,
                       lambda r: "kernel_ms" in r),
    ]
    # dif_rows_wide, one entry an instance: ms, plain_ms and bound_ms the two
    # launches of one forward NTT of the path (pass A columns in and out, pass
    # B rows in, columns out, with the factor), the plain version at the
    # sampled rows ("plain_rows" of each pass)
    for inst, fname, headline, a_role, b_role in (
            ("gl64", "goldilocks", GL_NTT_MAIN, "goldilocks 2^24 fwd pass A",
             "goldilocks 2^24 inv pass B"),
            ("fp8", "bn254_scalar", BN_NTT_MAIN, "bn254_scalar 2^22 fwd pass A",
             "bn254_scalar 2^22 inv pass B")):
        rows = [r for r in wide_rows if r["instance"] == inst]
        pair = [next(r for r in rows if r["role"] == a_role and r["main_path"]
                     and not r["factor"]),
                next(r for r in rows if r["role"] == b_role and r["main_path"] and r["factor"])]
        entries.append({
            "name": f"dif_rows_wide ({inst})", "route": "cuda",
            "source": "icicle_tpu_torch/kernels/csrc/ntt_wide.cu",
            "replaces": "none (XLA): icicle_tpu/ops/ntt.py:223-329 _ntt_four_step / "
                        "_ntt_vecfirst (the JAX NTT of a limb field)",
            "launches": launches[headline]["dif_rows_wide"], "headline_path": headline,
            # the wrapper's count: every path that launched either instance
            "launches_per_path": {path: c["dif_rows_wide"] for path, c in launches.items()
                                  if c["dif_rows_wide"]},
            "max_abs_err": max(r["max_abs_diff"] for r in rows),
            "ms": sum(r["kernel_ms"] for r in pair),
            "plain_ms": sum(r["plain_ms"] for r in pair),
            "plain_rows": [r["compared_rows"] for r in pair],
            "bound_ms": sum(r["bound_ms"] for r in pair), "bound_by": pair[1]["bound_by"],
            "library_ms": None,  # no PyTorch call computes a prime-field NTT butterfly pass
            "shapes": rows, "card": smi})
    gl_rows = [r for r in p2_rows if r["field"] == "goldilocks"]
    gl_main, gl_checked = p2_row(GL_POSEIDON2_ROLE), p2_row("goldilocks t=2")
    entries.append({
        "name": "poseidon2 (gl64)", "route": "cuda",
        "source": "icicle_tpu_torch/kernels/csrc/poseidon2_gl64.cu",
        "replaces": "none (XLA): icicle_tpu/ops/hash/poseidon2.py:211 permute_mont",
        "launches": launches[GL_MERKLE_MAIN]["poseidon2"], "headline_path": GL_MERKLE_MAIN,
        "max_abs_err": max(r["max_abs_diff"] for r in gl_rows if r["checked"]),
        "ms": gl_main["kernel_ms"], "plain_ms": gl_checked["plain_ms"],
        "bound_ms": gl_main["bound_ms"], "bound_by": gl_main["bound_by"],
        "library_ms": None,  # no PyTorch call computes a Poseidon2 permutation
        "shape": [gl_main["batch"], gl_main["n"]],
        "plain_shape": [gl_checked["batch"], gl_checked["n"]],
        "checked_ms": gl_checked["kernel_ms"], "shapes": gl_rows, "card": smi})
    # poseidon (one wrapper, two libraries): single-word ms and bound_ms at
    # babybear t = 9 with a tag, 2^24 hashes, timed alone; 8-limb at P1's
    # leaf layer; plain_ms at the checked batch of the same (field, t, tag)
    pos = hash_rows["poseidon"]
    replaces = ("none (XLA): icicle_tpu/ops/hash/poseidon.py:143 permute_mont, jitted through "
                ":172 _hash_fields_impl and :197 _hash_words_impl")
    for kname, source, fname, headline, main in (
            ("poseidon", "poseidon.cu", "babybear", P1_WORD,
             next(r for r in pos if not r["checked"])),
            ("poseidon (8-limb)", "poseidon_limbs.cu", "bls12_381_scalar", P1_MAIN,
             dict(hashes[P1_MAIN]["leaf_layer"], t=9))):
        rows = [r for r in pos if (r["field"] in POSEIDON_WORD_FIELDS) == (fname == "babybear")]
        checked = next(r for r in rows if "plain_ms" in r)
        entries.append({
            "name": kname, "route": "cuda", "source": f"icicle_tpu_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches[headline]["poseidon"],
            "headline_path": headline, "launches_per_path": per_path("poseidon"),
            "max_abs_err": max(r["max_abs_diff"] for r in rows if r["checked"]),
            "ms": main["kernel_ms"], "plain_ms": checked["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,  # no PyTorch call computes a Poseidon permutation
            "shape": [main["batch"], 9, "tag"], "plain_shape": [checked["batch"], 9, "tag"],
            "checked_ms": checked["kernel_ms"], "shapes": rows, "card": smi})
    # blake2s, blake3: ms and bound_ms at P2's leaf layer (2^25 rows of 16
    # words); plain_ms at 64 bytes x BLAKE_CHECK_BATCH rows, where checked
    for kname, source, replaces in (
            ("blake2s", "blake2s.cu", "none (XLA): icicle_tpu/ops/hash/blake2s.py:47 _compress "
             "(Blake2s._run :82, hash_words :108, hash_bytes :94)"),
            ("blake3", "blake3.cu", "none (XLA): icicle_tpu/ops/hash/blake3.py:64 _compress_dyn "
             "(Blake3._run :132, hash_words :231, hash_bytes :214)")):
        main = hashes[P2_MAIN[kname]]["leaf_layer"]
        rows = hash_rows[kname]
        entry = {"name": kname, "route": "cuda", "source": f"icicle_tpu_torch/kernels/csrc/{source}",
                 "replaces": replaces, "launches": launches[P2_MAIN[kname]][kname],
                 "headline_path": P2_MAIN[kname], "launches_per_path": per_path(kname),
                 "max_abs_err": max(r["max_abs_diff"] for r in rows),
                 "ms": main["kernel_ms"], "plain_ms": rows[0]["plain_ms"],
                 "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                 "library_ms": None,  # no PyTorch call computes a BLAKE compression
                 "shape": [main["batch"], 16], "plain_shape": [BLAKE_CHECK_BATCH, 16],
                 "checked_ms": rows[0]["kernel_ms"], "sm_clock_mhz": sm_clock_mhz,
                 "sass": {k: v for k, v in hash_sass.items() if kname in k}, "shapes": rows,
                 "card": smi}
        if kname == "blake3":
            p3 = hashes[P3_MAIN]
            entry.update(p3_ms=p3["ms"], p3_chunk_pass_ms=p3["chunk_pass_ms"],
                         p3_bound_ms=p3["bound_ms"],
                         p3_chunk_pass_bound_ms=p3["chunk_pass_bound_ms"])
        entries.append(entry)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
