"""Smoke test of the PyTorch/CUDA port (icicle_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a Hopper card (sm_90a), the
CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line).
They run in another order than listed: the build runs in the background
from the start (one nvcc a library, as many at a time as cores but one,
EARLY_LIBRARIES first), beside the kernel checks and main paths that need
no elliptic-curve library
(dif_rows, dif_rows_wide, poseidon2, the protocol, hash and lattice
kernels; the NTT, Merkle, FRI, sumcheck, field-layer, hash, L1, Q1 and S6
paths), each loading its libraries as their compiles end; then the MSM,
G2 and ECNTT kernel checks and paths, S1-S5 and S7:
  1. card    -- nvidia-smi name and power limit, torch's device name;
  2. build   -- every kernel library from icicle_tpu_torch/kernels/csrc, one
               nvcc per source, in parallel, with the compiler's report
               (registers, stack, spills, each compile's seconds);
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
               (v1's 2^20 MSM is not profiled: over 200k launches);
  5b. MSM long tail -- M1: bls12_381 G1 at 2^24 (bench.py's kind of input:
               one repeated point P = k G, canonical scalars below r) through
               msm_affine, then timed over prepared bases and profiled, and
               bls12_377 at 2^16 distinct points; M2: bw6_761 at 2^20 (a
               depth cut for run time), 12-limb scalars below r; M3: the
               reference's headline, bls12_377, 1000 MSMs of 2^10 shared
               points at precompute_factor 23 (c 8), the bases from
               msm_precompute_bases on the card (one precompute_bases
               launch), each of the 1000 results against a Python-int
               oracle, ms an MSM, the idle share from a profile of 100 of
               them; M4: bn254 2^22 at precompute_factor 1, 2 and 4 (c 11,
               bases from msm_precompute_bases) and msm_tpu3(glv=True),
               each against the same oracle, times side by side; M5: bn254
               2^16 distinct points with Montgomery-form scalars,
               Montgomery-form points, bitsize 64, and an unshared batch of
               8 x 2^12 (each element on its own points). Each counted: B3
               and B4 at the curve's limb count, precompute_bases where
               used, nothing else. Then the slice of B5 over every G1 curve
               and B6 and B7 at 12 and 24 limbs: M1's and M2's inputs
               through v2 (B6 + B4) and r12 (B5 + B4), each timed (median
               of 3 after a warm-up) and profiled; v1 (msm_tpu, B7) over
               bls12_381 2^20 and bw6_761 2^16 (timed once where the
               checked call ran past SLOW_CALL_S); M1's bls12_377 2^16
               distinct points through v2, r12 and v1, grumpkin 2^16
               distinct points through r12; each counted against its plan
               (expected_launches over the curve) and held to the oracle.
               Their kernels are checked in phase 3 after B3/B4 at 12 and
               24 limbs (slice_rows: each instance at K 64 at its path's
               lanes, bit-exact with its plain version, then timed at full
               depth);
  5c. G2 and the extension fields -- B3, B4 and precompute_bases over
               Fp2 (8 and 12 limbs) and over Fq (bw6_761's G2) against
               their plain versions (the kernel phase, after B3/B4 at 12
               and 24 limbs), then E1: bn254 G2 2^22 through
               msm_affine(MSMConfig(g2=True)) (Groth16's B query); E2:
               bls12_381 G2 2^20; E3: bls12_377 and bw6_761 G2 at 2^16;
               E4: bn254 G2 msm_precompute_bases at nu 2 over 2^20 points,
               its MSM with explicit c, and a shared batch of 8 x 2^12;
               E5: bn254 G1 and G2 MSMs of the same 2^16 scalars over k_i
               G1 and k_i G2, then pairing(A1, G2) == pairing(G1, A2) and
               the same by ate_pairing on the host; E6: a babybear4
               ntt_ext at 2^24, forward and inverse, 8 dif_rows launches
               each way, equal to the component-wise torch NTT. Inputs
               are 64 points of known logs, tiled, and scalars below r, so
               each oracle is one host scalar multiply; each path counted
               (B3 and B4 at the group's instance), E1, E2, E4, E6 profiled;
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
  11. multi-device (S1-S5) -- a mesh of every visible card: one card is a
               world of one NCCL rank in this process (its launch counters
               are this process's), more cards a spawned rank a card (rank
               0's counts and results reported). S1: ntt_sharded over
               babybear 2^26, forward and inverse, normalize True and
               False, each equal bit for bit to the rank's block of the
               single-card ntt, two dif_rows launches a rank an NTT (8 for
               the four calls, nothing else), ms beside the single-card
               ntt; S2: msm_sharded3 at bn254 2^24 with bench.py's inputs,
               equal to (sum of scalars) P, launching the per-shard plan's
               B3 / B4 (expected_launches), ms beside msm_affine (u32) on
               the same inputs; S3: msm_sharded (v1) at 2^20, once, against
               its oracle, with its B7 launches, and over bls12_381 at
               2^16 (B7's 12-limb instance); S4: merkle_build_sharded
               over bench.py's 2^29 leaves, the root equal to phase 6's, 29
               poseidon2 launches, the proofs of leaves 0, 2^28 + 5 and
               2^29 - 1 verifying (on the rank that owns them; also in a
               tree that was never built) and failing flipped; S5: the
               three *_2level functions over a (1, d) mesh at S1's, S2's
               and S4's sizes, held to the same answers and counts;
  12. stream_map (S6) -- a babybear 2^22 forward NTT over 16 chunks from
               pinned host memory, equal to per-chunk ntt, 32 dif_rows; ms
               a run, and a torch.profiler breakdown: H2D, kernel and D2H
               time, their serial sum, the share of copy time that
               overlaps kernels and of H2D time that overlaps D2H;
  13. the C ABI (S7) -- icicle_tpu_torch/capi/c_api.cpp built with g++
               (include/icicle_tpu.h unchanged), loaded with ctypes into
               this process (the embedded runtime is this interpreter),
               icicle_tpu_init(NULL); then icicle_tpu_ntt (babybear 2^26),
               icicle_tpu_msm (bn254 2^22, bench.py's kind of inputs; cut
               from 2^24, whose C copies took this phase past 30 s),
               icicle_tpu_merkle_build (babybear 2^24 leaves), ML-KEM-768
               keygen / encaps / decaps (a batch of 2^12) and
               icicle_tpu_lattice_decompose (2^20 elements), each counted
               (2 dif_rows; the plan's B3 / B4; 24 poseidon2; mlkem and
               keccak_sponge as Q1's; none), bit-equal to the port's
               Python entry point on the card, its C call timed beside the
               entry point (the difference: byte marshalling); then the
               port's C example program (capi/example.c), a C program in a
               subprocess: init(NULL), an NTT round trip at 2^20 and the
               MSM 5G check;
  14. the main paths' JSON line (per-path launches, times, profiles,
     seconds a phase);
  15. the kernels JSON line; 16. the result JSON line, last.

Phase 3 also holds B3 and B4 at 12 limbs (bls12_381) and 24 (bw6_761)
bit-exact to their plain versions at the lane widths M1 and M2 give them,
the serial depth cut to 64 and 61, and as projective points to the serial
plain version, then times them at those paths' full shapes; and
precompute_bases (kernels/csrc/precompute_bases.cu) at 8, 12 and 24 limbs
(bn254, bls12_377, bw6_761) over 2^12 points, two of them the identity, at
nu 2, 4 and 23, bit-exact to its plain version and at one point a copy to
Python-int doublings, timed at M3's and M4's bases. Its bound: per point 2
Montgomery multiplies into the form, per further copy `shift` doublings of
8 (the one by b3 an add chain), a Fermat inversion (bits(p - 2) squarings
and popcount(p - 2) multiplies) and 4 more; n 2L words read and nu n 2L
written.

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

Phase 3 also holds the new kernels to their plain versions, bit-exact, at
the shapes the paths give them, and times each alone there: the ECNTT
kernel (kernels/csrc/ecntt.cu) at 8, 12 and 24 limbs on EC1's inputs
(bn254 2^16, bls12_381 2^13, bw6_761 2^8; x, y and z): stage 1 (no
ladder), the last stage with the GLV and the plain ladder, and the GLV
scale of n lanes by random scalars below r; rq_ntt (rq_ntt.cu) over L1's
2^16 R_q polynomials both ways with rows of 0 and q - 1; the three mlkem
ops (mlkem.cu) at ML-KEM-768 2^16 (196,608 and 589,824 polynomials) with
rows of 0 and 3328; keccak.cu's icicle_keccak_sponge for every sponge
ML-KEM calls at Q1's batch for it and a 31-block squeeze (row 0 also
against hashlib). An ECNTT ladder's bound counts the least multiplies its
digits need (ladder_monts); rq_ntt 256 64-bit Montgomery multiplies of 11
32-bit products a polynomial; the sponge its permutations on the ALU pipe.
After the hashes: EC1, the ECNTT through icicle_tpu_torch.ecntt (bn254
2^16 forward, a coset forward and its inverse, bls12_381 2^13 forward and
inverse, bw6_761 2^8 forward; sampled lanes against (NTT(a)_k) G, the
inverses against the inputs as affine points; a stage launch a stage, a
scale launch a coset shift or inverse; timed, one forward profiled); L1,
the rings and lattice ops (ntt_rns 2^24: 8 dif_rows; negacyclic_ntt over
2^16 polynomials: 2 rq_ntt; rq_matmul (64 x 256) by (256 x 64): 3 rq_ntt,
equal to the plain version; decomposition, a JL projection and norm
checks over 2^22 elements); Q1, batched ML-KEM (768 at 2^16, 512 and
1024 at 2^12: every secret decapsulated, tampered ciphertexts rejected,
64 items against the host oracle byte for byte; operations/s).

Launch counts: every kernel's count is set to 0 just before each checked
main-path call (one NTT forward + inverse, one MSM, one Merkle build, one
FRI prove, one claimed sum and sumcheck prove; one limb-field NTT forward +
inverse or coset forward, one goldilocks build, one polynomial product; one
oct-tree, Blake tree, long-message Blake3 hash or Blake3 FRI prove; one
sharded NTT's four calls, one sharded MSM or build, one stream_map run, one
C ABI call) and read just after it; timing and profiling calls are not counted. A profile
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

import concurrent.futures
import contextlib
import functools
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
INT_MULS_PER_S = 132 * 64 * 1.98e9
MULS_PER_MONT = 3
REPS = 10
PROFILE_PAD_S = 1.0  # idle seconds before and after a profiled call, doubled a retry
PROFILE_TRIES = 3
# the libraries of the phases that overlap the build, compiled first
EARLY_LIBRARIES = ("ntt", "ntt_wide", "poseidon2", "poseidon2_limbs", "poseidon2_gl64", "keccak",
                   "fri_fold", "sumcheck", "program", "poseidon", "poseidon_limbs", "blake2s",
                   "blake3", "rq_ntt", "mlkem")
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


def timed_ms(fn, reps: int = 1):
    """(median ms of fn() + synchronize() on the host clock, no warm-up: for
    a call made just before, the last call's result)."""
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def host_ms(fn, reps: int = 5):
    """(median ms of fn() + synchronize() on the host clock after a warm-up,
    the last call's result)."""
    fn()
    return timed_ms(fn, reps)


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


def coord_muls(g) -> tuple[int, int, int]:
    """Base-field products of one multiply, one squaring and one multiply
    by b3 in the coordinate field of group g (a Group, or a curve for its
    G1): over Fp 1, 1 and 1; over Fp2 (Karatsuba) 3, 2 (the complex
    squaring) and 3, or 2 where b3 has a zero part (bls12_377's (0, b)).
    A b3 that is a small integer, or k + k u with k small, is an add chain
    and costs none."""
    from icicle_tpu_torch.kernels.msm_lib import as_group, b3_small
    g = as_group(g)
    if g.degree == 1:
        return 1, 1, 0 if b3_small(g) is not None else 1
    b3 = 0 if b3_small(g) is not None else (2 if 0 in g.b3 else 3)
    return 3, 2, b3


def add_muls(g, monts: int) -> int:
    """Integer multiplies of one add of `monts` coordinate multiplies plus
    two by b3 (coord_muls' costs) in group g, or a curve's G1."""
    from icicle_tpu_torch.kernels.msm_lib import as_group
    g = as_group(g)
    mul, _, b3 = coord_muls(g)
    return (monts * mul + 2 * b3) * big_mont_muls(g.base_limbs)


def prefix_scan_bound(K: int, C: int, g) -> tuple[float, str]:
    from icicle_tpu_torch.kernels.msm_lib import as_group
    nl = as_group(g).nlimbs
    return bound(K * C * 5 * nl * 4, K * C * add_muls(g, MADD_MONTS))


def ec_reduce_bound(R: int, C: int, g) -> tuple[float, str]:
    from icicle_tpu_torch.kernels.msm_lib import as_group
    nl = as_group(g).nlimbs
    return bound((R + 1) * C * 3 * nl * 4, R * C * add_muls(g, PADD_MONTS))


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
    from icicle_tpu_torch.kernels import precompute_kernel as PB
    from icicle_tpu_torch.kernels import program_kernel as PGK
    from icicle_tpu_torch.kernels import sumcheck_kernel as SK
    from icicle_tpu_torch.kernels import ecntt_kernel as EK
    from icicle_tpu_torch.kernels import mlkem_kernel as MK
    from icicle_tpu_torch.kernels import rq_ntt_kernel as RK
    return {"dif_rows": K.dif_rows, "dif_rows_wide": NW.dif_rows_wide,
            "prefix_scan": TS.prefix_scan, "ec_reduce": TR.ec_reduce,
            "precompute_bases": PB.precompute_bases,
            "prefix_scan_r12": TS12.prefix_scan_r12, "suffix_fold": TF.suffix_fold,
            "bucket_accum": TK.bucket_accum, "poseidon2": PK.poseidon2, "keccak": KK.keccak,
            "fri_fold": FK.fri_fold, "sumcheck_round": SK.sumcheck_round,
            "program": PGK.execute_program_kernel, "poseidon": PSK.poseidon,
            "blake2s": B2.blake2s, "blake3": B3.blake3, "ecntt_stage": EK.ecntt_stage,
            "ecntt_scale": EK.ecntt_scale, "rq_ntt": RK.rq_ntt, "mlkem_ntt": MK.mlkem_ntt,
            "mlkem_intt": MK.mlkem_intt, "mlkem_multiply_ntts": MK.mlkem_multiply_ntts,
            "keccak_sponge": KK.keccak_sponge}


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
V1_LOG = 20
V1_MAIN = f"msm v1 bn254 2^{V1_LOG} (repeated point)"
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


def same_points(g, a: torch.Tensor, b: torch.Tensor) -> bool:
    """a, b (..., 3W, C) projective points of group g on the card, Montgomery
    in any domain, values below 4p: equal as projective points (X1 Z2 = X2
    Z1, Y1 Z2 = Y2 Z1, X1 Y2 = X2 Y1 by the group's field, whose multiply
    gives canonical products of such values) and neither (0, 0, 0). A (K,
    3W, C) pair is compared SAME_POINTS_ROWS rows at a time."""
    from icicle_tpu_torch.kernels.msm_lib import split_point
    if a.dim() == 3 and a.shape[0] > SAME_POINTS_ROWS:
        return all(same_points(g, a[i:i + SAME_POINTS_ROWS], b[i:i + SAME_POINTS_ROWS])
                   for i in range(0, a.shape[0], SAME_POINTS_ROWS))
    m = g.f.mul_mont
    (x1, y1, z1), (x2, y2, z2) = (split_point(t.transpose(-1, -2), g.nlimbs) for t in (a, b))
    zero = any(bool(((x == 0) & (y == 0) & (z == 0)).all(-1).any())
               for x, y, z in ((x1, y1, z1), (x2, y2, z2)))
    return (not zero and torch.equal(m(x1, z2), m(x2, z1)) and torch.equal(m(y1, z2), m(y2, z1))
            and torch.equal(m(x1, y2), m(x2, y1)))


def group_generator(g):
    """The generator of group g as affine Python ints."""
    p = g.curve.params
    if not g.g2:
        return g.curve.gen_x, g.curve.gen_y
    return (p.g2_gen_x, p.g2_gen_y) if g.degree == 2 else (p.g2_gen_x[0], p.g2_gen_y[0])


def pool_logs(count: int = 64) -> list:
    return [0x5EED + 977 * i for i in range(count)]


def pool_points(g, count: int = 64) -> list:
    """k_i G for the k_i of pool_logs, G the generator of group g (or of a
    curve's G1), as affine Python ints, by adds (a 761-bit scalar multiply
    takes 0.1 s on the host)."""
    from icicle_tpu_torch.curves.host_ec import host_ops, scalar_mul
    from icicle_tpu_torch.kernels.msm_lib import as_group
    g = as_group(g)
    add = host_ops(g)[0]
    G = group_generator(g)
    cur, step = scalar_mul(g, G, pool_logs(1)[0]), scalar_mul(g, G, 977)
    pool = []
    for _ in range(count):
        pool.append(cur)
        cur = add(cur, step)
    return pool


def check_msm_kernels(dev, gen, smi: str, g, checks: list, full: list) -> dict:
    """The MSM kernels of `checks` and `full` (rows as MSM_CHECKS and
    MSM_FULL) over group g (G1, or G2 for B3 and B4): against their plain
    versions on the card at the MSM routes' lane widths (serial depth cut
    for the plain side), then timed alone at full depth. B3-B6 take curve points (`pool_points`
    and their negatives; B4's projective, sums of two, with one
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
    from icicle_tpu_torch.curves.group import Affine, Projective
    from icicle_tpu_torch.kernels import ec_reduce as TR
    from icicle_tpu_torch.kernels import msm_fold2 as TF
    from icicle_tpu_torch.kernels import msm_kernel as TK
    from icicle_tpu_torch.kernels import msm_scan as TS
    from icicle_tpu_torch.kernels import msm_scan_r12 as TS12

    curve = g.curve
    cname = curve.name
    fq, f = curve.fq, g.coord_field
    nl = g.nlimbs
    W1 = 12   # windows per B7 launch at the bn254 v1 2^20 shape (option "windows")

    pool = pool_points(g)
    pool_x = f.to_mont(f.from_ints([p[0] for p in pool] * 2, dev))
    pool_y = f.to_mont(f.from_ints([p[1] for p in pool], dev))
    pool_y = torch.cat([pool_y, f.neg(pool_y)])                   # P and -P
    r12 = {}
    pair = torch.randint(0, 128, (2, 128), generator=gen, device=dev)
    one = g.one_mont(dev).expand(128, nl)
    pool_proj = torch.cat(list(g.madd(Projective(pool_x[pair[0]], pool_y[pair[0]], one),
                                      Affine(pool_x[pair[1]], pool_y[pair[1]]))), -1)

    def lane_major(t: torch.Tensor) -> torch.Tensor:
        """(D, C, rows) -> (D, rows, C) contiguous."""
        return t.transpose(1, 2).contiguous()

    def curve_affine(depth: int, lanes: int, xs=pool_x, ys=pool_y) -> torch.Tensor:
        """(depth, 2W, lanes) Montgomery x || y of pool points."""
        i = torch.randint(0, 128, (depth, lanes), generator=gen, device=dev)
        return lane_major(torch.cat([xs[i], ys[i]], -1))

    def curve_proj(depth: int, lanes: int) -> torch.Tensor:
        """(depth, 3W, lanes) projective pool points, Z != 1, row 2 the
        identity where depth > 2."""
        pts = pool_proj[torch.randint(0, 128, (depth, lanes), generator=gen, device=dev)]
        if depth > 2:
            pts[2] = torch.cat(list(g.identity((lanes,), dev)), -1)
        return lane_major(pts)

    def r12_affine(depth: int, lanes: int) -> torch.Tensor:
        """curve_affine over the same points in B5's R' = 2^(12 nw) domain,
        canonical."""
        if not r12:
            rp = TS12.r12_engine(cname).R % fq.modulus
            y = fq.from_ints([p[1] * rp % fq.modulus for p in pool], dev)
            r12.update(x=fq.from_ints([p[0] * rp % fq.modulus for p in pool] * 2, dev),
                       y=torch.cat([y, fq.neg(y)]))
        return curve_affine(depth, lanes, r12["x"], r12["y"])

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

    def sorted_keys(depth: int, lanes: int, windows: int, v1: int) -> torch.Tensor:
        """(windows, depth, lanes) keys: at a cut depth (v1 0) random in [0,
        24), sorted along each lane, window 0's lane 0 one run over every
        slot and its lane 1 a new key at every slot; else as v1 lays them out
        with M = v1 (the window's depth * lanes keys in [0, M] sorted, lane c
        holding positions c depth .. (c + 1) depth - 1)."""
        if v1:
            k = torch.randint(0, v1 + 1, (windows, depth * lanes), generator=gen, device=dev)
            k = k.sort(dim=1).values.view(windows, lanes, depth).transpose(1, 2)
            return k.to(torch.int32).contiguous()
        k = torch.randint(0, 24, (windows, depth, lanes), generator=gen, device=dev)
        k = k.sort(dim=1).values.to(torch.int32)
        k[0, :, 0] = 7
        k[0, :, 1] = torch.arange(depth, device=dev, dtype=torch.int32)
        return k.contiguous()

    def accum_inputs(depth: int, lanes: int, windows: int = W1, v1=None):
        """B7's keys and (windows, depth, 2L, lanes) curve points; v1's key
        layout (M 2048) at full depth (1024) unless `v1` gives M, or 0."""
        keys = sorted_keys(depth, lanes, windows, (2048 if depth == 1024 else 0) if v1 is None
                           else v1)
        return keys, torch.stack([curve_affine(depth, lanes) for _ in range(windows)])

    def contract(out: torch.Tensor, args) -> torch.Tensor:
        """B7's output at the rows it promises, as (3L, rows)."""
        return out.transpose(2, 3)[TK.contract_rows(args[0])].T.contiguous()

    # name -> (kernel, plain version, inputs(depth, lanes, **options),
    # bound(depth, lanes, inputs), segment plan(depth, lanes, inputs)[, the
    # compared part of an output: view(out, inputs)])
    kernels = {
        "prefix_scan": (TS.prefix_scan, TS.prefix_scan_ref,
                        lambda d, c: (curve_affine(d, c),),
                        lambda d, c, a: prefix_scan_bound(d, c, g),
                        lambda d, c, a: TS.scan_segments(d, c)),
        "ec_reduce": (TR.ec_reduce, TR.ec_reduce_ref,
                      lambda d, c: (curve_proj(d, c),),
                      lambda d, c, a: ec_reduce_bound(d, c, g),
                      lambda d, c, a: TR.reduce_segments(d, c)),
        "prefix_scan_r12": (TS12.prefix_scan_r12, TS12.prefix_scan_r12_ref,
                            lambda d, c: (r12_affine(d, c),),
                            lambda d, c, a: prefix_scan_bound(d, c, curve),
                            lambda d, c, a: TS12.r12_segments(d, c)),
        "suffix_fold": (TF.suffix_fold, TF.suffix_fold_ref, fold_inputs,
                        lambda d, c, a: suffix_fold_bound(a[1], curve),
                        lambda d, c, a: TF.fold_segments(d, c)),
        "bucket_accum": (TK.bucket_accum, TK.bucket_accum_ref, accum_inputs,
                         lambda d, c, a: bucket_accum_bound(a[0], curve),
                         lambda d, c, a: TK.accum_segments(d, a[0].shape[0] * c), contract),
    }
    label = f"{cname} G2" if g.g2 else cname
    input_opts = ("stream", "M", "windows", "v1")
    rows = {name: [] for name, *_ in (*checks, *full)}
    for name, depth, lanes, role, opts in checks:
        fn, ref, make, bnd, plan, *part = kernels[name]
        on = g if name in ("prefix_scan", "ec_reduce") else curve   # B5-B7 take a curve
        view = part[0] if part else (lambda out, args: out)
        args = make(depth, lanes, **{k: v for k, v in opts.items() if k in input_opts})
        kw = {k: v for k, v in opts.items() if k not in input_opts}
        got = view(fn(on, *args, **kw), args)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = ref(on, *args, **kw)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        want = view(want, args)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"{name} != its plain version at {role}, {label}: "
                                 f"max abs err {err}")
        row = {"role": role, "curve": cname, "g2": g.g2, "depth": depth, "lanes": lanes,
               "options": opts, "checked": True, "max_abs_diff": err}
        extra = ""
        if plan is not None:
            row["segments"] = plan(depth, lanes, args)
            extra = f", S {row['segments']}"
            if depth <= SERIAL_DEPTH:
                # the kernel's association against the serial fold, as points
                if not same_points(g, got, view(ref(on, *args, segments=1, **kw), args)):
                    raise AssertionError(f"{name} != its serial plain version (segments=1) "
                                         f"as projective points at {role}")
                row["serial_equal_as_points"] = True
                extra += ", == serial as points"
        kernel_ms = cuda_ms(lambda: fn(on, *args, **kw))
        bound_ms, bound_by = bnd(depth, lanes, args)
        row.update(kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        rows[name].append(row)
        log(f"  {name:15s} {tuple(args[0].shape)} {label} exact{extra}; kernel {kernel_ms:.4f} ms, "
            f"plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by})  [{role}]")
        del args, got, want
    for name, depth, lanes, role, opts in full:
        fn, _, make, bnd, plan, *part = kernels[name]
        on = g if name in ("prefix_scan", "ec_reduce") else curve
        view = part[0] if part else (lambda out, args: out)
        args = make(depth, lanes, **{k: v for k, v in opts.items() if k in input_opts})
        kw = {k: v for k, v in opts.items() if k not in input_opts + ("serial",)}
        kernel_ms = cuda_ms(lambda: fn(on, *args, **kw), reps=3)
        bound_ms, bound_by = bnd(depth, lanes, args)
        row = {"role": role, "curve": cname, "g2": g.g2, "depth": depth, "lanes": lanes,
               "options": opts, "checked": False, "kernel_ms": kernel_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        extra = ""
        if plan is not None:
            row["segments"] = kw.get("_segments", plan(depth, lanes, args))
            extra = f", S {row['segments']}"
        if opts.get("serial"):
            # the plan's split against the serial kernel (the JAX order), as points
            if not same_points(g, view(fn(on, *args, **kw), args),
                               view(fn(on, *args, **dict(kw, _segments=1)), args)):
                raise AssertionError(f"{name} at its plan != itself at _segments=1 as "
                                     f"projective points at {role}")
            row["serial_equal_as_points"] = True
            extra += ", == _segments=1 as points"
        if name == "prefix_scan_r12":
            # its own arithmetic: radix-12 multiplies at the integer rate
            row["r12_muls"] = depth * lanes * r12_madd_muls(TS12.r12_engine(cname).nw)
            row["r12_muls_ms"] = row["r12_muls"] / INT_MULS_PER_S * 1e3
            extra += f", its radix-12 multiplies alone {row['r12_muls_ms']:.3f} ms"
        if name == "suffix_fold":
            row["bound_all_slots_ms"] = suffix_fold_bound_all_slots(depth, lanes, curve)[0]
            extra += (f"; both adds on every slot (the Pallas body) "
                      f"{row['bound_all_slots_ms']:.3f} ms")
        rows[name].append(row)
        log(f"  {name:15s} {tuple(args[0].shape)} {label} kernel {kernel_ms:.3f} ms, bound "
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


def expected_launches(route: str, n: int, curve: str = "bn254") -> dict:
    """Each kernel's launches in one MSM of `route` at n points over
    `curve`'s G1, from the ported plan functions."""
    from icicle_tpu_torch import get_curve
    from icicle_tpu_torch.ops import msm_tpu as V1
    from icicle_tpu_torch.ops import msm_tpu2 as V2
    from icicle_tpu_torch.ops import msm_tpu3 as V3

    counts = dict.fromkeys(kernel_counters(), 0)
    nbits = get_curve(curve).fr.modulus.bit_length()
    if route in ("u32", "r12"):
        plan = V3._resolve_plan(curve, n, None, None, None, route, 1)
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
        per_chunk = V1._auto_wchunk(n, n_windows, get_curve(curve).fq.nlimbs) or n_windows
        counts["bucket_accum"] = -(-n_windows // per_chunk)
    return counts


def msm_main_paths(dev, smi: str, launches: dict) -> dict:
    """The MSM routes on CUDA tensors; records each checked MSM's kernel
    launches in `launches` and returns the measurements."""
    from icicle_tpu_torch import get_curve
    from icicle_tpu_torch.curves.host_ec import ec_add, ec_mul
    from icicle_tpu_torch.ops.msm_tpu import msm_tpu
    from icicle_tpu_torch.ops.msm_tpu2 import msm_tpu2
    from icicle_tpu_torch.ops.msm_tpu3 import msm_tpu3, msm_tpu3_prepare

    curve = get_curve("bn254")
    fr, fq = curve.fr, curve.fq
    mod = fq.modulus
    gen_pt = (curve.gen_x, curve.gen_y)

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
        got = counted(label, lambda: route_entry(route, "bn254")(s_dev, px, py), launches)
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

    def profile(label: str, call, want) -> dict:
        got, prof = device_profile(label, call, smi)
        if got != want:
            raise AssertionError(f"profiled {label}: {got} != oracle {want}")
        return prof

    out = {}
    # 2^24 with bench.py's inputs: v3 "u32", v3 "r12", v2
    n = 1 << 24
    scal, px, py, want24 = bench_msm_inputs(n, 0, dev)
    profiles = {}
    for route, label in (("u32", MSM_24), ("r12", R12_24), ("v2", V2_24)):
        s24, out[label] = run_checked(route, label, n, scal, px, py, want24)
        profiles[label] = profile(label, timed_call(route, s24, px, py), want24)
        del s24
        torch.cuda.empty_cache()
    del px, py

    # v1 at 2^20 with the same kind of inputs
    n = 1 << V1_LOG
    scal, px, py, want20 = bench_msm_inputs(n, 2, dev)
    s20, out[V1_MAIN] = run_checked("v1", V1_MAIN, n, scal, px, py, want20)
    # not profiled: its 216,605 launches took the profile 34-51 s on the H100
    # (idle share 0.83: host-bound in the torch bucket phase)
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


# -- the MSM's long tail: B3/B4 at 12 and 24 limbs, precompute_bases, M1-M5 ------

DBL_MONTS = 8     # RCB15 Alg 9, not counting its multiply by b3
JAC_DBL_MONTS = 7  # Jacobian doubling at a = 0 (dbl-2009-l: 2M + 5S)
M1_LOG = 24
M2_LOG = 20       # a depth cut for run time: bw6_761's users run 2^20 and more
LIMB_CURVES = ((12, "bls12_381", M1_LOG), (24, "bw6_761", M2_LOG))  # (L, curve, M1 / M2 log n)
PRE_CURVES = ((8, "bn254"), (12, "bls12_377"), (24, "bw6_761"))
PRE_CHECK_N = 1 << 12
PRE_CHECK_NU = (2, 4, 23)
PRE_CHECK_C = 8
M1_MAIN = f"msm bls12_381 2^{M1_LOG} (repeated point)"
M1_377_LOG = 16
M1_377 = f"msm bls12_377 2^{M1_377_LOG} (distinct points)"
M2_MAIN = f"msm bw6_761 2^{M2_LOG} (repeated point)"
SLOW_CALL_S = 5.0   # a v1 slice path whose checked call took longer is timed once
R12_REPLACES = "icicle_tpu/pallas/msm_scan_r12.py:135 (make_prefix_scan_r12)"
FOLD_REPLACES = "icicle_tpu/pallas/msm_fold2.py:75 (make_suffix_fold)"
ACCUM_REPLACES = "icicle_tpu/pallas/msm_kernel.py:125 (make_bucket_accum)"
M3_BATCH, M3_LOG, M3_NU, M3_C = 1000, 10, 23, 8
M3_PROFILED = 100
M3_BASES = f"msm_precompute_bases bls12_377 2^{M3_LOG} x {M3_NU} (c {M3_C})"
M3_MAIN = (f"msm bls12_377 {M3_BATCH} x 2^{M3_LOG} shared, precompute_factor {M3_NU} "
           f"(c {M3_C})")
M4_LOG, M4_C = 22, 11
M4_NU = (1, 2, 4)
M4_MAIN = {nu: f"msm bn254 2^{M4_LOG} precompute_factor {nu} (c {M4_C})" for nu in M4_NU}
M4_BASES = {nu: f"msm_precompute_bases bn254 2^{M4_LOG} x {nu} (c {M4_C})" for nu in M4_NU[1:]}
M4_GLV = f"msm bn254 2^{M4_LOG} glv (c {M4_C})"
M5_LOG = 16
M5_BATCH, M5_BATCH_LOG = 8, 12      # the unshared batch: 8 x 2^12 of M5's points
M5_MAIN = {k: f"msm bn254 2^{M5_LOG} (distinct points) {k}"
           for k in ("montgomery scalars", "montgomery points", "bitsize 64")}
M5_MAIN["unshared batch"] = (f"msm bn254 {M5_BATCH} x 2^{M5_BATCH_LOG} unshared "
                             "(distinct points)")


def precompute_bound(g, n: int, nu: int, shift: int,
                     fermat_per_copy: bool = False) -> tuple[float, str]:
    """precompute_bases' least work over group g (or a curve's G1), in
    base-field products (coord_muls: an Fp2 multiply 3, a squaring 2):
    per point 2 D multiplies into the form (D the coordinate field's
    degree); per copy after the first, `shift` Jacobian doublings at a = 0
    (dbl-2009-l: 2M + 5S, no multiply by b: 7 over Fp, 16 over Fp2), the
    batch inversion's share (3 over Fp; over Fp2 inverted through the norm
    in Fp: 2 squarings for the norm, 3, and 2 for the conjugate) and 4 to
    affine (Z^-2 a squaring, Z^-3, x Z^-2, y Z^-3: 4 over Fp, 11 over
    Fp2); one Fermat inversion in Fp (bits(p - 2) squarings, popcount(p -
    2) multiplies) for the whole batch. Bytes: n 2W words read, nu n 2W
    written (W a coordinate's words). fermat_per_copy: the kernel's own
    algorithm instead (RCB15 doublings, DBL_MONTS multiplies and one by b3,
    and a Fermat inversion, through the norm over Fp2, and 4 multiplies a
    copy)."""
    from icicle_tpu_torch.kernels.msm_lib import as_group
    g = as_group(g)
    d = g.degree
    mul, sqr, b3 = coord_muls(g)
    e = g.curve.fq.modulus - 2
    inversion = e.bit_length() + bin(e).count("1")
    if fermat_per_copy:
        dbl = DBL_MONTS * mul + b3
        inv = inversion + (4 if d == 2 else 0)
        muls = n * (2 * d + (nu - 1) * (shift * dbl + inv + 4 * mul))
    else:
        dbl = 2 * mul + 5 * sqr
        batch_inv = 3 if d == 1 else 2 + 3 + 2
        muls = n * (2 * d + (nu - 1) * (shift * dbl + batch_inv + sqr + 3 * mul)) + inversion
    return bound(n * (1 + nu) * 2 * g.nlimbs * 4, muls * big_mont_muls(g.base_limbs))


def v3_plan(curve_name: str, n: int, c=None, T=None, nu: int = 1, glv: bool = False,
            bitsize: int = 0) -> dict:
    from icicle_tpu_torch.ops import msm_tpu3 as V3
    return V3._resolve_plan(curve_name, n, c, T, None, "u32", nu, glv, bitsize)


def v3_launches(plan: dict, times: int = 1) -> dict:
    """B3's and B4's launches in `times` MSMs of v3's stages over `plan`."""
    groups = -(-plan["n_windows"] // plan["wg"])
    return {"prefix_scan": times * groups,
            "ec_reduce": times * (groups + (2 if plan["M"] > 128 else 1))}


def canonical_scalars(rng, shape: tuple, fr) -> np.ndarray:
    """(*shape, Ls) uint32 limbs of random scalars below r: random words,
    the top one below r's top word."""
    nl = fr.nlimbs
    s = rng.integers(0, 2**32, size=shape + (nl,), dtype=np.uint32)
    s[..., -1] = rng.integers(0, fr.modulus >> (32 * (nl - 1)), size=shape, dtype=np.uint32)
    return s


def weighted_total(scal: np.ndarray, mod: int, weights=None):
    """sum_i w_i s_i mod `mod` over the rows s_i of (..., n, Ls) uint32
    limbs (w = 1 by default; w < 2^20, n < 2^28), one int per leading
    index; 16-bit halves keep the uint64 sums exact."""
    n = scal.shape[-2]
    halves = np.stack([scal & 0xFFFF, scal >> 16], -1).reshape(scal.shape[:-1] + (-1,))
    w = np.ones(n, np.uint64) if weights is None else np.asarray(weights, np.uint64)
    sums = np.einsum("i,...ih->...h", w, halves.astype(np.uint64))
    flat = sums.reshape(-1, sums.shape[-1])
    totals = [sum(int(v) << (16 * h) for h, v in enumerate(row)) % mod for row in flat]
    return totals if scal.ndim > 2 else totals[0]


def fixed_base_mul(table: list, k: int, mod: int):
    """k P from table[j] = 2^j P by affine adds (no doublings)."""
    from icicle_tpu_torch.curves.host_ec import INF, ec_add
    acc = INF
    j = 0
    while k:
        if k & 1:
            acc = ec_add(acc, table[j], mod)
        k >>= 1
        j += 1
    return acc if acc is not INF else (0, 0)


# The slice of B5 over every G1 curve and B6 and B7 at 12 and 24 limbs: each
# curve's paths (log n) by route; bls12_381 at M1's n and bw6_761 at M2's
R12_LOGS = {"bls12_381": M1_LOG, "bw6_761": M2_LOG, "bls12_377": 16, "grumpkin": 16}
V2_LOGS = {"bls12_381": M1_LOG, "bw6_761": M2_LOG, "bls12_377": 16}
V1_LOGS = {"bls12_381": 20, "bw6_761": 16, "bls12_377": 16}
SLICE_CURVES = ("bls12_381", "bw6_761", "bls12_377", "grumpkin")
SLICE_CHECKED = {"bls12_381": ("prefix_scan_r12", "suffix_fold", "bucket_accum"),
                 "bw6_761": ("prefix_scan_r12", "suffix_fold", "bucket_accum"),
                 "bls12_377": ("prefix_scan_r12",), "grumpkin": ("prefix_scan_r12",)}


def slice_label(route: str, cname: str, logn: int) -> str:
    """A slice path's label: bls12_381 and bw6_761 take one repeated point
    (M1's and M2's kind of input), bls12_377 and grumpkin distinct points."""
    kind = "distinct points" if cname in ("bls12_377", "grumpkin") else "repeated point"
    return f"msm {route} {cname} 2^{logn} ({kind})"


def slice_rows(cname: str) -> tuple[list, list]:
    """check_msm_kernels' rows for the curve's instances of B5, B6 and B7
    (SLICE_CHECKED) at the lane widths its paths' plans give them: checked
    at K 64 (the plain side's cut depth; B6 on v2's stream with 16 keys and
    also on random flags), then timed at the paths' full depth."""
    from icicle_tpu_torch import get_curve
    from icicle_tpu_torch.kernels import msm_scan_r12 as TS12
    from icicle_tpu_torch.ops import msm_tpu as V1
    from icicle_tpu_torch.ops import msm_tpu2 as V2
    from icicle_tpu_torch.ops import msm_tpu3 as V3

    curve = get_curve(cname)
    nl, nbits = curve.fq.nlimbs, curve.fr.modulus.bit_length()
    kind = f"{nl}-limb {cname}"
    checks, full = [], []
    logn = R12_LOGS[cname]
    p = V3._resolve_plan(cname, 1 << logn, None, None, None, "r12", 1)
    K, C, groups = p["T"], p["wg"] * p["tiles"], -(-p["n_windows"] // p["wg"])
    kind5 = f"{kind} (nw {TS12.r12_engine(cname).nw})"
    checks.append(("prefix_scan_r12", 64, C, f"B5 {kind5}, one r12 2^{logn} window group, "
                                              f"K cut from {K}", {}))
    full.append(("prefix_scan_r12", K, C, f"B5 {kind5} at full depth ({groups} per r12 "
                                          f"2^{logn} MSM)", {}))
    if "suffix_fold" in SLICE_CHECKED[cname]:
        logn = V2_LOGS[cname]
        _, M, T, tiles, W, wg = V2._plan2(1 << logn, None, nbits, None)
        K, C = T + M, wg * tiles
        checks += [("suffix_fold", 64, C, f"B6 {kind}, one v2 2^{logn} window group, K cut from "
                                          f"{K}, v2's stream, M 16", dict(V2_CUT, runs=16)),
                   ("suffix_fold", 64, C, f"B6 {kind}, K 64, random flags", {"stream": "random"})]
        full.append(("suffix_fold", K, C, f"B6 {kind} at full depth ({-(-W // wg)} per v2 "
                                          f"2^{logn} MSM)", {"stream": "v2", "M": M, "runs": M}))
    if "bucket_accum" in SLICE_CHECKED[cname]:
        logn = V1_LOGS[cname]
        c, W, K, C = V1._plan(1 << logn, None, nbits, 1024)
        chunk = V1._auto_wchunk(1 << logn, W, nl) or W
        checks.append(("bucket_accum", 64, C, f"B7 {kind}, one v1 2^{logn} chunk of {chunk} "
                                              f"windows, K cut from {K}",
                       {"windows": chunk, "v1": 0}))
        full.append(("bucket_accum", K, C, f"B7 {kind} at full depth ({-(-W // chunk)} per v1 "
                                           f"2^{logn} MSM)", {"windows": chunk, "v1": 1 << (c - 1)}))
    return checks, full


def route_entry(route: str, cname: str):
    """The route's entry point a user calls over `cname`: (s, px, py) ->
    affine; u32, r12 and v2 through msm_affine under their environment
    variable, v1 through msm_tpu."""
    from icicle_tpu_torch import msm_affine
    from icicle_tpu_torch.ops.msm_tpu import msm_tpu
    if route == "v1":
        return lambda s, x, y: msm_tpu(cname, s, x, y)
    name, value = {"u32": ("ICICLE_TPU_MSM_ENGINE", "u32"),
                   "r12": ("ICICLE_TPU_MSM_ENGINE", "r12"),
                   "v2": ("ICICLE_TPU_MSM_PIPELINE", "v2")}[route]

    def run(s, x, y):
        with env(name, value):
            return msm_affine(cname, s, x, y)
    return run


def plan_checks(g, plan: dict, path: str) -> tuple[list, list]:
    """check_msm_kernels' rows for B3 and B4 over group g at the lane
    widths `plan` gives them on `path` (v3's plan for M1 and M2, the
    generic msm()'s for E1-E3) with the serial depth cut to 64 and 61, then
    the path's full shapes, timed."""
    nl = g.base_limbs
    kind = f"{nl}-limb" + (f" G2, degree {g.degree}" if g.g2 else "")
    K, C = plan["T"], plan["wg"] * plan["tiles"]
    R, CR = plan["tiles"], plan["wg"] * plan["M"]
    w_pad = -(-plan["n_windows"] // plan["wg"]) * plan["wg"]
    groups = -(-plan["n_windows"] // plan["wg"])
    checks = [("prefix_scan", 64, C, f"B3 {kind}, one {path} window group, K cut from {K}"),
              ("prefix_scan", 61, C, f"B3 {kind}, K 61: ragged last segment"),
              ("ec_reduce", 64, CR, f"B4 {kind}, {path} cross-tile fold, R cut from {R}"),
              ("ec_reduce", 61, CR, f"B4 {kind}, R 61: ragged and empty segments")]
    full = [("prefix_scan", K, C, f"B3 {kind} at full depth ({groups} per {path} MSM)"),
            ("ec_reduce", R, CR, f"B4 {kind} cross-tile at full depth ({groups} per "
                                 f"{path} MSM)"),
            ("ec_reduce", plan["M"] // 128, w_pad * 128, f"B4 {kind}, {path} bucket pass 1"),
            ("ec_reduce", 128, w_pad, f"B4 {kind}, {path} bucket pass 2")]
    return [r + ({},) for r in checks], [r + ({},) for r in full]


def check_precompute_bases(dev, gen, smi: str, groups, chains, timed) -> list:
    """precompute_bases over each group of `groups` at 2^12 points (two of
    them the identity, (0, 0)), at each (nu, shift) of chains(group),
    bit-exact with its plain version and, at one point a copy, with
    Python-int doublings; then timed alone at each (group, n, nu, shift,
    role) of `timed`, the main paths' shapes."""
    from icicle_tpu_torch.curves.host_ec import host_ops
    from icicle_tpu_torch.kernels import precompute_kernel as PB

    def label(g):
        return f"{g.curve.name}{' G2' if g.g2 else ''} ({g.base_limbs}-limb, degree {g.degree})"

    pre = []
    for g in groups:
        f = g.coord_field
        cname = g.curve.name
        pool = pool_points(g)
        idx = torch.randint(0, len(pool), (PRE_CHECK_N,), generator=gen, device=dev)
        px = f.from_ints([p[0] for p in pool], dev)[idx]
        py = f.from_ints([p[1] for p in pool], dev)[idx]
        px[:2] = 0
        py[:2] = 0                                               # the identity, (0, 0)
        _, dbl, _, ident = host_ops(g)
        read = (lambda v: tuple(int(c) for c in v)) if g.degree == 2 else int
        P = pool[int(idx[2])]
        for nu, shift in chains(g):
            got = PB.precompute_bases(g, px, py, nu, shift)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            want = PB.precompute_bases_ref(g, px, py, nu, shift)
            end.record()
            end.synchronize()
            plain_ms = start.elapsed_time(end)
            err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                      for a, b in zip(got, want))
            if err != 0 or not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"precompute_bases != its plain version, {label(g)} nu "
                                     f"{nu}: max abs err {err}")
            ox, oy = (f.to_ints(t[:3 * nu]) for t in got)
            Q = P
            for j in range(nu):
                for _ in range(shift if j else 0):
                    Q = dbl(Q)                                   # 2^(j shift) P
                if (read(ox[2 * nu + j]), read(oy[2 * nu + j])) != Q:   # copy j of point 2
                    raise AssertionError(f"precompute_bases {label(g)} nu {nu}: copy {j} != "
                                         f"2^{j * shift} P by Python ints")
                if any((read(ox[r]), read(oy[r])) != ident for r in (j, nu + j)):
                    raise AssertionError(f"precompute_bases {label(g)} nu {nu}: the "
                                         f"identity's copy {j} is not (0, 0)")
            kernel_ms = cuda_ms(lambda: PB.precompute_bases(g, px, py, nu, shift))
            bound_ms, bound_by = precompute_bound(g, PRE_CHECK_N, nu, shift)
            pre.append({"role": f"{label(g)}, 2^12 points, nu {nu}", "curve": cname,
                        "g2": g.g2, "n": PRE_CHECK_N, "nu": nu, "shift": shift,
                        "checked": True, "max_abs_diff": err, "kernel_ms": kernel_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "bound_fermat_per_copy_ms":
                            precompute_bound(g, PRE_CHECK_N, nu, shift, True)[0]})
            log(f"  precompute_bases {label(g)} ({PRE_CHECK_N}, {g.nlimbs}) nu {nu} shift "
                f"{shift} exact, == Python ints at one point; kernel {kernel_ms:.4f} ms, plain "
                f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        del px, py
    for g, n, nu, shift, role in timed:
        f = g.coord_field
        pts = pool_points(g, 16)
        idx = torch.randint(0, 16, (n,), generator=gen, device=dev)
        px = f.from_ints([p[0] for p in pts], dev)[idx]
        py = f.from_ints([p[1] for p in pts], dev)[idx]
        kernel_ms = cuda_ms(lambda: PB.precompute_bases(g, px, py, nu, shift), reps=3)
        bound_ms, bound_by = precompute_bound(g, n, nu, shift)
        fermat_ms = precompute_bound(g, n, nu, shift, True)[0]
        pre.append({"role": role, "curve": g.curve.name, "g2": g.g2, "n": n, "nu": nu,
                    "shift": shift, "checked": False, "kernel_ms": kernel_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_fermat_per_copy_ms": fermat_ms})
        log(f"  precompute_bases {label(g)} ({n}, {g.nlimbs}) nu {nu} shift {shift} kernel "
            f"{kernel_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
            f"{kernel_ms / bound_ms:.1f}x (its own algorithm's multiplies {fermat_ms:.3f} ms)"
            f"  [{role}] [{smi}]")
        del px, py
    torch.cuda.empty_cache()
    return pre


def msm_long_tail_paths(dev, smi: str, launches: dict) -> dict:
    """M1-M5 on CUDA tensors through the entry points a user calls, each
    counted (B3 and B4 at the curve's limb count, precompute_bases where
    used, nothing else), equal to a Python-int oracle, and timed: M1
    bls12_381 2^24 (and bls12_377 2^16 distinct points); M2 bw6_761 2^20;
    M3 the reference's headline, bls12_377, 1000 MSMs of 2^10 shared
    points at precompute_factor 23; M4 bn254 2^22 at nu 1, 2, 4 and with
    glv; M5 bn254 2^16 distinct points with Montgomery-form scalars,
    Montgomery-form points, bitsize 64, and an unshared batch of 8 x 2^12.
    Repeated-point inputs take P = k G, so the answer is one host scalar
    multiply."""
    from icicle_tpu_torch import MSMConfig, get_curve, msm_affine
    from icicle_tpu_torch.curves.host_ec import ec_add, ec_mul
    from icicle_tpu_torch.ops.msm import _auto_c, generic_plan, msm_precompute_bases
    from icicle_tpu_torch.ops.msm_tpu3 import msm_tpu3, msm_tpu3_prepare

    out = {}
    zero = dict.fromkeys(kernel_counters(), 0)

    def run(label, call, want, expect, limbs):
        got = counted(label, call, launches)
        if launches[label] != dict(zero, **expect):
            raise AssertionError(f"{label}: launched {launches[label]}, expected {expect}")
        if got != want:
            bad = (sum(a != b for a, b in zip(got, want)) if isinstance(want, list)
                   else f"{got} != {want}")
            raise AssertionError(f"{label}: MSM result differs from the oracle: {bad}")
        launched = {k: v for k, v in launches[label].items() if v}
        log(f"  {label}: == oracle, {limbs}-limb launches {launched} [{smi}]")
        return {"limbs": limbs, "launches": launched}

    def repeated(cname, n, seed, k):
        """n canonical scalars (on the card) and P = k G repeated, the oracle."""
        curve = get_curve(cname)
        fq, fr, mod = curve.fq, curve.fr, curve.fq.modulus
        P = ec_mul((curve.gen_x, curve.gen_y), k, mod)
        scal = canonical_scalars(np.random.default_rng(seed), (n,), fr)
        px = fq.from_ints([P[0]], dev).expand(n, fq.nlimbs).contiguous()
        py = fq.from_ints([P[1]], dev).expand(n, fq.nlimbs).contiguous()
        s = torch.from_numpy(scal.view(np.int32)).to(dev)
        return s, px, py, P, ec_mul(P, weighted_total(scal, fr.modulus), mod)

    def distinct(cname, n, seed, k):
        """P_i = (i + 1) P on the card, P = k G; canonical scalars."""
        curve = get_curve(cname)
        fq, mod = curve.fq, curve.fq.modulus
        P = ec_mul((curve.gen_x, curve.gen_y), k, mod)
        pts, cur = [], P
        for _ in range(n):
            pts.append(cur)
            cur = ec_add(cur, P, mod)
        return (fq.from_ints([p[0] for p in pts], dev), fq.from_ints([p[1] for p in pts], dev),
                P, np.arange(1, n + 1))

    def timed(label, call, want, n, per=1, reps=3, warmed=False):
        """The median of `reps` calls after a warm-up (`warmed`: the caller's
        last call, the same one, was it)."""
        ms, last = (timed_ms if warmed else host_ms)(call, reps=reps)
        if last != want:
            raise AssertionError(f"{label}: timed result differs from the oracle")
        log(f"  {label}: timed == oracle, {ms:.1f} ms, {ms / per:.3f} ms an MSM, "
            f"{n * per / (ms * 1e-3):.4g} points/s [{smi}]")
        return {"ms": ms, "ms_per_msm": ms / per, "points_per_s": n * per / (ms * 1e-3)}

    def profiled(label, call, want):
        got, prof = device_profile(label, call, smi)
        if got != want:
            raise AssertionError(f"profiled {label}: result differs from the oracle")
        return prof

    def slice_path(route, cname, s, px, py, want, timed_too=True):
        """One MSM of `route` over cname's G1 through the entry point a user
        calls (route_entry), counted against its plan's launches and held to
        the oracle; with timed_too, timed (median of 3 after a warm-up, the
        checked call; v1 one timed call where that ran past SLOW_CALL_S)
        and profiled (not v1: host-bound, a launch a window slot)."""
        n = s.shape[0]
        label = slice_label(route, cname, n.bit_length() - 1)
        call = lambda: route_entry(route, cname)(s, px, py)
        t0 = time.perf_counter()
        rec = run(label, call, want, expected_launches(route, n, cname),
                  get_curve(cname).fq.nlimbs)
        checked_s = time.perf_counter() - t0
        rec.update(route=route, n=n, checked_s=checked_s)
        if timed_too:
            reps = 1 if route == "v1" and checked_s > SLOW_CALL_S else 3
            rec.update(timed(label, call, want, n, reps=reps, warmed=True), timed_reps=reps)
            if route != "v1":
                rec["profile"] = profiled(label, call, want)
        return rec

    # M1 (bls12_381 2^24) and M2 (bw6_761 2^20), repeated point: msm_affine,
    # then v3 over prepared bases, timed and profiled
    for label, cname, n, seed, k in ((M1_MAIN, "bls12_381", 1 << M1_LOG, 3, 0xB15),
                                     (M2_MAIN, "bw6_761", 1 << M2_LOG, 4, 0xB6)):
        s, px, py, _, want = repeated(cname, n, seed, k)
        rec = run(label, lambda: msm_affine(cname, s, px, py), want,
                  v3_launches(v3_plan(cname, n)), get_curve(cname).fq.nlimbs)
        prepared = msm_tpu3_prepare(cname, px, py)
        torch.cuda.synchronize()
        call = lambda: msm_tpu3(cname, s, prepared=prepared)
        rec.update(timed(label, call, want, n), n=n, plan={
            k: prepared[k] for k in ("c", "T", "tiles", "wg", "n_windows", "M")})
        rec["profile"] = profiled(label, call, want)
        out[label] = rec
        del prepared
        torch.cuda.empty_cache()
        # the same inputs through v2 (B6 + B4) and the r12 engine (B5 + B4)
        for route in ("v2", "r12"):
            out[slice_label(route, cname, n.bit_length() - 1)] = slice_path(
                route, cname, s, px, py, want)
        del s, px, py
        torch.cuda.empty_cache()

    # v1 (B7) over the 12- and 24-limb curves, repeated point
    for cname, seed, k in (("bls12_381", 12, 0xB15), ("bw6_761", 13, 0xB6)):
        n = 1 << V1_LOGS[cname]
        s, px, py, _, want = repeated(cname, n, seed, k)
        out[slice_label("v1", cname, V1_LOGS[cname])] = slice_path("v1", cname, s, px, py, want)
        del s, px, py
        torch.cuda.empty_cache()

    # M1's second input: bls12_377 at 2^16 distinct points, msm_affine
    n = 1 << M1_377_LOG
    px, py, P, w = distinct("bls12_377", n, 5, 0xC0FFEE)
    fr377 = get_curve("bls12_377").fr
    scal = canonical_scalars(np.random.default_rng(6), (n,), fr377)
    s = torch.from_numpy(scal.view(np.int32)).to(dev)
    want = ec_mul(P, weighted_total(scal, fr377.modulus, w), get_curve("bls12_377").fq.modulus)
    rec = run(M1_377, lambda: msm_affine("bls12_377", s, px, py), want,
              v3_launches(v3_plan("bls12_377", n)), 12)
    rec.update(timed(M1_377, lambda: msm_affine("bls12_377", s, px, py), want, n), n=n)
    out[M1_377] = rec
    # the same distinct points (distinct keys: B6's run flags) through v2, r12 and v1
    for route in ("v2", "r12", "v1"):
        out[slice_label(route, "bls12_377", M1_377_LOG)] = slice_path(
            route, "bls12_377", s, px, py, want, timed_too=False)
    # grumpkin at 2^16 distinct points through r12
    px_g, py_g, P_g, w_g = distinct("grumpkin", n, 14, 0xC0FFEE)
    fr_g = get_curve("grumpkin").fr
    scal = canonical_scalars(np.random.default_rng(15), (n,), fr_g)
    s_g = torch.from_numpy(scal.view(np.int32)).to(dev)
    want_g = ec_mul(P_g, weighted_total(scal, fr_g.modulus, w_g), get_curve("grumpkin").fq.modulus)
    out[slice_label("r12", "grumpkin", M1_377_LOG)] = slice_path(
        "r12", "grumpkin", s_g, px_g, py_g, want_g, timed_too=False)
    del px_g, py_g, s_g

    # M3: the reference's headline, 1000 MSMs of 2^10 shared points at nu 23
    curve = get_curve("bls12_377")
    n = 1 << M3_LOG
    px, py, P, w = distinct("bls12_377", n, 7, 0x377)
    cfg = MSMConfig(c=M3_C, precompute_factor=M3_NU)
    bx, by = counted(M3_BASES, lambda: msm_precompute_bases("bls12_377", px, py, cfg), launches)
    if launches[M3_BASES] != dict(zero, precompute_bases=1):
        raise AssertionError(f"{M3_BASES}: launched {launches[M3_BASES]}")
    scal = canonical_scalars(np.random.default_rng(8), (M3_BATCH, n), curve.fr)
    s = torch.from_numpy(scal.view(np.int32)).to(dev)
    table = [P]
    for _ in range(curve.fr.modulus.bit_length() + 10):
        table.append(ec_add(table[-1], table[-1], curve.fq.modulus))
    want = [fixed_base_mul(table, t, curve.fq.modulus)
            for t in weighted_total(scal, curve.fr.modulus, w)]
    plan = generic_plan("bls12_377", M3_NU * n, M3_C, M3_NU)
    call = lambda: msm_affine("bls12_377", s, bx, by, cfg)
    rec = run(M3_MAIN, call, want, v3_launches(plan, M3_BATCH), 12)
    # one timed call after the warm-up: it is already the mean of 1000 MSMs
    rec.update(timed(M3_MAIN, call, want, n, per=M3_BATCH, reps=1), batch=M3_BATCH, n=n,
               plan={k: plan[k] for k in ("c", "T", "tiles", "wg", "n_windows", "M")})
    # the profile takes the first M3_PROFILED MSMs of the batch: its idle
    # share is the batch's, for a tenth of the profiler's parsing
    rec["profile"] = profiled(f"{M3_PROFILED} of {M3_MAIN}",
                              lambda: msm_affine("bls12_377", s[:M3_PROFILED], bx, by, cfg),
                              want[:M3_PROFILED])
    out[M3_MAIN] = rec
    del s, bx, by

    # M4: bn254 2^22, repeated point, nu 1, 2, 4 (one c) and glv
    n = 1 << M4_LOG
    s, px, py, _, want = repeated("bn254", n, 9, 0xDEADBEEF)
    for nu in M4_NU:
        cfg = MSMConfig(c=M4_C, precompute_factor=nu)
        if nu > 1:
            bx, by = counted(M4_BASES[nu], lambda: msm_precompute_bases("bn254", px, py, cfg),
                             launches)
            if launches[M4_BASES[nu]] != dict(zero, precompute_bases=1):
                raise AssertionError(f"{M4_BASES[nu]}: launched {launches[M4_BASES[nu]]}")
        else:
            bx, by = px, py
        label = M4_MAIN[nu]
        rec = run(label, lambda: msm_affine("bn254", s, bx, by, cfg), want,
                  v3_launches(v3_plan("bn254", nu * n, M4_C, nu=nu)), 8)
        prepared = msm_tpu3_prepare("bn254", bx, by, c=M4_C, precompute_factor=nu)
        rec.update(timed(label, lambda: msm_tpu3("bn254", s, prepared=prepared,
                                                 precompute_factor=nu), want, n), n=n)
        out[label] = rec
        del bx, by, prepared
        torch.cuda.empty_cache()
    rec = run(M4_GLV, lambda: msm_tpu3("bn254", s, px, py, c=M4_C, glv=True), want,
              v3_launches(v3_plan("bn254", n, M4_C, glv=True)), 8)
    prepared = msm_tpu3_prepare("bn254", px, py, c=M4_C, glv=True)
    rec.update(timed(M4_GLV, lambda: msm_tpu3("bn254", s, prepared=prepared, glv=True), want,
                     n), n=n)
    out[M4_GLV] = rec
    log("  M4 side by side (ms): " + ", ".join(
        f"{k} {out[k]['ms']:.1f}" for k in [*M4_MAIN.values(), M4_GLV]) + f" [{smi}]")
    del s, px, py, prepared
    torch.cuda.empty_cache()

    # M5: bn254 2^16 distinct points; Montgomery-form scalars, Montgomery-form
    # points, bitsize 64, and an unshared batch of 8 x 2^12
    curve = get_curve("bn254")
    fq, fr, mod = curve.fq, curve.fr, curve.fq.modulus
    n = 1 << M5_LOG
    px, py, P, w = distinct("bn254", n, 10, 0xC0FFEE)
    scal = canonical_scalars(np.random.default_rng(11), (n,), fr)
    s = torch.from_numpy(scal.view(np.int32)).to(dev)
    want = ec_mul(P, weighted_total(scal, fr.modulus, w), mod)
    small = scal.copy()
    small[:, 2:] = 0                                             # scalars below 2^64
    s64 = torch.from_numpy(small.view(np.int32)).to(dev)
    want64 = ec_mul(P, weighted_total(small, fr.modulus, w), mod)
    nb = 1 << M5_BATCH_LOG
    sb = s[:M5_BATCH * nb].view(M5_BATCH, nb, -1)
    wb = [ec_mul(P, t, mod) for t in (weighted_total(scal[b * nb:(b + 1) * nb], fr.modulus,
                                                     w[b * nb:(b + 1) * nb])
                                      for b in range(M5_BATCH))]
    cases = {
        "montgomery scalars": (fr.to_mont(s), px, py,
                               MSMConfig(are_scalars_montgomery_form=True), want, n),
        "montgomery points": (s, fq.to_mont(px), fq.to_mont(py),
                              MSMConfig(are_points_montgomery_form=True), want, n),
        "bitsize 64": (s64, px, py, MSMConfig(bitsize=64), want64, None),
        "unshared batch": (sb, px[:M5_BATCH * nb], py[:M5_BATCH * nb],
                           MSMConfig(are_points_shared_in_batch=False), wb, nb),
    }
    for key, (sc, x, y, cfg, want_k, generic_n) in cases.items():
        label = M5_MAIN[key]
        if generic_n is None:                                    # v3 at bitsize 64
            expect = v3_launches(v3_plan("bn254", n, bitsize=64))
        else:
            expect = v3_launches(generic_plan("bn254", generic_n, _auto_c(generic_n)),
                                 M5_BATCH if key == "unshared batch" else 1)
        call = lambda sc=sc, x=x, y=y, cfg=cfg: msm_affine("bn254", sc, x, y, cfg)
        rec = run(label, call, want_k, expect, 8)
        per = M5_BATCH if key == "unshared batch" else 1
        rec.update(timed(label, call, want_k, generic_n or n, per=per))
        out[label] = rec
    del px, py, s
    torch.cuda.empty_cache()
    return out


# -- G2 and the extension fields: B3/B4/precompute_bases over Fp2, E1-E6 --------

G2_CURVES = ("bn254", "bls12_381", "bls12_377", "bw6_761")
E1_LOG, E2_LOG, E3_LOG = 22, 20, 16
E1_MAIN = f"msm bn254 G2 2^{E1_LOG}"
E2_MAIN = f"msm bls12_381 G2 2^{E2_LOG}"
E3_MAIN = {c: f"msm {c} G2 2^{E3_LOG}" for c in ("bls12_377", "bw6_761")}
E1_OTHER_C = (12, 16)   # E1 also timed at these c: the first runs' explicit c, the closed form's
E4_LOG, E4_NU, E4_C = 20, 2, 11
E4_BASES = f"msm_precompute_bases bn254 G2 2^{E4_LOG} x {E4_NU} (c {E4_C})"
E4_MAIN = f"msm bn254 G2 2^{E4_LOG} precompute_factor {E4_NU} (c {E4_C})"
E4_BATCH, E4_BATCH_LOG = 8, 12
E4_BATCHED = f"msm bn254 G2 {E4_BATCH} x 2^{E4_BATCH_LOG} shared"
E5_LOG = 16
E5_MAIN = {g: f"msm bn254 {g} 2^{E5_LOG} (the KZG-style pairing identity)" for g in ("G1", "G2")}
E6_LOG = 24
E6_MAIN = f"ntt_ext babybear4 2^{E6_LOG} fwd+inv"
G2_PATH_LOGS = {"bn254": E1_LOG, "bls12_381": E2_LOG, "bls12_377": E3_LOG, "bw6_761": E3_LOG}
G2_PATH_NAMES = {"bn254": "E1", "bls12_381": "E2", "bls12_377": "E3", "bw6_761": "E3"}
G2_PRE_N = 1 << 12
G2_PRE_NU, G2_PRE_SHIFT = 3, 16   # a short shift, as M3's (nu 23, c 8) is


def g2_paths(dev, smi: str, launches: dict) -> dict:
    """E1-E6 on CUDA tensors through the entry points a user calls, each
    counted (B3 and B4 at the group's instance, precompute_bases where used,
    dif_rows for E6, nothing else), gated by an oracle, timed and (E1-E4,
    E6) profiled. Inputs follow pool_points: 64 points k_i Q of known logs,
    tiled, and scalars below r from the seed, so the oracle is one scalar
    multiply on the host: E1 bn254 G2 2^22 (Groth16's B query), E2
    bls12_381 G2 2^20, E3 bls12_377 and bw6_761 G2 2^16, each through
    MSMConfig(g2=True) at msm()'s default c (E1 also timed at
    E1_OTHER_C); E4 bn254 G2
    msm_precompute_bases at nu 2 over 2^20 points, then its MSM with
    explicit c, and a shared-point batch of 8 x 2^12; E5 bn254 G1 and G2
    MSMs of one set of scalars over k_i G1 and k_i G2, then e(A1, G2) ==
    e(G1, A2) by `pairing` and `ate_pairing` on the host; E6 a babybear4
    ntt_ext 2^24 forward and inverse, 8 dif_rows launches each way, equal
    to the component-wise torch NTT."""
    from icicle_tpu_torch import MSMConfig, msm_affine
    from icicle_tpu_torch.curves import ate, pairing
    from icicle_tpu_torch.curves.host_ec import ec_mul, host_ops, scalar_mul
    from icicle_tpu_torch.curves.group import get_group
    from icicle_tpu_torch.fields.extension import get_ext_field
    from icicle_tpu_torch.ops import ntt as N
    from icicle_tpu_torch.ops.msm import default_c, generic_plan, msm_precompute_bases
    from icicle_tpu_torch.runtime.config import NTTConfig, NTTDir

    out = {}
    zero = dict.fromkeys(kernel_counters(), 0)

    def run(label, call, want, expect, inst):
        got = counted(label, call, launches)
        if launches[label] != dict(zero, **expect):
            raise AssertionError(f"{label}: launched {launches[label]}, expected {expect}")
        if got != want:
            bad = (sum(a != b for a, b in zip(got, want)) if isinstance(want, list)
                   else f"{got} != {want}")
            raise AssertionError(f"{label}: result differs from the oracle: {bad}")
        launched = {k: v for k, v in launches[label].items() if v}
        log(f"  {label}: == oracle, launches {launched} [{smi}]")
        return {"instance": inst, "launches": launched}

    def timed(label, call, want, n, per=1, reps=3):
        ms, last = host_ms(call, reps=reps)
        if last != want:
            raise AssertionError(f"{label}: timed result differs from the oracle")
        log(f"  {label}: timed == oracle, {ms:.1f} ms, {ms / per:.3f} ms an MSM, "
            f"{n * per / (ms * 1e-3):.4g} points/s [{smi}]")
        return {"ms": ms, "ms_per_msm": ms / per, "points_per_s": n * per / (ms * 1e-3)}

    def profiled(label, call, want):
        got, prof = device_profile(label, call, smi)
        if got != want:
            raise AssertionError(f"profiled {label}: result differs from the oracle")
        return prof

    def tiled(g, n, seed):
        """(px, py) of n points k_(i mod 64) Q on the card, (n, Ls) canonical
        scalars there and as numpy, and the k_i as weights."""
        pool, ks = pool_points(g), pool_logs()
        f = g.coord_field
        reps = -(-n // 64)
        px = f.from_ints([p[0] for p in pool], dev).repeat(reps, 1)[:n].contiguous()
        py = f.from_ints([p[1] for p in pool], dev).repeat(reps, 1)[:n].contiguous()
        scal = canonical_scalars(np.random.default_rng(seed), (n,), g.curve.fr)
        w = np.array((ks * reps)[:n], dtype=np.uint64)
        return px, py, torch.from_numpy(scal.view(np.int32)).to(dev), scal, w

    def oracle(g, scal, w):
        """sum_i s_i k_i Q: one host scalar multiply (the identity as
        msm_affine reads it)."""
        pt = scalar_mul(g, group_generator(g), weighted_total(scal, g.curve.fr.modulus, w))
        return pt if pt is not None else host_ops(g)[3]

    def inst(g):
        return f"{g.base_limbs}-limb, degree {g.degree}"

    # E1-E3: a G2 MSM a curve through msm_affine; E1 and E2 timed and profiled
    for label, cname, log_n, seed in ((E1_MAIN, "bn254", E1_LOG, 21),
                                      (E2_MAIN, "bls12_381", E2_LOG, 22),
                                      (E3_MAIN["bls12_377"], "bls12_377", E3_LOG, 23),
                                      (E3_MAIN["bw6_761"], "bw6_761", E3_LOG, 24)):
        g = get_group(cname, g2=True)
        n = 1 << log_n
        px, py, s, scal, w = tiled(g, n, seed)
        want = oracle(g, scal, w)
        call = lambda: msm_affine(cname, s, px, py, MSMConfig(g2=True))
        c = default_c(n, g2=True)
        log(f"  {label}: MSMConfig(g2=True), the default c {c}")
        rec = run(label, call, want, v3_launches(generic_plan(cname, n, c, g2=True)), inst(g))
        rec.update(timed(label, call, want, n, reps=3 if log_n > E3_LOG else 5), n=n, c=c)
        if log_n > E3_LOG:
            rec["profile"] = profiled(label, call, want)
        if label == E1_MAIN:
            rec["other_c_ms"] = {c2: timed(f"{label} at c {c2}", lambda: msm_affine(
                cname, s, px, py, MSMConfig(g2=True, c=c2)), want, n, reps=2)["ms"]
                for c2 in E1_OTHER_C}
        out[label] = rec
        del px, py, s
        torch.cuda.empty_cache()

    # E4: precomputed G2 bases at nu 2, their MSM with explicit c, and a
    # shared-point batch
    g = get_group("bn254", g2=True)
    n = 1 << E4_LOG
    px, py, s, scal, w = tiled(g, n, 25)
    want = oracle(g, scal, w)
    cfg = MSMConfig(g2=True, c=E4_C, precompute_factor=E4_NU)
    bx, by = counted(E4_BASES, lambda: msm_precompute_bases("bn254", px, py, cfg), launches)
    if launches[E4_BASES] != dict(zero, precompute_bases=1):
        raise AssertionError(f"{E4_BASES}: launched {launches[E4_BASES]}")
    call = lambda: msm_affine("bn254", s, bx, by, cfg)
    plan = generic_plan("bn254", E4_NU * n, E4_C, E4_NU, g2=True)
    rec = run(E4_MAIN, call, want, v3_launches(plan), inst(g))
    rec.update(timed(E4_MAIN, call, want, n), n=n)
    rec["profile"] = profiled(E4_MAIN, call, want)
    out[E4_MAIN] = rec
    del bx, by
    nb = 1 << E4_BATCH_LOG
    sb = s[:E4_BATCH * nb].view(E4_BATCH, nb, -1)
    wb = [scalar_mul(g, group_generator(g), t) for t in (
        weighted_total(scal[b * nb:(b + 1) * nb], g.curve.fr.modulus, w[:nb])
        for b in range(E4_BATCH))]
    call = lambda: msm_affine("bn254", sb, px[:nb], py[:nb], MSMConfig(g2=True))
    rec = run(E4_BATCHED, call, wb, v3_launches(generic_plan("bn254", nb, default_c(nb, True),
                                                             g2=True),
                                                E4_BATCH), inst(g))
    rec.update(timed(E4_BATCHED, call, wb, nb, per=E4_BATCH))
    out[E4_BATCHED] = rec
    del px, py, s, sb
    torch.cuda.empty_cache()

    # E5: the same scalars over k_i G1 and k_i G2; e(A1, G2) == e(G1, A2)
    n = 1 << E5_LOG
    g2 = get_group("bn254", g2=True)
    curve = g2.curve
    fq, mod = curve.fq, curve.fq.modulus
    g1_pt = (curve.gen_x, curve.gen_y)
    px2, py2, s, scal, w = tiled(g2, n, 26)
    g1_pool = pool_points(curve)
    reps = n // 64
    px1 = fq.from_ints([p[0] for p in g1_pool], dev).repeat(reps, 1).contiguous()
    py1 = fq.from_ints([p[1] for p in g1_pool], dev).repeat(reps, 1).contiguous()
    total = weighted_total(scal, curve.fr.modulus, w)
    want1, want2 = ec_mul(g1_pt, total, mod), scalar_mul(g2, group_generator(g2), total)
    msm1 = lambda: msm_affine("bn254", s, px1, py1, MSMConfig())
    msm2 = lambda: msm_affine("bn254", s, px2, py2, MSMConfig(g2=True))
    a1 = run(E5_MAIN["G1"], msm1, want1, v3_launches(v3_plan("bn254", n)), "8-limb, degree 1")
    a2 = run(E5_MAIN["G2"], msm2, want2,
             v3_launches(generic_plan("bn254", n, default_c(n, g2=True), g2=True)), inst(g2))
    t0 = time.perf_counter()
    lhs, rhs = pairing.pairing("bn254", want1, group_generator(g2)), \
        pairing.pairing("bn254", g1_pt, want2)
    if lhs != rhs or lhs == pairing.target_one("bn254"):
        raise AssertionError("E5: pairing(A1, G2) != pairing(G1, A2), or degenerate")
    if ate.ate_pairing("bn254", want1, group_generator(g2)) != \
            ate.ate_pairing("bn254", g1_pt, want2):
        raise AssertionError("E5: ate_pairing(A1, G2) != ate_pairing(G1, A2)")
    pairing_s = time.perf_counter() - t0
    log(f"  E5: pairing(A1, G2) == pairing(G1, A2) and the same by ate_pairing, non-degenerate, "
        f"on the host in {pairing_s:.2f} s")
    a1.update(timed(E5_MAIN["G1"], msm1, want1, n))
    a2.update(timed(E5_MAIN["G2"], msm2, want2, n))
    out[E5_MAIN["G1"]], out[E5_MAIN["G2"]] = a1, dict(a2, pairing_s=pairing_s)
    del px1, py1, px2, py2, s
    torch.cuda.empty_cache()

    # E6: babybear4 ntt_ext 2^24 forward and inverse
    ef = get_ext_field("babybear")
    f = ef.base
    x = torch.randint(0, f.modulus, (1 << E6_LOG, ef.degree), dtype=torch.int32, device=dev)

    def fwd_inv():
        y = N.ntt_ext(ef, x, NTTDir.FORWARD)
        return y, N.ntt_ext(ef, y, NTTDir.INVERSE)

    y, z = counted(E6_MAIN, fwd_inv, launches)
    expect = 4 * ef.degree
    if launches[E6_MAIN] != dict(zero, dif_rows=expect):
        raise AssertionError(f"{E6_MAIN}: launched {launches[E6_MAIN]}, expected {expect} "
                             "dif_rows (two a component each way)")
    ref = torch.stack([N._ntt_torch(f, x[:, i].contiguous(), NTTDir.FORWARD, NTTConfig())
                       for i in range(ef.degree)], -1)
    if not torch.equal(y, ref) or not torch.equal(z, x):
        raise AssertionError(f"{E6_MAIN}: forward != the component-wise torch NTT, or the "
                             "round trip != x")
    del ref, z
    fwd_ms, _ = host_ms(lambda: N.ntt_ext(ef, x, NTTDir.FORWARD))
    inv_ms, _ = host_ms(lambda: N.ntt_ext(ef, y, NTTDir.INVERSE))
    _, prof = device_profile(E6_MAIN, lambda: N.ntt_ext(ef, x, NTTDir.FORWARD), smi)
    log(f"  {E6_MAIN}: == component-wise _ntt_torch, round trip exact, {expect} dif_rows; "
        f"forward {fwd_ms:.3f} ms, inverse {inv_ms:.3f} ms [{smi}]")
    out[E6_MAIN] = {"launches": {"dif_rows": expect}, "forward_ms": fwd_ms,
                    "inverse_ms": inv_ms, "profile": prof}
    del x, y
    torch.cuda.empty_cache()
    return out


# -- the ECNTT, the babykoala rings and lattice ops, ML-KEM (EC1, L1, Q1) ------------

ECNTT_STEP = 0x9E3779B97F4A7C15F39CC0605CEDC835  # EC1's input: the log step between blocks of 64
ECNTT_COSET = 5             # EC1's coset generator
# (curve, log n, samples held to the oracle, inverse): EC1's transforms; the
# kernel checks run at the same sizes
EC1_PATHS = (("bn254", 16, 64, True), ("bls12_381", 13, 64, True), ("bw6_761", 8, 16, False))
EC1_MAIN = "ecntt bn254 2^16 fwd"
RNS_LOG = 24
RQ_POLYS_LOG = 16           # negacyclic NTTs over 2^16 R_q polynomials (2^22 coefficients)
RQ_MATMUL = (64, 256, 64)   # (n, m, k) R_q matrices
LATTICE_LOG = 22
LATTICE_BASE = 1 << 16
JL_ROWS = 32                # JL output rows at 2^22 inputs: 2^19 host Keccak-512 calls
NORM_MAX = 1 << 15          # the norm check's entries lie in [-NORM_MAX, NORM_MAX]
RNS_MAIN = f"ntt_rns 2^{RNS_LOG} fwd+inv"
RQ_MAIN = f"negacyclic_ntt 2^{RQ_POLYS_LOG} polynomials fwd+inv"
RQ_MATMUL_MAIN = "rq_matmul (64 x 256) by (256 x 64)"
MLKEM_CASES = (("768", 16), ("512", 12), ("1024", 12))   # (parameter set, log batch)
MLKEM_MAIN = "ml-kem-768 2^16"
MLKEM_SAMPLES = 64
# the ring ops at ML-KEM-768 2^16: (B, k) vectors, (B, k, k) products
MLKEM_POLYS = {"ntt": 3 << 16, "intt": 3 << 16, "multiply_ntts": 9 << 16}
# (role, log batch, message bytes, rate, pad byte, output bytes): every
# sponge ML-KEM calls, at Q1's largest batch for it (ML-KEM-768's at 2^16;
# ML-KEM-512's eta 3 PRF and 512's and 1024's ek and ciphertext lengths at
# 2^12), and a squeeze of many blocks
SPONGE_CHECKS = (
    ("SHA3-512 G(d || k)", 16, 33, 72, 0x06, 64), ("SHA3-512 G(m || h)", 16, 64, 72, 0x06, 64),
    ("SHA3-256 H(ek) 512", 12, 800, 136, 0x06, 32),
    ("SHA3-256 H(ek) 768", 16, 1184, 136, 0x06, 32),
    ("SHA3-256 H(ek) 1024", 12, 1568, 136, 0x06, 32),
    ("SHAKE128 XOF(rho || j || i)", 16, 34, 168, 0x1F, 504 * 3),
    ("SHAKE256 PRF eta 2", 16, 33, 136, 0x1F, 128),
    ("SHAKE256 PRF eta 3", 12, 33, 136, 0x1F, 192),
    ("SHAKE256 J(z || c) 512", 12, 32 + 768, 136, 0x1F, 32),
    ("SHAKE256 J(z || c) 768", 16, 32 + 1088, 136, 0x1F, 32),
    ("SHAKE256 J(z || c) 1024", 12, 32 + 1568, 136, 0x1F, 32),
    ("SHAKE256 31 blocks out", 12, 5, 136, 0x1F, 4200))
SPONGE_MAIN = "SHAKE128 XOF(rho || j || i)"   # the kernels line's sponge: the matrix XOF


def check_against_plain(label: str, fn, ref, args: tuple, bound_of: tuple,
                        reps: int = REPS) -> dict:
    """fn(*args), a kernel's wrapper, against ref(*args), its plain
    version, on the card: bit-exact (a tensor, or each coordinate of a
    tuple); then fn timed alone on the same inputs. bound_of is the
    launch's (bound ms, bound_by)."""
    got = fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ref(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
    err = max(_exact(label, u, v) for u, v in pairs)
    del got, want
    kernel_ms = cuda_ms(lambda: fn(*args), reps)
    return {"max_abs_diff": err, "plain_ms": plain_ms, "kernel_ms": kernel_ms,
            "bound_ms": bound_of[0], "bound_by": bound_of[1]}


TABLE_DBLS = TABLE_ADDS = 7   # a 16-entry table from P: 2i by a doubling, 2i + 1 by an add


def ladder_monts(rows, glv: bool) -> int:
    """Montgomery multiplies of the ladders over the columns of `rows`, the
    least this run's digits need: for each lane whose scalar is not 0, a
    table of TABLE_DBLS doublings and TABLE_ADDS adds (entry 1 is P), and
    with GLV 15 multiplies by beta for phi's table (its entry i is (beta x,
    +-y, z) of entry i); then from the first row with a nonzero digit, 4
    doublings a later row and an add a nonzero digit after the first. b3
    is an add chain on every G1 curve."""
    digits = torch.stack(rows[:2]) if glv else rows.unsqueeze(0)   # (tables, ndig, lanes)
    nz = digits != 0
    live = nz.any(0)
    used = live.any(0)
    first = live.to(torch.int32).argmax(0)
    ndig = digits.shape[1]
    dbls = int(torch.where(used, 4 * (ndig - 1 - first), 0).sum())
    lanes = int(used.sum())
    adds = int(nz.sum()) - lanes
    return ((dbls + TABLE_DBLS * lanes) * DBL_MONTS + (adds + TABLE_ADDS * lanes) * PADD_MONTS
            + (15 * lanes if glv else 0))


def ecntt_bound(g, lanes: int, rows, glv: bool, stage: bool) -> tuple[float, str]:
    """One launch's least time: its points read and written once (2 lanes
    points for a stage, `lanes` for the scale), its digit rows read once;
    the ladders' multiplies (ladder_monts over the rows' columns, each
    serving lanes / columns lanes; none for stage 1, rows None) and a
    stage's two adds a lane."""
    nl = g.nlimbs
    nbytes = lanes * (2 if stage else 1) * 3 * nl * 4 * 2
    monts = 2 * PADD_MONTS * lanes if stage else 0
    if rows is not None:
        parts = rows if glv else (rows,)
        nbytes += sum(t.numel() * t.element_size() for t in parts)
        monts += ladder_monts(rows, glv) * (lanes // parts[0].shape[1])
    return bound(nbytes, monts * big_mont_muls(nl))


def ecntt_transform_bound(g, logn: int, stage_rows: list, scale_rows: list) -> float:
    """Sum of the bounds of a GLV transform's launches: stage 1 (no
    ladder), stages 2..logn over their digit rows, a scale launch for each
    of scale_rows."""
    n = 1 << logn
    total = ecntt_bound(g, n // 2, None, True, True)[0]
    total += sum(ecntt_bound(g, n // 2, r, True, True)[0] for r in stage_rows)
    return total + sum(ecntt_bound(g, n, r, True, False)[0] for r in scale_rows)


@functools.lru_cache(maxsize=None)
def _ecntt_affine(cname: str, n: int) -> tuple:
    """(affine Python ints of n points a_j G of G1 of cname, the a_j):
    a_j = k_(j mod 64) + (j div 64) ECNTT_STEP, the 64 pool points plus a
    multiple of S = ECNTT_STEP G that changes every 64 lanes, so the input
    has no period; by host adds, once a size."""
    from icicle_tpu_torch import get_group
    from icicle_tpu_torch.curves.host_ec import INF, ec_add, scalar_mul
    g = get_group(cname)
    pool, logs = pool_points(g), pool_logs()
    mod, r = g.curve.fq.modulus, g.curve.fr.modulus
    step = scalar_mul(g, group_generator(g), ECNTT_STEP)
    pts, shift = [], INF
    while len(pts) < n:
        pts.extend(ec_add(p, shift, mod) for p in pool)
        shift = ec_add(shift, step, mod)
    if any(p is INF for p in pts[:n]):
        raise AssertionError("ecntt_points: an input point is the identity")
    return pts[:n], [(logs[j % len(logs)] + ECNTT_STEP * (j // len(logs))) % r for j in range(n)]


def ecntt_points(g, n: int, dev):
    """(n points a_j G (_ecntt_affine) as Montgomery projective coordinates
    on dev, z = 1; the a_j)."""
    pts, logs = _ecntt_affine(g.curve.name, n)
    fq = g.curve.fq
    x = fq.from_ints([p[0] for p in pts], dev)
    y = fq.from_ints([p[1] for p in pts], dev)
    return g.from_affine_canonical(x, y), logs


def check_ecntt_kernels(dev, smi: str) -> list:
    """ecntt_stage and ecntt_scale against their plain versions, bit-exact
    (x, y and z), at every limb count and at the shapes EC1 gives them: on
    each EC1 curve's 2^logn input points, stage 1 (n / 2 lanes, no
    ladder), the last stage (n / 2 lanes, its twiddles' digit rows) with
    the GLV and with the plain ladder, and the GLV scale (the scale's only
    ladder, as in the JAX package) of n lanes by random scalars below r;
    each timed alone there."""
    from icicle_tpu_torch.kernels import ecntt_kernel as EK
    from icicle_tpu_torch.ops import ecntt as E
    from icicle_tpu_torch import get_group

    rows = []
    for cname, logn, _, _ in EC1_PATHS:
        g = get_group(cname)
        n = 1 << logn
        P, _ = ecntt_points(g, n, dev)
        r = g.curve.fr.modulus
        rng = np.random.default_rng(logn)
        scalars = [int.from_bytes(rng.bytes(r.bit_length() // 8 + 8), "little") % r
                   for _ in range(n)]
        scale_rows = E._to_device(E._glv_rows(cname, scalars), dev)
        last = {glv: E._stage_rows(cname, logn, False, glv, dev)[-1] for glv in (True, False)}
        for entry, glv, rws in (("stage 1", True, None), ("stage", True, last[True]),
                                ("stage", False, last[False]), ("scale", True, scale_rows)):
            if entry == "scale":
                fn, ref, args, lanes = EK.ecntt_scale, EK.ecntt_scale_ref, (rws,), n
            else:
                m = 1 if rws is None else n // 2
                fn, ref, args, lanes = EK.ecntt_stage, EK.ecntt_stage_ref, (m, rws, glv), n // 2
            label = f"ecntt_{entry} {cname} {'no' if rws is None else 'GLV' if glv else 'plain'}"
            ndig = 0 if rws is None else (rws[0] if glv else rws).shape[0]
            row = check_against_plain(label, lambda *a: fn(g, P, *a), lambda *a: ref(g, P, *a),
                                      args, ecntt_bound(g, lanes, rws, glv, entry != "scale"),
                                      reps=3)
            row.update(curve=cname, limbs=g.nlimbs, entry=entry, glv=glv, logn=logn,
                       lanes=lanes, digit_rows=ndig)
            rows.append(row)
            log(f"  {label} ladder ({g.nlimbs} limbs), {lanes} lanes x {ndig} digit rows: exact; "
                f"kernel {row['kernel_ms']:.3f} ms, plain {row['plain_ms']:.1f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}) [{smi}]")
        del P, scale_rows
        torch.cuda.empty_cache()
    return rows


def _affine_rows(g, pts, lanes) -> list:
    """Affine Python ints of the sampled lanes of Montgomery projective pts
    ((0, 0) for the identity): X / Z, Y / Z on the host (R cancels)."""
    fq = g.curve.fq
    idx = torch.tensor(lanes, dtype=torch.int64, device=pts.x.device)
    xs, ys, zs = (fq.to_ints(c.index_select(0, idx)) for c in pts)
    p = fq.modulus
    out = []
    for x, y, z in zip(xs, ys, zs):
        zi = pow(int(z), -1, p) if int(z) else 0
        out.append((int(x) * zi % p, int(y) * zi % p))
    return out


def _ecntt_oracle(g, pts, logs, coset, samples: int, label: str) -> list:
    """Holds the sampled lanes k of an ECNTT of a_j G to (NTT(a)_k) G: the
    scalar NTT by the port's ntt over the scalar field (backend "torch"),
    the multiply on the host from a table of 2^i G."""
    from icicle_tpu_torch import NTTConfig, NTTDir, ntt
    from icicle_tpu_torch.curves.host_ec import ec_add
    fr = g.curve.fr
    n = len(logs)
    a = fr.from_ints(logs, pts.x.device)
    scal = fr.to_ints(ntt(fr, a, NTTDir.FORWARD, NTTConfig(coset_gen=coset, backend="torch")))
    rng = np.random.default_rng(n)
    lanes = sorted({0, n - 1, *rng.choice(n, size=min(samples, n) - 2, replace=False).tolist()})
    mod = g.curve.fq.modulus
    table = [group_generator(g)]
    for _ in range(fr.modulus.bit_length()):
        table.append(ec_add(table[-1], table[-1], mod))
    got = _affine_rows(g, pts, lanes)
    for k, pt in zip(lanes, got):
        if pt != fixed_base_mul(table, int(scal[k]), mod):
            raise AssertionError(f"{label}: lane {k} != NTT(a)_{k} G")
    return lanes


def _equals_input(g, out, P) -> bool:
    """out equals the affine input points P (z = 1) lane for lane:
    x_out == x z_out and y_out == y z_out in Montgomery form, z_out != 0."""
    m = g.f.mul_mont
    return (not bool(g.f.is_zero(out.z).any()) and torch.equal(out.x, m(P.x, out.z))
            and torch.equal(out.y, m(P.y, out.z)))


def ecntt_paths(dev, smi: str, launches: dict) -> dict:
    """EC1: the ECNTT through icicle_tpu_torch.ecntt on CUDA tensors. bn254
    at 2^16 points a_j G (ecntt_points: no period): a forward in natural
    order, a forward on the coset g = ECNTT_COSET and its inverse, which
    must give every input back; bls12_381 at 2^13 (an FK20 all-proofs
    circulant over one 4096-element blob), forward and inverse; bw6_761 at
    2^8, forward. Each forward's sampled lanes k equal (NTT(a)_k) G; each
    call counted (a stage launch a stage, a scale launch for the coset
    shift and for the inverse's n^-1 and unscale), the forwards and the
    inverses timed on the host clock, a bn254 forward profiled."""
    from icicle_tpu_torch import NTTConfig, NTTDir, ecntt, get_group
    from icicle_tpu_torch.ops.ecntt import _scale_rows, _stage_rows

    out = {}
    zero = dict.fromkeys(kernel_counters(), 0)
    for cname, logn, samples, inverse in EC1_PATHS:
        g = get_group(cname)
        n = 1 << logn
        P, logs = ecntt_points(g, n, dev)
        label = f"ecntt {cname} 2^{logn} fwd"
        y = counted(label, lambda: ecntt(cname, P, NTTDir.FORWARD), launches)
        if launches[label] != dict(zero, ecntt_stage=logn):
            raise AssertionError(f"{label}: launched {launches[label]}, expected {logn} stages")
        lanes = _ecntt_oracle(g, y, logs, None, samples, label)
        fwd_ms, _ = host_ms(lambda: ecntt(cname, P, NTTDir.FORWARD), reps=3)
        row = {"curve": cname, "logn": logn, "forward_ms": fwd_ms, "oracle_lanes": len(lanes),
               "forward_bound_ms": ecntt_transform_bound(
                   g, logn, _stage_rows(cname, logn, False, True, dev), [])}
        log(f"  {label}: {logn} ecntt_stage launches, {len(lanes)} sampled lanes == NTT(a)_k G; "
            f"forward {fwd_ms:.2f} ms (bound {row['forward_bound_ms']:.3f} ms) [{smi}]")
        cfg = NTTConfig()
        if cname == "bn254":
            cfg = NTTConfig(coset_gen=ECNTT_COSET)
            clabel = f"ecntt {cname} 2^{logn} fwd coset {ECNTT_COSET}"
            y = counted(clabel, lambda: ecntt(cname, P, NTTDir.FORWARD, cfg), launches)
            if launches[clabel] != dict(zero, ecntt_stage=logn, ecntt_scale=1):
                raise AssertionError(f"{clabel}: launched {launches[clabel]}")
            _ecntt_oracle(g, y, logs, ECNTT_COSET, samples, clabel)
            _, row["profile"] = device_profile(label, lambda: ecntt(cname, P, NTTDir.FORWARD),
                                               smi)
            if row["profile"]["launch_calls"] < logn:
                raise AssertionError(f"{label}: the profile saw {row['profile']['launch_calls']} "
                                     "launch calls")
        if inverse:
            ilabel = (f"ecntt {cname} 2^{logn} inv" +
                      (f" coset {cfg.coset_gen}" if cfg.coset_gen else ""))
            back = counted(ilabel, lambda: ecntt(cname, y, NTTDir.INVERSE, cfg), launches)
            if launches[ilabel] != dict(zero, ecntt_stage=logn, ecntt_scale=1):
                raise AssertionError(f"{ilabel}: launched {launches[ilabel]}")
            if not _equals_input(g, back, P):
                raise AssertionError(f"{ilabel}: inverse(forward(P)) != P as affine points")
            inv_ms, _ = host_ms(lambda: ecntt(cname, y, NTTDir.INVERSE, cfg), reps=3)
            row.update(inverse_ms=inv_ms, inverse_coset=cfg.coset_gen,
                       inverse_bound_ms=ecntt_transform_bound(
                           g, logn, _stage_rows(cname, logn, True, True, dev),
                           [_scale_rows(cname, n, cfg.coset_gen, True, dev)]))
            log(f"  {ilabel}: {logn} stages + 1 scale, every point back as an affine point; "
                f"inverse {inv_ms:.2f} ms (bound {row['inverse_bound_ms']:.3f} ms) [{smi}]")
            del back
        out[label] = row
        del P, y
        torch.cuda.empty_cache()
    return out


def zq_elements(shape: tuple, gen, dev) -> torch.Tensor:
    """Random canonical Z_q elements as (*shape, 2) int32 limbs on the card,
    the first row 0 and the second q - 1."""
    from icicle_tpu_torch.rings.babykoala import Q
    v = torch.randint(0, Q, shape, generator=gen, device=dev, dtype=torch.int64)
    v[0], v[1] = 0, Q - 1
    return torch.stack([(v & 0xFFFFFFFF).to(torch.int32), (v >> 32).to(torch.int32)], -1)


def rq_ntt_bound(polys: int) -> tuple[float, str]:
    """rq_ntt's least time: each polynomial's 64 words of 8 bytes read and
    written once, against its 256 Montgomery multiplies of 11 32-bit
    products."""
    from icicle_tpu_torch.kernels.rq_ntt_kernel import MONT64_MULS, POLY_MONTS
    return bound(polys * 64 * 8 * 2, polys * POLY_MONTS * MONT64_MULS)


MLKEM_MULS = {"ntt": 7 * 128, "intt": 7 * 128 + 256, "multiply_ntts": 5 * 128}


def mlkem_bound(op: str, polys: int) -> tuple[float, str]:
    """The ring op's least time: its polynomials of 256 int32 read (two for
    the product) and one written, against its multiplies (a butterfly's
    one, the inverse's scale, a pair's five)."""
    reads = 2 if op == "multiply_ntts" else 1
    return bound(polys * 256 * 4 * (reads + 1), polys * MLKEM_MULS[op])


def sponge_bound(batch: int, in_bytes: int, rate: int, out_bytes: int,
                 clock_mhz: float) -> tuple[float, str]:
    """The messages read and the digests written once, against the
    permutations' logic and shift instructions on the ALU pipe."""
    from icicle_tpu_torch.kernels.keccak_kernel import PERMUTATION_OPS, sponge_blocks
    absorb, squeeze = sponge_blocks(in_bytes, rate, out_bytes)
    byte_ms = batch * (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    op_ms = batch * (absorb + squeeze - 1) * PERMUTATION_OPS / alu_ops_per_s(clock_mhz) * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def check_lattice_pqc_kernels(dev, gen, smi: str, clock_mhz: float) -> dict:
    """Each kernel against its plain version on the card, bit-exact, at
    the shapes the paths give it, then timed alone there: rq_ntt forward
    and inverse over L1's 2^16 polynomials (rows of 0 and q - 1), the
    three mlkem ops at ML-KEM-768 2^16 (MLKEM_POLYS; rows of 0 and 3328)
    and icicle_keccak_sponge for every (length, rate, pad, output) ML-KEM
    calls at Q1's batch for it, and a long squeeze (SPONGE_CHECKS), row 0
    also held to hashlib."""
    from icicle_tpu_torch.kernels import keccak_kernel as KK
    from icicle_tpu_torch.kernels import mlkem_kernel as MK
    from icicle_tpu_torch.kernels import rq_ntt_kernel as RK
    from icicle_tpu_torch import NTTDir

    rows = {"rq_ntt": [], "mlkem": [], "keccak_sponge": []}
    x = zq_elements((1 << RQ_POLYS_LOG, 64), gen, dev)
    for d in (NTTDir.FORWARD, NTTDir.INVERSE):
        row = check_against_plain(f"rq_ntt {d.value}", RK.rq_ntt, RK.rq_ntt_ref, (x, d),
                                  rq_ntt_bound(x.shape[0]))
        rows["rq_ntt"].append(dict(row, dir=d.value, polys=x.shape[0]))
        log(f"  rq_ntt {d.value} 2^{RQ_POLYS_LOG} polynomials: exact; kernel "
            f"{row['kernel_ms']:.4f} ms, plain {row['plain_ms']:.1f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}) [{smi}]")
    del x

    for op, fn, ref in (("ntt", MK.mlkem_ntt, MK.ntt_ref), ("intt", MK.mlkem_intt, MK.intt_ref),
                        ("multiply_ntts", MK.mlkem_multiply_ntts, MK.multiply_ntts_ref)):
        polys = MLKEM_POLYS[op]
        args = tuple(torch.randint(0, MK.Q, (polys, 256), generator=gen, device=dev,
                                   dtype=torch.int32)
                     for _ in range(2 if op == "multiply_ntts" else 1))
        args[0][0], args[0][1], args[-1][2] = 0, MK.Q - 1, MK.Q - 1
        row = check_against_plain(f"mlkem {op}", fn, ref, args, mlkem_bound(op, polys))
        rows["mlkem"].append(dict(row, op=op, polys=polys))
        log(f"  mlkem {op} {polys} polynomials: exact; kernel {row['kernel_ms']:.4f} ms, plain "
            f"{row['plain_ms']:.2f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}) "
            f"[{smi}]")
        del args

    for role, log_batch, nbytes, rate, pad, outb in SPONGE_CHECKS:
        data = torch.randint(0, 256, (1 << log_batch, nbytes), generator=gen, device=dev,
                             dtype=torch.uint8)
        row = check_against_plain(f"keccak_sponge {role}", KK.keccak_sponge, KK.keccak_sponge_ref,
                                  (data, rate, pad, outb),
                                  sponge_bound(1 << log_batch, nbytes, rate, outb, clock_mhz))
        hl = {72: hashlib.sha3_512, 136: hashlib.sha3_256 if pad == 0x06 else hashlib.shake_256,
              168: hashlib.shake_128}[rate]
        row0 = bytes(data[0].cpu().numpy())
        digest = hl(row0).digest(outb) if pad == 0x1F else hl(row0).digest()
        if bytes(KK.keccak_sponge(data[:1], rate, pad, outb)[0].cpu().numpy()) != digest:
            raise AssertionError(f"keccak_sponge {role}: row 0 != hashlib")
        rows["keccak_sponge"].append(dict(row, role=role, batch=1 << log_batch, in_bytes=nbytes,
                                          rate=rate, pad=pad, out_bytes=outb))
        log(f"  keccak_sponge {role}: {nbytes} -> {outb} bytes, batch 2^{log_batch}: exact, row 0 "
            f"== hashlib; kernel {row['kernel_ms']:.4f} ms, plain {row['plain_ms']:.1f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}) [{smi}]")
        del data
    return rows


def lattice_paths(dev, gen, smi: str, launches: dict) -> dict:
    """L1: the rings and lattice ops on CUDA tensors. ntt_rns at 2^24
    (forward, inverse: 2 dif_rows a plane a direction, the forward equal to
    _ntt_torch on each plane, the inverse giving the input back);
    negacyclic_ntt over 2^16 R_q polynomials (one rq_ntt a direction, the
    round trip exact, the forward equal to the plain version); rq_matmul of
    (64 x 256) by (256 x 64) R_q matrices (3 rq_ntt), equal to the plain
    version; decompose_balanced / recompose_balanced of 2^22 elements at
    base 2^16 (round trip exact, digits balanced), a JL projection of them
    to JL_ROWS rows (two rows held to a numpy sum on the host) and the
    norm checks (against an exact host sum). Host-clock ms each."""
    from icicle_tpu_torch import NTTConfig, NTTDir
    from icicle_tpu_torch.kernels.rq_ntt_kernel import rq_ntt_ref
    from icicle_tpu_torch.ops import lattice as LT
    from icicle_tpu_torch.ops.mat_ops import rq_matmul
    from icicle_tpu_torch.ops.ntt import _ntt_torch, _rns_plane_fields, ntt_rns
    from icicle_tpu_torch.rings.babykoala import P_BB, P_KB, Q
    from icicle_tpu_torch.rings.rq import NegacyclicNTTConfig, negacyclic_ntt

    out = {}
    zero = dict.fromkeys(kernel_counters(), 0)
    n = 1 << RNS_LOG
    x = torch.stack([torch.randint(0, p, (n,), generator=gen, device=dev, dtype=torch.int32)
                     for p in (P_BB, P_KB)], -1)
    y, z = counted(RNS_MAIN, lambda: (lambda y: (y, ntt_rns(y, NTTDir.INVERSE)))(ntt_rns(x)),
                   launches)
    if launches[RNS_MAIN] != dict(zero, dif_rows=8):
        raise AssertionError(f"{RNS_MAIN}: launched {launches[RNS_MAIN]}, expected 8 dif_rows")
    for i, f in enumerate(_rns_plane_fields()):
        if not torch.equal(y[..., i], _ntt_torch(f, x[..., i].contiguous(), NTTDir.FORWARD,
                                                 NTTConfig())):
            raise AssertionError(f"{RNS_MAIN}: plane {f.name} != _ntt_torch")
    if not torch.equal(z, x):
        raise AssertionError(f"{RNS_MAIN}: inverse(forward(x)) != x")
    fwd_ms, _ = host_ms(lambda: ntt_rns(x))
    inv_ms, _ = host_ms(lambda: ntt_rns(y, NTTDir.INVERSE))
    out[RNS_MAIN] = {"forward_ms": fwd_ms, "inverse_ms": inv_ms}
    log(f"  {RNS_MAIN}: 8 dif_rows, each plane == _ntt_torch, round trip exact; forward "
        f"{fwd_ms:.3f} ms, inverse {inv_ms:.3f} ms [{smi}]")
    del x, y, z

    v = zq_elements((1 << RQ_POLYS_LOG, 64), gen, dev)
    e, back = counted(RQ_MAIN, lambda: (lambda e: (e, negacyclic_ntt(e, NTTDir.INVERSE)))(
        negacyclic_ntt(v)), launches)
    if launches[RQ_MAIN] != dict(zero, rq_ntt=2):
        raise AssertionError(f"{RQ_MAIN}: launched {launches[RQ_MAIN]}, expected 2 rq_ntt")
    if not torch.equal(back, v) or not torch.equal(e, rq_ntt_ref(v, NTTDir.FORWARD)):
        raise AssertionError(f"{RQ_MAIN}: round trip or forward != the plain version")
    fwd_ms, _ = host_ms(lambda: negacyclic_ntt(v))
    inv_ms, _ = host_ms(lambda: negacyclic_ntt(e, NTTDir.INVERSE))
    plain_ms, _ = host_ms(lambda: rq_ntt_ref(v, NTTDir.FORWARD), reps=1)
    out[RQ_MAIN] = {"forward_ms": fwd_ms, "inverse_ms": inv_ms, "plain_forward_ms": plain_ms}
    log(f"  {RQ_MAIN}: 2 rq_ntt, round trip exact, forward == plain; forward {fwd_ms:.3f} ms, "
        f"inverse {inv_ms:.3f} ms (plain forward {plain_ms:.1f} ms) [{smi}]")
    del v, e, back

    nm, mm, km = RQ_MATMUL
    a = zq_elements((nm, mm, 64), gen, dev)
    b = zq_elements((mm, km, 64), gen, dev)
    c = counted(RQ_MATMUL_MAIN, lambda: rq_matmul(a, b), launches)
    if launches[RQ_MATMUL_MAIN] != dict(zero, rq_ntt=3):
        raise AssertionError(f"{RQ_MATMUL_MAIN}: launched {launches[RQ_MATMUL_MAIN]}")
    if not torch.equal(c, rq_matmul(a, b, NegacyclicNTTConfig(backend="torch"))):
        raise AssertionError(f"{RQ_MATMUL_MAIN}: != the plain version")
    ms, _ = host_ms(lambda: rq_matmul(a, b), reps=3)
    out[RQ_MATMUL_MAIN] = {"ms": ms}
    log(f"  {RQ_MATMUL_MAIN}: 3 rq_ntt, == the plain version; {ms:.1f} ms [{smi}]")
    del a, b, c
    torch.cuda.empty_cache()

    m = 1 << LATTICE_LOG
    w = zq_elements((m,), gen, dev)
    label = f"decompose_balanced / recompose_balanced 2^{LATTICE_LOG} base 2^16"
    digits = counted(label, lambda: LT.decompose_balanced(w, LATTICE_BASE), launches)
    nd = LT.compute_nof_digits(LATTICE_BASE)
    dv = LT._to_i64(digits)
    if digits.shape != (nd * m, 2) or bool((torch.minimum(dv, Q - dv) > LATTICE_BASE // 2).any()):
        raise AssertionError(f"{label}: digits not balanced")
    if not torch.equal(LT.recompose_balanced(digits, LATTICE_BASE, m), w):
        raise AssertionError(f"{label}: recompose(decompose(w)) != w")
    dec_ms, _ = host_ms(lambda: LT.decompose_balanced(w, LATTICE_BASE), reps=3)
    rec_ms, _ = host_ms(lambda: LT.recompose_balanced(digits, LATTICE_BASE, m), reps=3)
    seed = b"icicle-lattice-L1"
    t0 = time.perf_counter()
    proj = LT.jl_projection(w, seed, JL_ROWS)
    torch.cuda.synchronize()
    jl_ms = (time.perf_counter() - t0) * 1e3
    vals = LT._to_i64(w).cpu().numpy()
    pieces = [(vals >> (21 * k)) & ((1 << 21) - 1) for k in range(3)]
    for r in (0, JL_ROWS - 1):
        e = LT._jl_entries(seed, r, 1, m)[0]
        total = sum((int(p[e == 1].sum()) - int(p[e == 2].sum())) << (21 * k)
                    for k, p in enumerate(pieces))
        if int(LT._to_i64(proj[r])) != total % Q:
            raise AssertionError(f"JL projection row {r} != the host's sum")
    small = torch.randint(-NORM_MAX, NORM_MAX + 1, (m,), generator=gen, device=dev,
                          dtype=torch.int64)
    sq = int((small.cpu().numpy().astype(np.int64) ** 2).sum())
    linf = int(small.abs().max())
    sv = LT._from_i64(torch.where(small < 0, small + Q, small))
    t0 = time.perf_counter()
    checks = [LT.check_norm_bound(sv, LT.NormType.L2, math.isqrt(sq) + 1),
              not LT.check_norm_bound(sv, LT.NormType.L2, math.isqrt(sq)),
              LT.check_norm_bound(sv, LT.NormType.LInfinity, linf + 1),
              not LT.check_norm_bound(sv, LT.NormType.LInfinity, linf)]
    norm_ms = (time.perf_counter() - t0) * 1e3 / 4
    if not all(checks):
        raise AssertionError(f"norm checks at 2^{LATTICE_LOG}: {checks}")
    out[label] = {"digits": nd, "decompose_ms": dec_ms, "recompose_ms": rec_ms,
                  "jl_rows": JL_ROWS, "jl_projection_ms": jl_ms, "norm_check_ms": norm_ms}
    log(f"  {label}: {nd} digits, balanced, round trip exact; decompose {dec_ms:.2f} ms, "
        f"recompose {rec_ms:.2f} ms; JL projection to {JL_ROWS} rows {jl_ms:.0f} ms (host "
        f"Keccak-512 seed expansion), two rows == the host's sum; L2 and L-inf norm checks at "
        f"their bounds, {norm_ms:.2f} ms each [{smi}]")
    return out


def mlkem_expected(op: str, k: int) -> dict:
    """Kernel launches of one batched ML-KEM op at module rank k: sponges
    (G, H, J, the PRFs, the k^2 matrix XOFs) and ring ops."""
    enc = {"keccak_sponge": k * k + 2 * k + 1, "mlkem_ntt": 1, "mlkem_multiply_ntts": 2,
           "mlkem_intt": 2}
    if op == "keygen":
        return {"keccak_sponge": k * k + 2 * k + 2, "mlkem_ntt": 2, "mlkem_multiply_ntts": 1}
    if op == "encaps":
        return dict(enc, keccak_sponge=enc["keccak_sponge"] + 2)
    return {"keccak_sponge": enc["keccak_sponge"] + 2, "mlkem_ntt": 2, "mlkem_multiply_ntts": 3,
            "mlkem_intt": 3}


def ml_kem_paths(dev, smi: str, launches: dict) -> dict:
    """Q1: batched ML-KEM on CUDA tensors: ML-KEM-768 at a batch of 2^16,
    ML-KEM-512 and ML-KEM-1024 at 2^12. keygen, encaps and decaps each
    counted (mlkem_expected); every decapsulated secret equals the
    encapsulated one; a batch with one bit of every ciphertext flipped
    decapsulates to the implicit-rejection secret; MLKEM_SAMPLES items of
    each step equal the host oracle (ops/pqc/ml_kem.py, hashlib) byte for
    byte; host-clock ms an operation batch, per operation and operations/s."""
    from icicle_tpu_torch.ops.pqc import ml_kem as H
    from icicle_tpu_torch.ops.pqc import ml_kem_tpu as D

    out = {}
    zero = dict.fromkeys(kernel_counters(), 0)
    for cat, log_b in MLKEM_CASES:
        B = 1 << log_b
        k = H.PARAMS[cat].k
        rng = np.random.default_rng(int(cat))
        ent = torch.from_numpy(rng.integers(0, 256, (B, 64), dtype=np.uint8)).to(dev)
        msg = torch.from_numpy(rng.integers(0, 256, (B, 32), dtype=np.uint8)).to(dev)
        base = f"ml-kem-{cat} 2^{log_b}"
        ek, dk = counted(f"{base} keygen", lambda: D.keygen(cat, ent), launches)
        c, K = counted(f"{base} encaps", lambda: D.encaps(cat, msg, ek), launches)
        K2 = counted(f"{base} decaps", lambda: D.decaps(cat, c, dk), launches)
        for op in ("keygen", "encaps", "decaps"):
            if launches[f"{base} {op}"] != dict(zero, **mlkem_expected(op, k)):
                raise AssertionError(f"{base} {op}: launched {launches[f'{base} {op}']}")
        if not torch.equal(K2, K):
            raise AssertionError(f"{base}: a decapsulated secret != the encapsulated one")
        bad = c.clone()
        bad[:, 0] ^= 1
        Kb = D.decaps(cat, bad, dk)
        if bool((Kb == K).all(1).any()):
            raise AssertionError(f"{base}: a tampered ciphertext gave the true secret")
        idx = torch.arange(MLKEM_SAMPLES, device=dev) * (B // MLKEM_SAMPLES)
        host = lambda t: t.index_select(0, idx).cpu().numpy()
        ekh, dkh = H.keygen(cat, host(ent))
        ch, Kh = H.encaps(cat, host(msg), ekh)
        for what, got, want in (("ek", ek, ekh), ("dk", dk, dkh), ("c", c, ch), ("K", K, Kh),
                                ("decaps K", K2, H.decaps(cat, ch, dkh)),
                                ("rejection K", Kb, H.decaps(cat, host(bad), dkh))):
            if not np.array_equal(host(got), want):
                raise AssertionError(f"{base}: {what} != the host oracle on sampled items")
        row = {"batch": B}
        for op, fn in (("keygen", lambda: D.keygen(cat, ent)),
                       ("encaps", lambda: D.encaps(cat, msg, ek)),
                       ("decaps", lambda: D.decaps(cat, c, dk))):
            ms, _ = host_ms(fn, reps=3)
            row[op] = {"ms": ms, "us_per_op": ms * 1e3 / B, "ops_per_s": B / (ms * 1e-3)}
        out[base] = row
        log(f"  {base}: launches as expected, every secret decapsulated, tampered ciphertexts "
            f"rejected, {MLKEM_SAMPLES} items == the host oracle; " + ", ".join(
                f"{op} {row[op]['ms']:.2f} ms ({row[op]['ops_per_s']:.4g}/s)"
                for op in ("keygen", "encaps", "decaps")) + f" [{smi}]")
        del ent, msg, ek, dk, c, K, K2, bad, Kb
        torch.cuda.empty_cache()
    return out


# -- multi-device, the stream pipeline and the C ABI (S1-S7) ---------------------

S_NTT_LOG = 26                 # S1, S5: babybear 2^26, as the NTT main path
S_MSM_LOG = 24                 # S2, S5: bn254 2^24 with bench.py's inputs
S_V1_LOG = 20                  # S3: v1 at 2^20
S_STREAM_LOG, S_STREAM_CHUNKS = 22, 16   # S6: 16 chunks of 2^22
S_CAPI_MSM_LOG = 22            # S7: icicle_tpu_msm, cut from 2^24: its C copies took S7 past 30 s
S_CAPI_MERKLE_LOG = 24         # S7: icicle_tpu_merkle_build's leaves
S_CAPI_MLKEM = ("768", 12)     # S7: ML-KEM-768, a batch of 2^12
S_CAPI_DECOMPOSE = (1 << 20, 1 << 16)    # S7: lattice_decompose of 2^20 elements, base 2^16
S_PROOF_LEAVES = (0, (1 << 28) + 5, (1 << MERKLE_LOG) - 1)
S1_MAIN = f"ntt_sharded babybear 2^{S_NTT_LOG} fwd+inv, normalize True and False"
S2_MAIN = f"msm_sharded3 bn254 2^{S_MSM_LOG}"
S3_MAIN = f"msm_sharded (v1) bn254 2^{S_V1_LOG}"
S3_12_LOG = 16                 # S3 over bls12_381 (12 limbs)
S3_12 = f"msm_sharded (v1) bls12_381 2^{S3_12_LOG}"
S4_MAIN = f"merkle_build_sharded babybear poseidon2 t=2 2^{MERKLE_LOG}"
S5_MAIN = {"ntt": f"ntt_sharded_2level babybear 2^{S_NTT_LOG} fwd+inv (ntt_sharded, 2-D mesh)",
           "msm": f"msm_sharded3_2level bn254 2^{S_MSM_LOG}",
           "merkle": f"merkle_build_sharded_2level babybear 2^{MERKLE_LOG}"}
S6_MAIN = f"stream_map ntt babybear {S_STREAM_CHUNKS} x 2^{S_STREAM_LOG}"
S7_MAIN = {"ntt": f"C ABI icicle_tpu_ntt babybear 2^{S_NTT_LOG}",
           "msm": f"C ABI icicle_tpu_msm bn254 2^{S_CAPI_MSM_LOG}",
           "merkle": f"C ABI icicle_tpu_merkle_build babybear 2^{S_CAPI_MERKLE_LOG}",
           "keygen": f"C ABI icicle_tpu_mlkem_keygen {S_CAPI_MLKEM[0]} 2^{S_CAPI_MLKEM[1]}",
           "encaps": f"C ABI icicle_tpu_mlkem_encaps {S_CAPI_MLKEM[0]} 2^{S_CAPI_MLKEM[1]}",
           "decaps": f"C ABI icicle_tpu_mlkem_decaps {S_CAPI_MLKEM[0]} 2^{S_CAPI_MLKEM[1]}",
           "decompose": "C ABI icicle_tpu_lattice_decompose 2^20 base 2^16"}


def only(counts: dict) -> dict:
    """A launch count's nonzero entries."""
    return {k: v for k, v in counts.items() if v}


def bench_msm_inputs(n: int, seed: int, dev):
    """bench.py's MSM inputs (bench.py:48-59): (n, 8) uint32 scalars of
    bench_scalars, one repeated point P on the card; and the oracle."""
    from icicle_tpu_torch import get_curve
    from icicle_tpu_torch.curves.host_ec import ec_mul
    curve = get_curve("bn254")
    fr, fq = curve.fr, curve.fq
    P = ec_mul((curve.gen_x, curve.gen_y), 0xDEADBEEF, fq.modulus)
    scal = bench_scalars(np.random.default_rng(seed), n)
    total = sum(int(np.sum(scal[:, limb], dtype=np.uint64)) << (32 * limb)
                for limb in range(8)) % fr.modulus
    px = fq.from_ints([P[0]], dev).expand(n, fq.nlimbs)
    py = fq.from_ints([P[1]], dev).expand(n, fq.nlimbs)
    return scal, px, py, ec_mul(P, total, fq.modulus)


def sharded_paths(dev, smi: str, launches: dict, merkle_root: int) -> dict:
    """S1-S5 on this rank's card, over a mesh of every rank of the process
    group: the sharded NTT, both sharded MSMs, the sharded Merkle build and
    the three two-level functions, each counted and held to the single-card
    answer; ms beside the single-card path's."""
    from icicle_tpu_torch import (MerkleTree, NTTConfig, NTTDir, Poseidon2, get_curve,
                                  get_field, msm_affine, ntt)
    from icicle_tpu_torch.curves.host_ec import ec_mul
    from icicle_tpu_torch.ops import ntt as N
    from icicle_tpu_torch.ops.merkle import MerkleProof
    from icicle_tpu_torch.parallel import two_level as TL
    from icicle_tpu_torch.parallel.merkle_sharded import merkle_build_sharded
    from icicle_tpu_torch.parallel.mesh import flat_rank, make_mesh
    from icicle_tpu_torch.parallel.msm_sharded import msm_sharded, msm_sharded3
    from icicle_tpu_torch.parallel.ntt_sharded import ntt_sharded

    mesh = make_mesh()
    pos, d = flat_rank(mesh)
    mesh2 = TL.make_mesh2(1, d)
    zero = dict.fromkeys(kernel_counters(), 0)
    out = {"devices": d, "rank": pos}

    # S1 / S5 NTT: every rank passes the global vector; the answers are the
    # rank's blocks of the single-card NTT's, which is held to the plain
    # version (_ntt_torch) on the card
    f = get_field("babybear")
    n = 1 << S_NTT_LOG
    n1, n2 = 1 << (S_NTT_LOG // 2), 1 << (S_NTT_LOG - S_NTT_LOG // 2)
    x = torch.from_numpy(np.random.default_rng(26).integers(0, f.modulus, n, dtype=np.uint32)
                         .view(np.int32)).to(dev)
    y = ntt(f, x, NTTDir.FORWARD)
    if not torch.equal(y, N._ntt_torch(f, x, NTTDir.FORWARD, NTTConfig())):
        raise AssertionError(f"babybear 2^{S_NTT_LOG}: the single-card ntt != _ntt_torch")
    block = slice(pos * n // d, (pos + 1) * n // d)
    rows = slice(pos * n1 // d, (pos + 1) * n1 // d)
    knm = y.view(n2, n1).T[rows]
    want_inv_knm = x.view(n2, n1).T[rows]
    single_ms, _ = host_ms(lambda: ntt(f, x, NTTDir.FORWARD))
    fwd, fwd_knm, inv, inv_knm = counted(S1_MAIN, lambda: (
        ntt_sharded(f, x, mesh, NTTDir.FORWARD),
        ntt_sharded(f, x, mesh, NTTDir.FORWARD, normalize=False),
        ntt_sharded(f, y, mesh, NTTDir.INVERSE),
        ntt_sharded(f, y, mesh, NTTDir.INVERSE, normalize=False)), launches)
    # ntt_sharded_2level is ntt_sharded: S5 runs it once each way on the
    # (1, d) mesh, whose flattened group the all_to_all takes
    fwd2, inv2 = counted(S5_MAIN["ntt"], lambda: (
        TL.ntt_sharded_2level(f, x, mesh2, NTTDir.FORWARD),
        TL.ntt_sharded_2level(f, y, mesh2, NTTDir.INVERSE)), launches)
    for label, calls, checks in (
            (S1_MAIN, 4, (("forward", fwd, y[block]), ("forward kNM", fwd_knm, knm),
                          ("inverse", inv, x[block]), ("inverse kNM", inv_knm, want_inv_knm))),
            (S5_MAIN["ntt"], 2, (("forward", fwd2, y[block]), ("inverse", inv2, x[block])))):
        if launches[label] != dict(zero, dif_rows=2 * calls):
            raise AssertionError(f"{label}: launched {only(launches[label])}, expected "
                                 f"{2 * calls} dif_rows (two a rank an NTT) and nothing else")
        for what, got, want in checks:
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"{label}: {what} != the single-card ntt's block")
    ms, _ = host_ms(lambda: ntt_sharded(f, x, mesh, NTTDir.FORWARD))
    out[S1_MAIN] = {"ms": ms, "single_card_ms": single_ms, "launches": only(launches[S1_MAIN])}
    out[S5_MAIN["ntt"]] = {"launches": only(launches[S5_MAIN["ntt"]])}
    log(f"  {S1_MAIN}: forward, inverse, kNM == the single-card ntt (== _ntt_torch) bit for "
        f"bit, 2 dif_rows a rank an NTT; forward {ms:.3f} ms against the single-card ntt's "
        f"{single_ms:.3f} ms on {d} device(s) [{smi}]")
    log(f"  {S5_MAIN['ntt']}: forward and inverse == the single-card ntt's block, 2 dif_rows a "
        f"rank an NTT (the code S1 timed) [{smi}]")
    del x, y, knm, want_inv_knm, fwd, fwd_knm, inv, inv_knm, fwd2, inv2
    torch.cuda.empty_cache()

    # S2 / S5 MSM (v3) and S3 (v1): bench.py's inputs, (sum of scalars) P
    n = 1 << S_MSM_LOG
    scal, px, py, want = bench_msm_inputs(n, 0, dev)
    s = torch.from_numpy(scal.view(np.int32)).to(dev)
    single_ms, single = host_ms(lambda: msm_affine("bn254", s, px, py), reps=2)
    if single != want:
        raise AssertionError(f"msm_affine bn254 2^{S_MSM_LOG}: {single} != oracle {want}")
    for label, fn in ((S2_MAIN, lambda: msm_sharded3("bn254", s, px, py, mesh)),
                      (S5_MAIN["msm"], lambda: TL.msm_sharded3_2level("bn254", s, px, py, mesh2))):
        got = counted(label, fn, launches)
        expect = expected_launches("u32", n // d)
        if launches[label] != expect or got != want:
            raise AssertionError(f"{label}: launched {only(launches[label])} (the per-shard "
                                 f"plan's {only(expect)}), result {got} (oracle {want})")
        ms, last = timed_ms(fn, reps=2)
        if last != want:
            raise AssertionError(f"{label}: timed result {last} != the oracle {want}")
        out[label] = {"ms": ms, "single_card_msm_affine_ms": single_ms,
                      "launches": only(launches[label])}
        log(f"  {label}: == oracle, launches {only(launches[label])} (the per-shard plan's); "
            f"{ms:.1f} ms against msm_affine (u32) {single_ms:.1f} ms [{smi}]")
    del s, px, py
    torch.cuda.empty_cache()
    n = 1 << S_V1_LOG
    scal, px, py, want = bench_msm_inputs(n, 2, dev)
    s = torch.from_numpy(scal.view(np.int32)).to(dev)
    got = counted(S3_MAIN, lambda: msm_sharded("bn254", s, px, py, mesh), launches)
    if launches[S3_MAIN] != expected_launches("v1", n // d) or got != want:
        raise AssertionError(f"{S3_MAIN}: launched {only(launches[S3_MAIN])}, result {got} "
                             f"(oracle {want})")
    out[S3_MAIN] = {"launches": only(launches[S3_MAIN])}
    log(f"  {S3_MAIN}: == oracle, launches {only(launches[S3_MAIN])} [{smi}]")
    del s, px, py
    # S3 over a 12-limb curve: bls12_381, canonical scalars, one repeated point
    n = 1 << S3_12_LOG
    c381 = get_curve("bls12_381")
    P = ec_mul((c381.gen_x, c381.gen_y), 0x5381, c381.fq.modulus)
    scal = canonical_scalars(np.random.default_rng(27), (n,), c381.fr)
    s = torch.from_numpy(scal.view(np.int32)).to(dev)
    px = c381.fq.from_ints([P[0]], dev).expand(n, c381.fq.nlimbs).contiguous()
    py = c381.fq.from_ints([P[1]], dev).expand(n, c381.fq.nlimbs).contiguous()
    want = ec_mul(P, weighted_total(scal, c381.fr.modulus), c381.fq.modulus)
    got = counted(S3_12, lambda: msm_sharded("bls12_381", s, px, py, mesh), launches)
    if launches[S3_12] != expected_launches("v1", n // d, "bls12_381") or got != want:
        raise AssertionError(f"{S3_12}: launched {only(launches[S3_12])}, result {got} "
                             f"(oracle {want})")
    out[S3_12] = {"launches": only(launches[S3_12])}
    log(f"  {S3_12}: == oracle, launches {only(launches[S3_12])} (B7's 12-limb instance) "
        f"[{smi}]")
    del s, px, py

    # S4 / S5 Merkle: bench.py's 2^29 leaves, the Merkle phase's root
    f = get_field("babybear")
    n = 1 << MERKLE_LOG
    leaves = torch.from_numpy(np.random.default_rng(0).integers(0, f.modulus, size=(n,),
                                                                dtype=np.uint32)
                              .view(np.int32)).to(dev)
    h = Poseidon2(f, 2)
    for label, fn in ((S4_MAIN, merkle_build_sharded),
                      (S5_MAIN["merkle"], TL.merkle_build_sharded_2level)):
        m = mesh if fn is merkle_build_sharded else mesh2
        tree = MerkleTree([h] * MERKLE_LOG, leaf_words=1)
        root = counted(label, lambda: fn(tree, leaves, m), launches)
        expect = dict(zero, poseidon2=MERKLE_LOG)
        if launches[label] != expect or int(root[0]) != merkle_root:
            raise AssertionError(f"{label}: launched {only(launches[label])} (expected "
                                 f"{MERKLE_LOG} poseidon2), root {int(root[0])} (the single-card "
                                 f"build's {merkle_root})")
        proved = []
        for idx in S_PROOF_LEAVES:
            if idx // (n // d) != pos:
                continue    # another rank's leaf
            proof = tree.get_merkle_proof(leaves, idx)
            bad = MerkleProof(proof.leaf ^ 1, idx, proof.root, proof.path, True)
            fresh = MerkleTree([h] * MERKLE_LOG, leaf_words=1)
            if not (tree.verify(proof) and fresh.verify(proof)) or tree.verify(bad):
                raise AssertionError(f"{label}: the proof of leaf {idx} does not verify, or "
                                     "verifies flipped")
            proved.append(idx)
        ms, _ = timed_ms(lambda: fn(tree, leaves, m), reps=3)
        out[label] = {"ms": ms, "proved_leaves": proved, "launches": only(launches[label])}
        log(f"  {label}: root == the single-card build's, {MERKLE_LOG} poseidon2 launches; "
            f"proofs of leaves {proved} verify (and fail flipped); build {ms:.3f} ms [{smi}]")
        tree.layers = []
    del leaves
    torch.cuda.empty_cache()
    return out


def _intervals_overlap(spans: list, cover: list) -> float:
    """Total length of `spans` that lies inside the union of `cover`."""
    union = []
    for a, b in sorted(cover):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    return sum(max(0.0, min(b, ub) - max(a, ua)) for a, b in spans for ua, ub in union)


def stream_path(dev, smi: str, launches: dict) -> dict:
    """S6: stream_map of a babybear forward NTT over S_STREAM_CHUNKS chunks
    of 2^S_STREAM_LOG from pinned host memory, equal to per-chunk ntt; a
    torch.profiler breakdown of one run: H2D, kernel and D2H time, the share
    of copy time that overlaps kernels, beside the serial sum."""
    from icicle_tpu_torch import NTTConfig, NTTDir, get_field, ntt, stream_map
    from icicle_tpu_torch.ops import ntt as N

    f = get_field("babybear")
    n = 1 << S_STREAM_LOG
    rng = np.random.default_rng(22)
    chunks = [torch.from_numpy(rng.integers(0, f.modulus, n, dtype=np.uint32).view(np.int32))
              .pin_memory() for _ in range(S_STREAM_CHUNKS)]

    def run():
        return list(stream_map(lambda x: ntt(f, x, NTTDir.FORWARD), chunks, device=dev))

    outs = counted(S6_MAIN, run, launches)
    if launches[S6_MAIN] != dict(dict.fromkeys(kernel_counters(), 0),
                                 dif_rows=2 * S_STREAM_CHUNKS):
        raise AssertionError(f"{S6_MAIN}: launched {only(launches[S6_MAIN])}")
    for i, (c, o) in enumerate(zip(chunks, outs)):
        want = N._ntt_torch(f, c.to(dev), NTTDir.FORWARD, NTTConfig())
        if not np.array_equal(o, want.cpu().numpy()):
            raise AssertionError(f"{S6_MAIN}: chunk {i} != the plain ntt (_ntt_torch) of the "
                                 "chunk")
    ms, _ = host_ms(run, reps=3)
    row = {"ms": ms, "chunks": S_STREAM_CHUNKS, "chunk_elements": n}
    for tries in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=list(PROFILE_ACTIVITIES)) as prof:
            time.sleep(PROFILE_PAD_S * 2 ** tries)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(PROFILE_PAD_S * 2 ** tries)
        spans = {"h2d": [], "d2h": [], "kernel": []}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            kind = ("h2d" if "HtoD" in e.name else "d2h" if "DtoH" in e.name
                    else None if e.name.startswith(("Memcpy", "Memset")) else "kernel")
            if kind:
                spans[kind].append((e.time_range.start / 1e3, e.time_range.end / 1e3))
        complete = all(len(spans[k]) >= (2 if k == "kernel" else 1) * S_STREAM_CHUNKS
                       for k in spans)
        if complete:
            break
    busy = {k: sum(b - a for a, b in v) for k, v in spans.items()}
    copies = spans["h2d"] + spans["d2h"]
    copy_ms = busy["h2d"] + busy["d2h"]
    overlap = _intervals_overlap(copies, spans["kernel"]) / copy_ms if copy_ms else 0.0
    row.update(profile_wall_ms=wall_ms, h2d_ms=busy["h2d"], kernel_ms=busy["kernel"],
               d2h_ms=busy["d2h"], serial_sum_ms=sum(busy.values()),
               copy_overlapping_kernels=overlap,
               h2d_overlapping_d2h=_intervals_overlap(spans["h2d"], spans["d2h"]) / busy["h2d"]
               if busy["h2d"] else 0.0,
               kept={k: len(v) for k, v in spans.items()}, complete=complete)
    log(f"  {S6_MAIN}: == per-chunk _ntt_torch, {2 * S_STREAM_CHUNKS} dif_rows; {ms:.2f} ms a "
        f"run; "
        f"profiled: H2D {busy['h2d']:.3f}, kernels {busy['kernel']:.3f}, D2H {busy['d2h']:.3f} ms "
        f"(serial sum {row['serial_sum_ms']:.3f}) in {wall_ms:.3f} ms; share of copy time "
        f"overlapping kernels {overlap:.3f}, of H2D time overlapping D2H "
        f"{row['h2d_overlapping_d2h']:.3f}{'' if complete else ' (kept activities only)'} [{smi}]")
    return row


def capi_paths(dev, smi: str, launches: dict) -> dict:
    """S7: the C ABI over the port, loaded with ctypes into this process
    (its embedded runtime is this interpreter): icicle_tpu_init(NULL), then
    the NTT, the MSM, a Merkle build, ML-KEM and a decomposition, each
    counted, bit-equal to the port's Python entry point on the card, its C
    call timed beside the entry point on the card (the difference is the
    byte marshalling); the NTT and the Merkle root also equal to the plain
    versions on the card; then the port's C example program in a
    subprocess."""
    import ctypes as C

    from icicle_tpu_torch import (MerkleTree, MerkleTreeConfig, NTTConfig, NTTDir, Poseidon2,
                                  get_field, msm_affine, ntt)
    from icicle_tpu_torch.capi import build as capi_build
    from icicle_tpu_torch.ops import ntt as N
    from icicle_tpu_torch.ops.lattice import decompose_balanced
    from icicle_tpu_torch.ops.pqc import decaps, encaps, keygen
    from icicle_tpu_torch.ops.pqc.ml_kem import PARAMS

    t0 = time.perf_counter()
    path = capi_build.build_library()
    build_s = time.perf_counter() - t0
    lib = C.CDLL(path)
    P = C.c_void_p
    sz = C.c_size_t
    lib.icicle_tpu_init.argtypes = [C.c_char_p]
    lib.icicle_tpu_last_error.restype = C.c_char_p
    lib.icicle_tpu_ntt.argtypes = [C.c_char_p, P, sz, C.c_int, P]
    lib.icicle_tpu_msm.argtypes = [C.c_char_p, P, P, P, sz, P]
    lib.icicle_tpu_merkle_build.argtypes = [C.c_char_p, P, sz, P]
    lib.icicle_tpu_mlkem_keygen.argtypes = [C.c_char_p, P, sz, P, P]
    lib.icicle_tpu_mlkem_encaps.argtypes = [C.c_char_p, P, P, sz, P, P]
    lib.icicle_tpu_mlkem_decaps.argtypes = [C.c_char_p, P, P, sz, P]
    lib.icicle_tpu_lattice_decompose.argtypes = [P, sz, C.c_uint32, sz, P]
    for fn in (lib.icicle_tpu_init, lib.icicle_tpu_ntt, lib.icicle_tpu_msm,
               lib.icicle_tpu_merkle_build, lib.icicle_tpu_mlkem_keygen,
               lib.icicle_tpu_mlkem_encaps, lib.icicle_tpu_mlkem_decaps,
               lib.icicle_tpu_lattice_decompose):
        fn.restype = C.c_int
    if lib.icicle_tpu_init(None) != 0:
        raise AssertionError(f"icicle_tpu_init(NULL): {lib.icicle_tpu_last_error().decode()}")
    ptr = lambda a: a.ctypes.data_as(P)
    zero = dict.fromkeys(kernel_counters(), 0)
    out = {"library_build_s": build_s}

    def call(key: str, fn, entry, expect: dict, same) -> None:
        """fn() through the C ABI, counted and checked against expect and
        same(); timed beside entry() on the card."""
        label = S7_MAIN[key]
        rc = counted(label, fn, launches)
        if rc != 0:
            raise AssertionError(f"{label}: rc {rc}: {lib.icicle_tpu_last_error().decode()}")
        if launches[label] != dict(zero, **expect):
            raise AssertionError(f"{label}: launched {only(launches[label])}, expected "
                                 f"{only(expect)}")
        if not same():
            raise AssertionError(f"{label}: != the port's Python entry point on the card")
        c_ms, _ = timed_ms(fn)       # the counted call and same() warmed both up
        entry_ms, _ = timed_ms(entry)
        out[label] = {"c_call_ms": c_ms, "entry_ms": entry_ms,
                      "marshalling_ms": c_ms - entry_ms, "launches": only(launches[label])}
        log(f"  {label}: == the Python entry point, launches {only(launches[label])}; C call "
            f"{c_ms:.1f} ms, entry point on the card {entry_ms:.1f} ms, marshalling "
            f"{c_ms - entry_ms:.1f} ms [{smi}]")

    f = get_field("babybear")
    n = 1 << S_NTT_LOG
    x = np.random.default_rng(27).integers(0, f.modulus, n, dtype=np.uint32)
    got = np.empty_like(x)
    x_dev = torch.from_numpy(x.view(np.int32)).to(dev)
    call("ntt", lambda: lib.icicle_tpu_ntt(b"babybear", ptr(x), n, 0, ptr(got)),
         lambda: ntt(f, x_dev, NTTDir.FORWARD), {"dif_rows": 2},
         lambda: np.array_equal(got.view(np.int32), ntt(f, x_dev).cpu().numpy())
         and np.array_equal(got.view(np.int32),
                            N._ntt_torch(f, x_dev, NTTDir.FORWARD, NTTConfig()).cpu().numpy()))
    del x, got, x_dev

    n = 1 << S_CAPI_MSM_LOG
    s_np, px, py, want = bench_msm_inputs(n, 0, dev)
    s = torch.from_numpy(s_np.view(np.int32)).to(dev)
    x_np, y_np = (t.contiguous().cpu().numpy().view(np.uint32) for t in (px, py))
    res = np.zeros(16, dtype=np.uint32)
    words = lambda v: [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    call("msm", lambda: lib.icicle_tpu_msm(b"bn254", ptr(s_np), ptr(x_np), ptr(y_np), n,
                                           ptr(res)),
         lambda: msm_affine("bn254", s, px, py), only(expected_launches("u32", n)),
         lambda: res.tolist() == words(want[0]) + words(want[1])
         and msm_affine("bn254", s, px, py) == want)
    del s, px, py, s_np, x_np, y_np

    n = 1 << S_CAPI_MERKLE_LOG
    leaves = np.random.default_rng(24).integers(0, f.modulus, n, dtype=np.uint32)
    leaves_dev = torch.from_numpy(leaves.view(np.int32)).to(dev)
    root = np.zeros(1, dtype=np.uint32)
    tree = MerkleTree([Poseidon2(f, 2)] * S_CAPI_MERKLE_LOG, leaf_words=1)
    plain_root = MerkleTree([Poseidon2(f, 2)] * S_CAPI_MERKLE_LOG, leaf_words=1).build(
        leaves_dev, MerkleTreeConfig(backend="torch"))     # the plain version on the card
    call("merkle", lambda: lib.icicle_tpu_merkle_build(b"babybear", ptr(leaves), n, ptr(root)),
         lambda: tree.build(leaves_dev), {"poseidon2": S_CAPI_MERKLE_LOG},
         lambda: np.array_equal(root, tree.build(leaves_dev))
         and np.array_equal(root, plain_root))
    del leaves, leaves_dev
    tree.layers = []

    cat, log_b = S_CAPI_MLKEM
    B = 1 << log_b
    p = PARAMS[cat]
    rng = np.random.default_rng(768)
    ent = rng.integers(0, 256, (B, 64), dtype=np.uint8)
    msg = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    ek, dk = np.zeros((B, p.ek_bytes), np.uint8), np.zeros((B, p.dk_bytes), np.uint8)
    ct, ss, ss2 = (np.zeros((B, p.ct_bytes), np.uint8), np.zeros((B, 32), np.uint8),
                   np.zeros((B, 32), np.uint8))
    ent_d, msg_d = torch.from_numpy(ent).to(dev), torch.from_numpy(msg).to(dev)
    ek_d, dk_d = keygen(cat, ent_d)
    ct_d, ss_d = encaps(cat, msg_d, ek_d)
    host = lambda t: t.cpu().numpy()
    cb = cat.encode()
    call("keygen", lambda: lib.icicle_tpu_mlkem_keygen(cb, ptr(ent), B, ptr(ek), ptr(dk)),
         lambda: keygen(cat, ent_d), mlkem_expected("keygen", p.k),
         lambda: np.array_equal(ek, host(ek_d)) and np.array_equal(dk, host(dk_d)))
    call("encaps", lambda: lib.icicle_tpu_mlkem_encaps(cb, ptr(msg), ptr(ek), B, ptr(ct),
                                                       ptr(ss)),
         lambda: encaps(cat, msg_d, ek_d), mlkem_expected("encaps", p.k),
         lambda: np.array_equal(ct, host(ct_d)) and np.array_equal(ss, host(ss_d)))
    call("decaps", lambda: lib.icicle_tpu_mlkem_decaps(cb, ptr(ct), ptr(dk), B, ptr(ss2)),
         lambda: decaps(cat, ct_d, dk_d), mlkem_expected("decaps", p.k),
         lambda: np.array_equal(ss2, ss) and np.array_equal(ss2, host(decaps(cat, ct_d, dk_d))))

    n, base = S_CAPI_DECOMPOSE
    zq = np.random.default_rng(16).integers(0, 1 << 31, (n, 2), dtype=np.uint32)
    zq[:, 1] = 0
    zq_d = torch.from_numpy(zq.view(np.int32)).to(dev)
    nd = int(decompose_balanced(zq_d[:1], base).shape[0])
    digits = np.zeros((nd * n, 2), dtype=np.uint32)
    call("decompose", lambda: lib.icicle_tpu_lattice_decompose(ptr(zq), n, base, nd,
                                                               ptr(digits)),
         lambda: decompose_balanced(zq_d, base, nd), {},
         lambda: np.array_equal(digits.view(np.int32),
                                decompose_balanced(zq_d, base, nd).cpu().numpy()))
    torch.cuda.empty_cache()

    # the port's own C example program, a C program in a subprocess: init(NULL), an
    # NTT round trip at 2^20 and the MSM 5G check
    t0 = time.perf_counter()
    example = capi_build.build_program(capi_build.EXAMPLE_SOURCE, capi_build.EXAMPLE)
    run = subprocess.run([example, "default", "20"], capture_output=True, text=True,
                         timeout=600)
    example_s = time.perf_counter() - t0
    if run.returncode != 0 or "C EXAMPLE OK" not in run.stdout:
        raise AssertionError(f"the C example program failed (rc {run.returncode}): "
                             f"{run.stdout[-1500:]} {run.stderr[-1500:]}")
    for line in run.stdout.splitlines():
        log(f"  C example program: {line}")
    out["c_example"] = {"s": example_s, "stdout": run.stdout.splitlines()}
    return out


def _sharded_rank(rank: int, world: int, init_method: str, merkle_root: int, out_path: str,
                  smi: str) -> None:
    """One rank of S1-S5 on a host with more than one card (spawned)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.distributed as dist

    from icicle_tpu_torch.parallel.mesh import init_mesh_process

    dev = init_mesh_process(rank, world, "cuda", init_method)
    try:
        launches = {}
        res = sharded_paths(dev, smi, launches, merkle_root)
        if rank == 0:
            with open(out_path, "w") as fh:
                json.dump({"result": res, "launches": launches}, fh)
    finally:
        dist.destroy_process_group()


def multi_device_paths(dev, smi: str, launches: dict, merkle_root: int) -> dict:
    """S1-S5 over every visible card: one card is a world of one NCCL rank
    in this process (its launch counters are this process's); more cards
    are a spawned rank a card, rank 0's counts and results reported."""
    import socket
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from icicle_tpu_torch.parallel.mesh import init_mesh_process

    world = torch.cuda.device_count()
    if world == 1:
        init_mesh_process(0, 1, dev)
        try:
            return sharded_paths(dev, smi, launches, merkle_root)
        finally:
            dist.destroy_process_group()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        mp.start_processes(_sharded_rank, args=(world, f"tcp://localhost:{port}", merkle_root,
                                                out_path, smi),
                           nprocs=world, start_method="spawn")
        with open(out_path) as fh:
            got = json.load(fh)
    launches.update(got["launches"])
    return got["result"]


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


def sass_counts():
    """The SASS instruction counts chip_smoke.py reports: the babybear t = 2
    single-permutation Poseidon2 kernel's (its count per hash), the
    Keccak-256 word-row kernel's, and the BLAKE kernels' (BLAKE_SASS)."""
    from icicle_tpu_torch.kernels import build, sass

    def one(lib: str, pattern: str) -> dict:
        found = sass.kernel_counts(build.lib_path(lib), pattern)
        if len(found) != 1:
            raise AssertionError(f"lib{lib}: {len(found)} kernels match {pattern}")
        return next(iter(found.values()))["counts"]

    return (one("poseidon2", P2_SASS_KERNEL), one("keccak", KECCAK_SASS_KERNEL),
            {pattern: one(lib, pattern) for lib, pattern in BLAKE_SASS})


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from icicle_tpu_torch import NTTConfig, NTTDir, get_field, get_group, ntt
    from icicle_tpu_torch.kernels import build
    from icicle_tpu_torch.kernels.keccak_kernel import PERMUTATION_OPS
    from icicle_tpu_torch.kernels import ntt_kernel as K
    from icicle_tpu_torch.ops import ntt as N
    from icicle_tpu_torch.ops.msm import default_c, generic_plan, precompute_shift

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
    # one nvcc a library in a background pool of all cores but one (this
    # process's phases keep that one), EARLY_LIBRARIES first; each phase
    # below loads its libraries as their compiles end (build.load waits for
    # a compile in flight, and starts one still queued), the phases that
    # need no elliptic-curve library first, so that the build overlaps them
    slots = max(1, len(os.sched_getaffinity(0)) - 1)
    log(f"== build: every library compiling in the background, {slots} at a time")
    build_out = {}

    def build_everything() -> None:
        t0 = time.perf_counter()
        order = [*EARLY_LIBRARIES, *(n for n in build.LIBRARIES if n not in EARLY_LIBRARIES)]
        with concurrent.futures.ThreadPoolExecutor(slots) as pool:
            for job in [pool.submit(build.build_all, [name]) for name in order]:
                try:
                    job.result()
                except Exception as e:  # raised again in the main thread, at the join
                    build_out.setdefault("error", e)
        build_out["s"] = time.perf_counter() - t0
        try:
            if "error" not in build_out:
                build_out["sass"] = sass_counts()
        except Exception as e:
            build_out["error"] = e

    builder = threading.Thread(target=build_everything, daemon=True)
    builder.start()
    phase_done("build: started")
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
        ("babybear", 2048, 11, True, False, "2^22 fwd pass A (S6's chunks)"),
        ("babybear", 2048, 11, True, True, "2^22 fwd pass B (S6's chunks)"),
        ("babybear", 1024, 10, True, False, "2^20 fwd pass A (the C example)"),
        ("babybear", 1024, 10, True, True, "2^20 fwd pass B (the C example)"),
        ("babybear", 1024, 10, False, False, "2^20 inv pass A (the C example)"),
        ("babybear", 1024, 10, False, True, "2^20 inv pass B (the C example)"),
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
    log("== kernels: rq_ntt, mlkem (ntt, intt, multiply_ntts), keccak_sponge against their plain "
        "versions on the card at L1's and Q1's shapes")
    lp_rows = check_lattice_pqc_kernels(dev, gen, smi, sm_clock_mhz)
    phase_done("kernels: rq_ntt, mlkem, keccak_sponge")

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
    log("== main paths: the babykoala rings and the lattice ops (L1: ntt_rns 2^24, "
        "negacyclic_ntt, rq_matmul, decomposition, JL projection, norms) on CUDA tensors")
    l1 = lattice_paths(dev, gen, smi, launches)
    phase_done("main path: rings and lattice (L1)")
    log("== main paths: batched ML-KEM (Q1: ML-KEM-768 at 2^16, ML-KEM-512 and -1024 at 2^12) "
        "on CUDA tensors")
    q1 = ml_kem_paths(dev, smi, launches)
    phase_done("main path: ML-KEM (Q1)")
    log("== main path: stream_map (S6) from pinned host memory")
    stream = stream_path(dev, smi, launches)
    phase_done("main path: stream_map (S6)")

    log("== build: the rest of the libraries")
    builder.join()
    if "error" in build_out:
        raise build_out["error"]
    reports = build.compile_reports()
    log(f"built {sorted(reports) or 'nothing (up to date)'} in {build_out['s']:.2f} s, in the "
        "background beside the phases above")
    for lib, text in reports.items():
        for line in text.splitlines():
            if ("ptxas info" in line and ("registers" in line or "Compiling" in line)) \
                    or "spill" in line or line.startswith("nvcc: "):
                log(f"  lib{lib}: {line.strip()}")
    p2_sass, keccak_sass, hash_sass = build_out["sass"]
    log(f"  libposeidon2 babybear t=2 single permutation, SASS per hash: {p2_sass}")
    log(f"  libkeccak Keccak-256 word rows, SASS (one block's path and the loop around it; "
        f"the permutation needs {PERMUTATION_OPS} logic and shift instructions): {keccak_sass}")
    for lib, pattern in BLAKE_SASS:
        log(f"  lib{lib} {pattern} SASS (a static count; the kernels loop over blocks, and "
            f"poseidon_limbs over rounds): {hash_sass[pattern]}")

    phase_done("build: the rest")
    log("== kernels: the MSM kernels B3-B7 against their plain versions on the card")
    msm_rows = check_msm_kernels(dev, gen, smi, get_group("bn254"), MSM_CHECKS, MSM_FULL)
    phase_done("kernels: B3-B7")
    log("== kernels: B3 and B4 at 12 and 24 limbs, precompute_bases at 8, 12 and 24, against "
        "their plain versions on the card")
    limb_rows = {}
    for nl, cname, log_n in LIMB_CURVES:
        g = get_group(cname)
        curve_rows = check_msm_kernels(dev, gen, smi, g, *plan_checks(
            g, v3_plan(cname, 1 << log_n), "M1" if nl == 12 else "M2"))
        limb_rows.update({f"{k} ({nl}-limb)": v for k, v in curve_rows.items()})
    nbits = lambda g: g.curve.fr.modulus.bit_length()
    limb_rows["precompute_bases"] = check_precompute_bases(
        dev, gen, smi, [get_group(cname) for _, cname in PRE_CURVES],
        lambda g: [(nu, precompute_shift(nbits(g), PRE_CHECK_C, nu)) for nu in PRE_CHECK_NU],
        [(get_group(cname), 1 << log_n, nu, precompute_shift(nbits(get_group(cname)), c, nu),
          role) for cname, log_n, nu, c, role in (
              ("bls12_377", M3_LOG, M3_NU, M3_C, "M3's bases"),
              ("bn254", M4_LOG, 4, M4_C, "M4's bases at nu 4"))])
    phase_done("kernels: B3/B4 12, 24 limbs, precompute_bases")
    log("== kernels: B5 over grumpkin, bls12_377, bls12_381 and bw6_761, B6 and B7 at 12 and "
        "24 limbs, against their plain versions on the card")
    slice_kernel_rows = {}
    for cname in SLICE_CURVES:
        for k, v in check_msm_kernels(dev, gen, smi, get_group(cname),
                                      *slice_rows(cname)).items():
            slice_kernel_rows.setdefault(k, []).extend(v)
    phase_done("kernels: B5 every G1 curve, B6/B7 12, 24 limbs")
    log("== kernels: G2 -- B3, B4 and precompute_bases over Fp2 (8 and 12 limbs) and over Fq "
        "(bw6_761's G2, the 24-limb libraries) against their plain versions on the card")
    g2_rows = {}
    for cname in G2_CURVES:
        g = get_group(cname, g2=True)
        n = 1 << G2_PATH_LOGS[cname]
        plan = generic_plan(cname, n, default_c(n, g2=True), g2=True)
        for k, v in check_msm_kernels(dev, gen, smi, g, *plan_checks(
                g, plan, G2_PATH_NAMES[cname])).items():
            g2_rows.setdefault(f"{k} ({g.base_limbs}-limb, degree {g.degree})", []).extend(v)
    g2b = get_group("bn254", g2=True)
    g2_rows["precompute_bases"] = check_precompute_bases(
        dev, gen, smi, [get_group(cname, g2=True) for cname in G2_CURVES],
        lambda g: [(G2_PRE_NU, G2_PRE_SHIFT)],
        [(g2b, 1 << E4_LOG, E4_NU, precompute_shift(nbits(g2b), E4_C, E4_NU), "E4's bases")])
    phase_done("kernels: G2 B3/B4/precompute_bases")
    log("== kernels: ecntt_stage and ecntt_scale at 8, 12 and 24 limbs, GLV and plain ladders, "
        "against their plain versions on the card at EC1's shapes")
    ecntt_rows = check_ecntt_kernels(dev, smi)
    phase_done("kernels: ecntt")

    # -- 5. MSM main paths ----------------------------------------------------
    log("== main paths: the MSM routes (msm_affine, its r12 engine and v2 pipeline, msm_tpu) "
        "on CUDA tensors")
    msm = msm_main_paths(dev, smi, launches)
    phase_done("main path: msm")
    log("== main paths: the MSM's long tail (M1-M5: bls12_381, bls12_377, bw6_761, precomputed "
        "bases, GLV, batches, Montgomery-form inputs, bitsize) on CUDA tensors")
    msm_tail = msm_long_tail_paths(dev, smi, launches)
    phase_done("main path: msm long tail (M1-M5)")
    log("== main paths: G2 and the extension fields (E1-E6: G2 MSMs over bn254, bls12_381, "
        "bls12_377 and bw6_761, precomputed G2 bases and a batch, the pairing identity, "
        "ntt_ext) on CUDA tensors")
    g2 = g2_paths(dev, smi, launches)
    phase_done("main path: G2 and extension fields (E1-E6)")
    log("== main paths: the ECNTT (EC1: bn254 2^16, bls12_381 2^13, bw6_761 2^8) on CUDA "
        "tensors")
    ec1 = ecntt_paths(dev, smi, launches)
    phase_done("main path: ecntt (EC1)")
    log("== main paths: multi-device (S1-S5: ntt_sharded, msm_sharded3, msm_sharded, "
        "merkle_build_sharded and the two-level functions) over every visible card")
    multi = multi_device_paths(dev, smi, launches, merkle["root"])
    phase_done("main path: multi-device (S1-S5)")
    log("== main paths: the C ABI over the port (S7), in this process and from a C program")
    capi = capi_paths(dev, smi, launches)
    phase_done("main path: C ABI (S7)")
    log("seconds a phase: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))

    # -- 7. main paths line ---------------------------------------------------
    print(json.dumps({"main_paths": {"ntt": paths, "msm": msm, "msm_long_tail": msm_tail,
                                     "g2_and_extension_fields": g2,
                                     "merkle": merkle, "fri": fri,
                                     "sumcheck": sumcheck, "ntt_limb_fields": wide_ntt,
                                     "merkle_goldilocks": gl_merkle, "polynomials": polys,
                                     "hashes": hashes, "ecntt": ec1, "lattice": l1,
                                     "ml_kem": q1, "multi_device": multi,
                                     "stream_map": stream, "c_abi": capi,
                                     "launches": launches, "phase_s": phase_s,
                                     "card": smi}}))

    # -- 8. kernels line ------------------------------------------------------
    # launches: the kernel's count in the checked run of its headline main
    # path (one babybear 2^26 NTT forward + inverse; one bn254 2^24 MSM of
    # its route, 2^20 for v1; one 2^29 Merkle build); launches_per_path: its
    # count in every main path's checked run
    def per_path(kname: str) -> dict:
        return {path: counts[kname] for path, counts in launches.items()}

    def curve_paths(kname: str, curves) -> dict:
        """kname's count in every main path over one of `curves` (named in
        the path's label) that launched it."""
        return {path: c[kname] for path, c in launches.items()
                if c[kname] and any(cn in path for cn in curves)}

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
            "launches_per_path": {p: c for p, c in per_path(kname).items()
                                  if not any(cn in p for cn in SLICE_CURVES)},
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
                  R12_REPLACES, "B5 at full depth (12 per r12 2^24 MSM)", R12_24),
        msm_entry("suffix_fold", "icicle_tpu_torch/kernels/csrc/msm_fold2.cu",
                  FOLD_REPLACES, "B6 at full depth (29 per v2 2^24 MSM)", V2_24),
        msm_entry("bucket_accum", "icicle_tpu_torch/kernels/csrc/bucket_accum.cu",
                  ACCUM_REPLACES, "B7 at full depth (2 per v1 2^20 MSM)", V1_MAIN),
    ]
    # B3 and B4 at 12 and 24 limbs: ms and bound_ms one launch at the path's
    # full-depth shape (M1, M2), plain_ms at the first checked (cut) shape
    for kname, source, replaces in (
            ("prefix_scan", "msm_scan.cu", "icicle_tpu/pallas/msm_scan.py:45 (make_prefix_scan)"),
            ("ec_reduce", "ec_reduce.cu", "icicle_tpu/pallas/ec_reduce.py:63 (make_ec_reduce)")):
        for nl, headline in ((12, M1_MAIN), (24, M2_MAIN)):
            rows = limb_rows[f"{kname} ({nl}-limb)"]
            main = next(r for r in rows if not r["checked"])
            checked = rows[0]
            entries.append({
                "name": f"{kname} ({nl}-limb)", "route": "cuda",
                "source": f"icicle_tpu_torch/kernels/csrc/{source}", "replaces": replaces,
                "launches": launches[headline][kname], "headline_path": headline,
                "launches_per_path": {path: c[kname] for path, c in launches.items()
                                      if c[kname] and path in msm_tail
                                      and msm_tail[path]["limbs"] == nl},
                "max_abs_err": max(r["max_abs_diff"] for r in rows if r["checked"]),
                "ms": main["kernel_ms"], "plain_ms": checked["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": None,  # no PyTorch call computes an elliptic-curve add
                "shape": [main["depth"], main["lanes"]],
                "plain_shape": [checked["depth"], checked["lanes"]],
                "checked_ms": checked["kernel_ms"], "shapes": rows, "card": smi})
    # B5 over grumpkin and at 12 and 24 limbs, B6 and B7 at 12 and 24 limbs:
    # ms and bound_ms one launch at the headline path's full-depth shape,
    # plain_ms at its first checked (cut) shape
    for kname, source, replaces, label, curves, headline in (
            ("prefix_scan_r12", "msm_scan_r12.cu", R12_REPLACES, "prefix_scan_r12 (grumpkin)",
             ("grumpkin",), slice_label("r12", "grumpkin", R12_LOGS["grumpkin"])),
            ("prefix_scan_r12", "msm_scan_r12.cu", R12_REPLACES, "prefix_scan_r12 (12-limb)",
             ("bls12_381", "bls12_377"), slice_label("r12", "bls12_381", M1_LOG)),
            ("prefix_scan_r12", "msm_scan_r12.cu", R12_REPLACES, "prefix_scan_r12 (24-limb)",
             ("bw6_761",), slice_label("r12", "bw6_761", M2_LOG)),
            ("suffix_fold", "msm_fold2.cu", FOLD_REPLACES, "suffix_fold (12-limb)",
             ("bls12_381", "bls12_377"), slice_label("v2", "bls12_381", M1_LOG)),
            ("suffix_fold", "msm_fold2.cu", FOLD_REPLACES, "suffix_fold (24-limb)",
             ("bw6_761",), slice_label("v2", "bw6_761", M2_LOG)),
            ("bucket_accum", "bucket_accum.cu", ACCUM_REPLACES, "bucket_accum (12-limb)",
             ("bls12_381", "bls12_377"), slice_label("v1", "bls12_381", V1_LOGS["bls12_381"])),
            ("bucket_accum", "bucket_accum.cu", ACCUM_REPLACES, "bucket_accum (24-limb)",
             ("bw6_761",), slice_label("v1", "bw6_761", V1_LOGS["bw6_761"]))):
        rows = [r for r in slice_kernel_rows[kname] if r["curve"] in curves]
        main = next(r for r in rows if not r["checked"] and r["curve"] == curves[0])
        checked = next(r for r in rows if r["checked"] and r["curve"] == curves[0])
        entries.append({
            "name": label, "route": "cuda", "source": f"icicle_tpu_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches[headline][kname],
            "headline_path": headline, "launches_per_path": curve_paths(kname, curves),
            "max_abs_err": max(r["max_abs_diff"] for r in rows if r["checked"]),
            "ms": main["kernel_ms"], "plain_ms": checked["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,  # no PyTorch call computes an elliptic-curve add
            "shape": [main["depth"], main["lanes"]],
            "plain_shape": [checked["depth"], checked["lanes"]],
            "checked_ms": checked["kernel_ms"], "shapes": rows, "card": smi})
    # precompute_bases: ms and bound_ms at M4's bases (2^22 bn254 points, nu 4),
    # M3's beside them; plain_ms at the first checked shape (bn254, 2^12, nu 2)
    pre = limb_rows["precompute_bases"]
    pre_main = next(r for r in pre if r["role"] == "M4's bases at nu 4")
    pre_m3 = next(r for r in pre if r["role"] == "M3's bases")
    entries.append({
        "name": "precompute_bases", "route": "cuda",
        "source": "icicle_tpu_torch/kernels/csrc/precompute_bases.cu",
        "replaces": "none (XLA): icicle_tpu/ops/msm.py:313 msm_precompute_bases chunk_fn",
        "launches": launches[M4_BASES[4]]["precompute_bases"], "headline_path": M4_BASES[4],
        "launches_per_path": per_path("precompute_bases"),
        "max_abs_err": max(r["max_abs_diff"] for r in pre if r["checked"]),
        "ms": pre_main["kernel_ms"], "plain_ms": pre[0]["plain_ms"],
        "bound_ms": pre_main["bound_ms"], "bound_by": pre_main["bound_by"],
        "library_ms": None,  # no PyTorch call computes an elliptic-curve doubling chain
        "shape": [pre_main["n"], pre_main["nu"], pre_main["shift"]],
        "plain_shape": [pre[0]["n"], pre[0]["nu"], pre[0]["shift"]],
        "checked_ms": pre[0]["kernel_ms"], "m3_ms": pre_m3["kernel_ms"],
        "m3_bound_ms": pre_m3["bound_ms"],
        "bound_fermat_per_copy_ms": pre_main["bound_fermat_per_copy_ms"],
        "shapes": pre, "card": smi})
    # G2: B3 and B4 a (limbs, degree) instance, ms and bound_ms one launch at
    # the headline path's full-depth shape, plain_ms at the first checked
    # (cut) shape; bw6_761's G2 through the 24-limb libraries
    for kname, source, replaces in (
            ("prefix_scan", "msm_scan.cu", "icicle_tpu/pallas/msm_scan.py:45 (make_prefix_scan)"),
            ("ec_reduce", "ec_reduce.cu", "icicle_tpu/pallas/ec_reduce.py:63 (make_ec_reduce)")):
        for inst, label, cname, headline in (
                ("8-limb, degree 2", f"{kname} (Fp2, 8-limb)", "bn254", E1_MAIN),
                ("12-limb, degree 2", f"{kname} (Fp2, 12-limb)", "bls12_381", E2_MAIN),
                ("24-limb, degree 1", f"{kname} (bw6_761 G2 consts, 24-limb)", "bw6_761",
                 E3_MAIN["bw6_761"])):
            rows = g2_rows[f"{kname} ({inst})"]
            main = next(r for r in rows if not r["checked"] and r["curve"] == cname)
            checked = next(r for r in rows if r["checked"] and r["curve"] == cname)
            paths_of = [k for k, v in g2.items() if v.get("instance") == inst]
            entries.append({
                "name": label, "route": "cuda",
                "source": f"icicle_tpu_torch/kernels/csrc/{source}", "replaces": replaces,
                "launches": launches[headline][kname], "headline_path": headline,
                "launches_per_path": {path: launches[path][kname] for path in paths_of},
                "max_abs_err": max(r["max_abs_diff"] for r in rows if r["checked"]),
                "ms": main["kernel_ms"], "plain_ms": checked["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": None,  # no PyTorch call computes an elliptic-curve add
                "shape": [main["depth"], main["lanes"]],
                "plain_shape": [checked["depth"], checked["lanes"]],
                "checked_ms": checked["kernel_ms"], "shapes": rows, "card": smi})
    pre2 = g2_rows["precompute_bases"]
    pre2_main = next(r for r in pre2 if r["role"] == "E4's bases")
    pre2_checked = pre2[0]
    entries.append({
        "name": "precompute_bases (G2: Fp2 8 and 12 limbs; bw6_761 over Fq)", "route": "cuda",
        "source": "icicle_tpu_torch/kernels/csrc/precompute_bases.cu",
        "replaces": "none (XLA): icicle_tpu/ops/msm.py:313 msm_precompute_bases chunk_fn "
                    "(group = get_group(curve, g2=True), ops/msm.py:286)",
        "launches": launches[E4_BASES]["precompute_bases"], "headline_path": E4_BASES,
        "launches_per_path": {E4_BASES: launches[E4_BASES]["precompute_bases"]},
        "max_abs_err": max(r["max_abs_diff"] for r in pre2 if r["checked"]),
        "ms": pre2_main["kernel_ms"], "plain_ms": pre2_checked["plain_ms"],
        "bound_ms": pre2_main["bound_ms"], "bound_by": pre2_main["bound_by"],
        "library_ms": None,  # no PyTorch call computes an elliptic-curve doubling chain
        "shape": [pre2_main["n"], pre2_main["nu"], pre2_main["shift"]],
        "plain_shape": [pre2_checked["n"], pre2_checked["nu"], pre2_checked["shift"]],
        "checked_ms": pre2_checked["kernel_ms"], "shapes": pre2, "card": smi})
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
    # the ECNTT kernel (ecntt_stage and ecntt_scale, one source, a library a
    # limb count): ms, plain_ms and bound_ms one launch of EC1's widest
    # ladder stage (bn254 2^16, 2^15 lanes, GLV), from its check
    stage = next(r for r in ecntt_rows if r["curve"] == "bn254" and r["glv"]
                 and r["entry"] == "stage")
    scale = next(r for r in ecntt_rows if r["curve"] == "bn254" and r["entry"] == "scale")
    entries.append({
        "name": "ecntt", "route": "cuda", "source": "icicle_tpu_torch/kernels/csrc/ecntt.cu",
        "replaces": "none (XLA): icicle_tpu/ops/ecntt.py:35 scalar_mul_vec_glv, :87 "
                    "scalar_mul_vec, :220 _ecntt_core",
        "launches": launches[EC1_MAIN]["ecntt_stage"] + launches[EC1_MAIN]["ecntt_scale"],
        "headline_path": EC1_MAIN,
        "launches_per_path": {p: c["ecntt_stage"] + c["ecntt_scale"] for p, c in launches.items()
                              if c["ecntt_stage"] + c["ecntt_scale"]},
        "max_abs_err": max(r["max_abs_diff"] for r in ecntt_rows),
        "ms": stage["kernel_ms"], "plain_ms": stage["plain_ms"],
        "bound_ms": stage["bound_ms"], "bound_by": stage["bound_by"],
        "library_ms": None,  # no PyTorch call computes an elliptic-curve scalar ladder
        "shape": [stage["lanes"], stage["digit_rows"]], "scale_ms": scale["kernel_ms"],
        "scale_plain_ms": scale["plain_ms"], "scale_bound_ms": scale["bound_ms"],
        "shapes": ecntt_rows, "card": smi})
    # rq_ntt: one forward launch over L1's 2^16 polynomials, from its check
    rq = next(r for r in lp_rows["rq_ntt"] if r["dir"] == "forward")
    entries.append({
        "name": "rq_ntt", "route": "cuda", "source": "icicle_tpu_torch/kernels/csrc/rq_ntt.cu",
        "replaces": "none (XLA): icicle_tpu/rings/rq.py:33 negacyclic_ntt",
        "launches": launches[RQ_MAIN]["rq_ntt"], "headline_path": RQ_MAIN,
        "launches_per_path": per_path("rq_ntt"),
        "max_abs_err": max(r["max_abs_diff"] for r in lp_rows["rq_ntt"]),
        "ms": rq["kernel_ms"], "plain_ms": rq["plain_ms"],
        "bound_ms": rq["bound_ms"], "bound_by": rq["bound_by"],
        "library_ms": None,  # no PyTorch call computes a modular NTT
        "shape": [rq["polys"], 64], "shapes": lp_rows["rq_ntt"], "card": smi})
    # mlkem: one ntt launch over ML-KEM-768's 2^16 x 3 polynomials, from its
    # check; the other ops in "shapes"
    ops = {r["op"]: r for r in lp_rows["mlkem"]}
    enc = f"{MLKEM_MAIN} encaps"
    mk_names = ("mlkem_ntt", "mlkem_intt", "mlkem_multiply_ntts")
    entries.append({
        "name": "mlkem", "route": "cuda", "source": "icicle_tpu_torch/kernels/csrc/mlkem.cu",
        "replaces": "none (XLA): icicle_tpu/ops/pqc/ml_kem_tpu.py:141 ntt, :153 intt, "
                    ":165 multiply_ntts",
        "launches": sum(launches[enc][k] for k in mk_names), "headline_path": enc,
        "launches_per_path": {p: {k: c[k] for k in mk_names} for p, c in launches.items()
                              if any(c[k] for k in mk_names)},
        "max_abs_err": max(r["max_abs_diff"] for r in lp_rows["mlkem"]),
        "ms": ops["ntt"]["kernel_ms"], "plain_ms": ops["ntt"]["plain_ms"],
        "bound_ms": ops["ntt"]["bound_ms"], "bound_by": ops["ntt"]["bound_by"],
        "library_ms": None,  # no PyTorch call computes a Z_3329 NTT
        "shape": [ops["ntt"]["polys"], 256], "shapes": lp_rows["mlkem"], "card": smi})
    # keccak_sponge: the SHAKE128 matrix XOF over ML-KEM-768's 2^16
    # messages, from its check; the other sponges in "shapes"
    sp = next(r for r in lp_rows["keccak_sponge"] if r["role"] == SPONGE_MAIN)
    entries.append({
        "name": "keccak_sponge", "route": "cuda",
        "source": "icicle_tpu_torch/kernels/csrc/keccak.cu",
        "replaces": "none (XLA): icicle_tpu/ops/pqc/ml_kem_tpu.py:88 _sponge",
        "launches": launches[enc]["keccak_sponge"], "headline_path": enc,
        "launches_per_path": per_path("keccak_sponge"),
        "max_abs_err": max(r["max_abs_diff"] for r in lp_rows["keccak_sponge"]),
        "ms": sp["kernel_ms"], "plain_ms": sp["plain_ms"],
        "bound_ms": sp["bound_ms"], "bound_by": sp["bound_by"],
        "library_ms": None,  # no PyTorch call computes a Keccak sponge
        "shape": [sp["batch"], sp["in_bytes"], sp["out_bytes"]],
        "sm_clock_mhz": sm_clock_mhz, "shapes": lp_rows["keccak_sponge"], "card": smi})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
