"""icicle_tpu_torch -- the PyTorch/CUDA port of icicle_tpu.

A second package beside the JAX one, with the same layout and names. It
imports torch and numpy, never jax and nothing of icicle_tpu. Elements of
single-limb fields are int32 tensors holding canonical values; functions
compute on their input's device, and create tensors on CUDA unless the
caller passes `device="cpu"` or calls `set_device("cpu")`.

Goldilocks elements are (..., 2) and multi-limb field elements (..., L)
int32 tensors holding the uint32 word bit patterns.

Ported so far: the runtime, the field layer (Mont32, goldilocks and
multi-limb), the NTT over every field, whose four-step row passes run in
hand-written Hopper kernels (kernels/csrc/ntt_dif.cu for single-word
fields, ntt_wide.cu for goldilocks and 8-limb fields), the polynomial API
over it, field matmul, and the bn254 G1 MSM: the v3 prefix-scan
pipeline, whose scan and EC reductions run in two more
(kernels/csrc/msm_scan.cu, ec_reduce.cu) or, with the radix-12 engine, a
third (msm_scan_r12.cu); the v2 suffix-fold pipeline (msm_fold2.cu); the
v1 bucket pipeline, ops/msm_tpu.py `msm_tpu` (bucket_accum.cu); and the
Poseidon2 hash with the Merkle tree over it, whose hashing runs in one more
(poseidon2.cu); the Poseidon, Blake2s and Blake3 hashes (poseidon.cu,
blake2s.cu, blake3.cu); and the protocol layer: the Keccak / SHA-3 hashes
(keccak.cu), field programs and the vector ops (program.cu), proof of
work, the sumcheck prover (sumcheck.cu) and the FRI prover (fri_fold.cu).

    fields:   get_field
    curves:   get_curve
    ops:      ntt, ntt_jit, NTTConfig, NTTDir, Ordering, matmul, MatMulConfig,
              msm_affine, MSMConfig,
              Poseidon2, Poseidon, Blake2s, Blake3, Keccak256, Keccak512, Sha3_256,
              Sha3_512, HashConfig,
              MerkleTree, MerkleProof, MerkleTreeConfig, Program,
              ReturningValueProgram, PreDefined, execute_program, sumcheck_prove,
              sumcheck_verify, fri_prove, fri_verify, FriConfig,
              FriTranscriptConfig, SumcheckConfig, SumcheckTranscriptConfig,
              proof_of_work, proof_of_work_verify
    polynomials: Polynomial
    runtime:  set_device
"""

from icicle_tpu_torch.curves.params import get_curve
from icicle_tpu_torch.fields.field import get_field
from icicle_tpu_torch.ops.fri import FriTranscriptConfig, fri_prove, fri_verify
from icicle_tpu_torch.ops.hash.blake2s import Blake2s
from icicle_tpu_torch.ops.hash.blake3 import Blake3
from icicle_tpu_torch.ops.hash.keccak import Keccak256, Keccak512, Sha3_256, Sha3_512
from icicle_tpu_torch.ops.hash.poseidon import Poseidon
from icicle_tpu_torch.ops.hash.poseidon2 import Poseidon2
from icicle_tpu_torch.ops.mat_ops import MatMulConfig, matmul
from icicle_tpu_torch.ops.merkle import MerkleProof, MerkleTree
from icicle_tpu_torch.ops.msm import MSMConfig, msm_affine
from icicle_tpu_torch.ops.ntt import ntt, ntt_jit
from icicle_tpu_torch.ops.pow import proof_of_work, proof_of_work_verify
from icicle_tpu_torch.ops.program import PreDefined, Program, ReturningValueProgram
from icicle_tpu_torch.ops.sumcheck import (SumcheckTranscriptConfig, sumcheck_prove,
                                           sumcheck_verify)
from icicle_tpu_torch.ops.vec_ops import execute_program
from icicle_tpu_torch.polynomials import Polynomial
from icicle_tpu_torch.runtime import registry as _registry  # noqa: F401
from icicle_tpu_torch.runtime.config import (FriConfig, HashConfig, MerkleTreeConfig, NTTConfig,
                                             NTTDir, Ordering, SumcheckConfig)
from icicle_tpu_torch.runtime.device import set_device

__all__ = ["get_curve", "get_field", "ntt", "ntt_jit", "NTTConfig", "NTTDir", "Ordering",
           "matmul", "MatMulConfig", "Polynomial",
           "msm_affine", "MSMConfig", "Poseidon2", "Poseidon", "Blake2s", "Blake3", "Keccak256",
           "Keccak512", "Sha3_256", "Sha3_512", "HashConfig", "MerkleTree", "MerkleProof", "MerkleTreeConfig",
           "Program", "ReturningValueProgram", "PreDefined", "execute_program",
           "sumcheck_prove", "sumcheck_verify", "SumcheckConfig", "SumcheckTranscriptConfig",
           "fri_prove", "fri_verify", "FriConfig", "FriTranscriptConfig", "proof_of_work",
           "proof_of_work_verify", "set_device"]
