"""Backend registration points (counterpart of icicle_tpu/runtime/registry.py;
reference include/icicle/backend/*.h REGISTER_* macros).

Ops register their "torch" and "cuda" implementations with the dispatcher at
their definition site; importing this module imports every op the port has.
So far that is the NTT (ops/ntt.py; the extension-field NTT `ntt_ext`
under the JAX registry's name "extension_ntt"), the MSM (ops/msm.py), the hashes
Poseidon2 (ops/hash/poseidon2.py, api "poseidon2"), Poseidon
(ops/hash/poseidon.py, api "poseidon"), Keccak (ops/hash/keccak.py, api
"keccak"), Blake2s (ops/hash/blake2s.py, api "blake2s") and Blake3
(ops/hash/blake3.py, api "blake3"), which the Merkle tree hashes through
(the JAX registry's poseidon_factory, blake2s_factory and blake3_factory
name the classes Poseidon, Blake2s and Blake3), the FRI fold
(ops/fri.py, api "fri_fold"), the sumcheck round (ops/sumcheck.py, api
"sumcheck_round"), program execution (ops/vec_ops.py, api
"execute_program"), the ECNTT (ops/ecntt.py, api "ecntt") and the
negacyclic NTT of R_q (rings/rq.py, api "negacyclic_ntt"). The rest of the JAX package's registration points
arrive with the slices that port them (ROADMAP.md).
"""

import icicle_tpu_torch.ops.ecntt  # noqa: F401
import icicle_tpu_torch.ops.fri  # noqa: F401
import icicle_tpu_torch.ops.hash.blake2s  # noqa: F401
import icicle_tpu_torch.ops.hash.blake3  # noqa: F401
import icicle_tpu_torch.ops.hash.keccak  # noqa: F401
import icicle_tpu_torch.ops.hash.poseidon  # noqa: F401
import icicle_tpu_torch.ops.hash.poseidon2  # noqa: F401
import icicle_tpu_torch.ops.msm  # noqa: F401
import icicle_tpu_torch.ops.ntt  # noqa: F401
import icicle_tpu_torch.ops.sumcheck  # noqa: F401
import icicle_tpu_torch.ops.vec_ops  # noqa: F401
import icicle_tpu_torch.rings.rq  # noqa: F401
