"""The port's NTT over multi-limb fields (icicle_tpu_torch/ops/ntt.py,
the vector axis before the limb axis) against the JAX package's `ntt` /
`ntt_jit` on the CPU, at the JAX tests' sizes (tests/test_ntt.py:18 and
:129: bn254_scalar at 2^3 and 2^5, stark252 at 2^5 and a batch of 3 x 64),
every ordering, a coset and the batch axis; and a 12-limb field
(bw6_761_scalar, 377 bits) at the same sizes. The four-step route at 2^16
is in tests/test_torch_ntt_limbs_four_step.py.

Inputs come from numpy seeds; tolerance: exact equality (integers mod p).
"""

import numpy as np
import pytest
import torch

from icicle_tpu.fields.field import get_field as jax_field
from icicle_tpu.ops import ntt as JN
from icicle_tpu.runtime import config as jcfg
from icicle_tpu_torch import interop
from icicle_tpu_torch.fields.field import get_field as torch_field
from icicle_tpu_torch.ops import ntt as TN
from icicle_tpu_torch.runtime.config import NTTConfig, NTTDir, Ordering

torch.set_num_threads(1)

CPU = torch.device("cpu")
ORDERINGS = [o.value for o in Ordering]


def limb_vec(fname: str, shape, seed: int, nbytes: int = 40) -> np.ndarray:
    """Canonical uint32 (..., L) limbs from a seed (`nbytes` random bytes
    each, reduced mod p), with 0 and p - 1 first."""
    f = jax_field(fname)
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(nbytes), "little") % f.modulus
            for _ in range(int(np.prod(shape)))]
    vals[:2] = [0, f.modulus - 1]
    return np.asarray(f.from_ints(np.array(vals, dtype=object).reshape(shape)), dtype=np.uint32)


def jax_ntt(fname, x, direction, ordering="NN", coset_gen=None, jit=False):
    cfg = jcfg.NTTConfig(ordering=jcfg.Ordering(ordering), coset_gen=coset_gen, backend="xla")
    fn = JN.ntt_jit if jit else JN.ntt
    return np.asarray(fn(jax_field(fname), x, jcfg.NTTDir(direction), cfg))


def port_ntt(fname, x, direction, ordering="NN", coset_gen=None, fn=None):
    tf = torch_field(fname)
    cfg = NTTConfig(ordering=Ordering(ordering), coset_gen=coset_gen)
    y = (fn or TN.ntt)(tf, interop.elements_from_numpy(tf, x, CPU), NTTDir(direction), cfg)
    return interop.elements_to_numpy(tf, y)


@pytest.mark.parametrize("logn", [3, 5])
def test_bn254_forward_matches_jax(logn):
    """The parent raised RuntimeError here: shape '[32, 4, 16]' is invalid."""
    x = limb_vec("bn254_scalar", (1 << logn,), seed=10 + logn)
    got = port_ntt("bn254_scalar", x, "forward")
    assert got.shape == x.shape and np.array_equal(got, jax_ntt("bn254_scalar", x, "forward"))


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_bn254_orderings_match_jax(direction):
    x = limb_vec("bn254_scalar", (32,), seed=20)
    for ordering in ORDERINGS:
        assert np.array_equal(port_ntt("bn254_scalar", x, direction, ordering),
                              jax_ntt("bn254_scalar", x, direction, ordering)), ordering


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_bn254_coset_matches_jax(direction):
    x = limb_vec("bn254_scalar", (32,), seed=21)
    for ordering in ("NN", "RN"):
        assert np.array_equal(port_ntt("bn254_scalar", x, direction, ordering, coset_gen=5),
                              jax_ntt("bn254_scalar", x, direction, ordering, coset_gen=5))


def test_stark252_jit_round_trip_matches_jax():
    """tests/test_ntt.py:129: stark252 at 2^5 through ntt_jit and back."""
    x = limb_vec("stark252", (32,), seed=30)
    fwd = jax_ntt("stark252", x, "forward", jit=True)
    tf = torch_field("stark252")
    got = TN.ntt_jit(tf, interop.elements_from_numpy(tf, x, CPU))
    assert np.array_equal(interop.elements_to_numpy(tf, got), fwd)
    back = TN.ntt_jit(tf, got, NTTDir.INVERSE)
    assert np.array_equal(interop.elements_to_numpy(tf, back), x)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_stark252_batch_matches_jax(direction):
    """A batch of 3 x 64 (tests/test_ntt.py:35): the batch axis before the
    vector axis before the limbs, every ordering, and a coset."""
    x = limb_vec("stark252", (3, 64), seed=31)
    for ordering in ORDERINGS:
        assert np.array_equal(port_ntt("stark252", x, direction, ordering),
                              jax_ntt("stark252", x, direction, ordering)), ordering
    assert np.array_equal(port_ntt("stark252", x, direction, coset_gen=3),
                          jax_ntt("stark252", x, direction, coset_gen=3))


def test_batch_of_64_takes_the_vector_major_route():
    """64 vectors and more: `_ntt_vecfirst` along axis 0 with the limbs
    last, against the per-vector classic route."""
    tf = torch_field("stark252")
    x = interop.elements_from_numpy(tf, limb_vec("stark252", (64, 8), seed=32), CPU)
    got = TN.ntt(tf, x)
    for r in (0, 17, 63):
        assert torch.equal(got[r], TN.ntt(tf, x[r]))


@pytest.mark.parametrize("logn", [3, 5])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_twelve_limb_orderings_match_jax(logn, direction):
    """bw6_761_scalar (= bls12_377_base, 12 limbs), whose NTT the CUDA route
    sends to dif_rows_wide's 12-limb instance at 2^16 and more: every
    ordering at 2^3 and 2^5, forward and inverse."""
    x = limb_vec("bw6_761_scalar", (1 << logn,), seed=40 + logn, nbytes=56)
    for ordering in ORDERINGS:
        got = port_ntt("bw6_761_scalar", x, direction, ordering)
        assert got.shape == x.shape
        assert np.array_equal(got, jax_ntt("bw6_761_scalar", x, direction, ordering)), ordering
