"""The port's NTT (icicle_tpu_torch/ops/ntt.py) on CPU tensors against the
JAX package's `ntt(..., backend="xla")` on the same numpy inputs, for
babybear over all orderings and both directions; the port's domain tables;
and the checked-in reference-library golden vectors. The helpers here serve
the other tests/test_torch_ntt_*.py files too (koalabear, coset and batch,
and the CUDA route).

Tolerance: exact equality (integers mod p).
"""

import numpy as np
import pytest
import torch

from icicle_tpu.fields.field import get_field as jax_field
from icicle_tpu.ops import ntt as JN
from icicle_tpu.runtime import config as jcfg
from icicle_tpu_torch import interop
from icicle_tpu_torch import ntt as torch_ntt
from icicle_tpu_torch.fields.field import get_field as torch_field
from icicle_tpu_torch.ops import ntt as TN
from icicle_tpu_torch.runtime.config import NTTConfig, NTTDir, Ordering
from tests import ref_ffi

CPU = torch.device("cpu")
ORDERINGS = [o.value for o in Ordering]
DIRS = ["forward", "inverse"]


def _vec(p: int, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, p, size=shape, dtype=np.uint32)


def _jax(name, x, direction, ordering="NN", coset_gen=None):
    cfg = jcfg.NTTConfig(ordering=jcfg.Ordering(ordering), coset_gen=coset_gen,
                         backend="xla")
    return np.asarray(JN.ntt(jax_field(name), x, jcfg.NTTDir(direction), cfg))


def _port(name, x, direction, ordering="NN", coset_gen=None, fn=None):
    tf = torch_field(name)
    cfg = NTTConfig(ordering=Ordering(ordering), coset_gen=coset_gen)
    xt = interop.elements_from_numpy(tf, x, CPU)
    if fn is None:
        y = torch_ntt(tf, xt, NTTDir(direction), cfg)
    else:
        y = fn(tf, xt, NTTDir(direction), cfg)
    return interop.elements_to_numpy(tf, y)


@pytest.mark.parametrize("direction", DIRS)
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_ntt_matches_jax(ordering, direction):
    _check_sizes("babybear", ordering, direction)


def _check_sizes(name, ordering, direction):
    """logn 1..12, one vector each."""
    p = torch_field(name).modulus
    for logn in range(1, 13):
        x = _vec(p, (1 << logn,), logn)
        assert np.array_equal(_port(name, x, direction, ordering),
                              _jax(name, x, direction, ordering)), logn


def _check_coset(name, ordering, direction):
    """coset generator 7, logn 1, 4, 9."""
    p = torch_field(name).modulus
    for logn in (1, 4, 9):
        x = _vec(p, (1 << logn,), 100 + logn)
        assert np.array_equal(_port(name, x, direction, ordering, coset_gen=7),
                              _jax(name, x, direction, ordering, coset_gen=7)), logn


def test_ntt_rejects_non_int32():
    tf = torch_field("babybear")
    with pytest.raises(Exception, match="int32"):
        torch_ntt(tf, torch.zeros(8, dtype=torch.int64))


def test_unregistered_backend_raises():
    tf = torch_field("babybear")
    with pytest.raises(Exception, match="no tpu backend"):
        torch_ntt(tf, tf.zeros((8,), CPU), NTTDir.FORWARD, NTTConfig(backend="tpu"))


def test_domain_matches_jax():
    for name in ("babybear", "koalabear"):
        jf, tf = jax_field(name), torch_field(name)
        for logn in (1, 5, 12):
            jd = JN.get_domain(jf, logn)
            got = TN.get_domain(tf, logn, CPU)
            want = interop.domain_from_numpy(tf, logn, np.asarray(jd.twiddles),
                                             np.asarray(jd.twiddles_inv), CPU)
            assert torch.equal(got.twiddles, want.twiddles)
            assert torch.equal(got.twiddles_inv, want.twiddles_inv)
            assert torch.equal(got.n_inv_mont, want.n_inv_mont)
            assert (got.w_int, got.w_inv_int) == (jd.w_int, jd.w_inv_int)


def test_root_of_unity_and_release_domain():
    jf, tf = jax_field("babybear"), torch_field("babybear")
    for size in (1, 2, 3, 1000, 1 << 20):
        assert TN.get_root_of_unity(tf, size) == JN.get_root_of_unity(jf, size)
    dom = TN.get_domain(tf, 6, CPU)
    TN.ntt_release_domain(tf)
    again = TN.get_domain(tf, 6, CPU)
    assert again is not dom and torch.equal(again.twiddles, dom.twiddles)


@pytest.mark.parametrize("shape", [(8,), (3, 16), (2, 2, 32)])
def test_bit_reverse_matches_jax(shape):
    from icicle_tpu.ops import vec_ops as jvec
    from icicle_tpu_torch.ops import vec_ops as tvec
    jf, tf = jax_field("babybear"), torch_field("babybear")
    x = _vec(tf.modulus, shape, 7)
    assert np.array_equal(jvec.bit_reverse_indices(shape[-1]),
                          tvec.bit_reverse_indices(shape[-1]))
    got = tvec.bit_reverse(tf, interop.elements_from_numpy(tf, x, CPU))
    assert np.array_equal(interop.elements_to_numpy(tf, got),
                          np.asarray(jvec.bit_reverse(jf, x)))


def test_auto_backend_follows_the_tensor():
    """auto resolves to "torch" for a CPU tensor; naming "cuda" on a CPU
    tensor takes the CUDA route, whose kernels compute their plain version
    because the tensor lies on the CPU."""
    from icicle_tpu_torch.runtime import dispatcher
    tf = torch_field("babybear")
    x = tf.zeros((16,), CPU)
    assert dispatcher.dispatch("ntt", None, x) is TN._ntt_torch
    assert dispatcher.dispatch("ntt", "auto", x) is TN._ntt_torch
    assert dispatcher.dispatch("ntt", "cuda", x) is TN._ntt_cuda


# -- golden replay: the calls of tests/test_reference_vectors.py:55-89, with
# the same `rng` fixture draws, so ref_ffi answers from tests/golden/ -------

def _golden_input(rng, n, p):
    return np.array([int.from_bytes(rng.bytes(8), "little") % p for _ in range(n)],
                    dtype=np.uint32)


@pytest.mark.parametrize("logn,ordering", [(4, "NN"), (8, "NN"), (6, "NR"), (6, "RN")])
def test_ntt_golden_replay(logn, ordering, rng):
    p = torch_field("babybear").modulus
    a = _golden_input(rng, 1 << logn, p)
    order_map = {"NN": 0, "NR": 1, "RN": 2, "RR": 3}
    ref = ref_ffi.ntt("babybear", a, logn_domain=max(logn, 10),
                      ordering=order_map[ordering])
    assert np.array_equal(_port("babybear", a, "forward", ordering), ref)


def test_intt_golden_replay(rng):
    a = _golden_input(rng, 64, torch_field("babybear").modulus)
    ref = ref_ffi.ntt("babybear", a, logn_domain=10, inverse=True)
    assert np.array_equal(_port("babybear", a, "inverse"), ref)


def test_coset_ntt_golden_replay(rng):
    a = _golden_input(rng, 32, torch_field("babybear").modulus)
    gen_le = np.array([7], dtype=np.uint32).view(np.uint8)
    ref = ref_ffi.ntt("babybear", a, logn_domain=10, coset_gen_le=gen_le)
    assert np.array_equal(_port("babybear", a, "forward", coset_gen=7), ref)
