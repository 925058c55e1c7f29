"""The port's goldilocks field (icicle_tpu_torch/math/gl64.py through
`Field`) against the JAX package's `Goldilocks` engine on the CPU: every
engine op on random values and on edge values (0, 1, p - 1, 2^32 - 1,
2^32, 2^63, and pairs whose sum or product wraps 2^64), the conversions
and `rand`, the goldilocks NTT at 2^3, 2^5 and 2^6 and a batch against
JAX `ntt` / `ntt_jit` (as tests/test_ntt.py:109), the four-step route at
2^16 against the `_ct_stages` route, the vector ops, and the protocol
kernels' refusal of goldilocks on the card.

Inputs come from numpy seeds; tolerance: exact equality (integers mod p).
"""

import numpy as np
import pytest
import torch

from icicle_tpu.fields.field import get_field as jax_field
from icicle_tpu.ops import ntt as JN
from icicle_tpu.ops import vec_ops as JV
from icicle_tpu.runtime import config as jcfg
from icicle_tpu_torch import interop
from icicle_tpu_torch.fields.field import get_field as torch_field
from icicle_tpu_torch.kernels import fri_kernel, program_kernel, sumcheck_kernel
from icicle_tpu_torch.ops import ntt as TN
from icicle_tpu_torch.ops import vec_ops as TV
from icicle_tpu_torch.ops.program import PreDefined, Program, ReturningValueProgram
from icicle_tpu_torch.runtime.config import NTTConfig, NTTDir, Ordering
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

torch.set_num_threads(1)

CPU = torch.device("cpu")
P = (1 << 64) - (1 << 32) + 1
EDGES = [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, 1 << 63, (1 << 63) + 7,
         P - (1 << 32), (1 << 64) - (1 << 33), 0xFFFFFFFF00000000]
JF, TF = jax_field("goldilocks"), torch_field("goldilocks")


def _values(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return EDGES + [int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)]


def _pairs(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Every pair of edge values (their sums and products wrap 2^64 where
    both are near p) and seeded random pairs, as (..., 2) uint32 words."""
    vals = _values(64, seed)
    a = [x for x in EDGES for _ in EDGES] + vals
    b = [y for _ in EDGES for y in EDGES] + vals[::-1]
    assert any(x + y >= 1 << 64 for x, y in zip(a, b))
    return (np.asarray(JF.from_ints(a), dtype=np.uint32),
            np.asarray(JF.from_ints(b), dtype=np.uint32))


def _port(a: np.ndarray) -> torch.Tensor:
    return interop.elements_from_numpy(TF, a, CPU)


def _u32(t: torch.Tensor) -> np.ndarray:
    return interop.elements_to_numpy(TF, t)


def test_field_layout():
    assert TF.limb_shape == JF.limb_shape == (2,)
    assert TF.nlimbs == 2 and TF.modulus == P


@pytest.mark.parametrize("op", ["add", "sub", "mul", "mul_mont"])
def test_binary_ops_match_jax(op):
    a, b = _pairs(seed=1)
    want = np.asarray(getattr(JF, op)(a, b))
    got = getattr(TF, op)(_port(a), _port(b))
    assert got.dtype == torch.int32 and np.array_equal(_u32(got), want)
    # and against Python ints
    ai, bi = JF.to_ints(a), JF.to_ints(b)
    ref = {"add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P,
           "mul": lambda x, y: x * y % P, "mul_mont": lambda x, y: x * y % P}[op]
    assert list(TF.to_ints(got)) == [ref(int(x), int(y)) for x, y in zip(ai, bi)]


@pytest.mark.parametrize("op", ["neg", "sqr", "inv", "to_mont", "from_mont"])
def test_unary_ops_match_jax(op):
    a = np.asarray(JF.from_ints(_values(32, seed=2)), dtype=np.uint32)
    want = np.asarray(getattr(JF, op)(a))
    assert np.array_equal(_u32(getattr(TF, op)(_port(a))), want)


def test_mul_in_chunks_is_the_whole_product(monkeypatch):
    """Above _MUL_BYTES // 256 elements `mul` runs a chunk at a time (a
    ragged last chunk included, and a broadcast operand): the same words as
    one pass."""
    from icicle_tpu_torch.math import gl64 as G
    a = TF.from_ints(_values(24, seed=21), CPU)   # the 13 edges and 24 more: 37
    b = TF.from_ints(_values(24, seed=22), CPU)
    assert a.shape == (37, 2)
    whole, scaled = TF.mul(a, b), TF.mul(a, b[:1])
    monkeypatch.setattr(G, "_MUL_BYTES", 256 * 8)   # chunks of 8 elements
    assert torch.equal(TF.mul(a, b), whole)
    assert torch.equal(TF.mul(a, b[:1]), scaled)
    assert torch.equal(TF.mul(a.view(37, 1, 2), b.view(1, 37, 2)),
                       G.Goldilocks._mul(a.view(37, 1, 2), b.view(1, 37, 2)))


def test_pow_eq_is_zero_const_match_jax():
    a = np.asarray(JF.from_ints(_values(16, seed=3)), dtype=np.uint32)
    for e in (0, 1, 2, 7, 12345, P - 2):
        assert np.array_equal(_u32(TF.pow_const(_port(a), e)), np.asarray(JF.pow_const(a, e))), e
    b = a.copy()
    b[5:] = np.asarray(JF.from_ints([3]), dtype=np.uint32)
    assert np.array_equal(TF.eq(_port(a), _port(b)).numpy(), np.asarray(JF.eq(a, b)))
    assert np.array_equal(TF.is_zero(_port(a)).numpy(), np.asarray(JF.is_zero(a)))
    for v in (0, 5, P - 1, P + 3):
        assert np.array_equal(_u32(TF.const(v, (3,), CPU)), np.asarray(JF.const(v, (3,))))


def test_conversions_and_rand_match_jax():
    vals = _values(8, seed=4)
    assert np.array_equal(_u32(TF.from_ints(vals, CPU)), np.asarray(JF.from_ints(vals)))
    assert list(TF.to_ints(TF.from_ints(vals, CPU))) == [v % P for v in vals]
    got = TF.rand(np.random.default_rng(5), (3, 4), CPU)
    assert got.shape == (3, 4, 2)
    assert np.array_equal(_u32(got), np.asarray(JF.rand(np.random.default_rng(5), (3, 4))))
    with pytest.raises(IcicleException, match="not canonical"):
        interop.elements_from_numpy(TF, np.array([[1, 0xFFFFFFFF]], dtype=np.uint32))


def _jax_ntt(x, direction, ordering="NN", jit=False, coset_gen=None):
    cfg = jcfg.NTTConfig(ordering=jcfg.Ordering(ordering), coset_gen=coset_gen, backend="xla")
    return np.asarray((JN.ntt_jit if jit else JN.ntt)(JF, x, jcfg.NTTDir(direction), cfg))


def _port_ntt(x, direction, ordering="NN", jit=False, coset_gen=None):
    cfg = NTTConfig(ordering=Ordering(ordering), coset_gen=coset_gen)
    return _u32((TN.ntt_jit if jit else TN.ntt)(TF, _port(x), NTTDir(direction), cfg))


def _vec(shape, seed):
    return np.asarray(JF.rand(np.random.default_rng(seed), shape), dtype=np.uint32)


@pytest.mark.parametrize("logn", [3, 5])
def test_ntt_matches_jax(logn):
    x = _vec((1 << logn,), seed=10 + logn)
    for direction in ("forward", "inverse"):
        assert np.array_equal(_port_ntt(x, direction), _jax_ntt(x, direction)), direction
    assert np.array_equal(_port_ntt(x, "forward", coset_gen=7),
                          _jax_ntt(x, "forward", coset_gen=7))


def test_ntt_orderings_match_jax():
    x = _vec((32,), seed=20)
    for ordering in [o.value for o in Ordering]:
        assert np.array_equal(_port_ntt(x, "forward", ordering), _jax_ntt(x, "forward", ordering))


def test_ntt_jit_round_trip_matches_jax():
    """tests/test_ntt.py:109: 2^6 through ntt_jit and back; lane 0 is the sum."""
    x = _vec((64,), seed=3)
    fwd = _port_ntt(x, "forward", jit=True)
    assert np.array_equal(fwd, _jax_ntt(x, "forward", jit=True))
    assert np.array_equal(_port_ntt(fwd, "inverse", jit=True), x)
    assert int(JF.to_ints(fwd)[0]) == sum(int(v) for v in JF.to_ints(x)) % P


def test_ntt_batch_matches_jax():
    x = _vec((3, 64), seed=30)
    for direction in ("forward", "inverse"):
        assert np.array_equal(_port_ntt(x, direction), _jax_ntt(x, direction)), direction


def test_four_step_2_16_against_ct_stages():
    logn = 16
    x = TF.rand(np.random.default_rng(40), (1 << logn,), CPU)
    y = TN.ntt(TF, x)
    dom = TN.get_domain(TF, logn, CPU)
    rev = TN._bit_reverse_index(1 << logn, CPU)
    assert torch.equal(y, TN._ct_stages(TF, x.index_select(0, rev), dom.twiddles, logn))
    assert torch.equal(TN.ntt(TF, y, NTTDir.INVERSE), x)
    # the domain's twiddles are plain powers of w (goldilocks has no
    # Montgomery form), as the JAX package's
    w = TF.omega(logn)
    assert [int(v) for v in TF.to_ints(dom.twiddles[:4])] == [pow(w, i, P) for i in range(4)]


def test_vec_ops_match_jax():
    a, b = _pairs(seed=50)
    a, b = a[:33], b[:33]
    s = a[7]
    for name in ("vector_add", "vector_sub", "vector_mul", "vector_div"):
        bb = b if name != "vector_div" else np.where(JF.is_zero(b)[..., None], a, b)
        want = np.asarray(getattr(JV, name)(JF, a, bb))
        assert np.array_equal(_u32(getattr(TV, name)(TF, _port(a), _port(bb))), want), name
    for name in ("scalar_add_vec", "scalar_sub_vec", "scalar_mul_vec"):
        want = np.asarray(getattr(JV, name)(JF, s, a))
        assert np.array_equal(_u32(getattr(TV, name)(TF, _port(s), _port(a))), want), name
    batch = np.stack([a[:21], a[12:33]])
    for name in ("vector_sum", "vector_product"):
        want = np.asarray(getattr(JV, name)(JF, batch))
        assert np.array_equal(_u32(getattr(TV, name)(TF, _port(batch))), want), name
    want = int(JV.highest_non_zero_idx(JF, a))
    assert int(TV.highest_non_zero_idx(TF, _port(a))) == want


def test_protocol_kernels_refuse_goldilocks():
    """execute_program (K4), fri_fold (K2) and sumcheck_round (K3) serve
    single-word fields only: goldilocks raises before a launch."""
    for fn, args in ((fri_kernel.route, ()),
                     (sumcheck_kernel.route, (ReturningValueProgram(PreDefined.AB_MINUS_C), 3, 2)),
                     (program_kernel.route, (Program(PreDefined.AB_MINUS_C),))):
        with pytest.raises(IcicleException) as e:
            fn(TF, *args)
        assert e.value.code == IcicleError.API_NOT_IMPLEMENTED
        assert "queue A item 6" in str(e.value)
