"""The port's programs and vector ops (icicle_tpu_torch/ops/program.py,
ops/vec_ops.py; kernel K4's plain version on the CPU) against the JAX
package's (icicle_tpu/ops/program.py, ops/vec_ops.py): bytecode and
constants word for word, `execute` and `execute_program` (the non-tail
slot case too), and every vec_ops function on babybear, koalabear and
bn254_scalar; `execute_program` over goldilocks too. Inputs come from numpy
seeds; tolerance: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from icicle_tpu.fields.field import get_field as jax_field
from icicle_tpu.ops import program as JP
from icicle_tpu.ops import vec_ops as JV
from icicle_tpu_torch import get_field
from icicle_tpu_torch.ops import program as PP
from icicle_tpu_torch.ops import vec_ops as PV
from icicle_tpu_torch.runtime import device

torch.set_num_threads(1)

FIELDS = ["babybear", "koalabear", "bn254_scalar"]


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))


def _ints(f, rng, shape, zeros=0):
    vals = [int.from_bytes(rng.bytes(40), "little") % f.modulus for _ in range(int(np.prod(shape)))]
    vals[:zeros] = [0] * zeros
    return np.array(vals, dtype=object).reshape(shape)


def _pair(fname, ints):
    """The same elements as a JAX array and a port tensor."""
    return jax_field(fname).from_ints(ints), get_field(fname).from_ints(ints, "cpu")


def _same(fname, jax_arr, port_t) -> bool:
    jf, pf = jax_field(fname), get_field(fname)
    return np.array_equal(np.asarray(jf.to_ints(jax_arr), dtype=object),
                          np.asarray(pf.to_ints(port_t), dtype=object))


# programs over 3 inputs: (name, lambda, nof_parameters) for Program; the
# lambdas of ReturningValueProgram take v[:3]
def _tail(v):
    v[3] = v[0] * v[1] - v[2]


def _non_tail(v):
    v[0] = v[1] * v[2]


def _two_outputs(v):
    t = v[0] + v[1]
    v[2] = t * t - 5
    v[3] = 3 - t.inverse()


def _output_is_input(v):
    v[3] = v[1]
    v[2] = v[0] * 7


def _const_output(v):
    v[1] = v[0] - v[0] + 11
    v[3] = PP.Symbol.constant(-2)


PROGRAMS = {"tail": (_tail, 4), "non_tail": (_non_tail, 3), "two_outputs": (_two_outputs, 4),
            "output_is_input": (_output_is_input, 4), "const_output": (_const_output, 4)}
COMBINES = {"const_inv": lambda v: v[0] * v[1].inverse() + 7 - v[2] * 3,
            "deg3": lambda v: v[0] * v[0] * v[1] + 3,
            "rsub": lambda v: 5 - v[2] * (v[0] + 2)}


def _programs(name):
    """(JAX program, port program) of one entry of PROGRAMS / COMBINES /
    the predefined ones."""
    if name in ("AB_MINUS_C", "EQ_X_AB_MINUS_C"):
        return (JP.ReturningValueProgram(JP.PreDefined[name]),
                PP.ReturningValueProgram(PP.PreDefined[name]))
    if name in COMBINES:
        return (JP.ReturningValueProgram(COMBINES[name], nof_inputs=3),
                PP.ReturningValueProgram(COMBINES[name], nof_inputs=3))
    func, nparams = PROGRAMS[name]
    if name == "const_output":
        def jfunc(v):
            v[1] = v[0] - v[0] + 11
            v[3] = JP.Symbol.constant(-2)
        return JP.Program(jfunc, nparams), PP.Program(func, nparams)
    return JP.Program(func, nparams), PP.Program(func, nparams)


ALL = ["AB_MINUS_C", "EQ_X_AB_MINUS_C", *PROGRAMS, *COMBINES]


@pytest.mark.parametrize("name", ALL)
def test_bytecode_and_constants_word_for_word(name):
    jp, pp = _programs(name)
    assert pp.to_bytecode() == jp.to_bytecode()
    assert pp.poly_degree == jp.poly_degree
    assert pp.nof_parameters == jp.nof_parameters
    if jp.predef is None:
        assert pp.constants == jp.constants
        # every constant and output slot is one the bytecode's register file has
        assert all(jp.nof_parameters <= s < pp.nof_slots for s in pp.constant_slots)
        assert all(0 <= s < pp.nof_slots for s in pp.output_slots)


def test_output_slots_name_the_values():
    """An output that is a parameter or a constant has no instruction: its
    slot is that parameter's or that constant's."""
    _, pp = _programs("output_is_input")     # outputs in slot order: v[2], v[3] = v[1]
    pp.to_bytecode()
    assert pp.output_slots[1] == 1
    _, pp = _programs("const_output")
    pp.to_bytecode()
    assert pp.output_slots[1] in pp.constant_slots


# bn254_scalar and goldilocks: three programs each, to keep the JAX compiles few
EXECUTE_CASES = ([(f, name) for f in ("babybear", "koalabear") for name in ALL]
                 + [("bn254_scalar", name) for name in ("AB_MINUS_C", "const_inv", "two_outputs")]
                 + [("goldilocks", name) for name in ("AB_MINUS_C", "EQ_X_AB_MINUS_C",
                                                      "const_inv")])


@pytest.mark.parametrize("fname,name", EXECUTE_CASES)
def test_execute_matches_jax(fname, name):
    jp, pp = _programs(name)
    rng = np.random.default_rng(len(name))
    ints = _ints(jax_field(fname), rng, (jp.nof_parameters, 8), zeros=2)
    jt, pt = _pair(fname, ints)
    jout = JV.execute_program(jax_field(fname), jp, [jt[i] for i in range(jp.nof_parameters)])
    pout = PV.execute_program(get_field(fname), pp, [pt[i] for i in range(pp.nof_parameters)])
    assert len(jout) == len(pout)
    for a, b in zip(jout, pout):
        assert _same(fname, a, b)


def test_execute_program_non_tail_slot_mapping():
    """The JAX package writes the outputs into the LAST parameter slots,
    whatever slot the lambda assigned: v[0] = v[1] * v[2] over (5, 7, 11)
    gives (5, 7, 77) in both packages."""
    jp, pp = _programs("non_tail")
    jt, pt = _pair("babybear", [[5], [7], [11]])
    jout = JV.execute_program(jax_field("babybear"), jp, [jt[0], jt[1], jt[2]])
    pout = PV.execute_program(get_field("babybear"), pp, [pt[0], pt[1], pt[2]])
    assert [int(np.asarray(v)[0]) for v in jout] == [5, 7, 77]
    assert [int(v[0]) for v in pout] == [5, 7, 77]


# -- vec_ops --------------------------------------------------------------------

def _vec_pair(fname, seed, shape=(2, 6), zeros=1):
    return _pair(fname, _ints(jax_field(fname), np.random.default_rng(seed), shape, zeros))


BINARY = ["vector_add", "vector_sub", "vector_mul", "vector_div", "vector_accumulate"]
SCALAR = ["scalar_add_vec", "scalar_sub_vec", "scalar_mul_vec"]


@pytest.mark.parametrize("fname", FIELDS)
def test_elementwise_ops_match_jax(fname):
    (ja, pa), (jb, pb) = _vec_pair(fname, 1), _vec_pair(fname, 2, zeros=0)
    jf, pf = jax_field(fname), get_field(fname)
    for op in BINARY:
        assert _same(fname, getattr(JV, op)(jf, ja, jb), getattr(PV, op)(pf, pa, pb)), op
    assert _same(fname, JV.vector_inv(jf, ja), PV.vector_inv(pf, pa))
    js, ps = _pair(fname, _ints(jf, np.random.default_rng(3), (2,)))
    for op in SCALAR:
        assert _same(fname, getattr(JV, op)(jf, js, ja), getattr(PV, op)(pf, ps, pa)), op
        assert _same(fname, getattr(JV, op)(jf, js[0], ja), getattr(PV, op)(pf, ps[0], pa)), op


@pytest.mark.parametrize("fname", FIELDS)
def test_reductions_match_jax(fname):
    jf, pf = jax_field(fname), get_field(fname)
    for n in (1, 5, 8):
        ja, pa = _vec_pair(fname, 10 + n, (3, n))
        assert _same(fname, JV.vector_sum(jf, ja), PV.vector_sum(pf, pa)), n
        assert _same(fname, JV.vector_product(jf, ja), PV.vector_product(pf, pa)), n


@pytest.mark.parametrize("fname", FIELDS)
def test_structural_ops_match_jax(fname):
    jf, pf = jax_field(fname), get_field(fname)
    ints = _ints(jf, np.random.default_rng(4), (2, 8))
    ints[0, 5:] = 0
    ints[1, :] = 0
    ja, pa = _pair(fname, ints)
    assert _same(fname, JV.slice_vec(jf, ja, 1, 3, 3), PV.slice_vec(pf, pa, 1, 3, 3))
    assert _same(fname, JV.bit_reverse(jf, ja), PV.bit_reverse(pf, pa))
    assert np.asarray(JV.highest_non_zero_idx(jf, ja)).tolist() == \
        PV.highest_non_zero_idx(pf, pa).tolist() == [4, -1]
    jflat, pflat = JV.to_flat(jf, ja, columns_batch=True), PV.to_flat(pf, pa, columns_batch=True)
    assert _same(fname, jflat, pflat)
    for cb in (False, True):
        assert _same(fname, JV.from_flat(jf, jflat, 8, 2, cb), PV.from_flat(pf, pflat, 8, 2, cb))


@pytest.mark.parametrize("fname", FIELDS)
def test_polynomial_eval_and_division_match_jax(fname):
    jf, pf = jax_field(fname), get_field(fname)
    (jc, pc), (jd, pd) = _vec_pair(fname, 5, (2, 5), 0), _vec_pair(fname, 6, (4,), 0)
    assert _same(fname, JV.polynomial_eval(jf, jc, jd), PV.polynomial_eval(pf, pc, pd))
    (jn, pn), (jq, pq) = _vec_pair(fname, 7, (7,), 0), _vec_pair(fname, 8, (3,), 0)
    jquot, jrem = JV.polynomial_division(jf, jn, jq)
    pquot, prem = PV.polynomial_division(pf, pn, pq)
    assert _same(fname, jquot, pquot) and _same(fname, jrem, prem)
    jz, pz = JV.polynomial_division(jf, jq, jn), PV.polynomial_division(pf, pq, pn)
    assert _same(fname, jz[0], pz[0]) and _same(fname, jz[1], pz[1])


def test_vector_sum_of_many_p_minus_1():
    """A sum whose running total wraps p many times: 1000 x (p - 1)."""
    pf = get_field("babybear")
    a = torch.full((3, 1000), pf.modulus - 1, dtype=torch.int32)
    want = (-1000) % pf.modulus
    assert PV.vector_sum(pf, a).tolist() == [want] * 3
    assert _same("babybear", JV.vector_sum(jax_field("babybear"), jnp.asarray(a.numpy().view(np.uint32))),
                 PV.vector_sum(pf, a))
