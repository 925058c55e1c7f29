"""The protocol kernels' wrappers (K1 keccak_kernel.py, K2 fri_kernel.py,
K3 sumcheck_kernel.py, K4 program_kernel.py) on the CPU: each route check
raises API_NOT_IMPLEMENTED for a multi-limb field, and refuses programs
past program.cuh's limits, before any launch (the checks are plain
functions, callable without a card); the packed `Code` has program.cuh's
layout; the build names the four sources; a CPU tensor takes the plain
version through the wrappers and the dispatcher. Tolerance: exact."""

import ctypes

import numpy as np
import pytest
import torch

from icicle_tpu_torch import Keccak256, get_field
from icicle_tpu_torch.kernels import build, fri_kernel, keccak_kernel, program_kernel
from icicle_tpu_torch.kernels import protocol_lib, sumcheck_kernel
from icicle_tpu_torch.ops import fri, sumcheck, vec_ops
from icicle_tpu_torch.ops.program import PreDefined, Program, ReturningValueProgram
from icicle_tpu_torch.runtime import dispatcher
from icicle_tpu_torch.runtime.config import HashConfig, VecOpsConfig
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

MULTI_LIMB = ["bn254_scalar", "bls12_381_scalar", "stark252", "bw6_761_scalar"]
AB = ReturningValueProgram(PreDefined.AB_MINUS_C)


def _not_implemented(fn, *args):
    with pytest.raises(IcicleException) as e:
        fn(*args)
    assert e.value.code == IcicleError.API_NOT_IMPLEMENTED
    assert "queue A item 6" in str(e.value)


@pytest.mark.parametrize("fname", MULTI_LIMB)
def test_multi_limb_fields_have_no_kernel_route(fname):
    f = get_field(fname)
    _not_implemented(fri_kernel.route, f)
    _not_implemented(sumcheck_kernel.route, f, AB, 3, 2)
    _not_implemented(program_kernel.route, f, Program(PreDefined.AB_MINUS_C))


def test_m31_has_no_fold_but_has_sumcheck_and_program():
    f = get_field("m31")
    _not_implemented(fri_kernel.route, f)
    assert sumcheck_kernel.route(f, AB, 3, 2)[0] == 0
    assert program_kernel.route(f, Program(PreDefined.EQ_X_AB_MINUS_C))[0] == 1


@pytest.mark.parametrize("fname", ["babybear", "koalabear"])
def test_word_fields_take_the_kernel_route(fname):
    f = get_field(fname)
    fri_kernel.route(f)
    kind, code = sumcheck_kernel.route(f, ReturningValueProgram(
        lambda v: v[0] * v[1].inverse() + 7, nof_inputs=2), 2, 2)
    assert kind == program_kernel.BYTECODE and code.n_consts == 1 and code.n_out == 1
    assert code.const_val[0] == (7 << 32) % f.modulus      # Montgomery form


def test_sumcheck_route_limits():
    f = get_field("babybear")
    with pytest.raises(IcicleException, match="at most 8 MLEs"):
        sumcheck_kernel.route(f, AB, 9, 2)
    with pytest.raises(IcicleException, match="degrees 1..6"):
        sumcheck_kernel.route(f, AB, 3, 7)
    with pytest.raises(IcicleException, match="reads input 2 of 2"):
        sumcheck_kernel.route(f, AB, 2, 2)


def test_program_route_limits():
    f = get_field("babybear")

    def long_chain(v):
        t = v[0]
        for _ in range(70):
            t = t * v[1]
        v[2] = t

    with pytest.raises(IcicleException) as e:
        program_kernel.route(f, Program(long_chain, 3))
    assert e.value.code == IcicleError.API_NOT_IMPLEMENTED
    with pytest.raises(IcicleException, match="parameters"):
        program_kernel.route(f, Program(lambda v: v.__setitem__(0, v[1] + v[2]), 17))


def test_code_has_program_cuh_layout():
    """3 ints, 64 instruction words, 16 constants, 16 constant slots and 8
    output slots: 356 bytes, 4-byte aligned, as the kernels read it."""
    assert ctypes.sizeof(program_kernel.Code) == 3 * 4 + 64 * 4 + 16 * 4 + 16 + 8
    assert ctypes.alignment(program_kernel.Code) == 4


def test_make_code_reads_only_the_parameters_used():
    f = get_field("babybear")

    def prog(v):
        v[3] = v[2].inverse() * 5    # INV reads one operand: slot 0 is not read
    kind, code, reads = program_kernel.make_code("program", f, Program(prog, 4))
    assert reads == [2]
    assert program_kernel.program_monts(f, Program(prog, 4)) == 1 + 32 + bin(f.modulus - 2).count("1")


def test_build_names_the_four_sources():
    for name, src in (("keccak", "keccak.cu"), ("fri_fold", "fri_fold.cu"),
                      ("sumcheck", "sumcheck.cu"), ("program", "program.cu")):
        assert build.LIBRARIES[name] == [src]
    headers = {p.split("/")[-1] for p in build._inputs("sumcheck")}
    assert {"mont32.cuh", "program.cuh"} <= headers


def test_cpu_tensors_take_the_plain_versions():
    """No launch is counted for CPU tensors, whatever backend is named."""
    f = get_field("babybear")
    counts = (keccak_kernel.keccak.launches, fri_kernel.fri_fold.launches,
              sumcheck_kernel.sumcheck_round.launches,
              program_kernel.execute_program_kernel.launches)
    x = torch.zeros((2, 3), dtype=torch.int32)
    h = Keccak256()
    assert torch.equal(h.hash_words(x, HashConfig(backend="cuda")),
                       keccak_kernel.keccak_ref(h, x))
    assert torch.equal(h.hash_words(x, HashConfig(backend="torch")),
                       keccak_kernel.keccak_ref(h, x))
    m = f.from_ints(np.arange(12).reshape(3, 4).tolist(), "cpu")
    rp, _ = sumcheck_kernel.sumcheck_round(f, AB, 2, m, 5, True)
    assert torch.equal(rp, sumcheck_kernel.sumcheck_round_ref(f, AB, 2, m, 5, True)[0])
    data = [m[0], m[1], m[2], torch.zeros_like(m[0])]
    prog = Program(PreDefined.AB_MINUS_C)
    for backend in ("cuda", "torch", None):
        out = vec_ops.execute_program(f, prog, data, VecOpsConfig(backend=backend))
        assert torch.equal(out[-1], program_kernel.execute_program_ref(f, prog, data)[0])
    assert counts == (keccak_kernel.keccak.launches, fri_kernel.fri_fold.launches,
                      sumcheck_kernel.sumcheck_round.launches,
                      program_kernel.execute_program_kernel.launches)


PROTOCOL_APIS = [
    (fri.FOLD_API, fri_kernel.fri_fold_ref, fri_kernel.fri_fold),
    (sumcheck.ROUND_API, sumcheck_kernel.sumcheck_round_ref, sumcheck_kernel.sumcheck_round),
    (vec_ops.PROGRAM_API, program_kernel.execute_program_ref,
     program_kernel.execute_program_kernel),
]


@pytest.mark.parametrize("api,plain,kernel", PROTOCOL_APIS, ids=[a for a, _, _ in PROTOCOL_APIS])
def test_protocol_apis_dispatch_to_kernel_or_plain_version(api, plain, kernel):
    """The ops reach K2-K4 through the dispatcher: "torch" is the plain
    version, "cuda" the kernel's wrapper, "auto" follows the tensor's
    device, and a backend that is not registered raises."""
    x = torch.zeros(4, dtype=torch.int32)
    assert dispatcher.dispatch(api, "torch", x) is plain
    assert dispatcher.dispatch(api, "cuda", x) is kernel
    assert dispatcher.dispatch(api, None, x) is plain
    assert dispatcher.dispatch(api, "auto", x) is plain
    with pytest.raises(IcicleException) as e:
        dispatcher.dispatch(api, "tpu", x)
    assert e.value.code == IcicleError.API_NOT_IMPLEMENTED


def test_wrappers_check_their_inputs():
    f = get_field("babybear")
    tw = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(IcicleException, match="does not cover"):
        fri_kernel.fri_fold(f, torch.zeros(16, dtype=torch.int32), 1, tw, 1)
    with pytest.raises(IcicleException, match="power of two"):
        fri_kernel.fri_fold(f, torch.zeros(6, dtype=torch.int32), 1, tw, 1)
    with pytest.raises(IcicleException, match="power of two >= 4"):
        sumcheck_kernel.sumcheck_round(f, AB, 2, torch.zeros((3, 2), dtype=torch.int32), 1, True)
    with pytest.raises(IcicleException, match="expected 4 vectors"):
        program_kernel.execute_program_kernel(f, Program(PreDefined.AB_MINUS_C),
                                              [torch.zeros(4, dtype=torch.int32)] * 3)
    with pytest.raises(IcicleException, match="int32"):
        keccak_kernel.keccak(Keccak256(), torch.zeros((2, 2), dtype=torch.int64))


def test_mont_int_and_permutation_count():
    f = get_field("koalabear")
    assert protocol_lib.mont_int(f, 1) == f.params.r
    # 24 rounds of 178 three-input logic and shift instructions, and iota's
    # XORs on the 24 low and 13 high round-constant halves that are not 0
    assert keccak_kernel.PERMUTATION_OPS == 24 * 178 + 24 + 13
