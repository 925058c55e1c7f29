"""A field program elementwise over parameter vectors, over a hand-written
CUDA kernel (kernels/csrc/program.cu over program.cuh, kernel K4 of the
port).

`execute_program_kernel(f, program, data)` gives the program's outputs
over `data` (`program.nof_parameters` equal-size vectors): on CUDA vectors
of a single-word field one launch, one thread an element; on CPU vectors
the plain version `execute_program_ref` (`Program.execute`). No Pallas
kernel is replaced: the JAX package's `execute_program`
(icicle_tpu/ops/vec_ops.py:258) is XLA. `make_code` packs a program for
the kernels that evaluate it (K3 and K4): the two predefined programs by
their kind, any other as its bytecode (`Program.to_bytecode`), its
constants in Montgomery form and its output slots, within program.cuh's
limits (KERNEL_LIMITS).
"""

from __future__ import annotations

import ctypes

import torch

from icicle_tpu_torch.kernels import protocol_lib as L
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

LIBRARY = "program"
BYTECODE = 2  # program.cuh Kind; 0 and 1 are PreDefined's values
# program.cuh's kMaxParams, kMaxInstr, kMaxSlots, kMaxConsts, kMaxOutputs
KERNEL_LIMITS = {"parameters": 16, "instructions": 64, "slots": 64, "constants": 16,
                 "outputs": 8}
_OPS = 8  # bits of the opcode in an instruction word


class Code(ctypes.Structure):
    """program.cuh `Code`, passed by value to the kernels."""
    _fields_ = [("n_instr", ctypes.c_int), ("n_consts", ctypes.c_int), ("n_out", ctypes.c_int),
                ("instr", ctypes.c_uint32 * KERNEL_LIMITS["instructions"]),
                ("const_val", ctypes.c_uint32 * KERNEL_LIMITS["constants"]),
                ("const_slot", ctypes.c_uint8 * KERNEL_LIMITS["constants"]),
                ("out_slot", ctypes.c_uint8 * KERNEL_LIMITS["outputs"])]


def _too_big(kernel: str, what: str, have: int) -> IcicleException:
    return IcicleException(IcicleError.API_NOT_IMPLEMENTED,
                           f"{kernel}: the program has {have} {what}, the kernel takes at most "
                           f"{KERNEL_LIMITS[what]}")


def make_code(kernel: str, f, program) -> tuple[int, Code, list[int]]:
    """(kind, Code, the parameter slots the program reads) for `program`
    over field f; raises API_NOT_IMPLEMENTED past the kernel's limits."""
    instrs = program.to_bytecode()
    code = Code()
    if program.predef is not None:
        return int(program.predef), code, list(range(3 if program.predef == 0 else 4))
    sizes = {"parameters": program.nof_parameters, "instructions": len(instrs),
             "slots": program.nof_slots, "constants": len(program.constants),
             "outputs": len(program.output_slots)}
    for what, have in sizes.items():
        if have > KERNEL_LIMITS[what]:
            raise _too_big(kernel, what, have)
    code.n_instr, code.n_consts, code.n_out = len(instrs), len(program.constants), len(
        program.output_slots)
    reads = set(s for s in program.output_slots if s < program.nof_parameters)
    for i, w in enumerate(instrs):
        code.instr[i] = w
        unary = (w & ((1 << _OPS) - 1)) in (0, 4)  # COPY, INV read one operand
        for s in ((w >> 8) & 0xFF,) + (() if unary else ((w >> 16) & 0xFF,)):
            if s < program.nof_parameters:
                reads.add(s)
    for i, (v, s) in enumerate(zip(program.constants, program.constant_slots)):
        code.const_val[i] = L.mont_int(f, v % f.modulus)
        code.const_slot[i] = s
    for i, s in enumerate(program.output_slots):
        code.out_slot[i] = s
    return BYTECODE, code, sorted(reads)


def program_monts(f, program) -> int:
    """Montgomery multiplies of one evaluation (the bound's count): one a
    MULT, the square-and-multiply chain of p - 2 an INV (program.cuh runs
    32 squarings and a multiply a set bit)."""
    if program.predef is not None:
        return 1 if program.predef == 0 else 2
    inv = 32 + bin(f.modulus - 2).count("1")
    monts = 0
    for w in program.to_bytecode():
        op = w & ((1 << _OPS) - 1)
        monts += 1 if op == 2 else inv if op == 4 else 0
    return monts


def execute_program_ref(f, program, data: list) -> list:
    """The plain version: `program.execute` over the vectors, on their
    device."""
    return program.execute(f, data)


_ARGTYPES = ((ctypes.c_uint32,) + (ctypes.c_void_p,) * 2 + (ctypes.c_longlong,)
             + (ctypes.c_int,) * 2 + (ctypes.c_void_p,) * 2)


def _check(f, program, data: list) -> None:
    if len(data) != program.nof_parameters:
        raise L.invalid("program", f"expected {program.nof_parameters} vectors, got {len(data)}")
    lim = f.limb_shape
    for t in data:
        L.check_words("program", t, 1 + len(lim))
        if t.shape != data[0].shape or t.device != data[0].device:
            raise L.invalid("program", "the vectors differ in shape or device")


def route(f, program):
    """(kind, Code, the parameters it reads) of the kernel route, or the
    API_NOT_IMPLEMENTED it raises before a launch (a field the kernel is
    not built for, a program past program.cuh's limits)."""
    L.require_word_field("program", f)
    return make_code("program", f, program)


def execute_program_kernel(f, program, data: list) -> list:
    """The outputs of `program` over `data` (canonical element vectors).

    On CUDA vectors this launches the kernel on the current stream (no
    synchronisation), counts the launch in `execute_program_kernel.launches`
    and raises if the field or program has no kernel route or the launch is
    refused; on CPU vectors it computes `execute_program_ref`."""
    _check(f, program, data)
    if not data[0].is_cuda:
        return execute_program_ref(f, program, data)
    kind, code, reads = route(f, program)
    n = data[0].shape[0]
    n_out = 1 if kind != BYTECODE else code.n_out
    outs = [torch.empty_like(data[0]) for _ in range(n_out)]
    if n == 0:
        return outs
    ins = (ctypes.c_void_p * program.nof_parameters)(
        *(data[q].data_ptr() if q in reads else None for q in range(program.nof_parameters)))
    out_ptrs = (ctypes.c_void_p * n_out)(*(t.data_ptr() for t in outs))
    fn, error_string = L.entry(LIBRARY, "icicle_execute_program", _ARGTYPES)
    with torch.cuda.device(data[0].device):
        err = fn(f.modulus, ctypes.addressof(ins), ctypes.addressof(out_ptrs), n,
                 program.nof_parameters, kind, ctypes.addressof(code), L.stream())
    L.raise_on("program", err, error_string)
    execute_program_kernel.launches += 1
    return outs


execute_program_kernel.launches = 0
