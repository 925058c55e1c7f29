"""Program / Symbol: user-defined elementwise field computations
(counterpart of icicle_tpu/ops/program.py; reference F10:
include/icicle/program/{symbol.h, program.h, returning_value_program.h}).

A Symbol DFG is captured from a user lambda and compiled into u32 bytecode
(op | in1 << 8 | in2 << 16 | out << 24), word for word the JAX package's.
`execute` evaluates the DFG over the port's `Field` on tensors in plain
torch; kernels K3 (sumcheck_kernel.py) and K4 (program_kernel.py) run the
two predefined programs compiled in and any other from `to_bytecode()`,
which also records the slot of each constant (`constant_slots`, beside the
JAX package's `constants`) and of each output (`output_slots`: an output
that is a parameter or a constant has no instruction of its own).
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from icicle_tpu_torch.fields.field import Field


class Opcode(enum.IntEnum):
    # mirrors ProgramOpcode (symbol.h:12-23)
    COPY = 0
    ADD = 1
    MULT = 2
    SUB = 3
    INV = 4
    NOF_OPERATIONS = 5
    INPUT = 6
    CONST = 7


class PreDefined(enum.IntEnum):
    # mirrors PreDefinedPrograms (program.h:13-16)
    AB_MINUS_C = 0
    EQ_X_AB_MINUS_C = 1


@dataclasses.dataclass(frozen=True)
class _Node:
    opcode: Opcode
    a: "_Node | None" = None
    b: "_Node | None" = None
    const_val: int | None = None
    input_idx: int | None = None
    poly_degree: int = 0


class Symbol:
    """Operator-overloaded construction of a DFG (reference Symbol<S>)."""

    def __init__(self, node: _Node):
        self._node = node

    @staticmethod
    def input(idx: int) -> "Symbol":
        return Symbol(_Node(Opcode.INPUT, input_idx=idx, poly_degree=1))

    @staticmethod
    def constant(value: int) -> "Symbol":
        return Symbol(_Node(Opcode.CONST, const_val=value, poly_degree=0))

    def _coerce(self, other) -> "Symbol":
        if isinstance(other, Symbol):
            return other
        return Symbol.constant(int(other))

    def __add__(self, other):
        o = self._coerce(other)
        return Symbol(_Node(Opcode.ADD, self._node, o._node,
                            poly_degree=max(self._node.poly_degree, o._node.poly_degree)))

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        return Symbol(_Node(Opcode.SUB, self._node, o._node,
                            poly_degree=max(self._node.poly_degree, o._node.poly_degree)))

    def __rsub__(self, other):
        return self._coerce(other).__sub__(self)

    def __mul__(self, other):
        o = self._coerce(other)
        return Symbol(_Node(Opcode.MULT, self._node, o._node,
                            poly_degree=self._node.poly_degree + o._node.poly_degree))

    __rmul__ = __mul__

    def inverse(self):
        # the operand's degree, as the JAX package keeps it (inverse is not
        # polynomial)
        return Symbol(_Node(Opcode.INV, self._node, poly_degree=self._node.poly_degree))


class Program:
    """Executable program over field element tensors: from a lambda over
    `nof_parameters` Symbols, whose overwritten entries are the outputs, or
    from a PreDefined."""

    def __init__(self, func_or_predef, nof_parameters: int | None = None):
        if isinstance(func_or_predef, PreDefined):
            pre = func_or_predef
            if pre == PreDefined.AB_MINUS_C:
                self.nof_parameters = 4
                func = self._ab_minus_c
            else:
                self.nof_parameters = 5
                func = self._eq_x_ab_minus_c
            self.predef = pre
        else:
            assert nof_parameters is not None
            self.nof_parameters = nof_parameters
            func = func_or_predef
            self.predef = None

        params = [Symbol.input(i) for i in range(self.nof_parameters)]
        originals = list(params)
        func(params)
        # outputs = entries replaced by the lambda (reference
        # Program::generate_program marks output symbols)
        self.outputs = [s._node for s, o in zip(params, originals) if s is not o]
        if not self.outputs:
            raise ValueError("program lambda must assign at least one output")
        self.poly_degree = max(n.poly_degree for n in self.outputs)

    # predefined lambdas (program.h:13-16: results overwrite the LAST slots)
    @staticmethod
    def _ab_minus_c(v):
        v[3] = v[0] * v[1] - v[2]

    @staticmethod
    def _eq_x_ab_minus_c(v):
        v[4] = v[3] * (v[0] * v[1] - v[2])

    # -- execution ------------------------------------------------------------
    def execute(self, f: Field, inputs: list) -> list:
        """Evaluate the outputs over `nof_parameters` element tensors
        (broadcastable; constants are made on the first tensor's device).
        Returns a list of output tensors."""
        device = next((t.device for t in inputs if isinstance(t, torch.Tensor)), None)
        cache: dict[int, object] = {}

        def ev(n: _Node):
            key = id(n)
            if key in cache:
                return cache[key]
            if n.opcode == Opcode.INPUT:
                v = inputs[n.input_idx]
            elif n.opcode == Opcode.CONST:
                v = f.from_ints([n.const_val % f.modulus], device)[0]
            elif n.opcode == Opcode.ADD:
                v = f.add(ev(n.a), ev(n.b))
            elif n.opcode == Opcode.SUB:
                v = f.sub(ev(n.a), ev(n.b))
            elif n.opcode == Opcode.MULT:
                v = f.mul(ev(n.a), ev(n.b))
            elif n.opcode == Opcode.INV:
                v = f.inv(ev(n.a))
            elif n.opcode == Opcode.COPY:
                v = ev(n.a)
            else:
                raise ValueError(n.opcode)
            cache[key] = v
            return v

        return [ev(n) for n in self.outputs]

    # -- bytecode (program.h's instruction format) ----------------------------
    def to_bytecode(self) -> list[int]:
        """Encode as u32 instructions: op | in1 << 8 | in2 << 16 | out << 24.

        Slots [0, nof_parameters) are the parameters; constants and
        temporaries follow in the order they are met. Sets `constants`
        (values), `constant_slots` and `output_slots`."""
        if self.predef is not None:
            return [int(Opcode.NOF_OPERATIONS) + int(self.predef)]
        instrs: list[int] = []
        slot_of: dict[int, int] = {}
        next_slot = self.nof_parameters
        consts: list[int] = []
        const_slots: list[int] = []

        def emit(n: _Node) -> int:
            nonlocal next_slot
            key = id(n)
            if key in slot_of:
                return slot_of[key]
            if n.opcode == Opcode.INPUT:
                slot_of[key] = n.input_idx
                return n.input_idx
            if n.opcode == Opcode.CONST:
                slot = next_slot
                next_slot += 1
                consts.append(n.const_val)
                const_slots.append(slot)
                slot_of[key] = slot
                return slot
            a = emit(n.a)
            b = emit(n.b) if n.b is not None else 0
            slot = next_slot
            next_slot += 1
            instrs.append(int(n.opcode) | (a << 8) | (b << 16) | (slot << 24))
            slot_of[key] = slot
            return slot

        self.output_slots = [emit(out) for out in self.outputs]
        self.constants = consts
        self.constant_slots = const_slots
        self.nof_slots = next_slot
        return instrs


class ReturningValueProgram(Program):
    """Single-output program built from a value-returning lambda (reference
    returning_value_program.h): sumcheck combine functions."""

    def __init__(self, func_or_predef, nof_inputs: int | None = None):
        if isinstance(func_or_predef, PreDefined):
            super().__init__(func_or_predef)
            self.nof_inputs = self.nof_parameters - 1
            return
        assert nof_inputs is not None
        self.nof_inputs = nof_inputs

        def wrapper(v):
            v[nof_inputs] = func_or_predef(v[:nof_inputs])

        super().__init__(wrapper, nof_inputs + 1)

    def execute_one(self, f: Field, inputs: list):
        return self.execute(f, inputs)[0]
