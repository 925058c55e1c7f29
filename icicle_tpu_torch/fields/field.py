"""Field registry and the `Field` wrapper (counterpart of
icicle_tpu/fields/field.py).

The parameter table is the JAX package's (standard public constants, equal
to the reference's config values). `Field` serves every field of the
table, with the engine chosen as the JAX package chooses it:

  * single-word p < 2^31 (babybear, koalabear, m31) -> int32 tensors
    through :class:`icicle_tpu_torch.math.mont32.Mont32`;
  * goldilocks -> `(..., 2)` int32 word pairs [lo, hi] through
    :class:`icicle_tpu_torch.math.gl64.Goldilocks`;
  * multi-limb (bn254, bls12, bw6, grumpkin, stark252) -> `(..., L)` int32
    limb tensors through :class:`icicle_tpu_torch.math.bigint.BigField`.

Limbs and words hold uint32 bit patterns.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from icicle_tpu_torch.math.bigint import BigField
from icicle_tpu_torch.math.gl64 import GOLDILOCKS_P, Goldilocks
from icicle_tpu_torch.math.params import FieldParams
from icicle_tpu_torch.math.mont32 import Mont32
from icicle_tpu_torch.runtime.device import resolve

# ---------------------------------------------------------------------------
# Field parameter table. rou generates the maximal power-of-two subgroup
# (reference: `rou` members of each fp_config).
# ---------------------------------------------------------------------------
_PARAMS: dict[str, FieldParams] = {}


def _def(name: str, modulus: int, rou: int | None = None,
         nonresidue: int | None = None, generator: int | None = None):
    _PARAMS[name] = FieldParams(name=name, modulus=modulus, rou=rou,
                                nonresidue=nonresidue, generator=generator)


# STARK fields (reference include/icicle/fields/stark_fields/*.h)
_def("babybear", 0x78000001, rou=0x89, nonresidue=11)
_def("koalabear", 0x7F000001, rou=0x6AC49F88, nonresidue=3)
_def("m31", 0x7FFFFFFF, rou=0x7FFFFFFE, nonresidue=-1)
_def("goldilocks", GOLDILOCKS_P, rou=0x185629DCDA58878C, nonresidue=7)
_def("stark252",
     0x800000000000011000000000000000000000000000000000000000000000001,
     rou=0x5282DB87529CFA3F0464519C8B0FA5AD187148E11A61616070024F42F8EF94)

# SNARK fields (reference include/icicle/fields/snark_fields/*.h)
_BN254_R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
_BN254_Q = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
_def("bn254_scalar", _BN254_R,
     rou=0x2A3C09F0A58A7E8500E0A7EB8EF62ABC402D111E41112ED49BD61B6E725B19F0)
_def("bn254_base", _BN254_Q, nonresidue=-1)

_BLS12_377_R = 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001
_BLS12_377_Q = 0x1AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001
_def("bls12_377_scalar", _BLS12_377_R,
     rou=0x11D4B7F60CB92CC160C69477D1A8A12F9B506EE363E3F04A476EF4A4EC2A895E)
_def("bls12_377_base", _BLS12_377_Q,
     rou=0x36A92E05198A8030F152488AEFFC9B40FBE05B4512A3D4B44D994A0DDFF8C606DF0A4306FE0BC37ECA603CC563B9A1,
     nonresidue=-5)

_BLS12_381_R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
_BLS12_381_Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
_def("bls12_381_scalar", _BLS12_381_R,
     rou=0x212D79E5B416B6F0FD56DC8D168D6C0C4024FF270B3E0941B788F500B912F1F)
_def("bls12_381_base", _BLS12_381_Q, nonresidue=-1)

_BW6_761_Q = 0x122E824FB83CE0AD187C94004FAFF3EB926186A81D14688528275EF8087BE41707BA638E584E91903CEBAFF25B423048689C8ED12F9FD9071DCD3DC73EBFF2E98A116C25667A8F8160CF8AEEAF0A437E6913E6870000082F49D00000000008B
_def("bw6_761_scalar", _BLS12_377_Q,
     rou=_PARAMS["bls12_377_base"].rou)
_def("bw6_761_base", _BW6_761_Q, nonresidue=-1)

# grumpkin is the bn254 2-cycle: its scalar field is bn254's base and vice versa
_def("grumpkin_scalar", _BN254_Q)
_def("grumpkin_base", _BN254_R,
     rou=_PARAMS["bn254_scalar"].rou)


class Field:
    """Named prime field with canonical-form elementwise ops on int32 tensors
    (single-limb) or int32 limb tensors (goldilocks and multi-limb, trailing
    limb axis)."""

    def __init__(self, params: FieldParams):
        self.params = params
        self.name = params.name
        self.modulus = params.modulus
        self.nlimbs = params.nlimbs
        if params.modulus == GOLDILOCKS_P:
            self.engine = Goldilocks(params)
            self.limb_shape = (2,)
        elif params.bits <= 31:
            self.engine = Mont32(params)
            self.limb_shape = ()
        else:
            self.engine = BigField(params)
            self.limb_shape = (params.nlimbs,)

    # -- delegated arithmetic ------------------------------------------------
    def add(self, a, b):
        return self.engine.add(a, b)

    def sub(self, a, b):
        return self.engine.sub(a, b)

    def neg(self, a):
        return self.engine.neg(a)

    def mul(self, a, b):
        return self.engine.mul(a, b)

    def mul_mont(self, a, b):
        return self.engine.mul_mont(a, b)

    def to_mont(self, a):
        return self.engine.to_mont(a)

    def from_mont(self, a):
        return self.engine.from_mont(a)

    def sqr(self, a):
        return self.engine.sqr(a)

    def inv(self, a):
        return self.engine.inv(a)

    def pow_const(self, a, e: int):
        return self.engine.pow_const(a, e)

    def eq(self, a, b):
        return a == b if self.limb_shape == () else self.engine.eq(a, b)

    def is_zero(self, a):
        return a == 0 if self.limb_shape == () else self.engine.is_zero(a)

    # -- conversions (test/tooling boundary; numpy/python ints) ---------------
    def from_ints(self, values, device=None) -> torch.Tensor:
        """Python ints (nested lists / numpy object arrays) -> element tensor
        (multi-limb: little-endian uint32 limbs as int32 bit patterns)."""
        arr = np.asarray(values, dtype=object)
        flat = [int(v) % self.modulus for v in arr.reshape(-1)]
        if self.limb_shape == ():
            out = np.array(flat, dtype=np.int32).reshape(arr.shape)
        else:
            nbytes = 4 * self.nlimbs
            raw = b"".join(v.to_bytes(nbytes, "little") for v in flat)
            out = np.frombuffer(raw, dtype="<u4").astype(np.uint32).view(
                np.int32).reshape(arr.shape + self.limb_shape)
        return torch.from_numpy(out).to(resolve(device))

    def to_ints(self, t: torch.Tensor) -> np.ndarray:
        """Element tensor -> numpy object array of Python ints."""
        a = t.cpu().numpy()
        if self.limb_shape == ():
            return a.astype(object)
        rows = np.ascontiguousarray(a.view(np.uint32).astype("<u4")).reshape(
            -1, self.nlimbs)
        out = np.empty(rows.shape[0], dtype=object)
        for i, row in enumerate(rows):
            out[i] = int.from_bytes(row.tobytes(), "little")
        return out.reshape(a.shape[:-1])

    def element_shape(self, batch_shape=()) -> tuple:
        return tuple(batch_shape) + self.limb_shape

    def zeros(self, batch_shape=(), device=None) -> torch.Tensor:
        return torch.zeros(self.element_shape(batch_shape), dtype=torch.int32,
                           device=resolve(device))

    def const(self, value: int, batch_shape=(), device=None) -> torch.Tensor:
        if self.limb_shape == ():
            return torch.full(tuple(batch_shape), value % self.modulus,
                              dtype=torch.int32, device=resolve(device))
        return self.from_ints([value], device)[0].expand(
            self.element_shape(batch_shape))

    def rand(self, rng: np.random.Generator, batch_shape=(), device=None) -> torch.Tensor:
        """Uniform random canonical elements; draws the same bytes from `rng`
        as the JAX package's Field.rand, so one seed gives both the same
        elements."""
        n = int(np.prod(batch_shape)) if batch_shape else 1
        nbytes = (self.modulus.bit_length() + 64) // 8
        raw = rng.bytes(n * nbytes)
        big = [int.from_bytes(raw[i * nbytes:(i + 1) * nbytes], "little") % self.modulus
               for i in range(n)]
        arr = np.array(big, dtype=object).reshape(batch_shape if batch_shape else ())
        return self.from_ints(arr, device)

    def omega(self, logn: int) -> int:
        return self.params.omega(logn)

    @property
    def two_adicity(self) -> int:
        return self.params.two_adicity


@functools.lru_cache(maxsize=None)
def get_field(name: str) -> Field:
    if name not in _PARAMS:
        raise KeyError(f"unknown field {name!r}; known: {sorted(_PARAMS)}")
    return Field(_PARAMS[name])


def field_params(name: str) -> FieldParams:
    """The parameter table's entry, for every field name (ported or not)."""
    return _PARAMS[name]


def field_names() -> list[str]:
    return sorted(_PARAMS)
