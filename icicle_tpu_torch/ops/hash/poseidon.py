"""Poseidon, the original Filecoin-optimised hash (counterpart of
icicle_tpu/ops/hash/poseidon.py; reference F7: include/icicle/hash/
poseidon.h and the CPU backend cpu_poseidon.cpp; constants in
data/poseidon_*.npz, byte-for-byte copies of the JAX package's).

The constants are the optimised form: round constants | MDS | pre_matrix |
sparse matrices. The permutation, as cpu_poseidon.cpp computes it (the
S-box is x^5 for every field; the JAX package hard-codes it):
  state += rc[0:t]                                   (pre-round constants)
  (half - 1) full rounds:  x^5 on every lane; += rc; x MDS
  1 pre-matrix round:      x^5 on every lane; += rc; x pre_matrix
  partial rounds:          x^5 on lane 0; lane 0 += rc; x sparse[i]
  (half - 1) full rounds
  a last round:            x^5 on every lane; x MDS   (no constants)
and the digest is lane 1. A matrix product is out_c = sum_r s_r M[r, c]; a
sparse matrix is stored as its column 0 (t values) then the rest of its
row 0 (t - 1 values): out_0 = <s, col0>, out_j = s_0 row0[j - 1] + s_j.

There is no sponge: a hash takes exactly t inputs, or t - 1 with a domain
tag, which then fills lane 0 (cpu_poseidon.cpp:130-135). States stay in
Montgomery form for the whole permutation. `hash_fields` and `hash_words`
run on their input's device through the dispatcher's api "poseidon":
backend "torch" is the plain version `Poseidon.hash_fields_ref` (a Python
loop over the rounds over `Field.add` / `mul_mont`, in the JAX package's
op order), backend "cuda" the kernel (kernels/poseidon_kernel.py), which
computes the plain version for a CPU tensor.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from icicle_tpu_torch.fields.field import Field, get_field
from icicle_tpu_torch.kernels import poseidon_kernel
from icicle_tpu_torch.ops.hash.hash import Hash
from icicle_tpu_torch.runtime import dispatcher
from icicle_tpu_torch.runtime.config import HashConfig
from icicle_tpu_torch.runtime.device import canonical
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

API = "poseidon"
_DATA = os.path.join(os.path.dirname(__file__), "data")


@functools.lru_cache(maxsize=None)
def _load_constants(field_name: str) -> dict:
    path = os.path.join(_DATA, f"poseidon_{field_name}.npz")
    if not os.path.exists(path):
        raise ValueError(f"no poseidon constants for field {field_name}")
    with np.load(path) as data:
        return dict(data)


def supported_widths(field_name: str) -> list[int]:
    return [int(t) for t in _load_constants(field_name)["arities"]]


def _from_limb_rows(f: Field, rows: np.ndarray) -> torch.Tensor:
    """(N, L) uint32 limb rows -> CPU element tensor in the field's layout."""
    a = rows[:, 0] if f.limb_shape == () else rows[:, :f.nlimbs]
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


@dataclasses.dataclass(frozen=True)
class PoseidonConstants:
    """One width's constants in Montgomery form on one device, shared by
    every domain tag. `table` is all of them, flat: the round constants
    (every round's, in order), MDS, pre_matrix and the sparse matrices, the
    array the kernel reads; the rest are views of it."""

    table: torch.Tensor          # (2 half t + partial + 2 t^2 + partial (2t - 1),)+lim
    rc_pre: torch.Tensor         # (t,)+lim
    rc_full_top: torch.Tensor    # (half - 1, t)+lim
    rc_pre_matrix: torch.Tensor  # (t,)+lim
    rc_partial: torch.Tensor     # (partial,)+lim
    rc_full_bot: torch.Tensor    # (half - 1, t)+lim
    mds: torch.Tensor            # (t, t)+lim: out_c = sum_r s_r mds[r, c]
    pre_matrix: torch.Tensor     # (t, t)+lim
    sparse: torch.Tensor         # (partial, 2t - 1)+lim: column 0, then row 0's rest


@functools.lru_cache(maxsize=None)
def _constants(field_name: str, t: int, device: torch.device) -> PoseidonConstants:
    """Built once per (field, width, device): on the CPU, then moved."""
    f = get_field(field_name)
    data = _load_constants(field_name)
    _, half, partial, _ = (int(v) for v in data[f"t{t}_meta"])
    lim = f.limb_shape
    parts = [f.to_mont(_from_limb_rows(f, data[f"t{t}_{k}"]))
             for k in ("rc", "mds", "pre", "sparse")]
    table = torch.cat(parts).contiguous().to(device)
    views, o = [], 0
    for shape in [(t,), (half - 1, t), (t,), (partial,), (half - 1, t), (t, t), (t, t),
                  (partial, 2 * t - 1)]:
        n = int(np.prod(shape))
        views.append(table[o:o + n].view(shape + lim))
        o += n
    assert o == table.shape[0], (field_name, t)
    return PoseidonConstants(table, *views)


@functools.lru_cache(maxsize=None)
def _tag_mont(field_name: str, domain_tag: int, device: torch.device) -> torch.Tensor:
    """A domain tag in Montgomery form, ()+lim, on `device`."""
    f = get_field(field_name)
    return f.to_mont(f.from_ints([domain_tag], device=torch.device("cpu")))[0].to(device)


class Poseidon(Hash):
    """One fixed-width Poseidon hasher over a field (reference
    create_poseidon_hash)."""

    def __init__(self, field: Field | str, t: int, domain_tag: int | None = None):
        f = get_field(field) if isinstance(field, str) else field
        self.field = f
        self.t = t
        self.domain_tag = domain_tag
        data = _load_constants(f.name)
        if t not in supported_widths(f.name):
            raise ValueError(f"unsupported poseidon width t={t} for {f.name}")
        self.full, self.half, self.partial, self.alpha = (int(v) for v in data[f"t{t}_meta"])
        self._lane = -1 - len(f.limb_shape)  # the lane axis of a state
        el_words = 1 if f.limb_shape == () else f.nlimbs
        self.digest_words = el_words
        self.arity = t - (domain_tag is not None)
        self.default_input_words = self.arity * el_words

    def constants(self, device) -> PoseidonConstants:
        """This width's Montgomery-form constants on `device`."""
        return _constants(self.field.name, self.t, canonical(torch.device(device)))

    def tag_mont(self, device) -> torch.Tensor | None:
        """The domain tag in Montgomery form on `device`, ()+lim, or None
        without one."""
        if self.domain_tag is None:
            return None
        return _tag_mont(self.field.name, self.domain_tag, canonical(torch.device(device)))

    # -- the plain version: the JAX package's op order (Montgomery domain) -----
    def _sbox(self, x):
        mul = self.field.mul_mont
        x2 = mul(x, x)
        return mul(mul(x2, x2), x)  # x^5 (cpu_poseidon.cpp:93)

    def _lane_sum(self, x, d: int):
        f = self.field
        tot = x.select(d, 0)
        for j in range(1, x.shape[d]):
            tot = f.add(tot, x.select(d, j))
        return tot

    def _matmul(self, s, mat):
        """(..., t)+lim states times a (t, t)+lim matrix: out_c = sum_r s_r
        M[r, c] (JAX `_matmul`)."""
        d = self._lane
        return self._lane_sum(self.field.mul_mont(s.unsqueeze(d), mat), d - 1)

    def _sparse_mul(self, s, sp):
        """The sparse matrix sp ((2t - 1,)+lim: column 0, then row 0's rest)
        applied to (..., t)+lim states (JAX `_sparse_mul`)."""
        f, d, t = self.field, self._lane, self.t
        out0 = self._lane_sum(f.mul_mont(s, sp[:t]), d)
        s0 = s.narrow(d, 0, 1)
        rest = f.add(f.mul_mont(s0, sp[t:]), s.narrow(d, 1, t - 1))
        return torch.cat([out0.unsqueeze(d), rest], d)

    def _full_round(self, s, rc, mat):
        return self._matmul(self.field.add(self._sbox(s), rc), mat)

    def permute_ref(self, s: torch.Tensor) -> torch.Tensor:
        """The permutation of Montgomery-form states (batch, t)+lim, in plain
        torch on s's device."""
        f, d = self.field, self._lane
        c = self.constants(s.device)
        s = f.add(s, c.rc_pre)
        for rc in c.rc_full_top:
            s = self._full_round(s, rc, c.mds)
        s = self._full_round(s, c.rc_pre_matrix, c.pre_matrix)
        for rc, sp in zip(c.rc_partial, c.sparse):
            s0 = f.add(self._sbox(s.select(d, 0)), rc)
            s = self._sparse_mul(torch.cat([s0.unsqueeze(d), s.narrow(d, 1, self.t - 1)], d),
                                 sp)
        for rc in c.rc_full_bot:
            s = self._full_round(s, rc, c.mds)
        return self._matmul(self._sbox(s), c.mds)

    def hash_fields_ref(self, x: torch.Tensor) -> torch.Tensor:
        """`hash_fields` in plain torch on x's device: (batch, arity)+lim
        canonical elements -> (batch,)+lim canonical digests."""
        f, d = self.field, self._lane
        lim = f.limb_shape
        self._check_arity(x)
        xm = f.to_mont(x)
        tag = self.tag_mont(x.device)
        if tag is not None:
            xm = torch.cat([tag.expand(x.shape[:x.dim() + d] + (1,) + lim), xm], d)
        return f.from_mont(self.permute_ref(xm).select(d, 1))

    def _check_arity(self, x: torch.Tensor) -> None:
        lim = self.field.limb_shape
        if x.dim() != 2 + len(lim) or tuple(x.shape[2:]) != lim:
            want = "(batch, n)" if not lim else f"(batch, n, {lim[0]})"
            raise IcicleException(IcicleError.INVALID_ARGUMENT,
                                  f"poseidon takes {want} elements, got {tuple(x.shape)}")
        if x.shape[1] != self.arity:
            raise IcicleException(
                IcicleError.INVALID_ARGUMENT,
                f"poseidon t={self.t}: expected {self.arity} input elements, got "
                f"{x.shape[1]} (sponge is unsupported, matching cpu_poseidon.cpp:130-135)")

    # -- entry points ------------------------------------------------------------
    def hash_fields(self, x: torch.Tensor, cfg: HashConfig | None = None) -> torch.Tensor:
        """(batch, arity)+lim int32 canonical elements -> (batch,)+lim
        digests, on x's device; arity = t, or t - 1 with a domain tag."""
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
            raise IcicleException(IcicleError.INVALID_ARGUMENT,
                                  "poseidon takes an int32 element tensor")
        self._check_arity(x)
        return dispatcher.dispatch(API, None if cfg is None else cfg.backend, x)(self, x)

    def hash_words(self, x: torch.Tensor, cfg: HashConfig | None = None) -> torch.Tensor:
        """(batch, arity * digest_words) int32 -> (batch, digest_words)
        int32: the rows read as elements (views, no copy), one digest a
        row."""
        w = self.digest_words
        if not isinstance(x, torch.Tensor) or x.dim() != 2 or x.shape[1] % w:
            raise IcicleException(IcicleError.INVALID_ARGUMENT,
                                  f"poseidon hash_words takes (batch, k * {w}) words, "
                                  f"got {getattr(x, 'shape', type(x))}")
        batch, in_words = x.shape
        elems = x.reshape((batch, in_words // w) + self.field.limb_shape)
        return self.hash_fields(elems, cfg).reshape(batch, w)


def create_poseidon(field, t: int, domain_tag: int | None = None) -> Poseidon:
    """Mirror of reference create_poseidon_hash (poseidon.h)."""
    return Poseidon(field, t, domain_tag)


dispatcher.register_impl(API, dispatcher.TORCH, Poseidon.hash_fields_ref)
dispatcher.register_impl(API, dispatcher.CUDA, poseidon_kernel.poseidon)
