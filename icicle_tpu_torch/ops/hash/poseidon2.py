"""Poseidon2 (counterpart of icicle_tpu/ops/hash/poseidon2.py; reference F7:
include/icicle/hash/poseidon2.h and the CPU backend cpu_poseidon2.cpp;
constants in data/poseidon2_*.npz, byte-for-byte copies of the JAX
package's).

Permutation, the reference's round structure:
  1. the external matrix M_ext once,
  2. half_full full rounds: +RC on every lane, x^alpha on every lane, M_ext,
  3. partial_rounds rounds: +RC and x^alpha on lane 0, then M_int =
     all-ones + diag(d - 1) (out_i = sum(state) + (d_i - 1) s_i),
  4. half_full full rounds;
the digest is lane 1.

Sponge (input length != t, or != t - 1 with a domain tag): a zero state
whose lane 0 holds the tag or the first input; each block of t - 1 further
inputs is added into lanes 1..t-1 and permuted, the last block padded
[1, 0, ...].

States stay in Montgomery form for the whole hash (constants are converted
once), so every multiply is one Montgomery multiply. `hash_fields` runs on
its input's device through the dispatcher's api "poseidon2": backend
"torch" is the plain version `Poseidon2.hash_fields_ref` (a Python loop
over the rounds over `Field.add` / `mul_mont`), backend "cuda" the kernel
(kernels/poseidon2_kernel.py), which computes the plain version for a CPU
tensor.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from icicle_tpu_torch.fields.field import Field, get_field
from icicle_tpu_torch.kernels import poseidon2_kernel
from icicle_tpu_torch.ops.hash.hash import Hash
from icicle_tpu_torch.runtime import dispatcher
from icicle_tpu_torch.runtime.config import HashConfig
from icicle_tpu_torch.runtime.device import canonical
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

API = "poseidon2"
_DATA = os.path.join(os.path.dirname(__file__), "data")
SBOX_ALPHAS = (3, 5, 7, 9, 11)


@functools.lru_cache(maxsize=None)
def _load_constants(field_name: str) -> dict:
    path = os.path.join(_DATA, f"poseidon2_{field_name}.npz")
    if not os.path.exists(path):
        raise ValueError(f"no poseidon2 constants for field {field_name}")
    with np.load(path) as data:
        return dict(data)


def supported_arities(field_name: str) -> list[int]:
    return [int(t) for t in _load_constants(field_name)["arities"]]


def _from_limb_rows(f: Field, rows: np.ndarray) -> torch.Tensor:
    """(N, L) uint32 limb rows -> CPU element tensor in the field's layout."""
    a = rows[:, 0] if f.limb_shape == () else rows[:, :f.nlimbs]
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


@dataclasses.dataclass(frozen=True)
class Poseidon2Constants:
    """One width's constants in Montgomery form on one device. `rc` is every
    round's constants, flat (the kernel reads it); the three round groups are
    views of it."""

    rc: torch.Tensor           # (2 half_full t + partial_rounds,)+lim
    rc_full_top: torch.Tensor  # (half_full, t)+lim
    rc_partial: torch.Tensor   # (partial_rounds,)+lim
    rc_full_bot: torch.Tensor  # (half_full, t)+lim
    mds: torch.Tensor          # (t, t)+lim: out_i = sum_j mds[i, j] s_j
    diag_m1: torch.Tensor      # (t,)+lim: d - 1
    tag: torch.Tensor | None   # ()+lim, or None without a domain tag


@functools.lru_cache(maxsize=None)
def _constants(field_name: str, t: int, domain_tag: int | None,
               device: torch.device) -> Poseidon2Constants:
    """Built once per (field, width, tag, device): on the CPU, then moved."""
    f = get_field(field_name)
    data = _load_constants(field_name)
    _, half_full, partial_rounds, _ = (int(v) for v in data[f"t{t}_meta"])
    lim = f.limb_shape
    cpu = torch.device("cpu")
    one = f.const(1, batch_shape=(t,), device=cpu)
    rc = f.to_mont(_from_limb_rows(f, data[f"t{t}_rc"])).to(device)
    mds = f.to_mont(_from_limb_rows(f, data[f"t{t}_mds"])).reshape((t, t) + lim)
    diag_m1 = f.to_mont(f.sub(_from_limb_rows(f, data[f"t{t}_diag"]), one))
    tag = None
    if domain_tag is not None:
        tag = f.to_mont(f.from_ints([domain_tag], device=cpu))[0].to(device)
    top = half_full * t
    return Poseidon2Constants(
        rc=rc,
        rc_full_top=rc[:top].view((half_full, t) + lim),
        rc_partial=rc[top:top + partial_rounds],
        rc_full_bot=rc[top + partial_rounds:].view((half_full, t) + lim),
        mds=mds.contiguous().to(device), diag_m1=diag_m1.contiguous().to(device), tag=tag)


class Poseidon2(Hash):
    """One fixed-width Poseidon2 hasher over a field (reference
    create_poseidon2_hash / Poseidon2HasherCpu)."""

    def __init__(self, field: Field | str, t: int, domain_tag: int | None = None):
        f = get_field(field) if isinstance(field, str) else field
        self.field = f
        self.t = t
        self.domain_tag = domain_tag
        data = _load_constants(f.name)
        if t not in supported_arities(f.name):
            raise ValueError(f"unsupported poseidon2 width t={t} for {f.name}")
        _, self.half_full, self.partial_rounds, self.alpha = (
            int(v) for v in data[f"t{t}_meta"])
        if self.alpha not in SBOX_ALPHAS:
            raise ValueError(f"alpha {self.alpha}")
        self._lane = -1 - len(f.limb_shape)  # the lane axis of a state
        el_words = 1 if f.limb_shape == () else f.nlimbs
        self.digest_words = el_words
        self.default_input_words = (t - (domain_tag is not None)) * el_words

    def constants(self, device) -> Poseidon2Constants:
        """This width's Montgomery-form constants on `device`."""
        return _constants(self.field.name, self.t, self.domain_tag,
                          canonical(torch.device(device)))

    # -- the plain version: field-level permutation (Montgomery domain) -------
    def _sbox(self, x):
        mul = self.field.mul_mont
        x2 = mul(x, x)
        if self.alpha == 3:
            return mul(x2, x)
        x4 = mul(x2, x2)
        if self.alpha == 5:
            return mul(x4, x)
        if self.alpha == 7:
            return mul(mul(x4, x2), x)
        if self.alpha == 9:
            return mul(mul(x4, x4), x)
        return mul(mul(mul(x4, x4), x2), x)

    def _lane_sum(self, x):
        """Sum over the lane axis of (..., t)+lim by field adds."""
        f, d = self.field, self._lane
        tot = x.select(d, 0)
        for j in range(1, x.shape[d]):
            tot = f.add(tot, x.select(d, j))
        return tot

    def _matmul_ext(self, s, mds):
        """M_ext s per batch row: out_i = sum_j mds[i, j] s_j."""
        return self._lane_sum(self.field.mul_mont(s.unsqueeze(self._lane - 1), mds))

    def _matmul_int(self, s, diag_m1):
        """out_i = sum_j s_j + (d_i - 1) s_i."""
        f = self.field
        return f.add(self._lane_sum(s).unsqueeze(self._lane), f.mul_mont(diag_m1, s))

    def permute_ref(self, s: torch.Tensor) -> torch.Tensor:
        """The permutation of Montgomery-form states (batch, t)+lim, in plain
        torch on s's device."""
        f, d = self.field, self._lane
        c = self.constants(s.device)
        s = self._matmul_ext(s, c.mds)
        for rc in c.rc_full_top:
            s = self._matmul_ext(self._sbox(f.add(s, rc)), c.mds)
        for rc in c.rc_partial:
            s0 = self._sbox(f.add(s.select(d, 0), rc))
            s = self._matmul_int(torch.cat([s0.unsqueeze(d), s.narrow(d, 1, self.t - 1)], d),
                                 c.diag_m1)
        for rc in c.rc_full_bot:
            s = self._matmul_ext(self._sbox(f.add(s, rc)), c.mds)
        return s

    def hash_fields_ref(self, x: torch.Tensor) -> torch.Tensor:
        """`hash_fields` in plain torch on x's device: (batch, n)+lim
        canonical elements -> (batch,)+lim canonical digests."""
        f, d, t = self.field, self._lane, self.t
        lim = f.limb_shape
        batch = x.shape[:x.dim() + d]
        n = x.shape[d]
        xm = f.to_mont(x)
        tag = self.constants(x.device).tag
        if n == (t - 1 if tag is not None else t):
            s = xm if tag is None else torch.cat([tag.expand(batch + (1,) + lim), xm], d)
            out = self.permute_ref(s)
        else:
            out = self._sponge_ref(xm, tag)
        return f.from_mont(out.select(d, 1))

    def _sponge_ref(self, xm: torch.Tensor, tag: torch.Tensor | None) -> torch.Tensor:
        f, d, t = self.field, self._lane, self.t
        lim = f.limb_shape
        batch = xm.shape[:xm.dim() + d]
        n = xm.shape[d]
        if tag is not None:
            first, rest = tag.expand(batch + (1,) + lim), xm
        else:
            first, rest = xm.narrow(d, 0, 1), xm.narrow(d, 1, n - 1)
        zeros = functools.partial(torch.zeros, dtype=torch.int32, device=xm.device)
        s = torch.cat([first, zeros(batch + (t - 1,) + lim)], d)
        rem = rest.shape[d]
        nof_hashers = max(1, -(-rem // (t - 1)))
        pad_len = nof_hashers * (t - 1) - rem
        if pad_len:
            # reference padding: [1, 0, 0, ...] (cpu_poseidon2.cpp sponge)
            one = f.to_mont(f.const(1, batch_shape=batch + (1,), device=xm.device))
            rest = torch.cat([rest, one, zeros(batch + (pad_len - 1,) + lim)], d)
        for k in range(nof_hashers):
            block = rest.narrow(d, k * (t - 1), t - 1)
            s = torch.cat([s.narrow(d, 0, 1), f.add(s.narrow(d, 1, t - 1), block)], d)
            s = self.permute_ref(s)
        return s

    # -- entry points ------------------------------------------------------------
    def hash_fields(self, x: torch.Tensor, cfg: HashConfig | None = None) -> torch.Tensor:
        """(batch, n)+lim int32 canonical elements -> (batch,)+lim digests,
        on x's device. n == t (or t - 1 with a domain tag): one permutation;
        otherwise the sponge."""
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
            raise IcicleException(IcicleError.INVALID_ARGUMENT,
                                  "poseidon2 takes an int32 element tensor")
        return dispatcher.dispatch(API, None if cfg is None else cfg.backend, x)(self, x)

    def hash_words(self, x: torch.Tensor, cfg: HashConfig | None = None) -> torch.Tensor:
        """(batch, in_words) int32 -> (batch, digest_words) int32: the rows
        read as elements (views, no copy), one digest a row."""
        w = self.digest_words
        if (not isinstance(x, torch.Tensor) or x.dim() != 2 or x.shape[1] % w
                or x.shape[1] == 0):
            raise IcicleException(IcicleError.INVALID_ARGUMENT,
                                  f"poseidon2 hash_words takes (batch, k * {w}) words, "
                                  f"got {getattr(x, 'shape', type(x))}")
        batch, in_words = x.shape
        lim = self.field.limb_shape
        elems = x.reshape((batch, in_words // w) + lim)
        return self.hash_fields(elems, cfg).reshape(batch, w)


dispatcher.register_impl(API, dispatcher.TORCH, Poseidon2.hash_fields_ref)
dispatcher.register_impl(API, dispatcher.CUDA, poseidon2_kernel.poseidon2)
