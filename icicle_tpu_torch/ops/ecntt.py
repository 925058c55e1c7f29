"""ECNTT: the NTT over elliptic-curve points (counterpart of
icicle_tpu/ops/ecntt.py; reference F4: include/icicle/ecntt.h).

A radix-2 DIT over projective G1 point arrays (curves/group.py): a
butterfly multiplies its odd point by a twiddle SCALAR with a 2^4-ary
ladder and adds / subtracts. The ladder is GLV's joint one by default (two
16-entry tables, half the doublings of the plain ladder; curves/glv.py),
the plain one with ICICLE_TPU_ECNTT_GLV=0, as in the JAX package. Stage 1's
twiddle is 1 and skips the ladder. The orderings, the forward coset shift
and the inverse's fused n^-1 and coset unscale are JAX's `_ecntt_one`.

Backends (`NTTConfig.backend`): "torch" runs the plain stage and ladder
(kernels/ecntt_kernel.py `ecntt_stage_ref`, `ecntt_scale_ref`) on any
device; "cuda" the hand-written kernel (kernels/csrc/ecntt.cu): one launch
a stage, one a scale; "auto" (None) the kernel for a CUDA tensor. The
bit-reversal and the output permutations are index gathers on the device.

The twiddle digit rows are made on the host with Python ints and cached as
numpy per (curve, log n, direction), their device copies per device.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from icicle_tpu_torch.curves.glv import glv_decompose
from icicle_tpu_torch.curves.group import Group, Projective, get_group
from icicle_tpu_torch.curves.params import get_curve
from icicle_tpu_torch.kernels.ecntt_kernel import (WDIG, ecntt_scale, ecntt_scale_ref,
                                                   ecntt_stage, ecntt_stage_ref,
                                                   scalar_mul_vec, scalar_mul_vec_glv)
from icicle_tpu_torch.ops.ntt import _bit_reverse_index
from icicle_tpu_torch.runtime import dispatcher
from icicle_tpu_torch.runtime.config import NTTConfig, NTTDir, Ordering
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

__all__ = ["ecntt", "ecntt_jit", "scalar_mul_vec_glv", "scalar_mul_vec"]


def _ndig(nbits: int) -> int:
    return -(-nbits // WDIG)


def _digit_rows(vals, nbits: int) -> np.ndarray:
    """(ndig, len(vals)) int32 base-2^4 digit rows, most significant first,
    of non-negative Python ints below 2^nbits."""
    nd = _ndig(nbits)
    nb = -(-nd // 2)
    raw = b"".join(int(v).to_bytes(nb, "little") for v in vals)
    b = np.frombuffer(raw, dtype=np.uint8).reshape(len(vals), nb)
    nibbles = np.stack([b & 0xF, b >> 4], axis=-1).reshape(len(vals), 2 * nb)[:, :nd]
    return np.ascontiguousarray(nibbles[:, ::-1].T.astype(np.int32))


def _powers(f_modulus: int, w: int, count: int) -> list[int]:
    vals, cur = [], 1
    for _ in range(count):
        vals.append(cur)
        cur = (cur * w) % f_modulus
    return vals


def _glv_nbits(curve_name: str) -> int:
    """Digit-row bit width of the GLV half-scalars (JAX `_glv_nbits`)."""
    return (get_curve(curve_name).fr.modulus.bit_length() + 1) // 2 + 2


def _glv_rows(curve_name: str, vals):
    """Host GLV split of Python-int scalars -> (dig1, dig2 (ndig, n) int32;
    neg1, neg2 (n,) bool)."""
    k1s, k2s = zip(*(glv_decompose(curve_name, int(v)) for v in vals))
    nbits = _glv_nbits(curve_name)
    return (_digit_rows([abs(k) for k in k1s], nbits), _digit_rows([abs(k) for k in k2s], nbits),
            np.array([k < 0 for k in k1s]), np.array([k < 0 for k in k2s]))


def _stage_twiddles(curve_name: str, logn: int, inverse: bool) -> list[list[int]]:
    """The distinct twiddles w_s^0..w_s^(m-1) of stages s = 2..logn."""
    p = get_curve(curve_name).fr.modulus
    w = get_curve(curve_name).fr.params.omega(logn)
    if inverse:
        w = pow(w, -1, p)
    n = 1 << logn
    return [_powers(p, pow(w, n >> s, p), 1 << (s - 1)) for s in range(2, logn + 1)]


@functools.lru_cache(maxsize=None)
def _stage_digits(curve_name: str, logn: int, inverse: bool):
    """Plain-ladder digit rows a stage (ICICLE_TPU_ECNTT_GLV=0)."""
    nbits = get_curve(curve_name).fr.modulus.bit_length()
    return [_digit_rows(vals, nbits) for vals in _stage_twiddles(curve_name, logn, inverse)]


@functools.lru_cache(maxsize=None)
def _stage_glv(curve_name: str, logn: int, inverse: bool):
    """GLV ladder rows a stage s = 2..logn, covering its m distinct
    twiddles, as numpy (cached across devices)."""
    return [_glv_rows(curve_name, vals) for vals in _stage_twiddles(curve_name, logn, inverse)]


def _glv_enabled() -> bool:
    return os.environ.get("ICICLE_TPU_ECNTT_GLV", "1") != "0"


def _to_device(rows, device):
    if isinstance(rows, np.ndarray):
        return torch.from_numpy(rows).to(device)
    return tuple(torch.from_numpy(a).to(device) for a in rows)


@functools.lru_cache(maxsize=None)
def _stage_rows(curve_name: str, logn: int, inverse: bool, glv: bool, device) -> list:
    stages = (_stage_glv if glv else _stage_digits)(curve_name, logn, inverse)
    return [_to_device(r, device) for r in stages]


@functools.lru_cache(maxsize=8)
def _scale_rows(curve_name: str, n: int, coset_gen, inverse: bool, device):
    """GLV rows of lane j's scalar: g^j (forward coset shift), or n^-1 g^-j
    (n^-1 alone without a coset) for the inverse."""
    r = get_curve(curve_name).fr.modulus
    if not inverse:
        vals = _powers(r, coset_gen % r, n)
    else:
        n_inv = pow(n, -1, r)
        vals = ([n_inv] * n if coset_gen is None
                else [n_inv * v % r for v in _powers(r, pow(coset_gen % r, -1, r), n)])
    return _to_device(_glv_rows(curve_name, vals), device)


def _gather(points: Projective, idx: torch.Tensor) -> Projective:
    return Projective(*(c.index_select(0, idx) for c in points))


def _ecntt_core(group: Group, points: Projective, dir: NTTDir, logn: int, stage) -> Projective:
    """Radix-2 DIT, natural input -> natural output (no scaling or coset):
    bit-reverse, then a stage call each for s = 1..logn."""
    name = group.curve.name
    dev = points.x.device
    glv = _glv_enabled()
    rows = _stage_rows(name, logn, dir == NTTDir.INVERSE, glv, dev)
    pts = _gather(points, _bit_reverse_index(1 << logn, dev))
    for s in range(1, logn + 1):
        pts = stage(group, pts, 1 << (s - 1), rows[s - 2] if s > 1 else None, glv)
    return pts


# ordering -> (input bit-reversed, output bit-reversed); a pure radix-2
# engine, so the mixed orderings alias the R forms (JAX `_ORDER_FLAGS`)
_ORDER_FLAGS = {
    Ordering.NN: (False, False), Ordering.NR: (False, True),
    Ordering.RN: (True, False), Ordering.RR: (True, True),
    Ordering.NM: (False, True), Ordering.MN: (True, False),
}


def _ecntt_one(group: Group, points: Projective, dir: NTTDir, cfg: NTTConfig, logn: int,
               stage, scale) -> Projective:
    """One (unbatched) config-aware ECNTT over axis 0 (JAX `_ecntt_one`)."""
    name = group.curve.name
    n = 1 << logn
    dev = points.x.device
    rev = _bit_reverse_index(n, dev)
    in_rev, out_rev = _ORDER_FLAGS[cfg.ordering]
    points = Projective(*(c.contiguous() for c in points))
    if in_rev:
        points = _gather(points, rev)
    if dir == NTTDir.FORWARD and cfg.coset_gen is not None:
        points = scale(group, points, _scale_rows(name, n, cfg.coset_gen, False, dev))
    pts = _ecntt_core(group, points, dir, logn, stage)
    if dir == NTTDir.INVERSE:
        pts = scale(group, pts, _scale_rows(name, n, cfg.coset_gen, True, dev))
    if out_rev:
        pts = _gather(pts, rev)
    return pts


def _log2(n: int) -> int:
    logn = n.bit_length() - 1
    if n < 1 or 1 << logn != n:
        raise IcicleException(IcicleError.INVALID_ARGUMENT, f"ecntt size {n} is not a power of two")
    return logn


def _ecntt(curve_name: str, points: Projective, dir: NTTDir, cfg: NTTConfig, stage,
           scale) -> Projective:
    group = get_group(curve_name)
    if cfg.batch_size > 1:
        axis = 1 if cfg.columns_batch else 0   # the batch axis of (n, B, L) / (B, n, L)
        logn = _log2(points.x.shape[1 - axis])
        outs = [_ecntt_one(group, Projective(*(c.select(axis, b) for c in points)), dir, cfg,
                           logn, stage, scale) for b in range(points.x.shape[axis])]
        return Projective(*(torch.stack(cs, dim=axis) for cs in zip(*outs)))
    return _ecntt_one(group, points, dir, cfg, _log2(points.x.shape[0]), stage, scale)


def _ecntt_torch(curve_name, points, dir, cfg):
    return _ecntt(curve_name, points, dir, cfg, ecntt_stage_ref, ecntt_scale_ref)


def _ecntt_cuda(curve_name, points, dir, cfg):
    return _ecntt(curve_name, points, dir, cfg, ecntt_stage, ecntt_scale)


dispatcher.register_impl("ecntt", dispatcher.TORCH, _ecntt_torch)
dispatcher.register_impl("ecntt", dispatcher.CUDA, _ecntt_cuda)

_DEFAULT_CFG = NTTConfig()


def ecntt(curve_name: str, points: Projective, dir: NTTDir = NTTDir.FORWARD,
          cfg: NTTConfig = _DEFAULT_CFG) -> Projective:
    """ECNTT with the reference's NTTConfig surface: ordering, coset_gen,
    batch_size. Points are Montgomery-form projective G1 coordinates,
    (n, L) each, transformed along axis 0; batched (cfg.batch_size > 1),
    (batch, n, L), or (n, batch, L) with columns_batch. Computed on the
    points' device."""
    return dispatcher.dispatch("ecntt", cfg.backend, points.x)(curve_name, points, dir, cfg)


def ecntt_jit(curve_name: str, points: Projective, dir: NTTDir = NTTDir.FORWARD,
              cfg: NTTConfig = _DEFAULT_CFG) -> Projective:
    """The JAX package's jit-cached entry point (icicle_tpu/ops/ecntt.py
    `ecntt_jit`). The port runs eagerly and caches the twiddle digit rows
    per (curve, size, direction), so this is `ecntt`."""
    return ecntt(curve_name, points, dir, cfg)
