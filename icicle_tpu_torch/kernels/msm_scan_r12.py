"""MSM v3 prefix scan on the signed radix-2^12 engine over a hand-written
CUDA kernel (counterpart of icicle_tpu/pallas/msm_scan_r12.py).

`prefix_scan_r12` runs kernel B5 (kernels/csrc/msm_scan_r12.cu over
radix12.cuh), which replaces `make_prefix_scan_r12`: the same E-stream as
B3 (per lane, E_k = E_{k-1} + P_k by the complete mixed add, RCB15 Alg 8,
from the identity), with the field arithmetic on math/radix12.py's words.
`prefix_scan_r12_ref` is the same function in plain torch.

Domain: every value in and out is in R' = 2^(12 nw) Montgomery form
(2^264 for bn254), not the 2^(32 L) of B3. Inputs are canonical u32 limbs
(ops/msm_tpu3.py shifts the points into R' when it prepares them); each
output coordinate is to_u32(norm(canon_nonneg(v))), a value in [0, 4p)
that is not canonical, so its exact representative depends on the exact
sequence of operations: the E state stays lazy between slots (words up to
2 * 4095) and is never normalised, and each multiply normalises an operand
exactly where `_R12Field.mul`'s overflow audit says so.

Layout as B3's: in (K, 2L, C) int32 limbs, x rows then (sign-applied) y
rows; out (K, 3L, C), x / y / z rows; the Pallas kernel's n_groups axis
folded into C.

The kernel splits each lane's K slots into S segments (`r12_segments`)
as B3 does (kernels/msm_scan.py): segment s covers slots [s * ceil(K/S),
min(K, (s + 1) * ceil(K/S))).
  1. reduce: each segment folds its slots from the identity (`_madd_r12`);
  2. carry scan: carry_0 = identity, carry_{s+1} = `_padd_r12`(carry_s,
     total_s), the complete projective add (RCB15 Alg 7) on the same words;
  3. rescan: each segment s >= 1 re-runs its madds from carry_s and writes
     every E_k (segment 0's pass-1 values are already final).
Totals and carries stay lazy radix-12 words ((S - 1, 3 nw, C) int32 in the
kernel), so no lazy bit is lost between passes. The plain version computes
the same association, so the two agree bit for bit at a given S; at
segments=1 both are the serial fold of the JAX XLA twin
`make_prefix_scan_r12_xla`. Other S give other representatives in [0, 4p)
of other projective coordinates of the same points; the MSM's extraction
and unshift (ops/msm_tpu3.py) take any value below 4p.

The audit decides the normalisations from static bounds, so for one curve
they are a fixed schedule: `KERNEL_SCHEDULES[curve]` says which operands
each Montgomery multiply of the mixed add and of the projective add
normalises first, and kernels/csrc/r12_schedules.cuh, which the CUDA source
applies, holds the same tables (both pinned to the audit by CPU tests).
The kernel is built for every G1 curve, one library a limb count (8:
bn254 at nw 22, grumpkin at 23; 12: bls12_377 at 32, bls12_381 at 33; 24:
bw6_761 at 64; `r12_engine` picks nw), b3 a small integer on each.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icicle_tpu_torch.kernels import msm_lib
from icicle_tpu_torch.kernels.msm_scan import check_segments, scan_segments
from icicle_tpu_torch.math.radix12 import MASK, RADIX, Radix12, int_to_words

# The curves the kernel holds a schedule for, in the order of their index
# in its consts (r12_schedules.cuh kCurve).
R12_CURVES = ("bn254", "grumpkin", "bls12_377", "bls12_381", "bw6_761")

# curve -> (madd, padd): per Montgomery multiply of one `_madd_r12` (11) and
# one `_padd_r12` from two lazy points (12), in call order, which operands
# the overflow audit normalises first: bit 0 the first, bit 1 the second
# (kernels/csrc/r12_schedules.cuh kMadd, kPadd). The normalisations that
# `_madd_r12` and `_padd_r12` write themselves are not in the table. On
# bn254 no multiply of the mixed add needs one; its projective add
# normalises the first operand of the three (a + b)(c + d) products, t3 in
# t3 * t1, t4 in z3 * t4 and t0 in t0 * t3.
KERNEL_SCHEDULES = {
    "bn254": ((0,) * 11, (0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 2, 1)),
    "grumpkin": ((0,) * 11, (0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 2, 1)),
    "bls12_377": ((0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0), (1, 1, 1, 3, 3, 3, 1, 0, 1, 0, 2, 1)),
    "bls12_381": ((0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0), (1, 1, 1, 3, 3, 3, 1, 0, 1, 0, 2, 1)),
    "bw6_761": ((1, 1, 2, 2, 2, 2, 0, 3, 2, 1, 1), (3, 3, 3, 3, 3, 3, 3, 1, 3, 2, 3, 3)),
}


class _BVal:
    """A field value as (signed words, static per-word absolute bound)."""

    __slots__ = ("w", "b")

    def __init__(self, w, b: int):
        self.w = w
        self.b = b


class _R12Field:
    """Bound-tracked radix-12 ops on lists of word tensors (the JAX
    package's `_R12Field`)."""

    def __init__(self, eng: Radix12):
        self.eng = eng
        self.NORM = MASK

    def add(self, a: _BVal, b: _BVal) -> _BVal:
        return _BVal(self.eng.add(a.w, b.w), a.b + b.b)

    def sub(self, a: _BVal, b: _BVal) -> _BVal:
        return _BVal(self.eng.sub(a.w, b.w), a.b + b.b)

    def norm(self, a: _BVal) -> _BVal:
        return _BVal(self.eng.norm(a.w), self.NORM)

    def mul(self, a: _BVal, b: _BVal) -> _BVal:
        """Montgomery multiply; where the audit finds that the operands'
        bounds could overflow a column, the larger-bound operand is
        normalised first, until it passes (a fixed schedule per field)."""
        while True:
            try:
                self.eng.audit_mul(a.b, b.b)
                break
            except OverflowError:
                if a.b <= self.NORM and b.b <= self.NORM:
                    raise
                if a.b >= b.b:
                    a = self.norm(a)
                else:
                    b = self.norm(b)
        return _BVal(self.eng.mul_mont(a.w, b.w), self.NORM)

    def mul_small(self, a: _BVal, k: int) -> _BVal:
        assert abs(k) * a.b < (1 << 31)
        return self.norm(_BVal(self.eng.mul_small(a.w, k), abs(k) * a.b))


def _madd_r12(f: _R12Field, X1, Y1, Z1, x2, y2, b3):
    """Complete mixed add (RCB15 Alg 8, a = 0) over bound-tracked radix-12
    values. The state (X1, Y1, Z1) may be lazy (words <= 2 * 4095); (x2, y2)
    must be normalised. Output coordinates are lazy. b3: a small Python int,
    or a normalised _BVal constant."""
    m, add, sub = f.mul, f.add, f.sub
    mb3 = (lambda v: f.mul_small(v, b3)) if isinstance(b3, int) else (lambda v: m(v, b3))
    t0 = m(X1, x2)
    t1 = m(Y1, y2)
    t3 = sub(m(f.norm(add(X1, Y1)), add(x2, y2)), add(t0, t1))
    t4 = add(m(y2, Z1), Y1)
    y3 = add(m(x2, Z1), X1)
    t0 = add(add(t0, t0), t0)
    t2 = mb3(Z1)
    z3 = add(t1, t2)
    t1 = sub(t1, t2)
    y3 = mb3(y3)
    t3 = f.norm(t3)
    t4 = f.norm(t4)
    x3 = sub(m(t3, t1), m(t4, y3))
    y3 = add(m(t1, z3), m(y3, t0))
    z3 = add(m(z3, t4), m(t0, t3))
    return x3, y3, z3


def _padd_r12(f: _R12Field, X1, Y1, Z1, X2, Y2, Z2, b3):
    """Complete projective add (RCB15 Alg 7, a = 0) over bound-tracked
    radix-12 values, as curves/group.py `add`. Both points may be lazy
    (words <= 2 * 4095): a segment total and a running carry. Output
    coordinates are lazy (words <= 2 * 4095), a valid state for
    `_madd_r12`. The audit in `f.mul` normalises operands where a column
    could overflow (`KERNEL_SCHEDULES`). b3 as in `_madd_r12`."""
    m, add, sub = f.mul, f.add, f.sub
    mb3 = (lambda v: f.mul_small(v, b3)) if isinstance(b3, int) else (lambda v: m(v, b3))
    t0 = m(X1, X2)
    t1 = m(Y1, Y2)
    t2 = m(Z1, Z2)
    t3 = sub(m(add(X1, Y1), add(X2, Y2)), add(t0, t1))
    t4 = sub(m(add(Y1, Z1), add(Y2, Z2)), add(t1, t2))
    y3 = sub(m(add(X1, Z1), add(X2, Z2)), add(t0, t2))
    t0 = add(add(t0, t0), t0)
    t2 = mb3(t2)
    z3 = add(t1, t2)
    t1 = sub(t1, t2)
    y3 = mb3(y3)
    x3 = sub(m(t3, t1), m(t4, y3))
    y3 = add(m(t1, z3), m(y3, t0))
    z3 = add(m(z3, t4), m(t0, t3))
    return x3, y3, z3


class _VBound:
    """A value's interval [lo, hi] (integers)."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo: int, hi: int):
        self.lo = lo
        self.hi = hi

    def mag(self) -> int:
        return max(-self.lo, self.hi)


class _VField:
    """Interval bounds of the values (not the words) through `_madd_r12`
    and `_padd_r12`: a Montgomery multiply gives (a b + m p) / R' with
    0 <= m < R', in [-|a b| / R', |a b| / R' + p]; `ok` turns false where
    an operand's value could pass the word audit's assumption on the top
    word of a normalised operand (below 2^12 at word nw - 1)."""

    def __init__(self, eng: Radix12):
        self.p, self.R = eng.p, eng.R
        self.limit = MASK << (RADIX * (eng.nw - 1))
        self.ok = True

    def add(self, a, b):
        return _VBound(a.lo + b.lo, a.hi + b.hi)

    def sub(self, a, b):
        return _VBound(a.lo - b.hi, a.hi - b.lo)

    def norm(self, a):
        return a

    def mul_small(self, a, k: int):
        return _VBound(min(k * a.lo, k * a.hi), max(k * a.lo, k * a.hi))

    def mul(self, a, b):
        self.ok = self.ok and max(a.mag(), b.mag()) < self.limit
        q = -(-(a.mag() * b.mag()) // self.R)
        return _VBound(-q, q + self.p)


def value_audit(eng: Radix12, b3: int, steps: int = 4096) -> bool:
    """Whether the E-stream's values stay where the engine's outputs need
    them, for any canonical inputs: from the identity, the mixed add's
    state intervals (each step's joined with the last) reach a fixed point
    within `steps`, every state coordinate and every projective add of two
    states lies in [-2p, 4p) (canon_nonneg then gives [0, 4p), which
    `to_u32` and the unshift take), and no multiply operand passes the word
    audit's assumption. Its failure is the state's values growing: a large
    |b3| against R' / p (grumpkin, b3 = -51, R' / p ~ 2^10.4) or little
    headroom (bls12_381, R' / p ~ 2^3.3) at the least word count."""
    f = _VField(eng)
    p = eng.p
    canon = _VBound(0, p)
    state = [_VBound(0, 0), canon, _VBound(0, 0)]
    for _ in range(steps):
        new = [_VBound(min(a.lo, b.lo), max(a.hi, b.hi))
               for a, b in zip(_madd_r12(f, *state, canon, canon, b3), state)]
        grew = any(a.lo != b.lo or a.hi != b.hi for a, b in zip(new, state))
        state = new
        if not f.ok or any(v.lo < -2 * p or v.hi >= 4 * p for v in state):
            return False
        if not grew:
            break
    else:
        return False
    total = _padd_r12(f, *state, *state, b3)
    return f.ok and all(-2 * p <= v.lo and v.hi < 4 * p for v in total)


def r12_segments(K: int, C: int) -> int:
    """Segments per lane for a (K, ., C) radix-12 scan: B3's rule
    (`scan_segments`) for one wave of blocks (msm_lib.ONE_WAVE_THREADS)."""
    return scan_segments(K, C, msm_lib.ONE_WAVE_THREADS)


@functools.lru_cache(maxsize=None)
def r12_engine(curve_name: str) -> Radix12:
    """The curve's radix-12 engine: the least word count from the JAX
    package's (the least with R' > 4p) whose `value_audit` passes. That is
    the JAX package's on bn254 (22), bls12_377 (32) and bw6_761 (64); one
    word more on grumpkin (23) and bls12_381 (33), where the JAX package's
    state leaves [-2p, 4p) and its MSM is wrong (ROADMAP.md section C)."""
    curve = msm_lib.as_curve(curve_name)
    b3 = msm_lib.b3_small(curve)
    eng = Radix12(curve.fq.modulus)
    while not value_audit(eng, b3):
        eng = Radix12(eng.p, eng.nw + 1)
    return eng


def _words_const(eng: Radix12, value: int, like: torch.Tensor):
    return [torch.full_like(like, w) for w in int_to_words(value, eng.nw)]


def prefix_scan_r12(curve, plimbs: torch.Tensor, *, _segments: int | None = None) -> torch.Tensor:
    """(K, 2L, C) int32 R'-domain points -> (K, 3L, C) E-stream in [0, 4p),
    split into `r12_segments(K, C)` segments a lane (`_segments` overrides
    the plan, to time other splits).

    On a CUDA tensor this launches the kernel's passes on the current stream
    (no synchronisation), counts one launch in `prefix_scan_r12.launches`
    per call and raises if a launch is refused or the curve has no
    instance. On a CPU tensor it computes `prefix_scan_r12_ref`."""
    curve = msm_lib.as_curve(curve)
    nl = curve.fq.nlimbs
    msm_lib.check_points("prefix_scan_r12", plimbs, 2 * nl)
    K, _, C = plimbs.shape
    S = check_segments("prefix_scan_r12", _segments, r12_segments(K, C))
    if not plimbs.is_cuda:
        return prefix_scan_r12_ref(curve, plimbs, S)
    consts = kernel_consts(curve)
    nw = r12_engine(curve.name).nw
    out = torch.empty((K, 3 * nl, C), dtype=torch.int32, device=plimbs.device)
    carries = torch.empty((S - 1, 3 * nw, C), dtype=torch.int32, device=plimbs.device)
    msm_lib.launch("prefix_scan_r12", curve, [plimbs, out, carries], [K, C, S], consts)
    prefix_scan_r12.launches += 1
    return out


prefix_scan_r12.launches = 0


@functools.lru_cache(maxsize=None)
def _consts(curve_name: str):
    """{curve, p12[nw], p2_12[nw], one[nw], inv12, b3} as a host uint32
    array: the curve's index in R12_CURVES (msm_scan_r12.cu picks its
    schedule and word count by it), then radix12.cuh R12Consts: words of p,
    2p and R' mod p, -p^-1 mod 2^12, b3 as a small signed integer's
    two's-complement bits."""
    eng = r12_engine(curve_name)
    b3 = msm_lib.b3_small(msm_lib.as_curve(curve_name))
    values = ([R12_CURVES.index(curve_name)] + eng.p12 + eng.p2_12 + eng.one_mont
              + [eng.inv12, b3 & 0xFFFFFFFF])
    return (ctypes.c_uint32 * len(values))(*values)


def kernel_consts(curve):
    """The kernel's constants for a G1 curve (R12_CURVES)."""
    return _consts(curve.name)


def prefix_scan_r12_ref(curve, plimbs: torch.Tensor, segments: int | None = None) -> torch.Tensor:
    """`prefix_scan_r12` in plain torch, with the kernel's association of
    adds at S = `segments` (None: the plan's): a Python loop over ceil(K/S)
    steps of all S * C (segment, lane) pairs, the S - 1 carry adds
    (`_padd_r12` on lazy words), then the rescan. segments=1 is the serial
    fold."""
    curve = msm_lib.as_curve(curve)
    eng = r12_engine(curve.name)
    f = _R12Field(eng)
    nl = curve.fq.nlimbs
    K, _, C = plimbs.shape
    S = check_segments("prefix_scan_r12", segments, r12_segments(K, C))
    dev = plimbs.device
    n = -(-K // S)
    steps = msm_lib.segment_rows(plimbs, S)            # (n, S, C, 2L)
    lazy = 2 * f.NORM
    b3 = msm_lib.b3_small(curve)
    lane = plimbs[0, 0]
    if b3 is None:
        b3 = _BVal(_words_const(eng, curve.b3 * eng.R % eng.p, lane), f.NORM)

    def identity(like):
        zero = _words_const(eng, 0, like)
        return [zero, _words_const(eng, eng.R % eng.p, like), zero]

    def lazy_point(words):
        return [_BVal(w, lazy) for w in words]

    def scan(state, out):
        """state: x, y, z lists of nw (S, C) words; out: None or (n, S, C, 3L)."""
        for j in range(n):
            x2 = _BVal(eng.from_u32([steps[j, ..., i] for i in range(nl)]), f.NORM)
            y2 = _BVal(eng.from_u32([steps[j, ..., nl + i] for i in range(nl)]), f.NORM)
            new = [v.w for v in _madd_r12(f, *lazy_point(state), x2, y2, b3)]
            mask = msm_lib.step_mask(j, n, K, S, dev)
            state = new if mask is None else [[torch.where(mask, a, b) for a, b in zip(nv, ov)]
                                              for nv, ov in zip(new, state)]
            if out is not None:
                out[j] = torch.stack([limb for v in state for limb in
                                      eng.to_u32(eng.norm(eng.canon_nonneg(v)), nl)], -1)
        return state

    state = identity(steps[0, ..., 0])
    if S > 1:
        totals = scan(state, None)
        carries = [identity(lane)]
        for s in range(S - 1):
            total = [[w[s] for w in coord] for coord in totals]
            carries.append([v.w for v in _padd_r12(f, *lazy_point(carries[-1]),
                                                    *lazy_point(total), b3)])
        state = [[torch.stack([c[i][k] for c in carries]) for k in range(eng.nw)]
                 for i in range(3)]                   # (S, C) words
    local = torch.empty((n, S, C, 3 * nl), dtype=torch.int32, device=dev)
    scan(state, local)
    # (n, S, C, 3L) -> (S * n, 3L, C), cut to K
    return local.permute(1, 0, 3, 2).reshape(S * n, 3 * nl, C)[:K].contiguous()
