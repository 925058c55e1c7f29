"""The port's signed radix-2^12 engine (icicle_tpu_torch/math/radix12.py)
and the bound-tracked field of kernel B5 (kernels/msm_scan_r12.py) against
the JAX package's (icicle_tpu/math/radix12.py, pallas/msm_scan_r12.py),
run eagerly on the same words. Tolerance: exact equality of every word
(the JAX engine computes in int32, the port's multiply sums its columns in
int64; no column can leave int32, so the two are equal)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu.math import radix12 as JX
from icicle_tpu.pallas import msm_scan_r12 as JS12
from icicle_tpu.pallas.msm_kernel import _b3_small
from icicle_tpu_torch.kernels import build
from icicle_tpu_torch.kernels import msm_scan_r12 as TS12
from icicle_tpu_torch.math import radix12 as TX
from tests.ec_ref import ec_mul

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)

CURVES = ["bn254", "bls12_381", "bls12_377", "grumpkin"]


def _engines(curve_name):
    p = jcurve(curve_name).fq.modulus
    return JX.Radix12(p), TX.Radix12(p)


def _same(jwords, twords):
    return all(np.array_equal(np.asarray(a), b.numpy()) for a, b in zip(jwords, twords)) \
        and len(jwords) == len(twords)


def _limbs(rng, curve_name, n):
    """(L, n) uint32 limbs of canonical field elements, most limbs >= 2^31."""
    fq = jcurve(curve_name).fq
    vals = [int.from_bytes(rng.bytes(48), "little") % fq.modulus for _ in range(n - 1)]
    vals.append(fq.modulus - 1)
    return np.asarray(fq.from_ints(vals)).T.copy()


def _words(rng, nw, n, lo, hi):
    return np.stack([rng.integers(lo, hi, size=n, dtype=np.int64).astype(np.int32)
                     for _ in range(nw)])


def _both(a: np.ndarray):
    """(nw, n) int32 -> (JAX word list, torch word list)."""
    return [jnp.asarray(w) for w in a], [torch.from_numpy(w.copy()) for w in a]


@pytest.mark.parametrize("curve_name", CURVES)
def test_constants(curve_name):
    je, te = _engines(curve_name)
    assert (te.nw, te.rbits, te.R, int(te.inv12)) == (je.nw, je.rbits, je.R, int(je.inv12))
    for a, b in ((te.p12, je.p12), (te.p2_12, je.p2_12), (te.one_mont, je.one_mont)):
        assert [int(v) for v in a] == [int(v) for v in b]


@pytest.mark.parametrize("curve_name", CURVES)
def test_from_u32_to_u32(curve_name):
    je, te = _engines(curve_name)
    rng = np.random.default_rng(1)
    limbs = _limbs(rng, curve_name, 16)
    assert (limbs >= 1 << 31).any()
    jw = je.from_u32([jnp.asarray(l) for l in limbs])
    tw = te.from_u32([torch.from_numpy(l.view(np.int32)) for l in limbs])
    assert _same(jw, tw)
    nl = limbs.shape[0]
    back = te.to_u32(tw, nl)
    assert all(np.array_equal(b.numpy().view(np.uint32), l) for b, l in zip(back, limbs))
    # to_u32 reads each word as uint32, negative or above 2^12 too, as JAX does
    raw = _words(rng, te.nw, 16, -(1 << 14), 1 << 14)
    jr, tr = _both(raw)
    jl = je.to_u32(jr, nl)
    tl = te.to_u32(tr, nl)
    assert all(np.array_equal(np.asarray(a), b.numpy().view(np.uint32)) for a, b in zip(jl, tl))


@pytest.mark.parametrize("curve_name", ["bn254", "bls12_381"])
def test_norm_canon_mul_small(curve_name):
    je, te = _engines(curve_name)
    rng = np.random.default_rng(2)
    limbs = _limbs(rng, curve_name, 12)
    ja = je.from_u32([jnp.asarray(l) for l in limbs])
    ta = te.from_u32([torch.from_numpy(l.view(np.int32)) for l in limbs])
    jb, tb = je.from_u32([jnp.asarray(l) for l in limbs[:, ::-1].copy()]), \
        te.from_u32([torch.from_numpy(l.view(np.int32)) for l in limbs[:, ::-1].copy()])
    jd, td = je.sub(ja, je.add(jb, jb)), te.sub(ta, te.add(tb, tb))   # negative words
    assert _same(jd, td)
    assert _same(je.norm(jd), te.norm(td))
    assert _same(je.canon_nonneg(je.norm(jd)), te.canon_nonneg(te.norm(td)))
    for k in (9, -51, 3):
        assert _same(je.norm(je.mul_small(ja, k)), te.norm(te.mul_small(ta, k)))


@pytest.mark.parametrize("curve_name", ["bn254", "bls12_381", "grumpkin"])
def test_mul_mont_normalised_times_lazy(curve_name):
    je, te = _engines(curve_name)
    rng = np.random.default_rng(3)
    limbs = _limbs(rng, curve_name, 12)
    ja = je.from_u32([jnp.asarray(l) for l in limbs])
    ta = te.from_u32([torch.from_numpy(l.view(np.int32)) for l in limbs])
    jm, tm = je.mul_mont(ja, ja), te.mul_mont(ta, ta)
    assert _same(jm, tm)
    # lazy operands: a sum and a difference of two products (negative words)
    jl, tl = je.sub(je.add(jm, jm), ja), te.sub(te.add(tm, tm), ta)
    assert _same(je.mul_mont(jm, jl), te.mul_mont(tm, tl))
    assert _same(je.mul_mont(jl, jm), te.mul_mont(tl, tm))
    # the value: a b R'^-1 mod p, in (-p, 2p)
    p, rinv = te.p, pow(te.R, -1, te.p)
    out = te.mul_mont(tm, tl)
    for lane in range(3):
        got = sum(int(w[lane]) << (12 * k) for k, w in enumerate(out))
        a = sum(int(w[lane]) << (12 * k) for k, w in enumerate(tm))
        b = sum(int(w[lane]) << (12 * k) for k, w in enumerate(tl))
        assert -p < got < 2 * p and got % p == a * b * rinv % p


@pytest.mark.parametrize("curve_name", ["bn254", "bls12_381", "bw6_761"])
def test_audit_raises_at_the_same_bounds(curve_name):
    p = jcurve(curve_name).fq.modulus
    je, te = JX.Radix12(p), TX.Radix12(p)
    for bounds in ((4095, 4095), (8190, 4095), (8190, 8190), (12285, 4095), (16380, 4095),
                   (12285, 12285), (24570, 4095), (16380, 16380)):
        outcomes = []
        for eng in (je, te):
            try:
                eng.audit_mul(*bounds)
                outcomes.append(True)
            except OverflowError:
                outcomes.append(False)
        assert outcomes[0] == outcomes[1], bounds


class _Recorder:
    """Stands in for an engine: records the multiplies and normalisations
    of one `_madd_r12` ("mul" a Montgomery multiply, "norm" a carry
    normalisation, "mul_small" the multiply by b3) and passes the overflow
    audit through to the real engine."""

    NAMES = {"mul_mont": "mul", "norm": "norm", "mul_small": "mul_small"}

    def __init__(self, eng):
        self.eng, self.log = eng, []

    def audit_mul(self, a, b):
        return self.eng.audit_mul(a, b)

    def __getattr__(self, op):
        def record(*args):
            if op in self.NAMES:
                self.log.append(self.NAMES[op])
            return ["w"]
        return record


def _schedule(module, eng, b3):
    rec = _Recorder(eng)
    f = module._R12Field(rec)
    lazy, norm = 2 * f.NORM, f.NORM
    args = [module._BVal(["w"], b) for b in (lazy, lazy, lazy, norm, norm)]
    module._madd_r12(f, *args, b3)
    return tuple(rec.log)


class _CodeRecorder:
    """Stands in for an engine under a field class's `mul`: per Montgomery
    multiply, which operands its overflow audit normalised first (bit 0 the
    first, bit 1 the second), as KERNEL_SCHEDULES holds them. Only the norms
    `mul` itself makes count; the audit is the real engine's."""

    def __init__(self, eng):
        self.eng, self.codes, self.inside = eng, [], False

    def audit_mul(self, a, b):
        return self.eng.audit_mul(a, b)

    def norm(self, w):
        return ("audit", w) if self.inside else w

    def mul_mont(self, a, b):
        self.codes.append(int(isinstance(a, tuple)) | int(isinstance(b, tuple)) << 1)
        return "w"

    def __getattr__(self, op):
        return lambda *args: "w"


def schedule_codes(module, eng, b3, padd: bool = False) -> tuple:
    """The codes of one `_madd_r12` (the state lazy, the point normalised)
    or, with `padd`, one `_padd_r12` from two lazy points, with `module`'s
    field class (the port's or the JAX package's) over `eng`'s audit."""
    rec = _CodeRecorder(eng)

    class Field(module._R12Field):
        def mul(self, a, b):
            rec.inside = True
            try:
                return super().mul(a, b)
            finally:
                rec.inside = False

    f = Field(rec)
    lazy, norm = 2 * f.NORM, f.NORM
    if padd:
        TS12._padd_r12(f, *(module._BVal("w", lazy) for _ in range(6)), b3)
    else:
        module._madd_r12(f, *(module._BVal("w", b) for b in (lazy, lazy, lazy, norm, norm)), b3)
    return tuple(rec.codes)


def header_schedules() -> dict:
    """kernels/csrc/r12_schedules.cuh's schedules: curve -> {curve index,
    words, madd codes, padd codes}."""
    with open(os.path.join(build.CSRC, "r12_schedules.cuh")) as fh:
        text = fh.read()
    out = {}
    for m in re.finditer(r"struct schedule_(\w+) \{(.*?)\n\};", text, re.S):
        body = m.group(2)

        def field(key):
            return re.search(rf"{key}(?:\[\d+\])? = \{{?([^}};]*)\}}?;", body).group(1)

        out[m.group(1)] = {"curve": int(field("kCurve")), "words": int(field("kWords")),
                           "madd": tuple(int(v) for v in field("kMadd").split(",")),
                           "padd": tuple(int(v) for v in field("kPadd").split(","))}
    return out


def jax_engine_at(curve_name):
    """The JAX package's engine where its word count is the port's; else
    (grumpkin, bls12_381, where the port takes one word more) the port's,
    whose audit equals the JAX one at equal words
    (test_audit_raises_at_the_same_bounds)."""
    te = TS12.r12_engine(curve_name)
    je = JX.Radix12(te.p)
    return je if je.nw == te.nw else te


@pytest.mark.parametrize("curve_name", CURVES + ["bw6_761"])
def test_madd_schedule_matches_jax(curve_name):
    """The port's `_madd_r12` makes the JAX package's operations in its
    order (at the JAX word count), and the multiplies' normalisations at the
    port's word count are the table KERNEL_SCHEDULES and the CUDA header
    r12_schedules.cuh hold, by the port's field and by the JAX package's."""
    je, te = _engines(curve_name)
    b3 = _b3_small(jcurve(curve_name))
    want = _schedule(JS12, je, b3)
    got = _schedule(TS12, te, b3)
    assert got == want
    # 11 multiplies, 2 by b3, the 5 normalisations _madd_r12 writes and
    # those the audit adds inside the multiplies
    codes = TS12.KERNEL_SCHEDULES[curve_name][0]
    assert [got.count(op) for op in ("mul", "mul_small")] == [11, 2]
    eng = TS12.r12_engine(curve_name)
    assert schedule_codes(TS12, eng, b3) == schedule_codes(
        JS12, jax_engine_at(curve_name), b3) == codes
    header = header_schedules()[curve_name]
    assert header["madd"] == codes and header["words"] == eng.nw
    assert header["curve"] == TS12.R12_CURVES.index(curve_name)
    if eng.nw == je.nw:
        assert got.count("norm") == 5 + sum(bin(c).count("1") for c in codes)


def test_madd_r12_matches_jax_on_lanes():
    """Two chained mixed adds (the second from a lazy state), word for word."""
    curve = "bn254"
    c = jcurve(curve)
    je, te = _engines(curve)
    mod = c.fq.modulus
    rng = np.random.default_rng(4)
    pts = [ec_mul((c.gen_x, c.gen_y), int(k), mod) for k in rng.integers(1, 1 << 40, size=8)]
    pts[1] = pts[0]                                 # a doubling inside the second add
    rp = je.R % mod

    def coords(sel):
        v = [(sel(p) * rp) % mod for p in pts]
        return np.asarray(c.fq.from_ints(v)).T.copy()

    xs, ys = coords(lambda p: p[0]), coords(lambda p: p[1])
    jf, tf = JS12._R12Field(je), TS12._R12Field(te)
    lazy = 2 * jf.NORM

    def run(mod_, eng, f, to):
        x2 = mod_._BVal(eng.from_u32(to(xs)), f.NORM)
        y2 = mod_._BVal(eng.from_u32(to(ys)), f.NORM)
        one = eng.from_u32(to(np.asarray(c.fq.from_ints([rp] * 8)).T.copy()))
        zero = [w * 0 for w in one]
        e = mod_._madd_r12(f, mod_._BVal(zero, lazy), mod_._BVal(one, lazy),
                           mod_._BVal(zero, lazy), x2, y2, 9)
        x3 = mod_._BVal(eng.from_u32(to(xs[:, ::-1].copy())), f.NORM)
        y3 = mod_._BVal(eng.from_u32(to(ys[:, ::-1].copy())), f.NORM)
        return mod_._madd_r12(f, *(mod_._BVal(v.w, lazy) for v in e), x3, y3, 9)

    jout = run(JS12, je, jf, lambda a: [jnp.asarray(r) for r in a])
    tout = run(TS12, te, tf, lambda a: [torch.from_numpy(r.view(np.int32)) for r in a])
    for jv, tv in zip(jout, tout):
        assert _same(jv.w, tv.w) and jv.b == tv.b
