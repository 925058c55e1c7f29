"""The ECNTT's butterfly stage and scalar ladder over a hand-written CUDA
kernel (kernels/csrc/ecntt.cu), and their plain versions.

An ECNTT (ops/ecntt.py) is a radix-2 DIT over projective G1 points whose
twiddles are scalars: each butterfly multiplies its odd point by a twiddle
with a 2^4-ary ladder. Two entries:
  * `ecntt_stage(group, points, m, rows, glv)`: one DIT stage of half-block
    m over (n, L) x, y, z; lane j of block b reads the even point b 2m + j
    and the odd point b 2m + m + j, t = w_j odd (the ladder over the
    stage's digit rows, which cover its m distinct twiddles; `rows` None
    for stage 1, whose twiddle is 1), and writes even + t and even - t;
  * `ecntt_scale(group, points, rows)`: the GLV ladder alone, lane j times
    its own scalar (the forward coset shift and the inverse's fused n^-1
    and coset unscale).
The ladder is the JAX package's: with GLV (`scalar_mul_vec_glv`,
icicle_tpu/ops/ecntt.py:35), rows = (dig1, dig2, neg1, neg2), two 16-entry
tables of P' = +-P and phi(P)' = +-(beta x, y, z), and per digit row four
doublings and two table adds; without (`scalar_mul_vec`, :87), rows = the
digit rows of the full scalar and one table. Digit rows are (ndig, lanes)
int32, most significant first; flags (lanes,) bool.

No Pallas kernel is replaced: JAX runs these in XLA (`_ecntt_core`,
icicle_tpu/ops/ecntt.py:220). The plain versions run the port's group ops
(curves/group.py) in the JAX order; the kernel runs ec_field.cuh's RCB15
formulas, line for line the same, in the same order, so the two agree bit
for bit (projective coordinates, not only points). Instances: L = 8
(bn254, grumpkin), 12 (bls12_377, bls12_381), 24 (bw6_761), one library
each.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icicle_tpu_torch.curves.glv import glv_constants
from icicle_tpu_torch.curves.group import Group, Projective, pselect
from icicle_tpu_torch.kernels import build, msm_lib
from icicle_tpu_torch.math.params import limbs_of
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

WDIG = 4              # ladder digit width (bits)
TABLE = 1 << WDIG     # entries of a ladder table
LIBRARIES = {8: "ecntt", 12: "ecntt_l12", 24: "ecntt_l24"}


# -- plain versions --------------------------------------------------------------------

def _table(group: Group, base: Projective) -> Projective:
    """(16, lanes..., L) coordinates: entry i = i P, built by complete adds
    from the identity (entry 1 is identity + P, as JAX's scan builds it)."""
    acc = group.identity(base.x.shape[:-1], base.x.device)
    entries = [acc]
    for _ in range(TABLE - 1):
        acc = group.add(acc, base)
        entries.append(acc)
    return Projective(*(torch.stack(c) for c in zip(*entries)))


def _select(table: Projective, digit: torch.Tensor) -> Projective:
    """Entry digit[..., j] of each lane: the pselect tree's result as one
    gather along the table axis (digit broadcasts from the right)."""
    shape = table.x.shape[1:]
    idx = digit.to(torch.int64).reshape((1,) + (1,) * (len(shape) - 1 - digit.dim())
                                        + tuple(digit.shape) + (1,))
    idx = idx.expand((1,) + shape)
    return Projective(*(c.gather(0, idx)[0] for c in table))


def scalar_mul_vec_glv(group: Group, points: Projective, rows) -> Projective:
    """Per-lane k P through the GLV split (JAX `scalar_mul_vec_glv`). rows =
    (dig1, dig2, neg1, neg2): (ndig, m) digit rows of |k1|, |k2| and (m,)
    sign flags, for the last axis of the lanes (leading lane axes share
    them). Both tables are built by one add a step over the stacked bases."""
    dig1, dig2, neg1, neg2 = rows
    f = group.f
    beta = group.glv_beta_mont(points.x.device)
    p1 = pselect(neg1, Projective(points.x, f.neg(points.y), points.z), points)
    phi = Projective(f.mul_mont(points.x, beta), points.y, points.z)
    p2 = pselect(neg2, Projective(phi.x, f.neg(phi.y), phi.z), phi)
    both = _table(group, Projective(*(torch.stack([a, b]) for a, b in zip(p1, p2))))
    t1 = Projective(*(c[:, 0] for c in both))
    t2 = Projective(*(c[:, 1] for c in both))
    acc = group.identity(points.x.shape[:-1], points.x.device)
    for d1, d2 in zip(dig1, dig2):
        for _ in range(WDIG):
            acc = group.dbl(acc)
        acc = group.add(acc, _select(t1, d1))
        acc = group.add(acc, _select(t2, d2))
    return acc


def scalar_mul_vec(group: Group, points: Projective, digits: torch.Tensor) -> Projective:
    """Per-lane k P, the plain 2^4-ary ladder (JAX `scalar_mul_vec`):
    digits (ndig, m) rows of k, most significant first."""
    table = _table(group, points)
    acc = group.identity(points.x.shape[:-1], points.x.device)
    for d in digits:
        for _ in range(WDIG):
            acc = group.dbl(acc)
        acc = group.add(acc, _select(table, d))
    return acc


def _ladder(group: Group, pts: Projective, rows, glv: bool) -> Projective:
    return scalar_mul_vec_glv(group, pts, rows) if glv else scalar_mul_vec(group, pts, rows)


def ecntt_stage_ref(group: Group, points: Projective, m: int, rows, glv: bool) -> Projective:
    """One DIT stage in plain torch: the lanes as (n / 2m, m) blocks, the
    odd points through the ladder (rows None: t = odd), one stacked add for
    even + t and even - t."""
    n, nl = points.x.shape
    halves = [c.reshape(n // (2 * m), 2, m, nl) for c in points]
    even = Projective(*(h[:, 0] for h in halves))
    odd = Projective(*(h[:, 1] for h in halves))
    t = odd if rows is None else _ladder(group, odd, rows, glv)
    s = group.add(Projective(*(torch.stack([e, e]) for e in even)),
                  Projective(*(torch.stack([a, b]) for a, b in zip(t, group.neg(t)))))
    return Projective(*(c.permute(1, 0, 2, 3).reshape(n, nl).contiguous() for c in s))


def ecntt_scale_ref(group: Group, points: Projective, rows) -> Projective:
    """Lane j times its own scalar (GLV rows over every lane), plain torch."""
    return Projective(*(c.contiguous() for c in scalar_mul_vec_glv(group, points, rows)))


# -- the kernel ---------------------------------------------------------------------------

def require_instance(group: Group) -> None:
    """Raises API_NOT_IMPLEMENTED unless the kernel is built for the group:
    G1 of a curve with a small b3 at 8, 12 or 24 limbs (every G1 curve);
    callable on the CPU."""
    if group.g2:
        raise IcicleException(
            IcicleError.API_NOT_IMPLEMENTED,
            f"ecntt: no CUDA kernel for {group.curve.name} G2: the ECNTT is a G1 transform, "
            "as the JAX package's (icicle_tpu/ops/ecntt.py takes get_group(curve) alone)")
    if group.nlimbs not in LIBRARIES or msm_lib.b3_small(group) is None:
        raise IcicleException(
            IcicleError.API_NOT_IMPLEMENTED,
            f"ecntt: no CUDA kernel for {group.curve.name}: the kernel is built for G1 at "
            f"{sorted(LIBRARIES)} limbs with a small b3 (other instances of the "
            "limb-count template: ROADMAP.md queue A item 6)")


@functools.lru_cache(maxsize=None)
def kernel_consts(group: Group):
    """ec_field.cuh's CurveConsts words (msm_lib.consts_values), then the GLV
    beta in Montgomery form, as a host uint32 array."""
    fp = group.curve.fq.params
    beta, _ = glv_constants(group.curve.name)
    values = msm_lib.consts_values(group) + limbs_of(fp.to_mont_int(beta), fp.nlimbs)
    return (ctypes.c_uint32 * len(values))(*values)


@functools.lru_cache(maxsize=None)
def _entry(nl: int, name: str):
    lib = build.load(LIBRARIES[nl])
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lib.icicle_msm_error_string.argtypes = [ctypes.c_int]
    lib.icicle_msm_error_string.restype = ctypes.c_char_p
    return fn, lib.icicle_msm_error_string


def _check(kernel: str, group: Group, points: Projective, rows, glv: bool, lanes: int) -> None:
    nl = group.nlimbs
    for c in points:
        msm_lib.check_aux(kernel, c, (points.x.shape[0], nl), points.x)
    if rows is None:
        return
    digs = rows[:2] if glv else (rows,)
    for d in digs:
        msm_lib.check_aux(kernel, d, (digs[0].shape[0], lanes), points.x)
    if glv:
        for flag in rows[2:]:
            if flag.dtype != torch.bool or tuple(flag.shape) != (lanes,) \
                    or flag.device != points.x.device:
                raise msm_lib.invalid(kernel, f"expected ({lanes},) bool sign flags")


def _launch(name: str, group: Group, points: Projective, rows, glv: bool, dims) -> Projective:
    require_instance(group)
    out = Projective(*(torch.empty_like(c) for c in points))
    if rows is None:
        digs, flags, ndig = (None, None), (None, None), 0
    elif glv:
        digs, flags, ndig = rows[:2], rows[2:], rows[0].shape[0]
    else:
        digs, flags, ndig = (rows, None), (None, None), rows.shape[0]
    ptr = [0 if t is None else t.data_ptr() for t in (*digs, *flags)]
    fn, error_string = _entry(group.nlimbs, name)
    with torch.cuda.device(points.x.device):
        err = fn(*(c.data_ptr() for c in points), *(c.data_ptr() for c in out), *ptr, *dims,
                 ndig, int(glv), group.nlimbs, ctypes.addressof(kernel_consts(group)),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise IcicleException(IcicleError.UNKNOWN_ERROR,
                              f"{name} launch failed: {error_string(err).decode()}")
    return out


def ecntt_stage(group: Group, points: Projective, m: int, rows, glv: bool) -> Projective:
    """One DIT stage of half-block m over (n, L) int32 Montgomery-form
    coordinates: new (n, L) tensors. On a CUDA tensor this launches the
    kernel on the current stream (no synchronisation), counts the launch in
    `ecntt_stage.launches` and raises if the launch is refused or the group
    has no instance; on a CPU tensor it computes `ecntt_stage_ref`."""
    n = points.x.shape[0]
    if m < 1 or n % (2 * m):
        raise msm_lib.invalid("ecntt_stage", f"half-block {m} does not divide {n} points")
    _check("ecntt_stage", group, points, rows, glv, m)
    if not points.x.is_cuda:
        return ecntt_stage_ref(group, points, m, rows, glv)
    out = _launch("icicle_ecntt_stage", group, points, rows, glv, (n, m, int(rows is not None)))
    ecntt_stage.launches += 1
    return out


def ecntt_scale(group: Group, points: Projective, rows) -> Projective:
    """Lane j of (n, L) coordinates times its own scalar, by the GLV ladder
    over rows covering the n lanes (the JAX package scales with GLV
    whatever ICICLE_TPU_ECNTT_GLV says): new tensors, as `ecntt_stage`
    (`ecntt_scale_ref` on the CPU)."""
    n = points.x.shape[0]
    _check("ecntt_scale", group, points, rows, True, n)
    if not points.x.is_cuda:
        return ecntt_scale_ref(group, points, rows)
    out = _launch("icicle_ecntt_scale", group, points, rows, True, (n, n, 1))
    ecntt_scale.launches += 1
    return out


ecntt_stage.launches = 0
ecntt_scale.launches = 0
