"""The split of B5's serial axis (icicle_tpu_torch/kernels/msm_scan_r12.py
`r12_segments`) in its plain version, on the CPU: the radix-12 projective
add `_padd_r12` of its carry scan against the u32 `group.add`, its
schedule against the overflow audit, the segmented scan against the
serial one and against the JAX package's XLA twin, and the r12 MSM over
it against the python-int oracle.

The CUDA kernel repeats the plain version's association and schedules and
is held bit for bit against it on the card by chip_smoke.py; here only the
plain version runs.

Tolerance: equality of points. R'-domain values are compared by cross
products (X1 Z2 = X2 Z1, Y1 Z2 = Y2 Z1, X1 Y2 = X2 Y1 mod p, neither
(0, 0, 0)) in Python integers, which holds in any Montgomery domain;
segments=1 and segment 0's rows are compared limb for limb.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu.pallas import msm_scan_r12 as JS12
from icicle_tpu.pallas.msm_scan_r12 import make_prefix_scan_r12_xla
from icicle_tpu_torch.curves.group import Projective, get_group
from icicle_tpu_torch.curves.params import get_curve
from icicle_tpu_torch.kernels import msm_lib
from icicle_tpu_torch.kernels import msm_scan_r12 as TS12
from icicle_tpu_torch.ops import msm_tpu3 as TM3
from icicle_tpu_torch.runtime.errors import IcicleException
from tests.ec_ref import INF, ec_add, ec_mul, ec_neg, msm_ref
from tests.test_torch_msm_r12 import _scan_input
from tests.test_torch_radix12 import _Recorder, header_schedules, jax_engine_at, schedule_codes

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)

CURVE = "bn254"
NL = 8
MOD = jcurve(CURVE).fq.modulus
ENG = TS12.r12_engine(CURVE)
RINV = pow(ENG.R, -1, MOD)          # out of the R' = 2^264 domain
B3 = 9                               # bn254's 3b, a small integer
LAZY = 2 * 4095
LANES = 5


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _words_int(words, lane: int) -> int:
    return sum(int(w[lane]) << (12 * k) for k, w in enumerate(words))


def _pool(n: int, seed: int):
    c = jcurve(CURVE)
    rng = np.random.default_rng(seed)
    return [ec_mul((c.gen_x, c.gen_y), int(k), MOD) for k in rng.integers(1, 1 << 40, size=n)]


def _affine_words(pts):
    """Affine int points -> normalised R'-domain (x, y) words, one lane each."""
    f = TS12._R12Field(ENG)
    rp = ENG.R % MOD
    lanes = [_i32(jcurve(CURVE).fq.from_ints([p[i] * rp % MOD for p in pts])) for i in (0, 1)]
    return [TS12._BVal(ENG.from_u32([t[:, j] for j in range(NL)]), f.NORM) for t in lanes]


def _lazy_sum(a, b):
    """Per lane, the identity + a + b by `_madd_r12`: lazy words (<= 2 * 4095)."""
    f = TS12._R12Field(ENG)
    state = _identity(len(a))
    for pts in (a, b):
        state = TS12._madd_r12(f, *state, *_affine_words(pts), B3)
    return state


def _identity(n: int):
    zero = [torch.zeros(n, dtype=torch.int32) for _ in range(ENG.nw)]
    one = [torch.full((n,), w, dtype=torch.int32) for w in ENG.one_mont]
    return [TS12._BVal(w, LAZY) for w in (zero, one, zero)]


def _point(state, lane: int):
    """Lazy R'-domain words -> the affine int point (INF for the identity)."""
    x, y, z = (_words_int(v.w, lane) * RINV % MOD for v in state)
    if z == 0:
        assert x == 0 and y != 0
        return INF
    zi = pow(z, -1, MOD)
    return (x * zi % MOD, y * zi % MOD)


def _u32_add(a, b):
    """The port's u32 `group.add` of the same two lazy points (moved to the
    2^256 Montgomery domain), as affine ints."""
    g = get_group(CURVE)
    fq = jcurve(CURVE).fq
    to_u32 = [[_i32(fq.from_ints([_words_int(v.w, i) * RINV * 2 ** 256 % MOD
                                  for i in range(len(v.w[0]))])) for v in p] for p in (a, b)]
    s = g.add(Projective(*to_u32[0]), Projective(*to_u32[1]))
    out = []
    for i in range(s.x.shape[0]):
        x, y, z = (int(fq.to_ints(np.asarray(c[i:i + 1].numpy().view(np.uint32)))[0])
                   * pow(2 ** 256, -1, MOD) % MOD for c in s)
        out.append(INF if z == 0 else (x * pow(z, -1, MOD) % MOD, y * pow(z, -1, MOD) % MOD))
    return out


def _padd_cases():
    """Six lanes: a generic sum, a doubling from two representatives of one
    point, P + (-P), the identity on the left (exact words, as the carry
    scan's carry_0), the identity on the right (a lazy P + (-P)), and both."""
    p = _pool(8, 3)
    a = _lazy_sum([p[0], p[0], p[2], p[2], p[4], p[4]], [p[1], p[1], p[3], p[3], p[5], p[6]])
    b = _lazy_sum([p[5], p[1], ec_neg(p[2], MOD), p[6], p[7], p[7]],
                  [p[6], p[0], ec_neg(p[3], MOD), p[7], ec_neg(p[7], MOD), ec_neg(p[7], MOD)])
    ident = _identity(6)
    for lane in (3, 5):                               # exact identity words on the left
        for v, e in zip(a, ident):
            for w, we in zip(v.w, e.w):
                w[lane] = we[lane]
    return a, b


def test_padd_r12_equals_u32_add_as_points():
    f = TS12._R12Field(ENG)
    a, b = _padd_cases()
    assert max(int(w.abs().max()) for v in a + b for w in v.w) > 4095   # lazy inputs
    out = TS12._padd_r12(f, *a, *b, B3)
    assert [v.b for v in out] == [LAZY] * 3
    assert max(int(w.abs().max()) for v in out for w in v.w) <= LAZY
    want = _u32_add(a, b)
    got = [_point(out, lane) for lane in range(6)]
    assert got == want
    assert got[2] is INF and got[4] == _point(a, 4) and got[5] is INF
    assert got[1] == ec_add(_point(a, 1), _point(b, 1), MOD)            # a doubling
    # the output is a valid state for the mixed add that follows it
    q = _pool(6, 4)
    nxt = TS12._madd_r12(f, *out, *_affine_words(q), B3)
    assert [_point(nxt, lane) for lane in range(6)] == [ec_add(g, qq, MOD)
                                                        for g, qq in zip(got, q)]


@pytest.mark.parametrize("curve", TS12.R12_CURVES)
def test_padd_schedule_is_the_audits(curve):
    """The projective add's normalisations, which the CUDA kernel applies
    (msm_scan_r12.cu padd_r12 over r12_schedules.cuh): 12 multiplies, 2 by
    b3 and the 2 norms after them, and those the audit puts into
    multiplies of lazy operands (6 on bn254), by the port's field and by
    the JAX package's, equal KERNEL_SCHEDULES and the header."""
    eng = TS12.r12_engine(curve)
    b3 = msm_lib.b3_small(get_curve(curve))
    rec = _Recorder(eng)
    f = TS12._R12Field(rec)
    TS12._padd_r12(f, *(TS12._BVal(["w"], LAZY) for _ in range(6)), b3)
    got = tuple(rec.log)
    codes = TS12.KERNEL_SCHEDULES[curve][1]
    assert [got.count(op) for op in ("mul", "mul_small")] == [12, 2]
    assert got.count("norm") == 2 + sum(bin(c).count("1") for c in codes)
    assert schedule_codes(TS12, eng, b3, padd=True) == schedule_codes(
        JS12, jax_engine_at(curve), b3, padd=True) == codes
    assert header_schedules()[curve]["padd"] == codes
    if curve == CURVE:
        assert codes == (0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 2, 1) and got.count("norm") == 8


def _ints(t: torch.Tensor, lane: int, k: int, nl: int = NL):
    a = t[k, :, lane].numpy().view(np.uint32).astype(object)
    return [sum(int(a[i * nl + j]) << (32 * j) for j in range(nl)) for i in range(3)]


def _same_points(a: torch.Tensor, b: torch.Tensor, curve: str = CURVE) -> bool:
    """(K, 3L, C) R'-domain outputs in [0, 4p), equal as projective points."""
    fq = jcurve(curve).fq
    mod, nl = fq.modulus, fq.nlimbs
    for k in range(a.shape[0]):
        for lane in range(a.shape[2]):
            (X1, Y1, Z1), (X2, Y2, Z2) = _ints(a, lane, k, nl), _ints(b, lane, k, nl)
            if not (X1 or Y1 or Z1) or not (X2 or Y2 or Z2):
                return False
            if (X1 * Z2 - X2 * Z1) % mod or (Y1 * Z2 - Y2 * Z1) % mod or (X1 * Y2 - X2 * Y1) % mod:
                return False
    return True


@functools.lru_cache(maxsize=None)
def _scan(K: int, curve: str = CURVE):
    x = _scan_input(K, LANES, 50 + K, curve)
    assert (x >= 1 << 31).any()
    return x


@functools.lru_cache(maxsize=None)
def _serial(K: int, curve: str = CURVE) -> torch.Tensor:
    return TS12.prefix_scan_r12_ref(curve, _i32(_scan(K, curve)), segments=1)


# bn254 at every (S, K); bls12_381 (12 limbs, nw 33) at two
SPLITS = [(S, K, CURVE) for K in (1, 5, 8, 13) for S in (2, 3, 4, 8)] + \
    [(4, 13, "bls12_381"), (3, 8, "bls12_381")]


@pytest.mark.parametrize("S,K,curve", SPLITS)
def test_prefix_scan_r12_split_equals_serial_as_points(S, K, curve):
    """Ragged last segments (13 = 4 + 4 + 4 + 1 at S 4), empty segments and
    K < S included; segment 0's rows are the serial ones, limb for limb;
    every value in [0, 4p)."""
    fq = jcurve(curve).fq
    got = TS12.prefix_scan_r12_ref(curve, _i32(_scan(K, curve)), segments=S)
    want = _serial(K, curve)
    assert got.shape == want.shape == (K, 3 * fq.nlimbs, LANES) and got.dtype == torch.int32
    assert _same_points(got, want, curve)
    n = -(-K // S)
    assert torch.equal(got[:n], want[:n])
    assert all(0 <= v < 4 * fq.modulus for k in range(K) for lane in range(LANES)
               for v in _ints(got, lane, k, fq.nlimbs))


def test_prefix_scan_r12_split_changes_the_representative():
    assert not torch.equal(TS12.prefix_scan_r12_ref(CURVE, _i32(_scan(13)), segments=4),
                           _serial(13))


def test_prefix_scan_r12_serial_matches_xla_twin():
    K = 5
    with jax.disable_jit():
        want = np.asarray(make_prefix_scan_r12_xla(CURVE, K, LANES)(jnp.asarray(_scan(K)[None])))[0]
    assert np.array_equal(_serial(K).numpy().view(np.uint32), want)


def test_default_plan_and_cpu_wrapper():
    x = _i32(_scan(13))
    S = TS12.r12_segments(13, LANES)
    assert S == 2
    TS12.prefix_scan_r12.launches = 0
    got = TS12.prefix_scan_r12(CURVE, x)
    assert torch.equal(got, TS12.prefix_scan_r12_ref(CURVE, x))
    assert torch.equal(got, TS12.prefix_scan_r12_ref(CURVE, x, segments=S))
    assert torch.equal(TS12.prefix_scan_r12(CURVE, x, _segments=3),
                       TS12.prefix_scan_r12_ref(CURVE, x, segments=3))
    assert TS12.prefix_scan_r12.launches == 0


@pytest.mark.parametrize("K,C,S", [
    (8192, 4096, 8),      # v3 r12 2^24: one window group, one wave of blocks
    (8192, 64, 64),       # v3 2^16: S * S <= K caps it
    (64, 4096, 8),        # chip_smoke.py's cut depth
    (61, 4096, 4),        # ... ragged
    (1, 4096, 1),
    (16, 100000, 1),      # enough lanes already
])
def test_r12_segments_pinned(K, C, S):
    assert TS12.r12_segments(K, C) == S


@pytest.mark.parametrize("fn,S", [(TS12.prefix_scan_r12, 0), (TS12.prefix_scan_r12, 2.0),
                                  (TS12.prefix_scan_r12, 1 << 16),
                                  (TS12.prefix_scan_r12_ref, 0)])
def test_prefix_scan_r12_rejects_bad_segments(fn, S):
    kw = {"segments": S} if fn is TS12.prefix_scan_r12_ref else {"_segments": S}
    with pytest.raises(IcicleException):
        fn(CURVE, torch.zeros((4, 2 * NL, 3), dtype=torch.int32), **kw)


def test_msm_tpu3_r12_torch_backend_with_split_equals_oracle():
    """K = T = 64 slots over 1 tile x 8 windows a group: the r12 plan gives
    S = 8, so the split scan runs in the MSM."""
    c = jcurve(CURVE)
    rng = np.random.default_rng(71)
    pts = _pool(64, 72)
    pts[5] = pts[4]                                       # a doubling in a bucket
    scalars = [int(s) for s in rng.integers(0, 1 << 62, size=64)]
    s = _i32(c.fr.from_ints(scalars))
    x, y = (_i32(c.fq.from_ints([p[i] for p in pts])) for i in (0, 1))
    plan = TM3.msm_tpu3_prepare(CURVE, x, y, c=6, T=64, engine="r12")
    assert TS12.r12_segments(plan["T"], plan["wg"] * plan["tiles"]) == 8
    want = msm_ref(scalars, pts, MOD)
    got = TM3.msm_tpu3(CURVE, s, prepared=plan, backend="torch")
    assert got == (want if want is not INF else (0, 0))
