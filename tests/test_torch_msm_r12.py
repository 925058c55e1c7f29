"""The port's radix-12 engine of the v3 MSM on the CPU: kernel B5's plain
version `prefix_scan_r12_ref` against the JAX package's XLA twin
`make_prefix_scan_r12_xla` (run under jax.disable_jit(), so that its
lax.scan runs eagerly and skips a multi-minute CPU compile), the wrapper's
checks, `msm_tpu3(engine="r12")` against the python-int oracle
tests/ec_ref.py and against the "u32" engine, the engine's selection, JAX
r12-prepared bases carried over by `interop.prepared_from_numpy`, and
`BigField.mul_mont` on the [0, 4p) values the r12 unshift feeds it.
Tolerance: exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu.ops.msm_tpu3 import msm_tpu3_prepare as jax_prepare
from icicle_tpu.pallas.msm_scan_r12 import make_prefix_scan_r12_xla
from icicle_tpu_torch import MSMConfig, get_curve, interop, msm_affine
from icicle_tpu_torch.kernels import msm_scan as TS
from icicle_tpu_torch.kernels import msm_scan_r12 as TS12
from icicle_tpu_torch.ops import msm_tpu3 as TM3
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException
from tests.ec_ref import INF, ec_add, ec_mul, ec_neg, msm_ref

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)

CURVE = "bn254"
NL = 8
MOD = jcurve(CURVE).fq.modulus
R = jcurve(CURVE).fr.modulus


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _points(n, seed, curve=CURVE):
    c = jcurve(curve)
    rng = np.random.default_rng(seed)
    return [ec_mul((c.gen_x, c.gen_y), int(k), c.fq.modulus)
            for k in rng.integers(1, 1 << 28, size=n)]


def _tensors(scalars, pts):
    c = jcurve(CURVE)
    return (_i32(c.fr.from_ints(scalars)), _i32(c.fq.from_ints([p[0] for p in pts])),
            _i32(c.fq.from_ints([p[1] for p in pts])))


def _want(scalars, pts):
    w = msm_ref(scalars, pts, MOD)
    return w if w is not INF else (0, 0)


def _scan_lanes(K, C, seed, curve=CURVE):
    """(K, C) affine curve points; lane 1 alternates P and -P."""
    mod = jcurve(curve).fq.modulus
    pool = _points(16, seed, curve)
    rng = np.random.default_rng(seed + 1)
    pts = [[pool[int(rng.integers(len(pool)))] for _ in range(C)] for _ in range(K)]
    for k in range(K):
        pts[k][1] = pool[0] if k % 2 == 0 else ec_neg(pool[0], mod)
    return pts


def _scan_input(K, C, seed, curve=CURVE, pts=None):
    """(K, 2L, C) uint32 R'-domain x || y of `_scan_lanes` points,
    canonical."""
    fq = jcurve(curve).fq
    mod, nl = fq.modulus, fq.nlimbs
    rp = TS12.r12_engine(curve).R % mod
    flat = [p for row in (pts or _scan_lanes(K, C, seed, curve)) for p in row]
    x = np.asarray(fq.from_ints([p[0] * rp % mod for p in flat])).reshape(K, C, nl)
    y = np.asarray(fq.from_ints([p[1] * rp % mod for p in flat])).reshape(K, C, nl)
    return np.ascontiguousarray(np.concatenate([x, y], -1).transpose(0, 2, 1))


# B5's plain version against the JAX twin where the port's word count is the
# JAX package's (bn254, bls12_377; bw6_761's twin compiles for minutes:
# slow), else (grumpkin, bls12_381, one word more) and for bw6_761 in tier 1
# against Python ints, as projective points
TWIN = {CURVE: "twin", "bls12_377": "twin", "grumpkin": "oracle", "bls12_381": "oracle",
        "bw6_761": "oracle"}


@pytest.mark.parametrize("curve,against", [*TWIN.items(),
                                           pytest.param("bw6_761", "twin",
                                                        marks=pytest.mark.slow)])
def test_prefix_scan_r12_ref_matches_xla_twin(curve, against):
    K, C = 3, 8
    fq = jcurve(curve).fq
    mod, nl = fq.modulus, fq.nlimbs
    lanes = _scan_lanes(K, C, 1, curve)
    x = _scan_input(K, C, 1, curve, lanes)
    assert (x >= 1 << 31).any()
    got = TS12.prefix_scan_r12_ref(curve, _i32(x))
    assert got.shape == (K, 3 * nl, C) and got.dtype == torch.int32
    out = got.numpy().view(np.uint32)
    if against == "twin":
        assert TS12.r12_engine(curve).nw == TS12.Radix12(mod).nw
        with jax.disable_jit():
            want = np.asarray(make_prefix_scan_r12_xla(curve, K, C)(jnp.asarray(x[None])))[0]
        assert np.array_equal(out, want)
    rinv = pow(TS12.r12_engine(curve).R, -1, mod)
    for lane in range(C):
        acc = INF
        for k in range(K):
            acc = ec_add(acc, lanes[k][lane], mod)
            vals = [fq.to_ints(out[k, i * nl:(i + 1) * nl, lane][None])[0] for i in range(3)]
            assert all(0 <= v < 4 * mod for v in vals)          # every value in [0, 4p)
            X, Y, Z = (int(v) * rinv % mod for v in vals)
            assert (None if Z == 0 else (X * pow(Z, -1, mod) % mod, Y * pow(Z, -1, mod) % mod)) \
                == acc


def test_wrapper_on_cpu_computes_plain_version_and_launches_nothing():
    TS12.prefix_scan_r12.launches = 0
    x = _i32(_scan_input(2, 5, seed=2))
    assert torch.equal(TS12.prefix_scan_r12(CURVE, x), TS12.prefix_scan_r12_ref(CURVE, x))
    assert TS12.prefix_scan_r12.launches == 0


def test_wrapper_rejects_bad_inputs_and_other_curves():
    good = torch.zeros((2, 2 * NL, 4), dtype=torch.int32)
    for bad in (good.to(torch.int64), good[:, :-1], good[0],
                good.transpose(0, 2).contiguous().transpose(0, 2),
                torch.zeros((2, 2 * NL, 4), dtype=torch.int32, device="meta")):
        with pytest.raises(IcicleException):
            TS12.prefix_scan_r12(CURVE, bad)
    # the kernel holds every G1 curve's schedule: grumpkin (8 limbs, nw 23)
    # and bls12_377 (12 limbs, nw 32) get consts {curve, p, 2p, R', inv12, b3}
    for name, nw in (("grumpkin", 23), ("bls12_377", 32)):
        consts = TS12.kernel_consts(get_curve(name))
        assert TS12.r12_engine(name).nw == nw and len(consts) == 1 + 3 * nw + 2
        assert consts[0] == TS12.R12_CURVES.index(name)
    assert len(TS12.kernel_consts(get_curve(CURVE))) == 1 + 3 * 22 + 2


def test_unaligned_and_zeros():
    pts = _points(56, 7)
    rng = np.random.default_rng(8)
    scalars = [0] * 28 + [int(s) for s in rng.integers(0, 1 << 16, size=28)]
    assert TM3.msm_tpu3(CURVE, *_tensors(scalars, pts), c=6, T=16, engine="r12") \
        == _want(scalars, pts)


def test_skewed_same_digit_equals_u32_engine():
    pts = _points(32, 9)
    scalars = [(13 << 12) | 5] * 32
    args = _tensors(scalars, pts)
    got = TM3.msm_tpu3(CURVE, *args, c=5, T=16, engine="r12")
    assert got == _want(scalars, pts)
    assert got == TM3.msm_tpu3(CURVE, *args, c=5, T=16, engine="u32")


def test_repeated_point_and_all_zero():
    c = jcurve(CURVE)
    P = ec_mul((c.gen_x, c.gen_y), 0xDEADBEEF, MOD)
    rng = np.random.default_rng(11)
    scalars = [int(s) for s in rng.integers(0, 1 << 62, size=48)]
    s, x, y = _tensors(scalars, [P] * 48)
    prepared = TM3.msm_tpu3_prepare(CURVE, x, y, c=6, T=16, engine="r12")
    assert prepared["engine"] == "r12"
    assert TM3.msm_tpu3(CURVE, s, prepared=prepared) == ec_mul(P, sum(scalars) % R, MOD)
    assert TM3.msm_tpu3(CURVE, torch.zeros_like(s), prepared=prepared) == (0, 0)
    # an explicit engine that differs from the prepared one is refused
    with pytest.raises(IcicleException, match="prepared") as e:
        TM3.msm_tpu3(CURVE, s, prepared=prepared, engine="u32")
    assert e.value.code == IcicleError.INVALID_ARGUMENT


def test_engine_from_environment(monkeypatch):
    pts = _points(24, 13)
    scalars = [int(v) for v in np.random.default_rng(14).integers(0, 1 << 40, size=24)]
    s, x, y = _tensors(scalars, pts)
    monkeypatch.setenv("ICICLE_TPU_MSM_ENGINE", "r12")
    assert TM3.msm_tpu3_prepare(CURVE, x, y, c=6)["engine"] == "r12"
    # engine= wins over the variable
    assert TM3.msm_tpu3_prepare(CURVE, x, y, c=6, engine="u32")["engine"] == "u32"
    # msm_affine under the variable runs the r12 engine (T cut to 16 slots)
    seen = []
    real_kernels, real_plan = TM3._kernels, TM3._plan3
    monkeypatch.setattr(TM3, "_kernels", lambda b, s_, e: seen.append(e) or real_kernels(b, s_, e))
    monkeypatch.setattr(TM3, "_plan3", lambda n, c, nbits, T, wg=None: real_plan(n, c, nbits, 16, wg))
    TS.prefix_scan.launches = TS12.prefix_scan_r12.launches = 0
    assert msm_affine(CURVE, s, x, y, MSMConfig(c=6)) == _want(scalars, pts)
    assert seen == ["r12"]
    assert TS.prefix_scan.launches == TS12.prefix_scan_r12.launches == 0
    monkeypatch.setenv("ICICLE_TPU_MSM_ENGINE", "r13")
    with pytest.raises(IcicleException, match="unknown engine"):
        TM3.msm_tpu3_prepare(CURVE, x, y, c=6)


@pytest.mark.parametrize("curve", [CURVE, "grumpkin"])
def test_prepared_from_jax_r12_bases(curve):
    """grumpkin: the JAX package's R' = 2^264, moved into the port's 2^276."""
    c = jcurve(curve)
    pts = _points(40, 15, curve)
    rng = np.random.default_rng(16)
    scalars = [int.from_bytes(rng.bytes(40), "little") % c.fr.modulus for _ in range(40)]
    px = np.asarray(c.fq.from_ints([p[0] for p in pts]))
    py = np.asarray(c.fq.from_ints([p[1] for p in pts]))
    with jax.disable_jit():        # eager: skips a ~40 s CPU compile of _prep_fn3
        jprep = jax_prepare(curve, px, py, c=6, T=16, engine="r12")
        jprep["pts_u8"] = np.asarray(jprep["pts_u8"])
    prepared = interop.prepared_from_numpy(curve, jprep, "cpu")
    own = TM3.msm_tpu3_prepare(curve, _i32(px), _i32(py), c=6, T=16, engine="r12")
    assert prepared["engine"] == own["engine"] == "r12"
    assert torch.equal(own["pts"], prepared["pts"])            # R'-domain limbs
    got = TM3.msm_tpu3(curve, _i32(c.fr.from_ints(scalars)), prepared=prepared)
    want = msm_ref(scalars, pts, c.fq.modulus)
    assert got == ((0, 0) if want is INF else want)


def test_bigfield_mul_mont_takes_values_below_4p():
    """The r12 unshift multiplies values in [0, 4p) (msm_tpu3.py:281-287):
    BigField.mul_mont gives JAX fq.mul_mont's canonical limbs there."""
    jfq = jcurve(CURVE).fq
    tfq = get_curve(CURVE).fq
    rng = np.random.default_rng(17)
    a = [int.from_bytes(rng.bytes(40), "little") % (3 * MOD) + MOD for _ in range(30)]
    a += [MOD, 2 * MOD, 4 * MOD - 1, 4 * MOD - 2]
    b = [int.from_bytes(rng.bytes(40), "little") % MOD for _ in range(len(a))]
    b[-1] = pow(2, 64 * NL - TS12.r12_engine(CURVE).rbits, MOD)
    limbs = lambda v: np.array([[(x >> (32 * i)) & 0xFFFFFFFF for i in range(NL)] for x in v],
                               dtype=np.uint32)
    want = np.asarray(jfq.mul_mont(jnp.asarray(limbs(a)), jnp.asarray(limbs(b))))
    got = tfq.mul_mont(_i32(limbs(a)), _i32(limbs(b)))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    rinv = pow(1 << 256, -1, MOD)
    assert list(tfq.to_ints(got)) == [x * y * rinv % MOD for x, y in zip(a, b)]


@pytest.mark.parametrize("curve_name", ["bn254", "grumpkin", "bls12_381"])
def test_div_pow2_equals_the_unshift_multiply(curve_name):
    """The port's unshift, BigField.div_pow2(v, 12 nw - 32 L), gives the
    canonical limbs of the JAX package's Montgomery multiply by
    2^(64 L - 12 nw), on values in [0, 4p) with limbs >= 2^31."""
    jfq = jcurve(curve_name).fq
    tfq = get_curve(curve_name).fq
    p, nl = jfq.modulus, jfq.nlimbs
    rbits = TS12.r12_engine(curve_name).rbits
    rng = np.random.default_rng(18)
    a = [int.from_bytes(rng.bytes(56), "little") % (4 * p) for _ in range(40)]
    a += [0, 1, p - 1, p, 2 * p + 1, 4 * p - 1]
    arr = np.array([[(x >> (32 * i)) & 0xFFFFFFFF for i in range(nl)] for x in a],
                   dtype=np.uint32)
    sh = np.asarray(jfq.params.const_limbs32((1 << (64 * nl - rbits)) % p), dtype=np.uint32)
    want = np.asarray(jfq.mul_mont(jnp.asarray(arr), jnp.asarray(sh)[None]))
    got = tfq.engine.div_pow2(_i32(arr), rbits - 32 * nl)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(tfq.mul_mont(_i32(arr), _i32(sh)).numpy().view(np.uint32), want)
