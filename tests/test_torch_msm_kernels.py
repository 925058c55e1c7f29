"""The port's MSM kernel modules (icicle_tpu_torch/kernels/msm_scan.py, B3,
and ec_reduce.py, B4) against the JAX package's XLA twins of the Pallas
kernels and the Pallas bodies' own formula functions, on the CPU.

On the CPU `prefix_scan` / `ec_reduce` compute their plain versions; the
CUDA kernels are held against those plain versions on the card by
chip_smoke.py. Where a test compares with the JAX package's serial order,
it passes segments=1 (tests/test_torch_msm_split.py covers the split).
The Pallas kernels themselves cannot run here: interpret mode did not
finish make_prefix_scan at K = 2, C = 128 in minutes.

Tolerance: exact equality of limbs, except where stated "as affine points":
the XLA twin of B4 starts its sum from row 0, the kernel from the identity,
which scales the projective coordinates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu.pallas import ec_reduce as JR
from icicle_tpu.pallas import msm_kernel as JMK
from icicle_tpu.pallas import msm_scan as JS
from icicle_tpu_torch.curves.group import Affine, Projective, get_group
from icicle_tpu_torch.curves.params import curve_names
from icicle_tpu_torch.kernels import ec_reduce as TR
from icicle_tpu_torch.kernels import msm_lib
from icicle_tpu_torch.kernels import msm_scan as TS
from icicle_tpu_torch.runtime.errors import IcicleException
from tests.ec_ref import ec_mul, ec_neg

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)

CURVE = "bn254"
NL = 8


def _pool(seed: int, n: int):
    c = jcurve(CURVE)
    rng = np.random.default_rng(seed)
    return [ec_mul((c.gen_x, c.gen_y), int(k), c.fq.modulus)
            for k in rng.integers(1, 1 << 40, size=n)]


def _mont_limbs(values) -> np.ndarray:
    """Python ints -> (n, L) uint32 Montgomery limbs."""
    fq = jcurve(CURVE).fq
    return np.asarray(fq.to_mont(fq.from_ints(list(values))))


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _scan_input(K: int, C: int, seed: int) -> np.ndarray:
    """(K, 2L, C) uint32 Montgomery x || y of curve points: lane 0 repeats
    one point, lane 1 alternates P, -P, the rest draw from a pool."""
    mod = jcurve(CURVE).fq.modulus
    pool = _pool(seed, 48)
    rng = np.random.default_rng(seed + 1)
    pts = [[pool[int(rng.integers(len(pool)))] for _ in range(C)] for _ in range(K)]
    for k in range(K):
        pts[k][0] = pool[0]
        pts[k][1] = pool[1] if k % 2 == 0 else ec_neg(pool[1], mod)
    flat = [p for row in pts for p in row]
    x = _mont_limbs([p[0] for p in flat]).reshape(K, C, NL)
    y = _mont_limbs([p[1] for p in flat]).reshape(K, C, NL)
    return np.ascontiguousarray(np.concatenate([x, y], -1).transpose(0, 2, 1))


def _reduce_input(R: int, C: int, seed: int) -> np.ndarray:
    """(R, 3L, C) uint32 projective Montgomery points with Z != 1: sums of
    two pool points, one row of identities, one P + (-P) lane pair."""
    tg = get_group(CURVE)
    mod = jcurve(CURVE).fq.modulus
    pool = _pool(seed, 32)
    rng = np.random.default_rng(seed + 1)
    a = [pool[int(rng.integers(len(pool)))] for _ in range(R * C)]
    b = [pool[int(rng.integers(len(pool)))] for _ in range(R * C)]
    b[1] = ec_neg(a[1], mod)                       # row 0, lane 1: P + (-P)
    P = tg.from_affine_canonical(*(_i32(np.asarray(jcurve(CURVE).fq.from_ints(v)))
                                   for v in ([p[0] for p in a], [p[1] for p in a])))
    Q = Affine(_i32(_mont_limbs([p[0] for p in b])), _i32(_mont_limbs([p[1] for p in b])))
    S = tg.madd(P, Q)                              # (R*C, L) each, Z != 1
    out = torch.stack(list(S), 1).reshape(R, C, 3, NL)
    if R > 2:
        out[2] = torch.stack(list(tg.identity((C,), "cpu")), 1).reshape(C, 3, NL)
    return _u32(out.permute(0, 2, 3, 1).reshape(R, 3 * NL, C).contiguous())


def _affine_ints(proj_3l_c: np.ndarray):
    """(3L, C) uint32 projective Montgomery -> list of affine int pairs."""
    fq = jcurve(CURVE).fq
    p = fq.modulus
    rinv = pow(1 << 256, -1, p)
    x, y, z = (fq.to_ints(proj_3l_c[i * NL:(i + 1) * NL].T) for i in range(3))
    out = []
    for xi, yi, zi in zip(x, y, z):
        zi = zi * rinv % p
        out.append(None if zi == 0 else
                   (xi * rinv * pow(zi, -1, p) % p, yi * rinv * pow(zi, -1, p) % p))
    return out


def test_prefix_scan_ref_matches_xla_twin():
    K, C = 8, 128
    x = _scan_input(K, C, seed=1)
    want = np.asarray(JS.make_prefix_scan_xla(CURVE, K, C)(jnp.asarray(x[None])))[0]
    got = TS.prefix_scan_ref(CURVE, _i32(x), segments=1)            # the serial fold
    assert got.shape == (K, 3 * NL, C) and got.dtype == torch.int32
    assert np.array_equal(_u32(got), want)
    # lane 1 sums P, -P, P, ...: the identity after every even slot
    assert not _u32(got)[1::2, 2 * NL:, 1].any()


def test_madd_matches_pallas_body_with_small_b3():
    """The port's mixed add (B3's per-slot step) against the Pallas body's
    formula function with its small-int b3 addition chain, on a few lanes."""
    c = jcurve(CURVE)
    f = JMK._ListField(c.fq.engine)
    lanes = 4
    P = _pool(3, lanes)
    Q = _pool(4, lanes)
    Q[1] = P[1]                                     # doubling through madd
    Q[2] = ec_neg(P[2], c.fq.modulus)               # P + (-P)
    px, py = _mont_limbs([p[0] for p in P]), _mont_limbs([p[1] for p in P])
    qx, qy = _mont_limbs([p[0] for p in Q]), _mont_limbs([p[1] for p in Q])
    one = np.broadcast_to(JMK._kernel_consts(CURVE)[1], px.shape)
    cols = lambda a: [jnp.asarray(a[:, i]) for i in range(NL)]
    want = JMK._madd_list(f, cols(px), cols(py), cols(one), cols(qx), cols(qy),
                          JMK._b3_small(c))
    got = get_group(CURVE).madd(Projective(_i32(px), _i32(py), _i32(one)),
                                Affine(_i32(qx), _i32(qy)))
    for g, w in zip(got, want):
        assert np.array_equal(_u32(g), np.stack([np.asarray(v) for v in w], -1))


@pytest.mark.parametrize("R", [1, 5, 8])
def test_ec_reduce_ref_matches_xla_twin_as_affine(R):
    C = 128
    x = _reduce_input(R, C, seed=10 + R)
    want = np.asarray(JR.make_ec_reduce_xla(CURVE, R, C)(jnp.asarray(x)))
    got = TR.ec_reduce_ref(CURVE, _i32(x))
    assert got.shape == (3 * NL, C) and got.dtype == torch.int32
    assert _affine_ints(_u32(got)) == _affine_ints(want)


def test_ec_reduce_ref_matches_padd_list_fold_from_identity():
    """Bit-exact against the Pallas body's own add, folded from the identity
    as the Pallas kernel folds (no row padding), on a few lanes."""
    R, C = 5, 4
    x = _reduce_input(R, C, seed=21)
    c = jcurve(CURVE)
    f = JMK._ListField(c.fq.engine)
    b3, one, _ = JMK._kernel_consts(CURVE)
    acc = ([jnp.zeros(C, jnp.uint32)] * NL,
           [jnp.full(C, v, jnp.uint32) for v in one],
           [jnp.zeros(C, jnp.uint32)] * NL)
    for r in range(R):
        row = [jnp.asarray(x[r, i]) for i in range(3 * NL)]
        acc = JR._padd_list(f, *acc, row[:NL], row[NL:2 * NL], row[2 * NL:],
                            JMK._b3_small(c))
    want = np.stack([np.asarray(v) for coord in acc for v in coord])
    assert np.array_equal(_u32(TR.ec_reduce_ref(CURVE, _i32(x), segments=1)), want)


def test_wrappers_on_cpu_compute_plain_versions_and_launch_nothing():
    TS.prefix_scan.launches = TR.ec_reduce.launches = 0
    x = _i32(_scan_input(3, 6, seed=30))
    assert torch.equal(TS.prefix_scan(CURVE, x, _segments=1),
                       TS.prefix_scan_ref(CURVE, x, segments=1))
    assert torch.equal(TS.prefix_scan(CURVE, x), TS.prefix_scan_ref(CURVE, x))
    y = _i32(_reduce_input(3, 5, seed=31))
    assert torch.equal(TR.ec_reduce(CURVE, y, _segments=1), TR.ec_reduce_ref(CURVE, y, segments=1))
    assert torch.equal(TR.ec_reduce(CURVE, y), TR.ec_reduce_ref(CURVE, y))
    assert TS.prefix_scan.launches == 0 and TR.ec_reduce.launches == 0


@pytest.mark.parametrize("fn,rows", [(TS.prefix_scan, 2 * NL), (TR.ec_reduce, 3 * NL)])
def test_wrappers_reject_bad_inputs(fn, rows):
    good = torch.zeros((2, rows, 4), dtype=torch.int32)
    for bad in (good.to(torch.int64),                       # dtype
                good[:, :-1],                               # limb rows
                good[0],                                    # rank
                good.transpose(0, 2).contiguous().transpose(0, 2),  # layout
                torch.zeros((2, rows, 4), dtype=torch.int32, device="meta")):
        with pytest.raises(IcicleException):
            fn(CURVE, bad)


def test_kernel_launch_rejects_other_limb_counts():
    """The CUDA kernels are built for 8 limbs: a 12-limb curve raises before
    anything is loaded or launched."""
    c = get_group("bls12_377").curve
    x = torch.zeros((2, 36, 4), dtype=torch.int32)
    with pytest.raises(IcicleException, match="8-limb"):
        msm_lib.launch("ec_reduce", c, x, x)


@pytest.mark.parametrize("name", curve_names())
def test_b3_small_matches_pallas_rule(name):
    """The kernels multiply by b3 as the small integer the Pallas bodies use."""
    assert msm_lib.b3_small(msm_lib.as_curve(name)) == JMK._b3_small(jcurve(name))


def test_kernel_launch_rejects_a_large_b3(monkeypatch):
    """An 8-limb curve whose b3 is no small integer raises before a launch."""
    monkeypatch.setattr(msm_lib, "b3_small", lambda curve: None)
    x = torch.zeros((2, 3 * NL, 4), dtype=torch.int32)
    with pytest.raises(IcicleException, match="small b3"):
        msm_lib.launch("ec_reduce", msm_lib.as_curve(CURVE), x, x)
