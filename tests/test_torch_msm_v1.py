"""The port's v1 bucket-accumulation MSM on the CPU: kernel B7's plain
version `bucket_accum_ref` against the JAX package's XLA twin
`make_bucket_accum_xla` (after a layout transpose) at the rows B7 writes,
the wrapper's checks,
`_plan`, `_auto_c` and `_auto_wchunk` against JAX's, the roll-scans
`_segmented_scan_add` and `_prefix_scan_add` against JAX's, and `msm_tpu`
on the cases of tests/test_msm_tpu.py (and window chunks) against the
python-int oracle tests/ec_ref.py. Tolerance: exact equality (of limbs
where the functions compute the same adds in the same order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_tpu.curves.group import Projective as JProjective
from icicle_tpu.curves.group import get_group as jgroup
from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu.ops import msm as JM
from icicle_tpu.ops import msm_tpu as JM1
from icicle_tpu.pallas.msm_kernel import make_bucket_accum_xla
from icicle_tpu_torch.curves.group import Affine, Projective, get_group
from icicle_tpu_torch.kernels import msm_kernel as TK
from icicle_tpu_torch.ops import msm as TM
from icicle_tpu_torch.ops import msm_tpu as TM1
from icicle_tpu_torch.runtime.errors import IcicleException
from tests.ec_ref import INF, ec_mul, msm_ref

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)

CURVE = "bn254"
NL = 8
MOD = jcurve(CURVE).fq.modulus


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def _points(n, seed, bits=28):
    c = jcurve(CURVE)
    rng = np.random.default_rng(seed)
    return [ec_mul((c.gen_x, c.gen_y), int(k), MOD) for k in rng.integers(1, 1 << bits, size=n)]


def _mont(values) -> np.ndarray:
    fq = jcurve(CURVE).fq
    return np.asarray(fq.to_mont(fq.from_ints(list(values))))


def _tensors(scalars, pts):
    c = jcurve(CURVE)
    return (_i32(c.fr.from_ints(scalars)), _i32(c.fq.from_ints([p[0] for p in pts])),
            _i32(c.fq.from_ints([p[1] for p in pts])))


def _want(scalars, pts):
    w = msm_ref(scalars, pts, MOD)
    return w if w is not INF else (0, 0)


def test_bucket_accum_ref_matches_xla_twin():
    """Key runs that restart inside a lane, a doubling (the same point twice
    in a run), W = 2 windows; compared at the rows B7 promises, with the
    serial fold (segments=1), the twin's order."""
    W, K, C = 2, 6, 8
    pts = _points(W * K * C, 1)
    pts[C] = pts[0]                                  # window 0, lane 0: P then P
    px = _mont([p[0] for p in pts]).reshape(W, K, C, NL)
    py = _mont([p[1] for p in pts]).reshape(W, K, C, NL)
    keys = np.sort(np.random.default_rng(2).integers(0, 4, size=(W, K, C)), axis=1).astype(np.int32)
    keys[0, :2, 0] = 3                               # keep lane 0's run
    vx, vy, vz = make_bucket_accum_xla(CURVE, W, K, C)(jnp.asarray(keys), jnp.asarray(px),
                                                       jnp.asarray(py))
    want = np.concatenate([np.asarray(v) for v in (vx, vy, vz)], -1)        # (W, K, C, 3L)
    plimbs = np.ascontiguousarray(np.concatenate([px, py], -1).transpose(0, 1, 3, 2))
    got = TK.bucket_accum_ref(CURVE, torch.from_numpy(keys), _i32(plimbs), segments=1)
    assert got.shape == (W, K, 3 * NL, C) and got.dtype == torch.int32
    # the contract: run ends and each lane's last slot, the rest zero
    rows = TK.contract_rows(torch.from_numpy(keys)).numpy()               # (W, K, C)
    assert np.array_equal(_u32(got.transpose(2, 3))[rows], want[rows])
    assert not _u32(got.transpose(2, 3))[~rows].any()
    TK.bucket_accum.launches = 0
    assert torch.equal(TK.bucket_accum(CURVE, torch.from_numpy(keys), _i32(plimbs), _segments=1),
                       got)
    assert TK.bucket_accum.launches == 0


def test_bucket_accum_rejects_bad_inputs():
    pts = torch.zeros((2, 3, 2 * NL, 4), dtype=torch.int32)
    keys = torch.zeros((2, 3, 4), dtype=torch.int32)
    for bad_keys, bad_pts in ((keys, pts[0]), (keys, pts[:, :, :-1]), (keys, pts.to(torch.int64)),
                              (keys[:, :-1], pts), (keys.to(torch.int64), pts),
                              (keys.transpose(1, 2).contiguous().transpose(1, 2), pts)):
        with pytest.raises(IcicleException):
            TK.bucket_accum(CURVE, bad_keys, bad_pts)


@pytest.mark.parametrize("n", [1, 7, 64, 1000, 1 << 16, 1 << 20, 1 << 24])
def test_plan_auto_c_and_wchunk_match_jax(n):
    nbits = jcurve(CURVE).fr.modulus.bit_length()
    assert TM._auto_c(n) == JM._auto_c(n)
    for c, lanes in ((None, 1024), (6, 8)):
        lanes = min(lanes, n) if n % min(lanes, n) == 0 else 1
        assert TM1._plan(n, c, nbits, lanes) == JM1._plan(n, c, nbits, lanes)
    W = TM1._plan(n, None, nbits, 1)[1]
    assert TM1._auto_wchunk(n, W, NL) == JM1._auto_wchunk(n, W, NL)
    if n == 1 << 20:                                 # the 2^20 shape on the card
        assert TM._auto_c(n) == 16
        assert TM1._plan(n, None, nbits, 1024) == (12, 22, 1024, 1024)
        assert TM1._auto_wchunk(n, 22, NL) == 12


def test_plan_refuses_unaligned_n():
    with pytest.raises(IcicleException, match="multiple of the lane count"):
        TM1._plan(100, 6, 254, 16)


def _scan_points(n, seed):
    """n projective points with Z != 1 (sums of two affine points) as JAX
    and torch Projectives over the same Montgomery limbs."""
    a, b = _points(n, seed), _points(n, seed + 1)
    tg = get_group(CURVE)
    pa = Projective(_i32(_mont([p[0] for p in a])), _i32(_mont([p[1] for p in a])),
                    tg.one_mont("cpu").expand(n, NL))
    s = tg.madd(pa, Affine(_i32(_mont([p[0] for p in b])), _i32(_mont([p[1] for p in b]))))
    return JProjective(*(jnp.asarray(_u32(v)) for v in s)), s


def test_segmented_and_prefix_scans_match_jax():
    n = 8
    jp, tp = _scan_points(n, 3)
    flags = np.array([1, 0, 0, 1, 1, 0, 0, 0], dtype=bool)
    want = JM._segmented_scan_add(jgroup(CURVE), jp, jnp.asarray(flags))
    got = TM._segmented_scan_add(get_group(CURVE), tp, torch.from_numpy(flags))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), _u32(g))
    want = JM._prefix_scan_add(jgroup(CURVE), jp)
    got = TM._prefix_scan_add(get_group(CURVE), tp)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), _u32(g))
    # a batch dimension behind the scan axis computes each column alone
    batched = Projective(*(torch.stack([v, v.flip(0)], 1) for v in tp))
    got2 = TM._prefix_scan_add(get_group(CURVE), batched)
    for w, g in zip(want, got2):
        assert np.array_equal(np.asarray(w), _u32(g[:, 0]))


@pytest.mark.parametrize("n,lanes,c", [(64, 8, 6), (128, 16, 0)])
def test_msm_tpu_vs_oracle(n, lanes, c):
    rng = np.random.default_rng(n)
    pts = _points(n, n)
    scalars = [int.from_bytes(rng.bytes(40), "little") % jcurve(CURVE).fr.modulus
               for _ in range(n)]
    assert TM1.msm_tpu(CURVE, *_tensors(scalars, pts), c=c or None, lanes=lanes) \
        == _want(scalars, pts)


def test_msm_tpu_skewed_zeros_and_window_chunks():
    n, lanes = 64, 8
    rng = np.random.default_rng(3)
    pts = _points(n, 3, bits=20)
    scalars = [0] * (n // 2) + [int(s) for s in rng.integers(0, 1 << 16, size=n // 2)]
    args = _tensors(scalars, pts)
    want = _want(scalars, pts)
    assert TM1.msm_tpu(CURVE, *args, lanes=lanes) == want
    # 43 windows in chunks of 5 (the last padded with zero digits)
    assert TM1.msm_tpu(CURVE, *args, c=6, lanes=lanes, wchunk=5) == want


def test_msm_tpu_one_bucket_takes_every_point():
    pts = _points(32, 9)
    scalars = [(13 << 12) | 5] * 32
    assert TM1.msm_tpu(CURVE, *_tensors(scalars, pts), c=5, lanes=4) == _want(scalars, pts)
