"""The split of B7's serial axis (icicle_tpu_torch/kernels/msm_kernel.py
`accum_segments`) in its plain version, on the CPU: each segment's fold
restarting at its first slot and at every key change, the carry scan that
stops at a reset, and the fixup of each segment's first run end, against
the JAX package's XLA twin `make_bucket_accum_xla` at the rows B7 promises
(`contract_rows`: run ends and each lane's last slot); the plan; and the
v1 MSM over the split against the python-int oracle.

The CUDA kernel repeats the plain version's association and is held bit
for bit against it on the card by chip_smoke.py; here only the plain
version runs.

Tolerance: limb for limb at segments=1 (the twin's serial fold); equality
of affine points at other S (the split gives other projective
coordinates of the same points).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu.pallas.msm_kernel import make_bucket_accum_xla
from icicle_tpu_torch.kernels import msm_kernel as TK
from icicle_tpu_torch.ops import msm_tpu as TM1
from tests.ec_ref import INF, ec_mul, msm_ref
from tests.test_torch_msm_kernels import _affine_ints, _i32, _scan_input, _u32

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)

CURVE = "bn254"
NL = 8
W, C = 2, 4


def _keys(K: int, seed: int) -> np.ndarray:
    """(W, K, C) keys sorted along each lane; window 0's lane 0 one run over
    all K slots, its lane 1 a new key at every slot."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 6, size=(W, K, C)), axis=1).astype(np.int32)
    keys[0, :, 0] = 3
    keys[0, :, 1] = np.arange(K)
    return keys


# a 12-limb curve beside bn254 for the split's twin comparisons
WIDE = "bls12_381"


@functools.lru_cache(maxsize=None)
def _case(K: int, curve: str = CURVE):
    """(keys, points (W, K, 2L, C) uint32, the twin's output (W, K, 3L, C))."""
    keys = _keys(K, seed=K)
    pts = np.stack([_scan_input(K, C, 40 + K + w, curve) for w in range(W)])  # (W, K, 2L, C)
    nl = pts.shape[2] // 2
    px = np.ascontiguousarray(pts[:, :, :nl].transpose(0, 1, 3, 2))          # (W, K, C, L)
    py = np.ascontiguousarray(pts[:, :, nl:].transpose(0, 1, 3, 2))
    vx, vy, vz = make_bucket_accum_xla(curve, W, K, C)(jnp.asarray(keys), jnp.asarray(px),
                                                       jnp.asarray(py))
    want = np.concatenate([np.asarray(v) for v in (vx, vy, vz)], -1).transpose(0, 1, 3, 2)
    return keys, pts, np.ascontiguousarray(want)


def _affine_rows(out: np.ndarray, rows: np.ndarray, curve: str = CURVE) -> list:
    """The affine points of (W, K, 3L, C) uint32 at the rows (W, K, C)."""
    return [p for w in range(W) for k in range(out.shape[1])
            for p, keep in zip(_affine_ints(out[w, k], curve), rows[w, k]) if keep]


@pytest.mark.parametrize("K,curve", [(24, CURVE), (61, CURVE), (24, WIDE)])
def test_serial_fold_is_bit_exact_with_xla_twin(K, curve):
    keys, pts, want = _case(K, curve)
    got = TK.bucket_accum_ref(curve, torch.from_numpy(keys), _i32(pts), segments=1)
    assert got.shape == (W, K, 3 * jcurve(curve).fq.nlimbs, C) and got.dtype == torch.int32
    rows = TK.contract_rows(torch.from_numpy(keys)).numpy()
    assert np.array_equal(_u32(got).transpose(0, 1, 3, 2)[rows],
                          want.transpose(0, 1, 3, 2)[rows])
    assert not _u32(got).transpose(0, 1, 3, 2)[~rows].any()


@pytest.mark.parametrize("K,S,curve", [(24, 3, CURVE), (24, 8, CURVE), (61, 3, CURVE),
                                       (61, 8, CURVE), (24, 3, WIDE)])
def test_split_fold_matches_xla_twin_as_points(K, S, curve):
    """K 61 leaves a ragged last segment (8 slots of 8 at S 8, 5 of 21 at
    S 3); window 0's lane 0 carries one run through every segment and its
    lane 1 resets at every slot."""
    keys, pts, want = _case(K, curve)
    got = TK.bucket_accum_ref(curve, torch.from_numpy(keys), _i32(pts), segments=S)
    rows = TK.contract_rows(torch.from_numpy(keys)).numpy()
    assert _affine_rows(_u32(got), rows, curve) == _affine_rows(want, rows, curve)
    assert rows[0, :, 1].all() and rows[0, :, 0].sum() == 1        # the two edge lanes
    serial = TK.bucket_accum_ref(curve, torch.from_numpy(keys), _i32(pts), segments=1)
    assert not torch.equal(got, serial)                            # the split took effect


def test_split_writes_only_the_contract_rows():
    keys, pts, _ = _case(24)
    got = TK.bucket_accum_ref(CURVE, torch.from_numpy(keys), _i32(pts), segments=3)
    rows = TK.contract_rows(torch.from_numpy(keys))
    assert not got.transpose(2, 3)[~rows].any()
    assert got.transpose(2, 3)[rows].any(-1).all()


def test_contract_rows():
    keys = torch.tensor([[[1, 2], [1, 2], [3, 2]]], dtype=torch.int32)    # (1, K 3, C 2)
    assert TK.contract_rows(keys).tolist() == [[[False, False], [True, False], [True, True]]]


@pytest.mark.parametrize("K,pairs,S", [(1024, 12 * 1024, 8), (1024, 1024, 32), (6, 16, 2),
                                       (24, 8, 4), (3, 8, 1), (1 << 14, 1 << 15, 2)])
def test_plan(K, pairs, S):
    """Doubling S from 1 while S * pairs is below about two waves of blocks
    (2^16 threads) and 4 S^2 <= K; v1 2^20 takes 8."""
    assert TK.accum_segments(K, pairs) == S


@pytest.mark.parametrize("S", [1, 3])
def test_wrapper_on_cpu_is_the_plain_version(S):
    keys, pts, _ = _case(24)
    TK.bucket_accum.launches = 0
    got = TK.bucket_accum(CURVE, torch.from_numpy(keys), _i32(pts), _segments=S)
    assert torch.equal(got, TK.bucket_accum_ref(CURVE, torch.from_numpy(keys), _i32(pts), S))
    assert TK.bucket_accum.launches == 0


def test_msm_tpu_over_the_split_vs_oracle():
    """n 128 on 4 lanes: K 32 slots a lane, which the plan splits in 4."""
    n, lanes = 128, 4
    c = jcurve(CURVE)
    rng = np.random.default_rng(17)
    pts = [ec_mul((c.gen_x, c.gen_y), int(k), c.fq.modulus)
           for k in rng.integers(1, 1 << 28, size=n)]
    scalars = [int.from_bytes(rng.bytes(40), "little") % c.fr.modulus for _ in range(n)]
    _, n_windows, K, C = TM1._plan(n, 6, c.fr.modulus.bit_length(), lanes)
    assert TK.accum_segments(K, n_windows * C) == 4
    want = msm_ref(scalars, pts, c.fq.modulus)
    got = TM1.msm_tpu(CURVE, _i32(c.fr.from_ints(scalars)),
                      _i32(c.fq.from_ints([p[0] for p in pts])),
                      _i32(c.fq.from_ints([p[1] for p in pts])), c=6, lanes=lanes)
    assert got == (want if want is not INF else (0, 0))
