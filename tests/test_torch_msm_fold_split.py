"""The split of B6's serial axis (icicle_tpu_torch/kernels/msm_fold2.py
`fold_segments`) in its plain version, on the CPU: the scan that stores E
at the run ends, the carries, the fixup of the rows and B4 over them,
against the JAX package's XLA twin `make_suffix_fold_xla`, on random flags
and on v2's stream; the run-end rows (`run_starts`, `runs`); the plan; and
the v2 MSM over the split against the python-int oracle.

The CUDA kernel repeats the plain version's association and is held bit
for bit against it on the card by chip_smoke.py; here only the plain
version runs.

Tolerance: equality of affine points against the twin (the split gives
other projective coordinates of the same point); limb for limb at
segments=1 with a serial B4 (reduce_segments=1), the twin's own order.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu.pallas.msm_fold2 import make_suffix_fold_xla
from icicle_tpu_torch.kernels import build
from icicle_tpu_torch.kernels import msm_fold2 as TF
from icicle_tpu_torch.ops import msm_tpu2 as TM2
from icicle_tpu_torch.runtime.errors import IcicleException
from tests.ec_ref import INF, msm_ref
from tests.test_torch_msm_kernels import _affine_ints, _pool, _scan_input

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)

CURVE = "bn254"
NL = 8
MOD = jcurve(CURVE).fq.modulus
K, C, M = 24, 6, 4          # v2's stream: T = K - M = 20 digits and M dummy slots a lane


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _random_flags(seed: int) -> np.ndarray:
    """Dummy slots and run ends anywhere; lane 0 ends no run, lane 1 one at
    every slot."""
    rng = np.random.default_rng(seed)
    real = rng.random((K, C)) < 0.8
    dacc = rng.random((K, C)) < 0.3
    dacc[:, 0], dacc[:, 1] = False, True
    return (real * TF.IS_REAL + dacc * TF.IS_DACC).astype(np.int32)


def _v2_flags(seed: int) -> np.ndarray:
    """v2's stream as ops/msm_tpu2.py builds it: per lane K - M digits |d| in
    [0, M] and a dummy slot for each key 1..M, sorted by key descending with
    each key's dummy last; exactly M run ends a lane."""
    rng = np.random.default_rng(seed)
    out = np.zeros((K, C), dtype=np.int32)
    for lane in range(C):
        keys = list(rng.integers(0, M + 1, size=K - M)) + list(range(1, M + 1))
        dummy = [False] * (K - M) + [True] * M
        order = sorted(range(K), key=lambda i: (M - keys[i], dummy[i]))
        sk = [keys[i] for i in order]
        for k, i in enumerate(order):
            end = sk[k] >= 1 and (k == K - 1 or sk[k + 1] != sk[k])
            out[k, lane] = (not dummy[i]) * TF.IS_REAL + end * TF.IS_DACC
    assert ((out & TF.IS_DACC) != 0).sum(0).tolist() == [M] * C
    return out


FLAGS = {"random": _random_flags(1), "v2": _v2_flags(2)}


@functools.lru_cache(maxsize=None)
def _points() -> np.ndarray:
    x = _scan_input(K, C, seed=81)                   # (K, 2L, C) Montgomery curve points
    assert (x >= 1 << 31).any()
    return x


@functools.lru_cache(maxsize=None)
def _xla(stream: str):
    """The twin's D per lane (its serial fold), as uint32 limbs (3L, C); its
    input is the coordinate bytes, then the flag word, then padding."""
    limbs = _points().transpose(0, 2, 1)             # (K, C, 2L); y already signed
    planes = np.stack([(limbs >> (8 * b)) & 0xFF for b in range(4)], -1).reshape(K, C, 8 * NL)
    rows = np.concatenate([planes, FLAGS[stream][..., None], np.zeros((K, C, 7))], -1)
    pbytes = jnp.asarray(rows.transpose(0, 2, 1)[None].astype(np.float32)).astype(jnp.bfloat16)
    return np.concatenate([np.asarray(d) for d in make_suffix_fold_xla(CURVE, K, C)(pbytes)])


def _fold(stream: str, **kw) -> torch.Tensor:
    return TF.suffix_fold_ref(CURVE, _i32(_points()), torch.from_numpy(FLAGS[stream]), **kw)


@pytest.mark.parametrize("stream", ["random", "v2"])
def test_serial_fold_is_bit_exact_with_xla_twin(stream):
    got = _fold(stream, segments=1, reduce_segments=1)
    assert got.shape == (3 * NL, C) and got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), _xla(stream))


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("stream", ["random", "v2"])
def test_split_fold_matches_xla_twin_as_affine(stream, S):
    """At K 24, S 8 gives segments of 3 slots and S 3 of 8; the random
    stream's lane 0 has no run end (D the identity), lane 1 one at every
    slot."""
    got = _fold(stream, segments=S)
    want = _affine_ints(_xla(stream))
    assert _affine_ints(got.numpy().view(np.uint32)) == want
    if stream == "random":
        assert want[0] is None and want[1] is not None


def test_split_gives_other_coordinates():
    """So the kernel-versus-plain check must use the same segments."""
    assert not torch.equal(_fold("v2", segments=4), _fold("v2", segments=1))


def test_run_starts():
    flags = torch.tensor([[2, 0, 3], [1, 0, 2], [3, 0, 2], [0, 0, 2], [2, 0, 1]],
                         dtype=torch.int32)                    # (K 5, C 3): 3, 0, 4 run ends
    starts, R = TF.run_starts(flags, 2, None)                   # segments [0, 3), [3, 5)
    assert R == 4
    assert starts.tolist() == [[1, 4, 0], [3, 4, 3]]            # R - total + ends before
    starts, R = TF.run_starts(flags, 1, 6)
    assert (R, starts.tolist()) == (6, [[3, 6, 2]])
    _, R = TF.run_starts(torch.zeros((4, 3), dtype=torch.int32), 2, None)
    assert R == 1                                               # no run end: one row


def test_runs_pads_with_identity_rows_and_drops_beyond():
    v2 = _affine_ints(_xla("v2"))
    exact = _fold("v2", segments=1, reduce_segments=1)
    # runs = M: no padding, the same rows as counting them
    assert torch.equal(_fold("v2", segments=1, reduce_segments=1, runs=M), exact)
    # leading identity rows leave the serial B4 bit-exact, the split one exact as points
    assert torch.equal(_fold("v2", segments=1, reduce_segments=1, runs=M + 3), exact)
    assert _affine_ints(_fold("v2", segments=4, runs=M + 3).numpy().view(np.uint32)) == v2
    # fewer rows than run ends: the first run ends are dropped (a wrong sum, no fault)
    short = _affine_ints(_fold("v2", segments=4, runs=M - 1).numpy().view(np.uint32))
    assert short != v2


def test_cpu_wrapper_computes_the_plan_and_launches_nothing():
    x, fl = _i32(_points()), torch.from_numpy(FLAGS["v2"])
    assert TF.fold_segments(K, C) == 4
    TF.suffix_fold.launches = 0
    assert torch.equal(TF.suffix_fold(CURVE, x, fl), TF.suffix_fold_ref(CURVE, x, fl, 4))
    assert torch.equal(TF.suffix_fold(CURVE, x, fl, runs=M, _segments=3),
                       TF.suffix_fold_ref(CURVE, x, fl, 3, runs=M))
    assert TF.suffix_fold.launches == 0


@pytest.mark.parametrize("K_,C_,S", [
    (2304, 8192, 4),      # v2 2^24: one window, one wave of blocks
    (64, 8192, 4),        # chip_smoke.py's cut depth
    (61, 8192, 4),        # ... ragged
    (2304, 64, 32),       # few lanes: S * S <= K caps it
    (1, 8192, 1),
])
def test_fold_segments_pinned(K_, C_, S):
    assert TF.fold_segments(K_, C_) == S


@pytest.mark.parametrize("kw", [{"_segments": 0}, {"_segments": 2.0}, {"_segments": 1 << 16},
                                {"runs": 0}, {"runs": 2.0}])
def test_suffix_fold_rejects_bad_split(kw):
    with pytest.raises(IcicleException):
        TF.suffix_fold(CURVE, torch.zeros((4, 2 * NL, 3), dtype=torch.int32),
                       torch.zeros((4, 3), dtype=torch.int32), **kw)


def test_split_header_is_an_input_of_both_libraries():
    for name in ("msm_scan", "msm_fold2"):
        assert "msm_split.cuh" in {os.path.basename(f) for f in build._inputs(name)}


def test_msm_tpu2_torch_backend_with_split_equals_oracle(monkeypatch):
    """c = 5 (M 16), T = 48: K = 64 slots over 8 tiles x 27 windows, so the
    fold's plan splits each lane (S 2); the call passes runs = M."""
    c = jcurve(CURVE)
    rng = np.random.default_rng(73)
    pts = _pool(74, 90)                                   # 90 points from seed 74
    pts[5] = pts[4]                                       # a doubling in a bucket
    scalars = [int.from_bytes(rng.bytes(40), "little") % c.fr.modulus for _ in range(90)]
    seen = []
    real = TF.suffix_fold_ref
    monkeypatch.setattr(TM2, "suffix_fold_ref",
                        lambda *a, **k: seen.append((a[1].shape, k)) or real(*a, **k))
    got = TM2.msm_tpu2(CURVE, _i32(c.fr.from_ints(scalars)),
                       *(_i32(c.fq.from_ints([p[i] for p in pts])) for i in (0, 1)),
                       c=5, T=48, backend="torch")
    want = msm_ref(scalars, pts, MOD)
    assert got == (want if want is not INF else (0, 0))
    (Kf, _, Cf), kw = seen[0]
    assert Kf == 64 and kw == {"runs": 16} and TF.fold_segments(Kf, Cf) > 1


def test_msm_tpu2_refuses_unequal_counts():
    """As the JAX package's msm_tpu2 does (its padded copy fails to
    broadcast); the port used to pad the missing points with zeros."""
    c = jcurve(CURVE)
    pts = _pool(75, 5)
    x, y = (_i32(c.fq.from_ints([p[i] for p in pts])) for i in (0, 1))
    s = _i32(c.fr.from_ints(list(range(1, 7))))
    for args in ((s, x, y), (s[:5], x[:5], y[:4])):
        with pytest.raises(IcicleException, match="scalars"):
            TM2.msm_tpu2(CURVE, *args, c=5, T=16, backend="torch")
