"""The v2, v1 and r12 MSM routes over the 12- and 24-limb curves (and r12
over grumpkin and bls12_377), on the CPU through their kernels' plain
versions (B6 `suffix_fold_ref`, B7 `bucket_accum_ref`, B5
`prefix_scan_r12_ref`), against the python-int oracle tests/ec_ref.py at a
few dozen points; and the radix-12 engine's word count per curve, where the
port leaves the JAX package's (grumpkin, bls12_381: at the JAX word count
the r12 state's values leave [-2p, 4p) and the MSM is wrong).

The CUDA instances of B5, B6 and B7 are held bit for bit against these
plain versions on the card by chip_smoke.py. Tolerance: exact equality of
the affine result."""

import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu.math import radix12 as JX
from icicle_tpu.pallas.msm_kernel import _b3_small
from icicle_tpu_torch.kernels import msm_scan_r12 as TS12
from icicle_tpu_torch.math import radix12 as TX
from icicle_tpu_torch.ops import msm as TMSM
from icicle_tpu_torch.ops import msm_tpu as TM1
from icicle_tpu_torch.ops import msm_tpu2 as TM2
from icicle_tpu_torch.ops import msm_tpu3 as TM3
from tests.ec_ref import INF, ec_mul, msm_ref

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _case(curve_name, n, seed):
    """n points k G (one repeated: a doubling in a bucket), canonical
    scalars (two zero), the tensors and the oracle."""
    c = jcurve(curve_name)
    rng = np.random.default_rng(seed)
    pts = [ec_mul((c.gen_x, c.gen_y), int(k), c.fq.modulus)
           for k in rng.integers(1, 1 << 28, size=n)]
    pts[1] = pts[0]
    scalars = [int.from_bytes(rng.bytes(100), "little") % c.fr.modulus for _ in range(n)]
    scalars[2] = scalars[3] = 0
    want = msm_ref(scalars, pts, c.fq.modulus)
    args = (_i32(c.fr.from_ints(scalars)), _i32(c.fq.from_ints([p[0] for p in pts])),
            _i32(c.fq.from_ints([p[1] for p in pts])))
    return args, (0, 0) if want is INF else want


# (curve, n, c) of each route; bw6_761's at a small c (its plain versions
# at 24 limbs and nw 64 take seconds a window), v1 over 4 lanes
V2_CASES = [("bls12_381", 24, 5), ("bw6_761", 16, 5)]
V1_CASES = [("bls12_381", 24, 6), ("bw6_761", 16, 3)]
R12_CASES = [("grumpkin", 32, 6), ("bls12_381", 24, 6), ("bw6_761", 16, 5)]


@pytest.mark.parametrize("curve_name,n,c", V2_CASES)
def test_v2_every_curve(curve_name, n, c):
    args, want = _case(curve_name, n, 60 + n)
    assert TM2.msm_tpu2(curve_name, *args, c=c, T=16) == want


@pytest.mark.parametrize("curve_name,n,c", V1_CASES)
def test_v1_every_curve(curve_name, n, c):
    args, want = _case(curve_name, n, 70 + n)
    assert TM1.msm_tpu(curve_name, *args, c=c, lanes=4) == want


@pytest.mark.parametrize("curve_name,n,c", R12_CASES)
def test_r12_every_curve(curve_name, n, c):
    """Grumpkin and bls12_381 failed here at the JAX package's word count
    (ROADMAP.md section C)."""
    args, want = _case(curve_name, n, 80 + n)
    assert TM3.msm_tpu3(curve_name, *args, c=c, T=16, engine="r12") == want


@pytest.mark.parametrize("curve_name,nw,jax_nw", [
    ("bn254", 22, 22), ("grumpkin", 23, 22), ("bls12_377", 32, 32), ("bls12_381", 33, 32),
    ("bw6_761", 64, 64)])
def test_r12_word_count(curve_name, nw, jax_nw):
    """The port's word count is the JAX package's where the value audit
    passes there, one more on grumpkin (b3 = -51 against R' / p ~ 2^10.4)
    and bls12_381 (R' / p ~ 2^3.3)."""
    p = jcurve(curve_name).fq.modulus
    b3 = _b3_small(jcurve(curve_name))
    assert JX.Radix12(p).nw == TX.Radix12(p).nw == jax_nw
    assert TS12.value_audit(TX.Radix12(p), b3) == (nw == jax_nw)
    eng = TS12.r12_engine(curve_name)
    assert eng.nw == nw and TS12.value_audit(eng, b3)
    assert eng.R > 4 * p


@pytest.mark.parametrize("curve_name", ["grumpkin", "bls12_381"])
def test_the_jax_word_count_gives_a_wrong_msm(curve_name, monkeypatch):
    """The fault the word count repairs: at the JAX package's word count the
    r12 MSM over grumpkin and bls12_381 differs from the oracle (the state's
    values leave [-2p, 4p), which canon_nonneg and the unshift need)."""
    least = TX.Radix12(jcurve(curve_name).fq.modulus)
    for module in (TS12, TM3, TMSM):
        monkeypatch.setattr(module, "r12_engine", lambda name: least)
    args, want = _case(curve_name, 32, 90)
    assert TM3.msm_tpu3(curve_name, *args, c=6, T=16, engine="r12") != want
