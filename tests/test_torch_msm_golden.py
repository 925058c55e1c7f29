"""The port's MSM against the golden bn254 MSM vector of the reference C++
backend (tests/golden, replayed through tests/ref_ffi.bn254_msm on the
inputs of tests/test_reference_bn254.py), and, in one slow-marked test,
against JAX `msm_tpu3(backend="xla")` itself, which takes about a minute on
the CPU. Tolerance: exact equality."""

import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu.ops.msm_tpu3 import msm_tpu3 as jax_msm_tpu3
from icicle_tpu_torch import MSMConfig, msm_affine
from icicle_tpu_torch.ops import msm_tpu3 as TM3
from tests import ref_ffi
from tests.ec_ref import ec_mul

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _setup(n, seed):
    c = jcurve("bn254")
    rng = np.random.default_rng(seed)
    pts = [ec_mul((c.gen_x, c.gen_y), int(k), c.fq.modulus)
           for k in rng.integers(1, 1 << 28, size=n)]
    scalars = [int.from_bytes(rng.bytes(40), "little") % c.fr.modulus for _ in range(n)]
    return pts, scalars


def test_msm_affine_matches_reference_golden_vector():
    curve = jcurve("bn254")
    fq, fr = curve.fq, curve.fr
    mod = fq.modulus
    rng = np.random.default_rng(31)
    n = 32
    gen = (curve.gen_x, curve.gen_y)
    pts = [ec_mul(gen, int(k), mod) for k in rng.integers(1, 1 << 30, size=n)]
    scalars = [int.from_bytes(rng.bytes(40), "little") % fr.modulus for _ in range(n)]
    scal_u32 = np.asarray(fr.from_ints(scalars), dtype=np.uint32)
    pts_u32 = np.zeros((n, 16), dtype=np.uint32)
    pts_u32[:, :8] = np.asarray(fq.from_ints([p[0] for p in pts]))
    pts_u32[:, 8:] = np.asarray(fq.from_ints([p[1] for p in pts]))
    ref_proj = ref_ffi.bn254_msm(scal_u32, pts_u32)       # replays tests/golden
    x, y, z = (int.from_bytes(ref_proj[i].astype("<u4").tobytes(), "little") for i in range(3))
    zi = pow(z, -1, mod)
    want = (x * zi % mod, y * zi % mod)

    got = msm_affine("bn254", _i32(scal_u32), _i32(pts_u32[:, :8]), _i32(pts_u32[:, 8:]),
                     MSMConfig(c=11))
    assert got == want


@pytest.mark.slow
def test_msm_tpu3_matches_jax_xla_pipeline():
    c = jcurve("bn254")
    pts, scalars = _setup(64, 65)
    s = np.asarray(c.fr.from_ints(scalars))
    px = np.asarray(c.fq.from_ints([p[0] for p in pts]))
    py = np.asarray(c.fq.from_ints([p[1] for p in pts]))
    want = jax_msm_tpu3("bn254", s, px, py, c=6, T=16, backend="xla", engine="u32")
    got = TM3.msm_tpu3("bn254", _i32(s), _i32(px), _i32(py), c=6, T=16)
    assert got == want
