"""The GLV endomorphism and the MSM's GLV split on the CPU
(icicle_tpu_torch/curves/glv.py, ops/msm_glv.py) against the JAX package's
(icicle_tpu/curves/glv.py, ops/msm_glv.py): the constants, the host
decomposition, the device split and its digits, on the same numpy-seeded
scalars; then `msm_tpu3(glv=True)` against the python-int oracle. A
slow-marked test holds it against JAX `msm_tpu3(backend="xla", glv=True)`.
Tolerance: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_tpu.curves import glv as JG
from icicle_tpu.curves.group import get_group as jgroup
from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu.ops import msm_glv as JMG
from icicle_tpu_torch.curves import glv as TG
from icicle_tpu_torch.curves.group import get_group
from icicle_tpu_torch.ops import msm_glv as TMG
from icicle_tpu_torch.ops import msm_tpu3 as TM3
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException
from tests.ec_ref import INF, ec_mul, msm_ref

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)

SPLIT_CURVES = ["bn254", "bls12_377", "bls12_381", "grumpkin"]


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _scalars(curve_name, n, seed):
    """Random scalars below r, with 0, 1, r - 1 and lambda among them."""
    r = jcurve(curve_name).fr.modulus
    rng = np.random.default_rng(seed)
    edge = [0, 1, r - 1, JG.glv_constants(curve_name)[1]]
    return edge + [int.from_bytes(rng.bytes(64), "little") % r for _ in range(n - len(edge))]


@pytest.mark.parametrize("curve_name", SPLIT_CURVES + ["bw6_761"])
def test_glv_constants_and_decomposition_match_jax(curve_name):
    assert TG.glv_constants(curve_name) == JG.glv_constants(curve_name)
    assert TG._lattice_basis(curve_name) == JG._lattice_basis(curve_name)
    for k in _scalars(curve_name, 8, 1):
        assert TG.glv_decompose(curve_name, k) == JG.glv_decompose(curve_name, k)


@pytest.mark.parametrize("curve_name", SPLIT_CURVES)
def test_glv_msm_constants_match_jax(curve_name):
    assert TMG.glv_msm_constants(curve_name) == JMG.glv_msm_constants(curve_name)
    assert TMG.glv_split_bound(curve_name) == JMG.glv_split_bound(curve_name)
    want = np.asarray(jgroup(curve_name).glv_beta_mont).astype(np.uint32)
    got = get_group(curve_name).glv_beta_mont("cpu").numpy().view(np.uint32)
    assert np.array_equal(got, want)


def test_bw6_761_split_does_not_fit_in_either_package():
    with pytest.raises(AssertionError):
        JMG.glv_msm_constants("bw6_761")
    with pytest.raises(IcicleException, match="160-bit") as e:
        TMG.glv_msm_constants("bw6_761")
    assert e.value.code == IcicleError.API_NOT_IMPLEMENTED


@pytest.mark.parametrize("curve_name", ["bn254", "bls12_381"])
def test_glv_split_and_digits_match_jax(curve_name):
    c = jcurve(curve_name)
    scalars = _scalars(curve_name, 24, 2)
    s_t = np.ascontiguousarray(np.asarray(c.fr.from_ints(scalars)).T)     # (Ls, n)
    want = [np.asarray(a) for a in JMG.glv_split_t(curve_name, jnp.asarray(s_t))]
    got = TMG.glv_split_t(curve_name, _i32(s_t))
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy().view(np.uint32) if w.dtype == np.uint32 else g.numpy(), w)
    # k == sg1 mag1 + lam sg2 mag2 (mod r)
    lam, r = JG.glv_constants(curve_name)[1], c.fr.modulus
    mags = [[int.from_bytes(col.astype("<u4").tobytes(), "little") for col in m.numpy().T.view(
        np.uint32)] for m in (got[0], got[2])]
    for i, k in enumerate(scalars):
        assert (int(got[1][i]) * mags[0][i] + lam * int(got[3][i]) * mags[1][i] - k) % r == 0
    for cw in (5, 6):
        want_d = np.asarray(JMG.glv_digits_t(curve_name, jnp.asarray(s_t), cw))
        assert np.array_equal(TMG.glv_digits_t(curve_name, _i32(s_t), cw).numpy(), want_d)


@pytest.mark.parametrize("curve_name,n", [("bn254", 20), ("bls12_377", 12)])
def test_msm_tpu3_glv_equals_oracle(curve_name, n):
    c = jcurve(curve_name)
    rng = np.random.default_rng(3 + n)
    pts = [ec_mul((c.gen_x, c.gen_y), int(k), c.fq.modulus)
           for k in rng.integers(1, 1 << 28, size=n)]
    scalars = _scalars(curve_name, n, 4)
    s = _i32(c.fr.from_ints(scalars))
    x, y = (_i32(c.fq.from_ints([p[i] for p in pts])) for i in (0, 1))
    want = msm_ref(scalars, pts, c.fq.modulus)
    prepared = TM3.msm_tpu3_prepare(curve_name, x, y, c=6, T=16, glv=True)
    assert prepared["glv"] and prepared["nbits"] == TMG.glv_split_bound(curve_name)
    assert prepared["n"] == n and prepared["pts"].shape[0] == 2 * prepared["n_pad"]
    assert TM3.msm_tpu3(curve_name, s, prepared=prepared, glv=True) == \
        (want if want is not INF else (0, 0))
    with pytest.raises(IcicleException, match="not combined"):
        TM3.msm_tpu3_prepare(curve_name, x, y, c=6, glv=True, precompute_factor=2)
    with pytest.raises(IcicleException, match="prepared with"):
        TM3.msm_tpu3(curve_name, s, prepared=prepared)


@pytest.mark.slow
def test_msm_tpu3_glv_matches_jax_xla_pipeline():
    from icicle_tpu.ops.msm_tpu3 import msm_tpu3 as jax_msm_tpu3
    c = jcurve("bn254")
    n = 16
    rng = np.random.default_rng(80)
    pts = [ec_mul((c.gen_x, c.gen_y), int(k), c.fq.modulus)
           for k in rng.integers(1, 1 << 28, size=n)]
    s = np.asarray(c.fr.from_ints(_scalars("bn254", n, 81)))
    px, py = (np.asarray(c.fq.from_ints([p[i] for p in pts])) for i in (0, 1))
    want = jax_msm_tpu3("bn254", s, px, py, c=6, T=32, backend="xla", engine="u32", glv=True)
    assert TM3.msm_tpu3("bn254", _i32(s), _i32(px), _i32(py), c=6, T=32, glv=True) == want
