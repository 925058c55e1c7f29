"""The MSM over every G1 curve, on the CPU: v3 (`msm_tpu3`, whose kernels'
plain versions run here) over bls12_377, bls12_381 and bw6_761 against the
python-int oracle (tests/ec_ref.py), as the JAX package's tests/test_msm.py
(:45, :171) runs its MSM; the plain B3 and B4 at 12 limbs against the JAX
package's XLA twins (make_prefix_scan_xla, make_ec_reduce_xla); and which
limb counts each CUDA kernel is built for: B3-B7 every G1 curve, none of B5-B7
over Fp2.

The 12- and 24-limb CUDA instances are held bit for bit against these plain
versions on the card by chip_smoke.py. Tolerance: exact equality (limbs;
B4 against its twin as affine points, since the twin starts its sum from
row 0 and the kernel from the identity)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu.pallas import ec_reduce as JR
from icicle_tpu.pallas import msm_scan as JS
from icicle_tpu_torch import MSMConfig, msm_affine
from icicle_tpu_torch.curves.group import Affine, get_group
from icicle_tpu_torch.kernels import ec_reduce as TR
from icicle_tpu_torch.kernels import msm_lib
from icicle_tpu_torch.kernels import msm_scan as TS
from icicle_tpu_torch.kernels import msm_scan_r12 as TS12
from icicle_tpu_torch.ops import msm_tpu3 as TM3
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException
from tests.ec_ref import INF, ec_mul, ec_neg, msm_ref

# The tier-1 run puts six pytest workers on the same cores; torch's intra-op
# threads then oversubscribe them and these small-tensor ops run ~10x slower.
torch.set_num_threads(1)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _inputs(curve_name, n, seed):
    c = jcurve(curve_name)
    rng = np.random.default_rng(seed)
    pts = [ec_mul((c.gen_x, c.gen_y), int(k), c.fq.modulus)
           for k in rng.integers(1, 1 << 28, size=n)]
    scalars = [int.from_bytes(rng.bytes(100), "little") % c.fr.modulus for _ in range(n)]
    return (pts, scalars, _i32(c.fr.from_ints(scalars)),
            _i32(c.fq.from_ints([p[0] for p in pts])), _i32(c.fq.from_ints([p[1] for p in pts])))


def _want(curve_name, scalars, pts):
    w = msm_ref(scalars, pts, jcurve(curve_name).fq.modulus)
    return w if w is not INF else (0, 0)


@pytest.mark.parametrize("curve_name,n,c", [("bls12_377", 13, 6), ("bls12_377", 32, 7),
                                            ("bls12_381", 16, 6), ("bw6_761", 8, 4)])
def test_msm_tpu3_every_curve(curve_name, n, c):
    pts, scalars, s, x, y = _inputs(curve_name, n, 45 + n)
    assert TM3.msm_tpu3(curve_name, s, x, y, c=c, T=16) == _want(curve_name, scalars, pts)


def test_msm_affine_bls12_381_and_the_scalar_widths():
    """msm_affine on a 12-limb curve takes v3 with the plan's c; bw6_761's
    scalars have 12 limbs and 377 bits, its points 24 limbs."""
    pts, scalars, s, x, y = _inputs("bls12_381", 12, 3)
    assert msm_affine("bls12_381", s, x, y, MSMConfig(c=5)) == _want("bls12_381", scalars, pts)
    plan = TM3._resolve_plan("bw6_761", 8, 4, 16, None, None, 1)
    assert plan["nbits"] == 377 and plan["n_windows"] == 377 // 4 + 1
    assert jcurve("bw6_761").fr.nlimbs == 12 and jcurve("bw6_761").fq.nlimbs == 24


def _points_12(n, seed):
    c = jcurve("bls12_381")
    rng = np.random.default_rng(seed)
    return c, [ec_mul((c.gen_x, c.gen_y), int(k), c.fq.modulus)
               for k in rng.integers(1, 1 << 30, size=n)]


def test_prefix_scan_ref_12_limbs_matches_xla_twin():
    K, C = 4, 4
    c, pool = _points_12(K * C, 7)
    pool[C + 1] = ec_neg(pool[1], c.fq.modulus)          # lane 1: P then -P
    fq = c.fq
    mont = lambda v: np.asarray(fq.to_mont(fq.from_ints(v)))
    x = mont([p[0] for p in pool]).reshape(K, C, 12)
    y = mont([p[1] for p in pool]).reshape(K, C, 12)
    inp = np.ascontiguousarray(np.concatenate([x, y], -1).transpose(0, 2, 1))
    want = np.asarray(JS.make_prefix_scan_xla("bls12_381", K, C)(jnp.asarray(inp[None])))[0]
    got = TS.prefix_scan(c.name, _i32(inp), _segments=1)  # the wrapper: the plain version here
    assert got.shape == (K, 36, C) and np.array_equal(got.numpy().view(np.uint32), want)


def test_ec_reduce_ref_12_limbs_matches_xla_twin():
    R, C = 4, 4
    c, pool = _points_12(2 * R * C, 8)
    g = get_group("bls12_381")
    fq = c.fq
    mod = fq.modulus
    a, b = pool[:R * C], pool[R * C:]
    P = g.from_affine_canonical(_i32(fq.from_ints([p[0] for p in a])),
                                _i32(fq.from_ints([p[1] for p in a])))
    Q = Affine(_i32(fq.to_mont(fq.from_ints([p[0] for p in b]))),
               _i32(fq.to_mont(fq.from_ints([p[1] for p in b]))))
    S = g.madd(P, Q)                                     # (R C, 12) each, Z != 1
    inp = torch.stack(list(S), 1).reshape(R, C, 36).transpose(1, 2).contiguous()
    want = np.asarray(JR.make_ec_reduce_xla("bls12_381", R, C)(jnp.asarray(
        inp.numpy().view(np.uint32))))
    got = TR.ec_reduce(c.name, inp, _segments=1)         # the wrapper: the plain version here

    def affine(t):                                       # Montgomery X R / Z R = X / Z
        x, y, z = (fq.to_ints(t[i * 12:(i + 1) * 12].T) for i in range(3))
        return [(int(xi) * pow(int(zi), -1, mod) % mod, int(yi) * pow(int(zi), -1, mod) % mod)
                for xi, yi, zi in zip(x, y, z)]

    sums = [msm_ref([1] * (2 * R), [a[r * C + i] for r in range(R)]
                    + [b[r * C + i] for r in range(R)], mod) for i in range(C)]
    assert affine(want) == sums
    assert affine(got.numpy().view(np.uint32)) == sums


@pytest.mark.parametrize("kernel", ["prefix_scan", "ec_reduce", "precompute_bases"])
@pytest.mark.parametrize("curve_name", ["bn254", "grumpkin", "bls12_377", "bls12_381",
                                        "bw6_761"])
def test_b3_b4_and_precompute_have_every_curve(kernel, curve_name):
    """B3, B4 and precompute_bases are built for 8, 12 and 24 limbs: every
    G1 curve passes the pre-launch check (callable on the CPU)."""
    assert msm_lib.built_limbs(kernel) == (8, 12, 24) == tuple(sorted(msm_lib.KERNEL_LIMBS))
    msm_lib.require_instance(kernel, msm_lib.as_curve(curve_name))


@pytest.mark.parametrize("kernel", ["prefix_scan_r12", "suffix_fold", "bucket_accum"])
@pytest.mark.parametrize("curve_name", ["bn254", "grumpkin", "bls12_377", "bls12_381",
                                        "bw6_761"])
def test_b5_b6_b7_have_every_curve(kernel, curve_name):
    """B5, B6 and B7 are built for 8, 12 and 24 limbs too: every G1 curve
    passes the pre-launch check (callable on the CPU), and B5's consts name
    a schedule the curve's library holds."""
    assert msm_lib.built_limbs(kernel) == (8, 12, 24)
    curve = msm_lib.as_curve(curve_name)
    msm_lib.require_instance(kernel, curve)
    if kernel == "prefix_scan_r12":
        consts = TS12.kernel_consts(curve)
        nw = TS12.r12_engine(curve_name).nw
        assert len(consts) == 1 + 3 * nw + 2
        assert consts[0] == TS12.R12_CURVES.index(curve_name)


@pytest.mark.parametrize("kernel", ["prefix_scan_r12", "suffix_fold", "bucket_accum"])
def test_fp_only_kernels_refuse_g2(kernel):
    """B5, B6 and B7 have no instance over Fp2 (v2, v1 and r12 take G1
    only): a G2 group raises API_NOT_IMPLEMENTED before any library is
    loaded."""
    assert msm_lib.built_limbs(kernel, degree=2) == ()
    with pytest.raises(IcicleException, match="over Fp2") as e:
        msm_lib.require_instance(kernel, get_group("bls12_381", g2=True))
    assert e.value.code == IcicleError.API_NOT_IMPLEMENTED
