"""The port's `msm_tpu3` over bases that the JAX package's
`msm_tpu3_prepare` prepared, carried across with
`interop.prepared_from_numpy`: the same plan, bit-equal Montgomery limbs to
the port's own preparation, and the python-int oracle's MSM. Tolerance:
exact equality."""

import functools

import jax
import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu.ops.msm_tpu3 import msm_tpu3_prepare as jax_prepare
from icicle_tpu_torch import MSMConfig, interop
from icicle_tpu_torch.ops.msm import msm_precompute_bases
from icicle_tpu_torch.ops import msm_tpu3 as TM3
from icicle_tpu_torch.runtime.errors import IcicleException
from tests.ec_ref import INF, ec_mul, msm_ref

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


def test_prepared_from_jax_bases():
    c = jcurve("bn254")
    pts, scalars = _setup(64, 64)
    px = np.asarray(c.fq.from_ints([p[0] for p in pts]))
    py = np.asarray(c.fq.from_ints([p[1] for p in pts]))
    jprep = jax_prepare("bn254", px, py, c=6, T=16, engine="u32")
    prepared = interop.prepared_from_numpy("bn254", jprep, "cpu")
    own = TM3.msm_tpu3_prepare("bn254", _i32(px), _i32(py), c=6, T=16)
    # the same plan and bit-equal Montgomery limbs
    assert {k: v for k, v in own.items() if k != "pts"} == \
        {k: v for k, v in prepared.items() if k != "pts"}
    assert torch.equal(own["pts"], prepared["pts"])
    got = TM3.msm_tpu3("bn254", _i32(c.fr.from_ints(scalars)), prepared=prepared)
    want = msm_ref(scalars, pts, c.fq.modulus)
    assert got == (want if want is not INF else (0, 0))


@functools.lru_cache(maxsize=None)
def _jax_prepared(kind: str):
    """JAX `msm_tpu3_prepare` over 16 bn254 points: "u32" and "r12" over
    the points' precomputed copies at nu = 2 (c = 6), "glv" over [P, phi(P)];
    with the port's own preparation of the same bases and the scalars'
    oracle."""
    c = jcurve("bn254")
    pts, scalars = _setup(16, 90)
    px = np.asarray(c.fq.from_ints([p[0] for p in pts]))
    py = np.asarray(c.fq.from_ints([p[1] for p in pts]))
    glv = kind == "glv"
    nu = 1 if glv else 2
    if nu > 1:
        bx, by = msm_precompute_bases("bn254", _i32(px), _i32(py), MSMConfig(c=6, precompute_factor=nu))
        px, py = bx.numpy().view(np.uint32), by.numpy().view(np.uint32)
    engine = "u32" if glv else kind
    with jax.disable_jit(kind == "r12"):                  # its jitted prepare compiles ~40 s
        jprep = jax_prepare("bn254", px, py, c=6, T=16, engine=engine, precompute_factor=nu,
                            glv=glv)
    own = TM3.msm_tpu3_prepare("bn254", _i32(px), _i32(py), c=6, T=16, engine=engine,
                               precompute_factor=nu, glv=glv)
    want = msm_ref(scalars, pts, c.fq.modulus)
    return jprep, own, _i32(c.fr.from_ints(scalars)), (want if want is not INF else (0, 0))


def test_prepared_from_numpy_refuses_other_engines():
    # "u32" and "r12" bases carry over (tests/test_torch_msm_r12.py for r12);
    # an engine the port does not have does not; precomputed bases (nu > 1)
    # in either engine load
    with pytest.raises(IcicleException, match="unknown engine"):
        interop.prepared_from_numpy("bn254", {"engine": "r13", "nu": 1}, "cpu")
    for kind in ("u32", "r12"):
        prepared = interop.prepared_from_numpy("bn254", _jax_prepared(kind)[0], "cpu")
        assert (prepared["engine"], prepared["nu"], prepared["glv"]) == (kind, 2, False)


@pytest.mark.parametrize("kind", ["u32", "r12", "glv"])
def test_prepared_from_jax_precomputed_and_glv_bases(kind):
    """JAX-prepared bases of precomputed copies (nu 2, both engines) and of
    GLV's [P, phi(P)]: the port's own preparation's plan and limbs, and the
    oracle's MSM over them."""
    jprep, own, s, want = _jax_prepared(kind)
    prepared = interop.prepared_from_numpy("bn254", jprep, "cpu")
    assert {k: v for k, v in own.items() if k != "pts"} == \
        {k: v for k, v in prepared.items() if k != "pts"}
    assert torch.equal(own["pts"], prepared["pts"])
    nu, glv = prepared["nu"], prepared["glv"]
    assert TM3.msm_tpu3("bn254", s, prepared=prepared, precompute_factor=nu, glv=glv) == want
