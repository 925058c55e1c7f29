"""The port's `msm_tpu3` over bases that the JAX package's
`msm_tpu3_prepare` prepared, carried across with
`interop.prepared_from_numpy`: the same plan, bit-equal Montgomery limbs to
the port's own preparation, and the python-int oracle's MSM. Tolerance:
exact equality."""

import numpy as np
import pytest
import torch

from icicle_tpu.curves.params import get_curve as jcurve
from icicle_tpu.ops.msm_tpu3 import msm_tpu3_prepare as jax_prepare
from icicle_tpu_torch import interop
from icicle_tpu_torch.ops import msm_tpu3 as TM3
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


def test_prepared_from_numpy_refuses_other_engines():
    plan = {"engine": "r12", "nu": 1}
    with pytest.raises(NotImplementedError, match="B5"):
        interop.prepared_from_numpy("bn254", plan, "cpu")
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        interop.prepared_from_numpy("bn254", {"engine": "u32", "nu": 2}, "cpu")
