"""The port's Fp2 fields, G2's coordinate fields (bn254, bls12_377 whose
u^2 = -5, bls12_381), against the JAX package's: mul, add, inv and the
Montgomery round trip with limbs >= 2^31, element for element (tolerance
0), from numpy seeds; and the interop of extension elements and G2 points."""

import numpy as np
import pytest
import torch

from icicle_tpu.fields import extension as JE
from icicle_tpu_torch import interop
from icicle_tpu_torch.fields import extension as TE
from icicle_tpu_torch.runtime import device
from icicle_tpu_torch.runtime.errors import IcicleException
from tests.test_torch_extension import check_field


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))


@pytest.mark.parametrize("base", ["bn254_base", "bls12_377_base", "bls12_381_base"])
def test_fp2_matches_jax(base):
    jf, tf = JE.get_ext_field(base), TE.get_ext_field(base)
    assert (tf.name, tf.degree, tf.nlimbs) == (jf.name, jf.degree, jf.nlimbs)
    x = tf.rand(np.random.default_rng(1), (5,), "cpu")
    assert bool((x < 0).any())                  # limbs >= 2^31 among them
    check_field(jf, tf)


def test_ext_and_g2_interop_round_trip():
    f = TE.get_tower_field("bls12_381", 12)
    a = f.rand(np.random.default_rng(2), (3,), "cpu")
    u = interop.elements_to_numpy(f, a)
    assert u.dtype == np.uint32 and torch.equal(interop.ext_elements_from_numpy(f, u, "cpu"), a)
    bad = u.copy()
    bad[0, 12:24] = 0xFFFFFFFF                   # the second Fq component >= q
    with pytest.raises(IcicleException, match="not canonical"):
        interop.ext_elements_from_numpy(f, bad, "cpu")
    fp2 = TE.get_ext_field("bn254_base")
    x, y = fp2.rand(np.random.default_rng(3), (4,), "cpu"), fp2.rand(np.random.default_rng(4), (4,), "cpu")
    q = interop.g2_affine_to_numpy("bn254", x, y)
    assert q.shape == (4, 32)                    # x.c0, x.c1, y.c0, y.c1 of 8 limbs
    assert np.array_equal(q[:, 8:16], x[:, 8:].numpy().view(np.uint32))
    gx, gy = interop.g2_affine_from_numpy("bn254", q, "cpu")
    assert torch.equal(gx, x) and torch.equal(gy, y)
    with pytest.raises(IcicleException, match="expected"):
        interop.g2_affine_from_numpy("bn254", q[:, :24], "cpu")
