"""The port's CUDA route `_ntt_cuda` (ops/ntt.py) on CPU tensors, where its
DIF passes compute their plain version `dif_rows_ref`, against the JAX
package's `_ntt_pallas` with the Pallas kernels in interpret mode: the
four-step glue (transposes, bit-reversal gathers, inter-pass twiddles,
n^-1 and coset shifts) at the shapes of B1 (2^16) and B2 (2^18).

Tolerance: exact equality (integers mod p).
"""

import functools

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from icicle_tpu.fields.field import get_field as jax_field
from icicle_tpu.ops import ntt as JN
from icicle_tpu.runtime import config as jcfg
from icicle_tpu_torch import interop
from icicle_tpu_torch.fields.field import get_field as torch_field
from icicle_tpu_torch.ops import ntt as TN
from icicle_tpu_torch.runtime.config import NTTConfig, NTTDir
from tests.test_torch_ntt import CPU, _port, _vec


@pytest.fixture
def interpret(monkeypatch):
    """Run every pallas_call in interpret mode (no TPU needed)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("direction,coset", [("forward", None), ("inverse", None),
                                             ("forward", 7), ("inverse", 7)])
def test_cuda_route_matches_pallas_2_16(interpret, direction, coset):
    """2^16: both four-step passes have B1's shape (256 x 256)."""
    _check_cuda_route(16, direction, coset)


@pytest.mark.parametrize("direction,coset", [("forward", None), ("inverse", None),
                                             ("forward", 7)])
def test_cuda_route_matches_pallas_2_18(interpret, direction, coset):
    """2^18: both passes have B2's shape (512 x 512), pass B with pre_mul."""
    _check_cuda_route(18, direction, coset)


def _check_cuda_route(logn, direction, coset):
    name = "babybear"
    x = _vec(torch_field(name).modulus, (1 << logn,), 400 + logn)
    cfg = jcfg.NTTConfig(coset_gen=coset)
    want = np.asarray(JN._ntt_pallas(jax_field(name), x, jcfg.NTTDir(direction), cfg))
    got = _port(name, x, direction, coset_gen=coset, fn=TN._ntt_cuda)
    assert np.array_equal(got, want)


def test_round_trip_2_18():
    tf = torch_field("babybear")
    x = interop.elements_from_numpy(tf, _vec(tf.modulus, (1 << 18,), 18), CPU)
    y = TN._ntt_cuda(tf, x, NTTDir.FORWARD, NTTConfig())
    assert torch.equal(TN._ntt_cuda(tf, y, NTTDir.INVERSE, NTTConfig()), x)
    assert torch.equal(y, TN._ntt_torch(tf, x, NTTDir.FORWARD, NTTConfig()))
