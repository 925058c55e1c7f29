"""The port's DIF row kernel module (icicle_tpu_torch/kernels/ntt_kernel.py)
against the JAX package's Pallas kernels B1 (`make_dif_kernel`) and B2
(`make_dif_kernel_mxu`), run in Pallas interpret mode on the CPU, and
against the JAX XLA NTT with bit-reversed output, row by row.

On the CPU `dif_rows` computes its plain version `dif_rows_ref`; the CUDA
kernel itself is held against `dif_rows_ref` on the card by chip_smoke.py.

Tolerance: exact equality (integers mod p).
"""

import functools

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from icicle_tpu.fields.field import get_field as jax_field
from icicle_tpu.ops import ntt as JN
from icicle_tpu.pallas import ntt_kernel as JK
from icicle_tpu.runtime.config import NTTConfig, NTTDir, Ordering
from icicle_tpu_torch import interop
from icicle_tpu_torch.fields.field import get_field as torch_field
from icicle_tpu_torch.kernels import ntt_kernel as TK
from icicle_tpu_torch.ops import ntt as TN

CPU = torch.device("cpu")


@pytest.fixture
def interpret(monkeypatch):
    """Run every pallas_call in interpret mode (no TPU needed)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _rows(p: int, rows: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, p, size=(rows, n), dtype=np.uint32)


def _xla_nr_rows(name: str, x: np.ndarray, forward: bool) -> np.ndarray:
    """Per-row JAX XLA NTT with bit-reversed output: the DIF pass's function."""
    d = NTTDir.FORWARD if forward else NTTDir.INVERSE
    y = np.asarray(JN._ntt_xla(jax_field(name), x, d, NTTConfig(ordering=Ordering.NR)))
    if not forward:  # the XLA inverse scales by n^-1; the DIF pass does not
        f = jax_field(name)
        y = np.asarray(f.mul(y, f.from_ints([x.shape[-1]] * x.shape[-1])))
    return y


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("logN", [4, 8, 13])
@pytest.mark.parametrize("name", ["babybear", "koalabear"])
def test_stage_twiddles_match_jax(name, logN, forward):
    want = JK._stage_twiddles(name, logN, forward)
    got = TK._stage_twiddles(torch_field(name), logN, forward, CPU)
    assert np.array_equal(interop.elements_to_numpy(torch_field(name), got), want)


@pytest.mark.parametrize("forward", [True, False])
def test_dif_rows_ref_matches_pallas_b1(interpret, forward):
    name, logN, rows = "babybear", 6, 8
    tf = torch_field(name)
    x = _rows(tf.modulus, rows, 1 << logN, 11)
    want = np.asarray(JK.make_dif_kernel(name, logN, rows)(
        x, JK._stage_twiddles(name, logN, forward)))
    tw = TK._stage_twiddles(tf, logN, forward, CPU)
    got = TK.dif_rows_ref(tf, interop.elements_from_numpy(tf, x, CPU), tw)
    assert np.array_equal(interop.elements_to_numpy(tf, got), want)
    assert np.array_equal(want, _xla_nr_rows(name, x, forward))
    # the wrapper on a CPU tensor is the plain version, and launches nothing
    launches = TK.dif_rows.launches
    wrapped = TK.dif_rows(tf, interop.elements_from_numpy(tf, x, CPU), tw)
    assert torch.equal(wrapped, got) and TK.dif_rows.launches == launches


@pytest.mark.parametrize("forward", [True, False])
def test_dif_rows_ref_factor_matches_pallas_b2(interpret, forward):
    name, logN, rows = "babybear", 9, 8
    tf = torch_field(name)
    jf = jax_field(name)
    x = _rows(tf.modulus, rows, 1 << logN, 12)
    factor = _rows(tf.modulus, rows, 1 << logN, 13)
    mt = JK._mxu_tail_matrix(name, logN, forward)
    want = np.asarray(JK.make_dif_kernel_mxu(name, logN, rows, True)(
        x, JK._stage_twiddles(name, logN, forward), mt, factor))
    got = TK.dif_rows_ref(tf, interop.elements_from_numpy(tf, x, CPU),
                          TK._stage_twiddles(tf, logN, forward, CPU),
                          interop.elements_from_numpy(tf, factor, CPU))
    assert np.array_equal(interop.elements_to_numpy(tf, got), want)
    pre = np.asarray(jf.mul_mont(x, factor))
    assert np.array_equal(want, _xla_nr_rows(name, pre, forward))


def test_dif_rows_rejects_bad_inputs():
    tf = torch_field("babybear")
    tw = TK._stage_twiddles(tf, 4, True, CPU)
    x = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(Exception, match="int32"):
        TK.dif_rows(tf, x.to(torch.int64), tw)
    with pytest.raises(Exception, match="contiguous"):
        TK.dif_rows(tf, torch.zeros((16, 2), dtype=torch.int32).T, tw)
    with pytest.raises(Exception, match="power of two"):
        TK.dif_rows(tf, torch.zeros((2, 12), dtype=torch.int32), tw[:, :12].contiguous())
    with pytest.raises(Exception, match="power of two"):
        TK.dif_rows(tf, torch.zeros((1, 1 << 15), dtype=torch.int32), tw)
    with pytest.raises(Exception, match="tw must be"):
        TK.dif_rows(tf, torch.zeros((2, 8), dtype=torch.int32), tw)
    with pytest.raises(Exception, match="factor must be"):
        TK.dif_rows(tf, x, tw, factor=torch.zeros((1, 16), dtype=torch.int32))


def test_four_step_glue_matches_torch_ntt():
    """ntt_four_step_cuda (kernel passes on the plain version here) equals
    the kernel-free torch four-step at small sizes, both directions."""
    tf = torch_field("koalabear")
    for logn in (4, 7, 10):
        x = interop.elements_from_numpy(tf, _rows(tf.modulus, 1, 1 << logn, logn)[0], CPU)
        for d in (TN.NTTDir.FORWARD, TN.NTTDir.INVERSE):
            assert torch.equal(TK.ntt_four_step_cuda(tf, x, d),
                               TN._ntt_four_step(tf, x, d, logn))
