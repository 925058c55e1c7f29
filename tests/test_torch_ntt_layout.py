"""The layouts of the port's DIF row kernel (icicle_tpu_torch/kernels/
ntt_kernel.py): `transpose_in` (rows read as columns) and `transpose_out`
(the natural-order result written as columns), against the JAX package's
Pallas kernels B1 (`make_dif_kernel`) and B2 (`make_dif_kernel_mxu`) in
interpret mode, transposed and bit-reversed in numpy; the two-launch
four-step `ntt_four_step_cuda` against the kernel-free torch four-step and
against JAX `_ntt_pallas` at 2^17 (the non-square 256 x 512 split); the
launch plan `dif_plan`; the inverse's n^-1 folded into the twiddle matrix;
and the wrapper's refusals.

On the CPU `dif_rows` computes its plain version `dif_rows_ref`; the CUDA
kernel itself is held against `dif_rows_ref` in every layout on the card by
chip_smoke.py.

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
from icicle_tpu.runtime import config as jcfg
from icicle_tpu_torch import interop
from icicle_tpu_torch.fields.field import get_field as torch_field
from icicle_tpu_torch.kernels import ntt_kernel as TK
from icicle_tpu_torch.ops import ntt as TN
from icicle_tpu_torch.ops.vec_ops import bit_reverse_indices
from icicle_tpu_torch.runtime.config import NTTDir

torch.set_num_threads(1)

CPU = torch.device("cpu")
LAYOUTS = [(False, False), (False, True), (True, False), (True, True)]


@pytest.fixture
def interpret(monkeypatch):
    """Run every pallas_call in interpret mode (no TPU needed)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _rows(p: int, rows: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, p, size=(rows, n), dtype=np.uint32)


def _t(tf, a: np.ndarray) -> torch.Tensor:
    return interop.elements_from_numpy(tf, np.ascontiguousarray(a), CPU)


def _port_layout(tf, x, tw, factor, tin, tout) -> np.ndarray:
    """dif_rows_ref on the layout's input (x given as (rows, N)); returns the
    layout's output in numpy."""
    xin = x.T if tin else x
    fin = None if factor is None else _t(tf, factor.T if tin else factor)
    got = TK.dif_rows_ref(tf, _t(tf, xin), tw, fin, transpose_in=tin, transpose_out=tout)
    return interop.elements_to_numpy(tf, got)


def _expected(jax_out: np.ndarray, tout: bool) -> np.ndarray:
    """The Pallas kernel's (rows, N) bit-reversed rows in the output layout:
    out[bitrev(j), r] = jax_out[r, j], i.e. jax_out.T[rev]."""
    if not tout:
        return jax_out
    return jax_out.T[bit_reverse_indices(jax_out.shape[1])]


@pytest.mark.parametrize("tin,tout", LAYOUTS)
@pytest.mark.parametrize("forward", [True, False])
def test_layouts_match_pallas_b1(interpret, forward, tin, tout):
    name, logN, rows = "babybear", 6, 8
    tf = torch_field(name)
    x = _rows(tf.modulus, rows, 1 << logN, 31)
    want = np.asarray(JK.make_dif_kernel(name, logN, rows)(
        x, JK._stage_twiddles(name, logN, forward)))
    tw = TK._stage_twiddles(tf, logN, forward, CPU)
    got = _port_layout(tf, x, tw, None, tin, tout)
    assert np.array_equal(got, _expected(want, tout))


@pytest.mark.parametrize("tin,tout", LAYOUTS)
@pytest.mark.parametrize("forward", [True, False])
def test_layouts_with_factor_match_pallas_b2(interpret, forward, tin, tout):
    name, logN, rows = "babybear", 9, 8
    tf = torch_field(name)
    x = _rows(tf.modulus, rows, 1 << logN, 32)
    factor = _rows(tf.modulus, rows, 1 << logN, 33)
    mt = JK._mxu_tail_matrix(name, logN, forward)
    want = np.asarray(JK.make_dif_kernel_mxu(name, logN, rows, True)(
        x, JK._stage_twiddles(name, logN, forward), mt, factor))
    tw = TK._stage_twiddles(tf, logN, forward, CPU)
    got = _port_layout(tf, x, tw, factor, tin, tout)
    assert np.array_equal(got, _expected(want, tout))


@pytest.mark.parametrize("tin,tout", LAYOUTS)
@pytest.mark.parametrize("rows,logN", [(1, 1), (3, 4), (8, 5), (5, 8), (2, 11)])
def test_dif_rows_on_cpu_is_the_plain_version(rows, logN, tin, tout):
    """The wrapper on CPU tensors is dif_rows_ref in every layout, at rows !=
    N and odd row counts, and counts no launch."""
    tf = torch_field("koalabear")
    n = 1 << logN
    shape = (n, rows) if tin else (rows, n)
    x = _t(tf, _rows(tf.modulus, *shape, 40 + logN))
    factor = _t(tf, _rows(tf.modulus, *shape, 41 + logN))
    tw = TK._stage_twiddles(tf, logN, True, CPU)
    launches = TK.dif_rows.launches
    for fac in (None, factor):
        got = TK.dif_rows(tf, x, tw, fac, transpose_in=tin, transpose_out=tout)
        want = TK.dif_rows_ref(tf, x, tw, fac, transpose_in=tin, transpose_out=tout)
        assert got.shape == ((n, rows) if tout else (rows, n))
        assert got.is_contiguous() and torch.equal(got, want)
    assert TK.dif_rows.launches == launches


@pytest.mark.parametrize("direction", [NTTDir.FORWARD, NTTDir.INVERSE])
@pytest.mark.parametrize("logn", [4, 7, 10, 11])
def test_four_step_two_passes_match_torch_four_step(logn, direction):
    """ntt_four_step_cuda (pass A columns in, both passes transposed out, the
    inverse's n^-1 in pass B's factor) equals the kernel-free torch
    four-step, at even and odd log n."""
    tf = torch_field("babybear")
    x = _t(tf, _rows(tf.modulus, 1, 1 << logn, 50 + logn)[0])
    launches = TK.dif_rows.launches
    got = TK.ntt_four_step_cuda(tf, x, direction)
    assert got.shape == x.shape and torch.equal(got, TN._ntt_four_step(tf, x, direction, logn))
    assert TK.dif_rows.launches == launches


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_cuda_route_matches_pallas_2_17(interpret, direction):
    """2^17: the non-square four-step, n1 = 256 (pass A, B1's shape) and
    n2 = 512 (pass B)."""
    name = "babybear"
    tf = torch_field(name)
    x = _rows(tf.modulus, 1, 1 << 17, 417)[0]
    want = np.asarray(JN._ntt_pallas(jax_field(name), x, jcfg.NTTDir(direction),
                                     jcfg.NTTConfig()))
    got = TN._ntt_cuda(tf, _t(tf, x), NTTDir(direction), TN.NTTConfig())
    assert np.array_equal(interop.elements_to_numpy(tf, got), want)


def test_inverse_twiddles_carry_n_inv():
    """The inverse four-step's factor is T * n^-1 (Montgomery), cached beside
    T; the unscaled matrix is kept only if it was cached already."""
    tf = torch_field("koalabear")
    n1, n2 = 8, 16
    TN.ntt_release_domain(tf)
    scaled = TN.twiddle_matrix(tf, n1, n2, NTTDir.INVERSE, CPU, scale_n_inv=True)
    assert not any(k[0] == tf.name and k[-1] is False for k in TN._tw_matrices)
    plain = TN.twiddle_matrix(tf, n1, n2, NTTDir.INVERSE, CPU)
    dom = TN.get_domain(tf, 7, CPU)
    assert torch.equal(scaled, tf.mul_mont(plain, dom.n_inv_mont))
    assert TN.twiddle_matrix(tf, n1, n2, NTTDir.INVERSE, CPU, scale_n_inv=True) is scaled
    TN.ntt_release_domain(tf)


# the main path's passes: (rows, log N) -> (TR, threads, cluster) in the
# layouts rows, rows>cols (transpose_out), cols>rows (transpose_in), cols
PINNED = {
    (8192, 13): [(1, 512, 1), (4, 512, 2), (4, 512, 1), (4, 512, 2)],
    (4096, 12): [(2, 512, 1), (8, 512, 1), (8, 512, 1), (8, 512, 1)],
    (256, 8): [(4, 64, 1), (4, 64, 2), (4, 64, 1), (4, 64, 2)],
    (8192, 14): [(1, 512, 1), (2, 512, 4), (2, 512, 1), (2, 512, 4)],
    (4096, 13): [(1, 512, 1), (4, 512, 2), (4, 512, 1), (4, 512, 2)],
    (8192, 12): [(2, 512, 1), (8, 512, 1), (8, 512, 1), (8, 512, 1)],
}


@pytest.mark.parametrize("shape", sorted(PINNED))
def test_dif_plan_pinned_at_the_main_path(shape):
    got = [TK.dif_plan(*shape, tin, tout) for tin, tout in LAYOUTS]
    assert got == PINNED[shape]


@pytest.mark.parametrize("rows", [1, 2, 3, 8, 12, 256, 4096, 8192, 1 << 14])
def test_dif_plan_fits_shared_memory(rows):
    """Every log N from 1 to 14, every layout: TR divides rows, the block's
    shared memory stays within 232,448 bytes, a cluster's tile divides rows
    and splits the N positions, and the block size is a multiple of the
    cluster tile's rows (the transposed store keeps one row a thread)."""
    for log_n in range(1, TK.MAX_LOG_N + 1):
        for tin, tout in LAYOUTS:
            tr, threads, cluster = TK.dif_plan(rows, log_n, tin, tout)
            assert rows % (tr * cluster) == 0 and cluster <= 1 << log_n
            assert TK.dif_smem_bytes(log_n, tr) <= 232_448
            assert 32 <= threads <= TK.MAX_THREADS and threads % 32 == 0
            assert threads % (tr * cluster) == 0
            assert cluster == 1 or (tout and tr * cluster <= TK.STORE_ROWS)


def test_bad_layouts_and_shapes_are_refused():
    tf = torch_field("babybear")
    tw = TK._stage_twiddles(tf, 4, True, CPU)
    x = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(Exception, match="transpose_in must be a bool"):
        TK.dif_rows(tf, x, tw, transpose_in=1)
    with pytest.raises(Exception, match="transpose_out must be a bool"):
        TK.dif_rows(tf, x, tw, transpose_out="yes")
    # with transpose_in, x is (N, rows): (2, 16) has N = 2, so tw must be (1, 2)
    with pytest.raises(Exception, match="tw must be"):
        TK.dif_rows(tf, x, tw, transpose_in=True)
    with pytest.raises(Exception, match="power of two"):
        TK.dif_rows(tf, torch.zeros((12, 2), dtype=torch.int32), tw, transpose_in=True)
    with pytest.raises(Exception, match="factor must be"):
        TK.dif_rows(tf, x.T.contiguous(), tw, factor=x, transpose_in=True)
    with pytest.raises(Exception, match="TR 3"):
        TK.dif_rows(tf, x, tw, _tr=3)
    with pytest.raises(Exception, match="TR 4"):
        TK.dif_rows(tf, x, tw, _tr=4)
    with pytest.raises(Exception, match="contiguous"):
        TK.dif_rows(tf, torch.zeros((2, 16), dtype=torch.int32).T, tw, transpose_in=True)
