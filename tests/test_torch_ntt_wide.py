"""The wide-element NTT kernel's wrapper (icicle_tpu_torch/kernels/
ntt_wide.py) on the CPU, where the kernel itself cannot run: its plain
version `dif_rows_wide_ref` in all four layouts, with and without the
factor, against the port's torch NTT; the two-pass four-step
(`ntt_four_step_wide`, on a CPU tensor the plain passes) against
`_ntt_torch`; and the routing rules of `_ntt_cuda` (which shapes and
fields go to which kernel, which to `_ntt_torch`, and which raise),
checked with stubs that record the call. The kernel is held bit for bit
against `dif_rows_wide_ref` on the card by chip_smoke.py.

Inputs come from numpy seeds (with 0 and p - 1 among them); tolerance:
exact equality (integers mod p).
"""

import types

import numpy as np
import pytest
import torch

from icicle_tpu_torch.fields.field import get_field
from icicle_tpu_torch.kernels import ntt_kernel as NK
from icicle_tpu_torch.kernels import ntt_wide as NW
from icicle_tpu_torch.ops import ntt as TN
from icicle_tpu_torch.runtime.config import NTTConfig, NTTDir, Ordering
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

torch.set_num_threads(1)

CPU = torch.device("cpu")
FIELDS = ["goldilocks", "bn254_scalar"]
EIGHT_LIMB = ["bn254_scalar", "bls12_381_scalar", "bls12_377_scalar", "grumpkin_scalar",
              "stark252"]


def _elements(f, shape, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % f.modulus for _ in range(int(np.prod(shape)))]
    vals[:2] = [0, f.modulus - 1]
    return f.from_ints(np.array(vals, dtype=object).reshape(shape), CPU)


@pytest.mark.parametrize("fname", FIELDS)
@pytest.mark.parametrize("tin,tout", [(False, False), (False, True), (True, False), (True, True)])
@pytest.mark.parametrize("with_factor", [False, True])
def test_ref_layouts_against_torch_ntt(fname, tin, tout, with_factor):
    """Rows of (8, 32): the DIF of each row (times the factor) is its
    forward NTT in bit-reversed order (transpose_out: natural order, as
    columns)."""
    f = get_field(fname)
    rows, log_n = 8, 5
    x = _elements(f, (rows, 1 << log_n), seed=1)
    factor = _elements(f, (rows, 1 << log_n), seed=2) if with_factor else None
    tw = NK._stage_twiddles(f, log_n, True, CPU)
    lay = (lambda t: t.transpose(0, 1).contiguous()) if tin else (lambda t: t)
    got = NW.dif_rows_wide(f, lay(x), tw, None if factor is None else lay(factor),
                           transpose_in=tin, transpose_out=tout)
    scaled = x if factor is None else f.mul_mont(x, factor)
    want = TN._ntt_torch(f, scaled, NTTDir.FORWARD,
                         NTTConfig(ordering=Ordering.NN if tout else Ordering.NR))
    assert torch.equal(got, want.transpose(0, 1).contiguous() if tout else want)
    assert torch.equal(got, NW.dif_rows_wide_ref(f, lay(x), tw, None if factor is None
                                                 else lay(factor), transpose_in=tin,
                                                 transpose_out=tout))


def test_four_step_wide_goldilocks_2_16():
    """Both passes as the CUDA route takes them, through `_ntt_cuda` on a CPU
    tensor: forward, inverse (n^-1 in pass B's factor) and a coset."""
    f = get_field("goldilocks")
    x = _elements(f, (1 << 16,), seed=3)
    for direction, coset in ((NTTDir.FORWARD, None), (NTTDir.INVERSE, None),
                             (NTTDir.FORWARD, 7)):
        cfg = NTTConfig(coset_gen=coset)
        want = TN._ntt_torch(f, x, direction, cfg)
        assert torch.equal(TN._ntt_cuda(f, x, direction, cfg), want), (direction, coset)


def test_four_step_wide_bn254_scalar():
    """bn254_scalar at 2^10 (passes of 32 x 32): the plain four-step
    against `_ntt_torch`, forward and inverse."""
    f = get_field("bn254_scalar")
    x = _elements(f, (1 << 10,), seed=4)
    y = NW.ntt_four_step_wide(f, x, NTTDir.FORWARD)
    assert torch.equal(y, TN._ntt_torch(f, x, NTTDir.FORWARD, NTTConfig()))
    assert torch.equal(NW.ntt_four_step_wide(f, y, NTTDir.INVERSE), x)


def test_instances_and_limits():
    assert NW.instance(get_field("goldilocks")) == "gl64"
    for fname in EIGHT_LIMB:
        assert NW.instance(get_field(fname)) == "fp8", fname
    for fname in ("bw6_761_scalar", "bls12_377_base", "babybear", "bn254_base"):
        f = get_field(fname)
        assert NW.instance(f) is (None if f.modulus.bit_length() > 255 or f.nlimbs != 8
                                  else "fp8"), fname
    assert NW.MAX_LOG_N == {"gl64": 14, "fp8": 12}
    assert NW.wide_plan(4096, 12, "gl64") == (4, 256)
    assert NW.wide_plan(2048, 11, "fp8") == (1, 256)
    assert NW.wide_plan(6, 4, "gl64") == (2, 32)
    assert NW.wide_plan(4, 14, "gl64") == (1, 256)   # a tile of 2 rows of 2^14 would not fit
    # the fp8 launch passes poseidon2_kernel's array, whose lead is
    # ec_field.cuh's CurveConsts<8>: p, R mod p, inv32
    bn = get_field("bn254_scalar")
    consts = list(NW.field_consts("bn254_scalar"))
    assert sum(v << (32 * i) for i, v in enumerate(consts[:8])) == bn.modulus
    assert sum(v << (32 * i) for i, v in enumerate(consts[8:16])) == bn.params.r
    assert consts[16] == bn.params.inv32


def _not_implemented(fn, *args, match="queue A item 6"):
    with pytest.raises(IcicleException, match=match) as e:
        fn(*args)
    assert e.value.code == IcicleError.API_NOT_IMPLEMENTED


def test_unserved_fields_raise_on_the_card():
    """12-limb fields (bw6_761_scalar, bls12_377_base) have no instance, and
    an 8-limb NTT past 2^24 no row length: on a CUDA tensor these raise
    before any work (checked with a stand-in that reports is_cuda)."""
    card = types.SimpleNamespace(is_cuda=True)
    for fname in ("bw6_761_scalar", "bls12_377_base"):
        _not_implemented(NW.require_instance, get_field(fname), card)
    _not_implemented(NW.require_instance, get_field("bn254_scalar"), card, 25,
                     match="dif_rows_wide redesign")
    NW.require_instance(get_field("bn254_scalar"), card, 24)
    NW.require_instance(get_field("goldilocks"), card, 28)
    NW.require_instance(get_field("bw6_761_scalar"), torch.zeros(1))  # the CPU: no refusal


def test_bad_calls_raise():
    f = get_field("goldilocks")
    tw = NK._stage_twiddles(f, 5, True, CPU)
    x = _elements(f, (4, 32), seed=5)
    with pytest.raises(IcicleException, match="single-word"):
        NW.dif_rows_wide(get_field("babybear"), x[..., 0].contiguous(), tw[..., 0])
    with pytest.raises(IcicleException, match="tw must be"):
        NW.dif_rows_wide(f, x, tw[:4])
    with pytest.raises(IcicleException, match="contiguous"):
        NW.dif_rows_wide(f, x.transpose(0, 1), tw, transpose_in=True)
    with pytest.raises(IcicleException, match="power of two"):
        NW.dif_rows_wide(f, x[:, :24].contiguous(), tw)
    with pytest.raises(IcicleException, match="factor must be"):
        NW.dif_rows_wide(f, x, tw, x[:2].contiguous())
    launches = NW.dif_rows_wide.launches
    NW.dif_rows_wide(f, x, tw)                          # the CPU: the plain version
    assert NW.dif_rows_wide.launches == launches


@pytest.fixture
def recorded(monkeypatch):
    """Stubs for the two four-step kernels' entries and `_ntt_torch`, each
    recording its call and returning its input."""
    calls = []

    def stub(name):
        def fn(f, x, *args):
            calls.append((name, f.name, tuple(x.shape)))
            return x
        return fn

    monkeypatch.setattr(NW, "ntt_four_step_wide", stub("dif_rows_wide"))
    monkeypatch.setattr(NK, "ntt_four_step_cuda", stub("dif_rows"))
    monkeypatch.setattr(TN, "_ntt_torch", stub("torch"))
    monkeypatch.setattr(NW, "require_instance", lambda f, x, *a: calls.append(("check", f.name)))
    return calls


@pytest.mark.parametrize("fname,shape,ordering,want", [
    ("goldilocks", (1 << 16,), "NN", "dif_rows_wide"),
    ("bn254_scalar", (1 << 16,), "NN", "dif_rows_wide"),
    ("stark252", (1 << 17,), "NN", "dif_rows_wide"),
    ("bw6_761_scalar", (1 << 16,), "NN", "dif_rows_wide"),  # where require_instance raises
    ("babybear", (1 << 16,), "NN", "dif_rows"),
    ("goldilocks", (1 << 15,), "NN", "torch"),
    ("bn254_scalar", (2, 1 << 16), "NN", "torch"),
    ("goldilocks", (1, 1 << 16), "NN", "dif_rows_wide"),
    ("goldilocks", (1 << 16,), "NR", "torch"),
    ("bn254_scalar", (1 << 16,), "RN", "torch"),
    ("babybear", (3, 1 << 16), "NN", "torch"),
])
def test_cuda_route_rules(recorded, fname, shape, ordering, want):
    f = get_field(fname)
    x = torch.zeros(shape + f.limb_shape, dtype=torch.int32)
    y = TN._ntt_cuda(f, x, NTTDir.FORWARD, NTTConfig(ordering=Ordering(ordering)))
    assert y.shape == x.shape
    kernels = [c for c in recorded if c[0] != "check"]
    assert [c[0] for c in kernels] == [want]
    if want == "dif_rows_wide":
        # the instance check comes first, then one vector of (n,)+limbs
        assert recorded[0] == ("check", fname)
        assert kernels[0][2] == (int(np.prod(shape)),) + f.limb_shape
    else:
        assert ("check", fname) not in recorded
