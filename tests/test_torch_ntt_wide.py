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
FIELDS = ["goldilocks", "bn254_scalar", "bw6_761_scalar"]
EIGHT_LIMB = ["bn254_scalar", "bls12_381_scalar", "bls12_377_scalar", "grumpkin_scalar",
              "stark252"]


def _elements(f, shape, seed):
    rng = np.random.default_rng(seed)
    nbytes = 56 if f.nlimbs > 8 else 40   # more bits than the modulus has
    vals = [int.from_bytes(rng.bytes(nbytes), "little") % f.modulus
            for _ in range(int(np.prod(shape)))]
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


@pytest.mark.parametrize("fname", FIELDS)
def test_ref_takes_w0_as_one(fname):
    """The butterflies whose twiddle is w^0 (k = 0) are not multiplied, as
    the kernel leaves them: a stage table whose k = 0 lanes hold random
    elements gives the output of the real one."""
    f = get_field(fname)
    log_n = 5
    x = _elements(f, (4, 1 << log_n), seed=7)
    factor = _elements(f, (4, 1 << log_n), seed=8)
    tw = NK._stage_twiddles(f, log_n, True, CPU)
    odd = tw.clone()
    lane = torch.arange(1 << log_n)
    for s in range(log_n):
        k0 = lane[lane % ((1 << log_n) >> (s + 1)) == 0]
        odd[s, k0] = _elements(f, (k0.numel(),), seed=9 + s)
    assert not torch.equal(odd, tw)
    for tout in (False, True):
        assert torch.equal(NW.dif_rows_wide_ref(f, x, odd, factor, transpose_out=tout),
                           NW.dif_rows_wide_ref(f, x, tw, factor, transpose_out=tout))


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


def test_four_step_wide_twelve_limbs():
    """bw6_761_scalar (12 limbs) at 2^10 (passes of 32 x 32): the plain
    four-step against `_ntt_torch`, forward and inverse."""
    f = get_field("bw6_761_scalar")
    x = _elements(f, (1 << 10,), seed=6)
    y = NW.ntt_four_step_wide(f, x, NTTDir.FORWARD)
    assert torch.equal(y, TN._ntt_torch(f, x, NTTDir.FORWARD, NTTConfig()))
    assert torch.equal(NW.ntt_four_step_wide(f, y, NTTDir.INVERSE), x)


# wide_plan's (TR, threads, cluster) at every row length of each instance,
# for 4096 rows and for one: a tile's rows fill a 32-byte sector of a
# column (4 goldilocks words), a cluster splits a tile so that two blocks
# share an SM, and rows too long for one block (above 2^12) always span
# one; the first stage group holds the stages that cross blocks, so fp8
# and fp12 (groups of 2 index bits) stop at clusters of 4
PLANS_4096 = {
    "gl64": {**dict.fromkeys(range(1, 7), (4, 32, 1)), 7: (4, 64, 1), 8: (4, 128, 1),
             9: (4, 256, 1), 10: (4, 256, 1), 11: (4, 256, 1), 12: (4, 256, 2),
             13: (4, 256, 4), 14: (4, 256, 8), 15: (4, 256, 8), 16: (2, 256, 8),
             17: (1, 256, 8)},
    "fp8": {**dict.fromkeys(range(1, 8), (1, 32, 1)), 8: (1, 64, 1), 9: (1, 128, 1),
            10: (1, 256, 1), 11: (1, 256, 1), 12: (1, 256, 2), 13: (1, 256, 4),
            14: (1, 256, 4)},
}
PLANS_4096["fp12"] = PLANS_4096["fp8"]
PLANS_ONE_ROW = {
    "gl64": {**dict.fromkeys(range(1, 8), (1, 32, 1)), 8: (1, 32, 1), 9: (1, 64, 1),
             10: (1, 128, 1), 11: (1, 256, 1), 12: (1, 256, 1), 13: (1, 256, 1),
             14: (1, 256, 2), 15: (1, 256, 4), 16: (1, 256, 8), 17: (1, 256, 8)},
    "fp8": PLANS_4096["fp8"], "fp12": PLANS_4096["fp12"],
}


def test_instances_and_limits():
    assert NW.instance(get_field("goldilocks")) == "gl64"
    for fname in EIGHT_LIMB + ["bn254_base"]:
        assert NW.instance(get_field(fname)) == "fp8", fname
    for fname in ("bw6_761_scalar", "bls12_377_base", "bls12_381_base"):
        assert NW.instance(get_field(fname)) == "fp12", fname
    for fname in ("babybear", "bw6_761_base"):
        assert NW.instance(get_field(fname)) is None, fname
    assert NW.MAX_LOG_N == {"gl64": 17, "fp8": 14, "fp12": 14}
    for kind in ("gl64", "fp8", "fp12"):
        for log_n in range(1, NW.MAX_LOG_N[kind] + 1):
            assert NW.wide_plan(4096, log_n, kind) == PLANS_4096[kind][log_n], (kind, log_n)
            assert NW.wide_plan(1, log_n, kind) == PLANS_ONE_ROW[kind][log_n], (kind, log_n)
        assert NW.wide_plan(1, NW.MAX_LOG_N[kind] + 1, kind) is None, kind
    assert NW.wide_plan(6, 4, "gl64") == (2, 32, 1)    # TR divides the rows
    # every plan's blocks fit the shared memory; the group sizes cover log_n
    for kind, plans in PLANS_4096.items():
        for log_n, (tr, _, cluster) in plans.items():
            assert NW.smem_bytes(log_n, tr, cluster, kind) <= NW.SMEM_LIMIT
            sizes = NW.group_sizes(log_n, kind)
            assert sum(sizes) == log_n and max(sizes) <= NW.GROUP[kind]
            assert cluster == 1 or sizes[0] >= cluster.bit_length() - 1
    # the fp8 and fp12 launches pass poseidon2_kernel's array, whose lead
    # is ec_field.cuh's CurveConsts<L>: p, R mod p, inv32
    for fname, nl in (("bn254_scalar", 8), ("bw6_761_scalar", 12)):
        f = get_field(fname)
        consts = list(NW.field_consts(fname))
        assert sum(v << (32 * i) for i, v in enumerate(consts[:nl])) == f.modulus
        assert sum(v << (32 * i) for i, v in enumerate(consts[nl:2 * nl])) == f.params.r
        assert consts[2 * nl] == f.params.inv32


def test_launch_plan_checks_an_override():
    """`_plan` (TR, cluster) is taken where the C entry would take it, with
    `_threads`' block, and refused with INVALID_ARGUMENT before any launch
    where it would not; without one the plan is `wide_plan`'s."""
    assert NW.launch_plan(4096, 12, "gl64") == NW.wide_plan(4096, 12, "gl64")
    assert NW.launch_plan(4096, 12, "gl64", (8, 4)) == (8, 256, 4)
    assert NW.launch_plan(2048, 11, "fp12", (1, 4)) == (1, 128, 4)
    assert NW.launch_plan(64, 8, "fp8", (1, 1)) == (1, 64, 1)
    for rows, log_n, kind, plan in ((4096, 12, "gl64", (3, 1)),    # TR not a power of two
                                    (6, 4, "gl64", (4, 1)),        # TR does not divide rows
                                    (2048, 11, "fp8", (1, 8)),     # groups of 2: clusters to 4
                                    (2048, 13, "fp8", (1, 1)),     # a block's memory overflows
                                    (64, 4, "fp12", (1, 16))):
        with pytest.raises(IcicleException, match="plan") as e:
            NW.launch_plan(rows, log_n, kind, plan)
        assert e.value.code == IcicleError.INVALID_ARGUMENT
    f = get_field("goldilocks")
    x = _elements(f, (4, 32), seed=5)
    with pytest.raises(IcicleException, match="plan"):
        NW.dif_rows_wide(f, x, NK._stage_twiddles(f, 5, True, CPU), _plan=(8, 1))


def test_kernel_source_holds_the_plan_s_constants():
    """The wrapper plans what ntt_wide.cu is built for and checks: GROUP is
    each instance's kMaxGroup (the kernel's registers are those of its
    largest group), MAX_THREADS its kThreads, CLUSTERS end at kMaxCluster,
    and `smem_bytes` is the source's `row_words`; the source takes the
    group sizes from the caller and plans none."""
    import re

    from icicle_tpu_torch.kernels import build

    text = open(f"{build.CSRC}/ntt_wide.cu").read()
    gl = text[text.index("struct Gl64 {"):text.index("struct FpWide {")]
    fp = text[text.index("struct FpWide {"):text.index("struct Pass {")]
    for body, kinds in ((gl, ("gl64",)), (fp, ("fp8", "fp12"))):
        assert [int(v) for v in re.findall(r"kMaxGroup = (\d+);", body)] == [NW.GROUP[kinds[0]]]
        assert all(NW.GROUP[k] == NW.GROUP[kinds[0]] for k in kinds)
        assert re.search(r"kThreads = (\d+),", body).group(1) == str(NW.MAX_THREADS)
    assert re.search(r"kMaxCluster = (\d+);", text).group(1) == str(max(NW.CLUSTERS))
    assert "int plane_words(int log_s) { return (1 << log_s) + ((1 << log_s) >> 5); }" in text
    assert ("int row_words(int w, int log_s, int tr) { return w * plane_words(log_s) + "
            "(tr > 1 ? 32 / tr : 0); }") in text
    assert "plan_groups" not in text and "sizes[g] > F::kMaxGroup" in text
    # smem_bytes is 4 TR row_words over the block's slice, 2^log_n / cluster
    for kind, words in (("gl64", 2), ("fp8", 8), ("fp12", 12)):
        for log_n, tr, cluster in ((12, 4, 2), (11, 1, 1), (14, 2, 8), (5, 1, 4)):
            s = (1 << log_n) // cluster
            assert NW.smem_bytes(log_n, tr, cluster, kind) == \
                4 * tr * (words * (s + (s >> 5)) + (32 // tr if tr > 1 else 0))


def _not_implemented(fn, *args, match="no CUDA kernel"):
    with pytest.raises(IcicleException, match=match) as e:
        fn(*args)
    assert e.value.code == IcicleError.API_NOT_IMPLEMENTED


def test_unserved_fields_raise_on_the_card():
    """On a CUDA tensor (a stand-in that reports is_cuda) the 24-limb
    bw6_761_base has no instance, and an NTT whose four-step rows pass
    MAX_LOG_N none: these raise before any work. Every size up to the
    limits, which lie past each field's domain or the card's memory, is
    served."""
    card = types.SimpleNamespace(is_cuda=True)
    _not_implemented(NW.require_instance, get_field("bw6_761_base"), card)
    for fname, served in (("bn254_scalar", 28), ("bls12_381_scalar", 28), ("goldilocks", 34),
                          ("bw6_761_scalar", 28), ("bls12_377_base", 28)):
        f = get_field(fname)
        for logn in (16, 25, served):
            NW.require_instance(f, card, logn)
        _not_implemented(NW.require_instance, f, card, served + 1, match="past what")
    NW.require_instance(get_field("bw6_761_base"), torch.zeros(1))  # the CPU: no refusal


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
    ("bw6_761_scalar", (1 << 16,), "NN", "dif_rows_wide"),
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
