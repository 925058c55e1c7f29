"""The arithmetic of the Poseidon2 CUDA kernel (icicle_tpu_torch/kernels/
poseidon2_kernel.py, kernels/csrc/poseidon2.cu) on the CPU, where the
kernel itself cannot run: its linear layers as add chains against the plain
version's Montgomery matrix products, the structure check that guards
them, the single-word Montgomery multiply's instruction sequence, the
compile-time instance table against the constant files, and the
Montgomery-multiply count of its bound. The kernel is held bit for bit
against `hash_fields_ref` on the card by chip_smoke.py.

Inputs come from numpy seeds (with 0 and p - 1 among them); every value
is a canonical field element, so the tolerance is exact equality."""

import os
import re

import numpy as np
import pytest
import torch

from icicle_tpu_torch import Poseidon2, get_field
from icicle_tpu_torch.kernels import poseidon2_kernel as PK
from icicle_tpu_torch.ops.hash import poseidon2 as TP
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

# Several pytest workers share the cores; torch's intra-op threads would
# oversubscribe them.
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(TP.__file__), "data")
FILES = sorted(f[len("poseidon2_"):-len(".npz")] for f in os.listdir(DATA)
               if f.startswith("poseidon2_"))
ENGINES = FILES  # every constant file's field has a port engine
WORD_MODULI = {"babybear": 0x78000001, "koalabear": 0x7F000001, "m31": 0x7FFFFFFF}
SOURCES = [os.path.join(os.path.dirname(PK.__file__), "csrc", f)
           for f in ("poseidon2.cu", "poseidon2_limbs.cu")]
GL64_SOURCE = os.path.join(os.path.dirname(PK.__file__), "csrc", "poseidon2_gl64.cu")


def _widths(fname):
    return TP.supported_arities(fname)


def _states(f, t: int, seed: int) -> torch.Tensor:
    """(6, t)+lim canonical elements; row 0 all 0, row 1 all p - 1."""
    rng = np.random.default_rng(seed)
    vals = [[int.from_bytes(rng.bytes(48), "little") % f.modulus for _ in range(t)]
            for _ in range(6)]
    vals[0], vals[1] = [0] * t, [f.modulus - 1] * t
    return f.from_ints(np.array(vals, dtype=object), "cpu")


def test_ten_constant_files():
    assert len(FILES) == 10 and "goldilocks" in FILES and "babybear" in FILES


@pytest.mark.parametrize("fname", ENGINES)
def test_integer_layers_equal_montgomery_products(fname):
    """ext_layer / int_layer (the kernel's chains, in plain torch) against
    Poseidon2._matmul_ext / _matmul_int at every width of the field."""
    f = get_field(fname)
    for t in _widths(fname):
        h = Poseidon2(fname, t)
        c = h.constants("cpu")
        s = _states(f, t, seed=t)
        assert torch.equal(PK.ext_layer(f, s), h._matmul_ext(s, c.mds)), (fname, t)
        assert torch.equal(PK.int_layer(f, s, c.diag_m1), h._matmul_int(s, c.diag_m1)), (fname, t)


@pytest.mark.parametrize("fname", FILES)
def test_chains_equal_integer_matrix_products(fname):
    """The same chains on Python ints mod p against M_ext and M_int as
    integer matrices, for every file, goldilocks' too."""
    rng = np.random.default_rng(7)
    for t in _widths(fname):
        mds, diag, p = PK.field_linear_layers(fname, t)
        add = lambda a, b: (a + b) % p  # noqa: E731
        for trial in range(4):
            s = [int.from_bytes(rng.bytes(48), "little") % p for _ in range(t)]
            if trial == 0:
                s = [0] * (t - 1) + [p - 1]
            want_ext = [sum(m * v for m, v in zip(row, s)) % p for row in mds]
            assert PK.ext_chain(s, add) == want_ext, (fname, t)
            tot = sum(s)
            want_int = [(tot + (d - 1) * v) % p for d, v in zip(diag, s)]
            assert PK.int_chain(s, add, lambda i, v: (diag[i] - 1) * v % p) == want_int


@pytest.mark.parametrize("fname", FILES)
def test_structure_check_accepts_every_file(fname):
    for t in _widths(fname):
        PK.check_linear_layers(t, *PK.field_linear_layers(fname, t))


@pytest.mark.parametrize("t", [2, 3, 4, 8, 24])
def test_structure_check_raises_on_a_perturbed_mds(t):
    mds, diag, p = PK.field_linear_layers("babybear", t)
    bad = [list(row) for row in mds]
    bad[t - 1][0] += 1
    with pytest.raises(IcicleException, match="M_ext") as err:
        PK.check_linear_layers(t, bad, diag, p)
    assert err.value.code == IcicleError.API_NOT_IMPLEMENTED
    with pytest.raises(IcicleException, match="M_ext"):
        PK.check_linear_layers(t, [row[::-1] for row in mds], diag, p)


@pytest.mark.parametrize("fname,t", [("babybear", 2), ("m31", 3), ("bn254_scalar", 2),
                                     ("stark252", 3)])
def test_structure_check_raises_on_a_perturbed_diag(fname, t):
    mds, diag, p = PK.field_linear_layers(fname, t)
    for bad in ([diag[0] + 1] + diag[1:], diag[::-1], [d + p - 1 for d in diag]):
        with pytest.raises(IcicleException, match="diag") as err:
            PK.check_linear_layers(t, mds, bad, p)
        assert err.value.code == IcicleError.API_NOT_IMPLEMENTED
    # at t >= 4 the diagonal is multiplied in as a general element
    mds4, diag4, _ = PK.field_linear_layers(fname, 4)
    PK.check_linear_layers(4, mds4, [d + 1 for d in diag4], p)


def test_cuda_path_runs_the_structure_check(monkeypatch):
    """The check the wrapper makes before a launch raises for a field whose
    constants lack the structure; it is cached per (field, t) only on
    success."""
    mds, diag, p = PK.field_linear_layers("babybear", 2)
    monkeypatch.setattr(PK, "field_linear_layers",
                        lambda name, t: ([[2, 1], [1, 3]], diag, p))
    PK._checked_structure.cache_clear()
    with pytest.raises(IcicleException) as err:
        PK._checked_structure("babybear", 2)
    assert err.value.code == IcicleError.API_NOT_IMPLEMENTED
    monkeypatch.undo()
    PK._checked_structure.cache_clear()
    PK._checked_structure("babybear", 2)


@pytest.mark.parametrize("fname", sorted(WORD_MODULI))
def test_montgomery_multiply_model(fname):
    """a b 2^-32 mod p for a < 2^32 (one operand may be unreduced) and
    b < p: at the edges of both ranges and at 10^4 seeded pairs."""
    p = get_field(fname).modulus
    assert p == WORD_MODULI[fname]
    rinv = pow(1 << 32, -1, p)
    edges_a = [0, 1, 2, p - 2, p - 1, p, p + 1, 2 * p - 1, (1 << 31) - 1, 1 << 31,
               (1 << 32) - 2, (1 << 32) - 1]
    edges_b = [0, 1, 2, p // 2, p - 2, p - 1, (1 << 32) % p, (1 << 64) % p]
    for a in edges_a:
        for b in edges_b:
            assert PK.mont_mul_model(a, b, p) == a * b * rinv % p, (a, b)
    rng = np.random.default_rng(11)
    a = rng.integers(0, 1 << 32, size=10_000, dtype=np.uint64)
    b = rng.integers(0, p, size=10_000, dtype=np.uint64)
    for x, y in zip(a.tolist(), b.tolist()):
        assert PK.mont_mul_model(x, y, p) == x * y * rinv % p


def test_needed_monts():
    """The kernel bound's count: babybear t = 2 n = 2 is 12 * 2 * 4 S-box
    multiplies in the full rounds, 24 * 4 in the partial rounds and 3
    conversions."""
    assert PK.needed_monts(Poseidon2("babybear", 2), 2) == 12 * 2 * 4 + 24 * 4 + 3 == 195
    # the sponge: babybear t = 3, 5 inputs = 2 permutations of (12 * 3 + 17)
    # S-boxes of 4 multiplies, no multiply in the linear layers, 6 conversions
    assert PK.needed_monts(Poseidon2("babybear", 3), 5) == 2 * (12 * 3 + 17) * 4 + 6 == 430
    # 8 limbs: bn254_scalar t = 4 (alpha 5: 3 multiplies), 8 full rounds and
    # 56 partial ones, each of those with 4 multiplies by d - 1
    assert PK.needed_monts(Poseidon2("bn254_scalar", 4), 4) == (8 * 4 + 56) * 3 + 56 * 4 + 5
    # a domain tag takes one input's place and is no conversion
    assert PK.needed_monts(Poseidon2("babybear", 4, domain_tag=5), 3) \
        == (8 * 4 + 21) * 4 + 21 * 4 + 4


def _instances():
    src = "".join(open(f).read() for f in SOURCES)
    words = re.findall(r"X\((\w+), (0x[0-9a-f]+)u, (\d+), (\d+), (\d+), (\d+)\)", src)
    limbs = re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)\s", src)
    return ([(name, int(p, 16), *map(int, rest)) for name, p, *rest in words],
            [tuple(map(int, v)) for v in limbs])


def test_kernel_instances_match_the_constant_files():
    """Every (field, t) the wrapper sends to the kernel has an instance in
    poseidon2.cu or poseidon2_limbs.cu with the file's round counts and
    alpha."""
    words, limbs = _instances()
    assert len(words) == 24 and len(limbs) == 12
    for name, p, t, half, partial, alpha in words:
        h = Poseidon2(name, t)
        assert (p, half, partial, alpha) == (get_field(name).modulus, h.half_full,
                                             h.partial_rounds, h.alpha), (name, t)
    have = {(name, t) for name, _, t, *_ in words}
    for fname in PK.WORD_FIELDS:
        assert {(fname, t) for t in _widths(fname)} <= have
    for fname in ENGINES:
        f = get_field(fname)
        if f.nlimbs != 8 or f.modulus.bit_length() > PK.MAX_BITS_8:
            continue
        for t in PK.KERNEL_WIDTHS[8]:
            h = Poseidon2(fname, t)
            assert PK.supported_on_cuda(h)
            assert (t, h.half_full, h.partial_rounds, h.alpha) in limbs, (fname, t)


def test_goldilocks_instances_match_the_constant_file():
    """poseidon2_gl64.cu's table: one instance a width the wrapper sends to
    the kernel, with the file's round counts and alpha."""
    table = re.findall(r"X\(goldilocks, (\d+), (\d+), (\d+), (\d+)\)", open(GL64_SOURCE).read())
    rows = [tuple(map(int, row)) for row in table]
    assert [t for t, *_ in rows] == list(PK.KERNEL_WIDTHS[2])
    for t, half, partial, alpha in rows:
        h = Poseidon2("goldilocks", t)
        assert PK.supported_on_cuda(h)
        assert (half, partial, alpha) == (h.half_full, h.partial_rounds, h.alpha), t
        PK.check_linear_layers(t, *PK.field_linear_layers("goldilocks", t))


def test_needed_multiplies_goldilocks():
    """Goldilocks has no Montgomery form: no conversions in or out. t = 2
    (alpha 7: 4 multiplies an S-box): 8 full rounds of 2 S-boxes and 27
    partial rounds of one, the linear layers adds; t = 4 adds 21 partial
    rounds of 4 multiplies by d - 1."""
    assert PK.needed_monts(Poseidon2("goldilocks", 2), 2) == (8 * 2 + 27) * 4 == 172
    assert PK.needed_monts(Poseidon2("goldilocks", 4), 4) == (8 * 4 + 21) * 4 + 21 * 4
    assert PK.needed_monts(Poseidon2("goldilocks", 3), 5) == 2 * (8 * 3 + 23) * 4


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_116poseidon2_kernelINS_11babybear_t2ELb0EEEvPKjPjxiNT_4ArgsE
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                  /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   ISETP.GE.AND P0, PT, R0, 0x10, PT ;
        /*0030*/               @P0 BRA `(.L_x_1) ;
        /*0040*/                   IMAD.WIDE.U32 R2, R0, 0x4, R2 ;
        /*0050*/                   IMAD.MOV.U32 R5, RZ, RZ, 0x1 ;
        /*0060*/                   IMAD R6, R2, R3, RZ ;
        /*0070*/                   IMAD.HI.U32 R7, R2, R3, RZ ;
        /*0080*/                   VIMNMX.U32 R8, R6, R7, PT ;
.L_x_1:
        /*0090*/                   EXIT ;
\t\tFunction : _Z5otherv
        /*0000*/                   EXIT ;
"""


def test_sass_counts_parse_cuobjdump_text():
    from icicle_tpu_torch.kernels import sass
    funcs = sass.functions(SASS)
    assert list(funcs) == ["_ZN12_GLOBAL__N_116poseidon2_kernelINS_11babybear_t2ELb0EEEvPKjPjxiNT_"
                           "4ArgsE", "_Z5otherv"]
    body = funcs[next(iter(funcs))]
    assert sass.counts(body) == {"BRA": 1, "EXIT": 1, "IMAD": 1, "IMAD.HI": 1, "IMAD.MOV": 1,
                                 "IMAD.WIDE": 1, "ISETP": 1, "LDC": 1, "S2R": 1, "VIMNMX": 1,
                                 "total": 10, "branches": 1}
    bl = sass.blocks(body)
    assert [(b["start"], b["counts"]["total"], b["branch_to"]) for b in bl] == [
        (0x0, 4, ".L_x_1"), (0x40, 5, None), (".L_x_1", 1, None)]
    assert sass.weighted(bl, {0x0: 1, 0x40: 3, ".L_x_1": 1})["IMAD.WIDE"] == 3
