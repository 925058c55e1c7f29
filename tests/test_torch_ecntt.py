"""The ECNTT on the port (icicle_tpu_torch/ops/ecntt.py and the plain
versions of its kernel, kernels/ecntt_kernel.py) against a Python-int DFT
over points (tests/ec_ref.py) and the JAX package (icicle_tpu/ops/ecntt.py).

Tolerances: equal as affine points against the DFT; limb for limb (the
projective coordinates themselves) against JAX, whose ladder and stage
order the port repeats. JAX's `ecntt_jit` compiles for 30 s (bls12_377,
n = 2, forward) to minutes (bn254 n = 4: 72 s a configuration; an inverse
with its scale ladder 163 s at bls12_377 n = 2; at bw6_761 over 40 GiB of
memory) on the CPU, so the comparisons with it are slow-marked; JAX's `scalar_mul_vec_glv` over one
stage's lanes, the function the kernel's plain version replaces, is held
to the port's at tier 1, as are the DFT and the configuration surface."""

import numpy as np
import pytest
import torch

from icicle_tpu_torch import interop
from icicle_tpu_torch.curves.group import Projective, get_group
from icicle_tpu_torch.curves.params import get_curve
from icicle_tpu_torch.kernels import ecntt_kernel as EK
from icicle_tpu_torch.ops import ecntt as E
from icicle_tpu_torch.ops.vec_ops import bit_reverse_indices
from icicle_tpu_torch.runtime import device
from icicle_tpu_torch.runtime.config import NTTConfig, NTTDir, Ordering
from tests.ec_ref import INF, ec_add, ec_mul


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))


def points(cname: str, logs) -> tuple:
    """(affine Python-int points k G, their Montgomery projective tensor)."""
    c, g = get_curve(cname), get_group(cname)
    fq = c.fq
    pts = [ec_mul((c.gen_x, c.gen_y), int(k), fq.modulus) for k in logs]
    proj = g.from_affine_canonical(fq.from_ints([p[0] for p in pts]),
                                   fq.from_ints([p[1] for p in pts]))
    return pts, proj


def affine(cname: str, proj: Projective) -> list:
    g, fq = get_group(cname), get_curve(cname).fq
    x, y = g.to_affine_canonical(proj)
    return [(int(a), int(b)) for a, b in zip(fq.to_ints(x), fq.to_ints(y))]


def dft(cname: str, pts: list) -> list:
    """sum_j w^(jk) P_j for each k, affine ints ((0, 0) the identity)."""
    c = get_curve(cname)
    r, mod, n = c.fr.modulus, c.fq.modulus, len(pts)
    w = c.fr.params.omega(n.bit_length() - 1)
    out = []
    for k in range(n):
        acc = INF
        for j, p in enumerate(pts):
            acc = ec_add(acc, ec_mul(p, pow(w, j * k, r), mod), mod)
        out.append((0, 0) if acc is INF else acc)
    return out


def test_ecntt_dft_bn254_n8():
    pts, proj = points("bn254", [5, 11, 23, 47, 2, 1 << 40, 97, 12345])
    out = E.ecntt("bn254", proj, NTTDir.FORWARD)
    assert affine("bn254", out) == dft("bn254", pts)
    back = E.ecntt_jit("bn254", out, NTTDir.INVERSE)
    assert affine("bn254", back) == pts


def test_ecntt_config_surface_bn254_n4():
    """NR is NN's output bit-reversed; RN of a bit-reversed input is NN;
    a forward on the coset c is NN of (c^j P_j), and its inverse gives the
    points back; a batch of 2 in both layouts is each vector's transform;
    NM / MN alias NR / RN (a pure radix-2 engine)."""
    cname = "bn254"
    r, mod = get_curve(cname).fr.modulus, get_curve(cname).fq.modulus
    pts, proj = points(cname, [5, 11, 23, 47])
    base = affine(cname, E.ecntt(cname, proj))
    assert base == dft(cname, pts)
    rev = list(bit_reverse_indices(4))
    out = E.ecntt(cname, proj, cfg=NTTConfig(ordering=Ordering.NR))
    assert affine(cname, out) == [base[rev[i]] for i in range(4)]
    idx = torch.tensor(rev, dtype=torch.int64)
    proj_rev = Projective(*(c.index_select(0, idx) for c in proj))
    assert affine(cname, E.ecntt(cname, proj_rev, cfg=NTTConfig(ordering=Ordering.RN))) == base
    assert E._ORDER_FLAGS[Ordering.NM] == E._ORDER_FLAGS[Ordering.NR]
    assert E._ORDER_FLAGS[Ordering.MN] == E._ORDER_FLAGS[Ordering.RN]
    assert E._ORDER_FLAGS[Ordering.RR] == (True, True)
    cfg = NTTConfig(coset_gen=7)
    out_c = E.ecntt(cname, proj, NTTDir.FORWARD, cfg)
    scaled = [ec_mul(p, pow(7, j, r), mod) for j, p in enumerate(pts)]
    assert affine(cname, out_c) == dft(cname, scaled)
    assert affine(cname, E.ecntt(cname, out_c, NTTDir.INVERSE, cfg)) == pts
    pts2, proj2 = points(cname, [3, 9, 21, 33])
    base2 = dft(cname, pts2)
    rows = Projective(*(torch.stack([a, b]) for a, b in zip(proj, proj2)))
    outb = E.ecntt(cname, rows, cfg=NTTConfig(batch_size=2))
    assert [affine(cname, Projective(*(c[i] for c in outb))) for i in range(2)] == [base, base2]
    cols = Projective(*(c.transpose(0, 1).contiguous() for c in rows))
    outc = E.ecntt(cname, cols, cfg=NTTConfig(batch_size=2, columns_batch=True))
    assert [affine(cname, Projective(*(c[:, i] for c in outc))) for i in range(2)] == [base, base2]
    with pytest.raises(Exception, match="power of two"):
        E.ecntt(cname, Projective(*(c[:3] for c in proj)))


@pytest.mark.parametrize("cname", ["bls12_377", "bw6_761"])
def test_ecntt_dft_n2(cname):
    """12- and 24-limb curves at n = 2: stage 1 and the inverse's scale
    ladder (GLV over 12 and 24 limbs), against the DFT."""
    pts, proj = points(cname, [7, 1 << 33])
    out = E.ecntt(cname, proj)
    assert affine(cname, out) == dft(cname, pts)
    assert affine(cname, E.ecntt(cname, out, NTTDir.INVERSE)) == pts


def test_plain_ladder_gives_the_same_points(monkeypatch):
    """ICICLE_TPU_ECNTT_GLV=0 runs the plain ladder (JAX's switch): the
    same points, other projective coordinates."""
    pts, proj = points("bn254", [5, 11, 23, 47])
    glv = E.ecntt("bn254", proj)
    monkeypatch.setenv("ICICLE_TPU_ECNTT_GLV", "0")
    plain = E.ecntt("bn254", proj)
    assert affine("bn254", plain) == affine("bn254", glv) == dft("bn254", pts)


def test_stage_and_scale_wrappers_take_the_plain_version_on_the_cpu():
    """On a CPU tensor ecntt_stage / ecntt_scale compute their plain
    versions; their checks refuse a bad half-block and bad flags."""
    _, proj = points("bn254", range(3, 11))
    g = get_group("bn254")
    rows = E._stage_rows("bn254", 3, False, True, torch.device("cpu"))[-1]
    got = EK.ecntt_stage(g, proj, 4, rows, True)
    want = EK.ecntt_stage_ref(g, proj, 4, rows, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(Exception, match="half-block"):
        EK.ecntt_stage(g, proj, 3, rows, True)
    with pytest.raises(Exception, match="sign flags"):
        EK.ecntt_stage(g, proj, 4, rows[:2] + (rows[2].to(torch.int32), rows[3]), True)
    EK.require_instance(g)
    with pytest.raises(Exception, match="no CUDA kernel"):
        EK.require_instance(get_group("bn254", g2=True))


def test_digit_rows_and_glv_rows_equal_jax():
    """The twiddle digit rows the kernel reads, against JAX's `_glv_rows`,
    `_stage_glv` and `_stage_digits` (numpy, no compile)."""
    import icicle_tpu.ops.ecntt as J
    for cname in ("bn254", "bls12_377", "bw6_761"):
        vals = [0, 1, get_curve(cname).fr.modulus - 1, 123456789 ** 5]
        for got, want in zip(E._glv_rows(cname, vals), J._glv_rows(cname, vals)):
            assert np.array_equal(got, np.asarray(want).astype(got.dtype))
        for got, want in zip(E._stage_glv(cname, 3, True), J._stage_glv(cname, 3, True)):
            assert all(np.array_equal(a, np.asarray(b).astype(a.dtype)) for a, b in zip(got, want))
        for got, want in zip(E._stage_digits(cname, 3, False), J._stage_digits(cname, 3, False)):
            assert np.array_equal(got, want.astype(got.dtype))


# -- against the JAX package itself ----------------------------------------------------

def _jax_points(cname, proj):
    """The port's points as a JAX Projective. JAX's group is made here, out
    of any trace: JAX `get_group` caches the group it first makes, and
    first made inside `ecntt_jit`'s trace its constants would be tracers
    that leak (UnexpectedTracerError), as JAX's own tests avoid by making
    it first."""
    import jax.numpy as jnp
    from icicle_tpu.curves.group import Projective as JProjective
    from icicle_tpu.curves.group import get_group as jget_group
    jget_group(cname)
    return JProjective(*(jnp.asarray(c) for c in interop.projective_to_numpy(proj)))


def _same_limbs(cname: str, tp: Projective, jp) -> bool:
    """The JAX points, carried across by interop, equal the port's limb for
    limb."""
    back = interop.projective_from_numpy(cname, *(np.asarray(c) for c in jp))
    return all(torch.equal(a, b) for a, b in zip(tp, back))


def test_stage_ladder_equals_jax_scalar_mul_vec_glv():
    """The kernel's plain ladder over a stage's lanes against JAX
    `scalar_mul_vec_glv` (icicle_tpu/ops/ecntt.py:35), limb for limb: the
    odd points of the last stage of a bn254 2^3 transform, its digit rows."""
    import jax.numpy as jnp
    import icicle_tpu.ops.ecntt as J
    from icicle_tpu.curves.group import get_group as jget_group
    _, proj = points("bn254", [5, 11, 23, 47])
    rows = E._stage_rows("bn254", 3, False, True, torch.device("cpu"))[-1]
    got = EK.scalar_mul_vec_glv(get_group("bn254"), proj, rows)
    jrows = tuple(jnp.asarray(a.numpy().astype(np.uint32) if a.dtype != torch.bool else a.numpy())
                  for a in rows)
    want = J.scalar_mul_vec_glv(jget_group("bn254"), _jax_points("bn254", proj), jrows)
    assert _same_limbs("bn254", got, want)


@pytest.mark.slow
def test_ecntt_equals_jax_bn254_n4():
    """NN, NR, RN, a coset forward and its inverse, a batch of 2 in both
    layouts: the port's projective limbs equal JAX `ecntt_jit`'s."""
    import jax.numpy as jnp
    import icicle_tpu.ops.ecntt as J
    from icicle_tpu.runtime.config import NTTConfig as JC
    from icicle_tpu.runtime.config import NTTDir as JD
    from icicle_tpu.runtime.config import Ordering as JO
    cname = "bn254"
    _, proj = points(cname, [5, 11, 23, 47])
    _, proj2 = points(cname, [3, 9, 21, 33])
    jp = _jax_points(cname, proj)
    for order in ("NN", "NR", "RN"):
        got = E.ecntt(cname, proj, cfg=NTTConfig(ordering=Ordering(order)))
        assert _same_limbs(cname, got, J.ecntt_jit(cname, jp, JD.FORWARD, JC(ordering=JO(order))))
    got = E.ecntt(cname, proj, cfg=NTTConfig(coset_gen=7))
    jgot = J.ecntt_jit(cname, jp, JD.FORWARD, JC(coset_gen=7))
    assert _same_limbs(cname, got, jgot)
    assert _same_limbs(cname, E.ecntt(cname, got, NTTDir.INVERSE, NTTConfig(coset_gen=7)),
                       J.ecntt_jit(cname, jgot, JD.INVERSE, JC(coset_gen=7)))
    rows = Projective(*(torch.stack([a, b]) for a, b in zip(proj, proj2)))
    got = E.ecntt(cname, rows, cfg=NTTConfig(batch_size=2))
    assert _same_limbs(cname, got, J.ecntt_jit(cname, _jax_points(cname, rows), JD.FORWARD,
                                        JC(batch_size=2)))
    cols = Projective(*(c.transpose(0, 1).contiguous() for c in rows))
    got = E.ecntt(cname, cols, cfg=NTTConfig(batch_size=2, columns_batch=True))
    assert _same_limbs(cname, got, J.ecntt_jit(cname, _jax_points(cname, cols), JD.FORWARD,
                                        JC(batch_size=2, columns_batch=True)))


@pytest.mark.slow
@pytest.mark.parametrize("cname, n", [("bls12_377", 2), ("bls12_381", 2)])
def test_ecntt_equals_jax_limb_curves(cname, n):
    """12-limb curves, forward and inverse, limb for limb with JAX (163 s of
    compile an inverse). JAX's 24-limb `ecntt_jit` (bw6_761) took over 40
    GiB of host memory to compile on the CPU and was stopped: bw6_761 is
    held to the DFT at tier 1 (test_ecntt_dft_n2)."""
    import icicle_tpu.ops.ecntt as J
    from icicle_tpu.runtime.config import NTTDir as JD
    pts, proj = points(cname, [7, 1 << 33, 99, 1234][:n])
    out = E.ecntt(cname, proj)
    jout = J.ecntt_jit(cname, _jax_points(cname, proj), JD.FORWARD)
    assert _same_limbs(cname, out, jout)
    assert affine(cname, out) == dft(cname, pts)
    assert _same_limbs(cname, E.ecntt(cname, out, NTTDir.INVERSE), J.ecntt_jit(cname, jout, JD.INVERSE))
