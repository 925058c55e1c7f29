"""The port's Poseidon2 (icicle_tpu_torch/ops/hash/poseidon2.py) against the
JAX package's `Poseidon2` and the reference C++ backend's golden vectors,
on the CPU (the plain version; the CUDA kernel is held against it on the
card by chip_smoke.py). Inputs come from numpy seeds; field elements are
canonical, so the tolerance is exact equality."""

import functools
import os

import numpy as np
import pytest
import torch

from icicle_tpu.fields.field import get_field as jax_field
from icicle_tpu.ops.hash import poseidon2 as JP
from icicle_tpu_torch import HashConfig, Poseidon2, get_field
from icicle_tpu_torch.kernels import poseidon2_kernel as PK
from icicle_tpu_torch.ops.hash import poseidon2 as TP
from icicle_tpu_torch.runtime import device
from icicle_tpu_torch.runtime.errors import IcicleException
from tests import ref_ffi

# Several pytest workers share the cores; torch's intra-op threads would
# oversubscribe them.
torch.set_num_threads(1)

BABYBEAR_WIDTHS = [2, 3, 4, 8, 12, 16, 20, 24]
# (field, t): every babybear width and one width of each other field family
CASES = ([("babybear", t) for t in BABYBEAR_WIDTHS]
         + [("koalabear", 4), ("m31", 8), ("bn254_scalar", 3), ("bls12_377_scalar", 2)])


def _elements(fname: str, shape, seed: int) -> np.ndarray:
    """Canonical uint32 elements (multi-limb: (..., L) limbs) from a seed."""
    f = jax_field(fname)
    rng = np.random.default_rng(seed)
    vals = np.array([int.from_bytes(rng.bytes(40), "little") % f.modulus
                     for _ in range(int(np.prod(shape)))], dtype=object).reshape(shape)
    return np.asarray(f.from_ints(vals), dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _jax_hasher(fname: str, t: int, domain_tag=None):
    """One JAX hasher per width: its constants and jitted hash are built once
    (a multi-limb field's take seconds)."""
    return JP.Poseidon2(jax_field(fname), t, domain_tag=domain_tag)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_data_files_are_the_jax_packages():
    src = os.path.join(os.path.dirname(JP.__file__), "data")
    dst = os.path.join(os.path.dirname(TP.__file__), "data")
    names = sorted(f for f in os.listdir(src) if f.startswith("poseidon2_"))
    assert names == sorted(f for f in os.listdir(dst) if f.startswith("poseidon2_"))
    assert len(names) == 10
    for name in names:
        with np.load(os.path.join(src, name)) as a, np.load(os.path.join(dst, name)) as b:
            assert sorted(a.files) == sorted(b.files), name
            for key in a.files:
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), \
                    (name, key)


@pytest.mark.parametrize("fname,t", CASES)
def test_montgomery_constants_equal_jax(fname, t):
    jh = _jax_hasher(fname, t)
    c = Poseidon2(fname, t, domain_tag=9).constants("cpu")
    for name in ("rc_full_top", "rc_partial", "rc_full_bot", "mds", "diag_m1"):
        want = np.asarray(getattr(jh, name))
        got = _u32(getattr(c, name))
        assert got.shape == want.shape and np.array_equal(got, want), name
    jf = jax_field(fname)
    nl = max(jf.nlimbs, 1)
    tag = 9 * (1 << (32 * nl)) % jf.modulus          # 9 in Montgomery form
    assert [int(w) for w in _u32(c.tag).reshape(-1)] == [
        (tag >> (32 * i)) & 0xFFFFFFFF for i in range(nl)]
    assert TP.supported_arities(fname) == JP.supported_arities(fname)


@pytest.mark.parametrize("fname,t", CASES)
def test_hash_fields_matches_jax(fname, t):
    lim = jax_field(fname).limb_shape
    x = _elements(fname, (3, t), seed=100 + t)
    want = np.asarray(_jax_hasher(fname, t).hash_fields(x))
    got = Poseidon2(fname, t).hash_fields(_t(x))
    assert got.shape == (3,) + lim
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("n", [1, 2, 5, 6, 9])
def test_sponge_lengths_match_jax(n):
    x = _elements("babybear", (2, n), seed=200 + n)
    want = np.asarray(_jax_hasher("babybear", 3).hash_fields(x))
    assert np.array_equal(_u32(Poseidon2("babybear", 3).hash_fields(_t(x))), want)


@pytest.mark.parametrize("n", [3, 1, 7])
def test_domain_tag_matches_jax(n):
    """t = 4 with a tag: n = 3 is one permutation, 1 and 7 the sponge."""
    x = _elements("babybear", (2, n), seed=300 + n)
    want = np.asarray(_jax_hasher("babybear", 4, 1234567).hash_fields(x))
    got = Poseidon2("babybear", 4, domain_tag=1234567).hash_fields(_t(x))
    assert np.array_equal(_u32(got), want)


def test_hash_words_and_bytes_match_jax(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))
    words = _elements("babybear", (4, 8), seed=400)
    jh, th = _jax_hasher("babybear", 8), Poseidon2("babybear", 8)
    got = th.hash_words(_t(words))
    assert got.shape == (4, 1) and th.digest_words == jh.digest_words == 1
    assert np.array_equal(_u32(got), np.asarray(jh.hash_words(words)))
    data = words.astype("<u4").tobytes()
    assert th.hash_bytes(data, batch=4) == jh.hash_bytes(data, batch=4)
    assert th.output_size == jh.output_size == 4
    assert th.default_input_words == jh.default_input_words == 8
    assert th.with_input_words(16).default_input_words == 16
    assert th.default_input_words == 8


def test_hash_words_multilimb_matches_jax():
    words = _elements("bn254_scalar", (2, 3), seed=500).reshape(2, 24)
    jh, th = _jax_hasher("bn254_scalar", 3), Poseidon2("bn254_scalar", 3)
    got = th.hash_words(_t(words))
    assert got.shape == (2, 8) and th.digest_words == jh.digest_words == 8
    # JAX hash_words is hash_fields over the same reshape; its own jit would
    # compile for seconds more
    assert np.array_equal(_u32(got), np.asarray(jh.hash_fields(words.reshape(2, 3, 8))))


# The golden vectors of tests/test_reference_vectors.py:21-52 (the reference
# C++ backend's babybear Poseidon2), replayed through tests/ref_ffi on the
# same inputs: the `rng` fixture's seed and draws are that file's.

@pytest.mark.parametrize("t", BABYBEAR_WIDTHS)
def test_golden_babybear(t, rng):
    p = get_field("babybear").modulus
    ins = np.array([[int.from_bytes(rng.bytes(8), "little") % p for _ in range(t)]
                    for _ in range(4)], dtype=np.uint32)
    want = ref_ffi.poseidon2_hash("babybear", t, ins.view(np.uint8)).view(np.uint32)
    got = Poseidon2("babybear", t).hash_fields(_t(ins))
    assert np.array_equal(_u32(got), want.reshape(4))


@pytest.mark.parametrize("t", [3, 8])
def test_golden_babybear_sponge(t, rng):
    p = get_field("babybear").modulus
    n = 2 * (t - 1) + 1
    ins = np.array([[int.from_bytes(rng.bytes(8), "little") % p for _ in range(n)]],
                   dtype=np.uint32)
    want = ref_ffi.poseidon2_hash("babybear", t, ins.view(np.uint8)).view(np.uint32)
    got = Poseidon2("babybear", t).hash_fields(_t(ins))
    assert int(_u32(got)[0]) == int(want.reshape(-1)[0])


def test_golden_babybear_domain_tag(rng):
    tag = 1234567
    ins = np.array([[5, 6, 7]], dtype=np.uint32)
    tag_bytes = np.array([tag], dtype=np.uint32).view(np.uint8)
    want = ref_ffi.poseidon2_hash("babybear", 4, ins.view(np.uint8), domain_tag=tag_bytes)
    got = Poseidon2("babybear", 4, domain_tag=tag).hash_fields(_t(ins))
    assert int(_u32(got)[0]) == int(want.view(np.uint32).reshape(-1)[0])


@pytest.mark.parametrize("backend", [None, "torch", "cuda"])
def test_backends_on_a_cpu_tensor_compute_the_plain_version(backend):
    x = _t(_elements("koalabear", (3, 2), seed=600))
    h = Poseidon2("koalabear", 2)
    launches = PK.poseidon2.launches
    got = h.hash_fields(x, HashConfig(backend=backend))
    assert torch.equal(got, h.hash_fields_ref(x))
    assert PK.poseidon2.launches == launches


def test_unknown_backend_and_bad_inputs_raise():
    h = Poseidon2("babybear", 2)
    x = _t(_elements("babybear", (3, 2), seed=700))
    with pytest.raises(IcicleException, match="no triton backend"):
        h.hash_fields(x, HashConfig(backend="triton"))
    with pytest.raises(IcicleException, match="int32"):
        h.hash_fields(x.to(torch.int64))
    with pytest.raises(IcicleException, match="expected"):
        PK.poseidon2(h, x.reshape(-1))
    with pytest.raises(IcicleException, match="contiguous"):
        PK.poseidon2(h, x.T)
    with pytest.raises(IcicleException, match="hash_words"):
        Poseidon2("bn254_scalar", 2).hash_words(x)


def test_kernel_instantiations():
    """Which fields and widths the CUDA kernel takes: every single-word
    width, the 8-limb fields below 2^255 at t <= 8; not bw6_761 (12 limbs),
    whose plain version still runs on the CPU."""
    for fname in ("babybear", "koalabear", "m31"):
        assert all(PK.supported_on_cuda(Poseidon2(fname, t))
                   for t in TP.supported_arities(fname))
    for fname in ("bn254_scalar", "grumpkin_scalar", "bls12_377_scalar",
                  "bls12_381_scalar", "stark252"):
        assert all(PK.supported_on_cuda(Poseidon2(fname, t)) for t in (2, 3, 4, 8))
        assert get_field(fname).modulus < 1 << 255
    bw6 = Poseidon2("bw6_761_scalar", 2)
    assert not PK.supported_on_cuda(bw6)
    assert bw6.hash_fields(get_field("bw6_761_scalar").from_ints([[1, 2]], "cpu")).shape \
        == (1, 12)


def test_kernel_field_constants_layout():
    fp = get_field("babybear").params
    assert list(PK.field_consts("babybear")) == [fp.modulus, (1 << 32) % fp.modulus,
                                                 fp.inv32, 0, (1 << 64) % fp.modulus]
    bn = get_field("bn254_scalar").params
    c = list(PK.field_consts("bn254_scalar"))
    assert len(c) == 26 and c[16:18] == [bn.inv32, 0]
    assert sum(v << (32 * i) for i, v in enumerate(c[18:])) == (1 << 512) % bn.modulus


def test_unsupported_width_raises():
    with pytest.raises(ValueError, match="unsupported poseidon2 width"):
        Poseidon2("babybear", 5)


GOLDILOCKS_WIDTHS = [2, 3, 4, 8, 12]


@pytest.mark.parametrize("t", GOLDILOCKS_WIDTHS)
def test_goldilocks_matches_jax(t):
    """Goldilocks at every width the kernel is built for: the constants
    (plain values: the field has no Montgomery form), one permutation, the
    sponge and a domain tag, against the JAX package's hasher."""
    jh = _jax_hasher("goldilocks", t)
    c = Poseidon2("goldilocks", t).constants("cpu")
    for name in ("rc_full_top", "rc_partial", "rc_full_bot", "mds", "diag_m1"):
        assert np.array_equal(_u32(getattr(c, name)), np.asarray(getattr(jh, name))), name
    for n, seed in ((t, 800 + t), (2 * t + 1, 810 + t)):
        x = _elements("goldilocks", (3, n), seed=seed)
        got = Poseidon2("goldilocks", t).hash_fields(_t(x))
        assert got.shape == (3, 2)
        assert np.array_equal(_u32(got), np.asarray(jh.hash_fields(x))), n
    x = _elements("goldilocks", (2, t - 1), seed=820 + t)
    got = Poseidon2("goldilocks", t, domain_tag=77).hash_fields(_t(x))
    want = np.asarray(_jax_hasher("goldilocks", t, 77).hash_fields(x))
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("t", [4, 12])
def test_goldilocks_against_python_poseidon2(t):
    """No golden goldilocks vector is in the store (tests/golden/); the JAX
    tests' Python-int Poseidon2 (tests/test_poseidon2.py py_poseidon2), a
    third implementation, stands in for one, with 0 and p - 1 among the
    inputs."""
    from tests.test_poseidon2 import py_poseidon2
    jf = jax_field("goldilocks")
    rng = np.random.default_rng(830 + t)
    ins = [[int.from_bytes(rng.bytes(16), "little") % jf.modulus for _ in range(t)]
           for _ in range(3)]
    ins[0], ins[1] = [0] * t, [jf.modulus - 1] * t
    got = get_field("goldilocks").to_ints(
        Poseidon2("goldilocks", t).hash_fields(get_field("goldilocks").from_ints(ins, "cpu")))
    assert list(got) == [py_poseidon2(jf, t, row) for row in ins]


def test_goldilocks_kernel_instantiations():
    """Every width of goldilocks' constant file has an instance: t = 16,
    20 and 24 too (tests/test_torch_poseidon2_gl64_wide.py holds their
    plain version to the JAX package)."""
    for t in GOLDILOCKS_WIDTHS + [16, 20, 24]:
        assert PK.supported_on_cuda(Poseidon2("goldilocks", t)), t
    assert sorted(TP.supported_arities("goldilocks")) == list(PK.KERNEL_WIDTHS[2])
    assert PK.LIBRARY[2] == "poseidon2_gl64"
