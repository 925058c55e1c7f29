"""The port's Poseidon (icicle_tpu_torch/ops/hash/poseidon.py) against the
JAX package's `Poseidon`, the reference C++ backend's golden vectors and a
Python-int model of the rounds, on the CPU (the plain version; the CUDA
kernel is held against it on the card by chip_smoke.py). Inputs come from
numpy seeds; field elements are canonical, so the tolerance is exact
equality.

The single-word fields are held to JAX at every width; the 8-limb fields at
t = 3 and 5 in tests/test_torch_poseidon_limbs*.py. At t = 9 and 12 a JAX
8-limb hash takes minutes to compile on the CPU, so there the port is held
to `poseidon_model` (this file), which those files hold to JAX at t = 3 and
5."""

import functools
import os
import re

import numpy as np
import pytest
import torch

from icicle_tpu.fields.field import get_field as jax_field
from icicle_tpu.ops.hash import poseidon as JP
from icicle_tpu_torch import HashConfig, Poseidon, get_field
from icicle_tpu_torch.kernels import build
from icicle_tpu_torch.kernels import poseidon_kernel as PK
from icicle_tpu_torch.ops.hash import poseidon as TP
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException
from tests import ref_ffi

# Several pytest workers share the cores; torch's intra-op threads would
# oversubscribe them.
torch.set_num_threads(1)

WORD_FIELDS = ["babybear", "koalabear", "m31"]
LIMB_FIELDS = ["bn254_scalar", "grumpkin_scalar", "bls12_377_scalar", "bls12_381_scalar",
               "stark252"]
WIDTHS = [3, 5, 9, 12]
TAG = 0x1234567


# -- the Python-int model ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model_constants(fname: str, t: int):
    """(p, half, partial, rc, mds, pre, sparse) as canonical ints, read from
    the port's copy of the constant file."""
    path = os.path.join(os.path.dirname(TP.__file__), "data", f"poseidon_{fname}.npz")
    with np.load(path) as data:
        _, half, partial, _ = (int(v) for v in data[f"t{t}_meta"])
        rows = {k: [sum(int(w) << (32 * i) for i, w in enumerate(row))
                    for row in np.asarray(data[f"t{t}_{k}"], dtype=np.uint64)]
                for k in ("rc", "mds", "pre", "sparse")}
    mat = lambda v: [v[r * t:(r + 1) * t] for r in range(t)]  # noqa: E731
    sparse = [rows["sparse"][i * (2 * t - 1):(i + 1) * (2 * t - 1)] for i in range(partial)]
    return (jax_field(fname).modulus, half, partial, rows["rc"], mat(rows["mds"]),
            mat(rows["pre"]), sparse)


def poseidon_model(fname: str, t: int, inputs: list, domain_tag=None) -> int:
    """One Poseidon digest on canonical Python ints: the rounds of
    cpu_poseidon.cpp in the plain (not Montgomery) domain, which a
    Montgomery-form computation mirrors value for value."""
    p, half, partial, rc, mds, pre, sparse = _model_constants(fname, t)
    s = ([domain_tag % p] if domain_tag is not None else []) + [int(v) % p for v in inputs]
    assert len(s) == t
    matmul = lambda s, m: [sum(s[r] * m[r][c] for r in range(t)) % p for c in range(t)]  # noqa
    s = [(v + rc[j]) % p for j, v in enumerate(s)]
    o = t
    for mat in [mds] * (half - 1) + [pre]:
        s = matmul([(pow(v, 5, p) + rc[o + j]) % p for j, v in enumerate(s)], mat)
        o += t
    for i in range(partial):
        s0 = (pow(s[0], 5, p) + rc[o + i]) % p
        sp = sparse[i]
        s = [(s0 * sp[0] + sum(s[j] * sp[j] for j in range(1, t))) % p] + \
            [(s0 * sp[t + j - 1] + s[j]) % p for j in range(1, t)]
    o += partial
    for _ in range(half - 1):
        s = matmul([(pow(v, 5, p) + rc[o + j]) % p for j, v in enumerate(s)], mds)
        o += t
    return matmul([pow(v, 5, p) for v in s], mds)[1]


# -- helpers --------------------------------------------------------------------------

def elements(fname: str, shape, seed: int) -> np.ndarray:
    """Canonical elements from a seed, 0 and p - 1 first and last, as
    (shape) uint32 or (shape)+(L,) limbs."""
    f = get_field(fname)
    rng = np.random.default_rng(seed)
    vals = np.array([int.from_bytes(rng.bytes(40), "little") % f.modulus
                     for _ in range(int(np.prod(shape)))], dtype=object).reshape(shape)
    vals.flat[0], vals.flat[-1] = 0, f.modulus - 1
    return f.from_ints(vals, device="cpu").numpy().view(np.uint32)


@functools.lru_cache(maxsize=None)
def jax_hasher(fname: str, t: int, domain_tag=None):
    """One JAX hasher per (field, width, tag): its jitted hash compiles once."""
    return JP.Poseidon(jax_field(fname), t, domain_tag=domain_tag)


def tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def as_ints(fname: str, a: np.ndarray) -> list:
    """uint32 elements (limbs last for a multi-limb field) -> Python ints."""
    if get_field(fname).nlimbs == 1:
        return [int(v) for v in a.reshape(-1)]
    return [sum(int(w) << (32 * i) for i, w in enumerate(row))
            for row in a.reshape(-1, a.shape[-1])]


def check_against_jax(fname: str, t: int, domain_tag, seed: int, batch: int = 4) -> np.ndarray:
    """The port's hash_fields (and, with a tag, hash_words) equal JAX's on the
    same inputs; returns the inputs and the digests as uint32."""
    h = Poseidon(fname, t, domain_tag=domain_tag)
    lim = get_field(fname).limb_shape
    x = elements(fname, (batch, h.arity), seed)
    jh = jax_hasher(fname, t, domain_tag)
    if domain_tag is None:
        want = np.asarray(jh.hash_fields(x)).astype(np.uint32)
        got = u32(h.hash_fields(tensor(x)))
    else:
        words = x.reshape(batch, -1)
        want = np.asarray(jh.hash_words(words)).astype(np.uint32)
        got = u32(h.hash_words(tensor(words)))
        want = want.reshape((batch,) + lim)
        got = got.reshape((batch,) + lim)
    assert got.shape == want.shape and np.array_equal(got, want), (fname, t, domain_tag)
    return x, got


# -- the constants --------------------------------------------------------------------

def test_data_files_are_the_jax_packages():
    src = os.path.join(os.path.dirname(JP.__file__), "data")
    dst = os.path.join(os.path.dirname(TP.__file__), "data")
    names = sorted(f for f in os.listdir(src) if f.startswith("poseidon_"))
    assert names == sorted(f for f in os.listdir(dst) if f.startswith("poseidon_"))
    assert len(names) == 9
    for name in names:
        with np.load(os.path.join(src, name)) as a, np.load(os.path.join(dst, name)) as b:
            assert sorted(a.files) == sorted(b.files), name
            for key in a.files:
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), \
                    (name, key)


def test_supported_widths():
    for fname in WORD_FIELDS + LIMB_FIELDS + ["bw6_761_scalar"]:
        assert TP.supported_widths(fname) == WIDTHS == JP.supported_widths(fname)


@pytest.mark.parametrize("fname,t", [(f, t) for f in WORD_FIELDS for t in WIDTHS]
                         + [("bn254_scalar", 3), ("bls12_381_scalar", 12)])
def test_montgomery_constants_equal_jax(fname, t):
    jh = JP.Poseidon(jax_field(fname), t, domain_tag=TAG)
    h = Poseidon(fname, t, domain_tag=TAG)
    c = h.constants("cpu")
    for name in ("rc_pre", "rc_full_top", "rc_pre_matrix", "rc_partial", "rc_full_bot", "mds",
                 "pre_matrix", "sparse"):
        want = np.asarray(getattr(jh, name)).astype(np.uint32)
        got = u32(getattr(c, name))
        assert got.shape == want.shape and np.array_equal(got, want), name
    assert np.array_equal(u32(h.tag_mont("cpu")), np.asarray(jh.domain_tag_mont).astype(np.uint32))


def _kernel_table(source: str, macro: str) -> list[tuple]:
    text = open(os.path.join(build.CSRC, source)).read()
    body = text[text.index(f"#define {macro}(X)"):]
    body = body[:body.index("\n\n")]
    return [tuple(a.strip() for a in m.split(",")) for m in re.findall(r"X\(([^)]*)\)", body)]


def test_kernel_tables_match_the_constant_files():
    """poseidon.cu's POSEIDON_WORDS and poseidon_limbs.cu's POSEIDON_LIMBS
    instantiate exactly the round counts of the constant files, and every
    file's alpha is 5 (the kernel's x^5)."""
    words = {(f, int(p, 16), int(t), int(h), int(r))
             for f, p, t, h, r in ((a[0], a[1].rstrip("u"), *a[2:]) for a in
                                   _kernel_table("poseidon.cu", "POSEIDON_WORDS"))}
    limbs = {tuple(int(v) for v in a) for a in _kernel_table("poseidon_limbs.cu",
                                                                 "POSEIDON_LIMBS")}
    want_words, want_limbs = set(), set()
    for fname in WORD_FIELDS + LIMB_FIELDS:
        for t in WIDTHS:
            h = Poseidon(fname, t)
            assert h.alpha == PK.ALPHA and h.full == 2 * h.half, (fname, t)
            if fname in WORD_FIELDS:
                want_words.add((fname, get_field(fname).modulus, t, h.half, h.partial))
            else:
                want_limbs.add((t, h.half, h.partial))
    assert words == want_words
    assert limbs == want_limbs


def test_needed_monts():
    h = Poseidon("bls12_381_scalar", 9, domain_tag=0)
    assert PK.needed_monts(h) == 7 * (27 + 81) + 57 * (3 + 17) + 27 + 9 + 9 == 1941
    h = Poseidon("babybear", 3)   # 11 full rounds: 9 + 9 each; 7 partial: 3 + 5
    assert PK.needed_monts(h) == 11 * 18 + 7 * 8 + 9 + 3 + 3 + 1


# -- against the JAX package ----------------------------------------------------------

@pytest.mark.parametrize("tag", [None, TAG])
@pytest.mark.parametrize("t", WIDTHS)
@pytest.mark.parametrize("fname", WORD_FIELDS)
def test_single_word_equals_jax(fname, t, tag):
    check_against_jax(fname, t, tag, seed=100 * t + (tag is not None), batch=6)


@pytest.mark.parametrize("tag", [None, TAG])
@pytest.mark.parametrize("t", [9, 12])
@pytest.mark.parametrize("fname", LIMB_FIELDS)
def test_limbs_wide_equal_the_model(fname, t, tag):
    """8-limb fields at t = 9 and 12 (JAX compiles them for minutes here)."""
    h = Poseidon(fname, t, domain_tag=tag)
    x = elements(fname, (2, h.arity), seed=7 * t + (tag is not None))
    got = as_ints(fname, u32(h.hash_fields(tensor(x))))
    want = [poseidon_model(fname, t, as_ints(fname, row), tag) for row in x]
    assert got == want


def test_model_equals_jax_single_word():
    for fname, t, tag in (("babybear", 9, None), ("m31", 12, TAG)):
        x, got = check_against_jax(fname, t, tag, seed=5)
        assert as_ints(fname, got) == [poseidon_model(fname, t, as_ints(fname, row), tag)
                                       for row in x]


# -- the reference C++ backend's golden vectors ----------------------------------------
# tests/test_poseidon.py:52-71's calls, replayed through tests/ref_ffi on the same
# inputs: the `rng` fixture's seed and draws are that file's.

@pytest.mark.parametrize("t", WIDTHS)
def test_golden_babybear(t, rng):
    ins = get_field("babybear").rand(rng, (8, t), device="cpu").numpy().view(np.uint32)
    want = ref_ffi.poseidon_hash("babybear", t, ins.view(np.uint8))
    got = u32(Poseidon("babybear", t).hash_fields(tensor(ins)))
    assert np.array_equal(got.view(np.uint8).reshape(want.shape), want)


def test_golden_babybear_domain_tag(rng):
    t, tag = 3, 1234567
    ins = get_field("babybear").rand(rng, (4, t - 1), device="cpu").numpy().view(np.uint32)
    tag_bytes = np.array([tag], dtype=np.uint32).view(np.uint8)
    want = ref_ffi.poseidon_hash("babybear", t, ins.view(np.uint8), domain_tag=tag_bytes)
    got = u32(Poseidon("babybear", t, domain_tag=tag).hash_fields(tensor(ins)))
    assert np.array_equal(got.view(np.uint8).reshape(want.shape), want)


# -- the API and its errors -----------------------------------------------------------

@pytest.mark.parametrize("backend", [None, "torch", "cuda"])
def test_backends_on_a_cpu_tensor_compute_the_plain_version(backend):
    h = Poseidon("koalabear", 5, domain_tag=3)
    x = tensor(elements("koalabear", (3, 4), seed=11))
    launches = PK.poseidon.launches
    got = h.hash_fields(x, HashConfig(backend=backend))
    assert torch.equal(got, h.hash_fields_ref(x))
    assert PK.poseidon.launches == launches


def test_hash_words_shapes():
    h = Poseidon("bn254_scalar", 3, domain_tag=1)
    assert (h.digest_words, h.default_input_words, h.arity) == (8, 16, 2)
    x = tensor(elements("bn254_scalar", (2, 2), seed=12))
    assert torch.equal(h.hash_words(x.reshape(2, 16)), h.hash_fields(x))
    assert TP.create_poseidon("babybear", 5).default_input_words == 5


def test_errors():
    with pytest.raises(ValueError):
        Poseidon("babybear", 4)
    h = Poseidon("babybear", 3, domain_tag=1)
    for n in (1, 3):      # arity 2: no sponge
        with pytest.raises(IcicleException) as e:
            h.hash_fields(tensor(elements("babybear", (2, n), seed=n)))
        assert e.value.code == IcicleError.INVALID_ARGUMENT
    with pytest.raises(IcicleException):
        h.hash_fields(torch.zeros((2, 2), dtype=torch.int64))
    with pytest.raises(IcicleException):
        h.hash_words(torch.zeros((2, 2, 1), dtype=torch.int32))


def test_bw6_761_has_no_cuda_instance():
    """bw6_761_scalar (12 limbs) computes on a CPU tensor and raises before
    a launch on a CUDA one (`require_instance`, the wrapper's first check
    there), as every width of the kernel's fields passes it."""
    h = Poseidon("bw6_761_scalar", 3)
    x = tensor(elements("bw6_761_scalar", (1, 3), seed=13))
    assert h.hash_fields(x).shape == (1, 12)
    with pytest.raises(IcicleException) as e:
        PK.require_instance(h)
    assert e.value.code == IcicleError.API_NOT_IMPLEMENTED and "item 6" in str(e.value)
    for fname in WORD_FIELDS + LIMB_FIELDS:
        for t in WIDTHS:
            PK.require_instance(Poseidon(fname, t))
    h = Poseidon("babybear", 3)
    h.alpha = 7
    with pytest.raises(IcicleException) as e:
        PK.require_instance(h)
    assert e.value.code == IcicleError.API_NOT_IMPLEMENTED
