"""The lattice ops on the port (icicle_tpu_torch/ops/lattice.py) against the
JAX package's (icicle_tpu/ops/lattice.py) on the same seeded inputs, at the
sizes of tests/test_lattice.py: digits, JL rows and projections, sampled
elements and challenge polynomials byte for byte (tolerance 0), norm
checks as the same booleans. The port's seed expansions call the same host
Keccak-512 (native/host_crypto.cpp) through its own loader."""

import math

import numpy as np
import pytest
import torch

import icicle_tpu.ops.lattice as J
from icicle_tpu.rings.babykoala import get_zq as jget_zq
from icicle_tpu_torch.ops import lattice as L
from icicle_tpu_torch.rings.babykoala import Q, RQ_DEGREE, get_zq
from icicle_tpu_torch.runtime import device


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))


def rand_vals(rng, n, bound=None):
    bound = bound or Q
    return [int.from_bytes(rng.bytes(8), "little") % bound for _ in range(n)]


def both(vals):
    return get_zq().from_ints(vals), jget_zq().from_ints(vals)


def same(t: torch.Tensor, j) -> bool:
    return t.shape == tuple(np.shape(j)) and np.array_equal(t.numpy().view(np.uint32),
                                                            np.asarray(j))


@pytest.mark.parametrize("base", [2, 4, 16, 1 << 16, 1 << 20])
def test_decompose_recompose_equal_jax(base):
    rng = np.random.default_rng(base)
    vals = rand_vals(rng, 64) + [0, 1, Q - 1, Q // 2, Q // 2 + 1]
    x, jx = both(vals)
    assert L.compute_nof_digits(base) == J.compute_nof_digits(base)
    digits = L.decompose_balanced(x, base)
    assert same(digits, J.decompose_balanced(jx, base))
    back = L.recompose_balanced(digits, base, len(vals))
    assert same(back, J.recompose_balanced(np.asarray(J.decompose_balanced(jx, base)), base,
                                           len(vals)))
    assert list(get_zq().to_ints(back)) == vals
    short = L.decompose_balanced(x, base, 2)          # fewer digits than the value needs
    assert same(short, J.decompose_balanced(jx, base, 2))
    with pytest.raises(ValueError):
        L.decompose_balanced(x, 1)


def test_jl_projection_and_rows_equal_jax():
    rng = np.random.default_rng(7)
    n, m = 300, 8                                       # two hashes a row, the second partial
    vals = rand_vals(rng, n)
    x, jx = both(vals)
    seed = b"jl-seed"
    proj = L.jl_projection(x, seed, m)
    assert same(proj, J.jl_projection(jx, seed, m))
    rows = L.get_jl_matrix_rows(seed, n, 3, m)
    assert same(rows, J.get_jl_matrix_rows(seed, n, 3, m))
    rows0 = get_zq().to_ints(L.get_jl_matrix_rows(seed, n, 0, m))
    got = get_zq().to_ints(proj)
    for r in range(m):
        assert got[r] == sum(int(rows0[r][i]) * vals[i] for i in range(n)) % Q


def test_jl_projection_exact_at_large_sums():
    """Entries near q over many columns: the port's 21-bit pieces against
    Python ints (a single int64 sum would overflow)."""
    n = 4096
    vals = [Q - 1 - i for i in range(n)]
    x, jx = both(vals)
    assert same(L.jl_projection(x, b"big", 3), J.jl_projection(jx, b"big", 3))


def test_jl_conjugated_rows_equal_jax():
    seed = b"conj"
    for size in (RQ_DEGREE, 3 * RQ_DEGREE):
        got = L.get_jl_matrix_rows(seed, size, 2, 2, negacyclic_conjugate=True)
        assert same(got, J.get_jl_matrix_rows(seed, size, 2, 2, negacyclic_conjugate=True))


def test_norm_checks_equal_jax():
    rng = np.random.default_rng(9)
    small = [int(v) for v in rng.integers(0, 1000, size=32)] + [Q - 5, Q - 999]
    x, jx = both(small)
    sq = sum(min(v, Q - v) ** 2 for v in small)
    for norm in (L.NormType.L2, L.NormType.LInfinity):
        for bound in (1, 999, 1000, math.isqrt(sq), math.isqrt(sq) + 1, 10 ** 6):
            assert L.check_norm_bound(x, norm, bound) == J.check_norm_bound(jx, norm, bound)
    y, jy = both([2] * 34)
    for norm in (L.NormType.L2, L.NormType.LInfinity):
        for scale in (1, 2, 1000):
            assert (L.check_norm_relative(y, x, norm, scale)
                    == J.check_norm_relative(jy, jx, norm, scale))
    big, jbig = both([math.isqrt(Q)])
    for fn, jfn in ((L.check_norm_bound, J.check_norm_bound),):
        with pytest.raises(ValueError):
            fn(big, L.NormType.L2, 10)
        with pytest.raises(ValueError):
            jfn(jbig, J.NormType.L2, 10)


def test_sum_of_squares_exact_near_sqrt_q():
    """Entries just below sqrt(q): each square near 2^62, their sum past
    2^63, held to Python ints."""
    r = math.isqrt(Q) - 1
    vals = [r - i for i in range(64)] + [Q - r]
    x, jx = both(vals)
    sq = sum(min(v, Q - v) ** 2 for v in vals)
    assert L._sum_squares(L._centered(x)) == sq
    for bound in (math.isqrt(sq), math.isqrt(sq) + 1):
        assert (L.check_norm_bound(x, L.NormType.L2, bound)
                == J.check_norm_bound(jx, J.NormType.L2, bound))


@pytest.mark.parametrize("fast", [True, False])
def test_random_sampling_equal_jax(fast):
    for size, batch in ((100, 1), (37, 2)):
        got = L.random_sampling(size, fast, b"seed-1", batch)
        assert same(got, J.random_sampling(size, fast, b"seed-1", batch))
    assert not torch.equal(L.random_sampling(100, fast, b"seed-2"),
                           L.random_sampling(100, fast, b"seed-1"))


def test_challenge_space_polynomials_equal_jax():
    ones, twos = 23, 10
    got = L.challenge_space_polynomials(b"chal", 4, ones, twos)
    assert same(got, J.challenge_space_polynomials(b"chal", 4, ones, twos))
    bounded = L.challenge_space_polynomials(b"chal", 2, ones, twos, norm_bound=40)
    assert same(bounded, J.challenge_space_polynomials(b"chal", 2, ones, twos, norm_bound=40))
    for p in get_zq().to_ints(bounded):
        balanced = [int(v) if int(v) <= 2 else int(v) - Q for v in p]
        assert L.operator_norm(balanced) == J.operator_norm(balanced) <= 40
    with pytest.raises(ValueError):
        L.challenge_space_polynomials(b"chal", 1, 40, 30)
