"""Precomputed MSM bases over a hand-written CUDA kernel (counterpart of the
XLA body of icicle_tpu/ops/msm.py `msm_precompute_bases`).

`precompute_bases` runs kernels/csrc/precompute_bases.cu, which replaces no
Pallas kernel: the JAX package computes this in XLA (`chunk_fn`,
icicle_tpu/ops/msm.py:313). For each canonical affine point P_i ((0, 0)
is the identity) and copy j < nu, row nu i + j of the output is
2^(j shift) P_i in canonical affine coordinates, (0, 0) for the identity.
`precompute_bases_ref` is the same function in plain torch: the port's
`Group.dbl` chain and `to_affine_canonical`. A canonical affine point is
unique, so the two agree bit for bit.

Layout: px, py (n, W) int32 canonical words; out (nu n, W) each; W words a
coordinate (L limbs over Fp; 2L over Fp2 for G2, c0 then c1, where the
kernel inverts through the norm in Fp). `curve` is a curve name, a `Curve`
(its G1) or a `Group` (G2: `get_group(name, g2=True)`). The kernel doubles
in Jacobian coordinates and inverts every copy's Z with one Fermat power a
block (Montgomery's batch inversion); for nu > 2 the wrapper gives it
`scratch_words` of scratch for the copies' Z and running products, and
launches it over chunks of points (`chunks`) so that the scratch stays
within SCRATCH_MAX_WORDS (1 GiB) beside the (nu n, W) outputs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icicle_tpu_torch.curves.group import Group, Projective
from icicle_tpu_torch.kernels import msm_lib
from icicle_tpu_torch.math.params import limbs_of


BLOCK_THREADS = 128  # precompute_bases.cu kThreads: points a block, one Fermat power a block
SCRATCH_MAX_WORDS = 1 << 28   # a launch's scratch, at most


def _check(px: torch.Tensor, py: torch.Tensor, nl: int, nu: int, shift: int) -> None:
    for t in (px, py):
        msm_lib.check_aux("precompute_bases", t, (px.shape[0], nl), px)
    if px.shape[0] < 1:
        raise msm_lib.invalid("precompute_bases", "expected at least one point")
    if not (isinstance(nu, int) and nu >= 1 and isinstance(shift, int) and shift >= 0):
        raise msm_lib.invalid("precompute_bases", f"need nu >= 1 and shift >= 0, got "
                              f"nu {nu!r}, shift {shift!r}")


@functools.lru_cache(maxsize=None)
def kernel_consts(group: Group):
    """The group's ec_field.cuh consts (msm_lib.consts_values), then R^2 mod
    p, p - 2 and the bit count of p - 2 (the Fermat exponent) of its base
    field, as a host uint32 array."""
    fp = group.curve.fq.params
    e = fp.modulus - 2
    values = (msm_lib.consts_values(group) + limbs_of(fp.r2, fp.nlimbs)
              + limbs_of(e, fp.nlimbs) + [e.bit_length()])
    return (ctypes.c_uint32 * len(values))(*values)


def scratch_words(n: int, nu: int, nl: int) -> int:
    """The kernel's scratch: each copy but the first and the last keeps its
    Z and the product of the Z before it (nl words each) for every point."""
    return max(nu - 2, 0) * 2 * nl * n


def chunks(n: int, nu: int, nl: int) -> list[tuple[int, int]]:
    """The launches' points [a, b): as few as keep each launch's scratch
    within SCRATCH_MAX_WORDS, each but the last a whole number of blocks
    (so every block inverts the points it would in one launch). The
    output rows of points [a, b) are rows [nu a, nu b)."""
    per_point = scratch_words(1, nu, nl)
    if per_point == 0 or per_point * n <= SCRATCH_MAX_WORDS:
        return [(0, n)]
    step = max(SCRATCH_MAX_WORDS // per_point // BLOCK_THREADS, 1) * BLOCK_THREADS
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def precompute_bases(curve, px: torch.Tensor, py: torch.Tensor, nu: int, shift: int):
    """(n, W) int32 canonical affine coordinates -> (ox, oy), (nu n, W) each:
    row nu i + j is 2^(j shift) (px[i], py[i]), canonical affine.

    On a CUDA tensor this launches the kernel on the current stream (no
    synchronisation), counts the launch in `precompute_bases.launches` and
    raises if the launch is refused or the group has no instance; one
    launch a chunk of points (`chunks`: one up to 2^28 scratch words, bn254
    2^22 points at nu 4 among them). On a CPU tensor it computes
    `precompute_bases_ref`."""
    group = msm_lib.as_group(curve)
    nl = group.nlimbs
    _check(px, py, nl, nu, shift)
    if not px.is_cuda:
        return precompute_bases_ref(group, px, py, nu, shift)
    n = px.shape[0]
    ox = torch.empty((nu * n, nl), dtype=torch.int32, device=px.device)
    oy = torch.empty_like(ox)
    parts = chunks(n, nu, nl)
    scratch = torch.empty(scratch_words(parts[0][1], nu, nl), dtype=torch.int32,
                          device=px.device)
    for a, b in parts:
        msm_lib.launch("precompute_bases", group,
                       [px[a:b], py[a:b], ox[nu * a:nu * b], oy[nu * a:nu * b], scratch],
                       [b - a, nu, shift], kernel_consts(group))
        precompute_bases.launches += 1
    return ox, oy


precompute_bases.launches = 0


def precompute_bases_ref(curve, px: torch.Tensor, py: torch.Tensor, nu: int, shift: int):
    """`precompute_bases` in plain torch: each copy `shift` doublings of the
    last (Group.dbl), then one `to_affine_canonical` over all copies."""
    g = msm_lib.as_group(curve)
    nl = g.nlimbs
    _check(px, py, nl, nu, shift)
    n = px.shape[0]
    cur = g.from_affine_canonical(px, py)
    copies = []
    for _ in range(1, nu):
        for _ in range(shift):
            cur = g.dbl(cur)
        copies.append(cur)
    ox, oy = [px], [py]
    if copies:
        x, y = g.to_affine_canonical(Projective(*(torch.stack(t) for t in zip(*copies))))
        ox += list(x)
        oy += list(y)
    # (nu, n, L) -> row nu i + j
    return (torch.stack(ox, 1).reshape(nu * n, nl).contiguous(),
            torch.stack(oy, 1).reshape(nu * n, nl).contiguous())
