"""Carrying the JAX package's state across to the port.

The JAX package (icicle_tpu) keeps field elements as uint32 arrays; the port
keeps them as int32 tensors holding the same bits: a single-limb element's
canonical value (< 2^31, never negative), a goldilocks element's (..., 2)
words [lo, hi] and a multi-limb element's (..., L) little-endian uint32
limbs, where a word >= 2^31 reads as negative in int32.
`.view(np.int32)` and back is exact both ways. Extension elements are flat
(..., D * B) words, the D components one after the other (fields/
extension.py), and G2 affine points over Fp2 are x.c0, x.c1, y.c0, y.c1
of L limbs each; projective G1 points (the ECNTT's) three (..., L) limb
arrays x, y, z in Montgomery form; babykoala Z_q elements (..., 2) words,
direct [lo, hi] or RNS residues, R_q polynomials (..., 64, 2). These
functions take numpy
arrays and give numpy arrays or the port's objects: the port imports nothing of JAX, and a caller that holds
a jax.Array passes `np.asarray(array)`.
"""

from __future__ import annotations

import numpy as np
import torch

from icicle_tpu_torch.curves.group import Projective, get_group
from icicle_tpu_torch.curves.params import get_curve
from icicle_tpu_torch.fields.extension import ExtField
from icicle_tpu_torch.fields.field import Field
from icicle_tpu_torch.kernels.msm_scan_r12 import r12_engine
from icicle_tpu_torch.math.radix12 import Radix12
from icicle_tpu_torch.ops.merkle import MerkleTree
from icicle_tpu_torch.ops.msm import signed_table
from icicle_tpu_torch.ops.msm_tpu3 import ENGINES
from icicle_tpu_torch.ops.ntt import NttDomain
from icicle_tpu_torch.polynomials.polynomial import Polynomial
from icicle_tpu_torch.runtime.device import resolve
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException


def _below_modulus(f: Field, a: np.ndarray) -> bool:
    """Every element of a uint32 array (multi-limb: (..., L)) is < p, compared
    as integers: limb by limb from the top, the first limb that differs from
    p's decides."""
    if f.limb_shape == ():
        return not a.size or int(a.max()) < f.modulus
    less = np.zeros(a.shape[:-1], dtype=bool)
    equal = np.ones(a.shape[:-1], dtype=bool)
    for limb, p_limb in reversed(list(zip(np.moveaxis(a, -1, 0), f.params.p_limbs32()))):
        less |= equal & (limb < p_limb)
        equal &= limb == p_limb
    return bool(less.all())


def elements_from_numpy(f: Field, arr_u32, device=None) -> torch.Tensor:
    """uint32 element array (canonical, < p; goldilocks (..., 2) words,
    multi-limb fields (..., L) limbs) -> int32 element tensor with the same
    bits."""
    a = np.asarray(arr_u32)
    if a.dtype != np.uint32:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"expected a uint32 element array, got {a.dtype}")
    if f.limb_shape and (a.ndim == 0 or a.shape[-1] != f.nlimbs):
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"{f.name}: expected (..., {f.nlimbs}) limbs, got {a.shape}")
    if not _below_modulus(f, a):
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"element >= {f.name} modulus: not canonical")
    return torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(resolve(device))


def elements_to_numpy(f, t: torch.Tensor) -> np.ndarray:
    """int32 element tensor -> uint32 element array with the same bits (a
    `Field`'s or an `ExtField`'s)."""
    return t.cpu().numpy().view(np.uint32)


def _ext_canonical(ef, a: np.ndarray) -> bool:
    """Every component of the flat (..., D*B) uint32 array `a` is canonical
    in its base field (recursively for towers)."""
    b = ef.engine.base_width
    for i in range(ef.degree):
        comp = a[..., i] if ef.engine.base_flat else a[..., i * b:(i + 1) * b]
        if not (_ext_canonical(ef.base, comp) if isinstance(ef.base, ExtField)
                else _below_modulus(ef.base, comp)):
            return False
    return True


def ext_elements_from_numpy(ef: ExtField, arr_u32, device=None) -> torch.Tensor:
    """uint32 extension-field array in the JAX package's flat layout
    (..., D * B), every component canonical -> int32 tensor with the same
    bits."""
    a = np.asarray(arr_u32)
    if a.dtype != np.uint32:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"expected a uint32 element array, got {a.dtype}")
    if a.ndim == 0 or a.shape[-1] != ef.nlimbs:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"{ef.name}: expected (..., {ef.nlimbs}) words, got {a.shape}")
    if not _ext_canonical(ef, a):
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"{ef.name}: a component is not canonical")
    return torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(resolve(device))


def g2_affine_from_numpy(curve_name: str, q_u32, device=None):
    """G2 affine points as uint32 words (..., 2W): x then y, each W words of
    the G2 coordinate field (over Fp2: x.c0, x.c1, y.c0, y.c1 of L limbs, the
    layout of the JAX package's G2 arrays and of the reference's pairing
    ABI; bw6_761's G2, over Fq: x, y of L limbs) -> (x, y) int32 tensors,
    (..., W) each, for `msm(..., MSMConfig(g2=True))`."""
    f = get_group(curve_name, g2=True).coord_field
    a = np.asarray(q_u32)
    if a.ndim == 0 or a.shape[-1] != 2 * f.nlimbs:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"{curve_name} G2: expected (..., {2 * f.nlimbs}) words, "
                              f"got {a.shape}")
    load = ext_elements_from_numpy if isinstance(f, ExtField) else elements_from_numpy
    return (load(f, a[..., :f.nlimbs], device), load(f, a[..., f.nlimbs:], device))


def g2_affine_to_numpy(curve_name: str, x: torch.Tensor, y: torch.Tensor) -> np.ndarray:
    """(x, y) G2 coordinate tensors -> the (..., 2W) uint32 words of
    `g2_affine_from_numpy`."""
    get_group(curve_name, g2=True)                   # the curve has a G2
    return np.concatenate([x.cpu().numpy(), y.cpu().numpy()], -1).view(np.uint32)


def projective_from_numpy(curve_name: str, x_u32, y_u32, z_u32, device=None) -> Projective:
    """A JAX `Projective` of G1 points (x, y, z: (..., L) uint32 Montgomery-
    form limbs, each canonical; pass `np.asarray(p.x)` and so on) -> the
    port's Projective on `device`, the ECNTT's input."""
    fq = get_curve(curve_name).fq
    return Projective(*(elements_from_numpy(fq, c, device) for c in (x_u32, y_u32, z_u32)))


def projective_to_numpy(p: Projective) -> tuple:
    """The port's Projective -> (x, y, z) uint32 limb arrays, a JAX
    `Projective`'s fields."""
    return tuple(c.cpu().numpy().view(np.uint32) for c in p)


def zq_from_numpy(arr_u32, rns: bool = False, device=None) -> torch.Tensor:
    """The JAX package's babykoala Z_q elements, (..., 2) uint32 -> int32
    tensor with the same bits: direct limbs [lo, hi] of a value below q, or
    with `rns` the residues (x mod P_bb, x mod P_kb), each canonical. An
    R_q batch is the same with a coefficient axis of 64 before the limbs
    (`rq_from_numpy`)."""
    from icicle_tpu_torch.rings.babykoala import P_BB, P_KB, get_zq
    a = np.asarray(arr_u32)
    if a.dtype != np.uint32 or a.ndim == 0 or a.shape[-1] != 2:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"expected (..., 2) uint32 Z_q words, got {a.dtype} {a.shape}")
    if rns:
        if a.size and (int(a[..., 0].max()) >= P_BB or int(a[..., 1].max()) >= P_KB):
            raise IcicleException(IcicleError.INVALID_ARGUMENT, "RNS residue not canonical")
        return torch.from_numpy(a.view(np.int32).copy()).to(resolve(device))
    return elements_from_numpy(get_zq(), a, device)


def rq_from_numpy(arr_u32, rns: bool = False, device=None) -> torch.Tensor:
    """The JAX package's R_q polynomials, (..., 64, 2) uint32 (direct, or
    RNS with `rns`) -> the port's int32 tensor (`zq_from_numpy`)."""
    from icicle_tpu_torch.rings.babykoala import RQ_DEGREE
    a = np.asarray(arr_u32)
    if a.ndim < 2 or a.shape[-2] != RQ_DEGREE:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"expected (..., {RQ_DEGREE}, 2) R_q words, got {a.shape}")
    return zq_from_numpy(a, rns, device)


def prepared_from_numpy(curve_name: str, prepared: dict, device=None) -> dict:
    """The JAX package's `msm_tpu3_prepare` result -> the port's prepared
    bases on `device`, for `msm_tpu3(prepared=...)`.

    `prepared` holds the plan (c, T, tiles, wg, engine, nu, glv, ...) and
    `pts_u8`, the (tiles, T, 8L) int8 Montgomery byte planes of x || y
    (little-endian bytes of each uint32 limb,
    icicle_tpu/ops/msm_tpu3.py:446-457); pass `np.asarray(prepared["pts_u8"])`
    or the jax.Array itself. The limbs are in the plan's engine's domain
    (R = 2^(32 L) for "u32", R' = 2^(12 nw) for "r12") and carry over as they
    are, with the engine: the bases of precomputed copies (nu > 1) and of
    GLV's [P, phi(P)] (glv=True) too. Where the port's radix-12 engine takes
    more words than the JAX package's (grumpkin, bls12_381:
    kernels/msm_scan_r12.py r12_engine), "r12" bases are moved into its R'
    by one multiply."""
    if prepared["engine"] not in ENGINES:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"prepared_from_numpy: unknown engine {prepared['engine']!r}")
    planes = np.ascontiguousarray(np.asarray(prepared["pts_u8"])).view(np.uint8)
    tiles, T, nbytes = planes.shape
    limbs = planes.reshape(tiles * T, nbytes).view("<u4").astype(np.uint32)
    plan = {k: prepared[k] for k in ("engine", "nbits", "c", "M", "T", "tiles",
                                     "n_windows", "wg", "n_pad", "nu")}
    plan["glv"] = bool(prepared.get("glv", False))
    plan["g2"] = False                                # the JAX pipeline's bases are G1
    xy = torch.from_numpy(limbs.view(np.int32)).to(resolve(device))
    fq = get_curve(curve_name).fq
    shift = (r12_engine(curve_name).rbits - Radix12(fq.modulus).rbits
             if plan["engine"] == "r12" else 0)
    if shift:
        # x 2^shift mod p: a Montgomery multiply by 2^shift R mod p
        lift = fq.from_ints([(1 << (shift + 32 * fq.nlimbs)) % fq.modulus], xy.device)
        xy = fq.mul_mont(xy.reshape(-1, fq.nlimbs), lift).reshape(xy.shape)
    return dict(plan, pts=signed_table(fq, xy), n=prepared["n"])


def domain_from_numpy(f: Field, logn: int, twiddles_u32, twiddles_inv_u32,
                      device=None) -> NttDomain:
    """The JAX package's NttDomain tables (w^0..w^(n/2-1) in Montgomery form,
    forward and inverse; plain values for goldilocks, which has no
    Montgomery form, in both packages) -> the port's NttDomain on
    `device`."""
    w = f.omega(logn)
    return NttDomain(f, logn, w, pow(w, -1, f.modulus),
                     elements_from_numpy(f, twiddles_u32, device),
                     elements_from_numpy(f, twiddles_inv_u32, device))


def polynomial_from_numpy(f: Field, coeffs_u32, size: int, device=None) -> Polynomial:
    """A JAX `Polynomial`'s state -> the port's Polynomial on `device`:
    `coeffs_u32` its `coeffs` ((cap,)+limbs uint32, canonical, padding
    included) and `size` its `size`."""
    return Polynomial(f, elements_from_numpy(f, coeffs_u32, device), int(size))


def merkle_tree_from_numpy(layer_hashes, leaf_words: int, layers,
                           output_store_min_layer: int = 0, device=None) -> MerkleTree:
    """A built JAX `MerkleTree`'s stored layers -> the port's `MerkleTree` on
    `device`, whose root, proofs and `verify` are the JAX tree's.

    `layer_hashes` are the port's hashers for the JAX tree's (for Poseidon2,
    the same field and width: the constants are the other half of the
    state, and are the JAX package's; for Keccak, the same variant);
    `layers` is `[np.asarray(l) if l is not None else None for l in
    jtree.layers]`, uint32 words: the leaves, then each layer's digests,
    None where the JAX tree dropped a layer below `output_store_min_layer`.
    Where the hasher that reads a layer has a field (Poseidon2), its words
    must be canonical elements of it (the leaves: the first layer's); a
    byte hash (Keccak) reads any words."""
    tree = MerkleTree(layer_hashes, leaf_words, output_store_min_layer)
    if len(layers) != len(tree.hashers) + 1 or layers[0] is None or layers[-1] is None:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                               f"expected {len(tree.hashers) + 1} layers with the leaves "
                               f"and the root stored, got {len(layers)}")
    readers = [tree.hashers[0]] + tree.hashers
    out = []
    for words, h in zip(layers, readers):
        if words is None:
            out.append(None)
            continue
        a = np.asarray(words)
        f = getattr(h, "field", None)
        if f is None:
            out.append(torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(resolve(device)))
            continue
        elems = a.reshape(a.shape[0], -1, f.nlimbs) if f.limb_shape else a
        out.append(elements_from_numpy(f, elems, device).reshape(a.shape))
    tree.layers = out
    tree.layer_offsets = [0] * len(out)
    return tree
