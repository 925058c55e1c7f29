"""Carrying the JAX package's state across to the port.

The JAX package (icicle_tpu) keeps field elements as uint32 arrays; the port
keeps them as int32 tensors holding the same bits: a single-limb element's
canonical value (< 2^31, never negative), a goldilocks element's (..., 2)
words [lo, hi] and a multi-limb element's (..., L) little-endian uint32
limbs, where a word >= 2^31 reads as negative in int32.
`.view(np.int32)` and back is exact both ways. These functions take numpy
arrays and give numpy arrays or the port's objects: the port imports nothing of JAX, and a caller that holds
a jax.Array passes `np.asarray(array)`.
"""

from __future__ import annotations

import numpy as np
import torch

from icicle_tpu_torch.curves.params import get_curve
from icicle_tpu_torch.fields.field import Field
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


def elements_to_numpy(f: Field, t: torch.Tensor) -> np.ndarray:
    """int32 element tensor -> uint32 element array with the same bits."""
    return t.cpu().numpy().view(np.uint32)


def prepared_from_numpy(curve_name: str, prepared: dict, device=None) -> dict:
    """The JAX package's `msm_tpu3_prepare` result -> the port's prepared
    bases on `device`, for `msm_tpu3(prepared=...)`.

    `prepared` holds the plan (c, T, tiles, wg, engine, ...) and `pts_u8`,
    the (tiles, T, 8L) int8 Montgomery byte planes of x || y (little-endian
    bytes of each uint32 limb, icicle_tpu/ops/msm_tpu3.py:446-457); pass
    `np.asarray(prepared["pts_u8"])` or the jax.Array itself. The limbs are
    in the plan's engine's domain (R = 2^(32 L) for "u32", R' = 2^(12 nw)
    for "r12") and carry over as they are, with the engine."""
    if prepared["engine"] not in ENGINES:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"prepared_from_numpy: unknown engine {prepared['engine']!r}")
    if prepared["nu"] != 1 or prepared.get("glv", False):
        raise NotImplementedError(
            "prepared_from_numpy: precomputed or GLV bases are not ported yet "
            "(ROADMAP.md queue A item 6)")
    planes = np.ascontiguousarray(np.asarray(prepared["pts_u8"])).view(np.uint8)
    tiles, T, nbytes = planes.shape
    limbs = planes.reshape(tiles * T, nbytes).view("<u4").astype(np.uint32)
    plan = {k: prepared[k] for k in ("engine", "nbits", "c", "M", "T", "tiles",
                                     "n_windows", "wg", "n_pad", "nu")}
    xy = torch.from_numpy(limbs.view(np.int32)).to(resolve(device))
    return dict(plan, pts=signed_table(get_curve(curve_name).fq, xy), n=prepared["n"])


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
    return tree
