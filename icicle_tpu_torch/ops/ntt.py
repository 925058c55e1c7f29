"""Number-theoretic transform (counterpart of icicle_tpu/ops/ntt.py; reference
F3: include/icicle/ntt.h + CPU backend ntt_cpu.h / cpu_ntt_domain.h).

  * Domain = per-(field, logn, device) cache of twiddles in Montgomery form
    (goldilocks has none: its twiddles are plain values), built on the
    device by repeated doubling.
  * "torch" backend, `_ntt_torch` (counterpart of `_ntt_xla`): radix-2
    Cooley-Tukey decimation-in-time over bit-reversed input, written as
    reshape/slice/cat stages; vector-major and four-step layouts chosen by
    shape. It is the bit-exactness reference and uses no kernel.
  * "cuda" backend, `_ntt_cuda` (counterpart of `_ntt_pallas`): the
    four-step decomposition with both row passes in a hand-written DIF
    kernel (kernels/ntt_kernel.py for single-word fields,
    kernels/ntt_wide.py for goldilocks, 8- and 12-limb fields), for large
    single vectors in natural order; every other shape goes to `_ntt_torch`
    on the same device, as the JAX package routes it.

Elements are int32 tensors: single-word values (math/mont32.py), or
goldilocks word pairs and multi-limb limbs on a trailing axis (math/gl64.py,
math/bigint.py). The vector axis is the last one before the limbs, as in
the JAX package.
Orderings follow ntt.h Ordering: N = natural, R = bit-reversed, M =
digit-reversed w.r.t. the four-step radix split (n1, n2).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from icicle_tpu_torch.fields.field import Field
from icicle_tpu_torch.ops.vec_ops import bit_reverse_indices
from icicle_tpu_torch.runtime import dispatcher
from icicle_tpu_torch.runtime.config import NTTConfig, NTTDir, Ordering
from icicle_tpu_torch.runtime.device import resolve
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

_DEFAULT = NTTConfig()


# ---------------------------------------------------------------------------
# Twiddle domain
# ---------------------------------------------------------------------------

class NttDomain:
    """Twiddle tables for one (field, logn) on one device: w^0..w^(n/2-1) in
    Montgomery form for forward and inverse, plus n^-1. Reference:
    CpuNttDomain (backend/cpu/include/cpu_ntt_domain.h)."""

    def __init__(self, f: Field, logn: int, w: int, w_inv: int,
                 twiddles: torch.Tensor, twiddles_inv: torch.Tensor):
        self.field = f
        self.logn = logn
        self.w_int = w
        self.w_inv_int = w_inv
        self.n_inv_int = pow(1 << logn, -1, f.modulus)
        self.twiddles = twiddles
        self.twiddles_inv = twiddles_inv
        self.n_inv_mont = f.to_mont(f.from_ints(self.n_inv_int, twiddles.device))


def _powers_mont(f: Field, base: int, count: int, device) -> torch.Tensor:
    """[base^0, ..., base^(count-1)] in Montgomery form, built by doubling:
    log2(count) elementwise multiplies on the device."""
    out = f.to_mont(f.from_ints([1], device))
    cur_pow = f.to_mont(f.from_ints([base], device))  # base^len(out), Montgomery
    while out.shape[0] < count:
        # mul_mont(xR, yR) = xyR: Montgomery form is closed under mul_mont
        out = torch.cat([out, f.mul_mont(out, cur_pow)])
        cur_pow = f.mul_mont(cur_pow, cur_pow)
    return out[:count]


_domains: dict[tuple[str, int, torch.device], NttDomain] = {}
_tw_matrices: dict[tuple, torch.Tensor] = {}


def ntt_init_domain(f: Field, logn: int, device=None) -> NttDomain:
    """Build (or fetch) the domain of size 2^logn on `device` (reference
    ntt_init_domain, src/ntt.cpp:24-36)."""
    device = resolve(device)
    key = (f.name, logn, device)
    if key not in _domains:
        w = f.params.omega(logn)
        w_inv = pow(w, -1, f.modulus)
        half = 1 << max(logn - 1, 0)
        _domains[key] = NttDomain(f, logn, w, w_inv,
                                  _powers_mont(f, w, half, device),
                                  _powers_mont(f, w_inv, half, device))
    return _domains[key]


def ntt_release_domain(f: Field) -> None:
    """Drop every cached table of field `f`, on every device."""
    for cache in (_domains, _tw_matrices):
        for key in [k for k in cache if k[0] == f.name]:
            del cache[key]


def get_root_of_unity(f: Field, max_size: int) -> int:
    """Smallest-order omega covering max_size (reference get_root_of_unity)."""
    logn = (max_size - 1).bit_length()
    return f.params.omega(logn)


def get_domain(f: Field, logn: int, device=None) -> NttDomain:
    """The cached domain, else a subsample of a larger cached domain on the
    same device, else a new one."""
    device = resolve(device)
    key = (f.name, logn, device)
    if key in _domains:
        return _domains[key]
    for (name, cached_logn, dev), dom in list(_domains.items()):
        if name == f.name and dev == device and cached_logn > logn:
            stride = 1 << (cached_logn - logn)
            half = 1 << max(logn - 1, 0)
            _domains[key] = NttDomain(
                f, logn, pow(dom.w_int, stride, f.modulus),
                pow(dom.w_inv_int, stride, f.modulus),
                dom.twiddles[::stride][:half], dom.twiddles_inv[::stride][:half])
            return _domains[key]
    return ntt_init_domain(f, logn, device)


def twiddle_matrix(f: Field, n1: int, n2: int, dir: NTTDir, device,
                   scale_n_inv: bool = False) -> torch.Tensor:
    """The four-step inter-pass twiddles T[k1, j2] = w_n^(k1*j2), n = n1*n2,
    in Montgomery form, as an (n1, n2)+limbs int32 tensor; cached per (field, n1,
    n2, dir, device, scale_n_inv). Ported from
    icicle_tpu/parallel/ntt_sharded.py:43-62 (`_twiddle_matrix`); the rest of
    `parallel/` is not ported yet. `scale_n_inv`: T * n^-1, for an inverse
    that folds its 1/n scale into the twiddles (the CUDA four-step); the
    unscaled matrix is built for it but kept only if it was cached already."""
    device = resolve(device)
    key = (f.name, n1, n2, dir, device, scale_n_inv)
    if key not in _tw_matrices:
        n = n1 * n2
        dom = get_domain(f, n.bit_length() - 1, device)
        m = _tw_matrices.get(key[:-1] + (False,))
        if m is None:
            w = dom.w_int if dir == NTTDir.FORWARD else dom.w_inv_int
            table = _powers_mont(f, w, n, device)
            k1 = torch.arange(n1, dtype=torch.int64, device=device)[:, None]
            j2 = torch.arange(n2, dtype=torch.int64, device=device)[None, :]
            m = table[(k1 * j2) & (n - 1)]
        _tw_matrices[key] = f.mul_mont(m, dom.n_inv_mont) if scale_n_inv else m
    return _tw_matrices[key]


def _index(idx: np.ndarray, device) -> torch.Tensor:
    """numpy permutation -> int64 index tensor (index_select takes int64)."""
    return torch.from_numpy(idx.astype(np.int64)).to(device)


@functools.lru_cache(maxsize=16)
def _bit_reverse_index(n: int, device: torch.device) -> torch.Tensor:
    """bit_reverse_indices(n) as an int64 tensor on `device`, cached so that
    a transform issues no host-to-device copy for it."""
    return _index(bit_reverse_indices(n), device)


# ---------------------------------------------------------------------------
# Torch radix-2 backend
# ---------------------------------------------------------------------------

def _vec_axis(f: Field, x) -> int:
    """The vector axis of an element tensor: the last one before the limbs
    (JAX `_vec_axis`, icicle_tpu/ops/ntt.py:152)."""
    return x.dim() - 1 - len(f.limb_shape)


def _ct_stages(f: Field, x, twiddles, logn: int):
    """DIT butterflies over bit-reversed input -> natural output, along the
    vector axis of batch + (n,) + limbs. Stage s merges blocks of size
    m=2^s; twiddle for j in [0,m) is w^(j * n/(2m)), a stride-sliced view of
    the master table."""
    n = 1 << logn
    lim = f.limb_shape
    batch = x.shape[:_vec_axis(f, x)]
    half = len(batch) + 1  # the axis of the (even, odd) halves of a block
    for s in range(logn):
        m = 1 << s
        tw = twiddles[::n // (2 * m)][:m]  # (m,)+lim, Montgomery form
        xr = x.reshape(batch + (n // (2 * m), 2, m) + lim)
        even, odd = xr.select(half, 0), xr.select(half, 1)
        t = f.mul_mont(odd, tw)  # canonical * Montgomery constant -> canonical
        x = torch.cat([f.add(even, t), f.sub(even, t)], dim=half).reshape(batch + (n,) + lim)
    return x


def _ct_stages_vecfirst(f: Field, x, twiddles, logn: int):
    """DIT butterflies with the vector axis FIRST: x is (n, batch...)+lim."""
    n = 1 << logn
    lim = f.limb_shape
    rest = x.shape[1:]
    for s in range(logn):
        m = 1 << s
        tw = twiddles[::n // (2 * m)][:m].reshape((1, m) + (1,) * (len(rest) - len(lim)) + lim)
        xr = x.reshape((n // (2 * m), 2, m) + rest)
        even, odd = xr[:, 0], xr[:, 1]
        t = f.mul_mont(odd, tw)
        x = torch.stack([f.add(even, t), f.sub(even, t)], dim=1).reshape((n,) + rest)
    return x


def _ntt_vecfirst(f: Field, x, dir: NTTDir, logn: int):
    """Full natural->natural NTT along axis 0 of (n, batch...)+lim, including
    the bit-reversal row gather and the inverse 1/n scaling."""
    dom = get_domain(f, logn, x.device)
    x = x.index_select(0, _bit_reverse_index(1 << logn, x.device))
    tw = dom.twiddles if dir == NTTDir.FORWARD else dom.twiddles_inv
    y = _ct_stages_vecfirst(f, x, tw, logn)
    if dir == NTTDir.INVERSE:
        y = f.mul_mont(y, dom.n_inv_mont)
    return y


_FOUR_STEP_MIN_LOGN = 16


def _ntt_four_step(f: Field, x, dir: NTTDir, logn: int):
    """Four-step NTT of one vector (n,)+lim: n = n1*n2 viewed as an (n1, n2)
    matrix -- column NTTs, w^(k1*j2) twiddles, one transpose, row NTTs
    (reference hierarchy-1 split, backend/cpu/include/ntt_cpu.h:79-100)."""
    lim = f.limb_shape
    log_n1 = logn // 2
    n1, n2 = 1 << log_n1, 1 << (logn - log_n1)
    tw = twiddle_matrix(f, n1, n2, dir, x.device)         # (n1, n2)+lim
    y = _ntt_vecfirst(f, x.reshape((n1, n2) + lim), dir, log_n1)  # columns (axis 0)
    y = f.mul_mont(y, tw).transpose(0, 1)                  # (n2, n1)+lim
    y = _ntt_vecfirst(f, y, dir, logn - log_n1)            # rows (now axis 0)
    # y[k2, k1] = X[k1 + n1*k2] -> flat natural order
    return y.reshape((1 << logn,) + lim)


def digit_reverse_indices(logn: int) -> np.ndarray:
    """The kNM/kMN "mixed" digit permutation (reference ntt.h Ordering
    kNM/kMN): the four-step (n1, n2) digit pair with n1 = 2^(logn//2),

        vM[k1*n2 + k2] = v[k1 + n1*k2]

    Returns idx with vM = v[idx]."""
    log_n1 = logn // 2
    n1, n2 = 1 << log_n1, 1 << (logn - log_n1)
    p = np.arange(n1 * n2)
    return (p // n2 + n1 * (p % n2)).astype(np.int32)


def digit_reverse_indices_inv(logn: int) -> np.ndarray:
    """Inverse of digit_reverse_indices: v = vM[idx]."""
    log_n1 = logn // 2
    n1 = 1 << log_n1
    q = np.arange(1 << logn)
    return ((q % n1) * (1 << (logn - log_n1)) + q // n1).astype(np.int32)


def _ntt_torch(f: Field, x, dir: NTTDir, cfg: NTTConfig):
    axis = _vec_axis(f, x)
    n = x.shape[axis]
    logn = n.bit_length() - 1
    if 1 << logn != n:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              f"NTT size must be a power of two, got {n}")
    lim = f.limb_shape
    dev = x.device
    dom = get_domain(f, logn, dev)
    rev = _bit_reverse_index(n, dev)

    input_rev = cfg.ordering in (Ordering.RN, Ordering.RR)
    output_rev = cfg.ordering in (Ordering.NR, Ordering.RR)

    if cfg.ordering is Ordering.MN:
        # digit-reversed input -> natural, then proceed as NN
        x = x.index_select(axis, _index(digit_reverse_indices_inv(logn), dev))

    if dir == NTTDir.FORWARD and cfg.coset_gen is not None:
        shifts = _powers_mont(f, cfg.coset_gen, n, dev)    # (n,)+lim
        if input_rev:  # input arrives bit-reversed: permute the shift table
            shifts = shifts.index_select(0, rev)
        x = f.mul_mont(x, shifts)

    # Core transform: pick a layout by shape. Natural input + large n with no
    # batch -> four-step; batched -> vector-major; else classic DIT.
    bsz = int(np.prod(x.shape[:axis]))
    scaled = False
    if not input_rev and bsz == 1 and logn >= _FOUR_STEP_MIN_LOGN:
        y = _ntt_four_step(f, x.reshape((n,) + lim), dir, logn).reshape(x.shape)
        scaled = True
    elif not input_rev and bsz >= 64:
        y = _ntt_vecfirst(f, x.movedim(axis, 0), dir, logn).movedim(0, axis).contiguous()
        scaled = True
    else:
        if not input_rev:
            x = x.index_select(axis, rev)
        tw = dom.twiddles if dir == NTTDir.FORWARD else dom.twiddles_inv
        y = _ct_stages(f, x, tw, logn)
    # y is natural-ordered now
    if dir == NTTDir.INVERSE:
        if not scaled:
            y = f.mul_mont(y, dom.n_inv_mont)
        if cfg.coset_gen is not None:
            inv_gen = pow(cfg.coset_gen, -1, f.modulus)
            y = f.mul_mont(y, _powers_mont(f, inv_gen, n, dev))
    if output_rev:
        y = y.index_select(axis, rev)
    if cfg.ordering is Ordering.NM:
        y = y.index_select(axis, _index(digit_reverse_indices(logn), dev))
    return y


dispatcher.register_impl("ntt", dispatcher.TORCH, _ntt_torch)


def _ntt_cuda(f: Field, x, dir: NTTDir, cfg: NTTConfig):
    """CUDA backend: the four-step with both row passes in a hand-written DIF
    kernel, for a single natural-order vector of size >= 2^_FOUR_STEP_MIN_LOGN
    (the rule of the JAX package's `_ntt_pallas`): `dif_rows`
    (kernels/ntt_kernel.py) for single-word fields, `dif_rows_wide`
    (kernels/ntt_wide.py) for goldilocks, the 8-limb fields below 2^255 and
    the 12-limb fields with two spare bits; another limb field raises
    API_NOT_IMPLEMENTED there on a CUDA tensor. Every
    other shape is `_ntt_torch` on the same device, as the JAX package
    routes it. (`_ntt_pallas` itself sends every limb field to XLA: its
    Pallas kernels take single-word fields only.)"""
    axis = _vec_axis(f, x)
    n = x.shape[axis]
    logn = n.bit_length() - 1
    bsz = int(np.prod(x.shape[:axis]))
    eligible = (1 << logn == n and bsz == 1 and logn >= _FOUR_STEP_MIN_LOGN
                and cfg.ordering is Ordering.NN)
    if not eligible:
        return _ntt_torch(f, x, dir, cfg)
    lim = f.limb_shape
    if lim == ():
        from icicle_tpu_torch.kernels.ntt_kernel import ntt_four_step_cuda as four_step
    else:
        from icicle_tpu_torch.kernels.ntt_wide import ntt_four_step_wide as four_step
        from icicle_tpu_torch.kernels.ntt_wide import require_instance
        require_instance(f, x)  # before any work on the card
    y = x.reshape((n,) + lim)
    if dir == NTTDir.FORWARD and cfg.coset_gen is not None:
        y = f.mul_mont(y, _powers_mont(f, cfg.coset_gen, n, y.device))
    y = four_step(f, y, dir)
    if dir == NTTDir.INVERSE and cfg.coset_gen is not None:
        inv_gen = pow(cfg.coset_gen, -1, f.modulus)
        y = f.mul_mont(y, _powers_mont(f, inv_gen, n, y.device))
    return y.reshape(x.shape)


dispatcher.register_impl("ntt", dispatcher.CUDA, _ntt_cuda)


def ntt(f: Field, x: torch.Tensor, dir: NTTDir = NTTDir.FORWARD,
        cfg: NTTConfig = _DEFAULT) -> torch.Tensor:
    """Forward/inverse NTT along the vector axis of an int32 element tensor
    (the last axis before the limbs), computed on the tensor's device
    (reference ntt(), ntt.h)."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
        raise IcicleException(IcicleError.INVALID_ARGUMENT,
                              "ntt takes an int32 element tensor")
    return dispatcher.dispatch("ntt", cfg.backend, x)(f, x, dir, cfg)


def ntt_jit(f: Field, x: torch.Tensor, dir: NTTDir = NTTDir.FORWARD,
            cfg: NTTConfig = _DEFAULT) -> torch.Tensor:
    """The JAX package's jit-cached entry point (icicle_tpu/ops/ntt.py:396
    `ntt_jit`). The port runs eagerly and has no jit; `ntt` already caches
    the domain and the four-step twiddle matrix per (field, size,
    device), which is what `ntt_jit` threads through its compiled program,
    so this is `ntt`."""
    return ntt(f, x, dir, cfg)


# ---------------------------------------------------------------------------
# Extension-field NTT (reference EXT_FIELD ntt, backend/cpu/src/field/
# cpu_ntt.cpp:41). The NTT is linear over the base field, so an
# extension-field NTT is a component-wise base-field NTT over the base
# field's twiddle domain.
# ---------------------------------------------------------------------------


def ntt_ext(ef, x: torch.Tensor, dir: NTTDir = NTTDir.FORWARD,
            cfg: NTTConfig = _DEFAULT) -> torch.Tensor:
    """NTT over extension-field elements (babybear4 etc.; counterpart of the
    JAX package's ops/ntt.py `ntt_ext`, which computes the same function).

    x: (batch..., n, D) int32 elements of `ef` over a single-word base, or
    (batch..., n, D * B) over a B-word base (goldilocks, whose quadratic
    extension the JAX function refuses). Each of the D components goes
    through `ntt` as its own vector over the base field: a single
    natural-order vector of 2^16 or more on a CUDA tensor takes `_ntt_cuda`'s
    two `dif_rows` launches a component (`_ntt_cuda` sends a batch of
    vectors to `_ntt_torch`)."""
    comps = [c.contiguous() for c in ef.engine.comps(x)]
    return ef.engine.restack([ntt(ef.base, c, dir, cfg) for c in comps])


# ntt_ext routes by its input's device (and cfg.backend), so it registers once
dispatcher.register_impl("extension_ntt", dispatcher.DEVICE, ntt_ext)


# ---------------------------------------------------------------------------
# RNS-ring NTT (reference RING_RNS ntt, backend/cpu/src/field/cpu_ntt.cpp:
# 45-48): each residue plane of babykoala Z_q transforms with the residue of
# the RING's root of unity (babykoala.h zq_config::rou) in that plane, so
# the results CRT-match the direct-domain Z_q NTT.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rns_plane_fields() -> tuple[Field, Field]:
    """The two Mont32 plane fields, babykoala_rns_bb and babykoala_rns_kb:
    babybear's and koalabear's moduli with the ring's root of unity (order
    2^24) reduced into each."""
    from icicle_tpu_torch.math.params import FieldParams
    from icicle_tpu_torch.rings.babykoala import OMEGAS_COUNT, P_BB, P_KB, ROU
    return tuple(Field(FieldParams(name=name, modulus=p, rou=ROU % p,
                                   two_adicity_override=OMEGAS_COUNT))
                 for name, p in (("babykoala_rns_bb", P_BB), ("babykoala_rns_kb", P_KB)))


def ntt_rns(x: torch.Tensor, dir: NTTDir = NTTDir.FORWARD,
            cfg: NTTConfig = _DEFAULT) -> torch.Tensor:
    """NTT over babykoala Z_q in RNS form (counterpart of the JAX package's
    ops/ntt.py `ntt_rns`). x: (batch..., n, 2) int32 canonical residues
    (x mod P_bb, x mod P_kb); each plane goes through `ntt` over its plane
    field, so a single natural-order vector of 2^16 or more on a CUDA
    tensor takes `_ntt_cuda`'s two `dif_rows` launches a plane."""
    f_bb, f_kb = _rns_plane_fields()
    return torch.stack([ntt(f, x[..., i].contiguous(), dir, cfg)
                        for i, f in enumerate((f_bb, f_kb))], dim=-1)
