"""Multi-device NTT: the four-step decomposition with one all_to_all
(counterpart of icicle_tpu/parallel/ntt_sharded.py).

The reference scales transform length with a two-pass hierarchy-1 split on
one host (backend/cpu/include/ntt_cpu.h:79-100) and has no inter-device
path. As in the JAX package, n = n1 * n2 is viewed as an (n1, n2) matrix
whose columns are split over the d devices:

  1. length-n1 NTTs along the rank's n2 / d columns (pass A);
  2. one all_to_all: the rank's block of rows k1 for every column;
  3. the twiddles w^(k1 j2) of those rows and length-n2 NTTs along them
     (pass B), the twiddles riding in pass B's `factor`.

Both passes are the single-card four-step's (kernels/ntt_kernel.py
`ntt_four_step_cuda`, ntt_wide.py for goldilocks, 8- and 12-limb fields),
in its layouts: pass A reads the columns and writes [k1, j2]; pass B takes
the twiddle matrix on load, for the inverse times n^-1, and writes
[k2, k1]. So a rank runs two row-kernel launches an NTT, as one card does;
on CPU tensors the same code runs their plain versions. The output is the
digit-reversed kNM matrix: normalize=False returns the rank's rows of it,
(n1 / d, n2); normalize=True spends a second all_to_all on the natural
order and returns the rank's contiguous block of n / d elements.
"""

from __future__ import annotations

from icicle_tpu_torch.fields.field import Field
from icicle_tpu_torch.kernels.ntt_kernel import _stage_twiddles, dif_rows
from icicle_tpu_torch.kernels.ntt_wide import dif_rows_wide
from icicle_tpu_torch.ops.ntt import twiddle_matrix
from icicle_tpu_torch.parallel.mesh import exchange, flat_rank, mesh_device, to_mesh_device
from icicle_tpu_torch.runtime.config import NTTDir
from icicle_tpu_torch.runtime.errors import IcicleError, check


def _split(n: int, d: int) -> tuple[int, int, int]:
    logn = n.bit_length() - 1
    check(n >= 2 and 1 << logn == n, IcicleError.INVALID_ARGUMENT,
          f"NTT size must be a power of two, got {n}")
    log_n1 = logn // 2
    n1, n2 = 1 << log_n1, 1 << (logn - log_n1)
    check(n1 % d == 0 and n2 % d == 0, IcicleError.INVALID_ARGUMENT,
          f"{d} devices must divide both factors of {n} = {n1} x {n2}")
    return logn, n1, n2


def ntt_sharded(f: Field, x, mesh, dir: NTTDir = NTTDir.FORWARD, normalize: bool = True):
    """Distributed NTT of a flat vector of n = n1 n2 = 2^logn elements.

    Every rank passes the global vector x (natural order; a tensor on any
    device: only the rank's columns are copied to its device). Returns, on
    this rank's device, its contiguous block of the natural-order result
    (normalize=True) or its row block (n1 / d, n2) of the digit-reversed
    kNM matrix, y[k1, k2] = X[k1 + n1 k2] (normalize=False). The device
    count d must divide both n1 and n2. Any mesh is taken over all of its
    devices, flattened first axis major (so this is also
    `ntt_sharded_2level`)."""
    pos, d = flat_rank(mesh)
    lim = f.limb_shape
    n = x.shape[0]
    logn, n1, n2 = _split(n, d)
    b1, b2 = n1 // d, n2 // d
    dev = mesh_device(mesh)
    fwd = dir == NTTDir.FORWARD
    # the row kernel: dif_rows (single word), dif_rows_wide (goldilocks,
    # the 8-limb fields)
    row_pass = dif_rows if lim == () else dif_rows_wide
    # the rank's columns j2 in [pos b2, (pos + 1) b2): sliced before the copy
    cols = to_mesh_device(x.reshape((n1, n2) + lim)[:, pos * b2:(pos + 1) * b2], mesh).contiguous()
    # pass A: the n1-point transform of each column, written as [k1, j2]
    a = row_pass(f, cols, _stage_twiddles(f, n1.bit_length() - 1, fwd, dev),
                 transpose_in=True, transpose_out=True)
    # block j of rows k1 goes to device j: from device i come its columns
    rows = exchange(mesh, a).view((d, b1, b2) + lim).transpose(0, 1).reshape((b1, n2) + lim)
    # pass B: the rows k1 of the rank times w^(k1 j2) (and n^-1 for the
    # inverse), each transformed and written as [k2, k1]
    tw = twiddle_matrix(f, n1, n2, dir, dev, scale_n_inv=not fwd)[pos * b1:(pos + 1) * b1]
    y = row_pass(f, rows.contiguous(), _stage_twiddles(f, n2.bit_length() - 1, fwd, dev),
                 factor=tw, transpose_out=True)                     # (n2, b1): [k2, k1]
    if not normalize:
        return y.transpose(0, 1).contiguous()                      # [k1, k2]
    # natural order X[k1 + n1 k2]: block j of k2 goes to device j, whose
    # block is then k2 in [pos b2, (pos + 1) b2) with every k1
    z = exchange(mesh, y).view((d, b2, b1) + lim).transpose(0, 1)
    return z.reshape((n // d,) + lim)
