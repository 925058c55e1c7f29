"""Structural vector ops (counterpart of icicle_tpu/ops/vec_ops.py:133-150).

Only the bit-reversal permutation, which the NTT needs, is ported so far.
"""

from __future__ import annotations

import numpy as np
import torch

from icicle_tpu_torch.fields.field import Field
from icicle_tpu_torch.runtime.config import VecOpsConfig

_DEFAULT = VecOpsConfig()


def bit_reverse_indices(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    assert 1 << logn == n, "bit_reverse requires a power-of-two size"
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def bit_reverse(f: Field, a: torch.Tensor, cfg: VecOpsConfig = _DEFAULT) -> torch.Tensor:
    """Bit-reversal permutation along the vector (last) axis (reference
    bit_reverse)."""
    perm = torch.from_numpy(bit_reverse_indices(a.shape[-1]).astype(np.int64))
    return a.index_select(-1, perm.to(a.device))
