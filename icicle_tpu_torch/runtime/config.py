"""Per-call config dataclasses, mirroring the reference Config structs.

The reference threads {stream, on-device flags, is_async, batch} through every
call (vec_ops.h:19-44, ntt.h:27-65, msm.h:19-97 ...). In PyTorch, tensors
carry their device and CUDA work is queued on the current stream, so the
on-device flags disappear; batch/columns_batch and backend-specific `ext`
knobs survive as API surface, plus a `backend` selector for the kernel-impl
axis: "torch" (plain tensor ops), "cuda" (the hand-written kernels) or
"auto" (None), which picks "cuda" for a CUDA tensor and "torch" for a CPU
tensor (runtime/dispatcher.py).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional


@dataclasses.dataclass
class ConfigExtension:
    """string -> int/bool options bag (reference include/icicle/config_extension.h)."""

    options: dict[str, Any] = dataclasses.field(default_factory=dict)

    def set(self, key: str, value: Any) -> None:
        self.options[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self.options.get(key, default)


@dataclasses.dataclass
class VecOpsConfig:
    """reference vec_ops.h:19-44."""

    batch_size: int = 1
    columns_batch: bool = False
    is_async: bool = False
    backend: Optional[str] = None
    ext: ConfigExtension = dataclasses.field(default_factory=ConfigExtension)


class NTTDir(enum.Enum):
    FORWARD = "forward"
    INVERSE = "inverse"


class Ordering(enum.Enum):
    """reference ntt.h Ordering enum: N = natural, R = bit-reversed,
    M = digit-reversed ("mixed", matching the hierarchical radix split)."""

    NN = "NN"
    NR = "NR"
    RN = "RN"
    RR = "RR"
    NM = "NM"
    MN = "MN"


@dataclasses.dataclass
class NTTConfig:
    """reference ntt.h:27-65."""

    coset_gen: Optional[int] = None  # python int (canonical); None = no coset
    batch_size: int = 1
    columns_batch: bool = False
    ordering: Ordering = Ordering.NN
    is_async: bool = False
    backend: Optional[str] = None
    ext: ConfigExtension = dataclasses.field(default_factory=ConfigExtension)


@dataclasses.dataclass
class MatMulConfig:
    """reference mat_ops.h:20-56."""

    a_transposed: bool = False
    b_transposed: bool = False
    result_transposed: bool = False
    backend: Optional[str] = None
    ext: ConfigExtension = dataclasses.field(default_factory=ConfigExtension)


@dataclasses.dataclass
class HashConfig:
    """reference hash/hash_config.h."""

    batch_size: int = 1
    backend: Optional[str] = None
    ext: ConfigExtension = dataclasses.field(default_factory=ConfigExtension)


@dataclasses.dataclass
class MerkleTreeConfig:
    """reference merkle/merkle_tree_config.h; padding policy mirrors
    PaddingPolicy {None, ZeroPadding, LastValue}."""

    padding_policy: str = "none"  # none | zero | last_value
    backend: Optional[str] = None
    ext: ConfigExtension = dataclasses.field(default_factory=ConfigExtension)


@dataclasses.dataclass
class SumcheckConfig:
    """reference sumcheck/sumcheck_config.h."""

    use_extension_field: bool = False
    batch: int = 1
    backend: Optional[str] = None
    ext: ConfigExtension = dataclasses.field(default_factory=ConfigExtension)


@dataclasses.dataclass
class FriConfig:
    """reference fri/fri_config.h:16-36."""

    folding_factor: int = 2
    stopping_degree: int = 0
    pow_bits: int = 16
    nof_queries: int = 100
    backend: Optional[str] = None
    ext: ConfigExtension = dataclasses.field(default_factory=ConfigExtension)
