"""Post-quantum KEMs (counterpart of icicle_tpu/ops/pqc/): ML-KEM's batched
device pipeline (ml_kem_tpu.py) and its host oracle (ml_kem.py)."""

from icicle_tpu_torch.ops.pqc.ml_kem import (KYBER_512, KYBER_768, KYBER_1024, PARAMS,
                                             MlKemConfig)
from icicle_tpu_torch.ops.pqc.ml_kem_tpu import decaps, encaps, keygen

__all__ = ["keygen", "encaps", "decaps", "MlKemConfig",
           "KYBER_512", "KYBER_768", "KYBER_1024", "PARAMS"]
