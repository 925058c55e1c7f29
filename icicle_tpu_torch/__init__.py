"""icicle_tpu_torch -- the PyTorch/CUDA port of icicle_tpu.

A second package beside the JAX one, with the same layout and names. It
imports torch and numpy, never jax and nothing of icicle_tpu. Elements of
single-limb fields are int32 tensors holding canonical values; functions
compute on their input's device, and create tensors on CUDA unless the
caller passes `device="cpu"` or calls `set_device("cpu")`.

Multi-limb field elements are (..., L) int32 tensors holding the uint32
limb bit patterns.

Ported so far: the runtime, the field layer (Mont32 and multi-limb), the
NTT, whose four-step row passes run in a hand-written Hopper kernel
(kernels/csrc/ntt_dif.cu), and the bn254 G1 MSM (the v3 prefix-scan
pipeline), whose scan and EC reductions run in two more
(kernels/csrc/msm_scan.cu, ec_reduce.cu).

    fields:   get_field
    curves:   get_curve
    ops:      ntt, NTTConfig, NTTDir, Ordering, msm_affine, MSMConfig
    runtime:  set_device
"""

from icicle_tpu_torch.curves.params import get_curve
from icicle_tpu_torch.fields.field import get_field
from icicle_tpu_torch.ops.msm import MSMConfig, msm_affine
from icicle_tpu_torch.ops.ntt import ntt
from icicle_tpu_torch.runtime import registry as _registry  # noqa: F401
from icicle_tpu_torch.runtime.config import NTTConfig, NTTDir, Ordering
from icicle_tpu_torch.runtime.device import set_device

__all__ = ["get_curve", "get_field", "ntt", "NTTConfig", "NTTDir", "Ordering",
           "msm_affine", "MSMConfig", "set_device"]
