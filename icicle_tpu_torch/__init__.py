"""icicle_tpu_torch -- the PyTorch/CUDA port of icicle_tpu.

A second package beside the JAX one, with the same layout and names. It
imports torch and numpy, never jax and nothing of icicle_tpu. Elements of
single-limb fields are int32 tensors holding canonical values; functions
compute on their input's device, and create tensors on CUDA unless the
caller passes `device="cpu"` or calls `set_device("cpu")`.

Ported so far: the runtime, the Mont32 field layer (babybear, koalabear,
m31) and the NTT, whose four-step row passes run in a hand-written Hopper
kernel (kernels/csrc/ntt_dif.cu).

    fields:   get_field
    ops:      ntt, NTTConfig, NTTDir, Ordering
    runtime:  set_device
"""

from icicle_tpu_torch.fields.field import get_field
from icicle_tpu_torch.ops.ntt import ntt
from icicle_tpu_torch.runtime import registry as _registry  # noqa: F401
from icicle_tpu_torch.runtime.config import NTTConfig, NTTDir, Ordering
from icicle_tpu_torch.runtime.device import set_device

__all__ = ["get_field", "ntt", "NTTConfig", "NTTDir", "Ordering", "set_device"]
