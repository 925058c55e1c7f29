"""Backend registration points (counterpart of icicle_tpu/runtime/registry.py;
reference include/icicle/backend/*.h REGISTER_* macros).

Ops register their "torch" and "cuda" implementations with the dispatcher at
their definition site; importing this module imports every op the port has.
So far that is the NTT (ops/ntt.py) and the MSM (ops/msm.py); the rest of
the JAX package's registration points arrive with the slices that port them
(ROADMAP.md).
"""

import icicle_tpu_torch.ops.msm  # noqa: F401
import icicle_tpu_torch.ops.ntt  # noqa: F401
