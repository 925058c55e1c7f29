"""Measures one build of the Poseidon2 kernel on a CUDA card: its build
time and ptxas report, the SASS instruction counts of its babybear t = 2
kernel (kernels/sass.py), a bit-exact check against `hash_fields_ref` at
batch 2^16 (with rows of 0 and p - 1), and its time at the 2^29 Merkle
tree's leaf layer (babybear t = 2, batch 2^28; median of CUDA events after
a warm-up). Prints one JSON line.

    PYTHONPATH=<checkout> python icicle_tpu_torch/kernels/poseidon2_probe.py

Run as a file, it measures the `icicle_tpu_torch` of the checkout on
PYTHONPATH (this one, or another unpacked under a gitignored directory):
run two builds in turns (A, B, B, A) within one machine to compare them.
The SASS counted is this tree's single-permutation kernel (no loop: its
static count is its count a hash), or the one kernel a width of builds
before the instances were fixed at compile time, whose blocks are
weighted by one hash's path (PARENT_PATH).
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import time

import torch

# this tree's SASS reader, also for a checkout that has none
_spec = importlib.util.spec_from_file_location(
    "icicle_sass", os.path.join(os.path.dirname(os.path.abspath(__file__)), "sass.py"))
sass = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sass)

REGEXES = ("babybear_t2ELb0E", "4WordELi2EE")
# The one-kernel-a-width build (before the compile-time instances) loops
# over the rounds: one babybear t = 2 hash (n = 2: one permutation, 12 full
# and 24 partial rounds, alpha 7) runs these blocks (start address: runs)
# of its SASS as nvcc 12.8 built it for sm_90a, read from `sass.py
# --blocks`.
PARENT_PATH = {0x0: 1, 0x2b0: 1, 0x3a0: 1, 0x590: 1, 0x650: 1, 0x910: 1, 0x960: 36,
               0xa00: 24, 0xb10: 24, 0xbc0: 24, 0xea0: 24, 0x10f0: 24,
               0x1300: 12, 0x1410: 12, 0x14c0: 12, 0x17a0: 12, 0x19f0: 12, 0x1ad0: 12,
               0x1b80: 12, 0x1e60: 12, 0x20b0: 12, 0x2360: 36, 0x2370: 1, 0x23a0: 1}
LEAF_BATCH = 1 << 28
CHECK_BATCH = 1 << 16
REPS = 10


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("poseidon2_probe: needs a CUDA card")
    from icicle_tpu_torch import Poseidon2, get_field
    from icicle_tpu_torch.kernels import build
    from icicle_tpu_torch.kernels import poseidon2_kernel as PK
    t0 = time.perf_counter()
    report = build.build_all(["poseidon2"]).get("poseidon2", "")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln or "bytes stack" in ln]
    lib = build.lib_path("poseidon2")
    counts = {}
    for rx in REGEXES:
        counts = sass.kernel_counts(lib, rx, with_blocks=True)
        if counts:
            break
    # a hash's count: the whole kernel where it has no loop, else the path
    per_hash = {name: (c["counts"] if rx == REGEXES[0] else sass.weighted(c["blocks"], PARENT_PATH))
                for name, c in counts.items()}

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(8)
    f = get_field("babybear")
    h = Poseidon2(f, 2)
    x = torch.randint(0, f.modulus, (CHECK_BATCH, 2), generator=gen, device=dev,
                      dtype=torch.int32)
    x[0], x[1] = 0, f.modulus - 1
    if not torch.equal(PK.poseidon2(h, x), h.hash_fields_ref(x)):
        raise AssertionError("poseidon2 != hash_fields_ref at babybear t=2, batch 2^16")
    x = torch.randint(0, f.modulus, (LEAF_BATCH, 2), generator=gen, device=dev,
                      dtype=torch.int32)
    PK.poseidon2(h, x)
    times = []
    for _ in range(REPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        PK.poseidon2(h, x)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"package": os.path.dirname(os.path.dirname(PK.__file__)),
                      "build_s": build_s, "ptxas": ptxas,
                      "sass": {name: c["counts"] for name, c in counts.items()},
                      "sass_per_hash": per_hash,
                      "checked_2^16": True, "leaf_ms": statistics.median(times),
                      "leaf_ms_all": times, "card": smi}))


if __name__ == "__main__":
    main()
