"""Builds B3's prefix scan (kernels/csrc/msm_scan.cu) from a directory of
kernel sources and runs chip_smoke.py's checks and timings of it on one
CUDA card, through the port's wrapper.

    python -m icicle_tpu_torch.kernels.msm_scan_probe [--csrc DIR]

Run it from a checkout's root: it imports chip_smoke.py from there. DIR
defaults to this checkout's kernels/csrc. To compare builds, give another
tree's sources (`git archive <rev> icicle_tpu_torch/kernels/csrc | tar -x
-C build/<name>`) or a copy with other launch bounds, one process a build,
in turns (A, B, B, A) on one machine. B3's libraries (bn254's msm_scan and
build.HEADERS' wide ones) are built from DIR with build.py's flags into
icicle_tpu_torch/build/msm_scan_probe/<DIR as a name>/, kept there: a
second run of the same DIR builds nothing. Prints each compiled library's
ptxas report of the three passes and the SASS counts of one madd of its
rescan (kernels/sass.py `outer_loop`), then chip_smoke.check_msm_kernels'
log over plan_checks' B3 rows for M1, E1, M2, E2, E3 (bls12_377 and
bw6_761) and bn254 2^24 (bit-exact against prefix_scan_ref at K 64 and 61
and equal to the serial fold as points, then timed at full depth), and
last one JSON line of the card, DIR and those times.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from icicle_tpu_torch.kernels import build, sass

LIBRARIES = ("msm_scan", *build.HEADERS)


def madd_trips(lib: str, wide: bool) -> int:
    """Trips of the rolled multiply loop in one madd of `lib`'s rescan:
    ec_wide.cuh's where DIR has that header (chip_smoke.wide_madd_trips),
    else ec_field.cuh's CIOS, one word of b a trip, rolled above 12 limbs."""
    import chip_smoke

    if wide:
        return chip_smoke.wide_madd_trips(lib)
    nl = build.define(lib, "ICICLE_EC_LIMBS", 8)
    return 1 if nl <= 12 else nl


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", default=build.CSRC)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("msm_scan_probe: needs a CUDA card")
    import chip_smoke
    from icicle_tpu_torch.curves.group import get_group
    from icicle_tpu_torch.ops.msm import default_c, generic_plan

    csrc = os.path.abspath(args.csrc)
    build.CSRC = csrc
    build.BUILD_DIR = os.path.join(build.BUILD_DIR, "msm_scan_probe",
                                   csrc.strip(os.sep).replace(os.sep, "_"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    chip_smoke.log(f"{smi}; B3 built from {csrc}")
    reports = build.build_all(LIBRARIES)
    has_wide = os.path.exists(os.path.join(csrc, "ec_wide.cuh"))
    ptxas, madds = {}, {}
    for lib in LIBRARIES:
        wide = has_wide and lib in build.HEADERS
        found = sass.kernel_counts(build.lib_path(lib),
                                   "wide_rescan_kernel" if wide else "rescan_kernel", True)
        if len(found) != 1:
            raise AssertionError(f"lib{lib}: {len(found)} rescan kernels")
        counts = sass.outer_loop(next(iter(found.values()))["blocks"], madd_trips(lib, wide))
        madds[lib] = {k: counts.get(k, 0) for k in chip_smoke.SASS_KINDS}
        ptxas[lib] = (build.ptxas_kernels(reports[lib], chip_smoke.B3_PASSES) if lib in reports
                      else "not compiled in this run: the library was up to date")
        chip_smoke.log(f"lib{lib}: {reports[lib].splitlines()[-1] if lib in reports else ''}; "
                       f"ptxas {ptxas[lib]}; one madd's SASS {madds[lib]}")

    def g2_plan(cname: str) -> dict:
        n = 1 << chip_smoke.G2_PATH_LOGS[cname]
        return generic_plan(cname, n, default_c(n, g2=True), g2=True)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    times = {}
    for path, cname, g2, plan in (
            ("M1", "bls12_381", False, chip_smoke.v3_plan("bls12_381", 1 << chip_smoke.M1_LOG)),
            ("E1", "bn254", True, g2_plan("bn254")),
            ("M2", "bw6_761", False, chip_smoke.v3_plan("bw6_761", 1 << chip_smoke.M2_LOG)),
            ("E2", "bls12_381", True, g2_plan("bls12_381")),
            ("E3 bls12_377", "bls12_377", True, g2_plan("bls12_377")),
            ("E3 bw6_761", "bw6_761", True, g2_plan("bw6_761")),
            ("2^24", "bn254", False, chip_smoke.v3_plan("bn254", 1 << 24))):
        g = get_group(cname, g2=g2)
        checks, full = (
            [r for r in rows if r[0] == "prefix_scan"]
            for rows in chip_smoke.plan_checks(g, plan, path))
        rows = chip_smoke.check_msm_kernels(dev, gen, smi, g, checks, full)["prefix_scan"]
        times[path] = next(r["kernel_ms"] for r in rows if not r["checked"])
    print(json.dumps({"card": smi, "csrc": csrc, "ms": times, "ptxas": ptxas,
                      "madd_sass": madds}))


if __name__ == "__main__":
    main()
