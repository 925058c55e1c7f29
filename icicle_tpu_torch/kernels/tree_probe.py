"""Builds kernels from a directory of kernel sources and runs them through
the port's wrappers on one CUDA card, with chip_smoke.py's inputs, checks
and timing, so two trees can be compared one process a tree.

    python -m icicle_tpu_torch.kernels.tree_probe [--csrc DIR]
        [--paths b3|bases|gl64|ecntt|b4|sponge|ntt_wide] [--against FILE]

Run it from a checkout's root: it imports chip_smoke.py and the package
from there. DIR defaults to this checkout's kernels/csrc; a DIR's libraries
are built with build.py's flags into icicle_tpu_torch/build/tree_probe/<DIR
as a name>/ and kept there (a second run of the same DIR builds nothing).
Compare builds in turns (A, B, B, A) on one machine.

--paths b3 (the default): B3's prefix scan (msm_scan.cu; bn254's msm_scan
and build.WIDE_SCANS). Prints each library's ptxas report of the three
passes and the SASS counts of one madd of its rescan (kernels/sass.py
`outer_loop`), then chip_smoke.check_msm_kernels' log over plan_checks' B3
rows for M1, E1, M2, E2, E3 (bls12_377 and bw6_761) and bn254 2^24
(bit-exact against prefix_scan_ref at K 64 and 61 and equal to the serial
fold as points, then timed at full depth). B3's C entry has kept its form,
so DIR may be an older tree's sources (`git archive <rev>
icicle_tpu_torch/kernels/csrc | tar -x -C build/<name>`).

--paths bases: precompute_bases (precompute_bases.cu, G1 and Fp2 libraries)
at M4's, E4's and M3's bases and the 8-limb Poseidon (poseidon_limbs.cu) at
P1's leaf layer (bls12_381_scalar, and bn254_scalar, a lazy field, at the
same shape), through precompute_kernel.precompute_bases and
poseidon_kernel.poseidon: each output's first rows held to the plain
version, then timed (chip_smoke.cuda_ms, a median of 3 after a warm-up) and
hashed. Also prints ptxas's registers and spills of those libraries and the
SASS counts of poseidon2_limbs' kernels. The wrappers' C calls have
changed between trees, so to time an older tree run this file from a
checkout of that commit (`git archive <rev> | tar -x -C build/parent`, this
file copied into its icicle_tpu_torch/kernels/): its own wrappers, sources
and build directory. With --against FILE (the last line another run
printed) it fails unless every output hash both runs have and
poseidon2_limbs' SASS counts equal that run's, and prints the two runs'
times side by side.

--paths gl64: the goldilocks Poseidon2 (poseidon2_gl64.cu) at the 2^28
tree's leaf layer (t = 2, 2^27 hashes) and at batch 2^16 at every width
the tree's wrapper sends to the kernel (an older tree has fewer: the
others are skipped), through poseidon2_kernel.poseidon2: the first rows
(rows of 0 and of p - 1 among them) held to hash_fields_ref, then timed
and hashed. Also prints the library's ptxas report and the SASS counts of
the t = 2 single-permutation kernel, its count a hash (no loop).

--paths ecntt: the ECNTT kernel (ecntt.cu; ecntt, ecntt_l12, ecntt_l24)
on EC1's inputs (chip_smoke.EC1_PATHS: bn254 2^16, bls12_381 2^13,
bw6_761 2^8): its last stage with the GLV ladder (n / 2 lanes), the GLV
scale of n lanes by random scalars, each through ecntt_kernel's wrapper,
its first lanes held to the plain version on a cut of the same lanes, then
timed and hashed; and a forward transform through icicle_tpu_torch.ecntt,
timed on the host clock and hashed. Also prints each library's ptxas
report.

--paths b4: B4, the EC reduce (ec_reduce.cu; bn254's ec_reduce and the
wide libraries ec_reduce_l12, _l24, _fp2, _fp2_l12). Prints each library's
ptxas report of its kernel and the kernel's static SASS counts, then
chip_smoke.check_msm_kernels' log over plan_checks' B4 rows for M1, E1,
M2, E2, E3 (bls12_377 and bw6_761) and bn254 2^24 (bit-exact against
ec_reduce_ref at R 64 and 61 and equal to the serial fold as points, then
the cross-tile sum and both bucket passes timed at full depth at the
wrapper's plan), with the cross-tile sum also timed at each segment count
of B4_SEGMENTS (the wrapper's `_segments`). B4's C entry has kept its form, so DIR may be
an older tree's sources, as for b3.

--paths sponge: keccak.cu's icicle_keccak_sponge at every row of
chip_smoke.SPONGE_CHECKS and at ML-KEM-768's matrix in one launch
(SPONGE_MATRIX: 9 x 2^16 messages of 34 bytes, squeezed to 1512), through
keccak_kernel.keccak_sponge: each output held to keccak_sponge_ref on its
first rows, then timed and hashed; then ML-KEM-768 keygen, encaps and
decaps at a batch of 2^16 through icicle_tpu_torch's ml_kem_tpu, each
counted, timed on the host clock (chip_smoke.host_ms) and hashed. Also
prints the library's ptxas report and the static SASS counts of the three
sponge instances. To time an older tree's ML-KEM, run this file from a
checkout of it (as for bases); DIR alone changes the kernel only.

--paths ntt_wide: the NTT row kernel dif_rows_wide (ntt_wide.cu; ntt_wide
and, where the tree has it, ntt_wide_l12) at NTT_WIDE_SHAPES, through
ntt_wide.dif_rows_wide in the four-step's layouts (pass A: columns in
and out; pass B: rows in, columns out, times a factor): the passes of
the goldilocks 2^24 and bn254_scalar 2^22 NTTs, bls12_381_scalar's (the
canonical instance) and bw6_761_scalar's at 2^22, and passes whose rows
span a thread-block cluster; each output held to dif_rows_wide_ref at
sampled rows, then timed (chip_smoke.cuda_ms, a median of 5 after a
warm-up) and its first 2^22 elements hashed, and at NTT_WIDE_PLANS's
other (TR, cluster) plans, bit-equal and timed; then forward NTTs of
goldilocks 2^24, bn254_scalar 2^22 and bw6_761_scalar 2^22 through
icicle_tpu_torch.ntt on the host clock, hashed. A tree whose wrapper has
no plan for a shape (an older tree's field or row length) skips it. Also
prints each library's ptxas report and the static SASS counts of its
kernels. The wrapper's C call has changed between trees: time an older
tree from a checkout of it, as for bases.

Last, one JSON line of the card, the tree and the times.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import subprocess

import torch

from icicle_tpu_torch.kernels import build, sass

PATHS = ("b3", "bases", "gl64", "ecntt", "b4", "sponge", "ntt_wide")
BASES_LIBRARIES = ("precompute_bases", "precompute_bases_fp2", "poseidon_limbs",
                   "poseidon2_limbs")
P1_FIELDS = ("bls12_381_scalar", "bn254_scalar")
CHECK_ROWS = 128       # rows of each output held to the plain version
GL64_WIDTHS = (2, 3, 4, 8, 12, 16, 20, 24)
GL64_BATCH = 1 << 16
# poseidon2_kernel<Gl64Instance<2, 4, 27, 7>, false>: one t = 2 permutation
# (chip_smoke.GL64_SASS_KERNEL; a copy, since an older tree's chip_smoke.py
# has none)
GL64_SASS_KERNEL = "Gl64InstanceILi2ELi4ELi27ELi7EEELb0E"
ECNTT_LIBRARIES = ("ecntt", "ecntt_l12", "ecntt_l24")
B4_LIBRARIES = ("ec_reduce", "ec_reduce_l12", "ec_reduce_l24", "ec_reduce_fp2", "ec_reduce_fp2_l12")
B4_SEGMENTS = (4, 8, 16, 32)   # the cross-tile sum's segment counts timed beside the plan's
# ML-KEM-768's matrix at 2^16 keys in one launch (chip_smoke.SPONGE_MATRIX;
# a copy, since an older tree's chip_smoke.py has none)
SPONGE_MATRIX = ("SHAKE128 XOF matrix, 9 entries a key", 9 << 16, 34, 168, 0x1F, 504 * 3)
MLKEM_LOG = 16
# (field, rows, log_n, pass, role) of dif_rows_wide: pass "A" (forward
# twiddles, columns in and out) or "B" (inverse twiddles, rows in, columns
# out, times a factor), as ntt_four_step_wide launches them
NTT_WIDE_SHAPES = (
    ("goldilocks", 4096, 12, "A", "goldilocks 2^24 pass A"),
    ("goldilocks", 4096, 12, "B", "goldilocks 2^24 pass B"),
    ("bn254_scalar", 2048, 11, "A", "bn254_scalar 2^22 pass A"),
    ("bn254_scalar", 2048, 11, "B", "bn254_scalar 2^22 pass B"),
    ("bls12_381_scalar", 2048, 11, "A", "bls12_381_scalar 2^22 pass A"),
    ("bls12_381_scalar", 2048, 11, "B", "bls12_381_scalar 2^22 pass B"),
    ("bw6_761_scalar", 2048, 11, "A", "bw6_761_scalar 2^22 pass A"),
    ("bw6_761_scalar", 2048, 11, "B", "bw6_761_scalar 2^22 pass B"),
    ("bn254_scalar", 4096, 12, "B", "bn254_scalar 2^24 pass B"),
    ("bn254_scalar", 8192, 13, "B", "bn254_scalar 2^26 pass B"),
    ("bn254_scalar", 8192, 14, "B", "bn254_scalar 2^27 pass B"),
    ("goldilocks", 16384, 15, "B", "goldilocks 2^29 pass B"),
    ("bw6_761_scalar", 4096, 12, "B", "bw6_761_scalar 2^24 pass B"),
    ("bw6_761_scalar", 4096, 13, "B", "bw6_761_scalar 2^25 pass B"),
    ("bw6_761_scalar", 8192, 14, "B", "bw6_761_scalar 2^27 pass B"),
)
# other (TR, cluster) plans timed beside the wrapper's, through its `_plan`
# (where the tree's wrapper takes it), each held bit-equal to the wrapper's
# plan
NTT_WIDE_PLANS = {"goldilocks 2^24 pass A": ((4, 1), (4, 4), (8, 2), (8, 4)),
                  "goldilocks 2^24 pass B": ((4, 1), (4, 4), (8, 2), (8, 4)),
                  "bn254_scalar 2^22 pass A": ((1, 2), (1, 4), (2, 2)),
                  "bn254_scalar 2^22 pass B": ((1, 2), (1, 4), (2, 2)),
                  "bw6_761_scalar 2^22 pass A": ((1, 2), (1, 4), (2, 4)),
                  "bw6_761_scalar 2^22 pass B": ((1, 2), (1, 4), (2, 4))}
NTT_WIDE_NTTS = (("goldilocks", 24), ("bn254_scalar", 22), ("bw6_761_scalar", 22))
NTT_WIDE_CHECKED = 16        # sampled rows of a pass held to the plain version
NTT_WIDE_HASHED = 1 << 22    # elements of a pass's output hashed


def madd_trips(lib: str, wide: bool) -> int:
    """Trips of the rolled multiply loop in one madd of `lib`'s rescan:
    ec_wide.cuh's where DIR has that header (chip_smoke.wide_madd_trips),
    else ec_field.cuh's CIOS, one word of b a trip, rolled above 12 limbs."""
    import chip_smoke

    if wide:
        return chip_smoke.wide_madd_trips(lib)
    nl = build.define(lib, "ICICLE_EC_LIMBS", 8)
    return 1 if nl <= 12 else nl


def b3_paths(csrc: str, smi: str) -> dict:
    import chip_smoke
    from icicle_tpu_torch.curves.group import get_group
    from icicle_tpu_torch.ops.msm import default_c, generic_plan

    libraries = ("msm_scan", *build.WIDE_SCANS)
    reports = build.build_all(libraries)
    has_wide = os.path.exists(os.path.join(csrc, "ec_wide.cuh"))
    ptxas, madds = {}, {}
    for lib in libraries:
        wide = has_wide and lib in build.WIDE_SCANS
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
    return {"ms": times, "ptxas": ptxas, "madd_sass": madds}


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def bases_paths(smi: str) -> dict:
    import chip_smoke
    from icicle_tpu_torch import Poseidon
    from icicle_tpu_torch.curves.group import get_group
    from icicle_tpu_torch.kernels import poseidon_kernel as PK
    from icicle_tpu_torch.kernels import precompute_kernel as PB
    from icicle_tpu_torch.ops.msm import precompute_shift

    reports = build.build_all(BASES_LIBRARIES)
    ptxas = {}
    for lib in BASES_LIBRARIES[:3]:
        ptxas[lib] = chip_smoke.lib_ptxas(reports, lib)
        chip_smoke.log(f"lib{lib}: ptxas {ptxas[lib]}")
    # kernel names hold the source path's hash: compare the sorted counts
    p2 = sorted(json.dumps(v["counts"], sort_keys=True) for v in
                sass.kernel_counts(build.lib_path("poseidon2_limbs"), ".").values())
    p2_sass = {"kernels": len(p2), "total": sum(json.loads(c)["total"] for c in p2),
               "digest": hashlib.sha256("\n".join(p2).encode()).hexdigest()}
    chip_smoke.log(f"libposeidon2_limbs: SASS {p2_sass}")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    times, digests = {}, {}
    for cname, g2, log_n, nu, c, label in (
            ("bn254", False, chip_smoke.M4_LOG, 4, chip_smoke.M4_C, "M4's bases at nu 4"),
            ("bn254", True, chip_smoke.E4_LOG, chip_smoke.E4_NU, chip_smoke.E4_C, "E4's bases"),
            ("bls12_377", False, chip_smoke.M3_LOG, chip_smoke.M3_NU, chip_smoke.M3_C,
             "M3's bases")):
        g = get_group(cname, g2=g2)
        f = g.coord_field
        n = 1 << log_n
        shift = precompute_shift(g.curve.fr.modulus.bit_length(), c, nu)
        pts = chip_smoke.pool_points(g, 16)
        idx = torch.randint(0, 16, (n,), generator=gen, device=dev)
        px = f.from_ints([p[0] for p in pts], dev)[idx]
        py = f.from_ints([p[1] for p in pts], dev)[idx]
        px[:2] = 0        # identities
        py[:2] = 0
        ox, oy = PB.precompute_bases(g, px, py, nu, shift)
        rx, ry = PB.precompute_bases_ref(g, px[:CHECK_ROWS], py[:CHECK_ROWS], nu, shift)
        if not (torch.equal(ox[:nu * CHECK_ROWS], rx) and torch.equal(oy[:nu * CHECK_ROWS], ry)):
            raise AssertionError(f"{label}: != precompute_bases_ref")
        label = f"{label} ({cname}{' G2' if g2 else ''} 2^{log_n}, nu {nu}, shift {shift})"
        digests[label] = digest(ox, oy)
        times[label] = chip_smoke.cuda_ms(lambda: PB.precompute_bases(g, px, py, nu, shift),
                                          reps=3)
        chip_smoke.log(f"{label}: {times[label]} ms [{smi}]")
        del px, py, ox, oy
        torch.cuda.empty_cache()

    n = 1 << (chip_smoke.P1_LOG - 3)
    for fname in P1_FIELDS:
        h = Poseidon(fname, 9, domain_tag=0)
        x = chip_smoke.field_elements(h.field, (n, h.arity), gen, dev).contiguous()
        out = PK.poseidon(h, x)
        if not torch.equal(out[:CHECK_ROWS], h.hash_fields_ref(x[:CHECK_ROWS])):
            raise AssertionError(f"poseidon {fname}: != hash_fields_ref")
        label = f"P1 leaf layer, {fname} t=9 tag, {n} hashes"
        digests[label] = digest(out)
        times[label] = chip_smoke.cuda_ms(lambda: PK.poseidon(h, x), reps=3)
        chip_smoke.log(f"{label}: {times[label]} ms [{smi}]")
        del x, out
        torch.cuda.empty_cache()
    return {"ms": times, "digest": digests, "ptxas": ptxas, "poseidon2_limbs_sass": p2_sass}


def gl64_paths(smi: str) -> dict:
    import chip_smoke
    from icicle_tpu_torch import Poseidon2, get_field
    from icicle_tpu_torch.kernels import poseidon2_kernel as PK

    reports = build.build_all(["poseidon2_gl64"])
    ptxas = chip_smoke.lib_ptxas(reports, "poseidon2_gl64")
    chip_smoke.log(f"libposeidon2_gl64: ptxas {ptxas}")
    found = sass.kernel_counts(build.lib_path("poseidon2_gl64"), GL64_SASS_KERNEL)
    if len(found) != 1:
        raise AssertionError(f"libposeidon2_gl64: {len(found)} kernels match {GL64_SASS_KERNEL}")
    t2_sass = next(iter(found.values()))["counts"]
    chip_smoke.log(f"libposeidon2_gl64 t=2 single permutation, SASS per hash: {t2_sass}")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    f = get_field("goldilocks")
    times, digests = {}, {}
    shapes = [(2, chip_smoke.GL_POSEIDON2_TIMED, chip_smoke.GL_POSEIDON2_ROLE)] + [
        (t, GL64_BATCH, f"goldilocks t={t}, batch {GL64_BATCH}") for t in GL64_WIDTHS]
    for t, batch, label in shapes:
        h = Poseidon2(f, t)
        if not PK.supported_on_cuda(h):
            chip_smoke.log(f"{label}: skipped, this tree's wrapper has no kernel at t={t}")
            continue
        gen = torch.Generator(device=dev).manual_seed(19 + t)
        x = chip_smoke.field_elements(f, (batch, t), gen, dev)
        x[0] = f.zeros((t,), dev)
        x[1] = f.from_ints([f.modulus - 1] * t, dev)
        out = PK.poseidon2(h, x)
        if not torch.equal(out[:CHECK_ROWS], h.hash_fields_ref(x[:CHECK_ROWS])):
            raise AssertionError(f"{label}: != hash_fields_ref")
        digests[label] = digest(out)
        times[label] = chip_smoke.cuda_ms(lambda: PK.poseidon2(h, x), reps=5)
        chip_smoke.log(f"{label}: {times[label]} ms [{smi}]")
        del x, out
        torch.cuda.empty_cache()
    return {"ms": times, "digest": digests, "ptxas": ptxas, "t2_sass": t2_sass}


def ecntt_paths(smi: str) -> dict:
    import numpy as np

    import chip_smoke
    from icicle_tpu_torch import NTTDir, ecntt, get_group
    from icicle_tpu_torch.curves.group import Projective
    from icicle_tpu_torch.kernels import ecntt_kernel as EK
    from icicle_tpu_torch.ops import ecntt as E

    reports = build.build_all(ECNTT_LIBRARIES)
    ptxas = {lib: chip_smoke.lib_ptxas(reports, lib) for lib in ECNTT_LIBRARIES}
    for lib, rep in ptxas.items():
        chip_smoke.log(f"lib{lib}: {reports[lib].splitlines()[-1] if lib in reports else ''}; "
                       f"ptxas {rep}")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    times, digests = {}, {}
    for cname, logn, _, _ in chip_smoke.EC1_PATHS:
        g = get_group(cname)
        n, m = 1 << logn, 1 << (logn - 1)
        P, _ = chip_smoke.ecntt_points(g, n, dev)
        r = g.curve.fr.modulus
        rng = np.random.default_rng(logn)
        scalars = [int.from_bytes(rng.bytes(r.bit_length() // 8 + 8), "little") % r
                   for _ in range(n)]
        scale_rows = E._to_device(E._glv_rows(cname, scalars), dev)
        stage_rows = E._stage_rows(cname, logn, False, True, dev)[-1]
        k = min(CHECK_ROWS, m)
        # the first k lanes of each launch: a stage's lanes j < k read points
        # j and m + j and column j of the rows; the scale's lane j point j
        cut = Projective(*(torch.cat([c[:k], c[m:m + k]]) for c in P))
        for label, call, want in (
                (f"ecntt_stage {cname} 2^{logn} last stage, GLV ({m} lanes)",
                 lambda: EK.ecntt_stage(g, P, m, stage_rows, True),
                 lambda: EK.ecntt_stage_ref(g, cut, k, tuple(t[..., :k] for t in stage_rows),
                                            True)),
                (f"ecntt_scale {cname} 2^{logn}, GLV ({n} lanes)",
                 lambda: EK.ecntt_scale(g, P, scale_rows),
                 lambda: EK.ecntt_scale_ref(g, Projective(*(c[:k] for c in P)),
                                            tuple(t[..., :k] for t in scale_rows)))):
            out = call()
            ref = want()
            rows = (torch.cat([torch.arange(k), torch.arange(m, m + k)]).to(dev)
                    if "stage" in label else torch.arange(k, device=dev))
            if not all(torch.equal(o[rows], w) for o, w in zip(out, ref)):
                raise AssertionError(f"{label}: != its plain version on the first {k} lanes")
            digests[label] = digest(*out)
            times[label] = chip_smoke.cuda_ms(call, reps=3)
            chip_smoke.log(f"{label}: {times[label]} ms [{smi}]")
        label = f"ecntt {cname} 2^{logn} fwd"
        digests[label] = digest(*ecntt(cname, P, NTTDir.FORWARD))
        times[label] = chip_smoke.host_ms(lambda: ecntt(cname, P, NTTDir.FORWARD), reps=3)[0]
        chip_smoke.log(f"{label}: {times[label]} ms, host clock [{smi}]")
        del P, cut, scale_rows, stage_rows
        torch.cuda.empty_cache()
    return {"ms": times, "digest": digests, "ptxas": ptxas}


def b4_paths(csrc: str, smi: str) -> dict:
    import chip_smoke
    from icicle_tpu_torch.curves.group import get_group
    from icicle_tpu_torch.ops.msm import default_c, generic_plan

    reports = build.build_all(B4_LIBRARIES)
    has_wide = '#include "ec_wide.cuh"' in open(os.path.join(csrc, "ec_reduce.cu")).read()
    ptxas, counts = {}, {}
    for lib in B4_LIBRARIES:
        kernel = "wide_ec_reduce_kernel" if has_wide and lib != "ec_reduce" else "ec_reduce_kernel"
        found = sass.kernel_counts(build.lib_path(lib), kernel)
        if len(found) != 1:
            raise AssertionError(f"lib{lib}: {len(found)} kernels match {kernel}")
        c = next(iter(found.values()))["counts"]
        counts[lib] = {k: c.get(k, 0) for k in (*chip_smoke.SASS_KINDS, "BAR")}
        ptxas[lib] = (build.ptxas_kernels(reports[lib], (kernel,)) if lib in reports
                      else "not compiled in this run: the library was up to date")
        chip_smoke.log(f"lib{lib}: {reports[lib].splitlines()[-1] if lib in reports else ''}; "
                       f"ptxas {ptxas[lib]}; {kernel} SASS (static) {counts[lib]}")

    def g2_plan(cname: str) -> dict:
        n = 1 << chip_smoke.G2_PATH_LOGS[cname]
        return generic_plan(cname, n, default_c(n, g2=True), g2=True)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(20)
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
        checks, full = ([r for r in rows if r[0] == "ec_reduce"]
                        for rows in chip_smoke.plan_checks(g, plan, path))
        _, R, CR, role, _ = full[0]          # the cross-tile sum at full depth
        full += [("ec_reduce", R, CR, f"{role}, S {s}", {"_segments": s})
                 for s in B4_SEGMENTS if s <= R]
        rows = chip_smoke.check_msm_kernels(dev, gen, smi, g, checks, full)["ec_reduce"]
        for r in rows:
            if not r["checked"]:
                times[f"{path}: {r['role']}"] = r["kernel_ms"]
        torch.cuda.empty_cache()
    return {"ms": times, "ptxas": ptxas, "sass": counts}


def sponge_paths(smi: str) -> dict:
    import numpy as np

    import chip_smoke
    from icicle_tpu_torch.kernels import keccak_kernel as KK
    from icicle_tpu_torch.ops.pqc import ml_kem_tpu as D

    reports = build.build_all(["keccak"])
    ptxas = chip_smoke.lib_ptxas(reports, "keccak")
    found = sass.kernel_counts(build.lib_path("keccak"), "sponge_kernel")
    counts = {name: {k: v["counts"].get(k, 0) for k in ("total", "LOP3", "SHF", "STG", "LDG",
                                                       "STS", "LDS", "BAR")}
              for name, v in found.items()}
    chip_smoke.log(f"libkeccak: ptxas {ptxas}; sponge kernels' SASS (static) {counts}")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    times, digests = {}, {}
    rows = [(role, 1 << log_b, *rest) for role, log_b, *rest in chip_smoke.SPONGE_CHECKS]
    for role, batch, nbytes, rate, pad, outb in rows + [SPONGE_MATRIX]:
        data = torch.randint(0, 256, (batch, nbytes), generator=gen, device=dev,
                             dtype=torch.uint8)
        out = KK.keccak_sponge(data, rate, pad, outb)
        if not torch.equal(out[:CHECK_ROWS],
                           KK.keccak_sponge_ref(data[:CHECK_ROWS], rate, pad, outb)):
            raise AssertionError(f"{role}: != keccak_sponge_ref")
        label = f"{role}: {nbytes} -> {outb} bytes, batch {batch}"
        digests[label] = digest(out)
        times[label] = chip_smoke.cuda_ms(lambda: KK.keccak_sponge(data, rate, pad, outb))
        chip_smoke.log(f"{label}: {times[label]} ms [{smi}]")
        del data, out
    torch.cuda.empty_cache()

    B = 1 << MLKEM_LOG
    rng = np.random.default_rng(768)
    ent = torch.from_numpy(rng.integers(0, 256, (B, 64), dtype=np.uint8)).to(dev)
    msg = torch.from_numpy(rng.integers(0, 256, (B, 32), dtype=np.uint8)).to(dev)
    ek, dk = D.keygen("768", ent)
    c, K = D.encaps("768", msg, ek)
    for op, fn, outs in (("keygen", lambda: D.keygen("768", ent), (ek, dk)),
                         ("encaps", lambda: D.encaps("768", msg, ek), (c, K)),
                         ("decaps", lambda: D.decaps("768", c, dk), None)):
        label = f"ML-KEM-768 2^{MLKEM_LOG} {op}"
        KK.keccak_sponge.launches = 0
        got = fn()
        torch.cuda.synchronize()
        launches = KK.keccak_sponge.launches
        if op == "decaps" and not torch.equal(got, K):
            raise AssertionError(f"{label}: a decapsulated secret != the encapsulated one")
        digests[label] = digest(*(outs or (got,)))
        times[label] = chip_smoke.host_ms(fn, reps=3)[0]
        chip_smoke.log(f"{label}: {launches} sponge launches, {times[label]} ms, host clock "
                       f"[{smi}]")
    return {"ms": times, "digest": digests, "ptxas": ptxas, "sponge_sass": counts}


def ntt_wide_paths(smi: str) -> dict:
    import chip_smoke
    from icicle_tpu_torch import NTTDir, get_field, ntt
    from icicle_tpu_torch.kernels import ntt_kernel as K
    from icicle_tpu_torch.kernels import ntt_wide as NW

    libraries = tuple(lib for lib in ("ntt_wide", "ntt_wide_l12") if lib in build.LIBRARIES)
    reports = build.build_all(libraries)
    ptxas, counts = {}, {}
    for lib in libraries:
        ptxas[lib] = chip_smoke.lib_ptxas(reports, lib)
        found = sass.kernel_counts(build.lib_path(lib), "dif_rows_wide_kernel")
        counts[lib] = {name: {k: v["counts"].get(k, 0) for k in
                              ("total", "IMAD.WIDE", "IMAD", "IADD3", "LDS", "STS", "BAR", "LDL",
                               "STL")} for name, v in found.items()}
        chip_smoke.log(f"lib{lib}: {reports[lib].splitlines()[-1] if lib in reports else ''}; "
                       f"ptxas {ptxas[lib]}; SASS (static) {counts[lib]}")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    times, digests, plans = {}, {}, {}
    for fname, rows, log_n, pas, role in NTT_WIDE_SHAPES:
        f = get_field(fname)
        kind = NW.instance(f)
        if kind is None or log_n > NW.MAX_LOG_N.get(kind, 0):
            chip_smoke.log(f"{role}: skipped, this tree's wrapper has no plan for it")
            continue
        gen = torch.Generator(device=dev).manual_seed(21 + log_n)
        tin, factor_too = pas == "A", pas == "B"
        shape = (1 << log_n, rows) if tin else (rows, 1 << log_n)
        tw = K._stage_twiddles(f, log_n, pas == "A", dev)
        x = chip_smoke._with_edges(f, chip_smoke.field_elements(f, shape, gen, dev), dev)
        factor = chip_smoke.field_elements(f, shape, gen, dev) if factor_too else None

        def call():
            return NW.dif_rows_wide(f, x, tw, factor, transpose_in=tin, transpose_out=True)

        out = call()
        idx = torch.cat([torch.tensor([0, 1, rows - 1], device=dev),
                         torch.randperm(rows, generator=gen, device=dev)[:NTT_WIDE_CHECKED]])
        idx = idx.unique()
        pick = (lambda t: t[:, idx].contiguous()) if tin else (lambda t: t[idx].contiguous())
        want = NW.dif_rows_wide_ref(f, pick(x), tw, None if factor is None else pick(factor),
                                    transpose_in=tin, transpose_out=True)
        if not torch.equal(out[:, idx], want):
            raise AssertionError(f"{role}: != dif_rows_wide_ref at {idx.numel()} rows")
        digests[role] = digest(out.view(-1)[:NTT_WIDE_HASHED * max(1, f.nlimbs)])
        times[role] = chip_smoke.cuda_ms(call, reps=5)
        plans[role] = NW.wide_plan(rows, log_n, kind)
        ns = times[role] * 1e6 / (rows << log_n)
        chip_smoke.log(f"{role}: ({rows}, 2^{log_n}), plan {plans[role]}, exact at "
                       f"{idx.numel()} rows; {times[role]} ms, {ns:.4f} ns an element [{smi}]")
        if "_plan" in inspect.signature(NW.dif_rows_wide).parameters:
            for tr, cluster in NTT_WIDE_PLANS.get(role, ()):
                def other(tr=tr, cluster=cluster):
                    return NW.dif_rows_wide(f, x, tw, factor, transpose_in=tin,
                                            transpose_out=True, _plan=(tr, cluster))

                if not torch.equal(other(), out):
                    raise AssertionError(f"{role}: TR {tr}, cluster {cluster} != the plan's")
                label = f"{role}, TR {tr} cluster {cluster}"
                times[label] = chip_smoke.cuda_ms(other, reps=5)
                chip_smoke.log(f"{label}: {times[label]} ms [{smi}]")
        del x, factor, out
        torch.cuda.empty_cache()
    for fname, logn in NTT_WIDE_NTTS:
        f = get_field(fname)
        kind = NW.instance(f)
        if kind is None or logn - logn // 2 > NW.MAX_LOG_N.get(kind, 0):
            continue
        gen = torch.Generator(device=dev).manual_seed(logn)
        x = chip_smoke.field_elements(f, (1 << logn,), gen, dev)
        label = f"ntt {fname} 2^{logn} forward"
        digests[label] = digest(ntt(f, x, NTTDir.FORWARD))
        times[label] = chip_smoke.host_ms(lambda: ntt(f, x, NTTDir.FORWARD), reps=5)[0]
        chip_smoke.log(f"{label}: {times[label]} ms, host clock [{smi}]")
        del x
        torch.cuda.empty_cache()
    return {"ms": times, "digest": digests, "plan": plans, "ptxas": ptxas, "sass": counts}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", default=build.CSRC)
    ap.add_argument("--paths", choices=PATHS, default="b3")
    ap.add_argument("--against", metavar="FILE")
    return ap.parse_args(argv)


def mismatches(result: dict, other: dict) -> list:
    """The keys of `digest` that both runs have and whose hashes differ, and
    "poseidon2_limbs_sass" where both runs have it and it differs."""
    ours, theirs = result.get("digest", {}), other.get("digest", {})
    bad = [label for label in ours if label in theirs and ours[label] != theirs[label]]
    key = "poseidon2_limbs_sass"
    if key in result and key in other and result[key] != other[key]:
        bad.append(key)
    return bad


def main() -> None:
    args = parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tree_probe: needs a CUDA card")
    import chip_smoke

    csrc = os.path.abspath(args.csrc)
    if csrc != os.path.abspath(build.CSRC):
        build.CSRC = csrc
        build.BUILD_DIR = os.path.join(build.BUILD_DIR, "tree_probe",
                                       csrc.strip(os.sep).replace(os.sep, "_"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    chip_smoke.log(f"{smi}; {args.paths} built from {csrc}, run from {os.getcwd()}")
    result = {"b3": lambda: b3_paths(csrc, smi), "bases": lambda: bases_paths(smi),
              "gl64": lambda: gl64_paths(smi), "ecntt": lambda: ecntt_paths(smi),
              "b4": lambda: b4_paths(csrc, smi), "sponge": lambda: sponge_paths(smi),
              "ntt_wide": lambda: ntt_wide_paths(smi)}[args.paths]()
    if args.against:
        other = json.loads(open(args.against).read().strip().splitlines()[-1])
        bad = mismatches(result, other)
        if bad:
            raise AssertionError(f"{bad} differ from {args.against}'s run")
        for label, ms in result["ms"].items():
            chip_smoke.log(f"{label}: {ms} ms here, {other['ms'].get(label)} ms in "
                           f"{other['tree']} (outputs bit-equal) [{smi}]")
    print(json.dumps({"card": smi, "tree": os.getcwd(), "csrc": csrc, **result}))


if __name__ == "__main__":
    main()
