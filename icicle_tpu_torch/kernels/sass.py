"""Instruction counts of a built kernel library's machine code (SASS), read
with the CUDA toolkit's `cuobjdump -sass`.

    python -m icicle_tpu_torch.kernels.sass LIB REGEX [--blocks] [--path A:N,...]

prints, for every kernel whose mangled name matches REGEX, its static
instruction count by kind (`kind`: IMAD.WIDE, IMAD.HI and the IMAD forms
that do not multiply, IMAD.MOV, IMAD.SHL, IMAD.IADD, kept apart from
IMAD; every other opcode by its first word) and the number of branch
instructions, as one JSON line a kernel. For a kernel with no loop,
as the single-permutation Poseidon2 instances, that count is its count
per thread. --blocks also prints each basic block (split at labels, at
branch targets and after branches) with its start address, its counts
and its branch's target; --path sums the blocks weighted by how often one
thread runs each (A: a block's start address, N: its runs; blocks not
listed run 0 times), a thread's dynamic count where a kernel loops.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys

BRANCHES = ("BRA", "BRX", "JMP", "JMX", "CALL", "RET")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"\((\.L_x_\d+)\)|BRA\s+(?:`\()?(0x[0-9a-f]+)")


def cuobjdump() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return path if os.path.exists(path) else (shutil.which("cuobjdump") or "cuobjdump")


def kind(instr: str) -> str:
    """An instruction's kind: its opcode's first word, or its first two for
    IMAD (IMAD.WIDE, IMAD.HI, IMAD.MOV, ...)."""
    op = re.sub(r"^@!?U?P[T0-9]+\s+", "", instr).split()[0]
    parts = op.split(".")
    if parts[0] == "IMAD" and len(parts) > 1 and parts[1] in ("WIDE", "HI", "MOV", "SHL", "IADD"):
        return f"IMAD.{parts[1]}"
    return parts[0]


def functions(sass: str) -> dict[str, list]:
    """cuobjdump -sass text -> {mangled kernel name: [(address or label,
    instruction text or None for a label)]}."""
    out: dict[str, list] = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            cur.append((m.group(1), None))
            continue
        m = _INSTR.search(line)
        if m:
            cur.append((int(m.group(1), 16), m.group(2)))
    return out


def counts(instrs: list) -> dict:
    c = collections.Counter(kind(i) for _, i in instrs if i is not None)
    return dict(sorted(c.items()), total=sum(c.values()),
                branches=sum(c[b] for b in BRANCHES))


def _target(ins: str):
    m = _TARGET.search(ins)
    if not m:
        return None
    return m.group(1) or int(m.group(2), 16)


def blocks(instrs: list) -> list[dict]:
    """Basic blocks, split at labels, at branch targets and after branches:
    [{start (address or label), counts, branch_to (address or label, where
    the block ends in a branch)}] in address order."""
    targets = {_target(i) for _, i in instrs if i is not None and kind(i) in BRANCHES}
    out, cur, start, label = [], [], None, None

    def close(target=None):
        if cur:
            out.append({"start": start, "counts": counts(cur), "branch_to": target})

    for at, ins in instrs:
        if ins is None:                      # a label starts the next block
            close()
            cur, label = [], at
            continue
        if at in targets and cur:
            close()
            cur = []
        if not cur:
            start, label = label or at, None
        cur.append((at, ins))
        if kind(ins) in BRANCHES:
            close(_target(ins) or ins)
            cur = []
    close()
    return out


def weighted(blks: list[dict], runs: dict) -> dict:
    """Sum of the blocks' counts, each times runs[its start] (0 if absent)."""
    tot = collections.Counter()
    for b in blks:
        for k, v in b["counts"].items():
            tot[k] += runs.get(b["start"], 0) * v
    return dict(sorted(tot.items()))


def kernel_counts(lib: str, pattern: str, with_blocks: bool = False) -> dict:
    """{mangled name: counts (and blocks)} of the kernels in `lib` whose
    name matches `pattern`."""
    text = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    found = {}
    for name, instrs in functions(text).items():
        if re.search(pattern, name):
            found[name] = {"counts": counts(instrs)}
            if with_blocks:
                found[name]["blocks"] = blocks(instrs)
    return found


def main(argv: list[str]) -> None:
    if len(argv) < 2:
        sys.exit(__doc__)
    path = None
    if "--path" in argv:
        spec = argv[argv.index("--path") + 1]
        path = {int(a, 16): int(n) for a, n in (item.split(":") for item in spec.split(","))}
    found = kernel_counts(argv[0], argv[1], "--blocks" in argv or path is not None)
    if not found:
        sys.exit(f"no kernel in {argv[0]} matches {argv[1]!r}")
    for name, info in found.items():
        print(json.dumps({"kernel": name, **info["counts"]}))
        if path is not None:
            print(json.dumps({"kernel": name, "path": argv[argv.index("--path") + 1],
                              **weighted(info["blocks"], path)}))
        if "--blocks" in argv:
            for b in info["blocks"]:
                print(json.dumps({"block": b["start"], "branch_to": b["branch_to"],
                                  **b["counts"]}))


if __name__ == "__main__":
    main(sys.argv[1:])
