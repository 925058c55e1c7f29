"""The port's messages cite ROADMAP.md's queue A by item number ("queue A
item N"), and item numbers are stable. Every citation must name an item
that is still open, and the item whose title is the citation's topic: the
words of the citing line and the line before it say which topic it is."""

import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "icicle_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
CITATION = re.compile(r"queue A item (\d+)")
# a citation's words -> the title its queue A item starts with
TOPICS = {
    "MSM long tail": ("Pippenger", "precompute", "GLV", "limb-count template"),
    "Extension towers": ("G2", "extension-field", "extension towers"),
    "Lattice and rings": ("rings", "rq_matmul"),
}


def queue_a() -> dict:
    """{item number: (title text, done)} of ROADMAP.md's queue A."""
    text = (ROOT / "ROADMAP.md").read_text()
    section = text[text.index("### A. Modules to port"):text.index("### B. ")]
    items = {}
    for m in re.finditer(r"^(\d+)\. (Done in PR \d+: )?(?:\*\*)?(.*)$", section, re.MULTILINE):
        items[int(m.group(1))] = (m.group(3), m.group(2) is not None)
    return items


def citations() -> list:
    """(file:line, cited item, the citing line and the line before it)."""
    out = []
    for path in SOURCES:
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            for m in CITATION.finditer(line):
                context = " ".join(lines[max(0, i - 1):i + 1])
                out.append((f"{path.relative_to(ROOT)}:{i + 1}", int(m.group(1)), context))
    return out


def test_queue_a_parses():
    items = queue_a()
    assert sorted(items) == list(range(1, 12))
    for topic in TOPICS:
        assert sum(title.startswith(topic) for title, _ in items.values()) == 1, topic


def test_every_citation_names_its_open_item():
    items = queue_a()
    found = citations()
    # the sites that still cite an open item (the B5-B7 instances took out
    # four refusals that cited queue A item 6; the NTT row kernel's 12-limb
    # instance one more, and glv.py no longer cites the ported ECNTT)
    assert len(found) >= 4
    for where, n, context in found:
        assert n in items and not items[n][1], f"{where}: item {n} is done or missing"
        topics = [t for t, words in TOPICS.items() if any(w in context for w in words)]
        assert len(topics) == 1, f"{where}: topic of {context!r}: {topics}"
        assert items[n][0].startswith(topics[0]), \
            f"{where}: cites item {n} ({items[n][0][:30]}) for {topics[0]}"
