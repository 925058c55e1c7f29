"""kernels/tree_probe.py's command line and its output digests, on the CPU
(its paths run on a CUDA card only)."""

import hashlib

import pytest
import torch

from icicle_tpu_torch.kernels import build, tree_probe


@pytest.mark.parametrize("paths", tree_probe.PATHS)
def test_parse_args_takes_every_path(paths):
    args = tree_probe.parse_args(["--paths", paths, "--csrc", "build/parent/csrc",
                                  "--against", "a.json"])
    assert (args.paths, args.csrc, args.against) == (paths, "build/parent/csrc", "a.json")


def test_parse_args_defaults():
    args = tree_probe.parse_args([])
    assert (args.paths, args.csrc, args.against) == ("b3", build.CSRC, None)
    assert set(tree_probe.PATHS) == {"b3", "bases", "gl64", "ecntt", "b4", "sponge",
                                     "ntt_wide"}


def test_parse_args_refuses_an_unknown_path():
    with pytest.raises(SystemExit):
        tree_probe.parse_args(["--paths", "nope"])


def test_digest_hashes_the_bytes_in_order():
    """sha256 over each tensor's contiguous bytes, in argument order: a
    non-contiguous view hashes as its copy, and the order matters."""
    a = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    b = torch.tensor([-1, 2**31 - 1], dtype=torch.int32)
    want = hashlib.sha256(a.numpy().tobytes() + b.numpy().tobytes()).hexdigest()
    assert tree_probe.digest(a, b) == want
    assert tree_probe.digest(b, a) != want
    assert tree_probe.digest(a.T) == tree_probe.digest(a.T.contiguous())
    assert tree_probe.digest(a.T) != tree_probe.digest(a)
    c = a.clone()
    c[2, 3] += 1
    assert tree_probe.digest(c, b) != want


def test_mismatches_compare_the_labels_both_runs_have():
    """An older tree skips the widths its wrapper lacks: only labels both
    runs hashed are compared."""
    ours = {"digest": {"t=2": "aa", "t=16": "bb"}}
    assert tree_probe.mismatches(ours, {"digest": {"t=2": "aa"}}) == []
    assert tree_probe.mismatches(ours, {"digest": {"t=2": "ab"}}) == ["t=2"]
    sass = {"kernels": 12, "total": 5}
    assert tree_probe.mismatches({**ours, "poseidon2_limbs_sass": sass},
                                 {**ours, "poseidon2_limbs_sass": {**sass, "total": 6}}) \
        == ["poseidon2_limbs_sass"]
