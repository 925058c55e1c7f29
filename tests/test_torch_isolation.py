"""The port stands alone: icicle_tpu_torch and chip_smoke.py import neither
jax nor the JAX package, and the port does not quietly compute on the CPU
when no CUDA device exists."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from icicle_tpu_torch.runtime import device
from icicle_tpu_torch.runtime.errors import IcicleException

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_SOURCES = sorted((ROOT / "icicle_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|icicle_tpu)\b(?!_torch)|from\s+(jax|icicle_tpu)\b(?!_torch))",
    re.MULTILINE)


def test_import_leaves_no_jax_in_sys_modules():
    code = ("import sys, icicle_tpu_torch, icicle_tpu_torch.interop, "
            "icicle_tpu_torch.kernels.ntt_kernel, icicle_tpu_torch.ops.msm_tpu3, "
            "icicle_tpu_torch.kernels.msm_scan, icicle_tpu_torch.kernels.ec_reduce, "
            "icicle_tpu_torch.kernels.msm_scan_r12, icicle_tpu_torch.kernels.msm_fold2, "
            "icicle_tpu_torch.kernels.msm_kernel, icicle_tpu_torch.math.radix12, "
            "icicle_tpu_torch.ops.msm_tpu, icicle_tpu_torch.ops.msm_tpu2, "
            "icicle_tpu_torch.curves.montgomery, icicle_tpu_torch.ops.hash.poseidon2, "
            "icicle_tpu_torch.ops.merkle, icicle_tpu_torch.kernels.poseidon2_kernel, "
            "icicle_tpu_torch.ops.hash.poseidon, icicle_tpu_torch.kernels.poseidon_kernel, "
            "icicle_tpu_torch.ops.hash.blake2s, icicle_tpu_torch.kernels.blake2s_kernel, "
            "icicle_tpu_torch.ops.hash.blake3, icicle_tpu_torch.kernels.blake3_kernel, "
            "icicle_tpu_torch.ops.ecntt, icicle_tpu_torch.kernels.ecntt_kernel, "
            "icicle_tpu_torch.rings.babykoala, icicle_tpu_torch.rings.rq, "
            "icicle_tpu_torch.kernels.rq_ntt_kernel, icicle_tpu_torch.ops.lattice, "
            "icicle_tpu_torch.ops.pqc, icicle_tpu_torch.ops.pqc.ml_kem, "
            "icicle_tpu_torch.ops.pqc.ml_kem_tpu, icicle_tpu_torch.kernels.mlkem_kernel\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'icicle_tpu' or m.startswith('icicle_tpu.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    src = path.read_text()
    assert not _FORBIDDEN.findall(src), path


def test_scan_pattern_catches_imports():
    for line in ("import jax", "from jax import numpy", "import icicle_tpu",
                 "from icicle_tpu.ops import ntt", "  import jax.numpy as jnp"):
        assert _FORBIDDEN.search(line), line
    for line in ("import icicle_tpu_torch", "from icicle_tpu_torch.ops import ntt",
                 "# jax is the reference"):
        assert not _FORBIDDEN.search(line), line


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(device, "_device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(IcicleException, match="no CUDA device"):
        device.default_device()
    from icicle_tpu_torch.fields.field import get_field
    with pytest.raises(IcicleException, match="no CUDA device"):
        get_field("babybear").from_ints([1, 2, 3])


def test_msm_affine_raises_without_cuda(monkeypatch):
    """numpy inputs go to the default device: with no CUDA and no
    set_device("cpu"), the MSM raises instead of computing on the CPU."""
    import numpy as np

    from icicle_tpu_torch import msm_affine
    monkeypatch.setattr(device, "_device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scalars = np.zeros((4, 8), dtype=np.uint32)
    scalars[:, 0] = [1, 2, 3, 4]
    px = np.zeros((4, 8), dtype=np.uint32)
    px[:, 0] = 1
    py = np.zeros((4, 8), dtype=np.uint32)
    py[:, 0] = 2
    with pytest.raises(IcicleException, match="no CUDA device"):
        msm_affine("bn254", scalars, px, py)


def test_set_device_cpu(monkeypatch):
    monkeypatch.setattr(device, "_device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    device.set_device("cpu")
    assert device.default_device() == torch.device("cpu")


def test_slice_entry_points_raise_without_cuda(monkeypatch):
    """The ECNTT, R_q and ML-KEM entry points create their tensors on the
    default device: with no CUDA and no set_device("cpu") they raise
    instead of computing on the CPU."""
    import numpy as np

    from icicle_tpu_torch.ops import lattice
    from icicle_tpu_torch.ops.pqc import keygen
    from icicle_tpu_torch.rings.rq import rq_from_ints
    monkeypatch.setattr(device, "_device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(IcicleException, match="no CUDA device"):
        keygen("512", np.zeros((1, 64), dtype=np.uint8))
    with pytest.raises(IcicleException, match="no CUDA device"):
        rq_from_ints([[0] * 64])
    with pytest.raises(IcicleException, match="no CUDA device"):
        lattice.random_sampling(4, True, b"seed")
