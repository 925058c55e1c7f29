"""ctypes loader for the host crypto library (counterpart of
icicle_tpu/utils/native.py; source native/host_crypto.cpp, shared with the
JAX package and compiled, not changed, here).

Fiat-Shamir transcript hashing (FRI, sumcheck) and proof-of-work grinding
are short serial host loops; the C++ library runs them. It is built at
first use with `g++ -O3 -shared` into icicle_tpu_torch/build/
libicicle_host.so (gitignored), through a temporary name that is then
renamed into place, so that processes building at once never load a
half-written file. There is no Python fallback: a failed build or load
raises BACKEND_LOAD_FAILED.
"""

from __future__ import annotations

import ctypes as C
import functools
import os
import shutil
import subprocess
import threading

from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException

# kind -> (host_crypto.cpp's hash id, digest bytes)
_KINDS = {"keccak_256": (0, 32), "keccak_512": (1, 64),
          "sha3_256": (2, 32), "sha3_512": (3, 64)}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "host_crypto.cpp")
LIBRARY = os.path.join(_PKG, "build", "libicicle_host.so")
_lock = threading.Lock()


def _failed(msg: str) -> IcicleException:
    return IcicleException(IcicleError.BACKEND_LOAD_FAILED, f"host crypto library: {msg}")


def build() -> None:
    """Compile native/host_crypto.cpp into LIBRARY unless it is there and
    newer than the source."""
    if os.path.exists(LIBRARY) and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE):
        return
    gxx = shutil.which("g++")
    if gxx is None:
        raise _failed("g++ not found")
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.{threading.get_ident()}.tmp"
    out = subprocess.run([gxx, "-O3", "-fPIC", "-shared", "-std=c++17", SOURCE, "-o", tmp],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise _failed(f"g++ failed:\n{out.stdout}{out.stderr}")
    os.replace(tmp, LIBRARY)


@functools.lru_cache(maxsize=1)
def _lib() -> C.CDLL:
    with _lock:
        build()
        try:
            lib = C.CDLL(LIBRARY)
        except OSError as e:
            raise _failed(str(e)) from e
    lib.icicle_host_hash.restype = C.c_int
    lib.icicle_host_hash.argtypes = [C.c_int, C.c_char_p, C.c_size_t, C.c_void_p, C.c_size_t]
    lib.icicle_host_pow.restype = C.c_int
    lib.icicle_host_pow.argtypes = [C.c_int, C.c_char_p, C.c_size_t, C.c_int, C.c_uint32,
                                    C.c_uint64, C.c_uint64, C.POINTER(C.c_uint64),
                                    C.POINTER(C.c_uint64)]
    return lib


def host_hash(kind: str, data: bytes) -> bytes:
    """Digest of `data` by the Keccak-family hash `kind` (a key of _KINDS)."""
    k, outlen = _KINDS[kind]
    out = C.create_string_buffer(outlen)
    if _lib().icicle_host_hash(k, data, len(data), out, outlen) != 0:
        raise IcicleException(IcicleError.UNKNOWN_ERROR, f"host hash {kind} failed")
    return out.raw


def keccak_256(data: bytes) -> bytes:
    return host_hash("keccak_256", data)


def keccak_512(data: bytes) -> bytes:
    return host_hash("keccak_512", data)


def sha3_256(data: bytes) -> bytes:
    return host_hash("sha3_256", data)


def sha3_512(data: bytes) -> bytes:
    return host_hash("sha3_512", data)


def host_pow(kind: str, challenge: bytes, solution_bits: int, padding: int = 24,
             start: int = 0, max_iters: int = 1 << 40) -> tuple[bool, int, int]:
    """The first nonce from `start` whose digest of challenge || u64 nonce
    (little-endian) || `padding` zero bytes has its first 8 bytes, read
    little-endian, below 2^(64 - solution_bits): (found, nonce, that
    value)."""
    nonce = C.c_uint64(0)
    mined = C.c_uint64(0)
    k, _ = _KINDS[kind]
    found = _lib().icicle_host_pow(k, challenge, len(challenge), solution_bits, padding, start,
                                   max_iters, C.byref(nonce), C.byref(mined))
    return bool(found), nonce.value, mined.value
