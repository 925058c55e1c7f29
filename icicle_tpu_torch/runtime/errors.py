"""Error model (reference: include/icicle/errors.h eIcicleError enum +
ICICLE_CHECK macros). Python surface uses exceptions; the enum survives for
FFI/status-return parity at the C boundary."""

from __future__ import annotations

import enum


class IcicleError(enum.IntEnum):
    SUCCESS = 0
    INVALID_DEVICE = 1
    OUT_OF_MEMORY = 2
    INVALID_POINTER = 3
    ALLOCATION_FAILED = 4
    DEALLOCATION_FAILED = 5
    COPY_FAILED = 6
    SYNCHRONIZATION_FAILED = 7
    STREAM_CREATION_FAILED = 8
    STREAM_DESTRUCTION_FAILED = 9
    API_NOT_IMPLEMENTED = 10
    INVALID_ARGUMENT = 11
    BACKEND_LOAD_FAILED = 12
    LICENSE_CHECK_ERROR = 13
    UNKNOWN_ERROR = 999


class IcicleException(RuntimeError):
    def __init__(self, code: IcicleError, message: str = ""):
        super().__init__(f"{code.name}: {message}" if message else code.name)
        self.code = code


def check(condition: bool, code: IcicleError, message: str = "") -> None:
    if not condition:
        raise IcicleException(code, message)
