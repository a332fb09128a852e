"""Error codes + per-context last-error tables.

Carried over unchanged from ``sdtpu/engine/errors.py`` (the JAX package):
the port cannot import it, because any ``import sdtpu.*`` imports JAX.

Python-native equivalent of the reference's error subsystem
(reference: errors.h:12-58, errors.cpp:8-81): a small stable ``ErrorCode``
enum, one exception type carrying code/reason/source-location, and a
per-context table remembering the last message per code so an embedding
API can introspect failures after the fact
(reference: libsdod.cpp:187-209 ``get_error_description`` /
``get_last_error_extra_info``). The C ABI mirror lives in csrc/.
"""

from __future__ import annotations

import enum
import inspect
import threading
from typing import Optional


class ErrorCode(enum.IntEnum):
    """Stable error codes (reference: errors.h:12-19 has 6 codes)."""

    NO_ERROR = 0
    INVALID_ARGUMENT = 1
    FAILED_ALLOCATION = 2
    RUNTIME_ERROR = 3
    INVALID_CONTEXT = 4
    INTERNAL_ERROR = 5

    def describe(self) -> str:
        return _DESCRIPTIONS[self]


_DESCRIPTIONS = {
    ErrorCode.NO_ERROR: "no error",
    ErrorCode.INVALID_ARGUMENT: "invalid argument",
    ErrorCode.FAILED_ALLOCATION: "allocation failed",
    ErrorCode.RUNTIME_ERROR: "runtime error",
    ErrorCode.INVALID_CONTEXT: "invalid context",
    ErrorCode.INTERNAL_ERROR: "internal error",
}


class ErrorTable:
    """Remembers the last extra-info message per error code, thread-safely
    (reference: errors.cpp:20-47)."""

    def __init__(self) -> None:
        self._last: dict[ErrorCode, str] = {}
        self._lock = threading.Lock()

    def record(self, code: ErrorCode, message: str) -> None:
        with self._lock:
            self._last[code] = message

    def last(self, code: ErrorCode) -> Optional[str]:
        with self._lock:
            return self._last.get(code)


#: Table for errors raised with no live context (reference: errors.cpp:25).
GLOBAL_ERROR_TABLE = ErrorTable()


class SdtpuError(Exception):
    """Exception carrying code/reason/source location
    (reference: errors.h:38-58 ``libsdod_exception``)."""

    def __init__(
        self,
        code: ErrorCode,
        reason: str,
        table: Optional[ErrorTable] = None,
    ) -> None:
        frame = inspect.stack()[1]
        self.code = ErrorCode(code)
        self.reason = reason
        self.func = frame.function
        self.file = frame.filename
        self.line = frame.lineno
        (table or GLOBAL_ERROR_TABLE).record(
            self.code, f"{reason} [{self.func} @ {self.file}:{self.line}]"
        )
        super().__init__(f"[{self.code.name}] {reason}")
