"""Per-context logging with thread-local activation, carried over from
``sdtpu/engine/logging.py`` (the JAX package's, standard library only).

Python-native equivalent of the reference's logger (reference:
logging.h:12-87, logging.cpp:17-115): 5 verbosity levels, a *thread-local
active logger* set by a context-manager scope guard so free functions
``info()/debug()/error()/abusive()`` route to the right per-context logger
across worker threads, and relative timestamps from logger creation.
"""

from __future__ import annotations

import enum
import sys
import threading
import time
from typing import Optional, TextIO


class LogLevel(enum.IntEnum):
    """(reference: logging.h:12-18)."""

    NOTHING = 0
    ERROR = 1
    INFO = 2
    DEBUG = 3
    ABUSIVE = 4


class Logger:
    def __init__(
        self,
        level: LogLevel = LogLevel.INFO,
        name: str = "sdtpu",
        stream: Optional[TextIO] = None,
    ) -> None:
        self.level = LogLevel(level)
        self.name = name
        self.stream = stream or sys.stderr
        self._t0 = time.perf_counter()

    def log(self, level: LogLevel, msg: str) -> None:
        if level > self.level or self.level == LogLevel.NOTHING:
            return
        dt = time.perf_counter() - self._t0
        self.stream.write(f"[{self.name} +{dt:9.3f}s {level.name:7s}] {msg}\n")

    def error(self, msg: str) -> None:
        self.log(LogLevel.ERROR, msg)

    def info(self, msg: str) -> None:
        self.log(LogLevel.INFO, msg)

    def debug(self, msg: str) -> None:
        self.log(LogLevel.DEBUG, msg)

    def abusive(self, msg: str) -> None:
        self.log(LogLevel.ABUSIVE, msg)


_tls = threading.local()
_default_logger = Logger(LogLevel.ERROR)


def active_logger() -> Logger:
    return getattr(_tls, "logger", None) or _default_logger


class logger_scope:
    """RAII-style activation of a per-context logger on this thread
    (reference: logging.cpp:104-115 ``ActiveLoggerScopeGuard``)."""

    def __init__(self, logger: Logger) -> None:
        self._logger = logger
        self._prev: Optional[Logger] = None

    def __enter__(self) -> Logger:
        self._prev = getattr(_tls, "logger", None)
        _tls.logger = self._logger
        return self._logger

    def __exit__(self, *exc) -> None:
        _tls.logger = self._prev


def error(msg: str) -> None:
    active_logger().error(msg)


def info(msg: str) -> None:
    active_logger().info(msg)


def debug(msg: str) -> None:
    active_logger().debug(msg)


def abusive(msg: str) -> None:
    active_logger().abusive(msg)
