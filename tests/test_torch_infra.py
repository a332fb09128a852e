"""The port's engine infrastructure (``sdtpu_torch.engine.logging`` and
``errors``): each case of the JAX package's ``tests/test_engine_infra.py``
on the port's modules, which carry the reference's over unchanged."""

import io
import threading

from sdtpu_torch.engine.errors import (GLOBAL_ERROR_TABLE, ErrorCode,
                                      ErrorTable, SdtpuError)
from sdtpu_torch.engine.logging import (Logger, LogLevel, active_logger, info,
                                       logger_scope)


def test_log_level_filtering():
    buf = io.StringIO()
    log = Logger(LogLevel.INFO, name="t", stream=buf)
    log.error("e1")
    log.info("i1")
    log.debug("d1")     # filtered
    log.abusive("a1")   # filtered
    out = buf.getvalue()
    assert "e1" in out and "i1" in out
    assert "d1" not in out and "a1" not in out
    # NOTHING silences everything including errors
    buf2 = io.StringIO()
    Logger(LogLevel.NOTHING, stream=buf2).error("x")
    assert buf2.getvalue() == ""


def test_thread_local_logger_scope():
    """Each thread's scoped logger wins on that thread only
    (reference: logging.cpp:21, 104-115)."""
    buf_a, buf_b = io.StringIO(), io.StringIO()
    results = {}

    def worker(name, buf):
        with logger_scope(Logger(LogLevel.INFO, name=name, stream=buf)):
            info(f"hello-{name}")
            results[name] = active_logger().name

    ta = threading.Thread(target=worker, args=("A", buf_a))
    tb = threading.Thread(target=worker, args=("B", buf_b))
    for t in (ta, tb):
        t.start()
    for t in (ta, tb):
        t.join()
    assert results == {"A": "A", "B": "B"}
    assert "hello-A" in buf_a.getvalue() and "hello-B" not in buf_a.getvalue()
    assert "hello-B" in buf_b.getvalue()


def test_logger_scope_restores_previous():
    outer = Logger(LogLevel.INFO, name="outer")
    inner = Logger(LogLevel.INFO, name="inner")
    with logger_scope(outer):
        assert active_logger().name == "outer"
        with logger_scope(inner):
            assert active_logger().name == "inner"
        assert active_logger().name == "outer"


def test_error_table_per_code_last_message():
    t = ErrorTable()
    try:
        raise SdtpuError(ErrorCode.RUNTIME_ERROR, "first", t)
    except SdtpuError:
        pass
    try:
        raise SdtpuError(ErrorCode.RUNTIME_ERROR, "second", t)
    except SdtpuError:
        pass
    try:
        raise SdtpuError(ErrorCode.INVALID_ARGUMENT, "arg", t)
    except SdtpuError:
        pass
    assert "second" in t.last(ErrorCode.RUNTIME_ERROR)
    assert "arg" in t.last(ErrorCode.INVALID_ARGUMENT)
    assert t.last(ErrorCode.FAILED_ALLOCATION) is None


def test_error_without_table_goes_global():
    try:
        raise SdtpuError(ErrorCode.INTERNAL_ERROR, "global-sentinel-xyz")
    except SdtpuError as e:
        assert e.code == ErrorCode.INTERNAL_ERROR
    assert "global-sentinel-xyz" in GLOBAL_ERROR_TABLE.last(
        ErrorCode.INTERNAL_ERROR)


def test_error_codes_describe():
    for code in ErrorCode:
        assert code.describe()
