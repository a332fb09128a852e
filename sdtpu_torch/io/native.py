"""ctypes bindings to the port's C API (``sdtpu_torch/capi``), the
counterpart of ``sdtpu/io/native.py``.

The library holds the host components (the CLIP BPE tokenizer, the DPM
solver) and the ``sdtpu.h`` engine facade, which embeds CPython and drives
``sdtpu_torch.Context``. ``build_library`` compiles it at first use with
``g++`` (one process a source, all at once) and the flags of
``python3-config --includes`` into
``sdtpu_torch/_build/capi/<hash>/libsdtpu.so``, keyed by a hash of the
sources and the flags. The library leaves CPython's symbols to the process
that loads it: a Python process (``load_library``) has them, whether its
interpreter is a shared ``libpython`` or built into the executable, and a
second copy of the interpreter would break the first. ``build_app`` builds
the test apps beside it, linked with ``python3-config --ldflags --embed``,
so that a C program embeds the interpreter. The engine's device is the
``SDTPU_TORCH_DEVICE`` environment variable (``DEVICE_VAR``), the card
when unset.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CAPI_DIR = PKG_DIR / "capi"
BUILD_DIR = PKG_DIR / "_build" / "capi"
LIB_NAME = "libsdtpu.so"
#: the environment variable that names the embedded Context's device
DEVICE_VAR = "SDTPU_TORCH_DEVICE"

CXXFLAGS = ["-std=c++20", "-O2", "-fPIC", "-fvisibility=hidden", "-Wall",
            "-Wextra", "-DSDTPU_EMBED_PYTHON"]

_lib: Optional[ctypes.CDLL] = None


def sources() -> list[Path]:
    return sorted((CAPI_DIR / "src").glob("*.cpp"))


def _inputs() -> list[Path]:
    """Every file a build reads (the hash's input)."""
    return sorted(p for p in CAPI_DIR.rglob("*") if p.is_file())


@functools.lru_cache(maxsize=None)
def python_flags() -> tuple[list[str], list[str]]:
    """(compile flags, link flags) that embed this interpreter, from
    ``python3-config`` beside ``sys.executable`` or on PATH; a host
    without it cannot build the C API."""
    exe = Path(sys.executable)
    cands = [exe.with_name(f"python{sys.version_info[0]}."
                           f"{sys.version_info[1]}-config"),
             exe.with_name("python3-config")]
    found = [str(c) for c in cands if c.exists()]
    tool = found[0] if found else shutil.which("python3-config")
    if tool is None:
        raise RuntimeError("python3-config not found: the C API cannot "
                           "embed this interpreter")
    flags = [subprocess.run([tool, *args], capture_output=True, text=True,
                            check=True).stdout.split()
             for args in (["--includes"], ["--ldflags", "--embed"])]
    return flags[0], flags[1]


def _hash() -> str:
    inc, ld = python_flags()
    h = hashlib.sha256(" ".join(CXXFLAGS + inc + ld).encode())
    for p in _inputs():
        h.update(str(p.relative_to(CAPI_DIR)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]], what: str) -> None:
    """Run the commands at once; raise with the compiler's output of the
    first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errors = []
    for c, p in zip(cmds, procs):
        out, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"{' '.join(c)}\n{err}{out}")
    if errors:
        raise RuntimeError(f"g++ failed on {what}:\n{errors[0]}")


def build_dir() -> Path:
    return BUILD_DIR / _hash()


def build_library() -> Path:
    """Compile ``libsdtpu.so`` unless this hash is built; the library is
    renamed into place, so a cut build never leaves half a file."""
    out = build_dir() / LIB_NAME
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    inc, _ = python_flags()
    flags = CXXFLAGS + [f"-I{CAPI_DIR / 'include'}",
                        f"-I{CAPI_DIR / 'src'}"] + inc
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / f"{s.stem}.o" for s in sources()]
        _run([["g++", *flags, "-c", str(s), "-o", str(o)]
              for s, o in zip(sources(), objs)], "the C API sources")
        lib = Path(tmp) / LIB_NAME
        _run([["g++", "-shared", *map(str, objs), "-o", str(lib)]],
             "the C API link")
        os.replace(lib, out)
    return out


def build_app(name: str, sanitize: Optional[str] = None) -> Path:
    """Build a test app of ``capi/test`` (``simple_app``, ``test_threads``)
    against the library, beside it; ``sanitize`` ("thread", ...) builds an
    instrumented copy of the library's sources into the app itself."""
    lib = build_library()
    src = next((CAPI_DIR / "test").glob(f"{name}.c*"))
    out = lib.parent / (name + (f"-{sanitize}" if sanitize else ""))
    if out.exists():
        return out
    inc, ld = python_flags()
    cc = "gcc" if src.suffix == ".c" else "g++"
    std = "-std=c11" if src.suffix == ".c" else "-std=c++20"
    cmd = [cc, std, "-Wall", f"-I{CAPI_DIR / 'include'}"]
    if sanitize:
        # the sanitizer instruments the library's code too: link its
        # sources in, with the C++ flags
        cmd = ["g++", "-std=c++20", "-Wall", f"-fsanitize={sanitize}",
               "-fno-omit-frame-pointer", "-g", "-O1",
               f"-I{CAPI_DIR / 'include'}", f"-I{CAPI_DIR / 'src'}", *inc,
               "-DSDTPU_EMBED_PYTHON", str(src), *map(str, sources()),
               "-Wl,--no-as-needed", *ld]
    else:
        cmd += [str(src), f"-L{lib.parent}", "-lsdtpu",
                f"-Wl,-rpath,{lib.parent}", "-Wl,--no-as-needed", *ld]
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_out = Path(tmp) / out.name
        _run([cmd + ["-o", str(tmp_out)]], name)
        os.replace(tmp_out, out)
    return out


def load_library(build: bool = True) -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = build_dir() / LIB_NAME
    if not path.exists():
        if not build:
            raise FileNotFoundError(f"{path} not built (build_library())")
        build_library()
    lib = ctypes.CDLL(str(path))

    lib.sdtpu_get_error_description.restype = ctypes.c_char_p
    lib.sdtpu_get_error_description.argtypes = [ctypes.c_int]
    lib.sdtpu_get_last_error_extra_info.restype = ctypes.c_char_p
    lib.sdtpu_get_last_error_extra_info.argtypes = [ctypes.c_int,
                                                    ctypes.c_void_p]

    lib.sdtpu_tokenizer_create.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.sdtpu_tokenizer_vocab_size.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.sdtpu_tokenizer_tokenize.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32)]
    lib.sdtpu_tokenizer_release.argtypes = [ctypes.c_void_p]

    lib.sdtpu_dpm_create.argtypes = [
        ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.sdtpu_dpm_prepare.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.sdtpu_dpm_model_ts.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int32]
    lib.sdtpu_dpm_update.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
    lib.sdtpu_dpm_release.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _check(status: int, lib, ctx=None):
    if status != 0:
        desc = lib.sdtpu_get_error_description(status).decode()
        extra = lib.sdtpu_get_last_error_extra_info(status, ctx)
        raise RuntimeError(
            f"libsdtpu: {desc}" + (f" ({extra.decode()})" if extra else ""))


class NativeTokenizer:
    """CLIP BPE through the C API: the ids of ``sdtpu_torch.Tokenizer``."""

    def __init__(self, flat_file: str | Path):
        self._lib = load_library()
        h = ctypes.c_void_p()
        _check(self._lib.sdtpu_tokenizer_create(
            str(flat_file).encode(), ctypes.byref(h)), self._lib)
        self._h = h

    @property
    def vocab_size(self) -> int:
        n = ctypes.c_int32()
        _check(self._lib.sdtpu_tokenizer_vocab_size(
            self._h, ctypes.byref(n)), self._lib)
        return n.value

    def tokenize(self, text: str, context_len: int = 77) -> list[int]:
        out = (ctypes.c_int32 * context_len)()
        _check(self._lib.sdtpu_tokenizer_tokenize(
            self._h, text.encode("utf-8"), context_len, out), self._lib)
        return list(out)

    def __del__(self):
        if getattr(self, "_h", None) and self._lib:
            self._lib.sdtpu_tokenizer_release(self._h)
            self._h = None


class NativeDpm:
    """DPM-Solver++(2M) through the C API: numerically the port's
    ``samplers.dpm``."""

    def __init__(self, train_steps=1000, lin_start=0.00085, lin_end=0.0120):
        self._lib = load_library()
        h = ctypes.c_void_p()
        _check(self._lib.sdtpu_dpm_create(
            train_steps, lin_start, lin_end, ctypes.byref(h)), self._lib)
        self._h = h
        self._steps = 0

    def prepare(self, steps: int) -> None:
        _check(self._lib.sdtpu_dpm_prepare(self._h, steps), self._lib)
        self._steps = steps

    def model_ts(self):
        import numpy as np

        out = np.zeros(self._steps, np.float32)
        _check(self._lib.sdtpu_dpm_model_ts(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._steps), self._lib)
        return out

    def update(self, step: int, x, eps):
        import numpy as np

        x = np.ascontiguousarray(x, np.float32)
        eps = np.ascontiguousarray(eps, np.float32)
        _check(self._lib.sdtpu_dpm_update(
            self._h, step,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            eps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            x.size), self._lib)
        return x

    def __del__(self):
        if getattr(self, "_h", None) and self._lib:
            self._lib.sdtpu_dpm_release(self._h)
            self._h = None
