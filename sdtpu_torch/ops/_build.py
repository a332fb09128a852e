"""Build the port's CUDA kernels with nvcc at first use, and load them.

All of ``sdtpu_torch/csrc/*.cu`` compiles into one shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). The library lands in
``sdtpu_torch/_build/<hash>/libsdtpu_torch_kernels.so``, keyed by a hash of
the sources and the nvcc command, so an unchanged tree does not rebuild. A
failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libsdtpu_torch_kernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def nvcc_command(nvcc: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, sources())]


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / source_hash() / LIB_NAME


def build() -> Path:
    """Compile the library unless this source hash is already built."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name, then rename: a concurrent or cut build
    # never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(find_nvcc(), Path(tmp)),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}"
                f"{proc.stdout}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built library with every C signature declared (once per
    process)."""
    from sdtpu_torch.ops import attention

    lib = ctypes.CDLL(str(build()))
    attention.bind(lib)
    lib.sdtpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sdtpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def error_string(err: int) -> str:
    return library().sdtpu_cuda_error_string(err).decode()
