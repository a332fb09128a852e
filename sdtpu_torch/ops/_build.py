"""Build the port's CUDA kernels with nvcc at first use, and load them.

Each of ``sdtpu_torch/csrc/*.cu`` compiles to an object file, all at once in
parallel nvcc processes; one more nvcc call links them into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). The library lands in
``sdtpu_torch/_build/<hash>/libsdtpu_torch_kernels.so``, keyed by a hash of
the sources and the nvcc flags, so an unchanged tree does not rebuild. A
failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libsdtpu_torch_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]


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


def compile_command(nvcc: str, src: Path, obj: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(nvcc: str, objs: list[Path], out: Path) -> list[str]:
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out), *map(str, objs)]


def headers() -> list[Path]:
    """Headers the sources include from their own directory."""
    return sorted(SRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / source_hash() / LIB_NAME


def _check(proc: subprocess.Popen, what: str) -> None:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what} ({proc.returncode}):\n"
                           f"{err}{out}")


def build() -> Path:
    """Compile the library unless this source hash is already built."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # objects and the library go to a temporary directory, then the library
    # is renamed into place: a concurrent or cut build never leaves a
    # half-written library under the final name
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        procs = [subprocess.Popen(compile_command(nvcc, src, obj),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(sources(), objs)]
        try:
            for src, proc in zip(sources(), procs):
                _check(proc, src.name)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lib = Path(tmp) / LIB_NAME
        _check(subprocess.Popen(link_command(nvcc, objs, lib),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True), "link")
        os.replace(lib, out)
    return out


def ptxas_report(src: Path) -> list[dict]:
    """Registers and spill bytes of every kernel of one source, as ``nvcc
    -Xptxas -v`` reports them; the object goes to a temporary directory.
    Names are demangled where the toolkit's ``cu++filt`` is at hand."""
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        cmd = compile_command(nvcc, src, Path(tmp) / "probe.o")
        proc = subprocess.run([*cmd, "-Xptxas", "-v"], capture_output=True,
                              text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    return parse_ptxas(proc.stderr + proc.stdout,
                       Path(nvcc).with_name("cu++filt"))


def parse_ptxas(text: str, filt: Path | None = None) -> list[dict]:
    """``[{"kernel", "registers", "spill_store_bytes", "spill_load_bytes"}]``
    from ptxas's verbose output, one entry per ``Compiling entry function``
    block."""
    rows = []
    for block in text.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          block)
        if filt is not None and filt.exists():
            out = subprocess.run([str(filt), name], capture_output=True,
                                 text=True).stdout.strip()
            name = out or name
        rows.append({"kernel": name,
                     "registers": int(regs.group(1)) if regs else None,
                     "spill_store_bytes": int(spill.group(1)) if spill else None,
                     "spill_load_bytes": int(spill.group(2)) if spill else None})
    return rows


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built library with every C signature declared (once per
    process)."""
    from sdtpu_torch.ops import attention, conv, groupnorm, matmul

    lib = ctypes.CDLL(str(build()))
    for module in (attention, conv, groupnorm, matmul):
        module.bind(lib)
    lib.sdtpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sdtpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


class NoBackwardError(RuntimeError):
    """A kernel without a backward was asked to run where autograd records
    the call: launched through ctypes, it would cut the graph and train the
    tensors before it with a zero gradient."""


def refuse_grad(what: str, *tensors) -> None:
    """Raise ``NoBackwardError`` if autograd would record a call of the
    kernel ``what`` on these tensors (None entries are skipped)."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NoBackwardError(
            f"{what} has no backward: it cannot run on a tensor that "
            f"requires grad (train with kernels 'plain' or 'cuda')")


def check_launch(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a cudaError_t other than
    0."""
    if err != 0:
        msg = library().sdtpu_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({msg})")
