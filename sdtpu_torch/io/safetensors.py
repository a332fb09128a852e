"""The safetensors file format, read and written with torch alone.

A file is an 8-byte little-endian header length ``n``, ``n`` bytes of JSON
header ``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (plus an
optional ``"__metadata__"`` of strings, which ``load_file`` skips,
``read_metadata`` returns and ``save_file`` writes where it is given),
then the tensors' raw little-endian bytes, the offsets counted from the
end of the header. The writer pads the
header with spaces to a multiple of 8 bytes and lays the tensors out by
element size, largest first, then by name, as the ``safetensors`` package
does, so each package reads the other's files and every tensor starts
aligned to its element size. ``StreamWriter`` writes the header from the
tensors' dtypes and shapes first, then takes the tensors one at a time.

The reader maps the file and views each tensor in place
(``torch.frombuffer``): a bfloat16 tensor never passes through numpy,
which has no bfloat16. A tensor read without ``device`` shares the mapped
pages until it is written to (the map is copy-on-write).
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path

import torch

#: the format's dtype names
DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
NAMES = {v: k for k, v in DTYPES.items()}
#: a header larger than this is not a safetensors file (the package's limit)
MAX_HEADER = 100_000_000


def _header(path: Path):
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", head)
        if n > MAX_HEADER:
            raise ValueError(f"{path}: header of {n} bytes is too large")
        return json.loads(f.read(n)), 8 + n


def load_file(path, device=None) -> dict:
    """{name: tensor} of every tensor in the file, in header order. With
    ``device`` each tensor is copied there as it is read; else it views the
    mapped file."""
    path = Path(path)
    header, start = _header(path)
    header.pop("__metadata__", None)
    size = path.stat().st_size
    with open(path, "rb") as f:
        mm = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
              if size > start else None)
    out = {}
    for name, info in header.items():
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name}: unsupported dtype "
                             f"{info['dtype']}")
        shape = tuple(int(s) for s in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        numel = 1
        for s in shape:
            numel *= s
        item = torch.empty((), dtype=dtype).element_size()
        if end - begin != numel * item or start + end > size:
            raise ValueError(f"{path}: {name}: offsets {begin}..{end} do "
                             f"not hold {shape} {info['dtype']}")
        if numel == 0:
            t = torch.empty(shape, dtype=dtype)
        elif (start + begin) % item:
            # not aligned to its element size: copy the bytes out
            t = torch.frombuffer(bytearray(mm[start + begin:start + end]),
                                 dtype=dtype).reshape(shape)
        else:
            t = torch.frombuffer(mm, dtype=dtype, count=numel,
                                 offset=start + begin).reshape(shape)
        out[name] = t if device is None else t.to(device)
    return out


def read_metadata(path) -> dict:
    """The file's ``__metadata__`` ({str: str}; empty where it has none)."""
    header, _ = _header(Path(path))
    return dict(header.get("__metadata__") or {})


def file_order(specs: dict) -> list:
    """The names of ``specs`` ({name: (dtype, shape)}) in the order a file
    lays them out: by element size, largest first, then by name."""
    def size(name):
        return torch.empty((), dtype=specs[name][0]).element_size()

    return sorted(specs, key=lambda n: (-size(n), n))


class StreamWriter:
    """A file written header first, from each tensor's dtype and shape
    ({name: (dtype, shape)}), then its tensors one at a time in
    ``file_order``: a caller that makes each tensor just before it is
    written (gathers it, converts it) never holds more than one.
    ``write(name, t)`` takes the next name of ``order``; ``close`` fails
    unless every tensor was written."""

    def __init__(self, path, specs: dict, metadata: dict | None = None):
        for name, (dtype, _) in specs.items():
            if dtype not in NAMES:
                raise ValueError(f"{name}: unsupported dtype {dtype}")
        self.specs = {n: (d, tuple(int(v) for v in s))
                      for n, (d, s) in specs.items()}
        self.order = file_order(self.specs)
        header = {} if metadata is None else {"__metadata__": {
            str(k): str(v) for k, v in metadata.items()}}
        offset = 0
        for name in self.order:
            dtype, shape = self.specs[name]
            numel = 1
            for v in shape:
                numel *= v
            nbytes = numel * torch.empty((), dtype=dtype).element_size()
            header[name] = {"dtype": NAMES[dtype], "shape": list(shape),
                            "data_offsets": [offset, offset + nbytes]}
            offset += nbytes
        raw = json.dumps(header, separators=(",", ":")).encode()
        raw += b" " * (-len(raw) % 8)
        self._next = 0
        self._f = open(path, "wb")
        self._f.write(struct.pack("<Q", len(raw)))
        self._f.write(raw)

    def write(self, name: str, t) -> None:
        """Write ``t`` (on any device, any memory layout) as ``name``, the
        next tensor of ``order``, copied to the host as it is written."""
        if self._next >= len(self.order) or name != self.order[self._next]:
            raise ValueError(f"{name}: written out of order (next: "
                             f"{self.order[self._next:self._next + 1]})")
        dtype, shape = self.specs[name]
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} where the "
                             f"header says {dtype} {shape}")
        if t.numel():
            host = t.detach().to("cpu").contiguous()
            self._f.write(host.reshape(-1).view(torch.uint8).numpy().data)
        self._next += 1

    def close(self) -> None:
        self._f.close()
        if self._next != len(self.order):
            raise ValueError(f"{len(self.order) - self._next} tensors of the "
                             f"header were not written")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            self._f.close()


def save_file(tensors: dict, path, metadata: dict | None = None) -> None:
    """Write {name: tensor} (on any device, any memory layout) to ``path``,
    with the format's optional ``__metadata__`` ({str: str}). Each tensor
    is copied to the host one at a time, as it is written."""
    for name, t in tensors.items():
        if not torch.is_tensor(t):
            raise TypeError(f"{name}: not a tensor ({type(t).__name__})")
    with StreamWriter(path, {n: (t.dtype, t.shape)
                             for n, t in tensors.items()}, metadata) as w:
        for name in w.order:
            w.write(name, tensors[name])
