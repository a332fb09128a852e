"""Fused GroupNorm(+SiLU) for the UNet under ``kernels="cuda_gn"``: a
hand-written CUDA kernel for Hopper (``csrc/group_norm_silu.cu``), the
counterpart of ``sdtpu/ops/groupnorm.py:_gn_kernel``, and its statistics
mode (``group_norm_affine_cuda``, the prologue operands of the fused conv).

``fused_group_norm`` takes every GroupNorm whose shape fits the kernel's
contract (``uses_kernel``). The reference's gate (``sdtpu/ops/groupnorm.py:
129``: a plane of at most 4 MB and ``hw % 128 == 0``) is the TPU's VMEM
budget and tiling; the Hopper kernel streams a plane too large for its
shared memory and masks nothing, so it has neither limit. ``plan_gn`` is
the launch's static rule, checked by the C entry points. On a CPU tensor the
kernel's plain version runs instead; on a CUDA tensor the kernel launches or
the call raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sdtpu_torch.models.layers import group_norm, silu

# channels per group the kernel takes (its span of whole groups, staged as
# per-channel scale and shift in shared memory)
MAX_CHANNELS_PER_GROUP = 4096
# (sample, span) pairs on the grid's y axis; a span holds at least one group
MAX_SAMPLE_GROUPS = 65535
# the kernel (csrc/group_norm_silu.cu: THREADS, MAX_CLUSTER, MAX_BUFS,
# gn_layout)
_THREADS = 256
_MAX_CLUSTER = 16
_MAX_BUFS = 2
_SMEM_CAP = 227 * 1024
# the resident rule, swept on the H100 at the UNet's 14 GroupNorm planes
# (tools/probe.py gn): the narrowest span whose rows fill a _SECTOR-byte
# sector; a cluster of one block per _ROWS rows up to _SMALL_CLUSTER, more
# where a block's tile would pass _TILE bytes, at most _BIG_CLUSTER (more
# blocks of fewer rows measured slower); at most _RESIDENT bytes of shared
# memory a block, so that two blocks share an SM and a 16-block cluster is
# co-scheduled with the others (one block an SM lets a GPC hold one such
# cluster: two waves). A streamed block's chunks: _CHUNK bytes through two
# buffers, three blocks an SM.
_ROWS = 256
_SMALL_CLUSTER = 8
_TILE = 64 * 1024
_BIG_CLUSTER = 12
_RESIDENT = 113 * 1024
_CHUNK = 32 * 1024
_SECTOR = 32


def gn_vec(c: int) -> int:
    """bf16 values a load or store of the kernel moves: 16 bytes, or 4 or 2
    where C is not a multiple of 8 (or of 2)."""
    return 8 if c % 8 == 0 else 2 if c % 2 == 0 else 1


def gn_smem_bytes(span: int, cpg: int, chunk: int, bufs: int) -> int:
    """The kernel's dynamic shared memory (``gn_layout`` in the source):
    ``bufs`` tiles of ``chunk`` rows x ``span`` bf16, each rounded up to 16
    bytes; a float per vector lane of each thread; the span's channel sums,
    folded scale and shift; six floats per group."""
    tile = -(-chunk * span * 2 // 16) * 16
    return bufs * tile + 4 * (_THREADS * 8 + 3 * span + 6 * (span // cpg))


def _layout(hw: int, span: int, cpg: int, cl: int, chunk=None) -> dict:
    """A cluster of ``cl`` blocks of ``rows`` rows: resident (one chunk of
    the rows), or with ``chunk`` given, chunks of that many rows through two
    buffers."""
    rows = -(-hw // cl)
    chunk = rows if chunk is None else min(rows, chunk)
    bufs = 1 if chunk == rows else _MAX_BUFS
    return {"cluster": cl, "rows": rows, "chunk": chunk, "bufs": bufs,
            "variant": "resident" if bufs * chunk >= rows else "streamed",
            "smem": gn_smem_bytes(span, cpg, chunk, bufs)}


def plan_gn(n: int, hw: int, c: int, groups: int, sms: int) -> dict:
    """The static rule of the kernel's launch, for both modes.

    * ``span``: the channels a block takes, whole groups and whole vectors
      (a multiple of lcm(C/G, ``vec``) dividing C): the narrowest whose row
      segment fills a 32-byte sector, which gives the most (sample, span)
      pairs and so the most blocks without a cluster.
    * ``cluster``: the blocks of one (sample, span), splitting its rows into
      runs of ``rows``; they combine their statistics through distributed
      shared memory. ``variant`` ``"resident"``: the block's rows stay in its
      shared memory (one ``chunk`` of ``rows``, ``bufs`` 1, at most
      ``_RESIDENT`` bytes), x is read once; one block per ``_ROWS`` rows up
      to ``_SMALL_CLUSTER`` (one block, no cluster, at the 16x16 and 8x8
      levels), more where a tile would pass ``_TILE`` bytes, at most
      ``_BIG_CLUSTER``. Swept on the H100 (``tools/probe.py gn``), the
      rule's per-image sums at the UNet's planes are within 2% (normalising)
      and 4% (statistics) of the best plan's at each (PERF.md, §6).
      ``"streamed"``: a plane no such cluster holds; spans widened while
      16-block clusters still fill the ``sms``, chunks of ``_CHUNK`` bytes
      through two buffers, and the normalising pass reads x again (the
      statistics mode does not).
    * ``smem``: the dynamic shared memory a block; ``grid``: (cluster, N x
      spans); ``blocks``: its size."""
    if n <= 0 or hw <= 0 or c <= 0 or groups <= 0 or c % groups:
        raise ValueError(f"no GroupNorm of [{n}, {hw}, {c}] in {groups} "
                         f"groups")
    cpg = c // groups
    vec = gn_vec(c)
    unit = math.lcm(cpg, vec)
    spans = [s for s in range(unit, c + 1, unit) if c % s == 0]
    first = next((s for s in spans if 2 * s >= _SECTOR), spans[-1])

    def result(span, plan):
        return {"span": span, "vec": vec, **plan,
                "grid": (plan["cluster"], n * (c // span)),
                "blocks": plan["cluster"] * n * (c // span)}

    cl = max(min(_SMALL_CLUSTER, hw // _ROWS), -(-hw * first * 2 // _TILE))
    plan = _layout(hw, first, cpg, max(1, min(_BIG_CLUSTER, hw, cl)))
    if plan["smem"] <= _RESIDENT:
        return result(first, plan)
    whole = [s for s in spans if 2 * s % 32 == 0] or spans
    span = max((s for s in whole if n * (c // s) * _MAX_CLUSTER >= sms),
               default=whole[0])
    cl = min(_MAX_CLUSTER, hw)
    return result(span, _layout(hw, span, cpg, cl,
                                max(1, _CHUNK // (2 * span))))


def uses_kernel(x, groups: int) -> bool:
    """The kernel's contract: channels-last x [N, ..., C] with C a multiple
    of ``groups``, at most MAX_CHANNELS_PER_GROUP channels per group,
    N * groups <= MAX_SAMPLE_GROUPS, under 2^31 elements per sample,
    contiguous, bf16. The dtype clause is the kernel's own: on a CPU tensor
    the plain version runs and takes any floating dtype, so the CPU tests
    take this route in float32."""
    if x.dim() < 3 or groups <= 0 or x.numel() == 0:
        return False
    c = x.shape[-1]
    if c % groups or c // groups > MAX_CHANNELS_PER_GROUP:
        return False
    if x.numel() // x.shape[0] >= 2 ** 31:
        return False
    if x.shape[0] * groups > MAX_SAMPLE_GROUPS or not x.is_contiguous():
        return False
    return x.device.type == "cpu" or x.dtype == torch.bfloat16


def fused_group_norm(p, x, groups: int, eps: float = 1e-5,
                     fuse_silu: bool = False):
    """Drop-in for ``silu(layers.group_norm(p, x, groups, eps))`` (SiLU only
    with ``fuse_silu``) on channels-last x [N, ..., C]."""
    if not uses_kernel(x, groups):
        y = group_norm(p, x, groups, eps)
        return silu(y) if fuse_silu else y
    if x.device.type == "cpu":
        return group_norm_reference(p, x, groups, eps, fuse_silu)
    return group_norm_cuda(p, x, groups, eps, fuse_silu)


def group_norm_reference(p, x, groups: int, eps: float = 1e-5,
                         fuse_silu: bool = False):
    """The kernel's plain version: ``layers.group_norm`` (float32 stats over
    each group's spatial x C/G slab, two-pass variance, affine), then SiLU
    in float32, rounded once to x's dtype."""
    y = group_norm(p, x.float(), groups, eps)
    return (silu(y) if fuse_silu else y).to(x.dtype)


def _checked(p, x, groups: int):
    """(n, hw, c, scale, bias, param_bf16, plan) for a kernel launch on x,
    or raise: x bf16, contiguous, on a CUDA device, within ``uses_kernel``'s
    contract; ``p["scale"]`` and ``p["bias"]``: [C], both bf16 or both
    float32, contiguous, on x's device. ``plan`` is ``plan_gn``'s for x on
    its device."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    if not uses_kernel(x, groups):
        raise ValueError(f"GroupNorm of {tuple(x.shape)} in {groups} groups "
                         f"is outside the kernel's contract")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    c = x.shape[-1]
    scale, bias = p["scale"], p["bias"]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (c,) or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{c}] tensor on "
                             f"{x.device}")
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"{name} must be bfloat16 or float32")
    if scale.dtype != bias.dtype:
        raise ValueError("scale and bias must share a dtype")
    n = x.shape[0]
    hw = x.numel() // (n * c)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return (n, hw, c, scale, bias, int(scale.dtype == torch.bfloat16),
            plan_gn(n, hw, c, groups, sms))


def group_norm_cuda(p, x, groups: int, eps: float = 1e-5,
                    fuse_silu: bool = False):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    x: [N, ..., C] and p as ``_checked`` takes them; raises on anything
    else. ``plan_gn`` tiles the launch; the C entry point checks the plan.
    Counts its launches in ``group_norm_cuda.launches``."""
    n, hw, c, scale, bias, param_bf16, plan = _checked(p, x, groups)
    from sdtpu_torch.ops import _build

    lib = _build.library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sdtpu_group_norm_silu(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, hw, c, groups, plan["span"], plan["cluster"], plan["chunk"],
            plan["bufs"], float(eps), int(bool(fuse_silu)), param_bf16,
            stream)
    _build.check_launch(err, "group_norm_silu")
    group_norm_cuda.launches += 1
    return out


group_norm_cuda.launches = 0


def group_norm_affine_cuda(p, x, groups: int, eps: float = 1e-5):
    """The kernel's statistics mode: GroupNorm(x) folded into float32
    A, D [N, C] with ``group_norm(p, x) == x * A[n] + D[n]``, the contract
    of ``sdtpu_torch.ops.conv.gn_affine`` (whose plain version is the
    reference). x and p as ``_checked`` takes them; raises on anything
    else; the launch as ``group_norm_cuda``'s. Counts its launches in
    ``group_norm_affine_cuda.launches``."""
    n, hw, c, scale, bias, param_bf16, plan = _checked(p, x, groups)
    from sdtpu_torch.ops import _build

    lib = _build.library()
    a = torch.empty((n, c), dtype=torch.float32, device=x.device)
    d = torch.empty_like(a)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sdtpu_group_norm_affine(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), a.data_ptr(),
            d.data_ptr(), n, hw, c, groups, plan["span"], plan["cluster"],
            plan["chunk"], plan["bufs"], float(eps), param_bf16, stream)
    _build.check_launch(err, "group_norm_affine")
    group_norm_affine_cuda.launches += 1
    return a, d


group_norm_affine_cuda.launches = 0


def co_resident(n: int, hw: int, c: int, groups: int, plan: dict,
                fuse_silu: bool = False) -> int:
    """How many of ``plan``'s clusters (blocks, where its cluster is 1) the
    current CUDA device holds at once (``cudaOccupancyMaxActiveClusters``):
    a grid of more runs in more than one wave. Raises on a plan the C entry
    point refuses."""
    from sdtpu_torch.ops import _build

    out = ctypes.c_int(0)
    err = _build.library().sdtpu_group_norm_clusters(
        n, hw, c, groups, plan["span"], plan["cluster"], plan["chunk"],
        plan["bufs"], int(bool(fuse_silu)), ctypes.addressof(out))
    _build.check_launch(err, "group_norm_clusters")
    return out.value


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signatures (pointers and the stream as c_void_p)."""
    fn = lib.sdtpu_group_norm_silu
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.sdtpu_group_norm_affine
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.sdtpu_group_norm_clusters
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
