"""Fused GroupNorm(+SiLU) for the UNet under ``kernels="cuda_gn"``: a
hand-written CUDA kernel for Hopper (``csrc/group_norm_silu.cu``), the
counterpart of ``sdtpu/ops/groupnorm.py:_gn_kernel``.

``fused_group_norm`` takes every GroupNorm whose shape fits the kernel's
contract (``uses_kernel``). The reference's gate (``sdtpu/ops/groupnorm.py:
129``: a plane of at most 4 MB and ``hw % 128 == 0``) is the TPU's VMEM
budget and tiling; the Hopper kernel reduces in a loop over the plane and
masks nothing, so it has neither limit. On a CPU tensor the kernel's plain
version runs instead; on a CUDA tensor the kernel launches or the call
raises.
"""

from __future__ import annotations

import ctypes

import torch

from sdtpu_torch.models.layers import group_norm, silu

# channels per group the kernel stages as per-channel scale and shift in
# shared memory (2 x 4 bytes each, within the 48 KB a block gets unasked)
MAX_CHANNELS_PER_GROUP = 4096
# the kernel's grid runs one 8-block cluster per (sample, group) on its y axis
MAX_SAMPLE_GROUPS = 65535


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
    """(n, hw, c, scale, bias, param_bf16) for a kernel launch on x, or
    raise: x bf16, contiguous, on a CUDA device, within ``uses_kernel``'s
    contract; ``p["scale"]`` and ``p["bias"]``: [C], both bf16 or both
    float32, contiguous, on x's device."""
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
    return (n, x.numel() // (n * c), c, scale, bias,
            int(scale.dtype == torch.bfloat16))


def group_norm_cuda(p, x, groups: int, eps: float = 1e-5,
                    fuse_silu: bool = False):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    x: [N, ..., C] and p as ``_checked`` takes them; raises on anything
    else. Counts its launches in ``group_norm_cuda.launches``."""
    n, hw, c, scale, bias, param_bf16 = _checked(p, x, groups)
    from sdtpu_torch.ops import _build

    lib = _build.library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sdtpu_group_norm_silu(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, hw, c, groups, float(eps), int(bool(fuse_silu)), param_bf16,
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
    else. Counts its launches in ``group_norm_affine_cuda.launches``."""
    n, hw, c, scale, bias, param_bf16 = _checked(p, x, groups)
    from sdtpu_torch.ops import _build

    lib = _build.library()
    a = torch.empty((n, c), dtype=torch.float32, device=x.device)
    d = torch.empty_like(a)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sdtpu_group_norm_affine(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), a.data_ptr(),
            d.data_ptr(), n, hw, c, groups, float(eps), param_bf16, stream)
    _build.check_launch(err, "group_norm_affine")
    group_norm_affine_cuda.launches += 1
    return a, d


group_norm_affine_cuda.launches = 0


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signatures (pointers and the stream as c_void_p)."""
    fn = lib.sdtpu_group_norm_silu
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.sdtpu_group_norm_affine
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
