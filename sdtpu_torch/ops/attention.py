"""Flash attention for the UNet's spatial self-attention and the VAE's mid
block: a hand-written CUDA kernel for Hopper (``csrc/flash_attn_fwd.cu``),
the counterpart of ``sdtpu/ops/attention.py:_flash_kernel``.

``flash_attention`` dispatches the way the JAX package does: short or
unaligned query sequences (the 77-token cross-attention, the 16x16 and 8x8
levels, CLIP) and anything that is not self-attention go to the plain
``layers.sdpa``; square problems of >= 512 tokens go to the kernel. On a CPU
tensor the kernel's plain version runs instead; on a CUDA tensor the kernel
launches or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from sdtpu_torch.models.layers import sdpa


def uses_kernel(sq: int, sk: int) -> bool:
    """The reference's dispatch rule (``sdtpu/ops/attention.py:224-238``,
    with ``CROSS_FLASH`` off): the kernel takes self-attention of at least
    512 tokens in multiples of 128."""
    if sq < 512 or sq % 128 != 0:
        return False
    return sq == sk


def flash_attention(q, k, v, heads: int):
    """Drop-in for ``layers.sdpa`` on [B, T, C] tensors."""
    if not uses_kernel(q.shape[1], k.shape[1]):
        return sdpa(q, k, v, heads)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, heads)
    return flash_attention_cuda(q, k, v, heads)


def flash_attention_reference(q, k, v, heads: int):
    """The kernel's plain version: heads split, float32 logits and softmax,
    the weights cast to q's dtype, P·V accumulated in float32."""
    return sdpa(q, k, v, heads, kernel="plain")


def flash_attention_cuda(q, k, v, heads: int):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    q: [B, Sq, C], k and v: [B, Sk, C], bf16, contiguous, on one CUDA
    device; head dim ``C // heads`` a multiple of 8 and at most 512. Raises
    on anything else. Counts its launches in ``flash_attention_cuda.launches``.
    """
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention_cuda takes [B, T, C] tensors")
    b, sq, c = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, c) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if heads <= 0 or c % heads:
        raise ValueError(f"{c} channels do not split into {heads} heads")
    d = c // heads
    if d % 8 or d > 512:
        raise ValueError(f"head dim {d} must be a multiple of 8 and <= 512")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got "
                             f"{t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if sq == 0 or sk == 0 or b == 0:
        raise ValueError("empty attention problem")
    from sdtpu_torch.ops import _build

    lib = _build.library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sdtpu_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, heads, sq, sk, d, stream)
    _build.check_launch(err, "flash_attn_fwd")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signature (every pointer and the stream as c_void_p,
    so ctypes does not cut them to 32 bits)."""
    fn = lib.sdtpu_flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
