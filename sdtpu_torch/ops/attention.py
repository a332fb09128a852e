"""Flash attention for the UNet's spatial self-attention and the VAE's mid
block: a hand-written CUDA kernel for Hopper (``csrc/flash_attn_fwd.cu``),
the counterpart of ``sdtpu/ops/attention.py:_flash_kernel``.

``flash_attention`` dispatches the way the JAX package does: short or
unaligned query sequences (the 77-token cross-attention, the 16x16 and 8x8
levels, CLIP) and anything that is not self-attention go to the plain
``layers.sdpa``; square problems of >= 512 tokens go to the kernel where
they are within its contract (``uses_kernel``: on a card, bf16 and a head
dim it is built for), else to ``layers.sdpa`` too. On a CPU
tensor the kernel's plain version runs instead; on a CUDA tensor the kernel
launches or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from sdtpu_torch.models.layers import sdpa


def uses_kernel(q, k, v, heads: int) -> bool:
    """The dispatch rule on [B, T, C] tensors. The reference's clause
    (``sdtpu/ops/attention.py:224-238``, with ``CROSS_FLASH`` off): the
    kernel takes self-attention of at least 512 tokens in multiples of 128.
    Then the kernel's own contract, as ``flash_attention_cuda`` checks it: on
    a CUDA tensor bf16 q, k, v, contiguous, on one device, 16-byte aligned,
    a head dim that is a multiple of 8 and at most 512, at most 65535
    batch-heads. On a CPU tensor the plain version runs and takes any
    floating dtype, as the other kernels' rules do; everything else goes to
    the plain ``layers.sdpa``."""
    sq, sk = q.shape[1], k.shape[1]
    if sq < 512 or sq % 128 != 0 or sq != sk:
        return False
    if q.device.type == "cpu":
        return True
    c = q.shape[-1]
    if heads <= 0 or c % heads or (c // heads) % 8 or c // heads > 512:
        return False
    if q.shape[0] * heads > 65535 or k.shape != q.shape or v.shape != q.shape:
        return False
    return all(t.device == q.device and t.dtype == torch.bfloat16
               and t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v))


# padded head dims the kernel is built for; above 128 its two warpgroups
# split the output columns of one 64-row tile
DPADS = (16, 32, 48, 64, 80, 128, 256, 512)


def plan(d: int, sq: int, sk: int, batch_heads: int, sms: int):
    """The launcher's static rule: ``(dpad, rows, bkv)`` for a head dim
    ``d`` (a multiple of 8, at most 512). Every shape of the contract runs
    the wgmma kernel; the rule picks its instantiation.

    ``dpad``: the least of ``DPADS`` that holds ``d``; the rest is zero in
    shared memory only. ``rows``, the query rows a block takes: 128 (two
    warpgroups sharing each K/V tile) up to dpad 64, unless that leaves half
    the SMs without a block; 64 (one warpgroup) from dpad 80 on, where the
    accumulator's registers would hold an SM to one 256-thread block but
    let it keep two or three of 128 threads; 64 above d = 128 too, where
    the two warpgroups split the columns of one 64-row tile. ``bkv``, the
    keys a step takes: 64, and 32 at dpad 512, where a 64-row Q tile and two
    stages of K and V must fit 227 KB. The C entry point takes all three and
    refuses a combination this rule does not give. Any ``sq`` and ``sk``:
    ragged tiles are zero-filled and masked in the kernel, so the rule reads
    them only for the grid's size."""
    if d <= 0 or d % 8 or d > DPADS[-1]:
        raise ValueError(f"head dim {d} must be a multiple of 8 and <= 512")
    if sq <= 0 or sk <= 0:
        raise ValueError("empty attention problem")
    dpad = next(p for p in DPADS if p >= d)
    if dpad > 128:
        return dpad, 64, 32 if dpad == 512 else 64
    wide = dpad <= 64 and 2 * -(-sq // 128) * batch_heads >= sms
    return dpad, 128 if wide else 64, 64


def flash_attention(q, k, v, heads: int):
    """Drop-in for ``layers.sdpa`` on [B, T, C] tensors."""
    if not uses_kernel(q, k, v, heads):
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
    if b * heads > 65535:
        raise ValueError(f"{b} x {heads} batch-heads exceed the grid's 65535")
    from sdtpu_torch.ops import _build

    lib = _build.library()
    out = torch.empty_like(q)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    dpad, rows, bkv = plan(d, sq, sk, b * heads, sms)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sdtpu_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, heads, sq, sk, d, dpad, rows, bkv, stream)
    _build.check_launch(err, "flash_attn_fwd")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signature (every pointer and the stream as c_void_p,
    so ctypes does not cut them to 32 bits)."""
    fn = lib.sdtpu_flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
