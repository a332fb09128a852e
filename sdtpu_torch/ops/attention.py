"""Flash attention for the UNet's spatial self-attention and the VAE's mid
block: a hand-written CUDA kernel for Hopper (``csrc/flash_attn_fwd.cu``),
the counterpart of ``sdtpu/ops/attention.py:_flash_kernel``, and its
backward (``csrc/flash_attn_bwd.cu``), the counterpart of
``sdtpu/ops/attention.py:_chunked_attn_bwd``.

``flash_attention`` dispatches the way the JAX package does: short or
unaligned query sequences (the 77-token cross-attention, the 16x16 and 8x8
levels, CLIP) and anything that is not self-attention go to the plain
``layers.sdpa``; square problems of >= 512 tokens go to the kernel where
they are within its contract (``uses_kernel``: on a card, bf16 and a head
dim it is built for), else to ``layers.sdpa`` too. On a CPU
tensor the kernel's plain version runs instead; on a CUDA tensor the kernel
launches or the call raises.

Under autograd (grad enabled and an input that requires it) a kernel call
goes through ``FlashSelf``, the counterpart of the reference's
``custom_vjp`` ``_flash_self``: its forward is the kernel with each row's
log-sum-exp saved, its backward the backward kernel (``plan_bwd``'s
contract, d <= 128); on the CPU the plain versions of both. A shape outside
the backward's contract takes the plain ``layers.sdpa``, which autograd
differentiates.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sdtpu_torch.models.layers import sdpa

#: the largest head dim of the backward kernel's contract
BWD_MAX_HEAD_DIM = 128


def needs_grad(*tensors) -> bool:
    """Would autograd record a call on these tensors?"""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def uses_kernel(q, k, v, heads: int) -> bool:
    """The dispatch rule on [B, T, C] tensors. The reference's clause
    (``sdtpu/ops/attention.py:224-238``, with ``CROSS_FLASH`` off): the
    kernel takes self-attention of at least 512 tokens in multiples of 128.
    Then the kernel's own contract, as ``flash_attention_cuda`` checks it: on
    a CUDA tensor bf16 q, k, v, contiguous, on one device, 16-byte aligned,
    a head dim that is a multiple of 8 and at most 512, at most 65535
    batch-heads. Under autograd (``needs_grad``) the backward kernel's
    contract too: a head dim of at most ``BWD_MAX_HEAD_DIM``. On a CPU
    tensor the plain versions run and take any floating dtype, as the other
    kernels' rules do; everything else goes to the plain ``layers.sdpa``."""
    sq, sk = q.shape[1], k.shape[1]
    if sq < 512 or sq % 128 != 0 or sq != sk:
        return False
    if q.device.type == "cpu":
        return True
    c = q.shape[-1]
    dmax = BWD_MAX_HEAD_DIM if needs_grad(q, k, v) else 512
    if heads <= 0 or c % heads or (c // heads) % 8 or c // heads > dmax:
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


# padded head dims the backward kernel is built for
BWD_DPADS = (16, 32, 48, 64, 80, 128)
# the lse2 and D scratch rows of the backward, padded to a multiple of this
BWD_SPAD = 64


def plan_bwd(d: int, s: int, batch_heads: int):
    """The backward launcher's static rule: ``(dpad, rows, bkv, bq)`` for a
    head dim ``d`` (a multiple of 8, at most 128). ``dpad``: the least of
    ``BWD_DPADS`` that holds ``d``, zero in shared memory only. ``rows``,
    the queries a dq block owns and the keys a dk/dv block owns: 128 (two
    warpgroups sharing each streamed tile) up to dpad 48, where two such
    blocks fit an SM's registers; 64 (one warpgroup) above, where the dk/dv
    kernel's two f32 accumulators take dpad registers a thread. ``bkv`` and
    ``bq``, the rows of the tile the dk/dv kernel (queries) and the dq
    kernel (keys) stream: 64 in general; 32 for dk/dv up to dpad 48 (so
    that its block keeps to 128 registers a thread) and for both at dpad
    128 (so that neither spills). Both kernels' grids are ``(ceil(s / rows),
    batch_heads)``. The C entry point takes all four and refuses a
    combination this rule does not give."""
    if d <= 0 or d % 8 or d > BWD_MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} must be a multiple of 8 and <= "
                         f"{BWD_MAX_HEAD_DIM}")
    if s <= 0 or batch_heads <= 0:
        raise ValueError("empty attention problem")
    dpad = next(p for p in BWD_DPADS if p >= d)
    return (dpad, 128 if dpad <= 48 else 64,
            32 if dpad <= 48 or dpad == 128 else 64,
            32 if dpad == 128 else 64)


def flash_attention(q, k, v, heads: int):
    """Drop-in for ``layers.sdpa`` on [B, T, C] tensors."""
    if not uses_kernel(q, k, v, heads):
        return sdpa(q, k, v, heads)
    if needs_grad(q, k, v):
        return FlashSelf.apply(q, k, v, heads)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, heads)
    return flash_attention_cuda(q, k, v, heads)


class FlashSelf(torch.autograd.Function):
    """Differentiable self-attention (``sdtpu/ops/attention.py:192-210``,
    ``_flash_self``): on a CUDA tensor the forward kernel, which also
    writes each row's log-sum-exp, and the backward kernel; on the CPU the
    plain versions of both. Saves q, k, v, the output and the statistics."""

    @staticmethod
    def forward(ctx, q, k, v, heads):
        if q.device.type == "cpu":
            out, lse = flash_attention_reference(q, k, v, heads), None
        else:
            out, lse = flash_attention_cuda(q, k, v, heads, with_lse=True)
        ctx.heads = heads
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "cpu":
            grads = flash_attention_bwd_reference(q, k, v, do, ctx.heads)
        else:
            grads = flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                             ctx.heads)
        return (*grads, None)


def flash_attention_reference(q, k, v, heads: int):
    """The kernel's plain version: heads split, float32 logits and softmax,
    the weights cast to q's dtype, P·V accumulated in float32."""
    return sdpa(q, k, v, heads, kernel="plain")


def flash_attention_bwd_reference(q, k, v, do, heads: int,
                                  chunk: int = 512):
    """The backward kernel's plain version, ``_chunked_attn_bwd``'s
    arithmetic: the softmax of each chunk of ``chunk`` queries recomputed
    over all keys in float32, dk and dv summed over the chunks, all math in
    float32; the gradients cast to each input's dtype."""
    b, s, c = q.shape
    d = c // heads
    scale = 1.0 / math.sqrt(d)

    def split(x):
        return (x.reshape(b, s, heads, d).transpose(1, 2)
                .reshape(b * heads, s, d).float())

    qh, kh, vh, doh = split(q), split(k), split(v), split(do)
    nc = s // chunk if (s % chunk == 0 and s > chunk) else 1
    cq = s // nc
    dk, dv, dq = torch.zeros_like(kh), torch.zeros_like(vh), []
    for i in range(nc):
        qi, doi = qh[:, i * cq:(i + 1) * cq], doh[:, i * cq:(i + 1) * cq]
        p = torch.softmax(torch.einsum("bqd,bkd->bqk", qi, kh) * scale,
                          dim=-1)
        dv += torch.einsum("bqk,bqd->bkd", p, doi)
        dp = torch.einsum("bqd,bkd->bqk", doi, vh)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq.append(torch.einsum("bqk,bkd->bqd", ds, kh) * scale)
        dk += torch.einsum("bqk,bqd->bkd", ds, qi) * scale

    def merge(x, ref):
        return (x.reshape(b, heads, s, d).transpose(1, 2)
                .reshape(b, s, c).to(ref.dtype))

    return merge(torch.cat(dq, dim=1), q), merge(dk, k), merge(dv, v)


def _check_bf16(named, like):
    for name, t in named:
        if t.device.type != "cuda" or t.device != like.device:
            raise ValueError(f"{name} must be on q's CUDA device, got "
                             f"{t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def flash_attention_cuda(q, k, v, heads: int, with_lse: bool = False):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    q: [B, Sq, C], k and v: [B, Sk, C], bf16, contiguous, on one CUDA
    device; head dim ``C // heads`` a multiple of 8 and at most 512. Raises
    on anything else. Counts its launches in ``flash_attention_cuda.launches``.

    ``with_lse`` (training, head dim at most ``BWD_MAX_HEAD_DIM``): also
    each row's natural-log log-sum-exp of the scaled logits, float32 [B *
    heads, Sq]; returns ``(out, lse)``.
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
    if with_lse and d > BWD_MAX_HEAD_DIM:
        raise ValueError(f"the statistics output takes head dims <= "
                         f"{BWD_MAX_HEAD_DIM}, got {d}")
    _check_bf16((("q", q), ("k", k), ("v", v)), q)
    if sq == 0 or sk == 0 or b == 0:
        raise ValueError("empty attention problem")
    if b * heads > 65535:
        raise ValueError(f"{b} x {heads} batch-heads exceed the grid's 65535")
    from sdtpu_torch.ops import _build

    lib = _build.library()
    out = torch.empty_like(q)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    dpad, rows, bkv = plan(d, sq, sk, b * heads, sms)
    lse = (torch.empty((b * heads, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if with_lse:
            err = lib.sdtpu_flash_attn_fwd_lse(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, heads, sq, sk, d, dpad, rows, bkv, stream)
        else:
            err = lib.sdtpu_flash_attn_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, heads, sq, sk, d, dpad, rows, bkv, stream)
    _build.check_launch(err, "flash_attn_fwd")
    flash_attention_cuda.launches += 1
    return (out, lse) if with_lse else out


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, out, lse, do, heads: int):
    """Launch the backward kernels (dq with D and lse2, then dk/dv) on
    ``torch.cuda.current_stream()``: ``(dq, dk, dv)``, bf16.

    q, k, v, out (the forward's output), do: [B, S, C] bf16, contiguous, on
    one CUDA device; lse: float32 [B * heads, S] from ``flash_attention_cuda
    (..., with_lse=True)``; head dim ``C // heads`` a multiple of 8 and at
    most ``BWD_MAX_HEAD_DIM``. Raises on anything else. Counts its calls in
    ``flash_attention_bwd_cuda.launches``."""
    if q.dim() != 3:
        raise ValueError("flash_attention_bwd_cuda takes [B, S, C] tensors")
    b, s, c = q.shape
    for name, t in (("k", k), ("v", v), ("out", out), ("do", do)):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} is not q's "
                             f"{tuple(q.shape)}")
    if heads <= 0 or c % heads:
        raise ValueError(f"{c} channels do not split into {heads} heads")
    d = c // heads
    if d % 8 or d > BWD_MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} must be a multiple of 8 and <= "
                         f"{BWD_MAX_HEAD_DIM}")
    _check_bf16((("q", q), ("k", k), ("v", v), ("out", out), ("do", do)), q)
    if (lse is None or lse.dtype != torch.float32 or lse.device != q.device
            or lse.shape != (b * heads, s) or not lse.is_contiguous()):
        raise ValueError(f"lse must be float32 [{b * heads}, {s}] on q's "
                         f"device")
    if s == 0 or b == 0:
        raise ValueError("empty attention problem")
    if b * heads > 65535:
        raise ValueError(f"{b} x {heads} batch-heads exceed the grid's 65535")
    from sdtpu_torch.ops import _build

    lib = _build.library()
    dpad, rows, bkv, bq = plan_bwd(d, s, b * heads)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    spad = -(-s // BWD_SPAD) * BWD_SPAD
    delta, lse2 = (torch.empty((b * heads, spad), dtype=torch.float32,
                               device=q.device) for _ in range(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sdtpu_flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), lse2.data_ptr(), b, heads, s,
            d, dpad, rows, bkv, bq, stream)
    _build.check_launch(err, "flash_attn_bwd")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signature (every pointer and the stream as c_void_p,
    so ctypes does not cut them to 32 bits)."""
    for name, pointers, ints in (("sdtpu_flash_attn_fwd", 4, 8),
                                 ("sdtpu_flash_attn_fwd_lse", 5, 8),
                                 ("sdtpu_flash_attn_bwd", 11, 8)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
