"""Int8 GEMMs for the quantized serving modes: hand-written CUDA kernels for
Hopper, the counterparts of ``sdtpu/ops/matmul.py``'s two Pallas kernels.

* ``matmul_int8w`` (``csrc/matmul_int8w.cu``, for ``_mm_kernel``):
  ``y = (x @ bf16(w8)) * scale + bias``, weight-only int8 with one float32
  scale per output column, applied to the float32 accumulator;
* ``matmul_w8a8`` (``csrc/matmul_w8a8.cu``, for ``_mm_w8a8_kernel``):
  ``y = (q(x) @ w8) * (x_scale * w_scale) + bias``, the activations quantized
  inside the kernel with a static per-tensor scale, int8 x int8 -> int32.

Int8 dense weights are ``(in, out)`` like every dense weight, but kept in
column-major memory (``w.t()`` is contiguous, ``column_major`` makes one):
each output column's K run is contiguous, the B operand the tensor cores
want, so the kernels read the weights where they lie. A 1x1 conv's OIHW
weight in channels_last memory is the same bytes.

``eligible`` is the kernels' own contract, not the reference's: its
``_tiles`` and ``eligible`` encode TPU lane, sublane and VMEM limits. On a CPU
tensor each wrapper runs its kernel's plain version; on a CUDA tensor the
kernel launches or the call raises. Which kernel of a source takes a
product, its column tile and its split of K are static rules on the shapes:
``plan_int8w`` and ``plan_w8a8``, each checked by its C entry point.
"""

from __future__ import annotations

import ctypes

import torch

# escape hatch: route w8 dense sites through the dequant fallback, and
# calibrated int8 sites through the library int8 product
DISABLE = False
# opt-in for routing calibrated int8 dense sites (``w_q`` + ``x_scale``)
# through ``matmul_w8a8``; off by default, as in the reference
KERNEL_W8A8 = False

_BIG = 2 ** 31            # the kernels index each tensor with 32-bit ints
_MAX_N_TILES = 65535      # output-column tiles on the grid's y axis


def column_major(w):
    """A 2-D ``(in, out)`` weight in column-major memory: same shape, and
    ``w.t()`` is contiguous. Done once, where a weight is quantized or
    loaded, never per call."""
    return w.t().contiguous().t()


def eligible(x, w) -> bool:
    """Can ``matmul_int8w`` / ``matmul_w8a8`` run ``x @ w``? x: [..., K];
    w: int8 [K, N].

    The kernels' contract, with M the product of x's leading axes: any M >=
    1 and N >= 1 (ragged tiles are masked in the kernel, so the 154-row
    cross-attention k/v and the 2-row time-embedding dense qualify); K % 16
    == 0 (a 16-byte vector of int8 weights never crosses a row; the K tail
    past a multiple of the kernels' step is zero-filled); w in column-major
    memory and x contiguous; M*K, M*N and K*N under 2^31; bf16 activations.
    The dtype clause is the kernels' own: on a CPU tensor the plain version
    runs and takes any floating dtype, so the CPU tests take this route in
    float32."""
    if w.dim() != 2 or w.dtype != torch.int8 or x.dim() < 1:
        return False
    k, n = w.shape
    if x.shape[-1] != k or k % 16 or n == 0 or x.numel() == 0:
        return False
    m = x.numel() // k
    if (m * k >= _BIG or m * n >= _BIG or k * n >= _BIG
            or -(-n // 64) > _MAX_N_TILES):
        return False
    if not x.is_contiguous() or not w.t().is_contiguous():
        return False
    return x.device.type == "cpu" or x.dtype == torch.bfloat16


SKINNY_M = 16             # rows up to which K4 takes its skinny kernel
_BM, _BK = 128, 64        # K4's tile kernel: output rows, K depth of a step
_BK_W8A8 = 128            # K5's K depth of a step: one swizzled row of int8


def _tile_plan(m: int, k: int, n: int, sms: int, bk: int,
               bn: int = 0) -> dict:
    """The rule both wgmma GEMMs share: 128 rows a block; ``bn`` columns
    (unless given), 160 where that divides ``n`` and 128 does not, else 128;
    K walked in steps of ``bk``, cut into ``splits`` runs of ``steps`` (the
    last may be shorter, none is empty) where the output tiles would leave
    half of the SMs idle."""
    bn = bn or (160 if n % 160 == 0 and n % 128 else 128)
    tiles = -(-m // _BM) * -(-n // bn)
    steps_all = -(-k // bk)
    splits = 1 if 2 * tiles > sms else min(steps_all, sms // tiles)
    steps = -(-steps_all // splits)
    splits = -(-steps_all // steps)
    return {"path": "tile", "bn": bn, "splits": splits, "steps": steps,
            "blocks": tiles * splits}


def plan_int8w(m: int, k: int, n: int, sms: int) -> dict:
    """``matmul_int8w``'s static rule: which of the kernels of
    ``csrc/matmul_int8w.cu`` takes ``[m, k] @ [k, n]``, and how.

    * ``path``: ``"skinny"`` up to ``SKINNY_M`` rows (the ResBlocks'
      time-embedding dense: no tensor cores, ``ceil(n / 8)`` blocks stream
      the weights), else ``"tile"`` (wgmma, 128 rows a block).
    * ``bn``, the tile's columns: 160 where that divides ``n`` and 128 does
      not (n = 320 is two exact tiles), else 128; a ragged last tile is
      zero-filled and masked.
    * ``splits`` and ``steps``: K is walked in steps of 64; where the output
      tiles would leave half of the SMs idle, the steps are cut into
      ``splits`` runs of ``steps`` each (the last may be shorter, none is
      empty), one block a run, and a second pass sums the float32 partial
      tiles in a fixed order. ``splits == 1`` writes the output directly.
    * ``blocks``: the grid's size.
    """
    if m <= SKINNY_M:
        return {"path": "skinny", "bn": 0, "splits": 1, "steps": 0,
                "blocks": -(-n // 8) * -(-m // 4)}
    return _tile_plan(m, k, n, sms, _BK)


def plan_w8a8(m: int, k: int, n: int, sms: int) -> dict:
    """``matmul_w8a8``'s static rule, ``plan_int8w``'s tile rule with K
    walked in steps of 128 (one swizzled row of int8): ``bn`` columns a
    block, ``splits`` runs of ``steps`` K steps with int32 partial tiles and
    a sum pass where ``splits > 1``, ``blocks`` the grid's size. Where tiles
    of 256 columns divide ``n`` and still give every SM a block (ff1: n =
    5120, 10240), ``bn`` is 256 and a step 64 deep: quantizing an x tile
    costs more than the products of 128 columns, and every column tile
    repeats it. Every M takes the tile kernel (the layers send K5 no site
    of a few rows)."""
    if n % 256 == 0 and -(-m // _BM) * (n // 256) >= sms:
        return _tile_plan(m, k, n, sms, _BK_W8A8 // 2, bn=256)
    return _tile_plan(m, k, n, sms, _BK_W8A8)


# ---------------------------------------------------------------------------
# K4: weight-only int8
# ---------------------------------------------------------------------------

def matmul_int8w(x, w8, scale, bias=None):
    """``y = (x @ w8) * scale + bias`` over the trailing axis of x, the
    contract of ``sdtpu/ops/matmul.py:matmul_int8w``.

    x: [..., K] in the activation dtype; w8: int8 [K, N]; scale: [N] per
    output column; bias: [N] or None. Output in x's dtype. The caller checks
    ``eligible`` first."""
    if x.device.type == "cpu":
        return matmul_int8w_reference(x, w8, scale, bias)
    return matmul_int8w_cuda(x, w8, scale, bias)


def matmul_int8w_reference(x, w8, scale, bias=None):
    """The kernel's plain version: the int8 weights widened (exact), the
    product accumulated in float32, then the scale, then the bias, both in
    float32, and one rounding to x's dtype."""
    y = x.float() @ w8.float()
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _check_operands(x, w, vectors):
    """The checks both wrappers share; returns (m, k, n)."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    if not eligible(x, w):
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w.shape)} "
                         f"({w.dtype}) is outside the kernel's contract")
    k, n = w.shape
    for name, t in (("w", w),) + vectors:
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
    for name, t in vectors:
        if t is not None and t.shape != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(t.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    return x.numel() // k, k, n


def _f32(t):
    return None if t is None else t.float().contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def matmul_int8w_cuda(x, w8, scale, bias=None):
    """Launch the weight-only-int8 kernel on ``torch.cuda.current_stream()``.

    x bf16 and w8 int8 within ``eligible``'s contract, on one CUDA device;
    scale and bias [N] (widened to float32 here). Raises on anything else.
    Counts its calls that launched in ``matmul_int8w_cuda.launches``, and
    in ``matmul_int8w_cuda.sum_launches`` those of them that split K and so
    launched the sum pass as a second kernel. Raises
    ``_build.NoBackwardError`` where autograd would record the call."""
    from sdtpu_torch.ops import _build

    _build.refuse_grad("matmul_int8w", x, scale, bias)
    m, k, n = _check_operands(x, w8, (("scale", scale), ("bias", bias)))
    scale, bias = _f32(scale), _f32(bias)

    lib = _build.library()
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = plan_int8w(m, k, n, sms)
    partial = None
    if plan["splits"] > 1:
        partial = torch.empty((plan["splits"], m, n), dtype=torch.float32,
                              device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sdtpu_matmul_int8w(
            x.data_ptr(), w8.data_ptr(), scale.data_ptr(), _ptr(bias),
            out.data_ptr(), _ptr(partial), m, k, n,
            int(plan["path"] == "skinny"), plan["bn"], plan["splits"],
            plan["steps"], stream)
    _build.check_launch(err, "matmul_int8w")
    matmul_int8w_cuda.launches += 1
    matmul_int8w_cuda.sum_launches += plan["splits"] > 1
    return out


matmul_int8w_cuda.launches = 0
matmul_int8w_cuda.sum_launches = 0


# ---------------------------------------------------------------------------
# K5: static-scale W8A8
# ---------------------------------------------------------------------------

def quantize_activation(x, x_scale):
    """``clip(round(f32(x) * (1 / x_scale)), -127, 127)`` as int8: one
    float32 division, one multiply, round half to even."""
    inv = 1.0 / x_scale
    return torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)


def int8_matmul(xq, wq):
    """int8 [..., K] x int8 [K, N] -> exact int32 [..., N], outside any
    kernel of the port (the reference leaves this product to XLA). On the
    CPU an int32 matmul; on a CUDA device ``torch._int_mm`` within its shape
    limits (more than 16 rows, K and N multiples of 8), else a float64
    matmul, exact since |sum| <= 127^2 K < 2^53. Never float32: at K = 5120
    the sum passes 2^24."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    n = wq.shape[1]
    x2 = xq.reshape(-1, k)
    if xq.device.type == "cpu":
        y = x2.to(torch.int32) @ wq.to(torch.int32)
    elif x2.shape[0] > 16 and k % 8 == 0 and n % 8 == 0:
        y = torch._int_mm(x2, wq)
    else:
        y = (x2.double() @ wq.double()).to(torch.int32)
    return y.reshape(*lead, n)


def matmul_w8a8(x, w8, w_scale, x_scale, bias=None):
    """Static-scale W8A8 GEMM, ``y = (q(x) @ w8) * (x_scale * w_scale) +
    bias``, the contract of ``sdtpu/ops/matmul.py:matmul_w8a8``.

    x: [..., K] activations; w8: int8 [K, N] with per-output-column
    ``w_scale`` [N]; ``x_scale``: the per-tensor activation scale, a
    float32 scalar tensor (``quant.ptq.calibrate``); bias: [N] or None.
    Output in x's dtype. The caller checks ``eligible`` first."""
    if x.device.type == "cpu":
        return matmul_w8a8_reference(x, w8, w_scale, x_scale, bias)
    return matmul_w8a8_cuda(x, w8, w_scale, x_scale, bias)


def matmul_w8a8_reference(x, w8, w_scale, x_scale, bias=None):
    """The kernel's plain version: quantize with the static scale, an exact
    int32 product, one float32 factor ``x_scale * w_scale`` per column, the
    bias, one rounding to x's dtype."""
    x_scale = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device)
    acc = int8_matmul(quantize_activation(x, x_scale), w8).float()
    y = acc * (x_scale * w_scale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def matmul_w8a8_cuda(x, w8, w_scale, x_scale, bias=None):
    """Launch the W8A8 kernel on ``torch.cuda.current_stream()``.

    x bf16 and w8 int8 within ``eligible``'s contract, on one CUDA device;
    w_scale and bias [N] (widened to float32 here); x_scale a one-element
    tensor on that device, read by the kernel (never by the host). Raises on
    anything else. Counts its calls that launched in
    ``matmul_w8a8_cuda.launches``, and in ``matmul_w8a8_cuda.sum_launches``
    those of them that split K and so launched the sum pass as a second
    kernel. Raises ``_build.NoBackwardError`` where autograd would record
    the call."""
    from sdtpu_torch.ops import _build

    _build.refuse_grad("matmul_w8a8", x, w_scale, bias,
                       x_scale if torch.is_tensor(x_scale) else None)
    m, k, n = _check_operands(x, w8, (("w_scale", w_scale), ("bias", bias)))
    if not torch.is_tensor(x_scale) or x_scale.numel() != 1 or (
            x_scale.device != x.device):
        raise ValueError("x_scale must be a one-element tensor on x's device")
    w_scale, bias, x_scale = _f32(w_scale), _f32(bias), _f32(x_scale)

    lib = _build.library()
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = plan_w8a8(m, k, n, sms)
    partial = None
    if plan["splits"] > 1:
        partial = torch.empty((plan["splits"], m, n), dtype=torch.int32,
                              device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sdtpu_matmul_w8a8(
            x.data_ptr(), w8.data_ptr(), w_scale.data_ptr(),
            x_scale.data_ptr(), _ptr(bias), out.data_ptr(), _ptr(partial),
            m, k, n, plan["bn"], plan["splits"], plan["steps"], 0, stream)
    _build.check_launch(err, "matmul_w8a8")
    matmul_w8a8_cuda.launches += 1
    matmul_w8a8_cuda.sum_launches += plan["splits"] > 1
    return out


matmul_w8a8_cuda.launches = 0
matmul_w8a8_cuda.sum_launches = 0


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signatures (pointers and the stream as c_void_p)."""
    fn = lib.sdtpu_matmul_int8w
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.sdtpu_matmul_w8a8
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
