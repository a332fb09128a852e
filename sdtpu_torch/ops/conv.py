"""Fused implicit-GEMM convolution for the UNet and VAE ResBlocks and the
transformer ``proj_in`` under ``kernels="cuda_conv"``: hand-written CUDA
kernels for Hopper (``csrc/conv_gn_silu.cu``), the counterpart of
``sdtpu/ops/conv.py``'s two Pallas kernels (``_conv_kernel`` and
``_conv_kernel_b``; their two grid orders are a TPU VMEM artefact, one
source takes both here).

The caller folds each GroupNorm into per-(sample, channel) vectors A and D
(``gn_affine``: one launch of the GroupNorm kernel's statistics mode on the
card, where the reference leaves it to XLA); the kernel
applies ``silu(x*A + D)`` while staging its input tile, adds a bias that may
differ per sample (the ResBlock's time-embedding add), and rounds once.

``eligible`` checks the source's own contract only: the reference's VMEM,
power-of-two and Mosaic gates (``sdtpu/ops/conv.py:120-173,192-201``) are the
TPU's. A conv outside it goes to ``layers.conv2d`` by that static rule.
Inside it ``plan_conv`` chooses, from the shapes alone, how the source's
one kernel tiles the conv: the slab kernel (wgmma over a halo slab that is
normalised once) takes every plane, with the 128 output pixels of a block a
patch, whole planes or a run of consecutive pixels, its column tile and its
split of the Cin chunks. On a CPU tensor the plain version runs instead; on
a CUDA tensor the kernel launches or the call raises.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from sdtpu_torch.ops import groupnorm as G

_BIG = 2 ** 31            # the kernel indexes each tensor with 32-bit ints
_MAX_COUT_TILES = 65535   # Cout tiles on the grid's y axis
_TILE = 128               # output pixels a block; eligible's Cout tile
# the slab kernel (csrc/conv_gn_silu.cu: SLAB_*, Shape, slab_smem)
_SLAB_PITCH = 144         # bytes of a slab row: 64 bf16 and 16 spare
_SLAB_MAX_ROWS = 400      # slab rows of one 64-channel group
_SLAB_MAX_SAMPLES = 8     # samples one block's 128 pixels may span
_SMEM_CAP = 227 * 1024    # a block's shared memory on sm_90
_PATCHES = ((1, 128), (2, 64), (4, 32), (8, 16), (16, 8))   # (ph, pw)
# plan_cost's constants, in slab rows staged and normalised, fitted to the
# slab kernel's times on an H100 under every tiling and split
# (tools/probe.py conv): one step of a block's products (64x64 x 320 3x3
# under each patch), and a block's own work, its tables, first slab and
# epilogue (the splits at 16x16 x 1280, 12x12 x 1280 and 48x48 x 640)
_STEP_ROWS = 35
_BLOCK_ROWS = 1000
_PROLOGUE = {None: 0, "affine": 1, "silu": 2}


def run_rows(w: int) -> int:
    """The rows of a plane of width ``w`` that a run of 128 consecutive
    pixels may span (``run_rows`` in the source): a run starts at a multiple
    of 128, so at a column that is a multiple of gcd(w, 128)."""
    return (w - math.gcd(w, 128) + 127) // w + 1


def conv_tilings(n: int, h: int, w: int):
    """Every way the slab kernel can lay its blocks' 128 output pixels over
    an n x h x w output, in ``plan_conv``'s order of preference, as
    ``(design, ph, pw, ns, blocks)``: ``ns`` whole planes (h w <= 128); a
    ph x pw patch of one sample (``_PATCHES``, the widest rows first; the
    patches at the plane's edge cut by it); a run of 128 consecutive pixels
    of one sample over ``run_rows(w)`` rows of the whole width. ``blocks``:
    how many tile the output."""
    out = []
    if h * w <= _TILE:
        ns = min(n, _TILE // (h * w), _SLAB_MAX_SAMPLES)
        out.append(("planes", h, w, ns, -(-n // ns)))
    out += [("patch", ph, pw, 1, n * -(-h // ph) * -(-w // pw))
            for ph, pw in _PATCHES]
    out.append(("run", run_rows(w), w, 1, n * -(-h * w // _TILE)))
    return out


def slab_shape(ks: int):
    """(steps, lead, buffers): a slab chunk of 64 input channels is
    multiplied in ``steps`` steps of one weight tile each (the 9 taps of a
    3x3 conv, the one of a 1x1), the weight copies run ``lead`` steps
    ahead, and the slabs run in a ring of ``buffers``."""
    return (9, 3, 2) if ks == 3 else (1, 4, 5)


def slab_smem_bytes(bn: int, int8: bool, ks: int, rows: int, ns: int) -> int:
    """The slab kernel's dynamic shared memory (``slab_smem`` in the
    source): 1 KB of alignment slack, the weight tiles (lead + 2 of bf16
    weights; 3 widened and ``lead`` raw stages of int8), ``buffers`` slabs
    of ``rows`` rows and as many stages of the chunk's A and D, the table of
    the slab rows' pixels, the block's bias rows and scales, the table of
    its 128 output pixels."""
    _, lead, bufs = slab_shape(ks)
    tiles = (3 if int8 else lead + 2) * bn * 128
    raw = lead * bn * 64 if int8 else 0
    slabs = bufs * rows * _SLAB_PITCH
    ad = bufs * (2 * ns * 64 * 4)
    table = (rows * 4 + 15) // 16 * 16
    return (1024 + tiles + raw + slabs + ad + table + ns * bn * 4 + bn * 4
            + _TILE * 4)


def slab_plan(n: int, h: int, w: int, c_in: int, c_out: int, ks: int,
              sms: int, int8: bool, tiling, splits=None):
    """The plan of one tiling of ``conv_tilings``, or None where its slab
    has more than ``_SLAB_MAX_ROWS`` rows or its block's shared memory
    does not fit (``plan_conv`` names the fields). ``splits``: the split
    rule's, or as many runs of Cin chunks as given (a probe's)."""
    design, ph, pw, ns, grid = tiling
    pad = ks // 2
    rows = ns * (ph + 2 * pad) * (pw + 2 * pad)
    bn = 160 if c_out % 160 == 0 and c_out % 128 else 128
    smem = slab_smem_bytes(bn, int8, ks, rows, ns)
    if smem > _SMEM_CAP and bn == 160:
        bn, smem = 128, slab_smem_bytes(128, int8, ks, rows, ns)
    if rows > _SLAB_MAX_ROWS or smem > _SMEM_CAP:
        return None
    tiles = grid * -(-c_out // bn)
    chunks_all = -(-c_in // 64)
    if splits is None:
        # the fewest runs of least plan_cost, within the kernel's 32-bit
        # indexing of the partials
        splits = min((s for s in range(1, chunks_all + 1)
                      if s == 1 or s * n * h * w * c_out < _BIG),
                     key=lambda s: (_cost(ks, rows, -(-tiles * s // sms),
                                          -(-chunks_all // s)), s))
    chunks = -(-chunks_all // splits)
    splits = -(-chunks_all // chunks)
    return {"design": design, "bn": bn, "splits": splits, "chunks": chunks,
            "ph": ph, "pw": pw, "ns": ns, "blocks": tiles * splits,
            "smem": smem}


def _cost(ks: int, rows: int, waves: int, chunks: int) -> int:
    return waves * (chunks * (slab_shape(ks)[0] * _STEP_ROWS + rows)
                    + _BLOCK_ROWS)


def plan_cost(plan: dict, ks: int, sms: int) -> int:
    """``plan_conv``'s estimate of a plan's time, in slab rows: waves of
    blocks (one block an SM) x (chunks a block x (a chunk's steps of
    products, each worth ``_STEP_ROWS`` rows, + the slab rows staged and
    normalised for it) + a block's own work, ``_BLOCK_ROWS``)."""
    pad = ks // 2
    rows = plan["ns"] * (plan["ph"] + 2 * pad) * (plan["pw"] + 2 * pad)
    return _cost(ks, rows, -(-plan["blocks"] // sms), plan["chunks"])


def plan_conv(n: int, h: int, w: int, c_in: int, c_out: int, ks: int,
              sms: int, int8: bool = False) -> dict:
    """The static rule of ``fused_conv_cuda``: how the slab kernel of
    ``csrc/conv_gn_silu.cu`` takes the conv.

    * ``design``, ``ph``, ``pw``, ``ns``: of the tilings of
      ``conv_tilings`` whose slab (``ns (ph + 2 pad)(pw + 2 pad)`` rows) has
      at most ``_SLAB_MAX_ROWS`` rows and whose block's shared memory fits,
      the one of least ``plan_cost``; of equals, the first in
      ``conv_tilings``' order. A wave of blocks costs as much whether every
      pixel of it is stored or not, so a cut patch may beat an exact
      tiling with a larger halo: 8 x 16 patches take SD 2.1 768's planes
      from 96^2 to 12^2 and a halo'd slice of 33 columns, 16 x 8 one of
      17; whole planes 8^2 and 8 x 5 at the CFG batch.
    * ``bn``, the column tile: 160 where that divides Cout and 128 does not
      (Cout = 320 is two exact tiles) and fits, else 128.
    * ``splits`` and ``chunks``: Cin is walked in slab chunks of 64
      channels (the last may be short), cut into ``splits`` runs of
      ``chunks`` each (the last may be shorter, none is empty), one block a
      run, where that lowers ``plan_cost`` (``slab_plan``: ten runs fill
      one wave with the 8x8 level's ten tiles, two save one of 48x48 x
      640's three); a second pass sums the float32 partial tiles in a
      fixed order.
    * ``blocks``: the grid's size; ``smem``: the block's dynamic shared
      memory.
    """
    best = None
    for tiling in conv_tilings(n, h, w):
        plan = slab_plan(n, h, w, c_in, c_out, ks, sms, int8, tiling)
        if plan is not None and (best is None or plan_cost(plan, ks, sms)
                                 < plan_cost(best, ks, sms)):
            best = plan
    return best


def _kernel_weight(w):
    """OIHW weight -> its [Cout, kh, kw, Cin] view, the kernel's operand
    (contiguous when ``w`` is in channels_last memory, as the port keeps
    conv weights)."""
    return w.permute(0, 2, 3, 1)


def eligible(x, w, stride: int, padding: int) -> bool:
    """Can ``fused_conv`` run this conv? x: [N, H, W, Cin] NHWC; w: OIHW.

    The kernel's contract: stride 1; 3x3 with pad 1 or 1x1 with pad 0;
    Cin % 8 == 0 (a 16-byte vector of the input never crosses a tap);
    contiguous x and weights in channels_last memory; every tensor under
    2^31 elements; bf16 activations. The dtype clause is the kernel's own:
    on a CPU tensor the plain version runs and takes any floating dtype, so
    the CPU tests take this route in float32. Each conv is checked against
    its own input (the reference checks a ResBlock's conv2 against the
    block's input, ``sdtpu/models/unet.py:230``)."""
    if x.dim() != 4 or w.dim() != 4 or stride != 1:
        return False
    c_out, c_in, kh, kw = w.shape
    if kh != kw or kh not in (1, 3) or padding != kh // 2:
        return False
    n, h, ww, xc = x.shape
    if xc != c_in or c_in % 8 or x.numel() == 0:
        return False
    if (x.numel() >= _BIG or n * h * ww * c_out >= _BIG or w.numel() >= _BIG
            or -(-c_out // _TILE) > _MAX_COUT_TILES):
        return False
    if not x.is_contiguous() or not _kernel_weight(w).is_contiguous():
        return False
    return x.device.type == "cpu" or x.dtype == torch.bfloat16


def fused_conv(x, w, b, *, a=None, d=None, silu=True, w_scale=None):
    """GN(+SiLU)-prologue implicit-GEMM conv, NHWC x OIHW -> NHWC, the
    contract of ``sdtpu/ops/conv.py:fused_conv``.

    x: [N, H, W, Cin]; w: [Cout, Cin, k, k] in x's dtype, or int8 with a
    per-output-channel ``w_scale`` [Cout]; b: [Cout] or per-sample
    [N, Cout]; a, d: optional prologue [N, Cin], ``xn = x*a + d`` (the
    GroupNorm folded by ``gn_affine``), then SiLU when ``silu``. 3x3 implies
    pad 1, 1x1 pad 0, stride 1. The caller checks ``eligible`` first."""
    if x.device.type == "cpu":
        return fused_conv_reference(x, w, b, a=a, d=d, silu=silu,
                                    w_scale=w_scale)
    return fused_conv_cuda(x, w, b, a=a, d=d, silu=silu, w_scale=w_scale)


def fused_conv_reference(x, w, b, *, a=None, d=None, silu=True,
                         w_scale=None):
    """The kernel's plain version: widen to float32, apply the prologue,
    round it to x's dtype (the kernel's product operand; exact in float32),
    convolve with zero padding (so the border is zero after the prologue),
    multiply by the weight scale, add the bias, round once to x's dtype."""
    z = x.float()
    if a is not None:
        z = z * a.float()[:, None, None, :] + d.float()[:, None, None, :]
        if silu:
            z = z * torch.sigmoid(z)
    z = z.to(x.dtype).float()
    y = F.conv2d(z.permute(0, 3, 1, 2), w.float(), padding=w.shape[-1] // 2)
    if w_scale is not None:
        y = y * w_scale.float()[None, :, None, None]
    b = b.float()
    y = y + (b[:, :, None, None] if b.dim() == 2 else b[None, :, None, None])
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def fused_conv_cuda(x, w, b, *, a=None, d=None, silu=True, w_scale=None):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    x bf16 and w bf16 (or int8 with ``w_scale``) within ``eligible``'s
    contract, on one CUDA device; b, a, d, w_scale as in ``fused_conv``
    (widened to float32 here). Raises on anything else. ``plan_conv``
    chooses the kernel and its tiling; the C entry point checks the plan.
    Counts its launches in ``fused_conv_cuda.launches``, those with int8
    weights also in ``fused_conv_cuda.launches_int8``. Raises
    ``_build.NoBackwardError`` where autograd would record the call."""
    from sdtpu_torch.ops import _build

    _build.refuse_grad("conv_gn_silu", x, w, b, a, d, w_scale)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    k = w.shape[-1] if w.dim() == 4 else 0
    if not eligible(x, w, 1, k // 2):
        raise ValueError(f"conv of x {tuple(x.shape)} with w "
                         f"{tuple(w.shape)} is outside the kernel's contract")
    n, h, ww, c_in = x.shape
    c_out = w.shape[0]
    quantized = w_scale is not None
    want = torch.int8 if quantized else torch.bfloat16
    if w.dtype != want:
        raise ValueError(f"w must be {want} here, got {w.dtype}")
    wk = _kernel_weight(w)
    if b.shape not in ((c_out,), (n, c_out)):
        raise ValueError(f"b must be [{c_out}] or [{n}, {c_out}], got "
                         f"{tuple(b.shape)}")
    b = b.float().contiguous()
    if (a is None) != (d is None):
        raise ValueError("a and d come together")
    if a is not None:
        if a.shape != (n, c_in) or d.shape != (n, c_in):
            raise ValueError(f"a and d must be [{n}, {c_in}]")
        a, d = a.float().contiguous(), d.float().contiguous()
    if quantized:
        if w_scale.shape != (c_out,):
            raise ValueError(f"w_scale must be [{c_out}]")
        w_scale = w_scale.float().contiguous()
    for name, t in (("w", wk), ("b", b), ("a", a), ("d", d),
                    ("w_scale", w_scale)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
    for name, t in (("x", x), ("w", wk), ("a", a), ("d", d)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    lib = _build.library()
    out = torch.empty((n, h, ww, c_out), dtype=x.dtype, device=x.device)
    m = n * h * ww
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = plan_conv(n, h, ww, c_in, c_out, k, sms, quantized)
    ws = None
    if plan["splits"] > 1:
        # float32 partial tiles, summed by the kernel's second pass
        ws = torch.empty((plan["splits"], m, c_out), dtype=torch.float32,
                         device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    prologue = _PROLOGUE[None if a is None else ("silu" if silu else
                                                 "affine")]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sdtpu_conv_gn_silu(
            x.data_ptr(), wk.data_ptr(), b.data_ptr(), ptr(a), ptr(d),
            ptr(w_scale), out.data_ptr(), ptr(ws), n, h, ww, c_in, c_out, k,
            c_out if b.dim() == 2 else 0, prologue, int(quantized),
            int(plan["design"] == "run"), plan["bn"], plan["splits"],
            plan["chunks"], plan["ph"], plan["pw"], plan["ns"], stream)
    _build.check_launch(err, "conv_gn_silu")
    fused_conv_cuda.launches += 1
    fused_conv_cuda.launches_int8 += int(quantized)
    return out


fused_conv_cuda.launches = 0
fused_conv_cuda.launches_int8 = 0


def gn_affine(p, x, groups: int, eps: float = 1e-5, stats=None):
    """Fold GroupNorm(x) into per-(sample, channel) float32 A, D [N, C] with
    ``group_norm(p, x) == x * A[n] + D[n]``, as ``sdtpu/ops/conv.py:
    gn_affine`` does: mean and variance over each group's (spatial, C/G)
    slab in float32, or ``stats`` (float32 [N, G, 2] mean and rstd of the
    whole plane, where x is a slice of it: ``parallel.spatial``). On a CUDA
    tensor within the GroupNorm kernel's contract, that kernel's statistics
    mode computes it in one launch (``groupnorm.group_norm_affine_cuda``);
    elsewhere the plain version."""
    if x.device.type == "cuda" and G.uses_kernel(x, groups):
        return G.group_norm_affine_cuda(p, x, groups, eps, stats)
    return gn_affine_reference(p, x, groups, eps, stats)


def gn_affine_reference(p, x, groups: int, eps: float = 1e-5, stats=None):
    """``gn_affine``'s plain version, in float32 torch ops."""
    c = x.shape[-1]
    cg = c // groups
    if stats is None:
        xf = x.float().reshape(x.shape[0], -1, groups, cg)
        var, mu = torch.var_mean(xf, dim=(1, 3), correction=0)  # [N, G]
        rstd = torch.rsqrt(var + eps)
    else:
        mu, rstd = stats[..., 0].float(), stats[..., 1].float()
    scale = p["scale"].float()[None, :]
    bias = p["bias"].float()[None, :]
    a = rstd.repeat_interleave(cg, dim=1) * scale
    d = bias - (mu * rstd).repeat_interleave(cg, dim=1) * scale
    return a, d


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signature (pointers and the stream as c_void_p)."""
    fn = lib.sdtpu_conv_gn_silu
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 16
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
