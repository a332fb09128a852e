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
Inside it ``plan_conv`` chooses, from the shapes alone, between the source's
two kernels: the slab kernel (wgmma over a halo slab that is normalised
once; Cin % 64 == 0 and planes whose rows tile 128 pixels: every UNet and
VAE site) with its column tile and its split of the Cin chunks, or the
general kernel (any plane, Cin % 8 == 0) with ``splits_for``'s split-K. On a
CPU tensor the plain version runs instead; on a CUDA tensor a kernel
launches or the call raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sdtpu_torch.ops import groupnorm as G

_BIG = 2 ** 31            # the kernel indexes each tensor with 32-bit ints
_MAX_COUT_TILES = 65535   # 128-wide Cout tiles on the grid's y axis
_TILE, _BK = 128, 32      # the general kernel's tile (M and Cout), K step
_MAX_SPLITS = 16
# the slab kernel (csrc/conv_gn_silu.cu: SLAB_*, Shape, slab_smem)
_SLAB_PITCH = 144         # bytes of a slab row: 64 bf16 and 16 spare
_SLAB_MAX_ROWS = 400      # slab rows of one 64-channel group
_SLAB_MAX_SAMPLES = 8     # samples one block's 128 pixels may span
_SMEM_CAP = 227 * 1024    # a block's shared memory on sm_90
_PROLOGUE = {None: 0, "affine": 1, "silu": 2}
_COUNTERS: dict = {}      # device -> int32 per-tile counters, kept at 0


def splits_for(m: int, c_out: int, k: int, sms: int) -> int:
    """How many blocks share one output tile's K loop (split-K): as many as
    keep all blocks in one wave of the two an SM holds, at most
    _MAX_SPLITS, with at least 32 K steps (1,024 of K) per block, so the
    partials' write and sum stay small beside the products. Swept on the
    H100 at the SD1.5 UNet's 8x8-32x32 convs: the best count was within 5%
    of this rule's at each."""
    tiles = -(-m // _TILE) * -(-c_out // _TILE)
    steps = -(-k // _BK)
    return max(1, min(_MAX_SPLITS, 2 * sms // tiles, steps // 32))


def general_plan(m: int, c_in: int, c_out: int, ks: int, sms: int) -> dict:
    """The general kernel's plan: 128 x 128 output tiles, ``splits_for``'s
    split-K."""
    splits = splits_for(m, c_out, ks * ks * c_in, sms)
    return {"design": "general", "bn": _TILE, "splits": splits, "chunks": 0,
            "ph": 0, "pw": 0, "ns": 0,
            "blocks": -(-m // _TILE) * -(-c_out // _TILE) * splits, "smem": 0}


def slab_patch(h: int, w: int):
    """How the slab kernel's 128 consecutive output pixels lie in an h x w
    plane, as (rows, pixels a row, samples), or None where they do not tile
    it: a 128-pixel run of one row (w a multiple of 128), 128 / w whole rows
    of one sample (dividing h), or whole planes of up to
    ``_SLAB_MAX_SAMPLES`` samples (h w dividing 128)."""
    if w >= 128:
        return (1, 128, 1) if w % 128 == 0 else None
    if 128 % w:
        return None
    rows = 128 // w
    if h % rows == 0:
        return (rows, w, 1)
    if rows % h == 0 and rows // h <= _SLAB_MAX_SAMPLES:
        return (h, w, rows // h)
    return None


def slab_shape(ks: int):
    """(groups, steps, lead): a slab chunk holds ``groups`` runs of 64 input
    channels and is multiplied in up to ``steps`` steps of one weight tile
    each (the 9 taps of its one group, or the 3 groups of a 1x1 conv); the
    weight copies run ``lead`` steps ahead."""
    return (1, 9, 3) if ks == 3 else (3, 3, 2)


def slab_smem_bytes(bn: int, int8: bool, ks: int, rows: int, ns: int) -> int:
    """The slab kernel's dynamic shared memory (``slab_smem`` in the
    source): 1 KB of alignment slack, the weight tiles (lead + 2 of bf16
    weights; 3 widened and ``lead`` raw stages of int8), two slabs of
    ``groups * rows`` rows, two stages of the chunk's A and D, the table of
    the slab rows' pixels, the block's bias rows and scales."""
    groups, _, lead = slab_shape(ks)
    tiles = (3 if int8 else lead + 2) * bn * 128
    raw = lead * bn * 64 if int8 else 0
    slabs = 2 * groups * rows * _SLAB_PITCH
    ad = 2 * (2 * ns * groups * 64 * 4)
    table = (rows * 4 + 15) // 16 * 16
    return 1024 + tiles + raw + slabs + ad + table + ns * bn * 4 + bn * 4


def slab_plan(n: int, h: int, w: int, c_in: int, c_out: int, ks: int,
              sms: int, int8: bool = False):
    """The slab kernel's plan for a conv within its contract, else None
    (``plan_conv`` names the fields)."""
    patch = slab_patch(h, w)
    if c_in % 64 or patch is None:
        return None
    ph, pw, ns = patch
    pad = ks // 2
    rows = ns * (ph + 2 * pad) * (pw + 2 * pad)
    bn = 160 if c_out % 160 == 0 and c_out % 128 else 128
    smem = slab_smem_bytes(bn, int8, ks, rows, ns)
    if smem > _SMEM_CAP and bn == 160:
        bn, smem = 128, slab_smem_bytes(128, int8, ks, rows, ns)
    if rows > _SLAB_MAX_ROWS or smem > _SMEM_CAP:
        return None
    tiles = -(-n * h * w // _TILE) * -(-c_out // bn)
    chunks_all = -(-(c_in // 64) // slab_shape(ks)[0])
    splits = 1 if 2 * tiles > sms else min(chunks_all, sms // tiles)
    chunks = -(-chunks_all // splits)
    splits = -(-chunks_all // chunks)
    return {"design": "slab", "bn": bn, "splits": splits, "chunks": chunks,
            "ph": ph, "pw": pw, "ns": ns, "blocks": tiles * splits,
            "smem": smem}


def plan_conv(n: int, h: int, w: int, c_in: int, c_out: int, ks: int,
              sms: int, int8: bool = False) -> dict:
    """The static rule of ``fused_conv_cuda``: which kernel of
    ``csrc/conv_gn_silu.cu`` takes the conv, and how.

    * ``design``: ``"slab"`` where Cin % 64 == 0, the plane tiles into runs
      of 128 pixels (``slab_patch``: ``ph``, ``pw``, ``ns``), the slab has at
      most ``_SLAB_MAX_ROWS`` rows and the block's shared memory fits; else
      ``"general"`` (``general_plan``). A 1x1 conv whose blocks would walk
      more than two slab chunks un-split stays general too: each chunk
      costs a block a round trip to device memory that nothing hides (one
      block an SM), and the general kernel measured faster there (the
      UNet's 32x32 ``proj_in``).
    * ``bn``, the slab kernel's column tile: 160 where that divides Cout
      and 128 does not (Cout = 320 is two exact tiles) and fits, else 128.
    * ``splits`` and ``chunks``: Cin is walked in slab chunks (64 channels
      for 3x3, 192 for 1x1); where the output tiles would leave half of the
      SMs idle, the chunks are cut into ``splits`` runs of ``chunks`` each
      (the last may be shorter, none is empty), one block a run, and a second
      pass sums the float32 partial tiles in a fixed order.
    * ``blocks``: the grid's size; ``smem``: the slab kernel's dynamic
      shared memory a block (0 for the general kernel, whose launcher sizes
      its own).
    """
    plan = slab_plan(n, h, w, c_in, c_out, ks, sms, int8)
    if plan is None or (ks == 1 and plan["splits"] == 1
                        and plan["chunks"] > 2):
        return general_plan(n * h * w, c_in, c_out, ks, sms)
    return plan


def _tile_counters(device, tiles: int):
    """Zeroed int32 counters, one per output tile, kept per device: the
    kernel's last block of each tile resets its counter to 0."""
    have = _COUNTERS.get(device)
    if have is None or have.numel() < tiles:
        have = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = have
    return have


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
    slab = plan["design"] == "slab"
    ws = counters = None
    if plan["splits"] > 1:
        # float32 partial tiles; the general kernel's last block of a tile
        # sums them (a counter a tile), the slab kernel's second pass
        ws = torch.empty((plan["splits"], m, c_out), dtype=torch.float32,
                         device=x.device)
        if not slab:
            counters = _tile_counters(x.device, -(-m // _TILE)
                                      * -(-c_out // _TILE))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    prologue = _PROLOGUE[None if a is None else ("silu" if silu else
                                                 "affine")]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sdtpu_conv_gn_silu(
            x.data_ptr(), wk.data_ptr(), b.data_ptr(), ptr(a), ptr(d),
            ptr(w_scale), out.data_ptr(), ptr(ws), ptr(counters), n, h, ww,
            c_in, c_out, k, c_out if b.dim() == 2 else 0, prologue,
            int(quantized), int(slab), plan["bn"], plan["splits"],
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
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 16
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
