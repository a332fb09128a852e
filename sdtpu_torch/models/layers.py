"""Shared neural-net primitives, the PyTorch counterpart of
``sdtpu/models/layers.py``.

Conventions (the same as the JAX package's, so tests compare like with like):

* activations are NHWC at every function boundary. An NHWC-contiguous tensor
  is, in memory, an NCHW tensor in ``channels_last`` format: ``conv2d`` hands
  cuDNN that NCHW ``channels_last`` view and gets the same layout back, so no
  layout copy happens around a convolution;
* conv weights are OIHW in ``channels_last`` memory; dense weights are
  ``(in, out)`` and run as ``x @ w``;
* normalizations run in float32 whatever the activation dtype; matmuls and
  convs run in the activation dtype. In float32 this matches the JAX
  package's ``Precision.HIGHEST`` only with TF32 off for both cuBLAS and cuDNN
  (``disable_tf32``). In bf16 one difference is known and accepted: the JAX
  ``dense``/``conv2d`` add the bias in float32 before rounding to bf16, while
  a bf16 ``torch.matmul``/``conv2d`` rounds its product before the bias add;
* attention is ``[B, T, C]``; ``sdpa(..., kernel="cuda")`` routes to
  ``sdtpu_torch.ops.attention.flash_attention``, ``"plain"`` stays here.
"""

from __future__ import annotations

import contextvars
import math

import torch
import torch.nn.functional as F

from sdtpu_torch.ops import matmul as MM
from sdtpu_torch.parallel import collectives


def disable_tf32() -> None:
    """float32 matmuls and convs in full float32 (the JAX package runs f32
    at ``Precision.HIGHEST``; cuDNN convs default to TF32 otherwise)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# initializers (the JAX package's bounds; torch.Generator in place of keys)
# ---------------------------------------------------------------------------

def _uniform(shape, bound, generator, device):
    if torch.device(device).type == "meta":
        # a meta tensor holds no values: skip the draw and its arithmetic,
        # each a decomposed op there
        return torch.empty(shape, device=device, dtype=torch.float32)
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u * (2.0 * bound) - bound


def init_normal(shape, std, generator, device):
    """Draws of N(0, std^2) in float32; on the meta device, as
    ``_uniform``, no draw (there a normal draw is a decomposed op whose
    first call imports torch's compiler stack, seconds of a load)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device=device, dtype=torch.float32)
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32) * std


def kaiming_uniform(shape, fan_in, generator, device):
    """torch default init (kaiming_uniform with a=sqrt(5))."""
    bound = math.sqrt(1.0 / fan_in) * math.sqrt(3.0)
    return _uniform(shape, bound, generator, device)


def init_dense(d_in, d_out, generator, device, zero_init=False, bias=True):
    if zero_init:
        w = torch.zeros((d_in, d_out), device=device)
    else:
        w = kaiming_uniform((d_in, d_out), d_in, generator, device)
    if not bias:
        return {"w": w}
    if zero_init:
        return {"w": w, "b": torch.zeros((d_out,), device=device)}
    return {"w": w,
            "b": _uniform((d_out,), 1.0 / math.sqrt(d_in), generator, device)}


def init_conv(k, c_in, c_out, generator, device, zero_init=False):
    """OIHW weight in channels_last memory, plus bias."""
    shape = (c_out, c_in, k, k)
    fan_in = c_in * k * k
    if zero_init:
        w = torch.zeros(shape, device=device)
        b = torch.zeros((c_out,), device=device)
    else:
        w = kaiming_uniform(shape, fan_in, generator, device)
        b = _uniform((c_out,), 1.0 / math.sqrt(fan_in), generator, device)
    return {"w": w.contiguous(memory_format=torch.channels_last), "b": b}


def init_norm(c, device):
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device)}


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

#: when set (``sdtpu_torch.quant.ptq.calibrate``), the int8 dense path
#: reports each site's activation absmax by calling the recorder with
#: ``(w_q, absmax)``: ``w_q`` is the site's weight leaf, whose identity maps
#: to its place in the parameter tree, and ``absmax`` a 0-d tensor on the
#: activations' device (nothing is read on the host). A ContextVar, not a
#: module global, so a calibration never leaks its recorder into another
#: thread's or task's run (``sdtpu/models/layers.py:89-97``).
_CALIB_RECORDER: contextvars.ContextVar = contextvars.ContextVar(
    "sdtpu_torch_calib_recorder", default=None)


def set_calibration_recorder(rec):
    """Install or remove the calibration recorder; returns the previous
    one."""
    prev = _CALIB_RECORDER.get()
    _CALIB_RECORDER.set(rec)
    return prev


def _w8a8_kernel_ok(p, x) -> bool:
    """Route a calibrated (static ``x_scale``) int8 site through the W8A8
    kernel (``ops.matmul.matmul_w8a8``)? The reference's rule
    (``sdtpu/models/layers.py:100-131``): the opt-in flag
    ``ops.matmul.KERNEL_W8A8`` (off by default), only sites whose weight
    matrix is the larger stream (``n >= m``), and the kernel's own
    ``eligible``. Every other site keeps the library int8 product."""
    if "x_scale" not in p:
        return False
    if MM.DISABLE or not MM.KERNEL_W8A8:
        return False
    m = x.numel() // x.shape[-1] if x.shape[-1] else 0
    if p["w_q"].shape[1] < m:
        return False
    return MM.eligible(x, p["w_q"])


def _dense_int8(p, x, dtype):
    """W8A8 matmul with int32 accumulation (``sdtpu/models/layers.py:
    _dense_int8``). Weights: per-output-channel scales
    (``sdtpu_torch.quant.ptq``). Activations: the static per-tensor scale if
    calibrated (``x_scale``), else a per-row dynamic scale. Calibrated sites
    within ``_w8a8_kernel_ok`` run the W8A8 kernel, which quantizes the
    activations itself; elsewhere the int8 x int8 -> int32 product is
    ``ops.matmul.int8_matmul`` and ``y * xs * w_scale + b`` runs in float32,
    in that order."""
    xf = x.float()
    rec = _CALIB_RECORDER.get()
    if rec is not None:
        rec(p["w_q"], xf.abs().max())
    if rec is None and _w8a8_kernel_ok(p, x):
        return MM.matmul_w8a8(x.to(dtype), p["w_q"], p["w_scale"],
                              p["x_scale"], p.get("b")).to(dtype)
    if "x_scale" in p:
        xs = p["x_scale"]
    else:
        absmax = xf.abs().amax(dim=-1, keepdim=True)
        xs = torch.where(absmax == 0, torch.ones_like(absmax),
                         absmax / 127.0)
    y = MM.int8_matmul(MM.quantize_activation(xf, xs), p["w_q"]).float()
    y = y * xs * p["w_scale"].float()
    if "b" in p:
        y = y + p["b"].float()
    return y.to(dtype)


def _weight(p, dtype):
    """A site's weight: plain ``w``, or weight-only int8 ``w8`` times its
    per-output-channel ``w8_scale`` rounded to the compute dtype (the
    fallback of ``sdtpu/models/layers.py:172-180``; the kernels apply the
    float32 scale to their accumulator instead). The scale lies along the
    last axis of a dense ``(in, out)`` weight and the first of a conv's
    OIHW."""
    if "w8" in p:
        scale = p["w8_scale"].to(dtype)
        if p["w8"].dim() == 4:
            scale = scale[:, None, None, None]
        return p["w8"].to(dtype) * scale
    return p["w"].to(dtype)


def _int8w_gemm_ok(w8, x) -> bool:
    """Route a weight-only-int8 site through ``ops.matmul.matmul_int8w``?
    ``w8`` (int8 ``(in, out)``) being there is the opt-in
    (``quantize="int8w_dense"``); a site outside the kernel's contract
    dequantizes and takes the normal product."""
    return not MM.DISABLE and MM.eligible(x, w8)


def dense(p, x, dtype=None, reduce: bool = False):
    """``x @ w + b``, dispatched on the site's leaf names as
    ``sdtpu/models/layers.py:199-227``: ``w_q`` is a W8A8 site, ``w8`` a
    weight-only-int8 one, ``w`` a plain one. A site with a LoRA adapter
    (``lora_a`` [in, r], ``lora_b`` [r, out], ``lora_s``) adds ``(x A) B s``
    in the output's dtype to whichever of them ran (``lora_delta``).

    ``reduce``: a row-parallel site of the mesh (``parallel.sharding``):
    ``x`` and the weight hold this rank's slice of the input features, so
    the product and the LoRA delta are a partial sum, all-reduced over the
    model group in the output's dtype before the bias is added, once
    (``collectives.reduce_from_model``: under autograd its gradient passes
    through). In training only the UNet's sites run under grad: CLIP's,
    the VAE's and the time MLP's are frozen and run under ``no_grad``
    (``sdtpu_torch.train.step``), so their collectives never carry a
    gradient."""
    if reduce:
        y = dense({k: v for k, v in p.items() if k != "b"}, x, dtype)
        y = collectives.reduce_from_model(y)
        return y + p["b"].to(y.dtype) if "b" in p else y
    y = _dense_base(p, x, dtype)
    if "lora_a" in p:
        dt = y.dtype
        y = y + lora_delta(p, x.to(dt) @ p["lora_a"].to(dt))
    return y


def _weight_leaf(p):
    for f in ("w", "w_q", "w8"):
        if f in p:
            return p[f]
    raise KeyError(f"no dense weight among {sorted(p)}")


def split_of(p, full: int) -> int:
    """The model-axis split of a row-parallel site whose whole input is
    ``full`` features wide: ``full // (its input width)``, 1 where the
    site is whole (``parallel.sharding``)."""
    return full // _weight_leaf(p).shape[0]


def column_input(x, split: int):
    """The input of a column-parallel site group split ``split`` ways
    (``collectives.copy_to_model``: under autograd each rank's columns give
    their share of the input's gradient, summed over the model group); ``x``
    as it is where the sites are whole."""
    return collectives.copy_to_model(x) if split > 1 else x


def gather_columns(p, y):
    """A lone column-parallel site's output (the time MLP's ``fc1``, whose
    ``(D, D)`` weight holds this rank's output columns) gathered over the
    model group (under autograd, the gradient's backward keeps this rank's
    columns); ``y`` as it is where the site is whole."""
    w = _weight_leaf(p)
    if w.shape[1] == w.shape[0]:
        return y
    return collectives.gather_from_model(y, dim=-1)


def lora_delta(p, xa):
    """A LoRA site's delta from ``xa``, its input times ``lora_a`` (a
    product, or a conv for a conv site): ``(xa @ lora_b) * lora_s`` in
    ``xa``'s dtype, as ``sdtpu/models/layers.py:198-208, 282-289`` compute
    it, outside any kernel."""
    dt = xa.dtype
    return (xa @ p["lora_b"].to(dt)) * p["lora_s"].to(dt)


def _dense_base(p, x, dtype=None):
    dtype = dtype or x.dtype
    if "w_q" in p:
        return _dense_int8(p, x, dtype)
    if "w8" in p and _int8w_gemm_ok(p["w8"], x.to(dtype)):
        return MM.matmul_int8w(x.to(dtype), p["w8"], p["w8_scale"],
                               p.get("b"))
    y = x.to(dtype) @ _weight(p, dtype)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def conv2d(p, x, stride=1, padding=1, dtype=None):
    """3x3/1x1 conv, NHWC x OIHW -> NHWC (cuDNN sees NCHW channels_last).
    A weight-only-int8 1x1 conv (stride 1, no padding) is a matmul over
    ``[N*H*W, Cin]`` and goes to ``ops.matmul.matmul_int8w`` where that is
    eligible; any other ``w8`` conv dequantizes first
    (``sdtpu/models/layers.py:268-281``). A LoRA adapter (``lora_a`` an
    OIHW [r, in, kh, kw] down conv with the base's stride and padding,
    ``lora_b`` a [r, out] up mix) adds its delta on every path, the int8
    GEMM's too (the reference's returns before it there)."""
    dtype = dtype or x.dtype
    y = None
    if ("w8" in p and p["w8"].shape[-1] == 1 and p["w8"].shape[-2] == 1
            and stride == 1 and padding == 0):
        # OIHW [Cout, Cin, 1, 1] in channels_last memory is the (in, out)
        # weight in column-major memory
        w8 = p["w8"].reshape(p["w8"].shape[:2]).t()
        if _int8w_gemm_ok(w8, x.to(dtype)):
            y = MM.matmul_int8w(x.to(dtype), w8, p["w8_scale"], p.get("b"))
    if y is None:
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), _weight(p, dtype),
                     p["b"].to(dtype), stride=stride,
                     padding=padding).permute(0, 2, 3, 1)
    if "lora_a" in p:
        d = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), p["lora_a"].to(dtype),
                     stride=stride, padding=padding)
        y = y + lora_delta(p, d.permute(0, 2, 3, 1))
    return y


def layer_norm(p, x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def group_norm(p, x, groups, eps=1e-5, stats=None):
    """GroupNorm over channels-last x of shape [..., C], in float32 "ln
    form": each group's (spatial x C/G) slab is normalized like a LayerNorm
    (``sdtpu/models/layers.py:group_norm``). ``stats``: float32 [N, G, 2]
    of each (sample, group)'s mean and 1 / sqrt(var + eps), handed in
    where x is a slice of the plane (``parallel.spatial``)."""
    c = x.shape[-1]
    n = x.shape[0]
    xf = x.float().reshape(n, -1, groups, c // groups)
    if stats is None:
        mu = xf.mean(dim=(1, 3), keepdim=True)
        var = (xf - mu).square().mean(dim=(1, 3), keepdim=True)
        rstd = torch.rsqrt(var + eps)
    else:
        mu, rstd = (stats[..., i].float()[:, None, :, None] for i in (0, 1))
    y = ((xf - mu) * rstd).reshape(x.shape)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def group_norm_moments(x, groups):
    """float32 [N, G, 2]: each (sample, group)'s mean and sum of squared
    deviations (M2) over x's rows, two passes: a slice's partial
    statistics, which Chan's rule combines (``parallel.spatial``)."""
    c = x.shape[-1]
    xf = x.float().reshape(x.shape[0], -1, groups, c // groups)
    mu = xf.mean(dim=(1, 3), keepdim=True)
    m2 = (xf - mu).square().sum(dim=(1, 3))
    return torch.stack([mu[:, 0, :, 0], m2], dim=-1)


def silu(x):
    return x * torch.sigmoid(x)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def gelu(x):
    """Exact (erf) GELU, OpenCLIP's MLP activation
    (``jax.nn.gelu(approximate=False)``)."""
    return F.gelu(x, approximate="none")


def geglu(p, x, dtype=None):
    h = dense(p, x, dtype)
    a, b = torch.chunk(h, 2, dim=-1)
    return a * F.gelu(b, approximate="none")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _split_heads(x, heads):
    b, t, c = x.shape
    return x.reshape(b, t, heads, c // heads).transpose(1, 2)


def _attend(q, k, v, heads, mask=None):
    """Multi-head attention with float32 logits and softmax, the weights
    cast to q's dtype before P·V, float32 accumulation. bf16 inputs are
    widened to float32 for the products, which is exact, as JAX's
    ``preferred_element_type=float32`` is."""
    b, tq, c = q.shape
    d = c // heads
    qh, kh, vh = (_split_heads(a, heads).float() for a in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * (1.0 / math.sqrt(d))
    if mask is not None:
        logits = torch.where(mask, logits, torch.tensor(
            -1e9, dtype=torch.float32, device=logits.device))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", w.float(), vh)
    return o.to(q.dtype).transpose(1, 2).reshape(b, tq, c)


def sdpa(q, k, v, heads: int, kernel: str = "plain"):
    """Multi-head scaled-dot-product attention over [B, T, C] tensors.

    ``kernel="cuda"`` routes to ``sdtpu_torch.ops.attention.flash_attention``
    (the hand-written flash kernel on CUDA tensors, by the reference's
    dispatch rule); ``"plain"`` is this module's einsum path."""
    if kernel == "cuda":
        from sdtpu_torch.ops.attention import flash_attention

        return flash_attention(q, k, v, heads)
    return _attend(q, k, v, heads)


def causal_sdpa(q, k, v, heads: int):
    """Causal multi-head attention (CLIP text encoder)."""
    t = q.shape[1]
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    return _attend(q, k, v, heads, mask)


# ---------------------------------------------------------------------------
# time features
# ---------------------------------------------------------------------------

def timestep_features(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal timestep features: [cos | sin] halves, LDM convention."""
    half = dim // 2
    t = torch.as_tensor(t, dtype=torch.float32)
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
