"""The VAE, the counterpart of ``sdtpu/models/vae.py``.

Decoder: latent [B,h,w,4] -> RGB image in [-1, 1]: post-quant 1x1 conv,
conv_in to the widest width, middle (ResnetBlock, single-head attention,
ResnetBlock), one level per channel-mult in reverse with ``num_res_blocks +
1`` ResnetBlocks and nearest-2x upsample between levels, GroupNorm -> SiLU
-> conv_out.

Encoder (img2img, inpaint, ip2p): RGB [B,H,W,3] in [-1, 1] -> the diagonal
Gaussian posterior's (mean, logvar) [B,h,w,z]: conv_in, one level per
channel-mult with ``num_res_blocks`` ResnetBlocks and a stride-2 downsample
between levels, the same middle, GroupNorm -> SiLU -> conv_out to 2z
channels, the 1x1 quant conv.

GroupNorm eps is 1e-6 throughout."""

from __future__ import annotations

import torch.nn.functional as F

from sdtpu_torch.config import VAEConfig
from sdtpu_torch.models.layers import (
    conv2d,
    group_norm,
    init_conv,
    init_norm,
    sdpa,
    silu,
)
from sdtpu_torch.models.unet import (
    _norm_conv,
    _upsample_nearest,
    attention_kernel,
)


def _init_resblock(c_in, c_out, gen, dev):
    p = {
        "norm1": init_norm(c_in, dev),
        "conv1": init_conv(3, c_in, c_out, gen, dev),
        "norm2": init_norm(c_out, dev),
        "conv2": init_conv(3, c_out, c_out, gen, dev),
    }
    if c_in != c_out:
        p["nin"] = init_conv(1, c_in, c_out, gen, dev)
    return p


def _init_attn(c, gen, dev):
    return {
        "norm": init_norm(c, dev),
        "q": init_conv(1, c, c, gen, dev),
        "k": init_conv(1, c, c, gen, dev),
        "v": init_conv(1, c, c, gen, dev),
        "proj": init_conv(1, c, c, gen, dev),
    }


def init(cfg: VAEConfig, generator, device):
    gen, dev = generator, device
    widest = cfg.base_channels * cfg.channel_mult[-1]
    params = {
        "post_quant": init_conv(1, cfg.z_channels, cfg.z_channels, gen, dev),
        "conv_in": init_conv(3, cfg.z_channels, widest, gen, dev),
        "mid": {
            "res1": _init_resblock(widest, widest, gen, dev),
            "attn": _init_attn(widest, gen, dev),
            "res2": _init_resblock(widest, widest, gen, dev),
        },
    }
    up = []
    cur = widest
    for lvl in reversed(range(len(cfg.channel_mult))):
        out_ch = cfg.base_channels * cfg.channel_mult[lvl]
        blocks = []
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(_init_resblock(cur, out_ch, gen, dev))
            cur = out_ch
        level = {"blocks": blocks}
        if lvl != 0:
            level["up"] = init_conv(3, cur, cur, gen, dev)
        up.append(level)
    params["up"] = up
    params["norm_out"] = init_norm(cur, dev)
    params["conv_out"] = init_conv(3, cur, cfg.out_channels, gen, dev)
    return params


def init_encoder(cfg: VAEConfig, generator, device):
    """The encoder's parameters (``sdtpu/models/vae.py:init_encoder``):
    conv_in, per-level ResnetBlocks with a stride-2 downsample conv between
    levels, middle (ResnetBlock, attention, ResnetBlock), GroupNorm ->
    conv_out to 2 * z channels (mean, logvar), the 1x1 quant conv. Every SD
    checkpoint carries them; ``apply_encoder`` runs them."""
    gen, dev = generator, device
    params = {"conv_in": init_conv(3, cfg.out_channels, cfg.base_channels,
                                   gen, dev)}
    down = []
    cur = cfg.base_channels
    for lvl, mult in enumerate(cfg.channel_mult):
        out_ch = cfg.base_channels * mult
        blocks = []
        for _ in range(cfg.num_res_blocks):
            blocks.append(_init_resblock(cur, out_ch, gen, dev))
            cur = out_ch
        level = {"blocks": blocks}
        if lvl != len(cfg.channel_mult) - 1:
            level["down"] = init_conv(3, cur, cur, gen, dev)
        down.append(level)
    params["down"] = down
    params["mid"] = {
        "res1": _init_resblock(cur, cur, gen, dev),
        "attn": _init_attn(cur, gen, dev),
        "res2": _init_resblock(cur, cur, gen, dev),
    }
    params["norm_out"] = init_norm(cur, dev)
    params["conv_out"] = init_conv(3, cur, 2 * cfg.z_channels, gen, dev)
    params["quant"] = init_conv(1, 2 * cfg.z_channels, 2 * cfg.z_channels,
                                gen, dev)
    return params


def _resblock(p, x, groups, kernels):
    """Under ``"cuda_conv"`` both convs take the fused kernel; under
    ``"cuda_gn"`` the GroupNorms stay plain, as the reference's VAE keeps
    them (``sdtpu/models/vae.py:82-108``)."""
    kernels = "cuda_conv" if kernels == "cuda_conv" else "plain"
    h = _norm_conv(p["norm1"], p["conv1"], x, groups, 1e-6, kernels)
    h = _norm_conv(p["norm2"], p["conv2"], h, groups, 1e-6, kernels)
    if "nin" in p:
        x = conv2d(p["nin"], x, padding=0)
    return x + h


def _attn(p, x, groups, kernels):
    b, hh, ww, c = x.shape
    h = group_norm(p["norm"], x, groups, eps=1e-6)
    q = conv2d(p["q"], h, padding=0).reshape(b, hh * ww, c)
    k = conv2d(p["k"], h, padding=0).reshape(b, hh * ww, c)
    v = conv2d(p["v"], h, padding=0).reshape(b, hh * ww, c)
    o = sdpa(q, k, v, heads=1, kernel=attention_kernel(kernels))
    o = o.reshape(b, hh, ww, c)
    return x + conv2d(p["proj"], o, padding=0)


def _downsample(p, x):
    """torch's Downsample: pad (0, 1, 0, 1), then a VALID stride-2 3x3 conv.
    A cuDNN conv in either policy: the fused conv kernel's contract is
    stride 1, and the reference leaves this conv to XLA
    (``sdtpu/models/vae.py:160-171``). The padded NHWC tensor stays
    channels_last for cuDNN, as the decoder's convs are."""
    return conv2d(p, F.pad(x, (0, 0, 0, 1, 0, 1)), stride=2, padding=0)


def apply_encoder(params, img, cfg: VAEConfig, kernels: str = "plain"):
    """img: [B, H, W, 3] in [-1, 1] -> (mean, logvar), each [B, H/2^L,
    W/2^L, z_channels], in ``img``'s dtype (``sdtpu/models/vae.py:174-193``).
    Under ``"cuda_conv"`` the ResBlocks' convs take the fused GN-prologue
    conv kernel (with the GroupNorm kernel's statistics mode for each
    prologue), under ``"cuda_gn"`` they stay plain, as the decoder's do;
    the mid block's attention goes to the flash kernel under every
    ``cuda*`` policy (4,096 tokens at d = 512 for a 512x512 image)."""
    g = cfg.groups
    h = conv2d(params["conv_in"], img)
    for level in params["down"]:
        for blk in level["blocks"]:
            h = _resblock(blk, h, g, kernels)
        if "down" in level:
            h = _downsample(level["down"], h)
    mid = params["mid"]
    h = _resblock(mid["res1"], h, g, kernels)
    h = _attn(mid["attn"], h, g, kernels)
    h = _resblock(mid["res2"], h, g, kernels)
    h = silu(group_norm(params["norm_out"], h, g, eps=1e-6))
    h = conv2d(params["conv_out"], h)
    h = conv2d(params["quant"], h, padding=0)
    z = cfg.z_channels
    return h[..., :z], h[..., z:]


def apply(params, z, cfg: VAEConfig, kernels: str = "plain"):
    """z: [B,h,w,z_channels] *scaled* latent (the pipeline divides by
    cfg.scale_factor first) -> [B, h*2^L, w*2^L, 3] in ~[-1, 1]. The mid
    block's single-head attention (4096 tokens at d=512 for a 512x512
    image) goes to the flash kernel under every ``cuda*`` policy; the
    ResBlock convs take the fused GN-prologue conv kernel under
    ``kernels="cuda_conv"``."""
    g = cfg.groups
    h = conv2d(params["post_quant"], z, padding=0)
    h = conv2d(params["conv_in"], h)
    mid = params["mid"]
    h = _resblock(mid["res1"], h, g, kernels)
    h = _attn(mid["attn"], h, g, kernels)
    h = _resblock(mid["res2"], h, g, kernels)
    for level in params["up"]:
        for blk in level["blocks"]:
            h = _resblock(blk, h, g, kernels)
        if "up" in level:
            h = conv2d(level["up"], _upsample_nearest(h))
    h = silu(group_norm(params["norm_out"], h, g, eps=1e-6))
    return conv2d(params["conv_out"], h)
