"""ControlNet: spatial control of the UNet, the counterpart of
``sdtpu/models/controlnet.py``.

A trained copy of the UNet's encoder (conv_in, the down path and the mid
block) with

* a hint network: seven SiLU-separated 3x3 convs that embed the control
  image (edges, depth, pose, ...) from pixel space down to the latent grid,
  then a projection to ``model_channels`` that starts at zero;
* zero convs: one 1x1 conv a skip tensor of the UNet and one on the mid
  output, each starting at zero, so a fresh ControlNet leaves the UNet as
  it is.

Its residuals add to the UNet's skips and mid output
(``models.unet.apply(control=...)``). The hint embedding does not depend on
the step, so the pipeline computes it once before the loop
(``embed_hint``); each step runs only the encoder copy, on the UNet's CFG
batch. The copy runs the UNet's ResBlocks and transformers with the
Context's kernel policy (K1, K2 and K3 at their usual rules), without ToMe,
perturbation or cross-only levels. The tree follows the LDM
``control_model.*`` layout (``io.weights.controlnet_rules``).
"""

from __future__ import annotations

import dataclasses

from sdtpu_torch.config import UNetConfig
from sdtpu_torch.models import temb
from sdtpu_torch.models.layers import conv2d, init_conv, silu
from sdtpu_torch.models.unet import (_heads, _init_resblock,
                                     _init_transformer, _resblock,
                                     _transformer)

#: the hint network's channel ladder (the ControlNet paper's
#: ``input_hint_block``): seven body convs, then the projection to
#: ``model_channels``
HINT_CHANNELS = (16, 16, 32, 32, 96, 96, 256)


def _hint_strides(factor: int) -> tuple:
    """The seven body convs' strides: the canonical network downsamples 8x
    with stride 2 at positions 2, 4 and 6; a smaller pixel -> latent factor
    (the TINY configurations) keeps only the last log2(factor) of those, so
    the parameter shapes, and the checkpoint mapping, stay the same."""
    n_down = max(0, factor.bit_length() - 1)
    if 1 << n_down != factor:
        raise ValueError(f"hint downsample factor must be a power of 2, "
                         f"got {factor}")
    if n_down > 3:
        raise ValueError(f"hint network supports factors up to 8, got {factor}")
    strides = [1] * len(HINT_CHANNELS)
    for pos in (2, 4, 6)[3 - n_down:]:
        strides[pos] = 2
    return tuple(strides)


def init(cfg: UNetConfig, generator, device, hint_channels: int = 3,
         zero_init_outs: bool = True):
    """The parameter tree; ``down`` and ``mid`` mirror ``unet.init``'s.
    ``zero_init_outs=False`` (demo weights) draws the zero convs and the
    hint projection too, so the control path acts without trained weights.
    The time MLP takes no guidance features (the pipeline embeds the
    adapter's table without them), so an LCM configuration's adapter has no
    ``cond_proj``."""
    gen, dev = generator, device
    ch = cfg.model_channels
    hint = []
    c_prev = hint_channels
    for c in HINT_CHANNELS:
        hint.append(init_conv(3, c_prev, c, gen, dev))
        c_prev = c
    hint.append(init_conv(3, c_prev, ch, gen, dev, zero_init=zero_init_outs))
    params = {
        "temb": temb.init(dataclasses.replace(cfg, time_cond_proj_dim=0), gen,
                          dev),
        "hint": hint,
        "conv_in": init_conv(3, cfg.in_channels, ch, gen, dev),
    }

    def zero(c):
        return init_conv(1, c, c, gen, dev, zero_init=zero_init_outs)

    down = []
    zeros = [zero(ch)]
    cur = ch
    for lvl, mult in enumerate(cfg.channel_mult):
        out_ch = ch * mult
        blocks = []
        for _ in range(cfg.num_res_blocks):
            blk = {"res": _init_resblock(cur, out_ch, cfg.time_embed_dim,
                                         zero_init_outs, gen, dev)}
            cur = out_ch
            if lvl in cfg.attn_levels:
                blk["st"] = _init_transformer(cur, cfg.context_dim,
                                              zero_init_outs, gen, dev,
                                              cfg.depth_at(lvl))
            blocks.append(blk)
            zeros.append(zero(cur))
        level = {"blocks": blocks}
        if lvl != len(cfg.channel_mult) - 1:
            level["down"] = init_conv(3, cur, cur, gen, dev)
            zeros.append(zero(cur))
        down.append(level)
    params["down"] = down
    params["zero"] = zeros
    params["mid"] = {
        "res1": _init_resblock(cur, cur, cfg.time_embed_dim, zero_init_outs,
                               gen, dev),
        "st": _init_transformer(cur, cfg.context_dim, zero_init_outs, gen,
                                dev, cfg.depth_at(len(cfg.channel_mult) - 1)),
        "res2": _init_resblock(cur, cur, cfg.time_embed_dim, zero_init_outs,
                               gen, dev),
    }
    params["zero_mid"] = zero(cur)
    return params


def embed_hint(params, hint, factor: int):
    """Control image [B, H, W, C_hint] (float in [0, 1]) -> hint features
    on the latent grid [B, H/factor, W/factor, model_channels]. ``factor``
    is the pixel -> latent ratio (``cfg.upscale``)."""
    h = hint
    for p, s in zip(params["hint"][:-1], _hint_strides(factor)):
        h = silu(conv2d(p, h, stride=s))
    return conv2d(params["hint"][-1], h)


def apply(params, x, hint_feat, t_emb, context, cfg: UNetConfig,
          kernels: str = "plain"):
    """One ControlNet eval. x: [B, h, w, C_in] noisy latents (the UNet's
    CFG batch); hint_feat: [B, h, w, model_channels] (``embed_hint``);
    t_emb: [B, time_embed_dim] from this adapter's own time MLP; context:
    [B, T, context_dim].

    Returns (down residuals, mid residual): one residual a skip tensor of
    the UNet in push order, and the mid output, unscaled (the pipeline
    applies each adapter's scale)."""
    g = cfg.groups
    h = conv2d(params["conv_in"], x) + hint_feat.to(x.dtype)
    zs = iter(params["zero"])
    outs = [conv2d(next(zs), h, padding=0)]
    for level in params["down"]:
        for blk in level["blocks"]:
            h = _resblock(blk["res"], h, t_emb, g, kernels)
            if "st" in blk:
                h = _transformer(blk["st"], h, context,
                                 _heads(cfg, h.shape[-1]), g, kernels)
            outs.append(conv2d(next(zs), h, padding=0))
        if "down" in level:
            h = conv2d(level["down"], h, stride=2)
            outs.append(conv2d(next(zs), h, padding=0))
    mid = params["mid"]
    h = _resblock(mid["res1"], h, t_emb, g, kernels)
    h = _transformer(mid["st"], h, context, _heads(cfg, h.shape[-1]), g,
                     kernels)
    h = _resblock(mid["res2"], h, t_emb, g, kernels)
    return tuple(outs), conv2d(params["zero_mid"], h, padding=0)
