"""The SD1.x, SD2.x and SDXL UNet denoiser, the counterpart of
``sdtpu/models/unet.py``, with the x4 upscaler's cross-only levels and
noise-level class table, and ControlNet's residuals (``apply``'s
``control``).

    down path:  per level, ``num_res_blocks`` x [ResBlock (+SpatialTransformer
                at attn levels)], then a stride-2 conv between levels;
    middle:     ResBlock, SpatialTransformer, ResBlock;

a SpatialTransformer runs ``transformer_depth`` basic blocks (SDXL: 2 and
10; 1 elsewhere), with ``num_heads`` heads or, where ``head_dim`` is set,
``channels // head_dim``;
    up path:    mirrored, with skip-concat from the down path, nearest-2x
                upsample between levels;
    out:        GroupNorm -> SiLU -> 3x3 conv.

The Context knobs reach it through ``apply``'s ``perturb`` (PAG's identity
self-attention) and ``deep`` (DeepCache's capture and shallow passes) and
through the config's ``tome_ratio`` (ToMe) and ``freeu`` (FreeU).

Activations are NHWC; attention flattens HW into the sequence axis, so the
64x64 level's self-attention is a 4096-token problem for the flash kernel.

Under the spatial partition of a mesh (``parallel.spatial``, on around a
``sharding.generate_sharded(..., spatial=True)`` call) the conv stack runs
on W-slices: each plane is held whole or as this rank's slice by the
reference's ``constrain`` rule (``spatial.tiles``), taken at the sites the
reference constrains (``conv_in``, each ResBlock, ``down``, ``up``) and
kept through the level; the transformers run on the gathered plane, and
the output is gathered.
"""

from __future__ import annotations

import torch

from sdtpu_torch.config import UNetConfig
from sdtpu_torch.models.layers import (
    conv2d,
    dense,
    geglu,
    group_norm,
    init_conv,
    init_dense,
    init_norm,
    init_normal,
    column_input,
    layer_norm,
    lora_delta,
    sdpa,
    silu,
    split_of,
)
from sdtpu_torch.ops import conv as C
from sdtpu_torch.ops import groupnorm as G
from sdtpu_torch.ops import tome as T
from sdtpu_torch.parallel import spatial as S


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_resblock(c_in, c_out, temb_dim, zero_init_outs, gen, dev):
    p = {
        "norm1": init_norm(c_in, dev),
        "conv1": init_conv(3, c_in, c_out, gen, dev),
        "emb": init_dense(temb_dim, c_out, gen, dev),
        "norm2": init_norm(c_out, dev),
        "conv2": init_conv(3, c_out, c_out, gen, dev,
                           zero_init=zero_init_outs),
    }
    if c_in != c_out:
        p["skip"] = init_conv(1, c_in, c_out, gen, dev)
    return p


def _init_attn(c, kv_in, gen, dev):
    return {
        "q": init_dense(c, c, gen, dev, bias=False),
        "k": init_dense(kv_in, c, gen, dev, bias=False),
        "v": init_dense(kv_in, c, gen, dev, bias=False),
        "out": init_dense(c, c, gen, dev),
    }


def _init_basic(c, ctx_dim, gen, dev, cross_only=False):
    """One attn1 / attn2 / GEGLU-ff block, the transformer's depth unit.
    ``cross_only`` (the x4 upscaler): attn1's k and v take the context
    (``sdtpu/models/unet.py:61-68``)."""
    return {
        "ln1": init_norm(c, dev),
        "attn1": _init_attn(c, ctx_dim if cross_only else c, gen, dev),
        "ln2": init_norm(c, dev),
        "attn2": _init_attn(c, ctx_dim, gen, dev),
        "ln3": init_norm(c, dev),
        "ff1": init_dense(c, c * 8, gen, dev),       # GEGLU: 2 x 4c
        "ff2": init_dense(c * 4, c, gen, dev),
    }


def _init_transformer(c, ctx_dim, zero_init_outs, gen, dev, depth=1,
                      cross_only=False):
    """Spatial transformer: GroupNorm + proj_in, ``depth`` basic blocks,
    proj_out. Depth 1 keeps the basic block's leaves flat in this dict (the
    SD1.x/2.x layout); deeper ones (SDXL) nest them under ``"blocks"``, as
    the JAX package does."""
    p = {
        "norm": init_norm(c, dev),
        "proj_in": init_conv(1, c, c, gen, dev),
        "proj_out": init_conv(1, c, c, gen, dev, zero_init=zero_init_outs),
    }
    if depth == 1:
        p.update(_init_basic(c, ctx_dim, gen, dev, cross_only))
    else:
        p["blocks"] = [_init_basic(c, ctx_dim, gen, dev, cross_only)
                       for _ in range(depth)]
    return p


def init(cfg: UNetConfig, generator, device, zero_init_outs: bool = True):
    """The parameter tree, in the JAX package's layout (same keys, same
    shapes apart from OIHW conv weights). ``zero_init_outs`` zeroes each
    block's output conv (the LDM training convention); demo mode passes
    False so a random UNet predicts a non-trivial eps."""
    gen, dev = generator, device
    ch = cfg.model_channels
    temb = cfg.time_embed_dim
    params = {"conv_in": init_conv(3, cfg.in_channels, ch, gen, dev)}

    down = []
    skip_chs = [ch]
    cur = ch
    for lvl, mult in enumerate(cfg.channel_mult):
        out_ch = ch * mult
        blocks = []
        for _ in range(cfg.num_res_blocks):
            blk = {"res": _init_resblock(cur, out_ch, temb, zero_init_outs,
                                         gen, dev)}
            cur = out_ch
            if lvl in cfg.attn_levels:
                blk["st"] = _init_transformer(
                    cur, cfg.context_dim, zero_init_outs, gen, dev,
                    cfg.depth_at(lvl), lvl in cfg.cross_only_levels)
            blocks.append(blk)
            skip_chs.append(cur)
        level = {"blocks": blocks}
        if lvl != len(cfg.channel_mult) - 1:
            level["down"] = init_conv(3, cur, cur, gen, dev)
            skip_chs.append(cur)
        down.append(level)
    params["down"] = down

    params["mid"] = {
        "res1": _init_resblock(cur, cur, temb, zero_init_outs, gen, dev),
        "st": _init_transformer(cur, cfg.context_dim, zero_init_outs, gen,
                                dev, cfg.mid_depth()),
        "res2": _init_resblock(cur, cur, temb, zero_init_outs, gen, dev),
    }

    up = []
    for lvl in reversed(range(len(cfg.channel_mult))):
        out_ch = ch * cfg.channel_mult[lvl]
        blocks = []
        for _ in range(cfg.num_res_blocks + 1):
            skip = skip_chs.pop()
            blk = {"res": _init_resblock(cur + skip, out_ch, temb,
                                         zero_init_outs, gen, dev)}
            cur = out_ch
            if lvl in cfg.attn_levels:
                blk["st"] = _init_transformer(
                    cur, cfg.context_dim, zero_init_outs, gen, dev,
                    cfg.depth_at(lvl), lvl in cfg.cross_only_levels)
            blocks.append(blk)
        level = {"blocks": blocks}
        if lvl != 0:
            level["up"] = init_conv(3, cur, cur, gen, dev)
        up.append(level)
    params["up"] = up

    if cfg.num_class_embeds:
        # the noise-level class table (LDM ``label_emb``, an nn.Embedding:
        # N(0, 1) init); its selected row adds to the time embedding
        params["label_emb"] = init_normal(
            (cfg.num_class_embeds, cfg.time_embed_dim), 1.0, gen, dev)
    params["out_norm"] = init_norm(cur, dev)
    params["conv_out"] = init_conv(3, cur, cfg.out_channels, gen, dev,
                                   zero_init=zero_init_outs)
    return params


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _gn(p, x, groups, eps, fuse_silu, kernels, split=False):
    """GroupNorm (+SiLU); the fused kernel under ``"cuda_gn"``
    (``sdtpu/models/unet.py:_gn``). ``split``: x is this rank's W-slice of
    the plane (``parallel.spatial``): the statistics are the whole plane's,
    from K2's partial mode under ``"cuda_gn"``."""
    kernel = kernels == "cuda_gn" and G.uses_kernel(x, groups)
    stats = S.stats(x, groups, eps, kernel) if split else None
    if kernels == "cuda_gn":
        return G.fused_group_norm(p, x, groups, eps, fuse_silu, stats)
    y = group_norm(p, x, groups, eps, stats)
    return silu(y) if fuse_silu else y


def _conv3(p, x, split, stride=1):
    """A 3x3 conv (padding 1) of x, whole or this rank's W-slice
    (``split``): a slice takes its neighbours' columns
    (``spatial.padded``) and no W padding."""
    if not split:
        return conv2d(p, x, stride=stride)
    return conv2d(p, S.padded(x), stride=stride, padding=(1, 0))


def _conv_wq(p):
    """(weight, int8 scale or None) of a conv site: the fused conv kernel
    takes weight-only-int8 weights as they are and applies the scale to its
    accumulator (``sdtpu/models/unet.py:_conv_wq``)."""
    if "w8" in p:
        return p["w8"], p["w8_scale"]
    return p["w"], None


def _norm_conv(pn, pc, x, groups, eps, kernels, *, fuse_silu=True,
               padding=1, t=None, split=False):
    """conv(pc, [silu](GroupNorm(pn, x))) [+ t, a per-sample [N, Cout] add].

    Under ``"cuda_conv"``, where the conv is ``eligible`` for x, one fused
    kernel launch: the GroupNorm folded into the conv's prologue
    (``gn_affine``), ``pc["b"] + t`` added in float32 in its epilogue
    (``sdtpu/models/unet.py:224-244,266-275``). A weight-only-int8 site
    hands the kernel its int8 weight and scale.

    A conv that carries a LoRA adapter (``lora_a``, its down conv) keeps
    the kernel where the down conv is ``eligible`` too: a second launch
    with ``lora_a`` as the weight, the same prologue and a zero bias gives
    the delta's input, which ``layers.lora_delta`` mixes up. Otherwise
    the site takes the unfused chain and its delta (``layers.conv2d``).
    The reference's fused path drops the delta there instead
    (``sdtpu/models/unet.py:225-242, 266-275``); its ``xla`` path, which
    the port matches, applies it.

    ``split``: x is this rank's W-slice (``parallel.spatial``). The
    GroupNorm's statistics are the whole plane's (K2's partial mode, then
    its statistics mode from them, under ``"cuda_conv"``); the kernel runs
    on the slice widened by its neighbours' raw columns
    (``spatial.halo_slice``) with its own padding, and the halo's output
    columns are dropped (``spatial.crop``)."""
    w, w_scale = _conv_wq(pc)
    lora_a = pc.get("lora_a")
    if lora_a is not None:
        # the loaders keep it in channels_last memory, where this is no copy
        lora_a = lora_a.to(x.dtype).contiguous(
            memory_format=torch.channels_last)
    if (kernels == "cuda_conv" and C.eligible(x, w, 1, padding)
            and (lora_a is None or C.eligible(x, lora_a, 1, padding))):
        stats = (S.stats(x, groups, eps, G.uses_kernel(x, groups)) if split
                 else None)
        a, d = C.gn_affine(pn, x, groups, eps, stats)
        xk, left, right = (S.halo_slice(x) if split and padding
                           else (x, False, False))
        b = pc["b"].float()
        if t is not None:
            b = b[None, :] + t.float()
        y = C.fused_conv(xk, w, b, a=a, d=d, silu=fuse_silu,
                         w_scale=w_scale)
        if lora_a is not None:
            zero = torch.zeros(lora_a.shape[0], dtype=torch.float32,
                               device=x.device)
            y = y + lora_delta(pc, C.fused_conv(xk, lora_a, zero, a=a, d=d,
                                                 silu=fuse_silu))
        return S.crop(y, left, right)
    h = _gn(pn, x, groups, eps, fuse_silu, kernels, split)
    if split and padding:
        h = conv2d(pc, S.padded(h), padding=(padding, 0))
    else:
        h = conv2d(pc, h, padding=padding)
    return h if t is None else h + t[:, None, None, :]


def _resblock(p, x, emb, groups, kernels, split=False):
    t = dense(p["emb"], silu(emb))
    h = _norm_conv(p["norm1"], p["conv1"], x, groups, 1e-5, kernels, t=t,
                   split=split)
    h = _norm_conv(p["norm2"], p["conv2"], h, groups, 1e-5, kernels,
                   split=split)
    if "skip" in p:
        x = conv2d(p["skip"], x, padding=0)
    return x + h


def _transformer(p, x, context, heads, groups, kernels, perturb_self=False,
                 tome=None, cross_only=False):
    """``tome``: (ratio, min_tokens) or None; a plane of at least
    ``min_tokens`` tokens merges (``sdtpu/models/unet.py:253-262``).
    ``cross_only``: the blocks' attn1 attends the context."""
    b, hh, ww, c = x.shape
    if tome is not None:
        tome = (hh, ww, tome[0]) if hh * ww >= tome[1] else None
    h = _norm_conv(p["norm"], p["proj_in"], x, groups, 1e-6, kernels,
                   fuse_silu=False, padding=0).reshape(b, hh * ww, c)
    for blk in p.get("blocks", (p,)):
        h = _basic_block(blk, h, context, heads, attention_kernel(kernels),
                         perturb_self, tome, cross_only)
    h = h.reshape(b, hh, ww, c)
    return x + conv2d(p["proj_out"], h, padding=0)


def _spatial_transformer(p, x, split, *args, **kw):
    """``_transformer`` on the whole plane: a W-slice (``split``) is
    gathered first and this rank's slice taken after."""
    if not split:
        return _transformer(p, x, *args, **kw)
    return S.split(_transformer(p, S.gather(x), *args, **kw))


def attention_kernel(kernels: str) -> str:
    """Every ``cuda*`` policy keeps the flash kernel on, as every
    ``pallas*`` policy does in the reference (``sdtpu/models/unet.py:255``,
    ``vae.py:117``)."""
    return "cuda" if kernels.startswith("cuda") else "plain"


def _split(y, parts):
    """A fused projection's output split into ``parts`` contiguous tensors:
    the flash kernel's rule takes contiguous q, k and v only."""
    return [t.contiguous() for t in torch.chunk(y, parts, dim=-1)]


def _basic_block(p, h, context, heads, attn_kernel, perturb_self=False,
                 tome=None, cross_only=False):
    """attn1 (self) -> attn2 (cross) -> GEGLU ff, each with a residual
    (``sdtpu/models/unet.py:291-363``).

    ``cross_only`` (the x4 upscaler): attn1 takes its keys and values from
    ``context``, so the block has no self-attention: PAG leaves it alone,
    ToMe merges its query rows only, and a fused projection is attn1's
    ``kv`` leaf, as attn2's.

    ``perturb_self``: the self-attention map is the identity (PAG), so
    attn1's output is its value rows: ``out(v)``, the q and k projections
    skipped. ``tome``: (hh, ww, ratio) or None: ``ln1``'s output merges
    before attn1 and its output unmerges after the out projection; attn2
    and the ff run unmerged. The identity attention never merges. A fused
    ``qkv`` (``io.params.fuse_attention_projections``) or ``kv`` leaf is one
    product, split.

    On the mesh's model axis (``parallel.sharding``) a split attention runs
    this rank's ``heads // split`` heads and all-reduces its ``out``
    partial; a split ff its slice of GEGLU's columns, all-reduced after
    ``ff2``. The split is read off each row site's input width. A split
    site group's input goes through ``layers.column_input``, whose
    backward sums its gradient over the model group."""
    c = h.shape[-1]
    a = p["attn1"]
    t1 = split_of(a["out"], c)
    heads1 = heads // t1
    hn = column_input(layer_norm(p["ln1"], h), t1)
    if cross_only:
        unmerge = None
        if tome is not None:
            merge, unmerge, r = T.build(h, *tome)
            if r:
                hn = merge(hn)
            else:
                unmerge = None
        k, v = _kv(a, context)
        o = dense(a["out"], sdpa(dense(a["q"], hn), k, v, heads1,
                                 attn_kernel), reduce=t1 > 1)
        h = h + (unmerge(o) if unmerge is not None else o)
    elif perturb_self:
        v = (_split(dense(a["qkv"], hn), 3)[2] if "qkv" in a
             else dense(a["v"], hn))
        h = h + dense(a["out"], v, reduce=t1 > 1)
    else:
        unmerge = None
        if tome is not None:
            merge, unmerge, r = T.build(h, *tome)
            if r:
                hn = merge(hn)
            else:
                unmerge = None
        if "qkv" in a:
            q, k, v = _split(dense(a["qkv"], hn), 3)
        else:
            q, k, v = dense(a["q"], hn), dense(a["k"], hn), dense(a["v"], hn)
        o = dense(a["out"], sdpa(q, k, v, heads1, attn_kernel),
                  reduce=t1 > 1)
        h = h + (unmerge(o) if unmerge is not None else o)
    a = p["attn2"]
    t2 = split_of(a["out"], c)
    hn = column_input(layer_norm(p["ln2"], h), t2)
    k, v = _kv(a, context)
    h = h + dense(a["out"], sdpa(dense(a["q"], hn), k, v, heads // t2,
                                 attn_kernel), reduce=t2 > 1)
    t3 = split_of(p["ff2"], 4 * c)
    hn = column_input(layer_norm(p["ln3"], h), t3)
    return h + dense(p["ff2"], geglu(p["ff1"], hn), reduce=t3 > 1)


def _kv(a, context):
    """An attention's keys and values of the text context, from its fused
    ``kv`` leaf or its ``k`` and ``v``."""
    if "kv" in a:
        return _split(dense(a["kv"], context), 2)
    return dense(a["k"], context), dense(a["v"], context)


def _heads(cfg: UNetConfig, c: int) -> int:
    """SD1.x: a fixed head count; SD2.x and SDXL: a fixed head dim, so the
    count grows with the width (``sdtpu/models/unet.py:378-381``)."""
    return c // cfg.head_dim if cfg.head_dim else cfg.num_heads


def _upsample_nearest(x):
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, h * 2, w * 2, c)


def _fourier_lowfreq_scale(x, scale, threshold: int = 1):
    """FreeU's skip filter: the lowest spatial frequencies of x [B, H, W,
    C] (a (2 threshold)^2 window around DC after fftshift) scaled by
    ``scale``, in float32 (a bf16 FFT takes power-of-two sizes only on
    CUDA), cast back."""
    f = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=(1, 2)),
                           dim=(1, 2))
    _, hh, ww, _ = x.shape

    def band(n):
        i = torch.arange(n, device=x.device)
        return (i >= n // 2 - threshold) & (i < n // 2 + threshold)

    m = torch.where(band(hh)[:, None] & band(ww)[None, :], scale, 1.0)
    f = f * m[None, :, :, None]
    out = torch.fft.ifftn(torch.fft.ifftshift(f, dim=(1, 2)), dim=(1, 2))
    return out.real.to(x.dtype)


def _freeu(h, s, cfg: UNetConfig):
    """FreeU (``sdtpu/models/unet.py:401-426``): at the decoder widths of
    the two deepest levels, ``model_channels * channel_mult[::-1][:2]``,
    the first half of the backbone's channels times b and the skip's low
    frequencies times s. The rule is the reference's: where both widths
    are equal (SD1.x: 1280 and 1280) b2 and s2 never apply."""
    b1, b2, s1, s2 = cfg.freeu
    widths = [cfg.model_channels * m for m in cfg.channel_mult[::-1][:2]]
    c = h.shape[-1]
    if c == widths[0]:
        bk, sk = b1, s1
    elif len(widths) > 1 and c == widths[1]:
        bk, sk = b2, s2
    else:
        return h, s
    if bk != 1.0:
        half = c // 2
        scale = torch.tensor(bk, dtype=h.dtype, device=h.device)
        h = torch.cat([h[..., :half] * scale, h[..., half:]], dim=-1)
    if sk != 1.0:
        s = _fourier_lowfreq_scale(s, sk)
    return h, s


def apply(params, x, t_emb, context, cfg: UNetConfig,
          kernels: str = "plain", control=None, perturb=None, deep=None):
    """x: [B,H,W,C_in]; t_emb: [B, time_embed_dim] (already MLP-embedded by
    ``sdtpu_torch.models.temb``); context: [B, T, context_dim] -> eps
    [B,H,W,C_out].

    kernels: ``"cuda"`` sends attention through the flash kernel's dispatch
    (``sdtpu_torch.ops.attention``); ``"cuda_gn"`` adds the fused
    GroupNorm(+SiLU) kernel for every GroupNorm (``ops.groupnorm``);
    ``"cuda_conv"`` adds, instead, the fused GN-prologue conv kernel for
    every ResBlock conv and transformer ``proj_in`` (``ops.conv``);
    ``"plain"`` keeps everything on ``layers``.

    control: ``(down residuals, mid residual)`` of
    ``models.controlnet.apply``, already scaled, or None: one residual a
    skip tensor in push order, added to the skip as the up path takes it,
    and one added to the mid output (``sdtpu/models/unet.py:436-530``).

    perturb: a subset of ("down", "mid", "up"): the self-attention of those
    sections' transformers is the identity map (perturbed-attention
    guidance, ``engine.pipeline.denoise``).

    deep: DeepCache's protocol (``sdtpu/models/unet.py:456-464``). None: the
    plain forward. "capture": the plain forward that also returns the
    hidden entering the last up level, ``(eps, cache)``. A tensor: the
    shallow forward: conv_in and the level-0 downs (the skips the last up
    level takes), the cached tensor in place of the deep stack, then the
    last up level and the head.
    """
    perturb = frozenset(perturb or ())
    if not perturb <= {"down", "mid", "up"}:
        raise ValueError(f"unknown perturb sections {sorted(perturb)}; "
                         f"expected a subset of ('down', 'mid', 'up')")
    capture = isinstance(deep, str)
    if capture and deep != "capture":
        raise ValueError(f"deep must be None, 'capture', or a cached "
                         f"junction tensor, got {deep!r}")
    shallow = deep is not None and not capture
    if shallow and control is not None:
        raise ValueError("DeepCache shallow pass is incompatible with "
                         "ControlNet residuals (they enter the deep skips)")
    tome = ((cfg.tome_ratio, cfg.tome_min_tokens) if cfg.tome_ratio > 0.0
            else None)
    g = cfg.groups
    # h is held whole or as this rank's W-slice (sp) of a plane w wide
    w = x.shape[2]
    h, sp = S.fit(x, False, w)
    h = _conv3(params["conv_in"], h, sp)
    skips = [h]
    for lvl, level in enumerate(params["down"][:1] if shallow
                                else params["down"]):
        for blk in level["blocks"]:
            h = _resblock(blk["res"], h, t_emb, g, kernels, sp)
            if "st" in blk:
                h = _spatial_transformer(
                    blk["st"], h, sp, context, _heads(cfg, h.shape[-1]), g,
                    kernels, "down" in perturb, tome,
                    lvl in cfg.cross_only_levels)
            skips.append(h)
        if "down" in level and not shallow:
            if sp and h.shape[2] % 2:
                # a slice of odd width would start the strided taps at odd
                # offsets: the conv runs on the gathered plane
                h, sp = S.gather(h), False
            h = _conv3(level["down"], h, sp, stride=2)
            w = (w + 1) // 2
            h, sp = S.fit(h, sp, w)
            skips.append(h)

    ctrl_down = None
    if control is not None:
        ctrl_down, ctrl_mid = control
        if len(ctrl_down) != len(skips):
            raise ValueError(
                f"control residual count {len(ctrl_down)} != skip count "
                f"{len(skips)}")
        ctrl_down = list(ctrl_down)

    if shallow:
        h, sp = S.fit(deep.to(h.dtype), False, w)
    else:
        mid = params["mid"]
        h = _resblock(mid["res1"], h, t_emb, g, kernels, sp)
        h = _spatial_transformer(mid["st"], h, sp, context,
                                 _heads(cfg, h.shape[-1]), g, kernels,
                                 "mid" in perturb, tome)
        h = _resblock(mid["res2"], h, t_emb, g, kernels, sp)
        if control is not None:
            h = h + S.fit(ctrl_mid.to(h.dtype), False, w)[0]

    cache = None
    up_levels = params["up"][-1:] if shallow else params["up"]
    for uidx, level in enumerate(up_levels):
        # the tree's up levels run deepest first; the shallow pass runs
        # level 0 only
        lvl = 0 if shallow else len(cfg.channel_mult) - 1 - uidx
        if capture and uidx == len(up_levels) - 1:
            cache = S.gather(h) if sp else h
        for blk in level["blocks"]:
            s = skips.pop()
            if ctrl_down is not None:
                s = s + S.fit(ctrl_down.pop().to(s.dtype), False, w)[0]
            if cfg.freeu is not None:
                if sp:
                    # the skip's Fourier filter takes the whole plane
                    h, s = (S.split(t) for t in _freeu(S.gather(h),
                                                       S.gather(s), cfg))
                else:
                    h, s = _freeu(h, s, cfg)
            h = torch.cat([h, s], dim=-1)
            h = _resblock(blk["res"], h, t_emb, g, kernels, sp)
            if "st" in blk:
                h = _spatial_transformer(
                    blk["st"], h, sp, context, _heads(cfg, h.shape[-1]), g,
                    kernels, "up" in perturb, tome,
                    lvl in cfg.cross_only_levels)
        if "up" in level:
            w = 2 * w
            h, sp = S.fit(_upsample_nearest(h), sp, w)
            h = _conv3(level["up"], h, sp)

    h = _gn(params["out_norm"], h, g, 1e-5, True, kernels, sp)
    out = _conv3(params["conv_out"], h, sp)
    if sp:
        out = S.gather(out)
    return (out, cache) if capture else out
