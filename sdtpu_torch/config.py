"""Model/pipeline configuration for the PyTorch port.

Carried over from ``sdtpu/config.py`` (the JAX package), cut to the fields
the txt2img and image-conditioned paths of SD v1.5, SD 2.x and SDXL read,
the concat-conditioned variants (inpaint, depth, InstructPix2Pix) whose
UNet takes extra input planes, the three staged configurations (LCM's
guidance embedding, the SDXL refiner's single tower, the x4 upscaler's
cross-only levels and noise-level classes) and the Context knobs (FreeU,
ToMe, CFG rescale, DeepCache). Field names, defaults and the values are
the JAX package's; ``tests/test_torch_slice.py``,
``tests/test_torch_families.py``, ``tests/test_torch_image.py`` and
``tests/test_torch_stages.py`` pin them against it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vocab_size: int = 49408
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    context_len: int = 77
    eps: float = 1e-5
    act: str = "quick_gelu"      # SD2 (OpenCLIP ViT-H) and bigG use "gelu"
    penultimate: bool = False    # skip the last block, then the final LN
    # A1111 "CLIP skip": run `layers - skip_last` blocks, then the final LN
    # (skip_last = clip_skip - 1). Set via Context(clip_skip=...)
    skip_last: int = 0
    # width of the pooled embedding's projection (SDXL's bigG: 1280); 0 =
    # no ``text_proj`` leaf
    projection: int = 0


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_levels: Tuple[int, ...] = (0, 1, 2)   # levels with spatial transformers
    num_heads: int = 8
    head_dim: int = 0            # SD2/XL: heads = channels // head_dim
    context_dim: int = 768
    time_embed_dim: int = 1280                 # = 4 * model_channels
    groups: int = 32
    # transformer blocks per spatial transformer, per level (SDXL: (0, 2,
    # 10)); empty = depth 1 at every attention level. The mid block takes
    # the deepest attention level's depth
    transformer_depth: Tuple[int, ...] = ()
    # input width of the additive conditioning MLP (SDXL: 2816 = 1280
    # pooled + 6 x 256 fourier micro-conditions); 0 = none
    adm_in_channels: int = 0
    # FreeU (Si et al. 2023): (b1, b2, s1, s2) backbone/skip rebalancing at
    # the two deepest decoder widths; None = off. Set via Context(freeu=...)
    freeu: Optional[Tuple[float, float, float, float]] = None
    # ToMe-SD (Bolya & Hoffman 2023): merge this fraction of spatial tokens
    # before each self-attention of at least tome_min_tokens tokens (4096:
    # the 64x64 level and up); 0.0 = off. Set via Context(tome_ratio=...)
    tome_ratio: float = 0.0
    tome_min_tokens: int = 4096
    # the x4 upscaler: levels whose transformers' attn1 attends the text
    # context instead of the hidden (LDM ``disable_self_attentions``; the
    # mid block keeps its self-attention)
    cross_only_levels: Tuple[int, ...] = ()
    # noise-level classes: a learned [num_class_embeds, time_embed_dim]
    # table whose selected row adds to the time embedding (x4: 1000); 0 =
    # none
    num_class_embeds: int = 0
    # LCM's guidance embedding: the width of the guidance-scale features a
    # bias-free projection adds to the time features (256); the model
    # bakes CFG in, so no CFG batch runs. 0 = none
    time_cond_proj_dim: int = 0

    def depth_at(self, lvl: int) -> int:
        if not self.transformer_depth:
            return 1
        return self.transformer_depth[lvl]

    def mid_depth(self) -> int:
        if not self.transformer_depth:
            return 1
        lvl = max(self.attn_levels) if self.attn_levels else (
            len(self.channel_mult) - 1)
        return self.transformer_depth[lvl]


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    z_channels: int = 4
    base_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)   # encoder order; decoder reverses
    num_res_blocks: int = 2                        # decoder uses num_res_blocks + 1
    out_channels: int = 3
    groups: int = 32
    scale_factor: float = 0.18215


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    clip: CLIPConfig = CLIPConfig()
    # second text tower (SDXL's OpenCLIP bigG): the two towers' hidden
    # states concatenate to the cross-attention context, and tower 2's
    # pooled embedding feeds the UNet's additive conditioning
    clip2: Optional[CLIPConfig] = None
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    latent_channels: int = 4
    latent_size: int = 64
    upscale: int = 8          # VAE upsampling factor
    dtype: str = "bfloat16"   # activation/compute dtype
    prediction: str = "eps"   # "eps" | "v" (SD 2.x 768-v)
    # the SDXL refiner's layout: tower 2 alone is the text conditioning (no
    # ``clip`` tree; ``clip`` is set to tower 2's config for the token
    # plumbing), and the micro-conditions are (H, W, 0, 0, aesthetic score)
    refiner: bool = False
    # the refiner's aesthetic-score micro-condition
    aesthetic_score: float = 6.0
    # CFG rescale (Lin et al. 2023): blend the guided eps toward itself
    # rescaled to the cond prediction's per-sample std; 0 = off. Set via
    # Context(guidance_rescale=...)
    guidance_rescale: float = 0.0
    # DeepCache (Ma et al. 2023): a full UNet eval every N steps, the cached
    # deep feature spliced into a shallow eval between; None = off. Set via
    # Context(deepcache=N)
    deepcache_interval: Optional[int] = None
    # the x4 upscaler: the low-res image is noised to a level below this on
    # an image-space schedule, and that level picks the class row
    max_noise_level: int = 350

    @property
    def image_size(self) -> int:
        return self.latent_size * self.upscale

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


SD15 = PipelineConfig()

# Stable Diffusion 2.1 (768-v): the OpenCLIP ViT-H text tower (GELU; 23 of
# its 24 blocks, the penultimate tap pre-cut, then the final LN),
# head-dim-64 attention, v-prediction, 768x768
SD21 = PipelineConfig(
    clip=CLIPConfig(hidden=1024, layers=23, heads=16, act="gelu",
                    penultimate=False),
    unet=UNetConfig(num_heads=0, head_dim=64, context_dim=1024),
    latent_size=96,
    prediction="v",
)

# SD 2.1-base (512x512, eps-prediction), the same towers
SD21_BASE = dataclasses.replace(SD21, latent_size=64, prediction="eps")

# Stable Diffusion XL base (1024x1024): CLIP-L and OpenCLIP bigG, each
# tapped at its penultimate block, concatenated to a 2048-wide context;
# bigG's pooled embedding and six size/crop micro-conditions through the
# additive MLP (2816 -> 1280); a 3-level UNet with no attention at level 0,
# transformer depth (-, 2, 10) and head-dim-64 attention
SDXL = PipelineConfig(
    clip=CLIPConfig(),
    clip2=CLIPConfig(hidden=1280, layers=32, heads=20, act="gelu",
                     projection=1280),
    unet=UNetConfig(channel_mult=(1, 2, 4), attn_levels=(1, 2),
                    transformer_depth=(0, 2, 10), num_heads=0, head_dim=64,
                    context_dim=2048, adm_in_channels=2816),
    vae=VAEConfig(scale_factor=0.13025),
    latent_size=128,
)

# Concat-conditioned checkpoints: the UNet's conv_in takes the latents plus
# extra planes at every step (``engine/pipeline.denoise``'s ``x_extra``).
# Dedicated inpainting (sd-v1-5-inpainting, stable-diffusion-2-inpainting,
# the SDXL 1.0 inpainting UNet): 9 channels, latents 4 + the latent-res mask
# 1 + the masked image's latents 4
SD15_INPAINT = dataclasses.replace(
    SD15, unet=dataclasses.replace(SD15.unet, in_channels=9))
SD21_INPAINT = dataclasses.replace(
    SD21_BASE, unet=dataclasses.replace(SD21_BASE.unet, in_channels=9))
SDXL_INPAINT = dataclasses.replace(
    SDXL, unet=dataclasses.replace(SDXL.unet, in_channels=9))
# depth-conditioned img2img (stable-diffusion-2-depth): latents 4 + a depth
# plane normalized per sample to [-1, 1], on SD 2.x-base
SD2_DEPTH = dataclasses.replace(
    SD21_BASE, unet=dataclasses.replace(SD21_BASE.unet, in_channels=5))
# InstructPix2Pix (timbrooks/instruct-pix2pix): latents 4 + the edit image's
# unscaled posterior-mode latents 4, with the dual text/image CFG
SD15_IP2P = dataclasses.replace(
    SD15, unet=dataclasses.replace(SD15.unet, in_channels=8))

# Latent-consistency distilled SD1.5 (LCM-Dreamshaper v7): SD1.5 with a
# 256-wide guidance embedding in the time MLP; served with sampler="lcm"
# at 2-8 steps, the CFG batch never runs
SD15_LCM = dataclasses.replace(
    SD15, unet=dataclasses.replace(SD15.unet, time_cond_proj_dim=256))

# The SD x4 upscaler (stable-diffusion-x4-upscaler): a 7-channel UNet
# (latents 4 + the noise-augmented low-res RGB 3) on the low-res grid, the
# noise level through a 1000-row class table, cross-only attention at
# levels 1 and 2, an f4 VAE; v-prediction, SD 2.x's OpenCLIP tower
SD_X4 = PipelineConfig(
    clip=CLIPConfig(hidden=1024, layers=23, heads=16, act="gelu"),
    unet=UNetConfig(in_channels=7, model_channels=256,
                    channel_mult=(1, 2, 2, 4), attn_levels=(1, 2, 3),
                    num_heads=8, context_dim=1024, time_embed_dim=1024,
                    cross_only_levels=(1, 2), num_class_embeds=1000),
    vae=VAEConfig(channel_mult=(1, 2, 4), scale_factor=0.08333),
    latent_size=128,
    upscale=4,
    prediction="v",
)

# The SDXL refiner (1024x1024, the second stage): one text tower (bigG,
# 1280-wide context), the pooled embedding and five micro-conditions
# through the additive MLP (2560 -> 1536), a 384-channel 4-level UNet with
# depth-4 transformers at levels 1 and 2
_XL_BIGG = CLIPConfig(hidden=1280, layers=32, heads=20, act="gelu",
                      projection=1280)
SDXL_REFINER = PipelineConfig(
    clip=_XL_BIGG,
    clip2=_XL_BIGG,
    unet=UNetConfig(model_channels=384, channel_mult=(1, 2, 4, 4),
                    attn_levels=(1, 2), transformer_depth=(0, 4, 4, 0),
                    num_heads=0, head_dim=64, context_dim=1280,
                    time_embed_dim=1536, adm_in_channels=2560),
    vae=VAEConfig(scale_factor=0.13025),
    latent_size=128,
    refiner=True,
)

# Tiny config for CPU tests: same topology, ~1000x fewer FLOPs.
TINY = PipelineConfig(
    clip=CLIPConfig(vocab_size=512 + 22 + 2, hidden=32, layers=2, heads=2,
                    context_len=16),
    unet=UNetConfig(model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                    attn_levels=(0, 1), num_heads=2, context_dim=32,
                    time_embed_dim=64, groups=4),
    vae=VAEConfig(base_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                  groups=4),
    latent_size=8,
    upscale=2,
    dtype="float32",
)

# Tiny SDXL topology for CPU tests: dual towers (the second a GELU tower
# with a 48 -> 16 projection), depth-2 transformers at level 1 only, the
# additive conditioning (16 pooled + 6 fourier blocks x 8 = 64)
TINY_XL = PipelineConfig(
    clip=CLIPConfig(vocab_size=512 + 22 + 2, hidden=32, layers=2, heads=2,
                    context_len=16),
    clip2=CLIPConfig(vocab_size=512 + 22 + 2, hidden=48, layers=3, heads=2,
                     context_len=16, act="gelu", projection=16),
    unet=UNetConfig(model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                    attn_levels=(1,), transformer_depth=(0, 2), num_heads=2,
                    context_dim=80, time_embed_dim=64, groups=4,
                    adm_in_channels=64),
    vae=VAEConfig(base_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                  groups=4),
    latent_size=8,
    upscale=2,
    dtype="float32",
)

# the refiner's topology at TINY (CPU tests): one tower, five
# micro-conditions (16 pooled + 5 x 8 = 56)
TINY_XL_REF = PipelineConfig(
    clip=CLIPConfig(vocab_size=512 + 22 + 2, hidden=48, layers=3, heads=2,
                    context_len=16, act="gelu", projection=16),
    clip2=CLIPConfig(vocab_size=512 + 22 + 2, hidden=48, layers=3, heads=2,
                     context_len=16, act="gelu", projection=16),
    unet=UNetConfig(model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                    attn_levels=(1,), transformer_depth=(0, 2), num_heads=2,
                    context_dim=48, time_embed_dim=64, groups=4,
                    adm_in_channels=56),
    vae=VAEConfig(base_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                  groups=4),
    latent_size=8,
    upscale=2,
    dtype="float32",
    refiner=True,
)

# LCM and the x4 upscaler at TINY (CPU tests): an 8-wide guidance
# embedding; 7 input channels, cross-only attention at level 0, a 20-row
# class table, an f2 VAE
TINY_LCM = dataclasses.replace(
    TINY, unet=dataclasses.replace(TINY.unet, time_cond_proj_dim=8))
TINY_X4 = dataclasses.replace(
    TINY,
    unet=dataclasses.replace(TINY.unet, in_channels=7,
                             cross_only_levels=(0,), num_class_embeds=20),
    max_noise_level=16,
    prediction="v",
)

# the concat-conditioned variants at TINY (CPU tests)
TINY_INPAINT = dataclasses.replace(
    TINY, unet=dataclasses.replace(TINY.unet, in_channels=9))
TINY_DEPTH = dataclasses.replace(
    TINY, unet=dataclasses.replace(TINY.unet, in_channels=5))
TINY_IP2P = dataclasses.replace(
    TINY, unet=dataclasses.replace(TINY.unet, in_channels=8))
TINY_XL_INPAINT = dataclasses.replace(
    TINY_XL, unet=dataclasses.replace(TINY_XL.unet, in_channels=9))

#: name -> config registry (Context(config=...))
CONFIGS = {
    "sd15": SD15,
    "sd15_inpaint": SD15_INPAINT,
    "sd15_ip2p": SD15_IP2P,
    "sd15_lcm": SD15_LCM,
    "sd21": SD21,
    "sd21_inpaint": SD21_INPAINT,
    "sd21base": SD21_BASE,
    "sd2_depth": SD2_DEPTH,
    "sd_x4": SD_X4,
    "sdxl": SDXL,
    "sdxl_inpaint": SDXL_INPAINT,
    "sdxl_refiner": SDXL_REFINER,
    "tiny": TINY,
    "tiny_inpaint": TINY_INPAINT,
    "tiny_lcm": TINY_LCM,
    "tiny_x4": TINY_X4,
    "tiny_depth": TINY_DEPTH,
    "tiny_ip2p": TINY_IP2P,
    "tiny_xl": TINY_XL,
    "tiny_xl_inpaint": TINY_XL_INPAINT,
    "tiny_xl_ref": TINY_XL_REF,
}

