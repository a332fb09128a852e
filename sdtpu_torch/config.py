"""Model/pipeline configuration for the PyTorch port.

Carried over from ``sdtpu/config.py`` (the JAX package), cut to the fields
the SD v1.5 txt2img path reads. Field names, defaults and the ``SD15`` and
``TINY`` values are the JAX package's; ``tests/test_torch_slice.py`` pins
them against it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

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
    # A1111 "CLIP skip": run `layers - skip_last` blocks, then the final LN
    # (skip_last = clip_skip - 1). Set via Context(clip_skip=...)
    skip_last: int = 0


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_levels: Tuple[int, ...] = (0, 1, 2)   # levels with spatial transformers
    num_heads: int = 8
    context_dim: int = 768
    time_embed_dim: int = 1280                 # = 4 * model_channels
    groups: int = 32


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
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    latent_channels: int = 4
    latent_size: int = 64
    upscale: int = 8          # VAE upsampling factor
    dtype: str = "bfloat16"   # activation/compute dtype

    @property
    def image_size(self) -> int:
        return self.latent_size * self.upscale

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


SD15 = PipelineConfig()

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

#: name -> config registry (Context(config=...))
CONFIGS = {
    "sd15": SD15,
    "tiny": TINY,
}
