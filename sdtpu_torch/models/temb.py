"""Time-embedding MLP: sinusoidal features -> time_embed_dim embedding,
the counterpart of ``sdtpu/models/temb.py`` (``Linear -> SiLU -> Linear``).
The pipeline embeds every step's timestep once, before the loop. SDXL's
additive conditioning (``init_add``, ``apply_vec``, ``micro_features``) is
the same MLP shape over the pooled text embedding and the micro-conditions;
its output adds to every step's time embedding."""

from __future__ import annotations

import torch

from sdtpu_torch.config import UNetConfig
from sdtpu_torch.models.layers import dense, init_dense, silu, timestep_features


def init(cfg: UNetConfig, generator, device):
    return {
        "fc0": init_dense(cfg.model_channels, cfg.time_embed_dim, generator,
                          device),
        "fc1": init_dense(cfg.time_embed_dim, cfg.time_embed_dim, generator,
                          device),
    }


def apply(params, t, cfg: UNetConfig, dtype=None):
    """t: [...] float timesteps -> [..., time_embed_dim] embeddings."""
    feats = timestep_features(t, cfg.model_channels)
    if dtype is not None:
        feats = feats.to(dtype)
    h = dense(params["fc0"], feats)
    return dense(params["fc1"], silu(h))


def init_add(cfg: UNetConfig, generator, device):
    """SDXL's additive-conditioning MLP (``add_embedding``):
    ``adm_in_channels -> time_embed_dim -> time_embed_dim``."""
    return {
        "fc0": init_dense(cfg.adm_in_channels, cfg.time_embed_dim, generator,
                          device),
        "fc1": init_dense(cfg.time_embed_dim, cfg.time_embed_dim, generator,
                          device),
    }


def apply_vec(params, y, dtype=None):
    """y: [..., adm_in_channels] -> [..., time_embed_dim]."""
    if dtype is not None:
        y = y.to(dtype)
    return dense(params["fc1"], silu(dense(params["fc0"], y)))


def micro_features(cfg, fourier_dim: int, device=None):
    """txt2img's micro-conditions (original_h, original_w, crop_top,
    crop_left, target_h, target_w) = (H, W, 0, 0, H, W), each through
    ``timestep_features(., fourier_dim)``, flattened: [6 * fourier_dim],
    float32. Constant for a configuration."""
    s = float(cfg.image_size)
    vals = torch.tensor([s, s, 0.0, 0.0, s, s], dtype=torch.float32,
                        device=device)
    return timestep_features(vals, fourier_dim).reshape(-1)
