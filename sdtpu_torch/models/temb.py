"""Time-embedding MLP: sinusoidal features -> time_embed_dim embedding,
the counterpart of ``sdtpu/models/temb.py`` (``Linear -> SiLU -> Linear``).
The pipeline embeds every step's timestep once, before the loop."""

from __future__ import annotations

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
