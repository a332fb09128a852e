"""Time-embedding MLP: sinusoidal features -> time_embed_dim embedding,
the counterpart of ``sdtpu/models/temb.py`` (``Linear -> SiLU -> Linear``).
The pipeline embeds every step's timestep once, before the loop. SDXL's
additive conditioning (``init_add``, ``apply_vec``, ``micro_features``) is
the same MLP shape over the pooled text embedding and the micro-conditions;
its output adds to every step's time embedding. LCM's guidance embedding
(``guidance_scale_features`` through ``cond_proj``) adds to the time
features before the MLP."""

from __future__ import annotations

import math

import torch

from sdtpu_torch.config import UNetConfig
from sdtpu_torch.models.layers import (dense, gather_columns, init_dense, silu,
                                      timestep_features)


def init(cfg: UNetConfig, generator, device):
    p = {
        "fc0": init_dense(cfg.model_channels, cfg.time_embed_dim, generator,
                          device),
        "fc1": init_dense(cfg.time_embed_dim, cfg.time_embed_dim, generator,
                          device),
    }
    if cfg.time_cond_proj_dim:
        # LCM's guidance projection (diffusers ``cond_proj``): bias-free,
        # added to the sinusoidal features before fc0
        p["cond_proj"] = init_dense(cfg.time_cond_proj_dim,
                                    cfg.model_channels, generator, device,
                                    bias=False)
    return p


def apply(params, t, cfg: UNetConfig, dtype=None, cond=None,
          cond_align: str = "outer"):
    """t: [...] float timesteps -> [..., time_embed_dim] embeddings
    (``sdtpu/models/temb.py:22-55``).

    ``cond``: guidance-scale features [time_cond_proj_dim] (one guidance)
    or [B, time_cond_proj_dim] (one a sample), projected by ``cond_proj``
    and added to the timestep features. With t [steps] and a [B, F] cond
    the result is [steps, B, D] under ``cond_align="outer"``; ``"aligned"``
    adds elementwise, for t already one a sample ([B] with [B, F])."""
    if cond_align not in ("outer", "aligned"):
        raise ValueError(f"cond_align must be outer|aligned, got "
                         f"{cond_align!r}")
    feats = timestep_features(t, cfg.model_channels)
    if cond is not None:
        proj = dense(params["cond_proj"], cond.to(feats.dtype))
        if cond_align == "outer" and proj.dim() == 2 and feats.dim() == 2:
            feats = feats[:, None, :] + proj[None, :, :]
        else:
            feats = feats + proj
    if dtype is not None:
        feats = feats.to(dtype)
    h = dense(params["fc0"], feats)
    return _fc1(params["fc1"], silu(h))


def _fc1(p, h):
    """The MLP's second product: on the mesh a lone column-parallel site
    (``parallel.sharding``), its columns gathered over the model group."""
    return gather_columns(p, dense(p, h))


def guidance_scale_features(w, dim: int, device=None):
    """Sinusoidal guidance-scale features in diffusers'
    ``get_guidance_scale_embedding`` convention (``sdtpu/models/temb.py:62``):
    ``[sin | cos]`` halves of ``w * 1000 * exp(-log(10000) j / (half -
    1))``, unlike ``timestep_features``' ``[cos | sin]`` over ``half``.
    ``w``: a scalar or [B] (the pipeline passes guidance - 1) -> [..., dim]
    float32."""
    half = dim // 2
    w = torch.as_tensor(w, dtype=torch.float32, device=device)
    freqs = torch.exp(
        -math.log(10000.0)
        * torch.arange(half, dtype=torch.float32, device=w.device)
        / max(half - 1, 1))
    args = w[..., None] * 1000.0 * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


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
    return _fc1(params["fc1"], silu(dense(params["fc0"], y)))


def micro_features(cfg, fourier_dim: int, device=None):
    """The micro-conditions, each through ``timestep_features(.,
    fourier_dim)``, flattened, float32; constant for a configuration.
    txt2img's six (original_h, original_w, crop_top, crop_left, target_h,
    target_w) = (H, W, 0, 0, H, W); the refiner's five (original_h,
    original_w, crop_top, crop_left, aesthetic_score)."""
    s = float(cfg.image_size)
    vals = ([s, s, 0.0, 0.0, cfg.aesthetic_score] if cfg.refiner
            else [s, s, 0.0, 0.0, s, s])
    vals = torch.tensor(vals, dtype=torch.float32, device=device)
    return timestep_features(vals, fourier_dim).reshape(-1)
