"""The prompt -> image pipeline, the counterpart of
``sdtpu/engine/pipeline.py``'s txt2img path with DPM-Solver++(2M):

    tokens --CLIP--> cond embedding --+
    cached uncond ("") embedding -----+
    timesteps --temb MLP--> table ----+   (all steps, before the loop)
                                      v
    x ~ N(0,1) --steps x [UNet on the batch-2 CFG pair -> CFG mix -> DPM
    step]--> latent --VAE--> RGB float --round/clamp--> uint8

The latents and the solver state stay float32; only the UNet input is cast
to the compute dtype, and eps comes back as float32. PyTorch runs the loop
eagerly, one UNet call per step.
"""

from __future__ import annotations

import torch

from sdtpu_torch.config import PipelineConfig
from sdtpu_torch.models import clip, temb, unet, vae
from sdtpu_torch.samplers import dpm
from sdtpu_torch.samplers.schedule import NoiseSchedule


def encode_text(params, tokens, cfg: PipelineConfig):
    """tokens [B, T] -> prompt embeddings [B, T, context_dim]."""
    return clip.apply(params["clip"], tokens, cfg.clip,
                      dtype=cfg.compute_dtype)


def _build_context(params, tokens, uncond_embedding, cfg, use_cfg):
    """Cond rows, then the uncond embedding [T, D] broadcast over the
    batch: the context of the batch-2B CFG eval."""
    p_cond = encode_text(params, tokens, cfg)
    if not use_cfg:
        return p_cond
    p_un = uncond_embedding.to(p_cond.dtype).expand(p_cond.shape)
    return torch.cat([p_cond, p_un], dim=0)


def decode_latents(params, x, cfg: PipelineConfig, kernels: str = "plain"):
    """Scaled f32 latents [B,h,w,4] -> uint8 RGB [B,H,W,3]. The latents are
    cast to the compute dtype before the VAE; ``torch.round`` rounds half
    to even, as ``jnp.round`` does."""
    z = (x / cfg.vae.scale_factor).to(cfg.compute_dtype)
    img = vae.apply(params["vae"], z, cfg.vae, kernels)
    img = (img.float() + 1.0) * 127.5
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def denoise(params, context, generator, guidance, cfg: PipelineConfig,
            steps: int, use_cfg: bool, kernels: str = "plain", noise=None):
    """Run the denoising loop. context: [B or 2B, T, D]; with ``use_cfg``
    rows [0:B] are cond and [B:2B] uncond.

    The initial latents are float32 ``torch.randn`` from ``generator`` on
    the context's device. They do not reproduce the JAX package's threefry
    bits for the same seed. ``noise`` ([B, h, w, C] float32) replaces that
    draw: it is the seam through which tests hand both pipelines the same
    latents."""
    device = context.device
    dtype = cfg.compute_dtype
    p = dpm.plan(NoiseSchedule.sd_v1(), steps, device)
    b = context.shape[0] // (2 if use_cfg else 1)
    shape = (b, cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    if noise is not None:
        x = torch.as_tensor(noise, dtype=torch.float32, device=device)
        if tuple(x.shape) != shape:
            raise ValueError(f"noise shape {tuple(x.shape)} != {shape}")
    else:
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
    # every step's time embedding in one batched MLP call, before the loop
    t_embs = temb.apply(params["temb"], p.model_t, cfg.unet, dtype=dtype)
    g = torch.tensor(guidance, dtype=torch.float32, device=device)
    state = dpm.init_state(x)
    for i in range(steps):
        te = t_embs[i].expand(context.shape[0], -1)
        x_in = (torch.cat([x, x], dim=0) if use_cfg else x).to(dtype)
        eps = unet.apply(params["unet"], x_in, te, context, cfg.unet,
                         kernels).float()
        if use_cfg:
            eps = g * eps[:b] + (1.0 - g) * eps[b:]
        x, state = dpm.step(p, i, x, eps, state)
    return x


def generate(params, tokens, uncond_embedding, generator, guidance, *,
             cfg: PipelineConfig, steps: int = 20, use_cfg: bool = True,
             kernels: str = "plain", noise=None, output: str = "image"):
    """tokens [B, T] -> uint8 [B, H, W, 3], or with ``output="latent"`` the
    float32 scale-factored latents. ``uncond_embedding``: [T, D], encoded
    once by the caller. ``noise``: see ``denoise``."""
    context = _build_context(params, tokens, uncond_embedding, cfg, use_cfg)
    x = denoise(params, context, generator, guidance, cfg, steps, use_cfg,
                kernels, noise=noise)
    if output == "latent":
        return x
    return decode_latents(params, x, cfg, kernels)
