"""The prompt -> image pipeline, the counterpart of
``sdtpu/engine/pipeline.py``'s txt2img path:

    tokens --CLIP--> cond embedding (weighted, chunked) --+
    uncond embedding ("", or a negative prompt a sample) -+
    timesteps --temb MLP--> table (all steps) ------------+
                                                          v
    x ~ N(0,1) --steps x [UNet on the batch-2B CFG pair -> CFG mix (a
    guidance a sample) -> sampler step]--> latent --VAE--> RGB float
    --round/clamp--> uint8

The latents and the sampler state stay float32; only the UNet input is cast
to the compute dtype, and eps comes back as float32. PyTorch runs the loop
eagerly: one UNet call a step, two for heun and dpm2, and one more on
``plms_exact``'s first step. Every sampler's ``step`` is tensor math with no
branch on a value.
"""

from __future__ import annotations

import torch

from sdtpu_torch.config import PipelineConfig
from sdtpu_torch.models import clip, temb, unet, vae
from sdtpu_torch.samplers import get_sampler
from sdtpu_torch.samplers.schedule import NoiseSchedule


def encode_text(params, tokens, cfg: PipelineConfig, weights=None):
    """tokens [B, T] -> prompt embeddings [B, T, context_dim].

    The chunked long-prompt form (``sdtpu_torch.text``): tokens [B, k, T]
    encode each window separately, and the hidden states concatenate to
    [B, k*T, D] (cross-attention takes any length). ``weights`` [B, k, T]
    scale each token's embedding; then each sample's mean is restored to
    its value before the weighting (the A1111 normalization), unless that
    mean is degenerate (|mean| <= 1e-4 rms). All-ones weights are an exact
    no-op."""
    if tokens.dim() == 2:
        return clip.apply(params["clip"], tokens, cfg.clip,
                          dtype=cfg.compute_dtype)
    b, k, t = tokens.shape
    emb = clip.apply(params["clip"], tokens.reshape(b * k, t), cfg.clip,
                     dtype=cfg.compute_dtype)
    emb = emb.reshape(b, k * t, emb.shape[-1])
    if weights is None:
        return emb
    w = torch.as_tensor(weights, device=emb.device).reshape(b, k * t, 1)
    old_mean = emb.float().mean(dim=(1, 2), keepdim=True)
    emb = emb * w.to(emb.dtype)
    g = emb.float()
    new_mean = g.mean(dim=(1, 2), keepdim=True)
    rms = torch.sqrt((g * g).mean(dim=(1, 2), keepdim=True))
    ok = new_mean.abs() > 1e-4 * rms
    one = torch.ones_like(new_mean)
    scale = torch.where(ok, old_mean / torch.where(ok, new_mean, one), one)
    return emb * scale.to(emb.dtype)


def _build_context(params, tokens, uncond_embedding, cfg, use_cfg,
                   weights=None):
    """Cond rows, then the uncond rows: the context of the batch-2B CFG
    eval. ``uncond_embedding``: [T, D], shared by the batch, or [B, T, D],
    one a sample (negative prompts in batched serving)."""
    p_cond = encode_text(params, tokens, cfg, weights)
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


def draw_noise(generator, shape, steps: int, with_steps: bool, device):
    """The starting latents [B, h, w, C] and, with ``with_steps``, every
    step's standard-normal draw [steps, B, h, w, C]: float32
    ``torch.randn`` on ``device``.

    ``generator``: one ``torch.Generator`` for the batch (``generate``),
    which draws the latents of all samples, then the step noise; or a list
    of one a sample (batched serving), each drawing its sample's latents,
    then its step noise, so that a request's numbers do not depend on its
    batch-mates (the reference's one PRNG key a sample). A batch of one
    gets the same numbers either way. The bits are not the JAX package's
    threefry bits."""
    def draw(g, shp):
        x = torch.randn(shp, generator=g, device=device, dtype=torch.float32)
        n = (torch.randn((steps,) + shp, generator=g, device=device,
                         dtype=torch.float32) if with_steps else None)
        return x, n

    if isinstance(generator, (list, tuple)):
        if len(generator) != shape[0]:
            raise ValueError(f"{len(generator)} generators for a batch of "
                             f"{shape[0]}")
        pairs = [draw(g, tuple(shape[1:])) for g in generator]
        x = torch.stack([x for x, _ in pairs])
        n = torch.stack([n for _, n in pairs], dim=1) if with_steps else None
        return x, n
    return draw(generator, tuple(shape))


def _seam(a, shape, device, name):
    t = torch.as_tensor(a, dtype=torch.float32, device=device)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    return t


def denoise(params, context, generator, guidance, cfg: PipelineConfig,
            steps: int, use_cfg: bool, kernels: str = "plain", noise=None,
            *, sampler: str = "dpm", step_noise=None, cond_schedule=None):
    """Run the denoising loop with ``sampler`` (a name of
    ``samplers.SAMPLERS``). context: [B or 2B, T, D]; with ``use_cfg`` rows
    [0:B] are cond and [B:2B] uncond. ``guidance``: a scalar or one a
    sample, [B].

    ``generator``: see ``draw_noise``. ``noise`` ([B, h, w, C] float32)
    replaces the starting latents and ``step_noise`` ([steps, B, h, w, C],
    or a callable of the step index giving [B, h, w, C]) the step noise of
    a ``NEEDS_NOISE`` sampler: the seams through which tests hand both
    pipelines the JAX package's draws.

    Two-eval samplers (``NEEDS_SECOND_EVAL``, heun and dpm2) evaluate the
    UNet again at ``predictor``'s probe point, with the time embeddings of
    the plan's ``model_t2``. ``plms_exact`` spends two evals on step 0
    (CompVis's pseudo improved Euler) and keeps ``e_t`` in its history.

    Prompt scheduling: ``cond_schedule`` = (table [V, B, T, D], idx
    [steps] int64 on the device); every UNet eval of step i takes its cond
    rows from variant ``idx[i]`` (gathered on the device: no host sync, no
    branch), the uncond rows from ``context``."""
    device = context.device
    dtype = cfg.compute_dtype
    mod = get_sampler(sampler)
    plan = mod.plan(NoiseSchedule.sd_v1(), steps, device=device)
    b = context.shape[0] // (2 if use_cfg else 1)
    shape = (b, cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    needs_noise = getattr(mod, "NEEDS_NOISE", False)
    needs_second = getattr(mod, "NEEDS_SECOND_EVAL", False)
    with_steps = needs_noise and step_noise is None
    if noise is None or with_steps:
        x, drawn = draw_noise(generator, shape, steps, with_steps, device)
    if noise is not None:
        x = _seam(noise, shape, device, "noise")
    if with_steps:
        step_noise = drawn
    elif needs_noise and not callable(step_noise):
        step_noise = _seam(step_noise, (steps,) + shape, device, "step_noise")
    # every step's time embedding in one batched MLP call, before the loop
    t_embs = temb.apply(params["temb"], plan.model_t, cfg.unet, dtype=dtype)
    t_embs2 = (temb.apply(params["temb"], plan.model_t2, cfg.unet,
                          dtype=dtype) if needs_second else None)
    g = torch.as_tensor(guidance, dtype=torch.float32, device=device)
    if g.dim():
        g = g.reshape(-1, 1, 1, 1)

    def rows(i):
        if cond_schedule is None:
            return context
        table, idx = cond_schedule
        cond = table.index_select(0, idx[i:i + 1])[0]
        return torch.cat([cond, context[b:]], dim=0) if use_cfg else cond

    def predict_eps(x, i, second=False):
        te = (t_embs2 if second else t_embs)[i].expand(context.shape[0], -1)
        x_in = (torch.cat([x, x], dim=0) if use_cfg else x).to(dtype)
        eps = unet.apply(params["unet"], x_in, te, rows(i), cfg.unet,
                         kernels).float()
        if use_cfg:
            eps = g * eps[:b] + (1.0 - g) * eps[b:]
        return eps

    state = mod.init_state(x)
    start = 0
    if sampler.lower() == "plms_exact":
        # a second UNet eval at the next time refines eps before the step-0
        # update; the history takes e_t, not the average
        e_t = predict_eps(x, 0)
        x_mid, _ = mod.step(plan, 0, x, e_t, state)
        e_next = predict_eps(x_mid, min(1, steps - 1))
        x, _ = mod.step(plan, 0, x, 0.5 * (e_t + e_next), state)
        _, state = mod.step(plan, 0, x_mid, e_t, state)
        start = 1
    for i in range(start, steps):
        eps = predict_eps(x, i)
        if needs_second:
            eps2 = predict_eps(mod.predictor(plan, i, x, eps), i, second=True)
            x, state = mod.step(plan, i, x, eps, state, eps2=eps2)
        elif needs_noise:
            n_i = (_seam(step_noise(i), shape, device, "step_noise")
                   if callable(step_noise) else step_noise[i])
            x, state = mod.step(plan, i, x, eps, state, noise=n_i)
        else:
            x, state = mod.step(plan, i, x, eps, state)
    return x


def generate(params, tokens, uncond_embedding, generator, guidance, *,
             cfg: PipelineConfig, sampler: str = "dpm", steps: int = 20,
             use_cfg: bool = True, kernels: str = "plain", noise=None,
             step_noise=None, output: str = "image", token_weights=None,
             sched_idx=None):
    """tokens [B, T] (or chunked [B, k, T] with ``token_weights``) -> uint8
    [B, H, W, 3], or with ``output="latent"`` the float32 scale-factored
    latents. ``uncond_embedding``: [T, D] or [B, T, D], encoded by the
    caller. ``generator``, ``noise``, ``step_noise``: see ``denoise``.

    Prompt scheduling (``sdtpu/engine/pipeline.py:653-667``): with
    ``sched_idx`` ([steps] integer, each step's variant), tokens are [V, B,
    k, T] (+ weights): the V variants encode into one table [V, B, k*T, D]
    in one call, and step i conditions on variant ``sched_idx[i]``."""
    cond_schedule = None
    if sched_idx is not None:
        v, bsz, k, t = tokens.shape
        w = (None if token_weights is None
             else torch.as_tensor(token_weights).reshape(v * bsz, k, t))
        emb = encode_text(params, tokens.reshape(v * bsz, k, t), cfg, w)
        table = emb.reshape(v, bsz, *emb.shape[1:])
        context = table[0]
        if use_cfg:
            p_un = uncond_embedding.to(table.dtype).expand(context.shape)
            context = torch.cat([context, p_un], dim=0)
        idx = torch.as_tensor(sched_idx, dtype=torch.int64,
                              device=table.device)
        cond_schedule = (table, idx)
    else:
        context = _build_context(params, tokens, uncond_embedding, cfg,
                                 use_cfg, weights=token_weights)
    x = denoise(params, context, generator, guidance, cfg, steps, use_cfg,
                kernels, noise=noise, sampler=sampler, step_noise=step_noise,
                cond_schedule=cond_schedule)
    if output == "latent":
        return x
    return decode_latents(params, x, cfg, kernels)
