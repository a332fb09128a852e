"""The prompt -> image pipeline, the counterpart of
``sdtpu/engine/pipeline.py``'s txt2img path, for SD1.x, SD2.x (v- or
eps-prediction) and SDXL (two towers, a packed pooled row, the additive
conditioning):

    tokens --CLIP--> cond embedding (weighted, chunked) --+
    uncond embedding ("", or a negative prompt a sample) -+
    timesteps --temb MLP--> table (all steps) ------------+
                                                          v
    x ~ N(0,1) --steps x [UNet on the batch-2B CFG pair -> CFG mix (a
    guidance a sample) -> sampler step]--> latent --VAE--> RGB float
    --round/clamp--> uint8

The latents and the sampler state stay float32; only the UNet input is cast
to the compute dtype, and eps comes back as float32 (a v-prediction model's
output converted to eps there, per CFG slot). PyTorch runs the loop
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
    no-op.

    Dual-tower configurations (SDXL, ``cfg.clip2``): each window goes
    through both towers (``clip.apply_xl``), whose penultimate hidden
    states concatenate to [.., 2048]; tower 2's pooled embedding (of
    window 0 in the chunked form) is packed after the weighting as one
    extra trailing row, zero-padded to the context width: [B, T+1, D]
    (``sdtpu/engine/pipeline.py:39-150``). One array thus carries the whole
    text conditioning through batching and negative prompts;
    ``_unpack_context`` splits it at the UNet."""
    chunked = tokens.dim() == 3
    b = tokens.shape[0]
    flat = tokens.reshape(-1, tokens.shape[-1])
    dt = cfg.compute_dtype
    pooled = None
    if cfg.clip2 is None:
        emb = clip.apply(params["clip"], flat, cfg.clip, dtype=dt)
    else:
        h2, pooled = clip.apply_xl(params["clip2"], flat, cfg.clip2,
                                   cfg.clip2.vocab_size - 1, dtype=dt)
        h1, _ = clip.apply_xl(params["clip"], flat, cfg.clip,
                              cfg.clip.vocab_size - 1, dtype=dt)
        emb = torch.cat([h1, h2], dim=-1)
        pooled = pooled.reshape(b, -1, pooled.shape[-1])[:, 0]
    emb = emb.reshape(b, -1, emb.shape[-1])
    if chunked and weights is not None:
        k, t = tokens.shape[1:]
        w = torch.as_tensor(weights, device=emb.device).reshape(b, k * t, 1)
        old_mean = emb.float().mean(dim=(1, 2), keepdim=True)
        emb = emb * w.to(emb.dtype)
        g = emb.float()
        new_mean = g.mean(dim=(1, 2), keepdim=True)
        rms = torch.sqrt((g * g).mean(dim=(1, 2), keepdim=True))
        ok = new_mean.abs() > 1e-4 * rms
        one = torch.ones_like(new_mean)
        scale = torch.where(ok, old_mean / torch.where(ok, new_mean, one),
                            one)
        emb = emb * scale.to(emb.dtype)
    if pooled is None:
        return emb
    row = torch.zeros((b, 1, emb.shape[-1]), dtype=emb.dtype,
                      device=emb.device)
    row[:, 0, : pooled.shape[-1]] = pooled.to(emb.dtype)
    return torch.cat([emb, row], dim=1)


def _unpack_context(context, cfg: PipelineConfig):
    """Packed text conditioning -> (cross-attention context, pooled [CB,
    projection] or None). The context is made contiguous: a slice of the
    packed rows is not, and the int8 GEMM kernels' rule takes contiguous
    activations only (attn2's k and v read it)."""
    if cfg.clip2 is None:
        return context, None
    return (context[:, :-1, :].contiguous(),
            context[:, -1, : cfg.clip2.projection])


def _add_embedding(params, pooled, cfg: PipelineConfig):
    """SDXL's additive conditioning: pooled [CB, P] and the six static
    micro-conditions' fourier features -> [CB, time_embed_dim], added to
    every step's time embedding."""
    fdim = (cfg.unet.adm_in_channels - cfg.clip2.projection) // 6
    micro = temb.micro_features(cfg, fdim, pooled.device).to(pooled.dtype)
    y = torch.cat([pooled, micro[None].expand(pooled.shape[0], -1)], dim=-1)
    return temb.apply_vec(params["add_mlp"], y, dtype=cfg.compute_dtype)


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
    branch), the uncond rows from ``context``; single-tower configurations
    only, as in the reference.

    SDXL: ``context`` is packed (``encode_text``); its pooled rows give the
    additive embedding, added to every eval's time embedding. A
    v-prediction model's output is turned into eps before the CFG mix."""
    device = context.device
    dtype = cfg.compute_dtype
    context, pooled = _unpack_context(context, cfg)
    add_emb = (None if pooled is None
               else _add_embedding(params, pooled, cfg))
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
        if add_emb is not None:
            te = te + add_emb.to(te.dtype)
        x_rep = torch.cat([x, x], dim=0) if use_cfg else x
        eps = unet.apply(params["unet"], x_rep.to(dtype), te, rows(i),
                         cfg.unet, kernels).float()
        if cfg.prediction == "v":
            # v = alpha*eps - sigma*x0  =>  eps = alpha*v + sigma*x_t, per
            # CFG slot; the second eval takes the probe point's marginals
            a_i = (plan.alpha_m if second else plan.alpha_s)[i]
            s_i = (plan.sigma_m if second else plan.sigma_s)[i]
            eps = a_i * eps + s_i * x_rep
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
