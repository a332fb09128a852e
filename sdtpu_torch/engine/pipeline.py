"""The prompt -> image pipeline, the counterpart of
``sdtpu/engine/pipeline.py``'s txt2img and image-conditioned paths, for
SD1.x, SD2.x (v- or eps-prediction) and SDXL (two towers, a packed pooled
row, the additive conditioning), their concat-conditioned UNets (inpaint,
depth, InstructPix2Pix), and the staged configurations: LCM (the guidance
embedded, no CFG batch), the SDXL refiner's second stage (``refine``
after ``generate(end_step=)``) and the x4 upscaler (``upscale``):

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

The image paths (``img2img``, ``inpaint``, ``hires_refine``,
``instruct_pix2pix``) encode an image with the VAE encoder, start the loop
at ``start_step`` from its noised latents, and may re-pin a masked region
or feed extra planes to the UNet at every step (``denoise``); a call's
random draws follow ``draw_noise``'s rule.

On the mesh (``sdtpu_torch.parallel``), each entry point takes the whole
call's inputs and draws on every rank, keeps this rank's rows of the data
axis (``_rows``; the draws sliced after ``_draws`` made them all, so a
rank's numbers are those of one device) and gathers the results over the
data group (``_finish``); the model axis acts inside the models.

The Context knobs act in ``denoise``: the CFG interval splits the loop into
segments (``segments``), CFG rescale and PAG change each step's eps,
DeepCache alternates full and shallow UNet evals; ``check_knobs`` holds
what does not compose. ControlNet (``denoise``'s ``hint``) runs each
adapter's encoder copy beside every UNet eval and adds its residuals to
the UNet's skips.
"""

from __future__ import annotations

import dataclasses

import torch

from sdtpu_torch.config import PipelineConfig
from sdtpu_torch.models import clip, controlnet, temb, unet, vae
from sdtpu_torch.parallel.sharding import data_rows, gather_rows
from sdtpu_torch.samplers import get_sampler
from sdtpu_torch.samplers.schedule import NoiseSchedule, to_f32


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
    ``_unpack_context`` splits it at the UNet. The refiner (``cfg.refiner``)
    has tower 2 alone: its hidden states are the context, its pooled
    embedding packs as XL's does (``sdtpu/engine/pipeline.py:74-80,
    118-121``)."""
    chunked = tokens.dim() == 3
    b = tokens.shape[0]
    flat = tokens.reshape(-1, tokens.shape[-1])
    dt = cfg.compute_dtype
    pooled = None
    if cfg.clip2 is None:
        emb = clip.apply(params["clip"], flat, cfg.clip, dtype=dt)
    else:
        emb, pooled = clip.apply_xl(params["clip2"], flat, cfg.clip2,
                                    cfg.clip2.vocab_size - 1, dtype=dt)
        if not cfg.refiner:
            h1, _ = clip.apply_xl(params["clip"], flat, cfg.clip,
                                  cfg.clip.vocab_size - 1, dtype=dt)
            emb = torch.cat([h1, emb], dim=-1)
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
    """SDXL's additive conditioning: pooled [CB, P] and the static
    micro-conditions' fourier features (six blocks; the refiner's five,
    ``temb.micro_features``) -> [CB, time_embed_dim], added to every step's
    time embedding."""
    n = 5 if cfg.refiner else 6
    fdim = (cfg.unet.adm_in_channels - cfg.clip2.projection) // n
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


#: the draws of a request's generator, in the order it makes them
DRAW_ORDER = ("noise", "step_noise", "posterior_noise", "masked_noise",
              "pin_noise", "aug_noise")
#: the draws with one value a step, [steps, B, h, w, C]
_PER_STEP = ("step_noise", "pin_noise")


def _draw_shape(name, shape, steps):
    """A draw's shape: the latent ``shape`` [B, h, w, C], [steps, ...] for
    a per-step draw, [B, h, w, 3] (the low-res image's) for
    ``aug_noise``."""
    if name in _PER_STEP:
        return (steps,) + tuple(shape)
    if name == "aug_noise":
        return tuple(shape[:-1]) + (3,)
    return tuple(shape)


def draw_noise(generator, shape, steps: int, names, device):
    """The standard-normal draws of a call: float32 ``torch.randn`` on
    ``device``, a dict of the ``names`` asked for (names of
    ``DRAW_ORDER``), each of the latent shape ``shape`` [B, h, w, C], or
    [steps, B, h, w, C] for ``step_noise`` and ``pin_noise``, or the
    low-res image's [B, h, w, 3] for ``aug_noise``.

    The rule of the draws, which replaces the JAX package's fold_in tags
    (``sdtpu/engine/pipeline.py:737-746``; the bits are not its threefry
    bits): a generator makes, in this order and only those the call uses,
      1. ``noise``: the starting latents (pure noise, or the noise a warm
         start forward-diffuses its clean latents with);
      2. ``step_noise``: a ``NEEDS_NOISE`` sampler's step draws;
      3. ``posterior_noise``: the VAE posterior sample of the init image
         (img2img, depth, a standard inpaint, a 9-ch inpaint with a warm
         start);
      4. ``masked_noise``: the posterior sample of the masked image (a 9-ch
         inpaint);
      5. ``pin_noise``: a standard inpaint's re-pin of the kept region at
         each step;
      6. ``aug_noise``: the x4 upscaler's noise augmentation of its low-res
         image.

    ``generator``: one ``torch.Generator`` for the batch (``generate``, the
    image paths on a list of prompts), which makes each draw for all
    samples at once; or a list of one a sample (batched serving), each
    making its sample's draws in the same order, so that a request's
    numbers do not depend on its batch-mates (the reference's one PRNG key
    a sample). A batch of one gets the same numbers either way. The hires
    fix's second pass continues the generator of its first pass, so its
    draws are not a prefix of the first pass's."""
    unknown = set(names) - set(DRAW_ORDER)
    if unknown:
        raise ValueError(f"unknown draws {sorted(unknown)}")
    names = [n for n in DRAW_ORDER if n in names]

    def draw(g, shp):
        return {k: torch.randn(_draw_shape(k, shp, steps), generator=g,
                               device=device, dtype=torch.float32)
                for k in names}

    if not isinstance(generator, (list, tuple)):
        return draw(generator, tuple(shape))
    if len(generator) != shape[0]:
        raise ValueError(f"{len(generator)} generators for a batch of "
                         f"{shape[0]}")
    per = [draw(g, tuple(shape[1:])) for g in generator]
    return {k: torch.stack([p[k] for p in per],
                           dim=1 if k in _PER_STEP else 0) for k in names}


def _seam(a, shape, device, name):
    t = torch.as_tensor(a, dtype=torch.float32, device=device)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    return t


def _latent_shape(b, cfg: PipelineConfig):
    return (b, cfg.latent_size, cfg.latent_size, cfg.latent_channels)


def _draws(generator, shape, steps, sampler, device, seams, extra=()):
    """The draws of a pipeline call, the only place they are made:
    ``noise``, a ``NEEDS_NOISE`` sampler's ``step_noise`` and the ``extra``
    ones (names of ``DRAW_ORDER``). Each comes from its seam in ``seams``
    where the caller gave one (a tensor or an array; for ``step_noise`` and
    ``pin_noise`` also a callable of the step, checked at each step), else
    from ``generator`` by ``draw_noise``'s rule (all of them then, so the
    order never shifts). ``shape`` is the whole call's; on the mesh each
    draw is then cut to this rank's rows. Returns the dict, float32 on
    ``device``."""
    with_steps = getattr(get_sampler(sampler), "NEEDS_NOISE", False)
    want = ("noise",) + (("step_noise",) if with_steps else ()) + tuple(extra)
    out = {k: seams.get(k) for k in want}
    if any(v is None for v in out.values()):
        drawn = draw_noise(generator, shape, steps, want, device)
        out = {k: drawn[k] if v is None else v for k, v in out.items()}
    for k, v in out.items():
        dim = 1 if k in _PER_STEP else 0
        if callable(v):
            out[k] = _rows_of_step(v, _draw_shape(k, shape, steps)[1:],
                                   device, k)
        else:
            out[k] = data_rows(_seam(v, _draw_shape(k, shape, steps),
                                     device, k), dim)
    return out


def _rows_of_step(fn, shape, device, name):
    """A per-step seam of the whole batch as one of this rank's rows."""
    def rows(i):
        return data_rows(_seam(fn(i), shape, device, name))

    return rows


def _rows(x, dim=0):
    """This rank's rows of a call's batched input on the mesh's data axis
    (``parallel.sharding.data_rows``): a tensor along ``dim``, a
    per-sample list or tuple; a scalar or None as it is."""
    if isinstance(x, (list, tuple)):
        t = data_rows(torch.arange(len(x)))
        return [x[i] for i in t.tolist()]
    if torch.is_tensor(x) and x.dim() > dim:
        return data_rows(x, dim)
    return x


def _uncond_rows(uncond):
    """One uncond embedding a sample [B, T, D] sliced; a shared [T, D]
    kept."""
    return _rows(uncond) if uncond.dim() == 3 else uncond


def check_knobs(cfg: PipelineConfig, sampler: str, pag=False, ip2p=False,
                scheduled=False, control=False) -> None:
    """The reference's incompatibility ``ValueError``s of the denoising
    loop's knobs, in its order (``sdtpu/engine/pipeline.py:244-266``): PAG
    with ip2p's dual CFG; DeepCache with ip2p, ControlNet hints
    (``control``: a shallow eval has no deep skips for the residuals),
    prompt scheduling, PAG, ``plms_exact`` or a two-eval sampler (its cache
    would cross an eval batch or a skip it never saw)."""
    if pag and ip2p:
        raise ValueError("PAG is incompatible with ip2p's dual CFG")
    dc_n = cfg.deepcache_interval
    if dc_n is None:
        return
    if int(dc_n) < 2:
        raise ValueError(f"deepcache_interval must be >= 2, got {dc_n}")
    for name, bad in (
            ("ip2p dual CFG", ip2p),
            ("ControlNet hints", control),
            ("prompt scheduling", scheduled),
            ("PAG", pag),
            ("plms_exact", sampler == "plms_exact"),
            ("two-eval samplers (heun/dpm2)",
             getattr(get_sampler(sampler), "NEEDS_SECOND_EVAL", False))):
        if bad:
            raise ValueError(f"DeepCache is incompatible with {name}")


def _control_tables(params, hint, cfg: PipelineConfig, plan, use_cfg,
                    needs_second):
    """[(adapter tree, hint features, time table, second time table or
    None), ...] of a call's ControlNets, made once before the loop: each
    control image embedded (doubled under CFG) and the steps through each
    adapter's own time MLP; None without a ``hint``."""
    if hint is None:
        return None
    cns = params.get("controlnet")
    if cns is None:
        raise ValueError("hint given but params has no 'controlnet' tree")
    if isinstance(cns, dict):
        cns, hint = (cns,), hint[None]
    dtype = cfg.compute_dtype
    factor = hint.shape[2] // cfg.latent_size
    out = []
    for j, cn in enumerate(cns):
        h_in = hint[j].to(dtype)
        if use_cfg:
            h_in = torch.cat([h_in, h_in], dim=0)
        out.append((cn, controlnet.embed_hint(cn, h_in, factor),
                    temb.apply(cn["temb"], plan.model_t, cfg.unet,
                               dtype=dtype),
                    temb.apply(cn["temb"], plan.model_t2, cfg.unet,
                               dtype=dtype) if needs_second else None))
    return out


def _control(adapters, scales, x_in, ctx, i, second, add_emb,
             cfg: PipelineConfig, kernels):
    """The scaled residuals of every ControlNet at one UNet eval (its input
    ``x_in`` and context rows ``ctx`` at step ``i``), summed over the
    adapters: ``unet.apply``'s ``control``; None without adapters."""
    if adapters is None:
        return None
    n = x_in.shape[0]
    acc_d = acc_m = None
    for j, (cn, feats, tab, tab2) in enumerate(adapters):
        te = (tab2 if second else tab)[i].expand(n, -1)
        if add_emb is not None:
            te = te + add_emb.to(te.dtype)[:n]
        dres, mres = controlnet.apply(cn, x_in, feats[:n], te, ctx, cfg.unet,
                                      kernels)
        s = scales[j % scales.shape[0]]
        dres = [r * s.to(r.dtype) for r in dres]
        mres = mres * s.to(mres.dtype)
        if acc_d is None:
            acc_d, acc_m = dres, mres
        else:
            acc_d = [a + r for a, r in zip(acc_d, dres)]
            acc_m = acc_m + mres
    return tuple(acc_d), acc_m


def segments(steps: int, start: int, cfg_interval=None, end=None):
    """[(first step, end, guided), ...]: the loop's segments over steps
    [start, end) (``end`` defaults to ``steps``;
    ``sdtpu/engine/pipeline.py:588-604``). With ``cfg_interval`` (lo, hi)
    the CFG pair runs on steps ``round(steps lo) <= i < round(steps hi)``
    only and the others evaluate the cond rows alone."""
    end = steps if end is None else int(end)
    if cfg_interval is None:
        return [(start, end, True)]
    lo, hi = cfg_interval
    a = int(round(steps * lo))
    c = int(round(steps * hi))
    segs = [(start, min(a, end), False),
            (max(a, start), min(c, end), True),
            (max(c, start), end, False)]
    return [(s0, s1, g) for s0, s1, g in segs if s1 > s0]


def denoise(params, context, guidance, cfg: PipelineConfig, steps: int,
            use_cfg: bool, kernels: str = "plain", *, noise=None,
            sampler: str = "dpm", step_noise=None, cond_schedule=None,
            init_latents=None, start_step: int = 0, mask=None,
            pin_noise=None, x_extra=None, image_guidance=None,
            cfg_interval=None, pag_scale=None, pag_layers=None,
            end_step=None, x_start=None, class_emb=None, hint=None,
            control_scale=None):
    """Run the denoising loop with ``sampler`` (a name of
    ``samplers.SAMPLERS``). context: [B or 2B, T, D]; with ``use_cfg`` rows
    [0:B] are cond and [B:2B] uncond. ``guidance``: a scalar or one a
    sample, [B].

    The draws are the caller's (``_draws``, which holds the rule of
    ``draw_noise``): ``noise`` [B, h, w, C] float32, the starting latents,
    and for a ``NEEDS_NOISE`` sampler ``step_noise`` ([steps, B, h, w, C],
    or a callable of the step index giving [B, h, w, C]). No knob draws.

    Two-eval samplers (``NEEDS_SECOND_EVAL``, heun and dpm2) evaluate the
    UNet again at ``predictor``'s probe point, with the time embeddings of
    the plan's ``model_t2``. ``plms_exact`` spends two evals on step 0
    (CompVis's pseudo improved Euler) and keeps ``e_t`` in its history,
    at ``start_step == 0`` only.

    Prompt scheduling: ``cond_schedule`` = (table [V, B, T, D], idx
    [steps] int64 on the device); every UNet eval of step i takes its cond
    rows from variant ``idx[i]`` (gathered on the device: no host sync, no
    branch), the uncond rows from ``context``; single-tower configurations
    only, as in the reference.

    SDXL: ``context`` is packed (``encode_text``); its pooled rows give the
    additive embedding, added to every eval's time embedding. A
    v-prediction model's output is turned into eps before the CFG mix, from
    the latents (not the extra planes).

    Warm start (``sdtpu/engine/pipeline.py:283-300``): ``init_latents``
    (clean, scale-factored, float32) is forward-diffused with ``noise`` to
    ``start_step``'s marginal and the loop runs steps [start_step, steps);
    the plan restarts a multistep solver's history there.

    Inpaint with a standard UNet: ``mask`` [B, h, w, 1] float32 (1 =
    generate, 0 = keep ``init_latents``); at the start of every step the
    kept region is re-pinned to the init latents at that step's marginal
    with that step's ``pin_noise`` ([steps, B, h, w, C] or a callable of the
    step), and after the loop it is pasted back exactly.

    Concat-conditioned UNets: ``x_extra`` [B, h, w, E] rides the channel
    axis into conv_in at every eval, once a CFG slot. InstructPix2Pix's dual
    CFG (``image_guidance``): ``context`` holds 3B rows [cond, uncond,
    uncond], the third slot's extra planes are zeros, and eps = e_un + g (e_txt
    - e_img) + g_img (e_img - e_un).

    The two-stage handoff (``sdtpu/engine/pipeline.py:219-223``):
    ``end_step`` stops the loop before that step, so the latents carry the
    marginal at its time; ``x_start`` are latents already at
    ``start_step``'s marginal, taken as they are (``noise`` is then not
    read).

    ``class_emb`` [B, time_embed_dim] (the x4 upscaler's noise-level row, a
    sample): added to every eval's time embedding, repeated over the CFG
    slots. LCM (``cfg.unet.time_cond_proj_dim``): the guidance is embedded,
    ``w = guidance - 1`` through ``temb.guidance_scale_features`` into the
    time MLP (a scalar, or one a sample for a [steps, B, D] table), and no
    CFG batch runs: ``use_cfg`` raises the reference's ``ValueError``.

    The knobs (``sdtpu/engine/pipeline.py:165-618``), each off by default:
    ``cfg_interval`` (``segments``); ``cfg.guidance_rescale``, the guided
    eps blended toward itself rescaled to the cond eps's per-sample
    population std; PAG, with ``pag_layers`` (sections of ``unet.apply``'s
    ``perturb``): one more eval of the cond rows a step with identity
    self-attention there, and eps + ``pag_scale`` (a scalar or [B]) x (the
    cond eps - the perturbed eps), in guided and unguided steps alike;
    DeepCache (``cfg.deepcache_interval`` n): a full eval that captures the
    deep feature when ``(i - first step of the segment) % n == 0``, a
    shallow eval that splices it in otherwise, so no cache crosses a
    segment. ``check_knobs`` raises what does not compose.

    ControlNet (``sdtpu/engine/pipeline.py:326-353, 397-431``): ``hint``
    [B, H, W, C] float in [0, 1] with one adapter tree in
    ``params["controlnet"]``, or [N, B, H, W, C] with a tuple of N
    (multi-ControlNet). Each control image is embedded once, before the
    loop (doubled under CFG), and each adapter embeds the steps with its
    own time MLP (``model_t``, and ``model_t2`` for a second eval), SDXL's
    additive embedding added. Every UNet eval runs each adapter on its
    input, rows and context (the cond rows alone where the eval has them
    alone: the CFG interval, PAG), weights its residuals by
    ``control_scale[j % len]`` (a scalar or a list; 1.0 by default), sums
    them over the adapters and adds them to the UNet's skips and mid
    output."""
    check_knobs(cfg, sampler, bool(pag_layers), image_guidance is not None,
                cond_schedule is not None, hint is not None)
    if cfg.unet.time_cond_proj_dim and use_cfg:
        raise ValueError(
            "guidance-embedded configs (time_cond_proj_dim > 0) bake "
            "CFG into the model; run with use_cfg off")
    device = context.device
    dtype = cfg.compute_dtype
    context, pooled = _unpack_context(context, cfg)
    add_emb = (None if pooled is None
               else _add_embedding(params, pooled, cfg))
    mod = get_sampler(sampler)
    plan = mod.plan(NoiseSchedule.sd_v1(), steps, start_step, device=device)
    reps = 3 if image_guidance is not None else (2 if use_cfg else 1)
    b = context.shape[0] // reps
    shape = (b, cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    needs_noise = getattr(mod, "NEEDS_NOISE", False)
    needs_second = getattr(mod, "NEEDS_SECOND_EVAL", False)
    if needs_noise and step_noise is None:
        raise ValueError(f"sampler {sampler} needs step_noise")
    if init_latents is not None:
        init_latents = init_latents.float()
    if x_start is not None:
        x = x_start.float()
    elif noise is None:
        raise ValueError("denoise needs noise or x_start")
    elif init_latents is not None:
        x = plan.alpha_s[start_step] * init_latents + (
            plan.sigma_s[start_step] * noise)
    else:
        x = noise
    if mask is not None:
        if init_latents is None or pin_noise is None:
            raise ValueError("a mask needs init_latents and pin_noise")
        mask = mask.float()
    # every step's time embedding in one batched MLP call, before the loop
    w_feats = None
    if cfg.unet.time_cond_proj_dim:
        w_feats = temb.guidance_scale_features(
            torch.as_tensor(guidance, dtype=torch.float32, device=device)
            - 1.0, cfg.unet.time_cond_proj_dim)
    t_embs = temb.apply(params["temb"], plan.model_t, cfg.unet, dtype=dtype,
                        cond=w_feats)
    t_embs2 = (temb.apply(params["temb"], plan.model_t2, cfg.unet,
                          dtype=dtype, cond=w_feats)
               if needs_second else None)
    g = torch.as_tensor(guidance, dtype=torch.float32, device=device)
    if g.dim():
        g = g.reshape(-1, 1, 1, 1)
    adapters = _control_tables(params, hint, cfg, plan, use_cfg,
                               needs_second)
    scales = None if adapters is None else torch.atleast_1d(torch.as_tensor(
        1.0 if control_scale is None else control_scale, dtype=torch.float32,
        device=device))
    xe = {}
    if x_extra is not None:
        xe[1] = x_extra.to(dtype)
        if image_guidance is not None:
            xe[3] = torch.cat([xe[1], xe[1], torch.zeros_like(xe[1])], dim=0)
        xe[2] = torch.cat([xe[1], xe[1]], dim=0)
    dc_n = cfg.deepcache_interval

    def rows(i, guided):
        if cond_schedule is None:
            return context if guided else context[:b]
        table, idx = cond_schedule
        cond = table.index_select(0, idx[i:i + 1])[0]
        return (torch.cat([cond, context[b:]], dim=0)
                if use_cfg and guided else cond)

    def predict_eps(x, i, guided=True, second=False, deep=None):
        """One step's eps; with ``deep`` (DeepCache) ``(eps, cache)``:
        "capture" for a full eval, else the cached tensor to splice."""
        r = reps if guided else 1
        ctx_i = rows(i, guided)
        te = (t_embs2 if second else t_embs)[i].expand(ctx_i.shape[0], -1)
        if add_emb is not None:
            te = te + add_emb.to(te.dtype)[: ctx_i.shape[0]]
        if class_emb is not None:
            ce = class_emb.to(te.dtype)
            te = te + (torch.cat([ce] * r, dim=0) if r > 1 else ce)
        x_rep = torch.cat([x] * r, dim=0) if r > 1 else x
        x_in = x_rep.to(dtype)
        if xe:
            x_in = torch.cat([x_in, xe[r]], dim=-1)
        ctrl = _control(adapters, scales, x_in, ctx_i, i, second, add_emb,
                        cfg, kernels)
        cache = deep
        if deep is None:
            eps = unet.apply(params["unet"], x_in, te, ctx_i, cfg.unet,
                             kernels, control=ctrl)
        elif isinstance(deep, str):
            eps, cache = unet.apply(params["unet"], x_in, te, ctx_i,
                                    cfg.unet, kernels, deep="capture")
        else:
            eps = unet.apply(params["unet"], x_in, te, ctx_i, cfg.unet,
                             kernels, deep=deep)
        eps = eps.float()
        if cfg.prediction == "v":
            # v = alpha*eps - sigma*x0  =>  eps = alpha*v + sigma*x_t, per
            # CFG slot; the second eval takes the probe point's marginals
            a_i = (plan.alpha_m if second else plan.alpha_s)[i]
            s_i = (plan.sigma_m if second else plan.sigma_s)[i]
            eps = a_i * eps + s_i * x_rep
        e_ptb = None
        if pag_layers:
            # the cond rows lead in every slot layout
            ctrl_b = None if ctrl is None else (
                tuple(d[:b] for d in ctrl[0]), ctrl[1][:b])
            e_ptb = unet.apply(params["unet"], x_in[:b], te[:b], ctx_i[:b],
                               cfg.unet, kernels, control=ctrl_b,
                               perturb=pag_layers).float()
            if cfg.prediction == "v":
                e_ptb = a_i * e_ptb + s_i * x
            e_cond_raw = eps[:b]
        if image_guidance is not None:
            gi = torch.as_tensor(image_guidance, dtype=torch.float32,
                                 device=device)
            e_txt, e_img, e_un = eps[:b], eps[b:2 * b], eps[2 * b:]
            eps = e_un + g * (e_txt - e_img) + gi * (e_img - e_un)
        elif use_cfg and guided:
            e_cond = eps[:b]
            eps = g * e_cond + (1.0 - g) * eps[b:]
            if cfg.guidance_rescale:
                axes = tuple(range(1, eps.dim()))
                std_c = e_cond.std(dim=axes, keepdim=True, correction=0)
                std_g = eps.std(dim=axes, keepdim=True, correction=0)
                rescaled = eps * (std_c / torch.clamp(std_g, min=1e-8))
                rr = torch.tensor(cfg.guidance_rescale, dtype=torch.float32,
                                  device=device)
                eps = rr * rescaled + (1.0 - rr) * eps
        if e_ptb is not None:
            ps = torch.as_tensor(0.0 if pag_scale is None else pag_scale,
                                 dtype=torch.float32, device=device)
            if ps.dim():
                ps = ps.reshape(-1, 1, 1, 1)
            eps = eps + ps * (e_cond_raw - e_ptb)
        return eps if deep is None else (eps, cache)

    def pin(i):
        n_i = (_seam(pin_noise(i), shape, device, "pin_noise")
               if callable(pin_noise) else pin_noise[i])
        return plan.alpha_s[i] * init_latents + plan.sigma_s[i] * n_i

    state = mod.init_state(x)
    start = start_step
    if sampler.lower() == "plms_exact" and start_step == 0:
        # a second UNet eval at the next time refines eps before the step-0
        # update; the history takes e_t, not the average (no re-pin on this
        # step, as in the reference)
        e_t = predict_eps(x, 0)
        x_mid, _ = mod.step(plan, 0, x, e_t, state)
        e_next = predict_eps(x_mid, min(1, steps - 1))
        x, _ = mod.step(plan, 0, x, 0.5 * (e_t + e_next), state)
        _, state = mod.step(plan, 0, x_mid, e_t, state)
        start = 1
    # the interval is ignored without CFG and under ip2p's dual CFG
    if not use_cfg or image_guidance is not None:
        cfg_interval = None
    for s0, s1, guided in segments(steps, start, cfg_interval, end_step):
        cache = None
        for i in range(s0, s1):
            if mask is not None:
                x = mask * x + (1.0 - mask) * pin(i)
            if dc_n is None:
                eps = predict_eps(x, i, guided)
            else:
                full = (i - s0) % int(dc_n) == 0
                eps, cache = predict_eps(x, i, guided,
                                         deep="capture" if full else cache)
            if needs_second:
                eps2 = predict_eps(mod.predictor(plan, i, x, eps), i, guided,
                                   second=True)
                x, state = mod.step(plan, i, x, eps, state, eps2=eps2)
            elif needs_noise:
                n_i = (_seam(step_noise(i), shape, device, "step_noise")
                       if callable(step_noise) else step_noise[i])
                x, state = mod.step(plan, i, x, eps, state, noise=n_i)
            else:
                x, state = mod.step(plan, i, x, eps, state)
    if mask is not None:
        x = mask * x + (1.0 - mask) * init_latents
    return x


def generate(params, tokens, uncond_embedding, generator, guidance, *,
             cfg: PipelineConfig, sampler: str = "dpm", steps: int = 20,
             use_cfg: bool = True, kernels: str = "plain", noise=None,
             step_noise=None, output: str = "image", token_weights=None,
             sched_idx=None, cfg_interval=None, pag_scale=None,
             pag_layers=None, end_step=None, hint=None, control_scale=None):
    """tokens [B, T] (or chunked [B, k, T] with ``token_weights``) -> uint8
    [B, H, W, 3], or with ``output="latent"`` the float32 scale-factored
    latents. ``uncond_embedding``: [T, D] or [B, T, D], encoded by the
    caller. Draws (``draw_noise``): noise, step noise; ``noise`` and
    ``step_noise`` are their seams. ``cfg_interval``, ``pag_scale`` and
    ``pag_layers``: ``denoise``'s knobs. ``end_step``: the base half of a
    two-stage call stops before that step (``denoise``); its latents,
    noisy at that step's time, are ``refine``'s input. ``hint`` and
    ``control_scale``: ControlNet (``denoise``), with the adapter trees in
    ``params["controlnet"]``.

    Prompt scheduling (``sdtpu/engine/pipeline.py:653-667``): with
    ``sched_idx`` ([steps] integer, each step's variant), tokens are [V, B,
    k, T] (+ weights): the V variants encode into one table [V, B, k*T, D]
    in one call, and step i conditions on variant ``sched_idx[i]``."""
    bdim = 0 if sched_idx is None else 1
    shape = _latent_shape(tokens.shape[bdim], cfg)
    tokens, token_weights = _rows(tokens, bdim), _rows(token_weights, bdim)
    uncond_embedding = _uncond_rows(uncond_embedding)
    guidance, pag_scale = _rows(guidance), _rows(pag_scale)
    if hint is not None:
        hint = _rows(hint, 1 if hint.dim() == 5 else 0)
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
    d = _draws(generator, shape, steps, sampler, context.device,
               {"noise": noise, "step_noise": step_noise})
    x = denoise(params, context, guidance, cfg, steps, use_cfg, kernels,
                noise=d["noise"], sampler=sampler,
                step_noise=d.get("step_noise"), cond_schedule=cond_schedule,
                cfg_interval=cfg_interval, pag_scale=pag_scale,
                pag_layers=pag_layers, end_step=end_step, hint=hint,
                control_scale=control_scale)
    return _finish(params, x, cfg, kernels, output)


def refine(params, tokens, uncond_embedding, generator, guidance, latents, *,
           cfg: PipelineConfig, sampler: str = "dpm", steps: int = 20,
           start_step: int = 0, use_cfg: bool = True, kernels: str = "plain",
           token_weights=None, output: str = "image", noise=None,
           step_noise=None, cfg_interval=None, pag_scale=None,
           pag_layers=None):
    """The second stage of a two-stage call (``sdtpu/engine/pipeline.py:
    701-722``): ``latents`` [B, h, w, C] float32, already at
    ``start_step``'s marginal on this ``steps`` timeline (the base ran with
    ``end_step == start_step``), are denoised over steps [start_step,
    steps) and decoded (or returned with ``output="latent"``).

    The draws are ``generate``'s, by the same rule, and the loop takes the
    steps' share from ``start_step`` on; the start latents drawn are not
    read. So ``start_step=0`` with ``generate``'s own start latents gives
    ``generate``'s result under one generator."""
    shape = _latent_shape(tokens.shape[0], cfg)
    tokens, token_weights = _rows(tokens), _rows(token_weights)
    uncond_embedding = _uncond_rows(uncond_embedding)
    guidance, pag_scale = _rows(guidance), _rows(pag_scale)
    context = _build_context(params, tokens, uncond_embedding, cfg, use_cfg,
                             weights=token_weights)
    d = _draws(generator, shape, steps, sampler, context.device,
               {"noise": noise, "step_noise": step_noise})
    x = denoise(params, context, guidance, cfg, steps, use_cfg, kernels,
                sampler=sampler, step_noise=d.get("step_noise"),
                start_step=start_step,
                x_start=_rows(_seam(latents, shape, context.device,
                                    "latents")),
                cfg_interval=cfg_interval, pag_scale=pag_scale,
                pag_layers=pag_layers)
    return _finish(params, x, cfg, kernels, output)


def _finish(params, x, cfg, kernels, output):
    """Decode (or not), then the whole batch from the data group's
    rows."""
    return gather_rows(x if output == "latent"
                       else decode_latents(params, x, cfg, kernels))


def _encode_init_latents(params, image, cfg: PipelineConfig, kernels,
                         noise=None, scaled: bool = True):
    """[B, H, W, 3] float in [-1, 1] -> clean latents [B, h, w, z] float32
    (``sdtpu/engine/pipeline.py:748-772``): the posterior mode, or with
    ``noise`` (a standard-normal draw of that shape) the posterior sample
    ``mean + exp(0.5 logvar) noise`` in float32; times the scale factor
    unless ``scaled=False`` (InstructPix2Pix's conditioning takes the raw
    mode)."""
    mean, logvar = vae.apply_encoder(params["vae_enc"],
                                     image.to(cfg.compute_dtype), cfg.vae,
                                     kernels)
    z = mean.float()
    if noise is not None:
        z = z + torch.exp(0.5 * logvar.float()) * noise
    return z * cfg.vae.scale_factor if scaled else z


def _latent_pool(a, cfg: PipelineConfig):
    """[B, H, W, 1] pixel plane -> its mean over each latent cell [B, h, w,
    1], float32."""
    b, s = a.shape[0], cfg.latent_size
    f = cfg.image_size // s
    return a.float().reshape(b, s, f, s, f, 1).mean(dim=(2, 4))


def img2img(params, tokens, uncond_embedding, generator, guidance, image, *,
            cfg: PipelineConfig, sampler: str = "dpm", steps: int = 20,
            start_step: int = 10, use_cfg: bool = True,
            kernels: str = "plain", token_weights=None, depth=None,
            output: str = "image", noise=None, step_noise=None,
            posterior_noise=None, cfg_interval=None, pag_scale=None,
            pag_layers=None):
    """Image to image (``sdtpu/engine/pipeline.py:775-827``): ``image``
    [B, H, W, 3] float in [-1, 1] is encoded to a posterior sample, noised
    to ``start_step``'s marginal, denoised over the remaining steps and
    decoded (uint8 [B, H, W, 3], or the float32 latents with
    ``output="latent"``). tokens [B, T] or chunked [B, k, T] with
    ``token_weights``, as ``generate`` takes them.

    A depth-conditioned UNet (``config.SD2_DEPTH``): ``depth`` [B, H, W, 1]
    float, any monotone scale, is mean-pooled to latent resolution,
    normalized per sample to [-1, 1] and concatenated to the latents at
    every step.

    Draws (``draw_noise``): noise, step noise, posterior noise; ``noise``,
    ``step_noise``, ``posterior_noise`` are their seams. ``cfg_interval``,
    ``pag_scale`` and ``pag_layers``: ``denoise``'s knobs."""
    shape = _latent_shape(tokens.shape[0], cfg)
    tokens, token_weights = _rows(tokens), _rows(token_weights)
    uncond_embedding = _uncond_rows(uncond_embedding)
    guidance, pag_scale = _rows(guidance), _rows(pag_scale)
    image, depth = _rows(image), _rows(depth)
    context = _build_context(params, tokens, uncond_embedding, cfg, use_cfg,
                             weights=token_weights)
    d = _draws(generator, shape, steps, sampler, context.device,
               {"noise": noise, "step_noise": step_noise,
                "posterior_noise": posterior_noise}, ("posterior_noise",))
    init = _encode_init_latents(params, image, cfg, kernels,
                                noise=d["posterior_noise"])
    x_extra = None
    if depth is not None:
        dp = _latent_pool(depth, cfg)
        lo = dp.amin(dim=(1, 2, 3), keepdim=True)
        hi = dp.amax(dim=(1, 2, 3), keepdim=True)
        x_extra = 2.0 * (dp - lo) / torch.clamp(hi - lo, min=1e-6) - 1.0
    x = denoise(params, context, guidance, cfg, steps, use_cfg,
                kernels, noise=d["noise"], sampler=sampler,
                step_noise=d.get("step_noise"), init_latents=init,
                start_step=start_step, x_extra=x_extra,
                cfg_interval=cfg_interval, pag_scale=pag_scale,
                pag_layers=pag_layers)
    return _finish(params, x, cfg, kernels, output)


def inpaint(params, tokens, uncond_embedding, generator, guidance, image,
            mask, *, cfg: PipelineConfig, sampler: str = "dpm",
            steps: int = 20, start_step: int = 0, use_cfg: bool = True,
            kernels: str = "plain", token_weights=None,
            output: str = "image", noise=None, step_noise=None,
            posterior_noise=None, masked_noise=None, pin_noise=None,
            cfg_interval=None):
    """Masked image to image (``sdtpu/engine/pipeline.py:830-896``).
    ``image`` [B, H, W, 3] float in [-1, 1]; ``mask`` [B, H, W, 1] float in
    [0, 1], 1 = repaint. The mask is mean-pooled to latent resolution.

    A standard UNet (``unet.in_channels == latent_channels``): the image's
    posterior sample is the init; the kept region is re-pinned every step
    and pasted back exactly after the loop. Draws: noise, step noise,
    posterior noise, pin noise.

    A dedicated inpaint UNet (``in_channels == 2 * latent_channels + 1``):
    the pooled mask and the latents of the masked image (the repaint region
    blanked to 0) are extra planes at every step; no pinning. The full
    image is encoded only for a warm start (``start_step > 0``). Draws:
    noise, step noise, posterior noise (a warm start only), masked noise.

    ``noise``, ``step_noise``, ``posterior_noise``, ``masked_noise`` and
    ``pin_noise`` are the draws' seams; ``cfg_interval`` is ``denoise``'s."""
    shape = _latent_shape(tokens.shape[0], cfg)
    tokens, token_weights = _rows(tokens), _rows(token_weights)
    uncond_embedding = _uncond_rows(uncond_embedding)
    guidance = _rows(guidance)
    image, mask = _rows(image), _rows(mask)
    context = _build_context(params, tokens, uncond_embedding, cfg, use_cfg,
                             weights=token_weights)
    m = _latent_pool(mask, cfg)
    seams = {"noise": noise, "step_noise": step_noise,
             "posterior_noise": posterior_noise,
             "masked_noise": masked_noise, "pin_noise": pin_noise}
    dev = context.device
    if cfg.unet.in_channels == 2 * cfg.latent_channels + 1:
        extra = (("posterior_noise",) if start_step > 0 else ()) + (
            "masked_noise",)
        d = _draws(generator, shape, steps, sampler, dev, seams, extra)
        masked = _encode_init_latents(params, image * (1.0 - mask), cfg,
                                      kernels, noise=d["masked_noise"])
        init = (_encode_init_latents(params, image, cfg, kernels,
                                     noise=d["posterior_noise"])
                if start_step > 0 else None)
        x = denoise(params, context, guidance, cfg, steps,
                    use_cfg, kernels, noise=d["noise"], sampler=sampler,
                    step_noise=d.get("step_noise"), init_latents=init,
                    start_step=start_step,
                    x_extra=torch.cat([m, masked], dim=-1),
                    cfg_interval=cfg_interval)
        return _finish(params, x, cfg, kernels, output)
    d = _draws(generator, shape, steps, sampler, dev, seams,
               ("posterior_noise", "pin_noise"))
    init = _encode_init_latents(params, image, cfg, kernels,
                                noise=d["posterior_noise"])
    x = denoise(params, context, guidance, cfg, steps, use_cfg,
                kernels, noise=d["noise"], sampler=sampler,
                step_noise=d.get("step_noise"), init_latents=init,
                start_step=start_step, mask=m, pin_noise=d["pin_noise"],
                cfg_interval=cfg_interval)
    return _finish(params, x, cfg, kernels, output)


def upscale_latents(latents, scale: int):
    """Nearest-neighbour upscale of [B, s, s, C] latents by an integer
    ``scale`` (``jax.image.resize(..., "nearest")`` at an integer factor:
    each latent repeated ``scale`` x ``scale`` times)."""
    up = latents.float().repeat_interleave(scale, dim=1)
    return up.repeat_interleave(scale, dim=2)


def hires_refine(params, tokens, uncond_embedding, generator, guidance,
                 latents, *, cfg: PipelineConfig, scale: int = 2,
                 sampler: str = "dpm", steps: int = 20, start_step: int = 8,
                 use_cfg: bool = True, kernels: str = "plain",
                 token_weights=None, output: str = "image", noise=None,
                 step_noise=None, cfg_interval=None):
    """The hires fix's second pass (``sdtpu/engine/pipeline.py:899-937``):
    the first pass's clean latents nearest-upscaled by ``scale``,
    forward-diffused to ``start_step``'s marginal and denoised over the
    remaining steps at the larger latent grid, then decoded. One parameter
    tree serves both passes (the UNet and the VAE are convolutional).
    Draws: noise and step noise at the larger grid, from ``generator``
    continued after the first pass (``Context.hires_fix``).
    ``cfg_interval`` is ``denoise``'s."""
    cfg_hi = dataclasses.replace(cfg, latent_size=cfg.latent_size * scale)
    shape = _latent_shape(tokens.shape[0], cfg_hi)
    tokens, token_weights = _rows(tokens), _rows(token_weights)
    uncond_embedding = _uncond_rows(uncond_embedding)
    guidance, latents = _rows(guidance), _rows(latents)
    context = _build_context(params, tokens, uncond_embedding, cfg_hi,
                             use_cfg, weights=token_weights)
    d = _draws(generator, shape, steps, sampler, context.device,
               {"noise": noise, "step_noise": step_noise})
    x = denoise(params, context, guidance, cfg_hi, steps,
                use_cfg, kernels, noise=d["noise"], sampler=sampler,
                step_noise=d.get("step_noise"),
                init_latents=upscale_latents(latents, scale),
                start_step=start_step, cfg_interval=cfg_interval)
    return _finish(params, x, cfg_hi, kernels, output)


def instruct_pix2pix(params, tokens, uncond_embedding, generator, guidance,
                     image, image_guidance, *, cfg: PipelineConfig,
                     sampler: str = "dpm", steps: int = 20,
                     kernels: str = "plain", token_weights=None,
                     output: str = "image", noise=None, step_noise=None):
    """Instruction-based editing (``sdtpu/engine/pipeline.py:940-979``): an
    8-channel UNet takes the latents and the edit image's unscaled
    posterior mode at every step; the dual CFG runs three slots a step,
    context [cond, uncond, uncond], and steers toward the instruction
    (``guidance``) and the image (``image_guidance``). Always from pure
    noise. Draws: noise and step noise."""
    shape = _latent_shape(tokens.shape[0], cfg)
    tokens, token_weights = _rows(tokens), _rows(token_weights)
    uncond_embedding = _uncond_rows(uncond_embedding)
    guidance, image = _rows(guidance), _rows(image)
    p_cond = encode_text(params, tokens, cfg, token_weights)
    p_un = uncond_embedding.to(p_cond.dtype).expand(p_cond.shape)
    context = torch.cat([p_cond, p_un, p_un], dim=0)
    d = _draws(generator, shape, steps, sampler, context.device,
               {"noise": noise, "step_noise": step_noise})
    image_latents = _encode_init_latents(params, image, cfg, kernels,
                                         scaled=False)
    x = denoise(params, context, guidance, cfg, steps, True,
                kernels, noise=d["noise"], sampler=sampler,
                step_noise=d.get("step_noise"), x_extra=image_latents,
                image_guidance=image_guidance)
    return _finish(params, x, cfg, kernels, output)


#: the x4 upscaler's augmentation schedule: image-space, sqrt-linear from
#: 1e-4 to 2e-2 (x4-upscaling.yaml's ``low_scale_config``)
AUG_SCHEDULE = dict(lin_start=1e-4, lin_end=2e-2)


def upscale(params, tokens, uncond_embedding, generator, guidance, image,
            noise_level, *, cfg: PipelineConfig, sampler: str = "dpm",
            steps: int = 20, use_cfg: bool = True, kernels: str = "plain",
            token_weights=None, output: str = "image", noise=None,
            step_noise=None, aug_noise=None, cfg_interval=None):
    """The x4 upscaler (``sdtpu/engine/pipeline.py:985-1046``): ``image``,
    the low-res [B, h, w, 3] float in [-1, 1] on the latent grid, is noised
    to ``noise_level`` (an int, or [B] ints, below ``cfg.max_noise_level``)
    on the image-space schedule (``AUG_SCHEDULE``, alpha-bar gathered at
    the level) and rides the UNet's channel axis at every step; the level's
    row of ``params["unet"]["label_emb"]`` adds to the time embedding. A
    full trajectory from pure noise, decoded by the f4 VAE to [B, 4h, 4w,
    3]. Draws: noise, step noise, then ``aug_noise`` in the image's shape;
    ``noise``, ``step_noise`` and ``aug_noise`` are their seams."""
    shape = _latent_shape(tokens.shape[0], cfg)
    tokens, token_weights = _rows(tokens), _rows(token_weights)
    uncond_embedding = _uncond_rows(uncond_embedding)
    guidance, image, noise_level = (_rows(guidance), _rows(image),
                                    _rows(noise_level))
    context = _build_context(params, tokens, uncond_embedding, cfg, use_cfg,
                             weights=token_weights)
    dev = context.device
    d = _draws(generator, shape, steps, sampler, dev,
               {"noise": noise, "step_noise": step_noise,
                "aug_noise": aug_noise}, ("aug_noise",))
    # gathered on the device: one level, or one a sample
    nl = torch.as_tensor(noise_level, dtype=torch.int64,
                         device=dev).reshape(-1)
    aug = NoiseSchedule.sd_v1(**AUG_SCHEDULE)
    ab = to_f32(aug.alphas_cumprod, dev).index_select(0, nl).reshape(
        -1, 1, 1, 1)
    z_lr = (torch.sqrt(ab) * image.float()
            + torch.sqrt(1.0 - ab) * d["aug_noise"])
    lab = params["unet"]["label_emb"].index_select(0, nl).expand(
        image.shape[0], -1)
    x = denoise(params, context, guidance, cfg, steps, use_cfg, kernels,
                noise=d["noise"], sampler=sampler,
                step_noise=d.get("step_noise"), x_extra=z_lr,
                cfg_interval=cfg_interval, class_emb=lab)
    return _finish(params, x, cfg, kernels, output)
