"""Smoke run of the PyTorch/CUDA port (sdtpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON object per line:

1. device: the card's name and power limit (also printed raw, as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them), torch and CUDA versions;
2. build: nvcc builds the kernels from sdtpu_torch/csrc (first use);
3. kernel: the flash-attention kernel (K1) against its plain version at the
   main path's shapes (and d=64 as a look ahead), error and device
   times;
4. sites: one SD1.5 UNet eval and one VAE decode under ``cuda_gn`` and
   ``cuda_conv`` record every call shape the fused GroupNorm (K2) and the
   fused conv (K3) get on the main path, and how often per image;
5. kernel_gn, kernel_conv: K2 and K3 at every one of those shapes and at
   ragged ones (odd planes, C/G not a multiple of 8, Cout not a multiple
   of the tile, int8 weights), each against its plain version run in
   float32 on the same bf16 inputs; device times of the kernel, of the
   plain version, and of the site as ``kernels="cuda"`` runs it (bf16
   GroupNorm + SiLU + cuDNN conv + bias);
6. main path: Context(config="sd15", steps=20, sampler="dpm") with random
   demo weights generates 512x512 images under ``kernels="cuda"`` (the
   ``auto`` choice), then under ``"cuda_gn"`` and ``"cuda_conv"`` on the
   same Context; each image must launch each kernel exactly the pinned
   number of times; the same seed must give the same bytes; median s/image
   of 3;
7. ab: s/image under plain, cuda, cuda_gn and cuda_conv, in turns;
8. model: one SD1.5 UNet eval and one VAE decode at full width under each
   policy, each against float32;
9. breakdown: stage times and a profiler trace of one image under cuda,
   cuda_gn and cuda_conv.

Kernel times are device times: CUDA-event time of CUDA-graph replays
(``cuda_ms``), so the host's launch cost is not in them.

Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Any failure ends the run with a non-zero exit and no last line.
Without a CUDA card it exits non-zero before printing anything.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PROMPT = "a photograph of an astronaut riding a horse"
KERNEL_TOL = 2e-2       # K1: bf16 output (2^-9 relative) and bf16 P in P.V
# K2, K3: max-abs error against the float32 plain version, relative to its
# max-abs: one bf16 rounding of the output (2^-9), and for K3 of the
# prologue's output too, the product operand
FUSED_TOL = 1e-2
# K2's statistics mode against gn_affine's plain version: both float32,
# sums in another order
AFFINE_TOL = 1e-4
MODEL_FACTOR = 2.0      # see phase_model
POLICIES = ("plain", "cuda", "cuda_gn", "cuda_conv")
# (batch, seq, channels, heads): UNet 64x64 and 32x32 self-attention at the
# CFG batch of 2, the VAE mid block, and d=64 (SD2/SDXL) as a look ahead
SHAPES = [(2, 4096, 320, 8), (2, 1024, 640, 8), (1, 4096, 512, 1),
          (2, 4096, 512, 8)]
STEPS = 20
# launches per image of each kernel under each policy:
#   flash: 5 self-attentions at 64x64 + 5 at 32x32 per UNet eval, 20 evals,
#     plus the VAE mid block, under every cuda* policy;
#   group_norm: 61 GroupNorms per UNet eval (22 ResBlocks x 2, 16
#     transformer norms, out_norm), 20 evals; the VAE keeps the plain one;
#   conv: 60 fused convs per UNet eval (22 ResBlocks x 2, 16 proj_in), 20
#     evals, plus 14 VAE ResBlocks x 2; each with one launch of the
#     GroupNorm kernel's statistics mode for its prologue (gn_affine)
FLASH_PER_IMAGE = (5 + 5) * STEPS + 1
CONV_PER_IMAGE = 60 * STEPS + 14 * 2
PINNED = {
    "cuda": {"flash": FLASH_PER_IMAGE, "group_norm": 0,
             "group_norm_affine": 0, "conv": 0},
    "cuda_gn": {"flash": FLASH_PER_IMAGE, "group_norm": 61 * STEPS,
                "group_norm_affine": 0, "conv": 0},
    "cuda_conv": {"flash": FLASH_PER_IMAGE, "group_norm": 0,
                  "group_norm_affine": CONV_PER_IMAGE,
                  "conv": CONV_PER_IMAGE},
}
# K2 and K3 at shapes off the main path: odd planes, C/G not a multiple of
# 8 (or of 2), Cout not a multiple of the 128 tile, int8 weights
GN_RAGGED = [(2, 77, 30, 3, 1e-5, True), (1, 5, 9, 3, 1e-6, False),
             (2, 1023, 960, 32, 1e-5, True)]
# (x shape, c_out, k, prologue, int8)
CONV_RAGGED = [((2, 63, 65, 64), 100, 3, "silu", False),
               ((2, 5, 3, 16), 13, 3, None, False),
               ((1, 7, 9, 24), 40, 3, "silu", True),
               ((2, 32, 32, 640), 640, 3, "silu", True),
               ((2, 9, 11, 40), 72, 1, "affine", False)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 10, replays: int = 5) -> float:
    """Device time of one call of ``fn``, in ms: ``reps`` calls captured in
    a CUDA graph after two warm-up calls, the graph replayed ``replays``
    times between two CUDA events. The host's launch cost is not in the
    number (a call of a few small kernels takes longer to enqueue than to
    run), so it compares what the card does for a kernel and for the
    kernels it replaces."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * replays)


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


def counts():
    from sdtpu_torch.ops import attention as A
    from sdtpu_torch.ops import conv as C
    from sdtpu_torch.ops import groupnorm as G

    return {"flash": A.flash_attention_cuda.launches,
            "group_norm": G.group_norm_cuda.launches,
            "group_norm_affine": G.group_norm_affine_cuda.launches,
            "conv": C.fused_conv_cuda.launches}


def reset_counts() -> None:
    from sdtpu_torch.ops import attention as A
    from sdtpu_torch.ops import conv as C
    from sdtpu_torch.ops import groupnorm as G

    A.flash_attention_cuda.launches = 0
    G.group_norm_cuda.launches = 0
    G.group_norm_affine_cuda.launches = 0
    C.fused_conv_cuda.launches = 0


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return name, smi


def phase_build():
    from sdtpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.library_path()
    fresh = not path.exists()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": fresh, "sources": [s.name for s in _build.sources()],
          "library": str(path.relative_to(_build.PKG_DIR))})


def phase_kernel():
    from sdtpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, s, c, heads in SHAPES:
        q, k, v = (torch.randn((b, s, c), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        out = A.flash_attention_cuda(q, k, v, heads)
        torch.cuda.synchronize()
        ref = A.flash_attention_reference(q.float(), k.float(), v.float(),
                                          heads)
        err = (out.float() - ref).abs().max().item()
        del ref
        ms = cuda_ms(lambda: A.flash_attention_cuda(q, k, v, heads))
        plain_ms = cuda_ms(
            lambda: A.flash_attention_reference(q, k, v, heads))
        flop = 4.0 * b * s * s * c
        row = {"shape": [b, s, c], "heads": heads, "head_dim": c // heads,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "tflops": flop / ms / 1e9, "plain_tflops": flop / plain_ms / 1e9}
        emit({"phase": "kernel", **row})
        if not err <= KERNEL_TOL:
            raise AssertionError(f"kernel disagrees at {row}")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def recording(module, name, log):
    """Log the arguments of every call of ``module.name`` (a kernel
    wrapper, which still launches), then put the wrapper back."""
    real = getattr(module, name)

    def record(*args, **kwargs):
        log.append((args, kwargs))
        return real(*args, **kwargs)

    # the wrapper adds to the launch count of whatever its module holds
    # under its name, which is `record` while it is replaced
    record.launches = 0
    setattr(module, name, record)
    try:
        yield
    finally:
        setattr(module, name, real)


def phase_sites(ctx):
    """The call shapes K2 and K3 get on the main path, and how many times
    each runs per image: one UNet eval (x STEPS) and one VAE decode under
    each policy, with the wrappers' arguments logged."""
    from sdtpu_torch.models import unet, vae
    from sdtpu_torch.ops import conv as C
    from sdtpu_torch.ops import groupnorm as G

    cfg = ctx.cfg
    g = torch.Generator(device="cuda").manual_seed(3)
    dt = cfg.compute_dtype
    x = torch.randn((2, cfg.latent_size, cfg.latent_size,
                     cfg.latent_channels), generator=g, device="cuda").to(dt)
    te = torch.randn((2, cfg.unet.time_embed_dim), generator=g,
                     device="cuda").to(dt)
    context = torch.randn((2, cfg.clip.context_len, cfg.unet.context_dim),
                          generator=g, device="cuda").to(dt)
    z = torch.randn((1, cfg.latent_size, cfg.latent_size,
                     cfg.latent_channels), generator=g, device="cuda").to(dt)
    gn_sites: dict = {}
    conv_sites: dict = {}
    for policy, module, name, sites in (
            ("cuda_gn", G, "group_norm_cuda", gn_sites),
            ("cuda_conv", C, "fused_conv_cuda", conv_sites)):
        for per_image, run in (
                (STEPS, lambda k: unet.apply(ctx.params["unet"], x, te,
                                             context, cfg.unet, k)),
                (1, lambda k: vae.apply(ctx.params["vae"], z, cfg.vae, k))):
            log = []
            with torch.inference_mode(), recording(module, name, log):
                run(policy)
            for args, kwargs in log:
                if module is G:
                    p, xx, groups, eps, silu = args
                    n = xx.shape[0]
                    key = (n, xx.numel() // (n * xx.shape[-1]),
                           xx.shape[-1], groups, eps, bool(silu))
                else:
                    xx, w, b = args
                    prologue = (None if kwargs.get("a") is None else
                                "silu" if kwargs.get("silu", True) else
                                "affine")
                    key = (tuple(xx.shape), w.shape[0], w.shape[-1],
                           prologue, b.dim() == 2)
                sites[key] = sites.get(key, 0) + per_image
    reset_counts()
    emit({"phase": "sites",
          "group_norm_sites": len(gn_sites),
          "group_norm_per_image": sum(gn_sites.values()),
          "conv_sites": len(conv_sites),
          "conv_per_image": sum(conv_sites.values())})
    if sum(gn_sites.values()) != PINNED["cuda_gn"]["group_norm"] or sum(
            conv_sites.values()) != PINNED["cuda_conv"]["conv"]:
        raise AssertionError("site counts differ from the pinned counts")
    return gn_sites, conv_sites


def phase_kernel_gn(gn_sites):
    """K2 at every main-path shape and at ragged ones, against its plain
    version in float32 on the same bf16 inputs; times of the kernel, the
    plain version (bf16 in, float32 math) and the cuda policy's site (bf16
    ``layers.group_norm``, then SiLU)."""
    from sdtpu_torch.models import unet
    from sdtpu_torch.ops import groupnorm as G

    g = torch.Generator(device="cuda").manual_seed(4)
    cases = [(k, n) for k, n in sorted(gn_sites.items(), key=str)]
    cases += [(k, 0) for k in GN_RAGGED]
    rows = []
    for (n, hw, c, groups, eps, silu), per_image in cases:
        x = (torch.randn((n, hw, c), generator=g, device="cuda") * 2 + 0.5
             ).to(torch.bfloat16)
        p = {"scale": (torch.rand(c, generator=g, device="cuda") + 0.5).to(
                 torch.bfloat16),
             "bias": torch.randn(c, generator=g, device="cuda").to(
                 torch.bfloat16)}
        out = G.group_norm_cuda(p, x, groups, eps, silu)
        torch.cuda.synchronize()
        ref = G.group_norm_reference(p, x.float(), groups, eps, silu)
        err = (out.float() - ref).abs().max().item()
        scale = ref.abs().max().item()
        row = {"shape": [n, hw, c], "groups": groups, "eps": eps,
               "silu": silu, "per_image": per_image, "max_abs_err": err,
               "ref_abs_max": scale,
               "ms": cuda_ms(lambda: G.group_norm_cuda(p, x, groups, eps,
                                                       silu)),
               "plain_ms": cuda_ms(lambda: G.group_norm_reference(
                   p, x, groups, eps, silu)),
               "cuda_site_ms": cuda_ms(lambda: unet._gn(
                   p, x, groups, eps, silu, "cuda"))}
        emit({"phase": "kernel_gn", **row})
        if not err <= FUSED_TOL * scale:
            raise AssertionError(f"group_norm kernel disagrees at {row}")
        rows.append(row)
    return rows


def phase_kernel_conv(conv_sites):
    """K3 at every main-path shape and at ragged ones, against its plain
    version in float32 on the same bf16 inputs (the prologue from a real
    GroupNorm of x, ``gn_affine``, which is K2's statistics mode, itself
    held against its plain version); times of the kernel, of the plain
    version, of the whole cuda_conv site (``gn_affine`` + the kernel) and of
    the cuda policy's site (bf16 GroupNorm + SiLU + cuDNN conv + bias)."""
    from sdtpu_torch.models import unet
    from sdtpu_torch.ops import conv as C
    from sdtpu_torch.ops import groupnorm as G

    g = torch.Generator(device="cuda").manual_seed(5)
    cases = [(k, n) for k, n in sorted(conv_sites.items(), key=str)]
    cases += [((s, co, k, pro, True), 0, q8)
              for s, co, k, pro, q8 in CONV_RAGGED]
    rows = []
    for case in cases:
        (shape, c_out, k, prologue, per_sample), per_image = case[:2]
        int8 = len(case) == 3 and case[2]
        n, h, w_, c_in = shape
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        w = torch.randn((c_out, c_in, k, k), generator=g, device="cuda") / (
            k * k * c_in) ** 0.5
        scale = None
        if int8:
            scale = w.abs().amax(dim=(1, 2, 3)) / 127.0
            w = torch.round(w / scale[:, None, None, None]).to(torch.int8)
        else:
            w = w.to(torch.bfloat16)
        w = w.contiguous(memory_format=torch.channels_last)
        b = torch.randn((n, c_out) if per_sample else (c_out,),
                        generator=g, device="cuda")
        pn = {"scale": (torch.rand(c_in, generator=g, device="cuda") + 0.5
                        ).to(torch.bfloat16),
              "bias": torch.randn(c_in, generator=g, device="cuda").to(
                  torch.bfloat16)}
        groups = 32 if c_in % 32 == 0 else 8
        kw = {}
        affine = {}
        if prologue:
            a, d = G.group_norm_affine_cuda(pn, x, groups, 1e-5)
            kw = {"a": a, "d": d, "silu": prologue == "silu"}
            ra, rd = C.gn_affine_reference(pn, x, groups, 1e-5)
            affine = {
                "affine_abs_err": max((a - ra).abs().max().item(),
                                      (d - rd).abs().max().item()),
                "affine_rel_err": max(rel_err(a, ra), rel_err(d, rd)),
                "affine_ms": cuda_ms(lambda: G.group_norm_affine_cuda(
                    pn, x, groups, 1e-5)),
                "affine_plain_ms": cuda_ms(lambda: C.gn_affine_reference(
                    pn, x, groups, 1e-5))}
            del ra, rd
        out = C.fused_conv_cuda(x, w, b, w_scale=scale, **kw)
        torch.cuda.synchronize()
        ref = C.fused_conv_reference(x.float(), w, b, w_scale=scale, **kw)
        err = (out.float() - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        del ref
        flop = 2.0 * n * h * w_ * c_out * k * k * c_in
        ms = cuda_ms(lambda: C.fused_conv_cuda(x, w, b, w_scale=scale, **kw))
        row = {"x": list(shape), "c_out": c_out, "k": k,
               "prologue": prologue, "int8": int8, "per_image": per_image,
               "max_abs_err": err, "ref_abs_max": ref_max, "ms": ms,
               "tflops": flop / ms / 1e9,
               "plain_ms": cuda_ms(lambda: C.fused_conv_reference(
                   x, w, b, w_scale=scale, **kw)), **affine}
        if prologue and not int8:
            # the whole site under each policy, with the same GroupNorm
            pc = {"w": w, "b": b if b.dim() == 1 else b[0]}
            t = (b - pc["b"]).to(torch.bfloat16) if per_sample else None
            for policy in ("cuda_conv", "cuda"):
                row[f"{policy}_site_ms"] = cuda_ms(lambda: unet._norm_conv(
                    pn, pc, x, groups, 1e-5, policy,
                    fuse_silu=prologue == "silu", padding=k // 2, t=t))
        emit({"phase": "kernel_conv", **row})
        if not err <= FUSED_TOL * ref_max:
            raise AssertionError(f"conv kernel disagrees at {row}")
        if affine and not affine["affine_rel_err"] <= AFFINE_TOL:
            raise AssertionError(f"gn_affine kernel disagrees at {row}")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def per_image_ms(rows, key):
    return sum(r["per_image"] * r[key] for r in rows if key in r)


def phase_model(ctx):
    """The full-width UNet and VAE decoder under each policy, in bf16, each
    against a float32 run of the same weights (bf16 values widened exactly)
    on the same inputs. Each kernel policy must be as close to float32 as
    the plain bf16 path is, within a factor MODEL_FACTOR: all differ from
    it only by bf16 rounding."""
    from sdtpu_torch.io.params import cast_params
    from sdtpu_torch.models import unet, vae

    cfg = ctx.cfg
    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            cfg.compute_dtype)

    x = randn(2, cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    te = randn(2, cfg.unet.time_embed_dim)
    context = randn(2, cfg.clip.context_len, cfg.unet.context_dim)
    z = randn(1, cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    res = {"phase": "model"}
    checks = {"unet": ("cuda", "cuda_gn", "cuda_conv"),
              "vae": ("cuda", "cuda_conv")}
    with torch.inference_mode():
        for name, run in (
                ("unet", lambda p, k, f: unet.apply(
                    p["unet"], f(x), f(te), f(context), cfg.unet, k)),
                ("vae", lambda p, k, f: vae.apply(p["vae"], f(z), cfg.vae,
                                                  k))):
            p32 = {name: cast_params(ctx.params[name], torch.float32)}
            ref = run(p32, "plain", lambda t: t.float())
            del p32
            for k in ("plain",) + checks[name]:
                out = run(ctx.params, k, lambda t: t)
                res[f"{name}_{k}_finite"] = bool(torch.isfinite(out).all())
                res[f"{name}_{k}_rel_err"] = rel_err(out, ref)
                del out
            del ref
            torch.cuda.empty_cache()
    emit(res)
    for name, policies in checks.items():
        for k in policies:
            if not (res[f"{name}_{k}_finite"] and res[f"{name}_{k}_rel_err"]
                    <= MODEL_FACTOR * res[f"{name}_plain_rel_err"]):
                raise AssertionError(f"{name} under {k} off the float32 run: "
                                     f"{res}")


def phase_breakdown(ctx, policy):
    """Where one image's time goes under ``policy``: CUDA-event times of
    the three stages, then a torch.profiler trace of one image (device busy
    and idle share, the kernels that take the most device time)."""
    from torch.profiler import ProfilerActivity, profile

    from sdtpu_torch.engine import pipeline

    ctx.kernels = policy
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    gen = torch.Generator(device="cuda").manual_seed(5)
    with torch.inference_mode():
        ev[0].record()
        context = pipeline._build_context(ctx.params, ctx._tokens(PROMPT),
                                          ctx._uncond, ctx.cfg, True)
        ev[1].record()
        x = pipeline.denoise(ctx.params, context, gen, 7.5, ctx.cfg,
                             ctx.steps, True, ctx.kernels)
        ev[2].record()
        pipeline.decode_latents(ctx.params, x, ctx.cfg, ctx.kernels)
        ev[3].record()
    torch.cuda.synchronize()
    res = {"phase": "breakdown", "kernels": policy,
           "text_ms": ev[0].elapsed_time(ev[1]),
           "denoise_ms": ev[1].elapsed_time(ev[2]),
           "unet_eval_ms": ev[1].elapsed_time(ev[2]) / ctx.steps,
           "decode_ms": ev[2].elapsed_time(ev[3])}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctx.generate(PROMPT, guidance=7.5, seed=5)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    launches = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            launches += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    res.update({
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / wall_ms if busy else None,
        "device_kernels": launches,
        "flash_ms": sum(v for k, v in by_name.items()
                        if "flash_fwd_kernel" in k),
        "group_norm_ms": sum(v for k, v in by_name.items()
                             if "gn_kernel" in k),
        "conv_ms": sum(v for k, v in by_name.items() if "conv_kernel" in k),
        "top_kernels_ms": [[k[:90], v] for k, v in top]})
    emit(res)
    ctx.kernels = "cuda"


def check_image(img, size):
    if img.shape != (size, size, 3) or img.dtype != np.uint8:
        raise AssertionError(f"image {img.shape} {img.dtype}")
    if img.min() == img.max():
        raise AssertionError("constant image")


def phase_main_path(ctx):
    """The ``auto`` policy (cuda): first image, median s/image, peak
    memory, and the final latents."""
    size = ctx.cfg.image_size
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    img = ctx.generate(PROMPT, guidance=7.5)
    first = time.perf_counter() - t0
    launches = counts()
    check_image(img, size)
    if launches != PINNED["cuda"]:
        raise AssertionError(f"launches for one image {launches}, expected "
                             f"{PINNED['cuda']}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ctx.generate(PROMPT, guidance=7.5)
        times.append(time.perf_counter() - t0)
    lat = ctx.generate(PROMPT, guidance=7.5, seed=0, output="latent")
    if lat.shape != (ctx.cfg.latent_size,) * 2 + (4,) or not np.isfinite(
            lat).all():
        raise AssertionError("final latents not finite")
    emit({"phase": "main_path", "kernels": "cuda", "init_s": ctx.init_seconds,
          "first_image_s": first, "s_per_image": statistics.median(times),
          "image_s": times, "launches_per_image": launches,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "image_mean": float(img.mean()), "image_std": float(img.std()),
          "latent_abs_max": float(np.abs(lat).max())})
    return launches


def phase_policy(ctx, policy):
    """The main path under a fused policy on the same Context: one image
    with the pinned launches of every kernel, the same seed giving the same
    bytes, median s/image of 3."""
    ctx.kernels = policy
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    img = ctx.generate(PROMPT, guidance=7.5, seed=11)
    first = time.perf_counter() - t0
    launches = counts()
    check_image(img, ctx.cfg.image_size)
    if launches != PINNED[policy]:
        raise AssertionError(f"{policy}: launches for one image {launches}, "
                             f"expected {PINNED[policy]}")
    same = bool(np.array_equal(img, ctx.generate(PROMPT, guidance=7.5,
                                                 seed=11)))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ctx.generate(PROMPT, guidance=7.5)
        times.append(time.perf_counter() - t0)
    emit({"phase": "main_path", "kernels": policy, "first_image_s": first,
          "s_per_image": statistics.median(times), "image_s": times,
          "launches_per_image": launches, "identical": same,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "image_mean": float(img.mean()), "image_std": float(img.std())})
    ctx.kernels = "cuda"
    if not same:
        raise AssertionError(f"{policy}: same seed gave different images")
    return launches


def phase_ab(ctx):
    """s/image under every policy, in turns (plain, cuda, cuda_gn,
    cuda_conv, then back, twice) on the same context and weights. It runs
    right after the main-path phases, before the float32 and profiler
    phases, so every arm sees the state the main-path timing saw."""
    times = {k: [] for k in POLICIES}
    for k in (POLICIES + POLICIES[::-1]) * 2:
        ctx.kernels = k
        t0 = time.perf_counter()
        ctx.generate(PROMPT, guidance=7.5, seed=9)
        times[k].append(time.perf_counter() - t0)
    ctx.kernels = "cuda"
    emit({"phase": "ab", "s_per_image": {k: statistics.median(v)
                                         for k, v in times.items()},
          "image_s": times})


def phase_determinism(ctx):
    a = ctx.generate(PROMPT, guidance=7.5, seed=123)
    b = ctx.generate(PROMPT, guidance=7.5, seed=123)
    same = bool(np.array_equal(a, b))
    emit({"phase": "determinism", "kernels": ctx.kernels, "identical": same})
    if not same:
        raise AssertionError("same seed gave different images")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from sdtpu_torch import Context

    name, _ = phase_device()
    phase_build()
    rows = phase_kernel()
    ctx = Context(config="sd15", steps=STEPS, sampler="dpm", kernels="auto",
                  seed=0, device="cuda")
    if ctx.kernels != "cuda":
        raise AssertionError(f"kernels resolved to {ctx.kernels}")
    gn_sites, conv_sites = phase_sites(ctx)
    gn_rows = phase_kernel_gn(gn_sites)
    conv_rows = phase_kernel_conv(conv_sites)
    emit({"phase": "kernel_totals", "per_image_ms": {
        "group_norm_kernel": per_image_ms(gn_rows, "ms"),
        "group_norm_plain": per_image_ms(gn_rows, "plain_ms"),
        "group_norm_cuda_site": per_image_ms(gn_rows, "cuda_site_ms"),
        "conv_kernel": per_image_ms(conv_rows, "ms"),
        "gn_affine_kernel": per_image_ms(conv_rows, "affine_ms"),
        "gn_affine_plain": per_image_ms(conv_rows, "affine_plain_ms"),
        "conv_cuda_conv_site": per_image_ms(conv_rows, "cuda_conv_site_ms"),
        "conv_cuda_site": per_image_ms(conv_rows, "cuda_site_ms")}})
    launches = {"cuda": phase_main_path(ctx)}
    phase_determinism(ctx)
    for policy in ("cuda_gn", "cuda_conv"):
        launches[policy] = phase_policy(ctx, policy)
    phase_ab(ctx)
    phase_model(ctx)
    for policy in ("cuda", "cuda_gn", "cuda_conv"):
        phase_breakdown(ctx, policy)

    # the timed row of each kernel: its most frequent main-path shape (the
    # largest plane among equals)
    gn_main = max(gn_rows, key=lambda r: (r["per_image"], r["shape"][1]))
    conv_main = max(conv_rows, key=lambda r: (r["per_image"], r["x"][1]))
    emit({"kernels": [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "sdtpu_torch/csrc/flash_attn_fwd.cu",
         "replaces": "sdtpu/ops/attention.py:37",
         "launches": launches["cuda"]["flash"],
         "max_abs_err": max(r["max_abs_err"] for r in rows),
         "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
         "timed_shape": rows[0]["shape"] + [rows[0]["heads"]],
         "shapes": rows},
        {"name": "group_norm_silu", "route": "cuda",
         "source": "sdtpu_torch/csrc/group_norm_silu.cu",
         "replaces": "sdtpu/ops/groupnorm.py:38",
         "launches": launches["cuda_gn"]["group_norm"],
         "max_abs_err": max(r["max_abs_err"] for r in gn_rows),
         "ms": gn_main["ms"], "plain_ms": gn_main["plain_ms"],
         "cuda_site_ms": gn_main["cuda_site_ms"],
         "timed_shape": gn_main["shape"] + [gn_main["groups"]]},
        {"name": "conv_gn_silu", "route": "cuda",
         "source": "sdtpu_torch/csrc/conv_gn_silu.cu",
         "replaces": "sdtpu/ops/conv.py:236",
         "also_replaces": "sdtpu/ops/conv.py:301",
         "launches": launches["cuda_conv"]["conv"],
         "max_abs_err": max(r["max_abs_err"] for r in conv_rows),
         "ms": conv_main["ms"], "plain_ms": conv_main["plain_ms"],
         "cuda_site_ms": conv_main.get("cuda_site_ms"),
         "timed_shape": conv_main["x"] + [conv_main["c_out"],
                                          conv_main["k"]]},
        {"name": "group_norm_affine", "route": "cuda",
         "source": "sdtpu_torch/csrc/group_norm_silu.cu",
         "replaces": "sdtpu/ops/groupnorm.py:38",
         "note": "K2's statistics mode: the prologue operands of "
                 "conv_gn_silu, in place of sdtpu/ops/conv.py:632 "
                 "gn_affine (XLA work in the reference)",
         "launches": launches["cuda_conv"]["group_norm_affine"],
         "max_abs_err": max(r["affine_abs_err"] for r in conv_rows
                            if "affine_abs_err" in r),
         "ms": conv_main["affine_ms"],
         "plain_ms": conv_main["affine_plain_ms"],
         "timed_shape": conv_main["x"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
