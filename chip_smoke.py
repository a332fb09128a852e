"""Smoke run of the PyTorch/CUDA port (sdtpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON object per line:

1. device: the card's name and power limit (also printed raw, as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them), torch and CUDA versions;
2. build: nvcc builds the kernels from sdtpu_torch/csrc (first use);
3. kernel: the flash-attention kernel against its plain version at the
   main path's shapes (and d=64 as a look ahead), error and CUDA-event
   times;
4. main path: Context(config="sd15", steps=20, sampler="dpm") with random
   demo weights generates 512x512 images; one image must launch the kernel
   exactly 201 times; init time, first image, median s/image, peak memory;
5. determinism: the same seed gives the same bytes;
6. ab: s/image with the plain attention and with the kernel, in turns;
7. model: one SD1.5 UNet eval and one VAE decode at full width, with the
   kernel and with the plain attention, each against float32;
8. breakdown: stage times and a profiler trace of one image.

Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Any failure ends the run with a non-zero exit and no last line.
Without a CUDA card it exits non-zero before printing anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PROMPT = "a photograph of an astronaut riding a horse"
KERNEL_TOL = 2e-2       # bf16 output (2^-9 relative) and bf16 P in P.V
MODEL_FACTOR = 2.0      # see phase_model
KERNELS = ("cuda", "plain")
# (batch, seq, channels, heads): UNet 64x64 and 32x32 self-attention at the
# CFG batch of 2, the VAE mid block, and d=64 (SD2/SDXL) as a look ahead
SHAPES = [(2, 4096, 320, 8), (2, 1024, 640, 8), (1, 4096, 512, 1),
          (2, 4096, 512, 8)]
# 5 self-attentions at 64x64 + 5 at 32x32 per UNet eval, 20 evals, plus the
# VAE mid block
LAUNCHES_PER_IMAGE = (5 + 5) * 20 + 1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


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
          "built": fresh, "library": str(path.relative_to(_build.PKG_DIR))})


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


def phase_model(ctx):
    """The full-width UNet and VAE decoder with the kernel and with the
    plain attention, both in bf16, each against a float32 run of the same
    weights (bf16 values widened exactly) on the same inputs. The kernel
    path must be as close to float32 as the plain bf16 path is, within a
    factor MODEL_FACTOR: both differ from it only by bf16 rounding."""
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
    with torch.inference_mode():
        for name, run in (
                ("unet", lambda p, k, f: unet.apply(
                    p["unet"], f(x), f(te), f(context), cfg.unet, k)),
                ("vae", lambda p, k, f: vae.apply(p["vae"], f(z), cfg.vae,
                                                  k))):
            p32 = {name: cast_params(ctx.params[name], torch.float32)}
            ref = run(p32, "plain", lambda t: t.float())
            del p32
            out = {k: run(ctx.params, k, lambda t: t) for k in KERNELS}
            res[f"{name}_finite"] = bool(torch.isfinite(out["cuda"]).all())
            for k in KERNELS:
                res[f"{name}_{k}_rel_err"] = rel_err(out[k], ref)
            del ref, out
            torch.cuda.empty_cache()
    emit(res)
    for name in ("unet", "vae"):
        if not (res[f"{name}_finite"] and res[f"{name}_cuda_rel_err"]
                <= MODEL_FACTOR * res[f"{name}_plain_rel_err"]):
            raise AssertionError(f"kernel path off the float32 run: {res}")


def phase_breakdown(ctx):
    """Where one image's time goes: CUDA-event times of the three stages,
    then a torch.profiler trace of one image (device busy and idle share,
    the kernels that take the most device time)."""
    from torch.profiler import ProfilerActivity, profile

    from sdtpu_torch.engine import pipeline

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
    res = {"phase": "breakdown",
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
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    res.update({
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / wall_ms if busy else None,
        "flash_ms": sum(v for k, v in by_name.items()
                        if "flash_fwd_kernel" in k),
        "top_kernels_ms": [[k[:90], v] for k, v in top]})
    emit(res)


def phase_main_path(ctx):
    from sdtpu_torch.ops import attention as A

    size = ctx.cfg.image_size
    torch.cuda.reset_peak_memory_stats()
    A.flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    img = ctx.generate(PROMPT, guidance=7.5)
    first = time.perf_counter() - t0
    launches = A.flash_attention_cuda.launches
    if img.shape != (size, size, 3) or img.dtype != np.uint8:
        raise AssertionError(f"image {img.shape} {img.dtype}")
    if img.min() == img.max():
        raise AssertionError("constant image")
    if launches != LAUNCHES_PER_IMAGE:
        raise AssertionError(f"{launches} kernel launches for one image, "
                             f"expected {LAUNCHES_PER_IMAGE}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ctx.generate(PROMPT, guidance=7.5)
        times.append(time.perf_counter() - t0)
    lat = ctx.generate(PROMPT, guidance=7.5, seed=0, output="latent")
    if lat.shape != (ctx.cfg.latent_size,) * 2 + (4,) or not np.isfinite(
            lat).all():
        raise AssertionError("final latents not finite")
    emit({"phase": "main_path", "init_s": ctx.init_seconds,
          "first_image_s": first, "s_per_image": statistics.median(times),
          "image_s": times, "launches_per_image": launches,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "image_mean": float(img.mean()), "image_std": float(img.std()),
          "latent_abs_max": float(np.abs(lat).max())})
    return launches


def phase_ab(ctx):
    """s/image with the plain attention and with the kernel, in turns
    (plain, kernel, kernel, plain, twice) on the same context and weights.
    It runs right after the main path, before the float32 and profiler
    phases, so both arms see the state the main-path timing saw."""
    times = {k: [] for k in KERNELS}
    for k in ("plain", "cuda", "cuda", "plain") * 2:
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
    emit({"phase": "determinism", "identical": same})
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
    ctx = Context(config="sd15", steps=20, sampler="dpm", kernels="auto",
                  seed=0, device="cuda")
    if ctx.kernels != "cuda":
        raise AssertionError(f"kernels resolved to {ctx.kernels}")
    launches = phase_main_path(ctx)
    phase_determinism(ctx)
    phase_ab(ctx)
    phase_model(ctx)
    phase_breakdown(ctx)
    main_row = rows[0]
    emit({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "sdtpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "sdtpu/ops/attention.py:37",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "timed_shape": main_row["shape"] + [main_row["heads"]],
        "shapes": rows}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
