"""Per-phase pipeline timings and ``torch.profiler`` trace capture, the
counterpart of ``sdtpu/bench/profile.py``.

The phases of the reference's runtime timers ("Conditioning" / "Single
iteration" / "Decoding" / "Image generation", reference:
context.cpp:309-314, 331, 381, 398, 402), each timed alone at steady state
through the port's own pipeline functions, as ``Context.generate`` calls
them: ``pipeline._build_context`` (the prompt's rows and the unconditional
ones), ``pipeline.denoise`` on the draws ``pipeline._draws`` makes (the
pipeline's one draw site) and ``pipeline.decode_latents``.
"""

from __future__ import annotations

import statistics
import tempfile
import time
from pathlib import Path

import torch

from sdtpu_torch.config import SD15, PipelineConfig


def phase_timings(
    cfg: PipelineConfig = SD15,
    params=None,
    steps: int = 20,
    sampler: str = "dpm",
    kernels: str = "auto",
    warmup: int = 3,
    iters: int = 10,
    device="cuda",
) -> dict:
    """Median host ms of Conditioning / full denoise / single iteration /
    Decoding (each call ends in a synchronize), the 20-step image estimate
    (``image_generation_est``) and ``per_step``. ``params`` None: the demo
    weights (``runner.demo_params``)."""
    from sdtpu_torch.bench.runner import (check_device, demo_params, resolve,
                                          sync)
    from sdtpu_torch.engine import pipeline

    device = check_device(device)
    kernels = resolve(kernels, device)
    if params is None:
        params = demo_params(cfg, device)
    tokens = torch.zeros((1, cfg.clip.context_len), dtype=torch.int64,
                         device=device)
    shape = pipeline._latent_shape(1, cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    lat = torch.zeros(shape, dtype=torch.float32, device=device)

    with torch.inference_mode():
        uncond = pipeline.encode_text(params, tokens, cfg)[0]
        context = pipeline._build_context(params, tokens, uncond, cfg, True)

        def run_denoise(n):
            d = pipeline._draws(gen, shape, n, sampler, device, {})
            return pipeline.denoise(params, context, 7.5, cfg, n, True,
                                    kernels, noise=d["noise"],
                                    sampler=sampler,
                                    step_noise=d.get("step_noise"))

        fns = {
            "conditioning": lambda: pipeline._build_context(
                params, tokens, uncond, cfg, True),
            "denoise_loop": lambda: run_denoise(steps),
            "single_iteration": lambda: run_denoise(1),
            "decoding": lambda: pipeline.decode_latents(params, lat, cfg,
                                                        kernels),
        }
        out = {}
        for name, fn in fns.items():
            for _ in range(warmup):
                fn()
            sync(device)
            times = []
            for _ in range(iters):
                t = time.perf_counter()
                fn()
                sync(device)
                times.append((time.perf_counter() - t) * 1e3)
            out[name] = statistics.median(times)
    out["image_generation_est"] = (
        out["conditioning"] + out["denoise_loop"] + out["decoding"]
    )
    out["per_step"] = out["denoise_loop"] / steps
    return out


def capture_trace(fn, args, out_dir: str | None = None) -> Path:
    """A ``torch.profiler`` Chrome trace (``chrome://tracing``, Perfetto)
    of one call of ``fn(*args)`` after a warm one, written as
    ``trace.json`` under ``out_dir`` (a new temporary directory when None);
    returns its path."""
    from sdtpu_torch.bench.xprof import on_cuda, trace

    prof = trace(fn, args, on_cuda(args))
    d = Path(out_dir or tempfile.mkdtemp(prefix="sdtpu_torch_trace_"))
    d.mkdir(parents=True, exist_ok=True)
    path = d / "trace.json"
    prof.export_chrome_trace(str(path))
    return path
