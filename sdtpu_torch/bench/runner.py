"""Per-part benchmark runner, the counterpart of ``sdtpu/bench/runner.py``.

Each model part (temb / text encoder / UNet / VAE decoder) is timed alone at
steady state (default warmup=20, iters=100, the reference's protocol) at
the reference's shapes, and its device kernels are counted by class
(``xprof.classify``). One JSON per part goes under ``results/``; a part
that fails leaves a ``.error`` file with its traceback and the others go
on (the reference's fleet behaviour, so a failure stays visible).

Timing: the host clock around each call, which ends in
``torch.cuda.synchronize()``, and beside it the device ms between two CUDA
events around the same call. Every call gets the same inputs: the JAX
package varies them and fetches a value because a remote TPU layer may
memoize repeated inputs and ``block_until_ready`` may return early there
(``sdtpu/bench/runner.py:28-63``); a local CUDA card has neither, and a
synchronize waits for the call's last kernel.
"""

from __future__ import annotations

import json
import statistics
import time
import traceback
from pathlib import Path

import torch

from sdtpu_torch.config import SD15, PipelineConfig
from sdtpu_torch.models import clip, temb, unet, vae

#: the parts, in the runner's order, and the trees each reads
PART_TREES = {"temb": "temb", "text_encoder": "clip", "unet": "unet",
              "vae_decoder": "vae"}


def resolve(kernels: str, device) -> str:
    """``auto`` -> ``cuda`` on a CUDA device, ``plain`` elsewhere, as
    ``Context`` resolves it."""
    if kernels == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "plain"
    return kernels


def check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "false); pass device='cpu' to run the plain "
                           "versions on the host")
    return device


def demo_params(cfg: PipelineConfig, device):
    """The demo weights ``Context`` serves without a checkpoint: every tree
    of the configuration drawn in order from a generator seeded 0 on
    ``device``, each cast to the compute dtype."""
    from sdtpu_torch.io.params import cast_params, init_tree, tree_names

    gen = torch.Generator(device=device).manual_seed(0)
    return {name: cast_params(init_tree(name, cfg, gen, device),
                              cfg.compute_dtype)
            for name in tree_names(cfg)}


def part_specs(cfg: PipelineConfig, params, kernels: str, device,
               batch: int | None = None) -> dict:
    """{part: (fn, args)} at the reference's shapes (``runner.py:112-138``):
    ``temb`` on 20 timesteps, ``text_encoder`` on [1, context_len] tokens,
    ``unet`` on the CFG batch of 2, ``vae_decoder`` at batch 1, all zeros;
    ``batch`` replaces each part's own. ``params`` None: the trees on the
    meta device (shapes only, for ``flops.count_flops``)."""
    dt = cfg.compute_dtype
    s = cfg.latent_size
    if params is None:
        from sdtpu_torch.io.params import cast_params, init_tree

        params = {tree: cast_params(init_tree(tree, cfg, None, device), dt)
                  for tree in PART_TREES.values()}

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    b = batch or 2
    return {
        "temb": (lambda p, t: temb.apply(p, t, cfg.unet, dtype=dt),
                 (params["temb"],
                  torch.linspace(0.0, 999.0, batch or 20, device=device))),
        "text_encoder": (
            lambda p, tok: clip.apply(p, tok, cfg.clip, dtype=dt),
            (params["clip"], zeros(batch or 1, cfg.clip.context_len,
                                   dtype=torch.int64))),
        "unet": (
            lambda p, x, t, c: unet.apply(p, x, t, c, cfg.unet, kernels),
            (params["unet"], zeros(b, s, s, cfg.unet.in_channels),
             zeros(b, cfg.unet.time_embed_dim),
             zeros(b, cfg.clip.context_len, cfg.unet.context_dim))),
        "vae_decoder": (
            lambda p, z: vae.apply(p, z, cfg.vae, kernels),
            (params["vae"], zeros(batch or 1, s, s, cfg.vae.z_channels))),
    }


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_fn(fn, args, warmup: int, iters: int, device):
    """(host ms, device ms or None) of each of ``iters`` calls after
    ``warmup`` calls; each call ends in a synchronize."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn(*args)
    sync(device)
    host, dev = [], []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        if cuda:
            start.record()
        fn(*args)
        if cuda:
            end.record()
        sync(device)
        host.append((time.perf_counter() - t) * 1e3)
        if cuda:
            dev.append(start.elapsed_time(end))
    return host, (dev or None)


def _p99(times):
    return sorted(times)[int(0.99 * (len(times) - 1))]


def op_classes(fn, args) -> dict:
    """The device kernels of one call by class (``xprof.classify``); on the
    CPU, the aten ops by class."""
    from sdtpu_torch.bench.xprof import profile_ops

    out: dict[str, int] = {}
    for rec in profile_ops(fn, args).values():
        out[rec["class"]] = out.get(rec["class"], 0) + rec["count"]
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def device_kind(device) -> str:
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def benchmark_parts(
    cfg: PipelineConfig = SD15,
    params=None,
    warmup: int = 20,
    iters: int = 100,
    parts=None,
    out_dir: str | Path = "results",
    kernels: str = "auto",
    device="cuda",
) -> dict:
    """Benchmark each model part; write results/<part>.json; return the
    summary. ``params`` None: the demo weights (``demo_params``).

    Keys of a part's result, the reference's: ``latency_ms`` (median host
    ms), ``latency_mean_ms``, ``latency_p99_ms``, ``warmup``, ``iters``,
    ``flops`` (``flops.count_flops``), ``bytes_accessed`` (None: nothing
    here counts bytes), ``op_classes`` (device kernels of one call by class,
    in place of HLO instruction counts), ``backend``, ``kernels``; and the
    port's: ``device_ms`` and ``device_p99_ms`` (CUDA events), ``device``,
    ``tflop_per_s`` and ``mfu_pct`` over the host median, and
    ``device_tflop_per_s`` and ``device_mfu_pct`` over the device median
    (no MFU on a device ``flops.PEAK_TFLOPS`` does not know)."""
    from sdtpu_torch.bench.flops import count_flops, peak_tflops

    device = check_device(device)
    kernels = resolve(kernels, device)
    if params is None:
        params = demo_params(cfg, device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    specs = part_specs(cfg, params, kernels, device)
    if parts:
        specs = {k: v for k, v in specs.items() if k in parts}
    kind = device_kind(device)
    peak = peak_tflops(kind)

    summary = {}
    for name, (fn, args) in specs.items():
        try:
            with torch.inference_mode():
                host, dev = time_fn(fn, args, warmup, iters, device)
                classes = op_classes(fn, args)
            flops = count_flops(cfg, name)
            result = {
                "part": name,
                "latency_ms": statistics.median(host),
                "latency_mean_ms": statistics.fmean(host),
                "latency_p99_ms": _p99(host),
                "device_ms": statistics.median(dev) if dev else None,
                "device_p99_ms": _p99(dev) if dev else None,
                "warmup": warmup,
                "iters": iters,
                "flops": flops,
                "bytes_accessed": None,
                "op_classes": classes,
                "backend": device.type,
                "device": kind,
                "kernels": kernels,
            }
            for prefix, ms in (("", result["latency_ms"]),
                               ("device_", result["device_ms"])):
                tflops = flops / ms / 1e9 if ms else None
                result[f"{prefix}tflop_per_s"] = tflops
                result[f"{prefix}mfu_pct"] = (100.0 * tflops / peak
                                              if tflops and peak else None)
            (out_dir / f"{name}.json").write_text(json.dumps(result, indent=1))
            summary[name] = result
        except Exception:  # noqa: BLE001 — the fleet goes on (reference)
            (out_dir / f"{name}.error").write_text(traceback.format_exc())
            summary[name] = {"part": name, "error": True}
    return summary
