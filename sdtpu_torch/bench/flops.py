"""FLOP and MFU accounting, the counterpart of ``sdtpu/bench/flops.py``.

``PART_FLOPS`` is a copy of the JAX package's table, provenance line and
all: FLOP counts of the model, which do not depend on the device that runs
it. ``count_flops`` is the port's own count of the same parts, taken on
the meta device (shapes only, nothing computed), and the tests hold the two
together. ``PEAK_TFLOPS`` is the CUDA card's own dense bf16 peak.
"""

from __future__ import annotations

import functools

#: dense bf16 peak TFLOP/s by device kind, lower-cased token, first match
#: wins (NVIDIA's data sheets: H100 SXM 989, H100 NVL 835, H100 PCIe 756;
#: ``nvidia-smi`` names the SXM card "NVIDIA H100 80GB HBM3")
PEAK_TFLOPS = [("h100 nvl", 835.0), ("h100 pcie", 756.0), ("h100", 989.0)]

#: per-part FLOPs from compiled-executable cost_analysis
#: (tools/extract_flops.py, kernels as served). ``unet_cfg`` is the batch-2
#: cond+uncond hot-loop program (one CFG step per image); ``unet_b1`` the
#: batch-1 no-CFG program (LCM / guidance-embedded serving).
PART_FLOPS: dict[str, dict[str, float]] = {
    # captured 2026-08-19 on TPU v5e, kernels=pallas
    "sd15": {"unet_cfg": 1.552361193472e12, "clip": 1.3363400704e10,
             "vae_dec": 2.578692702208e12, "temb": 8.214352e7},
}

#: ``count_flops``'s part names -> (the runner's part, its batch): the
#: table's names and the runner's both
PARTS = {"unet_cfg": ("unet", 2), "unet_b1": ("unet", 1),
         "unet": ("unet", 2), "vae_dec": ("vae_decoder", 1),
         "vae_decoder": ("vae_decoder", 1), "clip": ("text_encoder", 1),
         "text_encoder": ("text_encoder", 1), "temb": ("temb", 20)}


def peak_tflops(device_kind: str) -> float | None:
    kind = device_kind.lower()
    for token, peak in PEAK_TFLOPS:
        if token in kind:
            return peak
    return None


def count_flops(cfg, part: str, batch: int | None = None) -> float:
    """FLOPs of one call of ``part`` (a name of ``PARTS``) of ``cfg`` at
    the runner's shapes (``batch`` rows, timesteps for ``temb``, in place of
    the part's own), counted by ``torch.utils.flop_counter.FlopCounterMode``
    over the port's models on the meta device under the ``plain`` policy.
    Under a ``cuda*`` policy the hand-written kernels launch through ctypes
    and the counter would not see them; their plain versions compute the
    same function as torch ops, which it counts (products and convs).
    Cached by configuration, part and batch (the UNet's count takes
    seconds)."""
    name, default = PARTS[part]
    return _count(cfg, name, batch or default)


@functools.lru_cache(maxsize=64)
def _count(cfg, name: str, batch: int) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from sdtpu_torch.bench.runner import part_specs

    fn, args = part_specs(cfg, None, "plain", "meta", batch=batch)[name]
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def image_flops(config: str, steps: int, n_controlnets: int = 0,
                cfg_batch: bool = True) -> float | None:
    """Total FLOPs for one prompt->image generate of ``config`` at ``steps``
    solver steps on the full-UNet-per-step path (no deepcache/cfg-interval/
    ToMe/quant — those change per-step FLOPs). None when the config has no
    captured constants or the requested path wasn't captured.

    Family formulas:
    - CFG families (sd15/sd2x/sdxl/x4): unet_cfg per step, both text
      encodes (cond + uncond), one VAE decode, the temb table.
    - dual-tower (sdxl*): + clip2 encodes (both towers run cond + uncond).
    - no-CFG (``cfg_batch=False``, LCM): unet_b1 per step, one encode.
    - + n ControlNets: + n * controlnet_cfg per step (hint embed runs once,
      outside the loop; counted via ``cn_hint`` when captured).
    """
    pf = PART_FLOPS.get(config)
    if pf is None:
        return None
    encodes = 2 if cfg_batch else 1
    unet_key = "unet_cfg" if cfg_batch else "unet_b1"
    if unet_key not in pf:
        return None
    total = pf[unet_key] * steps + pf.get("temb", 0.0) + pf["vae_dec"]
    total += pf["clip"] * encodes + pf.get("clip2", 0.0) * encodes
    if n_controlnets:
        if "controlnet_cfg" not in pf:
            return None
        total += (pf["controlnet_cfg"] * steps
                  + pf.get("cn_hint", 0.0)) * n_controlnets
    return total


def mfu_fields(config: str, steps: int, value_s: float, device_kind: str,
               pure: bool = True, n_controlnets: int = 0,
               cfg_batch: bool = True) -> dict:
    """tflop_per_image / tflop_per_s / mfu_pct fields for a measured
    per-image latency, or {} when not applicable; no ``mfu_pct`` on a
    device kind ``PEAK_TFLOPS`` does not know."""
    if not pure or value_s <= 0:
        return {}
    flops = image_flops(config, steps, n_controlnets, cfg_batch)
    if flops is None:
        return {}
    tflop = flops / 1e12
    tflops_s = tflop / value_s
    out = {"tflop_per_image": round(tflop, 2),
           "tflop_per_s": round(tflops_s, 1)}
    peak = peak_tflops(device_kind)
    if peak:
        out["mfu_pct"] = round(100.0 * tflops_s / peak, 1)
        out["peak_tflops_bf16"] = peak
    return out
