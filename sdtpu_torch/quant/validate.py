"""Quantization quality validation: a quantized against a full-precision
pipeline, image for image at fixed seeds (PSNR, mean |diff|, worst pixel
delta).

The port's own copy of ``sdtpu/quant/validate.py`` (numpy only there too):
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def image_metrics(a: np.ndarray, b: np.ndarray) -> dict:
    """a, b: uint8 images of equal shape."""
    af = a.astype(np.float64)
    bf = b.astype(np.float64)
    mse = float(np.mean((af - bf) ** 2))
    psnr = float("inf") if mse == 0 else 10.0 * np.log10(255.0**2 / mse)
    return {
        "psnr_db": psnr,
        "mean_abs_diff": float(np.mean(np.abs(af - bf))),
        "max_abs_diff": float(np.abs(af - bf).max()),
        "identical_fraction": float(np.mean(a == b)),
    }


def validate_quantized(ctx_fp, ctx_q, prompts, guidance=7.5, seed=0) -> list[dict]:
    """Generate with both contexts at identical seeds and report metrics."""
    out = []
    for i, p in enumerate(prompts):
        a = ctx_fp.generate(p, guidance=guidance, seed=seed + i)
        b = ctx_q.generate(p, guidance=guidance, seed=seed + i)
        m = image_metrics(a, b)
        m["prompt"] = p
        out.append(m)
    return out
