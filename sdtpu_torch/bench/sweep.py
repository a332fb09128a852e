"""Config-matrix sweep harness, the counterpart of ``sdtpu/bench/sweep.py``:
the sampler sweep (DPM/DDIM/PLMS x steps x CFG), batched multi-prompt and
high-res configs through ``sdtpu_torch.Context``, one JSON line per config
(metric: s/image at steady state, host clock around ``generate``, which
ends in the image's copy to the host), with optional image dumps for eyeball
checks.
"""

from __future__ import annotations

import json
import statistics
import struct
import time
import zlib
from pathlib import Path
from typing import Optional


def write_png(path, img) -> None:
    """An 8-bit RGB PNG of a uint8 [H, W, 3] array (zlib, no filter), so
    the dump needs no imaging package."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def run_sweep(
    config: str = "sd15",
    samplers=("dpm", "ddim", "plms", "plms_exact"),
    steps_list=(10, 20, 50),
    guidance_list=(1.0, 4.0, 7.5),
    batches=(1, 4),
    sizes=(512, 768),
    iters: int = 3,
    out_dir: Optional[str] = None,
    dump_images: bool = False,
    quick: bool = False,
    device="cuda",
):
    """Yield one result dict per config (and optionally write JSONL/PNGs);
    ``quick`` keeps the first sampler, steps and size, guidance 7.5 and
    batch 1. One Context at a time: each is dropped before the next."""
    import numpy as np

    import sdtpu_torch

    if quick:
        samplers = samplers[:1]
        steps_list = steps_list[:1]
        guidance_list = (7.5,)
        batches = (1,)
        sizes = sizes[:1]

    out_path = Path(out_dir) if out_dir else None
    if out_path:
        out_path.mkdir(parents=True, exist_ok=True)
    prompt = "a photograph of an astronaut riding a horse"
    results = []

    for size in sizes:
        ctx = None
        for sampler in samplers:
            for steps in steps_list:
                for g in guidance_list:
                    for b in batches:
                        if ctx is None or ctx.sampler != sampler \
                                or ctx.steps != steps:
                            ctx = None
                            ctx = sdtpu_torch.Context(
                                config=config, steps=steps, sampler=sampler,
                                size=size if config == "sd15" else None,
                                device=device,
                            )
                        prompts = [prompt] * b if b > 1 else prompt
                        ctx.generate(prompts, guidance=g, seed=0)  # warm
                        times = []
                        for i in range(iters):
                            t = time.perf_counter()
                            img = ctx.generate(prompts, guidance=g, seed=i)
                            times.append(time.perf_counter() - t)
                        r = {
                            "config": config, "size": size,
                            "sampler": sampler, "steps": steps,
                            "guidance": g, "batch": b,
                            "kernels": ctx.kernels,
                            "s_per_image": statistics.median(times) / b,
                            "s_per_call": statistics.median(times),
                        }
                        results.append(r)
                        line = json.dumps(r)
                        print(line, flush=True)
                        if out_path:
                            with open(out_path / "sweep.jsonl", "a") as f:
                                f.write(line + "\n")
                            if dump_images:
                                im = img[0] if b > 1 else img
                                write_png(out_path /
                                          f"{sampler}_{steps}_{g}_{size}.png",
                                          np.ascontiguousarray(im))
        ctx = None
    return results
