"""Offline checkpoint converter: SD v1.x, v2.x, XL, LCM, x4-upscaler or
SDXL-refiner checkpoint -> model directory.

The port's counterpart of ``tools/convert_weights.py``:

    input:  an LDM single-file checkpoint (*.safetensors, or *.ckpt / *.pt /
            *.pth read with ``torch.load(weights_only=True)``): SD1.x, SD
            2.x with its OpenCLIP tower (``--config sd21`` or ``sd21base``)
            or SDXL in the sgm naming (``--config sdxl``), or a
            concat-conditioned variant with its wider ``conv_in``
            (``--config sd15_inpaint``, ``sd21_inpaint``, ``sdxl_inpaint``,
            ``sd2_depth``, ``sd15_ip2p``), or a staged one: LCM with its
            ``time_embed.cond_proj`` (``--config sd15_lcm``), the x4
            upscaler with its ``label_emb`` (``sd_x4``), the SDXL refiner
            with its one bigG tower (``sdxl_refiner``)
    output: <out_dir>/model.sdtpu.safetensors, the JAX package's native
            format (the flattened JAX-layout tree in the target dtype,
            quantized as asked), which both packages load
            [+ ctokenizer.txt copied alongside with --tokenizer]

Usage (from the repository root):

    python3 -m sdtpu_torch.tools.convert_weights \\
        v1-5-pruned-emaonly.safetensors out_dir [--dtype bfloat16] \\
        [--config sd15|sd21|sd21base|sdxl|<a concat or staged one>|tiny] \\
        [--tokenizer ctokenizer.txt] [--int8] [--int8w conv|dense] [--force]

Then ``sdtpu_torch.Context(model_dir="out_dir", config=..., device="cuda")``
with the same ``config``. A model
quantized here serves with ``quantize="none"``: its int8 leaves are in the
file. Runs on the host; no GPU is needed.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

import torch

from sdtpu_torch.config import CONFIGS
from sdtpu_torch.io import safetensors as st
from sdtpu_torch.io.weights import (NATIVE_SUFFIX, load_ldm_state_dict,
                                    save_native)
from sdtpu_torch.quant.ptq import (count_quantized, quantize_unet,
                                   quantize_weights_only)


def load_state_dict(path: Path) -> dict:
    """{key: tensor} of an LDM checkpoint file."""
    if path.suffix == ".safetensors":
        return st.load_file(path)
    if path.suffix in (".ckpt", ".pt", ".pth"):
        sd = torch.load(str(path), map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
        return {k: v for k, v in sd.items() if torch.is_tensor(v)}
    raise ValueError(f"unsupported checkpoint format: {path.suffix}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint", type=Path)
    ap.add_argument("out_dir", type=Path)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--config", default="sd15", choices=sorted(CONFIGS))
    ap.add_argument("--tokenizer", type=Path, default=None,
                    help="ctokenizer.txt to copy into the model dir")
    ap.add_argument("--int8", action="store_true",
                    help="also apply int8 PTQ to the transformer matmuls")
    ap.add_argument("--int8w", choices=("conv", "dense"), default=None,
                    help="bake weight-only int8 into the UNet (conv: conv "
                         "sites; dense: convs and matmuls)")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    cfg = CONFIGS[args.config]
    out = args.out_dir / f"model{NATIVE_SUFFIX}"
    args.out_dir.mkdir(parents=True, exist_ok=True)
    if out.exists() and not args.force:
        print(f"{out} exists (use --force to overwrite)")
        return 0

    print(f"loading {args.checkpoint} ...")
    sd = load_state_dict(args.checkpoint)
    print(f"  {len(sd)} tensors; mapping to the parameter tree ...")
    params = load_ldm_state_dict(sd, cfg, dtype=getattr(torch, args.dtype))
    if args.int8:
        params = quantize_unet(params)
        print(f"  int8 PTQ: {count_quantized(params)} sites")
    if args.int8w:
        params["unet"] = quantize_weights_only(
            params["unet"], include_dense=args.int8w == "dense")
        print(f"  weight-only int8 baked ({args.int8w})")
    save_native(params, out)
    print(f"wrote {out}")
    if args.tokenizer:
        shutil.copy(args.tokenizer, args.out_dir / "ctokenizer.txt")
        print(f"copied tokenizer -> {args.out_dir / 'ctokenizer.txt'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
