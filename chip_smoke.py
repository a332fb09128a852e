"""Smoke run of the PyTorch/CUDA port (sdtpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON object per line:

1. device: the card's name and power limit (also printed raw, as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them), torch and CUDA versions;
2. build: nvcc builds the six kernel sources from sdtpu_torch/csrc (first
   use); resources: registers and spills of the wgmma kernels (K1, K1-bwd,
   K3, K4, K5), from ptxas, taken beside the build: none may spill;
3. kernel: the flash-attention kernel (K1) against its plain version at the
   main path's shapes (and d=64 as a look ahead), error and device
   times, beside ``F.scaled_dot_product_attention`` as a yardstick and the
   time its exponentials alone need; then at the shapes its tiles could
   break (sq != sk, a ragged sk, one tile, d = 8, 128, 256);
4. sites: one SD1.5 UNet eval and one VAE decode under ``cuda_gn`` and
   ``cuda_conv`` record every call shape the fused GroupNorm (K2) and the
   fused conv (K3) get on the main path, and how often per image;
5. kernel_gn, kernel_gn_affine, kernel_conv: K2, K2's statistics mode (at
   the GroupNorm of every fused conv site) and K3 at every one of those
   shapes (K3 with int8 weights too at the UNet's, as ``quantize="int8w"``
   feeds it) and at ragged ones (odd planes, C/G not a multiple of 8, each
   of K2's span classes, planes K2 streams, Cout not a multiple of the
   tile; for K3 the shapes its slab could break and one of each class its
   general kernel takes), each against its plain version run in float32 on
   the same bf16 inputs; device times of the kernel, of the plain version,
   of the one PyTorch call that computes the same function where there is
   one (``F.group_norm`` + SiLU, ``torch.var_mean``), and of the site as
   ``kernels="cuda"`` runs it (bf16 GroupNorm + SiLU + cuDNN conv + bias);
   K2's and K3's rows carry the plan their static rules chose (``design``,
   ``plan``; K2's with the clusters the card holds at once), K3's the time
   its prologue's special-function work alone needs, and at three shapes
   the kernel's time without the prologue;
6. main path: Context(config="sd15", steps=20, sampler="dpm") with random
   demo weights generates 512x512 images under ``kernels="cuda"`` (the
   ``auto`` choice), then under ``"cuda_gn"`` and ``"cuda_conv"`` on the
   same Context; each image must launch each kernel exactly the pinned
   number of times; the same seed must give the same bytes; median s/image
   of 3 under ``cuda``, one more image under the others;
7. ab: s/image under plain, cuda, cuda_gn and cuda_conv, in turns (there
   and back: 2 each);
   samplers: one image each with ddim, plms_exact, euler_a, lms, dpm_sde,
   unipc, heun and dpm_karras under cuda, K1's launches pinned (201, 211
   for plms_exact, 401 for heun), the same bytes for the same seed, finite
   latents;
8. quantized serving, on three more Contexts with the same demo weights:
   ``quantize="int8w_dense"`` (kernels cuda), ``"int8w"`` (cuda_conv) and
   ``"int8"`` (cuda), the last calibrated on the card with 2 prompts x 2
   steps. mm_sites records every call shape the weight-only-int8 GEMM (K4)
   and the W8A8 GEMM (K5) get in one UNet eval; widening sends all 256
   int8 values through both of K4's widenings; kernel_mm holds both
   against their plain versions at those shapes and at ragged ones, with
   device times of the kernel, the plain version and the library
   yardsticks (the bf16 product of the unquantized site and the
   dequantize-then-multiply fallback for K4; the whole library int8 path
   and ``torch._int_mm`` alone for K5); main_path generates under each mode
   (``int8`` with ``ops.matmul.KERNEL_W8A8`` off, where K5 must not launch,
   and on) with every kernel's launches per image pinned and the same seed
   giving the same bytes; ab_quant times the modes in turns; quant_model
   holds one full-width UNet eval under each mode against the unquantized
   float32 UNet, beside the unquantized bf16 error, and records each
   mode's PSNR against the ``quantize="none"`` image at the same seed;
9. batch: ``generate_batch`` of 3 requests (own seed, guidance, negative
   prompt; padded to 4) under cuda, cuda_gn, cuda_conv, int8w_dense and
   int8 with K5: every kernel's launches per call pinned, a batch of one
   against ``generate`` (the same bytes), each request's latents against
   its run alone within ``BATCH_GAP_FACTOR`` times its own gap between
   bf16 and a float32 run, s/image at B = 4 against B = 1 in turns, device
   busy ms per image at B = 4; then kernel_*_b4: the sites of a UNet eval
   at N = 8 and a VAE decode at N = 4 recorded, and K1-K5 held against
   their plain versions at each, with their plans and device times;
10. model: one SD1.5 UNet eval and one VAE decode at full width under each
   policy, each against float32;
11. breakdown: stage times and a profiler trace of one image under cuda,
   cuda_gn, cuda_conv, int8w_dense and int8 with K5;
12. checkpoint: the demo weights exported by ``io.weights.params_to_ldm``
   as a BF16 LDM safetensors file (with the VAE encoder, as every SD
   checkpoint carries it), converted by ``sdtpu_torch.tools.convert_weights``
   to a native file and to an ``--int8w conv`` native file, all under a
   temporary directory; ``Context(model_dir=...)`` on each must give the
   demo Contexts' bytes at the same seed with every kernel's launches per
   image at the pins: the LDM file under cuda, cuda_gn and cuda_conv and
   with ``quantize="int8w_dense"`` and calibrated ``"int8"`` with K5, the
   native file under cuda and cuda_conv, the int8w file under cuda_conv
   with ``quantize="none"`` (its int8 weights are in the file); each
   load's ``init_s`` and each file's size;
13. text_surface, under cuda on the native file, K1's launches pinned and
   the same bytes for the same seed each time: ``clip_skip=2``, a
   textual-inversion placeholder whose vector is a word's row (that word's
   bytes), a scheduled prompt, a degenerate schedule (the plain prompt's
   bytes). The files are deleted after it;
14. families: the SD 2.x and SDXL configurations at full width with demo
   weights, 20 DPM-Solver++(2M) steps, CFG 7.5, batch 1, bf16 (the SD1.5
   Contexts released first). ``sdxl`` at 1024x1024: one image under plain,
   cuda, cuda_gn and cuda_conv on one Context, then on a Context each
   under ``quantize="int8w_dense"`` (K4) and calibrated ``"int8"`` with
   ``KERNEL_W8A8`` (K5); ``sd21`` at 768x768 (v-prediction) under cuda and
   cuda_conv and with heun (the second eval's v conversion); ``sd21base``
   under cuda. Every image: uint8, not constant, finite latents whose
   decode gives the same bytes (the same seed), every kernel's launches
   per image at ``FAMILY_PINNED`` (derived from the rules at every
   full-width site by tests/test_torch_hopper.py). s/image under each
   policy, one image each (SDXL), device busy ms, kernels and idle share per SDXL
   image (torch.profiler), ``init_s``; one UNet eval under each policy
   against float32 within ``MODEL_FACTOR`` of the plain bf16 path's error,
   the quantized modes' under ``QUANT_REL_ERR_MAX``; each family's demo
   tree written as a BF16 LDM file in its real naming (SDXL's sgm layout,
   SD 2.1's OpenCLIP tower) and served by ``Context(model_dir=...)`` with
   the demo bytes and pins (file bytes, write s, ``init_s``); then
   kernel_sdxl_* and kernel_sd21_*: K1-K5 at every site the two families'
   main paths give them, against their plain versions with the existing
   tolerances, device times beside bounds, plain and library times and
   launches per image.

15. image, after the quantized phases, on their Contexts: image-conditioned
   serving on SD1.5 at full width, 20 DPM-Solver++(2M) steps, CFG 7.5, a
   fixed-seed random uint8 image and a mask: ``img2img`` at strength 0.6
   under cuda, cuda_gn and cuda_conv and under ``quantize="int8w_dense"``,
   ``inpaint`` at 1.0, ``hires_fix(scale=2)`` and ``img2img_batch`` of 3
   requests (the batch of one against ``img2img``, the same bytes). Every
   call: uint8, not constant, finite latents whose decode gives the same
   bytes (the same seed), every kernel's launches per call at
   ``IMAGE_PINNED``; the encoder's device ms under cuda and cuda_conv;
   s/image of img2img against generate under cuda, in turns. Then
   kernel_image_*: K1-K5 at every image-conditioned site (the hires pass's
   UNet at a 128^2 grid and its 1024^2 decode, InstructPix2Pix's UNet batch
   of 3, the VAE encoder at 512^2), against their plain versions with the
   existing tolerances, device times beside bounds, plain and library
   times and launches per image (K1's plain version over groups of heads
   where its float32 scores would pass 2 GiB: ``flash_plain``);
16. concat, after the families: the concat-conditioned configurations at
   full width with demo weights, one Context at a time: ``sd15_inpaint``
   and ``sd15_ip2p`` at 20 steps under cuda and cuda_conv, ``sd2_depth``
   at 20 steps (strength 0.8) under cuda, ``sd21_inpaint`` and
   ``sdxl_inpaint`` at 4 steps under cuda (their kernel sites, not a speed
   measure), each call held as in the image phase;
17. knobs, after the image phase, on its Contexts: ``Context``'s knobs on
   SD1.5 at full width, ``KNOB_STEPS`` DPM-Solver++(2M) steps, CFG 7.5,
   one arm each (``KNOB_ARMS``): ToMe at 0.5 and at 0.3 (2,868 merged
   tokens: K1's rule sends them to the plain path), DeepCache 3, PAG 3.0
   at its default ("mid",) and at ("down", "up"), the CFG interval (0.2,
   0.8), CFG rescale 0.7, FreeU (1.5, 1.6, 0.9, 0.2), ``size=768``,
   ``fuse_qkv``, and DeepCache under ``cuda_conv`` and ToMe with PAG under
   ``quantize="int8w_dense"``. Each arm: uint8, not constant, finite
   latents whose decode gives the same bytes (the same seed), every
   kernel's launches per image at ``KNOBS_PINNED`` (derived on the meta
   device from the port's own loop by tests/test_torch_hopper.py); then
   s/image and device busy ms of ToMe 0.5, DeepCache 3 and the CFG
   interval against the knob off, in turns; then kernel_knobs_*: K1-K5 at
   every new site the knobs make (ToMe's 2,048-token self-attention and
   its GEMM rows, the batch-1 evals of PAG and of the interval's unguided
   steps, the 96^2 and 48^2 levels of ``size=768``), against their plain
   versions with the existing tolerances.
18. stages, after the concat phase: the staged configurations at full
   width with demo weights, one or two Contexts at a time: ``sd15_lcm``
   (``sampler="lcm"``, ``LCM_STEPS`` steps, guidance 8 embedded) under cuda
   and cuda_conv, one image and a ``generate_batch`` of three requests with
   three guidances (padded to four), one UNet row a request, each request
   in the batch within ``BATCH_GAP_FACTOR`` of its own bf16 gap to
   float32; the SDXL two-stage call at 1024x1024, ``sdxl`` with
   ``denoising_end=STAGE_END`` and ``output="latent"`` then
   ``sdxl_refiner``'s ``refine(denoising_start=STAGE_END)`` at
   ``STAGE_STEPS`` steps, under cuda, cuda_conv and ``quantize=
   "int8w_dense"``, and ``refine`` at ``denoising_start=0`` from
   ``generate``'s own start latents against ``generate`` (the same bytes,
   4 steps); ``sd_x4``'s ``upscale`` of a fixed-seed 128x128 image at
   noise level 20 to 512x512 at ``STAGE_STEPS`` steps under cuda, cuda_conv
   and int8w_dense. Every call with ``STAGES_PINNED`` (derived on the meta
   device by tests/test_torch_hopper.py), the same bytes from the same
   seed, finite latents; ``init_s``, s/image, device busy ms and kernels
   (torch.profiler), the UNet against float32 under each policy and under
   int8w_dense. Then kernel_stages_*: K1-K5 at the UNet sites the three
   bring (LCM's batch of four, the refiner's and the x4 UNet's CFG batch),
   against their plain versions with the existing tolerances.
19. adapters, after the knobs phase, on its Contexts: per-request adapters
   on SD1.5 at full width, ``ADAPTER_STEPS`` DPM-Solver++(2M) steps, CFG
   7.5: a "random" ControlNet (``Context.load_controlnet``) and a seeded
   512x512 uint8 control image under cuda, cuda_gn, cuda_conv and
   int8w_dense, two ControlNets with a list of scales, ``control_scale=0``
   (the bytes without control); a rank-``ADAPTER_RANK`` LoRA over every
   attention projection, feed-forward product, proj_in/proj_out and the
   text tower, written by the port's writers as a kohya file and an
   ``.npz`` and loaded by ``Context.load_lora``, each under cuda,
   cuda_conv, int8w_dense and calibrated int8 with ``KERNEL_W8A8``; the
   same LoRA with every ResBlock conv too (a "LoCon" kohya file) under
   cuda_conv, each adapted conv the fused conv kernel's twice (the base
   and the delta's down conv); ``lora=""`` (the base's bytes). Every arm with ``ADAPTER_PINNED``
   (derived on the meta device by tests/test_torch_hopper.py), the same
   bytes from the same seed, finite latents; the UNet with each adapter
   against float32 under each policy (within ``MODEL_FACTOR`` of the plain
   bf16 path's error; the quantized LoRA'd UNets under
   ``QUANT_REL_ERR_MAX``); s/image and device busy ms of one ControlNet
   and of the LoRA against none, in turns; K1-K5 at the most-launched
   site the adapters bring (``kernel_adapters_*``). After the stages, SDXL
   at 1024x1024 with one ControlNet at ``ADAPTER_XL_STEPS`` steps under
   cuda, one call, with its pins.
20. serving, after the adapters phase, on its Context: the serving
   infrastructure on SD1.5 at full width, ``SERVING_STEPS`` steps: the
   HTTP service (``engine.server.serve`` on an ephemeral port, max_batch
   4): /healthz with the reference's keys and the card as its backend;
   four concurrent /generate requests held by the device lock until the
   micro-batcher has taken them as one batch of 4, under cuda and under
   cuda_conv, each PNG ``generate_batch``'s bytes for the same four
   requests; one /img2img at strength 0.6 (``img2img``'s bytes); two
   malformed bodies with the reference's 400 texts; the stream pool
   (``engine.stream.StreamScheduler``, 4 slots, 8 and 4 steps) driven tick
   by tick through ``STREAM_REQUESTS``, two of them admitted mid-flight:
   ticks and decode batches as planned, each request's latents against
   the float32 single path within ``BATCH_GAP_FACTOR`` times its own bf16
   gap, the largest uint8 difference from ``generate`` recorded; the same
   six through the pool and through the micro-batcher in turns (s/image,
   latency p50/p95); the stream server over HTTP with a /preview; the CLI
   (``sdtpu_torch.cli generate`` in-process and as ``python -m``, both
   ``generate``'s bytes; ``info`` names the card); the C API built with
   g++ on the host, loaded here, ``sdtpu_setup("sd15", 8, use_tpu=1)`` on
   the card and ``sdtpu_generate_image`` (``generate``'s bytes). Every arm
   with ``SERVING_PINNED`` (the stream server's from its ticks and
   decodes); s/image, device busy ms; then kernel_serving: K1 at the
   pool's N = 8 and the decodes of 1 to 4 slots against its plain version.
21. train, after the breakdowns, with the four SD1.5 inference Contexts
   released (the step's peak memory is its own): K1-bwd
   (``flash_attn_bwd.cu``, wgmma) against its plain version at the
   training sites (SD1.5's 64x64 and 32x32 self-attention at batch 2, d =
   64) and ragged shapes of its contract, each of dq, dk, dv within
   ``KERNEL_TOL``, the same bytes twice, its plan, design, registers and
   spills, device ms and TFLOP/s beside the bound, the plain version and
   SDPA's backward; then SD1.5
   at full width, 512^2, demo weights, float32 masters, bf16 compute, batch
   2, through ``train.make_train_step``: one step's gradients from the same
   draws under cuda and plain, remat off and on, each against a float32
   plain step (cuda within ``MODEL_FACTOR`` of the plain bf16 error, remat
   within it of no remat), s/step in turns, peak memory, device busy ms and
   kernels a step, every step's K1 and K1-bwd launches at
   ``TRAIN_PINNED``; two runs of ``TRAIN_STEPS`` from one seed with the
   same bytes of params, moments and EMA; the images path (the encoder in
   the loss); ``TRAIN_STEPS`` of the LoRA optimizer at rank 16 (only the
   adapters move); the CLI: ``train --ema`` as ``python -m``,
   ``--resume``, ``--data`` over two ``.npz`` shards and over an image
   folder, each state read back.
22. bench, after the breakdowns and before the SD1.5 Contexts are
   released: the port's measurement tools at SD1.5's full width on the
   demo weights. ``bench.runner.benchmark_parts`` (3 warm-up calls, 10
   timed) under cuda, cuda_gn and cuda_conv: each part's median and p99
   host ms, device ms (CUDA events around the call), FLOPs
   (``bench.flops.count_flops``), TFLOP/s and MFU against the card's bf16
   peak; any part's ``.error`` fails the run. ``bench.xprof.profile_ops``
   over one UNet eval under each policy: each hand-written kernel's main
   launches at ``EVAL_PINNED`` (K1 10; K2 61 under cuda_gn; K3 and K2's
   statistics mode 60 under cuda_conv), sum passes beside them, the class
   totals and the top 10. ``tools/attr_mma.py`` over one UNet eval under
   cuda_conv: its FLOPs within ``ATTR_FLOPS_TOL`` of ``count_flops``, the
   10 shapes with the most device ms. ``bench.profile.phase_timings`` (20
   steps, cuda). The CLI's ``bench``, ``analyze``, ``profile`` and
   ``sweep --quick`` in process, each returning 0. CLIP score of two
   images against their prompts with a ViT-L/14 vision tower and a text
   projection made from a seed in float32 and the Context's text tower:
   scores in [0, 100], cosines within ``CLIP_COS_TOL`` of the same towers
   on the CPU, ms an image. ``quantize="int8w_dense"`` under cuda_conv:
   one image with ``PINNED["int8w_dense_conv"]``, the same bytes from the
   same seed, its K3 sites against ``kernel_conv``'s int8 rows, device busy
   ms beside int8w_dense under cuda.

Kernel times are device times: CUDA-event time of CUDA-graph replays
(``cuda_ms``), so the host's launch cost is not in them.

Every kernel's row carries its bound: the least time the card could take
for the same call, the larger of its bytes (each input read once, each
output written once) over the memory rate and its operations over the peak
rate for their type (``bound``).

Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Any failure ends the run with a non-zero exit and no last line.
Without a CUDA card it exits non-zero before printing anything.
"""

from __future__ import annotations

import base64
import contextlib
import ctypes
import gc
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

PROMPT = "a photograph of an astronaut riding a horse"
# K1: max-abs error against the float32 plain version, relative to its
# max-abs. The bf16 output (2^-9 relative) and bf16 P in P.V leave it near
# 2^-8; with randn inputs a value of the output is a mean over about sk / e
# keys, so a dropped key tile, a P rounded coarser than bf16 or a scale some
# per cent off moves it by more than this
KERNEL_TOL = 2.0 ** -6
# K2, K3: max-abs error against the float32 plain version, relative to its
# max-abs: one bf16 rounding of the output (2^-9), and for K3 of the
# prologue's output too, the product operand
FUSED_TOL = 1e-2
# K2's statistics mode against gn_affine's plain version: both float32,
# sums in another order
AFFINE_TOL = 1e-4
# K5 against its plain version: exact int32 sums and single float32
# operations on both sides, so the float32 values agree before the final
# cast: at most one bf16 ulp (2^-7 relative) after it
W8A8_TOL = 2.0 ** -7
MODEL_FACTOR = 2.0      # see phase_model
# the quantized UNet against float32, and an image's PSNR against the
# unquantized one: random weights, so only garbage is caught
QUANT_REL_ERR_MAX = 0.5
QUANT_PSNR_MIN_DB = 6.0
POLICIES = ("plain", "cuda", "cuda_gn", "cuda_conv")
# the H100 SXM's published dense peaks and memory rate (NVIDIA's data sheet)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
CALIB_PROMPTS = ["a photograph of an astronaut riding a horse",
                 "a watercolor of a lighthouse at dusk"]
# (batch, seq, channels, heads): UNet 64x64 and 32x32 self-attention at the
# CFG batch of 2, the VAE mid block, and d=64 (SD2/SDXL) as a look ahead
SHAPES = [(2, 4096, 320, 8), (2, 1024, 640, 8), (1, 4096, 512, 1),
          (2, 4096, 512, 8)]
# K1 off the main path, (batch, sq, sk, channels, heads): a ragged sk under
# 4096 queries, sq != sk both ways, a single 128-row tile, d = 8, 128, 256
# and 144 (padded to 256), the split design with ragged sq
FLASH_RAGGED = [(2, 4096, 1000, 320, 8), (2, 1024, 4096, 640, 8),
                (1, 128, 128, 40, 1), (2, 1024, 1024, 64, 8),
                (2, 1024, 1024, 1024, 8), (1, 1024, 1024, 256, 1),
                (1, 200, 136, 144, 1), (1, 1000, 4096, 512, 1)]
# exponentials a second: 16 a clock on each of the 132 SMs' special-function
# units, at the clock the published 989 TFLOP/s implies (4096 bf16 FLOP a
# clock an SM): 1.829 GHz
PEAK_EXP = 132 * 16 * (989e12 / (132 * 4096))
STEPS = 20
# the float32 scores K1's plain version may hold at once (``flash_plain``)
PLAIN_SCORES_BYTES = 2 ** 31
# launches per image of each kernel under each policy:
#   flash: 5 self-attentions at 64x64 + 5 at 32x32 per UNet eval, 20 evals,
#     plus the VAE mid block, under every cuda* policy;
#   group_norm: 61 GroupNorms per UNet eval (22 ResBlocks x 2, 16
#     transformer norms, out_norm), 20 evals; the VAE keeps the plain one;
#   conv: 60 fused convs per UNet eval (22 ResBlocks x 2, 16 proj_in), 20
#     evals, plus 14 VAE ResBlocks x 2; each with one launch of the
#     GroupNorm kernel's statistics mode for its prologue (gn_affine)
# under quantization (the UNet only; SD1.5 has 16 transformer blocks, 5 each
# at 64x64, 32x32, 16x16 and 1 at 8x8, of 10 dense sites each, of which
# attn2's k and v see the 154 rows of the text context; 16 proj_in, 16
# proj_out and 14 skip 1x1 convs; 22 ResBlock emb dense of 2 rows):
#   int8w_dense, kernels cuda: K4 at every dense site and 1x1 conv of the
#     UNet, 160 + 22 + 46 = 228 per eval (the reference's own gate would
#     leave out the 32 + 22 sites of 154 and 2 rows: 174);
#   int8w, kernels cuda_conv: K3 reads int8 weights at its 60 UNet sites
#     (the VAE's 28 stay bf16), and the 1x1 convs it does not fuse, 16
#     proj_out + 14 skip, go to K4;
#   int8, calibrated, KERNEL_W8A8 on: K5 where n >= m: every site of the 5
#     blocks at 16x16 and the one at 8x8 (60), ff1 at 32x32 (5), and attn2's
#     k and v at 64x64 and 32x32 (20; the reference's gate leaves the
#     154-row sites out, 53 in all): 85 per eval. With the flag off, none.
FLASH_PER_IMAGE = (5 + 5) * STEPS + 1
CONV_PER_IMAGE = 60 * STEPS + 14 * 2
MM_INT8W_PER_EVAL = 160 + 22 + 46
# of them the sites that split K on the H100's 132 SMs, where the sum pass
# is a second kernel after K4's (matmul_int8w counts a call once): every
# site of 512 and 128 rows but ff1, attn2's k and v at every level, the skip
# convs of 512 and 128 rows; and of int8w's 16 proj_out + 14 skip convs
MM_INT8W_SUMS_PER_EVAL = 93
MM_INT8W_SUMS_PER_EVAL_CONVS = 13
# int8w_dense under cuda_conv: K3 takes the 60 ResBlock convs and proj_in
# 1x1 convs an eval with int8 weights (the VAE's 28 stay bf16), K4 the 228
# sites less the 16 proj_in: 212, of which 87 split K (93 less the 6
# proj_in that do) (tests/test_torch_hopper.py::
# test_int8w_dense_conv_pins_are_the_rules)
MM_INT8W_PER_EVAL_CONV = MM_INT8W_PER_EVAL - 16
MM_INT8W_SUMS_PER_EVAL_CONV = 87
MM_W8A8_PER_EVAL = 60 + 5 + 20
# of them the sites that split K (K5's steps are 128 deep): every site of
# 512 and 128 rows but ff1 (54), and attn2's k and v at 64x64 and 32x32 (20)
MM_W8A8_SUMS_PER_EVAL = 54 + 20
# batched serving: generate_batch of 3 requests, padded to 4, runs one UNet
# eval at N = 8 a step and one VAE decode at N = 4. Its launches per call are
# one image's, but where a rule reads M: at N = 8 K5's n >= m routing keeps
# 35 of the 160 transformer sites (85 at N = 2), of which 29 split K (74),
# and 44 of K4's 228 sites split K (93)
# (tests/test_torch_hopper.py::test_batch_pins_are_the_rules)
BATCH = 4
MM_INT8W_SUMS_PER_EVAL_B4 = 44
MM_W8A8_PER_EVAL_B4 = 35
MM_W8A8_SUMS_PER_EVAL_B4 = 29
KERNEL_NAMES = ("flash", "group_norm", "group_norm_affine", "conv",
                "conv_int8", "matmul_int8w", "matmul_int8w_sum",
                "matmul_w8a8", "matmul_w8a8_sum")


def pins(**launches):
    return {**dict.fromkeys(KERNEL_NAMES, 0), "flash": FLASH_PER_IMAGE,
            **launches}


PINNED = {
    "cuda": pins(),
    "cuda_gn": pins(group_norm=61 * STEPS),
    "cuda_conv": pins(group_norm_affine=CONV_PER_IMAGE, conv=CONV_PER_IMAGE),
    "int8w_dense": pins(matmul_int8w=MM_INT8W_PER_EVAL * STEPS,
                        matmul_int8w_sum=MM_INT8W_SUMS_PER_EVAL * STEPS),
    "int8w": pins(group_norm_affine=CONV_PER_IMAGE, conv=CONV_PER_IMAGE,
                  conv_int8=60 * STEPS, matmul_int8w=(16 + 14) * STEPS,
                  matmul_int8w_sum=MM_INT8W_SUMS_PER_EVAL_CONVS * STEPS),
    "int8": pins(),
    "int8+k5": pins(matmul_w8a8=MM_W8A8_PER_EVAL * STEPS,
                    matmul_w8a8_sum=MM_W8A8_SUMS_PER_EVAL * STEPS),
    "int8w_dense_conv": pins(
        group_norm_affine=CONV_PER_IMAGE, conv=CONV_PER_IMAGE,
        conv_int8=60 * STEPS, matmul_int8w=MM_INT8W_PER_EVAL_CONV * STEPS,
        matmul_int8w_sum=MM_INT8W_SUMS_PER_EVAL_CONV * STEPS),
}
BATCH_PINNED = {
    "cuda": PINNED["cuda"], "cuda_gn": PINNED["cuda_gn"],
    "cuda_conv": PINNED["cuda_conv"],
    "int8w_dense": pins(
        matmul_int8w=MM_INT8W_PER_EVAL * STEPS,
        matmul_int8w_sum=MM_INT8W_SUMS_PER_EVAL_B4 * STEPS),
    "int8+k5": pins(matmul_w8a8=MM_W8A8_PER_EVAL_B4 * STEPS,
                    matmul_w8a8_sum=MM_W8A8_SUMS_PER_EVAL_B4 * STEPS),
}
# the families phase (sd21 768x768 v-prediction, sd21base 512x512, sdxl
# 1024x1024), 20 steps, batch 1: launches per image of each kernel under
# each mode, derived from the rules at every site of the full-width UNet
# and VAE (tests/test_torch_hopper.py::test_family_pins_are_the_rules):
#   flash: SDXL 10 self-attentions at 64x64 (d 64, 10 heads) and 60 at 32x32
#     (the depth-10 level, with the mid block; 20 heads) an eval, SD 2.x 5 at
#     the first level and 5 at the second (the 24^2 and 12^2 levels, 576 and
#     144 tokens, take the plain path by the sequence clause), plus the VAE's
#     mid block, under every cuda* policy;
#   group_norm: SDXL 46 (17 ResBlocks x 2, 11 transformer norms, out_norm)
#     an eval; conv and its statistics mode: SDXL 45 (34 + 11 proj_in) an
#     eval plus the VAE's 28; SD 2.x as SD1.5 (61; 60 + 28);
#   int8w_dense: K4 at SDXL's 700 transformer dense sites (70 basic blocks),
#     22 proj 1x1 convs, 11 skip convs and 17 emb dense: 750 an eval, of
#     which 140 split K; SD 2.x 228, as SD1.5;
#   int8 + K5: the n >= m sites: SDXL ff1 (N = 10,240 >= M = 2,048) and
#     attn2 k, v (154 rows) of the 60 blocks at 32x32, attn2 k, v of the 10
#     at 64x64: 200 an eval, of which 140 split K
FAMILY_STEPS = STEPS


def family_pins(flash, **launches):
    return {**dict.fromkeys(KERNEL_NAMES, 0), "flash": flash, **launches}


FLASH_XL = 70 * FAMILY_STEPS + 1
FLASH_SD2 = 10 * FAMILY_STEPS + 1
FAMILY_PINNED = {
    "sdxl": {
        "plain": family_pins(0),
        "cuda": family_pins(FLASH_XL),
        "cuda_gn": family_pins(FLASH_XL, group_norm=46 * FAMILY_STEPS),
        "cuda_conv": family_pins(FLASH_XL,
                                 group_norm_affine=45 * FAMILY_STEPS + 28,
                                 conv=45 * FAMILY_STEPS + 28),
        "int8w_dense": family_pins(FLASH_XL,
                                   matmul_int8w=750 * FAMILY_STEPS,
                                   matmul_int8w_sum=140 * FAMILY_STEPS),
        "int8+k5": family_pins(FLASH_XL, matmul_w8a8=200 * FAMILY_STEPS,
                               matmul_w8a8_sum=140 * FAMILY_STEPS)},
    "sd21": {
        "cuda": family_pins(FLASH_SD2),
        "cuda_conv": family_pins(FLASH_SD2, group_norm_affine=CONV_PER_IMAGE,
                                 conv=CONV_PER_IMAGE),
        "heun": family_pins(10 * 2 * FAMILY_STEPS + 1),
        # the sites phase's: the kernel rows at SD 2.1's K2, K4 and K5 sites
        "cuda_gn": family_pins(FLASH_SD2, group_norm=61 * FAMILY_STEPS),
        "int8w_dense": family_pins(FLASH_SD2,
                                   matmul_int8w=MM_INT8W_PER_EVAL * STEPS,
                                   matmul_int8w_sum=44 * FAMILY_STEPS),
        "int8+k5": family_pins(FLASH_SD2,
                               matmul_w8a8=MM_W8A8_PER_EVAL * STEPS,
                               matmul_w8a8_sum=39 * FAMILY_STEPS)},
    "sd21base": {"cuda": family_pins(FLASH_SD2)},
}
# the image and concat phases: image-conditioned calls at full width, 20
# DPM-Solver++(2M) steps (4 for sd21_inpaint and sdxl_inpaint), launches per
# call of each kernel under each mode, derived from the rules at every site
# of the UNet, the VAE decoder and its encoder
# (tests/test_torch_hopper.py::test_image_pins_are_the_rules). A warm start
# of strength s runs steps - round(steps (1 - s)) UNet evals: img2img at
# 0.6 12, depth2img at 0.8 16, the hires pass at 0.6 12; inpaint and ip2p at
# 1.0 run all 20. Each call encodes one image (an inpaint at strength 1.0
# only the masked one) and decodes one; the hires fix decodes once, at
# 1024^2:
#   flash: 10 an SD1.5 eval at any batch (ip2p's three CFG slots are one
#     UNet batch of 3), 15 an eval of the hires pass (at its 128^2 grid the
#     16,384-, 4,096- and 1,024-token levels all take the kernel), SD 2.x 10
#     and SDXL 70 an eval, and the encoder's and the decoder's mid blocks;
#   group_norm (cuda_gn): 61 an SD1.5 eval; the VAE's stay plain;
#   conv and its statistics mode (cuda_conv): 60 an SD1.5 eval, the
#     decoder's 28 and the encoder's 20 (8 down blocks and 2 mid blocks x 2);
#     conv_in and the downsample convs stay cuDNN convs;
#   int8w_dense: K4's 228 sites an eval, 93 of them split K, as at B = 1
IMAGE_STEPS_XL = 4
IMAGE_EVALS = 12
DEPTH_EVALS = 16
FLASH_IMAGE = 10 * IMAGE_EVALS + 2
FLASH_FULL = 10 * STEPS + 2
CONV_ENCODER = 20
IMAGE_PINNED = {
    "img2img": {
        "cuda": pins(flash=FLASH_IMAGE),
        "cuda_gn": pins(flash=FLASH_IMAGE, group_norm=61 * IMAGE_EVALS),
        "cuda_conv": pins(
            flash=FLASH_IMAGE,
            group_norm_affine=60 * IMAGE_EVALS + 28 + CONV_ENCODER,
            conv=60 * IMAGE_EVALS + 28 + CONV_ENCODER),
        "int8w_dense": pins(flash=FLASH_IMAGE,
                            matmul_int8w=MM_INT8W_PER_EVAL * IMAGE_EVALS,
                            matmul_int8w_sum=MM_INT8W_SUMS_PER_EVAL
                            * IMAGE_EVALS)},
    "inpaint": {"cuda": pins(flash=FLASH_FULL)},
    "hires": {"cuda": pins(flash=10 * STEPS + 15 * IMAGE_EVALS + 1)},
    "sd15_inpaint": {
        "cuda": pins(flash=FLASH_FULL),
        "cuda_conv": pins(flash=FLASH_FULL,
                          group_norm_affine=CONV_PER_IMAGE + CONV_ENCODER,
                          conv=CONV_PER_IMAGE + CONV_ENCODER)},
    "sd15_ip2p": {
        "cuda": pins(flash=FLASH_FULL),
        "cuda_conv": pins(flash=FLASH_FULL,
                          group_norm_affine=CONV_PER_IMAGE + CONV_ENCODER,
                          conv=CONV_PER_IMAGE + CONV_ENCODER)},
    "sd2_depth": {"cuda": pins(flash=10 * DEPTH_EVALS + 2)},
    "sd21_inpaint": {"cuda": pins(flash=10 * IMAGE_STEPS_XL + 2)},
    "sdxl_inpaint": {"cuda": pins(flash=70 * IMAGE_STEPS_XL + 2)},
}
# the stages phase: the staged configurations at full width, launches per
# call of each kernel under each mode the phase takes, derived from the
# rules at every site of the UNet evals and the decode the call makes
# (tests/test_torch_hopper.py::test_stage_pins_are_the_rules):
#   sd15_lcm at LCM_STEPS lcm steps with the guidance embedded: one UNet row
#     a request (SD1.5's sites at N = 1, or N = 4 for the batch of three
#     padded to four), SD1.5's kernel counts an eval;
#   the two-stage call at STAGE_STEPS steps split at STAGE_END: sdxl's first
#     STAGE_SPLIT steps with latent output (no decode), then sdxl_refiner's
#     last ones and its decode;
#   sd_x4 at STAGE_STEPS steps on a 128^2 image -> 512^2: its UNet runs no
#     K1 (cross-only attn1 at levels 1 and 2, 256 tokens at level 3 and the
#     mid block); its f4 VAE's mid block at 16,384 tokens does
LCM_STEPS = 4
STAGE_STEPS = 10
STAGE_END = 0.8
STAGE_SPLIT = round(STAGE_STEPS * STAGE_END)
#: call -> (configuration, UNet batch, UNet evals, decodes)
STAGE_CALLS = {
    "lcm": ("sd15_lcm", 1, LCM_STEPS, True),
    "lcm_batch": ("sd15_lcm", 4, LCM_STEPS, True),
    "base": ("sdxl", 2, STAGE_SPLIT, False),
    "refine": ("sdxl_refiner", 2, STAGE_STEPS - STAGE_SPLIT, True),
    "x4": ("sd_x4", 2, STAGE_STEPS, True),
}
#   cuda_conv: SD1.5's 60 fused convs an eval and its decoder's 28; SDXL's
#     45 an eval; the refiner's 55 (22 ResBlocks x 2, 11 proj_in) and the
#     SDXL decoder's 28; x4's 60 (22 ResBlocks x 2, 16 proj_in) and the f4
#     decoder's 22 (11 ResBlocks x 2);
#   int8w_dense: K4 at SDXL's 750 sites an eval (140 split K), the
#     refiner's 498 (121), x4's 228 (148)
STAGES_PINNED = {
    "lcm": {"cuda": pins(flash=10 * LCM_STEPS + 1),
            "cuda_conv": pins(flash=10 * LCM_STEPS + 1,
                              group_norm_affine=60 * LCM_STEPS + 28,
                              conv=60 * LCM_STEPS + 28)},
    "base": {"cuda": pins(flash=70 * STAGE_SPLIT),
             "cuda_conv": pins(flash=70 * STAGE_SPLIT,
                               group_norm_affine=45 * STAGE_SPLIT,
                               conv=45 * STAGE_SPLIT),
             "int8w_dense": pins(flash=70 * STAGE_SPLIT,
                                 matmul_int8w=750 * STAGE_SPLIT,
                                 matmul_int8w_sum=140 * STAGE_SPLIT)},
    "refine": {"cuda": pins(flash=40 * (STAGE_STEPS - STAGE_SPLIT) + 1),
               "cuda_conv": pins(
                   flash=40 * (STAGE_STEPS - STAGE_SPLIT) + 1,
                   group_norm_affine=55 * (STAGE_STEPS - STAGE_SPLIT) + 28,
                   conv=55 * (STAGE_STEPS - STAGE_SPLIT) + 28),
               "int8w_dense": pins(
                   flash=40 * (STAGE_STEPS - STAGE_SPLIT) + 1,
                   matmul_int8w=498 * (STAGE_STEPS - STAGE_SPLIT),
                   matmul_int8w_sum=121 * (STAGE_STEPS - STAGE_SPLIT))},
    "x4": {"cuda": pins(flash=1),
           "cuda_conv": pins(flash=1, group_norm_affine=60 * STAGE_STEPS + 22,
                             conv=60 * STAGE_STEPS + 22),
           "int8w_dense": pins(flash=1, matmul_int8w=228 * STAGE_STEPS,
                               matmul_int8w_sum=148 * STAGE_STEPS)},
}
# a batch's launches per call are one call's
STAGES_PINNED["lcm_batch"] = STAGES_PINNED["lcm"]
# the samplers phase, under cuda: UNet evals per image (K1 launches 10 times
# an eval, and once in the VAE): one a step, two on plms_exact's first step,
# two a step for heun
SAMPLER_EVALS = {"ddim": STEPS, "plms_exact": STEPS + 1, "euler_a": STEPS,
                 "lms": STEPS, "dpm_sde": STEPS, "unipc": STEPS,
                 "heun": 2 * STEPS, "dpm_karras": STEPS}
# three requests with their own seed, guidance (one of 1.0: its uncond half
# mixes in with weight 0) and negative prompt; the third's attention syntax
# takes the batch down the weighted text path. The batch phase times four
# distinct ones (no padding) against one
BATCH_REQUESTS = [
    {"prompt": PROMPT, "seed": 31, "guidance": 7.5},
    {"prompt": "a watercolor of a lighthouse at dusk", "seed": 32,
     "guidance": 1.0, "negative_prompt": "blurry"},
    {"prompt": "a (red:1.3) vintage car on a coastal road", "seed": 33,
     "guidance": 4.0, "negative_prompt": "low quality, [grainy]"}]
BATCH_TIMED = BATCH_REQUESTS + [
    {"prompt": "a bowl of fruit on a wooden table", "seed": 34,
     "guidance": 7.5}]
# a request's latents in the batch against the same request run alone,
# relative to the float32 run's max-abs, may differ by at most this factor
# times that request's own gap between bf16 alone (cuda) and float32. Both
# gaps are rounding grown over 20 steps: a batch runs other bf16 sums (and
# under int8 + K5 other routes, n >= m reading M), which the trajectory
# amplifies to the order of bf16 itself (0.72-1.16x under cuda, up to 1.95x
# under int8 + K5 on an H100), so the factor is the one the model phase
# holds every bf16 path to; a request mixed up with a batch-mate (its seed,
# guidance or negative prompt) is off by O(1)
BATCH_GAP_FACTOR = MODEL_FACTOR
# K2 and K3 at shapes off the main path: odd planes, C/G not a multiple of
# 8 (or of 2), Cout not a multiple of the 128 tile, int8 weights. K2's: C %
# 8 != 0 (4- and 2-byte vectors), a 16-block cluster with a short last run,
# each span class (C/G = 10, 20, 30, 40, 60, 80) on an odd plane, and two
# planes no cluster holds (the streamed variant: the VAE's 512^2 x 128 and
# 256^2 x 512)
GN_RAGGED = [(2, 77, 30, 3, 1e-5, True), (1, 5, 9, 3, 1e-6, False),
             (2, 1023, 960, 32, 1e-5, True)] + [
    (1, 999, c, 32, 1e-5, True) for c in (320, 640, 960, 1280, 1920, 2560)
] + [(1, 262144, 128, 32, 1e-6, False), (1, 65536, 512, 32, 1e-6, True)]
# (x shape, c_out, k, prologue, int8, the kernel the static rule must
# choose). The general kernel's classes: a plane whose rows do not tile 128
# pixels, Cin not a multiple of 64, both. The slab kernel: a tile that
# spans two samples and ends in a ragged one, a 128-pixel run of a row at W
# = 128 and 256 with Cout not a multiple of the tile, one Cin chunk and 30
# of them split over blocks, eight 4x4 planes a tile, 1x1 sites with one
# and with a ragged last chunk of three 64-channel groups
CONV_RAGGED = [((2, 63, 65, 64), 100, 3, "silu", False, "general"),
               ((2, 5, 3, 16), 13, 3, None, False, "general"),
               ((1, 7, 9, 24), 40, 3, "silu", True, "general"),
               ((2, 32, 32, 640), 640, 3, "silu", True, "slab"),
               ((2, 9, 11, 40), 72, 1, "affine", False, "general"),
               ((2, 16, 16, 40), 72, 3, "silu", True, "general"),
               ((2, 6, 32, 64), 72, 3, "silu", False, "general"),
               ((3, 8, 8, 64), 100, 3, "silu", False, "slab"),
               ((3, 8, 8, 64), 100, 3, "silu", True, "slab"),
               ((1, 8, 128, 64), 72, 3, "silu", False, "slab"),
               ((1, 8, 128, 64), 72, 3, "silu", True, "slab"),
               ((1, 4, 256, 128), 200, 3, "affine", False, "slab"),
               ((1, 4, 256, 128), 200, 3, None, True, "slab"),
               ((2, 16, 16, 1920), 100, 3, "silu", False, "slab"),
               ((2, 16, 16, 1920), 100, 3, "silu", True, "slab"),
               ((5, 4, 4, 64), 64, 3, "silu", False, "slab"),
               ((2, 16, 16, 128), 136, 1, "affine", False, "slab"),
               ((2, 16, 16, 320), 136, 1, "affine", True, "slab"),
               ((2, 8, 8, 1280), 1280, 1, "silu", False, "slab")]
# where K3's time without the prologue is taken too
CONV_PROBED = {((2, 64, 64, 320), 320, 3), ((2, 16, 16, 1280), 1280, 3),
               ((2, 8, 8, 1280), 1280, 3)}
# K4 and K5 off the main path, (m, k, n, bias): a 64-deep step's K tail
# (336 = 5 x 64 + 16), N not a multiple of 8 and odd, a single row, one
# 16-deep step, no bias, one 128-deep step and a tail (144), split-K with
# ragged M
MM_RAGGED = [(300, 336, 130, True), (100, 48, 72, False), (33, 16, 7, True),
             (1, 1280, 320, False), (129, 320, 129, True),
             (64, 144, 256, True), (154, 768, 1280, False)]


START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line on stdout; the seconds since the start and the phase on
    stderr, where a run's time goes."""
    print(json.dumps(obj), flush=True)
    print(f"[{time.perf_counter() - START:7.1f} s] {obj.get('phase')}",
          file=sys.stderr, flush=True)


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


def bound(ops: float, kind: str, nbytes: float):
    """(bound_ms, bound_by): the least time the card could take for a call
    of ``ops`` operations of type ``kind`` that must move ``nbytes``."""
    by_ops = ops / PEAK_OPS[kind] * 1e3
    by_bytes = nbytes / PEAK_BYTES * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops > by_bytes
                                   else "bytes")


def _counters():
    from sdtpu_torch.ops import attention as A
    from sdtpu_torch.ops import conv as C
    from sdtpu_torch.ops import groupnorm as G
    from sdtpu_torch.ops import matmul as MM

    return {"flash": (A.flash_attention_cuda, "launches"),
            "group_norm": (G.group_norm_cuda, "launches"),
            "group_norm_affine": (G.group_norm_affine_cuda, "launches"),
            "conv": (C.fused_conv_cuda, "launches"),
            "conv_int8": (C.fused_conv_cuda, "launches_int8"),
            "matmul_int8w": (MM.matmul_int8w_cuda, "launches"),
            "matmul_int8w_sum": (MM.matmul_int8w_cuda, "sum_launches"),
            "matmul_w8a8": (MM.matmul_w8a8_cuda, "launches"),
            "matmul_w8a8_sum": (MM.matmul_w8a8_cuda, "sum_launches")}


def counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def reset_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


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


WGMMA_SOURCES = ("flash_attn_fwd.cu", "flash_attn_bwd.cu", "conv_gn_silu.cu",
                 "matmul_int8w.cu", "matmul_w8a8.cu")


def phase_build():
    """Build and load the kernels; beside the build, ``nvcc -Xptxas -v`` on
    the wgmma kernels' sources (K1, K1-bwd, K3, K4, K5), none of which may
    spill. Returns the reports by source."""
    from concurrent.futures import ThreadPoolExecutor

    from sdtpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.library_path()
    fresh = not path.exists()
    names = WGMMA_SOURCES
    with ThreadPoolExecutor(len(names)) as pool:
        reports = [pool.submit(_build.ptxas_report, _build.SRC_DIR / n)
                   for n in names]
        _build.library()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "built": fresh, "sources": [s.name for s in _build.sources()],
              "headers": [h.name for h in _build.headers()],
              "library": str(path.relative_to(_build.PKG_DIR))})
        reports = [r.result() for r in reports]
    for name, report in zip(names, reports):
        emit({"phase": "resources", "source": name, "kernels": report})
        if not report or any(r["spill_store_bytes"] for r in report):
            raise AssertionError(f"{name}: a kernel spills: {report}")
    return dict(zip(names, reports))


def flash_plain_chunks(b, sq, sk, heads):
    """How many calls ``flash_plain`` splits a problem into."""
    per = max(1, PLAIN_SCORES_BYTES // (sq * sk * 4))
    return 1 if b * heads <= per else b * -(-heads // per)


def flash_plain(q, k, v, heads):
    """K1's plain version on [B, T, C] tensors. Where its float32 scores for
    all batch-heads would pass ``PLAIN_SCORES_BYTES`` (the hires pass's
    [2, 16384, 320] over 8 heads: 17 GB), it runs one sample's heads in
    groups that fit and concatenates the outputs: every head of every
    sample is computed, each by the same arithmetic as in one call."""
    from sdtpu_torch.ops import attention as A

    b, sq, c = q.shape
    sk, d = k.shape[1], c // heads
    per = max(1, PLAIN_SCORES_BYTES // (sq * sk * 4))
    if b * heads <= per:
        return A.flash_attention_reference(q, k, v, heads)
    out = []
    for i in range(b):
        cols = []
        for h0 in range(0, heads, per):
            cs = slice(h0 * d, min(heads, h0 + per) * d)
            cols.append(A.flash_attention_reference(
                q[i:i + 1, :, cs], k[i:i + 1, :, cs], v[i:i + 1, :, cs],
                min(heads, h0 + per) - h0))
        out.append(torch.cat(cols, dim=-1))
    return torch.cat(out, dim=0)


def phase_kernel(shapes=SHAPES, ragged=FLASH_RAGGED, label="kernel",
                 per_image=None):
    """K1 at the main path's shapes, then at ``FLASH_RAGGED`` (there without
    the plain version's time). Each phase line also carries the tile the
    wrapper's static rule chose and ``exp_bound_ms``, the time the softmax's
    exponentials alone need on the special-function units (derived, not
    measured, so it stays out of the ``kernels`` line). ``shapes`` and
    ``label``: the batch phase's shapes (N = 8, the VAE's 4), or a family's
    (``per_image``: launches per image of each shape, put in its row)."""
    from sdtpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    cases = [(b, s, s, c, h, True) for b, s, c, h in shapes]
    cases += [(*case, False) for case in ragged]
    for b, sq, sk, c, heads, main in cases:
        d = c // heads
        q = torch.randn((b, sq, c), generator=g, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn((b, sk, c), generator=g, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        out = A.flash_attention_cuda(q, k, v, heads)
        torch.cuda.synchronize()
        ref = flash_plain(q.float(), k.float(), v.float(), heads)
        err = (out.float() - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        del ref
        ms = cuda_ms(lambda: A.flash_attention_cuda(q, k, v, heads))
        # the one PyTorch call that computes the same function, as a
        # yardstick only: the port never calls it
        qh, kh, vh = (t.view(b, t.shape[1], heads, d).transpose(1, 2)
                      for t in (q, k, v))
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh))
        flop = 4.0 * b * sq * sk * c
        bound_ms, bound_by = bound(
            flop, "bf16", 2 * (q.numel() + k.numel()) * 2)
        dpad, block_rows, bkv = A.plan(d, sq, sk, b * heads, sms)
        # flash_attn_fwd.cu holds one design: every instantiation the rule
        # can choose is the wgmma kernel
        row = {"shape": [b, sq, c], "sk": sk, "heads": heads, "head_dim": d,
               "design": "wgmma", "max_abs_err": err, "ref_abs_max": ref_max,
               "ms": ms, "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "tflops": flop / ms / 1e9}
        if main:
            row["plain_ms"] = cuda_ms(lambda: flash_plain(q, k, v, heads))
            row["plain_chunks"] = flash_plain_chunks(b, sq, sk, heads)
            row["plain_tflops"] = flop / row["plain_ms"] / 1e9
        if per_image is not None:
            row["per_image"] = per_image.get((b, sq, c, heads), 0)
        emit({"phase": label if main else "kernel_ragged", **row,
              "dpad": dpad, "block_rows": block_rows, "keys_per_step": bkv,
              "exp_bound_ms": b * heads * sq * sk / PEAK_EXP * 1e3})
        if not err <= KERNEL_TOL * ref_max:
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
    record.launches = record.launches_int8 = record.sum_launches = 0
    setattr(module, name, record)
    try:
        yield
    finally:
        setattr(module, name, real)


def phase_sites(ctx, batch=1, pinned=PINNED, label="sites"):
    """The call shapes K1, K2 and K3 get on the main path, and how many
    times each runs per image: one UNet eval (x STEPS) and one VAE decode
    under each policy, with the wrappers' arguments logged
    (``record_sites``); for ``batch`` requests, the UNet eval at N = 2 x
    batch and the decode at N = batch (the launches per call do not
    change)."""
    from sdtpu_torch.models import unet, vae

    cfg = ctx.cfg
    g = torch.Generator(device="cuda").manual_seed(3)
    x, te, context = unet_inputs(cfg, 3, batch)
    z = torch.randn((batch, cfg.latent_size, cfg.latent_size,
                     cfg.latent_channels), generator=g, device="cuda").to(
        cfg.compute_dtype)
    sites = record_sites([
        (STEPS, lambda k: unet.apply(ctx.params["unet"], x, te, context,
                                     cfg.unet, k)),
        (1, lambda k: vae.apply(ctx.params["vae"], z, cfg.vae, k))])
    gn_sites, conv_sites = sites["group_norm"], sites["conv"]
    emit({"phase": label, "batch": batch,
          "flash_per_image": sum(sites["flash"].values()),
          "group_norm_sites": len(gn_sites),
          "group_norm_per_image": sum(gn_sites.values()),
          "conv_sites": len(conv_sites),
          "conv_per_image": sum(conv_sites.values())})
    if sum(gn_sites.values()) != pinned["cuda_gn"]["group_norm"] or sum(
            conv_sites.values()) != pinned["cuda_conv"]["conv"] or sum(
            sites["flash"].values()) != pinned["cuda"]["flash"]:
        raise AssertionError("site counts differ from the pinned counts")
    return sites


def record_sites(runs):
    """K1's, K2's and K3's call shapes in ``runs``, [(launches per image,
    run(policy)), ...]: each run under cuda (K1), cuda_gn (K2) and
    cuda_conv (K3) with the wrappers' arguments logged, keyed as
    ``phase_kernel``, ``phase_kernel_gn`` and ``phase_kernel_conv`` take
    them."""
    from sdtpu_torch.ops import attention as A
    from sdtpu_torch.ops import conv as C
    from sdtpu_torch.ops import groupnorm as G

    sites = {"flash": {}, "group_norm": {}, "conv": {}}
    for kernel, module, name, policy in (
            ("flash", A, "flash_attention_cuda", "cuda"),
            ("group_norm", G, "group_norm_cuda", "cuda_gn"),
            ("conv", C, "fused_conv_cuda", "cuda_conv")):
        for per_image, run in runs:
            log = []
            with torch.inference_mode(), recording(module, name, log):
                run(policy)
            for args, kwargs in log:
                if kernel == "flash":
                    q, heads = args[0], args[3]
                    key = (q.shape[0], q.shape[1], q.shape[2], heads)
                elif kernel == "group_norm":
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
                sites[kernel][key] = sites[kernel].get(key, 0) + per_image
    reset_counts()
    return sites


def record_mm_sites(ctx, x, te, context, per_image):
    """K4's and K5's call shapes in one UNet eval at ``x``'s shape, the
    Context's bf16 UNet quantized on the card as ``int8w_dense`` and as
    ``int8`` with a static scale at every site (``family_mm_sites``)."""
    from sdtpu_torch.models import unet
    from sdtpu_torch.ops import matmul as MM
    from sdtpu_torch.quant.ptq import quantize_unet, quantize_weights_only

    def scaled(node):
        if isinstance(node, dict):
            if "w_q" in node:
                return {**node, "x_scale": torch.tensor(0.05, device="cuda")}
            return {k: scaled(v) for k, v in node.items()}
        if isinstance(node, list):
            return [scaled(v) for v in node]
        return node

    found = {}
    for label, fn, flag, quantize in (
            ("int8w_dense", "matmul_int8w_cuda", False,
             lambda p: quantize_weights_only(p, include_dense=True)),
            ("int8+k5", "matmul_w8a8_cuda", True,
             lambda p: scaled(quantize_unet({"unet": p})["unet"]))):
        params = quantize(ctx.params["unet"])
        log = []
        with torch.inference_mode(), recording(MM, fn, log), w8a8_kernel(
                flag):
            unet.apply(params, x, te, context, ctx.cfg.unet, "cuda")
        del params
        sites = {}
        for args, _ in log:
            xx, w8 = args[0], args[1]
            key = (xx.numel() // xx.shape[-1], w8.shape[0], w8.shape[1],
                   args[-1] is not None)
            sites[key] = sites.get(key, 0) + per_image
        found[label] = sites
        torch.cuda.empty_cache()
    reset_counts()
    return found


def _gn_case(n, hw, c, g):
    x = (torch.randn((n, hw, c), generator=g, device="cuda") * 2 + 0.5).to(
        torch.bfloat16)
    p = {"scale": (torch.rand(c, generator=g, device="cuda") + 0.5).to(
             torch.bfloat16),
         "bias": torch.randn(c, generator=g, device="cuda").to(
             torch.bfloat16)}
    return x, p


def _gn_plan(n, hw, c, groups):
    """K2's plan for a call (the static rule, what the wrapper passes) and
    how many of its clusters the card holds at once."""
    from sdtpu_torch.ops import groupnorm as G

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = G.plan_gn(n, hw, c, groups, sms)
    return {**plan, "co_resident": G.co_resident(n, hw, c, groups, plan)}


def phase_kernel_gn(gn_sites, ragged=GN_RAGGED, label="kernel_gn"):
    """K2 at every main-path shape and at ragged ones, against its plain
    version in float32 on the same bf16 inputs; times of the kernel, the
    plain version (bf16 in, float32 math), the one PyTorch call that
    computes the same function (``F.group_norm`` on the NCHW view of the
    channels-last x, then ``F.silu`` at SiLU sites: ``library_ms``) and the
    cuda policy's site (bf16 ``layers.group_norm``, then SiLU). Each row
    carries the plan its static rule chose (``design``: ``resident`` or
    ``streamed``)."""
    from sdtpu_torch.models import unet
    from sdtpu_torch.ops import groupnorm as G

    g = torch.Generator(device="cuda").manual_seed(4)
    cases = [(k, n) for k, n in sorted(gn_sites.items(), key=str)]
    cases += [(k, 0) for k in ragged]
    rows = []
    for (n, hw, c, groups, eps, silu), per_image in cases:
        x, p = _gn_case(n, hw, c, g)
        out = G.group_norm_cuda(p, x, groups, eps, silu)
        torch.cuda.synchronize()
        ref = G.group_norm_reference(p, x.float(), groups, eps, silu)
        err = (out.float() - ref).abs().max().item()
        scale = ref.abs().max().item()
        del ref
        # x read and y written once; some 10 float32 operations an element
        # (two-pass statistics, the affine map, SiLU)
        bound_ms, bound_by = bound(10.0 * x.numel(), "f32",
                                   2 * x.numel() * 2 + 2 * c * 2)
        nchw = x.view(n, hw, c).permute(0, 2, 1)
        act = F.silu if silu else (lambda t: t)
        plan = _gn_plan(n, hw, c, groups)
        row = {"shape": [n, hw, c], "groups": groups, "eps": eps,
               "silu": silu, "per_image": per_image, "max_abs_err": err,
               "ref_abs_max": scale, "bound_ms": bound_ms,
               "bound_by": bound_by, "design": plan["variant"],
               "plan": plan,
               "ms": cuda_ms(lambda: G.group_norm_cuda(p, x, groups, eps,
                                                       silu)),
               "plain_ms": cuda_ms(lambda: G.group_norm_reference(
                   p, x, groups, eps, silu)),
               "library_ms": cuda_ms(lambda: act(F.group_norm(
                   nchw, groups, p["scale"], p["bias"], eps))),
               "cuda_site_ms": cuda_ms(lambda: unet._gn(
                   p, x, groups, eps, silu, "cuda"))}
        emit({"phase": label, **row})
        if not err <= FUSED_TOL * scale:
            raise AssertionError(f"group_norm kernel disagrees at {row}")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def phase_kernel_gn_affine(conv_sites, ragged=GN_RAGGED,
                           label="kernel_gn_affine",
                           pin=PINNED["cuda_conv"]["group_norm_affine"]):
    """K2's statistics mode at the GroupNorm of every fused conv site of
    the main path (the UNet's and the VAE's, launches per image summed over
    the convs that share an input shape) and at the ragged shapes, against
    ``gn_affine``'s plain version on the same bf16 inputs (both float32);
    times of the kernel, the plain version and the one PyTorch call that
    takes the same statistics (``torch.var_mean`` over the [N, hw, G, C/G]
    view: ``library_ms``)."""
    from sdtpu_torch.ops import conv as C
    from sdtpu_torch.ops import groupnorm as G

    g = torch.Generator(device="cuda").manual_seed(8)
    per_image: dict = {}
    for (shape, _, _, prologue, _), count in conv_sites.items():
        if prologue:
            n, h, w_, c = shape
            key = (n, h * w_, c, 32)
            per_image[key] = per_image.get(key, 0) + count
    cases = sorted(per_image.items())
    cases += [(k[:4], 0) for k in ragged]
    rows = []
    for (n, hw, c, groups), count in cases:
        x, p = _gn_case(n, hw, c, g)
        a, d = G.group_norm_affine_cuda(p, x, groups, 1e-5)
        torch.cuda.synchronize()
        ra, rd = C.gn_affine_reference(p, x, groups, 1e-5)
        err = max(rel_err(a, ra), rel_err(d, rd))
        # x read once, A and D written; some 6 float32 operations an
        # element (the two passes' sums)
        bound_ms, bound_by = bound(6.0 * x.numel(), "f32",
                                   x.numel() * 2 + 2 * c * 2 + 2 * n * c * 4)
        view = x.view(n, hw, groups, c // groups)
        plan = _gn_plan(n, hw, c, groups)
        row = {"shape": [n, hw, c], "groups": groups, "per_image": count,
               "max_abs_err": max((a - ra).abs().max().item(),
                                  (d - rd).abs().max().item()),
               "rel_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
               "design": plan["variant"], "plan": plan,
               "ms": cuda_ms(lambda: G.group_norm_affine_cuda(p, x, groups,
                                                              1e-5)),
               "plain_ms": cuda_ms(lambda: C.gn_affine_reference(
                   p, x, groups, 1e-5)),
               "library_ms": cuda_ms(lambda: torch.var_mean(
                   view, dim=(1, 3), correction=0))}
        emit({"phase": label, **row})
        if not err <= AFFINE_TOL:
            raise AssertionError(f"gn_affine kernel disagrees at {row}")
        rows.append(row)
        torch.cuda.empty_cache()
    if sum(r["per_image"] for r in rows) != pin:
        raise AssertionError("statistics-mode sites differ from the pins")
    return rows


def phase_kernel_conv(conv_sites, ragged=CONV_RAGGED, unet_n=2,
                      label="kernel_conv", int8=True):
    """K3 at every main-path shape (with int8 weights too at the UNet's)
    and at ragged ones, against its plain version in float32 on the same bf16 inputs (the prologue from a real
    GroupNorm of x, ``gn_affine``, which is K2's statistics mode, itself
    held against its plain version); times of the kernel, of the plain
    version, of the whole cuda_conv site (``gn_affine`` + the kernel) and of
    the cuda policy's site (bf16 GroupNorm + SiLU + cuDNN conv + bias).
    The plain version's times are taken at the main path's bf16 rows only
    (the statistics mode's in ``kernel_gn_affine``). Each row names the kernel and the tiling
    ``plan_conv`` chose; a ragged case must get the kernel it was written
    for. ``prologue_bound_ms`` is
    the time the SiLU's special-function work alone needs, one operation
    an input element (derived, not measured); ``ms_no_prologue`` the
    kernel's time on the same call without ``a`` and ``d``."""
    from sdtpu_torch.models import unet
    from sdtpu_torch.ops import conv as C
    from sdtpu_torch.ops import groupnorm as G

    g = torch.Generator(device="cuda").manual_seed(5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    main = sorted(conv_sites.items(), key=str)
    # (site, launches per image, int8 weights, launches per image under
    # quantize="int8w", which quantizes the UNet's sites: the CFG batch,
    # ``unet_n``)
    cases = [(k, n, False, 0, None) for k, n in main]
    cases += [(k, 0, True, n, None) for k, n in main
              if int8 and k[0][0] == unet_n]
    cases += [((s, co, k, pro, True), 0, q8, 0, want)
              for s, co, k, pro, q8, want in ragged]
    rows = []
    for (shape, c_out, k, prologue, per_sample), per_image, int8, \
            per_image_int8, want in cases:
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
                "affine_rel_err": max(rel_err(a, ra), rel_err(d, rd))}
            del ra, rd
        out = C.fused_conv_cuda(x, w, b, w_scale=scale, **kw)
        torch.cuda.synchronize()
        ref = C.fused_conv_reference(x.float(), w, b, w_scale=scale, **kw)
        err = (out.float() - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        del ref
        flop = 2.0 * n * h * w_ * c_out * k * k * c_in
        ms = cuda_ms(lambda: C.fused_conv_cuda(x, w, b, w_scale=scale, **kw))
        bound_ms, bound_by = bound(
            flop, "bf16", x.numel() * 2 + w.numel() * w.element_size()
            + n * h * w_ * c_out * 2 + b.numel() * 4
            + (2 * n * c_in * 4 if prologue else 0)
            + (c_out * 4 if int8 else 0))
        plan = C.plan_conv(n, h, w_, c_in, c_out, k, sms, int8)
        row = {"x": list(shape), "c_out": c_out, "k": k,
               "prologue": prologue, "int8": int8, "per_image": per_image,
               "design": plan["design"], "plan": plan,
               "per_image_int8": per_image_int8,
               "max_abs_err": err, "ref_abs_max": ref_max, "ms": ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops": flop / ms / 1e9, **affine}
        if per_image:
            row["plain_ms"] = cuda_ms(lambda: C.fused_conv_reference(
                x, w, b, w_scale=scale, **kw))
        if prologue == "silu":
            row["prologue_bound_ms"] = x.numel() / PEAK_EXP * 1e3
        if (shape, c_out, k) in CONV_PROBED and prologue and not int8:
            row["ms_no_prologue"] = cuda_ms(lambda: C.fused_conv_cuda(
                x, w, b, w_scale=scale))
        if prologue and not int8:
            # the whole site under each policy, with the same GroupNorm
            pc = {"w": w, "b": b if b.dim() == 1 else b[0]}
            t = (b - pc["b"]).to(torch.bfloat16) if per_sample else None
            for policy in ("cuda_conv", "cuda"):
                row[f"{policy}_site_ms"] = cuda_ms(lambda: unet._norm_conv(
                    pn, pc, x, groups, 1e-5, policy,
                    fuse_silu=prologue == "silu", padding=k // 2, t=t))
        emit({"phase": label, **row})
        if not err <= FUSED_TOL * ref_max:
            raise AssertionError(f"conv kernel disagrees at {row}")
        if want not in (None, plan["design"]):
            raise AssertionError(f"conv case written for the {want} kernel "
                                 f"got {row}")
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


def device_profile(fn):
    """torch.profiler over one call of ``fn``: device ms by kernel name,
    the number of device kernels, and the call's wall ms on the host. The
    device events are read from the profiler's raw records: building its
    Python event tree over the eager loop's CPU ops took 20-35 s a call.
    The profile may miss the call's first 25 or so kernels (see
    ``sdtpu_torch.bench.xprof``), a few of an image's tens of
    thousands."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    launches = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            launches += 1
            by_name[e.name()] = (by_name.get(e.name(), 0.0)
                                 + e.duration_ns() / 1e6)
    return by_name, launches, wall_ms


def phase_breakdown(ctx, policy):
    """Where one image's time goes under ``policy``: CUDA-event times of
    the three stages, then a torch.profiler trace of one image (device busy
    and idle share, the kernels that take the most device time)."""
    from sdtpu_torch.engine import pipeline

    before = ctx.kernels
    ctx.kernels = policy
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    gen = torch.Generator(device="cuda").manual_seed(5)
    with torch.inference_mode():
        ev[0].record()
        context = pipeline._build_context(ctx.params, ctx._tokens(PROMPT),
                                          ctx._uncond, ctx.cfg, True)
        ev[1].record()
        noise = pipeline.draw_noise(gen, pipeline._latent_shape(1, ctx.cfg),
                                    ctx.steps, ("noise",), "cuda")["noise"]
        x = pipeline.denoise(ctx.params, context, 7.5, ctx.cfg, ctx.steps,
                             True, ctx.kernels, noise=noise)
        ev[2].record()
        pipeline.decode_latents(ctx.params, x, ctx.cfg, ctx.kernels)
        ev[3].record()
    torch.cuda.synchronize()
    res = {"phase": "breakdown", "kernels": policy,
           "quantize": ctx.quantize, "text_ms": ev[0].elapsed_time(ev[1]),
           "denoise_ms": ev[1].elapsed_time(ev[2]),
           "unet_eval_ms": ev[1].elapsed_time(ev[2]) / ctx.steps,
           "decode_ms": ev[2].elapsed_time(ev[3])}
    by_name, launches, wall_ms = device_profile(
        lambda: ctx.generate(PROMPT, guidance=7.5, seed=5))
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
        "conv_ms": sum(v for k, v in by_name.items() if any(
            kernel in k for kernel in ("conv_slab_kernel",
                                       "conv_general_kernel",
                                       "conv_sum_kernel"))),
        "matmul_int8w_ms": sum(v for k, v in by_name.items()
                               if "mm_int8w" in k),
        "matmul_w8a8_ms": sum(v for k, v in by_name.items()
                              if "mm_w8a8" in k),
        "top_kernels_ms": [[k[:90], v] for k, v in top]})
    emit(res)
    ctx.kernels = before


# the bench phase: the port's measurement tools (sdtpu_torch.bench,
# tools/attr_mma.py, the CLI's bench, profile, sweep and analyze), CLIP
# score with a ViT-L/14 vision tower, and int8w_dense under cuda_conv
BENCH_POLICIES = ("cuda", "cuda_gn", "cuda_conv")
# launches of each hand-written kernel's main __global__ in one UNet eval
# (the CFG batch of 2), from the profiler's device kernels (xprof's
# classes): K1 10 under every policy (201 = 10 x 20 + 1), K2 61 under
# cuda_gn, K3 and K2's statistics mode 60 each under cuda_conv (1,228 =
# 60 x 20 + 28); a split's sum pass is not a launch of the kernel
# (tests/test_torch_hopper.py::test_eval_pins_are_the_image_pins)
EVAL_PINNED = {"cuda": {"K1": 10},
               "cuda_gn": {"K1": 10, "K2": 61},
               "cuda_conv": {"K1": 10, "K2": 60, "K3": 60}}
# attr_mma's FLOPs over a part against count_flops of the same part
ATTR_FLOPS_TOL = 0.06
# CLIP score: the cosines on the card against the same float32 towers on
# the CPU (the product order differs)
CLIP_COS_TOL = 1e-3
CLIP_SEED = 41


def bench_runner(ctx, res):
    """(a): ``benchmark_parts`` under each policy on the demo weights; a
    part's ``.error`` fails the run."""
    from sdtpu_torch.bench.runner import benchmark_parts

    tmp = tempfile.mkdtemp(prefix="sdtpu-bench-")
    try:
        for policy in BENCH_POLICIES:
            out = os.path.join(tmp, policy)
            summary = benchmark_parts(ctx.cfg, params=ctx.params, warmup=3,
                                      iters=10, out_dir=out, kernels=policy,
                                      device="cuda")
            errors = sorted(f for f in os.listdir(out)
                            if f.endswith(".error"))
            if errors:
                with open(os.path.join(out, errors[0])) as f:
                    raise AssertionError(f"bench {policy}: {errors}: "
                                         f"{f.read()[-3000:]}")
            res[f"parts_{policy}"] = {
                name: {k: r[k] for k in (
                    "latency_ms", "latency_p99_ms", "device_ms",
                    "device_p99_ms", "flops", "tflop_per_s", "mfu_pct",
                    "device_tflop_per_s", "device_mfu_pct", "op_classes")}
                for name, r in summary.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: the wrappers' counters (``counts``) of each class of EVAL_PINNED
EVAL_COUNTERS = {"K1": ("flash",), "K2": ("group_norm", "group_norm_affine"),
                 "K3": ("conv",)}


def bench_kernel_counts(ctx, res, failures):
    """(b): the profiler over one UNet eval under each policy: each
    hand-written kernel's main launches at ``EVAL_PINNED``, and at the
    wrappers' counts over the same calls (a warm one and the profiled one,
    so a record the profiler lost shows apart from a launch that did not
    happen); the sum passes beside them, the class totals and the top
    10."""
    from sdtpu_torch.bench.runner import part_specs
    from sdtpu_torch.bench.xprof import kernel_launches, profile_ops

    for policy in BENCH_POLICIES:
        fn, args = part_specs(ctx.cfg, ctx.params, policy, "cuda")["unet"]
        reset_counts()
        ops = profile_ops(fn, args)
        wrapped = counts()
        launches = kernel_launches(ops)
        mains = {k: v[0] for k, v in launches.items()}
        calls = {cls: sum(wrapped[c] for c in names) / 2
                 for cls, names in EVAL_COUNTERS.items()
                 if any(wrapped[c] for c in names)}
        by_class: dict[str, float] = {}
        for rec in ops.values():
            by_class[rec["class"]] = (by_class.get(rec["class"], 0.0)
                                      + rec["total_us"] / 1e3)
        top = sorted(ops.items(), key=lambda kv: -kv[1]["total_us"])[:10]
        res[f"eval_{policy}"] = {
            "launches": mains, "wrapper_calls": calls,
            "sum_passes": {k: v[1] for k, v in launches.items() if v[1]},
            "device_ms": sum(r["total_us"] for r in ops.values()) / 1e3,
            "kernels": sum(r["count"] for r in ops.values()),
            "class_ms": dict(sorted(by_class.items(),
                                    key=lambda kv: -kv[1])),
            "top_ms": [[k[:90], r["total_us"] / 1e3, r["count"], r["class"]]
                       for k, r in top],
            "names": {k[:160]: [r["count"], r["class"]]
                      for k, r in ops.items()}}
        if mains != EVAL_PINNED[policy] or calls != EVAL_PINNED[policy]:
            failures.append(f"{policy}: kernels an eval {mains} (the "
                            f"wrappers' {calls}), expected "
                            f"{EVAL_PINNED[policy]}")
    reset_counts()


def bench_attribution(ctx, res):
    """(c): ``attr_mma`` over one UNet eval under cuda_conv: its FLOPs
    within ``ATTR_FLOPS_TOL`` of ``count_flops``; the 10 rows with the most
    device ms."""
    from sdtpu_torch.bench.flops import count_flops
    from sdtpu_torch.tools import attr_mma

    fn, args = attr_mma.part_call("unet", ctx.cfg, "cuda_conv", "cuda",
                                  params=ctx.params)
    t0 = time.perf_counter()
    got = attr_mma.attribute(fn, args)
    want = count_flops(ctx.cfg, "unet")
    rows = sorted(got["rows"].items(), key=lambda kv: -kv[1]["us"])
    res["attr"] = {
        "seconds": time.perf_counter() - t0, "flops": got["flops"],
        "count_flops": want, "rel": got["flops"] / want - 1.0,
        "device_ms": got["total_us"] / 1e3,
        "attributed_ms": got["attributed_us"] / 1e3,
        "tflop_per_s": got["flops"] / (got["total_us"] * 1e-6) / 1e12,
        "top": [[k, r["us"] / 1e3, r["flops"] / r["calls"], r["calls"],
                 r["flops"] / (r["us"] * 1e-6) / 1e12] for k, r in rows[:10]],
        "by_class_ms": {k: v / 1e3 for k, v in got["by_class"].items()}}
    if abs(res["attr"]["rel"]) > ATTR_FLOPS_TOL:
        raise AssertionError(f"attr_mma FLOPs off count_flops: {res['attr']}")


def bench_cli(res):
    """(e): the CLI in process, each command returning 0."""
    from sdtpu_torch import cli

    tmp = tempfile.mkdtemp(prefix="sdtpu-bench-cli-")
    try:
        runs = {
            "bench": ["bench", "--parts", "unet", "--warmup", "2", "--iters",
                      "5", "--results", tmp],
            "analyze": ["analyze", "--results", tmp],
            "profile": ["profile", "--part", "unet", "--top", "10"],
            "sweep": ["sweep", "--quick", "--sizes", "512", "--steps-list",
                      "4", "--iters", "1"]}
        for name, argv in runs.items():
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv)
            lines = out.getvalue().splitlines()
            res[f"cli_{name}"] = {"rc": rc, "seconds":
                                  time.perf_counter() - t0,
                                  "lines": lines[-12:]}
            gc.collect()
            torch.cuda.empty_cache()
            if rc != 0:
                raise AssertionError(f"cli {name}: rc {rc}: {lines[-20:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sweep = json.loads(res["cli_sweep"]["lines"][-1])
    if sweep["steps"] != 4 or sweep["kernels"] != "cuda":
        raise AssertionError(f"cli sweep: {sweep}")


def bench_clip_score(ctx, res):
    """(f): CLIP score of two main-path images against their prompts, a
    ViT-L/14 vision tower and a [768, 768] text projection made from a
    seed in float32, the Context's text tower: scores finite in [0, 100],
    the cosines within ``CLIP_COS_TOL`` of the same towers on the CPU."""
    from sdtpu_torch.models import clip
    from sdtpu_torch.quant import clip_score as CS

    gen = torch.Generator(device="cuda").manual_seed(CLIP_SEED)
    vcfg = clip.VIT_L14
    vision = clip.init_vision(vcfg, gen, "cuda")
    proj = torch.randn((ctx.cfg.clip.hidden, vcfg.projection), generator=gen,
                       device="cuda") * ctx.cfg.clip.hidden ** -0.5
    images = np.stack([ctx.generate(p, guidance=7.5, seed=CLIP_SEED)
                       for p in CALIB_PROMPTS])
    args = (images, CALIB_PROMPTS, ctx.tokenizer, ctx.params["clip"], proj,
            vision, ctx.cfg.clip, vcfg)
    CS.clip_scores(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = CS.clip_scores(*args)
    ms = (time.perf_counter() - t0) * 1e3 / len(images)
    cos = CS.clip_cosines(*args)

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cpu(v) for v in tree]
        return tree.cpu()

    cos_cpu = CS.clip_cosines(images, CALIB_PROMPTS, ctx.tokenizer,
                              cpu(ctx.params["clip"]), proj.cpu(),
                              cpu(vision), ctx.cfg.clip, vcfg)
    del vision
    err = float(np.abs(cos - cos_cpu).max())
    res["clip_score"] = {"scores": scores.tolist(), "cosines": cos.tolist(),
                         "cosines_cpu": cos_cpu.tolist(), "max_abs_err": err,
                         "ms_per_image": ms, "images": list(images.shape)}
    if not (np.isfinite(scores).all() and ((scores >= 0)
                                           & (scores <= 100)).all()
            and err <= CLIP_COS_TOL):
        raise AssertionError(f"clip score: {res['clip_score']}")


def bench_int8w_dense_conv(ctx_d, conv_sites, res):
    """(g): ``quantize="int8w_dense"`` under cuda_conv: one image with
    every launch pinned, the same bytes from the same seed; its K3 sites of
    int8 weights against the ones ``kernel_conv`` holds (a row for each it
    does not); the image's device busy ms beside int8w_dense under cuda."""
    from sdtpu_torch.models import unet
    from sdtpu_torch.ops import conv as C

    launches = phase_policy(ctx_d, "cuda_conv", "int8w_dense_conv")
    cfg = ctx_d.cfg
    x, te, context = unet_inputs(cfg, 3)
    log = []
    with torch.inference_mode(), recording(C, "fused_conv_cuda", log):
        unet.apply(ctx_d.params["unet"], x, te, context, cfg.unet,
                   "cuda_conv")
    reset_counts()
    held = {k for k in conv_sites if k[0][0] == 2}
    new = {}
    for args, kwargs in log:
        xx, w, b = args
        if kwargs.get("w_scale") is None:
            raise AssertionError("int8w_dense: a K3 site without int8 "
                                 "weights")
        prologue = (None if kwargs.get("a") is None else
                    "silu" if kwargs.get("silu", True) else "affine")
        key = (tuple(xx.shape), w.shape[0], w.shape[-1], prologue,
               b.dim() == 2)
        if key not in held:
            new[key] = new.get(key, 0) + STEPS
    res["int8w_dense_conv"] = {"launches": launches, "k3_sites": len(log),
                               "new_k3_sites": len(new)}
    if new:
        res["int8w_dense_conv"]["rows"] = phase_kernel_conv(
            new, ragged=[], label="kernel_conv_int8w_dense")
    before = ctx_d.kernels
    for policy in ("cuda", "cuda_conv"):
        ctx_d.kernels = policy
        by_name, n, wall = device_profile(
            lambda: ctx_d.generate(PROMPT, guidance=7.5, seed=5))
        res["int8w_dense_conv"][f"busy_ms_{policy}"] = sum(by_name.values())
        res["int8w_dense_conv"][f"kernels_{policy}"] = n
        res["int8w_dense_conv"][f"wall_ms_{policy}"] = wall
    ctx_d.kernels = before


def phase_bench(ctx, ctx_d, conv_sites):
    """The port's measurement tools at SD1.5's full width on the demo
    weights, one JSON line: (a) ``benchmark_parts`` under cuda, cuda_gn and
    cuda_conv; (b) the per-eval launches of K1, K2 and K3 from the
    profiler; (c) ``attr_mma``'s FLOPs against ``count_flops``; (d)
    ``phase_timings``; (e) the CLI's bench, analyze, profile and sweep in
    process; (f) CLIP score on the card against the CPU; (g)
    ``int8w_dense`` under cuda_conv."""
    from sdtpu_torch.bench.profile import phase_timings

    t0 = time.perf_counter()
    res = {"phase": "bench"}
    failures = []
    bench_runner(ctx, res)
    bench_kernel_counts(ctx, res, failures)
    bench_attribution(ctx, res)
    res["phases"] = phase_timings(ctx.cfg, ctx.params, steps=STEPS,
                                  kernels="cuda", warmup=1, iters=3)
    bench_cli(res)
    bench_clip_score(ctx, res)
    bench_int8w_dense_conv(ctx_d, conv_sites, res)
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    if failures:
        raise AssertionError(f"bench: {failures}")
    return res["int8w_dense_conv"]["launches"]


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


def phase_policy(ctx, policy, label=None):
    """The main path under a kernel policy on ``ctx`` (``label`` names its
    pinned counts where they are not the policy's own: a quantized mode):
    one image with the pinned launches of every kernel, the same seed
    giving the same bytes, s/image of one more image (the policies and
    modes are compared in ``ab`` and ``ab_quant``, in turns)."""
    label = label or policy
    before = ctx.kernels
    ctx.kernels = policy
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    img = ctx.generate(PROMPT, guidance=7.5, seed=11)
    first = time.perf_counter() - t0
    launches = counts()
    check_image(img, ctx.cfg.image_size)
    if launches != PINNED[label]:
        raise AssertionError(f"{label}: launches for one image {launches}, "
                             f"expected {PINNED[label]}")
    same = bool(np.array_equal(img, ctx.generate(PROMPT, guidance=7.5,
                                                 seed=11)))
    t0 = time.perf_counter()
    ctx.generate(PROMPT, guidance=7.5)
    times = [time.perf_counter() - t0]
    emit({"phase": "main_path", "kernels": policy, "quantize": ctx.quantize,
          "mode": label, "first_image_s": first,
          "s_per_image": statistics.median(times), "image_s": times,
          "launches_per_image": launches, "identical": same,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "image_mean": float(img.mean()), "image_std": float(img.std())})
    ctx.kernels = before
    if not same:
        raise AssertionError(f"{label}: same seed gave different images")
    return launches


def phase_ab(ctx):
    """s/image under every policy, in turns (plain, cuda, cuda_gn,
    cuda_conv, then back: 2 each) on the same context and
    weights. It runs
    right after the main-path phases, before the float32 and profiler
    phases, so every arm sees the state the main-path timing saw."""
    times = {k: [] for k in POLICIES}
    for k in POLICIES + POLICIES[::-1]:
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


def unet_inputs(cfg, seed, batch=1):
    """The CFG batch of ``batch`` requests' UNet inputs at the
    configuration's widths (the input planes its UNet takes)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = cfg.compute_dtype
    n = 2 * batch
    x = torch.randn((n, cfg.latent_size, cfg.latent_size,
                     cfg.unet.in_channels), generator=g, device="cuda").to(dt)
    te = torch.randn((n, cfg.unet.time_embed_dim), generator=g,
                     device="cuda").to(dt)
    context = torch.randn((n, cfg.clip.context_len, cfg.unet.context_dim),
                          generator=g, device="cuda").to(dt)
    return x, te, context


@contextlib.contextmanager
def w8a8_kernel(on: bool):
    """``ops.matmul.KERNEL_W8A8`` set for a block, then put back."""
    from sdtpu_torch.ops import matmul as MM

    before = MM.KERNEL_W8A8
    MM.KERNEL_W8A8 = on
    try:
        yield
    finally:
        MM.KERNEL_W8A8 = before


def phase_calibrate(ctx_i):
    """Static activation scales for the int8 Context, on the card: 2
    prompts x 2 steps, as the caller of the reference does it. Every W8A8
    site must come back with a float32 scalar ``x_scale``."""
    from sdtpu_torch.quant.ptq import calibrate, count_quantized

    t0 = time.perf_counter()
    ctx_i.params = calibrate(ctx_i.params, ctx_i.cfg, CALIB_PROMPTS,
                             ctx_i.tokenizer, steps=2)
    scales = []

    def walk(node):
        if isinstance(node, dict):
            if "w_q" in node:
                scales.append(node["x_scale"])
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(ctx_i.params)
    vals = torch.stack(scales).float().cpu()
    emit({"phase": "calibrate", "seconds": time.perf_counter() - t0,
          "sites": count_quantized(ctx_i.params), "scaled": len(scales),
          "x_scale_min": vals.min().item(), "x_scale_max": vals.max().item()})
    # 16 transformer blocks of 10 dense sites
    if len(scales) != 160 or not bool(torch.isfinite(vals).all()) or not (
            vals.min().item() > 0):
        raise AssertionError("calibration left a site without a scale")


def phase_mm_sites(ctx_d, ctx_w, ctx_i, batch=1):
    """The call shapes K4 and K5 get on the quantized main paths, and how
    many times per image: one UNet eval (x STEPS) under each mode with the
    wrappers' arguments logged. Keys are (m, k, n, bias). For ``batch``
    requests (the UNet eval at N = 2 x batch) the modes of the batch phase,
    against ``BATCH_PINNED``."""
    from sdtpu_torch.models import unet
    from sdtpu_torch.ops import matmul as MM

    x, te, context = unet_inputs(ctx_d.cfg, 6, batch)
    found = {}
    arms = (("int8w_dense", ctx_d, "matmul_int8w_cuda", False),
            ("int8w", ctx_w, "matmul_int8w_cuda", False),
            ("int8+k5", ctx_i, "matmul_w8a8_cuda", True))
    pinned = PINNED if batch == 1 else BATCH_PINNED
    for label, ctx, name, flag in arms:
        if label not in pinned:
            continue
        log = []
        with torch.inference_mode(), recording(MM, name, log), w8a8_kernel(
                flag):
            unet.apply(ctx.params["unet"], x, te, context, ctx.cfg.unet,
                       ctx.kernels)
        sites = {}
        for args, _ in log:   # (x, w8, scale[, x_scale], bias)
            xx, w8 = args[0], args[1]
            key = (xx.numel() // xx.shape[-1], w8.shape[0], w8.shape[1],
                   args[-1] is not None)
            sites[key] = sites.get(key, 0) + STEPS
        found[label] = sites
    reset_counts()
    emit({"phase": "mm_sites", "batch": batch, **{
        f"{k}_{what}": v for k, sites in found.items() for what, v in (
            ("shapes", len(sites)), ("per_image", sum(sites.values())))}})
    for label, key in (("int8w_dense", "matmul_int8w"),
                       ("int8w", "matmul_int8w"),
                       ("int8+k5", "matmul_w8a8")):
        if label in found and sum(found[label].values()) != pinned[label][
                key]:
            raise AssertionError(f"{label}: site counts differ from the "
                                 f"pinned counts: {found[label]}")
    return found


def mm_case(m, k, n, bias, g):
    """bf16 activations, an int8 weight in column-major memory with its
    per-column scale, the bf16 weight it came from, a float32 bias."""
    from sdtpu_torch.ops import matmul as MM

    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn((k, n), generator=g, device="cuda") / k ** 0.5
    scale = w.abs().amax(dim=0) / 127.0
    w8 = MM.column_major(torch.clamp(torch.round(w / scale), -127, 127)
                         .to(torch.int8))
    b = torch.randn(n, generator=g, device="cuda") if bias else None
    return x, w8, scale, b, MM.column_major(w.to(torch.bfloat16))


def phase_widening():
    """All 256 int8 values through K4's two widenings (the tile kernel's
    byte permutes and bf16 subtract at 256 rows, the skinny kernel's float32
    mantissa trick at 2 rows): one-hot rows of x pick each weight out, with
    scale 1 and no bias, and the bf16 output must equal it exactly."""
    from sdtpu_torch.ops import matmul as MM

    vals = torch.arange(-128, 128, device="cuda").to(torch.int8)
    w8 = MM.column_major(vals[:, None].expand(256, 16).contiguous())
    ones = torch.ones(16, device="cuda")
    want = vals.float()[:, None].expand(256, 16)
    tile = MM.matmul_int8w_cuda(
        torch.eye(256, device="cuda", dtype=torch.bfloat16), w8, ones)
    skinny = []
    for k0 in range(0, 256, 2):
        x = torch.zeros((2, 256), device="cuda", dtype=torch.bfloat16)
        x[0, k0] = x[1, k0 + 1] = 1
        skinny.append(MM.matmul_int8w_cuda(x, w8, ones))
    torch.cuda.synchronize()
    wrong = {"tile": int((tile.float() != want).sum().item()),
             "skinny": int((torch.cat(skinny).float() != want).sum().item())}
    emit({"phase": "widening", "values": 256, "wrong": wrong})
    if any(wrong.values()):
        raise AssertionError(f"int8 -> bf16 widening is not exact: {wrong}")


def phase_kernel_mm(sites, ragged=MM_RAGGED, label="kernel_mm"):
    """K4 and K5 at every main-path shape and at ragged ones, each against
    its plain version on the same bf16 inputs (K4's run in float32, K5's
    as it is: its arithmetic is exact up to the final cast).

    Times: the kernel; the plain version; for K4 the bf16 ``x @ w + b`` of
    the unquantized site (what ``quantize="none"`` runs: ``library_ms``)
    and the dequantize-then-multiply fallback; for K5 the whole library
    path that ``KERNEL_W8A8 = False`` runs (``layers.dense``: quantize,
    ``_int_mm``, scale, bias: ``library_ms``, also as ``static_path_ms``)
    and ``torch._int_mm`` on activations quantized beforehand (the product
    alone: ``product_ms``). Each row carries its kernel's plan."""
    from sdtpu_torch.models import layers as L
    from sdtpu_torch.ops import matmul as MM

    g = torch.Generator(device="cuda").manual_seed(7)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k4 = dict(sites["int8w_dense"])
    for key in sites.get("int8w", ()):
        k4.setdefault(key, 0)
    k5 = sites["int8+k5"]
    rows = {"matmul_int8w": [], "matmul_w8a8": []}
    for name, cases in (
            ("matmul_int8w", sorted(k4.items()) + [(c, 0) for c in ragged]),
            ("matmul_w8a8", sorted(k5.items()) + [(c, 0) for c in ragged])):
        for (m, k, n, bias), per_image in cases:
            x, w8, scale, b, wb = mm_case(m, k, n, bias, g)
            nbytes = (x.numel() * 2 + w8.numel() + n * 4 * (1 + bias)
                      + m * n * 2)
            row = {"m": m, "k": k, "n": n, "bias": bias,
                   "per_image": per_image}
            derived = {}
            if name == "matmul_int8w":
                # which of the source's kernels the static rule chose
                derived["plan"] = MM.plan_int8w(m, k, n, sms)
                row["design"] = {"tile": "wgmma", "skinny": "simt"}[
                    derived["plan"]["path"]]
                out = MM.matmul_int8w_cuda(x, w8, scale, b)
                torch.cuda.synchronize()
                ref = MM.matmul_int8w_reference(x.float(), w8, scale, b)
                bb = None if b is None else b.to(torch.bfloat16)
                pd = {"w8": w8, "w8_scale": scale}
                if b is not None:
                    pd["b"] = bb
                with_bias = (lambda y: y) if b is None else (
                    lambda y: y + bb)
                row.update(zip(("bound_ms", "bound_by"),
                               bound(2.0 * m * k * n, "bf16", nbytes)))
                row.update({
                    "ms": cuda_ms(lambda: MM.matmul_int8w_cuda(
                        x, w8, scale, b)),
                    "plain_ms": cuda_ms(lambda: MM.matmul_int8w_reference(
                        x, w8, scale, b)),
                    "library_ms": cuda_ms(lambda: with_bias(x @ wb)),
                    "dequant_ms": cuda_ms(lambda: with_bias(
                        x @ L._weight(pd, torch.bfloat16)))})
                tol = FUSED_TOL
            else:
                derived["plan"] = MM.plan_w8a8(m, k, n, sms)
                row["design"] = "wgmma"
                xs = x.float().abs().max() / 127.0
                out = MM.matmul_w8a8_cuda(x, w8, scale, xs, b)
                torch.cuda.synchronize()
                ref = MM.matmul_w8a8_reference(x, w8, scale, xs, b)
                row["mismatched"] = int((out != ref).sum().item())
                ref = ref.float()
                xq = MM.quantize_activation(x, xs)
                pq = {"w_q": w8, "w_scale": scale, "x_scale": xs}
                if b is not None:
                    pq["b"] = b
                row.update(zip(("bound_ms", "bound_by"),
                               bound(2.0 * m * k * n, "int8", nbytes)))
                row.update({
                    "ms": cuda_ms(lambda: MM.matmul_w8a8_cuda(
                        x, w8, scale, xs, b)),
                    "plain_ms": cuda_ms(lambda: MM.matmul_w8a8_reference(
                        x, w8, scale, xs, b)),
                    "product_ms": (cuda_ms(lambda: torch._int_mm(xq, w8))
                                   if m > 16 and n % 8 == 0 else None),
                    "static_path_ms": cuda_ms(lambda: L.dense(pq, x))})
                row["library_ms"] = row["static_path_ms"]
                tol = W8A8_TOL
            row["max_abs_err"] = (out.float() - ref).abs().max().item()
            row["ref_abs_max"] = ref.abs().max().item()
            row["tops"] = 2.0 * m * k * n / row["ms"] / 1e9
            emit({"phase": label, "kernel": name, **row, **derived})
            if not row["max_abs_err"] <= tol * row["ref_abs_max"]:
                raise AssertionError(f"{name} disagrees at {row}")
            rows[name].append(row)
    return rows


def phase_ab_quant(arms):
    """s/image under each quantized mode and ``quantize="none"``, in turns
    (there and back: 2 each, their mean). arms: (label, ctx, KERNEL_W8A8)."""
    times = {label: [] for label, _, _ in arms}
    for label, ctx, flag in arms + arms[::-1]:
        with w8a8_kernel(flag):
            t0 = time.perf_counter()
            ctx.generate(PROMPT, guidance=7.5, seed=9)
            times[label].append(time.perf_counter() - t0)
    emit({"phase": "ab_quant",
          "s_per_image": {k: statistics.median(v) for k, v in times.items()},
          "image_s": times})


def phase_quant_model(ctx, arms):
    """One full-width UNet eval under each quantized mode against the
    unquantized float32 UNet on the same weights (the bf16 values widened
    exactly) and inputs, beside the unquantized bf16 error; and each mode's
    image against the ``quantize="none"`` image at the same seed
    (``validate_quantized``). The weights are random, so the numbers are
    recorded and only garbage fails."""
    from sdtpu_torch.io.params import cast_params
    from sdtpu_torch.models import unet
    from sdtpu_torch.quant.validate import validate_quantized

    cfg = ctx.cfg
    x, te, context = unet_inputs(cfg, 1)
    res = {"phase": "quant_model"}
    with torch.inference_mode():
        p32 = cast_params(ctx.params["unet"], torch.float32)
        ref = unet.apply(p32, x.float(), te.float(), context.float(),
                         cfg.unet, "plain")
        del p32
        for label, c, flag in arms:
            with w8a8_kernel(flag):
                out = unet.apply(c.params["unet"], x, te, context, cfg.unet,
                                 c.kernels)
            res[f"unet_{label}_finite"] = bool(torch.isfinite(out).all())
            res[f"unet_{label}_rel_err"] = rel_err(out, ref)
            del out
        del ref
    torch.cuda.empty_cache()
    for label, c, flag in arms[1:]:
        with w8a8_kernel(flag):
            m = validate_quantized(ctx, c, [PROMPT], seed=21)[0]
        res[f"psnr_db_{label}"] = m["psnr_db"]
        res[f"mean_abs_diff_{label}"] = m["mean_abs_diff"]
    emit(res)
    for label, _, _ in arms[1:]:
        if not (res[f"unet_{label}_finite"]
                and res[f"unet_{label}_rel_err"] <= QUANT_REL_ERR_MAX
                and res[f"psnr_db_{label}"] >= QUANT_PSNR_MIN_DB):
            raise AssertionError(f"{label}: quantized output is garbage: "
                                 f"{res}")


CKPT_SEED = 17
CONFIG = "sd15"


def demo_images(ctx, ctx_d, ctx_w, ctx_i):
    """The demo Contexts' images at ``CKPT_SEED``: under cuda, cuda_gn and
    cuda_conv, and under int8w_dense, int8w and int8 + K5."""
    before = ctx.kernels
    out = {}
    for policy in ("cuda", "cuda_gn", "cuda_conv"):
        ctx.kernels = policy
        out[policy] = ctx.generate(PROMPT, guidance=7.5, seed=CKPT_SEED)
    ctx.kernels = before
    out["int8w_dense"] = ctx_d.generate(PROMPT, guidance=7.5, seed=CKPT_SEED)
    out["int8w"] = ctx_w.generate(PROMPT, guidance=7.5, seed=CKPT_SEED)
    with w8a8_kernel(True):
        out["int8+k5"] = ctx_i.generate(PROMPT, guidance=7.5,
                                        seed=CKPT_SEED)
    return out


def loaded_image(c, policy, label, want):
    """One image of a Context on loaded weights under ``policy``: every
    kernel's launches at ``PINNED[label]``, the bytes of ``want`` (the demo
    weights' image at the same seed)."""
    c.kernels = policy
    reset_counts()
    img = c.generate(PROMPT, guidance=7.5, seed=CKPT_SEED)
    launches = counts()
    check_image(img, c.cfg.image_size)
    if launches != PINNED[label]:
        raise AssertionError(f"loaded {label}: launches for one image "
                             f"{launches}, expected {PINNED[label]}")
    if not np.array_equal(img, want):
        raise AssertionError(f"loaded {label}: other bytes than the demo "
                             f"weights at the same seed")
    return launches


def load_context(model_dir, **kw):
    from sdtpu_torch import Context

    return Context(model_dir=str(model_dir), config=CONFIG, steps=STEPS,
                   device="cuda", **kw)


def release(*contexts):
    for c in contexts:
        c.params = None
    gc.collect()
    torch.cuda.empty_cache()


def phase_checkpoint(root, ctx, demo, smi):
    """Write the checkpoint files under ``root`` and serve each through
    ``Context(model_dir=...)`` (module docstring, item 12). Returns the
    native directory and the launches per image on loaded weights."""
    from sdtpu_torch.io import safetensors as st
    from sdtpu_torch.io.weights import NATIVE_SUFFIX, params_to_ldm
    from sdtpu_torch.quant.ptq import calibrate
    from sdtpu_torch.tools import convert_weights

    start = time.perf_counter()
    ldm, native, int8w = (os.path.join(root, d) for d in ("ldm", "native",
                                                          "int8w"))
    for d in (ldm, native, int8w):
        os.makedirs(d)
    ldm_file = os.path.join(ldm, "sd15-demo.safetensors")
    t0 = time.perf_counter()
    st.save_file(params_to_ldm(ctx.params, ctx.cfg,
                               dtype=ctx.cfg.compute_dtype), ldm_file)
    res = {"phase": "checkpoint", "nvidia_smi": smi,
           "write_ldm_s": time.perf_counter() - t0}
    for label, out, extra in (("native", native, []),
                              ("int8w", int8w, ["--int8w", "conv"])):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):   # its progress lines
            rc = convert_weights.main([ldm_file, out, "--config", CONFIG,
                                       "--dtype", ctx.cfg.dtype, *extra])
        if rc != 0:
            raise AssertionError(f"convert_weights {label} failed")
        res[f"convert_{label}_s"] = time.perf_counter() - t0
    res["dtype"] = ctx.cfg.dtype
    res["bytes"] = {
        "ldm": os.path.getsize(ldm_file),
        "native": os.path.getsize(os.path.join(native,
                                               f"model{NATIVE_SUFFIX}")),
        "native_int8w": os.path.getsize(os.path.join(
            int8w, f"model{NATIVE_SUFFIX}"))}
    res["init_s"] = {"demo": ctx.init_seconds}
    launches = {}

    c = load_context(ldm, kernels="cuda")
    res["init_s"]["ldm"] = c.init_seconds
    for policy in ("cuda", "cuda_gn", "cuda_conv"):
        launches[policy] = loaded_image(c, policy, policy, demo[policy])
    release(c)
    c = load_context(native, kernels="cuda")
    res["init_s"]["native"] = c.init_seconds
    for policy in ("cuda", "cuda_conv"):
        loaded_image(c, policy, policy, demo[policy])
    release(c)
    c = load_context(int8w, kernels="cuda_conv")
    res["init_s"]["native_int8w"] = c.init_seconds
    launches["int8w"] = loaded_image(c, "cuda_conv", "int8w", demo["int8w"])
    release(c)
    c = load_context(ldm, kernels="cuda", quantize="int8w_dense")
    res["init_s"]["ldm_int8w_dense"] = c.init_seconds
    launches["int8w_dense"] = loaded_image(c, "cuda", "int8w_dense",
                                           demo["int8w_dense"])
    release(c)
    c = load_context(ldm, kernels="cuda", quantize="int8")
    res["init_s"]["ldm_int8"] = c.init_seconds
    c.params = calibrate(c.params, c.cfg, CALIB_PROMPTS, c.tokenizer,
                         steps=2)
    with w8a8_kernel(True):
        launches["int8+k5"] = loaded_image(c, "cuda", "int8+k5",
                                           demo["int8+k5"])
    release(c)
    res["launches_per_image"] = launches
    res["identical"] = True
    res["seconds"] = time.perf_counter() - start
    emit(res)
    return native, launches


def phase_text_surface(native, demo):
    """The text features on the native file under cuda (module docstring,
    item 13): K1 201 launches an image, the same bytes twice at a seed."""
    def image(c, prompt, label):
        reset_counts()
        img = c.generate(prompt, guidance=7.5, seed=CKPT_SEED)
        launches = counts()
        check_image(img, c.cfg.image_size)
        if launches != PINNED["cuda"]:
            raise AssertionError(f"{label}: launches {launches}, expected "
                                 f"{PINNED['cuda']}")
        if not np.array_equal(img, c.generate(prompt, guidance=7.5,
                                              seed=CKPT_SEED)):
            raise AssertionError(f"{label}: same seed gave other bytes")
        return img

    start = time.perf_counter()
    res = {"phase": "text_surface"}
    c = load_context(native, kernels="cuda", clip_skip=2)
    skip = image(c, PROMPT, "clip_skip=2")
    res["clip_skip_2_differs"] = not np.array_equal(skip, demo["cuda"])
    release(c)
    c = load_context(native, kernels="cuda")
    table = c.params["clip"]["token_embedding"]
    c.load_embedding("<steed>", table[c.tokenizer.encode("horse")])
    ti = image(c, PROMPT.replace("horse", "<steed>"), "placeholder")
    res["placeholder_is_the_word"] = bool(np.array_equal(ti, demo["cuda"]))
    sched = image(c, "a [cat:dog:0.5] on a sofa", "scheduled")
    res["scheduled_differs"] = not np.array_equal(
        sched, image(c, "a dog on a sofa", "plain"))
    degen = image(c, f"[{PROMPT}:{PROMPT}:0.5]", "degenerate schedule")
    res["degenerate_is_the_plain"] = bool(np.array_equal(degen,
                                                         demo["cuda"]))
    release(c)
    res["seconds"] = time.perf_counter() - start
    emit(res)
    if not (res["clip_skip_2_differs"] and res["placeholder_is_the_word"]
            and res["scheduled_differs"] and res["degenerate_is_the_plain"]):
        raise AssertionError(f"text_surface: {res}")


def phase_samplers(ctx):
    """One image with each sampler of ``SAMPLER_EVALS`` under ``cuda`` on
    the main Context (``checked_call``): uint8 [512, 512, 3], not constant,
    finite latents whose decode gives the same bytes (the same seed), and
    K1 launched 10 times an eval and once in the VAE, no other kernel."""
    before = ctx.sampler, ctx.kernels
    ctx.kernels = "cuda"
    for name, evals in SAMPLER_EVALS.items():
        ctx.sampler = name
        img, launches, image_s, lat = checked_call(
            ctx, lambda **kw: ctx.generate(PROMPT, guidance=7.5, **kw),
            pins(flash=10 * evals + 1), name, 41)
        emit({"phase": "samplers", "sampler": name, "evals": evals,
              "image_s": image_s, "launches_per_image": launches,
              "identical": True, "latent_finite": True,
              "latent_abs_max": float(np.abs(lat).max()),
              "image_mean": float(img.mean()), "image_std": float(img.std())})
    ctx.sampler, ctx.kernels = before


def latents_alone(ctx, requests):
    """Each request's latents, run alone (a batch of one)."""
    return [ctx.generate_batch([r], output="latent")[0] for r in requests]


def float32_latents(ctx, requests=BATCH_REQUESTS):
    """The requests' latents from a float32 run of ``ctx``'s weights (the
    bf16 values widened exactly) at full width, its steps and sampler: the
    plain path, each request alone. The float32 Context is freed before
    returning."""
    import dataclasses

    from sdtpu_torch import Context
    from sdtpu_torch.io.params import cast_params

    c32 = Context(config=dataclasses.replace(ctx.cfg, dtype="float32"),
                  steps=ctx.steps, sampler=ctx.sampler, kernels="plain",
                  device=ctx.device)
    c32.params = {k: cast_params(v, torch.float32)
                  for k, v in ctx.params.items()}
    with torch.inference_mode():
        c32._prepare_buffers()
    lat = latents_alone(c32, requests)
    del c32
    torch.cuda.empty_cache()
    return lat


def phase_batch(arms, lat32):
    """``generate_batch`` of ``BATCH_REQUESTS`` (3, padded to 4) on each
    arm, (label, Context, kernel policy, ``KERNEL_W8A8``): the images,
    every kernel's launches per call (``BATCH_PINNED``), a batch of one
    against ``generate`` (the same bytes), each request's latents in the
    batch against the request alone, within ``BATCH_GAP_FACTOR`` times the
    gap between the request alone under ``cuda`` and its float32 run
    (``lat32``), relative to the float32 run's max-abs; s/image at B = 4
    (``BATCH_TIMED``) against B = 1, in turns, and device busy ms per image
    at B = 4 (torch.profiler)."""
    bound = None
    rows = []
    for label, ctx, policy, flag in arms:
        before = ctx.kernels
        ctx.kernels = policy
        with w8a8_kernel(flag):
            reset_counts()
            imgs = ctx.generate_batch(BATCH_REQUESTS)
            launches = counts()
            for img in imgs:
                check_image(img, ctx.cfg.image_size)
            r0 = BATCH_REQUESTS[0]
            one = ctx.generate_batch([r0])[0]
            same_one = bool(np.array_equal(one, ctx.generate(
                r0["prompt"], guidance=r0["guidance"], seed=r0["seed"])))
            in_batch = ctx.generate_batch(BATCH_REQUESTS, output="latent")
            alone = latents_alone(ctx, BATCH_REQUESTS)
            scale = [float(np.abs(r).max()) for r in lat32]
            if bound is None:     # the first arm is cuda's bf16
                bound = [float(np.abs(a - r).max()) / m
                         for a, r, m in zip(alone, lat32, scale)]
            gap = [float(np.abs(b - a).max()) / m
                   for b, a, m in zip(in_batch, alone, scale)]
            times = {1: [], BATCH: []}
            for reqs in (BATCH_TIMED, [BATCH_TIMED[0]]):
                t0 = time.perf_counter()
                ctx.generate_batch(reqs)
                times[len(reqs)].append((time.perf_counter() - t0)
                                        / len(reqs))
            by_name, kernels_b4, wall_ms = device_profile(
                lambda: ctx.generate_batch(BATCH_TIMED))
        ctx.kernels = before
        row = {"phase": "batch", "mode": label, "kernels": policy,
               "quantize": ctx.quantize, "launches_per_call": launches,
               "batch_of_one_identical": same_one,
               "latent_finite": bool(all(np.isfinite(b).all()
                                         for b in in_batch)),
               "in_batch_gap": gap, "bound": bound,
               "bound_factor": BATCH_GAP_FACTOR,
               "s_per_image_b1": statistics.mean(times[1]),
               "s_per_image_b4": statistics.mean(times[BATCH]),
               "image_s": {str(k): v for k, v in times.items()},
               "device_busy_ms_per_image_b4": sum(by_name.values()) / BATCH,
               "device_kernels_b4": kernels_b4,
               "profiled_wall_ms_b4": wall_ms,
               "image_means": [float(i.mean()) for i in imgs]}
        emit(row)
        if launches != BATCH_PINNED[label]:
            raise AssertionError(f"batch {label}: launches {launches}, "
                                 f"expected {BATCH_PINNED[label]}")
        if not same_one or not row["latent_finite"]:
            raise AssertionError(f"batch {label}: a batch of one differs "
                                 f"from generate, or latents not finite")
        if any(g > BATCH_GAP_FACTOR * b for g, b in zip(gap, bound)):
            raise AssertionError(f"batch {label}: a request in the batch is "
                                 f"off its run alone: {gap} > {bound}")
        rows.append(row)
    return rows


def phase_batch_kernels(ctx, ctx_d, ctx_w, ctx_i):
    """The kernels at the call shapes of a batch of four: the sites of one
    UNet eval at N = 8 and one VAE decode at N = 4 recorded as
    ``phase_sites`` and ``phase_mm_sites`` do, then K1, K2, K2's statistics
    mode, K3, K4 and K5 at each distinct one against their plain versions,
    with the batch-2 rows' tolerances; each row carries its plan and its
    device time."""
    flash = phase_kernel([(2 * BATCH, 4096, 320, 8), (2 * BATCH, 1024, 640, 8),
                          (BATCH, 4096, 512, 1)], [], "kernel_b4")
    sites = phase_sites(ctx, BATCH)
    gn_sites, conv_sites = sites["group_norm"], sites["conv"]
    gn = phase_kernel_gn(gn_sites, [], "kernel_gn_b4")
    affine = phase_kernel_gn_affine(conv_sites, [], "kernel_gn_affine_b4")
    conv = phase_kernel_conv(conv_sites, [], 2 * BATCH, "kernel_conv_b4")
    mm = phase_kernel_mm(phase_mm_sites(ctx_d, ctx_w, ctx_i, BATCH), [],
                         "kernel_mm_b4")
    return {"flash": flash, "group_norm": gn, "group_norm_affine": affine,
            "conv": conv, **mm}


# ---------------------------------------------------------------------------
# the SD 2.x and SDXL families at full width
# ---------------------------------------------------------------------------

FAMILY_SEED = 23


def family_context(name, **kw):
    from sdtpu_torch import Context

    return Context(config=name, steps=FAMILY_STEPS, device="cuda", **kw)


def family_image(ctx, name, mode, seed=FAMILY_SEED):
    """One image of a family Context under its current policy, sampler and
    flags (``checked_call``, held to ``FAMILY_PINNED[name][mode]``).
    Returns (image, launches, first image's seconds)."""
    img, launches, seconds, lat = checked_call(
        ctx, lambda **kw: ctx.generate(PROMPT, guidance=7.5, **kw),
        FAMILY_PINNED[name][mode], f"{name} {mode}", seed)
    emit({"phase": "family_image", "config": name, "mode": mode,
          "kernels": ctx.kernels, "quantize": ctx.quantize,
          "sampler": ctx.sampler, "first_image_s": seconds,
          "launches_per_image": launches, "identical": True,
          "latent_abs_max": float(np.abs(lat).max()),
          "image_mean": float(img.mean()), "image_std": float(img.std())})
    return img, launches, seconds


def family_mm_sites(ctx, name):
    """The call shapes K4 and K5 get in one UNet eval of the family at the
    CFG batch of 2, and their launches per image (``record_mm_sites``),
    held to the family's pins."""
    found = record_mm_sites(ctx, *unet_inputs(ctx.cfg, 6), STEPS)
    pinned = FAMILY_PINNED[name]
    emit({"phase": "family_mm_sites", "config": name, **{
        f"{k}_{what}": v for k, sites in found.items() for what, v in (
            ("shapes", len(sites)), ("per_image", sum(sites.values())))}})
    for label, key in (("int8w_dense", "matmul_int8w"),
                       ("int8+k5", "matmul_w8a8")):
        if sum(found[label].values()) != pinned[label][key]:
            raise AssertionError(f"{name} {label}: site counts differ from "
                                 f"the pins: {found[label]}")
    return found


def family_sites(ctx, name):
    """Every kernel's call shapes on the family's main path, with launches
    per image: K1, K2 and K3 (``phase_sites``), K4 and K5."""
    sites = phase_sites(ctx, pinned=FAMILY_PINNED[name],
                        label=f"sites_{name}")
    return {**sites, "mm": family_mm_sites(ctx, name)}


def family_kernel_rows(name, sites):
    """K1-K5 at the family's sites against their plain versions, with the
    existing tolerances (``kernel_families``): device ms of the kernel, its
    plain version and the library call, the bound and launches per
    image."""
    label = f"kernel_{name}"
    flash = sorted(sites["flash"])
    return {
        "flash": phase_kernel(flash, [], label, per_image=sites["flash"]),
        "group_norm": phase_kernel_gn(sites["group_norm"], [],
                                      f"{label}_gn"),
        "group_norm_affine": phase_kernel_gn_affine(
            sites["conv"], [], f"{label}_gn_affine",
            FAMILY_PINNED[name]["cuda_conv"]["group_norm_affine"]),
        "conv": phase_kernel_conv(sites["conv"], [], 2, f"{label}_conv",
                                  int8=False),
        **phase_kernel_mm(sites["mm"], [], f"{label}_mm")}


def family_unet_errors(ctx, contexts=()):
    """One full-width UNet eval at the CFG batch of 2 under each policy on
    ``ctx`` (bf16), and under each quantized Context of ``contexts``
    ((label, Context, KERNEL_W8A8)), against a float32 eval of ``ctx``'s
    weights (the bf16 values widened exactly) on the same inputs, the time
    embedding carrying the additive conditioning of a random pooled
    embedding where the family has one. Returns (errors, the reference
    and its inputs, to hold later quantized Contexts to)."""
    from sdtpu_torch.engine import pipeline
    from sdtpu_torch.io.params import cast_params
    from sdtpu_torch.models import unet

    cfg = ctx.cfg
    x, te, context = unet_inputs(cfg, 1)
    with torch.inference_mode():
        if cfg.clip2 is not None:
            g = torch.Generator(device="cuda").manual_seed(2)
            pooled = torch.randn((2, cfg.clip2.projection), generator=g,
                                 device="cuda").to(cfg.compute_dtype)
            te = te + pipeline._add_embedding(ctx.params, pooled, cfg)
        p32 = cast_params(ctx.params["unet"], torch.float32)
        ref = unet.apply(p32, x.float(), te.float(), context.float(),
                         cfg.unet, "plain")
        del p32
        torch.cuda.empty_cache()
    res = {}
    for k in POLICIES:
        with torch.inference_mode():
            out = unet.apply(ctx.params["unet"], x, te, context, cfg.unet, k)
        res[f"unet_{k}_finite"] = bool(torch.isfinite(out).all())
        res[f"unet_{k}_rel_err"] = rel_err(out, ref)
        del out
    return res, (x, te, context, ref)


def quant_unet_error(c, flag, held):
    from sdtpu_torch.models import unet

    x, te, context, ref = held
    with torch.inference_mode(), w8a8_kernel(flag):
        out = unet.apply(c.params["unet"], x, te, context, c.cfg.unet,
                         c.kernels)
    return bool(torch.isfinite(out).all()), rel_err(out, ref)


def ldm_family_file(ctx, path):
    """The Context's tree as a BF16 LDM file in its family's real naming:
    SDXL's sgm layout as ``params_to_ldm`` gives it; SD 2.x with the
    OpenCLIP tower (``cond_stage_model.model.*``, fused in_proj) in place of
    the HF-CLIP keys."""
    from sdtpu_torch.io import safetensors as st
    from sdtpu_torch.io.params import jax_layout
    from sdtpu_torch.io.weights import params_to_ldm, tree_to_openclip_text

    dt = ctx.cfg.compute_dtype
    sd = params_to_ldm(ctx.params, ctx.cfg, dtype=dt)
    if ctx.cfg.clip2 is None:
        sd = {k: v for k, v in sd.items()
              if not k.startswith("cond_stage_model.")}
        sd.update({k: v.detach().to("cpu", dt).contiguous()
                   for k, v in tree_to_openclip_text(
                       jax_layout(ctx.params)["clip"]).items()})
    t0 = time.perf_counter()
    st.save_file(sd, path)
    del sd
    return time.perf_counter() - t0


def family_checkpoint(ctx, name, root, want):
    """The demo tree written as a BF16 LDM file in the family's naming and
    served by ``Context(model_dir=)`` under ``cuda``: the demo Context's
    bytes at the seed and its pins. Returns the phase's numbers."""
    d = os.path.join(root, name)
    os.makedirs(d)
    path = os.path.join(d, f"{name}-demo.safetensors")
    t0 = time.perf_counter()
    write_s = ldm_family_file(ctx, path)
    res = {"write_s": write_s, "export_and_write_s": time.perf_counter() - t0,
           "bytes": os.path.getsize(path)}
    c = family_context(name, model_dir=d, kernels="cuda")
    res["init_s"] = c.init_seconds
    img, launches, _ = family_image(c, name, "cuda")
    release(c)
    shutil.rmtree(d, ignore_errors=True)
    if not np.array_equal(img, want):
        raise AssertionError(f"{name}: the loaded checkpoint gave other "
                             f"bytes than the demo weights")
    res["launches_per_image"] = launches
    res["identical"] = True
    return res


def phase_families(smi):
    """SD 2.1 (768x768, v-prediction), SD 2.1-base and SDXL (1024x1024) at
    full width with demo weights, 20 DPM-Solver++(2M) steps, CFG 7.5, batch
    1, bf16 (module docstring, item 14). Returns the kernel rows at the
    families' sites and the launches per image."""
    from sdtpu_torch.quant.ptq import calibrate

    start = time.perf_counter()
    root = tempfile.mkdtemp(prefix="sdtpu-family-")
    out = {"rows": {}, "launches": {}}
    try:
        # SDXL: the policies on one Context, timed one image each
        xl = family_context("sdxl", kernels="cuda")
        res = {"phase": "family", "config": "sdxl", "nvidia_smi": smi,
               "init_s": xl.init_seconds}
        sites_xl = family_sites(xl, "sdxl")
        imgs, first = {}, {}
        for policy in POLICIES:
            xl.kernels = policy
            imgs[policy], out["launches"][f"sdxl_{policy}"], first[
                policy] = family_image(xl, "sdxl", policy)
        # one image a policy in each turn, the turns in opposite orders
        times = {k: [] for k in POLICIES}
        for k in POLICIES[::-1] + POLICIES:
            xl.kernels = k
            t0 = time.perf_counter()
            xl.generate(PROMPT, guidance=7.5, seed=9)
            times[k].append(time.perf_counter() - t0)
        xl.kernels = "cuda"
        by_name, kernels, wall_ms = device_profile(
            lambda: xl.generate(PROMPT, guidance=7.5, seed=5))
        busy = sum(by_name.values())
        res.update({
            "first_image_s": first,
            "s_per_image": {k: statistics.median(v)
                            for k, v in times.items()},
            "image_s": times, "device_busy_ms": busy,
            "device_kernels": kernels, "profiled_wall_ms": wall_ms,
            "device_idle_share": 1.0 - busy / wall_ms,
            "flash_ms": sum(v for k, v in by_name.items()
                            if "flash_fwd_kernel" in k),
            "top_kernels_ms": [[k[:90], v] for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]]})
        held = unet_errors_held(xl, res, "sdxl")
        res["checkpoint"] = family_checkpoint(xl, "sdxl", root, imgs["cuda"])
        release(xl)
        del xl
        emit(res)
        res = {"phase": "family_quant", "config": "sdxl", "nvidia_smi": smi,
               "unet_plain_rel_err": res["unet_plain_rel_err"]}
        # the quantized modes, one Context each, K4 and K5
        xd = family_context("sdxl", kernels="cuda", quantize="int8w_dense")
        _, out["launches"]["sdxl_int8w_dense"], res[
            "first_image_s_int8w_dense"] = family_image(xd, "sdxl",
                                                        "int8w_dense")
        quant_error(xd, held, res, "sdxl")
        release(xd)
        xi = family_context("sdxl", kernels="cuda", quantize="int8")
        t0 = time.perf_counter()
        xi.params = calibrate(xi.params, xi.cfg, CALIB_PROMPTS, xi.tokenizer,
                              steps=2)
        res["calibrate_s"] = time.perf_counter() - t0
        with w8a8_kernel(True):
            _, out["launches"]["sdxl_int8+k5"], res[
                "first_image_s_int8+k5"] = family_image(xi, "sdxl",
                                                        "int8+k5")
        quant_error(xi, held, res, "sdxl", "int8+k5", True)
        release(xi)
        del held
        torch.cuda.empty_cache()
        emit(res)

        # SD 2.1 768-v: cuda, cuda_conv, and heun's second-eval conversion
        sd2 = family_context("sd21", kernels="cuda")
        res = {"phase": "family", "config": "sd21", "nvidia_smi": smi,
               "init_s": sd2.init_seconds}
        sites_sd2 = family_sites(sd2, "sd21")
        imgs = {}
        for policy in ("cuda", "cuda_conv"):
            sd2.kernels = policy
            imgs[policy], out["launches"][f"sd21_{policy}"], _ = \
                family_image(sd2, "sd21", policy)
        sd2.kernels, sd2.sampler = "cuda", "heun"
        _, out["launches"]["sd21_heun"], _ = family_image(sd2, "sd21",
                                                          "heun")
        sd2.sampler = "dpm"
        times = []
        t0 = time.perf_counter()
        sd2.generate(PROMPT, guidance=7.5, seed=9)
        times.append(time.perf_counter() - t0)
        res.update({"s_per_image_cuda": statistics.median(times),
                    "image_s": times})
        unet_errors_held(sd2, res, "sd21")
        res["checkpoint"] = family_checkpoint(sd2, "sd21", root,
                                              imgs["cuda"])
        release(sd2)
        del sd2
        emit(res)

        base = family_context("sd21base", kernels="cuda")
        _, out["launches"]["sd21base_cuda"], first_base = family_image(
            base, "sd21base", "cuda")
        t0 = time.perf_counter()
        base.generate(PROMPT, guidance=7.5, seed=9)
        emit({"phase": "family", "config": "sd21base", "nvidia_smi": smi,
              "init_s": base.init_seconds, "first_image_s": first_base,
              "image_s": time.perf_counter() - t0})
        release(base)
        del base
        torch.cuda.empty_cache()

        out["rows"]["sdxl"] = family_kernel_rows("sdxl", sites_xl)
        out["rows"]["sd21"] = family_kernel_rows("sd21", sites_sd2)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "families_done", "seconds": time.perf_counter() - start})
    return out


# the knobs phase: SD1.5 at KNOB_STEPS steps, launches per image of each
# kernel in each arm, derived from the port's own denoising loop run on the
# meta device with the kernel wrappers recorded
# (tests/test_torch_hopper.py::test_knob_pins_are_the_rules):
#   flash: 10 an eval and the VAE's mid block. ToMe 0.5 merges the five
#     64x64 self-attentions to 2,048 tokens (still the kernel); ToMe 0.3
#     to 2,868 (not a multiple of 128: the plain path), 5 an eval left.
#     DeepCache 3 runs full evals at steps 0, 3, 6 and shallow ones (the
#     64x64 level's 2 down and 3 up transformers, its 6 + 9 fused convs)
#     at the other 5. PAG at ("mid",) adds an eval of the cond rows a step
#     (10 more), at ("down", "up") one whose self-attentions are identity
#     (none); the interval's unguided steps run the cond rows alone (10);
#     size=768 takes the 96^2 and 48^2 levels (9,216 and 2,304 tokens) and
#     the 96^2 VAE mid block;
#   int8w_dense with ToMe and PAG: K4 at the 228 sites of a CFG eval and the
#     226 of the perturbed one (the mid block's q and k skipped), 301 of
#     them a step splitting K (ToMe halves M at the 64x64 attn1 sites, the
#     batch-1 eval everywhere)
KNOB_STEPS = 8
KNOB_SEED = 37
#: label -> (Context keywords, generate keywords, mode). tome_ratio and
#: deepcache alone are set on the shared Context of the mode
#: (set_tome_ratio, set_deepcache); every other arm builds its own Context
KNOB_ARMS = {
    "tome_0.5": ({"tome_ratio": 0.5}, {}, "cuda"),
    "tome_0.3": ({"tome_ratio": 0.3}, {}, "cuda"),
    "deepcache_3": ({"deepcache": 3}, {}, "cuda"),
    "pag_mid": ({}, {"pag_scale": 3.0}, "cuda"),
    "pag_down_up": ({"pag_layers": ("down", "up")}, {"pag_scale": 3.0},
                    "cuda"),
    "cfg_interval": ({"cfg_interval": (0.2, 0.8)}, {}, "cuda"),
    "guidance_rescale": ({"guidance_rescale": 0.7}, {}, "cuda"),
    "freeu": ({"freeu": (1.5, 1.6, 0.9, 0.2)}, {}, "cuda"),
    "size_768": ({"size": 768}, {}, "cuda"),
    "fuse_qkv": ({"fuse_qkv": True}, {}, "cuda"),
    "deepcache_3_cuda_conv": ({"deepcache": 3}, {}, "cuda_conv"),
    "tome_pag_int8w_dense": ({"tome_ratio": 0.5}, {"pag_scale": 3.0},
                             "int8w_dense"),
}
KNOB_SETTABLE = ("tome_ratio", "deepcache")
KNOB_FLASH = 10 * KNOB_STEPS + 1
KNOB_SHALLOW = 5
KNOBS_PINNED = {
    "tome_0.5": pins(flash=KNOB_FLASH),
    "tome_0.3": pins(flash=5 * KNOB_STEPS + 1),
    "deepcache_3": pins(flash=10 * 3 + 5 * KNOB_SHALLOW + 1),
    "pag_mid": pins(flash=20 * KNOB_STEPS + 1),
    "pag_down_up": pins(flash=KNOB_FLASH),
    "cfg_interval": pins(flash=KNOB_FLASH),
    "guidance_rescale": pins(flash=KNOB_FLASH),
    "freeu": pins(flash=KNOB_FLASH),
    "size_768": pins(flash=KNOB_FLASH),
    "fuse_qkv": pins(flash=KNOB_FLASH),
    "deepcache_3_cuda_conv": pins(flash=10 * 3 + 5 * KNOB_SHALLOW + 1,
                                  group_norm_affine=60 * 3 + 15 * 5 + 28,
                                  conv=60 * 3 + 15 * 5 + 28),
    "tome_pag_int8w_dense": pins(flash=20 * KNOB_STEPS + 1,
                                 matmul_int8w=(228 + 226) * KNOB_STEPS,
                                 matmul_int8w_sum=301 * KNOB_STEPS),
}
#: the A/B's arms, in turns there and back: the knob off and three that
#: cut the work of an image
KNOB_AB = ("off", "tome_0.5", "deepcache_3", "cfg_interval")

# the adapters phase: SD1.5 at 512^2, ADAPTER_STEPS DPM-Solver++(2M) steps,
# CFG 7.5, demo weights, launches per call of each kernel in each arm,
# derived on the meta device from the port's own loop and the rules
# (tests/test_torch_hopper.py::test_adapter_pins_are_the_rules):
#   a ControlNet's encoder copy runs beside every UNet eval, on its CFG
#     batch: K1 at its 4 self-attentions of 4,096 and 1,024 tokens (its
#     256-token level and 64-token mid block take the plain path), K2 at its
#     27 GroupNorms (10 ResBlocks x 2, 7 transformers), K3 and K2's
#     statistics mode at its 27 fused convs (20 ResBlock convs, 7 proj_in);
#     the hint network's and the zero convs are cuDNN convs; it stays bf16
#     under int8w_dense (no K4); two ControlNets run two copies;
#   a LoRA at every attention projection, feed-forward product and
#     proj_in/proj_out (and the text tower's sites) leaves K1, K2, K4 and K5
#     as they are (its delta is two library products beside each site) and
#     launches K3 a second time at each of the 16 proj_in convs it adapts
#     (the delta's down conv, Cout the rank): 76 K3 launches an eval, the
#     statistics mode's 60; the LoCon adapts the 44 ResBlock convs too: 120;
#   SDXL at 1024^2, ADAPTER_XL_STEPS steps: its ControlNet's 4 self-attentions
#     at 4,096 tokens (level 1, depth 2) and 30 at 1,024 (level 2 and the mid
#     block, depth 10) beside the UNet's 70: 104 an eval
ADAPTER_STEPS = 8
ADAPTER_XL_STEPS = 4
ADAPTER_SEED = 43
ADAPTER_RANK = 16
ADAPTER_CN_FLASH = (10 + 4) * ADAPTER_STEPS + 1
ADAPTER_FLASH = 10 * ADAPTER_STEPS + 1
#: arm -> (mode, the adapter: "cn" one ControlNet, "cn2" two, "cn0" one at
#: control_scale 0, "kohya" or "npz" a LoRA, "base" lora="")
ADAPTER_ARMS = {
    "cn_cuda": ("cuda", "cn"), "cn_cuda_gn": ("cuda_gn", "cn"),
    "cn_cuda_conv": ("cuda_conv", "cn"),
    "cn_int8w_dense": ("int8w_dense", "cn"), "cn_two": ("cuda", "cn2"),
    "cn_scale_0": ("cuda", "cn0"),
    "kohya_cuda": ("cuda", "kohya"), "kohya_cuda_conv": ("cuda_conv", "kohya"),
    "kohya_int8w_dense": ("int8w_dense", "kohya"),
    "kohya_int8+k5": ("int8+k5", "kohya"),
    "npz_cuda": ("cuda", "npz"), "npz_cuda_conv": ("cuda_conv", "npz"),
    "npz_int8w_dense": ("int8w_dense", "npz"),
    "npz_int8+k5": ("int8+k5", "npz"),
    "locon_cuda_conv": ("cuda_conv", "locon"),
    "lora_base": ("cuda", "base"),
}


def _lora_pins(mode, adapted=16):
    """A LoRA arm's pins: K3 takes the UNet's 60 GroupNorm-conv sites an
    eval (44 ResBlock convs, 16 proj_in) and the decoder's 28, and a second
    launch at each of the ``adapted`` LoRA'd ones (16 proj_in; a LoCon's
    60), the statistics mode one a site."""
    return {"cuda": pins(flash=ADAPTER_FLASH),
            "cuda_conv": pins(flash=ADAPTER_FLASH,
                              group_norm_affine=60 * ADAPTER_STEPS + 28,
                              conv=(60 + adapted) * ADAPTER_STEPS + 28),
            "int8w_dense": pins(
                flash=ADAPTER_FLASH,
                matmul_int8w=MM_INT8W_PER_EVAL * ADAPTER_STEPS,
                matmul_int8w_sum=MM_INT8W_SUMS_PER_EVAL * ADAPTER_STEPS),
            "int8+k5": pins(
                flash=ADAPTER_FLASH,
                matmul_w8a8=MM_W8A8_PER_EVAL * ADAPTER_STEPS,
                matmul_w8a8_sum=MM_W8A8_SUMS_PER_EVAL * ADAPTER_STEPS)}[mode]


# K1 at 8 steps: 113 with a ControlNet (10 + 4 an eval and the decoder's
# mid block), 145 with two, 81 with a LoRA; K2 704 (88 an eval) with a
# ControlNet under cuda_gn; K3 724 (87 an eval and the decoder's 28) with
# one under cuda_conv, 636 (76 an eval) with the LoRA, 988 (120) with the
# LoCon; K4 1,824 under int8w_dense either way; K5 680 with the LoRA;
# SDXL with a ControlNet at 4 steps K1 417 ((70 + 34) an eval + 1)
ADAPTER_PINNED = {
    "cn_cuda": pins(flash=ADAPTER_CN_FLASH),
    "cn_cuda_gn": pins(flash=ADAPTER_CN_FLASH,
                       group_norm=(61 + 27) * ADAPTER_STEPS),
    "cn_cuda_conv": pins(flash=ADAPTER_CN_FLASH,
                         group_norm_affine=(60 + 27) * ADAPTER_STEPS + 28,
                         conv=(60 + 27) * ADAPTER_STEPS + 28),
    "cn_int8w_dense": pins(
        flash=ADAPTER_CN_FLASH,
        matmul_int8w=MM_INT8W_PER_EVAL * ADAPTER_STEPS,
        matmul_int8w_sum=MM_INT8W_SUMS_PER_EVAL * ADAPTER_STEPS),
    "cn_two": pins(flash=(10 + 2 * 4) * ADAPTER_STEPS + 1),
    "cn_scale_0": pins(flash=ADAPTER_CN_FLASH),
    **{arm: _lora_pins(mode) for arm, (mode, kind) in ADAPTER_ARMS.items()
       if kind in ("kohya", "npz")},
    "locon_cuda_conv": _lora_pins("cuda_conv", 60),
    "lora_base": pins(flash=ADAPTER_FLASH),
    "cn_sdxl": pins(flash=(70 + 34) * ADAPTER_XL_STEPS + 1),
}

IMAGE_SEED = 29
IMAGE_STRENGTH = 0.6
DEPTH_STRENGTH = 0.8


def image_inputs(size, seed=IMAGE_SEED):
    """A fixed-seed random uint8 image [size, size, 3], a uint8 mask that
    repaints its central square and a depth map (a ramp with noise)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    mask = np.zeros((size, size), np.uint8)
    mask[size // 4: 3 * size // 4, size // 4: 3 * size // 4] = 255
    depth = (np.linspace(1.0, 20.0, size, dtype=np.float32)[:, None]
             + rng.random((size, size), dtype=np.float32))
    return img, mask, depth


def checked_call(ctx, run, want, what, seed, scale=1):
    """One call ``run(seed=, output=)`` on ``ctx``: a uint8 [S, S, 3] image
    (S the Context's size x ``scale``), not constant, with every kernel's
    launches at ``want``; then the same seed's latents, finite, whose
    decode must give the same bytes. Returns (image, launches, the call's
    seconds, latents)."""
    from sdtpu_torch.engine import pipeline

    reset_counts()
    t0 = time.perf_counter()
    img = run(seed=seed, output="image")
    seconds = time.perf_counter() - t0
    launches = counts()
    check_image(img, ctx.cfg.image_size * scale)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    lat = run(seed=seed, output="latent")
    if not np.isfinite(lat).all():
        raise AssertionError(f"{what}: latents not finite")
    with torch.inference_mode():
        again = pipeline.decode_latents(
            ctx.params, torch.from_numpy(lat[None]).to("cuda"), ctx.cfg,
            ctx.kernels)[0].cpu().numpy()
    if not np.array_equal(img, again):
        raise AssertionError(f"{what}: the same seed gave other bytes")
    return img, launches, seconds, lat


def image_call(ctx, call, mode, run, scale=1):
    """One image-conditioned call (``checked_call``, held to
    ``IMAGE_PINNED[call][mode]``). Returns (image, launches, seconds)."""
    img, launches, seconds, lat = checked_call(
        ctx, run, IMAGE_PINNED[call][mode], f"{call} {mode}", IMAGE_SEED,
        scale)
    emit({"phase": "image_call", "call": call, "mode": mode,
          "size": ctx.cfg.image_size * scale, "kernels": ctx.kernels,
          "quantize": ctx.quantize, "seconds": seconds,
          "launches_per_image": launches, "identical": True,
          "latent_abs_max": float(np.abs(lat).max()),
          "image_mean": float(img.mean()), "image_std": float(img.std())})
    return img, launches, seconds


def phase_image(ctx, ctx_d, smi):
    """Image-conditioned serving on SD1.5 at full width (module docstring,
    item 15): img2img under cuda, cuda_gn and cuda_conv, inpaint,
    hires_fix(scale=2), img2img_batch of 3 requests (a batch of one against
    img2img) and img2img under ``quantize="int8w_dense"`` on ``ctx_d``, each
    with its pins; the encoder's device ms; s/image of img2img against
    generate under cuda, in turns. Returns the launches per call."""
    from sdtpu_torch.engine import pipeline

    size = ctx.cfg.image_size
    img, mask, _ = image_inputs(size)
    res = {"phase": "image", "nvidia_smi": smi, "strength": IMAGE_STRENGTH}
    launches, seconds = {}, {}

    def img2img(c):
        return lambda **kw: c.img2img(PROMPT, img, strength=IMAGE_STRENGTH,
                                      guidance=7.5, **kw)

    for policy in ("cuda", "cuda_gn", "cuda_conv"):
        ctx.kernels = policy
        out, launches[f"img2img_{policy}"], seconds[
            f"img2img_{policy}"] = image_call(ctx, "img2img", policy,
                                              img2img(ctx))
        if policy == "cuda":
            alone = out
    ctx.kernels = "cuda"
    _, launches["inpaint_cuda"], seconds["inpaint_cuda"] = image_call(
        ctx, "inpaint", "cuda",
        lambda **kw: ctx.inpaint(PROMPT, img, mask, guidance=7.5, **kw))
    _, launches["hires_cuda"], seconds["hires_cuda"] = image_call(
        ctx, "hires", "cuda", lambda **kw: ctx.hires_fix(
            PROMPT, scale=2, strength=IMAGE_STRENGTH, guidance=7.5, **kw),
        scale=2)
    _, launches["img2img_int8w_dense"], seconds[
        "img2img_int8w_dense"] = image_call(ctx_d, "img2img", "int8w_dense",
                                            img2img(ctx_d))
    # batched img2img: three requests (padded to four), then one
    reqs = [{**r, "image": np.roll(img, 37 * i, axis=1)}
            for i, r in enumerate(BATCH_REQUESTS)]
    reset_counts()
    outs = ctx.img2img_batch(reqs, strength=IMAGE_STRENGTH)
    launches["img2img_batch_cuda"] = counts()
    for o in outs:
        check_image(o, size)
    if launches["img2img_batch_cuda"] != IMAGE_PINNED["img2img"]["cuda"]:
        raise AssertionError(f"img2img_batch: launches "
                             f"{launches['img2img_batch_cuda']}")
    one = ctx.img2img_batch([{"prompt": PROMPT, "image": img,
                              "seed": IMAGE_SEED, "guidance": 7.5}],
                            strength=IMAGE_STRENGTH)[0]
    res["batch_of_one_identical"] = bool(np.array_equal(one, alone))
    # the encoder alone, device time (CUDA-graph replays), under the
    # policies that change it
    x = ctx._image_tensor(img[None]).to(ctx.cfg.compute_dtype)
    with torch.inference_mode():
        for policy in ("cuda", "cuda_conv"):
            res[f"encoder_ms_{policy}"] = cuda_ms(
                lambda: pipeline._encode_init_latents(ctx.params, x, ctx.cfg,
                                                      policy), 2, 3)
    times = {"generate": [], "img2img": []}
    for k in ("generate", "img2img", "img2img", "generate"):
        t0 = time.perf_counter()
        if k == "generate":
            ctx.generate(PROMPT, guidance=7.5, seed=9)
        else:
            ctx.img2img(PROMPT, img, strength=IMAGE_STRENGTH, seed=9)
        times[k].append(time.perf_counter() - t0)
    res.update({"launches": launches, "first_call_s": seconds,
                "s_per_image": {k: statistics.mean(v)
                                for k, v in times.items()},
                "image_s": times})
    emit(res)
    if not res["batch_of_one_identical"]:
        raise AssertionError("img2img_batch of one differs from img2img")
    return launches


def phase_image_kernels(ctx):
    """K1-K5 at every image-conditioned site, against their plain versions
    with the existing tolerances (``kernel_image_*``): the hires pass (one
    SD1.5 UNet eval at a 128^2 grid x 12, the 1024^2 decode), ip2p's UNet
    batch of 3 (x 20; its K2 and K3 sites are the 4-channel UNet's at N =
    3: conv_in is a cuDNN conv) and the VAE encoder at 512^2, each with
    launches per image. Returns {group: {kernel: rows}}."""
    from sdtpu_torch.models import unet, vae

    cfg = ctx.cfg
    dt = cfg.compute_dtype
    g = torch.Generator(device="cuda").manual_seed(12)

    def inputs(n, size):
        x = torch.randn((n, size, size, 4), generator=g,
                        device="cuda").to(dt)
        te = torch.randn((n, cfg.unet.time_embed_dim), generator=g,
                         device="cuda").to(dt)
        c = torch.randn((n, cfg.clip.context_len, cfg.unet.context_dim),
                        generator=g, device="cuda").to(dt)
        return x, te, c

    def unet_run(args):
        return lambda k: unet.apply(ctx.params["unet"], *args, cfg.unet, k)

    hires_in = inputs(2, 2 * cfg.latent_size)
    ip2p_in = inputs(3, cfg.latent_size)
    z = torch.randn((1, 2 * cfg.latent_size, 2 * cfg.latent_size, 4),
                    generator=g, device="cuda").to(dt)
    img = (torch.rand((1, cfg.image_size, cfg.image_size, 3), generator=g,
                      device="cuda") * 2 - 1).to(dt)
    groups = {
        "hires": (record_sites([
            (IMAGE_EVALS, unet_run(hires_in)),
            (1, lambda k: vae.apply(ctx.params["vae"], z, cfg.vae, k))]),
            record_mm_sites(ctx, *hires_in, IMAGE_EVALS), 2),
        "ip2p": (record_sites([(STEPS, unet_run(ip2p_in))]),
                 record_mm_sites(ctx, *ip2p_in, STEPS), 3),
        "encoder": (record_sites([(1, lambda k: vae.apply_encoder(
            ctx.params["vae_enc"], img, cfg.vae, k))]), None, 1)}
    out = {}
    for name, (sites, mm, unet_n) in groups.items():
        label = f"kernel_image_{name}"
        emit({"phase": f"sites_image_{name}", **{
            k: sum(v.values()) for k, v in sites.items()}})
        rows = {"flash": phase_kernel(
            sorted(sites["flash"]), [], label, per_image=sites["flash"])}
        if sites["group_norm"]:
            rows["group_norm"] = phase_kernel_gn(sites["group_norm"], [],
                                                 f"{label}_gn")
        affine = sum(n for k, n in sites["conv"].items() if k[3])
        rows["group_norm_affine"] = phase_kernel_gn_affine(
            sites["conv"], [], f"{label}_gn_affine", affine)
        rows["conv"] = phase_kernel_conv(sites["conv"], [], unet_n,
                                         f"{label}_conv", int8=False)
        if mm is not None:
            rows.update(phase_kernel_mm(mm, [], f"{label}_mm"))
        out[name] = rows
    return out


def phase_concat(smi):
    """The concat-conditioned families at full width with demo weights
    (module docstring, item 16): sd15_inpaint and sd15_ip2p at 20 steps
    under cuda and cuda_conv, sd2_depth at 20 steps under cuda,
    sd21_inpaint and sdxl_inpaint at 4 steps under cuda (their kernel
    sites, not a speed measure). Each call with its pins, the same bytes
    from the same seed and finite latents. Returns the launches."""
    from sdtpu_torch import Context

    start = time.perf_counter()
    launches = {}
    for name, steps, policies in (
            ("sd15_inpaint", STEPS, ("cuda", "cuda_conv")),
            ("sd15_ip2p", STEPS, ("cuda", "cuda_conv")),
            ("sd2_depth", STEPS, ("cuda",)),
            ("sd21_inpaint", IMAGE_STEPS_XL, ("cuda",)),
            ("sdxl_inpaint", IMAGE_STEPS_XL, ("cuda",))):
        c = Context(config=name, steps=steps, device="cuda", kernels="cuda")
        img, mask, depth = image_inputs(c.cfg.image_size)
        run = {
            "depth": lambda **kw: c.depth2img(
                PROMPT, img, depth, strength=DEPTH_STRENGTH, guidance=7.5,
                **kw),
            "ip2p": lambda **kw: c.instruct_pix2pix(
                "make it a watercolor", img, guidance=7.5,
                image_guidance=1.5, **kw),
        }.get(name.split("_")[-1], lambda **kw: c.inpaint(
            PROMPT, img, mask, guidance=7.5, **kw))
        res = {"phase": "concat", "config": name, "steps": steps,
               "nvidia_smi": smi, "init_s": c.init_seconds}
        for policy in policies:
            c.kernels = policy
            _, launches[f"{name}_{policy}"], res[f"s_{policy}"] = \
                image_call(c, name, policy, run)
        emit(res)
        release(c)
        del c
    emit({"phase": "concat_done", "seconds": time.perf_counter() - start})
    return launches


# ---------------------------------------------------------------------------
# the staged configurations at full width: LCM, the SDXL two-stage call,
# the x4 upscaler
# ---------------------------------------------------------------------------

STAGE_SEED = 41
LCM_GUIDANCE = 8.0
#: three LCM requests with their own seed and guidance, padded to four
LCM_REQUESTS = [
    {"prompt": PROMPT, "seed": 41, "guidance": LCM_GUIDANCE},
    {"prompt": "a watercolor of a lighthouse at dusk", "seed": 42,
     "guidance": 4.0},
    {"prompt": "a vintage car on a coastal road", "seed": 43,
     "guidance": 1.5}]
X4_NOISE_LEVEL = 20
X4_LOW_RES = 128


def stage_context(name, **kw):
    from sdtpu_torch import Context

    return Context(config=name, device="cuda", **kw)


@contextlib.contextmanager
def unet_rows(log):
    """The batch of every UNet eval of a block, appended to ``log``."""
    from sdtpu_torch.models import unet

    real = unet.apply

    def apply(params, x, *args, **kwargs):
        log.append(x.shape[0])
        return real(params, x, *args, **kwargs)

    unet.apply = apply
    try:
        yield
    finally:
        unet.apply = real


def stage_profile(run, res):
    """s/image of ``run`` (two calls, the mean) and its device busy ms,
    device kernels and idle share (torch.profiler, a third call), into
    ``res``."""
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    by_name, kernels, wall_ms = device_profile(run)
    busy = sum(by_name.values())
    res.update({"s_per_image": statistics.mean(times), "image_s": times,
                "device_busy_ms": busy, "device_kernels": kernels,
                "profiled_wall_ms": wall_ms,
                "device_idle_share": 1.0 - busy / wall_ms})


def unet_errors_held(ctx, res, label):
    """``family_unet_errors`` of ``ctx`` into ``res`` (every policy within
    ``MODEL_FACTOR`` of the plain bf16 path's error), and the float32
    reference to hold a quantized Context to."""
    errs, held = family_unet_errors(ctx)
    res.update(errs)
    for k in POLICIES[1:]:
        if not (errs[f"unet_{k}_finite"] and errs[f"unet_{k}_rel_err"]
                <= MODEL_FACTOR * errs["unet_plain_rel_err"]):
            emit(res)
            raise AssertionError(f"{label} UNet under {k} off the float32 "
                                 f"run: {errs}")
    return held


def quant_error(c, held, res, label, mode="int8w_dense", flag=False):
    """The quantized Context ``c``'s UNet (``KERNEL_W8A8`` = ``flag``)
    against the float32 reference ``held``, into ``res``: under
    ``QUANT_REL_ERR_MAX`` (random weights: garbage only is caught)."""
    res[f"unet_{mode}_finite"], res[f"unet_{mode}_rel_err"] = \
        quant_unet_error(c, flag, held)
    if not (res[f"unet_{mode}_finite"]
            and res[f"unet_{mode}_rel_err"] <= QUANT_REL_ERR_MAX):
        emit(res)
        raise AssertionError(f"{label} UNet under {mode} is garbage: {res}")


def stage_sites(ctx, n, evals):
    """K1-K5's call shapes in ``evals`` UNet evals of ``ctx`` at a batch of
    ``n``, with launches per call (``record_sites``,
    ``record_mm_sites``). The decoders' sites are the families' (SDXL's)
    and the main path's."""
    from sdtpu_torch.models import unet

    cfg = ctx.cfg
    x, te, context = (t[:n] for t in unet_inputs(cfg, 14, n))
    return (record_sites([(evals, lambda k: unet.apply(
        ctx.params["unet"], x, te, context, cfg.unet, k))]),
        record_mm_sites(ctx, x, te, context, evals))


def phase_stage_lcm(smi):
    """LCM (``sd15_lcm``) at ``LCM_STEPS`` lcm steps, guidance 8 embedded,
    under cuda and cuda_conv: one image and a ``generate_batch`` of
    ``LCM_REQUESTS`` (three guidances, padded to four), each with its pins
    and one UNet row a request; the same bytes from the same seed, finite
    latents; each request's latents in the batch against its run alone
    within ``BATCH_GAP_FACTOR`` times its own gap between bf16 and float32;
    s/image, device busy ms, the UNet against float32 under each policy
    and under int8w_dense. Returns (launches, kernel sites)."""
    from sdtpu_torch.quant.ptq import quantize_weights_only

    c = stage_context("sd15_lcm", sampler="lcm", steps=LCM_STEPS,
                      kernels="cuda")
    res = {"phase": "stage", "config": "sd15_lcm", "nvidia_smi": smi,
           "init_s": c.init_seconds, "steps": LCM_STEPS}
    launches = {}
    for policy in ("cuda", "cuda_conv"):
        c.kernels = policy
        rows = []
        with unet_rows(rows):
            _, launches[f"lcm_{policy}"], res[f"first_image_s_{policy}"], _ = \
                checked_call(c, lambda **kw: c.generate(
                    PROMPT, guidance=LCM_GUIDANCE, **kw),
                    STAGES_PINNED["lcm"][policy], f"sd15_lcm {policy}",
                    STAGE_SEED)
        reset_counts()
        with unet_rows(rows):
            imgs = c.generate_batch(LCM_REQUESTS)
        launches[f"lcm_batch_{policy}"] = counts()
        for img in imgs:
            check_image(img, c.cfg.image_size)
        if launches[f"lcm_batch_{policy}"] != STAGES_PINNED["lcm_batch"][
                policy]:
            raise AssertionError(f"sd15_lcm batch {policy}: launches "
                                 f"{launches[f'lcm_batch_{policy}']}")
        res[f"unet_rows_{policy}"] = sorted(set(rows))
        if set(rows) != {1, 4}:
            raise AssertionError(f"sd15_lcm {policy}: UNet rows {rows}, "
                                 f"expected one a request")
    c.kernels = "cuda"
    in_batch = c.generate_batch(LCM_REQUESTS, output="latent")
    alone = latents_alone(c, LCM_REQUESTS)
    lat32 = float32_latents(c, LCM_REQUESTS)
    scale = [float(np.abs(r).max()) for r in lat32]
    own = [float(np.abs(a - r).max()) / m
           for a, r, m in zip(alone, lat32, scale)]
    gap = [float(np.abs(b - a).max()) / m
           for b, a, m in zip(in_batch, alone, scale)]
    r0 = LCM_REQUESTS[0]
    one = c.generate_batch([r0])[0]
    res.update({"batch_gap": gap, "bf16_gap": own,
                "batch_of_one_identical": bool(np.array_equal(
                    one, c.generate(r0["prompt"], guidance=r0["guidance"],
                                    seed=r0["seed"])))})
    stage_profile(lambda: c.generate(PROMPT, guidance=LCM_GUIDANCE, seed=9),
                  res)
    held = unet_errors_held(c, res, "sd15_lcm")
    quant_error(types.SimpleNamespace(
        params={"unet": quantize_weights_only(c.params["unet"],
                                              include_dense=True)},
        cfg=c.cfg, kernels="cuda"), held, res, "sd15_lcm")
    del held
    sites = stage_sites(c, 4, LCM_STEPS)
    release(c)
    emit(res)
    if not res["batch_of_one_identical"]:
        raise AssertionError("sd15_lcm: a batch of one differs from generate")
    if any(g > BATCH_GAP_FACTOR * o for g, o in zip(gap, own)):
        raise AssertionError(f"sd15_lcm: a request in the batch is off its "
                             f"run alone: {gap} against {own}")
    return launches, sites


def two_stage(base, ref, mode, res):
    """``base.generate(denoising_end=STAGE_END, output="latent")`` then
    ``ref.refine(denoising_start=STAGE_END)``, each with its pins; twice,
    the same latents and bytes from the same seed; finite latents, a
    1024^2 uint8 image. Returns the launches of each half."""
    out = []
    for _ in range(2):
        reset_counts()
        t0 = time.perf_counter()
        lat = base.generate(PROMPT, guidance=7.5, seed=STAGE_SEED,
                            denoising_end=STAGE_END, output="latent")
        l_base = counts()
        reset_counts()
        img = ref.refine(lat, PROMPT, guidance=7.5, seed=STAGE_SEED,
                         denoising_start=STAGE_END)
        res.setdefault(f"call_s_{mode}", []).append(
            time.perf_counter() - t0)
        out.append((lat, img, l_base, counts()))
    (lat, img, l_base, l_ref), (lat2, img2, _, _) = out
    if l_base != STAGES_PINNED["base"][mode] or (
            l_ref != STAGES_PINNED["refine"][mode]):
        raise AssertionError(f"two-stage {mode}: launches {l_base}, {l_ref}")
    check_image(img, ref.cfg.image_size)
    if not np.isfinite(lat).all():
        raise AssertionError(f"two-stage {mode}: latents not finite")
    if not (np.array_equal(lat, lat2) and np.array_equal(img, img2)):
        raise AssertionError(f"two-stage {mode}: the same seed gave other "
                             f"bytes")
    emit({"phase": "stage_call", "call": "two_stage", "mode": mode,
          "launches_base": l_base, "launches_refine": l_ref,
          "identical": True, "latent_abs_max": float(np.abs(lat).max()),
          "image_mean": float(img.mean()), "image_std": float(img.std())})
    return l_base, l_ref


def phase_stage_refiner(smi):
    """The SDXL two-stage call at 1024^2, ``STAGE_STEPS`` steps split at
    ``STAGE_END`` (``two_stage``), under cuda and cuda_conv on one pair of
    Contexts and under int8w_dense on another; ``refine`` at
    ``denoising_start=0`` from ``generate``'s own start latents against
    ``generate`` at 4 steps (the same bytes); s/image of the two-stage
    call, device busy ms; the refiner's UNet against float32 under each
    policy and under int8w_dense. Returns (launches, kernel sites)."""
    base = stage_context("sdxl", steps=STAGE_STEPS, kernels="cuda")
    ref = stage_context("sdxl_refiner", steps=STAGE_STEPS, kernels="cuda")
    res = {"phase": "stage", "config": "sdxl+sdxl_refiner",
           "nvidia_smi": smi, "init_s_base": base.init_seconds,
           "init_s_refiner": ref.init_seconds, "steps": STAGE_STEPS,
           "split": STAGE_SPLIT}
    launches = {}
    for policy in ("cuda", "cuda_conv"):
        base.kernels = ref.kernels = policy
        launches[f"base_{policy}"], launches[f"refine_{policy}"] = \
            two_stage(base, ref, policy, res)
    base.kernels = ref.kernels = "cuda"

    def call():
        lat = base.generate(PROMPT, guidance=7.5, seed=9,
                            denoising_end=STAGE_END, output="latent")
        ref.refine(lat, PROMPT, guidance=7.5, seed=9,
                   denoising_start=STAGE_END)

    stage_profile(call, res)
    ref.set_steps(4)
    want = ref.generate(PROMPT, guidance=7.5, seed=STAGE_SEED)
    noise = torch.randn((1, ref.cfg.latent_size, ref.cfg.latent_size,
                         ref.cfg.latent_channels), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(
                            STAGE_SEED))
    got = ref.refine(noise[0].cpu().numpy(), PROMPT, guidance=7.5,
                     seed=STAGE_SEED, denoising_start=0.0)
    res["refine_from_start_is_generate"] = bool(np.array_equal(got, want))
    ref.set_steps(STAGE_STEPS)
    release(base)
    held = unet_errors_held(ref, res, "sdxl_refiner")
    sites = stage_sites(ref, 2, STAGE_STEPS - STAGE_SPLIT)
    release(ref)
    bd = stage_context("sdxl", steps=STAGE_STEPS, kernels="cuda",
                       quantize="int8w_dense")
    rd = stage_context("sdxl_refiner", steps=STAGE_STEPS, kernels="cuda",
                       quantize="int8w_dense")
    launches["base_int8w_dense"], launches["refine_int8w_dense"] = \
        two_stage(bd, rd, "int8w_dense", res)
    quant_error(rd, held, res, "sdxl_refiner")
    del held
    release(bd, rd)
    emit(res)
    if not res["refine_from_start_is_generate"]:
        raise AssertionError("refine from generate's start latents at "
                             "denoising_start=0 differs from generate")
    return launches, sites


def phase_stage_x4(smi):
    """The x4 upscaler (``sd_x4``): a fixed-seed 128^2 uint8 image at noise
    level ``X4_NOISE_LEVEL`` to 512^2 at ``STAGE_STEPS`` steps, guidance 9,
    under cuda and cuda_conv and on a Context under int8w_dense
    (``checked_call``: the pins, K1's one launch in the f4 VAE's mid block
    among them, the same bytes, finite latents); s/image, device busy ms;
    the UNet against float32 under each policy and under int8w_dense.
    Returns (launches, kernel sites)."""
    c = stage_context("sd_x4", steps=STAGE_STEPS, kernels="cuda")
    low = image_inputs(X4_LOW_RES)[0]
    res = {"phase": "stage", "config": "sd_x4", "nvidia_smi": smi,
           "init_s": c.init_seconds, "steps": STAGE_STEPS,
           "noise_level": X4_NOISE_LEVEL}
    launches = {}

    def run(ctx):
        return lambda **kw: ctx.upscale(PROMPT, low,
                                        noise_level=X4_NOISE_LEVEL, **kw)

    for policy in ("cuda", "cuda_conv"):
        c.kernels = policy
        _, launches[f"x4_{policy}"], res[f"first_image_s_{policy}"], _ = \
            checked_call(c, run(c), STAGES_PINNED["x4"][policy],
                         f"sd_x4 {policy}", STAGE_SEED)
    c.kernels = "cuda"
    stage_profile(lambda: run(c)(seed=9), res)
    held = unet_errors_held(c, res, "sd_x4")
    sites = stage_sites(c, 2, STAGE_STEPS)
    release(c)
    cd = stage_context("sd_x4", steps=STAGE_STEPS, kernels="cuda",
                       quantize="int8w_dense")
    _, launches["x4_int8w_dense"], res["first_image_s_int8w_dense"], _ = \
        checked_call(cd, run(cd), STAGES_PINNED["x4"]["int8w_dense"],
                     "sd_x4 int8w_dense", STAGE_SEED)
    quant_error(cd, held, res, "sd_x4")
    del held
    release(cd)
    emit(res)
    return launches, sites


def phase_stages(smi):
    """The staged configurations (module docstring, item 18), then K1-K5
    at their new sites (``kernel_stages_*``): LCM's UNet at N = 4 (its
    batch; N = 1 is the knobs phase's), the refiner's and the x4 UNet at
    the CFG batch of 2, each against its plain version with the existing
    tolerances. Returns (launches, {group: {kernel: rows}})."""
    start = time.perf_counter()
    launches, groups = {}, {}
    for name, phase in (("lcm", phase_stage_lcm),
                        ("refiner", phase_stage_refiner),
                        ("x4", phase_stage_x4)):
        found, groups[name] = phase(smi)
        launches.update(found)
    emit({"phase": "stages_calls_done",
          "seconds": time.perf_counter() - start})
    rows = {}
    for name, unet_n in (("lcm", 4), ("refiner", 2), ("x4", 2)):
        sites, mm = groups[name]
        label = f"kernel_stages_{name}"
        emit({"phase": f"sites_stages_{name}", **{
            k: sum(v.values()) for k, v in sites.items()}})
        out = {}
        if sites["flash"]:      # the x4 UNet launches none
            out["flash"] = phase_kernel(sorted(sites["flash"]), [], label,
                                        per_image=sites["flash"])
        out["group_norm"] = phase_kernel_gn(sites["group_norm"], [],
                                            f"{label}_gn")
        affine = sum(n for k, n in sites["conv"].items() if k[3])
        out["group_norm_affine"] = phase_kernel_gn_affine(
            sites["conv"], [], f"{label}_gn_affine", affine)
        out["conv"] = phase_kernel_conv(sites["conv"], [], unet_n,
                                        f"{label}_conv", int8=False)
        out.update(phase_kernel_mm(mm, [], f"{label}_mm"))
        rows[name] = out
    emit({"phase": "stages_done", "seconds": time.perf_counter() - start})
    return launches, rows


def knob_context(shared, label):
    """(the Context arm ``label`` runs on, whether the arm built it): the
    shared Context of its mode with the settable knobs set, or a new
    SD1.5 Context with the arm's keywords."""
    from sdtpu_torch import Context

    ckw, _, mode = KNOB_ARMS[label]
    if set(ckw) <= set(KNOB_SETTABLE):
        c = shared[mode]
        c.kernels = "cuda_conv" if mode == "cuda_conv" else "cuda"
        c.set_tome_ratio(ckw.get("tome_ratio", 0))
        c.set_deepcache(ckw.get("deepcache", 0))
        return c, False
    return Context(config="sd15", steps=KNOB_STEPS, device="cuda",
                   kernels="cuda", **ckw), True


def phase_knobs(ctx, ctx_d, smi):
    """Each arm of ``KNOB_ARMS`` (module docstring, item 17) with its pins,
    the same bytes from the same seed and finite latents; then s/image and
    device busy ms of ``KNOB_AB`` in turns on the same weights. The shared
    Contexts get their steps, knobs and policy back. Returns the launches
    per arm."""
    shared = {"cuda": ctx, "cuda_conv": ctx, "int8w_dense": ctx_d}
    launches, seconds, keep = {}, {}, {}
    start = time.perf_counter()
    for c in (ctx, ctx_d):
        c.set_steps(KNOB_STEPS)
    try:
        for label, (_, gkw, mode) in KNOB_ARMS.items():
            c, own = knob_context(shared, label)
            img, launches[label], seconds[label], lat = checked_call(
                c, lambda **kw: c.generate(PROMPT, guidance=7.5, **gkw,
                                           **kw),
                KNOBS_PINNED[label], f"knobs {label}", KNOB_SEED)
            emit({"phase": "knob_arm", "arm": label, "mode": mode,
                  "steps": KNOB_STEPS, "size": c.cfg.image_size,
                  "seconds": seconds[label],
                  "init_s": c.init_seconds if own else None,
                  "launches_per_image": launches[label], "identical": True,
                  "latent_abs_max": float(np.abs(lat).max()),
                  "image_mean": float(img.mean()),
                  "image_std": float(img.std())})
            if label in KNOB_AB:
                keep[label] = c
            elif own:
                release(c)
        keep["off"] = ctx
        times = {k: [] for k in KNOB_AB}
        busy = {}
        for label in KNOB_AB + KNOB_AB[::-1]:
            c = keep[label]
            if c is ctx:
                ctx.kernels = "cuda"
                ctx.set_tome_ratio(0.5 if label == "tome_0.5" else 0)
                ctx.set_deepcache(3 if label == "deepcache_3" else 0)
            t0 = time.perf_counter()
            c.generate(PROMPT, guidance=7.5, seed=KNOB_SEED)
            times[label].append(time.perf_counter() - t0)
            if label not in busy:
                by_name, kernels, wall_ms = device_profile(
                    lambda: c.generate(PROMPT, guidance=7.5,
                                       seed=KNOB_SEED))
                busy[label] = {"device_busy_ms": sum(by_name.values()),
                               "device_kernels": kernels,
                               "profiled_wall_ms": wall_ms}
        emit({"phase": "knobs", "nvidia_smi": smi, "steps": KNOB_STEPS,
              "s_per_image": {k: statistics.mean(v)
                              for k, v in times.items()},
              "image_s": times, "profile": busy, "launches": launches,
              "first_call_s": seconds,
              "seconds": time.perf_counter() - start})
    finally:
        for c in (ctx, ctx_d):
            c.set_tome_ratio(0)
            c.set_deepcache(0)
            c.set_steps(STEPS)
            c.kernels = "cuda"
        release(*(c for c in keep.values() if c is not ctx))
    return launches


def phase_knob_kernels(ctx, main_sites, main_mm):
    """K1-K5 at every site the knobs make that the main path does not
    (``kernel_knobs_*``): one SD1.5 UNet eval with ToMe 0.5 at the CFG
    batch (x ``KNOB_STEPS``), one of the cond rows alone, as PAG's
    perturbed eval and the interval's unguided steps run it, and one at
    size=768 with its 96^2 decode; K2 and K3 at the batch-1 eval (the 96^2
    planes are SD 2.1 768's, held in the families phase), K4 and K5 at the
    ToMe and batch-1 GEMM rows of the UNet quantized on the card. Each
    against its plain version with the existing tolerances. Returns
    {kernel: rows}."""
    import dataclasses

    from sdtpu_torch.models import unet, vae

    cfg = ctx.cfg
    dt = cfg.compute_dtype
    g = torch.Generator(device="cuda").manual_seed(13)

    def inputs(n, size):
        return (torch.randn((n, size, size, 4), generator=g,
                            device="cuda").to(dt),
                torch.randn((n, cfg.unet.time_embed_dim), generator=g,
                            device="cuda").to(dt),
                torch.randn((n, cfg.clip.context_len, cfg.unet.context_dim),
                            generator=g, device="cuda").to(dt))

    tome = dataclasses.replace(cfg.unet, tome_ratio=0.5)
    two, one, big = inputs(2, 64), inputs(1, 64), inputs(2, 96)
    z = torch.randn((1, 96, 96, 4), generator=g, device="cuda").to(dt)
    p = ctx.params
    flash = {}
    for runs in (
            [(KNOB_STEPS, lambda k: unet.apply(p["unet"], *two, tome, k))],
            [(KNOB_STEPS, lambda k: unet.apply(p["unet"], *big, cfg.unet,
                                               k)),
             (1, lambda k: vae.apply(p["vae"], z, cfg.vae, k))]):
        for key, n in record_sites(runs)["flash"].items():
            flash[key] = flash.get(key, 0) + n
    batch1 = record_sites([(KNOB_STEPS, lambda k: unet.apply(
        p["unet"], *one, cfg.unet, k, perturb=("mid",)))])
    for key, n in batch1["flash"].items():
        flash[key] = flash.get(key, 0) + n

    def new(found, seen):
        return {k: v for k, v in found.items() if k not in seen}

    flash = new(flash, main_sites["flash"])
    gn = new(batch1["group_norm"], main_sites["group_norm"])
    conv = new(batch1["conv"], main_sites["conv"])
    emit({"phase": "sites_knobs", "flash": sorted(flash),
          "group_norm": len(gn), "conv": len(conv)})
    rows = {"flash": phase_kernel(sorted(flash), [], "kernel_knobs",
                                  per_image=flash),
            "group_norm": phase_kernel_gn(gn, [], "kernel_knobs_gn"),
            "group_norm_affine": phase_kernel_gn_affine(
                conv, [], "kernel_knobs_gn_affine",
                sum(n for k, n in conv.items() if k[3])),
            "conv": phase_kernel_conv(conv, [], 1, "kernel_knobs_conv",
                                      int8=False)}
    ctx.set_tome_ratio(0.5)
    try:
        merged = record_mm_sites(ctx, *two, KNOB_STEPS)
    finally:
        ctx.set_tome_ratio(0)
    alone = record_mm_sites(ctx, *one, KNOB_STEPS)
    mm = {label: new({**merged[label], **alone[label]}, main_mm[label])
          for label in ("int8w_dense", "int8+k5")}
    rows.update(phase_kernel_mm(mm, [], "kernel_knobs_mm"))
    return rows


def lora_site(name: str, locon: bool = False) -> bool:
    """The kohya sites the phase's LoRA takes: every attention projection,
    both feed-forward products, proj_in and proj_out in the UNet, and every
    site of the text tower(s); with ``locon`` also each ResBlock's two 3x3
    convs (LDM ``in_layers.2``, ``out_layers.3``)."""
    return name.startswith("lora_te") or any(
        k in name for k in ("_attn1_", "_attn2_", "_ff_net_", "_proj_in",
                            "_proj_out")) or (locon and name.endswith(
                                ("_in_layers_2", "_out_layers_3")))


def write_lora_files(ctx, root):
    """A rank-``ADAPTER_RANK`` LoRA over ``lora_site``'s LoCon sites of
    ``ctx``'s configuration, drawn from ``ADAPTER_SEED`` on the card
    (lora_down at 1/sqrt(fan-in), lora_up at 0.1/sqrt(rank), alpha = rank:
    a delta of some tenths of the base's output), written by the port's
    writers as a kohya file and an ``.npz`` (the UNet's sites) of the
    LoRA's sites, and a kohya file of them all. Returns (kohya path, npz
    path, LoCon path, seconds)."""
    from sdtpu_torch.io.kohya import load_lora_kohya, save_lora_kohya, \
        site_map
    from sdtpu_torch.train.lora import save_lora_npz

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(ADAPTER_SEED)
    r = ADAPTER_RANK
    flat, seen = {}, set()
    for name, (path, kind) in sorted(site_map(ctx.cfg).items()):
        if not lora_site(name, True) or path in seen:
            continue
        seen.add(path)
        node = ctx.params
        for k in path:
            node = node[k]
        w = node["w"]
        if kind == "linear":
            d_in, d_out = w.shape
            down = torch.randn((r, d_in), generator=g, device="cuda")
            up = torch.randn((d_out, r), generator=g, device="cuda")
        else:
            d_out, d_in, kh, kw = w.shape
            down = torch.randn((r, d_in, kh, kw), generator=g, device="cuda")
            up = torch.randn((d_out, r, 1, 1), generator=g, device="cuda")
        flat[name + ".lora_down.weight"] = down / (down[0].numel() ** 0.5)
        flat[name + ".lora_up.weight"] = up * (0.1 / r ** 0.5)
        flat[name + ".alpha"] = torch.tensor(float(r))
    locon = os.path.join(root, "locon.safetensors")
    save_lora_kohya(load_lora_kohya(flat, ctx.cfg), ctx.cfg, locon)
    overlay = load_lora_kohya({k: v for k, v in flat.items()
                               if lora_site(k.split(".")[0])}, ctx.cfg)
    kohya = os.path.join(root, "style.safetensors")
    npz = os.path.join(root, "style.npz")
    save_lora_kohya(overlay, ctx.cfg, kohya)
    save_lora_npz(overlay["unet"], npz)
    return kohya, npz, locon, time.perf_counter() - t0


def control_images(size, n=2):
    """``n`` fixed-seed random uint8 control images [size, size, 3]."""
    return [image_inputs(size, ADAPTER_SEED + i)[0] for i in range(n)]


def adapter_kwargs(kind, images):
    """``generate``'s keywords of an arm's adapter."""
    return {"cn": dict(control_image=images[0], control="cn"),
            "cn2": dict(control_image=images, control=["cn", "cn2"],
                        control_scale=[1.0, 0.5]),
            "cn0": dict(control_image=images[0], control="cn",
                        control_scale=0.0),
            "kohya": dict(lora="kohya"), "npz": dict(lora="npz"),
            "locon": dict(lora="locon"),
            "base": dict(lora="")}[kind]


def adapter_unet_errors(ctx, images, res):
    """One full-width UNet eval at the CFG batch of 2 with each adapter,
    under each policy (bf16), against a float32 eval of the same weights
    (the bf16 values widened exactly) on the same inputs: the UNet with the
    ControlNet "cn"'s residuals (its hint embedded from the first control
    image, its copy on the same batch), and the UNet overlaid with the
    kohya LoRA and with the LoCon. Every policy within ``MODEL_FACTOR`` of the plain bf16
    path's error. Returns the float32 LoRA'd eval and its inputs, to hold
    the quantized Contexts' LoRA'd UNets to."""
    from sdtpu_torch.io.params import cast_params
    from sdtpu_torch.models import controlnet, unet

    cfg = ctx.cfg
    x, te, context = unet_inputs(cfg, 6)
    hint = torch.from_numpy(np.stack([images[0]] * 2)).to("cuda").float() / 255

    def with_cn(up, cn, k, f):
        feats = controlnet.embed_hint(cn, f(hint), cfg.upscale)
        ctrl = controlnet.apply(cn, f(x), feats, f(te), f(context), cfg.unet,
                                k)
        return unet.apply(up, f(x), f(te), f(context), cfg.unet, k,
                          control=ctrl)

    def with_lora(up, _, k, f):
        return unet.apply(up, f(x), f(te), f(context), cfg.unet, k)

    held = None
    for label, run, up, cn in (
            ("cn", with_cn, ctx.params["unet"], ctx._controlnets["cn"]),
            ("kohya", with_lora, ctx._params_for("kohya")["unet"], None),
            ("locon", with_lora, ctx._params_for("locon")["unet"], None)):
        with torch.inference_mode():
            ref = run(cast_params(up, torch.float32),
                      None if cn is None else cast_params(cn, torch.float32),
                      "plain", lambda t: t.float())
            for k in POLICIES:
                out = run(up, cn, k, lambda t: t.to(cfg.compute_dtype))
                res[f"unet_{label}_{k}_finite"] = bool(
                    torch.isfinite(out).all())
                res[f"unet_{label}_{k}_rel_err"] = rel_err(out, ref)
                del out
        if label == "kohya":
            held = (x, te, context, ref)
        del ref
        torch.cuda.empty_cache()
    for label in ("cn", "kohya", "locon"):
        for k in POLICIES[1:]:
            if not (res[f"unet_{label}_{k}_finite"]
                    and res[f"unet_{label}_{k}_rel_err"]
                    <= MODEL_FACTOR * res[f"unet_{label}_plain_rel_err"]):
                emit(res)
                raise AssertionError(f"the UNet with {label} under {k} off "
                                     f"the float32 run: {res}")
    return held


def adapter_ab(ctx, images, res):
    """s/image and device busy ms of one image with no adapter, with one
    ControlNet and with the kohya LoRA, in turns there and back on one
    Context under cuda (two images each), and one profiled image each."""
    arms = (("none", {}), ("cn", adapter_kwargs("cn", images)),
            ("lora", adapter_kwargs("kohya", images)))
    times = {a: [] for a, _ in arms}
    busy = {}
    for label, kw in arms + arms[::-1]:
        t0 = time.perf_counter()
        ctx.generate(PROMPT, guidance=7.5, seed=ADAPTER_SEED, **kw)
        times[label].append(time.perf_counter() - t0)
        if label not in busy:
            by_name, kernels, wall_ms = device_profile(
                lambda: ctx.generate(PROMPT, guidance=7.5, seed=ADAPTER_SEED,
                                     **kw))
            busy[label] = {"device_busy_ms": sum(by_name.values()),
                           "device_kernels": kernels,
                           "profiled_wall_ms": wall_ms}
    res.update({"ab_s_per_image": {k: statistics.mean(v)
                                   for k, v in times.items()},
                "ab_image_s": times, "ab_profile": busy})


def adapter_kernel_rows(ctx, ctx_d, ctx_i, images):
    """K1-K5 each at the most-launched site the adapters bring, against its
    plain version with the existing tolerances (``kernel_adapters_*``):
    K1, K2, K3 and K2's statistics mode at the ControlNet copy's sites (one
    eval at the CFG batch, x ``ADAPTER_STEPS``), K3 also at the LoCon's
    delta down convs (Cout ``ADAPTER_RANK``), K4 and K5 at the LoRA'd
    UNet's sites on the quantized Contexts (the int8w_dense one's, the
    calibrated int8 one's with ``KERNEL_W8A8``). Returns ({kernel: rows},
    the sites' launch counts)."""
    from sdtpu_torch.models import controlnet, unet
    from sdtpu_torch.ops import matmul as MM

    cfg = ctx.cfg
    cn = ctx._controlnets["cn"]
    x, te, context = unet_inputs(cfg, 7)
    hint = torch.from_numpy(np.stack([images[0]] * 2)).to("cuda").to(
        cfg.compute_dtype) / 255
    with torch.inference_mode():
        feats = controlnet.embed_hint(cn, hint, cfg.upscale)
    sites = record_sites([(ADAPTER_STEPS, lambda k: controlnet.apply(
        cn, x, feats, te, context, cfg.unet, k))])
    locon = record_sites([(ADAPTER_STEPS, lambda k: unet.apply(
        ctx._params_for("locon")["unet"], x, te, context, cfg.unet, k))])

    def top(found):
        key = max(found, key=lambda k: (found[k], str(k)))
        return {key: found[key]}

    mm = {}
    for label, c, fn, flag in (
            ("int8w_dense", ctx_d, "matmul_int8w_cuda", False),
            ("int8+k5", ctx_i, "matmul_w8a8_cuda", True)):
        log = []
        with torch.inference_mode(), recording(MM, fn, log), w8a8_kernel(
                flag):
            unet.apply(c._params_for("kohya")["unet"], x, te, context,
                       cfg.unet, "cuda")
        found = {}
        for args, _ in log:
            xx, w8 = args[0], args[1]
            key = (xx.numel() // xx.shape[-1], w8.shape[0], w8.shape[1],
                   args[-1] is not None)
            found[key] = found.get(key, 0) + ADAPTER_STEPS
        mm[label] = top(found)
    reset_counts()
    conv = top({k: n for k, n in sites["conv"].items() if k[3]})
    down = top({k: n for k, n in locon["conv"].items()
                if k[1] == ADAPTER_RANK})
    flash = top(sites["flash"])
    emit({"phase": "sites_adapters",
          "flash_per_image": sum(sites["flash"].values()),
          "group_norm_per_image": sum(sites["group_norm"].values()),
          "conv_per_image": sum(sites["conv"].values()),
          "timed": {"flash": list(flash), "conv": list(conv),
                    "lora_down": list(down),
                    "mm": {k: list(v) for k, v in mm.items()}}})
    rows = {"flash": phase_kernel(sorted(flash), [], "kernel_adapters",
                                  per_image=flash),
            "group_norm": phase_kernel_gn(top(sites["group_norm"]), [],
                                          "kernel_adapters_gn"),
            "group_norm_affine": phase_kernel_gn_affine(
                conv, [], "kernel_adapters_gn_affine", sum(conv.values())),
            "conv": phase_kernel_conv({**conv, **down}, [], 2,
                                      "kernel_adapters_conv", int8=False)}
    rows.update(phase_kernel_mm(mm, [], "kernel_adapters_mm"))
    return rows


def phase_adapters(ctx, ctx_d, ctx_i, smi):
    """Per-request adapters on SD1.5 at full width (module docstring, item
    19), on the demo Contexts: a "random" ControlNet (and a second) and a
    LoRA written as a kohya file and an ``.npz`` by the port's writers,
    each arm of ``ADAPTER_ARMS`` with its pins, the same bytes from the
    same seed and finite latents (``checked_call``); ``control_scale=0``
    and ``lora=""`` give the base's bytes; the UNet with each adapter
    against float32 (``adapter_unet_errors``, the quantized LoRA'd UNets
    under ``QUANT_REL_ERR_MAX``); the A/B of ``adapter_ab``; then K1-K5 at
    the adapters' sites (``adapter_kernel_rows``). Returns (launches per
    arm, kernel rows)."""
    start = time.perf_counter()
    images = control_images(ctx.cfg.image_size)
    contexts = {"cuda": ctx, "cuda_gn": ctx, "cuda_conv": ctx,
                "int8w_dense": ctx_d, "int8+k5": ctx_i}
    res = {"phase": "adapters", "nvidia_smi": smi, "steps": ADAPTER_STEPS,
           "rank": ADAPTER_RANK}
    launches, seconds = {}, {}
    root = tempfile.mkdtemp(prefix="sdtpu-lora-")
    for c in (ctx, ctx_d, ctx_i):
        c.set_steps(ADAPTER_STEPS)
    try:
        t0 = time.perf_counter()
        ctx.load_controlnet("cn", "random")
        ctx.load_controlnet("cn2", "random")
        res["load_controlnet_s"] = (time.perf_counter() - t0) / 2
        # the int8w_dense Context serves the same ControlNet tree, unquantized
        ctx_d.load_controlnet("cn", ctx._controlnets["cn"])
        kohya, npz, locon, res["write_lora_s"] = write_lora_files(ctx, root)
        res["lora_file_bytes"] = {"kohya": os.path.getsize(kohya),
                                  "npz": os.path.getsize(npz),
                                  "locon": os.path.getsize(locon)}
        t0 = time.perf_counter()
        for c in (ctx, ctx_d, ctx_i):
            c.load_lora("kohya", kohya)
            c.load_lora("npz", npz)
        res["load_lora_s"] = (time.perf_counter() - t0) / 6
        ctx.load_lora("locon", locon)
        ctx.kernels = "cuda"
        base = ctx.generate(PROMPT, guidance=7.5, seed=ADAPTER_SEED)
        for arm, (mode, kind) in ADAPTER_ARMS.items():
            c = contexts[mode]
            c.kernels = mode if mode in ("cuda_gn", "cuda_conv") else "cuda"
            kw = adapter_kwargs(kind, images)
            with w8a8_kernel(mode == "int8+k5"):
                img, launches[arm], seconds[arm], lat = checked_call(
                    c, lambda _kw=kw, _c=c, **k: _c.generate(
                        PROMPT, guidance=7.5, **_kw, **k),
                    ADAPTER_PINNED[arm], f"adapters {arm}", ADAPTER_SEED)
            same = bool(np.array_equal(img, base))
            want_base = kind in ("cn0", "base")
            emit({"phase": "adapter_arm", "arm": arm, "mode": mode,
                  "steps": ADAPTER_STEPS, "seconds": seconds[arm],
                  "launches_per_image": launches[arm], "identical": True,
                  "base_bytes": same,
                  "latent_abs_max": float(np.abs(lat).max()),
                  "image_mean": float(img.mean()),
                  "image_std": float(img.std())})
            if mode == "cuda" and same != want_base:
                raise AssertionError(
                    f"adapters {arm}: the image is "
                    f"{'not ' if want_base else ''}the base's")
        ctx.kernels = "cuda"
        held = adapter_unet_errors(ctx, images, res)
        for label, c, flag in (("int8w_dense", ctx_d, False),
                               ("int8+k5", ctx_i, True)):
            quant = types.SimpleNamespace(
                params={"unet": c._params_for("kohya")["unet"]}, cfg=c.cfg,
                kernels="cuda")
            quant_error(quant, held, res, f"adapters kohya {label}", label,
                        flag)
        del held
        adapter_ab(ctx, images, res)
        rows = adapter_kernel_rows(ctx, ctx_d, ctx_i, images)
    finally:
        for c in (ctx, ctx_d, ctx_i):
            c.set_steps(STEPS)
            c.kernels = "cuda"
            c._controlnets.clear()
            c._adapters.clear()
            c._lora_params.clear()
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    res.update({"launches": launches, "first_call_s": seconds,
                "seconds": time.perf_counter() - start})
    emit(res)
    return launches, rows


def phase_adapters_xl(smi):
    """SDXL at 1024^2 with one "random" ControlNet, ``ADAPTER_XL_STEPS``
    steps under cuda, one call (``checked_call``, ``ADAPTER_PINNED``): its
    sites, not a speed measure. Returns the call's launches."""
    c = stage_context("sdxl", steps=ADAPTER_XL_STEPS, kernels="cuda")
    t0 = time.perf_counter()
    c.load_controlnet("cn", "random")
    load_s = time.perf_counter() - t0
    image = control_images(c.cfg.image_size, 1)[0]
    img, launches, seconds, lat = checked_call(
        c, lambda **k: c.generate(PROMPT, guidance=7.5, control_image=image,
                                  **k),
        ADAPTER_PINNED["cn_sdxl"], "adapters cn_sdxl", ADAPTER_SEED)
    c._controlnets.clear()
    release(c)
    emit({"phase": "adapter_arm", "arm": "cn_sdxl", "mode": "cuda",
          "nvidia_smi": smi, "steps": ADAPTER_XL_STEPS, "seconds": seconds,
          "load_controlnet_s": load_s, "launches_per_image": launches,
          "identical": True, "latent_abs_max": float(np.abs(lat).max()),
          "image_mean": float(img.mean()), "image_std": float(img.std())})
    return {"cn_sdxl": launches}


# ---------------------------------------------------------------------------
# serving: the HTTP service, the stream pool, the CLI and the C API
# ---------------------------------------------------------------------------

SERVING_CONFIG = "sd15"
SERVING_STEPS = 8
SERVING_DRAFT = 4          # the stream's second step count
SERVING_SLOTS = 4
SERVING_SEED = 47
SERVING_STRENGTH = 0.6
# img2img at strength 0.6 over 8 steps runs round(8 x 0.4) = 3 ... 7: 5
SERVING_IMG2IMG_EVALS = 5
# four requests with their own seed, guidance and negative prompt: one
# batch of 4 through the micro-batcher
SERVING_REQUESTS = [
    {"prompt": PROMPT, "seed": 0, "guidance": 7.5},
    {"prompt": "a watercolor of a lighthouse at dusk", "seed": 1,
     "guidance": 5.0, "negative_prompt": "blurry"},
    {"prompt": "a vintage car on a coastal road", "seed": 2,
     "guidance": 6.0},
    {"prompt": "a bowl of fruit on a wooden table", "seed": 3,
     "guidance": 7.5}]
# the stream arm: (prompt, steps, seed, guidance, the tick before which it
# is submitted). Four fill the pool at tick 0 (two drafts of 4 steps, two
# finals of 8); two more arrive at tick 2 and wait for the drafts' slots,
# so they are admitted mid-flight at tick 4. The drafts finish after tick
# 4 (one decode of 2), the finals and the third draft after tick 8 (a
# decode of 3), the last final after tick 12 (a decode of 1): 12 pooled
# UNet evals at N = 2 x 4 and three decodes
STREAM_REQUESTS = [
    (PROMPT, SERVING_STEPS, 10, 7.5, 0),
    ("a watercolor of a lighthouse at dusk", SERVING_DRAFT, 11, 5.0, 0),
    ("a vintage car on a coastal road", SERVING_STEPS, 12, 6.0, 0),
    ("a bowl of fruit on a wooden table", SERVING_DRAFT, 13, 7.5, 0),
    ("a red fox in the snow", SERVING_DRAFT, 14, 7.5, 2),
    ("a castle on a hill at sunset", SERVING_STEPS, 15, 7.5, 2)]
STREAM_TICKS = 12
STREAM_DECODES = (2, 3, 1)
# K1 at SD1.5: 10 launches a UNet eval at any batch (5 self-attentions at
# 64x64, 5 at 32x32; 16x16 and 8x8 take the plain path) and one a VAE
# decode or encode (the mid block); K3 and K2's statistics mode 60 a UNet
# eval and 28 a decode (tests/test_torch_hopper.py::
# test_serving_pins_are_the_rules, on the meta device)
SERVING_FLASH = 10 * SERVING_STEPS + 1
SERVING_PINNED = {
    "batch_cuda": pins(flash=SERVING_FLASH),
    "batch_cuda_conv": pins(flash=SERVING_FLASH,
                            group_norm_affine=60 * SERVING_STEPS + 28,
                            conv=60 * SERVING_STEPS + 28),
    "img2img": pins(flash=10 * SERVING_IMG2IMG_EVALS + 2),
    "stream": pins(flash=10 * STREAM_TICKS + len(STREAM_DECODES)),
    "cli": pins(flash=SERVING_FLASH),
    "capi": pins(flash=SERVING_FLASH),
}
# the reference's texts of two malformed bodies (sdtpu/engine/server.py:
# 433-434, 452-453)
SERVING_MALFORMED = [
    (b"[1, 2, 3]", {"error": "body must be a JSON object"}),
    (json.dumps({"prompt": "x", "seed": 1.5}).encode(),
     {"error": "'seed' must be an int"})]
HEALTHZ_KEYS = {"status", "backend", "image_size", "steps", "sampler",
                "max_batch", "stream_slots", "stream_step_choices",
                "lora_adapters", "controlnets"}


def start_server(ctx, **kw):
    """``engine.server.serve`` on an ephemeral port, in a thread -> (the
    server, its micro-batcher, its stream worker, the base URL)."""
    from sdtpu_torch.engine.server import serve

    ready = threading.Event()
    threading.Thread(target=serve, args=(ctx,), daemon=True,
                     kwargs={"port": 0, "ready_event": ready, **kw}).start()
    if not ready.wait(60):
        raise AssertionError("the server did not start")
    httpd = serve.last_server
    return (httpd, serve.last_batcher, serve.last_stream,
            f"http://127.0.0.1:{httpd.server_address[1]}")


def http(url, body=None):
    """GET (``body`` None) or POST (a dict as JSON, or bytes) -> (status,
    content type, body bytes)."""
    data = body if isinstance(body, (bytes, type(None))) else json.dumps(
        body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None
                                 else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def png_array(body):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)))


def png_b64(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def posted(base, bodies, route="/generate", between=None):
    """POST each body from its own thread, in order (``between(i)``, if
    given, waits before the i-th) -> ([(status, type, body, seconds)],
    the wall seconds from the first POST to the last answer)."""
    out = [None] * len(bodies)

    def one(i):
        t0 = time.perf_counter()
        out[i] = (*http(base + route, bodies[i]), time.perf_counter() - t0)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    t0 = time.perf_counter()
    for i, t in enumerate(threads):
        if between is not None:
            between(i)
        t.start()
    for t in threads:
        t.join()
    return out, time.perf_counter() - t0


def wait_for(cond, what, seconds=120.0):
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"serving: timed out waiting for {what}")
        time.sleep(0.002)


def served_batch(ctx, batcher, base, policy):
    """``SERVING_REQUESTS`` as four concurrent /generate calls that form one
    batch of 4: the device lock is held until the batcher has queued them
    in order and taken them as one batch, the counts are zeroed, the lock
    is released. Each PNG must decode to ``generate_batch``'s bytes for the
    same four requests; the launches are pinned. Returns the arm's row."""
    ctx.kernels = policy
    # the same four on the Context: the bytes to hold the PNGs to, and a
    # warm call at the batch's shapes before the timed one
    want = ctx.generate_batch(SERVING_REQUESTS)
    key = ("gen", len(SERVING_REQUESTS))
    before = batcher.batch_sizes[key]
    old, batcher.max_wait = batcher.max_wait, 60.0
    try:
        with batcher.device_lock:
            def between(i):
                wait_for(lambda: len(batcher._queue) == i, f"request {i}")

            res = {}
            worker = threading.Thread(target=lambda: res.update(
                out=posted(base, SERVING_REQUESTS, between=between)))
            worker.start()
            wait_for(lambda: batcher.batch_sizes[key] == before + 1,
                     "one batch of 4")
            reset_counts()
        worker.join()
    finally:
        batcher.max_wait = old
    launches = counts()
    answers, wall = res["out"]
    for (status, ctype, body, _), w in zip(answers, want):
        if status != 200 or ctype != "image/png":
            raise AssertionError(f"serving {policy}: {status} {body[:200]}")
        got = png_array(body)
        check_image(got, ctx.cfg.image_size)
        if not np.array_equal(got, w):
            raise AssertionError(f"serving {policy}: a PNG is not "
                                 f"generate_batch's bytes")
    label = f"batch_{policy}"
    if launches != SERVING_PINNED[label]:
        raise AssertionError(f"serving {label}: launches {launches}, "
                             f"expected {SERVING_PINNED[label]}")
    by_name, kernels, _ = device_profile(
        lambda: ctx.generate_batch(SERVING_REQUESTS))
    return {"arm": label, "launches": launches, "batches_of_4": 1,
            "wall_s": wall, "s_per_image": wall / len(SERVING_REQUESTS),
            "request_s": [a[3] for a in answers],
            "device_busy_ms_per_image": sum(by_name.values())
            / len(SERVING_REQUESTS), "device_kernels": kernels,
            "identical_to_generate_batch": True}


def run_stream(ctx, capture=False):
    """``STREAM_REQUESTS`` through a ``StreamScheduler`` on ``ctx`` (4
    slots, step counts 8 and 4), submitted at their ticks -> (images by
    request, latents by request (with ``capture``), per-request seconds
    from submission to the image on the host, decode batch sizes, the
    scheduler, the wall seconds)."""
    from sdtpu_torch.engine.stream import StreamScheduler

    sched = StreamScheduler(ctx, SERVING_SLOTS, step_choices=(SERVING_DRAFT,))
    index, submitted, seconds, images, latents = {}, {}, {}, {}, {}
    decodes = []
    tick = 0
    t0 = time.perf_counter()
    while len(images) < len(STREAM_REQUESTS):
        for j, (prompt, steps, seed, g, at) in enumerate(STREAM_REQUESTS):
            if at == tick:
                index[sched.submit(prompt, guidance=g, seed=seed,
                                   steps=steps)] = j
                submitted[j] = time.perf_counter()
        live = {slot: rec.req_id for slot, rec in sched._live.items()}
        sched.tick()
        tick += 1
        if capture:
            # a finished slot keeps its latents until the next admission
            for slot, rid in live.items():
                if slot not in sched._live:
                    latents[index[rid]] = sched._x[slot].cpu().numpy().copy()
        done = sched.completed()
        if done:
            decodes.append(len(done))
        for rid, img in done.items():
            images[index[rid]] = img
            seconds[index[rid]] = time.perf_counter() - submitted[index[rid]]
    return (images, latents, seconds, decodes, sched,
            time.perf_counter() - t0)


def quantiles(xs):
    xs = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(xs, 50)),
            "p95": float(np.percentile(xs, 95))}


def stream_checks(ctx, images, latents, res):
    """Each stream request's latents against the float32 single path with
    its seed and steps, within ``BATCH_GAP_FACTOR`` times its own gap
    between the bf16 single path (``cuda``) and float32, relative to the
    float32 run's max-abs (the rule the batch phase holds); the largest
    uint8 difference of its image from ``Context.generate``'s."""
    import dataclasses

    from sdtpu_torch import Context
    from sdtpu_torch.io.params import cast_params

    c32 = Context(config=dataclasses.replace(ctx.cfg, dtype="float32"),
                  steps=SERVING_STEPS, kernels="plain", device=ctx.device)
    c32.params = {k: cast_params(v, torch.float32)
                  for k, v in ctx.params.items()}
    with torch.inference_mode():
        c32._prepare_buffers()
    gaps, bounds, uint8 = [], [], []
    try:
        for j, (prompt, steps, seed, g, _) in enumerate(STREAM_REQUESTS):
            kw = dict(guidance=g, seed=seed)
            for c in (ctx, c32):
                c.set_steps(steps)
            ref = c32.generate(prompt, output="latent", **kw)
            alone = ctx.generate(prompt, output="latent", **kw)
            img = ctx.generate(prompt, **kw)
            scale = float(np.abs(ref).max())
            gaps.append(float(np.abs(latents[j] - ref).max()) / scale)
            bounds.append(float(np.abs(alone - ref).max()) / scale)
            uint8.append(int(np.abs(images[j].astype(int)
                                    - img.astype(int)).max()))
    finally:
        ctx.set_steps(SERVING_STEPS)
        release(c32)
    res.update({"stream_gap": gaps, "stream_bound": bounds,
                "stream_bound_factor": BATCH_GAP_FACTOR,
                "stream_max_uint8_diff_from_generate": uint8})
    if any(gap > BATCH_GAP_FACTOR * b for gap, b in zip(gaps, bounds)):
        raise AssertionError(f"serving stream: a request is off the "
                             f"float32 path: {gaps} > {bounds}")


def phase_serving(ctx, smi):
    """The serving infrastructure on SD1.5 at full width (module docstring,
    item 20), on the demo Context at ``SERVING_STEPS`` steps. Returns
    (launches per arm, K1's rows at the serving shapes)."""
    from sdtpu_torch import cli
    from sdtpu_torch.io import native

    start = time.perf_counter()
    size = ctx.cfg.image_size
    res = {"phase": "serving", "nvidia_smi": smi, "steps": SERVING_STEPS,
           "slots": SERVING_SLOTS}
    launches, arms = {}, []
    ctx.set_steps(SERVING_STEPS)
    servers = []
    try:
        # 1. the micro-batched server
        httpd, batcher, _, base = start_server(ctx, max_batch=4)
        servers.append(httpd)
        status, _, body = http(base + "/healthz")
        info = json.loads(body)
        if status != 200 or set(info) != HEALTHZ_KEYS or info[
                "backend"] != ctx.device.type:
            raise AssertionError(f"serving /healthz: {status} {info}")
        res["healthz"] = info
        for policy in ("cuda", "cuda_conv"):
            row = served_batch(ctx, batcher, base, policy)
            launches[row["arm"]] = row["launches"]
            arms.append(row)
            emit({"phase": "serving_arm", "nvidia_smi": smi, **row})
        ctx.kernels = "cuda"
        image = image_inputs(size, SERVING_SEED)[0]
        reset_counts()
        status, _, body = http(base + "/img2img", {
            "prompt": PROMPT, "seed": SERVING_SEED,
            "strength": SERVING_STRENGTH, "image_b64": png_b64(image),
            "format": "raw"})
        launches["img2img"] = counts()
        if status != 200:
            raise AssertionError(f"serving /img2img: {status} {body[:200]}")
        got = np.frombuffer(body, np.uint8).reshape(size, size, 3)
        if not np.array_equal(got, ctx.img2img(
                PROMPT, image, strength=SERVING_STRENGTH, seed=SERVING_SEED)):
            raise AssertionError("serving /img2img: not img2img's bytes")
        if launches["img2img"] != SERVING_PINNED["img2img"]:
            raise AssertionError(f"serving img2img: launches "
                                 f"{launches['img2img']}")
        for body, want in SERVING_MALFORMED:
            status, _, got = http(base + "/generate", body)
            if status != 400 or json.loads(got) != want:
                raise AssertionError(f"serving malformed {body}: {status} "
                                     f"{got[:200]}")
        res["malformed"] = [w["error"] for _, w in SERVING_MALFORMED]

        # 2. the stream pool, driven tick by tick: pins, the latents
        # against float32, the images against generate
        reset_counts()
        images, latents, seconds, decodes, sched, wall = run_stream(
            ctx, capture=True)
        launches["stream"] = counts()
        for img in images.values():
            check_image(img, size)
        if (sched.ticks, tuple(decodes)) != (STREAM_TICKS, STREAM_DECODES):
            raise AssertionError(f"serving stream: {sched.ticks} ticks, "
                                 f"decodes {decodes}")
        if launches["stream"] != SERVING_PINNED["stream"]:
            raise AssertionError(f"serving stream: launches "
                                 f"{launches['stream']}")
        stream_checks(ctx, images, latents, res)
        by_name, kernels, _ = device_profile(lambda: run_stream(ctx))
        res.update({"stream_ticks": sched.ticks, "stream_decodes": decodes,
                    "stream_request_s": [seconds[j]
                                         for j in sorted(seconds)],
                    "stream_latency_s": quantiles(list(seconds.values())),
                    "stream_s_per_image": wall / len(STREAM_REQUESTS),
                    "stream_device_busy_ms_per_image":
                        sum(by_name.values()) / len(STREAM_REQUESTS),
                    "stream_device_kernels": kernels})
        # the same six through the micro-batcher (no per-request step
        # count there: each runs the context's 8), in turns with the pool
        six = [{"prompt": p, "seed": s, "guidance": g, "format": "raw"}
               for p, _, s, g, _ in STREAM_REQUESTS]
        turns = {"stream": [], "batcher": []}
        for arm in ("stream", "batcher", "batcher", "stream"):
            if arm == "stream":
                _, _, secs, _, _, w = run_stream(ctx)
                turns[arm].append({"s_per_image": w / len(six),
                                   "latency_s": quantiles(
                                       list(secs.values()))})
            else:
                answers, w = posted(base, six)
                if any(a[0] != 200 for a in answers):
                    raise AssertionError("serving: a batcher request failed")
                turns[arm].append({"s_per_image": w / len(six),
                                   "latency_s": quantiles(
                                       [a[3] for a in answers])})
        res["in_turns"] = turns

        # 3. the stream server: six staggered requests over HTTP, one
        # tagged for /preview
        httpd_s, _, stream, base_s = start_server(
            ctx, stream_slots=SERVING_SLOTS, stream_steps=(SERVING_DRAFT,))
        servers.append(httpd_s)
        bodies = [{"prompt": p, "seed": s, "guidance": g, "steps": n,
                   "format": "raw"} for p, n, s, g, _ in STREAM_REQUESTS]
        bodies[5]["tag"] = "t5"
        preview = {}

        def between(i):
            if i == 4:
                wait_for(lambda: stream.sched.ticks >= 2, "two ticks")

        def poll():
            def got():
                status, ctype, body = http(base_s + "/preview?tag=t5")
                if status == 200:
                    preview["png"] = body
                return status == 200
            wait_for(got, "a /preview")

        reset_counts()
        poller = threading.Thread(target=poll)
        poller.start()
        answers, w = posted(base_s, bodies, between=between)
        poller.join()
        launches["stream_http"] = counts()
        sched = stream.sched
        want = pins(flash=10 * sched.ticks + sched.decodes)
        if launches["stream_http"] != want or any(a[0] != 200
                                                  for a in answers):
            raise AssertionError(f"serving stream over HTTP: launches "
                                 f"{launches['stream_http']}, expected "
                                 f"{want}, {[a[0] for a in answers]}")
        prev = png_array(preview["png"])
        if prev.shape != (ctx.cfg.latent_size,) * 2 + (3,):
            raise AssertionError(f"serving /preview: {prev.shape}")
        http_diff = [int(np.abs(np.frombuffer(a[2], np.uint8).reshape(
            size, size, 3).astype(int) - images[j].astype(int)).max())
            for j, a in enumerate(answers)]
        res.update({"stream_http_ticks": sched.ticks,
                    "stream_http_decodes": sched.decodes,
                    "stream_http_latency_s": quantiles(
                        [a[3] for a in answers]),
                    "stream_http_s_per_image": w / len(bodies),
                    "stream_http_max_uint8_diff_from_pool": http_diff,
                    "preview_shape": list(prev.shape)})

        # 4. the CLI: in-process with the pins, then as a user runs it
        want = ctx.generate(PROMPT, guidance=7.5, seed=0)
        tmp = tempfile.mkdtemp(prefix="sdtpu-cli-")
        try:
            argv = ["generate", "--config", SERVING_CONFIG, "--steps",
                    str(SERVING_STEPS), "--seed", "0", "--log-level", "0"]
            out = os.path.join(tmp, "in.png")
            reset_counts()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(argv + ["--out", out])
            launches["cli"] = counts()
            t0 = time.perf_counter()
            here = os.path.dirname(os.path.abspath(__file__))
            proc = subprocess.run(
                [sys.executable, "-m", "sdtpu_torch.cli", *argv, "--out",
                 os.path.join(tmp, "sub.png")], cwd=here,
                capture_output=True, text=True, timeout=600,
                env={**os.environ, "PYTHONPATH": here})
            res["cli_subprocess_s"] = time.perf_counter() - t0
            if rc != 0 or proc.returncode != 0:
                raise AssertionError(f"serving cli: {rc}, "
                                     f"{proc.returncode}: {proc.stderr}")
            for name in ("in.png", "sub.png"):
                with open(os.path.join(tmp, name), "rb") as f:
                    got = png_array(f.read())
                if not np.array_equal(got, want):
                    raise AssertionError(f"serving cli {name}: not "
                                         f"generate's bytes")
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                cli.main(["info"])
            if torch.cuda.get_device_name(0) not in text.getvalue():
                raise AssertionError("serving cli info: no card name")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if launches["cli"] != SERVING_PINNED["cli"]:
            raise AssertionError(f"serving cli: launches {launches['cli']}")

        # 5. the C API: built on the host, loaded here, its embedded
        # Context on the card (the device variable unset)
        t0 = time.perf_counter()
        lib = native.load_library()
        res["capi_build_s"] = time.perf_counter() - t0
        os.environ.pop(native.DEVICE_VAR, None)
        vp = ctypes.c_void_p
        lib.sdtpu_setup.argtypes = [ctypes.POINTER(vp), ctypes.c_char_p,
                                    ctypes.c_char_p, ctypes.c_int32,
                                    ctypes.c_int32, ctypes.c_int32]
        lib.sdtpu_generate_image.argtypes = [
            vp, ctypes.c_char_p, ctypes.c_float, ctypes.POINTER(vp),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.sdtpu_release.argtypes = [vp]
        lib.sdtpu_free_buffer.argtypes = [vp]
        handle = vp()
        t0 = time.perf_counter()
        rc = lib.sdtpu_setup(ctypes.byref(handle), None,
                             SERVING_CONFIG.encode(), SERVING_STEPS, 0, 1)
        res["capi_setup_s"] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"serving sdtpu_setup: status {rc}")
        try:
            buf, n = vp(), ctypes.c_size_t()
            reset_counts()
            rc = lib.sdtpu_generate_image(handle, PROMPT.encode(), 7.5,
                                          ctypes.byref(buf), ctypes.byref(n))
            launches["capi"] = counts()
            if rc != 0:
                raise AssertionError(f"serving sdtpu_generate_image: {rc}")
            got = np.ctypeslib.as_array(
                ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)),
                (n.value,)).copy().reshape(size, size, 3)
            lib.sdtpu_free_buffer(buf)
        finally:
            lib.sdtpu_release(handle)
            gc.collect()
            torch.cuda.empty_cache()
        if not np.array_equal(got, want):
            raise AssertionError("serving capi: not generate's bytes")
        if launches["capi"] != SERVING_PINNED["capi"]:
            raise AssertionError(f"serving capi: launches "
                                 f"{launches['capi']}")
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        ctx.set_steps(STEPS)
        ctx.kernels = "cuda"
    # K1 at the shapes serving brings: the pool's UNet at N = 2 x 4 and
    # the batched decodes of 1 to 4 finishing slots, each row with its
    # launches per image of the stream arm
    n = len(STREAM_REQUESTS)
    unet = [(2 * SERVING_SLOTS, 4096, 320, 8),
            (2 * SERVING_SLOTS, 1024, 640, 8)]
    decode = [(k, 4096, 512, 1) for k in range(1, SERVING_SLOTS + 1)]
    per_image = {**{s: 5 * STREAM_TICKS / n for s in unet},
                 **{s: STREAM_DECODES.count(s[0]) / n for s in decode}}
    rows = phase_kernel(unet + decode, [], "kernel_serving", per_image)
    res.update({"launches": launches, "arms": arms,
                "seconds": time.perf_counter() - start})
    emit(res)
    return launches, rows


# ---------------------------------------------------------------------------
# 21. train: the LDM train step on SD1.5 at full width (module docstring)
# ---------------------------------------------------------------------------

TRAIN_CONFIG = "sd15"
TRAIN_BATCH = 2
TRAIN_SEED = 53
TRAIN_LR = 1e-5
TRAIN_STEPS = 3            # the determinism runs and the LoRA run
TRAIN_LORA_RANK = 16
# K1 a train step of SD1.5 at 512^2: 5 self-attentions at 64x64 and 5 at
# 32x32 (16x16, 8x8 and cross-attention stay plain), each one forward and
# one backward; under remat each forward runs again in the backward; the
# images path adds the encoder's mid block, a forward with no backward
# (tests/test_torch_hopper.py::test_train_pins_are_the_rules)
TRAIN_FLASH = 5 + 5
TRAIN_ENCODER_FLASH = 1


def train_pins(flash=0, flash_bwd=0):
    return {**dict.fromkeys(KERNEL_NAMES, 0), "flash": flash,
            "flash_bwd": flash_bwd}


TRAIN_PINNED = {
    "plain": train_pins(),
    "plain_remat": train_pins(),
    "cuda": train_pins(TRAIN_FLASH, TRAIN_FLASH),
    "cuda_remat": train_pins(2 * TRAIN_FLASH, TRAIN_FLASH),
    "cuda_images": train_pins(TRAIN_FLASH + TRAIN_ENCODER_FLASH,
                              TRAIN_FLASH),
}
# K1-bwd at the training sites (batch, seq, channels, heads): SD1.5's 64x64
# and 32x32 levels (d 40, 80), SD 2.x / SDXL's d = 64; then ragged shapes
# of its contract: a sequence no tile divides, d = 8, 96 (padded to 128),
# 128
TRAIN_SITES = [(2, 4096, 320, 8), (2, 1024, 640, 8), (2, 1024, 1280, 20)]
TRAIN_RAGGED = [(2, 1000, 512, 8), (1, 129, 16, 2), (1, 77, 96, 1),
                (1, 200, 128, 1)]


def train_counts():
    """``counts()`` and K1-bwd's, whose counter only training moves."""
    from sdtpu_torch.ops import attention as A

    return {**counts(), "flash_bwd": A.flash_attention_bwd_cuda.launches}


def reset_train_counts():
    from sdtpu_torch.ops import attention as A

    reset_counts()
    A.flash_attention_bwd_cuda.launches = 0


BWD_DESIGN = ("wgmma: a dq kernel (S, dP recomputed; D and lse2 of its "
              "rows) then a dk/dv kernel, each writing its own rows, no "
              "atomics; ss S/dP, rs_mn dv/dk/dq; cp.async ring into "
              "128-byte-swizzled tiles, copy slots worked out once; with "
              "one warpgroup a block, a tile's last product under the next "
              "tile's S and dP")


def bwd_resources(resources, plan):
    """Registers and spill bytes of the two K1-bwd kernels that ``plan``
    instantiates, from ``phase_build``'s reports (demangled or mangled
    names)."""
    dpad, rows, bkv, bq = plan
    got = {}
    for kernel, bt in (("dq", bq), ("dkdv", bkv)):
        names = (f"flash_bwd_{kernel}_kernel<{dpad}, {bt}, {rows // 64},",
                 f"flash_bwd_{kernel}_kernelILi{dpad}ELi{bt}ELi{rows // 64}E")
        for r in (resources or {}).get("flash_attn_bwd.cu", []):
            if any(n in r["kernel"].replace("(int)", "") for n in names):
                got[kernel] = r
    return {"registers": {k: r["registers"] for k, r in got.items()},
            "spill_store_bytes": sum(r["spill_store_bytes"]
                                     for r in got.values())}


def phase_train_kernels(resources=None):
    """K1-bwd against its plain version (``flash_attention_bwd_reference``,
    float32 on the same bf16 inputs) at ``TRAIN_SITES`` and
    ``TRAIN_RAGGED``: dq, dk and dv each within ``KERNEL_TOL`` of the plain
    version's max-abs; each row with its plan, design and the registers
    and spills of its instantiation (``resources``: ``phase_build``'s
    reports); at the sites the device times of the kernel, the plain
    version and the library's backward (``F.scaled_dot_product_
    attention`` forward and backward less its forward), the kernel's
    TFLOP/s beside the bound's: the larger of the five products' 10 BH S^2
    d operations at the bf16 peak, the S^2 exponentials a head at
    ``PEAK_EXP`` and the bytes (q, k, v, o, do, lse in; dq, dk, dv out)."""
    from sdtpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    rows = []
    cases = ([(*c, True) for c in TRAIN_SITES]
             + [(*c, False) for c in TRAIN_RAGGED])
    for b, s, c, heads, main in cases:
        d = c // heads
        q, k, v, do = (torch.randn((b, s, c), generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        out, lse = A.flash_attention_cuda(q, k, v, heads, with_lse=True)
        grads = A.flash_attention_bwd_cuda(q, k, v, out, lse, do, heads)
        again = A.flash_attention_bwd_cuda(q, k, v, out, lse, do, heads)
        torch.cuda.synchronize()
        refs = A.flash_attention_bwd_reference(q.float(), k.float(),
                                               v.float(), do.float(), heads)
        errs = {n: (x.float() - r).abs().max().item()
                for n, x, r in zip(("dq", "dk", "dv"), grads, refs)}
        maxes = {n: r.abs().max().item()
                 for n, r in zip(("dq", "dk", "dv"), refs)}
        del refs
        ops = 10.0 * b * heads * s * s * d
        nbytes = 2 * (5 * q.numel() + 3 * q.numel()) + 4 * lse.numel()
        by_ops = ops / PEAK_OPS["bf16"] * 1e3
        exp_ms = b * heads * s * s / PEAK_EXP * 1e3
        by_bytes = nbytes / PEAK_BYTES * 1e3
        row = {"shape": [b, s, c], "heads": heads, "head_dim": d,
               "plan": list(A.plan_bwd(d, s, b * heads)),
               "design": BWD_DESIGN,
               **bwd_resources(resources, A.plan_bwd(d, s, b * heads)),
               "max_abs_err": max(errs.values()), "errs": errs,
               "ref_abs_max": maxes,
               "deterministic": all(torch.equal(x, y)
                                    for x, y in zip(grads, again)),
               "bound_ms": max(by_ops, exp_ms, by_bytes),
               "bound_by": "bytes" if by_bytes > max(by_ops, exp_ms)
               else "operations",
               "ops_bound_ms": by_ops, "exp_bound_ms": exp_ms}
        if main:
            row["ms"] = cuda_ms(lambda: A.flash_attention_bwd_cuda(
                q, k, v, out, lse, do, heads))
            row["plain_ms"] = cuda_ms(lambda: A.flash_attention_bwd_reference(
                q, k, v, do, heads))
            row["tflops"] = ops / row["ms"] / 1e9
            row["bound_tflops"] = ops / row["bound_ms"] / 1e9
            # the one PyTorch call with the same function, as a yardstick
            # only: the backward of SDPA, its forward and backward less its
            # forward (the port never calls it)
            qh, kh, vh = (t.view(b, s, heads, d).transpose(1, 2).detach()
                          .requires_grad_(True) for t in (q, k, v))
            doh = do.view(b, s, heads, d).transpose(1, 2)

            def lib_fwd():
                return F.scaled_dot_product_attention(qh, kh, vh)

            def lib_both():
                torch.autograd.grad(lib_fwd(), (qh, kh, vh), doh)

            row["library_fwd_bwd_ms"] = cuda_ms(lib_both)
            row["library_fwd_ms"] = cuda_ms(lib_fwd)
            row["library_ms"] = row["library_fwd_bwd_ms"] - row[
                "library_fwd_ms"]
        emit({"phase": "kernel_bwd" if main else "kernel_bwd_ragged", **row})
        if not (row["deterministic"] and all(
                errs[n] <= KERNEL_TOL * maxes[n] for n in errs)):
            raise AssertionError(f"K1-bwd disagrees at {row}")
        rows.append(row)
        del q, k, v, do, out, lse, grads, again
        torch.cuda.empty_cache()
    return rows


def train_models(cfg, images=False):
    """The demo pipeline of ``cfg`` on the card as ``sdtpu-torch train``
    makes it (seed ``TRAIN_SEED``): float32 UNet masters, the frozen trees
    in float32 (cast to bf16 by the caller)."""
    from sdtpu_torch.io.params import init_tree, tree_names

    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    trees = {n: init_tree(n, cfg, gen, "cuda") for n in tree_names(cfg)}
    trees.pop("vae")
    if not images:
        trees.pop("vae_enc")
    return trees


def train_batch(cfg, seed, images=False, n=TRAIN_BATCH):
    g = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.clip.vocab_size, (n, cfg.clip.context_len),
                           generator=g, device="cuda", dtype=torch.int32)
    if images:
        s = cfg.image_size
        return {"images": torch.rand((n, s, s, 3), generator=g,
                                     device="cuda") * 2 - 1,
                "tokens": tokens}
    s = cfg.latent_size
    return {"latents": torch.randn((n, s, s, cfg.latent_channels),
                                   generator=g, device="cuda"),
            "tokens": tokens}


def grad_rel_err(grads, ref):
    """|g - g_ref| / |g_ref| over every leaf (global L2 norms)."""
    num = torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(a.float() - b) for a, b in zip(grads, ref)]))
    den = torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(b) for b in ref]))
    return (num / den).item()


def same_bytes(a, b):
    from sdtpu_torch.train.step import leaves

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        pa == pb and torch.equal(x, y) for (pa, x), (pb, y) in zip(la, lb))


def phase_train(smi, resources=None):
    """Training on SD1.5 at its published widths and depth, 512^2, demo
    weights, float32 masters, bf16 compute, batch ``TRAIN_BATCH`` (module
    docstring, item 21), run after the inference Contexts are released, so
    that its peak memory is the step's own. ``resources``: ``phase_build``'s
    reports, for K1-bwd's registers and spills. Returns (launches per arm,
    K1-bwd's rows)."""
    from sdtpu_torch.models.layers import disable_tf32

    start = time.perf_counter()
    disable_tf32()
    # the train step is bitwise reproducible with cuDNN's deterministic
    # algorithms, as the CLI sets them; the inference phases after this one
    # keep the setting they ran with
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _phase_train(smi, start, resources)
    finally:
        torch.backends.cudnn.deterministic = before


def _phase_train(smi, start, resources):
    import dataclasses

    from sdtpu_torch.config import CONFIGS
    from sdtpu_torch.io.params import cast_params
    from sdtpu_torch.train import lora as L
    from sdtpu_torch.train import step as T

    rows = phase_train_kernels(resources)
    cfg = CONFIGS[TRAIN_CONFIG]
    res = {"phase": "train", "nvidia_smi": smi, "config": TRAIN_CONFIG,
           "batch": TRAIN_BATCH, "lr": TRAIN_LR}
    launches = {}
    trees = train_models(cfg, images=True)
    frozen32 = {n: trees.pop(n) for n in ("clip", "temb", "vae_enc")}
    frozen = {n: cast_params(t, cfg.compute_dtype)
              for n, t in frozen32.items()}
    masters = trees.pop("unet")
    res["unet_parameters"] = sum(t.numel() for _, t in T.leaves(masters))
    opt = T.make_optimizer(lr=TRAIN_LR)
    batch = train_batch(cfg, 1)

    # 1. one step's gradients from the same draws: cuda and plain in bf16,
    # remat off and on, against a float32 plain step
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    shape = (TRAIN_BATCH, cfg.latent_size, cfg.latent_size,
             cfg.latent_channels)
    draws = {"t": torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen,
                                device="cuda"),
             "eps": torch.randn(shape, generator=gen, device="cuda")}
    named = [p.requires_grad_(True) for _, p in T.leaves(masters)]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    grads = {}
    for arm, c, kernels, remat in (
            ("f32", cfg32, "plain", False), ("plain", cfg, "plain", False),
            ("cuda", cfg, "cuda", False), ("cuda_remat", cfg, "cuda", True),
            ("plain_remat", cfg, "plain", True)):
        fz = frozen32 if c is cfg32 else frozen
        reset_train_counts()
        torch.cuda.reset_peak_memory_stats()
        loss = T.ldm_loss(masters, fz, batch, None, c, kernels, remat,
                          draws=draws)
        g = torch.autograd.grad(loss, named)
        torch.cuda.synchronize()
        got = train_counts()
        if arm != "f32":
            launches[f"grad_{arm}"] = got
        if got != TRAIN_PINNED["plain" if arm == "f32" else arm]:
            raise AssertionError(f"train grads {arm}: launches {got}")
        res[f"grad_{arm}_loss"] = loss.item()
        res[f"grad_{arm}_grad_norm"] = T.global_norm(g).item()
        res[f"grad_{arm}_max_memory_gb"] = (
            torch.cuda.max_memory_allocated() / 1e9)
        grads[arm] = g
        del loss, g
    for arm in ("plain", "cuda", "cuda_remat", "plain_remat"):
        res[f"grad_{arm}_rel_err"] = grad_rel_err(grads[arm], grads["f32"])
        res[f"grad_{arm}_finite"] = all(bool(torch.isfinite(x).all())
                                        for x in grads[arm])
    res["grad_cuda_remat_vs_cuda_rel_err"] = grad_rel_err(
        grads["cuda_remat"], [x.float() for x in grads["cuda"]])
    res["grad_remat_bitwise"] = all(torch.equal(a, b) for a, b in zip(
        grads["cuda_remat"], grads["cuda"]))
    del grads
    torch.cuda.empty_cache()
    emit(res)
    plain_err = res["grad_plain_rel_err"]
    for arm in ("cuda", "cuda_remat"):
        if not (res[f"grad_{arm}_finite"] and res[f"grad_{arm}_rel_err"]
                <= MODEL_FACTOR * plain_err):
            raise AssertionError(f"train {arm} off the float32 step: {res}")
    if not res["grad_cuda_remat_vs_cuda_rel_err"] <= MODEL_FACTOR * plain_err:
        raise AssertionError(f"train remat's gradients off cuda's: {res}")

    # 2. s/step in turns, plain and cuda, remat off and on, each with its
    # peak memory (the state, 860 M parameters in f32 with two moments and
    # the EMA and the gradients, and the step's activations); then device
    # busy ms and kernels a step
    state = T.init_train_state(masters, opt, ema=True)
    arms = ("plain", "cuda", "cuda_remat", "plain_remat")
    steps = {a: T.make_train_step(cfg, opt, kernels=a.split("_")[0],
                                  remat=a.endswith("remat")) for a in arms}
    times = {a: [] for a in arms}
    losses = []
    n = 0

    def one(arm, timed=True):
        nonlocal n
        torch.cuda.reset_peak_memory_stats()
        reset_train_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = steps[arm](state, frozen, batch,
                          T.step_generator(TRAIN_SEED, n, "cuda"))
        losses.append(m["loss"].item())
        w = time.perf_counter() - t0
        n += 1
        if timed:
            times[arm].append(w)
        res[f"step_{arm}_max_memory_gb"] = (
            torch.cuda.max_memory_allocated() / 1e9)
        got = train_counts()
        if got != TRAIN_PINNED[arm]:
            raise AssertionError(f"train step {arm}: launches {got} != "
                                 f"{TRAIN_PINNED[arm]}")
        launches[f"step_{arm}"] = got

    for arm in arms:
        one(arm, timed=False)
    for arm in arms + arms[::-1]:
        one(arm)
    res["s_per_step"] = {a: times[a] for a in arms}
    res["losses"] = losses
    for arm in ("cuda", "plain"):
        by_name, kernels, wall = device_profile(
            lambda: steps[arm](state, frozen, batch,
                               T.step_generator(TRAIN_SEED, n, "cuda")))
        res[f"profile_{arm}_busy_ms"] = sum(by_name.values())
        res[f"profile_{arm}_kernels"] = kernels
        res[f"profile_{arm}_wall_ms"] = wall
        res[f"profile_{arm}_top"] = sorted(by_name.items(),
                                           key=lambda kv: -kv[1])[:6]
    emit({**res, "phase": "train_steps"})

    # 3. determinism: two runs of TRAIN_STEPS from the same seed and state
    # give the same bytes of params, moments and EMA
    finals = []
    for run in range(2):
        del state
        gc.collect()
        torch.cuda.empty_cache()
        state = T.init_train_state(T._map(lambda t: t.detach().clone(),
                                          masters), opt, ema=True)
        for i in range(TRAIN_STEPS):
            steps["cuda"](state, frozen, train_batch(cfg, 100 + i),
                          T.step_generator(TRAIN_SEED, i, "cuda"))
        finals.append(state if run == 0 else None)
    first = finals[0]
    same = (same_bytes(first.params, state.params)
            and same_bytes(first.ema, state.ema)
            and all(torch.equal(first.opt_state[m][k], state.opt_state[m][k])
                    for m in ("mu", "nu") for k in state.opt_state[m]))
    res["deterministic"] = same
    del first, finals, state
    gc.collect()
    torch.cuda.empty_cache()
    if not same:
        raise AssertionError("train: two runs of the same seed differ")

    # 4. the images path: the encoder and its posterior inside the loss
    state = T.init_train_state(masters, opt)
    reset_train_counts()
    _, m = T.train_step(state, frozen, train_batch(cfg, 2, images=True),
                        T.step_generator(TRAIN_SEED, 0, "cuda"), cfg, opt)
    launches["cuda_images"] = train_counts()
    res["images_loss"] = m["loss"].item()
    if launches["cuda_images"] != TRAIN_PINNED["cuda_images"]:
        raise AssertionError(f"train images: {launches['cuda_images']}")

    # 5. LoRA: TRAIN_STEPS of make_lora_optimizer at rank 16: the adapters
    # move, every base leaf keeps its bytes
    del state
    gc.collect()
    torch.cuda.empty_cache()
    lora = L.inject_lora(masters, TRAIN_LORA_RANK,
                         torch.Generator(device="cuda").manual_seed(3))
    base = {T.flat_key(p): t.detach().clone() for p, t in T.leaves(lora)
            if not L.is_adapter(p)}
    lopt = L.make_lora_optimizer()
    state = T.init_train_state(lora, lopt)
    lstep = T.make_train_step(cfg, lopt)
    for i in range(TRAIN_STEPS):
        reset_train_counts()
        _, m = lstep(state, frozen, train_batch(cfg, 200 + i),
                     T.step_generator(TRAIN_SEED, i, "cuda"))
        launches["lora"] = train_counts()
        if launches["lora"] != TRAIN_PINNED["cuda"]:
            raise AssertionError(f"train lora: {launches['lora']}")
    bs = [t for p, t in T.leaves(state.params) if p[-1] == "lora_b"]
    res["lora_sites"] = len(bs)
    res["lora_moment_leaves"] = len(state.opt_state["mu"])
    res["lora_b_moved"] = sum(bool(t.any()) for t in bs)
    res["lora_base_leaves_changed"] = sum(
        not torch.equal(t.detach(), base[T.flat_key(p)])
        for p, t in T.leaves(state.params) if not L.is_adapter(p))
    res["lora_loss"] = m["loss"].item()
    del state, lora, base, bs
    gc.collect()
    torch.cuda.empty_cache()
    if (res["lora_base_leaves_changed"] or not res["lora_sites"]
            or res["lora_b_moved"] != res["lora_sites"]
            or res["lora_moment_leaves"] != 2 * res["lora_sites"]):
        raise AssertionError(f"train lora: {res}")
    del masters, frozen, frozen32
    gc.collect()
    torch.cuda.empty_cache()

    # 6. the CLI: the demo batches with --ema, then --resume; --data over a
    # two-shard .npz and over an image folder (the encoder in the loss)
    res.update(train_cli(cfg, launches))
    res["seconds"] = time.perf_counter() - start
    emit({**res, "phase": "train_done"})
    return launches, rows


TRAIN_LINE = re.compile(r"^step +\d+  loss \d+\.\d{4}  gnorm \d+\.\d{3}  "
                        r"\(\d+\.\d+s\)$")


def cli_train(argv, launches=None, arm=None):
    """``sdtpu_torch.cli train`` in this process: (rc, stdout lines), the
    launches of the run under ``launches[arm]``."""
    from sdtpu_torch import cli

    reset_train_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["train", *argv])
    if launches is not None:
        launches[arm] = train_counts()
    return rc, buf.getvalue().splitlines()


def train_state_like(cfg, ema):
    from sdtpu_torch.train import step as T

    unet = train_models(cfg)["unet"]
    return T.init_train_state(unet, T.make_optimizer(), ema=ema)


def train_cli(cfg, launches):
    """The train CLI at SD1.5 (checks, not a benchmark): ``--steps 3 --ema``
    as ``python -m``, then ``--resume`` for 2 more in this process; both
    states read back by ``load_train_state``; ``--data`` over a two-shard
    ``.npz`` of latents made from the seed and over a four-image folder
    with ``captions.txt`` (the encoder in the loss). Each run's launches are
    its steps' pins."""
    from sdtpu_torch.train import step as T

    res = {}
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="sdtpu-train-")
    try:
        res["cli_tmp_free_gb"] = shutil.disk_usage(tmp).free / 1e9
        argv = ["--config", TRAIN_CONFIG, "--batch", str(TRAIN_BATCH),
                "--seed", str(TRAIN_SEED), "--lr", str(TRAIN_LR),
                "--log-every", "1"]
        ck, ck2 = os.path.join(tmp, "ck"), os.path.join(tmp, "ck2")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sdtpu_torch.cli", "train", *argv,
             "--steps", "3", "--ema", "--out", ck], cwd=here,
            capture_output=True, text=True, timeout=900,
            env={**os.environ, "PYTHONPATH": here})
        res["cli_subprocess_s"] = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        steps = [ln for ln in lines if ln.startswith("step")]
        if (proc.returncode != 0 or len(steps) != 3
                or not all(TRAIN_LINE.match(ln) for ln in steps)
                or lines[-1] != f"saved train state (step 3, ema) to {ck}"):
            raise AssertionError(f"train cli: {proc.returncode} {lines} "
                                 f"{proc.stderr[-2000:]}")
        res["cli_lines"] = lines
        rc, lines = cli_train(argv + ["--steps", "2", "--ema", "--resume",
                                      ck, "--out", ck2], launches,
                              "cli_resume")
        if (rc != 0 or f"resumed at step 3 from {ck}" not in lines
                or lines[-1] != f"saved train state (step 5, ema) to {ck2}"
                or launches["cli_resume"] != {
                    k: 2 * v for k, v in TRAIN_PINNED["cuda"].items()}):
            raise AssertionError(f"train cli --resume: {rc} {lines} "
                                 f"{launches['cli_resume']}")
        res["cli_resume_lines"] = lines
        shutil.rmtree(ck)
        like = train_state_like(cfg, ema=True)
        res["cli_state_step"] = int(T.load_train_state(ck2, like).step)
        res["cli_state_bytes"] = os.path.getsize(
            os.path.join(ck2, T.STATE_FILE))
        del like
        shutil.rmtree(ck2)
        gc.collect()
        torch.cuda.empty_cache()
        if res["cli_state_step"] != 5:
            raise AssertionError(f"train cli state: {res}")

        rng = np.random.default_rng(TRAIN_SEED)
        shards = os.path.join(tmp, "shards")
        os.makedirs(shards)
        s = cfg.latent_size
        for i in range(2):
            np.savez(os.path.join(shards, f"part{i}.npz"),
                     latents=rng.standard_normal(
                         (4, s, s, cfg.latent_channels)).astype(np.float32),
                     tokens=rng.integers(0, cfg.clip.vocab_size,
                                         (4, cfg.clip.context_len)
                                         ).astype(np.int32))
        ck3 = os.path.join(tmp, "ck3")
        rc, lines = cli_train(argv + ["--steps", "2", "--data", shards,
                                      "--out", ck3], launches, "cli_data")
        if (rc != 0 or "dataset: 8 examples (latents), 4 steps/epoch, "
                "resuming epoch 0" not in lines
                or launches["cli_data"] != {
                    k: 2 * v for k, v in TRAIN_PINNED["cuda"].items()}):
            raise AssertionError(f"train cli --data shards: {rc} {lines} "
                                 f"{launches['cli_data']}")
        shutil.rmtree(ck3)

        from PIL import Image

        folder = os.path.join(tmp, "images")
        os.makedirs(folder)
        size = cfg.image_size
        with open(os.path.join(folder, "captions.txt"), "w") as f:
            for i in range(4):
                Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                             dtype=np.uint8)).save(
                    os.path.join(folder, f"{i}.png"))
                f.write(f"{i}.png\t{PROMPT} number {i}\n")
        ck4 = os.path.join(tmp, "ck4")
        rc, lines = cli_train(argv + ["--steps", "1", "--data", folder,
                                      "--out", ck4], launches, "cli_images")
        if (rc != 0 or "dataset: 4 examples (images), 2 steps/epoch, "
                "resuming epoch 0" not in lines
                or launches["cli_images"] != TRAIN_PINNED["cuda_images"]):
            raise AssertionError(f"train cli --data images: {rc} {lines} "
                                 f"{launches['cli_images']}")
        res["cli_images_lines"] = lines
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def image_summary(rows, launches):
    """A kernel's rows at the image sites for the ``kernels`` line, as
    ``family_summary``; None where the group has no site of it."""
    return family_summary(rows, launches) if rows else None


def family_summary(rows, launches):
    """A kernel's rows at a family's sites for the ``kernels`` line: the
    worst error, the most launched site's times and bound, the sum over
    the sites of launches x ms per image beside the bound's, and launches
    per image on the main path."""
    top = max(rows, key=lambda r: (r.get("per_image", 0), r.get("m", 0)))
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": top["ms"], "plain_ms": top.get("plain_ms"),
            "bound_ms": top["bound_ms"],
            "library_ms": top.get("library_ms", top.get("cuda_site_ms")),
            "per_image_ms": per_image_ms(rows, "ms"),
            "per_image_bound_ms": per_image_ms(rows, "bound_ms"),
            "launches": launches, "rows": len(rows)}


def batch_summary(rows):
    """A kernel's batch rows for the ``kernels`` line: the worst error and
    the most launched site's time."""
    top = max(rows, key=lambda r: (r.get("per_image", 0), r.get("m", 0)))
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": top["ms"], "bound_ms": top["bound_ms"],
            "rows": len(rows)}


def main_row(rows):
    """The timed row of a kernel: its most frequent main-path shape, the
    one with the most rows among equals."""
    return max(rows, key=lambda r: (r["per_image"], r["m"], r["n"]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from sdtpu_torch import Context

    name, smi = phase_device()
    resources = phase_build()
    rows = phase_kernel()
    ctx = Context(config="sd15", steps=STEPS, sampler="dpm", kernels="auto",
                  seed=0, device="cuda")
    if ctx.kernels != "cuda":
        raise AssertionError(f"kernels resolved to {ctx.kernels}")
    sites = phase_sites(ctx)
    gn_sites, conv_sites = sites["group_norm"], sites["conv"]
    gn_rows = phase_kernel_gn(gn_sites)
    affine_rows = phase_kernel_gn_affine(conv_sites)
    conv_rows = phase_kernel_conv(conv_sites)
    emit({"phase": "kernel_totals", "per_image_ms": {
        "group_norm_kernel": per_image_ms(gn_rows, "ms"),
        "group_norm_bound": per_image_ms(gn_rows, "bound_ms"),
        "group_norm_plain": per_image_ms(gn_rows, "plain_ms"),
        "group_norm_library": per_image_ms(gn_rows, "library_ms"),
        "group_norm_cuda_site": per_image_ms(gn_rows, "cuda_site_ms"),
        "group_norm_affine_kernel": per_image_ms(affine_rows, "ms"),
        "group_norm_affine_bound": per_image_ms(affine_rows, "bound_ms"),
        "group_norm_affine_plain": per_image_ms(affine_rows, "plain_ms"),
        "group_norm_affine_library": per_image_ms(affine_rows, "library_ms"),
        "conv_kernel": per_image_ms(conv_rows, "ms"),
        "conv_kernel_int8_sites": sum(r["per_image_int8"] * r["ms"]
                                      for r in conv_rows),
        "conv_cuda_conv_site": per_image_ms(conv_rows, "cuda_conv_site_ms"),
        "conv_cuda_site": per_image_ms(conv_rows, "cuda_site_ms")}})
    launches = {"cuda": phase_main_path(ctx)}
    phase_determinism(ctx)
    for policy in ("cuda_gn", "cuda_conv"):
        launches[policy] = phase_policy(ctx, policy)
    phase_ab(ctx)
    phase_samplers(ctx)

    # quantized serving: one Context per mode, the same demo weights
    ctx_d = Context(config="sd15", steps=STEPS, kernels="cuda",
                    quantize="int8w_dense", device="cuda")
    ctx_w = Context(config="sd15", steps=STEPS, kernels="cuda_conv",
                    quantize="int8w", device="cuda")
    ctx_i = Context(config="sd15", steps=STEPS, kernels="cuda",
                    quantize="int8", device="cuda")
    phase_calibrate(ctx_i)
    phase_widening()
    mm_sites = phase_mm_sites(ctx_d, ctx_w, ctx_i)
    mm_rows = phase_kernel_mm(mm_sites)
    k4_rows, k5_rows = mm_rows["matmul_int8w"], mm_rows["matmul_w8a8"]
    emit({"phase": "kernel_totals_mm", "per_image_ms": {
        "matmul_int8w_kernel": per_image_ms(k4_rows, "ms"),
        "matmul_int8w_bf16_site": per_image_ms(k4_rows, "library_ms"),
        "matmul_int8w_dequant_site": per_image_ms(k4_rows, "dequant_ms"),
        "matmul_w8a8_kernel": per_image_ms(k5_rows, "ms"),
        "matmul_w8a8_static_path": per_image_ms(k5_rows, "static_path_ms")}})
    launches["int8w_dense"] = phase_policy(ctx_d, "cuda", "int8w_dense")
    launches["int8w"] = phase_policy(ctx_w, "cuda_conv", "int8w")
    launches["int8"] = phase_policy(ctx_i, "cuda", "int8")
    with w8a8_kernel(True):
        launches["int8+k5"] = phase_policy(ctx_i, "cuda", "int8+k5")
    arms = [("none", ctx, False), ("int8w_dense", ctx_d, False),
            ("int8w", ctx_w, False), ("int8", ctx_i, False),
            ("int8+k5", ctx_i, True)]
    phase_ab_quant(arms)
    phase_quant_model(ctx, arms)

    # image-conditioned serving on the same Contexts, then every kernel at
    # the sites it brings
    img_launches = phase_image(ctx, ctx_d, smi)
    img_rows = phase_image_kernels(ctx)
    # the Context knobs on the same Contexts, then the kernels at the sites
    # they make
    knob_launches = phase_knobs(ctx, ctx_d, smi)
    knob_rows = phase_knob_kernels(ctx, sites, mm_sites)
    # per-request adapters (ControlNet, LoRA) on the same Contexts, then the
    # kernels at the sites they bring
    adapter_launches, adapter_rows = phase_adapters(ctx, ctx_d, ctx_i, smi)
    # the serving infrastructure (the HTTP service, the stream pool, the
    # CLI, the C API) on the same Context, then K1 at the shapes it brings
    serving_launches, serving_rows = phase_serving(ctx, smi)

    # the user's model: the demo weights written as checkpoint files and
    # served from them, then the text features on the native file
    demo = demo_images(ctx, ctx_d, ctx_w, ctx_i)
    root = tempfile.mkdtemp(prefix="sdtpu-ckpt-")
    try:
        native, loaded = phase_checkpoint(root, ctx, demo, smi)
        phase_text_surface(native, demo)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # batched serving under every policy and the modes with a GEMM kernel,
    # then the kernels at the batch's call shapes
    phase_batch([("cuda", ctx, "cuda", False),
                 ("cuda_gn", ctx, "cuda_gn", False),
                 ("cuda_conv", ctx, "cuda_conv", False),
                 ("int8w_dense", ctx_d, "cuda", False),
                 ("int8+k5", ctx_i, "cuda", True)], float32_latents(ctx))
    b4 = phase_batch_kernels(ctx, ctx_d, ctx_w, ctx_i)

    phase_model(ctx)
    for c, policy in ((ctx, "cuda"), (ctx, "cuda_gn"), (ctx, "cuda_conv"),
                      (ctx_d, "cuda")):
        phase_breakdown(c, policy)
    with w8a8_kernel(True):
        phase_breakdown(ctx_i, "cuda")
    # the port's measurement tools, CLIP score, int8w_dense under cuda_conv
    launches["int8w_dense_conv"] = phase_bench(ctx, ctx_d, conv_sites)
    release(ctx, ctx_d, ctx_w, ctx_i)

    # training on the card's own memory, with the inference Contexts
    # released: K1-bwd at the training sites, the SD1.5 train step (cuda
    # and plain, remat off and on) against float32, its pins, determinism,
    # LoRA, the CLI
    train_launches, train_rows = phase_train(smi, resources)

    # the SD 2.x and SDXL families at full width, then every kernel at their
    # sites
    fam = phase_families(smi)
    fl = fam["launches"]
    # the concat-conditioned families, one Context at a time
    img_launches.update(phase_concat(smi))
    # the staged configurations (LCM, the SDXL two-stage call, the x4
    # upscaler), then the kernels at the sites they bring
    stage_launches, stage_rows = phase_stages(smi)
    # a ControlNet on SDXL, for its sites
    adapter_launches.update(phase_adapters_xl(smi))

    def images(kernel, counter):
        return {"rows": {g: image_summary(rows.get(kernel), None)
                         for g, rows in img_rows.items()},
                "launches": {k: v[counter]
                             for k, v in img_launches.items()}}

    def knobs(kernel, counter):
        return {"rows": image_summary(knob_rows.get(kernel), None),
                "launches": {k: v[counter]
                             for k, v in knob_launches.items()}}

    def stages(kernel, counter):
        return {"rows": {g: image_summary(rows.get(kernel), None)
                         for g, rows in stage_rows.items()},
                "launches": {k: v[counter]
                             for k, v in stage_launches.items()}}

    def adapters(kernel, counter):
        return {"rows": image_summary(adapter_rows.get(kernel), None),
                "launches": {k: v[counter]
                             for k, v in adapter_launches.items()}}

    def serving(kernel, counter):
        return {"rows": image_summary(serving_rows, None)
                if kernel == "flash" else None,
                "launches": {k: v[counter]
                             for k, v in serving_launches.items()}}

    def families(kernel, counter, sdxl_mode, sd21_mode):
        return {"sdxl": family_summary(fam["rows"]["sdxl"][kernel],
                                       fl[f"sdxl_{sdxl_mode}"][counter]),
                "sd21": family_summary(fam["rows"]["sd21"][kernel],
                                       fl.get(f"sd21_{sd21_mode}", {}).get(
                                           counter))}

    # the timed row of each kernel: its most frequent main-path shape (the
    # largest plane among equals)
    gn_main = max(gn_rows, key=lambda r: (r["per_image"], r["shape"][1]))
    affine_main = max(affine_rows, key=lambda r: (r["per_image"],
                                                  r["shape"][1]))
    conv_main = max(conv_rows, key=lambda r: (r["per_image"], r["x"][1]))
    conv_main_int8 = max(conv_rows, key=lambda r: (r["per_image_int8"],
                                                   r["x"][1]))
    k4_main, k5_main = main_row(k4_rows), main_row(k5_rows)
    bwd_main = train_rows[0]
    emit({"kernels": [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "sdtpu_torch/csrc/flash_attn_fwd.cu",
         "replaces": "sdtpu/ops/attention.py:37",
         "launches": launches["cuda"]["flash"],
         "launches_loaded_weights": loaded["cuda"]["flash"],
         "max_abs_err": max(r["max_abs_err"] for r in rows),
         "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
         "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
         "library_ms": rows[0]["library_ms"],
         "design": rows[0]["design"],
         "batch4": batch_summary(b4["flash"]),
         "families": families("flash", "flash", "cuda", "cuda"),
         "image": images("flash", "flash"),
         "knobs": knobs("flash", "flash"),
         "stages": stages("flash", "flash"),
         "adapters": adapters("flash", "flash"),
         "serving": serving("flash", "flash"),
         "train": {k: v["flash"] for k, v in train_launches.items()},
         "timed_shape": rows[0]["shape"] + [rows[0]["heads"]],
         "shapes": rows},
        {"name": "flash_attn_bwd", "route": "cuda",
         "source": "sdtpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": "sdtpu/ops/attention.py:147",
         "note": "plain JAX under custom_vjp (_flash_self) in the "
                 "reference: the backward of K1, the training path's",
         "launches": train_launches["step_cuda"]["flash_bwd"],
         "launches_per_arm": {k: v["flash_bwd"]
                              for k, v in train_launches.items()},
         "max_abs_err": max(r["max_abs_err"] for r in train_rows),
         "ms": bwd_main["ms"], "plain_ms": bwd_main["plain_ms"],
         "bound_ms": bwd_main["bound_ms"], "bound_by": bwd_main["bound_by"],
         "library_ms": bwd_main["library_ms"],
         "library": "F.scaled_dot_product_attention's backward: its "
                    "forward and backward less its forward",
         "plan": bwd_main["plan"], "design": bwd_main["design"],
         "registers": bwd_main["registers"],
         "timed_shape": bwd_main["shape"] + [bwd_main["heads"]],
         "shapes": train_rows},
        {"name": "group_norm_silu", "route": "cuda",
         "source": "sdtpu_torch/csrc/group_norm_silu.cu",
         "replaces": "sdtpu/ops/groupnorm.py:38",
         "launches": launches["cuda_gn"]["group_norm"],
         "launches_loaded_weights": loaded["cuda_gn"]["group_norm"],
         "max_abs_err": max(r["max_abs_err"] for r in gn_rows),
         "ms": gn_main["ms"], "plain_ms": gn_main["plain_ms"],
         "bound_ms": gn_main["bound_ms"], "bound_by": gn_main["bound_by"],
         "library_ms": gn_main["library_ms"],
         "library": "F.group_norm on the NCHW view of x, then F.silu",
         "cuda_site_ms": gn_main["cuda_site_ms"],
         "design": gn_main["design"], "plan": gn_main["plan"],
         "batch4": batch_summary(b4["group_norm"]),
         "families": families("group_norm", "group_norm", "cuda_gn",
                              "cuda_gn"),
         "image": images("group_norm", "group_norm"),
         "knobs": knobs("group_norm", "group_norm"),
         "stages": stages("group_norm", "group_norm"),
         "adapters": adapters("group_norm", "group_norm"),
         "serving": serving("group_norm", "group_norm"),
         "timed_shape": gn_main["shape"] + [gn_main["groups"]]},
        {"name": "conv_gn_silu", "route": "cuda",
         "source": "sdtpu_torch/csrc/conv_gn_silu.cu",
         "replaces": "sdtpu/ops/conv.py:236",
         "also_replaces": "sdtpu/ops/conv.py:301",
         "launches": launches["cuda_conv"]["conv"],
         "launches_loaded_weights": loaded["cuda_conv"]["conv"],
         "launches_loaded_int8w_int8_weights": loaded["int8w"]["conv_int8"],
         "launches_int8w": launches["int8w"]["conv"],
         "launches_int8w_int8_weights": launches["int8w"]["conv_int8"],
         "launches_int8w_dense_conv": launches["int8w_dense_conv"]["conv"],
         "launches_int8w_dense_conv_int8_weights":
             launches["int8w_dense_conv"]["conv_int8"],
         "max_abs_err": max(r["max_abs_err"] for r in conv_rows),
         "ms": conv_main["ms"], "ms_int8_weights": conv_main_int8["ms"],
         "plain_ms": conv_main["plain_ms"],
         "bound_ms": conv_main["bound_ms"],
         "bound_by": conv_main["bound_by"],
         "library_ms": conv_main.get("cuda_site_ms"),
         "library": "the cuda policy's site: bf16 GroupNorm, SiLU, cuDNN "
                    "conv, bias",
         "design": conv_main["design"], "plan": conv_main["plan"],
         "batch4": batch_summary(b4["conv"]),
         "families": families("conv", "conv", "cuda_conv", "cuda_conv"),
         "image": images("conv", "conv"),
         "knobs": knobs("conv", "conv"),
         "stages": stages("conv", "conv"),
         "adapters": adapters("conv", "conv"),
         "serving": serving("conv", "conv"),
         "timed_shape": conv_main["x"] + [conv_main["c_out"],
                                          conv_main["k"]]},
        {"name": "group_norm_affine", "route": "cuda",
         "source": "sdtpu_torch/csrc/group_norm_silu.cu",
         "replaces": "sdtpu/ops/groupnorm.py:38",
         "note": "K2's statistics mode: the prologue operands of "
                 "conv_gn_silu, in place of sdtpu/ops/conv.py:632 "
                 "gn_affine (XLA work in the reference)",
         "launches": launches["cuda_conv"]["group_norm_affine"],
         "launches_loaded_weights": loaded["cuda_conv"]["group_norm_affine"],
         "launches_int8w": launches["int8w"]["group_norm_affine"],
         "launches_int8w_dense_conv":
             launches["int8w_dense_conv"]["group_norm_affine"],
         "max_abs_err": max(r["max_abs_err"] for r in affine_rows),
         "ms": affine_main["ms"], "plain_ms": affine_main["plain_ms"],
         "bound_ms": affine_main["bound_ms"],
         "bound_by": affine_main["bound_by"],
         "library_ms": affine_main["library_ms"],
         "library": "torch.var_mean over the [N, hw, G, C/G] view",
         "design": affine_main["design"], "plan": affine_main["plan"],
         "batch4": batch_summary(b4["group_norm_affine"]),
         "families": families("group_norm_affine", "group_norm_affine",
                              "cuda_conv", "cuda_conv"),
         "image": images("group_norm_affine", "group_norm_affine"),
         "knobs": knobs("group_norm_affine", "group_norm_affine"),
         "stages": stages("group_norm_affine", "group_norm_affine"),
         "adapters": adapters("group_norm_affine", "group_norm_affine"),
         "serving": serving("group_norm_affine", "group_norm_affine"),
         "timed_shape": affine_main["shape"] + [affine_main["groups"]]},
        {"name": "matmul_int8w", "route": "cuda",
         "source": "sdtpu_torch/csrc/matmul_int8w.cu",
         "replaces": "sdtpu/ops/matmul.py:81",
         "launches": launches["int8w_dense"]["matmul_int8w"],
         "launches_loaded_weights": loaded["int8w_dense"]["matmul_int8w"],
         "launches_int8w": launches["int8w"]["matmul_int8w"],
         "launches_int8w_dense_conv":
             launches["int8w_dense_conv"]["matmul_int8w"],
         "max_abs_err": max(r["max_abs_err"] for r in k4_rows),
         "ms": k4_main["ms"], "plain_ms": k4_main["plain_ms"],
         "bound_ms": k4_main["bound_ms"], "bound_by": k4_main["bound_by"],
         "library_ms": k4_main["library_ms"],
         "library": "the unquantized site: bf16 x @ w + b",
         "design": k4_main["design"],
         "sum_pass_launches": launches["int8w_dense"]["matmul_int8w_sum"],
         "sum_pass_launches_int8w": launches["int8w"]["matmul_int8w_sum"],
         "dequant_ms": k4_main["dequant_ms"],
         "batch4": batch_summary(b4["matmul_int8w"]),
         "families": families("matmul_int8w", "matmul_int8w",
                              "int8w_dense", "int8w_dense"),
         "image": images("matmul_int8w", "matmul_int8w"),
         "knobs": knobs("matmul_int8w", "matmul_int8w"),
         "stages": stages("matmul_int8w", "matmul_int8w"),
         "adapters": adapters("matmul_int8w", "matmul_int8w"),
         "serving": serving("matmul_int8w", "matmul_int8w"),
         "timed_shape": [k4_main[d] for d in "mkn"]},
        {"name": "matmul_w8a8", "route": "cuda",
         "source": "sdtpu_torch/csrc/matmul_w8a8.cu",
         "replaces": "sdtpu/ops/matmul.py:150",
         "launches": launches["int8+k5"]["matmul_w8a8"],
         "launches_loaded_weights": loaded["int8+k5"]["matmul_w8a8"],
         "launches_flag_off": launches["int8"]["matmul_w8a8"],
         "max_abs_err": max(r["max_abs_err"] for r in k5_rows),
         "mismatched": sum(r["mismatched"] for r in k5_rows),
         "ms": k5_main["ms"], "plain_ms": k5_main["plain_ms"],
         "bound_ms": k5_main["bound_ms"], "bound_by": k5_main["bound_by"],
         "library_ms": k5_main["library_ms"],
         "library": "the static library path: quantize, torch._int_mm, "
                    "scale, bias (layers.dense with KERNEL_W8A8 off)",
         "product_ms": k5_main["product_ms"],
         "product": "torch._int_mm on activations quantized beforehand: "
                    "the product alone, part of K5's function",
         "design": k5_main["design"],
         "sum_pass_launches": launches["int8+k5"]["matmul_w8a8_sum"],
         "static_path_ms": k5_main["static_path_ms"],
         "batch4": batch_summary(b4["matmul_w8a8"]),
         "families": families("matmul_w8a8", "matmul_w8a8", "int8+k5",
                              "int8+k5"),
         "image": images("matmul_w8a8", "matmul_w8a8"),
         "knobs": knobs("matmul_w8a8", "matmul_w8a8"),
         "stages": stages("matmul_w8a8", "matmul_w8a8"),
         "adapters": adapters("matmul_w8a8", "matmul_w8a8"),
         "serving": serving("matmul_w8a8", "matmul_w8a8"),
         "timed_shape": [k5_main[d] for d in "mkn"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
