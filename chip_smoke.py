"""Smoke run of the PyTorch/CUDA port (sdtpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON object per line:

1. device: the card's name and power limit (also printed raw, as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them), torch and CUDA versions;
2. build: nvcc builds the five kernels from sdtpu_torch/csrc (first use);
   resources: registers and spills of the wgmma kernels (K1, K3, K4, K5),
   from ptxas, taken beside the build;
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
   of 3 under ``cuda``, the mean of 2 under the others;
7. ab: s/image under plain, cuda, cuda_gn and cuda_conv, in turns;
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
9. model: one SD1.5 UNet eval and one VAE decode at full width under each
   policy, each against float32;
10. breakdown: stage times and a profiler trace of one image under cuda,
   cuda_gn, cuda_conv, int8w_dense and int8 with K5.

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

import contextlib
import json
import statistics
import subprocess
import sys
import time

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
MM_W8A8_PER_EVAL = 60 + 5 + 20
# of them the sites that split K (K5's steps are 128 deep): every site of
# 512 and 128 rows but ff1 (54), and attn2's k and v at 64x64 and 32x32 (20)
MM_W8A8_SUMS_PER_EVAL = 54 + 20
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
}
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


def phase_build():
    """Build and load the kernels; beside the build, ``nvcc -Xptxas -v`` on
    the wgmma kernels' sources (K1, K3, K4, K5) for their registers and
    spills."""
    from concurrent.futures import ThreadPoolExecutor

    from sdtpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.library_path()
    fresh = not path.exists()
    names = ("flash_attn_fwd.cu", "conv_gn_silu.cu", "matmul_int8w.cu",
             "matmul_w8a8.cu")
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


def phase_kernel():
    """K1 at the main path's shapes, then at ``FLASH_RAGGED`` (there without
    the plain version's time). Each phase line also carries the tile the
    wrapper's static rule chose and ``exp_bound_ms``, the time the softmax's
    exponentials alone need on the special-function units (derived, not
    measured, so it stays out of the ``kernels`` line)."""
    from sdtpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    cases = [(b, s, s, c, h, True) for b, s, c, h in SHAPES]
    cases += [(*case, False) for case in FLASH_RAGGED]
    for b, sq, sk, c, heads, main in cases:
        d = c // heads
        q = torch.randn((b, sq, c), generator=g, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn((b, sk, c), generator=g, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        out = A.flash_attention_cuda(q, k, v, heads)
        torch.cuda.synchronize()
        ref = A.flash_attention_reference(q.float(), k.float(), v.float(),
                                          heads)
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
            row["plain_ms"] = cuda_ms(
                lambda: A.flash_attention_reference(q, k, v, heads))
            row["plain_tflops"] = flop / row["plain_ms"] / 1e9
        emit({"phase": "kernel" if main else "kernel_ragged", **row,
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


def phase_kernel_gn(gn_sites):
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
    cases += [(k, 0) for k in GN_RAGGED]
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
        emit({"phase": "kernel_gn", **row})
        if not err <= FUSED_TOL * scale:
            raise AssertionError(f"group_norm kernel disagrees at {row}")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def phase_kernel_gn_affine(conv_sites):
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
    cases += [(k[:4], 0) for k in GN_RAGGED]
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
        emit({"phase": "kernel_gn_affine", **row})
        if not err <= AFFINE_TOL:
            raise AssertionError(f"gn_affine kernel disagrees at {row}")
        rows.append(row)
        torch.cuda.empty_cache()
    if sum(r["per_image"] for r in rows) != PINNED["cuda_conv"][
            "group_norm_affine"]:
        raise AssertionError("statistics-mode sites differ from the pins")
    return rows


def phase_kernel_conv(conv_sites):
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
    # quantize="int8w", which quantizes the UNet's sites: the CFG batch of 2)
    cases = [(k, n, False, 0, None) for k, n in main]
    cases += [(k, 0, True, n, None) for k, n in main if k[0][0] == 2]
    cases += [((s, co, k, pro, True), 0, q8, 0, want)
              for s, co, k, pro, q8, want in CONV_RAGGED]
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
        emit({"phase": "kernel_conv", **row})
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


def phase_breakdown(ctx, policy):
    """Where one image's time goes under ``policy``: CUDA-event times of
    the three stages, then a torch.profiler trace of one image (device busy
    and idle share, the kernels that take the most device time)."""
    from torch.profiler import ProfilerActivity, profile

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
        x = pipeline.denoise(ctx.params, context, gen, 7.5, ctx.cfg,
                             ctx.steps, True, ctx.kernels)
        ev[2].record()
        pipeline.decode_latents(ctx.params, x, ctx.cfg, ctx.kernels)
        ev[3].record()
    torch.cuda.synchronize()
    res = {"phase": "breakdown", "kernels": policy,
           "quantize": ctx.quantize, "text_ms": ev[0].elapsed_time(ev[1]),
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
    giving the same bytes, s/image as the mean of 2 (the policies and modes
    are compared in ``ab`` and ``ab_quant``, in turns)."""
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
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        ctx.generate(PROMPT, guidance=7.5)
        times.append(time.perf_counter() - t0)
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
    cuda_conv, then back, then there again: 3 each) on the same context and
    weights. It runs
    right after the main-path phases, before the float32 and profiler
    phases, so every arm sees the state the main-path timing saw."""
    times = {k: [] for k in POLICIES}
    for k in POLICIES + POLICIES[::-1] + POLICIES:
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


def unet_inputs(cfg, seed):
    """One CFG batch of UNet inputs at the configuration's widths."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = cfg.compute_dtype
    x = torch.randn((2, cfg.latent_size, cfg.latent_size,
                     cfg.latent_channels), generator=g, device="cuda").to(dt)
    te = torch.randn((2, cfg.unet.time_embed_dim), generator=g,
                     device="cuda").to(dt)
    context = torch.randn((2, cfg.clip.context_len, cfg.unet.context_dim),
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


def phase_mm_sites(ctx_d, ctx_w, ctx_i):
    """The call shapes K4 and K5 get on the quantized main paths, and how
    many times per image: one UNet eval (x STEPS) under each mode with the
    wrappers' arguments logged. Keys are (m, k, n, bias)."""
    from sdtpu_torch.models import unet
    from sdtpu_torch.ops import matmul as MM

    x, te, context = unet_inputs(ctx_d.cfg, 6)
    found = {}
    for label, ctx, name, flag in (
            ("int8w_dense", ctx_d, "matmul_int8w_cuda", False),
            ("int8w", ctx_w, "matmul_int8w_cuda", False),
            ("int8+k5", ctx_i, "matmul_w8a8_cuda", True)):
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
    emit({"phase": "mm_sites", **{
        f"{k}_{what}": v for k, sites in found.items() for what, v in (
            ("shapes", len(sites)), ("per_image", sum(sites.values())))}})
    for label, key in (("int8w_dense", "matmul_int8w"),
                       ("int8w", "matmul_int8w"),
                       ("int8+k5", "matmul_w8a8")):
        if sum(found[label].values()) != PINNED[label][key]:
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


def phase_kernel_mm(sites):
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
    for key in sites["int8w"]:
        k4.setdefault(key, 0)
    k5 = sites["int8+k5"]
    rows = {"matmul_int8w": [], "matmul_w8a8": []}
    for name, cases in (
            ("matmul_int8w", sorted(k4.items()) + [(c, 0) for c in MM_RAGGED]),
            ("matmul_w8a8", sorted(k5.items()) + [(c, 0) for c in MM_RAGGED])):
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
            emit({"phase": "kernel_mm", "kernel": name, **row, **derived})
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

    name, _ = phase_device()
    phase_build()
    rows = phase_kernel()
    ctx = Context(config="sd15", steps=STEPS, sampler="dpm", kernels="auto",
                  seed=0, device="cuda")
    if ctx.kernels != "cuda":
        raise AssertionError(f"kernels resolved to {ctx.kernels}")
    gn_sites, conv_sites = phase_sites(ctx)
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

    # quantized serving: one Context per mode, the same demo weights
    ctx_d = Context(config="sd15", steps=STEPS, kernels="cuda",
                    quantize="int8w_dense", device="cuda")
    ctx_w = Context(config="sd15", steps=STEPS, kernels="cuda_conv",
                    quantize="int8w", device="cuda")
    ctx_i = Context(config="sd15", steps=STEPS, kernels="cuda",
                    quantize="int8", device="cuda")
    phase_calibrate(ctx_i)
    phase_widening()
    mm_rows = phase_kernel_mm(phase_mm_sites(ctx_d, ctx_w, ctx_i))
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

    phase_model(ctx)
    for c, policy in ((ctx, "cuda"), (ctx, "cuda_gn"), (ctx, "cuda_conv"),
                      (ctx_d, "cuda")):
        phase_breakdown(c, policy)
    with w8a8_kernel(True):
        phase_breakdown(ctx_i, "cuda")

    # the timed row of each kernel: its most frequent main-path shape (the
    # largest plane among equals)
    gn_main = max(gn_rows, key=lambda r: (r["per_image"], r["shape"][1]))
    affine_main = max(affine_rows, key=lambda r: (r["per_image"],
                                                  r["shape"][1]))
    conv_main = max(conv_rows, key=lambda r: (r["per_image"], r["x"][1]))
    conv_main_int8 = max(conv_rows, key=lambda r: (r["per_image_int8"],
                                                   r["x"][1]))
    k4_main, k5_main = main_row(k4_rows), main_row(k5_rows)
    emit({"kernels": [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "sdtpu_torch/csrc/flash_attn_fwd.cu",
         "replaces": "sdtpu/ops/attention.py:37",
         "launches": launches["cuda"]["flash"],
         "max_abs_err": max(r["max_abs_err"] for r in rows),
         "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
         "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
         "library_ms": rows[0]["library_ms"],
         "design": rows[0]["design"],
         "timed_shape": rows[0]["shape"] + [rows[0]["heads"]],
         "shapes": rows},
        {"name": "group_norm_silu", "route": "cuda",
         "source": "sdtpu_torch/csrc/group_norm_silu.cu",
         "replaces": "sdtpu/ops/groupnorm.py:38",
         "launches": launches["cuda_gn"]["group_norm"],
         "max_abs_err": max(r["max_abs_err"] for r in gn_rows),
         "ms": gn_main["ms"], "plain_ms": gn_main["plain_ms"],
         "bound_ms": gn_main["bound_ms"], "bound_by": gn_main["bound_by"],
         "library_ms": gn_main["library_ms"],
         "library": "F.group_norm on the NCHW view of x, then F.silu",
         "cuda_site_ms": gn_main["cuda_site_ms"],
         "design": gn_main["design"], "plan": gn_main["plan"],
         "timed_shape": gn_main["shape"] + [gn_main["groups"]]},
        {"name": "conv_gn_silu", "route": "cuda",
         "source": "sdtpu_torch/csrc/conv_gn_silu.cu",
         "replaces": "sdtpu/ops/conv.py:236",
         "also_replaces": "sdtpu/ops/conv.py:301",
         "launches": launches["cuda_conv"]["conv"],
         "launches_int8w": launches["int8w"]["conv"],
         "launches_int8w_int8_weights": launches["int8w"]["conv_int8"],
         "max_abs_err": max(r["max_abs_err"] for r in conv_rows),
         "ms": conv_main["ms"], "ms_int8_weights": conv_main_int8["ms"],
         "plain_ms": conv_main["plain_ms"],
         "bound_ms": conv_main["bound_ms"],
         "bound_by": conv_main["bound_by"],
         "library_ms": conv_main.get("cuda_site_ms"),
         "library": "the cuda policy's site: bf16 GroupNorm, SiLU, cuDNN "
                    "conv, bias",
         "design": conv_main["design"], "plan": conv_main["plan"],
         "timed_shape": conv_main["x"] + [conv_main["c_out"],
                                          conv_main["k"]]},
        {"name": "group_norm_affine", "route": "cuda",
         "source": "sdtpu_torch/csrc/group_norm_silu.cu",
         "replaces": "sdtpu/ops/groupnorm.py:38",
         "note": "K2's statistics mode: the prologue operands of "
                 "conv_gn_silu, in place of sdtpu/ops/conv.py:632 "
                 "gn_affine (XLA work in the reference)",
         "launches": launches["cuda_conv"]["group_norm_affine"],
         "launches_int8w": launches["int8w"]["group_norm_affine"],
         "max_abs_err": max(r["max_abs_err"] for r in affine_rows),
         "ms": affine_main["ms"], "plain_ms": affine_main["plain_ms"],
         "bound_ms": affine_main["bound_ms"],
         "bound_by": affine_main["bound_by"],
         "library_ms": affine_main["library_ms"],
         "library": "torch.var_mean over the [N, hw, G, C/G] view",
         "design": affine_main["design"], "plan": affine_main["plan"],
         "timed_shape": affine_main["shape"] + [affine_main["groups"]]},
        {"name": "matmul_int8w", "route": "cuda",
         "source": "sdtpu_torch/csrc/matmul_int8w.cu",
         "replaces": "sdtpu/ops/matmul.py:81",
         "launches": launches["int8w_dense"]["matmul_int8w"],
         "launches_int8w": launches["int8w"]["matmul_int8w"],
         "max_abs_err": max(r["max_abs_err"] for r in k4_rows),
         "ms": k4_main["ms"], "plain_ms": k4_main["plain_ms"],
         "bound_ms": k4_main["bound_ms"], "bound_by": k4_main["bound_by"],
         "library_ms": k4_main["library_ms"],
         "library": "the unquantized site: bf16 x @ w + b",
         "design": k4_main["design"],
         "sum_pass_launches": launches["int8w_dense"]["matmul_int8w_sum"],
         "sum_pass_launches_int8w": launches["int8w"]["matmul_int8w_sum"],
         "dequant_ms": k4_main["dequant_ms"],
         "timed_shape": [k4_main[d] for d in "mkn"]},
        {"name": "matmul_w8a8", "route": "cuda",
         "source": "sdtpu_torch/csrc/matmul_w8a8.cu",
         "replaces": "sdtpu/ops/matmul.py:150",
         "launches": launches["int8+k5"]["matmul_w8a8"],
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
         "timed_shape": [k5_main[d] for d in "mkn"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
