"""Probes of the port's kernels on one CUDA card: where a kernel's time goes.

    python3 -m sdtpu_torch.tools.probe conv     # K3, the fused conv
    python3 -m sdtpu_torch.tools.probe w8a8     # K5, the W8A8 GEMM
    python3 -m sdtpu_torch.tools.probe gn       # K2, the GroupNorm's plans
    PYTHONPATH=. python3 <this file> gn_times   # K2 of the checkout in .

Run from the repository's root (device times come from ``chip_smoke.cuda_ms``:
CUDA-graph replays between CUDA events). Each probe prints one JSON object a
line, the first with the card's name and power limit.

``conv``: both kernels of the conv source at the UNet's shapes, each forced
through ``plan_conv`` where the rule would choose the other: at three 3x3
shapes with the SiLU prologue, the affine one and none, the general kernel
(mma.sync, the prologue applied to every staged tap) with split-K at 1 and
at its rule's value: how much of each time is prologue, products and the
split's tail; and at the 1x1 ``proj_in`` shapes.

``w8a8``: K5 at two main-path shapes as the wrapper runs it, with the products
left out and with the copies left out of its K loop (the entry point's
``probe`` argument: the output is then not the product), beside K4 on the
same operands: whether the copies and the quantizing or the products limit a
step.

``gn``: K2 at each distinct main-path GroupNorm plane (the UNet's, the VAE's
two resident ones and one streamed) under its static rule's plan, the same
with the rows in two chunks through two buffers, and every other plan of spans and cluster
sizes that fits a block: device times of both modes, each plan's co-resident
clusters, each against the plain version: which tiling the rule should
choose. Beside them the yardsticks: one tiny launch, a copy of x (the floor
of a pass that reads x and writes y), ``F.group_norm`` + SiLU on the NCHW
view, ``torch.var_mean`` over the groups.

``gn_times``: K2's both modes at the UNet's GroupNorm planes as the
checkout it is imported from runs them (``group_norm_cuda``,
``group_norm_affine_cuda``): run by path from the root of another checkout,
with ``PYTHONPATH=.``, it times that checkout's kernel, so two commits
compare in one call.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

CONV_SHAPES = [((2, 64, 64, 320), 320, 3), ((2, 16, 16, 1280), 1280, 3),
               ((2, 8, 8, 1280), 1280, 3), ((2, 64, 64, 320), 320, 1),
               ((2, 32, 32, 640), 640, 1), ((2, 16, 16, 1280), 1280, 1)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit({"probe": "device", "nvidia_smi": smi, "torch": torch.__version__})


def probe_conv() -> None:
    from chip_smoke import cuda_ms
    from sdtpu_torch.ops import conv as C
    from sdtpu_torch.ops import groupnorm as G

    g = torch.Generator(device="cuda").manual_seed(5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    real_plan = C.plan_conv
    for shape, c_out, ks in CONV_SHAPES:
        n, h, w_, c_in = shape
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn((c_out, c_in, ks, ks), generator=g, device="cuda")
             / (ks * ks * c_in) ** 0.5).to(torch.bfloat16).contiguous(
                 memory_format=torch.channels_last)
        b = torch.randn((n, c_out), generator=g, device="cuda")
        pn = {"scale": torch.ones(c_in, device="cuda", dtype=torch.bfloat16),
              "bias": torch.zeros(c_in, device="cuda", dtype=torch.bfloat16)}
        a, d = G.group_norm_affine_cuda(pn, x, 32, 1e-5)
        general = C.general_plan(n * h * w_, c_in, c_out, ks, sms)
        slab = C.slab_plan(n, h, w_, c_in, c_out, ks, sms)
        row = {"probe": "conv", "x": list(shape), "c_out": c_out, "k": ks,
               "rule": real_plan(n, h, w_, c_in, c_out, ks, sms)["design"],
               "rule_splits": general["splits"], "slab_plan": slab}
        prologues = (("silu", {"a": a, "d": d, "silu": True}),
                     ("affine", {"a": a, "d": d, "silu": False}),
                     ("no_prologue", {}))
        for name, kw in prologues if ks == 3 else prologues[1:2]:
            plans = [("slab", slab)] + [
                (f"general_splits{s}", {**general, "splits": s})
                for s in sorted({1, general["splits"]})]
            for label, plan in plans:
                C.plan_conv = lambda *args, plan=plan: plan
                row[f"{label}_ms_{name}"] = cuda_ms(
                    lambda: C.fused_conv_cuda(x, w, b, **kw))
            C.plan_conv = real_plan
        emit(row)


def probe_w8a8() -> None:
    from chip_smoke import cuda_ms, mm_case
    from sdtpu_torch.ops import _build
    from sdtpu_torch.ops import matmul as MM

    g = torch.Generator(device="cuda").manual_seed(7)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = _build.library()
    for m, k, n in ((2048, 640, 5120), (512, 1280, 1280)):
        x, w8, scale, b, _ = mm_case(m, k, n, True, g)
        xs = (x.float().abs().max() / 127.0).reshape(1)
        plan = MM.plan_w8a8(m, k, n, sms)
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        partial = None
        if plan["splits"] > 1:
            partial = torch.empty((plan["splits"], m, n), dtype=torch.int32,
                                  device="cuda")

        def run(probe):
            err = lib.sdtpu_matmul_w8a8(
                x.data_ptr(), w8.data_ptr(), scale.data_ptr(), xs.data_ptr(),
                b.data_ptr(), out.data_ptr(),
                None if partial is None else partial.data_ptr(), m, k, n,
                plan["bn"], plan["splits"], plan["steps"], probe,
                torch.cuda.current_stream().cuda_stream)
            _build.check_launch(err, "matmul_w8a8")

        emit({"probe": "w8a8", "m": m, "k": k, "n": n, "plan": plan,
              "ms": cuda_ms(lambda: run(0)),
              "ms_no_products": cuda_ms(lambda: run(1)),
              "ms_no_copies": cuda_ms(lambda: run(2)),
              "wrapper_ms": cuda_ms(lambda: MM.matmul_w8a8_cuda(
                  x, w8, scale, xs, b)),
              "int8w_ms": cuda_ms(lambda: MM.matmul_int8w_cuda(
                  x, w8, scale, b))})


# (n, hw, c) of the distinct GroupNorm planes of the main path (32 groups):
# the UNet's at the CFG batch, the VAE decoder's at batch 1
GN_PLANES = [(2, 4096, 320), (2, 4096, 640), (2, 4096, 960), (2, 1024, 320),
             (2, 1024, 640), (2, 1024, 960), (2, 1024, 1280), (2, 1024, 1920),
             (2, 256, 640), (2, 256, 1280), (2, 256, 1920), (2, 256, 2560),
             (2, 64, 1280), (2, 64, 2560)]
VAE_PLANES = [(1, 4096, 512), (1, 16384, 512), (1, 262144, 128)]


def _gn_inputs(n, hw, c, g):
    x = (torch.randn((n, hw, c), generator=g, device="cuda") * 2 + 0.5).to(
        torch.bfloat16)
    p = {"scale": (torch.rand(c, generator=g, device="cuda") + 0.5).to(
             torch.bfloat16),
         "bias": torch.randn(c, generator=g, device="cuda").to(
             torch.bfloat16)}
    return x, p


def probe_gn() -> None:
    import math

    from chip_smoke import cuda_ms, rel_err
    from sdtpu_torch.ops import conv as C
    from sdtpu_torch.ops import groupnorm as G

    g = torch.Generator(device="cuda").manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    real_plan = G.plan_gn
    one = torch.zeros(1, device="cuda")
    emit({"probe": "gn_floor", "launch_ms": cuda_ms(lambda: one.add_(1))})
    for n, hw, c in GN_PLANES + VAE_PLANES:
        x, p = _gn_inputs(n, hw, c, g)
        y = torch.empty_like(x)
        rule = real_plan(n, hw, c, 32, sms)
        cpg = c // 32
        unit = math.lcm(cpg, G.gn_vec(c))

        def plan_of(span, lay):
            return {**rule, "span": span, **lay,
                    "grid": (lay["cluster"], n * (c // span)),
                    "blocks": lay["cluster"] * n * (c // span)}

        # the rule's tiling with the rows in two chunks through two
        # buffers: the second lands while the first is reduced
        halves = G._layout(hw, rule["span"], cpg, rule["cluster"],
                           -(-rule["rows"] // 2))
        plans = [rule] + ([plan_of(rule["span"], halves)]
                          if rule["variant"] == "resident" else [])
        for span in (s for s in range(unit, c + 1, unit) if c % s == 0):
            for cl in (1, 2, 4, 8, 12, 16):
                if cl > hw:
                    continue
                lay = G._layout(hw, span, cpg, cl)
                if lay["smem"] > G._SMEM_CAP:
                    lay = G._layout(hw, span, cpg, cl,
                                    max(1, G._CHUNK // (2 * span)))
                plan = plan_of(span, lay)
                if plan["smem"] <= G._SMEM_CAP and plan not in plans:
                    plans.append(plan)
        ref = G.group_norm_reference(p, x.float(), 32, 1e-5, True)
        ra, rd = C.gn_affine_reference(p, x, 32, 1e-5)
        emit({"probe": "gn_yardsticks", "shape": [n, hw, c],
              "copy_ms": cuda_ms(lambda: y.copy_(x)),
              "library_ms": cuda_ms(lambda: torch.nn.functional.silu(
                  torch.nn.functional.group_norm(
                      x.view(n, hw, c).permute(0, 2, 1), 32, p["scale"],
                      p["bias"], 1e-5))),
              "var_mean_ms": cuda_ms(lambda: torch.var_mean(
                  x.view(n, hw, 32, cpg), dim=(1, 3), correction=0))})
        for plan in plans:
            G.plan_gn = lambda *args, plan=plan: plan
            try:
                y = G.group_norm_cuda(p, x, 32, 1e-5, True)
                a, d = G.group_norm_affine_cuda(p, x, 32, 1e-5)
                torch.cuda.synchronize()
                emit({"probe": "gn", "shape": [n, hw, c],
                      "rule": plan is rule,
                      **{k: plan[k] for k in ("span", "cluster", "rows",
                                              "chunk", "bufs", "variant",
                                              "smem", "blocks")},
                      "co_resident": G.co_resident(n, hw, c, 32, plan, True),
                      "err": rel_err(y, ref),
                      "affine_err": max(rel_err(a, ra), rel_err(d, rd)),
                      "ms": cuda_ms(lambda: G.group_norm_cuda(
                          p, x, 32, 1e-5, True)),
                      "affine_ms": cuda_ms(lambda: G.group_norm_affine_cuda(
                          p, x, 32, 1e-5))})
            finally:
                G.plan_gn = real_plan
        torch.cuda.empty_cache()


def probe_gn_times() -> None:
    from chip_smoke import cuda_ms
    from sdtpu_torch.ops import groupnorm as G

    g = torch.Generator(device="cuda").manual_seed(4)
    for n, hw, c in GN_PLANES:
        x, p = _gn_inputs(n, hw, c, g)
        emit({"probe": "gn_times", "module": G.__file__, "shape": [n, hw, c],
              "ms": cuda_ms(lambda: G.group_norm_cuda(p, x, 32, 1e-5, True)),
              "affine_ms": cuda_ms(lambda: G.group_norm_affine_cuda(
                  p, x, 32, 1e-5))})


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    probes = {"conv": probe_conv, "w8a8": probe_w8a8, "gn": probe_gn,
              "gn_times": probe_gn_times}
    if what not in probes:
        print(f"usage: python3 -m sdtpu_torch.tools.probe {'|'.join(probes)}",
              file=sys.stderr)
        return 2
    card()
    probes[what]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
