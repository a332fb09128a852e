"""Per-shape attribution of the tensor-core work in one part, the
counterpart of ``tools/attr_mxu.py``: for each shape of product or
convolution in one UNet eval (CFG batch 2), one VAE decode or one text
encode (batch 2) under a kernel policy, its device time, FLOPs a call,
calls, TFLOP/s, % of the card's bf16 peak and share of the part's device
time, as a markdown table; then the part's device time by class
(``bench.xprof.classify``).

    python -m sdtpu_torch.tools.attr_mma --part unet --kernels cuda_conv
    python -m sdtpu_torch.tools.attr_mma --part vae

How it works (one process, one part, one card):

1. one call runs with a ``TorchDispatchMode`` that logs every library
   product and convolution (``aten.mm``, ``addmm``, ``bmm``, ``baddbmm``,
   ``convolution``) with its operands' shapes and FLOPs (the formulas of
   ``torch.utils.flop_counter``), and with the hand-written kernels'
   wrappers replaced by recorders that log each launch and its FLOPs (K1:
   QK^T and PV, 4 b s_q s_k c; K3: 2 n h w c_out c_in k^2; K4, K5: 2 m k
   n), all in launch order;
2. one more call runs under ``torch.profiler``: the library ops are
   matched in order to the profiler's outermost ``aten::`` events of the
   same names (their shapes are the log's), and each gets its event's
   device time (its kernels'); the hand-written kernels are launched from
   ctypes and have no aten op, so their device kernels are matched by
   ``__global__`` name, in launch order, to the logged launches (a split's
   sum pass goes to the launch before it);
3. everything is aggregated by shape key. On the CPU (policy ``plain``) the
   aten events' host time stands in for device time.
"""

from __future__ import annotations

import argparse
import contextlib
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the library's tensor-core ops, as the profiler names them
MMA_OPS = ("aten::convolution", "aten::mm", "aten::addmm", "aten::bmm",
           "aten::baddbmm")
#: the parts -> (the runner's part, batch): the reference tool's shapes
PARTS = {"unet": ("unet", 2), "vae": ("vae_decoder", 1),
         "clip": ("text_encoder", 2)}
#: the hand-written tensor-core kernels (``bench.xprof``'s classes) and
#: their wrappers: (class, the wrapper's module, its name)
KERNELS = (("K1", "attention", "flash_attention_cuda"),
           ("K3", "conv", "fused_conv_cuda"),
           ("K4", "matmul", "matmul_int8w_cuda"),
           ("K5", "matmul", "matmul_w8a8_cuda"))


def _dims(t):
    return "x".join(map(str, t.shape))


class _LibraryLog(TorchDispatchMode):
    """Logs (key, flops) of each library product and convolution, in
    order."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        name = f"aten::{func._overloadpacket.__name__}"
        if name not in MMA_OPS:
            # a composite op (matmul, conv2d, einsum under inference mode)
            # into the ops it runs, as FlopCounterMode does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if name in MMA_OPS:
            flops = flop_registry[func._overloadpacket](*args, **kwargs,
                                                        out_val=out)
            op = name[6:]
            if op == "convolution":
                key = f"conv {_dims(args[0])} * {_dims(args[1])}"
            else:
                a, b = args[-2], args[-1]
                key = f"{op} {_dims(a)} . {_dims(b)}"
            self.log.append((name, key, float(flops)))
        return out


def _kernel_key(cls, args, kwargs):
    """(key, flops) of a hand-written kernel's launch from its wrapper's
    arguments."""
    if cls == "K1":
        q, k, _, heads = args[:4]
        b, sq, c = q.shape
        return (f"K1 flash {b}x{sq}x{c}/{heads} . {k.shape[1]}",
                4.0 * b * sq * k.shape[1] * c)
    if cls == "K3":
        x, w = args[0], args[1]
        n, h, ww, cin = x.shape
        int8 = " int8" if kwargs.get("w_scale") is not None else ""
        return (f"K3 conv {_dims(x)} * {_dims(w)}{int8}",
                2.0 * n * h * ww * w.shape[0] * cin * w.shape[-1] ** 2)
    x, w8 = args[0], args[1]
    m = x.numel() // x.shape[-1]
    return (f"{cls} mm {m}x{w8.shape[0]} . {_dims(w8)}",
            2.0 * m * w8.shape[0] * w8.shape[1])


@contextlib.contextmanager
def _kernel_log(log):
    """The hand-written kernels' wrappers replaced by recorders that log
    (class, key, flops) of each launch and then launch."""
    import importlib

    saved = []
    for cls, mod_name, fn_name in KERNELS:
        module = importlib.import_module(f"sdtpu_torch.ops.{mod_name}")
        real = getattr(module, fn_name)

        def record(*args, _real=real, _cls=cls, **kwargs):
            log.append((_cls, *_kernel_key(_cls, args, kwargs)))
            return _real(*args, **kwargs)

        # the wrapper counts its launches on what its module holds
        record.launches = record.launches_int8 = record.sum_launches = 0
        saved.append((module, fn_name, real))
        setattr(module, fn_name, record)
    try:
        yield
    finally:
        for module, fn_name, real in saved:
            setattr(module, fn_name, real)


def _event_time_us(evt, cuda: bool) -> float:
    if not cuda:
        return evt.cpu_time_total
    total = getattr(evt, "device_time_total", None)
    return total if total is not None else evt.cuda_time_total


def _outermost(events):
    """The profiler's ``MMA_OPS`` events that no other of them encloses,
    in start order."""
    out = []
    for e in events:
        if e.name not in MMA_OPS:
            continue
        p = e.cpu_parent
        while p is not None and p.name not in MMA_OPS:
            p = p.cpu_parent
        if p is None:
            out.append(e)
    return sorted(out, key=lambda e: e.time_range.start)


def match_kernels(kernels, own, rows) -> None:
    """Add the hand-written kernels' device time to ``rows``: the device
    kernels ``kernels`` ([(name, start_ns, duration_ns)] in launch order)
    of each class of ``KERNELS`` matched in order to the logged launches
    ``own`` ([(class, key, flops)] in launch order), a sum pass to the
    launch before it. Raises where the counts differ."""
    from sdtpu_torch.bench.xprof import own_kernel

    launches = {cls: [(key, f) for c, key, f in own if c == cls]
                for cls, _, _ in KERNELS}
    done = dict.fromkeys(launches, 0)
    last = {}
    for name, _, d in kernels:
        cls, is_sum = own_kernel(name) or (None, False)
        if cls not in launches:
            continue
        if not is_sum:
            if done[cls] >= len(launches[cls]):
                raise RuntimeError(f"{cls}: more kernels than logged "
                                   f"launches")
            last[cls] = launches[cls][done[cls]]
            done[cls] += 1
            rows[last[cls][0]]["flops"] += last[cls][1]
            rows[last[cls][0]]["calls"] += 1
        rows[last[cls][0]]["us"] += d / 1e3
    for cls, n in done.items():
        if n != len(launches[cls]):
            raise RuntimeError(f"{cls}: {len(launches[cls])} launches "
                               f"logged, {n} kernels profiled")


def attribute(fn, args) -> dict:
    """Attribute one call of ``fn(*args)`` (see the module's docstring).
    Returns {"rows": {key: {us, flops, calls}}, "total_us", "attributed_us",
    "flops", "by_class": {class: us}, "device": bool}."""
    from sdtpu_torch.bench.xprof import (classify, device_events, on_cuda,
                                         trace)

    cuda = on_cuda(args)
    lib, own = [], []
    with torch.inference_mode():
        fn(*args)                            # warm: builds, first launches
        with _kernel_log(own), _LibraryLog(lib):
            fn(*args)
    prof = trace(fn, args, cuda)
    rows: dict = defaultdict(lambda: {"us": 0.0, "flops": 0.0, "calls": 0})
    events = _outermost(prof.events())
    if [e.name for e in events] != [name for name, _, _ in lib]:
        raise RuntimeError(f"{len(events)} profiled products and convs, "
                           f"{len(lib)} logged: the two calls differ")
    for e, (_, key, flops) in zip(events, lib):
        r = rows[key]
        r["us"] += _event_time_us(e, cuda)
        r["flops"] += flops
        r["calls"] += 1
    by_class: dict = defaultdict(float)
    if cuda:
        kernels = device_events(prof)
        total = sum(d for _, _, d in kernels) / 1e3
        for name, _, d in kernels:
            by_class[classify(name)] += d / 1e3
        match_kernels(kernels, own, rows)
    else:
        total = 0.0
        for avg in prof.key_averages():
            if avg.key.startswith("aten::"):
                total += avg.self_cpu_time_total
                by_class[classify(avg.key)] += avg.self_cpu_time_total
    attributed = sum(r["us"] for r in rows.values())
    return {"rows": {k: dict(v) for k, v in rows.items()},
            "total_us": total, "attributed_us": attributed,
            "flops": sum(r["flops"] for r in rows.values()),
            "by_class": dict(by_class), "device": cuda}


def part_call(part: str, cfg, kernels: str, device, params=None):
    """(fn, args) of ``part`` (a name of ``PARTS``) at the runner's shapes,
    on the demo weights unless ``params`` are given."""
    from sdtpu_torch.bench.runner import demo_params, part_specs

    name, batch = PARTS[part]
    if params is None:
        params = demo_params(cfg, device)
    return part_specs(cfg, params, kernels, device, batch=batch)[name]


def table(res: dict, peak: float | None, top: int = 40) -> str:
    """The markdown tables of ``attribute``'s result."""
    total = max(res["total_us"], 1e-9)
    unit = "device" if res["device"] else "host"
    out = [f"# {unit} total {total / 1e3:.3f} ms; attributed to products "
           f"and convs {res['attributed_us'] / 1e3:.3f} ms "
           f"({100 * res['attributed_us'] / total:.1f}%); "
           f"{res['flops'] / 1e12:.4f} TFLOP", "",
           f"| shape | {unit} ms | % part | GFLOP a call | calls | TFLOP/s "
           f"| % bf16 peak |", "|---|---|---|---|---|---|---|"]
    rows = sorted(res["rows"].items(), key=lambda kv: -kv[1]["us"])
    for key, r in rows[:top]:
        tflops = r["flops"] / max(r["us"] * 1e-6, 1e-12) / 1e12
        pk = f"{100 * tflops / peak:.1f}" if peak else "-"
        out.append(f"| {key} | {r['us'] / 1e3:.4f} | "
                   f"{100 * r['us'] / total:.1f} | "
                   f"{r['flops'] / r['calls'] / 1e9:.3f} | {r['calls']} | "
                   f"{tflops:.1f} | {pk} |")
    if peak and res["attributed_us"]:
        eff = res["flops"] / (total * 1e-6) / 1e12
        out.append(f"\n# whole part: {eff:.1f} TFLOP/s = "
                   f"{100 * eff / peak:.1f}% of the bf16 peak")
    out += ["", "| class | ms | % part |", "|---|---|---|"]
    for cls, us in sorted(res["by_class"].items(), key=lambda kv: -kv[1]):
        out.append(f"| {cls} | {us / 1e3:.3f} | {100 * us / total:.1f} |")
    return "\n".join(out)


def main(argv=None) -> int:
    import dataclasses

    from sdtpu_torch.bench.flops import peak_tflops
    from sdtpu_torch.bench.runner import check_device, device_kind, resolve
    from sdtpu_torch.config import CONFIGS

    ap = argparse.ArgumentParser(prog="attr_mma")
    ap.add_argument("--part", default="unet", choices=sorted(PARTS))
    ap.add_argument("--config", default="sd15", choices=sorted(CONFIGS))
    ap.add_argument("--size", type=int, default=None,
                    help="image size (default: the config's native size)")
    ap.add_argument("--kernels", default="auto",
                    choices=["auto", "cuda", "cuda_gn", "cuda_conv",
                             "plain"])
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--platform", default="auto",
                    choices=["auto", "cpu", "cuda"])
    args = ap.parse_args(argv)
    device = check_device("cpu" if args.platform == "cpu" else "cuda")
    cfg = CONFIGS[args.config]
    if args.size and args.size != cfg.image_size:
        cfg = dataclasses.replace(cfg, latent_size=args.size // cfg.upscale)
    kernels = resolve(args.kernels, device)
    fn, fargs = part_call(args.part, cfg, kernels, device)
    res = attribute(fn, fargs)
    kind = device_kind(device)
    peak = peak_tflops(kind)
    print(f"# part={args.part} config={args.config} "
          f"size={cfg.image_size} kernels={kernels} device={kind} "
          f"peak_bf16={peak} TFLOP/s")
    print(table(res, peak, args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
