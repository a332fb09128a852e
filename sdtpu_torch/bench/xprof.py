"""Per-kernel device profiles through ``torch.profiler``, the counterpart
of ``sdtpu/bench/xprof.py``.

``profile_ops`` runs a function once warm, then once under the profiler,
and aggregates the device kernels by name. It reads them from the
profiler's raw records (``prof.profiler.kineto_results.events()``):
building the profiler's Python event tree over an image's eager loop took
20-35 s a call. On the CPU, where there are no device kernels, it
aggregates the aten ops by their own (self) time, as the JAX package falls
back to its host plane.

A profile that starts with the call may miss the call's first device
kernels: on an H100, in a process that had run and profiled for ten
minutes, every such profile of a UNet eval lost its first 25 kernels (3 of
K2's 61), whatever pause came first (up to 1 s), and a fresh process lost
20-64 in 2 of 10. With one warm-up step of the profiler's schedule before
the profiled call, none of 8 lost one. ``trace`` runs the call so.

``classify`` gives each of the port's hand-written kernels a class of its
own (K1 .. K5, K1-bwd, by their ``__global__`` names in
``sdtpu_torch/csrc``) and puts the library's kernels and the aten ops into
the reference's classes (``sdtpu/bench/xprof.py:20-40``).
"""

from __future__ import annotations

import re
from collections import defaultdict

import torch

#: the hand-written kernels by their ``__global__`` names -> class
KERNEL_CLASSES = (
    ("flash_fwd_kernel", "K1"),
    ("flash_bwd_dq_kernel", "K1-bwd"),
    ("flash_bwd_dkdv_kernel", "K1-bwd"),
    ("gn_kernel", "K2"),
    ("conv_slab_kernel", "K3"),
    ("conv_general_kernel", "K3"),
    ("conv_sum_kernel", "K3"),
    ("mm_int8w_kernel", "K4"),
    ("mm_int8w_skinny_kernel", "K4"),
    ("mm_int8w_reduce_kernel", "K4"),
    ("mm_w8a8_kernel", "K5"),
    ("mm_w8a8_reduce_kernel", "K5"),
)
#: the kernels that sum a split's partial results after the main launch
#: of their class: not launches of the kernel proper
SUM_PASSES = ("conv_sum_kernel", "mm_int8w_reduce_kernel",
              "mm_w8a8_reduce_kernel")

_OWN = [(re.compile(rf"(?<![\w]){name}(?![\w])"), cls)
        for name, cls in KERNEL_CLASSES]

#: aten ops (CPU profiles) -> class: exact op names after ``aten::``
_ATEN = {
    "conv": ("convolution", "_convolution", "conv2d", "mkldnn_convolution",
             "cudnn_convolution", "_slow_conv2d_forward",
             "thnn_conv2d", "conv_depthwise2d"),
    "matmul": ("mm", "addmm", "bmm", "baddbmm", "matmul", "linear",
               "einsum", "_int_mm", "dot"),
    "softmax": ("softmax", "_softmax", "log_softmax"),
    "copy": ("copy_", "clone", "contiguous", "empty_like", "empty",
             "empty_strided", "zeros", "zeros_like", "fill_", "zero_"),
    "cast": ("to", "_to_copy", "type_as"),
    "reduce": ("mean", "sum", "var", "var_mean", "std", "amax", "max",
               "min", "argmax", "norm", "linalg_vector_norm", "cumsum",
               "native_layer_norm", "native_group_norm", "layer_norm",
               "group_norm"),
    "shaping": ("view", "reshape", "_reshape_alias", "permute",
                "transpose", "t", "cat", "stack", "expand", "index",
                "index_select", "slice", "select", "unsqueeze", "squeeze",
                "flatten", "split", "chunk", "narrow", "pad",
                "constant_pad_nd", "as_strided", "_unsafe_view", "unbind",
                "repeat", "flip", "roll", "gather", "alias", "detach",
                "upsample_nearest2d", "upsample_bilinear2d",
                "_upsample_bilinear2d_aa", "interpolate", "lift_fresh"),
}
_ATEN_CLASS = {op: cls for cls, ops in _ATEN.items() for op in ops}

#: library kernel names (lower-cased) -> class, first match wins. The
#: names are those an H100's traces show (CUDA 12 cuDNN ``sm90_xmma_fprop``
#: and cutlass fprop convs, cuBLAS ``nvjet`` and ``xmma_gemm`` products,
#: ATen's elementwise, copy, reduce and softmax kernels); the list of them
#: is pinned in ``tests/test_torch_hopper.py``
_LIBRARY = [
    (r"softmax", "softmax"),
    (r"fprop|dgrad|wgrad|implicit_gemm|conv|nhwckrsc|winograd", "conv"),
    (r"nvjet|gemm|gemv|cublas|cutlass|xmma|matmul", "matmul"),
    (r"bfloat16_copy|half_copy|float_copy", "cast"),
    (r"catarray|nchwtonhwc|nhwctonchw|addpadding|transpose|index|gather"
     r"|scatter|upsample|(?<![a-z])(flip|roll)|permute", "shaping"),
    (r"memcpy|copy", "copy"),
    (r"reduce_kernel|norm|moments|welford", "reduce"),
    (r"memset|fill|elementwise|pointwise|functor", "elementwise"),
]
_LIBRARY = [(re.compile(p), cls) for p, cls in _LIBRARY]


def classify(name: str) -> str:
    """The class of a device kernel's or an aten op's name."""
    for pattern, cls in _OWN:
        if pattern.search(name):
            return cls
    if name.startswith("aten::"):
        op = name[6:]
        return _ATEN_CLASS.get(op, "elementwise")
    low = name.lower()
    for pattern, cls in _LIBRARY:
        if pattern.search(low):
            return cls
    return "other"


def device_events(prof):
    """(name, start_ns, duration_ns) of every device kernel the profiler
    recorded, in launch order. The schedule's step ranges (``trace``) are
    on the device's timeline too, one spanning the whole call: not a
    kernel."""
    out = [(e.name(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA
           and not e.name().startswith("ProfilerStep#")]
    return sorted(out, key=lambda e: e[1])


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def trace(fn, args, cuda: bool):
    """``fn(*args)`` in the warm-up step of ``torch.profiler``'s schedule
    (traced, then dropped), then in its active step; returns the profile
    of the second call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    steps = schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.inference_mode(), profile(activities=activities,
                                         schedule=steps) as prof:
        for _ in range(2):
            fn(*args)
            _sync(cuda)
            prof.step()
    return prof


def on_cuda(args) -> bool:
    def leaves(a):
        if isinstance(a, dict):
            for v in a.values():
                yield from leaves(v)
        elif isinstance(a, (list, tuple)):
            for v in a:
                yield from leaves(v)
        elif torch.is_tensor(a):
            yield a

    return any(t.is_cuda for t in leaves(args))


def profile_ops(fn, args) -> dict:
    """Run ``fn(*args)`` once warm, then once profiled (``trace``); return
    {name: {total_us, count, class}}: the device kernels by name where the
    arguments are on a CUDA card, else the aten ops by their self time."""
    cuda = on_cuda(args)
    prof = trace(fn, args, cuda)
    ops: dict = defaultdict(lambda: {"total_us": 0.0, "count": 0})
    if cuda:
        for name, _, dur in device_events(prof):
            rec = ops[name]
            rec["total_us"] += dur / 1e3
            rec["count"] += 1
    else:
        for avg in prof.key_averages():
            if not avg.key.startswith("aten::"):
                continue
            rec = ops[avg.key]
            rec["total_us"] += avg.self_cpu_time_total
            rec["count"] += avg.count
    for op_name, rec in ops.items():
        rec["class"] = classify(op_name)
    return dict(ops)


def own_kernel(name: str):
    """(class, is a sum pass) of a hand-written kernel's device name, or
    None for any other kernel."""
    for (kernel, cls), (pattern, _) in zip(KERNEL_CLASSES, _OWN):
        if pattern.search(name):
            return cls, kernel in SUM_PASSES
    return None


def kernel_launches(ops: dict) -> dict:
    """{class: [main launches, sum-pass launches]} of the hand-written
    kernels in ``ops`` (``profile_ops``' result)."""
    out: dict = {}
    for name, rec in ops.items():
        own = own_kernel(name)
        if own:
            out.setdefault(own[0], [0, 0])[own[1]] += rec["count"]
    return out


def summarize(ops: dict, top: int = 10) -> str:
    """Text report: top-N slowest ops + per-class totals (the reference
    analyzer's two views, analyze_results.py:129-146)."""
    if not ops:
        return "(no device events captured)"
    rows = sorted(ops.items(), key=lambda kv: -kv[1]["total_us"])
    total = sum(r["total_us"] for _, r in rows) or 1.0
    out = [f"top {top} ops by device time:"]
    for op_name, r in rows[:top]:
        out.append(
            f"  {r['total_us']:10.1f} us {100*r['total_us']/total:5.1f}%  "
            f"x{r['count']:<4d} [{r['class']:11s}] {op_name[:70]}"
        )
    by_class: dict = defaultdict(float)
    for _, r in rows:
        by_class[r["class"]] += r["total_us"]
    out.append("per-class totals:")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        out.append(f"  {us:10.1f} us {100*us/total:5.1f}%  {cls}")
    return "\n".join(out)
