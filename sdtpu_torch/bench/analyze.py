"""Benchmark-result analyzer, the counterpart of ``sdtpu/bench/analyze.py``:
reads ``results/*.json`` written by ``sdtpu_torch.bench.runner``, prints a
per-part latency table, the 20-step pipeline estimate, the device-kernel
class counts of each part (in place of the reference's HLO instruction
counts) and a ``FAILED:`` line for each part that left a ``.error``.
"""

from __future__ import annotations

import json
from pathlib import Path


def _fmt_table(rows, headers) -> str:
    cols = [len(h) for h in headers]
    srows = [[str(c) for c in r] for r in rows]
    for r in srows:
        for i, c in enumerate(r):
            cols[i] = max(cols[i], len(c))
    line = "  ".join(h.ljust(cols[i]) for i, h in enumerate(headers))
    out = [line, "-" * len(line)]
    for r in srows:
        out.append("  ".join(c.ljust(cols[i]) for i, c in enumerate(r)))
    return "\n".join(out)


def load_results(results_dir: str | Path = "results") -> dict:
    results = {}
    for f in sorted(Path(results_dir).glob("*.json")):
        results[f.stem] = json.loads(f.read_text())
    return results


def _num(v, fmt):
    return format(v, fmt) if v is not None else "-"


def analyze(results_dir: str | Path = "results", op_summary: bool = True) -> str:
    results = load_results(results_dir)
    errors = list(Path(results_dir).glob("*.error"))
    if not results and not errors:
        return f"no results under {results_dir} (run `sdtpu-torch bench` first)"

    rows = []
    total = 0.0
    for name, r in results.items():
        ms = r.get("latency_ms", float("nan"))
        total += ms
        flops = r.get("flops") or 0
        byts = r.get("bytes_accessed") or 0
        rows.append([
            name,
            f"{ms:.3f}",
            f"{r.get('latency_p99_ms', float('nan')):.3f}",
            _num(r.get("device_ms"), ".3f"),
            f"{flops / ms / 1e9:.1f}" if flops and ms else "-",
            _num(r.get("mfu_pct"), ".2f"),
            f"{byts / ms / 1e6:.1f}" if byts and ms else "-",
        ])
    out = [_fmt_table(
        rows,
        ["part", "median ms", "p99 ms", "device ms", "TFLOP/s", "MFU %",
         "GB/s"],
    )]
    out.append(f"\ntotal (1 eval of each part): {total:.3f} ms")
    # pipeline estimate: 20 steps x unet + 1 x others
    if "unet" in results:
        est = (
            20 * results["unet"]["latency_ms"]
            + sum(r["latency_ms"] for n, r in results.items() if n != "unet")
        )
        out.append(f"pipeline estimate (20-step): {est:.1f} ms")

    if op_summary:
        for name, r in results.items():
            oc = r.get("op_classes") or {}
            nonzero = {k: v for k, v in sorted(
                oc.items(), key=lambda kv: -kv[1]) if v}
            out.append(f"\n{name} op classes (kernels of one call):")
            out.append("  " + ", ".join(f"{k}={v}" for k, v in nonzero.items()))
    for e in errors:
        out.append(f"\nFAILED: {e.stem} (see {e})")
    return "\n".join(out)
