"""The port's measurement tools (``sdtpu_torch.bench``,
``sdtpu_torch.tools.attr_mma``) and ``sdtpu_torch.version`` on the CPU at
TINY, and against the JAX package's ``sdtpu.bench.flops`` and
``sdtpu.version``: the FLOP table copied as it is, the port's own count on
the meta device within 6% of it at SD1.5's full width (the tolerance the
reference's pin test gives its own count), the runner, analyzer, phase
timings, per-op profile, sweep and attribution running end to end."""

import json
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from sdtpu.bench import flops as j_flops
from sdtpu import version as j_version
from sdtpu_torch import __version__
from sdtpu_torch.bench import analyze as A
from sdtpu_torch.bench import flops as F
from sdtpu_torch.bench import profile as P
from sdtpu_torch.bench import runner as R
from sdtpu_torch.bench import sweep as S
from sdtpu_torch.bench import xprof as X
from sdtpu_torch.config import SD15, TINY
from sdtpu_torch.tools import attr_mma
from sdtpu_torch import version as t_version

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and eager ops on TINY tensors lose far more to oversubscribed threads
    than they gain from them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny_params():
    return R.demo_params(TINY, "cpu")


# ---------------------------------------------------------------------------
# FLOPs and MFU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("part", ["unet_cfg", "vae_dec", "clip", "temb"])
def test_count_flops_is_the_pinned_table(part):
    """The port's count of SD1.5's parts on the meta device under
    ``plain`` within 6% of the constants (UNet +3.5%, VAE -2.5%)."""
    got = F.count_flops(SD15, part)
    want = F.PART_FLOPS["sd15"][part]
    assert abs(got / want - 1.0) <= 0.06, (part, got, want)


def test_count_flops_names_and_batch():
    """The runner's part names count the same as the table's; ``batch``
    scales the UNet's count linearly."""
    assert F.count_flops(SD15, "unet") == F.count_flops(SD15, "unet_cfg")
    assert F.count_flops(TINY, "unet_b1") * 2 == F.count_flops(TINY,
                                                               "unet_cfg")
    assert F.count_flops(TINY, "unet", batch=4) == 2 * F.count_flops(
        TINY, "unet")
    assert F.count_flops(TINY, "temb") == F.count_flops(TINY, "temb",
                                                        batch=20)


def test_flop_table_is_the_references():
    assert F.PART_FLOPS == j_flops.PART_FLOPS
    for steps in (1, 20, 50):
        for cfg_batch in (True, False):
            assert F.image_flops("sd15", steps, cfg_batch=cfg_batch) == (
                j_flops.image_flops("sd15", steps, cfg_batch=cfg_batch))
    assert F.image_flops("sdxl", 20) is None
    assert F.image_flops("sd15", 20, n_controlnets=1) is None
    assert abs(F.image_flops("sd15", 20) / 1e12 - 33.65) < 0.01


@pytest.mark.parametrize("kind,peak", [("NVIDIA H100 80GB HBM3", 989.0),
                                       ("NVIDIA H100 PCIe", 756.0),
                                       ("NVIDIA H100 NVL", 835.0),
                                       ("Some Other Card", None),
                                       ("TPU v5 lite", None)])
def test_mfu_fields(kind, peak):
    """The card's own bf16 peak; an unknown kind (a TPU's too) gets none,
    and then no ``mfu_pct``."""
    assert F.peak_tflops(kind) == peak
    out = F.mfu_fields("sd15", 20, 1.0, kind)
    assert out["tflop_per_image"] == round(F.image_flops("sd15", 20) / 1e12,
                                           2)
    assert out["tflop_per_s"] == round(F.image_flops("sd15", 20) / 1e12, 1)
    if peak:
        assert out["peak_tflops_bf16"] == peak
        assert out["mfu_pct"] == round(100 * out["tflop_per_s"] / peak, 1)
    else:
        assert "mfu_pct" not in out
    assert F.mfu_fields("sd15", 20, 1.0, kind, pure=False) == {}
    assert F.mfu_fields("sd15", 20, 0.0, kind) == {}
    assert F.mfu_fields("sdxl", 20, 1.0, kind) == {}


# ---------------------------------------------------------------------------
# the runner and the analyzer
# ---------------------------------------------------------------------------

def test_benchmark_parts_and_analyze(tmp_path, tiny_params):
    """Every part's JSON with the reference's keys and the port's; the
    analyzer's table, estimate and op-class view over them."""
    summary = R.benchmark_parts(TINY, params=tiny_params, warmup=1, iters=3,
                                out_dir=tmp_path, device="cpu")
    assert list(summary) == ["temb", "text_encoder", "unet", "vae_decoder"]
    for name, r in summary.items():
        assert json.loads((tmp_path / f"{name}.json").read_text()) == r
        for key in ("latency_ms", "latency_mean_ms", "latency_p99_ms",
                    "warmup", "iters", "flops", "bytes_accessed",
                    "op_classes", "backend", "kernels"):
            assert key in r
        assert r["latency_ms"] > 0 and r["iters"] == 3
        assert r["flops"] == F.count_flops(TINY, name)
        assert r["bytes_accessed"] is None and r["device_ms"] is None
        assert r["backend"] == "cpu" and r["kernels"] == "plain"
        assert r["mfu_pct"] is None and r["tflop_per_s"] > 0
        assert r["op_classes"]["matmul"] > 0
    assert summary["unet"]["op_classes"]["conv"] > 0
    text = A.analyze(tmp_path)
    for name in summary:
        assert re.search(rf"^{name}\s+\d", text, re.M)
    assert "pipeline estimate (20-step)" in text
    est = 20 * summary["unet"]["latency_ms"] + sum(
        r["latency_ms"] for n, r in summary.items() if n != "unet")
    assert f"pipeline estimate (20-step): {est:.1f} ms" in text
    assert "unet op classes" in text and "FAILED" not in text


def test_a_failed_part_leaves_its_error(tmp_path, tiny_params, monkeypatch):
    """A part that raises writes ``.error`` with its traceback; the others
    still run, and the analyzer names the failure."""
    def broken(*args, **kwargs):
        raise RuntimeError("temb broke")

    monkeypatch.setattr(R.temb, "apply", broken)
    summary = R.benchmark_parts(TINY, params=tiny_params, warmup=0, iters=1,
                                out_dir=tmp_path, device="cpu",
                                parts=["temb", "text_encoder"])
    assert summary["temb"] == {"part": "temb", "error": True}
    assert "latency_ms" in summary["text_encoder"]
    assert "temb broke" in (tmp_path / "temb.error").read_text()
    assert "FAILED: temb" in A.analyze(tmp_path)
    assert "no results" in A.analyze(tmp_path / "none")


def test_runner_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        R.benchmark_parts(TINY, device="cuda")
    assert R.resolve("auto", "cpu") == "plain"
    assert R.resolve("auto", "cuda") == "cuda"
    assert R.resolve("cuda_conv", "cpu") == "cuda_conv"


def test_phase_timings_keys(tiny_params):
    out = P.phase_timings(TINY, tiny_params, steps=2, warmup=0, iters=1,
                          device="cpu")
    assert set(out) == {"conditioning", "denoise_loop", "single_iteration",
                        "decoding", "image_generation_est", "per_step"}
    assert all(v > 0 for v in out.values())
    assert out["image_generation_est"] == pytest.approx(
        out["conditioning"] + out["denoise_loop"] + out["decoding"])
    assert out["per_step"] == pytest.approx(out["denoise_loop"] / 2)


# ---------------------------------------------------------------------------
# the per-op profile, the trace, the sweep
# ---------------------------------------------------------------------------

def test_profile_ops_and_summarize(tiny_params):
    """On the CPU the aten ops of the TINY VAE decode by self time: its
    convolutions, products and softmax each in their class."""
    fn, args = R.part_specs(TINY, tiny_params, "plain", "cpu")["vae_decoder"]
    ops = X.profile_ops(fn, args)
    assert ops and all(set(r) == {"total_us", "count", "class"}
                       for r in ops.values())
    classes = {r["class"] for r in ops.values()}
    assert {"conv", "matmul", "softmax", "elementwise"} <= classes
    assert X.kernel_launches(ops) == {}
    text = X.summarize(ops, top=5)
    lines = text.splitlines()
    assert lines[0] == "top 5 ops by device time:"
    assert "per-class totals:" in lines and len(lines) > 7
    assert X.summarize({}) == "(no device events captured)"


def test_profile_ops_counts_one_call(tiny_params):
    """The profile holds the second call alone: the warm-up step's records
    are dropped (each product of the text tower counted once)."""
    fn, args = R.part_specs(TINY, tiny_params, "plain", "cpu")[
        "text_encoder"]
    log = []
    with torch.inference_mode(), attr_mma._LibraryLog(log):
        fn(*args)
    ops = X.profile_ops(fn, args)
    products = sum(1 for name, _, _ in log if name in ("aten::mm",
                                                        "aten::bmm"))
    assert products > 0
    assert ops["aten::mm"]["count"] + ops["aten::bmm"]["count"] == products


@pytest.mark.parametrize("name,cls", [
    ("aten::mm", "matmul"), ("aten::convolution", "conv"),
    ("aten::_softmax", "softmax"), ("aten::copy_", "copy"),
    ("aten::_to_copy", "cast"), ("aten::mean", "reduce"),
    ("aten::permute", "shaping"), ("aten::sigmoid", "elementwise"),
    ("void flash_fwd_kernel<48, 128, 64>(const __nv_bfloat16*)", "K1"),
    ("void flash_bwd_dq_kernel<48, 128, 1, 2>(Args)", "K1-bwd"),
    ("void flash_bwd_dkdv_kernel<48, 128, 1, 2>(Args)", "K1-bwd"),
    ("gn_kernel(GnArgs)", "K2"),
    ("void conv_slab_kernel<3, 160, false>(SlabArgs)", "K3"),
    ("conv_general_kernel(ConvArgs)", "K3"),
    ("conv_sum_kernel(ConvArgs, int)", "K3"),
    ("void mm_int8w_kernel<128, 4>(MmArgs)", "K4"),
    ("mm_int8w_skinny_kernel(MmArgs)", "K4"),
    ("mm_int8w_reduce_kernel(MmArgs, int)", "K4"),
    ("void mm_w8a8_kernel<256>(MmArgs)", "K5"),
    ("mm_w8a8_reduce_kernel(MmArgs, int)", "K5"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "sign_kernel_cuda(at::TensorIteratorBase&)::{lambda()#1}>(int)",
     "elementwise"),
])
def test_classify(name, cls):
    """The port's own kernels by their ``__global__`` names (a library
    name that contains one as a substring is not one of them), aten ops
    by name."""
    assert X.classify(name) == cls


def test_device_events_are_kernels_alone():
    """The device records of a profile, in start order, without the
    schedule's step range that spans the call on the device's timeline."""
    import types

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(name, start, dur, dev=cuda):
        return types.SimpleNamespace(name=lambda: name, start_ns=lambda: start,
                                     duration_ns=lambda: dur,
                                     device_type=lambda: dev)

    events = [event("gn_kernel(GnArgs)", 30, 5),
              event("ProfilerStep#1", 0, 900),
              event("aten::mm", 5, 50, cpu),
              event("nvjet_tst_64x8_64x16_4x1_v_bz_NNT", 10, 7)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    assert X.device_events(prof) == [
        ("nvjet_tst_64x8_64x16_4x1_v_bz_NNT", 10, 7),
        ("gn_kernel(GnArgs)", 30, 5)]


def test_kernel_launches_split_main_and_sum():
    ops = {"void conv_slab_kernel<3>(SlabArgs)": {"count": 50},
           "conv_general_kernel(ConvArgs)": {"count": 10},
           "conv_sum_kernel(ConvArgs, int)": {"count": 7},
           "gn_kernel(GnArgs)": {"count": 60},
           "void at::native::foo()": {"count": 9}}
    assert X.kernel_launches(ops) == {"K3": [60, 7], "K2": [60, 0]}


def test_capture_trace(tmp_path, tiny_params):
    fn, args = R.part_specs(TINY, tiny_params, "plain", "cpu")["temb"]
    path = P.capture_trace(fn, args, tmp_path / "tr")
    trace = json.loads(path.read_text())
    assert any(e.get("name") == "aten::mm"
               for e in trace["traceEvents"])


def test_run_sweep_quick(tmp_path, capsys):
    """One config at TINY: one JSON line printed and appended, the image
    dumped as a PNG that decodes to the sweep's own image."""
    from PIL import Image

    from sdtpu_torch import Context

    out = tmp_path / "sw"
    res = S.run_sweep(config="tiny", steps_list=(2, 5), iters=1,
                      out_dir=str(out), dump_images=True, quick=True,
                      device="cpu")
    assert len(res) == 1
    r = res[0]
    assert (r["sampler"], r["steps"], r["guidance"], r["batch"],
            r["kernels"]) == ("dpm", 2, 7.5, 1, "plain")
    assert r["s_per_image"] == r["s_per_call"] > 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == r
    assert json.loads((out / "sweep.jsonl").read_text()) == r
    img = np.asarray(Image.open(out / "dpm_2_7.5_512.png"))
    want = Context(config="tiny", steps=2, device="cpu").generate(
        "a photograph of an astronaut riding a horse", guidance=7.5, seed=0)
    assert np.array_equal(img, want)


def test_write_png_round_trip(tmp_path):
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3),
                                            dtype=np.uint8)
    S.write_png(tmp_path / "x.png", img)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "x.png")), img)


# ---------------------------------------------------------------------------
# the per-shape attribution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("part,counted", [("unet", "unet"),
                                          ("vae", "vae_decoder"),
                                          ("clip", "text_encoder")])
def test_attr_mma_flops_are_the_count(part, counted, tiny_params):
    """At TINY under ``plain`` every product and conv is a library op: the
    attributed FLOPs are ``count_flops``' of the same part within 1%, every
    call's time is its event's, and the table lists the shapes."""
    fn, args = attr_mma.part_call(part, TINY, "plain", "cpu",
                                  params=tiny_params)
    res = attr_mma.attribute(fn, args)
    want = F.count_flops(TINY, counted, batch=attr_mma.PARTS[part][1])
    assert abs(res["flops"] / want - 1.0) <= 0.01
    assert not res["device"] and 0 < res["attributed_us"] <= res["total_us"]
    assert all(r["calls"] > 0 and r["us"] > 0 for r in res["rows"].values())
    text = attr_mma.table(res, 989.0, top=5)
    assert "| shape |" in text and "| class |" in text
    body = [ln for ln in text.splitlines() if ln.startswith("| ")
            and ln.count("|") == 8 and ln.split("|")[1].strip() != "shape"]
    assert len(body) == min(5, len(res["rows"]))


def test_attr_mma_main_runs(capsys):
    assert attr_mma.main(["--part", "clip", "--config", "tiny",
                          "--platform", "cpu", "--top", "3"]) == 0
    out = capsys.readouterr().out
    assert "kernels=plain" in out and "| shape |" in out


# ---------------------------------------------------------------------------
# the version
# ---------------------------------------------------------------------------

def test_version_is_the_references():
    assert __version__ == t_version.__version__ == j_version.__version__
    rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                         capture_output=True, text=True, cwd=REPO)
    want = rev.stdout.strip() if rev.returncode == 0 else ""
    assert t_version.git_revision() == want == j_version.git_revision()
    full = t_version.full_version()
    if want:
        assert full == f"{__version__}+git.{want}"
        long = t_version.git_revision(short=False)
        assert len(long) == 40 and long.startswith(want)
    else:
        assert full == __version__
    assert re.fullmatch(r"\d+\.\d+\.\d+(\+git\.[0-9a-f]+)?", full)


def test_attr_mma_matches_kernels_in_launch_order():
    """The hand-written kernels' device records go to the logged launches
    of their class in order, a split's sum pass to the launch before it;
    other kernels (K2, the library's) are left to the aten events."""
    from collections import defaultdict

    own = [("K3", "K3 a", 10.0), ("K1", "K1 a", 5.0), ("K3", "K3 b", 20.0),
           ("K4", "K4 a", 2.0)]
    kernels = [("void conv_slab_kernel<160, false, 3>(SlabArgs)", 0, 3000),
               ("conv_sum_kernel<4>(ConvArgs, int)", 1, 500),
               ("void flash_fwd_kernel<48, 64, false, false>(...)", 2, 700),
               ("gn_kernel<8, 1>(GnArgs)", 3, 100),
               ("conv_general_kernel<1, false>(ConvArgs)", 4, 2000),
               ("nvjet_tst_64x8_64x16_4x1_v_bz_NNT", 5, 50),
               ("mm_int8w_skinny_kernel(MmArgs)", 6, 40)]
    rows = defaultdict(lambda: {"us": 0.0, "flops": 0.0, "calls": 0})
    attr_mma.match_kernels(kernels, own, rows)
    assert dict(rows) == {"K3 a": {"us": 3.5, "flops": 10.0, "calls": 1},
                          "K1 a": {"us": 0.7, "flops": 5.0, "calls": 1},
                          "K3 b": {"us": 2.0, "flops": 20.0, "calls": 1},
                          "K4 a": {"us": 0.04, "flops": 2.0, "calls": 1}}
    with pytest.raises(RuntimeError, match="K3: 2 launches logged, 1"):
        attr_mma.match_kernels(kernels[:4], own, defaultdict(
            lambda: {"us": 0.0, "flops": 0.0, "calls": 0}))
    with pytest.raises(RuntimeError, match="K1: more kernels"):
        attr_mma.match_kernels(kernels + kernels[2:3], own, defaultdict(
            lambda: {"us": 0.0, "flops": 0.0, "calls": 0}))
