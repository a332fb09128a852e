"""The static rules of the port's Hopper kernels (K1 flash attention and its
dispatch rule, K2 fused GroupNorm and its statistics mode, K3 fused conv, K4
weight-only-int8 GEMM, K5 W8A8 GEMM), mirrored in Python and tested on the
CPU; ``Context.generate``'s error boundary; the build's hash over the shared
headers; the committed ``wgmma_sm90.cuh`` against its generator. The kernels
themselves run only on the card: the ``cuda`` tests hold them against their
plain versions at the shapes the rules could break (this file imports no
JAX, so they run there: ``python3 -m pytest tests/test_torch_hopper.py -m
cuda``)."""

import importlib.util
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from sdtpu_torch import Context, ErrorCode, SdtpuError
from sdtpu_torch.ops import _build
from sdtpu_torch.ops import attention as t_attn
from sdtpu_torch.ops import conv as t_conv
from sdtpu_torch.ops import groupnorm as t_gn
from sdtpu_torch.ops import matmul as t_mm

SMS = 132     # an H100 SXM
SMEM_CAP = 227 * 1024     # a block's shared memory on sm_90


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the smoke run's ragged cases, so that both hold the same shapes
chip_smoke = _load(Path(__file__).resolve().parent.parent / "chip_smoke.py",
                   "chip_smoke")


# ---------------------------------------------------------------------------
# K1: plan(d, sq, sk, batch_heads, sms) -> (dpad, rows, bkv)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,sq,sk,bh,want", [
    # the main path: UNet 64x64 and 32x32 at the CFG batch, the VAE mid block
    (40, 4096, 4096, 16, (48, 128, 64)),
    (80, 1024, 1024, 16, (80, 64, 64)),
    (512, 4096, 4096, 1, (512, 64, 32)),
    # d = 64 (SD2 / SDXL)
    (64, 4096, 4096, 16, (64, 128, 64)),
    # few row tiles: 64 rows a block, so more SMs get one
    (64, 640, 512, 1, (64, 64, 64)),
    (40, 128, 128, 1, (48, 64, 64)),
    # ragged sequences and sq != sk do not change the tile
    (40, 4096, 1000, 16, (48, 128, 64)),
    # the padded head dims
    (8, 1024, 1024, 64, (16, 128, 64)),
    (24, 1024, 1024, 64, (32, 128, 64)),
    (96, 1024, 1024, 64, (128, 64, 64)),
    (128, 1024, 1024, 64, (128, 64, 64)),
    (136, 1024, 1024, 64, (256, 64, 64)),
    (256, 1024, 1024, 64, (256, 64, 64)),
    (264, 1024, 1024, 64, (512, 64, 32)),
])
def test_flash_plan(d, sq, sk, bh, want):
    assert t_attn.plan(d, sq, sk, bh, SMS) == want


def _flash_smem(dpad, rows, bkv):
    """The kernel's shared memory: 1 KB of alignment slack, the Q tile and
    two stages of a K and a V tile, each in column blocks of 64 bf16 (128-byte
    rows)."""
    ch = -(-dpad // 64)
    return 1024 + ch * rows * 128 + 2 * 2 * ch * bkv * 128


@pytest.mark.parametrize("d", range(8, 513, 8))
def test_flash_plan_covers_every_head_dim(d):
    """Every head dim of the wrapper's contract gets a padded dim the wgmma
    kernel is built for, and tiles that fit a block's 227 KB (two blocks an
    SM up to d = 128)."""
    for sq, bh in ((64, 1), (4096, 16), (130, 3)):
        dpad, rows, bkv = t_attn.plan(d, sq, 77, bh, SMS)
        assert dpad in t_attn.DPADS and dpad >= d and dpad % 16 == 0
        assert min(p for p in t_attn.DPADS if p >= d) == dpad
        assert rows in (64, 128) and bkv in (32, 64)
        smem = _flash_smem(dpad, rows, bkv)
        assert smem <= 227 * 1024
        if dpad <= 128:
            assert 2 * (smem + 1024) <= 228 * 1024
        if dpad > 64:
            # one warpgroup a tile, or two splitting its columns: the entry
            # point refuses 128 rows here
            assert rows == 64
        assert bkv == (32 if dpad == 512 else 64)


@pytest.mark.parametrize("d,sq,sk", [(0, 64, 64), (12, 64, 64), (520, 64, 64),
                                     (64, 0, 64), (64, 64, 0)])
def test_flash_plan_rejects(d, sq, sk):
    with pytest.raises(ValueError):
        t_attn.plan(d, sq, sk, 1, SMS)


def test_flash_rows_follow_the_card():
    """128 rows a block up to dpad 64 unless that leaves half the SMs
    without one; one warpgroup a block from dpad 80 on."""
    for tiles128 in range(1, 300):
        _, rows, _ = t_attn.plan(64, tiles128 * 128, 128, 1, SMS)
        assert rows == (128 if 2 * tiles128 >= SMS else 64)
        assert t_attn.plan(80, tiles128 * 128, 128, 1, SMS)[1] == 64


def _fake(shape, dtype=torch.bfloat16, device="cuda", contiguous=True,
          ptr=0):
    """What a dispatch rule reads of a tensor, without a card."""
    return types.SimpleNamespace(
        shape=torch.Size(shape), dtype=dtype, device=torch.device(device),
        is_contiguous=lambda: contiguous, data_ptr=lambda: ptr)


@pytest.mark.parametrize("case,c,heads,want", [
    ("bf16", 320, 8, True),            # the 64x64 self-attention, d = 40
    ("bf16", 512, 1, True),            # the VAE's mid block, d = 512
    ("float32", 320, 8, False),        # dataclasses.replace(SD15, "float32")
    ("bf16", 20, 1, False),            # d = 20: not a multiple of 8
    ("bf16", 520, 1, False),           # d = 520: above 512
    ("strided", 320, 8, False),        # not contiguous
    ("unaligned", 320, 8, False),      # not on a 16-byte boundary
    ("cpu_float32", 320, 8, True),     # the plain version takes any dtype
    ("cpu_float32", 20, 1, True),
    ("cpu_bf16", 520, 1, True),
])
def test_flash_rule_is_the_kernel_contract(case, c, heads, want):
    """K1's static rule reads the tensors: the reference's sequence clause,
    then, on a CUDA tensor, what ``flash_attention_cuda`` takes (bf16,
    contiguous, aligned, a head dim it is built for); on a CPU tensor the
    plain version, any floating dtype. Taken by the rule alone, on stand-ins
    for tensors of either device type."""
    dtype = torch.float32 if "float32" in case else torch.bfloat16
    device = "cpu" if case.startswith("cpu") else "cuda"
    t = _fake((2, 4096, c), dtype, device, contiguous=case != "strided",
              ptr=8 if case == "unaligned" else 0)
    assert t_attn.uses_kernel(t, t, t, heads) is want
    short = _fake((2, 77, c), dtype, device)
    assert t_attn.uses_kernel(short, short, short, heads) is False


@pytest.mark.parametrize("dtype,c,heads", [
    (torch.float32, 320, 8), (torch.bfloat16, 20, 1),
    (torch.bfloat16, 520, 1)])
def test_flash_outside_the_contract_takes_the_plain_path(monkeypatch, dtype,
                                                         c, heads):
    """On a CUDA tensor outside the kernel's contract ``flash_attention``
    calls the plain ``layers.sdpa`` and never the wrapper, which would
    raise."""
    taken = []
    monkeypatch.setattr(t_attn, "sdpa", lambda *a: taken.append("plain"))
    monkeypatch.setattr(t_attn, "flash_attention_cuda",
                        lambda *a: taken.append("kernel"))
    t = _fake((2, 4096, c), dtype)
    t_attn.flash_attention(t, t, t, heads)
    ok = _fake((2, 4096, 320))
    t_attn.flash_attention(ok, ok, ok, 8)
    assert taken == ["plain", "kernel"]


# ---------------------------------------------------------------------------
# Context.generate: failures inside the pipeline come out typed
# ---------------------------------------------------------------------------

def test_generate_types_a_wrapper_failure_and_stays_usable(monkeypatch):
    """A kernel wrapper's RuntimeError (a failed launch) inside ``generate``
    comes out as SdtpuError(RUNTIME_ERROR), chained, recorded; the context
    is not latched, and the next call gives the image it would have given.
    An SdtpuError raised inside passes through as it is."""
    ctx = Context(config="tiny", steps=2, device="cpu", kernels="cuda_gn")
    want = ctx.generate("a horse", seed=3)
    real = t_gn.group_norm_reference
    failure = RuntimeError("group_norm_silu launch failed: cudaError 700")

    def broken(*a, **kw):
        raise failure

    monkeypatch.setattr(t_gn, "group_norm_reference", broken)
    with pytest.raises(SdtpuError) as ei:
        ctx.generate("a horse", seed=3)
    assert ei.value.code == ErrorCode.RUNTIME_ERROR
    assert ei.value.__cause__ is failure
    assert "launch failed" in ctx.last_error(ErrorCode.RUNTIME_ERROR)
    inner = SdtpuError(ErrorCode.INVALID_ARGUMENT, "from inside")

    def refusing(*a, **kw):
        raise inner

    monkeypatch.setattr(t_gn, "group_norm_reference", refusing)
    with pytest.raises(SdtpuError) as ei:
        ctx.generate("a horse", seed=3)
    assert ei.value is inner
    monkeypatch.setattr(t_gn, "group_norm_reference", real)
    assert np.array_equal(ctx.generate("a horse", seed=3), want)


# ---------------------------------------------------------------------------
# K4: plan_int8w(m, k, n, sms)
# ---------------------------------------------------------------------------

def _unet_sites():
    """(m, k, n) of the 228 K4 sites of one SD1.5 UNet eval at 512x512 and
    the CFG batch of 2 (``quantize="int8w_dense"``): per level of width c
    and m = 2 * plane rows, a transformer block's attn1 q, k, v, o and
    attn2 q, o (c -> c), attn2 k, v (the 154 text rows, 768 -> c), ff1 (c ->
    8c), ff2 (4c -> c), proj_in and proj_out; the ResBlocks' skip 1x1 convs;
    the ResBlocks' time-embedding dense (2 rows, 1280 -> c)."""
    sites = []
    for m, c, blocks in ((8192, 320, 5), (2048, 640, 5), (512, 1280, 5),
                         (128, 1280, 1)):
        for _ in range(blocks):
            sites += [(m, c, c)] * 8 + [(154, 768, c)] * 2
            sites += [(m, c, 8 * c), (m, 4 * c, c)]
    # skip convs: down 320->640, 640->1280; up 2560, 2560, 2560, 2560,
    # 1920 -> 1280; 1920, 1280, 960 -> 640; 960, 640, 640 -> 320
    sites += [(2048, 320, 640), (512, 640, 1280)]
    sites += [(128, 2560, 1280)] * 3 + [(512, 2560, 1280)] * 2
    sites += [(512, 1920, 1280), (2048, 1920, 640), (2048, 1280, 640),
              (2048, 960, 640), (8192, 960, 320), (8192, 640, 320),
              (8192, 640, 320)]
    sites += [(2, 1280, c) for c in [320] * 5 + [640] * 5 + [1280] * 12]
    return sites


# chip_smoke.MM_RAGGED and the tails the tile kernel zero-fills or masks
MM_RAGGED = [(300, 336, 130), (100, 48, 72), (33, 16, 7), (1, 1280, 320),
             (129, 320, 129), (17, 16, 8), (16, 32, 9), (257, 1040, 480),
             (64, 144, 256), (154, 768, 1280)]


def test_ragged_rows_cover_the_smoke_runs():
    assert {c[:3] for c in chip_smoke.MM_RAGGED} <= set(MM_RAGGED)


def test_unet_site_count():
    assert len(_unet_sites()) == 228


def test_unet_sites_that_split_k():
    """93 of an eval's 228 sites split K on 132 SMs and so run the sum pass
    as a second kernel: every site of 512 and 128 rows but ff1, attn2's k
    and v at every level, and the skip convs of 512 and 128 rows."""
    split = [s for s in _unet_sites()
             if t_mm.plan_int8w(*s, SMS)["splits"] > 1]
    assert len(split) == 93
    assert all(m <= 512 and n < 10240 for m, _, n in split)


@pytest.mark.parametrize("m,k,n", sorted(set(_unet_sites())) + MM_RAGGED)
def test_int8w_plan_covers_k_once_and_fills_the_card(m, k, n):
    p = t_mm.plan_int8w(m, k, n, SMS)
    if m <= 16:
        assert p["path"] == "skinny" and p["splits"] == 1
        assert p["blocks"] == -(-n // 8) * -(-m // 4)
        return
    assert p["path"] == "tile" and p["bn"] in (128, 160)
    steps_all = -(-k // 64)
    tiles = -(-m // 128) * -(-n // p["bn"])
    # the runs cover the K steps exactly once and none is empty
    assert p["splits"] >= 1 and p["steps"] >= 1
    assert p["splits"] * p["steps"] >= steps_all
    assert (p["splits"] - 1) * p["steps"] < steps_all
    assert p["blocks"] == tiles * p["splits"] >= min(SMS, tiles)
    if 2 * tiles > SMS:
        assert p["splits"] == 1        # the tiles fill the card themselves
    else:
        assert p["blocks"] <= SMS
        # as many runs as fit the card, or one a step
        assert (p["splits"] == steps_all
                or tiles * (p["splits"] + 1) > SMS
                or -(-steps_all // (p["splits"] + 1)) == p["steps"])
    # a column tile that divides N where one of the two does
    if n % 160 == 0 and n % 128:
        assert p["bn"] == 160
    elif n % 128 == 0:
        assert p["bn"] == 128


@pytest.mark.parametrize("m,k,n,want", [
    (8192, 320, 320, {"path": "tile", "bn": 160, "splits": 1, "steps": 5,
                      "blocks": 128}),
    (2048, 640, 5120, {"path": "tile", "bn": 128, "splits": 1, "steps": 10,
                       "blocks": 640}),
    (512, 1280, 1280, {"path": "tile", "bn": 128, "splits": 3, "steps": 7,
                       "blocks": 120}),
    (128, 5120, 1280, {"path": "tile", "bn": 128, "splits": 12, "steps": 7,
                       "blocks": 120}),
    (154, 768, 320, {"path": "tile", "bn": 160, "splits": 12, "steps": 1,
                     "blocks": 48}),
    (2, 1280, 1280, {"path": "skinny", "bn": 0, "splits": 1, "steps": 0,
                     "blocks": 160}),
])
def test_int8w_plan_at_the_main_shapes(m, k, n, want):
    assert t_mm.plan_int8w(m, k, n, SMS) == want


def test_int8w_plan_is_what_the_wrapper_passes(monkeypatch):
    """The wrapper hands the plan to the C entry point as it is, with a
    float32 scratch of ``[splits, m, n]`` exactly where K is split."""
    seen, made = {}, []
    _fake_card(monkeypatch, "sdtpu_matmul_int8w", seen, made)
    monkeypatch.setattr(t_mm, "_check_operands",
                        lambda x, w, v: (x.shape[0], *w.shape))
    before = t_mm.matmul_int8w_cuda.launches
    sums = t_mm.matmul_int8w_cuda.sum_launches
    for m, k, n in ((512, 1280, 1280), (2048, 640, 640), (2, 1280, 320)):
        made.clear()
        x = torch.zeros((m, k), dtype=torch.bfloat16)
        w = t_mm.column_major(torch.zeros((k, n), dtype=torch.int8))
        t_mm.matmul_int8w_cuda(x, w, torch.ones(n))
        p = t_mm.plan_int8w(m, k, n, SMS)
        assert seen["args"][6:13] == (m, k, n, int(p["path"] == "skinny"),
                                      p["bn"], p["splits"], p["steps"])
        scratch = [s for s, dt in made if dt == torch.float32]
        assert scratch == ([(p["splits"], m, n)] if p["splits"] > 1 else [])
        assert (seen["args"][5] is None) == (p["splits"] == 1)
    assert t_mm.matmul_int8w_cuda.launches == before + 3
    # of the three only [512, 1280] @ [1280, 1280] splits K
    assert t_mm.matmul_int8w_cuda.sum_launches == sums + 1


# ---------------------------------------------------------------------------
# K5: plan_w8a8(m, k, n, sms)
# ---------------------------------------------------------------------------

def _w8a8_sites():
    """(m, k, n) of the 85 K5 sites of one SD1.5 UNet eval (``quantize=
    "int8"`` with ``KERNEL_W8A8`` on: the dense sites with n >= m): every
    site of the 5 transformer blocks at 16x16 and the one at 8x8, ff1 at
    32x32, attn2's k and v (the 154 text rows) at 64x64 and 32x32."""
    sites = []
    for m, blocks in ((512, 5), (128, 1)):
        for _ in range(blocks):
            sites += [(m, 1280, 1280)] * 6 + [(154, 768, 1280)] * 2
            sites += [(m, 1280, 10240), (m, 5120, 1280)]
    sites += [(2048, 640, 5120)] * 5
    sites += [(154, 768, 320)] * 10 + [(154, 768, 640)] * 10
    return sites


def test_w8a8_site_count():
    assert len(_w8a8_sites()) == 85
    assert all(n >= m for m, _, n in _w8a8_sites())


def test_w8a8_sites_that_split_k():
    """74 of an eval's 85 sites split K on 132 SMs and so run the sum pass
    as a second kernel: all but ff1 at every level (the smoke run's pin)."""
    split = [s for s in _w8a8_sites() if t_mm.plan_w8a8(*s, SMS)["splits"] > 1]
    assert len(split) == chip_smoke.MM_W8A8_SUMS_PER_EVAL == 74
    assert all(n < 5120 for _, _, n in split)


@pytest.mark.parametrize("m,k,n", sorted(set(_w8a8_sites())) + MM_RAGGED)
def test_w8a8_plan_covers_k_once_and_fills_the_card(m, k, n):
    p = t_mm.plan_w8a8(m, k, n, SMS)
    assert p["path"] == "tile" and p["bn"] in (128, 160, 256)
    bk = 64 if p["bn"] == 256 else 128     # a step's depth follows the tile
    steps_all = -(-k // bk)
    tiles = -(-m // 128) * -(-n // p["bn"])
    # the runs cover the K steps exactly once and none is empty
    assert p["splits"] >= 1 and p["steps"] >= 1
    assert p["splits"] * p["steps"] >= steps_all
    assert (p["splits"] - 1) * p["steps"] < steps_all
    assert p["blocks"] == tiles * p["splits"] >= min(SMS, tiles)
    if 2 * tiles > SMS:
        assert p["splits"] == 1        # the tiles fill the card themselves
    else:
        assert p["blocks"] <= SMS
        assert (p["splits"] == steps_all
                or tiles * (p["splits"] + 1) > SMS
                or -(-steps_all // (p["splits"] + 1)) == p["steps"])
    if p["bn"] == 256:
        # the wide tile only where it divides N and still fills the card
        assert n % 256 == 0 and tiles >= SMS and p["splits"] == 1
    else:
        assert n % 256 or -(-m // 128) * (n // 256) < SMS
        # the same tile rule as K4's, with steps twice as deep
        assert p["bn"] == t_mm.plan_int8w(max(m, 17), k, n, SMS)["bn"]
    # 3 quantized A tiles, lead + 2 B tiles and lead + 1 raw bf16 stages of
    # x (the copies run lead steps ahead), 1 KB of slack, the two column
    # vectors
    lead = 3 if p["bn"] == 256 else 2
    assert (1024 + 3 * 128 * bk + (lead + 2) * p["bn"] * bk
            + (lead + 1) * 128 * bk * 2 + 2 * p["bn"] * 4) <= SMEM_CAP
    # the epilogue's two staged 64-row tiles fit what the rings held
    assert 2 * 64 * (2 * p["bn"] + 16) <= 3 * 128 * bk + (lead + 2) * p[
        "bn"] * bk


@pytest.mark.parametrize("m,k,n,want", [
    (512, 1280, 1280, {"path": "tile", "bn": 128, "splits": 3, "steps": 4,
                       "blocks": 120}),
    (2048, 640, 5120, {"path": "tile", "bn": 256, "splits": 1, "steps": 10,
                       "blocks": 320}),
    (512, 1280, 10240, {"path": "tile", "bn": 256, "splits": 1, "steps": 20,
                        "blocks": 160}),
    (128, 1280, 10240, {"path": "tile", "bn": 128, "splits": 1, "steps": 10,
                        "blocks": 80}),
    (128, 5120, 1280, {"path": "tile", "bn": 128, "splits": 10, "steps": 4,
                       "blocks": 100}),
    (154, 768, 320, {"path": "tile", "bn": 160, "splits": 6, "steps": 1,
                     "blocks": 24}),
    (2, 1280, 1280, {"path": "tile", "bn": 128, "splits": 10, "steps": 1,
                     "blocks": 100}),
])
def test_w8a8_plan_at_the_main_shapes(m, k, n, want):
    assert t_mm.plan_w8a8(m, k, n, SMS) == want


def _fake_card(monkeypatch, entry_name, seen, made):
    """The wrapper's way to the C entry point without a card: the library,
    the device queries and ``torch.empty`` replaced."""
    def entry(*args):
        seen["args"] = args
        return 0

    lib = types.SimpleNamespace(**{entry_name: entry})
    monkeypatch.setattr(_build, "library", lambda: lib)
    real_empty = torch.empty

    def empty(shape, **kw):
        kw["device"] = "cpu"
        made.append((tuple(shape), kw["dtype"]))
        return real_empty(shape, **kw)

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            multi_processor_count=SMS))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: __import__("contextlib").nullcontext())


def test_w8a8_plan_is_what_the_wrapper_passes(monkeypatch):
    """The wrapper hands the plan to the C entry point as it is, with an
    int32 scratch of ``[splits, m, n]`` exactly where K is split, and no
    probe."""
    seen, made = {}, []
    _fake_card(monkeypatch, "sdtpu_matmul_w8a8", seen, made)
    monkeypatch.setattr(t_mm, "_check_operands",
                        lambda x, w, v: (x.shape[0], *w.shape))
    xs = types.SimpleNamespace(numel=lambda: 1, device=torch.device("cpu"),
                               float=lambda: torch.ones(1))
    monkeypatch.setattr(torch, "is_tensor", lambda t: True)
    before = t_mm.matmul_w8a8_cuda.launches
    sums = t_mm.matmul_w8a8_cuda.sum_launches
    for m, k, n in ((512, 1280, 1280), (2048, 640, 5120), (154, 768, 320)):
        made.clear()
        x = torch.zeros((m, k), dtype=torch.bfloat16)
        w = t_mm.column_major(torch.zeros((k, n), dtype=torch.int8))
        t_mm.matmul_w8a8_cuda(x, w, torch.ones(n), xs)
        p = t_mm.plan_w8a8(m, k, n, SMS)
        assert seen["args"][7:14] == (m, k, n, p["bn"], p["splits"],
                                      p["steps"], 0)
        scratch = [s for s, dt in made if dt == torch.int32]
        assert scratch == ([(p["splits"], m, n)] if p["splits"] > 1 else [])
        assert (seen["args"][6] is None) == (p["splits"] == 1)
    assert t_mm.matmul_w8a8_cuda.launches == before + 3
    assert t_mm.matmul_w8a8_cuda.sum_launches == sums + 2


# ---------------------------------------------------------------------------
# K3: plan_conv(n, h, w, c_in, c_out, ks, sms, int8)
# ---------------------------------------------------------------------------

# (n, h, w, c_in, c_out, ks) of the 60 fused convs of one SD1.5 UNet eval at
# 512x512 and the CFG batch of 2 (44 ResBlock 3x3 convs, 16 proj_in), and the
# shapes of the VAE decoder's 28 at batch 1
UNET_CONVS = (
    [(2, 64, 64, 320, 320, 3)] * 7 + [(2, 64, 64, 640, 320, 3)] * 2
    + [(2, 64, 64, 960, 320, 3)] + [(2, 64, 64, 320, 320, 1)] * 5
    + [(2, 32, 32, 320, 640, 3)] + [(2, 32, 32, 640, 640, 3)] * 6
    + [(2, 32, 32, c, 640, 3) for c in (960, 1280, 1920)]
    + [(2, 32, 32, 640, 640, 1)] * 5
    + [(2, 16, 16, 640, 1280, 3)] + [(2, 16, 16, 1280, 1280, 3)] * 6
    + [(2, 16, 16, 1920, 1280, 3)] + [(2, 16, 16, 2560, 1280, 3)] * 2
    + [(2, 16, 16, 1280, 1280, 1)] * 5
    + [(2, 8, 8, 1280, 1280, 3)] * 11 + [(2, 8, 8, 2560, 1280, 3)] * 3
    + [(2, 8, 8, 1280, 1280, 1)])
VAE_CONVS = [(1, 64, 64, 512, 512, 3), (1, 128, 128, 512, 512, 3),
             (1, 256, 256, 512, 256, 3), (1, 256, 256, 256, 256, 3),
             (1, 512, 512, 256, 128, 3), (1, 512, 512, 128, 128, 3)]
RAGGED_CONVS = [(*shape, c_out, ks, int8, want) for shape, c_out, ks, _, int8,
                want in chip_smoke.CONV_RAGGED]


def test_unet_conv_count():
    assert len(UNET_CONVS) == 60


def _check_conv_plan(n, h, w, c_in, c_out, ks, int8, want=None):
    p = t_conv.plan_conv(n, h, w, c_in, c_out, ks, SMS, int8)
    m = n * h * w
    assert p["design"] in ("slab", "general")      # exactly one kernel
    if want is not None:
        assert p["design"] == want
    if p["design"] == "general":
        assert p == t_conv.general_plan(m, c_in, c_out, ks, SMS)
        assert p["splits"] == t_conv.splits_for(m, c_out, ks * ks * c_in, SMS)
        return p
    # the slab kernel's contract
    ph, pw, ns = p["ph"], p["pw"], p["ns"]
    assert c_in % 64 == 0 and p["bn"] in (128, 160)
    assert ns * ph * pw == 128 and 1 <= ns <= 8
    assert pw == min(w, 128) and w % pw == 0
    assert (h % ph == 0) if ns == 1 else (ph == h)
    pad = ks // 2
    rows = ns * (ph + 2 * pad) * (pw + 2 * pad)
    assert rows <= 400
    assert p["smem"] == t_conv.slab_smem_bytes(p["bn"], int8, ks, rows, ns)
    assert p["smem"] <= SMEM_CAP
    # the epilogue stages two 64 x bn bf16 tiles, rows padded by 16 bytes,
    # over the weight tiles
    groups, steps, lead = t_conv.slab_shape(ks)
    assert 2 * 64 * (2 * p["bn"] + 16) <= (3 if int8 else lead + 2) * p[
        "bn"] * 128
    assert steps > lead          # the next slab lands inside its chunk
    # the runs cover the Cin chunks exactly once and none is empty
    chunks_all = -(-(c_in // 64) // groups)
    assert p["splits"] >= 1 and p["chunks"] >= 1
    assert p["splits"] * p["chunks"] >= chunks_all
    assert (p["splits"] - 1) * p["chunks"] < chunks_all
    tiles = -(-m // 128) * -(-c_out // p["bn"])
    assert p["blocks"] == tiles * p["splits"] >= min(SMS, tiles)
    if 2 * tiles > SMS:
        assert p["splits"] == 1
    else:
        assert p["blocks"] <= SMS
        assert (p["splits"] == chunks_all
                or tiles * (p["splits"] + 1) > SMS
                or -(-chunks_all // (p["splits"] + 1)) == p["chunks"])
    if c_out % 160 == 0 and c_out % 128:
        assert p["bn"] == 160
    elif c_out % 128 == 0:
        assert p["bn"] == 128
    return p


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("site", sorted(set(UNET_CONVS)) + VAE_CONVS)
def test_conv_plan_at_every_main_path_site(site, int8):
    """Every UNet and VAE site gets the slab kernel but the UNet's 32x32
    ``proj_in`` (un-split, four slab chunks a block: the general kernel
    measured faster there)."""
    general = site == (2, 32, 32, 640, 640, 1)
    _check_conv_plan(*site, int8, "general" if general else "slab")
    slab = t_conv.slab_plan(*site, SMS, int8)
    if general:      # within the slab kernel's contract, kept off it by rule
        assert slab["splits"] == 1 and slab["chunks"] == 4
    else:
        assert slab == t_conv.plan_conv(*site, SMS, int8)


@pytest.mark.parametrize("case", RAGGED_CONVS)
def test_conv_plan_at_the_ragged_cases(case):
    _check_conv_plan(*case)


@pytest.mark.parametrize("site,want", [
    ((2, 64, 64, 320, 320, 3), {"bn": 160, "splits": 1, "chunks": 5,
                                "ph": 2, "pw": 64, "ns": 1, "blocks": 128}),
    ((2, 32, 32, 640, 640, 3), {"bn": 128, "splits": 1, "chunks": 10,
                                "ph": 4, "pw": 32, "ns": 1, "blocks": 80}),
    ((2, 16, 16, 1280, 1280, 3), {"bn": 128, "splits": 3, "chunks": 7,
                                  "ph": 8, "pw": 16, "ns": 1, "blocks": 120}),
    ((2, 8, 8, 1280, 1280, 3), {"bn": 128, "splits": 10, "chunks": 2,
                                "ph": 8, "pw": 8, "ns": 2, "blocks": 100}),
    ((2, 64, 64, 320, 320, 1), {"bn": 160, "splits": 1, "chunks": 2,
                                "ph": 2, "pw": 64, "ns": 1, "blocks": 128}),
    ((1, 512, 512, 128, 128, 3), {"bn": 128, "splits": 1, "chunks": 2,
                                  "ph": 1, "pw": 128, "ns": 1,
                                  "blocks": 2048}),
])
def test_conv_plan_at_the_main_shapes(site, want):
    p = t_conv.plan_conv(*site, SMS)
    assert p["design"] == "slab"
    assert {k: p[k] for k in want} == want


@pytest.mark.parametrize("h,w,want", [
    (64, 64, (2, 64, 1)), (32, 32, (4, 32, 1)), (16, 16, (8, 16, 1)),
    (8, 8, (8, 8, 2)), (4, 4, (4, 4, 8)), (8, 16, (8, 16, 1)),
    (128, 128, (1, 128, 1)), (4, 256, (1, 128, 1)), (512, 512, (1, 128, 1)),
    (1, 128, (1, 128, 1)), (16, 8, (16, 8, 1)),
    # rows that do not tile 128 pixels, planes under an eighth of a tile
    (63, 65, None), (5, 3, None), (6, 32, None), (3, 64, None),
    (2, 2, None), (8, 192, None), (9, 11, None),
])
def test_slab_patch(h, w, want):
    assert t_conv.slab_patch(h, w) == want


def test_slab_constants_are_the_sources():
    """The Python mirror of the slab kernel's shared-memory layout and
    limits against the constants in the source."""
    src = (_build.SRC_DIR / "conv_gn_silu.cu").read_text()
    assert f"constexpr int SLAB_PITCH = {t_conv._SLAB_PITCH};" in src
    assert f"constexpr int SLAB_MAX_ROWS = {t_conv._SLAB_MAX_ROWS};" in src
    assert f"constexpr int SLAB_MAX_SAMPLES = {t_conv._SLAB_MAX_SAMPLES};" \
        in src
    assert "constexpr size_t SMEM_CAP = 227 * 1024;" in src
    assert t_conv._SMEM_CAP == SMEM_CAP
    assert "static constexpr int G = KS == 3 ? 1 : 3;" in src
    assert "static constexpr int T = KS == 3 ? 9 : 3;" in src
    assert "static constexpr int D = KS == 3 ? 3 : 2;" in src
    assert t_conv.slab_shape(3) == (1, 9, 3)
    assert t_conv.slab_shape(1) == (3, 3, 2)


def test_conv_plan_is_what_the_wrapper_passes(monkeypatch):
    """The wrapper hands the plan to the C entry point as it is, with a
    float32 scratch of ``[splits, m, c_out]`` exactly where the reduction is
    split, and the per-tile counters only for the general kernel."""
    seen, made = {}, []
    _fake_card(monkeypatch, "sdtpu_conv_gn_silu", seen, made)
    monkeypatch.setattr(t_conv, "eligible", lambda x, w, s, p: True)
    monkeypatch.setattr(t_conv, "_tile_counters",
                        lambda device, tiles: torch.zeros(tiles,
                                                          dtype=torch.int32))
    real_device = torch.Tensor.device

    class Cuda(torch.Tensor):
        device = types.SimpleNamespace(type="cuda")

    before = t_conv.fused_conv_cuda.launches
    for site in ((2, 8, 8, 128, 192, 3), (2, 16, 16, 64, 64, 3),
                 (1, 6, 32, 64, 64, 3), (2, 5, 5, 4096, 128, 3)):
        n, h, w, c_in, c_out, ks = site
        made.clear()
        x = torch.zeros((n, h, w, c_in), dtype=torch.bfloat16).as_subclass(
            Cuda)
        wt = torch.zeros((c_out, c_in, ks, ks), dtype=torch.bfloat16
                         ).contiguous(memory_format=torch.channels_last
                                      ).as_subclass(Cuda)
        b = torch.zeros(c_out).as_subclass(Cuda)
        t_conv.fused_conv_cuda(x, wt, b)
        p = t_conv.plan_conv(*site, SMS, False)
        assert seen["args"][9:15] == site
        assert seen["args"][18:25] == (
            int(p["design"] == "slab"), p["bn"], p["splits"], p["chunks"],
            p["ph"], p["pw"], p["ns"])
        scratch = [s for s, dt in made if dt == torch.float32]
        assert scratch == ([(p["splits"], n * h * w, c_out)]
                           if p["splits"] > 1 else [])
        assert (seen["args"][7] is None) == (p["splits"] == 1)
        assert (seen["args"][8] is None) == (
            p["splits"] == 1 or p["design"] == "slab")
    assert real_device is torch.Tensor.device
    assert t_conv.fused_conv_cuda.launches == before + 4


# ---------------------------------------------------------------------------
# K2: plan_gn(n, hw, c, groups, sms), both modes
# ---------------------------------------------------------------------------

# (n, hw, c) of the 61 GroupNorms of one SD1.5 UNet eval at 512x512 and the
# CFG batch of 2, 32 groups each: the 44 ResBlock norms (down 8 ResBlocks,
# mid 2, up 12 over the skip concats), the 16 transformer norms and
# out_norm; and of the 28 GroupNorms the VAE decoder's fused convs fold
# (gn_affine, the statistics mode) at batch 1: 14 ResBlocks x 2
UNET_GNS = ([(2, 4096, 320)] * 13 + [(2, 4096, 640)] * 2 + [(2, 4096, 960)]
            + [(2, 1024, 320)] + [(2, 1024, 640)] * 11
            + [(2, 1024, c) for c in (960, 1280, 1920)]
            + [(2, 256, 640)] + [(2, 256, 1280)] * 11 + [(2, 256, 1920)]
            + [(2, 256, 2560)] * 2 + [(2, 64, 1280)] * 12
            + [(2, 64, 2560)] * 3)
VAE_GNS = ([(1, 4096, 512)] * 10 + [(1, 16384, 512)] * 6 + [(1, 65536, 512)]
           + [(1, 65536, 256)] * 5 + [(1, 262144, 256)]
           + [(1, 262144, 128)] * 5)
GN_RAGGED = [case[:4] for case in chip_smoke.GN_RAGGED]
# the planes no cluster's shared memory holds: the VAE's 256^2 and 512^2
STREAMED = {(1, 65536, 512), (1, 65536, 256), (1, 262144, 256),
            (1, 262144, 128)}
# the sites the float64 emulation takes on the CPU (up to 8M values)
SMALL_GNS = [s for s in sorted(set(UNET_GNS)) + [(1, 4096, 512)] + GN_RAGGED
             if s[0] * s[1] * s[2] <= 2 ** 23]


def test_gn_site_counts():
    assert len(UNET_GNS) == 61 and len(VAE_GNS) == 28
    # a fused conv's input is a GroupNorm's: the same planes
    assert {(n, h * w, c) for n, h, w, c, _, _ in UNET_CONVS} == set(UNET_GNS)
    assert {(n, h * w, c) for n, h, w, c, _, _ in VAE_CONVS} == set(VAE_GNS)


def _check_gn_plan(n, hw, c, groups):
    p = t_gn.plan_gn(n, hw, c, groups, SMS)
    cpg = c // groups
    span, cl, rows = p["span"], p["cluster"], p["rows"]
    # whole groups and whole vectors: 16 bytes wherever C allows
    assert p["vec"] == (8 if c % 8 == 0 else 2 if c % 2 == 0 else 1)
    assert span % math.lcm(cpg, p["vec"]) == 0 and c % span == 0
    if c % 8 == 0:
        assert p["vec"] == 8 and span % 8 == 0
    # the clusters' runs of rows cover the plane exactly once
    assert 1 <= cl <= 16 and cl <= hw
    if p["variant"] == "resident":
        assert cl <= t_gn._BIG_CLUSTER
    assert cl * rows >= hw and (cl - 1) * rows < hw
    covered = [r for b in range(cl)
               for r in range(min(hw, b * rows), min(hw, (b + 1) * rows))]
    assert covered == list(range(hw))
    assert 1 <= p["chunk"] <= rows
    assert p["smem"] == t_gn.gn_smem_bytes(span, cpg, p["chunk"], p["bufs"])
    assert p["smem"] <= SMEM_CAP
    assert p["grid"] == (cl, n * (c // span))
    assert p["blocks"] == cl * n * (c // span)
    assert n * (c // span) <= 65535
    # one tile of the block's rows, or chunks through two buffers
    assert p["bufs"] == (1 if p["chunk"] == rows else 2)
    assert p["variant"] == ("resident" if p["bufs"] == 1 else "streamed")
    assert p["smem"] <= t_gn._RESIDENT     # two blocks an SM
    return p


@pytest.mark.parametrize("site", sorted(set(UNET_GNS)) + sorted(set(VAE_GNS))
                         + GN_RAGGED)
def test_gn_plan_at_every_site(site):
    """Every UNet and VAE site and the smoke run's ragged ones: spans of
    whole groups and 16-byte vectors covering whole 32-byte sectors where C
    is a multiple of 8, rows covered once, at most 16 blocks a cluster and
    227 KB a block; resident (x read once) at every UNet site, streamed at
    the VAE's planes of 256^2 and 512^2; one wave on the 132 SMs."""
    n, hw, c = site[:3]
    groups = site[3] if len(site) > 3 else 32
    p = _check_gn_plan(n, hw, c, groups)
    assert p["variant"] == ("streamed" if (n, hw, c) in STREAMED
                            else "resident")
    if p["variant"] == "resident":
        assert p["blocks"] <= 2 * SMS
    else:
        assert p["cluster"] == 16 and p["blocks"] >= SMS - 4


@pytest.mark.parametrize("site,want", [
    # the narrowest span of whole groups and sectors; a block per 256 rows
    ((2, 4096, 320), {"span": 40, "cluster": 8, "rows": 512,
                      "blocks": 128}),
    ((2, 1024, 640), {"span": 40, "cluster": 4, "rows": 256,
                      "blocks": 128}),
    # a 64 KB tile at most: 120 channels x 342 rows in 12-block clusters
    ((2, 4096, 960), {"span": 120, "cluster": 12, "rows": 342,
                      "blocks": 192}),
    # the 16x16 and 8x8 levels: one block a (sample, span), no cluster
    ((2, 256, 1280), {"span": 40, "cluster": 1, "rows": 256,
                      "blocks": 64}),
    ((2, 64, 1280), {"span": 40, "cluster": 1, "rows": 64, "blocks": 64}),
    ((2, 64, 2560), {"span": 80, "cluster": 1, "rows": 64, "blocks": 64}),
    # the VAE's 512^2 x 128: 32-byte spans, 16-block clusters, 32 KB chunks
    ((1, 262144, 128), {"span": 16, "cluster": 16, "rows": 16384,
                        "chunk": 1024, "blocks": 128}),
])
def test_gn_plan_at_the_main_shapes(site, want):
    p = t_gn.plan_gn(*site, 32, SMS)
    assert {k: p[k] for k in want} == want


@pytest.mark.parametrize("args", [(0, 64, 320, 32), (2, 0, 320, 32),
                                  (2, 64, 320, 0), (2, 64, 320, 33)])
def test_gn_plan_rejects(args):
    with pytest.raises(ValueError):
        t_gn.plan_gn(*args, SMS)


def test_gn_constants_are_the_sources():
    """The Python mirror of the kernel's block, cluster and shared-memory
    layout against the source."""
    src = (_build.SRC_DIR / "group_norm_silu.cu").read_text()
    assert f"constexpr int THREADS = {t_gn._THREADS};" in src
    assert f"constexpr int MAX_CLUSTER = {t_gn._MAX_CLUSTER};" in src
    assert f"constexpr int MAX_BUFS = {t_gn._MAX_BUFS};" in src
    assert "constexpr size_t SMEM_CAP = 227 * 1024;" in src
    assert t_gn._SMEM_CAP == SMEM_CAP
    assert "l.red = bufs * buf;" in src
    assert "l.chs = l.red + (size_t)THREADS * 8 * sizeof(float);" in src
    assert "l.ab = l.chs + (size_t)span * sizeof(float);" in src
    assert "l.gst = l.ab + 2 * (size_t)span * sizeof(float);" in src
    assert "l.total = l.gst + 6 * (size_t)(span / cpg) * sizeof(float);" \
        in src
    assert f"constexpr int MAX_CPG = {t_gn.MAX_CHANNELS_PER_GROUP};" in src


def _emulate_gn_stats(x, groups, plan, dtype):
    """The kernel's statistics in ``dtype``, by its partition: (sample,
    span) clusters of ``plan["cluster"]`` blocks of ``plan["rows"]`` rows,
    each in chunks of ``plan["chunk"]``; a chunk's group mean, then its
    centred squares; Chan's formula over a block's chunks, then over the
    cluster's blocks in rank order. Returns mean, variance [N, G]."""
    n, hw, c = x.shape
    cpg = c // groups
    span, rows, chunk = plan["span"], plan["rows"], plan["chunk"]
    xs = x.to(dtype).reshape(n, hw, c // span, span // cpg, cpg)
    parts = []
    for rank in range(plan["cluster"]):
        r0, r1 = min(hw, rank * rows), min(hw, (rank + 1) * rows)
        cnt, mean, m2 = 0, 0.0, 0.0
        for k0 in range(r0, r1, chunk):
            t = xs[:, k0:min(r1, k0 + chunk)]
            nb = t.shape[1] * cpg
            mb = t.sum(dim=(1, 4)) / nb
            qb = ((t - mb[:, None, :, :, None]) ** 2).sum(dim=(1, 4))
            if cnt == 0:
                mean, m2 = mb, qb
            else:
                d = mb - mean
                mean = mean + d * (nb / (cnt + nb))
                m2 = m2 + qb + d * d * (cnt * nb / (cnt + nb))
            cnt += nb
        parts.append((cnt, mean, m2))
    total = hw * cpg
    mean = sum(cnt / total * m for cnt, m, _ in parts)
    m2 = sum(q + cnt * (m - mean) ** 2 for cnt, m, q in parts)
    return mean.reshape(n, groups), (m2 / total).reshape(n, groups)


def _forced_streamed(n, hw, c, groups, cl, chunk):
    plan = t_gn.plan_gn(n, hw, c, groups, SMS)
    return {**plan, **t_gn._layout(hw, plan["span"], c // groups, cl, chunk)}


@pytest.mark.parametrize("site", SMALL_GNS + ["streamed", "cluster_edge"])
def test_gn_partition_and_chan_match_the_plain_version(site):
    """The kernel's partition and combination, emulated in float64, against
    ``gn_affine``'s plain version at each site's tiling (and a streamed plan
    of many chunks and a 16-block cluster with empty blocks, at small
    planes), on a plane of mean 64 and std 1. There E[x^2] - mean^2 in
    float32 loses the variance; the float32 emulation keeps it."""
    if site == "streamed":
        n, hw, c, groups = 2, 1000, 320, 32
        plan = _forced_streamed(n, hw, c, groups, 16, 7)
        assert plan["bufs"] == 2
    elif site == "cluster_edge":
        n, hw, c, groups = 2, 9, 320, 32
        plan = _forced_streamed(n, hw, c, groups, 16, 1)
    else:
        n, hw, c = site[:3]
        groups = site[3] if len(site) > 3 else 32
        plan = t_gn.plan_gn(n, hw, c, groups, SMS)
    rng = np.random.default_rng(hw + c)
    x = torch.from_numpy(rng.standard_normal((n, hw, c)).astype(np.float32)
                         + 64.0)
    p = {"scale": torch.from_numpy(rng.random(c).astype(np.float32) + 0.5),
         "bias": torch.from_numpy(rng.standard_normal(c).astype(np.float32))}
    mean, var = _emulate_gn_stats(x, groups, plan, torch.float64)
    cpg = c // groups
    rstd = torch.rsqrt(var + 1e-5)
    a = rstd.repeat_interleave(cpg, dim=1) * p["scale"].double()
    d = p["bias"].double() - (mean * rstd).repeat_interleave(cpg, dim=1) * \
        p["scale"].double()
    ra, rd = t_conv.gn_affine_reference(p, x, groups, 1e-5)
    for ours, ref in ((a, ra), (d, rd)):
        assert (ours.float() - ref).abs().max() <= 1e-4 * ref.abs().max()
    xd = x.double().reshape(n, hw, groups, cpg)
    true_var = xd.var(dim=(1, 3), unbiased=False)
    _, var32 = _emulate_gn_stats(x, groups, plan, torch.float32)
    naive = ((x * x).reshape(n, hw, groups, cpg).mean(dim=(1, 3))
             - x.reshape(n, hw, groups, cpg).mean(dim=(1, 3)) ** 2)
    err = (var32.double() - true_var).abs().max().item()
    assert err <= 1e-4
    if hw * cpg >= 4096:
        assert (naive.double() - true_var).abs().max().item() > 10 * err


def test_gn_plan_is_what_the_wrapper_passes(monkeypatch):
    """Both modes hand ``plan_gn``'s span, cluster and chunk to the C entry
    point as they are."""
    _fake_card(monkeypatch, "sdtpu_group_norm_silu", {}, [])
    entries = {}

    def entry(name):
        def run(*args):
            entries[name] = args
            return 0
        return run

    lib = types.SimpleNamespace(
        sdtpu_group_norm_silu=entry("silu"),
        sdtpu_group_norm_affine=entry("affine"))
    monkeypatch.setattr(_build, "library", lambda: lib)

    class Cuda(torch.Tensor):
        device = types.SimpleNamespace(type="cuda")

    before = (t_gn.group_norm_cuda.launches,
              t_gn.group_norm_affine_cuda.launches)
    for n, hw, c, groups in ((2, 4096, 320, 32), (2, 64, 2560, 32),
                             (1, 5, 9, 3), (1, 65536, 256, 32)):
        x = torch.zeros((n, hw, c), dtype=torch.bfloat16).as_subclass(Cuda)
        p = {k: torch.zeros(c).as_subclass(Cuda) for k in ("scale", "bias")}
        t_gn.group_norm_cuda(p, x, groups, 1e-5, True)
        t_gn.group_norm_affine_cuda(p, x, groups, 1e-5)
        plan = t_gn.plan_gn(n, hw, c, groups, SMS)
        want = (n, hw, c, groups, plan["span"], plan["cluster"],
                plan["chunk"], plan["bufs"])
        assert entries["silu"][4:12] == want
        assert entries["affine"][5:13] == want
    assert (t_gn.group_norm_cuda.launches,
            t_gn.group_norm_affine_cuda.launches) == (before[0] + 4,
                                                      before[1] + 4)


# ---------------------------------------------------------------------------
# the build: headers in the hash, the generated header, the C signatures
# ---------------------------------------------------------------------------

def test_headers_are_found():
    assert [h.name for h in _build.headers()] == ["wgmma_sm90.cuh"]


@pytest.mark.parametrize("name", ["wgmma_sm90.cuh"])
def test_source_hash_covers_each_header(monkeypatch, name):
    """Editing a header the kernels include moves the library to a new
    build directory."""
    full = _build.source_hash()
    rest = [h for h in _build.headers() if h.name != name]
    monkeypatch.setattr(_build, "headers", lambda: rest)
    assert _build.source_hash() != full


def test_source_hash_covers_the_flags(monkeypatch):
    full = _build.source_hash()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-g"])
    assert _build.source_hash() != full


def _generator():
    return _load(_build.SRC_DIR / "gen_wgmma.py", "gen_wgmma")


def test_wgmma_header_is_the_generators_output():
    assert (_build.SRC_DIR / "wgmma_sm90.cuh").read_text() == \
        _generator().render()


@pytest.mark.parametrize("n,forms", [
    (16, ("rs_mn",)), (32, ("ss", "rs_mn")), (48, ("rs_mn",)),
    (64, ("ss", "rs_mn")), (80, ("rs_mn",)),
    (128, ("ss", "rs_mn", "rs", "ss_s8")), (160, ("ss", "rs", "ss_s8")),
    (256, ("rs_mn", "ss_s8"))])
def test_wgmma_header_has_each_width(n, forms):
    """Every accumulator width a kernel instantiates has its wrapper, in
    the forms it is instantiated in and no other (flash: ``ss`` at its key
    tiles, ``rs_mn`` at its padded head dims and the halves of 256 and 512;
    the GEMMs: ``ss`` and the int8 ``ss_s8`` at their column tiles; the conv:
    ``rs`` at its), with N / 2 accumulator operands a thread, float for the
    m64nNk16 bf16 instruction and int for the m64nNk32 int8 one."""
    text = _generator().struct(n)
    assert f"struct Wgmma<{n}>" in text
    assert [f for f in ("ss", "rs_mn", "rs", "ss_s8")
            if f"void {f}(" in text] == list(forms)
    bf16 = [f for f in forms if f != "ss_s8"]
    assert text.count(
        f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16") == len(bf16)
    assert text.count('"+f"(d[') == len(bf16) * (n // 2)
    int8 = len(forms) - len(bf16)
    assert text.count(
        f"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8") == int8
    assert text.count('"+r"(d[') == int8 * (n // 2)
    # the register-operand forms differ in the transpose flag of B alone
    assert text.count("p, 1, 1, 1;") == ("rs_mn" in forms)
    assert text.count("p, 1, 1, 0;") == ("rs" in forms)


def test_wgmma_forms_are_what_the_kernels_instantiate():
    """flash_attn_fwd.cu: ``ss`` over the keys of a step, ``rs_mn`` over a
    warpgroup's output columns (the padded head dim, half of it above 128);
    matmul_int8w.cu: ``ss`` over its column tile; matmul_w8a8.cu: ``ss_s8``
    over its column tile; conv_gn_silu.cu: ``rs`` over its column tile."""
    forms = _generator().FORMS
    plans = [t_attn.plan(d, 4096, 4096, 16, SMS) for d in range(8, 513, 8)]
    bns = {t_mm.plan_int8w(m, 320, n, SMS)["bn"]
           for m in (64, 8192) for n in (320, 640, 130)}
    assert set(forms["ss"]) == {bkv for _, _, bkv in plans} | bns
    assert set(forms["rs_mn"]) == {dpad if dpad <= 128 else dpad // 2
                                   for dpad, _, _ in plans}
    assert set(forms["ss_s8"]) == {t_mm.plan_w8a8(m, k, n, SMS)["bn"]
                                   for m, k, n in _w8a8_sites() + MM_RAGGED}
    assert set(forms["rs"]) == {
        t_conv.plan_conv(*site, SMS)["bn"] for site in UNET_CONVS + VAE_CONVS}
    for name, form, count in (("matmul_w8a8.cu", "ss_s8", 1),
                              ("conv_gn_silu.cu", "rs", 1),
                              ("matmul_int8w.cu", "ss", 1)):
        src = (_build.SRC_DIR / name).read_text()
        assert src.count(f"Wgmma<BN>::{form}(") == count


PTXAS = """\
ptxas info    : Compiling entry function '_Z3fooILi48EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooILi48EEvPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 82 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers
"""


def test_parse_ptxas_reads_registers_and_spills():
    assert _build.parse_ptxas(PTXAS) == [
        {"kernel": "_Z3fooILi48EEvPf", "registers": 82,
         "spill_store_bytes": 0, "spill_load_bytes": 0},
        {"kernel": "_Z3barv", "registers": 255, "spill_store_bytes": 8,
         "spill_load_bytes": 4}]
    assert _build.parse_ptxas("nothing compiled") == []


@pytest.mark.parametrize("module,fn,pointers,ints", [
    (t_attn, "sdtpu_flash_attn_fwd", 4, 8),
    (t_mm, "sdtpu_matmul_int8w", 6, 7),
    (t_mm, "sdtpu_matmul_w8a8", 7, 7),
    (t_conv, "sdtpu_conv_gn_silu", 9, 16),
    # K2: (ints before eps, ints after it)
    (t_gn, "sdtpu_group_norm_silu", 4, (8, 2)),
    (t_gn, "sdtpu_group_norm_affine", 5, (8, 1)),
    (t_gn, "sdtpu_group_norm_clusters", 0, 9),
])
def test_bind_declares_the_c_signature(module, fn, pointers, ints):
    """Pointers and the stream as c_void_p (never cut to 32 bits), then the
    ints (K2's eps, a float, among them), in the entry point's order."""
    import ctypes

    names = ("sdtpu_flash_attn_fwd", "sdtpu_matmul_int8w",
             "sdtpu_matmul_w8a8", "sdtpu_conv_gn_silu",
             "sdtpu_group_norm_silu", "sdtpu_group_norm_affine",
             "sdtpu_group_norm_clusters")
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in names})
    module.bind(lib)
    sig = getattr(lib, fn)
    before, after = ints if isinstance(ints, tuple) else (ints, None)
    tail = ([] if after is None
            else [ctypes.c_float] + [ctypes.c_int] * after)
    assert sig.argtypes == ([ctypes.c_void_p] * pointers
                            + [ctypes.c_int] * before + tail
                            + [ctypes.c_void_p])
    assert sig.restype is ctypes.c_int
    src = (_build.SRC_DIR / {"sdtpu_flash_attn_fwd": "flash_attn_fwd.cu",
                             "sdtpu_matmul_int8w": "matmul_int8w.cu",
                             "sdtpu_matmul_w8a8": "matmul_w8a8.cu",
                             "sdtpu_conv_gn_silu": "conv_gn_silu.cu"}.get(
        fn, "group_norm_silu.cu")).read_text()
    decl = src[src.index(f'extern "C" int {fn}('):]
    decl = decl[:decl.index(")")]
    assert decl.count("void*") == pointers + 1
    assert decl.count("int ") == before + (after or 0) + 1  # and the return
    assert decl.count("float ") == (after is not None)


def test_no_fallback_in_the_wrappers():
    """On a CUDA tensor a wrapper launches or raises: no ``try`` in the
    kernel wrappers' modules, and no library attention or GEMM in them."""
    for mod in (t_attn, t_gn, t_mm, t_conv):
        text = Path(mod.__file__).read_text()
        assert "try:" not in text and "except" not in text
    assert "scaled_dot_product_attention" not in Path(
        t_attn.__file__).read_text()
    assert "functional" not in Path(t_gn.__file__).read_text()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,c,heads", [
    (2, 4096, 1000, 320, 8),     # ragged sk, sq != sk, d = 40 padded to 48
    (1, 128, 128, 40, 1),        # one tile
    (1, 130, 1, 40, 1),          # a single key
    (2, 300, 77, 80, 2),
    (1, 128, 256, 8, 1), (1, 256, 128, 64, 1), (1, 256, 200, 128, 1),
    (1, 200, 136, 144, 1), (1, 256, 256, 256, 1),
    (1, 1000, 4096, 512, 1),     # the split design, ragged sq
])
def test_cuda_flash_at_the_shapes_the_tiles_could_break(b, sq, sk, c, heads):
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((b, sq, c), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, sk, c), generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    out = t_attn.flash_attention_cuda(q, k, v, heads)
    torch.cuda.synchronize()
    ref = t_attn.flash_attention_reference(q.float(), k.float(), v.float(),
                                           heads)
    # relative to the output's largest value: the bf16 output (2^-9) and
    # bf16 P before P.V leave it near 2^-8; a dropped key tile, a coarser P
    # or a scale some per cent off does not
    assert (out.float() - ref).abs().max().item() <= 2.0 ** -6 * ref.abs(
        ).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [256, 2])
def test_cuda_int8w_widening_is_exact(m):
    """All 256 int8 values through the kernel (the tile kernel's bit-trick
    widening at m = 256, the skinny kernel's at m = 2): one-hot rows of x
    pick each weight out, and the output must equal it."""
    _needs_card()
    vals = torch.arange(-128, 128, device="cuda").to(torch.int8)
    w8 = t_mm.column_major(vals[:, None].expand(256, 16).contiguous())
    ones = torch.ones(16, device="cuda")
    if m == 256:
        x = torch.eye(256, device="cuda", dtype=torch.bfloat16)
        out = t_mm.matmul_int8w_cuda(x, w8, ones)
        assert bool((out.float() == vals.float()[:, None]).all())
        return
    for k0 in range(0, 256, 2):
        x = torch.zeros((2, 256), device="cuda", dtype=torch.bfloat16)
        x[0, k0] = x[1, k0 + 1] = 1
        out = t_mm.matmul_int8w_cuda(x, w8, ones).float()
        assert bool((out[0] == k0 - 128).all() and (out[1] == k0 - 127).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MM_RAGGED + [
    (512, 1280, 1280), (128, 5120, 1280), (154, 768, 320), (2, 1280, 1280),
    (8192, 320, 320), (5, 4096, 33)])
def test_cuda_int8w_paths_match_plain(m, k, n):
    """The K tail, ragged M and N, split-K and the skinny kernel, within one
    bf16 rounding of the float32 plain version (the sums run in another
    order, split-K's in runs)."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn((k, n), generator=g, device="cuda") * 0.05
    scale = w.abs().amax(dim=0) / 127.0
    w8 = t_mm.column_major(torch.clamp(torch.round(w / scale), -127, 127)
                           .to(torch.int8))
    b = torch.randn(n, generator=g, device="cuda")
    out = t_mm.matmul_int8w_cuda(x, w8, scale, b)
    again = t_mm.matmul_int8w_cuda(x, w8, scale, b)
    torch.cuda.synchronize()
    ref = t_mm.matmul_int8w_reference(x.float(), w8, scale, b)
    assert (out.float() - ref).abs().max().item() <= 1e-2 * ref.abs().max(
        ).item()
    assert torch.equal(out, again)      # no atomics: the same bytes


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MM_RAGGED + [
    (512, 1280, 1280), (128, 5120, 1280), (154, 768, 320), (2, 1280, 1280),
    (2048, 640, 5120)])
def test_cuda_w8a8_is_bit_equal_to_plain(m, k, n):
    """The K tail, ragged M and N, one step and a tail, split-K with int32
    partials: every value equal to the plain version's, and the same bytes
    twice."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn((k, n), generator=g, device="cuda") * 0.05
    scale = w.abs().amax(dim=0) / 127.0
    w8 = t_mm.column_major(torch.clamp(torch.round(w / scale), -127, 127)
                           .to(torch.int8))
    b = torch.randn(n, generator=g, device="cuda")
    xs = x.float().abs().max() / 127.0
    out = t_mm.matmul_w8a8_cuda(x, w8, scale, xs, b)
    again = t_mm.matmul_w8a8_cuda(x, w8, scale, xs, b)
    torch.cuda.synchronize()
    ref = t_mm.matmul_w8a8_reference(x, w8, scale, xs, b)
    assert int((out != ref).sum().item()) == 0
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_cuda_w8a8_quantizes_every_value_as_plain():
    """The kernel's rounding (an addition of 1.5 * 2^23) against the plain
    version's round-half-even and clip, on halves, values past the clip and
    both zeros: an identity weight picks each quantized value out."""
    _needs_card()
    vals = torch.cat([torch.arange(-130, 131, dtype=torch.float32) * 0.5,
                      torch.tensor([-0.0, 0.0, 1e30, -1e30, 126.5, -126.5,
                                    0.49, -0.49])])
    k = 272
    x = torch.zeros((k, k), dtype=torch.float32)
    x.diagonal()[:vals.numel()] = vals
    x = x.to(torch.bfloat16).cuda()
    w8 = t_mm.column_major(torch.eye(k, dtype=torch.int8).cuda())
    ones = torch.ones(k, device="cuda")
    xs = torch.ones((), device="cuda")
    out = t_mm.matmul_w8a8_cuda(x, w8, ones, xs)
    torch.cuda.synchronize()
    want = t_mm.quantize_activation(x, xs).to(torch.bfloat16)
    assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.CONV_RAGGED)
def test_cuda_conv_at_the_ragged_cases(case):
    """Both kernels of the conv source at the shapes their tiles could
    break, within one bf16 rounding of the float32 plain version, the same
    bytes twice, and the kernel the case was written for."""
    _needs_card()
    shape, c_out, ks, prologue, int8, want = case
    n, h, w_, c_in = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn((c_out, c_in, ks, ks), generator=g, device="cuda") / (
        ks * ks * c_in) ** 0.5
    scale = None
    if int8:
        scale = w.abs().amax(dim=(1, 2, 3)) / 127.0
        w = torch.round(w / scale[:, None, None, None]).to(torch.int8)
    else:
        w = w.to(torch.bfloat16)
    w = w.contiguous(memory_format=torch.channels_last)
    b = torch.randn((n, c_out), generator=g, device="cuda")
    kw = {}
    if prologue:
        kw = {"a": torch.rand((n, c_in), generator=g, device="cuda") + 0.5,
              "d": torch.randn((n, c_in), generator=g, device="cuda"),
              "silu": prologue == "silu"}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert t_conv.plan_conv(n, h, w_, c_in, c_out, ks, sms, int8)[
        "design"] == want
    out = t_conv.fused_conv_cuda(x, w, b, w_scale=scale, **kw)
    again = t_conv.fused_conv_cuda(x, w, b, w_scale=scale, **kw)
    torch.cuda.synchronize()
    ref = t_conv.fused_conv_reference(x.float(), w, b, w_scale=scale, **kw)
    assert (out.float() - ref).abs().max().item() <= 1e-2 * ref.abs().max(
        ).item()
    assert torch.equal(out, again)


# K2, both modes, on the card

# one main-path site of each span class, C/G = 10, 20, 30, 40, 60, 80
GN_SPAN_CLASSES = [(2, 4096, 320, 32), (2, 4096, 640, 32), (2, 4096, 960, 32),
                   (2, 1024, 1280, 32), (2, 1024, 1920, 32), (2, 64, 2560, 32)]


def _gn_inputs(n, hw, c, mean=0.5, std=2.0):
    g = torch.Generator(device="cuda").manual_seed(hw + c)
    x = (torch.randn((n, hw, c), generator=g, device="cuda") * std + mean
         ).to(torch.bfloat16)
    p = {"scale": (torch.rand(c, generator=g, device="cuda") + 0.5).to(
             torch.bfloat16),
         "bias": torch.randn(c, generator=g, device="cuda").to(
             torch.bfloat16)}
    return x, p


def _check_gn_modes(x, p, groups, eps=1e-5):
    """Both modes twice: y within one bf16 rounding (2^-9 relative, 1e-2
    with room) of the float32 plain version, A and D within 1e-4 of
    theirs (float32 both, sums in another order); the same bytes twice."""
    y = t_gn.group_norm_cuda(p, x, groups, eps, True)
    y2 = t_gn.group_norm_cuda(p, x, groups, eps, True)
    a, d = t_gn.group_norm_affine_cuda(p, x, groups, eps)
    a2, d2 = t_gn.group_norm_affine_cuda(p, x, groups, eps)
    torch.cuda.synchronize()
    ref = t_gn.group_norm_reference(p, x.float(), groups, eps, True)
    assert (y.float() - ref).abs().max().item() <= 1e-2 * ref.abs().max(
        ).item()
    ra, rd = t_conv.gn_affine_reference(p, x, groups, eps)
    for ours, want in ((a, ra), (d, rd)):
        assert (ours - want).abs().max().item() <= 1e-4 * want.abs().max(
            ).item()
    assert torch.equal(y, y2) and torch.equal(a, a2) and torch.equal(d, d2)


@pytest.mark.cuda
@pytest.mark.parametrize("n,hw,c,groups", GN_SPAN_CLASSES + GN_RAGGED)
def test_cuda_group_norm_both_modes_at_each_class(n, hw, c, groups):
    """Each span class, the ragged cases (C % 8 != 0, odd planes, a short
    last run of a 16-block cluster) and the streamed VAE plane."""
    _needs_card()
    _check_gn_modes(*_gn_inputs(n, hw, c), groups)


@pytest.mark.cuda
def test_cuda_group_norm_keeps_the_variance_at_mean_64():
    """A plane of mean 64 and std 1, where E[x^2] - mean^2 in float32 would
    lose the variance."""
    _needs_card()
    _check_gn_modes(*_gn_inputs(2, 4096, 320, mean=64.0, std=1.0), 32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,hw,c,groups,cl,chunk", [
    (2, 5, 320, 32, 16, 1),      # 11 of 16 blocks without a row
    (2, 9, 2560, 32, 16, 1),
    (2, 300, 320, 32, 16, 7),    # streamed: 3 chunks of 7 rows a block
    (1, 1000, 960, 32, 13, 5),
    (2, 77, 30, 3, 16, 2),       # 4-byte vectors, streamed
    (1, 5, 9, 3, 4, 1),          # 2-byte vectors, empty blocks
])
def test_cuda_group_norm_at_forced_plans(monkeypatch, n, hw, c, groups, cl,
                                         chunk):
    """Plans the static rule does not give but the C entry point takes: a
    16-block cluster over fewer rows than blocks, many chunks through two
    buffers, clusters that are not a power of two."""
    _needs_card()
    plan = _forced_streamed(n, hw, c, groups, cl, chunk)
    monkeypatch.setattr(t_gn, "plan_gn", lambda *a: plan)
    _check_gn_modes(*_gn_inputs(n, hw, c), groups)


@pytest.mark.cuda
@pytest.mark.parametrize("n,hw,c", [(2, 4096, 320), (2, 64, 2560),
                                    (1, 65536, 256)])
def test_cuda_group_norm_graph_replays_give_the_same_bytes(n, hw, c):
    """Both modes captured in a CUDA graph (cluster launches), replayed
    twice: each replay gives the eager calls' bytes."""
    _needs_card()
    x, p = _gn_inputs(n, hw, c)
    want = (t_gn.group_norm_cuda(p, x, 32, 1e-5, True),
            *t_gn.group_norm_affine_cuda(p, x, 32, 1e-5))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        t_gn.group_norm_cuda(p, x, 32, 1e-5, True)
        t_gn.group_norm_affine_cuda(p, x, 32, 1e-5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = (t_gn.group_norm_cuda(p, x, 32, 1e-5, True),
               *t_gn.group_norm_affine_cuda(p, x, 32, 1e-5))
    for _ in range(2):
        for t in got:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("site", sorted(set(UNET_GNS)) + sorted(set(VAE_GNS)))
def test_cuda_gn_plan_is_one_wave(site):
    """The card holds every cluster of a main-path plan at once
    (``cudaOccupancyMaxActiveClusters``)."""
    _needs_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = t_gn.plan_gn(*site, 32, sms)
    need = p["grid"][1] if p["cluster"] > 1 else p["blocks"]
    assert t_gn.co_resident(*site, 32, p) >= need


@pytest.mark.cuda
def test_cuda_flash_float32_takes_the_plain_path():
    """dataclasses.replace(SD15, dtype="float32")'s 64x64 self-attention on
    the card: the rule sends it to ``layers.sdpa``; nothing raises and the
    kernel does not launch."""
    _needs_card()
    from sdtpu_torch.models.layers import sdpa

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((2, 4096, 320), generator=g, device="cuda")
               for _ in range(3))
    before = t_attn.flash_attention_cuda.launches
    out = t_attn.flash_attention(q, k, v, 8)
    torch.cuda.synchronize()
    assert t_attn.flash_attention_cuda.launches == before
    assert torch.equal(out, sdpa(q, k, v, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("n,hw,c,groups,fuse_silu", [
    (2, 4096, 320, 32, True), (2, 64, 2560, 32, False), (2, 77, 30, 3, True),
    (1, 5, 9, 3, False)])
def test_cuda_group_norm_matches_plain(n, hw, c, groups, fuse_silu):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn((n, hw, c), generator=g, device="cuda") * 2 + 1).to(
        torch.bfloat16)
    p = {"scale": torch.randn(c, generator=g, device="cuda").to(
        torch.bfloat16), "bias": torch.randn(c, generator=g, device="cuda")
        .to(torch.bfloat16)}
    out = t_gn.group_norm_cuda(p, x, groups, 1e-5, fuse_silu)
    torch.cuda.synchronize()
    ref = t_gn.group_norm_reference(p, x.float(), groups, 1e-5, fuse_silu)
    # one bf16 rounding of the output (2^-9 relative) on float32 stats
    assert (out.float() - ref).abs().max().item() <= (
        1e-2 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [((2, 64, 64, 320), 32),
                                          ((2, 8, 8, 2560), 32),
                                          ((1, 7, 9, 30), 3)])
def test_cuda_group_norm_affine_matches_plain(shape, groups):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(shape, generator=g, device="cuda") * 2 + 1).to(
        torch.bfloat16)
    c = shape[-1]
    p = {"scale": torch.randn(c, generator=g, device="cuda"),
         "bias": torch.randn(c, generator=g, device="cuda")}
    a, d = t_gn.group_norm_affine_cuda(p, x, groups, 1e-6)
    torch.cuda.synchronize()
    ra, rd = t_conv.gn_affine_reference(p, x, groups, 1e-6)
    # float32 on both sides, sums in another order
    for ours, ref in ((a, ra), (d, rd)):
        assert (ours - ref).abs().max().item() <= (
            1e-4 * ref.abs().max().item())
