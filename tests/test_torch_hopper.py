"""The static rules of the port's Hopper kernels (K1 flash attention and its
dispatch rule, K2 fused GroupNorm and its statistics mode, K3 fused conv, K4
weight-only-int8 GEMM, K5 W8A8 GEMM), mirrored in Python and tested on the
CPU; ``Context.generate``'s error boundary; the build's hash over the shared
headers; the committed ``wgmma_sm90.cuh`` against its generator. The kernels
themselves run only on the card: the ``cuda`` tests hold them against their
plain versions at the shapes the rules could break (this file imports no
JAX, so they run there: ``python3 -m pytest tests/test_torch_hopper.py -m
cuda``)."""

import contextlib
import dataclasses
import importlib.util
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from sdtpu_torch import Context, ErrorCode, SdtpuError
from sdtpu_torch.config import TINY
from sdtpu_torch.io import safetensors as t_st
from sdtpu_torch.io import weights as t_weights
from sdtpu_torch.ops import _build
from sdtpu_torch.ops import attention as t_attn
from sdtpu_torch.ops import conv as t_conv
from sdtpu_torch.ops import groupnorm as t_gn
from sdtpu_torch.ops import matmul as t_mm

SMS = 132     # an H100 SXM
SMEM_CAP = 227 * 1024     # a block's shared memory on sm_90


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and eager ops on TINY tensors lose far more to oversubscribed threads
    than they gain from them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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
          ptr=0, requires_grad=False):
    """What a dispatch rule reads of a tensor, without a card."""
    return types.SimpleNamespace(
        shape=torch.Size(shape), dtype=dtype, device=torch.device(device),
        is_contiguous=lambda: contiguous, data_ptr=lambda: ptr,
        requires_grad=requires_grad)


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
    # under autograd the backward kernel's contract too: d <= 128
    ("bf16_grad", 320, 8, True),
    ("bf16_grad", 1024, 8, True),      # d = 128
    ("bf16_grad", 512, 1, False),      # d = 512: the plain sdpa, which
    ("cpu_grad", 512, 1, True),        # autograd differentiates
])
def test_flash_rule_is_the_kernel_contract(case, c, heads, want):
    """K1's static rule reads the tensors: the reference's sequence clause,
    then, on a CUDA tensor, what ``flash_attention_cuda`` takes (bf16,
    contiguous, aligned, a head dim it is built for); on a CPU tensor the
    plain version, any floating dtype. Taken by the rule alone, on stand-ins
    for tensors of either device type; under grad, the backward's contract
    too (a head dim of at most 128 on the card)."""
    dtype = torch.float32 if "float32" in case else torch.bfloat16
    device = "cpu" if case.startswith("cpu") else "cuda"
    t = _fake((2, 4096, c), dtype, device, contiguous=case != "strided",
              ptr=8 if case == "unaligned" else 0,
              requires_grad=case.endswith("grad"))
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
                               float=lambda: torch.ones(1),
                               requires_grad=False)
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
    flash_attn_bwd.cu: ``ss`` over its streamed tiles, ``rs_mn`` over its
    padded head dim;
    matmul_int8w.cu: ``ss`` over its column tile; matmul_w8a8.cu: ``ss_s8``
    over its column tile; conv_gn_silu.cu: ``rs`` over its column tile."""
    forms = _generator().FORMS
    plans = [t_attn.plan(d, 4096, 4096, 16, SMS) for d in range(8, 513, 8)]
    bns = {t_mm.plan_int8w(m, 320, n, SMS)["bn"]
           for m in (64, 8192) for n in (320, 640, 130)}
    bwd = [t_attn.plan_bwd(d, 4096, 16) for d in range(8, 129, 8)]
    assert set(forms["ss"]) == ({bkv for _, _, bkv in plans} | bns
                                | {bt for p in bwd for bt in p[2:]})
    assert set(forms["rs_mn"]) == ({dpad if dpad <= 128 else dpad // 2
                                    for dpad, _, _ in plans}
                                   | {p[0] for p in bwd})
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
    (t_attn, "sdtpu_flash_attn_fwd_lse", 5, 8),
    (t_attn, "sdtpu_flash_attn_bwd", 11, 8),
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

    names = ("sdtpu_flash_attn_fwd", "sdtpu_flash_attn_fwd_lse",
             "sdtpu_flash_attn_bwd", "sdtpu_matmul_int8w",
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
                             "sdtpu_flash_attn_fwd_lse": "flash_attn_fwd.cu",
                             "sdtpu_flash_attn_bwd": "flash_attn_bwd.cu",
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
# batched serving: four requests are one UNet eval at N = 8 (each request's
# CFG pair) and one VAE decode at N = 4; every rule at those sites
# ---------------------------------------------------------------------------

BATCH = 4


def _batched(sites, n):
    """The same sites with their batch (the first entry) set to ``n``."""
    return [(n, *site[1:]) for site in sites]


def _transformer_sites(batch):
    """(m, k, n) of the 160 dense sites of one UNet eval's 16 transformer
    blocks for ``batch`` requests (the CFG batch of 2 a request): attn1 q,
    k, v, o and attn2 q, o (c -> c), attn2 k, v (the 77 text rows a sample,
    768 -> c), ff1 (c -> 8c), ff2 (4c -> c). ``quantize="int8"`` routes the
    sites with n >= m to K5 (``layers._w8a8_kernel_ok``)."""
    sites = []
    for rows, c, blocks in ((4096, 320, 5), (1024, 640, 5), (256, 1280, 5),
                            (64, 1280, 1)):
        m = 2 * batch * rows
        for _ in range(blocks):
            sites += [(m, c, c)] * 6 + [(2 * batch * 77, 768, c)] * 2
            sites += [(m, c, 8 * c), (m, 4 * c, c)]
    return sites


FLASH_B4 = [(2 * BATCH, 4096, 320, 8), (2 * BATCH, 1024, 640, 8),
            (BATCH, 4096, 512, 1)]
GNS_B4 = sorted(set(_batched(UNET_GNS, 2 * BATCH) + _batched(VAE_GNS, BATCH)))
UNET_CONVS_B4 = sorted(set(_batched(UNET_CONVS, 2 * BATCH)))
VAE_CONVS_B4 = _batched(VAE_CONVS, BATCH)
K4_SITES_B4 = sorted({(BATCH * m, k, n) for m, k, n in _unet_sites()})
K5_SITES_B4 = sorted({s for s in _transformer_sites(BATCH) if s[2] >= s[0]})


def test_batch_pins_are_the_rules():
    """At N = 8 the K5 routing (n >= m) keeps 35 of the 160 transformer
    sites (85 at N = 2); K4 still takes all 228 sites, of which 44 split K
    (93 at N = 2); of K5's 35, 29 split (74): the smoke run's batch pins."""
    assert sorted(s for s in _transformer_sites(1) if s[2] >= s[0]) == sorted(
        _w8a8_sites())
    k5 = [s for s in _transformer_sites(BATCH) if s[2] >= s[0]]
    assert len(k5) == chip_smoke.MM_W8A8_PER_EVAL_B4 == 35
    assert sum(t_mm.plan_w8a8(*s, SMS)["splits"] > 1 for s in k5) == (
        chip_smoke.MM_W8A8_SUMS_PER_EVAL_B4) == 29
    k4 = [(BATCH * m, k, n) for m, k, n in _unet_sites()]
    assert sum(t_mm.plan_int8w(*s, SMS)["splits"] > 1 for s in k4) == (
        chip_smoke.MM_INT8W_SUMS_PER_EVAL_B4) == 44


@pytest.mark.parametrize("kernel,site", (
    [("flash", s) for s in FLASH_B4] + [("gn", s) for s in GNS_B4]
    + [("conv", s + (q8,)) for s in UNET_CONVS_B4 for q8 in (False, True)]
    + [("conv", s + (False,)) for s in VAE_CONVS_B4]
    + [("int8w", s) for s in K4_SITES_B4]
    + [("w8a8", s) for s in K5_SITES_B4]), ids=str)
def test_rules_take_every_batch_site(kernel, site):
    """Every site of a batch of four through its kernel's static rule, and
    the plan within what the C entry point accepts (its grid's axes, its
    32-bit indexing, the split-K scratch, shared memory)."""
    if kernel == "flash":
        b, sq, c, heads = site
        d = c // heads
        dpad, rows, bkv = t_attn.plan(d, sq, sq, b * heads, SMS)
        assert dpad in t_attn.DPADS and dpad >= d and b * heads <= 65535
        assert rows == (128 if dpad <= 64 else 64)
        assert _flash_smem(dpad, rows, bkv) <= SMEM_CAP
        assert b * sq * c < 2 ** 31
    elif kernel == "gn":
        n, hw, c = site
        p = _check_gn_plan(n, hw, c, 32)
        assert n * 32 <= t_gn.MAX_SAMPLE_GROUPS and hw * c < 2 ** 31
        assert p["grid"][1] <= 65535
    elif kernel == "conv":
        n, h, w, c_in, c_out, ks, int8 = site
        p = _check_conv_plan(n, h, w, c_in, c_out, ks, int8)
        assert n * h * w * max(c_in, c_out) < 2 ** 31
        assert p["splits"] * n * h * w * c_out < 2 ** 31
        assert -(-c_out // 128) <= 65535
    elif kernel == "int8w":
        test_int8w_plan_covers_k_once_and_fills_the_card(*site)
        m, k, n = site
        p = t_mm.plan_int8w(m, k, n, SMS)
        assert p["splits"] * m * n < 2 ** 31 and max(m * k, m * n) < 2 ** 31
    else:
        test_w8a8_plan_covers_k_once_and_fills_the_card(*site)
        m, k, n = site
        assert t_mm.plan_w8a8(m, k, n, SMS)["splits"] * m * n < 2 ** 31


def _check_site(kernel, site):
    """One recorded site (``_recorders``' key) through its kernel's static
    rule, and the plan within what the C entry point accepts: its grid's
    axes, its 32-bit indexing, the split-K scratch, shared memory."""
    if kernel == "flash":
        b, sq, c, heads = site
        d = c // heads
        dpad, rows, bkv = t_attn.plan(d, sq, sq, b * heads, SMS)
        assert dpad in t_attn.DPADS and d <= dpad < 2 * d + 16
        assert rows in (64, 128) and b * heads <= 65535
        assert _flash_smem(dpad, rows, bkv) <= SMEM_CAP
        assert b * sq * c < 2 ** 31 and sq % 128 == 0 and sq >= 512
    elif kernel in ("group_norm", "group_norm_affine"):
        n, hw, c, groups = site[:4]
        p = _check_gn_plan(n, hw, c, groups)
        assert n * groups <= t_gn.MAX_SAMPLE_GROUPS and hw * c < 2 ** 31
        assert p["grid"][1] <= 65535
    elif kernel == "conv":
        n, h, w, c_in, c_out, ks, int8 = site
        p = _check_conv_plan(n, h, w, c_in, c_out, ks, int8)
        assert n * h * w * max(c_in, c_out) < 2 ** 31
        assert p["splits"] * n * h * w * c_out < 2 ** 31
        assert -(-c_out // 128) <= 65535
    elif kernel == "matmul_int8w":
        test_int8w_plan_covers_k_once_and_fills_the_card(*site)
        m, k, n = site
        p = t_mm.plan_int8w(m, k, n, SMS)
        assert p["splits"] * m * n < 2 ** 31
        assert max(m * k, m * n) < 2 ** 31
    else:
        test_w8a8_plan_covers_k_once_and_fills_the_card(*site)
        m, k, n = site
        assert n >= m
        assert t_mm.plan_w8a8(m, k, n, SMS)["splits"] * m * n < 2 ** 31


# ---------------------------------------------------------------------------
# the families (sd21, sd21base, sdxl) at full width: every site the main
# path gives each kernel, recorded from the port's own code on the meta
# device (shapes only, nothing computed), through every rule
# ---------------------------------------------------------------------------

FAMILIES = ("sd21", "sd21base", "sdxl")
# (kernel policy, quantize, KERNEL_W8A8): the smoke run's modes
MODES = {"plain": ("plain", "none", False),
         "cuda": ("cuda", "none", False),
         "cuda_gn": ("cuda_gn", "none", False),
         "cuda_conv": ("cuda_conv", "none", False),
         "int8w": ("cuda_conv", "int8w", False),
         "int8w_dense": ("cuda", "int8w_dense", False),
         "int8+k5": ("cuda", "int8", True),
         "int8w_dense_conv": ("cuda_conv", "int8w_dense", False)}


def _meta_tree(tree, dtype=torch.bfloat16):
    if isinstance(tree, dict):
        return {k: _meta_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def _calibrated(tree):
    """Every W8A8 site with a static activation scale, as ``calibrate``
    leaves it."""
    if isinstance(tree, dict):
        if "w_q" in tree:
            return {**tree, "x_scale": torch.empty((), device="meta")}
        return {k: _calibrated(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_calibrated(v) for v in tree]
    return tree


@contextlib.contextmanager
def _recorders(mode, log, part):
    """The kernel wrappers replaced by recorders that return empty meta
    tensors of the kernel's output shape, appending each call's key to
    ``log[(part[0], kernel)]``, under ``mode``'s flags. Keys: flash and
    flash_bwd (b, sq, c, heads); group_norm (n, hw, c, groups, eps, silu);
    group_norm_affine (n, hw, c, groups); conv (n, h, w, c_in, c_out, k,
    int8); matmul_int8w and matmul_w8a8 (m, k, n)."""
    def put(kernel, key):
        log.setdefault((part[0], kernel), []).append(key)

    def flash(q, k, v, heads, with_lse=False):
        put("flash", (q.shape[0], q.shape[1], q.shape[2], heads))
        if with_lse:
            return torch.empty_like(q), q.new_empty(
                (q.shape[0] * heads, q.shape[1]), dtype=torch.float32)
        return torch.empty_like(q)

    def flash_bwd(q, k, v, out, lse, do, heads):
        put("flash_bwd", (q.shape[0], q.shape[1], q.shape[2], heads))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def gn(p, x, groups, eps, silu):
        put("group_norm", (x.shape[0], x.numel() // (x.shape[0] * x.shape[-1]),
                           x.shape[-1], groups, eps, bool(silu)))
        return torch.empty_like(x)

    def affine(p, x, groups, eps=1e-5):
        if t_gn.uses_kernel(x, groups):
            put("group_norm_affine", (x.shape[0], x.numel() // (
                x.shape[0] * x.shape[-1]), x.shape[-1], groups))
        return t_conv.gn_affine_reference(p, x, groups, eps)

    def conv(x, w, b, *, a=None, d=None, silu=True, w_scale=None):
        put("conv", (*x.shape, w.shape[0], w.shape[-1], w_scale is not None))
        return x.new_empty((*x.shape[:3], w.shape[0]))

    def mm(kernel):
        def run(x, w8, *args):
            put(kernel, (x.numel() // x.shape[-1], *w8.shape))
            return x.new_empty((*x.shape[:-1], w8.shape[1]))
        return run

    conv2d = torch.nn.functional.conv2d

    def channels_last_conv2d(*args, **kwargs):
        # cuDNN gives a channels_last result for a channels_last weight, as
        # every weight of the tree is; the meta device's rule may not (the
        # 1x1 post_quant conv of 4 channels, whose weight is both layouts)
        return conv2d(*args, **kwargs).contiguous(
            memory_format=torch.channels_last)

    mp = pytest.MonkeyPatch()
    mp.setattr(torch.nn.functional, "conv2d", channels_last_conv2d)
    mp.setattr(t_attn, "flash_attention_cuda", flash)
    mp.setattr(t_attn, "flash_attention_bwd_cuda", flash_bwd)
    mp.setattr(t_gn, "group_norm_cuda", gn)
    mp.setattr(t_conv, "gn_affine", affine)
    mp.setattr(t_conv, "fused_conv_cuda", conv)
    mp.setattr(t_mm, "matmul_int8w_cuda", mm("matmul_int8w"))
    mp.setattr(t_mm, "matmul_w8a8_cuda", mm("matmul_w8a8"))
    mp.setattr(t_mm, "KERNEL_W8A8", MODES[mode][2])
    try:
        yield
    finally:
        mp.undo()


_META_UNETS = {}


def _meta_unet(cfg, mode):
    """The configuration's UNet on the meta device, bf16, quantized as
    ``mode`` says (the bf16 tree made once a UNet configuration: the
    quantizers return new trees)."""
    from sdtpu_torch.models import unet
    from sdtpu_torch.quant.ptq import quantize_unet, quantize_weights_only

    if cfg.unet not in _META_UNETS:
        _META_UNETS[cfg.unet] = _meta_tree(unet.init(cfg.unet, None, "meta"))
    params = _META_UNETS[cfg.unet]
    quantize = MODES[mode][1]
    if quantize == "int8":
        params = _calibrated(quantize_unet({"unet": params})["unet"])
    elif quantize.startswith("int8w"):
        params = quantize_weights_only(
            params, include_dense=quantize == "int8w_dense")
    return params


def _run_unet(cfg, mode, n, size):
    """One UNet eval of ``cfg`` at a batch of ``n`` on a ``size``^2 latent
    grid (the input planes the config's UNet takes)."""
    from sdtpu_torch.models import unet

    def meta(*shape):
        return torch.empty(shape, device="meta", dtype=torch.bfloat16)

    unet.apply(_meta_unet(cfg, mode), meta(n, size, size,
                                           cfg.unet.in_channels),
               meta(n, cfg.unet.time_embed_dim),
               meta(n, cfg.clip.context_len, cfg.unet.context_dim),
               cfg.unet, MODES[mode][0])


def _run_vae(cfg, mode, size, encoder=False):
    """One VAE decode of a ``size``^2 latent grid, or one encode of the
    image it decodes to, at batch 1."""
    from sdtpu_torch.models import vae

    policy = MODES[mode][0]
    if encoder:
        img = torch.empty((1, size * cfg.upscale, size * cfg.upscale, 3),
                          device="meta", dtype=torch.bfloat16)
        vae.apply_encoder(_meta_tree(vae.init_encoder(cfg.vae, None, "meta")),
                          img, cfg.vae, policy)
    else:
        z = torch.empty((1, size, size, cfg.latent_channels), device="meta",
                        dtype=torch.bfloat16)
        vae.apply(_meta_tree(vae.init(cfg.vae, None, "meta")), z, cfg.vae,
                  policy)


def _family_log(name, mode):
    """{(part, kernel): [call key, ...]} of one UNet eval (part "unet", the
    CFG batch of 2) and one VAE decode (part "vae", batch 1) of the
    configuration ``name`` at its full width under ``mode`` (keys: see
    ``_recorders``): its ``_part_log``s."""
    return {**_part_log("unet", name, mode), **_part_log("vae", name, mode)}


def _per_image(log, evals, out=None):
    """Launches per image of each counter of ``chip_smoke.KERNEL_NAMES``:
    ``evals`` UNet evals and one VAE decode (added to ``out`` when given);
    the conv kernel's int8 launches and the GEMM kernels' sum passes (split
    K on the card's SMs) as the wrappers count them."""
    out = dict.fromkeys(chip_smoke.KERNEL_NAMES, 0) if out is None else out
    for (part, kernel), keys in log.items():
        times = evals if part == "unet" else 1
        out[kernel] += times * len(keys)
        if kernel == "conv":
            out["conv_int8"] += times * sum(k[-1] for k in keys)
        elif kernel == "matmul_int8w":
            out["matmul_int8w_sum"] += times * sum(
                t_mm.plan_int8w(*k, SMS)["splits"] > 1 for k in keys)
        elif kernel == "matmul_w8a8":
            out["matmul_w8a8_sum"] += times * sum(
                t_mm.plan_w8a8(*k, SMS)["splits"] > 1 for k in keys)
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_family_pins_are_the_rules(name):
    """Each family's launches per image under each mode, from its sites and
    the rules, are the smoke run's pins (``chip_smoke.FAMILY_PINNED``):
    K1 1,401 an SDXL image and 201 an SD 2.x one under every ``cuda*``
    policy (the 576- and 144-token levels take the plain path by the
    reference's sequence clause)."""
    for mode, want in chip_smoke.FAMILY_PINNED[name].items():
        evals = 2 * chip_smoke.STEPS if mode == "heun" else chip_smoke.STEPS
        got = _per_image(_family_log(name, "cuda" if mode == "heun"
                                     else mode), evals)
        assert got == want, (name, mode)
    assert chip_smoke.FAMILY_PINNED["sdxl"]["cuda"]["flash"] == 1401
    assert chip_smoke.FAMILY_PINNED["sd21"]["cuda"]["flash"] == 201


def _family_sites(kernel):
    sites = set()
    for name in FAMILIES:
        for mode in chip_smoke.FAMILY_PINNED[name]:
            if mode == "heun":
                continue
            for (_, k), keys in _family_log(name, mode).items():
                if k == kernel:
                    sites.update(keys)
    return sorted(sites)


@pytest.mark.parametrize("kernel", ["flash", "group_norm",
                                    "group_norm_affine", "conv",
                                    "matmul_int8w", "matmul_w8a8"])
def test_rules_take_every_family_site(kernel):
    """Every site of the three families through its kernel's static rule,
    and the plan within what the C entry point accepts (its grid's axes,
    its 32-bit indexing, the split-K scratch, shared memory). New at these
    widths: head dim 64 with 5-20 heads and 9,216- and 16,384-token
    attentions (K1), 128^2 UNet planes and the 1024^2 VAE (K2, K3), K =
    2,048 and N = 10,240 (K4, K5)."""
    sites = _family_sites(kernel)
    assert sites
    for site in sites:
        _check_site(kernel, site)
        if kernel == "flash":
            b, sq, c, heads = site
            assert c // heads in (64, 512)
            assert t_attn.plan(c // heads, sq, sq, b * heads, SMS)[0] == (
                c // heads)


def test_family_sites_reach_the_new_shapes():
    """The shapes the issue of these families names are among the sites:
    K1 at [20, 4096, 64] and [40, 1024, 64] (SDXL), [10, 9216, 64] (SD2.1
    768) and the VAE's [1, 16384, 512]; K2 and K3 at 128^2 x 320 and the
    1024^2 VAE; K4 and K5 at K = 2,048 and N = 10,240."""
    flash = _family_sites("flash")
    for site in ((2, 4096, 640, 10), (2, 1024, 1280, 20), (2, 9216, 320, 5),
                 (1, 16384, 512, 1)):
        assert site in flash
    assert (2, 16384, 320, 32, 1e-5, True) in _family_sites("group_norm")
    convs = _family_sites("conv")
    assert (2, 128, 128, 320, 320, 3, False) in convs
    assert (1, 1024, 1024, 128, 128, 3, False) in convs
    k4 = _family_sites("matmul_int8w")
    assert (154, 2048, 640) in k4 and (2048, 1280, 10240) in k4
    assert any(k == 2048 for _, k, _ in _family_sites("matmul_w8a8"))


# ---------------------------------------------------------------------------
# image-conditioned serving at full width: the VAE encoder at 512^2 and
# 1024^2, the hires pass's UNet at a 128^2 latent grid and its 1024^2
# decode, InstructPix2Pix's UNet batch of 3 and the concat families' UNets,
# recorded on the meta device as the families' sites are
# ---------------------------------------------------------------------------

_PART_LOGS = {}


def _part_log(kind, name, mode, n=2, size=None):
    """The log (``_recorders``) of one part of an image call: ``kind``
    "unet" (one eval at a batch of ``n``), "vae" (a decode) or "enc" (an
    encode) of the configuration ``name`` on a ``size``^2 latent grid (its
    own by default); the UNet's part is named "unet", the others "vae"."""
    from sdtpu_torch.config import CONFIGS

    key = (kind, name, mode, n, size)
    if key not in _PART_LOGS:
        cfg = CONFIGS[name]
        size = size or cfg.latent_size
        log = {}
        part = ["unet" if kind == "unet" else "vae"]
        with _recorders(mode, log, part):
            if kind == "unet":
                _run_unet(cfg, mode, n, size)
            else:
                _run_vae(cfg, mode, size, encoder=kind == "enc")
        _PART_LOGS[key] = log
    return _PART_LOGS[key]


def _image_call(call, mode):
    """[(log, UNet evals), ...] of the smoke run's image call ``call``
    (``chip_smoke.IMAGE_PINNED``): its UNet's evals, one decode and the
    encodes it makes."""
    steps, evals = chip_smoke.STEPS, chip_smoke.IMAGE_EVALS
    name = {"img2img": "sd15", "inpaint": "sd15", "hires": "sd15"}.get(
        call, call)
    evals = {"img2img": evals, "hires": steps, "sd2_depth":
             chip_smoke.DEPTH_EVALS, "sd21_inpaint": chip_smoke.IMAGE_STEPS_XL,
             "sdxl_inpaint": chip_smoke.IMAGE_STEPS_XL}.get(call, steps)
    n = 3 if call == "sd15_ip2p" else 2
    parts = [(_part_log("unet", name, mode, n), evals)]
    if call == "hires":
        parts += [(_part_log("unet", name, mode, 2, 128),
                   chip_smoke.IMAGE_EVALS),
                  (_part_log("vae", name, mode, size=128), 1)]
    else:
        parts += [(_part_log("vae", name, mode), 1),
                  (_part_log("enc", name, mode), 1)]
    return parts


@pytest.mark.parametrize("call", sorted(chip_smoke.IMAGE_PINNED))
def test_image_pins_are_the_rules(call):
    """Each image call's launches under each mode the smoke run takes, from
    its sites and the rules, are its pins: img2img at strength 0.6 K1 122
    (12 evals x 10, the encoder and the decoder), inpaint 202, the hires fix
    381 (pass 1's 200 without a decode, 12 x 15 and its 1024^2 decode),
    ip2p 202, sd2_depth at strength 0.8 162; under cuda_conv the encoder
    adds 20 K3 launches and 20 of K2's statistics mode."""
    for mode, want in chip_smoke.IMAGE_PINNED[call].items():
        got = dict.fromkeys(chip_smoke.KERNEL_NAMES, 0)
        for log, evals in _image_call(call, mode):
            _per_image(log, evals, got)
        assert got == want, (call, mode)
    pinned = chip_smoke.IMAGE_PINNED
    assert [pinned[c]["cuda"]["flash"] for c in (
        "img2img", "inpaint", "hires", "sd15_ip2p", "sd2_depth")] == [
        122, 202, 381, 202, 162]
    assert pinned["img2img"]["cuda_conv"]["conv"] == 60 * 12 + 28 + 20


def test_encoder_sites():
    """The encoder at 512^2: 20 fused convs (8 down ResBlocks and 2 mid ones
    x 2) each with one launch of the statistics mode under cuda_conv, its
    GroupNorms plain under cuda_gn, and one flash call (its mid block)
    under every policy."""
    conv = _part_log("enc", "sd15", "cuda_conv")
    assert len(conv["vae", "conv"]) == 20
    assert len(conv["vae", "group_norm_affine"]) == 20
    assert conv["vae", "flash"] == [(1, 4096, 512, 1)]
    assert ("vae", "group_norm") not in _part_log("enc", "sd15", "cuda_gn")
    assert sorted(set(k[:6] for k in conv["vae", "conv"])) == [
        (1, 64, 64, 512, 512, 3), (1, 128, 128, 256, 512, 3),
        (1, 128, 128, 512, 512, 3), (1, 256, 256, 128, 256, 3),
        (1, 256, 256, 256, 256, 3), (1, 512, 512, 128, 128, 3)]


POLICY_MODES = ("cuda", "cuda_gn", "cuda_conv")
QUANT_MODES = ("int8w", "int8w_dense", "int8+k5")


def _image_sites(kernel):
    """Every site of ``kernel`` at the new shapes: the encoder at 512^2
    (SD1.5, SD 2.x) and 1024^2 (SDXL) and the hires pass's 1024^2 decode
    under every policy (the VAE is never quantized); the hires pass's UNet
    (SD1.5 at a 128^2 grid) and ip2p's UNet at a batch of 3 under every
    mode. The 9- and 5-channel UNets' kernel sites are their families' own
    (conv_in is a cuDNN conv)."""
    sites = set()
    for mode in POLICY_MODES + QUANT_MODES:
        logs = [_part_log("unet", "sd15", mode, 2, 128),
                _part_log("unet", "sd15_ip2p", mode, 3)]
        if mode in POLICY_MODES:
            logs += [_part_log("enc", "sd15", mode),
                     _part_log("enc", "sdxl", mode),
                     _part_log("vae", "sd15", mode, size=128)]
        for log in logs:
            for (_, k), keys in log.items():
                if k == kernel:
                    sites.update(keys)
    return sorted(sites)


@pytest.mark.parametrize("kernel", ["flash", "group_norm",
                                    "group_norm_affine", "conv",
                                    "matmul_int8w", "matmul_w8a8"])
def test_rules_take_every_image_site(kernel):
    """Every new site through its kernel's static rule, and the plan within
    what the C entry point accepts (its grid's axes, its 32-bit indexing,
    the split-K scratch, shared memory). New: K1 at head dims 40, 80 and
    160 (padded to 48, 80 and 256) over 16,384, 4,096 and 1,024 tokens and
    at 24 batch-heads; K2 and K3 at N = 3, the hires grid's 128^2 planes and
    the encoder's 512^2 .. 64^2 levels; K4 and K5 at M = 3 x 4,096 and
    2 x 16,384."""
    sites = _image_sites(kernel)
    assert sites
    for site in sites:
        _check_site(kernel, site)


def test_image_sites_reach_the_new_shapes():
    """The image paths' new shapes are among the sites, and K1's head dim
    160 pads to 256."""
    flash = _image_sites("flash")
    for site in ((2, 16384, 320, 8), (2, 4096, 640, 8), (2, 1024, 1280, 8),
                 (3, 4096, 320, 8), (3, 1024, 640, 8), (1, 4096, 512, 1),
                 (1, 16384, 512, 1)):
        assert site in flash
    assert t_attn.plan(160, 1024, 1024, 16, SMS)[0] == 256
    assert (3, 4096, 320, 32, 1e-5, True) in _image_sites("group_norm")
    assert (2, 16384, 320, 32, 1e-5, True) in _image_sites("group_norm")
    convs = _image_sites("conv")
    for site in ((1, 512, 512, 128, 128, 3, False),
                 (1, 256, 256, 128, 256, 3, False),
                 (1, 128, 128, 256, 512, 3, False),
                 (2, 128, 128, 320, 320, 3, False),
                 (3, 64, 64, 320, 320, 3, False),
                 (3, 64, 64, 320, 320, 3, True)):
        assert site in convs
    k4 = _image_sites("matmul_int8w")
    assert (12288, 320, 320) in k4 and (32768, 320, 320) in k4
    assert (3 * 77, 768, 320) in k4


# ---------------------------------------------------------------------------
# the Context knobs at full width: each arm of the smoke run's knobs phase
# as the port's own pipeline.generate runs it, on the meta device with the
# kernel wrappers recorded, and the UNet parts whose shapes the knobs change
# under every mode
# ---------------------------------------------------------------------------

_KNOB_LOGS = {}


def _knob_context(ckw):
    """A Context with no weights: the configuration and the knob
    attributes ``Context.__init__`` makes of the arm's keywords."""
    from sdtpu_torch.engine.errors import ErrorTable

    c = Context.__new__(Context)
    c.errors = ErrorTable()
    c.cfg = c._configure("sd15", ckw.get("size"), 1, ckw.get("freeu"),
                         ckw.get("tome_ratio", 0.0), ckw.get("deepcache"),
                         ckw.get("guidance_rescale", 0.0))
    c.cfg_interval = c._check_cfg_interval(ckw.get("cfg_interval"))
    c.pag_layers = tuple(ckw.get("pag_layers", ("mid",)))
    return c


def _knob_log(label):
    """The log (``_recorders``) of one arm of ``chip_smoke.KNOB_ARMS``:
    ``pipeline.generate`` of SD1.5 at ``KNOB_STEPS`` DPM steps, CFG 7.5,
    batch 1, to the decoded image, with the arm's knobs as its Context
    passes them (``_knob_kwargs``), under the arm's mode."""
    from sdtpu_torch.engine import pipeline
    from sdtpu_torch.io.params import fuse_attention_projections, init_tree

    if label not in _KNOB_LOGS:
        ckw, gkw, mode = chip_smoke.KNOB_ARMS[label]
        c = _knob_context(ckw)
        cfg = c.cfg
        params = {name: _meta_tree(init_tree(name, cfg, None, "meta"))
                  for name in ("clip", "temb", "vae")}
        params["unet"] = _meta_unet(cfg, mode)
        if ckw.get("fuse_qkv"):
            params = fuse_attention_projections(params)
        n = cfg.clip.context_len
        s = cfg.latent_size

        def meta(*shape, dtype=torch.bfloat16):
            return torch.empty(shape, device="meta", dtype=dtype)

        log = {}
        with _recorders(mode, log, ["unet"]):
            pipeline.generate(
                params, meta(1, n, dtype=torch.int64),
                meta(n, cfg.unet.context_dim), None, 7.5, cfg=cfg,
                steps=chip_smoke.KNOB_STEPS, use_cfg=True,
                kernels=MODES[mode][0], noise=meta(1, s, s, 4,
                                                   dtype=torch.float32),
                **c._knob_kwargs(gkw.get("pag_scale")))
        _KNOB_LOGS[label] = log
    return _KNOB_LOGS[label]


@pytest.mark.parametrize("label", sorted(chip_smoke.KNOB_ARMS))
def test_knob_pins_are_the_rules(label):
    """Each knob arm's launches per image, from the port's loop and the
    rules, are the smoke run's pins (``chip_smoke.KNOBS_PINNED``)."""
    assert _per_image(_knob_log(label), 1) == chip_smoke.KNOBS_PINNED[label]


def test_knob_pins_are_the_counts_of_the_loop():
    """K1 at 8 steps: 81 an image with no knob, the same under ToMe 0.5
    (2,048 tokens take the kernel), 41 under ToMe 0.3 (2,868 do not),
    161 with PAG at ("mid",), 81 at ("down", "up"), 56 under DeepCache 3
    (3 full evals, 5 shallow ones of 5), and 81 under fuse_qkv (the split
    q, k, v are contiguous)."""
    pinned = {k: v["flash"] for k, v in chip_smoke.KNOBS_PINNED.items()}
    assert (pinned["tome_0.5"], pinned["tome_0.3"], pinned["pag_mid"],
            pinned["pag_down_up"], pinned["deepcache_3"],
            pinned["fuse_qkv"], pinned["size_768"]) == (
        81, 41, 161, 81, 56, 81, 81)


_KNOB_PARTS = {}


def _knob_part(part, mode):
    """The log of one UNet eval whose shapes a knob changes, under
    ``mode``: "tome" (ToMe 0.5 at the CFG batch), "batch1" (the cond rows
    alone, perturbed at the mid block as PAG's eval), "size_768" (the CFG
    batch on a 96^2 grid, and its decode)."""
    from sdtpu_torch.config import SD15

    if (part, mode) not in _KNOB_PARTS:
        cfg = SD15
        n, size, perturb = 2, 64, None
        if part == "tome":
            cfg = dataclasses.replace(SD15, unet=dataclasses.replace(
                SD15.unet, tome_ratio=0.5))
        elif part == "batch1":
            n, perturb = 1, ("mid",)
        else:
            size = 96
        log = {}
        with _recorders(mode, log, ["unet"]):
            def meta(*shape):
                return torch.empty(shape, device="meta", dtype=torch.bfloat16)

            from sdtpu_torch.models import unet

            unet.apply(_meta_unet(cfg, mode), meta(n, size, size, 4),
                       meta(n, cfg.unet.time_embed_dim),
                       meta(n, cfg.clip.context_len, cfg.unet.context_dim),
                       cfg.unet, MODES[mode][0], perturb=perturb)
            if part == "size_768":
                _run_vae(cfg, mode, size)
        _KNOB_PARTS[part, mode] = log
    return _KNOB_PARTS[part, mode]


def _knob_sites(kernel):
    sites = set()
    logs = [_knob_log(label) for label in chip_smoke.KNOB_ARMS]
    logs += [_knob_part(part, mode) for part in ("tome", "batch1", "size_768")
             for mode in POLICY_MODES + QUANT_MODES]
    for log in logs:
        for (_, k), keys in log.items():
            if k == kernel:
                sites.update(keys)
    return sorted(sites)


@pytest.mark.parametrize("kernel", ["flash", "group_norm",
                                    "group_norm_affine", "conv",
                                    "matmul_int8w", "matmul_w8a8"])
def test_rules_take_every_knob_site(kernel):
    """Every site of every knob arm, and of the UNet evals whose shapes the
    knobs change under every mode, through its kernel's static rule, and
    the plan within what the C entry point accepts. New: K1 at 2,048
    merged tokens, at batch 1 and at 9,216 and 2,304 tokens with head dims
    40 and 80; K2 and K3 at N = 1 and 96^2; K4 and K5 at ToMe's M = 4,096
    and batch 1's M."""
    sites = _knob_sites(kernel)
    assert sites
    for site in sites:
        _check_site(kernel, site)


def test_knob_sites_reach_the_new_shapes():
    """The knobs' new shapes are among the sites: K1 at ToMe's [2, 2048,
    320], batch 1's [1, 4096, 320] and [1, 1024, 640], size=768's [2, 9216,
    320], [2, 2304, 640] and its VAE's [1, 9216, 512]; K2 and K3 at N = 1;
    K4 at ToMe's M = 2 x 2,048."""
    flash = _knob_sites("flash")
    for site in ((2, 2048, 320, 8), (1, 4096, 320, 8), (1, 1024, 640, 8),
                 (2, 9216, 320, 8), (2, 2304, 640, 8), (1, 9216, 512, 1)):
        assert site in flash
    assert not any(sq == 2868 for _, sq, _, _ in flash)
    assert (1, 4096, 320, 32, 1e-5, True) in _knob_sites("group_norm")
    assert (1, 64, 64, 320, 320, 3, False) in _knob_sites("conv")
    k4 = _knob_sites("matmul_int8w")
    assert (4096, 320, 320) in k4 and (4096, 320, 960) not in k4


# ---------------------------------------------------------------------------
# the staged configurations at full width: LCM (sd15_lcm, one call and a
# batch of four), the SDXL two-stage call (sdxl stopped at the split, then
# sdxl_refiner) and the x4 upscaler (sd_x4), each call of the smoke run's
# stages phase as its parts recorded on the meta device, and once through
# the port's own pipeline functions
# ---------------------------------------------------------------------------

def _stage_call(stage, mode):
    """[(log, UNet evals), ...] of one call of the stages phase
    (``chip_smoke.STAGE_CALLS``: its configuration, UNet batch and evals,
    and whether it decodes)."""
    name, n, evals, decodes = chip_smoke.STAGE_CALLS[stage]
    parts = [(_part_log("unet", name, mode, n), evals)]
    if decodes:
        parts.append((_part_log("vae", name, mode), 1))
    return parts


@pytest.mark.parametrize("stage", sorted(chip_smoke.STAGES_PINNED))
def test_stage_pins_are_the_rules(stage):
    """Each stage call's launches under each mode the smoke run takes, from
    its sites and the rules, are its pins (``chip_smoke.STAGES_PINNED``):
    K1 41 an LCM call (10 an eval at 4 steps, the decoder's mid block) and
    the same for its batch of four, 560 the SDXL base's 8 steps of 10 (no
    decode), 81 the refiner's 2 (40 an eval: its 256-token mid block takes
    the plain path) and its decode, 1 an upscale (the x4 UNet's attn1 is
    cross-only at 4,096 and 1,024 tokens, its 256-token level and mid block
    take the plain path: the f4 VAE's 16,384-token mid block alone)."""
    for mode, want in chip_smoke.STAGES_PINNED[stage].items():
        got = dict.fromkeys(chip_smoke.KERNEL_NAMES, 0)
        for log, evals in _stage_call(stage, mode):
            _per_image(log, evals, got)
        assert got == want, (stage, mode)
    assert {s: chip_smoke.STAGES_PINNED[s]["cuda"]["flash"]
            for s in chip_smoke.STAGES_PINNED} == {
        "lcm": 41, "lcm_batch": 41, "base": 560, "refine": 81, "x4": 1}


_STAGE_RUNS = {}


def _stage_pipeline_run(stage):
    """(the UNet batch of each eval, the decodes) of the stage call as the
    port's pipeline function runs it on the meta device, the UNet and the
    VAE replaced by recorders: ``generate`` of LCM (guidance embedded, no
    CFG batch; four requests with a guidance each for the batch),
    ``generate(end_step=, output="latent")`` of SDXL, ``refine`` of the
    refiner from the split, ``upscale`` of a 128^2 image."""
    from sdtpu_torch.config import CONFIGS
    from sdtpu_torch.engine import pipeline
    from sdtpu_torch.io.params import init_tree, tree_names
    from sdtpu_torch.models import unet, vae

    if stage not in _STAGE_RUNS:
        name = chip_smoke.STAGE_CALLS[stage][0]
        cfg = CONFIGS[name]
        params = {t: _meta_tree(init_tree(t, cfg, None, "meta"))
                  for t in tree_names(cfg) if t != "vae_enc"}
        b = 4 if stage == "lcm_batch" else 1
        s, L = cfg.latent_size, cfg.clip.context_len

        def meta(*shape, dtype=torch.float32):
            return torch.empty(shape, device="meta", dtype=dtype)

        rows, decodes = [], []

        def unet_apply(p, x, te, ctx, ucfg, kernels="plain", **kw):
            assert te.shape[0] == ctx.shape[0] == x.shape[0]
            rows.append(x.shape[0])
            return x.new_empty((*x.shape[:3], ucfg.out_channels))

        def vae_apply(p, z, vcfg, kernels="plain"):
            decodes.append(z.shape[0])
            f = 2 ** (len(vcfg.channel_mult) - 1)
            return z.new_empty((z.shape[0], z.shape[1] * f, z.shape[2] * f,
                                3))

        tokens = meta(b, L, dtype=torch.int64)
        lat = meta(b, s, s, cfg.latent_channels)
        kw = dict(cfg=cfg, kernels="cuda", noise=lat)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(unet, "apply", unet_apply)
            mp.setattr(vae, "apply", vae_apply)
            uncond = pipeline.encode_text(params, tokens[:1], cfg)[0]
            if stage.startswith("lcm"):
                pipeline.generate(
                    params, tokens, uncond, None, [8.0, 4.0, 1.5, 8.0][:b],
                    sampler="lcm", steps=chip_smoke.LCM_STEPS, use_cfg=False,
                    step_noise=meta(chip_smoke.LCM_STEPS, b, s, s, 4), **kw)
            elif stage == "base":
                pipeline.generate(params, tokens, uncond, None, 7.5,
                                  steps=chip_smoke.STAGE_STEPS,
                                  end_step=chip_smoke.STAGE_SPLIT,
                                  output="latent", **kw)
            elif stage == "refine":
                pipeline.refine(params, tokens, uncond, None, 7.5, lat,
                                steps=chip_smoke.STAGE_STEPS,
                                start_step=chip_smoke.STAGE_SPLIT, **kw)
            else:
                pipeline.upscale(params, tokens, uncond, None, 9.0,
                                 meta(b, s, s, 3), 20,
                                 steps=chip_smoke.STAGE_STEPS,
                                 aug_noise=meta(b, s, s, 3), **kw)
        _STAGE_RUNS[stage] = (rows, decodes)
    return _STAGE_RUNS[stage]


@pytest.mark.parametrize("stage", sorted(chip_smoke.STAGE_CALLS))
def test_stage_calls_are_the_pipelines_loops(stage):
    """The port's pipeline functions run what each stage call's parts say:
    its evals, each on its batch (LCM one row a request, no CFG pair; the
    others the CFG pair), and its decode (none for the base's latent
    output)."""
    _, n, evals, decodes = chip_smoke.STAGE_CALLS[stage]
    rows, decoded = _stage_pipeline_run(stage)
    assert rows == [n] * evals
    assert decoded == ([n if stage == "lcm_batch" else 1] if decodes else [])


def _stage_sites(kernel):
    """Every site of ``kernel`` of the stages: the LCM UNet at N = 1 and 4,
    the refiner's and the x4 upscaler's UNets at the CFG batch of 2 under
    every mode, their decoders (the refiner's is SDXL's) under every
    policy."""
    sites = set()
    for mode in POLICY_MODES + QUANT_MODES:
        logs = [_part_log("unet", "sd15_lcm", mode, 1),
                _part_log("unet", "sd15_lcm", mode, 4),
                _part_log("unet", "sdxl_refiner", mode, 2),
                _part_log("unet", "sd_x4", mode, 2)]
        if mode in POLICY_MODES:
            logs.append(_part_log("vae", "sd_x4", mode))
        for log in logs:
            for (_, k), keys in log.items():
                if k == kernel:
                    sites.update(keys)
    return sorted(sites)


@pytest.mark.parametrize("kernel", ["flash", "group_norm",
                                    "group_norm_affine", "conv",
                                    "matmul_int8w", "matmul_w8a8"])
def test_rules_take_every_stage_site(kernel):
    """Every site of the stages through its kernel's static rule, and the
    plan within what the C entry point accepts (its grid's axes, its
    32-bit indexing, the split-K scratch, shared memory). New: K1 at 24 and
    48 batch-heads of head dim 64 (the refiner) and at N = 4 (LCM's batch);
    K2 at 12 and 8 channels a group (the refiner's 384, x4's 256) on 128^2
    planes; K3 at Cin 384 and 256 over 128^2 planes; K4 and K5 at K = 384
    and 768 (the refiner) and 256 and 512 (x4)."""
    sites = _stage_sites(kernel)
    assert sites
    for site in sites:
        _check_site(kernel, site)


def test_stage_sites_reach_the_new_shapes():
    """The shapes the stages bring are among the sites: K1 at the
    refiner's [2, 4096, 768] / 12 and [2, 1024, 1536] / 24, LCM's [4, 4096,
    320] and the f4 VAE's [1, 16384, 512] (the x4 UNet's cross-only levels
    never reach it); K2 at 12 (384 / 32) and 8 (256 / 32) channels a group
    on 128^2 planes; K3 at [2, 128, 128, 384] -> 384 and [2, 128, 128, 256]
    -> 256; K4 at K = 384 and 768."""
    flash = _stage_sites("flash")
    for site in ((2, 4096, 768, 12), (2, 1024, 1536, 24), (4, 4096, 320, 8),
                 (1, 4096, 320, 8), (1, 16384, 512, 1)):
        assert site in flash
    assert not any(c == 512 and sq == 4096 for _, sq, c, _ in flash)
    gn = _stage_sites("group_norm")
    assert (2, 16384, 384, 32, 1e-5, True) in gn
    assert (2, 16384, 256, 32, 1e-5, True) in gn
    convs = _stage_sites("conv")
    assert (2, 128, 128, 384, 384, 3, False) in convs
    assert (2, 128, 128, 256, 256, 3, False) in convs
    k4 = {k for _, k, _ in _stage_sites("matmul_int8w")}
    assert {384, 768, 256, 512} <= k4


# ---------------------------------------------------------------------------
# per-request adapters at full width: each arm of the smoke run's adapters
# phase (a ControlNet, two, a LoRA over the attention, feed-forward and
# proj_in/proj_out sites) as the port's own loop runs it on the meta device
# ---------------------------------------------------------------------------

_ADAPTER_LOGS = {}


def _meta_lora(cfg, params, locon=False):
    """The smoke run's LoRA (``chip_smoke.lora_site``'s sites, its LoCon's
    with ``locon``) as an overlay of meta tensors over ``params``' towers,
    read by the port's kohya loader from a file's tensors of the right
    shapes."""
    from sdtpu_torch.io import kohya

    r = chip_smoke.ADAPTER_RANK
    flat, seen = {}, set()
    for name, (path, kind) in sorted(kohya.site_map(cfg).items()):
        if not chip_smoke.lora_site(name, locon) or path in seen:
            continue
        seen.add(path)
        node = params
        for k in path:
            node = node[k]
        w = node["w"] if "w" in node else node.get("w8", node.get("w_q"))
        if kind == "linear":
            d_in, d_out = w.shape
            down, up = (r, d_in), (d_out, r)
        else:
            d_out, d_in, kh, kw = w.shape
            down, up = (r, d_in, kh, kw), (d_out, r, 1, 1)
        flat[name + ".lora_down.weight"] = torch.empty(down, device="meta")
        flat[name + ".lora_up.weight"] = torch.empty(up, device="meta")
        flat[name + ".alpha"] = torch.tensor(float(r))

    def meta(node):
        if isinstance(node, dict):
            return {k: meta(v) for k, v in node.items()}
        if isinstance(node, list):
            return [meta(v) for v in node]
        return node.to("meta")

    return meta(kohya.load_lora_kohya(flat, cfg))


def _adapter_arm(arm):
    """(configuration name, mode, adapter kind, steps) of an arm of
    ``chip_smoke.ADAPTER_ARMS`` or "cn_sdxl"."""
    if arm == "cn_sdxl":
        return "sdxl", "cuda", "cn", chip_smoke.ADAPTER_XL_STEPS
    return ("sd15", *chip_smoke.ADAPTER_ARMS[arm], chip_smoke.ADAPTER_STEPS)


def _adapter_log(arm):
    """The log (``_recorders``) of one arm (``_adapter_arm``):
    ``pipeline.generate`` of one step at the arm's configuration, CFG 7.5,
    batch 1, to the latents (part "unet": the hints' embedding, then every
    eval of a step: the ControlNets' copies and the UNet), with the arm's
    ControlNets (random trees on the meta device, the hints at the image
    size) or its LoRA overlaid as ``Context._params_for`` overlays it,
    under the arm's mode; and its decode (part "vae"). A DPM step is one
    eval, so the arm's steps are that step's launches times its steps
    (``_per_image``)."""
    from sdtpu_torch.config import CONFIGS
    from sdtpu_torch.engine import pipeline
    from sdtpu_torch.io.params import init_tree, tree_names
    from sdtpu_torch.models import controlnet
    from sdtpu_torch.train.lora import apply_lora

    if arm not in _ADAPTER_LOGS:
        name, mode, kind, _ = _adapter_arm(arm)
        cfg = CONFIGS[name]
        params = {t: _meta_tree(init_tree(t, cfg, None, "meta"))
                  for t in tree_names(cfg) if t not in ("unet", "vae_enc")}
        params["unet"] = _meta_unet(cfg, mode)
        n_cn = {"cn": 1, "cn0": 1, "cn2": 2}.get(kind, 0)
        if n_cn:
            trees = tuple(_meta_tree(controlnet.init(cfg.unet, None, "meta"))
                          for _ in range(n_cn))
            params["controlnet"] = trees[0] if n_cn == 1 else trees
        if kind in ("kohya", "npz", "locon"):
            overlay = _meta_lora(cfg, params, kind == "locon")
            if kind == "npz":
                overlay = {"unet": overlay["unet"]}
            params = {**params, **{t: apply_lora(params[t], o)
                                   for t, o in overlay.items()}}
        n, s = cfg.clip.context_len, cfg.latent_size
        size = cfg.image_size

        def meta(*shape, dtype=torch.bfloat16):
            return torch.empty(shape, device="meta", dtype=dtype)

        kw = {}
        if n_cn:
            kw = dict(hint=meta(*(((2,) if n_cn == 2 else ()) + (
                1, size, size, 3)), dtype=torch.float32),
                control_scale={"cn": 1.0, "cn0": 0.0,
                               "cn2": [1.0, 0.5]}[kind])
        log = {}
        with _recorders(mode, log, ["unet"]):
            pipeline.generate(
                params, meta(1, n, dtype=torch.int64),
                meta(n + (1 if cfg.clip2 is not None else 0),
                     cfg.unet.context_dim), None, 7.5, cfg=cfg,
                steps=1, use_cfg=True, kernels=MODES[mode][0],
                noise=meta(1, s, s, 4, dtype=torch.float32),
                output="latent", **kw)
        # the hints are embedded once a call, by cuDNN convs: no kernel
        _ADAPTER_LOGS[arm] = {**log, **_part_log("vae", name, mode)}
    return _ADAPTER_LOGS[arm]


@pytest.mark.parametrize("arm", sorted(chip_smoke.ADAPTER_PINNED))
def test_adapter_pins_are_the_rules(arm):
    """Each adapter arm's launches per image, from the port's loop and the
    rules, are the smoke run's pins (``chip_smoke.ADAPTER_PINNED``)."""
    assert _per_image(_adapter_log(arm), _adapter_arm(arm)[3]) == (
        chip_smoke.ADAPTER_PINNED[arm])


def _adapter_sites(kernel):
    sites = set()
    for arm in chip_smoke.ADAPTER_PINNED:
        for (_, k), keys in _adapter_log(arm).items():
            if k == kernel:
                sites.update(keys)
    return sorted(sites)


@pytest.mark.parametrize("kernel", ["flash", "group_norm",
                                    "group_norm_affine", "conv",
                                    "matmul_int8w", "matmul_w8a8"])
def test_rules_take_every_adapter_site(kernel):
    """Every site of every adapter arm through its kernel's static rule,
    and the plan within what the C entry point accepts (its grid's axes,
    its 32-bit indexing, the split-K scratch, shared memory): the
    ControlNet copy's at SD1.5's and SDXL's widths, the LoRA'd UNet's.
    And the adapter rule: an adapted conv keeps K3 and launches it a
    second time for its delta's down conv (Cout the rank) on the same
    input, the LoRA's 16 proj_in (1x1) and the LoCon's every ResBlock conv
    (3x3) too; the statistics mode runs once a site."""
    sites = _adapter_sites(kernel)
    assert sites
    for site in sites:
        _check_site(kernel, site)
    if kernel == "conv":
        r = chip_smoke.ADAPTER_RANK
        for arm, adapted in (("cn_cuda_conv", {}),
                             ("kohya_cuda_conv", {1: 16}),
                             ("locon_cuda_conv", {1: 16, 3: 44})):
            log = _adapter_log(arm)
            convs = log[("unet", "conv")]
            base = [k for k in convs if k[4] != r]
            downs = [k for k in convs if k[4] == r]
            assert sum(k[5] == 1 for k in base) == 16 + (7 if arm[0] == "c"
                                                         else 0)
            assert {ks: sum(k[5] == ks for k in downs)
                    for ks in adapted} == adapted
            assert {k[:4] for k in downs} <= {k[:4] for k in base}
            assert len(log[("unet", "group_norm_affine")]) == len(base)


# ---------------------------------------------------------------------------
# serving: the HTTP service's batch of four, the stream pool's ticks and
# batched decodes, the CLI and the C API (one image each), at SD1.5's full
# width: every site through the rules, the smoke run's pins from them
# ---------------------------------------------------------------------------

_VAE_LOGS = {}


def _vae_log(name, mode, batch):
    """The log (``_recorders``, part "vae") of one VAE decode of ``batch``
    latents of the configuration ``name`` under ``mode``."""
    from sdtpu_torch.config import CONFIGS
    from sdtpu_torch.models import vae

    key = (name, mode, batch)
    if key not in _VAE_LOGS:
        cfg = CONFIGS[name]
        s = cfg.latent_size
        z = torch.empty((batch, s, s, cfg.latent_channels), device="meta",
                        dtype=torch.bfloat16)
        log = {}
        with _recorders(mode, log, ["vae"]):
            vae.apply(_meta_tree(vae.init(cfg.vae, None, "meta")), z,
                      cfg.vae, MODES[mode][0])
        _VAE_LOGS[key] = log
    return _VAE_LOGS[key]


def test_serving_stream_is_the_planned_schedule(monkeypatch):
    """The smoke run's stream arm (``chip_smoke.run_stream``) through the
    port's pool at TINY on the CPU, the prompts cut to TINY's window (the
    schedule is the host's, whatever the width): one UNet eval a tick at
    N = 2 x slots, ``STREAM_TICKS`` ticks and the decode batches of
    ``STREAM_DECODES``; each image is ``generate``'s at its step count
    within one level. The img2img arm's evals are the Context's rule."""
    from sdtpu_torch.engine import stream
    from sdtpu_torch.models import unet

    evals, decodes = [], []
    apply, decode = unet.apply, stream.decode_latents

    def apply_rec(params, x, *args, **kwargs):
        evals.append(x.shape[0])
        return apply(params, x, *args, **kwargs)

    def decode_rec(params, x, *args):
        decodes.append(x.shape[0])
        return decode(params, x, *args)

    monkeypatch.setattr(unet, "apply", apply_rec)
    monkeypatch.setattr(stream, "decode_latents", decode_rec)
    monkeypatch.setattr(chip_smoke, "STREAM_REQUESTS", [
        ("a fox", *r[1:]) for r in chip_smoke.STREAM_REQUESTS])
    ctx = Context(config="tiny", steps=chip_smoke.SERVING_STEPS,
                  device="cpu")
    images, _, _, done, sched, _ = chip_smoke.run_stream(ctx)
    monkeypatch.undo()
    slots = chip_smoke.SERVING_SLOTS
    assert evals == [2 * slots] * chip_smoke.STREAM_TICKS == (
        [2 * slots] * sched.ticks)
    assert tuple(decodes) == tuple(done) == chip_smoke.STREAM_DECODES
    assert sched.decodes == len(chip_smoke.STREAM_DECODES)
    for j, (_, steps, seed, g, _) in enumerate(chip_smoke.STREAM_REQUESTS):
        ctx.set_steps(steps)
        want = ctx.generate("a fox", guidance=g, seed=seed)
        assert np.abs(images[j].astype(int) - want.astype(int)).max() <= 1
    steps = chip_smoke.SERVING_STEPS
    start = Context._start_step(types.SimpleNamespace(steps=steps),
                                chip_smoke.SERVING_STRENGTH)
    assert chip_smoke.SERVING_IMG2IMG_EVALS == steps - start == 5


def _serving_parts(arm):
    """[(log, UNet evals), ...] of a serving arm of
    ``chip_smoke.SERVING_PINNED``: a batch of four's UNet at N = 8 and its
    decode at 4; the img2img call's evals, decode and encode; the pool's
    ticks at N = 2 x slots and its decodes; one image's (CLI, C API)."""
    cs = chip_smoke
    name, steps = cs.SERVING_CONFIG, cs.SERVING_STEPS
    mode = "cuda_conv" if arm == "batch_cuda_conv" else "cuda"
    if arm.startswith("batch"):
        n = len(cs.SERVING_REQUESTS)
        return [(_part_log("unet", name, mode, 2 * n), steps),
                (_vae_log(name, mode, n), 1)]
    if arm == "img2img":
        return [(_part_log("unet", name, mode), cs.SERVING_IMG2IMG_EVALS),
                (_part_log("vae", name, mode), 1),
                (_part_log("enc", name, mode), 1)]
    if arm == "stream":
        return ([(_part_log("unet", name, mode, 2 * cs.SERVING_SLOTS),
                  cs.STREAM_TICKS)]
                + [(_vae_log(name, mode, k), 1) for k in cs.STREAM_DECODES])
    return [(_part_log("unet", name, mode), steps),
            (_part_log("vae", name, mode), 1)]


@pytest.mark.parametrize("arm", sorted(chip_smoke.SERVING_PINNED))
def test_serving_pins_are_the_rules(arm):
    """Each serving arm's launches, from its sites and the rules, are the
    smoke run's pins (``chip_smoke.SERVING_PINNED``): K1 81 an image at 8
    steps (a batch of four too), 52 for img2img at 0.6, 123 for the
    pool's 12 ticks and 3 decodes; under ``cuda_conv`` K3 and K2's
    statistics mode 508 a batch."""
    got = dict.fromkeys(chip_smoke.KERNEL_NAMES, 0)
    for log, evals in _serving_parts(arm):
        _per_image(log, evals, got)
    assert got == chip_smoke.SERVING_PINNED[arm]
    assert [chip_smoke.SERVING_PINNED[a]["flash"] for a in (
        "batch_cuda", "img2img", "stream", "cli", "capi")] == [
        81, 52, 123, 81, 81]


def _serving_sites(kernel):
    """Every site of ``kernel`` the serving paths can give: the pool's UNet
    at 1 to 4 slots (N = 2 to 8; the micro-batcher's batches of 1 to 4 are
    the same evals) under every mode, and the decodes of 1 to 4 finishing
    slots under every policy (the VAE is never quantized)."""
    sites = set()
    logs = [_part_log("unet", "sd15", mode, 2 * slots)
            for slots in range(1, 5) for mode in POLICY_MODES + QUANT_MODES]
    logs += [_vae_log("sd15", mode, k) for k in range(1, 5)
             for mode in POLICY_MODES]
    for log in logs:
        for (_, k), keys in log.items():
            if k == kernel:
                sites.update(keys)
    return sorted(sites)


@pytest.mark.parametrize("kernel", ["flash", "group_norm",
                                    "group_norm_affine", "conv",
                                    "matmul_int8w", "matmul_w8a8"])
def test_rules_take_every_serving_site(kernel):
    """Every serving site through its kernel's static rule, and the plan
    within what the C entry point accepts (its grid's axes, its 32-bit
    indexing, the split-K scratch, shared memory); K1 takes the pool's
    self-attentions at every slot count and every decode batch."""
    sites = _serving_sites(kernel)
    assert sites
    for site in sites:
        _check_site(kernel, site)
    if kernel == "flash":
        assert {(2 * n, 4096, 320, 8) for n in range(1, 5)} | {
            (2 * n, 1024, 640, 8) for n in range(1, 5)} | {
            (k, 4096, 512, 1) for k in range(1, 5)} <= set(sites)


# ---------------------------------------------------------------------------
# training: one SD1.5 train step at 512^2, batch 2, forward and backward,
# recorded on the meta device through the port's own ldm_loss with every
# kernel wrapper (K1-bwd's too) replaced by a recorder
# ---------------------------------------------------------------------------

_TRAIN_LOGS = {}


def _train_log(arm):
    """{(part, kernel): [call key, ...]} of one train step's loss and its
    gradients of ``chip_smoke.TRAIN_CONFIG`` at its full width under
    ``kernels="cuda"``: ``arm`` "cuda", "cuda_remat" or "cuda_images" (the
    images path: the encoder inside the loss)."""
    if arm not in _TRAIN_LOGS:
        from sdtpu_torch.config import CONFIGS
        from sdtpu_torch.models import clip, temb, vae
        from sdtpu_torch.train import step as T

        cfg = CONFIGS[chip_smoke.TRAIN_CONFIG]
        meta = torch.device("meta")
        if "masters" not in _TRAIN_LOGS:
            # float32 masters: the serving tests' bf16 meta UNet, cast
            masters = _meta_tree(_meta_unet(cfg, "cuda"), torch.float32)
            for _, p in T.leaves(masters):
                p.requires_grad_(True)
            _TRAIN_LOGS["masters"] = masters
            _TRAIN_LOGS["frozen"] = {
                "clip": _meta_tree(clip.init(cfg.clip, None, meta)),
                "temb": _meta_tree(temb.init(cfg.unet, None, meta)),
                "vae_enc": _meta_tree(vae.init_encoder(cfg.vae, None,
                                                       meta))}
        masters = _TRAIN_LOGS["masters"]
        b, s = chip_smoke.TRAIN_BATCH, cfg.latent_size
        lat = (b, s, s, cfg.latent_channels)
        batch = {"tokens": torch.empty((b, cfg.clip.context_len),
                                       dtype=torch.int32, device=meta)}
        if arm == "cuda_images":
            batch["images"] = torch.empty((b, cfg.image_size,
                                           cfg.image_size, 3), device=meta)
        else:
            batch["latents"] = torch.empty(lat, device=meta)
        draws = {"t": torch.empty((b,), dtype=torch.int64, device=meta),
                 "eps": torch.empty(lat, device=meta),
                 "posterior": torch.empty(lat, device=meta)}
        log = {}
        with _recorders("cuda", log, ("unet",)):
            loss = T.ldm_loss(masters, _TRAIN_LOGS["frozen"], batch, None,
                              cfg, "cuda", arm == "cuda_remat", draws=draws)
            torch.autograd.grad(loss, [p for _, p in T.leaves(masters)])
        _TRAIN_LOGS[arm] = log
    return _TRAIN_LOGS[arm]


@pytest.mark.parametrize("arm", ["cuda", "cuda_remat", "cuda_images"])
def test_train_pins_are_the_rules(arm):
    """A train step's launches, from the recording, are the smoke run's
    pins (``chip_smoke.TRAIN_PINNED``): K1 10 forward and 10 backward
    calls a step (the 64x64 and 32x32 self-attentions), 20 forward with
    remat, one more forward (the encoder's mid block, no backward) on the
    images path; the plain policy launches none."""
    got = dict.fromkeys(chip_smoke.KERNEL_NAMES + ("flash_bwd",), 0)
    for (_, kernel), keys in _train_log(arm).items():
        got[kernel] += len(keys)
    assert got == chip_smoke.TRAIN_PINNED[arm]
    assert chip_smoke.TRAIN_PINNED["cuda"]["flash_bwd"] == 10
    for plain in ("plain", "plain_remat"):
        assert not any(chip_smoke.TRAIN_PINNED[plain].values())


def _bwd_smem(dpad, rows, bt):
    """Shared memory of a K1-bwd kernel: 1 KB of alignment slack, the
    block's own two tiles of ``rows`` rows, a ring of two streamed tiles of
    ``bt`` rows (three stages where a row is one column block of 64, else
    two) and each stage's lse2 and D (read by the dk/dv kernel only), each
    tile in column blocks of 64 bf16 (128-byte rows)."""
    ch = -(-dpad // 64)
    stages = 3 if ch == 1 else 2
    return (1024 + 2 * ch * rows * 128 + stages * 2 * ch * bt * 128
            + stages * 2 * bt * 4)


def _bwd_want(d):
    """K1-bwd's rule as the C entry point writes it."""
    want = (d + 15) // 16 * 16 if d <= 80 else 128
    return (want, 128 if want <= 48 else 64,
            32 if want <= 48 or want == 128 else 64,
            32 if want == 128 else 64)


@pytest.mark.parametrize("d", range(8, 129, 8))
def test_flash_bwd_plan_covers_every_head_dim(d):
    """K1-bwd's rule at every head dim of its contract: the least padded
    dim that holds d, blocks of two warpgroups (128 rows) up to dpad 48 and
    one above, streamed tiles of 32 rows for dk/dv up to dpad 48 and for
    both kernels at 128, 64 else; an instantiation in the C entry point's
    switch, which computes the same rule and refuses any other plan; the
    blocks an SM must hold fit its shared memory."""
    dpad, rows, bkv, bq = t_attn.plan_bwd(d, 4096, 16)
    assert dpad == min(p for p in t_attn.BWD_DPADS if p >= d)
    assert (dpad, rows, bkv, bq) == _bwd_want(d)
    src = (_build.SRC_DIR / "flash_attn_bwd.cu").read_text()
    minb = 2 if rows == 128 else 1
    assert (f"case {dpad}: return (int)launch<{dpad}, {rows // 64}, {bkv}, "
            f"{bq}, {minb}>(a, st);" in src)
    assert "const int want = d <= 80 ? (d + 15) / 16 * 16 : 128;" in src
    assert "rows != (want <= 48 ? 128 : 64)" in src
    assert "bkv != (want <= 48 || want == 128 ? 32 : 64)" in src
    assert "bq != (want == 128 ? 32 : 64)" in src
    assert f"constexpr int SPAD = {t_attn.BWD_SPAD};" in src
    assert t_attn.BWD_SPAD % bkv == 0 and t_attn.BWD_SPAD % bq == 0
    for bt in (bkv, bq):
        assert _bwd_smem(dpad, rows, bt) * minb <= SMEM_CAP


def _check_bwd_site(b, s, c, heads):
    """One self-attention site under grad through K1-bwd's rule and the
    forward's statistics instantiation: the plan within what the C entry
    points accept (both kernels' grids, 32-bit indexing, the padded scratch
    rows every streamed tile's statistics read, shared memory)."""
    d = c // heads
    dpad, rows, bkv, bq = t_attn.plan_bwd(d, s, b * heads)
    assert dpad in t_attn.BWD_DPADS and d <= dpad < 2 * d + 16
    assert (dpad, rows, bkv, bq) == _bwd_want(d)
    assert max(_bwd_smem(dpad, rows, bt) for bt in (bkv, bq)) <= SMEM_CAP
    spad = -(-s // t_attn.BWD_SPAD) * t_attn.BWD_SPAD
    assert -(-s // bkv) * bkv <= spad <= -(-s // rows) * rows
    assert b * heads <= 65535 and b * s * c < 2 ** 31
    assert b * heads * spad < 2 ** 31
    fdpad, frows, fbkv = t_attn.plan(d, s, s, b * heads, SMS)
    assert fdpad <= 128 and fbkv == 64     # the statistics' instantiations


def _emulate_bwd(q, k, v, do, heads):
    """K1-bwd's design replayed with its arithmetic on [B, S, C] float32
    tensors (bf16 values): the forward's output rounded to bf16 and its
    log-sum-exp; the pre-pass's D = rowsum(do * o) and lse2 = lse log2(e),
    padded with +inf and 0 to ``BWD_SPAD``; head dims zero-padded to
    ``dpad``; dk/dv blocks of ``rows`` keys streaming query tiles of ``bkv``
    (P^T = exp2(S^T scale log2(e) - lse2), rounded to bf16 for dv, dS^T =
    P^T (dP^T - D) rounded to bf16 for dk) and dq blocks of ``rows``
    queries streaming key tiles of ``bq`` (the last tile's keys past the
    sequence masked), each product's sum in float32; outputs scaled and
    rounded to bf16 as the kernels store them."""
    b, s, c = q.shape
    d = c // heads
    dpad, rows, bkv, bq = t_attn.plan_bwd(d, s, b * heads)
    scale = 1.0 / math.sqrt(d)
    c2 = math.log2(math.e) * scale
    bf = torch.bfloat16

    def split(x):
        x = x.reshape(b, s, heads, d).transpose(1, 2).reshape(b * heads, s, d)
        return torch.nn.functional.pad(x, (0, dpad - d))

    qh, kh, vh, doh = (split(t) for t in (q, k, v, do))
    logits = torch.einsum("bqd,bkd->bqk", qh, kh) * scale
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.softmax(logits, dim=-1).to(bf).float()
    o = torch.einsum("bqk,bkd->bqd", p, vh).to(bf).float()
    spad = -(-s // t_attn.BWD_SPAD) * t_attn.BWD_SPAD
    lse2 = torch.full((b * heads, spad), math.inf)
    lse2[:, :s] = lse * math.log2(math.e)
    delta = torch.zeros((b * heads, spad))
    delta[:, :s] = (doh * o).sum(-1)

    def rows_of(x, r0, n):
        out = torch.zeros((x.shape[0], n, dpad))
        part = x[:, r0:r0 + n]
        out[:, :part.shape[1]] = part
        return out

    dq, dk, dv = (torch.zeros_like(qh) for _ in range(3))
    for r0 in range(0, s, rows):
        kb, vb = rows_of(kh, r0, rows), rows_of(vh, r0, rows)
        acc_k, acc_v = torch.zeros_like(kb), torch.zeros_like(vb)
        for t0 in range(0, s, bkv):
            qt, ot = rows_of(qh, t0, bkv), rows_of(doh, t0, bkv)
            lt, dt = lse2[:, None, t0:t0 + bkv], delta[:, None, t0:t0 + bkv]
            pt = torch.exp2(torch.einsum("bkd,bqd->bkq", kb, qt) * c2 - lt)
            acc_v += torch.einsum("bkq,bqd->bkd", pt.to(bf).float(), ot)
            dst = pt * (torch.einsum("bkd,bqd->bkq", vb, ot) - dt)
            acc_k += torch.einsum("bkq,bqd->bkd", dst.to(bf).float(), qt)
        n = min(rows, s - r0)
        dk[:, r0:r0 + n], dv[:, r0:r0 + n] = acc_k[:, :n] * scale, acc_v[:, :n]
        qb, ob = rows_of(qh, r0, rows), rows_of(doh, r0, rows)
        lr = lse2[:, r0:r0 + rows, None]
        dr = delta[:, r0:r0 + rows, None]
        if lr.shape[1] < rows:
            lr = torch.cat([lr, torch.full((lr.shape[0], rows - lr.shape[1],
                                            1), math.inf)], 1)
            dr = torch.cat([dr, torch.zeros((dr.shape[0], rows - dr.shape[1],
                                             1))], 1)
        acc = torch.zeros_like(qb)
        for t0 in range(0, s, bq):
            kt, vt = rows_of(kh, t0, bq), rows_of(vh, t0, bq)
            pt = torch.exp2(torch.einsum("bqd,bkd->bqk", qb, kt) * c2 - lr)
            pt[:, :, max(0, s - t0):] = 0.0
            ds = pt * (torch.einsum("bqd,bkd->bqk", ob, vt) - dr)
            acc += torch.einsum("bqk,bkd->bqd", ds.to(bf).float(), kt)
        dq[:, r0:r0 + n] = acc[:, :n] * scale

    def merge(x):
        return (x[..., :d].reshape(b, heads, s, d).transpose(1, 2)
                .reshape(b, s, c).to(bf))

    return merge(dq), merge(dk), merge(dv)


@pytest.mark.parametrize("b,s,c,heads", [
    (1, 200, 16, 2), (1, 200, 80, 2), (2, 130, 160, 2), (1, 77, 96, 1),
    (1, 129, 128, 1), (1, 256, 128, 2)])
def test_flash_bwd_design_replayed_matches_plain(b, s, c, heads):
    """K1-bwd's tiling, padding, masking and bf16 roundings, replayed on the
    CPU at a small size (``_emulate_bwd``; d = 8, 40, 80, 96, 128, 64 at
    sequences no tile divides and one that tiles exactly): dq, dk and dv
    within ``chip_smoke.KERNEL_TOL`` of the plain version's max-abs, as the
    card is held; two runs give the same bits."""
    rng = np.random.default_rng(16)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, s, c))
                                    .astype(np.float32))
                   .to(torch.bfloat16).float() for _ in range(4))
    got = _emulate_bwd(q, k, v, do, heads)
    refs = t_attn.flash_attention_bwd_reference(q, k, v, do, heads)
    for x, y, r in zip(got, _emulate_bwd(q, k, v, do, heads), refs):
        assert torch.equal(x, y)
        assert torch.isfinite(x.float()).all()
        assert (x.float() - r).abs().max().item() <= (
            chip_smoke.KERNEL_TOL * r.abs().max().item())


def test_flash_bwd_products_are_wgmma():
    """K1-bwd's products are wgmma through the generated wrappers: ``ss``
    over the streamed tile (S and dP, in each kernel, through one helper)
    and three ``rs_mn`` over the padded head dim (dv, dk, dq); no
    mma.sync."""
    src = (_build.SRC_DIR / "flash_attn_bwd.cu").read_text()
    assert src.count("Wgmma<BT>::ss(") == 1
    assert src.count("product_s<DPAD, BT, ROWS>(") == 4
    assert src.count("Wgmma<DPAD>::rs_mn(") == 3
    assert "mma.sync" not in src and "ldmatrix" not in src
    assert '#include "wgmma_sm90.cuh"' in src
    assert "flash_attn_bwd.cu" in chip_smoke.WGMMA_SOURCES


def test_rules_take_every_train_site():
    """K1-bwd's static rule at every self-attention that takes the kernel
    in a train step of SD1.5 (recorded), and of SD 2.1 and SDXL (their
    UNets' kernel sites at batch 2 and full width: head dim 64 everywhere,
    so under grad each takes the kernel as in inference)."""
    sites = {key for arm in ("cuda", "cuda_remat")
             for (_, kernel), keys in _train_log(arm).items()
             if kernel == "flash_bwd" for key in keys}
    assert sites == {(2, 4096, 320, 8), (2, 1024, 640, 8)}
    for name in ("sd21", "sdxl"):
        fam = {key for key in _part_log("unet", name, "cuda").get(
            ("unet", "flash"), [])}
        assert fam and all(c // h <= t_attn.BWD_MAX_HEAD_DIM
                           for _, _, c, h in fam)
        sites |= fam
    for site in sorted(sites):
        _check_bwd_site(*site)
    for b, s, c, heads in chip_smoke.TRAIN_SITES + chip_smoke.TRAIN_RAGGED:
        _check_bwd_site(b, s, c, heads)


def _grad_guard_calls():
    """Each K2-K5 wrapper with one argument that requires grad."""
    x = torch.zeros((1, 4, 4, 8), requires_grad=True)
    p = {"scale": torch.ones(8), "bias": torch.zeros(8)}
    w8 = torch.zeros((8, 8), dtype=torch.int8)
    return {
        "group_norm": lambda: t_gn.group_norm_cuda(p, x, 2),
        "group_norm_affine": lambda: t_gn.group_norm_affine_cuda(p, x, 2),
        "conv": lambda: t_conv.fused_conv_cuda(
            x, torch.zeros((8, 8, 3, 3)), torch.zeros(8)),
        "matmul_int8w": lambda: t_mm.matmul_int8w_cuda(
            x.reshape(16, 8), w8, torch.ones(8)),
        "matmul_w8a8": lambda: t_mm.matmul_w8a8_cuda(
            x.reshape(16, 8), w8, torch.ones(8), torch.ones(())),
    }


@pytest.mark.parametrize("kernel", sorted(_grad_guard_calls()))
def test_kernels_without_a_backward_refuse_grad(kernel):
    """K2-K5 launch through ctypes and have no backward: on a tensor that
    requires grad each wrapper raises ``NoBackwardError`` before anything
    else (it would cut the graph); under ``no_grad`` the guard lets the
    call through to the wrapper's own checks."""
    call = _grad_guard_calls()[kernel]
    with pytest.raises(_build.NoBackwardError, match="no backward"):
        call()
    with torch.no_grad(), pytest.raises(ValueError):
        call()      # a CPU tensor: the wrapper's own refusal


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
@pytest.mark.parametrize("b,sq,c,heads", [
    (6, 4096, 320, 8), (6, 1024, 640, 8),     # the pool at 3 slots
    (2, 4096, 512, 1), (3, 4096, 512, 1),     # batched decodes of 2, 3
])
def test_cuda_flash_at_the_serving_shapes(b, sq, c, heads):
    """K1 at the serving shapes no other case takes, against its plain
    version with the kernel's tolerance (relative to the output's largest
    value)."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((b, sq, c), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out = t_attn.flash_attention_cuda(q, k, v, heads)
    torch.cuda.synchronize()
    ref = t_attn.flash_attention_reference(q.float(), k.float(), v.float(),
                                           heads)
    assert (out.float() - ref).abs().max().item() <= 2.0 ** -6 * ref.abs(
        ).max().item()


@pytest.mark.cuda
def test_cuda_tome_merge_is_deterministic():
    """ToMe's scatter-mean on the card gives the same bits every call,
    where many rows land in one dst bin (equal tokens: every src token's
    best dst is the same): ``index_put_`` with ``accumulate`` adds in
    index order, where ``index_add_`` would add atomically."""
    from sdtpu_torch.ops import tome

    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    h = torch.ones((2, 4096, 320), device="cuda")
    x = torch.randn((2, 4096, 320), generator=g, device="cuda")
    merge, unmerge, r = tome.build(h, 64, 64, 0.5)
    outs = [merge(x) for _ in range(5)]
    assert r == 2048 and all(torch.equal(o, outs[0]) for o in outs)
    assert outs[0].shape == (2, 2048, 320) and outs[0].isfinite().all()
    assert torch.equal(unmerge(outs[0]), unmerge(outs[0]))


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c_out,ks,prologue", [
    ((2, 64, 64, 320), 16, 3, "silu"),      # a LoCon's ResBlock conv
    ((2, 64, 64, 320), 16, 1, "affine"),    # a LoRA's proj_in
    ((2, 8, 8, 1280), 16, 3, "silu"),
    ((2, 32, 32, 640), 4, 1, "affine"),     # rank 4: one short column
])
def test_cuda_conv_at_a_lora_down_conv(shape, c_out, ks, prologue):
    """The conv kernel with a LoRA's down conv as its weight (Cout the
    rank: a part of one column tile), a zero bias and the site's
    GroupNorm prologue, as ``unet._norm_conv`` launches it: within one bf16
    rounding of the float32 plain version, the same bytes twice."""
    _needs_card()
    n, h, w_, c_in = shape
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn((c_out, c_in, ks, ks), generator=g, device="cuda")
         / (ks * ks * c_in) ** 0.5).to(torch.bfloat16).contiguous(
             memory_format=torch.channels_last)
    b = torch.zeros(c_out, device="cuda")
    kw = {"a": torch.rand((n, c_in), generator=g, device="cuda") + 0.5,
          "d": torch.randn((n, c_in), generator=g, device="cuda"),
          "silu": prologue == "silu"}
    assert t_conv.eligible(x, w, 1, ks // 2)
    out = t_conv.fused_conv_cuda(x, w, b, **kw)
    again = t_conv.fused_conv_cuda(x, w, b, **kw)
    torch.cuda.synchronize()
    ref = t_conv.fused_conv_reference(x.float(), w, b, **kw)
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


# the kernels at the sites of a batch of four, on the card: K1 at 64
# batch-heads and the VAE's 4; K2 in both modes at the 64^2 and 8^2 levels
# and the VAE's largest plane; K3 (bf16 and int8 weights) at N = 8 and the
# VAE's 512^2 plane; K4 at 4x the rows, the emb dense of 8 rows; K5 at the
# N = 8 sites the n >= m routing keeps
BATCH_CARD_CASES = (
    [("flash", s) for s in FLASH_B4]
    + [("gn", s) for s in ((8, 4096, 320), (8, 64, 2560), (4, 262144, 128))]
    + [("conv", ((8, 64, 64, 320), 320, 3, "silu", q8)) for q8 in (0, 1)]
    + [("conv", ((8, 8, 8, 2560), 1280, 3, "silu", 1)),
       ("conv", ((8, 32, 32, 640), 640, 1, "affine", 0)),
       ("conv", ((4, 512, 512, 128), 128, 3, "silu", 0))]
    + [("int8w", s) for s in ((32768, 320, 320), (616, 768, 640),
                              (8, 1280, 320), (8192, 1280, 640))]
    + [("w8a8", s) for s in ((616, 768, 640), (2048, 1280, 10240),
                             (512, 1280, 1280))])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,site", BATCH_CARD_CASES, ids=str)
def test_cuda_kernels_at_batch_sites(kernel, site):
    """Each kernel at a site of a batch of four, with the plan its rule
    gives there, held to its plain version as at the batch-2 sites: K1
    within 2^-6 of the output's max-abs, K2, K3 and K4 within one bf16
    rounding (1e-2), K2's statistics within 1e-4, K5 bit-equal; the same
    bytes twice."""
    _needs_card()
    if kernel == "flash":
        b, sq, c, heads = site
        test_cuda_flash_at_the_shapes_the_tiles_could_break(b, sq, sq, c,
                                                            heads)
    elif kernel == "gn":
        _check_gn_modes(*_gn_inputs(*site), 32)
    elif kernel == "conv":
        shape, c_out, ks, prologue, int8 = site
        want = t_conv.plan_conv(*shape, c_out, ks, SMS, bool(int8))["design"]
        test_cuda_conv_at_the_ragged_cases(
            (shape, c_out, ks, prologue, bool(int8), want))
    elif kernel == "int8w":
        test_cuda_int8w_paths_match_plain(*site)
    else:
        test_cuda_w8a8_is_bit_equal_to_plain(*site)


@pytest.mark.cuda
def test_cuda_reader_puts_a_bf16_file_on_the_card(tmp_path):
    """A BF16 checkpoint read straight to the device: each tensor on the
    card, its dtype and bytes those written (beside I64 ids and a 0-d
    scalar)."""
    _needs_card()
    g = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn((320, 320, 3, 3), generator=g).to(
        torch.bfloat16), "b": torch.randn(320, generator=g).to(
        torch.bfloat16), "ids": torch.arange(77)[None],
        "s": torch.tensor(0.5)}
    t_st.save_file(tensors, tmp_path / "m.safetensors")
    got = t_st.load_file(tmp_path / "m.safetensors", device="cuda")
    for k, v in tensors.items():
        assert got[k].device.type == "cuda" and got[k].dtype == v.dtype, k
        assert torch.equal(got[k].cpu(), v), k


@pytest.mark.cuda
def test_cuda_context_model_dir_runs_the_kernels(tmp_path):
    """TINY in bf16 at a 32x32 latent (1,024 tokens: K1's rule takes the
    first level's and the VAE's self-attention) under ``cuda_conv``: a
    Context on the demo weights exported as a BF16 LDM file gives the demo
    Context's bytes, with the same launches of K1, K2's statistics mode and
    K3 per image."""
    _needs_card()
    cfg = dataclasses.replace(TINY, dtype="bfloat16", latent_size=32)
    counters = ((t_attn.flash_attention_cuda, "launches"),
                (t_gn.group_norm_affine_cuda, "launches"),
                (t_conv.fused_conv_cuda, "launches"))

    def run(ctx):
        before = [getattr(f, a) for f, a in counters]
        img = ctx.generate("a horse", seed=5)
        return img, [getattr(f, a) - n for (f, a), n in zip(counters,
                                                             before)]

    demo = Context(config=cfg, steps=2, device="cuda", kernels="cuda_conv")
    t_st.save_file(t_weights.params_to_ldm(demo.params, cfg,
                                           dtype=torch.bfloat16),
                   tmp_path / "sd.safetensors")
    ctx = Context(model_dir=str(tmp_path), config=cfg, steps=2,
                  device="cuda", kernels="cuda_conv")
    want, want_n = run(demo)
    got, got_n = run(ctx)
    assert all(n > 0 for n in want_n) and got_n == want_n
    assert np.array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,c,heads", [
    (2, 1024, 1280, 20),      # SDXL's depth-10 level: 40 batch-heads, d 64
    (2, 4096, 640, 10),       # SDXL's 64x64 level
    (2, 9216, 320, 5),        # SD 2.1 768's first level
    (1, 16384, 512, 1),       # SDXL's VAE mid block
])
def test_cuda_flash_at_the_family_shapes(b, sq, c, heads):
    """K1 at the families' self-attention shapes, within 2^-6 of the
    output's largest value, as at SD1.5's."""
    test_cuda_flash_at_the_shapes_the_tiles_could_break(b, sq, sq, c, heads)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["cuda", "cuda_gn", "cuda_conv"])
def test_cuda_tiny_xl_context_against_plain(policy):
    """TINY_XL in bf16 at a 64x64 latent (the depth-2 level: 1,024 tokens
    of d 16; the VAE: 4,096 of d 32), 2 steps: each ``cuda*`` policy
    launches its kernels, and its latents are as close to a float32 run
    of the same weights as the plain bf16 path's, within 2x (the smoke
    run's ``MODEL_FACTOR``)."""
    _needs_card()
    from sdtpu_torch.config import TINY_XL
    from sdtpu_torch.io.params import cast_params

    cfg = dataclasses.replace(TINY_XL, dtype="bfloat16", latent_size=64)
    ctx = Context(config=cfg, steps=2, device="cuda", kernels="plain")
    c32 = Context(config=dataclasses.replace(cfg, dtype="float32"), steps=2,
                  device="cuda", kernels="plain")
    c32.params = {k: cast_params(v, torch.float32)
                  for k, v in ctx.params.items()}
    with torch.inference_mode():
        c32._prepare_buffers()
    ref = c32.generate("a horse", seed=5, output="latent")
    plain = ctx.generate("a horse", seed=5, output="latent")
    counters = {"cuda": [(t_attn.flash_attention_cuda, "launches")],
                "cuda_gn": [(t_gn.group_norm_cuda, "launches")],
                "cuda_conv": [(t_conv.fused_conv_cuda, "launches"),
                              (t_gn.group_norm_affine_cuda, "launches")]}
    watched = counters["cuda"] + counters.get(policy, [])
    before = [getattr(f, a) for f, a in watched]
    ctx.kernels = policy
    got = ctx.generate("a horse", seed=5, output="latent")
    assert all(getattr(f, a) > n for (f, a), n in zip(watched, before))
    scale = np.abs(ref).max()
    gap_plain = np.abs(plain - ref).max() / scale
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() / scale <= 2.0 * max(gap_plain, 1e-3)
    assert np.array_equal(got, ctx.generate("a horse", seed=5,
                                            output="latent"))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,heads", chip_smoke.TRAIN_SITES
                         + chip_smoke.TRAIN_RAGGED)
def test_cuda_flash_bwd_matches_plain(b, s, c, heads):
    """K1-bwd against its plain version at the training sites and ragged
    shapes of its contract: dq, dk, dv each within the smoke run's
    ``KERNEL_TOL`` of the plain version's max-abs; the same bytes twice;
    the forward's statistics are each row's log-sum-exp."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((b, s, c), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = t_attn.flash_attention_cuda(q, k, v, heads, with_lse=True)
    assert torch.equal(out, t_attn.flash_attention_cuda(q, k, v, heads))
    d = c // heads
    qh, kh = (t.float().view(b, s, heads, d).transpose(1, 2) for t in (q, k))
    ref_lse = torch.logsumexp(torch.einsum("bhqd,bhkd->bhqk", qh, kh)
                              / d ** 0.5, dim=-1).reshape(b * heads, s)
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    grads = t_attn.flash_attention_bwd_cuda(q, k, v, out, lse, do, heads)
    again = t_attn.flash_attention_bwd_cuda(q, k, v, out, lse, do, heads)
    torch.cuda.synchronize()
    refs = t_attn.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), do.float(), heads)
    for x, y, r in zip(grads, again, refs):
        assert torch.equal(x, y)
        assert (x.float() - r).abs().max().item() <= (
            chip_smoke.KERNEL_TOL * r.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(_grad_guard_calls()))
def test_cuda_kernels_without_a_backward_refuse_grad(kernel):
    """The same guard on CUDA tensors: nothing launches."""
    _needs_card()
    x = torch.zeros((1, 4, 4, 8), device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    p = {"scale": torch.ones(8, device="cuda"),
         "bias": torch.zeros(8, device="cuda")}
    w8 = torch.zeros((8, 8), dtype=torch.int8, device="cuda")
    one = torch.ones(8, device="cuda")
    call = {"group_norm": lambda: t_gn.group_norm_cuda(p, x, 2),
            "group_norm_affine": lambda: t_gn.group_norm_affine_cuda(p, x, 2),
            "conv": lambda: t_conv.fused_conv_cuda(
                x, torch.zeros((8, 8, 3, 3), device="cuda",
                               dtype=torch.bfloat16), one),
            "matmul_int8w": lambda: t_mm.matmul_int8w_cuda(
                x.reshape(16, 8), w8, one),
            "matmul_w8a8": lambda: t_mm.matmul_w8a8_cuda(
                x.reshape(16, 8), w8, one, torch.ones((), device="cuda"))}
    with pytest.raises(_build.NoBackwardError):
        call[kernel]()


# ---------------------------------------------------------------------------
# int8w_dense under cuda_conv: K3 with int8 weights and K4 in one mode
# ---------------------------------------------------------------------------

def test_int8w_dense_conv_pins_are_the_rules():
    """SD1.5 under ``quantize="int8w_dense"`` and cuda_conv, from its sites
    and the rules: K3 1,228 an image (60 an eval with int8 weights + the
    VAE's 28 in bf16) with K2's statistics mode beside each, K4 at the 212
    sites an eval K3 does not take (228 less the 16 proj_in), 87 of them
    split K: the smoke run's ``PINNED["int8w_dense_conv"]``."""
    got = _per_image(_family_log("sd15", "int8w_dense_conv"),
                     chip_smoke.STEPS)
    assert got == chip_smoke.PINNED["int8w_dense_conv"]
    assert chip_smoke.MM_INT8W_PER_EVAL_CONV == 212
    assert chip_smoke.MM_INT8W_SUMS_PER_EVAL_CONV == 87
    assert got["conv"] == chip_smoke.CONV_PER_IMAGE == 1228
    assert got["conv_int8"] == 60 * chip_smoke.STEPS
    # K4's sites are int8w_dense's under cuda less the ones K3 fuses
    dense = _part_log("unet", "sd15", "int8w_dense")[("unet", "matmul_int8w")]
    conv = _part_log("unet", "sd15", "int8w_dense_conv")
    assert set(conv[("unet", "matmul_int8w")]) <= set(dense)
    assert len(dense) - len(conv[("unet", "matmul_int8w")]) == 16


@pytest.mark.parametrize("kernel", ["flash", "group_norm_affine", "conv",
                                    "matmul_int8w"])
def test_rules_take_every_int8w_dense_conv_site(kernel):
    """Every site of the mode through its kernel's static rule, and the
    plan within what the C entry point accepts; K3's UNet sites all carry
    int8 weights."""
    log = _family_log("sd15", "int8w_dense_conv")
    sites = sorted({k for (part, kk), keys in log.items() if kk == kernel
                    for k in keys})
    assert sites
    for site in sites:
        _check_site(kernel, site)
    if kernel == "conv":
        assert all(k[-1] for k in log[("unet", "conv")])
        assert not any(k[-1] for k in log[("vae", "conv")])


# ---------------------------------------------------------------------------
# the bench phase: kernels an eval from the profiler, the classes of the
# kernel names the card's traces show
# ---------------------------------------------------------------------------

def test_eval_pins_are_the_image_pins():
    """``EVAL_PINNED`` (the profiler's main launches in one UNet eval) are
    the recorders' counts in one eval, and the image pins less the VAE's:
    K1 10, K2 61 under cuda_gn, K3 and K2's statistics mode 60 under
    cuda_conv."""
    names = {"flash": "K1", "group_norm": "K2", "group_norm_affine": "K2",
             "conv": "K3"}
    for policy, want in chip_smoke.EVAL_PINNED.items():
        got = {}
        for (part, kernel), keys in _part_log("unet", "sd15",
                                              policy).items():
            got[names[kernel]] = got.get(names[kernel], 0) + len(keys)
        assert got == want, policy
        vae = _part_log("vae", "sd15", policy)
        for kernel, cls in names.items():
            image = chip_smoke.PINNED[policy][kernel]
            evals = sum(len(v) for (_, k), v in _part_log(
                "unet", "sd15", policy).items() if k == kernel)
            assert image == evals * chip_smoke.STEPS + len(
                vae.get(("vae", kernel), []))
    assert chip_smoke.EVAL_PINNED["cuda"] == {"K1": 10}
    assert chip_smoke.EVAL_PINNED["cuda_conv"] == {"K1": 10, "K2": 60,
                                                  "K3": 60}


CARD_KERNEL_NAMES = [
    ('void (anonymous namespace)::flash_fwd_kernel<48, 64, false, false>(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bflo',
     'K1'),
    ('void (anonymous namespace)::flash_fwd_kernel<80, 64, false, false>(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bflo',
     'K1'),
    ('void (anonymous namespace)::gn_kernel<8, 0, __nv_bfloat16>((anonymous namespace)::GnArgs)',
     'K2'),
    ('void (anonymous namespace)::gn_kernel<8, 1, __nv_bfloat16>((anonymous namespace)::GnArgs)',
     'K2'),
    ('void (anonymous namespace)::gn_kernel<8, 2, __nv_bfloat16>((anonymous namespace)::GnArgs)',
     'K2'),
    ('void (anonymous namespace)::conv_general_kernel<1, false>((anonymous namespace)::ConvArgs)',
     'K3'),
    ('void (anonymous namespace)::conv_slab_kernel<128, false, 1>((anonymous namespace)::SlabArgs)',
     'K3'),
    ('void (anonymous namespace)::conv_slab_kernel<128, false, 3>((anonymous namespace)::SlabArgs)',
     'K3'),
    ('void (anonymous namespace)::conv_slab_kernel<160, false, 1>((anonymous namespace)::SlabArgs)',
     'K3'),
    ('void (anonymous namespace)::conv_slab_kernel<160, false, 3>((anonymous namespace)::SlabArgs)',
     'K3'),
    ('void (anonymous namespace)::conv_sum_kernel<4>((anonymous namespace)::ConvArgs, int)',
     'K3'),
    ('void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::{lambd',
     'cast'),
    ('sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x32x64_stage5_warpsize2x2x1_g1_tensor16x8x16_',
     'conv'),
    ('sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x32_warpgroupsize1x1x1_g1_execute_segmen',
     'conv'),
    ('sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segmen',
     'conv'),
    ('sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x64x32_warpgroupsize1x1x1_g1_execute_segment',
     'conv'),
    ('sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x128x64_warpgroupsize1x1x1_g1_execute_segment',
     'conv'),
    ('sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x64_warpgroupsize1x1x1_g1_execute_segment_',
     'conv'),
    ('void cask_plugin__5x_cudnn::xmma__5x_cudnn::init_device_workspace_kernel<xmma__5x_cudnn::implicit_gemm::fprop::Warp_spec',
     'conv'),
    ('void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16_256x64_32x4_nhwc_align8>(cutlass_tensoro',
     'conv'),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda(at::T',
     'copy'),
    ('void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda(at::T',
     'copy'),
    ('void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}:',
     'copy'),
    ('Memset (Device)',
     'elementwise'),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::BinaryFunctor<float, float, f',
     'elementwise'),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<float> >(at::',
     'elementwise'),
    ('void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::BinaryFunctor<c10::BFloat16, ',
     'elementwise'),
    ('void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<c10::BFloat16',
     'elementwise'),
    ('void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::GeluCUDAKernelImpl(at::Tensor',
     'elementwise'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::pow_tensor_scalar_kernel_impl<float',
     'elementwise'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<float, float, float, at::native::binary_inte',
     'elementwise'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctorOnSelf_add<float>, std::array<char*, 2ul> >(int',
     'elementwise'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::rsqrt_kernel_cuda(at::TensorIteratorBase&)::{lambda()#2}::',
     'elementwise'),
    ('void at::native::vectorized_elementwise_kernel<8, at::native::BinaryFunctor<c10::BFloat16, c10::BFloat16, c10::BFloat16,',
     'elementwise'),
    ('void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul> >(i',
     'elementwise'),
    ('void at::native::vectorized_elementwise_kernel<8, at::native::sigmoid_kernel_cuda(at::TensorIteratorBase&)::{lambda()#2}',
     'elementwise'),
    ('nvjet_tst_128x64_64x8_2x4_h_bz_NNT',
     'matmul'),
    ('nvjet_tst_128x80_64x8_1x2_h_bz_NNT',
     'matmul'),
    ('nvjet_tst_160x64_64x6_1x2_h_bz_NNN',
     'matmul'),
    ('nvjet_tst_168x128_64x5_1x2_h_bz_TNN',
     'matmul'),
    ('nvjet_tst_320x128_64x3_1x2_h_bz_coopB_NNT',
     'matmul'),
    ('nvjet_tst_64x24_64x16_2x4_h_bz_NNT',
     'matmul'),
    ('nvjet_tst_64x32_64x16_2x4_h_bz_NNT',
     'matmul'),
    ('nvjet_tst_64x32_64x16_2x4_h_bz_TNT',
     'matmul'),
    ('nvjet_tst_64x40_64x16_2x4_h_bz_NNT',
     'matmul'),
    ('nvjet_tst_64x8_64x16_2x4_h_bz_NNT',
     'matmul'),
    ('nvjet_tst_64x8_64x16_4x1_v_bz_NNT',
     'matmul'),
    ('nvjet_tst_80x128_64x8_2x1_v_bz_TNN',
     'matmul'),
    ('nvjet_tst_80x64_64x11_1x2_h_bz_TNN',
     'matmul'),
    ('sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x32x8_stage3_warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cubl',
     'matmul'),
    ('sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize256x64x8_stage3_warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cubl',
     'matmul'),
    ('sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cubla',
     'matmul'),
    ('sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_warpsize1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cubla',
     'matmul'),
    ('void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MeanOps<float, float, float, float>, unsi',
     'reduce'),
    ('void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized<at::native::(anonymous namespace)::OpaqueType<2u>',
     'shaping'),
    ('void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true, (cudnnKernelDataType_t)0>(int, int, int, int, int, ',
     'shaping'),
    ('void (anonymous namespace)::softmax_warp_forward<float, float, float, 6, false, false>(float*, float const*, int, int, i',
     'softmax'),
    ('void (anonymous namespace)::softmax_warp_forward<float, float, float, 7, false, false>(float*, float const*, int, int, i',
     'softmax'),
    ('void (anonymous namespace)::softmax_warp_forward<float, float, float, 8, false, false>(float*, float const*, int, int, i',
     'softmax'),
]


@pytest.mark.parametrize("name,cls", CARD_KERNEL_NAMES)
def test_classify_the_card_kernel_names(name, cls):
    """The names of every device kernel in one SD1.5 UNet eval under cuda,
    cuda_gn and cuda_conv on an H100 (CUDA 12: cuDNN's ``sm90_xmma_fprop``
    and cutlass convs, cuBLAS's ``nvjet`` and float32 ``xmma_gemm``
    products, ATen's kernels), first 120 characters, each in its class."""
    from sdtpu_torch.bench.xprof import classify

    assert classify(name) == cls


def test_every_kernel_class_has_a_card_name():
    classes = {cls for _, cls in CARD_KERNEL_NAMES}
    assert {"K1", "K2", "K3", "conv", "matmul", "elementwise", "copy",
            "cast", "reduce", "softmax", "shaping"} <= classes
    assert "other" not in classes


@pytest.mark.cuda
def test_cuda_profile_counts_one_eval():
    """``profile_ops`` over one SD1.5 UNet eval on the card: each
    hand-written kernel's main launches at ``chip_smoke.EVAL_PINNED`` under
    every policy (the bench phase's check, here at random weights)."""
    from sdtpu_torch.bench.runner import part_specs
    from sdtpu_torch.bench.xprof import kernel_launches, profile_ops
    from sdtpu_torch.config import SD15
    from sdtpu_torch.models import unet

    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = {"unet": _meta_tree(unet.init(SD15.unet, gen, "cuda"))}
    for policy, want in chip_smoke.EVAL_PINNED.items():
        fn, args = part_specs(SD15, {**params, "temb": None, "clip": None,
                                     "vae": None}, policy, "cuda")["unet"]
        got = {k: v[0] for k, v in kernel_launches(
            profile_ops(fn, args)).items()}
        assert got == want, policy
