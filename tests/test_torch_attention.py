"""The port's attention op against the JAX package's
(``sdtpu_torch.ops.attention`` vs ``sdtpu.ops.attention``), its dispatch
rule, the build of all the port's kernels, and the port's import isolation.

On the CPU the port's ``flash_attention`` runs the kernel's plain version;
the JAX side runs its Pallas kernel in interpret mode, as tests/test_ops.py
does. The CUDA kernels themselves run only on the card (the ``cuda``
tests, one per kernel, each against its plain version)."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu.ops import attention as j_attn
from sdtpu_torch.ops import _build
from sdtpu_torch.ops import attention as t_attn
from sdtpu_torch.ops import conv as t_conv
from sdtpu_torch.ops import groupnorm as t_gn
from sdtpu_torch.ops import matmul as t_mm

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setattr(j_attn, "INTERPRET", True)
    j_attn._flash_mha.clear_cache()
    yield
    j_attn._flash_mha.clear_cache()


@pytest.mark.parametrize("seq,heads,d", [(512, 2, 40), (512, 1, 512)])
def test_flash_attention_matches_jax(_interpret, seq, heads, d):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, seq, heads * d), dtype=np.float32)
               for _ in range(3))
    ref = np.asarray(j_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads))
    ours = t_attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), heads).numpy()
    # f32 on both sides; the online softmax (JAX) and the one-pass softmax
    # (port) sum in different orders: the atol of tests/test_ops.py
    np.testing.assert_allclose(ours, ref, atol=2e-4)


def _jax_route(monkeypatch, sq, sk):
    """Which path sdtpu.ops.attention.flash_attention takes for (sq, sk)."""
    from sdtpu.models import layers as j_layers

    taken = []
    monkeypatch.setattr(j_layers, "sdpa",
                        lambda *a, **kw: taken.append("plain"))
    monkeypatch.setattr(j_attn, "_flash_self",
                        lambda *a, **kw: taken.append("kernel"))
    monkeypatch.setattr(j_attn, "_flash_mha",
                        lambda *a, **kw: taken.append("kernel"))
    j_attn.flash_attention(jnp.zeros((1, sq, 8)), jnp.zeros((1, sk, 8)),
                           jnp.zeros((1, sk, 8)), 1)
    assert len(taken) == 1
    return taken[0]


@pytest.mark.parametrize("sq,sk", [
    (77, 77), (256, 256), (384, 384), (512, 512), (600, 600), (640, 640),
    (1024, 1024), (4096, 4096), (1024, 77), (4096, 77), (4096, 1024)])
def test_uses_kernel_matches_jax_dispatch(monkeypatch, sq, sk):
    want = _jax_route(monkeypatch, sq, sk) == "kernel"
    assert t_attn.uses_kernel(torch.zeros(1, sq, 8), torch.zeros(1, sk, 8),
                              torch.zeros(1, sk, 8), 1) == want

    taken = []
    monkeypatch.setattr(t_attn, "sdpa",
                        lambda *a, **kw: taken.append("plain"))
    monkeypatch.setattr(t_attn, "flash_attention_reference",
                        lambda *a, **kw: taken.append("kernel"))
    t_attn.flash_attention(torch.zeros(1, sq, 8), torch.zeros(1, sk, 8),
                           torch.zeros(1, sk, 8), 1)
    assert taken == ["kernel" if want else "plain"]


@pytest.mark.parametrize("bad", ["cpu", "float32", "head_dim", "shape"])
def test_cuda_wrapper_rejects_without_launching(bad):
    """The kernel wrapper raises before building or launching anything;
    well-formed bf16 tensors on the CPU are refused too (it takes CUDA
    tensors only)."""
    shapes = {"head_dim": (1, 512, 20), "shape": (1, 512, 64)}
    q = torch.zeros(shapes.get(bad, (1, 512, 64)),
                    dtype=torch.float32 if bad == "float32" else torch.bfloat16)
    k = torch.zeros((1, 512, 32) if bad == "shape" else q.shape,
                    dtype=q.dtype)
    before = t_attn.flash_attention_cuda.launches
    with pytest.raises(ValueError):
        t_attn.flash_attention_cuda(q, k, k, 2 if bad == "head_dim" else 1)
    assert t_attn.flash_attention_cuda.launches == before


KERNEL_SOURCES = ["conv_gn_silu.cu", "flash_attn_fwd.cu",
                  "group_norm_silu.cu", "matmul_int8w.cu", "matmul_w8a8.cu"]


def test_nvcc_command_targets_sm90a_into_ignored_dir():
    """One nvcc compile per source (started together), then one link into
    the git-ignored build directory, every step for sm_90a."""
    out = _build.library_path()
    assert [s.name for s in _build.sources()] == KERNEL_SOURCES
    objs = []
    for src in _build.sources():
        obj = out.parent / f"{src.stem}.o"
        cmd = _build.compile_command("nvcc", src, obj)
        assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd
        assert cmd[cmd.index("-o") + 1] == str(obj) and cmd[-1] == str(src)
        objs.append(obj)
    link = _build.link_command("nvcc", objs, out)
    assert "arch=compute_90a,code=sm_90a" in link and "-shared" in link
    assert link[link.index("-o") + 1] == str(out)
    assert link[-len(objs):] == [str(o) for o in objs]
    assert out.is_relative_to(_build.BUILD_DIR)
    rel = _build.BUILD_DIR.relative_to(REPO).as_posix()
    ignored = [ln.strip().rstrip("/") for ln in
               (REPO / ".gitignore").read_text().splitlines()]
    assert rel in ignored


@pytest.mark.parametrize("name", KERNEL_SOURCES)
def test_source_hash_covers_each_kernel(monkeypatch, name):
    """Editing any kernel source moves the library to a new build
    directory: each source's bytes are in the hash."""
    full = _build.source_hash()
    rest = [s for s in _build.sources() if s.name != name]
    monkeypatch.setattr(_build, "sources", lambda: rest)
    assert _build.source_hash() != full


def test_port_imports_no_jax():
    """Every module of sdtpu_torch imports without jax or sdtpu (checked in
    a fresh interpreter: this test process has imported JAX)."""
    code = (
        "import importlib, pkgutil, sys, sdtpu_torch\n"
        "for m in pkgutil.walk_packages(sdtpu_torch.__path__, 'sdtpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'sdtpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('sdtpu_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15   # every module was imported


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,heads", [(2, 1024, 640, 8), (1, 640, 512, 1),
                                         (1, 200, 96, 1)])
def test_cuda_kernel_matches_plain(b, s, c, heads):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, s, c), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out = t_attn.flash_attention_cuda(q, k, v, heads)
    torch.cuda.synchronize()
    ref = t_attn.flash_attention_reference(q.float(), k.float(), v.float(),
                                           heads)
    # relative to the output's largest value: the bf16 output (2^-9) and
    # bf16 P before P.V leave it near 2^-8
    assert (out.float() - ref).abs().max().item() <= 2.0 ** -6 * ref.abs(
        ).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c_out,k,prologue,int8", [
    ((2, 64, 64, 320), 320, 3, "silu", False),
    ((2, 8, 8, 2560), 1280, 3, "silu", False),
    ((2, 32, 32, 640), 640, 1, "affine", False),
    ((1, 7, 9, 24), 40, 3, "silu", True),
    ((2, 5, 3, 16), 13, 3, None, False)])
def test_cuda_conv_matches_plain(shape, c_out, k, prologue, int8):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    n, _, _, c_in = shape
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
    b = torch.randn((n, c_out), generator=g, device="cuda")
    kw = {}
    if prologue:
        kw = {"a": torch.rand((n, c_in), generator=g, device="cuda") + 0.5,
              "d": torch.randn((n, c_in), generator=g, device="cuda"),
              "silu": prologue == "silu"}
    out = t_conv.fused_conv_cuda(x, w, b, w_scale=scale, **kw)
    torch.cuda.synchronize()
    ref = t_conv.fused_conv_reference(x.float(), w, b, w_scale=scale, **kw)
    # bf16 prologue operand and output (2^-9 relative each), f32 sums
    assert (out.float() - ref).abs().max().item() <= (
        1e-2 * ref.abs().max().item())


def _int8_gemm_case(m, k, n, bias):
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn((k, n), generator=g, device="cuda") * 0.05
    scale = w.abs().amax(dim=0) / 127.0
    w8 = t_mm.column_major(torch.clamp(torch.round(w / scale), -127, 127)
                           .to(torch.int8))
    b = torch.randn(n, generator=g, device="cuda") if bias else None
    return x, w8, scale, b


INT8_GEMM_SHAPES = [(8192, 320, 320, True), (512, 5120, 1280, True),
                    (154, 768, 320, False), (2, 1280, 320, True),
                    (33, 16, 7, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bias", INT8_GEMM_SHAPES)
def test_cuda_matmul_int8w_matches_plain(m, k, n, bias):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, w8, scale, b = _int8_gemm_case(m, k, n, bias)
    out = t_mm.matmul_int8w_cuda(x, w8, scale, b)
    torch.cuda.synchronize()
    ref = t_mm.matmul_int8w_reference(x.float(), w8, scale, b)
    # one bf16 rounding of the output (2^-9 relative) on float32 sums
    assert (out.float() - ref).abs().max().item() <= (
        1e-2 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bias", INT8_GEMM_SHAPES)
def test_cuda_matmul_w8a8_matches_plain(m, k, n, bias):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, w8, scale, b = _int8_gemm_case(m, k, n, bias)
    xs = x.float().abs().max() / 127.0
    out = t_mm.matmul_w8a8_cuda(x, w8, scale, xs, b)
    torch.cuda.synchronize()
    # exact int32 sums and single float32 operations on both sides: the
    # same bf16 values
    assert torch.equal(out, t_mm.matmul_w8a8_reference(x, w8, scale, xs, b))
