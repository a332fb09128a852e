"""The port's attention op against the JAX package's
(``sdtpu_torch.ops.attention`` vs ``sdtpu.ops.attention``), its dispatch
rule, its build command, and the port's import isolation.

On the CPU the port's ``flash_attention`` runs the kernel's plain version;
the JAX side runs its Pallas kernel in interpret mode, as tests/test_ops.py
does. The CUDA kernel itself runs only on the card (the ``cuda`` test)."""

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
    assert t_attn.uses_kernel(sq, sk) == want

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


def test_nvcc_command_targets_sm90a_into_ignored_dir():
    out = _build.library_path()
    cmd = _build.nvcc_command("nvcc", out)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-o") + 1] == str(out)
    assert [Path(s).name for s in cmd if s.endswith(".cu")] == [
        "flash_attn_fwd.cu"]
    assert out.is_relative_to(_build.BUILD_DIR)
    rel = _build.BUILD_DIR.relative_to(REPO).as_posix()
    ignored = [ln.strip().rstrip("/") for ln in
               (REPO / ".gitignore").read_text().splitlines()]
    assert rel in ignored


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
    # bf16 output (2^-9 relative) and bf16 P before P.V
    assert (out.float() - ref).abs().max().item() <= 2e-2
