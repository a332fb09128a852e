"""The port's fused GroupNorm and fused conv serving paths (``kernels=
"cuda_gn"`` and ``"cuda_conv"``) against the JAX package's ``"pallas_gn"``
and ``"pallas_conv"``, op by op, model by model and end to end, at TINY in
float32 on the CPU; and the routing of every ``cuda*`` policy.

On the CPU the port's kernel wrappers run their plain versions. The JAX
side runs its Pallas kernels in interpret mode, as tests/test_ops.py does,
and every comparison asserts that the JAX side really reached its Pallas
kernel: off the TPU its shape gates silently send a call to XLA
(``sdtpu/ops/conv.py:182``, ``sdtpu/ops/groupnorm.py:129``), which would
compare the port with the plain reference instead. Inputs are numpy arrays
from a fixed seed; weights are the JAX package's random init, carried over
by ``from_jax_tree``. Each test states its tolerance.
"""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sdtpu import config as j_config
from sdtpu.engine import pipeline as j_pipeline
from sdtpu.engine.context import DEMO_MERGES as J_DEMO_MERGES
from sdtpu.io.params import init_pipeline_params as j_init_params
from sdtpu.models import unet as j_unet
from sdtpu.models import vae as j_vae
from sdtpu.ops import attention as j_attn
from sdtpu.ops import conv as j_conv
from sdtpu.ops import groupnorm as j_gn
from sdtpu.tokenizer import Tokenizer as JTokenizer
from sdtpu_torch import Context, ErrorCode, SdtpuError
from sdtpu_torch import config as t_config
from sdtpu_torch.engine import pipeline as t_pipeline
from sdtpu_torch.io.params import from_jax_tree
from sdtpu_torch.models import layers as t_layers
from sdtpu_torch.models import unet as t_unet
from sdtpu_torch.models import vae as t_vae
from sdtpu_torch.ops import attention as t_attn
from sdtpu_torch.ops import conv as t_conv
from sdtpu_torch.ops import groupnorm as t_gn

TINY_J, TINY_T = j_config.TINY, t_config.TINY
PROMPT = "a photograph of an astronaut riding a horse"
CUDA_POLICIES = ("cuda", "cuda_gn", "cuda_conv")


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    t_layers.disable_tf32()


@pytest.fixture(scope="module")
def trees():
    """(JAX tree as numpy, the port's tree) for TINY."""
    jtree = jax.tree.map(np.asarray,
                         j_init_params(jax.random.PRNGKey(0), TINY_J))
    return jtree, from_jax_tree(jtree, TINY_T)


def _clear_jax_caches():
    j_gn._gn_call.clear_cache()
    j_conv._fused_conv.clear_cache()
    j_attn._flash_mha.clear_cache()


@pytest.fixture
def pallas(monkeypatch):
    """JAX's Pallas kernels in interpret mode; returns a Counter of the
    Pallas kernel functions that reached ``pl.pallas_call``."""
    reached = collections.Counter()
    real = pl.pallas_call

    def counting(kernel, *args, **kwargs):
        reached[getattr(kernel, "func", kernel).__name__] += 1
        return real(kernel, *args, **kwargs)

    for mod in (j_gn, j_conv, j_attn):
        monkeypatch.setattr(mod, "INTERPRET", True)
    monkeypatch.setattr(pl, "pallas_call", counting)
    _clear_jax_caches()
    yield reached
    _clear_jax_caches()


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def assert_close(ours, ref, rel):
    ours = ours.detach().float().numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    tol = rel * float(np.abs(ref).max())
    assert err <= tol, f"max-abs err {err:.3g} > {tol:.3g}"


def _oihw(w_hwio):
    """HWIO numpy weight -> the port's OIHW weight in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(w_hwio)).permute(
        3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,groups,eps,fuse_silu", [
    (32, 4, 1e-5, True),       # 8 channels per group
    (40, 4, 1e-6, False),      # 10 per group, as SD1.5's 320 / 32
    (80, 4, 1e-5, True),       # 20 per group, as 640 / 32
    (120, 4, 1e-6, False),     # 30 per group, as 960 / 32
])
def test_fused_group_norm_matches_jax(pallas, c, groups, eps, fuse_silu):
    """16x16 planes: the JAX kernel's gate needs hw % 128 == 0. Both sides
    f32; the JAX kernel takes E[x^2] - mean^2 and the port two passes:
    max-abs error <= 2e-5 x the output's max-abs."""
    x = _rand(2, 16, 16, c, seed=1) * 2.0 + 0.5
    p = {"scale": _rand(c, seed=2) * 0.5 + 1.0, "bias": _rand(c, seed=3)}
    ref = j_gn.fused_group_norm({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), groups, eps, fuse_silu)
    assert pallas["_gn_kernel"] == 1
    ours = t_gn.fused_group_norm({k: _t(v) for k, v in p.items()}, _t(x),
                                 groups, eps, fuse_silu)
    assert_close(ours, ref, rel=2e-5)


def _conv_case(case):
    """(x, HWIO weight, bias, GroupNorm params or None, silu, w_scale) for
    the three prologue/weight variants of K3."""
    if case == "3x3_silu_per_sample_bias":
        x, cin, cout, k = _rand(2, 8, 8, 24, seed=4), 24, 40, 3
    elif case == "1x1_affine":
        x, cin, cout, k = _rand(2, 8, 8, 32, seed=5), 32, 32, 1
    else:
        x, cin, cout, k = _rand(2, 8, 8, 16, seed=6), 16, 24, 3
    w = _rand(k, k, cin, cout, seed=7) * 0.1
    b = _rand(2, cout, seed=8) if case.startswith("3x3") else _rand(cout,
                                                                   seed=8)
    norm = {"scale": _rand(cin, seed=9) * 0.2 + 1.0,
            "bias": _rand(cin, seed=10)}
    scale = None
    if case == "int8_w_scale":
        scale = (np.abs(w).max(axis=(0, 1, 2)) / 127.0).astype(np.float32)
        w = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
        norm = None
    return x, w, b, norm, case != "1x1_affine", scale


@pytest.mark.parametrize("case", ["3x3_silu_per_sample_bias", "1x1_affine",
                                  "int8_w_scale"])
def test_fused_conv_matches_jax(pallas, case):
    """JAX's fused_conv (Pallas, interpret mode) against the port's, on the
    GroupNorm each side folds with its own gn_affine. Both f32: max-abs
    error <= 1e-5 x the output's max-abs."""
    x, w, b, norm, silu, scale = _conv_case(case)
    eps = 1e-6 if case == "1x1_affine" else 1e-5
    jx = jnp.asarray(x)
    kw = {}
    if norm is not None:
        a, d = j_conv.gn_affine({k: jnp.asarray(v) for k, v in norm.items()},
                                jx, 4, eps)
        kw = {"a": a, "d": d, "silu": silu}
    ref = j_conv.fused_conv(jx, jnp.asarray(w), jnp.asarray(b),
                            w_scale=None if scale is None else
                            jnp.asarray(scale), **kw)
    assert pallas["_conv_kernel_b"] == 1

    tx = _t(x)
    tw = _oihw(w)
    assert t_conv.eligible(tx, tw, 1, w.shape[0] // 2)
    kw = {}
    if norm is not None:
        a, d = t_conv.gn_affine({k: _t(v) for k, v in norm.items()}, tx, 4,
                                eps)
        kw = {"a": a, "d": d, "silu": silu}
    ours = t_conv.fused_conv(tx, tw, _t(b),
                             w_scale=None if scale is None else _t(scale),
                             **kw)
    assert_close(ours, ref, rel=1e-5)


@pytest.mark.parametrize("c,groups,eps", [(32, 4, 1e-5), (40, 4, 1e-6),
                                         (80, 4, 1e-5), (120, 4, 1e-6)])
def test_gn_affine_matches_jax(c, groups, eps):
    """The prologue operands: A and D with GroupNorm(x) = x * A + D, against
    JAX's gn_affine (XLA in the reference; the plain version on a CPU
    tensor here). Both f32: max-abs error <= 1e-5 x each one's max-abs."""
    x = _rand(2, 6, 7, c, seed=11) * 3.0 - 1.0
    p = {"scale": _rand(c, seed=12) + 1.0, "bias": _rand(c, seed=13)}
    ref = j_conv.gn_affine({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), groups, eps)
    ours = t_conv.gn_affine({k: _t(v) for k, v in p.items()}, _t(x), groups,
                            eps)
    for o, r in zip(ours, ref):
        assert_close(o, r, rel=1e-5)


def test_fused_conv_pads_after_the_prologue():
    """A zero input normalizes to silu(D) != 0 inside the image, but the
    padding ring stays 0: a 3x3 all-ones kernel over a constant plane sees
    4 taps at a corner, 6 at an edge and 9 inside."""
    x = torch.zeros(1, 4, 4, 8)
    w = torch.ones(1, 8, 3, 3).contiguous(memory_format=torch.channels_last)
    d = torch.full((1, 8), 2.0)
    y = t_conv.fused_conv(x, w, torch.zeros(1), a=torch.ones(1, 8), d=d)
    s = 8 * float(2.0 * torch.sigmoid(torch.tensor(2.0)))
    want = torch.tensor([[4, 6, 6, 4], [6, 9, 9, 6], [6, 9, 9, 6],
                         [4, 6, 6, 4]], dtype=torch.float32) * s
    torch.testing.assert_close(y[0, :, :, 0], want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("x_shape,w_shape,stride,padding,layout,want", [
    ((2, 8, 8, 16), (24, 16, 3, 3), 1, 1, "cl", True),
    ((2, 8, 8, 16), (24, 16, 1, 1), 1, 0, "cl", True),
    ((2, 7, 5, 8), (3, 8, 3, 3), 1, 1, "cl", True),      # ragged plane, Cout
    ((2, 8, 8, 16), (24, 16, 3, 3), 2, 1, "cl", False),  # stride 2
    ((2, 8, 8, 16), (24, 16, 3, 3), 1, 0, "cl", False),  # 3x3 without pad
    ((2, 8, 8, 16), (24, 16, 1, 1), 1, 1, "cl", False),  # 1x1 with pad
    ((2, 8, 8, 12), (24, 12, 3, 3), 1, 1, "cl", False),  # Cin % 8
    ((2, 8, 8, 16), (24, 16, 3, 3), 1, 1, "oihw", False),  # weight layout
    ((2, 8, 8, 16), (24, 8, 3, 3), 1, 1, "cl", False),   # Cin mismatch
    ((2, 8, 8, 16), (24, 16, 3, 3), 1, 1, "x_view", False),  # strided x
])
def test_conv_eligible_is_the_kernel_contract(x_shape, w_shape, stride,
                                              padding, layout, want):
    # the dtype clause binds the kernel only: a bf16 tensor qualifies, and
    # a float32 one on the CPU (where the plain version runs) too
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(x_shape, dtype=dtype)
        if layout == "x_view":
            x = torch.zeros(x_shape[:-1] + (2 * x_shape[-1],),
                            dtype=dtype)[..., ::2]
        w = torch.zeros(w_shape, dtype=dtype)
        if layout != "oihw":
            w = w.contiguous(memory_format=torch.channels_last)
        assert t_conv.eligible(x, w, stride, padding) is want


@pytest.mark.parametrize("shape,groups,want", [
    ((2, 16, 16, 32), 4, True),
    ((2, 7, 9, 40), 4, True),          # odd plane, 10 channels per group
    ((1, 3, 3, 9), 3, True),           # 3 channels per group
    ((2, 8, 8, 30), 4, False),         # C % groups
    ((2, 8, 8, 8192), 1, False),       # channels per group above the cap
    ((2, 8), 2, False),                # no spatial axis
])
def test_group_norm_uses_kernel_is_the_kernel_contract(shape, groups, want):
    assert t_gn.uses_kernel(torch.zeros(shape), groups) is want
    assert t_gn.uses_kernel(torch.zeros(shape, dtype=torch.bfloat16),
                            groups) is want


@pytest.mark.parametrize("m,c_out,k,want", [
    (8192, 320, 9 * 320, 1),        # 64x64: 192 output tiles, one wave
    (2048, 640, 9 * 640, 3),        # 32x32: 80 tiles
    (512, 1280, 9 * 2560, 6),       # 16x16: 40 tiles
    (128, 1280, 9 * 1280, 11),      # 8x8: 10 tiles, 32 K steps a block
    (128, 1280, 9 * 2560, 16),      # 8x8: capped at 16
    (512, 1280, 1280, 1),           # 16x16 1x1: too shallow to split
    (30, 13, 144, 1),
])
def test_conv_splits_fill_the_card(m, c_out, k, want):
    """Split-K on a 132-SM card: the blocks of one wave (two per SM), each
    with at least 32 K steps (the kernel runs on the card only; the choice
    is plain Python)."""
    assert t_conv.splits_for(m, c_out, k, 132) == want


@pytest.mark.parametrize("bad", ["cpu", "float32"])
def test_cuda_wrappers_reject_without_launching(bad):
    """The kernel wrappers raise before building or launching anything:
    they take CUDA tensors only (a CPU bf16 tensor is refused too)."""
    dtype = torch.float32 if bad == "float32" else torch.bfloat16
    x = torch.zeros((2, 8, 8, 16), dtype=dtype)
    p = {"scale": torch.ones(16), "bias": torch.zeros(16)}
    w = torch.zeros((16, 16, 3, 3), dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    wrappers = (t_gn.group_norm_cuda, t_gn.group_norm_affine_cuda,
                t_conv.fused_conv_cuda)
    before = [f.launches for f in wrappers]
    with pytest.raises(ValueError):
        t_gn.group_norm_cuda(p, x, 4, 1e-5, True)
    with pytest.raises(ValueError):
        t_gn.group_norm_affine_cuda(p, x, 4, 1e-5)
    with pytest.raises(ValueError):
        t_conv.fused_conv_cuda(x, w, torch.zeros(16))
    assert [f.launches for f in wrappers] == before


# ---------------------------------------------------------------------------
# routing of the policies (the port's own dispatch, on CPU tensors)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels", CUDA_POLICIES)
def test_cuda_policies_keep_flash_attention(monkeypatch, trees, kernels):
    """Every cuda* policy sends the UNet's self-attention and the VAE's mid
    block through ops.attention.flash_attention, as every pallas* policy
    keeps the flash kernel in the reference (``sdtpu/models/unet.py:255``,
    ``vae.py:117``). TINY runs 7 transformers, each with a self- and a
    cross-attention, and one VAE mid-block attention."""
    _, ttree = trees
    calls = []
    real = t_attn.flash_attention

    def counting(q, k, v, heads):
        calls.append(q.shape[1])
        return real(q, k, v, heads)

    monkeypatch.setattr(t_attn, "flash_attention", counting)
    x, te, ctx = _rand(2, 8, 8, 4), _rand(2, 64), _rand(2, 16, 32)
    t_unet.apply(ttree["unet"], _t(x), _t(te), _t(ctx), TINY_T.unet, kernels)
    assert len(calls) == 14
    t_vae.apply(ttree["vae"], _t(_rand(1, 8, 8, 4)), TINY_T.vae, kernels)
    assert len(calls) == 15 and calls[-1] == 64


# per TINY UNet eval: 8 ResBlocks x 2 norms + 7 transformer norms +
# out_norm for K2; 8 x 2 ResBlock convs + 7 proj_in for K3; per VAE
# decode: 6 ResBlocks x 2 convs for K3 and no K2
@pytest.mark.parametrize("kernels,gn_unet,conv_unet,conv_vae", [
    ("plain", 0, 0, 0), ("cuda", 0, 0, 0), ("cuda_gn", 24, 0, 0),
    ("cuda_conv", 0, 23, 12)])
def test_policy_routes_each_site(monkeypatch, trees, kernels, gn_unet,
                                 conv_unet, conv_vae):
    """Which sites reach each kernel's wrapper: on a CPU tensor the wrapper
    runs the plain version, so counting its calls counts the sites the
    kernel takes on the card (chip_smoke.py pins the SD1.5 counts)."""
    _, ttree = trees
    seen = collections.Counter()
    for mod, name in ((t_gn, "group_norm_reference"),
                      (t_conv, "fused_conv_reference")):
        real = getattr(mod, name)

        def counting(*a, _real=real, _name=name, **kw):
            seen[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, counting)
    x, te, ctx = _rand(2, 8, 8, 4), _rand(2, 64), _rand(2, 16, 32)
    t_unet.apply(ttree["unet"], _t(x), _t(te), _t(ctx), TINY_T.unet, kernels)
    assert seen["group_norm_reference"] == gn_unet
    assert seen["fused_conv_reference"] == conv_unet
    seen.clear()
    t_vae.apply(ttree["vae"], _t(_rand(1, 8, 8, 4)), TINY_T.vae, kernels)
    assert seen["group_norm_reference"] == 0
    assert seen["fused_conv_reference"] == conv_vae


# ---------------------------------------------------------------------------
# models and the pipeline against the JAX package's kernel policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ours,theirs,kernel", [
    ("cuda_gn", "pallas_gn", "_gn_kernel"),
    ("cuda_conv", "pallas_conv", "_conv_kernel_b")])
def test_unet_matches_jax_policy(pallas, trees, ours, theirs, kernel):
    """16x16 latents, so the JAX GroupNorm kernel's hw % 128 gate opens at
    the first level. Both f32: max-abs error <= 1e-4 x the output's
    max-abs, the tolerance of tests/test_torch_slice.py."""
    jtree, ttree = trees
    x, te = _rand(2, 16, 16, 4, seed=1), _rand(2, 64, seed=2)
    ctx = _rand(2, 16, 32, seed=3)
    ref = jax.jit(functools.partial(j_unet.apply, cfg=TINY_J.unet,
                                    kernels=theirs))(
        jtree["unet"], jnp.asarray(x), jnp.asarray(te), jnp.asarray(ctx))
    assert pallas[kernel] > 0
    out = t_unet.apply(ttree["unet"], _t(x), _t(te), _t(ctx), TINY_T.unet,
                       ours)
    assert_close(out, ref, rel=1e-4)


def test_vae_matches_jax_pallas_conv(pallas, trees):
    """The decoder under cuda_conv against JAX's pallas_conv. Both f32:
    max-abs error <= 1e-4 x the output's max-abs."""
    jtree, ttree = trees
    z = _rand(1, 8, 8, 4, seed=4)
    ref = jax.jit(functools.partial(j_vae.apply, cfg=TINY_J.vae,
                                    kernels="pallas_conv"))(
        jtree["vae"], jnp.asarray(z))
    assert pallas["_conv_kernel_b"] > 0
    out = t_vae.apply(ttree["vae"], _t(z), TINY_T.vae, "cuda_conv")
    assert_close(out, ref, rel=1e-4)


def test_context_cuda_conv_matches_jax_pipeline(monkeypatch, pallas, trees):
    """Context(kernels="cuda_conv").generate, with the JAX tree's weights
    and the JAX pipeline's noise injected, against the JAX pipeline under
    pallas_conv (its conv kernel in interpret mode). Latents: max-abs error
    <= 1e-4 x their max-abs; the uint8 image within 1 (a value on a .5
    boundary may round either way)."""
    jtree, ttree = trees
    steps, seed, guidance = 2, 7, 7.5
    tok = JTokenizer.from_merges(J_DEMO_MERGES)
    L = TINY_J.clip.context_len
    jtok = jnp.asarray([tok.tokenize(PROMPT, L)], jnp.int32)
    j_unc = jax.jit(functools.partial(j_pipeline.encode_text, cfg=TINY_J))(
        jtree, jnp.asarray([tok.tokenize("", L)], jnp.int32))[0]
    key = jax.random.PRNGKey(seed)
    j_lat = jax.jit(functools.partial(
        j_pipeline.generate, cfg=TINY_J, sampler="dpm", steps=steps,
        kernels="pallas_conv", output="latent"))(
        jtree, jtok, j_unc, key, jnp.float32(guidance))
    j_img = np.asarray(jax.jit(functools.partial(
        j_pipeline.decode_latents, cfg=TINY_J, kernels="pallas_conv"))(
        jtree, j_lat))
    assert pallas["_conv_kernel_b"] > 0
    shape = (1, TINY_J.latent_size, TINY_J.latent_size,
             TINY_J.latent_channels)
    noise = np.array(jax.random.normal(key, shape, jnp.float32))

    ctx = Context(config="tiny", steps=steps, kernels="cuda_conv",
                  device="cpu")
    ctx.params = ttree
    ctx._prepare_buffers()
    monkeypatch.setattr(t_pipeline, "generate", functools.partial(
        t_pipeline.generate, noise=noise))
    assert_close(torch.from_numpy(ctx.generate(PROMPT, guidance, seed=seed,
                                               output="latent"))[None],
                 j_lat, rel=1e-4)
    img = ctx.generate(PROMPT, guidance, seed=seed)
    assert img.dtype == np.uint8 and img.shape == j_img.shape[1:]
    assert np.abs(img.astype(int) - j_img[0].astype(int)).max() <= 1


@pytest.mark.parametrize("kernels", ["cuda_gn", "cuda_conv"])
def test_context_accepts_fused_policies(kernels):
    ctx = Context(config="tiny", steps=2, kernels=kernels, device="cpu")
    assert ctx.kernels == kernels
    img = ctx.generate(PROMPT, seed=3)
    assert img.shape == (16, 16, 3) and img.std() > 0
    # the plain path computes the same function in float32; a value on a
    # .5 boundary may round either way
    ctx.kernels = "plain"
    plain = ctx.generate(PROMPT, seed=3)
    assert np.abs(img.astype(int) - plain.astype(int)).max() <= 1


def test_context_names_every_policy_on_a_bad_one():
    with pytest.raises(SdtpuError) as ei:
        Context(config="tiny", kernels="pallas_conv", device="cpu")
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    msg = ei.value.args[0] if ei.value.args else str(ei.value)
    for name in ("auto",) + CUDA_POLICIES + ("plain",):
        assert name in str(msg)
