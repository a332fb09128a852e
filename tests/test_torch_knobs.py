"""The port's Context knobs against the JAX package, at TINY in float32 on
the CPU: the constructor's signature (read from the reference's source with
``ast``), ToMe (``ops.tome``), the UNet's PAG perturbation, DeepCache's
capture and shallow passes and FreeU, the fused attention projections, the
denoising loop under each knob (CFG interval and rescale, PAG with a scalar
and a per-sample scale, DeepCache alone and across the interval's
segments, FreeU, ToMe, ``size``, ``fuse_qkv``), the incompatibility
``ValueError``s, and ``Context``'s validation (codes and texts against the
reference's), setters, ``generate_async``, ``threads``, ``log_level`` and
``compile_cache``.

Both sides get the same weights (the port's init carried to the JAX layout
by ``io.params.to_jax_tree``) and the same draws (the reference's threefry
draws reach the port through ``noise=``). The reference's loops run as
Python loops over their bodies with the UNet jitted once per configuration
and DeepCache's ``lax.cond`` taken as a Python branch, as
``tests/test_torch_image.py`` runs them. Latents are held within 1e-4 of
the reference's max-abs, modules within 1e-5.
"""

import ast
import dataclasses
import functools
import io
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu import config as j_config
from sdtpu.engine import context as j_context
from sdtpu.engine import errors as j_errors
from sdtpu.engine import pipeline as j_pipeline
from sdtpu.io import params as j_params
from sdtpu.models import unet as j_unet
from sdtpu.ops import tome as j_tome
from sdtpu_torch import Context, ErrorCode, SdtpuError
from sdtpu_torch import config as t_config
from sdtpu_torch.engine import logging as t_slog
from sdtpu_torch.engine import pipeline as t_pipeline
from sdtpu_torch.io import params as t_params
from sdtpu_torch.io.params import init_pipeline_params, to_jax_tree
from sdtpu_torch.models import layers as t_layers
from sdtpu_torch.models import unet as t_unet
from sdtpu_torch.ops import tome as t_tome
from test_tome import _np_reference

TINY_J, TINY_T = j_config.TINY, t_config.TINY
PROMPT = "a photograph of an astronaut riding a horse"
#: the reference's Context, read as source (not imported) for its signature
REF_CONTEXT = (Path(__file__).resolve().parent.parent / "sdtpu" / "engine"
               / "context.py")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and eager ops on TINY tensors lose far more to oversubscribed threads
    than they gain from them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    t_layers.disable_tf32()


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def assert_close(ours, ref, rel=1e-4):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    tol = rel * float(np.abs(ref).max())
    assert err <= tol, f"max-abs err {err:.3g} > {tol:.3g}"


def _both(**kw):
    """(the JAX TINY, the port's) with the same fields replaced; the key
    ``unet`` holds the UNet's fields."""
    unet = kw.pop("unet", {})
    return tuple(dataclasses.replace(c, unet=dataclasses.replace(
        c.unet, **unet), **kw) for c in (TINY_J, TINY_T))


_TREES = {}


def trees(fused=False):
    """(the JAX layout as jnp arrays, the port's tree) of the TINY init,
    made once; ``fused``: both with the attention projections fused."""
    if fused not in _TREES:
        ttree = init_pipeline_params(TINY_T, torch.Generator().manual_seed(0),
                                     "cpu")
        jtree = jax.tree.map(jnp.asarray, to_jax_tree(ttree))
        if fused:
            ttree = t_params.fuse_attention_projections(ttree)
            jtree = j_params.fuse_attention_projections(jtree)
        _TREES[fused] = (jtree, ttree)
    return _TREES[fused]


# ---------------------------------------------------------------------------
# the reference run as loops (module docstring)
# ---------------------------------------------------------------------------

#: XLA:CPU compiles at backend optimization level 0 (the same arithmetic)
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})


def _scan_as_loop(f, init, xs, unroll=1, length=None):
    carry = init
    for i in range(int(xs.shape[0])):
        carry, _ = f(carry, xs[i])
    return carry, None


def _cond_as_branch(pred, true_fn, false_fn, *operands):
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


_normal = _jit(jax.random.normal, static_argnums=(1, 2))


def _normal_draw(key, shape, dtype=jnp.float32):
    return _normal(key, tuple(shape), dtype)


_J_UNET = j_unet.apply
_unet_plain = _jit(_J_UNET, static_argnums=(4, 5),
                   static_argnames=("perturb",))
_unet_capture = _jit(
    lambda p, x, t, c, cfg, k: _J_UNET(p, x, t, c, cfg, k, deep="capture"),
    static_argnums=(4, 5))
_unet_shallow = _jit(
    lambda p, x, t, c, cfg, k, d: _J_UNET(p, x, t, c, cfg, k, deep=d),
    static_argnums=(4, 5))


def _unet_apply(params, x, t_emb, context, cfg, kernels="xla", control=None,
                perturb=None, deep=None):
    """The reference's UNet, jitted once per configuration and mode (as
    it is under another trace: ``_dc_zeros``'s ``eval_shape``)."""
    assert control is None
    if isinstance(x, jax.core.Tracer):
        return _J_UNET(params, x, t_emb, context, cfg, kernels,
                       perturb=perturb, deep=deep)
    if deep is None:
        return _unet_plain(params, x, t_emb, context, cfg, kernels,
                           perturb=None if perturb is None
                           else tuple(perturb))
    if isinstance(deep, str):
        return _unet_capture(params, x, t_emb, context, cfg, kernels)
    return _unet_shallow(params, x, t_emb, context, cfg, kernels, deep)


_encode = _jit(j_pipeline.encode_text, static_argnums=(2,))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's pipeline module with its scan and cond taken as
    Python control flow and its models jitted once per shape."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.lax, "scan", _scan_as_loop)
    mp.setattr(jax.lax, "cond", _cond_as_branch)
    mp.setattr(jax.random, "normal", _normal_draw)
    mp.setattr(j_unet, "apply", _unet_apply)
    mp.setattr(j_pipeline, "encode_text",
               lambda p, t, cfg, w=None: _encode(
                   {"clip": p["clip"]}, t, dataclasses.replace(
                       TINY_J, dtype=cfg.dtype), w))
    yield j_pipeline
    mp.undo()


# ---------------------------------------------------------------------------
# step 0: the constructor's signature is the reference's
# ---------------------------------------------------------------------------

def _reference_signature():
    """[(name, default source)] of ``sdtpu.engine.context.Context.__init__``
    after ``self``, read from its source (the JAX Context is not imported
    for it)."""
    tree = ast.parse(REF_CONTEXT.read_text())
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "Context")
    init = next(n for n in cls.body
                if isinstance(n, ast.FunctionDef) and n.name == "__init__")
    args = init.args.args[1:]
    defaults = [None] * (len(args) - len(init.args.defaults)) + list(
        init.args.defaults)
    assert not init.args.kwonlyargs
    return [(a.arg, ast.unparse(d)) for a, d in zip(args, defaults)]


REF_SIGNATURE = _reference_signature()


def _default_value(src):
    """A default's source as a value: a literal, or ``slog.LogLevel.X``
    resolved in the port's logging module."""
    try:
        return ast.literal_eval(src)
    except ValueError:
        prefix = "slog.LogLevel."
        assert src.startswith(prefix), src
        return t_slog.LogLevel[src[len(prefix):]]


@pytest.mark.parametrize("pos,name,default", [
    (i, n, d) for i, (n, d) in enumerate(REF_SIGNATURE)])
def test_constructor_takes_the_references_keyword(pos, name, default):
    """Each of the reference's parameters at its position, with its name
    and its default (queue 3 #1: the port took none of ``size``,
    ``threads``, ``log_level``, ``compile_cache``, ``fuse_qkv``, ...)."""
    import inspect

    params = list(inspect.signature(Context.__init__).parameters.values())[1:]
    p = params[pos]
    assert p.name == name
    assert p.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD
    assert p.default == _default_value(default)


def test_constructor_adds_only_the_keyword_only_device():
    import inspect

    params = list(inspect.signature(Context.__init__).parameters.values())[1:]
    assert [p.name for p in params] == [n for n, _ in REF_SIGNATURE] + [
        "device"]
    assert params[-1].kind == inspect.Parameter.KEYWORD_ONLY
    assert params[-1].default == "cuda"
    assert len(REF_SIGNATURE) == 22


def test_positional_order_is_the_references():
    """``Context(None, 2, "dpm", "tiny", LogLevel.ERROR, "plain")``: the
    fifth position is the log level, as in the reference, and no longer
    ``kernels``."""
    c = Context(None, 2, "dpm", "tiny", t_slog.LogLevel.ERROR, "plain",
                device="cpu")
    assert c.kernels == "plain" and c.logger.level == t_slog.LogLevel.ERROR
    assert c.steps == 2 and c.cfg is TINY_T


# ---------------------------------------------------------------------------
# ToMe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hh,ww", [(4, 4), (8, 8), (6, 10), (3, 5)])
def test_tome_plan_matches_jax(hh, ww):
    for ours, theirs in zip(t_tome.plan(hh, ww), j_tome.plan(hh, ww)):
        np.testing.assert_array_equal(ours, theirs)
        assert ours.dtype == np.int32


def _separated_metric(b, n, c, seed):
    """Tokens whose similarities are well separated: each is a distinct
    scaled copy of one of a few directions plus a distinct offset, so no
    two scores of a row lie within float32 rounding of each other."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    return x + np.linspace(0.0, 3.0, c, dtype=np.float32)[None, None]


@pytest.mark.parametrize("ratio", [0.25, 0.5, 0.75])
def test_tome_build_matches_jax(ratio):
    """The selection (which tokens merge, into which dst) and the merge and
    unmerge against the reference's, on inputs whose scores are well
    separated; the merge count is the reference's."""
    hh = ww = 8
    x = _separated_metric(2, hh * ww, 16, seed=int(ratio * 100))
    merge, unmerge, r = t_tome.build(torch.from_numpy(x), hh, ww, ratio)
    j_merge, j_unmerge, j_r = j_tome.build(jnp.asarray(x), hh, ww, ratio)
    assert r == j_r
    y = _rand(2, hh * ww, 16, seed=9)
    got = merge(torch.from_numpy(y))
    want = np.asarray(j_merge(jnp.asarray(y)))
    assert_close(got, want, 1e-6)
    assert_close(unmerge(got), np.asarray(j_unmerge(jnp.asarray(want))),
                 1e-6)


def test_tome_merge_and_unmerge_match_the_numpy_oracle():
    """``tests/test_tome.py``'s numpy oracle of build + merge, and the
    unmerge of the merged tokens."""
    x = _rand(2, 16, 8, seed=4)
    merge, unmerge, r = t_tome.build(torch.from_numpy(x), 4, 4, 0.5)
    assert r == 8
    want, full_want = _np_reference(x, 4, 4, 0.5)
    got = merge(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(unmerge(got).numpy(), full_want, atol=1e-5,
                               rtol=1e-5)


def test_tome_ratio_zero_is_identity_and_grid_is_checked():
    x = torch.from_numpy(_rand(1, 16, 4))
    merge, unmerge, r = t_tome.build(x, 4, 4, 0.0)
    assert r == 0 and merge(x) is x and unmerge(x) is x
    with pytest.raises(ValueError, match="grid is 4x5"):
        t_tome.build(x, 4, 5, 0.5)


def test_tome_merges_on_the_meta_device():
    """The pins come from the meta device: the merge keeps its shapes
    there (4096 tokens at 0.5: 2048)."""
    h = torch.empty((2, 4096, 320), device="meta")
    merge, unmerge, r = t_tome.build(h, 64, 64, 0.5)
    assert r == 2048 and merge(h).shape == (2, 2048, 320)
    assert unmerge(merge(h)).shape == (2, 4096, 320)


# ---------------------------------------------------------------------------
# the UNet: PAG, DeepCache, ToMe, FreeU, fused projections
# ---------------------------------------------------------------------------

def _unet_inputs(cfg, b=2, size=None, seed=1):
    size = size or cfg.latent_size
    x = _rand(b, size, size, cfg.unet.in_channels, seed=seed)
    te = _rand(b, cfg.unet.time_embed_dim, seed=seed + 1)
    ctx = _rand(b, cfg.clip.context_len, cfg.unet.context_dim, seed=seed + 2)
    return x, te, ctx


def _unet_pair(jcfg, tcfg, fused=False, **kw):
    jtree, ttree = trees(fused)
    x, te, ctx = _unet_inputs(tcfg)
    ours = t_unet.apply(ttree["unet"], torch.from_numpy(x),
                        torch.from_numpy(te), torch.from_numpy(ctx),
                        tcfg.unet, **kw)
    theirs = _unet_apply(jtree["unet"], jnp.asarray(x), jnp.asarray(te),
                         jnp.asarray(ctx), jcfg.unet, **kw)
    return ours, theirs


@pytest.mark.parametrize("perturb", [("mid",), ("down", "up"),
                                     ("down", "mid", "up")])
def test_unet_perturb_matches_jax(perturb):
    ours, theirs = _unet_pair(TINY_J, TINY_T, perturb=perturb)
    assert_close(ours, theirs, 1e-5)
    plain, _ = _unet_pair(TINY_J, TINY_T)
    assert not torch.equal(ours, plain)


def test_unet_capture_and_shallow_match_jax():
    """``deep="capture"`` returns the eps of the plain forward and the
    hidden entering the last up level; the shallow pass splices it."""
    jtree, ttree = trees()
    (eps, cache), (j_eps, j_cache) = _unet_pair(TINY_J, TINY_T,
                                                deep="capture")
    assert_close(eps, j_eps, 1e-5)
    assert_close(cache, j_cache, 1e-5)
    plain, _ = _unet_pair(TINY_J, TINY_T)
    assert torch.equal(eps, plain)
    x, te, ctx = _unet_inputs(TINY_T, seed=5)
    ours = t_unet.apply(ttree["unet"], torch.from_numpy(x),
                        torch.from_numpy(te), torch.from_numpy(ctx),
                        TINY_T.unet, deep=cache)
    theirs = _unet_apply(jtree["unet"], jnp.asarray(x), jnp.asarray(te),
                         jnp.asarray(ctx), TINY_J.unet, deep=j_cache)
    assert_close(ours, theirs, 1e-5)


def test_unet_shallow_pass_reads_no_deep_weight():
    """The shallow pass never reads the mid block or the deeper levels."""
    _, ttree = trees()
    p = dict(ttree["unet"])
    x, te, ctx = (torch.from_numpy(a) for a in _unet_inputs(TINY_T))
    _, cache = t_unet.apply(p, x, te, ctx, TINY_T.unet, deep="capture")
    broken = {**p, "mid": None, "down": p["down"][:1], "up": [None] * (
        len(p["up"]) - 1) + p["up"][-1:]}
    assert torch.equal(
        t_unet.apply(p, x, te, ctx, TINY_T.unet, deep=cache),
        t_unet.apply(broken, x, te, ctx, TINY_T.unet, deep=cache))


@pytest.mark.parametrize("kw,text", [
    (dict(perturb=("side",)), "unknown perturb sections ['side']; expected "
     "a subset of ('down', 'mid', 'up')"),
    (dict(deep="bogus"), "deep must be None, 'capture', or a cached junction "
     "tensor, got 'bogus'")])
def test_unet_validation_has_the_references_text(kw, text):
    with pytest.raises(ValueError) as ours:
        t_unet.apply(None, None, None, None, TINY_T.unet, **kw)
    with pytest.raises(ValueError) as theirs:
        j_unet.apply(None, None, None, None, TINY_J.unet, **kw)
    assert str(ours.value) == str(theirs.value) == text


def test_unet_tome_matches_jax():
    """ToMe with the gate lowered to TINY's 8x8 level (64 tokens), as
    ``tests/test_tome.py`` lowers it: merged self-attention at level 0."""
    jcfg, tcfg = _both(unet=dict(tome_ratio=0.5, tome_min_tokens=64))
    ours, theirs = _unet_pair(jcfg, tcfg)
    assert_close(ours, theirs, 1e-5)
    plain, _ = _unet_pair(TINY_J, TINY_T)
    assert not torch.equal(ours, plain)
    gated, _ = _unet_pair(*_both(unet=dict(tome_ratio=0.5)))
    assert torch.equal(gated, plain)


@pytest.mark.parametrize("size", [8, 16, 32])
def test_fourier_lowfreq_scale_matches_jax(size):
    s = _rand(2, size, size, 16, seed=size)
    ours = t_unet._fourier_lowfreq_scale(torch.from_numpy(s), 0.2)
    theirs = j_unet._fourier_lowfreq_scale(jnp.asarray(s), 0.2)
    assert_close(ours, theirs, 1e-5)


@pytest.mark.parametrize("size", [8, 16, 32])
@pytest.mark.parametrize("c", [32, 16, 48])
def test_freeu_matches_jax(size, c):
    """Both TINY decoder widths (32 takes b1/s1, 16 b2/s2) and one FreeU
    leaves alone (48)."""
    jcfg, tcfg = _both(unet=dict(freeu=(1.5, 1.6, 0.9, 0.2)))
    h, s = _rand(2, size, size, c, seed=1), _rand(2, size, size, c, seed=2)
    oh, os_ = t_unet._freeu(torch.from_numpy(h), torch.from_numpy(s),
                            tcfg.unet)
    jh, js = j_unet._freeu(jnp.asarray(h), jnp.asarray(s), jcfg.unet)
    assert_close(oh, jh, 1e-6)
    assert_close(os_, js, 1e-5)
    if c == 48:
        assert np.array_equal(oh.numpy(), h) and np.array_equal(
            os_.numpy(), s)


def test_freeu_keeps_the_references_width_rule():
    """SD1.5's two deepest decoder widths are both 1280, so b2 and s2 never
    apply (the reference's rule, kept: ROADMAP queue 3, Divergences)."""
    cfg = dataclasses.replace(t_config.SD15.unet, freeu=(2.0, 3.0, 1.0, 1.0))
    h = torch.ones((1, 2, 2, 1280))
    out, _ = t_unet._freeu(h, h, cfg)
    assert out[..., :640].eq(2.0).all() and out[..., 640:].eq(1.0).all()
    xl = dataclasses.replace(t_config.SDXL.unet, freeu=(2.0, 3.0, 1.0, 1.0))
    h = torch.ones((1, 2, 2, 640))
    assert t_unet._freeu(h, h, xl)[0][..., :320].eq(3.0).all()


def test_fuse_attention_projections_matches_jax():
    jtree, ttree = trees(fused=True)
    ours = to_jax_tree(ttree)
    flat_o = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [p for p, _ in flat_o] == [p for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_o, flat_j):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    blk = ttree["unet"]["down"][0]["blocks"][0]["st"]
    assert set(blk["attn1"]) == {"qkv", "out"}
    assert set(blk["attn2"]) == {"q", "kv", "out"}


@pytest.mark.parametrize("perturb", [None, ("down", "mid", "up")])
def test_unet_fused_projections_match_jax_and_the_unfused(perturb):
    """The fused tree's UNet against the reference's fused one, and within
    float rounding of the unfused port (the same products, wider)."""
    ours, theirs = _unet_pair(TINY_J, TINY_T, fused=True, perturb=perturb)
    assert_close(ours, theirs, 1e-5)
    unfused, _ = _unet_pair(TINY_J, TINY_T, perturb=perturb)
    assert_close(ours, unfused.numpy(), 1e-5)


def test_fused_split_is_contiguous():
    """K1's rule takes contiguous q, k, v: the split of a fused product
    is copied out, so ``fuse_qkv`` keeps the flash kernel (its 201 a
    SD1.5 image)."""
    y = torch.randn(2, 5, 3 * 8)
    parts = t_unet._split(y, 3)
    assert all(p.is_contiguous() and p.shape == (2, 5, 8) for p in parts)
    assert torch.equal(torch.cat(parts, -1), y)


# ---------------------------------------------------------------------------
# the denoising loop under each knob
# ---------------------------------------------------------------------------

def _tokens(b, cfg, seed=3):
    return np.random.default_rng(seed).integers(0, 500, (b, cfg.clip
                                                         .context_len))


def _uncond(ttree, tcfg):
    un = torch.zeros((1, tcfg.clip.context_len), dtype=torch.int64)
    return t_pipeline.encode_text(ttree, un, tcfg)[0]


def _noise(b, tcfg):
    """The reference's start latents: one key, or one a sample."""
    shape = (b, tcfg.latent_size, tcfg.latent_size, tcfg.latent_channels)
    if b == 1:
        key = jax.random.PRNGKey(11)
        return key, np.array(_normal_draw(key, shape))
    key = jnp.stack([jax.random.PRNGKey(11 + i) for i in range(b)])
    return key, np.stack([np.array(_normal_draw(k, shape[1:])) for k in key])


def _port_latents(tcfg, steps=3, sampler="dpm", b=1, guidance=7.5,
                  fused=False, **kw):
    ttree = trees(fused)[1]
    return t_pipeline.generate(
        ttree, torch.from_numpy(_tokens(b, tcfg)), _uncond(ttree, tcfg),
        None, guidance, cfg=tcfg, sampler=sampler, steps=steps, use_cfg=True,
        output="latent", noise=_noise(b, tcfg)[1], **kw)


def _generate_pair(ref, jcfg, tcfg, steps=3, sampler="dpm", b=1,
                   guidance=7.5, fused=False, **kw):
    """The reference's ``generate`` latents and the port's on its draws."""
    jtree = trees(fused)[0]
    un = np.zeros((1, tcfg.clip.context_len), np.int32)
    j_un = ref.encode_text(jtree, jnp.asarray(un), jcfg)[0]
    jkw = {k: (jnp.asarray(v, jnp.float32) if k == "pag_scale" else v)
           for k, v in kw.items()}
    theirs = ref.generate(jtree, jnp.asarray(_tokens(b, tcfg), jnp.int32),
                          j_un, _noise(b, tcfg)[0],
                          jnp.asarray(guidance, jnp.float32), cfg=jcfg,
                          sampler=sampler, steps=steps, use_cfg=True,
                          output="latent", **jkw)
    ours = _port_latents(tcfg, steps, sampler, b, guidance, fused, **kw)
    return ours, np.asarray(theirs)


KNOB_CASES = {
    "cfg_interval": (dict(steps=5), dict(cfg_interval=(0.2, 0.8))),
    "rescale": (dict(guidance_rescale=0.7), {}),
    "rescale_v": (dict(guidance_rescale=0.7, prediction="v"), {}),
    "pag_mid": ({}, dict(pag_scale=3.0, pag_layers=("mid",))),
    "pag_down_up": ({}, dict(pag_scale=3.0, pag_layers=("down", "up"))),
    "pag_v_interval": (dict(prediction="v", steps=4),
                       dict(pag_scale=2.0, pag_layers=("mid",),
                            cfg_interval=(0.25, 0.75))),
    "deepcache": (dict(deepcache_interval=2, steps=4), {}),
    "deepcache_interval": (dict(deepcache_interval=2, steps=6),
                           dict(cfg_interval=(0.2, 0.7))),
    "freeu": (dict(unet=dict(freeu=(1.5, 1.6, 0.9, 0.2))), {}),
    "tome": (dict(unet=dict(tome_ratio=0.5, tome_min_tokens=64)), {}),
    "size": (dict(latent_size=16), {}),
    "fuse_qkv": (dict(fused=True), dict(pag_scale=1.5,
                                        pag_layers=("down", "mid", "up"))),
    "heun_interval": (dict(sampler="heun", steps=4),
                      dict(cfg_interval=(0.25, 0.75))),
}


@pytest.mark.parametrize("case", sorted(KNOB_CASES))
def test_generate_knob_matches_jax(ref, case):
    """``pipeline.generate`` under each knob (and the compositions the
    reference allows) against the reference's, within 1e-4 of its
    latents' max-abs; and each knob moves the result."""
    cfg_kw, kw = KNOB_CASES[case]
    cfg_kw = dict(cfg_kw)
    run = {k: cfg_kw.pop(k) for k in ("steps", "sampler", "fused")
           if k in cfg_kw}
    jcfg, tcfg = _both(**cfg_kw)
    ours, theirs = _generate_pair(ref, jcfg, tcfg, **run, **kw)
    assert_close(ours, theirs)
    if case != "size":
        plain = _port_latents(dataclasses.replace(
            TINY_T, prediction=tcfg.prediction), **run)
        assert not torch.equal(ours, plain)


def test_per_sample_pag_scale_matches_jax(ref):
    """A batch of two with a PAG scale each (one of them 0.0), against the
    reference's per-sample scale."""
    ours, theirs = _generate_pair(ref, TINY_J, TINY_T, b=2,
                                  guidance=[7.5, 4.0],
                                  pag_scale=[2.5, 0.0], pag_layers=("mid",))
    assert_close(ours, theirs)


def test_image_paths_take_the_knobs_as_the_reference(ref):
    """img2img with the CFG interval and PAG, inpaint with the interval,
    against the reference's, on its draws (its posterior and pin
    draws)."""
    jtree, ttree = trees()
    tok = _tokens(1, TINY_T)
    un = np.zeros((1, TINY_T.clip.context_len), np.int64)
    j_un = ref.encode_text(jtree, jnp.asarray(un, jnp.int32), TINY_J)[0]
    t_un = t_pipeline.encode_text(ttree, torch.from_numpy(un), TINY_T)[0]
    size = TINY_T.image_size
    img = np.random.default_rng(7).uniform(-1, 1, (1, size, size, 3)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(5)
    shape = (1, 8, 8, 4)
    fold = functools.partial(jax.random.fold_in, key)
    draws = {"noise": np.array(_normal_draw(key, shape)),
             "posterior_noise": np.array(_normal_draw(fold(1 << 20), shape))}
    seen = []
    real = ref.decode_latents
    mp = pytest.MonkeyPatch()
    mp.setattr(ref, "decode_latents",
               lambda p, x, cfg, k="xla": seen.append(np.asarray(x)) or real(
                   p, x, cfg, k))
    try:
        ref.img2img(jtree, jnp.asarray(tok, jnp.int32), j_un, key,
                    jnp.float32(7.5), jnp.asarray(img), cfg=TINY_J,
                    steps=4, start_step=1, cfg_interval=(0.3, 0.8),
                    pag_scale=jnp.float32(2.0), pag_layers=("mid",))
        mask = np.zeros((1, size, size, 1), np.float32)
        mask[:, : size // 2] = 1.0
        pins = np.stack([np.array(_normal_draw(fold(1 + i), shape))
                         for i in range(4)])
        ref.inpaint(jtree, jnp.asarray(tok, jnp.int32), j_un, key,
                    jnp.float32(7.5), jnp.asarray(img), jnp.asarray(mask),
                    cfg=TINY_J, steps=4, start_step=0,
                    cfg_interval=(0.3, 0.8))
    finally:
        mp.undo()
    ours = t_pipeline.img2img(
        ttree, torch.from_numpy(tok), t_un, None, 7.5, torch.from_numpy(img),
        cfg=TINY_T, steps=4, start_step=1, output="latent",
        cfg_interval=(0.3, 0.8), pag_scale=2.0, pag_layers=("mid",), **draws)
    assert_close(ours, seen[0])
    ours = t_pipeline.inpaint(
        ttree, torch.from_numpy(tok), t_un, None, 7.5, torch.from_numpy(img),
        torch.from_numpy(mask), cfg=TINY_T, steps=4, start_step=0,
        output="latent", cfg_interval=(0.3, 0.8), pin_noise=pins, **draws)
    assert_close(ours, seen[1])


@pytest.mark.parametrize("steps,start,interval,want", [
    (20, 0, (0.2, 0.8), [(0, 4, False), (4, 16, True), (16, 20, False)]),
    (8, 0, (0.2, 0.8), [(0, 2, False), (2, 6, True), (6, 8, False)]),
    (8, 3, (0.2, 0.8), [(3, 6, True), (6, 8, False)]),
    (8, 0, (0.0, 1.0), [(0, 8, True)]),
    (5, 1, (0.5, 0.9), [(1, 2, False), (2, 4, True), (4, 5, False)]),
])
def test_segments_are_the_references_split(steps, start, interval, want):
    """``round`` is Python's (half to even) on both sides: 2.5 -> 2."""
    assert t_pipeline.segments(steps, start, interval) == want
    assert t_pipeline.segments(steps, start) == [(start, steps, True)]


def test_knobs_at_their_defaults_change_nothing():
    """Each knob off gives the bytes of the knob-free call: the interval
    (0, 1), a ToMe ratio whose gate never opens (TINY's 64 tokens < 4096),
    PAG's 0.0 batch-mates."""
    c = Context(config="tiny", steps=3, device="cpu")
    a = c.generate(PROMPT, seed=4)
    for kw in (dict(cfg_interval=(0.0, 1.0)), dict(tome_ratio=0.5),
               dict(guidance_rescale=0.0), dict(deepcache=None),
               dict(freeu=None), dict(size=16), dict(threads=1),
               dict(log_level=t_slog.LogLevel.NOTHING)):
        assert np.array_equal(Context(config="tiny", steps=3, device="cpu",
                                      **kw).generate(PROMPT, seed=4), a), kw
    c.set_tome_ratio(0.5)
    c.set_deepcache(0)
    c.set_pag_scale(0.0)
    assert np.array_equal(c.generate(PROMPT, seed=4), a)
    two = [{"prompt": PROMPT, "seed": 4}, {"prompt": "a red car", "seed": 5}]
    plain = c.generate_batch(two)
    mixed = c.generate_batch([{**two[0], "pag_scale": 2.0}, two[1]])
    assert np.array_equal(mixed[1], plain[1])
    assert not np.array_equal(mixed[0], plain[0])


# ---------------------------------------------------------------------------
# what does not compose
# ---------------------------------------------------------------------------

INCOMPAT = [
    (dict(pag=True, image_guidance=1.5), {},
     "PAG is incompatible with ip2p's dual CFG"),
    (dict(image_guidance=1.5), dict(deepcache_interval=2),
     "DeepCache is incompatible with ip2p dual CFG"),
    (dict(scheduled=True), dict(deepcache_interval=2),
     "DeepCache is incompatible with prompt scheduling"),
    (dict(pag=True), dict(deepcache_interval=2),
     "DeepCache is incompatible with PAG"),
    (dict(sampler="plms_exact"), dict(deepcache_interval=2),
     "DeepCache is incompatible with plms_exact"),
    (dict(sampler="heun"), dict(deepcache_interval=2),
     "DeepCache is incompatible with two-eval samplers (heun/dpm2)"),
    (dict(sampler="dpm2"), dict(deepcache_interval=2),
     "DeepCache is incompatible with two-eval samplers (heun/dpm2)"),
    ({}, dict(deepcache_interval=1), "deepcache_interval must be >= 2, got 1"),
]


@pytest.mark.parametrize("kw,cfg_kw,text", INCOMPAT)
def test_incompatible_knobs_raise_the_references_value_error(ref, kw, cfg_kw,
                                                             text):
    """The port's ``denoise`` raises before any eval; the reference's
    ``denoise`` raises the same text."""
    jcfg, tcfg = _both(**cfg_kw)
    sampler = kw.get("sampler", "dpm")
    ig = kw.get("image_guidance")
    reps = 3 if ig is not None else 2
    _, ttree = trees()
    ctx = torch.zeros((reps, TINY_T.clip.context_len, 32))
    sched = ((torch.zeros((1,) + ctx.shape[:1] + ctx.shape[1:]),
              torch.zeros(3, dtype=torch.int64)) if kw.get("scheduled")
             else None)
    with pytest.raises(ValueError) as ours:
        t_pipeline.denoise(ttree, ctx, 7.5, tcfg, 3, True, noise=None,
                           sampler=sampler, image_guidance=ig,
                           cond_schedule=sched,
                           pag_layers=("mid",) if kw.get("pag") else None)
    jtree, _ = trees()
    with pytest.raises(ValueError) as theirs:
        ref.denoise(jtree, jnp.asarray(ctx.numpy()), jax.random.PRNGKey(0),
                    7.5, jcfg, sampler, 3, True, image_guidance=ig,
                    cond_schedule=None if sched is None else (
                        jnp.zeros((1, 2, 16, 32)), jnp.zeros(3, jnp.int32)),
                    pag_layers=("mid",) if kw.get("pag") else None)
    assert str(ours.value) == str(theirs.value) == text


def test_context_refuses_what_does_not_compose():
    """At the Context the same texts come out as ``INVALID_ARGUMENT``,
    before any work, and the seed does not move."""
    c = Context(config="tiny", steps=3, device="cpu", deepcache=2)
    seed = c.seed
    for call, text in (
            (lambda: c.generate(PROMPT, pag_scale=2.0), "with PAG"),
            (lambda: c.generate_batch([{"prompt": PROMPT,
                                        "pag_scale": 1.0}]), "with PAG"),
            (lambda: c.generate("a [cat:dog:0.5]"), "prompt scheduling")):
        with pytest.raises(SdtpuError) as ei:
            call()
        assert ei.value.code == ErrorCode.INVALID_ARGUMENT
        assert text in str(ei.value)
    assert c.seed == seed
    c.set_deepcache(0)
    c.generate(PROMPT, pag_scale=2.0)
    ip2p = Context(config=t_config.TINY_IP2P, steps=2, device="cpu",
                   deepcache=2)
    img = np.zeros((16, 16, 3), np.uint8)
    with pytest.raises(SdtpuError, match="ip2p dual CFG"):
        ip2p.instruct_pix2pix(PROMPT, img)


# ---------------------------------------------------------------------------
# Context: validation against the reference's texts, the host keywords
# ---------------------------------------------------------------------------

BAD_INIT = [
    dict(size=30), dict(size=0), dict(freeu=(1.0, 1.0)),
    dict(tome_ratio=0.9), dict(tome_ratio=-0.1), dict(deepcache=1),
    dict(deepcache=2.5), dict(guidance_rescale=1.5),
    dict(cfg_interval=(0.8, 0.2)), dict(cfg_interval=(-0.1, 0.5)),
    dict(pag_layers=("side",)), dict(pag_layers=()),
    dict(sampler="nope"), dict(quantize="int4"),
]


@pytest.mark.parametrize("kw", BAD_INIT, ids=lambda kw: repr(kw))
def test_bad_knob_has_the_references_code_and_text(kw):
    """The reference raises these before its init's work (nothing is
    built or compiled), so its text is read from its own Context."""
    with pytest.raises(SdtpuError) as ours:
        Context(config="tiny", steps=2, device="cpu", **kw)
    with pytest.raises(j_errors.SdtpuError) as theirs:
        j_context.Context(config="tiny", steps=2, compile_cache=None, **kw)
    assert ours.value.code == ErrorCode.INVALID_ARGUMENT
    assert int(ours.value.code) == int(theirs.value.code)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("setter,value", [
    ("set_tome_ratio", 0.9), ("set_tome_ratio", -0.2),
    ("set_deepcache", 1), ("set_deepcache", 2.5)])
def test_bad_setter_has_the_references_code_and_text(setter, value):
    c = Context(config="tiny", steps=2, device="cpu")
    cfg = c.cfg
    with pytest.raises(SdtpuError) as ours:
        getattr(c, setter)(value)
    stub = types.SimpleNamespace(errors=j_errors.ErrorTable(), cfg=TINY_J,
                                 _gen_cache={})
    with pytest.raises(j_errors.SdtpuError) as theirs:
        getattr(j_context.Context, setter)(stub, value)
    assert str(ours.value) == str(theirs.value)
    assert c.cfg is cfg


@pytest.mark.parametrize("kw,code,text", [
    (dict(mesh=(2, 2)), ErrorCode.INVALID_ARGUMENT,
     "mesh 2x2 exceeds 1 devices"),
    (dict(lora="a.npz"), ErrorCode.RUNTIME_ERROR, "model load failed")])
def test_unported_keywords_are_refused_naming_their_item(kw, code, text):
    """``mesh``, ported, builds its mesh at init, and a mesh larger than
    the world (one rank without a process group) is refused with the
    reference's ``make_mesh`` text; ``lora``, ported, loads its adapter at
    init, and a file that is not there fails the load as the reference's
    does (``RUNTIME_ERROR``)."""
    with pytest.raises(SdtpuError) as ei:
        Context(config="tiny", device="cpu", **kw)
    assert ei.value.code == code
    assert text in str(ei.value)
    Context(config="tiny", steps=1, device="cpu", mesh=None, lora=None)


def test_setters_set_the_config_and_the_default_pag():
    c = Context(config="tiny", steps=3, device="cpu")
    c.set_tome_ratio(0.25)
    c.set_deepcache(3)
    assert c.cfg.unet.tome_ratio == 0.25 and c.cfg.deepcache_interval == 3
    c.set_tome_ratio(0)
    c.set_deepcache(0)
    assert c.cfg.unet == TINY_T.unet and c.cfg.deepcache_interval is None
    a = c.generate(PROMPT, seed=2, pag_scale=1.5)
    c.set_pag_scale(1.5)
    assert np.array_equal(c.generate(PROMPT, seed=2), a)
    assert c.cfg_interval is None and c.pag_layers == ("mid",)
    c2 = Context(config="tiny", steps=3, device="cpu", pag_layers="up",
                 cfg_interval=(0, 1))
    assert c2.pag_layers == ("up",) and c2.cfg_interval == (0.0, 1.0)


def test_size_overrides_the_grid():
    c = Context(config="tiny", steps=2, device="cpu", size=32)
    assert c.cfg.latent_size == 16 and c.cfg.image_size == 32
    assert c.generate(PROMPT, seed=1).shape == (32, 32, 3)
    with pytest.raises(SdtpuError, match=r"uint8 \(1, 32, 32, 3\)"):
        c.img2img(PROMPT, np.zeros((16, 16, 3), np.uint8))


def test_fuse_qkv_applies_to_an_unquantized_tree_only():
    c = Context(config="tiny", steps=2, device="cpu", fuse_qkv=True)
    st = c.params["unet"]["mid"]["st"]
    assert "qkv" in st["attn1"] and "kv" in st["attn2"]
    plain = Context(config="tiny", steps=2, device="cpu")
    a, b = c.generate(PROMPT, seed=3), plain.generate(PROMPT, seed=3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    q = Context(config="tiny", steps=2, device="cpu", fuse_qkv=True,
                quantize="int8w")
    assert "q" in q.params["unet"]["mid"]["st"]["attn1"]


def test_generate_async_returns_a_finish_handle():
    c = Context(config="tiny", steps=2, device="cpu")
    finish = c.generate_async(PROMPT, seed=6)
    out = finish()
    assert out.shape == (1, 16, 16, 3) and out.dtype == np.uint8
    assert np.array_equal(out[0], c.generate(PROMPT, seed=6))
    seed = c.seed
    c.generate_async([PROMPT, "a red car"])
    assert c.seed == seed + 1
    with pytest.raises(SdtpuError) as ei:
        c.generate_async(PROMPT, lora="x")
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT


def test_threads_and_log_level_are_the_references(monkeypatch):
    """``threads > 1`` loads the models and the tokenizer on two workers
    (the bytes do not change); ``log_level`` INFO writes the reference's
    info lines to the context's logger; nothing is written under
    ``compile_cache``."""
    import threading

    seen = set()
    real = Context._load_tokenizer

    def tok(self):
        seen.add(threading.current_thread().name)
        return real(self)

    monkeypatch.setattr(Context, "_load_tokenizer", tok)
    buf = io.StringIO()
    real_logger = t_slog.Logger
    monkeypatch.setattr(t_slog, "Logger", lambda level, name: real_logger(
        level, name=name, stream=buf))
    c = Context(config="tiny", steps=2, device="cpu", threads=3,
                log_level=t_slog.LogLevel.INFO, compile_cache="/nonexistent")
    assert seen and all(n != threading.main_thread().name for n in seen)
    c.generate(PROMPT, seed=1)
    text = buf.getvalue()
    for line in ("no model_dir: random-init demo weights", "models loaded in",
                 "initialized in", "image generation took"):
        assert line in text
    one = Context(config="tiny", steps=2, device="cpu", threads=1)
    assert np.array_equal(one.generate(PROMPT, seed=1),
                          c.generate(PROMPT, seed=1))
    assert not Path("/nonexistent").exists()
    assert torch.get_num_threads() == 1
