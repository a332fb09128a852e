"""The port's SD v1.5 txt2img slice against the JAX package, module by
module and end to end, at TINY in float32 on the CPU.

Both sides get the same weights (the port's random init in the JAX
package's layout, ``sdtpu_torch.io.params.to_jax_tree``, carried back by
``from_jax_tree``) and the same inputs, made with numpy from a fixed seed.
Unless a test says otherwise the tolerance is max-abs error <= 1e-4 x the
reference output's max-abs: both sides compute in float32 (TF32 off,
HIGHEST precision in JAX), and only the order of summation differs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu import config as j_config
from sdtpu.engine import pipeline as j_pipeline
from sdtpu.engine.context import DEMO_MERGES as J_DEMO_MERGES
from sdtpu.io.params import init_pipeline_params as j_init_params
from sdtpu.models import clip as j_clip
from sdtpu.models import layers as j_layers
from sdtpu.models import temb as j_temb
from sdtpu.models import unet as j_unet
from sdtpu.models import vae as j_vae
from sdtpu.samplers import NoiseSchedule as JNoiseSchedule
from sdtpu.samplers import dpm as j_dpm
from sdtpu.tokenizer import Tokenizer as JTokenizer
from sdtpu_torch import Context, ErrorCode, SdtpuError
from sdtpu_torch import config as t_config
from sdtpu_torch.engine import pipeline as t_pipeline
from sdtpu_torch.io.params import (from_jax_tree, init_pipeline_params,
                                   to_jax_tree)
from sdtpu_torch.models import clip as t_clip
from sdtpu_torch.models import layers as t_layers
from sdtpu_torch.models import temb as t_temb
from sdtpu_torch.models import unet as t_unet
from sdtpu_torch.models import vae as t_vae
from sdtpu_torch.samplers import dpm as t_dpm
from sdtpu_torch.samplers.schedule import NoiseSchedule as TNoiseSchedule
from sdtpu_torch.tokenizer import DEMO_MERGES, Tokenizer


#: XLA:CPU compiles at backend optimization level 0: the same arithmetic,
#: compiled in a fraction of the time
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})

TINY_J, TINY_T = j_config.TINY, t_config.TINY
PROMPT = "a photograph of an astronaut riding a horse"


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


@pytest.fixture(scope="module")
def trees():
    """(the JAX package's tree as numpy, the port's tree) for TINY: the
    port's random init in the JAX layout (``to_jax_tree``), carried back by
    ``from_jax_tree``. The JAX package's own init of the same tree takes
    some 40 s on the CPU; ``test_torch_slice.py::
    test_port_init_has_jax_tree_shapes`` holds both inits to one tree."""
    jtree = to_jax_tree(init_pipeline_params(
        TINY_T, torch.Generator().manual_seed(0), "cpu"))
    return jtree, from_jax_tree(jtree, TINY_T)


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


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


# ---------------------------------------------------------------------------
# host-only modules carried over
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["SD15", "TINY"])
def test_config_matches_jax(name):
    ours, ref = getattr(t_config, name), getattr(j_config, name)
    for sub in ("clip", "unet", "vae", None):
        o = getattr(ours, sub) if sub else ours
        r = getattr(ref, sub) if sub else ref
        for f in dataclasses.fields(o):
            if f.name in ("clip", "unet", "vae"):
                continue
            assert getattr(o, f.name) == getattr(r, f.name), (sub, f.name)
    assert ours.image_size == ref.image_size
    assert str(ours.compute_dtype).split(".")[-1] == str(ref.compute_dtype)


@pytest.mark.parametrize("text", [
    PROMPT, "", "The horse's rider, 2024!", "  ÉTÉ   naïve\tcafé  ",
    "x" * 300])
def test_tokenizer_ids_match_jax(text):
    assert DEMO_MERGES == J_DEMO_MERGES
    ours = Tokenizer.from_merges(DEMO_MERGES).tokenize(text, 16)
    assert ours == JTokenizer.from_merges(J_DEMO_MERGES).tokenize(text, 16)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _dense_p(d_in, d_out, bias=True, seed=1):
    p = {"w": _rand(d_in, d_out, seed=seed)}
    if bias:
        p["b"] = _rand(d_out, seed=seed + 1)
    return p


def _conv_p(k, c_in, c_out, seed=1):
    return {"w": _rand(k, k, c_in, c_out, seed=seed),
            "b": _rand(c_out, seed=seed + 1)}


def _port_p(p):
    out = {k: _t(v) for k, v in p.items()}
    if "w" in out and out["w"].dim() == 4:
        out["w"] = out["w"].permute(3, 2, 0, 1)
    return out


_NORM = {"scale": _rand(24, seed=5) + 1.0, "bias": _rand(24, seed=6)}


@pytest.mark.parametrize("case", [
    "dense", "dense_nobias", "conv3x3", "conv3x3_s2", "conv1x1",
    "layer_norm", "group_norm_1e-5", "group_norm_1e-6", "silu",
    "quick_gelu", "geglu", "sdpa", "causal_sdpa", "timestep_features"])
def test_layers_match_jax(case):
    x = _rand(2, 6, 6, 24)
    x3 = x.reshape(2, 18, 48)
    if case.startswith("dense"):
        p = _dense_p(48, 40, bias=case == "dense")
        ref = j_layers.dense(p, jnp.asarray(x3))
        ours = t_layers.dense(_port_p(p), _t(x3))
    elif case.startswith("conv"):
        k = 1 if case == "conv1x1" else 3
        stride = 2 if case.endswith("s2") else 1
        p = _conv_p(k, 24, 16)
        ref = j_layers.conv2d(p, jnp.asarray(x), stride, k // 2)
        ours = t_layers.conv2d(_port_p(p), _t(x), stride, k // 2)
    elif case == "layer_norm":
        ref = j_layers.layer_norm(_NORM, jnp.asarray(x))
        ours = t_layers.layer_norm(_port_p(_NORM), _t(x))
    elif case.startswith("group_norm"):
        eps = float(case.split("_")[-1])
        ref = j_layers.group_norm(_NORM, jnp.asarray(x), 4, eps)
        ours = t_layers.group_norm(_port_p(_NORM), _t(x), 4, eps)
    elif case in ("silu", "quick_gelu"):
        ref = getattr(j_layers, case)(jnp.asarray(x))
        ours = getattr(t_layers, case)(_t(x))
    elif case == "geglu":
        p = _dense_p(48, 64)
        ref = j_layers.geglu(p, jnp.asarray(x3))
        ours = t_layers.geglu(_port_p(p), _t(x3))
    elif case == "sdpa":
        q, k, v = x3, _rand(2, 7, 48, seed=2), _rand(2, 7, 48, seed=3)
        ref = j_layers.sdpa(*map(jnp.asarray, (q, k, v)), 4, kernel="xla")
        ours = t_layers.sdpa(_t(q), _t(k), _t(v), 4)
    elif case == "causal_sdpa":
        k, v = _rand(2, 18, 48, seed=2), _rand(2, 18, 48, seed=3)
        ref = j_layers.causal_sdpa(*map(jnp.asarray, (x3, k, v)), 2)
        ours = t_layers.causal_sdpa(_t(x3), _t(k), _t(v), 2)
    else:
        t = np.array([999.0, 500.5, 0.0, 37.0], np.float32)
        ref = j_layers.timestep_features(jnp.asarray(t), 32)
        ours = t_layers.timestep_features(_t(t), 32)
    assert_close(ours, ref)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def test_temb_matches_jax(trees):
    jtree, ttree = trees
    t = t_dpm.plan(TNoiseSchedule.sd_v1(), 20, device="cpu").model_t
    ref = j_temb.apply(jtree["temb"], jnp.asarray(t.numpy()), TINY_J.unet)
    assert_close(t_temb.apply(ttree["temb"], t, TINY_T.unet), ref)


def test_clip_matches_jax(trees):
    jtree, ttree = trees
    tok = np.random.default_rng(0).integers(
        0, TINY_J.clip.vocab_size, (2, TINY_J.clip.context_len))
    ref = _jit(functools.partial(j_clip.apply, cfg=TINY_J.clip))(
        jtree["clip"], jnp.asarray(tok, jnp.int32))
    ours = t_clip.apply(ttree["clip"], torch.from_numpy(tok), TINY_T.clip)
    assert_close(ours, ref)


def test_unet_matches_jax(trees):
    jtree, ttree = trees
    x, te = _rand(2, 8, 8, 4, seed=1), _rand(2, 64, seed=2)
    ctx = _rand(2, 16, 32, seed=3)
    ref = _jit(functools.partial(j_unet.apply, cfg=TINY_J.unet))(
        jtree["unet"], jnp.asarray(x), jnp.asarray(te), jnp.asarray(ctx))
    for kernels in ("plain", "cuda"):   # "cuda" on CPU tensors: plain too
        ours = t_unet.apply(ttree["unet"], _t(x), _t(te), _t(ctx),
                            TINY_T.unet, kernels)
        assert_close(ours, ref)


def test_vae_matches_jax(trees):
    jtree, ttree = trees
    z = _rand(1, 8, 8, 4, seed=4)
    ref = _jit(functools.partial(j_vae.apply, cfg=TINY_J.vae))(
        jtree["vae"], jnp.asarray(z))
    assert_close(t_vae.apply(ttree["vae"], _t(z), TINY_T.vae), ref)


def test_port_init_has_jax_tree_shapes(trees):
    """The port's own init builds the JAX package's tree (shapes, keys:
    the JAX init traced, not run); ``to_jax_tree`` gives it the JAX
    package's layout, and from_jax_tree raises on any difference."""
    jtree, _ = trees
    shapes = jax.eval_shape(lambda k: j_init_params(k, TINY_J),
                            jax.random.PRNGKey(0))
    ref = {k: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes[k])
           for k in ("clip", "temb", "unet", "vae", "vae_enc")}
    ours = init_pipeline_params(TINY_T, torch.Generator().manual_seed(0),
                                "cpu")
    conv = from_jax_tree(ref, TINY_T)
    flat_o = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_c = jax.tree_util.tree_flatten_with_path(conv)[0]
    assert [(p, tuple(a.shape)) for p, a in flat_o] == [
        (p, tuple(a.shape)) for p, a in flat_c]
    flat_j = jax.tree_util.tree_flatten_with_path(to_jax_tree(ours))[0]
    assert [(p, a.shape) for p, a in flat_j] == [
        (p, a.shape) for p, a in jax.tree_util.tree_flatten_with_path(ref)[0]]
    with pytest.raises(ValueError):
        bad = dict(jtree, temb={"fc0": jtree["temb"]["fc0"]})
        from_jax_tree(bad, TINY_T)


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

def test_dpm_plan_and_step_match_jax():
    steps = 20
    ours = t_dpm.plan(TNoiseSchedule.sd_v1(), steps, device="cpu")
    ref = j_dpm.plan(JNoiseSchedule.sd_v1(), steps)
    for name in ref._fields:
        # the same float64 numpy math, cast once to float32: bit-equal
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    x, eps, prev = (_rand(1, 8, 8, 4, seed=s) for s in (1, 2, 3))
    for i in (0, 7):
        jx, js = j_dpm.step(ref, i, jnp.asarray(x), jnp.asarray(eps),
                            j_dpm.State(prev_y=jnp.asarray(prev)))
        tx, ts = t_dpm.step(ours, i, _t(x), _t(eps),
                            t_dpm.State(prev_y=_t(prev)))
        assert_close(tx, jx, rel=1e-6)
        assert_close(ts.prev_y, js.prev_y, rel=1e-6)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def test_generate_matches_jax(trees):
    jtree, ttree = trees
    steps, seed, guidance = 4, 7, 7.5
    tok = JTokenizer.from_merges(J_DEMO_MERGES)
    L = TINY_J.clip.context_len
    jtok = jnp.asarray([tok.tokenize(PROMPT, L)], jnp.int32)
    j_unc = _jit(functools.partial(j_pipeline.encode_text, cfg=TINY_J))(
        jtree, jnp.asarray([tok.tokenize("", L)], jnp.int32))[0]
    j_gen = _jit(functools.partial(
        j_pipeline.generate, cfg=TINY_J, sampler="dpm", steps=steps,
        kernels="xla", output="latent"))
    key = jax.random.PRNGKey(seed)
    j_lat = j_gen(jtree, jtok, j_unc, key, jnp.float32(guidance))
    j_img = np.asarray(_jit(functools.partial(
        j_pipeline.decode_latents, cfg=TINY_J))(jtree, j_lat))
    shape = (1, TINY_J.latent_size, TINY_J.latent_size,
             TINY_J.latent_channels)
    noise = np.array(jax.random.normal(key, shape, jnp.float32))

    ttok = torch.tensor(np.asarray(jtok), dtype=torch.int64)
    t_unc = t_pipeline.encode_text(
        ttree, torch.tensor([tok.tokenize("", L)]), TINY_T)[0]
    assert_close(t_unc, j_unc)
    run = functools.partial(t_pipeline.generate, ttree, ttok, t_unc, None,
                            guidance, cfg=TINY_T, steps=steps,
                            kernels="cuda", noise=noise)
    assert_close(run(output="latent"), j_lat)
    t_img = run().numpy()
    assert t_img.dtype == np.uint8 and t_img.shape == j_img.shape
    # rounding to uint8 may split a value that sits on a .5 boundary
    assert np.abs(t_img.astype(int) - j_img.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ctx():
    return Context(config="tiny", steps=3, device="cpu")


def test_context_generate(ctx):
    img = ctx.generate(PROMPT, guidance=7.5, seed=3)
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    assert img.std() > 0
    assert np.array_equal(img, ctx.generate(PROMPT, guidance=7.5, seed=3))
    buf = np.zeros_like(img)
    assert ctx.generate(PROMPT, guidance=7.5, seed=3, out=buf) is buf
    assert np.array_equal(buf, img)
    lat = ctx.generate(PROMPT, seed=3, output="latent")
    assert lat.shape == (8, 8, 4) and np.isfinite(lat).all()
    ctx.set_seed(11)
    a = ctx.generate(PROMPT)
    assert ctx.seed == 12
    assert np.array_equal(a, ctx.generate(PROMPT, seed=11))


@pytest.mark.parametrize("kwargs", [
    {"sampler": "nope"}, {"steps": 0}, {"clip_skip": 0},
    {"kernels": "pallas"}, {"cfg_interval": (0.8, 0.2)}])
def test_context_invalid_arguments(kwargs):
    with pytest.raises(SdtpuError) as ei:
        Context(**{"config": "tiny", **kwargs}, device="cpu")
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT


def test_context_set_steps_rejects_zero(ctx):
    with pytest.raises(SdtpuError) as ei:
        ctx.set_steps(0)
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert ctx.steps == 3


def test_failed_phase_latches_context(monkeypatch):
    from sdtpu_torch.engine import context as t_context

    c = Context(config="tiny", steps=2, device="cpu")
    with pytest.raises(SdtpuError) as ei:
        c._fail(ErrorCode.RUNTIME_ERROR, "a phase failed")
    assert ei.value.code == ErrorCode.RUNTIME_ERROR
    with pytest.raises(SdtpuError) as ei:
        c.generate(PROMPT)
    assert ei.value.code == ErrorCode.INVALID_CONTEXT
    assert "failed" in c.last_error(ErrorCode.INVALID_CONTEXT)

    def broken(*_a, **_kw):
        raise OSError("no merges")

    monkeypatch.setattr(t_context.Tokenizer, "from_merges", broken)
    with pytest.raises(SdtpuError) as ei:
        Context(config="tiny", device="cpu")
    assert ei.value.code == ErrorCode.RUNTIME_ERROR
