"""The port's staged configurations against the JAX package, at TINY in
float32 on the CPU:

* LCM (TINY_LCM): the guidance-scale features, the time MLP's guidance
  projection in its scalar, "outer" and "aligned" forms, the loop with the
  guidance embedded (a scalar and one a sample) and no CFG batch, the
  refusal of a CFG batch, and one UNet row a request in every ``Context``
  entry point;
* the SDXL refiner (TINY_XL_REF): the tree without ``clip``, the
  single-tower text encode (plain and chunked), five micro-conditions,
  ``generate(end_step=)``, ``refine`` from a start step, ``refine`` from
  ``generate``'s own start latents, a split trajectory of a stateless
  sampler, the base-to-refiner handoff from TINY_XL and the validation
  texts of ``refine`` and ``denoising_end``;
* the x4 upscaler (TINY_X4): the cross-only basic block (plain, under ToMe
  on its query rows, left alone by PAG), its fused projection, the noise
  augmentation and ``upscale`` (one level, and one a sample), its
  validation texts;
* the three configurations' LDM files (``time_embed.cond_proj``,
  ``label_emb``, the refiner's ``conditioner.embedders.0``), native files
  both ways and the converter.

Both sides get the same weights: the port's own random init, carried to the
JAX package's layout by ``io.params.to_jax_tree``. Inputs are made with
numpy from a fixed seed; the JAX package's threefry draws reach the port
through the pipeline functions' seams (``noise=``, ``step_noise=``,
``aug_noise=``). The reference's pipeline functions run with their
``lax.scan`` taken as a Python loop and their models jitted once per shape,
as ``tests/test_torch_image.py`` runs them. Modules are held within 1e-5 of
the reference's max-abs (the guidance features within two float32 ulps of
their largest argument, up to 8,000), loops within 1e-4, images within 1,
loads exactly.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu import config as j_config
from sdtpu.engine import context as j_context
from sdtpu.engine import errors as j_errors
from sdtpu.engine import logging as j_slog
from sdtpu.engine import pipeline as j_pipeline
from sdtpu.io import params as j_params
from sdtpu.io import weights as j_weights
from sdtpu.models import temb as j_temb
from sdtpu.models import unet as j_unet
from sdtpu.models import vae as j_vae
from sdtpu_torch import Context, ErrorCode, SdtpuError
from sdtpu_torch import config as t_config
from sdtpu_torch.engine import pipeline as t_pipeline
from sdtpu_torch.io import safetensors as t_st
from sdtpu_torch.io import weights as t_weights
from sdtpu_torch.io.params import (fuse_attention_projections, from_jax_tree,
                                   init_pipeline_params, jax_layout,
                                   to_jax_tree, tree_names)
from sdtpu_torch.models import layers as t_layers
from sdtpu_torch.models import temb as t_temb
from sdtpu_torch.models import unet as t_unet
from sdtpu_torch.tokenizer import DEMO_MERGES, Tokenizer
from test_torch_image import (_encode_text_once, _jit, _normal_draw,
                              _reference_latents, _scan_as_loop)

STEPS = 4
PROMPT = "a photograph of an astronaut riding a horse"
# the JAX package's fold_in tags: a NEEDS_NOISE sampler's step i, and the
# x4 upscaler's augmentation draw (sdtpu/engine/pipeline.py:737-746, 982)
ANCESTRAL_FOLD, AUG_FOLD = 1 << 21, 1 << 23

# name -> (the JAX config, the port's)
CFGS = {name: (getattr(j_config, attr), getattr(t_config, attr))
        for name, attr in (("lcm", "TINY_LCM"), ("xl", "TINY_XL"),
                           ("ref", "TINY_XL_REF"), ("x4", "TINY_X4"),
                           ("tiny", "TINY"))}


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


_TREES = {}


def trees(name):
    """(the JAX layout as jnp arrays, the port's tree) of one init of
    ``CFGS[name]``, made once."""
    if name not in _TREES:
        ttree = init_pipeline_params(CFGS[name][1],
                                     torch.Generator().manual_seed(0), "cpu")
        _TREES[name] = (jax.tree.map(jnp.asarray, to_jax_tree(ttree)), ttree)
    return _TREES[name]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's pipeline module with its scan taken as a loop and
    its models jitted once per shape."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.lax, "scan", _scan_as_loop)
    mp.setattr(jax.random, "normal", _normal_draw)
    mp.setattr(j_unet, "apply", _jit(
        j_unet.apply, static_argnums=(4, 5),
        static_argnames=("deep", "perturb")))
    mp.setattr(j_vae, "apply", _jit(j_vae.apply, static_argnums=(2, 3)))
    mp.setattr(j_pipeline, "encode_text", _encode_text_once)
    yield j_pipeline
    mp.undo()


@pytest.fixture(scope="module")
def tok():
    return Tokenizer.from_merges(DEMO_MERGES)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def assert_close(ours, ref, rel=1e-5):
    ours, ref = _np(ours), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    tol = rel * float(np.abs(ref).max())
    assert err <= tol, f"max-abs err {err:.3g} > {tol:.3g}"


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def assert_trees_equal(ours, ref):
    a, b = dict(_leaves(ours)), dict(_leaves(ref))
    assert a.keys() == b.keys()
    for path, t in a.items():
        assert t.dtype == b[path].dtype and t.shape == b[path].shape, path
        assert torch.equal(t, b[path]), path


def _text(name, tok, prompts=(PROMPT,)):
    """(tokens [B, T] int64, the uncond embedding of each side)."""
    jcfg, tcfg = CFGS[name]
    jtree, ttree = trees(name)
    L = tcfg.clip.context_len
    tokens = np.array([tok.tokenize(p, L) for p in prompts], np.int64)
    un = np.array([tok.tokenize("", L)], np.int64)
    j_un = j_pipeline.encode_text(jtree, jnp.asarray(un, jnp.int32), jcfg)[0]
    t_un = t_pipeline.encode_text(ttree, torch.from_numpy(un), tcfg)[0]
    return tokens, j_un, t_un


def _keys(seeds):
    """One PRNG key, or one a sample (the reference's batched serving)."""
    if isinstance(seeds, int):
        return jax.random.PRNGKey(seeds)
    return jnp.stack([jax.random.PRNGKey(s) for s in seeds])


def _draw(key, fold, shape):
    k = key if fold is None else jax.random.fold_in(key, fold)
    return np.array(_normal_draw(k, shape))


def _jax_draws(seeds, shape, steps=STEPS, image_shape=None):
    """The reference's draws of a key (or of one key a sample, stacked on
    the batch): the start latents, the ancestral step noise [steps, ...]
    and, with ``image_shape``, the upscaler's augmentation."""
    keys = [jax.random.PRNGKey(seeds)] if isinstance(seeds, int) else [
        jax.random.PRNGKey(s) for s in seeds]
    per = shape if len(keys) == 1 else (1,) + tuple(shape[1:])
    out = {"noise": np.concatenate([_draw(k, None, per) for k in keys]),
           "step_noise": np.stack([np.concatenate(
               [_draw(k, ANCESTRAL_FOLD + i, per) for k in keys])
               for i in range(steps)])}
    if image_shape is not None:
        ip = (image_shape if len(keys) == 1
              else (1,) + tuple(image_shape[1:]))
        out["aug_noise"] = np.concatenate([_draw(k, AUG_FOLD, ip)
                                           for k in keys])
    return out


def _shape(cfg, b=1):
    return (b, cfg.latent_size, cfg.latent_size, cfg.latent_channels)


def _check_image(t_lat, j_img, params, cfg):
    img = t_pipeline.decode_latents(params, t_lat, cfg).numpy()
    assert img.dtype == np.uint8 and img.shape == j_img.shape
    assert np.abs(img.astype(int) - j_img.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# configurations and trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["SD15_LCM", "SD_X4", "SDXL_REFINER",
                                  "TINY_LCM", "TINY_X4", "TINY_XL_REF"])
def test_config_matches_jax(name):
    """Every field the port carries is the reference's, tower by tower; the
    depth helpers agree level by level (the refiner's mid block takes the
    deepest attention level's depth)."""
    ours, ref = getattr(t_config, name), getattr(j_config, name)
    for sub in ("clip", "clip2", "unet", "vae", None):
        o = getattr(ours, sub) if sub else ours
        r = getattr(ref, sub) if sub else ref
        assert (o is None) == (r is None), sub
        if o is None:
            continue
        for f in dataclasses.fields(o):
            if f.name in ("clip", "clip2", "unet", "vae"):
                continue
            assert getattr(o, f.name) == getattr(r, f.name), (sub, f.name)
    for lvl in range(len(ref.unet.channel_mult)):
        assert ours.unet.depth_at(lvl) == ref.unet.depth_at(lvl)
    assert ours.unet.mid_depth() == ref.unet.mid_depth()
    assert ours.image_size == ref.image_size


@pytest.mark.parametrize("name", ["lcm", "ref", "x4"])
def test_trees_have_the_references_leaves(name):
    """The tree's names and every leaf's path and shape are the reference
    init's (abstract, nothing computed): no ``clip`` in the refiner's,
    ``temb.cond_proj`` in LCM's, ``unet.label_emb`` in the x4 upscaler's;
    ``from_jax_tree`` of ``to_jax_tree`` gives the tree back exactly."""
    jcfg, tcfg = CFGS[name]
    shapes = jax.eval_shape(
        lambda k: j_params.init_pipeline_params(k, jcfg),
        jax.random.PRNGKey(0))
    jtree, ttree = trees(name)
    assert set(tree_names(tcfg)) == set(shapes)
    want = {p: tuple(s.shape) for p, s in _leaves(shapes)}
    got = {p: tuple(t.shape) for p, t in _leaves(jax_layout(ttree))}
    assert got == want
    extra = {"lcm": ("temb", "cond_proj", "w"),
             "x4": ("unet", "label_emb"), "ref": ("clip2", "text_proj")}
    assert extra[name] in got
    assert ("clip" in ttree) == (name != "ref")
    assert_trees_equal(from_jax_tree(to_jax_tree(ttree), tcfg), ttree)


# ---------------------------------------------------------------------------
# LCM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,w", [(8, 7.0), (256, 7.0), (8, [0.0, 3.5]),
                                   (256, [0.5, 1.0, 8.0])])
def test_guidance_scale_features_match_jax(dim, w):
    """``[sin | cos]`` halves of ``w * 1000 * exp(-log(10000) j / (half -
    1))``: the reference's, and its formula in float64, within two float32
    ulps of the largest argument (an argument rounded one ulp apart moves a
    sine by as much: 4.9e-4 at 8,000)."""
    ours = _np(t_temb.guidance_scale_features(w, dim))
    tol = 2 * float(np.spacing(np.float32(1000 * np.max(w))))
    theirs = np.asarray(j_temb.guidance_scale_features(
        jnp.asarray(w, jnp.float32), dim))
    half = dim // 2
    args = (np.asarray(w, np.float64)[..., None] * 1000.0 * np.exp(
        -np.log(10000.0) * np.arange(half) / (half - 1)))
    exact = np.concatenate([np.sin(args), np.cos(args)], -1)
    assert ours.shape == theirs.shape == exact.shape
    assert np.abs(ours - theirs).max() <= tol
    assert np.abs(ours - exact).max() <= tol


@pytest.mark.parametrize("form", ["none", "scalar", "outer", "aligned"])
def test_temb_apply_with_the_guidance_matches_jax(form):
    """The time MLP with no guidance, one ([F]), one a sample against
    every step ([B, F] with t [steps] -> [steps, B, D]) and one a sample
    zipped with its own timestep ([B] with [B, F])."""
    jcfg, tcfg = CFGS["lcm"]
    jtree, ttree = trees("lcm")
    t = np.array([999.0, 759.0, 499.0], np.float32)
    cond = {"none": None, "scalar": _rand(8, seed=1),
            "outer": _rand(2, 8, seed=2), "aligned": _rand(3, 8, seed=3)}[
        form]
    align = "aligned" if form == "aligned" else "outer"
    ours = t_temb.apply(ttree["temb"], torch.from_numpy(t), tcfg.unet,
                        cond=None if cond is None else torch.from_numpy(cond),
                        cond_align=align)
    theirs = j_temb.apply(jtree["temb"], jnp.asarray(t), jcfg.unet,
                          cond=None if cond is None else jnp.asarray(cond),
                          cond_align=align)
    assert ours.shape == theirs.shape == {"outer": (3, 2, 64)}.get(
        form, (3, 64))
    assert_close(ours, theirs)


@pytest.mark.parametrize("per_sample", [False, True])
def test_lcm_generate_matches_jax(ref, tok, per_sample):
    """A 4-step TINY_LCM ``generate`` under the lcm sampler with the
    guidance embedded and no CFG batch, at one guidance and at one a
    sample (a key each), against the reference's with its draws injected:
    latents within 1e-4, images within 1."""
    jcfg, tcfg = CFGS["lcm"]
    jtree, ttree = trees("lcm")
    prompts = (PROMPT, "a watercolor of a lighthouse") if per_sample else (
        PROMPT,)
    tokens, j_un, t_un = _text("lcm", tok, prompts)
    seeds = [5, 6] if per_sample else 5
    guidance = [8.0, 2.5] if per_sample else 8.0
    kw = dict(cfg=jcfg, sampler="lcm", steps=STEPS, use_cfg=False,
              kernels="xla", output="latent")
    j_lat = np.asarray(ref.generate(
        jtree, jnp.asarray(tokens, jnp.int32), j_un, _keys(seeds),
        jnp.asarray(guidance, jnp.float32), **kw))
    d = _jax_draws(seeds, _shape(tcfg, len(prompts)))
    t_lat = t_pipeline.generate(
        ttree, torch.from_numpy(tokens), t_un, None, guidance, cfg=tcfg,
        sampler="lcm", steps=STEPS, use_cfg=False, noise=d["noise"],
        step_noise=d["step_noise"], output="latent")
    assert_close(t_lat, j_lat, rel=1e-4)
    j_img = np.asarray(j_pipeline.decode_latents(jtree, j_lat, jcfg))
    _check_image(t_lat, j_img, ttree, tcfg)


def test_cfg_batch_on_a_guidance_embedded_config_has_the_references_text(ref):
    """``denoise`` refuses ``use_cfg`` on an LCM configuration with the
    reference's ``ValueError`` text."""
    jcfg, tcfg = CFGS["lcm"]
    jtree, ttree = trees("lcm")
    ctx = _rand(2, 16, 32, seed=4)
    with pytest.raises(ValueError) as theirs:
        ref.denoise(jtree, jnp.asarray(ctx), jax.random.PRNGKey(0), 8.0,
                    jcfg, "lcm", STEPS, True)
    with pytest.raises(ValueError) as ours:
        t_pipeline.denoise(ttree, torch.from_numpy(ctx), 8.0, tcfg, STEPS,
                           True, noise=torch.zeros(_shape(tcfg)),
                           sampler="lcm",
                           step_noise=torch.zeros((STEPS,) + _shape(tcfg)))
    assert str(ours.value) == str(theirs.value)


@pytest.fixture(scope="module")
def lcm_ctx():
    c = Context(config=t_config.TINY_LCM, steps=2, sampler="lcm",
                device="cpu")
    c.params = trees("lcm")[1]
    c._prepare_buffers()
    return c


_IMG = np.random.default_rng(7).integers(0, 256, (16, 16, 3), dtype=np.uint8)
_MASK = np.zeros((16, 16), np.uint8)
_MASK[:8] = 255
_REQS = [{"prompt": PROMPT, "seed": 1, "guidance": 8.0},
         {"prompt": "a cat", "seed": 2, "guidance": 1.0},
         {"prompt": "a (red:1.3) car", "seed": 3, "guidance": 4.0,
          "negative_prompt": "blurry"}]
_IMG_REQS = [{**r, "image": _IMG, "mask": _MASK} for r in _REQS]

#: entry point -> (the call, UNet rows an eval)
ENTRY_POINTS = {
    "generate": (lambda c: c.generate(PROMPT, guidance=8.0), 1),
    "generate_list": (lambda c: c.generate([PROMPT, "a cat"],
                                           guidance=8.0), 2),
    "generate_scheduled": (lambda c: c.generate("a [cat:dog:0.5] photo",
                                                guidance=8.0), 1),
    "generate_batch": (lambda c: c.generate_batch(_REQS), 4),
    "generate_async": (lambda c: c.generate_async(PROMPT, guidance=8.0)(),
                       1),
    "img2img": (lambda c: c.img2img(PROMPT, _IMG, guidance=8.0), 1),
    "inpaint": (lambda c: c.inpaint(PROMPT, _IMG, _MASK, guidance=8.0), 1),
    "hires_fix": (lambda c: c.hires_fix(PROMPT, guidance=8.0), 1),
    "img2img_batch": (lambda c: c.img2img_batch(_IMG_REQS), 4),
    "inpaint_batch": (lambda c: c.inpaint_batch(_IMG_REQS), 4),
    "refine": (lambda c: c.refine(np.zeros((8, 8, 4), np.float32), PROMPT,
                                  guidance=8.0), 1),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_lcm_runs_one_unet_row_a_request(lcm_ctx, monkeypatch, entry):
    """Every entry point of a guidance-embedded Context evaluates the UNet
    on the requests' rows alone, never on a CFG pair
    (``Context._use_cfg``, ``sdtpu/engine/context.py:480-489``): a batch
    of three padded to four runs four rows, not eight."""
    rows = []
    real = t_unet.apply

    def counted(params, x, *args, **kw):
        rows.append(x.shape[0])
        return real(params, x, *args, **kw)

    monkeypatch.setattr(t_unet, "apply", counted)
    call, want = ENTRY_POINTS[entry]
    call(lcm_ctx)
    assert rows and set(rows) == {want}, rows


def test_lcm_batch_takes_each_requests_guidance(lcm_ctx):
    """A batch's guidances ride the [B] embedding: each request's latents
    are its own run's (within 1e-5; prompts of one window, so that no
    request is padded to a batch-mate's chunk count), and a batch of one
    gives the bytes of ``generate``."""
    reqs = [{**r, "prompt": p} for r, p in zip(_REQS, ("a horse", "a cat",
                                                       "a red car"))]
    lat = lcm_ctx.generate_batch(reqs, output="latent")
    for r, got in zip(reqs, lat):
        alone = lcm_ctx.generate(r["prompt"], guidance=r["guidance"],
                                 seed=r["seed"], output="latent",
                                 negative_prompt=r.get("negative_prompt"))
        assert_close(got, alone)
    assert not np.allclose(lat[0], lcm_ctx.generate(
        "a horse", guidance=2.0, seed=1, output="latent"))
    one = lcm_ctx.generate_batch(_REQS[:1])[0]
    assert np.array_equal(one, lcm_ctx.generate(PROMPT, guidance=8.0,
                                                seed=1))


# ---------------------------------------------------------------------------
# the SDXL refiner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunked", [False, True])
def test_refiner_encode_text_matches_jax(ref, tok, chunked):
    """Tower 2 alone is the refiner's context, its pooled embedding packed
    as a trailing row; the chunked [B, k, T] form with token weights too:
    [B, k T + 1, 48] within 1e-5."""
    jcfg, tcfg = CFGS["ref"]
    jtree, ttree = trees("ref")
    L = tcfg.clip.context_len
    tokens = np.array([tok.tokenize(PROMPT, L)], np.int64)
    weights = None
    if chunked:
        tokens = np.stack([tokens, np.array([tok.tokenize("a cat", L)])], 1)
        weights = 0.5 + np.random.default_rng(2).random(
            tokens.shape).astype(np.float32)
    ours = t_pipeline.encode_text(
        ttree, torch.from_numpy(tokens), tcfg,
        None if weights is None else torch.from_numpy(weights))
    theirs = ref.encode_text(jtree, jnp.asarray(tokens, jnp.int32), jcfg,
                             None if weights is None else jnp.asarray(weights))
    assert ours.shape == ((1, 2 * L + 1, 48) if chunked else (1, L + 1, 48))
    assert_close(ours, theirs)


def test_refiner_micro_conditions_have_five_blocks():
    """(H, W, 0, 0, aesthetic score) through the fourier features: 5 x 8
    wide, the reference's; the additive embedding of a random pooled row
    within 1e-5."""
    jcfg, tcfg = CFGS["ref"]
    jtree, ttree = trees("ref")
    micro = t_temb.micro_features(tcfg, 8)
    assert micro.shape == (40,)
    assert_close(micro, j_temb.micro_features(jcfg, 8))
    pooled = _rand(2, 16, seed=5)
    assert_close(t_pipeline._add_embedding(ttree, torch.from_numpy(pooled),
                                           tcfg),
                 j_pipeline._add_embedding(jtree, jnp.asarray(pooled), jcfg))


@pytest.mark.parametrize("sampler", ["dpm", "euler_a"])
def test_generate_end_step_matches_jax(ref, tok, sampler):
    """The base half of a two-stage call: TINY_XL's loop stopped before
    step 2 of 4, its noisy latents within 1e-4 of the reference's."""
    jcfg, tcfg = CFGS["xl"]
    jtree, ttree = trees("xl")
    tokens, j_un, t_un = _text("xl", tok)
    j_lat = ref.generate(jtree, jnp.asarray(tokens, jnp.int32), j_un,
                         _keys(4), jnp.float32(7.5), cfg=jcfg,
                         sampler=sampler, steps=STEPS, kernels="xla",
                         end_step=2, output="latent")
    d = _jax_draws(4, _shape(tcfg))
    t_lat = t_pipeline.generate(
        ttree, torch.from_numpy(tokens), t_un, None, 7.5, cfg=tcfg,
        sampler=sampler, steps=STEPS, noise=d["noise"],
        step_noise=d["step_noise"], output="latent", end_step=2)
    assert_close(t_lat, j_lat, rel=1e-4)


@pytest.mark.parametrize("sampler", ["dpm", "euler_a"])
def test_refine_matches_jax(ref, tok, monkeypatch, sampler):
    """TINY_XL_REF's ``refine`` of noisy latents from step 2 of 4 (taken as
    they are, not noised) against the reference's: latents within 1e-4,
    images within 1."""
    jcfg, tcfg = CFGS["ref"]
    jtree, ttree = trees("ref")
    tokens, j_un, t_un = _text("ref", tok)
    x = _rand(*_shape(tcfg), seed=6)
    j_lat, j_img = _reference_latents(
        ref, monkeypatch, ref.refine, jtree, jnp.asarray(tokens, jnp.int32),
        j_un, _keys(3), jnp.float32(7.5), jnp.asarray(x), cfg=jcfg,
        sampler=sampler, steps=STEPS, start_step=2, kernels="xla")
    d = _jax_draws(3, _shape(tcfg))
    t_lat = t_pipeline.refine(
        ttree, torch.from_numpy(tokens), t_un, None, 7.5, x, cfg=tcfg,
        sampler=sampler, steps=STEPS, start_step=2, noise=d["noise"],
        step_noise=d["step_noise"], output="latent")
    assert_close(t_lat, j_lat, rel=1e-4)
    _check_image(t_lat, j_img, ttree, tcfg)


@pytest.fixture(scope="module")
def ref_ctx():
    c = Context(config=t_config.TINY_XL_REF, steps=STEPS, device="cpu")
    c.params = trees("ref")[1]
    c._prepare_buffers()
    return c


@pytest.mark.parametrize("sampler", ["dpm", "euler_a", "plms_exact", "heun"])
def test_refine_from_generates_start_latents_is_generate(ref_ctx, sampler):
    """``refine`` at ``denoising_start=0`` from ``generate``'s own start
    latents (the seed generator's first draw) gives ``generate``'s bytes:
    both draw their tables by one rule. The refiner Context serves
    ``generate`` alone too."""
    ref_ctx.sampler = sampler
    try:
        want = ref_ctx.generate(PROMPT, seed=9)
        noise = torch.randn(_shape(ref_ctx.cfg),
                            generator=torch.Generator().manual_seed(9))
        got = ref_ctx.refine(noise[0].numpy(), PROMPT, seed=9,
                             denoising_start=0.0)
    finally:
        ref_ctx.sampler = "dpm"
    assert want.std() > 0 and np.array_equal(got, want)


@pytest.mark.parametrize("sampler", ["ddim", "euler"])
def test_split_trajectory_equals_the_full_one(sampler):
    """With a stateless sampler, ``generate(denoising_end=0.5)`` then
    ``refine(denoising_start=0.5)`` on one Context gives the unsplit
    bytes (``tests/test_refiner.py:84``)."""
    c = Context(config="tiny", steps=STEPS, sampler=sampler, device="cpu")
    c.params = trees("tiny")[1]
    c._prepare_buffers()
    full = c.generate(PROMPT, seed=3)
    lat = c.generate(PROMPT, seed=3, denoising_end=0.5, output="latent")
    assert lat.dtype == np.float32 and lat.shape == (8, 8, 4)
    assert np.array_equal(full, c.refine(lat, PROMPT, seed=3,
                                         denoising_start=0.5))


def test_base_to_refiner_handoff_matches_jax(ref, tok, monkeypatch):
    """TINY_XL stopped before step 2 of 4, its latents refined by
    TINY_XL_REF from step 2, each side's draws from its key: the handoff
    latents within 1e-4, the refined latents within 1e-4 and the images
    within 1 of the reference's."""
    bj, bt = CFGS["xl"]
    rj, rt = CFGS["ref"]
    (jbase, tbase), (jref, tref) = trees("xl"), trees("ref")
    tokens, jb_un, tb_un = _text("xl", tok)
    _, jr_un, tr_un = _text("ref", tok)
    j_mid = ref.generate(jbase, jnp.asarray(tokens, jnp.int32), jb_un,
                         _keys(2), jnp.float32(7.5), cfg=bj, sampler="dpm",
                         steps=STEPS, kernels="xla", end_step=2,
                         output="latent")
    j_lat, j_img = _reference_latents(
        ref, monkeypatch, ref.refine, jref, jnp.asarray(tokens, jnp.int32),
        jr_un, _keys(2), jnp.float32(7.5), j_mid, cfg=rj, sampler="dpm",
        steps=STEPS, start_step=2, kernels="xla")
    d = _jax_draws(2, _shape(bt))
    t_mid = t_pipeline.generate(
        tbase, torch.from_numpy(tokens), tb_un, None, 7.5, cfg=bt,
        sampler="dpm", steps=STEPS, noise=d["noise"], output="latent",
        end_step=2)
    assert_close(t_mid, j_mid, rel=1e-4)
    t_lat = t_pipeline.refine(tref, torch.from_numpy(tokens), tr_un, None,
                              7.5, t_mid, cfg=rt, sampler="dpm",
                              steps=STEPS, start_step=2, noise=d["noise"],
                              output="latent")
    assert_close(t_lat, j_lat, rel=1e-4)
    _check_image(t_lat, j_img, tref, rt)


def _stub(cfg):
    """The attributes the reference's ``refine`` and ``upscale`` read
    before their first piece of work, on a stand-in for its Context."""
    s = types.SimpleNamespace(
        cfg=cfg, errors=j_errors.ErrorTable(), _failed=False, steps=STEPS,
        logger=j_slog.Logger(j_slog.LogLevel.ERROR), seed=0)
    for name in ("_require_txt2img", "_image_conditioned", "refine",
                 "upscale"):
        setattr(s, name, types.MethodType(getattr(j_context.Context, name),
                                          s))
    return s


@pytest.mark.parametrize("kw", [
    dict(denoising_start=1.0), dict(denoising_start=-0.1),
    dict(latents=np.zeros((4, 4, 4), np.float32)),
    dict(latents=np.zeros((2, 8, 8, 4), np.float32))],
    ids=["start_1", "start_negative", "latent_grid", "latent_batch"])
def test_refine_validation_has_the_references_text(ref_ctx, kw):
    """A start outside [0, 1) and latents of another shape than the
    prompts' are ``INVALID_ARGUMENT`` with the reference's text, before
    the seed advances."""
    args = {"latents": np.zeros((8, 8, 4), np.float32), **kw}
    seed = ref_ctx.seed
    with pytest.raises(SdtpuError) as ours:
        ref_ctx.refine(prompt=PROMPT, **args)
    with pytest.raises(j_errors.SdtpuError) as theirs:
        _stub(CFGS["ref"][0]).refine(prompt=PROMPT, **args)
    assert ours.value.code == ErrorCode.INVALID_ARGUMENT
    assert int(ours.value.code) == int(theirs.value.code)
    assert str(ours.value) == str(theirs.value)
    assert ref_ctx.seed == seed


@pytest.fixture(scope="module")
def jctx():
    """The reference's TINY Context on the port's weights (its own init
    replaced), to read the texts its ``generate`` raises after its
    text work."""
    jtree = trees("tiny")[0]
    mp = pytest.MonkeyPatch()
    mp.setattr(j_context, "init_pipeline_params", lambda key, cfg: jtree)
    try:
        yield j_context.Context(config="tiny", steps=STEPS,
                                compile_cache=None)
    finally:
        mp.undo()


@pytest.mark.parametrize("prompt,end", [
    (PROMPT, 0.0), (PROMPT, 1.5), (PROMPT, -0.2),
    ("a [cat:dog:0.5] photo", 0.5)])
def test_denoising_end_validation_has_the_references_text(jctx, prompt, end):
    """``denoising_end`` outside (0, 1], and prompt scheduling with a
    two-stage call, are ``INVALID_ARGUMENT`` with the reference's text;
    the port's seed does not advance."""
    c = Context(config="tiny", steps=STEPS, device="cpu")
    c.params = trees("tiny")[1]
    c._prepare_buffers()
    seed = c.seed
    with pytest.raises(SdtpuError) as ours:
        c.generate(prompt, denoising_end=end)
    with pytest.raises(j_errors.SdtpuError) as theirs:
        jctx.generate(prompt, denoising_end=end)
    assert ours.value.code == ErrorCode.INVALID_ARGUMENT
    assert int(ours.value.code) == int(theirs.value.code)
    assert str(ours.value) == str(theirs.value)
    assert c.seed == seed


def test_denoising_end_of_one_is_the_full_trajectory(ref_ctx):
    """``round(steps * denoising_end) == steps`` runs every step."""
    assert np.array_equal(ref_ctx.generate(PROMPT, seed=4, denoising_end=1.0),
                          ref_ctx.generate(PROMPT, seed=4))


# ---------------------------------------------------------------------------
# the x4 upscaler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knob", ["plain", "tome", "pag"])
def test_cross_only_basic_block_matches_jax(knob):
    """A cross-only block (attn1's keys and values from the 32-wide text
    context) against the reference's: plain, under ToMe 0.5 on its query
    rows (an 8x8 plane), and with PAG's identity self-attention asked for,
    which leaves the block as it is. Within 1e-5."""
    jtree, ttree = trees("x4")
    tp = ttree["unet"]["down"][0]["blocks"][0]["st"]
    jp = jtree["unet"]["down"][0]["blocks"][0]["st"]
    assert tuple(tp["attn1"]["k"]["w"].shape) == (32, 16)
    h, ctx = _rand(2, 64, 16, seed=8), _rand(2, 16, 32, seed=9)
    tome = (8, 8, 0.5) if knob == "tome" else None
    pag = knob == "pag"
    ours = t_unet._basic_block(tp, torch.from_numpy(h), torch.from_numpy(ctx),
                               2, "plain", pag, tome, cross_only=True)
    theirs = j_unet._basic_block(jp, jnp.asarray(h), jnp.asarray(ctx), 2,
                                 "xla", pag, tome, cross_only=True)
    assert_close(ours, theirs)
    if knob != "plain":
        plain = t_unet._basic_block(tp, torch.from_numpy(h),
                                    torch.from_numpy(ctx), 2, "plain",
                                    cross_only=True)
        assert torch.equal(ours, plain) == (knob == "pag")


def test_fused_cross_only_projections_match_jax():
    """``fuse_attention_projections`` on TINY_X4: the cross-only attn1 of
    level 0 fuses k and v into ``kv`` (32 inputs wide), level 1's
    self-attention q, k, v into ``qkv``; every leaf is the reference's
    fused tree's, and the fused UNet's eps is the unfused one's within
    1e-5."""
    jcfg, tcfg = CFGS["x4"]
    jtree, ttree = trees("x4")
    ours = fuse_attention_projections(ttree)
    theirs = j_params.fuse_attention_projections(jtree)
    a1 = ours["unet"]["down"][0]["blocks"][0]["st"]["attn1"]
    assert set(a1) == {"q", "kv", "out"} and tuple(a1["kv"]["w"].shape) == (
        32, 32)
    assert set(ours["unet"]["down"][1]["blocks"][0]["st"]["attn1"]) == {
        "qkv", "out"}
    got = dict(_leaves(jax_layout(ours["unet"])))
    want = dict(_leaves(theirs["unet"]))
    assert got.keys() == want.keys()
    for p, a in got.items():
        np.testing.assert_array_equal(_np(a), np.asarray(want[p]),
                                      err_msg=str(p))
    x, te = _rand(2, 8, 8, 7, seed=10), _rand(2, 64, seed=11)
    ctx = _rand(2, 16, 32, seed=12)
    args = (torch.from_numpy(x), torch.from_numpy(te), torch.from_numpy(ctx),
            tcfg.unet)
    assert_close(t_unet.apply(ours["unet"], *args),
                 t_unet.apply(ttree["unet"], *args))


@pytest.mark.parametrize("per_sample", [False, True])
def test_upscale_matches_jax(ref, tok, monkeypatch, per_sample):
    """TINY_X4's ``upscale`` (v-prediction, dpm, CFG 7.5) of a random
    8x8 image at noise level 5, and of two at levels 3 and 12 with a key
    each, against the reference's with its start-latent and augmentation
    draws injected (``aug_noise=``): the augmented low-res planes within
    1e-6, the latents within 1e-4, the 16x16 images within 1."""
    jcfg, tcfg = CFGS["x4"]
    jtree, ttree = trees("x4")
    b = 2 if per_sample else 1
    prompts = (PROMPT, "a cat")[:b]
    tokens, j_un, t_un = _text("x4", tok, prompts)
    seeds = [7, 8] if per_sample else 7
    level = [3, 12] if per_sample else 5
    img = np.random.default_rng(3).uniform(-1, 1, (b, 8, 8, 3)).astype(
        np.float32)
    seen = {}

    def spy(mod, key):
        real = mod.denoise

        def denoise(*args, **kw):
            seen[key] = _np(kw["x_extra"])
            return real(*args, **kw)
        monkeypatch.setattr(mod, "denoise", denoise)

    spy(ref, "jax")
    spy(t_pipeline, "ours")
    j_lat, j_img = _reference_latents(
        ref, monkeypatch, ref.upscale, jtree, jnp.asarray(tokens, jnp.int32),
        j_un, _keys(seeds), jnp.float32(7.5), jnp.asarray(img),
        jnp.asarray(level, jnp.int32), cfg=jcfg, sampler="dpm", steps=STEPS,
        kernels="xla")
    d = _jax_draws(seeds, _shape(tcfg, b), image_shape=img.shape)
    t_lat = t_pipeline.upscale(
        ttree, torch.from_numpy(tokens), t_un, None, 7.5,
        torch.from_numpy(img), level, cfg=tcfg, sampler="dpm", steps=STEPS,
        noise=d["noise"], aug_noise=d["aug_noise"], output="latent")
    assert_close(seen["ours"], seen["jax"], rel=1e-6)
    assert_close(t_lat, j_lat, rel=1e-4)
    assert j_img.shape == (b, 16, 16, 3)
    _check_image(t_lat, j_img, ttree, tcfg)


def test_upscale_draws_follow_the_rule():
    """The augmentation is the generator's draw after the start latents (a
    NEEDS_NOISE sampler's step noise between), in the low-res image's
    shape: [B, h, w, 3]."""
    d = t_pipeline.draw_noise(torch.Generator().manual_seed(1),
                              (2, 8, 8, 4), 3,
                              ("aug_noise", "step_noise", "noise"), "cpu")
    g = torch.Generator().manual_seed(1)
    for name, shape in (("noise", (2, 8, 8, 4)),
                        ("step_noise", (3, 2, 8, 8, 4)),
                        ("aug_noise", (2, 8, 8, 3))):
        assert torch.equal(d[name], torch.randn(shape, generator=g)), name
    assert t_pipeline.DRAW_ORDER[-1] == "aug_noise"


@pytest.mark.parametrize("call", [
    lambda c, img: c.upscale(PROMPT, img, noise_level=16),
    lambda c, img: c.upscale(PROMPT, img, noise_level=-1),
    lambda c, img: c.upscale(PROMPT, np.zeros((16, 16, 3), np.uint8)),
    lambda c, img: c.upscale([PROMPT, "a cat"], img),
], ids=["level_max", "level_negative", "full_size_image", "batch"])
def test_upscale_validation_has_the_references_text(call):
    """A level outside [0, max_noise_level) and an image off the latent
    grid or the prompts' batch are ``INVALID_ARGUMENT`` with the
    reference's text, before the seed advances."""
    img = np.zeros((8, 8, 3), np.uint8)
    c = Context(config=t_config.TINY_X4, steps=STEPS, device="cpu")
    seed = c.seed
    with pytest.raises(SdtpuError) as ours:
        call(c, img)
    with pytest.raises(j_errors.SdtpuError) as theirs:
        call(_stub(CFGS["x4"][0]), img)
    assert ours.value.code == ErrorCode.INVALID_ARGUMENT
    assert str(ours.value) == str(theirs.value)
    assert c.seed == seed


@pytest.mark.parametrize("name", ["tiny", "lcm"])
def test_upscale_needs_a_class_table_with_the_references_text(name):
    """A configuration without the 7-channel UNet and its class rows
    refuses ``upscale`` with the reference's text."""
    img = np.zeros((8, 8, 3), np.uint8)
    c = Context(config=CFGS[name][1], steps=STEPS, device="cpu")
    with pytest.raises(SdtpuError) as ours:
        c.upscale(PROMPT, img)
    with pytest.raises(j_errors.SdtpuError) as theirs:
        _stub(CFGS[name][0]).upscale(PROMPT, img)
    assert ours.value.code == ErrorCode.INVALID_ARGUMENT
    assert str(ours.value) == str(theirs.value)
    assert "class rows" in str(ours.value)


def test_x4_context_serves_upscale(monkeypatch):
    """A TINY_X4 Context: 8x8 -> 16x16 uint8, the same bytes from the same
    seed, another level another image, the batch's rows [cond, uncond]
    each taking its sample's class row."""
    c = Context(config=t_config.TINY_X4, steps=2, device="cpu")
    img = np.random.default_rng(4).integers(0, 256, (8, 8, 3), np.uint8)
    a = c.upscale(PROMPT, img, noise_level=5, seed=2)
    assert a.shape == (16, 16, 3) and a.dtype == np.uint8 and a.std() > 0
    assert np.array_equal(a, c.upscale(PROMPT, img, noise_level=5, seed=2))
    assert not np.array_equal(a, c.upscale(PROMPT, img, noise_level=12,
                                           seed=2))
    lat = c.upscale(PROMPT, img, noise_level=5, seed=2, output="latent")
    assert lat.shape == (8, 8, 4) and np.isfinite(lat).all()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["SD15_LCM", "SD_X4", "SDXL_REFINER"])
def test_unet_rules_match_jax(name):
    """The full-width rule tables name by name: ``time_embed.cond_proj``,
    ``label_emb`` and the refiner's four levels."""
    ours = t_weights.unet_rules(getattr(t_config, name))
    theirs = j_weights.unet_rules(getattr(j_config, name))
    assert [tuple(r) for r in ours] == [tuple(r) for r in theirs]


def _f32(sd):
    return {k: np.asarray(v.float().numpy() if torch.is_tensor(v) else v,
                          np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("name", ["lcm", "x4", "ref"])
def test_ldm_round_trip_matches_jax(tmp_path, name):
    """``params_to_ldm`` is the reference's key by key (LCM's bias-free
    ``time_embed.cond_proj``, x4's ``label_emb``, the refiner's one bigG
    under ``conditioner.embedders.0.model`` and no CLIP-L key), and a BF16
    file of it loads through the port's reader as the reference loads it,
    exactly."""
    jcfg, tcfg = CFGS[name]
    jtree, ttree = trees(name)
    ours = t_weights.params_to_ldm(ttree, tcfg)
    theirs = j_weights.params_to_ldm(jtree, jcfg)
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    key = {"lcm": "model.diffusion_model.time_embed.cond_proj.weight",
           "x4": "model.diffusion_model.label_emb.weight",
           "ref": "conditioner.embedders.0.model.text_projection"}[name]
    assert key in ours
    if name == "ref":
        assert not any(k.startswith("conditioner.embedders.1.")
                       or ".transformer.text_model." in k for k in ours)
    t_st.save_file({k: v.to(torch.bfloat16) for k, v in ours.items()},
                   tmp_path / "m.safetensors")
    sd = t_st.load_file(tmp_path / "m.safetensors")
    assert_trees_equal(t_weights.load_ldm_state_dict(sd, tcfg),
                       from_jax_tree(j_weights.load_ldm_state_dict(
                           _f32(sd), jcfg), tcfg))


@pytest.mark.parametrize("name", ["lcm", "x4", "ref"])
def test_native_files_cross_between_the_packages(tmp_path, name):
    """A native file written by either package loads in the other as the
    same tree."""
    jcfg, tcfg = CFGS[name]
    jtree, ttree = trees(name)
    t_weights.save_native(ttree, tmp_path / "t.sdtpu.safetensors")
    got = dict(_leaves(j_weights.load_native(tmp_path / "t.sdtpu.safetensors")))
    want = dict(_leaves(jtree))
    assert got.keys() == want.keys()
    for p, a in got.items():
        np.testing.assert_array_equal(np.asarray(a), np.asarray(want[p]),
                                      err_msg=str(p))
    j_weights.save_native(jtree, tmp_path / "j.sdtpu.safetensors")
    assert_trees_equal(t_weights.load_native(
        tmp_path / "j.sdtpu.safetensors", tcfg), ttree)


def test_refiner_file_serves_and_the_base_refuses_it(tmp_path):
    """A refiner-keyed BF16 LDM file serves through ``Context(model_dir=)``
    on the refiner configuration with the demo tree's bytes (float32 here:
    the same weights rounded to bf16 and back); the base configuration
    refuses it, and the refiner refuses a base file, naming the
    configuration to serve each with."""
    _, tcfg = CFGS["ref"]
    ttree = trees("ref")[1]
    sd = {k: v.to(torch.bfloat16)
          for k, v in t_weights.params_to_ldm(ttree, tcfg).items()}
    t_st.save_file(sd, tmp_path / "ref.safetensors")
    served = Context(model_dir=str(tmp_path), config=tcfg, steps=STEPS,
                     device="cpu")
    demo = Context(config=tcfg, steps=STEPS, device="cpu")
    demo.params = t_weights.load_ldm_state_dict(sd, tcfg)
    demo._prepare_buffers()
    assert np.array_equal(served.generate(PROMPT, seed=3),
                          demo.generate(PROMPT, seed=3))
    with pytest.raises(SdtpuError) as ei:
        Context(model_dir=str(tmp_path), config=t_config.TINY_XL,
                device="cpu")
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert "config='sdxl_refiner'" in str(ei.value)
    base = tmp_path / "base"
    base.mkdir()
    t_st.save_file(t_weights.params_to_ldm(trees("xl")[1], CFGS["xl"][1]),
                   base / "xl.safetensors")
    with pytest.raises(SdtpuError) as ei:
        Context(model_dir=str(base), config=tcfg, device="cpu")
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert "config='sdxl'" in str(ei.value)


@pytest.mark.parametrize("name", ["lcm", "x4"])
def test_converter_takes_the_staged_configs(tmp_path, monkeypatch, name):
    """``convert_weights --config`` names the three configurations; a
    TINY LCM or x4 LDM file converts to a native file that is the tree."""
    from sdtpu_torch.tools import convert_weights

    for full in ("sd15_lcm", "sd_x4", "sdxl_refiner"):
        assert full in convert_weights.CONFIGS
    _, tcfg = CFGS[name]
    ttree = trees(name)[1]
    monkeypatch.setitem(convert_weights.CONFIGS, f"tiny_{name}", tcfg)
    ldm = tmp_path / "m.safetensors"
    t_st.save_file(t_weights.params_to_ldm(ttree, tcfg), ldm)
    assert convert_weights.main([str(ldm), str(tmp_path / "out"), "--config",
                                 f"tiny_{name}", "--dtype", "float32"]) == 0
    assert_trees_equal(t_weights.load_native(
        tmp_path / "out" / f"model{t_weights.NATIVE_SUFFIX}", tcfg), ttree)
