"""The port's image-conditioned serving against the JAX package, at TINY and
its concat-conditioned variants in float32 on the CPU: the VAE encoder, the
posterior draw, img2img (and its depth form), both inpaint regimes, the
hires fix's second pass and InstructPix2Pix's dual CFG, under the samplers
that keep each kind of history (dpm, plms_exact, euler_a, heun) from start
steps 0, 1 and steps - 1; then ``Context``'s image paths (validation and
its codes, determinism, batches, the exact paste of an inpaint's kept
region, the properties of zero-initialised extra conv_in taps) and the
concat families' checkpoints.

Both sides get the same weights: the port's own random init, carried to the
JAX package's layout by ``io.params.to_jax_tree``. Inputs are made with
numpy from a fixed seed; the JAX package's threefry draws (its start
latents, posterior, masked-image, pin and ancestral fold_in tags) reach the
port through the pipeline functions' seams (``noise=``, ``step_noise=``,
``posterior_noise=``, ``masked_noise=``, ``pin_noise=``).

The reference's pipeline functions run as they are, with their loop's
``lax.scan`` taken as a Python loop over the same body and the models (the
UNet, the VAE and its encoder, the text encode) jitted once per shape, so
that a case costs its own arithmetic and not a compile of the whole
program (and compiled at XLA's backend optimization level 0: it compiles
in a third of the time). Latents are held within 1e-4 of the reference's
max-abs, images
within 1 (a value on a .5 boundary may round either way), modules within
1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sdtpu import config as j_config
from sdtpu.engine import pipeline as j_pipeline
from sdtpu.io import weights as j_weights
from sdtpu.models import unet as j_unet
from sdtpu.models import vae as j_vae
from sdtpu.ops import conv as j_conv
from sdtpu.ops import groupnorm as j_gn
from sdtpu_torch import Context, ErrorCode, SdtpuError
from sdtpu_torch import config as t_config
from sdtpu_torch.engine import context as t_context
from sdtpu_torch.engine import pipeline as t_pipeline
from sdtpu_torch.io import safetensors as t_st
from sdtpu_torch.io import weights as t_weights
from sdtpu_torch.io.params import init_pipeline_params, to_jax_tree
from sdtpu_torch.models import layers as t_layers
from sdtpu_torch.models import unet as t_unet
from sdtpu_torch.models import vae as t_vae

TINY_J, TINY_T = j_config.TINY, t_config.TINY
STEPS = 3
PROMPT = "a photograph of an astronaut riding a horse"
SIZE = TINY_T.image_size
# the JAX package's fold_in tags (sdtpu/engine/pipeline.py:737-746), and the
# hires fix's second-pass key (sdtpu/engine/context.py:1767-1770)
POSTERIOR_FOLD, ANCESTRAL_FOLD, MASKED_FOLD = 1 << 20, 1 << 21, 1 << 22
HIRES_FOLD = 1 << 23


def _v(cfg):
    """A v-prediction variant: the conversion must read the latents, not
    the extra planes."""
    return dataclasses.replace(cfg, prediction="v")


# name -> (the JAX config, the port's)
CFGS = {
    "tiny": (TINY_J, TINY_T),
    "inpaint": (j_config.TINY_INPAINT, t_config.TINY_INPAINT),
    "depth": (j_config.TINY_DEPTH, t_config.TINY_DEPTH),
    "depth_v": (_v(j_config.TINY_DEPTH), _v(t_config.TINY_DEPTH)),
    "ip2p": (j_config.TINY_IP2P, t_config.TINY_IP2P),
    "xl_inpaint": (j_config.TINY_XL_INPAINT, t_config.TINY_XL_INPAINT),
}


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
        cfg = CFGS[name][1]
        ttree = init_pipeline_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
        _TREES[name] = (jax.tree.map(jnp.asarray, to_jax_tree(ttree)), ttree)
    return _TREES[name]


#: XLA:CPU compiles at backend optimization level 0 (the same arithmetic)
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})


def _scan_as_loop(f, init, xs, unroll=1, length=None):
    carry = init
    for i in range(int(xs.shape[0])):
        carry, _ = f(carry, xs[i])
    return carry, None


#: ``jax.random.normal`` compiled at level 0 too (its default compile takes
#: a second a shape); the reference's draws and ``_draws`` both take it
_normal = _jit(jax.random.normal, static_argnums=(1, 2))


def _normal_draw(key, shape, dtype=jnp.float32):
    return _normal(key, tuple(shape), dtype)


_encode_text = _jit(j_pipeline.encode_text, static_argnums=(2,))


def _encode_text_once(params, tokens, cfg, weights=None):
    """The reference's text encode, jitted once per text shape: it reads
    only the towers, the dtype and the refiner flag of ``cfg`` and
    the towers of ``params``, so the concat variants share a compile."""
    key = dataclasses.replace(TINY_J, clip=cfg.clip, clip2=cfg.clip2,
                              dtype=cfg.dtype, refiner=cfg.refiner)
    towers = {k: params[k] for k in ("clip", "clip2") if k in params}
    return _encode_text(towers, tokens, key, weights)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's pipeline module with its scan taken as a loop and
    its models jitted once per shape (module docstring)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.lax, "scan", _scan_as_loop)
    mp.setattr(jax.random, "normal", _normal_draw)
    mp.setattr(j_unet, "apply", _jit(
        j_unet.apply, static_argnums=(4, 5),
        static_argnames=("deep", "perturb")))
    mp.setattr(j_vae, "apply", _jit(j_vae.apply, static_argnums=(2, 3)))
    mp.setattr(j_vae, "apply_encoder",
               _jit(j_vae.apply_encoder, static_argnums=(2, 3)))
    mp.setattr(j_pipeline, "encode_text", _encode_text_once)
    yield j_pipeline
    mp.undo()


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def assert_close(ours, ref, rel=1e-4):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    tol = rel * float(np.abs(ref).max())
    assert err <= tol, f"max-abs err {err:.3g} > {tol:.3g}"


def _image(b=1, seed=7, size=SIZE):
    """uint8 [b, size, size, 3] and its float32 form in [-1, 1]."""
    u8 = np.random.default_rng(seed).integers(0, 256, (b, size, size, 3),
                                              dtype=np.uint8)
    return u8, u8.astype(np.float32) / 127.5 - 1.0


def _mask(b=1, size=SIZE):
    """A float32 [b, size, size, 1] mask with a soft edge: repaint the top
    half, keep the bottom, one half-weight row between."""
    m = np.zeros((b, size, size, 1), np.float32)
    m[:, : size // 2] = 1.0
    m[:, size // 2] = 0.5
    return m


def _text(name, b=1, seed=3):
    """(tokens [b, T] int, the uncond embedding of each side)."""
    jcfg, tcfg = CFGS[name]
    jtree, ttree = trees(name)
    L = tcfg.clip.context_len
    tok = np.random.default_rng(seed).integers(0, 500, (b, L))
    un = np.zeros((1, L), np.int64)
    j_un = j_pipeline.encode_text(jtree, jnp.asarray(un, jnp.int32), jcfg)[0]
    t_un = t_pipeline.encode_text(ttree, torch.from_numpy(un), tcfg)[0]
    return tok, j_un, t_un


def _draws(seed, shape, steps=STEPS, key=None):
    """The reference's draws for one PRNG key, as numpy: the start latents,
    the ancestral step noise [steps, ...], the posterior and masked-image
    noise, the inpaint pin noise [steps, ...]."""
    key = jax.random.PRNGKey(seed) if key is None else key

    def normal(k):
        return np.array(_normal_draw(k, shape))

    fold = functools.partial(jax.random.fold_in, key)
    return {"noise": normal(key),
            "step_noise": np.stack([normal(fold(ANCESTRAL_FOLD + i))
                                    for i in range(steps)]),
            "posterior_noise": normal(fold(POSTERIOR_FOLD)),
            "masked_noise": normal(fold(MASKED_FOLD)),
            "pin_noise": np.stack([normal(fold(1 + i))
                                   for i in range(steps)])}


def _shape(cfg, b=1, scale=1):
    s = cfg.latent_size * scale
    return (b, s, s, cfg.latent_channels)


def _reference_latents(ref, monkeypatch, fn, *args, **kw):
    """Run a reference pipeline function; -> (its latents before the
    decode, its uint8 image)."""
    seen = []
    real = ref.decode_latents

    def decode(params, x, cfg, kernels="xla"):
        seen.append(np.asarray(x))
        return real(params, x, cfg, kernels)

    monkeypatch.setattr(ref, "decode_latents", decode)
    img = np.asarray(fn(*args, **kw))
    return seen[-1], img


def _check(t_lat, j_lat, params, cfg, j_img):
    """Latents within 1e-4, and the port's decode of its own latents within
    1 of the reference's image."""
    assert_close(t_lat, j_lat)
    img = t_pipeline.decode_latents(params, t_lat, cfg).numpy()
    assert img.dtype == np.uint8 and img.shape == j_img.shape
    assert np.abs(img.astype(int) - j_img.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

CONCAT_NAMES = ("sd15_inpaint", "sd21_inpaint", "sdxl_inpaint", "sd2_depth",
                "sd15_ip2p")


@pytest.mark.parametrize("name", [
    "SD15_INPAINT", "SD21_INPAINT", "SDXL_INPAINT", "SD2_DEPTH", "SD15_IP2P",
    "TINY_INPAINT", "TINY_DEPTH", "TINY_IP2P", "TINY_XL_INPAINT"])
def test_concat_config_matches_jax(name):
    """Every field the port carries is the reference's, tower by tower,
    the UNet's input width included."""
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
    assert ours.image_size == ref.image_size


@pytest.mark.parametrize("name", CONCAT_NAMES)
def test_context_takes_the_concat_config_names(name, monkeypatch):
    """The five names resolve to their configs (no weights are built: the
    load phases are stubbed; the init's shapes are checked on the meta
    device)."""
    for phase in ("_load_models", "_load_tokenizer", "_prepare_buffers"):
        monkeypatch.setattr(Context, phase, lambda self: None)
    ctx = Context(config=name, device="cpu")
    cfg = t_config.CONFIGS[name]
    assert ctx.cfg is cfg
    w = t_unet.init(cfg.unet, None, "meta")["conv_in"]["w"]
    assert tuple(w.shape[:2]) == (cfg.unet.model_channels,
                                  cfg.unet.in_channels)


# ---------------------------------------------------------------------------
# the encoder and the posterior
# ---------------------------------------------------------------------------

@pytest.fixture
def pallas(monkeypatch):
    """JAX's GroupNorm and conv Pallas kernels in interpret mode; returns
    the kernel functions that reached ``pl.pallas_call``."""
    reached = []
    real = pl.pallas_call

    def counting(kernel, *args, **kwargs):
        reached.append(getattr(kernel, "func", kernel).__name__)
        return real(kernel, *args, **kwargs)

    for mod in (j_gn, j_conv):
        monkeypatch.setattr(mod, "INTERPRET", True)
    monkeypatch.setattr(pl, "pallas_call", counting)
    j_conv._fused_conv.clear_cache()
    yield reached
    j_conv._fused_conv.clear_cache()


def test_downsample_matches_jax():
    """Pad (0, 1, 0, 1), VALID stride-2 3x3 conv, on an odd plane too."""
    jtree, ttree = trees("tiny")
    p_j, p_t = jtree["vae_enc"]["down"][0]["down"], ttree["vae_enc"]["down"][
        0]["down"]
    for hw in ((16, 16), (9, 7)):
        x = _rand(2, *hw, 16, seed=1)
        assert_close(t_vae._downsample(p_t, _t(x)),
                     j_vae._downsample(p_j, jnp.asarray(x)))


@pytest.mark.parametrize("theirs,ours", [("xla", "plain"),
                                         ("pallas_conv", "cuda_conv")])
def test_encoder_matches_jax(pallas, theirs, ours):
    """``apply_encoder``'s mean and logvar within 1e-4 (the decoder's
    tolerance); under ``pallas_conv`` the reference's ResBlocks reach its
    conv kernel, and the port's ``cuda_conv`` runs K3's and K2's statistics
    mode's plain versions on the host."""
    jtree, ttree = trees("tiny")
    _, x = _image(2, seed=4)
    j_mean, j_logvar = _jit(functools.partial(
        j_vae.apply_encoder, cfg=TINY_J.vae, kernels=theirs))(
        jtree["vae_enc"], jnp.asarray(x))
    if theirs == "pallas_conv":
        assert "_conv_kernel_b" in pallas or "_conv_kernel" in pallas
    mean, logvar = t_vae.apply_encoder(ttree["vae_enc"], _t(x), TINY_T.vae,
                                       ours)
    assert mean.shape == (2, 8, 8, 4)
    assert_close(mean, j_mean)
    assert_close(logvar, j_logvar)


@pytest.mark.parametrize("form", ["mode", "sample", "unscaled"])
def test_encode_init_latents_matches_jax(ref, form):
    """The posterior mode, a sample with the reference's draw handed in,
    and the unscaled mode (ip2p)."""
    jtree, ttree = trees("tiny")
    _, x = _image(1, seed=5)
    key = jax.random.PRNGKey(9) if form == "sample" else None
    want = ref._encode_init_latents(jtree, jnp.asarray(x), TINY_J, "xla",
                                    key=key, scaled=form != "unscaled")
    noise = (_draws(9, _shape(TINY_T))["posterior_noise"]
             if form == "sample" else None)
    got = t_pipeline._encode_init_latents(
        ttree, _t(x), TINY_T, "plain",
        noise=None if noise is None else _t(noise),
        scaled=form != "unscaled")
    assert_close(got, want)


# ---------------------------------------------------------------------------
# the pipeline functions against the reference's
# ---------------------------------------------------------------------------

SAMPLERS = ("dpm", "plms_exact", "euler_a", "heun")


@pytest.mark.parametrize("start_step", [0, 1, STEPS - 1])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_img2img_matches_jax(ref, monkeypatch, sampler, start_step):
    """A warm start meets each kind of history: the multistep solver's
    (dpm), CompVis PLMS's two-eval first step (only at start 0), the
    ancestral draws (euler_a), the two-eval heun."""
    jtree, ttree = trees("tiny")
    tok, j_un, t_un = _text("tiny")
    _, x = _image(1, seed=11)
    seed, g = 5, 7.5
    j_lat, j_img = _reference_latents(
        ref, monkeypatch, ref.img2img, jtree, jnp.asarray(tok, jnp.int32),
        j_un, jax.random.PRNGKey(seed), jnp.float32(g), jnp.asarray(x),
        cfg=TINY_J, sampler=sampler, steps=STEPS, start_step=start_step,
        kernels="xla")
    d = _draws(seed, _shape(TINY_T))
    t_lat = t_pipeline.img2img(
        ttree, torch.from_numpy(tok), t_un, None, g, _t(x), cfg=TINY_T,
        sampler=sampler, steps=STEPS, start_step=start_step,
        output="latent", noise=d["noise"], step_noise=d["step_noise"],
        posterior_noise=d["posterior_noise"])
    _check(t_lat, j_lat, ttree, TINY_T, j_img)


@pytest.mark.parametrize("sampler,start_step", [
    ("dpm", 0), ("euler_a", 1), ("plms_exact", 0), ("heun", STEPS - 1)])
def test_inpaint_standard_matches_jax(ref, monkeypatch, sampler, start_step):
    """The 4-ch UNet: the kept region re-pinned every step with the pin
    draws, the soft-edged mask pooled to latent resolution, the exact paste
    after the loop."""
    jtree, ttree = trees("tiny")
    tok, j_un, t_un = _text("tiny")
    _, x = _image(1, seed=12)
    m = _mask(1)
    seed, g = 6, 7.5
    j_lat, j_img = _reference_latents(
        ref, monkeypatch, ref.inpaint, jtree, jnp.asarray(tok, jnp.int32),
        j_un, jax.random.PRNGKey(seed), jnp.float32(g), jnp.asarray(x),
        jnp.asarray(m), cfg=TINY_J, sampler=sampler, steps=STEPS,
        start_step=start_step, kernels="xla")
    d = _draws(seed, _shape(TINY_T))
    t_lat = t_pipeline.inpaint(
        ttree, torch.from_numpy(tok), t_un, None, g, _t(x), _t(m),
        cfg=TINY_T, sampler=sampler, steps=STEPS, start_step=start_step,
        output="latent", **{k: d[k] for k in (
            "noise", "step_noise", "posterior_noise", "pin_noise")})
    _check(t_lat, j_lat, ttree, TINY_T, j_img)


@pytest.mark.parametrize("name,sampler,start_step", [
    ("inpaint", "dpm", 0), ("inpaint", "dpm", 1),
    ("inpaint", "euler_a", STEPS - 1), ("xl_inpaint", "dpm", 1)])
def test_inpaint_9ch_matches_jax(ref, monkeypatch, name, sampler,
                                 start_step):
    """The dedicated inpaint UNet: mask and masked-image latents as extra
    planes of every CFG slot, the full image encoded only for a warm start;
    on the SDXL topology the packed context row and the planes together."""
    jcfg, tcfg = CFGS[name]
    jtree, ttree = trees(name)
    tok, j_un, t_un = _text(name)
    _, x = _image(1, seed=13)
    m = _mask(1)
    seed, g = 8, 5.0
    j_lat, j_img = _reference_latents(
        ref, monkeypatch, ref.inpaint, jtree, jnp.asarray(tok, jnp.int32),
        j_un, jax.random.PRNGKey(seed), jnp.float32(g), jnp.asarray(x),
        jnp.asarray(m), cfg=jcfg, sampler=sampler, steps=STEPS,
        start_step=start_step, kernels="xla")
    d = _draws(seed, _shape(tcfg))
    t_lat = t_pipeline.inpaint(
        ttree, torch.from_numpy(tok), t_un, None, g, _t(x), _t(m), cfg=tcfg,
        sampler=sampler, steps=STEPS, start_step=start_step,
        output="latent", **{k: d[k] for k in (
            "noise", "step_noise", "posterior_noise", "masked_noise")})
    _check(t_lat, j_lat, ttree, tcfg, j_img)


@pytest.mark.parametrize("name,sampler,start_step", [
    ("depth", "dpm", 1), ("depth", "plms_exact", 0),
    ("depth_v", "heun", 1)])
def test_depth_img2img_matches_jax(ref, monkeypatch, name, sampler,
                                   start_step):
    """The depth plane mean-pooled and normalized per sample to [-1, 1];
    under v-prediction the conversion reads the latents, not the plane."""
    jcfg, tcfg = CFGS[name]
    jtree, ttree = trees(name)
    tok, j_un, t_un = _text(name, b=2)
    _, x = _image(2, seed=14)
    depth = np.abs(_rand(2, SIZE, SIZE, 1, seed=15)) * 40.0 + 3.0
    seed, g = 9, 7.5
    j_lat, j_img = _reference_latents(
        ref, monkeypatch, ref.img2img, jtree, jnp.asarray(tok, jnp.int32),
        j_un, jax.random.PRNGKey(seed), jnp.float32(g), jnp.asarray(x),
        cfg=jcfg, sampler=sampler, steps=STEPS, start_step=start_step,
        kernels="xla", depth=jnp.asarray(depth))
    d = _draws(seed, _shape(tcfg, 2))
    t_lat = t_pipeline.img2img(
        ttree, torch.from_numpy(tok), t_un, None, g, _t(x), cfg=tcfg,
        sampler=sampler, steps=STEPS, start_step=start_step,
        depth=_t(depth), output="latent", noise=d["noise"],
        step_noise=d["step_noise"], posterior_noise=d["posterior_noise"])
    _check(t_lat, j_lat, ttree, tcfg, j_img)


@pytest.mark.parametrize("sampler,guidance", [("dpm", 7.5), ("heun", 1.0)])
def test_hires_refine_matches_jax(ref, monkeypatch, sampler, guidance):
    """The second pass: the base latents nearest-upscaled 2x, noised to the
    start step at the 16x16 grid, denoised and decoded at 32x32 (with and
    without the CFG pair); the reference's draws of its pass-2 key."""
    jtree, ttree = trees("tiny")
    tok, j_un, t_un = _text("tiny")
    base = _rand(1, 8, 8, 4, seed=16)
    key2 = jax.random.fold_in(jax.random.PRNGKey(4), HIRES_FOLD)
    use_cfg, start = guidance != 1.0, 1
    j_lat, j_img = _reference_latents(
        ref, monkeypatch, ref.hires_refine, jtree,
        jnp.asarray(tok, jnp.int32), j_un, key2, jnp.float32(guidance),
        jnp.asarray(base), cfg=TINY_J, scale=2, sampler=sampler,
        steps=STEPS, start_step=start, use_cfg=use_cfg, kernels="xla")
    d = _draws(None, _shape(TINY_T, 1, 2), key=key2)
    t_lat = t_pipeline.hires_refine(
        ttree, torch.from_numpy(tok), t_un, None, guidance, _t(base),
        cfg=TINY_T, scale=2, sampler=sampler, steps=STEPS, start_step=start,
        use_cfg=use_cfg, output="latent", noise=d["noise"],
        step_noise=d["step_noise"])
    assert t_lat.shape == (1, 16, 16, 4)
    _check(t_lat, j_lat, ttree, dataclasses.replace(TINY_T, latent_size=16),
           j_img)


def test_upscale_latents_is_jax_nearest():
    x = _rand(2, 8, 8, 4, seed=17)
    want = jax.image.resize(jnp.asarray(x), (2, 24, 24, 4), "nearest")
    assert torch.equal(t_pipeline.upscale_latents(_t(x), 3), _t(want))


@pytest.mark.parametrize("sampler,image_guidance", [("dpm", 1.5),
                                                    ("euler_a", 2.5)])
def test_instruct_pix2pix_matches_jax(ref, monkeypatch, sampler,
                                      image_guidance):
    """Three CFG slots a step (a UNet batch of 3), the unscaled mode as the
    extra planes and zeros in the third slot, the dual combine."""
    jcfg, tcfg = CFGS["ip2p"]
    jtree, ttree = trees("ip2p")
    tok, j_un, t_un = _text("ip2p")
    _, x = _image(1, seed=18)
    seed, g = 10, 7.5
    j_lat, j_img = _reference_latents(
        ref, monkeypatch, ref.instruct_pix2pix, jtree,
        jnp.asarray(tok, jnp.int32), j_un, jax.random.PRNGKey(seed),
        jnp.float32(g), jnp.asarray(x), jnp.float32(image_guidance),
        cfg=jcfg, sampler=sampler, steps=STEPS, kernels="xla")
    d = _draws(seed, _shape(tcfg))
    t_lat = t_pipeline.instruct_pix2pix(
        ttree, torch.from_numpy(tok), t_un, None, g, _t(x), image_guidance,
        cfg=tcfg, sampler=sampler, steps=STEPS, output="latent",
        noise=d["noise"], step_noise=d["step_noise"])
    _check(t_lat, j_lat, ttree, tcfg, j_img)


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------

def test_draw_order_is_the_documented_one():
    """One generator makes the start latents, the step noise, the posterior,
    the masked-image, the pin draws and the x4 upscaler's augmentation (in
    the low-res image's shape), in that order whatever the order they are
    asked in; a list of one a sample makes each sample's in the same order,
    so that sample 1 of a batch draws what it draws alone."""
    shape, steps = (2, 3, 3, 4), 4
    g = torch.Generator().manual_seed(3)
    got = t_pipeline.draw_noise(
        g, shape, steps, ("pin_noise", "aug_noise", "posterior_noise",
                          "masked_noise", "step_noise", "noise"), "cpu")
    g = torch.Generator().manual_seed(3)
    want = [torch.randn(s, generator=g) for s in (
        shape, (steps,) + shape, shape, shape, (steps,) + shape,
        shape[:-1] + (3,))]
    assert list(got) == list(t_pipeline.DRAW_ORDER)
    assert all(torch.equal(got[k], w)
               for k, w in zip(t_pipeline.DRAW_ORDER, want))
    names = ("noise", "step_noise", "posterior_noise", "pin_noise")
    gens = [torch.Generator().manual_seed(s) for s in (5, 6)]
    b = t_pipeline.draw_noise(gens, shape, steps, names, "cpu")
    one = t_pipeline.draw_noise(torch.Generator().manual_seed(6),
                                (1,) + shape[1:], steps, names, "cpu")
    for k in names:
        per_step = k in ("step_noise", "pin_noise")
        assert torch.equal(b[k][:, 1:] if per_step else b[k][1:], one[k])
    with pytest.raises(ValueError, match="unknown draws"):
        t_pipeline.draw_noise(g, shape, steps, ("nope",), "cpu")


def test_hires_second_pass_does_not_restart_the_stream():
    """The second pass continues the first pass's generator: its start
    noise is not the first pass's with more values after it, as a fresh
    generator of the same seed would give."""
    g = torch.Generator().manual_seed(4)
    x1 = t_pipeline.draw_noise(g, (1, 8, 8, 4), 3, ("noise",), "cpu")
    x2 = t_pipeline.draw_noise(g, (1, 16, 16, 4), 3, ("noise",), "cpu")
    fresh = t_pipeline.draw_noise(torch.Generator().manual_seed(4),
                                  (1, 16, 16, 4), 3, ("noise",), "cpu")
    n = x1["noise"].numel()
    assert torch.equal(fresh["noise"].flatten()[:n], x1["noise"].flatten())
    assert not torch.equal(x2["noise"].flatten()[:n], x1["noise"].flatten())


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------

_CTX = {}


def ctx(name="tiny", steps=STEPS):
    """A Context of ``CFGS[name]``'s port config on the host, the shared
    init's weights, made once."""
    if (name, steps) not in _CTX:
        c = Context(config=CFGS[name][1], steps=steps, device="cpu")
        c.params = trees(name)[1]
        c._prepare_buffers()
        _CTX[name, steps] = c
    return _CTX[name, steps]


IMG = _image(1, seed=21)[0][0]
MASK = (_mask(1)[0, ..., 0] * 255).astype(np.uint8)


def test_context_defaults_to_the_card_and_refuses_without_one(monkeypatch):
    """``device`` defaults to the card; with none, the Context raises
    instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SdtpuError) as ei:
        Context(config="tiny")
    assert ei.value.code == ErrorCode.RUNTIME_ERROR
    assert "no CUDA device" in str(ei.value)


def _call(kind):
    """Calls that must fail, and on which config."""
    depth = np.ones((SIZE, SIZE), np.float32)
    return {
        "strength_zero": ("tiny", lambda c: c.img2img("x", IMG, strength=0)),
        "strength_above_one": ("tiny", lambda c: c.inpaint(
            "x", IMG, MASK, strength=1.5)),
        "image_shape": ("tiny", lambda c: c.img2img("x", IMG[:8])),
        "image_dtype": ("tiny", lambda c: c.img2img(
            "x", IMG.astype(np.float32))),
        "image_batch": ("tiny", lambda c: c.img2img(["x", "y"], IMG)),
        "mask_shape": ("tiny", lambda c: c.inpaint("x", IMG, MASK[:8])),
        "mask_missing": ("tiny", lambda c: c.inpaint("x", IMG, None)),
        "depth_shape": ("depth", lambda c: c.depth2img("x", IMG, depth[1:])),
        "img2img_on_9ch": ("inpaint", lambda c: c.img2img("x", IMG)),
        "inpaint_on_5ch": ("depth", lambda c: c.inpaint("x", IMG, MASK)),
        "inpaint_on_8ch": ("ip2p", lambda c: c.inpaint("x", IMG, MASK)),
        "depth_on_4ch": ("tiny", lambda c: c.depth2img("x", IMG, depth)),
        "ip2p_on_4ch": ("tiny", lambda c: c.instruct_pix2pix("x", IMG)),
        "generate_on_9ch": ("inpaint", lambda c: c.generate("x")),
        "generate_batch_on_8ch": ("ip2p", lambda c: c.generate_batch(
            [{"prompt": "x"}])),
        "hires_on_5ch": ("depth", lambda c: c.hires_fix("x")),
        "hires_scale_one": ("tiny", lambda c: c.hires_fix("x", scale=1)),
        "hires_scale_float": ("tiny", lambda c: c.hires_fix("x",
                                                           scale=2.0)),
        "hires_strength_one": ("tiny", lambda c: c.hires_fix(
            "x", strength=1.0)),
        "batch_empty": ("tiny", lambda c: c.img2img_batch([])),
        "batch_image": ("tiny", lambda c: c.img2img_batch(
            [{"prompt": "x", "image": IMG[:8]}])),
        "batch_mask": ("tiny", lambda c: c.inpaint_batch(
            [{"prompt": "x", "image": IMG}])),
        "batch_strength": ("tiny", lambda c: c.inpaint_batch(
            [{"prompt": "x", "image": IMG, "mask": MASK}], strength=0.0)),
        "batch_on_5ch": ("depth", lambda c: c.img2img_batch(
            [{"prompt": "x", "image": IMG}])),
        "batch_prompt": ("tiny", lambda c: c.img2img_batch(
            [{"image": IMG}])),
        # an adapter that is not loaded
        "lora": ("tiny", lambda c: c.img2img("x", IMG, lora="style")),
        "batch_lora": ("tiny", lambda c: c.inpaint_batch(
            [{"prompt": "x", "image": IMG, "mask": MASK, "lora": "s"}])),
        "scheduled_prompt": ("tiny", lambda c: c.img2img(
            "a [cat:dog:0.5]", IMG)),
        "output": ("tiny", lambda c: c.instruct_pix2pix("x", IMG,
                                                        output="png")),
        "empty_prompts": ("ip2p", lambda c: c.instruct_pix2pix([], IMG)),
    }[kind]


@pytest.mark.parametrize("kind", [
    "strength_zero", "strength_above_one", "image_shape", "image_dtype",
    "image_batch", "mask_shape", "mask_missing", "depth_shape",
    "img2img_on_9ch", "inpaint_on_5ch", "inpaint_on_8ch", "depth_on_4ch",
    "ip2p_on_4ch", "generate_on_9ch", "generate_batch_on_8ch",
    "hires_on_5ch", "hires_scale_one", "hires_scale_float",
    "hires_strength_one", "batch_empty", "batch_image", "batch_mask",
    "batch_strength", "batch_on_5ch", "batch_prompt", "lora", "batch_lora",
    "scheduled_prompt", "output", "empty_prompts"])
def test_context_refuses_bad_image_calls(kind):
    """Each of the reference's checks, as ``INVALID_ARGUMENT``, before any
    work; the Context stays usable."""
    name, call = _call(kind)
    c = ctx(name)
    with pytest.raises(SdtpuError) as ei:
        call(c)
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT, str(ei.value)
    assert not c._failed


@pytest.mark.parametrize("mode", ["img2img", "inpaint", "inpaint_9ch",
                                  "depth", "ip2p", "hires"])
def test_same_seed_same_bytes(mode):
    """One seed, the same bytes; another seed, others. A list of two
    prompts (and a negative prompt) gives a batch of two images."""
    name, call = {
        "img2img": ("tiny", lambda c, **kw: c.img2img(PROMPT, IMG, **kw)),
        "inpaint": ("tiny", lambda c, **kw: c.inpaint(PROMPT, IMG, MASK,
                                                      **kw)),
        "inpaint_9ch": ("inpaint", lambda c, **kw: c.inpaint(
            PROMPT, IMG, MASK, strength=0.7, **kw)),
        "depth": ("depth", lambda c, **kw: c.depth2img(
            PROMPT, IMG, np.linspace(0, 1, SIZE * SIZE).reshape(SIZE, SIZE),
            **kw)),
        "ip2p": ("ip2p", lambda c, **kw: c.instruct_pix2pix(PROMPT, IMG,
                                                            **kw)),
        "hires": ("tiny", lambda c, **kw: c.hires_fix(PROMPT, **kw)),
    }[mode]
    c = ctx(name)
    a = call(c, seed=3)
    scale = 2 if mode == "hires" else 1
    assert a.dtype == np.uint8 and a.shape == (SIZE * scale, SIZE * scale, 3)
    assert np.array_equal(a, call(c, seed=3))
    assert not np.array_equal(a, call(c, seed=4))
    assert not np.array_equal(a, call(c, seed=3, negative_prompt="blurry"))
    lat = call(c, seed=3, output="latent")
    assert lat.dtype == np.float32 and np.isfinite(lat).all()


def test_list_of_prompts_batches_the_images():
    c = ctx("tiny")
    imgs = np.stack([IMG, IMG[::-1]])
    out = c.img2img([PROMPT, "a red car"], imgs, seed=2)
    assert out.shape == (2, SIZE, SIZE, 3)
    masks = np.stack([MASK, 255 - MASK])
    assert c.inpaint([PROMPT, "a red car"], imgs, masks, seed=2).shape == (
        2, SIZE, SIZE, 3)


@pytest.mark.parametrize("mode", ["img2img", "inpaint", "inpaint_9ch"])
def test_batch_of_one_gives_the_single_calls_bytes(mode):
    """``img2img_batch``/``inpaint_batch`` of one request: one generator of
    its seed, the draws in the same order, the bytes of the single call."""
    name = "inpaint" if mode == "inpaint_9ch" else "tiny"
    c = ctx(name)
    req = {"prompt": PROMPT, "image": IMG, "seed": 7, "guidance": 4.0,
           "negative_prompt": "blurry"}
    if mode == "img2img":
        alone = c.img2img(PROMPT, IMG, strength=0.6, guidance=4.0, seed=7,
                          negative_prompt="blurry")
        got = c.img2img_batch([req], strength=0.6)
    else:
        alone = c.inpaint(PROMPT, IMG, MASK, strength=0.7, guidance=4.0,
                          seed=7, negative_prompt="blurry")
        got = c.inpaint_batch([{**req, "mask": MASK}], strength=0.7)
    assert len(got) == 1 and np.array_equal(got[0], alone)


def test_batch_pads_and_keeps_each_request():
    """Three requests padded to four: three images come back, each request
    with its own seed, guidance and negative prompt; a request's image does
    not depend on its batch-mates beyond rounding (the first request: its
    prompt sets the batch's window count, so it is encoded alike alone)."""
    c = ctx("tiny")
    reqs = [{"prompt": PROMPT, "image": IMG, "seed": 1},
            {"prompt": "a red car", "image": IMG[::-1].copy(), "seed": 2,
             "guidance": 1.0, "negative_prompt": "dark"},
            {"prompt": "a (blue:1.2) boat", "image": IMG, "seed": 3,
             "guidance": 3.0}]
    fin = c.img2img_batch_async(reqs, strength=0.5)
    out = fin()
    assert len(out) == 3 and all(o.shape == (SIZE, SIZE, 3) for o in out)
    alone = c.img2img_batch([reqs[0]], strength=0.5)[0]
    assert np.abs(out[0].astype(int) - alone.astype(int)).max() <= 1
    masks = [{**r, "mask": MASK} for r in reqs]
    assert len(c.inpaint_batch_async(masks)()) == 3


def test_full_mask_inpaint_is_img2img():
    """A mask of ones repaints everything: the re-pin and the paste blend in
    nothing, and the draws start as img2img's, so the bytes are
    img2img's."""
    c = ctx("tiny")
    full = np.full((SIZE, SIZE), 255, np.uint8)
    for strength in (0.6, 1.0):
        assert np.array_equal(
            c.inpaint(PROMPT, IMG, full, strength=strength, seed=5),
            c.img2img(PROMPT, IMG, strength=strength, seed=5))


@pytest.mark.parametrize("start_step", [0, 2])
def test_empty_mask_keeps_the_encoded_latents_exactly(start_step):
    """A mask of zeros keeps everything: the latents out of the loop are the
    image's posterior sample, bit for bit (the reference's
    tests/test_img2img.py:72)."""
    _, ttree = trees("tiny")
    tok, _, t_un = _text("tiny")
    _, x = _image(1, seed=22)
    post = _rand(*_shape(TINY_T), seed=23)
    lat = t_pipeline.inpaint(
        ttree, torch.from_numpy(tok), t_un,
        torch.Generator().manual_seed(1), 7.5, _t(x),
        torch.zeros((1, SIZE, SIZE, 1)), cfg=TINY_T, steps=STEPS,
        start_step=start_step, output="latent", posterior_noise=post)
    want = t_pipeline._encode_init_latents(ttree, _t(x), TINY_T, "plain",
                                           noise=_t(post))
    assert torch.equal(lat, want)


def _zero_taps(tree, extra):
    """The tree with its UNet's conv_in widened by ``extra`` zero input
    taps (the standard init of a concat checkpoint fine-tuned from a
    txt2img one)."""
    w = tree["unet"]["conv_in"]["w"]
    wide = torch.zeros((w.shape[0], w.shape[1] + extra, *w.shape[2:]))
    wide[:, : w.shape[1]] = w
    conv_in = {**tree["unet"]["conv_in"],
               "w": wide.contiguous(memory_format=torch.channels_last)}
    return {**tree, "unet": {**tree["unet"], "conv_in": conv_in}}


@pytest.mark.parametrize("name,extra", [("inpaint", 5), ("depth", 1),
                                        ("ip2p", 4)])
def test_zero_extra_taps_reproduce_the_4ch_result(name, extra):
    """``tests/test_concat_models.py``'s properties: with zero extra taps a
    9-ch inpaint at strength 1 is ``generate``, a 5-ch depth2img is
    ``img2img``, and ip2p's image slot is its uncond slot, so its dual CFG
    is ``generate``'s (within 1: conv sums over more channels)."""
    base = ctx("tiny")
    c = Context(config=CFGS[name][1], steps=STEPS, device="cpu")
    c.params = _zero_taps(base.params, extra)
    c._prepare_buffers()
    if name == "inpaint":
        a = base.generate(PROMPT, seed=11)
        b = c.inpaint(PROMPT, IMG, MASK, strength=1.0, seed=11)
    elif name == "depth":
        depth = np.linspace(0, 4000, SIZE * SIZE).reshape(SIZE, SIZE)
        a = base.img2img(PROMPT, IMG, strength=0.5, seed=3)
        b = c.depth2img(PROMPT, IMG, depth, strength=0.5, seed=3)
    else:
        a = base.generate(PROMPT, seed=8, guidance=7.5)
        b = c.instruct_pix2pix(PROMPT, IMG, guidance=7.5, image_guidance=1.3,
                               seed=8)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_concat_planes_act():
    """With random extra taps: ip2p's image guidance and its image change
    the result; the 9-ch inpaint's mask does; the depth plane does, up to
    an affine remap of its values (normalized per sample)."""
    c = ctx("ip2p")
    a = c.instruct_pix2pix(PROMPT, IMG, seed=6)
    assert not np.array_equal(a, c.instruct_pix2pix(
        PROMPT, IMG, image_guidance=3.0, seed=6))
    assert not np.array_equal(a, c.instruct_pix2pix(
        PROMPT, IMG[::-1].copy(), seed=6))
    c = ctx("inpaint")
    assert not np.array_equal(c.inpaint(PROMPT, IMG, MASK, seed=5),
                              c.inpaint(PROMPT, IMG, 255 - MASK, seed=5))
    c = ctx("depth")
    d1 = np.linspace(0, 1, SIZE * SIZE, dtype=np.float32).reshape(SIZE, SIZE)
    a = c.depth2img(PROMPT, IMG, d1, seed=2)
    assert not np.array_equal(a, c.depth2img(PROMPT, IMG, d1[::-1].copy(),
                                             seed=2))
    assert np.array_equal(a, c.depth2img(PROMPT, IMG, 3000.0 * d1 + 42.0,
                                         seed=2))


def test_image_paths_type_a_failure_and_stay_usable(monkeypatch):
    """A failure inside a call comes out as ``RUNTIME_ERROR`` and latches
    nothing."""
    c = ctx("tiny")

    def broken(*a, **kw):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(t_vae, "apply_encoder", broken)
    with pytest.raises(SdtpuError) as ei:
        c.img2img(PROMPT, IMG, seed=1)
    assert ei.value.code == ErrorCode.RUNTIME_ERROR
    monkeypatch.undo()
    assert c.img2img(PROMPT, IMG, seed=1).shape == (SIZE, SIZE, 3)


# ---------------------------------------------------------------------------
# checkpoints of the concat families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["inpaint", "depth", "ip2p", "xl_inpaint"])
def test_concat_trees_round_trip_a_bf16_ldm_file(name, tmp_path,
                                                 monkeypatch):
    """The demo tree with its 9-, 5- or 8-channel conv_in: exported by
    ``params_to_ldm`` as a BF16 LDM file, loaded under its config (the
    reference's loader reads the same file to the same tree), converted by
    ``convert_weights --config <the real name>`` (the real name stands for
    the TINY variant here) and served with the demo's bytes."""
    from sdtpu_torch.tools import convert_weights

    _, tcfg = CFGS[name]
    _, ttree = trees(name)
    real = {"inpaint": "sd15_inpaint", "depth": "sd2_depth",
            "ip2p": "sd15_ip2p", "xl_inpaint": "sdxl_inpaint"}[name]
    sd = t_weights.params_to_ldm(ttree, tcfg, dtype=torch.bfloat16)
    w = sd["model.diffusion_model.input_blocks.0.0.weight"]
    assert w.shape == (tcfg.unet.model_channels, tcfg.unet.in_channels, 3, 3)
    path = tmp_path / "m.safetensors"
    t_st.save_file(sd, path)
    back = t_weights.load_ldm_state_dict(t_st.load_file(path), tcfg)
    want = t_weights.load_ldm_state_dict(
        {k: v.float() for k, v in sd.items()}, tcfg)
    for (p, a), (_, b) in zip(_leaves(back), _leaves(want)):
        assert torch.equal(a, b), p
    j_tree = j_weights.load_ldm_state_dict(
        {k: v.float().numpy() for k, v in sd.items()}, CFGS[name][0])
    assert j_tree["unet"]["conv_in"]["w"].shape == (
        3, 3, tcfg.unet.in_channels, tcfg.unet.model_channels)
    assert real in t_config.CONFIGS
    monkeypatch.setitem(convert_weights.CONFIGS, real, tcfg)
    assert convert_weights.main([str(path), str(tmp_path / "out"),
                                 "--config", real, "--dtype",
                                 "float32"]) == 0
    served = Context(model_dir=str(tmp_path / "out"), config=tcfg,
                     steps=2, device="cpu")
    demo = Context(model_dir=str(path), config=tcfg, steps=2, device="cpu")
    mask = MASK if "inpaint" in name else None
    run = {"inpaint": lambda c: c.inpaint(PROMPT, IMG, mask, seed=3),
           "xl_inpaint": lambda c: c.inpaint(PROMPT, IMG, mask, seed=3),
           "depth": lambda c: c.depth2img(
               PROMPT, IMG, np.ones((SIZE, SIZE)) * np.arange(SIZE), seed=3),
           "ip2p": lambda c: c.instruct_pix2pix(PROMPT, IMG, seed=3)}[name]
    assert np.array_equal(run(served), run(demo))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_a_conv_in_of_another_width_is_refused_at_load():
    """A 4-ch (txt2img) file under a 9-ch config: the reference's loader
    returns the file's width as it is (its UNet then fails at the first
    conv_in); the port's loader holds every leaf to the config's shapes and
    refuses at load, naming the leaf, and ``Context(model_dir=)`` latches
    that as ``RUNTIME_ERROR`` "model load failed"."""
    _, ttree = trees("tiny")
    sd = t_weights.params_to_ldm(ttree, TINY_T)
    j_tree = j_weights.load_ldm_state_dict(
        {k: v.numpy() for k, v in sd.items()}, j_config.TINY_INPAINT)
    assert j_tree["unet"]["conv_in"]["w"].shape[2] == 4
    with pytest.raises(ValueError, match="unet.conv_in.w"):
        t_weights.load_ldm_state_dict(sd, t_config.TINY_INPAINT)


def test_context_refuses_a_conv_in_of_another_width(tmp_path):
    _, ttree = trees("tiny")
    t_st.save_file(t_weights.params_to_ldm(ttree, TINY_T),
                   tmp_path / "m.safetensors")
    with pytest.raises(SdtpuError) as ei:
        Context(model_dir=str(tmp_path), config=t_config.TINY_INPAINT,
                device="cpu")
    assert ei.value.code == ErrorCode.RUNTIME_ERROR
    assert "conv_in" in str(ei.value)
    assert t_context.Context is Context
