"""The port's SD 2.x and SDXL families against the JAX package, at TINY in
float32 on the CPU: the configurations, the OpenCLIP (GELU, penultimate) and
SDXL (``apply_xl``) text taps, the dual-tower packed ``encode_text``, the
additive conditioning, the UNet with head-dim heads and nested transformer
blocks, v-prediction under the one- and two-eval samplers, a 3-step SDXL
``generate``, the checkpoint layouts (OpenCLIP's fused qkv, the sgm naming,
native files) and ``Context``'s serving and refusals.

Both sides get the same weights: the port's own random init, carried to the
JAX package's layout by ``io.params.to_jax_tree``. Inputs are made with
numpy from a fixed seed; the JAX package's threefry draws reach the port
through the ``noise=``/``step_noise=`` seams. Module outputs are held within
1e-5 of the reference's max-abs, loops and the pipeline within 1e-4, loads
exactly.
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
from sdtpu.io import weights as j_weights
from sdtpu.models import clip as j_clip
from sdtpu.models import temb as j_temb
from sdtpu.models import unet as j_unet
from sdtpu.models.layers import timestep_features as j_timestep_features
from sdtpu_torch import Context, ErrorCode, SdtpuError
from sdtpu_torch import config as t_config
from sdtpu_torch.engine import pipeline as t_pipeline
from sdtpu_torch.io import safetensors as t_st
from sdtpu_torch.io import weights as t_weights
from sdtpu_torch.io.params import (from_jax_tree, init_pipeline_params,
                                   jax_layout, to_jax_tree)
from sdtpu_torch.models import clip as t_clip
from sdtpu_torch.models import layers as t_layers
from sdtpu_torch.models import temb as t_temb
from sdtpu_torch.models import unet as t_unet
from sdtpu_torch.tokenizer import DEMO_MERGES, Tokenizer


#: XLA:CPU compiles at backend optimization level 0: the same arithmetic,
#: compiled in a fraction of the time
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})

XL_J, XL_T = j_config.TINY_XL, t_config.TINY_XL


def _v_config(cfg):
    """TINY with SD2's shape: a GELU tower tapped at its penultimate
    block, head-dim heads (8: 2 and 4 heads at the two widths),
    v-prediction."""
    return dataclasses.replace(
        cfg, clip=dataclasses.replace(cfg.clip, act="gelu", penultimate=True),
        unet=dataclasses.replace(cfg.unet, num_heads=0, head_dim=8),
        prediction="v")


V_J, V_T = _v_config(j_config.TINY), _v_config(t_config.TINY)
L = XL_T.clip.context_len
PROMPT = "a photograph of an astronaut riding a horse"
STEPS = 3
# the JAX package's fold_in tag of a NEEDS_NOISE sampler's step i
ANCESTRAL_FOLD = 1 << 21


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


def _trees(cfg):
    ttree = init_pipeline_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    return to_jax_tree(ttree), ttree


@pytest.fixture(scope="module")
def xl():
    """(the JAX layout as numpy, the port's tree) of one TINY_XL init."""
    return _trees(XL_T)


@pytest.fixture(scope="module")
def v_trees():
    return _trees(V_T)


@pytest.fixture(scope="module")
def tok():
    return Tokenizer.from_merges(DEMO_MERGES)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def assert_close(ours, ref, rel=1e-5):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref, np.float32)
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


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["SD21", "SD21_BASE", "SDXL", "TINY_XL"])
def test_config_matches_jax(name):
    """Every field the port carries is the reference's, tower by tower;
    the depth helpers agree level by level."""
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


def test_config_registry_covers_the_references():
    """The port serves every name of the reference's registry: sd15, sd21,
    sd21base and sdxl, their concat-conditioned variants, the staged
    sd15_lcm, sd_x4 and sdxl_refiner, and the TINY test configurations
    (the C API and the CLI take them by name)."""
    assert set(t_config.CONFIGS) == set(j_config.CONFIGS)
    ref = {n for n in j_config.CONFIGS if not n.startswith("tiny")}
    ours = {n for n in t_config.CONFIGS if not n.startswith("tiny")}
    assert ours == ref == {
        "sd15", "sd21", "sd21base", "sdxl", "sd15_inpaint", "sd21_inpaint",
        "sdxl_inpaint", "sd2_depth", "sd15_ip2p", "sd15_lcm", "sd_x4",
        "sdxl_refiner"}
    for name in ours:
        assert t_config.CONFIGS[name] == getattr(
            t_config, {"sd21base": "SD21_BASE", "sd2_depth": "SD2_DEPTH"}.get(
                name, name.upper()))


# ---------------------------------------------------------------------------
# text towers
# ---------------------------------------------------------------------------

def _tokens(rows, seed=0, eot=None):
    """[rows, L] random ids of the TINY vocabulary, the eot id at a
    different position in each row (and none in the last)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, XL_T.clip.vocab_size - 1, (rows, L))
    eot = XL_T.clip.vocab_size - 1 if eot is None else eot
    for r in range(rows - 1):
        t[r, 3 + 2 * r:] = eot
    return t.astype(np.int32)


@pytest.mark.parametrize("penultimate,skip", [(False, 0), (True, 0),
                                              (False, 2)])
def test_clip_apply_gelu_tower_matches_jax(xl, penultimate, skip):
    """``clip.apply`` on a GELU tower (TINY_XL's second, three blocks):
    the full stack, SD2's penultimate tap and a clip skip, each with the
    final LN."""
    jtree, ttree = xl
    cfg_t = dataclasses.replace(XL_T.clip2, penultimate=penultimate,
                                skip_last=skip)
    cfg_j = dataclasses.replace(XL_J.clip2, penultimate=penultimate,
                                skip_last=skip)
    toks = _tokens(3)
    ref = j_clip.apply(jtree["clip2"], jnp.asarray(toks), cfg_j)
    ours = t_clip.apply(ttree["clip2"], torch.from_numpy(toks), cfg_t)
    assert_close(ours, ref)


@pytest.mark.parametrize("tower", ["clip", "clip2"])
def test_apply_xl_matches_jax(xl, tower):
    """SDXL's tap: the penultimate hidden state without the final LN, and
    (bigG only) the pooled embedding at the first eot of each row through
    ``text_proj`` (48 -> 16: a transposed projection would not even
    multiply)."""
    jtree, ttree = xl
    cfg_t, cfg_j = getattr(XL_T, tower), getattr(XL_J, tower)
    eot = cfg_t.vocab_size - 1
    toks = _tokens(3, seed=1)
    h_ref, p_ref = j_clip.apply_xl(jtree[tower], jnp.asarray(toks), cfg_j,
                                   eot)
    h, p = t_clip.apply_xl(ttree[tower], torch.from_numpy(toks), cfg_t, eot)
    assert_close(h, h_ref)
    assert (p is None) == (p_ref is None) == (tower == "clip")
    if p is not None:
        assert p.shape == (3, 16)
        assert_close(p, p_ref)


_encode_xl = _jit(functools.partial(j_pipeline.encode_text, cfg=XL_J))


def test_encode_text_dual_tower_matches_jax(xl, tok):
    """The packed dual-tower encode: one window [B, T] -> [B, T+1, 80],
    and the chunked, weighted form [B, k, T] -> [B, k*T+1, 80] (the
    weights shape the hidden states only, the pooled row comes from window
    0); all-ones weights are an exact no-op."""
    from sdtpu_torch import text as t_text

    jtree, ttree = xl
    one = np.array([tok.tokenize(t, L) for t in (PROMPT, "")], np.int32)
    ref = _encode_xl(jtree, jnp.asarray(one))
    ours = t_pipeline.encode_text(ttree, torch.from_numpy(one).long(), XL_T)
    assert ours.shape == (2, L + 1, XL_T.unet.context_dim)
    assert_close(ours, ref)
    texts = ["a (red:1.4) car, [blurry]", "a cat, " * 8]
    per = [t_text.chunked_tokens(tok, t, L, min_chunks=3) for t in texts]
    toks = np.stack([t for t, _ in per])
    w = np.stack([w for _, w in per])
    assert (w != 1.0).any()
    ref = _encode_xl(jtree, jnp.asarray(toks), weights=jnp.asarray(w))
    ours = t_pipeline.encode_text(ttree, torch.from_numpy(toks).long(), XL_T,
                                  torch.from_numpy(w))
    assert ours.shape == (2, 3 * L + 1, XL_T.unet.context_dim)
    assert_close(ours, ref)
    plain = t_pipeline.encode_text(ttree, torch.from_numpy(toks).long(), XL_T)
    assert torch.equal(plain, t_pipeline.encode_text(
        ttree, torch.from_numpy(toks).long(), XL_T, torch.ones(2, 3, L)))
    ctx, pooled = t_pipeline._unpack_context(ours, XL_T)
    assert ctx.shape == (2, 3 * L, 80) and pooled.shape == (2, 16)
    # attn2's k and v read the context: the int8 GEMM kernels' rule
    # (ops.matmul.eligible) takes contiguous activations only
    assert ctx.is_contiguous()
    assert not ours[:, -1, 16:].any()


def test_micro_features_and_add_embedding_match_jax(xl):
    """``timestep_features``' [cos | sin] order, the six micro-conditions
    (H, W, 0, 0, H, W) and the additive embedding of a pooled batch."""
    jtree, ttree = xl
    t = np.array([0.0, 1.0, 999.0, 16.0], np.float32)
    assert_close(t_layers.timestep_features(torch.from_numpy(t), 8),
                 j_timestep_features(jnp.asarray(t), 8), rel=1e-6)
    assert_close(t_temb.micro_features(XL_T, 8),
                 j_temb.micro_features(XL_J, 8), rel=1e-6)
    pooled = _rand(4, 16, seed=3)
    ref = j_pipeline._add_embedding(jtree, jnp.asarray(pooled), XL_J)
    ours = t_pipeline._add_embedding(ttree, torch.from_numpy(pooled), XL_T)
    assert ours.shape == (4, XL_T.unet.time_embed_dim)
    assert_close(ours, ref)


# ---------------------------------------------------------------------------
# the UNet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["xl", "head_dim"])
def test_unet_matches_jax(xl, v_trees, which):
    """TINY_XL's UNet (no attention at level 0, depth-2 transformers at
    level 1 and the mid block, nested under ``blocks``) with the additive
    embedding on the time embedding; and the head-dim UNet (heads = C /
    8)."""
    (jtree, ttree), cj, ct = ((xl, XL_J, XL_T) if which == "xl"
                              else (v_trees, V_J, V_T))
    n, s = 2, ct.latent_size
    x = _rand(n, s, s, 4, seed=4)
    te = _rand(n, ct.unet.time_embed_dim, seed=5)
    ctx = _rand(n, L, ct.unet.context_dim, seed=6)
    if which == "xl":
        assert len(ttree["unet"]["mid"]["st"]["blocks"]) == 2
        assert "st" not in ttree["unet"]["down"][0]["blocks"][0]
        add = t_pipeline._add_embedding(ttree, torch.from_numpy(
            _rand(n, 16, seed=7)), ct).numpy()
        te = te + add
    ref = j_unet.apply(jtree["unet"], jnp.asarray(x), jnp.asarray(te),
                       jnp.asarray(ctx), cj.unet, "xla")
    ours = t_unet.apply(ttree["unet"], torch.from_numpy(x),
                        torch.from_numpy(te), torch.from_numpy(ctx), ct.unet)
    assert_close(ours, ref)
    assert t_unet._heads(ct.unet, 32) == j_unet._heads(cj.unet, 32)


# ---------------------------------------------------------------------------
# v-prediction and the SDXL pipeline
# ---------------------------------------------------------------------------

def _jax_draws(seed, shape):
    key = jax.random.PRNGKey(seed)
    x = np.array(jax.random.normal(key, shape, jnp.float32))
    n = np.stack([np.array(jax.random.normal(
        jax.random.fold_in(key, ANCESTRAL_FOLD + i), shape, jnp.float32))
        for i in range(STEPS)])
    return x, n


@pytest.mark.parametrize("sampler", ["dpm", "heun", "euler_a"])
def test_denoise_v_prediction_matches_jax(v_trees, sampler):
    """``denoise`` of a v-prediction model: eps = alpha*v + sigma*x_t per
    CFG slot before the mix, at the probe point's marginals on heun's
    second eval; the reference's draws injected; within 1e-4."""
    jtree, ttree = v_trees
    ctx = _rand(2, L, V_T.unet.context_dim, seed=8)
    shape = (1, V_T.latent_size, V_T.latent_size, 4)
    ref = _jit(functools.partial(
        j_pipeline.denoise, cfg=V_J, sampler=sampler, steps=STEPS,
        use_cfg=True, kernels="xla"))(jtree, jnp.asarray(ctx),
                                      jax.random.PRNGKey(9), 7.5)
    x, n = _jax_draws(9, shape)
    ours = t_pipeline.denoise(ttree, torch.from_numpy(ctx), 7.5, V_T, STEPS,
                              True, noise=torch.from_numpy(x),
                              sampler=sampler, step_noise=torch.from_numpy(n))
    assert_close(ours, ref, rel=1e-4)


def test_generate_xl_matches_jax(xl, tok):
    """A 3-step TINY_XL ``generate`` (packed context, the additive
    embedding on every step, CFG 7.5) against the reference's with its
    draws injected: latents within 1e-4, images within 1."""
    jtree, ttree = xl
    tokens = np.array([tok.tokenize(PROMPT, L)], np.int32)
    unc = _encode_xl(jtree, jnp.asarray([tok.tokenize("", L)], jnp.int32))[0]
    j_lat = _jit(functools.partial(
        j_pipeline.generate, cfg=XL_J, sampler="dpm", steps=STEPS,
        kernels="xla", output="latent"))(
        jtree, jnp.asarray(tokens), unc, jax.random.PRNGKey(5),
        jnp.float32(7.5))
    x, _ = _jax_draws(5, (1, 8, 8, 4))
    t_unc = t_pipeline.encode_text(ttree, torch.tensor(
        [tok.tokenize("", L)]), XL_T)[0]
    assert t_unc.shape == (L + 1, 80)
    t_lat = t_pipeline.generate(
        ttree, torch.from_numpy(tokens).long(), t_unc, None, 7.5, cfg=XL_T,
        sampler="dpm", steps=STEPS, noise=x, output="latent")
    assert_close(t_lat, j_lat, rel=1e-4)
    j_img = np.asarray(j_pipeline.decode_latents(jtree, j_lat, XL_J))
    t_img = t_pipeline.decode_latents(ttree, t_lat, XL_T).numpy()
    assert np.abs(t_img.astype(int) - j_img.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", ["unet_rules", "vae_rules", "all_rules",
                                   "clip_rules"])
@pytest.mark.parametrize("name", ["SD21", "SDXL", "TINY_XL"])
def test_rule_tables_match_jax(name, table):
    """Name by name and kind by kind at full width (no weights): the
    transformer depth, the nested block paths, ``label_emb`` -> add_mlp;
    SDXL's tower 1 under its sgm prefix."""
    kw = ({"pre": j_weights.XL_CLIP_PREFIX}
          if table == "clip_rules" and name != "SD21" else {})
    ours = getattr(t_weights, table)(getattr(t_config, name), **kw)
    ref = getattr(j_weights, table)(getattr(j_config, name), **kw)
    assert [tuple(r) for r in ours] == [tuple(r) for r in ref]


def _np(sd):
    return {k: np.asarray(v.float().numpy() if torch.is_tensor(v) else v,
                          np.float32) for k, v in sd.items()}


def test_openclip_ldm_load_matches_jax(v_trees):
    """An SD2 checkpoint (OpenCLIP tower: fused in_proj q/k/v, a block
    beyond the pre-cut config's that is ignored, HF-free naming) in bf16:
    the port's load equals ``from_jax_tree`` of the reference's, exactly;
    ``tree_to_openclip_text`` is the reference's, key by key."""
    jtree, ttree = v_trees
    sd = {k: v for k, v in t_weights.params_to_ldm(ttree, V_T).items()
          if not k.startswith("cond_stage_model.")}
    oc = t_weights.tree_to_openclip_text(jax_layout(ttree)["clip"])
    ref_oc = j_weights.tree_to_openclip_text(jtree["clip"], V_J)
    assert oc.keys() == ref_oc.keys()
    for k, v in ref_oc.items():
        np.testing.assert_array_equal(oc[k].numpy(), v, err_msg=k)
    sd.update(oc)
    last = V_T.clip.layers
    for k in [k for k in oc if ".resblocks.0." in k]:
        sd[k.replace(".resblocks.0.", f".resblocks.{last}.")] = oc[k] + 1.0
    sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    ours = t_weights.load_ldm_state_dict(sd, V_T)
    ref = j_weights.load_ldm_state_dict(_np(sd), V_J)
    assert_trees_equal(ours, from_jax_tree(ref, V_T))
    assert len(ours["clip"]["blocks"]) == last


def test_sgm_ldm_round_trip_matches_jax(xl, tmp_path):
    """SDXL in the sgm naming: ``params_to_ldm`` is the reference's key by
    key (bigG's fused qkv and ``text_projection`` as it is, ``label_emb``),
    and a BF16 file of it loads as the reference loads it, exactly."""
    jtree, ttree = xl
    ours = t_weights.params_to_ldm(ttree, XL_T)
    ref = j_weights.params_to_ldm(jtree, XL_J)
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    proj = "conditioner.embedders.1.model.text_projection"
    assert tuple(ours[proj].shape) == (48, 16)
    t_st.save_file({k: v.to(torch.bfloat16) for k, v in ours.items()},
                   tmp_path / "xl.safetensors")
    sd = t_st.load_file(tmp_path / "xl.safetensors")
    assert_trees_equal(t_weights.load_ldm_state_dict(sd, XL_T),
                       from_jax_tree(j_weights.load_ldm_state_dict(
                           _np(sd), XL_J), XL_T))


def test_native_files_cross_between_the_packages(xl, tmp_path):
    """A TINY_XL native file (``clip2``, ``add_mlp``, the nested blocks)
    written by either package loads in the other as the same tree."""
    jtree, ttree = xl
    t_weights.save_native(ttree, tmp_path / "t.sdtpu.safetensors")
    got = dict(_leaves(j_weights.load_native(tmp_path / "t.sdtpu.safetensors")))
    want = dict(_leaves(jtree))
    assert got.keys() == want.keys()
    for p, a in got.items():
        np.testing.assert_array_equal(np.asarray(a), want[p], err_msg=str(p))
    j_weights.save_native(jtree, tmp_path / "j.sdtpu.safetensors")
    assert_trees_equal(t_weights.load_native(
        tmp_path / "j.sdtpu.safetensors", XL_T), ttree)


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ctx_xl():
    return Context(config=XL_T, steps=STEPS, device="cpu")


def test_context_xl_serves_batches_and_negatives(ctx_xl):
    """The cached uncond is the encoded "" with its pooled row; a batch of
    one gives ``generate``'s bytes; a negative prompt changes the image."""
    c = ctx_xl
    assert c._uncond.shape == (L + 1, XL_T.unet.context_dim)
    img = c.generate(PROMPT, seed=4)
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    assert np.array_equal(img, c.generate_batch(
        [{"prompt": PROMPT, "seed": 4}])[0])
    neg = c.generate(PROMPT, seed=4, negative_prompt="blurry")
    assert not np.array_equal(img, neg)
    assert np.array_equal(neg, c.generate_batch(
        [{"prompt": PROMPT, "seed": 4, "negative_prompt": "blurry"}])[0])


def test_context_xl_textual_inversion(ctx_xl, tmp_path):
    """An XL embedding file (``clip_l`` and ``clip_g``) whose vectors are
    the rows of "horse" in each tower gives the bytes of the word; one
    tower alone is refused."""
    c = Context(config=XL_T, steps=STEPS, device="cpu")
    ids = c.tokenizer.encode("horse")
    rows = {"clip_l": c.params["clip"]["token_embedding"][ids],
            "clip_g": c.params["clip2"]["token_embedding"][ids]}
    t_st.save_file(rows, tmp_path / "steed.safetensors")
    c.load_embedding("<steed>", tmp_path / "steed.safetensors")
    want = ctx_xl.generate(PROMPT, seed=6)
    assert np.array_equal(c.generate(PROMPT.replace("horse", "<steed>"),
                                     seed=6), want)
    with pytest.raises(SdtpuError) as ei:
        c.load_embedding("<one>", {"clip_l": rows["clip_l"]})
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert "clip_g" in str(ei.value)


def test_v_prediction_context_degenerate_schedule(v_trees):
    """On a single-tower v-prediction configuration prompt scheduling
    runs, and a degenerate schedule gives the plain prompt's bytes."""
    c = Context(config=V_T, steps=STEPS, device="cpu")
    c.params = v_trees[1]
    c._prepare_buffers()
    short = "a horse on a beach"     # one window of TINY's 16 tokens
    plain = c.generate(short, seed=2)
    assert np.array_equal(c.generate(f"[{short}:{short}:0.5]", seed=2),
                          plain)
    assert not np.array_equal(c.generate("a [cat:dog:0.5] on a sofa",
                                         seed=2), plain)


@pytest.mark.parametrize("name", ["sd15_lcm", "sd_x4", "sdxl_refiner"])
def test_context_refuses_the_other_reference_configs(name, monkeypatch):
    """The reference's staged names, which the port once refused, resolve
    to configurations equal to the reference's field by field, tower by
    tower (no weights are built: the load phases are stubbed)."""
    for phase in ("_load_models", "_load_tokenizer", "_prepare_buffers"):
        monkeypatch.setattr(Context, phase, lambda self: None)
    ctx = Context(config=name, device="cpu")
    ours, ref = ctx.cfg, j_config.CONFIGS[name]
    assert ours is t_config.CONFIGS[name]
    for sub in ("clip", "clip2", "unet", "vae", None):
        o = getattr(ours, sub) if sub else ours
        r = getattr(ref, sub) if sub else ref
        assert (o is None) == (r is None), sub
        for f in dataclasses.fields(o) if o is not None else ():
            if f.name not in ("clip", "clip2", "unet", "vae"):
                assert getattr(o, f.name) == getattr(r, f.name), (sub, f.name)


def test_context_refuses_a_refiner_config():
    """A config object with the refiner's layout (TINY_XL_REF) is served:
    one text tower, no ``clip`` tree, a standalone image."""
    c = Context(config=t_config.TINY_XL_REF, steps=2, device="cpu")
    assert "clip" not in c.params and "clip2" in c.params
    img = c.generate(PROMPT, seed=1)
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    assert img.std() > 0


@pytest.mark.parametrize("config", ["sdxl", XL_T])
def test_clip_skip_is_refused_on_a_dual_tower_config(config):
    """The reference's guard: XL's towers already tap their penultimate
    blocks (refused before any weight is built)."""
    with pytest.raises(SdtpuError) as ei:
        Context(config=config, device="cpu", clip_skip=2)
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert "single-tower" in str(ei.value)


@pytest.mark.parametrize("call", [
    lambda c: c.generate(f"[{PROMPT}:{PROMPT}:0.5]"),
    lambda c: c.generate("a [cat|dog]"),
])
def test_xl_refuses_prompt_scheduling(ctx_xl, call):
    """Scheduling is single-tower only, as in the reference
    (``sdtpu/engine/context.py:851-855``)."""
    with pytest.raises(SdtpuError) as ei:
        call(ctx_xl)
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert "single-tower" in str(ei.value)


@pytest.mark.parametrize("keys,config,text", [
    (["conditioner.embedders.0.model.ln_final.weight"], XL_T, "refiner"),
    (["control_model.input_blocks.0.0.weight"], XL_T, "ControlNet"),
    (["cond_stage_model.model.ln_final.weight"], XL_T, "SD1.x/2.x"),
    (["conditioner.embedders.1.model.ln_final.weight"], V_T, "SDXL"),
])
def test_context_refuses_other_families(tmp_path, keys, config, text):
    """A ControlNet checkpoint, and a family that is not the
    configuration's (the refiner's one bigG tower on the SDXL base), are
    ``INVALID_ARGUMENT`` before any weight is read."""
    t_st.save_file({k: torch.ones(4) for k in keys},
                   tmp_path / "m.safetensors")
    with pytest.raises(SdtpuError) as ei:
        Context(model_dir=str(tmp_path), config=config, device="cpu")
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert text in str(ei.value)


def test_converter_takes_the_families(xl, tmp_path, monkeypatch):
    """``convert_weights`` on an sgm-named TINY_XL checkpoint: with
    ``--int8w dense`` the native file serves (``quantize="none"``) the bytes
    of the demo Context quantized at load; with ``--int8`` it carries the
    W8A8 sites of all 8 basic blocks' 10 matmuls (depth 2: one transformer
    down, the mid block's, two up)."""
    from sdtpu_torch.quant.ptq import count_quantized
    from sdtpu_torch.tools import convert_weights

    _, ttree = xl
    monkeypatch.setitem(convert_weights.CONFIGS, "tiny_xl", XL_T)
    ldm = tmp_path / "xl.safetensors"
    t_st.save_file(t_weights.params_to_ldm(ttree, XL_T), ldm)
    for out, extra in (("w8", ["--int8w", "dense"]), ("i8", ["--int8"])):
        assert convert_weights.main([str(ldm), str(tmp_path / out),
                                     "--config", "tiny_xl", "--dtype",
                                     "float32", *extra]) == 0
    served = Context(model_dir=str(tmp_path / "w8"), config=XL_T, steps=2,
                     device="cpu")
    demo = Context(config=XL_T, steps=2, device="cpu",
                   quantize="int8w_dense")
    assert np.array_equal(served.generate(PROMPT, seed=3),
                          demo.generate(PROMPT, seed=3))
    native = t_weights.load_native(
        tmp_path / "i8" / f"model{t_weights.NATIVE_SUFFIX}", XL_T)
    assert count_quantized(native) == 8 * 10
