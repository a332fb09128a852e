"""The port's per-request adapters against the JAX package, at TINY and
TINY_XL in float32 on the CPU:

* ControlNet: ``_hint_strides``, ``embed_hint`` and ``controlnet.apply``,
  ``unet.apply(control=)`` (a zero-initialised adapter is the identity; the
  residual count and DeepCache texts), the loop with hints
  (``pipeline.generate``: one adapter under CFG, two with a list of scales,
  LCM without a CFG pair, heun's second table, PAG, the CFG interval,
  TINY_XL's additive embedding), the DeepCache refusal in the reference's
  order, the LDM rules both ways, and ``Context``'s surface
  (``load_controlnet`` from each source, every ``_resolve_control`` text,
  ``control_scale=0``, a hint of batch one over two prompts, scheduling,
  latents);
* LoRA: the delta at dense and conv sites on every base path (plain,
  weight-only int8, W8A8, a 1x1 int8 conv) against the reference's ``xla``
  path, the adapter rule at fused conv sites (``cuda_conv`` launches the
  fused conv a second time for the delta's down conv and gives the
  ``plain`` result), native ``.npz`` files with
  sparse list slots both ways, kohya files both ways and their site maps
  at TINY, TINY_XL, SD1.5 and SDXL, and ``Context``'s surface (the
  constructor's forms, the default adapter and ``lora=""``, the batch rule,
  every entry point that takes ``lora``, quantized bases, a replaced
  adapter, ``fuse_qkv``).

Both sides get the same weights: the reference's random ControlNet carried
to the port by ``io.params.from_jax_tree``, the port's pipeline init
carried to the JAX package's layout by ``to_jax_tree``. Inputs are made with
numpy from a fixed seed; the reference's start latents reach the port
through ``noise=``. The reference's loops run with ``lax.scan`` as a Python
loop and its models jitted once per shape (``tests/test_torch_image.py``).
Modules are held within 1e-5 of the reference's max-abs, loops within 1e-4,
images within 1, loaded trees exactly.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu import config as j_config
from sdtpu.engine import context as j_context
from sdtpu.engine import errors as j_errors
from sdtpu.engine import pipeline as j_pipeline
from sdtpu.io import kohya as j_kohya
from sdtpu.io import params as j_params
from sdtpu.io import weights as j_weights
from sdtpu.models import controlnet as j_cn
from sdtpu.models import layers as j_layers
from sdtpu.models import temb as j_temb
from sdtpu.models import unet as j_unet
from sdtpu.models import vae as j_vae
from sdtpu.ops import matmul as j_mm
from sdtpu.train import lora as j_lora
from sdtpu_torch import Context, ErrorCode, SdtpuError
from sdtpu_torch import config as t_config
from sdtpu_torch.engine import pipeline as t_pipeline
from sdtpu_torch.io import kohya as t_kohya
from sdtpu_torch.io import safetensors as t_st
from sdtpu_torch.io import weights as t_weights
from sdtpu_torch.io.params import (fuse_attention_projections, from_jax_tree,
                                   init_pipeline_params, jax_layout,
                                   to_jax_tree)
from sdtpu_torch.models import controlnet as t_cn
from sdtpu_torch.models import layers as t_layers
from sdtpu_torch.models import temb as t_temb
from sdtpu_torch.models import unet as t_unet
from sdtpu_torch.ops.matmul import column_major
from sdtpu_torch.train import lora as t_lora
from test_torch_image import (_encode_text_once, _jit, _normal_draw,
                              _scan_as_loop)

STEPS = 4
#: the reference's fold_in tag of a NEEDS_NOISE sampler's step i
ANCESTRAL_FOLD = 1 << 21
#: the reference's UNet as the module defines it (the ``ref`` fixture jits
#: it, with ``deep`` static)
J_UNET_APPLY = j_unet.apply
#: ... and jitted once per shape, for the tests that run it whole
_J_UNET = _jit(J_UNET_APPLY, static_argnums=(4, 5),
               static_argnames=("deep", "perturb"))
PROMPT = "a photograph of an astronaut riding a horse"

# name -> (the JAX config, the port's)
CFGS = {name: (getattr(j_config, attr), getattr(t_config, attr))
        for name, attr in (("tiny", "TINY"), ("xl", "TINY_XL"),
                           ("lcm", "TINY_LCM"))}


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


_CNS = {}


def cns(name, seed=1):
    """(a random ControlNet in the reference's tree of ``CFGS[name]``, the
    port's tree of it by ``from_jax_tree``), made once: the tree's shapes
    from the reference's ``init`` (traced, not run), every leaf drawn with
    numpy, uniform within 1/sqrt(fan-in) (norm scales around 1), so no
    zero conv is zero."""
    key = (name, seed)
    if key not in _CNS:
        jcfg, tcfg = CFGS[name]
        shapes = jax.eval_shape(
            lambda k: j_cn.init(k, jcfg.unet, zero_init_outs=False),
            jax.random.PRNGKey(0))
        rng = np.random.default_rng(seed)

        def draw(path, sd):
            u = rng.uniform(-1.0, 1.0, sd.shape).astype(np.float32)
            if getattr(path[-1], "key", None) == "scale":
                return jnp.asarray(1.0 + 0.1 * u)
            fan = int(np.prod(sd.shape[:-1])) if len(sd.shape) > 1 else 16
            return jnp.asarray(u / np.sqrt(fan))

        j = jax.tree_util.tree_map_with_path(draw, shapes)
        _CNS[key] = (j, from_jax_tree({"controlnet": j}, tcfg)["controlnet"])
    return _CNS[key]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's pipeline module with its scan taken as a loop and
    its models, the ControlNet's too, jitted once per shape."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.lax, "scan", _scan_as_loop)
    mp.setattr(jax.random, "normal", _normal_draw)
    mp.setattr(j_unet, "apply", _jit(
        j_unet.apply, static_argnums=(4, 5),
        static_argnames=("deep", "perturb")))
    mp.setattr(j_vae, "apply", _jit(j_vae.apply, static_argnums=(2, 3)))
    mp.setattr(j_cn, "apply", _jit(j_cn.apply, static_argnums=(5, 6)))
    mp.setattr(j_cn, "embed_hint", _jit(j_cn.embed_hint,
                                        static_argnums=(2,)))
    mp.setattr(j_pipeline, "encode_text", _encode_text_once)
    yield j_pipeline
    mp.undo()


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
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def assert_trees_equal(ours, ref):
    a, b = dict(_leaves(ours)), dict(_leaves(ref))
    assert a.keys() == b.keys()
    for path, t in a.items():
        u = torch.as_tensor(np.asarray(b[path]))
        assert t.shape == u.shape, path
        assert torch.equal(t.float(), u.float()), path


def _unet_inputs(cfg, b=2, seed=0):
    """Latents, a time embedding and a context for one UNet eval."""
    s, u = cfg.latent_size, cfg.unet
    return (_rand(b, s, s, u.in_channels, seed=seed),
            _rand(b, u.time_embed_dim, seed=seed + 1),
            _rand(b, cfg.clip.context_len, u.context_dim, seed=seed + 2))


def _hint(cfg, b=1, seed=5):
    return np.random.default_rng(seed).random(
        (b, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# ControlNet: the module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor", [1, 2, 4, 8])
def test_hint_strides_match_jax(factor):
    assert t_cn._hint_strides(factor) == j_cn._hint_strides(factor)
    assert t_cn.HINT_CHANNELS == j_cn.HINT_CHANNELS


@pytest.mark.parametrize("factor", [3, 16])
def test_hint_strides_refuse_with_the_references_text(factor):
    with pytest.raises(ValueError) as ours:
        t_cn._hint_strides(factor)
    with pytest.raises(ValueError) as theirs:
        j_cn._hint_strides(factor)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("name", ["tiny", "xl"])
def test_controlnet_matches_jax(ref, name):
    """``embed_hint`` and one ``controlnet.apply`` of random weights (the
    zero convs drawn) within 1e-5 of the reference's, every residual; the
    port's kernel policies give the plain result on the CPU."""
    jcfg, tcfg = CFGS[name]
    jp, tp = cns(name)
    h = _hint(tcfg, 2)
    feats_j = j_cn.embed_hint(jp, jnp.asarray(h), jcfg.upscale)
    feats_t = t_cn.embed_hint(tp, torch.from_numpy(h), tcfg.upscale)
    assert_close(feats_t, feats_j)
    x, te, ctx = _unet_inputs(tcfg)
    d_j, m_j = j_cn.apply(jp, jnp.asarray(x), feats_j, jnp.asarray(te),
                          jnp.asarray(ctx), jcfg.unet)
    for kernels in ("plain", "cuda_conv"):
        d_t, m_t = t_cn.apply(tp, torch.from_numpy(x), feats_t,
                              torch.from_numpy(te), torch.from_numpy(ctx),
                              tcfg.unet, kernels)
        assert len(d_t) == len(d_j)
        for a, b in zip(d_t, d_j):
            assert_close(a, b)
        assert_close(m_t, m_j)


def test_controlnet_init_has_the_references_shapes():
    """The port's init, its LCM form too (no ``cond_proj``: no eval reads
    it), against the reference's tree through ``from_jax_tree``."""
    for name in ("tiny", "xl", "lcm"):
        tcfg = CFGS[name][1]
        ours = t_cn.init(tcfg.unet, None, "meta")
        theirs = cns(name)[1]
        a, b = dict(_leaves(ours)), dict(_leaves(theirs))
        assert a.keys() == b.keys()
        assert all(a[k].shape == b[k].shape for k in a)
    assert "cond_proj" not in cns("lcm")[1]["temb"]


def test_unet_with_control_matches_jax():
    """The residuals added to the skips and the mid output, within 1e-5."""
    jcfg, tcfg = CFGS["tiny"]
    jtree, ttree = trees("tiny")
    x, te, ctx = _unet_inputs(tcfg)
    n = 1 + len(tcfg.unet.channel_mult) * tcfg.unet.num_res_blocks + (
        len(tcfg.unet.channel_mult) - 1)
    shapes = [(2, 8, 8, 16), (2, 8, 8, 16), (2, 4, 4, 16), (2, 4, 4, 32)]
    down = [_rand(*s, seed=10 + i) for i, s in enumerate(shapes)]
    mid = _rand(2, 4, 4, 32, seed=20)
    assert len(down) == n
    want = _J_UNET(jtree["unet"], jnp.asarray(x), jnp.asarray(te),
                   jnp.asarray(ctx), jcfg.unet,
                        control=(tuple(map(jnp.asarray, down)),
                                 jnp.asarray(mid)))
    got = t_unet.apply(ttree["unet"], torch.from_numpy(x),
                       torch.from_numpy(te), torch.from_numpy(ctx),
                       tcfg.unet, control=(tuple(map(torch.from_numpy, down)),
                                           torch.from_numpy(mid)))
    assert_close(got, want)


def test_zero_init_controlnet_is_the_identity():
    """A fresh adapter (zero convs at zero) leaves the UNet's eps as it
    is, bit for bit."""
    tcfg = CFGS["tiny"][1]
    ttree = trees("tiny")[1]
    tp = t_cn.init(tcfg.unet, torch.Generator().manual_seed(3), "cpu")
    x, te, ctx = map(torch.from_numpy, _unet_inputs(tcfg))
    feats = t_cn.embed_hint(tp, torch.from_numpy(_hint(tcfg, 2)), 2)
    ctrl = t_cn.apply(tp, x, feats, te, ctx, tcfg.unet)
    base = t_unet.apply(ttree["unet"], x, te, ctx, tcfg.unet)
    assert torch.equal(t_unet.apply(ttree["unet"], x, te, ctx, tcfg.unet,
                                    control=ctrl), base)


@pytest.mark.parametrize("case", ["count", "shallow"])
def test_unet_control_errors_have_the_references_text(case):
    """The residual count check, and a DeepCache shallow pass with
    control."""
    jcfg, tcfg = CFGS["tiny"]
    jtree, ttree = trees("tiny")
    x, te, ctx = _unet_inputs(tcfg)
    r = _rand(2, 8, 8, 16)
    apply = J_UNET_APPLY
    if case == "count":
        apply = _J_UNET
        kw_j = dict(control=((jnp.asarray(r),), jnp.asarray(r)))
        kw_t = dict(control=((torch.from_numpy(r),), torch.from_numpy(r)))
    else:
        kw_j = dict(control=((), jnp.asarray(r)), deep=jnp.asarray(r))
        kw_t = dict(control=((), torch.from_numpy(r)),
                    deep=torch.from_numpy(r))
    with pytest.raises(ValueError) as theirs:
        apply(jtree["unet"], jnp.asarray(x), jnp.asarray(te),
              jnp.asarray(ctx), jcfg.unet, **kw_j)
    with pytest.raises(ValueError) as ours:
        t_unet.apply(ttree["unet"], torch.from_numpy(x), torch.from_numpy(te),
                     torch.from_numpy(ctx), tcfg.unet, **kw_t)
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# ControlNet: the loop
# ---------------------------------------------------------------------------

#: case -> (config name, sampler, adapters, scale, generate keywords)
LOOP_CASES = {
    "one_cfg": ("tiny", "dpm", 1, 0.8, {}),
    "two_scales": ("tiny", "dpm", 2, [0.7, 1.3], {}),
    "lcm": ("lcm", "lcm", 1, 1.0, {"use_cfg": False}),
    "heun": ("tiny", "heun", 1, 1.0, {}),
    "pag": ("tiny", "dpm", 1, 1.0, {"pag_scale": 2.0,
                                    "pag_layers": ("mid",)}),
    "cfg_interval": ("tiny", "dpm", 2, 1.0, {"cfg_interval": (0.3, 0.7)}),
    "xl": ("xl", "dpm", 1, 1.0, {}),
}


def _tokens(cfg, b=1, seed=3):
    return np.random.default_rng(seed).integers(
        0, 500, (b, cfg.clip.context_len))


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_generate_with_hints_matches_jax(ref, case):
    """``pipeline.generate`` with ControlNet hints against the reference's
    at 4 steps: latents within 1e-4 of its max-abs."""
    name, sampler, n, scale, kw = LOOP_CASES[case]
    jcfg, tcfg = CFGS[name]
    jtree, ttree = trees(name)
    b = 2 if case == "two_scales" else 1
    tokens = _tokens(tcfg, b)
    un = np.zeros((1, tcfg.clip.context_len), np.int64)
    j_un = j_pipeline.encode_text(jtree, jnp.asarray(un, jnp.int32), jcfg)[0]
    t_un = t_pipeline.encode_text(ttree, torch.from_numpy(un), tcfg)[0]
    pairs = [cns(name, seed=1 + j) for j in range(n)]
    hints = np.stack([_hint(tcfg, b, seed=5 + j) for j in range(n)])
    jp = {**jtree, "controlnet": (pairs[0][0] if n == 1 else
                                  tuple(p[0] for p in pairs))}
    tp = {**ttree, "controlnet": (pairs[0][1] if n == 1 else
                                  tuple(p[1] for p in pairs))}
    hint = hints[0] if n == 1 else hints
    guidance = 4.0 if name == "lcm" else 7.5
    kw = dict(kw)
    use_cfg = kw.pop("use_cfg", True)
    j_lat = ref.generate(
        jp, jnp.asarray(tokens, jnp.int32), j_un, jax.random.PRNGKey(4),
        jnp.float32(guidance), cfg=jcfg, sampler=sampler, steps=STEPS,
        use_cfg=use_cfg, kernels="xla", hint=jnp.asarray(hint),
        control_scale=jnp.asarray(scale, jnp.float32), output="latent",
        **{k: (jnp.float32(v) if k == "pag_scale" else v)
           for k, v in kw.items()})
    shape = (b, tcfg.latent_size, tcfg.latent_size, tcfg.latent_channels)
    key = jax.random.PRNGKey(4)
    noise = np.array(_normal_draw(key, shape))
    step_noise = np.stack([np.array(_normal_draw(
        jax.random.fold_in(key, ANCESTRAL_FOLD + i), shape))
        for i in range(STEPS)])
    t_lat = t_pipeline.generate(
        tp, torch.from_numpy(tokens), t_un, None, guidance, cfg=tcfg,
        sampler=sampler, steps=STEPS, use_cfg=use_cfg, noise=noise,
        step_noise=step_noise, hint=torch.from_numpy(hint),
        control_scale=scale, output="latent", **kw)
    assert_close(t_lat, j_lat, rel=1e-4)


def test_zero_scale_is_the_run_without_control():
    """``control_scale=0`` gives the latents of the loop without hints."""
    tcfg = CFGS["tiny"][1]
    ttree = trees("tiny")[1]
    tokens = torch.from_numpy(_tokens(tcfg))
    un = t_pipeline.encode_text(ttree, torch.zeros((1, 16), dtype=torch.int64),
                                tcfg)[0]
    noise = _rand(1, 8, 8, 4, seed=8)
    kw = dict(cfg=tcfg, steps=2, noise=noise, output="latent")
    base = t_pipeline.generate(ttree, tokens, un, None, 7.5, **kw)
    with_cn = t_pipeline.generate(
        {**ttree, "controlnet": cns("tiny")[1]}, tokens, un, None, 7.5,
        hint=torch.from_numpy(_hint(tcfg)), control_scale=0.0, **kw)
    assert torch.equal(base, with_cn)


@pytest.mark.parametrize("flags", [
    dict(control=True), dict(control=True, ip2p=True),
    dict(control=True, scheduled=True), dict(control=True, pag=True)])
def test_deepcache_refuses_hints_in_the_references_order(flags):
    """``check_knobs`` under DeepCache names what the reference's loop
    names first (``sdtpu/engine/pipeline.py:255-263``)."""
    tcfg = dataclasses.replace(CFGS["tiny"][1], deepcache_interval=3)
    jcfg = dataclasses.replace(CFGS["tiny"][0], deepcache_interval=3)
    with pytest.raises(ValueError) as ours:
        t_pipeline.check_knobs(tcfg, "dpm", flags.get("pag", False),
                               flags.get("ip2p", False),
                               flags.get("scheduled", False),
                               flags["control"])
    with pytest.raises(ValueError) as theirs:
        j_pipeline.denoise(
            {}, None, None, 7.5, jcfg, "dpm", STEPS, True, hint=1,
            image_guidance=1.0 if flags.get("ip2p") else None,
            cond_schedule=1 if flags.get("scheduled") else None,
            pag_layers=("mid",) if flags.get("pag") and not flags.get(
                "ip2p") else None)
    assert str(ours.value) == str(theirs.value)
    assert "ControlNet" in str(ours.value) or flags.get("ip2p")


# ---------------------------------------------------------------------------
# ControlNet: checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "xl"])
def test_controlnet_rules_match_jax(name):
    jcfg, tcfg = CFGS[name]
    assert t_weights.controlnet_rules(tcfg) == [
        tuple(r) for r in j_weights.controlnet_rules(jcfg)]


@pytest.mark.parametrize("name", ["tiny", "xl"])
def test_references_ldm_controlnet_loads_in_the_port(name):
    """The reference's ``controlnet_to_ldm`` of a tree, read by the port,
    is ``from_jax_tree`` of that tree exactly; the port's own export loads
    back to its tree."""
    jcfg, tcfg = CFGS[name]
    jp, tp = cns(name)
    ldm = {k: torch.from_numpy(np.array(v))
           for k, v in j_weights.controlnet_to_ldm(jp, jcfg).items()}
    assert_trees_equal(t_weights.load_controlnet_state_dict(ldm, tcfg), tp)
    ours = t_weights.controlnet_to_ldm(tp, tcfg)
    assert ours.keys() == ldm.keys()
    assert all(torch.equal(ours[k], ldm[k]) for k in ours)
    assert_trees_equal(t_weights.load_controlnet_state_dict(ours, tcfg), tp)


def test_controlnet_strict_load_has_the_references_text():
    jcfg, tcfg = CFGS["tiny"]
    jp, tp = cns("tiny")
    ldm = t_weights.controlnet_to_ldm(tp, tcfg)
    drop = sorted(ldm)[:7]
    for k in drop:
        del ldm[k]
    with pytest.raises(KeyError) as ours:
        t_weights.load_controlnet_state_dict(ldm, tcfg)
    with pytest.raises(KeyError) as theirs:
        j_weights.load_controlnet_state_dict(
            {k: v.numpy() for k, v in ldm.items()}, jcfg)
    assert str(ours.value) == str(theirs.value)
    part = t_weights.load_controlnet_state_dict(ldm, tcfg, strict=False)
    assert "hint" in part


# ---------------------------------------------------------------------------
# ControlNet: Context
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ctx():
    c = Context(config="tiny", steps=2, device="cpu")
    c.params = trees("tiny")[1]
    c._prepare_buffers()
    return c


def _u8(b=None, seed=9, size=16):
    shape = (size, size, 3) if b is None else (b, size, size, 3)
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def test_load_controlnet_from_each_source(ctx, tmp_path):
    """A tree, ``"random"``, an LDM ``control_model.*`` file and a native
    flat-tree file, each registered under its name; the files load to the
    tree they were written from."""
    c = Context(config="tiny", steps=2, device="cpu")
    tp = cns("tiny")[1]
    c.load_controlnet("tree", tp)
    c.load_controlnet("random", "random")
    t_st.save_file(t_weights.controlnet_to_ldm(tp, c.cfg),
                   tmp_path / "cn.safetensors")
    c.load_controlnet("ldm", str(tmp_path / "cn.safetensors"))
    t_st.save_file(t_weights._flatten_tree(jax_layout(tp)),
                   tmp_path / "cn_native.safetensors")
    c.load_controlnet("native", str(tmp_path / "cn_native.safetensors"))
    assert c.controlnet_names() == ["ldm", "native", "random", "tree"]
    for name in ("tree", "ldm", "native"):
        assert_trees_equal(c._controlnets[name], tp)
    # "random": the port's generator seeded with the count loaded + 1, the
    # zero convs drawn
    want = t_cn.init(c.cfg.unet, torch.Generator().manual_seed(2), "cpu",
                     zero_init_outs=False)
    assert_trees_equal(c._controlnets["random"], want)
    assert c._controlnets["random"]["zero_mid"]["w"].abs().max() > 0


def _resolve_stub(names):
    """The reference's ``Context._resolve_control`` on a stub holding
    ``names`` as its loaded ControlNets."""
    return types.SimpleNamespace(errors=j_errors.ErrorTable(),
                                 cfg=CFGS["tiny"][0],
                                 _controlnets=dict.fromkeys(names, {}))


@pytest.mark.parametrize("loaded,control,image", [
    (("a",), "a", None),
    (("a",), ["a", "a"], "one"),
    (("a", "b"), None, "one"),
    ((), None, "one"),
    (("a",), "z", "one"),
    (("a",), "a", "small"),
])
def test_resolve_control_errors_have_the_references_text(loaded, control,
                                                         image):
    c = Context(config="tiny", steps=2, device="cpu")
    c._controlnets = dict.fromkeys(loaded, {})
    img = {None: None, "one": _u8(), "small": _u8(size=8)}[image]
    with pytest.raises(SdtpuError) as ours:
        c._resolve_control(control, img)
    with pytest.raises(j_errors.SdtpuError) as theirs:
        j_context.Context._resolve_control(_resolve_stub(loaded), control,
                                           img)
    assert ours.value.code == ErrorCode.INVALID_ARGUMENT
    assert str(ours.value) == str(theirs.value)


def test_resolve_control_matches_the_reference():
    """Names, hints [N, B, H, W, C] scaled to [0, 1] and broadcast."""
    c = Context(config="tiny", steps=2, device="cpu")
    c._controlnets = {"a": {"n": 1}, "b": {"n": 2}}
    imgs = [_u8(), _u8(2, seed=4)]
    trees_t, hint_t = c._resolve_control(["a", "b"], imgs)
    stub = _resolve_stub(("a", "b"))
    stub._controlnets = c._controlnets
    trees_j, hint_j = j_context.Context._resolve_control(stub, ["a", "b"],
                                                         imgs)
    assert trees_t == trees_j
    assert hint_t.shape == (2, 2, 16, 16, 3)
    assert np.array_equal(hint_t.numpy(), np.asarray(hint_j))


def test_generate_with_control(ctx):
    """A random ControlNet changes the image; ``control_scale=0`` gives the
    bytes without control; a hint of batch one serves two prompts as two
    copies would; the latent output decodes to the image; ``control`` may
    be left out where one adapter is loaded."""
    ctx._controlnets.clear()
    ctx.load_controlnet("cn", cns("tiny")[1])
    img = _u8()
    base = ctx.generate(PROMPT, seed=3)
    got = ctx.generate(PROMPT, seed=3, control_image=img, control="cn")
    assert np.abs(got.astype(int) - base).max() > 0
    assert np.array_equal(ctx.generate(PROMPT, seed=3, control_image=img,
                                       control_scale=0.0), base)
    two = ctx.generate([PROMPT, "a red car"], seed=3, control_image=img)
    both = ctx.generate([PROMPT, "a red car"], seed=3,
                        control_image=np.stack([img, img]))
    assert np.array_equal(two, both)
    assert np.abs(two[0].astype(int) - got).max() <= 1
    lat = ctx.generate(PROMPT, seed=3, control_image=img, output="latent")
    with torch.inference_mode():
        dec = t_pipeline.decode_latents(ctx.params,
                                        torch.from_numpy(lat[None]),
                                        ctx.cfg)[0].numpy()
    assert np.array_equal(dec, got)


@pytest.mark.parametrize("kind", ["batch", "scheduled", "deepcache"])
def test_generate_control_refusals(ctx, kind):
    ctx._controlnets.clear()
    ctx.load_controlnet("cn", cns("tiny")[1])
    seed = ctx.seed
    text = {
        "batch": "control_image batch 2 != prompt batch 3",
        "scheduled": "prompt scheduling composes with plain txt2img only "
                     "(no ControlNet/two-stage/latent output yet)",
        "deepcache": "DeepCache is incompatible with ControlNet hints"}[kind]
    try:
        if kind == "deepcache":
            ctx.set_deepcache(3)
        with pytest.raises(SdtpuError) as ei:
            ctx.generate(["a", "b", "c"] if kind == "batch" else
                         ("a [cat:dog:0.5]" if kind == "scheduled" else "a"),
                         control_image=_u8(2) if kind == "batch" else _u8())
    finally:
        ctx.set_deepcache(0)
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert str(ei.value).endswith(text) and ctx.seed == seed


# ---------------------------------------------------------------------------
# LoRA: the delta
# ---------------------------------------------------------------------------

def _adapter(d_in, d_out, r=4, conv=None, seed=0):
    """(the JAX layout's adapter leaves, the port's): a dense site's, or a
    conv site's with a ``conv`` x ``conv`` down kernel."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((d_in, r)) if conv is None else
         rng.standard_normal((conv, conv, d_in, r))).astype(np.float32) * 0.3
    b = rng.standard_normal((r, d_out)).astype(np.float32) * 0.3
    j = {"lora_a": a, "lora_b": b, "lora_s": np.float32(0.75)}
    t = {"lora_a": torch.from_numpy(a if conv is None else
                                    a.transpose(3, 2, 0, 1).copy()),
         "lora_b": torch.from_numpy(b), "lora_s": torch.tensor(0.75)}
    return j, t


def _site(kind, seed=1):
    """(JAX site, port site, conv kernel size or None) of a base ``kind``:
    plain, w8 (weight-only int8), w_q (W8A8, dynamic scales) dense sites,
    and a 1x1 weight-only int8 conv."""
    rng = np.random.default_rng(seed)
    d_in, d_out = 32, 48
    b = rng.standard_normal(d_out).astype(np.float32)
    if kind == "plain":
        w = rng.standard_normal((d_in, d_out)).astype(np.float32) * 0.2
        return ({"w": w, "b": b}, {"w": torch.from_numpy(w),
                                   "b": torch.from_numpy(b)}, None)
    w8 = rng.integers(-127, 128, (d_in, d_out)).astype(np.int8)
    s = (rng.random(d_out).astype(np.float32) + 0.5) * 0.01
    if kind == "w_q":
        return ({"w_q": w8, "w_scale": s, "b": b},
                {"w_q": column_major(torch.from_numpy(w8)),
                 "w_scale": torch.from_numpy(s), "b": torch.from_numpy(b)},
                None)
    if kind == "w8":
        return ({"w8": w8, "w8_scale": s, "b": b},
                {"w8": column_major(torch.from_numpy(w8)),
                 "w8_scale": torch.from_numpy(s), "b": torch.from_numpy(b)},
                None)
    hwio = w8[None, None]
    oihw = torch.from_numpy(hwio.transpose(3, 2, 0, 1).copy()).contiguous(
        memory_format=torch.channels_last)
    return ({"w8": hwio, "w8_scale": s, "b": b},
            {"w8": oihw, "w8_scale": torch.from_numpy(s),
             "b": torch.from_numpy(b)}, 1)


@pytest.mark.parametrize("kind", ["plain", "w8", "w_q", "conv1x1_w8"])
def test_lora_delta_on_every_base_path_matches_jax(kind, monkeypatch):
    """``dense`` and the 1x1 conv with an adapter against the reference's
    ``xla`` path (its Pallas GEMM off: the path that applies every delta),
    within 1e-5; the port's weight-only int8 sites run K4's plain
    version. Without the adapter the base result differs: the delta
    acts."""
    monkeypatch.setattr(j_mm, "DISABLE", True)
    js, ts, conv = _site(kind)
    ja, ta = _adapter(32, 48, conv=conv)
    x = _rand(2, 3, 5, 32, seed=2)
    if conv is None:
        want = j_layers.dense({**js, **ja}, jnp.asarray(x))
        got = t_layers.dense({**ts, **ta}, torch.from_numpy(x))
        base = t_layers.dense(ts, torch.from_numpy(x))
    else:
        want = j_layers.conv2d({**js, **ja}, jnp.asarray(x), padding=0)
        got = t_layers.conv2d({**ts, **ta}, torch.from_numpy(x), padding=0)
        base = t_layers.conv2d(ts, torch.from_numpy(x), padding=0)
    assert_close(got, want)
    assert float((got - base).abs().max()) > 1e-2


def test_lora_delta_at_a_3x3_conv_matches_jax():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 3, 16, 24)).astype(np.float32) * 0.1
    b = rng.standard_normal(24).astype(np.float32)
    ja, ta = _adapter(16, 24, conv=3, seed=5)
    x = _rand(2, 6, 6, 16, seed=6)
    want = j_layers.conv2d({"w": w, "b": b, **ja}, jnp.asarray(x), stride=2)
    got = t_layers.conv2d(
        {"w": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
         "b": torch.from_numpy(b), **ta}, torch.from_numpy(x), stride=2)
    assert_close(got, want)


def _adapted_unet(ttree, sites):
    """The port's UNet with an adapter at each of ``sites`` (paths in the
    unet tree; a conv site's down kernel is its weight's size)."""
    adapters = {}
    for i, path in enumerate(sites):
        node = ttree["unet"]
        for p in path:
            node = node[p]
        w = node["w"]
        conv = w.shape[-1] if w.dim() == 4 else None
        d_in, d_out = ((w.shape[1], w.shape[0]) if conv else w.shape)
        _, ta = _adapter(d_in, d_out, conv=conv, seed=30 + i)
        sub = adapters
        for p in path[:-1]:
            sub = sub.setdefault(p, {})
        sub[path[-1]] = ta
    return t_lora.apply_lora(ttree["unet"], _listify(adapters))


def _listify(node):
    if isinstance(node, dict) and "lora_a" not in node:
        if node and all(isinstance(k, int) for k in node):
            return [_listify(node.get(i, {})) for i in range(max(node) + 1)]
        return {k: _listify(v) for k, v in node.items()}
    return node


def _k3_sites(node, path=()):
    """The paths of every conv the fused conv kernel may take in a UNet
    tree: each ResBlock's conv1 and conv2, each transformer's proj_in."""
    if isinstance(node, dict):
        if "conv1" in node and "norm1" in node:
            yield path + ("conv1",)
            yield path + ("conv2",)
        if "proj_in" in node:
            yield path + ("proj_in",)
        for k, v in node.items():
            yield from _k3_sites(v, path + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _k3_sites(v, path + (i,))


@pytest.mark.parametrize("policy", ["cuda_conv", "cuda_gn", "cuda"])
def test_fused_sites_with_an_adapter_give_the_plain_result(policy,
                                                           monkeypatch):
    """The adapter rule: a conv with a LoRA keeps the fused conv kernel and
    calls it a second time, with the delta's down conv as its weight.
    With an adapter at every conv the kernel may take (each ResBlock's
    convs, each ``proj_in``), the UNet under every policy gives the
    ``plain`` path's eps on the CPU within 1e-5 of its max-abs (the
    kernel's plain version folds the GroupNorm into a per-channel affine,
    as the kernel does), the wrapper called twice at each site under
    ``cuda_conv`` (the second with Cout the rank, 4); with adapters at
    four of them, twice at those and once at the others. The adapters
    act."""
    from sdtpu_torch.ops import conv as t_conv

    tcfg = CFGS["tiny"][1]
    ttree = trees("tiny")[1]
    every = sorted(set(_k3_sites(ttree["unet"])), key=str)
    some = [("down", 0, "blocks", 0, "st", "proj_in"),
            ("down", 1, "blocks", 0, "res", "conv1"),
            ("mid", "res2", "conv2"), ("up", 0, "blocks", 1, "st", "proj_in")]
    assert set(some) <= set(every) and len(every) == 23
    x, te, ctx_ = map(torch.from_numpy, _unet_inputs(tcfg))
    calls = []
    real = t_conv.fused_conv

    def counted(*args, **kwargs):
        calls.append(args[1].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(t_conv, "fused_conv", counted)
    for sites in (every, some):
        unet_p = _adapted_unet(ttree, sites)
        calls.clear()
        got = t_unet.apply(unet_p, x, te, ctx_, tcfg.unet, policy)
        want = len(every) + len(sites) if policy == "cuda_conv" else 0
        assert len(calls) == want
        assert calls.count(4) == (len(sites) if want else 0)
        if sites is every:
            plain = t_unet.apply(unet_p, x, te, ctx_, tcfg.unet, "plain")
            assert_close(got, plain)
            base = t_unet.apply(ttree["unet"], x, te, ctx_, tcfg.unet,
                                "plain")
            assert float((plain - base).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# LoRA: native .npz files
# ---------------------------------------------------------------------------

def _reference_adapters(jtree, seed=0):
    """The reference's adapters on its UNet: ``inject_lora`` at rank 4 with
    ``lora_b`` drawn (it starts at zero), those of the first down level's
    first block dropped (a sparse list slot), and a conv adapter at the mid
    block's ``proj_out``; ``extract_lora`` of it."""
    p = j_lora.inject_lora(jtree["unet"], 4, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            out = {k: draw(v) for k, v in node.items()}
            if "lora_b" in node:
                out["lora_b"] = jnp.asarray(rng.standard_normal(
                    node["lora_b"].shape).astype(np.float32) * 0.2)
            return out
        if isinstance(node, list):
            return [draw(v) for v in node]
        return node

    p = draw(p)
    p["down"][0] = _strip(p["down"][0])
    c = p["mid"]["st"]["proj_out"]["w"].shape[-1]
    p["mid"]["st"]["proj_out"] = {
        **p["mid"]["st"]["proj_out"],
        "lora_a": jnp.asarray(_rand(1, 1, c, 4, seed=7) * 0.3),
        "lora_b": jnp.asarray(_rand(4, c, seed=8) * 0.3),
        "lora_s": jnp.float32(0.5)}
    return j_lora.extract_lora(p)


def _strip(node):
    if isinstance(node, dict):
        return {k: _strip(v) for k, v in node.items()
                if k not in t_lora.ADAPTER_KEYS}
    if isinstance(node, list):
        return [_strip(v) for v in node]
    return node


def test_npz_from_the_reference_serves_the_references_unet(tmp_path):
    """The reference's ``save_lora_npz`` -> the port's ``load_lora_npz``
    (a sparse list slot, a conv adapter) -> ``apply_lora`` -> the UNet,
    within 1e-5 of the reference's UNet with its adapters; the port's file
    of the tree loads back in the reference to the same leaves."""
    jcfg, tcfg = CFGS["tiny"]
    jtree, ttree = trees("tiny")
    ad = _reference_adapters(jtree)
    j_lora.save_lora_npz(ad, tmp_path / "a.npz")
    with np.load(tmp_path / "a.npz") as z:
        assert not any(k.startswith("down/0/") for k in z.files)
    ours = t_lora.load_lora_npz(tmp_path / "a.npz")
    assert ours["down"][0] == {}
    assert ours["mid"]["st"]["proj_out"]["lora_a"].shape == (4, 32, 1, 1)
    x, te, ctx_ = _unet_inputs(tcfg)
    want = _J_UNET(j_lora.apply_lora(jtree["unet"], ad), jnp.asarray(x),
                        jnp.asarray(te), jnp.asarray(ctx_), jcfg.unet)
    got = t_unet.apply(t_lora.apply_lora(ttree["unet"], ours),
                       torch.from_numpy(x), torch.from_numpy(te),
                       torch.from_numpy(ctx_), tcfg.unet)
    assert_close(got, want)
    t_lora.save_lora_npz(ours, tmp_path / "b.npz")
    back = j_lora.load_lora_npz(tmp_path / "b.npz")
    a, b = dict(_leaves(back)), dict(_leaves(j_lora.load_lora_npz(
        tmp_path / "a.npz")))
    assert a.keys() == b.keys()
    assert all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def test_merge_and_extract_match_the_overlay():
    """``merge_lora`` folds the adapters into the weights (the eps of the
    overlay within 1e-5), ``extract_lora`` gives the adapter tree back."""
    tcfg = CFGS["tiny"][1]
    ttree = trees("tiny")[1]
    unet_p = _adapted_unet(ttree, [("mid", "st", "proj_in"),
                                   ("mid", "st", "attn1", "q"),
                                   ("down", 0, "blocks", 0, "res", "conv1")])
    x, te, ctx_ = map(torch.from_numpy, _unet_inputs(tcfg))
    assert_close(t_unet.apply(t_lora.merge_lora(unet_p), x, te, ctx_,
                              tcfg.unet),
                 _np(t_unet.apply(unet_p, x, te, ctx_, tcfg.unet)))
    # the reference's shape: the adapter leaves, every other leaf None
    ex = t_lora.extract_lora(unet_p)
    kept = {p[:-1] for p, v in _leaves(ex) if v is not None}
    assert kept == {("mid", "st", "proj_in"), ("mid", "st", "attn1", "q"),
                    ("down", 0, "blocks", 0, "res", "conv1")}
    assert all(p[-1] in t_lora.ADAPTER_KEYS
               for p, v in _leaves(ex) if v is not None)


# ---------------------------------------------------------------------------
# LoRA: kohya files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["TINY", "TINY_XL", "SD15", "SDXL"])
def test_kohya_site_map_matches_jax(name):
    """Name for name and path for path, the aliases included."""
    assert t_kohya.site_map(getattr(t_config, name)) == j_kohya.site_map(
        getattr(j_config, name))


def _kohya_file(cfg, path, tower_sites=True, seed=0):
    """A kohya file over every UNet site of ``cfg`` and, with
    ``tower_sites``, the text towers', written with the ``safetensors``
    package (numpy); -> the tensors."""
    import safetensors.numpy as snp

    rng = np.random.default_rng(seed)
    jtree = trees("xl" if cfg.clip2 is not None else "tiny")[0]
    out = {}
    for name, (p, kind) in j_kohya.site_map(cfg).items():
        if name.startswith("lora_te1_") and cfg.clip2 is None:
            continue
        if name.startswith("lora_te_") and cfg.clip2 is not None:
            continue
        if name.startswith("lora_te") and not tower_sites:
            continue
        node = jtree
        for k in p:
            node = node[k]
        w = np.asarray(node["w"])
        if kind == "linear":
            d_in, d_out = w.shape
            down = rng.standard_normal((4, d_in))
            up = rng.standard_normal((d_out, 4))
        else:
            kh, kw, d_in, d_out = w.shape
            down = rng.standard_normal((4, d_in, kh, kw))
            up = rng.standard_normal((d_out, 4, 1, 1))
        out[name + ".lora_down.weight"] = (down * 0.1).astype(np.float32)
        out[name + ".lora_up.weight"] = (up * 0.1).astype(np.float32)
        out[name + ".alpha"] = np.asarray(2.0, np.float32)
    snp.save_file(out, str(path))
    return out


@pytest.mark.parametrize("name", ["tiny", "xl"])
def test_kohya_files_load_both_ways(name, tmp_path):
    """A file of the reference's format loads in the port to the
    reference's overlay (``to_jax_tree`` of it, exactly); the port's file
    of that overlay loads in the reference to the same overlay."""
    jcfg, tcfg = CFGS[name]
    _kohya_file(jcfg, tmp_path / "k.safetensors")
    theirs = j_kohya.load_lora_kohya(tmp_path / "k.safetensors", jcfg)
    ours = t_kohya.load_lora_kohya(tmp_path / "k.safetensors", tcfg)
    assert set(ours) == set(theirs) == {"unet", "clip"} | (
        {"clip2"} if name == "xl" else set())
    a, b = dict(_leaves(to_jax_tree(ours))), dict(_leaves(theirs))
    assert a.keys() == b.keys()
    for k in a:
        assert np.allclose(a[k], np.asarray(b[k]), rtol=0, atol=0), k
    t_kohya.save_lora_kohya(ours, tcfg, tmp_path / "o.safetensors")
    back = j_kohya.load_lora_kohya(tmp_path / "o.safetensors", jcfg)
    c = dict(_leaves(back))
    assert c.keys() == b.keys()
    assert all(np.array_equal(np.asarray(c[k]), np.asarray(b[k]))
               for k in c)


@pytest.mark.parametrize("bad", ["foreign", "half"])
def test_kohya_strict_has_the_references_text(bad, tmp_path):
    jcfg, tcfg = CFGS["tiny"]
    t = _kohya_file(jcfg, tmp_path / "k.safetensors", tower_sites=False)
    if bad == "foreign":
        t["lora_unet_nowhere_block.lora_down.weight"] = np.zeros((4, 8),
                                                                 np.float32)
    else:
        del t[next(k for k in t if k.endswith(".lora_up.weight"))]
    with pytest.raises(ValueError) as ours:
        t_kohya.load_lora_kohya({k: torch.from_numpy(np.array(v))
                                 for k, v in t.items()}, tcfg)
    with pytest.raises(ValueError) as theirs:
        j_kohya.load_lora_kohya(t, jcfg)
    assert str(ours.value) == str(theirs.value)
    if bad == "foreign":
        loose = t_kohya.load_lora_kohya(
            {k: torch.from_numpy(np.array(v)) for k, v in t.items()}, tcfg,
            strict=False)
        assert set(loose) == {"unet"}


def test_kohya_adapter_serves_the_references_eps(tmp_path):
    """The UNet overlaid with a kohya adapter (attention, feed-forward and
    ``proj_in``/``proj_out`` sites, conv sites among them) against the
    reference's ``xla`` eps, within 1e-5."""
    jcfg, tcfg = CFGS["tiny"]
    jtree, ttree = trees("tiny")
    _kohya_file(jcfg, tmp_path / "k.safetensors", tower_sites=False)
    jo = j_kohya.load_lora_kohya(tmp_path / "k.safetensors", jcfg)["unet"]
    to = t_kohya.load_lora_kohya(tmp_path / "k.safetensors", tcfg)["unet"]
    x, te, ctx_ = _unet_inputs(tcfg)
    want = _J_UNET(j_lora.apply_lora(jtree["unet"], jo), jnp.asarray(x),
                        jnp.asarray(te), jnp.asarray(ctx_), jcfg.unet)
    got = t_unet.apply(t_lora.apply_lora(ttree["unet"], to),
                       torch.from_numpy(x), torch.from_numpy(te),
                       torch.from_numpy(ctx_), tcfg.unet, "cuda_conv")
    assert_close(got, want)


# ---------------------------------------------------------------------------
# LoRA: Context
# ---------------------------------------------------------------------------

def _npz(tmp_path, name="a.npz", seed=0):
    """A native adapter on TINY's UNet (the reference's tree)."""
    path = tmp_path / name
    j_lora.save_lora_npz(_reference_adapters(trees("tiny")[0], seed), path)
    return str(path)


@pytest.fixture(scope="module")
def lora_ctx(tmp_path_factory):
    """A TINY Context on the shared weights with the adapter "a" loaded as
    its default (the constructor's string form)."""
    path = _npz(tmp_path_factory.mktemp("lora"))
    c = Context(config="tiny", steps=2, device="cpu", lora=path)
    c.params = trees("tiny")[1]
    c._lora_params.clear()
    c._prepare_buffers()
    return c


def test_constructor_forms(lora_ctx, tmp_path):
    """A string is the default adapter ("default"); a dict registers its
    names and sets no default; a missing file fails the load as the
    reference's does."""
    assert lora_ctx.lora_names() == ["default"]
    assert lora_ctx._lora_default == "default"
    path = _npz(tmp_path)
    c = Context(config="tiny", steps=2, device="cpu",
                lora={"x": path, "y": path})
    assert c.lora_names() == ["x", "y"] and c._lora_default is None
    with pytest.raises(SdtpuError) as ei:
        Context(config="tiny", steps=2, device="cpu",
                lora=str(tmp_path / "missing.npz"))
    assert ei.value.code == ErrorCode.RUNTIME_ERROR
    assert str(ei.value).startswith("[RUNTIME_ERROR] model load failed")


def test_default_adapter_and_the_base(lora_ctx):
    """``lora=None`` runs the default adapter, ``""`` the base; the overlay
    shares every base tensor and is built once."""
    with_default = lora_ctx.generate(PROMPT, seed=5)
    assert np.array_equal(lora_ctx.generate(PROMPT, seed=5, lora="default"),
                          with_default)
    base = lora_ctx.generate(PROMPT, seed=5, lora="")
    assert np.abs(base.astype(int) - with_default).max() > 0
    p = lora_ctx._params_for(None)
    assert p is lora_ctx._params_for("default")
    assert p["vae"] is lora_ctx.params["vae"]
    assert (p["unet"]["conv_in"]["w"]
            is lora_ctx.params["unet"]["conv_in"]["w"])


@pytest.mark.parametrize("call", [
    lambda c: c.generate(PROMPT, lora="style"),
    lambda c: c.generate_batch([{"prompt": "a", "lora": "style"}]),
    lambda c: c.img2img(PROMPT, _u8(), lora="style"),
    lambda c: c.hires_fix(PROMPT, lora="style"),
])
def test_unknown_adapter_has_the_references_text(lora_ctx, call):
    seed = lora_ctx.seed
    with pytest.raises(SdtpuError) as ei:
        call(lora_ctx)
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert str(ei.value) == ("[INVALID_ARGUMENT] unknown LoRA adapter "
                             "'style'; loaded: ['default']")
    assert lora_ctx.seed == seed


@pytest.mark.parametrize("reqs,lora", [
    ([{"prompt": "a", "lora": "x"}, {"prompt": "b", "lora": "y"}], None),
    ([{"prompt": "a", "lora": "x"}, {"prompt": "b"}], "y"),
])
def test_mixed_adapters_in_a_batch_are_refused(lora_ctx, reqs, lora):
    with pytest.raises(SdtpuError) as ei:
        lora_ctx.generate_batch(reqs, lora=lora)
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert "mixed LoRA adapters in one batch: ['x'" in str(ei.value)
    assert str(ei.value).endswith("— group requests by adapter")


_IMG = _u8(seed=11)
_MASK = np.zeros((16, 16), np.uint8)
_MASK[:8] = 255
_REQ = {"prompt": PROMPT, "seed": 4, "image": _IMG, "mask": _MASK}
#: entry point -> (configuration, the call with a ``lora`` keyword)
ENTRY_POINTS = {
    "generate": ("tiny", lambda c, **kw: c.generate(PROMPT, seed=4, **kw)),
    "generate_async": ("tiny", lambda c, **kw: c.generate_async(
        PROMPT, seed=4, **kw)()),
    "refine": ("tiny", lambda c, **kw: c.refine(
        _rand(8, 8, 4, seed=2), PROMPT, seed=4, denoising_start=0.5, **kw)),
    "generate_batch": ("tiny", lambda c, **kw: c.generate_batch(
        [{"prompt": PROMPT, "seed": 4}], **kw)[0]),
    "generate_batch_request": ("tiny", lambda c, **kw: c.generate_batch(
        [{"prompt": PROMPT, "seed": 4, **kw}])[0]),
    "generate_batch_async": ("tiny", lambda c, **kw: c.generate_batch_async(
        [{"prompt": PROMPT, "seed": 4}], **kw)()[0]),
    "img2img": ("tiny", lambda c, **kw: c.img2img(PROMPT, _IMG, seed=4,
                                                  **kw)),
    "inpaint": ("tiny", lambda c, **kw: c.inpaint(PROMPT, _IMG, _MASK,
                                                  seed=4, **kw)),
    "hires_fix": ("tiny", lambda c, **kw: c.hires_fix(PROMPT, seed=4, **kw)),
    "img2img_batch": ("tiny", lambda c, **kw: c.img2img_batch([_REQ],
                                                              **kw)[0]),
    "img2img_batch_async": ("tiny", lambda c, **kw: c.img2img_batch_async(
        [_REQ], **kw)()[0]),
    "inpaint_batch": ("tiny", lambda c, **kw: c.inpaint_batch([_REQ],
                                                              **kw)[0]),
    "inpaint_batch_async": ("tiny", lambda c, **kw: c.inpaint_batch_async(
        [_REQ], **kw)()[0]),
    "depth2img": ("TINY_DEPTH", lambda c, **kw: c.depth2img(
        PROMPT, _IMG, _rand(16, 16, seed=3), seed=4, **kw)),
    "instruct_pix2pix": ("TINY_IP2P", lambda c, **kw: c.instruct_pix2pix(
        PROMPT, _IMG, seed=4, **kw)),
    "upscale": ("TINY_X4", lambda c, **kw: c.upscale(
        PROMPT, _u8(size=8), noise_level=5, seed=4, **kw)),
}
_ENTRY_CTX = {}


def _entry_ctx(name, tmp_path_factory):
    """A Context of ``name`` with a native adapter "a" over its UNet's
    attention and feed-forward sites (``lora_b`` drawn)."""
    if name not in _ENTRY_CTX:
        cfg = getattr(t_config, name) if name.isupper() else name
        c = Context(config=cfg, steps=2, device="cpu")
        p = j_lora.inject_lora(jax.tree.map(jnp.asarray, to_jax_tree(
            {"unet": c.params["unet"]}))["unet"], 4, jax.random.PRNGKey(1))
        rng = np.random.default_rng(1)

        def draw(node):
            if isinstance(node, dict):
                out = {k: draw(v) for k, v in node.items()}
                if "lora_b" in node:
                    out["lora_b"] = rng.standard_normal(
                        node["lora_b"].shape).astype(np.float32) * 0.3
                return out
            if isinstance(node, list):
                return [draw(v) for v in node]
            return node

        path = tmp_path_factory.mktemp("entry") / "a.npz"
        j_lora.save_lora_npz(draw(j_lora.extract_lora(p)), path)
        c.load_lora("a", str(path))
        _ENTRY_CTX[name] = c
    return _ENTRY_CTX[name]


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_every_entry_point_serves_the_adapter(entry, tmp_path_factory):
    """Each entry point with ``lora="a"`` gives the bytes of the same call
    on the base Context whose UNet is the overlay (the adapter reaches the
    UNet there and nowhere else), unlike the base's."""
    name, call = ENTRY_POINTS[entry]
    c = _entry_ctx(name, tmp_path_factory)
    kw = {"lora": "a"}
    got = call(c, **kw)
    base = call(c)
    real = c.params
    c.params = c._params_for("a")
    try:
        want = call(c)
    finally:
        c.params = real
    assert np.array_equal(got, want)
    assert np.abs(got.astype(np.float64) - base).max() > 0


@pytest.mark.parametrize("quantize", ["int8w_dense", "int8"])
def test_adapter_on_a_quantized_base(quantize, tmp_path):
    """Under ``int8w_dense`` (the K4 route, its plain version here, at every
    site with ``min_elems=0``) and ``int8`` (W8A8) the adapter's overlay
    keeps the int8 leaves and adds the delta: its eps against the
    dequantized base with the adapter, within 1e-4."""
    from sdtpu_torch.quant.ptq import quantize_unet, quantize_weights_only

    tcfg = CFGS["tiny"][1]
    ttree = trees("tiny")[1]
    ad = t_lora.load_lora_npz(_npz(tmp_path))
    if quantize == "int8":
        q = quantize_unet({"unet": ttree["unet"]})["unet"]
    else:
        q = quantize_weights_only(ttree["unet"], include_dense=True,
                                  min_elems=0)
    over = t_lora.apply_lora(q, ad)
    leaf = over["mid"]["st"]["attn1"]["q"]
    assert "lora_a" in leaf and ("w8" in leaf or "w_q" in leaf)
    x, te, ctx_ = map(torch.from_numpy, _unet_inputs(tcfg))
    got = t_unet.apply(over, x, te, ctx_, tcfg.unet, "cuda")
    base = t_unet.apply(q, x, te, ctx_, tcfg.unet, "cuda")
    assert float((got - base).abs().max()) > 1e-3
    # the same adapter on the float weights: within the quantization error
    ref_ = t_unet.apply(t_lora.apply_lora(ttree["unet"], ad), x, te, ctx_,
                        tcfg.unet)
    err = float((got - ref_).abs().max()) / float(ref_.abs().max())
    err_base = float((base - t_unet.apply(ttree["unet"], x, te, ctx_,
                                          tcfg.unet)).abs().max())
    assert err < 0.1 and err_base > 0


def test_load_lora_replaces_a_cached_overlay(tmp_path):
    c = Context(config="tiny", steps=2, device="cpu")
    c.load_lora("s", _npz(tmp_path, "a.npz", seed=0))
    first = c.generate(PROMPT, seed=6, lora="s")
    p = c._params_for("s")
    c.load_lora("s", _npz(tmp_path, "b.npz", seed=1))
    assert c._params_for("s") is not p
    again = c.generate(PROMPT, seed=6, lora="s")
    assert np.abs(first.astype(int) - again).max() > 0
    c.load_embedding("<w>", np.ones((1, 32), np.float32))
    assert c._lora_params == {}


def test_fuse_qkv_skips_a_q_k_v_adapter_as_the_reference(tmp_path):
    """Under ``fuse_qkv=True`` the adapter's attn1 q, k and v sites (and
    attn2's k and v) have no site left and are skipped, as the reference's
    ``apply_lora`` skips them on its fused tree; q of attn2 and the out
    projections keep theirs. The overlay's leaves are the reference's."""
    jtree, ttree = trees("tiny")
    ad_j = _reference_adapters(jtree)
    j_lora.save_lora_npz(ad_j, tmp_path / "a.npz")
    want = j_lora.apply_lora(j_params.fuse_attention_projections(jtree)[
        "unet"], ad_j)
    got = t_lora.apply_lora(fuse_attention_projections(ttree)["unet"],
                            t_lora.load_lora_npz(tmp_path / "a.npz"))
    a = {k for k, _ in _leaves(to_jax_tree(got))}
    b = {k for k, _ in _leaves(want)}
    assert a == b
    st = got["mid"]["st"]
    assert "lora_a" not in st["attn1"]["qkv"] and "lora_a" in st["attn1"][
        "out"]
    assert "lora_a" in st["attn2"]["q"] and "lora_a" not in st["attn2"]["kv"]
    c = Context(config="tiny", steps=2, device="cpu", fuse_qkv=True,
                lora=str(tmp_path / "a.npz"))
    p = c._params_for(None)
    assert "lora_a" in p["unet"]["mid"]["st"]["attn1"]["out"]
    assert c.generate(PROMPT, seed=2).shape == (16, 16, 3)


def test_temb_tables_of_an_adapter_match_jax():
    """An adapter's own time table (``model_t``) through its time MLP, as
    the loop makes it: within 1e-5 of the reference's."""
    jcfg, tcfg = CFGS["tiny"]
    jp, tp = cns("tiny")
    t = np.array([999.0, 749.0, 499.0, 1.0], np.float32)
    assert_close(t_temb.apply(tp["temb"], torch.from_numpy(t), tcfg.unet),
                 j_temb.apply(jp["temb"], jnp.asarray(t), jcfg.unet))


def test_model_dir_refuses_a_controlnet_naming_load_controlnet(tmp_path):
    """A ControlNet checkpoint is an adapter: ``Context(model_dir=)`` refuses
    it before any weight is read and names ``load_controlnet``, which
    takes it."""
    tcfg = CFGS["tiny"][1]
    t_st.save_file(t_weights.controlnet_to_ldm(cns("tiny")[1], tcfg),
                   tmp_path / "cn.safetensors")
    with pytest.raises(SdtpuError) as ei:
        Context(model_dir=str(tmp_path), config="tiny", device="cpu")
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert "Context.load_controlnet" in str(ei.value)
    c = Context(config="tiny", steps=2, device="cpu")
    c.load_controlnet("cn", str(tmp_path / "cn.safetensors"))
    assert_trees_equal(c._controlnets["cn"], cns("tiny")[1])
