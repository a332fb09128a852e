"""The port's CLIP-score harness (``sdtpu_torch.quant.clip_score``) and the
CLIP vision tower (``sdtpu_torch.models.clip``) against the JAX package's,
at TINY_VISION and a 32^2 patch-8 tower, in float32 on the CPU.

Both sides get the same weights: the port's random init in the JAX
package's layout (``patch_embedding`` HWIO), carried back by
``io.params.vision_from_jax_tree``; the same inputs, made with numpy from a
fixed seed. The tolerance is max-abs error <= 1e-4 x the reference's
max-abs; the resize within 1e-6."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu.config import CLIPConfig as JCLIPConfig
from sdtpu.models import clip as j_clip
from sdtpu.quant import clip_score as j_cs
from sdtpu.tokenizer import Tokenizer as JTokenizer
from sdtpu_torch.config import CLIPConfig
from sdtpu_torch.io.params import to_jax_tree, vision_from_jax_tree
from sdtpu_torch.models import clip as t_clip
from sdtpu_torch.models import layers as t_layers
from sdtpu_torch.quant import clip_score as t_cs
from sdtpu_torch.tokenizer import DEMO_MERGES, Tokenizer

V32 = t_clip.CLIPVisionConfig(image_size=32, patch=8, hidden=32, layers=2,
                              heads=2, projection=24)
VISIONS = {"tiny": t_clip.TINY_VISION, "v32": V32}
TEXT = dict(hidden=16, layers=2, heads=2, context_len=12)

#: XLA:CPU compiles at backend optimization level 0 (the same arithmetic)
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})


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


def _j_vision_cfg(v):
    return j_clip.CLIPVisionConfig(
        image_size=v.image_size, patch=v.patch, hidden=v.hidden,
        layers=v.layers, heads=v.heads, mlp_ratio=v.mlp_ratio,
        projection=v.projection, eps=v.eps)


def _vision(name, seed=0):
    """(the JAX tree as jnp arrays, the port's tree) of one vision tower."""
    v = VISIONS[name]
    jtree = to_jax_tree(t_clip.init_vision(
        v, torch.Generator().manual_seed(seed), "cpu"))
    return jax.tree.map(jnp.asarray, jtree), vision_from_jax_tree(jtree, v)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def assert_close(ours, ref, rel=1e-4):
    ours = ours.detach().cpu().numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    tol = rel * float(np.abs(ref).max())
    assert err <= tol, f"max-abs err {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("name", sorted(VISIONS))
def test_apply_vision_matches_reference(name):
    v = VISIONS[name]
    jp, tp = _vision(name)
    imgs = _rand(2, v.image_size, v.image_size, 3, seed=1)
    ref = _jit(lambda p, x: j_clip.apply_vision(p, x, _j_vision_cfg(v)))(
        jp, jnp.asarray(imgs))
    ours = t_clip.apply_vision(tp, torch.from_numpy(imgs), v)
    assert tuple(ours.shape) == (2, v.projection)
    assert_close(ours, ref)


def test_vision_tree_layout():
    """``patch_embedding`` is OIHW in channels_last memory on the port's
    side, HWIO on the reference's; a wrong shape is refused."""
    jp, tp = _vision("v32")
    w = tp["patch_embedding"]
    assert tuple(w.shape) == (V32.hidden, 3, V32.patch, V32.patch)
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert jp["patch_embedding"].shape == (V32.patch, V32.patch, 3,
                                           V32.hidden)
    assert np.array_equal(np.asarray(jp["patch_embedding"]),
                          w.permute(2, 3, 1, 0).numpy())
    bad = to_jax_tree(tp)
    bad["proj"] = bad["proj"][:, :3]
    with pytest.raises(ValueError, match="proj"):
        vision_from_jax_tree(bad, V32)


def _text(seed=0):
    """(reference config, port config, reference tree, port tree, the
    projection as numpy) of a TINY text tower."""
    from sdtpu_torch.io.params import _convert

    tcfg = CLIPConfig(vocab_size=100, **TEXT)
    jcfg = JCLIPConfig(vocab_size=100, **TEXT)
    g = torch.Generator().manual_seed(seed)
    tree = t_clip.init(tcfg, g, "cpu")
    jtree = to_jax_tree(tree)
    proj = torch.randn((TEXT["hidden"], 24), generator=g).numpy() * 0.1
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, jtree), _convert(jtree),
            proj)


def test_text_embedding_matches_reference():
    jcfg, tcfg, jp, tp, proj = _text()
    tokens = np.array([[5, 3, 7, 99, 99, 99, 99, 99, 99, 99, 99, 99],
                       [1, 2, 3, 4, 5, 6, 7, 8, 99, 99, 99, 99]], np.int64)
    ref = _jit(lambda p, t, w: j_clip.text_embedding(p, t, w, jcfg, 99))(
        jp, jnp.asarray(tokens, jnp.int32), jnp.asarray(proj))
    ours = t_clip.text_embedding(tp, torch.from_numpy(tokens),
                                 torch.from_numpy(proj), tcfg, eot_id=99)
    assert_close(ours, ref)


def test_encoder_block_causal_flag():
    """The text towers keep their causal mask; ``causal=False`` lets every
    token see every other, and changes the output."""
    _, tcfg, _, tp, _ = _text()
    x = torch.from_numpy(_rand(1, 12, TEXT["hidden"], seed=3))
    blk = tp["blocks"][0]
    a = t_clip._encoder_block(blk, x, 2, 1e-5, t_layers.quick_gelu)
    b = t_clip._encoder_block(blk, x, 2, 1e-5, t_layers.quick_gelu,
                              causal=True)
    c = t_clip._encoder_block(blk, x, 2, 1e-5, t_layers.quick_gelu,
                              causal=False)
    assert torch.equal(a, b)
    # the first row sees itself alone under the mask; the last sees all
    assert not torch.allclose(a[:, 0], c[:, 0], atol=1e-3)
    assert torch.allclose(a[:, -1], c[:, -1], atol=1e-5)


@pytest.mark.parametrize("src,dst", [(512, 224), (768, 224), (64, 16),
                                     (16, 224), (32, 16)])
def test_preprocess_images_matches_reference(src, dst):
    """The resize of the [0, 1] planes within 1e-6 of ``jax.image.resize``
    (antialiased bilinear both ways: up, down, by 2 and off ratios), and the
    normalized result within the file's tolerance."""
    imgs = np.random.default_rng(src).integers(0, 256, (2, src, src, 3),
                                               dtype=np.uint8)
    ref = np.asarray(j_cs.preprocess_images(imgs, size=dst))
    ours = t_cs.preprocess_images(imgs, size=dst, device="cpu").numpy()
    assert ours.shape == ref.shape == (2, dst, dst, 3)
    assert_close(ours, ref)
    planes = imgs.astype(np.float32) / 255.0
    ref_resized = np.asarray(jax.image.resize(
        jnp.asarray(planes), (2, dst, dst, 3), "bilinear"))
    resized = ours * t_cs.CLIP_STD + t_cs.CLIP_MEAN
    unnormalized = ref * j_cs.CLIP_STD + j_cs.CLIP_MEAN
    assert float(np.abs(unnormalized - ref_resized).max()) <= 1e-6
    assert float(np.abs(resized - ref_resized).max()) <= 1e-6


def test_preprocess_images_same_size_is_normalization():
    imgs = np.full((1, 32, 32, 3), 128, np.uint8)
    x = t_cs.preprocess_images(imgs, size=32, device="cpu").numpy()
    want = (128 / 255.0 - t_cs.CLIP_MEAN) / t_cs.CLIP_STD
    np.testing.assert_allclose(x[0, 5, 7], want, atol=1e-6)
    assert np.array_equal(t_cs.CLIP_MEAN, j_cs.CLIP_MEAN)
    assert np.array_equal(t_cs.CLIP_STD, j_cs.CLIP_STD)


def _hf_state_dict(v, text_hidden, seed=0):
    """A synthetic numpy state dict with HF CLIPModel's key names and
    shapes (no transformers needed)."""
    rng = np.random.default_rng(seed)
    d, m = v.hidden, v.hidden * v.mlp_ratio

    def r(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    pre = "vision_model."
    sd = {pre + "embeddings.class_embedding": r(d),
          pre + "embeddings.patch_embedding.weight": r(d, 3, v.patch,
                                                       v.patch),
          pre + "embeddings.position_embedding.weight": r(v.n_patches + 1,
                                                          d),
          "visual_projection.weight": r(v.projection, d),
          "text_projection.weight": r(v.projection, text_hidden)}
    for name in ("pre_layrnorm", "post_layernorm"):
        sd[f"{pre}{name}.weight"] = 1.0 + r(d)
        sd[f"{pre}{name}.bias"] = r(d)
    for i in range(v.layers):
        b = f"{pre}encoder.layers.{i}."
        for name in ("layer_norm1", "layer_norm2"):
            sd[b + name + ".weight"] = 1.0 + r(d)
            sd[b + name + ".bias"] = r(d)
        for name, (o, n) in {"self_attn.q_proj": (d, d),
                             "self_attn.k_proj": (d, d),
                             "self_attn.v_proj": (d, d),
                             "self_attn.out_proj": (d, d),
                             "mlp.fc1": (m, d), "mlp.fc2": (d, m)}.items():
            sd[b + name + ".weight"] = r(o, n)
            sd[b + name + ".bias"] = r(o)
    return sd


def test_vision_params_from_hf_matches_reference():
    """The port's mapping of HF's keys, put in the JAX package's layout,
    is the reference's mapping leaf for leaf, and the towers built from it
    agree."""
    sd = _hf_state_dict(V32, 16)
    jparams, jproj = j_cs.vision_params_from_hf(sd, _j_vision_cfg(V32))
    tparams, tproj = t_cs.vision_params_from_hf(sd, V32, device="cpu")
    assert tparams["patch_embedding"].is_contiguous(
        memory_format=torch.channels_last)
    got = jax.tree_util.tree_leaves_with_path(to_jax_tree(tparams))
    want = dict(jax.tree_util.tree_leaves_with_path(jparams))
    assert len(got) == len(want)
    for path, leaf in got:
        assert np.array_equal(leaf, np.asarray(want[path])), path
    assert np.array_equal(tproj.numpy(), jproj)
    imgs = _rand(1, 32, 32, 3, seed=4)
    ref = _jit(lambda p, x: j_clip.apply_vision(p, x, _j_vision_cfg(V32)))(
        jax.tree.map(jnp.asarray, jparams), jnp.asarray(imgs))
    assert_close(t_clip.apply_vision(tparams, torch.from_numpy(imgs), V32),
                 ref)


def test_clip_scores_match_reference():
    """TINY towers on both sides, the demo tokenizer, two images and
    prompts: the same scores (in [0, 100]) and the same cosines."""
    tok = Tokenizer.from_merges(DEMO_MERGES)
    jtok = JTokenizer.from_merges(DEMO_MERGES)
    kw = dict(hidden=16, layers=1, heads=2, context_len=12)
    tcfg = CLIPConfig(vocab_size=tok.vocab_size, **kw)
    jcfg = JCLIPConfig(vocab_size=jtok.vocab_size, **kw)
    g = torch.Generator().manual_seed(5)
    text = t_clip.init(tcfg, g, "cpu")
    proj = torch.randn((16, t_clip.TINY_VISION.projection), generator=g)
    jp, vp = _vision("tiny", seed=6)
    imgs = np.random.default_rng(7).integers(0, 256, (2, 24, 24, 3),
                                             dtype=np.uint8)
    prompts = ["a horse", "the photograph"]
    ref = j_cs.clip_scores(
        imgs, prompts, jtok, jax.tree.map(jnp.asarray, to_jax_tree(text)),
        jnp.asarray(proj.numpy()), jp, jcfg,
        _j_vision_cfg(t_clip.TINY_VISION))
    ours = t_cs.clip_scores(imgs, prompts, tok, text, proj, vp, tcfg,
                            t_clip.TINY_VISION)
    assert ours.shape == (2,) and np.all((ours >= 0) & (ours <= 100))
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    cos = t_cs.clip_cosines(imgs, prompts, tok, text, proj, vp, tcfg,
                            t_clip.TINY_VISION)
    np.testing.assert_allclose(100.0 * np.maximum(cos, 0.0), ours)
