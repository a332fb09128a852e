"""The port's prompt vocabulary against the JAX package, at TINY in float32
on the CPU: ``clip_skip`` (``CLIPConfig.skip_last``), textual-inversion
embeddings (``Context.load_embedding``, ``embeddings=``) and prompt
scheduling (``pipeline.generate(..., sched_idx=)``, ``Context.generate``).

Function-level tests hold the port against the JAX package on the same
weights: the port's random init at TINY, carried to the JAX package's
layout by ``io.params.to_jax_tree``. Context-level tests are the port's
own, at ``steps=2``, where the oracle is exact: a placeholder whose vector
is a word's row gives that word's bytes, and a schedule whose variants are
one text gives the plain prompt's bytes.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch as pkg_st
import torch

from sdtpu import config as j_config
from sdtpu.engine import pipeline as j_pipeline
from sdtpu_torch import Context, ErrorCode, SdtpuError
from sdtpu_torch import config as t_config
from sdtpu_torch import text as t_text
from sdtpu_torch.engine import pipeline as t_pipeline
from sdtpu_torch.io import safetensors as t_st
from sdtpu_torch.io.params import init_pipeline_params, to_jax_tree
from sdtpu_torch.models import layers as t_layers
from sdtpu_torch.tokenizer import DEMO_MERGES, Tokenizer


#: XLA:CPU compiles at backend optimization level 0: the same arithmetic,
#: compiled in a fraction of the time
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})

TINY_J, TINY_T = j_config.TINY, t_config.TINY
L = TINY_T.clip.context_len
PROMPT = "the horse rides"
SEED = 9


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
    ttree = init_pipeline_params(TINY_T, torch.Generator().manual_seed(0),
                                 "cpu")
    return to_jax_tree(ttree), ttree


@pytest.fixture(scope="module")
def tok():
    return Tokenizer.from_merges(DEMO_MERGES)


def assert_close(ours, ref, rel):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    tol = rel * float(np.abs(ref).max())
    assert err <= tol, f"max-abs err {err:.3g} > {tol:.3g}"


def _tokens(tok, texts):
    return np.array([tok.tokenize(t, L) for t in texts], np.int32)


def _context(**kw):
    return Context(config="tiny", steps=2, device="cpu", **kw)


# ---------------------------------------------------------------------------
# clip_skip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skip_last", [0, 1, 2])
def test_encode_text_under_skip_last_matches_jax(trees, tok, skip_last):
    """The text tower tapped ``skip_last`` blocks early, then the final LN
    (TINY has 2 blocks: 2 leaves the embeddings alone): within 1e-5 of the
    reference's max-abs."""
    jtree, ttree = trees
    jcfg = dataclasses.replace(TINY_J, clip=dataclasses.replace(
        TINY_J.clip, skip_last=skip_last))
    tcfg = dataclasses.replace(TINY_T, clip=dataclasses.replace(
        TINY_T.clip, skip_last=skip_last))
    toks = _tokens(tok, [PROMPT, "a photograph of an astronaut"])
    ref = j_pipeline.encode_text(jtree, jnp.asarray(toks), jcfg)
    ours = t_pipeline.encode_text(ttree, torch.from_numpy(toks).long(), tcfg)
    assert_close(ours, ref, rel=1e-5)


@pytest.mark.parametrize("clip_skip", [0, 3, 1.5, "2"])
def test_clip_skip_refusals(clip_skip):
    with pytest.raises(SdtpuError) as ei:
        _context(clip_skip=clip_skip)
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert "clip_skip" in str(ei.value)


def test_clip_skip_taps_early():
    c = _context(clip_skip=2)
    assert c.cfg.clip.skip_last == 1 and TINY_T.clip.skip_last == 0
    img = c.generate(PROMPT, seed=SEED)
    assert not np.array_equal(img, _context().generate(PROMPT, seed=SEED))
    assert np.array_equal(img, c.generate(PROMPT, seed=SEED))


# ---------------------------------------------------------------------------
# textual inversion
# ---------------------------------------------------------------------------

def _rows(ctx, words):
    table = ctx.params["clip"]["token_embedding"]
    return table[ctx.tokenizer.encode(words)].clone()


def test_placeholder_reproduces_a_word_bit_exactly():
    ctx = _context()
    ref = ctx.generate(PROMPT, seed=SEED)
    before = ctx.tokenizer.encode(PROMPT)
    ctx.load_embedding("<h>", _rows(ctx, "horse"))
    assert ctx.embedding_names() == ["<h>"]
    assert ctx.tokenizer.encode("the <h> rides") != before
    assert np.array_equal(ctx.generate("the <h> rides", seed=SEED), ref)
    # the weighted, chunked path takes it too
    long = " ".join(["the photograph of"] * 5)
    assert np.array_equal(ctx.generate(f"{long} (<h>:1.3)", seed=2),
                          ctx.generate(f"{long} (horse:1.3)", seed=2))


def test_multi_vector_placeholder():
    ctx = _context()
    ref = ctx.generate("the horse rides a photograph", seed=4)
    vecs = _rows(ctx, "horse rides")
    assert vecs.shape[0] >= 2
    ctx.load_embedding("<hr>", vecs)
    assert np.array_equal(ctx.generate("the <hr> a photograph", seed=4), ref)


def _embedding_source(fmt, rows, path):
    """``rows`` in one of the formats ``load_embedding`` reads."""
    if fmt == "npz":
        np.savez(path / "e.npz", emb=rows.numpy())
        return path / "e.npz"
    if fmt == "pt":   # A1111's artifact
        torch.save({"string_to_param": {"*": rows}, "name": "h",
                    "step": 100}, path / "e.pt")
        return path / "e.pt"
    if fmt == "safetensors":   # A1111's key, the port's writer
        t_st.save_file({"emb_params": rows}, path / "e.safetensors")
        return path / "e.safetensors"
    if fmt == "package_safetensors":
        pkg_st.save_file({"clip_l": rows.to(torch.bfloat16).float(),
                          "clip_g": torch.zeros(1, 8)},
                         str(path / "e2.safetensors"))
        return path / "e2.safetensors"
    if fmt == "dict":
        return {"clip_l": rows.numpy()}
    return rows[0]   # a bare [D] vector


@pytest.mark.parametrize("fmt", ["npz", "pt", "safetensors",
                                 "package_safetensors", "dict", "vector"])
def test_embedding_formats(tmp_path, fmt):
    """``.npz``, A1111's ``.pt`` (``string_to_param``) and ``.safetensors``
    (``emb_params``, or ``clip_l`` beside ``clip_g``), a dict, a bare
    vector, through ``embeddings=`` at init: the word's bytes (for the
    bf16-rounded one, the same rounded row's)."""
    demo = _context()
    rows = _rows(demo, "horse")
    if fmt == "package_safetensors":
        demo.load_embedding("<r>", rows.to(torch.bfloat16).float())
        ref = demo.generate("the <r> rides", seed=SEED)
    else:
        ref = demo.generate(PROMPT, seed=SEED)
    ctx = _context(embeddings={"<h>": _embedding_source(fmt, rows,
                                                        tmp_path)})
    assert ctx.embedding_names() == ["<h>"]
    assert np.array_equal(ctx.generate("the <h> rides", seed=SEED), ref)


@pytest.mark.parametrize("source,placeholder", [
    (torch.zeros(2, 5), "<x>"),                      # wrong width
    ({"a": torch.zeros(1, 32), "b": torch.zeros(1, 32)}, "<x>"),  # keys
    (torch.zeros(1, 2, 32), "<x>"),                  # not [k, D]
    (torch.zeros(1, 32), "two words"),               # not one word
    ("missing.npz", "<x>")])
def test_embedding_errors_are_invalid_argument(source, placeholder):
    ctx = _context()
    rows = ctx.params["clip"]["token_embedding"].shape[0]
    with pytest.raises(SdtpuError) as ei:
        ctx.load_embedding(placeholder, source)
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert ctx.params["clip"]["token_embedding"].shape[0] == rows
    assert ctx.embedding_names() == []


def test_encode_text_with_an_extended_table_matches_jax(trees, tok):
    """Two rows appended to the table (a two-vector placeholder) and a
    prompt through them: the port's encode against the reference's on the
    same extended tree, within 1e-5."""
    jtree, ttree = trees
    extra = np.random.default_rng(3).standard_normal(
        (2, TINY_T.clip.hidden)).astype(np.float32)
    jclip = dict(jtree["clip"], token_embedding=np.concatenate(
        [jtree["clip"]["token_embedding"], extra]))
    tclip = dict(ttree["clip"], token_embedding=torch.cat(
        [ttree["clip"]["token_embedding"], torch.from_numpy(extra)]))
    t = Tokenizer.from_merges(DEMO_MERGES)
    n = TINY_T.clip.vocab_size
    t.add_placeholder("<p>", [n, n + 1])
    toks = _tokens(t, ["the <p> rides", "a <p>"])
    assert (toks >= n).sum() == 4
    ref = j_pipeline.encode_text(dict(jtree, clip=jclip), jnp.asarray(toks),
                                 TINY_J)
    ours = t_pipeline.encode_text(dict(ttree, clip=tclip),
                                  torch.from_numpy(toks).long(), TINY_T)
    assert_close(ours, ref, rel=1e-5)


# ---------------------------------------------------------------------------
# prompt scheduling
# ---------------------------------------------------------------------------

SCHEDULED = ["a [horse:photograph:0.5] on it",
             "[riding|the (horse:1.2)] as one"]


def test_scheduled_generate_matches_jax(trees, tok):
    """Two prompts, four variants (a switch at half way beside an
    alternation, one with a weight), DPM-Solver++ 2M, 4 steps, CFG 7.5:
    ``pipeline.generate(..., sched_idx=)`` against the reference's on the
    same weights with its threefry latents injected: latents within 1e-5
    of the reference's max-abs."""
    jtree, ttree = trees
    steps, seed, guidance = 4, 3, 7.5
    variants, idx = t_text.schedule_table(SCHEDULED, steps)
    assert len(variants) == 4 and idx.tolist() == [0, 1, 2, 3]
    per = [[t_text.chunked_tokens(tok, p, L) for p in row]
           for row in variants]
    toks = np.stack([np.stack([t[0] for t, _ in row]) for row in per])
    w = np.stack([np.stack([w[0] for _, w in row]) for row in per])
    toks, w = toks[:, :, None], w[:, :, None]
    assert (w != 1.0).any()
    unc = j_pipeline.encode_text(jtree, jnp.asarray(_tokens(tok, [""])),
                                 TINY_J)[0]
    gen = _jit(functools.partial(
        j_pipeline.generate, cfg=TINY_J, sampler="dpm", steps=steps,
        kernels="xla", output="latent"))
    key = jax.random.PRNGKey(seed)
    ref = gen(jtree, jnp.asarray(toks), unc, key, jnp.float32(guidance),
              token_weights=jnp.asarray(w), sched_idx=jnp.asarray(idx))
    noise = np.array(jax.random.normal(
        key, (2, TINY_T.latent_size, TINY_T.latent_size, 4), jnp.float32))
    t_unc = t_pipeline.encode_text(
        ttree, torch.from_numpy(_tokens(tok, [""])).long(), TINY_T)[0]
    ours = t_pipeline.generate(
        ttree, torch.from_numpy(toks).long(), t_unc, None, guidance,
        cfg=TINY_T, sampler="dpm", steps=steps, noise=noise,
        output="latent", token_weights=torch.from_numpy(w),
        sched_idx=torch.from_numpy(idx))
    assert_close(ours, ref, rel=1e-5)


def test_degenerate_schedule_is_bit_identical_to_the_plain_prompt():
    """Variants that are all one text give the plain prompt's bytes (a
    switch between equal texts, an alternation of one text, a switch at
    step 0); a real schedule acts, and is deterministic."""
    ctx = _context()
    plain = ctx.generate(PROMPT, seed=3)
    for text in (f"[{PROMPT}:{PROMPT}:0.5]", f"[{PROMPT}|{PROMPT}]",
                 f"[a photograph:{PROMPT}:0]"):
        assert np.array_equal(ctx.generate(text, seed=3), plain), text
    sched = ctx.generate(f"[{PROMPT}:a photograph:0.5]", seed=3)
    assert np.array_equal(sched, ctx.generate(
        f"[{PROMPT}:a photograph:0.5]", seed=3))
    assert not np.array_equal(sched, plain)
    assert not np.array_equal(sched, ctx.generate("a photograph", seed=3))
    both = ctx.generate(SCHEDULED, seed=3, negative_prompt="(blurry:1.2)")
    assert both.shape == (2, 16, 16, 3)


@pytest.mark.parametrize("call", [
    lambda c: c.generate("[a:b:0.5]", negative_prompt="[x:y:0.5]"),
    lambda c: c.generate("the horse, " * 8 + "[a|b]"),
    lambda c: c.generate_batch([{"prompt": "[a:b:0.5]"}]),
    lambda c: c.generate("[a:b:0.5]", output="latent")])
def test_schedule_guards(call):
    """A scheduled negative prompt, a scheduled prompt past one window,
    ``generate_batch`` and latent output are refused; no seed is spent."""
    ctx = _context()
    seed = ctx.seed
    with pytest.raises(SdtpuError) as ei:
        call(ctx)
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert ctx.seed == seed
