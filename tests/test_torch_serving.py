"""The port's SD1.5 serving surface against the JAX package, at TINY in
float32 on the CPU: every sampler's plan and step, the pipeline under the
noise-drawing and two-eval samplers, the prompt syntax and long prompts,
the weighted and chunked text encode, batched requests, and ``Context``'s
refusals.

Both sides get the same weights: the port's own random init at TINY,
carried to the JAX package's layout by ``io.params.to_jax_tree`` (the JAX
package's init of the same tree takes tens of seconds on the CPU). Inputs
are made with numpy from a fixed seed; the JAX package's threefry draws
reach the port through the ``noise=``/``step_noise=`` seams. Unless a test
says otherwise the tolerance is max-abs error <= 1e-4 x the reference's
max-abs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu import config as j_config
from sdtpu import samplers as j_samplers
from sdtpu import text as j_text
from sdtpu.engine import context as j_context
from sdtpu.engine import pipeline as j_pipeline
from sdtpu.tokenizer import Tokenizer as JTokenizer
from sdtpu_torch import Context, ErrorCode, SdtpuError
from sdtpu_torch import config as t_config
from sdtpu_torch import samplers as t_samplers
from sdtpu_torch import text as t_text
from sdtpu_torch.engine import pipeline as t_pipeline
from sdtpu_torch.io.params import init_pipeline_params, to_jax_tree
from sdtpu_torch.models import layers as t_layers
from sdtpu_torch.tokenizer import DEMO_MERGES, Tokenizer


#: XLA:CPU compiles at backend optimization level 0: the same arithmetic,
#: compiled in a fraction of the time
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})

TINY_J, TINY_T = j_config.TINY, t_config.TINY
L = TINY_T.clip.context_len
PROMPT = "a photograph of an astronaut riding a horse"
SHAPE = (TINY_T.latent_size, TINY_T.latent_size, TINY_T.latent_channels)
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


@pytest.fixture(scope="module")
def trees():
    """(the JAX layout as numpy, the port's tree) of one TINY init."""
    ttree = init_pipeline_params(TINY_T, torch.Generator().manual_seed(0),
                                 "cpu")
    return to_jax_tree(ttree), ttree


@pytest.fixture(scope="module")
def tok():
    return Tokenizer.from_merges(DEMO_MERGES)


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
# samplers
# ---------------------------------------------------------------------------

NAMES = sorted(j_samplers.SAMPLERS)


def test_sampler_names_are_the_references():
    assert sorted(t_samplers.SAMPLERS) == NAMES and len(NAMES) == 21
    for name in NAMES:
        j, t = j_samplers.get_sampler(name), t_samplers.get_sampler(name)
        for flag in ("NEEDS_NOISE", "NEEDS_SECOND_EVAL"):
            assert getattr(t, flag, False) == getattr(j, flag, False), name
    with pytest.raises(ValueError, match="unknown sampler"):
        t_samplers.get_sampler("nope")


@pytest.mark.parametrize("start_step", [0, 3])
@pytest.mark.parametrize("name", NAMES)
def test_sampler_plan_matches_jax(name, start_step):
    """The same float64 numpy math, cast once to float32: bit-equal."""
    ref = j_samplers.get_sampler(name).plan(
        j_samplers.NoiseSchedule.sd_v1(), 20, start_step)
    ours = t_samplers.get_sampler(name).plan(
        t_samplers.NoiseSchedule.sd_v1(), 20, start_step, device="cpu")
    assert ours._fields == ref._fields
    for field in ref._fields:
        got = getattr(ours, field)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=f"{name}.{field}")


def _module(s):
    return getattr(s, "_mod", s)


@pytest.mark.parametrize("name", NAMES)
def test_sampler_step_matches_jax(name):
    """Three steps from the same latents, eps (and the step noise, the
    probe's eps2) on both sides, each side fed its own outputs: the
    latents, the state and heun/dpm2's probe point within 1e-6 x the
    reference's max-abs."""
    j_mod, t_mod = j_samplers.get_sampler(name), t_samplers.get_sampler(name)
    jp = j_mod.plan(j_samplers.NoiseSchedule.sd_v1(), 10)
    tp = t_mod.plan(t_samplers.NoiseSchedule.sd_v1(), 10, device="cpu")
    x0 = _rand(2, *SHAPE, seed=1)
    fields = _module(j_mod).State._fields
    state = {f: (np.zeros((), np.float32) if f == "unused"
                 else _rand(2, *SHAPE, seed=10 + k))
             for k, f in enumerate(fields)}
    jx, tx = jnp.asarray(x0), _t(x0)
    js = _module(j_mod).State(**{f: jnp.asarray(v) for f, v in state.items()})
    ts = _module(t_mod).State(**{f: _t(v) for f, v in state.items()})
    assert type(t_mod.init_state(tx)) is type(ts)
    for i in range(3):
        eps = _rand(2, *SHAPE, seed=20 + i)
        kw = {}
        if getattr(j_mod, "NEEDS_NOISE", False):
            kw["noise"] = _rand(2, *SHAPE, seed=30 + i)
        if getattr(j_mod, "NEEDS_SECOND_EVAL", False):
            assert_close(t_mod.predictor(tp, i, tx, _t(eps)),
                         j_mod.predictor(jp, i, jx, jnp.asarray(eps)),
                         rel=1e-6)
            kw["eps2"] = _rand(2, *SHAPE, seed=40 + i)
        jx, js = j_mod.step(jp, i, jx, jnp.asarray(eps), js,
                            **{k: jnp.asarray(v) for k, v in kw.items()})
        tx, ts = t_mod.step(tp, i, tx, _t(eps), ts,
                            **{k: _t(v) for k, v in kw.items()})
        assert_close(tx, jx, rel=1e-6)
        for f in fields:
            if f != "unused":
                assert_close(getattr(ts, f), getattr(js, f), rel=1e-6)


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------

TEXTS = [
    "", PROMPT, "a (red:1.3) car, [blurry], ((sharp))",
    "(unclosed open [square", "stray ) and ] closers",
    "\\(escaped\\) \\[brackets\\] and a \\\\ backslash",
    "a (car:1.0) with unit weight", "a cat, " * 20,
    "(a long weighted prompt:1.2), " * 12,
    "[from:to:0.5] and [a|b|c] and [plain]", "(nested [scheduling:x:3])",
]


@pytest.mark.parametrize("text", TEXTS)
def test_text_matches_jax(text, tok):
    jtok = JTokenizer.from_merges(j_context.DEMO_MERGES)
    assert t_text.parse_weighted(text) == j_text.parse_weighted(text)
    for fn in ("has_attention_syntax", "strip_syntax"):
        assert getattr(t_text, fn)(text) == getattr(j_text, fn)(text)
    assert t_text.needs_chunking(tok, text, L) == j_text.needs_chunking(
        jtok, text, L)
    for k in (1, 3):
        ours = t_text.chunked_tokens(tok, text, L, min_chunks=k)
        ref = j_text.chunked_tokens(jtok, text, L, min_chunks=k)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for steps in (4, 20):
        assert t_text.has_schedule(text, steps) == j_text.has_schedule(
            text, steps)
        assert [t_text.schedule_at(text, i, steps) for i in range(steps)] == [
            j_text.schedule_at(text, i, steps) for i in range(steps)]
    variants, idx = t_text.schedule_table([text, PROMPT], 6)
    ref_v, ref_idx = j_text.schedule_table([text, PROMPT], 6)
    assert variants == ref_v
    np.testing.assert_array_equal(idx, ref_idx)


_encode = _jit(functools.partial(j_pipeline.encode_text, cfg=TINY_J))


def test_encode_text_matches_jax(trees, tok):
    """The chunked, weighted encode [B, k, T] -> [B, k*T, D] against the
    reference's; all-ones weights are an exact no-op."""
    jtree, ttree = trees
    texts = ["a (red:1.4) car, [blurry]", "a cat, " * 8]
    per = [t_text.chunked_tokens(tok, t, L, min_chunks=3) for t in texts]
    toks = np.stack([t for t, _ in per])
    w = np.stack([w for _, w in per])
    assert toks.shape == (2, 3, L) and (w != 1.0).any()
    ref = _encode(jtree, jnp.asarray(toks), weights=jnp.asarray(w))
    ours = t_pipeline.encode_text(ttree, torch.from_numpy(toks).long(),
                                  TINY_T, torch.from_numpy(w))
    assert ours.shape == (2, 3 * L, TINY_T.clip.hidden)
    assert_close(ours, ref)
    plain = t_pipeline.encode_text(ttree, torch.from_numpy(toks).long(),
                                   TINY_T)
    ones = t_pipeline.encode_text(ttree, torch.from_numpy(toks).long(),
                                  TINY_T, torch.ones(2, 3, L))
    assert torch.equal(plain, ones)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

_decode = _jit(functools.partial(j_pipeline.decode_latents, cfg=TINY_J))


def _jax_draws(seed, batch):
    """The reference's starting latents and step noise for one PRNG key:
    ``normal(key)``, and ``normal(fold_in(key, ANCESTRAL_FOLD + i))``."""
    key = jax.random.PRNGKey(seed)
    shape = (batch, *SHAPE)
    x = np.array(jax.random.normal(key, shape, jnp.float32))
    n = np.stack([np.array(jax.random.normal(
        jax.random.fold_in(key, ANCESTRAL_FOLD + i), shape, jnp.float32))
        for i in range(STEPS)])
    return x, n


@pytest.mark.parametrize("sampler", ["euler_a", "heun", "plms_exact",
                                     "dpm_sde", "dpm_karras"])
def test_pipeline_matches_jax(trees, tok, sampler):
    """``generate(..., output="latent")`` at TINY, 3 steps, CFG 7.5, with
    the reference's draws injected: latents within 1e-4, images within 1."""
    jtree, ttree = trees
    seed, guidance = 5, 7.5
    tokens = np.array([tok.tokenize(PROMPT, L)], np.int32)
    unc = _encode(jtree, jnp.asarray([tok.tokenize("", L)], jnp.int32))[0]
    j_gen = _jit(functools.partial(
        j_pipeline.generate, cfg=TINY_J, sampler=sampler, steps=STEPS,
        kernels="xla", output="latent"))
    j_lat = j_gen(jtree, jnp.asarray(tokens), unc, jax.random.PRNGKey(seed),
                  jnp.float32(guidance))
    x, n = _jax_draws(seed, 1)
    t_unc = t_pipeline.encode_text(ttree, torch.tensor([tok.tokenize("", L)]),
                                   TINY_T)[0]
    t_lat = t_pipeline.generate(
        ttree, torch.from_numpy(tokens).long(), t_unc, None, guidance,
        cfg=TINY_T, sampler=sampler, steps=STEPS, noise=x, step_noise=n,
        output="latent")
    assert_close(t_lat, j_lat)
    j_img = np.asarray(_decode(jtree, j_lat)).astype(int)
    t_img = t_pipeline.decode_latents(ttree, t_lat, TINY_T).numpy()
    assert t_img.dtype == np.uint8
    assert np.abs(t_img.astype(int) - j_img).max() <= 1


def test_step_noise_seam_takes_a_callable(trees):
    """``step_noise`` as a tensor [steps, B, ...] and as a callable of the
    step give the same latents; per-sample generators draw each sample's
    latents, then its step noise, whatever its batch-mates."""
    _, ttree = trees
    ctx = torch.randn(4, L, TINY_T.unet.context_dim,
                      generator=torch.Generator().manual_seed(1))
    x, n = (torch.from_numpy(a) for a in _jax_draws(3, 2))
    run = functools.partial(t_pipeline.denoise, ttree, ctx, [7.5, 3.0],
                            TINY_T, STEPS, True, noise=x, sampler="euler_a")
    assert torch.equal(run(step_noise=n), run(step_noise=lambda i: n[i]))
    gens = [torch.Generator().manual_seed(s) for s in (7, 8)]
    names = ("noise", "step_noise")
    b = t_pipeline.draw_noise(gens, (2, *SHAPE), STEPS, names, "cpu")
    one = t_pipeline.draw_noise(torch.Generator().manual_seed(8),
                                (1, *SHAPE), STEPS, names, "cpu")
    assert torch.equal(b["noise"][1:], one["noise"])
    assert torch.equal(b["step_noise"][:, 1:], one["step_noise"])


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ctx(trees):
    c = Context(config="tiny", steps=STEPS, device="cpu")
    c.params = trees[1]
    c._prepare_buffers()
    return c


REQUESTS = [
    {"prompt": PROMPT, "seed": 11, "guidance": 7.5},
    {"prompt": "a (red:1.3) car", "seed": 12, "guidance": 1.0,
     "negative_prompt": "blurry"},
    {"prompt": "a watercolor of a lighthouse", "seed": 13, "guidance": 4.0,
     "negative_prompt": "dark, [grainy]"},
]


def test_generate_batch_matches_jax(trees, ctx, monkeypatch):
    """Three requests (padded to four) with a seed, guidance and negative
    prompt each, against the reference's ``Context.generate_batch`` on the
    same weights, with each sample's threefry latents injected: images
    within 1. Only the three come back."""
    jtree, _ = trees
    monkeypatch.setattr(j_context, "init_pipeline_params",
                        lambda key, cfg: jax.tree.map(jnp.asarray, jtree))
    jctx = j_context.Context(config="tiny", steps=STEPS, compile_cache=None)
    ref = jctx.generate_batch(REQUESTS)

    def draws(generator, shape, steps, names, device):
        assert len(generator) == 4 and tuple(names) == ("noise",)
        seeds = [r["seed"] for r in REQUESTS] + [REQUESTS[0]["seed"]]
        return {"noise": torch.from_numpy(np.concatenate(
            [_jax_draws(s, 1)[0] for s in seeds]))}

    monkeypatch.setattr(t_pipeline, "draw_noise", draws)
    ours = ctx.generate_batch(REQUESTS)
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert a.dtype == np.uint8 and a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_batch_of_one_gives_the_bytes_of_generate(ctx):
    for r in REQUESTS:
        one = ctx.generate_batch([r])
        img = ctx.generate(r["prompt"], guidance=r["guidance"],
                           seed=r["seed"],
                           negative_prompt=r.get("negative_prompt"))
        if r["guidance"] != 1.0:   # generate skips the CFG pair at 1.0
            assert np.array_equal(one[0], img)
    lat = ctx.generate_batch_async(REQUESTS, output="latent")()
    assert [a.shape for a in lat] == [SHAPE] * 3
    alone = ctx.generate_batch([REQUESTS[2]], output="latent")[0]
    assert_close(lat[2], alone, rel=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_context_generates_with_every_sampler(trees, name):
    c = Context(config="tiny", steps=2, sampler=name, device="cpu")
    img = c.generate(["a horse", "a (red:1.2) car"], seed=3,
                     negative_prompt="blurry")
    assert img.shape == (2, 16, 16, 3) and img.dtype == np.uint8
    assert c.sampler == name
    assert np.array_equal(img, c.generate(["a horse", "a (red:1.2) car"],
                                          seed=3, negative_prompt="blurry"))


def test_unknown_sampler_has_the_references_text():
    with pytest.raises(SdtpuError) as ei:
        Context(config="tiny", sampler="nope", device="cpu")
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert (f"unknown sampler 'nope'; available: "
            f"{sorted(j_samplers.SAMPLERS)}") in str(ei.value)


@pytest.mark.parametrize("call", [
    lambda c: c.generate_batch([]),
    lambda c: c.generate_batch([{"prompt": 5}]),
    lambda c: c.generate_batch([{"guidance": 3.0}]),
    lambda c: c.generate(123),
    lambda c: c.generate(["a", None]),
    lambda c: c.generate([]),
    lambda c: c.generate("a [cat:dog:0.5] photo", output="latent"),
    lambda c: c.generate("a photo", negative_prompt="[a|b]"),
    lambda c: c.generate_batch([{"prompt": "[cat:dog:2]"}]),
    lambda c: c.generate("a photo", output="png"),
    # an adapter that is not loaded (its text: test_torch_adapters.py)
    lambda c: c.generate("a photo", lora="style"),
    lambda c: c.generate("a photo", denoising_end=1.5),
    # a control image with no ControlNet loaded
    lambda c: c.generate("a photo", control_image=np.zeros((16, 16, 3))),
    lambda c: c.generate_batch([{"prompt": "a", "lora": "style"}]),
    # a mesh larger than the world of one rank
    lambda c: Context(config="tiny", device="cpu", mesh=(1, 2)),
])
def test_context_refusals(ctx, call):
    seed = ctx.seed
    with pytest.raises(SdtpuError) as ei:
        call(ctx)
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert ctx.seed == seed
