"""The port's continuous-batching pool (``sdtpu_torch.engine.stream``) at
TINY in float32 on the CPU.

* Each case of the JAX package's ``tests/test_stream.py`` on the port's
  ``StreamScheduler`` against the port's ``Context.generate``: every image
  within one uint8 level, and fewer than 1% of its pixels off (the pooled
  UNet runs at another batch shape than the single path).
* Parity with the reference's ``StreamScheduler`` on the same weights (the
  port's init carried to the JAX layout by ``io.params.to_jax_tree``) for
  dpm, euler_a, heun, LCM (TINY_LCM) and a mixed 2/4-step pool with a
  request admitted mid-flight: the JAX package's admission draws
  (``normal(PRNGKey(seed))``) and ancestral draws (``fold_in(key, 2^21 +
  i)``) reach the port through ``submit``'s ``noise=`` and ``step_noise=``
  seams; the whole pool's latents after every tick within 1e-4 x the
  reference's max-abs, the decoded images within one level. The
  reference's step program runs unjitted around its UNet and VAE, which
  are jitted once a shape at XLA level 0 (``tests/test_torch_image.py``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu import config as j_config
from sdtpu.engine import context as j_context
from sdtpu.engine import stream as j_stream
from sdtpu.models import unet as j_unet
from sdtpu.models import vae as j_vae
from sdtpu.tokenizer import Tokenizer as JTokenizer
from sdtpu_torch import Context
from sdtpu_torch.engine.stream import StreamScheduler
from sdtpu_torch.io.params import to_jax_tree
from sdtpu_torch.models import layers as t_layers
from test_torch_image import _encode_text_once, _jit, _normal, _normal_draw

PROMPT = "the horse"
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


def assert_pixels_match(a, b):
    """Within one gray level, on fewer than 1% of the pixels: the pooled
    UNet runs at another batch shape, so a reduction may round otherwise
    (``tests/test_stream.py``'s bound)."""
    d = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16))
    assert d.max() <= 1, f"max pixel delta {d.max()}"
    assert (d > 0).mean() < 0.01, f"{(d > 0).mean():.2%} pixels differ"


@pytest.fixture(scope="module")
def ctx():
    return Context(config="tiny", steps=4, sampler="dpm", device="cpu")


def _at_steps(c, steps, prompt, seed, **kw):
    old = c.steps
    c.set_steps(steps)
    try:
        return c.generate(prompt, seed=seed, **kw)
    finally:
        c.set_steps(old)


# ---------------------------------------------------------------------------
# tests/test_stream.py, on the port
# ---------------------------------------------------------------------------

def test_stream_matches_single_path(ctx):
    sched = StreamScheduler(ctx, slots=2)
    ids = {}
    for s, g in [(1, 7.5), (2, 5.0), (3, 7.5)]:
        ids[sched.submit(PROMPT, guidance=g, seed=s)] = (s, g)
    out = sched.drain()
    assert set(out) == set(ids)
    for rid, (s, g) in ids.items():
        assert out[rid].dtype == np.uint8
        assert_pixels_match(out[rid], ctx.generate(PROMPT, guidance=g, seed=s))


def test_stream_mid_flight_admission(ctx):
    sched = StreamScheduler(ctx, slots=2)
    a = sched.submit(PROMPT, seed=11)
    sched.tick()
    sched.tick()          # a is now 2 steps in
    b = sched.submit("a fox", seed=12)  # admitted into the second slot
    out = sched.drain()
    assert_pixels_match(out[a], ctx.generate(PROMPT, seed=11))
    assert_pixels_match(out[b], ctx.generate("a fox", seed=12))
    assert sched.ticks < 2 * ctx.steps + 2


def test_stream_slot_reuse_and_negative_prompt(ctx):
    sched = StreamScheduler(ctx, slots=2)
    ids = [sched.submit(PROMPT, seed=20 + i,
                        negative_prompt="blurry" if i % 2 else None)
           for i in range(5)]
    out = sched.drain()
    assert len(out) == 5
    for i, rid in enumerate(ids):
        ref = ctx.generate(PROMPT, seed=20 + i,
                           negative_prompt="blurry" if i % 2 else None)
        assert_pixels_match(out[rid], ref)


@pytest.mark.parametrize("sampler", ["euler_a", "heun", "plms"])
def test_stream_sampler_families(sampler):
    c = Context(config="tiny", steps=3, sampler=sampler, device="cpu")
    sched = StreamScheduler(c, slots=2)
    r1 = sched.submit(PROMPT, seed=1)
    r2 = sched.submit("a fox", seed=2)
    out = sched.drain()
    assert_pixels_match(out[r1], c.generate(PROMPT, seed=1))
    assert_pixels_match(out[r2], c.generate("a fox", seed=2))


def test_stream_lcm_guidance_embedded():
    c = Context(config="tiny_lcm", steps=4, sampler="lcm", device="cpu")
    sched = StreamScheduler(c, slots=2)
    r1 = sched.submit(PROMPT, guidance=8.0, seed=3)
    r2 = sched.submit(PROMPT, guidance=2.0, seed=3)
    out = sched.drain()
    assert_pixels_match(out[r1], c.generate(PROMPT, guidance=8.0, seed=3))
    assert_pixels_match(out[r2], c.generate(PROMPT, guidance=2.0, seed=3))
    assert not np.array_equal(out[r1], out[r2])


def test_stream_previews(ctx):
    sched = StreamScheduler(ctx, slots=1)
    rid = sched.submit(PROMPT, seed=5)
    sched.tick()
    p1 = sched.previews()
    s = ctx.cfg.latent_size
    assert p1[rid].shape == (s, s, 3) and p1[rid].dtype == np.uint8
    sched.tick()
    p2 = sched.previews()
    assert not np.array_equal(p1[rid], p2[rid])
    sched.drain()
    assert sched.previews() == {}


def test_stream_mixed_steps(ctx):
    sched = StreamScheduler(ctx, slots=2, step_choices=(2, 4, 6))
    ra = sched.submit(PROMPT, seed=31, steps=2)
    rb = sched.submit("a fox", seed=32, steps=6)
    rc = sched.submit(PROMPT, seed=33)          # default = ctx.steps (4)
    out = sched.drain()
    assert set(out) == {ra, rb, rc}
    for rid, (prompt, seed, steps) in {
            ra: (PROMPT, 31, 2), rb: ("a fox", 32, 6),
            rc: (PROMPT, 33, 4)}.items():
        assert_pixels_match(out[rid], _at_steps(ctx, steps, prompt, seed))
    assert sched.ticks < 2 + 6 + 4


def test_stream_mixed_steps_multistep_history():
    c = Context(config="tiny", steps=3, sampler="unipc", device="cpu")
    sched = StreamScheduler(c, slots=2, step_choices=(3, 5))
    r1 = sched.submit(PROMPT, seed=41, steps=5)
    r2 = sched.submit("a fox", seed=42, steps=3)
    out = sched.drain()
    assert_pixels_match(out[r1], _at_steps(c, 5, PROMPT, 41))
    assert_pixels_match(out[r2], _at_steps(c, 3, "a fox", 42))


def test_stream_block_ticks_match_single_ticks(ctx):
    base = StreamScheduler(ctx, slots=2)
    b1 = {base.submit(PROMPT, seed=50 + i): 50 + i for i in range(3)}
    out1 = base.drain()

    blk = StreamScheduler(ctx, slots=2, max_block=4)
    b2 = {blk.submit(PROMPT, seed=50 + i): 50 + i for i in range(3)}
    out2 = blk.drain()

    for (r1, s1), (r2, s2) in zip(sorted(b1.items(), key=lambda kv: kv[1]),
                                  sorted(b2.items(), key=lambda kv: kv[1])):
        assert s1 == s2
        np.testing.assert_array_equal(out1[r1], out2[r2])
    assert base.dispatches == base.ticks
    assert blk.ticks == base.ticks
    assert blk.dispatches < base.dispatches


def test_stream_block_ticks_heterogeneous(ctx):
    sched = StreamScheduler(ctx, slots=2, step_choices=(2, 6), max_block=8)
    ra = sched.submit(PROMPT, seed=61, steps=2)
    rb = sched.submit("a fox", seed=62, steps=6)
    rc = sched.submit(PROMPT, seed=63, steps=2)
    out = sched.drain()
    assert set(out) == {ra, rb, rc}
    for rid, (prompt, seed, steps) in {
            ra: (PROMPT, 61, 2), rb: ("a fox", 62, 6),
            rc: (PROMPT, 63, 2)}.items():
        assert_pixels_match(out[rid], _at_steps(ctx, steps, prompt, seed))
    assert sched.dispatches < sched.ticks


def test_stream_batched_decode(ctx):
    sched = StreamScheduler(ctx, slots=2)
    r1 = sched.submit(PROMPT, seed=71)
    r2 = sched.submit("a fox", seed=72)
    for _ in range(ctx.steps):
        sched.tick()
    assert len(sched._pending) == 1          # one decode for both
    assert len(sched._pending[0][0]) == 2
    out = sched.completed()
    assert_pixels_match(out[r1], ctx.generate(PROMPT, seed=71))
    assert_pixels_match(out[r2], ctx.generate("a fox", seed=72))


def test_stream_mixed_steps_rejects_unplanned(ctx):
    sched = StreamScheduler(ctx, slots=1, step_choices=(4, 8))
    with pytest.raises(ValueError, match="step_choices"):
        sched.submit(PROMPT, steps=6)


def test_stream_rejects_unsupported(ctx):
    """The reference's refusals, with its texts: long or weighted prompts
    (a negative too), plms_exact, DeepCache."""
    sched = StreamScheduler(ctx, slots=1)
    with pytest.raises(ValueError, match="long/weighted"):
        sched.submit("word " * 200)
    with pytest.raises(ValueError, match="long/weighted"):
        sched.submit(PROMPT, negative_prompt="(blurry:1.4)")
    with pytest.raises(ValueError, match="plms_exact"):
        StreamScheduler(Context(config="tiny", steps=2,
                                sampler="plms_exact", device="cpu"))
    with pytest.raises(ValueError, match="DeepCache"):
        StreamScheduler(Context(config="tiny", steps=2, deepcache=2,
                                device="cpu"))


def test_stream_seed_and_device(ctx):
    """A request without a seed takes the context's, incremented, as
    ``generate`` does; the pool lives on the context's device."""
    sched = StreamScheduler(ctx, slots=1)
    ctx.set_seed(90)
    rid = sched.submit(PROMPT)
    assert ctx.seed == 91
    assert sched._x.device == ctx.device == torch.device("cpu")
    assert_pixels_match(sched.drain()[rid], ctx.generate(PROMPT, seed=90))


# ---------------------------------------------------------------------------
# parity with the reference's StreamScheduler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jmodels():
    """The reference's UNet and VAE jitted once a shape at level 0, its
    ``normal`` draw compiled at level 0 (``tests/test_torch_image.py``)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "normal", _normal_draw)
    mp.setattr(j_unet, "apply", _jit(
        j_unet.apply, static_argnums=(4, 5),
        static_argnames=("deep", "perturb")))
    mp.setattr(j_vae, "apply", _jit(j_vae.apply, static_argnums=(2, 3)))
    yield
    mp.undo()


def _reference(tctx, jcfg, slots, step_choices=None):
    """The reference's scheduler over a stub of its Context on the port's
    weights, its programs unjitted (the models inside stay jitted)."""
    jtree = jax.tree.map(jnp.asarray, to_jax_tree(tctx.params))
    tok = JTokenizer.from_merges(j_context.DEMO_MERGES)
    L = jcfg.clip.context_len

    def embed(text):
        ids = jnp.asarray([tok.tokenize(text, L)], jnp.int32)
        return _encode_text_once(jtree, ids, jcfg)[0]

    stub = types.SimpleNamespace(
        sampler=tctx.sampler, cfg=jcfg, steps=tctx.steps, params=jtree,
        tokenizer=tok, _embed_prompt=embed, _uncond=embed(""), seed=0,
        kernels="xla")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", lambda f, *a, **k: f)
        return j_stream.StreamScheduler(stub, slots,
                                        step_choices=step_choices)


def _jax_draws(seed, steps, shape, ancestral):
    """The reference's admission draw [1, h, w, C] and, for an ancestral
    sampler, its step draws [steps, 1, h, w, C]."""
    key = jax.random.PRNGKey(seed)
    noise = np.array(_normal(key, shape, jnp.float32))[None]
    if not ancestral:
        return noise, None
    sn = np.stack([np.array(_normal(
        jax.random.fold_in(key, ANCESTRAL_FOLD + i), shape, jnp.float32))
        for i in range(steps)])
    return noise, sn[:, None]


PARITY = {
    # name -> (config, sampler, steps, step choices, requests: (prompt,
    # guidance, seed, steps or None, the tick before which it is submitted))
    "dpm": ("tiny", "dpm", 3, None,
            [(PROMPT, 7.5, 1, None, 0), ("a fox", 5.0, 2, None, 0)]),
    "euler_a": ("tiny", "euler_a", 3, None,
                [(PROMPT, 7.5, 3, None, 0), ("a fox", 4.0, 4, None, 1)]),
    "heun": ("tiny", "heun", 2, None,
             [(PROMPT, 6.0, 5, None, 0), ("a fox", 7.5, 6, None, 0)]),
    "lcm": ("tiny_lcm", "lcm", 3, None,
            [(PROMPT, 8.0, 7, None, 0), (PROMPT, 2.0, 7, None, 0)]),
    "mixed": ("tiny", "dpm", 4, (2, 4),
              [(PROMPT, 7.5, 8, 2, 0), ("a fox", 7.5, 9, 4, 0),
               (PROMPT, 3.0, 10, 2, 1)]),
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_stream_matches_the_reference(jmodels, name):
    """The same requests through both schedulers, tick by tick: the
    whole pool's latents within 1e-4 x the reference's max-abs after every
    tick, every image within one level; both retire the same requests on
    the same ticks."""
    config, sampler, steps, choices, reqs = PARITY[name]
    tctx = Context(config=config, steps=steps, sampler=sampler,
                   device="cpu")
    ours = StreamScheduler(tctx, slots=2, step_choices=choices)
    ref = _reference(tctx, getattr(j_config, config.upper()), 2, choices)
    shape = (tctx.cfg.latent_size,) * 2 + (tctx.cfg.latent_channels,)
    ids, out_t, out_j, tick = [], {}, {}, 0
    while len(out_t) < len(reqs):
        for prompt, g, seed, n, at in reqs:
            if at == tick:
                noise, sn = _jax_draws(seed, n or steps, shape,
                                       ours._needs_noise)
                rt = ours.submit(prompt, guidance=g, seed=seed, steps=n,
                                 noise=noise, step_noise=sn)
                rj = ref.submit(prompt, guidance=g, seed=seed, steps=n)
                ids.append((rt, rj))
        ours.tick()
        ref.tick()
        tick += 1
        got, want = ours._x.numpy(), np.asarray(ref._x)
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (tick, err)
        np.testing.assert_array_equal(ours._t_idx.numpy(),
                                      np.asarray(ref._t_idx))
        done_t, done_j = ours.completed(), ref.completed()
        assert sorted(done_t) == sorted(done_j)
        out_t.update(done_t)
        out_j.update(done_j)
    for rt, rj in ids:
        d = np.abs(out_t[rt].astype(int) - np.asarray(out_j[rj]).astype(int))
        assert d.max() <= 1
