"""Training in the port (``sdtpu_torch.train``, the differentiable flash
attention, ``sdtpu-torch train``) against the JAX package's
(``sdtpu.train``), on the CPU at TINY in float32.

The same numpy-seeded inputs go to both; JAX's draws (``split(key, 3)``,
``fold_in(key, 1)``) are handed to the port through ``draws=``. The JAX
side is compiled once per static variant (module-level jits at XLA's
backend optimization level 0, the same arithmetic): ``value_and_grad`` of
its ``ldm_loss`` for TINY's tree with fresh LoRA adapters (B = 0: the
base's loss and base gradients, and the adapters' own), for the images
path with the v objective, min-SNR and offset noise, and for TINY_XL; its
train step is that function's grads through optax's own ``update`` and
``apply_updates`` (``sdtpu/train/step.py:183-200``, one jit an optimizer),
never a jitted ``train_step`` per test. Tolerances: float32 on both sides,
products and sums in other orders."""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from sdtpu import tokenizer as j_tokenizer
from sdtpu.config import TINY as J_TINY
from sdtpu.config import TINY_XL as J_TINY_XL
from sdtpu.ops import attention as j_attn
from sdtpu.train import data as j_data
from sdtpu.train import lora as j_lora
from sdtpu.train import step as j_step
from sdtpu_torch import cli as t_cli
from sdtpu_torch.config import TINY, TINY_XL
from sdtpu_torch.io.params import (
    init_pipeline_params,
    opt_state_from_jax,
    to_jax_tree,
)
from sdtpu_torch.models import unet as t_unet
from sdtpu_torch.ops import attention as t_attn
from sdtpu_torch.quant.ptq import quantize_unet, quantize_weights_only
from sdtpu_torch.tokenizer import DEMO_MERGES, Tokenizer
from sdtpu_torch.train import data as t_data
from sdtpu_torch.train import lora as t_lora
from sdtpu_torch.train import step as t_step

B = 2
# loss: float32 on both sides, reductions in another order
LOSS_RTOL = 1e-5
# a gradient leaf against JAX's, relative to that leaf's largest value:
# float32 products and convolutions summed in other orders through the
# UNet's backward
GRAD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and eager ops on TINY tensors lose far more to oversubscribed threads
    than they gain from them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


#: XLA:CPU compiles at backend optimization level 0 (the same arithmetic)
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
_normal = _jit(jax.random.normal, static_argnums=(1,))
_randint = _jit(jax.random.randint, static_argnums=(1, 2, 3))
_value_and_grad_jit = _jit(jax.value_and_grad(j_step.ldm_loss),
                           static_argnames=("cfg", "objective", "snr_gamma",
                                            "noise_offset"))


def _value_and_grad(params, frozen, batch, key, cfg=J_TINY, objective="eps",
                    snr_gamma=0.0, noise_offset=0.0):
    """The reference's loss and its gradients, one compile per static
    variant (every static argument passed, so equal variants share it)."""
    return _value_and_grad_jit(params, frozen, batch, key, cfg=cfg,
                               objective=objective, snr_gamma=snr_gamma,
                               noise_offset=noise_offset)

_TREES = {}


def trees(cfg):
    """(the port's float32 tree, the JAX layout as jnp arrays) of one init
    of ``cfg`` (demo weights: the UNet's output convs are not zero)."""
    key = id(cfg)
    if key not in _TREES:
        ttree = init_pipeline_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
        _TREES[key] = (ttree, jax.tree.map(jnp.asarray, to_jax_tree(ttree)))
    return _TREES[key]


_LORA = {}


def _lora_trees(rank=4):
    """(the port's tree, JAX's tree, the port's UNet with fresh adapters,
    the same UNet in the JAX layout as jnp arrays): A drawn by the port's
    ``inject_lora`` from a seeded generator, once; the port's UNet a fresh
    copy each call, its state's to own."""
    ttree, jtree = trees(TINY)
    if "jl" not in _LORA:
        tl = t_lora.inject_lora(ttree["unet"], rank,
                                torch.Generator().manual_seed(1))
        _LORA["a"] = {p: n["lora_a"] for p, n in t_lora._site_dicts(tl)}
        _LORA["jl"] = jax.tree.map(jnp.asarray, to_jax_tree(tl))
    tl = t_lora.inject_lora(_masters(ttree), rank, None, a=_LORA["a"])
    return ttree, jtree, tl, _LORA["jl"]


def _frozen(tree, images=False):
    names = ["clip", "clip2", "temb", "add_mlp"] + (["vae_enc"] if images
                                                   else [])
    return {n: tree[n] for n in names if n in tree}


def _batch(cfg, images=False, seed=0):
    rng = np.random.default_rng(seed)
    vocab = cfg.clip.vocab_size if cfg.clip2 is None else min(
        cfg.clip.vocab_size, cfg.clip2.vocab_size)
    out = {"tokens": rng.integers(0, vocab, (B, cfg.clip.context_len)
                                  ).astype(np.int32)}
    if images:
        s = cfg.image_size
        out["images"] = rng.uniform(-1, 1, (B, s, s, 3)).astype(np.float32)
    else:
        s = cfg.latent_size
        out["latents"] = rng.standard_normal(
            (B, s, s, cfg.latent_channels)).astype(np.float32)
    return out


def _draws(key, cfg, offset=False, posterior=False):
    """JAX's draws of ``ldm_loss`` (``sdtpu/train/step.py:134-146``) from
    ``key``, by ``TRAIN_DRAW_ORDER``'s names."""
    kt, ke, kp = jax.random.split(key, 3)
    shape = (B, cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    out = {"t": _randint(kt, (B,), 0, 1000), "eps": _normal(ke, shape)}
    if offset:
        out["offset"] = _normal(jax.random.fold_in(key, 1),
                                (B, 1, 1, shape[-1]))
    if posterior:
        out["posterior"] = _normal(kp, shape)
    return {k: np.asarray(v) for k, v in out.items()}


def _flat(tree, path=()):
    """{path: numpy array} of a tree of dicts and lists (either package's)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, path + (i,)).items()}
    return {path: np.asarray(tree.detach() if torch.is_tensor(tree)
                             else tree)}


def _port_tree(state_params, by_key):
    """{flat key: tensor} -> the params' tree shape, in the JAX layout."""
    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return by_key[t_step.flat_key(path)].detach()

    return to_jax_tree(walk(state_params))


def assert_trees_close(ours, ref, tol=GRAD_TOL, what="grad"):
    """Every leaf of ``ours`` (the JAX layout) within ``tol`` of ``ref``'s,
    relative to the leaf's largest value (an all-zero leaf exactly)."""
    a, b = _flat(ours), _flat(ref)
    assert set(a) == set(b)
    for k in b:
        scale = np.abs(b[k]).max()
        err = np.abs(a[k] - b[k]).max()
        assert err <= tol * scale or (scale == 0 and err == 0), \
            (what, k, err, scale)


def _masters(tree):
    """A float32 copy of the port's UNet tree for a state to own."""
    return t_step._map(lambda t: t.detach().clone(), tree["unet"])


def _port_loss_grads(cfg, tree, batch, draws, unet=None, **kw):
    params = _masters(tree) if unet is None else unet
    state = t_step.init_train_state(params, t_step.make_optimizer())
    loss = t_step.ldm_loss(state.params, _frozen(tree, "images" in batch),
                           batch, None, cfg, draws=draws, **kw)
    named = t_step.leaves(state.params)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return float(loss.detach()), _port_tree(state.params, {
        t_step.flat_key(p): g for (p, _), g in zip(named, grads)})


# ---------------------------------------------------------------------------
# the attention gradient
# ---------------------------------------------------------------------------

def test_attention_grad_matches_jax(monkeypatch):
    """dq, dk, dv of the port's differentiable attention (``FlashSelf``,
    the plain backward on the CPU) against ``jax.grad`` through the
    reference's ``flash_attention`` (Pallas forward in interpret mode, its
    ``_chunked_attn_bwd`` under ``custom_vjp``) at S = 1,024: two query
    chunks of 512."""
    monkeypatch.setattr(j_attn, "INTERPRET", True)
    j_attn._flash_mha.clear_cache()
    s, heads, d = 1024, 2, 40
    rng = np.random.default_rng(1)
    q, k, v, do = (rng.standard_normal((1, s, heads * d), dtype=np.float32)
                   for _ in range(4))

    def f(q, k, v):
        return jnp.sum(j_attn.flash_attention(q, k, v, heads) * do)

    ref = _jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    j_attn._flash_mha.clear_cache()
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = t_attn.flash_attention(*ts, heads)
    assert out.grad_fn is not None and "FlashSelf" in type(
        out.grad_fn).__name__
    ours = torch.autograd.grad(out, ts, torch.from_numpy(do))
    for a, b in zip(ours, ref):
        b = np.asarray(b)
        # float32 both; the forward's online softmax (JAX) and one-pass
        # softmax (port) round otherwise: the attention tests' 2e-4 scale
        assert np.abs(a.numpy() - b).max() <= 2e-4 * np.abs(b).max()
    # the plain backward is the reference's function of (q, k, v, do)
    again = t_attn.flash_attention_bwd_reference(
        *(torch.from_numpy(a) for a in (q, k, v, do)), heads)
    for a, b in zip(ours, again):
        assert torch.equal(a, b)


def test_grad_dispatch_takes_the_function_or_plain(monkeypatch):
    """Under autograd a kernel-sized self-attention goes through
    ``FlashSelf``; without grad the inference path; a chunk that does not
    split 512 ways takes one chunk."""
    x = torch.zeros((1, 512, 16), requires_grad=True)
    assert "FlashSelf" in type(
        t_attn.flash_attention(x, x, x, 2).grad_fn).__name__
    with torch.no_grad():
        assert t_attn.flash_attention(x, x, x, 2).grad_fn is None
    assert t_attn.plan_bwd(40, 4096, 16) == (48, 128, 32, 64)
    assert t_attn.plan_bwd(80, 1024, 16) == (80, 64, 64, 64)
    assert t_attn.plan_bwd(64, 1024, 40) == (64, 64, 64, 64)
    assert t_attn.plan_bwd(96, 77, 1) == (128, 64, 32, 32)
    for bad in (0, 12, 136):
        with pytest.raises(ValueError):
            t_attn.plan_bwd(bad, 1024, 16)


# ---------------------------------------------------------------------------
# ldm_loss and its gradients
# ---------------------------------------------------------------------------

#: (port config, JAX config, images, the port's objective, JAX's, gamma,
#: offset, remat): one JAX compile per (JAX config, images, objective,
#: gamma, offset); the latents cases on TINY with fresh adapters
LOSS_CASES = {
    "eps": (TINY, J_TINY, False, "eps", "eps", 0.0, 0.0, False),
    "auto_eps": (TINY, J_TINY, False, "auto", "eps", 0.0, 0.0, False),
    # the reference's remat equals its plain loss (tests/test_train.py::
    # test_remat_matches_plain_loss): the port's remat is held to it
    "remat": (TINY, J_TINY, False, "eps", "eps", 0.0, 0.0, True),
    "v_images_snr_offset": (TINY, J_TINY, True, "v", "v", 5.0, 0.1, False),
    "auto_v_images_snr_offset": (dataclasses.replace(TINY, prediction="v"),
                                 J_TINY, True, "auto", "v", 5.0, 0.1, False),
    "xl_snr": (TINY_XL, J_TINY_XL, False, "eps", "eps", 5.0, 0.0, False),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_ldm_loss_and_grads_match_jax(case):
    cfg, jcfg, images, obj, jobj, gamma, offset, remat = LOSS_CASES[case]
    ttree, jtree = trees(cfg if cfg.clip2 is not None else TINY)
    unet, junet = None, jtree["unet"]
    if cfg.clip2 is None and not images:
        ttree, jtree, unet, junet = _lora_trees()
    batch = _batch(cfg, images)
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = _value_and_grad(
        junet, _frozen(jtree, images), jbatch, key, cfg=jcfg,
        objective=jobj, snr_gamma=gamma, noise_offset=offset)
    loss, grads = _port_loss_grads(
        cfg, ttree, batch, _draws(key, cfg, offset > 0, images), unet,
        objective=obj, snr_gamma=gamma, noise_offset=offset, remat=remat)
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    assert_trees_close(grads, jgrads)


def test_remat_gives_the_same_gradients():
    """``torch.utils.checkpoint`` around the UNet recomputes the same
    forward: the same loss and gradients, bit for bit on the CPU."""
    ttree, _ = trees(TINY)
    batch = _batch(TINY)
    draws = _draws(jax.random.PRNGKey(3), TINY)
    a = _port_loss_grads(TINY, ttree, batch, draws)
    b = _port_loss_grads(TINY, ttree, batch, draws, remat=True)
    assert a[0] == b[0]
    for k, v in _flat(a[1]).items():
        assert np.array_equal(v, _flat(b[1])[k]), k


def test_draws_follow_the_order():
    """One generator draws t, eps, the offset (only with noise_offset) and
    the posterior (only on the images path) in that order: the loss with a
    generator equals the loss with those draws handed in."""
    ttree, _ = trees(TINY)
    assert t_step.TRAIN_DRAW_ORDER == ("t", "eps", "offset", "posterior")
    for images, offset in ((False, 0.0), (True, 0.1)):
        batch = _batch(TINY, images)
        g = torch.Generator().manual_seed(5)
        shape = (B, 8, 8, 4)
        draws = {"t": torch.randint(0, 1000, (B,), generator=g),
                 "eps": torch.randn(shape, generator=g)}
        if offset:
            draws["offset"] = torch.randn((B, 1, 1, 4), generator=g)
        if images:
            draws["posterior"] = torch.randn(shape, generator=g)
        params = _masters(ttree)
        kw = dict(noise_offset=offset)
        with torch.no_grad():
            a = t_step.ldm_loss(params, _frozen(ttree, images), batch,
                                torch.Generator().manual_seed(5), TINY, **kw)
            b = t_step.ldm_loss(params, _frozen(ttree, images), batch, None,
                                TINY, draws=draws, **kw)
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

DECAY = 0.9


def _ravel(tree, adapters=None):
    """One float32 vector of the tree's leaves, or with ``adapters`` (True
    or False) of the adapter leaves or of the others alone, and its
    inverse ({path: array}), both on the host."""
    leaves = [(p, v) for p, v in _flat(tree).items()
              if adapters is None or t_lora.is_adapter(p) == adapters]
    flat = np.concatenate([v.reshape(-1) for _, v in leaves])
    ends = np.cumsum([v.size for _, v in leaves])

    def unravel(x):
        parts = np.split(np.asarray(x), ends[:-1])
        return {p: part.reshape(v.shape)
                for (p, v), part in zip(leaves, parts)}

    return jnp.asarray(flat), unravel


def _opt_step(opt, grads, opt_state, params, ema):
    """The rest of the reference's ``train_step`` (``sdtpu/train/step.py:
    190-199``): optax's update and apply_updates, the EMA at ``DECAY``,
    ``optax.global_norm`` of the grads."""
    updates, opt_state = opt.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    ema = jax.tree.map(lambda e, p: e * DECAY + p * (1 - DECAY), ema, params)
    return params, opt_state, ema, optax.global_norm(grads)


#: optax runs on raveled trees (one vector, or for LoRA the adapters' and
#: the base's): Adam and the decay are elementwise and the clip's global
#: norm is the vector's, so the numbers are the tree's, and the compile is
#: one small program in place of one a leaf (16 s on this tree)
_opt_step_jit = _jit(_opt_step, static_argnums=(0,))


def _by_key(tree):
    return {t_step.flat_key(p): t for p, t in t_step.leaves(tree)}


def _port_layout(by_path):
    """{path: array in the JAX layout} -> {flat key: float32 tensor in the
    port's layout} (a conv weight HWIO -> OIHW), as the bridge converts."""
    from sdtpu_torch.io.params import _convert

    return {t_step.flat_key(p): _convert(np.asarray(v), p[-1],
                                         torch.float32)
            for p, v in by_path.items()}


def _close(got, want, tol, what, floor=0.0):
    """{key: tensor} against {key: tensor}: the same keys, each within
    ``tol`` of the larger of its own largest value and ``floor``."""
    assert set(got) == set(want), what
    for k, t in want.items():
        scale = max(t.abs().max().item(), floor)
        assert (got[k].detach() - t).abs().max().item() <= tol * scale, \
            (what, k)


def _check_state(state, ref, tol_params, drift=False):
    """The port's state against the reference's ``ref`` ({"params", "mu",
    "nu", "ema"}: {flat key: tensor}, "count"): params and the EMA within
    ``tol_params`` absolute; mu and nu within ``GRAD_TOL`` of each leaf's
    largest value, or of a millionth of the largest moment for a leaf
    that is zero in exact arithmetic (an adapter's scale while B = 0).
    ``drift``: after a second step, whose gradients were taken at params
    that already differ by ``tol_params``, each moment within ``GRAD_TOL``
    of the largest moment of the tree."""
    for name, ours in (("params", state.params), ("ema", state.ema)):
        if ref.get(name) is not None:
            got = _by_key(ours)
            assert set(got) == set(ref[name])
            d = torch.cat([(got[k].detach() - t).abs().reshape(-1)
                           for k, t in ref[name].items()])
            if isinstance(tol_params, tuple):
                # end to end: Adam's steps are near sign(g) at first, so an
                # element whose gradient is within float32 noise of zero can
                # step the other way: a few such elements, none off by more
                # than its steps' size
                close, steps = tol_params
                assert (d > close).float().mean().item() <= 1e-3, name
                assert d.max().item() <= steps, name
            else:
                assert d.max().item() <= tol_params, name
    assert int(state.opt_state["count"]) == ref["count"]
    for name in ("mu", "nu"):
        top = max(t.abs().max().item() for t in ref[name].values())
        _close(state.opt_state[name], ref[name], GRAD_TOL, name,
               top if drift else 1e-6 * top)


def _end_to_end(lr, steps):
    """(a tenth of lr a step, three Adam steps of lr a step: m / sqrt(v)
    stays near 1 in the first steps)."""
    return 0.1 * lr * steps, 3 * lr * steps


class _Ref:
    """The reference's training on TINY's tree with adapters, on raveled
    trees: ``lora`` selects ``make_lora_optimizer`` (the adapters' vector
    and the base's, keyed ``lora_a`` and ``base`` so its labels read them)
    or ``make_optimizer`` (one vector)."""

    def __init__(self, jl, lr, lora):
        self.lora = lora
        if lora:
            self.opt = j_lora.make_lora_optimizer(lr=lr)
            (a, self.un_a), (b, self.un_b) = _ravel(jl, True), _ravel(
                jl, False)
            self.params = {"lora_a": a, "base": b}
        else:
            self.opt = j_step.make_optimizer(lr=lr)
            flat, self.un = _ravel(jl)
            self.params = {"all": flat}
        self.unravel = lambda t: (
            {**self.un_a(t["lora_a"]), **self.un_b(t["base"])} if lora
            else self.un(t["all"]))
        self.state = self.opt.init(self.params)
        self.ema = self.params
        self.tree = jl

    def ravel(self, tree):
        if self.lora:
            return {"lora_a": _ravel(tree, True)[0],
                    "base": _ravel(tree, False)[0]}
        return {"all": _ravel(tree)[0]}

    def step(self, jfrozen, jbatch, key):
        loss, grads = _value_and_grad(self.tree, jfrozen, jbatch, key,
                                      cfg=J_TINY)
        self.params, self.state, self.ema, norm = _opt_step_jit(
            self.opt, self.ravel(grads), self.state, self.params, self.ema)
        self.tree = _tree_like(self.tree, self.unravel(self.params))
        return float(loss), float(norm), grads

    def expect(self, ema=True):
        """The state in the port's layout: {flat key: tensor} of params,
        mu, nu (the trained leaves), the EMA; the count."""
        from sdtpu_torch.io.params import _adam_state

        adam = _adam_state(self.state)
        moments = {}
        for name in ("mu", "nu"):
            m = getattr(adam, name)
            moments[name] = _port_layout(
                self.un_a(m["lora_a"]) if self.lora else self.un(m["all"]))
        return {"params": _port_layout(self.unravel(self.params)),
                "ema": _port_layout(self.unravel(self.ema)) if ema else None,
                "count": int(adam.count), **moments}


def _tree_like(tree, by_path, path=()):
    if isinstance(tree, dict):
        return {k: _tree_like(v, by_path, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_like(v, by_path, path + (i,))
                for i, v in enumerate(tree)]
    return by_path[path]


def _unflat(like, by_key):
    """``by_key``'s tensors in ``like``'s tree shape."""
    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return by_key[t_step.flat_key(path)]

    return walk(like)


def test_train_step_matches_optax():
    """Two steps of the port's ``make_train_step`` (in place, every leaf
    trained, the adapters too) against the reference's step on optax:
    params, ``mu``, ``nu``, ``count``, the EMA, ``loss`` and ``grad_norm``.
    The optimizer alone, fed JAX's gradients, gives optax's params and
    moments to float32 rounding; end to end, params within a tenth of lr a
    step but for a thousandth of them, whose gradients are within float32
    noise of zero (``_check_state``). Then a port step from the
    reference's state after its first step equals the reference's
    second."""
    ttree, jtree, tl, jl = _lora_trees()
    batch = _batch(TINY)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    lr = 1e-3
    ref = _Ref(jl, lr, lora=False)
    opt = t_step.make_optimizer(lr=lr)
    state = t_step.init_train_state(tl, opt, ema=True)
    start = {k: t.detach().clone() for k, t in _by_key(state.params).items()}
    step = t_step.make_train_step(TINY, opt, ema_decay=DECAY)
    frozen, jfrozen = _frozen(ttree), _frozen(jtree)
    after_one = None
    for i in range(2):
        key = jax.random.PRNGKey(20 + i)
        jloss, jnorm, jgrads = ref.step(jfrozen, jbatch, key)
        state, m = step(state, frozen, batch, None, draws=_draws(key, TINY))
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), jnorm,
                                   rtol=GRAD_TOL)
        assert int(state.step) == i + 1
        want = ref.expect()
        _check_state(state, want, _end_to_end(lr, i + 1), drift=i > 0)
        if i == 0:
            after_one = want
            # the optimizer alone on JAX's gradients from the same start
            alone = t_step.TrainState(_unflat(state.params, start),
                                      opt.init(state.params),
                                      torch.tensor(0))
            opt.update_(_by_key(alone.params),
                        _port_layout(_flat(jgrads)), alone.opt_state)
            # float32 rounding: a few ulps of the largest param (~1)
            _check_state(alone, {**want, "ema": None}, 2.0 ** -21)

    # a port state made from the reference's after its first step
    params = _unflat(state.params, {k: t.clone().requires_grad_(True)
                                    for k, t in after_one["params"].items()})
    bridged = t_step.TrainState(params, {
        "count": torch.tensor(after_one["count"]), "mu": after_one["mu"],
        "nu": after_one["nu"]}, torch.tensor(1))
    bridged, _ = step(bridged, frozen, batch, None,
                      draws=_draws(jax.random.PRNGKey(21), TINY))
    _check_state(bridged, {**ref.expect(), "ema": None}, _end_to_end(lr, 1),
                 drift=True)


_update_state = _jit(lambda opt, g, p: opt.update(g, opt.init(p), p)[1],
                     static_argnums=(0,))


def test_opt_state_bridge_reads_optax_trees():
    """``io.params.opt_state_from_jax`` on optax's own states over a tree:
    ``make_optimizer``'s chain and ``make_lora_optimizer``'s
    multi_transform (masked leaves have no moments), a conv weight's
    moments turned HWIO -> OIHW as its weight is."""
    rng = np.random.default_rng(2)
    tree = {"conv": {"w": jnp.asarray(rng.standard_normal((3, 3, 2, 5),
                                                          np.float32)),
                     "lora_a": jnp.ones((4, 2)), "lora_b": jnp.ones((2, 5))},
            "blocks": [{"w": jnp.ones((2, 3))}]}
    grads = jax.tree.map(lambda x: x * 0.5, tree)
    for opt, keys in ((j_step.make_optimizer(), {
            "conv/w", "conv/lora_a", "conv/lora_b", "blocks/0/w"}),
            (j_lora.make_lora_optimizer(), {"conv/lora_a", "conv/lora_b"})):
        st = _update_state(opt, grads, tree)
        got = opt_state_from_jax(st)
        assert int(got["count"]) == 1 and set(got["mu"]) == keys
        if "conv/w" in keys:
            mu = np.array(st[1][0].mu["conv"]["w"])
            assert torch.equal(got["mu"]["conv/w"],
                               torch.from_numpy(mu).permute(3, 2, 0, 1))
            assert got["mu"]["conv/w"].is_contiguous(
                memory_format=torch.channels_last)


def test_masters_stay_float32_and_small_updates_survive():
    """bf16 compute with float32 masters: every param, moment and EMA
    leaf stays float32, and an lr of 1e-5 moves them (in bf16 most such
    updates round away; ``tests/test_train.py``'s ADVICE r2 case)."""
    ttree, _ = trees(TINY)
    cfg = dataclasses.replace(TINY, dtype="bfloat16")
    frozen = {k: t_step._map(lambda t: t.to(torch.bfloat16), v)
              for k, v in _frozen(ttree).items()}
    before = _masters(ttree)
    state = t_step.init_train_state(_masters(ttree), t_step.make_optimizer(),
                                    ema=True)
    state, m = t_step.train_step(state, frozen, _batch(TINY),
                                 torch.Generator().manual_seed(0), cfg,
                                 t_step.make_optimizer())
    assert np.isfinite(float(m["loss"]))
    for tree in (state.params, state.ema):
        assert all(t.dtype == torch.float32 for _, t in t_step.leaves(tree))
    moved = max((p - q).abs().max().item() for (_, p), (_, q) in zip(
        t_step.leaves(state.params), t_step.leaves(before)))
    assert moved > 0


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------



def test_injected_lora_is_the_base_and_its_sites_are_the_references():
    """``inject_lora``: the reference's sites and mask, A N(0, 1) / sqrt(in)
    from the caller's generator (or handed in), B zero, s = alpha / rank;
    the injected UNet's output is the base's, bit for bit."""
    ttree, jtree, tl, jl = _lora_trees()
    # (JAX's trees keep their dicts' keys sorted: the same sites)
    assert {p for p, _ in t_lora._site_dicts(tl)} == {
        p for p, _ in j_lora._site_dicts(jtree["unet"])}
    assert _flat(t_lora.lora_mask(tl)) == _flat(j_lora.lora_mask(jl))
    for _, site in t_lora._site_dicts(tl):
        d_in = site["w"].shape[0]
        assert site["lora_a"].shape == (d_in, 4)
        assert not site["lora_b"].any() and float(site["lora_s"]) == 1.0
    a = torch.cat([s["lora_a"].reshape(-1) * s["w"].shape[0] ** 0.5
                   for _, s in t_lora._site_dicts(tl)])
    assert abs(float(a.std()) - 1.0) < 0.1 and abs(float(a.mean())) < 0.1
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((B, 8, 8, 4), np.float32))
    te = torch.from_numpy(rng.standard_normal(
        (B, TINY.unet.time_embed_dim), np.float32))
    ctx = torch.from_numpy(rng.standard_normal(
        (B, TINY.clip.context_len, TINY.unet.context_dim), np.float32))
    with torch.no_grad():
        assert torch.equal(t_unet.apply(tl, x, te, ctx, TINY.unet),
                           t_unet.apply(ttree["unet"], x, te, ctx, TINY.unet))


def test_masked_lora_step_moves_only_the_adapters():
    """One step of ``make_lora_optimizer`` against the reference's masked
    optimizer (``tests/test_lora.py:60``'s run): the adapters, their
    moments, loss and ``grad_norm`` (over every leaf, base ones too);
    every base leaf keeps its bytes and has no moments."""
    ttree, jtree, tl, jl = _lora_trees()
    batch = _batch(TINY)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(2)
    lr = 1e-2
    ref = _Ref(jl, lr, lora=True)
    jloss, jnorm, _ = ref.step(_frozen(jtree), jbatch, key)
    base = {k: t.detach().clone() for k, t in _by_key(tl).items()}
    opt = t_lora.make_lora_optimizer(lr=lr)
    state = t_step.init_train_state(tl, opt)
    assert set(state.opt_state["mu"]) == {
        k for k in base if k.endswith(("lora_a", "lora_b"))}
    state, m = t_step.train_step(state, _frozen(ttree), batch, None, TINY,
                                 opt, draws=_draws(key, TINY))
    np.testing.assert_allclose(float(m["loss"]), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), jnorm, rtol=GRAD_TOL)
    moved = 0
    for path, t in t_step.leaves(state.params):
        k = t_step.flat_key(path)
        if t_lora.is_adapter(path):
            moved += not torch.equal(t, base[k])
        else:
            assert torch.equal(t.detach(), base[k]), k
    assert moved
    _check_state(state, {**ref.expect(), "ema": None}, _end_to_end(lr, 1))


# ---------------------------------------------------------------------------
# the data module
# ---------------------------------------------------------------------------

def _shards(tmp_path):
    rng = np.random.default_rng(11)
    root = tmp_path / "shards"
    root.mkdir()
    for i, n in enumerate((5, 3)):
        np.savez(root / f"s{i}.npz",
                 latents=rng.standard_normal((n, 8, 8, 4)).astype(np.float32),
                 tokens=rng.integers(0, 500, (n, 16)).astype(np.int32))
    return root


def _image_folder(tmp_path, n=4, size=16):
    rng = np.random.default_rng(12)
    root = tmp_path / "images"
    root.mkdir()
    lines = []
    for i in range(n):
        # one image a size to crop: the resize and center crop run
        w, h = (size, size) if i % 2 else (size + 6, size + 2)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(root / f"{i}.png")
        lines.append(f"{i}.png\ta photo number {i}")
    (root / "captions.txt").write_text("\n".join(lines) + "\n")
    return root


def _same_batches(ours, ref):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref) and ref
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for k in b:
            got = a[k].cpu().numpy() if torch.is_tensor(a[k]) else a[k]
            assert np.array_equal(got, b[k]), k


@pytest.mark.parametrize("kind", ["shards", "images"])
def test_batches_are_the_references(tmp_path, kind):
    """The same batches as ``sdtpu.train.data`` for each seed, epoch and
    shard layout: the sources, ``make_dataset``, ``batches`` and ``stream``
    without prefetch."""
    if kind == "shards":
        root = _shards(tmp_path)
        ours = t_data.make_dataset(root)
        ref = j_data.make_dataset(root)
    else:
        root = _image_folder(tmp_path)
        ours = t_data.make_dataset(root, Tokenizer.from_merges(DEMO_MERGES),
                                   16, 16)
        ref = j_data.make_dataset(
            root, j_tokenizer.Tokenizer.from_merges(DEMO_MERGES), 16, 16)
    assert len(ours) == len(ref) and ours.kind == ref.kind
    for seed, epoch in ((0, 0), (0, 1), (3, 0)):
        _same_batches(t_data.batches(ours, 2, epoch, seed),
                      j_data.batches(ref, 2, epoch, seed))
    _same_batches(t_data.batches(ours, 3, 0, 1, shuffle=False,
                                 drop_last=False),
                  j_data.batches(ref, 3, 0, 1, shuffle=False,
                                 drop_last=False))
    it = t_data.stream(ours, 2, seed=4, epochs=2, prefetch=0, start_epoch=1)
    _same_batches(it, j_data.stream(ref, 2, seed=4, epochs=2, prefetch=0,
                                    start_epoch=1))


def test_prefetcher_is_the_synchronous_stream_and_passes_errors(tmp_path):
    ds = t_data.make_dataset(_shards(tmp_path))
    want = list(t_data.batches(ds, 2, 0, 0))
    pf = t_data.Prefetcher(iter(want), depth=2)
    _same_batches(pf, want)
    with pytest.raises(StopIteration):
        next(pf)

    def failing():
        yield want[0]
        raise OSError("shard unreadable")

    pf = t_data.Prefetcher(failing(), depth=2)
    _same_batches([next(pf)], want[:1])
    with pytest.raises(OSError, match="shard unreadable"):
        next(pf)
    # close() stops a thread blocked on a full queue
    pf = t_data.stream(ds, 1, seed=0, prefetch=1)
    next(pf)
    pf.close()
    assert not pf._t.is_alive()


# ---------------------------------------------------------------------------
# state files and refusals
# ---------------------------------------------------------------------------

def _orbax_dir(tmp_path):
    """A directory the reference's rule takes for an orbax checkpoint
    (``sdtpu/io/orbax_ckpt.py:72``: its ``_CHECKPOINT_METADATA`` file)."""
    from sdtpu.io.orbax_ckpt import is_orbax_checkpoint

    root = tmp_path / "orbax"
    (root / "state").mkdir(parents=True)
    (root / "state" / "_CHECKPOINT_METADATA").write_text("{}")
    assert is_orbax_checkpoint(root)
    return root


def test_state_file_round_trip_and_orbax_refused(tmp_path):
    """``save_train_state`` then ``load_train_state`` into a fresh state
    gives every tensor's bytes, and the next step from each is the same;
    the reference's orbax directory is refused, naming the port's own
    train-state files."""
    ttree, _ = trees(TINY)
    opt = t_step.make_optimizer(lr=1e-3)
    step = t_step.make_train_step(TINY, opt)
    state = t_step.init_train_state(_masters(ttree), opt, ema=True)
    batch = _batch(TINY)
    state, _ = step(state, _frozen(ttree), batch,
                    torch.Generator().manual_seed(1))
    t_step.save_train_state(state, tmp_path / "ck")
    fresh = t_step.init_train_state(_masters(ttree), opt, ema=True)
    back = t_step.load_train_state(tmp_path / "ck", fresh)
    assert int(back.step) == 1
    a, b = t_step._state_tensors(state), t_step._state_tensors(back)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    _, ma = step(state, _frozen(ttree), batch,
                 torch.Generator().manual_seed(2))
    _, mb = step(back, _frozen(ttree), batch,
                 torch.Generator().manual_seed(2))
    assert float(ma["loss"]) == float(mb["loss"])
    for (_, p), (_, q) in zip(t_step.leaves(state.params),
                              t_step.leaves(back.params)):
        assert torch.equal(p, q)

    with pytest.raises(ValueError, match="keys differ"):
        t_step.load_train_state(tmp_path / "ck", t_step.init_train_state(
            _masters(ttree), opt))
    _orbax_dir(tmp_path)
    with pytest.raises(t_step.OrbaxCheckpointError,
                       match="its own train-state files"):
        t_step.load_train_state(tmp_path / "orbax", fresh)
    with pytest.raises(FileNotFoundError):
        t_step.load_train_state(tmp_path / "missing", fresh)


@pytest.mark.parametrize("kernels", ["cuda_gn", "cuda_conv", "nope"])
def test_ldm_loss_refuses_kernels_without_a_backward(kernels):
    ttree, _ = trees(TINY)
    with pytest.raises(ValueError, match="no backward"):
        t_step.ldm_loss(_masters(ttree), _frozen(ttree), _batch(TINY),
                        torch.Generator(), TINY, kernels=kernels)


@pytest.mark.parametrize("mode", ["int8w", "int8"])
def test_ldm_loss_refuses_a_quantized_tree(mode):
    ttree, _ = trees(TINY)
    if mode == "int8":
        unet = quantize_unet({"unet": ttree["unet"]})["unet"]
    else:
        unet = quantize_weights_only(ttree["unet"], include_dense=True,
                                     min_elems=0)
    with pytest.raises(ValueError, match="quantized UNet tree cannot train"):
        t_step.ldm_loss(unet, _frozen(ttree), _batch(TINY),
                        torch.Generator(), TINY)


def test_auto_kernels_resolve_by_device():
    """``auto`` is the card's ``cuda``; the CLI's choices are the step's
    policies (a literal copy there: ``--help`` imports no model)."""
    assert t_cli.TRAIN_KERNEL_CHOICES == list(t_step.TRAIN_KERNELS)
    assert t_step.resolve_kernels("auto", "cpu") == "plain"
    assert t_step.resolve_kernels("auto", "cuda") == "cuda"
    assert t_step.resolve_kernels("plain", "cuda") == "plain"


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

STEP_LINE = re.compile(r"^step +\d+  loss \d+\.\d{4}  gnorm \d+\.\d{3}  "
                       r"\(\d+\.\d+s\)$")


def _train(args, capsys):
    rc = t_cli.main(["train", "--config", "tiny", "--platform", "cpu",
                     "--log-every", "1", *args])
    return rc, capsys.readouterr()


def test_cli_train_demo_resume_and_data(tmp_path, capsys):
    """``train`` at TINY on the CPU: the demo batches with ``--ema``, the
    reference's line formats, a state that ``load_train_state`` reads;
    ``--resume`` continues its step count; ``--data`` over shards and over
    an image folder; an orbax ``--resume`` is refused, naming the port's
    own train-state files."""
    out = tmp_path / "ck"
    rc, io = _train(["--steps", "2", "--batch", "2", "--ema", "--out",
                     str(out)], capsys)
    assert rc == 0, io.err
    lines = io.out.splitlines()
    assert lines[0] == "no --model-dir: random-init demo weights"
    assert lines[2] == "no --data: 8 synthetic demo examples"
    steps = [ln for ln in lines if ln.startswith("step")]
    assert len(steps) == 2 and all(STEP_LINE.match(s) for s in steps)
    assert lines[-1] == f"saved train state (step 2, ema) to {out}"
    ttree, _ = trees(TINY)
    like = t_step.init_train_state(_masters(ttree), t_step.make_optimizer(),
                                   ema=True)
    assert int(t_step.load_train_state(out, like).step) == 2

    rc, io = _train(["--steps", "1", "--ema", "--resume", str(out), "--out",
                     str(tmp_path / "ck2")], capsys)
    assert rc == 0 and f"resumed at step 2 from {out}" in io.out
    assert "step      3  loss" in io.out

    rc, io = _train(["--steps", "2", "--data", str(_shards(tmp_path)),
                     "--out", str(tmp_path / "ck3")], capsys)
    assert rc == 0 and "dataset: 8 examples (latents), 4 steps/epoch, " \
        "resuming epoch 0" in io.out
    rc, io = _train(["--steps", "1", "--data", str(_image_folder(tmp_path)),
                     "--prefetch", "0", "--objective", "v", "--out",
                     str(tmp_path / "ck4")], capsys)
    assert rc == 0 and "dataset: 4 examples (images)" in io.out
    assert "WARNING: --objective v differs" in io.err

    _orbax_dir(tmp_path)
    rc, io = _train(["--steps", "1", "--resume", str(tmp_path / "orbax")],
                    capsys)
    assert rc == 2 and "its own train-state files" in io.err
