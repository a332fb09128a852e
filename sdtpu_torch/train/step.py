"""LDM fine-tuning: the noise-prediction training step for the SD UNet, the
counterpart of ``sdtpu/train/step.py``.

The objective is the latent-diffusion loss (CompVis
ldm/models/diffusion/ddpm.py): a timestep and Gaussian noise per example,
the clean latents forward-diffused to that marginal, the UNet's output
regressed onto the noise (``eps``) or onto ``v = a eps - s x0`` (``v``):

    t ~ U{0..999},  eps ~ N(0, I)
    x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps
    loss = mean || unet(x_t, temb(t), clip(tokens)) - target ||^2

CLIP, the time MLP, SDXL's additive conditioning and the VAE encoder stay
frozen and run under ``torch.no_grad``; the UNet trains from float32 master
weights (``TrainState.params``) through a differentiable cast to the
compute dtype, so its gradients reach the masters in float32 and the
optimizer and the EMA update in float32.

What differs from the reference, by design:

* **Draws.** The port does not copy threefry. One ``torch.Generator`` a step
  draws, in ``TRAIN_DRAW_ORDER``: the timesteps, eps, the offset noise only
  when ``noise_offset > 0``, the posterior noise only on the images path.
  ``draws=`` hands in any of them instead (the tests pass JAX's, made from
  the reference's ``split(key, 3)`` and ``fold_in(key, 1)``). Nothing else
  in a training call draws.
* **In place.** ``train_step`` updates the state's tensors in place and
  returns the same state (the analogue of the reference's donated
  buffers).
* **Optimizer.** ``AdamW`` is optax's ``chain(clip_by_global_norm,
  adamw)`` written out on tensors: the clip is ``g min(1, c / |g|)`` with no
  epsilon, and ``mu``, ``nu`` and ``count`` are optax's. ``trainable``
  restricts it to some leaves, the others' updates being exactly zero
  (``sdtpu/train/lora.py:make_lora_optimizer``).
* **State files** are the port's own (``save_train_state``): one
  safetensors file of flat keys and a JSON header, no pickle, holding the
  logical state however the state was split. An orbax directory is
  refused (``OrbaxCheckpointError``).

On the (data, model) mesh (``sdtpu/train/step.py:17-21, 243-252``; the
reference lets GSPMD shard its one jit) each rank runs the step on its split
tree (``parallel.sharding.shard_params``; ``init_train_state`` over its
UNet, ``make_train_step(..., mesh=, plan=)``), every rank handed the whole
batch: it draws the whole call in ``TRAIN_DRAW_ORDER`` and keeps its data
rows (``sharding.data_rows``), as serving does. The model axis's sums carry
gradients through Megatron's pairs (``parallel.collectives``); the
gradients are averaged over the data group in float32 buckets
(``collectives.all_reduce_mean``), the loss with them; the global norm is
the logical tree's (a split leaf's sum of squares all-reduced over the
model group, a replicated leaf's counted once), and the clip uses it.
AdamW and the EMA are elementwise on the shards. A state saved on a mesh
is gathered into the logical file, which loads on any mesh or one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from sdtpu_torch.config import PipelineConfig
from sdtpu_torch.models import clip, temb, unet
from sdtpu_torch.parallel import collectives
from sdtpu_torch.parallel.mesh import current
from sdtpu_torch.parallel.mesh import use as use_mesh
from sdtpu_torch.parallel.sharding import (check_plan, data_rows, spec_at,
                                           split_leaves, take, whole_shape)
from sdtpu_torch.samplers.schedule import NoiseSchedule

#: the order a training step's generator draws in; "offset" only with
#: noise_offset > 0, "posterior" only on the images path
TRAIN_DRAW_ORDER = ("t", "eps", "offset", "posterior")
#: the kernel policies a training step takes: the ones whose kernels have a
#: backward (K1 has, K2-K5 have none, as the reference's pallas_gn,
#: pallas_conv and int8 paths cannot be differentiated)
TRAIN_KERNELS = ("auto", "plain", "cuda")
STATE_FILE = "train_state.safetensors"
STATE_FORMAT = "sdtpu_torch.train_state"


class OrbaxCheckpointError(ValueError):
    """The JAX package's orbax train-state directory, which the port cannot
    read (orbax needs JAX): it reads its own train-state files."""


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def leaves(tree, path=()):
    """[(path, tensor)] of a tree of dicts and lists, in insertion order;
    a path is a tuple of keys and list indices."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in leaves(v, path + (k,))]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in leaves(v, path + (i,))]
    return [(path, tree)]


def flat_key(path) -> str:
    return "/".join(str(p) for p in path)


def unflatten(like, by_key: dict):
    """``by_key``'s tensors ({flat key: tensor}, the moments' and the
    gradients' form) in ``like``'s tree shape."""
    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return by_key[flat_key(path)]

    return walk(like)


def global_norm(tensors, split=None):
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    a float32 0-d tensor. ``split``: a flag a tensor, set where it holds
    this rank's slice of a leaf split over the mesh's model axis: their sum
    of squares is all-reduced over the model group, and the others, the
    same on every rank, count once, so that the norm is the logical
    tree's."""
    norms = torch.stack(torch._foreach_norm([t.float() for t in tensors]))
    if split is None or not any(split):
        return torch.linalg.vector_norm(norms)
    mask = torch.tensor(split, device=norms.device)
    sq = torch.square(norms)
    whole = collectives.all_reduce_sum(torch.where(mask, sq, 0.0).sum(),
                                       "model")
    return torch.sqrt(torch.where(mask, 0.0, sq).sum() + whole)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW after a global-norm clip (``sdtpu/train/step.py:53``,
    ``optax.chain(clip_by_global_norm(grad_clip), adamw(lr,
    weight_decay))``). ``trainable``: a predicate on a leaf's path, or None
    for every leaf; the others keep no moments and never move."""

    lr: float = 1e-5
    weight_decay: float = 1e-2
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    trainable: Callable | None = None

    def trains(self, path) -> bool:
        return self.trainable is None or bool(self.trainable(path))

    def init(self, params) -> dict:
        """Zero moments (float32, each leaf's shape and memory format) for
        the trainable leaves, ``count`` 0 (a host int64, as read by the
        update's bias corrections)."""
        mu, nu = {}, {}
        for path, p in leaves(params):
            if self.trains(path):
                mu[flat_key(path)] = torch.zeros_like(p, dtype=torch.float32)
                nu[flat_key(path)] = torch.zeros_like(p, dtype=torch.float32)
        return {"count": torch.zeros((), dtype=torch.int64), "mu": mu,
                "nu": nu}

    @torch.no_grad()
    def update_(self, params: dict, grads: dict, state: dict,
                split=frozenset(), norm=None) -> None:
        """One step on ``params`` ({flat key: leaf}) from ``grads`` (the
        same keys), in place; ``state`` is updated in place too. ``split``:
        the keys of leaves split over the mesh's model axis, for the clip's
        norm (``global_norm``); ``norm``: that norm where the caller has
        it."""
        keys = list(state["mu"])
        if not keys:
            return
        p = [params[k] for k in keys]
        g = [grads[k].float() for k in keys]
        if norm is None:
            norm = global_norm(g, [k in split for k in keys])
        # optax: where(|g| < c, g, g / |g| * c); c / 0 = inf clamps to 1
        g = torch._foreach_mul(g, torch.clamp(self.grad_clip / norm,
                                              max=1.0))
        mu = [state["mu"][k] for k in keys]
        nu = [state["nu"][k] for k in keys]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        state["count"] += 1
        n = np.float32(state["count"].item())
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** n)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** n)
        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_add_(p, upd, alpha=-self.lr)


def make_optimizer(lr: float = 1e-5, weight_decay: float = 1e-2,
                   grad_clip: float = 1.0) -> AdamW:
    """AdamW with global-norm clipping, the SD fine-tuning default."""
    return AdamW(lr=lr, weight_decay=weight_decay, grad_clip=grad_clip)


# ---------------------------------------------------------------------------
# the state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """The UNet's float32 master ``params`` (leaves that require grad), the
    optimizer's state (``AdamW.init``), ``step`` (a host int64) and the EMA
    of the params or None. CLIP, the time MLP and the VAE are frozen and
    ride separately."""

    params: dict
    opt_state: dict
    step: torch.Tensor
    ema: dict | None = None


def init_train_state(unet_params, optimizer: AdamW,
                     ema: bool = False) -> TrainState:
    """A TrainState over ``unet_params`` (float32 masters, which it marks
    as requiring grad), the moments on their device. On a mesh,
    ``unet_params`` is this rank's split UNet, and the moments and the EMA
    are its shards."""
    for _, p in leaves(unet_params):
        if p.is_floating_point():
            p.requires_grad_(True)
    return TrainState(
        params=unet_params,
        opt_state=optimizer.init(unet_params),
        step=torch.zeros((), dtype=torch.int64),
        ema=(_map(lambda t: t.detach().clone(), unet_params) if ema
             else None))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def resolve_kernels(kernels: str, device) -> str:
    """A training step's kernel policy: ``auto`` is ``cuda`` on the card,
    as the reference's is ``pallas`` on a TPU, and ``plain`` elsewhere;
    policies whose kernels have no backward are refused."""
    if kernels not in TRAIN_KERNELS:
        raise ValueError(
            f"kernels={kernels!r} cannot train: K2-K5 (cuda_gn, cuda_conv, "
            f"the int8 kernels) have no backward, as the reference's "
            f"pallas_gn, pallas_conv and int8 paths cannot be "
            f"differentiated; use one of {TRAIN_KERNELS}")
    if kernels == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "plain"
    return kernels


def _refuse_quantized(params) -> None:
    for path, _ in leaves(params):
        if path and path[-1] in ("w8", "w_q"):
            raise ValueError(
                f"a quantized UNet tree cannot train ({flat_key(path)}): "
                f"the int8 kernels and their dequantized products have no "
                f"gradient for the weights; train the float tree")


def _tensor(x, device):
    """A batch entry or a handed-in draw (a tensor, a numpy or JAX array)
    as a tensor on ``device``; an array is copied (it may be read-only)."""
    if torch.is_tensor(x):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


def draw(generator, draws, name, shape, device, kind="normal", high=None):
    """One of ``TRAIN_DRAW_ORDER``: ``draws[name]`` where it is handed in,
    else drawn from ``generator``."""
    if draws is not None and name in draws:
        t = _tensor(draws[name], device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"draws[{name!r}] has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        return t.long() if kind == "int" else t.float()
    if kind == "int":
        return torch.randint(0, high, shape, generator=generator,
                             device=device)
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def ldm_loss(unet_params, frozen, batch, generator, cfg: PipelineConfig,
             kernels: str = "auto", remat: bool = False,
             objective: str = "auto", snr_gamma: float = 0.0,
             noise_offset: float = 0.0, draws=None):
    """The loss of ``sdtpu/train/step.py:77-180`` as a differentiable 0-d
    float32 tensor.

    batch: ``tokens`` [B, T] plus either ``latents`` [B, h, w, 4] (clean,
    unscaled VAE latents; the scale factor is applied here) or ``images``
    [B, H, W, 3] in [-1, 1], which the frozen encoder (``frozen["vae_enc"]``)
    turns into a posterior sample inside the loss. numpy arrays or tensors.
    ``unet_params``: the float32 masters; the UNet runs in
    ``cfg.compute_dtype`` through a differentiable cast. ``objective``:
    ``eps``, ``v`` or ``auto`` (``cfg.prediction``). ``snr_gamma`` > 0:
    min-SNR weights, ``min(SNR, g) / SNR`` (eps) or ``/ (SNR + 1)`` (v).
    ``noise_offset`` > 0: eps += offset N(0, 1)[b, 1, 1, c], both in x_t and
    in the target. ``remat``: ``torch.utils.checkpoint`` around the UNet,
    its activations recomputed in the backward. ``kernels``:
    ``TRAIN_KERNELS``. ``generator`` draws ``TRAIN_DRAW_ORDER``; ``draws``
    ({name: array}) hands any of them in.

    On a mesh's data axis the draws are the whole batch's and the loss is
    the mean over this rank's rows (``sharding.data_rows``) of the
    batch."""
    from sdtpu_torch.io.params import cast_params

    if objective == "auto":
        objective = cfg.prediction
    if objective not in ("eps", "v"):
        raise ValueError(f"objective must be eps, v or auto, got "
                         f"{objective!r}")
    _refuse_quantized(unet_params)
    device = leaves(unet_params)[0][1].device
    kernels = resolve_kernels(kernels, device)
    dt = cfg.compute_dtype
    sched = NoiseSchedule.sd_v1()
    abar_all = torch.as_tensor(np.asarray(sched.alphas_cumprod, np.float32),
                               device=device)

    tokens = _tensor(batch["tokens"], device)
    b = tokens.shape[0]
    tokens = data_rows(tokens)
    with torch.no_grad():
        if "latents" in batch:
            latents = data_rows(_tensor(batch["latents"], device).float())
            posterior = None
        else:
            from sdtpu_torch.models import vae

            images = data_rows(_tensor(batch["images"], device))
            posterior = vae.apply_encoder(frozen["vae_enc"], images.to(dt),
                                          cfg.vae, kernels)
            latents = None
    shape = (b,) + tuple(latents.shape[1:] if latents is not None
                         else posterior[0].shape[1:])
    t_idx = data_rows(draw(generator, draws, "t", (b,), device, "int",
                           sched.num_train_steps))
    eps = data_rows(draw(generator, draws, "eps", shape, device))
    if noise_offset:
        eps = eps + noise_offset * data_rows(draw(
            generator, draws, "offset", (b, 1, 1, shape[-1]), device))
    if posterior is not None:
        mean, logvar = posterior
        latents = (mean.float() + torch.exp(0.5 * logvar.float())
                   * data_rows(draw(generator, draws, "posterior", shape,
                                    device)))

    abar = abar_all[t_idx]
    x0 = latents * cfg.vae.scale_factor
    a = torch.sqrt(abar)[:, None, None, None]
    s = torch.sqrt(1.0 - abar)[:, None, None, None]
    x_t = a * x0 + s * eps
    target = eps if objective == "eps" else a * eps - s * x0

    with torch.no_grad():
        if cfg.clip2 is None:
            ctx = clip.apply(frozen["clip"], tokens, cfg.clip, dtype=dt)
            pooled = None
        else:
            # SDXL: the dual-tower packed conditioning (engine.pipeline)
            from sdtpu_torch.engine import pipeline as pl

            ctx, pooled = pl._unpack_context(
                pl.encode_text(frozen, tokens, cfg), cfg)
        te = temb.apply(frozen["temb"], t_idx.float(), cfg.unet, dtype=dt)
        if pooled is not None:
            from sdtpu_torch.engine import pipeline as pl

            te = te + pl._add_embedding(frozen, pooled, cfg).to(te.dtype)

    compute = cast_params(unet_params, dt)
    if remat:
        from torch.utils.checkpoint import checkpoint

        mesh = current()

        def forward(*args):
            # the recompute runs in autograd's device thread: on the call's
            # mesh, which that thread does not see
            with use_mesh(mesh):
                return unet.apply(*args)

        pred = checkpoint(forward, compute, x_t.to(dt), te, ctx, cfg.unet,
                          kernels, use_reentrant=False)
    else:
        pred = unet.apply(compute, x_t.to(dt), te, ctx, cfg.unet, kernels)
    err = torch.square(pred.float() - target)
    if snr_gamma > 0.0:
        snr = abar / (1.0 - abar)
        w = (torch.clamp(snr, max=snr_gamma)
             / (snr + (1.0 if objective == "v" else 0.0)))
        return torch.mean(w * err.mean(dim=(1, 2, 3)))
    return err.mean()


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def loss_and_grads(state: TrainState, frozen, batch, generator,
                   cfg: PipelineConfig, kernels: str = "auto",
                   remat: bool = False, objective: str = "auto",
                   snr_gamma: float = 0.0, noise_offset: float = 0.0,
                   draws=None):
    """``(loss, grads)`` of one step: the float32 0-d loss and {flat key:
    gradient} of every leaf of ``state.params`` (a leaf the forward does
    not read gets zeros, as ``jax.grad`` gives it). On a mesh's data axis
    both are the data group's means, so every rank of a model column holds
    the whole batch's."""
    named = [(flat_key(path), p) for path, p in leaves(state.params)]
    loss = ldm_loss(state.params, frozen, batch, generator, cfg, kernels,
                    remat, objective, snr_gamma, noise_offset, draws)
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True, materialize_grads=True)
    loss = loss.detach()
    mesh = current()
    if mesh is not None and mesh.shape["data"] > 1:
        collectives.all_reduce_mean(list(grads), "data")
        collectives.all_reduce_mean([loss], "data")
    return loss, {k: g for (k, _), g in zip(named, grads)}


def train_step(state: TrainState, frozen, batch, generator,
               cfg: PipelineConfig, optimizer: AdamW, kernels: str = "auto",
               remat: bool = False, ema_decay: float = 0.9999,
               objective: str = "auto", snr_gamma: float = 0.0,
               noise_offset: float = 0.0, draws=None, mesh=None,
               plan=None):
    """One optimizer step, in place; returns ``(state, metrics)``:
    ``loss`` and ``grad_norm``, the global norm of every leaf's gradient
    before the clip (``optax.global_norm(grads)``), both float32 0-d tensors
    on the params' device (``sdtpu/train/step.py:183-200``).

    ``mesh`` and ``plan``: the step on a rank of the (data, model) mesh,
    ``state`` over its split UNet and ``frozen`` its split towers
    (``sharding.shard_params`` under ``plan``, ``site_plan`` of the whole
    tree); the loss and ``grad_norm`` are the logical step's, the same on
    every rank."""
    named = [(flat_key(path), p) for path, p in leaves(state.params)]
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        loss, grads = loss_and_grads(state, frozen, batch, generator, cfg,
                                     kernels, remat, objective, snr_gamma,
                                     noise_offset, draws)
        split = ({flat_key(p) for p in split_leaves(state.params, plan,
                                                    ("unet",))}
                 if plan else frozenset())
        grad_norm = global_norm(list(grads.values()),
                                [k in split for k in grads])
        # the clip's norm is grad_norm where every leaf trains
        optimizer.update_(dict(named), grads, state.opt_state, split,
                          grad_norm if optimizer.trainable is None else None)
    if state.ema is not None:
        with torch.no_grad():
            ema = [e for _, e in leaves(state.ema)]
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, [p for _, p in named],
                                alpha=1.0 - ema_decay)
    state.step += 1
    return state, {"loss": loss, "grad_norm": grad_norm}


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one training step: seeded from the run's seed and
    the step's number, so a resumed run draws what the run it continues
    would have drawn."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) << 32) + int(step))


def make_train_step(cfg: PipelineConfig, optimizer: AdamW,
                    kernels: str = "auto", remat: bool = False,
                    ema_decay: float = 0.9999, objective: str = "auto",
                    snr_gamma: float = 0.0, noise_offset: float = 0.0,
                    mesh=None, plan=None):
    """``step(state, frozen, batch, generator, draws=None) -> (state,
    metrics)`` with the configuration, optimizer, kernels, remat and
    objective knobs fixed: the counterpart of ``jit_train_step``
    (``sdtpu/train/step.py:243``). It updates the state in place, as the
    reference donates its buffers. ``mesh`` and ``plan``: the step on a
    rank of the mesh (``train_step``)."""
    return functools.partial(train_step, cfg=cfg, optimizer=optimizer,
                             kernels=kernels, remat=remat,
                             ema_decay=ema_decay, objective=objective,
                             snr_gamma=snr_gamma, noise_offset=noise_offset,
                             mesh=mesh, plan=plan)


# ---------------------------------------------------------------------------
# state files
# ---------------------------------------------------------------------------

def state_entries(state: TrainState) -> list:
    """[(flat key, the leaf's path in the UNet or None, tensor)] of every
    tensor of the state: params, the moments, count, step, the EMA."""
    out = [(f"params/{flat_key(p)}", p, t.detach())
           for p, t in leaves(state.params)]
    for name in ("mu", "nu"):
        moments = state.opt_state[name]
        out += [(f"opt/{name}/{flat_key(p)}", p, moments[flat_key(p)])
                for p, _ in leaves(state.params) if flat_key(p) in moments]
    out += [("opt/count", None, state.opt_state["count"]),
            ("step", None, state.step)]
    if state.ema is not None:
        out += [(f"ema/{flat_key(p)}", p, t) for p, t in leaves(state.ema)]
    return out


def _state_tensors(state: TrainState) -> dict:
    return {k: t for k, _, t in state_entries(state)}


def _specs(entries, plan) -> dict:
    """{flat key: the spec of the leaf's slice on a rank} ({} where a leaf
    is whole) under ``plan``, ``site_plan`` of the pipeline's tree."""
    out = {}
    for k, p, t in entries:
        if plan and p is not None:
            spec = spec_at(plan, ("unet",) + p, t.dim())
            if spec:
                out[k] = spec
    return out


def save_train_state(state: TrainState, path, mesh=None, plan=None) -> None:
    """The whole training state (params, AdamW moments and count, step,
    EMA), the resume artifact: ``path/train_state.safetensors``, flat keys
    (``params/...``, ``opt/mu/...``, ``opt/nu/...``, ``opt/count``,
    ``step``, ``ema/...``) with a JSON header in the file's metadata. The
    port's format in place of the reference's orbax directory.

    The file holds the logical state (``sdtpu/train/step.py:208-222``).
    ``mesh`` and ``plan``: ``state`` is this rank's of the mesh, split by
    ``plan`` (``site_plan`` of the pipeline's tree); every rank of the mesh
    calls this, each split leaf is gathered in the file's order and the
    mesh's first rank alone writes (``io.checkpoint.save_logical``). The
    header records the mesh it was saved from (for information: the file
    loads on any mesh)."""
    from sdtpu_torch.io.checkpoint import save_logical

    check_plan(mesh, plan)
    entries = state_entries(state)
    header = {"format": STATE_FORMAT, "version": 1,
              "step": int(state.step), "ema": state.ema is not None,
              "logical": True,
              "mesh": [1, 1] if mesh is None else [mesh.shape["data"],
                                                   mesh.shape["model"]]}
    save_logical({k: t for k, _, t in entries}, _specs(entries, plan), mesh,
                 Path(path) / STATE_FILE,
                 metadata={"sdtpu_torch": json.dumps(header)})


def load_train_state(path, like: TrainState, mesh=None,
                     plan=None) -> TrainState:
    """Restore a state written by ``save_train_state`` (on any mesh or on
    one device) into ``like`` (a freshly built ``init_train_state`` with the
    same optimizer and EMA setting), in place: every tensor keeps its
    device, dtype and memory format. ``mesh`` and ``plan``: ``like`` is
    this rank's of the mesh, split by ``plan``; each split leaf takes this
    rank's slice of the file's logical leaf (``sharding.take``), read
    through the file's memory map (``sdtpu/train/step.py:225-250``). No
    collective runs. Raises ``OrbaxCheckpointError`` on the reference's
    orbax directory and ``ValueError`` on missing or extra keys, or a
    tensor whose shape is not the logical state's (naming the key)."""
    from sdtpu_torch.io import safetensors
    from sdtpu_torch.io.weights import is_orbax_checkpoint

    check_plan(mesh, plan)
    root = Path(path)
    file = root / STATE_FILE
    if not file.exists():
        if is_orbax_checkpoint(root):
            raise OrbaxCheckpointError(
                f"{root} is an orbax checkpoint of the JAX package, which "
                f"the port cannot read: the port reads its own train-state "
                f"files ({STATE_FILE}, written by save_train_state)")
        raise FileNotFoundError(f"no {STATE_FILE} under {root}")
    header = json.loads(safetensors.read_metadata(file).get(
        "sdtpu_torch", "{}"))
    if header.get("format") != STATE_FORMAT:
        raise ValueError(f"{file} is not a {STATE_FORMAT} file")
    got = safetensors.load_file(file)
    entries = state_entries(like)
    if set(got) != {k for k, _, _ in entries}:
        want = {k for k, _, _ in entries}
        missing, extra = want - set(got), set(got) - want
        raise ValueError(f"{file}: keys differ from the state: missing "
                         f"{sorted(missing)[:5]}, extra {sorted(extra)[:5]}")
    specs = _specs(entries, plan)
    m = 1 if mesh is None else mesh.shape["model"]
    r = 0 if mesh is None else mesh.coords[1]
    with torch.no_grad():
        for k, _, dst in entries:
            src, spec = got[k], specs.get(k, ())
            want = whole_shape(dst.shape, spec, m)
            if tuple(src.shape) != want:
                part = len(src.shape) == len(want) and all(
                    a == b or (0 < a < b and b % a == 0)
                    for a, b in zip(src.shape, want))
                raise ValueError(
                    f"{file}: {k} has shape {tuple(src.shape)}, the logical "
                    f"state {want}" + (
                        " (one rank's slice: a file written on a mesh before "
                        "the train state was saved whole)" if part else ""))
            dst.copy_(take(src, spec, m, r) if spec else src)
    return like
