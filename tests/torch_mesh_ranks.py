"""One rank of ``tests/test_torch_mesh.py``'s gloo worlds, on the CPU.

    python tests/torch_mesh_ranks.py <world> <rank> <dir>

joins a gloo group of ``world`` ranks through the file store
``<dir>/store<world>``, runs every case of that world's meshes ((1, 2) and
(2, 1) in a world of two, (2, 2) in one of four) and writes
``<dir>/w<world>_r<rank>.npz``: each case's result under
``"<data>x<model>/<case>"``, the collectives the case issued under
``".../counts"`` (in ``collectives.COLLECTIVES`` order) and a refusal's
text under ``".../error"``. A "world" of one (no process group) writes the
Context's cases off the mesh, under ``"single/<case>"``.

Four kinds of case. The Context's: every entry point the reference routes
to the mesh, at TINY in float32, on a ``Context(mesh=...)`` beside the same
call on a Context without one, the stream pool's included, and at (1, 2)
the two requests the parent sends to ``sdtpu-torch serve --mesh 1,2``. The
pipeline's (``anchor_*``): the port's pipeline functions on the rank's
split tree with the reference's draws handed in through the seams
(``<dir>/inputs.npz``), held against the JAX package by the parent. The
spatial partition's (``spatial_*``, at m = 2): ``sharding.generate_sharded
(..., spatial=True)`` with the reference's draws, and one UNet eval's
collectives. The train step's (``train``): two steps of
``make_train_step(..., mesh=, plan=)`` with the reference's draws, the state
gathered (``sharding.gather_params``), each leaf's digest and each step's
collectives; the state saved whole into ``<dir>/ts_<mesh>`` and reloaded
(at (2, 1) also the file (1, 2) saved). The checkpoint's
(``checkpoint``): the demo Context's tree saved from the mesh into
``<dir>/ck_<mesh>`` and served from it. Imports no JAX: a spawned rank does
not pay for it.
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from sdtpu_torch import Context
from sdtpu_torch import config as t_config
from sdtpu_torch.engine import pipeline
from sdtpu_torch.engine.stream import StreamScheduler
from sdtpu_torch.io import safetensors as st
from sdtpu_torch.io.checkpoint import save_checkpoint
from sdtpu_torch.io.params import init_pipeline_params
from sdtpu_torch.models import unet
from sdtpu_torch.parallel import collectives, mesh as mesh_mod
from sdtpu_torch.parallel import sharding, spatial
from sdtpu_torch.parallel.sharding import shard_params
from sdtpu_torch.train import step as T

STEPS = 2
PROMPTS = ["a fox in the snow", "a red car"]
LONG = ("a (very:1.3) detailed watercolor painting of a lighthouse on a "
        "rocky coast at dusk with seagulls and waves")
REQUESTS = [
    {"prompt": "a fox in the snow", "seed": 11, "guidance": 7.5},
    {"prompt": "a (red:1.3) car", "seed": 12, "guidance": 1.0,
     "negative_prompt": "blurry"},
    {"prompt": "a lighthouse", "seed": 13, "guidance": 4.0,
     "negative_prompt": "dark"},
]
#: the stream pool's requests: plain prompts (the pool refuses weighted
#: ones)
POOL_REQUESTS = [dict(r, prompt=p) for r, p in
                 zip(REQUESTS, ["a fox in the snow", "a red car",
                                "a lighthouse"])]
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
#: anchor name -> (config, pipeline function, the draws it takes)
ANCHORS = {
    "anchor_generate": ("TINY", "generate", ("noise",)),
    "anchor_img2img": ("TINY", "img2img", ("noise", "posterior_noise")),
    "anchor_inpaint": ("TINY", "inpaint",
                       ("noise", "posterior_noise", "pin_noise")),
    "anchor_inpaint9": ("TINY_INPAINT", "inpaint",
                        ("noise", "posterior_noise", "masked_noise")),
    "anchor_xl_inpaint9": ("TINY_XL_INPAINT", "inpaint",
                           ("noise", "posterior_noise", "masked_noise")),
}
ANCHOR_STEPS = 3
ANCHOR_START = {"generate": 0, "img2img": 1, "inpaint": 1}
#: the spatial partition's cases: latent size -> the kernel policies run
#: (their plain versions on the CPU); at 6 the 3-wide level does not tile
#: m = 2 and the 6-wide one's slices are odd (its down conv gathers)
SPATIAL = {8: ("plain", "cuda_gn", "cuda_conv"), 6: ("plain",)}
SPATIAL_MESHES = [(1, 2), (2, 2)]
#: the train step's: TINY, two steps of AdamW at TRAIN_LR, the EMA at
#: TRAIN_DECAY, a batch of 2
TRAIN_STEPS = 2
TRAIN_LR = 1e-3
TRAIN_DECAY = 0.9
#: the requests the parent sends to ``serve --mesh 1,2 --stream-slots 2``:
#: /generate through the pool, /img2img through the micro-batcher
SERVE_STEPS = 2
SERVE_GENERATE = {"prompt": "a fox in the snow", "seed": 21,
                  "guidance": 6.0, "negative_prompt": "blurry"}
SERVE_IMG2IMG = {"prompt": "a red car", "seed": 22, "guidance": 7.5}
SERVE_STRENGTH = 0.6


def _images(b, seed, size):
    return np.random.default_rng(seed).integers(0, 256, (b, size, size, 3),
                                                dtype=np.uint8)


def _masks(b, size):
    m = np.zeros((b, size, size), np.uint8)
    m[:, : size // 2] = 255
    return m


def context_cases(mesh, inputs):
    """{case: result} of the Context's entry points on ``mesh`` (None: a
    Context without one), and {case: collective counts}."""
    out, counts = {}, {}

    def run(name, fn):
        collectives.reset_counts()
        out[name] = np.asarray(fn())
        counts[name] = np.array([collectives.collective_counts()[k]
                                 for k in collectives.COLLECTIVES])

    def ctx(config="tiny", **kw):
        return Context(config=config, steps=STEPS, device="cpu", mesh=mesh,
                       **kw)

    c = ctx()
    size = c.cfg.image_size
    imgs, masks = _images(2, 5, size), _masks(2, size)
    run("generate", lambda: c.generate(PROMPTS, seed=3))
    run("generate_negative", lambda: c.generate(
        PROMPTS, seed=4, negative_prompt="blurry", guidance=5.0))
    run("generate_async", lambda: c.generate_async(PROMPTS, seed=6)())
    run("generate_batch", lambda: np.stack(c.generate_batch(REQUESTS)))
    run("scheduled", lambda: c.generate(
        ["a [cat:dog:0.5] photo", "a [red|blue] car"], seed=7))
    run("weighted", lambda: c.generate([LONG, "a (blue:0.7) bird"], seed=8,
                                       negative_prompt=LONG))
    run("img2img", lambda: c.img2img(PROMPTS, imgs, strength=0.5, seed=5))
    run("inpaint", lambda: c.inpaint(PROMPTS, imgs, masks, seed=5))
    run("img2img_batch", lambda: np.stack(c.img2img_batch(
        [dict(r, image=imgs[i % 2]) for i, r in enumerate(REQUESTS)],
        strength=0.6)))
    run("inpaint_batch", lambda: np.stack(c.inpaint_batch(
        [dict(r, image=imgs[i % 2], mask=masks[0])
         for i, r in enumerate(REQUESTS)])))
    run("hires_fix", lambda: c.hires_fix(PROMPTS, seed=2, strength=0.5))
    run("two_stage_base", lambda: c.generate(
        PROMPTS, seed=3, denoising_end=0.5, output="latent"))
    run("two_stage", lambda: c.refine(out["two_stage_base"], PROMPTS,
                                      seed=3, denoising_start=0.5))
    c.load_controlnet("edge", "random")
    hint = _images(1, 9, size)[0]
    run("controlnet", lambda: c.generate(PROMPTS, seed=9,
                                         control_image=hint,
                                         control_scale=0.7))
    c.load_lora("style", inputs["lora_path"])
    run("lora", lambda: c.generate(PROMPTS, seed=10, lora="style"))
    pin = Context(config="tiny", steps=1, device="cpu", mesh=mesh)
    run("pin", lambda: pin.generate(PROMPTS, seed=1))
    xl = ctx(t_config.TINY_XL)
    run("xl", lambda: xl.generate(PROMPTS, seed=4, negative_prompt="dark"))
    c9 = ctx(t_config.TINY_INPAINT)
    run("concat_inpaint9", lambda: c9.inpaint(PROMPTS, imgs, masks, seed=6,
                                              strength=0.8))
    ip = ctx(t_config.TINY_IP2P)
    run("ip2p", lambda: ip.instruct_pix2pix(PROMPTS, imgs, seed=3))
    def pool():
        sched = StreamScheduler(c, slots=2)
        ids = [sched.submit(r["prompt"], guidance=r["guidance"],
                            seed=r["seed"],
                            negative_prompt=r.get("negative_prompt"))
               for r in POOL_REQUESTS]
        done = sched.drain()
        return np.stack([done[i] for i in ids])

    run("stream", pool)
    run("stream_batch", lambda: np.stack(c.generate_batch(POOL_REQUESTS)))
    if mesh in (None, (1, 2)):
        # what serve --mesh 1,2 must answer (the server's Context: TINY,
        # SERVE_STEPS, its pool of two slots)
        s = Context(config="tiny", steps=SERVE_STEPS, device="cpu",
                    mesh=mesh)
        run("serve_generate", lambda: _served_pool(s))
        run("serve_img2img", lambda: s.img2img_batch(
            [dict(SERVE_IMG2IMG, image=serve_image(size))],
            strength=SERVE_STRENGTH)[0])
    if mesh is not None and mesh[0] > 1:
        try:
            c.generate(["one"], seed=0)
            out["indivisible/error"] = np.array("no error")
        except Exception as e:  # noqa: BLE001 - the parent reads the text
            out["indivisible/error"] = np.array(
                f"{type(e).__name__}:{getattr(e, 'code', None)!r}:"
                f"{getattr(e, 'reason', e)}")
    return out, counts


def serve_image(size):
    """The /img2img request's image."""
    return _images(1, 23, size)[0]


def _served_pool(ctx):
    sched = StreamScheduler(ctx, slots=2)
    rid = sched.submit(**SERVE_GENERATE)
    return sched.drain()[rid]


def spatial_cases(mesh_shape, inputs):
    """The spatial partition at ``mesh_shape``: {case: latents or image}
    of ``generate_sharded(..., spatial=True)`` on the rank's split tree
    with the reference's draws (``spatial_<latent>/...`` of the inputs),
    under each policy of ``SPATIAL``; {case: collectives} of one UNet eval
    under the spatial spec."""
    import dataclasses

    m = mesh_mod.make_mesh(*mesh_shape)
    full = init_pipeline_params(t_config.TINY,
                                torch.Generator().manual_seed(0), "cpu")
    local = shard_params(full, m, t_config.TINY)
    out, counts = {}, {}
    for lat, policies in SPATIAL.items():
        cfg = dataclasses.replace(t_config.TINY, latent_size=lat)
        tag = f"spatial_{lat}"
        tok = torch.from_numpy(inputs[f"{tag}/tokens"]).long()
        with torch.inference_mode(), mesh_mod.use(m):
            un = pipeline.encode_text(
                local, torch.zeros((1, cfg.clip.context_len),
                                   dtype=torch.int64), cfg)[0]
        for kernels in policies:
            call = sharding.generate_sharded(cfg, m, "dpm", ANCHOR_STEPS,
                                             kernels=kernels, spatial=True)
            for output in ("latent", "image"):
                r = call(local, tok, un, None, 7.5, output=output,
                         noise=inputs[f"{tag}/noise"])
                out[f"{tag}/{kernels}/{output}"] = r.numpy()
        g = torch.Generator().manual_seed(4)
        x = torch.randn((2, lat, lat, 4), generator=g)
        te = torch.randn((2, cfg.unet.time_embed_dim), generator=g)
        ctx = torch.randn((2, cfg.clip.context_len, cfg.unet.context_dim),
                          generator=g)
        collectives.reset_counts()
        with torch.inference_mode(), mesh_mod.use(m), spatial.use(m):
            unet.apply(local["unet"], x, te, ctx, cfg.unet, "plain")
        counts[f"{tag}/eval"] = np.array(
            [collectives.collective_counts()[k]
             for k in collectives.COLLECTIVES])
    return out, counts


def _digests(tree):
    return np.array([hashlib.sha1(t.detach().numpy().tobytes()).hexdigest()
                     for _, t in T.leaves(tree)])


@contextlib.contextmanager
def counted_writers(paths):
    """Record in ``paths`` each file a ``safetensors.StreamWriter`` opens
    in this process while the block runs."""
    base = st.StreamWriter

    class Counted(base):
        def __init__(self, path, *args, **kw):
            paths.append(str(path))
            super().__init__(path, *args, **kw)

    st.StreamWriter = Counted
    try:
        yield paths
    finally:
        st.StreamWriter = base


def checkpoint_cases(mesh_shape, d):
    """The pipeline's checkpoint on ``mesh_shape``: the demo weights'
    ``Context(mesh=)`` saved by ``save_checkpoint`` (the files each rank
    opened, its all-gathers) into ``<d>/ck_<mesh>``, then a ``Context(model_dir=)`` of it
    on the same mesh: whether its split tree and plan are the demo
    Context's, and the ``generate`` case's images with their
    collectives."""
    out, counts = {}, {}
    tag = f"{mesh_shape[0]}x{mesh_shape[1]}"
    c = Context(config="tiny", steps=STEPS, device="cpu", mesh=mesh_shape)
    collectives.reset_counts()
    with counted_writers([]) as opened:
        save_checkpoint(c.params, d / f"ck_{tag}", mesh=c.mesh, plan=c.plan)
    out["checkpoint/writes"] = np.array(len(opened))
    out["checkpoint/save_gathers"] = np.array(
        collectives.collective_counts()["all-gather"])
    loaded = Context(config="tiny", steps=STEPS, device="cpu",
                     mesh=mesh_shape, model_dir=str(d / f"ck_{tag}"))
    a, b = dict(T.leaves(loaded.params)), dict(T.leaves(c.params))
    # values and dtypes (a 1x1 conv's strides may differ: either is its
    # one layout in memory)
    out["checkpoint/same_tree"] = np.array(set(a) == set(b) and all(
        a[p].dtype == t.dtype and torch.equal(a[p], t)
        for p, t in b.items()))
    out["checkpoint/same_plan"] = np.array(loaded.plan == c.plan)
    collectives.reset_counts()
    out["checkpoint/generate"] = loaded.generate(PROMPTS, seed=3)
    counts["checkpoint/generate"] = np.array(
        [collectives.collective_counts()[k] for k in collectives.COLLECTIVES])
    return out, counts


def _state_digests(state):
    """{flat key: digest} of every tensor of a train state."""
    return {k: hashlib.sha1(t.detach().contiguous().numpy().tobytes()
                            ).hexdigest()
            for k, t in T._state_tensors(state).items()}


def _fresh_state(m, cfg, plan, opt):
    full = init_pipeline_params(cfg, torch.Generator().manual_seed(0), "cpu")
    local = shard_params(full, m, cfg, plan)
    return T.init_train_state(local["unet"], opt, ema=True)


def train_cases(mesh_shape, inputs):
    """Two train steps on the rank's split tree at ``mesh_shape`` with the
    reference's draws: {name: array} of each step's loss and grad norm, the
    gathered params, moments and EMA (flat keys), each local leaf's
    digest, and the split leaves' keys; {step: collectives}."""
    m = mesh_mod.make_mesh(*mesh_shape)
    cfg = t_config.TINY
    full = init_pipeline_params(cfg, torch.Generator().manual_seed(0), "cpu")
    plan = sharding.site_plan(full, mesh_shape[1], cfg)
    local = shard_params(full, m, cfg, plan)
    opt = T.make_optimizer(lr=TRAIN_LR)
    state = T.init_train_state(local["unet"], opt, ema=True)
    frozen = {k: v for k, v in local.items() if k in ("clip", "temb")}
    step = T.make_train_step(cfg, opt, ema_decay=TRAIN_DECAY, mesh=m,
                             plan=plan)
    batch = {k: inputs[f"train/{k}"] for k in ("tokens", "latents")}
    out, counts = {}, {}
    for i in range(TRAIN_STEPS):
        draws = {k: inputs[f"train/{i}/{k}"] for k in ("t", "eps")}
        collectives.reset_counts()
        met = step(state, frozen, batch, None, draws=draws)[1]
        counts[f"train/{i}"] = np.array([collectives.collective_counts()[k]
                                         for k in collectives.COLLECTIVES])
        out[f"train/{i}/loss"] = met["loss"].numpy()
        out[f"train/{i}/grad_norm"] = met["grad_norm"].numpy()
    # a backward in another thread (as autograd's device thread runs a
    # CUDA backward), which does not see the call's mesh
    params = [p for _, p in T.leaves(state.params)]
    with mesh_mod.use(m):
        loss = T.ldm_loss(state.params, frozen, batch, None, cfg, draws={
            k: inputs[f"train/0/{k}"] for k in ("t", "eps")})
        here = torch.autograd.grad(loss, params, retain_graph=True,
                                   allow_unused=True, materialize_grads=True)
    there = []
    worker = threading.Thread(target=lambda: there.extend(torch.autograd.grad(
        loss, params, allow_unused=True, materialize_grads=True)))
    worker.start()
    worker.join()
    out["train/thread_grads_equal"] = np.array(
        len(there) == len(here) and all(torch.equal(a, b)
                                        for a, b in zip(here, there)))
    out["train/digests"] = _digests(state.params)
    out["train/split"] = np.array(sorted(
        T.flat_key(p) for p in sharding.split_leaves(state.params, plan,
                                                     ("unet",))))
    with torch.no_grad():
        for name, tree in (("params", state.params), ("ema", state.ema),
                           ("mu", T.unflatten(state.params,
                                              state.opt_state["mu"])),
                           ("nu", T.unflatten(state.params,
                                              state.opt_state["nu"]))):
            whole = sharding.gather_params(tree, m, plan, ("unet",))
            for p, t in T.leaves(whole):
                # a copy: an unsplit leaf is the state's own tensor, which
                # the resume case below steps in place
                out[f"train/{name}/{T.flat_key(p)}"] = (
                    t.detach().numpy().copy())
    # remat on the mesh (ROADMAP item 23c): one step's gradients with the
    # UNet's forward recomputed in the backward, against the same step's
    # without, and their collectives
    draws = {k: inputs[f"train/0/{k}"] for k in ("t", "eps")}
    grads = {}
    for remat in (True, False):
        collectives.reset_counts()
        with mesh_mod.use(m):
            grads[remat] = T.loss_and_grads(state, frozen, batch, None, cfg,
                                            remat=remat, draws=draws)[1]
        if remat:
            counts["train/remat"] = np.array(
                [collectives.collective_counts()[k]
                 for k in collectives.COLLECTIVES])
    out["train/remat_max_abs_diff"] = np.array(max(
        (grads[True][k] - g).abs().max().item()
        for k, g in grads[False].items()))
    # the state's file (ROADMAP queue 3): the logical state, rank 0 alone
    # writing; a fresh state on this mesh loaded from it holds this rank's
    # tensors, and one more step from each gives the same bits
    d = Path(inputs["dir"])
    tag = f"{mesh_shape[0]}x{mesh_shape[1]}"
    with counted_writers([]) as opened:
        T.save_train_state(state, d / f"ts_{tag}", m, plan)
    out["train/writes"] = np.array(len(opened))
    like = _fresh_state(m, cfg, plan, opt)
    T.load_train_state(d / f"ts_{tag}", like, m, plan)
    out["train/reload_same"] = np.array(
        _state_digests(like) == _state_digests(state))
    for s in (state, like):
        step(s, frozen, batch, None, draws=draws)
    out["train/resume_same"] = np.array(
        _state_digests(like) == _state_digests(state))
    if mesh_shape == (2, 1):
        # the file (1, 2) saved, on this mesh
        other = _fresh_state(m, cfg, plan, opt)
        T.load_train_state(d / "ts_1x2", other, m, plan)
        got = _state_digests(other)
        out["train/reload_1x2/keys"] = np.array(sorted(got))
        out["train/reload_1x2/digests"] = np.array([got[k]
                                                    for k in sorted(got)])
    return out, counts


def norm_case():
    """``global_norm`` at m = 2 over a replicated leaf (ones [3], the same
    on both ranks) and a split one (this rank's half of arange(4)): the
    logical tree's norm, sqrt(3 + 14)."""
    r = mesh_mod.current().coords[1]
    rep = torch.ones(3)
    part = torch.arange(4.0)[2 * r:2 * r + 2]
    return T.global_norm([rep, part], [False, True]).numpy()


def anchor_cases(mesh_shape, inputs):
    """The pipeline functions on this rank's split tree with the
    reference's draws: {case: latents} and {case: image}."""
    m = mesh_mod.make_mesh(*mesh_shape)
    out = {}
    for name, (cfg_name, fn_name, draws) in ANCHORS.items():
        cfg = getattr(t_config, cfg_name)
        full = init_pipeline_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        local = shard_params(full, m, cfg)
        fn = getattr(pipeline, fn_name)
        tok = torch.from_numpy(inputs[f"{name}/tokens"]).long()
        kw = {k: inputs[f"{name}/{k}"] for k in draws}
        args = [local, tok, None, None, 7.5]
        if fn_name != "generate":
            args.append(torch.from_numpy(inputs[f"{name}/image"]))
            kw["start_step"] = ANCHOR_START[fn_name]
        if fn_name == "inpaint":
            args.append(torch.from_numpy(inputs[f"{name}/mask"]))
        with torch.inference_mode(), mesh_mod.use(m):
            un = torch.zeros((1, cfg.clip.context_len), dtype=torch.int64)
            args[2] = pipeline.encode_text(local, un, cfg)[0]
            for output in ("latent", "image"):
                r = fn(*args, cfg=cfg, sampler="dpm", steps=ANCHOR_STEPS,
                       output=output, **kw)
                out[f"{name}/{output}"] = r.numpy()
    return out


def main(world: int, rank: int, d: Path) -> None:
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    if world > 1:
        dist.init_process_group(
            "gloo", init_method=f"file://{d}/store{world}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
    with np.load(d / "inputs.npz") as z:
        inputs = {k: z[k] for k in z.files}
    inputs["lora_path"] = str(d / "lora.npz")
    inputs["dir"] = str(d)
    res = {}
    try:
        if world == 1:
            single, _ = context_cases(None, inputs)
            res.update({f"single/{k}": v for k, v in single.items()})
            print(f"single {time.perf_counter() - t0:.1f} s", flush=True)
        for shape in MESHES.get(world, ()):
            tag = f"{shape[0]}x{shape[1]}"
            got, counts = context_cases(shape, inputs)
            res.update({f"{tag}/{k}": v for k, v in got.items()})
            res.update({f"{tag}/{k}/counts": v for k, v in counts.items()})
            res.update({f"{tag}/{k}": v for k, v in
                        anchor_cases(shape, inputs).items()})
            for cases in ((spatial_cases,) if shape in SPATIAL_MESHES
                          else ()) + (train_cases,):
                got, counts = cases(shape, inputs)
                res.update({f"{tag}/{k}": v for k, v in got.items()})
                res.update({f"{tag}/{k}/counts": v
                            for k, v in counts.items()})
            got, counts = checkpoint_cases(shape, d)
            res.update({f"{tag}/{k}": v for k, v in got.items()})
            res.update({f"{tag}/{k}/counts": v for k, v in counts.items()})
            if shape == (1, 2):
                with mesh_mod.use(mesh_mod.make_mesh(1, 2)):
                    res[f"{tag}/global_norm"] = norm_case()
            print(f"{tag} {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        np.savez(d / f"w{world}_r{rank}.npz", **res)
        if world > 1:
            dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
