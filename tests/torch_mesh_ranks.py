"""One rank of ``tests/test_torch_mesh.py``'s gloo worlds, on the CPU.

    python tests/torch_mesh_ranks.py <world> <rank> <dir>

joins a gloo group of ``world`` ranks through the file store
``<dir>/store<world>``, runs every case of that world's meshes ((1, 2) and
(2, 1) in a world of two, (2, 2) in one of four) and writes
``<dir>/w<world>_r<rank>.npz``: each case's result under
``"<data>x<model>/<case>"``, the collectives the case issued under
``".../counts"`` (in ``collectives.COLLECTIVES`` order) and a refusal's
text under ``".../error"``. Rank 0 of the world of two also writes the same
cases off the mesh, under ``"single/<case>"``.

Two kinds of case. The Context's: every entry point the reference routes
to the mesh, at TINY in float32, on a ``Context(mesh=...)`` beside the same
call on a Context without one. The pipeline's (``anchor_*``): the port's
pipeline functions on the rank's split tree with the reference's draws
handed in through the seams (``<dir>/inputs.npz``), held against the JAX
package by the parent. Imports no JAX: a spawned rank does not pay for it.
"""

from __future__ import annotations

import datetime
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from sdtpu_torch import Context
from sdtpu_torch import config as t_config
from sdtpu_torch.engine import pipeline
from sdtpu_torch.engine.stream import StreamScheduler
from sdtpu_torch.io.params import init_pipeline_params
from sdtpu_torch.parallel import collectives, mesh as mesh_mod
from sdtpu_torch.parallel.sharding import shard_params

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
    if mesh is not None:
        try:
            StreamScheduler(c, slots=2)
            out["stream/error"] = np.array("no error")
        except ValueError as e:
            out["stream/error"] = np.array(str(e))
    if mesh is not None and mesh[0] > 1:
        try:
            c.generate(["one"], seed=0)
            out["indivisible/error"] = np.array("no error")
        except Exception as e:  # noqa: BLE001 - the parent reads the text
            out["indivisible/error"] = np.array(
                f"{type(e).__name__}:{getattr(e, 'code', None)!r}:"
                f"{getattr(e, 'reason', e)}")
    return out, counts


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
    dist.init_process_group("gloo", init_method=f"file://{d}/store{world}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    with np.load(d / "inputs.npz") as z:
        inputs = {k: z[k] for k in z.files}
    inputs["lora_path"] = str(d / "lora.npz")
    res = {}
    try:
        if world == 2 and rank == 0:
            single, _ = context_cases(None, inputs)
            res.update({f"single/{k}": v for k, v in single.items()})
        for shape in MESHES[world]:
            tag = f"{shape[0]}x{shape[1]}"
            got, counts = context_cases(shape, inputs)
            res.update({f"{tag}/{k}": v for k, v in got.items()})
            res.update({f"{tag}/{k}/counts": v for k, v in counts.items()})
            res.update({f"{tag}/{k}": v for k, v in
                        anchor_cases(shape, inputs).items()})
    finally:
        np.savez(d / f"w{world}_r{rank}.npz", **res)
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
