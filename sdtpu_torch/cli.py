"""The command line, the counterpart of ``sdtpu/cli.py``, with its
subcommands' flags and defaults:

    python -m sdtpu_torch.cli generate --prompt "..." --out out.png
    python -m sdtpu_torch.cli show out.bin
    python -m sdtpu_torch.cli serve --port 8000 [--stream-slots 4]
    python -m sdtpu_torch.cli warmup --configs sd15 --batch-sizes 1,2,4
    python -m sdtpu_torch.cli info
    python -m sdtpu_torch.cli train --steps 100 --batch 2 [--data DIR]
    python -m sdtpu_torch.cli bench --parts unet [--phases]
    python -m sdtpu_torch.cli profile --part unet --top 15
    python -m sdtpu_torch.cli sweep --quick
    python -m sdtpu_torch.cli analyze --results results

(``sdtpu-torch`` once installed). ``--platform`` takes ``auto|cpu|cuda``:
``auto`` is the card, the port's default device, and raises
``RUNTIME_ERROR`` without one, as ``Context`` does; ``cpu`` runs the plain
versions on the host. ``warmup``'s counterpart of the reference's XLA
compile cache is the port's kernel library (``ops/_build.py``): it builds
the kernels into ``--cache-dir`` (the build directory by default), serves
the first image of each configuration and batch size, and ``--pack`` /
``--unpack`` carry the built library as a gzip tar. ``train``'s
``--kernels`` takes ``auto|plain|cuda`` (``auto`` is ``cuda`` on the card,
as the reference's is ``pallas`` on a TPU: the policies whose kernels have
a backward) and writes the port's train-state file (``--out``, read back by
``--resume``; an orbax directory is refused: orbax needs JAX). ``bench``
times each model part (``sdtpu_torch.bench.runner``; ``--phases`` the
pipeline's phases too) and ``analyze`` prints its table; ``profile``
prints one part's device kernels by time and by class
(``sdtpu_torch.bench.xprof``); ``sweep`` times ``Context.generate`` over
samplers, steps, guidance, batches and sizes (``sdtpu_torch.bench.sweep``).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

DEFAULT_PROMPT = "a photograph of an astronaut riding a horse"

# a literal copy of sorted(sdtpu_torch.samplers.SAMPLERS): --help imports no
# sampler module (tests pin the two lists equal)
SAMPLER_CHOICES = ["ddim", "dpm", "dpm++", "dpm2", "dpm2_karras",
                   "dpm_karras", "dpm_sde", "dpm_sde_karras", "euler",
                   "euler_a", "euler_a_karras", "euler_karras", "heun",
                   "heun_karras", "lcm", "lms", "lms_karras", "plms",
                   "plms_exact", "unipc", "unipc_karras"]

PLATFORMS = ["auto", "cpu", "cuda"]
KERNEL_CHOICES = ["auto", "cuda", "cuda_gn", "cuda_conv", "plain"]

#: the parts of ``sdtpu_torch.bench.runner``
PARTS = ["temb", "text_encoder", "unet", "vae_decoder"]

#: a literal copy of sdtpu_torch.train.step.TRAIN_KERNELS (tests pin them)
TRAIN_KERNEL_CHOICES = ["auto", "plain", "cuda"]


def _device(platform: str) -> str:
    """``--platform`` -> the Context's device: ``auto`` is the card."""
    return "cpu" if platform == "cpu" else "cuda"


def _interval(spec):
    if not spec:
        return None
    lo, _, hi = spec.partition(",")
    return float(lo), float(hi)


def _cmd_generate(args) -> int:
    import sdtpu_torch
    from sdtpu_torch.engine.logging import LogLevel

    ctx = sdtpu_torch.Context(
        model_dir=args.model_dir,
        steps=args.steps,
        sampler=args.sampler,
        config=args.config,
        log_level=LogLevel(args.log_level),
        kernels=args.kernels,
        quantize=args.quantize,
        seed=args.seed,
        size=args.size,
        lora=args.lora,
        cfg_interval=_interval(args.cfg_interval),
        clip_skip=args.clip_skip,
        guidance_rescale=args.guidance_rescale,
        freeu=(tuple(float(v) for v in args.freeu.split(","))
               if args.freeu else None),
        tome_ratio=args.tome_ratio,
        deepcache=args.deepcache,
        device=_device(args.platform),
    )
    if args.controlnet:
        # --controlnet [name=]path (or "random" for demo weights)
        for spec in args.controlnet:
            name, _, src = spec.rpartition("=")
            ctx.load_controlnet(name or "default", src or spec)
    if args.embedding:
        for spec in args.embedding:
            word, sep, src = spec.partition("=")
            if not sep:
                print(f"error: --embedding expects WORD=PATH, got {spec!r}",
                      file=sys.stderr)
                return 2
            ctx.load_embedding(word, src)
    t0 = time.perf_counter()
    common = dict(guidance=args.guidance, seed=args.seed,
                  negative_prompt=args.negative_prompt)
    if args.init_image:
        from PIL import Image

        init = np.asarray(Image.open(args.init_image).convert("RGB"))
        unet = ctx.cfg.unet
        lc = ctx.cfg.latent_channels
        if args.mask_image:
            mask = np.asarray(Image.open(args.mask_image).convert("L"))
            img = ctx.inpaint(args.prompt, init, mask,
                              strength=args.strength or 1.0, **common)
        elif unet.num_class_embeds and unet.in_channels == lc + 3:
            # the x4 upscaler (7-ch): --init-image is the low-res input
            img = ctx.upscale(args.prompt, init,
                              noise_level=args.noise_level, **common)
        elif unet.in_channels == 2 * lc:
            # InstructPix2Pix (8-ch): the prompt is an edit instruction
            img = ctx.instruct_pix2pix(
                args.prompt, init, image_guidance=args.image_guidance,
                **common)
        elif args.depth_image:
            # any monotone depth map: an 8/16-bit grayscale png
            depth = np.asarray(Image.open(args.depth_image)).astype(
                np.float32)
            if depth.ndim == 3:
                depth = depth.mean(axis=-1)
            img = ctx.depth2img(args.prompt, init, depth,
                                strength=args.strength or 0.8, **common)
        else:
            img = ctx.img2img(args.prompt, init,
                              strength=args.strength or 0.6, **common)
    elif args.control_image:
        from PIL import Image

        hint = np.asarray(Image.open(args.control_image).convert("RGB"))
        img = ctx.generate(args.prompt, control_image=hint,
                           control=args.control or None,
                           control_scale=args.control_scale, **common)
    elif args.hires_scale:
        img = ctx.hires_fix(args.prompt, scale=args.hires_scale,
                            strength=args.hires_strength, **common)
    else:
        img = ctx.generate(args.prompt, pag_scale=args.pag_scale, **common)
    dt = time.perf_counter() - t0
    print(f"generated {img.shape[0]}x{img.shape[1]} image in {dt:.3f}s "
          f"(steps={args.steps}, sampler={args.sampler}, seed={args.seed})")
    if args.out.endswith(".bin"):
        img.tofile(args.out)  # raw uint8, the reference's output.bin format
    else:
        from PIL import Image

        Image.fromarray(img).save(args.out)
    print(f"wrote {args.out}")
    return 0


def _cmd_show(args) -> int:
    data = np.fromfile(args.path, np.uint8)
    side = int(round((data.size / 3) ** 0.5))
    img = data.reshape(side, side, 3)
    from PIL import Image

    out = args.path.rsplit(".", 1)[0] + ".png"
    Image.fromarray(img).save(out)
    print(f"wrote {out} ({side}x{side})")
    return 0


def _cmd_serve(args) -> int:
    import sdtpu_torch
    from sdtpu_torch.engine.errors import ErrorCode, SdtpuError
    from sdtpu_torch.engine.logging import LogLevel
    from sdtpu_torch.engine.server import serve

    mesh = None
    if args.mesh:
        try:
            mesh = tuple(int(v) for v in args.mesh.split(","))
            if len(mesh) != 2 or min(mesh) < 1:
                raise ValueError
        except ValueError:
            raise SdtpuError(ErrorCode.INVALID_ARGUMENT,
                             f"--mesh takes 'data,model', got "
                             f"{args.mesh!r}") from None
    lora = None
    if args.lora:
        lora = {}
        for spec in args.lora:
            if "=" not in spec:
                print(f"error: --lora expects name=path, got {spec!r}",
                      file=sys.stderr)
                return 2
            name, path = spec.split("=", 1)
            lora[name] = path
    rank, group, followers = 0, None, []
    if mesh is not None and mesh[0] * mesh[1] > 1:
        from sdtpu_torch.parallel import follow

        rank, group, followers = follow.start(
            mesh[0] * mesh[1], _device(args.platform),
            ["-m", "sdtpu_torch.cli", *args.argv])
    ctx = sdtpu_torch.Context(
        model_dir=args.model_dir, steps=args.steps, sampler=args.sampler,
        config=args.config, log_level=LogLevel(args.log_level),
        kernels=args.kernels, lora=lora,
        cfg_interval=_interval(args.cfg_interval), deepcache=args.deepcache,
        tome_ratio=args.tome_ratio, device=_device(args.platform),
        mesh=mesh)
    if group is None:
        _serve(serve, ctx, args, None)
        return 0
    from sdtpu_torch.parallel import follow

    if rank:
        follow.follow(ctx, group)
        return 0
    leader = follow.Leader(group, ctx)
    try:
        _serve(serve, ctx, args, leader)
    finally:
        leader.stop()
        for p in followers:
            p.wait()
    return 0


def _serve(serve, ctx, args, leader) -> None:
    """``engine.server.serve`` with the command's flags; SIGTERM stops it
    as an interrupt does, so a mesh's leader ends its followers."""
    import signal

    def stop(signum, frame):
        raise KeyboardInterrupt

    stream_steps = (tuple(int(s) for s in args.stream_steps.split(","))
                    if args.stream_steps else ())
    previous = signal.signal(signal.SIGTERM, stop)
    try:
        serve(ctx, host=args.host, port=args.port,
              max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
              stream_slots=args.stream_slots, max_queue=args.max_queue,
              stream_steps=stream_steps, leader=leader)
    except KeyboardInterrupt:
        ctx.logger.info("serve: stopped")
    finally:
        signal.signal(signal.SIGTERM, previous)


def _library_files(cache_dir):
    """The built kernel libraries under ``cache_dir``: ``<hash>/<lib>``."""
    from sdtpu_torch.ops import _build

    return sorted(p for p in cache_dir.glob(f"*/{_build.LIB_NAME}")
                  if p.is_file())


def _cmd_warmup(args) -> int:
    """Build the kernel library and serve the first image of every
    configuration and batch size, so that a deployment starts warm; or
    pack the built library as a gzip tar artifact, or unpack one. The
    library is valid for the nvcc and the card it was built with (its
    directory is the hash of the sources and flags); the emitted JSON
    records torch's and CUDA's versions."""
    import gc
    import json
    import tarfile
    from pathlib import Path

    import torch

    from sdtpu_torch.ops import _build

    cache_dir = Path(args.cache_dir).expanduser()
    if args.unpack:
        cache_dir.mkdir(parents=True, exist_ok=True)
        root = cache_dir.resolve()
        with tarfile.open(args.unpack, "r:gz") as tf:
            for m in tf.getmembers():
                # --pack writes <hash>/<library> members, so a legitimate
                # member resolves to a file two levels under the cache dir;
                # a str-prefix check would admit '../_build2/x/f'
                p = (cache_dir / m.name).resolve()
                if not m.isfile() or p.parent.parent != root:
                    raise SystemExit(f"unsafe archive member {m.name!r}")
            tf.extractall(cache_dir, filter="data")
        n = len(_library_files(cache_dir))
        print(json.dumps({"unpacked_to": str(cache_dir), "entries": n}))
        return 0

    import sdtpu_torch
    from sdtpu_torch.engine.logging import LogLevel

    device = _device(args.platform)
    cache_dir.mkdir(parents=True, exist_ok=True)
    # the build goes to the artifact directory (the build directory itself
    # by default)
    _build.BUILD_DIR = cache_dir
    report = []
    if device == "cuda":
        t0 = time.perf_counter()
        _build.library()
        report.append({"kernels": str(_build.library_path()),
                       "build_s": round(time.perf_counter() - t0, 1)})
        print(json.dumps(report[-1]), flush=True)
    batches = [int(x) for x in args.batch_sizes.split(",")]
    for name in args.configs.split(","):
        t0 = time.perf_counter()
        try:
            ctx = sdtpu_torch.Context(
                model_dir=args.model_dir, steps=args.steps,
                sampler=args.sampler, config=name,
                log_level=LogLevel(args.log_level), device=device)
            r = {"config": name,
                 "init_s": round(time.perf_counter() - t0, 1),
                 "first_image_s": {}}
            for b in batches:
                t0 = time.perf_counter()
                if b == 1:
                    ctx.generate("warmup", seed=0)
                else:
                    ctx.generate_batch(
                        [{"prompt": "warmup", "seed": i} for i in range(b)])
                r["first_image_s"][str(b)] = round(
                    time.perf_counter() - t0, 1)
            del ctx
        except Exception as e:  # noqa: BLE001 - the fleet goes on a config
            r = {"config": name, "error": f"{type(e).__name__}: {e}"}
        report.append(r)
        print(json.dumps(r), flush=True)
        gc.collect()
    entries = _library_files(cache_dir)
    out = {"cache_dir": str(cache_dir), "entries": len(entries),
           "bytes": sum(p.stat().st_size for p in entries),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "backend": device}
    if args.pack:
        with tarfile.open(args.pack, "w:gz") as tf:
            for p in entries:
                tf.add(p, arcname=f"{p.parent.name}/{p.name}")
        out["artifact"] = args.pack
    print(json.dumps(out))
    return 0 if not any("error" in r for r in report) else 1


def _cmd_info(args) -> int:
    import torch

    from sdtpu_torch.config import CONFIGS
    from sdtpu_torch.version import __version__

    print(f"sdtpu_torch {__version__} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})")
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        names = ", ".join(torch.cuda.get_device_name(i) for i in range(n))
        print(f"backend: cuda, devices: {n} ({names})")
    else:
        print("backend: cpu, devices: 0 (no CUDA device)")
    for name, cfg in CONFIGS.items():
        print(f"config {name}: {cfg.image_size}x{cfg.image_size}, "
              f"latent {cfg.latent_size}, unet ch {cfg.unet.model_channels}, "
              f"dtype {cfg.dtype}")
    return 0


def _cmd_train(args) -> int:
    """LDM fine-tune loop (``sdtpu_torch.train``), the reference's
    ``_cmd_train`` (``sdtpu/cli.py:374-507``): data in, the train state
    (params, AdamW moments, EMA) out, resumable."""
    from pathlib import Path

    import torch

    from sdtpu_torch.config import CONFIGS
    from sdtpu_torch.engine.errors import ErrorCode, SdtpuError
    from sdtpu_torch.io.params import cast_params, init_tree, tree_names
    from sdtpu_torch.train import (
        init_train_state,
        load_train_state,
        make_optimizer,
        make_train_step,
        save_train_state,
    )
    from sdtpu_torch.train.step import OrbaxCheckpointError, step_generator

    cfg = CONFIGS[args.config]
    if args.objective != "auto" and args.objective != cfg.prediction:
        # a checkpoint trained against the "wrong" objective silently
        # disagrees with cfg.prediction at inference
        print(f"WARNING: --objective {args.objective} differs from the "
              f"{args.config} config's prediction={cfg.prediction!r}; the "
              f"resulting checkpoint will NOT sample correctly under "
              f"config={args.config} unless you know what you are doing",
              file=sys.stderr)
    device = torch.device(_device(args.platform))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SdtpuError(ErrorCode.RUNTIME_ERROR,
                         "no CUDA device (torch.cuda.is_available() is "
                         "false); pass --platform cpu")
    # cuDNN's deterministic algorithms: a run is bitwise reproducible from
    # its seed (the default backward-weight algorithms sum in any order)
    torch.backends.cudnn.deterministic = True

    t0 = time.time()
    dt = cfg.compute_dtype
    if args.model_dir is None:
        print("no --model-dir: random-init demo weights")
        gen = torch.Generator(device=device).manual_seed(args.seed)
        pipeline = {name: init_tree(name, cfg, gen, device)
                    for name in tree_names(cfg)}
        pipeline.pop("vae")
    else:
        from sdtpu_torch.io.weights import load_pipeline_params

        pipeline = load_pipeline_params(args.model_dir, cfg, device=device)
    # frozen models run in the compute dtype; the trainable UNet keeps
    # float32 master params (ldm_loss casts them for the forward and
    # backward), so lr-scale updates and the EMA do not round away in bf16
    frozen = {name: cast_params(pipeline[name], dt)
              for name in ("clip", "clip2", "temb", "add_mlp")
              if name in pipeline}
    unet_params = cast_params(pipeline["unet"], torch.float32)
    print(f"params ready in {time.time() - t0:.1f}s")

    opt = make_optimizer(lr=args.lr)
    state = init_train_state(unet_params, opt, ema=args.ema)
    if args.resume:
        try:
            load_train_state(args.resume, state)
        except OrbaxCheckpointError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"resumed at step {int(state.step)} from {args.resume}")

    if args.data:
        # streaming input: sharded .npz or an image folder, epoch shuffle,
        # background device prefetch (sdtpu_torch.train.data)
        from sdtpu_torch.tokenizer import DEMO_MERGES, Tokenizer
        from sdtpu_torch.train.data import make_dataset, stream

        flat = (Path(args.model_dir) / "ctokenizer.txt"
                if args.model_dir else None)
        if flat is not None and flat.exists():
            tok = Tokenizer.from_flat_file(flat)
        else:
            tok = Tokenizer.from_merges(DEMO_MERGES)
        ds = make_dataset(args.data, tokenizer=tok,
                          context_len=cfg.clip.context_len,
                          image_size=cfg.image_size)
        if len(ds) < args.batch:
            print(f"error: {len(ds)} examples < batch {args.batch}",
                  file=sys.stderr)
            return 2
        steps_per_epoch = len(ds) // args.batch
        start_epoch = int(state.step) // max(steps_per_epoch, 1)
        print(f"dataset: {len(ds)} examples ({ds.kind}), "
              f"{steps_per_epoch} steps/epoch, resuming epoch {start_epoch}")
        if ds.kind == "images":
            frozen["vae_enc"] = cast_params(pipeline["vae_enc"], dt)
        batches = stream(ds, args.batch, seed=args.seed,
                         prefetch=args.prefetch, device=device,
                         start_epoch=start_epoch)
    else:
        n = max(args.batch * 4, 8)
        s = cfg.latent_size
        g = torch.Generator(device=device).manual_seed(1)
        latents = torch.randn((n, s, s, cfg.latent_channels), generator=g,
                              device=device)
        tokens = torch.arange(cfg.clip.context_len, dtype=torch.int32,
                              device=device)[None].repeat(n, 1)
        print(f"no --data: {n} synthetic demo examples")

        def _demo_batches():
            i = int(state.step)
            while True:
                idx = torch.randperm(
                    n, generator=step_generator(args.seed + 23, i, device),
                    device=device)[:args.batch]
                i += 1
                yield {"latents": latents[idx], "tokens": tokens[idx]}

        batches = _demo_batches()
    del pipeline

    step = make_train_step(cfg, opt, kernels=args.kernels, remat=args.remat,
                           objective=args.objective,
                           snr_gamma=args.snr_gamma,
                           noise_offset=args.noise_offset)
    t0 = time.time()
    try:
        for i in range(args.steps):
            batch = next(batches)
            gen = step_generator(args.seed + 17, int(state.step), device)
            state, metrics = step(state, frozen, batch, gen)
            if i % args.log_every == 0 or i == args.steps - 1:
                print(f"step {int(state.step):6d}  "
                      f"loss {float(metrics['loss']):.4f}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}  "
                      f"({(time.time() - t0):.1f}s)", flush=True)
    finally:
        if hasattr(batches, "close"):
            batches.close()
    save_train_state(state, args.out)
    print(f"saved train state (step {int(state.step)}"
          + (", ema" if args.ema else "") + f") to {args.out}")
    return 0


def _cmd_bench(args) -> int:
    from sdtpu_torch.bench.analyze import analyze
    from sdtpu_torch.bench.runner import benchmark_parts
    from sdtpu_torch.config import CONFIGS

    cfg = CONFIGS[args.config]
    parts = args.parts.split(",") if args.parts else None
    summary = benchmark_parts(
        cfg, warmup=args.warmup, iters=args.iters, parts=parts,
        out_dir=args.results, kernels=args.kernels,
        device=_device(args.platform),
    )
    ok = [n for n, r in summary.items() if not r.get("error")]
    bad = [n for n, r in summary.items() if r.get("error")]
    print(f"benchmarked: {ok}" + (f", FAILED: {bad}" if bad else ""))
    if args.phases:
        from sdtpu_torch.bench.profile import phase_timings

        pt = phase_timings(cfg, steps=args.steps, kernels=args.kernels,
                           device=_device(args.platform))
        for k, v in pt.items():
            print(f"  {k:22s} {v:10.3f} ms")
    print(analyze(args.results))
    return 1 if bad else 0


def _cmd_profile(args) -> int:
    from sdtpu_torch.bench.runner import (check_device, demo_params,
                                          part_specs, resolve)
    from sdtpu_torch.bench.xprof import profile_ops, summarize
    from sdtpu_torch.config import CONFIGS

    cfg = CONFIGS[args.config]
    device = check_device(_device(args.platform))
    kernels = resolve(args.kernels, device)
    params = demo_params(cfg, device)
    fn, fargs = part_specs(cfg, params, kernels, device)[args.part]
    ops = profile_ops(fn, fargs)
    print(f"== {args.part} ({device.type}, kernels={kernels})")
    print(summarize(ops, top=args.top))
    if args.trace_dir:
        from sdtpu_torch.bench.profile import capture_trace

        print(f"trace: {capture_trace(fn, fargs, args.trace_dir)}")
    return 0


def _cmd_sweep(args) -> int:
    from sdtpu_torch.bench.sweep import run_sweep

    run_sweep(
        config=args.config,
        iters=args.iters,
        out_dir=args.out,
        dump_images=args.images,
        quick=args.quick,
        sizes=tuple(int(s) for s in args.sizes.split(",")),
        steps_list=tuple(int(s) for s in args.steps_list.split(",")),
        device=_device(args.platform),
    )
    return 0


def _cmd_analyze(args) -> int:
    from sdtpu_torch.bench.analyze import analyze

    print(analyze(args.results))
    return 0


def main(argv=None) -> int:
    from sdtpu_torch.config import CONFIGS

    p = argparse.ArgumentParser(
        prog="sdtpu-torch",
        description="Stable Diffusion txt2img engine (PyTorch/CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="prompt -> image")
    g.add_argument("--prompt", default=DEFAULT_PROMPT)
    g.add_argument("--guidance", type=float, default=7.5)
    g.add_argument("--negative-prompt", default=None)
    g.add_argument("--init-image", default=None,
                   help="img2img: starting image (png/jpg at the output size)")
    g.add_argument("--strength", type=float, default=None,
                   help="img2img/inpaint strength in (0, 1] "
                        "(default 0.6 img2img, 1.0 inpaint)")
    g.add_argument("--mask-image", default=None,
                   help="inpainting: grayscale mask (white = repaint); "
                        "requires --init-image")
    g.add_argument("--noise-level", type=int, default=20,
                   help="x4 upscaler (config sd_x4): conditioning noise "
                        "augmentation level in [0, max_noise_level); "
                        "--init-image is the low-res input")
    g.add_argument("--depth-image", default=None,
                   help="depth2img (config sd2_depth): grayscale depth map "
                        "(any monotone scale); requires --init-image")
    g.add_argument("--deepcache", type=int, default=None, metavar="N",
                   help="DeepCache: run the full UNet every N steps and "
                        "splice the cached deep feature on the others")
    g.add_argument("--tome-ratio", type=float, default=0.0,
                   help="ToMe-SD token merging: merge this fraction of "
                        "spatial tokens before the large self-attentions "
                        "(0 = off)")
    g.add_argument("--guidance-rescale", type=float, default=0.0,
                   help="CFG rescale in [0,1]")
    g.add_argument("--clip-skip", type=int, default=1,
                   help="A1111 CLIP skip: tap the text tower N-1 blocks "
                        "early (1 = default tap)")
    g.add_argument("--freeu", default=None, metavar="B1,B2,S1,S2",
                   help="FreeU decoder rebalancing, e.g. 1.5,1.6,0.9,0.2")
    g.add_argument("--hires-scale", type=int, default=None,
                   help="hires fix: second denoise pass at N x the base "
                        "resolution (latent upscale)")
    g.add_argument("--hires-strength", type=float, default=0.6,
                   help="denoising strength of the hires second pass")
    g.add_argument("--pag-scale", type=float, default=None,
                   help="perturbed-attention guidance strength (plain "
                        "txt2img path)")
    g.add_argument("--cfg-interval", default=None, metavar="LO,HI",
                   help="apply CFG only on the middle LO..HI fraction of the "
                        "trajectory")
    g.add_argument("--image-guidance", type=float, default=1.5,
                   help="InstructPix2Pix (config sd15_ip2p) image-side CFG "
                        "scale (requires --init-image)")
    g.add_argument("--steps", type=int, default=20)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--sampler", default="dpm", choices=SAMPLER_CHOICES)
    g.add_argument("--config", default="sd15", choices=sorted(CONFIGS))
    g.add_argument("--model-dir", default=None,
                   help="weights dir or file (omit for random-init demo)")
    g.add_argument("--kernels", default="auto", choices=KERNEL_CHOICES)
    g.add_argument("--quantize", default="none",
                   choices=["none", "int8", "int8w", "int8w_dense"])
    g.add_argument("--size", type=int, default=None,
                   help="output resolution override (e.g. 768)")
    g.add_argument("--lora", default=None,
                   help="LoRA adapter (.npz or kohya .safetensors) applied "
                        "to every request")
    g.add_argument("--controlnet", action="append", default=None,
                   metavar="[NAME=]PATH",
                   help="register a ControlNet (LDM control_model.* "
                        "safetensors, or 'random' for demo weights); "
                        "repeatable")
    g.add_argument("--embedding", action="append", default=None,
                   metavar="WORD=PATH",
                   help="textual-inversion embedding: trigger word = "
                        ".npz/.pt/.safetensors vector file; repeatable")
    g.add_argument("--control-image", default=None,
                   help="ControlNet conditioning image (png/jpg at the "
                        "output size); requires --controlnet")
    g.add_argument("--control", default=None,
                   help="ControlNet name to use (default: the only one "
                        "loaded)")
    g.add_argument("--control-scale", type=float, default=1.0)
    g.add_argument("--log-level", type=int, default=2,
                   help="0=nothing .. 4=abusive")
    g.add_argument("--platform", default="auto", choices=PLATFORMS,
                   help="the device (auto = the CUDA card)")
    g.add_argument("--out", default="output.png")
    g.set_defaults(fn=_cmd_generate)

    b = sub.add_parser("bench", help="per-part steady-state benchmark")
    b.add_argument("--config", default="sd15", choices=sorted(CONFIGS))
    b.add_argument("--warmup", type=int, default=20)
    b.add_argument("--iters", type=int, default=100)
    b.add_argument("--steps", type=int, default=20)
    b.add_argument("--parts", default=None,
                   help="comma list: " + ",".join(PARTS))
    b.add_argument("--results", default="results")
    b.add_argument("--kernels", default="auto", choices=KERNEL_CHOICES)
    b.add_argument("--phases", action="store_true",
                   help="also time pipeline phases (conditioning/denoise/decode)")
    b.add_argument("--platform", default="auto", choices=PLATFORMS)
    b.set_defaults(fn=_cmd_bench)

    pr = sub.add_parser("profile", help="per-op device profile of one part")
    pr.add_argument("--part", default="unet", choices=PARTS)
    pr.add_argument("--config", default="sd15", choices=sorted(CONFIGS))
    pr.add_argument("--kernels", default="auto", choices=KERNEL_CHOICES)
    pr.add_argument("--top", type=int, default=15)
    pr.add_argument("--trace-dir", default=None,
                    help="also write a Chrome trace of one call here "
                         "(torch.profiler)")
    pr.add_argument("--platform", default="auto", choices=PLATFORMS)
    pr.set_defaults(fn=_cmd_profile)

    w = sub.add_parser("sweep", help="sampler/steps/CFG/size config sweep")
    w.add_argument("--config", default="sd15", choices=sorted(CONFIGS))
    w.add_argument("--iters", type=int, default=3)
    w.add_argument("--sizes", default="512,768")
    w.add_argument("--steps-list", default="10,20,50")
    w.add_argument("--out", default=None)
    w.add_argument("--images", action="store_true")
    w.add_argument("--quick", action="store_true",
                   help="one config only (smoke test)")
    w.add_argument("--platform", default="auto", choices=PLATFORMS)
    w.set_defaults(fn=_cmd_sweep)

    a = sub.add_parser("analyze", help="analyze benchmark results")
    a.add_argument("--results", default="results")
    a.set_defaults(fn=_cmd_analyze)

    s = sub.add_parser("show", help="render a raw output.bin to png")
    s.add_argument("path")
    s.set_defaults(fn=_cmd_show)

    sv = sub.add_parser("serve", help="HTTP txt2img service")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--config", default="sd15", choices=sorted(CONFIGS))
    sv.add_argument("--steps", type=int, default=20)
    sv.add_argument("--sampler", default="dpm", choices=SAMPLER_CHOICES)
    sv.add_argument("--model-dir", default=None)
    sv.add_argument("--mesh", default=None,
                    help="multi-card serving mesh as 'data,model': rank 0 "
                         "serves HTTP, the other ranks (torchrun's, or "
                         "started here) follow its calls")
    sv.add_argument("--lora", action="append", default=None,
                    metavar="NAME=PATH",
                    help="register a LoRA adapter for per-request selection "
                         "(repeatable; requests pick one via the 'lora' "
                         "field)")
    sv.add_argument("--cfg-interval", default=None, metavar="LO,HI",
                    help="guidance interval for every request (see "
                         "generate --cfg-interval)")
    sv.add_argument("--deepcache", type=int, default=None, metavar="N",
                    help="DeepCache full-eval cadence for every request")
    sv.add_argument("--tome-ratio", type=float, default=0.0,
                    help="ToMe token-merge ratio (see generate --tome-ratio)")
    sv.add_argument("--kernels", default="auto", choices=KERNEL_CHOICES)
    sv.add_argument("--log-level", type=int, default=2)
    sv.add_argument("--max-batch", type=int, default=4,
                    help="micro-batching: max concurrent /generate requests "
                         "fused into one batched call")
    sv.add_argument("--max-wait-ms", type=float, default=25.0,
                    help="micro-batching: max added latency while waiting "
                         "for batch-mates")
    sv.add_argument("--stream-slots", type=int, default=0,
                    help="continuous batching: serve plain /generate "
                         "requests through an N-slot iteration-level pool "
                         "(no batch barriers; live /preview); 0 keeps the "
                         "micro-batcher")
    sv.add_argument("--stream-steps", default=None, metavar="K1,K2,...",
                    help="stream mode: extra per-request step counts the "
                         "pool schedules (clients pass \"steps\")")
    sv.add_argument("--max-queue", type=int, default=64,
                    help="backpressure: max waiting requests per worker; "
                         "excess requests get 503 + Retry-After")
    sv.add_argument("--platform", default="auto", choices=PLATFORMS)
    sv.set_defaults(fn=_cmd_serve)

    t = sub.add_parser("train",
                       help="LDM fine-tune the UNet (sdtpu_torch.train)")
    t.add_argument("--data", default=None,
                   help="training data: a .npz (latents [N,h,w,4] + tokens "
                        "[N,T]), a directory of such .npz shards, or an "
                        "image folder with captions.txt — shards stream "
                        "with epoch shuffle + device prefetch; image "
                        "folders VAE-encode on the device inside the step "
                        "(omit for a synthetic demo batch)")
    t.add_argument("--prefetch", type=int, default=2,
                   help="device-staging prefetch depth (0 disables the "
                        "background loader)")
    t.add_argument("--config", default="sd15", choices=sorted(CONFIGS))
    t.add_argument("--model-dir", default=None,
                   help="frozen CLIP/temb + UNet init weights "
                        "(omit for random-init demo)")
    t.add_argument("--steps", type=int, default=100)
    t.add_argument("--batch", type=int, default=2)
    t.add_argument("--lr", type=float, default=1e-5)
    t.add_argument("--ema", action="store_true",
                   help="track EMA weights (decay 0.9999)")
    t.add_argument("--objective", default="auto",
                   choices=["auto", "eps", "v"],
                   help="regression target: eps (SD1.x) or v-prediction "
                        "(SD2.x-768); auto follows the config")
    t.add_argument("--snr-gamma", type=float, default=0.0,
                   help="min-SNR loss weighting gamma (arXiv:2303.09556; "
                        "5.0 is the paper default, 0 disables)")
    t.add_argument("--noise-offset", type=float, default=0.0,
                   help="offset-noise strength: per-channel constant "
                        "shift added to eps (community full-range recipe)")
    t.add_argument("--remat", action="store_true",
                   help="torch.utils.checkpoint the UNet (memory for "
                        "FLOPs)")
    t.add_argument("--kernels", default="auto", choices=TRAIN_KERNEL_CHOICES,
                   help="auto = cuda on the card (the flash kernel and its "
                        "backward), plain elsewhere")
    t.add_argument("--resume", default=None,
                   help="train-state directory (--out of an earlier run) to "
                        "resume from")
    t.add_argument("--out", default="train_ckpt",
                   help="directory to save the final train state in")
    t.add_argument("--log-every", type=int, default=10)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--platform", default="auto", choices=PLATFORMS,
                   help="the device (auto = the CUDA card)")
    t.set_defaults(fn=_cmd_train)

    wu = sub.add_parser(
        "warmup",
        help="build the kernel library and serve each config's first "
             "image; optionally pack the library into a deployable "
             "artifact (or --unpack one)")
    wu.add_argument("--configs", default="sd15",
                    help="comma list of configs to warm up")
    wu.add_argument("--steps", type=int, default=20)
    wu.add_argument("--sampler", default="dpm", choices=SAMPLER_CHOICES)
    wu.add_argument("--batch-sizes", default="1",
                    help="comma list of serving batch sizes (the "
                         "micro-batcher pads to powers of two: 1,2,4)")
    wu.add_argument("--model-dir", default=None)
    wu.add_argument("--cache-dir", default=None,
                    help="where the kernel library is built (default: the "
                         "package's build directory, sdtpu_torch/_build)")
    wu.add_argument("--pack", default=None, metavar="TAR_GZ",
                    help="write the built library as a gzip tar artifact")
    wu.add_argument("--unpack", default=None, metavar="TAR_GZ",
                    help="deploy: extract a packed artifact into "
                         "--cache-dir and exit")
    wu.add_argument("--log-level", type=int, default=2)
    wu.add_argument("--platform", default="auto", choices=PLATFORMS)
    wu.set_defaults(fn=_cmd_warmup)

    i = sub.add_parser("info", help="print version/device/config info")
    i.set_defaults(fn=_cmd_info)

    args = p.parse_args(argv)
    # the command line, for the followers serve --mesh starts
    args.argv = list(sys.argv[1:] if argv is None else argv)
    if getattr(args, "cache_dir", "") is None:
        from sdtpu_torch.ops import _build

        args.cache_dir = str(_build.BUILD_DIR)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
